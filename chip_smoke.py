#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --hook-us TREE   # host us of one adapted
                                           # projection, port in TREE
    python3 chip_smoke.py --train-ms TREE  # the training rung's step
                                           # time, port in TREE
    python3 chip_smoke.py --profile-train pretrain|bench  # phase 7's
                                           # training-step profile on a
                                           # fresh rung
    python3 chip_smoke.py --int8-rmse      # int8 KV's logit error by
                                           # depth
    python3 chip_smoke.py --paged-ms TREE [OUT]  # the paged kernel over
                                           # float pages, port in TREE
                                           # (OUT: its outputs saved)
    python3 chip_smoke.py --paged-bits A B # two saved outputs bit-equal?
    python3 chip_smoke.py --rms-ms TREE    # the RMSNorm kernel of the port
                                           # in TREE beside this tree's
    python3 chip_smoke.py --vision         # phase 12 alone (ResNet-50
                                           # trained, the zoo, vision ops,
                                           # an LSTM, CE at V = 1000)
    python3 chip_smoke.py --procs          # phase 6, then phase 6j alone
    python3 chip_smoke.py --row            # phases 6, 6e, 6b, then 6k
                                           # (the row engine) alone
    python3 chip_smoke.py --host           # phase 13 alone (sharded
                                           # checkpoints, the native
                                           # collator, LazyGuard)
    python3 chip_smoke.py --train-rungs    # phase 2's cases at the rungs'
                                           # shapes, phases 4, 5 and 5c-5f
    python3 chip_smoke.py --eager          # phase 2's fp16 flash cases,
                                           # the op sweep and phase 5g
    python3 chip_smoke.py --gpt            # phase 2's D = 64 cases (int8
                                           # pages too), phase 3's GPT-2-
                                           # width int8 check and phase 9
                                           # (the GPT family, served with
                                           # int8 KV, prefix/chunks and a
                                           # GPT draft too)
    python3 chip_smoke.py --fp16           # phase 2's fp16 cases, phase
                                           # 10 (fp16 models) and the fp16
                                           # cases timed
    python3 chip_smoke.py --t5             # phase 2's T5 cases, phase 11
                                           # (T5, the tokenizer, jit
                                           # export) and the T5 cases
                                           # timed
    python3 chip_smoke.py --kv-dtype       # phase 2's cases of the paged
                                           # kernel over a pool in another
                                           # float dtype, phase 6, phase
                                           # 6l, those cases timed
    python3 chip_smoke.py --api            # phase 14 alone (the public
                                           # API packages on the card)
    python3 chip_smoke.py --api-profile    # phase 14's profiler window
                                           # in a fresh process
    python3 chip_smoke.py --tail           # phase 15 alone (audio, text
                                           # and distribution on the card)

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. build: compile every kernel source under `paddle_tpu_torch/csrc/` with
   nvcc (sm_90a), all sources at once; log each kernel's registers and
   spills, and require HGMMA (wgmma) instructions in the bf16 and the
   fp16 instantiations of the flash forward, dq and dk/dv kernels
   (`cuobjdump -sass`);
2. kernels: hold each kernel against its plain PyTorch version on the
   card, in f32 and bf16, at the serving and training paths' shapes
   (the flash forward, dq and dk/dv in fp16 too, `auto_cast(dtype=
   'float16')`'s path, below)
   (plus GQA, ragged lengths, the flash forward at the chunk shapes sq <
   sk of CHUNK_SHAPES, and again with the key count sk read from device
   memory over a 1024-row buffer whose rows past it are NaN (the
   captured chunk's call), int8 pages, int8 pages with the decode
   round's float window (window starts at row offsets 0, 9 and 15 of a
   page, a length-1 slot, an inactive slot on the null page; f32 and
   bf16, HKV 32 and 8), the speculative verify's k + 1 = 5 query rows
   per slot (f32 and bf16 at the serve shape, HKV 8, over int8 pages with
   the round's window of W = 2 pages, spans that cross a page boundary,
   an inactive slot), the same at head_dim 64 (`head64_cases`, GPT-2
   small's decode shape: 8 slots, H 12, ctx <= 1024, ps 16): the paged
   kernel over float pages and over int8 pages, without a window and
   with the round's W = 2 window (starts at row offsets 0, 9 and 15 of a
   page, a length-1 slot, an inactive slot on the null page), f32 and
   bf16 q, HKV 12 and 4, and the verify's T = 5 rows over int8 pages and
   the window across a page boundary; ignored CE rows, and adapter
   rows on slot 0, whose delta must be exactly zero and whose fused
   y + delta must equal y bit for bit); then the multi-tensor sum of
   squares and Adam update over the training rung's tensors of one
   decoder layer plus lm_head (bf16 with bf16 moments, and bf16 with
   fp32 masters and moments; a global-norm clip scale below 1, and
   amsgrad), every updated p, m, v (master, max) held to the plain
   version; and the training kernels at phase 5c's rungs' shapes, bf16:
   flash forward, dq and dk/dv at B=4 S=2048 H=16 and B=1 S=4096 H=32,
   RMSNorm over 8192 x 2048, CE forward and backward at [8188, 50304];
   and the fp16 cases (`fp16_cases`: the flash kernels, and RMSNorm,
   CE forward and backward, the paged kernel over fp16 pages and over
   int8 pages with an fp16 window at D = 128 and 64, T = 1 and 5, and the
   adapter kernel with an f32 and an fp16 bank, at phase 10's shapes;
   CE's fp16 dlogits at a mean loss's g = 1/N, where they round to 0 or
   to subnormals, held one by one to the plain version's subnormals, and
   logits at +-65504); and the T5 cases (`t5_cases`: the flash forward
   with its LSE, dq and dk/dv at D = 64, non-causal, B=8 H=16 over 512
   keys with 128, 1 and 100 queries, bf16 and f32; RMSNorm bf16 over
   [4096, 1024]; CE bf16 at [1024, 32128] with ignored rows) (these
   sets of cases are freed after the check and rebuilt for 8);
3. consistency: the engine (its decode sub-step and each prefill bucket
   replayed from a CUDA graph) at 2 layers of Llama-2-7B width in f32,
   greedy; each request's first 16 tokens must equal a no-cache
   full-recompute forward of the same model, and with a seeded sampling
   request added its eager twin (nothing captured) must give the same
   tokens; then adapter consistency at the same size:
   with a bank of two LoRA adapters, a mixed wave [base, ad0, ad1, ad0]
   gives each request the tokens it gets served alone under its adapter
   on a fresh engine and bank (and on the eager twin), base requests the
   tokens of a bank-less engine, and an adapter changes some tokens;
   then the prefix cache and
   chunked prefill at the same size: after a warm-up prompt, suffix hits
   (one in two chunks), a cold 900-token prompt in four chunks and a full
   hit (COW split) give the tokens of its eager twin, of an engine
   without cache or chunking and of a no-cache recompute, and every page
   is free after a forced clear; then the same with `kv_quant='int8'`:
   the graph engine's tokens equal its eager twin's, greedy and with a
   seeded sampling request, and with the prefix cache and chunking over
   the same paths, and every page is free after a forced clear; the
   first decode sub-step's logits equal (to 1e-4) those of the float
   engine over its pages roundtripped through int8 (the JAX bench's
   int8 arm) and lie within the bench's relative RMSE bound of 0.05 of
   float KV; the same int8 check again at 2 f32 layers of GPT-2 small's
   width (12 heads x 64: the D = 64 int8 split and window kernels);
   then speculative decoding (k = 4) at the same size: the
   spec engine's tokens equal the plain engine's (greedy and a seeded
   sampling request) with an independent 1-layer draft and with the
   target as its own draft, graph == eager, and so with the prefix
   cache and chunks and behind a bank; with int8 KV graph == eager (the
   plain int8 engine's tokens logged: the verify's rejected rows enter
   the touched pages' requantize scales); `traces` exactly the
   round and the prefill and draft-prefill buckets run; a swap to
   perturbed weights and a restore give the pre-swap tokens bit for bit
   with `traces` unchanged; `drain()` finishes every accepted request,
   one parked mid-chunk included; `evict_all()` frees every page;
4. train consistency: the same width at 2 layers in f32 (TF32 off), one
   forward and backward of the next-token loss on the card (kernels) and
   on the CPU (plain versions) with the same weights: the losses and
   every parameter's gradient must agree, and again on the card with
   `use_recompute=True`, and under 'dots' and 'dots_no_batch' against
   the CPU; a model with tied word embeddings the same way (no recompute
   and 'dots_no_batch'), and in bf16 on the card against f32 on the card
   (gradients to a relative norm error of 0.05); then two `TrainStep`s
   on each under Llama 2's AdamW recipe (global-norm clip, LinearWarmup
   around a cosine stepped after each step): the losses, and each
   parameter's update over the two steps, must agree; then two
   `TrainStep`s with `AdamW(offload='host')` and two in HBM on the card:
   parameters and moments bit-equal, every offloaded slot pinned;
5. train: the JAX bench's `llama2_7b_shape_8L` rung (Llama-2-7B width,
   8 layers, bf16, recompute, batch 2 x seq 2048, AdamW lr 3e-4 with bf16
   moments) through `TrainStep`, 2 warm-up and 6 timed steps on 4
   rotating batches, with every training kernel's launch count read
   around the timed steps and required to be > 0 (the multi-tensor Adam
   update included); then steps on one fixed batch it has not seen: the
   first loss (held out) must stay near ln(V), as no model that sees
   only past tokens can predict uniform random tokens, and the loss must
   then fall by at least OVERFIT_MIN_DROP;
5b. pretrain: the same model and rung under Llama 2's pretraining
   optimizer (AdamW 0.9/0.95/1e-5, decay 0.1 except on norms,
   ClipGradByGlobalNorm(1.0), 2000 warm-up steps into a cosine from
   3e-4 to 3e-5 over 498,000), phase 5's optimizer state freed first: 2
   warm-up and 6 timed steps, the scheduler stepped after each; each
   step's lr must be the schedule's, the loss finite, and the sum of
   squares and Adam kernels must both launch;
5c. rungs: the JAX bench's headline `gpt3_1p3b` exactly as
   bench.py:_run_config builds it (GPT-3 XL geometry on the Llama block,
   'dots_no_batch', batch 4 x 2048, bf16, AdamW lr 3e-4, bf16 moments and
   no masters above 1e9 parameters), then `llama2_7b_shape_8L` with
   'dots_no_batch' at 1 x 4096, each 2 warm-up and 6 timed steps on 4
   rotating batches (step time, tokens/s, MFU by bench.py's count over 989
   TFLOP/s, peak memory; every training kernel launched, the loss
   finite); then phase 5's rung under 'dots_no_batch' and True in 2
   interleaved pairs, and the GEMMs one backward dispatches under each
   policy (a dispatch-mode count): 'dots_no_batch' and 'dots' only the
   gradients' two per projection, True more;
5d. offload: bench.py's `llama2_7b_shape_16L` (16 layers, full
   recompute, 1 x 2048, AdamW offload='host'), 1 warm-up and 3 timed
   steps, then its in-HBM twin: every slot a pinned host tensor, the
   H2D and D2H counters moving by the slots' bytes each step, the peak
   device memory below the twin's by at least 0.9 x the slots' bytes;
   both step times logged;
5e. fault tolerance: phase 5's rung under `FaultTolerantStep(
   snapshot_interval=1)`: a batch poisoned through the loss (x NaN) rolls
   back once and is skipped, the parameters and slots bit-equal to the
   snapshot, later losses finite (the snapshot seconds logged); with
   skip_budget=0 a poisoned batch raises `SkipBudgetExhausted` after
   `skip_budget_exhausted`; a `StepWatchdog` of 0.5 s over a step slowed
   by 1.5 s fires once, emits `hang_suspected` and clears on return;
5f. fit: `Model(LlamaForCausalLM)` at Llama-2-7B width, 2 of 32 layers,
   bf16, over a shuffled `DataLoader` of seeded tokens: 8 steps of `fit`
   with `ckpt_dir` (the gitignored build/fit_ckpt, removed after),
   `ckpt_interval=4`, fault tolerance and `step_timeout`; a fresh Model
   with `resume='auto'` from the step-4 checkpoint gives steps 5-8's
   losses bit for bit;
5g. eager: phase 5's rung
   (Llama-2-7B width, 8 layers, recompute, 2 x 2048) in the canonical
   eager loop on port Tensors (`to_tensor`, `loss, _ = model(x,
   labels=y)`, `backward`, `opt.step()`, `opt.clear_grad()`), 3 steps
   from the same seeded weights and batches in each arm: O0 in f32, O1
   bf16 (step-1 loss within EAGER_O1_LOSS_RTOL of O0's), O1 fp16 under
   `GradScaler` (scale and found_inf logged, losses finite, exactly 16
   fp16 flash forwards, 8 dq and 8 dk/dv a step and no other flash
   launch), O2 bf16 through `decorate` eagerly and through
   `jit.TrainStep` (equal losses; step ms side by side: the eager API's
   host cost); every tensor freed before phase 6;
6. serve: Llama-2-7B (32 layers, bf16, random weights from a seed) behind
   the 8-slot paged engine, which replays its decode sub-step and each
   prefill bucket from captured CUDA graphs, 12 requests (prompts 13-700
   tokens, 32 new tokens; 11 greedy, 1 sampling), with every serving
   kernel's launch count read around that run (replays counted) and
   required to be > 0, and `traces` exactly one capture of the sub-step
   and of each bucket the run used; then the same requests on an engine
   that runs both uncaptured (the eager loop): every request's tokens
   must be equal, and both runs are logged side by side; then the same
   model,
   prompts and settings behind an engine with an `AdapterBank` of three
   rank-8 adapters on q/k/v/o_proj, request i under
   [base, ad0, ad1, ad2][i % 4], graph and eager alike: every request
   finishes with the same tokens in both, the adapter kernel runs
   exactly once per adapted projection of every prefill and decode
   sub-step, base requests get phase 6's tokens and adapted ones
   differ; then serve-prefix: the same model cut to CUT_LAYERS = 8 of
   its 32 layers (`serve(..., 'serve-cut')`, phase 6's seed,
   graph and eager twin, whose tokens stand for phase 6's in 6c, 6d and
   6f) behind an engine with
   `prefix_cache=0.25, prefill_chunk_tokens=256` on bench.py:stack_ab's
   shared-system-prompt trace at these lengths (a warm-up prompt of the
   512-token system prompt + 32 alone, then 16 requests: 13 suffix hits,
   the warm-up's exact repeat, two cold 900-token prompts; one sampling),
   on five engines in one process: graph (decode and prefill captured),
   eager, eager prefill (the decode graph only: the configuration before
   the prefill was captured) and two cold twins without cache or
   chunking (prefill captured and eager), each warmed by the trace once
   so its counted run captures nothing, logged side by side (hits, reused
   tokens, chunk rounds, COW splits, prompt tokens computed, prefill
   wall, TTFT, decode tok/s, the pool's peak pages, prefills by (kind,
   bucket), capture seconds, device memory held after the captures);
   graph, eager and eager-prefill tokens must be equal, hits >= 13, one
   COW split, a chunk run, the flash forward once per layer of every
   prefill and chunk, `traces` exactly the buckets run, a suffix hit's
   last logits through attached pages and the chunk forward equal to the
   same split without the cache and the whole prompt's chunk forward
   equal to a cold forward (bit for bit; the prefix path against the
   cold forward logged), and every page free after a forced clear; then
   the walls of a whole prefill at bucket 1024 and a 256-token chunk at
   start 512, captured and eager, and the device time of the captured
   chunk's whole-row gather;
6d. serve-int8: the cut model (8 of 32 layers), phase 6's requests and
   engine with
   `kv_quant='int8'`, graph and eager twin, then phase 6c's serve-prefix
   trace on the int8 prefix/chunk engine, graph and eager twin: tokens
   equal between the twins, `traces` exactly the buckets run, the paged
   kernel once per layer of every decode sub-step, the first decode
   sub-step's relative logit RMSE of phase 6's prompts against phase 6's
   bf16-KV engine at most 1.25 times the JAX bench's int8 arm's (phase
   6's engine over its pages roundtripped through int8; the bench's 0.05
   holds at its 4 layers, not at 32), every page free after a forced
   clear; pool bytes, decode tok/s, TTFT and peak used
   pages logged beside phases 6 and 6c;
6e. serve-spec: phase 6's model, requests and engine settings (k = 4,
   decode rounds of one speculation round) with two drafts in turn, the
   bench's same-width 2-layer random draft and the model itself (the
   self-draft on the cut model, 8 of 32 layers), each on
   the graph engine and its eager twin: tokens equal between the twins,
   the verify kernel once per layer of every round, `traces` exactly the
   round and the buckets run; decode tok/s, TTFT, tokens per round per
   greedy slot and the acceptance rate logged beside phase 6, and how
   many requests get phase 6's tokens (bf16: a 5-row verify can round
   differently from a 1-row step; a reading, not a gate);
6f. drain and swap (on the cut model, 8 of 32 layers, and its tokens):
   a fresh phase-6 engine: `swap_weights` to a host
   copy of the weights with one layer perturbed and `restore_weights`
   (their seconds logged), after which the 12 requests get phase 6's
   tokens; `evict_all()` after two steps hands back all 12 with every
   page free; `drain()` after two steps finishes all 12 with phase 6's
   tokens;
6g. adapter store and weight store: (a) phase 6b's wave behind a
   store-backed bank (f32, rank 8, capacity 4; its store a fresh
   directory under the gitignored `build/stores/`, removed at the end):
   ad0..ad2 published once each with 6b's factors, every request's
   tokens == 6b's through pins that load from the store; ad0 v2
   published while an ad0 request decodes (that request keeps 6b's
   tokens; a new one gets v2 in another slot, with the tokens of a fresh
   bank `load`ed with v2); a corrupt v3 quarantined while v2 keeps
   serving; a capacity-2 bank with three adapters in flight (each
   request gets its tokens alone, some admission requeued); `traces`
   unchanged after each engine's warm-up and the adapter kernel once per
   adapted projection of every prefill and decode sub-step; one publish,
   each hot load and its slot copy, the round that admits the v2 request
   beside a round that admits nothing, and the pool's and the bank's
   bytes logged. (b) the weight store at Llama-2-7B width and 2 bf16
   layers (1.33 GB a version; 32 layers would write 13.5 GB a version to
   disk) on a graph engine: `WeightPublisher` publishes v1, then a
   perturbed v2 and a v3 with one bf16 NaN; v2 is loaded, passes
   `finite_weights_gate`, is swapped in and passes a `CanaryGate` whose
   tokens come from a fresh engine on v2's weights; the gate refuses v3,
   which is quarantined (latest is v2 again), and `restore_weights` gives
   v1's tokens; publish and load GB/s, the sha256 and the swap seconds
   logged;
   then the host time of one adapted projection (hook, wrapper and
   launch) at the decode shape;
6h. observe: the serving observability layer on phase 6's graph engine
   and 12 requests (every phase runs instrumented, as
   `FLAGS_observability` defaults to on): (a) the port's HTTP server on an
   ephemeral port of 127.0.0.1, scraped at 4 Hz by a background client
   during the wave, every body parsed line by line (Prometheus
   exposition format); the serving counters of the scrapes before and
   after the wave and /summary?format=json's serving section must move
   by exactly `stats()`, the tokens must be phase 6's and nothing may be
   captured; (b) the goodput ledger's categories plus its residual
   within 1% of its wall (serving_prefill and serving_decode logged),
   every request's phase waterfall within 1% of its E2E, and the
   fair-share decode seconds within 1% of `stats()`'s decode seconds;
   /healthz 200, 503 `draining` after `begin_drain()` on an eager twin
   (phase 6's engine keeps serving later phases), still 503 after
   `drain()`, 200 after `clear_degraded('draining')`; /programs 200,
   /slo 503 (no SLO engine) and /fleet/metrics 503 (no aggregator);
   (d) a request whose admission raises fails alone and writes one
   flight bundle (flight.json naming
   `serving_request_failed`, events, trace, metrics, summary, goodput,
   requests) under a fresh PADDLE_FLIGHT_DIR; (c) decode tok/s with the
   layer off and on, 3 interleaved pairs on the engine: the least
   off/on ratio less 1 (bench.py's estimator) must stay at or below 3%
   (bench.py's guard), and the host time the layer adds to a round is
   logged;
6i. serve-fleet: replicated serving in one process on phase 6's model
   and requests: (a) the router's overhead on phase 6's engine, (b) two
   replicas, the second over its own weight copy, with (h) the roofline
   of that window, (c) failover through an injected replica loss, (d)
   QoS shedding, (e) a loadgen replay under the SLO engine onto 6b's
   banked engine, (f) the autoscaler, (g) the rolling weight swap at 2
   layers;
7. profile: one decode round with every slot busy (wall time, then a
   torch.profiler breakdown of the next round's device time) on the
   plain and on the banked engine, each replayed from its graph and run
   eagerly, a whole prefill at bucket 1024 and a 256-token chunk at start
   512 on the serve-prefix engine, each replayed from its graph and run
   eagerly (wgmma flash, no SDPA kernel; idle share against phase 6c's
   walls), and one training step (forward +
   backward, then the optimizer update, each profiled); each decode
   round must run the split-context paged kernels and RMSNorm and not
   the first design's `paged_attn_kernel` (the banked ones also the
   cluster adapter kernel and not the first design's
   `adapter_matmul_kernel`), the prefills the wgmma forward kernel, the
   training step the wgmma forward, dq and dk/dv kernels, and its update
   window (phase 5b's optimizer, then phase 5's) the multi-tensor Adam
   kernel (5b's also the sum of squares), its device ms logged beside
   the bound of the bytes the update must move (where the profiler
   recorded no event of a required kernel, the next step is profiled,
   up to 3 with pauses between, then the same profile runs in a fresh
   process on a fresh rung, `--profile-train`, up to 2, held to the same
   gates);
   then one int8 decode
   round, graph and eager, profiled in three windows (the window's
   fill, the sub-steps, the requantize of the touched pages): the
   sub-steps must run the int8 split, window and combine kernels, and
   the fill and requantize device work; then one speculation round of
   phase 6e's 2-layer-draft engine, graph (one replayed round) and eager
   (the draft sub-steps and the verify in windows of their own); then
   phase 11's T5-large: a greedy generate of 4 tokens and a training
   step (`t5_profile`), each broken down with its idle share;
6j. serve-procs (after phase 7, once the training rungs are freed:
   the parent then holds least of the card): the process fleet on
   Llama-2-7B (bf16, full width and depth). Two replica processes
   (`python -m paddle_tpu_torch.serving.replica_main`, started together
   by a `Supervisor` with `subprocess`, never a fork), each building
   phase 6's model from its seed (`replica_llama`) behind an engine of
   phase 6's settings that captures the decode round and every prefill
   bucket before it binds its socket, and ships its telemetry into a
   spool: (a) each child gives phase 6's tokens for the 12 requests, the
   sampled one too, from phase 6's weights (a parameter digest), with
   nothing captured or compiled after its ready-marks; (b) an in-process
   engine against one child, 3 interleaved pairs of the 12 requests, the
   least ratio less 1 reported beside parity (not gated); (g) the
   parent's `Aggregator`: each child's request and token counters equal
   its `stats()` and the merged ones their sum, /fleet/metrics parses,
   /fleet/trace holds each child's spans on its own process track; (c)
   a Router over both, one child SIGKILLed mid-decode: 0 lost, phase 6's
   tokens, the child respawned and serving phase 6's tokens; (d) a child
   SIGSTOPped: killed at the heartbeat deadline (PROCS_HEARTBEAT_S,
   above a full-depth swap) and respawned, events in order; (e) that
   fresh child serves phase 6's tokens with 0 captures and 0 compiles
   after its ready-marks; (h) beside (c)-(e), on a thread of its own, at
   2 of 32 layers (a full-depth version writes 13.5 GB to disk): two
   children that started with the first two boot on v1 of a weight
   store, and `RolloutLoop` runs 2 iterations (the parent's `TrainStep`
   at full width, `WeightPublisher`, `ReplicaUpdater` swapping each
   version in by version): rollouts carry the version they were
   generated under, no child captures after a swap; (f) an Autoscaler
   whose `signal_source` is a `FleetSignalSource` spawns a third
   process on a burst and drains and retires it when quiet, 0 dropped.
   The children's
   kernel launches (their `stats()`) join the kernels line; the free
   device memory is logged before each spawn; budget PROCS_BUDGET_S;
9. the GPT family (`gpt_family`, after the op sweep of 8): gpt-serve,
   GPT-3 XL (8 of its 24 layers x 2048, 16 heads x 128, bf16, random
   weights)
   behind the paged engine with its decode and prefill graphs, phase 6's
   12 requests (graph tokens == eager twin's), a wave through a bank with
   the default targets (`qkv_proj`, `out_proj`) and `generate()` greedy
   on two prompts == the engine (in f32 over the same weights), decode
   tok/s and the analytic catalog's HBM roof share logged; gpt2-serve,
   the same at GPT-2 small (12 heads x 64: the D = 64 flash and paged
   kernels); gpt-train, GPT-3 XL at 4 x 2048 bf16 with AdamW, 3 steps,
   finite losses, ms a step and MFU by `TransformerCost`; bert,
   BERT-base bf16 B=8 S=512 unmasked: an encode and 3 fine-tune steps of
   `BertForSequenceClassification` with hidden dropout on, each D = 64
   flash kernel launched once per layer and step. With int8 KV, on the
   served models (bf16, full width; GPT-2 at full depth):
   gpt2-serve-int8, GPT-2
   small with `kv_quant='int8'` and phase 6's 12 requests (graph ==
   eager twin, the D = 64 int8 paged call once per layer of every decode
   sub-step, its KV bytes beside the bf16 pool's, the first decode
   sub-step's relative logit RMSE against the bf16-KV engine at most
   1.25 x the JAX bench's int8 arm on this model), then phase 6c's
   serve-prefix trace on the int8 prefix/chunk engine (graph == eager,
   every page free after a forced clear), then a 2-layer random GPT draft
   of GPT-2 width, k = 4, over int8 KV (graph == eager; the T = 5 verify
   over int8 pages and the window at D = 64 once per layer of every
   round, the draft's float D = 64 paged kernel launched; the acceptance
   and the requests that get the plain int8 engine's tokens logged);
   gpt-serve-int8, GPT-3 XL the same way (the D = 128 int8 kernels; no
   draft). Phase 2 holds the D = 64 kernels (`head64_cases`) to their
   plain versions first;
10. fp16 (`fp16_phase`, after phase 9): a model cast to fp16 on the
   card. Llama-2-7B's width at 8 of its 32 layers (fp16, phase 6's seed)
   behind phase 6's graph engine and its eager twin with phase 6's 12
   requests, then
   phase 6b's banked wave (an f32 bank, the JAX bank's default), then
   with `kv_quant='int8'` (int8 pages, the round's window in fp16):
   graph tokens == eager tokens in every arm, every launch an fp16
   kernel's (no bf16 key rises), the first decode sub-step's logits
   finite, the int8 arm's relative logit RMSE within 1.25 x the JAX
   bench's int8 arm, the fp16 adapter kernel once per adapted projection
   of every prefill and decode sub-step; decode and prefill tok/s, TTFT
   and KV GB logged. At 4 layers of the
   same width, one f32 model's bf16 and fp16 casts: the fp16 engine's
   first-step logit RMSE against the f32 engine no larger than the bf16
   engine's. GPT-3 XL (D = 128, 8 layers) and GPT-2 small (D = 64) in
   fp16 the same
   way (no bank), each then with a 2-layer fp16 GPT draft (k = 4; over
   float KV at D = 128, the fp16 verify; over int8 KV at D = 64). An
   fp16 TrainStep at Llama-2-7B width, 2 layers, 1 x 2048, AdamW with
   fp32 masters, 3 steps: finite losses, step 1 within 1e-3 of the f32
   loss of the same weights and batch, the fp16 RMSNorm, CE and flash
   kernels launched; ms a step, MFU and the share of lm_head's gradient
   that is exactly 0 logged;
11. t5 (`t5_phase`, after phase 5g, before phase 6): a
   `FastBPETokenizer` (its merge loop in host C++, built with g++ at
   first use) trained on SURVEY.md and PAPER.md encodes 8 prompts of
   64-512 tokens of README.md, padded with their mask (every encode on
   the native path; the Python path's ids equal; both paths' ms logged);
   at T5-large width and 2 + 2 layers in f32: cached greedy == an argmax
   over uncached forwards, beam 1 == greedy, the card's logits (padded
   and unmasked) against a float64 run no further than twice the CPU's
   f32, the buckets gathered on the card == the CPU's, a self-draft
   `speculative_generate` == greedy, and a TrainStep's step-1 loss card
   == CPU to 1e-4; T5-large (24 + 24 layers, bf16, random weights)
   generates 64 tokens for the 8 prompts greedy, with 4 beams and
   sampling under a seed (tok/s, encoder ms, decoder ms per token);
   trains 3 steps (AdamW, recompute, batch 8 x 512 -> 128, no encoder
   mask) with exact launch counts a step of the RMSNorm, D = 64 flash
   forward, dq, dk/dv and CE kernels (ms a step, tokens/s, MFU, peak
   memory); t5_v1_1_base (gated, untied) forward and greedy in bf16, and
   its 2 + 2 f32 logits as T5-large's; `jit.save` of T5-large's
   `T5Model` at 2 + 2 layers, bf16, a dynamic batch, loaded without its
   class: equal to eager bit for bit at batch 4, the RMSNorm and D = 64
   flash kernels launched inside the program;
12. vision (`vision_phase`, after phase 11, before phase 6): ResNet-50
   at full width (25.6 M parameters, 224 x 224, 1000 classes, random
   weights from a seed) built on the CPU and copied to the card, one f32
   training step (Momentum 0.9, weight decay 1e-4, batch 4, BN in train
   mode, TF32 off) on each: logits, loss, BN running statistics and
   every parameter's update card == CPU within their limits; then
   trained in bf16 (O1, f32 parameters) through `Model.fit` over an
   `io.DataLoader`, batch 64, 2 warm-up and 5 timed steps (ms, images/s,
   peak memory, MFU over `conv_linear_flops`), exactly one CE forward
   and one CE backward launch a step and no RMSNorm launch; the bf16
   eval forward (images/s); one constructor of each zoo family at batch
   1, f32, card == CPU to 1e-4; `nms` over 2000 boxes, `roi_align` and
   `roi_pool` over 128 boxes, `deform_conv2d` 64 -> 64 and a 2-layer
   bidirectional LSTM with `sequence_length`, forward and backward, card
   == CPU. Phase 2 holds CE at [64 | 256, 1000] and RMSNorm at the
   redesign's shapes (`vision_cases`) to their plain versions;
6k. serve-row (after 6b): the row engine, `InferenceEngine(model,
   num_slots=8, max_length=1024, decode_block=8)` with no layout
   argument (one KV row per slot, 4.29 GB at full width, read through
   the paged kernel over its identity page table): phase 6's 12 requests
   on the graph engine and its eager twin, every request's tokens equal
   phase 6's paged engine's, phase 6's launch gates, `decode_step` and
   one `prefill_<b>` per bucket captured once; the prefix cache (0.25: 2
   retained slots) with 256-token chunks over phase 6c's trace, its
   tokens equal a row engine's with the same chunks and no cache, row
   copies = full-prompt hits, each `chunk_prefill_<b>` captured once;
   phase 6e's 2-layer draft at k = 4, the tokens equal phase 6e's paged
   speculating engine's; 8 requests of base and two adapters through
   phase 6b's bank, the tokens equal phase 6b's paged engine's and the
   adapter kernel launched; decode and prefill tok/s, TTFT, stranded
   rows and row utilization logged beside phase 6's; at most 60 s;
13. host (after phase 10): a Llama-2-7B-width 2-layer model's bf16
   state (1.3 GB) through `save_sharded` / `load_sharded` under the
   gitignored `build/`, loaded onto the card bit-equal, seconds and GB/s
   beside `save` / `load` (npz), a `CheckpointManager(backend='native')`
   save and restore; a `DataLoader(num_workers=2)` over 4 batches of 64
   x 3 x 224 x 224 uint8 images and int64 labels served by the native
   collator (no `io.native_collator` suppression) with the batches of a
   `num_workers=0` loader, batches/s of both; the same model built under
   `LazyGuard` allocates nothing, `initialize()` allocates exactly the
   eager build's bytes, and one forward launches the RMSNorm and flash
   kernels; both host libraries must build; at most 30 s;
6l. serve-kv-dtype (right after phase 6): the KV pool in another float
   dtype than the model's (`InferenceEngine(dtype=)`): phase 6's bf16
   model with `dtype='float32'` (the JAX engine's default pool, twice
   the KV bytes) on phase 6's 12 requests, graph and eager twin, every
   request's tokens and the first decode sub-step's logits equal phase
   6's bit for bit, the decode on the (bf16 q, f32 pages) kernel; then at 2 layers of
   Llama-2-7B's width a model in f32, bf16 and fp16 behind engines with
   each other pool dtype, float and int8 pages (every pair of the paged
   kernel on the path), 2 requests x 8 tokens, graph == eager, the f32 model's first decode
   sub-step within KV_DTYPE_RMSE of the port's plain path on the CPU
   with the same pool dtype; at most 30 s (phase 2 holds the 48 cases of
   those pairs, `kv_dtype_cases`, to their plain versions);
8. op sweep and timing: every case of the op library's table
   (tests/torch_op_cases.py) on the card against the CPU, the count
   logged (after 6j: the linear-algebra libraries keep their
   workspaces); then each kernel case of phase 2 timed (device time per call:
   CUDA events around calls queued behind a GPU-side sleep, which hides
   the host's launch gaps; beside it the event time of back-to-back
   calls, the host's launch rate for a small kernel), with its plain
   version, the one PyTorch call that computes the same function where
   there is one, and the card's bound for the same work; the adapter
   cases also beside a composite of several PyTorch calls, the
   multi-tensor ones beside PyTorch's nearest calls (`_foreach_norm`, the
   fused `torch.optim.AdamW`; neither computes the same function), and
   the decode ones also with L2 flushed before each call.
14. api (last, after the timing: it runs the profiler): the public API
   packages that compute on the card (`api_phase`): at Llama-2-7B's
   layer width `incubate`'s fused_rms_norm == F.rms_norm and
   fused_multi_head_attention forward and backward == its eager twin,
   each launching its kernels once, a `static` program (fc -> F.rms_norm
   -> causal attention) replayed by the Executor == the eager calls and
   launching RMSNorm and the flash forward; BERT-base's
   memory_efficient_attention (D = 64); GPT-2 small's PTQ weight-only
   (greedy generate() of 32 tokens, first-step logits within
   API_PTQ_RMSE of the float model) and 3 QAT steps (finite, falling
   loss, the CE and D = 64 flash kernels); `device.cuda`'s memory
   figures == torch.cuda's; fft, stft and sparse.matmul on the card ==
   the CPU; a profiler window whose Chrome trace names the RMSNorm and
   flash kernels; at most 45 s.
15. tail (after phase 14): the long-tail packages on the card
   (`tail_phase`): `audio`'s LogMelSpectrogram and MFCC (n_fft 2048, hop
   512, 128 mels, 40 coefficients) over 64 clips in ESC-50's format (5 s
   mono at 44.1 kHz, `datasets._SyntheticAudio` from a seed) == the same
   layers on the CPU (mel power rel norm 1e-5, log-mel 1e-3 dB within 60
   dB of the peak, 1e-2 dB below), ms a batch and clips/s;
   `text.viterbi_decode` at B 64, L 256, T 11 == the CPU (paths exactly,
   scores rel 1e-5), ms a batch; every `distribution` family drawn 1e6
   times from a CUDA generator (mean and variance within 5 standard
   errors, one seed bit-equal twice), log_prob and entropy == the CPU,
   Gamma's rsample gradient == the CPU's at the same draws; at most 30 s.
   No kernel of the port runs here.

Phases 5, 5b, 5c-5g, 11, 12 and 6 run in that order before any profiling:
once torch.profiler has run in a process, every later launch costs the
host more; 5c-5f free their rungs before phase 6, and phase 11 frees its
models; phase 11's profile windows run in phase 7. Phases 6e and
6f run right after phase 6, before 6b-6d, while only phase 6's engines
hold device memory, and free their engines; 6g runs after 6b and frees
its engines before 6c, and 6h after 6g; phase 7 builds fresh spec
engines once the serve engines are freed, and 6j runs once the training
rungs are freed too (its in-process engine of (b) runs in a process the
profiler has run in). The flight recorder writes
its bundles under the gitignored `build/flight/`.

The last lines are the card's name and power limit, a JSON line with the
kernel table, and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, published
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
                  torch.float16: 989e12,    # dense fp16 tensor cores
                  torch.float32: 67e12}     # fp32 outside the tensor cores
# kernel vs plain, per output and by the output's dtype, two readings:
# rel_max = max|kernel - plain| / max|plain| and rel_norm = |kernel -
# plain| / |plain| (Frobenius norms). A correct kernel sums in another
# order than its plain version, which moves an f32 output by about 1e-6
# of its scale; a bf16 output then differs by one bf16 ulp on a few
# elements, and the plain attention forward also rounds its
# probabilities to bf16 (as the JAX package's does), about 3e-3 of the
# output's norm. A kernel that leaves out a term (delta, the softmax
# term of CE) or is off by 2% fails the limits (tests/test_torch_smoke.py
# holds this check to such kernels on the CPU). fp16 keeps 3 more
# mantissa bits than bf16 at the same rounding points, so its limits are
# 8 times tighter, with the same headroom over its readings. The readings
# that set each limit are in PERF.md, section 2.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -6, 2 ** -7),
       torch.float16: (2 ** -9, 2 ** -10)}
REPLACES = {
    'flash_attention_fwd':
        'paddle_tpu/ops/pallas_kernels.py:89 (_flash_fwd_kernel)',
    'flash_attention_bwd_dq':
        'paddle_tpu/ops/pallas_kernels.py:226 (_flash_bwd_dq_kernel)',
    'flash_attention_bwd_dkv':
        'paddle_tpu/ops/pallas_kernels.py:272 (_flash_bwd_dkv_kernel)',
    'flash_attention_fwd_fp16':
        'paddle_tpu/ops/pallas_kernels.py:89 (_flash_fwd_kernel, fp16 under '
        'auto_cast(dtype=\'float16\'))',
    'flash_attention_bwd_dq_fp16':
        'paddle_tpu/ops/pallas_kernels.py:226 (_flash_bwd_dq_kernel, fp16)',
    'flash_attention_bwd_dkv_fp16':
        'paddle_tpu/ops/pallas_kernels.py:272 (_flash_bwd_dkv_kernel, fp16)',
    'flash_attention_fwd_d64':
        'paddle_tpu/ops/pallas_kernels.py:89 (_flash_fwd_kernel, head_dim '
        '64)',
    'flash_attention_bwd_dq_d64':
        'paddle_tpu/ops/pallas_kernels.py:226 (_flash_bwd_dq_kernel, '
        'head_dim 64)',
    'flash_attention_bwd_dkv_d64':
        'paddle_tpu/ops/pallas_kernels.py:272 (_flash_bwd_dkv_kernel, '
        'head_dim 64)',
    'paged_attention_d64':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, head_dim '
        '64)',
    'paged_attention_int8_d64':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, int8 '
        'pages at head_dim 64, with the decode round\'s float window)',
    'paged_attention_verify_int8_d64':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, k + 1 '
        'query rows over int8 pages and the window at head_dim 64; the JAX '
        'verify is a gather and dense attention, '
        'paddle_tpu/serving/engine.py:811-835)',
    'rms_norm': 'paddle_tpu/ops/pallas_kernels.py:434 (_rms_fwd_kernel)',
    'paged_attention':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel)',
    'paged_attention_int8':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, int8 '
        'pages; the float window is the JAX decode round\'s float view, '
        'paddle_tpu/serving/engine.py:698-741)',
    'paged_attention_verify':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, k + 1 '
        'query rows per slot; the JAX verify is a gather and dense '
        'attention, paddle_tpu/serving/engine.py:811-835)',
    'softmax_ce_fwd': 'paddle_tpu/ops/pallas_kernels.py:494 (_ce_fwd_kernel)',
    'softmax_ce_bwd': 'paddle_tpu/ops/pallas_kernels.py:531 (_ce_bwd_kernel)',
    'adapter_matmul':
        'paddle_tpu/ops/pallas_kernels.py:851 (_adapter_matmul_kernel)',
    'rms_norm_fp16':
        'paddle_tpu/ops/pallas_kernels.py:434 (_rms_fwd_kernel, fp16: a model '
        'cast with to(dtype=\'float16\'))',
    'softmax_ce_fwd_fp16':
        'paddle_tpu/ops/pallas_kernels.py:494 (_ce_fwd_kernel, fp16 logits: '
        'paddle_tpu/nn/functional.py:1012-1016)',
    'softmax_ce_bwd_fp16':
        'paddle_tpu/ops/pallas_kernels.py:531 (_ce_bwd_kernel, fp16 dlogits)',
    'paged_attention_fp16':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, fp16 q '
        'and pages)',
    'paged_attention_int8_fp16':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, fp16 q '
        'over int8 pages, with the decode round\'s fp16 window)',
    'paged_attention_verify_fp16':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, k + 1 '
        'fp16 query rows per slot; the JAX verify, '
        'paddle_tpu/serving/engine.py:811-835)',
    'paged_attention_fp16_d64':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, fp16 at '
        'head_dim 64)',
    'paged_attention_int8_fp16_d64':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, fp16 q '
        'over int8 pages and the fp16 window at head_dim 64)',
    'paged_attention_verify_int8_fp16_d64':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, k + 1 '
        'fp16 query rows over int8 pages and the window at head_dim 64)',
    'adapter_matmul_fp16':
        'paddle_tpu/ops/pallas_kernels.py:851 (_adapter_matmul_kernel, fp16 '
        'x: paddle_tpu/serving/adapters/apply.py:99)',
    'multi_tensor_adam':
        'no Pallas site: the Adam/AdamW update XLA fuses inside the JAX '
        'TrainStep (paddle_tpu/jit/__init__.py:269-273, '
        'paddle_tpu/optimizer/__init__.py:114-133)',
    'multi_tensor_sumsq':
        'no Pallas site: the global-norm clip XLA fuses inside the JAX '
        'TrainStep (paddle_tpu/jit/__init__.py:269-273, '
        'paddle_tpu/optimizer/__init__.py:114-133)',
}
SOURCES = {
    'flash_attention_fwd': 'paddle_tpu_torch/csrc/flash_attention.cu',
    'flash_attention_bwd_dq': 'paddle_tpu_torch/csrc/flash_attention_bwd.cu',
    'flash_attention_bwd_dkv': 'paddle_tpu_torch/csrc/flash_attention_bwd.cu',
    'flash_attention_fwd_fp16': 'paddle_tpu_torch/csrc/flash_attention.cu',
    'flash_attention_bwd_dq_fp16':
        'paddle_tpu_torch/csrc/flash_attention_bwd.cu',
    'flash_attention_bwd_dkv_fp16':
        'paddle_tpu_torch/csrc/flash_attention_bwd.cu',
    'flash_attention_fwd_d64': 'paddle_tpu_torch/csrc/flash_attention.cu',
    'flash_attention_bwd_dq_d64':
        'paddle_tpu_torch/csrc/flash_attention_bwd.cu',
    'flash_attention_bwd_dkv_d64':
        'paddle_tpu_torch/csrc/flash_attention_bwd.cu',
    'paged_attention_d64': 'paddle_tpu_torch/csrc/paged_attention_bf16.cu',
    'paged_attention_int8_d64':
        'paddle_tpu_torch/csrc/paged_attention_bf16.cu',
    'paged_attention_verify_int8_d64':
        'paddle_tpu_torch/csrc/paged_attention_bf16.cu',
    'rms_norm': 'paddle_tpu_torch/csrc/rms_norm.cu',
    'paged_attention': 'paddle_tpu_torch/csrc/paged_attention_bf16.cu',
    'paged_attention_int8':
        'paddle_tpu_torch/csrc/paged_attention_bf16.cu',
    'paged_attention_verify': 'paddle_tpu_torch/csrc/paged_attention_bf16.cu',
    'softmax_ce_fwd': 'paddle_tpu_torch/csrc/cross_entropy.cu',
    'softmax_ce_bwd': 'paddle_tpu_torch/csrc/cross_entropy.cu',
    'adapter_matmul': 'paddle_tpu_torch/csrc/adapter_matmul_bf16.cu',
    'multi_tensor_adam': 'paddle_tpu_torch/csrc/multi_tensor_adam.cu',
    'multi_tensor_sumsq': 'paddle_tpu_torch/csrc/multi_tensor_adam.cu',
    'rms_norm_fp16': 'paddle_tpu_torch/csrc/rms_norm.cu',
    'softmax_ce_fwd_fp16': 'paddle_tpu_torch/csrc/cross_entropy.cu',
    'softmax_ce_bwd_fp16': 'paddle_tpu_torch/csrc/cross_entropy.cu',
    'paged_attention_fp16': 'paddle_tpu_torch/csrc/paged_attention_fp16.cu',
    'paged_attention_int8_fp16':
        'paddle_tpu_torch/csrc/paged_attention_fp16.cu',
    'paged_attention_verify_fp16':
        'paddle_tpu_torch/csrc/paged_attention_fp16.cu',
    'paged_attention_fp16_d64':
        'paddle_tpu_torch/csrc/paged_attention_fp16.cu',
    'paged_attention_int8_fp16_d64':
        'paddle_tpu_torch/csrc/paged_attention_fp16.cu',
    'paged_attention_verify_int8_fp16_d64':
        'paddle_tpu_torch/csrc/paged_attention_fp16.cu',
    'adapter_matmul_fp16': 'paddle_tpu_torch/csrc/adapter_matmul_fp16.cu',
}
# the paged kernel's pairs of a float q and a KV pool kept in another
# float dtype (`InferenceEngine(dtype=)`): (q's dtype, the pages' or the
# int8 pool's window's)
KV_PAIRS = tuple((q, kv) for q in (torch.float32, torch.bfloat16,
                                   torch.float16)
                 for kv in (torch.float32, torch.bfloat16, torch.float16)
                 if q != kv)
_SHORT = {torch.float32: 'f32', torch.bfloat16: 'bf16', torch.float16: 'fp16'}
# their rows (`kv_dtype_cases`: D = 128, one query row a slot), each under
# its call's LAUNCHES key (`kernels.paged_key`)
for _q, _kv in ((_SHORT[q], _SHORT[kv]) for q, kv in KV_PAIRS):
    for _int8 in ('', '_int8'):
        _row = f'paged_attention{_int8}_{_q}_kv{_kv}'
        REPLACES[_row] = (
            f'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, '
            f'{_q} q over ' + (f'int8 pages with the round\'s {_kv} window'
                               if _int8 else f'{_kv} pages')
            + '; the JAX pool in the engine\'s dtype, '
            'paddle_tpu/serving/engine.py:206, 240-244, 295-296)')
        SOURCES[_row] = (f'paddle_tpu_torch/csrc/paged_attention_{_q}_kv'
                         f'{_kv}.cu')
# the kernel table's rows at phase 11's shapes (T5-large): {row: (the
# kernel's LAUNCHES key, whose launches the row reports; the shape)}
T5_ROWS = {
    'flash_attention_fwd_d64_t5': ('flash_attention_fwd_d64',
                                   'T5 cross-attention: non-causal, Sq != Sk'),
    'flash_attention_bwd_dq_d64_t5': ('flash_attention_bwd_dq_d64',
                                      'T5 cross-attention\'s backward'),
    'flash_attention_bwd_dkv_d64_t5': ('flash_attention_bwd_dkv_d64',
                                       'T5 cross-attention\'s backward'),
    'rms_norm_t5': ('rms_norm', 'T5\'s norms at width 1024'),
    'softmax_ce_fwd_t5': ('softmax_ce_fwd', 'T5\'s loss over V = 32128'),
    'softmax_ce_bwd_t5': ('softmax_ce_bwd', 'T5\'s loss over V = 32128')}
# the rows at phase 12's shapes: decode's RMSNorm (the serving path's
# most-launched kernel) and a classifier's CE over 1000 classes
VISION_ROWS = {
    'rms_norm_decode': ('rms_norm', 'decode: 8 rows of width 4096, bf16'),
    'softmax_ce_fwd_v1000': ('softmax_ce_fwd',
                             'ResNet-50\'s loss over 1000 classes'),
    'softmax_ce_bwd_v1000': ('softmax_ce_bwd',
                             'ResNet-50\'s loss over 1000 classes')}
ROW_KEYS = {**T5_ROWS, **VISION_ROWS}
REPLACES.update({row: f'{REPLACES[key]}; {shape}'
                 for row, (key, shape) in ROW_KEYS.items()})
SOURCES.update({row: SOURCES[key] for row, (key, _) in ROW_KEYS.items()})
# the tensor-core (wgmma) kernels that bf16 and fp16 inputs run on, by
# source: each template's instantiations by dtype and head width D (their
# mangled names)
WGMMA_KERNELS = {
    'flash_attention': tuple(f'flash_fwd_wgmma_kernelI{t}Li{d}E' for t in
                             ('13__nv_bfloat16', '6__half')
                             for d in (128, 64)),
    'flash_attention_bwd': tuple(
        f'flash_bwd_{k}_wgmma_kernelI{t}Li{d}E' for k in ('dq', 'dkv')
        for t in ('13__nv_bfloat16', '6__half') for d in (128, 64))}
# (sq, sk) of the flash forward on the suffix / chunk prefill path: a
# 256-token chunk after a 512-row prefix and after 768 rows, a 64-token
# suffix after 512, and an 8-token one
CHUNK_SHAPES = ((256, 768), (256, 1024), (64, 576), (8, 520))
# the rows of a slot of the serve engines (max_length): the captured chunk
# prefill gathers them all and attends to the first start + sq
SLOT_ROWS = 1024
# the device kernels of one paged_attention call
PAGED_KERNELS = ('paged_attn_split_kernel', 'paged_attn_combine_kernel')
# ... and of one call over int8 pages with the decode round's window
INT8_KERNELS = ('paged_attn_int8_split_kernel', 'paged_attn_window_kernel',
                'paged_attn_combine_kernel')
SERVE_KERNELS = ('flash_attention_fwd', 'paged_attention', 'rms_norm')
# ... over int8 pages: the paged call counts under its `_int8` key
INT8_SERVE_KERNELS = ('flash_attention_fwd', 'paged_attention_int8',
                      'rms_norm')
ADAPTER_KERNELS = SERVE_KERNELS + ('adapter_matmul',)
SPEC_KERNELS = SERVE_KERNELS + ('paged_attention_verify',)
# speculative decoding: k draft tokens a round (bench.py:372), so the
# verify's k + 1 query rows per slot
SPEC_K = 4
# Llama's projections; the bank's default targets name the JAX package's
# qkv_proj/out_proj
ADAPTER_TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')
TRAIN_KERNELS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv', 'rms_norm', 'softmax_ce_fwd',
                 'softmax_ce_bwd', 'multi_tensor_adam')
PRETRAIN_KERNELS = TRAIN_KERNELS + ('multi_tensor_sumsq',)
# training rung: the JAX bench's llama2_7b_shape_8L (bench.py:88-101,
# _run_config at :116-191)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 2, 2048, 6, 2
TRAIN_LR = 3e-4
# phase 10's fp16 TrainStep: Llama-2-7B width, 2 layers, batch 1 x 2048
FP16_TRAIN_LAYERS, FP16_TRAIN_SEQ = 2, 2048
# phase 5c: the JAX bench's headline rung, gpt3_1p3b (bench.py:41-73):
# GPT-3 XL geometry on the Llama block, 'dots_no_batch', batch 4 x 2048
GPT3_SHAPE = dict(vocab_size=50304, hidden_size=2048,
                  intermediate_size=5504, num_hidden_layers=24,
                  num_attention_heads=16, num_key_value_heads=16,
                  max_position_embeddings=4096)
GPT3_BATCH = 4
# Llama 2's pretraining optimizer (Touvron et al. 2023, section 2.2 and
# Table 1): AdamW(0.9, 0.95, eps 1e-5), decay 0.1, global-norm clip 1.0,
# 2000 warm-up steps, cosine to 10% of the peak lr
PRETRAIN_PEAK_LR, PRETRAIN_WARMUP, PRETRAIN_T_MAX = 3e-4, 2000, 498000
OVERFIT_STEPS = 10
OVERFIT_MIN_DROP = 0.5        # nats, first to last loss on one fixed batch
HELD_OUT_SLACK = 0.5          # nats below ln(V) a held-out loss may fall
# train consistency (f32, TF32 off): the loss to rel 1e-4, each gradient
# to a relative norm error of 1e-3 (fp32 sums over 128 tokens in another
# order on the card and on the CPU)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
DEV = 'cuda'


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events around the run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 20, attempts: int = 2, before=None):
    """Device ms per call of fn() without the host's launch gaps: the
    calls are queued behind a GPU-side sleep longer than the host takes
    to launch them, and CUDA events time them back to back on the device.
    With `before`, before() runs ahead of each call, untimed (e.g. writing
    a buffer larger than L2, so that fn's inputs come from device memory),
    and events around each call alone time it. None when the sleep ended
    before the host had launched them all (a call that waits for the
    device), `attempts` times with a longer sleep each time."""
    def step():
        if before is not None:
            before()
        fn()

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    launch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(launch_s, 0.25) * 4e9) + 100_000   # ~2x at ~2 GHz
    for _ in range(attempts):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(1 if before is None else iters)]
        torch.cuda._sleep(cycles)
        if before is None:
            events[0][0].record()
            for _ in range(iters):
                fn()
            events[0][1].record()
        else:
            for start, end in events:
                before()
                start.record()
                fn()
                end.record()
        queued = not events[0][0].query()   # still sleeping: no call waited
        torch.cuda.synchronize()
        if queued:
            return sum(a.elapsed_time(b) for a, b in events) / iters
        cycles *= 4
    return None


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def timed(fn):
    """(device ms per call: the calls queued behind a sleep (`queued_ms`),
    or the CUDA-event ms if the host could not keep ahead of the device;
    the CUDA-event ms of back-to-back calls, which for a small kernel is
    the host's launch rate). The profiler is not read here: in some
    processes it lost the device events of most windows, and it has read
    whole kernels at half and at 1.5 times their event time."""
    ev = time_ms(fn)
    dev = queued_ms(fn)
    if dev is None:
        log('[timing]   the host could not keep ahead of the device; '
            'taking the events')
    return (ev if dev is None else dev), ev


def device_ms(fn) -> float:
    """`timed(fn)[0]` without the back-to-back event reading it drops:
    the calls queued behind a sleep (`queued_ms`), or the CUDA-event ms
    where the host could not keep ahead of the device."""
    dev = queued_ms(fn)
    if dev is None:
        log('[timing]   the host could not keep ahead of the device; '
            'taking the events')
        return time_ms(fn)
    return dev


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name: str, got, want) -> dict:
    """{max_abs_err, rel_max, rel_norm} of the kernel's output against the
    plain version's (the worst over the outputs of a tuple, each held to
    the limits of its own dtype); raises past a limit."""
    if isinstance(got, tuple):
        parts = [compare(f'{name} [{i}]', g, w)
                 for i, (g, w) in enumerate(zip(got, want))]
        return {k: max(r[k] for r in parts) for k in parts[0]}
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f'{name}: kernel gives {got.dtype} '
                             f'{tuple(got.shape)}, plain {want.dtype} '
                             f'{tuple(want.shape)}')
    off = ~torch.isfinite(want)
    if off.any():
        got, want = overflow_matches(name, got, want, off)
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: kernel output has non-finite values')
    lim_max, lim_norm = TOL[want.dtype]
    r = readings(got, want)
    if r['rel_max'] > lim_max or r['rel_norm'] > lim_norm:
        raise AssertionError(f'{name}: kernel vs plain rel_max '
                             f'{r["rel_max"]:.3e} (limit {lim_max:.3e}), '
                             f'rel_norm {r["rel_norm"]:.3e} (limit '
                             f'{lim_norm:.3e})')
    return r


# of the plain version's infs, the share the kernel may give as a finite
# value at the edge of the dtype's range instead (or the other way): its
# sums run in another order, so a value that lands within rounding of
# the largest finite one may round the other way; a kernel that clamps
# gives the edge value at every overflow and fails
OVERFLOW_EDGE_SHARE = 0.01


def overflow_matches(name, got, want, off):
    """Where the plain output is inf or NaN (an fp16 overflow, which
    must reach the loss scaler), the kernel's must be too, never a
    clamped value; returns the elements finite in both, for the limits."""
    fmax = torch.finfo(want.dtype).max
    edge = fmax * (1 - torch.finfo(want.dtype).eps)
    same = ((torch.isposinf(got) == torch.isposinf(want))
            & (torch.isneginf(got) == torch.isneginf(want))
            & (torch.isnan(got) == torch.isnan(want)))
    near = (torch.where(torch.isfinite(got), got.abs(), 0) >= edge) \
        | (torch.where(torch.isfinite(want), want.abs(), 0) >= edge)
    excused = int((~same & near).sum())
    if bool((~same & ~near).any()) \
            or excused > OVERFLOW_EDGE_SHARE * int(off.sum()):
        raise AssertionError(
            f'{name}: kernel is not inf/NaN exactly where the plain version '
            f'is ({int((~same).sum())} of {int(off.sum())} places differ, '
            f'{excused} at the edge of the range)')
    keep = torch.isfinite(got) & torch.isfinite(want)
    return got[keep], want[keep]


def readings(got, want) -> dict:
    """{max_abs_err, rel_max, rel_norm} of `got` against `want`, in fp64."""
    got, want = got.double(), want.double()
    diff = got - want
    max_abs = float(diff.abs().max())
    return dict(max_abs_err=max_abs,
                rel_max=max_abs / max(float(want.abs().max()), 1e-30),
                rel_norm=float(diff.norm()) / max(float(want.norm()), 1e-30))


def live_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes per (batch, head): all of
    them, or with the bottom-right causal mask those at or below the
    diagonal."""
    if not causal:
        return sq * sk
    return sq * (sk - sq) + sq * (sq + 1) // 2


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def hgmma_counts(lib_path, kernels) -> dict:
    """{kernel: count of HGMMA (wgmma) instructions} in `cuobjdump -sass`
    of a built kernel library, over the functions whose symbol contains
    each of `kernels`."""
    from paddle_tpu_torch.ops import _build
    cuobjdump = str(Path(_build._nvcc()).parent / 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, owners = dict.fromkeys(kernels, 0), []
    for line in sass.splitlines():
        if 'Function : ' in line:
            owners = [k for k in kernels if k in line]
        elif 'HGMMA' in line:
            for k in owners:
                counts[k] += 1
    return counts


def build():
    """Compile every kernel source; log each kernel's registers and
    spills, and require the tensor-core kernels' libraries to hold HGMMA
    instructions."""
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f'[build] {len(logs)} kernel source(s) compiled in '
        f'{time.perf_counter() - t0:.1f} s')
    for name in _build.SOURCES:    # ptxas -v of this build or the cached one
        for line in _build.build_log(name).splitlines():
            if ('entry function' in line or 'registers' in line
                    or 'spill' in line or 'Performance Loss' in line
                    or 'compiled in' in line):
                log(f'[build] {name}: {line.strip()}')
    summaries = [(f'adapter_matmul_{x}', f'adapter_sgmv_kernel, {x} x: '
                  '{n} instantiations (bank dtype x padded rank x vector '
                  'path)') for x in ('f32', 'bf16', 'fp16')]
    summaries.append(('multi_tensor_adam', 'multi_tensor_adam.cu: {n} '
                      'kernels (param dtype x moment dtype x master x '
                      'amsgrad, the sum of squares and its finish)'))
    for source, label in summaries:
        regs, spills = [], []
        for line in _build.build_log(source).splitlines():
            if 'Used' in line and 'registers' in line:
                regs.append(int(line.split('Used')[1].split()[0]))
            elif 'spill stores' in line:
                spills.append(int(line.split('bytes spill stores')[0]
                                  .split(',')[-1]))
        log(f'[build] {label.format(n=len(regs))}, registers '
            f'{min(regs, default=0)}-{max(regs, default=0)}, spill stores '
            f'{sum(spills)} bytes in all')
    lib_dir = _build._build_dir(_build._nvcc())
    for source, kernels in WGMMA_KERNELS.items():
        counts = hgmma_counts(lib_dir / f'lib{source}.so', kernels)
        log(f'[build] {source}: HGMMA instructions per kernel {counts}')
        for fn, n in counts.items():
            if n <= 0:
                raise AssertionError(f'build: {fn} in lib{source}.so holds '
                                     f'no HGMMA instruction')


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _case_list():
    """(cases, add): `add(kernel, name, dtype, run, plain, lib, moved, ops,
    ...)` appends one kernel check to `cases`, its bound from the bytes
    moved and the operations at the peak rate of `dtype`'s arithmetic; a
    `rep` case reports the kernel table's row `row` (default: the
    kernel's LAUNCHES key)."""
    cases = []

    def add(kernel, name, dtype, run, plain, lib, moved, ops, rep=False,
            zero_rows=None, zero_base=None, yardstick=None, cold=False,
            subnormal=False, row=None):
        b_ms, by = bound_ms(moved, ops, dtype)
        cases.append(dict(kernel=kernel, name=name, dtype=dtype, run=run,
                          plain=plain, lib=lib, bound_ms=b_ms, bound_by=by,
                          rep=rep, zero_rows=zero_rows, zero_base=zero_base,
                          yardstick=yardstick, cold=cold,
                          subnormal=subnormal, row=row or kernel))
    return cases, add


def kernel_cases() -> list:
    """Every kernel check of the serving and training paths: the kernel's
    wrapper, its plain version and the one PyTorch call computing the same
    function (or None) as closures over inputs made on the card from a
    seed, at the paths' shapes, with the bytes and operations the work
    needs. `rep` marks the case each kernel's JSON entry reports;
    `zero_rows` rows whose output must equal `zero_base` bit for bit;
    `yardstick` a (label, call) of PyTorch that is timed beside the kernel
    though it is not one call of the same function; `cold` a case also
    timed with L2 flushed; `subnormal` an fp16 output whose subnormals
    are checked one by one (`check_subnormals`)."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases, add = _case_list()

    # flash attention: prefill shapes (buckets 8 .. 1024), causal, D = 128
    for dtype in (torch.float32, torch.bfloat16):
        for s, hkv in ((8, 32), (100, 32), (512, 32), (1024, 32),
                       (100, 8), (512, 8)):
            _flash_serve_case(add, gen, dtype, s, hkv,
                              rep=dtype == torch.bfloat16 and s == 1024
                              and hkv == 32)

    # flash attention at the chunk shapes: a suffix or chunk of sq queries
    # over the slot's sk = start + sq rows, causal aligned bottom-right;
    # the library's counterpart is SDPA under a lower-right causal bias
    # (is_causal=True aligns top-left, another function when sq < sk),
    # over K/V repeated to 32 heads
    from torch.nn.attention.bias import causal_lower_right
    for dtype in (torch.float32, torch.bfloat16):
        for (sq, sk), hkv in itertools.product(CHUNK_SHAPES, (32, 8)):
            q = _randn((1, sq, 32, 128), dtype, gen)
            k = _randn((1, sk, hkv, 128), dtype, gen)
            v = _randn((1, sk, hkv, 128), dtype, gen)
            qt, kt, vt = (t.transpose(1, 2) for t in
                          (q, k.repeat_interleave(32 // hkv, dim=2),
                           v.repeat_interleave(32 // hkv, dim=2)))
            add('flash_attention_fwd',
                f'flash {str(dtype)[6:]} chunk sq={sq} sk={sk} H=32 '
                f'HKV={hkv}', dtype,
                lambda q=q, k=k, v=v: K.flash_attention_fwd(q, k, v,
                                                            causal=True),
                lambda q=q, k=k, v=v: K.attention_reference(q, k, v,
                                                            causal=True),
                lambda qt=qt, kt=kt, vt=vt, sq=sq, sk=sk:
                    F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=causal_lower_right(sq, sk)),
                nbytes(q, k, v, q), 4 * 128 * 32 * live_pairs(sq, sk, True))

    # the same shapes as the captured chunk prefill calls them: sq queries
    # over the slot's whole 1024-row K/V buffer, the key count sk read
    # from device memory (seqused_k); the rows past it are NaN, so a
    # kernel that read one would fail the check. The bytes moved are the
    # rows the count covers; the library call is SDPA on them (a view)
    for dtype in (torch.float32, torch.bfloat16):
        for (sq, sk), hkv in itertools.product(CHUNK_SHAPES, (32, 8)):
            q = _randn((1, sq, 32, 128), dtype, gen)
            k = _randn((1, SLOT_ROWS, hkv, 128), dtype, gen)
            v = _randn((1, SLOT_ROWS, hkv, 128), dtype, gen)
            k[:, sk:] = float('nan')
            v[:, sk:] = float('nan')
            used = torch.tensor([sk], dtype=torch.int32, device=DEV)
            qt, kt, vt = (t.transpose(1, 2) for t in
                          (q, k[:, :sk].repeat_interleave(32 // hkv, dim=2),
                           v[:, :sk].repeat_interleave(32 // hkv, dim=2)))
            add('flash_attention_fwd',
                f'flash {str(dtype)[6:]} seqused_k chunk sq={sq} sk={sk} of '
                f'{SLOT_ROWS} rows H=32 HKV={hkv}', dtype,
                lambda q=q, k=k, v=v, u=used: K.flash_attention_fwd(
                    q, k, v, causal=True, seqused_k=u),
                lambda q=q, k=k, v=v, u=used: K.attention_reference(
                    q, k, v, causal=True, seqused_k=u),
                lambda qt=qt, kt=kt, vt=vt, sq=sq, sk=sk:
                    F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=causal_lower_right(sq, sk)),
                nbytes(q, q, used) + 2 * sk * hkv * 128 * k.element_size(),
                4 * 128 * 32 * live_pairs(sq, sk, True))

    # paged attention: decode shapes, 8 slots, context up to 1024, ps 16
    n, h, ps, p = 8, 32, 16, 64
    num_pages = n * p + 1
    table = (torch.randperm(num_pages - 1, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    lengths = torch.tensor([1024, 1000, 777, 513, 256, 100, 17, 1],
                           dtype=torch.int32, device=DEV)
    for dtype, hkv, quant in ((torch.float32, 32, False),
                              (torch.bfloat16, 32, False),
                              (torch.float32, 8, False),
                              (torch.bfloat16, 8, False),
                              (torch.float32, 32, True),
                              (torch.bfloat16, 8, True)):
        _paged_decode_case(add, gen, dtype, hkv, quant, table, lengths,
                           rep=dtype == torch.bfloat16 and hkv == 32
                           and not quant)

    _paged_window_cases(add, gen, table, lengths)
    _paged_verify_cases(add, gen)

    # RMSNorm: decode (8 rows), prefill (1024 rows) and a training batch
    # (2 x 2048 rows), width 4096
    for dtype in (torch.float32, torch.bfloat16):
        for r in (8, 1024, TRAIN_BATCH * TRAIN_SEQ):
            x = _randn((r, 4096), dtype, gen)
            w = (1 + 0.1 * torch.randn(4096, generator=gen,
                                       device=DEV)).to(dtype)
            add('rms_norm', f'rms_norm {str(dtype)[6:]} rows={r} width=4096',
                dtype,
                lambda x=x, w=w: K.rms_norm(x, w, 1e-6),
                lambda x=x, w=w: K.rms_norm_reference(x, w, 1e-6),
                lambda x=x, w=w: F.rms_norm(x, (4096,), w, 1e-6),
                nbytes(x, x, w), 4 * x.numel(),
                rep=dtype == torch.bfloat16 and r == 1024)
    _training_cases(add, gen)
    _adapter_cases(add, gen)
    return cases


def _paged_decode_case(add, gen, dtype, hkv, quant, table, lengths,
                       key='paged_attention', rep=False) -> None:
    """The paged kernel at the decode shape (8 slots, H 32, D 128, ctx
    <= 1024 by `lengths`, pages of 16 through `table`): q in `dtype` over
    pages in q's dtype, or over int8 pages with their scales (no window).
    Bytes: q, out, table, lengths, the live K/V rows (and every scale of
    the table's pages)."""
    from paddle_tpu_torch.ops import kernels as K
    n, p = table.shape
    h, ps = 32, 16
    num_pages = n * p + 1
    live_rows = int(lengths.sum())
    q = _randn((n, h, 128), dtype, gen)
    shape = (num_pages, ps, hkv, 128)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device=DEV,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=DEV,
                           dtype=torch.int8)
        ks = torch.rand((num_pages, hkv), generator=gen,
                        device=DEV) / 127 + 1e-3
        vs = torch.rand((num_pages, hkv), generator=gen,
                        device=DEV) / 127 + 1e-3
    else:
        kp, vp = _randn(shape, dtype, gen), _randn(shape, dtype, gen)
        ks = vs = None
    args = (q, kp, vp, table, lengths)
    row_bytes = hkv * 128 * kp.element_size() * 2
    add(key,
        f'paged {str(dtype)[6:]} N=8 H=32 HKV={hkv} ctx<=1024'
        + (' int8 pages' if quant else ''), dtype,
        lambda a=args, ks=ks, vs=vs: K.paged_attention(
            *a, k_scales=ks, v_scales=vs),
        lambda a=args, ks=ks, vs=vs: K.paged_attention_reference(
            *a, k_scales=ks, v_scales=vs),
        None,
        nbytes(q, q, table, lengths) + live_rows * row_bytes
        + (2 * n * p * hkv * 4 if quant else 0),
        4 * 128 * h * live_rows, rep=rep)


# the int8 decode round's window: W pages per slot at decode_block 8,
# ps 16 (`window_count`); row offsets 0, 9 and 15 of the round's first
# row in its page, a length-1 slot, and an inactive slot (its table row
# the null page) parked at the slot's last row
WINDOW_PAGES = 2
WINDOW_POS = (1023, 1001, 768, 521, 255, 96, 0, 1023)


def _paged_window_cases(add, gen, serve_table, serve_lengths, h=32, d=128,
                        hkvs=(32, 8), key='paged_attention_int8',
                        dtypes=(torch.float32, torch.bfloat16)) -> None:
    """The paged kernel over int8 pages with the decode round's float
    window (q and the window in each of `dtypes`, H query heads over
    each of `hkvs`, head_dim d): the window holds the slot's logical
    pages pos // 16 .. + 1, filled with other values than the int8 pages
    there, so a kernel that read those pages fails. Then the case phase
    8 reports under `key`: the last of `dtypes` at the serve shape of
    the decode case above (its table and lengths, the window at each
    slot's last row). Bytes: the live int8 rows below the window and
    their scales, the window's live rows in q's dtype, q, out, table,
    lengths and win_first."""
    from paddle_tpu_torch.ops import kernels as K
    n, ps, p = 8, 16, 64
    num_pages = n * p + 1
    table = (torch.randperm(num_pages - 1, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p)
    table[-1] = 0                        # the inactive slot: the null page
    pos = torch.tensor(WINDOW_POS, dtype=torch.int32, device=DEV)
    cases = [(dtype, hkv, table.contiguous(), pos, False)
             for hkv in hkvs for dtype in dtypes]
    cases.append((dtypes[-1], h, serve_table, serve_lengths - 1, True))
    width = '' if d == 128 else f' D={d}'
    for dtype, hkv, tbl, pos, rep in cases:
        lengths = (pos + 1).to(torch.int32)
        win_first = (pos // ps).to(torch.int32)
        q = _randn((n, h, d), dtype, gen)
        shape = (num_pages, ps, hkv, d)
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=DEV,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((num_pages, hkv), generator=gen, device=DEV)
                  / 127 + 1e-3 for _ in range(2))
        wshape = (n, WINDOW_PAGES, ps, hkv, d)
        kw, vw = _randn(wshape, dtype, gen), _randn(wshape, dtype, gen)
        args = (q, kp, vp, tbl, lengths)
        kw_args = dict(k_scales=ks, v_scales=vs, k_win=kw, v_win=vw,
                       win_first=win_first)
        below = int((win_first.long() * ps).sum())       # int8 rows
        in_win = int((lengths - win_first * ps).sum())   # window rows
        add(key,
            f'paged {str(dtype)[6:]} N=8 H={h} HKV={hkv}{width} int8 pages + '
            f'{str(dtype)[6:]} window W={WINDOW_PAGES} '
            + ('ctx<=1024 (serve)' if rep else
               'offsets 0/9/15, len 1, inactive slot'), dtype,
            lambda a=args, kw=kw_args: K.paged_attention(*a, **kw),
            lambda a=args, kw=kw_args: K.paged_attention_reference(*a, **kw),
            None,
            nbytes(q, q, tbl, lengths, win_first)
            + below * hkv * d * 2 + 2 * int(win_first.sum()) * hkv * 4
            + in_win * hkv * d * kw.element_size() * 2,
            4 * d * h * int(lengths.sum()), rep=rep)


# the verify's key count of query row 0 per slot at the serve shape: rows
# 510 .. 514 and 14 .. 18 cross a page boundary, 1020 .. 1024 end at the
# slot's last row
VERIFY_LENGTHS = (1020, 1000, 777, 510, 254, 100, 14, 1)


# the verify cases at D = 128: (q dtype, HKV, pages: float or int8 with
# the round's window, an inactive slot, the case phase 8 reports)
VERIFY_KINDS = ((torch.float32, 32, 'float', False, False),
                (torch.bfloat16, 32, 'float', False, True),
                (torch.float32, 8, 'float', False, False),
                (torch.bfloat16, 8, 'float', False, False),
                (torch.bfloat16, 32, 'int8_window', False, False),
                (torch.float32, 8, 'int8_window', False, False),
                (torch.bfloat16, 32, 'float', True, False))


def _paged_verify_cases(add, gen, h=32, d=128, kinds=VERIFY_KINDS,
                        key='paged_attention_verify') -> None:
    """The paged kernel over k + 1 = 5 query rows per slot (the
    speculative verify) at the serve shape (8 slots, H query heads, ctx
    <= 1024, head_dim d), each of `kinds`: f32 and bf16, over float
    pages or int8 pages with the round's window of W = window_count(5,
    16) = 2 pages (filled with other values than the pages it stands
    for), and with an inactive slot (its table row the null page, parked
    at the slot's last row). Row t of slot n sees lengths[n] + t keys.
    Bytes: the union of the rows the 5 rows see, read once (the kernel
    folds them into one block), q, out, table and lengths; with the
    window the int8 rows below it and their scales and the window's rows
    in q's dtype."""
    from paddle_tpu_torch.nlp.generation import window_count
    from paddle_tpu_torch.ops import kernels as K
    n, ps, p, t = 8, 16, 64, SPEC_K + 1
    num_pages = n * p + 1
    table = (torch.randperm(num_pages - 1, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    parked = table.clone()
    parked[-1] = 0
    lengths = torch.tensor(VERIFY_LENGTHS, dtype=torch.int32, device=DEV)
    last = [ln + t - 1 for ln in VERIFY_LENGTHS]        # keys of row T - 1
    w = window_count(t, ps)
    first = torch.div(lengths - 1, ps, rounding_mode='floor').to(torch.int32)
    width = '' if d == 128 else f' D={d}'
    for dtype, hkv, mode, inactive, rep in kinds:
        # over int8 pages the call counts under the `_int8` key
        name = key if mode == 'float' or '_int8' in key else key.replace(
            'verify', 'verify_int8')
        tbl = parked if inactive else table
        q = _randn((n, t, h, d), dtype, gen)
        shape = (num_pages, ps, hkv, d)
        kw = {}
        elt = torch.tensor([], dtype=dtype).element_size()
        if mode == 'float':
            kp, vp = _randn(shape, dtype, gen), _randn(shape, dtype, gen)
            moved = sum(last) * hkv * d * elt * 2
        else:
            kp, vp = (torch.randint(-127, 128, shape, generator=gen,
                                    device=DEV, dtype=torch.int8)
                      for _ in range(2))
            kw = dict(zip(('k_scales', 'v_scales'), (
                torch.rand((num_pages, hkv), generator=gen, device=DEV)
                / 127 + 1e-3 for _ in range(2))))
            wshape = (n, w, ps, hkv, d)
            kw.update(k_win=_randn(wshape, dtype, gen),
                      v_win=_randn(wshape, dtype, gen), win_first=first)
            below = int(first.long().sum()) * ps
            moved = (below * hkv * d * 2 + 2 * int(first.sum()) * hkv * 4
                     + (sum(last) - below) * hkv * d * elt * 2)
        args = (q, kp, vp, tbl, lengths)
        add(name,
            f'paged verify {str(dtype)[6:]} N=8 T={t} H={h} HKV={hkv}{width} '
            f'ctx<=1024' + (f' int8 pages + window W={w}'
                            if mode != 'float' else '')
            + (' inactive slot' if inactive else ''), dtype,
            lambda a=args, kw=kw: K.paged_attention(*a, **kw),
            lambda a=args, kw=kw: K.paged_attention_reference(*a, **kw),
            None,
            moved + nbytes(q, q, tbl, lengths)
            + (nbytes(first) if mode != 'float' else 0),
            4 * d * h * sum(ln + i for ln in VERIFY_LENGTHS
                            for i in range(t)), rep=rep)


def _flash_serve_case(add, gen, dtype, s, hkv, rep=False, h=32, d=128,
                      b=1, causal=True) -> None:
    """The flash forward at a prefill bucket [B, S, H, D] (HKV kv heads;
    by default [1, S, 32, 128], causal), with SDPA as the library call."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    q = _randn((b, s, h, d), dtype, gen)
    k = _randn((b, s, hkv, d), dtype, gen)
    v = _randn((b, s, hkv, d), dtype, gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    add('flash_attention_fwd' + _fp16_key(dtype) + _d64_key(d),
        f'flash {str(dtype)[6:]} ' + (f'B={b} ' if b > 1 else '')
        + f'S={s} H={h} HKV={hkv} D={d}' + ('' if causal else ' full'),
        dtype,
        lambda q=q, k=k, v=v: K.flash_attention_fwd(q, k, v, causal=causal),
        lambda q=q, k=k, v=v: K.attention_reference(q, k, v, causal=causal),
        lambda qt=qt, kt=kt, vt=vt, g=hkv != h:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=g),
        nbytes(q, k, v, q), 4 * d * h * b * live_pairs(s, s, causal),
        rep=rep)


def fp16_cases() -> list:
    """The fp16 kernels. The flash kernels, `auto_cast(dtype='float16')`'s
    path and an fp16 model's prefill and training: the forward at the
    serve bucket 1024 and at S=100 GQA, the forward with its LSE, dq and
    dk/dv at the training shape and a ragged GQA one, and a dq past
    fp16's range (inf where the plain version's is). Then the kernels of
    a model cast to fp16 (phase 10): RMSNorm at the decode, prefill and
    training rows (width 4096); CE forward and backward at the fp16
    training step's [2047, 32000] with its mean loss's g = 1/N (dlogits
    at or below fp16's subnormal range, checked one by one), with g =
    1/16 (almost all of them subnormal), at [4094, 32000] with O(1)
    gradients and ignored rows, and with logits at +-65504; the paged
    kernel at the decode shape over fp16 pages (HKV 32 and 8), over int8
    pages with the round's fp16 window (offsets 0/9/15, a length-1 slot,
    an inactive slot; the serve shape), the verify's T = 5 rows over
    fp16 pages and over int8 pages and the window; the same at GPT-2
    small's head_dim 64 (fp16 pages, int8 pages and the window, the
    verify over them); the adapter kernel's delta and fused add with an
    fp16 x over an f32 bank and over an fp16 bank at the decode, prefill
    and ragged shapes. Their ~2 GB are freed after phase 2's check and
    made again for phase 8, as `rung_cases`' (phase 6j's children leave
    the parent little room)."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(18)
    cases, add = _case_list()
    h = torch.float16
    for s, hkv in ((1024, 32), (100, 8)):
        _flash_serve_case(add, gen, h, s, hkv, rep=s == 1024)
    for b, s, hkv in ((TRAIN_BATCH, TRAIN_SEQ, 32), (1, 1000, 8)):
        _flash_train_case(add, gen, h, b, s, 32, hkv, rep=s == TRAIN_SEQ)
    _fp16_overflow_case(add, gen)

    for r in (8, 1024, FP16_TRAIN_SEQ):
        x = _randn((r, 4096), h, gen)
        w = (1 + 0.1 * torch.randn(4096, generator=gen, device=DEV)).to(h)
        add('rms_norm_fp16', f'rms_norm float16 rows={r} width=4096', h,
            lambda x=x, w=w: K.rms_norm(x, w, 1e-6),
            lambda x=x, w=w: K.rms_norm_reference(x, w, 1e-6),
            lambda x=x, w=w: F.rms_norm(x, (4096,), w, 1e-6),
            nbytes(x, x, w), 4 * x.numel(), rep=r == 1024)
    # the training step's mean loss (most dlogits round to 0, the rest to
    # subnormals), then g = 1/16, which puts almost every one of them in
    # fp16's subnormal range
    _ce_case(add, gen, h, FP16_TRAIN_SEQ - 1, 32000, rep=True,
             g_value=1 / (FP16_TRAIN_SEQ - 1))
    _ce_case(add, gen, h, 512, 32000, g_value=1 / 16)
    _ce_case(add, gen, h, TRAIN_BATCH * (TRAIN_SEQ - 1), 32000)
    _ce_case(add, gen, h, 512, 32000, near_max=True)

    n, p = 8, 64
    table = (torch.randperm(n * p, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    lengths = torch.tensor([1024, 1000, 777, 513, 256, 100, 17, 1],
                           dtype=torch.int32, device=DEV)
    for hkv in (32, 8):
        _paged_decode_case(add, gen, h, hkv, False, table, lengths,
                           key='paged_attention_fp16', rep=hkv == 32)
    _paged_window_cases(add, gen, table, lengths, dtypes=(h,),
                        key='paged_attention_int8_fp16')
    _paged_verify_cases(add, gen, kinds=(
        (h, 32, 'float', False, True), (h, 8, 'float', False, False),
        (h, 32, 'int8_window', False, False),
        (h, 32, 'float', True, False)), key='paged_attention_verify_fp16')
    _head64_fp16_paged_cases(add, gen)
    _adapter_cases(add, gen, pairs=((h, torch.float32), (h, h)),
                   key='adapter_matmul_fp16')
    return cases


def _fp16_key(dtype) -> str:
    """The fp16 flash cases report under the `_fp16` names (the wrappers'
    LAUNCHES keys)."""
    return '_fp16' if dtype == torch.float16 else ''


def _d64_key(d: int) -> str:
    """The D = 64 attention cases report under the `_d64` names (the
    wrappers' LAUNCHES keys, after any `_fp16`)."""
    return '_d64' if d == 64 else ''


def _fp16_overflow_case(add, gen) -> None:
    """An fp16 dq whose products leave fp16's range: the kernel must give
    inf exactly where the plain version does (`compare`), for GradScaler."""
    from paddle_tpu_torch.ops import kernels as K
    h = torch.float16
    q = _randn((1, 256, 32, 128), h, gen)
    k = (200 * torch.randn((1, 256, 32, 128), generator=gen,
                           device=DEV)).to(h)
    v = _randn((1, 256, 32, 128), h, gen)
    dout = (300 * torch.randn((1, 256, 32, 128), generator=gen,
                              device=DEV)).to(h)
    out, lse = K.flash_attention_fwd(q, k, v, True, return_lse=True)
    a = (q, k, v, out, lse, dout)
    add('flash_attention_bwd_dq_fp16', 'flash bwd dq fp16 past 65504 (inf)',
        h, lambda a=a: K.flash_attention_bwd_dq(*a, True)[0],
        lambda a=a: K.attention_bwd_dq_reference(*a, True)[0], None,
        nbytes(q, k, v, out, dout, lse, q), 3 * 2 * 128 * 32 * live_pairs(
            256, 256, True))


def _flash_train_case(add, gen, dtype, b, s, h, hkv, rep=False, d=128,
                      causal=True, rep_fwd=False, sk=None,
                      row_suffix='') -> None:
    """The flash forward with its LSE and the two backward kernels at
    q [B, S, H, D] over k/v [B, sk (default S), HKV, D] (D = 128 unless
    given; causal unless `causal` is False), against their plain
    versions, with SDPA (forward, and its whole backward) as the library
    call. A `rep` case reports the rows named by the kernels' keys and
    `row_suffix`."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    sk = s if sk is None else sk
    tag = (f'{str(dtype)[6:]} B={b} S={s}' + (f' Sk={sk}' if sk != s else '')
           + f' H={h} HKV={hkv} D={d} ' + ('causal' if causal else 'full'))
    key = _fp16_key(dtype) + _d64_key(d)
    q = _randn((b, s, h, d), dtype, gen)
    k = _randn((b, sk, hkv, d), dtype, gen)
    v = _randn((b, sk, hkv, d), dtype, gen)
    dout = _randn((b, s, h, d), dtype, gen)
    out, lse = K.flash_attention_fwd(q, k, v, causal, return_lse=True)
    _, delta = K.attention_bwd_dq_reference(q, k, v, out, lse, dout, causal)
    pairs = b * h * live_pairs(s, sk, causal)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=hkv != h)
    dout_t = dout.transpose(1, 2)

    def sdpa_bwd(o=sdpa_out, ins=(qt, kt, vt), g=dout_t):
        return torch.autograd.grad(o, ins, g, retain_graph=True)

    add('flash_attention_fwd' + key, f'flash fwd+lse {tag}', dtype,
        lambda q=q, k=k, v=v: K.flash_attention_fwd(
            q, k, v, causal, return_lse=True),
        lambda q=q, k=k, v=v: K.attention_reference(
            q, k, v, causal=causal, return_lse=True),
        lambda qt=qt, kt=kt, vt=vt, g=hkv != h:
            F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(),
                is_causal=causal, enable_gqa=g),
        nbytes(q, k, v, q, lse), 2 * 2 * d * pairs, rep=rep_fwd,
        row='flash_attention_fwd' + key + row_suffix)
    add('flash_attention_bwd_dq' + key, f'flash bwd dq {tag}', dtype,
        lambda a=(q, k, v, out, lse, dout):
            K.flash_attention_bwd_dq(*a, causal),
        lambda a=(q, k, v, out, lse, dout):
            K.attention_bwd_dq_reference(*a, causal),
        sdpa_bwd,
        nbytes(q, k, v, out, dout, lse, q, delta),
        3 * 2 * d * pairs, rep=rep,
        row='flash_attention_bwd_dq' + key + row_suffix)
    add('flash_attention_bwd_dkv' + key, f'flash bwd dk/dv {tag}', dtype,
        lambda a=(q, k, v, lse, delta, dout):
            K.flash_attention_bwd_dkv(*a, causal),
        lambda a=(q, k, v, lse, delta, dout):
            K.attention_bwd_dkv_reference(*a, causal),
        sdpa_bwd,
        nbytes(q, k, v, dout, lse, delta, k, v),
        4 * 2 * d * pairs, rep=rep,
        row='flash_attention_bwd_dkv' + key + row_suffix)


def _ce_case(add, gen, dtype, n, vocab, rep=False, g_value=None,
             near_max=False, row_suffix='') -> None:
    """The CE forward and backward at [n, vocab] with ignored rows, against
    their plain versions, with `F.cross_entropy` (and its backward) as the
    library call. With `g_value`, unit-scale logits and that gradient on
    every row instead (1/n: a mean loss over the rows, the training
    step's), so that fp16 dlogits p g (p ~ 1/V) fall to fp16's subnormal
    range or below it; with `near_max`, seven logits a row at fp16's
    largest value 65504 (and one at -65504 every third row). fp16 cases
    report under the `_fp16` names."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    scale = 3.0 if g_value is None else 1.0
    x = (scale * torch.randn((n, vocab), generator=gen, device=DEV)).to(dtype)
    if near_max:
        x[:, :7] = 65504.0
        x[::3, 7] = -65504.0
    lab = torch.randint(0, vocab, (n,), generator=gen, device=DEV,
                        dtype=torch.int32)
    if g_value is not None:
        g = torch.full((n,), g_value, device=DEV)
    else:
        lab[::7] = 0                    # ignored rows: safe label 0 ...
        # an O(1) upstream gradient of either sign, so that both the
        # softmax and the one-hot term of dlogits stand far above the limit
        g = torch.randn((n,), generator=gen, device=DEV)
        g[::7] = 0.0                    # ... and no gradient
    _, lse = K.softmax_cross_entropy_fwd_reference(x, lab)
    xg = x.detach().requires_grad_()
    lab64 = lab.long()
    lib_nll = F.cross_entropy(xg, lab64, reduction='none')
    tag = (f'{str(dtype)[6:]} N={n} V={vocab}'
           + ('' if g_value is None else f' g={g_value:.3g}')
           + (' logits at +-65504' if near_max else ''))
    key = _fp16_key(dtype)
    add('softmax_ce_fwd' + key, f'ce fwd {tag}', dtype,
        lambda x=x, lab=lab: K.softmax_cross_entropy_fwd(x, lab),
        lambda x=x, lab=lab: K.softmax_cross_entropy_fwd_reference(x, lab),
        lambda x=x, lab=lab64: F.cross_entropy(x, lab, reduction='none'),
        nbytes(x, lab, lse, lse), 4 * x.numel(), rep=rep,
        row='softmax_ce_fwd' + key + row_suffix)
    add('softmax_ce_bwd' + key, f'ce bwd {tag}', dtype,
        lambda a=(x, lab, lse, g): K.softmax_cross_entropy_bwd(*a),
        lambda a=(x, lab, lse, g):
            K.softmax_cross_entropy_bwd_reference(*a),
        lambda o=lib_nll, x=xg, g=g:
            torch.autograd.grad(o, x, g, retain_graph=True),
        nbytes(x, lab, lse, g, x), 4 * x.numel(), rep=rep,
        subnormal=dtype == torch.float16,
        row='softmax_ce_bwd' + key + row_suffix)


def _training_cases(add, gen) -> None:
    """The training path's kernels: flash forward with its LSE and the
    two backward kernels at the training shape (B=2, S=2048, H=32,
    causal), plus a GQA and a ragged case; the CE forward and backward
    at [4094, 32000] with ignored rows."""
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, hkv in ((TRAIN_BATCH, TRAIN_SEQ, 32), (1, 1024, 8),
                          (1, 1000, 32)):
            _flash_train_case(add, gen, dtype, b, s, 32, hkv,
                              rep=dtype == torch.bfloat16 and s == TRAIN_SEQ)
    for dtype in (torch.float32, torch.bfloat16):
        _ce_case(add, gen, dtype, TRAIN_BATCH * (TRAIN_SEQ - 1), 32000,
                 rep=dtype == torch.bfloat16)


def rung_cases() -> list:
    """The training kernels at the shapes of phase 5c's rungs, bf16: flash
    forward, dq and dk/dv at GPT-3 XL's B=4 S=2048 H=16 and the 7B rung's
    B=1 S=4096 H=32 (causal, no GQA); RMSNorm over GPT-3 XL's 8192 x 2048;
    CE forward and backward at [8188, 50304] (4 x 2047 next-token rows of
    GPT-3 XL's padded vocab). Their ~2 GB are freed after phase 2's check
    and made again for phase 8 (phase 6j's children leave the parent
    little room)."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(17)
    cases, add = _case_list()
    dtype = torch.bfloat16
    for b, s, h in ((GPT3_BATCH, TRAIN_SEQ, 16), (1, 4096, 32)):
        _flash_train_case(add, gen, dtype, b, s, h, h)
    x = _randn((GPT3_BATCH * TRAIN_SEQ, 2048), dtype, gen)
    w = (1 + 0.1 * torch.randn(2048, generator=gen, device=DEV)).to(dtype)
    add('rms_norm', f'rms_norm bf16 rows={x.shape[0]} width=2048', dtype,
        lambda x=x, w=w: K.rms_norm(x, w, 1e-6),
        lambda x=x, w=w: K.rms_norm_reference(x, w, 1e-6),
        lambda x=x, w=w: F.rms_norm(x, (2048,), w, 1e-6),
        nbytes(x, x, w), 4 * x.numel())
    _ce_case(add, gen, dtype, GPT3_BATCH * (TRAIN_SEQ - 1),
             GPT3_SHAPE['vocab_size'])
    return cases


# the head_dim-64 shapes: GPT-2 small (12 heads x 64) serves 8 slots of
# up to 1024 positions; BERT-base (12 x 64) encodes and fine-tunes at
# B=8 S=512, unmasked (bidirectional)
GPT2_HEADS, BERT_BATCH, BERT_SEQ = 12, 8, 512


def head64_cases() -> list:
    """The D = 64 kernels against their plain versions (phase 2): the
    flash forward at GPT-2 small's prefill buckets (causal) and at a
    ragged GQA length, at BERT-base's encode (B=8 S=512 H=12, full), and
    with the key count read from device memory over a 1024-row buffer
    whose rows past it are NaN; the forward with its LSE, dq and dk/dv
    at BERT-base's fine-tune (full) and a ragged causal GQA shape; in
    f32, bf16 and fp16. The paged kernel at GPT-2 small's decode (8
    slots, H 12, ctx <= 1024, ps 16) with one query row and with T = 5
    rows, f32 and bf16, and over GQA pages (HKV 4); over int8 pages
    (f32 HKV 12, bf16 HKV 4), with the round's float window
    (`_paged_window_cases`: offsets 0/9/15, a length-1 slot, an inactive
    slot; f32 and bf16, HKV 12 and 4) and the verify's T = 5 rows over
    int8 pages and the window (spans across a page boundary; bf16 HKV
    12, f32 HKV 4, f32 with an inactive slot). The bf16 BERT and GPT-2
    cases report the `_d64` rows, the bf16 serve-shape window and verify
    cases the `_int8_d64` ones."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(19)
    cases, add = _case_list()
    h, d = GPT2_HEADS, 64
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        bf = dtype == torch.bfloat16
        for s, hkv in ((8, h), (100, h), (1024, h), (1000, 4)):
            _flash_serve_case(add, gen, dtype, s, hkv, h=h, d=d)
        _flash_serve_case(add, gen, dtype, BERT_SEQ, h, h=h, d=d,
                          b=BERT_BATCH, causal=False, rep=bf)
        for sq, sk in ((256, 768), (8, 520)):
            q = _randn((1, sq, h, d), dtype, gen)
            k = _randn((1, SLOT_ROWS, h, d), dtype, gen)
            v = _randn((1, SLOT_ROWS, h, d), dtype, gen)
            k[:, sk:] = float('nan')
            v[:, sk:] = float('nan')
            used = torch.tensor([sk], dtype=torch.int32, device=DEV)
            add('flash_attention_fwd' + _fp16_key(dtype) + '_d64',
                f'flash {str(dtype)[6:]} seqused_k chunk sq={sq} sk={sk} of '
                f'{SLOT_ROWS} rows H={h} D={d}', dtype,
                lambda q=q, k=k, v=v, u=used: K.flash_attention_fwd(
                    q, k, v, causal=True, seqused_k=u),
                lambda q=q, k=k, v=v, u=used: K.attention_reference(
                    q, k, v, causal=True, seqused_k=u),
                None,
                nbytes(q, q, used) + 2 * sk * h * d * k.element_size(),
                4 * d * h * live_pairs(sq, sk, True))
        _flash_train_case(add, gen, dtype, BERT_BATCH, BERT_SEQ, h, h, d=d,
                          causal=False, rep=bf)
        _flash_train_case(add, gen, dtype, 1, 1000, h, 4, d=d)
    n, ps, p = 8, 16, 64
    num_pages = n * p + 1
    table = (torch.randperm(num_pages - 1, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    lengths = torch.tensor([1024, 1000, 777, 513, 256, 100, 17, 1],
                           dtype=torch.int32, device=DEV)
    for dtype, hkv, t in ((torch.float32, h, 1), (torch.bfloat16, h, 1),
                          (torch.bfloat16, 4, 1), (torch.float32, h, 5),
                          (torch.bfloat16, h, 5)):
        _paged_d64_float_case(add, gen, dtype, hkv, t, table, lengths,
                              rep=t == 1 and dtype == torch.bfloat16
                              and hkv == h)
    # int8 pages at D = 64 (their launches count under `_int8_d64`): a
    # decode call without a window, then with the round's window, then
    # the verify's 5 rows over int8 pages and the window
    for dtype, hkv in ((torch.float32, h), (torch.bfloat16, 4)):
        _paged_d64_int8_case(add, gen, dtype, hkv, table, lengths)
    _paged_window_cases(add, gen, table, lengths, h=h, d=d, hkvs=(h, 4),
                        key='paged_attention_int8_d64')
    _paged_verify_cases(add, gen, h=h, d=d, kinds=(
        (torch.bfloat16, h, 'int8_window', False, True),
        (torch.float32, 4, 'int8_window', False, False),
        (torch.float32, h, 'int8_window', True, False)),
        key='paged_attention_verify_int8_d64')
    return cases


def _paged_d64_float_case(add, gen, dtype, hkv, t, table, lengths,
                          rep=False) -> None:
    """The paged kernel at GPT-2 small's decode (8 slots, H 12, D 64,
    ctx <= 1024 by `lengths`, pages of 16) over pages in q's dtype, with
    t query rows a slot (t = 5: the verify, lengths less 4); reported
    under the call's LAUNCHES key."""
    from paddle_tpu_torch.ops import kernels as K
    n, p = table.shape
    h, d, ps = GPT2_HEADS, 64, 16
    num_pages = n * p + 1
    q = _randn((n, h, d) if t == 1 else (n, t, h, d), dtype, gen)
    shape = (num_pages, ps, hkv, d)
    kp, vp = _randn(shape, dtype, gen), _randn(shape, dtype, gen)
    lens = lengths - (t - 1) if t > 1 else lengths
    lens = lens.clamp(min=1).to(torch.int32)
    last = [ln + t - 1 for ln in lens.tolist()]
    args = (q, kp, vp, table, lens)
    add('paged_attention' + ('_verify' if t > 1 else '') + _fp16_key(dtype)
        + '_d64',
        f'paged {str(dtype)[6:]} N=8 T={t} H={h} HKV={hkv} D={d} '
        f'ctx<=1024', dtype,
        lambda a=args: K.paged_attention(*a),
        lambda a=args: K.paged_attention_reference(*a),
        None,
        nbytes(q, q, table, lens) + sum(last) * hkv * d
        * kp.element_size() * 2,
        4 * d * h * sum(ln + i for ln in lens.tolist() for i in range(t)),
        rep=rep)


def _paged_d64_int8_case(add, gen, dtype, hkv, table, lengths) -> None:
    """The paged kernel at GPT-2 small's decode shape over int8 pages and
    their scales, no window (its launches under `_int8_d64`)."""
    from paddle_tpu_torch.ops import kernels as K
    n, p = table.shape
    h, d, ps = GPT2_HEADS, 64, 16
    num_pages = n * p + 1
    live_rows = int(lengths.sum())
    q = _randn((n, h, d), dtype, gen)
    shape = (num_pages, ps, hkv, d)
    kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=DEV,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((num_pages, hkv), generator=gen, device=DEV)
              / 127 + 1e-3 for _ in range(2))
    args = (q, kp, vp, table, lengths)
    add('paged_attention_int8' + _fp16_key(dtype) + '_d64',
        f'paged {str(dtype)[6:]} N=8 H={h} HKV={hkv} D={d} ctx<=1024 '
        f'int8 pages', dtype,
        lambda a=args, ks=ks, vs=vs: K.paged_attention(
            *a, k_scales=ks, v_scales=vs),
        lambda a=args, ks=ks, vs=vs: K.paged_attention_reference(
            *a, k_scales=ks, v_scales=vs),
        None,
        nbytes(q, q, table, lengths) + live_rows * hkv * d * 2
        + 2 * n * p * hkv * 4,
        4 * d * h * live_rows)


def _head64_fp16_paged_cases(add, gen) -> None:
    """The fp16 paged kernels at GPT-2 small's decode shape (phase 10's
    D = 64 path): fp16 pages (HKV 12, reported, and 4), the verify's
    T = 5 rows over them, int8 pages without and with the round's fp16
    window (`_paged_window_cases`, the serve-shape case reported), and
    the verify over int8 pages and the window (reported)."""
    h, f16 = GPT2_HEADS, torch.float16
    n, p = 8, 64
    table = (torch.randperm(n * p, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    lengths = torch.tensor([1024, 1000, 777, 513, 256, 100, 17, 1],
                           dtype=torch.int32, device=DEV)
    for hkv, t in ((h, 1), (4, 1), (h, 5)):
        _paged_d64_float_case(add, gen, f16, hkv, t, table, lengths,
                              rep=t == 1 and hkv == h)
    _paged_d64_int8_case(add, gen, f16, 4, table, lengths)
    _paged_window_cases(add, gen, table, lengths, h=h, d=64, hkvs=(h, 4),
                        key='paged_attention_int8_fp16_d64', dtypes=(f16,))
    _paged_verify_cases(add, gen, h=h, d=64, kinds=(
        (f16, h, 'int8_window', False, True),
        (f16, 4, 'int8_window', False, False),
        (f16, h, 'int8_window', True, False)),
        key='paged_attention_verify_int8_fp16_d64')


def kv_dtype_cases() -> list:
    """The paged kernel over a pool in another float dtype than q's
    (phase 2): each of KV_PAIRS over float pages in that dtype, and over
    int8 pages with the decode round's window (W = 2) in it, at the serve
    shape (8 slots, ctx <= 1024, pages of 16) of Llama-2-7B (H 32, D 128)
    and of GPT-2 small (H 12, D 64), one query row a slot and the
    verify's T = 5: 48 cases. Each pair's D = 128, T = 1 case reports its
    row (its LAUNCHES key, `kernels.paged_key`)."""
    from paddle_tpu_torch.ops import kernels as K
    gen = torch.Generator(device=DEV).manual_seed(25)
    cases, add = _case_list()
    n, ps, p = 8, 16, 64
    num_pages = n * p + 1
    table = (torch.randperm(num_pages - 1, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    lengths = torch.tensor([1024, 1000, 777, 513, 256, 100, 17, 1],
                           dtype=torch.int32, device=DEV)
    for d, h in ((128, 32), (64, GPT2_HEADS)):
        for t in (1, SPEC_K + 1):
            lens = (lengths - (t - 1)).clamp(min=1).to(torch.int32)
            last = [ln + t - 1 for ln in lens.tolist()]
            first = torch.div(lens - 1, ps,
                              rounding_mode='floor').to(torch.int32)
            for qd, kvd in KV_PAIRS:
                for int8 in (False, True):
                    q = _randn((n, h, d) if t == 1 else (n, t, h, d), qd,
                               gen)
                    shape = (num_pages, ps, h, d)
                    elt = torch.tensor([], dtype=kvd).element_size()
                    kw = {}
                    if int8:
                        kp, vp = (torch.randint(
                            -127, 128, shape, generator=gen, device=DEV,
                            dtype=torch.int8) for _ in range(2))
                        kw = dict(zip(('k_scales', 'v_scales'), (
                            torch.rand((num_pages, h), generator=gen,
                                       device=DEV) / 127 + 1e-3
                            for _ in range(2))))
                        wshape = (n, WINDOW_PAGES, ps, h, d)
                        kw.update(k_win=_randn(wshape, kvd, gen),
                                  v_win=_randn(wshape, kvd, gen),
                                  win_first=first)
                        below = int(first.long().sum()) * ps
                        moved = (below * h * d * 2
                                 + 2 * int(first.sum()) * h * 4
                                 + (sum(last) - below) * h * d * elt * 2
                                 + nbytes(first))
                    else:
                        kp, vp = (_randn(shape, kvd, gen)
                                  for _ in range(2))
                        moved = sum(last) * h * d * elt * 2
                    args = (q, kp, vp, table, lens)
                    add(K.paged_key(q.dim(), int8, qd, d, kvd),
                        f'paged {_SHORT[qd]} q over '
                        + (f'int8 pages + {_SHORT[kvd]} window W='
                           f'{WINDOW_PAGES}' if int8 else
                           f'{_SHORT[kvd]} pages')
                        + f' N=8 T={t} H={h} D={d} ctx<=1024', qd,
                        lambda a=args, kw=kw: K.paged_attention(*a, **kw),
                        lambda a=args, kw=kw: K.paged_attention_reference(
                            *a, **kw),
                        None, moved + nbytes(q, q, table, lens),
                        4 * d * h * sum(ln + i for ln in lens.tolist()
                                        for i in range(t)),
                        rep=d == 128 and t == 1)
    return cases


ADAPTER_COMPOSITE = ('composite of several PyTorch calls (index_select x2, '
                     'bmm x2, casts; not one library call)')


def adapter_composite(x, a_bank, b_bank, rows, scale):
    """The adapter delta from several PyTorch calls (two index_selects, two
    bmms, casts and the scale): the nearest library yardstick, since no one
    PyTorch call computes it. Timed only; the port never calls it."""
    idx = rows.long()
    h1 = torch.bmm(x.float(), a_bank.index_select(0, idx).float())
    out = torch.bmm(h1, b_bank.index_select(0, idx).float())
    return (out * scale.index_select(0, idx)[:, None, None]).to(x.dtype)


def _adapter_cases(add, gen, pairs=((torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)),
                   key='adapter_matmul') -> None:
    """adapter_matmul (the delta) and adapter_matmul_add (y + delta, what
    the serve path's hook calls) at the serve path's shapes: decode (8
    slots, T=1) and prefill (one row, T=1024) at H = O = 4096 and rank 8,
    with rows mixing slot 0 and repeated slots, x and the bank in each of
    the (x, bank) dtype `pairs`; and a ragged case (H=4000, O=1000, rank
    16). The case reported under `key` is the decode add of the pair
    whose bank is f32 and whose x is not (the serve path's hook). y is of the
    delta's scale, so that an add that drops or doubles the delta fails.
    The bytes count the factors and scale of each distinct adapted slot
    the rows use, once (slot 0's rows read none), and x, rows and the
    output of every row. The decode cases are also timed with L2 flushed."""
    from paddle_tpu_torch.ops import kernels as K
    slots = 5
    for b, t, h, r, o, rows in ((8, 1, 4096, 8, 4096, [0, 1, 2, 1, 0, 3, 3, 1]),
                                (1, 1024, 4096, 8, 4096, [3]),
                                (6, 5, 4000, 16, 1000, [0, 2, 2, 1, 0, 4])):
        for x_dtype, w_dtype in pairs:
            x = _randn((b, t, h), x_dtype, gen)
            a = (0.05 * torch.randn((slots, h, r), generator=gen,
                                    device=DEV)).to(w_dtype)
            bb = (0.05 * torch.randn((slots, r, o), generator=gen,
                                     device=DEV)).to(w_dtype)
            a[0], bb[0] = 0, 0
            scale = torch.rand(slots, generator=gen, device=DEV) + 0.5
            scale[0] = 0.0
            y = (0.5 * torch.randn((b, t, o), generator=gen,
                                   device=DEV)).to(x_dtype)
            rows_t = torch.tensor(rows, dtype=torch.int32, device=DEV)
            used = len(set(rows) - {0})   # slot 0 reads no factors
            moved = (nbytes(x, rows_t) + b * t * o * x.element_size()
                     + used * ((h * r + r * o) * a.element_size() + 4))
            args = (x, a, bb, rows_t, scale)
            tag = (f'x {str(x_dtype)[6:]} bank {str(w_dtype)[6:]} '
                   f'B={b} T={t} H={h} R={r} O={o}')
            dtype = (x_dtype if torch.float32 not in
                     (x_dtype, w_dtype) else torch.float32)
            decode_rep = (t == 1 and x_dtype != torch.float32
                          and w_dtype == torch.float32)
            add(key, f'adapter {tag}', dtype,
                lambda a=args: K.adapter_matmul(*a),
                lambda a=args: K.adapter_matmul_reference(*a), None,
                moved, 2 * b * t * r * (h + o), zero_rows=rows_t == 0,
                zero_base=torch.zeros_like(y),
                yardstick=(ADAPTER_COMPOSITE,
                           lambda a=args: adapter_composite(*a)),
                cold=t == 1)
            add(key, f'adapter + y {tag}', dtype,
                lambda a=args, y=y: K.adapter_matmul_add(y, *a),
                lambda a=args, y=y: K.adapter_matmul_add_reference(y, *a),
                None, moved + nbytes(y), 2 * b * t * r * (h + o),
                rep=decode_rep, zero_rows=rows_t == 0, zero_base=y,
                yardstick=(ADAPTER_COMPOSITE, lambda a=args, y=y:
                           y + adapter_composite(*a)),
                cold=t == 1)


FOREACH_NORM = ('torch._foreach_norm, then the sum of the squared norms '
                '(not the same function: a norm per tensor; library_ms null)')
FUSED_ADAMW = ('torch.optim.AdamW(fused=True) on the same tensors (not the '
               'same function: epsilon inside the bias correction, no clip '
               'scale; library_ms null)')


def rung_tensor_shapes(cfg) -> list:
    """[(name, shape)] of one decoder layer of `cfg` plus lm_head, named
    and laid out as the port's Llama holds them (Linear weights [in, out])."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_attention_heads * cfg.head_dim, \
        cfg.num_key_value_heads * cfg.head_dim
    return [('self_attn.q_proj.weight', (h, q)),
            ('self_attn.k_proj.weight', (h, kv)),
            ('self_attn.v_proj.weight', (h, kv)),
            ('self_attn.o_proj.weight', (q, h)),
            ('mlp.gate_proj.weight', (h, inter)),
            ('mlp.up_proj.weight', (h, inter)),
            ('mlp.down_proj.weight', (inter, h)),
            ('input_layernorm.weight', (h,)),
            ('post_attention_layernorm.weight', (h,)),
            ('lm_head.weight', (h, cfg.vocab_size))]


def optimizer_cases() -> list:
    """The multi-tensor kernels at the training rung's tensors: one
    decoder layer of Llama-2-7B width plus lm_head (333.5 M elements),
    bf16 grads whose global norm (~180) puts phase 5b's clip of 1.0 at a
    scale below 1. The sum of squares; and one AdamW step of phase 5b's
    settings (step 10, lr 3e-4, decay 0.1 except on norms) in four
    variants: bf16 params and moments under the clip (the rung's, the
    JSON row), the same with amsgrad and no clip, and bf16 params with
    fp32 masters and moments, with the clip and with amsgrad; then fp16
    params and grads (the bf16 grads rounded to fp16) with fp32 masters
    and moments under the clip, phase 10's fp16 TrainStep. The kernel
    and the plain version each update their own copy of the same state
    in place and return it; every output is compared."""
    from paddle_tpu_torch.nlp import LlamaConfig
    from paddle_tpu_torch.ops import kernels as K
    shapes = rung_tensor_shapes(LlamaConfig.llama2_7b())
    gen = torch.Generator(device=DEV).manual_seed(8)
    cases, add = _case_list()
    grads = [(0.01 * torch.randn(s, generator=gen, device=DEV)).bfloat16()
             for _, s in shapes]
    n = sum(g.numel() for g in grads)
    add('multi_tensor_sumsq', f'sumsq bf16 grads, one layer + lm_head '
        f'({n / 1e6:.1f} M)', torch.float32,
        lambda: K.multi_tensor_sumsq(grads),
        lambda: K.multi_tensor_sumsq_reference(grads), None,
        nbytes(*grads) + 4, 2 * n, rep=True,
        yardstick=(FOREACH_NORM, lambda: torch.stack(
            torch._foreach_norm(grads)).square().sum()))
    clip = torch.clamp_max(1.0 / K.multi_tensor_sumsq(grads).sqrt()
                           .clamp_min(1e-12), 1.0)
    if not float(clip) < 1.0:
        raise AssertionError(f'optimizer cases: clip scale {float(clip)}')
    lr, t = np.float32(PRETRAIN_PEAK_LR), np.float32(10)
    lr_t = lr * np.sqrt(np.float32(1) - np.power(np.float32(0.95), t)) \
        / (np.float32(1) - np.power(np.float32(0.9), t))
    kw = dict(lr_t=float(lr_t), beta1=0.9, beta2=0.95, epsilon=1e-5,
              decay=[0.0 if 'norm' in name else float(lr * np.float32(0.1))
                     for name, _ in shapes], decay_mode='decoupled')

    def make_state(m_dtype, master, ams, p_dtype=torch.bfloat16):
        """(params, m, v, masters, vmax) as after some steps, the same
        values at every call."""
        g = torch.Generator(device=DEV).manual_seed(9)

        def rand(shape, dtype, scale, positive=False):
            x = scale * torch.randn(shape, generator=g, device=DEV)
            return (x.abs() if positive else x).to(dtype)

        ps = [rand(s, p_dtype, 0.02) for _, s in shapes]
        return (ps, [rand(s, m_dtype, 1e-3) for _, s in shapes],
                [rand(s, m_dtype, 1e-4, True) for _, s in shapes],
                [p.float() for p in ps] if master else [None] * len(ps),
                [rand(s, m_dtype, 1e-4, True) for _, s in shapes] if ams
                else None)

    def step(fn, state, scale, gs):
        ps, m, v, masters, vmax = state
        fn(ps, gs, m, v, masters, vmax or [None] * len(ps),
           clip_scale=scale, **kw)
        return tuple(x for ts in (ps, m, v, masters, vmax or ())
                     for x in ts if x is not None)

    grads16 = [g.half() for g in grads]
    for p_dtype, m_dtype, master, ams in (
            (torch.bfloat16, torch.bfloat16, False, False),
            (torch.bfloat16, torch.bfloat16, False, True),
            (torch.bfloat16, torch.float32, True, False),
            (torch.bfloat16, torch.float32, True, True),
            (torch.float16, torch.float32, True, False)):
        scale = None if ams else clip
        gs = grads16 if p_dtype == torch.float16 else grads
        mine, ref = (make_state(m_dtype, master, ams, p_dtype)
                     for _ in range(2))
        moved = (2 * nbytes(*(x for ts in mine[1:] if ts for x in ts
                              if x is not None))
                 + nbytes(*mine[0]) * (1 if master else 2) + nbytes(*gs)
                 + (4 if scale is not None else 0))
        tag = (f'adam {str(p_dtype)[6:]} params, {str(m_dtype)[6:]} moments'
               + (', fp32 masters' if master else '')
               + (', amsgrad' if ams else ', global clip scale < 1')
               + f', one layer + lm_head ({n / 1e6:.1f} M)')
        rep = m_dtype == torch.bfloat16 and not ams
        yard = None
        if rep:
            held = [torch.nn.Parameter(p.clone()) for p in mine[0]]
            for p, gr in zip(held, grads):
                p.grad = gr
            fused = torch.optim.AdamW(held, lr=PRETRAIN_PEAK_LR,
                                      betas=(0.9, 0.95), eps=1e-5,
                                      weight_decay=0.1, fused=True)
            yard = (FUSED_ADAMW, fused.step)
        add('multi_tensor_adam', tag, torch.float32,
            lambda st=mine, sc=scale, gs=gs: step(K.multi_tensor_adam, st,
                                                  sc, gs),
            lambda st=ref, sc=scale, gs=gs: step(
                K.multi_tensor_adam_reference, st, sc, gs),
            None, moved, 15 * n, rep=rep, yardstick=yard)
    return cases


def check_kernels(cases) -> None:
    """Hold every kernel against its plain version, and adapter rows on
    slot 0 to an exact zero delta (y bit for bit with the add; fatal on a
    miss)."""
    for c in cases:
        got = c['run']()
        r = compare(c['name'], got, c['plain']())
        if c['zero_rows'] is not None:
            rows = c['zero_rows']
            if not torch.equal(got[rows], c['zero_base'][rows]):
                raise AssertionError(f'{c["name"]}: rows on slot 0 are not '
                                     f'left unchanged (delta not exactly 0)')
            log(f'[kernels] {c["name"]}: {int(rows.sum())} rows on slot 0 '
                f'bit-equal to ' + ('y' if c['zero_base'].any()
                                    else 'zero'))
        if c['subnormal']:
            check_subnormals(c['name'], got, c['plain']())
        c['max_abs_err'] = r['max_abs_err']
        log(f'[kernels] {c["name"]}: max_abs_err {r["max_abs_err"]:.3e} '
            f'rel_max {r["rel_max"]:.3e} rel_norm {r["rel_norm"]:.3e}')


# fp16's subnormal spacing (2^-24), and how far the count of an fp16
# output's nonzero subnormals may stray from the plain version's: their
# exp runs in another implementation, and a value within an f32 ulp of a
# rounding midpoint may round the other way
FP16_SUBNORMAL_STEP = 2.0 ** -24
SUBNORMAL_COUNT_SHARE = 0.005


def check_subnormals(name, got, want) -> None:
    """An fp16 output's subnormals kept as the plain version keeps them
    (`.to(torch.float16)`, no flush to zero): as many nonzero ones to
    SUBNORMAL_COUNT_SHARE, each within one subnormal step where both are
    subnormal (the relative limits of `compare` cannot see them: they
    lie below 2^-14 of an output whose largest values are ~1). Logs the
    share of the output that is subnormal."""
    tiny = torch.finfo(torch.float16).tiny
    sub = (got != 0) & (got.abs() < tiny)
    want_sub = (want != 0) & (want.abs() < tiny)
    n, n_want = int(sub.sum()), int(want_sub.sum())
    both = sub & want_sub
    step = float((got[both].float() - want[both].float()).abs().max()) \
        if bool(both.any()) else 0.0
    log(f'[kernels] {name}: {n} nonzero subnormal outputs ({n_want} in the '
        f'plain version, {n_want / want.numel():.4f} of the output), '
        f'largest difference between them {step:.3e}; exact zeros '
        f'{int((got == 0).sum())} (plain {int((want == 0).sum())})')
    if abs(n - n_want) > SUBNORMAL_COUNT_SHARE * max(n_want, 1) \
            or step > FP16_SUBNORMAL_STEP:
        raise AssertionError(f'{name}: fp16 subnormals not kept as the '
                             f'plain version keeps them ({n} vs {n_want}, '
                             f'largest difference {step:.3e})')


def time_kernels(cases) -> dict:
    """Time every case; returns {kernel: its JSON entry's numbers}. Runs
    last: once torch.profiler has run in a process, every later launch
    costs the host more, so the serve phase and the unprofiled decode
    round are measured before any profiler use."""
    rows = {}
    # written before each cold call: more than the H100's 50 MB of L2
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for c in cases:
        ms, ev = timed(c['run'])
        plain = device_ms(c['plain'])
        lib = device_ms(c['lib']) if c['lib'] is not None else None
        log(f'[timing] {c["name"]}: kernel {ms:.4f} ms (events {ev:.4f})  '
            f'plain {plain:.4f} ms  library '
            + (f'{lib:.4f} ms' if lib is not None else 'none')
            + f'  bound {c["bound_ms"]:.4f} ms ({c["bound_by"]})')
        if c['yardstick'] is not None:
            label, call = c['yardstick']
            log(f'[timing]   {c["name"]}: {label} {timed(call)[0]:.4f} ms')
        if c['cold']:
            cold = queued_ms(c['run'], before=flush.zero_)
            log(f'[timing]   {c["name"]}: kernel with L2 flushed before '
                f'each call ' + (f'{cold:.4f} ms' if cold is not None else
                                 'not measured (the host fell behind)'))
        if c['rep']:
            rows[c['row']] = dict(
                shape=c['name'], max_abs_err=c['max_abs_err'], ms=ms,
                plain_ms=plain, bound_ms=c['bound_ms'],
                bound_by=c['bound_by'], library_ms=lib)
    return rows


# ---------------------------------------------------------------------------
# phase 3: paged engine against a no-cache full recompute
# ---------------------------------------------------------------------------

def check_consistency(cfg):
    """The graph engine's greedy tokens equal a no-cache full recompute;
    with a seeded sampling request added, its eager twin (decode and
    prefill uncaptured) gives the same tokens."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import (SAMPLING, InferenceEngine,
                                          SamplingParams)
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(0, DEV))
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in (5, 16, 37, 130)]
    n_new = 16
    handles = eng.generate_many(
        prompts, SamplingParams(max_new_tokens=n_new, eos_token_id=-1))
    with torch.inference_mode():
        for h, prompt in zip(handles, prompts):
            seq = list(prompt)
            for _ in range(n_new):
                logits = model(torch.tensor([seq], device=DEV))
                seq.append(int(logits[0, -1].argmax()))
            ref = seq[len(prompt):]
            if h.tokens != ref:
                raise AssertionError(
                    f'consistency: prompt len {len(prompt)}: engine '
                    f'{h.tokens} != full recompute {ref}')
    log(f'[consistency] 2 layers f32, {len(prompts)} requests x {n_new} '
        f'greedy tokens: paged engine == no-cache full recompute')
    params = [SamplingParams(max_new_tokens=n_new, eos_token_id=-1)
              for _ in prompts] + [SamplingParams(
                  max_new_tokens=n_new, eos_token_id=-1, strategy=SAMPLING,
                  temperature=0.8, top_p=0.9, seed=5)]
    graph_equals_eager(eng, prompts + prompts[2:3], params, 'consistency')
    del eng, model
    torch.cuda.empty_cache()


def causal_lm(cfg):
    """The port's causal LM class for a config: GPT for a `GPTConfig`,
    else Llama."""
    from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM,
                                      LlamaForCausalLM)
    return GPTForCausalLM if isinstance(cfg, GPTConfig) else LlamaForCausalLM


def check_int8_consistency(cfg, label: str = ''):
    """With `kv_quant='int8'` at 2 layers in f32 (a Llama, or a GPT for a
    `GPTConfig`; `label` tells the log lines apart): the graph engine's
    tokens equal its eager twin's, greedy and with a seeded sampling
    request; the same with the prefix cache and chunked prefill over the
    serve-prefix trace's paths (suffix hits in chunks, a cold prompt in
    four chunks, a full hit with its COW split); and every page is free
    after a forced clear. The first decode sub-step's logits of phase 6's
    prompts must equal, to INT8_EXACT, those of the float engine over
    its pages roundtripped through int8 (the JAX bench's int8 arm), and
    lie within INT8_RMSE_BOUND of float KV. The greedy tokens against
    float KV are logged (int8 rounding may move an argmax)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.serving import (SAMPLING, InferenceEngine,
                                          SamplingParams)
    tag, ptag = f'int8-consistency{label}', f'int8-prefix-consistency{label}'
    model = causal_lm(cfg)(cfg, device=DEV, dtype='float32',
                           generator=ptt.generator(0, DEV))
    rng = np.random.RandomState(1)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in (5, 16, 37, 130)]
    greedy = SamplingParams(max_new_tokens=16, eos_token_id=-1)
    params = [greedy] * len(prompts) + [SamplingParams(
        max_new_tokens=16, eos_token_id=-1, strategy=SAMPLING,
        temperature=0.8, top_p=0.9, seed=5)]
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16, kv_quant='int8')
    got = graph_equals_eager(eng, prompts + prompts[2:3], params, tag)
    dense = InferenceEngine(model, num_slots=8, max_length=1024,
                            decode_block=8, kv_page_size=16)
    ref = [h.tokens for h in dense.generate_many(prompts, greedy)]
    same = sum(a == b for a, b in zip(got, ref))
    log(f'[{tag}] {same} of {len(prompts)} greedy requests get '
        f'the float-KV engine\'s 16 tokens')
    # the first decode sub-step of phase 6's prompts: the int8 engine
    # against the float engine over its pages roundtripped through int8
    # (the JAX bench's int8 arm), and against float KV
    rng = np.random.RandomState(2)
    serve_prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
                     for s in SERVE_LENS]
    q = first_step_logits(eng, serve_prompts)
    f = first_step_logits(dense, serve_prompts)
    rt = first_step_logits(dense, serve_prompts, roundtrip=True)
    exact, rmse = rel_rmse(q, rt), rel_rmse(q, f)
    log(f'[{tag}] first decode sub-step of {len(serve_prompts)} '
        f'prompts: relative logit RMSE {exact:.3e} against the float engine '
        f'over int8-roundtripped pages (limit {INT8_EXACT}), {rmse:.4e} '
        f'against float KV (the JAX bench\'s bound {INT8_RMSE_BOUND}; the '
        f'roundtripped pages: {rel_rmse(rt, f):.4e})')
    if not (exact <= INT8_EXACT and rmse <= INT8_RMSE_BOUND):
        raise AssertionError(f'{tag}: relative logit RMSE '
                             f'{exact:.3e} against the roundtripped pages, '
                             f'{rmse:.4e} against float KV')
    del eng, dense
    warm, trace = prefix_trace(cfg.vocab_size, np.random.RandomState(6))
    prompts = [trace[i] for i in (0, 3, 5, 6, 11)]
    params = [greedy] * len(prompts)
    params[1] = SamplingParams(max_new_tokens=16, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=3)
    eng = InferenceEngine(model, **PREFIX_ENGINE, **PREFIX_OPTS,
                          kv_quant='int8')
    twin = eager_twin(eng, **PREFIX_OPTS)
    runs = []
    for e in (eng, twin):
        e.generate_many([warm], greedy)
        runs.append([h.tokens for h in e.generate_many(prompts, params)])
        st = e.stats()
        if st['prefix_cache']['hits'] < 4 or st['pool']['cow_splits'] != 1 \
                or st['chunk_rounds'] < 7:
            raise AssertionError(
                f'{ptag}: hits '
                f'{st["prefix_cache"]["hits"]}, COW '
                f'{st["pool"]["cow_splits"]}, chunk rounds '
                f'{st["chunk_rounds"]}: the trace missed a path')
        pages_free_after_clear(e, ptag)
    if runs[0] != runs[1]:
        raise AssertionError(f'{ptag}: graph engine '
                             f'{runs[0]} != eager twin {runs[1]}')
    log(f'[{ptag}] 2 layers f32, int8 KV, {len(prompts)} '
        f'requests x 16 tokens (suffix hits in chunks, a cold prompt in '
        f'chunks, a full hit with its COW split, one sampling): graph '
        f'engine (captures {eng.stats()["traces"]}) == its eager twin')
    del eng, twin, model
    torch.cuda.empty_cache()


def adapter_bank(model, n_adapters: int, capacity: int, scale: float = 0.02):
    """An f32 rank-8 bank on Llama's q/k/v/o projections holding
    ad0..ad{n-1}, with factors `make_adapter_factors(bank, seed=i + 1)`."""
    from paddle_tpu_torch.serving import AdapterBank, make_adapter_factors
    bank = AdapterBank(model, capacity=capacity, rank=8,
                       targets=ADAPTER_TARGETS, dtype='float32')
    for i in range(n_adapters):
        bank.load(f'ad{i}', make_adapter_factors(bank, seed=i + 1,
                                                 scale=scale))
    return bank


def check_adapter_consistency(cfg):
    """The tests/test_adapters.py acceptance bar on the card, at 2
    layers of Llama-2-7B width in f32, greedy: in a mixed wave
    [base, ad0, ad1, ad0] each request gets the tokens it gets served
    alone under its adapter (fresh engine and bank), base requests those
    of a bank-less engine, and the adapters change some tokens. Factors
    at scale 0.05, large enough to move greedy tokens at this depth."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(7, DEV))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in (5, 16, 37, 130)]
    ids = [None, 'ad0', 'ad1', 'ad0']
    sp = SamplingParams(max_new_tokens=16, eos_token_id=-1)

    def tokens(adapter_ids, banked=True, graph=True):
        eng = InferenceEngine(
            model, num_slots=8, max_length=1024, decode_block=8,
            kv_page_size=16,
            adapter_bank=adapter_bank(model, 2, 2, 0.05) if banked else None)
        eng._capture_decode = eng._capture_prefill = graph
        return [h.tokens for h in eng.generate_many(prompts, sp,
                                                    adapter_ids=adapter_ids)]

    base = tokens(None, banked=False)
    alone = {aid: tokens(aid) for aid in ('ad0', 'ad1')}
    mixed = tokens(ids)
    if tokens(ids, graph=False) != mixed:
        raise AssertionError('adapter consistency: the mixed wave on the '
                             'eager twin differs from the graph engine')
    for j, aid in enumerate(ids):
        want = base[j] if aid is None else alone[aid][j]
        if mixed[j] != want:
            raise AssertionError(f'adapter consistency: request {j} under '
                                 f'{aid}: mixed wave {mixed[j]} != '
                                 f'{"bank-less" if aid is None else "alone"}'
                                 f' {want}')
    changed = sum(alone[aid][j] != base[j] for aid in alone
                  for j in range(len(prompts)))
    if not changed:
        raise AssertionError('adapter consistency: no adapter changed a '
                             'token')
    log(f'[adapter-consistency] 2 layers f32, mixed wave {ids} x 16 greedy '
        f'tokens == each adapter alone == the eager twin\'s, base == '
        f'bank-less engine; {changed} of {2 * len(prompts)} adapted '
        f'requests differ from base')
    del model
    torch.cuda.empty_cache()


def perturbed_state(model, scale: float = 0.05) -> dict:
    """A host (CPU) copy of `model`'s state with layer 0's MLP down
    projection moved by `scale` times a seeded normal draw: weights a
    swap can publish."""
    state = {k: v.detach().to('cpu', copy=True)
             for k, v in model.state_dict().items()}
    w = state['llama.layers.0.mlp.down_proj.weight']
    gen = torch.Generator().manual_seed(0)
    w += (scale * torch.randn(w.shape, generator=gen)).to(w.dtype)
    return state


def draft_config(cfg, layers: int):
    """The target's config cut to `layers` layers: a same-width draft, as
    the JAX bench builds it (bench.py:366)."""
    return type(cfg)(**{**cfg.__dict__, 'num_hidden_layers': layers})


def spec_traces(eng, whole, draft, chunk=()) -> dict:
    """The `traces` of a speculating graph engine that ran whole prefills
    at the buckets `whole`, draft prefills at `draft` and chunks at
    `chunk`."""
    return {eng._decode_name: 1,
            **{f'paged_prefill_{b}': 1 for b in whole},
            **{f'draft_prefill_{b}': 1 for b in draft},
            **{f'paged_chunk_prefill_{b}': 1 for b in chunk}}


def check_spec_consistency(cfg) -> None:
    """Speculative decoding (k = SPEC_K) at 2 layers of Llama-2-7B width in
    f32: with an independent 1-layer draft and with the target as its own
    draft, the graph engine's tokens equal its eager twin's and the plain
    engine's (greedy, and a seeded sampling request, which draws one token
    a round from the verify's first row with its own generator); the
    same with int8 KV, with the prefix cache and chunked prefill, and
    behind a bank of two adapters; `traces` exactly the round and the
    prefill and draft-prefill buckets run. Then on the graph engine: a
    swap to perturbed weights and a restore give the pre-swap tokens bit
    for bit with `traces` unchanged; `evict_all()` after a step hands
    every request back with every page free; `drain()` after a step
    finishes every accepted request, one parked mid-chunk included, with
    the plain engine's tokens."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import (FINISHED, SAMPLING,
                                          InferenceEngine, SamplingParams)
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(0, DEV))
    draft = LlamaForCausalLM(draft_config(cfg, 1), device=DEV,
                             dtype='float32', generator=ptt.generator(8, DEV))
    rng = np.random.RandomState(1)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in (5, 16, 37, 130)]
    greedy = SamplingParams(max_new_tokens=16, eos_token_id=-1)
    sampled = SamplingParams(max_new_tokens=16, eos_token_id=-1,
                             strategy=SAMPLING, temperature=0.8, top_p=0.9,
                             seed=5)
    prompts, params = prompts + prompts[2:3], [greedy] * 4 + [sampled]
    kw = dict(num_slots=8, max_length=1024, kv_page_size=16)
    spec_kw = dict(num_draft_tokens=SPEC_K, **kw)
    buckets = sorted({8, 16, 64, 256})        # the buckets of the prompts

    def plain_tokens(prompts, params, ids=None, **opts):
        return [h.tokens for h in InferenceEngine(
            model, decode_block=8, **kw, **opts).generate_many(
                prompts, params, adapter_ids=ids)]

    for quant in (None, 'int8'):
        want = plain_tokens(prompts, params, kv_quant=quant)
        for label, d in (('independent 1-layer draft', draft),
                         ('self-draft', model)):
            if quant and d is model:
                continue
            tag = f'spec-consistency ({label}' + (', int8 KV)' if quant
                                                  else ')')
            eng = InferenceEngine(model, draft_model=d, kv_quant=quant,
                                  **spec_kw)
            got = graph_equals_eager(eng, prompts, params, tag)
            # over int8 pages the verify's rejected rows enter each touched
            # page's requantize scale (as in the JAX engine), so the plain
            # engine's tokens are a reading there, not a gate
            same = sum(a == b for a, b in zip(got, want))
            if got != want and not quant:
                raise AssertionError(f'{tag}: spec engine {got} != plain '
                                     f'engine {want}')
            if eng.stats()['traces'] != spec_traces(eng, buckets, buckets):
                raise AssertionError(f'{tag}: captures '
                                     f'{eng.stats()["traces"]}')
            log(f'[{tag}] 2 layers f32, {len(prompts)} requests x 16 tokens '
                f'(one sampling): {same} of {len(prompts)} equal the plain '
                f'engine\'s; spec {eng.stats()["spec"]}')
    # the prefix cache and chunked prefill: suffix hits in chunks, a cold
    # prompt in four chunks, a full hit with its COW split
    warm, trace = prefix_trace(cfg.vocab_size, np.random.RandomState(6))
    pre = [trace[i] for i in (0, 3, 5, 6, 11)]
    pre_params = [greedy] * len(pre)
    pre_params[1] = sampled
    want = [h.tokens for h in InferenceEngine(
        model, decode_block=8, **kw).generate_many(pre, pre_params)]
    eng = InferenceEngine(model, draft_model=draft, **PREFIX_OPTS, **spec_kw)
    eng.generate_many([warm], greedy)
    runs = []
    for e in (eng, eager_twin(eng, **PREFIX_OPTS)):
        if e is not eng:
            e.generate_many([warm], greedy)
        runs.append([h.tokens for h in e.generate_many(pre, pre_params)])
        st = e.stats()
        if st['prefix_cache']['hits'] < 4 or st['pool']['cow_splits'] != 1 \
                or st['chunk_rounds'] < 7:
            raise AssertionError(
                f'spec prefix consistency: hits {st["prefix_cache"]["hits"]}'
                f', COW {st["pool"]["cow_splits"]}, chunk rounds '
                f'{st["chunk_rounds"]}: the trace missed a path')
        pages_free_after_clear(e, 'spec-prefix-consistency')
    if not runs[0] == runs[1] == want:
        raise AssertionError(f'spec prefix consistency: graph {runs[0]}, '
                             f'eager {runs[1]}, plain {want}')
    log(f'[spec-prefix-consistency] {len(pre)} requests (suffix hits in '
        f'chunks, a cold prompt in chunks, a full hit, one sampling): graph '
        f'(captures {eng.stats()["traces"]}) == eager == the plain engine')
    del eng, runs
    # behind a bank: the verify runs under the adapters, the draft not
    ids = [None, 'ad0', 'ad1', 'ad0', None]
    bank = adapter_bank(model, 2, 2, 0.05)
    want = plain_tokens(prompts, params, adapter_bank=bank, ids=ids)
    eng = InferenceEngine(model, draft_model=draft, adapter_bank=bank,
                          **spec_kw)
    got = [h.tokens for h in eng.generate_many(prompts, params,
                                               adapter_ids=ids)]
    twin = [h.tokens for h in eager_twin(eng).generate_many(
        prompts, params, adapter_ids=ids)]
    if not got == twin == want:
        raise AssertionError(f'spec bank consistency: graph {got}, eager '
                             f'{twin}, plain {want}')
    log(f'[spec-bank-consistency] mixed wave {ids}: graph == eager == the '
        f'plain banked engine')
    del eng, bank
    # swap and restore, evict, drain on the graph engine
    eng = InferenceEngine(model, draft_model=draft,
                          prefill_chunk_tokens=256, **spec_kw)
    long = np.random.RandomState(3).randint(3, cfg.vocab_size,
                                            (900,)).tolist()
    before = [h.tokens for h in eng.generate_many(prompts, params)]
    traces = dict(eng.stats()['traces'])
    prev = eng.swap_weights(perturbed_state(model), version=1)
    moved = sum(a != b for a, b in zip(
        [h.tokens for h in eng.generate_many(prompts, params)], before))
    eng.restore_weights(prev)
    again = [h.tokens for h in eng.generate_many(prompts, params)]
    if again != before or eng.stats()['traces'] != traces or not moved:
        raise AssertionError(f'spec swap: {moved} requests moved by the '
                             f'swap; after the restore {again} (before '
                             f'{before}), captures {eng.stats()["traces"]} '
                             f'(before {traces})')
    log(f'[spec-swap] swap to perturbed weights moved {moved} of '
        f'{len(prompts)} requests; the restore gives the pre-swap tokens bit '
        f'for bit, captures unchanged {traces}')
    hs = [eng.submit(p, sp) for p, sp in zip(prompts + [long],
                                             params + [greedy])]
    eng.step()
    out = eng.evict_all()
    if sorted(h.request_id for h in out) != sorted(h.request_id for h in hs) \
            or eng.pool.free_page_count != eng.pool.num_pages - 1:
        raise AssertionError(f'spec evict_all: {len(out)} of {len(hs)} '
                             f'handles back, {eng.pool.used_page_count} pages '
                             f'still used')
    want = plain_tokens(prompts + [long], params + [greedy],
                        prefill_chunk_tokens=256)
    hs = [eng.submit(p, sp) for p, sp in zip(prompts + [long],
                                             params + [greedy])]
    eng.step()
    parked = len(eng._prefilling)
    if not parked or not eng.drain() or \
            any(h.status != FINISHED for h in hs) or \
            [h.tokens for h in hs] != want:
        raise AssertionError(f'spec drain: {parked} parked mid-chunk; '
                             f'{[h.status for h in hs]}')
    log(f'[spec-drain] evict_all() after a step: {len(out)} handles back, '
        f'every page free; drain() after a step ({parked} request parked '
        f'mid-chunk) finished all {len(hs)} with the plain engine\'s tokens')
    del eng, model, draft
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: training on the card against training on the CPU
# ---------------------------------------------------------------------------

def next_token_loss(logits, labels):
    """The JAX bench's loss (bench.py:_run_config): predict token t+1
    from positions <= t."""
    from paddle_tpu_torch.nn import functional as PF
    vocab = logits.shape[-1]
    return PF.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                            labels[:, 1:].reshape(-1))


def _loss_and_grads(model, ids):
    x = torch.as_tensor(ids, device=model.device)
    loss = next_token_loss(model(x), x)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.item(), grads


def _grad_errors(got: dict, want: dict) -> dict:
    """{name: |got - want| / |want|} (Frobenius norms, on got's device)."""
    out = {}
    for name, w in want.items():
        w = w.to(got[name].device, torch.float64)
        out[name] = float((got[name].double() - w).norm() / w.norm())
    return out


def check_train_consistency(cfg) -> None:
    """One forward + backward of the next-token loss at 2 layers of
    Llama-2-7B width in f32 (TF32 off): on the card (kernels) and on the
    CPU (plain versions) with the same weights, then on the card with
    use_recompute=True. Fatal if the losses or any gradient disagree."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(5, DEV))
    on_cpu = LlamaForCausalLM(cfg, device='cpu', dtype='float32')
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            model.state_dict().items()})
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (1, 128))
    loss_card, g_card = _loss_and_grads(model, ids)
    loss_cpu, g_cpu = _loss_and_grads(on_cpu, ids)
    del on_cpu
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    errs = _grad_errors(g_card, g_cpu)
    worst = max(errs, key=errs.get)
    log(f'[train-consistency] 2 layers f32, 1 x 128 tokens: loss card '
        f'{loss_card:.6f} cpu {loss_cpu:.6f} (rel {rel:.2e}, limit '
        f'{TRAIN_LOSS_RTOL}); worst gradient rel error {errs[worst]:.2e} '
        f'({worst}; limit {TRAIN_GRAD_RTOL})')
    if rel > TRAIN_LOSS_RTOL or errs[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError('train consistency: card and CPU disagree')
    model.config.use_recompute = True
    loss_remat, g_remat = _loss_and_grads(model, ids)
    errs = _grad_errors(g_remat, g_card)
    worst = max(errs, key=errs.get)
    log(f'[train-consistency] use_recompute=True on the card: loss '
        f'{loss_remat:.6f}, worst gradient rel error vs no recompute '
        f'{errs[worst]:.2e} ({worst}) in {time.perf_counter() - t0:.1f} s')
    if abs(loss_remat - loss_card) > TRAIN_LOSS_RTOL * abs(loss_card) \
            or errs[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError('train consistency: recompute changes the '
                             'gradients')
    del g_remat
    for policy in ('dots', 'dots_no_batch'):
        model.config.use_recompute = policy
        loss_p, g_p = _loss_and_grads(model, ids)
        rel = abs(loss_p - loss_cpu) / abs(loss_cpu)
        errs = _grad_errors(g_p, g_cpu)
        worst = max(errs, key=errs.get)
        log(f'[train-consistency] use_recompute={policy!r} on the card: '
            f'loss {loss_p:.6f} (rel {rel:.2e} vs the CPU), worst gradient '
            f'rel error vs the CPU plain run {errs[worst]:.2e} ({worst})')
        if rel > TRAIN_LOSS_RTOL or errs[worst] > TRAIN_GRAD_RTOL:
            raise AssertionError(f'train consistency: {policy!r} on the card '
                                 f'and the CPU disagree')
        del g_p
    del model, g_card, g_cpu
    torch.cuda.empty_cache()
    check_tied_consistency(cfg, ids)


# tied embeddings in bf16 on the card against the same model in f32 on the
# card: each gradient to a relative norm error of 0.05 (bf16 activations
# and products over 2 layers of 4096 wide; the head's and the gather's
# gradients both round in bf16 before their sum)
TIED_BF16_GRAD_RTOL = 0.05


def check_tied_consistency(cfg, ids) -> None:
    """Tied word embeddings at phase 4's size: the f32 tied model's loss
    and gradients on the card (kernels) against the CPU plain run (the
    phase's limits), under no recompute and 'dots_no_batch'; then the same
    weights in bf16 on the card against the f32 card run
    (TIED_BF16_GRAD_RTOL). The embedding's gradient sums the gather's and
    the head's."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    tied = LlamaConfig(**{**cfg.__dict__, 'tie_word_embeddings': True,
                          'use_recompute': False})
    model = LlamaForCausalLM(tied, device=DEV, dtype='float32',
                             generator=ptt.generator(8, DEV))
    if model.lm_head is not None:
        raise AssertionError('tied consistency: the tied model has a head')
    on_cpu = LlamaForCausalLM(tied, device='cpu', dtype='float32')
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            model.state_dict().items()})
    loss_cpu, g_cpu = _loss_and_grads(on_cpu, ids)
    del on_cpu
    for policy in (False, 'dots_no_batch'):
        model.config.use_recompute = policy
        loss_card, g_card = _loss_and_grads(model, ids)
        rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        errs = _grad_errors(g_card, g_cpu)
        worst = max(errs, key=errs.get)
        log(f'[train-consistency] tied embeddings, recompute {policy!r}: '
            f'loss card {loss_card:.6f} cpu {loss_cpu:.6f} (rel {rel:.2e}); '
            f'embedding gradient rel error '
            f'{errs["llama.embed_tokens.weight"]:.2e}, worst {errs[worst]:.2e}'
            f' ({worst})')
        if rel > TRAIN_LOSS_RTOL or errs[worst] > TRAIN_GRAD_RTOL:
            raise AssertionError('tied consistency: card and CPU disagree')
    model.config.use_recompute = False
    half = LlamaForCausalLM(tied, device=DEV, dtype='bfloat16')
    half.load_state_dict(model.state_dict())
    loss_bf16, g_bf16 = _loss_and_grads(half, ids)
    errs = _grad_errors({k: v.float() for k, v in g_bf16.items()}, g_card)
    worst = max(errs, key=errs.get)
    log(f'[train-consistency] tied embeddings in bf16 on the card: loss '
        f'{loss_bf16:.4f} vs f32 {loss_card:.4f}; embedding gradient rel '
        f'error {errs["llama.embed_tokens.weight"]:.2e}, worst '
        f'{errs[worst]:.2e} ({worst}; limit {TIED_BF16_GRAD_RTOL})')
    if not np.isfinite(loss_bf16) or errs[worst] > TIED_BF16_GRAD_RTOL:
        raise AssertionError('tied consistency: bf16 on the card strays '
                             'from f32')
    del model, half, g_cpu, g_card, g_bf16
    torch.cuda.empty_cache()


def check_offload_steps(cfg) -> None:
    """Two `TrainStep`s of AdamW(offload='host') and two of AdamW in HBM
    at phase 4's size (f32, the same weights and batches): the parameters
    and every moment bit-equal (the same kernel on the same values), every
    offloaded slot a pinned host tensor, and the multi-tensor Adam kernel
    launched by the offloaded update."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW
    t0 = time.perf_counter()
    rng = np.random.RandomState(10)
    batches = [rng.randint(0, cfg.vocab_size, (1, 128)) for _ in range(2)]
    steps, losses = {}, {}
    for offload in (None, 'host'):
        model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                                 generator=ptt.generator(7, DEV))
        step = TrainStep(model, next_token_loss, AdamW(
            learning_rate=1e-3, parameters=model.parameters(),
            offload=offload))
        K.reset_launch_counts()
        losses[offload] = [float(step(b, b)) for b in batches]
        launches = K.LAUNCHES['multi_tensor_adam']
        steps[offload] = step
    if launches <= 0:
        raise AssertionError('offload steps: the offloaded update launched '
                             'no multi-tensor Adam kernel')
    hbm, off = steps[None], steps['host']
    differ = [n for (n, a), (_, b) in zip(hbm.layer.named_parameters(),
                                          off.layer.named_parameters())
              if not torch.equal(a, b)]
    want, got = hbm.opt_state(), off.opt_state()
    unpinned = []
    for n, slots in want['slots'].items():
        for k, v in slots.items():
            g = got['slots'][n][k]
            if not (g.device.type == 'cpu' and g.is_pinned()):
                unpinned.append(f'{n}.{k}')
            if not torch.equal(g, v.cpu()):
                differ.append(f'{n}.{k}')
    log(f'[train-offload] 2 layers f32, 2 TrainSteps each: losses in HBM '
        f'{losses[None]}, offloaded {losses["host"]}; parameters and '
        f'moments bit-equal: {not differ}; slots pinned on the host: '
        f'{not unpinned}; multi_tensor_adam launches {launches}; '
        f'{time.perf_counter() - t0:.1f} s')
    if differ or unpinned or losses[None] != losses['host']:
        raise AssertionError(f'offload steps: differ {differ[:4]}, not '
                             f'pinned {unpinned[:4]}')
    del steps, hbm, off, want, got
    gc.collect()
    torch.cuda.empty_cache()


def pretraining_optimizer(named, peak_lr: float, warmup: int, t_max: int,
                          start_lr: float, **kw):
    """(AdamW, its scheduler): Llama 2's pretraining optimizer over the
    (name, parameter) pairs `named`: betas 0.9 / 0.95, epsilon 1e-5,
    decoupled decay 0.1 on every parameter whose name holds no `norm`
    (as PaddleNLP's Trainer exempts norms), ClipGradByGlobalNorm(1.0),
    and LinearWarmup from start_lr to peak_lr over `warmup` steps into a
    cosine to peak_lr / 10 over t_max steps."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    sched = LinearWarmup(CosineAnnealingDecay(peak_lr, T_max=t_max,
                                              eta_min=peak_lr / 10),
                         warmup_steps=warmup, start_lr=start_lr,
                         end_lr=peak_lr)
    opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-5,
                weight_decay=0.1, parameters=named,
                apply_decay_param_fun=lambda name: 'norm' not in name,
                grad_clip=ClipGradByGlobalNorm(1.0), **kw)
    return opt, sched


def check_train_steps(cfg) -> None:
    """Two `TrainStep`s under Llama 2's optimizer (a 2-step warm-up from
    1e-4 into a cosine, so both steps move) at 2 layers of Llama-2-7B
    width in f32 (TF32 off), on the card (kernels, the update through the
    multi-tensor sum of squares and Adam) and on the CPU (plain versions),
    from the same weights on the same two batches. Fatal unless each
    step's loss agrees to TRAIN_LOSS_RTOL and each parameter's update over
    the two steps to a relative norm error of TRAIN_GRAD_RTOL (epsilon
    1e-5 damps the step of an element whose grad is near 0, where the two
    devices' grads differ most)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(6, DEV))
    on_cpu = LlamaForCausalLM(cfg, device='cpu', dtype='float32')
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            model.state_dict().items()})
    start = {k: v.clone() for k, v in on_cpu.state_dict().items()}
    rng = np.random.RandomState(9)
    batches = [rng.randint(0, cfg.vocab_size, (1, 128)) for _ in range(2)]
    losses, lrs = {}, {}
    K.reset_launch_counts()
    for tag, m in (('card', model), ('cpu', on_cpu)):
        opt, sched = pretraining_optimizer(m.named_parameters(), 3e-4, 2,
                                           1000, start_lr=1e-4)
        step = TrainStep(m, next_token_loss, opt)
        losses[tag], lrs[tag] = [], []
        for ids in batches:
            lrs[tag].append(opt.get_lr())
            losses[tag].append(float(step(ids, ids)))
            sched.step()
        if tag == 'card':
            launches = {k: K.LAUNCHES[k] for k in ('multi_tensor_adam',
                                                   'multi_tensor_sumsq')}
        del opt, step
    if min(launches.values()) <= 0:
        raise AssertionError(f'train steps: the card skipped a kernel: '
                             f'{launches}')
    rel = [abs(a - b) / abs(b) for a, b in zip(losses['card'], losses['cpu'])]
    got = {k: v.cpu() - start[k] for k, v in model.state_dict().items()}
    want = {k: v - start[k] for k, v in on_cpu.state_dict().items()}
    errs = _grad_errors(got, want)
    worst = max(errs, key=errs.get)
    log(f'[train-steps] 2 layers f32, 2 TrainSteps of Llama 2\'s AdamW '
        f'(lr {lrs["card"]}, clip 1.0, decay 0.1 but norms): losses card '
        f'{losses["card"]} cpu {losses["cpu"]} (rel {max(rel):.2e}, limit '
        f'{TRAIN_LOSS_RTOL}); worst update rel error {errs[worst]:.2e} '
        f'({worst}; limit {TRAIN_GRAD_RTOL}); kernel launches on the card '
        f'{launches}; {time.perf_counter() - t0:.1f} s')
    if lrs['card'] != lrs['cpu'] or max(rel) > TRAIN_LOSS_RTOL \
            or errs[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError('train steps: card and CPU disagree')
    del model, on_cpu, got, want, start
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: train the llama2_7b_shape_8L rung
# ---------------------------------------------------------------------------

def train_flops_per_step(cfg, batch: int, seq: int) -> float:
    """bench.py:169-180: 3x the forward's weight-matmul and attention
    flops (recompute not counted)."""
    h, layers = cfg.hidden_size, cfg.num_hidden_layers
    qkvo = h * (cfg.num_attention_heads * cfg.head_dim) * 2 \
        + h * (cfg.num_key_value_heads * cfg.head_dim) * 2
    n_matmul = layers * (qkvo + 3 * h * cfg.intermediate_size) \
        + h * cfg.vocab_size
    fwd = 2 * n_matmul * batch * seq + layers * 4 * batch * seq * seq * h
    return 3 * fwd


def train(cfg) -> dict:
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(0, DEV))
    n_params = sum(p.numel() for p in model.parameters())
    big = n_params > 1e9            # bench.py: bf16 moments above 1e9
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                multi_precision=not big,
                moment_dtype='bfloat16' if big else None)
    step = TrainStep(model, next_token_loss, opt)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
               for _ in range(4)]
    log(f'[train] Llama {cfg.num_hidden_layers} layers x '
        f'{cfg.hidden_size}, {n_params / 1e9:.3f} B params bf16, '
        f'recompute {cfg.use_recompute}, AdamW lr {TRAIN_LR} moments '
        f'{"bf16" if big else "fp32"}, batch {TRAIN_BATCH} x {TRAIN_SEQ}; '
        f'built in {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP):
        loss = step(batches[i % 4], batches[i % 4])
    warm = float(loss)
    log(f'[train] {TRAIN_WARMUP} warm-up steps in '
        f'{time.perf_counter() - t0:.2f} s, loss {warm:.4f}')
    torch.cuda.reset_peak_memory_stats()

    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        loss = step(batches[i % 4], batches[i % 4])
    final = float(loss)             # waits for the last step
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    missing = [k for k in TRAIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f'train: kernels never launched on the main '
                             f'path: {missing}')
    if not np.isfinite(final):
        raise AssertionError(f'train: loss {final} is not finite')
    flops = train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    res = {'step_s': dt, 'tokens_per_s': TRAIN_BATCH * TRAIN_SEQ / dt,
           'mfu': flops / dt / PEAK_OPS_PER_S[torch.bfloat16],
           'loss': final, 'peak_mem_gb': (peak - base) / 1e9,
           'peak_mem_raw_gb': peak / 1e9, 'launches': launches,
           'params_b': n_params / 1e9}
    log(f'[train] {TRAIN_STEPS} steps: {dt * 1e3:.1f} ms/step, '
        f'{res["tokens_per_s"]:.0f} tokens/s, MFU {res["mfu"]:.4f} '
        f'(bench.py FLOP count {flops / 1e12:.1f} TFLOP/step vs 989 '
        f'TFLOP/s), loss {final:.4f}, peak device memory '
        f'{res["peak_mem_gb"]:.2f} GB above the {base / 1e9:.2f} GB held '
        f'before the phase ({res["peak_mem_raw_gb"]:.2f} GB in all)')
    log(f'[train] kernel launches on the timed steps: {launches}')

    # a fifth batch, never trained on: its first loss is held out. The
    # tokens are uniform and independent, so a model that sees no future
    # token cannot beat ln(V) on them (a causal-mask leak would)
    fixed = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    losses = [float(step(fixed, fixed)) for _ in range(OVERFIT_STEPS)]
    floor = math.log(cfg.vocab_size) - HELD_OUT_SLACK
    drop = losses[0] - losses[-1]
    log(f'[train] one fixed unseen batch: held-out loss {losses[0]:.4f} '
        f'(required >= ln(V) - {HELD_OUT_SLACK} = {floor:.4f}), then '
        + ' '.join(f'{x:.4f}' for x in losses[1:])
        + f'; drop {drop:.4f} nats (required >= {OVERFIT_MIN_DROP})')
    if not all(np.isfinite(losses)) or losses[0] < floor:
        raise AssertionError(f'train: held-out loss {losses[0]:.4f} below '
                             f'{floor:.4f}: the model sees future tokens')
    if drop < OVERFIT_MIN_DROP:
        raise AssertionError(f'train: the loss on one fixed batch fell by '
                             f'{drop:.4f} < {OVERFIT_MIN_DROP} nats')
    res.update(overfit_losses=losses, step=step, batch=fixed,
               batches=batches, base=base)
    return res


# ---------------------------------------------------------------------------
# phase 5b: the rung under Llama 2's pretraining optimizer
# ---------------------------------------------------------------------------

def pretrain(trained: dict, cfg) -> dict:
    """Phase 5's model and batches under Llama 2's pretraining optimizer
    (`pretraining_optimizer`, bf16 moments as the rung keeps them), phase
    5's optimizer state freed first: 2 warm-up and 6 timed steps, the
    scheduler stepped after each. Each step's lr must be LinearWarmup's
    value after that many scheduler steps, the loss finite, and every
    kernel of PRETRAIN_KERNELS must launch on the timed steps. The peak
    memory is counted above phase 5's base, so the two read alike; the
    optimizer state is freed at the end (phase 7 makes it anew)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import kernels as K
    model = trained['step'].layer
    trained['step'].optimizer._slots.clear()
    torch.cuda.empty_cache()
    opt, sched = pretraining_optimizer(
        model.named_parameters(), PRETRAIN_PEAK_LR, PRETRAIN_WARMUP,
        PRETRAIN_T_MAX, start_lr=0.0, moment_dtype='bfloat16')
    step = TrainStep(model, next_token_loss, opt)
    batches = trained['batches']

    def one(i):
        want = PRETRAIN_PEAK_LR * (i / PRETRAIN_WARMUP)   # LinearWarmup
        if opt.get_lr() != want:
            raise AssertionError(f'pretrain: step {i} lr {opt.get_lr()} != '
                                 f'the schedule\'s {want}')
        loss = step(batches[i % 4], batches[i % 4])
        sched.step()
        return loss

    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP):
        loss = one(i)
    warm = float(loss)
    log(f'[pretrain] {TRAIN_WARMUP} warm-up steps in '
        f'{time.perf_counter() - t0:.2f} s, loss {warm:.4f}')
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        loss = one(i)
    final = float(loss)
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in PRETRAIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f'pretrain: kernels never launched on the main '
                             f'path: {missing}')
    if not np.isfinite(final):
        raise AssertionError(f'pretrain: loss {final} is not finite')
    mfu = train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ) / dt \
        / PEAK_OPS_PER_S[torch.bfloat16]
    res = {'step_s': dt, 'tokens_per_s': TRAIN_BATCH * TRAIN_SEQ / dt,
           'mfu': mfu, 'loss': final,
           'peak_mem_gb': (peak - trained['base']) / 1e9,
           'launches': launches, 'step': step}
    log(f'[pretrain] Llama 2\'s optimizer (clip 1.0, decay 0.1 but norms, '
        f'lr {PRETRAIN_PEAK_LR} x i / {PRETRAIN_WARMUP} in warm-up, each '
        f'step\'s lr checked), {TRAIN_STEPS} steps: {dt * 1e3:.1f} ms/step '
        f'beside phase 5\'s {trained["step_s"] * 1e3:.1f} (same process), '
        f'{res["tokens_per_s"]:.0f} tokens/s, MFU {mfu:.4f}, loss '
        f'{final:.4f}, peak device memory {res["peak_mem_gb"]:.2f} GB above '
        f'phase 5\'s base (phase 5: {trained["peak_mem_gb"]:.2f})')
    log(f'[pretrain] kernel launches on the timed steps: {launches}')
    opt._slots.clear()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 5c-5f: the bench's rungs, offload, fault tolerance, Model.fit
# ---------------------------------------------------------------------------

# the rungs of bench.py this port could not run before: its headline
# (bench.py:_configs, :48-73) and the first 7B rung (_7b_configs, :97-99),
# each (name, config, batch, seq, warm-up steps, timed steps)
def headline_rungs() -> list:
    from paddle_tpu_torch.nlp import LlamaConfig
    return [('gpt3_1p3b', LlamaConfig(use_recompute='dots_no_batch',
                                      **GPT3_SHAPE),
             GPT3_BATCH, TRAIN_SEQ, 2, 6),
            ('llama2_7b_shape_8L', LlamaConfig.llama2_7b(
                num_hidden_layers=8, use_recompute='dots_no_batch'),
             1, 4096, 2, 6)]


AB_PAIRS = 2             # interleaved (dots_no_batch, True) pairs
AB_STEPS = 3             # timed steps per reading, after one warm-up
OFFLOAD_LAYERS = 16      # bench.py:_7b_configs' deep rung (:109-111)
OFFLOAD_SEQ = 2048
OFFLOAD_MIN_SAVING = 0.9  # of the slots' bytes, HBM peak below the twin's
FIT_LAYERS = 2           # 5f: Llama-2-7B width, 2 of 32 layers
FIT_SAMPLES, FIT_BATCH, FIT_SEQ = 16, 2, 2048
FIT_ROOT = Path(__file__).resolve().parent / 'build' / 'fit_ckpt'
GEMM_OPS = ('mm', 'addmm', 'bmm', 'baddbmm')


def bench_optimizer(model, offload=None):
    """bench.py:_run_config's AdamW (:128-135): lr 3e-4; above 1e9
    parameters bf16 moments and no masters, else fp32 masters and
    moments."""
    from paddle_tpu_torch.optimizer import AdamW
    big = sum(p.numel() for p in model.parameters()) > 1e9
    return AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                 multi_precision=not big,
                 moment_dtype='bfloat16' if big else None, offload=offload)


def run_rung(name, cfg, batch, seq, warmup, steps, offload=None,
             kernels=TRAIN_KERNELS) -> dict:
    """One bench rung as bench.py:_run_config builds it (seed 0, bf16,
    `bench_optimizer`, 4 rotating batches of RandomState(0)): `warmup`
    steps, then `steps` timed ones (host clock to a synchronized loss) with
    the peak device memory and the kernel launches read around them. Fatal
    unless every kernel of `kernels` launched and the loss is finite."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(0, DEV))
    opt = bench_optimizer(model, offload)
    step = TrainStep(model, next_token_loss, opt)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size, (batch, seq))
               for _ in range(4)]
    n_params = sum(p.numel() for p in model.parameters())
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(warmup):
        loss = step(batches[i % 4], batches[i % 4])
    float(loss)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step(batches[i % 4], batches[i % 4])
    host = (time.perf_counter() - t0) / steps
    final = float(loss)
    dt = (time.perf_counter() - t0) / steps
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in kernels if launches[k] <= 0]
    if missing or not np.isfinite(final):
        raise AssertionError(f'{name}: kernels never launched {missing}, '
                             f'loss {final}')
    flops = train_flops_per_step(cfg, batch, seq)
    res = dict(name=name, step_s=dt, host_s=host,
               tokens_per_s=batch * seq / dt,
               mfu=flops / dt / PEAK_OPS_PER_S[torch.bfloat16], loss=final,
               peak_gb=peak / 1e9, launches=launches,
               params_b=n_params / 1e9, step=step, batches=batches)
    log(f'[rungs] {name}: {cfg.num_hidden_layers} layers x '
        f'{cfg.hidden_size}, {n_params / 1e9:.3f} B params bf16, recompute '
        f'{cfg.use_recompute!r}, batch {batch} x {seq}, moments '
        f'{opt._moment_dtype}, offload {offload}; built in {built:.1f} s, '
        f'{warmup} warm-up steps in {warm_s:.2f} s; {steps} steps: '
        f'{dt * 1e3:.1f} ms/step (the card finished '
        f'{(dt - host) * steps * 1e3:.1f} ms after the host\'s last launch:'
        f' near 0, the card waits on the host), '
        f'{res["tokens_per_s"]:.0f} tokens/s, MFU '
        f'{res["mfu"]:.4f} ({flops / 1e12:.1f} TFLOP/step by bench.py\'s '
        f'count vs 989 TFLOP/s), loss {final:.4f}, peak device memory '
        f'{res["peak_gb"]:.2f} GB in all')
    log(f'[rungs] {name}: kernel launches on the timed steps {launches}')
    return res


def flush() -> None:
    """Collect what the caller dropped and give its device memory, and
    the pinned host memory it held, back."""
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, '_host_emptyCache'):
        torch._C._host_emptyCache()


class GemmCount(TorchDispatchMode):
    """The GEMMs a region dispatches, by aten op (a dispatch mode sees the
    ops below autograd, and never those a selective recompute policy
    serves from its cache)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in GEMM_OPS:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def backward_gemms(model, ids, policy) -> int:
    """The GEMMs one backward of the next-token loss dispatches under
    `policy` (the model's grads dropped after)."""
    model.config.use_recompute = policy
    x = torch.as_tensor(ids, device=DEV)
    loss = next_token_loss(model(x), x)
    with GemmCount() as count:
        loss.backward()
    for p in model.parameters():
        p.grad = None
    return sum(count.counts.values())


def train_rungs(trained: dict) -> dict:
    """Phase 5c: the bench's headline rungs (`headline_rungs`), then phase
    5's rung (its model, a fresh `bench_optimizer`) under 'dots_no_batch'
    and under True in AB_PAIRS interleaved pairs, and the GEMMs one
    backward dispatches under each policy: every projection's two
    gradient products (and the head's) under 'dots_no_batch', and no
    forward product rerun; True reruns them."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import kernels as K
    out = {'launches': collections.Counter()}
    for name, cfg, b, seq, warm, steps in headline_rungs():
        r = run_rung(name, cfg, b, seq, warm, steps)
        out['launches'].update(r['launches'])
        out[name] = {k: v for k, v in r.items()
                     if k not in ('step', 'batches')}
        del r
        flush()
    model = trained['step'].layer
    layers = model.config.num_hidden_layers
    grads = 2 * (7 * layers + 1)
    gemms = {p: backward_gemms(model, trained['batch'], p)
             for p in ('dots_no_batch', 'dots', True, False)}
    log(f'[rungs] GEMMs one backward dispatches at phase 5\'s rung: '
        + ', '.join(f'{p!r} {n}' for p, n in gemms.items())
        + f' (the gradients\' products: {grads})')
    if gemms['dots_no_batch'] != grads or gemms['dots'] != grads \
            or gemms[True] <= grads:
        raise AssertionError(f'rungs: the policies rerun the wrong GEMMs: '
                             f'{gemms}')
    step = TrainStep(model, next_token_loss, bench_optimizer(model))
    batches = trained['batches']
    readings = collections.defaultdict(list)
    K.reset_launch_counts()
    for policy in ('dots_no_batch', True) * AB_PAIRS:
        model.config.use_recompute = policy
        float(step(batches[0], batches[0]))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(AB_STEPS):
            loss = step(batches[i % 4], batches[i % 4])
        host = (time.perf_counter() - t0) / AB_STEPS
        final = float(loss)
        dt = (time.perf_counter() - t0) / AB_STEPS
        if not np.isfinite(final):
            raise AssertionError(f'rungs: A/B loss {final} under {policy!r}')
        readings[policy].append((dt, torch.cuda.max_memory_allocated(),
                                 host))
    model.config.use_recompute = True
    out['launches'].update(K.LAUNCHES)
    flops = train_flops_per_step(model.config, TRAIN_BATCH, TRAIN_SEQ)
    ab = {}
    for policy, rs in readings.items():
        dts = [dt for dt, _, _ in rs]
        ab[repr(policy)] = dict(step_s=dts,
                                host_s=[h for _, _, h in rs],
                                peak_gb=max(p for _, p, _ in rs) / 1e9,
                                mfu=[flops / dt / PEAK_OPS_PER_S[
                                    torch.bfloat16] for dt in dts])
        log(f'[rungs] phase 5\'s rung, recompute {policy!r}: '
            + ' '.join(f'{dt * 1e3:.1f}' for dt in dts) + ' ms/step (MFU '
            + ' '.join(f'{m:.4f}' for m in ab[repr(policy)]['mfu'])
            + '; the card finished '
            + ' '.join(f'{(dt - h) * AB_STEPS * 1e3:.1f}' for dt, _, h in rs)
            + f' ms after the host\'s last launch), peak device memory '
            f'{ab[repr(policy)]["peak_gb"]:.2f} GB')
    out['ab'] = ab
    out['gemms'] = {repr(k): v for k, v in gemms.items()}
    step.optimizer._slots.clear()
    del step
    flush()
    return out


def train_offload() -> dict:
    """Phase 5d: bench.py's deep rung (llama2_7b_shape_16L: 16 layers,
    full recompute, 1 x 2048, AdamW offload='host', 1 warm-up and 3 timed
    steps), then its in-HBM twin on the same card. Fatal unless every slot
    is a pinned host tensor, the transfer counters move by the slots'
    bytes each step both ways, and the offloaded rung's peak device memory
    lies below the twin's by at least OFFLOAD_MIN_SAVING of the slots'
    bytes."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.nlp import LlamaConfig
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=OFFLOAD_LAYERS,
                                use_recompute=True)
    reg = obs.get_registry()

    def moved():
        return {d: reg.counter(f'paddle_offload_{d}_bytes_total', '').value
                for d in ('h2d', 'd2h')}
    t0 = time.perf_counter()
    before = moved()
    off = run_rung('llama2_7b_shape_16L offload', cfg, 1, OFFLOAD_SEQ, 1, 3,
                   offload='host')
    after = moved()
    opt = off['step'].optimizer
    opt._settle()
    slots = [v for s in opt._slots.values() for v in s.values()]
    slot_bytes = sum(v.numel() * v.element_size() for v in slots)
    unpinned = sum(1 for v in slots if v.is_cuda or not v.is_pinned())
    per_step = {d: (after[d] - before[d]) / 4 for d in after}
    log(f'[offload] {len(slots)} slots, {slot_bytes / 1e9:.2f} GB, on the '
        f'host and pinned: {unpinned == 0}; per step H2D '
        f'{per_step["h2d"] / 1e9:.3f} GB, D2H {per_step["d2h"] / 1e9:.3f} GB '
        f'(the slots\' bytes: {slot_bytes / 1e9:.3f} GB); ring '
        f'{sum(t.numel() * t.element_size() for r in opt._engine._ring for t in r.values()) / 1e9:.2f} GB')
    if unpinned or any(v != slot_bytes for v in per_step.values()):
        raise AssertionError(f'offload: {unpinned} slots not pinned on the '
                             f'host, per-step bytes {per_step} != '
                             f'{slot_bytes}')
    res = {'offload': {k: v for k, v in off.items()
                       if k not in ('step', 'batches')},
           'slot_gb': slot_bytes / 1e9,
           'launches': collections.Counter(off['launches'])}
    del off, opt, slots
    flush()
    twin = run_rung('llama2_7b_shape_16L in HBM', cfg, 1, OFFLOAD_SEQ, 1, 3)
    res['hbm'] = {k: v for k, v in twin.items()
                  if k not in ('step', 'batches')}
    res['launches'].update(twin['launches'])
    del twin
    flush()
    saving = res['hbm']['peak_gb'] - res['offload']['peak_gb']
    log(f'[offload] peak device memory offloaded '
        f'{res["offload"]["peak_gb"]:.2f} GB vs in HBM '
        f'{res["hbm"]["peak_gb"]:.2f} GB: {saving:.2f} GB saved of '
        f'{res["slot_gb"]:.2f} GB of slots (required >= '
        f'{OFFLOAD_MIN_SAVING}); step {res["offload"]["step_s"] * 1e3:.1f} '
        f'vs {res["hbm"]["step_s"] * 1e3:.1f} ms; phase 5d took '
        f'{time.perf_counter() - t0:.1f} s')
    if saving < OFFLOAD_MIN_SAVING * res['slot_gb']:
        raise AssertionError(f'offload: saved {saving:.2f} GB < '
                             f'{OFFLOAD_MIN_SAVING} x {res["slot_gb"]:.2f}')
    return res


def fault_tolerance(trained: dict) -> dict:
    """Phase 5e: phase 5's rung (its model, a fresh `bench_optimizer`)
    under `FaultTolerantStep(snapshot_interval=1)` (NaN/Inf detection;
    each snapshot's seconds logged): two good steps, a batch poisoned
    through the loss (loss x NaN, so the update writes NaNs), which must
    give one rollback and one skipped batch with the parameters and
    slots bit-equal to the snapshot, then two finite steps; with
    skip_budget=0 a poisoned batch must raise SkipBudgetExhausted after
    `skip_budget_exhausted` is emitted; a `StepWatchdog` with a 0.5 s
    deadline under a step slowed by 1.5 s must fire once, emit
    `hang_suspected` with /healthz's hang state set, and clear on
    return."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.observability import server
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.resilience import (FaultTolerantStep,
                                             SkipBudgetExhausted,
                                             StepWatchdog)
    t_phase = time.perf_counter()
    model = trained['step'].layer
    batches = trained['batches']
    mode = {'scale': 1.0, 'sleep': 0.0}

    def poisoned_loss(logits, labels):
        if mode['sleep']:
            time.sleep(mode['sleep'])
        return next_token_loss(logits, labels) * mode['scale']
    opt = bench_optimizer(model)
    step = TrainStep(model, poisoned_loss, opt)
    ft = FaultTolerantStep(step, snapshot_interval=1, check_spikes=False)
    snap_s = []
    capture = ft._capture

    def timed_capture():
        t0 = time.perf_counter()
        snap = capture()
        snap_s.append(time.perf_counter() - t0)
        return snap
    ft._capture = timed_capture
    K.reset_launch_counts()
    losses = [float(ft(batches[i], batches[i])) for i in range(2)]
    mode['scale'] = float('nan')
    bad = float(ft(batches[2], batches[2]))
    mode['scale'] = 1.0
    if not (ft.rollbacks == 1 and ft.skipped_batches == 1
            and ft.last_step_skipped and math.isnan(bad)):
        raise AssertionError(f'fault tolerance: {ft.stats()} after a NaN '
                             f'batch')
    snap = ft.snapshot_tensors()
    live = {('param', n): p for n, p in model.named_parameters()}
    live.update({('slot', n, k): v for n, sl in step.opt_state()['slots']
                 .items() for k, v in sl.items()})
    snap_gb = sum(v.numel() * v.element_size() for v in snap.values()) / 1e9
    differ = [k for k, v in live.items()
              if not torch.equal(v, snap[k].to(v.device))]
    if differ or set(snap) != set(live):
        raise AssertionError(f'fault tolerance: the restore differs from '
                             f'the snapshot at {differ[:4]}')
    losses += [float(ft(batches[i], batches[i])) for i in (2, 3)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f'fault tolerance: losses {losses}')
    log(f'[fault-tolerance] phase 5\'s rung under FaultTolerantStep('
        f'snapshot_interval=1): losses {[round(x, 4) for x in losses]}, the '
        f'NaN batch rolled back ({ft.stats()}); parameters and slots '
        f'bit-equal to the snapshot ({len(snap)} tensors, {snap_gb:.2f} GB, '
        f'pinned); snapshot seconds ' + ' '.join(f'{x:.3f}' for x in snap_s)
        + ' (the first allocates the pinned buffers)')
    # a budget of 0: the first bad batch ends the run
    ft0 = FaultTolerantStep(step, skip_budget=0, check_spikes=False)
    ft0._host = ft._host            # the same pinned buffers
    seq = _last_seq(obs)
    mode['scale'] = float('nan')
    try:
        ft0(batches[0], batches[0])
    except SkipBudgetExhausted as e:
        raised = str(e)
    else:
        raise AssertionError('fault tolerance: skip_budget=0 did not raise')
    finally:
        mode['scale'] = 1.0
    names = [e['name'] for e in obs.get_event_log().events()
             if e['seq'] > seq]
    if 'skip_budget_exhausted' not in names or \
            names.index('skip_budget_exhausted') < names.index('bad_step'):
        raise AssertionError(f'fault tolerance: events {names}')
    log(f'[fault-tolerance] skip_budget=0: SkipBudgetExhausted ({raised}) '
        f'after events {names}')
    # the watchdog over a slowed step
    seen = []
    dog = StepWatchdog(0.5, poll_interval=0.05, on_hang=lambda elapsed:
                       seen.append((elapsed, server.hang_suspected())))
    mode['sleep'] = 1.5
    try:
        with dog.watch():
            float(step(batches[0], batches[0]))
    finally:
        mode['sleep'] = 0.0
        dog.stop()
    hangs = [e for e in obs.get_event_log().events()
             if e['name'] == 'hang_suspected' and e['seq'] > seq]
    log(f'[fault-tolerance] StepWatchdog(0.5 s) over a step slowed by 1.5 s:'
        f' fired {dog.fired}, hang_suspected events {len(hangs)}, /healthz '
        f'hang state during {[h for _, h in seen]} and after '
        f'{server.hang_suspected()}; phase 5e took '
        f'{time.perf_counter() - t_phase:.1f} s')
    if dog.fired != 1 or len(hangs) != 1 or seen[0][1] is not True \
            or server.hang_suspected():
        raise AssertionError('fault tolerance: the watchdog did not fire '
                             'once and clear')
    res = {'losses': losses, 'snapshot_s': snap_s, 'snapshot_gb': snap_gb,
           'launches': dict(K.LAUNCHES)}
    opt._slots.clear()
    del ft, ft0, step, opt, snap, live, capture, timed_capture
    flush()
    return res


def fit_resume() -> dict:
    """Phase 5f: `Model(LlamaForCausalLM)` at Llama-2-7B width and FIT_LAYERS
    of 32 layers (a checkpoint of all 32 would write 40 GB to disk twice),
    bf16, AdamW lr 3e-4 with bf16 moments, the next-token loss, over a
    DataLoader of FIT_SAMPLES seeded token rows (batch FIT_BATCH, shuffle):
    `fit` of 8 steps with `ckpt_dir` (the gitignored build/fit_ckpt),
    `ckpt_interval=4`, fault tolerance (NaN/Inf: a spike test would see
    the resumed run's fresh window) and `step_timeout`; then a fresh Model
    of other random weights with `resume='auto'` from the step-4
    checkpoint must give steps 5-8's losses bit for bit. The directory is
    removed after."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=FIT_LAYERS)
    rows = np.random.RandomState(12).randint(0, cfg.vocab_size,
                                             (FIT_SAMPLES, FIT_SEQ))
    shutil.rmtree(FIT_ROOT, ignore_errors=True)
    kw = dict(batch_size=FIT_BATCH, epochs=1, shuffle=True, verbose=0,
              ckpt_dir=str(FIT_ROOT), ckpt_interval=4,
              fault_tolerance={'check_spikes': False}, step_timeout=120.0)

    def model(seed):
        net = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                               generator=ptt.generator(seed, DEV))
        return ptt.Model(net).prepare(
            AdamW(learning_rate=TRAIN_LR, parameters=net.parameters(),
                  moment_dtype='bfloat16'), next_token_loss)
    try:
        t0 = time.perf_counter()
        K.reset_launch_counts()
        full = model(11).fit(io.TensorDataset([rows, rows]), **kw)['loss']
        launches = dict(K.LAUNCHES)
        fit_s = time.perf_counter() - t0
        steps = sorted(os.listdir(FIT_ROOT))
        ckpt_gb = sum(f.stat().st_size for f in (FIT_ROOT / 'step_4')
                      .iterdir()) / 1e9
        if steps != ['step_4', 'step_8'] or len(full) != 8:
            raise AssertionError(f'fit: {len(full)} steps, checkpoints '
                                 f'{steps}')
        shutil.rmtree(FIT_ROOT / 'step_8')
        flush()
        t0 = time.perf_counter()
        rest = model(99).fit(io.TensorDataset([rows, rows]),
                             **dict(kw, resume='auto'))['loss']
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(FIT_ROOT, ignore_errors=True)
    flush()
    log(f'[fit] Model.fit at {FIT_LAYERS} of 32 Llama-2-7B layers, bf16, '
        f'batch {FIT_BATCH} x {FIT_SEQ}: 8 steps with checkpoints at 4 and '
        f'8 ({ckpt_gb:.2f} GB each) in {fit_s:.1f} s, losses '
        + ' '.join(f'{x:.6f}' for x in full) + f'; resumed from step 4 in '
        f'{resume_s:.1f} s: ' + ' '.join(f'{x:.6f}' for x in rest)
        + f'; bit-equal {rest == full[4:]}')
    if rest != full[4:] or not all(np.isfinite(full)):
        raise AssertionError(f'fit: the resumed losses {rest} are not steps '
                             f'5-8 of {full}')
    return {'losses': full, 'resumed': rest, 'fit_s': fit_s,
            'resume_s': resume_s, 'ckpt_gb': ckpt_gb, 'launches': launches}


# ---------------------------------------------------------------------------
# phase 5g: the eager Paddle API on the training rung, and the op sweep
# ---------------------------------------------------------------------------

EAGER_STEPS = 3
# O1 bf16's first loss against O0 f32's, relative (phase 4 holds bf16
# gradients to 0.05 of f32's; a loss, one mean over 4096 tokens, to less)
EAGER_O1_LOSS_RTOL = 0.01
# the fp16 flash launches of one O1 step on the 8-layer rung with
# recompute: a forward per layer and its rerun, one dq and one dk/dv
EAGER_FP16_LAUNCHES = {'flash_attention_fwd_fp16': 16,
                       'flash_attention_bwd_dq_fp16': 8,
                       'flash_attention_bwd_dkv_fp16': 8}
EAGER_SEED = 11


def _place() -> str:
    """The eager API's name of DEV."""
    return 'gpu' if DEV == 'cuda' else 'cpu'


def _eager_batches(cfg):
    """(inputs, next-token labels) of EAGER_STEPS seeded batches."""
    rng = np.random.RandomState(EAGER_SEED)
    out = []
    for _ in range(EAGER_STEPS):
        ids = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
        out.append((ids, np.roll(ids, -1, axis=1)))
    return out


def _eager_arm(cfg, batches, tag, dtype='float32', amp=None, scaler=None,
               decorate=False, train_step=False) -> dict:
    """One arm of phase 5g: the rung's model from EAGER_SEED, AdamW, and
    EAGER_STEPS steps of the canonical eager loop (`loss, _ = model(x,
    labels=y)`, `backward`, `opt.step()`, `opt.clear_grad()`) on port
    Tensors, or of a `jit.TrainStep` over the same loss; the step losses,
    step ms (host clock, synchronised) and kernel launches. Frees the
    model and optimizer."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW
    model = LlamaForCausalLM(cfg, device=DEV, dtype=dtype,
                             generator=ptt.generator(EAGER_SEED, DEV))
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    if decorate:
        model, opt = ptt.amp.decorate(model, opt, level='O2',
                                      dtype='bfloat16')
    vocab = cfg.vocab_size
    step = TrainStep(model, lambda logits, y: PF.cross_entropy(
        logits.reshape(-1, vocab), y.reshape(-1)), opt) if train_step \
        else None
    ctx = (lambda: ptt.amp.auto_cast(**amp)) if amp else \
        contextlib.nullcontext
    losses, times, scales = [], [], []
    K.reset_launch_counts()
    for ids, lab in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step is not None:
            with ctx():
                loss = step(ids, lab)
        else:
            x = ptt.to_tensor(ids, place=_place())
            y = ptt.to_tensor(lab, place=_place())
            with ctx():
                loss, _ = model(x, labels=y)
            if scaler is not None:
                scaler.scale(loss).backward()
                scaler.unscale_(opt)
                scales.append((scaler.get_loss_scaling(),
                               scaler._found_inf))
                scaler.step(opt)
                scaler.update()
            else:
                loss.backward()
                opt.step()
            opt.clear_grad()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(K.LAUNCHES)
    del model, opt, step, loss
    flush()
    log(f'[eager] {tag}: losses ' + ' '.join(f'{x:.6f}' for x in losses)
        + '; step ms ' + ' '.join(f'{t:.1f}' for t in times)
        + (('; loss scale, found_inf ' + ' '.join(
            f'{sc:.0f}/{fi}' for sc, fi in scales)) if scaler else '')
        + '; flash launches ' + json.dumps(
            {k: n for k, n in launches.items() if k.startswith('flash')}))
    return {'losses': losses, 'ms': times, 'launches': launches,
            'scales': scales}


def eager_dygraph(cfg) -> dict:
    """Phase 5g: the rung in four arms of the eager API, every tensor
    freed at the end."""
    import paddle_tpu_torch as ptt
    t0 = time.perf_counter()
    batches = _eager_batches(cfg)
    o0 = _eager_arm(cfg, batches, 'O0 f32')
    o1 = _eager_arm(cfg, batches, 'O1 bf16', amp=dict(dtype='bfloat16'))
    rel = abs(o1['losses'][0] - o0['losses'][0]) / abs(o0['losses'][0])
    log(f'[eager] O1 bf16 step-1 loss vs O0 f32: rel {rel:.3e} (limit '
        f'{EAGER_O1_LOSS_RTOL})')
    if rel > EAGER_O1_LOSS_RTOL or not all(np.isfinite(o1['losses'])):
        raise AssertionError(f'eager: O1 bf16 loss {o1["losses"][0]} vs O0 '
                             f'{o0["losses"][0]} (rel {rel:.3e})')
    f16 = _eager_arm(cfg, batches, 'O1 fp16 + GradScaler',
                     amp=dict(dtype='float16'),
                     scaler=ptt.amp.GradScaler())
    want = {k: n * EAGER_STEPS for k, n in EAGER_FP16_LAUNCHES.items()}
    got = {k: f16['launches'][k] for k in want}
    bf = {k: f16['launches'][k[:-5]] for k in want}
    if got != want or any(bf.values()) \
            or not all(np.isfinite(f16['losses'])):
        raise AssertionError(f'eager: O1 fp16 launched {got} fp16 flash '
                             f'kernels (want {want}) and {bf} others, '
                             f'losses {f16["losses"]}')
    o2 = _eager_arm(cfg, batches, 'O2 bf16 (decorate), eager',
                    amp=dict(level='O2'), decorate=True)
    o2s = _eager_arm(cfg, batches, 'O2 bf16 (decorate), TrainStep',
                     amp=dict(level='O2'), decorate=True, train_step=True)
    if o2['losses'] != o2s['losses']:
        raise AssertionError(f'eager: O2 eager losses {o2["losses"]} != '
                             f'TrainStep {o2s["losses"]}')
    host = [a - b for a, b in zip(o2['ms'][1:], o2s['ms'][1:])]
    log(f'[eager] O2 eager == TrainStep bit for bit; step ms after the '
        f'first: eager ' + ' '.join(f'{t:.1f}' for t in o2['ms'][1:])
        + ' vs TrainStep ' + ' '.join(f'{t:.1f}' for t in o2s['ms'][1:])
        + ' (eager - TrainStep ' + ' '.join(f'{d:+.1f}' for d in host)
        + ' ms)')
    launches = collections.Counter()
    for arm in (o0, o1, f16, o2, o2s):
        launches.update(arm['launches'])
    took = time.perf_counter() - t0
    log(f'[eager] phase 5g took {took:.1f} s; device memory held after '
        f'it {torch.cuda.memory_allocated() / 1e9:.2f} GB')
    return {'launches': dict(launches), 'o1_rel': rel, 'seconds': took,
            'arms': {'O0': o0, 'O1': o1, 'fp16': f16, 'O2': o2,
                     'O2_step': o2s}}


def op_sweep() -> int:
    """Every case of the op library's table (tests/torch_op_cases.py) run
    on the card and on the CPU from the same seeded inputs: equal
    integer and bool outputs, float ones to rtol 1e-4 (or 10 times a
    case's own), TF32 off. Returns the number of cases checked."""
    import paddle_tpu_torch as ptt
    sys.path.insert(0, str(Path(__file__).resolve().parent / 'tests'))
    from torch_op_cases import CASES

    def leaves(out):
        if isinstance(out, (list, tuple)):
            return [x for o in out for x in leaves(o)]
        return [out]

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x.numpy() if hasattr(x, 'numpy') else x)

    t0 = time.perf_counter()
    n = 0
    for case in CASES:
        arrays = case.inputs()
        outs = []
        for place in (_place(), 'cpu'):
            with ptt.device_guard(place):
                ts = [ptt.to_tensor(a) for a in arrays]
                outs.append([host(x) for x in leaves(case.run(ptt, ts))])
        for g, w in zip(*outs):
            if g.dtype.kind in 'fc':
                np.testing.assert_allclose(
                    g, w, rtol=max(10 * case.rtol, 1e-4),
                    atol=max(10 * case.atol, 1e-5), equal_nan=True,
                    err_msg=f'op sweep: {case.name} on the card vs the CPU')
            else:
                np.testing.assert_array_equal(
                    g, w, err_msg=f'op sweep: {case.name} on the card vs '
                    f'the CPU')
        n += 1
    log(f'[eager] op sweep: {n} cases of {len({c.name for c in CASES})} '
        f'ops on the card equal the CPU in '
        f'{time.perf_counter() - t0:.1f} s')
    return n


def rest_of_training(trained: dict) -> dict:
    """Phases 5c-5f, each timed."""
    out = {}
    for key, fn in (('5c', lambda: train_rungs(trained)),
                    ('5d', train_offload),
                    ('5e', lambda: fault_tolerance(trained)),
                    ('5f', fit_resume)):
        t0 = time.perf_counter()
        out[key] = fn()
        log(f'[rest-of-training] phase {key} took '
            f'{time.perf_counter() - t0:.1f} s')
    return out


# ---------------------------------------------------------------------------
# phase 6: serve Llama-2-7B
# ---------------------------------------------------------------------------

SERVE_LENS = (13, 700, 48, 311, 96, 650, 27, 205, 512, 64, 400, 150)


def _run_serve(eng, prompts, params, adapter_ids, kernels, tag,
               base: int) -> dict:
    """One counted run of the 12 requests on `eng` after a warm-up: one
    short request (a graph engine captures its decode sub-step at its
    first round, and a capture empties the allocator's cache), then
    the same requests for one token each (a graph engine captures each
    prefill bucket's graph; every bucket's first cuBLAS plans, kernel
    shapes and cached blocks), so the counted run captures nothing. Each
    of `kernels`' launch counts is read around the counted run (graph
    replays counted) and required to be > 0. Every request must finish
    with 32 tokens; a graph engine must have captured its decode
    sub-step and each prefill bucket it used once, an eager one nothing.
    Peak memory is counted above `base` bytes."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import FINISHED, SamplingParams
    vocab = eng.model.config.vocab_size
    one = SamplingParams(max_new_tokens=1, eos_token_id=-1)
    eng.generate_many([prompts[0][:8]], one)
    eng.generate_many(prompts, one, adapter_ids=adapter_ids)
    eng.reset_stats()
    torch.cuda.reset_peak_memory_stats()

    K.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(p, sp, adapter_id=aid) for p, sp, aid in
               zip(prompts, params, adapter_ids or [None] * len(prompts))]
    peak_pages, rows = 0, pool_rows(eng.pool)
    while eng.has_work:
        eng.step()
        peak_pages = max(peak_pages, used_pages(eng.pool))
        rows = max(rows, pool_rows(eng.pool))
    wall = time.perf_counter() - t0
    launches = {k: K.LAUNCHES[k] for k in kernels}
    every = dict(K.LAUNCHES)

    st = eng.stats()
    for h in handles:
        if h.status != FINISHED or len(h.tokens) != 32:
            raise AssertionError(f'{tag}: request {h} did not finish with '
                                 f'32 tokens')
        if not all(0 <= t < vocab for t in h.tokens):
            raise AssertionError(f'{tag}: token out of range in {h.tokens}')
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f'{tag}: kernels never launched on the main '
                             f'path: {missing}')
    want_traces = expected_traces(eng, {
        ('whole', eng.pool.bucket_for(len(p)))
        for p in prompts + [prompts[0][:8]]})
    if st['traces'] != want_traces:
        raise AssertionError(f'{tag}: captures {st["traces"]}, want '
                             f'{want_traces}')
    ttft = sorted(h.ttft for h in handles)
    res = {
        'requests': len(handles), 'wall_s': wall,
        'prefills': st['prefills'],
        'prefill_tokens': st['prefill_tokens'],
        'prefill_bucket_tokens': st['prefill_bucket_tokens'],
        'prefill_s': st['prefill_seconds'],
        'prefill_tok_per_s': st['prefill_tokens'] / st['prefill_seconds'],
        'decode_tokens': st['tokens'], 'decode_s': st['decode_seconds'],
        'decode_tok_per_s': st['tokens'] / st['decode_seconds'],
        'decode_rounds': st['decode_rounds'],
        'decode_steps': st['decode_steps'],
        'ttft_mean_s': sum(ttft) / len(ttft), 'ttft_max_s': ttft[-1],
        'ttft_p50_s': ttft[len(ttft) // 2], 'peak_pages': peak_pages,
        'peak_allocated_rows': rows[0], 'stranded_rows': rows[1],
        'row_utilization': rows[2],
        'peak_mem_gb': (torch.cuda.max_memory_allocated() - base) / 1e9,
        'launches': launches, 'tokens': [h.tokens for h in handles],
        'every_launch': every,
    }
    log(f'[{tag}] {len(handles)} requests in {wall:.2f} s: prefill '
        f'{res["prefill_tok_per_s"]:.0f} tok/s ({st["prefill_tokens"]} '
        f'prompt tokens in {st["prefill_seconds"]:.3f} s), decode '
        f'{res["decode_tok_per_s"]:.1f} tok/s ({st["tokens"]} tokens in '
        f'{st["decode_seconds"]:.3f} s, {st["decode_rounds"]} rounds), TTFT '
        f'mean {res["ttft_mean_s"]:.3f} s p50 {res["ttft_p50_s"]:.3f} s max '
        f'{res["ttft_max_s"]:.3f} s, {pool_peak_note(eng.pool, res)}, peak '
        f'device memory {res["peak_mem_gb"]:.2f} GB above the '
        f'{base / 1e9:.2f} GB held before the engine was built; captures '
        f'{st["traces"]}')
    log(f'[{tag}] kernel launches on this run: {launches}')
    return res


def used_pages(pool) -> int:
    """Pages a paged pool has handed out (0 for a row pool, which holds
    its rows for good)."""
    return getattr(pool, 'used_page_count', 0)


def pool_rows(pool) -> tuple:
    """(allocated, stranded, utilization) of the pool's seated slots, from
    its `stats()` (allocated rows: whole rows in a row pool, reserved
    pages' rows in a paged one)."""
    st = pool.stats()
    alloc, written = st['allocated_rows'], st['written_rows']
    return alloc, alloc - written, written / alloc if alloc else 1.0


def pool_peak_note(pool, run: dict) -> str:
    """The pool's peak for a log line: pages (paged) and rows (both)."""
    pages = (f'pool peak {run["peak_pages"]} of {pool.num_pages - 1} pages, '
             if hasattr(pool, 'num_pages') else 'row pool, ')
    return (pages + f'at its most allocated {run["peak_allocated_rows"]} '
            f'rows ({run["stranded_rows"]} stranded, utilization '
            f'{run["row_utilization"]:.3f})')


def eager_twin(eng, **kw):
    """An engine with `eng`'s model, bank, pool dtype and settings (and
    `kw`) that runs its decode sub-steps and its prefills uncaptured: the
    eager reference of a graph engine (a row engine's twin is a row
    engine)."""
    from paddle_tpu_torch.serving import InferenceEngine
    layout = dict(kv_page_size=eng.pool.page_size,
                  kv_quant=eng.pool.quant) if eng._paged else {}
    kw.setdefault('dtype', eng.pool.compute_dtype)
    twin = InferenceEngine(eng.model, num_slots=eng.pool.num_slots,
                           max_length=eng.pool.max_length,
                           decode_block=eng.decode_block,
                           adapter_bank=eng.adapter_bank,
                           draft_model=eng.draft_model,
                           num_draft_tokens=eng.spec_k, **layout, **kw)
    twin._capture_decode = twin._capture_prefill = False
    return twin


def graph_equals_eager(eng, prompts, params, tag: str, **kw) -> list:
    """Serve `prompts` on `eng` (decode and prefill captured) and on its
    eager twin (with `kw`); every request's tokens must be equal.
    Returns them."""
    got = [h.tokens for h in eng.generate_many(prompts, params)]
    want = [h.tokens for h in eager_twin(eng, **kw).generate_many(
        prompts, params)]
    if got != want:
        raise AssertionError(f'{tag}: graph engine {got} != eager twin '
                             f'{want}')
    log(f'[{tag}] graph engine (captures {eng.stats()["traces"]}) == its '
        f'eager twin: {len(prompts)} requests, sampling included')
    return got


def expected_traces(eng, buckets) -> dict:
    """The `traces` of `eng` after its prefills ran at `buckets`
    ({(kind, bucket)}): one capture of the decode sub-step (or of a
    speculating engine's round) and one per prefill bucket and kind (the
    JAX engine's names; with a draft also its draft prefill at each
    whole bucket), or none at all for what runs eagerly."""
    out = {eng._decode_name: 1} if eng._capture_decode else {}
    if eng._capture_prefill:
        paged = 'paged_' if eng._paged else ''
        names = {'whole': f'{paged}prefill', 'chunk': f'{paged}chunk_prefill',
                 'draft': 'draft_prefill'}
        if eng.draft_model is not None:
            buckets = set(buckets) | {('draft', b) for kind, b in buckets
                                      if kind == 'whole'}
        out.update({f'{names[kind]}_{b}': 1 for kind, b in buckets})
    return out


def serve_eager(eng, res, prompts, params, adapter_ids, kernels,
                tag: str) -> dict:
    """The counted run of `_run_serve` on `eager_twin(eng)`: every request
    must get the graph run's (`res`) tokens, the seeded sampling one
    included. Logs both runs side by side; the result holds the eager
    engine under 'engine'."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    twin = eager_twin(eng)
    eager = _run_serve(twin, prompts, params, adapter_ids, kernels,
                       f'{tag} eager', base)
    for j, (a, b) in enumerate(zip(res['tokens'], eager['tokens'])):
        if a != b:
            at = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            raise AssertionError(
                f'{tag}: request {j}: graph and eager tokens differ first at '
                f'position {at} ({a[at]} vs {b[at]}): graph {a} eager {b}')
    log(f'[{tag}] graph == eager: the tokens of all {len(res["tokens"])} '
        f'requests are equal (sampling included)')
    for key, unit, fmt in (('decode_tok_per_s', 'tok/s', '.1f'),
                           ('prefill_tok_per_s', 'tok/s', '.0f'),
                           ('ttft_mean_s', 's', '.3f'),
                           ('ttft_p50_s', 's', '.3f'),
                           ('ttft_max_s', 's', '.3f'),
                           ('peak_mem_gb', 'GB', '.3f'),
                           ('wall_s', 's', '.3f')):
        log(f'[{tag}]   {key}: graph {res[key]:{fmt}} {unit}, eager '
            f'{eager[key]:{fmt}} {unit}')
    eager['engine'] = twin
    return eager


def serve(cfg, tag: str = 'serve') -> dict:
    """Phase 6 (`tag` 'serve'): Llama-2-7B of `cfg` in bf16 from phase 6's
    seed behind the graph engine (8 slots, pages of 16, decode_block 8)
    and its eager twin, phase 6's 12 requests. With another `tag`, the
    same at a cut depth: the model of the phases run at CUT_LAYERS."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import (SAMPLING, InferenceEngine,
                                          SamplingParams)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(1234, DEV))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16)
    log(f'[{tag}] Llama {cfg.num_hidden_layers} layers x {cfg.hidden_size} '
        f'bf16 built in {time.perf_counter() - t0:.1f} s, '
        f'{nbytes(*model.parameters()) / 1e9:.2f} GB of weights;'
        f' KV pool {eng.pool.num_pages} pages, '
        f'{eng.pool.pool_bytes / 1e9:.2f} GB')
    rng = np.random.RandomState(2)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in SERVE_LENS]
    params = [SamplingParams(max_new_tokens=32, eos_token_id=-1)
              for _ in prompts]
    params[5] = SamplingParams(max_new_tokens=32, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=7)
    res = _run_serve(eng, prompts, params, None, SERVE_KERNELS, tag, base)
    eager = serve_eager(eng, res, prompts, params, None, SERVE_KERNELS, tag)
    from paddle_tpu_torch.weights import param_digest
    res.update(engine=eng, eager=eager, prompts=prompts, params=params,
               digest=param_digest(model))
    return res


def serve_adapters(served) -> dict:
    """Phase 6's model, prompts, parameters and engine settings behind an
    engine with a bank of three adapters (capacity 4, rank 8, f32, on
    q/k/v/o_proj), request i under [base, ad0, ad1, ad2][i % 4], as
    bench.py mixes adapters. Requires the adapter kernel once per adapted
    projection of every prefill and decode forward (replays counted),
    base requests to get phase 6's tokens, some adapted request to differ
    from them, and the eager loop to give the same tokens."""
    from paddle_tpu_torch.serving import InferenceEngine
    model = served['engine'].model
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bank = adapter_bank(model, 3, 4)
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16, adapter_bank=bank)
    log(f'[serve-adapters] bank of 3 adapters over {len(bank.sites)} '
        f'projections built in {time.perf_counter() - t0:.1f} s')
    prompts = served['prompts']
    ids = [(None, 'ad0', 'ad1', 'ad2')[i % 4] for i in range(len(prompts))]
    res = _run_serve(eng, prompts, served['params'], ids, ADAPTER_KERNELS,
                     'serve-adapters', base)
    eager = serve_eager(eng, res, prompts, served['params'], ids,
                        ADAPTER_KERNELS, 'serve-adapters')
    for run, tag in ((res, 'graph'), (eager, 'eager')):
        want = len(bank.sites) * (run['prefills'] + run['decode_steps'])
        if run['launches']['adapter_matmul'] != want:
            raise AssertionError(
                f'serve-adapters ({tag}): {run["launches"]["adapter_matmul"]}'
                f' adapter launches, want {len(bank.sites)} x '
                f'({run["prefills"]} prefills + {run["decode_steps"]} decode '
                f'sub-steps) = {want}')
    base = [j for j, aid in enumerate(ids) if aid is None]
    wrong = [j for j in base if res['tokens'][j] != served['tokens'][j]]
    if wrong:
        raise AssertionError(f'serve-adapters: base requests {wrong} differ '
                             f'from phase 6')
    changed = [j for j, aid in enumerate(ids)
               if aid is not None and res['tokens'][j] != served['tokens'][j]]
    if not changed:
        raise AssertionError('serve-adapters: no adapted request differs '
                             'from phase 6')
    log(f'[serve-adapters] {res["launches"]["adapter_matmul"]} adapter '
        f'launches = {len(bank.sites)} x ({res["prefills"]} prefills + '
        f'{res["decode_steps"]} decode sub-steps, replays counted), and so '
        f'for the eager run; base requests {base} == phase 6; adapted '
        f'requests {changed} differ from it')
    log(f'[serve-adapters] beside phase 6 (same process): decode '
        f'{res["decode_tok_per_s"]:.1f} vs {served["decode_tok_per_s"]:.1f} '
        f'tok/s, prefill {res["prefill_tok_per_s"]:.0f} vs '
        f'{served["prefill_tok_per_s"]:.0f} tok/s, TTFT mean '
        f'{res["ttft_mean_s"]:.3f} vs {served["ttft_mean_s"]:.3f} s')
    res.update(engine=eng, eager=eager, prompts=prompts, ids=ids)
    return res


# ---------------------------------------------------------------------------
# phase 6k: the row engine (InferenceEngine's default layout)
# ---------------------------------------------------------------------------

ROW_ENGINE = dict(num_slots=8, max_length=1024, decode_block=8)
ROW_BUDGET_S = 60.0
ROW_ADAPTER_IDS = (None, 'ad0', 'ad1', None, 'ad1', 'ad0', None, 'ad0')


def _same_tokens(tag: str, got: list, want: list, what: str) -> None:
    """Every request's tokens of `got` equal `want`'s, or an error naming
    the first request and position that differ."""
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            raise AssertionError(f'{tag}: request {j} differs from {what} '
                                 f'first at {first_difference(a, b)}: {a} '
                                 f'vs {b}')
    if len(got) != len(want):
        raise AssertionError(f'{tag}: {len(got)} requests, {what} has '
                             f'{len(want)}')


def serve_row(served, spec, adapted) -> dict:
    """Phase 6k: the row engine (no layout argument: one KV row per slot,
    read through the paged kernel over its identity page table) on phase
    6's Llama-2-7B, with phase 6e's 2-layer draft and phase 6b's bank.

    1. Phase 6's 12 requests through `_run_serve` (graph) and
       `serve_eager`: each request's tokens equal phase 6's paged
       engine's (the same flash, RMSNorm and paged kernels on the same K/V
       values through a table of the same width), phase 6's launch gates,
       `decode_step` and one `prefill_<b>` per bucket captured once, and
       the eager twin's tokens equal.
    2. The prefix cache (0.25: 2 retained slots) and 256-token chunks over
       phase 6c's shared-prefix trace: the tokens equal a row engine's
       with the same chunks and no cache (the system prompt is two whole
       chunks, so both compute every row through the same chunks), the
       row copies equal the full-prompt hits, each chunk bucket is
       captured once, and the last prompt served again (retained last:
       a full hit) takes one row copy and gets its tokens again.
    3. Speculation with phase 6e's draft at k = SPEC_K: the tokens equal
       phase 6e's paged speculating engine's (the same verify arithmetic);
       how many equal step 1's is logged (a 5-row verify can round
       differently from a 1-row step in bf16).
    4. Eight requests, base and two adapters mixed, through phase 6b's
       bank: the tokens equal phase 6b's paged engine's with the bank, and
       the adapter kernel launches.
    Logs the row pool's bytes beside the paged pool's, decode and prefill
    tok/s and TTFT beside phase 6's, and the stranded rows and row
    utilization at each pool's most allocated step beside the paged
    pool's. The whole phase must take at
    most ROW_BUDGET_S seconds."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
    t_phase = time.perf_counter()
    model = served['engine'].model
    paged = served['engine'].pool
    prompts, params = served['prompts'], served['params']
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, **ROW_ENGINE)
    if eng.stats()['kv_layout'] != 'row':
        raise AssertionError(f'serve-row: InferenceEngine(model) built a '
                             f'{eng.stats()["kv_layout"]} engine')
    log(f'[serve-row] row pool {eng.pool.num_slots} slots x '
        f'{eng.pool.max_length} rows: {eng.pool.pool_bytes / 1e9:.2f} GB '
        f'(the paged pool of phase 6: {paged.num_pages} pages, '
        f'{paged.pool_bytes / 1e9:.2f} GB)')
    res = _run_serve(eng, prompts, params, None, SERVE_KERNELS, 'serve-row',
                     base)
    _same_tokens('serve-row', res['tokens'], served['tokens'],
                 'phase 6 (paged)')
    eager = serve_eager(eng, res, prompts, params, None, SERVE_KERNELS,
                        'serve-row')
    log(f'[serve-row] every request\'s tokens equal phase 6\'s paged '
        f'engine\'s (sampling included)')
    for key, unit, fmt in (('decode_tok_per_s', 'tok/s', '.1f'),
                           ('prefill_tok_per_s', 'tok/s', '.0f'),
                           ('ttft_mean_s', 's', '.3f'),
                           ('ttft_p50_s', 's', '.3f'),
                           ('stranded_rows', 'rows', 'd'),
                           ('row_utilization', '', '.3f')):
        log(f'[serve-row]   {key}: row {res[key]:{fmt}} {unit}, paged '
            f'(phase 6, same process) {served[key]:{fmt}} {unit}')
    release(res)

    # prefix cache and chunks, against the same chunks without a cache
    warm, trace = prefix_trace(model.config.vocab_size,
                               np.random.RandomState(5))
    tparams = prefix_params(len(trace))
    runs = {}
    for tag, opts in (('serve-row prefix', PREFIX_OPTS),
                      ('serve-row cold', {'prefill_chunk_tokens':
                                          PREFIX_OPTS['prefill_chunk_tokens']
                                          })):
        base = torch.cuda.memory_allocated()
        e = InferenceEngine(model, **ROW_ENGINE, **opts)
        runs[tag] = _run_prefix(e, warm, trace, tparams, tag, base)
        if opts is PREFIX_OPTS:
            # the last prompt again: retained last, so a full-prompt hit,
            # served by a copy of its row
            copies = e.pool.stats()['row_copies']
            again = e.generate_many(trace[-1:], tparams[-1:])[0]
            runs[tag]['repeat'] = (again.tokens, again._prefix_len,
                                   e.pool.stats()['row_copies'] - copies)
        del e
    pre, cold = runs['serve-row prefix'], runs['serve-row cold']
    _same_tokens('serve-row prefix', pre['tokens'], cold['tokens'],
                 'the row engine without a cache')
    if pre['row_copies'] != pre['full_hits']:
        raise AssertionError(f'serve-row prefix: {pre["row_copies"]} row '
                             f'copies, {pre["full_hits"]} full-prompt hits')
    toks, matched, copies = pre['repeat']
    if matched != len(trace[-1]) or copies != 1 or toks != pre['tokens'][-1]:
        raise AssertionError(f'serve-row prefix: the repeated last prompt '
                             f'matched {matched} of {len(trace[-1])} tokens, '
                             f'{copies} row copies, tokens {toks} vs '
                             f'{pre["tokens"][-1]}')
    if pre['hits'] < 1 or not any(k == 'chunk' for k, _ in pre['buckets']):
        raise AssertionError(f'serve-row prefix: {pre["hits"]} hits, '
                             f'prefills {pre["buckets"]}')
    log(f'[serve-row prefix] tokens == the cold row engine\'s for all '
        f'{len(trace)} requests; hits {pre["hits"]}, tokens reused '
        f'{pre["tokens_reused"]}, evictions {pre["evictions"]}, row copies '
        f'{pre["row_copies"]} = full hits {pre["full_hits"]} (and the repeated '
        f'last prompt: a full hit, one row copy, its tokens again), prompt '
        f'tokens computed {pre["prefill_tokens"]} vs {cold["prefill_tokens"]}, '
        f'TTFT mean {pre["ttft_mean_s"]:.3f} vs {cold["ttft_mean_s"]:.3f} s, '
        f'decode {pre["decode_tok_per_s"]:.1f} vs '
        f'{cold["decode_tok_per_s"]:.1f} tok/s')

    # speculation with phase 6e's draft
    base = torch.cuda.memory_allocated()
    e = InferenceEngine(model, num_slots=8, max_length=1024,
                        draft_model=spec['draft'], num_draft_tokens=SPEC_K)
    sres = _run_serve(e, prompts, params, None, SPEC_KERNELS,
                      'serve-row spec', base)
    if sres['launches']['paged_attention_verify'] != \
            model.config.num_hidden_layers * sres['decode_steps']:
        raise AssertionError(f'serve-row spec: '
                             f'{sres["launches"]["paged_attention_verify"]} '
                             f'verify launches for {sres["decode_steps"]} '
                             f'rounds')
    _same_tokens('serve-row spec', sres['tokens'], spec['draft2']['tokens'],
                 'phase 6e\'s paged speculating engine')
    same = sum(a == b for a, b in zip(sres['tokens'], served['tokens']))
    log(f'[serve-row spec] k={SPEC_K}: tokens == phase 6e\'s paged '
        f'speculating engine\'s for all {len(prompts)} requests; {same} of '
        f'{len(prompts)} equal step 1\'s (plain decode); decode '
        f'{sres["decode_tok_per_s"]:.1f} tok/s (6e paged '
        f'{spec["draft2"]["decode_tok_per_s"]:.1f})')
    del e
    release(sres)

    # adapters through phase 6b's bank, against phase 6b's paged engine
    bank = adapted['engine'].adapter_bank
    ids = list(ROW_ADAPTER_IDS)
    few, fparams = prompts[:len(ids)], params[:len(ids)]
    want = [h.tokens for h in adapted['engine'].generate_many(
        few, fparams, adapter_ids=ids)]
    base = torch.cuda.memory_allocated()
    e = InferenceEngine(model, **ROW_ENGINE, adapter_bank=bank)
    e.generate_many(few, [SamplingParams(max_new_tokens=1,
                                         eos_token_id=-1)] * len(ids),
                    adapter_ids=ids)
    K.reset_launch_counts()
    got = [h.tokens for h in e.generate_many(few, fparams, adapter_ids=ids)]
    ad_launches = K.LAUNCHES['adapter_matmul']
    _same_tokens('serve-row adapters', got, want, 'phase 6b\'s paged engine')
    if ad_launches <= 0:
        raise AssertionError('serve-row adapters: the adapter kernel never '
                             'launched')
    log(f'[serve-row adapters] {len(ids)} requests ({ids}): tokens == phase '
        f'6b\'s paged engine\'s; {ad_launches} adapter launches')
    del e
    launches = collections.Counter(res['launches'])
    for run in (eager, pre, sres):
        launches.update(run['launches'])
    launches['adapter_matmul'] += ad_launches
    release(eager)
    seconds = time.perf_counter() - t_phase
    log(f'[serve-row] phase 6k took {seconds:.1f} s (budget '
        f'{ROW_BUDGET_S:.0f} s)')
    if seconds > ROW_BUDGET_S:
        raise AssertionError(f'serve-row: phase 6k took {seconds:.1f} s, '
                             f'over its {ROW_BUDGET_S:.0f} s budget')
    return {'launches': dict(launches), 'seconds': seconds,
            'decode_tok_per_s': res['decode_tok_per_s'],
            'stranded_rows': res['stranded_rows']}


# ---------------------------------------------------------------------------
# phase 6c: serve with the prefix cache and chunked prefill
# ---------------------------------------------------------------------------

# bench.py:stack_ab's shared-system-prompt trace (:1480) at the serve
# cell's lengths, with paged_ab's / stack_ab's engine options
PREFIX_SYSTEM, PREFIX_COLD = 512, 900
# phase 6l: the KV pool in another float dtype than the model's
# (`InferenceEngine(dtype=)`); its budget, the 2-layer runs' requests
# (four of SERVE_LENS), and the first decode sub-step's limits against
# the port's plain path on the CPU with the same pool dtype (relative
# logit RMSE; int8 pages round through the pool's compute dtype too, so
# a value near an int8 or a 16-bit boundary may round the other way on
# one side)
KV_DTYPE_BUDGET_S = 30.0
KV_DTYPE_LENS = (13, 48)
KV_DTYPE_RMSE = {None: 2e-3, 'int8': 2e-2}


def _kv_dtype_launches(every: dict) -> dict:
    """The launches of the paged kernel's pairs of another pool dtype."""
    return {k: n for k, n in every.items() if '_kv' in k and n}


def serve_kv_dtype(served) -> dict:
    """Phase 6l. (a) Phase 6's bf16 Llama-2-7B (32 layers) behind the
    graph engine with `dtype='float32'` (the JAX engine's default pool, at
    twice phase 6's KV bytes) and its eager twin, phase 6's 12 requests:
    graph == eager, and every request's tokens and the first decode
    sub-step's logits equal phase 6's bit for bit: the decode runs the
    (bf16 q, f32 pages) kernel, whose f32 tiles keep the 16-bit column
    order, so it sums in the bf16 kernel's order over the same values
    (the pool holds the bf16 rows exactly). (b) At 2 layers of Llama-2-7B's width, a model in each of
    f32, bf16 and fp16 behind engines with each other pool dtype, float
    and int8 pages (12 engines, each pair of the paged kernel on the
    path): 2 requests x 8 tokens, graph == eager; for the f32 model the
    first decode sub-step's logits within KV_DTYPE_RMSE of the port's
    plain path on the CPU with the same pool dtype. Fails past
    KV_DTYPE_BUDGET_S."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
    t0 = time.perf_counter()
    launches = collections.Counter()
    key = K.paged_key(3, False, torch.bfloat16, 128, torch.float32)
    model = served['engine'].model
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16, dtype='float32')
    own = served['engine'].pool.pool_bytes
    log(f'[serve-kv-dtype] phase 6\'s model with dtype=\'float32\': KV pool '
        f'{eng.pool.pool_bytes / 1e9:.2f} GB of f32 pages (phase 6: '
        f'{own / 1e9:.2f} GB, x{eng.pool.pool_bytes / own:.2f}); the decode '
        f'counts under {key}')
    kernels = ('flash_attention_fwd', key, 'rms_norm')
    res = _run_serve(eng, served['prompts'], served['params'], None,
                     kernels, 'serve-kv-dtype', base)
    eager = serve_eager(eng, res, served['prompts'], served['params'], None,
                        kernels, 'serve-kv-dtype')
    for run in (res, eager):
        launches.update(run['launches'])
    same = [a == b for a, b in zip(res['tokens'], served['tokens'])]
    wide = first_step_logits(eng, served['prompts'])
    narrow = first_step_logits(served['engine'], served['prompts'])
    d = (wide.double() - narrow.double()).abs().max().item()
    log(f'[serve-kv-dtype] {sum(same)} of {len(same)} requests get phase '
        f'6\'s tokens (bf16 pool); the first decode sub-step\'s logits '
        + ('equal phase 6\'s bit for bit' if d == 0 else
           f'differ from phase 6\'s by up to {d:.3e}'))
    if not all(same) or d != 0:
        raise AssertionError(
            f'serve-kv-dtype: over an f32 pool the bf16 model must read the '
            f'bits of its bf16 pool (the f32 tiles keep the 16-bit column '
            f'order): requests differing '
            f'{[i for i, ok in enumerate(same) if not ok]}, logits {d:.3e}')
    del eng, eager
    release(res)
    # (b) every pair at 2 layers of the width
    rng = np.random.RandomState(2)
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in KV_DTYPE_LENS]
    params = SamplingParams(max_new_tokens=8, eos_token_id=-1)
    names = {torch.float32: 'float32', torch.bfloat16: 'bfloat16',
             torch.float16: 'float16'}
    for mdt in (torch.float32, torch.bfloat16, torch.float16):
        model = LlamaForCausalLM(cfg, device=DEV, dtype=names[mdt],
                                 generator=ptt.generator(0, DEV))
        cpu = (copy.deepcopy(model).to('cpu') if mdt == torch.float32
               else None)
        for pdt in (d for d in names if d != mdt):
            for quant in (None, 'int8'):
                tag = (f'kv-dtype {_SHORT[mdt]} model, {_SHORT[pdt]} '
                       + ('int8 pool' if quant else 'pool'))
                kw = dict(num_slots=8, max_length=1024, decode_block=8,
                          kv_page_size=16, kv_quant=quant,
                          dtype=names[pdt])
                eng = InferenceEngine(model, **kw)
                K.reset_launch_counts()
                graph_equals_eager(eng, prompts, params, tag)
                pair = K.paged_key(3, quant is not None, mdt, 128, pdt)
                if K.LAUNCHES[pair] <= 0:
                    raise AssertionError(f'{tag}: {pair} never launched')
                launches.update({k: n for k, n in K.LAUNCHES.items() if n})
                note = ''
                if cpu is not None:
                    got = first_step_logits(eng, prompts)
                    want = first_step_logits(InferenceEngine(cpu, **kw),
                                             prompts)
                    err = rel_rmse(got.cpu(), want)
                    note = (f'; first decode sub-step vs the CPU plain path '
                            f'with the same pool: relative RMSE {err:.3e} '
                            f'(limit {KV_DTYPE_RMSE[quant]})')
                    if err > KV_DTYPE_RMSE[quant]:
                        raise AssertionError(f'{tag}{note}')
                log(f'[{tag}] {pair} launched {K.LAUNCHES[pair]} times'
                    f'{note}')
                del eng
        del model, cpu
        torch.cuda.empty_cache()
    dt = time.perf_counter() - t0
    log(f'[serve-kv-dtype] phase 6l took {dt:.1f} s (budget '
        f'{KV_DTYPE_BUDGET_S:.0f} s); launches of the pairs '
        + json.dumps(_kv_dtype_launches(launches)))
    if dt > KV_DTYPE_BUDGET_S:
        raise AssertionError(f'phase 6l took {dt:.1f} s, over its budget')
    return {'launches': dict(launches)}


PREFIX_SUFFIXES = (3, 30, 9, 44, 200, 380)
PREFIX_ENGINE = dict(num_slots=8, max_length=1024, decode_block=8,
                     kv_page_size=16)
PREFIX_OPTS = dict(prefix_cache=0.25, prefill_chunk_tokens=256)
PREFIX_MIN_HITS = 13
# the depth of the phases that run on a cut copy of phase 6's model
# (6f, 6c, 6d and 6e's self-draft arm), which keeps the whole smoke
# inside its time limit
CUT_LAYERS = 8


def prefix_trace(vocab: int, rng) -> tuple:
    """(warm-up prompt, 16 prompts). The warm-up is the 512-token system
    prompt + 32 tokens: 34 whole pages, which it leaves in the cache at
    retirement. The 16: 13 with the system prompt and a suffix of
    PREFIX_SUFFIXES[i % 6] tokens, an exact repeat of the warm-up (the
    only full hit: the cache holds whole pages only), and two cold
    900-token prompts (4 chunk rounds of 256 each)."""
    system = rng.randint(3, vocab, (PREFIX_SYSTEM,)).tolist()
    warm = system + rng.randint(3, vocab, (32,)).tolist()
    shared = [system + rng.randint(3, vocab, (n,)).tolist()
              for n in (PREFIX_SUFFIXES * 3)[:13]]
    cold = [rng.randint(3, vocab, (PREFIX_COLD,)).tolist() for _ in range(2)]
    return warm, (shared[:6] + cold[:1] + shared[6:10] + [warm]
                  + shared[10:] + cold[1:])


def prefix_params(n: int) -> list:
    """The serve-prefix trace's parameters: 32 greedy tokens each, request
    3 sampling (seeded)."""
    from paddle_tpu_torch.serving import SAMPLING, SamplingParams
    params = [SamplingParams(max_new_tokens=32, eos_token_id=-1)
              for _ in range(n)]
    params[3] = SamplingParams(max_new_tokens=32, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=11)
    return params


def _run_prefix(eng, warm, prompts, params, tag: str, base: int,
                kernels=SERVE_KERNELS) -> dict:
    """The warm-up prompt alone (it seeds the cache), then the trace once
    (a graph engine captures the prefill buckets the trace uses, and a
    capture's warm-up launches count), then a fresh cache and the
    warm-up prompt again, so that the counted run starts from the same
    state, runs the same buckets and captures nothing. The counted run
    of `prompts` is stepped by hand to read the pool's peak of used
    pages; launches of `kernels` (the flash forward's key first) are
    read around it, and the flash forward must have launched once per
    layer of every whole prefill and chunk (graph replays counted). Every request must finish with 32
    tokens in range, and `traces` must name exactly the decode sub-step
    and the (kind, bucket) of every prefill the runs ran, for what the
    engine captures."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import FINISHED, SamplingParams
    vocab = eng.model.config.vocab_size
    sp_warm = SamplingParams(max_new_tokens=32, eos_token_id=-1)
    buckets = collections.Counter()
    run_prefill = eng._run_prefill

    def recorded(slot, kind, window, bucket, **staged):
        buckets[(kind, bucket)] += 1
        run_prefill(slot, kind, window, bucket, **staged)

    eng._run_prefill = recorded
    try:
        t0 = time.perf_counter()
        eng.generate_many([warm], sp_warm)
        eng.generate_many(prompts, params)
        warm_s = time.perf_counter() - t0
        capture_s = eng.stats()['capture_seconds']
        if eng.prefix_cache is not None:
            # a fresh cache: the warm-up pass's refused inserts (every
            # entry pinned, the budget full) leave bare trie nodes, which
            # clear() does not prune and later lookups descend into, so
            # they change the hits (tests/test_torch_prefix_cache.py:
            # test_refused_insert_leaves_the_same_trie_as_jax)
            eng.prefix_cache.clear(force=True)
            eng.prefix_cache = type(eng.prefix_cache)(
                eng.pool, PREFIX_OPTS['prefix_cache'])
        eng.generate_many([warm], sp_warm)
        traces = eng.stats()['traces']
        warm_buckets = set(buckets)
        buckets.clear()
        eng.reset_stats()
        cache0 = eng.prefix_cache.stats() if eng.prefix_cache else {}
        pool0 = eng.pool.stats()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
        peak_pages = 0
        while eng.has_work:
            eng.step()
            peak_pages = max(peak_pages, used_pages(eng.pool))
        wall = time.perf_counter() - t0
    finally:
        del eng._run_prefill
    launches = {k: K.LAUNCHES[k] for k in kernels}
    for h in handles:
        if h.status != FINISHED or len(h.tokens) != 32 or \
                not all(0 <= t < vocab for t in h.tokens):
            raise AssertionError(f'{tag}: request {h} did not finish with '
                                 f'32 tokens in range')
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f'{tag}: kernels never launched on the main '
                             f'path: {missing}')
    st = eng.stats()
    want_traces = expected_traces(eng, warm_buckets)
    if traces != want_traces or st['traces'] != traces:
        raise AssertionError(f'{tag}: captures {traces} before the counted '
                             f'run and {st["traces"]} after it, want '
                             f'{want_traces}')
    if not set(buckets) <= warm_buckets:
        raise AssertionError(f'{tag}: the counted run ran prefills at '
                             f'{sorted(set(buckets) - warm_buckets)}, which '
                             f'the warm-up did not')
    layers = eng.model.config.num_hidden_layers
    want_flash = layers * (st['prefills'] + st['chunk_rounds'])
    if launches[kernels[0]] != want_flash:
        raise AssertionError(
            f'{tag}: {launches[kernels[0]]} flash launches, want '
            f'{layers} x ({st["prefills"]} prefills + {st["chunk_rounds"]} '
            f'chunks) = {want_flash}')
    cache = st.get('prefix_cache', {})
    ttft = sorted(h.ttft for h in handles)
    res = {
        'requests': len(handles), 'wall_s': wall,
        'hits': cache.get('hits', 0) - cache0.get('hits', 0),
        'tokens_reused': (cache.get('tokens_reused', 0)
                          - cache0.get('tokens_reused', 0)),
        'evictions': cache.get('evictions', 0) - cache0.get('evictions', 0),
        'chunk_rounds': st['chunk_rounds'],
        'chunked_prefills': st['chunked_prefills'],
        'cow_splits': (st['pool'].get('cow_splits', 0)
                       - pool0.get('cow_splits', 0)),
        'row_copies': (st['pool'].get('row_copies', 0)
                       - pool0.get('row_copies', 0)),
        'full_hits': sum(h._prefix_len >= len(h.prompt_tokens)
                         for h in handles),
        'prefills': st['prefills'], 'requeued': st['requeued'],
        'prefill_tokens': st['prefill_tokens'],
        'prefill_s': st['prefill_seconds'],
        'decode_tokens': st['tokens'], 'decode_s': st['decode_seconds'],
        'decode_tok_per_s': st['tokens'] / st['decode_seconds'],
        'decode_steps': st['decode_steps'],
        'ttft_mean_s': sum(ttft) / len(ttft), 'ttft_max_s': ttft[-1],
        'ttft_p50_s': ttft[len(ttft) // 2],
        'peak_pages': peak_pages,
        'peak_mem_gb': (torch.cuda.max_memory_allocated() - base) / 1e9,
        'launches': launches, 'buckets': dict(sorted(buckets.items())),
        'capture_s': capture_s, 'warm_s': warm_s,
        'tokens': [h.tokens for h in handles],
    }
    log(f'[{tag}] {len(handles)} requests in {wall:.2f} s: prefix hits '
        f'{res["hits"]}, tokens reused {res["tokens_reused"]}, chunk rounds '
        f'{res["chunk_rounds"]} ({res["chunked_prefills"]} chunked '
        f'prefills), COW splits {res["cow_splits"]}, whole prefills '
        f'{res["prefills"]}, prompt tokens computed {res["prefill_tokens"]}'
        f' in {res["prefill_s"]:.3f} s, decode {res["decode_tok_per_s"]:.1f}'
        f' tok/s, TTFT mean {res["ttft_mean_s"]:.3f} s p50 '
        f'{res["ttft_p50_s"]:.3f} s max {res["ttft_max_s"]:.3f} s, '
        + (f'pool peak {peak_pages} of {eng.pool.num_pages - 1} pages'
           if eng._paged else f'row copies {res["row_copies"]} (full hits '
                              f'{res["full_hits"]})')
        + f', requeued {res["requeued"]}, peak device memory '
        f'{res["peak_mem_gb"]:.2f} GB above {base / 1e9:.2f} GB')
    log(f'[{tag}] kernel launches {launches} (flash = {layers} x every '
        f'prefill and chunk); prefills by (kind, bucket) {res["buckets"]}; '
        f'captures {traces} in {capture_s:.2f} s of the {warm_s:.2f} s '
        f'warm-up')
    return res


def prefix_logits(eng, prompt) -> dict:
    """The last prompt position's logits of `prompt` (a suffix hit)
    through the prefix path, on a slot of `eng`'s pool: the cached pages
    attached, then the suffix through the chunk forward. They must equal,
    bit for bit, the same split computed without the cache (the prompt's
    prefix prefilled into a second slot's own pages, then the same suffix
    chunk): the attached pages hold what a prefill writes. And the chunk
    forward of the whole prompt from row 0 must equal a cold whole-prompt
    forward (no pages) bit for bit. Together they leave, between the
    prefix path and the cold forward, only the split of one forward into
    a prefix and a suffix chunk, whose bf16 sums (products over 44 rows
    instead of 556) run in another order through 32 layers: that reading
    is logged, not held to `compare`'s limits (PERF.md, section 6)."""
    from paddle_tpu_torch.nlp import chunk_forward
    from paddle_tpu_torch.serving import scatter_pages
    pool, ps, model = eng.pool, eng.pool.page_size, eng.model
    node, matched = eng.prefix_cache.lookup(prompt)
    if node is None:
        raise AssertionError('serve-prefix: the logits check found no '
                             'cached prefix')
    cursor = min(matched, node.slot.kv_len) // ps * ps
    fwd = chunk_forward(model)
    ids = torch.tensor([prompt], device=DEV)
    slots = [pool.alloc(), pool.alloc()]
    try:
        pool.attach_prefix(slots[0], node.slot, cursor // ps)
        tables = []
        for slot in slots:
            pool.reserve(slot, len(prompt))
            tables.append(torch.from_numpy(
                pool.page_table[slot:slot + 1]).to(DEV))
        with torch.inference_mode():
            got = fwd(ids[:, cursor:], pool.pages, cursor, tables[0],
                      cursor)[0, -1]
            scatter_pages(pool.pages, tables[1],
                          model.prefill_kv(ids[:, :cursor]),
                          torch.zeros(1, dtype=torch.long, device=DEV))
            split = fwd(ids[:, cursor:], pool.pages, cursor, tables[1],
                        0)[0, -1]
            whole = fwd(ids, pool.pages, 0, tables[1], 0)[0, -1]
            cold = model(ids)[0, -1]
    finally:
        for slot in slots:
            pool.free(slot)
    if not torch.equal(got, split):
        raise AssertionError(f'serve-prefix: logits through the attached '
                             f'pages differ from the same split without '
                             f'the cache: {readings(got, split)}')
    if not torch.equal(whole, cold):
        raise AssertionError(f'serve-prefix: the chunk forward of the whole '
                             f'prompt differs from the cold forward: '
                             f'{readings(whole, cold)}')
    r = readings(got, cold)
    log(f'[serve-prefix] logits of a {len(prompt)}-token prompt through '
        f'{cursor} attached rows + its {len(prompt) - cursor}-token suffix '
        f'== the same split without the cache, bit for bit; the whole '
        f'prompt through the chunk forward == the cold forward, bit for '
        f'bit; the prefix path vs the cold forward: max_abs_err '
        f'{r["max_abs_err"]:.3e} rel_max {r["rel_max"]:.3e} rel_norm '
        f'{r["rel_norm"]:.3e} (bf16 summation order, not a limit), argmax '
        f'{int(got.argmax())} vs {int(cold.argmax())}')
    return r


def pages_free_after_clear(eng, tag: str) -> None:
    eng.prefix_cache.clear(force=True)
    pool = eng.pool
    if pool.free_page_count != pool.num_pages - 1 or \
            pool.stats()['holds_live']:
        raise AssertionError(f'{tag}: after clear(force=True) '
                             f'{pool.used_page_count} pages are still used '
                             f'({pool.stats()["holds_live"]} holds)')
    log(f'[{tag}] after prefix_cache.clear(force=True) all '
        f'{pool.num_pages - 1} pages are free')


def check_prefix_consistency(cfg) -> None:
    """At 2 layers of Llama-2-7B width in f32: the prefix/chunk engine
    (the serve-prefix settings) after the warm-up prompt, over a suffix
    hit of 3, 44 and 380 tokens (two chunks), a cold 900-token prompt
    (four) and the warm-up's exact repeat (a full hit, COW), gives each
    request the tokens of an engine without cache or chunking and of a
    no-cache full recompute (16 greedy tokens)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(0, DEV))
    warm, trace = prefix_trace(cfg.vocab_size, np.random.RandomState(6))
    prompts = [trace[i] for i in (0, 3, 5, 6, 11)]
    sp = SamplingParams(max_new_tokens=16, eos_token_id=-1)
    runs = []
    for opts, graph in ((PREFIX_OPTS, True), (PREFIX_OPTS, False), ({}, True)):
        eng = InferenceEngine(model, **PREFIX_ENGINE, **opts)
        eng._capture_decode = eng._capture_prefill = graph
        eng.generate_many([warm], sp)
        runs.append([h.tokens for h in eng.generate_many(prompts, sp)])
        st = eng.stats()
        if opts:
            pc = st['prefix_cache']
            if pc['hits'] < 4 or st['pool']['cow_splits'] != 1 or \
                    st['chunk_rounds'] < 7:
                raise AssertionError(
                    f'prefix consistency: hits {pc["hits"]}, COW '
                    f'{st["pool"]["cow_splits"]}, chunk rounds '
                    f'{st["chunk_rounds"]}: the trace missed a path')
            pages_free_after_clear(eng, 'prefix-consistency')
        del eng
    with torch.inference_mode():
        for j, prompt in enumerate(prompts):
            seq = list(prompt)
            for _ in range(16):
                seq.append(int(model(torch.tensor([seq], device=DEV))
                               [0, -1].argmax()))
            ref = seq[len(prompt):]
            if not runs[0][j] == runs[1][j] == runs[2][j] == ref:
                raise AssertionError(
                    f'prefix consistency: prompt len {len(prompt)}: '
                    f'prefix/chunk engine {runs[0][j]}, its eager twin '
                    f'{runs[1][j]}, cold engine {runs[2][j]}, full '
                    f'recompute {ref}')
    log(f'[prefix-consistency] 2 layers f32, {len(prompts)} requests x 16 '
        f'greedy tokens (suffix hits of 3/44/380 tokens, a cold 900-token '
        f'prompt in chunks, a full hit with its COW split): prefix/chunk '
        f'engine (prefill captured per bucket) == its eager twin == cold '
        f'engine == no-cache full recompute')
    del model
    torch.cuda.empty_cache()


# the serve-prefix engines: (tag, options, decode captured, prefill
# captured). 'eager-prefill' is the configuration before the prefill was
# captured (decode graph, eager prefill), beside the same engine now
PREFIX_RUNS = (
    ('serve-prefix', PREFIX_OPTS, True, True),
    ('serve-prefix eager', PREFIX_OPTS, False, False),
    ('serve-prefix eager-prefill', PREFIX_OPTS, True, False),
    ('serve-prefix cold', {}, True, True),
    ('serve-prefix cold eager-prefill', {}, True, False))
# the prefills phase 7 profiles, with their walls taken here:
# (kind, bucket, start)
PROFILED_PREFILLS = (('whole', 1024, 0), ('chunk', 256, 512))


def reserved_gb() -> float:
    """The device memory PyTorch holds after a collection and the release
    of its cached free blocks (a graph's pool stays held), GB."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 1e9


def prefill_wall(eng, kind: str, bucket: int, start: int = 0,
                 reps: int = 5) -> float:
    """Median host seconds of one prefill of `eng` of `kind` at `bucket`
    (a chunk at `start`, its floor there) into a fresh slot through the
    engine's own call (staging, the step, a device sync), after one
    untimed call (a graph engine captures the bucket there if it has
    not)."""
    pool = eng.pool
    slot = pool.alloc()
    try:
        pool.reserve(slot, start + bucket)
        ids = np.random.RandomState(bucket).randint(
            3, eng.model.config.vocab_size, (bucket,))
        staged = dict(start=start, floor=start) if kind == 'chunk' else {}
        walls = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            eng._run_prefill(slot, kind, ids, bucket, **staged)
            walls.append(time.perf_counter() - t0)
    finally:
        pool.free(slot)
    return sorted(walls[1:])[reps // 2]


def serve_prefix(served) -> dict:
    """Phase 6's Llama-2-7B behind the serve-prefix engine (PREFIX_ENGINE
    + PREFIX_OPTS, decode and prefill captured), its eager twin, the
    same engine with its prefill eager (the configuration before the
    prefill was captured) and two cold twins (no cache, no chunking;
    prefill captured and eager), each warmed as `_run_prefix` says; one
    request samples (seeded). Gates: graph == eager == eager-prefill
    tokens, prefix hits >= 13, one COW split, the flash forward once per
    layer of every prefill and chunk, a chunk bucket run, the prefix
    path's logits (`prefix_logits`), and every page free after a forced
    clear. Logs each engine beside the cold twins, the device memory
    each engine holds after its captures, and the walls of the prefills
    phase 7 profiles, captured and eager."""
    from paddle_tpu_torch.serving import InferenceEngine
    model = served['engine'].model
    warm, prompts = prefix_trace(model.config.vocab_size,
                                 np.random.RandomState(5))
    params = prefix_params(len(prompts))
    runs = {}
    for tag, opts, decode_graph, prefill_graph in PREFIX_RUNS:
        r0 = reserved_gb()
        base = torch.cuda.memory_allocated()
        eng = InferenceEngine(model, **PREFIX_ENGINE, **opts)
        eng._capture_decode, eng._capture_prefill = decode_graph, prefill_graph
        runs[tag] = run = _run_prefix(eng, warm, prompts, params, tag, base)
        run['reserved_gb'] = reserved_gb() - r0
        log(f'[{tag}] device memory the engine holds after its captures '
            f'(reserved): {run["reserved_gb"]:.3f} GB (its KV pool: '
            f'{eng.pool.pool_bytes / 1e9:.3f} GB)')
        if 'cold' not in tag:
            run['engine'] = eng
        del eng      # a cold twin goes here, before the next baseline
    res, eager, parent = (runs[t] for t in (
        'serve-prefix', 'serve-prefix eager', 'serve-prefix eager-prefill'))
    for j, (a, b, c) in enumerate(zip(res['tokens'], eager['tokens'],
                                      parent['tokens'])):
        if not a == b == c:
            raise AssertionError(f'serve-prefix: request {j}: graph {a}, '
                                 f'eager {b}, eager prefill {c}')
    if res['hits'] < PREFIX_MIN_HITS or res['cow_splits'] != 1:
        raise AssertionError(f'serve-prefix: {res["hits"]} prefix hits '
                             f'(want >= {PREFIX_MIN_HITS}), '
                             f'{res["cow_splits"]} COW splits (want 1)')
    if not any(kind == 'chunk' for kind, _ in res['buckets']):
        raise AssertionError('serve-prefix: no chunk prefill ran')
    cold = runs['serve-prefix cold']
    same = sum(a == b for a, b in zip(res['tokens'], cold['tokens']))
    log(f'[serve-prefix] graph == eager == eager prefill: the tokens of all '
        f'{len(prompts)} requests are equal (sampling included); '
        f'{same} of {len(prompts)} equal the cold twin\'s (bf16: a '
        f'suffix chunk sums its projections in another order than a whole '
        f'prefill)')
    for key, fmt in (('hits', 'd'), ('tokens_reused', 'd'),
                     ('chunk_rounds', 'd'), ('cow_splits', 'd'),
                     ('prefill_tokens', 'd'), ('prefill_s', '.3f'),
                     ('decode_tok_per_s', '.1f'), ('ttft_mean_s', '.3f'),
                     ('ttft_p50_s', '.3f'), ('ttft_max_s', '.3f'),
                     ('peak_pages', 'd'), ('wall_s', '.3f'),
                     ('capture_s', '.3f'), ('reserved_gb', '.3f')):
        log(f'[serve-prefix]   {key}: ' + ', '.join(
            f'{tag[13:] or "prefix/chunk"} {run[key]:{fmt}}'
            for tag, run in runs.items()))
    for tag in ('serve-prefix', 'serve-prefix eager-prefill'):
        for cold_tag in ('serve-prefix cold', 'serve-prefix cold '
                                              'eager-prefill'):
            run, c = runs[tag], runs[cold_tag]
            log(f'[serve-prefix]   {tag[13:] or "prefix/chunk"} against '
                f'{cold_tag[13:]}: prefill wall {run["prefill_s"]:.3f} vs '
                f'{c["prefill_s"]:.3f} s, TTFT mean {run["ttft_mean_s"]:.3f}'
                f' vs {c["ttft_mean_s"]:.3f} s (p50 {run["ttft_p50_s"]:.3f} '
                f'vs {c["ttft_p50_s"]:.3f}, max {run["ttft_max_s"]:.3f} vs '
                f'{c["ttft_max_s"]:.3f}), decode '
                f'{run["decode_tok_per_s"]:.1f} vs '
                f'{c["decode_tok_per_s"]:.1f} tok/s')
    eng = res['engine']
    res['logits'] = prefix_logits(eng, prompts[3])
    for tag in ('serve-prefix', 'serve-prefix eager',
                'serve-prefix eager-prefill'):
        pages_free_after_clear(runs[tag]['engine'], tag)
    # before any profiling: the walls phase 7 sets its device times beside
    res['walls'] = {}
    for kind, bucket, start in PROFILED_PREFILLS:
        for label, e in (('captured', eng), ('eager', parent['engine'])):
            res['walls'][(kind, bucket, label)] = w = prefill_wall(
                e, kind, bucket, start)
            log(f'[serve-prefix] {kind} prefill at bucket {bucket}'
                + (f' (start {start})' if kind == 'chunk' else '')
                + f', {label}: wall {w * 1e3:.2f} ms (median of 5)')
    ms = whole_row_gather_ms(eng)
    layers = model.config.num_hidden_layers
    log(f'[serve-prefix] the captured chunk\'s whole-row gather: '
        f'{ms:.4f} ms of device time per layer (K and V, '
        f'{eng.pool.max_length} rows), {layers * ms:.3f} ms per chunk '
        f'forward of {layers} layers')
    res['gather_ms'] = ms
    res['eager'], res['eager_prefill'] = eager, parent
    release(eager)
    return res


# ---------------------------------------------------------------------------
# phase 6d: serve with int8 paged KV
# ---------------------------------------------------------------------------

# the JAX package's int8 KV quality bound: relative decode-logit RMSE
# against float KV (bench.py:1537, PAGED_INT8_RMSE_BOUND; a copy, as
# bench.py is the JAX side's), set on the bench's 4-layer f32 GPT
# (bench.py:1153-1165, paged_int8_rmse :1540). The scheme's own error
# grows with depth: on random-weight Llama-2-7B width, the bench's int8
# arm (pages roundtripped through int8) is 0.025 at 2 f32 layers and
# 0.081 at 32 (`python3 chip_smoke.py --int8-rmse`; PERF.md). So
# the bound gates phase 3 (2 f32 layers); at 32 layers (phase 6d) the
# port's int8 KV must cost no more than INT8_REF_SLACK times the
# bench's int8 arm on the same model and prompts.
INT8_RMSE_BOUND = 0.05
INT8_REF_SLACK = 1.25
# f32: the int8 engine against the float engine over int8-roundtripped
# pages (the same function, sums in another order; 1.2e-6 measured)
INT8_EXACT = 1e-4


def roundtrip_pages(pool) -> None:
    """Every page of a float pool through int8 and back, in place, each
    at its own per-(page, kv head) absmax scale: the JAX bench's int8 arm
    (bench.py:paged_int8_rmse's `roundtrip`)."""
    from paddle_tpu_torch.quantization import (kv_dequantize_page,
                                               kv_page_scales,
                                               kv_quantize_page)
    for kv in pool.pages:
        for t in kv:
            sc = kv_page_scales(t)
            t.copy_(kv_dequantize_page(kv_quantize_page(t, sc), sc, t.dtype))


def first_step_logits(eng, prompts, roundtrip=False) -> torch.Tensor:
    """[len(prompts), V] f32 logits of each prompt's first decode sub-step
    on `eng`: its whole prefill as the engine runs it (captured or
    eager), then one sub-step of a staged round (after the round's window
    fill over int8 pages), as many prompts at once as the engine has
    slots; the slots are freed after, and no token is emitted. With
    `roundtrip` (a float pool) the pages go through int8 and back
    between the prefill and the sub-step (`roundtrip_pages`)."""
    from paddle_tpu_torch.serving import SamplingParams
    one = SamplingParams(max_new_tokens=1, eos_token_id=-1)
    out = []
    for i in range(0, len(prompts), eng.pool.num_slots):
        handles = [eng.submit(p, one) for p in
                   prompts[i:i + eng.pool.num_slots]]
        eng._admit()
        slot_of = {id(h): s for s, h in eng._slot_req.items()}
        with torch.inference_mode():
            if roundtrip:
                roundtrip_pages(eng.pool)
            step = eng._stage_round()
            if step.side:
                step.run_side('_round_begin')
            logits = step.run_once().clone()
        for h in handles:
            slot = slot_of[id(h)]
            out.append(logits[slot])
            eng._detach_slot(slot, h)
            eng.pool.free(slot)
    eng.reset_stats()
    return torch.stack(out)


def rel_rmse(got, want) -> float:
    """The JAX bench's relative logit RMSE (bench.py:paged_int8_rmse):
    |got - want| over the norm of `want` about each row's mean, fp64."""
    got, want = got.double(), want.double()
    ref = want - want.mean(dim=-1, keepdim=True)
    return float((got - want).norm() / ref.norm())


def int8_logit_rmse(bf16, eng, prompts, tag: str) -> tuple:
    """(rmse, ref_rmse): the first decode sub-step's relative logit RMSE
    of `prompts` on the int8 engine `eng` against the float-KV engine
    `bf16` (bf16, or any float dtype), and that of the JAX bench's int8
    arm (`bf16` over its pages roundtripped through int8). Logged; the
    first must stay within INT8_REF_SLACK times the second, and every
    logit of both engines must be finite."""
    want = first_step_logits(bf16, prompts)
    got = first_step_logits(eng, prompts)
    if not (bool(torch.isfinite(want).all())
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f'{tag}: non-finite first-step logits')
    ref = first_step_logits(bf16, prompts, roundtrip=True)
    rmse, ref_rmse = rel_rmse(got, want), rel_rmse(ref, want)
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    kv = str(bf16.model.dtype)[6:]
    log(f'[{tag}] first decode sub-step of the {len(prompts)} prompts: '
        f'relative logit RMSE {rmse:.4e} against the {kv}-KV engine, the '
        f'JAX bench\'s int8 arm (its pages roundtripped through int8) '
        f'{ref_rmse:.4e} (limit {INT8_REF_SLACK} x that; the bench\'s '
        f'4-layer bound {INT8_RMSE_BOUND}), against each other '
        f'{rel_rmse(got, ref):.4e}; argmax equal on {agree} of '
        f'{len(prompts)}')
    if not rmse <= INT8_REF_SLACK * ref_rmse:
        raise AssertionError(f'{tag}: relative logit RMSE {rmse:.4e} '
                             f'> {INT8_REF_SLACK} x the bench\'s int8 arm\'s '
                             f'{ref_rmse:.4e}')
    return rmse, ref_rmse


def int8_prefix_runs(model, tag: str, kernels=INT8_SERVE_KERNELS):
    """(graph run, eager run) of phase 6c's serve-prefix trace and
    parameters (`prefix_params`) on `model`
    behind the int8 prefix/chunk engine (PREFIX_ENGINE + PREFIX_OPTS,
    `kv_quant='int8'`) and its eager twin, each warmed as `_run_prefix`
    says and every page free after a forced clear; their tokens must be
    equal."""
    from paddle_tpu_torch.serving import InferenceEngine
    warm, trace = prefix_trace(model.config.vocab_size,
                               np.random.RandomState(5))
    runs = []
    for rtag, graph in ((f'{tag}-prefix', True),
                        (f'{tag}-prefix eager', False)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        e = InferenceEngine(model, **PREFIX_ENGINE, **PREFIX_OPTS,
                            kv_quant='int8')
        e._capture_decode = e._capture_prefill = graph
        runs.append(_run_prefix(e, warm, trace, prefix_params(len(trace)),
                                rtag, base, kernels))
        pages_free_after_clear(e, rtag)
        del e
    pre, pre_eager = runs
    if pre['tokens'] != pre_eager['tokens']:
        diff = {j: first_difference(a, b) for j, (a, b) in enumerate(
            zip(pre['tokens'], pre_eager['tokens'])) if a != b}
        raise AssertionError(f'{tag}-prefix: graph and eager tokens differ '
                             f'in requests {diff} ({{request: first '
                             f'position}}): graph {pre["tokens"]} eager '
                             f'{pre_eager["tokens"]}')
    log(f'[{tag}-prefix] graph == eager: the tokens of all {len(trace)} '
        f'requests are equal (sampling included)')
    return pre, pre_eager


def check_int8_launches(runs, key: str, layers: int, tag: str) -> None:
    """The int8 paged call (LAUNCHES `key`) once per layer of every decode
    sub-step on each of `runs` ({tag: run}), replays counted."""
    for rtag, run in runs.items():
        if run['launches'][key] != layers * run['decode_steps']:
            raise AssertionError(
                f'{rtag}: {run["launches"][key]} int8 paged launches, want '
                f'{layers} x {run["decode_steps"]} decode sub-steps')
    first = next(iter(runs.values()))
    log(f'[{tag}] int8 paged launches ({key}) = {layers} x decode sub-steps '
        f'on all {len(runs)} runs ({first["launches"][key]} on the graph '
        f'serve run, replays counted)')


def serve_int8(served, prefixed) -> dict:
    """Phase 6's Llama-2-7B behind the same engine with `kv_quant='int8'`:
    phase 6's 12 requests (graph and eager twin), then phase 6c's
    serve-prefix trace (`int8_prefix_runs`). Gates: graph tokens equal
    eager tokens in both; `traces` exactly the buckets run; the paged
    kernel launched once per layer of every decode sub-step (replays
    counted); the first decode sub-step's relative logit RMSE of phase
    6's prompts against phase 6's bf16-KV engine at most INT8_REF_SLACK
    times that of the JAX bench's int8 arm (`int8_logit_rmse`). Logs
    each beside phase 6 and 6c: pool bytes, decode tok/s, TTFT, peak
    used pages."""
    from paddle_tpu_torch.serving import InferenceEngine
    bf16 = served['engine']
    model = bf16.model
    layers = model.config.num_hidden_layers
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16, kv_quant='int8')
    log(f'[serve-int8] KV pool {eng.pool.num_pages} pages, '
        f'{eng.pool.pool_bytes / 1e9:.3f} GB int8 with scales, against '
        f'{bf16.pool.pool_bytes / 1e9:.3f} GB bf16 (phase 6); window '
        f'{sum(t.nbytes for kv in eng._decode._windows for t in kv) / 1e6:.1f}'
        f' MB')
    prompts, params = served['prompts'], served['params']
    res = _run_serve(eng, prompts, params, None, INT8_SERVE_KERNELS,
                     'serve-int8', base)
    eager = serve_eager(eng, res, prompts, params, None, INT8_SERVE_KERNELS,
                        'serve-int8')
    rmse, ref_rmse = int8_logit_rmse(bf16, eng, prompts, 'serve-int8')
    same = sum(a == b for a, b in zip(res['tokens'], served['tokens']))
    log(f'[serve-int8] {same} of {len(prompts)} requests get the bf16-KV '
        f'engine\'s 32 tokens')
    pre, pre_eager = int8_prefix_runs(model, 'serve-int8')
    check_int8_launches({'serve-int8': res, 'serve-int8 eager': eager,
                         'serve-int8-prefix': pre,
                         'serve-int8-prefix eager': pre_eager},
                        'paged_attention_int8', layers, 'serve-int8')
    for key, fmt in (('decode_tok_per_s', '.1f'), ('ttft_mean_s', '.3f'),
                     ('ttft_p50_s', '.3f'), ('ttft_max_s', '.3f'),
                     ('peak_pages', 'd'), ('prefill_s', '.3f'),
                     ('peak_mem_gb', '.3f')):
        log(f'[serve-int8]   {key}: serve int8 {res[key]:{fmt}} (eager '
            f'{eager[key]:{fmt}}) vs bf16 {served[key]:{fmt}}; serve-prefix '
            f'int8 {pre[key]:{fmt}} (eager {pre_eager[key]:{fmt}}) vs bf16 '
            f'{prefixed[key]:{fmt}}')
    prefix_same = sum(a == b for a, b in zip(pre['tokens'],
                                             prefixed['tokens']))
    log(f'[serve-int8-prefix] hits {pre["hits"]}, COW splits '
        f'{pre["cow_splits"]}, chunk rounds {pre["chunk_rounds"]} (bf16: '
        f'{prefixed["hits"]}, {prefixed["cow_splits"]}, '
        f'{prefixed["chunk_rounds"]}); {prefix_same} of '
        f'{len(pre["tokens"])} requests get the bf16-KV tokens')
    res.update(engine=eng, eager=eager, prefix=pre, rmse=rmse,
               ref_rmse=ref_rmse, prompts=prompts)
    return res


# ---------------------------------------------------------------------------
# phase 6e: serve with speculative decoding; 6f: drain, evict and swap
# ---------------------------------------------------------------------------

def first_difference(a, b):
    """The first position where two token lists differ, or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def serve_spec(served, cut) -> dict:
    """Phase 6's model, requests and engine settings with a draft model
    (k = SPEC_K), two drafts in turn: the JAX bench's same-width 2-layer
    draft with random weights (bench.py:361-370) on phase 6's model, and
    the model itself (the acceptance ceiling) on the cut model of `cut`
    (CUT_LAYERS of 32), beside that model's own run. Each
    on the graph engine and its eager twin
    (`_run_serve`, `serve_eager`): equal tokens, the verify kernel once
    per layer of every round (replays counted). Logs decode tok/s, TTFT,
    tokens per round per greedy slot and the acceptance rate beside its
    model's plain run, and how many requests get that run's tokens (a
    reading: in bf16 a 5-row verify can round differently from a 1-row
    step). With the
    2-layer draft also the wall of one round with every slot busy, graph
    and eager, before any profiling (phase 7's idle shares use it). Runs
    right after phase 6, while only its engines hold device memory, and
    frees its engines. Returns {'draft2': run, 'self': run, 'model',
    'draft'}."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine
    model = served['engine'].model
    draft = LlamaForCausalLM(draft_config(model.config, 2), device=DEV,
                             dtype='bfloat16',
                             generator=ptt.generator(4321, DEV))
    greedy = [j for j, sp in enumerate(served['params'])
              if sp.strategy != 'sampling']
    out = {}
    for key, ref, d, label in (
            ('draft2', served, draft, '2-layer random draft'),
            ('self', cut, cut['engine'].model,
             f'self-draft at {CUT_LAYERS} layers')):
        tag = f'serve-spec {label}'
        target = ref['engine'].model
        layers = target.config.num_hidden_layers
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        eng = InferenceEngine(target, num_slots=8, max_length=1024,
                              kv_page_size=16, draft_model=d,
                              num_draft_tokens=SPEC_K)
        res = _run_serve(eng, ref['prompts'], ref['params'], None,
                         SPEC_KERNELS, tag, base)
        spec = eng.stats()['spec']
        want = layers * res['decode_steps']
        if res['launches']['paged_attention_verify'] != want or \
                spec['rounds'] != res['decode_steps']:
            raise AssertionError(
                f'{tag}: {res["launches"]["paged_attention_verify"]} verify '
                f'launches, want {layers} x {res["decode_steps"]} rounds')
        eager = serve_eager(eng, res, ref['prompts'], ref['params'],
                            None, SPEC_KERNELS, tag)
        if key == 'draft2':
            for run, e in ((res, eng), (eager, eager['engine'])):
                run['round_wall_s'] = spec_round_wall(e, ref['prompts'])
        per_round = 1 + spec['accepted'] / max(spec['proposed'] / SPEC_K, 1)
        same = [j for j in range(len(res['tokens']))
                if res['tokens'][j] == ref['tokens'][j]]
        diffs = {j: first_difference(res['tokens'][j], ref['tokens'][j])
                 for j in range(len(res['tokens'])) if j not in same}
        log(f'[{tag}] k={SPEC_K}: {spec["rounds"]} rounds, acceptance rate '
            f'{spec["acceptance_rate"]:.4f}, {per_round:.3f} tokens per round '
            f'per greedy slot; decode {res["decode_tok_per_s"]:.1f} tok/s = '
            f'{res["decode_tok_per_s"] / ref["decode_tok_per_s"]:.3f} x '
            f'its model\'s {ref["decode_tok_per_s"]:.1f} (same process), '
            f'TTFT mean {res["ttft_mean_s"]:.3f} s p50 '
            f'{res["ttft_p50_s"]:.3f} s max {res["ttft_max_s"]:.3f} s (its '
            f'model: {ref["ttft_mean_s"]:.3f} / {ref["ttft_p50_s"]:.3f} / '
            f'{ref["ttft_max_s"]:.3f})')
        log(f'[{tag}] {len(same)} of {len(res["tokens"])} requests '
            f'({sum(j in same for j in greedy)} of {len(greedy)} greedy) get '
            f'its model\'s tokens; first differing position by request '
            f'{diffs}')
        res.update(engine=eng, eager=eager, spec=spec,
                   tokens_per_round=per_round)
        release(res)
        out[key] = res
    out.update(model=model, draft=draft, prompts=served['prompts'])
    return out


def spec_round_wall(eng, prompts) -> float:
    """Seconds of one speculation round of `eng` with every slot busy
    (its first round admits and prefills them), unprofiled; the engine
    is drained after."""
    n = eng.pool.num_slots
    for p in prompts[:n]:
        eng.submit(p, max_new_tokens=4 * (SPEC_K + 1), eos_token_id=-1)
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    wall = time.perf_counter() - t0
    eng.run()
    return wall


def drain_swap(served) -> dict:
    """On a fresh engine with phase 6's settings: `swap_weights` to a host
    copy of the weights with layer 0's MLP perturbed, then
    `restore_weights` (each one's seconds logged: 13.5 GB each way, the
    swap also taking the host copy of the old weights), after which the
    12 requests get phase 6's tokens with nothing captured again;
    `evict_all()` after two steps hands back all 12 with every page
    free; `drain()` after two steps finishes all 12 with phase 6's
    tokens."""
    from paddle_tpu_torch.serving import FINISHED, InferenceEngine
    model = served['engine'].model
    prompts, params = served['prompts'], served['params']
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16)
    eng.generate_many(prompts, params)          # captures what it uses
    traces = dict(eng.stats()['traces'])
    t0 = time.perf_counter()
    state = perturbed_state(model)
    t_state = time.perf_counter() - t0
    t0 = time.perf_counter()
    prev = eng.swap_weights(state, version=1)
    t_swap = time.perf_counter() - t0
    moved = sum(h.tokens != want for h, want in zip(
        eng.generate_many(prompts, params), served['tokens']))
    t0 = time.perf_counter()
    eng.restore_weights(prev)
    t_restore = time.perf_counter() - t0
    del state, prev
    back = [h.tokens for h in eng.generate_many(prompts, params)]
    if back != served['tokens'] or eng.stats()['traces'] != traces:
        raise AssertionError(f'swap: after the restore the tokens differ '
                             f'from phase 6 or captures moved '
                             f'({eng.stats()["traces"]} vs {traces})')
    gb = nbytes(*model.parameters()) / 1e9
    log(f'[swap] {gb:.2f} GB of weights: the host copy of the new weights '
        f'took {t_state:.3f} s; swap_weights {t_swap:.3f} s (a host copy of '
        f'the old weights, then the new ones copied in place), '
        f'restore_weights {t_restore:.3f} s; the swap moved {moved} of '
        f'{len(prompts)} requests, and after the restore all get phase 6\'s '
        f'tokens; captures unchanged')
    hs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.step()
    eng.step()
    out = eng.evict_all()
    if sorted(h.request_id for h in out) != sorted(h.request_id for h in hs) \
            or eng.pool.free_page_count != eng.pool.num_pages - 1:
        raise AssertionError(f'evict_all: {len(out)} of {len(hs)} handles, '
                             f'{eng.pool.used_page_count} pages still used')
    hs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.step()
    eng.step()
    t0 = time.perf_counter()
    ok = eng.drain()
    t_drain = time.perf_counter() - t0
    if not ok or any(h.status != FINISHED for h in hs) or \
            [h.tokens for h in hs] != served['tokens']:
        raise AssertionError('drain: not every request finished with phase '
                             '6\'s tokens')
    log(f'[drain] evict_all() after two steps: {len(out)} handles back, all '
        f'{eng.pool.num_pages - 1} pages free; drain() after two steps '
        f'finished all {len(hs)} requests in {t_drain:.3f} s with phase 6\'s '
        f'tokens')
    del eng
    torch.cuda.empty_cache()
    return dict(swap_s=t_swap, restore_s=t_restore, state_s=t_state)


# ---------------------------------------------------------------------------
# phase 6g: the adapter store and the weight store
# ---------------------------------------------------------------------------

# where 6g's stores live while it runs (inside the checkout's build
# directory, which .gitignore lists); each run makes and removes its own
STORE_ROOT = Path(__file__).resolve().parent / 'build' / 'stores'


def _store_dir(prefix: str) -> Path:
    STORE_ROOT.mkdir(parents=True, exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=prefix, dir=STORE_ROOT))


def _flip_payload(store, version: int) -> None:
    """Flip one byte in the middle of a committed version's payload (a torn
    write or bit rot, which its sha256 manifest must catch)."""
    payload = Path(store.directory) / f'step_{version}' / 'tree.npz'
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))


def _timed_loads(bank) -> list:
    """Wrap `bank`'s store load and slot write to log each one's seconds
    (synchronised): [(adapter, version, load s or None on a reject,
    slot-copy s)]."""
    loads = []
    load, write = bank._load_version, bank._write_slot

    def timed_write(*args):
        t0 = time.perf_counter()
        write(*args)
        torch.cuda.synchronize()
        loads[-1][3] = time.perf_counter() - t0

    def timed_load(adapter_id, store, version):
        loads.append([adapter_id, version, None, None])
        t0 = time.perf_counter()
        slot = load(adapter_id, store, version)
        torch.cuda.synchronize()
        if slot is not None:
            loads[-1][2] = time.perf_counter() - t0
        return slot

    bank._load_version, bank._write_slot = timed_load, timed_write
    return loads


def _count_launches(run: dict, launches: dict) -> None:
    """Add a segment's kernel launches into `run['launches']`."""
    for k, n in launches.items():
        run['launches'][k] = run['launches'].get(k, 0) + n


def serve_adapter_store(served, adapted) -> dict:
    """Phase 6b's model, prompts, parameters and mix behind a store-backed
    bank (f32, rank 8, capacity 4, q/k/v/o_proj, its store a fresh
    directory removed at the end): ad0..ad2 published once each with 6b's
    factors, the 12 requests served through pins that load them from the
    store (every request's tokens == 6b's); then ad0 v2 published while an
    ad0 request decodes (it keeps 6b's tokens; a new ad0 request gets v2,
    in another slot, with the tokens of a fresh bank `load`ed with v2); a
    corrupt v3 (quarantined, v2 keeps serving); then a capacity-2 bank on
    the same store with three adapters in flight (each request gets its
    tokens alone, some admission requeued). Nothing is captured after
    each engine's warm-up, and the adapter kernel runs once per adapted
    projection of every prefill and decode sub-step. Logs one publish,
    each hot load (store read + sha256 + slot copy) and its slot copy,
    the round that admits the v2 request beside one that admits nothing,
    and the pool's and the bank's bytes. Frees its engines."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (AdapterBank, InferenceEngine,
                                          WeightStore, make_adapter_factors)
    model = served['engine'].model
    prompts, params, ids = served['prompts'], served['params'], adapted['ids']
    root = _store_dir('adapters-')
    tag = 'adapter-store'
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        bank = AdapterBank(model, capacity=4, rank=8, targets=ADAPTER_TARGETS,
                           dtype='float32', store_dir=str(root))
        publish_s = []
        for i in range(3):
            t0 = time.perf_counter()
            bank.publish(f'ad{i}', make_adapter_factors(bank, seed=i + 1))
            publish_s.append(time.perf_counter() - t0)
        ad_mb = sum(nbytes(torch.from_numpy(x)) for a_b in
                    make_adapter_factors(bank, seed=1).values()
                    for x in a_b) / 1e6
        loads = _timed_loads(bank)
        eng = InferenceEngine(model, num_slots=8, max_length=1024,
                              decode_block=8, kv_page_size=16,
                              adapter_bank=bank)
        res = _run_serve(eng, prompts, params, ids, ADAPTER_KERNELS, tag,
                         base)
        sites = len(bank.sites)
        want = sites * (res['prefills'] + res['decode_steps'])
        if res['tokens'] != adapted['tokens'] or \
                res['launches']['adapter_matmul'] != want:
            raise AssertionError(
                f'{tag}: tokens differ from 6b on requests '
                f'{[j for j, (a, b) in enumerate(zip(res["tokens"], adapted["tokens"])) if a != b]}'
                f' or {res["launches"]["adapter_matmul"]} adapter launches '
                f'!= {want}')
        traces = dict(eng.stats()['traces'])
        log(f'[{tag}] published ad0..ad2 (v1 each, {ad_mb:.1f} MB of f32 '
            f'factors a version) in {", ".join(f"{s:.3f}" for s in publish_s)}'
            f' s; the wave\'s pins loaded them from the store: '
            + '; '.join(f'{a} v{v} {t * 1e3:.1f} ms (slot copy '
                        f'{c * 1e3:.2f} ms)' for a, v, t, c in loads)
            + f'; all 12 requests == phase 6b\'s tokens, {want} adapter '
            f'launches = {sites} x ({res["prefills"]} prefills + '
            f'{res["decode_steps"]} sub-steps)')

        # a publish while an ad0 request decodes, then a corrupt version
        j = ids.index('ad0')
        prompt, sp = prompts[j], params[j]
        loads.clear()
        eng.reset_stats()
        K.reset_launch_counts()
        h1 = eng.submit(prompt, sp, adapter_id='ad0')
        eng.step()                       # admit, prefill, one round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        plain_round = time.perf_counter() - t0
        if h1.done or h1.adapter_version != 1:
            raise AssertionError(f'{tag}: the v1 request is not mid-decode')
        t0 = time.perf_counter()
        v2 = bank.publish('ad0', make_adapter_factors(bank, seed=11))
        publish_v2 = time.perf_counter() - t0
        h2 = eng.submit(prompt, sp, adapter_id='ad0')
        t0 = time.perf_counter()
        eng.step()                       # admits h2: hot load + prefill
        admit_round = time.perf_counter() - t0
        slot1, slot2 = h1._adapter_pin, h2._adapter_pin
        eng.run()
        store = WeightStore(str(root / 'ad0'))
        t0 = time.perf_counter()
        store.mgr.verify(v2)
        verify_s = time.perf_counter() - t0
        hot = list(loads)
        v3 = bank.publish('ad0', make_adapter_factors(bank, seed=12))
        _flip_payload(store, v3)
        h3 = eng.submit(prompt, sp, adapter_id='ad0')
        eng.run()
        st = eng.stats()
        launches = {k: K.LAUNCHES[k] for k in ADAPTER_KERNELS}
        _count_launches(res, launches)
        want = sites * (st['prefills'] + st['decode_steps'])

        # the v2 reference: a fresh bank `load`ed with v2, eager, a pool of
        # one request's pages
        ref_bank = AdapterBank(model, capacity=4, rank=8,
                               targets=ADAPTER_TARGETS, dtype='float32')
        ref_bank.load('ad0', make_adapter_factors(ref_bank, seed=11))
        ref = InferenceEngine(model, num_slots=8, max_length=1024,
                              decode_block=8, kv_page_size=16,
                              kv_pages=1 + 1024 // 16, adapter_bank=ref_bank)
        ref._capture_decode = ref._capture_prefill = False
        v2_tokens = ref.generate_many([prompt], sp,
                                      adapter_ids='ad0')[0].tokens
        del ref, ref_bank
        problems = []
        if h1.tokens != adapted['tokens'][j]:
            problems.append('the v1 request left 6b\'s tokens')
        if (h2.adapter_version, h2.tokens) != (v2, v2_tokens) or \
                slot2 in (None, slot1):
            problems.append(f'the new request got v{h2.adapter_version} in '
                            f'slot {slot2} (v1 in {slot1})')
        if (h3.adapter_version, h3.tokens) != (v2, v2_tokens) or \
                store.quarantined() != [v3]:
            problems.append(f'after the corrupt v3: v{h3.adapter_version}, '
                            f'quarantined {store.quarantined()}')
        if st['traces'] != traces or launches['adapter_matmul'] != want:
            problems.append(f'captures {st["traces"]} (after the warm-up '
                            f'{traces}), {launches["adapter_matmul"]} '
                            f'adapter launches, want {want}')
        if problems:
            raise AssertionError(f'{tag}: ' + '; '.join(problems))
        pool_gb = eng.pool.pool_bytes / 1e9
        bank_mb = nbytes(*[t for s in bank.sites
                           for t in (bank._a[s], bank._b[s])],
                         bank._scale) / 1e6
        log(f'[{tag}] ad0 v2 published in {publish_v2:.3f} s while a v1 '
            f'request decoded (slot {slot1}); the round that admitted the v2 '
            f'request (hot load, prefill of {len(prompt)} tokens, decode '
            f'round) {admit_round * 1e3:.1f} ms beside a round that admitted '
            f'nothing {plain_round * 1e3:.1f} ms; its hot load '
            + '; '.join(f'{a} v{v} {t * 1e3:.1f} ms (slot copy '
                        f'{c * 1e3:.2f} ms)' for a, v, t, c in hot)
            + f', the sha256 of the version alone {verify_s * 1e3:.1f} ms; '
            f'v1 request == 6b\'s tokens, v2 request in slot {slot2} == a '
            f'fresh bank loaded with v2; corrupt v3 quarantined '
            f'({store.quarantined()}), v2 still served; captures unchanged; '
            f'{want} adapter launches = {sites} x ({st["prefills"]} prefills'
            f' + {st["decode_steps"]} sub-steps); KV pool {pool_gb:.2f} GB, '
            f'bank {bank_mb:.1f} MB')
        del eng, bank, h1, h2, h3
        gc.collect()
        torch.cuda.empty_cache()

        # saturated: three adapters in flight on two slots
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        sat_bank = AdapterBank(model, capacity=2, rank=8,
                               targets=ADAPTER_TARGETS, dtype='float32',
                               store_dir=str(root))
        sat = InferenceEngine(model, num_slots=8, max_length=1024,
                              decode_block=8, kv_page_size=16,
                              adapter_bank=sat_bank)
        order = [ids.index(a) for a in ('ad0', 'ad1', 'ad2')]
        run = _run_serve(sat, [prompts[j] for j in order],
                         [params[j] for j in order], ['ad0', 'ad1', 'ad2'],
                         ADAPTER_KERNELS, f'{tag} saturated', base)
        st = sat.stats()
        alone = [v2_tokens] + [adapted['tokens'][j] for j in order[1:]]
        want = sites * (run['prefills'] + run['decode_steps'])
        if run['tokens'] != alone or st['requeued'] < 1 or st['failed'] or \
                run['launches']['adapter_matmul'] != want:
            raise AssertionError(
                f'{tag} saturated: tokens == alone '
                f'{[a == b for a, b in zip(run["tokens"], alone)]}, '
                f'requeued {st["requeued"]}, failed {st["failed"]}, '
                f'{run["launches"]["adapter_matmul"]} adapter launches, '
                f'want {want}')
        _count_launches(res, run['launches'])
        log(f'[{tag} saturated] 3 adapters in flight on 2 slots: '
            f'{st["requeued"]} admissions requeued, none failed; every '
            f'request == its tokens alone (ad0 at v2); {want} adapter '
            f'launches')
        del sat, sat_bank
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def weight_store_swap(served) -> dict:
    """The weight store at Llama-2-7B width, 2 bf16 layers (a version of
    the full 32 layers is 13.5 GB; two would write 27 GB to disk), on a
    graph engine of phase 6's settings: v1 published from the model by
    `WeightPublisher`, v2 a copy with layer 0's MLP perturbed, v3 a copy
    with one bf16 NaN. v2: load (sha256 checked), `finite_weights_gate`
    (passes), `swap_weights`, and a `CanaryGate` whose expected tokens come
    from a fresh engine on a model given v2's weights (passes). v3: load,
    the gate refuses it, `quarantine`, the store's latest is v2 again, and
    `restore_weights` gives v1's tokens. Nothing is captured after the
    warm-up. Logs publish and load GB/s, the sha256 seconds and the swap
    seconds. Frees what it made."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (CanaryGate, InferenceEngine,
                                          SamplingParams, WeightPublisher,
                                          WeightStore, finite_weights_gate)
    tag = 'weight-store'
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(1234, DEV))
    gb = nbytes(*model.parameters()) / 1e9
    prompts = served['prompts'][:4]
    sp = SamplingParams(max_new_tokens=8, eos_token_id=-1)
    root = _store_dir('weights-')
    try:
        K.reset_launch_counts()
        eng = InferenceEngine(model, num_slots=8, max_length=1024,
                              decode_block=8, kv_page_size=16)
        v1_tokens = [h.tokens for h in eng.generate_many(prompts, sp)]
        traces = dict(eng.stats()['traces'])
        store = WeightStore(str(root))
        t0 = time.perf_counter()
        WeightPublisher(model, store).publish(step=0)      # v1
        publish_s = time.perf_counter() - t0
        state = perturbed_state(model)
        v2 = store.publish(state, meta={'step': 1})
        name = 'llama.layers.1.self_attn.q_proj.weight'
        nan = state[name].clone()
        nan.view(-1)[nan.numel() // 3] = float('nan')
        v3 = store.publish({**state, name: nan}, meta={'step': 2})
        del state, nan
        t0 = time.perf_counter()
        store.mgr.verify(v2)
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = store.load(v2)
        load_s = time.perf_counter() - t0
        gate = finite_weights_gate(eng, v2, tree)
        t0 = time.perf_counter()
        prev = eng.swap_weights(tree, version=v2)
        swap_s = time.perf_counter() - t0
        fresh_model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                                       generator=ptt.generator(1, DEV))
        fresh_model.load_state_dict({
            k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
            for k, v in tree.items()})
        fresh = InferenceEngine(fresh_model, num_slots=8, max_length=1024,
                                decode_block=8, kv_page_size=16)
        expect = fresh.generate_many([prompts[0]], sp)[0].tokens
        del fresh, fresh_model, tree
        canary = CanaryGate(prompts[0], max_new_tokens=8, expect=expect)(
            eng, v2, None)
        moved = [h.tokens for h in eng.generate_many(prompts, sp)]
        tree3 = store.load(v3)
        refused = finite_weights_gate(eng, v3, tree3)
        del tree3
        if not refused[0]:
            store.quarantine(v3, refused[1])
        latest = store.latest_version()
        eng.restore_weights(prev)
        back = [h.tokens for h in eng.generate_many(prompts, sp)]
        launches = {k: K.LAUNCHES[k] for k in SERVE_KERNELS}
        problems = []
        if gate != (True, '') or canary != (True, ''):
            problems.append(f'v2: gate {gate}, canary {canary}')
        if moved == v1_tokens:
            problems.append('v2 moved no token')
        if refused[0] or store.quarantined() != [v3] or latest != v2:
            problems.append(f'v3: gate {refused}, quarantined '
                            f'{store.quarantined()}, latest {latest}')
        if back != v1_tokens or eng.stats()['traces'] != traces:
            problems.append(f'after the restore: tokens == v1 '
                            f'{back == v1_tokens}, captures '
                            f'{eng.stats()["traces"]} vs {traces}')
        if problems:
            raise AssertionError(f'{tag}: ' + '; '.join(problems))
        log(f'[{tag}] Llama-2-7B width at 2 bf16 layers, {gb:.3f} GB a '
            f'version: WeightPublisher.publish {publish_s:.3f} s '
            f'({gb / publish_s:.3f} GB/s: the host copy, the npz write, the '
            f'sha256); load {load_s:.3f} s ({gb / load_s:.3f} GB/s, the '
            f'sha256 alone {verify_s:.3f} s); swap_weights {swap_s:.3f} s; '
            f'v2 passed the finite gate and the canary (tokens {expect}), '
            f'moved the tokens; v3 refused ({refused[1]}), quarantined, '
            f'latest v{latest}; the restore gave v1\'s tokens, captures '
            f'unchanged')
        del eng, prev, store
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {'launches': launches}


# ---------------------------------------------------------------------------
# phase 6h: the serving observability layer at full width
# ---------------------------------------------------------------------------

# where the flight recorder writes its bundles in this run (inside the
# checkout's gitignored build directory); 6h (d) points it at a fresh
# directory of its own and removes it
FLIGHT_ROOT = Path(__file__).resolve().parent / 'build' / 'flight'
# the scrape rate of 6h (a), bench.py:scrape_overhead_ab's
SCRAPE_HZ = 4.0
# the reference's guard on the instrumentation's cost (bench.py:517)
OBS_OVERHEAD_MAX = 0.03
OBS_PAIRS = 3
# one exposition line: a sample `name{labels} value` (HELP/TYPE apart)
_EXPO_SAMPLE = (r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
                r'(\{[a-zA-Z_][a-zA-Z0-9_]*="([^"\\\n]|\\[\\"n])*"'
                r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\\n]|\\[\\"n])*")*\})?'
                r' (NaN|[+-]Inf|-?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?)$')
_EXPO_COMMENT = r'^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .*$'


def parse_exposition(body: str) -> dict:
    """{sample with its labels: value} of a /metrics body; raises on any
    line that is neither a sample nor a HELP/TYPE comment."""
    import re
    sample, comment = re.compile(_EXPO_SAMPLE), re.compile(_EXPO_COMMENT)
    out = {}
    for line in body.splitlines():
        if comment.match(line):
            continue
        if not sample.match(line):
            raise ValueError(f'bad exposition line {line!r}')
        key, value = line.rsplit(' ', 1)
        out[key] = float(value)
    return out


def http_get(url: str) -> tuple:
    """(status, body) of one GET, 5 s at most."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class Scraper:
    """A background client scraping `/metrics` at `hz`, each body
    parse-checked (bench.py:scrape_overhead_ab's client)."""

    def __init__(self, url: str, hz: float = SCRAPE_HZ):
        import threading
        self.url, self.hz = f'{url}/metrics', hz
        self.scrapes = self.failures = 0
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                status, body = http_get(self.url)
                if status != 200:
                    raise ValueError(f'status {status}')
                parse_exposition(body)
            except Exception as exc:
                self.failures += 1
                self.errors.append(f'{type(exc).__name__}: {exc}'[:200])
            self.scrapes += 1
            self._stop.wait(1.0 / self.hz)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


def _serving_counters(url: str) -> dict:
    """The serving counters of one scrape, summed over labels."""
    m = parse_exposition(http_get(f'{url}/metrics')[1])

    def total(name, **labels):
        want = [f'{k}="{v}"' for k, v in labels.items()]
        return sum(v for k, v in m.items()
                   if (k == name or k.startswith(name + '{'))
                   and all(w in k for w in want))
    return {
        'submitted': total('paddle_serving_requests_total',
                           status='submitted'),
        'completed': total('paddle_serving_requests_total',
                           status='completed'),
        'failed': total('paddle_serving_requests_total', status='failed'),
        'tokens': total('paddle_serving_tokens_total'),
        'prefills': total('paddle_serving_prefills_total'),
        'decode_rounds': total('paddle_serving_decode_rounds_total'),
        'decode_steps': total('paddle_serving_decode_steps_total'),
        'chunk_rounds': total('paddle_serving_chunk_rounds_total'),
    }


def _summary_serving(url: str) -> dict:
    sv = json.loads(http_get(f'{url}/summary?format=json')[1])['serving']
    return {'submitted': sv['submitted'], 'completed': sv['completed'],
            'failed': sv['failed'], 'tokens': sv['tokens'],
            'prefills': sv['prefills'], 'decode_steps': sv['decode_steps'],
            'chunk_rounds': sv['chunk']['rounds']}


def _wave(eng, prompts, params) -> tuple:
    """Phase 6's 12 requests on `eng` from fresh stats: (handles,
    stats)."""
    eng.reset_stats()
    handles = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    while eng.has_work:
        eng.step()
    return handles, eng.stats()


def _check_closed(summary: dict, tag: str, frac: float = 0.01) -> float:
    """A finished request's waterfall against its E2E: returns the
    unexplained share."""
    e2e = summary['e2e_s']
    gap = summary['residual_s'] + summary['overcount_s']
    if gap > frac * e2e:
        raise AssertionError(f'{tag}: request {summary["request_id"]} '
                             f'leaves {gap * 1e3:.3f} ms of {e2e * 1e3:.3f} '
                             f'ms unexplained: {summary}')
    return gap / e2e


def observe_wave(eng, prompts, params, want_tokens, srv) -> dict:
    """6h (a) and (b): the wave under a 4 Hz scraper; the counters of the
    scrapes before and after it, and the /summary serving section's
    change, against `stats()`; then both ledgers' closure."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.ops import kernels as K
    traces = dict(eng.stats()['traces'])
    before, sum_before = _serving_counters(srv.url), \
        _summary_serving(srv.url)
    obs.get_ledger().reset()
    obs.get_request_ledger().reset()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with Scraper(srv.url) as scraper:
        handles, st = _wave(eng, prompts, params)
    wall = time.perf_counter() - t0
    launches = {k: K.LAUNCHES[k] for k in SERVE_KERNELS}
    after, sum_after = _serving_counters(srv.url), _summary_serving(srv.url)
    if scraper.failures or scraper.scrapes < 2:
        raise AssertionError(f'observability: {scraper.failures} of '
                             f'{scraper.scrapes} scrapes failed to parse: '
                             f'{scraper.errors[:3]}')
    want = {k: st[k] for k in after}
    got = {k: after[k] - before[k] for k in after}
    got_sum = {k: sum_after[k] - sum_before[k] for k in sum_after}
    if got != want or got_sum != {k: st[k] for k in sum_after}:
        raise AssertionError(f'observability: /metrics moved by {got}, '
                             f'/summary by {got_sum}, stats() {want}')
    if [h.tokens for h in handles] != want_tokens:
        raise AssertionError('observability: the instrumented wave\'s '
                             'tokens differ from phase 6\'s')
    if st['traces'] != traces or min(launches.values()) <= 0:
        raise AssertionError(f'observability: captures {st["traces"]} '
                             f'(before {traces}), launches {launches}')
    log(f'[observe] 12 requests in {wall:.3f} s under a {SCRAPE_HZ:g} Hz '
        f'scraper: {scraper.scrapes} scrapes, {scraper.failures} parse '
        f'failures; /metrics and /summary moved by stats() exactly '
        f'({got}); tokens == phase 6\'s; captures unchanged {st["traces"]}; '
        f'launches {launches}')
    # (b) the ledgers
    gp = obs.get_ledger().report()
    cats = gp['categories']
    books = sum(cats.values()) + gp['residual_seconds']
    if abs(books - gp['wall_seconds']) > 0.01 * gp['wall_seconds'] or \
            gp['overcount_seconds'] > 0:
        raise AssertionError(f'observability: the goodput books do not '
                             f'close: {gp}')
    shares = [_check_closed(h._ledger_rec.summary(), 'request ledger')
              for h in handles]
    closure = obs.get_request_ledger().report()['closure']
    if abs(closure['decode_fair_s'] - st['decode_seconds']) > \
            0.01 * st['decode_seconds'] or closure['finished'] != 12:
        raise AssertionError(f'observability: fair-share decode '
                             f'{closure["decode_fair_s"]:.6f} s against the '
                             f'engine\'s {st["decode_seconds"]:.6f} s, '
                             f'{closure["finished"]} finished')
    log(f'[observe] goodput ledger: wall {gp["wall_seconds"]:.4f} s, '
        f'serving_prefill {cats["serving_prefill"]:.4f} s, serving_decode '
        f'{cats["serving_decode"]:.4f} s, residual '
        f'{gp["residual_seconds"]:.4f} s '
        f'({gp["fractions"]["residual"]:.2%}); stats() prefill '
        f'{st["prefill_seconds"]:.4f} s, decode {st["decode_seconds"]:.4f} s')
    log(f'[observe] request ledger: 12 records closed, largest '
        f'unexplained share {max(shares):.4%}; fair-share decode '
        f'{closure["decode_fair_s"]:.6f} s == the engine decode wall '
        f'{closure["engine_decode_wall_s"]:.6f} s (stats() '
        f'{st["decode_seconds"]:.6f} s)')
    return {'scrapes': scraper.scrapes, 'scrape_failures': scraper.failures,
            'wall_s': wall, 'goodput': gp, 'closure': closure,
            'max_unexplained_share': max(shares), 'launches': launches}


def check_health(eng, srv) -> None:
    """/healthz 200 (once the holds of earlier phases' drains are
    cleared), then 503 `draining` from `begin_drain()` on an engine of
    its own (the eager twin of phase 6's, which later phases keep serving
    on), still 503 after `drain()`, 200 after
    `clear_degraded('draining')`."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import FINISHED, SamplingParams
    # a drained engine keeps /healthz at 503 until its holder clears it
    # (the process is expected to exit): the engines earlier phases
    # drained (3's spec consistency, 6f) are done, so clear their holds
    held = obs.health()['degraded'].get('draining', {}).get('count', 0)
    obs.clear_degraded('draining', force=True)
    log(f'[observe] cleared {held} hold(s) of `draining` left by the '
        f'engines earlier phases drained')
    twin = eager_twin(eng)
    seen = [http_get(f'{srv.url}/healthz')]
    hs = [twin.submit(list(range(3, 40)), SamplingParams(
        max_new_tokens=4, eos_token_id=-1)) for _ in range(2)]
    twin.step()
    twin.begin_drain()
    seen.append(http_get(f'{srv.url}/healthz'))
    if not twin.drain() or any(h.status != FINISHED for h in hs):
        raise AssertionError('observability: the drain did not finish')
    seen.append(http_get(f'{srv.url}/healthz'))
    obs.clear_degraded('draining')
    seen.append(http_get(f'{srv.url}/healthz'))
    states = [(code, json.loads(body)['status']) for code, body in seen]
    if states != [(200, 'ok'), (503, 'draining'), (503, 'draining'),
                  (200, 'ok')]:
        raise AssertionError(f'observability: /healthz went {states}')
    codes = {r: http_get(srv.url + r)[0]
             for r in ('/programs', '/slo', '/fleet/metrics')}
    if codes != {'/programs': 200, '/slo': 503, '/fleet/metrics': 503}:
        raise AssertionError(f'observability: routes answered {codes}')
    log(f'[observe] /healthz {" -> ".join(f"{c} {s}" for c, s in states)} '
        f'(begin_drain, drain, clear_degraded); /programs 200, /slo 503 '
        f'(no SLO engine registered), /fleet/metrics 503 (no fleet '
        f'aggregator registered)')


def check_flight(eng, prompts, params) -> None:
    """6h (d): a request whose admission raises fails alone and the flight
    recorder writes one bundle for it under a fresh PADDLE_FLIGHT_DIR."""
    import os
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import FAILED, FINISHED
    FLIGHT_ROOT.mkdir(parents=True, exist_ok=True)
    flight = Path(tempfile.mkdtemp(prefix='6h_', dir=FLIGHT_ROOT))
    rec = obs.get_flight_recorder()
    env, interval = os.environ.get('PADDLE_FLIGHT_DIR'), rec.min_interval_s
    os.environ['PADDLE_FLIGHT_DIR'] = str(flight)
    rec.min_interval_s = 0.0          # no debounce against earlier dumps
    begin = eng._begin_request

    def refused(slot, h):
        if h.prompt_tokens == prompts[1]:
            raise RuntimeError('injected admission failure')
        return begin(slot, h)
    eng._begin_request = refused
    try:
        hs = eng.generate_many(prompts[:2], params[:2])
    finally:
        del eng._begin_request
        rec.min_interval_s = interval
        if env is None:
            del os.environ['PADDLE_FLIGHT_DIR']
        else:
            os.environ['PADDLE_FLIGHT_DIR'] = env
    bundles = sorted(flight.iterdir())
    files = sorted(p.name for p in bundles[0].iterdir()) if bundles else []
    want = {'flight.json', 'events.jsonl', 'trace.json', 'metrics.json',
            'summary.txt', 'goodput.json', 'requests.json', 'programs.json',
            'slo.json'}
    if [h.status for h in hs] != [FINISHED, FAILED] or len(bundles) != 1 \
            or not want <= set(files):
        raise AssertionError(f'observability: statuses '
                             f'{[h.status for h in hs]}, bundles {bundles}, '
                             f'files {files}')
    doc = json.loads((bundles[0] / 'flight.json').read_text())
    if doc['reason'] != 'serving_request_failed' or \
            doc['trigger']['attrs']['error'] != 'RuntimeError':
        raise AssertionError(f'observability: flight.json names '
                             f'{doc["reason"]}: {doc["trigger"]}')
    log(f'[observe] a refused admission failed alone; one flight bundle '
        f'{bundles[0].name} with {files}')
    shutil.rmtree(flight, ignore_errors=True)


def round_hooks_us(slots: int = 8, block: int = 8,
                   rounds: int = 2000) -> float:
    """Host µs of the observability calls one decode round of `slots`
    busy slots makes (`InferenceEngine.step` and `_decode_round`: the
    round's span, the liveness beat, the request ledger's `note_round`
    over the slots' records, the round's counters and occupancy, each
    slot's token count, the goodput ledger's attribution of the span),
    timed alone on the host over `rounds` rounds, into a registry, event
    log and ledgers of their own."""
    from paddle_tpu_torch import observability as obs
    reg, log_ = obs.MetricsRegistry(), obs.EventLog()
    obs.GoodputLedger(log=log_).start()
    led = obs.RequestLedger()
    recs = [led.open(i, time.perf_counter()) for i in range(slots)]
    ids = list(range(slots))
    steps = reg.counter('paddle_serving_decode_steps_total')
    count = reg.counter('paddle_serving_decode_rounds_total')
    occ = reg.histogram('paddle_serving_slot_occupancy',
                        buckets=(0.125, 0.25, 0.5, 1.0))
    tokens = reg.counter('paddle_serving_tokens_total')
    t0 = time.perf_counter()
    for _ in range(rounds):
        with obs.Span('smoke.round_hooks', _log=log_, slots=slots,
                      requests=ids):
            pass
        obs.note_progress('decode')
        if obs.enabled():
            steps.inc(block)
        led.note_round(0.07, recs, 'decode', absorb=True)
        if obs.enabled():
            count.inc()
            occ.observe(1.0)
            tokens.inc(0)
            for _ in range(slots):
                tokens.inc(block)
    return (time.perf_counter() - t0) / rounds * 1e6


def obs_overhead(eng, prompts, params) -> dict:
    """6h (c): decode tok/s of phase 6's wave with observability off (the
    flag and the request ledger) and on, OBS_PAIRS interleaved pairs on
    one engine (off-on, then on-off, ...); the overhead is the least
    off/on ratio of a pair less 1 (bench.py:582-585's estimator), and the
    host time the layer adds to a round the pair's difference of the mean
    round wall."""
    from paddle_tpu_torch import observability as obs
    pairs = []
    for i in range(OBS_PAIRS):
        arms = {}
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                obs.enable()
                obs.get_request_ledger().enable()
            else:
                obs.disable()
                obs.get_request_ledger().disable()
            try:
                _, st = _wave(eng, prompts, params)
            finally:
                obs.enable()
                obs.get_request_ledger().enable()
            arms[on] = (st['tokens'] / st['decode_seconds'],
                        st['decode_seconds'] / st['decode_rounds'])
        pairs.append(arms)
    ratios = [p[False][0] / p[True][0] for p in pairs]
    added_us = sorted((p[True][1] - p[False][1]) * 1e6 for p in pairs)
    overhead = min(ratios) - 1
    for i, p in enumerate(pairs):
        log(f'[observe] pair {i}: decode off {p[False][0]:.1f} tok/s, on '
            f'{p[True][0]:.1f} tok/s (off/on {ratios[i]:.4f}); round wall '
            f'off {p[False][1] * 1e3:.3f} ms, on {p[True][1] * 1e3:.3f} ms')
    hooks = round_hooks_us(eng.pool.num_slots, eng.decode_block)
    wall_on = sum(p[True][1] for p in pairs) / len(pairs)
    log(f'[observe] overhead on decode tok/s (least off/on ratio of '
        f'{OBS_PAIRS} adjacent pairs, less 1): {overhead:.4%}; host time '
        f'the layer adds to a round (on - off round wall, by pair): '
        f'{", ".join(f"{u:.1f}" for u in added_us)} us; the hooks of one '
        f'{eng.pool.num_slots}-slot round timed alone on the host: '
        f'{hooks:.1f} us ({hooks / (wall_on * 1e6):.4%} of the on arm\'s '
        f'mean round wall)')
    if overhead > OBS_OVERHEAD_MAX:
        raise AssertionError(f'observability costs {overhead:.2%} of decode '
                             f'tok/s, above {OBS_OVERHEAD_MAX:.0%}')
    return {'overhead': overhead, 'ratios': ratios, 'added_us': added_us,
            'pairs': pairs, 'round_hooks_us': hooks}


def serve_observed(served) -> dict:
    """Phase 6h on phase 6's graph engine (Llama-2-7B, bf16, 8 slots,
    max_length 1024) and its 12 requests: (a) the port's server on an
    ephemeral port scraped at 4 Hz during the wave, every body parsed,
    the serving counters and /summary's serving section moved by exactly
    `stats()`, the tokens phase 6's and nothing captured; (b) the goodput
    ledger, every request's waterfall and the fair-share decode book
    closed within 1%; /healthz through a drain on an engine of its own;
    (d) a refused admission's flight bundle; (c) the layer's cost on
    decode tok/s in interleaved pairs."""
    from paddle_tpu_torch import observability as obs
    eng, prompts, params = served['engine'], served['prompts'], \
        served['params']
    srv = obs.start_server(0, host='127.0.0.1')
    try:
        log(f'[observe] server at {srv.url}')
        res = observe_wave(eng, prompts, params, served['tokens'], srv)
        check_health(eng, srv)
    finally:
        srv.stop()
    check_flight(eng, prompts, params)
    res.update(obs_overhead(eng, prompts, params))
    gc.collect()
    torch.cuda.empty_cache()
    import threading
    left = sorted(t.name for t in threading.enumerate()
                  if t is not threading.main_thread())
    if left:
        raise AssertionError(f'observability: threads left running: {left}')
    log('[observe] the server and the scraper left no thread running')
    return res


# ---------------------------------------------------------------------------
# phase 6i: replicated serving in one process at full width
# ---------------------------------------------------------------------------

FLEET_PAIRS = 3
ROUTER_OVERHEAD_MAX = 0.03       # bench.py router_ab's tier-1 guard
FLEET_ENGINE = dict(num_slots=8, max_length=1024, decode_block=8,
                    kv_page_size=16)
FLEET_QOS = 'paid:priority=high;free:priority=low,concurrency=4'
FLEET_SHED_DEPTH = 8


def _fleet_engine(model):
    """A graph engine of phase 6's settings over `model`."""
    from paddle_tpu_torch.serving import InferenceEngine
    return InferenceEngine(model, **FLEET_ENGINE)


def _warm(eng, prompts, adapter_ids=None) -> None:
    """`_run_serve`'s warm-up: one short request (the decode graph's
    capture) and every prompt for one token (each prefill bucket's)."""
    from paddle_tpu_torch.serving import SamplingParams
    one = SamplingParams(max_new_tokens=1, eos_token_id=-1)
    eng.generate_many([prompts[0][:8]], one)
    eng.generate_many(prompts, one, adapter_ids=adapter_ids)


def _wave_s(fn) -> tuple:
    """(seconds, result) of `fn()`, between two device syncs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _last_seq(obs) -> int:
    events = obs.get_event_log().events()
    return events[-1]['seq'] if events else -1


def _router_events(obs, since: int) -> list:
    """The fleet's events logged after sequence number `since`."""
    return [e['name'] for e in obs.get_event_log().events()
            if e['seq'] > since and e['name'].startswith(
                ('router_', 'breaker_', 'request_shed', 'autoscale_',
                 'weight_swap', 'weight_rollback', 'slo_'))]


def _release_replica(eng, scope) -> None:
    """Give an engine reused from an earlier phase back its observability
    scope and clear the holds a router phase left on it."""
    from paddle_tpu_torch import observability as obs
    if eng.obs_scope is not None:
        obs.clear_degraded('draining', scope=eng.obs_scope, force=True)
        obs.clear_degraded('weight_swap', scope=eng.obs_scope, force=True)
    eng.obs_scope = scope


def fleet_router_overhead(eng, prompts, params, want) -> dict:
    """6i (a): phase 6's engine bare, then behind a one-replica Router, in
    `FLEET_PAIRS` interleaved pairs; the overhead is the least ratio less
    1 (bench.py:router_ab's estimator), gated at 3%."""
    from paddle_tpu_torch.serving import Replica, Router
    scope = eng.obs_scope
    router = Router([Replica(0, eng)])
    tokens = sum(p.max_new_tokens for p in params)
    ratios, bare_s, r1_s = [], [], []
    try:
        for _ in range(FLEET_PAIRS):
            b, hs = _wave_s(lambda: eng.generate_many(prompts, params))
            r, rhs = _wave_s(lambda: router.generate_many(prompts, params))
            for got in ([h.tokens for h in hs], [h.tokens for h in rhs]):
                if got != want:
                    raise AssertionError('serve-fleet (a): a wave did not '
                                         'give phase 6\'s tokens')
            bare_s.append(b)
            r1_s.append(r)
            ratios.append(r / b)
    finally:
        _release_replica(eng, scope)
    overhead = min(ratios) - 1
    log(f'[serve-fleet] (a) bare vs 1-replica router, {FLEET_PAIRS} '
        f'interleaved pairs of the 12 requests: bare '
        f'{", ".join(f"{tokens / s:.1f}" for s in bare_s)} tok/s, router '
        f'{", ".join(f"{tokens / s:.1f}" for s in r1_s)} tok/s; ratios '
        f'{", ".join(f"{x:.4f}" for x in ratios)}; overhead (least ratio '
        f'- 1) {overhead * 100:+.2f}% (prediction +0.1 to +0.5%, gate '
        f'{ROUTER_OVERHEAD_MAX * 100:.0f}%)')
    if overhead > ROUTER_OVERHEAD_MAX:
        raise AssertionError(f'serve-fleet (a): router overhead '
                             f'{overhead * 100:.2f}% > '
                             f'{ROUTER_OVERHEAD_MAX * 100:.0f}%')
    return {'overhead': overhead, 'r1_tok_s': tokens / min(r1_s),
            'bare_tok_s': tokens / min(bare_s)}


def _catalog_sums(cat) -> dict:
    """{program: (invocations, host seconds, FLOPs total, bytes total)}."""
    return {r.name: (r.invocations, r.host_seconds,
                     r.flops * r.invocations, r.bytes_accessed * r.invocations)
            for r in cat.records()}


def fleet_two_replicas(eng, spare, prompts, params, want, r1_tok_s) -> dict:
    """6i (b) and (h): phase 6's engine and `spare` (a graph engine over
    its own copy of the weights, warmed) behind one Router: every greedy
    request's tokens equal the one-replica router's. The goodput
    ledger's window (the MFU baseline) is reset just before, and the
    roofline of the window printed after."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import cost
    from paddle_tpu_torch.serving import GREEDY, Replica, Router
    scope = eng.obs_scope
    router = Router([Replica(0, eng), Replica(1, spare)])
    cat = obs.program_catalog()
    try:
        obs.get_ledger().reset()
        before = _catalog_sums(cat)
        dt, hs = _wave_s(lambda: router.generate_many(prompts, params))
        after = _catalog_sums(cat)
        roof = cost.roofline_summary(max_rows=8)
    finally:
        _release_replica(eng, scope)
    got = [h.tokens for h in hs]
    greedy = [i for i, p in enumerate(params) if p.strategy == GREEDY]
    wrong = [i for i in greedy if got[i] != want[i]]
    placed = [h.replica_id for h in hs]
    if wrong or set(placed) != {0, 1}:
        raise AssertionError(f'serve-fleet (b): requests {wrong} differ from '
                             f'the one-replica router; placements {placed}')
    tokens = sum(p.max_new_tokens for p in params)
    tok_s = tokens / dt
    log(f'[serve-fleet] (b) 2 replicas (replica 1 over its own copy of the '
        f'weights): {tok_s:.1f} tok/s, scaling_2_replica '
        f'{tok_s / r1_tok_s:.3f} (prediction 0.9-1.3: one card, one host '
        f'thread, each round waits for its fetch); placements {placed}; '
        f'greedy tokens == the 1-replica router for all {len(greedy)}; the '
        f'sampled request {"==" if got == want else "!="} too')
    name = 'serving.paged_decode_block'
    d = [a - b for a, b in zip(after[name], before.get(name, (0, 0, 0, 0)))]
    peaks = roof['peak_flops'], roof['peak_hbm_bytes_per_s']
    hbm = d[3] / d[1] / peaks[1] if peaks[1] else None
    mfu = d[2] / d[1] / peaks[0] if peaks[0] else None
    log(f'[serve-fleet] (h) roofline_summary() over (b)\'s window: '
        f'{json.dumps(roof, default=str)}')
    log(f'[serve-fleet] (h) {name} in (b): {d[0]} rounds, {d[1]:.3f} s in '
        f'them; {d[3] / d[0] / 1e9:.2f} GB and {d[2] / d[0] / 1e12:.3f} '
        f'TFLOP a round (analytic); HBM roof share '
        f'{"not measured" if hbm is None else f"{hbm:.3f}"} (prediction '
        f'0.70-0.85), MFU {"not measured" if mfu is None else f"{mfu:.4f}"}'
        f' (prediction < 0.02)')
    return {'tok_s': tok_s, 'scaling': tok_s / r1_tok_s, 'tokens': got,
            'hbm_share': hbm, 'mfu': mfu, 'roofline': roof}


def fleet_chaos(eng, spare, prompts, params, want) -> None:
    """6i (c): the two replicas of (b), breakers that open at one failure
    and half-open after 0.5 s; replica 0 raises a TransientError at its
    3rd step. No request is lost, every failed-over request's tokens
    equal (b)'s, and the log holds `router_failover` and the breaker's
    open -> half_open -> closed (a probe request after the cooldown)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.resilience import TransientError
    from paddle_tpu_torch.serving import (CircuitBreaker, FINISHED, Replica,
                                          Router)
    scope = eng.obs_scope
    breaker = dict(failure_threshold=1, reset_after_s=0.5)
    router = Router([Replica(0, eng, CircuitBreaker('0', **breaker)),
                     Replica(1, spare, CircuitBreaker('1', **breaker))])
    since = _last_seq(obs)
    calls, real = [0], eng.step

    def dying():
        calls[0] += 1
        if calls[0] == 3:
            raise TransientError('UNAVAILABLE: injected replica loss')
        return real()
    eng.step = dying
    try:
        dt, hs = _wave_s(lambda: router.generate_many(prompts, params))
        del eng.step
        time.sleep(breaker['reset_after_s'] + 0.05)
        probe = router.submit(prompts[0], params[0])
        router.run()
    finally:
        eng.__dict__.pop('step', None)
        _release_replica(eng, scope)
    lost = [i for i, h in enumerate(hs)
            if not (h.status == FINISHED or h.error is not None)]
    moved = [i for i, h in enumerate(hs) if h.failovers]
    wrong = [i for i in moved if hs[i].tokens != want[i]]
    events = _router_events(obs, since)
    need = ['breaker_open', 'router_failover', 'breaker_half_open',
            'breaker_closed']
    if lost or not moved or wrong or \
            [e for e in events if e in need] != need or \
            probe.status != FINISHED or probe.replica_id != 0:
        raise AssertionError(f'serve-fleet (c): lost {lost}, failed over '
                             f'{moved} (differing {wrong}), events {events}, '
                             f'probe {probe}')
    tokens = sum(p.max_new_tokens for p in params)
    log(f'[serve-fleet] (c) replica 0 lost at its 3rd step: 0 lost, '
        f'{len(moved)} requests failed over to replica 1 with (b)\'s tokens, '
        f'{tokens / dt:.1f} tok/s through the loss; events {events}; the '
        f'probe after the 0.5 s cooldown closed the breaker')


def fleet_qos(eng, prompts, params) -> None:
    """6i (d): phase 6's engine behind a Router with a protected `paid`
    tenant and a `free` one capped at 4 in flight, shed past 8 queued;
    the 12 requests twice, one router round after every second
    submission (bench.py:router_ab's qos arm steps after each one, but
    its requests are shorter: at 32 tokens a request, one round per
    arrival never fills the free tenant's cap). At least one typed
    rejection with a `retry_after_s`, and every accepted paid request
    finishes."""
    from paddle_tpu_torch.serving import (AdmissionRejected, FINISHED,
                                          Replica, Router)
    scope = eng.obs_scope
    router = Router([Replica(0, eng)], tenants=FLEET_QOS,
                    shed_queue_depth=FLEET_SHED_DEPTH)
    accepted, shed = [], []
    try:
        for i, (p, sp) in enumerate(zip(prompts * 2, params * 2)):
            tenant = 'paid' if i % 3 == 0 else 'free'
            try:
                accepted.append((tenant, router.submit(p, sp,
                                                       tenant=tenant)))
            except AdmissionRejected as exc:
                shed.append((tenant, exc.reason, exc.retry_after_s))
            if i % 2:
                router.step()
        router.run()
    finally:
        _release_replica(eng, scope)

    def p50(tenant):
        vals = sorted(h.ttft for t, h in accepted
                      if t == tenant and h.ttft is not None)
        return vals[len(vals) // 2] * 1e3 if vals else None
    unfinished = [t for t, h in accepted
                  if t == 'paid' and h.status != FINISHED]
    if not shed or any(r is None for _, _, r in shed) or unfinished:
        raise AssertionError(f'serve-fleet (d): shed {shed}, unfinished '
                             f'paid {unfinished}')
    hi, lo = p50('paid'), p50('free')
    log(f'[serve-fleet] (d) QoS ({FLEET_QOS}, shed at {FLEET_SHED_DEPTH} '
        f'queued): {len(accepted)} accepted, {len(shed)} rejected '
        f'({sorted({r for _, r, _ in shed})}, retry_after_s '
        f'{sorted({round(x, 3) for _, _, x in shed})}); p50 TTFT paid '
        f'{hi:.1f} ms, free {lo:.1f} ms')


def _loadgen_trace(vocab):
    """bench.py:adapters_smoke's trace: Poisson rate 8 for 4 s, seed 77,
    prompts 8, outputs 6, `paid` (ad0/ad1/base) and `free` (base)."""
    from paddle_tpu_torch.loadgen import (FixedLength, PoissonSchedule,
                                          TenantClass, make_trace)
    from paddle_tpu_torch.serving import PRIORITY_HIGH, PRIORITY_LOW
    tenants = [
        TenantClass(name='paid', weight=2.0, priority=PRIORITY_HIGH,
                    adapters=(('ad0', 2.0), ('ad1', 1.0), (None, 1.0))),
        TenantClass(name='free', weight=1.0, priority=PRIORITY_LOW)]
    return make_trace(PoissonSchedule(8.0), 4.0, seed=77,
                      prompt_lengths=FixedLength(8),
                      output_lengths=FixedLength(6), tenants=tenants,
                      vocab_size=vocab)


def fleet_loadgen(banked) -> None:
    """6i (e): the adapters_smoke trace replayed (time_scale 0.2) through a
    Router onto phase 6b's banked engine, an SLOEngine of the default
    objectives polled once per router round; /slo and /programs served
    beside it. The trace is identical across two builds, nothing is
    dropped, at least 2 adapters serve, /slo and /programs answer 200 and
    parse, and /programs lists every program the engine captured once,
    its invocations in the replay equal to the engine's own calls."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.loadgen import LoadReplayer, trace_stats
    from paddle_tpu_torch.serving import (PRIORITY_HIGH, PRIORITY_LOW,
                                          Replica, Router, TenantRegistry)
    from paddle_tpu_torch.serving.engine import program_name
    trace = _loadgen_trace(banked.model.config.vocab_size)
    same = _loadgen_trace(banked.model.config.vocab_size) == trace
    reg = TenantRegistry()
    reg.add('paid', priority=PRIORITY_HIGH)
    reg.add('free', priority=PRIORITY_LOW)
    scope = banked.obs_scope
    router = Router([Replica(0, banked)], tenants=reg)
    slo = obs.SLOEngine(obs.default_objectives(2.0))
    obs.set_slo_engine(slo)
    step = router.step

    def polled():
        n = step()
        slo.poll()
        return n
    router.step = polled
    cat = obs.program_catalog()
    inv0 = {r.name: r.invocations for r in cat.records()}
    calls0 = dict(banked._program_calls)
    srv = obs.start_server(0, host='127.0.0.1')
    try:
        t0 = time.perf_counter()
        report = LoadReplayer(router, trace, time_scale=0.2,
                              max_wall_s=60.0).run().report(slo_ttft_s=2.0)
        wall = time.perf_counter() - t0
        slo_code, slo_body = http_get(f'{srv.url}/slo')
        prog_code, prog_body = http_get(f'{srv.url}/programs?format=json')
        text_code, _ = http_get(f'{srv.url}/programs')
    finally:
        srv.stop()
        obs.set_slo_engine(None)
        _release_replica(banked, scope)
    stats = trace_stats(trace)
    slo_doc = json.loads(slo_body) if slo_code == 200 else None
    rows = json.loads(prog_body)['programs'] if prog_code == 200 else []
    names = [r['name'] for r in rows]
    bad = []
    for key in banked.stats()['traces']:
        name = program_name(key)
        row = [r for r in rows if r['name'] == name]
        done = banked._program_calls[name] - calls0.get(name, 0)
        if len(row) != 1 or \
                row[0]['invocations'] - inv0.get(name, 0) != done:
            bad.append((name, names.count(name), row and
                        row[0]['invocations'] - inv0.get(name, 0), done))
    problems = []
    if not same:
        problems.append('the trace differs across two builds')
    if report['dropped'] or report['completed'] != report['offered']:
        problems.append(f'report {report}')
    if len(stats.get('by_adapter', {})) < 2:
        problems.append(f'adapters served {stats.get("by_adapter")}')
    if slo_doc is None or text_code != 200 or not rows or bad:
        problems.append(f'/slo {slo_code}, /programs {prog_code}/'
                        f'{text_code}, catalog vs engine {bad}')
    if problems:
        raise AssertionError('serve-fleet (e): ' + '; '.join(problems))
    burn = {o['name']: (o['burn_short'], o['alerting'])
            for o in slo_doc['objectives']}
    log(f'[serve-fleet] (e) loadgen (adapters_smoke trace, '
        f'{stats["requests"]} requests, adapters {stats["by_adapter"]}) '
        f'through a Router onto the banked engine in {wall:.2f} s: '
        f'{report["completed"]} completed, 0 dropped, TTFT p50 '
        f'{report["ttft_p50_s"]} s p99 {report["ttft_p99_s"]} s, SLO '
        f'attainment {report["slo_attainment"]}; /slo 200 (burn short, '
        f'alerting: {burn}); /programs 200 lists each of the engine\'s '
        f'{len(banked.stats()["traces"])} captured programs once with its '
        f'replay calls')


def fleet_autoscale(eng, prompts, params) -> dict:
    """6i (f): an Autoscaler (force=True, 1 to 2 replicas) over a Router
    on phase 6's engine; its factory builds a graph engine over a copy of
    the weights and warms it (the captures). The 12 requests as a
    burst, the 12 again at the scale-up, then quiet: exactly one scale_up and one scale_down, every
    request finished through the drain, and the goodput ledger closed
    within 1% with the provision booked under scale_up."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import (Autoscaler, AutoscalerConfig,
                                          FINISHED, Replica, Router,
                                          replica_model)

    def factory():
        new = _fleet_engine(replica_model(eng.model))
        _warm(new, prompts)
        torch.cuda.synchronize()
        return new
    scope = eng.obs_scope
    router = Router([Replica(0, eng)], signal_window_s=2.0)
    scaler = Autoscaler(router, factory, AutoscalerConfig(
        min_replicas=1, max_replicas=2, slo_ttft_s=100.0,
        up_queue_per_replica=2.0, down_queue_per_replica=0.5,
        cooldown_s=1.0, provision_cooldown_factor=0.0, down_stable_s=1.0),
        force=True)
    since = _last_seq(obs)
    obs.get_ledger().reset()
    t0 = time.perf_counter()
    try:
        hs = [router.submit(p, sp) for p, sp in zip(prompts, params)]
        decisions = []
        while time.perf_counter() - t0 < 45.0:
            decisions.append(scaler.poll())
            if decisions[-1] == 'scale_up':
                # the burst's second half lands on the grown fleet
                hs += [router.submit(p, sp) for p, sp in zip(prompts,
                                                             params)]
            router.step()
            if not router._live:
                if len(router.replicas) == 1 and 'scale_down' in decisions:
                    break
                time.sleep(0.01)
        wall = time.perf_counter() - t0
        gp = obs.get_ledger().report()
    finally:
        _release_replica(eng, scope)
    events = _router_events(obs, since)
    up, down = decisions.count('scale_up'), decisions.count('scale_down')
    gap = abs(sum(gp['categories'].values()) + gp['residual_seconds']
              - gp['wall_seconds'])
    unfinished = [i for i, h in enumerate(hs) if h.status != FINISHED]
    if up != 1 or down != 1 or unfinished or len(router.replicas) != 1 or \
            gap > 0.01 * gp['wall_seconds'] or \
            gp['categories']['scale_up'] <= 0 or \
            'autoscale_down_complete' not in events:
        raise AssertionError(f'serve-fleet (f): scale_up {up}, scale_down '
                             f'{down}, unfinished {unfinished}, replicas '
                             f'{len(router.replicas)}, ledger {gp}, events '
                             f'{events}')
    placed = collections.Counter(h.replica_id for h in hs)
    log(f'[serve-fleet] (f) autoscaler over a burst of {len(hs)} requests '
        f'then quiet, {wall:.2f} s: 1 scale_up (provision: build + '
        f'captures {scaler.provision_ema_s:.2f} s), 1 scale_down drained '
        f'and removed, placements {dict(placed)}, all finished; goodput '
        f'books close within {gap / gp["wall_seconds"] * 100:.3f}% of '
        f'{gp["wall_seconds"]:.2f} s: scale_up '
        f'{gp["categories"]["scale_up"]:.3f} s, scale_down '
        f'{gp["categories"]["scale_down"]:.6f} s; events {events}')
    del hs
    return {'provision_s': scaler.provision_ema_s}


def fleet_rolling_swap(served) -> None:
    """6i (g): `ReplicaUpdater` over a 2-replica Router on the 2-layer
    Llama-2-7B-width model of 6g (b) (a full-depth version would write
    13.5 GB to disk): v1 the model's weights, v2 a perturbed copy, v3 a
    copy with one bf16 NaN. Rolling to v2 under traffic (a pump submits
    while replicas drain): the fleet is mixed mid-roll (the finite gate,
    wrapped, reads the fleet's versions as each replica is gated), every
    request
    finishes, the fleet version is 2 after it and nothing is captured
    again; v3 is refused by the gate on replica 0, rolled back,
    quarantined, and the fleet stays on 2."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (FINISHED, ReplicaSet,
                                          ReplicaUpdater, Router,
                                          SamplingParams, WeightPublisher,
                                          WeightStore, finite_weights_gate)
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(1234, DEV))
    prompts = served['prompts'][:6]
    sp = SamplingParams(max_new_tokens=8, eos_token_id=-1)
    root = _store_dir('fleet-')
    try:
        rs = ReplicaSet(model, 2, **FLEET_ENGINE)
        router = Router(rs)
        for r in rs:            # each replica captures every bucket used
            r.engine.generate_many(prompts, sp)
        traces = [dict(r.engine.stats()['traces']) for r in rs]
        store = WeightStore(str(root))
        WeightPublisher(model, store).publish(step=0)           # v1
        state = perturbed_state(model)
        v2 = store.publish(state, meta={'step': 1})
        name = 'llama.layers.1.self_attn.q_proj.weight'
        nan = state[name].clone()
        nan.view(-1)[nan.numel() // 3] = float('nan')
        v3_state = {**state, name: nan}
        del state, nan
        seen, pumped = [], []

        def pump():
            if len(pumped) < 18:
                pumped.append(router.submit(prompts[len(pumped) % 6], sp))

        def gate(engine, version, tree):
            # runs on each swapped replica before it rejoins: the fleet's
            # versions at that moment
            seen.append(dict(updater.current_versions()))
            return finite_weights_gate(engine, version, tree)
        updater = ReplicaUpdater(router, store, gates=[gate],
                                 traffic_pump=pump)
        # requests in flight when the roll begins: replica 0's drain
        # steps the fleet, and the pump keeps submitting meanwhile
        pumped += [router.submit(p, sp) for p in prompts]
        t0 = time.perf_counter()
        res2 = updater.update_to(v2)
        roll_s = time.perf_counter() - t0
        router.run()
        fleet2 = updater.fleet_version
        v3 = store.publish(v3_state, meta={'step': 2})
        del v3_state
        res3 = updater.poll()
        mixed = any(len(set(v.values())) > 1 for v in seen)
        problems = []
        if res2['outcome'] != 'completed' or fleet2 != v2 or not mixed:
            problems.append(f'v2: {res2}, fleet {fleet2}, mixed {mixed}')
        if any(h.status != FINISHED for h in pumped) or not pumped:
            problems.append(f'pumped {[h.status for h in pumped]}')
        if res3 is None or res3['outcome'] != 'aborted' or \
                [r['outcome'] for r in res3['replicas']] != ['rolled_back'] \
                or store.quarantined() != [v3] or \
                updater.fleet_version != v2:
            problems.append(f'v3: {res3}, quarantined '
                            f'{store.quarantined()}, fleet '
                            f'{updater.fleet_version}')
        if [dict(r.engine.stats()['traces']) for r in rs] != traces or \
                any(r['real_compiles'] for r in res2['replicas']):
            problems.append(f'a graph was captured again: '
                            f'{[r.engine.stats()["traces"] for r in rs]} '
                            f'vs {traces}')
        if problems:
            raise AssertionError('serve-fleet (g): ' + '; '.join(problems))
        log(f'[serve-fleet] (g) ReplicaUpdater on 2 replicas of the 2-layer '
            f'Llama-2-7B-width model: v{v2} rolled in {roll_s:.2f} s under '
            f'traffic ({len(pumped)} requests pumped, all finished; drain '
            f'rounds {[r["drain_rounds"] for r in res2["replicas"]]}, '
            f'recaptures {[r["real_compiles"] for r in res2["replicas"]]}), '
            f'mixed mid-roll, fleet version {fleet2}; v{v3} (one bf16 NaN) '
            f'refused on replica 0, rolled back, quarantined, fleet stays '
            f'v{updater.fleet_version}')
        del rs, router, updater, store, pumped
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def serve_fleet(served, adapted) -> dict:
    """Phase 6i: replicated serving in one process on Llama-2-7B (bf16,
    full depth), phase 6's 12 requests: (a) the router's overhead on
    phase 6's engine, (b) two replicas (the second over its own copy of
    the weights) with (h) the roofline of that window, (c) failover
    through a replica loss, (d) QoS shedding, (e) a loadgen replay under
    the SLO engine onto the banked engine of 6b, (f) the autoscaler, (g)
    the rolling weight swap at 2 layers. Counts the serving kernels'
    launches over the whole phase; frees what it built."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import replica_model
    eng, prompts, params = served['engine'], served['prompts'], \
        served['params']
    want = served['tokens']
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    a = fleet_router_overhead(eng, prompts, params, want)
    t1 = time.perf_counter()
    spare = _fleet_engine(replica_model(eng.model))
    _warm(spare, prompts)
    torch.cuda.synchronize()
    log(f'[serve-fleet] replica 1: a copy of the weights and a graph engine, '
        f'warmed (captures) in {time.perf_counter() - t1:.2f} s')
    b = fleet_two_replicas(eng, spare, prompts, params, want, a['r1_tok_s'])
    fleet_chaos(eng, spare, prompts, params, b['tokens'])
    del spare
    gc.collect()
    torch.cuda.empty_cache()
    fleet_qos(eng, prompts, params)
    fleet_loadgen(adapted['engine'])
    f = fleet_autoscale(eng, prompts, params)
    gc.collect()
    torch.cuda.empty_cache()
    fleet_rolling_swap(served)
    launches = {k: K.LAUNCHES[k] for k in ADAPTER_KERNELS}
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f'serve-fleet: kernels never launched: '
                             f'{missing}')
    took = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f'[serve-fleet] kernel launches over the phase: {launches}')
    log(f'[serve-fleet] phase 6i took {took:.1f} s (budget 120 s), peak '
        f'device memory {peak:.2f} GB above the {base / 1e9:.2f} GB held '
        f'before it')
    if took > 120.0:
        raise AssertionError(f'serve-fleet: {took:.1f} s > 120 s')
    return {'launches': launches, 'overhead': a['overhead'],
            'scaling': b['scaling'], 'provision_s': f['provision_s']}


PROCS_BUDGET_S = 150.0
PROCS_PAIRS = 3
# above the longest call that holds a replica's engine lock: a decode
# round takes ~71 ms and a full-depth swap_weights 7.3-7.8 s (PERF.md,
# PR 12); healthz itself never takes that lock
PROCS_HEARTBEAT_S = 10.0
PROCS_SPAWN_TIMEOUT_S = 300.0
PROCS_SHIP_WAIT_S = 10.0
ROLLOUT_ITERS = 2


def replica_llama(device: str = 'cuda', layers=None):
    """The replica processes' model factory (`chip_smoke.py:replica_llama`,
    also what the parent builds to compare with): phase 6's Llama-2-7B in
    bf16 from the same seed, so every process holds the same weights;
    `layers` cuts the depth."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b() if layers is None else \
        LlamaConfig.llama2_7b(num_hidden_layers=layers)
    return LlamaForCausalLM(cfg, device=device, dtype='bfloat16',
                            generator=ptt.generator(1234, device))


PROCS_FACTORY = f'{Path(__file__).resolve()}:replica_llama'


class _ChildLaunches:
    """Each replica process's kernel launches, read from its `stats()`
    (the newest reading per process uid): the children's share of the
    kernels line. A killed child's reading is the one taken before the
    kill."""

    def __init__(self):
        self.by_uid = {}

    def read(self, rr) -> dict:
        st = rr.stats()
        self.by_uid[st['uid']] = st['launches']
        return st

    def total(self) -> dict:
        out = collections.Counter()
        for launches in self.by_uid.values():
            out.update(launches)
        return dict(out)


def _procs_supervisor(run: Path, name: str, spec):
    """A Supervisor of phase 6j: heartbeat every second, a hang declared
    after PROCS_HEARTBEAT_S, respawns after 0.5-4 s (a dead child is
    reaped, and its device memory released, before its backoff starts),
    the free device memory logged before each spawn."""
    from paddle_tpu_torch.serving import Supervisor
    sup = None

    def popen(argv, env, log_path):
        free, total = torch.cuda.mem_get_info()
        log(f'[serve-procs] spawn {Path(log_path).stem}: device memory '
            f'free {free / 1e9:.2f} of {total / 1e9:.2f} GB (this process '
            f'holds {torch.cuda.memory_reserved() / 1e9:.2f} GB)')
        return sup._default_popen(argv, env, log_path)
    sup = Supervisor(str(run / name), spec, heartbeat_interval_s=1.0,
                     heartbeat_timeout_s=PROCS_HEARTBEAT_S,
                     spawn_timeout_s=PROCS_SPAWN_TIMEOUT_S,
                     backoff_base_s=0.5, backoff_cap_s=4.0, max_restarts=3,
                     restart_window_s=600.0, popen_fn=popen)
    return sup


def _spawn_all(children) -> list:
    """Spawn every (supervisor, name) of `children` at once (one thread
    each; each spawn blocks until its child is warm and bound); returns
    their RemoteReplicas in order, and logs the seconds and each child's
    own account of its warm-up (the last line it wrote)."""
    import threading
    out, errs = {}, []
    t0 = time.perf_counter()

    def one(sup, name):
        try:
            out[name] = sup.spawn(name)
        except BaseException as exc:      # re-raised below, in this thread
            errs.append(exc)
    threads = [threading.Thread(target=one, args=c) for c in children]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    log(f'[serve-procs] spawned {[n for _, n in children]} together in '
        f'{time.perf_counter() - t0:.2f} s (process start to a warm, '
        f'bound socket)')
    for sup, name in children:
        lines = (Path(sup.run_dir) / f'{name}.log').read_text().splitlines()
        log(f'[serve-procs]   {name}: {lines[-1] if lines else "no log"}')
    return [out[n] for _, n in children]


def _check_ready(rr, st, digest, tag: str) -> None:
    """A child's ready-marks: every graph captured at boot (the decode
    round and each prefill bucket, nothing else), no kernel source
    compiled, the parameters' digest `digest` (None: not checked); and
    its serving window since: no capture, no compile."""
    want = {'paged_decode_step': 1, **{f'paged_prefill_{b}': 1
                                       for b in st['pool']['buckets']}}
    problems = []
    if st['traces_at_ready'] != want:
        problems.append(f'captured at boot {st["traces_at_ready"]}, want '
                        f'{want}')
    if st['traces'] != st['traces_at_ready']:
        problems.append(f'captured while serving: {st["traces"]} vs '
                        f'{st["traces_at_ready"]} at ready')
    if st['kernel_builds'] or st['kernel_builds_at_ready']:
        problems.append(f'compiled {st["kernel_builds"]} kernel sources')
    if digest is not None and st['param_digest'] != digest:
        problems.append(f'parameter digest {st["param_digest"][:16]} != '
                        f'{digest[:16]}')
    if problems:
        raise AssertionError(f'serve-procs {tag} ({rr.name}, pid '
                             f'{rr.pid}): ' + '; '.join(problems))


def _child_logs(run: Path) -> None:
    """The last lines of every replica process's log under `run` (a
    failing phase prints them before its directory goes)."""
    for path in sorted(run.glob('*/*.log')):
        tail = path.read_text(errors='replace').splitlines()[-30:]
        log(f'[serve-procs] {path.parent.name}/{path.name}, last lines:\n'
            + '\n'.join(tail))


def _tokens(handles) -> list:
    return [h.tokens for h in handles]


def procs_parity(children, prompts, params, want, digest, seen) -> None:
    """6j (a): each child serves phase 6's 12 requests with phase 6's
    tokens, request by request (the seeded sampling one included), from
    phase 6's weights (digest), warm and without compiling."""
    for rr in children:
        got = _tokens(rr.generate_many(prompts, params))
        wrong = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if wrong:
            raise AssertionError(f'serve-procs (a): child {rr.name} differs '
                                 f'from phase 6 at requests {wrong}')
        _check_ready(rr, seen.read(rr), digest, '(a)')
    log(f'[serve-procs] (a) {len(children)} replica processes: every one '
        f'of the 12 requests gets phase 6\'s tokens (the sampled one too); '
        f'parameter digests == phase 6\'s; the decode round and every '
        f'prefill bucket captured at boot, nothing captured or compiled '
        f'since')


def procs_rpc_overhead(rr, prompts, params, want, digest) -> dict:
    """6j (b): an in-process engine of phase 6's settings over a model of
    its own (the same seed) against one replica process, `PROCS_PAIRS`
    interleaved pairs of the 12 requests: the least ratio less 1
    (bench.py:fleet_rpc_overhead_ab's estimator, both arms warmed by a
    wave off the clock first), reported beside parity."""
    from paddle_tpu_torch.weights import param_digest
    model = replica_llama(DEV)
    if param_digest(model) != digest:
        raise AssertionError('serve-procs (b): the parent\'s model is not '
                             'phase 6\'s')
    eng = _fleet_engine(model)
    _warm(eng, prompts)
    eng.generate_many(prompts, params)    # both arms warm, off the clock
    rr.generate_many(prompts, params)
    tokens = sum(p.max_new_tokens for p in params)
    local, remote, ratios = [], [], []
    for _ in range(PROCS_PAIRS):
        a, ha = _wave_s(lambda: eng.generate_many(prompts, params))
        b, hb = _wave_s(lambda: rr.generate_many(prompts, params))
        if _tokens(ha) != want or _tokens(hb) != want:
            raise AssertionError('serve-procs (b): a wave did not give '
                                 'phase 6\'s tokens')
        local.append(a)
        remote.append(b)
        ratios.append(b / a)
    overhead = min(ratios) - 1
    log(f'[serve-procs] (b) in-process engine vs one replica process, '
        f'{PROCS_PAIRS} interleaved pairs of the 12 requests: in-process '
        f'{", ".join(f"{tokens / s:.1f}" for s in local)} tok/s, process '
        f'{", ".join(f"{tokens / s:.1f}" for s in remote)} tok/s; ratios '
        f'{", ".join(f"{x:.4f}" for x in ratios)}; RPC overhead (least '
        f'ratio - 1) {overhead * 100:+.2f}% (reported, not gated), parity '
        f'True')
    return {'overhead': overhead, 'local_tok_s': tokens / min(local),
            'remote_tok_s': tokens / min(remote)}


def procs_fleet_plane(agg, children, seen) -> None:
    """6j (g): the parent's Aggregator over the children's spool: each
    child's request and token counters equal its own `stats()`, and the
    merged ones their sum; /fleet/metrics parses, with a section per
    child, and /fleet/trace holds each child's spans on a process track
    of its own."""
    from paddle_tpu_torch import observability as obs
    stats = {st['uid']: st for st in (seen.read(rr) for rr in children)}
    want = {'paddle_serving_tokens_total': {u: float(s['tokens'])
                                            for u, s in stats.items()},
            'paddle_serving_requests_total': {
                u: float(s['completed']) for u, s in stats.items()}}
    labels = {'paddle_serving_tokens_total': {},
              'paddle_serving_requests_total': {'status': 'completed'}}
    deadline = time.perf_counter() + PROCS_SHIP_WAIT_S
    while True:
        agg.poll()
        got = {name: {u: v for u, v in agg.per_process_value(
            name, **labels[name]).items() if u in stats}
            for name in want}
        if got == want or time.perf_counter() > deadline:
            break
        time.sleep(0.25)
    merged = {}
    for m in agg.merged()['metrics']:
        if m['name'] in want:
            merged[m['name']] = sum(
                s['value'] for s in m['samples']
                if all(s['labels'].get(k) == v
                       for k, v in labels[m['name']].items()))
    sums = {name: sum(v.values()) for name, v in want.items()}
    if got != want or merged != sums:
        raise AssertionError(f'serve-procs (g): per process {got}, want '
                             f'{want}; merged {merged}, want {sums}')
    srv = obs.start_server(0, host='127.0.0.1')
    try:
        status, body = http_get(srv.url + '/fleet/metrics')
        samples = parse_exposition(body)
        t_status, t_body = http_get(srv.url + '/fleet/trace')
    finally:
        srv.stop()
    fleet_tokens = samples.get(
        'paddle_serving_tokens_total{process="fleet"}')
    trace = json.loads(t_body) if t_status == 200 else {}
    names = {e['pid']: e['args']['name'] for e in trace.get('traceEvents', ())
             if e.get('ph') == 'M' and e['name'] == 'process_name'}
    tracks = collections.defaultdict(set)
    for e in trace.get('traceEvents', ()):
        if e.get('ph') == 'X':
            tracks[names.get(e['pid'])].add(e['name'])
    missing = [u for u in stats
               if not tracks.get(f'process {u}', set())
               & {'serving.decode_round', 'serving.prefill'}]
    if status != 200 or fleet_tokens != sums['paddle_serving_tokens_total'] \
            or missing:
        raise AssertionError(f'serve-procs (g): /fleet/metrics {status}, '
                             f'fleet tokens {fleet_tokens}; /fleet/trace '
                             f'{t_status}, children without serving spans '
                             f'on their track: {missing}')
    log(f'[serve-procs] (g) the parent\'s aggregator over the spool: tokens '
        f'{want["paddle_serving_tokens_total"]}, completed requests '
        f'{want["paddle_serving_requests_total"]} per child == their own '
        f'stats(), merged {sums}; /fleet/metrics parsed ({len(samples)} '
        f'samples), /fleet/trace: {len(trace["traceEvents"])} events on '
        f'{len(names)} process tracks, each child\'s decode and prefill '
        f'spans on its own; clock offsets '
        f'{trace["metadata"]["clock_offsets"]}')


def _wait_restart(sup, restarted, what: str) -> None:
    deadline = time.perf_counter() + PROCS_SPAWN_TIMEOUT_S
    while not restarted and time.perf_counter() < deadline:
        sup.poll()
        time.sleep(0.05)
    if not restarted:
        raise AssertionError(f'serve-procs: {what}: no respawn')


def procs_sigkill(sup, r0, r1, prompts, params, want, seen) -> object:
    """6j (c): a Router over both children; r1 SIGKILLed once both
    decode: 0 lost, every request's tokens phase 6's (failed over ones
    included), the supervisor respawns r1, and the respawned child
    serves phase 6's tokens. Returns the respawned child."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import FINISHED, Replica, Router
    restarted = []
    sup.on_restart = lambda name, replica: restarted.append(replica)
    router = Router([Replica(0, r0), Replica(1, r1)])
    since = _last_seq(obs)
    t0 = time.perf_counter()
    hs = [router.submit(p, sp) for p, sp in zip(prompts, params)]
    while not (r0._slot_req and r1._slot_req and any(
            h.tokens and not h.done for h in hs)):
        router.step()
        if all(h.done for h in hs):
            raise AssertionError('serve-procs (c): the wave ended before '
                                 'both children decoded')
    seen.read(r1)
    sup.kill(r1.name)
    while any(not h.done for h in hs):
        router.step()
    wave = time.perf_counter() - t0
    lost = [i for i, h in enumerate(hs) if h.status != FINISHED]
    moved = [i for i, h in enumerate(hs) if h.failovers]
    wrong = [i for i, h in enumerate(hs) if h.tokens != want[i]]
    t1 = time.perf_counter()
    _wait_restart(sup, restarted, '(c)')
    respawn = time.perf_counter() - t1
    fresh = restarted[0]
    got = _tokens(fresh.generate_many(prompts, params))
    events = [e['name'] for e in obs.get_event_log().events()
              if e['seq'] > since and e['name'].startswith(
                  ('router_failover', 'replica_'))]
    if lost or not moved or wrong or got != want or \
            'router_failover' not in events or fresh.pid == r1.pid:
        raise AssertionError(f'serve-procs (c): lost {lost}, failed over '
                             f'{moved}, differing {wrong}, respawned child '
                             f'== phase 6 {got == want}, events {events}')
    sup.on_restart = None
    log(f'[serve-procs] (c) SIGKILL of {r1.name} (pid {r1.pid}) mid-decode: '
        f'0 lost, {len(moved)} requests failed over to {r0.name} with '
        f'phase 6\'s tokens, the wave in {wave:.2f} s; respawned as pid '
        f'{fresh.pid} in {respawn:.2f} s (backoff included), which serves '
        f'phase 6\'s tokens; events {events}')
    return fresh


def procs_sigstop(sup, rr, seen) -> object:
    """6j (d): `rr` SIGSTOPped: the heartbeat misses, the supervisor
    declares a hang at PROCS_HEARTBEAT_S, SIGKILLs it and respawns it,
    with its events in order. Returns the respawned child."""
    import signal
    from paddle_tpu_torch import observability as obs
    restarted = []
    sup.on_restart = lambda name, replica: restarted.append(replica)
    seen.read(rr)
    since = _last_seq(obs)
    t0 = time.perf_counter()
    os.kill(rr.pid, signal.SIGSTOP)
    _wait_restart(sup, restarted, '(d)')
    took = time.perf_counter() - t0
    sup.on_restart = None
    events = [e['name'] for e in obs.get_event_log().events()
              if e['seq'] > since and e['name'].startswith('replica_')]
    want = ['replica_hang', 'replica_crash', 'replica_restart',
            'replica_spawn', 'replica_ready']
    fresh = restarted[0]
    if events != want or os.path.exists(f'/proc/{rr.pid}') or \
            not fresh.healthz()['ok']:
        raise AssertionError(f'serve-procs (d): events {events}, want '
                             f'{want}; old pid alive '
                             f'{os.path.exists(f"/proc/{rr.pid}")}')
    log(f'[serve-procs] (d) SIGSTOP of {rr.name} (pid {rr.pid}): hang '
        f'declared at the {PROCS_HEARTBEAT_S:.0f} s heartbeat deadline, '
        f'SIGKILLed and respawned as pid {fresh.pid}, {took:.2f} s in all; '
        f'events {events}')
    return fresh


def procs_warm_start(rr, prompts, params, want, digest, seen) -> None:
    """6j (e): a fresh child (respawned in (d)): phase 6's 12 requests
    with phase 6's tokens, and after its ready-marks 0 captures and 0
    kernel compiles."""
    t0 = time.perf_counter()
    got = _tokens(rr.generate_many(prompts, params))
    wave = time.perf_counter() - t0
    st = seen.read(rr)
    if got != want:
        raise AssertionError('serve-procs (e): a fresh child differs from '
                             'phase 6')
    _check_ready(rr, st, digest, '(e)')
    log(f'[serve-procs] (e) fresh child pid {rr.pid}: phase 6\'s tokens, '
        f'first wave {wave:.2f} s; captures after its ready-marks '
        f'{sum(st["traces"].values()) - st["captures_at_ready"]}, kernel '
        f'sources compiled {st["kernel_builds"]}')


def procs_autoscale(sup, r0, router_spool, prompts, params, seen) -> None:
    """6j (f): an Autoscaler (1 to 2 replicas) over a Router on r0 whose
    `signal_source` is a `FleetSignalSource` over the routers' spool (the
    parent ships its router's signals there before each read): the burst
    scales up by spawning a real process, the quiet drains and retires
    one, and every request finishes."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import (Autoscaler, AutoscalerConfig,
                                          FINISHED, Replica, Router)
    router = Router([Replica(0, r0)], signal_window_s=2.0)
    shipper = obs.Shipper(str(router_spool), uid=f'router-{os.getpid()}')
    source = obs.FleetSignalSource(obs.Aggregator(str(router_spool)),
                                   router=router, fresh_s=30.0)
    sources = []

    def read():
        shipper.ship_now()
        sig = source()
        sources.append(sig['source'])
        return sig
    scaler = Autoscaler(router, sup.replica_factory(), AutoscalerConfig(
        min_replicas=1, max_replicas=2, slo_ttft_s=100.0,
        up_queue_per_replica=2.0, down_queue_per_replica=0.5,
        cooldown_s=1.0, provision_cooldown_factor=0.0, down_stable_s=1.0),
        force=True, signal_source=read)
    retire = sup.retire

    def read_and_retire(name, deadline_s=30.0):
        # the retired child's launches, read before it exits
        rr = sup.replicas().get(name)
        if rr is not None:
            seen.read(rr)
        retire(name, deadline_s=deadline_s)
    sup.retire = read_and_retire
    before = set(sup.stats())
    t0 = time.perf_counter()
    hs = [router.submit(p, sp) for p, sp in zip(prompts, params)]
    decisions = []
    try:
        while time.perf_counter() - t0 < 90.0:
            decisions.append(scaler.poll())
            if decisions[-1] == 'scale_up':
                hs += [router.submit(p, sp)
                       for p, sp in zip(prompts, params)]
            router.step()
            if not router._live:
                if len(router.replicas) == 1 and 'scale_down' in decisions:
                    break
                time.sleep(0.05)
    finally:
        del sup.retire
    wall = time.perf_counter() - t0
    added = sorted(set(sup.stats()) - before)
    states = {n: sup.stats()[n]['state'] for n in added}
    up, down = decisions.count('scale_up'), decisions.count('scale_down')
    unfinished = [i for i, h in enumerate(hs) if h.status != FINISHED]
    if up != 1 or down != 1 or unfinished or len(router.replicas) != 1 \
            or router.replicas[0].engine is not r0 or \
            list(states.values()) != ['stopped'] or 'fleet' not in sources:
        raise AssertionError(f'serve-procs (f): scale_up {up}, scale_down '
                             f'{down}, unfinished {unfinished}, replicas '
                             f'{len(router.replicas)}, spawned {states}, '
                             f'signal sources {collections.Counter(sources)}')
    log(f'[serve-procs] (f) autoscaler over a burst of {len(hs)} requests '
        f'then quiet, {wall:.2f} s: 1 scale_up spawned {added} (provision '
        f'{scaler.provision_ema_s:.2f} s: process start to a warm socket), '
        f'1 scale_down drained and retired it ({states}), placements '
        f'{dict(collections.Counter(h.replica_id for h in hs))}, all '
        f'finished; signal reads by source '
        f'{dict(collections.Counter(sources))}')


def procs_rollout(model, publisher, v1, children, prompts) -> dict:
    """6j (h), at 2 of 32 layers (a full-depth version writes 13.5 GB to
    disk): the parent's 2-layer Llama-2-7B-width `model` trains through
    `TrainStep` (AdamW), `publisher` publishes each step to its store,
    and `RolloutLoop` runs ROLLOUT_ITERS iterations over a Router of
    `children` (replica processes that booted on v1 of that store):
    each publish is swapped in by version (`ReplicaUpdater`), each
    iteration's rollouts carry the version they were generated under,
    and no child captures or compiles after its boot. Returns the
    parent's launches and the children's stats."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.loop import RolloutLoop, response_lm_loss
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import Replica, ReplicaUpdater, Router
    vocab = model.config.vocab_size
    ready = [rr.stats() for rr in children]
    # replica ids (and so observability scopes) of their own: this loop
    # runs beside (c)-(e)'s Router over replicas 0 and 1
    router = Router([Replica(10 + i, rr) for i, rr in enumerate(children)])
    step = TrainStep(model, response_lm_loss(vocab), AdamW(
        learning_rate=TRAIN_LR, parameters=model.parameters(),
        multi_precision=True))
    rng = np.random.RandomState(16)
    lengths = [len(p) for p in prompts[:4]]
    loop = RolloutLoop(
        train_step=step, router=router, publisher=publisher,
        updater=ReplicaUpdater(router, publisher.store),
        prompt_fn=lambda i: [rng.randint(3, vocab, (n,)).tolist()
                             for n in lengths],
        reward_fn=lambda p, r: float(np.mean([t % 2 for t in r])),
        rollouts_per_iter=4, keep_best=2, max_new_tokens=16)
    versions = []
    generate = loop.generate

    def recorded(i):
        out = generate(i)
        versions.append([r.weight_version for r in out])
        return out
    loop.generate = recorded
    K.reset_launch_counts()
    t0 = time.perf_counter()
    hist = loop.run(ROLLOUT_ITERS)
    took = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    after = [rr.stats() for rr in children]
    want_versions = [[v1 + i] * 4 for i in range(ROLLOUT_ITERS)]
    swaps = [h['swap'] for h in hist]
    problems = []
    if versions != want_versions:
        problems.append(f'rollout versions {versions}, want {want_versions}')
    if swaps != [{'version': v1 + i + 1, 'outcome': 'completed'}
                 for i in range(ROLLOUT_ITERS)] or \
            [st['weight_version'] for st in after] != [v1 + ROLLOUT_ITERS] * 2:
        problems.append(f'swaps {swaps}, children on '
                        f'{[st["weight_version"] for st in after]}')
    for a, b in zip(ready, after):
        if b['traces'] != a['traces_at_ready'] or b['kernel_builds']:
            problems.append(f'child {b["uid"]} captured {b["traces"]} vs '
                            f'{a["traces_at_ready"]} or compiled '
                            f'{b["kernel_builds"]}')
    missing = [k for k in TRAIN_KERNELS if launches.get(k, 0) <= 0]
    if missing or not all(np.isfinite(h['loss']) for h in hist):
        problems.append(f'kernels never launched {missing}, losses '
                        f'{[h["loss"] for h in hist]}')
    if problems:
        raise AssertionError('serve-procs (h): ' + '; '.join(problems))
    log(f'[serve-procs] (h) RolloutLoop, {ROLLOUT_ITERS} iterations over 2 '
        f'replica processes of the 2-layer Llama-2-7B-width model: '
        f'{took:.2f} s; losses {[round(h["loss"], 4) for h in hist]}, mean '
        f'rewards {[round(h["mean_reward"], 4) for h in hist]}; rollouts '
        f'generated under versions {versions}; swaps by version {swaps}; '
        f'the children captured nothing after boot and compiled nothing')
    return {'launches': launches, 'children': after}


def serve_procs(served) -> dict:
    """Phase 6j: the process fleet on Llama-2-7B (bf16, full width and
    depth), two replica processes under a `Supervisor`, each an engine of
    phase 6's settings that captured its graphs before binding, phase 6's
    12 requests: (a) parity, (b) the RPC overhead, (g) the fleet plane,
    (c) SIGKILL mid-decode, (d) SIGSTOP and (e) a fresh child's warm
    start, beside (h) the rollout loop at 2 layers swapping by version
    (its two children start with the first two, on v1 published first),
    then (f) the autoscaler spawning and retiring a process. Counts the
    parent's and the children's kernel launches; stops every process it
    started."""
    import threading
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (ReplicaSpec, WeightPublisher,
                                          WeightStore)
    prompts, params, want = served['prompts'], served['params'], \
        served['tokens']
    digest = served['digest']
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    run = _store_dir('procs-')
    spool = run / 'spool'
    agg = obs.set_aggregator(obs.Aggregator(str(spool)))
    seen = _ChildLaunches()
    small = replica_llama(DEV, layers=2)
    publisher = WeightPublisher(small, WeightStore(str(run / 'weights')))
    t1 = time.perf_counter()
    v1 = publisher.publish(step=0)
    log(f'[serve-procs] (h) v{v1} of the 2-layer model published in '
        f'{time.perf_counter() - t1:.2f} s')
    sup = _procs_supervisor(run, 'serve', ReplicaSpec(
        PROCS_FACTORY, engine_kwargs=FLEET_ENGINE, spool_dir=str(spool),
        device=DEV))
    sup2 = _procs_supervisor(run, 'rollout', ReplicaSpec(
        PROCS_FACTORY, model_kwargs={'layers': 2},
        engine_kwargs=FLEET_ENGINE, weight_store_dir=str(run / 'weights'),
        spool_dir=str(spool), device=DEV))
    rollout, thread = {}, None

    def run_rollout(children):
        try:
            rollout['h'] = procs_rollout(small, publisher, v1, children,
                                         prompts)
        except BaseException as exc:      # re-raised by the main thread
            rollout['error'] = exc
    try:
        r0, r1, s0, s1 = _spawn_all([(sup, 'r0'), (sup, 'r1'),
                                     (sup2, 's0'), (sup2, 's1')])
        procs_parity([r0, r1], prompts, params, want, digest, seen)
        b = procs_rpc_overhead(r0, prompts, params, want, digest)
        gc.collect()                  # the in-process engine of (b)
        torch.cuda.empty_cache()
        procs_fleet_plane(agg, [r0, r1], seen)
        parent = dict(K.LAUNCHES)
        # (h) trains and swaps (store-bound: each 1.33 GB version is
        # written once and read three times) on a thread of its own while
        # (c)-(e) kill and respawn the serve fleet's processes; it is done
        # before (f), whose autoscaler reads the router gauges both set
        thread = threading.Thread(target=run_rollout, args=([s0, s1],),
                                  name='serve-procs-rollout')
        thread.start()
        r1 = procs_sigkill(sup, r0, r1, prompts, params, want, seen)
        r1 = procs_sigstop(sup, r1, seen)
        procs_warm_start(r1, prompts, params, want, digest, seen)
        thread.join()
        if 'error' in rollout:
            raise rollout['error']
        sup2.stop_all(deadline_s=30.0)
        gc.collect()                  # (h)'s trainer
        torch.cuda.empty_cache()
        procs_autoscale(sup, r0, run / 'router_spool', prompts, params,
                        seen)
        for rr in (r0, r1):
            seen.read(rr)
    except BaseException:
        _child_logs(run)
        raise
    finally:
        if thread is not None:
            thread.join()
        sup.stop_all(deadline_s=30.0)
        sup2.stop_all(deadline_s=30.0)
        obs.set_aggregator(None)
        shutil.rmtree(run, ignore_errors=True)
    h = rollout['h']
    del small, publisher
    gc.collect()
    torch.cuda.empty_cache()
    children = collections.Counter(seen.total())
    for st in h['children']:
        children.update(st['launches'])
    missing = [k for k in SERVE_KERNELS if children[k] <= 0]
    if missing:
        raise AssertionError(f'serve-procs: kernels the children never '
                             f'launched: {missing}')
    mine = collections.Counter(parent) + collections.Counter(h['launches'])
    launches = dict(mine + children)
    took = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    free, total = torch.cuda.mem_get_info()
    log(f'[serve-procs] kernel launches over the phase: parent '
        f'{dict(mine)}, children {dict(children)}')
    log(f'[serve-procs] phase 6j took {took:.1f} s (budget '
        f'{PROCS_BUDGET_S:.0f} s), the parent\'s peak device memory '
        f'{peak:.2f} GB above the {base / 1e9:.2f} GB held before it; '
        f'device memory free after {free / 1e9:.2f} of {total / 1e9:.2f} GB')
    if took > PROCS_BUDGET_S:
        raise AssertionError(f'serve-procs: {took:.1f} s > '
                             f'{PROCS_BUDGET_S:.0f} s')
    return {'launches': launches, 'overhead': b['overhead']}


def paged_float_ms(readings: int = 5, outputs=None) -> list:
    """[(case, [device ms per call] x readings)] of the paged kernel over
    pages in q's dtype at phase 2's serve shape (8 slots, H 32, context
    up to 1024): bf16 and f32 at HKV 32, bf16 at HKV 8 (`queued_ms`);
    where the port takes several query rows per slot, also the verify's
    5 rows, bf16 at HKV 32 and 8. With `outputs` (a dict) each one-row
    case's output goes there, on the host, for a bit comparison of two
    trees (`--paged-bits`)."""
    from paddle_tpu_torch.ops import kernels as K
    gen = torch.Generator(device=DEV).manual_seed(0)
    n, h, ps, p = 8, 32, 16, 64
    num_pages = n * p + 1
    table = (torch.randperm(num_pages - 1, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    lengths = torch.tensor([1024, 1000, 777, 513, 256, 100, 17, 1],
                           dtype=torch.int32, device=DEV)
    out = []
    for dtype, hkv in ((torch.bfloat16, 32), (torch.float32, 32),
                       (torch.bfloat16, 8)):
        q = _randn((n, h, 128), dtype, gen)
        kp, vp = (_randn((num_pages, ps, hkv, 128), dtype, gen)
                  for _ in range(2))
        call = (lambda q=q, kp=kp, vp=vp:
                K.paged_attention(q, kp, vp, table, lengths))
        out.append((f'{str(dtype)[6:]} HKV={hkv}',
                    [queued_ms(call) for _ in range(readings)]))
        if outputs is not None:
            outputs[out[-1][0]] = call().cpu()
    if hasattr(K, 'PAGED_MAX_ROWS'):
        # row 0's key count, so that the last row sees the decode's count
        rows0 = (lengths - SPEC_K).clamp(min=1).to(torch.int32)
        for hkv in (32, 8):
            q = _randn((n, SPEC_K + 1, h, 128), torch.bfloat16, gen)
            kp, vp = (_randn((num_pages, ps, hkv, 128), torch.bfloat16, gen)
                      for _ in range(2))
            call = (lambda q=q, kp=kp, vp=vp:
                    K.paged_attention(q, kp, vp, table, rows0))
            out.append((f'verify T={SPEC_K + 1} bf16 HKV={hkv}',
                        [queued_ms(call) for _ in range(readings)]))
    return out


def int8_rmse_by_depth() -> None:
    """The first decode sub-step's relative logit RMSE of phase 6's
    prompts at Llama-2-7B width and 1-32 layers (bf16, and f32 at 2, 8
    and 32; random weights from phase 6's seed; eager engines): the int8
    engine (q) and the float engine over its pages roundtripped through
    int8 (rt, the JAX bench's int8 arm) against the float-KV engine (f),
    and q against rt."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(2)
    prompts = [rng.randint(3, 32000, (s,)).tolist() for s in SERVE_LENS]
    for dtype, depths in (('bfloat16', (1, 2, 4, 8, 16, 32)),
                          ('float32', (2, 8, 32))):
        for d in depths:
            model = LlamaForCausalLM(
                LlamaConfig.llama2_7b(num_hidden_layers=d), device=DEV,
                dtype=dtype, generator=ptt.generator(1234, DEV))
            out = {}
            for tag, quant in (('f', None), ('rt', None), ('q', 'int8')):
                eng = InferenceEngine(model, num_slots=8, max_length=1024,
                                      decode_block=8, kv_quant=quant)
                eng._capture_decode = eng._capture_prefill = False
                out[tag] = first_step_logits(eng, prompts,
                                             roundtrip=tag == 'rt')
                del eng
            f, rt, q = out['f'], out['rt'], out['q']
            log(f'[int8-rmse] {dtype} {d} layers: q vs f '
                f'{rel_rmse(q, f):.4e}, rt vs f {rel_rmse(rt, f):.4e}, q vs '
                f'rt {rel_rmse(q, rt):.4e}; argmax q == f on '
                f'{int((q.argmax(-1) == f.argmax(-1)).sum())} of '
                f'{len(prompts)}')
            del model, out
            gc.collect()
            torch.cuda.empty_cache()


def hook_host_us(calls: int = 200) -> float:
    """Host µs of one adapted projection at the serve path's decode shape:
    the hook, its wrapper and its launch(es) (`linear_hook` on a tagged
    4096 x 4096 bf16 Linear inside an adapter scope: x [8, 4096] bf16, a
    rank-8 f32 bank of 5 slots, rows [0, 1, 2, 1, 0, 3, 3, 1]), host clock
    over `calls` calls after a warm-up, the device not waited for. Uses
    only the port's public hook API, so it also times an earlier tree."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.serving.adapters import apply
    gen = torch.Generator(device=DEV).manual_seed(3)
    lin = Linear(4096, 4096, bias=False, device=DEV, dtype=torch.bfloat16,
                 generator=gen)
    lin._adapter_site = 'site'
    arrays = {'factors': {'site': {
        'a': 0.05 * torch.randn((5, 4096, 8), generator=gen, device=DEV),
        'b': 0.05 * torch.randn((5, 8, 4096), generator=gen, device=DEV)}},
        'scale': torch.rand(5, generator=gen, device=DEV)}
    rows = torch.tensor([0, 1, 2, 1, 0, 3, 3, 1], dtype=torch.int32,
                        device=DEV)
    x = torch.randn((8, 4096), generator=gen, device=DEV).bfloat16()
    y = lin(x)
    with torch.inference_mode(), apply.adapter_scope(arrays, rows):
        for _ in range(20):
            apply.linear_hook(lin, x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            apply.linear_hook(lin, x, y)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
    return host / calls * 1e6


# ---------------------------------------------------------------------------
# phase 7: where the time goes (torch.profiler, device activity)
# ---------------------------------------------------------------------------

_GROUPS = (('paged_attention', PAGED_KERNELS + INT8_KERNELS),
           ('adapter_matmul', ('adapter_sgmv_kernel',)),
           ('flash_attention_bwd', ('flash_bwd_dq_kernel',
                                    'flash_bwd_dq_wgmma_kernel',
                                    'flash_bwd_dkv_kernel',
                                    'flash_bwd_dkv_wgmma_kernel')),
           ('flash_attention', ('flash_fwd_kernel',
                                'flash_fwd_wgmma_kernel')),
           ('cross_entropy', ('ce_fwd_kernel', 'ce_bwd_kernel')),
           ('rms_norm', ('rms_norm_kernel',)),
           ('matmul', ('gemm', 'gemv', 'xmma', 'cutlass', 'splitk',
                       'nvjet')))


def _breakdown(windows, wall_s: float, label: str) -> float:
    """Log profiled windows [(prof, group or None)]: device time by group
    (a window with a group puts all its device time there; otherwise
    kernels are grouped by name) and the top kernels, and the device's
    idle share of `wall_s`. Returns the device busy ms."""
    groups, names = {}, {}
    for prof, forced in windows:
        for e in _device_events(prof):
            ms = e.time_range.elapsed_us() / 1e3
            low = e.name.lower()
            g = forced or next((g for g, keys in _GROUPS
                                if any(k in low for k in keys)), 'other')
            for table, key in ((groups, g), (names, e.name[:70])):
                c = table.setdefault(key, [0, 0.0])
                c[0] += 1
                c[1] += ms
    busy = sum(v[1] for v in groups.values())
    if not busy:
        log(f'[profile] {label}: the profiler recorded no device time '
            f'(device busy share not measured)')
        return busy
    log(f'[profile] {label}: wall {wall_s * 1e3:.2f} ms, device busy '
        f'{busy:.2f} ms, idle share {1 - busy / (wall_s * 1e3):.3f}')
    for g, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        log(f'[profile]   {g:20s} {n:6d} launches {ms:9.3f} ms')
    for name, (n, ms) in sorted(names.items(),
                                key=lambda kv: -kv[1][1])[:8]:
        log(f'[profile]   top: {ms:8.3f} ms {n:5d}x {name}')
    return busy


PROFILE_TRIES = 3
PROFILE_PAUSE_S = 2.0           # host pause before a retried window, x tries
FRESH_PROFILE_TRIES = 2         # `--profile-train` in a process of its own
FRESH_PROFILE_TIMEOUT_S = 300
TRAIN_RECIPES = {'pretrain': 'Llama 2 pretraining optimizer',
                 'bench': 'bench optimizer'}


def marked_window(body):
    """A torch.profiler window (CUDA activity) around `body`, its result
    synchronized; the CUDA-event ms of `body` is kept as `event_ms`.
    CUPTI has missed the first kernels of a window, most often of one
    opened right after another (the sum of squares of the update window
    after the training step's), so a host pause and a GPU sleep of ~1 us
    (`spin_kernel`) go first."""
    from torch.profiler import ProfilerActivity, profile
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        a.record()
        body()
        b.record()
        torch.cuda.synchronize()
    prof.event_ms = a.elapsed_time(b)
    return prof


def window_note(prof, events: int = 0) -> str:
    """A `marked_window`'s device events by the profiler's clock (their
    count and first start to last end, `spin_kernel` left out) beside the
    CUDA-event ms of its body; where the profiler lost or misread events
    the two part. With `events`, the first `events` of them in order
    (start and length in ms, name)."""
    ev = sorted((e for e in _device_events(prof)
                 if 'spin_kernel' not in e.name),
                key=lambda e: e.time_range.start)
    if not ev:
        return f'no device event, {prof.event_ms:.3f} ms by CUDA events'
    t0 = ev[0].time_range.start
    span = (max(e.time_range.end for e in ev) - t0) / 1e3
    note = (f'{len(ev)} device events over {span:.3f} ms by the profiler, '
            f'{prof.event_ms:.3f} ms by CUDA events')
    if events:
        note += ': ' + '; '.join(
            f'{(e.time_range.start - t0) / 1e3:.3f}'
            f'+{e.time_range.elapsed_us() / 1e3:.3f} {e.name[:48]}'
            for e in ev[:events])
    return note


def missing_kernels(prof, kernels) -> list:
    """The names of `kernels` of which the window holds no device event."""
    seen = {e.name for e in _device_events(prof)}
    return [k for k in kernels if not any(k in n for n in seen)]


def require_kernels(prof, kernels, label: str, absent=()) -> None:
    """Fail unless the profiled window ran a device event of each of
    `kernels`, and none of `absent` (by name)."""
    seen = {e.name for e in _device_events(prof)}
    missing = missing_kernels(prof, kernels)
    if missing:
        raise AssertionError(f'profile: the {label} ran no device event of '
                             f'{missing}')
    stale = [k for k in absent if any(k in n for n in seen)]
    if stale:
        raise AssertionError(f'profile: the {label} ran {stale}')
    log(f'[profile]   {label} ran ' + ', '.join(kernels)
        + (' and no ' + ', '.join(absent) if absent else ''))


def profile_serve(served, adapted, prefixed) -> None:
    """On the serve and banked engines, graph and eager, after their
    counted runs: time one decode round of each with every slot busy (no
    profiler yet; the banked engines' requests under the serve-adapters
    mix), then profile the next round of each, then the prefills of
    `profile_prefills`. Every round must run the split-context
    paged kernels and not the first design's `paged_attn_kernel`; the
    banked ones the cluster adapter kernel and not the first design's
    `adapter_matmul_kernel`. The graph rounds' kernels are read from the
    profile of a replayed round."""
    from torch.profiler import ProfilerActivity, profile
    prompts, adapter_ids = served['prompts'], adapted['ids']
    rounds = []
    for e, ids, label in (
            (served['engine'], None, 'decode round, graph'),
            (served['eager']['engine'], None, 'decode round, eager'),
            (adapted['engine'], adapter_ids,
             'decode round with adapters, graph'),
            (adapted['eager']['engine'], adapter_ids,
             'decode round with adapters, eager')):
        n = e.pool.num_slots
        for p, aid in zip(prompts[:n], ids or [None] * n):
            e.submit(p, max_new_tokens=4 * e.decode_block, eos_token_id=-1,
                     adapter_id=aid)
        e.step()                # admit + prefill all, first round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.step()                # a pure decode round, not profiled
        rounds.append((e, time.perf_counter() - t0,
                       f'{label} ({n} slots x {e.decode_block} sub-steps)'))
    for e, wall, label in rounds:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            e.step()            # the next decode round, profiled
            wall_prof = time.perf_counter() - t0
        busy = _breakdown([(prof, None)], wall, label)
        log(f'[profile]   (the profiled round took {wall_prof * 1e3:.2f} '
            f'ms, idle share {1 - busy / (wall_prof * 1e3):.3f} of it; the '
            f'idle share above uses the unprofiled round)')
        require_kernels(prof, PAGED_KERNELS + ('rms_norm_kernel',), label,
                        absent=('paged_attn_kernel',))
        if e.adapter_bank is not None:
            require_kernels(prof, ('adapter_sgmv_kernel',), label,
                            absent=('adapter_matmul_kernel',))
        e.run()
    profile_prefills(prefixed)


def profile_int8(run) -> None:
    """On the int8 serve engine and its eager twin: one decode round with
    every slot busy, timed unprofiled, then the next round in three
    profiled windows: the round's begin (the window's fill), its
    decode_block sub-steps, its end (the touched pages requantized).
    The sub-steps must run the int8 split, window and combine kernels and
    RMSNorm, and not the float split kernel; the fill and the requantize
    must run device work. Device ms by group, the two bodies each a group
    of their own."""
    for e, label in ((run['engine'], 'int8 decode round, graph'),
                     (run['eager']['engine'], 'int8 decode round, eager')):
        n = e.pool.num_slots
        for p in run['prompts'][:n]:
            e.submit(p, max_new_tokens=4 * e.decode_block, eos_token_id=-1)
        e.step()                # admit + prefill all, first round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.step()                # a pure decode round, not profiled
        wall = time.perf_counter() - t0
        windows = []
        with torch.inference_mode():
            step = e._stage_round()
            for group, body in (
                    ('int8 window fill',
                     lambda: step.run_side('_round_begin')),
                    (None, lambda: [step.run_once()
                                    for _ in range(e.decode_block)]),
                    ('int8 window requantize',
                     lambda: step.run_side('_round_end'))):
                prof = marked_window(body)
                windows.append((prof, group))
                if group is not None and not any(
                        'spin_kernel' not in ev.name
                        for ev in _device_events(prof)):
                    raise AssertionError(f'profile: the {label}\'s {group} '
                                         f'ran no device work')
        _breakdown(windows, wall,
                   f'{label} ({n} slots x {e.decode_block} sub-steps; wall '
                   f'of an unprofiled round)')
        require_kernels(windows[1][0], INT8_KERNELS + ('rms_norm_kernel',),
                        label, absent=('paged_attn_split_kernel',
                                       'paged_attn_kernel'))
        e.run()


def profile_spec(spec) -> None:
    """One speculation round of phase 6e's 2-layer-draft engine with every
    slot busy, profiled, on fresh engines (phase 6e freed its own): on
    the graph engine one replayed round (device ms by kernel group), on
    its eager twin the draft's k sub-steps and the verify with the
    acceptance in windows of their own (the draft's kernels are the
    target's, so only a window tells them apart); idle shares against
    the unprofiled round walls phase 6e took. Each must run the
    split-context paged kernels and RMSNorm."""
    from paddle_tpu_torch.serving import InferenceEngine
    run = spec['draft2']
    for graph, wall, label in (
            (True, run['round_wall_s'], 'spec round, graph'),
            (False, run['eager']['round_wall_s'], 'spec round, eager')):
        e = InferenceEngine(spec['model'], num_slots=8, max_length=1024,
                            kv_page_size=16, draft_model=spec['draft'],
                            num_draft_tokens=SPEC_K)
        e._capture_decode = e._capture_prefill = graph
        n = e.pool.num_slots
        for p in spec['prompts'][:n]:
            e.submit(p, max_new_tokens=4 * (SPEC_K + 1), eos_token_id=-1)
        e.step()                # admit + prefill all, first round
        windows = []
        with torch.inference_mode():
            step = e._stage_round()
            if step.graph is not None:
                bodies = ((None, step.run_once),)
            else:
                drafts = []
                bodies = (('draft (k sub-steps)',
                           lambda: drafts.append(step._propose())),
                          (None, lambda: step._verify(drafts[0])))
            for group, body in bodies:
                windows.append((marked_window(body), group))
        _breakdown(windows, wall, f'{label} ({n} slots, k={SPEC_K}, 2-layer '
                                  f'draft; wall of an unprofiled round)')
        for prof, _ in windows:
            require_kernels(prof, PAGED_KERNELS + ('rms_norm_kernel',),
                            label)
        e.run()
        del e
        torch.cuda.empty_cache()


def profile_prefills(prefixed) -> None:
    """Each of PROFILED_PREFILLS (a whole prefill at bucket 1024, a
    256-token chunk at start 512 over its slot's 1024 rows) on the
    serve-prefix engine, replayed from its captured graph, and on the
    same engine with its prefill eager, each profiled once into a fresh
    slot: device time by group beside the wall that phase 6c measured
    before any profiling (the idle share is taken against it; the
    profiled call's own wall is logged too). Each must run the wgmma
    flash kernel and none of PyTorch's own attention (flash,
    memory-efficient or cuDNN SDPA)."""
    from torch.profiler import ProfilerActivity, profile
    for kind, bucket, start in PROFILED_PREFILLS:
        for label, eng in (('captured', prefixed['engine']),
                           ('eager', prefixed['eager_prefill']['engine'])):
            pool = eng.pool
            slot = pool.alloc()
            try:
                pool.reserve(slot, start + bucket)
                ids = np.random.RandomState(bucket + 1).randint(
                    3, eng.model.config.vocab_size, (bucket,))
                staged = (dict(start=start, floor=start)
                          if kind == 'chunk' else {})
                eng._run_prefill(slot, kind, ids, bucket, **staged)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    eng._run_prefill(slot, kind, ids, bucket, **staged)
                    wall_prof = time.perf_counter() - t0
            finally:
                pool.free(slot)
            what = (f'{kind} prefill, bucket {bucket}'
                    + (f' at start {start} (sq {bucket}, key count '
                       f'{start + bucket} of {pool.max_length} rows)'
                       if kind == 'chunk' else '') + f', {label}')
            busy = _breakdown([(prof, None)],
                              prefixed['walls'][(kind, bucket, label)], what)
            log(f'[profile]   (the profiled call took {wall_prof * 1e3:.2f} '
                f'ms, idle share {1 - busy / (wall_prof * 1e3):.3f} of it; '
                f'the idle share above uses the unprofiled wall of phase '
                f'6c)')
            require_kernels(prof, ('flash_fwd_wgmma_kernel',), what,
                            absent=('pytorch_flash', 'fmha', 'cudnn'))


def whole_row_gather_ms(eng) -> float:
    """Device ms of the captured chunk's whole-row gather for one layer:
    K and V of every row of one slot's table (`gather_rows` over
    max_length rows), queued behind a GPU sleep."""
    from paddle_tpu_torch.nlp import gather_rows
    pool = eng.pool
    slot = pool.alloc()
    try:
        pool.reserve(slot, pool.max_length)
        table = torch.from_numpy(pool.page_table[slot:slot + 1]).to(DEV)
        k_pages, v_pages = pool.pages[0]
        ms = timed(lambda: (gather_rows(k_pages, table),
                            gather_rows(v_pages, table)))[0]
    finally:
        pool.free(slot)
    return ms


def update_bound_ms(opt, named) -> float:
    """The least time of one Adam/AdamW update of `named` parameters under
    `opt` at 3.35 TB/s: each parameter read and written (only written when
    an fp32 master is read instead), its grad (of its dtype) read, twice
    under a global-norm clip (the norm, then the update), each slot read
    and written."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    reads = 2 if isinstance(opt._grad_clip, ClipGradByGlobalNorm) else 1
    total = 0
    for _, p in named:
        slots = opt._slots[p]
        total += (nbytes(p) * ((1 if 'master' in slots else 2) + reads)
                  + 2 * nbytes(*slots.values()))
    return total / HBM_BYTES_PER_S * 1e3


def profile_train(step, batch, step_s: float, recipe: str,
                  fresh_process: bool = True) -> None:
    """One training step of `step` (phase 5's or 5b's: `recipe` of
    TRAIN_RECIPES) in two profiled windows: the forward and backward, and
    the optimizer update. The update window must run the multi-tensor
    Adam kernel (and, under a global-norm clip, the sum of squares); its
    device ms is logged beside `update_bound_ms`. Where the profiler
    recorded no event of a required kernel, the next step is profiled in
    its place after a pause of PROFILE_PAUSE_S x the tries so far, up to
    PROFILE_TRIES steps. On some machines a process that has profiled
    for a while loses the first kernels of most later windows (there,
    the sum of squares and its finish), while a fresh process records
    them: so if the last step still misses one (and `fresh_process`),
    the same profile runs in a process of its own on a fresh rung of
    `recipe` (`--profile-train`), held to the same gates, up to
    FRESH_PROFILE_TRIES times, and the first that exits 0 decides. The
    idle share is taken against `step_s`, the step time measured before
    any profiling (a step run after the profiler has been used costs the
    host more; its wall is logged beside it)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    label = TRAIN_RECIPES[recipe]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(step(batch, batch))
    wall_now = time.perf_counter() - t0
    x = torch.as_tensor(batch, device=DEV)
    clipped = isinstance(step.optimizer._grad_clip, ClipGradByGlobalNorm)
    step_kernels = ('flash_fwd_wgmma_kernel', 'flash_bwd_dq_wgmma_kernel',
                    'flash_bwd_dkv_wgmma_kernel')
    update_kernels = (('multi_tensor_adam_kernel',)
                      + (('multi_tensor_sumsq_kernel',) if clipped else ()))

    def update_body():
        step.optimizer.update(step._params)
        for _, p in step._params:
            p.grad = None

    for attempt in range(1, PROFILE_TRIES + 1):
        time.sleep(PROFILE_PAUSE_S * (attempt - 1))
        fwd_bwd = marked_window(
            lambda: next_token_loss(step.layer(x), x).backward())
        update = marked_window(update_body)
        missing = (missing_kernels(fwd_bwd, step_kernels)
                   + missing_kernels(update, update_kernels))
        if not missing:
            break
        log(f'[profile]   training step, {label}: the profiler recorded no '
            f'event of {missing} in step {attempt} of {PROFILE_TRIES} '
            f'(forward and backward: {window_note(fwd_bwd)}; update: '
            f'{window_note(update, events=12)})')
    if missing and fresh_process:
        torch.cuda.empty_cache()
        for attempt in range(1, FRESH_PROFILE_TRIES + 1):
            log(f'[profile]   training step, {label}: profiling it in a '
                f'fresh process ({attempt} of {FRESH_PROFILE_TRIES})')
            child = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 '--profile-train', recipe], capture_output=True,
                text=True, timeout=FRESH_PROFILE_TIMEOUT_S)
            for line in child.stdout.splitlines():
                log(f'[fresh] {line}')
            if not child.returncode:
                return
            log(f'[fresh] exit {child.returncode}: {child.stderr[-2000:]}')
        raise AssertionError(
            f'profile: the training step ({label}) ran no device event of '
            f'{missing} in {PROFILE_TRIES} steps here, nor in '
            f'{FRESH_PROFILE_TRIES} fresh processes')
    _breakdown([(fwd_bwd, None), (update, 'optimizer')], step_s,
               f'training step, {label} (batch {TRAIN_BATCH} x {TRAIN_SEQ}; '
               f'wall = the step time of its phase)')
    log(f'[profile]   forward and backward: {window_note(fwd_bwd)}; update: '
        f'{window_note(update)}')
    log(f'[profile]   (an unprofiled step run now, after the serve '
        f'profile, took {wall_now * 1e3:.2f} ms)')
    require_kernels(fwd_bwd, step_kernels, 'training step')
    require_kernels(update, update_kernels, f'update window ({label})')
    dev = sum(e.time_range.elapsed_us() for e in _device_events(update)
              if 'spin_kernel' not in e.name) / 1e3
    log(f'[profile]   update window ({label}): device {dev:.3f} ms, bound '
        f'{update_bound_ms(step.optimizer, step._params):.3f} ms (the bytes '
        f'of params, grads{" read twice" if clipped else ""} and optimizer '
        f'state at 3.35 TB/s)')


def rung_step(recipe: str = 'bench') -> tuple:
    """(TrainStep, 4 batches of RandomState(0)): phase 5's rung (seed 0)
    under `recipe`: 'bench' is phase 5's optimizer (AdamW lr 3e-4, bf16
    moments), 'pretrain' phase 5b's (`pretraining_optimizer`, bf16
    moments, its scheduler left at step 0). Uses only the port's public
    API, so it also builds the rung of an earlier tree."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=8, use_recompute=True)
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(0, DEV))
    if recipe == 'pretrain':
        opt, _ = pretraining_optimizer(
            model.named_parameters(), PRETRAIN_PEAK_LR, PRETRAIN_WARMUP,
            PRETRAIN_T_MAX, start_lr=0.0, moment_dtype='bfloat16')
    else:
        opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                    moment_dtype='bfloat16')
    rng = np.random.RandomState(0)
    return (TrainStep(model, next_token_loss, opt),
            [rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
             for _ in range(4)])


def rung_step_s(step, batches, steps: int = TRAIN_STEPS) -> tuple:
    """(seconds per step, peak device bytes) of `rung_step`'s (step,
    batches), host clock over `steps` steps after TRAIN_WARMUP."""
    for i in range(TRAIN_WARMUP):
        float(step(batches[i % 4], batches[i % 4]))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step(batches[i % 4], batches[i % 4])
    float(loss)
    return ((time.perf_counter() - t0) / steps,
            torch.cuda.max_memory_allocated())


# ---------------------------------------------------------------------------
# phase 9: the GPT family (GPT-3 XL and GPT-2 small served, GPT-3 XL
# trained, BERT-base encoded and fine-tuned)
# ---------------------------------------------------------------------------

# GPT and BERT normalize with LayerNorm (plain torch, as the JAX package
# leaves it to XLA): their serving path runs the attention kernels only
GPT_SERVE_KERNELS = ('flash_attention_fwd', 'paged_attention')
GPT2_SERVE_KERNELS = ('flash_attention_fwd_d64', 'paged_attention_d64')
# with int8 KV the paged call counts under its `_int8` key at both
# widths; the GPT draft's sub-steps run the float D = 64 paged kernel
# over its pool, the verify the int8 one
GPT_INT8_KERNELS = ('flash_attention_fwd', 'paged_attention_int8')
GPT2_INT8_KERNELS = ('flash_attention_fwd_d64', 'paged_attention_int8_d64')
GPT2_SPEC_KERNELS = ('flash_attention_fwd_d64', 'paged_attention_d64',
                     'paged_attention_verify_int8_d64')
GPT_DRAFT_LAYERS = 2
# GPT-3 XL is served (phases 9 and 10) at 8 of its 24 layers, to keep the
# whole smoke inside its time limit; gpt-train keeps all 24
GPT_SERVE_LAYERS = 8


def gpt3_xl_served():
    """GPT-3 XL's width (d_model 2048, 16 heads x 128, vocab 50304) at
    GPT_SERVE_LAYERS layers (the preset fixes its depth)."""
    from paddle_tpu_torch.nlp import GPTConfig
    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_hidden_layers = GPT_SERVE_LAYERS
    return cfg
GPT_TRAIN_KERNELS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                     'flash_attention_bwd_dkv', 'softmax_ce_fwd',
                     'softmax_ce_bwd', 'multi_tensor_adam')
BERT_TRAIN_KERNELS = ('flash_attention_fwd_d64', 'flash_attention_bwd_dq_d64',
                      'flash_attention_bwd_dkv_d64', 'softmax_ce_fwd',
                      'softmax_ce_bwd', 'multi_tensor_adam')
GPT_TRAIN_STEPS = 3
GENERATE_PROMPTS = (0, 4)        # of SERVE_LENS: 13 and 96 tokens


def _gpt_bank_wave(model, served, kernels, tag) -> dict:
    """One wave of the served requests through an engine whose bank uses
    the default targets (`qkv_proj`, `out_proj`: GPT's projections),
    three adapters, request i under [base, ad0, ad1, ad2][i % 4]: the
    adapter kernel launches once per adapted projection of every prefill
    and decode forward, base requests get the plain engine's tokens, and
    some adapted request differs."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (AdapterBank, InferenceEngine,
                                          make_adapter_factors)
    from paddle_tpu_torch.serving.adapters.bank import DEFAULT_TARGETS
    bank = AdapterBank(model, capacity=4, rank=8, dtype='float32')
    if set(s.rsplit('.', 1)[-1] for s in bank.sites) != set(DEFAULT_TARGETS):
        raise AssertionError(f'{tag}: default-target bank adapts '
                             f'{sorted(bank.sites)}')
    for i in range(3):
        bank.load(f'ad{i}', make_adapter_factors(bank, seed=i + 1,
                                                 scale=0.05))
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16, adapter_bank=bank)
    prompts, params = served['prompts'], served['params']
    ids = [(None, 'ad0', 'ad1', 'ad2')[i % 4] for i in range(len(prompts))]
    torch.cuda.synchronize()
    res = _run_serve(eng, prompts, params, ids, kernels + ('adapter_matmul',),
                     f'{tag} banked', torch.cuda.memory_allocated())
    want = len(bank.sites) * (res['prefills'] + res['decode_steps'])
    if res['launches']['adapter_matmul'] != want:
        got = res['launches']['adapter_matmul']
        raise AssertionError(f'{tag} banked: {got} adapter launches, want '
                             f'{want}')
    base = [j for j, a in enumerate(ids) if a is None]
    wrong = [j for j in base if res['tokens'][j] != served['tokens'][j]]
    changed = [j for j, a in enumerate(ids)
               if a is not None and res['tokens'][j] != served['tokens'][j]]
    if wrong or not changed:
        raise AssertionError(f'{tag} banked: base requests {wrong} differ '
                             f'from the plain engine, or no adapter changed '
                             f'a token')
    log(f'[{tag}] banked wave over {sorted(bank.sites)[:2]}...: '
        f'{len(bank.sites)} sites, {want} adapter launches; base requests '
        f'== the plain engine, {len(changed)} adapted requests changed')
    bank.detach()
    return res


def _generate_equals_engine(model, served, tag) -> None:
    """`generate()` greedy on two of the prompts against the engine, in
    f32 over the served bf16 weights (upcast, so both see the same
    numbers): `generate` attends through the plain masked attention over
    its static cache, the engine through the flash and paged kernels at
    another batch size, and in f32 the two orders of summation agree to
    about 1e-6, far inside a greedy margin. The bf16 engine's tokens are
    logged beside them."""
    import copy
    from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
    m32 = copy.deepcopy(model).float()
    prompts = [served['prompts'][i] for i in GENERATE_PROMPTS]
    eng = InferenceEngine(m32, num_slots=2, max_length=1024, decode_block=8,
                          kv_page_size=16)
    want = [h.tokens for h in eng.generate_many(
        prompts, SamplingParams(max_new_tokens=32, eos_token_id=-1))]
    got = [model_out.tolist() for model_out in (
        m32.generate(torch.tensor([p], device=DEV), max_new_tokens=32,
                     eos_token_id=-1)[0][0] for p in prompts)]
    if got != want:
        raise AssertionError(f'{tag}: generate() {got} != engine {want}')
    same16 = [served['tokens'][i] == w for i, w in zip(GENERATE_PROMPTS,
                                                        want)]
    log(f'[{tag}] generate() greedy == the engine (f32 over the served '
        f'weights) on prompts {list(GENERATE_PROMPTS)}, 32 tokens each; the '
        f'bf16 engine\'s tokens equal them: {same16}')
    del eng, m32
    gc.collect()
    torch.cuda.empty_cache()


def serve_gpt(cfg, tag: str, kernels, seed: int) -> dict:
    """A GPT (bf16, random weights from `seed`) behind the paged engine
    with its decode and prefill graphs, phase 6's 12 requests (a seeded
    sampling one among them): the graph engine's tokens equal its eager
    twin's, a default-target bank's wave (`_gpt_bank_wave`), and
    `generate()` against the engine (`_generate_equals_engine`). Logs
    decode tok/s and the analytic catalog's share of the HBM roof over
    the counted run's decode blocks. The result holds the graph engine
    under 'engine' (`serve_gpt_int8` serves its model again)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.nlp import GPTForCausalLM
    from paddle_tpu_torch.serving import (SAMPLING, InferenceEngine,
                                          SamplingParams)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=DEV, dtype='bfloat16',
                           generator=ptt.generator(seed, DEV))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16)
    log(f'[{tag}] GPT {cfg.num_hidden_layers} layers x {cfg.hidden_size} '
        f'({cfg.num_attention_heads} heads x {cfg.head_dim}) bf16 built in '
        f'{time.perf_counter() - t0:.1f} s, '
        f'{nbytes(*model.parameters()) / 1e9:.2f} GB of weights; KV pool '
        f'{eng.pool.num_pages} pages, {eng.pool.pool_bytes / 1e9:.2f} GB')
    rng = np.random.RandomState(2)
    prompts = [rng.randint(3, cfg.vocab_size, (n,)).tolist()
               for n in SERVE_LENS]
    params = [SamplingParams(max_new_tokens=32, eos_token_id=-1)
              for _ in prompts]
    params[5] = SamplingParams(max_new_tokens=32, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=7)
    cat = obs.program_catalog()
    before = _catalog_sums(cat)
    res = _run_serve(eng, prompts, params, None, kernels, tag, base)
    after = _catalog_sums(cat)
    name = 'serving.paged_decode_block'
    d = [a - b for a, b in zip(after[name], before.get(name, (0, 0, 0, 0)))]
    # the analytic bytes of a round (the warm-up's rounds included in the
    # catalog's mean) over the counted run's rounds and decode seconds
    round_bytes = d[3] / d[0]
    res['hbm_share'] = (round_bytes * res['decode_rounds'] / res['decode_s']
                        / HBM_BYTES_PER_S)
    log(f'[{tag}] decode {res["decode_tok_per_s"]:.1f} tok/s; {name}: '
        f'{round_bytes / 1e9:.2f} GB a round (analytic, TransformerCost), '
        f'{res["decode_rounds"]} rounds in {res["decode_s"]:.3f} s: HBM roof '
        f'share {res["hbm_share"]:.3f}')
    eager = serve_eager(eng, res, prompts, params, None, kernels, tag)
    res.update(prompts=prompts, params=params)
    release(eager)
    banked = _gpt_bank_wave(model, res, kernels, tag)
    _generate_equals_engine(model, res, tag)
    res['launches'] = _summed(res, eager, banked)
    res['engine'] = eng
    return res


def _summed(*runs) -> dict:
    """The runs' launch counts, summed by key."""
    keys = set().union(*(r['launches'] for r in runs))
    return {k: sum(r['launches'].get(k, 0) for r in runs) for k in keys}


def serve_gpt_int8(served, tag: str, kernels, draft_seed=None) -> dict:
    """`serve_gpt`'s model behind the same engine with `kv_quant='int8'`
    (bf16, full width and depth): the served requests on the graph
    engine and its eager twin, then phase 6c's serve-prefix trace
    (`int8_prefix_runs`). Gates: graph tokens equal eager tokens in
    both; `traces` exactly the buckets run; the int8 paged call
    (`kernels[1]`) once per layer of every decode sub-step
    (`check_int8_launches`); the first decode sub-step's logit RMSE
    against the bf16-KV engine (`int8_logit_rmse`); every page free
    after a forced clear. With `draft_seed`, then
    `serve_gpt_spec`. Logs the KV bytes beside the bf16 pool's,
    decode tok/s and TTFT beside the bf16 run, the seconds it took. The
    launches of every run are summed."""
    from paddle_tpu_torch.serving import InferenceEngine
    t0 = time.perf_counter()
    bf16 = served['engine']
    model = bf16.model
    paged = kernels[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16, kv_quant='int8')
    log(f'[{tag}] KV pool {eng.pool.num_pages} pages, '
        f'{eng.pool.pool_bytes / 1e9:.4f} GB int8 with scales, against '
        f'{bf16.pool.pool_bytes / 1e9:.4f} GB bf16; window '
        f'{sum(t.nbytes for kv in eng._decode._windows for t in kv) / 1e6:.1f}'
        f' MB')
    prompts, params = served['prompts'], served['params']
    res = _run_serve(eng, prompts, params, None, kernels, tag, base)
    eager = serve_eager(eng, res, prompts, params, None, kernels, tag)
    release(eager)
    rmse, ref_rmse = int8_logit_rmse(bf16, eng, prompts, tag)
    del eng
    same = sum(a == b for a, b in zip(res['tokens'], served['tokens']))
    log(f'[{tag}] {same} of {len(prompts)} requests get the bf16-KV '
        f'engine\'s 32 tokens')
    pre, pre_eager = int8_prefix_runs(model, tag, kernels)
    runs = {tag: res, f'{tag} eager': eager, f'{tag}-prefix': pre,
            f'{tag}-prefix eager': pre_eager}
    check_int8_launches(runs, paged, model.config.num_hidden_layers, tag)
    log(f'[{tag}-prefix] hits {pre["hits"]}, COW splits '
        f'{pre["cow_splits"]}, chunk rounds {pre["chunk_rounds"]}')
    for key, fmt in (('decode_tok_per_s', '.1f'), ('ttft_mean_s', '.3f'),
                     ('ttft_max_s', '.3f'), ('peak_pages', 'd'),
                     ('peak_mem_gb', '.3f')):
        log(f'[{tag}]   {key}: int8 {res[key]:{fmt}} (eager '
            f'{eager[key]:{fmt}}) vs bf16 {served[key]:{fmt}}; prefix/chunk '
            f'int8 {pre[key]:{fmt}} (eager {pre_eager[key]:{fmt}})')
    out = {'tokens': res['tokens'], 'rmse': rmse, 'ref_rmse': ref_rmse,
           'decode_tok_per_s': res['decode_tok_per_s'],
           'launches': _summed(*runs.values())}
    log(f'[{tag}] int8 serve and prefix/chunk runs took '
        f'{time.perf_counter() - t0:.1f} s')
    if draft_seed is not None:
        spec = serve_gpt_spec(served, out, f'{tag}-draft', draft_seed)
        out['launches'] = _summed(out, spec)
        out['spec'] = spec['spec']
    return out


def serve_gpt_spec(served, int8_run, tag: str, seed: int,
                   kernels=GPT2_SPEC_KERNELS, dtype='bfloat16',
                   kv_quant='int8') -> dict:
    """`serve_gpt`'s model over int8 KV (or `kv_quant`'s) with a
    GPT_DRAFT_LAYERS-layer random GPT draft of its width (in `dtype`,
    weights from `seed`), k = SPEC_K, the served requests on the graph
    engine and its eager twin: equal tokens; the verify (k + 1 rows over
    int8 pages and the round's window, `kernels[2]`) once per layer of
    every round; the draft's float paged kernel (`kernels[1]`) launched.
    Logs the acceptance, decode tok/s beside the plain engine's of the
    same KV (`int8_run`), and how many requests get its tokens (over int8
    pages the verify's rejected rows enter the touched pages' requantize
    scales, as in the JAX engine: a reading, not a gate)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import GPTForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine
    t0 = time.perf_counter()
    model = served['engine'].model
    layers = model.config.num_hidden_layers
    draft = GPTForCausalLM(draft_config(model.config, GPT_DRAFT_LAYERS),
                           device=DEV, dtype=dtype,
                           generator=ptt.generator(seed, DEV))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          kv_page_size=16, kv_quant=kv_quant,
                          draft_model=draft, num_draft_tokens=SPEC_K)
    prompts, params = served['prompts'], served['params']
    res = _run_serve(eng, prompts, params, None, kernels, tag, base)
    spec = eng.stats()['spec']
    verify = kernels[2]
    if res['launches'][verify] != layers * res['decode_steps'] or \
            spec['rounds'] != res['decode_steps']:
        raise AssertionError(f'{tag}: {res["launches"][verify]} verify '
                             f'launches, want {layers} x '
                             f'{res["decode_steps"]} rounds')
    eager = serve_eager(eng, res, prompts, params, None, kernels, tag)
    release(eager)
    same = sum(a == b for a, b in zip(res['tokens'], int8_run['tokens']))
    per_round = 1 + spec['accepted'] / max(spec['proposed'] / SPEC_K, 1)
    log(f'[{tag}] k={SPEC_K}, {GPT_DRAFT_LAYERS}-layer random draft: '
        f'{spec["rounds"]} rounds, acceptance rate '
        f'{spec["acceptance_rate"]:.4f}, {per_round:.3f} tokens per round '
        f'per greedy slot; decode {res["decode_tok_per_s"]:.1f} tok/s '
        f'against the plain {kv_quant or "float"}-KV engine\'s '
        f'{int8_run["decode_tok_per_s"]:.1f}; {same} of {len(prompts)} '
        f'requests get its tokens; the draft\'s paged launches '
        f'{res["launches"][kernels[1]]}, the verify\'s '
        f'{res["launches"][verify]}; took {time.perf_counter() - t0:.1f} s')
    del eng, draft
    return {'spec': spec, 'tokens': res['tokens'],
            'launches': _summed(res, eager), 'runs': (res, eager)}


def train_gpt() -> dict:
    """GPT-3 XL (24 layers, d_model 2048, 16 heads x 128, vocab 50304,
    tied head), bf16, batch 4 x 2048, AdamW (bf16 moments, as the JAX
    bench above 1e9 parameters) through `TrainStep`: GPT_TRAIN_STEPS
    steps on fresh batches, every loss finite, every training kernel
    launched. Hidden dropout 0.1 is on; attention dropout is 0, since a
    dropped attention takes the plain path in both packages. ms a step
    and MFU by the analytic `TransformerCost` (two MLP matrices)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.observability.cost import TransformerCost
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW
    cfg = GPTConfig.gpt3_1p3b(attention_probs_dropout_prob=0.0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = GPTForCausalLM(cfg, device=DEV, dtype='bfloat16',
                           generator=ptt.generator(21, DEV))
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                multi_precision=False, moment_dtype='bfloat16')
    step = TrainStep(model, next_token_loss, opt)
    rng = np.random.RandomState(21)
    batches = [rng.randint(0, cfg.vocab_size, (GPT3_BATCH, TRAIN_SEQ))
               for _ in range(GPT_TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(b, b)))
        times.append(time.perf_counter() - t0)
    launches = {k: K.LAUNCHES[k] for k in GPT_TRAIN_KERNELS}
    if not all(np.isfinite(losses)):
        raise AssertionError(f'gpt-train: losses {losses}')
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f'gpt-train: kernels never launched: {missing}')
    rows = GPT3_BATCH * TRAIN_SEQ
    fwd, _ = TransformerCost(cfg, 2).forward(
        rows, GPT3_BATCH * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2)
    step_s = float(np.mean(times[1:]))
    mfu = 3 * fwd / step_s / PEAK_OPS_PER_S[torch.bfloat16]
    log(f'[gpt-train] GPT-3 XL {n_params / 1e9:.3f} B params bf16, batch '
        f'{GPT3_BATCH} x {TRAIN_SEQ}: losses '
        + ' '.join(f'{x:.4f}' for x in losses)
        + f'; {step_s * 1e3:.1f} ms/step (steps 2-{GPT_TRAIN_STEPS}), MFU '
        f'{mfu:.4f} (TransformerCost: {3 * fwd / 1e12:.1f} TFLOP a step vs '
        f'989 TFLOP/s), peak device memory '
        f'{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB; '
        f'launches {launches}')
    return {'losses': losses, 'step_s': step_s, 'mfu': mfu,
            'launches': dict(K.LAUNCHES)}


def bert_phase() -> dict:
    """BERT-base (bf16, random weights): an encode of B=8 S=512 unmasked
    (the D = 64 flash forward once per layer), then GPT_TRAIN_STEPS
    fine-tune steps of `BertForSequenceClassification` (2 labels, hidden
    dropout 0.1 on, attention dropout 0) through `TrainStep` with AdamW:
    finite losses, and the D = 64 forward, dq and dk/dv kernels launched
    once per layer and step."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import BertConfig, BertForSequenceClassification
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW
    cfg = BertConfig.bert_base(attention_probs_dropout_prob=0.0)
    model = BertForSequenceClassification(cfg, device=DEV, dtype='bfloat16',
                                          generator=ptt.generator(22, DEV))
    rng = np.random.RandomState(22)
    ids = torch.from_numpy(rng.randint(1, cfg.vocab_size,
                                       (BERT_BATCH, BERT_SEQ))).to(DEV)
    K.reset_launch_counts()
    model.eval()
    with torch.no_grad():
        seq, pooled = model.bert(ids)
    encode = K.LAUNCHES['flash_attention_fwd_d64']
    if tuple(seq.shape) != (BERT_BATCH, BERT_SEQ, cfg.hidden_size) \
            or not bool(torch.isfinite(seq).all()) \
            or encode != cfg.num_hidden_layers:
        raise AssertionError(f'bert: encode {tuple(seq.shape)}, '
                             f'{encode} D=64 flash launches')
    model.train()
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters(),
                multi_precision=True)
    step = TrainStep(model, lambda logits, lab: PF.cross_entropy(logits, lab),
                     opt)
    K.reset_launch_counts()
    losses, times = [], []
    for _ in range(GPT_TRAIN_STEPS):
        lab = rng.randint(0, 2, (BERT_BATCH,))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(ids, lab)))
        times.append(time.perf_counter() - t0)
    launches = {k: K.LAUNCHES[k] for k in BERT_TRAIN_KERNELS}
    want = cfg.num_hidden_layers * GPT_TRAIN_STEPS
    if not all(np.isfinite(losses)) or any(
            launches[k] != want for k in BERT_TRAIN_KERNELS[:3]):
        raise AssertionError(f'bert: losses {losses}, launches {launches} '
                             f'(want {want} of each D=64 flash kernel)')
    log(f'[bert] BERT-base bf16 B={BERT_BATCH} S={BERT_SEQ}: encode '
        f'{encode} D=64 flash launches; fine-tune losses '
        + ' '.join(f'{x:.4f}' for x in losses)
        + f', {float(np.mean(times[1:])) * 1e3:.1f} ms/step (steps 2-'
        f'{GPT_TRAIN_STEPS}); launches {launches}')
    return {'losses': losses, 'launches': dict(K.LAUNCHES)}


def gpt_family() -> dict:
    """Phase 9: gpt-serve and gpt-serve-int8, gpt2-serve and
    gpt2-serve-int8 (its prefix/chunk and GPT-draft runs included),
    gpt-train, bert; {name: result} with each run's launch counts."""
    from paddle_tpu_torch.nlp import GPTConfig
    t0 = time.perf_counter()
    out = {}
    for name, cfg, kernels, int8_kernels, seed, draft_seed in (
            ('gpt', gpt3_xl_served(), GPT_SERVE_KERNELS,
             GPT_INT8_KERNELS, 1919, None),
            ('gpt2', GPTConfig.gpt2_small(), GPT2_SERVE_KERNELS,
             GPT2_INT8_KERNELS, 1920, 1921)):
        served = out[f'{name}-serve'] = serve_gpt(cfg, f'{name}-serve',
                                                  kernels, seed)
        out[f'{name}-serve-int8'] = serve_gpt_int8(
            served, f'{name}-serve-int8', int8_kernels, draft_seed)
        release(served)
    out['gpt-train'] = train_gpt()
    release(out['gpt-train'])
    out['bert'] = bert_phase()
    release(out['bert'])
    log(f'[gpt-family] phase 9 took {time.perf_counter() - t0:.1f} s')
    return out


# ---------------------------------------------------------------------------
# phase 10: fp16 models (a model cast with to(dtype='float16'))
# ---------------------------------------------------------------------------

FP16_SERVE_KERNELS = ('flash_attention_fwd_fp16', 'paged_attention_fp16',
                      'rms_norm_fp16')
FP16_GPT_KERNELS = ('flash_attention_fwd_fp16', 'paged_attention_fp16')
FP16_GPT_SPEC_KERNELS = FP16_GPT_KERNELS + ('paged_attention_verify_fp16',)
FP16_GPT2_KERNELS = ('flash_attention_fwd_fp16_d64',
                     'paged_attention_fp16_d64')
FP16_GPT2_SPEC_KERNELS = FP16_GPT2_KERNELS + (
    'paged_attention_verify_int8_fp16_d64',)
FP16_TRAIN_KERNELS = ('flash_attention_fwd_fp16',
                      'flash_attention_bwd_dq_fp16',
                      'flash_attention_bwd_dkv_fp16', 'rms_norm_fp16',
                      'softmax_ce_fwd_fp16', 'softmax_ce_bwd_fp16',
                      'multi_tensor_adam')
# the 4-layer logit check: the fp16 engine against the f32 one, beside
# the bf16 engine's, over one set of weights
FP16_RMSE_LAYERS = 4
# phase 10 serves Llama-2-7B's width at 8 of its 32 layers: cut to keep
# the whole smoke inside its time limit once phase 11 joined it
FP16_LLAMA_LAYERS = 8
# the fp16 TrainStep against an f32 TrainStep from the same weights on
# the same batches. Step 1 (before any update): the fp16 loss within
# FP16_TRAIN_LOSS_RTOL of the f32 one (the logits round at 2^-11
# relative; read 5.2e-6 at ln V ~ 10.4 less the target logit).
# Steps 2-3: the fp16 loss within FP16_TRAIN_UPDATE_SHARE of what the
# f32 updates moved the f32 loss on that batch (its loss after the
# updates less its loss at the initial weights). fp16 without loss
# scaling cannot follow f32 closely: 88% of its dlogits round to 0, so
# its gradient differs from f32's, and Adam's first step, about
# lr sign(g), moves every element by lr whatever its size (read 0.273
# and 0.156 of moves of -0.0044 and -0.0153 nats). A skipped fp16
# update reads 1, a reversed one about 2
FP16_TRAIN_LOSS_RTOL = 1e-4
FP16_TRAIN_UPDATE_SHARE = 0.5


def fp16_only(launches: dict, tag: str) -> None:
    """Every launch in `launches` (a LAUNCHES copy, as `_run_serve`'s
    `every_launch`) is an fp16 kernel's: no key without `_fp16` rose, but
    the multi-tensor update's (one key for every dtype)."""
    other = {k: n for k, n in launches.items() if n and '_fp16' not in k
             and not k.startswith('multi_tensor')}
    if other:
        raise AssertionError(f'{tag}: launches outside the fp16 kernels: '
                             f'{other}')


def _fp16_prompts(vocab: int) -> tuple:
    """Phase 6's 12 requests over `vocab`: SERVE_LENS prompts from seed 2,
    32 new tokens, the sixth a seeded sampling one."""
    from paddle_tpu_torch.serving import SAMPLING, SamplingParams
    rng = np.random.RandomState(2)
    prompts = [rng.randint(3, vocab, (n,)).tolist() for n in SERVE_LENS]
    params = [SamplingParams(max_new_tokens=32, eos_token_id=-1)
              for _ in prompts]
    params[5] = SamplingParams(max_new_tokens=32, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=7)
    return prompts, params


def _fp16_bank_wave(eng, res, prompts, params, kernels, tag) -> list:
    """Phase 6b's wave on the fp16 model: a three-adapter f32 bank (the
    JAX bank's default dtype) on q/k/v/o_proj, request i under [base,
    ad0, ad1, ad2][i % 4], graph and eager twin. Gates: equal tokens, the
    fp16 adapter kernel once per adapted projection of every prefill and
    decode sub-step, base requests the plain fp16 engine's tokens, some
    adapted request differs, every launch an fp16 kernel's."""
    from paddle_tpu_torch.serving import InferenceEngine
    model = eng.model
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    bank = adapter_bank(model, 3, 4)
    beng = InferenceEngine(model, num_slots=8, max_length=1024,
                           decode_block=8, kv_page_size=16,
                           adapter_bank=bank)
    ids = [(None, 'ad0', 'ad1', 'ad2')[i % 4] for i in range(len(prompts))]
    kernels = kernels + ('adapter_matmul_fp16',)
    banked = _run_serve(beng, prompts, params, ids, kernels,
                        f'{tag} banked', base)
    eager = serve_eager(beng, banked, prompts, params, ids, kernels,
                        f'{tag} banked')
    for run, how in ((banked, 'graph'), (eager, 'eager')):
        fp16_only(run['every_launch'], f'{tag} banked ({how})')
        want = len(bank.sites) * (run['prefills'] + run['decode_steps'])
        if run['launches']['adapter_matmul_fp16'] != want:
            raise AssertionError(f'{tag} banked ({how}): '
                                 f'{run["launches"]["adapter_matmul_fp16"]}'
                                 f' fp16 adapter launches, want {want}')
    plain = [j for j, a in enumerate(ids) if a is None]
    wrong = [j for j in plain if banked['tokens'][j] != res['tokens'][j]]
    changed = [j for j, a in enumerate(ids)
               if a is not None and banked['tokens'][j] != res['tokens'][j]]
    if wrong or not changed:
        raise AssertionError(f'{tag} banked: base requests {wrong} differ '
                             f'from the bank-less engine, or no adapter '
                             f'changed a token')
    log(f'[{tag} banked] f32 bank over {len(bank.sites)} projections of the '
        f'fp16 model: fp16 adapter launches = sites x (prefills + decode '
        f'sub-steps) in both runs, base requests == the bank-less engine, '
        f'{len(changed)} adapted requests changed')
    release(eager)
    bank.detach()
    del beng
    return [banked, eager]


def serve_fp16(model, tag: str, kernels, int8_key: str,
               bank=False) -> dict:
    """An fp16 `model` behind the 8-slot paged engine (decode block 8,
    pages of 16) with its decode and prefill graphs, phase 6's 12
    requests (`_fp16_prompts`), graph and eager twin; with `bank`, phase
    6b's wave (`_fp16_bank_wave`); then the same engine with
    `kv_quant='int8'` (int8 pages, the round's window in fp16), graph and
    eager twin. Gates: graph tokens equal eager tokens in every arm;
    every launch an fp16 kernel's (`fp16_only`); the first decode
    sub-step's logits finite on both KV kinds and the int8 engine's
    within INT8_REF_SLACK of the JAX bench's int8 arm (`int8_logit_rmse`);
    the int8 paged call (`int8_key`) once per layer of every decode
    sub-step. Logs decode and prefill tok/s, TTFT and the KV pool's GB."""
    from paddle_tpu_torch.serving import InferenceEngine
    t0 = time.perf_counter()
    layers = model.config.num_hidden_layers
    prompts, params = _fp16_prompts(model.config.vocab_size)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16)
    res = _run_serve(eng, prompts, params, None, kernels, tag, base)
    eager = serve_eager(eng, res, prompts, params, None, kernels, tag)
    runs = [res, eager]
    release(eager)
    if bank:
        runs += _fp16_bank_wave(eng, res, prompts, params, kernels, tag)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng8 = InferenceEngine(model, num_slots=8, max_length=1024,
                           decode_block=8, kv_page_size=16, kv_quant='int8')
    k8 = (kernels[0], int8_key) + kernels[2:]
    r8 = _run_serve(eng8, prompts, params, None, k8, f'{tag}-int8', base)
    e8 = serve_eager(eng8, r8, prompts, params, None, k8, f'{tag}-int8')
    release(e8)
    rmse, ref_rmse = int8_logit_rmse(eng, eng8, prompts, f'{tag}-int8')
    check_int8_launches({f'{tag}-int8': r8, f'{tag}-int8 eager': e8},
                        int8_key, layers, f'{tag}-int8')
    for run in runs + [r8, e8]:
        fp16_only(run['every_launch'], tag)
    kv = (eng.pool.pool_bytes / 1e9, eng8.pool.pool_bytes / 1e9)
    for key, fmt in (('decode_tok_per_s', '.1f'), ('prefill_tok_per_s', '.0f'),
                     ('ttft_mean_s', '.3f'), ('ttft_max_s', '.3f')):
        log(f'[{tag}]   {key}: fp16 {res[key]:{fmt}} (int8 KV '
            f'{r8[key]:{fmt}})')
    log(f'[{tag}]   KV pool: fp16 {kv[0]:.3f} GB, int8 with scales '
        f'{kv[1]:.3f} GB; took {time.perf_counter() - t0:.1f} s')
    del eng8
    return {'engine': eng, 'prompts': prompts, 'params': params,
            'tokens': res['tokens'], 'decode_tok_per_s':
                res['decode_tok_per_s'], 'rmse': rmse, 'ref_rmse': ref_rmse,
            'int8_tokens': r8['tokens'], 'int8_tok_per_s':
                r8['decode_tok_per_s'], 'launches': _summed(*runs, r8, e8)}


def fp16_logit_rmse() -> dict:
    """Llama-2-7B width at FP16_RMSE_LAYERS layers: an f32 model (random
    weights from phase 6's seed), its bf16 and its fp16 cast, each behind
    an eager engine of phase 6's settings (the graphs give the eager
    tokens, phase 10's serve runs show); the first decode sub-step's
    logits of phase 6's prompts. The fp16 engine's relative logit RMSE
    against the f32 engine must be no larger than the bf16 engine's."""
    import copy
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=FP16_RMSE_LAYERS)
    m32 = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                           generator=ptt.generator(1234, DEV))
    prompts, _ = _fp16_prompts(cfg.vocab_size)
    logits = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        m = m32 if dt == torch.float32 else copy.deepcopy(m32).to(dt)
        eng = InferenceEngine(m, num_slots=8, max_length=1024,
                              decode_block=8, kv_page_size=16)
        eng._capture_decode = eng._capture_prefill = False
        logits[dt] = first_step_logits(eng, prompts)
        if not bool(torch.isfinite(logits[dt]).all()):
            raise AssertionError(f'fp16-rmse: {dt} logits not finite')
        del eng, m
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    want = logits[torch.float32]
    r16 = rel_rmse(logits[torch.float16], want)
    rbf = rel_rmse(logits[torch.bfloat16], want)
    agree = {str(dt)[6:]: int((logits[dt].argmax(-1) == want.argmax(-1))
                              .sum()) for dt in (torch.bfloat16,
                                                 torch.float16)}
    log(f'[fp16-rmse] Llama-2-7B width, {FP16_RMSE_LAYERS} layers, the first '
        f'decode sub-step of {len(prompts)} prompts against the f32 engine: '
        f'relative logit RMSE fp16 {r16:.4e}, bf16 {rbf:.4e} (fp16 / bf16 '
        f'{r16 / rbf:.4f}); argmax equal to f32 on {agree} of '
        f'{len(prompts)}')
    if not r16 <= rbf:
        raise AssertionError(f'fp16-rmse: the fp16 engine\'s logit RMSE '
                             f'{r16:.4e} exceeds the bf16 engine\'s {rbf:.4e}')
    return {'rmse_fp16': r16, 'rmse_bf16': rbf, 'launches': {}}


def train_fp16() -> dict:
    """Llama-2-7B width at FP16_TRAIN_LAYERS layers in fp16 (random weights
    from a seed), batch 1 x FP16_TRAIN_SEQ, AdamW with multi_precision
    (fp32 masters, moments f32) through `TrainStep`, 3 steps on fresh
    batches, no loss scaling (as the JAX TrainStep). First the same
    weights in f32: their loss on each batch, then 3 steps of an f32
    TrainStep with the same AdamW on the same batches; and one backward
    of the fp16 model on the first batch: the share of lm_head's gradient
    that is exactly 0 (fp16 dlogits p g round to 0 below 2^-25). Gates:
    every loss finite, step 1's within FP16_TRAIN_LOSS_RTOL of the f32
    step's, steps 2-3 within FP16_TRAIN_UPDATE_SHARE of the f32 updates'
    move of the loss, the fp16 RMSNorm, CE forward and backward and flash
    forward, dq and dk/dv kernels and the multi-tensor update launched,
    no other dtype's. Logs ms a step and MFU (bench.py's count over 989
    TFLOP/s)."""
    import copy
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=FP16_TRAIN_LAYERS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float16',
                             generator=ptt.generator(23, DEV))
    rng = np.random.RandomState(23)
    batches = [rng.randint(0, cfg.vocab_size, (1, FP16_TRAIN_SEQ))
               for _ in range(3)]
    m32 = copy.deepcopy(model).float()
    with torch.no_grad():
        initial32 = []
        for b in batches:
            ids = torch.as_tensor(b, device=DEV)
            initial32.append(float(next_token_loss(m32(ids), ids)))
    step32 = TrainStep(m32, next_token_loss,
                       AdamW(learning_rate=TRAIN_LR,
                             parameters=m32.parameters()))
    losses32 = [float(step32(b, b)) for b in batches]
    del step32, m32
    ids = torch.as_tensor(batches[0], device=DEV)
    loss = next_token_loss(model(ids), ids)
    loss.backward()
    zero = float((model.lm_head.weight.grad == 0).float().mean())
    model.zero_grad(set_to_none=True)
    del loss
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                multi_precision=True)
    step = TrainStep(model, next_token_loss, opt)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(b, b)))
        times.append(time.perf_counter() - t0)
    launches = dict(K.LAUNCHES)
    rel = abs(losses[0] - losses32[0]) / abs(losses32[0])
    moved = [l32 - l0 for l32, l0 in zip(losses32[1:], initial32[1:])]
    shares = [abs(l16 - l32) / abs(mv) for l16, l32, mv in
              zip(losses[1:], losses32[1:], moved)]
    step_s = float(np.mean(times[1:]))
    flops = train_flops_per_step(cfg, 1, FP16_TRAIN_SEQ)
    mfu = flops / step_s / PEAK_OPS_PER_S[torch.float16]
    log(f'[fp16-train] Llama-2-7B width, {FP16_TRAIN_LAYERS} layers fp16, '
        f'batch 1 x {FP16_TRAIN_SEQ}, AdamW multi_precision: losses '
        + ' '.join(f'{x:.6f}' for x in losses)
        + '; the f32 TrainStep from the same weights '
        + ' '.join(f'{x:.6f}' for x in losses32)
        + ', the f32 initial weights on each batch '
        + ' '.join(f'{x:.6f}' for x in initial32)
        + f'; step 1 rel {rel:.3e} (limit {FP16_TRAIN_LOSS_RTOL}); steps '
        f'2-3: the f32 updates moved the loss by '
        + ' '.join(f'{x:+.6f}' for x in moved)
        + ', the fp16 loss off the f32 one by '
        + ' '.join(f'{x:.4f}' for x in shares)
        + f' of that (limit {FP16_TRAIN_UPDATE_SHARE}); '
        f'{step_s * 1e3:.1f} ms/step '
        f'(steps 2-3), MFU {mfu:.4f} ({flops / 1e12:.1f} TFLOP a step by '
        f'bench.py\'s count vs 989 TFLOP/s), peak device memory '
        f'{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB; '
        f'lm_head\'s gradient exactly 0 on {zero:.4f} of its elements; '
        f'launches ' + json.dumps({k: launches[k] for k in
                                   FP16_TRAIN_KERNELS}))
    if not all(np.isfinite(losses)) or not rel <= FP16_TRAIN_LOSS_RTOL \
            or not all(x <= FP16_TRAIN_UPDATE_SHARE for x in shares):
        raise AssertionError(f'fp16-train: losses {losses}, f32 {losses32} '
                             f'from {initial32}')
    missing = [k for k in FP16_TRAIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f'fp16-train: kernels never launched: '
                             f'{missing}')
    fp16_only(launches, 'fp16-train')
    del step, opt, model
    return {'losses': losses, 'losses32': losses32, 'initial32': initial32,
            'shares': shares, 'step_s': step_s, 'mfu': mfu,
            'zero_share': zero, 'launches': launches}


def fp16_phase() -> dict:
    """Phase 10: fp16 models on the card. Llama-2-7B's width at
    FP16_LLAMA_LAYERS of its 32 layers (fp16, phase 6's seed) served with
    float KV, behind a bank, and with int8 KV (`serve_fp16`); the 4-layer
    logit check (`fp16_logit_rmse`); GPT-3 XL (D = 128) and GPT-2
    small (D = 64) in fp16 with float and int8 KV, and a 2-layer fp16
    draft over each (float KV at D = 128: the fp16 verify; int8 KV at
    D = 64); the fp16 TrainStep (`train_fp16`). {name: result}."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                      LlamaForCausalLM)
    t0 = time.perf_counter()
    out = {}
    model = LlamaForCausalLM(
        LlamaConfig.llama2_7b(num_hidden_layers=FP16_LLAMA_LAYERS),
        device=DEV, dtype='float16', generator=ptt.generator(1234, DEV))
    log(f'[llama-fp16] Llama {FP16_LLAMA_LAYERS} of 32 layers x 4096 fp16, '
        f'{nbytes(*model.parameters()) / 1e9:.2f} GB of weights')
    out['llama-fp16'] = serve_fp16(model, 'llama-fp16', FP16_SERVE_KERNELS,
                                   'paged_attention_int8_fp16', bank=True)
    del model
    release(out['llama-fp16'])
    out['fp16-rmse'] = fp16_logit_rmse()
    for name, cfg, kernels, int8_key, seed, spec in (
            ('gpt-fp16', gpt3_xl_served(), FP16_GPT_KERNELS,
             'paged_attention_int8_fp16', 1919,
             (FP16_GPT_SPEC_KERNELS, None, 'plain')),
            ('gpt2-fp16', GPTConfig.gpt2_small(), FP16_GPT2_KERNELS,
             'paged_attention_int8_fp16_d64', 1920,
             (FP16_GPT2_SPEC_KERNELS, 'int8', 'int8'))):
        model = GPTForCausalLM(cfg, device=DEV, dtype='float16',
                               generator=ptt.generator(seed, DEV))
        run = out[name] = serve_fp16(model, name, kernels, int8_key)
        spec_kernels, kv_quant, ref = spec
        ref_run = run if ref == 'plain' else {
            'tokens': run['int8_tokens'],
            'decode_tok_per_s': run['int8_tok_per_s']}
        drafted = serve_gpt_spec(run, ref_run, f'{name}-draft',
                                      seed + 100, kernels=spec_kernels,
                                      dtype='float16', kv_quant=kv_quant)
        for r in drafted['runs']:
            fp16_only(r['every_launch'], f'{name}-draft')
        run['launches'] = _summed(run, drafted)
        del model
        release(run)
    out['fp16-train'] = train_fp16()
    gc.collect()
    torch.cuda.empty_cache()
    log(f'[fp16] phase 10 took {time.perf_counter() - t0:.1f} s')
    return out


# ---------------------------------------------------------------------------
# phase 11: T5 (encoder-decoder generation and training), the tokenizer
# with its host C++, and a jit-exported program
# ---------------------------------------------------------------------------

# T5-large served and trained at full width and depth: batch 8, encoder
# 512 tokens, decoder 128 (training) or 64 new tokens (generation)
T5_BATCH, T5_ENC, T5_DEC, T5_NEW, T5_BEAMS = 8, 512, 128, 64, 4
T5_PROMPT_LENS = (64, 100, 128, 200, 256, 320, 400, 512)
# the tokenizer trains on text in the repo (nothing is downloaded); the
# prompts come from another file
T5_CORPUS, T5_PROMPT_TEXT, T5_TOKENIZER_VOCAB = (
    ('SURVEY.md', 'PAPER.md'), 'README.md', 2000)
# the f32 gates run at 2 + 2 layers of full width: greedy against an
# argmax over uncached forwards, the card's logits and a TrainStep's
# losses against the port on the CPU (batch 2), speculative == greedy
T5_CHECK_LAYERS, T5_CHECK_NEW, T5_CHECK_BATCH = 2, 16, 2
T5_LOSS_RTOL = 1e-4
# the f32 logits at 2 + 2 layers: T5's tied head gives logits ~0.04 from a
# 1024-term sum that cancels, so f32 itself lies 1.6e-5 to 2.9e-5 (rel_norm,
# rel_max) from float64 there, past the kernels' 1e-5 limit (measured on
# the CPU). The card's logits are held to a float64 run of the CPU copy,
# no further from it than T5_F64_SLACK x the CPU's own f32 logits are,
# and never past T5_F32_CEIL, which also bounds the card against the CPU
# (readings 1.6e-5 to 6.1e-5), so the limit cannot widen with the CPU's
T5_F64_SLACK = 2.0
T5_F32_CEIL = 1e-4
T5_TRAIN_STEPS = 3
T5_TRAIN_KERNELS = ('rms_norm', 'flash_attention_fwd_d64',
                    'flash_attention_bwd_dq_d64',
                    'flash_attention_bwd_dkv_d64', 'softmax_ce_fwd',
                    'softmax_ce_bwd')
T5_EXPORT_ROOT = Path(__file__).resolve().parent / 'build' / 't5_export'


def t5_cases() -> list:
    """Phase 2's cases at T5-large's shapes: the flash forward with its
    LSE, dq and dk/dv at the cross-attention's D = 64, non-causal, B=8,
    H=16 over Sk=512 keys, Sq = 128 (training's decoder; the bf16 case
    reports the `_t5` rows), 1 and 100 (a partial last query tile), bf16
    and f32; RMSNorm bf16 over [4096, 1024]; CE forward and backward bf16
    at [1024, 32128] with ignored rows."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(23)
    cases, add = _case_list()
    for dtype in (torch.bfloat16, torch.float32):
        for sq in (T5_DEC, 1, 100):
            rep = dtype == torch.bfloat16 and sq == T5_DEC
            _flash_train_case(add, gen, dtype, T5_BATCH, sq, 16, 16, d=64,
                              causal=False, sk=T5_ENC, rep=rep, rep_fwd=rep,
                              row_suffix='_t5')
    dtype = torch.bfloat16
    x = _randn((T5_BATCH * T5_ENC, 1024), dtype, gen)
    w = (1 + 0.1 * torch.randn(1024, generator=gen, device=DEV)).to(dtype)
    add('rms_norm', f'rms_norm bf16 rows={x.shape[0]} width=1024', dtype,
        lambda x=x, w=w: K.rms_norm(x, w, 1e-6),
        lambda x=x, w=w: K.rms_norm_reference(x, w, 1e-6),
        lambda x=x, w=w: F.rms_norm(x, (1024,), w, 1e-6),
        nbytes(x, x, w), 4 * x.numel(), rep=True, row='rms_norm_t5')
    _ce_case(add, gen, dtype, T5_BATCH * T5_DEC, 32128, rep=True,
             row_suffix='_t5')
    return cases


def t5_step_launches(cfg) -> dict:
    """Each training kernel's launches in one step of a T5 without an
    encoder mask: RMSNorm 2 per encoder block, 3 per decoder block and the
    2 final norms; the flash forward once per decoder block (its
    cross-attention, D = 64) and dq and dk/dv once each; CE once each
    way. `use_recompute` reruns each block's forward in the backward:
    its norms and its flash forward again."""
    enc, dec = cfg.num_layers, cfg.num_decoder_layers
    rerun = 1 if cfg.use_recompute else 0
    return {'rms_norm': (2 * enc + 3 * dec) * (1 + rerun) + 2,
            'flash_attention_fwd_d64': dec * (1 + rerun),
            'flash_attention_bwd_dq_d64': dec,
            'flash_attention_bwd_dkv_d64': dec,
            'softmax_ce_fwd': 1, 'softmax_ce_bwd': 1}


def t5_train_flops(cfg, b: int, s_enc: int, s_dec: int) -> float:
    """Model FLOPs of one training step (3 x the forward; the recompute's
    extra forward not counted), written out in PERF.md: per encoder
    token and layer 8 d i (q, k, v, o) + 4 s_enc i (the scores and PV of
    all s_enc keys) + the FF; per decoder token and layer 8 d i + 4 s_dec
    i (self-attention over all s_dec keys, as the masked plain attention
    computes) + 4 d i (cross q, o) + 4 s_enc i + the FF, and 4 d i per
    encoder token and decoder layer (cross k, v); the head 2 d V per
    decoder token. The FF is 4 d f, or 6 d f gated. d = d_model, i =
    heads x d_kv, f = d_ff."""
    d, i, f, v = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff, \
        cfg.vocab_size
    ff = (6 if cfg.is_gated_act else 4) * d * f
    enc = b * s_enc * cfg.num_layers * (8 * d * i + 4 * s_enc * i + ff)
    dec = b * s_dec * cfg.num_decoder_layers * (
        8 * d * i + 4 * s_dec * i + 4 * d * i + 4 * s_enc * i + ff)
    cross_kv = b * s_enc * cfg.num_decoder_layers * 4 * d * i
    head = b * s_dec * 2 * d * v
    return 3.0 * (enc + dec + cross_kv + head)


def t5_tokenize() -> dict:
    """A `FastBPETokenizer` trained on T5_CORPUS (vocab
    T5_TOKENIZER_VOCAB), then 8 prompts of T5_PROMPT_LENS tokens, each
    from its own stretch of T5_PROMPT_TEXT, padded to T5_ENC with their
    attention mask. Gates: every encode took the native path
    (`fast_tokenizer.ENCODES`), and the Python path gives the same ids.
    Logs the training seconds and both paths' ms per batch encode (the
    best of 3)."""
    from paddle_tpu_torch.nlp import fast_tokenizer as fast
    from paddle_tpu_torch.nlp.tokenizer import BPETokenizer
    root = Path(__file__).resolve().parent
    lines = [line for name in T5_CORPUS
             for line in (root / name).read_text().splitlines()]
    t0 = time.perf_counter()
    tok = fast.FastBPETokenizer().train_from_iterator(
        lines, vocab_size=T5_TOKENIZER_VOCAB)
    train_s = time.perf_counter() - t0
    words = (root / T5_PROMPT_TEXT).read_text().split()
    per = len(words) // len(T5_PROMPT_LENS)
    texts = [' '.join(words[i * per:(i + 1) * per])
             for i in range(len(T5_PROMPT_LENS))]
    before = dict(fast.ENCODES)
    ms = {}
    # the Python path: the parent's merge loop (FastBPETokenizer's own
    # tokenize is the native one)
    for path, encode in (('native', lambda t, n: tok.encode(t,
                                                            max_length=n)),
                         ('python', lambda t, n: tok.convert_tokens_to_ids(
                             BPETokenizer.tokenize(tok, t))[:n])):
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            got = [encode(t, n) for t, n in zip(texts, T5_PROMPT_LENS)]
            dt = (time.perf_counter() - t0) * 1e3
            best = dt if best is None else min(best, dt)
        ms[path] = (best, got)
    native, python = ms['native'][1], ms['python'][1]
    if fast.ENCODES['native'] - before['native'] != 3 * len(texts) \
            or fast.ENCODES['python'] != before['python']:
        raise AssertionError(f't5-tokenize: encodes by path '
                             f'{fast.ENCODES} (before {before}): the native '
                             f'path did not serve every encode')
    if native != python or [len(x) for x in native] != list(T5_PROMPT_LENS):
        raise AssertionError('t5-tokenize: native and Python ids differ, or '
                             'a prompt is short')
    ids = np.full((len(texts), T5_ENC), tok.pad_token_id, np.int64)
    mask = np.zeros((len(texts), T5_ENC), np.int64)
    for j, row in enumerate(native):
        ids[j, :len(row)] = row
        mask[j, :len(row)] = 1
    log(f'[t5-tokenize] FastBPETokenizer trained on {" + ".join(T5_CORPUS)} '
        f'({len(lines)} lines) to {len(tok.vocab)} tokens, {len(tok.merges)} '
        f'merges in {train_s:.2f} s; 8 prompts of {T5_PROMPT_LENS} tokens '
        f'from {T5_PROMPT_TEXT}: batch encode {ms["native"][0]:.3f} ms native '
        f'(C++), {ms["python"][0]:.3f} ms Python (best of 3; equal ids); '
        f'encodes by path {fast.ENCODES}')
    return {'tok': tok, 'ids': ids, 'mask': mask, 'train_s': train_s,
            'native_ms': ms['native'][0], 'python_ms': ms['python'][0]}


def _t5_depth(cfg, layers: int):
    """`cfg` cut to `layers` encoder and decoder blocks (its presets fix
    num_layers, as the JAX package's do)."""
    cfg.num_layers = cfg.num_decoder_layers = layers
    return cfg


def _t5_model(cfg, dtype, seed, cls=None):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import T5ForConditionalGeneration
    return (cls or T5ForConditionalGeneration)(
        cfg, device=DEV, dtype=dtype, generator=ptt.generator(seed, DEV))


def _on_cpu_copy(model):
    """A CPU model of the same class and config with `model`'s weights."""
    cpu = type(model)(model.config, device='cpu')
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu


def t5_checks(prep) -> None:
    """T5-large at 2 + 2 layers and full width in f32 (random weights):
    greedy decode over the static cache of prep's 8 padded prompts equals
    an argmax over uncached decoder forwards, and num_beams=1 equals
    greedy; the card's logits (padded prompts, then unmasked: the flash
    cross-attention) lie within T5_F64_SLACK x the CPU copy's f32 logits'
    distance from its float64 run, capped at T5_F32_CEIL, and within
    T5_F32_CEIL of the CPU's f32 logits (`f32_like_cpu`); the
    relative-position buckets the forward gathers on the card equal the
    CPU's exactly (and the f32 expression itself computed on the card,
    logged); a self-draft `speculative_generate`
    gives greedy's tokens; a TrainStep (AdamW, recompute) on the card
    and on the CPU from the same weights and batch (T5_CHECK_BATCH x
    T5_ENC -> T5_DEC, no encoder mask): step 1's loss within
    T5_LOSS_RTOL, step 2's logged."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import T5Config
    from paddle_tpu_torch.nlp.t5 import _relative_position_bucket
    from paddle_tpu_torch.optimizer import AdamW
    t0 = time.perf_counter()
    cfg = _t5_depth(T5Config.t5_large(dropout_rate=0.0, use_recompute=True),
                    T5_CHECK_LAYERS)
    model = _t5_model(cfg, 'float32', 2202).eval()
    cpu = _on_cpu_copy(model).eval()
    ids = torch.from_numpy(prep['ids']).to(DEV)
    mask = torch.from_numpy(prep['mask']).to(DEV)
    greedy, _ = model.generate(ids, max_new_tokens=T5_CHECK_NEW,
                               attention_mask=mask, eos_token_id=-1)
    with torch.no_grad():
        enc = model.encode(ids, attention_mask=mask)
        dec = torch.zeros((ids.shape[0], 1), dtype=torch.int64, device=DEV)
        for _ in range(T5_CHECK_NEW):
            nxt = model(decoder_input_ids=dec, encoder_output=enc,
                        attention_mask=mask)[:, -1].argmax(-1)
            dec = torch.cat([dec, nxt[:, None]], dim=1)
    if not torch.equal(greedy, dec[:, 1:]):
        raise AssertionError(f't5-check: cached greedy {greedy.tolist()} != '
                             f'uncached argmax {dec[:, 1:].tolist()}')
    beam1, _ = model.generate(ids, max_new_tokens=T5_CHECK_NEW,
                              attention_mask=mask, eos_token_id=-1,
                              decode_strategy='beam_search', num_beams=1)
    if not torch.equal(beam1, greedy):
        raise AssertionError('t5-check: num_beams=1 != greedy')
    b, w = T5_CHECK_BATCH, 128
    readings_ = {}
    for label, m in (('padded', mask[:b, :w]), ('unmasked', None)):
        readings_[label] = f32_like_cpu(
            f't5-check logits {label}', model, cpu,
            dict(input_ids=ids[:b, :w], decoder_input_ids=dec[:b],
                 attention_mask=m))
    for stack in ('encoder', 'decoder'):
        attn = getattr(model.t5, stack).block[0].self_attn
        cattn = getattr(cpu.t5, stack).block[0].self_attn
        for sq, sk, off in ((T5_ENC, T5_ENC, 0), (1, T5_NEW + 1, T5_NEW)):
            if not torch.equal(attn.buckets(sq, sk, off).cpu(),
                               cattn.buckets(sq, sk, off)):
                raise AssertionError(f't5-check: {stack} buckets differ '
                                     f'on the card')
    rel = torch.arange(-256, 257)
    flips = {}
    for bi in (True, False):
        on_card = _relative_position_bucket(
            rel.to(DEV), bi, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance).cpu()
        host = _relative_position_bucket(
            rel, bi, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        flips['bidirectional' if bi else 'causal'] = int(
            (on_card != host).sum())
    spec, stats = model.speculative_generate(
        model, ids[:1], max_new_tokens=T5_CHECK_NEW,
        attention_mask=mask[:1], eos_token_id=-1)
    if not torch.equal(spec, greedy[:1]):
        raise AssertionError(f't5-check: self-draft speculative '
                             f'{spec.tolist()} != greedy '
                             f'{greedy[:1].tolist()}')
    rng = np.random.RandomState(22)
    src = rng.randint(2, cfg.vocab_size, (b, T5_ENC))
    tgt = rng.randint(2, cfg.vocab_size, (b, T5_DEC))
    dec_in = np.concatenate([np.zeros((b, 1), np.int64), tgt[:, :-1]], 1)
    losses = []
    for m in (model, cpu):
        m.train()
        step = TrainStep(m, t5_loss(cfg.vocab_size), AdamW(
            learning_rate=TRAIN_LR, parameters=m.parameters()))
        losses.append([float(step((src, dec_in), tgt)) for _ in range(2)])
    rel1 = abs(losses[0][0] - losses[1][0]) / abs(losses[1][0])
    if not rel1 <= T5_LOSS_RTOL:
        raise AssertionError(f't5-check: step-1 loss card {losses[0][0]} vs '
                             f'CPU {losses[1][0]} (rel {rel1:.3e})')
    log(f'[t5-check] T5-large width, {T5_CHECK_LAYERS} + {T5_CHECK_LAYERS} '
        f'layers f32: cached greedy ({T5_CHECK_NEW} tokens x '
        f'{ids.shape[0]} padded prompts) == an argmax over uncached '
        f'forwards, beam 1 == greedy, self-draft speculative == greedy '
        f'({stats["rounds"]} rounds); logits ' + ', '.join(
            f'{k}: {_f64_note(r)}' for k, r in readings_.items())
        + f'; buckets gathered on the card == CPU; the f32 bucket expression '
        f'computed on the card differs from the host at {flips} of 513 '
        f'positions; TrainStep losses card {losses[0]} vs CPU {losses[1]} '
        f'(step 1 rel {rel1:.3e}, limit {T5_LOSS_RTOL}; step 2 rel '
        f'{abs(losses[0][1] - losses[1][1]) / abs(losses[1][1]):.3e}); '
        f'{time.perf_counter() - t0:.1f} s')
    del model, cpu
    gc.collect()
    torch.cuda.empty_cache()


def f32_like_cpu(label: str, model, cpu, kw) -> dict:
    """The card's f32 output of `model(**kw)` against a float64 run of
    its CPU copy `cpu`, within T5_F64_SLACK x the CPU's own f32 output's
    distance from it and within T5_F32_CEIL, and against the CPU's f32
    output within T5_F32_CEIL, by rel_max and by rel_norm; raises past
    either. Returns the three readings (card and CPU against float64,
    card against CPU)."""
    host_kw = {k: None if v is None else v.cpu() for k, v in kw.items()}
    with torch.no_grad():
        got = model(**kw).cpu().double()
        f32 = cpu(**host_kw).double()
        f64 = copy.deepcopy(cpu).double()(**host_kw)
    r = {'card': readings(got, f64), 'cpu': readings(f32, f64),
         'card_vs_cpu': readings(got, f32)}
    over = []
    for m in ('rel_max', 'rel_norm'):
        for name, limit in (
                ('card', min(T5_F64_SLACK * r['cpu'][m], T5_F32_CEIL)),
                ('card_vs_cpu', T5_F32_CEIL)):
            if r[name][m] > limit:
                over.append(f'{name} {m} {r[name][m]:.3e} > {limit:.3e}')
    if over:
        raise AssertionError(f'{label}: f32 past its limit: '
                             f'{"; ".join(over)} ({_f64_note(r)})')
    return r


def _f64_note(r: dict) -> str:
    return (f'rel_max / rel_norm against float64: card '
            f'{r["card"]["rel_max"]:.3e} / {r["card"]["rel_norm"]:.3e}, CPU '
            f'{r["cpu"]["rel_max"]:.3e} / {r["cpu"]["rel_norm"]:.3e}; card '
            f'vs CPU {r["card_vs_cpu"]["rel_max"]:.3e} / '
            f'{r["card_vs_cpu"]["rel_norm"]:.3e}')


def t5_loss(vocab: int):
    from paddle_tpu_torch.nn import functional as F
    return lambda logits, labels: F.cross_entropy(
        logits.reshape(-1, vocab), labels.reshape(-1))


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def t5_serve(prep) -> dict:
    """T5-large (24 + 24 layers, bf16, random weights) generates T5_NEW
    tokens for prep's 8 padded prompts: greedy, beam search (T5_BEAMS
    beams) and sampling under a seed (twice: equal tokens), with
    eos_token_id -1 (a random model's EOS would end rows at random: every
    row then runs all T5_NEW steps, so the timings count the same work);
    the greedy ids decoded to text. Logs tok/s, the encoder's ms and the
    decoder's ms per token (the wall less the encoder, over T5_NEW)."""
    from paddle_tpu_torch.nlp import T5Config
    from paddle_tpu_torch.ops import kernels as K
    cfg = T5Config.t5_large(dropout_rate=0.0)
    model = _t5_model(cfg, 'bfloat16', 2201).eval()
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.from_numpy(prep['ids']).to(DEV)
    mask = torch.from_numpy(prep['mask']).to(DEV)
    model.generate(ids, max_new_tokens=2, attention_mask=mask,
                   eos_token_id=-1)                       # warm-up
    with torch.no_grad():
        enc_s = min(_wall(lambda: model.encode(ids, attention_mask=mask))[1]
                    for _ in range(3))
    K.reset_launch_counts()
    runs = {}
    for label, kw in (('greedy', {}),
                      ('beam', dict(decode_strategy='beam_search',
                                    num_beams=T5_BEAMS)),
                      ('sampling', dict(decode_strategy='sampling', top_k=50,
                                        top_p=0.9, temperature=0.8,
                                        seed=7))):
        (out, scores), wall = _wall(lambda kw=kw: model.generate(
            ids, max_new_tokens=T5_NEW, attention_mask=mask,
            eos_token_id=-1, **kw))
        if tuple(out.shape) != (T5_BATCH, T5_NEW) \
                or not torch.isfinite(scores).all():
            raise AssertionError(f't5-serve {label}: ids {tuple(out.shape)},'
                                 f' scores {scores.tolist()}')
        runs[label] = dict(tokens=out, wall=wall)
    launches = dict(K.LAUNCHES)
    again, _ = model.generate(ids, max_new_tokens=T5_NEW, attention_mask=mask,
                              eos_token_id=-1, decode_strategy='sampling',
                              top_k=50, top_p=0.9, temperature=0.8, seed=7)
    if not torch.equal(again, runs['sampling']['tokens']):
        raise AssertionError('t5-serve: sampling under one seed gave other '
                             'tokens')
    if launches['rms_norm'] <= 0:
        raise AssertionError('t5-serve: the RMSNorm kernel never launched')
    texts = [prep['tok'].decode(row)
             for row in runs['greedy']['tokens'].tolist()]
    out = {'launches': launches, 'enc_ms': enc_s * 1e3}
    for label, r in runs.items():
        out[f'{label}_tok_s'] = T5_BATCH * T5_NEW / r['wall']
        out[f'{label}_dec_ms'] = (r['wall'] - enc_s) * 1e3 / T5_NEW
        log(f'[t5-serve] {label}: {out[f"{label}_tok_s"]:.1f} tok/s '
            f'({T5_BATCH} x {T5_NEW} tokens in {r["wall"]:.3f} s), decoder '
            f'{out[f"{label}_dec_ms"]:.2f} ms per token')
    log(f'[t5-serve] T5-large {n_params / 1e6:.1f} M params bf16, 8 padded '
        f'prompts of {T5_PROMPT_LENS} tokens: encoder {enc_s * 1e3:.2f} ms; '
        f'greedy row 0 decodes to {texts[0][:60]!r} (ids past the '
        f'tokenizer\'s {len(prep["tok"].vocab)} are <unk>); launches '
        f'rms_norm {launches["rms_norm"]}')
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def t5_train() -> dict:
    """T5-large (bf16, `use_recompute=True`, dropout 0) through `TrainStep`
    with `bench_optimizer`'s AdamW: T5_TRAIN_STEPS steps of batch
    T5_BATCH, encoder T5_ENC and decoder T5_DEC tokens, no encoder mask
    (the cross-attention takes the D = 64 flash forward, dq and dk/dv,
    non-causal, Sq T5_DEC over Sk T5_ENC). Gates: finite losses; each
    step launches exactly `t5_step_launches` of every training kernel,
    and the multi-tensor Adam update. Logs ms a step (steps 2-3),
    tokens/s (encoder + decoder), peak memory, MFU by `t5_train_flops`."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import T5Config
    from paddle_tpu_torch.ops import kernels as K
    cfg = T5Config.t5_large(dropout_rate=0.0, use_recompute=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = _t5_model(cfg, 'bfloat16', 2203)
    step = TrainStep(model, t5_loss(cfg.vocab_size), bench_optimizer(model))
    rng = np.random.RandomState(23)
    want = t5_step_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    losses, times, total = [], [], collections.Counter()
    for i in range(T5_TRAIN_STEPS):
        src = rng.randint(2, cfg.vocab_size, (T5_BATCH, T5_ENC))
        tgt = rng.randint(2, cfg.vocab_size, (T5_BATCH, T5_DEC))
        dec = np.concatenate([np.zeros((T5_BATCH, 1), np.int64),
                              tgt[:, :-1]], 1)
        K.reset_launch_counts()
        loss, dt = _wall(lambda: float(step((src, dec), tgt)))
        losses.append(loss)
        times.append(dt)
        got = {k: K.LAUNCHES[k] for k in want}
        total.update(K.LAUNCHES)
        if got != want or K.LAUNCHES['multi_tensor_adam'] <= 0:
            raise AssertionError(f't5-train step {i + 1}: launches {got} '
                                 f'(multi_tensor_adam '
                                 f'{K.LAUNCHES["multi_tensor_adam"]}), want '
                                 f'{want}')
    if not all(np.isfinite(losses)):
        raise AssertionError(f't5-train: losses {losses}')
    step_s = float(np.mean(times[1:]))
    flops = t5_train_flops(cfg, T5_BATCH, T5_ENC, T5_DEC)
    mfu = flops / step_s / PEAK_OPS_PER_S[torch.bfloat16]
    tok_s = T5_BATCH * (T5_ENC + T5_DEC) / step_s
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f'[t5-train] T5-large bf16, recompute, batch {T5_BATCH} x '
        f'{T5_ENC} -> {T5_DEC}: losses ' + ' '.join(f'{x:.4f}' for x in losses)
        + f'; {step_s * 1e3:.1f} ms/step (steps 2-{T5_TRAIN_STEPS}), '
        f'{tok_s:.0f} tokens/s, MFU {mfu:.4f} ({flops / 1e12:.2f} TFLOP a '
        f'step by t5_train_flops vs 989 TFLOP/s), peak device memory '
        f'{peak:.2f} GB; launches a step {want} (exact) and multi_tensor_adam '
        f'{K.LAUNCHES["multi_tensor_adam"]}')
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return {'losses': losses, 'step_s': step_s, 'mfu': mfu, 'tok_s': tok_s,
            'peak_gb': peak, 'launches': dict(total)}


def t5_v1_1(prep) -> dict:
    """t5_v1_1_base (gated-gelu, untied head), bf16, random weights: one
    forward of prep's padded prompts against T5_DEC decoder tokens
    (finite logits of [8, T5_DEC, V]) and greedy generate of T5_NEW // 4
    tokens (finite scores); the same forward at 2 + 2 layers in f32, the
    card's logits held as `f32_like_cpu` holds them."""
    from paddle_tpu_torch.nlp import T5Config
    from paddle_tpu_torch.ops import kernels as K
    ids = torch.from_numpy(prep['ids']).to(DEV)
    mask = torch.from_numpy(prep['mask']).to(DEV)
    dec = torch.randint(2, 32128, (T5_BATCH, T5_DEC), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(4))
    K.reset_launch_counts()
    model = _t5_model(T5Config.t5_v1_1_base(dropout_rate=0.0), 'bfloat16',
                      2204).eval()
    with torch.no_grad():
        logits = model(input_ids=ids, decoder_input_ids=dec,
                       attention_mask=mask)
    toks, scores = model.generate(ids, max_new_tokens=T5_NEW // 4,
                                  attention_mask=mask, eos_token_id=-1)
    if tuple(logits.shape) != (T5_BATCH, T5_DEC, 32128) \
            or not torch.isfinite(logits).all() \
            or not torch.isfinite(scores).all():
        raise AssertionError('t5-v1_1: non-finite logits or scores')
    launches = dict(K.LAUNCHES)
    del model
    small = _t5_model(_t5_depth(T5Config.t5_v1_1_base(dropout_rate=0.0),
                                T5_CHECK_LAYERS), 'float32', 2205).eval()
    cpu = _on_cpu_copy(small).eval()
    r = f32_like_cpu('t5-v1_1 logits', small, cpu,
                     dict(input_ids=ids[:2, :128],
                          decoder_input_ids=dec[:2, :16]))
    log(f'[t5-v1_1] t5_v1_1_base bf16 (gated-gelu, untied head): forward '
        f'[8, {T5_DEC}, 32128] finite, greedy {tuple(toks.shape)}; at '
        f'{T5_CHECK_LAYERS} + {T5_CHECK_LAYERS} layers f32 the logits\' '
        + _f64_note(r))
    del small, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return {'launches': launches}


def t5_export() -> dict:
    """`jit.save` of T5-large's `T5Model` eval forward at 2 + 2 layers,
    bf16, with a dynamic batch (InputSpec [None, T5_ENC] and [None,
    T5_DEC]), into the gitignored build/t5_export/ (removed after), then
    `jit.load` without the class. Gates: the program holds the RMSNorm
    and flash export ops; at batch 4 (the export's example is 2) its
    decoder and encoder states equal the eager forward's bit for bit, and
    its run launches the RMSNorm kernel 2 x 2 + 3 x 2 + 2 times and the
    D = 64 flash forward twice (the decoder's cross-attention). Logs the
    save and load seconds and the files' sizes."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nlp import T5Config, T5Model
    from paddle_tpu_torch.ops import kernels as K
    cfg = _t5_depth(T5Config.t5_large(dropout_rate=0.0), T5_CHECK_LAYERS)
    model = _t5_model(cfg, 'bfloat16', 2206, cls=T5Model).eval()
    T5_EXPORT_ROOT.mkdir(parents=True, exist_ok=True)
    path = str(T5_EXPORT_ROOT / 't5_large_2x2')
    t0 = time.perf_counter()
    jit.save(model, path, input_spec=[jit.InputSpec([None, T5_ENC], 'int64'),
                                      jit.InputSpec([None, T5_DEC], 'int64')])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = jit.load(path)
    load_s = time.perf_counter() - t0
    sizes = {ext: os.path.getsize(path + ext) for ext in
             ('.pdmodel.pt2', '.pdiparams.npz', '.pdmodel.json')}
    ops = [str(n.target) for n in loaded._program.graph.nodes
           if n.op == 'call_function']
    held = {op: ops.count(f'paddle_tpu_torch.{op}.default')
            for op in ('rms_norm_fwd', 'flash_attention_fwd')}
    gen = torch.Generator(device=DEV).manual_seed(6)
    ids = torch.randint(2, cfg.vocab_size, (4, T5_ENC), device=DEV,
                        generator=gen)
    dec = torch.randint(2, cfg.vocab_size, (4, T5_DEC), device=DEV,
                        generator=gen)
    K.reset_launch_counts()
    got = loaded(ids, dec)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    with torch.no_grad():
        want = model(ids, dec)
    norms = 2 * cfg.num_layers + 3 * cfg.num_decoder_layers + 2
    if held != {'rms_norm_fwd': norms,
                'flash_attention_fwd': cfg.num_decoder_layers}:
        raise AssertionError(f't5-export: the program holds {held}')
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError('t5-export: the loaded program differs from '
                             'the eager forward')
    if launches['rms_norm'] != norms or \
            launches['flash_attention_fwd_d64'] != cfg.num_decoder_layers:
        raise AssertionError(f't5-export: the loaded program launched '
                             f'{ {k: n for k, n in launches.items() if n} }')
    log(f'[t5-export] T5Model (T5-large width, {cfg.num_layers} + '
        f'{cfg.num_decoder_layers} layers, bf16) saved in {save_s:.2f} s '
        f'(files {sizes} bytes: the program holds no weights) and loaded '
        f'without its class in {load_s:.2f} s; at batch 4 its states equal '
        f'the eager forward bit for bit; it launched rms_norm '
        f'{launches["rms_norm"]} and flash_attention_fwd_d64 '
        f'{launches["flash_attention_fwd_d64"]} times')
    shutil.rmtree(T5_EXPORT_ROOT)
    del model, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return {'launches': launches, 'save_s': save_s, 'load_s': load_s}


def t5_phase() -> tuple:
    """Phase 11: the tokenizer (`t5_tokenize`), the f32 gates
    (`t5_checks`), T5-large served (`t5_serve`) and trained (`t5_train`),
    t5_v1_1_base (`t5_v1_1`) and the exported program (`t5_export`).
    Returns ({name: result} with each run's launch counts (the checks'
    aside), the tokenized prompts for `t5_profile`)."""
    t0 = time.perf_counter()
    prep = t5_tokenize()
    t5_checks(prep)
    out = {'t5-serve': t5_serve(prep), 't5-train': t5_train(),
           't5-v1_1': t5_v1_1(prep), 't5-export': t5_export()}
    log(f'[t5] phase 11 took {time.perf_counter() - t0:.1f} s')
    return out, prep


def t5_profile(prep) -> None:
    """Phase 7's T5 windows: torch.profiler over a greedy generate of 4
    tokens of prep's prompts on T5-large (bf16) and over a training step
    of `t5_train`'s setup (after one unprofiled step), each broken down
    by kernel group with the device's idle share (`_breakdown`)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import T5Config
    ids = torch.from_numpy(prep['ids']).to(DEV)
    mask = torch.from_numpy(prep['mask']).to(DEV)
    model = _t5_model(T5Config.t5_large(dropout_rate=0.0), 'bfloat16',
                      2201).eval()
    model.generate(ids, max_new_tokens=2, attention_mask=mask,
                   eos_token_id=-1)                       # warm-up
    prof = marked_window(lambda: model.generate(
        ids, max_new_tokens=4, attention_mask=mask, eos_token_id=-1))
    _breakdown([(prof, None)], prof.event_ms / 1e3,
               't5-serve greedy generate, 4 tokens')
    del model
    cfg = T5Config.t5_large(dropout_rate=0.0, use_recompute=True)
    model = _t5_model(cfg, 'bfloat16', 2203)
    step = TrainStep(model, t5_loss(cfg.vocab_size), bench_optimizer(model))
    rng = np.random.RandomState(23)
    src = rng.randint(2, cfg.vocab_size, (T5_BATCH, T5_ENC))
    tgt = rng.randint(2, cfg.vocab_size, (T5_BATCH, T5_DEC))
    dec = np.concatenate([np.zeros((T5_BATCH, 1), np.int64), tgt[:, :-1]], 1)
    step((src, dec), tgt)                                 # warm-up
    prof = marked_window(lambda: step((src, dec), tgt))
    _breakdown([(prof, None)], prof.event_ms / 1e3, 't5-train step')
    del step, model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12 (part): RMSNorm at the redesign's shapes
# ---------------------------------------------------------------------------

# the shapes the RMSNorm kernel is measured at: decode's 8 rows, prefill
# and training rows at widths 4096 and 2048, T5-large's [4096, 1024]
RMS_SHAPES = tuple((dt, r, w) for dt in (torch.bfloat16, torch.float16)
                   for r, w in ((8, 4096), (1024, 4096), (2048, 4096),
                                (4096, 4096), (8192, 2048), (4096, 1024))) \
    + ((torch.float32, 8, 4096), (torch.float32, 1024, 4096))
RMS_EPS = 1e-6


def _rms_inputs(dtype, rows: int, width: int, gen) -> tuple:
    x = _randn((rows, width), dtype, gen)
    w = (1 + 0.1 * torch.randn(width, generator=gen, device=DEV)).to(dtype)
    return x, w


def rms_cases() -> list:
    """RMSNorm at every shape of RMS_SHAPES (the bf16 decode shape reports
    the kernel table's `rms_norm_decode` row), and on the one-element
    path: a width that is not a multiple of the 16-byte vector, and a
    view 2 or 4 bytes past an aligned buffer."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(12)
    cases, add = _case_list()

    def one(x, w, tag, rep=False):
        width = x.shape[-1]
        add('rms_norm' + _fp16_key(x.dtype), f'rms_norm {tag}', x.dtype,
            lambda x=x, w=w: K.rms_norm(x, w, RMS_EPS),
            lambda x=x, w=w: K.rms_norm_reference(x, w, RMS_EPS),
            lambda x=x, w=w: F.rms_norm(x, (width,), w, RMS_EPS),
            nbytes(x, x, w), 4 * x.numel(), rep=rep, row='rms_norm_decode')

    for dtype, r, width in RMS_SHAPES:
        x, w = _rms_inputs(dtype, r, width, gen)
        one(x, w, f'{str(dtype)[6:]} rows={r} width={width}',
            rep=dtype == torch.bfloat16 and r == 8)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for r in (8, 1024):
            x, w = _rms_inputs(dtype, r, 4100, gen)
            one(x, w, f'{str(dtype)[6:]} rows={r} width=4100 (not a '
                f'multiple of the vector)')
            buf = _randn((r * 4096 + 1,), dtype, gen)
            one(buf[1:].view(r, 4096), w[:4096].contiguous(),
                f'{str(dtype)[6:]} rows={r} width=4096, x a view one '
                f'element past an aligned buffer')
    return cases


def old_rms_kernel(tree: str):
    """fn(x, w, eps) over the RMSNorm kernel of the port in the checkout
    TREE, built by nvcc with the port's flags from that tree's
    `csrc/rms_norm.cu` alone into build/rms_ms/ (its C entry as it stood
    before the redesign: x, w, out, rows, width, eps, dtype, stream)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import kernels as K
    src = Path(tree).resolve() / 'paddle_tpu_torch' / 'csrc' / 'rms_norm.cu'
    out_dir = _build.BUILD_ROOT.parent / 'rms_ms'
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / 'librms_norm_tree.so'
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f'{src}: {proc.stdout}{proc.stderr}')
    fn = ctypes.CDLL(str(lib)).rms_norm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]

    def run(x, w, eps):
        y = torch.empty_like(x)
        rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                x.numel() // x.shape[-1], x.shape[-1], eps,
                K._DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f'{tree}: rms_norm_fwd returned CUDA error {rc}')
        return y
    return run


def _rms_timing_inputs(gen):
    """(tag, x, w) at each of RMS_SHAPES, then on the one-element path:
    width 4100 (not a multiple of the vector) and an x one element past
    an aligned buffer, bf16 at 8 and 1024 rows and f32 at 1024."""
    for dtype, r, width in RMS_SHAPES:
        x, w = _rms_inputs(dtype, r, width, gen)
        yield f'{str(dtype)[6:]} [{r}, {width}]', x, w
    for dtype, r in ((torch.bfloat16, 8), (torch.bfloat16, 1024),
                     (torch.float32, 1024)):
        x, w = _rms_inputs(dtype, r, 4100, gen)
        yield f'{str(dtype)[6:]} [{r}, 4100]', x, w
        buf = _randn((r * 4096 + 1,), dtype, gen)
        yield (f'{str(dtype)[6:]} [{r}, 4096] unaligned',
               buf[1:].view(r, 4096), w[:4096].contiguous())


def rms_ms(tree: str) -> list:
    """At each of `_rms_timing_inputs`: both kernels held to the plain
    version, then the bound, the kernel of the port in TREE ("old"), this
    tree's ("new"), `F.rms_norm` and the plain version, in device ms per
    call (`timed`: warm, the inputs in L2 from the call before), the two
    kernels in turns old, new, new, old; then old, new and `F.rms_norm`
    again with L2 flushed before each call (`queued_ms(before=)`: cold,
    x and w read from device memory). Returns one dict a shape."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    old = old_rms_kernel(tree)
    gen = torch.Generator(device=DEV).manual_seed(12)
    # written before each cold call: more than the H100's 50 MB of L2
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    one = torch.zeros(1, device=DEV)
    gap = queued_ms(lambda: one.add_(1), before=flush.zero_)
    log(f'[rms-ms] L2 flushed, events around each call: a one-element add '
        f'reads ' + ('not measured' if gap is None else f'{gap:.4f} ms')
        + ' (the launch gap inside each cold reading)')
    out = []
    for tag, x, w in _rms_timing_inputs(gen):
        width = x.shape[-1]
        want = K.rms_norm_reference(x, w, RMS_EPS)
        compare(f'rms_norm new {tag}', K.rms_norm(x, w, RMS_EPS), want)
        compare(f'rms_norm old {tag}', old(x, w, RMS_EPS), want)
        new_fn = lambda x=x, w=w: K.rms_norm(x, w, RMS_EPS)
        old_fn = lambda x=x, w=w: old(x, w, RMS_EPS)
        lib_fn = lambda x=x, w=w: F.rms_norm(x, (width,), w, RMS_EPS)
        o1, n1, n2, o2 = (timed(f)[0] for f in (old_fn, new_fn, new_fn,
                                                 old_fn))
        lib = timed(lib_fn)[0]
        plain = timed(lambda x=x, w=w: K.rms_norm_reference(x, w,
                                                            RMS_EPS))[0]
        cold = {k: queued_ms(f, before=flush.zero_) for k, f in
                (('old', old_fn), ('new', new_fn), ('lib', lib_fn))}
        bound, _ = bound_ms(nbytes(x, x, w), 4 * x.numel(), x.dtype)
        new, prev = (n1 + n2) / 2, (o1 + o2) / 2

        def ms(v):
            return 'not measured' if v is None else f'{v:.4f}'
        log(f'[rms-ms] {tag}: bound {bound:.4f}  old {o1:.4f} {o2:.4f}  new '
            f'{n1:.4f} {n2:.4f}  F.rms_norm {lib:.4f}  plain {plain:.4f} ms;'
            f' new/bound {bound / new:.3f}, new/old {new / prev:.3f}, '
            f'new/F.rms_norm {new / lib:.3f}; L2 flushed: old '
            f'{ms(cold["old"])}  new {ms(cold["new"])}  F.rms_norm '
            f'{ms(cold["lib"])} ms' + (
                '' if cold['new'] is None else
                f', new/bound {bound / cold["new"]:.3f}'))
        out.append(dict(shape=tag, bound=bound, old=prev, new=new, lib=lib,
                        plain=plain, cold=cold))
    return out


# ---------------------------------------------------------------------------
# phase 12: the vision slice (ResNet-50 at full width, the zoo, the vision
# ops, an LSTM) and its kernel cases
# ---------------------------------------------------------------------------

VISION_F32_BATCH = 4
VISION_BATCH = 64
VISION_SIZE = 224
# the LSTM: input, hidden, steps, batch
VISION_LSTM = (256, 512, 128, 32)
VISION_WARMUP, VISION_STEPS = 2, 5
VISION_LR = 0.1           # the f32 step's: updates well above rounding
VISION_TRAIN_LR = 0.01    # bf16 training: 7 steps on random labels
# card vs CPU in f32, TF32 off: logits and every update by rel_norm, the
# loss relative, BN running statistics by rel_norm; the zoo and the ops
VISION_LOGITS_TOL, VISION_LOSS_TOL = 1e-4, 1e-5
VISION_BN_TOL, VISION_UPDATE_TOL, VISION_ZOO_TOL = 1e-4, 1e-4, 1e-4
VISION_F64_SLACK = 4.0     # card's update vs float64, x the CPU's own
VISION_OPS_TOL = 1e-4
VISION_KERNELS = ('softmax_ce_fwd', 'softmax_ce_bwd')
# one constructor of each family, at its input size
ZOO = (('resnext50_32x4d', 224), ('wide_resnet50_2', 224), ('vgg16', 224),
       ('mobilenet_v1', 224), ('mobilenet_v2', 224),
       ('mobilenet_v3_large', 224), ('shufflenet_v2_x1_0', 224),
       ('squeezenet1_1', 224), ('densenet121', 224), ('googlenet', 224),
       ('inception_v3', 299), ('alexnet', 224))


def vision_cases() -> list:
    """Phase 2's kernel cases at this slice's shapes: CE forward and
    backward over a classifier's 1000 classes (f32 and bf16, 64 and 256
    rows, with ignored rows, and with a mean loss's g = 1 / N on every
    row; f32 [64, 1000] at g = 1/64 is ResNet-50's step under O1 and
    reports the `_v1000` rows), then RMSNorm at RMS_SHAPES."""
    gen = torch.Generator(device=DEV).manual_seed(23)
    cases, add = _case_list()
    for dtype in (torch.float32, torch.bfloat16):
        for n in (64, 256):
            _ce_case(add, gen, dtype, n, 1000, row_suffix='_v1000')
            _ce_case(add, gen, dtype, n, 1000, g_value=1.0 / n,
                     rep=dtype == torch.float32 and n == 64,
                     row_suffix='_v1000')
    return cases + rms_cases()


def conv_linear_flops(model, shape) -> float:
    """Forward FLOPs of one batch of `shape` through `model`'s
    convolutions and linear layers, from their shapes: 2 * Cin / groups
    * Cout * kh * kw * Ho * Wo per image a convolution, 2 * in * out a
    linear row (forward hooks read each output's shape on one forward of
    zeros, batch 1, scaled to the batch)."""
    from paddle_tpu_torch import nn
    total = [0.0]

    def conv(mod, inputs, out):
        total[0] += (2.0 * mod.in_channels / mod.groups * mod.out_channels
                     * math.prod(mod.kernel_size) * math.prod(out.shape[2:]))

    def linear(mod, inputs, out):
        total[0] += 2.0 * mod.in_features * mod.out_features \
            * (out.numel() // out.shape[-1])
    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, nn.conv._ConvNd) and not m._transpose]
    hooks += [m.register_forward_hook(linear) for m in model.modules()
              if isinstance(m, nn.Linear)]
    was_training = model.training
    model.eval()
    dev = next(model.parameters()).device
    try:
        with torch.no_grad():
            model(torch.zeros((1,) + tuple(shape[1:]), device=dev))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return total[0] * shape[0]


def _resnet_step(model, x, y, dev) -> dict:
    """One training step (Momentum 0.9, weight decay 1e-4, BN in train
    mode) of `model` on the batch (x, y): logits, loss, every parameter's
    update and the buffers after the step, on the host."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import functional as PF
    model.train()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = optimizer.Momentum(learning_rate=VISION_LR, momentum=0.9,
                             parameters=model.parameters(),
                             weight_decay=1e-4)
    logits = model(torch.from_numpy(x).to(dev))
    loss = PF.cross_entropy(logits, torch.from_numpy(y).to(dev))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return {'logits': logits.detach().cpu(), 'loss': float(loss.detach()),
            'update': {k: (p.detach() - before[k]).cpu()
                       for k, p in model.named_parameters()},
            'buffers': {k: b.detach().cpu()
                        for k, b in model.named_buffers()}}


def vision_f32_step() -> dict:
    """resnet50 built on the CPU from a seed and copied to the card; one
    training step on each from the same weights and batch of 4, f32 (TF32
    off), and on a float64 CPU copy: logits, loss and BN running
    statistics held to the CPU's f32; every parameter's update held to
    float64, within VISION_F64_SLACK x the CPU's own f32 distance from it
    (at least VISION_UPDATE_TOL). f32 itself cannot hold an update to
    1e-4 here: the CPU's f32 step lies up to 2.4e-2 from float64 on the
    BatchNorm parameters of layers 1-3, whose gradients are sums of
    nearly cancelling terms over 4 x 56 x 56 positions."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import vision
    ptt.seed(23)
    cpu = vision.resnet50(device='cpu')
    card = copy.deepcopy(cpu).to(DEV)
    exact = copy.deepcopy(cpu).double()
    rng = np.random.default_rng(23)
    x = rng.standard_normal((VISION_F32_BATCH, 3, VISION_SIZE,
                             VISION_SIZE)).astype(np.float32)
    y = rng.integers(0, 1000, VISION_F32_BATCH)
    got = _resnet_step(card, x, y, DEV)
    want = _resnet_step(cpu, x, y, 'cpu')
    f64 = _resnet_step(exact, x.astype(np.float64), y, 'cpu')
    upd = {k: (readings(got['update'][k], want['update'][k])['rel_norm'],
               readings(got['update'][k], f64['update'][k])['rel_norm'],
               readings(want['update'][k], f64['update'][k])['rel_norm'])
           for k in want['update']}
    over = [k for k, (_, card64, cpu64) in upd.items()
            if card64 > max(VISION_UPDATE_TOL, VISION_F64_SLACK * cpu64)]
    r = {'logits': readings(got['logits'], want['logits'])['rel_norm'],
         'loss': abs(got['loss'] - want['loss']) / abs(want['loss']),
         'bn': max(readings(got['buffers'][k], want['buffers'][k])
                   ['rel_norm'] for k in want['buffers']
                   if want['buffers'][k].is_floating_point()),
         'update_vs_cpu': max(u[0] for u in upd.values()),
         'update_vs_f64': max(u[1] for u in upd.values()),
         'cpu_vs_f64': max(u[2] for u in upd.values()),
         'ratio': max(u[1] / max(u[2], 1e-30) for u in upd.values())}
    log(f'[vision] resnet50 f32 step, batch {VISION_F32_BATCH}, card vs CPU: '
        f'logits rel_norm {r["logits"]:.3e} (limit {VISION_LOGITS_TOL}), '
        f'loss {got["loss"]:.6f} vs {want["loss"]:.6f} rel {r["loss"]:.3e} '
        f'(limit {VISION_LOSS_TOL}), BN running stats worst rel_norm '
        f'{r["bn"]:.3e} (limit {VISION_BN_TOL}); updates over '
        f'{len(upd)} parameters, worst rel_norm card vs CPU '
        f'{r["update_vs_cpu"]:.3e}, card vs float64 {r["update_vs_f64"]:.3e},'
        f' CPU vs float64 {r["cpu_vs_f64"]:.3e}, worst card / CPU distance '
        f'from float64 {r["ratio"]:.2f} (limit {VISION_F64_SLACK}, floor '
        f'{VISION_UPDATE_TOL}); float64 loss {f64["loss"]:.6f}')
    if not (r['logits'] <= VISION_LOGITS_TOL and r['loss'] <= VISION_LOSS_TOL
            and r['bn'] <= VISION_BN_TOL and not over):
        raise AssertionError(f'vision: resnet50 f32 step past its limits: '
                             f'{r}; updates past: '
                             + ', '.join(f'{k} {upd[k]}' for k in over[:8]))
    return r


class _Images:
    """A seeded dataset: image i is base[i % len(base)], labels drawn from
    the same seed."""

    def __init__(self, n: int, base: np.ndarray, labels: np.ndarray):
        self.n, self.base, self.labels = n, base, labels

    def __getitem__(self, i):
        return self.base[i % len(self.base)], self.labels[i]

    def __len__(self):
        return self.n


def vision_train() -> dict:
    """resnet50 trained in bf16 (O1, f32 parameters) through
    `Model(...).prepare(Momentum, CrossEntropyLoss, Accuracy)` and `fit`
    over an `io.DataLoader` of seeded arrays: VISION_WARMUP steps, then
    VISION_STEPS timed; exactly one CE forward and one CE backward launch
    a step, no RMSNorm launch, a finite loss. Then the eval forward."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import amp, io, metric, nn, optimizer, vision
    from paddle_tpu_torch.hapi import Callback
    from paddle_tpu_torch.ops import kernels as K
    ptt.seed(24)
    net = vision.resnet50(device=DEV)
    fwd_flops = conv_linear_flops(net, (VISION_BATCH, 3, VISION_SIZE,
                                        VISION_SIZE))
    rng = np.random.default_rng(24)
    steps = VISION_WARMUP + VISION_STEPS
    base = rng.standard_normal((VISION_BATCH, 3, VISION_SIZE,
                                VISION_SIZE)).astype(np.float32)
    labels = rng.integers(0, 1000, steps * VISION_BATCH)
    loader = io.DataLoader(_Images(steps * VISION_BATCH, base, labels),
                           batch_size=VISION_BATCH, shuffle=False)

    class Steps(Callback):
        def __init__(self):
            super().__init__()
            self.t, self.launches, self.losses = [], [], []

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())
            self.launches.append({k: K.LAUNCHES[k] for k in
                                  VISION_KERNELS + ('rms_norm',)})
            self.losses.append(float((logs or {}).get('loss', math.nan)))

    model = ptt.Model(net)
    model.prepare(optimizer.Momentum(learning_rate=VISION_TRAIN_LR,
                                     momentum=0.9,
                                     parameters=net.parameters(),
                                     weight_decay=1e-4),
                  nn.CrossEntropyLoss(), metric.Accuracy(),
                  amp_configs={'level': 'O1', 'dtype': 'bfloat16'})
    timer = Steps()
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(loader, epochs=1, verbose=0, callbacks=[timer])
    launches = {k: K.LAUNCHES[k] for k in K.LAUNCHES if K.LAUNCHES[k]}
    peak = torch.cuda.max_memory_allocated()
    if len(timer.t) != steps:
        raise AssertionError(f'vision: fit ran {len(timer.t)} steps, not '
                             f'{steps}')
    step_s = (timer.t[-1] - timer.t[VISION_WARMUP - 1]) / VISION_STEPS
    per_step = [{k: b[k] - a[k] for k in a} for a, b in
                zip([{k: 0 for k in timer.launches[0]}] + timer.launches,
                    timer.launches)]
    step_flops = 3 * fwd_flops
    mfu = step_flops / step_s / PEAK_OPS_PER_S[torch.bfloat16]
    log(f'[vision] resnet50 bf16 O1 fit, batch {VISION_BATCH}, '
        f'{VISION_SIZE} x {VISION_SIZE}: '
        f'{VISION_WARMUP} warm-up steps ({timer.t[VISION_WARMUP - 1] - t0:.2f}'
        f' s), then {step_s * 1e3:.1f} ms/step, '
        f'{VISION_BATCH / step_s:.1f} images/s; {step_flops / 1e12:.3f} '
        f'TFLOP a step (3 x the forward by conv_linear_flops, '
        f'{fwd_flops / VISION_BATCH / 1e9:.3f} GFLOP an image), MFU '
        f'{mfu:.4f}; peak device memory {peak / 1e9:.2f} GB; losses '
        + ' '.join(f'{v:.4f}' for v in timer.losses)
        + f'; launches a step {per_step}')
    for i, d in enumerate(per_step):
        if d['softmax_ce_fwd'] != 1 or d['softmax_ce_bwd'] != 1 \
                or d['rms_norm'] != 0:
            raise AssertionError(f'vision: step {i} launched {d}; want one '
                                 f'CE forward, one CE backward, no RMSNorm')
    if not all(math.isfinite(v) for v in timer.losses):
        raise AssertionError(f'vision: non-finite loss {timer.losses}')

    # the eval forward, bf16, batch 64
    net.eval()
    xb = torch.from_numpy(base).to(DEV)

    def forward():
        with torch.no_grad(), amp.auto_cast(level='O1', dtype='bfloat16'):
            return net(xb)
    out = forward()
    if not bool(torch.isfinite(out).all()) or tuple(out.shape) != (
            VISION_BATCH, 1000):
        raise AssertionError(f'vision: eval forward gave {tuple(out.shape)}'
                             f' or non-finite logits')
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(VISION_STEPS):
        forward()
    torch.cuda.synchronize()
    eval_s = (time.perf_counter() - t1) / VISION_STEPS
    log(f'[vision] resnet50 bf16 eval forward, batch {VISION_BATCH}: '
        f'{eval_s * 1e3:.1f} ms, {VISION_BATCH / eval_s:.1f} images/s')
    return {'launches': launches, 'step_ms': step_s * 1e3,
            'images_s': VISION_BATCH / step_s, 'mfu': mfu,
            'peak_gb': peak / 1e9, 'eval_images_s': VISION_BATCH / eval_s,
            'step_tflop': step_flops / 1e12}


def vision_zoo() -> dict:
    """One eval forward at batch 1, f32 (TF32 off), of one constructor of
    each family on the card against its CPU copy from the same weights:
    every output within VISION_ZOO_TOL by rel_norm."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import vision
    out = {}
    for i, (name, size) in enumerate(ZOO):
        ptt.seed(100 + i)
        cpu = getattr(vision, name)(device='cpu').eval()
        card = copy.deepcopy(cpu).to(DEV).eval()
        x = np.random.default_rng(i).standard_normal(
            (1, 3, size, size)).astype(np.float32)
        with torch.no_grad():
            want = cpu(torch.from_numpy(x))
            got = card(torch.from_numpy(x).to(DEV))
        pairs = list(zip(got, want)) if isinstance(want, tuple) \
            else [(got, want)]
        worst = max(readings(g.cpu(), w)['rel_norm'] for g, w in pairs)
        finite = all(bool(torch.isfinite(g).all()) for g, _ in pairs)
        log(f'[vision] zoo {name} ({size} x {size}, '
            f'{sum(p.numel() for p in cpu.parameters()) / 1e6:.1f} M '
            f'parameters): card vs CPU rel_norm {worst:.3e} over '
            f'{len(pairs)} output(s)')
        if worst > VISION_ZOO_TOL or not finite:
            raise AssertionError(f'vision: {name} card vs CPU rel_norm '
                                 f'{worst:.3e} (limit {VISION_ZOO_TOL}), '
                                 f'finite {finite}')
        out[name] = worst
        del cpu, card
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _card_vs_cpu(label: str, got, want, tol: float = VISION_OPS_TOL):
    r = readings(got.detach().cpu(), want.detach())['rel_norm']
    if r > tol:
        raise AssertionError(f'vision: {label} card vs CPU rel_norm {r:.3e}'
                             f' (limit {tol})')
    return r


def vision_ops() -> dict:
    """`vision.ops` and a recurrent layer on the card against the CPU:
    nms over 2000 boxes (equal kept indices; plain and by category with a
    score threshold and top_k), roi_align and roi_pool over a [2, 256, 50,
    50] map and 128 boxes, deform_conv2d at 3 x 3, 64 -> 64 channels with
    a mask, and a 2-layer bidirectional LSTM (input 256, hidden 512, 128
    steps, batch 32, with sequence_length) forward and backward; each
    timed on the card."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision import ops as V
    rng = np.random.default_rng(31)
    res = {}
    xy = rng.uniform(0, 480, (2000, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 96, (2000, 2))],
                           1).astype(np.float32)
    scores = rng.uniform(0, 1, 2000).astype(np.float32)
    cats = rng.integers(0, 10, 2000)
    for tag, kw in (('plain', {}), ('by category', {
            'score_threshold': 0.3, 'top_k': 300,
            'category_idxs': cats})):
        def call(dev, kw=kw):
            args = {k: torch.from_numpy(v).to(dev)
                    if isinstance(v, np.ndarray) else v
                    for k, v in kw.items()}
            return V.nms(torch.from_numpy(boxes).to(dev),
                         torch.from_numpy(scores).to(dev), 0.5, **args)
        got, want = call(DEV), call('cpu')
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f'vision: nms {tag}: card keeps '
                                 f'{got.numel()} boxes, CPU {want.numel()}')
        res[f'nms {tag} ms'] = _wall(lambda: call(DEV))[1] * 1e3
        log(f'[vision] nms {tag}, 2000 boxes: {got.numel()} kept, equal to '
            f'the CPU; {res[f"nms {tag} ms"]:.2f} ms')
    feat = rng.standard_normal((2, 256, 50, 50)).astype(np.float32)
    xy = rng.uniform(0, 600, (128, 2))
    rois = np.concatenate([xy, xy + rng.uniform(16, 200, (128, 2))],
                          1).astype(np.float32)
    num = np.array([64, 64], np.int32)
    for name, fn in (('roi_align', lambda f, r, n: V.roi_align(
            f, r, n, 7, spatial_scale=1 / 16, sampling_ratio=2)),
                     ('roi_pool', lambda f, r, n: V.roi_pool(
                         f, r, n, 7, spatial_scale=1 / 16))):
        def call(dev, fn=fn):
            return fn(*(torch.from_numpy(a).to(dev)
                        for a in (feat, rois, num)))
        r = _card_vs_cpu(name, call(DEV), call('cpu'))
        ms = time_ms(lambda: call(DEV), iters=10)
        log(f'[vision] {name}, [2, 256, 50, 50], 128 boxes, 7 x 7: card vs '
            f'CPU rel_norm {r:.3e}; {ms:.3f} ms')
        res[name] = (r, ms)
    x = rng.standard_normal((2, 64, 32, 32)).astype(np.float32)
    off = rng.standard_normal((2, 18, 32, 32)).astype(np.float32)
    mask = 1 / (1 + np.exp(-rng.standard_normal((2, 9, 32, 32)))).astype(
        np.float32)
    w = (rng.standard_normal((64, 64, 3, 3)) / 24).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)

    def deform(dev):
        return V.deform_conv2d(*(torch.from_numpy(a).to(dev)
                                 for a in (x, off, w, b)), padding=1,
                               mask=torch.from_numpy(mask).to(dev))
    r = _card_vs_cpu('deform_conv2d', deform(DEV), deform('cpu'))
    ms = time_ms(lambda: deform(DEV), iters=10)
    log(f'[vision] deform_conv2d 3 x 3, 64 -> 64, [2, 64, 32, 32], with a '
        f'mask: card vs CPU rel_norm {r:.3e}; {ms:.3f} ms')
    res['deform_conv2d'] = (r, ms)

    n_in, hidden, n_steps, batch = VISION_LSTM
    ptt.seed(32)
    cpu = nn.LSTM(n_in, hidden, num_layers=2, direction='bidirect',
                  device='cpu')
    card = copy.deepcopy(cpu).to(DEV)
    xs = rng.standard_normal((batch, n_steps, n_in)).astype(np.float32)
    lens = rng.integers(n_steps // 2, n_steps + 1, batch)
    cot = rng.standard_normal((batch, n_steps, 2 * hidden)).astype(
        np.float32)

    def lstm(model, dev):
        xt = torch.from_numpy(xs).to(dev).requires_grad_()
        out, (h, c) = model(xt, sequence_length=torch.from_numpy(lens).to(
            dev))
        (out * torch.from_numpy(cot).to(dev)).sum().backward()
        return out, h, c, xt.grad, model.weight_ih_l0.grad
    got, want = lstm(card, DEV), lstm(cpu, 'cpu')
    r = max(_card_vs_cpu(f'lstm {n}', g, w_) for n, g, w_ in zip(
        ('output', 'h', 'c', 'dx', 'dW_ih_l0'), got, want))
    card.zero_grad()

    def fwd_bwd():
        lstm(card, DEV)
        card.zero_grad()
    ms = _wall(fwd_bwd)[1] * 1e3
    log(f'[vision] LSTM 2 layers, bidirectional, {n_in} -> {hidden}, '
        f'{n_steps} steps, batch {batch}, sequence_length '
        f'{int(lens.min())}..{int(lens.max())}: '
        f'card vs CPU worst rel_norm {r:.3e} (output, h, c, dx, dW); '
        f'forward + backward {ms:.1f} ms')
    res['lstm'] = (r, ms)
    return res


def vision_phase() -> dict:
    """Phase 12: the f32 step card vs CPU, bf16 training and the eval
    forward, the zoo, the vision ops and the LSTM; logs its seconds and
    returns each part's readings (the training run's launches under
    'train')."""
    t0 = time.perf_counter()
    f32 = vision_f32_step()
    train = vision_train()
    zoo = vision_zoo()
    ops_res = vision_ops()
    log(f'[vision] phase 12 took {time.perf_counter() - t0:.1f} s')
    return {'train': train, 'f32': f32, 'zoo': zoo, 'ops': ops_res}


# ---------------------------------------------------------------------------
# phase 13: the native host pieces
# ---------------------------------------------------------------------------

HOST_ROOT = Path(__file__).resolve().parent / 'build' / 'host_phase'
HOST_BUDGET_S = 30.0
HOST_LAYERS = 2             # Llama-2-7B width, 2 of 32 layers: ~1.3 GB bf16
HOST_BATCHES, HOST_BATCH = 4, 64


def _gbps(nbytes: int, seconds: float) -> str:
    return f'{seconds:.3f} s ({nbytes / seconds / 1e9:.2f} GB/s)'


def host_checkpoints(state: dict) -> None:
    """`save_sharded` / `load_sharded` of `state` (bf16 tensors on the
    card) under the gitignored build/, loaded back onto the card
    bit-equal, timed beside `save` / `load` (npz) of the same state; then
    one `CheckpointManager(backend='native')` save and restore. The files
    are deleted after."""
    from paddle_tpu_torch import serialization as ser
    from paddle_tpu_torch.utils import CheckpointManager, ckpt_native
    if not ckpt_native.available():
        raise AssertionError('host: the native checkpoint sharder did not '
                             'build')
    size = nbytes(*state.values())
    shutil.rmtree(HOST_ROOT, ignore_errors=True)
    HOST_ROOT.mkdir(parents=True)
    try:
        walls = {}
        for label, save, load, path in (
                ('sharded', ser.save_sharded, ser.load_sharded,
                 HOST_ROOT / 'sharded'),
                ('npz', ser.save, ser.load, HOST_ROOT / 'state.npz')):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(state, str(path))
            t1 = time.perf_counter()
            back = load(str(path), device=DEV)
            torch.cuda.synchronize()
            walls[label] = (t1 - t0, time.perf_counter() - t1)
            bad = [k for k, v in state.items()
                   if back[k].device != v.device or back[k].dtype !=
                   v.dtype or not torch.equal(back[k], v)]
            if bad:
                raise AssertionError(f'host: {label} load is not bit-equal '
                                     f'on the card: {bad[:4]}')
            del back
        log(f'[host] {len(state)} bf16 tensors, {size / 1e9:.3f} GB, loaded '
            f'back onto the card bit-equal; sharded save '
            f'{_gbps(size, walls["sharded"][0])}, load '
            f'{_gbps(size, walls["sharded"][1])}; npz save '
            f'{_gbps(size, walls["npz"][0])}, load '
            f'{_gbps(size, walls["npz"][1])} (page cache warm)')
        mgr = CheckpointManager(str(HOST_ROOT / 'mgr'), backend='native')
        small = {k: state[k] for k in list(state)[:4]}
        mgr.save(1, {'params': small, 'step': 1})
        tree = mgr.restore()
        if tree['step'] != 1 or not all(
                torch.equal(torch.as_tensor(tree['params'][k]).to(DEV), v)
                for k, v in small.items()):
            raise AssertionError('host: CheckpointManager(backend=native) '
                                 'restored another tree')
        log(f'[host] CheckpointManager(backend=\'native\'): step 1 saved '
            f'and restored ({mgr.backend}, {len(small)} tensors)')
    finally:
        shutil.rmtree(HOST_ROOT, ignore_errors=True)


class _HostImages:
    """HOST_BATCHES x HOST_BATCH uint8 images [3, 224, 224] with int64
    labels, made from a seed (a `paddle.io` map-style dataset)."""

    def __init__(self, n: int):
        rng = np.random.RandomState(13)
        self.x = rng.randint(0, 256, (n, 3, 224, 224), dtype=np.uint8)
        self.y = rng.randint(0, 1000, (n,)).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def host_collator() -> None:
    """A `DataLoader(num_workers=2)` over HOST_BATCHES batches of
    HOST_BATCH images: the native collator serves it (no
    `io.native_collator` suppression counted) and its batches equal a
    `num_workers=0` loader's; batches/s of both."""
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.io import native
    if not native.available():
        raise AssertionError('host: the native staging runtime did not '
                             'build')
    was = obs.enabled()
    obs.enable()
    reg = obs.get_registry()
    site = dict(site='io.native_collator')
    before = reg.value('paddle_suppressed_errors_total', **site)
    data = _HostImages(HOST_BATCHES * HOST_BATCH)
    batches, rates = {}, {}
    for workers in (2, 0):
        loader = pio.DataLoader(data, batch_size=HOST_BATCH,
                                num_workers=workers)
        if workers and loader._native is None:
            raise AssertionError('host: the loader did not take the native '
                                 'collator')
        t0 = time.perf_counter()
        batches[workers] = list(loader)
        rates[workers] = len(batches[workers]) / (time.perf_counter() - t0)
        del loader
    if reg.value('paddle_suppressed_errors_total', **site) != before:
        raise AssertionError('host: the native collator failed to start '
                             '(io.native_collator counted)')
    if not was:
        obs.disable()
    for (xa, ya), (xb, yb) in zip(batches[2], batches[0]):
        if not (torch.equal(xa, xb) and torch.equal(ya, yb)):
            raise AssertionError('host: native and Python batches differ')
    log(f'[host] DataLoader over {HOST_BATCHES} batches of {HOST_BATCH} x '
        f'3 x 224 x 224 uint8 + int64 labels: native collator (2 workers) '
        f'{rates[2]:.1f} batches/s, Python (0 workers) {rates[0]:.1f} '
        f'batches/s, equal batches')


def host_lazy(cfg) -> None:
    """A Llama-2-7B-width model of HOST_LAYERS layers built under
    `LazyGuard` allocates nothing; `initialize()` of every parameter
    raises the allocated bytes by exactly what the eager model's build
    did; one forward then launches the RMSNorm and flash kernels."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    eager = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(7, DEV))
    torch.cuda.synchronize()
    eager_bytes = torch.cuda.memory_allocated() - m0
    del eager
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    with ptt.LazyGuard():
        lazy = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                                generator=ptt.generator(7, DEV))
    built = torch.cuda.memory_allocated() - m0
    if built != 0 or any(p.device.type != 'meta'
                         for p in lazy.parameters()):
        raise AssertionError(f'host: the model built under LazyGuard '
                             f'allocated {built} bytes')
    for p in lazy.parameters():
        p.initialize()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - m0
    if grown != eager_bytes:
        raise AssertionError(f'host: initialize() allocated {grown} bytes, '
                             f'the eager model {eager_bytes}')
    K.reset_launch_counts()
    ids = torch.randint(3, cfg.vocab_size, (2, 128),
                        generator=torch.Generator().manual_seed(3)).to(DEV)
    with torch.no_grad():
        logits = lazy(ids)
    torch.cuda.synchronize()
    logits = logits[0] if isinstance(logits, tuple) else logits
    if not torch.isfinite(logits.float()).all():
        raise AssertionError('host: the initialized model gave non-finite '
                             'logits')
    missing = [k for k in ('rms_norm', 'flash_attention_fwd')
               if K.LAUNCHES[k] <= 0]
    if missing:
        raise AssertionError(f'host: the forward launched no {missing}')
    log(f'[host] LazyGuard: {cfg.num_hidden_layers}-layer Llama-2-7B-width '
        f'model built with 0 bytes allocated; initialize() allocated '
        f'{grown / 1e9:.3f} GB = the eager build; one forward launched '
        f'rms_norm {K.LAUNCHES["rms_norm"]}, flash '
        f'{K.LAUNCHES["flash_attention_fwd"]} times')


def host_phase(cfg) -> dict:
    """Phase 13: sharded checkpoints, the native collator and LazyGuard
    (`host_checkpoints`, `host_collator`, `host_lazy`), in at most
    HOST_BUDGET_S seconds. The state checkpointed is a
    Llama-2-7B-width HOST_LAYERS-layer model's bf16 parameters."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    t0 = time.perf_counter()
    small = draft_config(cfg, HOST_LAYERS)
    model = LlamaForCausalLM(small, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(5, DEV))
    state = {k: v.detach() for k, v in model.state_dict().items()}
    host_checkpoints(state)
    del model, state
    host_collator()
    host_lazy(small)
    seconds = time.perf_counter() - t0
    log(f'[host] phase 13 took {seconds:.1f} s (budget '
        f'{HOST_BUDGET_S:.0f} s)')
    if seconds > HOST_BUDGET_S:
        raise AssertionError(f'host: phase 13 took {seconds:.1f} s, over '
                             f'its {HOST_BUDGET_S:.0f} s budget')
    gc.collect()
    torch.cuda.empty_cache()
    return {'seconds': seconds}


# phase 14: the public API packages on the card; its budget, the shapes
# (Llama-2-7B's layer width, BERT-base's attention, GPT-2 small whole),
# and the bound on PTQ's first-step logits (relative RMSE of int8
# weight-only against the float model: per-channel absmax rounding moves
# each weight by up to 1/254 of its column's largest)
API_BUDGET_S = 45.0
API_SEQ = 1024
API_PTQ_RMSE = 0.05
API_QAT_STEPS = 3
API_TRACE_ROOT = Path(__file__).resolve().parent / 'build' / 'api_trace'


def _launched(before: dict) -> dict:
    from paddle_tpu_torch.ops import kernels as K
    return {k: n - before.get(k, 0) for k, n in K.LAUNCHES.items()
            if n != before.get(k, 0)}


def _require_launches(tag: str, got: dict, want: dict) -> None:
    """Each of `want`'s keys launched exactly as often in `got`."""
    bad = {k: got.get(k, 0) for k, n in want.items() if got.get(k, 0) != n}
    if bad:
        raise AssertionError(f'{tag}: launches {got}, want {want}')


def _mha_eager(x, qkv_w, lin_w):
    """fused_multi_head_attention's chain (post-LN, no biases) written out
    of the port's ops: the eager twin the fused entry must equal."""
    from paddle_tpu_torch.nn import functional as PF
    qkv = torch.einsum('bse,tnhe->tbsnh', x, qkv_w)
    attn = PF.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
    out = x + attn.reshape(x.shape[0], x.shape[1], -1) @ lin_w
    return PF.layer_norm(out, out.shape[-1])


def api_layer_width(gen) -> dict:
    """Llama-2-7B's layer width (4096, 32 heads x 128), bf16, 1024
    tokens: fused_rms_norm == F.rms_norm (the RMSNorm kernel, held to its
    plain version too); fused_multi_head_attention forward and backward
    == its eager twin (the flash forward, dq and dk/dv kernels, each
    launched once by each); a static program (fc -> F.rms_norm -> causal
    attention) replayed by the Executor == the eager calls, launching
    RMSNorm and the flash forward once a replay."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops import kernels as K
    bf = torch.bfloat16
    launches = collections.Counter()
    x = _randn((1, API_SEQ, 4096), bf, gen)
    w = (1 + 0.1 * torch.randn(4096, generator=gen, device=DEV)).to(bf)
    before = dict(K.LAUNCHES)
    got = IF.fused_rms_norm(x, w, epsilon=1e-6)
    _require_launches('api fused_rms_norm', _launched(before),
                      {'rms_norm': 1})
    if not torch.equal(got, PF.rms_norm(x, w, epsilon=1e-6)):
        raise AssertionError('api: fused_rms_norm != F.rms_norm')
    compare('api fused_rms_norm', got, K.rms_norm_reference(x, w, 1e-6))
    launches.update(_launched(before))
    qkv_w = (_randn((3, 32, 128, 4096), torch.float32, gen) * 0.02).to(bf)
    lin_w = (_randn((4096, 4096), torch.float32, gen) * 0.02).to(bf)
    outs, grads = [], []
    for fused in (True, False):
        xs = x.detach().clone().requires_grad_(True)
        before = dict(K.LAUNCHES)
        out = (IF.fused_multi_head_attention(xs, qkv_w, lin_w)
               if fused else _mha_eager(xs, qkv_w, lin_w))
        out.float().square().mean().backward()
        _require_launches(f'api fused_multi_head_attention (fused {fused})',
                          _launched(before),
                          {'flash_attention_fwd': 1,
                           'flash_attention_bwd_dq': 1,
                           'flash_attention_bwd_dkv': 1})
        launches.update(_launched(before))
        outs.append(out.detach())
        grads.append(xs.grad)
    if not (torch.equal(*outs) and torch.equal(*grads)):
        raise AssertionError('api: fused_multi_head_attention != its eager '
                             'twin')
    log(f'[api] Llama-2-7B layer width, bf16, {API_SEQ} tokens: '
        f'fused_rms_norm == F.rms_norm; fused_multi_head_attention forward '
        f'and backward == its eager twin, bit for bit')
    ptt.set_device('gpu')
    ptt.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            xd = static.data('x', [None, API_SEQ, 4096], 'bfloat16')
            lin = ptt.nn.Linear(4096, 4096, dtype='bfloat16',
                                generator=ptt.generator(3, DEV))
            h = PF.rms_norm(lin(xd), w)
            q = ptt.reshape(h, [-1, API_SEQ, 32, 128])
            y = PF.scaled_dot_product_attention(q, q, q, is_causal=True)
        feed = np.random.default_rng(0).standard_normal(
            (2, API_SEQ, 4096)).astype(np.float32)
        exe = static.Executor()
        before = dict(K.LAUNCHES)
        out, = exe.run(main, feed={'x': feed}, fetch_list=[y],
                       return_numpy=False)
        _require_launches('api static replay', _launched(before),
                          {'rms_norm': 1, 'flash_attention_fwd': 1})
        launches.update(_launched(before))
    finally:
        ptt.disable_static()
    xe = torch.from_numpy(feed).to(DEV).to(bf)
    he = PF.rms_norm(lin(xe), w).reshape(-1, API_SEQ, 32, 128)
    want = PF.scaled_dot_product_attention(he, he, he, is_causal=True)
    if not torch.equal(out.value, want):
        raise AssertionError('api: the static program\'s replay != eager')
    log(f'[api] static program (fc -> F.rms_norm -> causal attention, '
        f'{len(main._ops)} ops recorded) replayed at batch 2 == eager, bit '
        f'for bit; the replay launched RMSNorm and the flash forward once')
    return {'launches': launches, 'program': (exe, main, feed, y)}


def api_bert_attention(gen) -> dict:
    """BERT-base's attention (B 8, S 512, 12 heads x 64, bf16):
    memory_efficient_attention == F.scaled_dot_product_attention (the D =
    64 flash forward, once each), held to the plain version."""
    from paddle_tpu_torch.incubate import nn as inn
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops import kernels as K
    q, k, v = (_randn((BERT_BATCH, BERT_SEQ, GPT2_HEADS, 64), torch.bfloat16,
                      gen) for _ in range(3))
    before = dict(K.LAUNCHES)
    got = inn.memory_efficient_attention(q, k, v)
    want = PF.scaled_dot_product_attention(q, k, v)
    launched = _launched(before)
    _require_launches('api memory_efficient_attention', launched,
                      {'flash_attention_fwd_d64': 2})
    if not torch.equal(got, want):
        raise AssertionError('api: memory_efficient_attention != SDPA')
    r = compare('api memory_efficient_attention', got,
                K.attention_reference(q, k, v))
    log(f'[api] BERT-base attention: memory_efficient_attention == F.sdpa, '
        f'rel_norm {r["rel_norm"]:.3e} of the plain version')
    return {'launches': collections.Counter(launched)}


def api_quantization(gen) -> dict:
    """GPT-2 small at full width (bf16): PTQ weight-only (every Linear ->
    QuantedLinear), a greedy generate() of 32 tokens from two prompts
    (finite scores, tokens in range), the first-step logits within
    API_PTQ_RMSE of the float model's; then API_QAT_STEPS AdamW steps of
    the QAT model on one batch through the CE kernels: finite, falling
    loss; QAT.convert gives QuantedLinears."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops import kernels as K
    # dropout off, so that the attention trains on the flash kernels (as
    # phase 9 trains)
    cfg = GPTConfig.gpt2_small(hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device=DEV, dtype='bfloat16',
                           generator=ptt.generator(12, DEV)).eval()
    qm = Q.PTQ().quantize(model)
    n_q = sum(isinstance(m, Q.QuantedLinear) for m in qm.modules())
    floats = sum(p.nbytes for n, p in model.named_parameters()
                 if n.endswith('weight') and p.dim() == 2
                 and 'embeddings' not in n)
    rng = np.random.RandomState(4)
    prompts = torch.tensor(rng.randint(3, cfg.vocab_size, (2, 48)),
                           device=DEV)
    before = dict(K.LAUNCHES)
    with torch.inference_mode():
        toks, scores = qm.generate(prompts, max_new_tokens=32,
                                   eos_token_id=-1)
        lq = qm(prompts)[:, -1].float()
        lf = model(prompts)[:, -1].float()
    launches = collections.Counter(_launched(before))
    if toks.shape != (2, 32) or not bool(torch.isfinite(scores).all()) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f'api PTQ: generate gave {toks.shape} '
                             f'{scores}')
    err = rel_rmse(lq, lf)
    log(f'[api] GPT-2 small PTQ weight-only: {n_q} QuantedLinears, '
        f'{Q.quanted_state_bytes(qm) / 1e6:.1f} MB of int8 weights and '
        f'scales for {floats / 1e6:.1f} MB of bf16 ones; greedy generate() '
        f'of 32 tokens x 2; first-step logits relative RMSE against the '
        f'float model {err:.4f} (limit {API_PTQ_RMSE})')
    if n_q != 4 * cfg.num_hidden_layers or err > API_PTQ_RMSE:
        raise AssertionError(f'api PTQ: {n_q} layers, RMSE {err}')
    del qm
    qat = Q.QAT()
    tm = qat.quantize(model.train())
    opt = ptt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=tm.parameters())
    ids = torch.tensor(rng.randint(3, cfg.vocab_size, (4, 256)),
                       device=DEV)
    losses = []
    before = dict(K.LAUNCHES)
    for _ in range(API_QAT_STEPS):
        logits = tm(ids[:, :-1])
        loss = PF.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                ids[:, 1:].reshape(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    launched = _launched(before)
    launches.update(launched)
    _require_launches('api QAT', {k: min(n, 1) for k, n in launched.items()},
                      {'softmax_ce_fwd': 1, 'softmax_ce_bwd': 1,
                       'flash_attention_fwd_d64': 1,
                       'flash_attention_bwd_dq_d64': 1,
                       'flash_attention_bwd_dkv_d64': 1})
    converted = qat.convert(tm)
    n_c = sum(isinstance(m, Q.QuantedLinear) for m in converted.modules())
    log(f'[api] GPT-2 small QAT: {API_QAT_STEPS} AdamW steps on one batch of '
        f'4 x 256, losses {[round(v, 4) for v in losses]}; convert -> {n_c} '
        f'QuantedLinears')
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
            and n_c == n_q):
        raise AssertionError(f'api QAT: losses {losses}, {n_c} layers')
    return {'launches': launches}


def api_numeric(gen) -> None:
    """device.cuda's memory figures == torch.cuda's; fft, stft and
    sparse.matmul on the card against the same calls on the CPU."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import fft, signal, sparse
    d = ptt.device.cuda
    torch.cuda.synchronize()
    figures = {name: (getattr(d, name)(), getattr(torch.cuda, name)())
               for name in ('memory_allocated', 'max_memory_allocated',
                            'memory_reserved', 'max_memory_reserved')}
    figures['device_memory_limit'] = (
        d.device_memory_limit(),
        torch.cuda.get_device_properties(0).total_memory)
    figures['device_count'] = (d.device_count(), torch.cuda.device_count())
    if any(a != b for a, b in figures.values()):
        raise AssertionError(f'api device figures {figures}')
    x = torch.randn(64, 4096, generator=gen, device=DEV) + 1j * torch.randn(
        64, 4096, generator=gen, device=DEV)
    sig = torch.randn(4, 16000, generator=gen, device=DEV)
    win = torch.hann_window(512, device=DEV)
    dense = torch.randn(4096, 64, generator=gen, device=DEV)
    keep = torch.rand(4096, 4096, generator=gen, device=DEV) < 0.01
    idx = keep.nonzero().t()
    vals = torch.randn(idx.shape[1], generator=gen, device=DEV)
    coo = sparse.sparse_coo_tensor(idx, vals, [4096, 4096])
    coo_cpu = sparse.sparse_coo_tensor(idx.cpu(), vals.cpu(), [4096, 4096])
    for label, got, want in (
            ('fft', fft.fft(x), fft.fft(x.cpu())),
            ('rfft2', fft.rfft2(x.real), fft.rfft2(x.real.cpu())),
            ('stft', signal.stft(sig, 512, window=win),
             signal.stft(sig.cpu(), 512, window=win.cpu())),
            ('sparse.matmul', sparse.matmul(coo, dense),
             sparse.matmul(coo_cpu, dense.cpu()))):
        g, w = (getattr(t, 'value', t) for t in (got, want))
        if g.is_complex():
            g, w = torch.view_as_real(g), torch.view_as_real(w)
        err = float((g.cpu().double() - w.double()).norm()
                    / w.double().norm())
        log(f'[api] {label} on the card vs the CPU: relative error '
            f'{err:.3e}')
        if err > 1e-5:
            raise AssertionError(f'api {label}: {err}')
    log(f'[api] device.cuda figures == torch.cuda\'s: '
        + ', '.join(f'{k} {a}' for k, (a, _) in figures.items()))


API_TRACE_KERNELS = ('rms_norm_kernel', 'flash_fwd_wgmma_kernel')


def api_profile(calls, tries: int = PROFILE_TRIES) -> None:
    """Phase 14's profiler: a `profiler.Profiler(trace_dir=)` window over
    `calls` (run three times in a host region, after a host pause and a
    GPU sleep: CUPTI has lost the first kernels of a window), whose Chrome
    trace must name the host region and API_TRACE_KERNELS; up to `tries`
    windows, each after a longer pause (a process that has profiled
    before can lose a window's first kernels, phase 7)."""
    from paddle_tpu_torch import profiler
    for attempt in range(1, tries + 1):
        shutil.rmtree(API_TRACE_ROOT, ignore_errors=True)
        time.sleep(PROFILE_PAUSE_S * (attempt - 1))
        torch.cuda.synchronize()
        with profiler.Profiler(trace_dir=str(API_TRACE_ROOT)) as prof:
            time.sleep(0.05)
            torch.cuda._sleep(1000)
            with profiler.RecordEvent('api_phase_window'):
                for _ in range(3):
                    calls()
                torch.cuda.synchronize()
        trace = Path(prof.trace_path)
        names = ' '.join(e.get('name', '') for e in json.loads(
            trace.read_text())['traceEvents'])
        missing = [k for k in ('api_phase_window',) + API_TRACE_KERNELS
                   if k not in names]
        log(f'[api] profiler window {attempt} of {tries}: Chrome trace '
            f'{trace} ({trace.stat().st_size / 1e6:.2f} MB) '
            + (f'lacks {missing}' if missing else
               'names the host region and the kernels'))
        if not missing:
            return
    raise AssertionError(f'api profiler: the trace lacks {missing}')


def api_trace_calls(gen):
    """The calls phase 14's profiler window runs: incubate's fused RMSNorm
    and causal attention (the RMSNorm and flash forward kernels)."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as PF
    x = _randn((8, 4096), torch.bfloat16, gen)
    w = torch.ones(4096, dtype=torch.bfloat16, device=DEV)
    q = _randn((1, 512, 32, 128), torch.bfloat16, gen)

    def calls():
        IF.fused_rms_norm(x, w)
        PF.scaled_dot_product_attention(q, q, q, is_causal=True)
    return calls


def api_phase() -> dict:
    """Phase 14: the public API packages that compute on the card
    (`api_layer_width`, `api_bert_attention`, `api_quantization`,
    `api_numeric`), then the profiler: a window over the fused entries
    and a replay of the static program (`api_profile`), its Chrome trace
    required to name the RMSNorm and flash forward kernels and the host
    region; where every window of this process misses one, the same
    window in a fresh process (`--api-profile`). Runs last (a process
    that has profiled launches slower). Fails past API_BUDGET_S."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(14)
    launches = collections.Counter()
    width = api_layer_width(gen)
    for run in (width, api_bert_attention(gen), api_quantization(gen)):
        launches.update(run['launches'])
    api_numeric(gen)
    exe, main, feed, y = width['program']
    fused = api_trace_calls(gen)

    def calls():
        fused()
        exe.run(main, feed={'x': feed}, fetch_list=[y], return_numpy=False)
    try:
        api_profile(calls)
    except AssertionError as e:
        log(f'[api] {e}; the same window in a fresh process')
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), '--api-profile'],
            capture_output=True, text=True, timeout=FRESH_PROFILE_TIMEOUT_S)
        for line in child.stdout.splitlines():
            log(f'[fresh] {line}')
        if child.returncode != 0:
            raise AssertionError(f'api profiler: the fresh process exited '
                                 f'{child.returncode}: '
                                 f'{child.stderr[-2000:]}') from e
    dt = time.perf_counter() - t0
    log(f'[api] phase 14 took {dt:.1f} s (budget {API_BUDGET_S:.0f} s); '
        f'launches {json.dumps(dict(sorted(launches.items())))}')
    if dt > API_BUDGET_S:
        raise AssertionError(f'phase 14 took {dt:.1f} s, over its budget')
    return {'launches': dict(launches)}


# phase 15 (tail): the long-tail packages on the card at full width, in
# at most TAIL_BUDGET_S. Audio: ESC-50's published clip format (5 s,
# mono, 44.1 kHz); the mel power held to the CPU's by relative norm
# (cuFFT and the CPU's FFT sum in another order, about 1e-7 of the
# norm), log-mel by dB (10 log10 turns a relative error e into 4.3 e dB):
# TAIL_DB_ATOL for every band within TAIL_DB_RANGE of the batch's peak
# power, TAIL_DB_DEEP_ATOL below it (an fp32 FFT's error is relative to
# the frame's energy: a band 70 dB below the peak reads 1.3e-3 dB from a
# float64 reference on the card, 5.4e-4 on the CPU), and MFCC by
# TAIL_DB_ATOL times sqrt(n_mels) (the orthonormal DCT moves a
# coefficient by at most the norm of the bands' errors). Viterbi:
# Conll05st's 9 tags plus BOS and EOS. Distributions: 1e6 draws of every
# family from a CUDA generator, the sample mean and variance within
# TAIL_SE standard errors of the family's own.
TAIL_BUDGET_S = 30.0
TAIL_CLIPS, TAIL_SR, TAIL_SECONDS = 64, 44100, 5.0
TAIL_FEATURES = dict(sr=TAIL_SR, n_fft=2048, hop_length=512, n_mels=128)
TAIL_MFCC = 40
TAIL_MEL_RTOL = 1e-5
TAIL_DB_ATOL = 1e-3
TAIL_DB_RANGE = 60.0
TAIL_DB_DEEP_ATOL = 1e-2
TAIL_VITERBI = (64, 256, 11)          # B, L, T
TAIL_DRAWS = 1_000_000
TAIL_SE = 5.0
TAIL_RTOL = 1e-5
TAIL_SEED = 15


def _tail_close(label: str, got, want, rtol: float = TAIL_RTOL) -> float:
    """|got - want| <= rtol * max(|want|max, 1) elementwise (the CPU
    tests' tolerance); returns the largest |got - want|."""
    g = getattr(got, 'value', got).detach().cpu().double()
    w = getattr(want, 'value', want).detach().cpu().double()
    if g.shape != w.shape:
        raise AssertionError(f'{label}: shape {tuple(g.shape)} vs '
                             f'{tuple(w.shape)}')
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not err <= rtol * max(float(w.abs().max()), 1.0):
        raise AssertionError(f'{label}: card vs CPU max abs err {err}')
    return err


def tail_audio(smi: str) -> dict:
    """LogMelSpectrogram and MFCC over 64 ESC-50-format clips on the card
    == the same layers on the CPU; ms a batch and clips/s."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.audio import datasets, features
    clips = torch.from_numpy(datasets._SyntheticAudio(
        TAIL_CLIPS, 50, TAIL_SR, TAIL_SECONDS, seed=TAIL_SEED).waveforms)
    x = clips.to(DEV)
    logmel = features.LogMelSpectrogram(**TAIL_FEATURES)
    mfcc = features.MFCC(n_mfcc=TAIL_MFCC, **TAIL_FEATURES)
    with ptt.device_guard('cpu'):
        logmel_c = features.LogMelSpectrogram(**TAIL_FEATURES)
        mfcc_c = features.MFCC(n_mfcc=TAIL_MFCC, **TAIL_FEATURES)
    out = {}
    with torch.no_grad():
        mel, mel_c = logmel._melspectrogram(x), logmel_c._melspectrogram(
            clips)
        frames = 1 + clips.shape[1] // TAIL_FEATURES['hop_length']
        if tuple(mel.shape) != (TAIL_CLIPS, TAIL_FEATURES['n_mels'],
                                frames) or not bool(mel.isfinite().all()):
            raise AssertionError(f'tail mel: shape {tuple(mel.shape)}')
        diff = (mel.cpu().double() - mel_c.double()).norm()
        out['mel_rel_norm'] = float(diff / mel_c.double().norm())
        db, db_c = logmel(x), logmel_c(clips)
        err = (db.cpu() - db_c).abs()
        deep = db_c < db_c.max() - TAIL_DB_RANGE
        out['db_max_abs'] = float(err[~deep].max())
        out['db_deep_max_abs'] = float(err[deep].max()) if bool(
            deep.any()) else 0.0
        out['db_deep_count'] = int(deep.sum())
        mf, mf_c = mfcc(x), mfcc_c(clips)
        out['mfcc_max_abs'] = float((mf.cpu() - mf_c).abs().max())
        mfcc_atol = TAIL_DB_ATOL * math.sqrt(TAIL_FEATURES['n_mels'])
        if not (out['mel_rel_norm'] <= TAIL_MEL_RTOL
                and out['db_max_abs'] <= TAIL_DB_ATOL
                and out['db_deep_max_abs'] <= TAIL_DB_DEEP_ATOL
                and out['mfcc_max_abs'] <= mfcc_atol
                and tuple(mf.shape) == (TAIL_CLIPS, TAIL_MFCC, frames)):
            raise AssertionError(f'tail audio card vs CPU: {out}')
        for name, layer in (('logmel', logmel), ('mfcc', mfcc)):
            ms = time_ms(lambda: layer(x), iters=5, warmup=1)
            out[f'{name}_ms'] = ms
            out[f'{name}_clips_s'] = TAIL_CLIPS / (ms / 1e3)
    log(f'[tail] audio: {TAIL_CLIPS} clips x {clips.shape[1]} samples '
        f'(5 s at 44.1 kHz), n_fft 2048, hop 512, 128 mels: mel power card '
        f'vs CPU rel norm {out["mel_rel_norm"]:.3e} (limit '
        f'{TAIL_MEL_RTOL:g}), log-mel max {out["db_max_abs"]:.3e} dB '
        f'within {TAIL_DB_RANGE:g} dB of the peak (limit '
        f'{TAIL_DB_ATOL:g}), {out["db_deep_max_abs"]:.3e} dB on the '
        f'{out["db_deep_count"]} bands below (limit {TAIL_DB_DEEP_ATOL:g}), '
        f'MFCC-40 max {out["mfcc_max_abs"]:.3e} '
        f'dB; LogMelSpectrogram {out["logmel_ms"]:.3f} ms a batch, '
        f'{out["logmel_clips_s"]:.1f} clips/s; MFCC {out["mfcc_ms"]:.3f} '
        f'ms a batch, {out["mfcc_clips_s"]:.1f} clips/s ({smi})')
    return out


def tail_text(smi: str) -> dict:
    """viterbi_decode at B = 64, L = 256, T = 11 on the card == the CPU
    (paths exactly, scores rel 1e-5); ms a batch."""
    from paddle_tpu_torch.text import viterbi_decode
    b, length, tags = TAIL_VITERBI
    rng = np.random.default_rng(TAIL_SEED)
    pot = torch.from_numpy(rng.standard_normal((b, length, tags)).astype(
        np.float32))
    trans = torch.from_numpy(rng.standard_normal((tags, tags)).astype(
        np.float32))
    lens = torch.from_numpy(rng.integers(1, length + 1, b))
    args = (pot.to(DEV), trans.to(DEV), lens.to(DEV))
    scores, paths = viterbi_decode(*args)
    scores_c, paths_c = viterbi_decode(pot, trans, lens)
    if paths.dtype != torch.int64 or not torch.equal(paths.cpu(), paths_c):
        raise AssertionError('tail viterbi: card paths differ from the CPU')
    err = _tail_close('tail viterbi scores', scores, scores_c)
    ms = time_ms(lambda: viterbi_decode(*args), iters=5, warmup=1)
    log(f'[tail] viterbi B {b} L {length} T {tags} (lengths 1..{length}): '
        f'paths == CPU, scores max abs err {err:.3e}; {ms:.3f} ms a batch '
        f'(a host loop of {length} steps: launch-bound) ({smi})')
    return {'viterbi_ms': ms}


def _tail_families(D, t) -> list:
    """(name, distribution) of every family, parameters from `t`."""
    loc, scale = t([-0.5, 0.0, 1.5]), t([0.4, 1.0, 2.2])
    alpha, beta = t([0.7, 1.5, 3.0]), t([1.2, 0.8, 2.5])
    rate, prob = t([0.5, 1.3, 4.0]), t([0.2, 0.5, 0.8])
    cov = t([[2.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 0.5]])
    return [
        ('Normal', D.Normal(loc, scale)),
        ('Uniform', D.Uniform(loc, t([0.0, 1.0, 3.7]))),
        ('Categorical', D.Categorical(t([[0.1, 0.5, -1.0],
                                         [2.0, 0.0, 0.3]]))),
        # not p = 0.5, where a Bernoulli's sample variance is a function
        # of its sample mean at its stationary point (no standard error)
        ('Bernoulli', D.Bernoulli(t([0.2, 0.35, 0.8]))),
        ('Beta', D.Beta(alpha, beta)),
        ('Dirichlet', D.Dirichlet(alpha)),
        ('Gamma', D.Gamma(alpha, rate)),
        ('Exponential', D.Exponential(rate)),
        ('Geometric', D.Geometric(prob)),
        ('Gumbel', D.Gumbel(loc, scale)),
        ('Laplace', D.Laplace(loc, scale)),
        ('LogNormal', D.LogNormal(loc, t([0.4, 0.5, 0.3]))),
        ('Multinomial', D.Multinomial(6, t([0.2, 0.3, 0.5]))),
        ('Poisson', D.Poisson(rate)),
        ('StudentT', D.StudentT(t([5.0, 10.0, 30.0]), loc, scale)),
        ('Binomial', D.Binomial(t([5.0, 10.0, 20.0]), prob)),
        ('Cauchy', D.Cauchy(loc, scale)),
        ('Chi2', D.Chi2(t([3.0, 5.0, 10.0]))),
        ('ContinuousBernoulli', D.ContinuousBernoulli(t([0.2, 0.4995,
                                                         0.8]))),
        ('MultivariateNormal', D.MultivariateNormal(
            loc, covariance_matrix=cov)),
        ('LKJCholesky', D.LKJCholesky(3, t(2.0))),
    ]


def _tail_moments(name: str, dist, s: torch.Tensor) -> float:
    """The largest deviation of the draws' statistics from the family's,
    in standard errors."""
    s = s.double()
    n = s.shape[0]
    if name == 'Categorical':
        p = torch.softmax(dist.logits.value.double(), -1)
        freq = torch.nn.functional.one_hot(s.long(), p.shape[-1]).double(
        ).mean(0)
        return float(((freq - p).abs() / (p * (1 - p) / n).sqrt()).max())
    if name == 'Cauchy':
        med = s.median(0).values
        se = math.pi * dist.scale.value.double() / (2 * math.sqrt(n))
        return float(((med - dist.loc.value.double()).abs() / se).max())
    if name == 'LKJCholesky':
        off = (s @ s.transpose(-1, -2))[:, 1, 0]
        eta = float(dist.concentration.value)
        var = 1.0 / (2 * (eta - 1 + 1.5) + 1)     # LKJ's marginal, d = 3
        return float(off.mean().abs() / math.sqrt(var / n))
    mean, var = s.mean(0), s.var(0)
    m4 = ((s - mean) ** 4).mean(0)
    se_var = ((m4 - var ** 2 * (n - 3) / (n - 1)) / n).sqrt()
    dev_mean = (mean - dist.mean.value.double()).abs() / (var / n).sqrt()
    dev_var = (var - dist.variance.value.double()).abs() / se_var
    return float(torch.maximum(dev_mean, dev_var).max())


def tail_distribution(smi: str) -> dict:
    """Every family: 1e6 draws on the card from a CUDA generator, their
    mean and variance within TAIL_SE standard errors of the family's,
    one seed's draws bit-equal twice; log_prob (at the first 4096 draws)
    and entropy on the card == the CPU; Gamma's rsample gradient on the
    card == the CPU's implicit gradient at the same draws."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import distribution as D

    def on(device):
        return lambda v: ptt.to_tensor(np.asarray(v, np.float32),
                                       place=device)
    card = _tail_families(D, on('gpu'))
    cpu = _tail_families(D, on('cpu'))
    worst, worst_name, names = 0.0, '', []
    for (name, d), (_, dc) in zip(card, cpu):
        s = d.sample((TAIL_DRAWS,), seed=TAIL_SEED)
        if s.value.device.type != 'cuda' or not bool(
                s.value.isfinite().all()):
            raise AssertionError(f'tail {name}: draws on {s.value.device}')
        if not torch.equal(s.value, d.sample((TAIL_DRAWS,),
                                             seed=TAIL_SEED).value):
            raise AssertionError(f'tail {name}: one seed, two draws')
        dev = _tail_moments(name, d, s.value)
        if not dev <= TAIL_SE:
            raise AssertionError(f'tail {name}: statistics {dev:.2f} '
                                 f'standard errors off')
        if dev > worst:
            worst, worst_name = dev, name
        # a Categorical's value has exactly the batch shape
        head = s.value[0] if name == 'Categorical' else s.value[:4096]
        _tail_close(f'tail {name} log_prob', d.log_prob(head),
                    dc.log_prob(head.cpu()))
        if name not in ('Multinomial', 'LKJCholesky'):
            _tail_close(f'tail {name} entropy', d.entropy(), dc.entropy())
        names.append(name)
    a = ptt.to_tensor(np.linspace(0.3, 4.0, 4096, dtype=np.float32))
    b = ptt.to_tensor(np.linspace(0.5, 2.0, 4096, dtype=np.float32))
    a.stop_gradient = False
    s = D.Gamma(a, b).rsample(seed=TAIL_SEED)
    (g,) = ptt.grad(s.sum(), [a])
    raw = (s.value * b.value).detach().cpu()
    want = torch._standard_gamma_grad(a.value.detach().cpu(), raw) \
        / b.value.cpu()
    err = _tail_close('tail Gamma rsample gradient', g, want)
    log(f'[tail] distribution: {len(names)} families x {TAIL_DRAWS} draws '
        f'on the card, statistics within {worst:.2f} standard errors '
        f'({worst_name}; limit {TAIL_SE:g}), seeds bit-equal, log_prob and '
        f'entropy == CPU (rel {TAIL_RTOL:g}), Gamma rsample gradient max '
        f'abs err '
        f'{err:.3e} ({smi})')
    return {'families': names, 'worst_se': worst}


def tail_phase() -> dict:
    """Phase 15: audio, text and distribution on the card (`tail_audio`,
    `tail_text`, `tail_distribution`). Fails past TAIL_BUDGET_S."""
    t0 = time.perf_counter()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {**tail_audio(smi), **tail_text(smi), **tail_distribution(smi)}
    dt = time.perf_counter() - t0
    log(f'[tail] phase 15 took {dt:.1f} s (budget {TAIL_BUDGET_S:.0f} s)')
    if dt > TAIL_BUDGET_S:
        raise AssertionError(f'phase 15 took {dt:.1f} s, over its budget')
    out['seconds'] = dt
    return out


def release(*runs) -> None:
    """Drop the engines and train steps that the phases' results hold on
    the card (and the eager twins'), keeping their numbers."""
    for run in runs:
        for key in ('engine', 'step'):
            run.pop(key, None)
        if isinstance(run.get('eager'), dict):
            release(run['eager'])
    gc.collect()
    torch.cuda.empty_cache()


def build_seconds(layout: str, flags: tuple) -> float:
    """Build every kernel source from scratch into a fresh directory under
    build/, nvcc given `flags` beyond `_build.NVCC_FLAGS`, and log the
    seconds. `layout` 'split' builds the sources as shipped (the paged and
    adapter kernels one library per q or x dtype); 'single' builds each
    of those two as one source holding its three dtypes' instantiations
    (each entry renamed, so that the three can share one library)."""
    import shutil
    import tempfile
    from paddle_tpu_torch.ops import _build
    root = _build.BUILD_ROOT.parent
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        csrc = Path(tmp) / 'csrc'
        shutil.copytree(_build.CSRC, csrc)
        sources = _build.SOURCES
        if layout == 'single':
            for name, macro in (('paged_attention', 'PTT_PAGED_ATTENTION_FWD'),
                                ('adapter_matmul', 'PTT_ADAPTER_MATMUL_FWD')):
                body = [f'#include "{name}.cuh"']
                for t, code in (('float', 'PTT_F32'),
                                ('__nv_bfloat16', 'PTT_BF16'),
                                ('__half', 'PTT_F16')):
                    body += [f'#define {name}_fwd {name}_fwd_{code}',
                             f'{macro}({t}, {code})', f'#undef {name}_fwd']
                (csrc / f'{name}.cu').write_text('\n'.join(body) + '\n')
                sources = tuple(n for n in sources
                                if not n.startswith(name + '_')) + (name,)
        elif layout != 'split':
            raise ValueError(f'--build-s: layout {layout!r}')
        saved = _build.CSRC, _build.SOURCES, _build.BUILD_ROOT, \
            _build.NVCC_FLAGS
        _build.CSRC, _build.SOURCES = csrc, sources
        _build.BUILD_ROOT = Path(tmp) / 'build'
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + flags
        try:
            t0 = time.perf_counter()
            logs = _build.build_all()
            total = time.perf_counter() - t0
        finally:
            _build.CSRC, _build.SOURCES, _build.BUILD_ROOT, \
                _build.NVCC_FLAGS = saved
    log(f'[build-s] {layout} ({len(sources)} sources), extra nvcc flags '
        f'{list(flags)}: {total:.1f} s; ' + '; '.join(
            f'{n} {logs[n].strip().splitlines()[-1].split()[-2]} s'
            for n in sources))
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if sys.argv[1:2] == ['--hook-us']:
        # python3 chip_smoke.py --hook-us TREE: hook_host_us() of the port
        # in the checkout TREE (to set an earlier tree beside this one)
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        from paddle_tpu_torch.ops import _build
        _build.build_all()
        log(f'[host] {sys.argv[2]}: one adapted projection {hook_host_us():.2f}'
            f' us of host time per call')
        return 0
    if sys.argv[1:2] == ['--paged-ms']:
        # python3 chip_smoke.py --paged-ms TREE [OUT]: paged_float_ms() of
        # the port in TREE (to set an earlier tree beside this one); OUT
        # keeps its one-row outputs
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        from paddle_tpu_torch.ops import _build
        # the paged kernel's sources only (one, or one per dtype)
        _build.SOURCES = tuple(n for n in _build.SOURCES
                               if n.startswith('paged_attention'))
        _build.build_all()
        outputs = {} if len(sys.argv) > 3 else None
        log(f'[paged] {sys.argv[2]}: ' + '; '.join(
            f'{label}: ' + ' '.join('not measured' if ms is None else
                                    f'{ms:.4f}' for ms in times)
            for label, times in paged_float_ms(outputs=outputs))
            + ' ms per call')
        if outputs is not None:
            torch.save(outputs, sys.argv[3])
        return 0
    if sys.argv[1:2] == ['--rms-ms']:
        # python3 chip_smoke.py --rms-ms TREE: the RMSNorm kernel of the
        # port in the checkout TREE beside this tree's, at RMS_SHAPES
        from paddle_tpu_torch.ops import _build
        _build.SOURCES = ('rms_norm',)
        _build.build_all()
        for line in _build.build_log('rms_norm').splitlines():
            if 'registers' in line or 'spill' in line \
                    or 'entry function' in line:
                log(f'[build] rms_norm: {line.strip()}')
        check_kernels(rms_cases())
        rms_ms(sys.argv[2])
        return 0
    if sys.argv[1:2] == ['--build-s']:
        # python3 chip_smoke.py --build-s split|single [NVCC_FLAG ...]:
        # every kernel source built from scratch, timed (build_seconds)
        build_seconds(sys.argv[2], tuple(sys.argv[3:]))
        return 0
    if sys.argv[1:2] == ['--paged-bits']:
        # python3 chip_smoke.py --paged-bits A B: two --paged-ms outputs
        a, b = (torch.load(f) for f in sys.argv[2:4])
        for label in a:
            log(f'[paged] {label}: bit-equal {torch.equal(a[label], b[label])}')
        return 0
    if sys.argv[1:2] == ['--int8-rmse']:
        # python3 chip_smoke.py --int8-rmse: int8 KV's logit error by depth
        from paddle_tpu_torch.ops import _build
        _build.build_all()
        int8_rmse_by_depth()
        return 0
    if sys.argv[1:2] == ['--profile-train']:
        # python3 chip_smoke.py --profile-train pretrain|bench: phase 7's
        # training-step profile on a fresh rung of that recipe, in this
        # process (profile_train's fallback)
        from paddle_tpu_torch.ops import _build
        _build.build_all()
        step, batches = rung_step(sys.argv[2])
        step_s, _ = rung_step_s(step, batches)
        log(f'[profile] a fresh rung, {TRAIN_RECIPES[sys.argv[2]]}: '
            f'{step_s * 1e3:.1f} ms/step')
        profile_train(step, batches[0], step_s, sys.argv[2],
                      fresh_process=False)
        return 0
    if sys.argv[1:2] == ['--train-ms']:
        # python3 chip_smoke.py --train-ms TREE: the rung's step time of
        # the port in the checkout TREE
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.nlp import LlamaConfig
        _build.build_all()
        dt, peak = rung_step_s(*rung_step())
        flops = train_flops_per_step(
            LlamaConfig.llama2_7b(num_hidden_layers=8), TRAIN_BATCH,
            TRAIN_SEQ)
        log(f'[train] {sys.argv[2]}: {dt * 1e3:.1f} ms/step, MFU '
            f'{flops / dt / PEAK_OPS_PER_S[torch.bfloat16]:.4f}, peak device '
            f'memory {peak / 1e9:.2f} GB in all')
        return 0
    # fails outside the repo
    from paddle_tpu_torch.nlp import GPTConfig, LlamaConfig
    if sys.argv[1:2] == ['--train-rungs']:
        # python3 chip_smoke.py --train-rungs: phase 2's training kernels at
        # the rungs' shapes (checked and timed), phase 4, phase 5, then
        # phases 5c-5f alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        build()
        cases = rung_cases()
        check_kernels(cases)
        cfg = LlamaConfig.llama2_7b(num_hidden_layers=2)
        check_train_consistency(cfg)
        check_train_steps(cfg)
        check_offload_steps(cfg)
        trained = train(LlamaConfig.llama2_7b(num_hidden_layers=8,
                                              use_recompute=True))
        rest = rest_of_training(trained)
        release(trained)
        time_kernels(cases)
        log(f'[train-rungs] launches ' + json.dumps({
            k: sum(r['launches'].get(k, 0) for r in rest.values())
            for k in TRAIN_KERNELS}))
        log(f'[done] {time.perf_counter() - t0:.1f} s')
        return 0
    if sys.argv[1:2] == ['--eager']:
        # python3 chip_smoke.py --eager: phase 2's fp16 flash cases, the op
        # sweep and phase 5g alone, then the fp16 cases timed
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        build()
        fp16 = fp16_cases()
        check_kernels(fp16)
        op_sweep()
        eager = eager_dygraph(LlamaConfig.llama2_7b(num_hidden_layers=8,
                                                    use_recompute=True))
        time_kernels(fp16)
        log(f'[eager] launches {json.dumps(eager["launches"])}')
        log(f'[done] {time.perf_counter() - t0:.1f} s')
        return 0
    if sys.argv[1:2] == ['--gpt']:
        # python3 chip_smoke.py --gpt: phase 2's D = 64 cases, phase 3's
        # int8 check at GPT-2 width, then phase 9 alone, then the D = 64
        # cases timed
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        build()
        d64 = head64_cases()
        check_kernels(d64)
        check_int8_consistency(draft_config(GPTConfig.gpt2_small(), 2),
                               ' gpt2-width')
        gpt = gpt_family()
        time_kernels(d64)
        log('[gpt] launches ' + json.dumps(dict(sorted(
            _summed(*gpt.values()).items()))))
        log(f'[done] {time.perf_counter() - t0:.1f} s')
        return 0
    if sys.argv[1:2] == ['--fp16']:
        # python3 chip_smoke.py --fp16: phase 2's fp16 cases, then phase
        # 10 alone, then the fp16 cases timed
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        build()
        f16 = fp16_cases()
        check_kernels(f16)
        fp16 = fp16_phase()
        time_kernels(f16)
        log('[fp16] launches ' + json.dumps(dict(sorted(
            _summed(*fp16.values()).items()))))
        log(f'[done] {time.perf_counter() - t0:.1f} s')
        return 0
    if sys.argv[1:2] == ['--t5']:
        # python3 chip_smoke.py --t5: phase 2's T5 cases, then phase 11
        # alone, then the T5 cases timed
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        build()
        t5c = t5_cases()
        check_kernels(t5c)
        t5, prep = t5_phase()
        time_kernels(t5c)
        t5_profile(prep)
        log('[t5] launches ' + json.dumps(dict(sorted(
            _summed(*t5.values()).items()))))
        log(f'[done] {time.perf_counter() - t0:.1f} s')
        return 0
    if sys.argv[1:2] == ['--vision']:
        # python3 chip_smoke.py --vision: phase 12's kernel cases, then
        # phase 12 alone, then its cases timed
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        build()
        vc = vision_cases()
        check_kernels(vc)
        vis = vision_phase()
        time_kernels(vc)
        log('[vision] launches ' + json.dumps(vis['train']['launches']))
        log(f'[done] {time.perf_counter() - t0:.1f} s')
        return 0
    if sys.argv[1:2] == ['--kv-dtype']:
        # python3 chip_smoke.py --kv-dtype: phase 2's cases of the paged
        # kernel over a pool in another float dtype, phase 6, then phase
        # 6l alone, then those cases' reported rows timed
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        build()
        kvc = kv_dtype_cases()
        check_kernels(kvc)
        res = serve(LlamaConfig.llama2_7b())
        kvd = serve_kv_dtype(res)
        release(res)
        time_kernels([c for c in kvc if c['rep']])
        log('[kv-dtype] launches ' + json.dumps(
            _kv_dtype_launches(kvd['launches'])))
        log(f'[done] {time.perf_counter() - t0:.1f} s')
        return 0
    if sys.argv[1:2] == ['--api-profile']:
        # python3 chip_smoke.py --api-profile: phase 14's profiler window
        # in a process that has not profiled (api_phase's fallback)
        api_profile(api_trace_calls(
            torch.Generator(device=DEV).manual_seed(14)))
        return 0
    if sys.argv[1:2] == ['--api']:
        # python3 chip_smoke.py --api: phase 14 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        build()
        api_phase()
        log(f'[done] {time.perf_counter() - t0:.1f} s')
        return 0
    if sys.argv[1:2] == ['--tail']:
        # python3 chip_smoke.py --tail: phase 15 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        tail_phase()
        log(f'[done] {time.perf_counter() - t0:.1f} s')
        return 0
    if sys.argv[1:2] == ['--row']:
        # python3 chip_smoke.py --row: phases 6, 6e and 6b (the model, the
        # draft and the bank; 6e's self-draft arm on the cut model), then
        # phase 6k alone
        build()
        res = serve(LlamaConfig.llama2_7b())
        cut = serve(LlamaConfig.llama2_7b(num_hidden_layers=CUT_LAYERS),
                    'serve-cut')
        spec = serve_spec(res, cut)
        adapted = serve_adapters(res)
        row = serve_row(res, spec, adapted)
        log(f'[serve-row] launches {json.dumps(row["launches"])}')
        return 0
    if sys.argv[1:2] == ['--host']:
        # python3 chip_smoke.py --host: phase 13 alone
        build()
        host_phase(LlamaConfig.llama2_7b())
        return 0
    if sys.argv[1:2] == ['--procs']:
        # python3 chip_smoke.py --procs: phase 6j on phase 6's requests and
        # tokens, without the phases between
        build()
        res = serve(LlamaConfig.llama2_7b())
        release(res)
        log(f'[serve-procs] launches {serve_procs(res)["launches"]}')
        return 0
    # the flight recorder's bundles (a failed request in phase 3, ...) stay
    # inside the checkout's gitignored build directory
    FLIGHT_ROOT.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault('PADDLE_FLIGHT_DIR', str(FLIGHT_ROOT))
    log(f'[env] torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')
    # every comparison below runs fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('[env] TF32 off for matmul and cuDNN')
    t0 = time.perf_counter()

    def mark(label: str) -> None:
        """The seconds since t0 after a group of phases (the budget's
        breakdown)."""
        log(f'[time] {label}: {time.perf_counter() - t0:.1f} s')

    build()
    mark('build')
    cases = kernel_cases()
    check_kernels(cases)
    check_kernels(optimizer_cases())    # freed here, rebuilt for phase 8
    check_kernels(rung_cases())         # the same
    check_kernels(fp16_cases())         # the same
    check_kernels(head64_cases())       # the same
    check_kernels(t5_cases())           # the same
    check_kernels(vision_cases())       # the same
    check_kernels(kv_dtype_cases())     # the same
    torch.cuda.empty_cache()
    mark('phase 2')
    check_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_adapter_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_prefix_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_int8_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_int8_consistency(draft_config(GPTConfig.gpt2_small(), 2),
                           ' gpt2-width')
    check_spec_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_train_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_train_steps(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_offload_steps(LlamaConfig.llama2_7b(num_hidden_layers=2))
    mark('phases 3-4')
    rung = LlamaConfig.llama2_7b(num_hidden_layers=8, use_recompute=True)
    trained = train(rung)
    pretrained = pretrain(trained, rung)
    mark('phases 5-5b')
    rest = rest_of_training(trained)
    log(f'[eager] device memory held before phase 5g '
        f'{torch.cuda.memory_allocated() / 1e9:.2f} GB')
    eager = eager_dygraph(rung)
    mark('phases 5c-5g')
    # phase 11 runs before any profiling (later launches cost the host
    # more) and before phase 6 builds its engines
    t5, t5_prep = t5_phase()
    mark('phase 11')
    vis = vision_phase()
    mark('phase 12')
    res = serve(LlamaConfig.llama2_7b())
    kvd = serve_kv_dtype(res)
    cut = serve(LlamaConfig.llama2_7b(num_hidden_layers=CUT_LAYERS),
                'serve-cut')
    spec = serve_spec(res, cut)
    drain_swap(cut)
    adapted = serve_adapters(res)
    rowed = serve_row(res, spec, adapted)
    mark('phases 6, 6l, 6e, 6f, 6b, 6k')
    t6g = time.perf_counter()
    stored = serve_adapter_store(res, adapted)
    weights = weight_store_swap(res)
    log(f'[weight-store] phase 6g (both stores) took '
        f'{time.perf_counter() - t6g:.1f} s')
    t6h = time.perf_counter()
    observed = serve_observed(res)
    log(f'[observe] phase 6h took {time.perf_counter() - t6h:.1f} s')
    fleet = serve_fleet(res, adapted)
    mark('phases 6g-6i')
    prefixed = serve_prefix(cut)
    int8 = serve_int8(cut, prefixed)
    mark('phases 6c, 6d')
    log(f'[host] one adapted projection (hook + wrapper + launch, decode '
        f'shape): {hook_host_us():.2f} us of host time per call')
    profile_serve(res, adapted, prefixed)
    profile_int8(int8)
    release(res, cut, adapted, prefixed, prefixed['eager_prefill'], int8)
    profile_spec(spec)
    del spec['model'], spec['draft']
    profile_train(pretrained['step'], trained['batch'],
                  pretrained['step_s'], 'pretrain')
    pretrained['step'].optimizer._slots.clear()
    profile_train(trained['step'], trained['batch'], trained['step_s'],
                  'bench')
    release(trained, pretrained)
    t5_profile(t5_prep)
    mark('phase 7')
    procs = serve_procs(res)
    mark('phase 6j')
    # after 6j: the linear-algebra libraries' workspaces stay in the
    # process, and 6j's children leave the parent little room
    n_ops = op_sweep()
    gpt = gpt_family()
    fp16 = fp16_phase()
    host_phase(LlamaConfig.llama2_7b())
    mark('phases 8 (op sweep), 9, 10, 13')
    opt_cases = optimizer_cases()
    check_kernels(opt_cases)
    rungs = rung_cases()
    check_kernels(rungs)
    f16 = fp16_cases()
    check_kernels(f16)
    d64 = head64_cases()
    check_kernels(d64)
    t5c = t5_cases()
    check_kernels(t5c)
    vc = vision_cases()
    check_kernels(vc)
    kvc = [c for c in kv_dtype_cases() if c['rep']]
    check_kernels(kvc)
    mark('phase 8 (checks again)')
    rows = time_kernels(cases + opt_cases + rungs + f16 + d64 + t5c + vc
                        + kvc)
    mark('phase 8 (timing)')
    api = api_phase()
    mark('phase 14')
    tail_phase()
    mark('phase 15')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    table = []
    for name in REPLACES:
        r = rows[name]
        key = ROW_KEYS.get(name, (name,))[0]
        launches = sum(run['launches'].get(key, 0)
                       for run in (res, trained, pretrained, adapted,
                                   rowed, stored, weights, fleet, prefixed,
                                   int8,
                                   spec['draft2'], spec['self'], procs,
                                   eager, *rest.values(), *gpt.values(),
                                   *fp16.values(), *t5.values(),
                                   vis['train'], kvd, api))
        table.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name],
            'replaces': REPLACES[name], 'launches': launches,
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
            'shape': r['shape']})
    log(f'[eager] op sweep {n_ops} cases; phase 5g {eager["seconds"]:.1f} '
        f's, O1 bf16 vs O0 f32 step-1 loss rel {eager["o1_rel"]:.3e}')
    log(f'[done] {time.perf_counter() - t0:.1f} s')
    print(smi)
    print(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
