#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.

  python3 chip_smoke.py

It drives the port's main paths — the diffusion relay executor on linear
and DAG arms, the scheduler's decision loop over the executor's quality
table, the sequential serving engine, the continuous-batching runtime
and a fleet of three clusters over that table, the serving driver end to
end, diffusion training and the Table III baselines, LM training on
seven configurations, the MoE and MLA models (``deepseek-v3-671b``,
``llama4-maverick-400b-a17b``) at full width cut in depth, the encoder
and cross-attention models (``whisper-medium`` at full width and depth,
``llama-3.2-vision-11b`` at full width cut in depth), ``xlstm-1.3b`` at
full width and depth served and relayed, the LM prefix relay at
``qwen3-4b`` width and the same relay at ``recurrentgemma-9b`` width —
and holds every CUDA kernel against its plain PyTorch version.  Phases,
each failing the run (non-zero exit, no result line) on any mismatch:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel),
   with ``-Xptxas -v``'s registers, stack and spills of every flash
   kernel, and the registers and spills of the emit's kernels (each
   route's range, those that spill, the path's instantiation);
2. each of the four boundary kernels against its plain PyTorch version on
   the card — main-path shapes (R = 4·{1, 8} wire rows of L = 64), ragged
   shapes, one HBM-sized shape (R = 8192, L = 4096); fp32 and bf16; ddim
   and rf; guidance 1.0 and 3.5 — payloads, scales and stepped rows
   exact; the emit on every route of its launch plan (``ops.emit_plan``)
   and every load width: the wire rows, L = 1, 5, 63, 65, 1023, 1024,
   1025, 1500, (32, 16384) and (128, 16384), the longest row a cluster of
   8 holds and one value longer, eps_u its own tensor and eps_c itself;
   slices whose bases lie off 16 bytes; all-zero and subnormal rows; and
   the interior sampler step (``fused_cfg_step``) bit for bit
   at the relay's latents (8, 8, 8, 4) and a straggler's (1, 8, 8, 4),
   ragged shapes and (8192, 4096); fp32 and bf16; ddim (``ddim_coeffs(0.4,
   0.6)``) and rf; guidance 1.0 and 3.5; eps_u its own tensor and eps_c
   itself;
3. the diffusion main path: the trained families on the card,
   ``generate_bucketed`` for 8 requests on each of the 11 raw arms and of
   the 10 compressed twins (fused and unfused boundaries, which must
   agree bit for bit), then ``quality_table``; every diffusion
   kernel must have launched on this path, the emit exactly once per
   compressed hop of each fused call (20), the interior step exactly
   once per step of each F3 call but a fused hop's two boundary steps
   (50 raw and unfused, 48 fused) and never on XL; a request re-run alone
   and in a pair (``subset=``) equals its rows of 8 bit for bit;
4. diffusion card against CPU: 2 requests per family on the same
   host-drawn noise; then F3's s = 15 relay guided (g = 3.5, an
   unconditional input of zeros) through ``execute_program``, raw, int8
   unfused and int8 fused, card against CPU, with exact interior-step
   launches, two net calls a step, equal bytes, and latents that differ
   from the unguided relay's;
5. diffusion times: per-arm ms per request (host clock around a
   synchronized run) and the device's busy share of one run; the launch
   floor (an empty kernel); per kernel, the device time per call
   (profiler) and the time per back-to-back call (CUDA events) beside the
   plain version's, the library call's, the byte/operation bound and the
   floor (that bound or the empty kernel's time, whichever is larger); the
   interior step at the path's shape (unguided and guided) and at (8192,
   4096) in fp32 and bf16, its library time the pair lerp + add; the emit
   (fp32, ddim, g = 1) at (32, 64), (4, 64), (32, 16384), (128, 16384)
   and (8192, 4096), each with its plan's route, the bound and the floor,
   and beside the plan at L = 64 a half warp per row, on the cluster
   route each cluster size;
6. flash attention against its plain version on the card (tolerances at
   ``FLASH_TOL``), each case run twice and equal to itself bit for bit:
   the five shapes of ``tests/test_kernels.py`` in fp32 and bf16, and in
   bf16 the LM paths' shapes in the model's strided layout — ``qwen3-4b``
   decode (q (8, 32, 1, 128) over a cache of 128, kv_len 1, 37, 128, and
   over caches of 2048 and 4096, kv_len 1, 37, T: split KV, whole splits
   empty at 37), scoring (S = T = 128, causal) and S = T = 4096 causal;
   ``recurrentgemma-9b`` (MQA at head dim 256) decode (q (8, 16, 1, 256)
   over a ring of 128, kv_len 1, 37, 128), full rings of 16 and 2048
   slots and the ring of 2048 at kv_len 37, scoring (S = T = 128, causal,
   window 2048), and fp32 cases at head dim 256; scoring at S = 70
   (ragged tiles) at head dims 128 and 256, plain and with a window of 24;
   ``gemma2-27b``'s training shape (q (2, 32, 64, 128) over 16 KV heads,
   softcap 50, causal, window 16 and global); ``llama4-maverick-400b-a17b``'s
   group of 5 (q (8, 40, 1, 128) over 8 KV heads and a cache of 32, kv_len
   1, 17, 32, and scoring at S = T = 32); phase 23's non-causal shapes
   over a context: ``whisper-medium``'s encoder (4 x 16 heads of 64,
   S = T = 1,500: scoring at D 64), its cross calls at the prompt (S = 16
   at a group of 1: the decode kernel's 16 rows) and in decode over 1,500
   frames, ``llama-3.2-vision-11b``'s at the prompt (S = 16 at a group of
   4: scoring with S != T, a ragged query tile) and in decode over 1,600
   patches, and a prompt of 70 over 1,500 frames (ragged tiles on both
   axes);
7. flash attention's times per shape (both models' decode and scoring,
   4096, the two long-cache decodes, phase 23's encoder and cross calls,
   in the model's layout): the kernel's, the plain version's and SDPA's
   beside the bound;
11. the RG-LRU scan against its plain version, bit for bit: the path's
    shape (8, 128, 4096), ragged shapes, S = 1 and (1, 4096, 4096); then
    its times at (8, 128, 4096) and (1, 4096, 4096) beside the plain
    version's, the bound and the launch floor (run here, before the LM
    paths' long runs, as the profiler needs);
8. the LM main path: ``qwen3-4b`` (cut to 18 of its 36 layers for the
   command's time, bf16) as the large model and
   its 9-layer cut as the small one, random weights from seeded
   generators; 8 prompts of 64 tokens decode 64 new tokens large-only,
   relayed at s = 32, and small-only, then ``sequence_logprob`` of each
   under the large model; flash attention must launch in both the decode
   calls and the scoring forward, as many times as there are layer calls,
   every decode call on the decode kernel and every scoring call on the
   scoring kernel (none on the CUDA-core one), and the handoff bytes must
   follow the reference's formula; then the relay at s = 32 untraced and,
   in turn, with a span tracer (``tracer=SpanTracer(), rid=7``): the
   untraced run's tokens bit for bit and its flash launches on each
   variant (the traced run's launches count toward the path's), request 7
   complete with ``t_total`` = ``attributed_s()`` = 64 logical seconds,
   segment spans ``n00`` and ``n01`` of 32 tokens, one hop of the
   transfer bytes, the Chrome trace schema-valid (also through ``python -m
   repro_torch.serving.obs.export`` in a child process) and the spans'
   JSONL read back equal; ms per relay request untraced and traced;
9. LM card against CPU on the same weights: full width, 2 layers, fp32,
   2 prompts of 16 tokens: teacher-forced logits and ``sequence_logprob``
   within 1e-5 relative, and an 8-token relay's tokens equal up to the
   first step whose top-2 margin does not exceed ten times the logit
   difference (a tie, reported as one); then full width, 4 layers, bf16
   (the main path's dtype): every layer's attention output at every
   decode step and in the scoring forward, the bf16 caches and the logits
   within ``LM_BF16_RTOL`` of the CPU's;
10. LM times: ms per new token of each model and ms per relay request,
    and the busy share of one relay run; then the ``qwen3-4b`` models are
    freed;
12. the RecurrentGemma main path: ``recurrentgemma-9b`` (cut to 20 of its
    38 layers, six super-blocks and the remainder, bf16) as the large model and its 11-layer cut as the small one, random
    weights from seeded generators, the same prompts, large-only, relayed
    at s = 32 and small-only, then ``sequence_logprob`` of each under the
    large model; exact launch counts: the RG-LRU scan never in decode and
    once per recurrent layer (14) per scored batch, flash attention once
    per attention layer (6 and 3) per decode step (decode kernel) and 6
    times per scored batch (scoring kernel);
13. RecurrentGemma card against CPU on the same weights, at full width
    with 5 layers (one super-block and the remainder, the depth
    ``make_reduced`` keeps) and, for this check only, the window cut to 16
    so that the ring wraps inside a 32-token run: fp32 as in phase 9
    (logits and ``sequence_logprob`` within 1e-5, relay tokens up to the
    first tie), and bf16: every layer's mixer output at every decode step
    and in the scoring forward, the ``h``/``conv`` states and the rings
    after every step, and the logits, within ``RG_BF16_RTOL``;
14. RecurrentGemma times, as phase 10;
15. DAG relay execution: the trained families with their mid stages, 8
    requests through ``generate_bucketed`` on the 4 DAG arms of
    ``dag_action_space()`` (3 speculative twin-hops with a Select, the
    ensemble with a Merge), fused and unfused, then ``quality_table``:
    exact launches per call, derived from the plan (the emit kernel never:
    a DAG emit needs the Eq. 1 deviation, so it is the step and the quant
    and dequant kernels; the consume once per fused compressed edge), each
    count set to 0 just before its call; bit for bit: fused ≡ unfused, a
    forced reject (bound 0) ≡ the int8 relay at s, a forced accept (bound
    1e9) ≡ the int8 relay at s_spec, the merge ≡ the mean of its two branch
    chains, the pipeline ≡ ``execute_graph``, the chain-graph twins of the
    21 linear arms ≡ phase 3's outputs with no pipeline added, a re-run
    alone and in a pair (``subset=``) ≡ its rows of 8; the default-bound
    Select's deviation, bound and kept branch; the ensemble's edge output
    and one initial latent keep their bits after every consumer; card
    against CPU on 2 requests through ``execute_graph`` and the executor
    (latents within ``COMPRESSED_RTOL``, equal bytes, each Select's winner,
    and its deviation and bound within ``DEV_RTOL`` relative; a Select
    within ``SELECT_TIE`` of its bound is reported as a tie); ms per request of each DAG arm beside its int8
    twin, in turns, and the busy share of one run;
16. the scheduler, no engine: the handoff transport (``handoff_error``
    for XL and F3 card against CPU within 1e-6, equal payload bytes, one
    quant and one dequant launch on a first call and none cached; the
    quality deltas; ``warm(boundary=True)`` launching the emit, consume,
    quant and dequant kernels the number of times derived from the code
    (``warm_launches``), ``boundary=False`` none); the Fig. 6 offline
    protocol (``benchmarks/fig6_scheduler_comparison.py``) on the card's
    ``quality_table`` of 64 training and 32 held-out requests over the 11
    arms (the interior step once per F3 step), the reward from the latency
    model and the transport's quality delta: RISE's sequential
    select/update on the card, its state equal bit for bit to a CPU policy
    fed the same arms and rewards and its held-out scores within
    ``SCORE_RTOL``; PPO and SAC trained with ``train_offline`` from the same
    weights on both devices (weights within ``WEIGHT_RTOL``, equal held-out
    picks unless the top-2 margin is under ``MARGIN_TIE``); each policy's
    mean held-out reward, RR and Greedy (host-only, nothing on the card to
    check) included (a smoke reading); LinUCB alone:
    10,000 sampled draws against softmax(s/τ) (chi-square p > 1e-3, a
    masked arm never drawn), the forced branch exact, the 15 DAG arms with
    a 10-dim context card against CPU bit for bit; the federation of three
    clusters over five gossip rounds equal to ``centralized_reference`` on
    the card bit for bit; µs per ``RisePolicy.select`` and ``update`` on
    the card and the CPU (median, and p50/p95/max through
    ``StreamingQuantiles``) and the device kernels per call; scheduler
    introspection (``serving/obs/sched.py``): the ``linucb_snapshot`` of
    the card's trained RISE equal to its CPU twin's, pulls summing to the
    training updates, the held-out picks' regret, a JSON report;
17. the sequential serving engine (``serving/engine.py``,
    ``runtime="sequential"``) over phase 16's 96 requests and its quality
    table, checking only what the card computes: (a) compressed, the
    engine with its transport on the card against the same engine with
    ``device="cpu"``, on the 11 arms and on the 15 DAG arms with an
    always-reject speculation (the synthetic table; Selects both accept
    and reject): arms, ``t_total``, ``wait_s``, contexts, fault counters
    and Select decisions exact, quality and reward within ``ENGINE_RTOL``;
    (b) RISE on the card against RISE on the CPU by replay
    (``ReplayPolicy``: each forced pick the CPU policy's own), the state
    within ``RISE_ULPS``; (c) every card run's ``quant_int8`` and
    ``dequant_int8`` launches, counted from 0 just before the engine is
    built, equal to one round trip per family its records touch
    (``engine_launches``); (d) ms
    per request with RISE and the transport on each device, in alternating
    turns (printed, not held);
18. the continuous-batching runtime (``serving/runtime/engine.py``, the
    engine's default ``runtime="continuous"``) over phase 16's 96
    requests and its quality table, checking only what the card computes:
    (a) compressed, the runtime with its transport on the card against
    the same runtime with ``device="cpu"``, on the 11 arms and on the DAG
    arms with the always-reject speculation: arms, ``t_total``,
    ``wait_s``, contexts, fault counters and Select decisions exact (both
    outcomes served), quality and reward within ``ENGINE_RTOL``; (b) RISE
    on the card against RISE on the CPU by replay of its picks in decision
    order (records equal, the state within ``RISE_ULPS``); (c) every card
    run's ``quant_int8`` and ``dequant_int8`` launches, counted from 0
    before the engine is built, equal to one round trip per family of the
    action space (the runtime warms its transport before its loop;
    ``engine_launches``); (d) ms per request in alternating turns of RISE
    on the card, RISE on the CPU beside the card's transport, and the
    whole engine on the CPU (printed, not held); (e) ``launch/serve.py``'s
    ``main`` end to end on the card (``--policy rise --runtime continuous
    --requests 32 --trace-out --profile``): 32 records, a valid trace,
    the quality table's launches and the runtime's round trips exact
    (``table_launches``, ``warm_launches``); the same run with ``--policy
    rr`` on the card and with ``--device cpu`` equal in arms, latencies
    and runtime telemetry;
19. the fleet (``serving/fleet/engine.py::FleetEngine``) over phase 16's
    96 requests and its quality table, on ``benchmarks/bench_fleet.py``'s
    three clusters (``FLEET_CLUSTERS``: the testbed inventory, one and
    four replicas per pool; regions by ``rid % 3``), checking only what
    the card computes: (a) compressed, Cycle on every cluster, the
    fleet's transports on the card against ``device="cpu"`` for each
    router and once autoscaled (``AutoscaleConfig()``): every cluster's
    records in completion order (arms, ``t_total``, ``wait_s``,
    contexts), the assignments and every cluster's telemetry (pool stats,
    fault and autoscale counters) exact, quality and reward within
    ``ENGINE_RTOL``; (b) a one-cluster fleet on the card against the
    standalone runtime on the card, every ``Record`` field bit for bit in
    completion order; (c) three ``FederatedRisePolicy`` on the card,
    gossip every 30 s, against CPU policies fed the card's picks per
    cluster in decision order (``FedReplay``) beside the same card
    transports: records, assignments and gossips equal, the merged base
    and every live state within ``RISE_ULPS``; (d) every card fleet's
    ``quant_int8`` and ``dequant_int8`` launches, counted from 0 before
    the fleet is built, equal to one round trip per family per cluster
    (``fleet_launches``); (e) ms per request in alternating turns of
    federated RISE on the card, RISE on the CPU beside the card's
    transports and the whole fleet on the CPU, and of a fleet of one
    against the standalone runtime (the driver's own cost); federated
    against isolated cumulative reward (printed, not held);
20. diffusion training and the Table III baselines
    (``diffusion/train.py``, ``core/accel_baselines.py``): (a) one
    training step of each of the six nets at full width, batch 64, from
    the same initial net and host draws, card against ``device="cpu"``:
    the loss, every gradient (and the same parameters without one), Adam
    alone on identical inputs in ulps, the parameters after the step (but
    elements whose gradient lies at the noise floor or near Adam's eps,
    counted and bounded),
    and whether two card runs agree bit for bit (printed); (b)
    ``get_or_train_families`` on the card into a temporary directory (300
    steps, batch 64, mid stages): every model's loss falls, the four
    checkpoints read back by ``load_families`` equal the trained modules
    bit for bit, the teacher pool launches the interior step 50 times for
    F3 and never for XL; (c) the quality table of those families beside
    the committed ones on 8 requests (a reading); (d) full sampling,
    DeepCache, T-GATE and SADA on the committed trained large nets, 8
    requests a family, card against CPU (latents within 1e-4, evals and
    model calls equal, a SADA stability test within ``SADA_TIE`` of its
    threshold reported as a tie), the interior step 50 times per F3 call
    and never on XL, ms per request in alternating turns; (e) seconds per
    training step of each net on each device; nothing under ``results/``
    changes;
21. LM training (``training/{optimizer,train_step}.py``,
    ``launch/train.py``): (a) one step of each of the seven
    configurations' ``make_reduced`` (the MoE models' aux term and
    deepseek's MTP head in the loss) and of ``granite-8b`` at full width
    (2 layers, 2 x 64 tokens), fp32, from the same weights and batch, card
    against ``device="cpu"``: the loss, every parameter's gradient (none
    ``None``; each within ``TRAIN_GRAD_RTOL``), the step's loss,
    ``grad_norm`` and rate, the parameters after it (as phase 20, the
    floor counted), seconds per step on each device; (b) ``gemma2-27b`` at
    full width in bf16, 2 layers (the local window cut to 16 so that it
    masks inside 64 tokens), the tied 256k head through the chunked loss,
    ``remat`` on: 10 steps on one batch, the loss finite and falling,
    exactly one scoring-kernel launch per attention layer per forward and
    per recompute, every weight moved, and each layer's flash call of the
    first forward (softcap 50; window 16, then global) replayed on its
    own operands within ``FLASH_TOL`` of the plain version; seconds per
    step; (c) ``launch.train``'s ``main`` on
    the card, 8 steps, and 4 steps resumed to 8: the losses within 1e-5
    (bits equal or not, printed); flash attention and the scan launch
    exactly once per attention or RG-LRU layer per forward throughout (a
    backward is the plain versions' VJP and launches neither); (d) one
    step of each reduced configuration of (a) counted by
    ``analysis.roofline.CostCounter`` on the CPU and on the card (the
    kernels declaring their work): the flops equal exactly, the bytes
    equal but for the two branches a step takes by device (the flash
    output's layout, torch's ``one_hot`` check; :func:`device_branch_bytes`,
    exactly, op by op), the step's roofline printed;
22. the MoE and MLA models (``models/mlp.py``'s sort-based MoE,
    ``models/attention.py``'s MLA, the MTP head): (a) ``make_reduced`` of
    ``deepseek-v3-671b`` and ``llama4-maverick-400b-a17b`` in fp32, the
    same weights on the card and the CPU: every MoE call's experts equal
    (a flip fails), the forward logits, each decode step (MLA expanded and
    absorbed; llama4 at top-1 and at top-2, the latter also against the
    forward), the MTP logits and the aux term within ``LM_RTOL``; (b)
    ``deepseek-v3-671b`` at full width in bf16, the large model one
    MLA+MoE layer (256 experts, top-8, one shared) and one MLA+dense
    layer (13.94 B), the small one the MLA+MoE layer (13.36 B):
    ``relay_decode`` of 8 prompts of 16 tokens at s = 8 of 16 new ones and
    ``sequence_logprob``, MLA expanded and absorbed on the same weights
    (tokens equal up to a tie; scoring logits, and each step of the decode
    over the latent cache teacher-forced on one run's tokens, within
    ``MLA_MODES_RTOL``, with each clear new token equal), each MoE call within ``MOE_ORACLE_RTOL`` of an fp32 oracle computed on
    the card from its routing, the relay again bit for bit, no kernel
    launched (MLA's attention is plain torch); (c)
    ``llama4-maverick-400b-a17b`` at full width in bf16, 2 layers (dense,
    MoE of 128 experts top-1; 18.56 B): ``greedy_decode`` of the same
    shape and ``sequence_logprob``, flash attention exactly once per
    layer per decode step (decode kernel, a group of 5) and per scoring
    forward (scoring kernel), the MoE oracle, the decode again bit for
    bit, every flash call replayed within ``FLASH_TOL`` of the plain
    version; for (b) and (c) the peak memory, ms per decode step, the
    busy share and the step's byte bounds (every expert read, as the
    reference's dispatch reads them; only the routed ones);
23. encoders and cross-attention (``models/transformer.py``'s
    ``Encoder``, cross layers and ``ctx_proj``, ``gqa_fwd`` over a
    context, the train, prefill and serve steps with one): (a)
    ``make_reduced`` of ``whisper-medium`` and ``llama-3.2-vision-11b``
    in fp32 card against CPU on the same weights and seeded context: the
    prefill logits, ``ENC_CHECK_STEPS`` teacher-forced decode steps (and
    each against its device's prefill), within ``LM_RTOL``, and one train
    step as phase 21 (a) holds it, every gradient (encoder, cross layers,
    ``ctx_proj``) non-``None``; (b) ``whisper-medium`` at full width and
    depth (24 decoder and 24 encoder layers, bf16) and (c)
    ``llama-3.2-vision-11b`` at full width cut to ``VISION_LAYERS`` (two
    super-blocks of a cross and four self layers, ``ctx_proj`` 7,680 to
    4,096, bf16), each serving ``ENC_ROWS`` requests (1,500 seeded frames
    or a (1,600, 7,680) seeded context each; prompts of ``ENC_PROMPT``,
    ``ENC_NEW`` greedy tokens) through ``make_prefill_step`` and
    ``make_serve_step`` with the context: every flash call replayed
    within ``FLASH_TOL`` of the plain version, launches by variant equal
    to the count derived from ``ops.plan``'s rule (whisper's decode step:
    24 encoder scoring, 24 self and 24 cross decode launches), each
    decode step and the prompt's prefill within ``ENC_LOGITS_RTOL`` of
    the prefill teacher-forced over the whole sequence, a second run
    equal bit for bit; ms per prefill and per decode step beside the
    step's bound (weight and context bytes over the HBM rate plus the
    context's operations over the bf16 rate), the busy share, the peak
    memory;
24. xLSTM (``models/recurrent.py``'s mLSTM and sLSTM, plain torch: no
    hand-written kernel on this path, so every launch count reads 0 over
    the phase): (a) ``make_reduced(xlstm-1.3b)`` in fp32 card against CPU
    on the same weights: the forward in the parallel and the chunkwise
    form (S = 32, chunk 8), 16 teacher-forced decode steps (their logits,
    and every layer's state after each step) within ``LM_RTOL``, the
    greedy tokens equal up to a tie; (b) one period at full width (7
    mLSTM layers and the sLSTM layer, bf16) card against CPU: every block
    output, state and logit row of a 16-step decode and of the forward
    within ``XLSTM_BF16_RTOL``, and on the card the chunkwise form against
    the parallel one at S = 256, chunk 64, in fp32 within the reference's
    2e-2 (bf16 read); (c) ``xlstm-1.3b`` at full width and depth (48
    layers, bf16): ``greedy_decode`` of 8 prompts of 16 tokens and 16 new
    ones, each decode step within ``XLSTM_LOGITS_RTOL`` of the full
    forward, ``relay_decode`` at s = 8 to the one-period model and the
    small model alone, ``sequence_logprob`` of each arm, the handoff's
    bytes, ms per decode step against the step's byte bound (the weights
    and the state read and written once), the device time and busy share
    of a step, the peak memory; (d) trained: one fp32 step of
    ``make_reduced`` card against CPU as phase 21 (a) holds it, with and
    without ``mlstm_chunk`` (loss and ``grad_norm`` within
    ``XLSTM_RTOL``; every gradient finite), the 48-layer bf16 model 10
    steps of 2 x 64 tokens with ``remat`` (every gradient finite, the
    first loss in both mLSTM forms within 2e-2, the loss falling; ms per
    step, peak memory and the counted step's roofline), and
    ``launch.train --arch xlstm-1.3b`` resumed as phase 21 (c);
25. the distributed layer (``distributed/{sharding,compat,compression,
    pipeline_parallel}.py``, the expert-parallel MoE, sharded GQA and
    the step factories with a mesh), its ranks child processes sharing
    the card in a gloo group (NCCL refuses two ranks on one device;
    ``compat`` stages through the host what gloo cannot carry on CUDA
    tensors, and counts the copies): (a) one ``deepseek-v3-671b`` MoE
    layer (bf16; 256 experts of d_ff 2,048, top-8, one shared expert;
    each expert drawn from its own seed) on a 1 x 4 mesh, 64 experts a
    rank, 64 tokens, against the unsharded ``moe_fwd`` of the same
    weights run first: routing equal, aux equal, the output within
    ``DIST_MOE_RTOL``; ms a call both ways, peak memory per rank; (b)
    ``compressed_psum`` on 4 and 8 ranks, fp32 and bf16 leaves, both
    quantizers: the reference parity test's checks, then distinct inputs
    per rank, each rank's error bit for bit against
    ``fused_error_feedback_step`` alone on the card, the mean the same
    bits on every rank and within ``world`` spacings of the
    reconstructions' magnitude from their fp64 mean;
    ``quant_int8`` and ``dequant_int8`` launches exactly as the code
    implies (9 a rank); (c) ``pipeline_apply`` on 2 and 4 stages (3
    layers a stage, d 16, 6 microbatches of 8) against the sequential
    layers within the reference's 1e-5 (fp32) and 3e-2 (bf16), its
    ``ppermute`` host copies as the schedule implies; (d) ``qwen3-4b`` at full
    width cut to ``DIST_QWEN_LAYERS`` (bf16): prefill and
    ``DIST_STEPS`` teacher-forced decode steps through
    ``make_prefill_step``/``make_serve_step(mesh=)`` on 1 x 4 and, with
    head padding (32 heads to 48), on 1 x 3, against the unsharded steps
    on the card: logits within ``DIST_LOGITS_RTOL``, each clear greedy
    token (``MARGIN_FACTOR``) equal, flash launches per rank; (e) a bf16
    weight sharded on 2 x 2, saved and restored onto 4 x 1: every rank's
    block on the card equal to its slice.

The phases run in the order 1-7, 11, 15-25, 8-10, 12-14.  Every
profiled time comes from a session whose kernel records are complete (see
:func:`profiled`); the profiled phases run before the LM paths' long
unprofiled runs where they can.

Prints a ``kernels`` JSON line (a diffusion kernel's ``launches`` summed
over phases 3 and 15-20, the quantizers' also over 25's ranks; flash
attention's over phases 8, the traced relay included, 12, 21, 22, 23 and
25's ranks; the scan's over 12 and 21), the card's
line,
and last ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
CKPTS = REPO / "results" / "ckpts"
sys.path.insert(0, str(REPO / "src"))
# the H100's rates (HBM_BW, PEAK_FLOPS, PEAK_FLOPS_FP32) and each kernel's
# work, which its bound and the cost counter both take
from repro_torch.analysis import roofline as rl  # noqa: E402

MAIN_ROWS, WIRE_LEN = 4 * 8, 64  # 8 requests x 4 latent channels, 8x8
RAW_RTOL, COMPRESSED_RTOL = 1e-4, 1e-3
# LM paths: 8 prompts of 64 tokens, 64 new tokens, relays at s
LM_BATCH, LM_PROMPT, LM_TOTAL, LM_SPLITS = 8, 64, 64, (32,)
# the relays' large models cut in depth for the command's time (from 36
# and 38 layers before PR 36: the command read 622-998 s, and phase 24
# adds about 70 s against the 1,200 s limit); the small ones as before
LM_LARGE_LAYERS, LM_SMALL_LAYERS = 18, 9
RG_NAME, RG_LARGE_LAYERS, RG_SMALL_LAYERS = "recurrentgemma-9b", 20, 11
# phase 13: one super-block (R, R, A) and the remainder (R, R); the
# window cut to 16, for the check only, so that the ring wraps in a run of
# 16 prompt tokens and 16 new ones
RG_CHECK_LAYERS, RG_CHECK_WINDOW = 5, 16
# RG-LRU scan shapes (B, S, R): the path's, ragged ones, S = 1, a long one
RGLRU_SHAPES = [(LM_BATCH, LM_PROMPT + LM_TOTAL, 4096), (3, 70, 70),
                (1, 1, 5), (2, 1, 33), (1, 4096, 4096)]
LM_RTOL = 1e-5  # card against CPU, fp32 logits (norm-wise relative)
MARGIN_FACTOR = 10.0  # a greedy step is a tie below 10x the logit gap
# flash attention against its plain version, (atol, rtol): fp32 at
# tests/test_kernels.py's TOL; bf16 to one bf16 ulp (rtol 8e-3 > 2^-7, the
# largest ulp/|x|) over an atol of 1e-4 for outputs near zero.  Both round
# one fp32 result to bf16, so they differ by at most one ulp: the largest
# bf16 error the card showed under the older 4e-2 was 9.8e-4, one ulp at
# |x| in [0.125, 0.25) (14 cases, H100 80GB HBM3, 700 W)
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 8e-3)}
# full width, 4 layers, bf16, card against CPU on the same weights:
# norm-wise relative error of each attention output, cache and logit row,
# about five bf16 epsilons (2^-8); a wrong cache write or read moves an
# attention output by O(1)
LM_BF16_LAYERS, LM_BF16_RTOL = 4, 2e-2
# recurrentgemma-9b at full width, 5 layers, window 16, bf16, card against
# CPU, norm-wise as above: 2.3x the largest reading (RG-LRU block outputs
# 1.09e-2 in decode and 1.01e-2 in scoring; attention 6.7e-3, logits
# 7.2e-3, h and conv states 7.3e-3 and 6.3e-3, rings 3.8e-3; H100 80GB
# HBM3, 700 W), and 2.5x under the weakest fault that
# tests/test_torch_recurrentgemma.py injects (an h not carried moves the
# mixer outputs by 0.063)
RG_BF16_RTOL = 2.5e-2
# the interior step's cases in phase 2: the relay's latents (8 requests, a
# straggler's 1), ragged shapes and one HBM-sized shape
STEP_SHAPES = [(8, 8, 8, 4), (1, 8, 8, 4), (13, 17), (2, 5, 7, 3), (1, 5),
               (8192, 4096)]
RF_DT = -0.02  # an rf step's coefficient in the kernel checks
GUIDANCE = 3.5  # phase 4's guided relay and the guided kernel cases
# the emit's cases in phase 2: every route of ops.emit_plan (rows up to
# L = 1024, cluster, and two-pass past a cluster of 8 full on chip)
EMIT_SHAPES = [(4, 64), (32, 64), (3, 1), (3, 5), (3, 63), (3, 65), (3, 1023),
               (3, 1024), (3, 1025), (3, 1500), (32, 16384), (128, 16384),
               (1, 458_752), (1, 458_753)]
# phase 5's emit shapes: the path's wire rows, a straggler's, SDXL- and
# SD3.5-size latent rows (4x128x128 and 16x128x128, 8 requests), HBM-sized
EMIT_TIME_SHAPES = [(MAIN_ROWS, WIRE_LEN), (4, WIRE_LEN), (32, 16384),
                    (128, 16384), (8192, 4096)]
DIFFUSION_KERNELS = ("fused_cfg_step", "fused_cfg_step_quant",
                     "fused_cfg_step_dequant", "quant_int8", "dequant_int8")
KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "fused_cfg_step": ("src/repro_torch/csrc/fused_sampler.cu",
                       "src/repro/kernels/fused_sampler/kernel.py:48"),
    "fused_cfg_step_quant": ("src/repro_torch/csrc/fused_sampler.cu",
                             "src/repro/kernels/fused_sampler/kernel.py:126"),
    "fused_cfg_step_dequant": ("src/repro_torch/csrc/fused_sampler.cu",
                               "src/repro/kernels/fused_sampler/kernel.py:166"),
    "quant_int8": ("src/repro_torch/csrc/quant.cu",
                   "src/repro/kernels/quant/kernel.py:36"),
    "dequant_int8": ("src/repro_torch/csrc/quant.cu",
                     "src/repro/kernels/quant/kernel.py:60"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:78"),
    "rglru_scan": ("src/repro_torch/csrc/rglru.cu",
                   "src/repro/kernels/rglru/kernel.py:37"),
}


# the profiler's name of each counted kernel: the three flash kernels share
# the prefix (flash_fwd_kernel, flash_fwd_decode_kernel,
# flash_fwd_scoring_kernel)
KERNEL_SYMBOLS = {"flash_attention": "flash_impl::flash_fwd",
                  "rglru_scan": "rglru_scan_kernel",
                  "fused_cfg_step_dequant": "consume_kernel"}
# phase 15, card against CPU: a Select whose deviation lies within this
# share of its bound is a tie (reported, not failed); each Select's
# deviation and bound agree within DEV_RTOL relative, as the CPU tests hold
# them to the reference
SELECT_TIE = 1e-4
DEV_RTOL = 1e-5
DAG_TURNS = 3  # phase 15's timed runs of each (DAG arm, int8 twin) pair
# phase 16: the Fig. 6 protocol's training and held-out requests, the
# sampled branch's draws, the timed decisions, the DAG-space steps
SCHED_TRAIN, SCHED_HELD = 64, 32
# their stream (serving/engine.py::make_requests), which phase 17 serves
SCHED_STREAM = dict(n_requests=SCHED_TRAIN + SCHED_HELD,
                    mean_interarrival=1.0, seed=10)
SCHED_SEED0 = 50_000
SCHED_DRAWS, SCHED_TIMED, SCHED_DAG_STEPS = 10_000, 1_000, 300
# card against CPU: held-out UCB scores (relative to the largest score's
# magnitude), PPO/SAC weights after training (norm-wise per tensor), and a
# held-out selection whose top-2 margin is under this share is a tie
SCORE_RTOL, WEIGHT_RTOL, MARGIN_TIE = 1e-5, 1e-4, 1e-5
# phase 17, card against CPU: compressed records' quality and reward within
# ENGINE_RTOL of max(|CPU|, 1), the round trip's error differing in its
# last bits (read 1.7e-8 on the 11 arms and 8.4e-9 on the DAG arms, H100
# 80GB HBM3, 700 W; the bound is 6x); RISE's state after the stream within
# RISE_ULPS, as phase 16 holds it (read 0); the engine's timed turns on
# each device
ENGINE_RTOL = 1e-7
RISE_ULPS = 0
ENGINE_TURNS = 3
# phase 18: the requests of each serving-driver run (launch/serve.py)
CLI_REQUESTS = 32
# phase 19: bench_fleet's fleet (benchmarks/bench_fleet.py): (name,
# region, replicas per pool, None for the testbed inventory) of each
# cluster, the pools, the gossip period in simulated seconds, the routers
FLEET_CLUSTERS = (("edge-a", "east", None), ("edge-b", "west", 1),
                  ("edge-c", "south", 4))
FLEET_POOLS = ("sdxl", "ssd1b", "vega", "sd3l", "sd3lt", "sd3m")
FLEET_GOSSIP_S = 30.0
FLEET_ROUTERS = ("least_loaded", "locality", "weighted")
# phase 20: the six nets; the batch and steps of get_or_train_families (300
# is the fewest at which the reference fine-tunes on trajectories, cut from
# serve.py's 1500 for time)
TRAIN_NETS = tuple((f, r) for f in ("XL", "F3")
                   for r in ("large", "mid", "small"))
TRAIN_BATCH, TRAIN_STEPS = 64, 300
# one step card against CPU from the same init and host draws: the loss
# (relative), every gradient (max |Δ| over max |CPU| per tensor), Adam alone
# on identical inputs (ulps of the moments and the rate; the parameters in
# spacings of max(|p|, |p'|), as p − u may cancel), and the parameters
# after the step (max |Δ| over max |CPU| per tensor) but for the floor:
# elements whose CPU gradient is under GRAD_FLOOR of its tensor's largest,
# or under EPS_FLOOR (100 × Adam's eps).  Adam's first update is
# lr·g/(|g| + eps): about ±lr whatever the gradient's size, so a gradient
# at rounding noise whose sign differs moves the element 2·lr, and where
# |g| is within 100 eps the update follows the gradient's last bits (a
# card run read up to 1.4e-2 of max |p| there, each element's difference
# the one its two gradients predict).  Floor elements beyond
# TRAIN_PARAM_RTOL are counted, at most FLOOR_SHARE of the floor (read
# 5.7 % on XL large, 94 of 1,642; H100 80GB HBM3, 700 W)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
TRAIN_ADAM_ULPS = 4
TRAIN_PARAM_RTOL, GRAD_FLOOR, EPS_FLOOR, FLOOR_SHARE = 1e-5, 1e-4, 1e-6, 0.15
# the Table III baselines: requests a family, SADA's threshold (its
# default) and the tie bound on its stability measure, timed turns
BASELINES = ("full", "deepcache", "tgate", "sada")
BASELINE_REQUESTS, BASELINE_TURNS = 8, 3
SADA_THRESHOLD, SADA_TIE = 0.12, 1e-4
# phase 21, LM training: (a) one step card against CPU, fp32, of each
# configuration's make_reduced (LM_TRAIN_ROWS sequences of LM_TRAIN_SEQ
# tokens) and of granite-8b at full width, 2 layers, 2 x 64 tokens: the
# loss and gradients as phase 20 holds them (TRAIN_LOSS_RTOL,
# TRAIN_GRAD_RTOL), the parameters after the step within TRAIN_PARAM_RTOL
# of the tensor's largest plus twice the update difference the two
# devices' gradients predict (phase 20's floor alone read 4.3e-5 off it
# at full width: elements just above it still follow their gradients'
# last bits; H100 80GB HBM3, 700 W); seconds per step of
# LM_TIMED_STEPS more steps on the card, of the checked step on the CPU;
# (b) gemma2-27b at full width,
# bf16, 2 layers (local window cut to LM_BF16_WINDOW, global), tied 256k
# head, ce_chunk LM_BF16_CHUNK, remat on, LM_BF16_STEPS steps on one
# batch of 2 x 64 tokens (the loss must fall); (c) launch/train.py's
# resume case (the reference's tests/test_training.py) on the card
LM_TRAIN_NAMES = ("gemma2-27b", "granite-8b", "qwen3-4b", RG_NAME,
                  "stablelm-1.6b", "deepseek-v3-671b",
                  "llama4-maverick-400b-a17b")
LM_TRAIN_ROWS, LM_TRAIN_SEQ = 4, 16
LM_FULL_NAME, LM_FULL_LAYERS, LM_FULL_ROWS, LM_FULL_SEQ = (
    "granite-8b", 2, 2, 64)
LM_TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LM_TIMED_STEPS = 5
LM_BF16_NAME, LM_BF16_WINDOW, LM_BF16_CHUNK, LM_BF16_STEPS = (
    "gemma2-27b", 16, 16, 10)
LAUNCH_ARGS = ["--batch", "2", "--seq", "16", "--ckpt-every", "4"]
# phase 22, MoE and MLA: (a) card against CPU in fp32 on make_reduced of
# both MoE models, MOE_CHECK_ROWS sequences of MOE_CHECK_SEQ tokens (their
# training step is phase 21 (a)'s, LM_TRAIN_NAMES); (b) deepseek-v3-671b
# and (c) llama4-maverick-400b-a17b at full width in bf16, cut in depth,
# MOE_ROWS prompts of MOE_PROMPT tokens and MOE_NEW new ones, deepseek's
# relay at s = MOE_SPLIT
MOE_DS, MOE_L4 = "deepseek-v3-671b", "llama4-maverick-400b-a17b"
MOE_CHECK_ROWS, MOE_CHECK_SEQ = 2, 12
MOE_ROWS, MOE_PROMPT, MOE_NEW, MOE_SPLIT = 8, 16, 16, 8
# each bf16 MoE call against an fp32 oracle computed on the card from the
# same bf16 input, weights and routing (norm-wise over the call's tokens):
# the port rounds the three expert products, the weighting and each add of
# the combine to bf16, about 2^-8 each; the LM_BF16_RTOL of phase 9, 4.2x
# the largest reading (4.7e-3 over deepseek's 114 calls, 4.4e-3 over
# llama4's 33; H100 80GB HBM3, 700 W)
MOE_ORACLE_RTOL = 2e-2
# deepseek bf16, MLA expand against absorb: the scoring logits of the two
# modes on the same tokens, norm-wise; 3.1x the reading (6.4e-3; H100
# 80GB HBM3, 700 W): the modes round different bf16 intermediates (the
# expanded keys and values, or the absorbed query and latent output).
# The same bound holds each teacher-forced decode step over the latent
# cache: 1.24x the largest step (1.61e-2, the small model's second step;
# most steps read 3.3e-3-8.3e-3, seven 9.4e-3-1.4e-2; H100 80GB HBM3,
# 700 W), whose readings repeat bit for bit, their weights and tokens
# drawn from fixed seeds
MLA_MODES_RTOL = 2e-2
# phase 23, encoders and cross-attention: ENC_ROWS requests of ENC_PROMPT
# prompt tokens and ENC_NEW new ones; whisper-medium's ENC_FRAMES frames,
# llama-3.2-vision-11b's VISION_CTX patches cut to VISION_LAYERS layers
# (two super-blocks of (cross, self x 4))
ENC_NAMES = ("whisper-medium", "llama-3.2-vision-11b")
ENC_ROWS, ENC_PROMPT, ENC_NEW = 4, 16, 16
ENC_FRAMES, VISION_CTX, VISION_LAYERS = 1500, 1600, 10
# (a): teacher-forced decode steps card against CPU (MOE_CHECK_ROWS
# sequences); (b) and (c): each bf16 decode step's logits and the prompt's
# prefill logits against the prefill teacher-forced over the whole
# sequence, norm-wise: the two paths round different bf16 intermediates
# (decode or scoring kernel, one row or all, the encoder re-run at each
# step).  1.8x the largest reading (1.65e-2, whisper's first step of 32; its
# prompt's prefill 1.41e-2; vision 1.18e-2 and 1.16e-2; H100 80GB HBM3,
# 700 W); the same prefill without the context must differ from it by
# more than ENC_CTX_FACTOR times the tolerance
ENC_CHECK_STEPS = 8
ENC_LOGITS_RTOL, ENC_CTX_FACTOR = 3e-2, 2.0
# the full-width runs' context scale: whisper's frames at (a)'s 0.1 (its
# encoder ends in a norm; they move its logits by 1.19); vision's patches
# at 4: with random weights its two cross layers' softmax over 1,600 keys
# is nearly flat at scales 0.1 and 1, the patches average out and move the
# logits by 1.19e-2 and 3.53e-2 only, within the bf16 noise of the check
# above (H100 80GB HBM3, 700 W)
ENC_CTX_SCALE = {"whisper-medium": 0.1, "llama-3.2-vision-11b": 4.0}
# phase 24, xLSTM (no hand-written kernel on its path): (a) make_reduced
# in fp32 card against CPU, 2 x XLSTM_CHECK_SEQ tokens (the chunkwise form
# at XLSTM_CHECK_CHUNK), XLSTM_CHECK_STEPS decode steps, a greedy decode
# of XLSTM_CHECK_PROMPT + XLSTM_CHECK_NEW; (b) one period
# (XLSTM_SMALL_LAYERS layers) at full width in bf16 over the same greedy
# length, and the two mLSTM forms at XLSTM_FORMS_SEQ, chunk
# XLSTM_FORMS_CHUNK, within the reference's own tolerance for them
# (tests/test_models.py); (c) XLSTM_ROWS prompts of XLSTM_PROMPT tokens,
# XLSTM_NEW new ones, the relay at XLSTM_SPLIT to the one-period model
XLSTM_NAME, XLSTM_SMALL_LAYERS = "xlstm-1.3b", 8
XLSTM_CHECK_SEQ, XLSTM_CHECK_CHUNK, XLSTM_CHECK_STEPS = 32, 8, 16
XLSTM_CHECK_PROMPT, XLSTM_CHECK_NEW = 8, 8
XLSTM_FORMS_SEQ, XLSTM_FORMS_CHUNK, XLSTM_FORMS_TOL = 256, 64, 2e-2
XLSTM_ROWS, XLSTM_PROMPT, XLSTM_NEW, XLSTM_SPLIT = 8, 16, 16, 8
XLSTM_TIMED_STEPS = 8
# (a), fp32 card against CPU, norm-wise: 3.5x the largest reading (1.43e-5,
# the mLSTM's C; the forwards 9.72e-6, the decode's logits 8.99e-6; H100
# 80GB HBM3, 700 W).  LM_RTOL's 1e-5 is under the model's own noise: the
# mLSTM's per-head group norm enlarges a near-cancelled head's rounding
# error (tests/test_torch_xlstm.py::test_gradients_are_ill_conditioned)
XLSTM_RTOL = 5e-5
# (b), bf16 card against CPU, norm-wise: 1.8x the largest reading (an
# mLSTM block's output at a decode step, 5.60e-2; the states 3.64e-2, the
# logits 2.91e-2; H100 80GB HBM3, 700 W)
XLSTM_BF16_RTOL = 0.1
# (c), bf16, each decode step against the full forward at 48 layers,
# norm-wise: the logits at 1.9x the largest reading (0.161, growing from
# 0.082 at the first step), the first period's block outputs at 2.1x theirs
# (5.65e-2; H100 80GB HBM3, 700 W).  Deeper blocks read up to 0.482 (layer
# 45): the two forms round different bf16 intermediates, and each layer's
# per-head group norm enlarges what reaches it; dropping the state at
# every step moves the blocks by 1.25-1.43
XLSTM_LOGITS_RTOL, XLSTM_BLOCK_RTOL, XLSTM_DROP_FACTOR = 0.3, 0.12, 2.0
# (d), training: one step of make_reduced in fp32 card against CPU as phase
# 21 (a), with and without mlstm_chunk XLSTM_CHECK_CHUNK (LM_TRAIN_ROWS x
# LM_TRAIN_SEQ tokens; the loss and grad_norm within XLSTM_RTOL, every
# gradient within TRAIN_GRAD_RTOL, the CPU test's XLSTM_GRAD_RTOL); the
# 48-layer model in bf16, remat on, fp32 moments at LM_TRAIN_OPT's rate,
# XLSTM_TRAIN_STEPS steps on one batch of XLSTM_TRAIN_ROWS x
# XLSTM_TRAIN_SEQ tokens, the first step's loss against the chunkwise
# form's (chunk XLSTM_CHECK_CHUNK) within XLSTM_FORMS_TOL; launch.train
# --arch xlstm-1.3b resumed as phase 21 (c)
XLSTM_TRAIN_ROWS, XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS = 2, 64, 10


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def flash_ptxas(log: str) -> list:
    """``-Xptxas -v``'s report of each kernel of ``flash_attention.cu`` in
    the build log: its name and template arguments, registers, stack and
    spills."""
    section = log.split("== flash_attention.cu", 1)[-1].split("\n== ", 1)[0]
    out, name = [], None
    for line in section.splitlines():
        entry = re.search(r"Compiling entry function '\w*?(flash_fwd_\w*?kernel)I(\w*?)EEEv",
                          line)
        if entry:
            args = (entry.group(2).replace("13__nv_bfloat16", "bf16, ")
                    .replace("Li", ""))
            name = f"{entry.group(1)}<{'fp32, ' + args[1:] if args.startswith('f') else args}>"
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
    return out


def ptxas_entries(log: str, source: str) -> list:
    """``-Xptxas -v``'s report of each kernel of ``source`` in the build
    log: (mangled name, registers, bytes of spill stores and loads)."""
    section = log.split(f"== {source}", 1)[-1].split("\n== ", 1)[0]
    return [(name, int(regs), int(st) + int(ld)) for name, st, ld, regs in re.findall(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes "
        r"spill loads.*?Used (\d+) registers", section, re.S)]


def emit_kernel_name(mangled: str) -> str:
    """``emit_rows_kernel<fp32, ddim, g=1, vec 2, 1 vector>`` from the
    mangled name of an emit kernel."""
    kind, t, mode, guided, vec, pt = re.search(
        r"(emit_\w+?_kernel)I(f|13__nv_bfloat16)Li(\d)ELb(\d)ELi(\d+)E(?:Li(\d+)E)?",
        mangled).groups()
    args = ["fp32" if t == "f" else "bf16", ("ddim", "rf")[int(mode)],
            "guided" if guided == "1" else "g=1", f"vec {vec}"]
    return f"{kind}<{', '.join(args + ([f'{pt} vectors'] if pt else []))}>"


def emit_ptxas(log: str) -> list:
    """Phase 1: the emit's kernels in the build log — per route the number
    of instantiations and their register range, those that spill, and the
    path's instantiation (fp32, ddim, g = 1, 8-byte loads, one vector a
    lane)."""
    entries = [e for e in ptxas_entries(log, "fused_sampler.cu") if "emit_" in e[0]]
    out = []
    for kind in ("emit_rows_kernel", "emit_cluster_kernel"):
        mine = [e for e in entries if kind in e[0]]
        check(mine, f"ptxas reported no {kind}")
        regs = [r for _, r, _ in mine]
        spilled = {emit_kernel_name(n): sp for n, _, sp in mine if sp}
        out.append(f"{kind}: {len(mine)} instantiations, {min(regs)}-{max(regs)} "
                   f"registers; spill bytes in {len(spilled)}: {json.dumps(spilled)}")
    path = [e for e in entries if "emit_rows_kernelIfLi0ELb0ELi2ELi1E" in e[0]]
    check(len(path) == 1, "ptxas reported no rows kernel at the path's plan")
    out.append(f"the path's {emit_kernel_name(path[0][0])}: {path[0][1]} "
               f"registers, {path[0][2]} bytes of spills")
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(min(10, iters)):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profiled(run, calls: int = 1, counted: str = None, records: int = None,
             attempts: int = 3):
    """Device time (µs) of the kernels ``run()`` launches, from the
    profiler (CUPTI), and the profiler's averages by kernel.

    The session must hold every kernel record: ``run`` makes ``calls``
    calls that launch the same kernels, so the number recorded must be a
    multiple of ``calls`` (with ``records``, the kernels one call
    launches, exactly ``records * calls``); with ``counted`` (a kernel of
    ``build.LAUNCHES``), the records of that kernel must number its
    launches during ``run``.  On the H100 machine CUPTI has dropped
    records (all of them, or some at a session's end) in a process that
    had already run many profiled or unprofiled launches; such a session
    is repeated, up to ``attempts`` times in all, and then this raises."""
    from repro_torch.kernels import build

    symbol = KERNEL_SYMBOLS.get(counted)
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        before = build.LAUNCHES[counted] if counted else 0
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        us = sum(e.self_device_time_total for e in averages)
        n = sum(e.count for e in averages if e.self_device_time_total > 0)
        complete = us > 0 and n % calls == 0
        if records:
            complete = complete and n == records * calls
        if counted:
            launched = build.LAUNCHES[counted] - before
            recorded = sum(e.count for e in averages if symbol in e.key)
            complete = complete and recorded == launched
        if complete:
            return us, averages
        print(f"profiler: {n} kernels, {us} us recorded for {calls} calls "
              f"(session {attempt} of {attempts}): "
              f"{ {e.key[:60]: e.count for e in averages} }", file=sys.stderr)
        time.sleep(1.0)
    raise RuntimeError("check failed: the profiler lost device records")


def device_ms(fn, iters: int = 50, records: int = None) -> float:
    """Device time of one call of ``fn``: the durations of the kernels it
    launched, from the profiler, over ``iters`` calls."""
    for _ in range(min(5, iters)):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return profiled(run, calls=iters, records=records)[0] / 1e3 / iters


def busy(fn, wall_ms: float, counted: str = None) -> dict:
    """Device time of the kernels of one call of ``fn`` (profiled run),
    and its share of ``wall_ms``, the same call's unprofiled wall time
    (the profiler stretches the wall time of the run it traces); the five
    kernels with the most device time in that run; with ``counted``, the
    device time of that kernel's records."""
    us, averages = profiled(fn, counted=counted)
    top = sorted(averages, key=lambda e: -e.self_device_time_total)[:5]
    out = {"device_busy_ms": us / 1e3, "wall_ms": wall_ms,
           "busy_share": us / 1e3 / wall_ms,
           "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                              for e in top}}
    if counted:
        out[f"{counted}_ms"] = sum(
            e.self_device_time_total for e in averages
            if KERNEL_SYMBOLS[counted] in e.key) / 1e3
    return out


def timed(fn, iters: int = 200, records: int = None) -> dict:
    """``ms``: device time per call (profiler); ``call_ms``: CUDA-event
    time per call over back-to-back calls, which includes the host's
    launch overhead when the host is slower than the device."""
    return {"ms": device_ms(fn, min(50, iters), records),
            "call_ms": time_ms(fn, iters)}


def host_timed(fn):
    """``(fn(), host ms)`` around a synchronized call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def flash_inputs(gen, dev, b, h, kv, s, t, d, dtype, model_layout=False):
    """q (b, h, s, d), k and v (b, kv, t, d); with ``model_layout``, the
    strided views the LM path passes: (b, s, h, d) projections and a
    (b, t, kv, d) cache, each seen through ``.transpose(1, 2)``."""
    if not model_layout:
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d))]
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            .transpose(1, 2)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


def flash_share(out, ref) -> tuple:
    """``(max |out - ref|, the largest share of its tolerance that an
    element uses)``, the tolerance ``FLASH_TOL`` of ``out``'s dtype."""
    atol, rtol = FLASH_TOL[out.dtype]
    diff = (out.double() - ref.double()).abs()
    return (float(diff.max()),
            float((diff / (atol + rtol * ref.double().abs())).max()))


class FlashReplay:
    """While active, each flash call of ``models/attention.py`` runs the
    kernel, and the kernel's output on the call's operands is held within
    ``FLASH_TOL`` of the plain version's: at once, or, with ``keep=n``,
    for the first ``n`` calls after the run, their operands cloned (a
    decode's cache moves on under them) and launched again by
    :meth:`replay`.  ``log`` keeps each checked call's variant, keywords,
    largest |err| and largest share of the tolerance; ``read`` sums it per
    variant.  A replay launches after the counted run and the plain
    version launches no kernel, so the counts are the path's."""

    def __init__(self, what: str, keep=None):
        self.what, self.keep, self.kept, self.log = what, keep, [], []

    def _check(self, q, k, v, kw, out):
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.kernels.flash_attention.ref import \
            flash_attention_ref

        variant = ops.plan(q, k, v).variant
        err, share = flash_share(out, flash_attention_ref(q, k, v, **kw))
        check(share <= 1.0 and bool(torch.isfinite(out).all()),
              f"{self.what}: flash {variant} {tuple(q.shape)} over "
              f"{tuple(k.shape)} {kw}: max |err| {err}, {share} of "
              f"FLASH_TOL")
        self.log.append((variant, kw, err, share))

    @property
    def read(self) -> dict:
        out = {}
        for variant, _, err, share in self.log:
            r = out.setdefault(variant, [0, 0.0, 0.0])
            r[0], r[1], r[2] = r[0] + 1, max(r[1], err), max(r[2], share)
        return out

    def replay(self) -> dict:
        from repro_torch.kernels.flash_attention import ops

        for (q, k, v), kw in self.kept:
            self._check(q, k, v, kw, ops.flash_attention(q, k, v, **kw))
        self.kept = []
        return self.read

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.models import attention as attn

        def call(q, k, v, **kw):
            out = ops.flash_attention(q, k, v, **kw)
            if self.keep is None:
                self._check(q, k, v, kw, out)
            elif len(self.kept) < self.keep:
                self.kept.append(([x.detach().clone() for x in (q, k, v)],
                                  kw))
            return out

        attn.flash_attention = call
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.models import attention as attn

        attn.flash_attention = ops.flash_attention
        return False


def check_flash(gen, dev) -> float:
    """Phase 6: the kernels against their plain version, each case run
    twice and equal to itself bit for bit; returns max |err|."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    # (b, h, kv, s, t, d, causal, window, cap, kv_len, dtype, model layout)
    cases = [(b, h, kv, s, t, d, c, w, cap, None, dt, False)
             for (b, h, kv, s, t, d, c, w, cap) in (
                 (2, 4, 2, 64, 64, 32, True, None, None),
                 (1, 4, 4, 40, 40, 16, True, None, 50.0),
                 (2, 8, 2, 32, 96, 32, False, None, None),
                 (1, 4, 1, 64, 64, 32, True, 16, None),
                 (1, 2, 2, 16, 128, 64, True, None, None))
             for dt in (torch.float32, torch.bfloat16)]
    steps = LM_PROMPT + LM_TOTAL
    cases += [(LM_BATCH, 32, 8, 1, steps, 128, False, None, None, kl,
               torch.bfloat16, True) for kl in (1, 37, steps)]
    cases.append((LM_BATCH, 32, 8, steps, steps, 128, True, None, None, None,
                  torch.bfloat16, True))
    cases.append((1, 32, 8, 4096, 4096, 128, True, None, None, None,
                  torch.bfloat16, True))
    # recurrentgemma-9b: 16 query heads over 1 KV head of 256; ring
    # decode, full rings (as after a wrap) of phase 13's 16 slots and the
    # window's 2048, scoring inside the window; and fp32 at head dim 256
    for dt in (torch.bfloat16, torch.float32):
        cases += [(LM_BATCH, 16, 1, 1, steps, 256, False, None, None, kl, dt,
                   True) for kl in ((1, 37, steps) if dt == torch.bfloat16
                                    else (37,))]
        cases.append((LM_BATCH, 16, 1, steps, steps, 256, True, 2048, None,
                      None, dt, True))
    cases += [(LM_BATCH, 16, 1, 1, w, 256, False, None, None, w,
               torch.bfloat16, True) for w in (RG_CHECK_WINDOW, 2048)]
    # decode over long caches, split over KV: kv_len 37 leaves whole
    # splits empty; the ring of 2048 as it fills
    cases += [(LM_BATCH, 32, 8, 1, t, 128, False, None, None, kl,
               torch.bfloat16, True) for t in (2048, 4096)
              for kl in (1, 37, t)]
    cases.append((LM_BATCH, 16, 1, 1, 2048, 256, False, None, None, 37,
                  torch.bfloat16, True))
    # scoring at S = 70 (ragged tiles), plain and with a window shorter
    # than S, at both tensor-core head dims the paths use
    cases += [(2, h, kv, 70, 70, d, True, w, None, None, torch.bfloat16,
               True) for h, kv, d in ((32, 8, 128), (16, 1, 256))
              for w in (None, 24)]
    # gemma2-27b's training shape (phase 21 (b)): 32 query heads over 16
    # KV heads of 128, attention softcap 50, on the scoring kernel, the
    # local layer's window cut to LM_BF16_WINDOW and the global layer
    cases += [(LM_FULL_ROWS, 32, 16, LM_FULL_SEQ, LM_FULL_SEQ, 128, True, w,
               50.0, None, torch.bfloat16, True)
              for w in (LM_BF16_WINDOW, None)]
    # llama4-maverick-400b-a17b (phase 22 (c)): 40 query heads over 8 KV
    # heads of 128, a group of 5 (5 of the decode tile's 16 rows live);
    # decode over its cache of MOE_PROMPT + MOE_NEW, and its scoring
    steps = MOE_PROMPT + MOE_NEW
    cases += [(MOE_ROWS, 40, 8, 1, steps, 128, False, None, None, kl,
               torch.bfloat16, True) for kl in (1, 17, steps)]
    cases.append((MOE_ROWS, 40, 8, steps, steps, 128, True, None, None, None,
                  torch.bfloat16, True))
    # phase 23's encoders and cross-attention, non-causal over all T keys:
    # whisper-medium's encoder (scoring at D 64) and its cross calls at the
    # prompt (S·G = 16: decode) and in decode; llama-3.2-vision-11b's
    # cross calls at the prompt (S·G = 64: scoring with S != T and a
    # ragged query tile) and in decode; a longer whisper prompt (scoring
    # at D 64, ragged tiles on both axes)
    cases += [(b, h, kv, s, t, d, False, None, None, None, torch.bfloat16,
               True) for (b, h, kv, s, t, d) in (
                   (ENC_ROWS, 16, 16, ENC_FRAMES, ENC_FRAMES, 64),
                   (ENC_ROWS, 16, 16, ENC_PROMPT, ENC_FRAMES, 64),
                   (ENC_ROWS, 16, 16, 1, ENC_FRAMES, 64),
                   (ENC_ROWS, 32, 8, ENC_PROMPT, VISION_CTX, 128),
                   (ENC_ROWS, 32, 8, 1, VISION_CTX, 128),
                   (2, 16, 16, 70, ENC_FRAMES, 64))]
    worst, used = 0.0, {}
    for (b, h, kv, s, t, d, causal, window, cap, kv_len, dtype,
         layout) in cases:
        q, k, v = flash_inputs(gen, dev, b, h, kv, s, t, d, dtype, layout)
        kw = dict(causal=causal, window=window, softcap=cap, kv_len=kv_len)
        out = flash_attention(q, k, v, **kw)
        again = flash_attention(q, k, v, **kw)
        ref = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"flash_attention {(b, h, kv, s, t, d, causal, window, cap, kv_len)} "
              f"{dtype}: two calls differ")
        err, share = flash_share(out, ref)
        worst = max(worst, err)
        atol, rtol = FLASH_TOL[dtype]
        used[str(dtype)] = max(used.get(str(dtype), 0.0), share)
        check(share <= 1.0 and out.dtype == dtype
              and torch.isfinite(out).all(),
              f"flash_attention {(b, h, kv, s, t, d, causal, window, cap, kv_len)} "
              f"{dtype}: max |err| {err}, {share:.3f} of (atol {atol}, "
              f"rtol {rtol})")
    print(f"flash_attention equals its plain version: {len(cases)} cases "
          f"(each twice, bit-identical), max |err| {worst:.3e}, largest "
          f"share of the tolerance used {json.dumps(used)}")
    return worst


def guided_relay(dev, fam_card, fam_cpu, noise, cond) -> dict:
    """Phase 4, guidance: F3's s = 15 relay through ``execute_program``
    over ``make_program(..., guidance=3.5)`` with an unconditional input,
    raw, int8 unfused and int8 fused, on the card and on the CPU from the
    same host noise; and the same relays unguided.  The unconditional
    input is zeros of the conditioning's shape: a test input, not the
    families' null prompt."""
    from repro_torch.core.program import make_program
    from repro_torch.core.relay import execute_program
    from repro_torch.diffusion.families import role_fn, role_params
    from repro_torch.kernels import build

    spec = fam_card.spec
    cond = torch.as_tensor(cond, dtype=torch.float32)
    uncond = torch.zeros_like(cond)
    s = 15
    route = [("large", "p0", s), ("small", "p1", None)]
    net_calls = [0]

    def counting(fn):
        def call(*args):
            net_calls[0] += 1
            return fn(*args)
        return call

    res, table = {}, {}
    for mode in ("raw", "unfused", "fused"):
        compress = mode != "raw"
        for where, fam in (("card", fam_card), ("cpu", fam_cpu)):
            place = dev if where == "card" else torch.device("cpu")
            models = {r: (counting(role_fn(fam, r)), role_params(fam, r))
                      for r in ("large", "small")}
            for g in (GUIDANCE, 1.0):
                prog = make_program(spec, route, guidance=g, compress=compress)
                net_calls[0] = 0
                before = build.LAUNCHES["fused_cfg_step"]
                with torch.inference_mode():
                    out, info = execute_program(
                        spec, prog, models, noise.to(place), cond.to(place),
                        uncond=uncond.to(place), fused_boundary=mode == "fused")
                res[mode, where, g] = {
                    "out": out.cpu(), "bytes": info["transfer_bytes"],
                    "launches": build.LAUNCHES["fused_cfg_step"] - before,
                    "net_calls": net_calls[0]}
        steps = prog.total_steps
        want_launches = steps - (2 if mode == "fused" else 0)
        card, cpu = res[mode, "card", GUIDANCE], res[mode, "cpu", GUIDANCE]
        plain = res[mode, "card", 1.0]
        rel = norm_rel(card["out"], cpu["out"])
        plain_rel = norm_rel(plain["out"], res[mode, "cpu", 1.0]["out"])
        moved = norm_rel(card["out"], plain["out"])
        table[mode] = {"card_vs_cpu_rel": rel, "unguided_card_vs_cpu_rel":
                       plain_rel, "guided_vs_unguided_rel": moved,
                       "bytes": card["bytes"], "launches": card["launches"],
                       "net_calls": card["net_calls"]}
        tol = COMPRESSED_RTOL if compress else RAW_RTOL
        check(rel <= tol and plain_rel <= tol,
              f"guided F3 relay ({mode}): card vs CPU rel {rel} "
              f"({plain_rel} unguided)")
        check(card["bytes"] == cpu["bytes"] == plain["bytes"],
              f"guided F3 relay ({mode}): bytes {card['bytes']}, "
              f"CPU {cpu['bytes']}, unguided {plain['bytes']}")
        check(card["launches"] == plain["launches"] == want_launches,
              f"guided F3 relay ({mode}): {card['launches']} interior-step "
              f"launches ({plain['launches']} unguided), want {want_launches}")
        # both nets on every step when guided, the conditional one alone
        # at g = 1
        check(card["net_calls"] == cpu["net_calls"] == 2 * steps
              and plain["net_calls"] == steps,
              f"guided F3 relay ({mode}): {card['net_calls']} net calls "
              f"({plain['net_calls']} unguided) over {steps} steps")
        check(bool(torch.isfinite(card["out"]).all()) and moved > 0.5,
              f"guided F3 relay ({mode}): guided vs unguided rel {moved}")
    print(f"guided F3 relay (s={s}, g={GUIDANCE}, uncond = zeros, 2 requests):"
          f" {json.dumps(table)}")
    return table


def step_times(dev, gen, floor_ms) -> dict:
    """Phase 5: the interior step's times, rf: at the path's shape as the
    relay calls it (fp32, g = 1, eps_u is eps_c), guided there (g = 3.5,
    eps_u its own tensor), and guided at (8192, 4096) in fp32 and bf16;
    beside the plain version's, the bound and the launch floor.  No single
    PyTorch call computes the step: the library time is the pair
    ``torch.lerp`` (the combine) and ``torch.add(alpha=)`` (the update)."""
    from repro_torch.kernels.fused_sampler import ops as fops
    from repro_torch.kernels.fused_sampler import ref as fref

    rows = {}
    for name, shape, dtype, g in (
            ("path", (8, 8, 8, 4), torch.float32, 1.0),
            ("path_guided", (8, 8, 8, 4), torch.float32, GUIDANCE),
            ("hbm_fp32", (8192, 4096), torch.float32, GUIDANCE),
            ("hbm_bf16", (8192, 4096), torch.bfloat16, GUIDANCE)):
        x, ec, eu = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for _ in range(3))
        if g == 1.0:
            eu = ec  # the relay's call: the unconditional net is not run
        kw = dict(guidance=g, c1=RF_DT, c2=0.0, mode="rf")
        kern = timed(lambda: fops.fused_cfg_step(x, ec, eu, **kw), records=1)
        plain = timed(lambda: fref.fused_cfg_step_ref(x, ec, eu, **kw))
        lib = timed(lambda: torch.add(x, torch.lerp(eu, ec, g), alpha=RF_DT),
                    records=2)
        b_ms, b_by = rl.bound(rl.step_work(x.numel(), x.element_size(),
                                           2 if eu is ec else 3))
        f_ms, f_by = max((b_ms, b_by), (floor_ms, "launch"))
        rows[name] = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                      "guidance": g, "ms": kern["ms"],
                      "call_ms": kern["call_ms"], "plain_ms": plain["ms"],
                      "plain_call_ms": plain["call_ms"],
                      "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
                      "bound_ms": b_ms, "bound_by": b_by,
                      "floor_ms": f_ms, "floor_by": f_by}
    print(f"fused_cfg_step times, rf (library: lerp + add, two calls): "
          f"{json.dumps(rows)}")
    return rows


def emit_times(dev, gen, floor_ms) -> list:
    """Phase 5: the emit (fp32, ddim, g = 1) at ``EMIT_TIME_SHAPES``: the
    plan's route and shape, the device and call times beside the plain
    version's, the bound and the floor; beside the plan, at L = 64 a half
    warp per row (4 values a lane, 16-byte loads), on the cluster route
    each cluster size (each equal to the plain version bit for bit)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_sampler import ops as fops
    from repro_torch.kernels.fused_sampler import ref as fref

    coeffs = torch.tensor([0.4, 0.6], device=dev)

    def launch(plan, x, ec):  # the wrapper's launch, on another plan
        rows, length = x.shape
        q = torch.empty(x.shape, dtype=torch.int8, device=dev)
        s = torch.empty(rows, 1, device=dev)
        build.launch("fused_cfg_step_quant", dev, x.data_ptr(), ec.data_ptr(),
                     ec.data_ptr(), build.dtype_code(x), coeffs.data_ptr(), 1.0,
                     build.MODES["ddim"], q.data_ptr(), s.data_ptr(), rows,
                     length, fops.EMIT_ROUTES.index(plan.route), plan.vec,
                     plan.per_thread, plan.threads, plan.cluster)
        return q, s

    def variant(plan, x, ec, ref):
        q, s = launch(plan, x, ec)
        check(torch.equal(q, ref[0]) and torch.equal(s, ref[1]),
              f"emit on {plan} differs from its plain version")
        return timed(lambda: launch(plan, x, ec))["ms"]

    out = []
    for rows, length in EMIT_TIME_SHAPES:
        x, ec = (torch.randn(rows, length, generator=gen, device=dev)
                 for _ in range(2))
        plan = fops.emit_plan(rows, length, x.dtype, [x.data_ptr(), ec.data_ptr()])
        b_ms, b_by = rl.bound(rl.boundary_work("fused_cfg_step_quant", rows,
                                               length, 4, 1.0))
        k = timed(lambda: fops.fused_cfg_step_quant(x, ec, ec, coeffs))
        p = timed(lambda: fref.fused_cfg_step_quant_ref(
            x, ec, ec, coeffs, guidance=1.0, mode="ddim"))
        floor, floor_by = max((b_ms, b_by), (floor_ms, "launch"))
        row = {"shape": [rows, length], **dataclasses.asdict(plan),
               "ms": k["ms"], "call_ms": k["call_ms"], "plain_ms": p["ms"],
               "plain_call_ms": p["call_ms"], "bound_ms": b_ms,
               "bound_by": b_by, "floor_ms": floor, "floor_by": floor_by,
               "share_of_floor": floor / k["ms"]}
        ref = fref.fused_cfg_step_quant_ref(x, ec, ec, coeffs, guidance=1.0,
                                            mode="ddim")
        if length == WIRE_LEN:
            row["half_warp_ms"] = variant(dataclasses.replace(
                plan, vec=4, per_thread=4, threads=16), x, ec, ref)
        if plan.route == "cluster":
            row["cluster_ms"] = {c: variant(dataclasses.replace(plan, cluster=c),
                                            x, ec, ref) for c in (1, 2, 4, 8)}
        out.append(row)
    print(f"emit (fp32, ddim, g = 1) by shape: {json.dumps(out)}")
    return out


def count_launches(what: str, fn, want: dict, total: dict):
    """``fn()`` with every kernel's launch count set to 0 just before it:
    the launches must equal ``want``, and are added to ``total``.  Returns
    ``fn``'s result and the launches."""
    from repro_torch.kernels import build

    build.reset_launches()
    out = fn()
    got = dict(build.LAUNCHES)
    check(got == want, f"{what}: launches {got}, want {want}")
    for k in total:
        total[k] += got[k]
    return out, got


def dag_call_launches(plan, fused: bool, rf: bool) -> dict:
    """Phase 15: each kernel's launches in one call of a DAG plan, from the
    plan.  A DAG node's emit needs the payload's Eq. 1 deviation, so it is
    the step, the quant kernel and the dequant kernel (``core/boundary.py``'s
    accounting flavors), never the fused emit kernel: one per node with
    compressed out-edges.  Each fused consume is the peek (dequant) and the
    consume kernel.  Unfused, each compressed hop is a quant and dequant
    round trip.  The interior step runs every rf step but the emits' and
    the consumes'."""
    hops = [e for e in plan.edge_order
            if e.handoff is not None and e.handoff.compress]
    check(all(plan.nodes[plan.index[e.dst]].kind == "segment"
              and e.handoff.quantizer == "rowwise" for e in hops),
          "a compressed edge into a join or off the rowwise wire")
    emitters = {e.src for e in hops}
    steps = sum(n.segment.steps for n in plan.nodes if n.kind == "segment")
    want = dict.fromkeys(KERNELS, 0)
    if fused:
        want.update(fused_cfg_step_dequant=len(hops), quant_int8=len(emitters),
                    dequant_int8=len(emitters) + len(hops))
        steps -= len(emitters) + len(hops)
    else:
        want.update(quant_int8=len(hops), dequant_int8=len(hops))
    want["fused_cfg_step"] = steps if rf else 0
    return want


class SharedInputs:
    """Phase 15 and ``tests/test_torch_dag.py``: while active, keeps every
    input that a fused consume (``boundary.dequant_step``'s payload) or an
    unfused hop (``relay.latent_roundtrip``'s latent) read, beside a copy
    taken when it read it."""

    def __enter__(self):
        from repro_torch.core import boundary
        from repro_torch.core import relay

        self.seen, self.saved = [], (boundary.dequant_step,
                                     relay.latent_roundtrip)
        step, roundtrip = self.saved

        def dequant_step(kind, fn, params, qs, *args, **kw):
            self.seen += [("payload", qs["q"], qs["q"].clone()),
                          ("scales", qs["s"], qs["s"].clone())]
            return step(kind, fn, params, qs, *args, **kw)

        def latent_roundtrip(x, quantizer="rowwise"):
            self.seen.append(("latent", x, x.clone()))
            return roundtrip(x, quantizer)

        boundary.dequant_step = dequant_step
        relay.latent_roundtrip = latent_roundtrip
        return self

    def __exit__(self, *exc):
        from repro_torch.core import boundary
        from repro_torch.core import relay

        boundary.dequant_step, relay.latent_roundtrip = self.saved

    def readers(self, kind) -> int:
        """The most consumers that read one input of ``kind``, once every
        input is checked to have kept its bits."""
        for what, t, copy in self.seen:
            check(torch.equal(t, copy), f"a shared {what} changed after a "
                  "consumer read it")
        ids = [id(t) for what, t, _ in self.seen if what == kind]
        return max((ids.count(i) for i in ids), default=0)


def dag_phase(dev, seeds, served_out, linear) -> dict:
    """Phase 15: DAG relay execution on the trained families (mid weights
    included), 8 requests through ``generate_bucketed``.  ``served_out`` and
    ``linear`` are phase 3's outputs and its (executor, arms, key suffix)
    triples, for the chain twins.  Returns the DAG path's launches."""
    from repro_torch.core.program import (compile_plan, linear_graph,
                                          make_program)
    from repro_torch.core.relay import execute_graph
    from repro_torch.diffusion import synth
    from repro_torch.diffusion.families import (load_families, role_fn,
                                                role_params)
    from repro_torch.serving.arms import (FAMILY_POOLS, Arm,
                                          dag_action_space, relay_program,
                                          speculative_program)
    from repro_torch.serving.executor import Executor

    fams = load_families(CKPTS, with_mid=True, device=dev)
    cpu_fams = load_families(CKPTS, with_mid=True, device="cpu")
    space = dag_action_space()
    dag = space[11:]
    ex = {f: Executor(fams, arms=space, fused_boundary=f, device=dev)
          for f in (True, False)}
    cpu_ex = {f: Executor(cpu_fams, arms=space, fused_boundary=f,
                          device="cpu") for f in (True, False)}
    tag = {True: "", False: "|unfused"}

    def is_spec(arm):
        return any(n.kind == "select" for n in arm.program.nodes)

    def steps_of(arm):  # (s, s_spec) of a speculative arm, (s,) otherwise
        g = arm.program
        if is_spec(arm):
            return g.node("edge+").segment.stop, g.node("edge").segment.stop
        return (g.node("edge").segment.stop,)

    def twin(arm, route_steps, mid=False):
        """A linear int8 arm with ``arm``'s index (so the same noise)."""
        fam = arm.program.family
        name = "sdxl+vega" if fam == "XL" else "sd35L+M"
        if not mid:
            return Arm(arm.idx, relay_program(fam, route_steps, compress=True),
                       f"{name}@s={route_steps}|int8")
        pools = FAMILY_POOLS[fam]
        return Arm(arm.idx, make_program(
            fams[fam].spec, [("large", pools["large"], route_steps),
                             ("mid", pools["mid"], None)], compress=True),
            f"{name}@s={route_steps}|mid|int8")

    # -- the path: each DAG arm fused and unfused, then the quality table;
    # exact launches per call, each count set to 0 just before its call
    total = dict.fromkeys(KERNELS, 0)
    per_call, outs = {}, {}

    def counted_call(key, fn, want):
        out, got = count_launches(key, fn, want, total)
        per_call[key] = {k: v for k, v in got.items() if v}
        return out

    for arm in dag:
        plan = compile_plan(arm.program)
        rf = fams[arm.program.family].spec.kind == "rf"
        for fused in (True, False):
            key = arm.label + tag[fused]
            out = counted_call(
                key, lambda: ex[fused].generate_bucketed(arm, seeds),
                dag_call_launches(plan, fused, rf))
            check(out.shape == (8, 8, 8, 4) and np.isfinite(out).all(),
                  f"{key}: output shape {out.shape} or non-finite values")
            outs[key] = out
        a, b = outs[arm.label], outs[arm.label + "|unfused"]
        check(np.array_equal(a, b), f"{arm.label}: fused vs unfused differ "
              f"by {float(np.abs(a - b).max())}")
    want = dict.fromkeys(KERNELS, 0)
    for arm in dag:
        for k, v in dag_call_launches(
                compile_plan(arm.program), True,
                fams[arm.program.family].spec.kind == "rf").items():
            want[k] += v
    table = counted_call("quality_table", lambda: ex[True].quality_table(
        seeds, arms=dag), want)
    for arm in dag:
        for m in table[:, arm.idx]:
            check(np.isfinite(list(m.values())).all(),
                  f"{arm.label}: non-finite quality {m}")
    check(total["fused_cfg_step_quant"] == 0
          and all(total[k] > 0 for k in DIFFUSION_KERNELS
                  if k != "fused_cfg_step_quant"),
          f"the DAG path's launches {total}")
    print(f"DAG path launches per 8-request call (exact, from the plan): "
          f"{json.dumps(per_call)}")
    print(f"DAG path launches (each DAG arm fused and unfused, then the "
          f"quality table): {json.dumps(total)}")
    print(f"DAG fused vs unfused: bit-identical on all {len(dag)} arms")
    quality = {arm.label: {k: float(np.mean([m[k] for m in table[:, arm.idx]]))
                           for k in table[0, arm.idx]} for arm in dag}
    print(f"DAG quality (mean proxies, 8 requests): {json.dumps(quality)}")

    # -- forced Select and the merge against linear int8 arms on the same
    # noise, fused and unfused
    forced = {}
    for arm in dag:
        for fused in (True, False):
            gen = ex[fused].generate_bucketed
            if is_spec(arm):
                s, s_spec = steps_of(arm)
                for bound, kept in ((0.0, s), (1e9, s_spec)):
                    key = f"{arm.label}|bound={bound:g}{tag[fused]}"
                    a = gen(Arm(arm.idx, speculative_program(
                        arm.program.family, s, s_spec, bound_pct=bound),
                        key), seeds)
                    b = gen(twin(arm, kept), seeds)
                    forced[key] = {"kept_s": kept,
                                   "max_abs_diff": float(np.abs(a - b).max())}
                    check(np.array_equal(a, b), f"{key} vs the int8 relay "
                          f"at s={kept}: {forced[key]}")
                    outs[key] = a
            else:
                (s,) = steps_of(arm)
                key = arm.label + tag[fused]
                d, r = (gen(twin(arm, s, mid), seeds) for mid in (False, True))
                mean = (d + r) / np.float32(2.0)
                forced[key] = {"max_abs_diff": float(np.abs(outs[key] - mean).max())}
                check(np.array_equal(outs[key], mean),
                      f"{key} vs the mean of its branch chains: {forced[key]}")
    for key in [k for k in outs if "|bound=" in k and not k.endswith("unfused")]:
        check(np.array_equal(outs[key], outs[key + "|unfused"]),
              f"{key}: fused vs unfused differ")
    print(f"forced Select (bound 0: the int8 relay at s; 1e9: at s_spec) and "
          f"the Merge (the mean of its branch chains), bit for bit: "
          f"{json.dumps(forced)}")

    # -- the default-bound Select: execute_graph on the path's inputs gives
    # its deviation, bound and winner; the executor's output is the int8
    # relay of the branch it kept
    default = {}
    for arm in dag:
        fam = arm.program.family
        models = {r: (role_fn(fams[fam], r), role_params(fams[fam], r))
                  for r in ("large", "mid", "small")}
        noise = ex[True].noise(arm, seeds, per_sample=True).to(dev)
        cond = torch.as_tensor(synth.batch(seeds, fam)[2]).to(dev)
        with torch.inference_mode():
            x, info = execute_graph(fams[fam].spec, arm.program, models, noise,
                                    cond, fused_boundary=True)
        x = x.cpu().numpy()
        check(np.array_equal(x, outs[arm.label]),
              f"{arm.label}: execute_graph vs the pipeline differ by "
              f"{float(np.abs(x - outs[arm.label]).max())}")
        if not is_spec(arm):
            continue
        (j,) = info["joins"]
        s, s_spec = steps_of(arm)
        kept = s_spec if j["accepted"] else s
        b = ex[True].generate_bucketed(twin(arm, kept), seeds)
        check(np.array_equal(outs[arm.label], b),
              f"{arm.label}: the output is not the int8 relay at s={kept}")
        default[arm.label] = {"winner": j["winner"], "kept_s": kept,
                              "deviation_pct": j["deviation_pct"],
                              "bound_pct": j["bound_pct"],
                              "bytes": info["transfer_bytes"]}
    print(f"default-bound Select over 8 requests (execute_graph on the card, "
          f"equal to the pipeline bit for bit; the pipeline's output equal "
          f"to the int8 relay it kept): {json.dumps(default)}")

    # -- the chain twins of the 21 linear arms: the linear arms' bits, no
    # pipeline added
    n_twins = 0
    for exl, arms, suffix in linear:
        before = len(exl._pipelines)
        for a in arms:
            t = exl.generate_bucketed(Arm(a.idx, linear_graph(a.program),
                                          a.label), seeds)
            check(np.array_equal(t, served_out[a.label + suffix]),
                  f"{a.label}{suffix}: chain twin differs")
            n_twins += 1
        check(len(exl._pipelines) == before,
              f"chain twins added pipelines: {before} -> {len(exl._pipelines)}")
    print(f"chain-graph twins equal their linear arms bit for bit: {n_twins} "
          f"calls, no pipeline added")

    # -- straggler re-runs: a lone request and a pair against their rows
    lone = {}
    for arm in dag:
        for fused in (True, False):
            key = arm.label + tag[fused]
            for what, subset in (("one_row", [5]), ("two_rows", [6, 2])):
                rerun = ex[fused].generate_bucketed(arm, seeds, subset=subset)
                lone[f"{key}|{what}"] = float(
                    np.abs(rerun - outs[key][subset]).max())
                check(np.array_equal(rerun, outs[key][subset]),
                      f"{key}: {what} re-run differs by {lone[f'{key}|{what}']}")
    print(f"DAG straggler re-runs vs their rows of 8, max |diff|: "
          f"{json.dumps(lone)}")

    # -- shared inputs keep their bits: the ensemble's edge payload (fused)
    # or latent (unfused), read by both branches; and one initial latent
    # fed to the source nodes of several plans in turn
    ens = next(a for a in dag if not is_spec(a))
    readers = {}
    for fused in (True, False):
        with SharedInputs() as rec:
            ex[fused].generate_bucketed(ens, seeds)
            readers[ens.label + tag[fused]] = rec.readers(
                "payload" if fused else "latent")
    check(set(readers.values()) == {2},
          f"the ensemble's edge output is not read by both branches: {readers}")
    spec_arm = dag[0]
    x0 = ex[True].noise(spec_arm, seeds, per_sample=True).to(dev)
    kept = x0.clone()
    _, _, cond = synth.batch(seeds, spec_arm.program.family)
    for fused in (True, False):
        for a in (spec_arm, twin(spec_arm, steps_of(spec_arm)[0]),
                  twin(spec_arm, steps_of(spec_arm)[1])):
            ex[fused].run(a, x0, cond)
    check(torch.equal(x0, kept), "the initial latent changed")
    print(f"shared inputs kept their bits: the ensemble's edge output read by "
          f"{json.dumps(readers)} consumers; one initial latent through "
          f"6 runs of 3 plans")

    # -- card against CPU, 2 requests: execute_graph and the executor
    worst = {}
    for arm in dag:
        fam = arm.program.family
        noise = ex[True].noise(arm, seeds[:2], per_sample=True)
        cond = torch.as_tensor(synth.batch(seeds[:2], fam)[2])
        for fused in (False, True):
            key = arm.label + tag[fused]
            a = ex[fused].run(arm, noise, cond).cpu().numpy()
            b = cpu_ex[fused].run(arm, noise, cond).numpy()
            served_rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            res = {}
            for where, place, fm in (("card", dev, fams), ("cpu", "cpu",
                                                           cpu_fams)):
                models = {r: (role_fn(fm[fam], r), role_params(fm[fam], r))
                          for r in ("large", "mid", "small")}
                with torch.inference_mode():
                    x, info = execute_graph(
                        fm[fam].spec, arm.program, models, noise.to(place),
                        cond.to(place), fused_boundary=fused)
                res[where] = (x.cpu().numpy(), info)
            (xa, ia), (xb, ib) = res["card"], res["cpu"]
            rel = float(np.linalg.norm(xa - xb) / np.linalg.norm(xb))
            joins, tie = [], False
            for ja, jb in zip(ia["joins"], ib["joins"]):
                row = {"node": ja["node"], "kind": ja["kind"]}
                if ja["kind"] == "select":
                    near = abs(jb["deviation_pct"] - jb["bound_pct"]) \
                        < SELECT_TIE * jb["bound_pct"]
                    tie = tie or near
                    row.update({
                        "winner": [ja["winner"], jb["winner"]],
                        "deviation_pct": [ja["deviation_pct"],
                                          jb["deviation_pct"]],
                        "bound_pct": [ja["bound_pct"], jb["bound_pct"]],
                        "tie": near})
                    check(near or ja["winner"] == jb["winner"],
                          f"{key}: the card kept {ja['winner']}, the CPU "
                          f"{jb['winner']}")
                    check(all(abs(ja[k] - jb[k]) <= DEV_RTOL * abs(jb[k])
                              for k in ("deviation_pct", "bound_pct")),
                          f"{key}: join {row}")
                joins.append(row)
            worst[key] = {"rel": rel, "served_rel": served_rel,
                          "bytes": [ia["transfer_bytes"], ib["transfer_bytes"]],
                          "joins": joins}
            check(ia["transfer_bytes"] == ib["transfer_bytes"],
                  f"{key}: bytes {worst[key]['bytes']}")
            check(tie or (rel <= COMPRESSED_RTOL
                          and served_rel <= COMPRESSED_RTOL),
                  f"{key}: card vs CPU {worst[key]}")
    print(f"DAG card vs CPU (2 requests; rel: execute_graph, served_rel: the "
          f"executor): {json.dumps(worst)}")

    # -- times: ms per request of each DAG arm beside its int8 twin (the
    # relay at s), in turns; the busy share of one run
    pairs = [(arm, twin(arm, steps_of(arm)[0])) for arm in dag]
    arm_ms = {}
    for turn in range(DAG_TURNS):
        for pair in pairs:
            for a in (pair if turn % 2 == 0 else pair[::-1]):
                _, ms = host_timed(lambda: ex[True].generate_bucketed(a, seeds))
                arm_ms.setdefault(a.label, []).append(ms / len(seeds))
    print(f"DAG ms per request (8-request bucket, {DAG_TURNS} runs in turns) "
          f"beside the int8 twins: {json.dumps(arm_ms)}")
    shares = {a.label: busy(lambda: ex[True].generate_bucketed(a, seeds),
                            float(np.median(arm_ms[a.label])) * len(seeds),
                            counted="fused_cfg_step_dequant")
              for pair in pairs for a in pair}
    print(f"DAG device busy share of one 8-request run (profiled device time "
          f"over the median unprofiled wall time): {json.dumps(shares)}")
    return total


# ---- 16. the scheduler --------------------------------------------------


def warm_launches(families, boundary: bool, cached=()) -> dict:
    """Phase 16: each kernel's launches in one ``HandoffTransport`` call
    on the card, derived from the code: a family's first ``handoff_error``
    is one row-wise round trip (``quant_int8``, ``dequant_int8``), a cached
    one launches nothing; with ``boundary``, ``boundary.warm`` fires per
    family and sampler kind (ddim, rf) the ``"wire"`` emit (the emit
    kernel), the ``"wire_dev"`` emit (the step, a quant and a dequant), the
    peek (a dequant) and the consume (the consume kernel)."""
    want = dict.fromkeys(KERNELS, 0)
    fams = [f for f in families if f is not None]
    for fam in fams:
        if fam not in cached:
            want["quant_int8"] += 1
            want["dequant_int8"] += 1
    if boundary:
        kinds = 2 * len(fams)
        want["fused_cfg_step_quant"] += kinds
        want["quant_int8"] += kinds
        want["dequant_int8"] += 2 * kinds
        want["fused_cfg_step_dequant"] += kinds
    return want


def table_launches(ex) -> dict:
    """Phases 16 and 18: each kernel's launches in one ``quality_table``
    call of ``ex`` over its raw arms: one ``generate`` per arm over all
    requests, so the interior step launches on every step of each F3 (rf)
    arm, and no boundary kernel runs (raw arms have no int8 hop)."""
    want = dict.fromkeys(KERNELS, 0)
    want["fused_cfg_step"] = sum(
        a.program.total_steps for a in ex.arms
        if ex.families[a.program.family].spec.kind == "rf")
    return want


def ulps(a, b) -> int:
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    return int(np.abs(a - b).max()) if a.size else 0


def spacings(a, b, scale) -> float:
    """max |a − b| in fp32 spacings at |scale| (elementwise)."""
    gap = np.spacing(np.abs(np.asarray(scale, np.float32)))
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float((diff / gap).max()) if diff.size else 0.0


def transport_checks(dev, total) -> "HandoffTransport":
    """Phase 16, the transport: ``handoff_error`` card against CPU, exact
    launches on a first and a cached call, the quality deltas, ``warm``.
    Adds the launches to ``total``; returns the card's transport (both
    families measured)."""
    from repro_torch.quantization import latent_roundtrip
    from repro_torch.serving.runtime import HandoffTransport
    from repro_torch.serving.runtime.transport import handoff_latent

    card, cpu = HandoffTransport(device=dev), HandoffTransport(device="cpu")
    quality = {"clip": 0.31, "ir": -0.42, "pick": 0.21, "aes": 5.2, "ocr": 0.1}
    out = {}
    for fam in ("XL", "F3"):
        err, _ = count_launches(
            f"{fam} handoff_error", lambda: card.handoff_error(fam),
            warm_launches([fam], False), total)
        again, _ = count_launches(
            f"{fam} cached handoff_error", lambda: card.handoff_error(fam),
            warm_launches([fam], False, cached=(fam,)), total)
        ref = cpu.handoff_error(fam)
        x = torch.from_numpy(handoff_latent(fam))
        nbytes = [latent_roundtrip(x.to(dev))[1], latent_roundtrip(x)[1]]
        dq, dq_cpu = (t.quality_delta(fam, quality, n_hops=2)
                      for t in (card, cpu))
        dev_q, dev_q_cpu = (t.deviation_quality_delta(fam, quality, 9.716)
                            for t in (card, cpu))
        out[fam] = {"err": [err, ref], "rel": abs(err - ref) / ref,
                    "payload_bytes": nbytes,
                    "clip_delta": [dq["clip"], dq_cpu["clip"]]}
        check(again == err and abs(err - ref) <= 1e-6 * ref
              and nbytes[0] == nbytes[1]
              and all(abs(dq[k] - dq_cpu[k]) <= 1e-6 * abs(dq_cpu[k])
                      for k in quality)
              and dq["aes"] == quality["aes"] and dev_q == dev_q_cpu,
              f"{fam}: transport card vs CPU {out[fam]}")
    fresh = HandoffTransport(device=dev)
    fams = ["XL", "F3", None]
    count_launches("warm(boundary=True)",
                   lambda: fresh.warm(fams, boundary=True),
                   warm_launches(fams, True), total)
    count_launches("warm(boundary=False)",
                   lambda: fresh.warm(fams, boundary=False),
                   warm_launches(fams, False, cached=("XL", "F3")), total)
    print(f"transport, card vs CPU (handoff error, payload bytes of the "
          f"representative latent, clip after a 2-hop delta): "
          f"{json.dumps(out)}; warm(boundary=True) launches "
          f"{json.dumps({k: v for k, v in warm_launches(fams, True).items() if v})}, "
          f"warm(boundary=False) none")
    return card


def fig6_protocol(dev, ex, transport, total) -> dict:
    """Phase 16, the Fig. 6 offline protocol
    (``benchmarks/fig6_scheduler_comparison.py``) on the card's quality
    table: RISE, PPO, SAC, RR and Greedy trained on ``SCHED_TRAIN``
    requests and read on ``SCHED_HELD`` held-out ones, each learned policy
    on the card against the same policy on the CPU.  Returns the trained
    card RisePolicy (for the LinUCB checks), and the stream and the card's
    quality table (for phase 17)."""
    from repro_torch.core import linucb
    from repro_torch.core import policies as pol
    from repro_torch.core.context import context_vector
    from repro_torch.core.reward import RewardInputs, compute_reward
    from repro_torch.kernels import build
    from repro_torch.serving import latency as lat
    from repro_torch.serving.arms import pools_used
    from repro_torch.serving.context import pool_key
    from repro_torch.serving.engine import SimConfig, make_requests

    arms = ex.arms
    sim = SimConfig(**SCHED_STREAM)
    reqs = make_requests(sim, seed0=SCHED_SEED0)
    t0 = time.perf_counter()
    seeds = np.array([r.prompt_seed for r in reqs])
    table, _ = count_launches("the scheduler's quality table",
                              lambda: ex.quality_table(seeds),
                              table_launches(ex), total)
    table_s = time.perf_counter() - t0
    check(all(np.isfinite(list(m.values())).all() for m in table.ravel()),
          "non-finite quality in the scheduler's table")

    rng = np.random.default_rng(0)
    ctxs = np.stack([context_vector(r, {"vega": rng.uniform(),
                                        "sdxl": rng.uniform(),
                                        "sd3": rng.uniform()}) for r in reqs])

    def reward_fn(i, arm):
        a = arms[arm]
        lb = lat.arm_latency(a, None, reqs[i].rtt_ms,
                             compressed=transport.cfg.compress)
        occ = {"vega": ctxs[i][5], "sdxl": ctxs[i][6], "sd3": ctxs[i][7]}
        l_used = max(occ[pool_key(p)] for p in pools_used(a))
        return compute_reward(RewardInputs(
            quality=transport.quality_delta(a.family, table[i, arm],
                                            n_hops=a.n_hops),
            t_total=lb.total + 8.0 * l_used, m_vram=lat.arm_vram(a),
            l_dev=l_used, c_txt=ctxs[i][1], c_pref=ctxs[i][4],
            c_bat=ctxs[i][3]))

    train, held = ctxs[:SCHED_TRAIN], range(SCHED_TRAIN, len(reqs))
    avail = np.ones(len(arms), bool)
    build.reset_launches()

    # RISE: sequential select/update over the training set on the card;
    # its arms and rewards replayed into a CPU policy
    rise = pol.RisePolicy(seed=0, device=dev)
    rise_cpu = pol.RisePolicy(seed=0, device="cpu")
    for i in np.random.default_rng(5).permutation(SCHED_TRAIN):
        arm = rise.select(ctxs[i], avail)
        r = reward_fn(i, arm)
        rise.update(ctxs[i], arm, r)
        rise_cpu.update(ctxs[i], arm, r)
    state = {f: ulps(a.cpu().numpy(), b.numpy())
             for f, a, b in zip(rise.state._fields, rise.state, rise_cpu.state)}
    check(all(v == 0 for v in state.values()),
          f"RISE state card vs CPU, ulps: {state}")
    worst = 0.0
    for i in held:
        c = torch.from_numpy(ctxs[i])
        a = linucb.scores(rise.state, c.to(dev), rise.p).cpu().numpy()
        b = linucb.scores(rise_cpu.state, c, rise_cpu.p).numpy()
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    check(worst <= SCORE_RTOL, f"RISE held-out scores card vs CPU {worst}")

    # PPO and SAC from the card's default weights carried to the CPU
    nets = {"PPO": ("pi", "v"), "SAC": ("q1", "q2")}
    learned, drift = {"RISE": rise}, {}
    for name, cls in (("PPO", pol.PPOPolicy), ("SAC", pol.SACPolicy)):
        card, cpu = cls(seed=0, device=dev), cls(seed=0, device="cpu")
        for net in nets[name]:
            getattr(cpu, net).load_state_dict(getattr(card, net).state_dict())
        for p in (card, cpu):
            p.train_offline(train, reward_fn, epochs=10)
        drift[name] = max(norm_rel(a.detach().cpu(), b.detach())
                          for net in nets[name]
                          for a, b in zip(getattr(card, net).parameters(),
                                          getattr(cpu, net).parameters()))
        check(drift[name] <= WEIGHT_RTOL,
              f"{name} weights card vs CPU {drift[name]}")
        ties = 0
        for i in held:
            a, b = card.select(ctxs[i], avail), cpu.select(ctxs[i], avail)
            v = (cpu.logits(ctxs[i][None])[0] if name == "PPO"
                 else cpu.q_min(ctxs[i][None])[0])
            top2 = np.sort(v)[-2:]
            tie = top2[1] - top2[0] < MARGIN_TIE * max(abs(top2[1]), 1.0)
            ties += int(tie)
            check(a == b or tie, f"{name}: held-out {i} card {a} CPU {b}")
        drift[name + "_ties"] = ties
        learned[name] = card
    # RR and Greedy are host-only numpy policies with nothing on the card:
    # they join the mean-reward reading only (their picks are held to the
    # reference in tests/test_torch_scheduler.py)
    learned["RR"], learned["Greedy"] = pol.RoundRobinPolicy(), pol.GreedyPolicy()
    held_out = {}  # (request, arm, reward) of each held-out pick
    for name, p in learned.items():
        picks = [(i, p.select(ctxs[i], avail)) for i in held]
        held_out[name] = [(i, a, reward_fn(i, a)) for i, a in picks]
    mean = {name: float(np.mean([r for _, _, r in picks]))
            for name, picks in held_out.items()}
    got = dict(build.LAUNCHES)
    check(not any(got.values()), f"the policies launched kernels: {got}")
    sched_obs_checks(rise, rise_cpu, held_out["RISE"], arms)
    print(f"Fig. 6 offline protocol on the card's quality table ("
          f"{SCHED_TRAIN} training + {SCHED_HELD} held-out requests x "
          f"{len(arms)} arms, table {table_s:.1f} s): RISE state card vs "
          f"CPU ulps {json.dumps(state)}, held-out scores rel {worst:.3g}; "
          f"PPO/SAC weights rel and held-out ties {json.dumps(drift)}")
    print(f"mean held-out reward (smoke reading, not a metric): "
          f"{json.dumps(mean)}")
    return rise, SimpleNamespace(sim=sim, reqs=reqs, table=table)


def sched_obs_checks(rise, rise_cpu, held_out, arms) -> None:
    """Phase 16, scheduler introspection on the card's RISE: the LinUCB
    snapshot of its state (on the card) equals the CPU twin's exactly and
    its pulls sum to the training updates; the held-out (arm, reward) pairs
    give pulls that sum to ``SCHED_HELD`` and a regret >= 0; the report is
    JSON-serializable."""
    from repro_torch.serving.obs import (SchedulerIntrospection,
                                         linucb_snapshot, scheduler_report)

    snap, snap_cpu = linucb_snapshot(rise), linucb_snapshot(rise_cpu)
    check(snap == snap_cpu and sum(snap["pulls"]) == SCHED_TRAIN,
          f"LinUCB snapshot card vs CPU: {snap} vs {snap_cpu}")
    records = [SimpleNamespace(rid=int(i), arm=int(a), reward=float(r))
               for i, a, r in held_out]
    intro = SchedulerIntrospection.from_records(records, len(arms))
    regret = intro.cumulative_regret()
    check(int(intro.pulls.sum()) == SCHED_HELD and regret >= 0.0,
          f"held-out introspection: pulls {intro.pulls.tolist()}, regret "
          f"{regret}")
    report = json.dumps(scheduler_report(rise, records, arms))
    print(f"RISE introspection on the card: snapshot == CPU twin's (pulls "
          f"{snap['pulls']}, width at the unit context "
          f"{max(snap['confidence_width_at_ctx']):.4g} max); held-out pulls "
          f"{intro.pulls.tolist()}, best arm {intro.best_arm}, cumulative "
          f"regret {regret:.4g}; report {len(report)} JSON bytes")


def linucb_checks(dev, rise) -> None:
    """Phase 16, LinUCB alone on the card: the sampled branch by
    distribution, the forced branch exact, the DAG action space with the
    telemetry context."""
    from repro_torch.core import linucb
    from repro_torch.core import policies as pol
    from repro_torch.serving.arms import dag_action_space
    from scipy import stats

    # sampled: a spread temperature over the trained state's scores
    p = dataclasses.replace(rise.p, tau0=5.0, tau_min=5.0)
    check(bool((rise.state.counts >= p.n_min).all()), "forced arms remain")
    k = rise.state.A.shape[0]
    c = torch.from_numpy(np.linspace(0.1, 0.9, 8, dtype=np.float32))
    avail = torch.ones(k, dtype=torch.bool)
    avail[4] = False
    s = linucb.scores(rise.state, c.to(dev), p).double().cpu().numpy()
    tau = float(linucb._decayed(p, rise.state.counts.sum())[2])
    z = np.where(avail.numpy(), s / tau, -np.inf)
    prob = np.exp(z - z.max())
    prob /= prob.sum()
    gen = torch.Generator(device=dev).manual_seed(7)
    cd, ad = c.to(dev), avail.to(dev)
    hist = np.bincount([int(linucb.select(rise.state, cd, gen, p, ad))
                        for _ in range(SCHED_DRAWS)], minlength=k)
    keep = avail.numpy() & (prob * SCHED_DRAWS >= 5)
    expected = prob[keep] / prob[keep].sum() * hist[keep].sum()
    pvalue = float(stats.chisquare(hist[keep], expected).pvalue)
    check(hist[4] == 0 and keep.sum() >= 3 and pvalue > 1e-3,
          f"sampled branch: histogram {hist.tolist()}, p {pvalue}")

    # forced: any available arm under N_min -> the least pulled, first
    rng = np.random.default_rng(8)
    forced = 0
    for _ in range(200):
        counts = rng.integers(0, 5, size=k).astype(np.float32)
        av = rng.uniform(size=k) < 0.7
        under = av & (counts < rise.p.n_min)
        if not under.any():
            continue
        st = rise.state._replace(counts=torch.from_numpy(counts).to(dev))
        got = int(linucb.select(st, cd, gen, rise.p,
                                torch.from_numpy(av).to(dev)))
        check(got == int(np.argmin(np.where(under, counts, np.inf))),
              f"forced branch picked {got} for counts {counts}, avail {av}")
        forced += 1

    # the 15 DAG arms with the 2 telemetry features (ctx_dim 10)
    space = dag_action_space()
    card = pol.RisePolicy(seed=4, arms=space, ctx_dim=10, device=dev)
    cpu = pol.RisePolicy(seed=4, arms=space, ctx_dim=10, device="cpu")
    rng = np.random.default_rng(9)
    theta = rng.normal(size=(len(space), 10))
    for _ in range(SCHED_DAG_STEPS):
        ctx = rng.random(10).astype(np.float32)
        arm = card.select(ctx, rng.uniform(size=len(space)) < 0.8)
        r = float(theta[arm] @ ctx)
        card.update(ctx, arm, r)
        cpu.update(ctx, arm, r)
    dag_ulps = {f: ulps(a.cpu().numpy(), b.numpy())
                for f, a, b in zip(card.state._fields, card.state, cpu.state)}
    check(float(card.state.counts.sum()) == SCHED_DAG_STEPS
          and not any(dag_ulps.values()),
          f"DAG-space RISE: counts {card.state.counts.tolist()}, card vs "
          f"CPU ulps {dag_ulps}")
    print(f"LinUCB on the card: {SCHED_DRAWS} sampled draws against "
          f"softmax(s/tau) (tau {tau:.3g}) chi-square p {pvalue:.3g}, the "
          f"masked arm never drawn, histogram {hist.tolist()}; {forced} "
          f"forced selections exact; K = {len(space)}, d = 10: "
          f"{SCHED_DAG_STEPS} steps, counts "
          f"{card.state.counts.int().tolist()}, card vs CPU ulps "
          f"{json.dumps(dag_ulps)}")


def federation_checks(dev) -> None:
    """Phase 16, the federation on the card: three clusters, one
    observation each per round, five rounds: the merged state equals
    ``centralized_reference`` on the card bit for bit; a second gossip
    with no observations is a no-op."""
    from repro_torch.serving.fleet import (FederatedRisePolicy,
                                           LinUCBFederation,
                                           centralized_reference)

    pols = [FederatedRisePolicy(seed=5, device=dev) for _ in range(3)]
    fed = LinUCBFederation(pols)
    rng = np.random.default_rng(6)
    obs = []
    for _ in range(5):
        for p in pols:
            o = (int(rng.integers(11)), rng.random(8).astype(np.float32),
                 float(rng.normal()))
            p.update(o[1], o[0], o[2])
            obs.append(o)
        merged = fed.gossip()
    central = centralized_reference(obs, 11, 8, device=dev)
    again = fed.gossip()
    check(all(torch.equal(a, b) for a, b in zip(merged, central))
          and all(torch.equal(a, b) for a, b in zip(merged, again))
          and all(torch.equal(x, y) for p in pols
                  for x, y in zip(p.state, merged)),
          "the federation's merged state is not the centralized one")
    print(f"federation on the card: 3 clusters x 5 rounds, merged == "
          f"centralized_reference bit for bit, second gossip a no-op "
          f"(counts {merged.counts.int().tolist()})")


def decision_kernels() -> dict:
    """The device kernels of one RisePolicy decision on the card, with
    ``profiled``'s exact-count check over 20 calls, its operands already
    on the card (the policy adds the host-to-device copies of the context,
    and of the mask in select, and select's ``int(arm)``).  Run in a child
    process (:func:`child_decision_kernels`): late in this script CUPTI
    recorded 1,356 of a session's 1,360 select kernels on an H100 80GB
    HBM3, four fewer in every attempt, while a fresh process records them
    all."""
    from repro_torch.core import linucb
    from repro_torch.core import policies as pol

    p = pol.RisePolicy(seed=1, device="cuda")
    c = torch.from_numpy(np.linspace(0.1, 0.9, 8, dtype=np.float32)).to(
        p.device)
    mask = torch.ones(len(p.arms), dtype=torch.bool, device=p.device)
    runs = {"select": lambda: linucb.select(p.state, c, p.generator, p.p,
                                            mask),
            "update": lambda: linucb.update(p.state, 1, c, 0.5, p.p)}
    out = {}
    for name, fn in runs.items():
        averages = profiled(lambda: [fn() for _ in range(20)], calls=20)[1]
        out[f"{name}_kernels"] = sum(
            e.count for e in averages if e.self_device_time_total > 0) / 20
    return out


def child_decision_kernels() -> dict:
    """:func:`decision_kernels` in a fresh Python process on the card."""
    code = ("import json, sys; sys.path.insert(0, 'src'); import chip_smoke; "
            "print(json.dumps(chip_smoke.decision_kernels()))")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0, f"decision kernels: {run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def decision_times(dev, rise) -> dict:
    """Phase 16, the cost of one decision: µs per ``RisePolicy.select``
    (ending in its ``int(arm)``) and per ``update`` (on the card followed
    by a synchronize), median of ``SCHED_TIMED`` calls by host clock (and
    p50/p95/max through ``StreamingQuantiles``), on the card and on the
    CPU; the device kernels per call (profiler)."""
    from repro_torch.core import policies as pol
    from repro_torch.serving.obs import StreamingQuantiles

    rng = np.random.default_rng(12)
    ctxs = rng.random((SCHED_TIMED, 8)).astype(np.float32)
    avail = np.ones(len(rise.arms), bool)
    out, spread = {}, {}
    for where in (dev, torch.device("cpu")):
        p = pol.RisePolicy(seed=1, device=where)
        p.state = type(rise.state)(*(x.to(where) for x in rise.state))
        sync = (torch.cuda.synchronize if where.type == "cuda"
                else lambda: None)
        sel, upd = [], []
        for c in ctxs:
            t0 = time.perf_counter()
            arm = p.select(c, avail)
            t1 = time.perf_counter()
            p.update(c, arm, 0.5)
            sync()
            t2 = time.perf_counter()
            sel.append(t1 - t0)
            upd.append(t2 - t1)
        out[where.type] = {"select_us": float(np.median(sel)) * 1e6,
                           "update_us": float(np.median(upd)) * 1e6}
        spread[where.type] = {}
        for name, xs in (("select", sel), ("update", upd)):
            q = StreamingQuantiles()
            for x in xs:
                q.add(x * 1e6)
            spread[where.type][name] = {k: q.summary()[k]
                                        for k in ("p50", "p95", "max")}
        if where.type == "cuda":
            out["cuda"].update(child_decision_kernels())
    print(f"one RISE decision, per call, µs (StreamingQuantiles over "
          f"{SCHED_TIMED} calls): {json.dumps(spread)}")
    print(f"one RISE decision, median of {SCHED_TIMED} calls by host clock "
          f"(the card's select includes int(arm), its update a "
          f"synchronize): {json.dumps(out)}")
    return out


def scheduler_phase(dev, ex):
    """Phase 16: the scheduler's decision loop on the card — the
    transport, the Fig. 6 offline protocol on ``ex``'s quality table
    (phase 3's raw executor), LinUCB alone, the federation, the cost of a
    decision.  Returns the phase's kernel launches, and the protocol's
    stream and quality table."""
    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    transport = transport_checks(dev, total)
    rise, stream = fig6_protocol(dev, ex, transport, total)
    linucb_checks(dev, rise)
    federation_checks(dev)
    decision_times(dev, rise)
    print(f"scheduler phase launches: {json.dumps(total)}; "
          f"{time.perf_counter() - t0:.1f} s")
    return total, stream


# ---- 17. the sequential serving engine -----------------------------------


class ReplayPolicy:
    """Phase 17: serves another run's arms in order, each checked available, and feeds every update to
    ``inner``, a RisePolicy.  Where ``inner`` is in its forced branch (an
    available arm pulled fewer than ``n_min`` times), the replayed arm must
    be ``inner``'s own pick; ``forced`` counts those decisions.  Its
    sampled picks are not compared: each device draws from its own
    generator."""

    name = "Replay"

    def __init__(self, seq, inner):
        self.seq, self.inner, self.arms = list(seq), inner, inner.arms
        self.i = self.forced = 0

    def select(self, ctx, avail):
        arm = self.seq[self.i]
        check(bool(avail[arm]), f"replayed arm {arm} unavailable at "
              f"decision {self.i}")
        counts = self.inner.state.counts.cpu().numpy()
        mask = np.asarray(self.inner._mask(avail), bool)
        if (mask & (counts < self.inner.p.n_min)).any():
            own = self.inner.select(ctx, avail)
            check(own == arm, f"forced pick {own}, replayed {arm} at "
                  f"decision {self.i}")
            self.forced += 1
        self.i += 1
        return arm

    def update(self, ctx, arm, reward):
        self.inner.update(ctx, arm, reward)


def engine_launches(eng, recs) -> dict:
    """Phases 17 and 18: each kernel's launches in one run of a fresh
    engine, derived from its runtime and its records.  The sequential
    engine's transport measures the round trip of each family that a
    compressed record's arm belongs to once, on its first
    ``handoff_error`` (:func:`warm_launches`); the continuous runtime
    builds its own transport and warms it on every family of its action
    space before its loop (``_setup_arms``), whatever the records touch.
    The standalone arm has no family and no handoff.  Uncompressed,
    nothing launches."""
    if eng.runtime == "continuous":
        compress = eng.runtime_cfg.compress_handoff
        fams = {a.family for a in eng.arms}
    else:
        compress = eng.transport.cfg.compress
        fams = {eng.arms[r.arm].family for r in recs}
    if not compress:
        return dict.fromkeys(KERNELS, 0)
    return warm_launches(sorted(fams - {None}), False)


def serve(what, policy, table, stream, dev, total, compress=True,
          arms=None, runtime="sequential"):
    """Phases 17 and 18: one run of a fresh engine (``runtime``) on
    ``dev`` over ``stream``'s requests; on the card its launches, counted
    from 0 just before the engine is built, must equal
    :func:`engine_launches` and are added to ``total``.  The continuous
    runtime is given ``RuntimeConfig(compress_handoff=compress)``; the
    sequential engine ``RuntimeConfig()`` if ``compress``, else none.
    Returns (engine, records)."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.runtime import RuntimeConfig

    rc = (RuntimeConfig(compress_handoff=compress) if runtime == "continuous"
          else RuntimeConfig() if compress else None)
    build.reset_launches()
    eng = ServingEngine(policy, table, stream.sim, runtime=runtime,
                        runtime_cfg=rc, arms=arms, device=dev)
    recs = eng.run(stream.reqs)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
        got, want = dict(build.LAUNCHES), engine_launches(eng, recs)
        check(got == want, f"{what}: launches {got}, want {want}")
        for k in total:
            total[k] += got[k]
    check(len(recs) == stream.sim.n_requests
          and all(np.isfinite(r.reward) and np.isfinite(r.t_total)
                  for r in recs), f"{what}: a request lost or not finite")
    return eng, recs


def joins(tracer) -> list:
    """Every DAG join's (rid, name, accepted, winner), in trace order."""
    return [(tr.rid, s.name, s.meta.get("accepted"), s.meta.get("winner"))
            for tr in tracer.requests.values() for s in tr.spans
            if s.kind == "join"]


def compressed_twins(what, card, cpu) -> float:
    """Phase 17 (a): a compressed run with the transport on the card
    against the same run with ``device="cpu"``, each (engine, records):
    arms, ``t_total``, ``wait_s``, contexts, fault counters and Select
    decisions exact, quality and reward within ``ENGINE_RTOL`` of
    ``max(|CPU|, 1)``.  Returns the worst relative difference."""
    (ce, cr), (pe, pr) = card, cpu
    check(len(cr) == len(pr), f"{what}: {len(cr)} records vs {len(pr)}")
    worst = 0.0
    for a, b in zip(cr, pr):
        check((a.rid, a.arm, a.t_total, a.wait_s)
              == (b.rid, b.arm, b.t_total, b.wait_s)
              and np.array_equal(a.ctx, b.ctx)
              and a.quality.keys() == b.quality.keys(),
              f"{what}: request {b.rid} card {(a.arm, a.t_total, a.wait_s)}"
              f" CPU {(b.arm, b.t_total, b.wait_s)}")
        for x, y in [(a.reward, b.reward)] + [(a.quality[k], b.quality[k])
                                              for k in b.quality]:
            worst = max(worst, abs(x - y) / max(abs(y), 1.0))
    check(worst <= ENGINE_RTOL, f"{what}: quality/reward rel {worst}")
    check(ce.fault_counters.as_dict() == pe.fault_counters.as_dict(),
          f"{what}: fault counters {ce.fault_counters.as_dict()} vs "
          f"{pe.fault_counters.as_dict()}")
    check(joins(ce.tracer) == joins(pe.tracer),
          f"{what}: Select decisions differ")
    return worst


def reject_space() -> tuple:
    """Phases 17 and 18: the 15 DAG arms and a speculation whose Select
    always rejects (bound 0), so that a stream under Cycle serves both of
    a Select's outcomes."""
    from repro_torch.serving.arms import (Arm, dag_action_space,
                                          speculative_program)

    space = dag_action_space()
    return space + (Arm(len(space), speculative_program("XL", 20, 10,
                                                        bound_pct=0.0),
                        "XL@s=20|spec=10|reject"),)


def select_outcomes(what, tracer) -> list:
    """Each Select's accept flag in ``tracer``'s order; both outcomes
    must occur."""
    got = [acc for _, name, acc, _ in joins(tracer)
           if name.startswith("join:select")]
    check(set(got) == {True, False}, f"{what}: Selects {got}: both "
          f"outcomes must occur")
    return got


def engine_phase(dev, stream) -> dict:
    """Phase 17: the sequential serving engine on the card over phase 16's
    stream and quality table, checking what the card computes: (a) the
    transport's round trip, compressed, card against CPU, on the 11 arms
    and on the 15 DAG arms with an always-reject speculation, both Select
    outcomes served; (b) RISE on the card against RISE on the CPU by
    replay; (c) each run's launches (:func:`serve`); (d) ms per request on
    each device, in turns.  Returns the phase's kernel launches."""
    from repro_torch.core import policies as pol
    from repro_torch.serving.workload import (CyclePolicy,
                                              synthetic_quality_table)

    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    cpu = torch.device("cpu")

    # (a) the round trip's error in the records, card against CPU; the DAG
    # space adds a speculation whose Select always rejects, so both of a
    # Select's outcomes are served on each device
    space = reject_space()
    rel = {}
    for key, arms, qt in (
            ("table2", None, stream.table),
            ("dag", space, synthetic_quality_table(stream.reqs, space))):
        what = f"compressed, {key}"
        card, twin = (serve(what, CyclePolicy(), qt, stream, where, total,
                            arms=arms) for where in (dev, cpu))
        rel[key] = compressed_twins(what, card, twin)
    selects = select_outcomes("DAG", card[0].tracer)
    print(f"engine, compressed, card vs CPU ({stream.sim.n_requests} "
          f"requests, Cycle; arms, t_total, wait_s, contexts, counters and "
          f"Selects equal): quality/reward rel {json.dumps(rel)}; DAG "
          f"Selects accepted {sum(selects)}, rejected "
          f"{len(selects) - sum(selects)}")

    # (b) RISE on the card; its arms replayed into RISE on the CPU
    rise = pol.RisePolicy(seed=0, device=dev)
    run = serve("RISE", rise, stream.table, stream, dev, total,
                compress=False)
    replay = ReplayPolicy([r.arm for r in run[1]],
                          pol.RisePolicy(seed=0, device=cpu))
    serve("RISE replay", replay, stream.table, stream, cpu, total,
          compress=False)
    state = {f: ulps(a.cpu().numpy(), b.numpy()) for f, a, b in
             zip(rise.state._fields, rise.state, replay.inner.state)}
    check(replay.i == len(run[1]) and replay.forced >= len(rise.arms),
          f"RISE replay: {replay.i} decisions, {replay.forced} forced")
    check(all(v <= RISE_ULPS for v in state.values()),
          f"RISE state card vs CPU, ulps: {state}")
    print(f"engine, RISE card vs CPU by replay ({replay.i} decisions, "
          f"{replay.forced} forced and equal): state ulps "
          f"{json.dumps(state)}")

    # (d) the cost of the loop: RISE and the transport on each device
    ms = {"cuda": [], "cpu": []}
    for _ in range(ENGINE_TURNS):
        for where in (dev, cpu):
            t1 = time.perf_counter()
            serve("timed", pol.RisePolicy(seed=0, device=where),
                  stream.table, stream, where, total)
            ms[where.type].append(
                (time.perf_counter() - t1) * 1e3 / stream.sim.n_requests)
    loop = {k: {"median_ms": float(np.median(v)), "turns_ms": v}
            for k, v in ms.items()}
    print(f"engine ms per request, compressed, RISE and the transport on "
          f"each device ({ENGINE_TURNS} turns each, alternating): "
          f"{json.dumps(loop)}")
    print(f"engine phase launches: {json.dumps(total)}; "
          f"{time.perf_counter() - t0:.1f} s")
    return total


# ---- 18. the continuous-batching runtime ---------------------------------


def recorded(policy):
    """Wraps ``policy.select`` to keep its picks in decision order (the
    continuous runtime returns its records in completion order).
    Returns the list that holds them."""
    picks, select = [], policy.select

    def select_and_keep(ctx, avail):
        picks.append(select(ctx, avail))
        return picks[-1]

    policy.select = select_and_keep
    return picks


def cli_run(args, dev, want=None):
    """Phase 18 (e): ``launch/serve.py::main`` on ``dev`` over the in-repo
    checkpoints, its printed summary kept off this script's output.  On
    the card its launches, counted from 0 just before, must equal
    ``want``.  Returns (summary, launches, seconds)."""
    import contextlib
    import io

    from repro_torch.kernels import build
    from repro_torch.launch import serve as cli

    build.reset_launches()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = cli.main(args + ["--device", dev.type, "--ckpt-dir",
                                   str(REPO / "results" / "ckpts")])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    got = dict(build.LAUNCHES)
    if want is not None and dev.type == "cuda":
        check(got == want, f"serve.py {args} on {dev.type}: launches {got}, "
              f"want {want}")
    return summary, got, secs


def runtime_phase(dev, stream, ex) -> dict:
    """Phase 18: the continuous-batching runtime
    (``serving/runtime/engine.py::ContinuousRuntime``, the engine's
    default) on the card over phase 16's stream and quality table,
    checking what the card computes: (a) the transport's round trip,
    compressed, card against CPU, on the 11 arms and on the DAG arms with
    an always-reject speculation, both Select outcomes served; (b) RISE on
    the card against RISE on the CPU by replay; (c) each run's launches
    (:func:`serve`, counted from 0 before the engine is built); (d) ms per
    request in turns; (e) ``launch/serve.py::main`` end to end.  ``ex`` is
    phase 3's raw executor, whose families and arms the CLI loads again.
    Returns the phase's kernel launches."""
    from repro_torch.core import policies as pol
    from repro_torch.serving.obs import validate_chrome_trace
    from repro_torch.serving.workload import (CyclePolicy,
                                              synthetic_quality_table)

    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    cpu = torch.device("cpu")

    # (a) compressed, the transport on the card against device="cpu"
    space = reject_space()
    rel = {}
    for key, arms, qt in (
            ("table2", None, stream.table),
            ("dag", space, synthetic_quality_table(stream.reqs, space))):
        what = f"continuous, compressed, {key}"
        card, twin = (serve(what, CyclePolicy(), qt, stream, where, total,
                            arms=arms, runtime="continuous")
                      for where in (dev, cpu))
        rel[key] = compressed_twins(what, card, twin)
    selects = select_outcomes("continuous DAG", card[0].tracer)
    batched = max(p["mean_batch_size"]
                  for p in card[0].telemetry.summary().values())
    print(f"continuous runtime, compressed, card vs CPU "
          f"({stream.sim.n_requests} requests, Cycle; arms, t_total, "
          f"wait_s, contexts, counters and Selects equal): quality/reward "
          f"rel {json.dumps(rel)}; DAG Selects accepted {sum(selects)}, "
          f"rejected {len(selects) - sum(selects)}; largest mean batch "
          f"{batched:.3f}")

    # (b) RISE on the card; its picks, in decision order, replayed into
    # RISE on the CPU, whose updates then come in the runtime's order
    rise = pol.RisePolicy(seed=0, device=dev)
    picks = recorded(rise)
    run = serve("continuous RISE", rise, stream.table, stream, dev, total,
                compress=False, runtime="continuous")
    replay = ReplayPolicy(picks, pol.RisePolicy(seed=0, device=cpu))
    again = serve("continuous RISE replay", replay, stream.table, stream,
                  cpu, total, compress=False, runtime="continuous")
    check([(r.rid, r.arm, r.t_total, r.reward) for r in run[1]]
          == [(r.rid, r.arm, r.t_total, r.reward) for r in again[1]],
          "continuous RISE: card and replayed records differ")
    state = {f: ulps(a.cpu().numpy(), b.numpy()) for f, a, b in
             zip(rise.state._fields, rise.state, replay.inner.state)}
    check(replay.i == len(picks) == stream.sim.n_requests
          and replay.forced >= len(rise.arms),
          f"continuous RISE replay: {replay.i} decisions, {replay.forced} "
          f"forced")
    check(all(v <= RISE_ULPS for v in state.values()),
          f"continuous RISE state card vs CPU, ulps: {state}")
    print(f"continuous runtime, RISE card vs CPU by replay ({replay.i} "
          f"decisions, {replay.forced} forced and equal; records equal): "
          f"state ulps {json.dumps(state)}")

    # (d) the cost of the loop, compressed: RISE on the card, RISE on the
    # CPU beside the card's transport, and the whole engine on the CPU
    turns = {"rise_card": (dev, dev), "rise_cpu": (cpu, dev),
             "engine_cpu": (cpu, cpu)}
    ms = {k: [] for k in turns}
    for _ in range(ENGINE_TURNS):
        for key, (p_dev, e_dev) in turns.items():
            t1 = time.perf_counter()
            serve("timed", pol.RisePolicy(seed=0, device=p_dev),
                  stream.table, stream, e_dev, total,
                  runtime="continuous")
            ms[key].append(
                (time.perf_counter() - t1) * 1e3 / stream.sim.n_requests)
    loop = {k: {"median_ms": float(np.median(v)), "turns_ms": v}
            for k, v in ms.items()}
    print(f"continuous runtime ms per request, compressed ({ENGINE_TURNS} "
          f"turns of RISE on the card, RISE on the CPU with the card's "
          f"transport, the engine on the CPU): {json.dumps(loop)}")

    # (e) the serving driver end to end: the quality table on the card's
    # families (one generate per raw arm), then one round trip per family
    # as the continuous runtime warms its transport
    want = table_launches(ex)
    for k, v in warm_launches(sorted({a.family for a in ex.arms} - {None}),
                              False).items():
        want[k] += v
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        rise_args = ["--policy", "rise", "--runtime", "continuous",
                     "--requests", str(CLI_REQUESTS), "--trace-out",
                     str(trace), "--profile"]
        summary, got, rise_s = cli_run(rise_args, dev, want)
        errors = validate_chrome_trace(json.loads(trace.read_text()))
    check(sum(summary["arm_histogram"]) == CLI_REQUESTS and errors == []
          and summary["event_loop_profile"]["events"] > 0
          and np.isfinite(summary["total_reward"]),
          f"serve.py RISE: histogram {summary['arm_histogram']}, trace "
          f"errors {errors[:3]}")
    for k in total:
        total[k] += got[k]
    rr_args = ["--policy", "rr", "--runtime", "continuous", "--requests",
               str(CLI_REQUESTS)]
    rr_card, got, rr_s = cli_run(rr_args, dev, want)
    for k in total:
        total[k] += got[k]
    rr_cpu, _, rr_cpu_s = cli_run(rr_args, cpu)
    same = ("arm_histogram", "text_fraction", "mean_latency_s",
            "p95_latency_s", "time_reward", "runtime_telemetry")
    check(all(rr_card[k] == rr_cpu[k] for k in same),
          f"serve.py RR card vs CPU: "
          f"{[k for k in same if rr_card[k] != rr_cpu[k]]} differ")
    print(f"serve.py on the card ({CLI_REQUESTS} requests, continuous, "
          f"families loaded and the quality table built in each call): "
          f"RISE {rise_s:.2f} s, histogram {summary['arm_histogram']}, "
          f"trace valid, launches {json.dumps({k: v for k, v in want.items() if v})}; "
          f"RR {rr_s:.2f} s, equal to the CPU's ({rr_cpu_s:.2f} s) in "
          f"{', '.join(same)}")
    print(f"runtime phase launches: {json.dumps(total)}; "
          f"{time.perf_counter() - t0:.1f} s")
    return total


# ---- 19. the fleet ------------------------------------------------------


def fleet_clusters() -> tuple:
    """Phase 19: bench_fleet's heterogeneous clusters as ``ClusterSpec``s
    (the testbed inventory, one replica per pool, four per pool)."""
    from repro_torch.serving.fleet import ClusterSpec

    return tuple(ClusterSpec(name, region=region,
                             pool_replicas=(None if per_pool is None else
                                            dict.fromkeys(FLEET_POOLS,
                                                          per_pool)))
                 for name, region, per_pool in FLEET_CLUSTERS)


def fleet_region(req) -> str:
    """bench_fleet's home region of a request (rid round-robin)."""
    return FLEET_CLUSTERS[req.rid % len(FLEET_CLUSTERS)][1]


def fleet_launches(runtimes) -> dict:
    """Phase 19: each kernel's launches in one run of fresh ``runtimes``
    (a fleet's clusters, or one standalone runtime): every runtime warms
    its own transport on every family of the action space before the loop
    (:func:`engine_launches`), so a compressed fleet launches one round
    trip per family per cluster."""
    want = dict.fromkeys(KERNELS, 0)
    for rt in runtimes:
        if rt.rt.compress_handoff:
            fams = sorted({a.family for a in rt.arms} - {None})
            for k, v in warm_launches(fams, False).items():
                want[k] += v
    return want


def fleet_serve(what, policies, stream, dev, total, router="least_loaded",
                autoscale=False, gossip=None, clusters=None, compress=True):
    """Phase 19: one run of a fresh ``FleetEngine`` with its transports
    on ``dev`` over ``stream``'s requests and quality table; on the card
    its launches, counted from 0 just before the fleet is built, must
    equal :func:`fleet_launches` and are added to ``total``.  Returns
    (engine, result)."""
    from repro_torch.kernels import build
    from repro_torch.serving.fleet import (AutoscaleConfig, FleetConfig,
                                           FleetEngine)
    from repro_torch.serving.runtime import RuntimeConfig

    build.reset_launches()
    fleet = FleetConfig(clusters=clusters or fleet_clusters(), router=router,
                        gossip_period_s=gossip)
    eng = FleetEngine(fleet, stream.sim, stream.table, policies,
                      rt_cfg=RuntimeConfig(compress_handoff=compress),
                      autoscale=AutoscaleConfig() if autoscale else None,
                      region_of=fleet_region, device=dev)
    res = eng.run(stream.reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        got, want = dict(build.LAUNCHES), fleet_launches(eng.runtimes)
        check(got == want, f"{what}: launches {got}, want {want}")
        for k in total:
            total[k] += got[k]
    check(len(res.records) == stream.sim.n_requests
          and sorted(res.assignments) == [r.rid for r in res.records]
          and all(np.isfinite(r.reward) and np.isfinite(r.t_total)
                  for r in res.records),
          f"{what}: a request lost or not finite")
    return eng, res


def standalone(stream, dev, total):
    """Phase 19: the standalone runtime under Cycle, compressed, with its
    transport on ``dev``, over ``stream``; on the card its launches are
    checked as a fleet of one's (:func:`fleet_launches`) and added to
    ``total``.  Returns the runtime."""
    from repro_torch.kernels import build
    from repro_torch.serving.runtime import ContinuousRuntime, RuntimeConfig
    from repro_torch.serving.workload import CyclePolicy

    build.reset_launches()
    rt = ContinuousRuntime(CyclePolicy(), stream.table, stream.sim,
                           RuntimeConfig(), device=dev)
    rt.run(stream.reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        got = dict(build.LAUNCHES)
        want = fleet_launches([rt])
        check(got == want, f"standalone runtime: launches {got}, want {want}")
        for k in total:
            total[k] += got[k]
    return rt


def fleet_telemetry(res) -> list:
    return [{"summary": t.summary(), "faults": t.faults.as_dict(),
             "autoscale": t.autoscale.as_dict()} for t in res.telemetry]


def fleet_twins(what, card, cpu) -> float:
    """Phase 19 (a): a compressed fleet with its transports on the card
    against the same fleet with ``device="cpu"``, each (engine, result):
    every cluster's records in completion order as
    :func:`compressed_twins` holds them, the assignments and every
    cluster's telemetry (pool stats, fault and autoscale counters) exact.
    Returns the worst relative difference of quality and reward."""
    (ce, cr), (pe, pr) = card, cpu
    check(cr.assignments == pr.assignments,
          f"{what}: assignments differ")
    check(fleet_telemetry(cr) == fleet_telemetry(pr),
          f"{what}: telemetry differs")
    return max(compressed_twins(f"{what}, cluster {k}",
                                (ce.runtimes[k], cr.per_cluster[k]),
                                (pe.runtimes[k], pr.per_cluster[k]))
               for k in range(len(ce.runtimes)))


class FedReplay(ReplayPolicy):
    """Phase 19 (c): a :class:`ReplayPolicy` over a ``FederatedRisePolicy``
    that the federation can drive: ``state`` reads and writes the inner
    policy's, ``take_delta`` is the inner policy's."""

    @property
    def state(self):
        return self.inner.state

    @state.setter
    def state(self, value):
        self.inner.state = value

    def take_delta(self):
        return self.inner.take_delta()


def record_fields(r) -> tuple:
    """Every field of a ``Record``, the context as bytes."""
    return (r.rid, r.arm, r.reward, r.t_total, r.quality, r.ctx.tobytes(),
            r.wait_s)


def fleet_phase(dev, stream) -> dict:
    """Phase 19: the fleet (``serving/fleet/engine.py::FleetEngine``) on
    the card over phase 16's stream and quality table, on bench_fleet's
    three heterogeneous clusters, checking what the card computes: (a)
    compressed, the transports on the card against ``device="cpu"`` under
    Cycle, for each router and once autoscaled; (b) a one-cluster fleet
    against the standalone runtime on the card, bit for bit; (c)
    federated RISE on the card against RISE on the CPU by replay, gossip
    on; (d) each card fleet's launches (:func:`fleet_serve`); (e) ms per
    request in turns of three placements, and the one-cluster fleet
    against the standalone runtime.  Returns the phase's kernel
    launches."""
    from repro_torch.serving.fleet import ClusterSpec, FederatedRisePolicy
    from repro_torch.serving.workload import CyclePolicy

    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    cpu = torch.device("cpu")
    n = stream.sim.n_requests
    n_clusters = len(FLEET_CLUSTERS)

    # (a) the round trip's error in the records, card against CPU
    rel, spread, scaled = {}, {}, {}
    for router, autoscale in [(r, False) for r in FLEET_ROUTERS] + [
            ("least_loaded", True)]:
        what = f"fleet, compressed, {router}" + (", autoscaled"
                                                 if autoscale else "")
        card, twin = (fleet_serve(what, [CyclePolicy() for _ in
                                         range(n_clusters)], stream, where,
                                  total, router=router, autoscale=autoscale)
                      for where in (dev, cpu))
        key = router + ("+autoscale" if autoscale else "")
        rel[key] = fleet_twins(what, card, twin)
        spread[key] = np.bincount(list(card[1].assignments.values()),
                                  minlength=n_clusters).tolist()
        if autoscale:
            scaled[key] = [t.autoscale.as_dict() for t in card[1].telemetry]
            check(all(s["ticks"] > 0 for s in scaled[key]),
                  f"{what}: a cluster never ticked")
    print(f"fleet, compressed, card vs CPU ({n} requests, Cycle, "
          f"{n_clusters} clusters; records, assignments and telemetry "
          f"equal): quality/reward rel {json.dumps(rel)}; requests per "
          f"cluster {json.dumps(spread)}; autoscaled {json.dumps(scaled)}")

    # (b) a fleet of one is the standalone runtime, on the card
    solo_spec = (ClusterSpec("solo"),)
    _, one = fleet_serve("fleet of one", [CyclePolicy()], stream, dev, total,
                         clusters=solo_spec)
    solo = standalone(stream, dev, total)
    check([record_fields(r) for r in one.per_cluster[0]]
          == [record_fields(r) for r in solo.records],
          "the one-cluster fleet differs from the standalone runtime")
    print(f"fleet of one on the card == the standalone runtime: {n} "
          f"records, every field bit for bit in completion order")

    # (c) federated RISE on the card; each cluster's picks, in decision
    # order, replayed into RISE on the CPU beside the same card transports
    pols = [FederatedRisePolicy(seed=13 * k, device=dev)
            for k in range(n_clusters)]
    picks = [recorded(p) for p in pols]
    fed, fres = fleet_serve("federated RISE", pols, stream, dev, total,
                            gossip=FLEET_GOSSIP_S)
    replays = [FedReplay(picks[k], FederatedRisePolicy(seed=13 * k,
                                                       device=cpu))
               for k in range(n_clusters)]
    again, ares = fleet_serve("federated RISE replay", replays, stream, dev,
                              total, gossip=FLEET_GOSSIP_S)
    check([record_fields(r) for r in fres.records]
          == [record_fields(r) for r in ares.records]
          and fres.assignments == ares.assignments
          and fres.n_gossips == ares.n_gossips > 1,
          f"federated RISE: card and replayed fleets differ (gossips "
          f"{fres.n_gossips}, {ares.n_gossips})")
    forced = sum(r.forced for r in replays)
    check(all(r.i == len(p) for r, p in zip(replays, picks))
          and forced >= len(pols[0].arms),
          f"federated RISE replay: {[r.i for r in replays]} decisions, "
          f"{forced} forced")
    states = [("base", fed.federation.base, again.federation.base)] + [
        (f"cluster {k}", p.state, r.inner.state)
        for k, (p, r) in enumerate(zip(pols, replays))]
    drift = {name: {f: ulps(a.cpu().numpy(), b.numpy())
                    for f, a, b in zip(x._fields, x, y)}
             for name, x, y in states}
    check(all(v <= RISE_ULPS for d in drift.values() for v in d.values()),
          f"federated RISE state card vs CPU, ulps: {drift}")
    print(f"fleet, federated RISE card vs CPU by replay ({n} decisions, "
          f"{forced} forced and equal; {fres.n_gossips} gossips; records "
          f"equal): merged base and live states, ulps "
          f"{json.dumps(drift['base'])}, worst of all "
          f"{max(v for d in drift.values() for v in d.values())}")

    # (e) the cost of the fleet, compressed, gossip on: federated RISE on
    # the card, RISE on the CPU beside the card's transports, and the
    # whole fleet on the CPU; then the driver's own cost, a fleet of one
    # against the standalone runtime (Cycle, on the card)
    turns = {"rise_card": (dev, dev), "rise_cpu": (cpu, dev),
             "fleet_cpu": (cpu, cpu)}
    ms = {k: [] for k in list(turns) + ["fleet_of_one", "standalone"]}
    reward = {}
    for _ in range(ENGINE_TURNS):
        for key, (p_dev, f_dev) in turns.items():
            t1 = time.perf_counter()
            _, res = fleet_serve(
                "timed", [FederatedRisePolicy(seed=13 * k, device=p_dev)
                          for k in range(n_clusters)],
                stream, f_dev, total, gossip=FLEET_GOSSIP_S)
            ms[key].append((time.perf_counter() - t1) * 1e3 / n)
            reward[key] = res.cumulative_reward()
        t1 = time.perf_counter()
        fleet_serve("timed fleet of one", [CyclePolicy()], stream, dev,
                    total, clusters=solo_spec)
        ms["fleet_of_one"].append((time.perf_counter() - t1) * 1e3 / n)
        t1 = time.perf_counter()
        standalone(stream, dev, total)
        ms["standalone"].append((time.perf_counter() - t1) * 1e3 / n)
    loop = {k: {"median_ms": float(np.median(v)), "turns_ms": v}
            for k, v in ms.items()}
    _, iso = fleet_serve("isolated RISE", [
        FederatedRisePolicy(seed=13 * k, device=dev)
        for k in range(n_clusters)], stream, dev, total)
    print(f"fleet ms per request, compressed ({ENGINE_TURNS} turns of "
          f"federated RISE on the card, RISE on the CPU with the card's "
          f"transports, the fleet on the CPU; and Cycle through a fleet of "
          f"one against the standalone runtime, on the card): "
          f"{json.dumps(loop)}")
    print(f"fleet cumulative reward over {n} requests (a smoke reading, "
          f"not a claim): federated {reward['rise_card']:.6f} (gossip "
          f"every {FLEET_GOSSIP_S:g} s), isolated "
          f"{iso.cumulative_reward():.6f}")
    print(f"fleet phase launches: {json.dumps(total)}; "
          f"{time.perf_counter() - t0:.1f} s")
    return total


def train_setup(fam: str, role: str, seed: int, teachers):
    """Phase 20: one (family, role) net's first training step set up on
    the host: the initial net (``init_net`` from a seeded generator), the
    step's ``synth.batch`` (step 1 of ``train_model``), its host draws, and
    a function of (net, device) giving the loss on that device; mid and
    small nets are distilled from ``teachers[device type][fam]``."""
    from repro_torch.diffusion import synth
    from repro_torch.diffusion import train
    from repro_torch.diffusion.families import NET_CONFIGS
    from repro_torch.models.diffusion_nets import init_net

    cfg = NET_CONFIGS[(fam, role)]
    gen = torch.Generator().manual_seed(seed)
    net = init_net(cfg, gen)
    seeds = np.arange(TRAIN_BATCH, 2 * TRAIN_BATCH)
    _, x0, cond = synth.batch(seeds, fam)
    x0, cond = torch.from_numpy(x0), torch.from_numpy(cond)
    if role == "large":
        draws = (train._draw_xl if fam == "XL" else train._draw_f3)(gen, x0)
    else:
        draws = train._draw_distill(gen, fam, x0)

    def loss(net, where):
        args = [a.to(where) for a in (x0, cond) + draws]
        if role == "large":
            fn = train._loss_xl if fam == "XL" else train._loss_f3
            return fn(net, *args)
        return train._loss_distill(net, teachers[where.type][fam], fam,
                                   *args)
    base_lr = 3e-3 if cfg.kind == "mmdit" else 1e-3
    return cfg, net, loss, base_lr


def grads_of(net, loss) -> tuple:
    """(loss, gradients by parameter name, ``None`` where the loss does not
    reach a parameter) of one net."""
    names, params = zip(*net.named_parameters())
    value = loss()
    grads = torch.autograd.grad(value, params, allow_unused=True)
    return value.detach(), dict(zip(names, grads))


def rel_max(a, b) -> float:
    """max |a − b| over max |b| (0 when both are all zero)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff / scale if scale else diff


def train_step_checks(dev, teachers) -> dict:
    """Phase 20 (a): one training step of each of the six nets at full
    width, batch 64, from the same initial net and the same host draws,
    card against ``device="cpu"``: the loss, every gradient, Adam alone on
    identical inputs, the parameters after the whole step (the floor,
    elements whose CPU gradient lies under ``GRAD_FLOOR`` of its tensor's
    largest or under ``EPS_FLOOR``, counted apart), and whether two card
    runs agree bit for bit."""
    import copy

    from repro_torch.device import keep_fp32
    from repro_torch.diffusion import train

    keep_fp32(dev)  # as train_model does: fp32 convolutions and products
    cpu = torch.device("cpu")
    out = {}
    for k, (fam, role) in enumerate(TRAIN_NETS):
        what = f"{fam}/{role}"
        cfg, net0, loss, base_lr = train_setup(fam, role, 20 + k, teachers)
        nets = {"cpu": copy.deepcopy(net0),
                "card": copy.deepcopy(net0).to(dev)}
        read = {}
        for key, where in (("cpu", cpu), ("card", dev)):
            read[key] = grads_of(nets[key], lambda: loss(nets[key], where))
        (l_cpu, g_cpu), (l_card, g_card) = read["cpu"], read["card"]
        loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
        check(loss_rel <= TRAIN_LOSS_RTOL,
              f"{what}: loss card {float(l_card)} vs CPU {float(l_cpu)}")
        unreached = sorted(n for n, g in g_cpu.items() if g is None)
        check(unreached == sorted(n for n, g in g_card.items() if g is None),
              f"{what}: the parameters without a gradient differ")
        grad_rel = max(rel_max(g_card[n], g) for n, g in g_cpu.items()
                       if g is not None)
        check(grad_rel <= TRAIN_GRAD_RTOL,
              f"{what}: gradient card vs CPU rel {grad_rel}")

        # Adam alone: the CPU's gradients, step 1 from zero moments
        adam = {}
        for key, where in (("cpu", cpu), ("card", dev)):
            p = [q.detach().clone().to(where) for q in net0.parameters()]
            g = [None if x is None else x.to(where) for x in g_cpu.values()]
            m, v = ([torch.zeros_like(q) for q in p] for _ in range(2))
            step = torch.tensor(1.0, device=where)
            lr = train.cosine_lr(base_lr, step, TRAIN_STEPS)
            train._adam_step(p, g, m, v, step, lr)
            adam[key] = (p, m, v, lr)
        # m, v in ulps; the parameters in ulps of the larger of |p| before
        # and after: p − u can cancel (u ≈ ±lr), and there a last-bit
        # difference of u is many ulps of the small result
        adam_ulps = {
            name: max(ulps(a.cpu().numpy(), b.numpy())
                      for a, b in zip(adam["card"][i], adam["cpu"][i]))
            for i, name in ((1, "m"), (2, "v"))}
        adam_ulps["params"] = max(
            spacings(a.cpu().numpy(), b.numpy(), np.maximum(
                np.abs(q.detach().numpy()), np.abs(b.numpy())))
            for a, b, q in zip(adam["card"][0], adam["cpu"][0],
                               net0.parameters()))
        adam_ulps["lr"] = ulps(adam["card"][3].cpu().numpy(),
                               adam["cpu"][3].numpy())
        check(max(adam_ulps.values()) <= TRAIN_ADAM_ULPS,
              f"{what}: Adam card vs CPU, ulps {adam_ulps}")

        # the whole step on each device, twice on the card
        after = {}
        for key, where in (("cpu", cpu), ("card", dev), ("card2", dev)):
            net = copy.deepcopy(net0).to(where)
            opt = train.Adam(net)
            train.train_step(opt, lambda: loss(net, where), 1, TRAIN_STEPS,
                             base_lr)
            after[key] = dict(net.named_parameters())
        worst, floor, beyond = 0.0, 0, 0
        for name, p_cpu in after["cpu"].items():
            g = g_cpu[name]
            err = ((after["card"][name].detach().cpu().double()
                    - p_cpu.detach().double()).abs()
                   / p_cpu.detach().double().abs().max())
            low = torch.zeros_like(err, dtype=torch.bool)
            if g is not None and float(g.abs().max()) > 0:
                low = g.abs() < max(GRAD_FLOOR * float(g.abs().max()),
                                    EPS_FLOOR)
            if (~low).any():
                worst = max(worst, float(err[~low].max()))
            floor += int(low.sum())
            beyond += int((err[low] > TRAIN_PARAM_RTOL).sum())
        check(worst <= TRAIN_PARAM_RTOL,
              f"{what}: parameters after a step, card vs CPU rel {worst}")
        check(beyond <= FLOOR_SHARE * floor,
              f"{what}: {beyond} of {floor} floor elements beyond "
              f"{TRAIN_PARAM_RTOL}")
        repeat = all(torch.equal(after["card"][n], after["card2"][n])
                     for n in after["card"])
        out[what] = {"loss_rel": loss_rel, "grad_rel": grad_rel,
                     "unreached": unreached, "adam_ulps": adam_ulps,
                     "param_rel": worst, "floor_elements": floor,
                     "floor_beyond": beyond, "card_repeats_bitwise": repeat}
    print(f"training step card vs CPU (full width, batch {TRAIN_BATCH}, "
          f"same init and host draws; gradient floor {GRAD_FLOOR:g} of the "
          f"tensor's largest or {EPS_FLOOR:g}): {json.dumps(out)}")
    return out


def results_digest() -> dict:
    """sha256 of every file under ``results/``, by path."""
    import hashlib

    return {str(p.relative_to(REPO)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "results").rglob("*")) if p.is_file()}


def trained_families(dev, total) -> tuple:
    """Phase 20 (b): ``get_or_train_families(tmp, steps=TRAIN_STEPS,
    batch=64, with_mid=True)`` on the card: every model's loss falls, the
    files read back by ``load_families`` equal the trained modules bit
    for bit, the teacher pool launches the interior step once per F3 step
    and never on XL (each pool counted from 0 just before its call).
    Returns (families, the seconds it took)."""
    from repro_torch.diffusion import train
    from repro_torch.diffusion.families import load_families
    from repro_torch.kernels import build

    losses, pools = {}, {}
    real_train, real_pool = train.train_model, train.teacher_pool

    def recording(seed, family, size, **kw):
        net, ls = real_train(seed, family, size, **kw)
        losses[f"{family}/{size}"] = ls
        return net, ls

    def pool(family, *args):
        torch.cuda.synchronize()
        build.reset_launches()
        out = real_pool(family, *args)
        torch.cuda.synchronize()
        pools[family] = dict(build.LAUNCHES)
        for k in total:
            total[k] += pools[family][k]
        return out

    train.train_model, train.teacher_pool = recording, pool
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            fams = train.get_or_train_families(
                tmp, steps=TRAIN_STEPS, batch=TRAIN_BATCH, with_mid=True,
                device=dev)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            names = sorted(p.name for p in Path(tmp).iterdir())
            loaded = load_families(tmp, with_mid=True, device=dev)
    finally:
        train.train_model, train.teacher_pool = real_train, real_pool
    check(names == ["diffusion_F3.ckpt", "diffusion_F3_mid.ckpt",
                    "diffusion_XL.ckpt", "diffusion_XL_mid.ckpt"],
          f"trained checkpoints: {names}")
    check(sorted(losses) == sorted(f"{f}/{r}" for f, r in TRAIN_NETS)
          and all(len(v) == TRAIN_STEPS for v in losses.values()),
          f"trained models: {sorted(losses)}")
    falls = {k: (float(np.mean(v[:5])), float(np.mean(v[-5:])))
             for k, v in losses.items()}
    check(all(last < first for first, last in falls.values()),
          f"a model's loss did not fall (first 5, last 5): {falls}")
    want = {"XL": 0, "F3": len(fams["F3"].spec.sigmas_edge) - 1}
    got = {f: pools.get(f, {}).get("fused_cfg_step") for f in want}
    check(got == want and all(
        v == 0 for p in pools.values() for k, v in p.items()
        if k != "fused_cfg_step"),
        f"teacher-pool launches {pools}, interior step want {want}")
    for fam in ("XL", "F3"):
        for role in ("large", "mid", "small"):
            a = getattr(fams[fam], f"{role}_params").state_dict()
            b = getattr(loaded[fam], f"{role}_params").state_dict()
            check(a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                               for k in a),
                  f"{fam}/{role}: the checkpoint read back differs")
    print(f"get_or_train_families on the card ({TRAIN_STEPS} steps, batch "
          f"{TRAIN_BATCH}, with_mid; fine-tune {min(350, TRAIN_STEPS)} "
          f"steps): {seconds:.1f} s; loss mean of the first and last 5 "
          f"steps {json.dumps(falls)}; teacher-pool interior-step launches "
          f"{json.dumps(got)}; {len(names)} checkpoints read back bit for "
          f"bit")
    return fams, seconds


def quality_means(ex, seeds) -> dict:
    """Per arm, the mean of each quality metric over ``seeds``."""
    table = ex.quality_table(seeds)
    return {arm.label: {k: float(np.mean([m[k] for m in table[:, arm.idx]]))
                        for k in table[0, arm.idx]} for arm in ex.arms}


def recorder(fn, calls):
    """``fn`` recording each call's time value and prediction."""
    def call(params, x, t, cond):
        pred = fn(params, x, t, cond)
        calls.append((float(t), pred))
        return pred
    return call


def sada_deltas(calls) -> list:
    """SADA's stability measure after each recorded call but the first,
    as ``sada_sample`` computes it."""
    preds = [p for _, p in calls]
    return [float(torch.linalg.norm(b - a) / (torch.linalg.norm(a) + 1e-8))
            for a, b in zip(preds, preds[1:])]


def baseline_phase(dev, cards, cpus, total) -> dict:
    """Phase 20 (d): the four Table III samplers on the committed trained
    large nets, ``BASELINE_REQUESTS`` requests per family from host-drawn
    noise, card against CPU (latents within ``RAW_RTOL``, evals equal, the
    same model calls; a SADA run whose calls differ only after a
    stability test within ``SADA_TIE`` of its threshold is reported as a
    tie), the interior step launched once per F3 step and never on XL (each
    call counted from 0 just before it); then ms per request of each on
    the card in alternating turns."""
    from repro_torch.core import accel_baselines as ab
    from repro_torch.diffusion import synth
    from repro_torch.kernels import build

    n = BASELINE_REQUESTS
    inputs, rel, evals, ties = {}, {}, {}, {}
    for fam in ("XL", "F3"):
        spec = cards[fam].spec
        cond = torch.from_numpy(np.stack([
            synth.embed(synth.sample_prompt(i), fam) for i in range(n)]))
        xT = torch.randn((n,) + spec.latent_shape,
                         generator=torch.Generator().manual_seed(31))
        inputs[fam] = (xT.to(dev), cond.to(dev))
        steps = len(spec.sigmas_edge) - 1
        for name in BASELINES:
            sample = getattr(ab, f"{name}_sample")
            what = f"{fam} {name}"
            calls = {"card": [], "cpu": []}
            torch.cuda.synchronize()
            build.reset_launches()
            x_card, ev_card = sample(
                spec.kind, recorder(cards[fam].large_fn, calls["card"]),
                cards[fam].large_params, inputs[fam][0], spec.sigmas_edge,
                inputs[fam][1])
            torch.cuda.synchronize()
            got = dict(build.LAUNCHES)
            want = dict.fromkeys(KERNELS, 0)
            want["fused_cfg_step"] = steps if spec.kind == "rf" else 0
            check(got == want, f"{what}: launches {got}, want {want}")
            for k in total:
                total[k] += got[k]
            x_cpu, ev_cpu = sample(
                spec.kind, recorder(cpus[fam].large_fn, calls["cpu"]),
                cpus[fam].large_params, xT, spec.sigmas_edge, cond)
            check(x_card.shape == xT.shape
                  and bool(torch.isfinite(x_card).all()),
                  f"{what}: output shape or non-finite values")
            t_card = [t for t, _ in calls["card"]]
            t_cpu = [t for t, _ in calls["cpu"]]
            if t_card != t_cpu and name == "sada":
                # the first call that differs follows the stability test
                # of the call before it
                k = next((i for i, (a, b) in enumerate(zip(t_card, t_cpu))
                          if a != b), min(len(t_card), len(t_cpu)))
                deltas = (sada_deltas(calls["card"])[k - 2],
                          sada_deltas(calls["cpu"])[k - 2])
                check(min(abs(d - SADA_THRESHOLD) for d in deltas)
                      < SADA_TIE,
                      f"{what}: the skipped steps differ at call {k} "
                      f"(stability {deltas})")
                ties[what] = {"call": k, "deltas": deltas}
                continue
            check(t_card == t_cpu, f"{what}: the model calls differ")
            check(type(ev_card) is type(ev_cpu) and ev_card == ev_cpu,
                  f"{what}: evals {ev_card} vs {ev_cpu}")
            rel[what] = norm_rel(x_card.cpu(), x_cpu)
            check(rel[what] <= RAW_RTOL, f"{what}: card vs CPU rel "
                  f"{rel[what]}")
            evals[what] = ev_card
    print(f"baselines card vs CPU ({n} requests a family; evals and model "
          f"calls equal): latents rel {json.dumps(rel)}; evals "
          f"{json.dumps(evals)}; SADA ties {json.dumps(ties)}")

    ms = {f"{fam} {name}": [] for fam in ("XL", "F3") for name in BASELINES}
    for _ in range(BASELINE_TURNS):
        for fam in ("XL", "F3"):
            spec = cards[fam].spec
            for name in BASELINES:
                sample = getattr(ab, f"{name}_sample")
                build.reset_launches()
                x, cond = inputs[fam]
                _, t = host_timed(lambda: sample(
                    spec.kind, cards[fam].large_fn, cards[fam].large_params,
                    x, spec.sigmas_edge, cond))
                ms[f"{fam} {name}"].append(t / n)
                for k in total:
                    total[k] += build.LAUNCHES[k]
    loop = {k: {"median_ms": float(np.median(v)), "turns_ms": v}
            for k, v in ms.items()}
    print(f"baselines ms per request on the card ({BASELINE_TURNS} turns, "
          f"{n}-request batches): {json.dumps(loop)}")
    return loop


def step_seconds(dev, teachers) -> dict:
    """Phase 20 (e): seconds per training step of each net (full width,
    batch 64, the same step repeated) on the card and on the CPU."""
    import copy

    from repro_torch.diffusion import train

    out = {}
    for k, (fam, role) in enumerate(TRAIN_NETS):
        _, net0, loss, base_lr = train_setup(fam, role, 20 + k, teachers)
        row = {}
        for key, where, reps in (("card_s", dev, 20), ("cpu_s", "cpu", 3)):
            where = torch.device(where)
            net = copy.deepcopy(net0).to(where)
            opt = train.Adam(net)
            step = lambda i: train.train_step(opt, lambda: loss(net, where),
                                              i, TRAIN_STEPS, base_lr)
            float(step(1))
            t0 = time.perf_counter()
            for i in range(reps):
                last = step(2 + i)
            float(last)
            row[key] = (time.perf_counter() - t0) / reps
        out[f"{fam}/{role}"] = row
    print(f"seconds per training step (batch {TRAIN_BATCH}, host draws "
          f"made before the timed steps; card 20 steps, CPU 3): "
          f"{json.dumps(out)}")
    return out


def train_phase(dev) -> dict:
    """Phase 20: diffusion training and the Table III baselines on the
    card: (a) one step of each net card against CPU; (b)
    ``get_or_train_families`` on the card into a temporary directory; (c)
    the quality table of the card-trained families beside the committed
    ones (a reading); (d) the baselines card against CPU and their ms per
    request; (e) seconds per training step on each device.  Nothing
    under ``results/`` changes.  Returns the phase's kernel launches."""
    from repro_torch.diffusion.families import load_families
    from repro_torch.serving.arms import build_action_space
    from repro_torch.serving.executor import Executor

    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    before = results_digest()
    committed = {"cuda": load_families(CKPTS, device=dev),
                 "cpu": load_families(CKPTS, device="cpu")}
    teachers = {k: {f: v.large_params for f, v in fams.items()}
                for k, fams in committed.items()}

    train_step_checks(dev, teachers)
    trained, _ = trained_families(dev, total)

    # (c) a reading, not held: quality of the card-trained families
    seeds = np.arange(BASELINE_REQUESTS)
    means = {k: quality_means(Executor(f, arms=build_action_space(),
                                       device=dev), seeds)
             for k, f in (("trained", trained),
                          ("committed", committed["cuda"]))}
    print(f"quality_table means, {BASELINE_REQUESTS} requests (a reading: "
          f"families trained {TRAIN_STEPS} steps on the card beside the "
          f"committed ones): {json.dumps(means)}")

    baseline_phase(dev, committed["cuda"], committed["cpu"], total)
    step_seconds(dev, teachers)
    if (REPO / ".git").exists():
        status = subprocess.run(["git", "status", "--porcelain", "results/"],
                                cwd=REPO, capture_output=True, text=True,
                                check=True).stdout
        check(status == "", f"results/ changed: {status}")
    check(results_digest() == before, "a file under results/ changed")
    print(f"training phase launches: {json.dumps(total)}; results/ "
          f"unchanged; {time.perf_counter() - t0:.1f} s")
    return total


def lm_train_batch(cfg, rows: int, seq: int, step: int, where) -> dict:
    """Step ``step`` of the token pipeline at ``cfg``'s vocabulary, as
    ``launch/train.py`` feeds it, on ``where``."""
    from repro_torch.training.data import DataConfig, TokenPipeline

    toks, labels = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq,
        global_batch=rows)).batch(step)
    return {"tokens": torch.from_numpy(toks).to(where),
            "labels": torch.from_numpy(labels).to(where)}


def flash_layers(cfg, ctx: bool = False) -> int:
    """The flash-attention calls of one forward of ``cfg``: its GQA
    layers (MLA's attention is plain torch, as in the reference); with
    ``ctx`` (a forward over a context), also each cross layer's call and
    each encoder layer's."""
    from repro_torch.models import transformer as tr

    if cfg.mla is not None:
        return 0
    n = mixer_layers(cfg, "attn")
    if ctx:
        n += sum(spec.cross_attn for spec in tr.layer_specs(cfg))
        n += cfg.encoder.n_layers if cfg.encoder is not None else 0
    return n


def lm_launches(cfg, forwards: int, ctx: bool = False) -> dict:
    """The kernel launches of ``forwards`` training forwards of ``cfg``
    (over a context with ``ctx``): flash attention once per call of
    :func:`flash_layers`, the scan once per RG-LRU layer (a backward
    launches neither: it is the plain versions' VJP)."""
    return {"flash_attention": flash_layers(cfg, ctx) * forwards,
            "rglru_scan": mixer_layers(cfg, "rglru") * forwards}


def lm_train_step_checks(dev, total) -> dict:
    """Phase 21 (a): one training step card against ``device="cpu"`` from
    the same weights (drawn on the card, copied) and batch, fp32: the
    loss, every parameter's gradient (none ``None`` on either device, each
    within ``TRAIN_GRAD_RTOL`` of the CPU's, max |Δ| over max |CPU|), the
    step's loss, ``grad_norm`` and ``lr``, and the parameters after it
    (within ``TRAIN_PARAM_RTOL`` of the tensor's largest plus twice the
    update difference the two gradients predict; phase 20's floor
    statistics printed beside); seconds per step on each device.  The
    comparisons run on the card in fp64.  The kernels launch as
    :func:`lm_launches` counts, exactly (:func:`lm_step_case`)."""
    from repro_torch import configs
    from repro_torch.device import keep_fp32
    from repro_torch.models import transformer as tr

    keep_fp32(dev)  # as launch/train.py does: fp32 products
    cpu = torch.device("cpu")
    cases = [(name, configs.make_reduced(configs.get_config(name)),
              LM_TRAIN_ROWS, LM_TRAIN_SEQ) for name in LM_TRAIN_NAMES]
    cases.append((f"{LM_FULL_NAME}/full", configs.get_config(
        LM_FULL_NAME).replace(n_layers=LM_FULL_LAYERS, dtype="float32"),
        LM_FULL_ROWS, LM_FULL_SEQ))
    out = {}
    for k, (what, cfg, rows, seq) in enumerate(cases):
        card = tr.init_model(cfg, torch.Generator(device=dev)
                             .manual_seed(40 + k), dev)
        batches = {key: lm_train_batch(cfg, rows, seq, k, where)
                   for key, where in (("card", dev), ("cpu", cpu))}
        out[what] = lm_step_case(dev, what, cfg, card, batches, total)
        del card
        torch.cuda.empty_cache()
    print(f"LM training step card vs CPU: fp32; reduced at "
          f"{LM_TRAIN_ROWS} x {LM_TRAIN_SEQ} tokens, {LM_FULL_NAME} full "
          f"width {LM_FULL_LAYERS} layers at {LM_FULL_ROWS} x "
          f"{LM_FULL_SEQ}; seconds per step: the card over "
          f"{LM_TIMED_STEPS} more steps, the CPU of the checked step")
    return out


def lm_step_case(dev, what, cfg, card, batches, total, mlstm_chunk=None,
                 loss_rtol=TRAIN_LOSS_RTOL) -> dict:
    """One case of :func:`lm_train_step_checks`: the model ``card`` (on
    the card) and a copy of it on the CPU, each trained one step on its
    batch of ``batches`` (``"card"``, ``"cpu"``; the same values, a
    context included if any), checked as that function says, every
    gradient also finite; the loss, the step's loss and ``grad_norm``
    within ``loss_rtol``; the kernels' launches added to ``total``.  An
    xLSTM model's mLSTM layers run chunkwise with ``mlstm_chunk``."""
    import copy

    from repro_torch.kernels import build
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    t_case = time.perf_counter()
    cpu = torch.device("cpu")
    c = opt.OptConfig(**LM_TRAIN_OPT)
    models = {"card": card, "cpu": copy.deepcopy(card).to(cpu)}
    with_ctx = "ctx" in batches["card"]
    loss_fn = ts.make_loss_fn(cfg, remat=False, mlstm_chunk=mlstm_chunk)
    read, steps, seconds = {}, {}, {}
    for key in ("cpu", "card"):
        model = models[key]
        build.reset_launches()
        model.requires_grad_(True)
        loss, _ = loss_fn(model, batches[key])
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        read[key] = (float(loss.detach()), dict(zip(names, grads)))
        # the whole step, from the same weights (timed on the CPU)
        step = ts.make_train_step(cfg, c, remat=False,
                                  mlstm_chunk=mlstm_chunk)
        state = opt.adamw_init(dict(model.named_parameters()), c)
        t0 = time.perf_counter()
        _, state, m = step(model, state, batches[key])
        steps[key] = ({n: p.detach().clone() for n, p in
                       model.named_parameters()},
                      {n: float(v) for n, v in m.items()})
        seconds[key] = time.perf_counter() - t0
        # on the card, seconds per step over more steps on the batch
        reps = LM_TIMED_STEPS if key == "card" else 0
        if reps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                _, state, m = step(model, state, batches[key])
            float(m["loss"])
            seconds[key] = (time.perf_counter() - t0) / reps
        if key == "card":  # the gradients' forward, the step's, reps
            got = {n: build.LAUNCHES[n] for n in
                   ("flash_attention", "rglru_scan")}
            want = lm_launches(cfg, 2 + reps, with_ctx)
            check(got == want, f"{what}: launches {got}, want {want}")
            for n in got:
                total[n] += got[n]
    (l_cpu, g_cpu), (l_card, g_card) = read["cpu"], read["card"]
    missing = sorted(n for n in g_cpu if g_cpu[n] is None
                     or g_card[n] is None)
    nonfinite = sorted(n for n in g_cpu if n not in missing and not (
        torch.isfinite(g_cpu[n]).all() and torch.isfinite(g_card[n]).all()))
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_rel = {n: float((g_card[n].double() - g.to(dev).double())
                         .abs().max() / g.to(dev).double().abs().max()
                         .clamp_min(1e-30))
                for n, g in g_cpu.items() if n not in missing}
    (p_cpu, m_cpu), (p_card, m_card) = steps["cpu"], steps["card"]
    metric_rel = {n: abs(m_card[n] - m_cpu[n]) / abs(m_cpu[n])
                  for n in ("loss", "grad_norm")}
    lr_ulps = ulps(m_card["lr"], m_cpu["lr"])
    # Adam's first update is lr·x/(|x| + eps), x the clipped gradient:
    # each element is held within TRAIN_PARAM_RTOL of its tensor's
    # largest |p| plus twice the difference its two gradients predict
    # (large only where |x| is near eps)
    def update(g, norm):  # on the card, in fp64
        x = g.detach().to(dev).double() * min(
            1.0, c.grad_clip / (norm + 1e-9))
        return x / (x.abs() + c.eps)
    worst, excess, floor, beyond = 0.0, 0.0, 0, 0
    for name, p in p_cpu.items():
        if name in missing:
            continue
        p = p.to(dev).double()
        scale = float(p.abs().max())
        err = (p_card[name].double() - p).abs()
        pred = m_cpu["lr"] * (update(g_card[name], m_card["grad_norm"])
                              - update(g_cpu[name], m_cpu["grad_norm"])
                              ).abs()
        excess = max(excess, float((err / (TRAIN_PARAM_RTOL * scale
                                            + 2 * pred)).max()))
        g = g_cpu[name].detach().to(dev).abs()
        low = g < max(GRAD_FLOOR * float(g.max()), EPS_FLOOR)
        if (~low).any():
            worst = max(worst, float(err[~low].max()) / scale)
        floor += int(low.sum())
        beyond += int((err[low] > TRAIN_PARAM_RTOL * scale).sum())
    res = {"loss_rel": loss_rel,
           "grad_rel": max(grad_rel.values()),
           "grad_rel_at": max(grad_rel, key=grad_rel.get),
           "params_with_grad": len(grad_rel),
           "step_rel": metric_rel, "lr_ulps": lr_ulps,
           "param_bound_share": excess,
           "param_rel_off_floor": worst, "floor_elements": floor,
           "floor_beyond": beyond,
           "card_s": seconds["card"], "cpu_s": seconds["cpu"],
           "case_s": time.perf_counter() - t_case}
    print(f"LM training step card vs CPU, {what}: {json.dumps(res)}")
    check(missing == [], f"{what}: parameters without a gradient "
          f"{missing}")
    check(nonfinite == [], f"{what}: gradients not finite {nonfinite}")
    check(loss_rel <= loss_rtol,
          f"{what}: loss card {l_card} vs CPU {l_cpu}")
    check(max(grad_rel.values()) <= TRAIN_GRAD_RTOL,
          f"{what}: gradient card vs CPU rel {max(grad_rel.values())}")
    check(max(metric_rel.values()) <= loss_rtol,
          f"{what}: step metrics card {m_card} vs CPU {m_cpu}")
    check(lr_ulps <= TRAIN_ADAM_ULPS, f"{what}: lr {lr_ulps} ulps")
    check(excess <= 1.0, f"{what}: parameters after a step beyond their "
          f"bound ({excess} of it)")
    del models, read, steps
    return res


def lm_bf16_training(dev, total) -> dict:
    """Phase 21 (b): ``gemma2-27b`` at full width in bf16 on the card, 2
    layers (its local window cut to ``LM_BF16_WINDOW``, so that the mask
    bites inside 64 tokens, then global), the tied 256k head through the
    chunked loss, ``remat`` on: ``LM_BF16_STEPS`` steps on one batch.  The
    loss stays finite and falls; every step launches the scoring kernel
    once per attention layer in the forward and once more in ``remat``'s
    recompute, and no other flash kernel; every weight moves.  Each
    attention layer's flash call of the first forward is kept (its
    operands, in the model's strided layout, and its keywords) and, after
    the counted steps, launched again and held to the plain version within
    ``FLASH_TOL``: the scoring kernel's softcap and window on the operands
    training gives it."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tr
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    base = configs.get_config(LM_BF16_NAME)
    pattern = tuple(dataclasses.replace(
        spec, window=LM_BF16_WINDOW if spec.window else None)
        for spec in base.pattern)
    cfg = base.replace(n_layers=2, pattern=pattern)
    model = tr.init_model(cfg, torch.Generator(device=dev).manual_seed(50),
                          dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    c = opt.OptConfig(**dict(LM_TRAIN_OPT, total_steps=LM_BF16_STEPS))
    state = opt.adamw_init(dict(model.named_parameters()), c)
    step = ts.make_train_step(cfg, c, remat=True, ce_chunk=LM_BF16_CHUNK)
    batch = lm_train_batch(cfg, LM_FULL_ROWS, LM_FULL_SEQ, 0, dev)
    build.reset_launches()
    flash_ops.reset_variant_launches()
    losses, times = [], []
    # the first forward's calls, kept
    with FlashReplay(f"{LM_BF16_NAME} bf16",
                     keep=mixer_layers(cfg, "attn")) as flash:
        for _ in range(LM_BF16_STEPS):
            (_, state, m), ms = host_timed(lambda: step(model, state, batch))
            losses.append(float(m["loss"]))
            times.append(ms / 1e3)
    got = {n: build.LAUNCHES[n] for n in ("flash_attention", "rglru_scan")}
    want = lm_launches(cfg, 2 * LM_BF16_STEPS)  # forward + recompute
    check(got == want, f"{LM_BF16_NAME} bf16: launches {got}, want {want}")
    variants = dict(flash_ops.VARIANT_LAUNCHES)
    check(variants == {"simt": 0, "decode": 0,
                       "scoring": want["flash_attention"]},
          f"{LM_BF16_NAME} bf16: flash kernels {variants}")
    for n in got:
        total[n] += got[n]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{LM_BF16_NAME} bf16: losses {losses}")
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()),
          f"{LM_BF16_NAME}: a weight left bf16")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    check(still == [], f"{LM_BF16_NAME} bf16: weights unchanged by "
          f"{LM_BF16_STEPS} steps: {still}")
    del before
    # the kept calls against the plain version (not counted launches)
    read = flash.replay()
    windows = [spec.window for spec in tr.layer_specs(cfg)]
    check([kw["window"] for _, kw, _, _ in flash.log] == windows
          and all(kw["softcap"] == cfg.attn_softcap
                  for _, kw, _, _ in flash.log)
          and set(read) == {"scoring"},
          f"{LM_BF16_NAME} bf16: kept flash calls "
          f"{[(v, kw) for v, kw, _, _ in flash.log]}")
    replay = [{"window": kw["window"], "softcap": kw["softcap"],
               "max_abs_err": err, "share_of_tol": share}
              for _, kw, err, share in flash.log]
    out = {"params_b": cm.count_params(model) / 1e9, "losses": losses,
           "first_step_s": times[0],
           "step_s": float(np.median(times[1:])), "launches": got,
           "flash_variants": variants, "flash_replay": replay}
    print(f"{LM_BF16_NAME} bf16 training on the card (full width, 2 layers, "
          f"window {LM_BF16_WINDOW}, ce_chunk {LM_BF16_CHUNK}, remat, "
          f"{LM_FULL_ROWS} x {LM_FULL_SEQ} tokens): {json.dumps(out)}")
    del model, state, flash
    torch.cuda.empty_cache()
    return out


def lm_launch_resume(dev, total, arch: str = "stablelm-1.6b") -> dict:
    """Phase 21 (c) (and 24 (d) with ``arch`` xlstm-1.3b): ``python -m
    repro_torch.launch.train --arch <arch>``'s ``main`` on the card (its
    default device), reduced: 8 steps, then 4 steps into another
    directory resumed to 8 (the reference's resume test); the resumed
    losses within its ``rtol=1e-5`` of the uninterrupted run's, and
    whether the bits are equal (printed)."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch_train

    cfg = configs.make_reduced(configs.get_config(arch))
    args = ["--arch", arch] + LAUNCH_ARGS
    build.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        full = launch_train.main(args + ["--steps", "8",
                                         "--ckpt-dir", f"{tmp}/a"])
        seconds = time.perf_counter() - t0
        launch_train.main(args + ["--steps", "4", "--ckpt-dir", f"{tmp}/b"])
        resumed = launch_train.main(args + [
            "--steps", "8", "--resume", "--ckpt-dir", f"{tmp}/b"])
        files = sorted(p.name for p in Path(f"{tmp}/b/{arch}").iterdir())
    got = {n: build.LAUNCHES[n] for n in ("flash_attention", "rglru_scan")}
    want = lm_launches(cfg, 16)
    check(got == want, f"launch.train: launches {got}, want {want}")
    for n in got:
        total[n] += got[n]
    rel = float(np.max(np.abs(np.array(resumed) / np.array(full[4:]) - 1)))
    check(len(resumed) == 4 and rel <= 1e-5,
          f"launch.train resume: {resumed} vs {full[4:]}")
    check(files == ["latest", "step_00000004.ckpt", "step_00000008.ckpt"],
          f"launch.train checkpoints {files}")
    out = {"losses": full, "resumed": resumed, "resume_rel": rel,
           "bits_equal": resumed == full[4:], "run_s": seconds}
    print(f"launch.train on the card ({arch} reduced, 8 steps; 4 + "
          f"resumed to 8): {json.dumps(out)}")
    return out


def device_branch_bytes(cfg, rows: int, seq: int, dev) -> dict:
    """The bytes, by op, that a training step of ``cfg`` over ``rows`` x
    ``seq`` tokens (fp32, one forward) counts on the CPU and not on the
    card, from the two branches a step takes by device:

    * ``flash_layout``: the flash kernel writes its output as (B, S, H,
      D), so the attention's ``out.transpose(1, 2).reshape(...)`` is a
      view on the card, and on the CPU a copy (``aten.clone``: read and
      write) of the plain version's (B, H, S, D) output, once per flash
      call (``tests/test_torch_analysis.py`` emulates the card's layout);
    * ``one_hot_check``: torch's ``F.one_hot`` (the MoE's balance term,
      ``models/mlp.py::_route``, once per MoE layer) checks a CPU tensor's
      classes (their least and largest, read to the host; the ops depend
      on torch's version) and leaves a CUDA tensor's to the device:
      counted here at the routing's shape on both devices."""
    from repro_torch.models import transformer as tr

    out = collections.Counter({"aten.clone": flash_layers(cfg) * 2 * rows
                               * seq * cfg.n_heads * cfg.head_dim * 4})
    moe_layers = sum(spec.mlp == "moe" for spec in tr.layer_specs(cfg))
    if moe_layers:
        counts = []
        for where in ("cpu", dev):
            idx = torch.zeros(rows, seq, cfg.moe.top_k, dtype=torch.long,
                              device=where)
            with rl.CostCounter() as c:
                F.one_hot(idx, cfg.moe.n_experts)
            counts.append(c.by_op)
        for op in set(counts[0]) | set(counts[1]):
            out[op] += moe_layers * (counts[0].get(op, [0, 0, 0])[2]
                                     - counts[1].get(op, [0, 0, 0])[2])
    return {op: n for op, n in out.items() if n}


def lm_train_costs(dev, total) -> dict:
    """Phase 21 (d): one training step of each of ``LM_TRAIN_NAMES``'
    ``make_reduced`` (fp32, as (a): the same weights and batch on both
    devices) counted by ``analysis.roofline.CostCounter`` on the CPU (the
    kernels' plain versions) and on the card (the flash and scan kernels,
    exactly :func:`lm_launches` of one forward): the flops equal exactly,
    the bytes equal but for the two branches a step takes by device,
    :func:`device_branch_bytes` (the CPU's count less the card's equal to
    it exactly, op by op).  Each case's roofline (``analyze``) on the card
    is printed."""
    import copy

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tr
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    cpu = torch.device("cpu")
    c = opt.OptConfig(**LM_TRAIN_OPT)
    out = {}
    for k, name in enumerate(LM_TRAIN_NAMES):
        cfg = configs.make_reduced(configs.get_config(name))
        card = tr.init_model(cfg, torch.Generator(device=dev)
                             .manual_seed(40 + k), dev)
        models = {"card": card, "cpu": copy.deepcopy(card).to(cpu)}
        counts = {}
        for key, where in (("cpu", cpu), ("card", dev)):
            model = models[key]
            batch = lm_train_batch(cfg, LM_TRAIN_ROWS, LM_TRAIN_SEQ, k, where)
            step = ts.make_train_step(cfg, c, remat=False)
            state = opt.adamw_init(dict(model.named_parameters()), c)
            build.reset_launches()
            with rl.CostCounter() as counter:
                _, _, m = step(model, state, batch)
                float(m["loss"])
            counts[key] = counter
        got = {n: build.LAUNCHES[n] for n in ("flash_attention", "rglru_scan")}
        want = lm_launches(cfg, 1)
        check(got == want, f"{name} counted step: launches {got}, want {want}")
        for n in got:
            total[n] += got[n]
        a, b = counts["cpu"], counts["card"]
        explained = device_branch_bytes(cfg, LM_TRAIN_ROWS, LM_TRAIN_SEQ, dev)
        differ = {op: (a.by_op.get(op), b.by_op.get(op))
                  for op in set(a.by_op) | set(b.by_op)
                  if a.by_op.get(op) != b.by_op.get(op)}
        less = {op: (a.by_op.get(op, [0, 0, 0])[2]
                     - b.by_op.get(op, [0, 0, 0])[2]) for op in differ}
        res = {"flops": b.flops, "flops_fp32": b.flops_fp32,
               "bytes_card": b.bytes, "bytes_cpu": a.bytes,
               "cpu_less_card": a.bytes - b.bytes,
               "cpu_less_card_by_op": less, "explained": explained,
               "kernels": {op: row for op, row in b.by_op.items()
                           if op.startswith("kernel:")},
               "roofline": {k: v for k, v in rl.analyze(b.summary(), 1).items()
                            if k in ("t_compute_s", "t_memory_s", "dominant")}}
        out[name] = res
        print(f"LM training step counted, {name}: {json.dumps(res)}")
        check(a.flops == b.flops and a.flops_fp32 == b.flops_fp32,
              f"{name}: flops CPU {a.flops} card {b.flops}; by op {differ}")
        check({op: n for op, n in less.items() if n} == explained
              and a.bytes - b.bytes == sum(explained.values()),
              f"{name}: bytes CPU {a.bytes} card {b.bytes}, "
              f"{explained} explained; by op {differ}")
        del models, card, counts
        torch.cuda.empty_cache()
    return out


def lm_train_phase(dev) -> dict:
    """Phase 21: LM training on the card, (a) card against CPU, (b) bf16
    at full width, (c) ``launch.train`` and its resume, (d) a step's cost count
    card against CPU.  Returns the phase's kernel launches."""
    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    lm_train_step_checks(dev, total)
    lm_bf16_training(dev, total)
    lm_launch_resume(dev, total)
    lm_train_costs(dev, total)
    print(f"LM training phase launches: {json.dumps(total)}; "
          f"{time.perf_counter() - t0:.1f} s; card: {card_line()}")
    return total


# ---- 22. MoE and MLA -----------------------------------------------------


class MoECalls:
    """Records every MoE call while active: ``_route``'s experts and
    probabilities and, with ``inputs``, the layer, its input and its
    output (copies; the recorded tensors stay on their device).  It
    patches ``models/mlp.py``'s ``_route`` and ``moe_fwd``, which the
    layer looks up at each call."""

    def __init__(self, inputs: bool = False):
        self.inputs, self.calls = inputs, []

    def __enter__(self):
        from repro_torch.models import mlp as mlp_mod

        self.route, self.fwd = mlp_mod._route, mlp_mod.moe_fwd

        def route(router, xf, m):
            top_p, top_idx, aux = self.route(router, xf, m)
            self.calls.append({"top_idx": top_idx.clone(),
                               "top_p": top_p.detach().clone(),
                               "aux": aux.detach().clone()})
            return top_p, top_idx, aux

        def fwd(p, cfg, x, **kw):
            out, aux = self.fwd(p, cfg, x, **kw)
            if self.inputs:
                self.calls[-1].update(p=p, x=x.detach().clone(),
                                      out=out.detach().clone())
            return out, aux

        mlp_mod._route, mlp_mod.moe_fwd = route, fwd
        return self.calls

    def __exit__(self, *exc):
        from repro_torch.models import mlp as mlp_mod

        mlp_mod._route, mlp_mod.moe_fwd = self.route, self.fwd
        return False


def routing_flips(card: list, cpu: list) -> int:
    """The experts chosen differently by the two devices' MoE calls (the
    calls pair in order; a missing call fails)."""
    check(len(card) == len(cpu) and len(card) > 0,
          f"MoE calls: card {len(card)}, CPU {len(cpu)}")
    return sum(int((a["top_idx"].cpu() != b["top_idx"]).sum())
               for a, b in zip(card, cpu))


def moe_oracle(p, cfg, x, top_idx, top_p) -> torch.Tensor:
    """One MoE call in fp32 on the card, token by token from the same
    routing: each token's kept experts (an assignment is kept while fewer
    than ``capacity`` earlier assignments, in flat token-major order, went
    to its expert), ``w · expert(x)`` summed, plus the shared expert."""
    m = cfg.moe
    act = F.silu if cfg.act == "silu" else None
    check(act is not None, f"oracle: activation {cfg.act}")
    xf = x.reshape(-1, x.shape[-1]).float()
    t, k = top_idx.shape
    cap = max(8, min(int(t * k * m.capacity_factor / m.n_experts) + 1, t))
    flat = F.one_hot(top_idx.reshape(-1), m.n_experts)
    earlier = (flat.cumsum(0) - flat) * flat
    keep = (earlier.sum(1) < cap).view(t, k)
    out = torch.zeros_like(xf)
    for e in torch.unique(top_idx[keep]).tolist():
        sel = (top_idx == e) & keep
        rows = sel.any(1).nonzero()[:, 0]
        w = (top_p * sel).sum(1)[rows, None]
        xe = xf[rows]
        y = (act(xe @ p.we_gate[e].float()) * (xe @ p.we_up[e].float())
             ) @ p.we_down[e].float()
        out[rows] += w * y
    if m.n_shared:
        s = p.shared
        out += (act(xf @ s.w_gate.float()) * (xf @ s.w_up.float())
                ) @ s.w_down.float()
    return out


def moe_oracle_checks(what: str, calls: list, cfg) -> dict:
    """Every recorded bf16 MoE call against :func:`moe_oracle` within
    ``MOE_ORACLE_RTOL``; the largest error, the calls and their tokens,
    and the distinct experts a one-row-per-prompt (decode) call read."""
    worst, tokens, distinct = 0.0, 0, []
    for c in calls:
        ref = moe_oracle(c["p"], cfg, c["x"], c["top_idx"], c["top_p"])
        got = c["out"].reshape(ref.shape)
        check(torch.isfinite(got).all(), f"{what}: a MoE output not finite")
        worst = max(worst, norm_rel(got, ref))
        tokens += ref.shape[0]
        if c["x"].shape[1] == 1:
            distinct.append(int(torch.unique(c["top_idx"]).numel()))
    check(worst <= MOE_ORACLE_RTOL, f"{what}: a MoE call {worst} off its "
          f"fp32 oracle (MOE_ORACLE_RTOL {MOE_ORACLE_RTOL})")
    return {"calls": len(calls), "tokens": tokens, "oracle_rel": worst,
            "distinct_experts_per_decode_call": (
                float(np.mean(distinct)) if distinct else None)}


def moe_card_vs_cpu(dev) -> dict:
    """Phase 22 (a): ``make_reduced`` of both MoE models in fp32, the same
    weights (drawn on the card, copied) on the card and the CPU: every MoE
    call's experts equal (no flip), the forward logits, each decode step's
    logits (deepseek's MLA expanded and absorbed; llama4 at its top-1 and
    at top-2, where each step is also held to the forward, as the
    reference's ``test_decode_matches_forward`` holds top-1 MoE at k = 2),
    the MTP logits and the aux term, within ``LM_RTOL``."""
    import copy

    from repro_torch import configs
    from repro_torch.models import transformer as tr

    cpu = torch.device("cpu")
    out = {}
    for i, name in enumerate((MOE_DS, MOE_L4)):
        base = configs.make_reduced(configs.get_config(name))
        card = tr.init_model(base, torch.Generator(device=dev)
                             .manual_seed(70 + i), dev)
        models = {"card": card, "cpu": copy.deepcopy(card).to(cpu)}
        variants = {"base": base}
        if base.mla is not None:
            variants["absorb"] = base.replace(mla=dataclasses.replace(
                base.mla, absorb=True))
        if base.moe.top_k == 1:
            variants["top2"] = base.replace(moe=dataclasses.replace(
                base.moe, top_k=2))
        for variant, cfg in variants.items():
            toks = lm_train_batch(cfg, MOE_CHECK_ROWS, MOE_CHECK_SEQ, i,
                                  cpu)["tokens"].long()
            read = {}
            for key, where in (("card", dev), ("cpu", cpu)):
                model, x = models[key], toks.to(where)
                with torch.no_grad(), MoECalls() as calls:
                    full = tr.model_fwd(model, cfg, {"tokens": x})
                    cache = tr.init_model_cache(cfg, MOE_CHECK_ROWS,
                                                MOE_CHECK_SEQ, device=where)
                    steps = []
                    for j in range(MOE_CHECK_SEQ):
                        lg, cache = tr.decode_step(model, cfg, cache,
                                                   x[:, j:j + 1], j)
                        steps.append(lg[:, 0])
                    _, aux, extras = tr.train_fwd(model, cfg, {"tokens": x})
                read[key] = {"full": full.cpu(),
                             "steps": torch.stack(steps, 1).cpu(),
                             "aux": float(aux), "calls": calls,
                             "mtp": (extras["mtp_logits"].cpu()
                                     if "mtp_logits" in extras else None)}
            a, b = read["card"], read["cpu"]
            flips = routing_flips(a["calls"], b["calls"])
            res = {"moe_calls": len(a["calls"]), "routing_flips": flips,
                   "logits_rel": norm_rel(a["full"], b["full"]),
                   "decode_rel": norm_rel(a["steps"], b["steps"]),
                   "aux_rel": abs(a["aux"] - b["aux"]) / abs(b["aux"])}
            if cfg.moe.top_k > 1:
                res["decode_vs_forward_rel"] = max(
                    norm_rel(r["steps"], r["full"]) for r in (a, b))
            if a["mtp"] is not None:
                res["mtp_rel"] = norm_rel(a["mtp"], b["mtp"])
            out[f"{name}/{variant}"] = res
            check(flips == 0, f"{name}/{variant}: {flips} experts chosen "
                  f"differently on the card and the CPU")
            worst = max(v for k, v in res.items() if k.endswith("_rel"))
            check(worst <= LM_RTOL and a["aux"] > 0,
                  f"{name}/{variant} card vs CPU: {res}")
        del models, card
    print(f"MoE/MLA card vs CPU (make_reduced, fp32, {MOE_CHECK_ROWS} x "
          f"{MOE_CHECK_SEQ} tokens): {json.dumps(out)}")
    return out


def weight_bytes(model, rows: int) -> int:
    """Bytes a decode step of ``rows`` tokens reads of the weights: every
    parameter once but the embedding, of which ``rows`` rows, and the MTP
    head, which decode does not run (the reference's dispatch reads every
    expert at every step)."""
    total = 0
    for name, p in model.named_parameters():
        if name.startswith("mtp_"):
            continue
        n = rows * p.shape[1] if name == "embed" else p.numel()
        total += n * p.element_size()
    return total


def expert_bytes(model) -> int:
    """Bytes of one expert's three matrices in the model's MoE layers."""
    moe = next(m for m in model.modules() if hasattr(m, "we_gate"))
    return sum(w[0].numel() * w.element_size()
               for w in (moe.we_gate, moe.we_up, moe.we_down))


def decode_times(what, model, cfg, prompt, moe_stats) -> dict:
    """ms per decode step of ``model`` (``greedy_decode`` of MOE_NEW
    tokens after the prompt, host clock over a synchronized run, every
    step counted), the busy share of one such run, and the step's byte
    bounds: every weight read (the reference's dispatch) and only the
    experts a step routes to (its MoE calls' mean distinct experts)."""
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import greedy_decode

    steps = prompt.shape[1] + MOE_NEW
    greedy_decode(model, cfg, prompt, 2)  # warm
    _, wall = host_timed(lambda: greedy_decode(model, cfg, prompt, MOE_NEW))
    share = busy(lambda: greedy_decode(model, cfg, prompt, MOE_NEW), wall)
    n_moe = sum(s.mlp == "moe" for s in tr.layer_specs(cfg))
    every = weight_bytes(model, prompt.shape[0])
    e_bytes = expert_bytes(model) * n_moe
    active = (every - cfg.moe.n_experts * e_bytes
              + moe_stats["distinct_experts_per_decode_call"] * e_bytes)
    out = {"ms_per_step": wall / steps,
           "bound_ms_every_expert": every / rl.HBM_BW * 1e3,
           "bound_ms_active_experts": active / rl.HBM_BW * 1e3,
           "weight_gb": every / 1e9, "busy": share}
    out["share_of_bound"] = out["bound_ms_every_expert"] / out["ms_per_step"]
    print(f"{what} decode: {json.dumps(out)}; card: {card_line()}")
    return out


def tokens_upto_tie(seqs: dict, logits: dict, p: int, n: int) -> tuple:
    """Two runs' tokens (``seqs``, 2 of them) equal up to the first
    position whose top-2 margin in the first run's logits is within
    ``MARGIN_FACTOR`` times the largest difference of the two runs'
    logits there (a tie, reported); ``logits[k][j - 1]`` chose token j.
    Returns ``(position checked up to, tie position or None)``."""
    (ka, a), (kb, b) = seqs.items()
    tie = None
    for j in range(p, p + n):
        la, lb = logits[ka][:, j - 1], logits[kb][:, j - 1]
        top2 = torch.topk(la, 2).values
        if bool((top2[:, 0] - top2[:, 1] <= MARGIN_FACTOR
                 * (la - lb).abs().amax(-1)).any()):
            tie = j
            break
    upto = p + n if tie is None else tie
    check(torch.equal(a[:, :upto], b[:, :upto]),
          f"{ka} and {kb} tokens differ before position {upto}")
    return upto, tie


def teacher_forced(model, cfg, x) -> torch.Tensor:
    """Each ``decode_step``'s logits over ``x``'s tokens, fed one at a time
    on a fresh cache of ``x``'s length, as ``greedy_decode`` feeds them:
    step j reads token j and its logits choose token j + 1; (B, L, V) in
    the model's dtype."""
    from repro_torch.models import transformer as tr

    b, n = x.shape
    cache = tr.init_model_cache(cfg, b, n, device=x.device)
    steps = []
    with torch.no_grad():
        for j in range(n):
            lg, cache = tr.decode_step(model, cfg, cache, x[:, j:j + 1], j)
            steps.append(lg[:, 0, :cfg.vocab_size])
    return torch.stack(steps, 1)


def mla_modes_decode(large, small, modes, seq, p) -> dict:
    """Phase 22 (b)'s decode over the written latent cache, MLA expanded
    and absorbed, teacher-forced on the expanded relay's tokens ``seq``
    with the relay's cache lengths (large ``p + MOE_SPLIT``, small the
    whole sequence).  The expanded steps choose the relay's own new tokens
    (bit for bit the relay's path); every step's logits of the two modes
    within ``MLA_MODES_RTOL`` for each model; each new token equal in the
    two modes wherever the expanded logits' top-2 margin exceeds
    ``MARGIN_FACTOR`` times the modes' largest difference there (else a
    tie, counted)."""
    x = seq.long()
    n_large = p + MOE_SPLIT
    forced, rel = {}, {"large": [], "small": []}
    for mode, (cl, cs) in modes.items():
        fl = teacher_forced(large, cl, x[:, :n_large])
        fs = teacher_forced(small, cs, x)
        forced[mode] = {"large": fl, "small": fs,
                        "relay": torch.cat([fl[:, :n_large - 1],
                                            fs[:, n_large - 1:]], 1)}
    for role in ("large", "small"):
        e, a = forced["expand"][role].float(), forced["absorb"][role].float()
        check(torch.isfinite(e).all() and torch.isfinite(a).all(),
              f"{MOE_DS}: teacher-forced {role} decode logits not finite")
        rel[role] = [norm_rel(a[:, j], e[:, j]) for j in range(e.shape[1])]
    worst = max(max(v) for v in rel.values())
    new = slice(p - 1, seq.shape[1] - 1)  # the logits choosing seq[:, p:]
    le = forced["expand"]["relay"][:, new]
    la = forced["absorb"]["relay"][:, new]
    check(torch.equal(le.argmax(-1).to(seq.dtype), seq[:, p:]),
          f"{MOE_DS}: teacher-forced expanded decode does not choose the "
          f"relay's tokens")
    le, la = le.float(), la.float()
    top2 = torch.topk(le, 2).values
    clear = (top2[..., 0] - top2[..., 1]
             > MARGIN_FACTOR * (le - la).abs().amax(-1))
    differ = le.argmax(-1) != la.argmax(-1)
    out = {"decode_logits_rel_max": worst,
           "decode_logits_rel_by_step": rel,
           "new_tokens_compared": int(clear.sum()),
           "new_tokens_tied": int((~clear).sum()),
           "new_tokens_differing_when_clear": int((differ & clear).sum()),
           "new_tokens_differing_at_ties": int((differ & ~clear).sum())}
    check(worst <= MLA_MODES_RTOL,
          f"{MOE_DS}: absorb vs expand decode logits {worst} "
          f"(MLA_MODES_RTOL {MLA_MODES_RTOL}): {json.dumps(out)}")
    check(out["new_tokens_differing_when_clear"] == 0,
          f"{MOE_DS}: absorb and expand choose different tokens where no "
          f"tie: {json.dumps(out)}")
    return out


def deepseek_full(dev, total) -> dict:
    """Phase 22 (b): ``deepseek-v3-671b`` at full width in bf16, cut in
    depth: the large model one MLA+MoE layer (256 experts, top-8, one
    shared) and one MLA+dense layer, the small one the MLA+MoE layer;
    random weights from seeded generators.  ``relay_decode`` of MOE_ROWS
    prompts at s = MOE_SPLIT of MOE_NEW new tokens and ``sequence_logprob``
    of its output, with MLA expanded and then absorbed (the same weights):
    finite logits; the two modes' free-running tokens equal up to a tie
    (with random weights the tie may come at the first new token, and then
    this compares the prompt alone), their scoring logits within
    ``MLA_MODES_RTOL``, and their decode over the latent cache
    teacher-forced on the same tokens (:func:`mla_modes_decode`); every
    MoE call against its fp32 oracle; the expanded relay again, equal bit
    for bit; flash attention never launched (MLA's attention is plain
    torch)."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import relay_decode, sequence_logprob
    from repro_torch.training.data import DataConfig, TokenPipeline

    base = configs.get_config(MOE_DS)
    dense = next(s for s in base.remainder if s.mlp == "dense")
    cfg_l = base.replace(n_layers=2, remainder=(dense,))
    cfg_s = base.replace(n_layers=1, remainder=())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    large = tr.init_model(cfg_l, torch.Generator(device=dev).manual_seed(80),
                          dev)
    small = tr.init_model(cfg_s, torch.Generator(device=dev).manual_seed(81),
                          dev)
    torch.cuda.synchronize()
    drawn = time.perf_counter() - t0
    sizes = {"large_b": cm.count_params(large) / 1e9,
             "small_b": cm.count_params(small) / 1e9}
    check(large.layers[0].moe.router.dtype == torch.float32
          and large.layers[0].moe.we_gate.dtype == torch.bfloat16,
          f"{MOE_DS}: router fp32 and experts bf16")
    prompt = TokenPipeline(DataConfig(
        vocab_size=base.vocab_size, seq_len=MOE_PROMPT,
        global_batch=MOE_ROWS)).batch(998)[0]
    absorb = dataclasses.replace(base.mla, absorb=True)
    modes = {"expand": (cfg_l, cfg_s),
             "absorb": (cfg_l.replace(mla=absorb), cfg_s.replace(mla=absorb))}
    build.reset_launches()
    runs, stats = {}, {}
    for mode, (cl, cs) in modes.items():
        with MoECalls(inputs=True) as calls:
            (seq, info), ms = host_timed(lambda: relay_decode(
                large, cl, small, cs, prompt, MOE_SPLIT, MOE_NEW))
            logp = sequence_logprob(large, cl, seq)
        runs[mode] = {"seq": seq, "info": info, "ms": ms, "logp": logp}
        stats[mode] = moe_oracle_checks(f"{MOE_DS} {mode}", calls, cl)
        del calls
    launches = {n: build.LAUNCHES[n] for n in ("flash_attention",
                                               "rglru_scan")}
    check(launches == {"flash_attention": 0, "rglru_scan": 0},
          f"{MOE_DS}: launches {launches} (MLA runs no kernel)")
    for n in launches:
        total[n] += launches[n]
    want_calls = (MOE_PROMPT + MOE_SPLIT) + (MOE_PROMPT + MOE_NEW) + 1
    check(all(s["calls"] == want_calls for s in stats.values()),
          f"{MOE_DS}: MoE calls {stats}, want {want_calls} a mode")
    p = MOE_PROMPT
    prompt_t = torch.from_numpy(prompt).to(dev)
    for mode, r in runs.items():
        seq = r["seq"]
        check(seq.shape == (MOE_ROWS, p + MOE_NEW)
              and torch.equal(seq[:, :p], prompt_t)
              and bool(((seq >= 0) & (seq < base.vocab_size)).all())
              and np.isfinite(r["logp"]),
              f"{MOE_DS} {mode}: sequence or logp {r['logp']}")
    # both modes' scoring logits on each run's own tokens, large then small
    logits = {}
    with torch.no_grad():
        for mode, (cl, cs) in modes.items():
            x = runs[mode]["seq"].long()
            ll = tr.model_fwd(large, cl, {"tokens": x})[..., :base.vocab_size]
            ls = tr.model_fwd(small, cs, {"tokens": x})[..., :base.vocab_size]
            check(torch.isfinite(ll).all() and torch.isfinite(ls).all(),
                  f"{MOE_DS} {mode}: logits not finite")
            logits[mode] = torch.cat([ll[:, :p + MOE_SPLIT - 1],
                                      ls[:, p + MOE_SPLIT - 1:]], 1).float()
        # the two modes on the expanded run's tokens
        x = runs["expand"]["seq"].long()
        absorbed = tr.model_fwd(large, modes["absorb"][0], {"tokens": x})
        expanded = tr.model_fwd(large, cfg_l, {"tokens": x})
    modes_rel = norm_rel(absorbed.float(), expanded.float())
    upto, tie = tokens_upto_tie({m: r["seq"] for m, r in runs.items()},
                                logits, p, MOE_NEW)
    check(modes_rel <= MLA_MODES_RTOL, f"{MOE_DS}: absorb vs expand logits "
          f"{modes_rel} (MLA_MODES_RTOL {MLA_MODES_RTOL})")
    forced = mla_modes_decode(large, small, modes, runs["expand"]["seq"], p)
    (again, _), warm_ms = host_timed(lambda: relay_decode(
        large, cfg_l, small, cfg_s, prompt, MOE_SPLIT, MOE_NEW))
    check(torch.equal(again, runs["expand"]["seq"]),
          f"{MOE_DS}: the relay's tokens differ run to run")
    same = float((runs["expand"]["seq"][:, p:]
                  == runs["absorb"]["seq"][:, p:]).float().mean())
    peak = torch.cuda.max_memory_allocated() / 1e9
    times = decode_times(f"{MOE_DS} large ({cfg_l.n_layers} layers)", large,
                         cfg_l, prompt, stats["expand"])
    out = {**sizes, "drawn_s": drawn, "peak_gb": peak,
           "expand_vs_absorb_logits_rel": modes_rel,
           "tokens_equal_upto": upto, "tie_at": tie,
           "new_tokens_equal_share": same,
           "teacher_forced": forced,
           "logp": {m: r["logp"] for m, r in runs.items()},
           "ms_per_relay_request": {m: r["ms"] / MOE_ROWS
                                    for m, r in runs.items()},
           "ms_per_relay_request_again": warm_ms / MOE_ROWS,
           "moe": stats, "launches": launches, "decode": times}
    print(f"{MOE_DS} (bf16, full width; large {cfg_l.n_layers} layers "
          f"{sizes['large_b']:.3f} B, small {cfg_s.n_layers} layer "
          f"{sizes['small_b']:.3f} B; relay s = {MOE_SPLIT} of {MOE_NEW}): "
          f"{json.dumps(out)}")
    del large, small, runs
    torch.cuda.empty_cache()
    return out


def llama4_full(dev, total) -> dict:
    """Phase 22 (c): ``llama4-maverick-400b-a17b`` at full width in bf16,
    2 layers (dense, then MoE: 128 experts, top-1, one shared), random
    weights from a seeded generator.  ``greedy_decode`` of MOE_ROWS
    prompts and MOE_NEW new tokens, then ``sequence_logprob``: flash
    attention launched exactly once per GQA layer per decode step on the
    decode kernel (a group of 5) and once per GQA layer in scoring on the
    scoring kernel; every MoE call against its fp32 oracle; the decode
    again, equal bit for bit; each flash call of the run replayed on its
    own operands within ``FLASH_TOL`` of the plain version."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import greedy_decode, sequence_logprob
    from repro_torch.training.data import DataConfig, TokenPipeline

    cfg = configs.get_config(MOE_L4).replace(n_layers=2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tr.init_model(cfg, torch.Generator(device=dev).manual_seed(82),
                          dev)
    torch.cuda.synchronize()
    drawn = time.perf_counter() - t0
    params_b = cm.count_params(model) / 1e9
    prompt = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=MOE_PROMPT,
        global_batch=MOE_ROWS)).batch(997)[0]
    steps, n_attn = MOE_PROMPT + MOE_NEW, flash_layers(cfg)

    build.reset_launches()
    flash_ops.reset_variant_launches()
    # the run's calls, kept
    with FlashReplay(MOE_L4, keep=n_attn * (steps + 1)) as flash, \
            MoECalls(inputs=True) as calls:
        seq, ms = host_timed(lambda: greedy_decode(model, cfg, prompt,
                                                   MOE_NEW))
        logp = sequence_logprob(model, cfg, seq)
    launches = {n: build.LAUNCHES[n] for n in ("flash_attention",
                                               "rglru_scan")}
    variants = dict(flash_ops.VARIANT_LAUNCHES)
    want = {"flash_attention": n_attn * (steps + 1), "rglru_scan": 0}
    check(launches == want, f"{MOE_L4}: launches {launches}, want {want}")
    check(variants == {"simt": 0, "decode": n_attn * steps,
                       "scoring": n_attn},
          f"{MOE_L4}: flash kernels {variants}")
    for n in launches:
        total[n] += launches[n]
    stats = moe_oracle_checks(MOE_L4, calls, cfg)
    check(stats["calls"] == steps + 1, f"{MOE_L4}: MoE calls {stats}")
    del calls
    check(seq.shape == (MOE_ROWS, steps) and np.isfinite(logp)
          and torch.equal(seq[:, :MOE_PROMPT], torch.from_numpy(prompt)
                          .to(dev)), f"{MOE_L4}: sequence or logp {logp}")
    with torch.no_grad():
        logits = tr.model_fwd(model, cfg, {"tokens": seq.long()})
    check(torch.isfinite(logits).all(), f"{MOE_L4}: logits not finite")
    del logits
    again, warm_ms = host_timed(lambda: greedy_decode(model, cfg, prompt,
                                                      MOE_NEW))
    check(torch.equal(again, seq), f"{MOE_L4}: tokens differ run to run")
    # the kept calls against the plain version (not counted launches)
    replay = flash.replay()
    check(replay.get("decode", [0])[0] == n_attn * steps
          and replay.get("scoring", [0])[0] == n_attn
          and set(replay) <= {"decode", "scoring"},
          f"{MOE_L4}: replayed flash calls {replay}")
    del flash
    peak = torch.cuda.max_memory_allocated() / 1e9
    times = decode_times(f"{MOE_L4} ({cfg.n_layers} layers)", model, cfg,
                         prompt, stats)
    out = {"params_b": params_b, "drawn_s": drawn, "peak_gb": peak,
           "logp": logp, "ms_per_request": ms / MOE_ROWS,
           "ms_per_request_again": warm_ms / MOE_ROWS, "moe": stats,
           "launches": launches, "flash_variants": variants,
           "flash_replay": {k: dict(zip(("calls", "max_abs_err",
                                         "share_of_tol"), v))
                            for k, v in replay.items()},
           "decode": times}
    print(f"{MOE_L4} (bf16, full width, {cfg.n_layers} layers, "
          f"{params_b:.3f} B): {json.dumps(out)}")
    del model
    torch.cuda.empty_cache()
    return out


def moe_mla_phase(dev) -> dict:
    """Phase 22: the MoE and MLA models, (a) card against CPU, (b)
    deepseek-v3-671b and (c) llama4-maverick-400b-a17b at full width, one
    after the other.  Returns the phase's kernel launches."""
    from repro_torch.device import keep_fp32

    t0 = time.perf_counter()
    keep_fp32(dev)  # (a) and the oracles: fp32 products
    total = dict.fromkeys(KERNELS, 0)
    moe_card_vs_cpu(dev)
    deepseek_full(dev, total)
    llama4_full(dev, total)
    print(f"MoE/MLA phase launches: {json.dumps(total)}; "
          f"{time.perf_counter() - t0:.1f} s; card: {card_line()}")
    return total


# ---- 23. encoders and cross-attention -----------------------------------


def context_of(cfg, rows: int, seed: int, dev, dtype=torch.float32,
               scale: float = 0.1):
    """Phase 23's seeded context on ``dev``: frames (rows, n_frames,
    d_enc) for a config with an encoder, patches (rows, ctx_len, ctx_dim)
    otherwise; N(0, scale²) (0.1 is the scale of the reference's
    ``tests/test_models.py``), drawn in fp32 and cast to ``dtype``."""
    shape = ((rows, cfg.encoder.n_frames, cfg.encoder.d_model)
             if cfg.encoder is not None else (rows, cfg.ctx_len, cfg.ctx_dim))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def ctx_variants(cfg, s: int) -> dict:
    """Flash launches by variant of one forward of ``s`` tokens over a
    context, by ``ops.plan``'s rule (bf16 at a tensor-core head dim: the
    S·G rows fit the decode tile, else scoring; otherwise the CUDA-core
    kernel): each self-attention and cross layer at ``s`` rows, each
    encoder layer at its frames."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as tr

    def variant(rows, c):
        if c.dtype != "bfloat16" or c.head_dim not in ops.TENSOR_CORE_HEAD_DIMS:
            return "simt"
        g = c.n_heads // c.n_kv_heads
        return "decode" if rows * g <= ops.DECODE_ROWS else "scoring"

    out = dict.fromkeys(ops.VARIANTS, 0)
    out[variant(s, cfg)] += mixer_layers(cfg, "attn") + sum(
        spec.cross_attn for spec in tr.layer_specs(cfg))
    if cfg.encoder is not None:
        ecfg = tr.encoder_cfg(cfg)
        out[variant(cfg.encoder.n_frames, ecfg)] += ecfg.n_layers
    return out


def ctx_serve(model, cfg, prompt, ctx, n_new: int) -> dict:
    """Phase 23's serving of one batch of requests: ``make_prefill_step``
    over the prompt and the context; ``make_serve_step`` fed the prompt
    token by token (the cache filled as ``greedy_decode`` fills it: a
    cached call of more than one token is not ported), then ``n_new``
    greedy tokens, the context passed at every step; then the prefill
    step teacher-forced over the whole sequence.  Returns the tokens, the
    prompt's prefill logits, each decode step's logits (B, P + n, V; step
    j reads token j) and the teacher-forced prefill's, on the vocabulary,
    the decode's cache, and the host ms of the prompt's prefill, of the
    decode loop and of the whole call."""
    from repro_torch.models import transformer as tr
    from repro_torch.training import train_step as ts

    prefill, serve = ts.make_prefill_step(cfg), ts.make_serve_step(cfg)
    (b, p), voc = prompt.shape, cfg.vocab_size
    first, prefill_ms = host_timed(
        lambda: prefill(model, {"tokens": prompt, "ctx": ctx})[..., :voc])

    def decode():
        cache = tr.init_model_cache(cfg, b, p + n_new, device=prompt.device)
        seq, steps = prompt, []
        for j in range(p + n_new):
            lg, cache = serve(model, cache, seq[:, j:j + 1], j, ctx=ctx)
            steps.append(lg[:, 0, :voc])
            if j >= p - 1 and seq.shape[1] < p + n_new:
                nxt = lg[:, -1, :voc].argmax(-1, keepdim=True)
                seq = torch.cat([seq, nxt.to(seq.dtype)], 1)
        return seq, torch.stack(steps, 1), cache

    (seq, steps, cache), decode_ms = host_timed(decode)
    forced, forced_ms = host_timed(
        lambda: prefill(model, {"tokens": seq, "ctx": ctx})[..., :voc])
    return {"seq": seq, "prompt_logits": first, "steps": steps,
            "forced": forced, "cache": cache, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms,
            "wall_ms": prefill_ms + decode_ms + forced_ms}


def ctx_step_bound(model, cfg, ctx) -> dict:
    """A decode step's bound over the context ``ctx``: the bytes it reads
    (every weight once — the embedding whole as a tied head, else its rows
    — and the context) over ``rl.HBM_BW``, plus the operations it
    spends on the context over ``rl.PEAK_FLOPS``: the encoder's layers
    over the frames (projections, MLP, attention), ``ctx_proj``, and each
    cross layer's K/V projections over T rows and its attention of one
    query row.  The decoder's own products are in the bytes."""
    from repro_torch.models import transformer as tr

    rows, t = ctx.shape[:2]
    nbytes = ctx.numel() * ctx.element_size()
    for name, p in model.named_parameters():
        n = p.numel()
        if name == "embed" and not cfg.tie_embeddings:
            n = rows * p.shape[1]
        nbytes += n * p.element_size()
    ops = 0
    if cfg.encoder is not None:
        e = tr.encoder_cfg(cfg)
        per = (2 * e.d_model * (e.n_heads + 2 * e.n_kv_heads) * e.head_dim
               + 2 * e.n_heads * e.head_dim * e.d_model
               + 3 * 2 * e.d_model * e.d_ff)
        ops += e.n_layers * (rows * t * per
                             + 4 * e.head_dim * rows * e.n_heads * t * t)
    if cfg.ctx_dim:
        ops += 2 * rows * t * cfg.ctx_dim * cfg.d_model
    n_cross = sum(spec.cross_attn for spec in tr.layer_specs(cfg))
    ops += n_cross * (2 * 2 * rows * t * cfg.d_model * cfg.n_kv_heads
                      * cfg.head_dim
                      + 4 * cfg.head_dim * rows * cfg.n_heads * t)
    t_bytes, t_ops = nbytes / rl.HBM_BW, ops / rl.PEAK_FLOPS
    return {"bound_ms": (t_bytes + t_ops) * 1e3,
            "bytes_ms": t_bytes * 1e3, "context_ops_ms": t_ops * 1e3,
            "weight_and_context_gb": nbytes / 1e9,
            "context_tflop": ops / 1e12}


def ctx_card_vs_cpu(dev, total) -> dict:
    """Phase 23 (a): ``make_reduced`` of both configurations in fp32, the
    same weights (drawn on the card, copied) and context on the card and
    the CPU: the prefill logits with the context, ``ENC_CHECK_STEPS``
    teacher-forced decode steps with it (each device's also against its
    prefill), within ``LM_RTOL``; then one train step with the context as
    phase 21 (a) holds it (:func:`lm_step_case`: the loss, every gradient
    — encoder, cross layers and ``ctx_proj`` included, none ``None`` —
    and the parameters after AdamW).  Flash launches once per call of
    :func:`flash_layers` with the context, exactly."""
    import copy

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tr
    from repro_torch.training import train_step as ts

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    out = {}
    for i, name in enumerate(ENC_NAMES):
        cfg = configs.make_reduced(configs.get_config(name))
        card = tr.init_model(cfg, torch.Generator(device=dev)
                             .manual_seed(90 + i), dev)
        ctx = context_of(cfg, MOE_CHECK_ROWS, 92 + i, dev)
        toks = lm_train_batch(cfg, MOE_CHECK_ROWS, MOE_CHECK_SEQ, i,
                              cpu)["tokens"].long()
        prefill, serve = ts.make_prefill_step(cfg), ts.make_serve_step(cfg)
        read = {}
        for key, model, where in (("card", card, dev),
                                  ("cpu", copy.deepcopy(card).to(cpu), cpu)):
            x, c = toks.to(where), ctx.to(where)
            build.reset_launches()
            logits = prefill(model, {"tokens": x, "ctx": c})
            cache = tr.init_model_cache(cfg, MOE_CHECK_ROWS, ENC_CHECK_STEPS,
                                        device=where)
            steps = []
            for j in range(ENC_CHECK_STEPS):
                lg, cache = serve(model, cache, x[:, j:j + 1], j, ctx=c)
                steps.append(lg[:, 0])
            read[key] = (logits.cpu(), torch.stack(steps, 1).cpu())
            if key == "card":
                got = build.LAUNCHES["flash_attention"]
                want = flash_layers(cfg, ctx=True) * (1 + ENC_CHECK_STEPS)
                check(got == want, f"{name}: flash launches {got}, want "
                      f"{want}")
                total["flash_attention"] += got
        res = {"prefill_rel": norm_rel(read["card"][0], read["cpu"][0]),
               "decode_rel": norm_rel(read["card"][1], read["cpu"][1]),
               "decode_vs_prefill_rel": max(
                   norm_rel(r[1], r[0][:, :ENC_CHECK_STEPS])
                   for r in read.values())}
        check(max(res.values()) <= LM_RTOL,
              f"{name} card vs CPU with a context: {res}")
        batches = {key: dict(lm_train_batch(cfg, LM_TRAIN_ROWS, LM_TRAIN_SEQ,
                                            i, where),
                             ctx=context_of(cfg, LM_TRAIN_ROWS, 94 + i,
                                            dev).to(where))
                   for key, where in (("card", dev), ("cpu", cpu))}
        res["train_step"] = lm_step_case(dev, f"{name} (reduced, with a "
                                         f"context)", cfg, card, batches,
                                         total)
        out[name] = res
        del card
    print(f"encoders and cross-attention card vs CPU (make_reduced, fp32, "
          f"{MOE_CHECK_ROWS} x {MOE_CHECK_SEQ} tokens, {ENC_CHECK_STEPS} "
          f"decode steps; {time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(out)}")
    return out


def ctx_full(dev, name: str, cfg, seed: int, total) -> dict:
    """Phase 23 (b) and (c): ``cfg`` at full width in bf16 (random weights
    and a context of scale ``ENC_CTX_SCALE[name]`` from seeded
    generators) serving ENC_ROWS requests of ENC_PROMPT prompt tokens and
    ENC_NEW new ones (:func:`ctx_serve`).
    The checked run: every flash call replayed on its operands
    (:class:`FlashReplay`), the launches by variant equal to
    :func:`ctx_variants`' count, each decode step's logits and the
    prompt's prefill logits within ``ENC_LOGITS_RTOL`` of the
    teacher-forced prefill's, which differs from the same prefill without
    the context by more than ``ENC_CTX_FACTOR`` times that tolerance (a
    decode step that lost its context would fail it).  The timed run,
    unchecked: tokens and logits
    equal to the checked run's bit for bit; ms per prefill and per decode
    step, the step's bound (:func:`ctx_step_bound`), the busy share of
    one decode step, the peak memory."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tr
    from repro_torch.training import train_step as ts
    from repro_torch.training.data import DataConfig, TokenPipeline

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tr.init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                          dev)
    ctx = context_of(cfg, ENC_ROWS, seed + 1, dev, torch.bfloat16,
                     ENC_CTX_SCALE[name])
    torch.cuda.synchronize()
    drawn = time.perf_counter() - t0
    params_b = cm.count_params(model) / 1e9
    prompt = torch.from_numpy(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=ENC_PROMPT,
        global_batch=ENC_ROWS)).batch(997)[0]).to(dev)
    n_steps = ENC_PROMPT + ENC_NEW

    build.reset_launches()
    flash_ops.reset_variant_launches()
    with FlashReplay(name) as replay:
        run = ctx_serve(model, cfg, prompt, ctx, ENC_NEW)
    launches = build.LAUNCHES["flash_attention"]
    variants = dict(flash_ops.VARIANT_LAUNCHES)
    want = dict.fromkeys(flash_ops.VARIANTS, 0)
    for s, times in ((ENC_PROMPT, 1), (1, n_steps), (n_steps, 1)):
        for k, n in ctx_variants(cfg, s).items():
            want[k] += n * times
    check(variants == want and launches == sum(want.values())
          and build.LAUNCHES["rglru_scan"] == 0,
          f"{name}: flash launches {launches} by variant {variants}, want "
          f"{want}")
    total["flash_attention"] += launches
    seq, steps, forced = run["seq"], run["steps"], run["forced"]
    check(seq.shape == (ENC_ROWS, n_steps)
          and torch.equal(seq[:, :ENC_PROMPT], prompt)
          and all(bool(torch.isfinite(x).all())
                  for x in (steps, forced, run["prompt_logits"])),
          f"{name}: tokens {tuple(seq.shape)} or logits not finite")
    step_rel = [norm_rel(steps[:, j], forced[:, j]) for j in range(n_steps)]
    prompt_rel = norm_rel(run["prompt_logits"], forced[:, :ENC_PROMPT])
    check(max(step_rel) <= ENC_LOGITS_RTOL
          and prompt_rel <= ENC_LOGITS_RTOL,
          f"{name}: decode steps against the teacher-forced prefill "
          f"{max(step_rel)}, the prompt's prefill {prompt_rel} "
          f"(ENC_LOGITS_RTOL {ENC_LOGITS_RTOL})")
    with torch.no_grad():
        bare = tr.model_fwd(model, cfg, {"tokens": seq})[..., :cfg.vocab_size]
    ctx_rel = norm_rel(bare, forced)
    check(ctx_rel > ENC_CTX_FACTOR * ENC_LOGITS_RTOL,
          f"{name}: the context moves the logits by {ctx_rel} only, under "
          f"{ENC_CTX_FACTOR} x ENC_LOGITS_RTOL")
    del bare
    timed = ctx_serve(model, cfg, prompt, ctx, ENC_NEW)
    check(torch.equal(timed["seq"], seq) and torch.equal(timed["steps"], steps)
          and torch.equal(timed["forced"], forced),
          f"{name}: the unchecked run differs from the checked one")
    prefill_ms = min(run["prefill_ms"], timed["prefill_ms"])
    step_ms = timed["decode_ms"] / n_steps
    # the last decode step again, on its own cache (it rewrites the same
    # K/V): its unprofiled wall time and its profiled device time
    serve, last = ts.make_serve_step(cfg), seq[:, -1:]

    def one_step():
        return serve(model, timed["cache"], last, n_steps - 1, ctx=ctx)
    _, one_ms = host_timed(one_step)
    share = busy(one_step, one_ms)
    bound = ctx_step_bound(model, cfg, ctx)
    out = {"params_b": params_b, "drawn_s": drawn,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "prefill_ms": prefill_ms, "decode_ms_per_step": step_ms,
           "step_bound": bound,
           "share_of_bound": bound["bound_ms"] / step_ms,
           "busy": share, "flash_launches": launches,
           "flash_variants": variants,
           "flash_replay": {k: dict(zip(("calls", "max_abs_err",
                                         "share_of_tol"), v))
                            for k, v in replay.read.items()},
           "decode_vs_forced_rel_max": max(step_rel),
           "decode_vs_forced_rel_by_step": step_rel,
           "prompt_prefill_vs_forced_rel": prompt_rel,
           "logits_rtol": ENC_LOGITS_RTOL,
           "forced_without_ctx_rel": ctx_rel,
           "case_s": time.perf_counter() - t0}
    print(f"{name} (bf16, full width, {cfg.n_layers} layers"
          f"{', encoder ' + str(cfg.encoder.n_layers) if cfg.encoder else ''}"
          f", {params_b:.3f} B; {ENC_ROWS} requests, {ENC_PROMPT} + "
          f"{ENC_NEW} tokens): {json.dumps(out)}; card: {card_line()}")
    del model, ctx, run, timed
    torch.cuda.empty_cache()
    return out


def ctx_phase(dev) -> dict:
    """Phase 23: encoders and cross-attention, (a) card against CPU on the
    reduced configurations, (b) ``whisper-medium`` at full width and
    depth, (c) ``llama-3.2-vision-11b`` at full width cut to
    ``VISION_LAYERS`` layers.  Returns the phase's kernel launches."""
    from repro_torch import configs
    from repro_torch.device import keep_fp32

    t0 = time.perf_counter()
    keep_fp32(dev)  # (a): fp32 products
    total = dict.fromkeys(KERNELS, 0)
    ctx_card_vs_cpu(dev, total)
    whisper, vision = ENC_NAMES
    ctx_full(dev, whisper, configs.get_config(whisper), 95, total)
    ctx_full(dev, vision, configs.get_config(vision).replace(
        n_layers=VISION_LAYERS), 97, total)
    print(f"encoder/cross-attention phase launches: {json.dumps(total)}; "
          f"{time.perf_counter() - t0:.1f} s; card: {card_line()}")
    return total


# ---------------------------------------------------------------------------
# phase 24: xLSTM (mLSTM and sLSTM, plain torch: no hand-written kernel)
# ---------------------------------------------------------------------------


class MixerRecorder:
    """While active, every mLSTM and sLSTM block's output, an fp32 copy on
    ``where``, in call order: ``seen``, a list of (kind, output)."""

    def __init__(self, where):
        self.where, self.seen = where, []

    def __enter__(self):
        from repro_torch.models import recurrent as rec

        self.rec = rec
        self.originals = {"mlstm": rec.mlstm_block_fwd,
                          "slstm": rec.slstm_block_fwd}
        for kind, fn in self.originals.items():
            setattr(rec, f"{kind}_block_fwd", self._recording(kind, fn))
        return self

    def _recording(self, kind, fn):
        def fwd(*args, **kw):
            y, c = fn(*args, **kw)
            self.seen.append((kind, y.to(self.where, torch.float32,
                                         copy=True)))
            return y, c
        return fwd

    def __exit__(self, *exc):
        for kind, fn in self.originals.items():
            setattr(self.rec, f"{kind}_block_fwd", fn)


def xlstm_caches_rel(card: dict, cpu: dict, worst: dict) -> None:
    """Every layer's state, card against CPU, into ``worst`` (the largest
    norm-wise error by mixer and state: ``mlstm_C``, ``slstm_n``, ...)."""
    for a, b in zip(card["layers"], cpu["layers"]):
        kind = "mlstm" if "C" in a else "slstm"
        for key, x in a.items():
            k = f"{kind}_{key}"
            worst[k] = max(worst.get(k, 0.0), norm_rel(x.cpu(), b[key]))


def xlstm_card_vs_cpu(dev) -> dict:
    """Phase 24 (a): ``make_reduced(xlstm-1.3b)`` in fp32, the same weights
    (drawn on the card, copied) on the card and the CPU: the full forward
    in the parallel form and in the chunkwise form (S = XLSTM_CHECK_SEQ,
    chunk XLSTM_CHECK_CHUNK), ``XLSTM_CHECK_STEPS`` teacher-forced decode
    steps (their logits as one tensor, and every layer's state after each
    step: C, n, m, conv; h, c, n, m), within ``XLSTM_RTOL``; the greedy
    tokens of ``greedy_decode`` equal up to a tie (the margin test of
    :func:`tokens_upto_tie` on each device's teacher-forced logits)."""
    import copy

    from repro_torch import configs
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import greedy_decode

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cfg = configs.make_reduced(configs.get_config(XLSTM_NAME))
    card = tr.init_model(cfg, torch.Generator(device=dev).manual_seed(110),
                         dev)
    host = copy.deepcopy(card).to(cpu)
    toks = lm_train_batch(cfg, 2, XLSTM_CHECK_SEQ, 110, cpu)["tokens"].long()
    res = {}
    with torch.no_grad():
        for form, chunk in (("parallel", None), ("chunkwise",
                                                 XLSTM_CHECK_CHUNK)):
            a = tr.model_fwd(card, cfg, {"tokens": toks.to(dev)},
                             mlstm_chunk=chunk)
            b = tr.model_fwd(host, cfg, {"tokens": toks}, mlstm_chunk=chunk)
            res[f"forward_{form}_rel"] = norm_rel(a.cpu(), b)
        n = XLSTM_CHECK_STEPS
        caches = {"card": tr.init_model_cache(cfg, 2, n, device=dev),
                  "cpu": tr.init_model_cache(cfg, 2, n, device=cpu)}
        steps, states = {"card": [], "cpu": []}, {}
        for t in range(n):
            for key, model in (("card", card), ("cpu", host)):
                where = dev if key == "card" else cpu
                lg, caches[key] = tr.decode_step(
                    model, cfg, caches[key], toks[:, t:t + 1].to(where), t)
                steps[key].append(lg[:, 0].cpu())
            xlstm_caches_rel(caches["card"], caches["cpu"], states)
    res["decode_rel"] = norm_rel(torch.stack(steps["card"], 1),
                                 torch.stack(steps["cpu"], 1))
    res["states"] = states
    check(max([v for k, v in res.items() if k.endswith("_rel")]
              + list(states.values())) <= XLSTM_RTOL,
          f"xLSTM card vs CPU (reduced, fp32): {res}")
    p, new = XLSTM_CHECK_PROMPT, XLSTM_CHECK_NEW
    prompt = toks[:, :p]
    seqs = {"card": greedy_decode(card, cfg, prompt.to(dev), new,
                                  device=dev).cpu(),
            "cpu": greedy_decode(host, cfg, prompt, new, device=cpu)}
    logits = {"card": teacher_forced(card, cfg, seqs["card"].to(dev)).cpu(),
              "cpu": teacher_forced(host, cfg, seqs["card"])}
    upto, tie = tokens_upto_tie(seqs, logits, p, new)
    res.update(tokens_equal_upto=upto, tie_at=tie,
               case_s=time.perf_counter() - t0)
    print(f"xLSTM card vs CPU (make_reduced, fp32, 2 x {XLSTM_CHECK_SEQ} "
          f"tokens, chunk {XLSTM_CHECK_CHUNK}, {n} decode steps, greedy "
          f"{p} + {new}): {json.dumps(res)}")
    return res


def xlstm_period_bf16(dev) -> dict:
    """Phase 24 (b): one period of ``xlstm-1.3b`` at full width (7 mLSTM
    layers and the sLSTM layer, bf16), the same weights on the card and
    the CPU.  The card greedy-decodes XLSTM_CHECK_NEW tokens after
    XLSTM_CHECK_PROMPT; both devices then feed that sequence one token at
    a time through ``decode_step`` and once through ``model_fwd``, in
    lockstep: every mLSTM and sLSTM block's output at every step and in
    the forward, every layer's state after every step and the logits,
    within ``XLSTM_BF16_RTOL`` norm-wise (the mixer outputs on their own:
    the tied logits of a random model are dominated by the token's own
    embedding).  On the card, the chunkwise form against the parallel one
    at S = XLSTM_FORMS_SEQ, chunk XLSTM_FORMS_CHUNK, in bf16 and on the
    same weights in fp32, within ``XLSTM_FORMS_TOL`` (the reference's own
    tolerance for the two forms)."""
    import copy

    from repro_torch import configs
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import greedy_decode

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cfg = configs.get_config(XLSTM_NAME).replace(n_layers=XLSTM_SMALL_LAYERS)
    card = tr.init_model(cfg, torch.Generator(device=dev).manual_seed(111),
                         dev)
    host = copy.deepcopy(card).to(cpu)
    p, new = XLSTM_CHECK_PROMPT, XLSTM_CHECK_NEW
    prompt = lm_train_batch(cfg, 2, p, 111, dev)["tokens"].long()
    seq = greedy_decode(card, cfg, prompt, new, device=dev)
    n = p + new
    recorder = MixerRecorder(cpu)

    def both(fn):
        """``fn(key, model, where)`` on the card and the CPU: the two
        results and the mixer outputs each recorded."""
        out = {}
        for key, model, where in (("card", card, dev), ("cpu", host, cpu)):
            recorder.seen.clear()
            res = fn(key, model, where)
            out[key] = (res, list(recorder.seen))
        return out

    worst, states = {}, {}

    def note(prefix, out):
        (a, sa), (b, sb) = out["card"], out["cpu"]
        check([k for k, _ in sa] == [k for k, _ in sb], "mixer calls")
        for (kind, x), (_, y) in zip(sa, sb):
            k = f"{prefix}_{kind}"
            worst[k] = max(worst.get(k, 0.0), norm_rel(x, y))
        k = f"{prefix}_logits"
        worst[k] = max(worst.get(k, 0.0),
                       norm_rel(a[..., :cfg.vocab_size].float().cpu(),
                                b[..., :cfg.vocab_size].float()))

    with recorder, torch.no_grad():
        caches = {"card": tr.init_model_cache(cfg, 2, n, device=dev),
                  "cpu": tr.init_model_cache(cfg, 2, n, device=cpu)}
        for t in range(n):
            def step(key, model, where, t=t):
                lg, caches[key] = tr.decode_step(
                    model, cfg, caches[key], seq[:, t:t + 1].to(where), t)
                return lg
            note("decode", both(step))
            xlstm_caches_rel(caches["card"], caches["cpu"], states)
        note("forward", both(lambda key, model, where: tr.model_fwd(
            model, cfg, {"tokens": seq.to(where)})))
    del host, caches
    res = {"decode_and_forward": worst, "states": states}
    # the two forms of the mLSTM on the card
    toks = lm_train_batch(cfg, 2, XLSTM_FORMS_SEQ, 112, dev)["tokens"].long()
    forms = {}
    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            model = card if dtype == "bfloat16" else card.float()
            c = cfg.replace(dtype=dtype)
            par = tr.model_fwd(model, c, {"tokens": toks})
            chunked = tr.model_fwd(model, c, {"tokens": toks},
                                   mlstm_chunk=XLSTM_FORMS_CHUNK)
            forms[dtype] = norm_rel(chunked[..., :cfg.vocab_size].float(),
                                    par[..., :cfg.vocab_size].float())
            del par, chunked
    res["chunkwise_vs_parallel_rel"] = forms
    res["case_s"] = time.perf_counter() - t0
    print(f"xLSTM one period (full width, {cfg.n_layers} layers, bf16, 2 x "
          f"{p} + {new} tokens) card vs CPU, largest norm-wise relative "
          f"error per step and layer; forms at S = {XLSTM_FORMS_SEQ}, chunk "
          f"{XLSTM_FORMS_CHUNK}: {json.dumps(res)}; card: {card_line()}")
    del card
    torch.cuda.empty_cache()
    check(max(list(worst.values()) + list(states.values())) <= XLSTM_BF16_RTOL,
          f"xLSTM one period bf16 card vs CPU over {XLSTM_BF16_RTOL}")
    check(max(forms.values()) <= XLSTM_FORMS_TOL,
          f"xLSTM chunkwise vs parallel over {XLSTM_FORMS_TOL}: {forms}")
    return res


def xlstm_step_bound(model, cache: dict) -> dict:
    """A decode step's least time: every weight read once (the tied
    embedding whole, as the head) and the state read and written once,
    over ``rl.HBM_BW``."""
    w = sum(p.numel() * p.element_size() for p in model.parameters())
    s = sum(x.numel() * x.element_size() for c in cache["layers"]
            for x in c.values())
    return {"bound_ms": (w + 2 * s) / rl.HBM_BW * 1e3,
            "weight_gb": w / 1e9, "state_gb": s / 1e9}


def xlstm_served(dev) -> dict:
    """Phase 24 (c): ``xlstm-1.3b`` at full width and depth (48 layers,
    bf16, seeded random weights) serving XLSTM_ROWS prompts of
    XLSTM_PROMPT tokens: ``greedy_decode`` of XLSTM_NEW tokens, each
    decode step's logits (teacher-forced on its tokens, which they
    choose again bit for bit) against the full forward's within
    ``XLSTM_LOGITS_RTOL``, and each block's output at each step against
    the forward's at that position (the tied logits of a random model
    follow the token's own embedding; a block's output follows its
    state): the first period's blocks within ``XLSTM_BLOCK_RTOL``, which
    the same steps on a fresh cache each (the state dropped) must miss by
    more than ``XLSTM_DROP_FACTOR`` times in every one of those layers;
    the deeper blocks read; ``relay_decode`` at s = XLSTM_SPLIT with the
    one-period model as the small one (its large segment equal to the
    large-only run's prefix, the handoff's bytes by the reference's
    formula) and the small model alone; ``sequence_logprob`` of each arm
    under the large model; ms per large decode step (the greedy run's)
    against :func:`xlstm_step_bound`, a step's device time and busy share
    (:func:`child_xlstm_step_profile`), the peak memory."""
    from repro_torch import configs
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import (greedy_decode, relay_decode,
                                              sequence_logprob)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = configs.get_config(XLSTM_NAME)
    cfg_s = cfg.replace(n_layers=XLSTM_SMALL_LAYERS)
    large = tr.init_model(cfg, torch.Generator(device=dev).manual_seed(113),
                          dev)
    small = tr.init_model(cfg_s, torch.Generator(device=dev).manual_seed(114),
                          dev)
    torch.cuda.synchronize()
    drawn = time.perf_counter() - t0
    params_b = cm.count_params(large) / 1e9
    prompt = lm_train_batch(cfg, XLSTM_ROWS, XLSTM_PROMPT, 113,
                            dev)["tokens"].long()
    p, new, s = XLSTM_PROMPT, XLSTM_NEW, XLSTM_SPLIT
    greedy_decode(large, cfg, prompt, 2, device=dev)  # warm
    seq, wall = host_timed(lambda: greedy_decode(large, cfg, prompt, new,
                                                 device=dev))
    check(seq.shape == (XLSTM_ROWS, p + new)
          and torch.equal(seq[:, :p], prompt), "xLSTM greedy tokens")
    with MixerRecorder(dev) as steps:
        forced = teacher_forced(large, cfg, seq)
    with MixerRecorder(dev) as whole, torch.no_grad():
        full = tr.model_fwd(large, cfg, {"tokens": seq})[..., :cfg.vocab_size]
    check(torch.equal(forced[:, p - 1:-1].argmax(-1), seq[:, p:]),
          "xLSTM teacher-forced decode chose other tokens than greedy")
    check(bool(torch.isfinite(forced).all() and torch.isfinite(full).all()),
          "xLSTM logits not finite")
    step_rel = [norm_rel(forced[:, j], full[:, j]) for j in range(p + new)]
    # each block's output at each step against the forward's at that
    # position (step j's calls are steps.seen[j * L: (j + 1) * L])
    n_layers = len(whole.seen)
    check(len(steps.seen) == n_layers * (p + new), "xLSTM mixer calls")
    block_rel = [max(norm_rel(steps.seen[j * n_layers + i][1][:, 0],
                              whole.seen[i][1][:, j])
                     for j in range(p + new)) for i in range(n_layers)]
    del steps
    # the control: each step on a fresh cache (the state dropped)
    with MixerRecorder(dev) as dropped, torch.no_grad():
        for j in range(p + new):
            tr.decode_step(large, cfg, tr.init_model_cache(
                cfg, XLSTM_ROWS, 1, device=dev), seq[:, j:j + 1], j)
    dropped_rel = [max(norm_rel(dropped.seen[j * n_layers + i][1][:, 0],
                                whole.seen[i][1][:, j])
                       for j in range(p + new)) for i in range(n_layers)]
    first = XLSTM_SMALL_LAYERS  # the first period's blocks are held
    del forced, full, dropped, whole
    relay, info = relay_decode(large, cfg, small, cfg_s, prompt, s, new,
                               device=dev)
    check(torch.equal(relay[:, :p + s], seq[:, :p + s])
          and info["transfer_bytes"] == XLSTM_ROWS * (p + s) * 4,
          f"xLSTM relay: large segment or handoff bytes {info}")
    alone = greedy_decode(small, cfg_s, prompt, new, device=dev)
    logp = {arm: sequence_logprob(large, cfg, x, device=dev)
            for arm, x in (("large", seq), (f"relay_s{s}", relay),
                           ("small", alone))}
    check(all(np.isfinite(v) for v in logp.values()), f"xLSTM logp {logp}")
    profile = child_xlstm_step_profile()
    bound = xlstm_step_bound(large, tr.init_model_cache(
        cfg, XLSTM_ROWS, 1, device="meta"))
    step_ms = wall / (p + new)
    out = {"params_b": params_b, "drawn_s": drawn,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "ms_per_step": step_ms, "step_bound": bound,
           "share_of_bound": bound["bound_ms"] / step_ms,
           "share_of_bound_device": bound["bound_ms"] / profile["device_ms"],
           "step_profile": profile,
           "decode_vs_forward_rel_max": max(step_rel),
           "decode_vs_forward_rel_by_step": step_rel,
           "block_decode_vs_forward_rel_by_layer": block_rel,
           "logits_rtol": XLSTM_LOGITS_RTOL,
           "block_rtol": XLSTM_BLOCK_RTOL,
           "block_state_dropped_vs_forward_rel_by_layer": dropped_rel,
           "logprob": logp,
           "relay_info": info, "tokens_large": seq[0].tolist(),
           "tokens_relay": relay[0].tolist(),
           "case_s": time.perf_counter() - t0}
    print(f"xlstm-1.3b (bf16, full width and depth, {params_b:.3f} B; "
          f"{XLSTM_ROWS} prompts of {p} + {new} tokens, relay at s = {s} "
          f"to {cfg_s.n_layers} layers): {json.dumps(out)}; card: "
          f"{card_line()}")
    check(max(step_rel) <= XLSTM_LOGITS_RTOL
          and max(block_rel[:first]) <= XLSTM_BLOCK_RTOL,
          f"xLSTM decode against the forward: logits {max(step_rel)} over "
          f"{XLSTM_LOGITS_RTOL} or the first period's blocks "
          f"{max(block_rel[:first])} over {XLSTM_BLOCK_RTOL}")
    check(min(dropped_rel[:first]) > XLSTM_DROP_FACTOR * XLSTM_BLOCK_RTOL,
          f"xLSTM: dropping the state moves a block of the first period by "
          f"{min(dropped_rel[:first])} only, under {XLSTM_DROP_FACTOR} x "
          f"XLSTM_BLOCK_RTOL")
    del large, small
    torch.cuda.empty_cache()
    return out


def xlstm_step_profile() -> dict:
    """One decode step of phase 24 (c)'s ``xlstm-1.3b`` (its seeded
    weights, bf16, XLSTM_ROWS rows, on a fresh cache) on the card: its
    host time over XLSTM_TIMED_STEPS steps, and its device time, kernels
    and busy share from :func:`profiled` with the exact-count check (a
    two-step session holds twice a one-step session's kernel records;
    the pair is measured again, up to three times, when it does not, and
    the process's first session is left out: in a fresh process a
    two-step session read 8,010 kernels, not twice what the process's
    first one-step session read).  Run in a child process
    (:func:`child_xlstm_step_profile`): late in this script CUPTI
    recorded 7,974 of a two-step session's 8,010 kernels in every attempt
    (H100 80GB HBM3, 700 W), while a fresh process records them all."""
    from repro_torch import configs
    from repro_torch.models import transformer as tr

    dev = torch.device("cuda")
    cfg = configs.get_config(XLSTM_NAME)
    model = tr.init_model(cfg, torch.Generator(device=dev).manual_seed(113),
                          dev)
    cache = tr.init_model_cache(cfg, XLSTM_ROWS, 1, device=dev)
    tok = lm_train_batch(cfg, XLSTM_ROWS, 1, 113, dev)["tokens"].long()

    def steps(k):
        def run():
            with torch.no_grad():
                for _ in range(k):
                    tr.decode_step(model, cfg, cache, tok, 0)
        return run
    steps(2)()
    _, wall = host_timed(steps(XLSTM_TIMED_STEPS))
    step_ms = wall / XLSTM_TIMED_STEPS
    profiled(steps(1))  # a process's first session: its count may differ
    for attempt in range(3):
        _, one = profiled(steps(1))
        records = sum(e.count for e in one if e.self_device_time_total > 0)
        try:
            us, averages = profiled(steps(2), calls=2, records=records)
            break
        except RuntimeError:
            print(f"xLSTM step profile: one step recorded {records} kernels "
                  f"(pair {attempt + 1} of 3)", file=sys.stderr)
            if attempt == 2:
                raise
    top = sorted(averages, key=lambda e: -e.self_device_time_total)[:8]
    return {"step_ms": step_ms, "device_ms": us / 2e3,
            "busy_share": us / 2e3 / step_ms, "kernels_per_step": records,
            "top_kernels_ms_per_step": {
                e.key[:80]: e.self_device_time_total / 2e3 for e in top}}


def child_xlstm_step_profile() -> dict:
    """:func:`xlstm_step_profile` in a fresh Python process on the card."""
    code = ("import json, sys; sys.path.insert(0, 'src'); import chip_smoke; "
            "print(json.dumps(chip_smoke.xlstm_step_profile()))")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0, f"xLSTM step profile: {run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def xlstm_train_step_checks(dev, total) -> dict:
    """Phase 24 (d), first part: one training step of
    ``make_reduced(xlstm-1.3b)`` in fp32, card against CPU from the same
    weights and batch, as :func:`lm_step_case` holds phase 21 (a)'s (the
    parameters after the step by its rule), once with the mLSTM in its
    parallel form and once chunkwise (``XLSTM_CHECK_CHUNK``); the loss and
    ``grad_norm`` within ``XLSTM_RTOL``; every gradient non-``None`` and
    finite on both devices, among them the mLSTM's, the sLSTM's
    (``w_gates``, ``r_gates``, ``gn_scale``) and the embedding's."""
    from repro_torch import configs
    from repro_torch.models import transformer as tr

    cfg = configs.make_reduced(configs.get_config(XLSTM_NAME))
    cpu = torch.device("cpu")
    out = {}
    for form, chunk in (("parallel", None), ("chunkwise", XLSTM_CHECK_CHUNK)):
        card = tr.init_model(cfg, torch.Generator(device=dev)
                             .manual_seed(115), dev)
        names = {n for n, _ in card.named_parameters()}
        named = {"embed", "layers.0.mlstm.wq_h", "layers.0.mlstm.w_if",
                 "layers.7.slstm.w_gates", "layers.7.slstm.r_gates",
                 "layers.7.slstm.gn_scale"}
        check(named <= names, f"xLSTM weights {sorted(named - names)}")
        batches = {key: lm_train_batch(cfg, LM_TRAIN_ROWS, LM_TRAIN_SEQ, 115,
                                       where)
                   for key, where in (("card", dev), ("cpu", cpu))}
        out[form] = lm_step_case(dev, f"{XLSTM_NAME} {form}", cfg, card,
                                 batches, total, mlstm_chunk=chunk,
                                 loss_rtol=XLSTM_RTOL)
        del card
    return out


def xlstm_full_training(dev) -> dict:
    """Phase 24 (d), second part: ``xlstm-1.3b`` at full width and depth
    (48 layers, bf16) trained on the card, ``remat`` on, fp32 moments (the
    default ``state_dtype``) at phase 21 (b)'s rate (``LM_TRAIN_OPT``: the
    default warm-up of 100 steps gives rates of 3e-6 to 3e-5 over 10 steps,
    which bf16 weights mostly round away), ``XLSTM_TRAIN_STEPS`` steps on one batch
    of ``XLSTM_TRAIN_ROWS`` x ``XLSTM_TRAIN_SEQ`` tokens.  Before the first
    step, every gradient of the loss non-``None`` and finite, and the loss
    against the chunkwise form's (``XLSTM_CHECK_CHUNK``) within
    ``XLSTM_FORMS_TOL``.  The first step runs under
    ``analysis.roofline.CostCounter``: its flops and bytes, ``analyze``'s
    terms and ``model_flops_estimate`` (6·N_active·D); the others are
    timed (host clock, synchronized).  The loss is finite and falls; ms
    per step (median of the timed steps) and the step's bound; the peak
    memory; after the steps, one AdamW update counted alone (its share of
    the step's bytes)."""
    from repro_torch import configs
    from repro_torch.analysis import params
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tr
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    from repro_torch.training.checkpoint import lm_leaf_ranks

    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = configs.get_config(XLSTM_NAME)
    model = tr.init_model(cfg, torch.Generator(device=dev).manual_seed(116),
                          dev)
    c = opt.OptConfig(**dict(LM_TRAIN_OPT, total_steps=XLSTM_TRAIN_STEPS))
    batch = lm_train_batch(cfg, XLSTM_TRAIN_ROWS, XLSTM_TRAIN_SEQ, 116, dev)
    # the first step's gradients, and its loss in both mLSTM forms
    model.requires_grad_(True)
    loss, _ = ts.make_loss_fn(cfg, remat=True)(model, batch)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    missing = [n for n, g in zip(names, grads) if g is None]
    nonfinite = [n for n, g in zip(names, grads)
                 if g is not None and not torch.isfinite(g).all()]
    del grads
    with torch.no_grad():
        chunked, _ = ts.make_loss_fn(cfg, remat=True,
                                     mlstm_chunk=XLSTM_CHECK_CHUNK)(model,
                                                                    batch)
    loss = float(loss.detach())
    forms_rel = abs(float(chunked) - loss) / abs(loss)
    state = opt.adamw_init(dict(model.named_parameters()), c)
    step = ts.make_train_step(cfg, c, remat=True)
    losses, times = [], []
    with rl.CostCounter() as counter:
        (_, state, m), ms = host_timed(lambda: step(model, state, batch))
        losses.append(float(m["loss"]))
    counted_ms = ms
    for _ in range(XLSTM_TRAIN_STEPS - 1):
        (_, state, m), ms = host_timed(lambda: step(model, state, batch))
        losses.append(float(m["loss"]))
        times.append(ms)
    shape = SimpleNamespace(kind="train", global_batch=XLSTM_TRAIN_ROWS,
                            seq_len=XLSTM_TRAIN_SEQ)
    roof = rl.analyze(counter.summary(), 1,
                      model_flops=rl.model_flops_estimate(cfg, shape))
    step_ms = float(np.median(times))
    bound_ms = max(roof["t_compute_s"], roof["t_memory_s"]) * 1e3
    # the update alone, on gradients of the step's dtype and shapes
    named = dict(model.named_parameters())
    zeros = {n: torch.zeros_like(p) for n, p in named.items()}
    with torch.no_grad(), rl.CostCounter() as update:
        opt.adamw_update(named, zeros, state, c,
                         ranks=lm_leaf_ranks(named, cfg))
    del named, zeros
    top = sorted(counter.by_op.items(), key=lambda kv: -kv[1][2])[:6]
    out = {"params_b": cm.count_params(model) / 1e9,
           "active_params_b": params.active_params(cfg) / 1e9,
           "held_before_gb": held_gb, "losses": losses,
           "first_loss_forms_rel": forms_rel,
           "ms_per_step": step_ms, "ms_by_step": times,
           "counted_step_ms": counted_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "flops": counter.flops, "flops_fp32": counter.flops_fp32,
           "bytes": counter.bytes, "t_compute_ms": roof["t_compute_s"] * 1e3,
           "t_memory_ms": roof["t_memory_s"] * 1e3,
           "dominant": roof["dominant"],
           "model_flops_estimate": roof["model_flops_total"],
           "useful_flops_ratio": roof["useful_flops_ratio"],
           "roofline_fraction": roof["roofline_fraction"],
           "bound_ms": bound_ms, "share_of_bound": bound_ms / step_ms,
           "adamw_update_bytes": update.bytes,
           "adamw_share_of_bytes": update.bytes / counter.bytes,
           "top_ops_by_bytes": {op: row for op, row in top},
           "case_s": time.perf_counter() - t0}
    print(f"xlstm-1.3b trained on the card (bf16, full width and depth, "
          f"remat, fp32 moments, {XLSTM_TRAIN_STEPS} steps of "
          f"{XLSTM_TRAIN_ROWS} x {XLSTM_TRAIN_SEQ} tokens): "
          f"{json.dumps(out)}; card: {card_line()}")
    check(missing == [] and nonfinite == [],
          f"xLSTM full: gradients None {missing} or not finite {nonfinite}")
    check(forms_rel <= XLSTM_FORMS_TOL,
          f"xLSTM full: first loss, chunkwise vs parallel {forms_rel}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"xLSTM full: losses {losses}")
    del model, state, step
    torch.cuda.empty_cache()
    return out


def xlstm_training(dev, total) -> dict:
    """Phase 24 (d): xLSTM trained on the card: the fp32 step card against
    CPU (:func:`xlstm_train_step_checks`), the 48-layer bf16 model
    (:func:`xlstm_full_training`), ``launch.train --arch xlstm-1.3b``
    resumed (:func:`lm_launch_resume`).  The first and the last count
    their card runs' launches themselves (:func:`lm_launches`: none), the
    48-layer run by :func:`count_launches`; each adds to ``total``."""
    from repro_torch.device import keep_fp32

    keep_fp32(dev)  # the fp32 step: fp32 products, as launch/train.py
    t0 = time.perf_counter()
    out = {"card_vs_cpu": xlstm_train_step_checks(dev, total),
           "full": count_launches(
               "xLSTM 48-layer training", lambda: xlstm_full_training(dev),
               dict.fromkeys(KERNELS, 0), total)[0],
           "launch": lm_launch_resume(dev, total, XLSTM_NAME)}
    out["case_s"] = time.perf_counter() - t0
    return out


def xlstm_phase(dev) -> dict:
    """Phase 24: xLSTM, (a) card against CPU on the reduced configuration
    in fp32, (b) one period at full width in bf16 card against CPU and the
    two mLSTM forms, (c) ``xlstm-1.3b`` at full width and depth served and
    relayed, (d) trained (:func:`xlstm_training`).  No hand-written kernel
    runs on this path: every launch count reads 0 over the phase
    (:func:`count_launches`)."""
    from repro_torch.device import keep_fp32

    t0 = time.perf_counter()
    keep_fp32(dev)  # (a): fp32 products
    total = dict.fromkeys(KERNELS, 0)

    def run():
        return {"card_vs_cpu": xlstm_card_vs_cpu(dev),
                "period_bf16": xlstm_period_bf16(dev),
                "served": xlstm_served(dev)}
    out, _ = count_launches("xLSTM phase (a)-(c)", run,
                            dict.fromkeys(KERNELS, 0), total)
    out["trained"] = xlstm_training(dev, total)
    check(not any(total.values()), f"xLSTM phase launches {total}")
    print(f"xLSTM phase launches: {json.dumps(total)}; "
          f"{time.perf_counter() - t0:.1f} s; card: {card_line()}")
    return out


# ---- 25. the distributed layer --------------------------------------------

# ranks: child processes sharing the one card in a gloo group (NCCL
# refuses two ranks on one device); every collective on CUDA tensors goes
# through repro_torch.distributed.compat, DTensor's own all-reduce aside
DIST_DIR = REPO / "build" / "dist"
DIST_TIMEOUT = 300.0  # seconds one spawn of ranks may take
DIST_MOE_TOKENS, DIST_MOE_SEED = 64, 2500
# the expert-parallel output against the unsharded one, norm-wise relative:
# the two sum a token's experts and the shared expert in bf16 in different
# orders (per rank, then across ranks); read 4.36e-3 (max abs 0.0156) on
# an H100 80GB HBM3 at 700 W, twice
DIST_MOE_RTOL = 1e-2
DIST_PSUM_SHAPE, DIST_PSUM_SEED = (64, 1024), 2600
DIST_PIPE_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}  # reference's
DIST_PIPE_STAGES, DIST_PIPE_MICRO = (2, 4), 6  # the reference test's sizes
DIST_QWEN_LAYERS, DIST_PROMPT, DIST_ROWS, DIST_STEPS = 2, 16, 4, 8
DIST_QWEN_SEED = 2700
# sharded qwen3-4b logits against the unsharded steps' on the card, bf16,
# norm-wise relative per step (the head-sharded sums add in another order);
# read 5.82e-3 (1 x 4) and 5.66e-3 (1 x 3, padded) on an H100 80GB HBM3 at
# 700 W, twice
DIST_LOGITS_RTOL = 1.5e-2
DIST_CKPT_SHAPE, DIST_CKPT_SEED = (64, 256), 2800


def dist_spawn(fn, world: int, *args) -> list:
    """``fn(rank, world, port, *args)`` in ``world`` child processes
    (spawned, each on the one card), joined within ``DIST_TIMEOUT``; the
    list of what each rank saved under ``DIST_DIR``."""
    import socket

    import torch.multiprocessing as mp

    DIST_DIR.mkdir(parents=True, exist_ok=True)
    for old in DIST_DIR.glob(f"{fn.__name__}.*.pt"):
        old.unlink()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(fn, args=(world, port) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline,
                  f"{fn.__name__}: ranks running after {DIST_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(DIST_DIR / f"{fn.__name__}.{r}.pt", weights_only=False)
            for r in range(world)]


def dist_init(rank: int, world: int, port: int):
    """A rank's gloo group and its device (the one card)."""
    import torch.distributed as dist

    from repro_torch.device import keep_fp32

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    keep_fp32(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    return dev


def dist_done(name: str, rank: int, out: dict) -> None:
    import torch.distributed as dist

    torch.save(out, DIST_DIR / f"{name}.{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def dist_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cuda", shape, mesh_dim_names=names)


def dist_moe_cfg():
    """One ``deepseek-v3-671b`` MoE layer: d 7,168, 256 routed experts
    (top-8) of d_ff 2,048, one shared expert; bf16."""
    from repro_torch import configs

    return configs.get_config("deepseek-v3-671b")


def dist_moe_weights(cfg, dev, lo: int, hi: int) -> SimpleNamespace:
    """The MoE's weights with experts ``lo .. hi`` only: each expert drawn
    from its own seed (so a rank makes its block and the unsharded run
    the same tensors), the router and the shared expert from theirs."""
    from repro_torch.models import common as cm

    d, f, bf = cfg.d_model, cfg.moe.d_ff_expert, torch.bfloat16
    stacks = [torch.empty((hi - lo, d, f), dtype=bf, device=dev),
              torch.empty((hi - lo, d, f), dtype=bf, device=dev),
              torch.empty((hi - lo, f, d), dtype=bf, device=dev)]
    for e in range(lo, hi):
        g = torch.Generator(device=dev).manual_seed(DIST_MOE_SEED + 1 + e)
        for w, (fan_in, out) in zip(stacks, ((d, f), (d, f), (f, d))):
            w[e - lo] = cm.dense_init(g, fan_in, (out,), bf, dev)
    g = torch.Generator(device=dev).manual_seed(DIST_MOE_SEED)
    router = cm.dense_init(g, d, (cfg.moe.n_experts,), torch.float32, dev)
    fs = f * cfg.moe.n_shared
    shared = SimpleNamespace(w_gate=cm.dense_init(g, d, (fs,), bf, dev),
                             w_up=cm.dense_init(g, d, (fs,), bf, dev),
                             w_down=cm.dense_init(g, fs, (d,), bf, dev))
    x = torch.randn((1, DIST_MOE_TOKENS, d), generator=g, device=dev).to(bf)
    return SimpleNamespace(router=router, we_gate=stacks[0], we_up=stacks[1],
                           we_down=stacks[2], shared=shared), x


def dist_moe_call(p, cfg, x, mesh=None) -> tuple:
    """``moe_fwd`` once, recording its routing; then ms a call over 3."""
    from repro_torch.models import mlp

    routes = []
    route = mlp._route

    def recording(*a):
        out = route(*a)
        routes.append(out[1])
        return out

    mlp._route = recording
    try:
        out, aux = mlp.moe_fwd(p, cfg, x, mesh=mesh)
    finally:
        mlp._route = route
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        mlp.moe_fwd(p, cfg, x, mesh=mesh)
    torch.cuda.synchronize()
    return out, aux, routes[0], (time.perf_counter() - t0) / 3 * 1e3


def dist_ranks_main(rank: int, world: int, port: int, parts: tuple) -> None:
    """One rank of the world-``world`` spawn: the parts named in
    ``parts`` (moe, psum, pipe, qwen), each with its launches counted
    from 0 and its host copies."""
    from repro_torch.distributed import compat
    from repro_torch.kernels import build

    dev = dist_init(rank, world, port)
    out = {}
    for part in parts:
        build.reset_launches()
        compat.reset_host_copies()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = DIST_PARTS[part](rank, world, dev)
        torch.cuda.synchronize()
        res.update(seconds=time.perf_counter() - t0,
                   launches=dict(build.LAUNCHES),
                   host_copies=dict(compat.HOST_COPIES),
                   peak_gb=torch.cuda.max_memory_allocated() / 2**30)
        out[part] = res
    dist_done("dist_ranks_main", rank, out)


def dist_rank_moe(rank, world, dev) -> dict:
    """(a) on a 1 x ``world`` mesh: this rank's block of 256 / world
    experts as a DTensor, the tokens replicated over ``model`` (data 1)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    cfg = dist_moe_cfg()
    mesh = dist_mesh((1, world), ("data", "model"))
    e_blk = cfg.moe.n_experts // world
    p, x = dist_moe_weights(cfg, dev, rank * e_blk, (rank + 1) * e_blk)
    for name in ("we_gate", "we_up", "we_down"):
        setattr(p, name, DTensor.from_local(getattr(p, name), mesh,
                                            [Replicate(), Shard(0)],
                                            run_check=False))
    out, aux, top_idx, ms = dist_moe_call(p, cfg, x, mesh)
    local = out.to_local()
    return {"out": local.cpu() if rank == 0 else None,
            "out_dtype": str(local.dtype), "aux": float(aux.to_local()),
            "top_idx": top_idx.cpu(), "ms": ms}


def dist_psum_inputs(rank: int, dev) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(DIST_PSUM_SEED + rank)
    scale = 0.1 + rank * 0.4
    return (torch.randn(DIST_PSUM_SHAPE, generator=g) * scale).to(dev)


def dist_psum_base(dev) -> torch.Tensor:
    """The reference parity test's leaf: (4, 64), rows apart by 0.01."""
    return (torch.ones((4, 64)) * 0.1 + torch.arange(4)[:, None] * 0.01
            + torch.linspace(-3, 3, 64)[None] * 0.05).to(dev)


def dist_rank_psum(rank, world, dev) -> dict:
    """(b) ``compressed_psum`` over ``pod`` = ``world`` ranks: the
    reference's parity checks (fp32 and bf16 leaves, both quantizers, 4
    syncs), then this rank's own input (rowwise).  Each check's bound,
    one round trip's error, is taken first, and the launches count from
    0 after it: they are those of ``compressed_psum`` alone."""
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.kernels import build
    from repro_torch.quantization import QUANTIZERS

    mesh = dist_mesh((world,), ("pod",))
    dtypes = (torch.float32, torch.bfloat16)
    steps = {(dtype, qname): float(qz.error(
        dist_psum_base(dev).to(dtype).float()).abs().max())
        for dtype in dtypes for qname, qz in QUANTIZERS.items()}
    build.reset_launches()
    checks = {}
    for dtype in dtypes:
        x = dist_psum_base(dev).to(dtype)
        exact = x.float()
        for qname in sorted(QUANTIZERS):
            step = steps[dtype, qname]
            reduced, err = compressed_psum({"g": x}, mesh, axis="pod",
                                           quantizer=qname)
            e1 = float((reduced["g"] - exact).abs().max())
            acc = reduced["g"]
            for _ in range(3):
                reduced, err = compressed_psum({"g": x}, mesh, axis="pod",
                                               error_state=err,
                                               quantizer=qname)
                acc = acc + reduced["g"]
            checks[f"{dtype}/{qname}"] = (step, e1, float(
                (acc / 4 - exact).abs().max()))
    own = dist_psum_inputs(rank, dev)
    reduced, err = compressed_psum({"g": own}, mesh, axis="pod")
    return {"checks": checks, "new_err": err["g"].cpu(),
            "reduced": reduced["g"].cpu()}


def dist_rank_pipe(rank, world, dev) -> dict:
    """(c) ``pipeline_apply`` over 2 and 4 stages (a ``stage x data``
    mesh), 3 layers a stage of d 16, 6 microbatches of 8; rank 0 holds it
    against the sequential layers."""
    from repro_torch.distributed.pipeline_parallel import pipeline_apply

    errs = {}
    for n_stages in DIST_PIPE_STAGES:
        mesh = dist_mesh((n_stages, world // n_stages), ("stage", "data"))
        g = torch.Generator(device="cpu").manual_seed(2800 + n_stages)
        w = (torch.randn((n_stages, 3, 16, 16), generator=g) / 4.0).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((DIST_PIPE_MICRO, 8, 16), generator=g).to(
                dev, dtype)
            got = pipeline_apply(lambda wp, h: torch.tanh(h @ wp),
                                 w.to(dtype), x, mesh)
            seq = x
            for s in range(n_stages):
                for layer in range(3):
                    seq = torch.tanh(seq @ w[s, layer].to(dtype))
            errs[f"{n_stages}/{dtype}"] = float(
                (got.float() - seq.float()).abs().max())
    return {"errs": errs}


def dist_qwen_cfg(padding: bool):
    from repro_torch import configs

    return configs.get_config("qwen3-4b").replace(
        n_layers=DIST_QWEN_LAYERS, attn_head_padding=padding)


def dist_qwen_run(cfg, dev, tokens, mesh=None) -> tuple:
    """``make_prefill_step`` over the prompt, then ``DIST_STEPS`` steps of
    ``make_serve_step`` teacher-forced on ``tokens`` (B, prompt + steps):
    each step's last-position logits (fp32, on the host), and the flash
    launches."""
    from repro_torch.distributed import compat
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tr
    from repro_torch.training import train_step as ts

    g = torch.Generator(device=dev).manual_seed(DIST_QWEN_SEED)
    model = tr.init_model(cfg, g, dev)
    kw = {}
    if mesh is not None:
        from repro_torch.distributed import sharding

        sharding.distribute(model, mesh, cfg=cfg)
        kw = {"mesh": mesh}

    def whole(t):
        return compat.replicated(t, mesh) if mesh is not None else t

    launches = build.LAUNCHES["flash_attention"]
    prompt = tokens[:, :DIST_PROMPT]
    logits = [whole(ts.make_prefill_step(cfg, **kw)(
        model, {"tokens": prompt}))[:, -1].float().cpu()]
    cache = tr.init_model_cache(cfg, tokens.shape[0], tokens.shape[1],
                                device=dev)
    serve = ts.make_serve_step(cfg, **kw)
    for j in range(DIST_PROMPT, DIST_PROMPT + DIST_STEPS):
        step, cache = serve(model, cache, tokens[:, j:j + 1], j)
        logits.append(whole(step)[:, -1].float().cpu())
    torch.cuda.synchronize()
    return torch.stack(logits, 1), (build.LAUNCHES["flash_attention"]
                                    - launches)


def dist_rank_qwen(rank, world, dev) -> dict:
    """(d) qwen3-4b at full width (2 layers, bf16) on a 1 x ``world``
    mesh, head padding on when ``world`` does not divide 32 heads."""
    tokens = torch.load(DIST_DIR / "qwen_tokens.pt").to(dev)
    cfg = dist_qwen_cfg(padding=dist_qwen_cfg(False).n_heads % world != 0)
    mesh = dist_mesh((1, world), ("data", "model"))
    logits, flash = dist_qwen_run(cfg, dev, tokens, mesh)
    return {"logits": logits if rank == 0 else None, "flash": flash}


def dist_rank_ckpt(rank, world, dev) -> dict:
    """(e) a sharded checkpoint on CUDA ranks: a bf16 weight placed on a
    2 x ``world / 2`` mesh, saved (``checkpoint.save`` gathers it through
    ``compat``), restored onto ``world`` x 1 (the reference's
    reshard-on-load); whether this rank's block is its slice of the
    weight."""
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import P
    from repro_torch.training import checkpoint as ck

    g = torch.Generator(device="cpu").manual_seed(DIST_CKPT_SEED)
    w = torch.randn(DIST_CKPT_SHAPE, generator=g).to(dev, torch.bfloat16)
    spec = P("data", "model")
    path = ck.save(DIST_DIR / "ckpt.bin", {"w": compat.placed(
        w, dist_mesh((2, world // 2), ("data", "model")), spec)})
    got, _ = ck.restore(path, {"w": w}, placements={"w": spec},
                        mesh=dist_mesh((world, 1), ("data", "model")))
    local = got["w"].to_local()
    return {"equal": torch.equal(local, w.chunk(world, 0)[rank]),
            "device": local.device.type}


DIST_PARTS = {"moe": dist_rank_moe, "psum": dist_rank_psum,
              "pipe": dist_rank_pipe, "qwen": dist_rank_qwen,
              "ckpt": dist_rank_ckpt}


def dist_moe_unsharded(dev) -> dict:
    """(a), first: the unsharded ``moe_fwd`` on the card (its output,
    routing and aux, ms a call, peak memory), its weights freed before
    the ranks start."""
    cfg = dist_moe_cfg()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    p, x = dist_moe_weights(cfg, dev, 0, cfg.moe.n_experts)
    want, aux, top_idx, ms = dist_moe_call(p, cfg, x)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del p, x
    torch.cuda.empty_cache()
    return {"out": want, "aux": float(aux), "top_idx": top_idx.cpu(),
            "ms": ms, "peak_gb": peak}


def dist_moe_check(dev, ranks: list, unsharded: dict) -> dict:
    """(a): the ranks' output against the unsharded run's."""
    want, aux, top_idx = (unsharded["out"], unsharded["aux"],
                          unsharded["top_idx"])
    ms, peak = unsharded["ms"], unsharded["peak_gb"]
    got = ranks[0]["moe"]["out"].to(dev)
    rel = norm_rel(got.float(), want.float())
    for r, res in enumerate(ranks):
        check(torch.equal(res["moe"]["top_idx"], top_idx),
              f"rank {r}'s routing differs from the unsharded top_idx")
        check(res["moe"]["aux"] == aux,
              f"rank {r}'s aux {res['moe']['aux']} != {float(aux)}")
    check(torch.isfinite(got).all() and rel <= DIST_MOE_RTOL,
          f"expert-parallel MoE rel {rel} over {DIST_MOE_RTOL}")
    return {"rel": rel, "max_abs": float((got.float() - want.float()).abs()
                                         .max()),
            "psum_dtype": ranks[0]["moe"]["out_dtype"],
            "ms_unsharded": ms, "peak_gb_unsharded": peak,
            "ms_sharded": [res["moe"]["ms"] for res in ranks],
            "peak_gb_per_rank": [res["moe"]["peak_gb"] for res in ranks],
            "host_copies": ranks[0]["moe"]["host_copies"]}


def dist_psum_check(dev, ranks: list) -> dict:
    """(b): the parity checks, each rank's error bit for bit against
    ``fused_error_feedback_step`` alone on the card over its input, the
    mean the same bits on every rank and within ``world`` spacings of
    the reconstructions' magnitude from their fp64 mean (an fp32 sum's
    rounding in any order); launches."""
    from repro_torch.quantization import fused_error_feedback_step

    world = len(ranks)
    for r, res in enumerate(ranks):
        for key, (step, e1, ek) in res["psum"]["checks"].items():
            check(e1 <= step * 1.01 + 1e-6, f"psum {world} {key}: one sync "
                  f"{e1} over the round trip's {step}")
            check(ek <= e1 / 2 + 1e-6 or e1 < 1e-6, f"psum {world} {key}: "
                  f"4 syncs {ek} over half of {e1}")
    recs = []
    for r, res in enumerate(ranks):
        x = dist_psum_inputs(r, dev)
        _, rec, err = fused_error_feedback_step(x, torch.zeros_like(x))
        check(torch.equal(res["psum"]["new_err"], err.cpu()),
              f"psum {world}: rank {r}'s error differs from the lone step's")
        recs.append(rec)
    got = ranks[0]["psum"]["reduced"]
    for r, res in enumerate(ranks):
        check(torch.equal(res["psum"]["reduced"], got),
              f"psum {world}: rank {r}'s mean differs from rank 0's")
    got = got.to(dev)
    mean = sum(r.double() for r in recs) / world
    size = sum(r.double().abs() for r in recs) / world
    gap = (got.double() - mean).abs()
    spacing = torch.from_numpy(np.spacing(size.float().cpu().numpy())).to(dev)
    ulps = float((gap / spacing.double()).max())
    check(ulps <= world, f"psum {world}: mean {ulps} spacings off")
    per_rank = ranks[0]["psum"]["launches"]
    return {"ulps_of_magnitude": ulps,
            "launches": {k: sum(res["psum"]["launches"][k] for res in ranks)
                         for k in ("quant_int8", "dequant_int8")},
            "launches_per_rank": {k: per_rank[k]
                                  for k in ("quant_int8", "dequant_int8")},
            "host_copies": ranks[0]["psum"]["host_copies"]}


def dist_qwen_check(dev, world_runs: dict) -> dict:
    """(d): the unsharded steps on the card, then each world's ranks
    against them: logits per step within ``DIST_LOGITS_RTOL``, the greedy
    token equal wherever its top-2 margin is clear (``MARGIN_FACTOR``)."""
    out = {}
    want, flash = dist_qwen_run(dist_qwen_cfg(False), dev,
                                torch.load(DIST_DIR / "qwen_tokens.pt").to(dev))
    for world, ranks in world_runs.items():
        got = ranks[0]["qwen"]["logits"]
        rels = [norm_rel(got[:, j], want[:, j]) for j in range(got.shape[1])]
        diff = (got - want).abs().amax(-1)
        top2 = torch.topk(want, 2).values
        clear = (top2[..., 0] - top2[..., 1]) > MARGIN_FACTOR * diff
        same = got.argmax(-1) == want.argmax(-1)
        check(bool(same[clear].all()), f"qwen3-4b on {world} ranks: a clear "
              f"greedy token differs")
        check(max(rels) <= DIST_LOGITS_RTOL,
              f"qwen3-4b on {world} ranks: logits rel {max(rels)}")
        out[f"1x{world}"] = {
            "rel_max": max(rels), "clear": int(clear.sum()),
            "tokens": clear.numel(),
            "flash_per_rank": [res["qwen"]["flash"] for res in ranks],
            "host_copies": ranks[0]["qwen"]["host_copies"],
            "seconds": ranks[0]["qwen"]["seconds"]}
    out["flash_unsharded"] = flash
    return out


def dist_phase(dev) -> dict:
    """Phase 25: the distributed layer (``repro_torch.distributed``), its
    ranks child processes sharing the card in a gloo group: (a) one
    deepseek-v3-671b MoE layer expert-parallel on 1 x 4 against the
    unsharded one, (b) ``compressed_psum`` on 4 and 8 ranks, (c)
    ``pipeline_apply`` on 2 and 4 stages, (d) qwen3-4b (2 layers, bf16)
    served through ``make_prefill_step``/``make_serve_step(mesh=)`` on
    1 x 4 and, with head padding (32 -> 48), 1 x 3, (e) a sharded
    checkpoint saved on 2 x 2 and restored onto 4 x 1.  Returns the
    ranks' kernel launches (the main path's: the comparisons run here
    count none)."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    g = torch.Generator(device="cpu").manual_seed(DIST_QWEN_SEED + 1)
    DIST_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(torch.randint(0, dist_qwen_cfg(False).vocab_size,
                             (DIST_ROWS, DIST_PROMPT + DIST_STEPS),
                             generator=g), DIST_DIR / "qwen_tokens.pt")
    moe_unsharded = dist_moe_unsharded(dev)
    four = dist_spawn(dist_ranks_main, 4,
                      ("moe", "psum", "pipe", "qwen", "ckpt"))
    eight = dist_spawn(dist_ranks_main, 8, ("psum",))
    three = dist_spawn(dist_ranks_main, 3, ("qwen",))
    out = {"moe": dist_moe_check(dev, four, moe_unsharded)}
    print(f"phase 25 (a) MoE 1x4: {json.dumps(out['moe'])}")
    out["psum"] = {w: dist_psum_check(dev, ranks)
                   for w, ranks in ((4, four), (8, eight))}
    print(f"phase 25 (b) compressed_psum: {json.dumps(out['psum'])}")
    pipe = four[0]["pipe"]["errs"]
    for key, err in pipe.items():
        dtype = torch.float32 if "float32" in key else torch.bfloat16
        check(err < DIST_PIPE_TOL[dtype], f"pipeline {key}: {err}")
    # each of the n_micro + P - 1 steps' ppermute stages one copy to the
    # host and one back (gloo sends no CUDA tensor), per dtype
    steps = sum(DIST_PIPE_MICRO + n - 1 for n in DIST_PIPE_STAGES)
    for r, res in enumerate(four):
        copies = res["pipe"]["host_copies"]
        check(copies == {"to_host": 2 * steps, "to_device": 2 * steps},
              f"pipeline rank {r}: host copies {copies}, the schedule "
              f"implies {2 * steps} each way")
    print(f"phase 25 (c) pipeline max abs err: {json.dumps(pipe)}; host "
          f"copies a rank: {json.dumps(four[0]['pipe']['host_copies'])}")
    out["qwen"] = dist_qwen_check(dev, {4: four, 3: three})
    print(f"phase 25 (d) qwen3-4b: {json.dumps(out['qwen'])}")
    for r, res in enumerate(four):
        check(res["ckpt"]["equal"] and res["ckpt"]["device"] == "cuda",
              f"checkpoint rank {r}: restored block {res['ckpt']}")
    print(f"phase 25 (e) checkpoint 2x2 -> 4x1: every rank's block equal; "
          f"host copies a rank: {json.dumps(four[0]['ckpt']['host_copies'])}")
    total = dict.fromkeys(KERNELS, 0)
    for ranks in (four, eight, three):
        for res in ranks:
            for part in res.values():
                for k in KERNELS:
                    total[k] += part["launches"].get(k, 0)
    want = sum(v["launches"]["quant_int8"] for v in out["psum"].values())
    check(total["quant_int8"] == total["dequant_int8"] == want,
          f"phase 25 quant launches {total}, want {want} each")
    check(total["quant_int8"] == 9 * (4 + 8),
          f"phase 25: {total['quant_int8']} quant launches, the code implies "
          f"9 a rank (2 dtypes x 4 rowwise syncs + 1) over 12 ranks")
    print(f"distributed phase launches: {json.dumps(total)}; "
          f"{time.perf_counter() - t0:.1f} s; card: {card_line()}")
    return total


def mixer_layers(cfg, mixer: str) -> int:
    """The number of layers of ``cfg`` whose mixer is ``mixer``."""
    from repro_torch.models import transformer as tr

    return sum(spec.mixer == mixer for spec in tr.layer_specs(cfg))


def lm_main_path(dev, name: str, large_layers: int, small_layers: int,
                 seeds=(1, 2)):
    """Phases 8 and 12: the large model ``name`` cut to ``large_layers``
    and its ``small_layers`` cut; returns the models, their configs, the
    prompts and the path's
    launches.  Flash attention launches once per attention layer per
    decode step and per scored batch; the RG-LRU scan never in decode and
    once per recurrent layer per scored batch."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import (greedy_decode, relay_decode,
                                              sequence_logprob)
    from repro_torch.training.data import DataConfig, TokenPipeline

    cfg_l = configs.get_config(name).replace(n_layers=large_layers)
    cfg_s = cfg_l.replace(n_layers=small_layers)
    t0 = time.perf_counter()
    large = tr.init_model(cfg_l, torch.Generator(device=dev)
                          .manual_seed(seeds[0]), dev)
    small = tr.init_model(cfg_s, torch.Generator(device=dev)
                          .manual_seed(seeds[1]), dev)
    torch.cuda.synchronize()
    print(f"{name} models: large {cfg_l.n_layers} layers "
          f"{cm.count_params(large) / 1e9:.3f} B params, small "
          f"{cfg_s.n_layers} layers {cm.count_params(small) / 1e9:.3f} B, "
          f"{cfg_l.dtype}, drawn in {time.perf_counter() - t0:.1f} s")
    prompt = TokenPipeline(DataConfig(
        vocab_size=cfg_l.vocab_size, seq_len=LM_PROMPT,
        global_batch=LM_BATCH)).batch(999)[0]

    build.reset_launches()
    flash_ops.reset_variant_launches()
    runs = {}
    seq, ms = host_timed(lambda: greedy_decode(large, cfg_l, prompt, LM_TOTAL))
    runs["large-only"] = (LM_TOTAL, 0, seq, ms)
    for s in LM_SPLITS:
        (seq, info), ms = host_timed(lambda: relay_decode(
            large, cfg_l, small, cfg_s, prompt, s, LM_TOTAL))
        want = LM_BATCH * (LM_PROMPT + s) * 4  # 4 bytes a token
        check(info["transfer_bytes"] == want and info["edge_tokens"] == s
              and info["node_tokens"] == {"n00": s, "n01": LM_TOTAL - s},
              f"relay s={s}: info {info}, transfer bytes want {want}")
        runs[f"relay s={s}"] = (s, LM_TOTAL - s, seq, ms)
    seq, ms = host_timed(lambda: greedy_decode(small, cfg_s, prompt, LM_TOTAL))
    runs["small-only"] = (0, LM_TOTAL, seq, ms)
    decode = dict(build.LAUNCHES)
    # decode steps (prompt + new tokens) of each model over all runs
    steps_l = sum(LM_PROMPT + e for e, _, _, _ in runs.values() if e)
    steps_s = sum(LM_PROMPT + LM_TOTAL for _, d, _, _ in runs.values() if d)
    want_decode = {"flash_attention": mixer_layers(cfg_l, "attn") * steps_l
                   + mixer_layers(cfg_s, "attn") * steps_s, "rglru_scan": 0}
    got = {k: decode[k] for k in want_decode}
    check(got == want_decode, f"{name}: launches in decode {got}, want "
          f"{want_decode}")
    # every bf16 flash call of the path on a tensor-core kernel
    variants = dict(flash_ops.VARIANT_LAUNCHES)
    want_variants = {"simt": 0, "decode": want_decode["flash_attention"],
                     "scoring": 0}
    check(variants == want_variants, f"{name}: flash kernels in decode "
          f"{variants}, want {want_variants}")

    logp = {run: sequence_logprob(large, cfg_l, r[2])
            for run, r in runs.items()}
    scoring = {k: build.LAUNCHES[k] - decode[k] for k in want_decode}
    want_scoring = {
        "flash_attention": mixer_layers(cfg_l, "attn") * len(runs),
        "rglru_scan": mixer_layers(cfg_l, "rglru") * len(runs)}
    check(scoring == want_scoring, f"{name}: launches in scoring "
          f"{scoring}, want {want_scoring}")
    want_variants["scoring"] = want_scoring["flash_attention"]
    check(flash_ops.VARIANT_LAUNCHES == want_variants, f"{name}: flash "
          f"kernels after scoring {flash_ops.VARIANT_LAUNCHES}, want "
          f"{want_variants}")
    launches = dict(build.LAUNCHES)

    ref = runs["large-only"][2]
    prompt_t = torch.from_numpy(prompt).to(dev)
    for run, (e, _, seq, _) in runs.items():
        check(seq.shape == (LM_BATCH, LM_PROMPT + LM_TOTAL)
              and seq.dtype == prompt_t.dtype
              and bool(((seq >= 0) & (seq < cfg_l.vocab_size)).all())
              and torch.equal(seq[:, :LM_PROMPT], prompt_t),
              f"{run}: sequence {tuple(seq.shape)} out of range or prompt lost")
        check(np.isfinite(logp[run]), f"{run}: logp {logp[run]}")
        # the relay's large segment is the large-only decode's prefix
        check(torch.equal(seq[:, :LM_PROMPT + e], ref[:, :LM_PROMPT + e]),
              f"{run}: large-model prefix differs from large-only")
    print(f"{name} main path launches: decode {json.dumps(got)}, "
          f"scoring {json.dumps(scoring)}; flash kernels "
          f"{json.dumps(want_variants)}")
    print(f"{'config':12s} {'edge':>5s} {'dev':>5s} {'logp(large)':>12s} "
          f"{'wall ms':>9s}")
    for run, (e, d, _, ms) in runs.items():
        print(f"{run:12s} {e:5d} {d:5d} {logp[run]:12.4f} {ms:9.1f}")
    return large, small, cfg_l, cfg_s, prompt, launches


def traced_relay(large, small, cfg_l, cfg_s, prompt) -> int:
    """Phase 8, the span tracer on the LM relay: the relay at s =
    ``LM_SPLITS[0]`` untraced, then in turn through ``relay_decode(...,
    tracer=, rid=7)``: the same tokens bit for bit and the same flash
    launches on each variant (the tracer launches nothing);
    request 7's spans tile the logical clock of one second per token; the
    Chrome trace is schema-valid, also through the exporter's CLI in a
    child process; the JSONL reads back to the same spans.  Returns the
    run's flash attention launches."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.serving.lm_relay import relay_decode
    from repro_torch.serving.obs import (SpanTracer, to_chrome_trace,
                                         validate_chrome_trace,
                                         write_chrome_trace,
                                         write_spans_jsonl)

    s, rid = LM_SPLITS[0], 7
    tracer = SpanTracer()
    runs = {}  # (tokens, ms, flash launches per variant, all launches)
    for name, kw in (("untraced", {}), ("traced", {"tracer": tracer,
                                                   "rid": rid})):
        build.reset_launches()
        flash_ops.reset_variant_launches()
        (seq, info), ms = host_timed(functools.partial(
            relay_decode, large, cfg_l, small, cfg_s, prompt, s, LM_TOTAL,
            **kw))
        runs[name] = (seq, ms, dict(flash_ops.VARIANT_LAUNCHES),
                      dict(build.LAUNCHES))
    seq, ms, variants, launches = runs["traced"]
    check(torch.equal(seq, runs["untraced"][0]),
          "the traced relay's tokens differ from the untraced run's")
    check(variants == runs["untraced"][2]
          and launches["flash_attention"] == sum(variants.values())
          and not any(v for k, v in launches.items()
                      if k != "flash_attention"),
          f"traced relay launches {launches}, flash {variants}; untraced "
          f"flash {runs['untraced'][2]}")
    req = tracer.requests.get(rid)
    check(list(tracer.requests) == [rid] and req.complete
          and req.t_total == req.attributed_s() == float(LM_TOTAL),
          f"request {rid}: complete {req and req.complete}, t_total "
          f"{req and req.t_total}, attributed {req and req.attributed_s()}")
    segs = [(sp.name, sp.meta.get("tokens")) for sp in req.spans
            if sp.kind == "segment"]
    hops = [sp.meta["bytes"] for sp in req.spans if sp.kind == "hop"]
    want = LM_BATCH * (LM_PROMPT + s) * 4
    check(segs == [("n00", s), ("n01", LM_TOTAL - s)]
          and hops == [info["transfer_bytes"]] == [want],
          f"segment spans {segs}, hop bytes {hops}, want {want}")
    trace = to_chrome_trace(tracer)
    errors = validate_chrome_trace(trace)
    check(errors == [], f"chrome trace schema: {errors}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "lm_relay_trace.json"
        write_chrome_trace(tracer, str(path))
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.serving.obs.export",
             str(path)], cwd=REPO, capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
        check(cli.returncode == 0, f"the exporter's CLI: rc "
              f"{cli.returncode} {cli.stdout[-2000:]} {cli.stderr[-2000:]}")
        jsonl = Path(tmp) / "lm_relay_spans.jsonl"
        n_lines = write_spans_jsonl(tracer, str(jsonl))
        lines = [json.loads(x) for x in jsonl.read_text().splitlines()]
    spans = [{k: v for k, v in x.items() if k != "type"}
             for x in lines if x["type"] == "span"]
    check(len(lines) == n_lines
          and spans == [sp.as_dict() for sp in req.spans],
          "the spans' JSONL does not read back to the spans")
    print(f"{cfg_l.name} traced relay s={s}: tokens equal the untraced "
          f"run's, flash launches per variant {json.dumps(variants)} as "
          f"untraced; request {rid} t_total {req.t_total} = attributed, "
          f"segments {segs}, hop bytes {hops}; chrome trace "
          f"{len(trace['traceEvents'])} events schema-valid (CLI: "
          f"{cli.stdout.strip()}), JSONL {n_lines} lines read back")
    print(f"{cfg_l.name} relay s={s} ms per request, in turns: untraced "
          f"{runs['untraced'][1] / LM_BATCH:.2f}, traced {ms / LM_BATCH:.2f}")
    return launches["flash_attention"]


def rg_check_config(cfg):
    """Phase 13's configuration: ``cfg`` at full width, ``RG_CHECK_LAYERS``
    layers, each local-attention window cut to ``RG_CHECK_WINDOW`` (for
    this check only: at the model's 2048 a 32-token run never wraps the
    ring)."""
    def cut(specs):
        return tuple(dataclasses.replace(
            spec, window=RG_CHECK_WINDOW if spec.window else None)
            for spec in specs)
    return cfg.replace(n_layers=RG_CHECK_LAYERS, pattern=cut(cfg.pattern),
                       remainder=cut(cfg.remainder))


def lm_card_vs_cpu(dev, prompt, cfg, seeds=(3, 4), s=4, total=8) -> dict:
    """Phases 9 and 13, fp32: ``cfg`` in fp32 (full width, cut in depth),
    the same weights on both; a relay of ``total`` new tokens at ``s``
    after 16 tokens of 2 prompts."""
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import relay_decode, sequence_logprob

    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products
    cfg = cfg.replace(dtype="float32")
    models = {role: tr.init_model(cfg, torch.Generator(device=dev)
                                  .manual_seed(seed), dev)
              for role, seed in zip(("large", "small"), seeds)}
    p2 = prompt[:2, :16]
    places = {"card": dev, "cpu": torch.device("cpu")}
    out = {}
    for name, where in places.items():
        for m in models.values():
            m.to(where)
        seq, info = relay_decode(models["large"], cfg, models["small"], cfg,
                                 p2, s, total, device=where)
        out[name] = {"seq": seq.cpu(), "info": info}
    # logits of both devices on the card's tokens
    seq = out["card"]["seq"]
    for name in ("cpu", "card"):
        where = places[name]
        for m in models.values():
            m.to(where)
        out[name]["logits"] = {
            role: tr.model_fwd(m, cfg, {"tokens": seq.to(where).long()})
            .float().cpu() for role, m in models.items()}
        out[name]["logp"] = sequence_logprob(models["large"], cfg, seq,
                                             device=where)
    card, cpu = out["card"], out["cpu"]
    rel = {role: float(torch.linalg.norm(card["logits"][role]
                                         - cpu["logits"][role])
                       / torch.linalg.norm(cpu["logits"][role]))
           for role in models}
    check(max(rel.values()) <= LM_RTOL, f"LM card vs CPU logits rel {rel}")
    lp_rel = abs(card["logp"] - cpu["logp"]) / abs(cpu["logp"])
    check(lp_rel <= LM_RTOL, f"LM card vs CPU logp rel {lp_rel}")
    check(card["info"] == cpu["info"], "LM card vs CPU relay info differs")
    # tokens, up to the first tie: position j was chosen by the logits at
    # j - 1 of the model whose segment holds it
    p = p2.shape[1]
    tie, margins = None, []
    for j in range(p, p + total):
        role = "large" if j < p + s else "small"
        lc, lh = (x["logits"][role][:, j - 1, :cfg.vocab_size]
                  for x in (card, cpu))
        top2 = torch.topk(lc, 2).values
        margin = top2[:, 0] - top2[:, 1]
        gap = (lc - lh).abs().amax(-1)
        margins.append(float(margin.min()))
        if bool((margin <= MARGIN_FACTOR * gap).any()):
            tie = j
            break
    upto = p + total if tie is None else tie
    check(torch.equal(card["seq"][:, :upto], cpu["seq"][:, :upto]),
          f"LM card vs CPU tokens differ before position {upto}")
    result = {"logits_rel": rel, "logp_rel": lp_rel,
              "tokens_equal_upto": upto, "tie_at": tie,
              "min_margin": min(margins)}
    print(f"{cfg.name} card vs CPU ({cfg.n_layers} layers, fp32): "
          f"{json.dumps(result)}")
    del models
    return result


def norm_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in fp64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def lm_bf16_card_vs_cpu(dev, prompt, cfg, tol: float, seed: int = 6,
                        n_new: int = 8) -> dict:
    """Phases 9 and 13, bf16: ``cfg`` (full width, cut in depth) in the
    main path's dtype, the same weights on the card and the CPU (the plain
    path).  The card greedy-decodes ``n_new`` tokens after 16 of a prompt;
    both devices then feed those tokens one by one through ``decode_step``
    (the bf16 caches written and read as on the main path) and once
    through ``model_fwd`` (the scoring forward).  Each layer's mixer
    output (attention or RG-LRU block) at each step and in the scoring
    forward, every cache tensor (K/V, or the ``h`` and ``conv`` states)
    after each step, and the logits are held card against CPU within
    ``tol``, norm-wise.  The mixer outputs are compared on their own: with
    random weights the tied logits are dominated by the current token's
    own embedding, so a wrong cache read or state carry would move them
    little."""
    from repro_torch.models import attention as attn
    from repro_torch.models import recurrent as rec
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import greedy_decode

    model = tr.init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                          dev)
    seq = greedy_decode(model, cfg, prompt[:2, :16], n_new, device=dev)
    b, n = seq.shape
    originals, seen = {"attn": attn.gqa_fwd, "rglru": rec.rglru_block_fwd}, []

    def host(x):  # a copy on the host: the caches change in place
        return x.to("cpu", torch.float32, copy=True)

    def recording(kind):  # every layer's mixer output
        def fwd(*args, **kw):
            y, c = originals[kind](*args, **kw)
            seen.append((kind, host(y)))
            return y, c
        return fwd

    def by_kind(records, prefix):
        out = {}
        for kind, y in records:
            out.setdefault(f"{prefix}_{kind}", []).append(y)
        return out

    out = {}
    attn.gqa_fwd, rec.rglru_block_fwd = recording("attn"), recording("rglru")
    try:
        for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
            model.to(where)
            toks = seq.to(where)
            cache = tr.init_model_cache(cfg, b, n, device=where)
            res = {"logits": []}
            with torch.no_grad():
                for t in range(n):
                    lg, cache = tr.decode_step(model, cfg, cache,
                                               toks[:, t:t + 1], t)
                    res["logits"].append(host(lg[:, 0, :cfg.vocab_size]))
                    for c in cache["layers"]:
                        for key, x in c.items():
                            res.setdefault(f"cache_{key}", []).append(host(x))
                res.update(by_kind(seen, "decode"))
                seen.clear()
                scoring = tr.model_fwd(model, cfg, {"tokens": toks})
            res.update(by_kind(seen, "scoring"))
            res["scoring_logits"] = [host(scoring[:, j, :cfg.vocab_size])
                                     for j in range(n)]
            out[name] = res
            seen.clear()
    finally:
        attn.gqa_fwd, rec.rglru_block_fwd = originals["attn"], originals["rglru"]
    del model
    card, cpu = out["card"], out["cpu"]
    kinds = {"attn": mixer_layers(cfg, "attn"),
             "rglru": mixer_layers(cfg, "rglru")}
    check(all(len(card.get(f"decode_{k}", ())) == n * m
              and len(card.get(f"scoring_{k}", ())) == m
              for k, m in kinds.items() if m)
          and card.keys() == cpu.keys(), f"bf16 {cfg.name}: mixer calls recorded")
    rel = {key: max(norm_rel(a, c) for a, c in zip(card[key], cpu[key]))
           for key in sorted(card)}
    print(f"{cfg.name} card vs CPU ({cfg.n_layers} layers, bf16, {b} prompts "
          f"of {n} tokens), largest norm-wise relative error per step and "
          f"layer: {json.dumps(rel)}")
    check(max(rel.values()) <= tol,
          f"bf16 {cfg.name} card vs CPU over {tol}: {rel}")
    return rel


def flash_times(dev, floor_ms) -> dict:
    """Phase 7: flash attention's times per shape, bf16."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    steps = LM_PROMPT + LM_TOTAL
    shapes = {
        # (b, h, kv, s, t, d, causal, window, kv_len, iters)
        "decode": (LM_BATCH, 32, 8, 1, steps, 128, False, None, steps, 200),
        "scoring": (LM_BATCH, 32, 8, steps, steps, 128, True, None, None,
                    100),
        "s4096": (1, 32, 8, 4096, 4096, 128, True, None, None, 10),
        # recurrentgemma-9b: the ring decode and the windowed scoring call
        "rg_decode": (LM_BATCH, 16, 1, 1, steps, 256, False, None, steps,
                      200),
        "rg_scoring": (LM_BATCH, 16, 1, steps, steps, 256, True, 2048, None,
                       100),
        # decode over long caches: qwen3-4b at 4096, the ring of 2048
        "decode_t4096": (LM_BATCH, 32, 8, 1, 4096, 128, False, None, 4096,
                         50),
        "rg_decode_t2048": (LM_BATCH, 16, 1, 1, 2048, 256, False, None, 2048,
                            100),
        # phase 23: whisper-medium's encoder and cross calls (prompt,
        # decode), llama-3.2-vision-11b's cross calls, a longer prompt
        "enc_whisper": (ENC_ROWS, 16, 16, ENC_FRAMES, ENC_FRAMES, 64, False,
                        None, None, 20),
        "cross_whisper_prompt": (ENC_ROWS, 16, 16, ENC_PROMPT, ENC_FRAMES,
                                 64, False, None, None, 100),
        "cross_whisper_decode": (ENC_ROWS, 16, 16, 1, ENC_FRAMES, 64, False,
                                 None, None, 200),
        "cross_vision_prompt": (ENC_ROWS, 32, 8, ENC_PROMPT, VISION_CTX, 128,
                                False, None, None, 100),
        "cross_vision_decode": (ENC_ROWS, 32, 8, 1, VISION_CTX, 128, False,
                                None, None, 200),
        "cross_whisper_s70": (2, 16, 16, 70, ENC_FRAMES, 64, False, None,
                              None, 100),
    }
    rows = {}
    for name, (b, h, kv, s, t, d, causal, window, kv_len,
               iters) in shapes.items():
        q, k, v = flash_inputs(gen, dev, b, h, kv, s, t, d, torch.bfloat16,
                               model_layout=True)
        # a window of at least s keys changes nothing for SDPA's causal mask
        kw = dict(causal=causal, window=window, kv_len=kv_len)
        kl = t if kv_len is None else kv_len
        k_l, v_l = k[:, :, :kl], v[:, :, :kl]
        kern = timed(lambda: flash_attention(q, k, v, **kw), iters)
        plain = timed(lambda: flash_attention_ref(q, k, v, **kw), iters)
        lib = timed(lambda: F.scaled_dot_product_attention(
            q, k_l, v_l, is_causal=causal, enable_gqa=True), iters)
        b_ms, b_by = rl.bound(rl.flash_work(b, h, kv, s, t, d, causal,
                                            window, kl, 2), torch.bfloat16)
        f_ms, f_by = max((b_ms, b_by), (floor_ms, "launch"))
        rows[name] = {"shape": [b, h, kv, s, t, d, causal, kl],
                      "ms": kern["ms"], "call_ms": kern["call_ms"],
                      "plain_ms": plain["ms"],
                      "plain_call_ms": plain["call_ms"],
                      "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
                      "bound_ms": b_ms, "bound_by": b_by,
                      "floor_ms": f_ms, "floor_by": f_by}
    print(f"flash_attention times, bf16 (b, h, kv, s, t, d, causal, "
          f"kv_len): "
          f"{json.dumps(rows)}")
    return rows


def rglru_inputs(gen, dev, shape):
    """Decays a in [0.3, 0.999) and inputs b ~ N(0, 0.2²), as
    ``tests/test_kernels.py`` draws them."""
    a = torch.rand(shape, generator=gen, device=dev) * 0.699 + 0.3
    return a, torch.randn(shape, generator=gen, device=dev) * 0.2


def check_rglru(gen, dev) -> float:
    """Phase 11: the scan against its plain version, bit for bit."""
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    worst = 0.0
    for shape in RGLRU_SHAPES:
        a, b = rglru_inputs(gen, dev, shape)
        out, ref = rglru_scan(a, b), rglru_scan_ref(a, b)
        torch.cuda.synchronize()
        err = float((out.double() - ref.double()).abs().max())
        worst = max(worst, err)
        check(out.dtype == torch.float32 and torch.equal(out, ref),
              f"rglru_scan {shape} differs from its plain version "
              f"(max |err| {err})")
    print(f"rglru_scan equals its plain version bit for bit: "
          f"{json.dumps(RGLRU_SHAPES)}")
    return worst


def rglru_times(dev, floor_ms) -> dict:
    """Phase 11: the scan's times at the path's shape and a long one.  No
    single PyTorch call computes the recurrence (a cumprod/cumsum form
    underflows), so there is no library time."""
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = {}
    # (shape, iters of the kernel, iters of the plain loop)
    for name, shape, iters, plain_iters in (
            ("scoring", RGLRU_SHAPES[0], 200, 20),
            ("long", (1, 4096, 4096), 20, 1)):
        a, b = rglru_inputs(gen, dev, shape)
        kern = timed(lambda: rglru_scan(a, b), iters, records=1)
        # the plain loop launches a fill, then a product, a sum and a copy
        # per step: the profiler has lost the last of 36,867 such records
        # in one session, so each session's count is checked exactly
        plain = timed(lambda: rglru_scan_ref(a, b), plain_iters,
                      records=3 * shape[1] + 1)
        b_ms, b_by = rl.bound(rl.scan_work(int(np.prod(shape))))
        f_ms, f_by = max((b_ms, b_by), (floor_ms, "launch"))
        rows[name] = {"shape": list(shape), "ms": kern["ms"],
                      "call_ms": kern["call_ms"], "plain_ms": plain["ms"],
                      "plain_call_ms": plain["call_ms"], "library_ms": None,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "floor_ms": f_ms, "floor_by": f_by}
    print(f"rglru_scan times (B, S, R): {json.dumps(rows)}")
    return rows


def lm_times(large, small, cfg_l, cfg_s, prompt) -> dict:
    """Phases 10 and 14: ms per new token, per relay request, and the busy
    share of one relay run."""
    from repro_torch.serving.lm_relay import greedy_decode, relay_decode

    _, large_ms = host_timed(lambda: greedy_decode(large, cfg_l, prompt, LM_TOTAL))
    _, small_ms = host_timed(lambda: greedy_decode(small, cfg_s, prompt, LM_TOTAL))
    s = LM_SPLITS[len(LM_SPLITS) // 2]
    relay = lambda: relay_decode(large, cfg_l, small, cfg_s, prompt,  # noqa: E731
                                 s, LM_TOTAL)
    _, relay_ms = host_timed(relay)
    times = {
        "large_ms_per_new_token": large_ms / LM_TOTAL,
        "small_ms_per_new_token": small_ms / LM_TOTAL,
        "large_ms_per_decode_step": large_ms / (LM_PROMPT + LM_TOTAL),
        "small_ms_per_decode_step": small_ms / (LM_PROMPT + LM_TOTAL),
        f"relay_s{s}_ms_per_request": relay_ms / LM_BATCH,
        f"relay_s{s}_ms_per_batch": relay_ms,
        f"busy_relay_s{s}": busy(relay, relay_ms, counted="flash_attention"),
    }
    print(f"{cfg_l.name} times ({LM_BATCH} prompts of {LM_PROMPT}, "
          f"{LM_TOTAL} new tokens): {json.dumps(times)}")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.diffusion.families import load_families
    from repro_torch.diffusion import synth
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_sampler import ops as fops
    from repro_torch.kernels.fused_sampler import ref as fref
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.serving.arms import build_action_space
    from repro_torch.serving.executor import Executor

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({build.library_path().name})")
    log = build.build_log_path().read_text()
    for src in ("quant.cu", "fused_sampler.cu"):
        for name, regs, spills in ptxas_entries(log, src):
            if "emit_" not in name:
                print(f"  ptxas {name}: {regs} registers, {spills} bytes of spills")
    for line in emit_ptxas(log):
        print(f"  ptxas {line}")
    flash = flash_ptxas(log)
    check(len(flash) == 14, f"ptxas reported {len(flash)} flash kernels, "
          f"want 14 (8 CUDA-core, 3 decode, 3 scoring)")
    for line in flash:
        print(f"  ptxas {line}")

    # ---- 2. each kernel against its plain version ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {name: 0.0 for name in KERNELS}

    def note(name, a, b):
        err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        max_err[name] = max(max_err[name], err)
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b),
              f"{name} differs from its plain version (max |err| {err})")

    shapes = [(4, WIRE_LEN), (MAIN_ROWS, WIRE_LEN), (13, 17), (3, 33),
              (1, 5), (3, 1500), (8192, 4096)]
    n_cases = 0
    for rows, length in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, ec, eu = (torch.randn(rows, length, generator=gen, device=dev)
                         .to(dtype) for _ in range(3))
            q, s = qops.quant_int8(x)
            qr, sr = qref.quant_int8_ref(x)
            note("quant_int8", q, qr)
            note("quant_int8", s, sr)
            note("dequant_int8", qops.dequant_int8(q, s),
                 qref.dequant_int8_ref(q, s))
            for mode, cf in (("ddim", [0.4, 0.6]), ("rf", [-0.02, 0.0])):
                coeffs = torch.tensor(cf, device=dev)
                for g in (1.0, 3.5):
                    q, s = fops.fused_cfg_step_quant(x, ec, eu, coeffs,
                                                     guidance=g, mode=mode)
                    qr, sr = fref.fused_cfg_step_quant_ref(
                        x, ec, eu, coeffs, guidance=g, mode=mode)
                    note("fused_cfg_step_quant", q, qr)
                    note("fused_cfg_step_quant", s, sr)
                    note("fused_cfg_step_dequant",
                         fops.fused_cfg_step_dequant(q, s, ec, eu, coeffs,
                                                     guidance=g, mode=mode),
                         fref.fused_cfg_step_dequant_ref(
                             q, s, ec, eu, coeffs, guidance=g, mode=mode))
                    n_cases += 1
    # the emit on every route of its plan and every load width
    emit_cases, seen = 0, set()

    def emit_case(x, ec, eu):
        nonlocal emit_cases
        for mode, cf in (("ddim", [0.4, 0.6]), ("rf", [RF_DT, 0.0])):
            coeffs = torch.tensor(cf, device=dev)
            for g in (1.0, GUIDANCE):
                read = (x, ec) if g == 1.0 else (x, ec, eu)
                p = fops.emit_plan(*x.shape, x.dtype, [t.data_ptr() for t in read])
                seen.add((p.route, str(x.dtype)[6:], p.vec))
                q, s = fops.fused_cfg_step_quant(x, ec, eu, coeffs, guidance=g,
                                                 mode=mode)
                qr, sr = fref.fused_cfg_step_quant_ref(x, ec, eu, coeffs,
                                                       guidance=g, mode=mode)
                note("fused_cfg_step_quant", q, qr)
                note("fused_cfg_step_quant", s, sr)
                emit_cases += 1
        return q, s

    for rows, length in EMIT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, ec, eu = (torch.randn(rows, length, generator=gen, device=dev)
                         .to(dtype) for _ in range(3))
            emit_case(x, ec, eu)
            emit_case(x, ec, ec)
    # slices of flat buffers whose bases lie 4, 8 (fp32) or 2, 4, 8 (bf16)
    # bytes off 16, and an odd L: the narrow-load plans
    for rows, length in ((8, 64), (4, 1500), (8, 16384), (5, 17)):
        for dtype, off in ((torch.float32, 1), (torch.float32, 2),
                           (torch.bfloat16, 1), (torch.bfloat16, 2),
                           (torch.bfloat16, 4)):
            emit_case(*(torch.randn(rows * length + off, generator=gen, device=dev)
                        .to(dtype)[off:].view(rows, length) for _ in range(3)))
    # an all-zero row (scale 1.0) and a row of subnormal magnitude, which
    # sends both IEEE divisions (x0 and the quantize) down their slow path
    for length in (WIRE_LEN, 1500, 16384):
        for dtype in (torch.float32, torch.bfloat16):
            x, ec, eu = (torch.randn(4, length, generator=gen, device=dev)
                         .to(dtype) for _ in range(3))
            for t in (x, ec, eu):
                t[0] = 0
                t[1] *= 1e-39
            q, s = emit_case(x, ec, eu)
            check(float(s[0, 0]) == 1.0 and not q[0].any()
                  and 0 < float(s[1, 0]) < torch.finfo(torch.float32).tiny,
                  f"emit at L = {length}: zero row scale {float(s[0, 0])}, "
                  f"subnormal row scale {float(s[1, 0])}")
    widths = {(d, v) for _, d, v in seen}
    check({r for r, _, _ in seen} == set(fops.EMIT_ROUTES)
          and widths == {("float32", 1), ("float32", 2), ("float32", 4),
                         ("bfloat16", 1), ("bfloat16", 2), ("bfloat16", 4),
                         ("bfloat16", 8)},
          f"the emit cases missed a route or a load width: {sorted(seen)}")
    torch.cuda.synchronize()
    print(f"emit equals its plain version: {emit_cases} cases; (route, "
          f"dtype, elements per load) taken: {json.dumps(sorted(seen))}")

    # the interior step: ddim (affine coefficients) and rf, g = 1 and 3.5,
    # eps_u its own tensor or eps_c itself (as the relay passes it)
    step_coeffs = {"ddim": fref.ddim_coeffs(0.4, 0.6), "rf": (RF_DT, 0.0)}
    step_cases = 0
    for shape in STEP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, ec, eu = (torch.randn(shape, generator=gen, device=dev)
                         .to(dtype) for _ in range(3))
            for mode, (c1, c2) in step_coeffs.items():
                for g in (1.0, GUIDANCE):
                    for e_u in (eu, ec):
                        kw = dict(guidance=g, c1=c1, c2=c2, mode=mode)
                        note("fused_cfg_step",
                             fops.fused_cfg_step(x, ec, e_u, **kw),
                             fref.fused_cfg_step_ref(x, ec, e_u, **kw))
                        step_cases += 1
    torch.cuda.synchronize()
    print(f"kernels equal their plain versions: {n_cases} boundary cases, "
          f"{len(shapes)} shapes x fp32/bf16; {step_cases} interior-step "
          f"cases over {json.dumps(STEP_SHAPES)}")

    # ---- 3. the main path ------------------------------------------------
    fams = load_families(CKPTS, device=dev)
    raw_arms = build_action_space()
    twins = [a for a in build_action_space(compress=True) if a.program.is_relay]
    ex_raw = Executor(fams, arms=raw_arms, device=dev)
    ex_fused = Executor(fams, arms=build_action_space(compress=True),
                        device=dev)
    ex_unfused = Executor(fams, arms=build_action_space(compress=True),
                          fused_boundary=False, device=dev)
    seeds = np.arange(8)

    def interior_steps(ex, arm):
        """Launches of the interior step in one run of the arm's program:
        every step of an rf (F3) program but a fused hop's emit and consume
        steps, none of a ddim (XL) one."""
        prog = arm.program
        if fams[prog.family].spec.kind != "rf":
            return 0
        fused_hops = (sum(h.compress for h in prog.handoffs)
                      if ex.fused_boundary else 0)
        return prog.total_steps - 2 * fused_hops

    step_launches, served_out = {}, {}

    def served(ex, arm):
        before = build.LAUNCHES["fused_cfg_step"]
        out = ex.generate_bucketed(arm, seeds)
        got = build.LAUNCHES["fused_cfg_step"] - before
        key = arm.label + ("" if ex.fused_boundary else "|unfused")
        step_launches[key] = got
        check(got == interior_steps(ex, arm),
              f"{key}: {got} interior-step launches, want "
              f"{interior_steps(ex, arm)}")
        check(out.shape == (8, 8, 8, 4) and np.isfinite(out).all(),
              f"{arm.label}: output shape {out.shape} or non-finite values")
        served_out[key] = out
        return out

    build.reset_launches()
    for arm in raw_arms:
        served(ex_raw, arm)
    for arm in twins:
        out_f, out_u = served(ex_fused, arm), served(ex_unfused, arm)
        check(np.array_equal(out_f, out_u),
              f"{arm.label}: fused vs unfused differ by "
              f"{float(np.abs(out_f - out_u).max())}")
    tables = [ex_raw.quality_table(seeds),
              ex_fused.quality_table(seeds, arms=twins)]
    launches = dict(build.LAUNCHES)
    print(f"main path launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in DIFFUSION_KERNELS),
          f"a kernel never launched on the diffusion path: {launches}")
    # one emit per compressed hop of each fused call: the served run and
    # the quality table's
    emits = 2 * sum(h.compress for a in twins for h in a.program.handoffs)
    check(launches["fused_cfg_step_quant"] == emits,
          f"{launches['fused_cfg_step_quant']} emits on the path, want {emits}")
    for table, arms in zip(tables, (raw_arms, twins)):
        for arm in arms:
            for m in table[:, arm.idx]:
                check(np.isfinite(list(m.values())).all(),
                      f"{arm.label}: non-finite quality {m}")
    print(f"interior-step launches per 8-request call: "
          f"{json.dumps(step_launches)}")
    print(f"fused vs unfused compressed arms: bit-identical on all "
          f"{len(twins)}")

    # straggler re-runs: a lone request (one row) and a pair (two rows)
    # against their rows of the 8-request run, bit for bit (the re-run
    # repeats the full call's bucket, rows and filler)
    lone = {}
    for ex, arm in ((ex_raw, raw_arms[3]), (ex_raw, raw_arms[8]),
                    (ex_fused, twins[2]), (ex_fused, twins[7])):
        full = ex.generate_bucketed(arm, seeds)
        lone[arm.label] = {}
        for what, subset in (("one_row", [5]), ("two_rows", [6, 2])):
            rerun = ex.generate_bucketed(arm, seeds, subset=subset)
            ref = full[subset]
            lone[arm.label][what] = float(np.abs(rerun - ref).max())
            check(np.array_equal(rerun, ref),
                  f"{arm.label}: {what} re-run differs from its rows by "
                  f"{lone[arm.label][what]}")
    print(f"straggler re-runs vs their rows of 8, max |diff|: "
          f"{json.dumps(lone)}")

    # ---- 4. card against CPU on the same host-drawn noise ------------------
    cpu_fams = load_families(CKPTS, device="cpu")
    worst = {}
    for compress in (False, True):
        space = build_action_space(compress=compress)
        ex_gpu = ex_fused if compress else ex_raw
        ex_cpu = Executor(cpu_fams, arms=space, device="cpu")
        for idx in (3, 8):  # s=15 relay of XL and of F3
            arm = space[idx]
            noise = ex_gpu.noise(arm, seeds[:2], per_sample=True)
            _, _, cond = synth.batch(seeds[:2], arm.family)
            a = ex_gpu.run(arm, noise, cond).cpu().numpy()
            b = ex_cpu.run(arm, noise, cond).numpy()
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            worst[arm.label] = rel
            check(rel <= (COMPRESSED_RTOL if compress else RAW_RTOL),
                  f"{arm.label}: card vs CPU rel {rel}")
    print(f"card vs CPU rel diff: {json.dumps(worst)}")
    guided_relay(dev, fams["F3"], cpu_fams["F3"],
                 ex_raw.noise(raw_arms[8], seeds[:2], per_sample=True),
                 synth.batch(seeds[:2], "F3")[2])

    # ---- 5. times --------------------------------------------------------
    arm_ms = {}
    for ex, arms in ((ex_raw, raw_arms), (ex_fused, twins)):
        for arm in arms:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.generate_bucketed(arm, seeds)
            torch.cuda.synchronize()
            arm_ms[arm.label] = (time.perf_counter() - t0) * 1e3 / len(seeds)
    print(f"ms per request (8-request bucket): {json.dumps(arm_ms)}")
    shares = {arm.label: busy(lambda: ex.generate_bucketed(arm, seeds),
                              arm_ms[arm.label] * len(seeds))
              for ex, arm in ((ex_raw, raw_arms[3]), (ex_raw, raw_arms[8]),
                              (ex_fused, twins[2]))}
    print(f"device busy share of one 8-request run (profiled device time "
          f"over the unprofiled wall time above): {json.dumps(shares)}")

    # the floor every launch pays: a kernel that does nothing, launched
    # by the same path as the four
    empty = timed(lambda: build.launch_empty(dev))
    print(f"empty kernel: {json.dumps(empty)}")

    def kernel_rows(rows, length):
        x, ec, eu = (torch.randn(rows, length, generator=gen, device=dev)
                     for _ in range(3))
        coeffs = torch.tensor([0.4, 0.6], device=dev)
        q, s = qops.quant_int8(x)
        calls = {
            "fused_cfg_step_quant": (
                lambda: fops.fused_cfg_step_quant(x, ec, ec, coeffs),
                lambda: fref.fused_cfg_step_quant_ref(x, ec, ec, coeffs,
                                                      guidance=1.0,
                                                      mode="ddim"),
                None),
            "fused_cfg_step_dequant": (
                lambda: fops.fused_cfg_step_dequant(q, s, ec, ec, coeffs),
                lambda: fref.fused_cfg_step_dequant_ref(q, s, ec, ec, coeffs,
                                                        guidance=1.0,
                                                        mode="ddim"),
                None),
            "quant_int8": (lambda: qops.quant_int8(x),
                           lambda: qref.quant_int8_ref(x), None),
            # one PyTorch call computes q*s in fp32: int8 x fp32 promotes
            "dequant_int8": (lambda: qops.dequant_int8(q, s),
                             lambda: qref.dequant_int8_ref(q, s),
                             lambda: torch.mul(q, s)),
        }
        out = {}
        for name, (kern, plain, lib) in calls.items():
            b_ms, b_by = rl.bound(rl.boundary_work(name, rows, length, 4,
                                                   1.0))
            k, p = timed(kern), timed(plain)
            # the least device time of one launch: the byte or operation
            # bound, or the empty kernel's time where that is larger
            floor_ms, floor_by = max((b_ms, b_by), (empty["ms"], "launch"))
            out[name] = {
                "ms": k["ms"], "plain_ms": p["ms"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed(lib)["ms"] if lib is not None else None,
                "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
                "floor_ms": floor_ms, "floor_by": floor_by,
            }
        return out

    main_times = kernel_rows(MAIN_ROWS, WIRE_LEN)
    hbm_times = kernel_rows(8192, 4096)
    print(f"kernel times at R=8192, L=4096 fp32 ddim g=1: "
          f"{json.dumps(hbm_times)}")
    step_rows = step_times(dev, gen, empty["ms"])
    emit_times(dev, gen, empty["ms"])

    # ---- 6, 7, 11. flash attention and the RG-LRU scan ---------------------
    max_err["flash_attention"] = check_flash(gen, dev)
    flash_rows = flash_times(dev, empty["ms"])
    max_err["rglru_scan"] = check_rglru(gen, dev)
    rglru_rows = rglru_times(dev, empty["ms"])

    # ---- 15. DAG relay execution: after the kernel timings, whose
    # profiled sessions lost records when it ran before them (profiled)
    dag_launches = dag_phase(dev, seeds, served_out, (
        (ex_raw, raw_arms, ""), (ex_fused, twins, ""),
        (ex_unfused, twins, "|unfused")))
    for name in DIFFUSION_KERNELS:
        launches[name] += dag_launches[name]

    # ---- 16. the scheduler, on phase 3's raw executor -------------------
    sched_launches, stream = scheduler_phase(dev, ex_raw)
    for name in DIFFUSION_KERNELS:
        launches[name] += sched_launches[name]

    # ---- 17. the sequential serving engine, on phase 16's table ----------
    engine_total = engine_phase(dev, stream)
    for name in DIFFUSION_KERNELS:
        launches[name] += engine_total[name]

    # ---- 18. the continuous-batching runtime, on phase 16's table -------
    runtime_total = runtime_phase(dev, stream, ex_raw)
    for name in DIFFUSION_KERNELS:
        launches[name] += runtime_total[name]

    # ---- 19. the fleet, on phase 16's table --------------------------------
    fleet_total = fleet_phase(dev, stream)
    for name in DIFFUSION_KERNELS:
        launches[name] += fleet_total[name]

    # ---- 20. diffusion training and the Table III baselines -------------
    train_total = train_phase(dev)
    for name in DIFFUSION_KERNELS:
        launches[name] += train_total[name]

    # ---- 21. LM training ---------------------------------------------------
    lm_train_total = lm_train_phase(dev)

    # ---- 22. MoE and MLA ---------------------------------------------------
    moe_total = moe_mla_phase(dev)

    # ---- 23. encoders and cross-attention --------------------------------
    ctx_total = ctx_phase(dev)

    # ---- 24. xLSTM ---------------------------------------------------------
    xlstm_phase(dev)

    # ---- 25. the distributed layer ----------------------------------------
    dist_total = dist_phase(dev)
    for name in ("quant_int8", "dequant_int8"):
        launches[name] += dist_total[name]

    # ---- 8-10. the qwen3-4b LM path ---------------------------------------
    from repro_torch import configs

    large, small, cfg_l, cfg_s, prompt, qwen_launches = lm_main_path(
        dev, "qwen3-4b", LM_LARGE_LAYERS, LM_SMALL_LAYERS)
    qwen_launches["flash_attention"] += traced_relay(
        large, small, cfg_l, cfg_s, prompt)
    lm_card_vs_cpu(dev, prompt, cfg_l.replace(n_layers=2))
    lm_bf16_card_vs_cpu(dev, prompt, cfg_l.replace(n_layers=LM_BF16_LAYERS),
                        LM_BF16_RTOL)
    lm_times(large, small, cfg_l, cfg_s, prompt)
    del large, small
    torch.cuda.empty_cache()

    # ---- 12-14. the recurrentgemma-9b LM path ----------------------------
    large, small, cfg_l, cfg_s, prompt, rg_launches = lm_main_path(
        dev, RG_NAME, RG_LARGE_LAYERS, RG_SMALL_LAYERS, seeds=(11, 12))
    rg_check = rg_check_config(configs.get_config(RG_NAME))
    lm_card_vs_cpu(dev, prompt, rg_check, seeds=(13, 14), s=8, total=16)
    lm_bf16_card_vs_cpu(dev, prompt, rg_check, RG_BF16_RTOL, seed=15,
                        n_new=16)
    lm_times(large, small, cfg_l, cfg_s, prompt)
    del large, small

    launches["flash_attention"] = (qwen_launches["flash_attention"]
                                   + rg_launches["flash_attention"]
                                   + lm_train_total["flash_attention"]
                                   + moe_total["flash_attention"]
                                   + ctx_total["flash_attention"]
                                   + dist_total["flash_attention"])
    launches["rglru_scan"] = (rg_launches["rglru_scan"]
                              + lm_train_total["rglru_scan"])
    # the rows of the shapes launched most on the LM paths: qwen3-4b's
    # decode, and the RG-LRU scan's scoring shape
    main_times["flash_attention"] = {
        k: v for k, v in flash_rows["decode"].items() if k != "shape"}
    main_times["rglru_scan"] = {
        k: v for k, v in rglru_rows["scoring"].items() if k != "shape"}
    main_times["fused_cfg_step"] = {
        k: v for k, v in step_rows["path"].items()
        if k not in ("shape", "dtype", "guidance")}

    print(f"phases 1-25: {time.perf_counter() - t_start:.1f} s after the "
          f"imports")
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": tpu,
        "launches": launches[name], "max_abs_err": max_err[name],
        **main_times[name],
    } for name, (src, tpu) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
