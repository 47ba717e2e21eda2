#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time;
2. prints each kernel's registers, shared memory and spills from ptxas
   (``kernel_resources``), then holds each kernel against its plain
   PyTorch version on the card, at the main path's shapes and at edge
   shapes (budget > cap, ragged tiling, empty masks, one detection,
   H*W = 1961, 720x1280 at stride 1, every mask empty; k past the
   included count, all-equal scores, k = 1024, N below one 32-row block,
   the cluster index's k = 1024 at the batched shape; the captioner's
   prefill attention, the reference's attention test shapes, a GQA case,
   and the edges of the bf16 kernel's 128-row tiles: S = 17, S = 1025,
   MQA, window 1, non-causal dh = 128 at S = 2048; nearest-neighbour
   distances at the reference's test shapes, a chamfer, a centroid sweep,
   no valid neighbour, N past one staged tile, a stretch of invalid b
   longer than a share, D = 8 and 5, M no multiple of a block's rows):
   ints exactly, floats within 1e-4 (lift_compact, nearest_dist), 1e-5
   (query_topk_bias scores) and rtol = atol = 2e-5 / 2e-2
   (flash_attention in f32 / bf16); requires one launch per
   lift_compact call and the same bits from two calls of lift_compact
   and nearest_dist; and times kernel, plain version and, where one
   PyTorch call computes the same function, that call (with TFLOP/s for
   flash_attention; nearest_dist at the centroid and the chamfer shape);
   then query_topk_bias past its old limits (``query_topk_bias_any_k``):
   k = 2000 at the SQ shape and at the 1M flat shape, k = N + 5, N * E >=
   2^31 (N = 1,048,576, E = 2048) and Q * N >= 2^31 (Q = 2048, N =
   1,048,576, E = 16, against the plain version over chunks of queries),
   on exact-grid values so ties are exact, each timed beside its bound;
3. drives the single-client loop at the paper's deployment size (Knobs()
   defaults, E = 512, 720x1280 keyframes, 40 keyframes of an 80-object
   scene): MappingServer.process_frame, CloudService.update_tick ->
   DeviceClient.ingest every second keyframe, then an SQ and an LQ per
   mapped class, with every kernel launch counter reset just before and
   read just after;
4. profiles the loop: the server, cloud and client of step 3 take more
   keyframes, each followed by an update tick, the device-side ingest, an
   SQ and an LQ; half of them timed by stage on the host clock, half
   under ``torch.profiler`` (device-busy share, host syncs, top kernels;
   one lift kernel on the card for each lift_compact call);
5. runs 16 batched full_mix-style queries over a 10,000-object store and
   requires the same top-k as the CPU port, with the launch counters reset
   just before and read just after;
6. replays the first 6 keyframes of step 3 on the CPU port and requires
   the same store;
7. serves the full-width ``semanticxr-captioner-110m`` (12 layers, d 768,
   12 / 4 heads, vocab 32000, bf16, seeded weights): 8 caption prompts of
   1024 tokens, ``api.prefill`` then 32 greedy ``api.decode`` steps, three
   times, with the launch counters reset just before and read just after
   (12 flash_attention launches per prefill, none per decode step), and
   reads the share of one prefill's device time that flash_attention
   takes from ``torch.profiler``;
8. replays step 7's weights in f32 at B = 1, S = 256 and 8 greedy steps on
   the card and on the CPU port: the same tokens, logits within 1e-4;
9. builds the query engine benchmark's store (1,000,000 clustered objects,
   E = 256) and its ClusterIndex, and runs the full_mix query two-stage:
   equal to the flat sweep (oids and slots exactly, scores within 1e-5) and
   to a numpy oracle (rtol 5e-5, atol 1e-5, modulo ties); query_topk_bias
   launched by stage 1 and by stage 2 (counters reset just before, read
   just after); two-stage and flat ms, the stage split, a
   ``torch.profiler`` window over 5 queries of each (``index_profile``),
   escalations, candidate fraction, peak memory; the kernel against its plain version
   and timed at the index path's shapes (stage 1 at m = 64 and at the
   largest m, stage 2, the 1M flat sweep); then a churn (20,000
   tombstones, 15,000 moves) after which the incremental summaries equal a
   rebuild bit for bit; and at 100,000 objects the same build and query on
   the card and on the CPU port (member tables and exact fields equal,
   float fields within rtol = atol = 1e-6, equal results);
10. serves 64 full_mix requests over step 9's store and index through
    BatchScheduler(batch_size=16) and make_query_step_fn, blocking and
    not: every result equal to the same request run alone; requests/s,
    step ms;
11. runs the four Fig. 3 mapping arms (B, B+P, B+P+SD instrumented, B+P+SD
    fused) at the mapping benchmark's configuration (E = 256, 30 objects,
    8 keyframes of 240x320) on the card and on the CPU port with the same
    host-drawn noise: equal stores (ints exactly, floats within 1e-4),
    top-1 class accuracy >= 0.9, one lift_compact launch per mapped
    keyframe in the SD arms and none in B / B+P; per-stage walls beside the
    reference's CPU-container gate figures (printed, not required);
12. the fleet tier (``fleet_phase``): (a) benchmarks/fleet_scale.py's full
    configuration, C from 1 to 4096 (tick ms p50 / p95, per-client bytes
    and objects, the caller's reused sync tensor untouched, a 4-part mesh
    tier byte-identical to the unsharded one at every C >= 4) and its
    default configuration, whose per-client bytes must be exactly 19748
    at C = 1, 8, 64 and 256; a fenced span around one collect; (b)
    FleetServer at Knobs() defaults, E = 512, over 3,000 objects: 8 clean
    and 8 faulty pose twins through 20 ticks of churn and a clean settle,
    each faulty twin's map equal to its clean twin's, every packet equal
    to the CPU port's tick by tick, one query_topk_bias launch per
    selected flat zone in FleetServer.query; (c) step 9's 1,000,000
    objects mirrored into a 2x2 ZoneShardedStore with a zone index each:
    full_mix equal to the flat sweep (global slots zone * capacity +
    slot), two launches per two-stage shard round, mirror and build s,
    p50 / p95 ms, and the card against the CPU port at 100,000;
13. the scenario engine (``sim_phase``): (a) the golden churn scenario
    (seed 23, 20 objects, 20 + 8 ticks, 3 clients) matches the committed
    ``tests/golden/scenario_churn_v1.json``, two card runs are ``equals``,
    the card run ``equals`` the CPU port's and ``async_loop=True`` the
    sequential tick; (b) scenario_suite's small, mid and large arms:
    sent_bytes_total 15150 and 111840, large ``equals`` the CPU port,
    engine tick ms p50 / p95; (c) fault_tolerance's loss sweep (0, 1, 5,
    20 %) and its crash arm at the benchmark's default shape: down_bytes
    25987, 26533, 27675, 40844 and 31898, every arm converged; (d) the
    network-drop session of ``examples/network_drop_session.py`` (E = 256,
    240x320 keyframes, the stream cut after tick 8) on the card and on the
    CPU port with the same host-drawn noise, ``equals``; one lift_compact
    launch per mapped keyframe and one query_topk_bias launch per SQ and
    LQ; (e) FleetSimulator at the paper's deployment (``Knobs()``, E =
    512, step 3's 40 keyframes at 720x1280, 16 clients on heterogeneous
    links, SQ through BatchScheduler): stats, tick ms, both kernels
    launched, and the card's MetricsLog ``equals`` the CPU port's over the
    first 8 ticks;
14. the serving loop (``serving_loop_phase``) at
    benchmarks/serving_loop.py's non-smoke configuration (C = 256, 120
    ticks, 4096 live objects in a 131,072-slot store, E = 128, P = 128,
    churn 96, budget 32, batches of 4, two a tick, 1 Hz base and 8 Hz
    burst): the sync arm, then the overlapped arm, every per-request result
    byte-identical and equal sent bytes and final stores; ticks/s, tick ms,
    wait / e2e ms and query_topk_bias launches; the overlapped arm again
    with ``enable_index`` (two-stage), equal to the flat results; and
    ``StageTimes.record`` and the index metrics in an installed registry
    after one mapped keyframe and one two-stage query;
15. the flash-attention gradient (``flash_bwd_checks``): at the
    captioner's training shape (B = 8, S = 256, H = 12, Kv = 4, dh = 64,
    causal, bf16 and f32) and at S = 200 and 129 (ragged tiles), window 32,
    softcap 30, non-causal, G = 1, dh = 128 and S = 1024, the forward
    kernel's lse against the plain version's and its output bits unchanged
    by asking for the lse, then ``flash_attention_bwd_cuda`` against
    ``flash_attention_bwd_plain`` on the same inputs (lse included) within
    ATTN_TOL, with the same bits from two calls; autograd through
    ``ops.flash_attention_bshd`` launches it once, saves the forward's lse
    and returns the kernel's bits; its time (the lse in hand, as SDPA's
    backward has its statistics) beside its bound, the plain version and
    SDPA's backward, and the device ms of its dq and dk/dv launches;
16. training (``train_phase``): (a) ``repro_torch.launch.train.main`` on
    the full-width bf16 captioner, B = 8, S = 256, 200 steps, counters
    reset just before and read just after (12 flash forward and 12
    backward launches every step; every loss finite, the mean of the last
    10 under half that of the first 10): step ms p50 / p95, tokens/s, peak
    bytes, the loss at steps 1, 50, 100, 200; (b) ``--kill-at 6`` of 12
    with checkpoints every 4 exits 42, the checkpoint restores bit-equal to
    the parameters saved, and the rerun resumes from step 4 and finishes;
    (c) ``--compress-grads`` for 4 steps; (d) 3 f32 train steps at B = 1,
    S = 256 on the card and on the CPU port from the same weights (loss,
    grad norm, masters within TRAIN_REPLAY_TOL); (e) a ``torch.profiler``
    window over 3 train steps; (f) the mini-CLIP towers at
    ``examples/train_perception.py``'s shape (batch 16, 300 steps, a
    60-object scene): losses, retrieval top-1 over 6 held-out batches, the
    card's first 10 losses = the CPU port's; no kernel launched.

17. DeepSeek-V3 (MLA + MoE): (a) ``mla_attention_checks``: the flash
    kernel at MLA's head widths (q / k 192, v 128) against its plain
    version at (B, S, H) = (1, 1, 1), (1, 129, 4), (2, 200, 4),
    (1, 1024, 16), (4, 1024, 128), causal, bf16 and f32, and a ragged
    non-causal S, within ATTN_TOL, the same bits twice; its time at the
    prefill shape beside its bound (bytes), the plain version's and
    SDPA's; (b) ``deepseek_serve_phase``: ``deepseek-v3-671b`` at full
    width cut to 4 layers (3 dense-prefix + 1 MoE, about 30 GB of bf16
    weights seeded on the card), 4 prompts of 1024 tokens prefilled
    twice, then 16 greedy steps, in naive and in absorbed decode: prefill
    and decode ms, tokens/s, peak bytes, the MoE's dropped share and
    prefill expert load, the modes' greedy agreement; 4 flash launches a
    prefill and none while decoding, every logit finite, the two
    prefills' logits the same bits; then a
    ``torch.profiler`` window over one prefill and 8 decode steps a mode
    (``deepseek_profile``); (c)
    ``deepseek_replay_phase``: the same family in f32 at d_model 1024, 16
    heads, the published MLA widths, 16 experts top-8, card vs CPU port
    in both modes: the same expert ids at every MoE call, logits within
    1e-4 of the largest, equal tokens.  ``deepseek_cuts`` prints the cuts.
18. DeepSeek-V3 training: (a) ``mla_bwd_checks``: the flash gradient
    kernel at (192, 128) against its plain version at (B, S, H) =
    (1, 1, 1), (1, 129, 4), (2, 200, 4), (1, 1024, 16) and the training
    shape (2, 512, 128), causal, bf16 and f32, and a ragged non-causal S,
    on the forward kernel's lse (itself held to the plain version's, the
    output bits unchanged by asking for it), within ATTN_TOL, the same
    bits twice, autograd = the direct call; its time at the training shape
    beside its bound (bytes), the plain version's and SDPA's backward, and
    its two launches' device ms; (b) ``deepseek_train_phase``:
    ``deepseek-v3-671b`` at full width cut to 1 dense-prefix and 1 MoE
    layer and 16 routed experts (top-8, 1 shared; 3.37 B parameters),
    bf16, under remat (the MoE layer's period recomputed in the backward
    pass, as the reference's config trains), 30 steps of
    ``launch.train.main`` at B x S = 2 x 512 through ``trainer_run``,
    counters reset just before and read just after (3 flash forward
    launches every step: the dense prefix's once, the MoE layer's twice;
    2 gradient launches; two MoE routes a step, the recomputed one's
    expert ids equal to the forward's; every loss finite, the mean of the
    last 5 under that of the first 5; the peak within its reckoning plus
    DEEPSEEK_PEAK_MARGIN): step ms p50 / p95, tokens/s, peak bytes, the
    MoE's dropped share and aux loss; two gradients of one batch with the
    same bits; a ``torch.profiler`` window over one
    step; (c) ``deepseek_train_replay``: 3 f32 train steps at step 17c's
    width, card vs CPU port, the same expert ids at every MoE call, loss,
    grad norm and masters within TRAIN_REPLAY_TOL; (d)
    ``deepseek_kill_resume``: that width in bf16, ``--kill-at 3`` of 6
    with checkpoints every 2 exits 42, restores bit-equal and resumes
    (``kill_resume``).
19. The dense grouped-query-attention configs: (a)
    ``dense_attention_checks``: the flash kernel at h2o-danube-3's head,
    (dh, dv) = (120, 120), against its plain version at h2o's prefill
    shape (2, 5000, 32, 8, window 4096), S = 17 and 129, window 1,
    softcap 50, MQA and a non-causal S = 200, and the (128, 128) instance
    at gemma2-27b's prefill shape (2, 5000, 32, 16, window 4096, softcap
    50: the window's lower tile bound past 0 over many tiles), bf16 and
    f32, within ATTN_TOL, the same bits twice; both prefill shapes timed
    (cold L2) beside their bounds (operations, the masks counted), the
    plain version's and SDPA's (``enable_gqa``, the window as a mask), and
    the (128, 128) instance at h2o's (B, S, H, Kv); (b)
    ``dense_serve_phase``: ``gemma2-27b`` at full width and depth (46
    layers, 54.45 GB of bf16 weights seeded on the card; the peak reckoned
    first, ``dense_cuts``), 2 prompts of 5000 tokens prefilled twice (past
    the 4096 window: the ring's roll shift is 904), then 32 greedy steps
    (the ring wraps from the first): prefill and decode ms, tokens/s, peak
    bytes at init and serving beside the reckoning, 46 flash launches a
    prefill and none decoding, every logit finite, a profiler window
    (``dense_profile``); (c) ``h2o-danube-3-4b`` at full width and depth,
    the same prompts and steps, with a bf16 cache (24 launches of the
    (120, 120) instance a prefill) and an int8 cache fed the bf16 arm's
    tokens, its logits within 5 % of the bf16 arm's largest at every step
    (``tests/test_arch_smoke.py``'s bound); (d) ``yi-9b`` and
    ``minitron-4b`` at full width and depth: 4 prompts of 1024 tokens and
    16 greedy steps, 48 and 32 launches a prefill; (e)
    ``dense_replay_phase``: gemma2 and h2o cut to d_model 1024, 8 / 4
    heads, 4 layers, window 256, vocab 4096, in f32, a 300-token prompt
    and 24 greedy steps (the ring wraps), card vs CPU port (equal tokens,
    logits within 1e-4 of the largest), and every decode step's logits
    against one prefill over the whole sequence so far on the card: the
    ring cache held to the window mask.

20. The dense GQA configs trained: (a) ``dense_bwd_checks``: the flash
    gradient kernel's (120, 120) instance at h2o-danube-3-4b's training
    shape (1, 5000, 32, 8, window 4096) and the 120-wide edges (S = 17 and
    129, window 1, window 64 with softcap 50, MQA, non-causal S = 200, S =
    333 with every option), the (128, 128) instance at gemma2-27b's SWA
    and GLOBAL shapes (1, 5000, 32, 16, softcap 50) and yi-9b's and
    minitron-4b's (4, 1024), bf16 and f32, on the forward kernel's lse
    (itself held to the plain version's first), bf16 within
    DENSE_BWD_BF16_TOL (scaled to each gradient row's RMS) and f32
    within ATTN_TOL, the same bits twice, autograd = the direct call; the
    limit must reject a gradient that drops the window's first key tile,
    one whose 120-wide heads read the next head's first 8 columns and one
    whose dq or dv is 10 % low on the later rows; h2o's and gemma2's
    windowed shapes timed beside their operations bound, the plain
    version as called and SDPA's backward (none under the softcap: its
    time without it beside), and the (128, 128) instance at h2o's shape;
    (b) ``dense_train_cuts``: each config's training peak reckoned at its
    B x S before its run
    (``dense_train_reckon``: 16 bytes a parameter, then AdamW's
    temporaries or the remat activations and the loss chunks' logits,
    whichever is larger) and its depth cut by whole periods while that
    passes DENSE_PEAK_LIMIT; (c) ``dense_train_phase``: 20 bf16 steps of
    ``launch.train.main`` per config through ``trainer_run``, h2o and
    gemma2 at 1 x 5000 (past the 4096 window), yi and minitron at 4 x
    1024: under remat 2 flash forward and 1 gradient launch a layer a
    step, every loss finite and falling, the peak within its reckoning,
    then one loss-and-gradient pass's own peak within the reckoning's
    backward term; step ms p50 / p95, tokens/s, peaks; on
    h2o two gradients of one batch with the same bits and a profiler
    window with device ms by kind; (d) ``dense_train_replay``: gemma2 and
    h2o at DENSE_REPLAY's width, 3 f32 train steps, card vs CPU port
    within TRAIN_REPLAY_TOL (the f32 gradient at (128, 128) with the
    softcap and at (120, 120)); (e) ``dense_kill_resume``: gemma2 at that
    width in bf16, ``--kill-at 3`` of 6, restored bit-equal, resumed.

21. phi-3-vision-4.2b, its 576 image tokens (seeded f32 patch embeddings,
    the CLIP frontend's output) through ``vis_proj`` in front of the text:
    (a) ``dense_attention_checks`` at PHI3_ATTN_CASES: the flash kernel's
    (96, 96) instance at the serving prefill (4, 1600, 32, 32), the
    training shape (1, 4096, 32, 32) and the 96-wide edges (S = 17 and
    129, window 1, window 64 with softcap 50, MQA, non-causal S = 200,
    S = 333 with every option), bf16 within DENSE_BF16_TOL and f32 within
    ATTN_TOL, the same bits twice; the limit rejects an output whose heads
    read the next head's first 32 columns and, at the windowed edges, one
    that drops the window's first key tile; both phi-3 shapes timed beside
    their operations bound, the plain version, SDPA and the (128, 128)
    instance; (b) ``dense_bwd_checks`` at the training shape and the same
    edges (``faulty_grads``' four faults rejected), autograd = direct, the
    training shape timed; (c) ``dense_serve_phase`` with 576 patch tokens:
    32 layers at full width (7.66 GB of bf16 weights seeded on the card),
    4 prompts of 576 + 1024 positions prefilled twice, then 32 greedy
    steps at positions 1600 + t, 32 flash launches a prefill and none
    decoding, the peak within ``dense_reckon``'s (the cache counts the
    image tokens), a profiler window; (d) ``dense_replay_phase`` on an f32
    cut (d_model 768, 8 heads of 96, 2 layers, 64 patch tokens and a
    200-token prompt): card = CPU port, decode = whole-sequence prefill;
    (e) ``phi3_train_phase`` at 1 x 4096 whole: 10 steps of
    ``launch.train.main`` (tokens only: ``vis_proj`` moves by weight decay
    alone, followed by ``LeafSpy``), then 20 steps of
    ``build_train_step`` on input_specs' ``train_4k`` cell at B = 1 (tokens
    [1, 3520], extra_embeds [1, 576, 3072] fresh each step from
    ``make_inputs``: ``vis_proj`` learns), 2 forward and 1 gradient launch
    a layer a step, losses falling, peaks within ``dense_train_reckon``'s,
    two gradients of one image batch bit-equal, a profiler window; (f)
    ``dense_train_replay`` of (d)'s cut with image batches (f32, card =
    CPU port) and ``dense_kill_resume`` of it in bf16 (``vis_proj`` in the
    checkpoint, restored bit-equal).

22. The recurrent families: (a) ``dense_attention_checks`` at
    JAMBA_ATTN_CASES: the flash kernel's (128, 128) instance at
    jamba-v0.1-52b's prefill (4, 2048, 32 heads, 8 kv, causal) and a
    ragged S = 2000, bf16 within DENSE_BF16_TOL and f32 within ATTN_TOL,
    the same bits twice, the prefill shape timed beside its operations
    bound, the plain version as called and SDPA (``enable_gqa``); (b)
    ``recurrent_serve_phase`` reckons each config's peak first
    (``recurrent_reckon``: weights at each leaf's dtype, the Mamba / RWKV
    / KV caches, the largest layer's prefill transients with the MoE's
    capacity buffers, init's f32 leaf) and cuts the depth by whole periods
    past DENSE_PEAK_LIMIT (``recurrent_cuts``): jamba keeps 2 of its 4
    periods (16 layers, every expert, full width), rwkv6-3b runs whole;
    (c) each served, weights seeded on the card: jamba 4 x 2048 prompts
    and rwkv6-3b 4 x 4096, prefilled twice into zeroed caches, then 32
    greedy steps: prefill ms and tokens/s, decode ms p50 / p95 and
    tokens/s, peaks at init and serving within their reckoning, cache
    bytes a sequence, jamba's MoE dropped share; one flash launch per
    attention layer a prefill (2 on jamba's cut) and none decoding, none
    at all on rwkv6-3b; every logit finite, the two prefills the same
    bits; a profiler window each (``recurrent_profile``: busy share, top
    kernels, aten ops a decode step; rwkv6-3b's prefill window over the
    prompts' first 512 tokens); (d) ``recurrent_replay_phase``: f32
    cuts at d_model 1024 (jamba: 16 heads of 128, 4 kv, 4 experts at
    capacity factor 2, where no copy drops; rwkv: heads of 64), the scan
    chunk 16, a ragged 45-token prompt and 8 greedy steps: card = CPU port
    (tokens, logits within 1e-4 of the largest, expert ids at every MoE
    call), and every decode step against a whole-sequence prefill on the
    card (the recurrent state's handoff from prefill to decode); (a')
    ``wkv6_checks``, before (b): the wkv6 kernel against ``wkv6_plain``
    at WKV6_CASES (rwkv6-3b.prefill_4k's 16 x 4096 x 40 heads from zeros,
    a ragged 29-step cached prefill, one step, a tile and one step),
    within WKV6_TOL, each beside the plain version in float64, the same
    bits twice, timed beside its byte bound and the plain version; (c)
    also holds rwkv6-3b to one wkv6 launch a layer a prefill and none
    decoding, and step 23 its training to none (the chunk loop under
    autograd).

23. The recurrent families trained: (a) ``recurrent_train_cuts``: each
    training peak reckoned before its run (``recurrent_train_reckon``: 16
    bytes a parameter, then AdamW's temporaries or the backward pass's
    transients, whichever is larger: the remat checkpoints, one period's
    recomputed activations with each Mamba scan chunk recomputed inside
    it, the gradients in flight through its largest layer, the loss
    chunks) and jamba-v0.1-52b at full width cut while it passes
    DENSE_PEAK_LIMIT, first by experts (down to its top-2), then by whole
    periods: one period with 2 of its 16 experts a MoE layer, registered
    as ``jamba-v0.1-52b-train-cut``; rwkv6-3b whole; (b)
    ``dense_attention_checks`` / ``dense_bwd_checks`` at jamba's training
    shape (1, 2048, 32 heads, 8 kv, causal, (128, 128)): the forward with
    its lse and the gradient, bf16 within DENSE_BF16_TOL /
    DENSE_BWD_BF16_TOL and f32 within ATTN_TOL, timed beside their bounds,
    the plain versions as called and SDPA (``enable_gqa``, causal) with
    its backward; (c) ``recurrent_train_phase``: 10 bf16 steps of
    ``launch.train.main`` each through ``trainer_run``, jamba's cut at 1 x
    2048 and rwkv6-3b at 1 x 4096 under remat: step ms p50 / p95,
    tokens/s, peaks within their reckoning, every loss finite and the last
    5 under the first 5, 2 flash forward and 1 gradient launch a step on
    jamba and none on rwkv6-3b, jamba's MoE routed twice a MoE layer a
    step (the recomputed ids the forward's), its dropped share and aux
    loss; the step's model FLOPs over its time against 989 TFLOP/s and
    ``roofline_terms``' bound (``train_roofline``, from
    ``repro_torch.launch.costs``), one loss-and-gradient pass's own peak
    (``backward_peak``) within the reckoning's backward term, and at 1 x
    128 on jamba, 1 x 64 on rwkv6-3b two gradients of one batch bit-equal
    and a profiler window over one train step; (d)
    ``recurrent_train_replay``: 3 f32 train steps of step 22d's cuts at 48
    tokens, card vs CPU port within TRAIN_REPLAY_TOL (rwkv6-3b within the
    larger of it and the CPU port's own spread between its default thread
    count and one thread, measured in the run: its per-head norm makes the
    cut's gradients depend on the summation order at 1e-3), jamba's
    expert ids equal at every MoE call,
    the recomputed ones included; (e) ``recurrent_kill_resume``: 22d's
    rwkv6-3b cut in bf16, ``--kill-at 3`` of 6, restored bit-equal (the
    slash-named leaves in the checkpoint), resumed.

24. whisper-small, the encoder-decoder, whole: (a)
    ``whisper_attention_checks``: both flash kernels with k / v of their
    own length T at WHISPER_ATTN_CASES (the encoder at S = T = 1500, the
    decoder's causal self-attention at 448, the cross-attention at S =
    448 and 1 against T = 1500, and the T != S edges: T < S, T = 1, T
    one past a 128- and a 64-key tile, GQA), bf16 and f32, against their
    plain versions, lse included, the same bits twice, autograd = the
    direct call at the cross-attention's training shape, and the three
    training shapes timed beside their bounds, the plain versions and
    SDPA (with its backward); (b) ``whisper_serve_phase``: 32 x 1500
    seeded f32 frames, prefill (encoder, cross k / v, BOS step) and 64
    greedy decode steps, twice: prefill ms, decode ms a step p50 / p95,
    tokens/s, 36 flash launches a prefill and 12 a step, the self cache
    given back unwritten by the prefill, the peak within
    ``whisper_serve_reckon``; (c) ``whisper_replay_phase``: the whole
    model in f32 at 1 x 1500, 8 greedy steps, card vs CPU port: tokens
    equal, logits within LOGIT_TOL; (d) ``whisper_train_phase``: 20 bf16
    steps of ``build_train_step`` at 16 x (1500 frames + 448 caption
    tokens) through ``trainer_run``, remat only where
    ``whisper_train_reckon`` passes DENSE_PEAK_LIMIT: step ms p50 / p95,
    frames + tokens a second, 36 flash forward and gradient launches a
    step, losses finite and falling, the peak within its reckoning, MFU
    and roofline bound from ``launch.costs``; (e)
    ``whisper_train_replay``: a 2 + 2 layer cut at full width in f32, 3
    steps at 1 x (1500 frames + 64 tokens), card vs CPU port within
    TRAIN_REPLAY_TOL.

25. The mesh, the sharding rules and the dry run: (a) ``mesh_phase``:
    ``make_production_mesh`` of 256 and of 512 devices must raise on this
    machine (the message printed), ``make_host_mesh()`` is 1 x 1 on
    cuda:0; (b) ``dryrun_phase``: ``launch.dryrun.main --all`` on the
    16 x 16 and the 2 x 16 x 16 planning meshes into a temporary
    directory, a line a cell (per-device argument, output and alias
    bytes, analytic FLOPs, the bound without collectives), every cell
    planned but the reference's long_500k skips; (c)
    ``whisper_mesh_phase``: whisper-small whole through
    ``launch.steps.build_step`` on the host mesh at each kind's SHAPES
    cell with the batch cut to one device's share of the 16 x 16 mesh's
    data axis (prefill 2 x 32768 frames, decode 8 x 32768 cache slots,
    train 16 x (4096 frames + 448 tokens) under remat), the sequence cut
    only where ``mesh_reckon`` passes DENSE_PEAK_LIMIT (each cut printed,
    ``whisper_mesh_cuts``): 3 prefill runs, 8 greedy decode steps after a
    prefill of ``enc_seq`` frames, 3 AdamW steps; each the same bits as the
    mesh-free ``model_api`` / ``build_train_step`` calls on the same
    inputs, the placed tensors' bytes equal to the arguments' per-device
    bytes, the peak within ``mesh_reckon``, 36 flash launches a prefill,
    12 a decode step, 72 forward and 36 gradient launches a train step,
    and the p50 step times beside the card's name and power limit.

``nearest_dist`` has no caller on any system path: its phase drives its
entry point, ``ops.nearest_dist``, at a chamfer and a centroid shape.

It imports nothing of JAX or of the JAX package, catches no failure, and
exits non-zero (printing no result) without a CUDA device or outside a
checkout of the repository.  ``phase_seconds`` gives each step's host
seconds.  The line before the last is the per-kernel JSON record; the last
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data-sheet peaks (at the 700 W limit): HBM3 bandwidth and
# the fp32 rate outside the tensor cores (lift_compact, query_topk_bias and
# nearest_dist compute in fp32 FMA), the dense bf16 tensor-core rate (the
# captioner's flash_attention).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

LIFT_TOL = 1e-4          # metres: back-projection + pose in another order
SCORE_TOL = 1e-5         # unit-vector dot products in another order
CROSS_FRAMES = 6         # keyframes replayed on the CPU port (step 6)
# flash_attention against its plain version (rtol = atol), the reference's
# own tolerances: f32 in another summation order; bf16 p and outputs round
# to 8 bits, so one rounding that lands the other way moves an output by a
# bf16 ulp
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# query_topk_bias past its old limits: (what, (Q, N, E, k), the plain
# version's query chunk or None, timed reps)
TOPK_ANY_K = (("k=2000 at the SQ shape", (1, 4096, 512, 2000), None, 10),
              ("k=2000 at the 1M flat shape", (1, 1_000_000, 256, 2000),
               None, 3),
              ("k=N+5", (2, 3000, 64, 3005), None, 10),
              ("N*E >= 2^31", (2, 1 << 20, 2048, 10), None, 3),
              ("Q*N >= 2^31", (2048, 1 << 20, 16, 10), 128, 3))
ND_TOL = 1e-4            # nearest_dist: |a|^2 + |b|^2 - 2ab in another order
# wkv6 against wkv6_plain, relative to the largest |entry| of y or of the
# end state: the two sum in different orders.  The kernel steps the
# recurrence, a rounding in every state entry every step; the plain version
# carries the state across chunks only and forms each chunk's decays as
# exp of differences of cumulative log-decays.  At rwkv6-3b's prefill
# shape on an H100 the kernel lies 2.3e-6 (y) and 2.8e-6 (state) from the
# plain version in float64, the plain version 5.4e-7 and 2.5e-7: the limit
# leaves seven times the kernel's reading
WKV6_TOL = 2e-5
# (B, S, h, nonzero state0): rwkv6-3b.prefill_4k's shape from zeros (the
# timed case), a ragged cached prefill, one step, a tile and one step
WKV6_CASES = ((16, 4096, 40, False), (16, 29, 40, True), (2, 1, 3, True),
              (3, 17, 5, True))
LOGIT_TOL = 1e-4         # step 8: f32 logits, 12 layers in another order
PROFILE_KEYFRAMES = 4    # keyframes timed by stage, then as many profiled
PROFILE_DECODE = 8       # decode steps under the profiler (step 7)
PROFILE_QUERIES = 5      # full_mix queries under the profiler (step 9)
# ops whose CPU side waits for the card: each is a host sync in the loop
SYNC_OPS = ("aten::item", "aten::_local_scalar_dense", "aten::nonzero",
            "cudaStreamSynchronize", "cudaDeviceSynchronize",
            "aten::masked_select")

# the paper's deployment: Knobs() defaults (Tab. 2), MobileCLIP's width,
# 720p keyframes every 5th frame, and the 10,000-object query claim
DEPLOYMENT = dict(embed_dim=512, h=720, w=1280, n_frames=200,
                  keyframe_interval=5, n_objects=80)
QUERY_STORE = dict(n=10_000, capacity=10_240, embed_dim=512, max_points=16)
# the captioner's serving shape (step 7) and the f32 replay (step 8)
SERVE = dict(batch=8, prompt=1024, new_tokens=32, reps=3)
REPLAY = dict(batch=1, prompt=256, new_tokens=8)
# nearest_dist: a detection's cloud against a map object's, both at
# Knobs().max_object_points_server; every kept point of a keyframe's 32
# detections against the 4096-slot store's centroids
ND_PATH_SHAPES = ((2000, 2000, 3), (64000, 4096, 3))
# step 9: the query engine's configuration (benchmarks/query_engine.py): a
# clustered store of 1,000,000 objects at E = 256, its hotspot count, and
# the full_mix spec; a churn of 20,000 tombstones and 15,000 moves; the
# card against the CPU port at 100,000 objects
INDEX = dict(n=1_000_000, embed_dim=256, max_points=16, room=80.0, reps=20,
             tombstones=20_000, moves=15_000, cross_n=100_000)
FULL_MIX = dict(radius=4.0, prox_weight=0.2, labels=tuple(range(10)),
                min_points=4, min_obs=1, zones=(0, 1, 2, 3),
                grid=(-40.0, -40.0, 40.0, 2, 2), k=10)
SUMM_TOL = 1e-6          # cluster summaries' float fields, card vs CPU:
#                          rtol = atol (centroids reach 40 m, where one
#                          f32 ulp is 3.8e-6)
ORACLE_TOL = dict(rtol=5e-5, atol=1e-5)   # the benchmark's _oracle_parity
# step 10: 64 full_mix requests in scheduler batches of 16
SERVING = dict(requests=64, batch_size=16)
# step 11: benchmarks/mapping_latency.py's four arms at default_knobs()
# (benchmarks/common.py), B and B+P with uncapped geometry, and the
# reference's CPU-container gate figures (BENCH_gate.md, printed beside)
ARMS = dict(embed_dim=256, n_objects=30, n_frames=40, keyframe_interval=5,
            h=240, w=320)
ARM_MODES = (("B", "baseline", False), ("B+P", "parallel", False),
             ("B+P+SD", "semanticxr", True),
             ("B+P+SD (fused)", "semanticxr", False))
ARM_KNOBS = dict(server_capacity=256, client_capacity=128,
                 max_object_points_server=512, max_object_points_client=128,
                 max_detections_per_frame=16, min_obs_before_sync=1)
REFERENCE_GATE = {"n_mapped": 31, "mAcc": 100.0}
# step 12: benchmarks/fleet_scale.py's full configuration (:128-130) and
# its default one (:131-133), whose per-client bytes at C = 1, 8, 64 and 256
# are the reference's exact counter (BENCH_fleet_scale.json)
FLEET_SWEEP = (1, 8, 64, 256, 512, 1024, 2048, 4096)
FLEET_FULL = dict(sweep=FLEET_SWEEP, n_obj=256, cap=512, E=256, P=512,
                  budget=32, reps=10, shards=4)
FLEET_DEFAULT = dict(sweep=(1, 8, 64, 256), n_obj=128, cap=256, E=128, P=256,
                     budget=32, reps=3, shards=4)
FLEET_BYTES = 19748
# FleetServer at the paper's deployment: Knobs() defaults, E = 512, a 2x2
# grid over an 8 m room and 3,000 objects, 60 % of them transient (below
# min_obs_before_sync), so each client's one subscribed zone holds fewer
# objects than its 512 local-map slots; 8 clean / faulty pose twins
TWINS = dict(n_objects=3000, embed_dim=512, pairs=8, ticks=20, settle=16,
             transient=0.6, churn=6, radius=1.0,
             faults=dict(loss_prob=0.1, dup_prob=0.05, reorder_prob=0.1,
                         corrupt_prob=0.05))
# step 13: the scenario engine.  The golden churn scenario
# (tests/golden/regen.py) and its committed snapshot; scenario_suite's arms
# (benchmarks/scenario_suite.py:95-100, the large one at its _BIG knobs)
# with the reference's sent_bytes_total (BENCH_scenario_suite.json, None:
# the large arm is held to the CPU port instead); fault_tolerance's default
# shape and arms (benchmarks/fault_tolerance.py:74-91) with their
# down_bytes (BENCH_fault_tolerance.json): (loss, crash, down_bytes)
GOLDEN = dict(seed=23, n_objects=20, n_ticks=20, n_clients=3,
              remove_frac=0.25, drain_ticks=8)
GOLDEN_SNAPSHOT = ROOT / "tests" / "golden" / "scenario_churn_v1.json"
SUITE_KNOBS = dict(server_capacity=256, client_capacity=128,
                   max_object_points_server=64, max_object_points_client=16,
                   min_obs_before_sync=1)
SUITE = (("small", GOLDEN, 15150),
         ("mid", dict(seed=23, n_objects=60, n_ticks=40, n_clients=8,
                      remove_frac=0.3, drain_ticks=8), 111840),
         ("large", dict(seed=23, n_objects=100, n_ticks=60, n_clients=16,
                        remove_frac=0.3, drain_ticks=10), None))
FAULT_SHAPE = dict(seed=29, n_objects=24, n_ticks=24, n_clients=4,
                   drain_ticks=12, outage_frac=0.0, query_prob=0.0)
FAULT_ARMS = ((0.0, False, 25987), (0.01, False, 26533),
              (0.05, False, 27675), (0.2, False, 40844), (0.05, True, 31898))
# examples/network_drop_session.py:36-62: E = 256, 240x320 keyframes, the
# stream cut after tick 8, an outage over ticks 4-8, two removals at tick 9
NETWORK_DROP = dict(n_objects=25, scene_seed=2, embed_dim=256, h=240,
                    w=320, n_frames=60, keyframe_interval=5, stream_ticks=9,
                    knobs=dict(server_capacity=256, client_capacity=64,
                               max_object_points_server=512,
                               max_object_points_client=128,
                               max_detections_per_frame=16,
                               min_obs_before_sync=1))
# FleetSimulator at the paper's deployment over step 3's keyframes: 16
# clients, one tick per keyframe, the card held to the CPU port over the
# first 8 ticks
FLEET_SIM = dict(n_clients=16, seed=3, cross_ticks=8)
# step 14: benchmarks/serving_loop.py's non-smoke configuration (:151-153)
SERVING_LOOP = dict(C=256, ticks=120, n_live=4096, cap=131072, E=128, P=128,
                    nz=1, zcap=6144, churn=96, budget=32, batch=4,
                    max_batches=2, base_hz=1.0, burst_hz=8.0,
                    warm_ticks=6, trace_ticks=40, index_min_flat=1024,
                    hold_every=25)
# step 15 holds flash_attention_bwd to its plain version with ATTN_TOL.
# step 16: the reference trainer's own example (launch/train.py docstring),
# kill / resume, compression, the f32 replay, a profiler window, and
# examples/train_perception.py's mini-CLIP run
TRAIN = dict(arch="semanticxr-captioner-110m", steps=200, batch=8, seq=256,
             kill=dict(steps=12, ckpt_every=4, kill_at=6), compress=4,
             replay=dict(batch=1, seq=256, steps=3), profile_steps=3,
             clip=dict(batch=16, steps=300, n_objects=60, scene_seed=5,
                       eval_batches=6, cross_steps=10))
# card vs CPU port, relative: f32 products in another order through 12
# layers and their gradients; the masters as an L2 norm over every leaf
TRAIN_REPLAY_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "master": 1e-4}
CLIP_CROSS_TOL = 1e-4    # mini-CLIP loss, card vs CPU, first 10 steps
# step 17: DeepSeek-V3 (MLA + MoE).  (a) the flash kernel at MLA's head
# widths, q / k 192 and v 128, at these (B, S, H) (H = Kv: MLA has no GQA),
# the last MLA's prefill; (b) the full-width model cut in depth from 61 to
# 4 layers (its 3 dense-prefix layers and 1 MoE layer), serving B prompts
# then greedy steps in both decode modes; (c) an f32 replay, card vs CPU
# port, at the published MLA widths and ranks and narrower elsewhere, so
# the (192, 128) pair still runs.
MLA_HEADS = (192, 128)
MLA_ATTN_SHAPES = ((1, 1, 1), (1, 129, 4), (2, 200, 4), (1, 1024, 16),
                   (4, 1024, 128))
DEEPSEEK = dict(arch="deepseek-v3-671b", n_layers=4, batch=4, prompt=1024,
                new_tokens=16)
DEEPSEEK_REPLAY = dict(arch="deepseek-v3-671b", n_layers=4, d_model=1024,
                       n_heads=16, d_ff_dense_prefix=2048, vocab_size=4096,
                       n_experts=16, top_k=8, d_ff_expert=256, batch=1,
                       prompt=256, new_tokens=8)
DEEPSEEK_REPLAY_TOL = 1e-4   # f32 logits: max |card - CPU| / max |logit|
# step 18: DeepSeek-V3 training.  (a) the flash gradient kernel at (192,
# 128) against its plain version at MLA_ATTN_SHAPES' small shapes and the
# training shape; (b) ``deepseek-v3-671b`` at full width, cut to what one
# card trains (one dense-prefix and one MoE layer, 16 routed experts of
# top-8), 30 steps of ``launch.train.main`` at B x S = 2 x 512; (c)
# DEEPSEEK_REPLAY's width in f32, 3 train steps, card vs CPU port; (d)
# kill / resume at (c)'s width in bf16 (full-width checkpoints would be
# about 47 GB).
MLA_TRAIN_SHAPE = (2, 512, 128)
MLA_BWD_SHAPES = MLA_ATTN_SHAPES[:-1] + (MLA_TRAIN_SHAPE,)
DEEPSEEK_TRAIN = dict(arch="deepseek-v3-671b", name="deepseek-v3-671b-train-cut",
                      n_layers=2, n_dense_prefix=1, n_experts=16, steps=30,
                      batch=2, seq=512)
# the cut's training peak, less what was allocated before, within its
# reckoning (16 bytes a parameter and AdamW's three f32 temporaries of the
# largest leaf) plus this margin: the small leaves' and the loss's
# transients, which the reckoning leaves out (the peak passed it by
# 0.01-0.06 GB under remat on an H100)
DEEPSEEK_PEAK_MARGIN = 0.5e9
DEEPSEEK_TRAIN_REPLAY = dict(batch=1, seq=256, steps=3)
DEEPSEEK_KILL = dict(steps=6, ckpt_every=2, kill_at=3, batch=1, seq=128)
# step 19: the dense GQA configs.  (a) the flash kernel's (120, 120)
# instance (h2o-danube-3's head) and (128, 128) at every prefill shape of
# the four configs: (B, S, H, Kv, dh, causal, window, softcap), each in
# bf16 and f32; DENSE_TIMED are timed.  (b)-(d) the four configs at full
# width and depth, serving; a reckoned peak past DENSE_PEAK_LIMIT cuts
# gemma2's depth (by periods: the SWA / GLOBAL alternation stays).  (e)
# f32 cuts of gemma2 and h2o, card vs CPU port and decode vs whole-sequence
# prefill.
DENSE_ATTN_CASES = ((2, 5000, 32, 8, 120, True, 4096, 0.0),     # h2o
                    (1, 17, 4, 2, 120, True, 0, 0.0),
                    (1, 129, 4, 2, 120, True, 0, 0.0),
                    (1, 300, 4, 4, 120, True, 1, 0.0),
                    (1, 200, 4, 2, 120, True, 64, 50.0),
                    (2, 1024, 8, 1, 120, True, 0, 0.0),
                    (2, 200, 4, 2, 120, False, 0, 0.0),
                    (2, 5000, 32, 16, 128, True, 4096, 50.0),   # gemma2 SWA
                    (2, 5000, 32, 16, 128, True, 0, 50.0),      # gemma2 GLOBAL
                    (4, 1024, 32, 4, 128, True, 0, 0.0),        # yi-9b
                    (4, 1024, 24, 8, 128, True, 0, 0.0))        # minitron-4b
DENSE_TIMED = (0, 7)
# step 19a's bf16 limit, (atol, rtol): |got - want| <= 8e-3 + 2^-7 |want|.
# 2^-7 |want| is one bf16 ulp of the output (its last rounding); 8e-3 is
# about twice the largest error the kernel showed at S = 5000 (0.0039, p
# rounded to bf16 before P . V in another tile order).  ATTN_TOL's bf16
# limit is about as large as a typical output there (~0.03 for randn
# inputs over 4096 keys), so a kernel that dropped the window's first key
# tile could pass it; at each windowed shape the script builds that
# kernel's output and checks that this limit rejects it.
DENSE_BF16_TOL = (8e-3, 2 ** -7)
DENSE_PEAK_LIMIT = 70e9
DENSE_SERVE = (("gemma2-27b", dict(batch=2, prompt=5000, new_tokens=32,
                                   profile=True)),
               ("h2o-danube-3-4b", dict(batch=2, prompt=5000, new_tokens=32,
                                        int8_arm=True)),
               ("yi-9b", dict(batch=4, prompt=1024, new_tokens=16)),
               ("minitron-4b", dict(batch=4, prompt=1024, new_tokens=16)))
INT8_BOUND = 0.05        # max |int8 - bf16| / max |bf16| (the reference's)
DENSE_REPLAY = dict(d_model=1024, n_heads=8, n_kv_heads=4, d_ff=2048,
                    n_layers=4, sliding_window=256, vocab_size=4096,
                    batch=1, prompt=300, new_tokens=24)
DENSE_REPLAY_TOL = 1e-4  # f32 logits: max |diff| / max |logit|
# step 20: the dense GQA configs trained.  (a) the flash gradient kernel at
# every shape the training path gives it, (B, S, H, Kv, dh, causal, window,
# softcap), bf16 and f32: h2o's (120, 120), gemma2's SWA and GLOBAL, yi's
# and minitron's (128, 128), and the 120-wide edges (S = 17 and 129,
# window 1, window 64 with softcap 50, MQA, non-causal S = 200, S = 333
# with every option); DENSE_BWD_TIMED are timed in bf16.  (b)-(c) each
# config at full width through launch.train.main, cut in depth only where
# its reckoned peak passes DENSE_PEAK_LIMIT; (d) an f32 replay at
# DENSE_REPLAY's width, card vs CPU port; (e) kill and resume at that width
# in bf16.
DENSE_BWD_CASES = ((1, 5000, 32, 8, 120, True, 4096, 0.0),      # h2o
                   (1, 5000, 32, 16, 128, True, 4096, 50.0),    # gemma2 SWA
                   (1, 5000, 32, 16, 128, True, 0, 50.0),       # GLOBAL
                   (4, 1024, 32, 4, 128, True, 0, 0.0),         # yi-9b
                   (4, 1024, 24, 8, 128, True, 0, 0.0),         # minitron
                   (1, 17, 4, 2, 120, True, 0, 0.0),
                   (1, 129, 4, 2, 120, True, 0, 0.0),
                   (1, 300, 4, 4, 120, True, 1, 0.0),
                   (1, 200, 4, 2, 120, True, 64, 50.0),
                   (2, 1024, 8, 1, 120, True, 0, 0.0),
                   (2, 200, 4, 2, 120, False, 0, 0.0),
                   (2, 333, 12, 4, 120, True, 100, 30.0))
DENSE_BWD_TIMED = (0, 1)
# step 20a's bf16 limit, (a, r, floor): |got - want| <= a * max(rms, floor)
# + r |want| for each gradient entry, ``rms`` the root mean square of its
# own row of want (one query's dq, one key's dk or dv, over the head's
# columns).  A row's size follows its partners: a key attended by few
# queries, or a query with few keys, has entries of 3-10, one with 4096
# partners about 0.01-0.03, and an array's largest entry or even its RMS
# sits far above the long rows.  r = 2^-7 is one bf16 ulp of an entry
# (its last rounding); a = 0.02 is about twice the kernel's largest
# (|got - want| - r |want|) / max(rms, floor) at these shapes, 0.0092 (dq
# at yi-9b's, an H100 before this limit was set; ``a_needed`` in each
# row); the floor, a thousandth of the inputs' unit scale, holds at
# window 1, where dq and dk cancel to f32 rounding residue (ds = dP - D =
# 0) in both versions.  At the windowed shapes a kernel that drops the
# window's first key tile, at the 120-wide ones a kernel whose heads also
# read the next head's first 8 columns, and at every shape one whose dq or
# dv is 10 % low past position min(4096, S / 2), must each fail it.
DENSE_BWD_BF16_TOL = (2e-2, 2 ** -7, 1e-3)
DENSE_TRAIN = (("h2o-danube-3-4b", dict(batch=1, seq=5000, profile=True)),
               ("gemma2-27b", dict(batch=1, seq=5000)),
               ("yi-9b", dict(batch=4, seq=1024)),
               ("minitron-4b", dict(batch=4, seq=1024)))
DENSE_TRAIN_STEPS = 20
DENSE_TRAIN_REPLAY = dict(batch=1, seq=300, steps=3)
DENSE_KILL = dict(steps=6, ckpt_every=2, kill_at=3, batch=1, seq=300)
# step 21: phi-3-vision-4.2b, its 576 CLIP patch tokens (seeded f32
# embeddings) through vis_proj in front of the text.  (a) the flash
# kernel's (96, 96) instance at the serving prefill (576 + 1024 = 1600
# positions, no multiple of 128), the training shape and the 96-wide edges
# (B, S, H, Kv, dh, causal, window, softcap), bf16 and f32; PHI3_TIMED are
# timed.  (b) the gradient kernel at the training shape and the same
# edges.  (c) the model at full width and depth serving 4 x (576 + 1024)
# prompts and 32 greedy steps; (d) an f32 cut (d_model 768, 8 heads of 96,
# 2 layers, 64 patch tokens before a 200-token prompt), card vs CPU port
# and decode vs whole-sequence prefill; (e) training at full width and
# depth, B x S = 1 x 4096: the trainer (tokens only), then
# build_train_step on input_specs' train_4k cell (tokens [1, 3520] and
# extra_embeds [1, 576, 3072]); (f) an f32 train replay of (d)'s cut with
# image batches, and kill / resume of that cut in bf16.
PHI3 = "phi-3-vision-4.2b"
PHI3_ATTN_CASES = ((4, 1600, 32, 32, 96, True, 0, 0.0),     # serving prefill
                   (1, 4096, 32, 32, 96, True, 0, 0.0),     # training
                   (1, 17, 4, 2, 96, True, 0, 0.0),
                   (1, 129, 4, 2, 96, True, 0, 0.0),
                   (1, 300, 4, 4, 96, True, 1, 0.0),
                   (1, 200, 4, 2, 96, True, 64, 50.0),
                   (2, 1024, 8, 1, 96, True, 0, 0.0),
                   (2, 200, 4, 2, 96, False, 0, 0.0),
                   (2, 333, 12, 4, 96, True, 100, 30.0))
PHI3_TIMED = (0, 1)
PHI3_BWD_CASES = PHI3_ATTN_CASES[1:]
PHI3_BWD_TIMED = (0,)
PHI3_SERVE = dict(batch=4, prompt=1024, n_vis=576, new_tokens=32,
                  profile=True)
PHI3_REPLAY = dict(d_model=768, n_heads=8, n_kv_heads=8, d_ff=2048,
                   n_layers=2, sliding_window=4096, vocab_size=4096)
PHI3_REPLAY_RUN = dict(PHI3_REPLAY, batch=1, prompt=200, new_tokens=8,
                       n_vis=64, names=(PHI3,), tag="phi3_replay_phase")
PHI3_TRAIN = dict(batch=1, seq=4096, trainer_steps=10, step_steps=20)
PHI3_TRAIN_REPLAY = dict(batch=1, seq=200, steps=3, n_vis=64, names=(PHI3,),
                         replay=PHI3_REPLAY, tag="phi3_train_replay")
PHI3_KILL = dict(steps=6, ckpt_every=2, kill_at=3, batch=1, seq=300,
                 name=PHI3, replay=PHI3_REPLAY, tag="phi3_train_kill_resume")
# vis_proj's master after tokens-only steps against first * prod(1 - lr_t *
# wd), relative to its largest entry: each step rounds mp - lr * wd * mp in
# f32 (about 1.2e-7 relative), ten steps about 1e-6
PHI3_DECAY_TOL = 1e-5
# with image batches it must move past its decay by 100 times that
PHI3_LEARN_MIN = 1e-3


# step 22: the recurrent families.  (a) the flash kernel's (128, 128)
# instance at jamba-v0.1-52b's prefill (4, 2048, 32 heads, 8 kv, causal)
# and a ragged S = 2000, bf16 and f32; JAMBA_TIMED are timed.  (b)-(c)
# jamba at full width, cut by whole periods to its reckoned peak, and
# rwkv6-3b whole, serving; (d) f32 cuts at d_model 1024, the scan chunk
# 16, card vs CPU port and decode vs whole-sequence prefill on a ragged
# 45-token prompt.
JAMBA = "jamba-v0.1-52b"
RWKV6 = "rwkv6-3b"
JAMBA_ATTN_CASES = ((4, 2048, 32, 8, 128, True, 0, 0.0),
                    (4, 2000, 32, 8, 128, True, 0, 0.0))
JAMBA_TIMED = (0,)
# rwkv6-3b's profiler window prefills the prompts' first 512 tokens: the
# window's events grow with the chunks it scans (163 aten ops a chunk and
# layer), and the whole 4096 took 62.8 s to process on an H100's host
# (jamba's window at 512 saved 1 s of its 30.8: its decode steps dominate)
RECURRENT_SERVE = ((JAMBA, dict(batch=4, prompt=2048, new_tokens=32)),
                   (RWKV6, dict(batch=4, prompt=4096, new_tokens=32,
                                profile_prompt=512)))
RECURRENT_REPLAY = {
    JAMBA: dict(d_model=1024, n_heads=16, n_kv_heads=4, d_head=128,
                d_ff=2048, n_layers=8, vocab_size=4096, chunk=16,
                moe=dict(n_experts=4, d_ff_expert=2048,
                         capacity_factor=2.0)),
    RWKV6: dict(d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
                d_ff=3584, n_layers=4, vocab_size=4096, chunk=16)}
RECURRENT_REPLAY_RUN = dict(batch=2, prompt=45, new_tokens=8)
# the init reckoning counts every byte of the weights and of the largest
# leaf's f32 draw; rwkv6-3b draws that leaf (lm_head) last, so its peak
# meets the count exactly when step 22 runs alone and passed it by 2.25
# MiB of the allocator's own after steps 1-21 (an H100, before this slack
# was set): the slack, far under a leaf's f32 copy (671 MB), covers that
INIT_SLACK = 16 << 20
# step 23: the recurrent families trained.  (a) each training peak reckoned
# before its run (``recurrent_train_reckon``): jamba-v0.1-52b at full width
# cut by experts (to its top-k) and then by whole periods while the
# reckoning passes DENSE_PEAK_LIMIT, rwkv6-3b whole; (b) the flash forward
# and gradient kernels at jamba's training shape; (c) each config through
# the trainer, jamba at 1 x 2048 and rwkv6-3b at 1 x 4096, host-bound at
# 4.1 and 10.7 s a step on an H100 (427,039 aten ops a step on jamba's
# cut), so 10 steps each and the profiler windows at 1 x 128 and 1 x 64
# (four chunks of jamba's scan, one of rwkv's): a window's events grow with
# the chunks, and jamba's at 1 x 2048 took 108.6 s to process;
# (d) 3 f32 train steps of step 22d's cuts at a multiple of their chunk,
# card vs CPU port; (e) kill / resume of 22d's rwkv6-3b cut in bf16.
JAMBA_TRAIN_CUT = JAMBA + "-train-cut"
JAMBA_TRAIN_ATTN_CASES = ((1, 2048, 32, 8, 128, True, 0, 0.0),)
RECURRENT_TRAIN = ((JAMBA, dict(batch=1, seq=2048, steps=10, short_seq=128)),
                   (RWKV6, dict(batch=1, seq=4096, steps=10, short_seq=64)))
RECURRENT_TRAIN_REPLAY = dict(batch=1, seq=48, steps=3)
# rwkv6-3b's replay cut: its time mix's per-head RMS norm lifts a small
# row's rounding (the first tokens', whose state is still empty) into layer
# 0's wk / wr / bonus_u gradients, up to 1.7e-3 of their norm from the
# summation order alone, and Adam's normalised steps carry that on: the
# card's grad norm after 3 steps came 1.13e-3 from the CPU port's, and the
# CPU port's own, on the 8-core host of an H100 machine, came 1.9e-4,
# 8.7e-3 and 1.0e-3 from its 8-thread run at 1, 2 and 4 threads (step 1's
# grad norm, before any Adam step, agrees to 1.3e-6).  So its CPU run is
# made again on each of these thread counts, and the card is held to the
# larger of TRAIN_REPLAY_TOL and the largest gap among them.  jamba's cut meets TRAIN_REPLAY_TOL by two
# orders (4.9e-7 in grad norm), and its CPU run takes 8 s on eight threads:
# it runs once.
REPLAY_SPREAD_THREADS = (1, 2, 4)
RECURRENT_KILL = dict(steps=6, ckpt_every=2, kill_at=3, batch=1, seq=64)
# step 24: whisper-small, the encoder-decoder, served and trained whole.
# (a) both flash kernels with k / v of another length T than q (the
# decoder's cross-attention) and at the encoder's S = T = 1500 (no
# multiple of either kernel's tile), dh 64: (B, S, T, H, Kv, causal,
# dtypes, timed).  The encoder, the decoder's causal self-attention and the
# cross-attention at the training batch (16: bf16, timed beside their
# bounds, the plain versions as called and SDPA, with their gradients), the
# cross-attention of a decode step at the serving batch (32 x 1 query), f32
# at small batches, and the T != S edges: T < S, T = 1, T one past the
# forward's 128-key tile and the gradient's 64-key tile, GQA.  (b) serving
# at 32 x 1500 seeded f32 frames, prefill and 64 greedy steps, twice; (c)
# the whole model in f32 at 1 x 1500, 8 greedy steps, card vs CPU port;
# (d) 20 bf16 steps of build_train_step at 16 x (1500 frames + 448 caption
# tokens), under remat only if the reckoned peak passes
# DENSE_PEAK_LIMIT; (e) 3 f32 train steps of a 2 + 2 layer cut at full
# width, 1 x (1500 frames + 64 tokens), card vs CPU port.
WHISPER = "whisper-small"
_BF, _F32 = ("bfloat16",), ("bfloat16", "float32")
WHISPER_ATTN_CASES = (
    (16, 1500, 1500, 12, 12, False, _BF, True),     # encoder, training
    (16, 448, 448, 12, 12, True, _BF, True),        # decoder self, training
    (16, 448, 1500, 12, 12, False, _BF, True),      # cross, training
    (32, 1, 1500, 12, 12, False, _F32, False),      # cross, a decode step
    (4, 1500, 1500, 12, 12, False, ("float32",), False),
    (2, 448, 1500, 12, 12, False, ("float32",), False),
    (2, 448, 448, 12, 12, True, ("float32",), False),
    (2, 300, 77, 12, 12, False, _F32, False),       # T < S
    (2, 200, 1, 12, 12, False, _F32, False),        # T = 1
    (2, 200, 129, 12, 12, False, _F32, False),      # one past a 128-key tile
    (2, 100, 65, 12, 12, False, _F32, False),       # one past a 64-key tile
    (2, 130, 333, 12, 4, False, _F32, False))       # GQA, T != S
WHISPER_SERVE = dict(batch=32, frames=1500, new_tokens=64)
WHISPER_REPLAY = dict(frames=1500, new_tokens=8)
WHISPER_TRAIN = dict(batch=16, frames=1500, tokens=448, steps=20)
WHISPER_TRAIN_REPLAY = dict(n_layers=2, frames=1500, tokens=64, steps=3)
# step 25: the mesh, the sharding rules, the dry run.  (a) the production
# meshes raise on one card, the host mesh is 1 x 1 on cuda:0; (b) the dry
# run plans every ASSIGNED x SHAPES cell on both planning meshes; (c)
# whisper-small whole through launch.steps.build_step on the host mesh at
# each kind's SHAPES cell, the global batch cut to one device's share of the
# 16 x 16 mesh's data axis (train_4k 16, prefill_32k 2, decode_32k 8): the
# prefill step run MESH_RUNS["prefill"] times, MESH_RUNS["decode"] greedy
# decode steps after a prefill of enc_seq frames has filled the cache's
# cross k / v, MESH_RUNS["train"] AdamW steps; each held bit for bit to the
# mesh-free path on the same inputs.  A sequence is cut (halved) only where
# its reckoned peak passes DENSE_PEAK_LIMIT.
MESH_SHARE = 16
MESH_RUNS = dict(prefill=3, decode=8, train=3)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


# ---------------------------------------------------------------- timing
class Clock:
    """Median CUDA-event time of single calls, each after a write of a
    buffer larger than the 50 MB L2, so every call starts with a cold
    cache as a query against a freshly touched map would.

    ``device`` mode queues a spin kernel ahead of the start event, so the
    host has enqueued the whole call before the card reaches it: the time
    is the card's alone (every kernel of the call and the gaps between
    them).  ``call`` mode omits the spin, so host work in the call that
    outlasts the cache flush is counted too, as a caller sees it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        self.spin = 1 << 22              # cycles: ~2 ms at the boost clock

    def _median(self, fn, reps: int, device: bool):
        torch = self.torch
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        ahead = True
        for a, b in ev:
            self.flush.zero_()
            if device:
                torch.cuda._sleep(self.spin)
            a.record()
            fn()
            b.record()
            ahead &= not a.query()       # the card had not started the call
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev), ahead

    def ms(self, fn, reps: int = 30) -> float:
        """The card's time for one call of ``fn``."""
        fn()
        self.torch.cuda.synchronize()
        for _ in range(4):
            t, ahead = self._median(fn, reps, device=True)
            if ahead:
                return t
            self.spin *= 4
        raise RuntimeError("chip_smoke: the host never got ahead of the card")

    def call_ms(self, fn, reps: int = 30) -> float:
        """One call of ``fn`` as its caller waits for it."""
        fn()
        self.torch.cuda.synchronize()
        return self._median(fn, reps, device=False)[0]


# ------------------------------------------------------------ step 2 inputs
def lift_inputs(torch, d, h, w, stride, seed, dev, empty="one"):
    """Depth with 25 % holes, D masks of mixed density (some objects under
    the point budget, some past the lift cap); ``empty``: one empty mask
    (the middle one), ``none`` or ``all``."""
    rng = np.random.default_rng(seed)
    depth = np.where(rng.random((h, w)) > 0.25,
                     rng.uniform(0.4, 6.0, (h, w)), 0.0).astype(np.float32)
    dens = rng.uniform(0.002, 0.6, size=(d, 1, 1))
    masks = rng.random((d, h, w)) < dens
    if empty == "one":
        masks[d // 2] = False
    elif empty == "all":
        masks[:] = False
    intr = np.array([0.9 * w * stride, 0.9 * w * stride, w * stride / 2,
                     h * stride / 2], np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q
    pose[:3, 3] = rng.uniform(-2, 2, 3)
    return [torch.from_numpy(a).to(dev) for a in (depth, masks, intr, pose)]


def topk_inputs(torch, Q, N, E, seed, dev, *, frac=0.8, tie=False,
                grid=False):
    """Unit-norm queries and rows (as the embedder makes them), a finite
    bias in [0, 0.2) on a ``frac`` share of the slots and NEG elsewhere.
    ``grid``: every value a multiple of 1/16 (bias of 1/256), so each score
    is exact in f32 under any summation order and equal scores are exact
    ties: the kernel's rank order must then equal the plain version's at
    any k, where at k = 1024 of unit-norm rows two scores closer than the
    rounding of either summation order (about 1e-7) may legitimately swap."""
    rng = np.random.default_rng(seed)
    if tie:      # every included slot scores exactly E / 8
        qs = np.full((Q, E), 0.5, np.float32)
        emb = np.full((N, E), 0.25, np.float32)
    elif grid:
        qs = (rng.integers(-8, 9, size=(Q, E)) / 16).astype(np.float32)
        emb = (rng.integers(-8, 9, size=(N, E)) / 16).astype(np.float32)
    else:
        qs = rng.normal(size=(Q, E)).astype(np.float32)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        emb = rng.normal(size=(N, E)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    inc = rng.random((Q, N)) < frac
    finite = (0.0 if tie else rng.integers(0, 52, size=(Q, N)) / 256 if grid
              else 0.2 * rng.random((Q, N)))
    bias = np.where(inc, finite, -1e30).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (qs, emb, bias)]


def lift_bytes(d, h, w, budget):
    """Each input read once, each output written once."""
    hw = h * w
    return hw * 4 + d * hw + 16 + 64 + d * budget * 12 + d * 4 + 3 * d * 12


def topk_cost(Q, N, E, k):
    """(bytes, fp32 flops) of one fused score + bias + top-k."""
    return (Q * E + N * E + Q * N) * 4 + Q * k * 8, 2 * Q * N * E + Q * N


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ step 2
def same_bits(torch, xs, ys) -> bool:
    """Every tensor of ``xs`` equal to its partner in ``ys`` bit for bit."""
    def bits(t):
        return (t.view(torch.int32) if t.dtype == torch.float32 else
                t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
    return all(x.dtype == y.dtype and torch.equal(bits(x), bits(y))
               for x, y in zip(xs, ys))


def kernel_checks(torch, clock, dev):
    from repro_torch.kernels import lift_compact as lc
    from repro_torch.kernels import query_topk as qt

    # lift_compact: main path (32 detections at 144x256, stride 5, budget
    # 2000, cap 4096), the edge shapes of tests/test_kernels.py, and the
    # edges of the cluster kernel's split (lift_compact.work_split): one
    # detection (8 blocks on one object), H*W = 1961 (no multiple of 16,
    # so no block share divides it and most masks start unaligned for the
    # 16-byte loads), 720x1280 at stride 1 (8 blocks of 15 register
    # chunks each), and every mask empty
    lift_cases = [((32, 144, 256, 5, 2000, 4096), "one"),
                  ((4, 24, 32, 1, 64, 4096), "one"),
                  ((8, 48, 64, 5, 512, 4096), "one"),
                  ((3, 20, 26, 2, 16, 32), "one"),
                  ((6, 30, 40, 3, 100, 80), "one"),
                  ((1, 144, 256, 5, 2000, 4096), "none"),
                  ((5, 37, 53, 3, 300, 4096), "one"),
                  ((4, 720, 1280, 1, 2000, 4096), "one"),
                  ((6, 144, 256, 5, 2000, 4096), "all")]
    for case, empty in lift_cases:
        d, h, w, stride, budget, cap = case
        args = lift_inputs(torch, d, h, w, stride, sum(case), dev, empty)
        kw = dict(stride=stride, budget=budget, lift_cap=cap)
        n0 = lc.launches
        got = lc.lift_compact_cuda(*args, **kw)
        check(lc.launches == n0 + 1, "lift_compact: one launch per call")
        want = lc.lift_compact_plain(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]), f"lift_compact n at {case}")
        err = max(float((g - x).abs().max()) for g, x in
                  zip(got, want) if g.is_floating_point())
        check(err <= LIFT_TOL, f"lift_compact err {err} at {case}")
        for k in {"all": range(d), "one": [d // 2], "none": []}[empty]:
            check(int(got[1][k]) == 0 and not got[0][k].any()
                  and not got[2][k].any() and not got[3][k].any(),
                  f"lift_compact empty mask at {case}")
        emit("lift_compact_check", {"shape": case, "empty": empty,
                                    "max_abs_err": err})
        if case == lift_cases[0][0]:
            again = lc.lift_compact_cuda(*args, **kw)
            check(same_bits(torch, got, again),
                  "lift_compact: two calls give the same bits")
            kernel = lambda: lc.lift_compact_cuda(*args, **kw)  # noqa
            b_ms, b_by = bound(lift_bytes(d, h, w, budget), 0)
            lift_row = {
                "ms": clock.ms(kernel), "call_ms": clock.call_ms(kernel),
                "plain_ms": clock.ms(lambda: lc.lift_compact_plain(*args,
                                                                   **kw)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "max_abs_err": err,
                "shape": f"D={d} H={h} W={w} stride={stride} "
                         f"budget={budget} cap={cap}"}
            emit("lift_compact_time", lift_row)

    # query_topk_bias: SQ (N = 4096), LQ (N = 512) and the batched query
    # phase (Q = 16, N = 10240 slots) at E = 512, k = 5, the SQ shape
    # being the one the kernel record reports; then k past the
    # included count, all-equal scores, k = 1024, a ragged N, more queries
    # than one block holds, an E that takes the scalar-load path, N below
    # one 32-row block, and the cluster index's k = 1024 at the batched
    # shape (on exact-grid values, see topk_inputs)
    topk_cases = [((16, 10240, 512, 5), {}), ((1, 4096, 512, 5), {}),
                  ((1, 512, 512, 5), {}), ((2, 700, 64, 40), {"frac": 0.03}),
                  ((4, 700, 64, 20), {"tie": True}),
                  ((2, 3000, 64, 1024), {}), ((3, 1000, 96, 100), {}),
                  ((37, 2000, 128, 9), {}), ((2, 900, 50, 7), {}),
                  ((2, 20, 64, 7), {}), ((1, 31, 512, 5), {}),
                  ((16, 10240, 512, 1024), {"grid": True})]
    timed = {}
    for (Q, N, E, k), kind in topk_cases:
        args = topk_inputs(torch, Q, N, E, Q * N + E + k, dev, **kind)
        gv, gi = qt.query_topk_bias_cuda(*args, k)
        wv, wi = qt.query_topk_bias_plain(*args, k)
        torch.cuda.synchronize()
        tag = f"Q={Q} N={N} E={E} k={k} {kind}"
        check(torch.equal(gi, wi), f"query_topk_bias slots at {tag}")
        err = float((gv - wv).abs().max())
        check(err <= SCORE_TOL, f"query_topk_bias err {err} at {tag}")
        if kind.get("tie"):
            n_inc = int((args[2][0] > -5e29).sum())
            want0 = torch.nonzero(args[2][0] > -5e29)[:k, 0].to(torch.int32)
            check(torch.equal(gi[0, :min(k, n_inc)], want0),
                  "ties go to the lower slot")
        emit("query_topk_bias_check", {"shape": [Q, N, E, k], **kind,
                                       "max_abs_err": err})
        if E == 512 and k == 5 and N >= 512:
            qs, emb, bias = args
            kernel = lambda: qt.query_topk_bias_cuda(qs, emb, bias, k)  # noqa
            b_ms, b_by = bound(*topk_cost(Q, N, E, k))
            timed[(Q, N)] = {
                "ms": clock.ms(kernel), "call_ms": clock.call_ms(kernel),
                "plain_ms": clock.ms(
                    lambda: qt.query_topk_bias_plain(qs, emb, bias, k)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": clock.ms(
                    lambda: torch.topk(qs @ emb.T + bias, k)),
                "max_abs_err": err, "shape": f"Q={Q} N={N} E={E} k={k}"}
            emit("query_topk_bias_time", timed[(Q, N)])
    return lift_row, timed[(1, 4096)]


def grid_topk_inputs(torch, Q, N, E, seed, dev, *, frac=0.8):
    """``topk_inputs(grid=True)`` drawn on the card (the shapes past 2^31
    elements would take minutes of numpy): every value a multiple of 1/16,
    the bias a multiple of 1/256 or NEG, so each score is exact in f32 under
    any summation order and equal scores are exact ties."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def vals(shape):
        return (torch.randint(-8, 9, shape, generator=g, device=dev,
                              dtype=torch.int8).to(torch.float32) / 16)
    qs, emb = vals((Q, E)), vals((N, E))
    bias = torch.empty((Q, N), device=dev)
    rows = max(1, (1 << 28) // N)           # fill the bias in slabs
    for q0 in range(0, Q, rows):
        q1 = min(Q, q0 + rows)
        inc = torch.rand((q1 - q0, N), generator=g, device=dev) < frac
        fin = torch.randint(0, 52, (q1 - q0, N), generator=g, device=dev,
                            dtype=torch.int8).to(torch.float32) / 256
        bias[q0:q1] = torch.where(inc, fin, -1e30)
    return qs, emb, bias


def plain_by_query_chunks(torch, qt, qs, emb, bias, k, rows):
    """The plain version over chunks of ``rows`` queries (queries are
    independent rows), for shapes whose [Q, N] scores would not fit twice."""
    outs = [qt.query_topk_bias_plain(qs[q0:q0 + rows], emb,
                                     bias[q0:q0 + rows], k)
            for q0 in range(0, qs.shape[0], rows)]
    return torch.cat([v for v, _ in outs]), torch.cat([i for _, i in outs])


def topk_any_k_checks(torch, clock, dev) -> list:
    """query_topk_bias past the old limits: k = 2000 at the SQ shape and at
    the 1M flat shape, k = N + 5, N * E >= 2^31 and Q * N >= 2^31; each
    against its plain version (slots exactly, ties to the lower slot,
    scores within SCORE_TOL) and timed beside its byte bound."""
    from repro_torch.kernels import query_topk as qt

    rows = []
    for tag, (Q, N, E, k), chunk, reps in TOPK_ANY_K:
        qs, emb, bias = grid_topk_inputs(torch, Q, N, E, Q + N + E + k, dev)

        def plain(qs=qs, emb=emb, bias=bias, k=k, chunk=chunk):
            if chunk is None:
                return qt.query_topk_bias_plain(qs, emb, bias, k)
            return plain_by_query_chunks(torch, qt, qs, emb, bias, k, chunk)
        gv, gi = qt.query_topk_bias_cuda(qs, emb, bias, k)
        wv, wi = plain()
        torch.cuda.synchronize()
        check(tuple(gi.shape) == (Q, k), f"query_topk_bias shape at {tag}")
        check(torch.equal(gi, wi), f"query_topk_bias slots at {tag}")
        err = float((gv - wv).abs().max())
        check(err <= SCORE_TOL, f"query_topk_bias err {err} at {tag}")
        n_inc = (bias > -5e29).sum(dim=1)
        if k > N:
            check(bool((gi[:, N:] == -1).all())
                  and bool((gv[:, N:] == qt.NEG).all()),
                  f"query_topk_bias pads past N at {tag}")
        del wv, wi
        b_ms, b_by = bound(*topk_cost(Q, N, E, k))
        # past 2^31 elements the caching allocator frees and syncs inside
        # the calls, so the host cannot queue ahead: time them as called
        timer = clock.ms if chunk is None else clock.call_ms
        row = {"case": tag, "shape": [Q, N, E, k], "max_abs_err": err,
               "included_min": int(n_inc.min()),
               "timed": "device" if chunk is None else "call",
               "ms": timer(lambda: qt.query_topk_bias_cuda(qs, emb, bias, k),
                           reps),
               "plain_ms": timer(plain, reps),
               "bound_ms": b_ms, "bound_by": b_by,
               # torch.topk refuses k > N
               "library_ms": None if k > N else timer(
                   lambda: torch.topk(qs @ emb.T + bias, k), reps)}
        emit("query_topk_bias_any_k", row)
        rows.append(row)
        del qs, emb, bias, gv, gi
        torch.cuda.empty_cache()
    return rows


def attn_inputs(torch, B, S, H, Kv, dh, dtype, seed, dev, T=None):
    """Seeded q [B, S, H, dh] and k, v [B, T, Kv, dh] (T = S by
    default) on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    T = S if T is None else T
    return [torch.randn((B, n, h, dh), generator=g, device=dev).to(dtype)
            for n, h in ((S, H), (T, Kv), (T, Kv))]


def attn_cost(q, k, causal, window, elt, dv=None):
    """(bytes, flops) of one attention call: q, k, v read and o written
    once; 2 * (dh + dv) flops for each (query, key) pair the masks keep
    (v and o of head width ``dv``, by default q's dh; k and v of their own
    length T)."""
    B, S, H, dh = q.shape
    dv = dh if dv is None else dv
    qp = np.arange(S)[:, None]
    kp = np.arange(k.shape[1])[None, :]
    keep = np.ones((S, k.shape[1]), bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= qp - kp < window
    return ((q.numel() + k.numel()) * (dh + dv) // dh * elt,
            2 * (dh + dv) * B * H * int(keep.sum()))


def tlen(q, k) -> str:
    """" T=<keys>" where k's length differs from q's, else ""."""
    return "" if k.shape[1] == q.shape[1] else f" T={k.shape[1]}"


def attn_close(got, want, dtype, tol=None):
    """(max abs error, within ``tol`` = (atol, rtol); by default ATTN_TOL's
    as both)."""
    if tol is None:
        tol = (ATTN_TOL[str(dtype).split(".")[-1]],) * 2
    err = (got.float() - want.float()).abs()
    return float(err.max()), bool(
        (err <= tol[0] + tol[1] * want.float().abs()).all())


def attn_time(torch, clock, q, k, v, kw, err, plain_as_called=False):
    """The time row of one bf16 attention call: cold-L2 ms of
    ``flash_attention_cuda`` beside its bound (operations and bytes, the
    masks counted, v of its own width), the plain version's
    (``plain_as_called``: timed as called, where its key steps keep the
    host from queueing ahead of the card) and SDPA's on the same inputs
    (``enable_gqa`` where H != Kv, a window as a boolean mask).  SDPA has
    no logit softcap: under one it computes another function, so
    ``library_ms`` is null and its time is kept as
    ``library_without_softcap_ms``; where no SDPA backend takes the pair,
    null with the reason."""
    from repro_torch.kernels import flash_attention as fa
    F = torch.nn.functional

    B, S, H, dh = q.shape
    Kv, dv = k.shape[2], v.shape[-1]
    causal, window, cap = kw["causal"], kw["window"], kw["softcap"]
    nbytes, flops = attn_cost(q, k, causal, window, q.element_size(), dv=dv)
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    sdpa_kw = dict(enable_gqa=True) if H != Kv else {}
    if window:
        pos = torch.arange(S, device=q.device)
        keep = pos[:, None] - pos[None, :] < window
        if causal:
            keep &= pos[None, :] <= pos[:, None]
        sdpa_kw["attn_mask"] = keep
    else:
        sdpa_kw["is_causal"] = causal
    sdpa = [t.transpose(1, 2) for t in (q, k, v)]
    try:
        lib_ms = clock.ms(lambda: F.scaled_dot_product_attention(*sdpa,
                                                                 **sdpa_kw))
        lib = ("torch.nn.functional.scaled_dot_product_attention("
               + ", ".join(sorted(sdpa_kw)) + ")")
    except RuntimeError as e:     # no SDPA backend takes this pair
        lib_ms, lib = None, f"SDPA refused dv != dqk: {e}"[:300]

    def plain():
        return fa.flash_attention_plain(q, k, v, **kw)
    row = {"ms": clock.ms(lambda: fa.flash_attention_cuda(q, k, v, **kw)),
           "plain_ms": (clock.call_ms(plain, 10) if plain_as_called
                        else clock.ms(plain)),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": None if cap else lib_ms, "library": lib,
           "max_abs_err": err, "flops": flops, "bytes": nbytes,
           "shape": f"B={B} S={S}{tlen(q, k)} H={H} Kv={Kv} dqk={dh} "
                    f"dv={dv} bf16 causal={causal} window={window} "
                    f"softcap={cap}"}
    if plain_as_called:
        row["plain_timed"] = "call"
    if cap and lib_ms is not None:
        row["library_without_softcap_ms"] = lib_ms
    row["tflops"] = flops / row["ms"] / 1e9
    if row["library_ms"] is not None:
        row["library_tflops"] = flops / row["library_ms"] / 1e9
    return row


def attention_checks(torch, clock, dev):
    from repro_torch.kernels import flash_attention as fa
    close = attn_close

    # (B, S, H, Kv, dh, dtype, causal, window, softcap): the captioner's
    # prefill; tests/test_kernels.py:75-81 and a non-causal ragged S, each
    # in the reference's [H, S, dh] layout (strided views, as
    # ops.flash_attention passes them); a GQA case with every option
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(8, 1024, 12, 4, 64, bf, True, 0, 0.0),
             (8, 1024, 12, 4, 64, f32, True, 0, 0.0),
             (1, 128, 2, 2, 64, f32, True, 0, 0.0),
             (1, 256, 4, 4, 64, f32, True, 64, 0.0),
             (1, 200, 2, 2, 128, f32, True, 0, 50.0),
             (1, 128, 1, 1, 64, f32, False, 0, 0.0),
             (1, 256, 2, 2, 64, bf, True, 0, 0.0),
             (1, 200, 2, 2, 64, f32, False, 0, 0.0),
             (1, 200, 2, 2, 64, bf, False, 0, 0.0),
             (2, 333, 12, 4, 128, bf, True, 100, 30.0),
             # edges of the bf16 kernel's 128 x 128 tiling: S below one
             # tile, one row past a tile, MQA, window 1, non-causal dh 128
             (2, 17, 12, 4, 64, bf, True, 0, 0.0),
             (1, 1025, 12, 4, 64, bf, True, 0, 0.0),
             (2, 1024, 12, 1, 64, bf, True, 0, 0.0),
             (1, 300, 4, 4, 64, bf, True, 1, 0.0),
             (1, 2048, 4, 2, 128, bf, False, 0, 0.0)]
    row = None
    for i, (B, S, H, Kv, dh, dt, causal, window, cap) in enumerate(cases):
        if B == 1 and H == Kv:
            hsd = attn_inputs(torch, 1, S, H, H, dh, dt, i, dev)
            q, k, v = (t[0].transpose(0, 1).contiguous().transpose(0, 1)[None]
                       for t in hsd)      # [1, S, H, dh] views of [H, S, dh]
        else:
            q, k, v = attn_inputs(torch, B, S, H, Kv, dh, dt, i, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err, ok = close(got, want, dt)
        tag = dict(B=B, S=S, H=H, Kv=Kv, dh=dh, dtype=str(dt), **kw)
        check(ok and bool(torch.isfinite(got).all()),
              f"flash_attention err {err} at {tag}")
        emit("flash_attention_check", {**tag, "max_abs_err": err})
        if i == 0:
            row = attn_time(torch, clock, q, k, v, kw, err)
            emit("flash_attention_time", row)
    return row


def nd_inputs(torch, M, N, D, seed, dev, frac=0.9, hole=None):
    """Points in a 10 m room (a), map points or centroids (b), a share
    ``frac`` of b valid, none of the rows in ``hole`` = (lo, hi)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = (torch.rand((M, D), generator=g, device=dev) - 0.5) * 10
    b = (torch.rand((N, D), generator=g, device=dev) - 0.5) * 10
    bv = torch.rand((N,), generator=g, device=dev) < frac
    if hole is not None:
        bv[hole[0]:hole[1]] = False
    return a, b, bv


def nd_cost(M, N, D, n_valid):
    """(bytes, fp32 flops) of one nearest_dist call.  The least work is D
    multiply-adds and one min for each (row, valid b row) pair, 2D + 1
    flops: the kernel folds |b|^2 into the first FMA and adds |a|^2 once a
    row, so counting the reference's 2D + 3 would put the kernel's own
    work above its bound."""
    return 4 * (M * D + N * D + M) + N, M * n_valid * (2 * D + 1)


def nearest_checks(torch, clock, dev):
    from repro_torch.kernels import pairwise as pw

    # the reference's test shapes, the two path shapes, no valid
    # neighbour; then the edges of the kernel's tiling (pairwise.nd_split:
    # 1024 rows of a a block, or 256 where M < 16384; b cut among a
    # cluster's blocks and staged 2048 rows (D <= 3) or 512 rows (D <= 8)
    # at a time): N that is no multiple of a tile with shares past one
    # tile, a stretch of invalid b rows longer than a share (a block whose
    # whole share is invalid), D = 8 and D = 5 (the padded 8-lane kernel),
    # M no multiple of a block's rows, and one row against one point
    cases = [((50, 70, 3), 0.9, None), ((256, 512, 3), 0.9, None),
             ((1000, 333, 3), 0.9, None), ((128, 128, 8), 0.9, None),
             ((2000, 2000, 3), 0.9, None), ((64000, 4096, 3), 0.8, None),
             ((300, 200, 3), 0.0, None),
             ((20000, 17000, 3), 0.9, None),
             ((20000, 17000, 3), 0.9, (4000, 9000)),
             ((20000, 17000, 8), 0.9, (4000, 9000)),
             ((513, 2049, 5), 0.9, None), ((1, 1, 3), 1.0, None)]
    rows = {}
    for i, ((M, N, D), frac, hole) in enumerate(cases):
        a, b, bv = nd_inputs(torch, M, N, D, i, dev, frac, hole)
        got = pw.nearest_dist_cuda(a, b, bv)
        want = pw.nearest_dist_plain(a, b, bv)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(((got - want).abs() <= ND_TOL + ND_TOL * want.abs()).all()),
              f"nearest_dist err {err} at {(M, N, D)}")
        if frac == 0.0:
            check(bool((got == pw.INF).all()), "no valid neighbour -> 1e30")
        emit("nearest_dist_check", {"shape": [M, N, D], "valid_share": frac,
                                    "invalid_rows": hole, "max_abs_err": err})
        if (M, N, D) in ND_PATH_SHAPES and (M, N, D) not in rows:
            check(same_bits(torch, [got], [pw.nearest_dist_cuda(a, b, bv)]),
                  f"nearest_dist: two calls give the same bits at {(M, N)}")
            n_valid = int(bv.sum())
            b_ms, b_by = bound(*nd_cost(M, N, D, n_valid))
            rows[(M, N, D)] = {
                "ms": clock.ms(lambda: pw.nearest_dist_cuda(a, b, bv)),
                "plain_ms": clock.ms(lambda: pw.nearest_dist_plain(a, b, bv)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": clock.ms(lambda: torch.cdist(a, b).masked_fill(
                    ~bv[None], torch.inf).amin(1).square()),
                "max_abs_err": err, "n_valid": n_valid,
                "shape": f"M={M} N={N} D={D}"}
            emit("nearest_dist_time", rows[(M, N, D)])
    return {**rows[ND_PATH_SHAPES[1]], "chamfer": rows[ND_PATH_SHAPES[0]]}


def nearest_phase(torch, dev):
    """The whole path of nearest_dist is its entry point: ops.nearest_dist
    at the chamfer and centroid shapes, the chamfer held against the CPU
    port, with the launch counters reset just before and read just after."""
    from repro_torch.kernels import ops

    inputs = [nd_inputs(torch, M, N, D, 100 + i, dev)
              for i, (M, N, D) in enumerate(ND_PATH_SHAPES)]
    ops.reset_launch_counts()
    outs = [ops.nearest_dist(*x) for x in inputs]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = ops.nearest_dist(*(t.cpu() for t in inputs[0]))
    err = float((outs[0].cpu() - want).abs().max())
    check(err <= ND_TOL * (1 + float(want.abs().max())),
          f"nearest_dist chamfer against the CPU port: err {err}")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          "nearest_dist outputs finite")
    check(counts["nearest_dist"] == len(ND_PATH_SHAPES),
          f"nearest_dist launched on its path: {counts}")
    out = {"shapes": ND_PATH_SHAPES, "max_abs_err_vs_cpu": err,
           "launches": counts}
    emit("nearest_dist_phase", out)
    return out


# ------------------------------------------------------------------ step 3
def main_path(torch, dev, knobs, *, embed_dim, h, w, n_frames,
              keyframe_interval, n_objects):
    from repro_torch.core import (CloudService, DeviceClient, MappingServer,
                                  Query)
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.kernels import ops
    from repro_torch.perception.embedder import OracleEmbedder

    kn, E = knobs, embed_dim
    D = kn.max_detections_per_frame
    emb = OracleEmbedder(embed_dim=E)
    scene = make_scene(n_objects=n_objects, seed=0)
    classes = {o.oid: o.class_id for o in scene.objects}
    srv = MappingServer(knobs=kn, embedder=emb, device=dev)
    cloud = CloudService(knobs=kn, store_ref=srv, device=dev)
    client = DeviceClient(knobs=kn, embed_dim=E, device=dev)
    gen = torch.Generator().manual_seed(0)   # per-view noise, host-drawn so
    kept, snap = [], None                    # step 5 can replay it on the CPU
    ingest_ms, tick_bytes, render_s = [], [], 0.0

    ops.reset_launch_counts()
    t_render = time.perf_counter()
    for i, fr in enumerate(scene_stream(scene, n_frames=n_frames,
                                        keyframe_interval=keyframe_interval,
                                        h=h, w=w)):
        render_s += time.perf_counter() - t_render
        noise = torch.randn((D, E), generator=gen)
        t = srv.process_frame(fr, classes, noise)
        if t.ingest_ms > 0:
            ingest_ms.append(t.ingest_ms)
        if i < CROSS_FRAMES:
            kept.append((fr, noise))
            if i == CROSS_FRAMES - 1:
                snap = srv.store._replace(**{
                    f: v.clone() for f, v in srv.store._asdict().items()
                    if v is not None})
        if i % 2 == 1:
            pkt = cloud.update_tick(network_up=True)
            client.ingest(pkt, user_pos=torch.from_numpy(
                np.asarray(fr.pose[:3, 3], np.float32)))
            tick_bytes.append(pkt.nbytes)
        t_render = time.perf_counter()
    n_keyframes = i + 1

    st, loc = srv.store, client.local
    act, lab = st.active.cpu().numpy(), st.label.cpu().numpy()
    lact, llab = loc.active.cpu().numpy(), loc.label.cpu().numpy()
    mapped = sorted(set(lab[act].tolist()))
    sq_hit = lq_hit = 0
    sq_ms, lq_ms = [], []
    for c in mapped:
        spec = Query(embed=emb.embed_text(c, dev), k=5)
        t0 = time.perf_counter()
        r = cloud.query_spec(spec)
        sq_ms.append((time.perf_counter() - t0) * 1e3)
        check(tuple(r.oids.shape) == (5,) and bool(
            torch.isfinite(r.scores[0])), f"SQ result for class {c}")
        s = int(r.slots[0])
        sq_hit += bool(s >= 0 and act[s] and lab[s] == c)
        t0 = time.perf_counter()
        r = client.query_spec(spec)
        lq_ms.append((time.perf_counter() - t0) * 1e3)
        s = int(r.slots[0])
        lq_hit += bool(s >= 0 and lact[s] and llab[s] == c)
    counts = ops.launch_counts()

    for name in ("embed", "centroid", "points"):
        check(bool(torch.isfinite(getattr(st, name)).all()),
              f"store.{name} finite")
    check(n_keyframes == -(-n_frames // keyframe_interval), "keyframes")
    check(len(mapped) > 0, "objects mapped")
    check(sq_hit >= 0.9 * len(mapped), f"SQ top-1 accuracy {sq_hit}/"
          f"{len(mapped)}")
    check(lq_hit >= 0.9 * len(mapped), f"LQ top-1 accuracy {lq_hit}/"
          f"{len(mapped)}")
    for name in ("lift_compact", "query_topk_bias"):
        check(counts[name] > 0, f"{name} launched on the main path")
    out = {"keyframes": n_keyframes,
           "ingest_ms_p50": float(np.percentile(ingest_ms, 50)),
           "ingest_ms_p95": float(np.percentile(ingest_ms, 95)),
           "render_s_host": render_s,
           "n_mapped": int(act.sum()), "deferred": srv.deferred,
           "downlink_bytes_per_tick": tick_bytes,
           "local_occupancy": int(lact.sum()),
           "local_bytes": client.memory_bytes(),
           "mapped_classes": len(mapped),
           "sq_top1_acc": sq_hit / len(mapped),
           "lq_top1_acc": lq_hit / len(mapped),
           "sq_ms_p50": float(np.percentile(sq_ms, 50)),
           "lq_ms_p50": float(np.percentile(lq_ms, 50)),
           "launches": counts}
    emit("main_path", out)
    loop = SimpleNamespace(srv=srv, cloud=cloud, client=client, emb=emb,
                           gen=gen, scene=scene, classes=classes)
    return out, kept, snap, loop


# ------------------------------------------------------------------ step 4
def profile_phase(torch, dev, loop, *, embed_dim, h, w, n_frames,
                  keyframe_interval, **_):
    """Host ms per stage of PROFILE_KEYFRAMES keyframes (each stage ending
    in a synchronize), then a ``torch.profiler`` window over as many more.
    The keyframes revisit the start of step 3's stream."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Query
    from repro_torch.data.scenes import scene_stream
    from repro_torch.kernels import ops

    srv, cloud, client = loop.srv, loop.cloud, loop.client
    D = srv.knobs.max_detections_per_frame
    spec = Query(embed=loop.emb.embed_text(0, dev), k=5)

    def step(fr):
        ms = {}
        t = srv.process_frame(fr, loop.classes, torch.randn(
            (D, embed_dim), generator=loop.gen))
        ms["detect"], ms["ingest"] = t.detect_ms, t.ingest_ms
        t0 = time.perf_counter()
        pkt = cloud.update_tick(network_up=True)
        torch.cuda.synchronize()
        ms["collect"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        client.ingest(pkt, user_pos=torch.from_numpy(
            np.asarray(fr.pose[:3, 3], np.float32)))
        torch.cuda.synchronize()
        ms["client_ingest"] = (time.perf_counter() - t0) * 1e3
        for name, fn in (("sq", cloud.query_spec), ("lq", client.query_spec)):
            t0 = time.perf_counter()
            fn(spec)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
        return ms

    frames = scene_stream(loop.scene, n_frames=n_frames,
                          keyframe_interval=keyframe_interval, h=h, w=w)
    todo = [next(frames) for _ in range(2 * PROFILE_KEYFRAMES)]
    stages = [step(fr) for fr in todo[:PROFILE_KEYFRAMES]]
    emit("stages", stages)

    torch.cuda.synchronize()
    n0 = ops.launch_counts()["lift_compact"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fr in todo[PROFILE_KEYFRAMES:]:
            step(fr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # one lift kernel on the card for each lift_compact call
    lift_calls = ops.launch_counts()["lift_compact"] - n0
    lift_kernels = sum(e.count for e in prof.key_averages()
                       if "lift_cluster_kernel" in e.key)
    check(lift_calls > 0 and lift_kernels == lift_calls,
          f"{lift_kernels} lift kernels for {lift_calls} lift_compact calls")
    out = {"keyframes": PROFILE_KEYFRAMES, "lift_compact_calls": lift_calls,
           "lift_kernels": lift_kernels, **profile_summary(prof, wall_ms)}
    emit("profile", out)
    return out


def profile_summary(prof, wall_ms: float, kernels=()) -> dict:
    """Device-busy share, host syncs and top kernels / CPU ops of a
    ``torch.profiler`` window that lasted ``wall_ms`` on the host; with
    ``kernels``, the device ms of every kernel whose name holds each
    substring (``kernel_ms``)."""
    from torch.autograd import DeviceType

    ev = prof.key_averages()
    # device-side events only: a CPU op's row also carries its kernels' time
    on_dev = [e for e in ev if e.device_type != DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    check(busy_ms > 0, "the profiler saw device time")
    aten = [e for e in ev if e.key.startswith("aten::")]

    def top(rows, key):
        return [{"name": e.key[:60], "calls": e.count, "ms": key(e) / 1e3}
                for e in sorted(rows, key=key, reverse=True)[:10]]

    extra = {"kernel_ms": {k: sum(e.self_device_time_total for e in on_dev
                                  if k in e.key) / 1e3 for k in kernels}} \
        if kernels else {}
    return {**extra, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "host_syncs": {e.key: e.count for e in ev if e.key in SYNC_OPS},
            "cpu_ops": sum(e.count for e in aten),
            "top_kernels": top(on_dev, lambda e: e.self_device_time_total),
            "top_cpu_ops": top(aten, lambda e: e.self_cpu_time_total)}


def profiled(torch, fn, kernels=()) -> dict:
    """``profile_summary`` of one call of ``fn`` (ending in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, wall_ms, kernels)


# ------------------------------------------------------------------ step 5
def query_phase(torch, dev, *, n, capacity, embed_dim, max_points):
    from repro_torch.core.query import Query, execute_query, stack_queries
    from repro_torch.core.store import synthetic_store
    from repro_torch.kernels import ops

    cap = capacity
    gpu = synthetic_store(n, cap, embed_dim, max_points, device=dev)
    cpu = synthetic_store(n, cap, embed_dim, max_points, device="cpu")
    lab = cpu.label.numpy()[:n]
    qi = np.random.default_rng(1).choice(np.nonzero(lab < 10)[0], 16,
                                         replace=False)
    spec = stack_queries([Query(
        embed=cpu.embed[i], near=(cpu.centroid[i], torch.tensor(4.0)),
        prox_weight=torch.tensor(0.2), labels=tuple(range(10)),
        min_obs=torch.tensor(1, dtype=torch.int32), k=5) for i in qi])

    ops.reset_launch_counts()
    want = execute_query(cpu, spec)
    got = execute_query(gpu, spec)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        execute_query(gpu, spec)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launched = ops.launch_counts()["query_topk_bias"]
    check(launched > 0, "query_topk_bias launched in the query phase")
    check(torch.equal(got.oids.cpu(), want.oids), "query phase oids")
    check(torch.equal(got.slots.cpu(), want.slots), "query phase slots")
    err = float((got.scores.cpu() - want.scores).abs().max())
    check(err <= SCORE_TOL, f"query phase scores err {err}")
    check(torch.equal(got.oids[:, 0].cpu(),
                      torch.from_numpy(qi + 1).to(torch.int32)),
          "each query's own object ranks first")
    out = {"objects": n, "slots": cap, "queries": 16,
           "batched_ms_p50": float(np.percentile(lat, 50)),
           "batched_ms_p95": float(np.percentile(lat, 95)),
           "max_abs_err_vs_cpu": err, "kernel_launches": launched}
    emit("query_phase", out)
    return out


# ------------------------------------------------------------------ step 6
def cross_device(torch, knobs, embed_dim, kept, snap, classes):
    from repro_torch.core import MappingServer
    from repro_torch.perception.embedder import OracleEmbedder

    srv = MappingServer(knobs=knobs,
                        embedder=OracleEmbedder(embed_dim=embed_dim),
                        device="cpu")
    for fr, noise in kept:
        srv.process_frame(fr, classes, noise)
    errs = {}
    for f, v in srv.store._asdict().items():
        g = getattr(snap, f).cpu()
        if v.is_floating_point():
            errs[f] = float((g - v).abs().max())
            check(errs[f] <= LIFT_TOL, f"cross-device store.{f} {errs[f]}")
        else:
            check(torch.equal(g, v), f"cross-device store.{f}")
    out = {"keyframes": len(kept), "n_active": int(snap.active.sum()),
           "max_abs_err": errs}
    emit("cross_device", out)
    return out


# ------------------------------------------------------------------ step 7
def serve_phase(torch, dev, cfg, *, batch, prompt, new_tokens, reps):
    """The captioner's serving path: prefill, then greedy decode steps,
    through model_api's entry points, ``reps`` times on the same caches."""
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.models.api import model_api
    from repro_torch.models.lm import greedy_token

    api = model_api(cfg)
    t0 = time.perf_counter()
    model = api.init(torch.Generator().manual_seed(0), device=dev)
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(next(batch_iterator(
        batch, prompt, seed=0, vocab_size=cfg.vocab_size))["tokens"]).to(dev)
    caches = api.init_cache(batch, prompt + new_tokens, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pre_ms, dec_ms, per_prefill, per_decode, generated = [], [], [], [], []

    ops.reset_launch_counts()
    for _ in range(reps):
        n0 = ops.launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        logits, caches = api.prefill(model, {"tokens": tokens}, caches)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
        n1 = ops.launch_counts()["flash_attention"]
        per_prefill.append(n1 - n0)
        check(bool(torch.isfinite(logits).all()), "prefill logits finite")
        tok = greedy_token(logits)
        gen = [tok]
        for i in range(new_tokens):
            t0 = time.perf_counter()
            logits, caches = api.decode(model, tok, caches, prompt + i)
            tok = greedy_token(logits)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            gen.append(tok)
        per_decode.append(ops.launch_counts()["flash_attention"] - n1)
        check(bool(torch.isfinite(logits).all()), "decode logits finite")
        generated.append(torch.cat(gen, dim=1).cpu())
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    check(per_prefill == [cfg.n_layers] * reps,
          f"{cfg.n_layers} flash_attention launches per prefill: "
          f"{per_prefill}")
    check(per_decode == [0] * reps, f"no flash_attention launch while "
          f"decoding: {per_decode}")
    check(all(torch.equal(g, generated[0]) for g in generated),
          "the same greedy tokens from every repetition")
    check(int(caches[0].length) == prompt + new_tokens, "cache length")
    check(counts["flash_attention"] > 0,
          "flash_attention launched on the serving path")
    prof = serve_profile(torch, api, model, tokens, caches)
    pre = prof["prefill"]
    flash_ms = sum(r["ms"] for r in pre["top_kernels"] if "flash" in r["name"])
    check(flash_ms > 0, "flash_attention among the prefill's top kernels")
    prof["prefill_flash_device_ms"] = flash_ms
    prof["prefill_flash_share_of_device"] = flash_ms / pre["device_busy_ms"]
    emit("serve_profile", prof)

    dec = float(np.percentile(dec_ms, 50))
    out = {"config": cfg.name, "batch": batch, "prompt": prompt,
           "new_tokens": new_tokens, "reps": reps,
           "params": sum(p.numel() for p in model.parameters()),
           "weights_bytes": sum(p.numel() * p.element_size()
                                for p in model.parameters()),
           "kv_cache_bytes": sum(c.k.nbytes + c.v.nbytes for c in caches),
           "init_s_host": init_s,
           "prefill_ms": pre_ms, "prefill_ms_p50": float(np.median(pre_ms)),
           "decode_ms_per_step_p50": dec,
           "decode_ms_per_step_p95": float(np.percentile(dec_ms, 95)),
           "generated_tokens_per_s": batch / dec * 1e3,
           "max_memory_allocated_bytes": peak,
           "flash_launches_per_prefill": per_prefill,
           "launches": counts,
           "first_tokens": generated[0][0, :8].tolist()}
    emit("serve_phase", out)
    return out


# ------------------------------------------------------------------ step 8
def frontend_batch(tokens, extra):
    """The model batch of ``tokens``, with ``extra`` (a vision model's patch
    embeddings [B, n_vis, d], or None) as its ``extra_embeds``."""
    return ({"tokens": tokens} if extra is None
            else {"tokens": tokens, "extra_embeds": extra})


def replay_run(torch, api, model, prompt_np, new_tokens, device,
               extra_np=None):
    """The replays' loop: the launch counters reset, ``prompt_np`` [B, S]
    (after ``extra_np``'s n_vis patch embeddings, where given) prefilled
    into fresh caches on ``device``, then ``new_tokens`` greedy steps at
    positions n_vis + S + i.  Returns (the greedy tokens [B, new_tokens +
    1], the logits of the prefill and every step [new_tokens + 1, B, V] on
    the CPU, the prefill's flash launches)."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import greedy_token

    batch, prompt = prompt_np.shape
    front = 0 if extra_np is None else extra_np.shape[1]
    caches = api.init_cache(batch, front + prompt + new_tokens,
                            device=device)
    ops.reset_launch_counts()
    logits, caches = api.prefill(model, frontend_batch(
        torch.from_numpy(prompt_np).to(device),
        None if extra_np is None else torch.from_numpy(extra_np).to(device)),
        caches)
    flash = ops.launch_counts()["flash_attention"]
    toks, all_logits = [], [logits.cpu()]
    tok = greedy_token(logits)
    for i in range(new_tokens):
        toks.append(tok.cpu())
        logits, caches = api.decode(model, tok, caches, front + prompt + i)
        all_logits.append(logits.cpu())
        tok = greedy_token(logits)
    toks.append(tok.cpu())
    return torch.cat(toks, dim=1), torch.stack(all_logits), flash


def replay_phase(torch, dev, cfg, *, batch, prompt, new_tokens):
    """Step 7's weights in f32 (the same seeded draw, not rounded to bf16)
    on the card and on the CPU port: greedy tokens equal, logits close."""
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.models.api import model_api

    api = model_api(cfg.replace(dtype=torch.float32))
    prompt_np = next(batch_iterator(batch, prompt, seed=1,
                                    vocab_size=cfg.vocab_size))["tokens"]

    def run(device):
        model = api.init(torch.Generator().manual_seed(0), device=device)
        return replay_run(torch, api, model, prompt_np, new_tokens,
                          device)[:2]

    t0 = time.perf_counter()
    gtok, glog = run(dev)
    ctok, clog = run("cpu")
    err = float((glog - clog).abs().max())
    check(torch.equal(gtok, ctok), f"greedy tokens card {gtok.tolist()} vs "
          f"CPU {ctok.tolist()}")
    check(err <= LOGIT_TOL, f"f32 logits card vs CPU err {err}")
    out = {"batch": batch, "prompt": prompt, "new_tokens": new_tokens,
           "tokens": gtok[0].tolist(), "max_abs_logit_err": err,
           "max_abs_logit": float(clog.abs().max()),
           "seconds_host": time.perf_counter() - t0}
    emit("replay_phase", out)
    return out



# ------------------------------------------------------------------ step 9
def full_mix(torch, st, qi):
    """The query engine benchmark's full_mix spec, asked as object ``qi``."""
    from repro_torch.core.query import Query
    f = FULL_MIX
    return Query(embed=st.embed[qi],
                 near=(st.centroid[qi], torch.tensor(f["radius"])),
                 prox_weight=torch.tensor(f["prox_weight"]),
                 labels=f["labels"],
                 min_points=torch.tensor(f["min_points"], dtype=torch.int32),
                 min_obs=torch.tensor(f["min_obs"], dtype=torch.int32),
                 zones=f["zones"], grid=f["grid"], k=f["k"])


def np_oracle_full_mix(st, qi):
    """numpy flat sweep of full_mix (benchmarks/query_engine.py's
    ``_np_oracle_full_mix``): f32 scores, stable argsort.  -> top-k scores."""
    f = FULL_MIX
    host = {c: getattr(st, c).cpu().numpy() for c in
            ("active", "embed", "centroid", "label", "n_points", "obs_count")}
    qe, center = host["embed"][qi], host["centroid"][qi]
    sim = host["embed"] @ qe
    d = np.linalg.norm(host["centroid"] - center, axis=1)
    ok = (host["active"] & (d <= f["radius"])
          & np.isin(host["label"], np.asarray(f["labels"]))
          & (host["n_points"] >= f["min_points"])
          & (host["obs_count"] >= f["min_obs"]))
    score = np.where(ok, sim + np.float32(f["prox_weight"])
                     / (np.float32(1.0) + d), -np.inf).astype(np.float32)
    return score[np.argsort(-score, kind="stable")[:f["k"]]]


def oracle_parity(scores, oracle) -> bool:
    """The k scores equal the oracle's modulo tie order and f32 summation
    order (the benchmark's ``_oracle_parity``)."""
    s = np.sort(scores.cpu().numpy())[::-1]
    o = np.sort(oracle)[::-1]
    fin = np.isfinite(o)
    return bool(np.array_equal(fin, np.isfinite(s))
                and np.allclose(s[fin], o[fin], **ORACLE_TOL))


def same_topk(torch, a, b) -> float:
    """Checks equal oids and slots; returns the largest score difference
    (padded ranks, -inf in both, count as equal)."""
    check(torch.equal(a.oids.cpu(), b.oids.cpu()), "oids equal")
    check(torch.equal(a.slots.cpu(), b.slots.cpu()), "slots equal")
    sa, sb = a.scores.cpu(), b.scores.cpu()
    fin = torch.isfinite(sb)
    check(torch.equal(torch.isfinite(sa), fin), "padded ranks equal")
    return float((sa[fin] - sb[fin]).abs().max()) if bool(fin.any()) else 0.0


def clustered(n, dev, *, embed_dim, max_points, room, **_):
    from repro_torch.core.store import clustered_synthetic_store
    return clustered_synthetic_store(n, n, embed_dim, max_points, seed=0,
                                     room=room,
                                     n_hotspots=max(128, n // 2_000),
                                     device=dev)


def query_object(st) -> int:
    """The benchmark's query: the middle of the objects with label < 10."""
    lab_ok = np.nonzero(st.label.cpu().numpy() < 10)[0]
    return int(lab_ok[len(lab_ok) // 2])


def host_ms(torch, fn, reps):
    """Host-clock ms of ``reps`` calls, each ending in a synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def topk_spy(ops, fn, keep=lambda i: True, clone=True) -> list:
    """[(inputs or None, (scores, slots))] of every ops.query_topk_bias call
    ``fn`` makes, in order: each call's answer, and its inputs (qs, embeds,
    bias, k) where ``keep(i)`` picks the i-th call, cloned (``clone``) so a
    later in-place write to a store leaves them as the call read them.  The
    calls go through to the real wrapper: a launch count around ``fn``
    stays exact."""
    calls, real = [], ops.query_topk_bias

    def spy(qs, embeds, bias, k):
        args = None
        if keep(len(calls)):
            args = (qs.clone(), embeds.clone() if clone else embeds,
                    bias.clone(), k)
        out = real(qs, embeds, bias, k)
        calls.append((args, tuple(x.clone() for x in out)))
        return out
    ops.query_topk_bias = spy
    try:
        fn()
    finally:
        ops.query_topk_bias = real
    return calls


def captured_topk_calls(ops, fn) -> list:
    """(qs, embeds, bias, k) of every ops.query_topk_bias call ``fn``
    makes (these launches are extra: outside any counted window)."""
    return [args for args, _ in topk_spy(ops, fn, clone=False)]


def hold_topk_calls(torch, calls, where: str) -> dict:
    """The kernel against its plain version on every call of ``calls``
    (``topk_spy``'s list) whose inputs were kept, at the shapes the path
    gave it (a launch each, after the counted window): equal slots, scores
    within SCORE_TOL, and the answer the path got equal to both."""
    from repro_torch.kernels import query_topk as qt

    err, shapes, n = 0.0, set(), 0
    for args, (vals, slots) in calls:
        if args is None:
            continue
        qs, emb, bias, k = args
        gv, gi = qt.query_topk_bias_cuda(qs, emb, bias, k)
        wv, wi = qt.query_topk_bias_plain(qs, emb, bias, k)
        tag = (f"{where}: Q={qs.shape[0]} N={emb.shape[0]} "
               f"E={qs.shape[1]} k={k}")
        check(torch.equal(gi, wi) and torch.equal(slots.to(gi.device), gi),
              f"query_topk_bias slots != plain at {tag}")
        e = max(float((gv - wv).abs().max()),
                float((vals.to(gv.device) - wv).abs().max())) \
            if gv.numel() else 0.0
        check(e <= SCORE_TOL, f"query_topk_bias err {e} at {tag}")
        err, n = max(err, e), n + 1
        shapes.add(tag.split(": ", 1)[1])
    check(n > 0, f"{where}: no query_topk_bias call held to its plain version")
    return {"held": n, "max_abs_err": err, "shapes": sorted(shapes)}


def same_topk_answers(torch, a, b) -> float:
    """Max |score| difference between two runs' query_topk_bias answers
    (``topk_spy``'s lists), call by call; -1 when the call counts, shapes
    or slots differ."""
    if len(a) != len(b):
        return -1.0
    err = 0.0
    for (_, (av, ai)), (_, (bv, bi)) in zip(a, b):
        av, ai, bv, bi = av.cpu(), ai.cpu(), bv.cpu(), bi.cpu()
        if av.shape != bv.shape or not torch.equal(ai, bi):
            return -1.0
        if av.numel():
            err = max(err, float((av - bv).abs().max()))
    return err


def topk_time(torch, clock, qs, emb, bias, k, where):
    """The kernel against its plain version on one captured input, timed
    with the plain version, ``torch.topk`` of the same scores and the byte
    bound."""
    from repro_torch.kernels import query_topk as qt

    gv, gi = qt.query_topk_bias_cuda(qs, emb, bias, k)
    wv, wi = qt.query_topk_bias_plain(qs, emb, bias, k)
    torch.cuda.synchronize()
    Q, E = qs.shape
    N = emb.shape[0]
    tag = f"{where}: Q={Q} N={N} E={E} k={k}"
    check(torch.equal(gi, wi), f"query_topk_bias slots at {tag}")
    err = float((gv - wv).abs().max())
    check(err <= SCORE_TOL, f"query_topk_bias err {err} at {tag}")
    b_ms, b_by = bound(*topk_cost(Q, N, E, k))
    row = {"shape": tag, "max_abs_err": err,
           "included": int((bias > -5e29).sum()),
           "ms": clock.ms(lambda: qt.query_topk_bias_cuda(qs, emb, bias, k)),
           "plain_ms": clock.ms(
               lambda: qt.query_topk_bias_plain(qs, emb, bias, k)),
           "library_ms": clock.ms(lambda: torch.topk(qs @ emb.T + bias, k)),
           "bound_ms": b_ms, "bound_by": b_by}
    emit("query_topk_bias_index_time", row)
    return row


def stage_split(torch, search, fn, reps) -> dict:
    """Mean host ms a query of stage 1 (with the cells' host read), stage 2
    and the host work between (slab assembly, certificate): the stages
    wrapped in synchronizes for this window only."""
    acc = {"stage1": 0.0, "stage2": 0.0}
    real = {"stage1": search._stage1, "stage2": search._stage2}

    def timed(name):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run
    search._stage1, search._stage2 = timed("stage1"), timed("stage2")
    try:
        total = sum(host_ms(torch, fn, reps))
    finally:
        search._stage1, search._stage2 = real["stage1"], real["stage2"]
    out = {k: v / reps for k, v in acc.items()}
    out["host_between"] = total / reps - out["stage1"] - out["stage2"]
    return out


def index_phase(torch, dev, clock, *, n, reps, tombstones, moves, cross_n,
                **cfg):
    """The cluster index's certified two-stage query at the query engine's
    configuration, against the flat sweep and a numpy oracle; churn;
    the card against the CPU port at ``cross_n`` objects."""
    from repro_torch.core.query import execute_query
    from repro_torch.core.store import remove_objects
    from repro_torch.index import ClusterIndex, rebuilt, search
    from repro_torch.index.cluster import ClusterSummaries
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry, set_registry

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = clustered(n, dev, **cfg)
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t0
    qi = query_object(st)
    spec = full_mix(torch, st, qi)
    t0 = time.perf_counter()
    idx = ClusterIndex.for_target(st)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(idx.engaged(), "the index engages at this size")

    # the counted run: one two-stage query; stage 1 alone launches once
    reg = MetricsRegistry()
    prev = set_registry(reg)
    ops.reset_launch_counts()
    two = execute_query(st, spec, index=idx)
    torch.cuda.synchronize()
    set_registry(prev)
    counts = ops.launch_counts()
    escalations = reg.counter("query_index_escalations_total").total()
    rounds = 1 + escalations
    check(counts["query_topk_bias"] == 2 * rounds,
          f"query_topk_bias launched by stage 1 and stage 2 in each of "
          f"{rounds} rounds: {counts}")
    ops.reset_launch_counts()
    search._stage1(spec, idx.summaries, m=min(search._C0, idx.grid.n_cells),
                   has_obs=True, has_seen=True)
    torch.cuda.synchronize()
    check(ops.launch_counts()["query_topk_bias"] == 1,
          "stage 1 is one query_topk_bias launch")
    fraction = reg.histogram("query_index_candidate_fraction").summary()

    flat = execute_query(st, spec)
    err = same_topk(torch, two, flat)
    check(err <= SCORE_TOL, f"two-stage scores against flat: err {err}")
    oracle = np_oracle_full_mix(st, qi)
    check(oracle_parity(two.scores, oracle), "two-stage = numpy oracle")
    check(oracle_parity(flat.scores, oracle), "flat = numpy oracle")
    check(int(two.oids[0]) == qi + 1, "the query's own object ranks first")

    two_ms = host_ms(torch, lambda: execute_query(st, spec, index=idx), reps)
    flat_ms = host_ms(torch, lambda: execute_query(st, spec), reps)
    split = stage_split(torch, search,
                        lambda: execute_query(st, spec, index=idx), reps)
    emit("index_profile", {
        f"{name}_{PROFILE_QUERIES}_queries": profiled(torch, lambda: [
            execute_query(st, spec, index=i) for _ in range(PROFILE_QUERIES)])
        for name, i in (("two_stage", idx), ("flat", None))})

    # query_topk_bias at the index path's shapes: stage 1 (k = m = 64, and
    # the largest m the kernel takes), stage 2, the flat sweep
    s1, s2 = captured_topk_calls(
        ops, lambda: execute_query(st, spec, index=idx))[:2]
    (fl,) = captured_topk_calls(ops, lambda: execute_query(st, spec))
    topk_rows = [topk_time(torch, clock, *s1, "stage 1"),
                 topk_time(torch, clock, *s1[:3], idx.grid.n_cells,
                           "stage 1 at the largest m (every cell)"),
                 topk_time(torch, clock, *s2, "stage 2"),
                 topk_time(torch, clock, *fl, "flat sweep")]
    del s1, s2, fl
    peak = torch.cuda.max_memory_allocated()

    # churn: tombstones, then moves with a version bump, then refresh
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    remove_objects(st, rng.choice(np.arange(1, n + 1), tombstones,
                                  replace=False))
    slots = torch.from_numpy(rng.choice(n, moves, replace=False)).to(dev)
    st.centroid[slots] += torch.from_numpy(rng.normal(
        scale=8.0, size=(moves, 3)).astype(np.float32)).to(dev)
    st.version[slots] += 1
    changed = idx.refresh(st)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scratch = rebuilt(idx, st)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    equal = [torch.equal(a, b) for a, b in zip(idx.summaries,
                                               scratch.summaries)]
    check(all(equal), "incremental = rebuilt after churn on the card: "
          + str(dict(zip(ClusterSummaries._fields, equal))))
    check(torch.equal(idx.members, scratch.members),
          "member table = rebuilt after churn")
    del scratch
    err_churn = same_topk(torch, execute_query(st, spec, index=idx),
                          execute_query(st, spec))
    check(err_churn <= SCORE_TOL, f"two-stage = flat after churn: "
          f"{err_churn}")

    cross = index_cross_device(torch, dev, cross_n, cfg)
    out = {"objects": n, "embed_dim": cfg["embed_dim"],
           "n_cells": idx.grid.n_cells, "cell_cap": idx.cell_cap,
           "store_s_host": store_s, "build_s": build_s,
           "two_stage_ms_p50": float(np.percentile(two_ms, 50)),
           "two_stage_ms_p95": float(np.percentile(two_ms, 95)),
           "flat_ms_p50": float(np.percentile(flat_ms, 50)),
           "flat_ms_p95": float(np.percentile(flat_ms, 95)),
           "split_ms_mean": split,
           "escalations": escalations,
           "candidate_fraction": fraction["mean"],
           "two_stage_vs_flat_max_abs_err": err,
           "churn": {"tombstones": tombstones, "moves": moves,
                     "changed_slots": changed, "refresh_s": refresh_s,
                     "rebuild_s": rebuild_s},
           "max_memory_allocated_bytes": peak,
           "launches": counts, "cross_device": cross}
    emit("index_phase", out)
    return out, st, idx, topk_rows


def index_cross_device(torch, dev, n, cfg) -> dict:
    """The same build and query on the card and on the CPU port: equal
    member tables and exact summary fields, float fields within SUMM_TOL,
    equal results."""
    from repro_torch.core.query import execute_query
    from repro_torch.index import ClusterIndex

    built = {}
    for d in (dev, "cpu"):
        st = clustered(n, d, **cfg)
        built[str(d)] = (st, ClusterIndex.for_target(st))
    (gst, gidx), (cst, cidx) = built[str(dev)], built["cpu"]
    check(gidx.grid == cidx.grid and gidx.cell_cap == cidx.cell_cap,
          "grid and cell_cap, card vs CPU")
    check(np.array_equal(gidx._members, cidx._members)
          and torch.equal(gidx.members.cpu(), cidx.members),
          "member tables, card vs CPU")
    errs = {}
    for f, g in gidx.summaries._asdict().items():
        c = getattr(cidx.summaries, f)
        if f in ("centroid", "embed_mean", "res_max"):
            diff = (g.cpu() - c).abs()
            errs[f] = float(diff.max())
            check(bool((diff <= SUMM_TOL + SUMM_TOL * c.abs()).all()),
                  f"summaries.{f} card vs CPU {errs[f]}")
        else:
            check(torch.equal(g.cpu(), c), f"summaries.{f} card vs CPU")
    qi = query_object(cst)
    err = same_topk(torch, execute_query(gst, full_mix(torch, gst, qi),
                                         index=gidx),
                    execute_query(cst, full_mix(torch, cst, qi), index=cidx))
    check(err <= SCORE_TOL, f"two-stage card vs CPU scores err {err}")
    return {"objects": n, "n_cells": gidx.grid.n_cells,
            "summary_max_abs_err": errs, "score_max_abs_err": err}


# ----------------------------------------------------------------- step 10
def serving_phase(torch, dev, st, idx, *, requests, batch_size):
    """Batched full_mix requests through BatchScheduler and the query step
    function over step 9's store and index, blocking and not; each result
    equal to the same request run alone."""
    from repro_torch.core.query import execute_query
    from repro_torch.kernels import ops
    from repro_torch.serving.batching import (BatchScheduler,
                                              make_query_step_fn,
                                              resolve_results)

    rng = np.random.default_rng(3)
    lab_ok = np.nonzero(st.label.cpu().numpy() < 10)[0]
    specs = [full_mix(torch, st, int(q))
             for q in rng.choice(lab_ok, requests, replace=False)]
    alone = [execute_query(st, s, index=idx) for s in specs]
    out = {"requests": requests, "batch_size": batch_size}
    for block in (True, False):
        fn = make_query_step_fn(lambda: st, pad_to=batch_size, block=block,
                                get_index=lambda: idx)
        step_ms = []

        def step_fn(payloads, fn=fn, step_ms=step_ms):
            t0 = time.perf_counter()
            res = fn(payloads)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return res
        sched = BatchScheduler(batch_size=batch_size, step_fn=step_fn)
        rids = [sched.submit(s) for s in specs]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = sched.drain()
        torch.cuda.synchronize()
        if not block:
            resolve_results(done)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(counts["query_topk_bias"] > 0,
              "query_topk_bias launched on the serving path")
        err = 0.0
        for rid, want in zip(rids, alone):
            got = done[rid]
            check(np.array_equal(got.oids, want.oids.cpu().numpy())
                  and np.array_equal(got.slots, want.slots.cpu().numpy()),
                  f"request {rid} batched = alone (block={block})")
            w = want.scores.cpu().numpy()
            fin = np.isfinite(w)
            check(np.array_equal(np.isfinite(got.scores), fin),
                  f"request {rid} padded ranks")
            if fin.any():
                err = max(err, float(np.abs(got.scores[fin] - w[fin]).max()))
        check(err <= SCORE_TOL, f"batched scores err {err}")
        out["blocking" if block else "non_blocking"] = {
            "requests_per_s": requests / wall, "wall_s": wall,
            "steps": len(step_ms),
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "max_abs_err_vs_alone": err, "launches": counts}
    emit("serving_phase", out)
    return out


# ----------------------------------------------------------------- step 11
def mapping_arms_phase(torch, dev, *, embed_dim, n_objects, n_frames,
                       keyframe_interval, h, w):
    """The four Fig. 3 arms on the card and on the CPU port with the same
    host-drawn noise: equal stores, class accuracy, per-stage walls, and
    lift_compact launched once per keyframe in the SD arms only."""
    from repro_torch.core import Knobs, MappingServer, Query
    from repro_torch.core.query import execute_query
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.kernels import ops
    from repro_torch.perception.embedder import OracleEmbedder

    scene = make_scene(n_objects=n_objects, seed=0)
    classes = {o.oid: o.class_id for o in scene.objects}
    frames = list(scene_stream(scene, n_frames=n_frames,
                               keyframe_interval=keyframe_interval, h=h, w=w))
    D = ARM_KNOBS["max_detections_per_frame"]
    gen = torch.Generator().manual_seed(0)
    noises = [torch.randn((D, embed_dim), generator=gen) for _ in frames]
    emb = OracleEmbedder(embed_dim=embed_dim)
    gt = sorted({o.class_id for o in scene.objects})

    def run(mode, instrument, device):
        kn = dict(ARM_KNOBS)
        if mode != "semanticxr":
            kn["max_object_points_server"] = 2048
        srv = MappingServer(knobs=Knobs(**kn), embedder=emb, mode=mode,
                            instrument=instrument, device=device)
        times = [srv.process_frame(fr, classes, z)
                 for fr, z in zip(frames, noises)]
        return srv, times

    out = {"reference_cpu_container_gate": REFERENCE_GATE}
    for label, mode, instrument in ARM_MODES:
        ops.reset_launch_counts()
        srv, times = run(mode, instrument, dev)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        mapped = sum(t.ingest_ms > 0 or t.embed_ms > 0 for t in times)
        want = mapped if mode == "semanticxr" else 0
        check(counts["lift_compact"] == want,
              f"{label}: {counts['lift_compact']} lift_compact launches for "
              f"{mapped} mapped keyframes (want {want})")
        cpu, _ = run(mode, instrument, "cpu")
        errs = {}
        for f, v in cpu.store._asdict().items():
            g = getattr(srv.store, f).cpu()
            if v.is_floating_point():
                errs[f] = float((g - v).abs().max())
                check(errs[f] <= LIFT_TOL, f"{label} store.{f} card vs CPU "
                      f"{errs[f]}")
            else:
                check(torch.equal(g, v), f"{label} store.{f} card vs CPU")
        act = srv.store.active.cpu().numpy()
        lab = srv.store.label.cpu().numpy()
        hits = 0
        for c in gt:
            s = int(execute_query(srv.store, Query(
                embed=emb.embed_text(c, dev), k=5)).slots[0])
            hits += bool(s >= 0 and act[s] and lab[s] == c)
        macc = hits / len(gt)
        check(macc >= 0.9, f"{label} top-1 class accuracy {macc}")
        warm = times[2:]
        stages = ("embed", "lift", "associate") if label != \
            "B+P+SD (fused)" else ("ingest",)
        out[label] = {
            "n_mapped": int(act.sum()), "mAcc": 100.0 * macc,
            "keyframes": len(frames), "mapped_keyframes": mapped,
            "stage_ms_mean": {
                st: float(np.mean([getattr(t, f"{st}_ms") for t in warm]))
                for st in ("detect",) + stages},
            "max_abs_err_vs_cpu": errs, "launches": counts}
    emit("mapping_arms_phase", out)
    return out

# ----------------------------------------------------------------- step 12
def fleet_sweep(torch, dev, *, sweep, n_obj, cap, E, P, budget, reps,
                shards):
    """benchmarks/fleet_scale.py at one configuration: tick ms (p50, p95)
    of a SessionManager collect for C clients, every rep from the same
    ``fresh`` sync row (which must stay zero: the collect returns new
    tensors), per-client bytes and objects; and at C >= ``shards`` the
    mesh tier of ``shards`` parts against the unsharded tier on fresh
    sessions, byte for byte."""
    from repro_torch.core import Knobs
    from repro_torch.core.store import synthetic_store
    from repro_torch.server import (ClientRoster, MeshSessionTier,
                                    SessionManager)

    kn = Knobs(server_capacity=cap, client_capacity=max(budget * 2, 64),
               max_object_points_server=P,
               max_object_points_client=max(P // 4, 16),
               min_obs_before_sync=1)
    store = synthetic_store(n_obj, cap, E, P, device=dev)
    out = {}
    for C in sweep:
        sm = SessionManager(knobs=kn, n_clients=C, capacity=cap,
                            budget=budget, device=dev)
        fresh = torch.zeros((C, cap), dtype=torch.int32, device=dev)

        def tick_once(sm=sm, fresh=fresh):
            sm.sync = sm.sync._replace(synced_version=fresh)
            return sm.collect(store)
        for _ in range(2):
            tick_once()
        ms = host_ms(torch, tick_once, reps if C <= 256 else
                     max(reps // 2, 3))
        pkt = tick_once()
        check(not bool(fresh.any()), f"C={C}: the collect wrote the "
              "caller's sync tensor")
        row = {"tick_ms_p50": float(np.percentile(ms, 50)),
               "tick_ms_p95": float(np.percentile(ms, 95)),
               "per_client_bytes": float(pkt.nbytes.mean()),
               "objects_per_client": float(pkt.counts.mean())}
        if C >= shards:
            roster = ClientRoster.round_robin(C, shards)
            tier = MeshSessionTier(knobs=kn, capacity=cap, roster=roster,
                                   budget=budget, device=dev)
            tier.set_all(subscribed=np.ones((C,), bool))
            ref = SessionManager(knobs=kn, n_clients=C, capacity=cap,
                                 budget=budget, device=dev)
            a, b = tier.collect(store), ref.collect(store)
            same = all(np.array_equal(getattr(a, f), getattr(b, f))
                       for f in ("counts", "nbytes", "seqs"))
            for part, members in zip(a.parts, roster.members):
                m = torch.from_numpy(members).to(dev)
                same &= part is not None and all(
                    torch.equal(x, y[m]) for x, y in zip(part.batch,
                                                         b.batch))
            check(same, f"mesh tier ({shards} parts) = unsharded at C={C}")
            row["mesh_byte_identical"] = same
            row["tick_ms_mesh_p50"] = float(np.percentile(host_ms(
                torch, lambda tier=tier: tier.collect(store), 3), 50))
        out[C] = row
    return out


def fleet_digest(packets, C) -> list:
    """Per zone packet of one tick: nbytes and seqs, and each client's
    count, crc32, ids, versions, points and centroids (host copies)."""
    out = []
    for z, pkt in packets:
        rows = []
        for c in range(C):
            u = pkt.packet_for(c)
            if not u.count:
                rows.append(None)
                continue
            b = u.batch
            n = u.count
            rows.append((u.seq, u.epoch, u.checksum,
                         b.oid[:n].cpu().numpy(),
                         b.version[:n].cpu().numpy(),
                         b.n_points[:n].cpu().numpy(),
                         b.points[:n].cpu().numpy(),
                         b.centroid[:n].cpu().numpy()))
        out.append((z, pkt.nbytes.tolist(), pkt.seqs.tolist(), rows))
    return out


def same_digest(a, b) -> bool:
    """Two runs' digests (per tick, per zone packet): ids, versions,
    counts, seqs, crc32 and bytes exactly; points to one f16 ulp;
    centroids within rtol = atol = SUMM_TOL."""
    if [len(t) for t in a] != [len(t) for t in b]:
        return False
    for (za, na, sa, ra), (zb, nb, sb, rb) in zip(
            [e for t in a for e in t], [e for t in b for e in t]):
        if (za, na, sa) != (zb, nb, sb) or len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if (x is None) != (y is None):
                return False
            if x is None:
                continue
            if x[:3] != y[:3] or not all(np.array_equal(p, q) for p, q in
                                         zip(x[3:6], y[3:6])):
                return False
            ulp = np.abs(x[6].view(np.int16).astype(np.int32)
                         - y[6].view(np.int16).astype(np.int32))
            if ulp.max(initial=0) > 1 or not np.allclose(
                    x[7], y[7], rtol=SUMM_TOL, atol=SUMM_TOL):
                return False
    return True


def fleet_twins(torch, dev, *, n_objects, embed_dim, pairs, ticks, settle,
                transient, churn, radius, faults, seed=0):
    """FleetServer end to end: ``pairs`` pose twins, one on a clean link and
    one on a FaultModel link, through ``ticks`` ticks of churn (removals,
    version-bumped moves inside a zone, transients promoted past min_obs,
    tombstones released once no subscriber owes an ack) and ``settle``
    clean ticks;
    clean twins acked through ``ack_tick``, faulty ones through ``ack``
    (with uplink loss) and ``request_resync``.  Returns the per-tick packet
    digests, each twin's map ({oid: version}), the faulty clients' counters
    and the server."""
    from repro_torch.core import (ClientSession, DeviceClient, FaultModel,
                                  Knobs, NetworkModel)
    from repro_torch.core.store import (release_tombstones, remove_objects,
                                        synthetic_store, tombstone_slots)
    from repro_torch.server import FleetServer, ZoneGrid

    kn = Knobs()
    C = 2 * pairs
    rng = np.random.default_rng(seed)
    st = synthetic_store(n_objects, kn.server_capacity, embed_dim,
                         kn.max_object_points_server, seed=seed, device=dev)
    transients = np.nonzero(rng.random(n_objects) < transient)[0]
    st.obs_count[torch.from_numpy(transients).to(dev)] = 1
    grid = ZoneGrid.for_room(8.0, 2, 2)
    fs = FleetServer(knobs=kn, embed_dim=embed_dim, n_clients=C, grid=grid,
                     proto=True, device=dev)
    fm = FaultModel(seed=seed, **faults)
    centers = np.array([[-2, 1.5, -2], [-2, 1.5, 2], [2, 1.5, -2],
                        [2, 1.5, 2]], np.float32)
    poses = np.stack([centers[c % 4] + [0.1 * (c // 4), 0.0, 0.0]
                      for c in range(pairs)] * 2).astype(np.float32)
    sess = [ClientSession(dev=DeviceClient(knobs=kn, embed_dim=embed_dim,
                                           device=dev),
                          net=NetworkModel(), knobs=kn, cid=c,
                          user_pos=torch.from_numpy(poses[c]).to(dev),
                          faults=None if c < pairs else fm)
            for c in range(C)]
    clean = np.arange(C) < pairs
    up = np.ones((C,), bool)
    fs.refresh(st)
    for c in range(C):
        fs.join(c, poses[c], radius, tick=0)
    digests = []
    promoted = list(rng.permutation(transients))
    for t in range(ticks + settle):
        if t < ticks:
            live = np.nonzero(st.active.cpu().numpy())[0]
            remove_objects(st, st.ids.cpu().numpy()[
                rng.choice(live, churn, replace=False)])
            # moves stay inside their zone: a move across a zone boundary
            # frees the old shard's slot without a tombstone, so a client
            # that had received the object keeps it (ROADMAP.md section 4)
            act = np.nonzero(st.active.cpu().numpy())[0]
            cand = rng.choice(act, 4 * churn, replace=False)
            old = st.centroid.cpu().numpy()[cand]
            new = old + rng.normal(scale=0.3, size=old.shape).astype(
                np.float32)
            keep = np.nonzero(grid.zone_of(new) == grid.zone_of(old))[0]
            keep = keep[:churn]
            mv = torch.from_numpy(cand[keep]).to(dev)
            st.centroid[mv] = torch.from_numpy(new[keep]).to(dev)
            st.version[mv] += 1
            pr = torch.from_numpy(np.asarray(
                [promoted.pop() for _ in range(min(churn, len(promoted)))],
                np.int64)).to(dev)
            st.obs_count[pr] = 2
            st.version[pr] += 1
        elif t == ticks:
            for s in sess[pairs:]:
                s.faults = None                    # the settle: clean links
        fs.refresh(st)
        pk = fs.tick(up, tick=t)
        digests.append(fleet_digest(pk, C))
        for c, s in enumerate(sess):
            for _, p in pk or [(None, None)]:
                s.step(float(t), None if p is None else p.packet_for(c))
        fs.ack_tick([(z, dataclasses.replace(p, seqs=np.where(
            clean, p.seqs, -1))) for z, p in pk], tick=t)
        for c in range(pairs, C):
            for z, ep, sq in sess[c].drain_acks():
                if sess[c].faults is None or not fm.uplink_lost(0, c, t, z,
                                                                sq):
                    fs.ack(c, z, ep, sq, tick=t)
            for _, z in sess[c].drain_ctrl():
                fs.request_resync(c)
        for s in sess[:pairs]:
            s.drain_acks()
        fs.maintain(tick=t, deliverable=up, retx_ticks=fm.retx_ticks)
        blocked = fs.blocked_tombstone_oids(tick=t)
        ids = st.ids.cpu().numpy()
        rel = [sl for sl in tombstone_slots(st)
               if int(ids[sl]) not in blocked]
        if rel:
            release_tombstones(st, np.asarray(rel))
    maps = []
    for s in sess:
        m = s.dev.local
        a = m.active.cpu().numpy()
        maps.append(dict(zip(m.ids.cpu().numpy()[a].tolist(),
                             m.version.cpu().numpy()[a].tolist())))
    counters = [{k: getattr(s, k) for k in ("lost", "dup_drops",
                                            "corrupt_drops", "stale_drops",
                                            "resyncs", "delivered")}
                for s in sess[pairs:]]
    return digests, maps, counters, fs


def zoned_mirror(torch, dev, st, n, cfg):
    """Step 9's store mirrored into a 2x2 ZoneShardedStore on the query
    engine benchmark's grid (room 80 m, zone capacity 2n / 4) with one
    ClusterIndex per zone.  Returns (zoned, mirror s, per-zone build s)."""
    from repro_torch.core import Knobs
    from repro_torch.index import cluster
    from repro_torch.server import ZoneGrid, ZoneShardedStore

    zoned = ZoneShardedStore(knobs=Knobs(server_capacity=n),
                             embed_dim=cfg["embed_dim"],
                             grid=ZoneGrid.for_room(cfg["room"], 2, 2),
                             max_points=cfg["max_points"], device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    zoned.refresh_from(st)
    sync()
    mirror_s = time.perf_counter() - t0
    build_s, real = [], cluster.ClusterIndex.refresh

    def timed_refresh(self, target):
        t0 = time.perf_counter()
        out = real(self, target)
        sync()
        build_s.append(time.perf_counter() - t0)
        return out
    cluster.ClusterIndex.refresh = timed_refresh
    try:
        zoned.enable_index()
    finally:
        cluster.ClusterIndex.refresh = real
    return zoned, mirror_s, build_s


def fleet_phase(torch, dev, st, *, sweep_full, sweep_default, twins, index):
    """Step 12: the fleet tier on the card.  (a) the fleet_scale sweep,
    (b) FleetServer end to end with faulty / clean twins against the CPU
    port, (c) the zone-sharded full_mix at step 9's 1,000,000 objects."""
    from repro_torch.core.query import Query, compile_query, execute_query
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry, set_registry

    out = {}
    # (a) session-tier sweep
    t0 = time.perf_counter()
    full = fleet_sweep(torch, dev, **sweep_full)
    default = fleet_sweep(torch, dev, **sweep_default)
    for C in (1, 8, 64, 256):
        b = default[C]["per_client_bytes"]
        check(b == FLEET_BYTES, f"per_client_bytes {b} at C={C} on the "
              f"default configuration (want {FLEET_BYTES})")
    out["sweep_full"] = full
    out["sweep_default"] = default
    out["sweep_s"] = time.perf_counter() - t0
    # a fenced span around one collect waits on the card's queued work
    from repro_torch.core import Knobs
    from repro_torch.core.store import synthetic_store
    from repro_torch.obs import Tracer, set_tracer
    from repro_torch.server import SessionManager
    sm = SessionManager(knobs=Knobs(), n_clients=64, capacity=512,
                        budget=32, device=dev)
    tr = Tracer(fenced=True)
    prev = set_tracer(tr)
    try:
        sm.collect(synthetic_store(256, 512, 256, 64, device=dev))
    finally:
        set_tracer(prev)
    check(len(tr.durations_ms("session.collect_fleet")) == 1,
          "a fenced collect span")
    out["fenced_collect_ms"] = tr.durations_ms("session.collect_fleet")[0]

    # (b) FleetServer end to end, card and CPU port
    t0 = time.perf_counter()
    dg, maps, counters, fs = fleet_twins(torch, dev, **twins)
    card_s = time.perf_counter() - t0
    pairs = twins["pairs"]
    for c in range(pairs):
        check(maps[c] == maps[c + pairs] and len(maps[c]) > 0,
              f"faulty twin {c + pairs} converged to clean twin {c}")
    t0 = time.perf_counter()
    dg_cpu, maps_cpu, counters_cpu, fs_cpu = fleet_twins(
        torch, torch.device("cpu"), **twins)
    cpu_s = time.perf_counter() - t0
    check(same_digest(dg, dg_cpu), "card = CPU port packets, tick by tick")
    check(maps == maps_cpu and counters == counters_cpu,
          "card = CPU port maps and fault counters")
    launches = {}
    for name, kw in (
            ("zones=(3,)", dict(zones=(3,), grid=Query.grid_of(fs.grid))),
            ("near two zones", dict(near=(torch.tensor([-2.0, 1.5, 0.0]),
                                          torch.tensor(1.0)))),
            ("all zones", {})):
        spec = Query(embed=fs.zoned.zones[0].embed[0], k=5, **kw)
        shards = compile_query(spec, fs.zoned).shards
        ops.reset_launch_counts()
        got = fs.query(spec)
        torch.cuda.synchronize()
        n = ops.launch_counts()["query_topk_bias"]
        check(n == len(shards), f"FleetServer.query {name}: {n} launches "
              f"for {len(shards)} flat shards")
        want = fs_cpu.query(Query(embed=fs_cpu.zoned.zones[0].embed[0], k=5,
                                  **kw))
        same_topk(torch, got, want)
        launches[name] = {"shards": list(shards), "launches": n}
    out["fleet_server"] = {
        "clients": 2 * pairs, "ticks": twins["ticks"],
        "settle": twins["settle"], "objects": twins["n_objects"],
        "twins_converged": True, "card_eq_cpu_port": True,
        "map_sizes": [len(m) for m in maps],
        "packets": sum(len(d) for d in dg),
        "faulty_counters": counters, "card_s": card_s, "cpu_port_s": cpu_s,
        "query_launches": launches}

    # (c) the zone-sharded full_mix at 1M objects
    qi = query_object(st)
    spec = full_mix(torch, st, qi)
    zoned, mirror_s, build_s = zoned_mirror(torch, dev, st, index["n"],
                                            index)
    capz = zoned.zone_capacity
    plan = compile_query(spec, zoned)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    ops.reset_launch_counts()
    got = plan(zoned)
    torch.cuda.synchronize()
    set_registry(prev)
    n_launch = ops.launch_counts()["query_topk_bias"]
    rounds = len(plan.shards) \
        + reg.counter("query_index_escalations_total").total()
    engaged = all(zoned.indexes[z].engaged() for z in plan.shards)
    check(engaged, "every zone index engages at 1M")
    check(n_launch == 2 * rounds, f"sharded full_mix: {n_launch} "
          f"query_topk_bias launches for {rounds} two-stage rounds")
    flat = execute_query(st, spec)
    check(torch.equal(got.oids.cpu(), flat.oids.cpu()),
          "zoned full_mix oids = step 9's flat sweep")
    fin = torch.isfinite(flat.scores)
    err = float((got.scores[fin] - flat.scores[fin]).abs().max())
    check(err <= SCORE_TOL and torch.equal(torch.isfinite(got.scores), fin),
          f"zoned full_mix scores err {err}")
    for r in range(got.slots.shape[0]):
        g = int(got.slots[r])
        if g >= 0:
            z, loc = divmod(g, capz)
            check(int(zoned.zones[z].ids[loc]) == int(got.oids[r]),
                  "global slot = zone * zone_capacity + slot")
    ms = host_ms(torch, lambda: plan(zoned), index["reps"])
    zone_objects = [int(z.active.sum()) for z in zoned.zones]
    del zoned, plan
    geom = {k: index[k] for k in ("embed_dim", "max_points", "room")}
    (gst, gz), (cst, cz) = [
        (x, zoned_mirror(torch, d, x, index["cross_n"], index)[0])
        for d in (dev, torch.device("cpu"))
        for x in (clustered(index["cross_n"], d, **geom),)]
    qc = query_object(cst)
    cg = compile_query(full_mix(torch, gst, qc), gz)(gz)
    cc = compile_query(full_mix(torch, cst, qc), cz)(cz)
    cross = {"objects": index["cross_n"],
             "score_max_abs_err": same_topk(torch, cg, cc)}
    check(cross["score_max_abs_err"] <= SCORE_TOL, "zoned card = CPU port")
    out["sharded_query"] = {
        "objects": index["n"], "zones": 4, "zone_capacity": capz,
        "zone_objects": zone_objects,
        "mirror_s": mirror_s, "build_s_per_zone": build_s,
        "ms_p50": float(np.percentile(ms, 50)),
        "ms_p95": float(np.percentile(ms, 95)),
        "launches": n_launch, "rounds": rounds,
        "max_abs_err_vs_flat": err, "cross_device": cross}
    emit("fleet_phase", out)
    return out


# ---------------------------------------------------------------- build
# ----------------------------------------------------------------- step 13
def tick_ms(wall_ms) -> dict:
    return {"ticks": len(wall_ms),
            "tick_ms_p50": float(np.percentile(wall_ms, 50)),
            "tick_ms_p95": float(np.percentile(wall_ms, 95))}


def span_split(tracer, n_ticks: int) -> dict:
    """Host ms a tick in each traced span name (spans nest: an inner span's
    time is inside its parent's)."""
    acc = {}
    for name, _, t0, t1, _, _ in tracer.events:
        acc[name] = acc.get(name, 0.0) + (t1 - t0) * 1e3
    return {k: v / n_ticks for k, v in sorted(acc.items())}


def converged(eng) -> bool:
    """Every client's map holds exactly the world's live set."""
    live = eng.world.live_ids()
    return all(set(m.ids.cpu().numpy()[m.active.cpu().numpy()].tolist())
               == live for m in (s.dev.local for s in eng.sessions.values()))


def network_drop_run(torch, dev, cfg, noise=None):
    """examples/network_drop_session.py's scenario on ``dev``: the mapper
    over the 240x320 keyframes, the stream cut after tick 8."""
    from repro_torch.core import Knobs, MappingServer
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.perception.embedder import OracleEmbedder
    from repro_torch.sim import (ClientSpec, GridSpec, NetTrace, ObjectEvent,
                                 PoseTrack, QueryPlan, Scenario,
                                 ScenarioEngine)

    scene = make_scene(n_objects=cfg["n_objects"], seed=cfg["scene_seed"])
    classes = {o.oid: o.class_id for o in scene.objects}
    E = cfg["embed_dim"]
    emb = OracleEmbedder(embed_dim=E)
    kn = Knobs(**cfg["knobs"])
    srv = MappingServer(knobs=kn, embedder=emb, device=dev)
    frames = list(scene_stream(scene, n_frames=cfg["n_frames"],
                               keyframe_interval=cfg["keyframe_interval"],
                               h=cfg["h"], w=cfg["w"]))
    sc = Scenario(
        seed=0, n_ticks=len(frames), tick_s=1.0, embed_dim=E, knobs=kn,
        grid=GridSpec(room=scene.room_size, nx=1, nz=1), budget=64,
        clients=(ClientSpec(
            cid=0, net=NetTrace(rtt_ms=20.0, outages=((4.0, 8.0),)),
            track=PoseTrack(anchor=(0.0, 1.5, 0.0), orbit_radius=0.0),
            subscribe_radius=scene.room_size),),
        events=(ObjectEvent(tick=9, kind="remove", oid=1),
                ObjectEvent(tick=9, kind="remove", oid=2)),
        query=QueryPlan(prob=0.6, radius=scene.room_size, k=3))
    eng = ScenarioEngine(sc, mapper=srv,
                         frames=frames[:cfg["stream_ticks"]],
                         classes=classes, embedder=emb, noise=noise,
                         device=dev)
    return eng.run(), eng


def sim_phase(torch, dev, *, deployment):
    """Step 13: the scenario engine on the card.  (a) The golden churn
    scenario: the committed snapshot, card = card, card = CPU port,
    ``async_loop`` = sequential.  (b) scenario_suite's arms: the
    reference's sent bytes on small and mid, large = CPU port; engine tick
    ms.  (c) fault_tolerance's loss sweep and crash arm: the reference's
    down bytes, every arm converged.  (d) The network-drop session, card =
    CPU port with the same host-drawn noise, every SQ / LQ answer = the CPU
    port's and held to the plain version; one lift_compact launch per
    mapped keyframe and one query_topk_bias launch per SQ and LQ.  (e)
    FleetSimulator at the paper's deployment over step 3's keyframes:
    stats, tick ms, both kernels launched, every query_topk_bias call
    held to the plain version, the card's MetricsLog and SQ answers
    = the CPU port's over the first ticks."""
    from repro_torch.core import Knobs, MappingServer
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry, set_registry
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.perception.embedder import OracleEmbedder
    from repro_torch.server import FleetSimulator, ZoneGrid
    from repro_torch.serving.batching import resolve_results
    from repro_torch.sim import (CrashEvent, FaultModel, MetricsLog,
                                 ScenarioEngine, churn_scenario,
                                 run_scenario)

    cpu = torch.device("cpu")
    out = {}

    # (a) the golden churn scenario
    sc = churn_scenario(**GOLDEN)
    t0 = time.perf_counter()
    card = run_scenario(sc, device=dev)
    card_s = time.perf_counter() - t0
    again = run_scenario(sc, device=dev)
    overlapped = run_scenario(sc, device=dev, async_loop=True)
    t0 = time.perf_counter()
    host = run_scenario(sc, device=cpu)
    cpu_s = time.perf_counter() - t0
    try:
        card.assert_matches_snapshot(json.loads(GOLDEN_SNAPSHOT.read_text()))
    except AssertionError as e:
        check(False, f"golden: {e}")
    check(card.equals(again), f"golden: card != card in {card.diff(again)}")
    check(card.equals(host), f"golden: card != CPU port in {card.diff(host)}")
    check(card.equals(overlapped),
          f"golden: async_loop != sequential in {card.diff(overlapped)}")
    out["golden"] = {"summary": card.summary(), "card_s": card_s,
                     "cpu_s": cpu_s}

    # (b) scenario_suite's arms
    out["suite"] = {}
    for name, kw, want in SUITE:
        kn = Knobs(**SUITE_KNOBS) if name == "large" else None
        sc = churn_scenario(knobs=kn, **kw)
        eng = ScenarioEngine(sc, device=dev)
        t0 = time.perf_counter()
        log = eng.run()
        row = {"card_s": time.perf_counter() - t0, **tick_ms(eng.wall_ms),
               "sent_bytes_total": log.summary()["exact"]["sent_bytes_total"],
               "converged": converged(eng)}
        check(row["converged"], f"scenario_suite {name}: converged")
        if want is not None:
            check(row["sent_bytes_total"] == want,
                  f"scenario_suite {name}: sent_bytes_total "
                  f"{row['sent_bytes_total']} != {want}")
        else:
            t0 = time.perf_counter()
            host = run_scenario(sc, device=cpu)
            row["cpu_s"] = time.perf_counter() - t0
            check(log.equals(host), f"scenario_suite {name}: card != CPU "
                  f"port in {log.diff(host)}")
        out["suite"][name] = row

    # (c) fault_tolerance's arms
    out["fault_tolerance"] = {}
    for loss, crash, want in FAULT_ARMS:
        crashes = (CrashEvent(tick=FAULT_SHAPE["n_ticks"] // 2, cid=1,
                              down_ticks=2),) if crash else ()
        eng = ScenarioEngine(churn_scenario(
            faults=FaultModel(seed=30, loss_prob=loss),
            crash_events=crashes, **FAULT_SHAPE), device=dev)
        log = eng.run()
        s = log.summary()["exact"]
        name = f"crash+loss={loss:g}" if crash else f"loss={loss:g}"
        row = {"down_bytes": s["sent_bytes_total"],
               "up_bytes": s["up_bytes_total"],
               "packets_lost": s["packets_lost"],
               "resync_requests": s["resync_requests"],
               "converged": converged(eng), **tick_ms(eng.wall_ms)}
        check(row["converged"], f"fault_tolerance {name}: converged")
        check(row["down_bytes"] == want, f"fault_tolerance {name}: "
              f"down_bytes {row['down_bytes']} != {want}")
        out["fault_tolerance"][name] = row

    # (d) the network-drop session; every SQ / LQ answer is recorded on
    # both devices (the mapper path scores no hit against a world)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    ops.reset_launch_counts()
    run = {}
    calls = topk_spy(ops, lambda: run.update(
        card=network_drop_run(torch, dev, NETWORK_DROP)))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    set_registry(prev)
    log, eng = run["card"]
    mapped = reg.histogram("mapping_stage_ms").count(stage="ingest",
                                                     mode="semanticxr")
    s = log.summary()["exact"]
    t0 = time.perf_counter()
    host_calls = topk_spy(ops, lambda: run.update(
        cpu=network_drop_run(torch, cpu, NETWORK_DROP)), keep=lambda i: False)
    cpu_s = time.perf_counter() - t0
    host = run["cpu"][0]
    check(log.equals(host),
          f"network drop: card != CPU port in {log.diff(host)}")
    answers_err = same_topk_answers(torch, calls, host_calls)
    check(0.0 <= answers_err <= SCORE_TOL,
          f"network drop: card's SQ / LQ answers != the CPU port's "
          f"(err {answers_err})")
    held = hold_topk_calls(torch, calls, "network drop")
    check(mapped > 0 and counts["lift_compact"] == mapped,
          f"network drop: {counts['lift_compact']} lift_compact launches "
          f"for {mapped} mapped keyframes")
    queries = s["sq_queries"] + s["lq_queries"]
    check(s["sq_queries"] > 0 and s["lq_queries"] > 0
          and counts["query_topk_bias"] == queries,
          f"network drop: {counts['query_topk_bias']} query_topk_bias "
          f"launches for {s['sq_queries']} SQ + {s['lq_queries']} LQ")
    check(int(log.sent_tomb_bytes[9:].sum()) == 18,
          "network drop: two 9-byte tombstones on the wire")
    out["network_drop"] = {"summary": s, "mapped_keyframes": mapped,
                           "launches": counts, "cpu_s": cpu_s,
                           "answers_max_err_vs_cpu": answers_err,
                           "held_to_plain": held,
                           **tick_ms(eng.wall_ms)}

    # (e) FleetSimulator at the paper's deployment
    kn, E = Knobs(), deployment["embed_dim"]
    scene = make_scene(n_objects=deployment["n_objects"], seed=0)
    classes = {o.oid: o.class_id for o in scene.objects}
    frames = list(scene_stream(
        scene, n_frames=deployment["n_frames"],
        keyframe_interval=deployment["keyframe_interval"],
        h=deployment["h"], w=deployment["w"]))
    emb = OracleEmbedder(embed_dim=E)
    grid = ZoneGrid.for_room(scene.room_size, 2, 2)
    mk = lambda d: FleetSimulator(                         # noqa: E731
        knobs=kn, embed_dim=E, n_clients=FLEET_SIM["n_clients"],
        seed=FLEET_SIM["seed"], grid=grid, device=d)
    sim = mk(dev)
    tracer = Tracer()                    # unfenced: host wall per span
    prev = set_tracer(tracer)
    ops.reset_launch_counts()
    run = {}
    t0 = time.perf_counter()
    calls = topk_spy(ops, lambda: run.update(stats=sim.run(
        n_ticks=len(frames), mapper=MappingServer(
            knobs=kn, embedder=emb, device=dev), frames=frames,
        embedder=emb, classes=classes)))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    set_tracer(prev)
    counts = ops.launch_counts()
    stats = run["stats"]
    held = hold_topk_calls(torch, calls, "FleetSimulator")
    check(counts["lift_compact"] > 0 and counts["query_topk_bias"] > 0,
          f"FleetSimulator launched both kernels: {counts}")
    check(stats["unserved"] == 0 and stats["served"] == stats["sq_queries"],
          "FleetSimulator: every SQ served")
    # the CPU port over the first ticks: the same clients (drawn for the
    # whole run), keyframes and per-tick noise, SQ through a scheduler as
    # the simulator routes it
    n = FLEET_SIM["cross_ticks"]
    host_sim = mk(cpu)
    host_sim._build_clients(len(frames))
    host_map = MappingServer(knobs=kn, embedder=emb, device=cpu)
    sched = host_sim._build_scheduler(lambda: host_map.store)
    t0 = time.perf_counter()
    host = ScenarioEngine(
        dataclasses.replace(host_sim._scenario(len(frames)), n_ticks=n),
        mapper=host_map, frames=frames[:n], classes=classes, embedder=emb,
        server=host_sim.server, device=cpu,
        query_hook=lambda cid, t, spec: sched.submit(spec),
        tick_hook=lambda t: sched.step()).run()
    cpu_s = time.perf_counter() - t0
    head = MetricsLog(**{f: getattr(sim.log, f)[:n]
                         for f in MetricsLog._FIELDS})
    check(head.equals(host), f"FleetSimulator: card != CPU port over the "
          f"first {n} ticks in {head.diff(host)}")
    # every SQ of those ticks: the card's answer = the CPU port's
    want = resolve_results(sched.drain())
    got = resolve_results(sim.scheduler.done)
    sq_err = same_results({r: got[r] for r in want if r in got}, want,
                          exact=False)
    check(len(want) > 0 and 0.0 <= sq_err <= SCORE_TOL,
          f"FleetSimulator: the card's SQ answers over the first {n} ticks "
          f"!= the CPU port's ({len(want)} requests, err {sq_err})")
    out["fleet_simulator"] = {"stats": stats, "launches": counts,
                              "held_to_plain": held,
                              f"sq_answers_first_{n}_ticks": len(want),
                              "sq_answers_max_err_vs_cpu": sq_err,
                              "card_s": card_s,
                              f"cpu_s_first_{n}_ticks": cpu_s,
                              **tick_ms(sim.log.wall_ms),
                              "span_ms_per_tick": span_split(
                                  tracer, len(frames))}
    emit("sim_phase", out)
    return out


# ----------------------------------------------------------------- step 14
def serving_loop_build(torch, dev, cfg, *, overlap: bool, ticks: int):
    """benchmarks/serving_loop.py's ``_build`` on the port."""
    from repro_torch.core import Knobs
    from repro_torch.core.store import SnapshotStore, synthetic_store
    from repro_torch.server import FleetServer, ZoneGrid, ZoneShardedStore
    from repro_torch.serving.loadgen import LoadGenerator, LoadSpec
    from repro_torch.serving.loop import IngestStream, ServingLoop

    kn = Knobs(server_capacity=cfg["cap"],
               client_capacity=max(cfg["budget"] * 2, 64),
               max_object_points_server=cfg["P"],
               max_object_points_client=max(cfg["P"] // 8, 8),
               min_obs_before_sync=1)
    store = synthetic_store(cfg["n_live"], cfg["cap"], cfg["E"], cfg["P"],
                            seed=7, centroid_low=(-7.0, 0.0, -7.0),
                            centroid_high=(7.0, 2.0, 7.0), device=dev)
    grid = ZoneGrid.for_room(16.0, cfg["nz"], cfg["nz"])
    zoned = ZoneShardedStore(knobs=kn, embed_dim=cfg["E"], grid=grid,
                             zone_capacity=cfg["zcap"], device=dev)
    srv = FleetServer(knobs=kn, embed_dim=cfg["E"], n_clients=cfg["C"],
                      grid=grid, budget=cfg["budget"], index=False,
                      zoned=zoned, device=dev)
    lg = LoadGenerator(LoadSpec(n_clients=cfg["C"], n_ticks=ticks,
                                base_hz=cfg["base_hz"],
                                burst_hz=cfg["burst_hz"]),
                       embed_dim=cfg["E"], device=dev)
    ing = IngestStream(n_ticks=ticks, n_live=cfg["n_live"],
                       embed_dim=cfg["E"], max_points=cfg["P"],
                       churn=cfg["churn"], seed=11, device=dev)
    snap = SnapshotStore.of(store) if overlap \
        else SnapshotStore(front=store)
    for c in range(cfg["C"]):
        srv.join(c, lg.pose_at(c, 0), 6.0)
    return ServingLoop(server=srv, store=snap, ingest=ing, loadgen=lg,
                       overlap=overlap, batch_size=cfg["batch"],
                       max_batches_per_tick=cfg["max_batches"])


def same_results(a: dict, b: dict, exact: bool) -> float:
    """Max |score| difference of two loops' per-request results; -1 when
    the request sets, oids or slots differ (or, ``exact``, any score)."""
    if set(a) != set(b):
        return -1.0
    err = 0.0
    for rid, r in a.items():
        o = b[rid]
        if not (np.array_equal(r.oids, o.oids)
                and np.array_equal(r.slots, o.slots)):
            return -1.0
        fin = np.isfinite(r.scores)
        if not np.array_equal(fin, np.isfinite(o.scores)):
            return -1.0
        d = float(np.abs(r.scores[fin] - o.scores[fin]).max()) \
            if fin.any() else 0.0
        if exact and not np.array_equal(r.scores, o.scores):
            return -1.0
        err = max(err, d)
    return err


def serving_loop_phase(torch, dev, cfg):
    """Step 14: the serving loop at benchmarks/serving_loop.py's non-smoke
    configuration.  The sync arm, then the overlapped arm (each after a
    short warm-up run): every per-request result byte-identical, equal
    sent bytes and final stores; ticks/s, tick ms, wait / e2e ms and the
    query_topk_bias launches; in each arm every ``hold_every``-th
    scheduler batch (the snapshot it read, its stacked queries and bias)
    held to the plain version.  Then the overlapped arm once more with
    ``enable_index`` (min_flat_size lowered so the 4096 live objects go
    two-stage): results equal to the flat run's.  Last, one mapped
    keyframe and one two-stage query under an installed registry: the
    mapping stage and index metrics land in it."""
    from repro_torch.core import Knobs, MappingServer, Query
    from repro_torch.core.query import execute_query
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry, set_registry
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.perception.embedder import OracleEmbedder

    def arm(overlap, index=False):
        warm = serving_loop_build(torch, dev, cfg, overlap=overlap,
                                  ticks=cfg["warm_ticks"])
        warm.run(cfg["warm_ticks"])
        loop = serving_loop_build(torch, dev, cfg, overlap=overlap,
                                  ticks=cfg["ticks"])
        if index:
            loop.enable_index(min_flat_size=cfg["index_min_flat"])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        stats = {}
        calls = topk_spy(ops, lambda: stats.update(loop.run(cfg["ticks"])),
                         keep=lambda i: i % cfg["hold_every"] == 0)
        torch.cuda.synchronize()
        stats["launches"] = ops.launch_counts()
        stats["held_to_plain"] = hold_topk_calls(
            torch, calls, f"serving loop ({stats['mode']}"
            f"{', indexed' if index else ''})")
        return loop, stats

    sync, s_stats = arm(False)
    ovl, o_stats = arm(True)
    # where a tick goes: a traced sync run (each of its dispatches ends in
    # a synchronize, so a span holds its own device work)
    traced = serving_loop_build(torch, dev, cfg, overlap=False,
                                ticks=cfg["trace_ticks"])
    tracer = Tracer()
    prev = set_tracer(tracer)
    traced.run(cfg["trace_ticks"])
    set_tracer(prev)
    split = span_split(tracer, cfg["trace_ticks"])
    check(same_results(sync.results, ovl.results, exact=True) == 0.0,
          "serving loop: sync and overlapped results byte-identical")
    check(s_stats["n_queries_served"] == o_stats["n_queries_served"] > 0,
          "serving loop: every request served in both arms")
    check(s_stats["sent_bytes_total"] == o_stats["sent_bytes_total"] > 0,
          "serving loop: equal sent_bytes_total")
    check(all(torch.equal(a, b) for a, b in zip(sync.store.front,
                                                ovl.store.front)
              if a is not None), "serving loop: equal final stores")
    for st in (s_stats, o_stats):
        check(st["launches"]["query_topk_bias"] > 0,
              f"serving loop ({st['mode']}): query_topk_bias launched")

    reg = MetricsRegistry()
    prev = set_registry(reg)
    idx_loop, i_stats = arm(True, index=True)
    set_registry(prev)
    err = same_results(ovl.results, idx_loop.results, exact=False)
    check(0.0 <= err <= SCORE_TOL,
          f"serving loop: indexed results = flat results (err {err})")
    two_stage = reg.counter("query_index_two_stage_total").total()
    check(two_stage > 0, "serving loop: the index served two-stage")
    check(i_stats["sent_bytes_total"] == o_stats["sent_bytes_total"],
          "serving loop: indexed run's sent bytes")

    # the registry after one mapped keyframe and one two-stage query
    kn = Knobs(max_detections_per_frame=16)
    scene = make_scene(n_objects=25, seed=2)
    classes = {o.oid: o.class_id for o in scene.objects}
    frame = next(iter(scene_stream(scene, n_frames=5, keyframe_interval=5,
                                   h=240, w=320)))
    srv = MappingServer(knobs=kn, embedder=OracleEmbedder(embed_dim=256),
                        device=dev)
    st = idx_loop.store.front
    spec = Query(embed=st.embed[0], k=5)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    srv.process_frame(frame, classes, torch.Generator().manual_seed(0))
    execute_query(st, spec, index=idx_loop.index)
    set_registry(prev)
    stages = reg.histogram("mapping_stage_ms")
    registry = {"mapping_stage_ms": {
        k: stages.count(stage=k, mode="semanticxr")
        for k in ("detect", "ingest")},
        "query_index_two_stage_total":
            reg.counter("query_index_two_stage_total").total(),
        "query_index_candidate_fraction":
            reg.histogram("query_index_candidate_fraction").summary()}
    check(registry["mapping_stage_ms"] == {"detect": 1, "ingest": 1},
          f"StageTimes.record in the registry: {registry}")
    check(registry["query_index_two_stage_total"] == 1
          and registry["query_index_candidate_fraction"]["n"] == 1,
          f"index metrics in the registry: {registry}")

    keep = ("ticks_per_s", "tick_ms", "wait_ms", "e2e_ms",
            "n_queries_served", "n_arrivals", "sent_bytes_total",
            "launches", "held_to_plain")
    out = {"config": {k: v for k, v in cfg.items()},
           "arms": {st["mode"]: {k: st[k] for k in keep}
                    for st in (s_stats, o_stats)},
           "indexed": {**{k: i_stats[k] for k in keep},
                       "two_stage_queries": two_stage,
                       "max_score_err_vs_flat": err},
           "overlap_speedup_x": o_stats["ticks_per_s"]
           / max(s_stats["ticks_per_s"], 1e-9),
           "sync_span_ms_per_tick": split,
           "registry": registry}
    emit("serving_loop_phase", out)
    return out


# ----------------------------------------------------------------- step 15
def bwd_cost(q, k, causal, window, elt, dv=None):
    """(bytes, flops) of one attention gradient: q, k, v, o, do and the f32
    lse [B, H, S] read and dq, dk, dv written once (v, o, do and dv at v's
    head width ``dv``, by default q's dh); five products for each (query,
    key) pair the masks keep, three over dh (S = Q . K^T, dQ = dS . K,
    dK = dS^T . Q) and two over dv (dP = dO . V^T, dV = P^T . dO), 2 flops
    a multiply-add."""
    B, S, H, dh = q.shape
    dv = dh if dv is None else dv
    _, fwd_flops = attn_cost(q, k, causal, window, elt, dv=dv)
    pairs = fwd_flops // (2 * (dh + dv))
    narrow = dv / dh                    # v, o, do, dv against q's width
    nbytes = (2 * (q.numel() + k.numel())
              + round(2 * narrow * (k.numel() + q.numel()))) * elt
    return nbytes + B * H * S * 4, 2 * (3 * dh + 2 * dv) * pairs


def hold_bwd(torch, dev, q, k, v, kw, tag, seed, scaled=None):
    """The forward kernel's lse against the plain version's and its output
    bits unchanged by asking for it; then ``flash_attention_bwd_cuda``
    against ``flash_attention_bwd_plain`` on the same inputs and lse
    (do drawn from ``seed``), within ATTN_TOL and in the input shapes, the
    same bits from two calls.  ``scaled`` = (a, r, floor) holds each
    gradient to ``scaled_limit`` instead and records each array's scale.
    Returns (the check's row, (o, do, lse, the plain gradients), the
    largest gradient error)."""
    from repro_torch.kernels import flash_attention as fa

    tol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    bare = fa.flash_attention_cuda(q, k, v, **kw)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    _, lse_plain = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    o_same = torch.equal(o, bare)
    check(o_same, f"flash_attention output bits unchanged by the lse at "
          f"{tag}")
    d = (lse - lse_plain).abs()
    lse_err = float(d.max())
    check(bool((d <= tol + tol * lse_plain.abs()).all())
          and bool(torch.isfinite(lse).all()),
          f"flash_attention lse err {lse_err} at {tag}")
    g = torch.Generator(device=dev).manual_seed(seed)
    do = torch.randn(o.shape, generator=g, device=dev).to(q.dtype)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    check([tuple(t.shape) for t in got]
          == [tuple(q.shape), tuple(k.shape), tuple(v.shape)],
          f"flash_attention_bwd shapes at {tag}")
    errs, shares, scale = {}, {}, {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        d = (a.float() - b.float()).abs()
        errs[name] = float(d.max())
        limit = (tol + tol * b.float().abs() if scaled is None else
                 scaled_limit(b, scaled))
        shares[name] = float((d / limit).max())
        if scaled is not None:
            w = b.float()
            rms = row_rms(w).clamp(min=scaled[2])
            scale[name] = {
                "max_abs_want": float(w.abs().max()),
                "rms_want": float(w.square().mean().sqrt()),
                "row_rms_median": float(row_rms(w).median()),
                # the least a that passes with this r: what sets a
                "a_needed": float(((d - scaled[1] * w.abs()) / rms).max())}
        check(shares[name] <= 1 and bool(torch.isfinite(a).all()),
              f"flash_attention_bwd {name} err {errs[name]} at {tag}: "
              f"{shares[name]} of the limit {scale.get(name, '')}")
    same = same_bits(torch, got, again)
    check(same, f"flash_attention_bwd same bits twice at {tag}")
    row = {**tag, "max_abs_err": errs, "same_bits_twice": same,
           "lse_max_abs_err": lse_err, "o_bits_unchanged_by_lse": o_same}
    if scaled is not None:
        row.update(limit=scaled, limit_share=shares, scale=scale)
    return row, (o, do, lse, want), max(errs.values())


def row_rms(w):
    """The root mean square of each row of ``w`` over its last axis (one
    head's columns), kept as a size-1 axis."""
    return w.float().square().mean(-1, keepdim=True).sqrt()


def scaled_limit(want, tol):
    """``a * max(rms, floor) + r * |want|`` for ``tol`` = (a, r, floor),
    ``rms`` each entry's row RMS: an absolute part of the size of the
    entry's own row and a relative part."""
    return (tol[0] * row_rms(want).clamp(min=tol[2])
            + tol[1] * want.float().abs())


def bwd_time(torch, clock, q, k, v, o, do, lse, kw, err, *,
             plain_as_called=False, plain_reps=30) -> dict:
    """The time row of one gradient call: cold-L2 ms of
    ``flash_attention_bwd_cuda`` (the lse in hand, as SDPA's backward has
    its statistics) beside its bound (operations at the dtype's peak and
    bytes, the masks counted, v of its own width), the plain version's
    (``plain_as_called``: as called, where its steps keep the host from
    queueing ahead of the card) and SDPA's backward through autograd on
    the same inputs (``enable_gqa`` where H != Kv, a window as a boolean
    mask; backward only, timed with ``retain_graph``).  SDPA has no logit
    softcap: under one ``library_ms`` is null and its time is kept as
    ``library_without_softcap_ms``; where no SDPA backend takes the case,
    null with the reason."""
    from repro_torch.kernels import flash_attention as fa
    F = torch.nn.functional

    B, S, H, dh = q.shape
    Kv, dvw = k.shape[2], v.shape[-1]
    causal, window = kw.get("causal", True), kw.get("window", 0)
    cap = kw.get("softcap", 0.0)
    elt = q.element_size()
    nbytes, flops = bwd_cost(q, k, causal, window, elt, dv=dvw)
    t_ops = flops / (BF16_FLOP_PER_S if elt == 2 else FP32_FLOP_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    sdpa_kw = dict(enable_gqa=True) if H != Kv else {}
    if window:
        pos = torch.arange(S, device=q.device)
        keep = pos[:, None] - pos[None, :] < window
        if causal:
            keep &= pos[None, :] <= pos[:, None]
        sdpa_kw["attn_mask"] = keep
    else:
        sdpa_kw["is_causal"] = causal
    sq, sk, sv = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    try:
        so = F.scaled_dot_product_attention(sq, sk, sv, **sdpa_kw)
        lib_ms = clock.ms(lambda: torch.autograd.grad(
            so, (sq, sk, sv), do.transpose(1, 2), retain_graph=True))
        lib = ("SDPA backward through autograd ("
               + ", ".join(sorted(sdpa_kw)) + "; backward only, timed with "
               "retain_graph)")
        del so
    except RuntimeError as e:         # no SDPA backend takes this case
        lib_ms, lib = None, f"SDPA refused the backward: {e}"[:300]

    def plain():
        return fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    row = {"ms": clock.ms(lambda: fa.flash_attention_bwd_cuda(
               q, k, v, o, do, lse, **kw)),
           "plain_ms": (clock.call_ms(plain, plain_reps) if plain_as_called
                        else clock.ms(plain, plain_reps)),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": None if cap else lib_ms, "library": lib,
           "max_abs_err": err, "flops": flops, "bytes": nbytes,
           "shape": f"B={B} S={S}{tlen(q, k)} H={H} Kv={Kv} dqk={dh} "
                    f"dv={dvw} {'bf16' if elt == 2 else 'f32'} "
                    f"causal={causal} "
                    f"window={window} softcap={cap}"}
    if plain_as_called:
        row["plain_timed"] = "call"
    if cap and lib_ms is not None:
        row["library_without_softcap_ms"] = lib_ms
    row["tflops"] = flops / row["ms"] / 1e9
    return row


def flash_bwd_checks(torch, clock, dev):
    """``flash_attention_bwd_cuda`` against ``flash_attention_bwd_plain`` on
    the card: the captioner's training shape in bf16 and f32, ragged S,
    window, softcap, non-causal, G = 1, dh = 128 and S = 1024, after the
    forward kernel's lse is held to the plain version's and its output to
    the bits it has without the lse; two calls give the same bits; autograd
    through ``ops.flash_attention_bshd`` launches it once, saves the lse
    and returns its bits; timed beside its bound, the plain version and
    SDPA's backward, and the bf16 call's two launches under the
    profiler."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    bf, f32 = torch.bfloat16, torch.float32
    cases = [(8, 256, 12, 4, 64, bf, True, 0, 0.0),      # training shape
             (8, 256, 12, 4, 64, f32, True, 0, 0.0),
             (2, 200, 12, 4, 64, bf, True, 0, 0.0),      # ragged tiles
             (2, 129, 12, 4, 64, f32, True, 0, 0.0),
             (1, 256, 4, 4, 64, bf, True, 32, 0.0),      # window 32
             (1, 256, 4, 2, 64, f32, True, 0, 30.0),     # softcap 30
             (2, 200, 4, 4, 64, bf, False, 0, 0.0),      # non-causal, G = 1
             (2, 129, 4, 4, 128, f32, False, 0, 0.0),    # ... dh = 128
             (1, 1024, 12, 4, 128, bf, True, 0, 0.0),    # S = 1024
             (1, 1024, 4, 4, 64, f32, True, 32, 30.0),
             (2, 333, 12, 4, 128, bf, True, 100, 30.0)]  # every option, GQA
    rows, timed = [], {}
    for i, (B, S, H, Kv, dh, dt, causal, window, cap) in enumerate(cases):
        q, k, v = attn_inputs(torch, B, S, H, Kv, dh, dt, 100 + i, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        tag = dict(B=B, S=S, H=H, Kv=Kv, dh=dh, dtype=str(dt), **kw)
        row, (o, do, lse, _), err = hold_bwd(torch, dev, q, k, v, kw, tag,
                                             200 + i)
        rows.append(row)
        if i < 2:
            timed[i] = (q, k, v, o, do, lse, kw, err)
    emit("flash_attention_bwd_checks", rows)

    # autograd through the model's entry point launches the kernel once
    q, k, v, o, do, lse, kw, _ = timed[0]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention_bshd(*leaves, **kw)
    check(torch.equal(out.grad_fn.saved_tensors[4], lse),
          "autograd saved the forward kernel's lse")
    n0 = fa.bwd_launches
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    direct = fa.flash_attention_bwd_cuda(q, k, v, out.detach(), do, lse,
                                         **kw)
    check(fa.bwd_launches - n0 == 2, "autograd launched the backward kernel "
          f"once ({fa.bwd_launches - n0 - 1} launches)")
    check(torch.equal(out.detach(), o), "autograd forward = the kernel's")
    check(all(torch.equal(a, b) for a, b in zip(grads, direct)),
          "autograd's gradients = the kernel's direct output")

    row = {}
    for i, key in ((0, ""), (1, "f32_")):
        row.update({key + name: x for name, x in bwd_time(
            torch, clock, *timed[i]).items()})

    # the bf16 call's two launches, under the profiler, each call after an
    # L2 flush as in Clock.ms
    q, k, v, o, do, lse, kw, _ = timed[0]
    reps = 10

    def calls():
        for _ in range(reps):
            clock.flush.zero_()
            fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    split = profiled(torch, calls, kernels=("flash_bwd_dq", "flash_bwd_dkdv"))
    row["launch_ms"] = {name: t / reps
                        for name, t in split["kernel_ms"].items()}
    check(all(t > 0 for t in row["launch_ms"].values()),
          f"both backward launches seen by the profiler: {row['launch_ms']}")
    emit("flash_attention_bwd_time", row)
    return row


# ----------------------------------------------------------------- step 16
def train_run(torch, dev, argv, on_step=None):
    """``repro_torch.launch.train.main(argv)`` on ``dev``, its standard
    output captured: (returned parameters or the SystemExit code, output)."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            out = train.main(argv, device=dev, on_step=on_step)
        except SystemExit as e:           # --kill-at's simulated failure
            out = e.code
    sys.stdout.write(buf.getvalue())
    sys.stdout.flush()
    return out, buf.getvalue()


def replay_train(torch, dev, cfg, *, batch, seq, steps, n_vis=0,
                 tol=TRAIN_REPLAY_TOL, spread_threads=()):
    """``steps`` f32 train steps of ``cfg`` (the full-width captioner, the
    replay cuts) from the same seeded weights on the card and on the CPU
    port (plain versions); with ``n_vis``, each batch's tokens after as
    many seeded f32 patch embeddings (a vision model's image batch);
    loss, grad norm and masters within ``tol``.  With ``spread_threads``,
    the CPU port runs again on each of those thread counts, and each limit
    is the larger of ``tol``'s and the CPU port's own spread, its largest
    gap from the first CPU run (``cpu_spread``): the card is held no
    further from the CPU port than the CPU port is from itself in other
    summation orders."""
    from repro_torch import convert
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import model_api
    from repro_torch.models import common as cm
    from repro_torch.optim import adamw

    cfg = cfg.replace(dtype=torch.float32)
    ocfg = adamw.AdamWConfig(warmup_steps=1, total_steps=steps)
    cpu = model_api(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    it = batch_iterator(batch, seq, seed=3, vocab_size=cfg.vocab_size)
    rng = np.random.default_rng(4)
    batches = [frontend_batch(
        torch.from_numpy(next(it)["tokens"]),
        torch.from_numpy(rng.normal(size=(batch, n_vis, cfg.d_model)).astype(
            np.float32)) if n_vis else None) for _ in range(steps)]
    tree = convert.lm_params_to_tree(cpu)          # copies: training is in place
    threads = torch.get_num_threads()
    runs = {}
    for where, n in (("card", 0), ("cpu", 0),
                     *((f"cpu_{n}", n) for n in spread_threads)):
        lm = cpu if where == "cpu" else convert.lm_params_from_numpy(
            cfg, tree, device=dev if where == "card" else "cpu")
        if n:
            torch.set_num_threads(n)
        lm.requires_grad_(True)
        opt = adamw.init_opt_state(lm, ocfg)
        step = build_train_step(cfg, ocfg)
        t0 = time.perf_counter()
        hist = []
        for b in batches:
            lm, opt, m = step(lm, opt, {k: v.to(lm.device)
                                        for k, v in b.items()})
            hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        torch.set_num_threads(threads)
        runs[where] = (hist, dict(cm.leaves(opt.master)),
                       time.perf_counter() - t0)

    def gaps(run):
        """``run``'s loss, grad norm and masters against the CPU run's."""
        (gh, gm, _), (ch, cmast, _) = run, runs["cpu"]
        out = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(gh, ch))
               for k in ("loss", "grad_norm")}
        num = sum(float(((gm[p].cpu() - cmast[p]) ** 2).sum())
                  for p in cmast)
        den = sum(float((cmast[p] ** 2).sum()) for p in cmast)
        out["master"] = (num / den) ** 0.5
        return out

    err = gaps(runs["card"])
    out = {"batch": batch, "seq": seq, "frontend_tokens": n_vis,
           "steps": steps, "card": runs["card"][0], "cpu": runs["cpu"][0],
           "rel_err": {k: err[k] for k in ("loss", "grad_norm")},
           "master_rel_err_l2": err["master"],
           "master_max_abs_err": max(
               float((runs["card"][1][p].cpu() - runs["cpu"][1][p]).abs()
                     .max()) for p in runs["cpu"][1]),
           "card_s_host": runs["card"][2], "cpu_s_host": runs["cpu"][2],
           "tolerance": tol}
    if spread_threads:
        spread = {n: gaps(runs[f"cpu_{n}"]) for n in spread_threads}
        tol = {k: max(tol[k], *(g[k] for g in spread.values())) for k in tol}
        out.update(cpu_spread={"default_threads": threads, **{
            f"{n}_threads": {**g, "s_host": runs[f"cpu_{n}"][2]}
            for n, g in spread.items()}}, limits=tol)
    for k in ("loss", "grad_norm", "master"):
        check(err[k] <= tol[k], f"train replay {k} rel err {err[k]} within "
              f"{tol[k]}")
    return out


def clip_phase(torch, dev, *, batch, steps, n_objects, scene_seed,
               eval_batches, cross_steps):
    """examples/train_perception.py's run on the port: ClipConfig(), AdamW
    (lr 1e-3, warmup 20, decay 0.01), on the card and, for the first
    ``cross_steps`` steps, on the CPU port from the same weights."""
    from repro_torch.data.scenes import N_CLASSES, make_scene
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.perception import clip as clip_mod

    ccfg = clip_mod.ClipConfig()
    ocfg = adamw.AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=20,
                             weight_decay=0.01)
    scene = make_scene(n_objects=n_objects, seed=scene_seed)
    classes = {o.oid: o.class_id for o in scene.objects}

    def run(device, n):
        params = clip_mod.init_clip_params(
            ccfg, torch.Generator().manual_seed(0), device=device)
        for p in params.values():
            p.requires_grad_(True)
        opt = adamw.init_opt_state(params, ocfg)
        it = clip_mod.pair_batches(scene, classes, batch=batch,
                                   device=device)
        losses = []
        for _ in range(n):
            b = next(it)
            b.pop("class_ids")
            loss, _ = clip_mod.clip_loss(params, b, ccfg)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            params, opt, _ = adamw.adamw_update(grads, opt, params, ocfg)
            losses.append(loss.detach())
        return params, [float(x) for x in losses]

    before = dict(ops.launch_counts())
    t0 = time.perf_counter()
    params, losses = run(dev, steps)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    eval_it = clip_mod.pair_batches(scene, classes, batch=16, seed=99,
                                    device=dev)
    all_toks = torch.from_numpy(np.stack([clip_mod.class_tokens(c)
                                          for c in range(N_CLASSES)])).to(dev)
    hits = tot = 0
    with torch.no_grad():
        te = clip_mod.encode_text(params, all_toks, ccfg)
        for _ in range(eval_batches):
            b = next(eval_it)
            oe = clip_mod.encode_object(params, b["crops"], b["stats"], ccfg)
            pred = torch.argmax(oe @ te.T, dim=1).cpu().numpy()
            hits += int((pred == b["class_ids"]).sum())
            tot += len(pred)
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
    _, cpu_losses = run("cpu", cross_steps)
    err = max(abs(a - b) / abs(b) for a, b in zip(losses[:cross_steps],
                                                  cpu_losses))
    check(all(np.isfinite(losses)), "mini-CLIP losses finite")
    check(err <= CLIP_CROSS_TOL, f"mini-CLIP card vs CPU loss rel err {err}")
    check(not any(launched.values()), f"mini-CLIP launched {launched}")
    check(hits / tot > 1.0 / N_CLASSES, f"retrieval {hits}/{tot} at chance")
    return {"config": dataclasses.asdict(ccfg), "batch": batch,
            "steps": steps, "n_objects": n_objects,
            "loss_at": {s: losses[s - 1] for s in range(50, steps + 1, 50)},
            "retrieval_top1": hits / tot, "retrieval_hits": [hits, tot],
            "chance": 1.0 / N_CLASSES, "card_s_host": card_s,
            "cross_steps": cross_steps, "cross_loss_rel_err": err,
            "kernels_launched": 0,
            "note": "no hand-written kernel on this path: the towers are "
                    "small dense products (torch.matmul)"}


def train_phase(torch, dev, *, arch, steps, batch, seq, kill, compress,
                replay, profile_steps, clip):
    """(a) the full-width captioner trained by repro_torch.launch.train on
    the card; (b) kill and resume; (c) --compress-grads; (d) the f32
    card-vs-CPU replay; (e) a profiler window over train steps; (f) the
    mini-CLIP towers."""
    import shutil

    from repro_torch import convert
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import common as cm
    from repro_torch.optim import adamw

    cfg = get_config(arch)
    work = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    base = ["--arch", arch, "--batch", str(batch), "--seq", str(seq)]
    out = {}

    # (a) training, counters reset just before and read just after
    walls, losses, per_step = [], [], []
    last = {"t": 0.0, "n": (0, 0)}

    def on_step(step, m, params):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append((now - last["t"]) * 1e3)
        last["t"] = now
        losses.append(float(m["loss"]))
        c = ops.launch_counts()
        n = (c["flash_attention"], c["flash_attention_bwd"])
        per_step.append((n[0] - last["n"][0], n[1] - last["n"][1]))
        last["n"] = n

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # earlier steps' tensors
    ops.reset_launch_counts()
    last["t"] = time.perf_counter()
    t0 = last["t"]
    model, log = train_run(torch, dev, base + [
        "--steps", str(steps), "--ckpt-dir", str(work / "a"),
        "--ckpt-every", "0", "--log-every", "50"], on_step)
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and len(losses) == steps,
          "every training loss finite")
    first, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last10 < 0.5 * first, f"loss fell below half its start: mean of "
          f"the first 10 {first}, of the last 10 {last10}")
    check(all(n == (cfg.n_layers, cfg.n_layers) for n in per_step),
          f"{cfg.n_layers} flash forward and backward launches a step: "
          f"{sorted(set(per_step))}")
    check("training complete" in log, "the trainer finished")
    steady = walls[1:]
    out["train"] = {
        "config": cfg.name, "dtype": str(cfg.dtype), "batch": batch,
        "seq": seq, "steps": steps,
        "params": sum(p.numel() for p in model.parameters()),
        "step_ms_first": walls[0],
        "step_ms_p50": float(np.percentile(steady, 50)),
        "step_ms_p95": float(np.percentile(steady, 95)),
        "tokens_per_s": batch * seq / float(np.percentile(steady, 50)) * 1e3,
        "tokens_per_s_overall": batch * seq * steps / total_s,
        "max_memory_allocated_bytes": peak,
        "allocated_before_bytes": held,
        "training_peak_bytes": peak - held,
        "loss_at": {s: losses[s - 1] for s in (1, 50, 100, steps)
                    if s <= steps},
        "mean_loss_first_10": first, "mean_loss_last_10": last10,
        "flash_launches_per_step": {"flash_attention": per_step[0][0],
                                    "flash_attention_bwd": per_step[0][1]},
        "launches": launches}
    emit("train_phase", out["train"])

    # (b) kill at step 6 of 12, checkpoints every 4; the rerun resumes
    kdir = work / "b"
    saved = {}

    def snap(step, m, params):
        if step == kill["ckpt_every"]:
            saved["tree"] = convert.lm_params_to_tree(params)

    code, _ = train_run(torch, dev, base + [
        "--steps", str(kill["steps"]), "--ckpt-dir", str(kdir),
        "--ckpt-every", str(kill["ckpt_every"]), "--kill-at",
        str(kill["kill_at"])], snap)
    check(code == 42, f"--kill-at exits 42 (got {code!r})")
    ck = kdir / cfg.name
    check(ckpt_mod.latest_step(ck) == kill["ckpt_every"],
          f"latest checkpoint after the kill: {ckpt_mod.latest_step(ck)}")
    back = ckpt_mod.restore(ck, kill["ckpt_every"], saved["tree"],
                            device=dev)
    bit_equal = same_bits(
        torch, [a.cpu().view(torch.int16) for _, a in cm.leaves(back)],
        [b.view(torch.int16) for _, b in cm.leaves(saved["tree"])])
    check(bit_equal, "restored parameters bit-equal to the saved ones")
    seen = []
    model_b, log = train_run(torch, dev, base + [
        "--steps", str(kill["steps"]), "--ckpt-dir", str(kdir),
        "--ckpt-every", str(kill["ckpt_every"])],
        lambda s, m, p: seen.append((s, float(m["loss"]))))
    check(f"[restore] resuming from step {kill['ckpt_every']}" in log
          and "training complete" in log, "the rerun resumed and finished")
    check([s for s, _ in seen] == list(range(kill["ckpt_every"] + 1,
                                             kill["steps"] + 1)),
          f"resumed steps {[s for s, _ in seen]}")
    check(all(np.isfinite(x) for _, x in seen), "resumed losses finite")
    out["kill_resume"] = {**kill, "exit_code": code,
                          "resumed_from": kill["ckpt_every"],
                          "restored_bit_equal": bit_equal,
                          "resumed_losses": seen}
    emit("train_kill_resume", out["kill_resume"])

    # (c) int8 error-feedback compression
    comp = []
    train_run(torch, dev, base + [
        "--steps", str(compress), "--ckpt-dir", str(work / "c"),
        "--ckpt-every", "0", "--compress-grads"],
        lambda s, m, p: comp.append(float(m["loss"])))
    check(len(comp) == compress and all(np.isfinite(comp)),
          f"--compress-grads losses {comp}")
    out["compress_grads"] = {"steps": compress, "losses": comp}
    emit("train_compress_grads", out["compress_grads"])

    # (d) f32 card vs CPU port
    out["replay"] = replay_train(torch, dev, cfg, **replay)
    emit("train_replay", out["replay"])

    # (e) where a train step's time goes
    ocfg = adamw.AdamWConfig(total_steps=profile_steps)
    opt = adamw.init_opt_state(model, ocfg)
    step = build_train_step(cfg, ocfg)
    it = batch_iterator(batch, seq, seed=5, vocab_size=cfg.vocab_size)
    toks = [torch.from_numpy(next(it)["tokens"]).to(dev)
            for _ in range(profile_steps + 1)]
    state = {"lm": model, "opt": opt}

    def steps_fn(ts):
        for t in ts:
            state["lm"], state["opt"], _ = step(state["lm"], state["opt"],
                                                {"tokens": t})
    steps_fn(toks[:1])                       # warm
    prof = profiled(torch, lambda: steps_fn(toks[1:]),
                    kernels=("flash_wgmma", "flash_bwd"))
    flash = prof["kernel_ms"]
    prof.update({
        "steps": profile_steps,
        "device_busy_ms_per_step": prof["device_busy_ms"] / profile_steps,
        "cpu_ops_per_step": prof["cpu_ops"] / profile_steps,
        "host_syncs_per_step": {k: v / profile_steps
                                for k, v in prof["host_syncs"].items()},
        "flash_forward_ms": flash["flash_wgmma"],
        "flash_backward_ms": flash["flash_bwd"],
        "flash_share_of_device": (flash["flash_wgmma"] + flash["flash_bwd"])
        / max(prof["device_busy_ms"], 1e-9)})
    check(flash["flash_bwd"] > 0 and flash["flash_wgmma"] > 0,
          "the flash kernels ran in the profiled train steps")
    out["profile"] = prof
    emit("train_profile", prof)

    # (f) the mini-CLIP towers
    out["clip"] = clip_phase(torch, dev, **clip)
    emit("clip_phase", out["clip"])
    shutil.rmtree(work, ignore_errors=True)
    return out


# ----------------------------------------------------------------- step 17
def mla_inputs(torch, B, S, H, dtype, seed, dev):
    """q [B, S, H, 192]; k [B, S, H, 192] whose last 64 columns are one
    rope head broadcast to every head, as MLA's prefill builds it; v
    [B, S, H, 128]."""
    dqk, dv = MLA_HEADS
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    rope = rnd(B, S, 1, 64).expand(B, S, H, 64)
    return (rnd(B, S, H, dqk), torch.cat([rnd(B, S, H, dqk - 64), rope], -1),
            rnd(B, S, H, dv))


def mla_attention_checks(torch, clock, dev):
    """(a) ``flash_attention_cuda`` at (dqk, dv) = (192, 128) against
    ``flash_attention_plain``: every MLA_ATTN_SHAPES (B, S, H) causal in
    bf16 and f32, and a ragged non-causal S in both (the padded keys
    masked), within ATTN_TOL, the same bits from two calls; then its time
    at the prefill shape (4, 1024, 128, bf16, causal, cold L2) beside its
    bound, the plain version's and SDPA's."""
    from repro_torch.kernels import flash_attention as fa

    bf, f32 = torch.bfloat16, torch.float32
    cases = [(B, S, H, dt, True) for B, S, H in MLA_ATTN_SHAPES
             for dt in (bf, f32)] + [(2, 200, 4, bf, False),
                                     (2, 200, 4, f32, False)]
    for i, (B, S, H, dt, causal) in enumerate(cases):
        q, k, v = mla_inputs(torch, B, S, H, dt, 100 + i, dev)
        got = fa.flash_attention_cuda(q, k, v, causal=causal)
        again = fa.flash_attention_cuda(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, ok = attn_close(got, want, dt)
        tag = dict(B=B, S=S, H=H, dqk=MLA_HEADS[0], dv=MLA_HEADS[1],
                   dtype=str(dt), causal=causal)
        check(tuple(got.shape) == (B, S, H, MLA_HEADS[1]),
              f"flash_attention (192, 128) shape at {tag}")
        check(ok and bool(torch.isfinite(got).all()),
              f"flash_attention (192, 128) err {err} at {tag}")
        same = same_bits(torch, [got.float()], [again.float()])
        check(same, f"flash_attention (192, 128) same bits twice at {tag}")
        emit("mla_attention_check", {**tag, "max_abs_err": err,
                                     "same_bits_twice": same})
    B, S, H = MLA_ATTN_SHAPES[-1]
    q, k, v = mla_inputs(torch, B, S, H, bf, 7, dev)
    err, _ = attn_close(fa.flash_attention_cuda(q, k, v),
                        fa.flash_attention_plain(q, k, v), bf)
    row = attn_time(torch, clock, q, k, v,
                    dict(causal=True, window=0, softcap=0.0), err)
    emit("mla_attention_time", row)
    return row


def card_model(torch, dev, cfg) -> tuple:
    """``cfg``'s model drawn on the card from a seeded CUDA generator, and
    what drawing it cost: (model, {allocated_before_bytes, init_s_host,
    init_peak_bytes, params, weights_bytes})."""
    import gc

    from repro_torch.models.api import model_api

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_api(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                device=dev)
    torch.cuda.synchronize()
    return model, {
        "allocated_before_bytes": before,
        "init_s_host": time.perf_counter() - t0,
        "init_peak_bytes": torch.cuda.max_memory_allocated(),
        "params": sum(p.numel() for p in model.parameters()),
        "weights_bytes": sum(p.numel() * p.element_size()
                             for p in model.parameters())}


def serve_run(torch, api, model, tokens, new_tokens, forced=None,
              spy=None, extra=None):
    """The serving loop of steps 17, 19, 21 and 22: counters reset, two
    prefills of ``tokens`` (after ``extra``, a vision model's n_vis patch
    embeddings, where given) into caches of n_vis + S + new_tokens
    positions, zeroed before each (a recurrent layer's prefill continues
    from its cache's state), then ``new_tokens`` greedy steps at
    positions n_vis + S + i (or the tokens of ``forced`` [B, steps + 1]
    fed instead), the counters read; ``spy`` (a context such as MoESpy) open around the passes.
    Returns (metrics, the tokens fed [B, new_tokens + 1], the logits of
    the prefill and every step, the caches)."""
    import contextlib

    from repro_torch.kernels import ops
    from repro_torch.models.lm import greedy_token

    batch, prompt = tokens.shape
    front = 0 if extra is None else extra.shape[1]
    caches = api.init_cache(batch, front + prompt + new_tokens,
                            device=tokens.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    pre_ms, per_prefill, dec_ms, pre_logits = [], [], [], []
    with spy or contextlib.nullcontext():
        for _ in range(2):
            for c in caches:
                for t in c:
                    if isinstance(t, torch.Tensor):
                        t.zero_()
            torch.cuda.synchronize()
            n0 = ops.launch_counts()["flash_attention"]
            t0 = time.perf_counter()
            logits, caches = api.prefill(
                model, frontend_batch(tokens, extra), caches)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
            per_prefill.append(ops.launch_counts()["flash_attention"] - n0)
            pre_logits.append(logits.float())
        n1 = ops.launch_counts()["flash_attention"]
        all_logits = [pre_logits[-1]]
        tok = greedy_token(logits) if forced is None else forced[:, :1]
        toks = [tok]
        for i in range(new_tokens):
            t0 = time.perf_counter()
            logits, caches = api.decode(model, tok, caches,
                                        front + prompt + i)
            tok = (greedy_token(logits) if forced is None
                   else forced[:, i + 1:i + 2])
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            all_logits.append(logits.float())
            toks.append(tok)
    launches = ops.launch_counts()
    dec = float(np.percentile(dec_ms, 50))
    metrics = {
        "prefill_ms": pre_ms,
        "prefill_tokens_per_s": batch * prompt / pre_ms[-1] * 1e3,
        "frontend_tokens": batch * front,
        "prefill_positions_per_s": batch * (front + prompt) / pre_ms[-1]
        * 1e3,
        "decode_ms_per_step_p50": dec,
        "decode_ms_per_step_p95": float(np.percentile(dec_ms, 95)),
        "generated_tokens_per_s": batch / dec * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "flash_launches_per_prefill": per_prefill,
        "flash_launches_decoding": launches["flash_attention"] - n1,
        "launches": launches,
        "logits_finite": all(bool(torch.isfinite(x).all())
                             for x in all_logits),
        "prefill_logits_same_bits_twice": same_bits(torch, pre_logits[:1],
                                                    pre_logits[1:]),
        "cache_length": next((int(c.length) for c in caches
                              if hasattr(c, "length")), None),
        "first_tokens": torch.cat(toks, dim=1)[0, :8].tolist()}
    return metrics, torch.cat(toks, dim=1), all_logits, caches


def check_served(name: str, m: dict, n_layers: int, max_len: int) -> None:
    """A serve_run's checks: one flash launch an attention layer
    (``n_layers`` of them) a prefill and none decoding, every logit
    finite, the two prefills the same bits, the KV cache's length (where
    the model has attention layers)."""
    check(m["flash_launches_per_prefill"] == [n_layers] * 2,
          f"{name}: {n_layers} flash launches a prefill: "
          f"{m['flash_launches_per_prefill']}")
    check(m["flash_launches_decoding"] == 0,
          f"{name}: no flash launch decoding: {m['flash_launches_decoding']}")
    check(m["logits_finite"], f"{name}: every logit finite")
    check(m["prefill_logits_same_bits_twice"],
          f"{name}: the prefill's logits the same bits twice")
    check(m["cache_length"] == (max_len if n_layers else None),
          f"{name}: cache length")


def serve_profile(torch, api, model, tokens, caches, kernels=(),
                  extra=None) -> dict:
    """Where the time goes, after a run's counts are read (these launches
    are extra): one prefill of ``tokens`` (after ``extra``'s patch
    embeddings, where given) into ``caches``, then PROFILE_DECODE greedy
    steps, each under the profiler."""
    from repro_torch.models.lm import greedy_token

    prompt = tokens.shape[1] + (0 if extra is None else extra.shape[1])
    state = {}

    def prefill_once():
        state["logits"], state["caches"] = api.prefill(
            model, frontend_batch(tokens, extra), caches)

    def decode_steps():
        tok = greedy_token(state["logits"])
        for i in range(PROFILE_DECODE):
            logits, _ = api.decode(model, tok, state["caches"], prompt + i)
            tok = greedy_token(logits)

    return {"prefill": profiled(torch, prefill_once, kernels),
            f"decode_{PROFILE_DECODE}_steps": profiled(torch, decode_steps)}


class MoESpy:
    """While open, records every MoE call of the port: its expert ids
    (``moe._route``) and its ``MoEStats`` (``moe.moe_apply``), detached: a
    stats tensor that kept its graph would keep alive, after the backward,
    the recomputed tensors that a nested checkpoint (jamba's scan chunks
    inside its period) stored and the backward never read (5.67 GB a step
    on jamba's training cut)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.ids, self.stats = moe, [], []

    def __enter__(self):
        moe = self.moe
        self._route, self._apply = moe._route, moe.moe_apply

        def route(*a, **kw):
            out = self._route(*a, **kw)
            self.ids.append(out[1])
            return out

        def apply(*a, **kw):
            y, st = self._apply(*a, **kw)
            self.stats.append(type(st)(*(t.detach() for t in st)))
            return y, st

        moe._route, moe.moe_apply = route, apply
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe.moe_apply = self._route, self._apply


def deepseek_serve_phase(torch, dev, *, arch, n_layers, batch, prompt,
                         new_tokens):
    """(b) ``deepseek-v3-671b`` at full width, ``n_layers`` deep, bf16,
    weights seeded on the card: ``batch`` prompts of ``prompt`` tokens
    (prefilled twice), then ``new_tokens`` greedy steps, once with naive
    and once with absorbed MLA decode, through model_api's entry points
    (serve_run).  Counters reset just before each mode and read just
    after: one flash launch per MLA layer per prefill, none while
    decoding."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    from repro_torch.models.api import model_api

    full = get_config(arch)
    cfg = full.replace(n_layers=n_layers)
    emit("deepseek_cuts", {
        "serve": f"{arch}: depth {full.n_layers} -> {n_layers} layers "
                 f"({cfg.n_dense_prefix} dense-prefix + "
                 f"{n_layers - cfg.n_dense_prefix} MoE); widths as "
                 "published; random weights seeded on the card",
        "replay": "d_model 7168 -> 1024, heads 128 -> 16, d_ff_dense_prefix "
                  "18432 -> 2048, experts 256 -> 16 (top-8 kept), "
                  "d_ff_expert 2048 -> 256, vocab 129280 -> 4096, depth 61 "
                  "-> 4; MLA ranks and head widths as published, f32"})
    model, init = card_model(torch, dev, cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)).to(dev)
    E = cfg.moe.n_experts
    n_moe = n_layers - cfg.n_dense_prefix
    out = {"config": cfg.name, "n_layers": n_layers, "batch": batch,
           "prompt": prompt, "new_tokens": new_tokens, **init, "modes": {}}
    gen = {}
    for mode, absorb in (("naive", False), ("absorbed", True)):
        api = model_api(cfg.replace(mla=dataclasses.replace(
            cfg.mla, absorb=absorb)))
        spy = MoESpy()
        m, toks, _, caches = serve_run(torch, api, model, tokens, new_tokens,
                                       spy=spy)
        # the MoE adds a token's k contributions in a fixed order (no
        # index_add_): the same prompt gives the same bits twice
        check_served(f"DeepSeek ({mode})", m, n_layers, prompt + new_tokens)
        check(len(spy.ids) == n_moe * (2 + new_tokens),
              f"one MoE call per MoE layer and pass ({mode})")
        load = torch.bincount(spy.ids[-1 - new_tokens].flatten(),
                              minlength=E).cpu()
        gen[mode] = toks.cpu()
        out["modes"][mode] = {
            **m,
            "moe_dropped_frac_prefill": float(
                spy.stats[-1 - new_tokens].dropped_frac),
            "moe_dropped_frac_decode_max": max(
                float(st.dropped_frac) for st in spy.stats[-new_tokens:]),
            "prefill_expert_load": {
                "min": int(load.min()), "max": int(load.max()),
                "mean": float(load.float().mean()),
                "idle_experts": int((load == 0).sum()),
                "capacity": moe.expert_capacity(batch * prompt, cfg)}}
        flash = ("flash_wgmma_kernel<192",)
        prof = serve_profile(torch, api, model, tokens, caches, flash)
        if mode == "naive":
            check(prof["prefill"]["kernel_ms"][flash[0]] > 0,
                  "flash_wgmma_kernel<192, 128> ran in the profiled prefill")
        out["modes"][mode]["profile"] = prof
        emit("deepseek_profile", {"mode": mode, **prof})
        del caches
    out["greedy_agreement_naive_vs_absorbed"] = float(
        (gen["naive"] == gen["absorbed"]).float().mean())
    out["flash_launches"] = out["modes"]["absorbed"]["launches"][
        "flash_attention"]
    emit("deepseek_serve_phase", out)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def deepseek_replay_phase(torch, dev, *, arch, n_layers, d_model, n_heads,
                          d_ff_dense_prefix, vocab_size, n_experts, top_k,
                          d_ff_expert, batch, prompt, new_tokens):
    """(c) the cut v3 in f32 on the card and on the CPU port, the same
    seeded weights, in both decode modes: the same expert ids at every
    MoE call, logits within DEEPSEEK_REPLAY_TOL of the largest, equal
    greedy tokens, and 4 flash launches (the f32 (192, 128) instance) per
    prefill on the card."""
    from repro_torch.models.api import model_api

    cfg = deepseek_replay_cut(
        torch, torch.float32, arch=arch, n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, d_ff_dense_prefix=d_ff_dense_prefix,
        vocab_size=vocab_size, n_experts=n_experts, top_k=top_k,
        d_ff_expert=d_ff_expert)
    prompt_np = np.random.default_rng(1).integers(
        0, vocab_size, (batch, prompt)).astype(np.int32)
    models = {d: model_api(cfg).init(torch.Generator().manual_seed(0),
                                     device=d) for d in (dev, "cpu")}

    def run(device, absorb):
        api = model_api(cfg.replace(mla=dataclasses.replace(
            cfg.mla, absorb=absorb)))
        with MoESpy() as spy:
            toks, logits, flash = replay_run(torch, api, models[device],
                                             prompt_np, new_tokens, device)
        return toks, logits, [i.cpu() for i in spy.ids], flash

    t0 = time.perf_counter()
    out = {"config": f"{cfg.name} cut (d_model {d_model}, {n_heads} heads, "
                     f"{n_experts} experts top-{top_k}, d_ff_expert "
                     f"{d_ff_expert}, vocab {vocab_size}, {n_layers} "
                     "layers), f32",
           "batch": batch, "prompt": prompt, "new_tokens": new_tokens,
           "modes": {}}
    for mode, absorb in (("naive", False), ("absorbed", True)):
        gtok, glog, gids, flash = run(dev, absorb)
        ctok, clog, cids, _ = run("cpu", absorb)
        check(len(gids) == len(cids) == 1 + new_tokens,
              f"replay MoE calls ({mode})")
        for j, (a, b) in enumerate(zip(gids, cids)):
            check(torch.equal(a, b), f"replay expert ids at MoE call {j} "
                  f"({mode})")
        scale = float(clog.abs().max())
        err = float((glog - clog).abs().max())
        check(torch.equal(gtok, ctok), f"replay greedy tokens card "
              f"{gtok.tolist()} vs CPU {ctok.tolist()} ({mode})")
        check(err <= DEEPSEEK_REPLAY_TOL * scale,
              f"replay f32 logits err {err} of {scale} ({mode})")
        check(flash == n_layers, f"{n_layers} f32 flash launches per "
              f"prefill on the card ({mode}): {flash}")
        out["modes"][mode] = {"tokens": gtok[0].tolist(),
                              "max_abs_logit_err": err,
                              "max_abs_logit": scale,
                              "relative_err": err / scale,
                              "moe_calls_equal_ids": len(gids),
                              "flash_launches_prefill": flash}
    out["seconds_host"] = time.perf_counter() - t0
    emit("deepseek_replay_phase", out)
    return out


# ----------------------------------------------------------------- step 18
def mla_bwd_checks(torch, clock, dev):
    """(a) ``flash_attention_bwd_cuda`` at (dqk, dv) = (192, 128) against
    ``flash_attention_bwd_plain``: every MLA_BWD_SHAPES (B, S, H) causal
    in bf16 and f32 and a ragged non-causal S in both, after the forward
    kernel's lse at (192, 128) is held to the plain version's and its
    output to the bits it has without the lse; the same inputs and lse to
    both, within ATTN_TOL, the same bits from two calls; autograd through
    ``ops.flash_attention_bshd`` at the training shape launches it once
    and returns the direct call's bits on the lse it saved; its time at
    the training shape (cold L2) beside its bound, the plain version and
    SDPA's backward, and its two launches under the profiler."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    bf, f32 = torch.bfloat16, torch.float32
    dqk, dvw = MLA_HEADS
    cases = [(B, S, H, dt, True) for B, S, H in MLA_BWD_SHAPES
             for dt in (bf, f32)] + [(2, 200, 4, bf, False),
                                     (2, 200, 4, f32, False)]
    rows, timed = [], {}
    for i, (B, S, H, dt, causal) in enumerate(cases):
        q, k, v = mla_inputs(torch, B, S, H, dt, 300 + i, dev)
        tag = dict(B=B, S=S, H=H, dqk=dqk, dv=dvw, dtype=str(dt),
                   causal=causal)
        row, (o, do, lse, _), err = hold_bwd(torch, dev, q, k, v,
                                             dict(causal=causal), tag, 400 + i)
        rows.append(row)
        if (B, S, H) == MLA_TRAIN_SHAPE and causal:
            timed[dt] = (q, k, v, o, do, lse, err)
    emit("mla_attention_bwd_checks", rows)

    # autograd through the model's entry point at the training shape
    q, k, v, o, do, lse, _ = timed[bf]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention_bshd(*leaves, causal=True)
    check(torch.equal(out.grad_fn.saved_tensors[4], lse),
          "autograd saved the (192, 128) forward kernel's lse")
    n0 = fa.bwd_launches
    grads = torch.autograd.grad(out, leaves, do)
    direct = fa.flash_attention_bwd_cuda(q, k, v, out.detach(), do, lse)
    torch.cuda.synchronize()
    check(fa.bwd_launches - n0 == 2, "autograd launched the (192, 128) "
          f"backward once ({fa.bwd_launches - n0 - 1} launches)")
    check(all(torch.equal(a, b) for a, b in zip(grads, direct)),
          "autograd's (192, 128) gradients = the kernel's direct output")

    row = {}
    for dt, key in ((bf, ""), (f32, "f32_")):
        q, k, v, o, do, lse, err = timed[dt]
        row.update({key + name: x for name, x in bwd_time(
            torch, clock, q, k, v, o, do, lse, dict(causal=True), err,
            plain_reps=5).items()})

    q, k, v, o, do, lse, _ = timed[bf]
    reps = 10

    def calls():
        for _ in range(reps):
            clock.flush.zero_()
            fa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    split = profiled(torch, calls, kernels=("flash_bwd_dq_kernel<192",
                                            "flash_bwd_dkdv_kernel<192"))
    row["launch_ms"] = {name: t / reps
                        for name, t in split["kernel_ms"].items()}
    check(all(t > 0 for t in row["launch_ms"].values()),
          f"both (192, 128) backward launches seen by the profiler: "
          f"{row['launch_ms']}")
    emit("mla_attention_bwd_time", row)
    return row


def train_cut(torch, *, arch, name, n_layers, n_dense_prefix, n_experts,
              **_):
    """``arch`` cut in depth to ``n_layers`` (``n_dense_prefix`` of them
    dense) and to ``n_experts`` routed experts, registered as ``name`` so
    ``launch.train.main --arch name`` trains it."""
    from repro_torch.configs.base import get_config, register

    full = get_config(arch)
    cut = full.replace(name=name, n_layers=n_layers,
                       n_dense_prefix=n_dense_prefix,
                       moe=dataclasses.replace(full.moe, n_experts=n_experts))
    register(name)(lambda: cut)
    return full, cut


def trainer_run(torch, dev, cfg, *, steps, batch, seq, fwd, bwd, reckoned,
                limit=None, run=None):
    """``repro_torch.launch.train.main`` on the registered ``cfg`` for
    ``steps`` steps at B x S = ``batch`` x ``seq`` and the trainer's
    defaults (no checkpoints), or ``run(on_step) -> (parameters, log)``,
    another loop that calls ``on_step(step, metrics, params)`` after each
    of its ``steps`` steps and logs "training complete" at its end;
    counters reset just before and read just after: ``fwd`` flash forward
    and ``bwd`` gradient launches every step, every loss finite, the mean
    of the last 5 under that of the first 5, and the peak, less what was
    allocated before, within ``limit`` (by default ``reckoned``).
    Returns (the trained parameters, the row: step ms, tokens/s, peak
    bytes, losses, aux losses)."""
    import shutil

    from repro_torch.kernels import ops

    walls, losses, auxes, per_step = [], [], [], []
    last = {"t": 0.0, "n": (0, 0)}

    def on_step(step, m, params):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append((now - last["t"]) * 1e3)
        last["t"] = now
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
        c = ops.launch_counts()
        n = (c["flash_attention"], c["flash_attention_bwd"])
        per_step.append((n[0] - last["n"][0], n[1] - last["n"][1]))
        last["n"] = n

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    work = ROOT / "build" / "chip_smoke_ckpt" / cfg.name
    shutil.rmtree(work, ignore_errors=True)
    ops.reset_launch_counts()
    last["t"] = time.perf_counter()
    t0 = last["t"]
    if run is None:
        def run(on_step):
            return train_run(torch, dev, [
                "--arch", cfg.name, "--steps", str(steps), "--batch",
                str(batch), "--seq", str(seq), "--ckpt-dir", str(work),
                "--ckpt-every", "0", "--log-every", "10"], on_step)
    model, log = run(on_step)
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"every {cfg.name} training loss finite")
    first, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last5 < first, f"{cfg.name} loss fell: mean of the first 5 "
          f"{first}, of the last 5 {last5}")
    check(all(n == (fwd, bwd) for n in per_step),
          f"{cfg.name}: {fwd} flash forward and {bwd} gradient launches a "
          f"step: {sorted(set(per_step))}")
    check("training complete" in log, f"the {cfg.name} trainer finished")
    limit = reckoned if limit is None else limit
    check(peak - held <= limit, f"{cfg.name}: training peak {peak - held} "
          f"within {limit} (reckoned {reckoned})")
    steady = walls[1:]
    return model, {
        "config": cfg.name, "dtype": str(cfg.dtype), "batch": batch,
        "seq": seq, "steps": steps, "n_layers": cfg.n_layers,
        "remat": cfg.remat,
        "params": sum(p.numel() for p in model.parameters()),
        "step_ms_first": walls[0],
        "step_ms_p50": float(np.percentile(steady, 50)),
        "step_ms_p95": float(np.percentile(steady, 95)),
        "tokens_per_s": batch * seq / float(np.percentile(steady, 50)) * 1e3,
        "tokens_per_s_overall": batch * seq * steps / total_s,
        "max_memory_allocated_bytes": peak,
        "allocated_before_bytes": held, "training_peak_bytes": peak - held,
        "reckoned_peak_bytes": reckoned,
        "losses": losses, "mean_loss_first_5": first,
        "mean_loss_last_5": last5, "aux_first": auxes[0],
        "aux_last": auxes[-1],
        "flash_launches_per_step": {"flash_attention": per_step[0][0],
                                    "flash_attention_bwd": per_step[0][1]},
        "launches": launches}


def grads_twice(torch, dev, cfg, model, *, batch, seq, batches=None):
    """Two gradients of one batch (seeded tokens, or the first of
    ``batches``, two model batches) on the trained parameters: whether
    every leaf has the same bits.  Returns (same, two batches)."""
    import gc

    from repro_torch.data.tokens import batch_iterator
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import common as cm
    from repro_torch.models.api import model_api

    api = model_api(cfg)
    if batches is None:
        it = batch_iterator(batch, seq, seed=7, vocab_size=cfg.vocab_size)
        batches = [{"tokens": torch.from_numpy(next(it)["tokens"]).to(dev)}
                   for _ in range(2)]
    twice = [dict(cm.leaves(loss_and_grads(api.loss, model, batches[0])[2]))
             for _ in range(2)]
    torch.cuda.synchronize()
    same = sorted(twice[0]) == sorted(twice[1]) and same_bits(
        torch, [twice[0][p] for p in twice[0]],
        [twice[1][p] for p in twice[0]])
    check(same, f"two {cfg.name} gradients of one batch have the same bits")
    del twice
    gc.collect()
    return same, batches


def train_step_profile(torch, cfg, model, batches, flash) -> dict:
    """A ``torch.profiler`` window over one train step on the second of
    two model ``batches`` (after a warm one on the first) from a fresh
    optimizer state, with the device ms of the ``flash``
    kernels, each of which must have run, and by kind: elementwise passes
    (AdamW's per-leaf update, the norms), reductions, cuBLAS products
    (gemm / nvjet)."""
    import gc

    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    ocfg = adamw.AdamWConfig(total_steps=2)
    state = {"lm": model, "opt": adamw.init_opt_state(model, ocfg)}
    step = build_train_step(cfg, ocfg)

    def one(b):
        state["lm"], state["opt"], _ = step(state["lm"], state["opt"], b)
    one(batches[0])                           # warm
    prof = profiled(torch, lambda: one(batches[1]),
                    kernels=flash + ("elementwise", "reduce", "gemm",
                                     "nvjet"))
    check(all(prof["kernel_ms"][k] > 0 for k in flash),
          f"the flash kernels ran in the profiled {cfg.name} step: "
          f"{prof['kernel_ms']}")
    del state, step
    gc.collect()
    return prof


def deepseek_train_phase(torch, dev, *, steps, batch, seq, **cut_kw):
    """(b) the full-width ``deepseek-v3-671b`` cut to ``cut_kw``, bf16,
    through ``trainer_run``: under remat the dense prefix's MLA runs its
    flash forward once a step and the body's twice (the forward and its
    recomputation), one gradient launch a layer; two MoE calls a MoE layer
    a step, the recomputed call's expert ids equal to the forward's; the
    peak within its reckoning plus DEEPSEEK_PEAK_MARGIN; step ms,
    tokens/s, peak bytes, the MoE's dropped share and aux loss; then,
    on the trained weights, two gradients of one batch with the same bits
    (the MoE's backward adds in a fixed order) and a ``torch.profiler``
    window over one train step."""
    import gc

    from repro_torch.models import common as cm
    from repro_torch.models.api import model_api

    full, cfg = train_cut(torch, **cut_kw)
    n_moe = cfg.n_layers - cfg.n_dense_prefix
    specs = [s for _, s in cm.leaves(model_api(cfg).param_specs())]
    n_params = sum(math.prod(s.shape) for s in specs)
    largest = max(math.prod(s.shape) for s in specs)
    # bf16 parameters and gradients, f32 masters and two moments, three
    # f32 temporaries of the largest leaf in AdamW's update
    reckoned = n_params * (2 + 2 + 3 * 4) + 3 * 4 * largest
    emit("deepseek_train_cuts", {
        "config": cfg.name,
        "cuts": [f"depth {full.n_layers} -> {cfg.n_layers} "
                 f"({cfg.n_dense_prefix} dense-prefix layer, d_ff "
                 f"{cfg.d_ff_dense_prefix}, and {n_moe} MoE layer)",
                 f"routed experts {full.moe.n_experts} -> "
                 f"{cfg.moe.n_experts} (top-{cfg.moe.top_k} and "
                 f"{cfg.moe.n_shared} shared expert kept)",
                 f"B x S = {batch} x {seq}"],
        "widths": "as published: d_model 7168, 128 heads, MLA ranks 1536 / "
                  "512, heads 128 + 64 / 128, d_ff_expert 2048, vocab "
                  "129280, untied",
        "remat": cfg.remat,
        "params": n_params, "reckoned_peak_bytes": reckoned,
        "card_bytes": torch.cuda.get_device_properties(0).total_memory})
    gc.collect()
    torch.cuda.empty_cache()
    check(reckoned < torch.cuda.get_device_properties(0).total_memory,
          f"the cut's reckoned peak {reckoned} fits the card")
    check(cfg.remat, "the DeepSeek cut trains under remat, as the "
          "reference's config does")
    fwd = cfg.n_dense_prefix + 2 * n_moe
    with MoESpy() as spy:
        model, out = trainer_run(
            torch, dev, cfg, steps=steps, batch=batch, seq=seq, fwd=fwd,
            bwd=cfg.n_layers, reckoned=reckoned,
            limit=reckoned + DEEPSEEK_PEAK_MARGIN)
    # routes, counted by ``_route``: the recomputation stops (PyTorch's
    # early stop) once it has every tensor the backward needs, before
    # ``moe_apply`` returns, so ``spy.stats`` holds the forward's calls
    check(len(spy.ids) == 2 * steps * n_moe,
          f"two MoE calls a MoE layer a step (the forward and its "
          f"recomputation): {len(spy.ids)} in {steps} steps")
    # each step: the forward's MoE calls in layer order, then the
    # recomputed ones, last period first
    same_ids = True
    for s in range(steps):
        ids = spy.ids[2 * n_moe * s:2 * n_moe * (s + 1)]
        for a, b in zip(ids[:n_moe], reversed(ids[n_moe:])):
            same_ids &= torch.equal(a, b)
    check(same_ids, "every recomputed MoE call routed to the forward's "
          "expert ids")
    dropped = [float(st.dropped_frac) for st in spy.stats]
    out.update({
        "moe_calls_per_step": len(spy.ids) // steps,
        "moe_stats_recorded": len(spy.stats),
        "recomputed_ids_equal_forward": same_ids,
        "moe_dropped_frac_first": dropped[0],
        "moe_dropped_frac_last": dropped[-1],
        "moe_dropped_frac_mean": float(np.mean(dropped))})
    out["grads_same_bits_twice"], toks = grads_twice(
        torch, dev, cfg, model, batch=batch, seq=seq)
    flash = ("flash_wgmma_kernel<192", "flash_bwd_dq_kernel<192",
             "flash_bwd_dkdv_kernel<192")
    out["profile"] = prof = train_step_profile(torch, cfg, model, toks,
                                               flash)
    emit("deepseek_train_phase", out)
    emit("deepseek_train_profile", prof)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def deepseek_replay_cut(torch, dtype, *, arch, n_layers, d_model, n_heads,
                        d_ff_dense_prefix, vocab_size, n_experts, top_k,
                        d_ff_expert, **_):
    """DEEPSEEK_REPLAY's cut of ``arch`` in ``dtype``."""
    from repro_torch.configs.base import get_config

    base = get_config(arch)
    return base.replace(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=n_heads, d_ff_dense_prefix=d_ff_dense_prefix,
        vocab_size=vocab_size, dtype=dtype,
        moe=dataclasses.replace(base.moe, n_experts=n_experts, top_k=top_k,
                                d_ff_expert=d_ff_expert))


def deepseek_train_replay(torch, dev, *, batch, seq, steps):
    """(c) ``steps`` f32 train steps of DEEPSEEK_REPLAY's cut on the card
    and on the CPU port from the same weights: the same expert ids at every
    MoE call of every step (the recomputed ones under remat too), loss,
    grad norm and masters within TRAIN_REPLAY_TOL (``replay_train``)."""
    cfg = deepseek_replay_cut(torch, torch.float32, **DEEPSEEK_REPLAY)
    with MoESpy() as spy:
        out = replay_train(torch, dev, cfg, batch=batch, seq=seq,
                           steps=steps)
    # under remat each MoE call routes again in the backward pass
    n = steps * (cfg.n_layers - cfg.n_dense_prefix) * (1 + cfg.remat)
    check(len(spy.ids) == 2 * n, f"replay MoE calls {len(spy.ids)}")
    for j, (a, b) in enumerate(zip(spy.ids[:n], spy.ids[n:])):
        check(torch.equal(a.cpu(), b.cpu()),
              f"DeepSeek train replay expert ids at MoE call {j}")
    out.update({"config": f"{cfg.name} cut as DEEPSEEK_REPLAY, f32",
                "moe_calls_equal_ids": n})
    emit("deepseek_train_replay", out)
    return out


def kill_resume(torch, dev, cfg, *, steps, ckpt_every, kill_at, batch, seq):
    """``cfg`` (registered under its name here) through
    ``launch.train.main``: ``--kill-at`` exits 42, the checkpoint restores
    bit-equal to the parameters saved, and the rerun resumes and
    finishes."""
    import shutil

    from repro_torch import convert
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.configs.base import register
    from repro_torch.models import common as cm
    from repro_torch.models.lm import lm_param_specs

    register(cfg.name)(lambda: cfg)
    kdir = ROOT / "build" / "chip_smoke_ckpt" / f"{cfg.name}_kill"
    shutil.rmtree(kdir, ignore_errors=True)
    base = ["--arch", cfg.name, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--ckpt-dir", str(kdir), "--ckpt-every",
            str(ckpt_every)]
    saved = {}

    def snap(step, m, params):
        if step == ckpt_every:
            saved["tree"] = convert.lm_params_to_tree(params)

    code, _ = train_run(torch, dev, base + ["--kill-at", str(kill_at)], snap)
    check(code == 42, f"{cfg.name} --kill-at exits 42 (got {code!r})")
    ck = kdir / cfg.name
    check(ckpt_mod.latest_step(ck) == ckpt_every,
          f"latest {cfg.name} checkpoint after the kill: "
          f"{ckpt_mod.latest_step(ck)}")
    back = ckpt_mod.restore(ck, ckpt_every, saved["tree"], device=dev)
    bit_equal = same_bits(torch, [a.cpu() for _, a in cm.leaves(back)],
                          [b for _, b in cm.leaves(saved["tree"])])
    check(bit_equal, f"restored {cfg.name} parameters bit-equal to the "
          "saved")
    top = sorted(k for k in lm_param_specs(cfg) if k != "layers")
    check(sorted(k for k in saved["tree"] if k not in ("prefix", "body"))
          == top, f"the {cfg.name} checkpoint holds every top-level leaf "
          f"{top}")
    seen = []
    _, log = train_run(torch, dev, base,
                       lambda s, m, p: seen.append((s, float(m["loss"]))))
    check(f"[restore] resuming from step {ckpt_every}" in log
          and "training complete" in log,
          f"the {cfg.name} rerun resumed and finished")
    check([s for s, _ in seen] == list(range(ckpt_every + 1, steps + 1)),
          f"resumed steps {[s for s, _ in seen]}")
    check(all(np.isfinite(x) for _, x in seen), "resumed losses finite")
    shutil.rmtree(kdir, ignore_errors=True)
    return {"steps": steps, "ckpt_every": ckpt_every, "kill_at": kill_at,
            "batch": batch, "seq": seq, "exit_code": code,
            "resumed_from": ckpt_every, "restored_bit_equal": bit_equal,
            "top_level_leaves": top,
            "resumed_losses": seen}


def deepseek_kill_resume(torch, dev, **kw):
    """(d) DEEPSEEK_REPLAY's cut in bf16 through ``kill_resume``."""
    cfg = deepseek_replay_cut(torch, torch.bfloat16, **DEEPSEEK_REPLAY)
    cfg = cfg.replace(name=cfg.name + "-replay-cut")
    out = {"config": f"{cfg.name} (DEEPSEEK_REPLAY's cut), bf16",
           **kill_resume(torch, dev, cfg, **kw)}
    emit("deepseek_train_kill_resume", out)
    return out


# ----------------------------------------------------------------- step 19
def limit_share(got, want, tol) -> tuple:
    """(the largest |got - want| / (atol + rtol |want|), the entries past
    that limit) for ``tol`` = (atol, rtol)."""
    share = (got.float() - want.float()).abs() / (
        tol[0] + tol[1] * want.float().abs())
    return float(share.max()), int((share > 1).sum())


def first_tile_dropped(torch, q, k, v, *, causal, window, softcap):
    """What a kernel reads whose window's lower key-tile bound is one tile
    too high: each 128-row query tile whose window starts past key 0 (the
    kernel's ``key_range`` begin > 0) leaves out the keys of that first
    tile.  Returns ([B, S, H, dv] in q's dtype, the (row, key) pairs of the
    window dropped)."""
    B, S, H, dh = q.shape
    Kv = k.shape[2]
    G = H // Kv
    pos = torch.arange(S, device=q.device)
    keep = pos[:, None] - pos[None, :] < window
    if causal:
        keep &= pos[None, :] <= pos[:, None]
    lo = (pos // 128 * 128 - window + 1).clamp(min=0) // 128
    drop = keep & (pos[None, :] // 128 == lo[:, None]) & (lo[:, None] > 0)
    keep &= ~drop
    out = torch.empty((B, S, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    for b in range(B):
        for j in range(Kv):
            hs = slice(j * G, (j + 1) * G)
            s = torch.einsum("qgd,kd->gqk", q[b, :, hs].float(),
                             k[b, :, j].float()) * dh ** -0.5
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            p = s.masked_fill(~keep, float("-inf")).softmax(-1)
            out[b, :, hs] = torch.einsum("gqk,kd->qgd", p,
                                         v[b, :, j].float()).to(q.dtype)
    return out, int(drop.sum())


def next_head_read(torch, q, k, v, kw):
    """What a kernel reads whose rows of a head narrower than its 128-wide
    tile are loaded 128 wide, the columns past dh the next head's first
    (``widen_next_head``), with the scale kept at dh^-0.5: the plain
    version's output on those rows, its first dh columns, in q's dtype."""
    from repro_torch.kernels import flash_attention as fa

    dh = q.shape[-1]
    wide = -(-dh // 64) * 64
    f = (wide / dh) ** 0.5
    w = [widen_next_head(torch, t, wide).float() for t in (q, k, v)]
    return fa.flash_attention_plain(w[0] * f, w[1], w[2], **kw)[
        ..., :dh].to(q.dtype)


def dense_attention_checks(torch, clock, dev, cases=DENSE_ATTN_CASES,
                           timed=DENSE_TIMED, tag="dense_attention",
                           seed=190, next_head=False):
    """(a) ``flash_attention_cuda`` against ``flash_attention_plain`` at
    every ``cases`` shape, bf16 within DENSE_BF16_TOL and f32 within
    ATTN_TOL, the same bits from two calls.  At a windowed bf16 shape
    where the window's lower key-tile bound is past 0 (the S = 5000
    prefills over many tiles, window 1, S = 333 at window 100) the output
    of a kernel that drops the window's first key tile must fall outside
    DENSE_BF16_TOL; with ``next_head``, at every bf16 shape of a head width
    no multiple of 64, so must the output of one whose heads also read the
    next head's first columns (``next_head_read``), but at window 1, where
    each row keeps one key and its output is that key's v whatever the
    scores.  ``timed`` (step 19:
    h2o's prefill, (120, 120), and gemma2's windowed one, (128, 128)) are
    timed in bf16, each not at 128 beside the (128, 128) instance at its
    (B, S, H, Kv).  Returns the time rows."""
    from repro_torch.kernels import flash_attention as fa

    rows, dropped = [], 0
    for i, (B, S, H, Kv, dh, causal, window, cap) in enumerate(cases):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = attn_inputs(torch, B, S, H, Kv, dh, dt, seed + i, dev)
            kw = dict(causal=causal, window=window, softcap=cap)
            got = fa.flash_attention_cuda(q, k, v, **kw)
            again = fa.flash_attention_cuda(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            bf = dt == torch.bfloat16
            tol = DENSE_BF16_TOL if bf else (ATTN_TOL["float32"],) * 2
            err, ok = attn_close(got, want, dt, tol)
            where = dict(B=B, S=S, H=H, Kv=Kv, dh=dh, dtype=str(dt), **kw)
            check(tuple(got.shape) == (B, S, H, dh),
                  f"flash_attention shape at {where}")
            check(ok and bool(torch.isfinite(got).all()),
                  f"flash_attention err {err} past {tol} at {where}")
            same = same_bits(torch, [got], [again])
            check(same, f"flash_attention same bits twice at {where}")
            rec = {**where, "max_abs_err": err, "tol": tol,
                   "limit_share": limit_share(got, want, tol)[0],
                   "same_bits_twice": same}
            faults = {}
            if bf and window:
                bad, n_drop = first_tile_dropped(torch, q, k, v, **kw)
                if n_drop:
                    faults["first_tile_dropped"] = (bad, n_drop,
                                                    "pairs_dropped")
                    dropped += 1
            if bf and next_head and dh % 64 and window != 1:
                faults["next_head"] = (next_head_read(torch, q, k, v, kw),
                                       -(-dh // 64) * 64 - dh,
                                       "columns_read")
            for fault, (bad, n, what) in faults.items():
                dev_err, caught = attn_close(bad, want, dt, tol)
                share, n_over = limit_share(bad, want, tol)
                check(not caught, f"DENSE_BF16_TOL rejects the {fault} "
                      f"output at {where}: {n} {what}, err {dev_err}")
                rec[fault] = {what: n, "max_abs_err": dev_err,
                              "limit_share": share,
                              "entries_past_limit": n_over}
            del faults
            emit(f"{tag}_check", rec)
            if bf and i in timed:
                rows.append(attn_time(torch, clock, q, k, v, kw, err,
                                      plain_as_called=True))
            del q, k, v, got, again, want
    check(dropped or not any(c[6] for c in cases),
          f"{tag}: a windowed shape held the first-tile fault")
    for i, row in zip(timed, rows):
        B, S, H, Kv, dh, causal, window, cap = cases[i]
        if dh != 128:
            q, k, v = attn_inputs(torch, B, S, H, Kv, 128, torch.bfloat16, 7,
                                  dev)
            kw = dict(causal=causal, window=window, softcap=cap)
            row["dh128_same_shape_ms"] = clock.ms(
                lambda: fa.flash_attention_cuda(q, k, v, **kw))
            del q, k, v
    for row in rows:
        emit(f"{tag}_time", row)
    torch.cuda.empty_cache()
    return rows


def dense_reckon(cfg, batch: int, prompt: int, max_len: int,
                 n_vis: int = 0) -> dict:
    """Bytes before a run: the weights (from the parameter specs), the
    caches (a ring of ``sliding_window`` slots on a sliding-window layer
    whose ``max_len`` reaches it; int8 values plus an f32 scale a token
    and head under ``kv_cache_dtype="int8"``), the prefill's transients
    (three d_ff-wide activations of the MLP, six f32 head-wide ones of
    rotary embedding and four d_model-wide ones, a position each of the
    ``n_vis`` frontend tokens and the ``prompt`` text tokens), the
    frontend's (the f32 patch embeddings, their f32 product with an f32
    copy of ``vis_proj`` and its cast) and init's (the largest leaf drawn
    in f32 beside its cast).  ``max_len`` counts the frontend tokens."""
    from repro_torch.models import common as cm
    from repro_torch.models.lm import lm_param_specs

    es = cfg.dtype.itemsize
    sizes = [int(np.prod(s.shape)) for _, s in cm.leaves(
        lm_param_specs(cfg))]
    int8 = cfg.kv_cache_dtype == "int8"
    caches = 0
    for mk, _ in cfg.layer_kinds():
        T = (min(max_len, cfg.sliding_window) if mk == cm.MIXER_SWA
             else max_len)
        caches += 2 * batch * T * cfg.n_kv_heads * (
            cfg.d_head + 4 if int8 else cfg.d_head * es)
    n = batch * (n_vis + prompt)
    transients = n * (3 * cfg.d_ff * es + 6 * cfg.n_heads * cfg.d_head * 4
                      + 4 * cfg.d_model * es)
    d = cfg.d_model
    frontend = (batch * n_vis * d * (8 + es) + 4 * d * d) if n_vis else 0
    out = {"weights_bytes": sum(sizes) * es, "cache_bytes": caches,
           "prefill_transient_bytes": transients,
           "frontend_bytes": frontend,
           "init_transient_bytes": 4 * max(sizes)}
    out["serve_bytes"] = (out["weights_bytes"] + caches + transients
                          + frontend)
    out["init_bytes"] = out["weights_bytes"] + out["init_transient_bytes"]
    return out


def dense_serve_phase(torch, dev, name, *, batch, prompt, new_tokens,
                      profile=False, int8_arm=False, n_vis=0):
    """(b)-(d) ``name`` at full width, bf16, weights seeded on the card,
    through model_api's entry points (serve_run): ``batch`` prompts of
    ``prompt`` tokens (each after ``n_vis`` seeded f32 patch embeddings,
    a vision model's image, where given) prefilled twice, then
    ``new_tokens`` greedy steps; check_served's checks and the peaks
    within their reckoning (a reckoned peak past DENSE_PEAK_LIMIT cuts the
    depth by whole periods).
    ``int8_arm``: the same with an int8 cache fed the bf16 arm's tokens,
    its logits within INT8_BOUND of the bf16 arm's at every step.
    ``profile``: a profiler window over one prefill and PROFILE_DECODE
    steps."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.models.api import model_api

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    full = get_config(name)
    cfg = full
    max_len = n_vis + prompt + new_tokens
    rk = dense_reckon(cfg, batch, prompt, max_len, n_vis)
    while before + rk["serve_bytes"] > DENSE_PEAK_LIMIT:
        cfg = cfg.replace(n_layers=cfg.n_layers - cfg.period)
        rk = dense_reckon(cfg, batch, prompt, max_len, n_vis)
    emit("dense_cuts", {
        "config": name, "n_layers": f"{full.n_layers} -> {cfg.n_layers}",
        "cut": cfg.n_layers != full.n_layers,
        "why": f"reckoned peak {before + rk['serve_bytes']} bytes against "
               f"{DENSE_PEAK_LIMIT:.0f}",
        "widths": "as published; random weights seeded on the card",
        "reckoned": rk, "allocated_before_bytes": before})
    model, init = card_model(torch, dev, cfg)
    tokens = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)).to(dev)
    extra = None if not n_vis else torch.randn(
        (batch, n_vis, cfg.d_model), device=dev,
        generator=torch.Generator(device=dev).manual_seed(21))
    out = {"config": cfg.name, "n_layers": cfg.n_layers, "batch": batch,
           "prompt": prompt, "frontend_tokens": n_vis,
           "new_tokens": new_tokens, **init,
           "init_peak_reckoned_bytes": before + rk["init_bytes"],
           "reckoned": rk, "arms": {}}
    check(init["weights_bytes"] == rk["weights_bytes"],
          f"{name}: weights {init['weights_bytes']} bytes as reckoned "
          f"{rk['weights_bytes']}")
    check(init["init_peak_bytes"] <= before + rk["init_bytes"],
          f"{name}: init peak {init['init_peak_bytes']} within "
          f"{before + rk['init_bytes']}")
    arms = [("bf16", cfg)]
    if int8_arm:
        arms.append(("int8", cfg.replace(kv_cache_dtype="int8")))
    fed = logits = None
    for arm, acfg in arms:
        arm_rk = dense_reckon(acfg, batch, prompt, max_len, n_vis)
        m, toks, arm_logits, caches = serve_run(
            torch, model_api(acfg), model, tokens, new_tokens,
            forced=None if arm == "bf16" else fed, extra=extra)
        m["cache_bytes"] = sum(
            t.numel() * t.element_size() for c in caches for t in c
            if isinstance(t, torch.Tensor) and t.dim() > 0)
        m["serve_peak_reckoned_bytes"] = before + arm_rk["serve_bytes"]
        check(m["cache_bytes"] == arm_rk["cache_bytes"],
              f"{name} ({arm}): cache {m['cache_bytes']} bytes as reckoned "
              f"{arm_rk['cache_bytes']}")
        check(m["max_memory_allocated_bytes"]
              <= m["serve_peak_reckoned_bytes"],
              f"{name} ({arm}): serving peak "
              f"{m['max_memory_allocated_bytes']} within its reckoning "
              f"{m['serve_peak_reckoned_bytes']}")
        check_served(f"{name} ({arm})", m, cfg.n_layers, max_len)
        if arm == "bf16":
            fed, logits = toks, arm_logits
        else:
            rel = [float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(arm_logits, logits)]
            check(max(rel) < INT8_BOUND, f"{name}: int8-cache logits within "
                  f"{INT8_BOUND} of the bf16 arm's: {max(rel)}")
            m["relative_err_vs_bf16_per_step"] = rel
            m["greedy_agreement_vs_bf16"] = float(
                (torch.stack([a.argmax(-1) for a in arm_logits], 1)
                 == fed).float().mean())
        del caches
        out["arms"][arm] = m
    if profile:
        api = model_api(cfg)
        flash = (f"flash_wgmma_kernel<{cfg.d_head}",)
        prof = serve_profile(torch, api, model, tokens,
                             api.init_cache(batch, max_len, device=dev),
                             flash, extra=extra)
        check(prof["prefill"]["kernel_ms"][flash[0]] > 0,
              f"{flash[0]}> ran in the profiled prefill")
        out["profile"] = prof
        emit("dense_profile", {"config": name, **prof})
    out["flash_launches"] = sum(m["launches"]["flash_attention"]
                                for m in out["arms"].values())
    emit("dense_serve_phase", out)
    del model, logits, extra
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dense_replay_cut(name, dtype, *, d_model, n_heads, n_kv_heads, d_ff,
                     n_layers, sliding_window, vocab_size, **_):
    """``name`` cut to DENSE_REPLAY's widths in ``dtype``: its own head
    width, softcaps, activation and remat as published."""
    from repro_torch.configs.base import get_config

    return get_config(name).replace(
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads, d_ff=d_ff,
        n_layers=n_layers, sliding_window=sliding_window,
        vocab_size=vocab_size, dtype=dtype)


def dense_replay_phase(torch, dev, *, d_model, n_heads, n_kv_heads, d_ff,
                       n_layers, sliding_window, vocab_size, batch, prompt,
                       new_tokens, names=("gemma2-27b", "h2o-danube-3-4b"),
                       n_vis=0, tag="dense_replay_phase"):
    """(e) ``names`` (gemma2 and h2o) cut to these widths (their head
    widths, softcaps and activations as published), f32, the same seeded
    weights on the card and on the CPU port, each prompt after ``n_vis``
    seeded f32 patch embeddings where given: equal greedy tokens, logits
    within DENSE_REPLAY_TOL of the largest, one flash launch a layer a
    prefill on the card; then on the card each decode step's logits
    against the last-token logits of one prefill over the whole sequence
    so far (the patch embeddings in front)."""
    from repro_torch.models import common as cm
    from repro_torch.models.api import model_api

    out = {"cut": f"d_model {d_model}, {n_heads} heads / {n_kv_heads} kv, "
                  f"d_ff {d_ff}, {n_layers} layers, window "
                  f"{sliding_window}, vocab {vocab_size}, f32",
           "batch": batch, "prompt": prompt, "frontend_tokens": n_vis,
           "new_tokens": new_tokens, "configs": {}}
    prompt_np = np.random.default_rng(2).integers(
        0, vocab_size, (batch, prompt)).astype(np.int32)
    extra_np = None if not n_vis else np.random.default_rng(3).normal(
        size=(batch, n_vis, d_model)).astype(np.float32)
    for name in names:
        cfg = dense_replay_cut(name, torch.float32, d_model=d_model,
                               n_heads=n_heads, n_kv_heads=n_kv_heads,
                               d_ff=d_ff, n_layers=n_layers,
                               sliding_window=sliding_window,
                               vocab_size=vocab_size)
        api = model_api(cfg)
        runs = {}
        for device in (dev, "cpu"):
            model = api.init(torch.Generator().manual_seed(0), device=device)
            runs[str(device)] = (*replay_run(torch, api, model, prompt_np,
                                             new_tokens, device, extra_np),
                                 model)
        gtok, glog, flash, gmodel = runs[str(dev)]
        ctok, clog, _, _ = runs["cpu"]
        scale = float(clog.abs().max())
        err = float((glog - clog).abs().max())
        check(torch.equal(gtok, ctok), f"{name} replay greedy tokens card "
              f"{gtok.tolist()} vs CPU {ctok.tolist()}")
        check(err <= DENSE_REPLAY_TOL * scale,
              f"{name} replay f32 logits err {err} of {scale}")
        check(flash == n_layers, f"{name}: {n_layers} f32 flash launches a "
              f"prefill on the card: {flash}")
        # decode step i fed token i at position prompt + i: its logits are
        # the last-token logits of the prompt and tokens 0 .. i prefilled
        seq = torch.cat([torch.from_numpy(prompt_np), gtok[:, :-1]],
                        dim=1).to(dev)
        extra = None if extra_np is None else torch.from_numpy(extra_np).to(
            dev)
        worst = 0.0
        for i in range(new_tokens):
            L = prompt + i + 1
            whole, _ = api.prefill(gmodel, frontend_batch(
                seq[:, :L], extra), api.init_cache(
                    batch, n_vis + L, device=dev))
            d = float((whole.cpu() - glog[i + 1]).abs().max())
            worst = max(worst, d / float(whole.abs().max()))
        check(worst <= DENSE_REPLAY_TOL, f"{name}: decode vs whole-sequence "
              f"prefill relative err {worst}")
        out["configs"][name] = {
            "tokens": gtok[0].tolist(), "max_abs_logit_err": err,
            "max_abs_logit": scale, "relative_err": err / scale,
            "flash_launches_prefill": flash,
            "decode_vs_prefill_relative_err": worst, "d_head": cfg.d_head,
            "ring_wrapped": cm.MIXER_SWA in cfg.mixers
            and n_vis + prompt + new_tokens > sliding_window}
        del runs, gmodel
    emit(tag, out)
    return out


# ----------------------------------------------------------------- step 20
def widen_next_head(torch, t, to: int):
    """[B, S, h, d] (contiguous) -> [B, S, h, to] whose columns d .. to - 1
    are the ``to - d`` elements after each row in memory (the next head's
    first columns; zeros past the tensor's end): what a load of ``to``
    columns a row reads."""
    B, S, h, d = t.shape
    flat = torch.cat([t.reshape(-1), t.new_zeros(to - d)])
    rows = torch.arange(B * S * h, device=t.device)[:, None] * d
    return flat[rows + torch.arange(to, device=t.device)].reshape(B, S, h,
                                                                  to)


def faulty_grads(torch, q, k, v, o, do, lse, want, kw) -> dict:
    """The gradients of faulty kernels, built from
    ``flash_attention_bwd_plain`` on the same inputs and lse or from its
    gradients ``want``: ``first_tile``, one whose window's lower key-tile
    bound is a 64-key tile too high (each 64-row query tile whose
    ``key_tiles`` begin is past 0 leaves out that first tile's keys; at a
    window of 64 or more); ``next_head``, one whose rows of a head
    narrower than its 128-wide tile are read 128 wide, columns 120-127 the
    next head's first 8 (at dh 120; 96-127, its first 32, at dh 96);
    ``dq_tail`` and ``dv_tail``, one
    whose dq (dv) is 0.9 of the true one on the queries (keys) at or past
    position min(4096, S // 2) (where a row there passes the limit's
    floor: at window 1 dq is rounding residue).  {name: ((dq, dk, dv) in
    q's dtype, the (row, key) pairs, columns or rows it gets wrong)}."""
    from repro_torch.kernels import flash_attention as fa

    out = {}
    tail = min(4096, q.shape[1] // 2)
    for i, name in ((0, "dq_tail"), (2, "dv_tail")):
        bad = list(want)
        bad[i] = want[i].clone()
        bad[i][:, tail:] *= 0.9
        n = int((row_rms(want[i][:, tail:])
                 >= DENSE_BWD_BF16_TOL[2]).sum())
        if n:
            out[name] = (tuple(bad), n)
    S, dh = q.shape[1], q.shape[3]
    window = kw["window"]
    if window >= 64:
        masks = fa._bwd_masks
        pos = torch.arange(S, device=q.device)
        lo = (pos // 64 * 64 - window + 1).clamp(min=0) // 64
        drop = (pos[None, :] // 64 == lo[:, None]) & (lo[:, None] > 0)
        n = int((masks(S, kw["causal"], window, q.device) & drop).sum())
        fa._bwd_masks = lambda *a: masks(*a) & ~drop
        try:
            out["first_tile"] = (fa.flash_attention_bwd_plain(
                q, k, v, o, do, lse, **kw), n)
        finally:
            fa._bwd_masks = masks
    if dh % 64:
        wide = -(-dh // 64) * 64
        f = (wide / dh) ** 0.5           # keeps the scale at dh^-0.5
        w = [widen_next_head(torch, t, wide).float() for t in (q, k, v, o,
                                                               do)]
        dq, dk, dv = fa.flash_attention_bwd_plain(w[0] * f, *w[1:], lse,
                                                  **kw)
        out["next_head"] = (tuple(t[..., :dh].to(q.dtype)
                                  for t in (dq * f, dk, dv)), wide - dh)
    return out


def dense_bwd_checks(torch, clock, dev, cases=DENSE_BWD_CASES,
                     timed=DENSE_BWD_TIMED, tag="dense_attention_bwd",
                     seed=700):
    """(a) ``flash_attention_bwd_cuda`` against ``flash_attention_bwd_plain``
    at every ``cases`` shape through ``hold_bwd`` (the forward kernel's lse
    held to the plain version's first): bf16 within DENSE_BWD_BF16_TOL,
    f32 within ATTN_TOL, the same bits from two calls.  At each bf16 shape
    every gradient of ``faulty_grads`` must fail DENSE_BWD_BF16_TOL.
    Autograd through ``ops.flash_attention_bshd`` at the first timed shape
    launches the kernel once and returns the direct call's bits.
    ``timed`` (step 20: h2o's (120, 120) and gemma2's windowed (128, 128))
    are timed by ``bwd_time``, each not at 128 beside the (128, 128)
    instance at its (B, S, H, Kv).  Returns the time rows."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    tol = DENSE_BWD_BF16_TOL
    held = {}
    for i, (B, S, H, Kv, dh, causal, window, cap) in enumerate(cases):
        for dt in (torch.bfloat16, torch.float32):
            bf = dt == torch.bfloat16
            q, k, v = attn_inputs(torch, B, S, H, Kv, dh, dt, seed + i, dev)
            kw = dict(causal=causal, window=window, softcap=cap)
            where = dict(B=B, S=S, H=H, Kv=Kv, dh=dh, dtype=str(dt), **kw)
            row, (o, do, lse, want), err = hold_bwd(
                torch, dev, q, k, v, kw, where, seed + 100 + i,
                scaled=tol if bf else None)
            if bf:
                row["faulty"] = {}
                for fault, (bad, n) in faulty_grads(torch, q, k, v, o, do,
                                                    lse, want, kw).items():
                    over = [(a.float() - b.float()).abs()
                            / scaled_limit(b, tol) for a, b in zip(bad, want)]
                    share = max(float(x.max()) for x in over)
                    check(share > 1, f"DENSE_BWD_BF16_TOL rejects the "
                          f"{fault} gradient at {where}: {share} of the "
                          "limit")
                    row["faulty"][fault] = {
                        "wrong": n, "limit_share": share,
                        "entries_past_limit": sum(int((x > 1).sum())
                                                  for x in over)}
                    del bad, over
            emit(f"{tag}_check", row)
            if bf and i in timed:
                held[i] = (q, k, v, o, do, lse, kw, err)
            del q, k, v, o, do, lse, want
            torch.cuda.empty_cache()

    q, k, v, o, do, lse, kw, _ = held[timed[0]]
    pair = f"({q.shape[-1]}, {v.shape[-1]})"
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention_bshd(*leaves, **kw)
    check(torch.equal(out.grad_fn.saved_tensors[4], lse),
          f"autograd saved the {pair} forward kernel's lse")
    n0 = fa.bwd_launches
    grads = torch.autograd.grad(out, leaves, do)
    direct = fa.flash_attention_bwd_cuda(q, k, v, out.detach(), do, lse,
                                         **kw)
    torch.cuda.synchronize()
    check(fa.bwd_launches - n0 == 2, f"autograd launched the {pair} "
          f"backward once ({fa.bwd_launches - n0 - 1} launches)")
    check(all(torch.equal(a, b) for a, b in zip(grads, direct)),
          f"autograd's {pair} gradients = the kernel's direct output")
    del leaves, out, grads, direct

    rows = [bwd_time(torch, clock, *held[i], plain_as_called=True,
                     plain_reps=5) for i in timed]
    for i, row in zip(timed, rows):
        B, S, H, Kv, dh, causal, window, cap = cases[i]
        if dh == 128:
            continue
        q, k, v = attn_inputs(torch, B, S, H, Kv, 128, torch.bfloat16, 7, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        do = torch.randn_like(o)
        row["dh128_same_shape_ms"] = clock.ms(
            lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw))
        del q, k, v, o, do, lse
    for row in rows:
        emit(f"{tag}_time", row)
    del held
    torch.cuda.empty_cache()
    return rows


def train_reckon(cfg, batch: int, seq: int, period_bytes: int,
                 **extra) -> dict:
    """The terms every train reckoning shares, for a bf16 step of ``cfg``
    at B x S under remat: 16 bytes a parameter (bf16 parameter and
    gradient, f32 master and two moments), then the larger of AdamW's
    three f32 temporaries of the largest leaf (the update runs once the
    backward pass has freed its activations) and the backward pass's
    transients: the remat checkpoints (each period's input saved, four
    more d_model-wide tensors around the body), ``period_bytes`` (one
    period's recomputed activations, by family), each of ``extra`` and the
    loss: the f32 logits every other 512-position chunk saved for its
    backward (two copies under a final softcap: the tanh's output and the
    capped logits) and the chunk in flight (five f32 copies of its logits,
    six under a final softcap, and two of the head's weight gradient).
    ``backward_bytes`` is what one loss-and-gradient pass adds to the
    parameters it is given (``backward_peak`` measures it)."""
    from repro_torch.models import common as cm
    from repro_torch.models.lm import lm_param_specs

    es = cfg.dtype.itemsize
    sizes = [math.prod(s.shape) for _, s in cm.leaves(lm_param_specs(cfg))]
    n, d, V = batch * seq, cfg.d_model, cfg.vocab_size
    out = {"params": sum(sizes), "state_bytes": 16 * sum(sizes),
           "adamw_bytes": 12 * max(sizes),
           "checkpoint_bytes": (cfg.n_layers // cfg.period + 4) * n * d * es,
           "period_bytes": period_bytes,
           "loss_chunk_bytes": batch * min(512, seq) * V * 4 * (
               6 if cfg.final_logit_softcap else 5) + 2 * V * d * es,
           "loss_saved_bytes": (-(-seq // 512) - 1) * batch * 512 * V * 4
           * (2 if cfg.final_logit_softcap else 1), **extra}
    transients = (out["checkpoint_bytes"] + period_bytes
                  + out["loss_saved_bytes"] + out["loss_chunk_bytes"]
                  + sum(extra.values()))
    out["transient_bytes"] = transients
    out["total_bytes"] = out["state_bytes"] + max(out["adamw_bytes"],
                                                  transients)
    out["backward_bytes"] = es * sum(sizes) + transients
    return out


def dense_train_reckon(cfg, batch: int, seq: int, n_vis: int = 0) -> dict:
    """``train_reckon`` of a dense ``cfg``: one period's recomputed
    activations and their gradients are 14 bytes a d_ff column, 28 a
    d_model column, q, k, v and o in bf16 and 8 bytes a head, a token and
    a layer.  ``seq`` counts every position, the ``n_vis`` frontend
    tokens' too; those add their f32 patch embeddings, the f32 product and
    its gradient, and two f32 copies of ``vis_proj`` (the product's
    operand and its gradient)."""
    es, d = cfg.dtype.itemsize, cfg.d_model
    H, Kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    period = cfg.period * batch * seq * (
        14 * cfg.d_ff + 28 * d + es * (2 * H + 2 * Kv) * dh + 8 * H)
    return train_reckon(cfg, batch, seq, period, frontend_bytes=(
        batch * n_vis * d * 12 + 8 * d * d if n_vis else 0))


def dense_train_cut(torch, name: str, batch: int, seq: int,
                    n_vis: int = 0):
    """``name`` at full width, cut while the allocated bytes plus its
    reckoning (``recurrent_train_reckon`` for a Mamba or RWKV model,
    ``dense_train_reckon`` otherwise) pass DENSE_PEAK_LIMIT: first its
    routed experts, one at a time down to its top-k, where it has an MoE,
    then its depth by whole periods (gemma2's SWA / GLOBAL pair, a layer
    elsewhere); registered as ``name-train-cut`` when cut.  Returns (the
    config, its reckoning)."""
    import gc

    from repro_torch.configs.base import get_config, register

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    full = cfg = get_config(name)
    recurrent = full.mamba is not None or full.rwkv is not None

    def reckon(c):
        return (recurrent_train_reckon(c, batch, seq) if recurrent
                else dense_train_reckon(c, batch, seq, n_vis))
    rk = reckon(cfg)
    while before + rk["total_bytes"] > DENSE_PEAK_LIMIT:
        if cfg.moe is not None and cfg.moe.n_experts > cfg.moe.top_k:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, n_experts=cfg.moe.n_experts - 1))
        else:
            cfg = cfg.replace(n_layers=cfg.n_layers - cfg.period)
        check(cfg.n_layers >= cfg.period, f"{name}: one period fits")
        rk = reckon(cfg)
    cuts = [f"depth {full.n_layers} -> {cfg.n_layers} ({full.n_periods} "
            f"-> {cfg.n_periods} periods)"]
    if cfg.moe is not None:
        cuts.append(f"routed experts {full.moe.n_experts} -> "
                    f"{cfg.moe.n_experts} a MoE layer (top-"
                    f"{cfg.moe.top_k} kept)")
    if cfg != full:
        cfg = cfg.replace(name=f"{name}-train-cut")
        register(cfg.name)(lambda c=cfg: c)
    emit("recurrent_train_cuts" if recurrent else "dense_train_cuts", {
        "config": cfg.name, "cut": cfg.name != name, "cuts": cuts,
        "batch": batch, "seq": seq,
        "why": f"reckoned peak {before + rk['total_bytes']} bytes against "
               f"{DENSE_PEAK_LIMIT:.0f}",
        "widths": "as published; random weights seeded on the card",
        "reckoned": rk, "allocated_before_bytes": before})
    return cfg, rk


def backward_peak(torch, dev, cfg, model, *, batch, seq, inputs=None) -> int:
    """The bytes one loss-and-gradient pass of ``cfg`` on a seeded B x S
    token batch (or the model batch ``inputs``) allocates past what was
    held before it (the gradients, the remat activations, the loss chunks'
    logits): the backward phase's own peak, apart from AdamW's."""
    import gc

    from repro_torch.data.tokens import batch_iterator
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.api import model_api

    if inputs is None:
        inputs = {"tokens": torch.from_numpy(next(batch_iterator(
            batch, seq, seed=5, vocab_size=cfg.vocab_size))["tokens"]).to(
                dev)}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    grads = loss_and_grads(model_api(cfg).loss, model, inputs)[2]
    torch.cuda.synchronize()
    del grads
    return torch.cuda.max_memory_allocated() - held


def dense_train_phase(torch, dev, name, *, batch, seq, steps,
                      profile=False):
    """(b)-(c) ``name`` at full width, cut by ``dense_train_cut``, bf16,
    through ``trainer_run``: under remat each layer's flash forward runs
    twice a step (the forward and its recomputation) and its gradient
    once, every loss finite and falling, the peak within its reckoning;
    then ``backward_peak`` within the reckoning's backward term.
    ``profile``: two gradients of one batch with the same bits and a
    ``torch.profiler`` window over one train step."""
    import gc

    cfg, rk = dense_train_cut(torch, name, batch, seq)
    check(cfg.remat, f"{name} trains under remat, as the reference's "
          "config does")
    model, out = trainer_run(torch, dev, cfg, steps=steps, batch=batch,
                             seq=seq, fwd=2 * cfg.n_layers, bwd=cfg.n_layers,
                             reckoned=rk["total_bytes"])
    out["reckoned"] = rk
    out["backward_peak_bytes"] = backward_peak(torch, dev, cfg, model,
                                               batch=batch, seq=seq)
    check(out["backward_peak_bytes"] <= rk["backward_bytes"],
          f"{name}: backward peak {out['backward_peak_bytes']} within its "
          f"reckoning {rk['backward_bytes']}")
    if profile:
        out["grads_same_bits_twice"], toks = grads_twice(
            torch, dev, cfg, model, batch=batch, seq=seq)
        flash = tuple(f"{k}<{cfg.d_head}" for k in (
            "flash_wgmma_kernel", "flash_bwd_dq_kernel",
            "flash_bwd_dkdv_kernel"))
        out["profile"] = train_step_profile(torch, cfg, model, toks, flash)
        emit("dense_train_profile", {"config": cfg.name, **out["profile"]})
    emit("dense_train_phase", out)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dense_train_replay(torch, dev, *, batch, seq, steps,
                       names=("gemma2-27b", "h2o-danube-3-4b"),
                       replay=DENSE_REPLAY, n_vis=0,
                       tag="dense_train_replay"):
    """(d) ``names`` (gemma2 and h2o) cut to ``replay``'s width (their head
    widths, softcaps and remat as published), f32, ``steps`` train steps on
    the card and on the CPU port from the same weights (``replay_train``,
    image batches of ``n_vis`` patch embeddings where given): loss, grad
    norm and masters within TRAIN_REPLAY_TOL; on the card the f32 gradient
    kernel launched once a layer a step and the forward twice (remat)."""
    from repro_torch.kernels import ops

    out = {}
    for name in names:
        cfg = dense_replay_cut(name, torch.float32, **replay)
        ops.reset_launch_counts()
        out[name] = replay_train(torch, dev, cfg, batch=batch, seq=seq,
                                 steps=steps, n_vis=n_vis)
        c = ops.launch_counts()
        check((c["flash_attention"], c["flash_attention_bwd"])
              == (2 * steps * cfg.n_layers, steps * cfg.n_layers),
              f"{name} replay: flash launches on the card {c}")
        out[name].update(launches=c, d_head=cfg.d_head,
                         softcap=cfg.attn_logit_softcap)
    emit(tag, out)
    return out


def dense_kill_resume(torch, dev, *, name="gemma2-27b", replay=DENSE_REPLAY,
                      tag="dense_train_kill_resume", **kw):
    """(e) ``name`` (gemma2) at ``replay``'s width in bf16 through
    ``kill_resume``."""
    cfg = dense_replay_cut(name, torch.bfloat16, **replay)
    cfg = cfg.replace(name=cfg.name + "-replay-cut")
    out = {"config": f"{cfg.name} (the replay's cut), bf16",
           **kill_resume(torch, dev, cfg, **kw)}
    emit(tag, out)
    return out


# ----------------------------------------------------------------- step 21
class LeafSpy:
    """While open, follows one top-level leaf's f32 master through every
    ``optim.adamw.adamw_update`` call: its value before the first update,
    the master itself (AdamW writes it in place), the weight decay and each
    update's lr."""

    def __init__(self, path: str):
        from repro_torch.optim import adamw
        self.adamw, self.path = adamw, path
        self.first = self.master = self.decay = None
        self.lrs = []

    def __enter__(self):
        self._update = self.adamw.adamw_update

        def update(grads, opt, params, ocfg):
            if self.first is None:
                self.master = opt.master[self.path]
                self.first = self.master.detach().clone()
                self.decay = ocfg.weight_decay
            out = self._update(grads, opt, params, ocfg)
            self.lrs.append(out[2]["lr"])
            return out

        self.adamw.adamw_update = update
        return self

    def __exit__(self, *exc):
        self.adamw.adamw_update = self._update

    def decay_gap(self) -> float:
        """The largest |master - first * prod(1 - lr_t * decay)| over the
        largest |first|: how far the leaf moved past weight decay."""
        factor = math.prod(1.0 - float(lr) * self.decay for lr in self.lrs)
        want = self.first.double() * factor
        return float((self.master.double() - want).abs().max()
                     / self.first.abs().max())


def phi3_train_phase(torch, dev, *, batch, seq, trainer_steps, step_steps):
    """(e) ``phi-3-vision-4.2b`` at full width, cut by ``dense_train_cut``
    (its peak reckoned with the frontend's tokens), bf16, under remat:
    (i) ``trainer_steps`` steps of ``launch.train.main`` through
    ``trainer_run``, tokens only (the reference trainer's path), after
    which ``vis_proj``'s master is its first value times prod(1 - lr_t *
    wd) within PHI3_DECAY_TOL, then ``backward_peak``; (ii) ``step_steps``
    steps of ``launch.steps.build_train_step`` on input_specs'
    ``train_4k`` cell at B = ``batch`` (tokens and patch embeddings drawn
    fresh each step by ``make_inputs`` from one seeded generator), from
    (i)'s parameters and a fresh AdamW state, through ``trainer_run`` with
    that loop, where ``vis_proj`` moves past its decay by more than
    PHI3_LEARN_MIN; then ``backward_peak`` on an image batch, two
    gradients of one image batch with the same bits and a profiler window
    over one step with device ms by kind.  In both, 2 flash forward and 1
    gradient launch a layer a step, every loss finite and falling, the
    peak within its reckoning."""
    import gc

    from repro_torch.configs.base import (SHAPES, get_config, input_specs,
                                          make_inputs)
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    cell = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                               global_batch=batch)
    specs = input_specs(get_config(PHI3), cell)
    n_vis = specs["extra_embeds"].shape[1]
    cfg, rk = dense_train_cut(torch, PHI3, batch, seq, n_vis)
    check(cfg.remat, f"{PHI3} trains under remat, as the reference's "
          "config does")
    L = cfg.n_layers
    out = {"config": cfg.name, "reckoned": rk,
           "cell": {"name": cell.name, "batch": batch, "seq": seq,
                    "text_tokens": specs["tokens"].shape[1],
                    "frontend_tokens": n_vis}}

    with LeafSpy("vis_proj") as spy:
        model, row = trainer_run(torch, dev, cfg, steps=trainer_steps,
                                 batch=batch, seq=seq, fwd=2 * L, bwd=L,
                                 reckoned=rk["total_bytes"])
    gap = spy.decay_gap()
    check(len(spy.lrs) == trainer_steps and gap <= PHI3_DECAY_TOL,
          f"{PHI3} tokens only: vis_proj moved by weight decay alone "
          f"({gap} past it, {len(spy.lrs)} updates)")
    row["vis_proj_past_decay"] = gap
    del spy
    row["backward_peak_bytes"] = backward_peak(torch, dev, cfg, model,
                                               batch=batch, seq=seq)
    check(row["backward_peak_bytes"] <= rk["backward_bytes"],
          f"{PHI3} tokens only: backward peak {row['backward_peak_bytes']} "
          f"within its reckoning {rk['backward_bytes']}")
    out["trainer_tokens_only"] = row

    ocfg = adamw.AdamWConfig(lr=3e-4, total_steps=step_steps,
                             warmup_steps=min(50, step_steps // 4))
    gen = torch.Generator(device=dev).manual_seed(24)

    def run(on_step):
        state = {"lm": model, "opt": adamw.init_opt_state(model, ocfg)}
        step = build_train_step(cfg, ocfg)
        for i in range(1, step_steps + 1):
            b = make_inputs(cfg, cell, gen, device=dev)
            state["lm"], state["opt"], m = step(state["lm"], state["opt"], b)
            del b
            on_step(i, m, state["lm"])
        lm = state.pop("lm")
        state.clear()                       # frees the optimizer state
        return lm, "training complete"

    with LeafSpy("vis_proj") as spy:
        model, row = trainer_run(
            torch, dev, cfg, steps=step_steps, batch=batch, seq=seq,
            fwd=2 * L, bwd=L, reckoned=rk["total_bytes"], run=run,
            limit=rk["total_bytes"] - 2 * rk["params"])
    gap = spy.decay_gap()
    check(gap > PHI3_LEARN_MIN, f"{PHI3} image batches: vis_proj learned "
          f"({gap} past its decay)")
    row["vis_proj_past_decay"] = gap
    del spy
    images = [make_inputs(cfg, cell, torch.Generator(
        device=dev).manual_seed(25 + i), device=dev) for i in range(2)]
    row["backward_peak_bytes"] = backward_peak(torch, dev, cfg, model,
                                               batch=batch, seq=seq,
                                               inputs=images[0])
    check(row["backward_peak_bytes"] <= rk["backward_bytes"],
          f"{PHI3} image batch: backward peak {row['backward_peak_bytes']} "
          f"within its reckoning {rk['backward_bytes']}")
    row["grads_same_bits_twice"], _ = grads_twice(
        torch, dev, cfg, model, batch=batch, seq=seq, batches=images)
    flash = tuple(f"{k}<{cfg.d_head}" for k in (
        "flash_wgmma_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"))
    row["profile"] = train_step_profile(torch, cfg, model, images, flash)
    emit("phi3_train_profile", {"config": cfg.name, **row["profile"]})
    out["build_train_step_images"] = row
    out["launches"] = {k: out["trainer_tokens_only"]["launches"][k]
                       + row["launches"][k] for k in row["launches"]}
    emit("phi3_train_phase", out)
    del model, images
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- step 22
def recurrent_reckon(cfg, batch: int, prompt: int, max_len: int) -> dict:
    """Bytes before a run of a recurrent model (jamba's Mamba, attention
    and MoE layers; RWKV-6): the weights (each leaf at its spec's dtype:
    Mamba's ``A_log``, ``D``, ``dt_bias`` and RWKV's mixing, decay and
    bonus leaves are f32), the caches (a Mamba layer's conv inputs and f32
    scan state, an RWKV layer's two token-shift inputs and f32 wkv state,
    an attention layer's KV cache of ``max_len`` positions), the prefill's
    transients (four d_model-wide activations of the residual stream, and
    the largest layer's own: a Mamba layer's projections and f32 scan
    inputs and outputs, 10 model-dtype and 36 bytes of f32 a d_inner
    channel a token, and eight f32 [B, chunk, d_inner, d_state] arrays of
    a chunk's scan; an RWKV time mix's five mixed inputs and f32 r, k, v,
    decays and outputs, 6 model-dtype and 48 f32 bytes a channel a token,
    and six f32 [B, chunk, chunk, d_model] arrays of a chunk's scores; its
    channel mix's three d_ff-wide and eight d_model-wide activations; an
    attention layer's q, k, v, output and six f32 rotary copies a head; the
    MoE's f32 router input, capacity buffer, three expert-wide activations
    a slot, the experts' output and its padded copy, and the k gathered
    copies of each token; a dense MLP's three d_ff-wide activations), and
    init's (the largest leaf drawn in f32 beside its cast, and
    INIT_SLACK)."""
    from repro_torch.models import common as cm
    from repro_torch.models.lm import lm_param_specs
    from repro_torch.models.moe import expert_capacity

    es = cfg.dtype.itemsize
    specs = [s for _, s in cm.leaves(lm_param_specs(cfg))]
    sizes = [int(np.prod(s.shape)) for s in specs]
    d, n = cfg.d_model, batch * prompt
    caches, layer = 0, [0]
    for mk, lk in cfg.layer_kinds():
        if mk == cm.MIXER_MAMBA:
            mb = cfg.mamba
            d_in, N = mb.expand * d, mb.d_state
            caches += batch * d_in * ((mb.d_conv - 1) * es + N * 4)
            layer.append(n * d_in * (10 * es + 36)
                         + 8 * batch * min(mb.chunk, prompt) * d_in * N * 4)
        elif mk == cm.MIXER_RWKV6:
            h, dh = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
            Cn = min(cfg.rwkv.chunk, prompt)
            caches += batch * (2 * d * es + h * dh * dh * 4)
            layer.append(n * d * (6 * es + 48) + 6 * batch * Cn * Cn * d * 4)
            layer.append(n * (3 * cfg.d_ff + 8 * d) * es)
            continue
        else:
            hd = cfg.n_heads * cfg.d_head
            caches += 2 * batch * max_len * cfg.n_kv_heads * cfg.d_head * es
            layer.append(n * ((2 * hd + 2 * cfg.n_kv_heads * cfg.d_head) * es
                              + 6 * hd * 4))
        if lk == cm.MLP_MOE:
            mo = cfg.moe
            EC = mo.n_experts * expert_capacity(n, cfg)
            layer.append(n * d * 4 + (3 * EC + 1) * d * es
                         + 3 * EC * mo.d_ff_expert * es
                         + 2 * n * mo.top_k * d * es)
        else:
            layer.append(3 * n * cfg.d_ff * es)
    out = {"weights_bytes": sum(z * s.dtype.itemsize
                                for z, s in zip(sizes, specs)),
           "params": sum(sizes), "cache_bytes": caches,
           "prefill_transient_bytes": 4 * n * d * es + max(layer),
           "init_transient_bytes": 4 * max(sizes) + INIT_SLACK}
    out["serve_bytes"] = (out["weights_bytes"] + caches
                          + out["prefill_transient_bytes"])
    out["init_bytes"] = out["weights_bytes"] + out["init_transient_bytes"]
    return out


# ------------------------------------------------------- wkv6 (step 22)
def wkv6_inputs(torch, B, S, H, state, seed, dev):
    """r, k, v normal, lw = -exp(dec) with dec spread as rwkv6-3b's
    ``decay_base`` init spreads it (decays 0.7 to 0.998 a step), u normal,
    state0 normal or zeros: [B, S, H, 64] f32 and so on, drawn on the
    card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (B, S, H, 64)
    r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    spread = -6.0 + 5.0 * torch.linspace(0, 1, 64, device=dev) ** 0.7
    lw = -torch.exp(spread + 0.3 * torch.randn(shape, generator=g,
                                              device=dev))
    u = torch.randn((H, 64), generator=g, device=dev)
    s0 = (torch.randn((B, H, 64, 64), generator=g, device=dev) if state
          else torch.zeros((B, H, 64, 64), device=dev))
    return r, k, v, lw, u, s0


def wkv6_cost(B, S, H):
    """(bytes, f32 flops) of one call: r, k, v, lw read and y written once,
    the state read and written; per head a token 64 x 64 FMAs for y, and a
    multiply and an FMA for each state entry."""
    n = B * S * H * 64
    return 5 * n * 4 + 2 * B * H * 64 * 64 * 4, B * S * H * 64 * 64 * 5


def wkv6_checks(torch, clock, dev, cases=WKV6_CASES, chunk=64):
    """The wkv6 kernel against wkv6_plain (the chunk loop, in chunks of
    ``chunk`` as rwkv6-3b runs it) at WKV6_CASES: y and the end state
    within WKV6_TOL of the largest entry, each also against the plain
    version in float64; one launch a call, the same bits twice; the first
    case timed beside its bound and the plain version (as called)."""
    from repro_torch.kernels import wkv6

    row = None
    for i, (B, S, H, state) in enumerate(cases):
        args = wkv6_inputs(torch, B, S, H, state, 700 + i, dev)
        n0 = wkv6.launches
        got = wkv6.wkv6_cuda(*args)
        check(wkv6.launches == n0 + 1, "wkv6: one launch a call")
        want = wkv6.wkv6_plain(*args, chunk)
        exact = wkv6.wkv6_plain(*(a.double() for a in args), chunk)
        torch.cuda.synchronize()
        out = {"shape": [B, S, H, 64], "nonzero_state": state}
        for name, g, w, x in zip(("y", "state"), got, want, exact):
            scale = float(w.abs().max())
            err = float((g - w).abs().max()) / scale
            out[f"{name}_rel_err"] = err
            out[f"{name}_rel_err_f64"] = float((g.double() - x).abs().max()
                                               / x.abs().max())
            out[f"{name}_plain_rel_err_f64"] = float(
                (w.double() - x).abs().max() / x.abs().max())
            out[f"{name}_largest"] = scale
            check(err <= WKV6_TOL, f"wkv6 {name} err {err} at {out['shape']}")
        check(all(bool(torch.isfinite(t).all()) for t in got),
              "wkv6 outputs finite")
        check(same_bits(torch, got, wkv6.wkv6_cuda(*args)),
              f"wkv6: two calls give the same bits at {out['shape']}")
        emit("wkv6_check", out)
        if i == 0:
            del exact
            b_ms, b_by = bound(*wkv6_cost(B, S, H))
            row = {**out, "ms": clock.ms(lambda: wkv6.wkv6_cuda(*args)),
                   "plain_ms": clock.call_ms(
                       lambda: wkv6.wkv6_plain(*args, chunk), reps=3),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None, "library": "none: PyTorch has no "
                   "wkv operator"}
            emit("wkv6_time", row)
        del args, got, want
        torch.cuda.empty_cache()
    return row


def recurrent_serve_phase(torch, dev, name, *, batch, prompt, new_tokens,
                          profile_prompt=None):
    """(b)-(c) ``name`` at full width, bf16, weights seeded on the card:
    its peak reckoned first (``recurrent_reckon``) and its depth cut by
    whole periods while that passes DENSE_PEAK_LIMIT; ``batch`` prompts of
    ``prompt`` tokens prefilled twice into zeroed caches, then
    ``new_tokens`` greedy steps through model_api's entry points
    (serve_run, MoESpy open where the model has an MoE): one flash launch
    an attention layer a prefill and none decoding (none at all without
    attention), every logit finite, the two prefills the same bits, the
    cache's bytes and both peaks within their reckoning; then a profiler
    window over one prefill (of the prompts' first ``profile_prompt``
    tokens, where given) and PROFILE_DECODE steps."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.models import common as cm
    from repro_torch.models.api import model_api
    from repro_torch.models.blocks import ATTN_KINDS

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    full = cfg = get_config(name)
    max_len = prompt + new_tokens
    rk = recurrent_reckon(cfg, batch, prompt, max_len)
    while before + rk["serve_bytes"] > DENSE_PEAK_LIMIT:
        cfg = cfg.replace(n_layers=cfg.n_layers - cfg.period)
        rk = recurrent_reckon(cfg, batch, prompt, max_len)
    check(cfg.n_layers >= cfg.period, f"{name}: a whole period fits")
    kinds = cfg.layer_kinds()
    n_attn = sum(mk in ATTN_KINDS for mk, _ in kinds)
    n_moe = sum(lk == cm.MLP_MOE and mk != cm.MIXER_RWKV6
                for mk, lk in kinds)
    emit("recurrent_cuts", {
        "config": name, "n_layers": f"{full.n_layers} -> {cfg.n_layers}",
        "periods": f"{full.n_periods} -> {cfg.n_periods}",
        "cut": cfg.n_layers != full.n_layers,
        "why": f"reckoned peak {before + rk['serve_bytes']} bytes against "
               f"{DENSE_PEAK_LIMIT:.0f}",
        "widths": "as published (every expert); random weights seeded on "
                  "the card",
        "reckoned": rk, "allocated_before_bytes": before})
    model, init = card_model(torch, dev, cfg)
    check(init["weights_bytes"] == rk["weights_bytes"],
          f"{name}: weights {init['weights_bytes']} bytes as reckoned "
          f"{rk['weights_bytes']}")
    check(init["init_peak_bytes"] <= before + rk["init_bytes"],
          f"{name}: init peak {init['init_peak_bytes']} within "
          f"{before + rk['init_bytes']}")
    tokens = torch.from_numpy(np.random.default_rng(22).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)).to(dev)
    api = model_api(cfg)
    spy = MoESpy() if n_moe else None
    m, _, _, caches = serve_run(torch, api, model, tokens, new_tokens,
                                spy=spy)
    m["cache_bytes"] = sum(t.numel() * t.element_size() for c in caches
                           for t in c if isinstance(t, torch.Tensor)
                           and t.dim() > 0)
    m["cache_bytes_per_sequence"] = m["cache_bytes"] / batch
    m["cache_types"] = sorted({type(c).__name__ for c in caches})
    m["serve_peak_reckoned_bytes"] = before + rk["serve_bytes"]
    check(m["cache_bytes"] == rk["cache_bytes"],
          f"{name}: cache {m['cache_bytes']} bytes as reckoned "
          f"{rk['cache_bytes']}")
    check(m["max_memory_allocated_bytes"] <= m["serve_peak_reckoned_bytes"],
          f"{name}: serving peak {m['max_memory_allocated_bytes']} within "
          f"its reckoning {m['serve_peak_reckoned_bytes']}")
    check_served(name, m, n_attn, max_len)
    n_rwkv = sum(mk == cm.MIXER_RWKV6 for mk, _ in kinds)
    check(m["launches"]["wkv6"] == 2 * n_rwkv,
          f"{name}: one wkv6 launch an RWKV layer a prefill, none decoding: "
          f"{m['launches']['wkv6']} for {n_rwkv} layers, 2 prefills")
    if spy is not None:
        check(len(spy.ids) == n_moe * (2 + new_tokens),
              f"{name}: one MoE call a MoE layer a pass")
        m["moe_dropped_frac_prefill"] = [
            float(st.dropped_frac) for st in
            spy.stats[n_moe:2 * n_moe]]
        m["moe_dropped_frac_decode_max"] = max(
            float(st.dropped_frac) for st in spy.stats[2 * n_moe:])
    del caches, spy
    out = {"config": cfg.name, "n_layers": cfg.n_layers,
           "n_periods": cfg.n_periods, "attention_layers": n_attn,
           "moe_layers": n_moe, "batch": batch, "prompt": prompt,
           "new_tokens": new_tokens, **init,
           "init_peak_reckoned_bytes": before + rk["init_bytes"],
           "reckoned": rk, **m}
    flash = (f"flash_wgmma_kernel<{cfg.d_head}",) if n_attn else ()
    t0 = time.perf_counter()
    prof = serve_profile(torch, api, model, tokens[:, :profile_prompt],
                         api.init_cache(batch, max_len, device=dev), flash)
    prof["seconds_host"] = time.perf_counter() - t0
    prof["prompt"] = profile_prompt or prompt
    if n_attn:
        check(prof["prefill"]["kernel_ms"][flash[0]] > 0,
              f"{flash[0]}> ran in the profiled prefill")
    dec = prof[f"decode_{PROFILE_DECODE}_steps"]
    prof["decode_aten_ops_per_step"] = dec["cpu_ops"] / PROFILE_DECODE
    prof["decode_device_busy_ms_per_step"] = (dec["device_busy_ms"]
                                              / PROFILE_DECODE)
    out["profile"] = prof
    out["flash_launches"] = m["launches"]["flash_attention"]
    out["wkv6_launches"] = m["launches"]["wkv6"]
    emit("recurrent_profile", {"config": name, **prof})
    emit("recurrent_serve_phase", out)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recurrent_replay_cut(torch, name, *, d_model, n_heads, n_kv_heads,
                         d_head, d_ff, n_layers, vocab_size, chunk,
                         moe=None):
    """``name`` cut to these widths in f32, its scan chunk set to
    ``chunk``, its MoE's fields replaced by ``moe``'s where given."""
    from repro_torch.configs.base import get_config

    cfg = get_config(name)
    sub = ({"mamba": dataclasses.replace(cfg.mamba, chunk=chunk)}
           if cfg.mamba else
           {"rwkv": dataclasses.replace(cfg.rwkv, chunk=chunk)})
    if moe:
        sub["moe"] = dataclasses.replace(cfg.moe, **moe)
    return cfg.replace(d_model=d_model, n_heads=n_heads,
                       n_kv_heads=n_kv_heads, d_head=d_head, d_ff=d_ff,
                       n_layers=n_layers, vocab_size=vocab_size,
                       dtype=torch.float32, **sub)


def recurrent_replay_phase(torch, dev, *, batch, prompt, new_tokens,
                           cuts=None):
    """(d) each of ``cuts`` (RECURRENT_REPLAY: jamba and rwkv6 at d_model
    1024, f32, the scan chunk 16) with the same seeded weights on the card
    and on the CPU port, a ragged ``prompt`` (45 tokens at chunk 16, the
    length at which the reference's Mamba raises): equal greedy tokens,
    logits within DENSE_REPLAY_TOL of the largest, the same expert ids at
    every MoE call, one flash launch an attention layer a prefill on the
    card; then on the card each decode step's logits against the
    last-token logits of one prefill over the whole sequence so far: the
    recurrent state's handoff from prefill to decode.  jamba's cut runs at
    capacity_factor = n_experts / top_k, where no copy can drop, so a
    whole-sequence prefill routes each token as decode does; every MoE
    call is checked to drop none."""
    from repro_torch.models.api import model_api
    from repro_torch.models.blocks import ATTN_KINDS

    cuts = RECURRENT_REPLAY if cuts is None else cuts
    out = {"batch": batch, "prompt": prompt, "new_tokens": new_tokens,
           "configs": {}}
    for name, kw in cuts.items():
        cfg = recurrent_replay_cut(torch, name, **kw)
        prompt_np = np.random.default_rng(23).integers(
            0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
        api = model_api(cfg)
        chunk = (cfg.mamba or cfg.rwkv).chunk
        n_attn = sum(mk in ATTN_KINDS for mk, _ in cfg.layer_kinds())
        runs = {}
        for device in (dev, "cpu"):
            model = api.init(torch.Generator().manual_seed(0), device=device)
            with MoESpy() as spy:
                toks, logits, flash = replay_run(
                    torch, api, model, prompt_np, new_tokens, device)
            runs[str(device)] = (toks, logits, flash, model,
                                 [i.cpu() for i in spy.ids],
                                 [float(st.dropped_frac)
                                  for st in spy.stats])
        gtok, glog, flash, gmodel, gids, gdrop = runs[str(dev)]
        ctok, clog, _, _, cids, cdrop = runs["cpu"]
        scale = float(clog.abs().max())
        err = float((glog - clog).abs().max())
        check(torch.equal(gtok, ctok), f"{name} replay greedy tokens card "
              f"{gtok.tolist()} vs CPU {ctok.tolist()}")
        check(err <= DENSE_REPLAY_TOL * scale,
              f"{name} replay f32 logits err {err} of {scale}")
        check(flash == n_attn, f"{name}: {n_attn} f32 flash launches a "
              f"prefill on the card: {flash}")
        check(len(gids) == len(cids), f"{name}: as many MoE calls")
        for j, (a, b) in enumerate(zip(gids, cids)):
            check(torch.equal(a, b), f"{name} replay expert ids at MoE "
                  f"call {j}")
        seq = torch.cat([torch.from_numpy(prompt_np), gtok[:, :-1]],
                        dim=1).to(dev)
        worst = 0.0
        with MoESpy() as spy:
            for i in range(new_tokens):
                L = prompt + i + 1
                whole, _ = api.prefill(gmodel, {"tokens": seq[:, :L]},
                                       api.init_cache(batch, L, device=dev))
                d = float((whole.cpu() - glog[i + 1]).abs().max())
                worst = max(worst, d / float(whole.abs().max()))
        # a share under half a copy of the largest call is zero dropped
        # (the mean's f32 rounding leaves about 2.4e-7 where none drop)
        drops = gdrop + cdrop + [float(st.dropped_frac) for st in spy.stats]
        half_copy = 0.5 / (batch * (prompt + new_tokens) * (
            cfg.moe.top_k if cfg.moe else 1))
        worst_drop = max(drops, default=0.0)
        check(worst_drop < half_copy,
              f"{name}: no MoE copy dropped in the replay: {worst_drop}")
        check(worst <= DENSE_REPLAY_TOL, f"{name}: decode vs whole-sequence "
              f"prefill relative err {worst}")
        out["configs"][name] = {
            "cut": kw, "n_layers": cfg.n_layers,
            "tokens": gtok[0].tolist(), "max_abs_logit_err": err,
            "max_abs_logit": scale, "relative_err": err / scale,
            "flash_launches_prefill": flash,
            "moe_calls_equal_ids": len(gids),
            "moe_capacity_factor": cfg.moe.capacity_factor if cfg.moe
            else None,
            "moe_dropped_frac_max": worst_drop,
            "ragged_prompt": prompt % chunk != 0 and prompt > chunk,
            "decode_vs_prefill_relative_err": worst}
        del runs, gmodel
    emit("recurrent_replay_phase", out)
    return out


# ----------------------------------------------------------------- step 23
def recurrent_train_reckon(cfg, batch: int, seq: int) -> dict:
    """``train_reckon`` of a recurrent ``cfg`` (jamba's Mamba, attention
    and MoE layers; RWKV-6), with the gradients in flight through the
    period's largest layer as an extra transient.  A layer's activations,
    in bytes a token, as ``saved_tensors_hooks`` counts what autograd
    saves on the CPU port at these configs' ratios (d_model 256 and 512):
    its two norms' f32 copies and inputs; a Mamba mixer's projections and
    scan inputs (three f32 and eight model-dtype d_inner-wide arrays) and,
    with each scan chunk recomputed, one f32 state a chunk; an attention
    mixer's q, output and input, k and v, the rotary key's f32 halves and
    the lse; an MoE's k * capacity_factor expert slots a token (their
    four d_ff_expert-wide activations and their input), its f32 router
    input and the k gathered copies; a dense MLP's four d_ff-wide
    activations; an RWKV time mix's two f32 [chunk, d_model] arrays a
    token of each chunk's scores, six model-dtype and eighteen f32
    d_model-wide arrays, its channel mix's two d_ff-wide and five
    d_model-wide ones.  In flight through the largest layer: its
    activations' gradients (an RWKV layer's chunk scores only a chunk at
    a time) and, for a Mamba layer, one chunk's recomputed scan (18 f32
    [B, chunk, d_inner, d_state] arrays) and their gradients.  Both
    totals are upper bounds: they hold every gradient beside every
    transient, where the backward frees a layer's activations as its
    gradients form."""
    from repro_torch.models import common as cm

    es = cfg.dtype.itemsize
    n, d = batch * seq, cfg.d_model
    H, Kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    flight = []              # (bytes a token, bytes of one chunk in flight)

    def layer(mk, lk) -> int:
        b = 16 * d + 2 * es * d                  # two norms and their outputs
        chunk = 0
        if mk == cm.MIXER_MAMBA:
            mb = cfg.mamba
            d_in, C = mb.expand * d, min(mb.chunk, seq)
            b += d_in * (12 + 8 * es) + 4 * d_in * mb.d_state / C + 4 * d
            chunk = 2 * 18 * batch * C * d_in * mb.d_state * 4
        elif mk == cm.MIXER_RWKV6:
            C = min(cfg.rwkv.chunk, seq)
            scores = 2 * C * d * 4
            b += scores + d * (6 * es + 18 * 4) + es * (2 * cfg.d_ff + 5 * d)
            flight.append((b - scores, 6 * batch * C * C * d * 4))
            return b
        else:
            b += es * (3 * H * dh + 2 * Kv * dh + d) + 8 * Kv * dh + 4 * H
        if lk == cm.MLP_MOE:
            mo = cfg.moe
            slots = mo.top_k * mo.capacity_factor
            b += (slots * (4 * mo.d_ff_expert + d) * es + 4 * d
                  + mo.top_k * d * es)
        else:
            b += 4 * cfg.d_ff * es
        flight.append((b, chunk))
        return b

    check(cfg.n_dense_prefix == 0, f"{cfg.name}: no dense prefix")
    period = sum(layer(*cfg.block_kinds(s)) for s in range(cfg.period))
    out = train_reckon(cfg, batch, seq, int(period * n), in_flight_bytes=int(
        max(t * n + c for t, c in flight)))
    out["period_bytes_per_token"] = period
    return out


def train_roofline(cfg, batch: int, seq: int, step_ms: float) -> dict:
    """The train step against the analytic cost model
    (``repro_torch.launch.costs``): its model FLOPs (6 N_active B S) over
    the measured step time against the card's dense bf16 peak (the step's
    MFU), and ``roofline_terms``' bound and dominant term on one H100."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import costs

    c = costs.step_costs(cfg, ShapeCell(cfg.name, seq, batch, "train"))
    terms = costs.roofline_terms(c, 0.0, chips=1)
    return {"model_flops": c.model_flops, "flops": c.flops,
            "hbm_bytes": c.hbm_bytes, "n_params": c.n_params,
            "n_active": c.n_active, "breakdown": c.breakdown,
            "mfu": c.model_flops / (step_ms / 1e3) / BF16_FLOP_PER_S,
            "roofline": terms,
            "step_over_bound": step_ms / 1e3 / terms["bound_s"]}


def recurrent_train_phase(torch, dev, name, *, batch, seq, steps,
                          short_seq):
    """(a), (c) ``name`` at full width, cut by ``dense_train_cut``,
    bf16, through ``trainer_run`` under remat (each period and, inside it,
    each Mamba scan chunk recomputed): 2 flash forward and 1 gradient
    launch an attention layer a step (none on rwkv6-3b), every loss finite
    and falling, the peak within its reckoning; jamba's MoE calls counted
    (each routed twice a step, the recomputed ids equal to the forward's),
    its dropped share and aux loss; then the step against
    ``train_roofline``, ``backward_peak`` within the reckoning's backward
    term, and at B x ``short_seq`` two gradients of one batch with the
    same bits and a ``torch.profiler`` window over one train step (the
    window's events grow with the scan chunks)."""
    import gc

    from repro_torch.models import common as cm
    from repro_torch.models.blocks import ATTN_KINDS

    cfg, rk = dense_train_cut(torch, name, batch, seq)
    check(cfg.remat, f"{name} trains under remat, as the reference's "
          "config does")
    kinds = cfg.layer_kinds()
    n_attn = sum(mk in ATTN_KINDS for mk, _ in kinds)
    n_moe = sum(lk == cm.MLP_MOE and mk != cm.MIXER_RWKV6
                for mk, lk in kinds)
    with MoESpy() as spy:
        model, out = trainer_run(torch, dev, cfg, steps=steps, batch=batch,
                                 seq=seq, fwd=2 * n_attn, bwd=n_attn,
                                 reckoned=rk["total_bytes"])
    out["reckoned"] = rk
    out["attention_layers"], out["moe_layers"] = n_attn, n_moe
    if n_moe:
        # each step: the forward's MoE calls in layer order, then the
        # recomputed ones, last period first and in layer order inside it
        check(len(spy.ids) == 2 * steps * n_moe,
              f"{name}: two MoE routes a MoE layer a step: {len(spy.ids)}")
        m = n_moe // cfg.n_periods
        same_ids = True
        for s in range(steps):
            ids = spy.ids[2 * n_moe * s:2 * n_moe * (s + 1)]
            rec = [ids[n_moe + i * m:n_moe + (i + 1) * m]
                   for i in range(cfg.n_periods)][::-1]
            for a, b in zip(ids[:n_moe], [x for p in rec for x in p]):
                same_ids &= torch.equal(a, b)
        check(same_ids, f"{name}: every recomputed MoE call routed to the "
              "forward's expert ids")
        dropped = [float(st.dropped_frac) for st in spy.stats]
        out.update({"moe_calls_per_step": len(spy.ids) // steps,
                    "recomputed_ids_equal_forward": same_ids,
                    "moe_dropped_frac_max": max(dropped),
                    "moe_dropped_frac_mean": float(np.mean(dropped)),
                    "moe_experts": cfg.moe.n_experts})
    del spy
    out["roofline"] = train_roofline(cfg, batch, seq, out["step_ms_p50"])
    out["backward_peak_bytes"] = backward_peak(torch, dev, cfg, model,
                                               batch=batch, seq=seq)
    check(out["backward_peak_bytes"] <= rk["backward_bytes"],
          f"{name}: backward peak {out['backward_peak_bytes']} within its "
          f"reckoning {rk['backward_bytes']}")
    out["grads_same_bits_twice"], toks = grads_twice(
        torch, dev, cfg, model, batch=batch, seq=short_seq)
    flash = tuple(f"{k}<{cfg.d_head}" for k in (
        "flash_wgmma_kernel", "flash_bwd_dq_kernel",
        "flash_bwd_dkdv_kernel")) if n_attn else ()
    t0 = time.perf_counter()
    prof = train_step_profile(torch, cfg, model, toks, flash)
    prof["seconds_host"] = time.perf_counter() - t0
    prof["seq"] = short_seq
    out["profile"] = prof
    emit("recurrent_train_profile", {"config": cfg.name, **prof})
    emit("recurrent_train_phase", out)
    del model, toks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recurrent_train_replay(torch, dev, *, batch, seq, steps, cuts=None):
    """(d) each of ``cuts`` (RECURRENT_REPLAY, step 22d's: d_model 1024,
    f32, the scan chunk 16, remat as published) for ``steps`` train steps on
    the card and on the CPU port from the same weights at a ``seq`` that
    is a multiple of the chunk (``replay_train``): loss, grad norm and
    masters within TRAIN_REPLAY_TOL (rwkv6-3b's within the larger of it
    and the CPU port's own spread: its largest gap, at REPLAY_SPREAD_THREADS,
    from its run at the default thread count); jamba's expert ids equal at
    every MoE
    call, the recomputed ones included; on the card the f32 flash kernels
    launched twice (forward) and once (gradient) an attention layer a
    step."""
    from repro_torch.kernels import ops
    from repro_torch.models import common as cm
    from repro_torch.models.blocks import ATTN_KINDS

    out = {}
    for name, kw in (RECURRENT_REPLAY if cuts is None else cuts).items():
        cfg = recurrent_replay_cut(torch, name, **kw)
        check(seq % (cfg.mamba or cfg.rwkv).chunk == 0,
              f"{name}: the replay's {seq} tokens a multiple of the chunk")
        kinds = cfg.layer_kinds()
        n_attn = sum(mk in ATTN_KINDS for mk, _ in kinds)
        n_moe = sum(lk == cm.MLP_MOE and mk != cm.MIXER_RWKV6
                    for mk, lk in kinds)
        ops.reset_launch_counts()
        with MoESpy() as spy:
            out[name] = replay_train(
                torch, dev, cfg, batch=batch, seq=seq, steps=steps,
                spread_threads=REPLAY_SPREAD_THREADS if cfg.rwkv else ())
        c = ops.launch_counts()
        check((c["flash_attention"], c["flash_attention_bwd"])
              == (2 * steps * n_attn, steps * n_attn),
              f"{name} train replay: flash launches on the card {c}")
        # the card's run, then the CPU's; each routes again under remat
        n = steps * n_moe * (1 + cfg.remat)
        check(len(spy.ids) == 2 * n, f"{name} train replay MoE calls "
              f"{len(spy.ids)}")
        for j, (a, b) in enumerate(zip(spy.ids[:n], spy.ids[n:])):
            check(torch.equal(a.cpu(), b.cpu()),
                  f"{name} train replay expert ids at MoE call {j}")
        out[name].update(launches=c, moe_calls_equal_ids=n, cut=kw,
                         remat=cfg.remat)
    emit("recurrent_train_replay", out)
    return out


def recurrent_kill_resume(torch, dev, **kw):
    """(e) step 22d's rwkv6-3b cut in bf16 through ``kill_resume``: its
    slash-named leaves go through the checkpoint."""
    cfg = recurrent_replay_cut(torch, RWKV6, **RECURRENT_REPLAY[RWKV6])
    cfg = cfg.replace(name=cfg.name + "-replay-cut", dtype=torch.bfloat16)
    out = {"config": f"{cfg.name} (step 22d's cut), bf16",
           **kill_resume(torch, dev, cfg, **kw)}
    emit("recurrent_train_kill_resume", out)
    return out


# ----------------------------------------------------------------- step 24
def whisper_attention_checks(torch, clock, dev, cases=WHISPER_ATTN_CASES,
                             seed=2400):
    """(a) Both flash kernels at whisper's shapes and the T != S edges: at
    each case and dtype ``flash_attention_cuda`` against
    ``flash_attention_plain`` (bf16 within DENSE_BF16_TOL, f32 within
    ATTN_TOL, the same bits twice), then ``hold_bwd``: the forward kernel's
    lse against the plain version's, its output bits unchanged by the lse,
    and ``flash_attention_bwd_cuda`` against ``flash_attention_bwd_plain``
    (bf16 within DENSE_BWD_BF16_TOL, f32 within ATTN_TOL, dk and dv at T,
    the same bits twice).  Autograd through ``ops.flash_attention_bshd`` at
    the cross-attention's training shape launches the gradient once and
    returns the direct call's bits.  The timed (training) shapes are timed
    in bf16: the forward by ``attn_time`` and the gradient by ``bwd_time``,
    beside their bounds, the plain versions as called and SDPA.  Returns
    (forward time rows, gradient time rows)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    fwd_rows, bwd_rows, held = [], [], None
    for i, (B, S, T, H, Kv, causal, dtypes, timed) in enumerate(cases):
        for name in dtypes:
            dt = getattr(torch, name)
            bf = dt == torch.bfloat16
            q, k, v = attn_inputs(torch, B, S, H, Kv, 64, dt, seed + i, dev,
                                  T=T)
            kw = dict(causal=causal, window=0, softcap=0.0)
            where = dict(B=B, S=S, T=T, H=H, Kv=Kv, dh=64, dtype=name,
                         causal=causal)
            got = fa.flash_attention_cuda(q, k, v, **kw)
            again = fa.flash_attention_cuda(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            tol = DENSE_BF16_TOL if bf else (ATTN_TOL["float32"],) * 2
            err, ok = attn_close(got, want, dt, tol)
            check(tuple(got.shape) == (B, S, H, 64),
                  f"flash_attention shape at {where}")
            check(ok and bool(torch.isfinite(got).all()),
                  f"flash_attention err {err} past {tol} at {where}")
            same = same_bits(torch, [got], [again])
            check(same, f"flash_attention same bits twice at {where}")
            del got, again, want
            row, (o, do, lse, _), gerr = hold_bwd(
                torch, dev, q, k, v, kw, where, seed + 100 + i,
                scaled=DENSE_BWD_BF16_TOL if bf else None)
            emit("whisper_attention_check", {
                **row, "max_abs_err": {"o": err, **row["max_abs_err"]},
                "tol": tol, "same_bits_twice": {
                    "o": same, "grads": row["same_bits_twice"]}})
            if bf and timed:
                fwd_rows.append(attn_time(torch, clock, q, k, v, kw, err,
                                          plain_as_called=True))
                bwd_rows.append(bwd_time(torch, clock, q, k, v, o, do, lse,
                                         kw, gerr, plain_as_called=True,
                                         plain_reps=5))
                if S != T:
                    held = (q, k, v, o, do, lse, kw)
            del q, k, v, o, do, lse
            torch.cuda.empty_cache()

    q, k, v, o, do, lse, kw = held
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention_bshd(*leaves, **kw)
    check(torch.equal(out.grad_fn.saved_tensors[4], lse),
          "autograd saved the cross-attention forward kernel's lse")
    n0 = fa.bwd_launches
    grads = torch.autograd.grad(out, leaves, do)
    direct = fa.flash_attention_bwd_cuda(q, k, v, out.detach(), do, lse,
                                         **kw)
    torch.cuda.synchronize()
    check(fa.bwd_launches - n0 == 2, "autograd launched the cross-attention "
          f"backward once ({fa.bwd_launches - n0 - 1} launches)")
    check([tuple(g.shape) for g in grads] == [tuple(t.shape)
                                              for t in (q, k, v)]
          and all(torch.equal(a, b) for a, b in zip(grads, direct)),
          "autograd's cross-attention gradients = the kernel's direct "
          "output, dk and dv at T")
    del held, leaves, out, grads, direct
    for row in fwd_rows:
        emit("whisper_attention_time", row)
    for row in bwd_rows:
        emit("whisper_attention_bwd_time", row)
    torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def whisper_serve_reckon(cfg, batch: int, frames: int, max_len: int) -> dict:
    """The serving peak, reckoned before the run as an upper bound: the
    weights, the f32 frames, the cache given to the prefill (a
    ``max_len``-slot self cache a decoder layer and cross k / v at
    ``enc_seq``), the prefill's cross k / v at the frames' length twice
    (the per-layer tensors and their stack), the encoder's output, and one
    encoder layer's transients a frame: two norms' f32 copies and outputs,
    q, k, v and their f32 rotary copies, the attention's output, the
    MLP's four d_ff-wide tensors."""
    from repro_torch.models import common as cm
    from repro_torch.models.encdec import encdec_param_specs

    es, d, ff = cfg.dtype.itemsize, cfg.d_model, cfg.d_ff
    L, H, Kv, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    n = batch * frames
    out = {"weights_bytes": es * cm.count_params(encdec_param_specs(cfg)),
           "frames_bytes": 4 * n * d,
           "given_cache_bytes": 2 * L * batch * (max_len * Kv
                                                 + cfg.enc_seq * H) * dh * es,
           "cross_bytes": 2 * 2 * L * n * H * dh * es,
           "encoder_out_bytes": n * d * es,
           "encoder_layer_bytes": n * (d * (16 + 4 * es)
                                       + (H + 2 * Kv) * dh * (es + 12)
                                       + H * dh * es + 4 * ff * es)}
    out["total_bytes"] = sum(out.values())
    return out


def whisper_serve_phase(torch, dev, *, batch, frames, new_tokens):
    """(b) whisper-small whole in bf16 at ``batch`` x ``frames`` seeded f32
    frames: ``api.prefill`` (the encoder, the cross k / v, the BOS step)
    into a cache of ``new_tokens`` self slots, then ``new_tokens`` greedy
    ``api.decode`` steps at pos 1 + i, twice.  Requires: 3 flash launches
    a decoder layer a prefill (the encoder's layers, the BOS step's
    self-attention on the token alone and its cross-attention) and one a
    decoder layer a decode step (the cross-attention; the self-attention
    decodes from the cache in plain PyTorch), the self cache given back
    unwritten by each prefill and ``new_tokens`` long after the steps,
    every logit finite, the two runs' tokens and logits the same bits, and
    the peak within ``whisper_serve_reckon``."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import model_api
    from repro_torch.models.lm import greedy_token

    cfg = get_config(WHISPER)
    api = model_api(cfg)
    L = cfg.n_layers
    rk = whisper_serve_reckon(cfg, batch, frames, new_tokens)
    model, init = card_model(torch, dev, cfg)
    held = init["allocated_before_bytes"]
    gen = torch.Generator(device=dev).manual_seed(2410)
    x = torch.randn((batch, frames, cfg.d_model), generator=gen, device=dev)
    caches = api.init_cache(batch, new_tokens, device=dev)
    ops.reset_launch_counts()
    runs = []
    for _ in range(2):
        for c in caches.self_kv:
            for t in c:
                if isinstance(t, torch.Tensor):
                    t.zero_()
        torch.cuda.synchronize()
        n0 = ops.launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        logits, st = api.prefill(model, {"frames": x}, caches)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        pre_n = ops.launch_counts()["flash_attention"] - n0
        given_back = st.self_kv is caches.self_kv and all(
            int(c.length) == 0 and not c.k.any() for c in st.self_kv)
        cross_shape = tuple(st.cross_k.shape)
        bad = (~torch.isfinite(logits)).sum()
        toks, all_logits, dec_ms, per_step = [], [logits], [], []
        tok = greedy_token(logits)
        toks.append(tok)
        for i in range(new_tokens):
            n1 = ops.launch_counts()["flash_attention"]
            t0 = time.perf_counter()
            logits, st = api.decode(model, tok, st, 1 + i)
            tok = greedy_token(logits)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append(ops.launch_counts()["flash_attention"] - n1)
            bad = bad + (~torch.isfinite(logits)).sum()
            toks.append(tok)
            all_logits.append(logits)
        runs.append({"prefill_ms": pre_ms, "prefill_launches": pre_n,
                     "given_back": given_back, "cross_shape": cross_shape,
                     "decode_ms": dec_ms, "per_step": per_step,
                     "nonfinite": int(bad),
                     "lengths": [int(c.length) for c in st.self_kv],
                     "tokens": torch.cat(toks, dim=1),
                     "logits": torch.stack(all_logits)})
        del st
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    launches = ops.launch_counts()
    want_cross = (L, batch, frames, cfg.n_heads, cfg.d_head)
    for r in runs:
        check(r["prefill_launches"] == 3 * L, f"{WHISPER}: {3 * L} flash "
              f"launches a prefill: {r['prefill_launches']}")
        check(set(r["per_step"]) == {L}, f"{WHISPER}: {L} flash launches a "
              f"decode step: {sorted(set(r['per_step']))}")
        check(r["given_back"], f"{WHISPER}: the prefill gave the self cache "
              "back unwritten")
        check(r["cross_shape"] == want_cross, f"{WHISPER}: cross k / v "
              f"{r['cross_shape']} at the frames' length {want_cross}")
        check(r["nonfinite"] == 0, f"{WHISPER}: every logit finite "
              f"({r['nonfinite']} not)")
        check(r["lengths"] == [new_tokens] * L, f"{WHISPER}: self cache "
              f"lengths {r['lengths']}")
    check(launches["flash_attention"] == 2 * L * (3 + new_tokens),
          f"{WHISPER}: flash launches {launches['flash_attention']}")
    same = same_bits(torch, [runs[0]["tokens"], runs[0]["logits"]],
                     [runs[1]["tokens"], runs[1]["logits"]])
    check(same, f"{WHISPER}: the two runs' tokens and logits the same bits")
    check(peak <= rk["total_bytes"], f"{WHISPER}: serving peak {peak} within "
          f"its reckoning {rk['total_bytes']}")
    dec = runs[1]["decode_ms"]
    dec_p50 = float(np.percentile(dec, 50))
    out = {"config": WHISPER, "dtype": "bfloat16", "batch": batch,
           "frames": frames, "new_tokens": new_tokens,
           "params": init["params"], "weights_bytes": init["weights_bytes"],
           "prefill_ms": [r["prefill_ms"] for r in runs],
           "prefill_frames_per_s": batch * frames / runs[1]["prefill_ms"]
           * 1e3,
           "decode_ms_per_step_p50": dec_p50,
           "decode_ms_per_step_p95": float(np.percentile(dec, 95)),
           "generated_tokens_per_s": batch / dec_p50 * 1e3,
           "flash_launches_per_prefill": [r["prefill_launches"]
                                          for r in runs],
           "flash_launches_per_decode_step": L, "launches": launches,
           "flash_launches": launches["flash_attention"],
           "two_runs_same_bits": same, "peak_bytes": peak,
           "reckoned": rk, "peak_share_of_reckoning": peak / rk[
               "total_bytes"],
           "first_tokens": runs[1]["tokens"][0, :8].tolist()}
    emit("whisper_serve_phase", out)
    del model, caches, x, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def whisper_replay_phase(torch, dev, *, frames, new_tokens):
    """(c) The whole model in f32 (the same seeded draw on both, not
    rounded to bf16) at 1 x ``frames`` seeded frames on the card and on
    the CPU port: prefill and ``new_tokens`` greedy steps, tokens equal
    and logits within LOGIT_TOL; 3 flash launches a decoder layer on the
    card's prefill and one a layer a step."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import model_api
    from repro_torch.models.lm import greedy_token

    cfg = get_config(WHISPER).replace(dtype=torch.float32)
    api = model_api(cfg)
    x = torch.from_numpy(np.random.default_rng(2420).normal(
        size=(1, frames, cfg.d_model)).astype(np.float32))

    def run(device):
        model = api.init(torch.Generator().manual_seed(0), device=device)
        ops.reset_launch_counts()
        caches = api.init_cache(1, new_tokens, device=device)
        logits, caches = api.prefill(model, {"frames": x.to(device)}, caches)
        toks, out = [], [logits.cpu()]
        tok = greedy_token(logits)
        for i in range(new_tokens):
            toks.append(tok.cpu())
            logits, caches = api.decode(model, tok, caches, 1 + i)
            out.append(logits.cpu())
            tok = greedy_token(logits)
        toks.append(tok.cpu())
        return (torch.cat(toks, dim=1), torch.stack(out),
                ops.launch_counts()["flash_attention"])

    t0 = time.perf_counter()
    gtok, glog, n = run(dev)
    t1 = time.perf_counter()
    ctok, clog, _ = run("cpu")
    err = float((glog - clog).abs().max())
    L = cfg.n_layers
    check(n == L * (3 + new_tokens), f"{WHISPER} f32 replay: flash launches "
          f"{n}")
    check(torch.equal(gtok, ctok), f"{WHISPER} f32 greedy tokens card "
          f"{gtok.tolist()} vs CPU {ctok.tolist()}")
    check(err <= LOGIT_TOL, f"{WHISPER} f32 logits card vs CPU err {err}")
    out = {"config": WHISPER, "dtype": "float32", "batch": 1,
           "frames": frames, "new_tokens": new_tokens,
           "tokens": gtok[0].tolist(), "max_abs_logit_err": err,
           "max_abs_logit": float(clog.abs().max()), "flash_launches": n,
           "card_s_host": t1 - t0, "cpu_s_host": time.perf_counter() - t1}
    emit("whisper_replay_phase", out)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def whisper_train_reckon(cfg, batch: int, frames: int, tokens: int) -> dict:
    """The training peak of a bf16 step, reckoned before the run as an
    upper bound: 16 bytes a parameter (bf16 parameter and gradient, f32
    master and two moments), then the larger of AdamW's three f32
    temporaries of the largest leaf and what the backward pass holds.
    That is the f32 frames and the encoder's output, each layer's saved
    activations (as ``saved_tensors_hooks`` counts them on the CPU port,
    within 5 % at a quarter of the width), and the loss's.  Without remat,
    an encoder layer keeps a frame's two norms' f32 copies and outputs, q
    and k's f32 rotary halves, q, k, v, o and the lse, and the MLP's four
    d_ff-wide tensors; a decoder layer keeps the same for a token with a
    third norm, the cross-attention's q and o and lse, and the cross k / v
    of every frame.  The loss keeps the f32 logits (and the bf16 ones) of
    every token, and its backward adds ten bytes a logit (the f32 gradient,
    its bf16 cast, the softmax).  Under remat a layer keeps only its
    input, and one layer's activations are recomputed at a time."""
    from repro_torch.models import common as cm
    from repro_torch.models.encdec import encdec_param_specs

    es, d, ff, V = cfg.dtype.itemsize, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    sizes = [math.prod(s.shape) for _, s in cm.leaves(
        encdec_param_specs(cfg))]
    ne, nd = batch * frames, batch * tokens
    norm = 8 * d + 4 + es * d
    attn = 4 * (H + Kv) * dh + es * 2 * (H + Kv) * dh + 4 * H
    mlp = 4 * ff * es
    enc = ne * (2 * norm + attn + mlp)
    dec = nd * (3 * norm + attn + es * 2 * H * dh + 4 * H + mlp) \
        + ne * 2 * H * dh * es
    out = {"params": sum(sizes), "state_bytes": 16 * sum(sizes),
           "adamw_bytes": 12 * max(sizes),
           "inputs_bytes": ne * d * (4 + es) + nd * 4,
           "loss_bytes": nd * V * (4 + es),
           "loss_backward_bytes": nd * V * 10}
    if cfg.remat:
        out["layers_bytes"] = (cfg.n_enc_layers * ne + cfg.n_layers * nd) \
            * d * es + max(enc, dec)
    else:
        out["layers_bytes"] = cfg.n_enc_layers * enc + cfg.n_layers * dec
    act = (out["inputs_bytes"] + out["layers_bytes"] + out["loss_bytes"]
           + out["loss_backward_bytes"])
    out["activation_bytes"] = act
    out["total_bytes"] = out["state_bytes"] + max(out["adamw_bytes"], act)
    return out


def whisper_train_phase(torch, dev, *, batch, frames, tokens, steps):
    """(d) whisper-small whole, bf16, ``steps`` steps of
    ``launch.steps.build_train_step`` through ``trainer_run``: each step a
    fresh batch of ``batch`` x ``frames`` seeded f32 frames and
    ``tokens`` caption tokens (``data.tokens.batch_iterator``), AdamW at
    lr 3e-4 after 5 warmup steps; remat only if the reckoned peak without
    it passes DENSE_PEAK_LIMIT.  Requires: 3 flash forward (the encoder's
    layers, the decoder's self- and cross-attention; twice that under
    remat) and 3 gradient launches a decoder layer a step, every loss
    finite and the mean of the last 5 under that of the first 5, the peak
    within its reckoning.  Reports step ms, frames + tokens a second, and
    the step's MFU and roofline bound from ``launch.costs``."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    base = get_config(WHISPER)
    rk = whisper_train_reckon(base.replace(remat=False), batch, frames,
                              tokens)
    cfg = base.replace(remat=rk["total_bytes"] > DENSE_PEAK_LIMIT)
    if cfg.remat:
        rk = whisper_train_reckon(cfg, batch, frames, tokens)
    emit("whisper_train_cut", {"config": cfg.name, "remat": cfg.remat,
                               "reckoned": rk})
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    model, _ = card_model(torch, dev, cfg)
    model.requires_grad_(True)
    ocfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=steps)
    gen = torch.Generator(device=dev).manual_seed(2430)
    it = batch_iterator(batch, tokens, seed=5, vocab_size=cfg.vocab_size)

    def run(on_step):
        state = {"m": model, "opt": adamw.init_opt_state(model, ocfg)}
        step = build_train_step(cfg, ocfg)
        for i in range(1, steps + 1):
            b = {"frames": torch.randn((batch, frames, cfg.d_model),
                                       generator=gen, device=dev),
                 "tokens": torch.from_numpy(next(it)["tokens"]).to(dev)}
            state["m"], state["opt"], m = step(state["m"], state["opt"], b)
            del b
            on_step(i, m, state["m"])
        trained = state.pop("m")
        state.clear()                     # frees the optimizer state
        return trained, "training complete"

    model, row = trainer_run(
        torch, dev, cfg, steps=steps, batch=batch, seq=frames + tokens,
        fwd=n_attn * (2 if cfg.remat else 1), bwd=n_attn,
        reckoned=rk["total_bytes"], run=run)
    row.update(frames=frames, tokens=tokens,
               seq=f"{frames} frames + {tokens} tokens",
               frames_tokens_per_s=row.pop("tokens_per_s"),
               frames_tokens_per_s_overall=row.pop("tokens_per_s_overall"),
               n_enc_layers=cfg.n_enc_layers,
               peak_share_of_reckoning=row["training_peak_bytes"]
               / rk["total_bytes"],
               roofline=train_roofline(cfg, batch, frames,
                                       row["step_ms_p50"]))
    row["reckoned"] = rk
    emit("whisper_train_phase", row)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def whisper_train_replay(torch, dev, *, n_layers, frames, tokens, steps,
                         tol=TRAIN_REPLAY_TOL):
    """(e) whisper-small at full width cut to ``n_layers`` encoder and as
    many decoder layers, f32: ``steps`` train steps on 1 x (``frames``
    seeded frames, ``tokens`` caption tokens) from the same seeded weights
    on the card and on the CPU port; loss, grad norm and masters within
    ``tol``, and 3 flash forward and gradient launches a decoder layer a
    step on the card."""
    import gc

    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import common as cm
    from repro_torch.models.api import model_api
    from repro_torch.optim import adamw

    cfg = get_config(WHISPER).replace(
        n_layers=n_layers, n_enc_layers=n_layers, dtype=torch.float32,
        remat=False)
    ocfg = adamw.AdamWConfig(warmup_steps=1, total_steps=steps)
    cpu = model_api(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    tree = convert.encdec_params_to_numpy(cpu)      # copies: training is in
    it = batch_iterator(1, tokens, seed=3, vocab_size=cfg.vocab_size)
    rng = np.random.default_rng(2440)
    batches = [{"frames": torch.from_numpy(rng.normal(
        size=(1, frames, cfg.d_model)).astype(np.float32)),
        "tokens": torch.from_numpy(next(it)["tokens"])}
        for _ in range(steps)]
    runs = {}
    for where in ("card", "cpu"):
        m = cpu if where == "cpu" else convert.encdec_params_from_numpy(
            cfg, tree, device=dev)
        m.requires_grad_(True)
        opt = adamw.init_opt_state(m, ocfg)
        step = build_train_step(cfg, ocfg)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = []
        for b in batches:
            m, opt, met = step(m, opt, {k: v.to(m.device)
                                        for k, v in b.items()})
            hist.append({k: float(met[k]) for k in ("loss", "grad_norm")})
        runs[where] = (hist, dict(cm.leaves(opt.master)),
                       time.perf_counter() - t0, ops.launch_counts())
    (gh, gm, gs, gl), (ch, cmast, cs, _) = runs["card"], runs["cpu"]
    err = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(gh, ch))
           for k in ("loss", "grad_norm")}
    num = sum(float(((gm[p].cpu() - cmast[p]) ** 2).sum()) for p in cmast)
    den = sum(float((cmast[p] ** 2).sum()) for p in cmast)
    err["master"] = (num / den) ** 0.5
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    check(gl["flash_attention"] == steps * n_attn
          and gl["flash_attention_bwd"] == steps * n_attn,
          f"{WHISPER} train replay: flash launches {gl}")
    for k in ("loss", "grad_norm", "master"):
        check(err[k] <= tol[k], f"{WHISPER} train replay {k} rel err "
              f"{err[k]} within {tol[k]}")
    out = {"config": f"{WHISPER} cut to {n_layers} + {n_layers} layers, f32",
           "batch": 1, "frames": frames, "tokens": tokens, "steps": steps,
           "card": gh, "cpu": ch,
           "rel_err": {k: err[k] for k in ("loss", "grad_norm")},
           "master_rel_err_l2": err["master"],
           "master_max_abs_err": max(float((gm[p].cpu() - cmast[p]).abs()
                                           .max()) for p in cmast),
           "launches": gl, "card_s_host": gs, "cpu_s_host": cs,
           "tolerance": tol}
    emit("whisper_train_replay", out)
    del runs, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- step 25
def mesh_phase(torch) -> object:
    """(a) ``make_production_mesh`` (256 and 512 devices) must raise on this
    machine, naming the count it needs; ``make_host_mesh()`` is 1 x 1 on
    cuda:0.  Returns the host mesh."""
    from repro_torch.launch import mesh as mesh_mod

    out = {"cuda_devices": torch.cuda.device_count()}
    for multi in (False, True):
        try:
            mesh_mod.make_production_mesh(multi_pod=multi)
        except RuntimeError as e:
            out["pod2" if multi else "pod1"] = str(e)
        else:
            check(False, f"make_production_mesh(multi_pod={multi}) returned "
                  f"on {torch.cuda.device_count()} card(s)")
    host = mesh_mod.make_host_mesh()
    out["host"] = {"shape": dict(host.shape),
                   "devices": [str(d) for d in host.devices.flat]}
    check(dict(host.shape) == {"data": 1, "model": 1}
          and list(host.devices.flat) == [torch.device("cuda", 0)],
          f"the host mesh is 1 x 1 on cuda:0: {out['host']}")
    emit("mesh_phase", out)
    return host


def dryrun_phase() -> dict:
    """(b) ``launch.dryrun.main --all`` on both planning meshes into a
    temporary directory (its own line a cell: per-device argument, output
    and alias bytes, analytic FLOPs, the bound without collectives): every
    ASSIGNED x SHAPES cell planned, or skipped where the reference skips
    it (long_500k on a full-attention config)."""
    import tempfile

    from repro_torch.configs import ASSIGNED
    from repro_torch.configs.base import SHAPES, cell_is_runnable
    from repro_torch.launch import dryrun

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for multi in (False, True):
            flag = ["--multi-pod"] if multi else []
            t0 = time.perf_counter()
            try:
                dryrun.main(["--all", "--out", tmp] + flag)
            except SystemExit as e:
                check(False, f"dry run --all {flag}: exit {e.code}")
            sec = time.perf_counter() - t0
            d = Path(tmp) / ("pod2" if multi else "pod1")
            recs = {(a, sh): json.loads((d / f"{a}__{sh}.json").read_text())
                    for a in ASSIGNED for sh in SHAPES}
            planned = {k: r for k, r in recs.items() if not r.get("skipped")}
            check(set(planned) == {(a, sh) for a, sh in recs
                                   if cell_is_runnable(a, sh)},
                  f"dry run {flag}: planned {len(planned)} cells")
            for k, r in planned.items():
                check(r["memory"]["argument_bytes_per_dev"] > 0
                      and r["analytic"]["flops"] > 0
                      and r["roofline"]["bound_s"] > 0,
                      f"dry run {flag} {k}: {r['memory']}")
            big = max(planned, key=lambda k: planned[k]["memory"][
                "argument_bytes_per_dev"])
            out["pod2" if multi else "pod1"] = {
                "chips": 512 if multi else 256, "cells": len(recs),
                "planned": len(planned),
                "skipped": len(recs) - len(planned), "seconds": sec,
                "largest_arguments": {
                    "cell": "__".join(big), "bytes_per_dev": planned[big][
                        "memory"]["argument_bytes_per_dev"]}}
    emit("dryrun_phase", out)
    return out


def mesh_cell(kind: str, host):
    """whisper-small's dry-run config and its ``kind`` cell cut to one
    device's share of the data axis, the sequence halved while the
    reckoned peak passes DENSE_PEAK_LIMIT: (cfg, cell, cut)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun

    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    full = SHAPES[name]
    cfg = dryrun.cell_config(WHISPER, name, host)
    B, S = full.global_batch // MESH_SHARE, full.seq_len
    while mesh_reckon(cfg, kind, B, S)["total_bytes"] > DENSE_PEAK_LIMIT:
        S //= 2
    cell = dataclasses.replace(full, global_batch=B, seq_len=S)
    cut = {"cell": name, "global_batch": full.global_batch, "batch": B,
           "seq_len": full.seq_len, "seq": S, "seq_cut": S != full.seq_len,
           "reckoned": mesh_reckon(cfg, kind, B, S)}
    return cfg, cell, cut


def mesh_reckon(cfg, kind: str, B: int, S: int) -> dict:
    """An upper bound of a host-mesh step's peak, reckoned before its run:
    its arguments' bytes (the specs' own per-device bytes on the 1 x 1
    mesh) and its transients.  Prefill: ``whisper_serve_reckon``'s cross k
    / v, encoder output and one encoder layer at the frames' length.
    Decode: one layer's self cache cast to f32 three times over (k, v and
    an einsum's copy), six f32 score rows, the kept logits and the greedy
    pick's temporaries.  Train: ``whisper_train_reckon`` (the state, the
    batch and the backward pass)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_host_mesh

    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    cell = dataclasses.replace(SHAPES[name], global_batch=B, seq_len=S)
    _, args = steps_mod.build_step(cfg, make_host_mesh("cpu"), cell)
    arg_b = sum(steps_mod.bytes_per_device(a) for a in args)
    if kind == "train":
        rk = whisper_train_reckon(cfg, B, S, 448)
        return {"arguments_bytes": arg_b, **rk}
    V, H, Kv, dh = cfg.vocab_size, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    es = cfg.dtype.itemsize
    if kind == "prefill":
        rk = whisper_serve_reckon(cfg, B, S, S)
        out = {k: rk[k] for k in ("cross_bytes", "encoder_out_bytes",
                                  "encoder_layer_bytes")}
        out["logits_bytes"] = B * V * 4
    else:
        out = {"cache_f32_bytes": 3 * B * S * Kv * dh * 4,
               "scores_bytes": 6 * B * H * S * 4,
               "logits_bytes": MESH_RUNS["decode"] * B * V * es
               + B * V * 24}
    out["total_bytes"] = arg_b + sum(out.values())
    out["arguments_bytes"] = arg_b
    return out


def placed_bytes(steps_mod, *trees) -> int:
    return sum(t.nbytes for t in steps_mod.arg_tensors(trees))


def mesh_prefill(torch, dev, host, runs: int) -> dict:
    """(c) prefill_32k: seeded frames through the host-mesh prefill step
    ``runs`` times, then ``model_api.prefill`` once: logits and cross k /
    v the same bits; 36 flash launches a step run."""
    import gc

    from repro_torch.configs.base import make_inputs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.api import model_api

    cfg, cell, cut = mesh_cell("prefill", host)
    step, args = steps_mod.build_step(cfg, host, cell)
    api = model_api(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model, init = card_model(torch, dev, cfg)
    batch = make_inputs(cfg, cell, torch.Generator(device=dev).manual_seed(
        2510), device=dev)
    caches = api.init_cache(cell.global_batch, cell.seq_len, device=dev)
    arg_b = sum(steps_mod.bytes_per_device(a) for a in args)
    placed = placed_bytes(steps_mod, model, batch, caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ms, got = [], None
    for _ in range(runs):
        got = None
        t0 = time.perf_counter()
        logits, st = step(model, batch, caches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        got = [logits, st.cross_k, st.cross_v]
        del logits, st
    peak = torch.cuda.max_memory_allocated() - held
    launches = ops.launch_counts()
    logits, st = api.prefill(model, batch, caches)
    same = same_bits(torch, got, [logits, st.cross_k, st.cross_v])
    nonfinite = int((~torch.isfinite(got[0])).sum())
    L = cfg.n_layers
    check(placed == arg_b, f"prefill: placed {placed} bytes, args {arg_b}")
    check(same, "prefill: the host-mesh step = model_api.prefill bit for bit")
    check(launches["flash_attention"] == runs * 3 * L,
          f"prefill: flash launches {launches['flash_attention']}")
    check(nonfinite == 0, f"prefill: {nonfinite} logits not finite")
    check(peak <= cut["reckoned"]["total_bytes"],
          f"prefill: peak {peak} within {cut['reckoned']['total_bytes']}")
    row = {"cut": cut, "batch": cell.global_batch, "frames": cell.seq_len,
           "args_bytes": arg_b, "placed_bytes": placed, "step_ms": ms,
           "step_ms_p50": float(np.percentile(ms, 50)),
           "frames_per_s": cell.global_batch * cell.seq_len
           / float(np.percentile(ms, 50)) * 1e3,
           "launches": launches, "same_bits_as_mesh_free": same,
           "peak_bytes": peak, "weights_bytes": init["weights_bytes"],
           "peak_share_of_reckoning": peak / cut["reckoned"]["total_bytes"]}
    del model, batch, caches, got, logits, st
    gc.collect()
    torch.cuda.empty_cache()
    return row


def mesh_decode(torch, dev, host, steps: int) -> dict:
    """(c) decode_32k: a 32768-slot self cache whose cross k / v a prefill
    of ``enc_seq`` seeded frames filled, then ``steps`` greedy host-mesh
    decode steps at pos 1 + t, and the same from a fresh self cache
    through ``model_api.decode``: every step's logits and the final self
    caches the same bits; 12 flash launches a step (the cross-attention)."""
    import gc

    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.api import model_api
    from repro_torch.models.lm import greedy_token

    cfg, cell, cut = mesh_cell("decode", host)
    step, args = steps_mod.build_step(cfg, host, cell)
    api = model_api(cfg)
    B, T = cell.global_batch, cell.seq_len
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model, init = card_model(torch, dev, cfg)
    caches = api.init_cache(B, T, device=dev)
    frames = torch.randn((B, cfg.enc_seq, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             2511))
    logits, st = api.prefill(model, {"frames": frames}, caches)
    caches.cross_k.copy_(st.cross_k)
    caches.cross_v.copy_(st.cross_v)
    tok0 = greedy_token(logits)
    del st, frames, logits
    arg_b = sum(steps_mod.bytes_per_device(a) for a in args[:3])
    placed = placed_bytes(steps_mod, model, tok0, caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    def run(fn, c):
        tok, outs, ms = tok0, [], []
        for i in range(steps):
            t0 = time.perf_counter()
            logits, c = fn(model, tok, c, 1 + i)
            tok = greedy_token(logits)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(logits)
        return outs, c, ms

    got, caches, ms = run(step, caches)
    peak = torch.cuda.max_memory_allocated() - held
    launches = ops.launch_counts()
    fresh = api.init_cache(B, T, device=dev)._replace(
        cross_k=caches.cross_k, cross_v=caches.cross_v)
    want, fresh, _ = run(api.decode, fresh)
    flat = lambda c: [t for kv in c.self_kv for t in kv if t is not None]  # noqa
    same = same_bits(torch, got + flat(caches), want + flat(fresh))
    lengths = sorted({int(kv.length) for kv in caches.self_kv})
    L = cfg.n_layers
    check(placed == arg_b, f"decode: placed {placed} bytes, args {arg_b}")
    check(same, "decode: the host-mesh steps = model_api.decode bit for bit")
    check(lengths == [steps], f"decode: self cache lengths {lengths}")
    check(launches["flash_attention"] == steps * L,
          f"decode: flash launches {launches['flash_attention']}")
    check(peak <= cut["reckoned"]["total_bytes"],
          f"decode: peak {peak} within {cut['reckoned']['total_bytes']}")
    row = {"cut": cut, "batch": B, "cache_slots": T, "steps": steps,
           "args_bytes": arg_b, "placed_bytes": placed,
           "pos_note": "pos is a host int: its 4-byte spec is not placed",
           "step_ms": ms, "step_ms_p50": float(np.percentile(ms, 50)),
           "tokens_per_s": B / float(np.percentile(ms, 50)) * 1e3,
           "launches": launches, "same_bits_as_mesh_free": same,
           "peak_bytes": peak, "weights_bytes": init["weights_bytes"],
           "peak_share_of_reckoning": peak / cut["reckoned"]["total_bytes"]}
    del model, caches, fresh, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return row


def mesh_train(torch, dev, host, steps: int) -> dict:
    """(c) train_4k: ``steps`` AdamW steps of the host-mesh train step on
    seeded batches (``make_inputs``: frames and 448 caption tokens), then
    the same from the same seeded weights through the mesh-free
    ``build_train_step``: every metric, parameter, master and moment the
    same bits; under remat 72 flash forward and 36 gradient launches a
    step (the encoder's 12 layers, the decoder's self- and
    cross-attention, each forward recomputed)."""
    import gc

    from repro_torch.configs.base import make_inputs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import common as cm
    from repro_torch.optim import adamw

    cfg, cell, cut = mesh_cell("train", host)
    step, args = steps_mod.build_step(cfg, host, cell)
    ocfg = adamw.AdamWConfig()         # build_step's
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    arg_b = sum(steps_mod.bytes_per_device(a) for a in args)

    def run(fn, measure):
        model, init = card_model(torch, dev, cfg)
        model.requires_grad_(True)
        opt = adamw.init_opt_state(model, ocfg)
        gen = torch.Generator(device=dev).manual_seed(2520)
        placed, ms, mets = None, [], []
        if measure:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
        for _ in range(steps):
            b = make_inputs(cfg, cell, gen, device=dev)
            if placed is None:
                placed = placed_bytes(steps_mod, model, opt, b)
            t0 = time.perf_counter()
            model, opt, m = fn(model, opt, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            mets.append(m)
            del b
        return model, opt, mets, ms, placed, init

    model, opt, mets, ms, placed, init = run(step, True)
    peak = torch.cuda.max_memory_allocated() - held
    launches = ops.launch_counts()
    model_b, opt_b, mets_b, _, _, _ = run(
        steps_mod.build_train_step(cfg, ocfg), False)
    tree = lambda m, o: ([p for _, p in cm.leaves(m.tree())]  # noqa
                         + [o.step] + [t for x in (o.master, o.m, o.v)
                                       for _, t in cm.leaves(x)])
    same = same_bits(torch, [m[k] for m in mets for k in sorted(m)]
                     + tree(model, opt),
                     [m[k] for m in mets_b for k in sorted(m)]
                     + tree(model_b, opt_b))
    losses = [float(m["loss"]) for m in mets]
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    fwd = n_attn * (2 if cfg.remat else 1)
    check(placed == arg_b, f"train: placed {placed} bytes, args {arg_b}")
    check(same, "train: the host-mesh steps = build_train_step bit for bit")
    check(all(math.isfinite(x) for x in losses), f"train: losses {losses}")
    check(launches["flash_attention"] == steps * fwd
          and launches["flash_attention_bwd"] == steps * n_attn,
          f"train: flash launches {launches}")
    check(peak <= cut["reckoned"]["total_bytes"],
          f"train: peak {peak} within {cut['reckoned']['total_bytes']}")
    row = {"cut": cut, "batch": cell.global_batch, "frames": cell.seq_len,
           "tokens": 448, "remat": cfg.remat, "steps": steps,
           "args_bytes": arg_b, "placed_bytes": placed, "step_ms": ms,
           "step_ms_p50": float(np.percentile(ms, 50)), "losses": losses,
           "frames_tokens_per_s": cell.global_batch * (cell.seq_len + 448)
           / float(np.percentile(ms, 50)) * 1e3,
           "launches": launches, "same_bits_as_mesh_free": same,
           "peak_bytes": peak, "weights_bytes": init["weights_bytes"],
           "peak_share_of_reckoning": peak / cut["reckoned"]["total_bytes"]}
    del model, opt, model_b, opt_b, mets, mets_b
    gc.collect()
    torch.cuda.empty_cache()
    return row


def whisper_mesh_phase(torch, dev, host, smi: str) -> dict:
    """(c) whisper-small's prefill, decode and train steps through
    ``build_step`` on the host mesh (``mesh_prefill``, ``mesh_decode``,
    ``mesh_train``), with the card's name and power limit beside the
    p50 step times."""
    cuts = {k: mesh_cell(k, host)[2] for k in ("prefill", "decode", "train")}
    emit("whisper_mesh_cuts", cuts)
    out = {"config": WHISPER, "card": smi,
           "prefill": mesh_prefill(torch, dev, host, MESH_RUNS["prefill"]),
           "decode": mesh_decode(torch, dev, host, MESH_RUNS["decode"]),
           "train": mesh_train(torch, dev, host, MESH_RUNS["train"])}
    out["step_ms_p50"] = {k: out[k]["step_ms_p50"]
                          for k in ("prefill", "decode", "train")}
    emit("whisper_mesh_phase", out)
    return out


def kernel_resources(build) -> dict:
    """{source: {kernel: registers, static shared memory, spills}} from
    ptxas's ``-v`` report in each build log (dynamic shared memory is set
    at launch and not in it)."""
    import re

    out = {}
    for src in build.SOURCES:
        rows, name = {}, None
        for ln in build.build_log(src).splitlines():
            m = re.search(r"entry function '(\w+)'", ln)
            if m:
                name = demangle(m.group(1))
                rows[name] = {}
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m:
                rows[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                rows[name]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                rows[name]["static_smem_bytes"] = int(m.group(1)) if m else 0
        out[src] = rows
    return out


def demangle(sym: str) -> str:
    """``..._18flash_wgmma_kernelILi64ELi3EEEv...`` -> ``flash_wgmma_kernel
    <64,3>``: the kernel's name and its integer or type template args."""
    import re

    for m in re.finditer(r"_kernel", sym):
        end = m.end()
        starts = [a for a in range(end - 1, 0, -1)
                  if sym[:a].endswith(str(end - a))]
        if not starts:
            continue
        name, at = sym[starts[0]:end], end
        if sym[at:at + 1] != "I":
            return name
        args, at = [], at + 1
        while at < len(sym) and sym[at] != "E":
            lit = re.match(r"L[a-z](\d+)E", sym[at:])    # Li64E, Lb1E
            ident = re.match(r"(\d+)", sym[at:])
            if lit:
                args.append(lit.group(1))
                at += lit.end()
            elif ident:
                k = int(ident.group(1))
                args.append(sym[at + ident.end():at + ident.end() + k])
                at += ident.end() + k
            else:
                args.append({"f": "float", "i": "int"}.get(sym[at], sym[at]))
                at += 1
        return f"{name}<{','.join(args)}>"
    return sym


# -------------------------------------------------------------------- main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.core import Knobs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = resolve_device("cuda")
    emit("versions", {"python": sys.version.split()[0],
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    build.build_all()
    emit("build", {"seconds": time.perf_counter() - t0})
    emit("kernel_resources", kernel_resources(build))

    clock = Clock(torch)
    # the floor of a kernel time on this clock: a one-element fill
    one = torch.empty(1, device=dev)
    emit("clock", {"empty_kernel_ms": clock.ms(lambda: one.fill_(0.0))})
    phase_s = {}

    def timed(phase, fn, /, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[phase] = time.perf_counter() - t0
        return out
    lift_row, topk_row = timed("kernel_checks", kernel_checks, torch, clock,
                               dev)
    any_k = timed("topk_any_k_checks", topk_any_k_checks, torch, clock, dev)
    flash_row = timed("attention_checks", attention_checks, torch, clock, dev)
    nd_row = timed("nearest_checks", nearest_checks, torch, clock, dev)
    nd_path = timed("nearest_phase", nearest_phase, torch, dev)
    knobs = Knobs()
    path, kept, snap, loop = timed("main_path", main_path, torch, dev, knobs,
                                   **DEPLOYMENT)
    timed("profile_phase", profile_phase, torch, dev, loop, **DEPLOYMENT)
    timed("query_phase", query_phase, torch, dev, **QUERY_STORE)
    timed("cross_device", cross_device, torch, knobs,
          DEPLOYMENT["embed_dim"], kept, snap, loop.classes)
    captioner = get_config("semanticxr-captioner-110m")
    serve = timed("serve_phase", serve_phase, torch, dev, captioner, **SERVE)
    timed("replay_phase", replay_phase, torch, dev, captioner, **REPLAY)
    index, st, idx, index_topk = timed("index_phase", index_phase, torch, dev,
                                       clock, **INDEX)
    timed("serving_phase", serving_phase, torch, dev, st, idx, **SERVING)
    del idx
    arms = timed("mapping_arms_phase", mapping_arms_phase, torch, dev, **ARMS)
    fleet = timed("fleet_phase", fleet_phase, torch, dev, st,
                  sweep_full=FLEET_FULL, sweep_default=FLEET_DEFAULT,
                  twins=TWINS, index=INDEX)
    del st
    sim = timed("sim_phase", sim_phase, torch, dev, deployment=DEPLOYMENT)
    loop_out = timed("serving_loop_phase", serving_loop_phase, torch, dev,
                     SERVING_LOOP)
    bwd_row = timed("flash_bwd_checks", flash_bwd_checks, torch, clock, dev)
    train = timed("train_phase", train_phase, torch, dev, **TRAIN)
    mla_row = timed("mla_attention_checks", mla_attention_checks, torch,
                    clock, dev)
    deepseek = timed("deepseek_serve_phase", deepseek_serve_phase, torch,
                     dev, **DEEPSEEK)
    timed("deepseek_replay_phase", deepseek_replay_phase, torch, dev,
          **DEEPSEEK_REPLAY)
    mla_bwd_row = timed("mla_bwd_checks", mla_bwd_checks, torch, clock, dev)
    ds_train = timed("deepseek_train_phase", deepseek_train_phase, torch,
                     dev, **DEEPSEEK_TRAIN)
    timed("deepseek_train_replay", deepseek_train_replay, torch, dev,
          **DEEPSEEK_TRAIN_REPLAY)
    timed("deepseek_kill_resume", deepseek_kill_resume, torch, dev,
          **DEEPSEEK_KILL)
    dense120, dense128 = timed("dense_attention_checks",
                               dense_attention_checks, torch, clock, dev)
    dense = {name: timed(f"dense_serve_{name}", dense_serve_phase, torch,
                         dev, name, **kw) for name, kw in DENSE_SERVE}
    timed("dense_replay_phase", dense_replay_phase, torch, dev,
          **DENSE_REPLAY)
    dense_bwd120, dense_bwd128 = timed("dense_bwd_checks", dense_bwd_checks,
                                       torch, clock, dev)
    dense_train = {name: timed(f"dense_train_{name}", dense_train_phase,
                               torch, dev, name, steps=DENSE_TRAIN_STEPS,
                               **kw) for name, kw in DENSE_TRAIN}
    timed("dense_train_replay", dense_train_replay, torch, dev,
          **DENSE_TRAIN_REPLAY)
    timed("dense_kill_resume", dense_kill_resume, torch, dev, **DENSE_KILL)
    phi3_fwd = timed("phi3_attention_checks", dense_attention_checks, torch,
                     clock, dev, cases=PHI3_ATTN_CASES, timed=PHI3_TIMED,
                     tag="phi3_attention", seed=240, next_head=True)
    phi3_bwd, = timed("phi3_bwd_checks", dense_bwd_checks, torch, clock, dev,
                      cases=PHI3_BWD_CASES, timed=PHI3_BWD_TIMED,
                      tag="phi3_attention_bwd", seed=900)
    phi3_serve = timed("phi3_serve", dense_serve_phase, torch, dev, PHI3,
                       **PHI3_SERVE)
    timed("phi3_replay_phase", dense_replay_phase, torch, dev,
          **PHI3_REPLAY_RUN)
    phi3_train = timed("phi3_train_phase", phi3_train_phase, torch, dev,
                       **PHI3_TRAIN)
    timed("phi3_train_replay", dense_train_replay, torch, dev,
          **PHI3_TRAIN_REPLAY)
    timed("phi3_kill_resume", dense_kill_resume, torch, dev, **PHI3_KILL)
    jamba_fwd, = timed("jamba_attention_checks", dense_attention_checks,
                       torch, clock, dev, cases=JAMBA_ATTN_CASES,
                       timed=JAMBA_TIMED, tag="jamba_attention", seed=250)
    wkv6_row = timed("wkv6_checks", wkv6_checks, torch, clock, dev)
    recurrent = {name: timed(f"recurrent_serve_{name}",
                             recurrent_serve_phase, torch, dev, name, **kw)
                 for name, kw in RECURRENT_SERVE}
    check(recurrent[RWKV6]["flash_launches"] == 0,
          f"{RWKV6}: no flash launch")
    timed("recurrent_replay_phase", recurrent_replay_phase, torch, dev,
          **RECURRENT_REPLAY_RUN)
    jamba_train_fwd, = timed("jamba_train_attention_checks",
                             dense_attention_checks, torch, clock, dev,
                             cases=JAMBA_TRAIN_ATTN_CASES, timed=(0,),
                             tag="jamba_train_attention", seed=260)
    jamba_train_bwd, = timed("jamba_train_bwd_checks", dense_bwd_checks,
                             torch, clock, dev, cases=JAMBA_TRAIN_ATTN_CASES,
                             timed=(0,), tag="jamba_train_attention_bwd",
                             seed=960)
    rec_train = {name: timed(f"recurrent_train_{name}",
                             recurrent_train_phase, torch, dev, name, **kw)
                 for name, kw in RECURRENT_TRAIN}
    check(rec_train[RWKV6]["launches"]["flash_attention"] == 0,
          f"{RWKV6} training: no flash launch")
    check(rec_train[RWKV6]["launches"]["wkv6"] == 0,
          f"{RWKV6} training: the chunk loop under autograd, no wkv6 launch")
    timed("recurrent_train_replay", recurrent_train_replay, torch, dev,
          **RECURRENT_TRAIN_REPLAY)
    timed("recurrent_kill_resume", recurrent_kill_resume, torch, dev,
          **RECURRENT_KILL)
    whisper_fwd, whisper_bwd = timed("whisper_attention_checks",
                                     whisper_attention_checks, torch, clock,
                                     dev)
    whisper_serve = timed("whisper_serve_phase", whisper_serve_phase, torch,
                          dev, **WHISPER_SERVE)
    timed("whisper_replay_phase", whisper_replay_phase, torch, dev,
          **WHISPER_REPLAY)
    whisper_train = timed("whisper_train_phase", whisper_train_phase, torch,
                          dev, **WHISPER_TRAIN)
    timed("whisper_train_replay", whisper_train_replay, torch, dev,
          **WHISPER_TRAIN_REPLAY)
    host = timed("mesh_phase", mesh_phase, torch)
    timed("dryrun_phase", dryrun_phase)
    whisper_mesh = timed("whisper_mesh_phase", whisper_mesh_phase, torch,
                         dev, host, smi)
    emit("phase_seconds", phase_s)
    print(smi, flush=True)          # again, inside the tail of a long log

    launches = path["launches"]
    kernels = [
        {"name": "lift_compact", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lift_compact.cu",
         "replaces": "src/repro/kernels/lift_compact.py:229",
         "launches": launches["lift_compact"],
         "launched_on": "step 3 main path", **lift_row,
         "mapping_arms_launches": {a: arms[a]["launches"]["lift_compact"]
                                   for a, _, _ in ARM_MODES},
         "sim_launches": {
             "network_drop": sim["network_drop"]["launches"]["lift_compact"],
             "fleet_simulator":
                 sim["fleet_simulator"]["launches"]["lift_compact"]}},
        {"name": "query_topk_bias", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/query_topk.cu",
         "replaces": "src/repro/kernels/query_topk.py:121",
         "launches": launches["query_topk_bias"],
         "launched_on": "step 3 main path", **topk_row,
         "index_launches": index["launches"]["query_topk_bias"],
         "index_shapes": index_topk, "any_k_shapes": any_k,
         "fleet_launches": {
             "fleet_server_query": fleet["fleet_server"]["query_launches"],
             "sharded_full_mix_1M": fleet["sharded_query"]["launches"]},
         "sim_launches": {
             "network_drop":
                 sim["network_drop"]["launches"]["query_topk_bias"],
             "fleet_simulator":
                 sim["fleet_simulator"]["launches"]["query_topk_bias"]},
         "serving_loop_launches": {
             mode: a["launches"]["query_topk_bias"]
             for mode, a in loop_out["arms"].items()}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "launches": serve["launches"]["flash_attention"],
         "launched_on": "step 7 captioner serving path", **flash_row,
         "train_launches": train["train"]["launches"]["flash_attention"],
         "whisper": {
             "instance": "(dh, dv) = (64, 64) with k / v of their own "
                         "length T: the encoder's self-attention (S = T = "
                         "1500), the decoder's causal self-attention and "
                         "its cross-attention (S = 448 or 1 against T = "
                         "1500)",
             "launches": whisper_serve["flash_launches"],
             "launched_on": "step 24 whisper-small serving path (36 a "
                            "prefill, 12 a decode step, 2 x (prefill + 64 "
                            "steps))",
             "train_launches": whisper_train["launches"]["flash_attention"],
             "training_shapes": whisper_fwd,
             "mesh_steps": {
                 kind: whisper_mesh[kind]["launches"]["flash_attention"]
                 for kind in ("prefill", "decode", "train")},
             "mesh_steps_launched_on": "step 25 whisper-small's steps "
                                       "through launch.steps.build_step on "
                                       "the 1 x 1 host mesh (36 a prefill, "
                                       "12 a decode step, 72 a train step "
                                       "under remat)"}},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "gradient_of": "flash_attention (the JAX package trains through "
                        "src/repro/models/attention.py:55 under jax.grad)",
         "launches": train["train"]["launches"]["flash_attention_bwd"],
         "launched_on": "step 16 captioner training path (12 a step); "
                        "step 18 DeepSeek training path (2 a step, the "
                        "(192, 128) instance); step 20 the dense GQA "
                        "configs' training paths (one a layer a step: "
                        "(120, 120) on h2o-danube-3-4b, (128, 128) on "
                        "gemma2-27b, yi-9b and minitron-4b); step 21 "
                        "phi-3-vision-4.2b's training path (one a layer a "
                        "step, the (96, 96) instance, 32 layers); step 23 "
                        "jamba-v0.1-52b-train-cut's (one a step, the "
                        "(128, 128) instance at its attention layer)",
         **bwd_row,
         "deepseek_train_launches":
             ds_train["launches"]["flash_attention_bwd"],
         "dense_train_launches": {
             n: d["launches"]["flash_attention_bwd"]
             for n, d in dense_train.items()},
         "phi3_train_launches": phi3_train["launches"]["flash_attention_bwd"],
         "whisper": {
             "instance": "(dqk, dv) = (64, 64) with k / v of their own "
                         "length T (dk, dv at T): the encoder, the "
                         "decoder's causal self-attention and its "
                         "cross-attention (448 against 1500)",
             "launches": whisper_train["launches"]["flash_attention_bwd"],
             "launched_on": "step 24 whisper-small training path (36 a "
                            "step: 12 encoder, 12 decoder self, 12 cross)",
             "training_shapes": whisper_bwd,
             "mesh_train_launches":
                 whisper_mesh["train"]["launches"]["flash_attention_bwd"],
             "mesh_train_launched_on": "step 25 whisper-small's train step "
                                       "through launch.steps.build_step on "
                                       "the 1 x 1 host mesh (36 a step)"},
         "dh96_instance": {
             "instance": "(dqk, dv) = (96, 96): flash_bwd_dq_kernel<96,96> "
                         "and flash_bwd_dkdv_kernel<96,96> (bf16, on the "
                         "128-wide tiles, columns 96-127 zero-filled), the "
                         "f32 pair <96,96>",
             "launches": phi3_train["launches"]["flash_attention_bwd"],
             **phi3_bwd},
         "dh120_instance": {
             "instance": "(dqk, dv) = (120, 120): flash_bwd_dq_kernel<120,"
                         "120> and flash_bwd_dkdv_kernel<120,120> (bf16, on "
                         "the 128-wide tiles, columns 120-127 zero-filled), "
                         "the f32 pair <120,120>",
             "launches": dense_train["h2o-danube-3-4b"]["launches"][
                 "flash_attention_bwd"], **dense_bwd120},
         "gqa128_training": {
             "instance": "(dqk, dv) = (128, 128) at gemma2-27b's windowed "
                         "training shape",
             "launches": sum(dense_train[n]["launches"]["flash_attention_bwd"]
                             for n in ("gemma2-27b", "yi-9b",
                                       "minitron-4b"))
             + rec_train[JAMBA]["launches"]["flash_attention_bwd"],
             "launches_by_config": {
                 **{n: dense_train[n]["launches"]["flash_attention_bwd"]
                    for n in ("gemma2-27b", "yi-9b", "minitron-4b")},
                 JAMBA_TRAIN_CUT:
                     rec_train[JAMBA]["launches"]["flash_attention_bwd"]},
             **dense_bwd128,
             "jamba_training_shape": {
                 "launches": rec_train[JAMBA]["launches"][
                     "flash_attention_bwd"],
                 "launched_on": "step 23 jamba-v0.1-52b-train-cut's "
                                "training path (one a step: its attention "
                                "layer)", **jamba_train_bwd}},
         "mla_instance": {
             "instance": "(dqk, dv) = (192, 128): flash_bwd_dq_kernel<192,"
                         "128> and flash_bwd_dkdv_kernel<192,128> (bf16), "
                         "the f32 pair <192,128>",
             "launches": ds_train["launches"]["flash_attention_bwd"],
             **mla_bwd_row}},
        {"name": "flash_attention_mla", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "instance": "(dqk, dv) = (192, 128): flash_wgmma_kernel<192,128> "
                     "(bf16), flash_f32_kernel<192,128> (f32)",
         "launches": deepseek["flash_launches"],
         "launched_on": "step 17 DeepSeek-V3 serving path (one a layer a "
                        "prefill, 4 layers, 2 prefills)", **mla_row,
         "deepseek_train_launches": ds_train["launches"]["flash_attention"]},
        {"name": "flash_attention_dh120", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "instance": "(dh, dv) = (120, 120): flash_wgmma_kernel<120,120> "
                     "(bf16, on the 128-wide tiles, columns 120-127 "
                     "zero-filled by TMA), flash_f32_kernel<120,120> (f32)",
         "launches": dense["h2o-danube-3-4b"]["flash_launches"],
         "launched_on": "step 19 h2o-danube-3-4b serving path (one a layer "
                        "a prefill, 24 layers, 2 prefills an arm, bf16 and "
                        "int8 cache arms)", **dense120,
         "train_launches": dense_train["h2o-danube-3-4b"]["launches"][
             "flash_attention"]},
        {"name": "flash_attention_dh96", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "instance": "(dh, dv) = (96, 96): flash_wgmma_kernel<96,96> (bf16, "
                     "on the 128-wide tiles, columns 96-127 zero-filled by "
                     "TMA), flash_f32_kernel<96,96> (f32)",
         "launches": phi3_serve["flash_launches"],
         "launched_on": "step 21 phi-3-vision-4.2b serving path (one a "
                        "layer a prefill, 32 layers, 2 prefills of 576 "
                        "image + 1024 text positions)", **phi3_fwd[0],
         "training_shape": phi3_fwd[1],
         "train_launches": phi3_train["launches"]["flash_attention"]},
        {"name": "flash_attention_gqa128", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "instance": "(dh, dv) = (128, 128): flash_wgmma_kernel<128,128> "
                     "at the dense GQA configs' and jamba's prefill",
         "launches": sum(dense[n]["flash_launches"]
                         for n in ("gemma2-27b", "yi-9b", "minitron-4b"))
         + recurrent[JAMBA]["flash_launches"],
         "launches_by_config": {
             **{n: dense[n]["flash_launches"]
                for n in ("gemma2-27b", "yi-9b", "minitron-4b")},
             JAMBA: recurrent[JAMBA]["flash_launches"]},
         "launched_on": "step 19 gemma2-27b (46 layers), yi-9b (48) and "
                        "minitron-4b (32) serving paths, one a layer a "
                        "prefill, 2 prefills each; step 22 jamba-v0.1-52b's "
                        "serving path (one an attention layer a prefill, "
                        "1 in 8 layers), 2 prefills; step 23 its training "
                        "cut's (two a step under remat)", **dense128,
         "jamba_prefill_shape": jamba_fwd,
         "jamba_training_shape": {
             "launches": rec_train[JAMBA]["launches"]["flash_attention"],
             "launched_on": "step 23 jamba-v0.1-52b-train-cut's training "
                            "path (two a step under remat: its attention "
                            "layer's forward and recomputation)",
             **jamba_train_fwd},
         "train_launches": {
             **{n: dense_train[n]["launches"]["flash_attention"]
                for n in ("gemma2-27b", "yi-9b", "minitron-4b")},
             JAMBA_TRAIN_CUT: rec_train[JAMBA]["launches"][
                 "flash_attention"]}},
        {"name": "nearest_dist", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pairwise.cu",
         "replaces": "src/repro/kernels/pairwise.py:59",
         "launches": nd_path["launches"]["nearest_dist"],
         "launched_on": "its own phase: ops.nearest_dist is its whole path "
                        "(no system path calls it)", **nd_row},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/wkv6.cu",
         "replaces": "none (the JAX package's wkv is jnp: "
                     "src/repro/models/rwkv.py _wkv_chunk under lax.scan)",
         "launches": recurrent[RWKV6]["wkv6_launches"],
         "launched_on": "step 22 rwkv6-3b serving path (one a layer a "
                        "prefill, 2 prefills)", **wkv6_row},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
