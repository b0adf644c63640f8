#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and generation paths once
on an NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
imports ``tfmesos_tpu_torch`` from beside this file (never JAX), and:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds every kernel of ``tfmesos_tpu_torch/csrc`` from a clean build
   directory and prints the build seconds;
3. holds each forward kernel against its plain PyTorch version on the
   card at the serving path's shapes (bf16; flash fwd: o atol 2e-2, lse
   atol 1e-3; paged decode: atol 2e-2 — bf16 operands, fp32
   accumulation in a different order), and times kernel, plain version
   and one PyTorch library call as a yardstick (CUDA-event medians),
   beside the bound, with the flash_fwd route (wgmma / mma.sync / fma)
   and query rows per CTA as the C entry reports its launch (for
   flash_fwd and the timed flash_decode cases also the host microseconds
   a call takes to enqueue); the forward also at q_offset 64 with a
   window over 364 keys, [4, 1000] and GQA at the training shape; then,
   for correctness only, GQA in bf16, the float32 kernels at the tiny
   preset's head_dim 8 (atol 1e-4), head_dim 128 and full attention on
   wgmma, and bf16 head_dim 16 and 32 on mma.sync; then the linear-cache
   decode kernel with the split count S its launch reports (bf16
   [4, KV 8, M 16384, 64] at pos 1024, int8 [8, M 384] at pos 300, and
   the long-context one cold: 8 layers in turn, so their live K/V exceed
   L2, beside SDPA cycled the same way; checks of a ragged 16-token GQA
   int8 chunk, float32 at head_dim 8, ragged long context pos [0, 1024,
   9000, 16383] in bf16, int8 and float32, and M = 301: 2e-2 bf16, 1e-4
   float32, both absolute and per output row over the row's own
   magnitude; and per row against ``_decode_split_reference`` at the
   launch's S, 1e-2 bf16, 1e-5 float32); the paged decode kernel at the
   serving shape (8 layers, rows 8, KV 8, 16 pages of 64, pos 1..1000,
   the deferred chunk of t=1 and t=4) over bf16 and int8 pools, an int8
   pool taking the raw chunk with ``round_self``, and at phase 11's
   long-context bytes laid out in 256 pages beside ``flash_decode.cu``
   over the same bytes; then, for correctness only, pages of 16 and
   128, head_dim 128, float32 at head_dim 8, a GQA chunk of 8 over a
   parked row, a 70-token chunk; and at the prefill chunk's shape (1
   row, KV 8, t = 64, pages of 64, pos 0, 64, 448 and 896 at the table
   width the batcher gives each, bf16 and int8 with ``round_self``,
   timed beside SDPA over the gathered view with the chunk's causal
   mask), then a chunk whose pad positions run past the row's last
   allocated column onto the sink, and each prefix-cache tail phase 14
   dispatches (1 bf16 row at pos 512, t = 64, 128 and 192, timed), the
   session tails phase 19 dispatches (1 bf16 row at an unaligned start,
   its chunk straddling a page: t = 64 at pos 541 and 831, t = 128 at
   pos 700, timed), and the fused tick's chunk slots (S = 4 and 8 rows
   of t = 64 at pos 0 / 448 / 896 mixed across rows over 16-column
   tables, bf16 and int8 with ``round_self``, timed): every paged case with the S its launch
   reports (equal to the wrapper's plan), within 2e-2 bf16 / 1e-4
   float32 of the plain version and per row within 1e-2 / 1e-5 of
   ``_paged_split_reference`` at that S, two launches bit-identical, and
   ``round_self`` bit-identical to the chunk rounded first; and the int8
   kernel: its quantize entry at every flagship weight leaf's shape and
   a cache write's, each on the row plan's 16-byte vector path
   (round-to-nearest and seeded stochastic rounding BIT-exact to the
   plain versions, the dither unbiased), and the nine leaves of
   ``quantize_params`` in one launch (bit-exact both ways, timed against
   their bytes bound); its commit entry (K and V quantized straight into
   an int8 cache, one launch) at int8 generate's linear cache (t = 1 at
   ragged positions with a clamped start, and the t = 128 prefill) and
   int8 serving's pool (t = 1 and 4, two parked rows on the sink page;
   one row's t = 64 chunk page-aligned at pos 896, and at pos 480 with
   its pads on the sink page; the fused tick's S = 4 and 8 slots of t =
   64, two of the eight dummy slots on the sink page), the whole cache
   bit-equal to the plain
   commit but for the sink page, timed beside the plain commit and the
   sequence it replaced (a quantize launch and indexed writes for each
   of K and V), with the device operations each puts on the card
   (torch.profiler);
4. does the same for the two backward kernels (dq, dk/dv) at the
   training shape [8, 2048, 8, 64] and at [1, 512, 8, 64], causal bf16,
   against the plain backward from the same bf16 inputs (tolerance
   2e-2 x max(1, max|grad|): a bf16 gradient's rounding is relative, and
   2e-2 is about one bf16 ulp on values of order 1), with
   ``torch.autograd.grad`` through SDPA's backward as the yardstick of
   the pair and ``flash_backward`` whole (delta included) timed beside
   it; then, for correctness only, GQA, a window with q_offset, a ragged
   T with float32 gradients, the float32 kernels at head_dim 8 (atol
   1e-4), and on the wgmma route head_dim 128 (ragged T at 128 rows a
   CTA, GQA with a ragged Tq, window 100 and q_offset 37 over T 700, GQA
   at [8, 2048] with 128 keys a dk/dv CTA), the same edges at head_dim
   64, GQA with a ragged T, full attention over more keys than queries;
   and bf16 head_dim 16 and 32 on mma.sync (causal, GQA, window with
   q_offset).  Every case reads each kernel's route, rows a CTA and rows
   a streamed tile back from ``tfm_flash_bwd_last_launch`` and requires
   them equal to ``_flash_bwd_route`` and the kernel's design, launches
   both kernels twice, and calls ``flash_backward``: all three sets of
   gradients must be bit-identical;
5. warms a ``ContinuousBatcher`` on the flagship config (rows 8, page
   64, bucket 64) with ``warmup()`` (the admission prefill at each
   prompt width and the decode tick at each table width captured as
   CUDA graphs; prints the names, seconds and the graphs' pool memory),
   serves 16 seeded requests (prompts of 8..700 tokens, 32 new tokens
   each) through the graphed prefills and ticks, and checks that every prefill and every decode tick
   launched the kernels once per layer, and the paged kernel's merge
   once per layer of each tick whose table width splits it (a replay
   counts what its capture counted); then serves the same traffic with
   every tick eager (the graph helper's diagnostic switch): identical
   streams, the same exact counts; prints ms a tick, TTFT (graphed
   prefills beside eager ones), tokens/s and a profile's busy share for
   both;
6. reruns two served requests teacher-forced through ``forward`` on the
   CPU in float32 with the same float32 master weights, and requires
   the card's token wherever the CPU's top-1/top-2 margin is clear;
7. runs the flagship forward at [4, 1024] on the card;
8. trains the flagship through ``transformer_train``'s own setup and
   loop (B 8, T 2048, AdamW 3e-4, weight decay 0.01, weights seeded 0)
   for 2 + 20 steps: every loss finite, the last below the first, and
   exactly 8 launches of each of flash_fwd, flash_bwd_dq and
   flash_bwd_dkv per step; prints ms per step, tokens/s, the host time
   of ``token_batches`` per batch, and a profile of two steps;
9. runs one ``loss_fn`` + backward at full width on the card (bf16) and
   on the CPU (float32) from the same float32 master weights and batch
   at [1, 1024]: |dloss| <= 2e-2 and every leaf's gradient at cosine
   >= 0.99 to the CPU's;
10. generates with the full int8 configuration (flagship weights seeded
    0 through ``quantize_params`` on the card, an int8 KV cache; batch 8,
    prompt 128, 256 new tokens, greedy; the step a CUDA graph, replayed
    after one eager step and its capture): exactly 1 quant_int8 (the nine
    leaves), 8 x 256 quant_int8_commit (K and V of a layer, for the
    prefill and each step), 8 flash_fwd and 8 x 255 flash_decode launches (and as
    many flash_decode_merge where the shapes split the cache), and the
    tokens teacher-forced against a float32 CPU run with the same int8
    weights over an int8 cache (the phase-6 margin rule); prints decode
    tokens/s without the prefill, ms per step and a profile of 16 steps;
    then the same run with every step eager: identical tokens, the same
    counts, and its rate and profile;
11. generates in bf16 at long context (batch 4 over a 16384-slot cache,
    prompt 1024, 64 new tokens): exactly 8 flash_fwd and 8 x 63
    flash_decode launches (and merges), the tokens teacher-forced against
    the card's own ``forward``; tokens/s, ms per step and a profile of
    16 steps, graphed and eager as in phase 10;
12. serves phase 5's 16 requests with int8 weights over an int8 page
    pool: 8 flash_decode_paged launches per tick (and merges as in phase
    5), 8 flash_fwd per prefill, 1 quant_int8_commit per prefill and 1
    per tick (K and V of every layer; the paged kernel rounds the
    deferred chunk itself), two requests teacher-forced as in phase 10,
    warmup, the eager run and the profiles as in phase 5;
13. samples: the threefry golden values (jax 0.9.0's) computed on the
    card bit-exact, and a chi-square test of ``categorical`` on the card
    against softmax over 16 fixed logits (200,000 draws, one key for the
    batch and a key a row; p > 1e-3); phase 5's traffic at temperature
    0.8 with top-k 50 and with top-p 0.9, bf16 and int8 (warmed, graphed
    against eager: identical streams, exact counts; two requests each
    held to the margin rule on ``filter_logits`` of the float32 CPU
    logits plus the gumbel noise of the same ``fold_in(fold_in(rng,
    rid), step)`` keys); and int8 generate at temperature 0.8 (batch 8,
    prompt 128, 64 new tokens; graphed against eager, exact counts, the
    margin rule under the reference's split-a-step key schedule);
14. chunked prefill and the prefix cache: the flagship (rows 8, page 64,
    bucket 64) serves 16 seeded requests sharing a 512-token system
    prompt plus 8..188 tokens of their own, 32 new tokens each, greedy:
    (a) with the prefix cache unchunked, (b) with ``prefill_chunk=64``
    and the cache, (c) as (b) over an int8 pool, where the cache
    bypasses.  Each run on a fresh batcher, warmed, graphed (serving
    captures no graph warmup did not), then
    again eager: identical streams and exact launch counts (8
    flash_decode_paged for each tick, tail and chunk, merges where the
    shape splits, 8 flash_fwd for each cold prefill, and with the int8
    pool 1 quant_int8_commit for each call); two warm requests held to
    the margin rule against a float32 CPU teacher-forced run; prints
    the prefix-cache stats, TTFT cold vs warm (graphed prefills and
    tails beside eager ones), ms a tick and tok/s;
15. four requests exported by one batcher and, through
    ``pack_prefilled``/``unpack_prefilled`` bytes, imported by a second
    (bf16 and int8): packed arrays and the pages installed and gathered
    back bit-equal to the export, the import's launches exactly those
    of its ticks (no prefill; merges where a tick's width splits, no
    quantize launch), and its streams identical to the unified
    batcher's; ``preempt_all`` while 8 rows decode, the Suspended items
    resumed on a second batcher, both runs with exact launch counts
    (the first's prefills and ticks, the resume's ticks alone), every
    stream held to the uninterrupted
    run's by the margin rule at its first difference (it prints how
    many are identical) and two teacher-forced; and ``generate`` with a
    256-token window at the flagship's width (batch 4, prompt 512, 64
    new tokens): graphed and eager tokens identical, exactly 8
    flash_fwd launches and no decode kernel (the rolling read is plain
    torch, as in JAX), the tokens teacher-forced against the card's own
    windowed ``forward``;
16. the batcher's schedule modes, each on a fresh warmed batcher with
    exact launch counts (K x n_layers paged launches a K-step block, the
    fused tick's slots n_layers more, merges where a shape splits, an
    int8 pool one commit a step): phase 5's traffic under (a)
    ``multi_step=4``, (b) ``overlap``, (c) ``pipeline_depth=1``, (d) the
    pipeline with ``multi_step=4`` and (e) (a) with int8 weights and
    pool, every stream identical to phase 5's (12's) synchronous run;
    phase 14(b)'s traffic under (h) ``overlap``, (i) ``overlap`` with
    ``multi_step=4``, (j) ``pipeline_depth=1`` and (k) the pipeline with
    ``multi_step=4`` (chunk calls and table changes between a lagged
    block's dispatch and its retire), every stream identical to phase
    14(b)'s phase-split run; no run captures a graph warmup did not;
    phase 14(b)'s and (c)'s traffic with ``fused_prefill`` under (f) the
    default token budget and (g) ``tokens_per_tick`` rows + 8 x 64,
    streams identical to phase 14's phase-split runs or differing first
    at a near-tie by the margin rule (counted), the fused counters
    moving; prints ms a block and a step, blocks, TTFT and the graphs'
    pool beside the synchronous runs', and for (a)-(e) a profile's busy
    share;
17. the fleet replica (``tfmesos_tpu_torch.fleet.replica``) on the
    flagship (rows 8, page 64, bucket 64, ``--warmup``), built in this
    process through ``start_replica`` and driven over TCP with the
    port's ``MuxConnection``: (a) phase 5's 16 requests on 4
    connections, 4 of them streamed — every request completes, each
    stream equal to phase 5's or first differing at a near-tie by the
    margin rule (counted), streamed partials a prefix of the final list
    at contiguous offsets, no graph captured after warmup, exact launch
    counts against the batcher's prefill and tick counters; prints TTFT
    (the replies' ``ttft_ms``), ms a tick, the wall time and the wire's
    share of the streamed requests' client-side TTFT; (b) two replicas:
    8 requests whose rows stay at three pages (so a row's arithmetic
    does not depend on its neighbours) served by A alone, then again
    with ``migrate`` sent to A after its first tick, every suspended
    raw frame resubmitted to B as a raw generate — and once more with
    ``push_to`` B (``kv_stage``, then ``kv_ref``): every resumed stream
    equal to A's own token for token, B running no prefill, exact
    launch counts over both; (c) a prefill-role replica answers phase
    5's requests with raw ``prefilled`` frames (exact counts: 8
    flash_fwd an export) and a decode-role replica imports them (no
    flash_fwd), streams by the margin rule; (d) ``python -m
    tfmesos_tpu_torch.fleet.replica --warmup --rows 8`` as a process:
    its warmed and serving lines, phase 5's 16 requests sent from this
    process (4 streamed and traced) held to phase 5's by the margin
    rule, exit code 0 on SIGTERM. (a) and (d) print the replies' TTFT,
    the streamed requests' client-side TTFT and what it adds: the wait
    for a free row (the trace's spans) and the wire with the handler;
18. the port's front door on the card: (a) ``FleetServer(replicas=2,
    warmup=True)`` (flagship, rows 8, max_len 1024, page 64, bucket 64,
    seed 0) launches two replica processes through the port's
    scheduler, ``LocalBackend`` and ``tfmesos_tpu_torch.server``; phase
    5's 16 requests through ``fleet.client()`` from 4 threads, 4 of
    them streamed with ``on_tokens``: 16 completions held to phase 5's
    by the margin rule, each streamed concatenation equal to its reply,
    the gateway's received == admitted == completed == 16, both
    replicas served (the router's attempt spans in the trace book), and
    each replica process on the card by its own ``stats`` answer (its
    pid one of this process's replica children, its batcher on a CUDA
    device, at least the bf16 weights' bytes allocated there), the
    card's compute apps grown by both replicas' weights; prints
    the fleet's up seconds, the client's TTFT, the replies' ``ttft_ms``,
    requests per replica and the wall time; (b) phase 17 (b)'s 8
    requests streamed through that fleet; once each has its first token
    the replica holding most of them is drained (pinned, as a
    scale-down drains) and ``fleet.request_migration`` asks it to
    suspend them: 8 of 8 complete with streams equal to an undisturbed
    run through the fleet, ``migrations_requested`` >= 1 and at least
    one request moved; (c) ``FleetServer(
    replicas=0, prefill_replicas=1, decode_replicas=1, warmup=True)``
    serves phase 5's 16 requests: the margin rule on every stream,
    ``disagg_requests`` == 16 and ``kv_transfer_bytes`` > 0; prints the
    MB of KV moved and the replies' ``decode_ms``; (d) ``python -m
    tfmesos_tpu_torch.cli serve --replicas 1 --rows 8 --warmup -p 0
    --gateway-host 127.0.0.1`` as a process: its banner, ``cli submit``
    of phase 5's first prompt for 8 tokens (one JSON line, the margin
    rule against phase 5's first 8), ``cli metrics`` exits 0, and on
    SIGINT ``tfserve`` exits 0 with no replica process left.  Each fleet
    is stopped before the next starts.  The replicas are processes of
    their own: (a), (b) and (c) set their launch counts to 0 through
    the ``stats`` op just before the run and read them just after, each
    replica's held to its batcher's prefill and decode counters;
19. the KV tier and sessions on the flagship (rows 8, page 64, bucket
    64, warmed): 8 conversations (seed 19) of 4 turns, turn 0 a prompt
    of 200..400 tokens, each later turn the history plus 40..120 new
    tokens, 32 new tokens a turn; (a) in process, a batcher with a
    ``KVTierStore`` (512 MB of RAM) and ``prefix_cache_pages=64``
    against one without, turn by turn on the same prompts: 32 parks and
    24 resumes, no flash_fwd on a resumed turn (8 paged launches a tail
    and a tick, exact counts a run), no graph captured after warmup,
    every reply identical to the cold batcher's or first differing at a
    near-tie by the margin rule (counted); prints TTFT resumed against
    cold, a park's ms and MB, an install's ms (in the run; and synced,
    beside the export gather) and ms a tick with parks against without;
    (b) phase 14's shared-prompt traffic with a prefix cache of one
    system prompt (8 pages) and a tier: system prompt A, then B (A's
    pages spill), then A again (promoted back): spills and promotions
    counted, every stream equal to a 64-page cache's that keeps both;
    (c) ``FleetServer(replicas=2, kv_tier_mb=24)``, RAM for about two
    parks over the disk directory the fleet shares between them: (a)'s
    prompts through ``FleetClient.generate(session=...)``, 4 threads at
    a time; session affinity on at least 18 of the 24 later turns, each
    replica's resumes read through its ``stats`` op (every later turn
    whose history matches resumes); before the last turn the replica
    holding more sessions is stopped, and the other resumes exactly
    those of its sessions whose directory entry extends into the new
    prompt, with no fabric fetch; replies by the margin rule against
    (a)'s; the directory is gone after ``stop()``; (d)
    ``FleetServer(replicas=2, kv_tier_mb=512, kv_replicas=1,
    kv_replication=2)``: turn 0's parks replicate to the ``--role kv``
    holder, whose ``stats`` shows no torch, no CUDA context and no card
    memory and lists every session; the replica holding more sessions is
    stopped and turn 1 resumes them on the other by ``kv_fetch`` from
    the holder; replies by the margin rule; no process left after
    ``stop()``.
20. speculative decoding, the static prefix and weight swaps on the
    flagship (rows 8, page 64, bucket 64, n_draft 4; the draft
    ``flagship_draft_model`` seed 1, or the target as its own draft):
    phase 5's traffic with (a) the preset draft, (b) the self-draft, (c)
    (b) at multi_step=8 (2 rounds a dispatch), (d) (b) under overlap,
    (e) (b) with an int8 draft pool, each against phase 5's run by the
    margin rule, with exact launch counts (k+1 draft steps of the
    draft's layers and one verify of the target's a round, the draft's
    prompt chunks, merges where a shape splits), no capture after
    warmup, tokens a round, the acceptance rate (above 0.9 for the
    self-draft), ms a dispatch, decode tokens/s and TTFT beside phase
    5's; (f) (b) sampled at T 0.8 / top-k 50 / top-p 0.9 against the
    target-only sampled run (each stream by the sampled margin rule up
    to its first fork, a round's bonus or correction draw); (g) phase
    14's traffic with ``prefix=`` its 512-token system prompt and the
    self-draft, against phase 14 (a)'s prefix-cache run; (h) on a
    warmed batcher, ``set_weights`` to the seed-1 flagship between two
    halves of phase 5's traffic, then a ``swap_adapter`` delta on
    ``embed``: the parameter addresses kept, nothing captured, exact
    launch counts, each post-swap run's streams equal to a fresh
    batcher's on those weights;
    (i) ``speculative_generate`` in bf16 (batch 4, prompt 128, 256 new)
    with the preset draft and the self-draft against ``generate``, exact
    launch counts; (j) a ``--draft`` replica process behind the port's
    registry serving phase 5's traffic over the wire, its launches held
    to its counters and the registry's spec gauge reading its rounds.
    Phase 3 holds the kernels at these shapes: the paged kernel at the
    verify chunk (t = 5) and the draft's t = 1 step and t = 64 chunk
    (KV 4, head_dim 32), the forward kernel at [1, 512, 4, 32], the
    linear-cache kernel at t = 5 and at t = 1 head_dim 32, and the int8
    commit of a [8, 5] chunk into a KV 4 head_dim 32 pool.
21. the fleet's control loops on the card (phase 18's shape: flagship,
    rows 8, max_len 1024, page 64, bucket 64, ``--warmup``, seed 0):
    (a) ``FleetServer(replicas=1, autoscale=True, min_replicas=1,
    max_replicas=2)`` with its loop ticking every 0.25 s: 4 copies of
    phase 5's 16 requests at once measure the queue-wait p99 on one
    replica, which sets the loop's bounds (hi half of it, lo a
    twentieth; the utilization trigger off); the same 64 then stay in
    flight until the one replica the loop launches has registered
    warming, gone alive and prefilled 16 requests, then quiet until the
    loop has drained, migrated and killed back to one replica: exactly
    one up, one launch, one drain and one kill, in that order, no
    request failed or shed; prints the autoscaler gauge tick by tick,
    the seconds from the up tick to the newcomer's first routed request
    and from the quiet to one replica, and the migrations requested and
    resumed; (b) on that fleet, ``FleetClient.rollout("v1")`` while
    phase 5's 16 requests run again and again from a second thread, 4
    at a time: none failed, the roles gauge's versions ``{"v1": 1}``,
    one rollout and none aborted, the registry's generation fence at
    least 1, a hello of the reaped generation dropped and one of the
    new generation kept; prints the rollout's seconds; (c)
    ``FleetServer(models=[chat seed 0 on 1 replica, code seed 7 on 0],
    warm_pool=1, model_budget=2)``: phase 5's traffic labeled ``chat``,
    four requests labeled ``code`` one at a time (the first waits in the
    router while the trader's ``demand`` adopts the pool replica with
    ``set_weights``: one adoption, no launch), an adapter swap on
    ``chat`` through ``FleetClient.swap_adapter`` with phase 20 (h)'s
    delta on ``embed``, and phase 5's traffic labeled ``chat`` again;
    the per-model metering counters present; prints the first code
    request's client TTFT against the warm ones', the adoption's and the
    swap's milliseconds.  Every reply by the margin rule: (a), (b) and
    (c)'s first chat run against phase 5's streams, the code replies
    against an in-process batcher of the seed-7 preset on the card, the
    swapped chat replies against a fresh batcher on the folded weights.
    Never more than two replica processes at a time.  Each replica's
    flash_fwd and paged launches, read through its ``stats`` op from its
    first read (or, for a replica the loop or the rollout launched, from
    a freshly warmed replica's) to its last (taken just before a kill or
    a reap removes it), are held to 8 a prefill, tick, tail and chunk of
    its own counters, and its captured graphs did not grow after warmup.
22. checkpointed, supervised training on the flagship (B 8, T 2048,
    AdamW 3e-4, weights seeded 0, phase 8's stream): (a) 12 steps
    through ``TrainLoop`` with a ``CheckpointManager`` saving every 4
    steps asynchronously, every loss recorded; the ms of a synchronous
    save (the first, with its pinned buffers, and a second), of an
    asynchronous save's return and completion, the checkpoint's MB and
    a restore's ms; (b) ``supervise_training`` over the same build,
    attempt 0 stopped by a ``ClusterError`` at its 7th batch draw: it
    resumes at step 4 (``resumed_steps == [0, 4]``), and its losses of
    steps 1-6 and 5-12 and its final params equal (a)'s bit for bit;
    (c) a token file of 12 batches of the seeded bigram stream: the
    native gather's batches equal numpy's (from step 0 and from step
    8), host ms a batch for each beside phase 8's ``token_batches``;
    then ``transformer_train.main`` with ``--data`` and ``--ckpt-dir``
    for 8 steps, again for 12 (it must print ``resumed from step 8``),
    and a third time (``nothing to do``, no launch); (d) one forward and
    backward of the flagship with ``remat=True`` and one without from
    the same weights and batch: every gradient leaf and the loss
    bit-identical, flash_fwd 16 launches against 8, the backward pair
    8 each, and both runs' peak memory.  (a), (b) and (c) hold rows 1-3
    to exactly 8 launches a step and every other kernel to 0.  It
    writes under a temporary directory and removes it.
23. the reference's own surface on the card, several processes sharing
    it over gloo (two ranks on one card: NCCL refuses that): (a)
    ``python -m tfmesos_tpu_torch.plus`` prints 42, its two Mode-A
    ranks adding CUDA tensors over gloo; (b) ``python -m
    tfmesos_tpu_torch.cli run -w 2 -s 0 --mesh dp=-1 --worker-logs '*'
    -- python -m tfmesos_tpu_torch.transformer_train --steps 4
    --batch_size 8 --seq_len 2048``: both workers' lines arrive
    prefixed, both ranks print the same losses, each step's within 2e-2
    of a single-process run in this process over the same global batch
    (rank 0's stream at seed 100 and rank 1's at 101, concatenated);
    (c) ``cluster(Job(worker, 2), restart_policy="elastic")``
    dispatching ``transformer_train.train_chunk`` with ``run_all``: 4
    chunks of 2 flagship steps (local batch 4 at T 2048), rank 0
    checkpointing after each; rank 1 SIGKILLed after chunk 2 (its pid
    from a reply); the next dispatch raises ``ClusterError``,
    ``wait_ready`` sees generation 1, the chunks resume from the step-4
    checkpoint, and every chunk's losses and the final state EQUAL an
    uninterrupted 4-chunk run's in the re-formed gang, bit for bit; each
    reply's launch delta holds rows 1-3 at 8 a step and every other
    kernel at 0; (d) ``mnist_replica`` under ``tfrun -w 2 -s 1`` (three
    ranks), 50 steps: the output contract, and every rank's validation
    cross entropy equal.  (a), (b) and (d) start together (their
    process starts overlap), with phase 27's two launches, whose
    one-process references this process computes while they run; then
    (c) runs here, beside them (so phase 23's seconds and ms a step are
    taken under phase 27's load).  Prints the bring-up's seconds (to both ranks
    answering, their process group formed), the kill to ``wait_ready``
    and to the new gang answering, ms a step for one rank and for two,
    and the gloo all-reduce of the flagship's gradients a step.
24. the mesh, every rank sharing the card over gloo: (a) each kernel at
    the shapes a rank of tp=2 gives it (flash_fwd [1, 512, 4, 64] and
    [8, 2048, 4, 64], the backward pair at [8, 2048, 4, 64], the paged
    kernel at t = 1 and 4 over a data shard's half pool, KV 4, bf16 and
    int8, flash_decode [4, KV 4, M 16384, 64], the int8 commit into a
    KV-4 pool), against its plain version, timed beside its library
    call and bound; (b) ``tfrun -w 2 --mesh tp=2`` running ``python -m
    tfmesos_tpu_torch.serve --continuous --mesh tp=2`` on phase 5's
    traffic, bf16 and then int8 weights over an int8 pool: every
    stream equal on both ranks (their digests) and held to phase 5's
    (12's) one-process run by the margin rule, each rank's launches
    exact (flash_fwd 8 a prefill it ran, the paged kernel 8 a tick, one
    commit each over an int8 pool), the graphs bypass named ("gloo
    collectives": every call eager) and ms a tick; then, in (d)'s
    Mode-A gang after its training runs, both ranks build the same
    tp=2 batcher with a KV tier (``mesh_kv_rank``) and re-run phase 5's
    first 8 requests with ``preempt_all`` at the first completion,
    re-importing every suspended request (artifacts gathered over tp),
    park a session and resume its next turn beside a cold prefill, fold
    a seeded delta into the embedding and set the weights back: both
    ranks' results equal, the streams by the margin rule against phase
    5's (the resumed turn against the cold one), the fold changing
    request 0's stream, each rank's launches of this part exact (8
    flash_fwd a prefill, 8 paged a tick and a tail); (c) the same
    traffic on ``--mesh dp=2,tp=2`` over four ranks, 4 rows a data
    shard, every shard's sub-pool recycled to its sink at the end; (d) a
    Mode-A gang of two ranks training the flagship at phase 8's shape
    for 4 steps through ``transformer_train``'s setup and loop over
    ``tp=2``, and ``tfrun -w 2 --mesh tp=2`` and ``fsdp=2 -- python -m
    tfmesos_tpu_torch.transformer_train`` (fsdp=2 with ``--grads-out``
    and ``--time-collectives``; (b)'s two launches, (c)'s and (d)'s two
    start together with phase 28's four, twenty-two ranks on the card,
    the gang runs beside them, and each is checked as if alone: their
    ms a tick and a step are taken under each other's load; the
    one-process references are made in this process meanwhile): every
    step's loss within 2e-2 of one process over the global batch (and
    both ranks' equal), every gathered gradient leaf of the
    first step at cosine >= 0.99 with one process's, rows 1-3 at 8 a
    step a rank, under fsdp each rank's memory after the first step
    (params and AdamW state) 0.4-0.6 of one process's, ms a step and
    the share in gloo collectives; (e) the tp=2 state saved (rank 0
    writes the gathered leaves) and restored on one process, every
    param leaf equal to the ranks' gathered state bit for bit.
25. gang replicas, leader and member sharing the card, each on the
    graphed one-device batcher, no collective between them: (a)
    ``FleetServer(gang_size=2, replicas=1, warmup=True)`` at phase 18's
    shape serves phase 5's 16 requests through the gateway, the streams
    by the margin rule against phase 5's, the leader's ``stats``
    showing 16 dispatches, 16 acks and no divergence, the member's
    report line (it has no socket) 16 served; both processes' launches
    exact (8 flash_fwd a prefill, 8 paged a tick); launch to formed,
    client TTFT and ms a tick beside phase 17's one replica; then the
    same over int8 weights and pool (``int8=True``)
    against phase 12's streams, one commit a prefill and a tick; (b)
    the member's process SIGKILLed under traffic: the old leader logs
    its break once and ends, the member is the only death counted, the
    gang re-forms once (a fresh id, the generation bumped,
    ``gang_reforms`` 1); the seconds from
    the kill to the new gang's first routed request and the requests
    that failed in the gap; the re-formed gang serves phase 5's
    traffic as (a); (c) two batchers on the card each park the same
    session, the shards packed into one gang artifact that replicates
    through a KV fabric and comes back from the peer, then unpacked:
    each rank's resumed turn by the margin rule against a cold
    full-history prefill.
26. the fleet's edges over ``tests/torch_fake_mesos.py``'s fake Mesos
    master and agent (offers with a scalar ``gpus``; each TaskInfo's
    command run as a process of this host) named by a fake ZooKeeper:
    (a) ``tfrun -m zk://... -w 2 -s 0 -Gw 1`` runs ``plus`` in two
    tasks, both print 42 on the card, and the seconds from SUBSCRIBE to
    both tasks RUNNING; (b) ``tfserve --master`` with two replicas of
    one card each, two gateway processes, the HTTP edge and the batch
    lane at phase 18's shape, its replicas Mesos tasks on the card
    (each process's ``stats``): phase 5's requests as 8 JSON and 8 SSE
    completions and 16 streamed over the wire, every stream by the
    margin rule against phase 5's, launches exact, the SSE first event
    and the wire client TTFT; (c) ``tfserve batch`` with phase 5's
    prompts three times over while 8 interactive requests arrive: every
    completion by the margin rule, interactive TTFT with the lane busy
    against idle, batch rows preempted and resumed; (d) the gateway
    process holding a client's connection SIGKILLed under traffic:
    16/16 requests complete with every streamed token once, the
    failover gap, and the seconds until its lease expires.
27. MoE, ep and sp (run right after 23, with whose launches its own
    two start, before 23): (a) the flagship with 8 experts, each token to 2, the
    dense top-k form: ``quantize_params`` over its tree in ONE int8
    launch, every leaf bit-exact to the plain version (the experts
    int8, the router fp); then phase 5's 16 requests through a warmed,
    graphed ``ContinuousBatcher`` (rows 8, page 64, bucket 64): no graph
    captured after warmup, exact launches (8 flash_fwd a prefill, 8
    paged a tick), every stream held to the CPU float32 teacher-forced
    argmax wherever the margin exceeds 0.25, ms a tick and TTFT; (b)
    ``tfrun -w 4 --mesh sp=2,ep=2 -- python -m
    tfmesos_tpu_torch.transformer_train --moe 8 --top-k 2`` (switch,
    the ring over sp, experts over ep) at B 8, T 2048 for 4 steps, and
    (c) ``tfrun -w 2 --mesh sp=2 ... --sp-impl ulysses --kv-heads 4``
    (dense): every rank's losses equal, within 2e-2 of one process of
    the same config and seed in this process, (b)'s overflow fraction
    within 1e-2 of it; every rank's launches exact (the ring: flash_fwd
    and the backward pair once a layer a step for each visible shard,
    1 on sp rank 0 and 2 on sp rank 1; Ulysses: once), with each rank's
    peak device memory.

28. pipeline parallelism (started with phase 24's launches; the
    card's memory in use sampled from ``nvidia-smi`` while they run):
    ``tfrun -w 2 --mesh pp=2 -- python -m
    tfmesos_tpu_torch.transformer_train`` at B 8, T 2048 for 4 steps
    with ``--pp-schedule gpipe`` (a), ``1f1b`` (b) and ``circular
    --virtual-stages 2`` (c), and ``tfrun -w 4 --mesh pp=2,ep=2``
    ``--pp-schedule 1f1b --moe 8 --top-k 2`` (d, the dense top-k MoE),
    each with ``--grads-out`` and ``--time-collectives``: every rank's
    losses equal, each step within 2e-2 of one process of the same
    config and seed in this process on the global batch ((d)'s averaged
    over the pipeline's 2 microbatches: the router aux is a microbatch
    estimator under pp), every gathered gradient leaf of the first step
    at cosine >= 0.99 with one process's, (b)'s first-step loss within
    1e-3 of (a)'s and its gradients at cosine >= 0.9999 (the same bf16
    products on another timetable), each rank's launches of rows 1-3
    exact as the timetable gives them (gpipe and circular: a rank's 4
    layers x 2 microbatches a step, each; 1F1B: the forward twice that
    on stage 0, whose chunk is not the last), each rank's memory after
    the first step within 0.05 of its share of the params against one
    process's, ms a step and its share in gloo collectives.

Phases 3 and 4 also hold rows 1-3 at a flagship sp=2 rank's ring steps
(T/sp = 1024 at [8, 1024, 8, 64]): the causal step, the full step
(``causal=False``), a windowed step at q_offset 1024 (window 1536), the
full step's backward with float32 gradients (timed beside SDPA), and a
rank's two steps merged by their logsumexps with each step's backward
run from the global lse, against the plain versions and against
``flash_attention`` over the whole T 2048; and at a flagship pp=2
stage's microbatch [4, 2048, 8, 64] (the forward, and the backward
pair timed beside SDPA).

It prints each phase's seconds.

Every path phase zeroes all launch counts (``attention.LAUNCHES`` and
``quant.LAUNCHES``) just before it runs and reads them just after; the
bf16 paths launch neither quant_int8 entry.

It prints a ``kernels`` JSON line, the card's name and power limit,
then as its last line ``{"ok": true, "device": {...}}``.  Any failure
raises (non-zero exit, no result line); so does a machine without a
card, or a directory without the package.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (dense, full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12          # outside the tensor cores

FLASH_O_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-3
PAGED_ATOL = 2e-2
# Linear-cache decode kernel vs its plain version: bf16 operands and
# float32 accumulation in another order (the kernel rounds p to bf16
# before P.V, the plain version after normalizing); float32 differs in
# summation order and where an int8 scale multiplies.
DECODE_ATOL = 2e-2
DECODE_F32_ATOL = 1e-4
# The same kernel against ``_decode_split_reference`` at its split count:
# that plain version partitions as the kernel does (splits, and each
# warp's 16-key slice of a block), so p rounds to bf16 at the same
# points and what remains is summation order and the output's own
# rounding — 1e-2 of a row's magnitude is ~2.5 bf16 ulps of its largest
# element.
SPLIT_BF16_TOL = 1e-2
SPLIT_F32_TOL = 1e-5
# Teacher-forced check: a generated position counts when the float32
# CPU logits' top-1 beats top-2 by more than this.  bf16 compute on the
# card rounds activations at ~2^-8 relative through 8 layers; the card's
# logits land within ~0.1 of the float32 run's (printed below as
# max |dlogit|), so a 0.25 margin cannot be flipped by rounding alone,
# while a wrong kernel (a logit off by O(1)) still fails.
MARGIN = 0.25
MIN_CHECKED = 10
# Backward kernels vs the plain backward from the same bf16 inputs: a
# gradient of magnitude m rounds to bf16 at ~m * 2^-8 per element, so
# the bound scales with m (2e-2 at m <= 1, the forward's).  float32
# gradients (the FMA kernels) differ only in summation order.
BWD_REL_TOL = 2e-2
BWD_F32_ATOL = 1e-4
# Phases 3-4's ring steps: a flagship sp=2 rank's shard (phase 27 (b))
# and the window of the windowed step.
RING_T = 1024
RING_WINDOW = 1536
# Training: 20 measured steps after 2 warm-up steps; card bf16 vs CPU
# float32 gradients at [1, 1024].
TRAIN_STEPS = 20
TRAIN_DLOSS = 2e-2
TRAIN_MIN_COS = 0.99


class SmokeFailure(RuntimeError):
    pass


# Phase 3's prefill-chunk positions (t = 64 over pages of 64), and the
# prefix-cache tails' (phase 14: the own tokens, padded to the 64-token
# bucket, after the 512 cached system-prompt positions).
CHUNK_POS = (0, 64, 448, 896)
TAIL_POS, TAIL_TS = 512, (64, 128, 192)
# Phase 3's fused chunk-slot counts (phase 16's fused ticks pad their
# slots to 1, 2, 4 or 8 rows).
FUSED_SLOTS = (4, 8)
# Phase 3's session tails (phase 19: a resumed turn's tail starts at
# the parked history's last position, almost never on a page boundary,
# so the self chunk straddles a page): (t, pos).
SESSION_TAILS = ((64, 541), (64, 831), (128, 700))


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 5, n: int = 20) -> float:
    """Median over ``reps`` of the mean device time of ``n`` back-to-back
    calls of ``fn``.  A device-side sleep ahead of each timed run lets
    the host enqueue all ``n`` calls before the device reaches them, so
    the events bracket device work, not host overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    return statistics.median(out)


def host_us(torch, fn, n: int = 200) -> float:
    """Median over 5 runs of the host microseconds one call of ``fn``
    takes to enqueue its work: a device-side sleep ahead of each run
    keeps the device from ever stalling the host.  The decode paths are
    host-bound, so this is their wrappers' cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def row_err(out, ref) -> float:
    """Largest error of any output row (the last dim) over that row's own
    magnitude, the magnitude capped at 1 so the measure is never looser
    than the absolute error.  A decode row over 16k positions averages
    them into values ~100x smaller than a row at position 0, whose bf16
    rounding would otherwise set the whole tensor's maximum."""
    d = out.shape[-1]
    o, r = out.float().reshape(-1, d), ref.float().reshape(-1, d)
    mag = r.abs().amax(-1).clamp(min=1e-12, max=1.0)
    return float(((o - r).abs().amax(-1) / mag).max())


def last_launch(lib: str, symbol: str, n: int):
    """The ``n`` ints a kernel library reports about this thread's last
    launch (its ``tfm_*_last_launch`` entry): what the C side ran, read
    back rather than recomputed from the wrapper's plan."""
    import ctypes

    from tfmesos_tpu_torch.kernels import build

    out = (ctypes.c_int * n)()
    build.kernel(lib, symbol, [ctypes.c_void_p], None)(out)
    return list(out)


FWD_ROUTES = ("fma", "mma.sync", "wgmma")


def fwd_launched(torch, ta, q):
    """(route, query rows per CTA) of the last flash_fwd launch as the C
    entry reports it, required to equal the wrapper's static rule."""
    code, rows = last_launch("flash_fwd", "tfm_flash_fwd_last_launch", 5)[:2]
    b, t, h, d = q.shape
    plan = ta._flash_fwd_route(q.dtype, d, b, t, h, ta._sm_count(q.device))
    got = (FWD_ROUTES[code], rows)
    need(got == plan, f"flash_fwd {tuple(q.shape)} launched {got}, the "
         f"wrapper's rule says {plan}")
    return got


def bwd_tile(route: str, d: int, name: str) -> int:
    """Rows a streamed tile of a flash_bwd kernel holds by its design
    (keys for dq, q rows for dk/dv): 32 where head_dim 128 would not fit
    64 (the FMA kernels' shared tiles, the wgmma dk/dv's registers), else
    64."""
    if d == 128 and (route == "fma" or (route == "wgmma" and name == "dkv")):
        return 32
    return 64


def bwd_launched(ta, q, k):
    """{"dq": (route, q rows per CTA, keys a streamed tile), "dkv": (route,
    keys per CTA, q rows a streamed tile)} of the last two flash_bwd
    launches as the C entry reports them, each required to equal
    ``_flash_bwd_route`` on its own grid and the design's tile."""
    got = last_launch("flash_bwd", "tfm_flash_bwd_last_launch", 12)
    b, tq, h, d = q.shape
    tk, kv = k.shape[1], k.shape[2]
    sms = ta._sm_count(q.device)
    out = {}
    for name, (code, rows, tile), t, heads in (("dq", got[:3], tq, h),
                                               ("dkv", got[6:9], tk, kv)):
        plan = ta._flash_bwd_route(q.dtype, d, b, t, heads, sms)
        plan = (*plan, bwd_tile(plan[0], d, name))
        out[name] = (FWD_ROUTES[code], rows, tile)
        need(out[name] == plan, f"flash_bwd {name} q {tuple(q.shape)} k "
             f"{tuple(k.shape)} launched {out[name]}, the wrapper's rule "
             f"and the kernel's design say {plan}")
    return out


def decode_launched(ta, q, kc):
    """Split count S of the last flash_decode launch as the C entry
    reports it (its grid's z), required to equal ``_decode_plan`` and to
    come with a merge exactly when S > 1."""
    return split_launched(ta, "flash_decode", q, kc.shape[2], kc.shape[3])


def split_launched(ta, lib, q, kv, slots):
    """Split count S of the last launch of decode kernel ``lib`` as its C
    entry reports it (its grid's z), required to equal ``_decode_plan``
    and to come with a merge exactly when S > 1."""
    grid = last_launch(lib, f"tfm_{lib}_last_launch", 4)
    qq = q if q.dim() == 4 else q[:, None]
    plan = ta._decode_plan(qq, kv, slots)
    need(grid[2] == plan and (grid[3] > 0) == (plan > 1),
         f"{lib} {tuple(q.shape)} launched grid {grid[:3]} merge "
         f"{grid[3]}, the wrapper's plan says S {plan}")
    return grid[2]


def bound(bytes_: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zero_launches():
    """Set every kernel's launch count to 0."""
    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.ops import quant as tq

    for counts in (ta.LAUNCHES, tq.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_launches():
    """Every kernel's launch count since the last :func:`zero_launches`."""
    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.ops import quant as tq

    return {**ta.LAUNCHES, **tq.LAUNCHES}


def phase_device(torch):
    need(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    say("[1/28] device")
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from tfmesos_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build(clean=True)
    secs = time.perf_counter() - t0
    say(f"[2/28] build: {len(build.sources())} kernels from a clean build "
        f"directory in {secs:.2f} s")
    for log in sorted(build.build_dir().glob("*.log")):
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                # The mangled name without its namespace prefix: the
                # kernel and its template arguments (ILi64ELi2E: <64, 2>).
                name = re.sub(r"^_ZN\d+_GLOBAL__N__.*?_cu_[0-9a-f]{8}\d+",
                              "", line.split("'")[1])
                say(f"  {log.stem}: {name[:48]}")
            elif ("registers" in line or "spill" in line
                  or "Performance" in line):
                say(f"  {log.stem}: {line.strip()}")
    return secs


def paged_case(torch, gen, label, rows, t, h, kv, ps, np_, d, pos, dtype,
               int8=False, with_self=True, time_it=False, n_layers=8,
               layer=3, linear=False, park_last=False, sink_from=None):
    """One flash_decode_paged case on the card, inputs drawn from ``gen``:
    a stacked pool of ``n_layers`` with a scrambled table (page 0 the
    sink), ``pos`` per row, and (``with_self``) a deferred chunk, which an
    int8 pool takes raw with ``round_self`` as serving passes it.  Checks
    the launch's S and merge against the wrapper's plan; the output within
    PAGED_ATOL (bf16) / 1e-4 (float32) of ``_paged_decode_reference`` and
    per row within 1e-2 / 1e-5 of ``_paged_split_reference`` at that S;
    a second launch bit-identical; an int8 pool's ``round_self`` launch
    bit-identical to the launch with the chunk already rounded.  With
    ``time_it`` it times kernel (merge included), plain version and SDPA
    over the gathered (dequantized) view with the chunk written at its
    positions, and the host cost of a call, beside the bound; with
    ``linear`` also ``flash_decode.cu`` over the same K/V laid out as a
    linear cache, and SDPA over its live prefix.  ``park_last``: the last
    row's table row is all sink, as the batcher parks an idle row;
    ``sink_from``: table columns from this one on are the sink, as past a
    row's last allocated page (a chunk's pad positions land there)."""
    import torch.nn.functional as F

    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.ops import quant as tq

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    n_pages = rows * np_ + 1
    kpool = randn(n_layers, n_pages, kv, ps, d)
    vpool = randn(n_layers, n_pages, kv, ps, d)
    if int8:
        kpool, vpool = _lane_int8(tq, kpool), _lane_int8(tq, vpool)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1    # 0 = sink
    table = perm[:rows * np_].reshape(rows, np_).to(dev, torch.int32)
    if park_last:
        table[-1] = 0
    if sink_from is not None:
        table[:, sink_from:] = 0
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    q = randn(rows, t, h, d)
    chunk = (randn(rows, t, kv, d), randn(rows, t, kv, d)) \
        if with_self else None
    rs = int8 and with_self
    scale = 1.0 / math.sqrt(d)

    def call():
        return ta.flash_decode_paged(q, kpool, vpool, table, posv,
                                     layer=layer, self_kv=chunk,
                                     round_self=rs)

    out = call()
    splits = split_launched(ta, "flash_decode_paged", q, kv, np_ * ps)
    again = call()
    self_ops = ta._self_operands(q, chunk, rs)
    ref = ta._paged_decode_reference(q, kpool, vpool, table, posv, scale,
                                     layer=layer, self_kv=self_ops)
    split_ref = ta._paged_split_reference(q, kpool, vpool, table, posv,
                                          None, splits, layer=layer,
                                          self_kv=chunk, round_self=rs)
    pre = ta.flash_decode_paged(q, kpool, vpool, table, posv, layer=layer,
                                self_kv=self_ops) if rs else out
    torch.cuda.synchronize()
    bf = dtype == torch.bfloat16
    tol = PAGED_ATOL if bf else DECODE_F32_ATOL
    split_tol = SPLIT_BF16_TOL if bf else SPLIT_F32_TOL
    err = float((out.float() - ref.float()).abs().max())
    err_split = row_err(out, split_ref)
    shape = {"layers": n_layers, "rows": rows, "t": t, "h": h, "kv": kv,
             "page": ps, "np": np_, "d": d,
             "dtype": str(dtype).split(".")[-1], "int8": int8,
             "self": with_self}
    need(bool(torch.isfinite(out).all()) and err <= tol
         and err_split <= split_tol,
         f"flash_decode_paged {label} {shape}: err {err} (tol {tol}); per "
         f"row against the S {splits} split reference {err_split} (tol "
         f"{split_tol})")
    need(torch.equal(out, again), f"flash_decode_paged {label}: two "
         f"launches differ")
    need(torch.equal(out, pre), f"flash_decode_paged {label}: round_self "
         f"differs from the pre-rounded chunk")
    row = {"shape": shape, "pos": list(pos), "max_abs_err": err, "tol": tol,
           "split_ref_row_err": err_split, "split_tol": split_tol,
           "splits": splits, "rerun_identical": True,
           "round_self_identical": True if rs else None}
    if not time_it:
        say(f"  flash_decode_paged check {label} [S {splits}]: err "
            f"{err:.2e} (tol {tol}) split_ref_row_err {err_split:.2e} (tol "
            f"{split_tol}), reruns bit-identical"
            + (", round_self bit-identical" if rs else ""))
        return row
    row["ms"] = cuda_ms(torch, call)
    row["host_us"] = host_us(torch, call)
    row["plain_ms"] = cuda_ms(torch, lambda: ta._paged_decode_reference(
        q, kpool, vpool, table, posv, scale, layer=layer,
        self_kv=ta._self_operands(q, chunk, rs)))
    # Yardstick: SDPA over the gathered contiguous view (int8 dequantized,
    # the chunk written at its positions), ragged mask precomputed.
    tl = table.long()
    m = np_ * ps

    def view(pool):
        if int8:
            pool = ta._dequant_lane_major(tq.QTensor(
                pool.values[layer], pool.scales[layer]), dtype)
        else:
            pool = pool[layer]
        return pool[tl].transpose(1, 2).reshape(rows, kv, m, d)

    kview, vview = view(kpool), view(vpool)
    cols = posv.long()[:, None] + torch.arange(t, device=dev)[None]
    if with_self:
        ridx = torch.arange(rows, device=dev)[:, None]
        kview[ridx, :, cols] = self_ops[0]
        vview[ridx, :, cols] = self_ops[1]
    allow = (torch.arange(m, device=dev)[None, None, :]
             <= cols[:, :, None])[:, None]            # [B, 1, t, M]
    qh = q.transpose(1, 2).contiguous()
    gqa = {"enable_gqa": True} if kv != h else {}
    row["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kview, vview, attn_mask=allow, **gqa))
    # Bytes: the live positions' K and V (and int8 scales) — committed
    # positions < pos with a chunk, else <= pos + t - 1 —, the chunk, q
    # and the output, the live table entries and pos.
    live = [p_ if with_self else p_ + t for p_ in pos]
    item = 1 if int8 else torch.finfo(dtype).bits // 8
    qitem = torch.finfo(dtype).bits // 8
    bytes_ = (2 * sum(live) * kv * d * item
              + (8 * sum(live) * kv if int8 else 0)
              + (2 * rows * t * kv * d * qitem if with_self else 0)
              + 2 * rows * t * h * d * qitem
              + 4 * sum(-(-n // ps) for n in live) + 4 * rows)
    keys = sum(p_ + tt + 1 for p_ in pos for tt in range(t))
    row["bound_ms"], row["bound_by"] = bound(bytes_, 4 * keys * h * d)
    extra = ""
    if linear:
        # The same K/V as a linear stacked cache [1, rows, KV, M, D].
        kc, vc = kview[None].contiguous(), vview[None].contiguous()
        row["linear_ms"] = cuda_ms(torch, lambda: ta.flash_decode(
            q, kc, vc, posv, layer=0))
        row["linear_splits"] = decode_launched(ta, q, kc)
        prefix = max(pos) + t
        kl, vl = kview[:, :, :prefix], vview[:, :, :prefix]
        row["linear_library_ms"] = cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(qh, kl, vl, **gqa))
        extra = (f" | flash_decode over the same bytes linear [S "
                 f"{row['linear_splits']}] {row['linear_ms']:.4f}, SDPA "
                 f"over its live prefix {row['linear_library_ms']:.4f}")
    say(f"  flash_decode_paged {label} [S {splits}]: kernel_ms "
        f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
        f"{row['library_ms']:.4f} bound_ms {row['bound_ms']:.5f} "
        f"({row['bound_by']}) err {err:.2e} split_ref_row_err "
        f"{err_split:.2e} host_us {row['host_us']:.1f}{extra}")
    return row


def _flash_case(torch, flash_rows, b, t, window, draw, kv=None, tk=None,
               q_offset=0, h=8, d=64, causal=True, label=None):
    """One flash_fwd case on the card (inputs from ``draw``): the kernel
    against its plain version, timed beside SDPA and the bound; the row
    goes to ``flash_rows``.  ``causal=False`` is a full (unmasked)
    call, as a ring step past the first runs it."""
    import torch.nn.functional as F

    from tfmesos_tpu_torch.ops import attention as ta

    dev = torch.device("cuda")
    kv = h if kv is None else kv
    tk = t if tk is None else tk
    scale = 1.0 / math.sqrt(d)
    q, k, v = draw(b, t, h, d), draw(b, tk, kv, d), draw(b, tk, kv, d)
    o_k, lse_k = ta.flash_forward(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    route, rows = fwd_launched(torch, ta, q)
    o_p, lse_p = ta.flash_attention_reference(
        q, k, v, causal=causal, scale=scale, window=window,
        q_offset=q_offset)
    torch.cuda.synchronize()
    err_o = float((o_k.float() - o_p.float()).abs().max())
    err_l = float((lse_k - lse_p).abs().max())
    need(err_o <= FLASH_O_ATOL and err_l <= FLASH_LSE_ATOL,
         f"flash_fwd [{b},{t},{h},{d}] kv={kv} tk={tk} window={window} "
         f"q_offset={q_offset}: o err {err_o} lse err {err_l}")
    ms = cuda_ms(torch, lambda: ta.flash_forward(
        q, k, v, causal=causal, window=window, q_offset=q_offset))
    enqueue = host_us(torch, lambda: ta.flash_forward(
        q, k, v, causal=causal, window=window, q_offset=q_offset))
    plain = cuda_ms(torch, lambda: ta.flash_attention_reference(
        q, k, v, causal=causal, scale=scale, window=window,
        q_offset=q_offset))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gqa = {"enable_gqa": True} if kv != h else {}
    allow = ~ta._causal_mask(t, tk, q_offset, window, dev)
    if not causal:
        allow = torch.ones_like(allow)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **gqa))
    elif window is None and q_offset == 0 and tk == t:
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa))
    else:
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allow, **gqa))
    pairs = b * int(allow.sum())
    flops = 4 * pairs * h * d
    bytes_ = (2 * b * t * h * d + 2 * b * tk * kv * d) * 2 + b * h * t * 4
    bms, by = bound(bytes_, flops)
    row = {"shape": [b, t, h, d], "kv": kv, "tk": tk, "window": window,
           "q_offset": q_offset, "causal": causal, "route": route,
           "block_rows": rows, **({"case": label} if label else {}),
           "max_abs_err": err_o, "lse_err": err_l, "ms": ms,
           "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
           "bound_by": by, "host_us": enqueue}
    flash_rows.append(row)
    say(f"  flash_fwd {label + ' ' if label else ''}{row['shape']} kv={kv} "
        f"tk={tk} window={window} q_offset={q_offset} causal={causal} "
        f"[{route}, BQ {rows}]: kernel_ms {ms:.4f} "
        f"plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms "
        f"{bms:.5f} ({by}) o_err {err_o:.2e} lse_err {err_l:.2e} "
        f"host_us {enqueue:.1f}")


def phase_kernels(torch):
    import torch.nn.functional as F

    from tfmesos_tpu_torch.ops import attention as ta

    say("[3/28] kernels vs plain versions (bf16, CUDA-event medians)")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    h, d = 8, 64
    scale = 1.0 / math.sqrt(d)
    flash_rows = []

    flash_case = functools.partial(_flash_case, torch, flash_rows)

    for b, t, window in [(1, 64, None), (1, 512, None), (1, 1000, None),
                         (4, 1024, None), (1, 512, 128)]:
        flash_case(b, t, window, randn)

    # The paged kernel at the serving shape: 8 layers, rows 8, KV 8, 16
    # pages of 64, pos 1..1000, the deferred chunk of 1 and 4 tokens.
    paged_rows = []
    for t in (1, 4):
        pos = torch.randint(1, 1001, (8,), generator=gen).clamp(
            max=16 * 64 - t).tolist()
        paged_rows.append(paged_case(torch, gen, f"bf16 t={t}", 8, t, h, 8,
                                     64, 16, d, pos, torch.bfloat16,
                                     time_it=True))
    check_other_paths(torch, ta, gen)
    # The training shape, from a generator of its own: drawing it from
    # the shared one would move the paged-decode inputs above.
    gen_train = torch.Generator().manual_seed(2)
    flash_case(8, 2048, None, lambda *shape: torch.randn(
        shape, generator=gen_train).to(dev, torch.bfloat16))
    # Cases added with the wgmma kernel, from a generator of their own:
    # q_offset with a window over a longer key sequence, a 1000-token
    # batch of 4 (a ragged T at BQ 128), GQA at the training shape.
    gen_new = torch.Generator().manual_seed(6)

    def draw_new(*shape):
        return torch.randn(shape, generator=gen_new).to(dev, torch.bfloat16)

    flash_case(2, 300, 100, draw_new, tk=364, q_offset=64)
    flash_case(4, 1000, None, draw_new)
    flash_case(8, 2048, None, draw_new, kv=2)
    check_forward_routes(torch, ta, draw_new)
    # The flagship draft's prefill (phase 20): 4 heads of head_dim 32,
    # whose bf16 route is mma.sync, from a generator of its own.
    gen_draft = torch.Generator().manual_seed(30)
    flash_case(1, 512, None, lambda *shape: torch.randn(
        shape, generator=gen_draft).to(dev, torch.bfloat16), h=4, d=32)
    # A flagship sp=2 rank's ring steps (phase 27): T/sp = 1024 at
    # [8, 1024, 8, 64], the own shard causal (step 0), a visible shard
    # full (causal=False, step >= 1), and a windowed step (causal at
    # q_offset 1024 over the previous shard), from a generator of their
    # own.
    gen_ring = torch.Generator().manual_seed(27)

    def draw_ring(*shape):
        return torch.randn(shape, generator=gen_ring).to(dev, torch.bfloat16)

    flash_case(8, RING_T, None, draw_ring, label="ring step 0")
    flash_case(8, RING_T, None, draw_ring, causal=False,
               label="ring step 1")
    flash_case(8, RING_T, RING_WINDOW, draw_ring, q_offset=RING_T,
               label="ring windowed step 1")
    # A flagship pp=2 stage's call (phase 28): a microbatch of half the
    # batch, [4, 2048, 8, 64], from a generator of its own.
    gen_pp = torch.Generator().manual_seed(280)
    flash_case(4, 2048, None, lambda *shape: torch.randn(
        shape, generator=gen_pp).to(dev, torch.bfloat16),
        label="pp microbatch")
    return flash_rows, paged_rows


def check_other_paths(torch, ta, gen):
    """Correctness only, off the flagship path: flash_fwd with GQA in
    bf16, and at float32 with the tiny preset's head_dim 8 (FMA route),
    atol 1e-4 — float32 throughout, summed in another order."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
               for s in ((1, 300, 8, 64), (1, 300, 2, 64), (1, 300, 2, 64)))
    o_k, _ = ta.flash_forward(q, k, v, causal=True)
    o_p, _ = ta.flash_attention_reference(q, k, v, causal=True)
    err = float((o_k.float() - o_p.float()).abs().max())
    need(err <= FLASH_O_ATOL, f"flash_fwd GQA bf16: err {err}")
    q, k, v = (torch.randn(s, generator=gen).to(dev)
               for s in ((2, 100, 4, 8), (2, 100, 2, 8), (2, 100, 2, 8)))
    o_k, lse_k = ta.flash_forward(q, k, v, causal=True)
    o_p, lse_p = ta.flash_attention_reference(q, k, v, causal=True)
    err32 = max(float((o_k - o_p).abs().max()),
                float((lse_k - lse_p).abs().max()))
    need(err32 <= 1e-4, f"flash_fwd float32: err {err32}")
    say(f"  other paths: flash_fwd GQA bf16 err {err:.2e}, flash_fwd "
        f"float32 head_dim 8 err {err32:.2e}")


def check_forward_routes(torch, ta, draw):
    """Correctness only (o atol 2e-2, lse atol 1e-3): the wgmma forward at
    head_dim 128 (both query block sizes, GQA, a window) and without the
    causal mask over a longer key sequence; then the mma.sync kernel that
    bf16 head_dim 16 and 32 take — causal with GQA, a window with
    q_offset over more keys than queries, and full attention."""
    out = []
    for b, t, tk, h, kv, d, causal, window, q_offset in [
            (4, 1000, 1000, 8, 8, 128, True, None, 0),
            (1, 300, 300, 4, 2, 128, True, 100, 0),
            (2, 200, 333, 4, 4, 64, False, None, 0),
            (2, 300, 300, 8, 2, 16, True, None, 0),
            (1, 200, 264, 4, 4, 32, True, 50, 64),
            (2, 130, 200, 4, 2, 32, False, None, 0),
            (1, 100, 100, 4, 1, 16, True, 30, 0)]:
        q, k, v = draw(b, t, h, d), draw(b, tk, kv, d), draw(b, tk, kv, d)
        o_k, lse_k = ta.flash_forward(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
        route = fwd_launched(torch, ta, q)
        o_p, lse_p = ta.flash_attention_reference(
            q, k, v, causal=causal, window=window, q_offset=q_offset)
        torch.cuda.synchronize()
        err_o = float((o_k.float() - o_p.float()).abs().max())
        err_l = float((lse_k - lse_p).abs().max())
        need(err_o <= FLASH_O_ATOL and err_l <= FLASH_LSE_ATOL,
             f"flash_fwd check [{b},{t},{h},{d}] kv={kv} tk={tk} "
             f"causal={causal} window={window} q_offset={q_offset} "
             f"{route}: o err {err_o} lse err {err_l}")
        out.append(f"[{b},{t},{h},{d}] kv {kv} tk {tk} causal {causal} "
                   f"window {window} q_offset {q_offset} {route[0]} BQ "
                   f"{route[1]}: o {err_o:.2e} lse {err_l:.2e}")
    say("  flash_fwd checks: " + "; ".join(out))


def _bwd_case(torch, gen, b, t, h, kv, d, window=None, q_offset=0,
              dtype=None, out_dtype=None, time_it=False, tk=None,
              causal=True, dkv_rows=None):
    """One case of the backward pair on the card (inputs from ``gen``):
    each kernel against its plain version, reruns bit-identical, timed
    beside SDPA's backward and the bound with ``time_it``."""
    from tfmesos_tpu_torch.ops import attention as ta

    dev = torch.device("cuda")
    dtype = torch.bfloat16 if dtype is None else dtype
    tk = t if tk is None else tk
    q, k, v, do = (torch.randn(s, generator=gen).to(dev, dtype)
                   for s in ((b, t, h, d), (b, tk, kv, d),
                             (b, tk, kv, d), (b, t, h, d)))
    scale = 1.0 / math.sqrt(d)
    o, lse = ta.flash_forward(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    delta = ta._bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, scale, window, q_offset,
            out_dtype)
    got = (ta.flash_bwd_dq(*args),) + ta.flash_bwd_dkv(*args)
    routes = bwd_launched(ta, q, k)
    # Deterministic: no atomics, so a second launch on the same
    # inputs gives the same bits.
    again = (ta.flash_bwd_dq(*args),) + ta.flash_bwd_dkv(*args)
    # flash_backward (what training calls: delta, then both kernels on
    # operands checked and mapped once) gives the same bits as well.
    whole = ta.flash_backward(q, k, v, o, lse, do, causal=causal,
                              window=window, q_offset=q_offset,
                              out_dtype=out_dtype)
    ref = ((ta._flash_bwd_dq_reference(*args),)
           + ta._flash_bwd_dkv_reference(*args))
    torch.cuda.synchronize()
    row = {"shape": [b, t, h, kv, d], "tk": tk, "causal": causal,
           "window": window, "q_offset": q_offset,
           "dtype": str(dtype).split(".")[-1],
           "out_dtype": str(got[0].dtype).split(".")[-1],
           "dq_route": list(routes["dq"]),
           "dkv_route": list(routes["dkv"])}
    need(dkv_rows is None or routes["dkv"][1] == dkv_rows,
         f"flash_bwd {row}: dk/dv took {routes['dkv'][1]} keys a CTA, "
         f"the case is built for {dkv_rows}")
    need(all(torch.equal(x, y) for x, y in zip(got, again)),
         f"flash_bwd {row}: two launches on the same inputs differ")
    need(all(torch.equal(x, y) for x, y in zip(got, whole)),
         f"flash_bwd {row}: flash_backward differs from the two "
         f"kernels launched alone")
    for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        err = float((g_.float() - r_.float()).abs().max())
        mag = float(r_.float().abs().max())
        tol = (BWD_F32_ATOL if dtype == torch.float32
               else BWD_REL_TOL * max(1.0, mag))
        need(bool(torch.isfinite(g_).all()) and err <= tol,
             f"flash_bwd {name} {row}: err {err} > tol {tol} (max "
             f"|ref| {mag})")
        row[f"{name}_err"], row[f"{name}_tol"] = err, tol
    if not time_it:
        return row
    allow = ~ta._causal_mask(t, tk, q_offset, window, dev)
    if not causal:
        allow = torch.ones_like(allow)
    pairs = b * h * int(allow.sum())            # visible (q, k) pairs
    qbytes, kbytes = b * t * h * d * 2, b * tk * kv * d * 2
    ins = 2 * qbytes + 2 * kbytes + 2 * b * h * t * 4
    row["dq_bound_ms"], row["dq_bound_by"] = bound(ins + qbytes,
                                                   6 * d * pairs)
    row["dkv_bound_ms"], row["dkv_bound_by"] = bound(ins + 2 * kbytes,
                                                     8 * d * pairs)
    big = b * t >= 8192
    reps, n = (3, 5) if big else (5, 20)
    row["dq_ms"] = cuda_ms(torch, lambda: ta.flash_bwd_dq(*args))
    row["dkv_ms"] = cuda_ms(torch, lambda: ta.flash_bwd_dkv(*args))
    # The whole backward as training calls it (delta included), like
    # for like with SDPA's backward below.
    row["backward_ms"] = cuda_ms(torch, lambda: ta.flash_backward(
        q, k, v, o, lse, do, causal=causal, window=window,
        q_offset=q_offset))
    row["dq_plain_ms"] = cuda_ms(
        torch, lambda: ta._flash_bwd_dq_reference(*args), reps, n)
    row["dkv_plain_ms"] = cuda_ms(
        torch, lambda: ta._flash_bwd_dkv_reference(*args), reps, n)
    # Yardstick: SDPA's backward alone (dq, dk and dv in one call).
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2).contiguous()
    row["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    row["pair_over_library"] = ((row["dq_ms"] + row["dkv_ms"])
                                / row["library_ms"])
    say(f"  flash_bwd {row['shape']} [dq {routes['dq'][0]} BQ "
        f"{routes['dq'][1]} BK {routes['dq'][2]}, dkv "
        f"{routes['dkv'][0]} BKV {routes['dkv'][1]} BT "
        f"{routes['dkv'][2]}]: dq kernel_ms {row['dq_ms']:.4f} "
        f"plain_ms {row['dq_plain_ms']:.4f} bound_ms "
        f"{row['dq_bound_ms']:.5f} ({row['dq_bound_by']}); dkv "
        f"kernel_ms {row['dkv_ms']:.4f} plain_ms "
        f"{row['dkv_plain_ms']:.4f} bound_ms {row['dkv_bound_ms']:.5f} "
        f"({row['dkv_bound_by']}); flash_backward (delta included) "
        f"{row['backward_ms']:.4f}; SDPA backward library_ms "
        f"{row['library_ms']:.4f}; (dq + dkv) / library "
        f"{row['pair_over_library']:.2f}; err dq {row['dq_err']:.2e} "
        f"dk {row['dk_err']:.2e} dv {row['dv_err']:.2e}; two launches "
        f"and flash_backward bit-identical")
    return row


def ring_merge_check(torch, gen):
    """A flagship sp=2 rank 1's ring at T/sp = 1024 in one process: the
    kernels' step 0 (its own shard, causal) and step 1 (rank 0's shard,
    full), merged by their logsumexps; then each step's backward pair
    with the GLOBAL merged lse, the merged output and float32 gradients
    (dk/dv of each shard), each against its plain version from the same
    inputs, and the merged output and summed gradients against
    ``flash_attention`` and its backward over the whole T 2048 (the
    queries of the second half)."""
    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.parallel.ring_attention import _merge

    dev = torch.device("cuda")
    b, t, h, d = 8, RING_T, 8, 64
    q, k, v, do = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
                   for s in ((b, 2 * t, h, d),) * 4)
    q1, do1 = q[:, t:].contiguous(), do[:, t:].contiguous()
    halves = [(k[:, :t].contiguous(), v[:, :t].contiguous()),
              (k[:, t:].contiguous(), v[:, t:].contiguous())]
    steps = [(halves[1], True), (halves[0], False)]     # own, then rank 0's
    o, lse = None, None
    for (ks, vs), causal in steps:
        o_i, lse_i = ta.flash_forward(q1, ks, vs, causal=causal)
        o, lse = ((o_i.float(), lse_i) if o is None
                  else _merge(o, lse, o_i.float(), lse_i))
    out = o.to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    delta = ta._bwd_delta(out, do1)
    dq = 0
    dkv = {}
    errs = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for i, ((ks, vs), causal) in enumerate(steps):
        args = (q1, ks, vs, do1, lse, delta, causal, scale, None, 0,
                torch.float32)
        got = (ta.flash_bwd_dq(*args),) + ta.flash_bwd_dkv(*args)
        ref = ((ta._flash_bwd_dq_reference(*args),)
               + ta._flash_bwd_dkv_reference(*args))
        for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
            err = float((g_ - r_).abs().max())
            tol = BWD_REL_TOL * max(1.0, float(r_.abs().max()))
            need(g_.dtype == torch.float32 and err <= tol,
                 f"ring step {i} {name} (global lse, float32): err {err} > "
                 f"{tol}")
            errs[name] = max(errs[name], err)
        dq = dq + got[0]
        dkv[1 - i] = got[1:]                 # step 0 holds shard 1
    qf, kf, vf = (x.detach().requires_grad_() for x in (q, k, v))
    whole = ta.flash_attention(qf, kf, vf, causal=True)
    dwhole = torch.autograd.grad(whole, (qf, kf, vf),
                                 torch.cat([torch.zeros_like(do1), do1], 1))
    torch.cuda.synchronize()
    e_o = float((out.float() - whole[:, t:].float()).abs().max())
    e_dq = float((dq - dwhole[0][:, t:].float()).abs().max())
    dk = torch.cat([dkv[0][0], dkv[1][0]], 1)
    dv = torch.cat([dkv[0][1], dkv[1][1]], 1)
    e_dk = float((dk - dwhole[1].float()).abs().max())
    e_dv = float((dv - dwhole[2].float()).abs().max())
    for name, err, ref in (("o", e_o, whole), ("dq", e_dq, dwhole[0]),
                           ("dk", e_dk, dwhole[1]), ("dv", e_dv, dwhole[2])):
        tol = BWD_REL_TOL * max(1.0, float(ref.float().abs().max()))
        need(err <= tol, f"ring merge {name} vs flash_attention over T "
             f"{2 * t}: err {err} > {tol}")
    row = {"ring": True, "shape": [b, t, h, h, d], "steps": 2,
           "step_errs": errs, "merged_vs_whole": {
               "o": e_o, "dq": e_dq, "dk": e_dk, "dv": e_dv}}
    say(f"  ring merge [8, {t}] x 2 steps (global lse, float32 grads): "
        f"per-step err dq {errs['dq']:.2e} dk {errs['dk']:.2e} dv "
        f"{errs['dv']:.2e} vs plain; merged vs flash_attention over T "
        f"{2 * t}: o {e_o:.2e} dq {e_dq:.2e} dk {e_dk:.2e} dv {e_dv:.2e}")
    return row


def phase_backward(torch):
    from tfmesos_tpu_torch.ops import attention as ta

    say("[4/28] backward kernels vs plain versions (CUDA-event medians)")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)

    case = functools.partial(_bwd_case, torch, gen)

    timed = [case(8, 2048, 8, 8, 64, time_it=True),
             case(1, 512, 8, 8, 64, time_it=True)]
    checks = [case(1, 300, 8, 2, 64),                          # GQA
              case(1, 512, 8, 8, 64, window=128, q_offset=64),
              case(2, 1000, 8, 8, 64, out_dtype=torch.float32),
              case(2, 100, 4, 2, 8, dtype=torch.float32),
              case(1, 200, 4, 2, 16, window=16, q_offset=32,
                   dtype=torch.float32)]
    # Cases added with the wgmma kernels, from a generator of their own:
    # head_dim 128 (ragged T at 128 rows a CTA, GQA with a ragged Tq, a
    # window edge and q_offset mid-tile), the same edges at head_dim 64,
    # GQA with a ragged T, GQA whose dk/dv grid fills the card (128 keys
    # a CTA: the two-warpgroup CTA walks the group's q heads through its
    # ring), full attention over more keys than queries; then bf16
    # head_dim 16 and 32 on mma.sync (causal, GQA, window with q_offset).
    gen = torch.Generator().manual_seed(10)
    for d in (128, 64):
        checks += [case(4, 1000, 8, 8 if d == 128 else 2, d),
                   case(1, 333, 8, 2, d),
                   case(1, 700, 4, 4, d, window=100, q_offset=37, tk=737),
                   case(8, 2048, 8, 2, d, dkv_rows=128)]
    checks.append(case(2, 200, 4, 4, 64, tk=333, causal=False))
    for d in (16, 32):
        checks += [case(2, 300, 8, 8, d), case(1, 300, 8, 2, d),
                   case(1, 200, 4, 4, d, window=50, q_offset=37, tk=237)]
    # A flagship sp=2 rank's ring-step backward (phase 27): the visible
    # shard's full step at [8, 1024, 8, 64] with float32 gradients,
    # timed; then the two halves' merged forward and their backward with
    # the global lse, against flash_attention over the whole T 2048.
    gen = torch.Generator().manual_seed(28)
    timed.append(case(8, RING_T, 8, 8, 64, causal=False,
                      out_dtype=torch.float32, time_it=True))
    timed[-1]["case"] = "ring step 1"
    checks.append(ring_merge_check(torch, gen))
    # A flagship pp=2 stage's backward (phase 28): a microbatch of half
    # the batch, [4, 2048, 8, 64], timed, from a generator of its own.
    timed.append(_bwd_case(torch, torch.Generator().manual_seed(281), 4,
                           2048, 8, 8, 64, time_it=True))
    timed[-1]["case"] = "pp microbatch"
    for r in checks:
        if "ring" in r:
            continue
        say(f"  flash_bwd check {r['shape']} tk={r['tk']} "
            f"causal={r['causal']} window={r['window']} "
            f"q_offset={r['q_offset']} {r['dtype']}->{r['out_dtype']} [dq "
            f"{' '.join(map(str, r['dq_route']))}, dkv "
            f"{' '.join(map(str, r['dkv_route']))}]: err dq "
            f"{r['dq_err']:.2e} dk {r['dk_err']:.2e} dv {r['dv_err']:.2e} "
            f"(tol {r['dq_tol']:.2e}/{r['dk_tol']:.2e}/{r['dv_tol']:.2e}); "
            f"deterministic, flash_backward the same bits")
    return timed, checks


def phase_serve(torch, np):
    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    say("[5/28] serve: flagship, rows 8, page 64, bucket 64, 16 requests")
    cfg, params = flagship_model(seed=0, max_len=1024)
    batcher = ContinuousBatcher(cfg, params, rows=8, page_size=64,
                                prefill_bucket=64, device="cuda")
    warm = warm_batcher(batcher)
    # Warm-up request (cuBLAS handles, allocator pools) outside the
    # measured run.
    list(batcher.run([Request(np.arange(1, 9), 2)]))
    reqs = phase5_requests(np, cfg)
    comps, stats = serve_run(torch, cfg, batcher, reqs, int8=False)
    stats["warmup"] = warm
    say("  graphed: " + json.dumps(stats))
    stats["profile"] = profile_serving(torch, np, batcher, cfg)
    stats["eager"] = serve_eager(torch, np, cfg, batcher, reqs, comps, False)
    ttft_line(stats)
    return cfg, params, reqs, comps, stats


def ttft_line(stats):
    """TTFT of the graphed run (prefills replaying their graphs) beside
    the eager run's (every prefill an eager call)."""
    g, e = stats, stats["eager"]
    say(f"  TTFT ms, prefill graphs vs eager prefills: mean "
        f"{g['ttft_ms_mean']:.3f} vs {e['ttft_ms_mean']:.3f}, p50 "
        f"{g['ttft_ms_p50']:.3f} vs {e['ttft_ms_p50']:.3f}")


def phase5_requests(np, cfg):
    """Phase 5's traffic: 16 seeded requests, prompts of 8..700 tokens,
    32 new tokens each."""
    from tfmesos_tpu_torch.serving import Request

    rng = np.random.RandomState(0)
    lens = rng.randint(8, 701, size=16)
    return [Request(rng.randint(0, cfg.vocab_size, n), 32) for n in lens]


def warm_batcher(batcher):
    """``batcher.warmup()``: prints the names it prepared, its seconds
    and the device memory its graphs' pool reserved."""
    info = batcher.warmup()
    out = {"compiled": info["compiled"], "seconds": info["seconds"],
           "graph_pool_mib": batcher._graphs.pool_bytes / 2 ** 20}
    need(any(n.startswith("decode[") for n in info["compiled"])
         and all(n[:n.index("[")] in ("decode", "prefill")
                 for n in info["compiled"]),
         f"warmup prepared {info['compiled']}")
    say(f"  warmup: {json.dumps(out)}")
    return out


def serve_run(torch, cfg, batcher, reqs, int8: bool):
    """Serve ``reqs`` once through :func:`counted_run` (exact launch
    counts: n_layers flash_fwd a prefill and flash_decode_paged a tick,
    merges where a tick's table width splits the paged kernel, and with
    an int8 pool one quant_int8_commit a prefill and a tick); every
    request prefilled once.  Returns (completions, stats)."""
    comps, launches, wall, _ = counted_run(torch, cfg, batcher, reqs,
                                           int8, "serving")
    n_pre, ticks = batcher.prefills, batcher.decode_ticks
    new = reqs[0].max_new_tokens
    need(len(comps) == len(reqs)
         and all(len(c.tokens) == new for c in comps),
         f"serving: {len(comps)} of {len(reqs)} requests completed their "
         f"{new} tokens")
    need(n_pre == len(reqs) and ticks > 0,
         f"serving: {n_pre} prefills for {len(reqs)} requests, {ticks} "
         f"ticks")
    ttft = sorted(c.ttft_s * 1e3 for c in comps)
    return comps, {
        "requests": len(comps), "wall_s": wall, "prefills": n_pre,
        "decode_ticks": ticks, "decode_tokens": batcher.decode_tokens,
        "decode_tok_per_s": batcher.decode_tokens / batcher.decode_seconds,
        "ms_per_tick": batcher.decode_seconds / ticks * 1e3,
        "ttft_ms_mean": statistics.mean(ttft),
        "ttft_ms_p50": statistics.median(ttft),
        "peak_pages": batcher.peak_pages_used, "n_pages": batcher.n_pages,
        "launches": launches}


def streams(comps):
    """Token streams in admission order."""
    return [c.tokens for c in sorted(comps, key=lambda c: c.rid)]


def serve_eager(torch, np, cfg, batcher, reqs, comps, int8: bool):
    """The same traffic once more with every tick run eagerly (the
    graph helper's diagnostic switch): the streams must be identical to
    the graphed run's and the launch counts exact; then its profile."""
    batcher._graphs.eager = True
    try:
        eager_comps, stats = serve_run(torch, cfg, batcher, reqs, int8)
        need(streams(eager_comps) == streams(comps),
             "serving: the graphed ticks' streams differ from the eager "
             "ticks'")
        say("  eager: " + json.dumps(stats))
        stats["profile"] = profile_serving(torch, np, batcher, cfg)
    finally:
        batcher._graphs.eager = False
    return stats


def profile_serving(torch, np, batcher, cfg):
    """Device busy share of a short serving run (8 requests of 64 prompt
    tokens, 16 new tokens) under torch.profiler, and the top device
    kernels.  The profiler slows the host, so the busy share it reports
    is a lower bound of the unprofiled run's."""
    from tfmesos_tpu_torch.serving import Request

    rng = np.random.RandomState(1)
    reqs = [Request(rng.randint(0, cfg.vocab_size, 64), 16)
            for _ in range(8)]
    out = profile(torch, lambda: list(batcher.run(reqs)))
    say("  profile (8 x 64-token prompts, 16 new tokens): "
        + json.dumps(out))
    return out


# The port's kernel functions (csrc/*.cu), as the profiler names them.
PORT_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_mma_kernel",
                "flash_fwd_fma_kernel", "split_decode_kernel",
                "merge_partials", "paged_split_kernel", "flash_bwd_dq_",
                "flash_bwd_dkv_", "quant_kernel")


def device_ops(torch, fn) -> int:
    """Device operations (kernels, copies, fills) one call of ``fn``
    puts on the card, counted by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def profile(torch, fn):
    """Run ``fn`` once under torch.profiler: wall ms, device ms, the
    device-busy share (device time over wall time), the top six device
    kernels by time, and the device ms and launches of each of the
    port's kernels that ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    port = {}
    for e in kernels:
        for name in PORT_KERNELS:
            if name in e.key:
                ms, n = port.get(name, (0.0, 0))
                port[name] = (ms + e.self_device_time_total / 1e3,
                              n + e.count)
    return {"wall_ms": wall_us / 1e3, "device_ms": dev_us / 1e3,
            "device_busy_share": dev_us / wall_us,
            "top_kernels": [(e.key[:60], e.self_device_time_total / 1e3,
                             e.count) for e in top],
            "port_kernels": port}


def phase_teacher_forced(torch, cfg, params, comps):
    from tfmesos_tpu_torch.models.transformer import forward

    say(f"[6/28] teacher-forced check vs float32 CPU forward "
        f"(margin {MARGIN})")
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    checked = agree_all = 0
    max_dlogit = 0.0
    card_params = _cuda(params)
    for c in sorted(comps, key=lambda c: c.rid)[:2]:
        prompt = [int(x) for x in c.request.prompt]
        seq = torch.tensor([prompt + c.tokens[:-1]])
        idx = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(c.tokens))
        with torch.no_grad():
            ref = forward(cpu_cfg, params, seq)[0, idx]
            card = forward(cfg, card_params, seq.cuda())[0, idx.cuda()]
        card = card.float().cpu()
        max_dlogit = max(max_dlogit, float((card - ref).abs().max()))
        top = ref.topk(2, dim=-1)
        margin = top.values[:, 0] - top.values[:, 1]
        for i, tok in enumerate(c.tokens):
            agree_all += int(int(top.indices[i, 0]) == tok)
            if float(margin[i]) > MARGIN:
                checked += 1
                need(int(top.indices[i, 0]) == tok,
                     f"rid {c.rid} token {i}: card {tok} vs CPU argmax "
                     f"{int(top.indices[i, 0])} at margin "
                     f"{float(margin[i]):.3f}")
    need(checked >= MIN_CHECKED, f"only {checked} positions above the "
         f"margin (need {MIN_CHECKED})")
    say(f"  checked {checked} positions (margin > {MARGIN}); all agree; "
        f"argmax agreement at every position {agree_all}/"
        f"{2 * len(comps[0].tokens)}; card bf16 vs CPU fp32 teacher-forced "
        f"max |dlogit| {max_dlogit:.4f}")
    return {"checked": checked, "agree_all": agree_all,
            "max_dlogit": max_dlogit}


def _cuda(params):
    return {k: (_cuda(v) if isinstance(v, dict) else v.cuda())
            for k, v in params.items()}


def phase_forward(torch):
    from tfmesos_tpu_torch.models.transformer import entry

    fn, (params, tokens) = entry(device="cuda")
    with torch.no_grad():
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        need(tuple(logits.shape) == (4, 1024, 8192),
             f"forward logits {tuple(logits.shape)}")
        need(bool(torch.isfinite(logits).all()), "non-finite logits")
        ms = cuda_ms(torch, lambda: fn(params, tokens), reps=3, n=5)
    say(f"[7/28] forward [4, 1024] on the card: logits finite, "
        f"{ms:.3f} ms per call")
    return ms


def phase_train(torch):
    from tfmesos_tpu_torch import transformer_train as tr
    from tfmesos_tpu_torch.train.data import token_batches

    args = tr.parse_args([])            # the example's defaults
    say(f"[8/28] train: flagship, B {args.batch_size}, T {args.seq_len}, "
        f"AdamW {args.learning_rate} (weight decay 0.01), weights seeded 0")
    run = tr.setup(args, torch.device("cuda"))
    torch.cuda.reset_peak_memory_stats()
    # Two warm-up steps (cuBLAS handles, the allocator's pools) outside
    # the measured run; their losses still count for the loss check.
    warm = tr.train(run, 2, log=None)
    zero_launches()
    out = tr.train(run, TRAIN_STEPS, log=lambda line: say("  " + line))
    launches = read_launches()
    losses = warm["losses"] + out["losses"]
    need(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    need(losses[-1] < losses[0], f"loss did not fall: {losses}")
    L = run.cfg.n_layers
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        need(launches[key] == L * TRAIN_STEPS,
             f"{key} launches {launches[key]} != {L} x {TRAIN_STEPS} steps")
    for key in ("flash_decode_paged", "flash_decode_paged_merge",
                "flash_decode", "flash_decode_merge", "quant_int8",
                "quant_int8_commit"):
        need(launches[key] == 0, f"{key} launched in training")
    # The host cost of the input stream, alone: its Python loop over T.
    stream = token_batches(args.batch_size, run.seq_len, run.cfg.vocab_size,
                           seed=tr.DATA_SEED + 1)
    t0 = time.perf_counter()
    host = [next(stream) for _ in range(3)]
    data_ms = (time.perf_counter() - t0) / 3 * 1e3
    # Steps with the batch already on the card.
    batch = {"tokens": torch.from_numpy(host[0]["tokens"]).cuda()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        run.params, run.opt_state, m = run.step(run.params, run.opt_state,
                                                batch)
    float(m["loss"])
    ready_ms = (time.perf_counter() - t0) / 5 * 1e3
    tokens = args.batch_size * run.seq_len
    stats = {"steps": TRAIN_STEPS, "first_loss": losses[0],
             "last_loss": losses[-1],
             "ms_per_step": out["elapsed_s"] / TRAIN_STEPS * 1e3,
             "tokens_per_s": out["tokens_per_s"],
             "ms_per_step_batch_ready": ready_ms,
             "tokens_per_s_batch_ready": tokens / ready_ms * 1e3,
             "token_batches_ms_per_batch": data_ms,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    say("  " + json.dumps(stats))

    def two_steps():
        for _ in range(2):
            run.params, run.opt_state, _m = run.step(
                run.params, run.opt_state, batch)

    stats["profile"] = profile(torch, two_steps)
    # The profiler slows the host, so its busy share is a lower bound;
    # device time per step over the unprofiled step time estimates the
    # share of a plain step.
    stats["device_busy_share_unprofiled"] = (
        stats["profile"]["device_ms"] / 2 / ready_ms)
    say("  profile (2 steps, batch ready): " + json.dumps(stats["profile"])
        + f"; device ms per step over the unprofiled step: "
        f"{stats['device_busy_share_unprofiled']:.3f}")
    return run.cfg, stats


def phase_train_vs_cpu(torch, cfg):
    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.train.data import token_batches

    say("[9/28] loss_fn + backward at [1, 1024]: card bf16 vs CPU float32")
    master = tt.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(next(token_batches(
        1, 1024, cfg.vocab_size, seed=7))["tokens"])

    def loss_and_grads(cfg_, dev):
        flat = {k: v.detach().to(dev).requires_grad_()
                for k, v in convert.flatten(master).items()}
        loss, _ = tt.loss_fn(cfg_, convert.unflatten(flat),
                             {"tokens": tokens.to(dev)})
        grads = torch.autograd.grad(loss, list(flat.values()))
        return float(loss.detach()), {k: g.double().cpu()
                                      for k, g in zip(flat, grads)}

    card_loss, card = loss_and_grads(cfg, "cuda")
    t0 = time.perf_counter()
    cpu_loss, cpu = loss_and_grads(dataclasses.replace(
        cfg, dtype=torch.float32), "cpu")
    cpu_s = time.perf_counter() - t0
    dloss = abs(card_loss - cpu_loss)
    cos = {k: float(torch.nn.functional.cosine_similarity(
        card[k].reshape(-1), cpu[k].reshape(-1), dim=0)) for k in cpu}
    worst = min(cos, key=cos.get)
    need(dloss <= TRAIN_DLOSS, f"|dloss| {dloss} > {TRAIN_DLOSS} (card "
         f"{card_loss}, cpu {cpu_loss})")
    need(cos[worst] >= TRAIN_MIN_COS, f"gradient cosine of {worst} "
         f"{cos[worst]} < {TRAIN_MIN_COS}")
    out = {"card_loss": card_loss, "cpu_loss": cpu_loss, "dloss": dloss,
           "dloss_limit": TRAIN_DLOSS, "min_cos": cos[worst],
           "min_cos_leaf": worst, "min_cos_limit": TRAIN_MIN_COS,
           "cos": cos, "cpu_s": cpu_s}
    say("  " + json.dumps(out))
    return out


def _lane_int8(tq, cache):
    """An int8 QTensor of a [..., M, D] cache, scales lane-major."""
    vals, scales = tq.quantize_int8_reference(cache)
    return tq.QTensor(vals, scales.squeeze(-1).unsqueeze(-2).contiguous())


def _decode_case(torch, randn, decode_rows, b, t, h, kv, m, d, pos, dtype,
                 int8, time_it):
    """One flash_decode case on the card (inputs from ``randn(shape,
    dtype)``) against its plain and split versions, timed beside SDPA
    and the bound with ``time_it``; the row goes to ``decode_rows``."""
    import torch.nn.functional as F

    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.ops import quant as tq

    dev = torch.device("cuda")
    layer = 1
    q = randn((b, t, h, d), dtype)
    kc, vc = randn((2, b, kv, m, d), dtype), randn((2, b, kv, m, d), dtype)
    if int8:
        kc, vc = _lane_int8(tq, kc), _lane_int8(tq, vc)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = ta.flash_decode(q, kc, vc, posv, layer=layer)
    splits = decode_launched(ta, q, kc.values if int8 else kc)
    ref = ta.flash_decode_reference(q, kc, vc, posv, layer=layer)
    split_ref = ta._decode_split_reference(q, kc, vc, posv, None, splits,
                                           layer=layer)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    err_row = row_err(out, ref)
    err_split = row_err(out, split_ref)
    bf = dtype == torch.bfloat16
    tol = DECODE_ATOL if bf else DECODE_F32_ATOL
    split_tol = SPLIT_BF16_TOL if bf else SPLIT_F32_TOL
    shape = {"b": b, "t": t, "h": h, "kv": kv, "m": m, "d": d,
             "pos": pos, "dtype": str(dtype).split(".")[-1],
             "int8": int8}
    need(bool(torch.isfinite(out).all()) and err <= tol
         and err_row <= tol and err_split <= split_tol,
         f"flash_decode {shape}: err {err}, per row {err_row} (tol "
         f"{tol}); per row against the S {splits} split reference "
         f"{err_split} (tol {split_tol})")
    row = {"shape": shape, "max_abs_err": err, "row_err": err_row,
           "tol": tol, "split_ref_row_err": err_split,
           "split_tol": split_tol, "splits": splits}
    if time_it:
        row["ms"] = cuda_ms(torch, lambda: ta.flash_decode(
            q, kc, vc, posv, layer=layer))
        row["host_us"] = host_us(torch, lambda: ta.flash_decode(
            q, kc, vc, posv, layer=layer))
        row["plain_ms"] = cuda_ms(torch, lambda: ta.flash_decode_reference(
            q, kc, vc, posv, layer=layer))
        # Yardstick: SDPA over the live prefix of the layer's cache
        # (MHA, t = 1, every row at the same position; an int8 cache
        # dequantized first, outside the timing).
        if int8:
            kl, vl = (ta._dequant_lane_major(tq.QTensor(
                c.values[layer], c.scales[layer]), dtype)
                for c in (kc, vc))
        else:
            kl, vl = kc[layer], vc[layer]
        kl, vl = kl[:, :, :pos[0] + 1], vl[:, :, :pos[0] + 1]
        qh = q.transpose(1, 2)
        row["library_ms"] = cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(qh, kl, vl))
        live = sum(p + t for p in pos)       # positions read per head
        item = 1 if int8 else torch.finfo(dtype).bits // 8
        qbytes = b * t * h * d * torch.finfo(dtype).bits // 8
        bytes_ = (2 * live * kv * d * item + (8 * live * kv if int8
                                               else 0)
                  + 2 * qbytes + 4 * b)
        keys = sum(p + tt + 1 for p in pos for tt in range(t))
        row["bound_ms"], row["bound_by"] = bound(bytes_,
                                                 4 * keys * h * d)
        say(f"  flash_decode {shape} [S {splits}]: kernel_ms "
            f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
            f"library_ms {row['library_ms']:.4f} bound_ms "
            f"{row['bound_ms']:.5f} ({row['bound_by']}) err {err:.2e} "
            f"row_err {err_row:.2e} split_ref_row_err {err_split:.2e} "
            f"host_us {row['host_us']:.1f}")
    else:
        say(f"  flash_decode check {shape} [S {splits}]: err {err:.2e} "
            f"row_err {err_row:.2e} (tol {tol}) split_ref_row_err "
            f"{err_split:.2e} (tol {split_tol})")
    decode_rows.append(row)


def phase_decode_kernels(torch):
    """Phase 3, continued: the linear-cache decode kernel, the paged
    kernel's int8 fold and the int8 quantize kernel, each against its
    plain version on the card (inputs from generators of their own, so
    the earlier cases keep their inputs)."""
    import torch.nn.functional as F

    from tfmesos_tpu_torch.kernels import build
    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.ops import quant as tq

    dev = torch.device("cuda")
    rt = build.kernel("flash_decode", "tfm_flash_decode_row_tile", [])()
    need(rt == ta._DECODE_ROW_TILE, f"flash_decode row tile: kernel {rt}, "
         f"wrapper {ta._DECODE_ROW_TILE}")
    gen = torch.Generator().manual_seed(3)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    decode_rows = []

    decode_case = functools.partial(_decode_case, torch, randn,
                                    decode_rows)

    bf16, f32 = torch.bfloat16, torch.float32
    decode_case(4, 1, 8, 8, 16384, 64, [1024] * 4, bf16, False, True)
    decode_case(8, 1, 8, 8, 384, 64, [300] * 8, bf16, True, True)
    decode_case(3, 16, 8, 2, 512, 64, [7, 200, 400], bf16, True, False)
    decode_case(4, 1, 8, 2, 1024, 64, [0, 5, 511, 1000], bf16, False, False)
    decode_case(2, 4, 4, 2, 300, 8, [0, 250], f32, False, False)
    decode_case(2, 40, 4, 1, 300, 8, [3, 250], f32, True, False)
    cold = decode_cold(torch, ta, F)
    # Cases added with the split kernel, from a generator of their own
    # (the draws below keep their inputs): ragged long context, bf16 and
    # int8, and M = 301, whose odd heads' spans are not 16-byte aligned
    # (the producer warp loads them itself).
    main_gen, gen = gen, torch.Generator().manual_seed(7)
    ragged = [0, 1024, 9000, 16383]
    decode_case(4, 1, 8, 8, 16384, 64, ragged, bf16, False, False)
    decode_case(4, 1, 8, 8, 16384, 64, ragged, bf16, True, False)
    decode_case(3, 2, 8, 4, 301, 64, [0, 150, 298], bf16, True, False)
    decode_case(3, 1, 4, 4, 301, 8, [0, 150, 300], bf16, False, False)
    decode_case(2, 3, 8, 2, 700, 128, [0, 600], bf16, True, False)
    # Ragged long context in float32, from a generator of its own: at S 9
    # the pos-16383 row's shares are 29 blocks, so the 4-stage ring wraps
    # seven times under the tight float32 tolerance.
    gen = torch.Generator().manual_seed(8)
    decode_case(4, 1, 8, 8, 16384, 64, ragged, f32, False, False)
    gen = main_gen

    # The paged kernel over an int8 pool at the serving shape, the chunk
    # handed over raw with round_self as serving does.
    paged_rows = []
    for t in (1, 4):
        pos = torch.randint(1, 1001, (8,), generator=gen).clamp(
            max=16 * 64 - t).tolist()
        paged_rows.append(paged_case(torch, gen, f"int8 t={t}", 8, t, 8, 8,
                                     64, 16, 64, pos, bf16, int8=True,
                                     time_it=True))
    # From a generator of its own: phase 11's long-context bytes laid out
    # in pages ([4 rows, KV 8, 256 pages of 64], pos 1024, the pool holding
    # the chunk) beside flash_decode.cu over the same bytes, so the cost
    # of the table shows; then correctness at the edges of the design:
    # pages of 16 (four a block) and 128 (half a block), head_dim 128,
    # float32 at head_dim 8, a GQA chunk of 8 over a parked row, and a
    # 70-token chunk (two self blocks).
    pgen = torch.Generator().manual_seed(10)
    paged_rows.append(paged_case(torch, pgen, "long context", 4, 1, 8, 8, 64,
                                 256, 64, [1024] * 4, bf16, with_self=False,
                                 time_it=True, n_layers=2, layer=1,
                                 linear=True))
    for label, args, kw in [
            ("page 16 GQA", (3, 2, 8, 2, 16, 20, 64, [0, 150, 318], bf16),
             {}),
            ("page 128 int8", (3, 1, 8, 4, 128, 6, 64, [0, 400, 767], bf16),
             {"int8": True}),
            ("page 32 float32, no chunk",
             (3, 2, 8, 2, 32, 10, 64, [0, 100, 318], f32),
             {"with_self": False}),
            ("head_dim 128", (4, 1, 8, 8, 64, 8, 128, [0, 100, 300, 511],
                              bf16), {}),
            ("head_dim 128 int8 GQA t=3",
             (2, 3, 8, 2, 64, 8, 128, [0, 509], bf16), {"int8": True}),
            ("float32 head_dim 8", (2, 1, 4, 4, 64, 2, 8, [70, 5], f32), {}),
            ("float32 head_dim 8 int8", (2, 1, 4, 4, 64, 2, 8, [70, 5], f32),
             {"int8": True}),
            ("GQA t=8 int8, a parked row",
             (3, 8, 8, 2, 64, 8, 64, [200, 504, 0], bf16),
             {"int8": True, "park_last": True}),
            ("float32 t=70 over pages of 16",
             (2, 70, 4, 2, 16, 10, 16, [0, 90], f32), {})]:
        paged_rows.append(paged_case(torch, pgen, label, *args, n_layers=2,
                                     layer=1, **kw))

    # From a generator of its own: the prefill chunk's shape (chunked
    # prefill and prefix-cache tails: 1 row, t = 64, pages of 64, the
    # table width the batcher gives a chunk at each pos), bf16 and int8
    # with round_self, timed; then a chunk whose pad positions run past
    # the row's last allocated column onto the sink.
    from tfmesos_tpu_torch.serving import ContinuousBatcher

    cgen = torch.Generator().manual_seed(14)
    for pos in CHUNK_POS:
        w = ContinuousBatcher.chunk_width(pos, 64, 64, 16)
        for int8 in (False, True):
            paged_rows.append(paged_case(
                torch, cgen, f"chunk t=64 pos {pos}"
                + (" int8" if int8 else ""), 1, 64, 8, 8, 64, w, 64, [pos],
                bf16, int8=int8, time_it=True))
    for int8 in (False, True):
        paged_rows.append(paged_case(
            torch, cgen, "chunk t=64 pos 480, pads past the last page"
            + (" int8" if int8 else ""), 1, 64, 8, 8, 64, 16, 64, [480],
            bf16, int8=int8, sink_from=8))
    # From a generator of its own: each prefix-cache tail width phase 14
    # dispatches (one bf16 row at pos 512, the cache bypassing int8
    # pools), at the table width the batcher gives it.
    tgen = torch.Generator().manual_seed(18)
    for t in TAIL_TS:
        w = ContinuousBatcher.chunk_width(TAIL_POS, t, 64, 16)
        paged_rows.append(paged_case(
            torch, tgen, f"tail t={t} pos {TAIL_POS}", 1, t, 8, 8, 64, w,
            64, [TAIL_POS], bf16, time_it=True))

    # From a generator of its own: phase 19's session tails (one bf16
    # row at an unaligned start, its chunk straddling a page; the tier
    # bypasses int8 pools), at the table width the batcher gives each.
    sgen = torch.Generator().manual_seed(22)
    for t, pos in SESSION_TAILS:
        w = ContinuousBatcher.chunk_width(pos, t, 64, 16)
        paged_rows.append(paged_case(
            torch, sgen, f"session tail t={t} pos {pos}", 1, t, 8, 8, 64,
            w, 64, [pos], bf16, time_it=True))

    # From a generator of its own: the fused tick's chunk slots (phase
    # 16): S rows of t = 64 at positions 0 / 448 / 896 mixed across rows
    # over the np_max-wide (16) tables the slots take, bf16 and int8
    # with round_self, timed.
    fgen = torch.Generator().manual_seed(20)
    for n in FUSED_SLOTS:
        pos = [CHUNK_POS[(0, 2, 3)[i % 3]] for i in range(n)]
        for int8 in (False, True):
            paged_rows.append(paged_case(
                torch, fgen, f"fused slots S={n} t=64"
                + (" int8" if int8 else ""), n, 64, 8, 8, 64, 16, 64, pos,
                bf16, int8=int8, time_it=True))

    # From generators of their own: phase 20's shapes.  The paged kernel
    # at the verify chunk (t = n_draft + 1 = 5, 8 rows at mixed
    # positions, KV 8, head_dim 64, bf16 and int8), at the flagship
    # draft's round step (t = 1, 8 rows, KV 4, head_dim 32) and at its
    # prompt chunk (t = 64, 1 row); the linear-cache kernel at
    # speculative_generate's verify (t = 5, head_dim 64) and draft step
    # (t = 1, KV 4, head_dim 32) over its 393-slot cache (prompt 128,
    # 256 new, 2 x 4 + 1 slack).
    vgen = torch.Generator().manual_seed(32)
    vpos = [3, 90, 200, 333, 512, 640, 800, 1000]
    for int8 in (False, True):
        paged_rows.append(paged_case(
            torch, vgen, "verify t=5" + (" int8" if int8 else ""), 8, 5, 8,
            8, 64, 16, 64, vpos, bf16, int8=int8, time_it=True))
    paged_rows.append(paged_case(torch, vgen, "draft t=1 head_dim 32", 8, 1,
                                 4, 4, 64, 16, 32, vpos, bf16, time_it=True,
                                 n_layers=2, layer=1))
    paged_rows.append(paged_case(torch, vgen, "draft chunk t=64 head_dim 32",
                                 1, 64, 4, 4, 64, 16, 32, [448], bf16,
                                 time_it=True, n_layers=2, layer=1))
    main_gen, gen = gen, torch.Generator().manual_seed(33)
    decode_case(4, 5, 8, 8, 393, 64, [128, 200, 300, 383], bf16, False, True)
    decode_case(4, 1, 4, 4, 393, 32, [128, 200, 300, 388], bf16, False, True)
    gen = main_gen

    quant_rows, total = check_quantize(torch, randn)
    commit_rows = check_commit(torch, randn)
    return decode_rows, cold, paged_rows, quant_rows, total, commit_rows


def check_quantize(torch, randn):
    """Phase 3, the int8 kernel's quantize entry: every flagship weight
    leaf (float32 masters, rows = leading dims flattened) and a cache
    write's K chunk (bf16, one row per (row, token, kv head)), each on
    the vector path of the row plan, round-to-nearest and seeded
    stochastic rounding BIT-exact to the plain versions, the dither
    unbiased; then the nine leaves of ``quantize_params`` in one launch,
    bit-exact both ways, timed against their bytes bound."""
    from tfmesos_tpu_torch.ops import quant as tq

    f32, bf16 = torch.float32, torch.bfloat16
    dev = torch.device("cuda")
    quant_rows = []
    leaves = [("embed", 8192, 512, 1), ("wq|wk|wv|wo", 4096, 512, 4),
              ("w_gate|w_up", 4096, 1408, 2), ("w_down", 11264, 512, 1),
              ("head", 512, 8192, 1)]
    cases = [(n, r, c, k, f32) for n, r, c, k in leaves] + [
        ("cache write, t=1", 64, 64, 0, bf16),
        ("cache write, prefill 128", 8192, 64, 0, bf16)]
    for name, r, c, n_leaves, dtype in cases:
        x = randn((r, c), dtype)
        size = x.element_size()
        plan = tq.row_plan(r, c, size, True)
        need(tq.vector_ok(x.data_ptr(), x.stride()[:1], c, size)
             and (n_leaves == 0 or plan.ctas >= 132),
             f"quant_int8 {name} [{r}, {c}]: not on the vector path or "
             f"under 132 CTAs ({plan})")
        v, s_ = tq.quantize_int8(x)
        rv, rs = tq.quantize_int8_reference(x)
        sv, ss = tq.quantize_int8(x, stochastic=True, seed=11)
        pv, ps_ = tq.quantize_int8_reference(x, stochastic=True, seed=11)
        torch.cuda.synchronize()
        err = max(float((v.float() - rv.float()).abs().max()),
                  float((s_ - rs).abs().max()),
                  float((sv.float() - pv.float()).abs().max()))
        need(torch.equal(v, rv) and torch.equal(s_, rs),
             f"quant_int8 {name} [{r}, {c}]: round-to-nearest not "
             f"bit-exact (err {err})")
        need(torch.equal(sv, pv) and torch.equal(ss, ps_),
             f"quant_int8 {name} [{r}, {c}]: stochastic not bit-exact to "
             f"its plain version")
        # The dither is unbiased: the mean rounding error in steps is ~0
        # (its standard error is ~0.29 / sqrt(n)).
        bias = float(((sv.float() * ss - x.float()) / ss).mean())
        need(abs(bias) < 0.02 and int(sv.min()) >= -127,
             f"quant_int8 {name}: stochastic bias {bias} steps")
        ms = cuda_ms(torch, lambda: tq.quantize_int8(x))
        plain = cuda_ms(torch, lambda: tq.quantize_int8_reference(x))
        n = r * c
        bms, by = bound(n * size + n + 4 * r, 5 * n, F32_FLOPS)
        row = {"shape": [r, c], "leaf": name, "leaves": n_leaves,
               "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
               "stochastic_bias_steps": bias, "ms": ms, "plain_ms": plain,
               "library_ms": None, "bound_ms": bms, "bound_by": by,
               "plan": plan._asdict()}
        quant_rows.append(row)
        say(f"  quant_int8 {name} [{r}, {c}] {row['dtype']}: kernel_ms "
            f"{ms:.4f} plain_ms {plain:.4f} bound_ms {bms:.5f} ({by}) "
            f"bit-exact (RTN and stochastic), bias {bias:+.4f} steps; "
            f"{plan.threads} threads a row, {plan.ctas} CTAs")
    # The kernel divides without a division instruction (quant_int8.cu:
    # quotient), so it is held bit-exact on rows across the float32
    # range: rows with absmax from 2^-140 (subnormal rows) to 2^120,
    # elements reaching 40 binades below their row's top (subnormals),
    # exact ties (absmax 127 2^k, elements (j + 1/2) 2^k), zero rows.
    edge = edge_rows(torch).to(dev)
    for name, vector in (("edge magnitudes", True),
                         ("edge magnitudes, scalar path", False)):
        # The same rows as a view of row stride 257: no 16-byte loads.
        xe = edge if vector else torch.cat([edge, edge[:, :1]], 1)[:, :256]
        v, s_ = tq.quantize_int8(xe)
        sv, ss = tq.quantize_int8(xe, stochastic=True, seed=5)
        rv, rs = tq.quantize_int8_reference(xe)
        pv, ps_ = tq.quantize_int8_reference(xe, stochastic=True, seed=5)
        torch.cuda.synchronize()
        bad = int((v != rv).sum() + (sv != pv).sum())
        need(bad == 0 and torch.equal(s_, rs) and torch.equal(ss, ps_)
             and tq.vector_ok(xe.data_ptr(), xe.stride()[:1],
                              xe.shape[1], 4) is vector,
             f"quant_int8 {name}: {bad} values off the plain version (RTN "
             f"and stochastic), scales equal "
             f"{torch.equal(s_, rs)}/{torch.equal(ss, ps_)}")
        say(f"  quant_int8 {name} {list(xe.shape)}: bit-exact (RTN and "
            f"stochastic)")
    x = torch.full((8, 128), 0.5, device=dev)
    x[:, 0] = 127.0                           # every row's scale is 1
    means = [float(tq.quantize_int8(x, stochastic=True, seed=sd)[0][:, 1:]
                   .float().mean()) for sd in range(8)]
    need(0.3 < statistics.mean(means) < 0.7 and len(set(means)) > 1,
         f"quant_int8: stochastic half-step means {means}")
    # quantize_params' nine leaves in one launch.
    nine = [randn((r, c), f32) for _, r, c, k in leaves for _ in range(k)]
    zero_launches()
    got = tq.quantize_int8_many(nine)
    got_sr = tq.quantize_int8_many(nine, stochastic=True, seed=11)
    launched = read_launches()["quant_int8"]
    for x, (v, s_), (sv, ss) in zip(nine, got, got_sr):
        rv, rs = tq.quantize_int8_reference(x)
        pv, ps_ = tq.quantize_int8_reference(x, stochastic=True, seed=11)
        need(torch.equal(v, rv) and torch.equal(s_, rs)
             and torch.equal(sv, pv) and torch.equal(ss, ps_),
             f"quant_int8, nine leaves in one launch: leaf "
             f"{tuple(x.shape)} not bit-exact to its plain version")
    need(launched == 2, f"quant_int8: the nine leaves took {launched} "
         f"launches for two calls, not 2")
    ms = cuda_ms(torch, lambda: tq.quantize_int8_many(nine))
    plain = cuda_ms(torch, lambda: [tq.quantize_int8_reference(x)
                                    for x in nine])
    bms, by = bound(sum(x.numel() * 5 + 4 * x.shape[0] for x in nine),
                    sum(5 * x.numel() for x in nine), F32_FLOPS)
    total = {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
             "launches": 1,
             "per_leaf_launches_ms": sum(r_["ms"] * r_["leaves"]
                                         for r_ in quant_rows)}
    say(f"  quantize_params (9 leaves, one launch): kernel_ms {ms:.4f} "
        f"plain_ms {plain:.4f} bound_ms {bms:.5f} ({by}), "
        f"{bms / ms:.0%} of the bound; nine launches "
        f"{total['per_leaf_launches_ms']:.4f}; bit-exact (RTN and "
        f"stochastic); half-step stochastic means "
        f"{statistics.mean(means):.3f}")
    return quant_rows, total


def edge_rows(torch):
    """[2048, 256] float32 rows across the float32 range (seeded, on the
    CPU): row i's top at 2^e_i, e_i in [-140, 120], its elements' own
    exponents up to 40 below it (into the subnormals); the first 256
    rows exact ties (column 0 at 127 2^k, the rest (j + 1/2) 2^k, so the
    scale is 2^k); 8 zero rows."""
    g = torch.Generator().manual_seed(21)
    rows, cols = 2048, 256
    top = torch.randint(-140, 121, (rows, 1), generator=g).double()
    below = torch.randint(-40, 1, (rows, cols), generator=g).double()
    mant = torch.rand((rows, cols), generator=g, dtype=torch.float64) * 4 - 2
    x = (mant * torch.pow(2.0, top + below)).float()
    k = torch.randint(-140, 100, (256, 1), generator=g).double()
    steps = torch.randint(-127, 127, (256, cols), generator=g).double() + 0.5
    steps[:, 0] = 127.0
    x[:256] = (steps * torch.pow(2.0, k)).float()
    x[256:264] = 0.0
    return x


def _today_linear(tq, kc, vc, k, v, pos, li):
    """The linear int8 cache write as the tree before the commit entry
    ran it, for timing: for each of K and V, a quantize launch and two
    indexed copies (values, then lane-major scales)."""
    for cache, x in ((kc, k), (vc, v)):
        vals, scale = tq.quantize_int8(x.reshape(-1, x.shape[-1]))
        tq._put_positions(cache.values[li], vals.reshape(x.shape), pos)
        tq._put_positions(cache.scales[li, :, :, 0],
                          scale.reshape(x.shape[:-1]), pos)


def _today_paged(torch, tq, kp, vp, ks, vs, table, pos):
    """The paged int8 commit as the tree before the commit entry ran it,
    for timing: for each of K and V, the stack of the layers' chunks,
    the page-table index math, a quantize launch and two indexed
    writes."""
    for pool, chunks in ((kp, ks), (vp, vs)):
        x = torch.stack(chunks)
        n, b, t, kvh, dh = x.shape
        pages, offs = tq._paged_slots(table, pos, b, t, pool.values.shape[3])
        vals, scale = tq.quantize_int8(
            x.permute(1, 2, 0, 3, 4).reshape(-1, dh))
        pool.values[:, pages, :, offs] = vals.reshape(b * t, n, kvh, dh)
        pool.scales[:, :, :, 0][:, pages, :, offs] = scale.reshape(
            b * t, n, kvh)


def _commit_case(torch, rows, label, kc, vc, ks, vs, pos, today, layer=0,
                 table=None):
    """One int8 commit case on the card: the kernel's cache bit-equal to
    the plain commit (but the sink page), one launch, timed beside the
    plain commit and ``today``'s sequence; the row goes to ``rows``."""
    from tfmesos_tpu_torch.ops import quant as tq

    def clone(q):
        return tq.QTensor(q.values.clone(), q.scales.clone())

    got_k, got_v, ref_k, ref_v = clone(kc), clone(vc), clone(kc), clone(vc)
    zero_launches()
    tq.commit_int8(got_k, got_v, ks, vs, pos, layer=layer,
                   page_table=table)
    launched = read_launches()["quant_int8_commit"]
    tq.commit_int8_reference(ref_k, ref_v, ks, vs, pos, layer=layer,
                             page_table=table)
    torch.cuda.synchronize()
    keep = slice(None) if table is None else slice(1, None)  # no sink
    err = 0.0
    for got, ref in ((got_k, ref_k), (got_v, ref_v)):
        gv, rv = got.values[:, keep], ref.values[:, keep]
        gs, rs = got.scales[:, keep], ref.scales[:, keep]
        err = max(err, float((gv.float() - rv.float()).abs().max()),
                  float((gs - rs).abs().max()))
        need(torch.equal(gv, rv) and torch.equal(gs, rs),
             f"quant_int8 commit {label}: cache not bit-equal to the "
             f"plain commit (err {err})")
    need(launched == 1, f"quant_int8 commit {label}: {launched} "
         f"launches, not 1")
    ms = cuda_ms(torch, lambda: tq.commit_int8(
        got_k, got_v, ks, vs, pos, layer=layer, page_table=table))
    plain = cuda_ms(torch, lambda: tq.commit_int8_reference(
        ref_k, ref_v, ks, vs, pos, layer=layer, page_table=table))
    seq = cuda_ms(torch, lambda: today(ref_k, ref_v))
    ops = device_ops(torch, lambda: tq.commit_int8(
        got_k, got_v, ks, vs, pos, layer=layer, page_table=table))
    seq_ops = device_ops(torch, lambda: today(ref_k, ref_v))
    n = sum(x.numel() for x in list(ks) + list(vs))
    slots = n // ks[0].shape[-1]
    by_table = 0 if table is None else 4 * table.numel()
    bms, by = bound(n * ks[0].element_size() + n + 4 * slots
                    + 8 * pos.numel() + by_table, 5 * n, F32_FLOPS)
    row = {"shape": [len(ks), *ks[0].shape], "leaf": f"commit {label}",
           "leaves": 0, "dtype": str(ks[0].dtype).split(".")[-1],
           "max_abs_err": err, "ms": ms, "plain_ms": plain,
           "today_sequence_ms": seq, "device_ops": ops,
           "today_sequence_device_ops": seq_ops, "library_ms": None,
           "bound_ms": bms, "bound_by": by}
    rows.append(row)
    say(f"  quant_int8 commit {label}: kernel_ms {ms:.4f} ({ops} device "
        f"op) today's sequence {seq:.4f} ({seq_ops} device ops) "
        f"plain_ms {plain:.4f} bound_ms {bms:.6f} ({by}); cache "
        f"bit-equal to the plain commit")


def check_commit(torch, randn):
    """Phase 3, the int8 kernel's commit entry: K and V chunks quantized
    into an int8 cache in one launch, the whole cache bit-equal to the
    plain commit (every page but the sink of a pool, where parked rows
    race as JAX's scatter leaves them): int8 generate's linear cache
    [8, 8, 8, 384, 64] at t = 1 over ragged positions with a clamped
    start and at the prefill t = 128 from 0; int8 serving's pool (rows
    8, KV 8, pages of 64, NP 16) at t = 1 and 4 with two parked rows,
    and one row's t = 64 prefill chunk (page-aligned, and a tail whose
    pad positions land on the sink page); the fused tick's S = 4 and 8
    chunk slots of t = 64 (at S = 8 two dummy slots on the sink page).
    Each timed beside the plain commit and the sequence the tree ran
    before it (timed at one position for every row, as generate passes
    a python int)."""
    from tfmesos_tpu_torch.ops import quant as tq

    dev = torch.device("cuda")
    L, B, KV, D = 8, 8, 8, 64

    def clone(q):
        return tq.QTensor(q.values.clone(), q.scales.clone())

    rows = []

    case = functools.partial(_commit_case, torch, rows)

    # int8 generate: the linear cache of phase 10, layer 3.
    kc = _lane_int8(tq, randn((L, B, KV, 384, D)))
    vc = _lane_int8(tq, randn((L, B, KV, 384, D)))
    for label, t, pos in (
            ("generate t=1, ragged, one start clamped", 1,
             [0, 17, 100, 255, 300, 382, 383, 500]),
            ("generate prefill t=128", 128, [0] * B)):
        k, v = randn((B, t, KV, D)), randn((B, t, KV, D))
        p0 = 300 if t == 1 else 0
        case(label, kc, vc, [k], [v],
             torch.tensor(pos, dtype=torch.int64, device=dev),
             lambda rk, rv, k=k, v=v, p0=p0: _today_linear(tq, rk, rv, k, v,
                                                         p0, 3), layer=3)
    del kc, vc
    # int8 serving: the pool of phase 12 (129 pages of 64, page 0 the
    # sink), rows 6 and 7 parked one block past their all-sink tables.
    kp = _lane_int8(tq, randn((L, 129, KV, 64, D)))
    vp = _lane_int8(tq, randn((L, 129, KV, 64, D)))
    gen = torch.Generator().manual_seed(12)
    table = torch.zeros((B, 16), dtype=torch.int32)
    table[:6] = (torch.randperm(128, generator=gen)[:96] + 1).reshape(6, 16)
    table = table.to(dev)
    for t in (1, 4):
        pos = torch.randint(0, 1024 - t + 1, (B,), generator=gen)
        pos[6:] = 16 * 64
        pos = pos.to(dev)
        ks = [randn((B, t, KV, D)) for _ in range(L)]
        vs = [randn((B, t, KV, D)) for _ in range(L)]
        case(f"serve t={t}, two parked rows", kp, vp, ks, vs, pos,
             lambda rk, rv, ks=ks, vs=vs, pos=pos: _today_paged(
                 torch, tq, rk, rv, ks, vs, table, pos), table=table)
    # int8 chunked serving: one row's t = 64 chunk, page-aligned at pos
    # 896, and a tail at pos 480 whose pad positions past column 7 land
    # on the sink page.
    for pos, sink_from in ((896, None), (480, 8)):
        ctable = table[:1].clone()
        if sink_from is not None:
            ctable[:, sink_from:] = 0
        cpos = torch.tensor([pos], dtype=torch.int64, device=dev)
        ks = [randn((1, 64, KV, D)) for _ in range(L)]
        vs = [randn((1, 64, KV, D)) for _ in range(L)]
        case(f"serve chunk t=64 pos {pos}"
             + (", pads on the sink" if sink_from else ""), kp, vp, ks, vs,
             cpos, lambda rk, rv, ks=ks, vs=vs, cpos=cpos, ct=ctable:
             _today_paged(torch, tq, rk, rv, ks, vs, ct, cpos), table=ctable)
    # int8 fused ticks: S chunk slots of t = 64 committed at once, at
    # positions 0 / 448 / 896 mixed across rows; at S = 8 two dummy slots
    # (rows 6 and 7: all-sink tables) write to the sink page.
    for n in FUSED_SLOTS:
        stable = table[:n].clone()
        spos = torch.tensor([CHUNK_POS[(0, 2, 3)[i % 3]] for i in range(n)],
                            dtype=torch.int64, device=dev)
        ks = [randn((n, 64, KV, D)) for _ in range(L)]
        vs = [randn((n, 64, KV, D)) for _ in range(L)]
        case(f"fused slots S={n} t=64", kp, vp, ks, vs, spos,
             lambda rk, rv, ks=ks, vs=vs, spos=spos, st=stable:
             _today_paged(torch, tq, rk, rv, ks, vs, st, spos), table=stable)
    # Phase 20's int8 draft pool (the flagship draft: 2 layers, KV 4,
    # head_dim 32): a [8, 5] chunk of every layer committed at mixed
    # positions, as the verify-sized chunk lands in a pool of this shape.
    del kp, vp
    dgen = torch.Generator().manual_seed(31)
    dl, dkv, dd = 2, 4, 32
    dkp = _lane_int8(tq, randn((dl, 129, dkv, 64, dd)))
    dvp = _lane_int8(tq, randn((dl, 129, dkv, 64, dd)))
    dpos = torch.randint(0, 1024 - 5 + 1, (B,), generator=dgen).to(dev)
    ks = [randn((B, 5, dkv, dd)) for _ in range(dl)]
    vs = [randn((B, 5, dkv, dd)) for _ in range(dl)]
    case("draft pool [8, 5] KV 4 head_dim 32", dkp, dvp, ks, vs, dpos,
         lambda rk, rv, ks=ks, vs=vs, p=dpos: _today_paged(
             torch, tq, rk, rv, ks, vs, table, p), table=table)
    return rows


def decode_cold(torch, ta, F):
    """flash_decode as generate calls it: bf16 [4, KV 8, M 16384, 64] at
    pos 1024, one launch per layer of an 8-layer stacked cache in turn,
    so the ~67 MB of live K/V (8 layers x 4 rows x 8 heads x 1,025
    positions x 64 x 2 bytes x 2) exceed the 50 MB L2 and every launch
    reads its layer from device memory; SDPA over the live prefix cycled
    the same way.  Warm numbers are phase 3's first decode row."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)
    n_layers, b, kv, m, d, pos = 8, 4, 8, 16384, 64, 1024
    q = torch.randn((b, 1, kv, d), generator=gen).to(dev, torch.bfloat16)
    kc, vc = (torch.randn((n_layers, b, kv, m, d), generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    posv = torch.full((b,), pos, dtype=torch.int32, device=dev)
    turn = [0]

    def next_layer():
        turn[0] = (turn[0] + 1) % n_layers
        return turn[0]

    out = ta.flash_decode(q, kc, vc, posv, layer=5)
    splits = decode_launched(ta, q, kc)
    ref = ta.flash_decode_reference(q, kc, vc, posv, layer=5)
    split_ref = ta._decode_split_reference(q, kc, vc, posv, None, splits,
                                           layer=5)
    err = float((out.float() - ref.float()).abs().max())
    err_row, err_split = row_err(out, ref), row_err(out, split_ref)
    need(err <= DECODE_ATOL and err_row <= DECODE_ATOL
         and err_split <= SPLIT_BF16_TOL,
         f"flash_decode cold case: err {err}, per row {err_row}, per row "
         f"against the split reference {err_split}")
    ms = cuda_ms(torch, lambda: ta.flash_decode(q, kc, vc, posv,
                                                layer=next_layer()), n=32)
    qh = q.transpose(1, 2)
    live = [(kc[i][:, :, :pos + 1], vc[i][:, :, :pos + 1])
            for i in range(n_layers)]
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, *live[next_layer()]), n=32)
    bytes_ = 2 * b * kv * (pos + 1) * d * 2 + 2 * b * kv * d * 2 + 4 * b
    bms, by = bound(bytes_, 4 * b * (pos + 1) * kv * d)
    row = {"shape": {"layers": n_layers, "b": b, "kv": kv, "m": m, "d": d,
                     "pos": pos}, "max_abs_err": err, "row_err": err_row,
           "split_ref_row_err": err_split, "splits": splits, "ms": ms,
           "library_ms": lib, "bound_ms": bms, "bound_by": by}
    say(f"  flash_decode cold L2 (8 layers in turn) [S {splits}]: kernel_ms "
        f"{ms:.4f} library_ms {lib:.4f} bound_ms {bms:.5f} ({by}) err "
        f"{err:.2e} row_err {err_row:.2e} split_ref_row_err "
        f"{err_split:.2e}")
    return row


def _to(params, dev):
    """A params tree on ``dev`` (QTensor leaves keep their dtypes)."""
    from tfmesos_tpu_torch.ops.quant import QTensor

    def leaf(v):
        if isinstance(v, dict):
            return _to(v, dev)
        if isinstance(v, QTensor):
            return QTensor(v.values.to(dev), v.scales.to(dev))
        return v.to(dev)

    return {k: leaf(v) for k, v in params.items()}


def cpu_logits_int8(torch, cfg, qparams, prompt, gen):
    """float32 CPU logits [B, n, V] for each generated token from the
    SAME int8 weights over an int8 linear cache, teacher-forced with the
    card's tokens: the prompt prefilled, then every generated token but
    the last decoded as one chunk (a chunk writes each position's K/V
    before attending, as token-by-token decoding does)."""
    from tfmesos_tpu_torch.models import transformer as tt

    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = _to(qparams, "cpu")
    prompt, gen = prompt.cpu().long(), gen.cpu().long()
    b, p = prompt.shape
    n = gen.shape[1]
    with torch.no_grad():
        cache = tt.init_cache(cpu_cfg, b, p + n, quantized=True)
        first, cache = tt.decode_step(cpu_cfg, cpu_params, cache, prompt, 0)
        ref = first[:, -1:]
        if n > 1:
            rest, _ = tt.decode_step(cpu_cfg, cpu_params, cache,
                                     gen[:, :-1], p)
            ref = torch.cat([ref, rest], dim=1)
    return ref.float()


def teacher_forced_int8(torch, cfg, qparams, prompt, gen):
    """:func:`cpu_logits_int8` against the card's tokens: fails where the
    card's token differs from the CPU argmax at a top-1/top-2 margin
    above MARGIN; returns (positions above the margin, argmax agreement
    at every position, positions)."""
    return margin_check(torch, cpu_logits_int8(torch, cfg, qparams, prompt,
                                                gen), gen.cpu().long(),
                        "teacher-forced")


def margin_check(torch, ref, gen, what):
    """The phase-6 margin rule over scores ``ref`` [..., V] (CPU) and the
    card's tokens ``gen`` [...]: wherever the top-1 beats the top-2 by
    more than MARGIN the token must be the top-1.  Returns (positions
    above the margin, top-1 agreement at every position, positions)."""
    top = ref.topk(2, dim=-1)
    margin = top.values[..., 0] - top.values[..., 1]
    clear = margin > MARGIN
    agree = top.indices[..., 0] == gen
    bad = clear & ~agree
    need(not bool(bad.any()), f"{what}: card token differs from the CPU "
         f"top-1 at {int(bad.sum())} positions above the margin")
    return int(clear.sum()), int(agree.sum()), agree.numel()


def _generate_rate(torch, run, prefill, new_tokens, batch, reps=2):
    """(seconds of a whole run, of its prefill alone, decode tokens/s
    without the prefill, ms per decode step), each the best of ``reps``
    host-clock timings that end in a synchronize."""
    def best(fn):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return min(out)

    whole, pre = best(run), best(prefill)
    decode = whole - pre
    return whole, pre, batch * (new_tokens - 1) / decode, \
        decode / (new_tokens - 1) * 1e3


def decode_splits(cfg, batch, slots):
    """Split count of a generate step's flash_decode launch (t = 1) over a
    cache of ``slots`` positions on this card."""
    from tfmesos_tpu_torch.ops import attention as ta

    tiles = -(-(cfg.n_heads // cfg.kv_heads) // ta._DECODE_ROW_TILE)
    return ta._decode_splits(batch, cfg.kv_heads, tiles, slots,
                             ta._sm_count("cuda"))


def phase_generate_int8(torch):
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_model

    batch, plen, new = 8, 128, 256
    say(f"[10/28] generate: flagship, int8 weights + int8 KV cache, batch "
        f"{batch}, prompt {plen}, {new} new tokens, greedy")
    cfg, params = flagship_model(seed=0, max_len=plen + new, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                           generator=torch.Generator().manual_seed(4)).cuda()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    qparams = tt.quantize_params(cfg, params)
    with torch.no_grad():
        out = tt.generate(cfg, qparams, prompt, new, quantized_cache=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    L = cfg.n_layers
    # The merge kernel runs after every decode launch whose shapes split
    # the cache (static: batch, kv heads, row tiles, cache slots).
    merges = L * (new - 1) if decode_splits(cfg, batch, plen + new) > 1 \
        else 0
    # quantize_params: one launch for the nine leaves; the cache: one
    # commit (K and V) a layer for the prefill and for each step.
    want = {"quant_int8": 1, "quant_int8_commit": L * new, "flash_fwd": L,
            "flash_decode": L * (new - 1), "flash_decode_merge": merges,
            "flash_decode_paged": 0, "flash_decode_paged_merge": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    need(launches == want, f"int8 generate launches {launches} != {want}")
    need(tuple(out.shape) == (batch, plen + new)
         and bool(((out >= 0) & (out < cfg.vocab_size)).all())
         and torch.equal(out[:, :plen], prompt),
         f"int8 generate output {tuple(out.shape)}")

    def run(n=new, eager=False):
        with torch.no_grad():
            return tt.generate(cfg, qparams, prompt, n, quantized_cache=True,
                               _eager=eager)

    rerun_identical = bool(torch.equal(run(), out))
    whole, pre, tok_s, step_ms = _generate_rate(
        torch, run, lambda: run(1), new, batch)
    eager = generate_eager(torch, run, out, dict(want, quant_int8=0), new,
                           batch)
    t0 = time.perf_counter()
    checked, agree, n_pos = teacher_forced_int8(torch, cfg, qparams, prompt,
                                                out[:, plen:])
    cpu_s = time.perf_counter() - t0
    need(checked >= MIN_CHECKED, f"only {checked} positions above the "
         f"margin (need {MIN_CHECKED})")
    stats = {"batch": batch, "prompt": plen, "new_tokens": new,
             "first_run_s": first_s, "run_s": whole, "prefill_s": pre,
             "decode_tok_per_s": tok_s, "ms_per_step": step_ms,
             "launches": launches, "rerun_identical": rerun_identical,
             "teacher_forced_checked": checked, "argmax_agree": agree,
             "positions": n_pos, "cpu_check_s": cpu_s}
    say("  graphed: " + json.dumps(stats))
    stats["profile"] = profile(torch, lambda: run(16))
    say("  profile (16 new tokens): " + json.dumps(stats["profile"]))
    stats["eager"] = eager_profile(torch, eager, lambda: run(16, True))
    return stats


def phase_generate_long(torch):
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_model

    batch, plen, new, max_len = 4, 1024, 64, 16384
    say(f"[11/28] generate: flagship bf16, batch {batch} over a {max_len}-"
        f"slot cache, prompt {plen}, {new} new tokens, greedy")
    cfg, params = flagship_model(seed=0, max_len=max_len, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                           generator=torch.Generator().manual_seed(5)).cuda()
    cache = tt.init_cache(cfg, batch, max_len, device="cuda")
    torch.cuda.synchronize()
    zero_launches()
    with torch.no_grad():
        out = tt.generate(cfg, params, prompt, new, cache=cache)
    torch.cuda.synchronize()
    launches = read_launches()
    L = cfg.n_layers
    merges = L * (new - 1) if decode_splits(cfg, batch, max_len) > 1 else 0
    want = {"quant_int8": 0, "quant_int8_commit": 0, "flash_fwd": L,
            "flash_decode": L * (new - 1),
            "flash_decode_merge": merges, "flash_decode_paged": 0,
            "flash_decode_paged_merge": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    need(launches == want, f"long-context generate launches {launches} != "
         f"{want}")

    def run(n=new, eager=False):
        with torch.no_grad():
            return tt.generate(cfg, params, prompt, n, cache=cache,
                               _eager=eager)

    whole, pre, tok_s, step_ms = _generate_rate(
        torch, run, lambda: run(1), new, batch)
    eager = generate_eager(torch, run, out, want, new, batch)
    # Teacher-forced on the card: the forward kernel over the whole
    # sequence must agree with the decode path's tokens wherever its
    # top-1/top-2 margin is clear.
    with torch.no_grad():
        logits = tt.forward(cfg, params, out[:, :-1].long())[:, plen - 1:]
    top = logits.float().topk(2, dim=-1)
    clear = (top.values[..., 0] - top.values[..., 1]) > MARGIN
    gen = out[:, plen:].long()
    bad = clear & (top.indices[..., 0] != gen)
    need(bool(torch.isfinite(logits).all()) and not bool(bad.any()),
         f"long-context generate: {int(bad.sum())} tokens differ from the "
         f"forward's clear argmax")
    checked = int(clear.sum())
    need(checked >= MIN_CHECKED, f"only {checked} positions above the "
         f"margin (need {MIN_CHECKED})")
    stats = {"batch": batch, "prompt": plen, "new_tokens": new,
             "cache_slots": max_len, "run_s": whole, "prefill_s": pre,
             "decode_tok_per_s": tok_s, "ms_per_step": step_ms,
             "launches": launches, "forward_checked": checked}
    say("  graphed: " + json.dumps(stats))
    stats["profile"] = profile(torch, lambda: run(16))
    say("  profile (16 new tokens): " + json.dumps(stats["profile"]))
    stats["eager"] = eager_profile(torch, eager, lambda: run(16, True))
    return stats


def generate_eager(torch, run, out, want, new, batch):
    """``run(new, eager=True)`` (every step eager, the diagnostic switch)
    with the launch counts zeroed: the tokens must be identical to the
    graphed run's ``out`` and the counts ``want``; then its rate."""
    zero_launches()
    eager_out = run(new, True)
    torch.cuda.synchronize()
    launches = read_launches()
    need(torch.equal(eager_out, out), "generate: the graphed step's tokens "
         "differ from the eager step's")
    need(launches == want, f"eager generate launches {launches} != {want}")
    whole, pre, tok_s, step_ms = _generate_rate(
        torch, lambda: run(new, True), lambda: run(1, True), new, batch)
    return {"run_s": whole, "prefill_s": pre, "decode_tok_per_s": tok_s,
            "ms_per_step": step_ms, "launches": launches,
            "tokens_identical": True}


def eager_profile(torch, stats, fn):
    say("  eager: " + json.dumps(stats))
    stats["profile"] = profile(torch, fn)
    say("  eager profile (16 new tokens): " + json.dumps(stats["profile"]))
    return stats


def phase_serve_int8(torch, np, reqs):
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    say("[12/28] serve int8: phase 5's 16 requests, int8 weights and an "
        "int8 page pool")
    cfg, params = flagship_model(seed=0, max_len=1024, device="cuda")
    qparams = tt.quantize_params(cfg, params)
    batcher = ContinuousBatcher(cfg, qparams, rows=8, page_size=64,
                                prefill_bucket=64, quantized_cache=True,
                                device="cuda")
    warm = warm_batcher(batcher)
    list(batcher.run([Request(np.arange(1, 9), 2)]))          # warm-up
    comps, stats = serve_run(torch, cfg, batcher, reqs, int8=True)
    checked = agree = n_pos = 0
    for c in sorted(comps, key=lambda c: c.rid)[:2]:
        prompt = torch.tensor([[int(x) for x in c.request.prompt]])
        ch, ag, n = teacher_forced_int8(torch, cfg, qparams, prompt,
                                        torch.tensor([c.tokens]))
        checked, agree, n_pos = checked + ch, agree + ag, n_pos + n
    need(checked >= MIN_CHECKED, f"only {checked} positions above the "
         f"margin (need {MIN_CHECKED})")
    stats.update(warmup=warm, teacher_forced_checked=checked,
                 argmax_agree=agree, positions=n_pos)
    say("  graphed: " + json.dumps(stats))
    stats["profile"] = profile_serving(torch, np, batcher, cfg)
    stats["eager"] = serve_eager(torch, np, cfg, batcher, reqs, comps, True)
    ttft_line(stats)
    return stats, comps


# Phase 13's draws: the chi-square check's categories and draws, and
# its floor on the p-value (a right kernel fails it once in 1000 runs).
CHI2_CATEGORIES = 16
CHI2_DRAWS = 200_000
CHI2_MIN_P = 1e-3
GOLDEN = {"fold_in": [2467461003, 3840466878],
          "split": [[1797259609, 2579123966], [928981903, 3453687069]],
          "bits": [4070199207, 4202968722, 1427181096, 2012915765,
                   2447653815],
          "categorical": [1296, 3306]}
SAMPLED_MODES = ({"temperature": 0.8, "top_k": 50},
                 {"temperature": 0.8, "top_p": 0.9})


def check_prng(torch):
    """The threefry golden values (jax 0.9.0's) computed on the card,
    bit-exact, and a chi-square test of ``categorical`` on the card
    against softmax over fixed logits: one key for a [N, C] batch, and a
    key a row (the batcher's draw)."""
    from scipy.stats import chisquare

    from tfmesos_tpu_torch.ops import prng

    key = prng.PRNGKey(0, "cuda")
    got = {"fold_in": prng.fold_in(key, 3).tolist(),
           "split": prng.split(key).tolist(),
           "bits": prng.bits(key, (5,)).tolist(),
           "categorical": prng.categorical(
               key, torch.zeros(2, 8192, device="cuda")).tolist()}
    need(got == GOLDEN, f"threefry on the card: {got} != {GOLDEN}")
    logits = torch.randn(CHI2_CATEGORIES,
                         generator=torch.Generator().manual_seed(13)) * 1.5
    expected = torch.softmax(logits.double(), -1) * CHI2_DRAWS
    batch = logits.cuda().expand(CHI2_DRAWS, CHI2_CATEGORIES).contiguous()
    out = {}
    for name, keys in (
            ("one key", prng.PRNGKey(1, "cuda")),
            ("a key a row", prng.fold_in(prng.PRNGKey(2, "cuda"),
                                         torch.arange(CHI2_DRAWS,
                                                      device="cuda")))):
        draws = prng.categorical(keys, batch)
        counts = torch.bincount(draws, minlength=CHI2_CATEGORIES).cpu()
        p = float(chisquare(counts.double().numpy(),
                            expected.numpy()).pvalue)
        need(p > CHI2_MIN_P, f"categorical on the card ({name}): "
             f"chi-square p {p:.2e} <= {CHI2_MIN_P}")
        out[name] = p
    say(f"  threefry golden values bit-exact on the card; categorical "
        f"chi-square p over {CHI2_DRAWS} draws of {CHI2_CATEGORIES}: "
        f"{json.dumps(out)}")
    return out


def sampled_margin(torch, ref, gen, noise, mode):
    """The phase-6 margin rule on the sampled draw: the scores are the
    float32 CPU logits ``ref`` [n, V] filtered as the card filtered them,
    plus ``noise`` [n, V], the gumbel draws of the card's keys."""
    from tfmesos_tpu_torch.models import transformer as tt

    f = tt.filter_logits(ref, mode["temperature"], mode.get("top_k"),
                         mode.get("top_p"))
    return margin_check(torch, f + noise, gen, "sampled teacher-forced")


def phase_sampled(torch, reqs):
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.ops import prng
    from tfmesos_tpu_torch.serving import ContinuousBatcher

    say("[13/28] sampled serving and generation: phase 5's traffic at "
        "temperature 0.8 with top-k 50 and with top-p 0.9 (bf16 and int8), "
        "int8 generate at temperature 0.8")
    out = {"chi2_p": check_prng(torch)}
    cfg, params = flagship_model(seed=0, max_len=1024, device="cuda")
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = _to(params, "cpu")
    qparams = tt.quantize_params(cfg, params)
    seed = 7
    for name, weights, int8 in (("bf16", params, False),
                                ("int8", qparams, True)):
        for mode in SAMPLED_MODES:
            label = f"serve {name} " + ", ".join(
                f"{k} {v}" for k, v in mode.items())
            runs = {}
            for eager in (False, True):
                b = ContinuousBatcher(cfg, weights, rows=8, page_size=64,
                                      prefill_bucket=64, rid_seed=0,
                                      rng=prng.PRNGKey(seed, "cuda"),
                                      quantized_cache=int8, device="cuda",
                                      **mode)
                b._graphs.eager = eager
                b.warmup()          # eager: the same calls, no capture
                runs[eager] = serve_run(torch, cfg, b, reqs, int8)
            (comps, stats), (eager_comps, eager_stats) = runs[False], \
                runs[True]
            need(streams(comps) == streams(eager_comps),
                 f"{label}: graphed and eager streams differ")
            checked = positions = 0
            for c in sorted(comps, key=lambda c: c.rid)[:2]:
                prompt = [int(x) for x in c.request.prompt]
                gen = torch.tensor(c.tokens)
                if int8:
                    ref = cpu_logits_int8(torch, cfg, qparams,
                                          torch.tensor([prompt]),
                                          gen[None])[0]
                else:
                    seq = torch.tensor([prompt + c.tokens[:-1]])
                    with torch.no_grad():
                        ref = tt.forward(cpu_cfg, cpu_params, seq)[
                            0, len(prompt) - 1:].float()
                keys = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), c.rid),
                                    torch.arange(len(c.tokens)))
                noise = prng.gumbel(keys, (cfg.vocab_size,))
                ch, _, n = sampled_margin(torch, ref, gen, noise, mode)
                checked, positions = checked + ch, positions + n
            need(checked >= MIN_CHECKED, f"{label}: only {checked} "
                 f"positions above the margin (need {MIN_CHECKED})")
            row = {"graphed": stats, "eager": eager_stats,
                   "streams_identical": True, "margin_checked": checked,
                   "positions": positions}
            say(f"  {label}: " + json.dumps(row))
            out[label] = row
    out["generate"] = sampled_generate(torch, cfg, qparams)
    return out


def sampled_generate(torch, cfg, qparams):
    """int8 generate at temperature 0.8 (batch 8, prompt 128, 64 new
    tokens, key PRNGKey(3)): graphed against eager, exact launch counts,
    and the margin rule against the float32 CPU run under the
    reference's key schedule (one split before the first token, one a
    step; one key for the batch's [B, V] draw)."""
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.ops import prng

    batch, plen, new, seed = 8, 128, 64, 3
    mode = {"temperature": 0.8}
    prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                           generator=torch.Generator().manual_seed(6)).cuda()
    cache_len = plen + new

    def run(n=new, eager=False):
        with torch.no_grad():
            return tt.generate(cfg, qparams, prompt, n,
                               rng=prng.PRNGKey(seed, "cuda"),
                               quantized_cache=True, _eager=eager, **mode)

    run(4)
    zero_launches()
    out = run()
    torch.cuda.synchronize()
    launches = read_launches()
    L = cfg.n_layers
    merges = L * (new - 1) if decode_splits(cfg, batch, cache_len) > 1 \
        else 0
    want = {"quant_int8": 0, "quant_int8_commit": L * new, "flash_fwd": L,
            "flash_decode": L * (new - 1), "flash_decode_merge": merges,
            "flash_decode_paged": 0, "flash_decode_paged_merge": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    need(launches == want, f"sampled generate launches {launches} != "
         f"{want}")
    whole, pre, tok_s, step_ms = _generate_rate(
        torch, run, lambda: run(1), new, batch)
    eager = generate_eager(torch, run, out, want, new, batch)
    gen = out[:, plen:].cpu().long()
    ref = cpu_logits_int8(torch, cfg, qparams, prompt, gen)
    rng, noise = prng.PRNGKey(seed), []
    for _ in range(new):
        keys = prng.split(rng)
        rng = keys[0]
        noise.append(prng.gumbel(keys[1], (batch, cfg.vocab_size)))
    checked, _, positions = sampled_margin(
        torch, ref.reshape(-1, cfg.vocab_size), gen.reshape(-1),
        torch.stack(noise, 1).reshape(-1, cfg.vocab_size), mode)
    need(checked >= MIN_CHECKED, f"sampled generate: only {checked} "
         f"positions above the margin (need {MIN_CHECKED})")
    stats = {"batch": batch, "prompt": plen, "new_tokens": new,
             "run_s": whole, "prefill_s": pre, "decode_tok_per_s": tok_s,
             "ms_per_step": step_ms, "launches": launches,
             "margin_checked": checked, "positions": positions,
             "eager": eager}
    say("  generate int8, temperature 0.8: " + json.dumps(stats))
    return stats


# Phase 14's traffic: a 512-token system prompt shared by 16 requests,
# each with 8..188 tokens of its own, 32 new tokens each, greedy.
SYSTEM_LEN = 512


def phase14_requests(np, cfg):
    from tfmesos_tpu_torch.serving import Request

    rng = np.random.RandomState(14)
    system = rng.randint(0, cfg.vocab_size, SYSTEM_LEN)
    lens = rng.randint(8, 189, size=16)
    return [Request(np.concatenate([system, rng.randint(0, cfg.vocab_size,
                                                        n)]), 32)
            for n in lens]


def paged_split(ta, cfg, rows, t, slots):
    """Whether a paged launch of ``rows`` rows of ``t`` query tokens over
    ``slots`` table positions splits (S > 1, so a merge follows)."""
    tiles = -(-t * (cfg.n_heads // cfg.kv_heads) // ta._DECODE_ROW_TILE)
    return ta._decode_splits(rows, cfg.kv_heads, tiles, slots,
                             ta._sm_count("cuda")) > 1


class Counted:
    """Record what ``batcher`` dispatches from here on, its counters
    reset: each decode block's table width, each chunk call's (tokens,
    table width) and each fused tick's slot count.  :meth:`want` is the
    launch counts that must follow — n_layers flash_fwd a full prefill,
    n_layers flash_decode_paged a prefix-cache tail, a prefill chunk
    and a fused tick's chunk slots and K x n_layers a K-step block,
    n_layers merges for each of those calls (each step of a block)
    whose shape splits the kernel, no quantize launch, and over an int8
    pool one quant_int8_commit a call (a step).  Works while another
    thread (a replica's serve loop) runs the batcher."""

    COUNTERS = ("prefills", "tail_prefills", "prefill_chunks",
                "decode_ticks", "decode_tokens", "fused_ticks",
                "fused_chunk_tokens", "fused_decode_tokens")

    def __init__(self, batcher):
        self.b = b = batcher
        self.widths, self.chunks, self.slots = [], [], []
        read, width = b._decode_table, b._chunk_width
        slot_buffers = b._slot_buffers

        def recorded_slots(n):
            self.slots.append(n)
            return slot_buffers(n)

        def recorded(*a):
            table = read(*a)
            self.widths.append(int(table.shape[1]))
            return table

        def chunk_width(pos, t):
            w = width(pos, t)
            self.chunks.append((t, w))
            return w

        b._decode_table, b._chunk_width = recorded, chunk_width
        b._slot_buffers = recorded_slots
        for name in self.COUNTERS:
            setattr(b, name, 0)
        b.decode_seconds = 0.0

    def close(self) -> None:
        del self.b._decode_table, self.b._chunk_width
        del self.b._slot_buffers

    def want(self, cfg, int8: bool, label: str):
        """(expected launches, the chunk calls' shapes)."""
        from tfmesos_tpu_torch.ops import attention as ta

        b = self.b
        L, ps, K = cfg.n_layers, b.page_size, b.multi_step
        pre, tails, nch = b.prefills, b.tail_prefills, b.prefill_chunks
        ticks = b.decode_ticks
        need(len(self.widths) == ticks
             and len(self.chunks) == tails + nch
             and len(self.slots) == b.fused_ticks,
             f"{label}: {len(self.widths)} tick widths for {ticks} ticks, "
             f"{len(self.chunks)} chunk widths for {tails + nch} chunk "
             f"calls, {len(self.slots)} slot counts for {b.fused_ticks} "
             f"fused ticks")
        c, slot_keys = b.prefill_chunk, b.np_max * ps
        merges = L * (K * sum(paged_split(ta, cfg, b.rows, 1, w * ps)
                              for w in self.widths)
                      + sum(paged_split(ta, cfg, 1, t, w * ps)
                            for t, w in self.chunks)
                      + sum(paged_split(ta, cfg, n, c, slot_keys)
                            for n in self.slots))
        calls = K * ticks + tails + nch + len(self.slots)
        want = {"flash_fwd": L * pre, "flash_decode_paged": L * calls,
                "flash_decode_paged_merge": merges, "quant_int8": 0,
                "quant_int8_commit": pre + calls if int8 else 0,
                "flash_decode": 0, "flash_decode_merge": 0,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        return want, sorted(
            {f"t {t} w {w}" for t, w in self.chunks}
            | {f"fused slots {n} x t {c} w {b.np_max}" for n in self.slots})


def counted_run(torch, cfg, batcher, items, int8: bool, label: str,
                drive=None):
    """Run ``items`` through ``batcher`` once (or call ``drive()``, which
    makes another thread run it: a replica's serve loop fed over the
    wire), under :class:`Counted` with every launch count zeroed just
    before and read just after, and require the exact counts.  Returns
    (outputs, launches, wall s, the chunk calls' shapes)."""
    counted = Counted(batcher)
    zero_launches()
    t0 = time.perf_counter()
    try:
        outs = drive() if drive is not None else list(batcher.run(items))
        torch.cuda.synchronize()
    finally:
        counted.close()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want, shapes = counted.want(cfg, int8, label)
    b = batcher
    need(launches == want, f"{label} launches {launches} != {want} "
         f"({b.prefills} prefills, {b.tail_prefills} tails, "
         f"{b.prefill_chunks} chunks, {b.decode_ticks} ticks of K "
         f"{b.multi_step}, fused slot counts {counted.slots})")
    return outs, launches, wall, shapes


def fleet_run(torch, cfg, batcher, reqs, int8: bool, label: str):
    """Serve ``reqs`` once through :func:`counted_run` (exact launch
    counts); every request completes its tokens.  Returns (completions,
    stats: ticks — decode dispatches, K steps each —, ms a tick and a
    step, decode tokens/s, TTFT mean and p50, cold (rid 0) and warm, the
    prefix-cache and fused counters)."""
    comps, launches, wall, shapes = counted_run(torch, cfg, batcher, reqs,
                                                int8, label)
    new = reqs[0].max_new_tokens
    need(len(comps) == len(reqs)
         and all(len(c.tokens) == new for c in comps),
         f"{label}: {len(comps)} of {len(reqs)} requests completed")
    ticks, K = batcher.decode_ticks, batcher.multi_step
    by_rid = sorted(comps, key=lambda c: c.rid)
    ttft = sorted(c.ttft_s * 1e3 for c in comps)
    warm = [c.ttft_s * 1e3 for c in by_rid[1:]]
    return comps, {
        "requests": len(comps), "wall_s": wall, "multi_step": K,
        "prefills": batcher.prefills, "tail_prefills": batcher.tail_prefills,
        "prefill_chunks": batcher.prefill_chunks, "chunk_shapes": shapes,
        "decode_ticks": ticks, "decode_tokens": batcher.decode_tokens,
        "decode_tok_per_s": batcher.decode_tokens / batcher.decode_seconds,
        "ms_per_tick": batcher.decode_seconds / ticks * 1e3,
        "ms_per_step": batcher.decode_seconds / (ticks * K) * 1e3,
        "ttft_ms_mean": statistics.mean(ttft),
        "ttft_ms_p50": statistics.median(ttft),
        "ttft_ms_cold": by_rid[0].ttft_s * 1e3,
        "ttft_ms_warm_mean": statistics.mean(warm),
        "ttft_ms_warm_p50": statistics.median(warm),
        "prefix_cache": batcher.prefix_cache_stats(),
        "fused_ticks": batcher.fused_ticks,
        "fused_chunk_tokens": batcher.fused_chunk_tokens,
        "fused_decode_tokens": batcher.fused_decode_tokens,
        "peak_pages": batcher.peak_pages_used, "launches": launches}


def fp32_margin(torch, cfg, cpu_params, comps, what):
    """The phase-6 margin rule on ``comps`` against the float32 CPU
    forward over each prompt and its tokens, teacher-forced."""
    from tfmesos_tpu_torch.models.transformer import forward

    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    checked = positions = 0
    for c in comps:
        prompt = [int(x) for x in c.request.prompt]
        seq = torch.tensor([prompt + c.tokens[:-1]])
        with torch.no_grad():
            ref = forward(cpu_cfg, cpu_params, seq)[0, len(prompt) - 1:]
        ch, _, n = margin_check(torch, ref.float(), torch.tensor(c.tokens),
                                what)
        checked, positions = checked + ch, positions + n
    need(checked >= MIN_CHECKED, f"{what}: only {checked} positions above "
         f"the margin (need {MIN_CHECKED})")
    return checked, positions


def no_new_graphs(b, warmed, label: str) -> None:
    """Fail if serving on ``b`` captured a graph that its warmup, which
    left ``warmed``, did not."""
    new = b._graphs.keys() - warmed
    need(not new, f"{label}: captured {sorted(map(str, new))} after "
         f"warmup")


def phase_prefix_chunked(torch, np):
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.serving import ContinuousBatcher

    say("[14/28] chunked prefill and the prefix cache: flagship, rows 8, "
        "page 64, bucket 64, 16 requests sharing a 512-token system prompt")
    cfg, params = flagship_model(seed=0, max_len=1024)
    card = _cuda(params)
    qparams = tt.quantize_params(cfg, card)
    reqs = phase14_requests(np, cfg)
    out, bases = {}, {}
    for label, kw, int8 in (
            ("prefix cache", {"prefix_cache_pages": 64}, False),
            ("chunk 64 + prefix cache", {"prefix_cache_pages": 64,
                                         "prefill_chunk": 64}, False),
            ("chunk 64 + prefix cache, int8", {"prefix_cache_pages": 64,
                                               "prefill_chunk": 64}, True)):
        runs = {}
        for eager in (False, True):
            b = ContinuousBatcher(cfg, qparams if int8 else card, rows=8,
                                  page_size=64, prefill_bucket=64,
                                  quantized_cache=int8, device="cuda", **kw)
            b._graphs.eager = eager
            info = b.warmup()
            warmed = b._graphs.keys()
            mode = "eager" if eager else "graphed"
            runs[eager] = fleet_run(torch, cfg, b, reqs, int8,
                                    f"{label} ({mode})")
            no_new_graphs(b, warmed, f"{label} ({mode})")
            runs[eager][1].update(warmup=info["compiled"],
                                  warmup_seconds=info["seconds"],
                                  graph_pool_mib=b._graphs.pool_bytes
                                  / 2 ** 20)
        (comps, stats), (ecomps, estats) = runs[False], runs[True]
        need(streams(comps) == streams(ecomps),
             f"{label}: graphed and eager streams differ")
        need((b.prefix_cache_active, b.prefix_cache_bypass_reason)
             == ((False, "quantized kv cache") if int8 else (True, None)),
             f"{label}: prefix cache {b.prefix_cache_bypass_reason}")
        warm = sorted(comps, key=lambda c: c.rid)[1:3]
        if int8:
            checked = positions = 0
            for c in warm:
                ch, _, n = teacher_forced_int8(
                    torch, cfg, qparams,
                    torch.tensor([[int(x) for x in c.request.prompt]]),
                    torch.tensor([c.tokens]))
                checked, positions = checked + ch, positions + n
            need(checked >= MIN_CHECKED, f"{label}: only {checked} "
                 f"positions above the margin")
        else:
            checked, positions = fp32_margin(torch, cfg, params, warm, label)
        row = {"graphed": stats, "eager": estats, "streams_identical": True,
               "margin_checked": checked, "positions": positions}
        say(f"  {label}: " + json.dumps(row))
        say(f"  {label}: TTFT ms, graphed prefills and tails vs eager: "
            f"cold {stats['ttft_ms_cold']:.3f} vs "
            f"{estats['ttft_ms_cold']:.3f}, warm mean "
            f"{stats['ttft_ms_warm_mean']:.3f} vs "
            f"{estats['ttft_ms_warm_mean']:.3f}, warm p50 "
            f"{stats['ttft_ms_warm_p50']:.3f} vs "
            f"{estats['ttft_ms_warm_p50']:.3f}; warmup "
            f"{stats['warmup_seconds']:.3f} s, {len(stats['warmup'])} "
            f"names, graph pool {stats['graph_pool_mib']:.1f} MiB")
        out[label] = row
        bases[label] = comps
    return out, bases


def _host_tensor(a):
    """An artifact array (numpy, or a bf16 CPU tensor) as a tensor."""
    import numpy as np
    import torch

    return torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) \
        else a


def phase_disagg_preempt_rolling(torch, np):
    from tfmesos_tpu_torch import serving as ts
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_model

    say("[15/28] export/import, preemption and rolling caches: flagship")
    cfg, params = flagship_model(seed=0, max_len=1024)
    card = _cuda(params)
    qparams = tt.quantize_params(cfg, card)
    kw = dict(rows=8, page_size=64, prefill_bucket=64, device="cuda")
    rng = np.random.RandomState(15)
    out = {}
    # Four requests exported by one batcher, their artifacts through
    # pack_prefilled bytes, imported by a second; the unified batcher
    # serves the same four.
    reqs = [ts.Request(rng.randint(0, cfg.vocab_size, n), 32)
            for n in (100, 250, 400, 600)]
    for name, weights, int8 in (("bf16", card, False),
                                ("int8", qparams, True)):
        exp = ts.ContinuousBatcher(cfg, weights, quantized_cache=int8, **kw)
        arts, nbytes = [], 0
        for r in reqs:
            art = exp.export_kv(r)
            meta, body = ts.pack_prefilled(art)
            nbytes += len(body)
            back = ts.unpack_prefilled(json.loads(json.dumps(meta)),
                                       bytes(body))
            for key in ("k", "v", "k_scales", "v_scales"):
                if key in art:
                    a, b = _host_tensor(art[key]), _host_tensor(back[key])
                    need(a.dtype == b.dtype and torch.equal(a, b),
                         f"export {name}: {key} changed in packing")
            arts.append(back)
        # The installed pages, gathered back, equal the artifact's bits.
        chk = ts.ContinuousBatcher(cfg, weights, quantized_cache=int8, **kw)
        for r, art in zip(reqs, arts):
            active = {}
            wt, wd, need_len = chk._worst_pages(r)
            row, state, first = chk._admit_import(
                0, ts.Prefilled(r, art), wt, wd, need_len, active)
            state.out = [first]
            again = chk._export_row(row, state)
            chk._finish(row, active, [])
            for key in ("k", "v", "k_scales", "v_scales"):
                if key in art:
                    need(torch.equal(_host_tensor(art[key]),
                                     _host_tensor(again[key])),
                         f"import {name}: {key} pages not bit-equal after "
                         f"the round trip")
        imp = ts.ContinuousBatcher(cfg, weights, quantized_cache=int8, **kw)
        imp.warmup(prefill=False)
        comps, launches, _, _ = counted_run(
            torch, cfg, imp, [ts.Prefilled(r, a) for r, a in zip(reqs, arts)],
            int8, f"import {name}")
        need((imp.prefills, imp.tail_prefills, imp.prefill_chunks)
             == (0, 0, 0), f"import {name}: an import prefilled")
        uni = ts.ContinuousBatcher(cfg, weights, quantized_cache=int8, **kw)
        want = list(uni.run(reqs))
        need(streams(comps) == streams(want), f"import {name}: streams "
             f"differ from the unified batcher's")
        out[f"import {name}"] = {
            "requests": len(reqs), "artifact_bytes": nbytes,
            "ticks": imp.decode_ticks, "launches": launches,
            "streams_identical": True, "pages_bit_equal": True}
        say(f"  export/import {name}: " + json.dumps(out[f"import {name}"]))
    out["preempt"] = preempt_resume(torch, np, cfg, params, card, kw)
    out["rolling"] = windowed_generate(torch, cfg, card)
    return out


def preempt_resume(torch, np, cfg, params, card, kw):
    """``preempt_all`` while 8 rows decode (48 new tokens each; fired
    once request 0 has streamed 16), the Suspended items resumed on a
    second batcher: every request completes, each stream held to the
    uninterrupted run's by the margin rule at its first difference (the
    resumed row's table width, and with it the kernel's split count and
    merge order, may differ), and two resumed streams teacher-forced."""
    from tfmesos_tpu_torch import serving as ts
    from tfmesos_tpu_torch.models.transformer import forward

    rng = np.random.RandomState(16)
    mk = [(rng.randint(0, cfg.vocab_size, n), 48)
          for n in rng.randint(64, 301, size=8)]
    ref = {c.rid: c.tokens for c in ts.ContinuousBatcher(
        cfg, card, **kw).run(ts.Request(p, n) for p, n in mk)}
    b1 = ts.ContinuousBatcher(cfg, card, **kw)
    reqs = [ts.Request(p, n) for p, n in mk]

    def trigger(chunk, off):
        if off + len(chunk) >= 16:
            reqs[0].on_tokens = None
            b1.preempt_all()

    reqs[0].on_tokens = trigger
    first, launches1, _, _ = counted_run(torch, cfg, b1, reqs, False,
                                         "preempt_all")
    susp = [x for x in first if isinstance(x, ts.Suspended)]
    done = {c.rid: c.tokens for c in first if isinstance(c, ts.Completion)}
    need(susp and all(s.artifact is not None for s in susp),
         f"preempt_all: {len(susp)} suspended, artifacts "
         f"{[s.artifact is not None for s in susp]}")
    b2 = ts.ContinuousBatcher(cfg, card, **kw)
    resumed_out, launches2, _, _ = counted_run(
        torch, cfg, b2, [ts.Prefilled(s.request, s.artifact) for s in susp],
        False, "resume")
    need(b2.prefills == 0, f"resume: {b2.prefills} prefills")
    for c in resumed_out:
        done[c.rid] = c.tokens
    need(sorted(done) == sorted(ref), f"resume: rids {sorted(done)}")
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)

    def next_logits(rid, prefix):
        prompt = [int(x) for x in mk[rid][0]]
        with torch.no_grad():
            return forward(cpu_cfg, params,
                           torch.tensor([prompt + prefix]))[0, -1]

    identical, gaps = divergence_gaps(ref, done, next_logits, "resume")
    resumed = [ts.Completion(rid=s.rid, request=s.request,
                             tokens=done[s.rid]) for s in susp[:2]]
    checked, positions = fp32_margin(torch, cfg, params, resumed,
                                     "resumed teacher-forced")
    stats = {"requests": len(ref), "suspended": len(susp),
             "suspended_steps": [s.artifact["step"] for s in susp],
             "streams_identical": identical, "divergence_gaps": gaps,
             "margin_checked": checked, "positions": positions,
             "launches_preempt_all": launches1, "launches_resume": launches2}
    say("  preempt_all + resume: " + json.dumps(stats))
    return stats


def divergence_gaps(ref, got, next_logits, what):
    """Streams ``got`` against ``ref`` (both {key: tokens}): how many are
    identical, and at each other stream's first difference the CPU
    logit gap between the two tokens (``next_logits(key, prefix)``: the
    float32 CPU logits after the prompt and ``prefix`` of the reference
    stream), each required within MARGIN — a near-tie, where rounding
    alone may pick either token."""
    identical, gaps = 0, []
    for key, want in ref.items():
        have = got[key]
        if have == want:
            identical += 1
            continue
        i = next(j for j in range(len(want)) if have[j] != want[j])
        logits = next_logits(key, want[:i])
        gap = abs(float(logits[have[i]]) - float(logits[want[i]]))
        need(gap <= MARGIN, f"{what} {key}: diverged at token {i} with a "
             f"CPU logit gap {gap:.3f} > {MARGIN}")
        gaps.append({"stream": key, "token": i, "gap": gap})
    return identical, gaps


def windowed_generate(torch, cfg, card):
    """``generate`` with window 256 at the flagship's width (batch 4,
    prompt 512, 64 new tokens): graphed and eager tokens identical,
    exactly n_layers flash_fwd launches (the windowed prefill) and no
    decode kernel (the rolling read is plain torch, as in JAX), the
    tokens teacher-forced against the card's own windowed forward."""
    from tfmesos_tpu_torch.models import transformer as tt

    wcfg = dataclasses.replace(cfg, window=256)
    batch, plen, new = 4, 512, 64
    prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                           generator=torch.Generator().manual_seed(17)).cuda()

    def run(n=new, eager=False):
        with torch.no_grad():
            return tt.generate(wcfg, card, prompt, n, _eager=eager)

    run(4)
    zero_launches()
    out = run()
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: 0 for k in launches}
    want["flash_fwd"] = cfg.n_layers
    need(launches == want, f"windowed generate launches {launches} != "
         f"{want}")
    eager = generate_eager(torch, run, out, want, new, batch)
    whole, pre, tok_s, step_ms = _generate_rate(
        torch, run, lambda: run(1), new, batch)
    with torch.no_grad():
        logits = tt.forward(wcfg, card, out[:, :-1].long())[:, plen - 1:]
    top = logits.float().topk(2, dim=-1)
    clear = (top.values[..., 0] - top.values[..., 1]) > MARGIN
    bad = clear & (top.indices[..., 0] != out[:, plen:].long())
    need(bool(torch.isfinite(logits).all()) and not bool(bad.any()),
         f"windowed generate: {int(bad.sum())} tokens differ from the "
         f"windowed forward's clear argmax")
    checked = int(clear.sum())
    need(checked >= MIN_CHECKED, f"windowed generate: only {checked} "
         f"positions above the margin")
    stats = {"window": 256, "batch": batch, "prompt": plen,
             "new_tokens": new, "run_s": whole, "prefill_s": pre,
             "decode_tok_per_s": tok_s, "ms_per_step": step_ms,
             "launches": launches, "forward_checked": checked,
             "eager": eager}
    say("  windowed generate: " + json.dumps(stats))
    return stats


# Phase 16's schedule modes over phase 5's traffic: (label, batcher
# arguments, int8 weights and pool).
MODE_RUNS = (("a multi_step=4", {"multi_step": 4}, False),
             ("b overlap", {"overlap": True}, False),
             ("c pipeline_depth=1", {"pipeline_depth": 1}, False),
             ("d pipeline_depth=1 multi_step=4",
              {"pipeline_depth": 1, "multi_step": 4}, False),
             ("e multi_step=4 int8", {"multi_step": 4}, True))
# Overlap and the pipeline over phase 14(b)'s chunked prefix-cache
# traffic, where chunk calls and decode-table changes fall between a
# lagged block's dispatch and its retire: (label, batcher arguments).
LAGGED14_RUNS = (("h overlap", {"overlap": True}),
                 ("i overlap multi_step=4", {"overlap": True,
                                             "multi_step": 4}),
                 ("j pipeline_depth=1", {"pipeline_depth": 1}),
                 ("k pipeline_depth=1 multi_step=4",
                  {"pipeline_depth": 1, "multi_step": 4}))
# The fused tick over phase 14(b)'s and (c)'s traffic: (label,
# tokens_per_tick).  The default budget is rows x K + one chunk (72 at K
# = 1): one chunk slot a tick.  rows + 8 x 64 lets every filling row
# take a slot, so slot counts of 1 to 8 run.
FUSED_RUNS = (("f fused, default budget", None),
              ("g fused, tokens_per_tick rows + 8 x 64", 8 + 8 * 64))


def phase_schedule_modes(torch, np, reqs, base, base8, sync, sync8, bases14,
                         sync14):
    """Phase 16: the batcher's schedule modes on the flagship.  Phase 5's
    traffic (``reqs``) under (a) multi_step=4, (b) overlap, (c)
    pipeline_depth=1, (d) pipeline_depth=1 with multi_step=4 and (e) (a)
    over int8 weights and an int8 pool: streams identical to phase 5's
    and 12's synchronous runs (``base``, ``base8``: the same shapes, only
    the sync point moves), exact launch counts.  Phase 14(b)'s and (c)'s
    traffic with ``fused_prefill`` under (f) the default budget and (g)
    rows + 8 x 64: streams identical to phase 14's phase-split runs
    (``bases14``) or, where one differs, differing first at a near-tie
    by the margin rule (the fused slots run [S, 64] GEMMs over
    16-column tables; counted and printed), the fused counters moving,
    exact launch counts.  Phase 14(b)'s traffic under (h)-(k), overlap
    and the pipeline at K 1 and 4: streams identical to phase 14(b)'s
    phase-split run, exact launch counts.  Each run on a fresh batcher,
    warmed, capturing no graph after warmup; prints ms a block and a
    step, TTFT and blocks beside the synchronous run's, and for (a)-(e)
    a profile's busy share."""
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.models.transformer import forward
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    say("[16/28] schedule modes: multi_step, overlap, pipeline_depth and "
        "the fused prefill tick, flagship, rows 8, page 64, bucket 64")
    cfg, params = flagship_model(seed=0, max_len=1024)
    card = _cuda(params)
    qparams = tt.quantize_params(cfg, card)
    out = {}
    for label, kw, int8 in MODE_RUNS:
        b = ContinuousBatcher(cfg, qparams if int8 else card, rows=8,
                              page_size=64, prefill_bucket=64,
                              quantized_cache=int8, device="cuda", **kw)
        info = b.warmup()
        warmed = b._graphs.keys()
        list(b.run([Request(np.arange(1, 9), 2)]))          # warm-up
        comps, stats = fleet_run(torch, cfg, b, reqs, int8, label)
        no_new_graphs(b, warmed, label)
        need(streams(comps) == streams(base8 if int8 else base),
             f"{label}: streams differ from the synchronous run's")
        ref = sync8 if int8 else sync
        stats.update(streams_identical=True,
                     warmup_seconds=info["seconds"],
                     warmup_graphs=len(info["compiled"]),
                     graph_pool_mib=b._graphs.pool_bytes / 2 ** 20,
                     sync_ms_per_tick=ref["ms_per_tick"],
                     sync_ttft_ms_mean=ref["ttft_ms_mean"],
                     sync_ttft_ms_p50=ref["ttft_ms_p50"],
                     sync_ticks=ref["decode_ticks"])
        say(f"  {label}: " + json.dumps(stats))
        stats["profile"] = profile_serving(torch, np, b, cfg)
        say(f"  {label}: ms a step {stats['ms_per_step']:.4f} (sync "
            f"{ref['ms_per_tick']:.4f}), blocks {stats['decode_ticks']} "
            f"(sync ticks {ref['decode_ticks']}), TTFT mean "
            f"{stats['ttft_ms_mean']:.3f} p50 {stats['ttft_ms_p50']:.3f} "
            f"(sync {ref['ttft_ms_mean']:.3f} / {ref['ttft_ms_p50']:.3f}); "
            f"streams identical")
        out[label] = stats
        del b
        torch.cuda.empty_cache()
    reqs14 = phase14_requests(np, cfg)
    traffic = "chunk 64 + prefix cache"
    ref = sync14[traffic]["graphed"]
    for label, kw in LAGGED14_RUNS:
        name = f"{label} ({traffic})"
        b = ContinuousBatcher(cfg, card, rows=8, page_size=64,
                              prefill_bucket=64, prefix_cache_pages=64,
                              prefill_chunk=64, device="cuda", **kw)
        info = b.warmup()
        warmed = b._graphs.keys()
        comps, stats = fleet_run(torch, cfg, b, reqs14, False, name)
        no_new_graphs(b, warmed, name)
        need(streams(comps) == streams(bases14[traffic]),
             f"{name}: streams differ from phase 14's phase-split run's")
        stats.update(streams_identical=True,
                     warmup_seconds=info["seconds"],
                     warmup_graphs=len(info["compiled"]),
                     graph_pool_mib=b._graphs.pool_bytes / 2 ** 20,
                     sync_ms_per_tick=ref["ms_per_tick"],
                     sync_ticks=ref["decode_ticks"],
                     sync_ttft_ms_mean=ref["ttft_ms_mean"],
                     sync_ttft_ms_warm_mean=ref["ttft_ms_warm_mean"],
                     sync_ttft_ms_warm_p50=ref["ttft_ms_warm_p50"])
        say(f"  {name}: " + json.dumps(stats))
        say(f"  {name}: ms a step {stats['ms_per_step']:.4f} (phase-split "
            f"{ref['ms_per_tick']:.4f}), blocks {stats['decode_ticks']} "
            f"(ticks {ref['decode_ticks']}), TTFT mean "
            f"{stats['ttft_ms_mean']:.3f} warm p50 "
            f"{stats['ttft_ms_warm_p50']:.3f} (phase-split "
            f"{ref['ttft_ms_mean']:.3f} / {ref['ttft_ms_warm_p50']:.3f}); "
            f"streams identical")
        out[name] = stats
        del b
        torch.cuda.empty_cache()
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    for label, budget in FUSED_RUNS:
        for traffic, int8 in (("chunk 64 + prefix cache", False),
                              ("chunk 64 + prefix cache, int8", True)):
            name = f"{label} ({traffic})"
            b = ContinuousBatcher(cfg, qparams if int8 else card, rows=8,
                                  page_size=64, prefill_bucket=64,
                                  quantized_cache=int8, prefix_cache_pages=64,
                                  prefill_chunk=64, fused_prefill=True,
                                  tokens_per_tick=budget, device="cuda")
            info = b.warmup()
            warmed = b._graphs.keys()
            need(sum(n.startswith("fused[") for n in info["compiled"])
                 == len(b._decode_widths()) * len(b._fused_slot_buckets()),
                 f"{name}: warmup prepared {info['compiled']}")
            comps, stats = fleet_run(torch, cfg, b, reqs14, int8, name)
            no_new_graphs(b, warmed, name)
            need(b.fused_prefill_bypass_reason is None
                 and min(stats["fused_ticks"], stats["fused_chunk_tokens"],
                         stats["fused_decode_tokens"]) > 0,
                 f"{name}: fused counters {stats}")

            def next_logits(i, prefix, int8=int8):
                prompt = [int(x) for x in reqs14[i].prompt]
                if int8:
                    return cpu_logits_int8(
                        torch, cfg, qparams, torch.tensor([prompt]),
                        torch.tensor([prefix + [0]]))[0, len(prefix)]
                with torch.no_grad():
                    return forward(cpu_cfg, params,
                                   torch.tensor([prompt + prefix]))[0, -1]

            identical, gaps = divergence_gaps(
                dict(enumerate(streams(bases14[traffic]))),
                dict(enumerate(streams(comps))), next_logits, name)
            ref = sync14[traffic]["graphed"]
            stats.update(streams_identical=identical, divergence_gaps=gaps,
                         warmup_seconds=info["seconds"],
                         warmup_graphs=len(info["compiled"]),
                         graph_pool_mib=b._graphs.pool_bytes / 2 ** 20,
                         tokens_per_tick=b.tokens_per_tick,
                         sync_ms_per_tick=ref["ms_per_tick"],
                         sync_ticks=ref["decode_ticks"],
                         sync_prefill_chunks=ref["prefill_chunks"],
                         sync_ttft_ms_cold=ref["ttft_ms_cold"],
                         sync_ttft_ms_warm_mean=ref["ttft_ms_warm_mean"],
                         sync_ttft_ms_warm_p50=ref["ttft_ms_warm_p50"])
            say(f"  {name}: " + json.dumps(stats))
            say(f"  {name}: {identical} of {len(comps)} streams identical "
                f"to the phase-split run's, {len(gaps)} differ first at a "
                f"near-tie; {stats['fused_ticks']} fused ticks of "
                f"{stats['fused_chunk_tokens']} chunk and "
                f"{stats['fused_decode_tokens']} decode tokens; ms a "
                f"tick {stats['ms_per_tick']:.4f} (phase-split tick "
                f"{ref['ms_per_tick']:.4f}), TTFT warm mean "
                f"{stats['ttft_ms_warm_mean']:.3f} (phase-split "
                f"{ref['ttft_ms_warm_mean']:.3f})")
            out[name] = stats
            del b
            torch.cuda.empty_cache()
    return out


# Phase 17's migration traffic: every prompt 130..150 tokens plus 40 new
# ones stays at three pages of 64 from its prefill to its last token, so
# the decode tick's table width — and with it every row's arithmetic —
# does not depend on which rows share a tick, and a migrated stream must
# equal the unmigrated one token for token.
MIGRATE_LENS = (130, 151)
MIGRATE_NEW = 40


def replica_up(token, *argv):
    """One flagship replica in this process through the port's own
    ``start_replica`` (rows 8, page 64, bucket 64, ``--warmup``, weights
    seeded 0, no registry): (server, serving, batcher, the graph keys
    its warmup captured)."""
    from tfmesos_tpu_torch.fleet import replica

    args = replica.build_parser().parse_args(
        ["--rows", "8", "--page-size", "64", "--prefill-bucket", "64",
         "--warmup", "--seed", "0", *argv])
    server, serving, b = replica.start_replica(args, token=token,
                                               environ={})
    return server, serving, b, b._graphs.keys()


def replica_down(torch, rep) -> None:
    server, serving = rep[:2]
    server.stop()
    if serving is not None:
        serving.close()
    torch.cuda.synchronize()


def wire_calls(links, msgs, bodies=None, timeout=300.0):
    """Send ``msgs`` (raw frames where ``bodies`` has a body) over
    ``links`` round robin, one thread a call, all at once.  Returns
    (replies, each call's partial frames, client-side ms from send to
    first partial or None)."""
    import threading

    n = len(msgs)
    replies, parts, first = [None] * n, [[] for _ in msgs], [None] * n
    errors = []

    def call(i):
        t0 = time.perf_counter()

        def on_partial(frame):
            if first[i] is None:
                first[i] = (time.perf_counter() - t0) * 1e3
            parts[i].append(frame)

        try:
            link = links[i % len(links)]
            body = bodies[i] if bodies is not None else None
            replies[i] = (link.call(msgs[i], timeout=timeout,
                                    on_partial=on_partial)
                          if body is None else
                          link.call_raw(msgs[i], body, timeout=timeout,
                                        on_partial=on_partial))
        except Exception as e:         # reported below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    need(not errors, f"replica calls failed: {errors}")
    return replies, parts, first


def head(reply):
    """A reply's JSON part: the dict, or a raw frame's meta."""
    return reply if isinstance(reply, dict) else reply.meta


def completions(replies, what):
    """The token lists of ``replies``, each required a completion."""
    bad = [head(r) for r in replies
           if not (isinstance(r, dict) and r.get("op") == "completion")]
    need(not bad, f"{what}: {len(bad)} replies are not completions: "
         f"{bad[:2]}")
    return [r["tokens"] for r in replies]


def rebuilt(parts, tokens, what):
    """Partial frames must carry contiguous offsets from 0 whose tokens
    are the final list's prefix (the last block may come only with the
    completion)."""
    got = []
    for p in parts:
        need(p.get("op") == "tokens" and p.get("off") == len(got),
             f"{what}: partial frame {p} at stream length {len(got)}")
        got += p["tokens"]
    need(0 < len(got) <= len(tokens) and got == tokens[:len(got)],
         f"{what}: partials {got} are not a prefix of {tokens}")


def generate_msg(prompt, new, **kw):
    return {"op": "generate", "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(new), **kw}


def phase_replica(torch, np, cfg, params, reqs, base, stats5):
    """Phase 17: the fleet replica on the card, built through the port's
    ``start_replica`` and driven over TCP with the port's
    ``MuxConnection``.  (a) phase 5's 16 requests on 4 connections, 4 of
    them streamed: every request completes, streams held to phase 5's by
    the margin rule, partials rebuild the list, no capture after
    warmup, exact launch counts; TTFT, ms a tick, wall time and the
    wire's share of TTFT.  (b) two replicas: ``migrate`` to A after its
    first tokens, the suspended raw frames resubmitted to B as raw
    generates, then once with ``push_to`` (``kv_stage``, then
    ``kv_ref``): every stream equal to A's own, token for token.  (c) a
    prefill-role replica's raw ``prefilled`` frames imported by a
    decode-role replica, which runs no flash_fwd; streams by the margin
    rule.  (d) ``python -m tfmesos_tpu_torch.fleet.replica --warmup
    --rows 8`` as a process: its warmed and serving lines, phase 5's
    requests served (timed, as in (a)), exit 0 on SIGTERM."""
    from tfmesos_tpu_torch import wire
    from tfmesos_tpu_torch.models.transformer import forward

    say("[17/28] the replica: flagship, rows 8, page 64, bucket 64, "
        "--warmup, over TCP")
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    token = wire.new_token()
    ref = dict(enumerate(base))

    def next_logits(i, prefix):
        prompt = [int(x) for x in reqs[i].prompt]
        with torch.no_grad():
            return forward(cpu_cfg, params,
                           torch.tensor([prompt + prefix]))[0, -1]

    out = {}
    a = replica_up(token)
    b = replica_up(token)
    try:
        out["a"] = replica_serve(torch, cfg, a, token, reqs, ref,
                                 next_logits, stats5)
        out["b"] = replica_migrate(torch, np, cfg, a, b, token)
    finally:
        replica_down(torch, a)
        replica_down(torch, b)
    # A replica is cyclic garbage once stopped (its server and handler
    # refer to each other): collect it here, not at a random allocation.
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    out["c"] = replica_disagg(torch, cfg, token, reqs, ref, next_logits)
    gc.collect()
    torch.cuda.empty_cache()
    out["d"] = replica_process(torch, token, reqs, ref, next_logits,
                               stats5)
    return out


def phase5_msgs(reqs):
    """Phase 5's requests as generate messages; every fourth streamed
    and traced (its reply carries the replica's hop-local spans)."""
    return [generate_msg(r.prompt, r.max_new_tokens,
                         **({"stream": True, "trace_id": f"p17-{i}",
                             "trace_detail": True} if i % 4 == 0 else {}))
            for i, r in enumerate(reqs)]


def wire_ttft(replies, parts, first, what):
    """TTFT over the wire: the replies' ``ttft_ms`` (admission to first
    token in the batcher), and for the streamed requests the client's
    (send to first partial), their difference (the wire's share as the
    client sees it: the wire, the handler and the wait for a free row),
    the wait for a row (the trace's ``batcher/admit`` after
    ``replica/recv``) and what remains without it; ms a token (each
    reply's decode time over its tokens after the first)."""
    streamed = [i for i, f in enumerate(first) if f is not None]
    for i in streamed:
        rebuilt(parts[i], replies[i]["tokens"], f"{what} request {i}")
    need(len(streamed) == 4, f"{what}: {len(streamed)} streamed requests "
         f"had partials")
    queue, rest = [], []
    for i in streamed:
        spans = {(x["component"], x["name"]): x
                 for x in replies[i].get("trace", ())}
        need(("replica", "recv") in spans and ("batcher", "prefill") in
             spans, f"{what} request {i}: spans {sorted(spans)}")
        pre = spans[("batcher", "prefill")]
        queue.append(pre["t0"] - spans[("replica", "recv")]["t0"])
        rest.append(first[i] - (pre["t0"] + pre["dur"]))
    ttft = [r["ttft_ms"] for r in replies]
    client = [first[i] for i in streamed]
    wire = [first[i] - replies[i]["ttft_ms"] for i in streamed]
    per_token = [(r["total_ms"] - r["ttft_ms"]) / (len(r["tokens"]) - 1)
                 for r in replies]
    return {"ttft_ms_mean": statistics.mean(ttft),
            "ttft_ms_p50": statistics.median(ttft),
            "client_ttft_ms_mean_streamed": statistics.mean(client),
            "wire_ms_mean_streamed": statistics.mean(wire),
            "wire_share_of_ttft": statistics.mean(wire)
            / statistics.mean(client),
            "row_wait_ms_mean_streamed": statistics.mean(queue),
            "wire_ms_without_row_wait": statistics.mean(rest),
            "ms_per_token_mean": statistics.mean(per_token)}


def ttft_say(label, stats, stats5):
    say(f"  {label} TTFT mean {stats['ttft_ms_mean']:.3f} p50 "
        f"{stats['ttft_ms_p50']:.3f} ms (phase 5 "
        f"{stats5['ttft_ms_mean']:.3f}); streamed at the client "
        f"{stats['client_ttft_ms_mean_streamed']:.3f} ms, of it "
        f"{stats['wire_ms_mean_streamed']:.3f} beyond ttft_ms (share "
        f"{stats['wire_share_of_ttft']:.3f}): "
        f"{stats['row_wait_ms_mean_streamed']:.3f} waiting for a row, "
        f"{stats['wire_ms_without_row_wait']:.3f} the wire and the "
        f"handler; ms a token {stats['ms_per_token_mean']:.4f}")


def replica_serve(torch, cfg, rep, token, reqs, ref, next_logits, stats5):
    """Phase 17 (a)."""
    from tfmesos_tpu_torch.fleet.client import MuxConnection

    server, _, b, warmed = rep
    links = [MuxConnection(server.addr, token) for _ in range(4)]
    try:
        # Warm-up request (cuBLAS handles, allocator pools) outside the
        # measured run.
        completions(wire_calls(links[:1], [generate_msg(range(1, 9), 2)])[0],
                    "17 (a) warm-up")
        msgs = phase5_msgs(reqs)
        (replies, parts, first), launches, wall, _ = counted_run(
            torch, cfg, b, None, False, "17 (a) replica",
            drive=lambda: wire_calls(links, msgs))
    finally:
        for link in links:
            link.close()
    no_new_graphs(b, warmed, "17 (a) replica")
    got = completions(replies, "17 (a)")
    need(all(len(t) == r.max_new_tokens for t, r in zip(got, reqs)),
         "17 (a): a request did not complete its tokens")
    identical, gaps = divergence_gaps(ref, dict(enumerate(got)),
                                      next_logits, "17 (a)")
    stats = {"requests": len(replies), "wall_s": wall,
             "prefills": b.prefills, "decode_ticks": b.decode_ticks,
             "ms_per_tick": b.decode_seconds / b.decode_ticks * 1e3,
             **wire_ttft(replies, parts, first, "17 (a)"),
             "streams_identical": identical, "divergence_gaps": gaps,
             "graphs_after_warmup": 0, "launches": launches,
             "phase5_ttft_ms_mean": stats5["ttft_ms_mean"],
             "phase5_ms_per_tick": stats5["ms_per_tick"]}
    say("  (a) " + json.dumps(stats))
    say(f"  (a) {identical} of {len(got)} streams identical to phase 5's, "
        f"{len(gaps)} differ first at a near-tie; ms a tick "
        f"{stats['ms_per_tick']:.4f} (phase 5 {stats5['ms_per_tick']:.4f}); "
        f"wall {wall:.3f} s")
    ttft_say("(a)", stats, stats5)
    return stats


def replica_migrate(torch, np, cfg, a, b, token):
    """Phase 17 (b): A's own streams of 8 requests, then the same
    requests migrated from A to B mid-stream, relayed and pushed."""
    import threading

    from tfmesos_tpu_torch.fleet.client import MuxConnection

    rng = np.random.RandomState(17)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in rng.randint(*MIGRATE_LENS, size=8)]
    la, lb = MuxConnection(a[0].addr, token), MuxConnection(b[0].addr, token)
    control = MuxConnection(a[0].addr, token)
    out = {}
    try:
        want = completions(wire_calls(
            [la], [generate_msg(p, MIGRATE_NEW) for p in prompts])[0],
            "17 (b) A alone")
        for mode in ("relay", "push_to"):
            counted = [Counted(a[2]), Counted(b[2])]
            zero_launches()

            t0 = time.perf_counter()
            sent = {}
            t = threading.Thread(target=lambda: sent.update(a=wire_calls(
                [la], [generate_msg(p, MIGRATE_NEW, stream=True)
                       for p in prompts])))
            t.start()
            # Migrate once every request is admitted and A has ticked.
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and not (
                    a[2].decode_ticks >= 1
                    and a[2].prefills == len(prompts)):
                time.sleep(0.0005)
            msg = {"op": "migrate"}
            if mode == "push_to":
                msg["push_to"] = b[0].addr
            need(control.call(msg, timeout=30.0)["op"] == "migrated",
                 "17 (b): migrate not acked")
            t.join()
            replies, parts, _ = sent["a"]
            ops = [head(r).get("op") for r in replies]
            suspended = ops.count("suspended")
            need(suspended == len(prompts),
                 f"17 (b) {mode}: {suspended} of {len(prompts)} requests "
                 f"suspended ({ops})")
            msgs, bodies = [], []
            for p, r in zip(prompts, replies):
                if mode == "relay":
                    need(not isinstance(r, dict), f"17 (b) relay: {r}")
                    meta = {k: v for k, v in r.meta.items()
                            if k not in ("op", "id", "gen",
                                         "weights_version", "trace")}
                    meta.update(generate_msg(p, MIGRATE_NEW))
                    msgs.append(meta)
                    bodies.append(r.body)
                else:
                    need(isinstance(r, dict) and r.get("pushed"),
                         f"17 (b) push_to: {r}")
                    msgs.append(generate_msg(p, MIGRATE_NEW,
                                             kv_ref=r["xfer"]))
                    bodies.append(None)
            resumed = completions(wire_calls([lb], msgs, bodies)[0],
                                  f"17 (b) {mode} resumed")
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            for c in counted:
                c.close()
            launches = read_launches()
            wa, _ = counted[0].want(cfg, False, "17 (b) A")
            wb, _ = counted[1].want(cfg, False, "17 (b) B")
            expect = {k: wa[k] + wb[k] for k in wa}
            need(launches == expect and b[2].prefills == 0,
                 f"17 (b) {mode} launches {launches} != {expect} (B "
                 f"prefills {b[2].prefills})")
            steps = [len(head(r).get("tokens") or ()) or None
                     for r in replies]
            need(resumed == want, f"17 (b) {mode}: resumed streams differ "
                 f"from A's own")
            for i, ps in enumerate(parts):
                rebuilt(ps, want[i], f"17 (b) {mode} request {i}")
            no_new_graphs(a[2], a[3], f"17 (b) {mode} A")
            no_new_graphs(b[2], b[3], f"17 (b) {mode} B")
            out[mode] = {"requests": len(prompts), "suspended":
                         suspended, "identical": len(prompts),
                         "tokens_before_migrate": steps,
                         "a_ticks": a[2].decode_ticks,
                         "b_ticks": b[2].decode_ticks, "wall_s": wall,
                         "launches": launches}
            say(f"  (b) {mode}: " + json.dumps(out[mode]))
            say(f"  (b) {mode}: {len(prompts)} of {len(prompts)} requests "
                f"migrated from A to B mid-stream, every resumed stream "
                f"identical to A's own")
    finally:
        for link in (la, lb, control):
            link.close()
    return out


def replica_disagg(torch, cfg, token, reqs, ref, next_logits):
    """Phase 17 (c): phase 5's requests prefilled by a prefill-role
    replica (raw ``prefilled`` frames) and imported by a decode-role
    replica."""
    from tfmesos_tpu_torch.fleet.client import MuxConnection

    p = replica_up(token, "--role", "prefill")
    d = replica_up(token, "--role", "decode")
    out = {}
    try:
        pl = [MuxConnection(p[0].addr, token) for _ in range(4)]
        dl = [MuxConnection(d[0].addr, token) for _ in range(4)]
        counted = Counted(p[2])
        zero_launches()
        t0 = time.perf_counter()
        # Two waves of 8: the prefill handler sheds past 8 queued
        # (``overloaded``; the router would retry another replica).
        msgs = [dict(generate_msg(r.prompt, r.max_new_tokens), op="prefill")
                for r in reqs]
        frames = (wire_calls(pl, msgs[:8])[0]
                  + wire_calls(pl, msgs[8:])[0])
        torch.cuda.synchronize()
        export_wall = time.perf_counter() - t0
        counted.close()
        exports = read_launches()
        want, _ = counted.want(cfg, False, "17 (c) prefill")
        need(exports == want and p[2].prefills == len(reqs),
             f"17 (c) prefill launches {exports} != {want}")
        need(all(not isinstance(f, dict) and head(f).get("op") == "prefilled"
                 for f in frames), "17 (c): a prefill reply is not a raw "
             "prefilled frame")
        msgs, bodies = [], []
        for r, f in zip(reqs, frames):
            meta = {k: v for k, v in f.meta.items()
                    if k not in ("op", "id", "prefill_ms", "trace")}
            meta.update(generate_msg(r.prompt, r.max_new_tokens))
            msgs.append(meta)
            bodies.append(f.body)
        (replies, _, _), imports, wall, _ = counted_run(
            torch, cfg, d[2], None, False, "17 (c) decode import",
            drive=lambda: wire_calls(dl, msgs, bodies))
        need(d[2].prefills == 0 and imports["flash_fwd"] == 0,
             f"17 (c): the import path ran {imports['flash_fwd']} flash_fwd")
        no_new_graphs(p[2], p[3], "17 (c) prefill")
        no_new_graphs(d[2], d[3], "17 (c) decode")
        got = completions(replies, "17 (c)")
        identical, gaps = divergence_gaps(ref, dict(enumerate(got)),
                                          next_logits, "17 (c)")
        mb = sum(len(x) for x in bodies) / 1e6
        out = {"requests": len(got), "artifact_mb": mb,
               "export_wall_s": export_wall, "import_wall_s": wall,
               "prefill_ms_mean": statistics.mean(
                   f.meta["prefill_ms"] for f in frames),
               "decode_ticks": d[2].decode_ticks,
               "ms_per_tick": d[2].decode_seconds / d[2].decode_ticks * 1e3,
               "streams_identical": identical, "divergence_gaps": gaps,
               "launches_export": exports, "launches": imports}
        say("  (c) " + json.dumps(out))
        say(f"  (c) {identical} of {len(got)} disaggregated streams "
            f"identical to phase 5's, {len(gaps)} differ first at a "
            f"near-tie; {mb:.1f} MB of artifacts over the wire; the "
            f"import path ran no flash_fwd")
        for link in pl + dl:
            link.close()
    finally:
        replica_down(torch, p)
        replica_down(torch, d)
    return out


def replica_process(torch, token, reqs, ref, next_logits, stats5):
    """Phase 17 (d): the replica as its own process on the card, phase
    5's traffic sent to it from this one (so no client thread contends
    with its serve thread for the interpreter)."""
    import os
    import signal
    import threading

    from tfmesos_tpu_torch.fleet.client import MuxConnection

    env = dict(os.environ, TPUMESOS_TOKEN=token)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TPUMESOS_TOKEN_FILE", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tfmesos_tpu_torch.fleet.replica",
         "--warmup", "--rows", "8"], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    timer = threading.Timer(300.0, proc.kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("replica serving on"):
                break
        timer.cancel()
        need(lines and lines[-1].startswith("replica serving on")
             and lines[-1].endswith("(role unified)"),
             f"17 (d): no serving line: {lines[-20:]}")
        need(any(x.startswith("replica warmed in") for x in lines),
             f"17 (d): no warmed line: {lines[-20:]}")
        up_s = time.perf_counter() - t0
        addr = lines[-1].split()[3]
        links = [MuxConnection(addr, token) for _ in range(4)]
        try:
            completions(wire_calls(links[:1],
                                   [generate_msg(range(1, 9), 2)])[0],
                        "17 (d) warm-up")
            t1 = time.perf_counter()
            replies, parts, first = wire_calls(links, phase5_msgs(reqs))
            wall = time.perf_counter() - t1
        finally:
            for link in links:
                link.close()
        got = completions(replies, "17 (d)")
        identical, gaps = divergence_gaps(ref, dict(enumerate(got)),
                                          next_logits, "17 (d)")
        timing = wire_ttft(replies, parts, first, "17 (d)")
        proc.send_signal(signal.SIGTERM)
        tail, _ = proc.communicate(timeout=60)
        need(proc.returncode == 0, f"17 (d): exit code {proc.returncode}: "
             f"{tail[-2000:]}")
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = {"lines": [x for x in lines if x.startswith("replica ")],
           "up_s": up_s, "requests": len(got), "wall_s": wall, **timing,
           "streams_identical": identical, "divergence_gaps": gaps,
           "exit_code": proc.returncode}
    say("  (d) " + json.dumps(out))
    say(f"  (d) the replica process: up in {up_s:.1f} s, {identical} of "
        f"{len(got)} streams identical to phase 5's, {len(gaps)} differ "
        f"first at a near-tie, exit code 0 on SIGTERM")
    ttft_say("(d)", out, stats5)
    return out


#: a request as :func:`fleet_requests` reads it.
FleetReq = collections.namedtuple("FleetReq", "prompt max_new_tokens")

FRONT_DOOR = dict(rows=8, max_len=1024, page_size=64, prefill_bucket=64,
                  seed=0, warmup=True, request_timeout=300.0,
                  start_timeout=300.0, gateway_host="127.0.0.1")


#: phase 18 (d)'s ``tfserve`` flags.
CLI_SERVE = ["--replicas", "1", "--rows", "8", "--warmup", "-p", "0",
             "--gateway-host", "127.0.0.1"]


def proc_table():
    """{pid: (ppid, state)} of every process on this machine."""
    import os

    table = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        table[int(name)] = (int(fields[1]), fields[0])
    return table


def descendants(root):
    """Live (not zombie) processes below ``root``."""
    table = proc_table()
    out, frontier = [], [root]
    while frontier:
        parent = frontier.pop()
        for pid, (ppid, state) in table.items():
            if ppid == parent:
                frontier.append(pid)
                if state != "Z":
                    out.append(pid)
    return out


def replica_pids(roots):
    """The replica processes (``-m tfmesos_tpu_torch.fleet.replica``)
    below ``roots``."""
    out = []
    for root in roots:
        for pid in descendants(root):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().split(b"\0")
            except OSError:
                continue
            if b"tfmesos_tpu_torch.fleet.replica" in argv:
                out.append(pid)
    return sorted(out)


def pids_alive(pids):
    table = proc_table()
    return [p for p in pids if p in table and table[p][1] != "Z"]


def smi_apps():
    """``nvidia-smi --query-compute-apps=pid,used_memory``: {pid: MiB}
    (summed per pid)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    need(out.returncode == 0, f"nvidia-smi compute-apps: {out.stderr}")
    apps = {}
    for line in out.stdout.strip().splitlines():
        pid, mem = (x.strip() for x in line.split(","))
        apps[int(pid)] = apps.get(int(pid), 0.0) + float(mem)
    return apps


def tree_numel(tree):
    """Elements of every tensor in a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_numel(v) for v in tree)
    return tree.numel()


def replica_stats(addrs, token, reset=False):
    """Each replica's answer to the ``stats`` op, {addr: reply}; with
    ``reset`` its launch counts are set to 0 first."""
    from tfmesos_tpu_torch.fleet.client import MuxConnection

    out = {}
    for addr in addrs:
        link = MuxConnection(addr, token)
        try:
            reply = link.call({"op": "stats", "reset_launches": reset},
                              timeout=60.0)
        finally:
            link.close()
        need(isinstance(reply, dict) and reply.get("op") == "stats",
             f"stats of replica {addr}: {reply}")
        out[addr] = reply
    return out


def settled_stats(addrs, token):
    """:func:`replica_stats` once two reads 0.2 s apart agree on every
    count (a replica may still be counting its last tick when its last
    reply has arrived)."""
    def counts(stats):
        return {a: (s["launches"], s["counters"]) for a, s in stats.items()}

    last = replica_stats(addrs, token)
    for _ in range(50):
        time.sleep(0.2)
        now = replica_stats(addrs, token)
        if counts(now) == counts(last):
            return now
        last = now
    need(False, f"replica counts did not settle: {counts(last)}")


def on_the_card(stats, pids, weights_bytes, before, what):
    """Each replica is on the card, by its own ``stats`` answer: it is
    one of this fleet's replica processes ``pids``, its batcher runs on
    a CUDA device, and it holds at least the model's bf16 weights
    (``weights_bytes``) in device memory.  And the card's compute apps
    (nvidia-smi, summed: on the card's machine it lists every process
    under one pid) grew from ``before`` (MiB) by at least the weights
    of every replica.  Returns what was read."""
    by_pid = {s["pid"]: s for s in stats.values()}
    need(sorted(by_pid) == sorted(pids), f"{what}: the replicas answer "
         f"as pids {sorted(by_pid)}, the fleet's processes are {pids}")
    for pid, s in by_pid.items():
        need(s["device"].startswith("cuda")
             and s["memory_allocated"] >= weights_bytes,
             f"{what}: replica pid {pid} on {s['device']} holds "
             f"{s['memory_allocated']} bytes, the weights are "
             f"{weights_bytes}")
    apps = smi_apps()
    grew = sum(apps.values()) - sum(before.values())
    need(grew * 2 ** 20 >= len(pids) * weights_bytes,
         f"{what}: the compute apps grew {grew} MiB ({before} -> {apps}) "
         f"for {len(pids)} replicas of {weights_bytes} weight bytes")
    return {"replicas": {str(p): {"device": s["device"],
                                  "memory_allocated": s["memory_allocated"]}
                         for p, s in sorted(by_pid.items())},
            "weights_bytes": weights_bytes, "smi_apps_mib": apps,
            "smi_apps_mib_before": before, "apps_mib_grew": grew}


#: The kernels no replica of phase 18 may launch (no int8 pool, no
#: linear-cache generate, no training).
IDLE_IN_A_REPLICA = ("quant_int8", "quant_int8_commit", "flash_decode",
                     "flash_decode_merge", "flash_bwd_dq", "flash_bwd_dkv")


def replica_launches(cfg, before, after, what):
    """The kernels the replicas launched between two ``stats`` reads
    (their launch counts set to 0 at ``before``), summed over replicas.
    Each replica's counts are held to its batcher's dispatch counters:
    n_layers flash_fwd a prefill, n_layers flash_decode_paged a call
    (K a decode block, one a prefix-cache tail or prefill chunk), no
    fused tick and none of :data:`IDLE_IN_A_REPLICA`.  The merges are
    counted, not derived: their number depends on each call's table
    width, which the counters do not carry."""
    total = {}
    for addr, a in after.items():
        d = {k: n - before[addr]["counters"][k]
             for k, n in a["counters"].items()}
        got = a["launches"]
        calls = (a["multi_step"] * d["decode_ticks"] + d["tail_prefills"]
                 + d["prefill_chunks"])
        need(d["fused_ticks"] == 0
             and got["flash_fwd"] == cfg.n_layers * d["prefills"]
             and got["flash_decode_paged"] == cfg.n_layers * calls
             and not any(got[k] for k in IDLE_IN_A_REPLICA),
             f"{what}: replica {addr} launched {got} for its counters {d}")
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
    return total


def fleet_counters(fleet):
    return dict(fleet.snapshot()["counters"])


def delta(after, before, key):
    return after.get(key, 0) - before.get(key, 0)


def fleet_requests(fleet, reqs, streamed_every=4, threads=4):
    """Phase 5's requests through ``fleet.client()`` from ``threads``
    threads (each sends its share in turn), every ``streamed_every``-th
    streamed with ``on_tokens``, all traced in full.  Returns (replies,
    streamed tokens {i: list}, client-side ms to the first streamed
    token {i: ms}, wall seconds)."""
    import threading

    client = fleet.client(timeout=300.0)
    n = len(reqs)
    replies, streamed, first, errors = [None] * n, {}, {}, []

    def worker(k):
        for i in range(k, n, threads):
            kw = {}
            t0 = time.perf_counter()
            if i % streamed_every == 0:
                streamed[i] = []

                def on_tokens(toks, i=i, t0=t0):
                    if not streamed[i]:
                        first[i] = (time.perf_counter() - t0) * 1e3
                    streamed[i].extend(toks)

                kw["on_tokens"] = on_tokens
            try:
                replies[i] = client.generate(
                    [int(x) for x in reqs[i].prompt],
                    reqs[i].max_new_tokens, trace=True, **kw)
            except Exception as e:         # reported below
                errors.append((i, repr(e)))

    t0 = time.perf_counter()
    pool = [threading.Thread(target=worker, args=(k,))
            for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    wall = time.perf_counter() - t0
    client.close()
    need(not errors, f"fleet requests failed: {errors}")
    for i, toks in streamed.items():
        need(toks == replies[i]["tokens"], f"request {i}: the streamed "
             f"concatenation differs from the reply's tokens")
    return replies, streamed, first, wall


def served_by(fleet, replies):
    """{replica addr: requests} from the router's ``attempt`` spans of
    each reply's trace (the last successful attempt served it)."""
    count = {}
    for r in replies:
        rec = fleet.tracebook.get(r["trace_id"])
        need(rec is not None and rec.get("spans"),
             f"no trace detail for {r['trace_id']}")
        ok = [s["addr"] for s in rec["spans"]
              if s["component"] == "router" and s["name"] == "attempt"
              and s.get("outcome") == "ok"]
        need(len(ok) == 1, f"trace {r['trace_id']}: attempts {ok}")
        count[ok[0]] = count.get(ok[0], 0) + 1
    return count


def phase_front_door(torch, np, cfg, params, reqs, base):
    """Phase 18: the port's front door (``FleetServer``, ``tfserve``)
    on the card, its replicas launched as processes of their own."""
    import os

    from tfmesos_tpu_torch.fleet.launcher import FleetServer
    from tfmesos_tpu_torch.models.transformer import forward

    say("[18/28] the front door: FleetServer and tfserve, flagship, rows "
        "8, max_len 1024, page 64, bucket 64, --warmup, seed 0")
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ref = dict(enumerate(base))

    def next_logits(i, prefix):
        prompt = [int(x) for x in reqs[i].prompt]
        with torch.no_grad():
            return forward(cpu_cfg, params,
                           torch.tensor([prompt + prefix]))[0, -1]

    # This process's own pools stay out of the replicas' way.
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    before = smi_apps()
    t0 = time.perf_counter()
    fleet = FleetServer(replicas=2, **FRONT_DOOR).start()
    try:
        up_s = time.perf_counter() - t0
        pids = replica_pids([os.getpid()])
        out["a"] = front_unified(np, cfg, fleet, reqs, ref, next_logits,
                                 up_s, pids, before, 2 * tree_numel(params))
        out["b"] = front_migrate(np, cfg, fleet)
    finally:
        fleet.stop()
    need(not pids_alive(pids), f"18 (a): replica processes "
         f"{pids_alive(pids)} outlived FleetServer.stop()")
    out["c"] = front_disagg(FleetServer, cfg, reqs, ref, next_logits)
    out["d"] = front_cli(reqs, ref, next_logits)
    return out


def front_unified(np, cfg, fleet, reqs, ref, next_logits, up_s, pids,
                  before, weights_bytes):
    """Phase 18 (a)."""
    need(len(pids) == 2, f"18 (a): replica processes {pids}")
    addrs = sorted(r.addr for r in fleet.registry.alive())
    card = on_the_card(replica_stats(addrs, fleet.token), pids,
                       weights_bytes, before, "18 (a)")
    # One request a replica first (cuBLAS handles and allocator pools of
    # each process), outside the measured run.
    warm = [FleetReq(list(range(1, 9)), 2)] * 4
    fleet_requests(fleet, warm, streamed_every=len(warm) + 1)
    before = fleet_counters(fleet)
    zero = replica_stats(addrs, fleet.token, reset=True)
    replies, streamed, first, wall = fleet_requests(fleet, reqs)
    launches = replica_launches(cfg, zero, settled_stats(addrs, fleet.token),
                                "18 (a)")
    after = fleet_counters(fleet)
    need(launches["flash_fwd"] > 0 and launches["flash_decode_paged"] > 0,
         f"18 (a): the replicas launched {launches}")
    got = [r["tokens"] for r in replies]
    need(all(len(t) == r.max_new_tokens for t, r in zip(got, reqs)),
         "18 (a): a request did not complete its tokens")
    identical, gaps = divergence_gaps(ref, dict(enumerate(got)),
                                      next_logits, "18 (a)")
    books = {k: delta(after, before, k)
             for k in ("received", "admitted", "completed", "failed")}
    need(books["received"] == books["admitted"] == books["completed"]
         == len(reqs) and books["failed"] == 0,
         f"18 (a): gateway counters {books}")
    per = served_by(fleet, replies)
    need(len(per) == 2 and min(per.values()) >= 1,
         f"18 (a): requests per replica {per}")
    ttft = [r["ttft_ms"] for r in replies]
    client = [first[i] for i in sorted(first)]
    stats = {"fleet_up_s": up_s, "requests": len(replies),
             "wall_s": wall, "ttft_ms_mean": statistics.mean(ttft),
             "ttft_ms_p50": statistics.median(ttft), "ttft_ms": ttft,
             "client_ttft_ms_mean_streamed": statistics.mean(client),
             "client_ttft_ms_p50_streamed": statistics.median(client),
             "requests_per_replica": sorted(per.values()),
             "replica_pids": pids, "card": card, "counters": books,
             "launches": launches, "streams_identical": identical,
             "divergence_gaps": gaps}
    say("  (a) " + json.dumps(stats))
    say(f"  (a) fleet up in {up_s:.1f} s; {identical} of {len(got)} "
        f"streams identical to phase 5's, {len(gaps)} differ first at a "
        f"near-tie; replies' ttft_ms mean {stats['ttft_ms_mean']:.3f} p50 "
        f"{stats['ttft_ms_p50']:.3f}; client TTFT of the streamed mean "
        f"{stats['client_ttft_ms_mean_streamed']:.3f} p50 "
        f"{stats['client_ttft_ms_p50_streamed']:.3f} ms; requests per "
        f"replica {sorted(per.values())}; wall {wall:.3f} s; both "
        f"replica processes on the card (compute apps "
        f"+{card['apps_mib_grew']:.0f} MiB); launches {launches}")
    return stats


def front_migrate(np, cfg, fleet):
    """Phase 18 (b)."""
    import threading

    rng = np.random.RandomState(17)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in rng.randint(*MIGRATE_LENS, size=8)]
    reqs = [FleetReq(p, MIGRATE_NEW) for p in prompts]
    want = [r["tokens"] for r in fleet_requests(fleet, reqs,
                                                len(reqs) + 1)[0]]
    before = fleet_counters(fleet)
    addrs = sorted(r.addr for r in fleet.registry.alive())
    zero = replica_stats(addrs, fleet.token, reset=True)
    client = fleet.client(timeout=300.0)
    streamed = [[] for _ in prompts]
    firsts = threading.Semaphore(0)
    replies, errors = [None] * len(prompts), []

    def call(i):
        def on_tokens(toks):
            if not streamed[i]:
                firsts.release()
            streamed[i].extend(toks)

        try:
            replies[i] = client.generate(prompts[i], MIGRATE_NEW,
                                         on_tokens=on_tokens)
        except Exception as e:             # reported below
            errors.append((i, repr(e)))

    t0 = time.perf_counter()
    pool = [threading.Thread(target=call, args=(i,))
            for i in range(len(prompts))]
    victim = None
    try:
        for t in pool:
            t.start()
        for _ in prompts:
            need(firsts.acquire(timeout=60.0), "18 (b): no first token")
        # Every request is decoding: drain the replica holding the most
        # of them (pinned, as a scale-down does) and ask it to migrate.
        victim = max((r.addr for r in fleet.registry.alive()),
                     key=fleet.router.outstanding)
        in_flight = fleet.router.outstanding(victim)
        fleet.registry.begin_drain(victim, pinned=True)
        asked = fleet.request_migration(victim)
        for t in pool:
            t.join()
    finally:
        if victim is not None:
            fleet.registry.clear_drain(victim)
        client.close()
    wall = time.perf_counter() - t0
    need(not errors, f"18 (b): {errors}")
    launches = replica_launches(cfg, zero, settled_stats(addrs, fleet.token),
                                "18 (b)")
    after = fleet_counters(fleet)
    got = [r["tokens"] for r in replies]
    stats = {"requests": len(got), "victim_in_flight": in_flight,
             "identical": sum(g == w for g, w in zip(got, want)),
             "wall_s": wall, "launches": launches,
             **{k: delta(after, before, k) for k in (
                 "migrations_requested", "migration_resumes",
                 "migration_direct", "migration_reruns")}}
    say("  (b) " + json.dumps(stats))
    need(asked and stats["migrations_requested"] >= 1,
         "18 (b): no migration requested")
    need(stats["migration_resumes"] + stats["migration_reruns"] >= 1,
         "18 (b): the migration moved no request")
    need(got == want, "18 (b): the migrated streams differ from the "
         "undisturbed run's")
    need(all(s == g for s, g in zip(streamed, got)),
         "18 (b): a streamed concatenation differs from its reply")
    say(f"  (b) {len(got)} of {len(got)} requests complete, the victim "
        f"held {in_flight} when drained and migrated "
        f"({stats['migration_resumes']} resumed, "
        f"{stats['migration_direct']} pushed directly, "
        f"{stats['migration_reruns']} rerun); every stream equal to the "
        f"undisturbed run's")
    return stats


def front_disagg(FleetServer, cfg, reqs, ref, next_logits):
    """Phase 18 (c)."""
    import os

    t0 = time.perf_counter()
    fleet = FleetServer(replicas=0, prefill_replicas=1, decode_replicas=1,
                        **FRONT_DOOR).start()
    try:
        up_s = time.perf_counter() - t0
        pids = replica_pids([os.getpid()])
        need(len(pids) == 2, f"18 (c): replica processes {pids}")
        addrs = sorted(r.addr for r in fleet.registry.alive())
        fleet_requests(fleet, [FleetReq(list(range(1, 9)), 2)] * 2, 3)
        before = fleet_counters(fleet)
        zero = replica_stats(addrs, fleet.token, reset=True)
        replies, _, first, wall = fleet_requests(fleet, reqs)
        launches = replica_launches(
            cfg, zero, settled_stats(addrs, fleet.token), "18 (c)")
        after = fleet_counters(fleet)
    finally:
        fleet.stop()
    need(not pids_alive(pids), f"18 (c): replica processes "
         f"{pids_alive(pids)} outlived FleetServer.stop()")
    got = [r["tokens"] for r in replies]
    identical, gaps = divergence_gaps(ref, dict(enumerate(got)),
                                      next_logits, "18 (c)")
    moved = delta(after, before, "kv_transfer_bytes")
    need(delta(after, before, "disagg_requests") == len(reqs)
         and moved > 0, f"18 (c): disagg_requests "
         f"{delta(after, before, 'disagg_requests')}, kv bytes {moved}")
    need(launches["flash_fwd"] > 0 and launches["flash_decode_paged"] > 0,
         f"18 (c): the replicas launched {launches}")
    decode_ms = [r["decode_ms"] for r in replies]
    stats = {"fleet_up_s": up_s, "requests": len(got), "wall_s": wall,
             "launches": launches,
             "kv_mb": moved / 1e6, "decode_ms": decode_ms,
             "decode_ms_mean": statistics.mean(decode_ms),
             "ttft_ms_mean": statistics.mean(r["ttft_ms"] for r in replies),
             "streams_identical": identical, "divergence_gaps": gaps}
    say("  (c) " + json.dumps(stats))
    say(f"  (c) disaggregated fleet up in {up_s:.1f} s; {identical} of "
        f"{len(got)} streams identical to phase 5's, {len(gaps)} differ "
        f"first at a near-tie; {moved / 1e6:.1f} MB of KV moved; replies' "
        f"decode_ms mean {stats['decode_ms_mean']:.3f}")
    return stats


def front_cli(reqs, ref, next_logits):
    """Phase 18 (d): ``tfserve`` as a process."""
    import os
    import signal
    import threading

    token = "front-door-cli"
    env = dict(os.environ, TPUMESOS_TOKEN=token)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TPUMESOS_TOKEN_FILE", None)
    cli = [sys.executable, "-m", "tfmesos_tpu_torch.cli"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cli + ["serve"] + CLI_SERVE,
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    timer = threading.Timer(300.0, proc.kill)
    timer.start()
    lines, pids = [], []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("tfserve: gateway on"):
                break
        timer.cancel()
        need(lines and lines[-1].startswith("tfserve: gateway on"),
             f"18 (d): no banner: {lines[-20:]}")
        up_s = time.perf_counter() - t0
        gw = lines[-1].split()[3]
        pids = replica_pids([proc.pid])
        need(len(pids) == 1, f"18 (d): replica processes {pids}")
        prompt = ",".join(str(int(x)) for x in reqs[0].prompt)
        sub = subprocess.run(cli + ["submit", "-g", gw, "--prompt", prompt,
                                    "-n", "8"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        need(sub.returncode == 0, f"18 (d): submit: {sub.stderr[-2000:]}")
        rows = sub.stdout.strip().splitlines()
        need(len(rows) == 1, f"18 (d): submit printed {rows}")
        tokens = json.loads(rows[0])["tokens"]
        identical, gaps = divergence_gaps({0: ref[0][:8]}, {0: tokens},
                                          next_logits, "18 (d)")
        met = subprocess.run(cli + ["metrics", "-g", gw], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        need(met.returncode == 0, f"18 (d): metrics: {met.stderr[-2000:]}")
        proc.send_signal(signal.SIGINT)
        tail, _ = proc.communicate(timeout=120)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    need(proc.returncode == 0, f"18 (d): tfserve exit code "
         f"{proc.returncode}: {tail[-2000:]}")
    need(not pids_alive(pids), f"18 (d): replica {pids_alive(pids)} "
         f"outlived tfserve")
    out = {"up_s": up_s, "banner": lines[-1], "submit_tokens": tokens,
           "identical": identical, "divergence_gaps": gaps,
           "metrics_rc": met.returncode, "exit_code": proc.returncode,
           "replica_pids": pids}
    say("  (d) " + json.dumps(out))
    say(f"  (d) tfserve up in {up_s:.1f} s; submit's 8 tokens "
        f"{'identical to' if identical else 'within the margin of'} "
        f"phase 5's; metrics exit 0; exit 0 on SIGINT, no replica left")
    return out


# Phase 19's traffic: 8 conversations (seed 19) of 4 turns, as a chat
# client sends them: turn 0 a prompt of 200..400 tokens, each later turn
# the whole history (prompts and replies) plus 40..120 new tokens, 32
# new tokens a turn, greedy.
SESSIONS, SESSION_TURNS, SESSION_NEW = 8, 4, 32
SESSION_SHAPE = dict(rows=8, page_size=64, prefill_bucket=64)
SESSION_TIER_BYTES = int(512e6)


def session_traffic(np, cfg):
    """(turn 0's prompts, each conversation's new tokens of turns 1..3),
    token lists."""
    rng = np.random.RandomState(19)
    firsts = [rng.randint(0, cfg.vocab_size, n).tolist()
              for n in rng.randint(200, 401, size=SESSIONS)]
    news = [[rng.randint(0, cfg.vocab_size, n).tolist()
             for n in rng.randint(40, 121, size=SESSION_TURNS - 1)]
            for _ in range(SESSIONS)]
    return firsts, news


def add_counts(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    return total


def session_logits(torch, cfg, params, prompts):
    """``next_logits((i, t), prefix)``: the float32 CPU logits after
    conversation i's turn-t prompt and ``prefix``."""
    from tfmesos_tpu_torch.models.transformer import forward

    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)

    def next_logits(key, prefix):
        i, t = key
        with torch.no_grad():
            return forward(cpu_cfg, params, torch.tensor(
                [prompts[t][i] + prefix]))[0, -1]

    return next_logits


def sync_ms(torch, fn, reps=5):
    """Median wall ms of ``fn`` between two device syncs."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_sessions(torch, np):
    """Phase 19: the KV tier and sessions.  (a) in process, a batcher with
    a tier against one without, over the same full-history prompts; (b)
    prefix pages spilled and promoted; (c) the front door over two
    replica processes with a tier each and a shared directory, the
    busier one stopped before the last turn and its sessions resumed
    from the directory; (d) the fabric: a ``--role
    kv`` holder keeps the replicated parks, the parking replica is
    stopped and the other resumes from the holder."""
    from tfmesos_tpu_torch.fleet.launcher import FleetServer
    from tfmesos_tpu_torch.models.presets import flagship_model

    say("[19/28] the KV tier and sessions: flagship, rows 8, page 64, "
        "bucket 64, 8 conversations of 4 turns")
    cfg, params = flagship_model(seed=0, max_len=1024)
    card = _cuda(params)
    out = {}
    out["a"], prompts, replies = sessions_in_process(torch, np, cfg,
                                                     params, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["b"] = sessions_spill(torch, np, cfg, card)
    del card
    gc.collect()
    torch.cuda.empty_cache()
    next_logits = session_logits(torch, cfg, params, prompts)
    out["c"] = sessions_front_door(cfg, FleetServer, prompts, replies,
                                   next_logits)
    out["d"] = sessions_fabric(cfg, FleetServer, prompts, replies,
                               next_logits)
    return out


def sessions_in_process(torch, np, cfg, params, card):
    """Phase 19 (a): the conversations on a warmed batcher with a tier
    (``prefix_cache_pages=64``, 512 MB of RAM) and, turn by turn, the
    same prompts on a warmed batcher without one.  Parks 32 and resumes
    24; every resumed turn runs no flash_fwd and one tail call (exact
    launch counts a run); no graph captured after warmup; the replies by
    the margin rule against the cold ones.  Times the parks (host ms
    and MB), the installs (host ms in the run; and with the device
    synced, beside the export gather), TTFT and ms a tick."""
    from tfmesos_tpu_torch import serving as ts
    from tfmesos_tpu_torch.fleet.kvtier import KVTierStore

    tier = KVTierStore(ram_bytes=SESSION_TIER_BYTES)
    b = ts.ContinuousBatcher(cfg, card, prefix_cache_pages=64, kv_tier=tier,
                             device="cuda", **SESSION_SHAPE)
    cold = ts.ContinuousBatcher(cfg, card, device="cuda", **SESSION_SHAPE)
    need(b.kv_tier_bypass_reason is None, f"19 (a): the tier bypassed: "
         f"{b.kv_tier_bypass_reason}")
    warmed = {}
    for name, x in (("tier", b), ("cold", cold)):
        info = x.warmup()
        warmed[name] = (x._graphs.keys(), info)
        list(x.run([ts.Request(np.arange(1, 9), 2)]))   # handles, pools
    park_ms, park_bytes, install_ms = [], [], []
    park, store_park, install = b._park_session, tier.park, ts._install_pages

    def timed_park(r, state):
        t0 = time.perf_counter()
        park(r, state)
        park_ms.append((time.perf_counter() - t0) * 1e3)

    def sized_park(sid, meta, body):
        park_bytes.append(len(body))
        return store_park(sid, meta, body)

    def timed_install(pool, payload, ids):
        t0 = time.perf_counter()
        install(pool, payload, ids)
        install_ms.append(((time.perf_counter() - t0) * 1e3, ids.numel()))

    b._park_session, tier.park, ts._install_pages = (timed_park, sized_park,
                                                     timed_install)
    runs = {"tier": [], "cold": []}
    cold_replies = []

    def serve_turn(t, prompts):
        got = {}
        for name, x in (("tier", b), ("cold", cold)):
            reqs = [ts.Request(np.asarray(p), SESSION_NEW, session_id=(
                f"conv-{i}" if name == "tier" else None))
                for i, p in enumerate(prompts)]
            label = f"19 (a) {name} turn {t}"
            comps, launches, wall, shapes = counted_run(
                torch, cfg, x, reqs, False, label)
            by = {id(c.request): c for c in comps}
            done = [by[id(r)] for r in reqs]
            need(all(len(c.tokens) == SESSION_NEW for c in done),
                 f"{label}: a request did not complete its tokens")
            if name == "tier" and t:
                need(x.prefills == 0 and x.tail_prefills == SESSIONS
                     and launches["flash_fwd"] == 0,
                     f"{label}: {x.prefills} prefills, {x.tail_prefills} "
                     f"tails, launches {launches}")
            runs[name].append({
                "ttft_ms": [c.ttft_s * 1e3 for c in done],
                "wall_s": wall, "ticks": x.decode_ticks,
                "decode_s": x.decode_seconds, "prefills": x.prefills,
                "tails": x.tail_prefills, "chunk_shapes": shapes,
                "launches": launches})
            got[name] = [list(c.tokens) for c in done]
        cold_replies.append(got["cold"])
        return got["tier"]

    firsts, news = session_traffic(np, cfg)
    prompts, replies = [firsts], []
    try:
        for t in range(SESSION_TURNS):
            replies.append(serve_turn(t, prompts[t]))
            if t + 1 < SESSION_TURNS:
                prompts.append([p + r + news[i][t] for i, (p, r) in
                                enumerate(zip(prompts[t], replies[t]))])
    finally:
        ts._install_pages = install
        del b._park_session, tier.park
    need(max(map(len, prompts[-1])) + SESSION_NEW <= 992,
         f"19 (a): a history outgrew 992 positions")
    for name, x in (("tier", b), ("cold", cold)):
        no_new_graphs(x, warmed[name][0], f"19 (a) {name}")
    st = tier.stats()
    need(st["park"] == SESSIONS * SESSION_TURNS
         and st["resume"] == SESSIONS * (SESSION_TURNS - 1),
         f"19 (a): parks {st['park']}, resumes {st['resume']}")
    key = [(i, t) for t in range(SESSION_TURNS) for i in range(SESSIONS)]
    identical, gaps = divergence_gaps(
        {k: cold_replies[k[1]][k[0]] for k in key},
        {k: replies[k[1]][k[0]] for k in key},
        session_logits(torch, cfg, params, prompts), "19 (a)")
    # The install and the export gather alone, the device synced: the
    # largest parked artifact written onto (and read from) the sink page.
    art = ts.unpack_prefilled(*tier.get("session", max(
        (f"conv-{i}" for i in range(SESSIONS)),
        key=lambda s: len(prompts[-1][int(s[5:])]))))
    n = art["k"].shape[1]
    sink = torch.full((n,), b.t_side.sink, dtype=torch.long, device=b.device)
    payload = [ts._as_tensor(art["k"]), ts._as_tensor(art["v"])]
    alone = {"pages": n, "mb": sum(x.numel() * x.element_size()
                                   for x in payload) / 1e6,
             "install_ms": sync_ms(torch, lambda: ts._install_pages(
                 b.pool, payload, sink)),
             "gather_ms": sync_ms(torch, lambda: ts._gather_pages(
                 b.pool, sink))}

    def resumed(name, key):
        return [x for r in runs[name][1:] for x in r[key]]

    def per_tick(name, key):
        rs = runs[name][1:]
        return sum(r[key] for r in rs) / sum(r["ticks"] for r in rs) * 1e3

    session_installs = [ms for ms, _ in install_ms]
    stats = {
        "conversations": SESSIONS, "turns": SESSION_TURNS,
        "history_positions_max": max(map(len, prompts[-1])) + SESSION_NEW,
        "tier": {k: st[k] for k in ("park", "resume", "spills", "promotions",
                                    "hits", "misses", "evictions")},
        "prefix_cache": b.prefix_cache_stats(),
        "streams_identical": identical, "divergence_gaps": gaps,
        "ttft_ms_resumed_mean": statistics.mean(resumed("tier", "ttft_ms")),
        "ttft_ms_resumed_p50": statistics.median(resumed("tier", "ttft_ms")),
        "ttft_ms_cold_mean": statistics.mean(resumed("cold", "ttft_ms")),
        "ttft_ms_cold_p50": statistics.median(resumed("cold", "ttft_ms")),
        "ttft_ms_turn0_mean": statistics.mean(runs["tier"][0]["ttft_ms"]),
        "park_ms_mean": statistics.mean(park_ms),
        "park_ms_max": max(park_ms),
        "park_mb_mean": statistics.mean(park_bytes) / 1e6,
        "park_mb_max": max(park_bytes) / 1e6,
        "install_ms_in_run_mean": statistics.mean(session_installs),
        "install_ms_in_run_max": max(session_installs),
        "install_pages": [p for _, p in install_ms],
        "synced_largest": alone,
        "ms_per_tick_with_parks": per_tick("tier", "decode_s"),
        "ms_per_tick_without": per_tick("cold", "decode_s"),
        "wall_ms_per_tick_with_parks": per_tick("tier", "wall_s"),
        "wall_ms_per_tick_without": per_tick("cold", "wall_s"),
        "warmup_names": {k: len(v[1]["compiled"])
                         for k, v in warmed.items()},
        "warmup_s": {k: v[1]["seconds"] for k, v in warmed.items()},
        "launches": {f"{name} turn {t}": r["launches"]
                     for name, rs in runs.items()
                     for t, r in enumerate(rs)}}
    say("  (a) " + json.dumps(stats))
    say(f"  (a) {identical} of {len(key)} replies identical to the cold "
        f"batcher's, {len(gaps)} differ first at a near-tie; parks "
        f"{st['park']}, resumes {st['resume']}, no flash_fwd on a resumed "
        f"turn; TTFT resumed mean {stats['ttft_ms_resumed_mean']:.3f} p50 "
        f"{stats['ttft_ms_resumed_p50']:.3f} ms against cold mean "
        f"{stats['ttft_ms_cold_mean']:.3f} p50 "
        f"{stats['ttft_ms_cold_p50']:.3f}; a park {stats['park_ms_mean']:.3f}"
        f" ms of {stats['park_mb_mean']:.2f} MB (max "
        f"{stats['park_ms_max']:.3f} ms, {stats['park_mb_max']:.2f} MB), an "
        f"install {stats['install_ms_in_run_mean']:.3f} ms host (synced: "
        f"{alone['install_ms']:.3f} ms for {n} pages, the export gather "
        f"{alone['gather_ms']:.3f}); ms a tick "
        f"{stats['ms_per_tick_with_parks']:.4f} with parks, "
        f"{stats['ms_per_tick_without']:.4f} without (wall a tick "
        f"{stats['wall_ms_per_tick_with_parks']:.4f} vs "
        f"{stats['wall_ms_per_tick_without']:.4f})")
    return stats, prompts, replies


def sessions_spill(torch, np, cfg, card):
    """Phase 19 (b): phase 14's shared-prompt traffic with a prefix cache
    of 8 pages, the size of one system prompt, and a tier: its first 8
    requests (system prompt A), 8 of another system prompt B (whose
    pages evict A's: spills), then its last 8 (A's pages promoted back):
    streams equal to a batcher whose 64-page cache keeps both, exact
    launch counts."""
    from tfmesos_tpu_torch import serving as ts
    from tfmesos_tpu_torch.fleet.kvtier import KVTierStore

    reqs14 = phase14_requests(np, cfg)
    rng = np.random.RandomState(119)
    sys_b = rng.randint(0, cfg.vocab_size, SYSTEM_LEN)
    traffic = (("A", [r.prompt for r in reqs14[:8]]),
               ("B", [np.concatenate([sys_b, rng.randint(
                   0, cfg.vocab_size, r.prompt.size - SYSTEM_LEN)])
                      for r in reqs14[8:]]),
               ("A again", [r.prompt for r in reqs14[8:]]))
    tier = KVTierStore(ram_bytes=SESSION_TIER_BYTES)
    sides = {"tier": ts.ContinuousBatcher(cfg, card, prefix_cache_pages=8,
                                          kv_tier=tier, device="cuda",
                                          **SESSION_SHAPE),
             "reference": ts.ContinuousBatcher(cfg, card,
                                               prefix_cache_pages=64,
                                               device="cuda",
                                               **SESSION_SHAPE)}
    warmed = {}
    for name, x in sides.items():
        x.warmup()
        warmed[name] = x._graphs.keys()
        list(x.run([ts.Request(np.arange(1, 9), 2)]))
    runs = {}
    for label, prompts in traffic:
        got = {}
        for name, x in sides.items():
            comps, launches, wall, _ = counted_run(
                torch, cfg, x, [ts.Request(p, 32) for p in prompts], False,
                f"19 (b) {label} {name}")
            got[name] = streams(comps)
            ttft = [c.ttft_s * 1e3 for c in comps]
            runs[f"{label} {name}"] = {
                "ttft_ms_mean": statistics.mean(ttft),
                "tails": x.tail_prefills, "prefills": x.prefills,
                "launches": launches, "tier": dict(tier.stats())
                if name == "tier" else None}
        need(got["tier"] == got["reference"], f"19 (b) {label}: the tier "
             f"batcher's streams differ from the reference's")
    for name, x in sides.items():
        no_new_graphs(x, warmed[name], f"19 (b) {name}")
    st = tier.stats()
    need(st["spills"] > 0 and st["promotions"] > 0,
         f"19 (b): spills {st['spills']}, promotions {st['promotions']}")
    stats = {"spills": st["spills"], "promotions": st["promotions"],
             "prefix_cache": sides["tier"].prefix_cache_stats(),
             "runs": runs,
             "streams_identical": sum(len(p) for _, p in traffic)}
    say("  (b) " + json.dumps(stats))
    say(f"  (b) {st['spills']} pages spilled, {st['promotions']} promoted; "
        f"{stats['streams_identical']} streams identical to the 64-page "
        f"cache's; TTFT of A "
        f"again {runs['A again tier']['ttft_ms_mean']:.3f} ms (promoted) "
        f"against {runs['A again reference']['ttft_ms_mean']:.3f} "
        f"(resident)")
    return stats


def fleet_turn(client, prompts, new, threads=4, only=None):
    """One turn of the conversations (those numbered ``only``, else all)
    through ``client``, ``threads`` at a time: the replies' token lists
    (None for a conversation not in ``only``)."""
    import threading

    idx = list(range(len(prompts))) if only is None else list(only)
    got, errors = [None] * len(prompts), []

    def worker(k):
        for i in idx[k::threads]:
            try:
                got[i] = client.generate(prompts[i], new,
                                         session=f"conv-{i}")["tokens"]
            except Exception as e:         # reported below
                errors.append((i, repr(e)))

    pool = [threading.Thread(target=worker, args=(k,))
            for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    need(not errors, f"session requests failed: {errors}")
    return got


def advertised(fleet):
    """{replica addr: the parked sessions its last heartbeat listed}."""
    return {r.addr: list((r.kv_tier or {}).get("sessions") or ())
            for r in fleet.registry.members()
            if isinstance(r.kv_tier, dict)}


def wait_parked(fleet, sessions, what):
    """Until every one of ``sessions`` rides some replica's heartbeat."""
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        held = {s for v in advertised(fleet).values() for s in v}
        if set(sessions) <= held:
            return
        time.sleep(0.05)
    need(False, f"{what}: parked sessions never advertised: "
         f"{advertised(fleet)}")


def expected_resumes(got, replies, turns):
    """Resumed turns expected: a later turn resumes exactly when the
    previous turn's reply equals phase 19 (a)'s (its prompt, (a)'s
    history, then extends the parked one)."""
    return sum(got[t - 1][i] == replies[t - 1][i]
               for t in turns if t for i in range(SESSIONS))


def stop_replica(fleet, addr, what):
    """Kill the replica serving on ``addr`` and wait until the registry
    no longer counts it alive."""
    node = [r.node for r in fleet.registry.members() if r.addr == addr][0]
    need(fleet.kill_replica(node), f"{what}: kill {node}")
    deadline = time.monotonic() + 30.0
    while addr in {r.addr for r in fleet.registry.alive()} \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    need(addr not in {r.addr for r in fleet.registry.alive()},
         f"{what}: {addr} still alive after its kill")


def tier_dir_of(pids):
    """The ``--kv-tier-dir`` every replica process ``pids`` was given
    (one directory, or the check fails)."""
    dirs = set()
    for pid in pids:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = [a.decode() for a in f.read().split(b"\0")]
        need("--kv-tier-dir" in argv, f"replica {pid} has no disk tier: "
             f"{argv}")
        dirs.add(argv[argv.index("--kv-tier-dir") + 1])
    need(len(dirs) == 1, f"replicas {pids} got the disk tiers {dirs}")
    return dirs.pop()


def disk_histories(tier_dir, token, sessions):
    """{session: parked history} of the sessions with an entry in the
    disk tier ``tier_dir``, read as a replica reads it (the HMAC under
    ``token`` checked); a RAM-less store writes nothing back."""
    from tfmesos_tpu_torch.fleet.kvtier import KVTierStore

    store = KVTierStore(ram_bytes=0, disk_dir=tier_dir, disk_bytes=1,
                        token=token)
    out = {}
    for sid in sessions:
        got = store.resume(sid)
        if got is not None:
            out[sid] = [int(t) for t in got[0]["history"]]
    return out


def tier_delta(after, before, key):
    return after["kv_tier"].get(key, 0) - before["kv_tier"].get(key, 0)


def sessions_front_door(cfg, FleetServer, prompts, replies, next_logits):
    """Phase 19 (c): ``FleetServer(replicas=2, kv_tier_mb=24)``: each
    replica's RAM tier holds about two parks (8-12 MB each), so the rest
    demote to the one disk directory the fleet makes for both, whose
    budget (4x RAM) holds every conversation: no disk eviction races a
    resume.  (a)'s prompts go through ``FleetClient.generate(
    session=...)``, 4 threads at a time.  Before the last turn the
    replica holding more sessions is stopped: the other resumes its own
    sessions, then the stopped one's from the shared directory (no
    fabric copy exists: one is held to 0 fetches)."""
    import os

    t0 = time.perf_counter()
    fleet = FleetServer(replicas=2, kv_tier_mb=24, **FRONT_DOOR).start()
    try:
        up_s = time.perf_counter() - t0
        pids = replica_pids([os.getpid()])
        need(len(pids) == 2, f"19 (c): replica processes {pids}")
        tier_dir = tier_dir_of(pids)
        addrs = sorted(r.addr for r in fleet.registry.alive())
        fleet_requests(fleet, [FleetReq(list(range(1, 9)), 2)] * 4, 5)
        before = fleet_counters(fleet)
        zero = replica_stats(addrs, fleet.token, reset=True)
        client = fleet.client(timeout=300.0)
        last = SESSION_TURNS - 1
        sessions = [f"conv-{i}" for i in range(SESSIONS)]
        try:
            got = []
            for t in range(last):
                got.append(fleet_turn(client, prompts[t], SESSION_NEW))
                wait_parked(fleet, sessions, f"19 (c) turn {t}")
            mid = settled_stats(addrs, fleet.token)
            launches = replica_launches(cfg, zero, mid, "19 (c) turns 0-2")
            held = advertised(fleet)
            victim = max(addrs, key=lambda a: len(held.get(a, ())))
            survivor = [a for a in addrs if a != victim][0]
            mine = set(held.get(survivor, ()))
            theirs = [i for i in range(SESSIONS)
                      if sessions[i] not in mine]
            own = [i for i in range(SESSIONS) if i not in theirs]
            on_disk = disk_histories(tier_dir, fleet.token,
                                     [sessions[i] for i in theirs])
            stop_replica(fleet, victim, "19 (c)")
            zero2 = replica_stats([survivor], fleet.token, reset=True)
            turn = fleet_turn(client, prompts[last], SESSION_NEW, only=own)
            part = settled_stats([survivor], fleet.token)
            moved = fleet_turn(client, prompts[last], SESSION_NEW,
                               threads=max(1, len(theirs)), only=theirs)
            end = settled_stats([survivor], fleet.token)
            add_counts(launches, replica_launches(
                cfg, zero2, end, "19 (c) the last turn"))
            got.append([moved[i] if i in theirs else turn[i]
                        for i in range(SESSIONS)])
        finally:
            client.close()
        counters = fleet_counters(fleet)
    finally:
        fleet.stop()
    need(not pids_alive(pids), f"19 (c): replica processes "
         f"{pids_alive(pids)} outlived FleetServer.stop()")
    need(not os.path.exists(tier_dir), f"19 (c): the fleet's disk tier "
         f"{tier_dir} outlived FleetServer.stop()")
    later = SESSIONS * (SESSION_TURNS - 1)
    hits = delta(counters, before, "session_affinity_hits")
    need(hits >= 18, f"19 (c): session affinity hit {hits} of {later} "
         f"later turns")
    early = sum(tier_delta(mid[a], zero[a], "resume") for a in addrs)
    want = expected_resumes(got, replies, range(last))
    need(early == want, f"19 (c): turns 0-2 resumed {early}, {want} "
         f"expected")
    # The survivor's own sessions resume from its RAM or the directory;
    # one both replicas list may have either copy.
    both = [i for i in own if sessions[i] in held.get(victim, ())]
    lo = sum(got[last - 1][i] == replies[last - 1][i]
             for i in own if i not in both)
    own_resumes = tier_delta(part[survivor], zero2[survivor], "resume")
    need(lo <= own_resumes <= lo + len(both), f"19 (c): the survivor "
         f"resumed {own_resumes} of its own, {lo}..{lo + len(both)} "
         f"expected")
    # The stopped replica's: exactly those whose directory entry extends
    # into the new prompt, none through the fabric.
    from_disk = sum(
        sessions[i] in on_disk
        and prompts[last][i][:len(on_disk[sessions[i]])]
        == on_disk[sessions[i]] for i in theirs)
    moved_resumes = tier_delta(end[survivor], part[survivor], "resume")
    fetched = tier_delta(end[survivor], zero2[survivor], "fabric_fetch_hit")
    need(mid[victim]["kv_tier"]["disk_entries"] > 0 and from_disk > 0,
         f"19 (c): the stopped replica left {len(on_disk)} sessions in "
         f"the directory ({mid[victim]['kv_tier']})")
    need(moved_resumes == from_disk and fetched == 0, f"19 (c): the "
         f"survivor resumed {moved_resumes} of the stopped replica's "
         f"{len(theirs)} sessions ({from_disk} resumable from the "
         f"directory) and fetched {fetched} through the fabric")
    key = [(i, t) for t in range(SESSION_TURNS) for i in range(SESSIONS)]
    identical, gaps = divergence_gaps(
        {k: replies[k[1]][k[0]] for k in key},
        {k: got[k[1]][k[0]] for k in key}, next_logits, "19 (c)")
    tiers = {a: mid[a]["kv_tier"] for a in addrs}
    stats = {"fleet_up_s": up_s, "affinity_hits": hits, "later_turns": later,
             "affinity_misses": delta(counters, before,
                                      "session_affinity_misses"),
             "sessions_held_before_stop": {a: len(v)
                                           for a, v in held.items()},
             "resumes_turns_0_2": {a: tier_delta(mid[a], zero[a], "resume")
                                   for a in addrs},
             "demotions_turns_0_2": {a: tier_delta(mid[a], zero[a],
                                                   "demotions")
                                     for a in addrs},
             "disk_entries_before_stop": {a: s["disk_entries"]
                                          for a, s in tiers.items()},
             "ram_entries_before_stop": {a: s["ram_entries"]
                                         for a, s in tiers.items()},
             "stopped_sessions": len(theirs),
             "stopped_sessions_on_disk": len(on_disk),
             "survivor_own_resumes": own_resumes,
             "survivor_disk_resumes": moved_resumes,
             "survivor_fabric_fetch_hits": fetched,
             "streams_identical": identical, "divergence_gaps": gaps,
             "launches": launches}
    say("  (c) " + json.dumps(stats))
    say(f"  (c) fleet up in {up_s:.1f} s; session affinity {hits} of "
        f"{later} later turns; turns 0-2 resumed {early}; the stopped "
        f"replica held {len(theirs)} sessions, {len(on_disk)} in the "
        f"shared directory; the survivor resumed {moved_resumes} of them "
        f"from it and {own_resumes} of its own {len(own)}, 0 through the "
        f"fabric; {identical} of {len(key)} replies identical to (a)'s, "
        f"{len(gaps)} differ first at a near-tie")
    return stats


def sessions_fabric(cfg, FleetServer, prompts, replies, next_logits):
    """Phase 19 (d): ``FleetServer(replicas=2, kv_tier_mb=512,
    kv_replicas=1, kv_replication=2)``: turn 0 parks replicate to the
    ``--role kv`` holder, which holds no card memory and lists them; the
    replica holding more sessions is stopped and turn 1 resumes them on
    the other by ``kv_fetch`` from the holder."""
    import os

    t0 = time.perf_counter()
    fleet = FleetServer(replicas=2, kv_tier_mb=512, kv_replicas=1,
                        kv_replication=2, **FRONT_DOOR).start()
    try:
        up_s = time.perf_counter() - t0
        pids = replica_pids([os.getpid()])
        need(len(pids) == 3, f"19 (d): replica processes {pids}")
        members = fleet.registry.members()
        holder = [r.addr for r in members if r.role == "kv"]
        servers = sorted(r.addr for r in members if r.role != "kv")
        need(len(holder) == 1 and len(servers) == 2,
             f"19 (d): holder {holder}, servers {servers}")
        fleet_requests(fleet, [FleetReq(list(range(1, 9)), 2)] * 4, 5)
        zero = replica_stats(servers, fleet.token, reset=True)
        client = fleet.client(timeout=300.0)
        try:
            got = [fleet_turn(client, prompts[0], SESSION_NEW)]
            sessions = [f"conv-{i}" for i in range(SESSIONS)]
            wait_parked(fleet, sessions, "19 (d) turn 0")
            first = settled_stats(servers, fleet.token)
            launches = replica_launches(cfg, zero, first, "19 (d) turn 0")
            kept = replica_stats(holder, fleet.token)[holder[0]]
            held = advertised(fleet)
            victim = max(servers, key=lambda a: len(held.get(a, ())))
            survivor = [a for a in servers if a != victim][0]
            stop_replica(fleet, victim, "19 (d)")
            zero = replica_stats([survivor], fleet.token, reset=True)
            got.append(fleet_turn(client, prompts[1], SESSION_NEW))
            last = settled_stats([survivor], fleet.token)
            add_counts(launches, replica_launches(cfg, zero, last,
                                                  "19 (d) turn 1"))
        finally:
            client.close()
    finally:
        fleet.stop()
    need(not pids_alive(pids), f"19 (d): processes {pids_alive(pids)} "
         f"outlived FleetServer.stop()")
    need(kept["torch_imported"] is False and kept["cuda_initialized"]
         is False and kept["memory_allocated"] == 0,
         f"19 (d): the holder {kept}")
    need(set(sessions) <= set(kept["summary"]["sessions"]),
         f"19 (d): the holder lists {kept['summary']['sessions']}")
    moved = len(held.get(victim, ()))
    tier = last[survivor]["kv_tier"]
    want = expected_resumes(got, replies, (0, 1))
    need(tier["resume"] == want and tier["fabric_fetch_hit"] >= min(
        moved, want), f"19 (d): the survivor resumed {tier['resume']} "
         f"({want} expected), fetched {tier.get('fabric_fetch_hit')} of "
         f"the victim's {moved}")
    key = [(i, t) for t in range(2) for i in range(SESSIONS)]
    identical, gaps = divergence_gaps(
        {k: replies[k[1]][k[0]] for k in key},
        {k: got[k[1]][k[0]] for k in key}, next_logits, "19 (d)")
    stats = {"fleet_up_s": up_s, "holder": {
        k: kept[k] for k in ("torch_imported", "cuda_initialized",
                             "memory_allocated", "device")},
        "holder_sessions": len(kept["summary"]["sessions"]),
        "holder_fabric_store": kept["kv_tier"].get("fabric_store", 0),
        "victim_sessions": moved, "survivor_resumes": tier["resume"],
        "survivor_fabric_fetch_hits": tier.get("fabric_fetch_hit", 0),
        "replicated": {a: s["kv_tier"].get("park_replicated", 0)
                       for a, s in first.items()},
        "streams_identical": identical, "divergence_gaps": gaps,
        "launches": launches}
    say("  (d) " + json.dumps(stats))
    say(f"  (d) fleet of two and a holder up in {up_s:.1f} s; the holder "
        f"(no torch, no CUDA context, 0 bytes on the card) kept "
        f"{stats['holder_sessions']} sessions; the stopped replica held "
        f"{moved}, the survivor resumed {tier['resume']} of 8, "
        f"{stats['survivor_fabric_fetch_hits']} fetched from the holder; "
        f"{identical} of {len(key)} replies identical to (a)'s, "
        f"{len(gaps)} differ first at a near-tie; no process left")
    return stats


# -- phase 20: speculative decoding, the static prefix, weight swaps -------

#: Phase 20's proposals a round.
SPEC_N_DRAFT = 4
#: Phase 20's schedule variants: (case, draft, batcher flags); "preset" is
#: flagship_draft_model (seed 1), "self" the target as its own draft.
SPEC_RUNS = (("a preset draft", "preset", {}),
             ("b self-draft", "self", {}),
             ("c self-draft multi_step=8", "self", {"multi_step": 8}),
             ("d self-draft overlap", "self", {"overlap": True}),
             ("e self-draft int8 draft pool", "self",
              {"draft_quantized_cache": True}))
#: (f)'s sampling.
SPEC_SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.9}


class SpecCounted:
    """Record what a speculative ``batcher`` dispatches from here on, its
    counters reset: each round dispatch's (target, draft) table widths,
    each draft prompt chunk's tokens, each target chunk call's (tokens,
    table width) and each admission prefill's width.  :meth:`want` is the
    launch counts that must follow: per dispatch R rounds (``multi_step``
    composed), each the draft's k+1 steps (draft-layers paged launches
    at t = 1) and the verify (target-layers paged launches at t = k+1);
    a full prefill's target-layers flash_fwd (or, after a static prefix,
    paged launches at the prompt width over an np_max-wide table); a
    draft chunk's draft-layers paged launches; merges wherever a
    launch's shape splits the kernel; one quant_int8_commit a call on an
    int8 pool (a draft step, a draft chunk, a verify, a prefill)."""

    def __init__(self, batcher):
        self.b = b = batcher
        self.rounds, self.dchunks, self.chunks, self.prefill_ws = \
            [], [], [], []
        dispatch, dchunk = b._spec_dispatch, b._draft_chunk_call
        width, prefill = b._chunk_width, b._prefill_call

        def rec_dispatch(*a):
            self.rounds.append(dispatch(*a))
            return self.rounds[-1]

        def rec_dchunk(row, tokens, pos):
            self.dchunks.append(int(tokens.size))
            return dchunk(row, tokens, pos)

        def rec_width(pos, t):
            w = width(pos, t)
            self.chunks.append((t, w))
            return w

        def rec_prefill(row, prompt, w, rid):
            self.prefill_ws.append(w)
            return prefill(row, prompt, w, rid)

        b._spec_dispatch, b._draft_chunk_call = rec_dispatch, rec_dchunk
        b._chunk_width, b._prefill_call = rec_width, rec_prefill
        for name in Counted.COUNTERS + ("spec_rounds", "spec_row_rounds",
                                        "spec_committed"):
            setattr(b, name, 0)
        b.decode_seconds = 0.0

    def close(self) -> None:
        for name in ("_spec_dispatch", "_draft_chunk_call", "_chunk_width",
                     "_prefill_call"):
            delattr(self.b, name)

    def want(self, cfg, label):
        from tfmesos_tpu_torch.ops import attention as ta
        from tfmesos_tpu_torch.ops.quant import QTensor

        b = self.b
        dcfg = b.draft_cfg
        L, Ld, ps, k1 = cfg.n_layers, dcfg.n_layers, b.page_size, \
            b.n_draft + 1
        R = max(1, b._spec_rounds)
        n = len(self.rounds)
        need(n == b.decode_ticks and len(self.prefill_ws) == b.prefills
             and len(self.chunks) == b.tail_prefills + b.prefill_chunks,
             f"{label}: {n} round dispatches for {b.decode_ticks} ticks, "
             f"{len(self.prefill_ws)} prefill widths for {b.prefills} "
             f"prefills, {len(self.chunks)} chunk widths")
        wide = b.np_max * ps
        prefixed = b.prefix_len > 0
        t_calls = R * n + len(self.chunks) + (len(self.prefill_ws)
                                              if prefixed else 0)
        merges = (L * (R * sum(paged_split(ta, cfg, b.rows, k1, tw * ps)
                               for tw, _ in self.rounds)
                       + sum(paged_split(ta, cfg, 1, t, w * ps)
                             for t, w in self.chunks)
                       + (sum(paged_split(ta, cfg, 1, w, wide)
                              for w in self.prefill_ws) if prefixed else 0))
                  + Ld * (R * k1 * sum(paged_split(ta, dcfg, b.rows, 1,
                                                   dw * ps)
                                       for _, dw in self.rounds)
                          + sum(paged_split(ta, dcfg, 1, t, wide)
                                for t in self.dchunks)))
        int8_t = isinstance(b.pool["k"], QTensor)
        int8_d = isinstance(b.dpool["k"], QTensor)
        commits = ((len(self.prefill_ws) + t_calls - (
            len(self.prefill_ws) if prefixed else 0)) if int8_t else 0) \
            + ((R * k1 * n + len(self.dchunks)) if int8_d else 0)
        return {"flash_fwd": 0 if prefixed else L * len(self.prefill_ws),
                "flash_decode_paged": L * t_calls
                + Ld * (R * k1 * n + len(self.dchunks)),
                "flash_decode_paged_merge": merges, "quant_int8": 0,
                "quant_int8_commit": commits, "flash_decode": 0,
                "flash_decode_merge": 0, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}


def spec_run(torch, cfg, batcher, reqs, label):
    """Serve ``reqs`` once under :class:`SpecCounted`, every launch count
    zeroed just before and read just after, the exact counts required.
    Returns (completions, stats: rounds and dispatches, tokens a round,
    the acceptance rate, ms a dispatch and a round, decode tokens/s,
    TTFT mean and p50, launches)."""
    counted = SpecCounted(batcher)
    zero_launches()
    t0 = time.perf_counter()
    try:
        comps = list(batcher.run(reqs))
        torch.cuda.synchronize()
    finally:
        counted.close()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = counted.want(cfg, label)
    b = batcher
    need(launches == want, f"{label} launches {launches} != {want} "
         f"({b.prefills} prefills, {b.tail_prefills} tails, "
         f"{len(counted.dchunks)} draft chunks, {b.decode_ticks} dispatches "
         f"of R {max(1, b._spec_rounds)})")
    new = reqs[0].max_new_tokens
    need(len(comps) == len(reqs)
         and all(len(c.tokens) == new for c in comps),
         f"{label}: {len(comps)} of {len(reqs)} requests completed")
    ticks = b.decode_ticks
    ttft = sorted(c.ttft_s * 1e3 for c in comps)
    return comps, {
        "requests": len(comps), "wall_s": wall, "dispatches": ticks,
        "rounds": b.spec_rounds, "row_rounds": b.spec_row_rounds,
        "committed": b.spec_committed,
        "tokens_per_round": b.spec_committed / max(1, b.spec_row_rounds),
        "acceptance_rate": b.acceptance_rate,
        "decode_tokens": b.decode_tokens,
        "decode_tok_per_s": b.decode_tokens / b.decode_seconds,
        "ms_per_dispatch": b.decode_seconds / ticks * 1e3,
        "ms_per_round": b.decode_seconds / max(1, b.spec_rounds) * 1e3,
        "ttft_ms_mean": statistics.mean(ttft),
        "ttft_ms_p50": statistics.median(ttft),
        "table_widths": sorted({w for w in counted.rounds}),
        "launches": launches}


def spec_batcher(cfg, card, draft, **kw):
    """A warmed flagship speculative batcher (rows 8, page 64, bucket 64,
    n_draft 4): the preset draft (seed 1) or the target itself; returns
    (batcher, warmup names, the graph keys warmup left)."""
    from tfmesos_tpu_torch.models.presets import flagship_draft_model
    from tfmesos_tpu_torch.serving import ContinuousBatcher

    if draft == "self":
        dcfg = dataclasses.replace(
            cfg, max_seq_len=cfg.max_seq_len + SPEC_N_DRAFT + 1)
        dparams = card
    else:
        dcfg, dparams = flagship_draft_model(seed=1, max_len=1024,
                                             n_draft=SPEC_N_DRAFT,
                                             device="cuda")
    b = ContinuousBatcher(cfg, card, rows=8, page_size=64,
                          prefill_bucket=64, draft_cfg=dcfg,
                          draft_params=dparams, n_draft=SPEC_N_DRAFT,
                          device="cuda", **kw)
    info = b.warmup()
    need(any(n.startswith("spec_round[") for n in info["compiled"])
         and any(n.startswith("draft_chunk[") for n in info["compiled"])
         and not any(n.startswith("decode[") for n in info["compiled"]),
         f"speculative warmup prepared {info['compiled']}")
    return b, info, b._graphs.keys()


def spec_say(label, stats, ref):
    say(f"  {label}: {stats['streams_identical']} of {stats['requests']} "
        f"streams identical to the non-speculative run's, "
        f"{len(stats['divergence_gaps'])} differ first at a near-tie; "
        f"tokens a round {stats['tokens_per_round']:.3f}, acceptance "
        f"{stats['acceptance_rate']:.4f}; ms a dispatch "
        f"{stats['ms_per_dispatch']:.4f} (non-spec tick "
        f"{ref['ms_per_tick']:.4f}), decode tok/s "
        f"{stats['decode_tok_per_s']:.1f} (non-spec "
        f"{ref['decode_tok_per_s']:.1f}), TTFT mean "
        f"{stats['ttft_ms_mean']:.3f} p50 {stats['ttft_ms_p50']:.3f} "
        f"(non-spec {ref['ttft_ms_mean']:.3f} / {ref['ttft_ms_p50']:.3f}); "
        f"0 captures after warmup")


def phase_spec(torch, np, reqs, base, stats5, base14, stats14):
    """Phase 20: speculative decoding, the static prefix and weight swaps
    on the flagship (rows 8, page 64, bucket 64; the draft
    ``flagship_draft_model`` seed 1 or the self-draft, n_draft 4).  (a)-(e)
    phase 5's traffic under the variants of :data:`SPEC_RUNS`, (f) the
    self-draft sampled at T 0.8 / top-k 50 / top-p 0.9, (g) phase 14's
    traffic with ``prefix=`` its 512-token system prompt and the
    self-draft, (h) weight swaps on a warmed batcher, (i)
    ``speculative_generate`` against ``generate``, (j) a ``--draft``
    replica process behind a registry.  Each serving case on a fresh
    warmed batcher: streams against the non-speculative run of the same
    traffic by the margin rule, exact launch counts, no capture after
    warmup."""
    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.models.transformer import forward

    say("[20/28] speculative decoding, the static prefix and weight swaps: "
        f"flagship, rows 8, page 64, bucket 64, n_draft {SPEC_N_DRAFT}")
    cfg, params = flagship_model(seed=0, max_len=1024)
    card = _cuda(params)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ref = dict(enumerate(base))

    def next_logits(i, prefix, reqs=reqs):
        prompt = [int(x) for x in reqs[i].prompt]
        with torch.no_grad():
            return forward(cpu_cfg, params,
                           torch.tensor([prompt + prefix]))[0, -1]

    out = {}
    for label, draft, kw in SPEC_RUNS:
        b, info, warmed = spec_batcher(cfg, card, draft, **kw)
        comps, stats = spec_run(torch, cfg, b, reqs, label)
        no_new_graphs(b, warmed, label)
        identical, gaps = divergence_gaps(ref, dict(enumerate(
            streams(comps))), next_logits, label)
        stats.update(streams_identical=identical, divergence_gaps=gaps,
                     warmup_seconds=info["seconds"],
                     warmup_graphs=len(info["compiled"]),
                     graph_pool_mib=b._graphs.pool_bytes / 2 ** 20,
                     captures_after_warmup=0)
        if draft == "self":
            need(stats["acceptance_rate"] >= 0.9, f"{label}: a self-draft "
                 f"accepted only {stats['acceptance_rate']}")
        say(f"  {label}: " + json.dumps(stats))
        spec_say(label, stats, stats5)
        out[label] = stats
        del b
        gc.collect()
        torch.cuda.empty_cache()
    out["f self-draft sampled"] = spec_sampled(torch, np, cfg, card, params,
                                               reqs)
    out["g static prefix"] = spec_prefix(torch, np, cfg, card, params,
                                         base14, stats14)
    out["h weight swaps"] = spec_swaps(torch, np, cfg, card, reqs)
    out["i speculative_generate"] = spec_generate(torch, cfg, card)
    out["j replica --draft"] = spec_replica(torch, cfg, reqs, ref,
                                            next_logits, stats5)
    return out


def spec_sampled(torch, np, cfg, card, params, reqs):
    """(f): phase 5's traffic sampled (:data:`SPEC_SAMPLED`, the same rng
    key) without and with the self-draft.  A proposal is drawn under the
    target-only stream's key of its position, but a round's last token
    (the bonus after k accepted proposals, or the correction at a
    rejection) under ``fold_in(key, 2)``: a stream follows the
    target-only one up to its first round's bonus (token k+1) and forks
    there, by design.  Every stream is held to the target-only draw by
    the sampled margin rule up to its first difference, the forks are
    counted and printed, and the self-draft's acceptance must be
    high."""
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.ops import prng
    from tfmesos_tpu_torch.serving import ContinuousBatcher

    label = "f self-draft sampled"
    seed = 7
    rng = prng.PRNGKey(seed, "cuda")
    plain = ContinuousBatcher(cfg, card, rows=8, page_size=64,
                              prefill_bucket=64, rng=rng, device="cuda",
                              **SPEC_SAMPLED)
    plain.warmup()
    want, wstats = serve_run(torch, cfg, plain, reqs, False)
    del plain
    b, info, warmed = spec_batcher(cfg, card, "self", rng=rng,
                                   **SPEC_SAMPLED)
    comps, stats = spec_run(torch, cfg, b, reqs, label)
    no_new_graphs(b, warmed, label)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = _to(params, "cpu")
    by_rid = {c.rid: c for c in want}
    identical, forks, checked = 0, [], 0
    for c in sorted(comps, key=lambda c: c.rid):
        w = by_rid[c.rid].tokens
        n = next((j for j in range(len(w)) if w[j] != c.tokens[j]), len(w))
        if n == len(w):
            identical += 1
        else:
            forks.append({"stream": c.rid, "token": n})
        if n == 0 or c.rid >= 6:
            continue
        prompt = [int(x) for x in c.request.prompt]
        seq = torch.tensor([prompt + c.tokens[:n - 1]])
        with torch.no_grad():
            ref = tt.forward(cpu_cfg, cpu_params, seq)[
                0, len(prompt) - 1:].float()
        keys = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), c.rid),
                            torch.arange(n))
        ch, _, _ = sampled_margin(torch, ref, torch.tensor(c.tokens[:n]),
                                  prng.gumbel(keys, (cfg.vocab_size,)),
                                  SPEC_SAMPLED)
        checked += ch
    need(checked >= MIN_CHECKED, f"{label}: only {checked} positions above "
         f"the margin")
    need(stats["acceptance_rate"] >= 0.9, f"{label}: a self-draft accepted "
         f"only {stats['acceptance_rate']}")
    stats.update(streams_identical=identical, forks=forks,
                 margin_checked=checked, warmup_seconds=info["seconds"],
                 divergence_gaps=forks, captures_after_warmup=0)
    say(f"  {label}: " + json.dumps(stats))
    say(f"  {label}: {identical} of {len(comps)} streams identical to the "
        f"target-only sampled run's, {len(forks)} fork at a round's bonus "
        f"or correction draw ({forks}); tokens a round "
        f"{stats['tokens_per_round']:.3f}, "
        f"acceptance {stats['acceptance_rate']:.4f}; ms a dispatch "
        f"{stats['ms_per_dispatch']:.4f} (target-only tick "
        f"{wstats['ms_per_tick']:.4f}), decode tok/s "
        f"{stats['decode_tok_per_s']:.1f} (target-only "
        f"{wstats['decode_tok_per_s']:.1f}), TTFT mean "
        f"{stats['ttft_ms_mean']:.3f} (target-only "
        f"{wstats['ttft_ms_mean']:.3f})")
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def spec_prefix(torch, np, cfg, card, params, base14, stats14):
    """(g): phase 14's traffic as prompts after ``prefix=`` its 512-token
    system prompt (prefilled once into shared pages; the prompts then
    prefill as chunks over the paged pool), with the self-draft, against
    phase 14 (a)'s prefix-cache run of the whole prompts."""
    from tfmesos_tpu_torch.serving import Request

    label = "g static prefix + self-draft"
    reqs14 = phase14_requests(np, cfg)
    system = reqs14[0].prompt[:SYSTEM_LEN]
    need(all(np.array_equal(r.prompt[:SYSTEM_LEN], system) for r in reqs14),
         f"{label}: phase 14's prompts do not share their system prompt")
    reqs = [Request(r.prompt[SYSTEM_LEN:], r.max_new_tokens)
            for r in reqs14]
    b, info, warmed = spec_batcher(cfg, card, "self", prefix=system)
    need(b.prefix_len == SYSTEM_LEN and b.t_side.shared_len == SYSTEM_LEN
         and b.d_side.shared_len == SYSTEM_LEN,
         f"{label}: shared {b.t_side.shared_len}")
    widths = [n for n in info["compiled"] if n.startswith("prefill[")]
    need(widths == [f"prefill[{w}]" for w in b._prefill_widths()]
         and b._prefill_widths()[-1] == b.max_len - SYSTEM_LEN,
         f"{label}: prefill widths {widths}")
    comps, stats = spec_run(torch, cfg, b, reqs, label)
    no_new_graphs(b, warmed, label)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)

    def next_logits(i, prefix):
        prompt = [int(x) for x in reqs14[i].prompt]
        with torch.no_grad():
            return forward_cpu(prompt + prefix)

    def forward_cpu(seq):
        from tfmesos_tpu_torch.models.transformer import forward

        return forward(cpu_cfg, params, torch.tensor([seq]))[0, -1]

    identical, gaps = divergence_gaps(dict(enumerate(streams(base14))),
                                      dict(enumerate(streams(comps))),
                                      next_logits, label)
    stats.update(streams_identical=identical, divergence_gaps=gaps,
                 warmup_seconds=info["seconds"],
                 warmup_graphs=len(info["compiled"]),
                 captures_after_warmup=0)
    ref = stats14["graphed"]
    say(f"  {label}: " + json.dumps(stats))
    say(f"  {label}: {identical} of {len(comps)} streams identical to "
        f"phase 14 (a)'s prefix-cache run, {len(gaps)} differ first at a "
        f"near-tie; TTFT mean {stats['ttft_ms_mean']:.3f} p50 "
        f"{stats['ttft_ms_p50']:.3f} (phase 14 (a): "
        f"{ref['ttft_ms_mean']:.3f} / {ref['ttft_ms_p50']:.3f}); ms a "
        f"dispatch {stats['ms_per_dispatch']:.4f}, acceptance "
        f"{stats['acceptance_rate']:.4f}")
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def param_ptrs(tree):
    """Every tensor's address in a param tree, in key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += param_ptrs(v)
        elif hasattr(v, "values") and hasattr(v, "scales"):
            out += [v.values.data_ptr(), v.scales.data_ptr()]
        else:
            out.append(v.data_ptr())
    return out


def spec_swaps(torch, np, cfg, card, reqs):
    """(h): a warmed batcher serves the first half of phase 5's traffic,
    ``set_weights`` to the seed-1 flagship, the second half, then a
    ``swap_adapter`` delta on ``embed`` and the second half again.  The
    updates copy into the captured graphs' parameter tensors (the same
    addresses), nothing is captured after warmup, the post-swap runs'
    launch counts are exact, and their streams equal a fresh batcher's
    built on those weights."""
    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    label = "h weight swaps"
    kw = dict(rows=8, page_size=64, prefill_bucket=64, device="cuda")
    b = ContinuousBatcher(cfg, card, **kw)
    b.warmup()
    warmed = b._graphs.keys()
    ptrs = param_ptrs(b.params)
    half = len(reqs) // 2

    def again(rs):
        return [Request(r.prompt.copy(), r.max_new_tokens) for r in rs]

    list(b.run(again(reqs[:half])))
    _, other = flagship_model(seed=1, max_len=1024)
    t0 = time.perf_counter()
    b.set_weights(other, version="seed1")
    torch.cuda.synchronize()
    set_ms = (time.perf_counter() - t0) * 1e3
    comps, launches, _, _ = counted_run(torch, cfg, b, again(reqs[half:]),
                                        False, f"{label} (after set_weights)")
    second = streams(comps)
    rs = np.random.RandomState(20)
    delta = {"embed": (0.5 * rs.standard_normal(
        (cfg.vocab_size, cfg.d_model))).astype(np.float32)}
    t0 = time.perf_counter()
    b.swap_adapter(delta, "embed-noise")
    torch.cuda.synchronize()
    fold_ms = (time.perf_counter() - t0) * 1e3
    comps, launches3, _, _ = counted_run(torch, cfg, b, again(reqs[half:]),
                                         False,
                                         f"{label} (after swap_adapter)")
    third = streams(comps)
    no_new_graphs(b, warmed, label)
    need(param_ptrs(b.params) == ptrs, f"{label}: a swap moved a parameter "
         f"tensor (the graphs read the old address)")
    fresh = ContinuousBatcher(cfg, _cuda(other), **kw)
    want2 = streams(list(fresh.run(again(reqs[half:]))))
    del fresh
    folded = dict(other, embed=other["embed"] + torch.from_numpy(
        delta["embed"]))
    fresh = ContinuousBatcher(cfg, _cuda(folded), **kw)
    want3 = streams(list(fresh.run(again(reqs[half:]))))
    del fresh
    need(second == want2, f"{label}: after set_weights the streams differ "
         f"from a fresh batcher's on the seed-1 weights")
    need(third == want3, f"{label}: after swap_adapter the streams differ "
         f"from a fresh batcher's on the folded weights")
    need(third != second, f"{label}: the fold changed no stream")
    stats = {"weight_swaps": b.weight_swaps,
             "adapter_version": b.adapter_version, "set_weights_ms": set_ms,
             "swap_adapter_ms": fold_ms, "requests_per_half": half,
             "post_swap_streams_equal_fresh": True,
             "parameter_addresses_kept": True, "captures_after_warmup": 0,
             "launches": {k: launches[k] + launches3[k] for k in launches}}
    need(b.weight_swaps == 2, f"{label}: weight_swaps {b.weight_swaps}")
    say(f"  {label}: " + json.dumps(stats))
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def spec_generate(torch, cfg, card):
    """(i): ``speculative_generate`` in bf16, batch 4, prompt 128, 256 new
    tokens, with the preset draft and with the self-draft, against
    ``generate`` on the same prompt: the linear-cache kernel at the
    verify's t = 5 and the draft's t = 1 (head_dim 32 for the preset),
    the forward kernel for both prefills.  Streams by the margin rule
    against generate's, exact launch counts (the round count read back
    from them), ms a round and tokens/s beside generate's."""
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_draft_model
    from tfmesos_tpu_torch.ops import attention as ta

    batch, plen, new, k = 4, 128, 256, SPEC_N_DRAFT
    prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                           generator=torch.Generator().manual_seed(40)).cuda()
    with torch.no_grad():
        tt.generate(cfg, card, prompt, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base = tt.generate(cfg, card, prompt, new)
        torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    depth = tt.speculative_cache_depth(plen, new, k)
    out = {"generate_tok_per_s": batch * new / gen_s, "generate_s": gen_s}
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu = _to(card, "cpu")
    for name in ("preset draft", "self-draft"):
        if name == "self-draft":
            dcfg, dparams = cfg, card
        else:
            dcfg, dparams = flagship_draft_model(seed=1, max_len=1024,
                                                 n_draft=k, device="cuda")

        def run():
            with torch.no_grad():
                return tt.speculative_generate(cfg, card, dcfg, dparams,
                                               prompt, new, n_draft=k)

        run()
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        L, Ld = cfg.n_layers, dcfg.n_layers
        per_round = Ld * (k + 1) + L
        rounds = launches["flash_decode"] // per_round
        qt = torch.empty((batch, k + 1, cfg.n_heads, cfg.head_dim),
                         device="cuda")
        qd = torch.empty((batch, 1, dcfg.n_heads, dcfg.head_dim),
                         device="cuda")
        split_t = ta._decode_plan(qt, cfg.kv_heads, depth) > 1
        split_d = ta._decode_plan(qd, dcfg.kv_heads, depth) > 1
        want = {"flash_fwd": L + Ld, "flash_decode": rounds * per_round,
                "flash_decode_merge": rounds * (Ld * (k + 1) * split_d
                                                + L * split_t),
                "flash_decode_paged": 0, "flash_decode_paged_merge": 0,
                "quant_int8": 0, "quant_int8_commit": 0, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
        need(launches == want and rounds >= -(-(new - 1) // (k + 1)),
             f"speculative_generate ({name}) launches {launches} != {want}")
        ref = {i: base[i, plen:].tolist() for i in range(batch)}
        have = {i: got[i, plen:].tolist() for i in range(batch)}

        def next_logits(i, prefix):
            with torch.no_grad():
                return tt.forward(cpu_cfg, cpu, torch.tensor(
                    [prompt[i].tolist() + prefix]))[0, -1]

        identical, gaps = divergence_gaps(ref, have, next_logits,
                                          f"speculative_generate ({name})")
        row = {"rounds": rounds, "tokens_per_round": batch * (new - 1)
               / (rounds * batch), "seconds": secs,
               "ms_per_round": secs / rounds * 1e3,
               "tok_per_s": batch * new / secs,
               "streams_identical": identical, "divergence_gaps": gaps,
               "cache_slots": depth, "launches": launches}
        say(f"  i speculative_generate ({name}): " + json.dumps(row))
        say(f"  i speculative_generate ({name}): {identical} of {batch} "
            f"rows identical to generate's, {len(gaps)} differ first at a "
            f"near-tie; {rounds} rounds, {row['tokens_per_round']:.3f} "
            f"tokens a round a row, ms a round {row['ms_per_round']:.4f}, "
            f"tok/s {row['tok_per_s']:.1f} (generate "
            f"{out['generate_tok_per_s']:.1f})")
        out[name] = row
    return out


def spec_replica(torch, cfg, reqs, ref, next_logits, stats5):
    """(j): ``python -m tfmesos_tpu_torch.fleet.replica --warmup --rows 8
    --draft`` as a process behind the port's registry, phase 5's traffic
    over the wire: streams by the margin rule against phase 5's, the
    replica's launches held to its counters (n_layers flash_fwd a
    prefill; paged launches n_layers a round and a prefill-time draft
    chunk of the draft's layers, k+1 draft steps a round), and the
    registry's spec gauge reading the replica's rounds and acceptance."""
    import os
    import signal
    import threading

    from tfmesos_tpu_torch import wire
    from tfmesos_tpu_torch.fleet.client import MuxConnection
    from tfmesos_tpu_torch.fleet.registry import ReplicaRegistry
    from tfmesos_tpu_torch.models.presets import flagship_draft_model

    token = wire.new_token()
    registry = ReplicaRegistry(token=token).start()
    env = dict(os.environ, TPUMESOS_TOKEN=token)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TPUMESOS_TOKEN_FILE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tfmesos_tpu_torch.fleet.replica",
         "--warmup", "--rows", "8", "--draft", "--n-draft",
         str(SPEC_N_DRAFT), "--registry", registry.addr,
         "--heartbeat-interval", "0.1"], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    timer = threading.Timer(300.0, proc.kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("replica serving on"):
                break
        timer.cancel()
        need(lines and lines[-1].startswith("replica serving on"),
             f"20 (j): no serving line: {lines[-20:]}")
        addr = lines[-1].split()[3]
        links = [MuxConnection(addr, token) for _ in range(4)]
        try:
            completions(wire_calls(links[:1],
                                   [generate_msg(range(1, 9), 2)])[0],
                        "20 (j) warm-up")
            before = settled_stats([addr], token)
            replica_stats([addr], token, reset=True)
            t1 = time.perf_counter()
            replies, parts, first = wire_calls(links, phase5_msgs(reqs))
            wall = time.perf_counter() - t1
            after = settled_stats([addr], token)
        finally:
            for link in links:
                link.close()
        got = completions(replies, "20 (j)")
        identical, gaps = divergence_gaps(ref, dict(enumerate(got)),
                                          next_logits, "20 (j)")
        a, bef = after[addr], before[addr]
        d = {k: n - bef["counters"][k] for k, n in a["counters"].items()}
        dcfg = flagship_draft_model(max_len=1024)[0]
        L, Ld, k1 = cfg.n_layers, dcfg.n_layers, SPEC_N_DRAFT + 1
        launches = a["launches"]
        need(launches["flash_fwd"] == L * d["prefills"]
             and launches["flash_decode_paged"]
             == L * d["decode_ticks"] + Ld * (k1 * d["decode_ticks"]
                                              + d["prefills"])
             and d["spec_rounds"] > 0
             and not any(launches[x] for x in IDLE_IN_A_REPLICA),
             f"20 (j): the replica launched {launches} for its counters "
             f"{d}")
        rounds = a["counters"]["spec_rounds"]
        wait_deadline = time.monotonic() + 10.0
        spec = None
        while time.monotonic() < wait_deadline:
            info = next((r for r in registry.members() if r.addr == addr),
                        None)
            spec = getattr(info, "spec", None)
            if isinstance(spec, dict) and spec.get("rounds") == rounds:
                break
            time.sleep(0.1)
        gauge = registry.spec_summary()
        need(isinstance(spec, dict) and spec.get("rounds") == rounds
             and gauge.get("replicas") == 1
             and gauge.get("rounds") == rounds
             and "acceptance_rate" in gauge,
             f"20 (j): the registry's spec gauge {gauge} / beat {spec} for "
             f"{rounds} rounds")
        proc.send_signal(signal.SIGTERM)
        tail, _ = proc.communicate(timeout=60)
        need(proc.returncode == 0, f"20 (j): exit code {proc.returncode}: "
             f"{tail[-2000:]}")
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        registry.stop()
    timing = wire_ttft(replies, parts, first, "20 (j)")
    out = {"requests": len(got), "wall_s": wall, **timing,
           "streams_identical": identical, "divergence_gaps": gaps,
           "spec_gauge": gauge, "launches": launches, "counters": d}
    say("  (j) " + json.dumps(out))
    say(f"  (j) the --draft replica process: {identical} of {len(got)} "
        f"streams identical to phase 5's, {len(gaps)} differ first at a "
        f"near-tie; the registry's spec gauge {json.dumps(gauge)}")
    return out


#: phase 21's fleets: phase 18's shape, a deeper admission queue (64 in
#: flight against 8 gateway workers queue 56) and no per-path retry noise.
CONTROL = dict(FRONT_DOOR, max_queue=256)
#: phase 21 (a)'s control loop: a tick every 0.25 s; the queue-wait
#: bounds are set from the burst measured first on one replica.
AUTOSCALE = dict(interval=0.25, scale_up_cooldown=1.0,
                 scale_down_cooldown=1.0, drain_grace=0.5,
                 drain_timeout=60.0)
#: (a)'s surge runs until the newcomer has prefilled this many requests.
SURGE_NEWCOMER_PREFILLS = 16
#: phase 20 (h)'s adapter delta on ``embed`` (seed 20, scale 0.5).
SWAP_SEED, SWAP_SCALE = 20, 0.5


class LaunchBook:
    """Each replica's launch counts, batcher counters and captured graphs
    across a phase-21 fleet's life: a baseline read per replica present
    at :meth:`begin` (a replica launched later starts from ``warm``, a
    freshly warmed replica's read: its warmup's launches, zero counters),
    and a final read taken at its kill (:func:`count_before_kills`) or at
    :meth:`end`.  :meth:`held` holds each replica's launches between the
    two to its batcher's counters as phase 18 does."""

    def __init__(self, cfg, token, warm):
        self.cfg, self.token, self.warm = cfg, token, warm
        self.base, self.final, self.errors = {}, {}, []

    def begin(self, addrs):
        self.base.update(settled_stats(addrs, self.token))

    def read_final(self, addrs):
        addrs = [a for a in addrs if a not in self.final]
        if addrs:
            self.final.update(settled_stats(addrs, self.token))

    def end(self, addrs):
        self.read_final(addrs)

    def held(self, what):
        """{addr: launches} per replica and their sum, each replica held
        to its counters and to no capture after its warmup."""
        per, total = {}, {}
        for addr, fin in sorted(self.final.items()):
            base = self.base.get(addr, self.warm)
            after = dict(fin, launches={
                k: n - base["launches"][k] for k, n in fin["launches"].items()})
            got = replica_launches(self.cfg, {addr: base}, {addr: after},
                                   f"{what} {addr}")
            need(fin["graphs"] == base["graphs"], f"{what}: replica {addr} "
                 f"captured {fin['graphs'] - base['graphs']} graphs after "
                 f"its warmup")
            per[addr] = {"launches": got,
                         "counters": {k: n - base["counters"][k]
                                      for k, n in fin["counters"].items()}}
            for k, n in got.items():
                total[k] = total.get(k, 0) + n
        return per, total


def say_launches(label, per):
    """Each replica's flash_fwd and paged launches and its counters."""
    say(f"  {label} launches per replica (held to its counters): "
        + "; ".join(
        f"{addr}: flash_fwd {p['launches']['flash_fwd']}, paged "
        f"{p['launches']['flash_decode_paged']} + merges "
        f"{p['launches']['flash_decode_paged_merge']} for "
        f"{p['counters']['prefills']} prefills, "
        f"{p['counters']['decode_ticks']} ticks" for addr, p in per.items()))


def count_before_kills(fleet, books):
    """Read each replica's final counts just before the fleet removes its
    process: the autoscaler's reap (``kill_replica``) and a rollout's
    reap of the old tier (after ``_drain_and_flush``).  ``books[-1]`` is
    the current :class:`LaunchBook`."""
    kill = fleet.kill_replica
    flush = fleet._drain_and_flush

    def counted_kill(node):
        addr = next((r.addr for r in fleet.registry.members()
                     if r.node == node), None)
        try:
            if addr is not None:
                books[-1].read_final([addr])
        except Exception as e:            # re-raised by the phase
            books[-1].errors.append(f"kill {node}: {e!r}")
        return kill(node)

    def counted_flush(reps, drain_timeout):
        flush(reps, drain_timeout)
        try:
            books[-1].read_final([r.addr for r in reps])
        except Exception as e:            # re-raised by the phase
            books[-1].errors.append(f"reap: {e!r}")

    fleet.kill_replica = counted_kill
    fleet._drain_and_flush = counted_flush


def full_logits(torch, cfg, params, prompts, refs):
    """``next_logits(key, prefix)`` for :func:`divergence_gaps` over keys
    ``(i, n)``: the float32 CPU logits after prompt ``i`` and ``prefix``
    of reference stream ``refs[i]``, from one forward a prompt over the
    prompt and the whole reference stream (the model is causal), made
    when a stream of ``i`` first differs."""
    from tfmesos_tpu_torch.models.transformer import forward

    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cache = {}

    def next_logits(key, prefix):
        i = key[0]
        if i not in cache:
            seq = [int(x) for x in prompts[i]] + list(refs[i])
            with torch.no_grad():
                cache[i] = forward(cpu_cfg, params, torch.tensor([seq]))[0]
        return cache[i][len(prompts[i]) - 1 + len(prefix)]

    return next_logits


def margin_all(refs, got, next_logits, what):
    """Every reply ``got[i]`` (a list a request) against ``refs[i]`` by
    the margin rule: (identical, near-ties, replies)."""
    ref = {(i, n): refs[i] for i, rs in got.items() for n in range(len(rs))}
    have = {(i, n): r for i, rs in got.items() for n, r in enumerate(rs)}
    identical, gaps = divergence_gaps(ref, have, next_logits, what)
    return identical, len(gaps), len(have)


def labeled(client, prompt, new, model=None, stream=True):
    """One ``FleetClient.generate``: (tokens, client ms to the first
    streamed token, the reply)."""
    t0 = time.perf_counter()
    first = []

    def on_tokens(toks):
        if not first:
            first.append((time.perf_counter() - t0) * 1e3)

    kw = {"on_tokens": on_tokens} if stream else {}
    reply = client.generate(prompt, new, model=model, **kw)
    return reply["tokens"], (first[0] if first else None), reply


def fleet_wave(client, reqs, copies, model=None, threads=None):
    """``copies`` copies of every request of ``reqs`` in flight at once
    (or from ``threads`` threads in turn): {i: [tokens, ...]}."""
    import threading

    jobs = [i for _ in range(copies) for i in range(len(reqs))]
    threads = threads or len(jobs)
    got, errors = collections.defaultdict(list), []

    def worker(k):
        for j in range(k, len(jobs), threads):
            i = jobs[j]
            try:
                got[i].append(labeled(client, [int(x) for x in
                                               reqs[i].prompt],
                                      reqs[i].max_new_tokens, model,
                                      stream=False)[0])
            except Exception as e:         # reported below
                errors.append((i, repr(e)))

    pool = [threading.Thread(target=worker, args=(k,))
            for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    need(not errors, f"fleet requests failed: {errors}")
    return got


def merge_replies(*parts):
    out = collections.defaultdict(list)
    for part in parts:
        for i, rs in part.items():
            out[i].extend(rs)
    return out


def phase_control(torch, np, cfg, params, reqs, base):
    """Phase 21: the fleet's control loops on the card — (a) the
    autoscaler grows a one-replica fleet under a surge and drains it
    back, (b) a blue-green rollout under traffic, (c) a model catalog
    whose cold model starts by warm-pool adoption, and an adapter swap.
    Every replica's launches are held to its own counters."""
    import os

    from tfmesos_tpu_torch.fleet import (AutoscalerConfig, FleetServer,
                                         ModelSpec, TraderConfig)

    say("[21/28] the control loops: autoscale, rollout, catalog; flagship, "
        "rows 8, max_len 1024, page 64, bucket 64, --warmup")
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    auto_cfg = AutoscalerConfig(queue_wait_hi_ms=math.inf,
                                util_hi=math.inf, **AUTOSCALE)
    fleet = FleetServer(replicas=1, autoscale=True, min_replicas=1,
                        max_replicas=2, autoscale_config=auto_cfg,
                        **CONTROL).start()
    books = []
    try:
        pids = replica_pids([os.getpid()])
        need(len(pids) == 1, f"21: replica processes {pids}")
        (r0,) = [r.addr for r in fleet.registry.alive()]
        warm = replica_stats([r0], fleet.token)[r0]
        need(not any(warm["counters"].values())
             and warm["launches"]["flash_fwd"] > 0,
             f"21: a warmed replica read {warm['counters']} / "
             f"{warm['launches']}")
        books.append(LaunchBook(cfg, fleet.token, warm))
        books[-1].begin([r0])
        count_before_kills(fleet, books)
        out["a"], replies_a = control_autoscale(np, cfg, fleet, reqs,
                                                books[-1], auto_cfg, pids)
        survivors = [r.addr for r in fleet.registry.alive()]
        books[-1].end(survivors)
        out["a"]["replicas"], out["a"]["launches"] = books[-1].held("21 (a)")
        need(not books[-1].errors, f"21 (a): {books[-1].errors}")
        say_launches("(a)", out["a"]["replicas"])
        books.append(LaunchBook(cfg, fleet.token, warm))
        books[-1].begin(survivors)
        out["b"], replies_b = control_rollout(np, cfg, fleet, reqs,
                                              books[-1])
        books[-1].end([r.addr for r in fleet.registry.alive()])
        out["b"]["replicas"], out["b"]["launches"] = books[-1].held("21 (b)")
        need(not books[-1].errors, f"21 (b): {books[-1].errors}")
        say_launches("(b)", out["b"]["replicas"])
    finally:
        fleet.stop()
    need(not pids_alive(replica_pids([os.getpid()])),
         "21: replica processes outlived FleetServer.stop()")
    out["c"], checks_c = control_catalog(torch, np, cfg, params, reqs,
                                         FleetServer, ModelSpec,
                                         TraderConfig)
    # The margin rule on every stream, after the fleets are down (the
    # CPU forwards would otherwise share the host with the replicas).
    prompts = [r.prompt for r in reqs]
    ref = dict(enumerate(base))
    seed0 = full_logits(torch, cfg, params, prompts, ref)
    for label, got in (("a", replies_a), ("b", replies_b),
                       ("c chat", checks_c["chat"])):
        same, ties, n = margin_all(ref, got, seed0, f"21 ({label})")
        key = "c" if label.startswith("c") else label
        out[key][f"streams {label}"] = {"replies": n, "identical": same,
                                        "near_ties": ties}
        say(f"  ({label}) {same} of {n} replies identical to phase 5's, "
            f"{ties} first differ at a near-tie")
    for label in ("code", "chat after swap"):
        refs, got, logits = checks_c[label]
        same, ties, n = margin_all(refs, got, logits, f"21 (c) {label}")
        out["c"][f"streams {label}"] = {"replies": n, "identical": same,
                                        "near_ties": ties}
        say(f"  (c) {label}: {same} of {n} replies identical to the "
            f"in-process batcher's, {ties} first differ at a near-tie")
    return out


def control_autoscale(np, cfg, fleet, reqs, book, auto_cfg, pids):
    """Phase 21 (a): a burst measured on one replica sets the queue-wait
    bounds; then the same burst held in flight until the newcomer the
    loop launches has registered warming, gone alive and prefilled
    :data:`SURGE_NEWCOMER_PREFILLS` requests; then quiet until the loop
    has drained, migrated and killed back to one replica."""
    import threading

    from tfmesos_tpu_torch.fleet.metrics import Histogram

    auto = fleet.autoscaler
    traj, t0 = [], time.perf_counter()
    step = auto.step

    def traced_step(now=None):
        step(now)
        d = auto.describe()["unified"]
        traj.append({"t": round(time.perf_counter() - t0, 3),
                     "target": d["target"], "actual": d["actual"],
                     "alive": d["alive"], "warming": d["warming"],
                     "action": d["last_action"]})

    auto.step = traced_step
    counters0 = fleet_counters(fleet)
    client = fleet.client(timeout=300.0)
    try:
        # The burst on one replica: 4 copies of phase 5's 16 at once.
        prev = fleet.metrics.hist_cumulative("queue_wait_ms")
        cal = fleet_wave(client, reqs, 4)
        cur = fleet.metrics.hist_cumulative("queue_wait_ms")
        p99 = Histogram.delta_percentile(prev, cur, 0.99)
        need(p99 is not None and p99 > 0, f"21 (a): burst p99 {p99}")
        need(fleet.targets["unified"] == 1, "21 (a): the loop moved on the "
             "calibration burst")
        # Two ticks under the old bounds first: their windows take the
        # burst's samples, so the surge's own waits are what the new
        # bounds judge.
        ticks = len(traj) + 2
        deadline = time.monotonic() + 10.0
        while len(traj) < ticks and time.monotonic() < deadline:
            time.sleep(0.05)
        need(len(traj) >= ticks, "21 (a): the control loop stopped ticking")
        with fleet.scale_lock:
            auto_cfg.queue_wait_hi_ms = p99 / 2
            auto_cfg.queue_wait_lo_ms = p99 / 20
        say(f"  (a) the burst on one replica: queue-wait p99 {p99} ms; "
            f"bounds hi {auto_cfg.queue_wait_hi_ms} lo "
            f"{auto_cfg.queue_wait_lo_ms} ms")
        start = {r.addr for r in fleet.registry.members()}
        seen, stop = {}, threading.Event()
        surge = collections.defaultdict(list)
        errors = []

        def worker(k):
            i = k % len(reqs)
            while not stop.is_set():
                try:
                    surge[i].append(client.generate(
                        [int(x) for x in reqs[i].prompt],
                        reqs[i].max_new_tokens)["tokens"])
                except Exception as e:     # reported below
                    errors.append((i, repr(e)))
                    return

        def watch():
            while not stop.is_set() or "killed" not in seen:
                now = time.perf_counter() - t0
                for r in fleet.registry.members():
                    if r.addr in start:
                        continue
                    seen.setdefault("addr", r.addr)
                    if r.state == "warming":
                        seen.setdefault("warming", now)
                    if r.state == "alive":
                        seen.setdefault("alive", now)
                    if fleet.router.outstanding(r.addr) > 0:
                        seen.setdefault("routed", now)
                if any(x["action"].startswith("kill:") for x in traj):
                    seen.setdefault("killed", now)
                if now > 300:
                    return
                time.sleep(0.01)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t_surge = time.perf_counter() - t0
        pool = [threading.Thread(target=worker, args=(k,))
                for k in range(4 * len(reqs))]
        for t in pool:
            t.start()
        deadline = time.monotonic() + 180.0
        newcomer = {}
        while time.monotonic() < deadline and not errors:
            addr = seen.get("addr")
            if addr and "routed" in seen:
                newcomer = replica_stats([addr], fleet.token)[addr]
                if newcomer["counters"]["prefills"] \
                        >= SURGE_NEWCOMER_PREFILLS:
                    break
            time.sleep(0.5)
        t_quiet = time.perf_counter() - t0
        stop.set()
        for t in pool:
            t.join()
        need(not errors, f"21 (a): surge requests failed: {errors}")
        need(newcomer.get("counters", {}).get("prefills", 0)
             >= SURGE_NEWCOMER_PREFILLS,
             f"21 (a): the newcomer never took traffic: {seen}")
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if fleet.tier_actual("unified") == 1 \
                    and len(fleet.registry.alive()) == 1 \
                    and "killed" in seen:
                break
            time.sleep(0.05)
        t_down = time.perf_counter() - t0
        watcher.join(timeout=5.0)
    finally:
        auto.step = step
        client.close()
    after = fleet_counters(fleet)
    books = {k: delta(after, counters0, k) for k in (
        "autoscale_up", "autoscale_down", "autoscale_launches",
        "autoscale_drains", "autoscale_kills", "autoscale_kill_failures",
        "failed", "shed_queue", "shed_rate_limited", "shed_deadline",
        "migrations_requested", "migration_resumes", "migration_direct",
        "migration_reruns")}
    need(fleet.tier_actual("unified") == 1
         and len(fleet.registry.alive()) == 1,
         f"21 (a): not back to one replica: {traj[-3:]}")
    need(books["autoscale_up"] == 1 and books["autoscale_launches"] == 1
         and books["autoscale_down"] == 1 and books["autoscale_drains"] == 1
         and books["autoscale_kills"] == 1,
         f"21 (a): the loop's actions {books}")
    need(not any(books[k] for k in ("failed", "shed_queue",
                                    "shed_rate_limited", "shed_deadline",
                                    "autoscale_kill_failures")),
         f"21 (a): failed or shed requests: {books}")
    t_up = next((x["t"] for x in traj if x["target"] == 2), -1.0)
    need(t_up >= t_surge and t_up <= seen.get("warming", -1)
         <= seen.get("alive", -1) <= seen.get("routed", -1) <= t_quiet
         <= seen.get("killed", -1), f"21 (a): out of order: surge "
         f"{t_surge}, up tick {t_up}, newcomer {seen}, quiet {t_quiet}")
    replies = merge_replies(cal, surge)
    stats = {"burst_queue_wait_p99_ms": p99,
             "queue_wait_hi_ms": auto_cfg.queue_wait_hi_ms,
             "queue_wait_lo_ms": auto_cfg.queue_wait_lo_ms,
             "surge_s": t_quiet - t_surge,
             "up_to_first_routed_s": seen["routed"] - t_up,
             "warming_to_alive_s": seen["alive"] - seen["warming"],
             "quiet_to_one_replica_s": t_down - t_quiet,
             "newcomer_prefills_in_surge": newcomer["counters"]["prefills"],
             "replies": sum(len(v) for v in replies.values()),
             "counters": books, "trajectory": traj}
    say("  (a) " + json.dumps(stats))
    say(f"  (a) one scale-up {t_up - t_surge:.2f} s into the surge; the "
        f"newcomer warming {seen['warming'] - t_up:.2f} s later, alive "
        f"{seen['alive'] - t_up:.2f} s, first routed request "
        f"{seen['routed'] - t_up:.2f} s after the up tick; back to one "
        f"replica {t_down - t_quiet:.2f} s after the quiet; migrations "
        f"requested {books['migrations_requested']}, resumed "
        f"{books['migration_resumes']}, rerun {books['migration_reruns']}")
    moves = [x for k, x in enumerate(traj) if k == 0 or any(
        x[f] != traj[k - 1][f] for f in ("target", "actual", "alive",
                                          "warming"))]
    say("  (a) the autoscaler gauge, tick by tick where it moved (s: "
        "target/actual, alive+warming): " + " ".join(
            f"{x['t']}: {x['target']}/{x['actual']}, "
            f"{x['alive']}+{x['warming']}" for x in moves)
        + f" ({len(traj)} ticks)")
    return stats, replies


def control_rollout(np, cfg, fleet, reqs, book):
    """Phase 21 (b): ``FleetClient.rollout("v1")`` (the path ``tfserve
    rollout`` takes) while phase 5's 16 requests run again and again from
    a second thread, 4 at a time; then the roles gauge, the counters, the
    generation fence and a stale-generation hello."""
    import threading

    from tfmesos_tpu_torch import wire

    old = {r.addr for r in fleet.registry.alive()}
    counters0 = fleet_counters(fleet)
    client = fleet.client(timeout=600.0)
    done, traffic, errors = threading.Event(), [], []

    def feed():
        while not done.is_set():
            try:
                traffic.append(fleet_wave(client, reqs, 1, threads=4))
            except Exception as e:         # reported below
                errors.append(repr(e))
                return

    feeder = threading.Thread(target=feed)
    feeder.start()
    try:
        time.sleep(0.2)
        t0 = time.perf_counter()
        info = client.rollout("v1", timeout=600.0)
        rollout_s = time.perf_counter() - t0
    finally:
        done.set()
        feeder.join()
        client.close()
    need(not errors, f"21 (b): requests failed during the rollout: {errors}")
    snap = fleet.snapshot()
    roles = snap["gauges"]["roles"]["unified"]
    after = snap["counters"]
    books = {k: delta(after, counters0, k) for k in (
        "rollouts", "rollouts_aborted", "failed", "shed_queue",
        "version_fallbacks", "migrations_requested", "migration_resumes",
        "migration_reruns")}
    need(info.get("ok") and info.get("new_version") == "v1"
         and info.get("old_version") == "v0" and info.get("reaped") == 1
         and info.get("generation", 0) >= 1, f"21 (b): rollout {info}")
    need(roles["versions"] == {"v1": 1}, f"21 (b): roles gauge {roles}")
    need(books["rollouts"] == 1 and books["rollouts_aborted"] == 0
         and books["failed"] == 0 and books["shed_queue"] == 0,
         f"21 (b): counters {books}")
    fence = fleet.registry._min_gen
    need(fence >= 1 and not fleet.registry.gen_allowed(fence - 1),
         f"21 (b): generation fence {fence}")
    alive = fleet.registry.alive()
    need(len(alive) == 1 and not ({r.addr for r in alive} & old)
         and alive[0].weights_version == "v1",
         f"21 (b): after the rollout {[(r.addr, r.weights_version) for r in alive]}")
    # A straggler of the reaped generation re-registering is dropped; a
    # hello of the current generation lands.
    sock = wire.connect(fleet.registry.addr)
    try:
        wire.send_msg(sock, {"op": "hello", "addr": "stale:1", "gen": 0,
                             "weights_version": "v0", "role": "unified"},
                      fleet.token)
        wire.send_msg(sock, {"op": "hello", "addr": "fresh:1",
                             "gen": info["generation"],
                             "weights_version": "v1", "role": "unified"},
                      fleet.token)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and "fresh:1" not in {
                r.addr for r in fleet.registry.members()}:
            time.sleep(0.05)
        members = {r.addr for r in fleet.registry.members()}
    finally:
        sock.close()
    need("fresh:1" in members and "stale:1" not in members,
         f"21 (b): the fence let in {sorted(members)}")
    fleet.registry.mark_dead("fresh:1", "phase 21 probe")
    replies = merge_replies(*traffic)
    stats = {"rollout_s": rollout_s, "rollout": {
        k: info.get(k) for k in ("old_version", "new_version", "replicas",
                                 "reaped", "generation")},
        "fence": fence, "versions": roles["versions"],
        "requests_during": sum(len(v) for v in replies.values()),
        "waves_during": len(traffic), "counters": books}
    say("  (b) " + json.dumps(stats))
    say(f"  (b) rollout v0 -> v1 in {rollout_s:.2f} s under "
        f"{len(traffic)} waves of phase 5's traffic, none failed; versions "
        f"{roles['versions']}, fence {fence}, the stale hello dropped")
    return stats, replies


def control_catalog(torch, np, cfg, params, reqs, FleetServer, ModelSpec,
                    TraderConfig):
    """Phase 21 (c): a catalog fleet — ``chat`` (seed 0) on one replica,
    ``code`` (seed 7) scaled to zero, one warm-pool replica, budget 2.
    Phase 5's traffic labeled ``chat``; four ``code`` requests, the first
    a cold start the router waits out while the trader's ``demand``
    adopts the pool replica (``set_weights``, no launch); an adapter
    swap on ``chat`` through ``FleetClient.swap_adapter`` (phase 20
    (h)'s delta on ``embed``) and phase 5's traffic again.  The trader's
    tick-driven trades and scale-to-zero are held off (their decisions
    are the CPU tests'); its demand path is what runs here."""
    import os

    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    models = [ModelSpec("chat", replicas=1, seed=0),
              ModelSpec("code", replicas=0, seed=7)]
    t0 = time.perf_counter()
    fleet = FleetServer(models=models, warm_pool=1, model_budget=2,
                        trader_config=TraderConfig(
                            zero_after_ticks=10 ** 6,
                            trade_cooldown_s=10 ** 6),
                        **CONTROL).start()
    adoptions, launched = [], []
    try:
        up_s = time.perf_counter() - t0
        pids = replica_pids([os.getpid()])
        need(len(pids) == 2, f"21 (c): replica processes {pids}")
        addrs = sorted(r.addr for r in fleet.registry.alive())
        book = LaunchBook(cfg, fleet.token, None)
        book.begin(addrs)
        adopt, launch = fleet.adopt_replica, fleet.launch_replica

        def timed_adopt(addr, model_id, **kw):
            a0 = time.perf_counter()
            ok = adopt(addr, model_id, **kw)
            adoptions.append({"addr": addr, "model": model_id, "ok": ok,
                              "ms": (time.perf_counter() - a0) * 1e3})
            return ok

        def counted_launch(key, weights_version=None):
            launched.append(key)
            return launch(key, weights_version)

        fleet.adopt_replica = timed_adopt
        fleet.launch_replica = counted_launch
        counters0 = fleet_counters(fleet)
        client = fleet.client(timeout=300.0)
        try:
            chat = fleet_wave(client, reqs, 1, model="chat", threads=4)
            code, ttft, ttft_reply = {}, [], []
            for i in range(4):
                toks, first, reply = labeled(
                    client, [int(x) for x in reqs[i].prompt],
                    reqs[i].max_new_tokens, model="code")
                code[i] = [toks]
                ttft.append(first)
                ttft_reply.append(reply["ttft_ms"])
            rs = np.random.RandomState(SWAP_SEED)
            delta_ = {"embed": (SWAP_SCALE * rs.standard_normal(
                (cfg.vocab_size, cfg.d_model))).astype(np.float32)}
            s0 = time.perf_counter()
            swap = client.swap_adapter("chat", "embed-noise", delta_,
                                       timeout=300.0)
            swap_ms = (time.perf_counter() - s0) * 1e3
            chat2 = fleet_wave(client, reqs, 1, model="chat", threads=4)
        finally:
            client.close()
        book.end(addrs)
        per, launches = book.held("21 (c)")
        snap = fleet.snapshot()
        after = snap["counters"]
        models_gauge = snap["gauges"]["models"]
    finally:
        fleet.stop()
    need(not pids_alive(pids), "21 (c): replica processes outlived stop()")
    books = {k: delta(after, counters0, k) for k in (
        "model_cold_waits", "model_cold_starts", "model_adoptions",
        "model_trades", "adapter_swaps", "failed", "shed_queue")}
    need(len(adoptions) == 1 and adoptions[0]["ok"]
         and adoptions[0]["model"] == "code" and not launched,
         f"21 (c): adoptions {adoptions}, launches {launched}")
    need(books["model_cold_waits"] == 1 and books["model_cold_starts"] == 1
         and books["model_adoptions"] == 1 and books["adapter_swaps"] == 1
         and books["failed"] == 0 and books["shed_queue"] == 0,
         f"21 (c): counters {books}")
    meters = {k: after.get(k, 0) for k in (
        "metering_prompt_tokens_default_chat",
        "metering_decode_tokens_default_chat",
        "metering_prompt_tokens_default_code",
        "metering_decode_tokens_default_code")}
    need(all(meters.values()), f"21 (c): per-model metering {meters}")
    need(swap.get("replicas") == 1 and swap.get("model_id") == "chat",
         f"21 (c): swap {swap}")
    swaps = sorted(p["counters"]["weight_swaps"] for p in per.values())
    need(swaps == [1, 1], f"21 (c): weight swaps per replica {swaps}")
    # The references, in this process on the card, after the fleet.
    kw = dict(rows=8, page_size=64, prefill_bucket=64, device="cuda")
    _, code_params = flagship_model(seed=7, max_len=1024)
    b = ContinuousBatcher(cfg, _cuda(code_params), **kw)
    code_ref = streams(list(b.run([Request(r.prompt.copy(), r.max_new_tokens)
                                   for r in reqs[:4]])))
    del b
    folded = dict(params, embed=params["embed"] + torch.from_numpy(
        delta_["embed"]))
    b = ContinuousBatcher(cfg, _cuda(folded), **kw)
    swap_ref = streams(list(b.run([Request(r.prompt.copy(), r.max_new_tokens)
                                   for r in reqs])))
    del b
    gc.collect()
    torch.cuda.empty_cache()
    prompts = [r.prompt for r in reqs]
    checks = {
        "chat": chat,
        "code": (dict(enumerate(code_ref)), code,
                 full_logits(torch, cfg, code_params, prompts,
                             dict(enumerate(code_ref)))),
        "chat after swap": (dict(enumerate(swap_ref)), chat2,
                            full_logits(torch, cfg, folded, prompts,
                                        dict(enumerate(swap_ref))))}
    need(chat2 != chat, "21 (c): the swap changed no chat stream")
    stats = {"fleet_up_s": up_s, "cold_ttft_ms": ttft[0],
             "warm_ttft_ms": ttft[1:], "reply_ttft_ms": ttft_reply,
             "adoption_ms": adoptions[0]["ms"], "swap_ms": swap_ms,
             "counters": books, "metering": meters,
             "models": models_gauge, "replicas": per, "launches": launches}
    say("  (c) " + json.dumps(stats))
    say(f"  (c) catalog fleet up in {up_s:.1f} s; the first code request "
        f"cold-started by adoption: client TTFT {ttft[0]:.1f} ms against "
        f"{statistics.mean(ttft[1:]):.1f} warm; adoption "
        f"{adoptions[0]['ms']:.1f} ms; adapter swap {swap_ms:.1f} ms")
    say_launches("(c)", per)
    return stats, checks


# -- phase 22: checkpointed, supervised training ----------------------------

CKPT_STEPS = 12
CKPT_EVERY = 4
CKPT_FAIL_DRAW = 6          # attempt 0 dies drawing its 7th batch


def train_launches_exact(launches, L, steps, what, fwd_per_step=1):
    """Rows 1-3 at exactly L (fwd: fwd_per_step x L) a step; the decode
    kernels, their merges and both quant_int8 entries at 0."""
    need(launches["flash_fwd"] == fwd_per_step * L * steps,
         f"{what}: flash_fwd launches {launches['flash_fwd']} != "
         f"{fwd_per_step} x {L} x {steps}")
    for key in ("flash_bwd_dq", "flash_bwd_dkv"):
        need(launches[key] == L * steps,
             f"{what}: {key} launches {launches[key]} != {L} x {steps}")
    for key in ("flash_decode_paged", "flash_decode_paged_merge",
                "flash_decode", "flash_decode_merge", "quant_int8",
                "quant_int8_commit"):
        need(launches[key] == 0, f"{what}: {key} launched {launches[key]}")


def flat_clone(torch, params):
    from tfmesos_tpu_torch.convert import flatten

    return {k: v.detach().clone() for k, v in flatten(params).items()}


def same_params(torch, got, want, what):
    from tfmesos_tpu_torch.convert import flatten

    got = flatten(got)
    need(sorted(got) == sorted(want), f"{what}: leaf names differ")
    bad = [k for k in want if not torch.equal(got[k].detach(), want[k])]
    need(not bad, f"{what}: params not bit-identical in {bad}")


def dir_mb(path) -> float:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e6


def phase_checkpointed(torch, np, train):
    """Phase 22: the flagship trained through ``TrainLoop`` with
    asynchronous checkpoints (a); the same run supervised, killed by a
    ``ClusterError`` at its 7th batch and resumed from step 4 (b), bit
    for bit; ``transformer_train`` from a token file, stopped and
    resumed (c); remat against the plain step (d)."""
    import contextlib
    import io
    import shutil
    import tempfile

    from tfmesos_tpu_torch import transformer_train as tr
    from tfmesos_tpu_torch.convert import flatten, unflatten
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.scheduler import ClusterError
    from tfmesos_tpu_torch.train.checkpoint import CheckpointManager
    from tfmesos_tpu_torch.train.data import (TokenFileDataset,
                                              _NativeTokenGather, prefetch,
                                              token_batches)
    from tfmesos_tpu_torch.train.supervisor import supervise_training
    from tfmesos_tpu_torch.train.trainer import TrainLoop, TrainState

    args = tr.parse_args([])
    cuda = torch.device("cuda")
    say(f"[22/28] checkpointed training: flagship, B {args.batch_size}, "
        f"T {args.seq_len}, AdamW {args.learning_rate}, weights seeded 0, "
        f"{CKPT_STEPS} steps, a save every {CKPT_EVERY}")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {}
    try:
        losses = {}
        loops = []
        cfgs = []

        def build(attempt, fail_at_draw=None):
            run = tr.setup(args, cuda)
            cfgs.append(run.cfg)
            record = losses.setdefault(attempt, [])

            def step(p, o, b):
                p, o, m = run.step(p, o, b)
                record.append(m["loss"])
                return p, o, m

            loop = TrainLoop(step_fn=step, state=TrainState(
                run.params, run.opt_state), log_every=1000,
                name=f"phase22-{attempt}", save_async=True)
            loops.append(loop)
            gen = prefetch(run.batches, cuda)

            def batches():
                for n, batch in enumerate(gen):
                    if n == fail_at_draw:
                        raise ClusterError("phase 22: attempt 0 stopped at "
                                           "its 7th batch")
                    yield batch

            return loop, batches()

        # (a) uninterrupted, through TrainLoop with async saves.
        loop, batches = build("a")
        cfg = cfgs[0]
        L = cfg.n_layers
        mgr_a = CheckpointManager(f"{root}/a")
        loop.checkpoint, loop.save_every = mgr_a, CKPT_EVERY
        zero_launches()
        res = loop.run(batches, CKPT_STEPS)
        launches_a = read_launches()
        mgr_a.close()
        train_launches_exact(launches_a, L, CKPT_STEPS, "(a)")
        loss_a = torch.stack(losses["a"]).tolist()
        need(all(math.isfinite(x) for x in loss_a), f"(a) losses {loss_a}")
        need(mgr_a.all_steps() == [4, 8, 12], f"(a) saved "
             f"{mgr_a.all_steps()}")
        ref = flat_clone(torch, loop.state.params)
        ms_step = res["elapsed_s"] / CKPT_STEPS * 1e3
        out["a"] = {"losses": loss_a, "ms_per_step": ms_step,
                    "phase8_ms_per_step": (train or {}).get("ms_per_step"),
                    "steps_per_sec": res["steps_per_sec"],
                    "final_step": res["final_step"], "launches": launches_a}
        say(f"  (a) {CKPT_STEPS} steps through TrainLoop, saves at "
            f"{mgr_a.all_steps()}: {ms_step:.2f} ms a step (phase 8's loop "
            f"{out['a']['phase8_ms_per_step']}); losses {loss_a}")

        # The costs of a save and a restore of (a)'s state.
        state = loop.state_dict()
        mgr_t = CheckpointManager(f"{root}/t", max_to_keep=1)
        t0 = time.perf_counter()
        mgr_t.save(1, state, wait=True)
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mgr_t.save(2, state, wait=True)
        sync_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mgr_t.save(3, state, wait=False)
        return_ms = (time.perf_counter() - t0) * 1e3
        mgr_t.wait_until_finished()
        done_ms = (time.perf_counter() - t0) * 1e3
        mb = dir_mb(f"{root}/t/step_3")
        t0 = time.perf_counter()
        mgr_t.restore(state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        mgr_t.close()
        same_params(torch, loop.state.params, ref, "restore of (a)")
        for d in ("a", "t"):             # ~410 MB a step on disk
            shutil.rmtree(f"{root}/{d}")
        out["costs"] = {"save_sync_first_ms": first_ms,
                        "save_sync_ms": sync_ms,
                        "save_async_return_ms": return_ms,
                        "save_async_done_ms": done_ms,
                        "checkpoint_mb": mb, "restore_ms": restore_ms}
        say("  costs: " + json.dumps(out["costs"]))

        # (b) supervised: killed at the 7th draw, resumed from step 4.
        loops.clear()
        mgr_b = CheckpointManager(f"{root}/b")
        zero_launches()
        r = supervise_training(
            lambda a: build(a, CKPT_FAIL_DRAW if a == 0 else None),
            CKPT_STEPS, mgr_b, save_every=CKPT_EVERY, max_restarts=1,
            restart_wait=0.0)
        launches_b = read_launches()
        mgr_b.close()
        need(r.attempts == 2 and r.resumed_steps == [0, CKPT_EVERY],
             f"(b) attempts {r.attempts}, resumed {r.resumed_steps}")
        need(r.result["final_step"] == CKPT_STEPS
             and r.result["restores"] == 1, f"(b) result {r.result}")
        ran = CKPT_FAIL_DRAW + CKPT_STEPS - CKPT_EVERY
        train_launches_exact(launches_b, L, ran, "(b)")
        loss_b0 = torch.stack(losses[0]).tolist()
        loss_b1 = torch.stack(losses[1]).tolist()
        need(loss_b0 == loss_a[:CKPT_FAIL_DRAW],
             f"(b) attempt 0 losses {loss_b0} != (a)'s {loss_a}")
        need(loss_b1 == loss_a[CKPT_EVERY:],
             f"(b) resumed losses {loss_b1} != (a)'s steps 5-12 "
             f"{loss_a[CKPT_EVERY:]}")
        same_params(torch, loops[-1].state.params, ref, "(b) final")
        out["b"] = {"resumed_steps": r.resumed_steps, "attempts": r.attempts,
                    "steps_run": ran, "losses_resumed": loss_b1,
                    "elapsed_s": r.elapsed_s, "launches": launches_b}
        say(f"  (b) supervised: attempts {r.attempts}, resumed "
            f"{r.resumed_steps}, {ran} steps run; steps 5-12 losses and "
            f"the final params bit-identical to (a)'s")
        del loops[:], ref, loop, state
        shutil.rmtree(f"{root}/b")

        # (c) a token file, native gather against numpy, then
        # transformer_train stopped at 8 and resumed to 12.
        data = f"{root}/tokens.bin"
        bs, t = args.batch_size, args.seq_len
        stream = token_batches(bs, t, cfg.vocab_size,
                               seed=tr.DATA_SEED + 22)
        TokenFileDataset.write(data, np.concatenate(
            [next(stream)["tokens"].ravel() for _ in range(CKPT_STEPS)]))
        t0 = time.perf_counter()
        need(_NativeTokenGather.load() is not None, "native gather build")
        build_s = time.perf_counter() - t0
        ds = TokenFileDataset(data)
        per = {}
        got = {}
        for native in (True, False):
            gen = ds.batches(bs, t, seed=tr.DATA_SEED, native=native)
            t0 = time.perf_counter()
            got[native] = [next(gen)["tokens"] for _ in range(CKPT_STEPS)]
            per[native] = (time.perf_counter() - t0) / CKPT_STEPS * 1e3
            gen.close()
        need(all(np.array_equal(a, b) for a, b in zip(got[True],
                                                        got[False])),
             "(c) native batches differ from numpy's")
        resumed = ds.batches(bs, t, seed=tr.DATA_SEED, start_step=8,
                             native=True)
        need(all(np.array_equal(next(resumed)["tokens"], b)
                 for b in got[False][8:]), "(c) start_step=8 differs")
        resumed.close()
        ckpt = f"{root}/c"
        argv = ["--data", data, "--ckpt-dir", ckpt, "--ckpt-every",
                str(CKPT_EVERY)]
        lines = []

        def main(steps):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = tr.main(argv + ["--steps", str(steps)])
            need(rc == 0, f"(c) transformer_train --steps {steps} rc {rc}")
            lines.append(buf.getvalue())
            for line in buf.getvalue().splitlines():
                say("    " + line)
            return buf.getvalue()

        zero_launches()
        main(8)
        need("resumed from step 8" in main(CKPT_STEPS),
             "(c) the second run did not resume from step 8")
        launches_c = read_launches()
        train_launches_exact(launches_c, L, CKPT_STEPS, "(c)")
        need("nothing to do" in main(CKPT_STEPS),
             "(c) the third run did not find nothing to do")
        need(read_launches() == launches_c, "(c) the third run launched")
        out["c"] = {"native_ms_per_batch": per[True],
                    "numpy_ms_per_batch": per[False],
                    "native_build_s": build_s,
                    "token_batches_ms_per_batch":
                        (train or {}).get("token_batches_ms_per_batch"),
                    "file_tokens": int(ds.tokens.size),
                    "launches": launches_c}
        say(f"  (c) {ds.tokens.size} tokens; host ms a batch: native "
            f"{per[True]:.2f}, numpy {per[False]:.2f}, token_batches "
            f"{out['c']['token_batches_ms_per_batch']} (phase 8); g++ "
            f"build {build_s:.2f} s; resumed at 8, then nothing to do")

        # (d) remat against the plain step, same weights and batch.
        master = tt.init_params(cfg, torch.Generator().manual_seed(0), cuda)
        batch = {"tokens": torch.from_numpy(got[False][0]).to(cuda)}

        def grads(remat):
            c = dataclasses.replace(cfg, remat=remat)
            flat = {k: v.detach().clone().requires_grad_()
                    for k, v in flatten(master).items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            t0 = time.perf_counter()
            loss, _ = tt.loss_fn(c, unflatten(flat), batch)
            g = torch.autograd.grad(loss, list(flat.values()))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            return (float(loss.detach()), dict(zip(flat, g)), read_launches(),
                    torch.cuda.max_memory_allocated(), ms)

        grads(False)                     # warm both: cuBLAS handles, pools
        grads(True)
        plain = grads(False)
        remat = grads(True)
        train_launches_exact(plain[2], L, 1, "(d) plain")
        train_launches_exact(remat[2], L, 1, "(d) remat", fwd_per_step=2)
        need(remat[0] == plain[0], f"(d) loss {remat[0]} != {plain[0]}")
        bad = [k for k in plain[1] if not torch.equal(remat[1][k],
                                                      plain[1][k])]
        need(not bad, f"(d) remat grads not bit-identical in {bad}")
        out["d"] = {"loss": plain[0], "peak_mem_gb_plain": plain[3] / 1e9,
                    "peak_mem_gb_remat": remat[3] / 1e9,
                    "ms_plain": plain[4], "ms_remat": remat[4],
                    "launches_plain": plain[2], "launches": remat[2]}
        say(f"  (d) remat: every grad leaf bit-identical to the plain "
            f"step's; flash_fwd {remat[2]['flash_fwd']} vs "
            f"{plain[2]['flash_fwd']}; peak memory {remat[3] / 1e9:.3f} "
            f"GB vs {plain[3] / 1e9:.3f} GB; fwd+bwd {remat[4]:.1f} ms "
            f"vs {plain[4]:.1f} ms")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# -- phase 23: the reference's own surface -----------------------------------

SURFACE_STEPS = 4           # (b): tfrun's transformer_train --steps
SURFACE_CHUNKS = 4          # (c): chunks of SURFACE_CHUNK_STEPS steps
SURFACE_CHUNK_STEPS = 2
SURFACE_KILL_AFTER = 2      # (c): rank 1 dies after this many chunks
MNIST_STEPS = 50
# (b): bf16 steps of a 2-rank mean against one rank on the whole batch
# (phase 9's card-vs-CPU bound).
SURFACE_DLOSS = 2e-2
# The flagship at the example's global batch; a CPU rehearsal swaps in
# the tiny preset and "cpu".
SURFACE_ARGV = ["--batch_size", "8", "--seq_len", "2048"]
SURFACE_DEVICE = None       # the card
CHUNK_FN = "tfmesos_tpu_torch.transformer_train:train_chunk"
PING = "tfmesos_tpu_torch.runtime:rank_hosts"


def gloo_allreduce_ms(ctx, numel: int, reps: int = 5) -> float:
    """Dispatched to every rank of a Mode-A cluster: the median ms of
    ``trainer.mesh_mean`` (the step's one collective) over a float32
    buffer of ``numel`` elements on this rank's device."""
    import torch

    from tfmesos_tpu_torch.train.trainer import mesh_mean

    mesh = ctx.mesh()
    buf = torch.ones(numel, device=ctx.device)

    def sync():
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)

    mesh_mean([buf], mesh)
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        mesh_mean([buf], mesh)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def child(argv, timeout: float):
    """``python -m <argv>`` from the checkout; (stdout, stderr, s)."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    need(p.returncode == 0, f"{' '.join(argv[:3])} exited {p.returncode}: "
         f"{p.stderr[-3000:]}\n(stdout) {p.stdout[-3000:]}")
    return p.stdout, p.stderr, secs


def start_children(argvs, timeout: float):
    """:func:`child` for several commands, all started at once: a future
    each, in order, whose result is that child's (stdout, stderr, s),
    s its own wall time."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(argvs))
    futures = [pool.submit(child, argv, timeout) for argv in argvs]
    pool.shutdown(wait=False)
    return futures


def children(argvs, timeout: float):
    """:func:`child` for several commands started together; their
    (stdout, stderr, s) in order."""
    return [f.result() for f in start_children(argvs, timeout)]


def surface_argvs():
    """Phase 23's child launches: (a) ``plus`` over two Mode-A ranks,
    (b) ``tfrun`` (Mode B) over two ranks of ``transformer_train``, (d)
    ``mnist_replica`` under ``tfrun``."""
    dev = ["--device", SURFACE_DEVICE] if SURFACE_DEVICE else []
    return [["tfmesos_tpu_torch.plus", *dev],
            ["tfmesos_tpu_torch.cli", "run", "-w", "2", "-s", "0",
             "--mesh", "dp=-1", "--worker-logs", "*", "--",
             sys.executable, "-m", "tfmesos_tpu_torch.transformer_train",
             "--steps", str(SURFACE_STEPS), *SURFACE_ARGV, *dev],
            ["tfmesos_tpu_torch.cli", "run", "-w", "2", "-s", "1",
             "--worker-logs", "*", "--", sys.executable, "-m",
             "tfmesos_tpu_torch.mnist_replica", "--train_steps",
             str(MNIST_STEPS), *dev]]


def phase_surface(torch, np, train, launched):
    """Phase 23: ``plus`` (a), ``tfrun`` over ``transformer_train`` (b),
    Mode A under the elastic policy with a killed rank (c),
    ``mnist_replica`` under ``tfrun`` (d); ``launched`` the futures of
    (a), (b) and (d) (:func:`surface_argvs`), started before this phase
    together with phase 27's launches."""
    import os
    import shutil
    import signal
    import tempfile

    from tfmesos_tpu_torch import ClusterError, Job, cluster
    from tfmesos_tpu_torch import transformer_train as tr
    from tfmesos_tpu_torch.convert import flatten
    from tfmesos_tpu_torch.train.checkpoint import (STATE_FILE,
                                                    CheckpointManager)
    from tfmesos_tpu_torch.train.data import token_batches

    say("[23/28] the reference's surface: plus, tfrun, Mode A under the "
        "elastic policy, mnist_replica (ranks share the card over gloo)")
    dev = ["--device", SURFACE_DEVICE] if SURFACE_DEVICE else []
    device = torch.device(SURFACE_DEVICE or "cuda")
    out = {}

    # (a), (b) and (d) are independent launches, already running beside
    # phase 27's two; (c) runs in this process while they run; each is
    # checked below as it was alone.  (b)'s one-process run is set up
    # first: (c) all-reduces its gradients' size.
    args = tr.parse_args(["--steps", str(SURFACE_STEPS), *SURFACE_ARGV,
                          *dev])
    run = tr.setup(args, device, start_step=None)
    n_params = sum(p.numel() for p in flatten(run.params).values())

    # (c) Mode A under the elastic policy, rank 1 killed after chunk 2.
    root = tempfile.mkdtemp(prefix="chip-smoke-surface-")
    resumed, uninterrupted = f"{root}/resumed", f"{root}/uninterrupted"
    argv = [*SURFACE_ARGV, *dev]
    S, N = SURFACE_CHUNK_STEPS, SURFACE_CHUNKS
    extra = {"device": SURFACE_DEVICE} if SURFACE_DEVICE else {}
    try:
        t0 = time.perf_counter()
        with cluster(Job(name="worker", num=2, cpus=1.0, mem=1024.0),
                     quiet=True, start_timeout=300.0, extra_config=extra,
                     restart_policy="elastic", max_cluster_restarts=2,
                     restart_backoff=0.5, restart_jitter=0.0,
                     restart_seed=0) as c:
            # Both ranks answer once their process group has formed.
            c.run_all(PING)
            up_s = time.perf_counter() - t0
            allreduce = c.run_all(gloo_allreduce_ms, n_params)
            replies, chunk, killed = {}, 0, None
            ready_s = reform_s = None
            while chunk < N:
                try:
                    rs = c.run_all(CHUNK_FN, argv, resumed, chunk * S, S)
                except ClusterError as e:
                    need(killed is not None and reform_s is None,
                         f"(c) unexpected ClusterError: {e}")
                    need(c.wait_ready(timeout=300.0),
                         "(c) the gang did not re-form")
                    ready_s = time.perf_counter() - killed[1]
                    c.run_all(PING)
                    reform_s = time.perf_counter() - killed[1]
                    latest = CheckpointManager(resumed).latest_step()
                    need(latest == SURFACE_KILL_AFTER * S,
                         f"(c) latest checkpoint {latest}")
                    chunk = latest // S
                    continue
                replies[chunk] = rs
                chunk += 1
                if chunk == SURFACE_KILL_AFTER and killed is None:
                    killed = (rs[1]["pid"], time.perf_counter())
                    os.kill(rs[1]["pid"], signal.SIGKILL)
            stats = c.restart_stats
            want = [c.run_all(CHUNK_FN, argv, uninterrupted, i * S, S)
                    for i in range(N)]
        need(reform_s is not None and stats["generation"] == 1
             and stats["cluster_restarts"] == 1,
             f"(c) no re-formation at generation 1: {stats}")
        need(replies[SURFACE_KILL_AFTER][0]["pid"]
             != replies[SURFACE_KILL_AFTER - 1][0]["pid"],
             "(c) the resumed chunk ran in the old gang")
        for i in range(N):
            for r in (0, 1):
                need(replies[i][r]["losses"] == want[i][r]["losses"],
                     f"(c) chunk {i} rank {r}: losses "
                     f"{replies[i][r]['losses']} != uninterrupted "
                     f"{want[i][r]['losses']}")
            need(replies[i][0]["losses"] == replies[i][1]["losses"],
                 f"(c) chunk {i}: the ranks' losses differ")
        final = [torch.load(f"{d}/step_{N * S}/{STATE_FILE}",
                            weights_only=True)
                 for d in (resumed, uninterrupted)]
        need(sorted(final[0]) == sorted(final[1]), "(c) state keys differ")
        bad = [k for k in final[0]
               if not (torch.equal(final[0][k], final[1][k])
                       if isinstance(final[0][k], torch.Tensor)
                       else final[0][k] == final[1][k])]
        need(not bad, f"(c) final state not bit-identical in {bad}")
        L = 8 if "--tiny" not in argv else 2
        launches = collections.Counter()
        for label, runs in (("resumed", replies), ("uninterrupted",
                                                   dict(enumerate(want)))):
            for i, rs in runs.items():
                for r in rs:
                    train_launches_exact(r["launches"], L, S,
                                         f"(c) {label} chunk {i} rank "
                                         f"{r['rank']}")
                    launches.update(r["launches"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    chunk_ms = [r["elapsed_s"] / S * 1e3 for rs in want[1:] for r in rs]
    out["c"] = {"bring_up_s": up_s, "wait_ready_s": ready_s,
                "reform_s": reform_s,
                "restart_stats": stats,
                "losses": [rs[0]["losses"] for rs in want],
                "dp2_ms_per_step": statistics.median(chunk_ms),
                "allreduce_ms": statistics.median(allreduce),
                "allreduce_numel": n_params,
                "launches": {k: launches[k] for k in read_launches()}}
    say(f"  (c) elastic Mode A: bring-up {up_s:.2f} s; rank 1 killed after "
        f"chunk {SURFACE_KILL_AFTER}, re-formed at generation "
        f"{stats['generation']}: wait_ready {ready_s:.2f} s and both "
        f"ranks answering {reform_s:.2f} s after the kill; resumed "
        f"from step {SURFACE_KILL_AFTER * S}; every chunk's losses and the "
        f"final state bit-identical to the uninterrupted run's")

    (a_out, a_err, a_s), (b_out, _, b_s), (d_out, _, d_s) = [
        f.result() for f in launched]
    need(a_out.strip().splitlines()[-1] == "42",
         f"(a) plus printed {a_out!r}")
    diag = [line for line in a_err.splitlines() if line.startswith("plus:")]
    kind = device.type + (":0" if device.type == "cuda" else "")
    need(diag == [f"plus: ['{kind}', '{kind}'] over gloo"],
         f"(a) plus ran on {diag}")
    out["a"] = {"printed": 42, "s": a_s, "ranks": diag[0]}
    say(f"  (a) plus printed 42 in {a_s:.1f} s: {diag[0]}")

    stdout, secs = b_out, b_s
    got = dict(re.findall(r"^\[worker:(\d)\] rank \d/2 step losses: "
                          r"(\[.*\])$", stdout, re.M))
    need(sorted(got) == ["0", "1"], f"(b) missing rank losses: {stdout}")
    need(got["0"] == got["1"], f"(b) the ranks' losses differ: {got}")
    losses = json.loads(got["0"])
    tps = re.search(r"^\[worker:0\] tokens/sec: (\d+) \(per card: "
                    r"(\d+)\)$", stdout, re.M)
    need(tps is not None and "[worker:0] Training elapsed time" in stdout,
         f"(b) rank 0's closing lines missing: {stdout[-2000:]}")
    half = tr.local_batch(args, 2)
    streams = [token_batches(half, run.seq_len, run.cfg.vocab_size,
                             seed=tr.DATA_SEED + r) for r in (0, 1)]
    ref, step_ms = [], []
    for _ in range(SURFACE_STEPS):
        batch = {"tokens": torch.from_numpy(np.concatenate(
            [next(s)["tokens"] for s in streams])).to(device)}
        t0 = time.perf_counter()
        run.params, run.opt_state, m = run.step(run.params, run.opt_state,
                                                batch)
        ref.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del run, m, batch
    gc.collect()
    dl = max(abs(a - b) for a, b in zip(losses, ref))
    need(len(losses) == SURFACE_STEPS and dl <= SURFACE_DLOSS,
         f"(b) tfrun losses {losses} vs one process {ref}: |dloss| {dl}")
    out["b"] = {"s": secs, "losses": losses, "one_process_losses": ref,
                "max_dloss": dl, "tokens_per_s": int(tps.group(1)),
                "one_process_ms_per_step": statistics.median(step_ms[1:])}
    say(f"  (b) tfrun -w 2 in {secs:.1f} s: losses {losses}, one process "
        f"{ref} (max |dloss| {dl:.2e}); {tps.group(1)} tokens/s over both "
        f"ranks")

    # (d) mnist_replica under tfrun, three ranks (started with (a) and
    # (b)).
    stdout, secs = d_out, d_s
    for i in (0, 1):
        for line in ("job name = worker", f"task index = {i}",
                     "Training begins @",
                     f"Worker {i}: training step {MNIST_STEPS} done",
                     "Training elapsed time:", "steps/sec:",
                     f"After {MNIST_STEPS} training step(s), validation "
                     f"cross entropy = ", "validation accuracy = "):
            need(re.search(rf"^\[worker:{i}\] .*{re.escape(line)}", stdout,
                           re.M) is not None,
                 f"(d) worker {i} lacks {line!r}: {stdout[-3000:]}")
    ce = re.findall(r"validation cross entropy = (\S+)$", stdout, re.M)
    need(len(ce) == 5 and len(set(ce)) == 1,
         f"(d) ranks' validation cross entropy differ: {ce}")
    rate = re.search(r"^\[worker:0\] steps/sec: (\S+)", stdout, re.M)
    acc = re.search(r"^\[worker:0\] validation accuracy = (\S+)", stdout,
                    re.M)
    out["d"] = {"s": secs, "cross_entropy": float(ce[0]),
                "accuracy": float(acc.group(1)),
                "steps_per_s": float(rate.group(1))}
    say(f"  (d) mnist_replica -w 2 -s 1 in {secs:.1f} s: validation cross "
        f"entropy {ce[0]} on every rank, accuracy {acc.group(1)}, "
        f"{rate.group(1)} steps/s")
    say(f"  timings: bring-up to both ranks answering {up_s:.2f} s, kill "
        f"to wait_ready {ready_s:.2f} s (to answering {reform_s:.2f} s); "
        f"ms a step: one process at the global batch "
        f"{out['b']['one_process_ms_per_step']:.1f} (phase 8's loop "
        f"{train['ms_per_step']:.1f}), two ranks on half each "
        f"{out['c']['dp2_ms_per_step']:.1f}, of which the gloo all-reduce "
        f"of {n_params} float32 gradients "
        f"{out['c']['allreduce_ms']:.1f}.  Two ranks on one card measure "
        f"no scaling, and gloo staging through host memory is not NCCL.")
    say("  " + json.dumps(out))
    return out


# -- phase 27: MoE, ep and sp --------------------------------------------------

# (a): the flagship with 8 experts, each token to 2 of them, the dense
# top-k form (exact per token, so the margin rule holds a stream; the
# switch form's capacity makes a row depend on its tick's other rows).
MOE_SERVE = dict(n_experts=8, top_k=2, moe_impl="dense")
# (b), (c): phase 8's shape, 4 steps, each held to one process of the
# same config and seed: |dloss| within the mesh phase's bound, and the
# switch overflow fraction within 1e-2 (a bf16 near-tie in the router
# moves an assignment's slot, and one drop more or less changes the
# fraction by 1 / 32768).
MOE_STEPS = 4
MOE_DLOSS = 2e-2
MOE_DOVERFLOW = 1e-2
MOE_TRAIN = {
    "b": (4, "sp=2,ep=2", ["--moe", "8", "--top-k", "2"]),
    "c": (2, "sp=2", ["--sp-impl", "ulysses", "--kv-heads", "4"]),
}


def moe_argv(key):
    """(b) or (c)'s ``tfrun`` command over ``transformer_train``."""
    n, mesh, extra = MOE_TRAIN[key]
    return ["tfmesos_tpu_torch.cli", "run", "-w", str(n), "-s", "0",
            "--mesh", mesh, "--worker-logs", "*", "--", sys.executable,
            "-m", "tfmesos_tpu_torch.transformer_train", "--steps",
            str(MOE_STEPS), *MESH_TRAIN_ARGV, *extra]


def moe_rank_lines(stdout, n, what):
    """Each rank's step losses, router metrics, kernel launches and peak
    memory from a ``tfrun --worker-logs '*'`` run's output."""
    def grab(tag):
        got = dict(re.findall(rf"^\[worker:(\d)\] rank \d/{n} {tag}: "
                              r"(.*)$", stdout, re.M))
        return {int(r): v for r, v in got.items()}

    losses, launches = grab("step losses"), grab("kernel launches")
    need(sorted(losses) == list(range(n)) and sorted(launches)
         == list(range(n)), f"{what}: missing rank lines: {stdout[-3000:]}")
    moe = {r: json.loads(v) for r, v in grab("step moe metrics").items()}
    mem = {r: float(v.split()[0]) for r, v in
           grab("peak device memory").items()}
    return ({r: json.loads(v) for r, v in losses.items()}, moe,
            {r: json.loads(v) for r, v in launches.items()}, mem)


def moe_references(torch):
    """(b) and (c)'s one-process references (:func:`moe_one_process`)
    while their launches run: each one's (losses, overflow, s)."""
    refs = {}
    for k, (_, _, extra) in MOE_TRAIN.items():
        t0 = time.perf_counter()
        refs[k] = moe_one_process(torch, extra) + (time.perf_counter() - t0,)
    return refs


def moe_one_process(torch, extra):
    """The same config, seed and global batch in this process (no mesh):
    each step's loss and router metrics."""
    from tfmesos_tpu_torch import transformer_train as tr

    args = tr.parse_args(["--steps", str(MOE_STEPS), *MESH_TRAIN_ARGV,
                          *extra])
    run = tr.setup(args, torch.device("cuda"), start_step=None)
    stream = tr.data_stream(args, run.cfg, run.seq_len, 0, 0, 1)
    losses, overflow = [], []
    for _ in range(MOE_STEPS):
        batch = {"tokens": torch.from_numpy(next(stream)["tokens"]).cuda()}
        run.params, run.opt_state, m = run.step(run.params, run.opt_state,
                                                batch)
        losses.append(float(m["loss"]))
        if "moe_overflow_frac" in m:
            overflow.append(float(m["moe_overflow_frac"]))
    del run, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    return losses, overflow


def moe_train_check(key, result, ref):
    """(b) or (c) from its launch's ``result`` and its one-process
    ``ref`` (losses, overflow, seconds): every rank's losses equal (the
    mesh's mean), within MOE_DLOSS of one process's, the overflow
    fraction within MOE_DOVERFLOW; every rank's attention launches exact
    (the ring's visible steps on an sp rank, Ulysses' one call over the
    whole sequence)."""
    n, mesh, extra = MOE_TRAIN[key]
    stdout, _, secs = result
    what = f"({key}) tfrun -w {n} --mesh {mesh} {' '.join(extra)}"
    losses, moe, launches, mem = moe_rank_lines(stdout, n, what)
    need(all(losses[r] == losses[0] for r in losses),
         f"{what}: the ranks' losses differ: {losses}")
    ref, ref_over, ref_s = ref
    dl = max(abs(a - b) for a, b in zip(losses[0], ref))
    need(len(losses[0]) == MOE_STEPS and dl <= MOE_DLOSS,
         f"{what}: losses {losses[0]} vs one process {ref}: |dloss| {dl}")
    out = {"s": secs, "losses": losses[0], "one_process_losses": ref,
           "max_dloss": dl, "peak_gib_by_rank": mem,
           "one_process_s": ref_s}
    if "--moe" in extra:
        over = moe[0]["moe_overflow_frac"]
        do = max(abs(a - b) for a, b in zip(over, ref_over))
        need(all(moe[r] == moe[0] for r in moe) and do <= MOE_DOVERFLOW,
             f"{what}: overflow {over} vs one process {ref_over}")
        out.update(moe_metrics=moe[0], one_process_overflow=ref_over,
                   max_doverflow=do)
    L = 8
    total = collections.Counter()
    for r, counts in launches.items():
        sp_idx = r % 2                     # sp is the inner axis here
        per = (sp_idx + 1) if "--sp-impl" not in extra else 1
        want = MOE_STEPS * L * per
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            need(counts[k] == want, f"{what}: rank {r} launched {k} "
                 f"{counts[k]} times, want {want} ({per} a layer a step)")
        need(all(v == 0 for k, v in counts.items()
                 if k not in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
             f"{what}: rank {r} launched {counts}")
        total.update(counts)
    out["launches"] = dict(total)
    tps = re.search(r"^\[worker:0\] tokens/sec: (\d+)", stdout, re.M)
    out["tokens_per_s"] = int(tps.group(1)) if tps else None
    say(f"  ({key}) {what} in {secs:.1f} s: losses {losses[0]}, one "
        f"process {ref} (max |dloss| {dl:.2e})"
        + (f"; overflow {out['moe_metrics']['moe_overflow_frac']} vs "
           f"{ref_over}" if "moe_metrics" in out else "")
        + f"; {out['tokens_per_s']} tokens/s over the ranks; peak GiB "
        f"by rank {mem}; launches {dict(total)}")
    return out


def phase_moe(torch, np, reqs, launched, refs):
    """Phase 27: (a) an MoE config served in this process; (b) tfrun
    sp=2,ep=2 over transformer_train --moe 8 --top-k 2 (switch); (c)
    tfrun sp=2 --sp-impl ulysses (dense); ``launched`` the futures of
    (b) and (c) (:func:`moe_argv`), started before phase 23 together
    with its launches, ``refs`` their :func:`moe_references`."""
    from tfmesos_tpu_torch.convert import flatten
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.ops import quant as tq
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    say("[27/28] MoE, ep and sp: the flagship with 8 experts (top 2) "
        "served; tfrun sp=2,ep=2 --moe 8 and sp=2 --sp-impl ulysses "
        "training (ranks share the card over gloo)")
    out = {}
    cfg = tt.TransformerConfig(vocab_size=8192, d_model=512, n_layers=8,
                               n_heads=8, d_ff=1408, max_seq_len=1024,
                               dtype=torch.bfloat16, **MOE_SERVE)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    card = _cuda(params)

    # quantize_params over the MoE tree: one launch, bit-exact.
    zero_launches()
    q = tt.quantize_params(cfg, card)
    torch.cuda.synchronize()
    q_launches = read_launches()
    need(q_launches["quant_int8"] == 1
         and all(v == 0 for k, v in q_launches.items() if k != "quant_int8"),
         f"(a) quantize_params over the MoE tree launched {q_launches}, "
         f"not one quant_int8")
    flat = flatten(card)
    qflat = {k: v for k, v in flatten(q).items()}
    n_leaves = 0
    for name, leaf in flat.items():
        if f"{name}/values" not in qflat:
            continue
        n_leaves += 1
        rv, rs = tq.quantize_int8_reference(leaf.reshape(-1, leaf.shape[-1]))
        need(torch.equal(qflat[f"{name}/values"].reshape(rv.shape), rv)
             and torch.equal(qflat[f"{name}/scales"].reshape(rs.shape), rs),
             f"(a) quantize_params {name} not bit-exact to its plain "
             f"version")
    need({"layers/e_gate/values", "layers/e_up/values",
          "layers/e_down/values"} <= set(qflat)
         and "layers/router" in qflat,
         "(a) quantize_params left an expert leaf fp or took the router")
    q_ms = cuda_ms(torch, lambda: tt.quantize_params(cfg, card), 3, 5)
    # Its plain version (a reference call a leaf) and its bound: each
    # float32 element read once, its int8 and each row's float32 scale
    # written once (the bound of phase 4's nine flagship leaves).
    rows = [leaf.reshape(-1, leaf.shape[-1]) for name, leaf in flat.items()
            if f"{name}/values" in qflat]
    del q, qflat
    plain_ms = cuda_ms(torch, lambda: [tq.quantize_int8_reference(x)
                                       for x in rows], 3, 5)
    bound_ms, bound_by = bound(sum(x.numel() * 5 + 4 * x.shape[0]
                                   for x in rows),
                               sum(5 * x.numel() for x in rows), F32_FLOPS)
    out["quantize"] = {"leaves": n_leaves, "launches": q_launches,
                       "ms": q_ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "elements": sum(x.numel() for x in rows)}
    del rows
    say(f"  (a) quantize_params over the MoE tree: {n_leaves} leaves "
        f"({out['quantize']['elements']} elements) in one launch, "
        f"bit-exact, {q_ms:.3f} ms; plain_ms {plain_ms:.3f}, bound_ms "
        f"{bound_ms:.5f} ({bound_by}), {bound_ms / q_ms:.0%} of the "
        f"bound")

    batcher = ContinuousBatcher(cfg, card, rows=8, page_size=64,
                                prefill_bucket=64, device="cuda")
    warm = warm_batcher(batcher)
    warmed = set(batcher._graphs.keys())
    list(batcher.run([Request(np.arange(1, 9), 2)]))
    comps, stats = serve_run(torch, cfg, batcher, reqs, int8=False)
    no_new_graphs(batcher, warmed, "(a) MoE serving")
    t0 = time.perf_counter()
    checked, positions = fp32_margin(torch, cfg, params, comps,
                                     "(a) MoE serving")
    stats.update(warmup=warm, margin_checked=checked,
                 margin_positions=positions,
                 margin_check_s=time.perf_counter() - t0)
    out["a"] = stats
    say(f"  (a) served {stats['requests']} requests graphed: "
        f"{stats['ms_per_tick']:.3f} ms a tick, TTFT mean "
        f"{stats['ttft_ms_mean']:.3f} p50 {stats['ttft_ms_p50']:.3f} ms, "
        f"{stats['decode_tok_per_s']:.0f} decode tokens/s; launches "
        f"{stats['launches']}; no graph after warmup; {checked} of "
        f"{positions} positions above the margin, all the CPU float32 "
        f"argmax ({stats['margin_check_s']:.1f} s on the CPU)")
    del batcher, card, comps
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    results = [f.result() for f in launched]
    say(f"  (waited {time.perf_counter() - t0:.1f} s for (b) and (c))")
    for key, result in zip(MOE_TRAIN, results):
        out[key] = moe_train_check(key, result, refs[key])
    say("  " + json.dumps(out))
    return out


# -- phase 28: pipeline parallelism (the pp axis) ---------------------------

# Phase 8's shape (B 8, T 2048), 4 steps over ``tfrun``: the three
# schedules on pp=2 and the dense top-k MoE over pp=2 x ep=2 on 1F1B.
# Each is held to one process in this process: every step's loss within
# MESH_DLOSS, every gathered gradient leaf of the first step (the
# launch's ``--grads-out``) at cosine >= MESH_MIN_COS; the MoE's one
# process averages its loss over the pipeline's 2 microbatches (the
# router aux is a microbatch estimator under pp, as in JAX).
PP_MICROBATCHES = 2             # the pipeline's default: pp
PP_LAYERS_A_RANK = 4            # 8 layers over pp=2
PP_TRAIN = {
    "a": (2, "pp=2", ["--pp-schedule", "gpipe"]),
    "b": (2, "pp=2", ["--pp-schedule", "1f1b"]),
    "c": (2, "pp=2", ["--pp-schedule", "circular", "--virtual-stages",
                      "2"]),
    "d": (4, "pp=2,ep=2", ["--pp-schedule", "1f1b", "--moe", "8",
                           "--top-k", "2"]),
}
# (b) against (a), the same math on another timetable: the same bf16
# products (1F1B recomputes a chunk's forward from its stashed input,
# bit for bit), float32 sums in another order (the loss tail chunks a
# microbatch where gpipe's fused CE chunks the batch).
PP_B_VS_A_DLOSS = 1e-3
PP_B_VS_A_MIN_COS = 0.9999
# A rank's memory after the first step (params and AdamW state) against
# one process's: the share of the params it holds, +-0.05.
PP_MEM_TOL = 0.05


def pp_argv(key, grads_dir):
    """(a)-(d)'s ``tfrun`` command over ``transformer_train``, its first
    step's gradients written to ``grads_dir/<key>.npz``."""
    n, mesh, extra = PP_TRAIN[key]
    return ["tfmesos_tpu_torch.cli", "run", "-w", str(n), "-s", "0",
            "--mesh", mesh, "--worker-logs", "*", "--", sys.executable,
            "-m", "tfmesos_tpu_torch.transformer_train", "--steps",
            str(MESH_TRAIN_STEPS), *MESH_TRAIN_ARGV, *extra, "--grads-out",
            f"{grads_dir}/{key}.npz", "--time-collectives"]


class SmiMemory:
    """The card's memory in use (``nvidia-smi``), sampled every
    ``period`` s on a thread from :meth:`start` to :meth:`stop` (which
    returns the largest sample, in MiB)."""

    def __init__(self, period: float = 1.0):
        import threading

        self.period, self.samples = period, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _poll(self):
        while not self._stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "-i", "0", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60)
            if out.returncode == 0 and out.stdout.strip():
                self.samples.append(float(out.stdout.strip()))
            self._stop.wait(self.period)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=120)
        return max(self.samples, default=None)


def train_reference(torch, extra=(), shards: int = 1,
                    microbatches: int = 1):
    """One process of a ``transformer_train`` config (``extra``: its
    flags; experts in the dense top-k form) over the global batch of
    ``shards`` data shards' streams (the mesh's) in this process, its
    loss the mean over ``microbatches`` equal blocks: each step's loss,
    the first step's gradients (float32 on the host), its memory after
    the first step (less what stays once the run is freed) and its ms
    a step."""
    import numpy as np

    from tfmesos_tpu_torch import transformer_train as tr
    from tfmesos_tpu_torch.convert import flatten
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.train import optim
    from tfmesos_tpu_torch.train.trainer import make_train_step

    dev = torch.device("cuda")
    args = tr.parse_args(["--steps", str(MESH_TRAIN_STEPS),
                          *MESH_TRAIN_ARGV, *extra])
    run = tr.setup(args, dev, start_step=None)
    cfg = dataclasses.replace(run.cfg, moe_impl="dense")
    opt = optim.adamw(args.learning_rate, weight_decay=0.01)
    step = make_train_step(lambda p, b: tt.loss_fn(cfg, p, b), opt,
                           grad_accum=microbatches)
    state = opt.init(run.params)
    streams = [tr.data_stream(args, cfg, run.seq_len, 0, i, shards)
               for i in range(shards)]
    batches = [{"tokens": torch.from_numpy(np.concatenate(
        [next(s_)["tokens"] for s_ in streams])).to(dev)}
        for _ in range(MESH_TRAIN_STEPS)]
    grads = step.grads(run.params, batches[0])[0]
    grads = {k: v.detach().float().cpu() for k, v in flatten(grads).items()}
    losses, mem_first = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        run.params, state, m = step(run.params, state, batch)
        losses.append(m["loss"])
        if i == 0:
            mem_first = torch.cuda.memory_allocated(dev)
            losses[0] = float(losses[0])
            t0 = time.perf_counter()
    losses = [float(v) for v in losses]
    ms = (time.perf_counter() - t0) / (MESH_TRAIN_STEPS - 1) * 1e3
    del run, state, m, batches, step
    gc.collect()
    mem = mem_first - torch.cuda.memory_allocated(dev)
    torch.cuda.empty_cache()
    return {"losses": losses, "grads": grads, "mem_bytes": mem,
            "ms_per_step": ms}


def train_references(torch, out_dir):
    """The one-process references of phase 24 (d) and phase 28, while
    their launches run: the flagship on phase 8's stream (phase 28 (a)-(c)
    and 24 (d)'s tp=2, written to ``out_dir/dense.npz`` for its gang),
    the MoE of 28 (d) over the pipeline's microbatches, and 24 (d)'s
    fsdp=2 global batch (two data shards' streams)."""
    import numpy as np

    refs = {}
    for label, kw in (("dense", {}),
                      ("moe", dict(extra=["--moe", "8", "--top-k", "2"],
                                   microbatches=PP_MICROBATCHES)),
                      ("fsdp", dict(shards=2))):
        t0 = time.perf_counter()
        refs[label] = train_reference(torch, **kw)
        refs[label]["s"] = time.perf_counter() - t0
    dense = refs["dense"]
    np.savez(f"{out_dir}/dense.npz", losses=np.asarray(dense["losses"]),
             mem_bytes=np.asarray(dense["mem_bytes"]),
             ms_per_step=np.asarray(dense["ms_per_step"]),
             **{f"grad/{k}": v.numpy() for k, v in dense["grads"].items()})
    return refs


def tfrun_rank_lines(stdout, n, what):
    """Each rank's losses, launches, params held, memory after the first
    step, collectives' ms a step and peak memory from a ``tfrun
    --worker-logs '*'`` run of ``transformer_train --time-collectives``
    on the card."""
    def grab(tag):
        got = dict(re.findall(rf"^\[worker:(\d)\] rank \d/{n} {tag}: "
                              r"(.*)$", stdout, re.M))
        return {int(r): v for r, v in got.items()}

    rows = {tag: grab(tag) for tag in (
        "step losses", "kernel launches", "params held",
        "memory after the first step", "collectives", "peak device memory")}
    for tag, got in rows.items():
        need(sorted(got) == list(range(n)), f"{what}: missing "
             f"'{tag}' rank lines: {stdout[-3000:]}")
    out = {}
    for r in range(n):
        held, _, total = rows["params held"][r].split()
        coll = re.match(r"([\d.]+) ms a step of ([\d.]+)",
                        rows["collectives"][r])
        out[r] = {"losses": json.loads(rows["step losses"][r]),
                  "launches": json.loads(rows["kernel launches"][r]),
                  "held": int(held) / int(total),
                  "mem_bytes": int(rows["memory after the first step"][r]
                                   .split()[0]),
                  "collective_ms": float(coll.group(1)),
                  "ms_per_step": float(coll.group(2)),
                  "peak_gib": float(rows["peak device memory"][r]
                                    .split()[0])}
    return out


def grad_cosines(got, want):
    """Each leaf's cosine between two flat gradient dicts (numpy and
    torch leaves alike)."""
    import numpy as np

    cos = {}
    for k, w in want.items():
        g = np.asarray(got[k], np.float64).ravel()
        w = np.asarray(w, np.float64).ravel()
        cos[k] = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)
                                + 1e-30))
    return cos


def pp_launches_exact(counts, key, rank, what):
    """Rows 1-3 on a rank as the timetable gives them: gpipe and
    circular run each of a rank's layers once a microbatch forward and
    once backward; 1F1B runs the forward twice on every chunk but the
    last (its forward tick, then its backward's recompute), once on the
    last chunk (its backward's recompute only)."""
    n, _, extra = PP_TRAIN[key]
    stage = rank // (n // 2)              # pp is the outer axis
    base = PP_LAYERS_A_RANK * PP_MICROBATCHES * MESH_TRAIN_STEPS
    twice = "1f1b" in extra and stage == 0
    want = {"flash_fwd": base * (2 if twice else 1), "flash_bwd_dq": base,
            "flash_bwd_dkv": base}
    for k, v in counts.items():
        need(v == want.get(k, 0), f"{what}: rank {rank} launched {k} {v} "
             f"times, want {want.get(k, 0)}")


def tfrun_train_check(what, n, result, ref, grads_path, launches_exact,
                      mem_ok):
    """A ``tfrun`` launch of ``transformer_train --grads-out
    --time-collectives`` held to its one-process ``ref``: every rank's
    losses equal, each step within MESH_DLOSS; every gathered gradient
    leaf of the first step at cosine >= MESH_MIN_COS;
    ``launches_exact(counts, rank)`` on each rank's launches and
    ``mem_ok(share, held)`` on its memory after the first step over one
    process's and the share of the params it holds.  Returns the
    numbers and the first step's (loss, gradients)."""
    import numpy as np

    stdout, _, secs = result
    ranks = tfrun_rank_lines(stdout, n, what)
    losses = ranks[0]["losses"]
    need(all(r["losses"] == losses for r in ranks.values()),
         f"{what}: the ranks' losses differ: "
         f"{[r['losses'] for r in ranks.values()]}")
    dl = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
    need(len(losses) == MESH_TRAIN_STEPS and dl <= MESH_DLOSS,
         f"{what}: losses {losses} vs one process {ref['losses']}")
    got = dict(np.load(grads_path))
    first_loss = float(got.pop("loss"))
    need(sorted(got) == sorted(ref["grads"]), f"{what}: gradient leaves "
         f"{sorted(got)}")
    cos = grad_cosines(got, ref["grads"])
    need(min(cos.values()) >= MESH_MIN_COS,
         f"{what}: gradient cosines {cos}")
    for r, row in ranks.items():
        launches_exact(row["launches"], r)
        row["mem_share"] = row["mem_bytes"] / ref["mem_bytes"]
        need(mem_ok(row["mem_share"], row["held"]),
             f"{what}: rank {r}'s memory after the first step is "
             f"{row['mem_share']:.3f} of one process's, its params "
             f"{row['held']:.3f}")
    ms = statistics.median(r["ms_per_step"] for r in ranks.values())
    coll = statistics.median(r["collective_ms"] for r in ranks.values())
    by_rank = [(r, row["launches"]) for r, row in ranks.items()]
    out = {"s": secs, "losses": losses, "one_process_losses": ref["losses"],
           "max_dloss": dl, "min_cosine": min(cos.values()),
           "ms_per_step": ms, "collective_ms_per_step": coll,
           "collective_share": coll / ms,
           "one_process_ms_per_step": ref["ms_per_step"],
           "held_share": {r: row["held"] for r, row in ranks.items()},
           "mem_share": {r: row["mem_share"] for r, row in ranks.items()},
           "peak_gib_by_rank": {r: row["peak_gib"]
                                for r, row in ranks.items()},
           "launches_by_rank": {r: row["launches"]
                                for r, row in ranks.items()},
           "launches": {k: sum(row["launches"][k] for row in
                               ranks.values())
                        for k in ranks[0]["launches"]}}
    say(f"  {what} in {secs:.1f} s: losses {losses}, one process "
        f"{[round(v, 4) for v in ref['losses']]} (max |dloss| {dl:.2e}); "
        f"gradient cosines >= {min(cos.values()):.5f}; memory a rank "
        f"{[round(x, 3) for x in out['mem_share'].values()]} of one "
        f"process's (params held "
        f"{[round(x, 3) for x in out['held_share'].values()]}); "
        f"{ms:.1f} ms a step ({coll:.1f} in gloo collectives, "
        f"{coll / ms:.0%}) against one process's "
        f"{ref['ms_per_step']:.1f}; peak GiB by rank "
        f"{out['peak_gib_by_rank']}; launches by rank "
        f"{ {r: {k: v for k, v in c.items() if v} for r, c in by_rank} }")
    return out, (first_loss, got)


def phase_pipeline(torch, launched, refs, grads_dir, smi_mem):
    """Phase 28: tfrun pp=2 over transformer_train on gpipe (a), 1F1B
    (b) and circular with 2 virtual stages (c), and pp=2 x ep=2 with 8
    experts, top 2, dense top-k, on 1F1B (d); ``launched`` their futures
    (:func:`pp_argv`), started with phase 24's, ``refs`` their
    :func:`train_references`, ``smi_mem`` the card's memory sampler that
    ran beside them."""
    import numpy as np

    say("[28/28] pipeline parallelism: tfrun pp=2 over transformer_train "
        "on gpipe, 1F1B and circular (2 virtual stages), and pp=2,ep=2 "
        "with 8 experts (top 2, dense top-k) on 1F1B (ranks share the "
        "card over gloo)")
    t0 = time.perf_counter()
    results = [f.result() for f in launched]
    peak = smi_mem.stop()
    say(f"  (waited {time.perf_counter() - t0:.1f} s for (a)-(d); the "
        f"card's memory in use peaked at {peak} MiB while they ran)")
    out, firsts = {"smi_peak_mib": peak}, {}
    for key, result in zip(PP_TRAIN, results):
        n, mesh, extra = PP_TRAIN[key]
        out[key], firsts[key] = tfrun_train_check(
            f"({key}) tfrun -w {n} --mesh {mesh} {' '.join(extra)}", n,
            result, refs["moe" if "--moe" in extra else "dense"],
            f"{grads_dir}/{key}.npz",
            lambda counts, r, key=key, what=key: pp_launches_exact(
                counts, key, r, f"({what})"),
            lambda share, held: abs(share - held) <= PP_MEM_TOL)
    # (b) against (a): the same model and batch on another timetable.
    (la, ga), (lb, gb) = firsts["a"], firsts["b"]
    cos = grad_cosines(gb, ga)
    need(abs(la - lb) <= PP_B_VS_A_DLOSS
         and min(cos.values()) >= PP_B_VS_A_MIN_COS,
         f"(b) against (a): first-step loss {lb} vs {la}, gradient "
         f"cosines {cos}")
    worst = max(float(np.abs(gb[k] - ga[k]).max()
                      / (np.abs(ga[k]).max() + 1e-30)) for k in ga)
    out["b_vs_a"] = {"dloss": abs(la - lb), "min_cosine": min(cos.values()),
                     "max_rel_err": worst}
    say(f"  (b) against (a), first step: |dloss| {abs(la - lb):.2e}, "
        f"gradient cosines >= {min(cos.values()):.6f}, max |dg| / max |g| "
        f"a leaf {worst:.2e}")
    say("  " + json.dumps(out))
    return out


# -- phase 24: the mesh (dp/fsdp x tp over ranks sharing the card) -----------

# Serving (b, c): phase 5's traffic through ``serve --mesh`` under tfrun.
MESH_SERVE_ARGV = ["--continuous", "--batch", "8", "--n-prompts", "16",
                   "--prompt-len", "8,700", "--new-tokens", "32",
                   "--max-len", "1024", "--stats"]
# Training (d): phase 8's shape, 4 steps; phase 9's gates.
MESH_TRAIN_ARGV = ["--batch_size", "8", "--seq_len", "2048"]
MESH_TRAIN_STEPS = 4
MESH_DLOSS = 2e-2
MESH_MIN_COS = 0.99
# fsdp=2: a rank's params and AdamW state against one process's, by
# torch.cuda.memory_allocated after the first step less what stays
# allocated once the run is freed (cuBLAS workspaces and the kernels'
# scratch, which the process keeps): half, plus the whole norms and the
# step's small buffers.
MESH_FSDP_MEM = (0.4, 0.6)


def mesh_train_rank(ctx, mesh_spec: str, steps: int, ckpt_dir: str,
                    ref_path: str):
    """Dispatched to every rank of a Mode-A gang (phase 24 (d), (e)):
    ``transformer_train``'s run over the mesh ``mesh_spec`` (its
    params and AdamW state cut per ``partition_specs``), at phase 8's
    shape.  The first step's gradients are taken once more by hand,
    averaged as the step averages them and gathered whole; then
    ``steps`` steps train (the first alone, to read
    ``torch.cuda.memory_allocated``), their launches counted and the
    gloo collectives timed; the state is saved to ``ckpt_dir`` (rank 0
    writes) and each whole leaf's digest returned.  Rank 0 then returns
    each gradient leaf's cosine with one process's over the global
    batch (``ref_path``: :func:`train_references`' npz, computed in the
    driving process), and its losses and memory."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from tfmesos_tpu_torch import graphs
    from tfmesos_tpu_torch import transformer_train as tr
    from tfmesos_tpu_torch.cli import parse_mesh
    from tfmesos_tpu_torch.convert import flatten, unflatten
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.parallel import sharding
    from tfmesos_tpu_torch.train.checkpoint import CheckpointManager
    from tfmesos_tpu_torch.train.trainer import (_flat_specs,
                                                 sharded_grad_mean)

    dev = ctx.device
    args = tr.parse_args([*MESH_TRAIN_ARGV, "--steps", str(steps),
                          "--mesh", mesh_spec])
    mesh = ctx.mesh(parse_mesh(mesh_spec))
    run = tr.setup(args, dev, start_step=None, rank=ctx.rank,
                   world_size=ctx.world_size, mesh=mesh)
    index, shards = tr.data_shard(mesh, ctx.rank, ctx.world_size)
    first = next(tr.data_stream(args, run.cfg, run.seq_len, 0, index,
                                shards))
    batch = {"tokens": torch.from_numpy(first["tokens"]).to(dev)}
    flat = flatten(run.params)
    loss, _ = tt.loss_fn(run.cfg, run.params, batch, mesh=mesh)
    grads = sharded_grad_mean(
        list(torch.autograd.grad(loss, list(flat.values()))),
        _flat_specs(run.specs, list(flat)), mesh)
    whole = flatten(sharding.gather_tree(
        mesh, unflatten(dict(zip(flat, grads))), run.specs))
    whole = None if ctx.rank else {k: v.cpu() for k, v in whole.items()}
    del grads, loss
    graphs.zero_launches()
    run.params, run.opt_state, m = run.step(run.params, run.opt_state,
                                            batch)
    first_loss = float(m["loss"])
    del m
    gc.collect()
    mem = torch.cuda.memory_allocated(dev)
    run.batches = tr.data_stream(args, run.cfg, run.seq_len, 1, index,
                                 shards)
    # The gloo collectives of the later steps, timed on the host (gloo
    # stages a CUDA tensor through host memory, so the call blocks).
    spent = [0.0]
    orig = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def timed(fn):
        def call(*a, **k):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spent[0] += time.perf_counter() - t0
            return out
        return call

    for n, fn in orig.items():
        setattr(dist, n, timed(fn))
    try:
        rest = tr.train(run, steps, log=None, start_step=1)
    finally:
        for n, fn in orig.items():
            setattr(dist, n, fn)
    launches = graphs.launch_counts()
    out = {"rank": ctx.rank, "losses": [first_loss] + rest["losses"],
           "launches": launches,
           "ms_per_step": rest["elapsed_s"] / (steps - 1) * 1e3,
           "collective_ms_per_step": spent[0] / (steps - 1) * 1e3}
    ckpt = CheckpointManager(ckpt_dir, mesh=mesh, param_specs=run.specs)
    ckpt.save(steps, (run.params, run.opt_state))
    ckpt.close()
    out["digests"] = {k: hashlib.sha256(
        v.float().cpu().numpy().tobytes()).hexdigest()
        for k, v in flatten(sharding.gather_tree(
            mesh, run.params, run.specs)).items()}
    del run, flat, first, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["mem_bytes"] = mem - torch.cuda.memory_allocated(dev)
    if ctx.rank:
        return out
    ref = np.load(ref_path)
    out.update(cosines=grad_cosines(whole, {
                   k: ref[f"grad/{k}"] for k in whole}),
               ref_losses=[float(v) for v in ref["losses"]],
               ref_mem_bytes=int(ref["mem_bytes"]),
               ref_ms_per_step=float(ref["ms_per_step"]))
    return out


def mesh_serve_argv(axes: str, n: int, extra):
    """``serve --continuous --mesh axes`` on phase 5's traffic under
    ``tfrun -w n``."""
    return ["tfmesos_tpu_torch.cli", "run", "-w", str(n), "-s", "0",
            "--mesh", axes, "--worker-logs", "*", "--", sys.executable,
            "-m", "tfmesos_tpu_torch.serve", "--mesh", axes,
            *MESH_SERVE_ARGV, *extra]


def mesh_serve(result, axes: str, n: int, reqs, refs, next_logits, int8,
               label):
    """The check of a :func:`mesh_serve_argv` launch from its child
    ``result``: rank 0's streams against ``refs`` by the margin rule
    (every rank checked its digest against rank 0's), each rank's
    launches exact (rows 1 and 5 at 8 a prefill it ran and a tick, row
    6 at one commit each over an int8 pool, the merges at 8 a split
    tick), the graphs bypass named, and every data shard's sub-pool
    recycled to its sink."""
    stdout, _, secs = result
    comps = [json.loads(j) for j in re.findall(
        r"^\[worker:0\] (\{\"rid\".*\})$", stdout, re.M)]
    stats = {int(r): json.loads(j) for r, j in re.findall(
        r"^\[worker:(\d+)\] stats (\{.*\})$", stdout, re.M)}
    need(len(comps) == len(refs) and sorted(stats) == list(range(n)),
         f"(serve {label}) {len(comps)} completions, stats of ranks "
         f"{sorted(stats)}: {stdout[-3000:]}")
    need([c["prompt_len"] for c in sorted(comps, key=lambda c: c["rid"])]
         == [int(r.prompt.size) for r in reqs],
         f"(serve {label}) not phase 5's traffic")
    got = {c["rid"]: [c["tokens"]] for c in comps}
    identical, near, total = margin_all(dict(enumerate(refs)), got,
                                        next_logits, f"serve {label}")
    tp = 2 if "tp=2" in axes else 1
    launches = collections.Counter()
    for r, st in sorted(stats.items()):
        got_l, ph, tk = st["launches"], st["prefills_here"], \
            st["decode_ticks"]
        what = f"serve {label} rank {r}"
        need(got_l["flash_fwd"] == 8 * ph
             and got_l["flash_decode_paged"] == 8 * tk,
             f"{what}: {got_l} for {ph} prefills and {tk} ticks")
        merges = got_l["flash_decode_paged_merge"]
        need(merges % 8 == 0 and merges <= 8 * tk,
             f"{what}: {merges} merges for {tk} ticks")
        need(got_l["quant_int8_commit"] == ((ph + tk) if int8 else 0),
             f"{what}: {got_l['quant_int8_commit']} commits")
        for key in ("flash_decode", "flash_decode_merge", "flash_bwd_dq",
                    "flash_bwd_dkv", "quant_int8"):
            need(got_l[key] == 0, f"{what}: {key} launched {got_l[key]}")
        need(st["graphs_bypass_reason"] == "gloo collectives",
             f"{what}: graphs bypass {st['graphs_bypass_reason']!r}")
        need(all(f == st["n_pages_per_shard"] - 1
                 for f in st["free_by_shard"]),
             f"{what}: sub-pools not recycled: {st['free_by_shard']} of "
             f"{st['n_pages_per_shard']}")
        need(stats[r - r % tp]["prefills_here"] == ph,
             f"{what}: its tp peers ran other prefills")
        launches.update(got_l)
    shards_pre = sum(st["prefills_here"] for st in stats.values()) // tp
    need(shards_pre == len(refs), f"serve {label}: the data shards ran "
         f"{shards_pre} prefills for {len(refs)} requests")
    ms_tick = statistics.median(st["ms_per_tick"] for st in stats.values())
    out = {"s": secs, "identical": identical, "near_ties": near,
           "streams": total, "ms_per_tick": ms_tick,
           "graphs_bypass_reason": stats[0]["graphs_bypass_reason"],
           "per_rank": {r: {k: st[k] for k in ("prefills_here",
                                                "decode_ticks",
                                                "ms_per_tick",
                                                "free_by_shard")}
                        for r, st in stats.items()},
           "launches": {k: launches[k] for k in read_launches()}}
    say(f"  (serve {label}) {n} ranks in {secs:.1f} s: {identical}/{total} "
        f"streams identical to one process, {near} near-ties (margin "
        f"{MARGIN}), equal on every rank; {ms_tick:.2f} ms a tick eager "
        f"(graphs bypassed: {out['graphs_bypass_reason']}); every rank's "
        f"launches exact, every data shard's sub-pool recycled")
    return out


#: the batcher counters a KV-surface rank reports (deltas).
MESH_KV_COUNTERS = ("prefills_here", "tail_prefills", "decode_ticks",
                    "weight_swaps")


def mesh_kv_rank(ctx, prompts, new_tokens: int):
    """Dispatched to both ranks of a Mode-A gang (phase 24 (b)): the
    flagship's batcher over tp=2 as ``serve --continuous --mesh tp=2``
    builds it (seed 0, 8 rows, pages of 64), given a KV tier, on phase
    5's first 8 prompts.  ``preempt_all`` once request 0 (at 4 tokens)
    is back, every suspended request re-imported (its artifact gathered
    over tp, each rank's kv heads cut back on import); a session parked
    (request 1) and its next turn resumed beside a cold prefill of the
    same history; a seeded 0.5-sigma delta folded into the embedding
    (request 0 again), then the original weights set back (requests 0
    and 1).  Returns the streams, the counts and this part's launches
    with the batcher's counters."""
    import numpy as np
    import torch

    from tfmesos_tpu_torch import graphs
    from tfmesos_tpu_torch.cli import parse_mesh
    from tfmesos_tpu_torch.fleet.kvtier import KVTierStore
    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.serving import (ContinuousBatcher, Prefilled,
                                           Request, Suspended)

    dev = ctx.device
    mesh = ctx.mesh(parse_mesh("tp=2"))
    cfg, params = flagship_model(0, device=dev, max_len=1024)
    b = ContinuousBatcher(cfg, params, rows=8, page_size=64,
                          prefill_bucket=64,
                          kv_tier=KVTierStore(ram_bytes=256 << 20),
                          mesh=mesh, device=dev)
    prompts = [np.asarray(p, np.int32) for p in prompts]

    def req(i, n=new_tokens, session=None):
        return Request(prompt=prompts[i], max_new_tokens=n,
                       session_id=session)

    graphs.zero_launches()
    before = {k: getattr(b, k) for k in MESH_KV_COUNTERS}
    sub = [req(0, 4)] + [req(i) for i in range(1, len(prompts))]
    index = {id(r): i for i, r in enumerate(sub)}
    final, back = {}, []
    for item in b.run(sub):
        if isinstance(item, Suspended):
            back.append(item)
            continue
        final[index[id(item.request)]] = item.tokens
        if len(final) == 1:
            b.preempt_all()
    for c in b.run([Prefilled(s.request, s.artifact)
                    if s.artifact is not None else s.request
                    for s in back]):
        final[index[id(c.request)]] = c.tokens
    out = {"rank": ctx.rank, "preempt": {
        "suspended": len(back),
        "carried": sum(s.artifact is not None for s in back),
        "streams": {str(i): final[i] for i in sorted(final)}}}
    (turn1,) = b.run([req(1, session="kv")])
    hist = [int(t) for t in prompts[1]] + list(turn1.tokens) + [7, 2]
    (warm,) = b.run([Request(np.asarray(hist, np.int32), new_tokens,
                             session_id="kv")])
    (cold,) = b.run([Request(np.asarray(hist, np.int32), new_tokens)])
    out["session"] = {"history": hist, "resumed": warm.tokens,
                      "cold": cold.tokens,
                      "resume": b.kv_tier.stats().get("resume", 0)}
    embed = params["embed"].float()
    delta = (np.random.default_rng(19).standard_normal(
        tuple(embed.shape)).astype(np.float32) * 0.5 * float(embed.std()))
    b.swap_adapter({"embed": delta}, "kv")
    (folded,) = b.run([req(0)])
    b.set_weights(params, "v0")
    pair = [req(0), req(1)]
    index = {id(r): i for i, r in enumerate(pair)}
    out["swaps"] = {"folded": folded.tokens,
                    "restored": {str(index[id(c.request)]): c.tokens
                                 for c in b.run(pair)}}
    torch.cuda.synchronize(dev)
    out["launches"] = graphs.launch_counts()
    out["counters"] = {k: getattr(b, k) - before[k]
                       for k in MESH_KV_COUNTERS}
    del b, params, embed
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_kv_checks(rs, refs, next_logits, kv_logits):
    """Phase 24 (b)'s KV surface over tp=2 (:func:`mesh_kv_rank`'s
    replies ``rs``): both ranks' results equal; the preempted and
    re-imported streams held to phase 5's by the margin rule (request 0
    at its 4 tokens), the resumed turn to the cold one (``kv_logits(
    history, cold)``: their logits), the fold changing request 0's
    stream and the weights set back giving phase 5's again; each rank's
    launches exact: 8 flash_fwd a prefill, 8 paged a tick and a tail."""
    what = "(b) tp=2 KV surface"
    head = rs[0]
    need(all({k: r[k] for k in ("preempt", "session", "swaps")}
             == {k: head[k] for k in ("preempt", "session", "swaps")}
             for r in rs), f"{what}: the ranks' results differ")
    pre = head["preempt"]
    need(pre["carried"] >= 1 and pre["carried"] == pre["suspended"],
         f"{what}: {pre['carried']} of {pre['suspended']} suspended "
         f"requests carried an artifact")
    got = {int(i): [t] for i, t in pre["streams"].items()}
    need(sorted(got) == list(range(8)) and len(got[0][0]) == 4,
         f"{what}: preempted streams {sorted(got)}")
    want = {i: refs[i][:len(got[i][0])] for i in got}
    p_ident, p_near, _ = margin_all(want, got, next_logits,
                                    f"{what} preempt")
    sess = head["session"]
    need(sess["resume"] == 1, f"{what}: {sess['resume']} tier resumes")
    logits = kv_logits(sess["history"], sess["cold"])
    s_ident, s_near, _ = margin_all({0: sess["cold"]},
                                    {0: [sess["resumed"]]}, logits,
                                    f"{what} session")
    sw = head["swaps"]
    need(sw["folded"] != refs[0] and all(
        r["counters"]["weight_swaps"] == 2 for r in rs),
         f"{what}: the fold left request 0's stream as it was "
         f"({[r['counters']['weight_swaps'] for r in rs]} swaps)")
    r_ident, r_near, _ = margin_all(
        {0: refs[0], 1: refs[1]},
        {int(i): [t] for i, t in sw["restored"].items()}, next_logits,
        f"{what} restored")
    launches = collections.Counter()
    for r in rs:
        got_l, d = r["launches"], r["counters"]
        calls = d["decode_ticks"] + d["tail_prefills"]
        need(got_l["flash_fwd"] == 8 * d["prefills_here"]
             and got_l["flash_decode_paged"] == 8 * calls
             and got_l["quant_int8_commit"] == 0 and got_l["quant_int8"] == 0,
             f"{what} rank {r['rank']}: {got_l} for {d}")
        launches.update(got_l)
    out = {"carried": pre["carried"], "preempt_identical": p_ident,
           "preempt_near_ties": p_near, "session_identical": s_ident,
           "session_near_ties": s_near, "tier_resumes": sess["resume"],
           "fold_changed_stream": True, "restored_identical": r_ident,
           "restored_near_ties": r_near,
           "per_rank": {r["rank"]: r["counters"] for r in rs},
           "launches": {k: launches[k] for k in read_launches()}}
    say(f"  {what}: {pre['carried']} of 8 requests suspended by "
        f"preempt_all with artifacts (gathered over tp) and re-imported, "
        f"{p_ident}/8 streams identical to phase 5's, {p_near} near-ties; "
        f"a session resumed from the tier, "
        f"{'identical to' if s_ident else 'a near-tie from'} the cold "
        f"prefill; the fold changed request 0's stream, set_weights gave "
        f"back {r_ident}/2 identical ({r_near} near-ties); both ranks "
        f"equal, their launches exact")
    return out


def phase_mesh(torch, np, cfg, params, reqs, comps, comps8, rows,
               train_dir, beside=(), smi=None):
    """Phase 24: the kernels at the per-rank shapes (a), ``serve --mesh``
    over tp=2 (b) and dp2 x tp2 (c), training over tp=2 and fsdp=2 (d)
    and the checkpoint round trip (e).  ``beside``: another phase's
    launches (phase 28's), started with (b)-(d)'s, their futures in
    ``out["beside"]``, and ``smi`` its memory sampler, started with
    them; the one-process references of both phases
    (:func:`train_references`, written under ``train_dir``) are made here
    while the launches run, in ``out["refs"]``."""
    import hashlib
    import shutil
    import tempfile

    from tfmesos_tpu_torch import Job, cluster
    from tfmesos_tpu_torch import transformer_train as tr
    from tfmesos_tpu_torch.convert import flatten
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.ops import quant as tq
    from tfmesos_tpu_torch.train.checkpoint import CheckpointManager

    say("[24/28] the mesh: per-rank kernel shapes, serve --mesh tp=2 and "
        "dp=2,tp=2, training over tp=2 and fsdp=2, a checkpoint across "
        "meshes (ranks share the card over gloo)")
    dev = torch.device("cuda")
    out = {}

    # (a) Every kernel at the shapes a rank gives it: heads and kv heads
    # halved by tp=2, a data shard's 4 rows over its half pool.
    gen = torch.Generator().manual_seed(24)

    def draw(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    for b, t in ((1, 512), (8, 2048)):
        _flash_case(torch, rows["flash"], b, t, None, draw, h=4)
    rows["bwd"].append(_bwd_case(torch, gen, 8, 2048, 4, 4, 64,
                                 time_it=True))
    for int8 in (False, True):
        for t in (1, 4):
            pos = torch.randint(1, 1001, (4,), generator=gen).clamp(
                max=16 * 64 - t).tolist()
            rows["paged"].append(paged_case(
                torch, gen, f"tp rank {'int8' if int8 else 'bf16'} t={t}",
                4, t, 4, 4, 64, 16, 64, pos, torch.bfloat16, int8=int8,
                time_it=True))
    _decode_case(torch, randn, rows["decode"], 4, 1, 4, 4, 16384, 64,
                 [1024] * 4, torch.bfloat16, False, True)
    L, KV, D = 8, 4, 64
    kp = _lane_int8(tq, randn((L, 65, KV, 64, D)))
    vp = _lane_int8(tq, randn((L, 65, KV, 64, D)))
    table = (torch.randperm(64, generator=gen) + 1).reshape(4, 16).to(
        dev, torch.int32)
    for t in (1, 4):
        pos = torch.randint(0, 1024 - t + 1, (4,), generator=gen).to(dev)
        ks = [randn((4, t, KV, D)) for _ in range(L)]
        vs = [randn((4, t, KV, D)) for _ in range(L)]
        _commit_case(torch, rows["commit"], f"tp rank pool KV 4 t={t}", kp,
                     vp, ks, vs, pos,
                     lambda rk, rv, ks=ks, vs=vs, pos=pos: _today_paged(
                         torch, tq, rk, rv, ks, vs, table, pos),
                     table=table)
    del kp, vp

    # (b) and (c): serving over ranks, against phase 5's and 12's runs,
    # and (d)'s two tfrun training launches: all five start together
    # (twelve ranks on the card, with ``beside``) while this process
    # computes the references and runs (d)'s Mode-A gang, each checked as
    # if alone (their ms a tick and a step are taken under each other's
    # load).  tfrun's fsdp=2 run writes its first step's gradients and
    # times its collectives (``--grads-out``, ``--time-collectives``):
    # the gang trains tp=2 only.
    serves = [("tp=2", 2, [], False, "tp=2 bf16"),
              ("tp=2", 2, ["--int8", "--int8-kv"], True, "tp=2 int8"),
              ("dp=2,tp=2", 4, [], False, "dp=2,tp=2 bf16")]
    trains = {"tp=2": [],
              "fsdp=2": ["--grads-out", f"{train_dir}/fsdp.npz",
                         "--time-collectives"]}
    t_launch = time.perf_counter()
    launched = start_children(
        [mesh_serve_argv(axes, n, extra) for axes, n, extra, _, _ in serves]
        + [["tfmesos_tpu_torch.cli", "run", "-w", "2", "-s", "0",
            "--mesh", label, "--worker-logs", "*", "--",
            sys.executable, "-m", "tfmesos_tpu_torch.transformer_train",
            "--steps", str(MESH_TRAIN_STEPS), *MESH_TRAIN_ARGV,
            "--mesh", label, *extra] for label, extra in trains.items()]
        + list(beside), 900)
    out["beside"] = launched[len(serves) + len(trains):]
    prompts = [r.prompt for r in reqs]
    ref, ref8 = streams(comps), streams(comps8)
    logits = full_logits(torch, cfg, params, prompts, ref)
    logits8 = full_logits(torch, cfg, tt.quantize_params(cfg, params),
                          prompts, ref8)
    if smi is not None:
        smi.start()
    out["refs"] = refs = train_references(torch, train_dir)

    # (d) training over tp=2 in a gang, (e) the checkpoint round trip.
    root = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    try:
        t1 = time.perf_counter()
        with cluster(Job(name="worker", num=2, cpus=1.0, mem=1024.0),
                     quiet=True, start_timeout=300.0) as c:
            up_s = time.perf_counter() - t1
            rs = c.run_all(mesh_train_rank, "tp=2", MESH_TRAIN_STEPS,
                           f"{root}/ck", f"{train_dir}/dense.npz")
            # (b)'s KV surface over tp=2, after the training run so that
            # it leaves nothing in its memory readings.
            t0 = time.perf_counter()
            kv = c.run_all(mesh_kv_rank,
                           [[int(t) for t in r.prompt] for r in reqs[:8]],
                           reqs[0].max_new_tokens)
            kv_s = time.perf_counter() - t0
        served = [mesh_serve(f.result(), axes, n, reqs,
                             ref8 if int8 else ref,
                             logits8 if int8 else logits, int8, label)
                  for f, (axes, n, _, int8, label) in zip(launched, serves)]
        out["b"] = {"bf16": served[0], "int8": served[1]}
        out["c"] = served[2]
        out["serve_s"] = time.perf_counter() - t_launch
        say(f"  (b), (c) the three serve launches done "
            f"{out['serve_s']:.1f} s after they started (with (d)'s "
            f"tfrun pair, beside (d)'s gang)")
        out["b"]["kv"] = mesh_kv_checks(
            kv, ref, logits, lambda hist, cold: full_logits(
                torch, cfg, params, [hist], [cold]))
        out["b"]["kv"]["s"] = kv_s
        out["d"] = {"bring_up_s": up_s}
        head = rs[0]
        need(all(r["losses"] == head["losses"] for r in rs),
             "(d) tp=2: the ranks' losses differ")
        dl = max(abs(a - b) for a, b in zip(head["losses"],
                                            head["ref_losses"]))
        need(dl <= MESH_DLOSS, f"(d) tp=2: losses {head['losses']} vs one "
             f"process {head['ref_losses']}")
        low = min(head["cosines"].values())
        need(low >= MESH_MIN_COS, f"(d) tp=2: gradient cosines "
             f"{head['cosines']}")
        for r in rs:
            train_launches_exact(r["launches"], 8, MESH_TRAIN_STEPS,
                                 f"(d) tp=2 rank {r['rank']}")
        share = [r["mem_bytes"] / head["ref_mem_bytes"] for r in rs]
        ms = statistics.median(r["ms_per_step"] for r in rs)
        coll = statistics.median(r["collective_ms_per_step"] for r in rs)
        out["d"]["tp=2"] = {
            "losses": head["losses"], "ref_losses": head["ref_losses"],
            "max_dloss": dl, "min_cosine": low,
            "mem_share_of_one_process": share,
            "mem_bytes": [r["mem_bytes"] for r in rs],
            "ref_mem_bytes": head["ref_mem_bytes"], "ms_per_step": ms,
            "ref_ms_per_step": head["ref_ms_per_step"],
            "collective_ms_per_step": coll, "collective_share": coll / ms,
            "launches": {k: sum(r["launches"][k] for r in rs)
                         for k in read_launches()}}
        say(f"  (d) tp=2: losses {head['losses']} vs one process "
            f"{head['ref_losses']} (max |dloss| {dl:.2e}); gradient "
            f"cosines >= {low:.5f}; memory a rank "
            f"{[round(s, 3) for s in share]} of one process's; "
            f"{ms:.1f} ms a step ({coll:.1f} of it in gloo collectives, "
            f"{coll / ms:.0%}) against one process's "
            f"{head['ref_ms_per_step']:.1f}; rows 1-3 at 8 a step a rank")
        # The two runs through tfrun, as users start them, launched with
        # (b) and (c): tp=2's losses against one process (the gang held
        # its gradients and memory); fsdp=2's held whole
        # (:func:`tfrun_train_check`: under fsdp a rank's memory after
        # the first step 0.4-0.6 of one process's).
        tfrun = [f.result() for f in launched[len(serves):][:len(trains)]]
        out["d"]["tfrun_s"] = time.perf_counter() - t_launch
        stdout, _, secs = tfrun[0]
        got = dict(re.findall(r"^\[worker:(\d)\] rank \d/2 step losses: "
                              r"(\[.*\])$", stdout, re.M))
        need(sorted(got) == ["0", "1"] and got["0"] == got["1"],
             f"(d) tfrun tp=2: rank losses {got}: {stdout[-2000:]}")
        losses = json.loads(got["0"])
        dl = max(abs(a - b) for a, b in zip(losses, head["ref_losses"]))
        need(len(losses) == MESH_TRAIN_STEPS and dl <= MESH_DLOSS,
             f"(d) tfrun tp=2: losses {losses} vs one process "
             f"{head['ref_losses']}")
        out["d"]["tp=2"]["tfrun"] = {"s": secs, "losses": losses,
                                     "max_dloss": dl}
        say(f"  (d) tfrun -w 2 --mesh tp=2 transformer_train in {secs:.1f} "
            f"s (beside the other launches): both ranks' losses {losses} "
            f"(max |dloss| {dl:.2e} against one process)")
        out["d"]["fsdp=2"], _ = tfrun_train_check(
            "(d) tfrun -w 2 --mesh fsdp=2 transformer_train", 2, tfrun[1],
            refs["fsdp"], f"{train_dir}/fsdp.npz",
            lambda counts, r: train_launches_exact(
                counts, 8, MESH_TRAIN_STEPS, f"(d) fsdp=2 rank {r}"),
            lambda share, held: MESH_FSDP_MEM[0] <= share
            <= MESH_FSDP_MEM[1])
        say(f"  (d) both tfrun launches done {out['d']['tfrun_s']:.1f} s "
            f"after the five launches started")
        # (e) Saved under dp1 x tp2, restored on one process.
        one = tr.setup(tr.parse_args([*MESH_TRAIN_ARGV, "--steps",
                                      str(MESH_TRAIN_STEPS)]), dev,
                       start_step=None)
        restored = CheckpointManager(f"{root}/ck").restore(
            (one.params, one.opt_state), step=MESH_TRAIN_STEPS)
        need(restored is not None, "(e) no checkpoint")
        mine = {k: hashlib.sha256(v.detach().float().cpu().numpy()
                                  .tobytes()).hexdigest()
                for k, v in flatten(one.params).items()}
        need(mine == rs[0]["digests"],
             "(e) the restored params differ from the tp=2 ranks' state")
        out["e"] = {"leaves": len(mine), "equal": True,
                    "count": one.opt_state.count}
        need(one.opt_state.count == MESH_TRAIN_STEPS,
             f"(e) optimizer count {one.opt_state.count}")
        say(f"  (e) saved under dp=1,tp=2, restored on one process: all "
            f"{len(mine)} param leaves equal the ranks' gathered state bit "
            f"for bit, optimizer count {one.opt_state.count}")
        del one
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("  Two ranks on one card measure no scaling, and gloo staging "
        "through host memory is not NCCL.")
    say("  " + json.dumps({k: v for k, v in out.items()
                           if k not in ("beside", "refs")}))
    return out


# -- phase 25: gang replicas (leader and member sharing the card) -----------

#: Phase 25's gang fleets: phase 18's shape, one gang of two; (c)'s
#: batchers run on GANG_DEVICE.
GANG = dict(FRONT_DOOR, replicas=1, gang_size=2)
GANG_DEVICE = "cuda"
#: The kernels no gang process may launch (``int8`` adds the commits).
IDLE_IN_A_GANG = ("quant_int8", "flash_decode", "flash_decode_merge",
                  "flash_bwd_dq", "flash_bwd_dkv")


class StdoutTo:
    """fd 1 of this process, and of every process started meanwhile,
    into ``path`` (a gang member has no socket: it reports on stdout);
    on exit the file is echoed to this process's stdout."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        import os

        sys.stdout.flush()
        self.saved = os.dup(1)
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.dup2(fd, 1)
        os.close(fd)
        return self

    def read(self):
        sys.stdout.flush()
        with open(self.path, errors="replace") as f:
            return f.read()

    def __exit__(self, *exc):
        import os

        sys.stdout.flush()
        os.dup2(self.saved, 1)
        os.close(self.saved)
        sys.stdout.write(self.read())
        sys.stdout.flush()


def member_reports(log, gang_id):
    """The ``gang member stats`` lines of ``gang_id``'s member so far."""
    return [r for r in (json.loads(j) for j in re.findall(
        r"gang member stats (\{.*\})$", log.read(), re.M))
        if r["gang"] == gang_id]


def member_report(log, gang_id, served, what):
    """The member's report once it has served ``served`` requests."""
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        got = [r for r in member_reports(log, gang_id)
               if r["served"] == served]
        if got:
            return got[-1]
        time.sleep(0.1)
    need(False, f"{what}: no member report at {served} served: "
         f"{member_reports(log, gang_id)[-1:]}")


def gang_launches_exact(cfg, got, d, int8, what):
    """A gang process's launches against its batcher's counters ``d``: 8
    flash_fwd a prefill, 8 paged a tick, a tail and a chunk (blocks of
    one), one commit a prefill and a call over an int8 pool, nothing of
    :data:`IDLE_IN_A_GANG`."""
    calls = d["decode_ticks"] + d["tail_prefills"] + d["prefill_chunks"]
    need(d["fused_ticks"] == 0
         and got["flash_fwd"] == cfg.n_layers * d["prefills"]
         and got["flash_decode_paged"] == cfg.n_layers * calls
         and got["quant_int8_commit"] == ((d["prefills"] + calls)
                                          if int8 else 0)
         and not any(got[k] for k in IDLE_IN_A_GANG),
         f"{what}: launched {got} for its counters {d}")


def gang_leader(fleet, what):
    reps = [r for r in fleet.registry.alive()
            if (r.role or "unified") == "unified"]
    need(len(reps) == 1 and reps[0].gang_size == 2,
         f"{what}: routable replicas {[(r.addr, r.gang_id) for r in reps]}")
    return reps[0]


def gang_settled(addr, token, acks, what):
    """The leader's ``stats`` once the member's acks reached ``acks`` and
    its counts settled."""
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        st = replica_stats([addr], token)[addr]
        if st["gang"]["acks"] >= acks:
            return settled_stats([addr], token)[addr]
        time.sleep(0.1)
    need(False, f"{what}: the member acked {st['gang']['acks']} of {acks}")


def gang_pass(cfg, fleet, log, reqs, ref, next_logits, int8, what):
    """Phase 5's requests through a formed gang: the streams by the
    margin rule, the leader's dispatches, acks and divergence, each
    process's launches exact.  Returns the stats."""
    rep = gang_leader(fleet, what)
    addr, gid = rep.addr, rep.gang_id
    # One request first (cuBLAS handles, allocator pools of both
    # processes), outside the measured run.
    fleet_requests(fleet, [FleetReq(list(range(1, 9)), 2)], streamed_every=2)
    st0 = gang_settled(addr, fleet.token, 1, what)
    g0 = st0["gang"]
    need(g0["acks"] == g0["dispatches"], f"{what}: {g0}")
    m0 = member_report(log, gid, g0["acks"], what)
    st0 = replica_stats([addr], fleet.token, reset=True)[addr]
    replies, streamed, first, wall = fleet_requests(fleet, reqs)
    got = [r["tokens"] for r in replies]
    need(all(len(t) == r.max_new_tokens for t, r in zip(got, reqs)),
         f"{what}: a request did not complete its tokens")
    identical, gaps = divergence_gaps(ref, dict(enumerate(got)),
                                      next_logits, what)
    st1 = gang_settled(addr, fleet.token, g0["acks"] + len(reqs), what)
    g1 = st1["gang"]
    dispatched, acked = (g1["dispatches"] - g0["dispatches"],
                         g1["acks"] - g0["acks"])
    need(dispatched == acked == len(reqs) and g1["divergence"] == 0
         and not g1["broken"],
         f"{what}: {dispatched} dispatches, {acked} acks, divergence "
         f"{g1['divergence']}")
    d = {k: st1["counters"][k] - st0["counters"][k]
         for k in st1["counters"]}
    gang_launches_exact(cfg, st1["launches"], d, int8, f"{what} leader")
    m1 = member_report(log, gid, m0["served"] + len(reqs), what)
    md = {k: m1["counters"][k] - m0["counters"][k] for k in m1["counters"]}
    ml = {k: m1["launches"][k] - m0["launches"][k] for k in m1["launches"]}
    gang_launches_exact(cfg, ml, md, int8, f"{what} member")
    need(md["prefills"] == len(reqs) and m1["device"].startswith("cuda"),
         f"{what}: the member's {md} on {m1['device']}")
    client = [first[i] for i in sorted(first)]
    out = {"gang": gid, "generation": g1["generation"],
           "streams_identical": identical, "divergence_gaps": gaps,
           "dispatches": dispatched, "acks": acked,
           "divergence": g1["divergence"], "member_served": len(reqs),
           "member_pid": m1["pid"], "leader_pid": st1["pid"],
           "client_ttft_ms_mean_streamed": statistics.mean(client),
           "ttft_ms_mean": statistics.mean(r["ttft_ms"] for r in replies),
           "ms_per_tick": d["decode_seconds"] / d["decode_ticks"] * 1e3,
           "member_ms_per_tick": md["decode_seconds"]
           / md["decode_ticks"] * 1e3,
           "leader_ticks": d["decode_ticks"],
           "member_ticks": md["decode_ticks"], "wall_s": wall,
           "launches": {k: st1["launches"][k] + ml[k]
                        for k in read_launches()},
           "leader_launches": st1["launches"], "member_launches": ml}
    return out


def gang_kill(fleet, log, reqs, member_pid, leader_pid, what):
    """SIGKILL the member (its replica process, ``member_pid`` from its
    report) under traffic (one client sending phase 5's requests in
    turn): the leader logs its break exactly once and its process ends,
    the member is the only death the fleet counts, and the gang re-forms
    once under a fresh id; returns the seconds from the kill to the
    first reply the new gang served, the requests that failed
    meanwhile, and the old leader task's exit code.  (The re-form's
    teardown SIGTERMs the old leader's node runtime as the leader exits
    1 on its break, so the task's code is 1 or -15; the leader process's
    own exit 1 is held in ``tests/test_torch_gang.py``.)"""
    import os
    import signal
    import threading

    old = gang_leader(fleet, what)
    with fleet._gang_lock:
        ((gid, info),) = fleet._gangs.items()
    leader_task = fleet.scheduler.backend._procs[info["task_ids"][0]]
    deaths = fleet.metrics.get("replica_deaths") or 0
    broke = f"gang {gid} member rank 1 lost: gang broken"
    client = fleet.client(timeout=300.0)
    sent, stop, kill_at = [], threading.Event(), []

    def sender():
        i = 0
        while not stop.is_set():
            r = reqs[i % len(reqs)]
            t0 = time.perf_counter()
            try:
                reply = client.generate([int(x) for x in r.prompt],
                                        r.max_new_tokens, trace=True)
                sent.append((t0, time.perf_counter(), reply))
            except Exception as e:         # counted, not raised
                sent.append((t0, time.perf_counter(), e))
                time.sleep(0.05)
            i += 1

    t = threading.Thread(target=sender)
    t.start()
    try:
        deadline = time.monotonic() + 60.0
        while len(sent) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        kill_at.append(time.perf_counter())
        os.kill(member_pid, signal.SIGKILL)
        first_new = None
        deadline = time.monotonic() + 240.0
        while first_new is None and time.monotonic() < deadline:
            for t0, t1, r in list(sent):
                if t0 > kill_at[0] and isinstance(r, dict):
                    by = served_by(fleet, [r])
                    if old.addr not in by:
                        first_new = t1
                        break
            time.sleep(0.05)
    finally:
        stop.set()
        t.join()
        client.close()
    need(first_new is not None, f"{what}: no request served after the kill")
    failed = [r for t0, t1, r in sent if not isinstance(r, dict)]
    try:
        leader_rc = leader_task.wait(timeout=60.0)
    except subprocess.TimeoutExpired:
        leader_rc = None
    deadline = time.monotonic() + 60.0
    while pids_alive([leader_pid]) and time.monotonic() < deadline:
        time.sleep(0.1)
    breaks = log.read().count(broke)
    need(breaks == 1 and leader_rc in (1, -signal.SIGTERM)
         and not pids_alive([leader_pid]),
         f"{what}: the old leader logged {breaks} breaks, its task ended "
         f"with {leader_rc}, its process {pids_alive([leader_pid])} alive")
    need((fleet.metrics.get("replica_deaths") or 0) - deaths == 1,
         f"{what}: {(fleet.metrics.get('replica_deaths') or 0) - deaths} "
         f"deaths counted for one member kill")
    with fleet._gang_lock:
        ((new_gid, _),) = fleet._gangs.items()
    need(new_gid != gid and fleet.metrics.get("gang_reforms") == 1
         and fleet.scheduler.generation == 1,
         f"{what}: gang {gid} -> {new_gid}, reforms "
         f"{fleet.metrics.get('gang_reforms')}, generation "
         f"{fleet.scheduler.generation}")
    rep = gang_leader(fleet, what)
    need(rep.addr != old.addr and rep.gang_id == new_gid,
         f"{what}: the routable replica is {rep.addr} of {rep.gang_id}")
    return {"old_gang": gid, "new_gang": new_gid,
            "kill_to_first_routed_s": first_new - kill_at[0],
            "requests_sent": len(sent), "requests_failed": len(failed),
            "failures": sorted({type(e).__name__ for e in failed}),
            "gang_reforms": fleet.metrics.get("gang_reforms"),
            "leader_breaks": breaks, "old_leader_task_rc": leader_rc,
            "deaths_counted": 1}


def gang_artifacts(torch, np, cfg, params, reqs, next_turn_logits, what):
    """Phase 25 (c): two batchers on the card each park the same session;
    the shards fold into one gang artifact that a KV fabric replicates
    and fetches back from the peer after the parker lost its copy;
    unpacked, each rank's resumed turn against a cold full-history
    prefill by the margin rule."""
    from tfmesos_tpu_torch import wire
    from tfmesos_tpu_torch.fleet.kvtier import (KVFabric, KVTierStore,
                                                pack_gang_shards,
                                                unpack_gang_shards)
    from tfmesos_tpu_torch.fleet.registry import ReplicaRegistry
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    batchers = [ContinuousBatcher(cfg, params, rows=8, page_size=64,
                                  prefill_bucket=64, device=GANG_DEVICE,
                                  kv_tier=KVTierStore(ram_bytes=64 << 20))
                for _ in range(2)]
    for b in batchers:
        b.warmup()
    prompt = reqs[1].prompt
    zero_launches()
    shards, turn1 = [], []
    for r, b in enumerate(batchers):
        (c,) = b.run([Request(prompt, 32, session_id="gang")])
        turn1.append(c.tokens)
        meta, body = b.kv_tier.resume("gang")
        shards.append((dict(meta, rank=r), body))
    need(turn1[0] == turn1[1], f"{what}: the ranks' first turns differ")
    gmeta, gbody = pack_gang_shards(shards)
    reg = ReplicaRegistry()
    fabs = {}

    def rpc(addr, meta, body=None, timeout=10.0):
        if addr == "reg:0":
            return (reg.kv_peers() if meta["op"] == "kv_peers"
                    else reg.kv_locate(meta.get("kind"), meta.get("key")))
        if meta.get("op") == "kv_put":
            return fabs[addr].handle_put(wire.RawFrame(meta, body or b""))
        return fabs[addr].handle_fetch(meta)

    for addr in ("a:1", "b:1"):
        fabs[addr] = KVFabric(KVTierStore(ram_bytes=256 << 20), self_addr=addr,
                              registry_addr="reg:0", replication=2, rpc=rpc,
                              peer_ttl=0.0)

    def beat():
        for addr, fab in fabs.items():
            reg.observe({"op": "heartbeat", "addr": addr, "capacity": 4,
                         "outstanding": 0, "kv_tier": fab.summary()})

    beat()
    t0 = time.perf_counter()
    fabs["a:1"].park("gang", gmeta, gbody)
    need(fabs["a:1"].store.stats()["park_replicated"] == 1,
         f"{what}: {fabs['a:1'].store.stats()}")
    beat()
    fabs["a:1"].store.delete("session", "gang")
    got = fabs["a:1"].resume("gang")
    trip_ms = (time.perf_counter() - t0) * 1e3
    need(got is not None
         and fabs["a:1"].store.stats()["fabric_fetch_hit"] == 1,
         f"{what}: the gang artifact did not come back from the peer")
    back = unpack_gang_shards(dict(got[0]), got[1])
    need([m["rank"] for m, _ in back] == [0, 1], f"{what}: shards {back}")
    hist = [int(t) for t in prompt] + turn1[0] + [7, 2]
    p2 = np.asarray(hist, np.int32)
    (cold,) = batchers[0].run([Request(p2, 32)])
    logits = next_turn_logits(hist, cold.tokens)
    resumed = {}
    for r, ((smeta, sbody), b) in enumerate(zip(back, batchers)):
        b.kv_tier = KVTierStore(ram_bytes=64 << 20)
        b.kv_tier.park("gang", dict(smeta), sbody)
        (c,) = b.run([Request(p2, 32, session_id="gang")])
        need(b.kv_tier.stats()["resume"] == 1, f"{what}: rank {r} missed")
        resumed[r] = [c.tokens]
    torch.cuda.synchronize()
    launches = read_launches()
    d = {k: sum(getattr(b, k) for b in batchers)
         for k in ("prefills", "tail_prefills", "prefill_chunks",
                   "decode_ticks", "fused_ticks")}
    gang_launches_exact(cfg, launches, d, False, what)
    identical, near, _ = margin_all({r: cold.tokens for r in resumed},
                                    resumed, lambda key, prefix: logits(
                                        (0,) + key[1:], prefix), what)
    return {"gang_artifact_mb": len(gbody) / 1e6, "shards": len(back),
            "round_trip_ms": trip_ms, "resumed_identical": identical,
            "resumed_near_ties": near, "launches": launches}


def phase_gang(torch, np, cfg, params, reqs, comps, comps8, stats17):
    """Phase 25: gang replicas on the card."""
    import os
    import tempfile

    from tfmesos_tpu_torch.fleet.launcher import FleetServer
    from tfmesos_tpu_torch.models import transformer as tt

    say("[25/28] gang replicas: FleetServer(gang_size=2) at phase 18's "
        "shape, leader and member each on the graphed one-device "
        "batcher; a member SIGKILL; gang KV artifacts")
    prompts = [r.prompt for r in reqs]
    ref, ref8 = streams(comps), streams(comps8)
    logits = full_logits(torch, cfg, params, prompts, ref)
    logits8 = full_logits(torch, cfg, tt.quantize_params(cfg, params),
                          prompts, ref8)
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    with StdoutTo(os.path.join(tempfile.mkdtemp(prefix="chip-smoke-gang-"),
                               "stdout.log")) as log:
        t0 = time.perf_counter()
        fleet = FleetServer(**GANG).start()
        try:
            up_s = time.perf_counter() - t0
            pids = replica_pids([os.getpid()])
            need(len(pids) == 2, f"25 (a): gang processes {pids}")
            out["a"] = gang_pass(cfg, fleet, log, reqs, dict(enumerate(ref)),
                                 logits, False, "25 (a)")
            out["a"]["launch_to_formed_s"] = up_s
            out["b"] = gang_kill(fleet, log, reqs, out["a"]["member_pid"],
                                 out["a"]["leader_pid"], "25 (b)")
            out["b"].update(gang_pass(cfg, fleet, log, reqs,
                                      dict(enumerate(ref)), logits, False,
                                      "25 (b) re-formed"))
        finally:
            fleet.stop()
        t0 = time.perf_counter()
        fleet = FleetServer(**GANG, int8=True).start()
        try:
            up8 = time.perf_counter() - t0
            out["a"]["int8"] = gang_pass(cfg, fleet, log, reqs,
                                         dict(enumerate(ref8)), logits8,
                                         True, "25 (a) int8")
            out["a"]["int8"]["launch_to_formed_s"] = up8
        finally:
            fleet.stop()
    need(not pids_alive(pids), f"25: gang processes {pids_alive(pids)} "
         f"outlived FleetServer.stop()")
    out["c"] = gang_artifacts(
        torch, np, cfg, _to(params, GANG_DEVICE), reqs,
        lambda hist, cold: full_logits(torch, cfg, params, [hist], [cold]),
        "25 (c)")
    a, b, a8, c = out["a"], out["b"], out["a"]["int8"], out["c"]
    say("  (a) " + json.dumps({k: v for k, v in a.items() if k != "int8"}))
    say(f"  (a) bf16 gang formed {a['launch_to_formed_s']:.1f} s after "
        f"launch; {a['streams_identical']}/16 streams identical to phase "
        f"5's, {len(a['divergence_gaps'])} near-ties; leader dispatched "
        f"{a['dispatches']}, member acked {a['acks']}, divergence "
        f"{a['divergence']}; client TTFT {a['client_ttft_ms_mean_streamed']:.3f} "
        f"ms (phase 17's one replica {stats17['client_ttft_ms_mean_streamed']:.3f}), "
        f"ms a tick leader {a['ms_per_tick']:.4f}, member "
        f"{a['member_ms_per_tick']:.4f} (phase 17 "
        f"{stats17['ms_per_tick']:.4f}); both processes' launches exact")
    say("  (a) int8 " + json.dumps(a8))
    say(f"  (a) int8 gang formed in {a8['launch_to_formed_s']:.1f} s; "
        f"{a8['streams_identical']}/16 identical to phase 12's, "
        f"{len(a8['divergence_gaps'])} near-ties; divergence "
        f"{a8['divergence']}; ms a tick {a8['ms_per_tick']:.4f}; commits "
        f"leader {a8['leader_launches']['quant_int8_commit']}, member "
        f"{a8['member_launches']['quant_int8_commit']}")
    say("  (b) " + json.dumps(b))
    say(f"  (b) member SIGKILLed: gang {b['old_gang']} re-formed once as "
        f"{b['new_gang']} (generation {b['generation']}); "
        f"{b['kill_to_first_routed_s']:.1f} s from the kill to the new "
        f"gang's first routed request, {b['requests_failed']} of "
        f"{b['requests_sent']} requests failed in the gap; re-formed: "
        f"{b['streams_identical']}/16 identical, divergence "
        f"{b['divergence']}")
    say(f"  (c) gang artifact {c['gang_artifact_mb']:.2f} MB of "
        f"{c['shards']} shards through a fabric round trip in "
        f"{c['round_trip_ms']:.1f} ms; {c['resumed_identical']}/2 resumed "
        f"turns identical to the cold prefill, {c['resumed_near_ties']} "
        f"near-ties")
    return out


# -- phase 26: the fleet's edges over a fake Mesos master -------------------


#: phase 26 (b)'s ``tfserve`` flags beside ``--master`` and ``--http-port``:
#: two replicas of one card each (the ``gpus`` resource), two gateway
#: processes, the offline lane, phase 18's shape; 32 gateway workers a
#: process, so 16 batch requests can hold all 16 rows while interactive
#: ones still reach the replicas (a worker carries one request at a
#: time).
EDGE_SERVE = ["--replicas", "2", "-Gr", "1", "--gateway-processes", "2",
              "--batch-lane", "--rows", "8", "--workers", "32", "--warmup",
              "-p", "0", "--gateway-host", "127.0.0.1"]


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ProcLines:
    """A process's merged output, read on a thread: every line with the
    ``time.perf_counter()`` it arrived at."""

    def __init__(self, proc):
        import threading

        self.proc = proc
        self.lines = []
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter(), line.rstrip()))

    def wait_for(self, pred, timeout):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            for t, line in list(self.lines):
                if pred(line):
                    return t, line
            if self.proc.poll() is not None and not self._thread.is_alive():
                break
            time.sleep(0.02)
        return None, None

    def tail(self, n=40):
        return "\n".join(line for _, line in self.lines[-n:])


def proc_argv(pid):
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return [a.decode() for a in f.read().split(b"\0") if a]


def gateway_procs(root):
    """{pid: argv} of the gateway processes below ``root``."""
    out = {}
    for pid in descendants(root):
        try:
            argv = proc_argv(pid)
        except OSError:
            continue
        if "tfmesos_tpu_torch.fleet.gateway" in argv:
            out[pid] = argv
    return out


def socket_owner(sock, pids):
    """Which of ``pids`` holds the far end of the loopback TCP
    connection ``sock`` (by ``/proc/net/tcp`` and each process's fds)."""
    import os

    lport, rport = sock.getsockname()[1], sock.getpeername()[1]
    inodes = set()
    with open("/proc/net/tcp") as f:
        for line in f.readlines()[1:]:
            fields = line.split()
            loc, rem = fields[1], fields[2]
            if int(loc.split(":")[1], 16) == rport \
                    and int(rem.split(":")[1], 16) == lport:
                inodes.add(f"socket:[{fields[9]}]")
    for pid in pids:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        for fd in fds:
            try:
                if os.readlink(f"/proc/{pid}/fd/{fd}") in inodes:
                    return pid
            except OSError:
                continue
    return None


def registry_replicas(registry, token):
    """The central registry's alive replica addrs (``registry_view``)."""
    from tfmesos_tpu_torch import wire

    sock = wire.connect(registry, timeout=10.0)
    try:
        sock.settimeout(10.0)
        wire.send_msg(sock, {"op": "registry_view"}, token)
        view = wire.recv_msg(sock, token)
    finally:
        sock.close()
    return sorted(d["addr"] for d in view["replicas"]
                  if d.get("state") == "alive")


def http_completion(port, prompt, new, stream):
    """POST /v1/completions; (tokens, ms to the first SSE token event or
    None, total ms)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300.0)
    try:
        conn.request("POST", "/v1/completions",
                     body=json.dumps({"prompt": [int(x) for x in prompt],
                                      "max_tokens": int(new),
                                      "stream": stream}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            need(False, f"HTTP {resp.status}: {resp.read()[:300]!r}")
        if not stream:
            body = json.loads(resp.read())
            return body["tokens"], None, (time.perf_counter() - t0) * 1e3
        first, toks, done = None, [], None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().rstrip("\n")
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                break
            ev = json.loads(data)
            if "tokens" in ev:
                need(ev["off"] == len(toks), f"SSE offset {ev['off']} after "
                     f"{len(toks)} tokens")
                if first is None:
                    first = (time.perf_counter() - t0) * 1e3
                toks.extend(ev["tokens"])
            elif ev.get("done"):
                done = ev
            else:
                need(False, f"SSE error event {ev}")
        need(done is not None and done["n_tokens"] == len(toks),
             f"SSE stream ended without its done event: {done}")
        return toks, first, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def run_threads(fns):
    """Run each callable on its own thread; the first error is raised."""
    import threading

    errors = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:      # reported below
            errors.append(repr(e))

    pool = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=600.0)
    need(not errors, f"request threads failed: {errors[:3]}")


def wire_streams(addr, token, items, threads=4):
    """``items`` [(key, prompt, new, kw)] through ``FleetClient``s over
    ``addr`` from ``threads`` threads, each request streamed; returns
    ({key: reply}, {key: client ms to the first token})."""
    from tfmesos_tpu_torch.fleet.client import FleetClient

    replies, first = {}, {}

    def worker(k):
        client = FleetClient(addr, token, timeout=300.0)
        try:
            for key, prompt, new, kw in items[k::threads]:
                got, t0 = [], time.perf_counter()

                def on_tokens(toks, key=key, t0=t0, got=got):
                    if not got:
                        first[key] = (time.perf_counter() - t0) * 1e3
                    got.extend(toks)

                replies[key] = client.generate(
                    [int(x) for x in prompt], new, on_tokens=on_tokens,
                    **kw)
                need(got == replies[key]["tokens"], f"{key}: the streamed "
                     f"tokens differ from the reply's")
        finally:
            client.close()

    run_threads([functools.partial(worker, k) for k in range(threads)])
    return replies, first


def ms_stats(values):
    values = list(values)
    return {"mean": statistics.mean(values), "p50": statistics.median(values),
            "n": len(values)}


def phase_edge(torch, cfg, params, reqs, base, smi):
    """Phase 26: the fleet's edges over a fake Mesos master and agent."""
    from tfmesos_tpu_torch.models.transformer import forward

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_fake_mesos import FakeMesos, FakeZK

    say("[26/28] the fleet's edges over a fake Mesos master and agent: "
        "tfrun -m zk://, tfserve --master with gateway processes, the "
        "HTTP/SSE edge and the batch lane, a gateway SIGKILL")
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ref = dict(enumerate(base))

    def next_logits(key, prefix):
        prompt = [int(x) for x in reqs[key % 100].prompt]
        with torch.no_grad():
            return forward(cpu_cfg, params,
                           torch.tensor([prompt + prefix]))[0, -1]

    def check(got, what):
        """Streams {key: tokens} by the margin rule against phase 5's
        (key % 100 is the request's index in phase 5's traffic; a
        shorter stream is held to that stream's first tokens)."""
        want = {k: ref[k % 100][:len(v)] for k, v in got.items()}
        return divergence_gaps(want, got, next_logits, what)

    out = {"card": smi}
    gc.collect()
    torch.cuda.empty_cache()
    master = FakeMesos(cpus=64.0, mem=512 * 1024.0, gpus=8.0)
    zk = FakeZK(master.addr)
    try:
        out["a"] = edge_tfrun(master, zk)
        out.update(edge_serve(cfg, params, reqs, master, check))
    finally:
        zk.close()
        master.close()
    return out


def edge_tfrun(master, zk):
    """Phase 26 (a): ``tfrun -m zk://.../mesos -w 2 -s 0`` runs the
    port's ``plus`` in two Mesos tasks of one card each."""
    stdout, stderr, secs = child(
        ["tfmesos_tpu_torch.cli", "run", "-m", zk.url(), "-w", "2", "-s",
         "0", "-Gw", "1", "--worker-logs", "*", "--", sys.executable, "-m",
         "tfmesos_tpu_torch.plus"], 300)
    lines = stdout.splitlines()
    need(sorted(x for x in lines if x.endswith(" 42"))
         == ["[worker:0] 42", "[worker:1] 42"],
         f"26 (a): tfrun printed {lines[-10:]}")
    diag = sorted(x for x in lines if "] plus: " in x)
    need(len(diag) == 2 and all("'cuda:0', 'cuda:0'" in x for x in diag),
         f"26 (a): plus ran on {diag}")
    tasks = list(master.tasks.values())
    need(len(tasks) == 2 and all(t.exit_code == 0 for t in tasks),
         f"26 (a): tasks {[(t.id, t.state, t.exit_code) for t in tasks]}")
    gpus = [r["scalar"]["value"] for t in tasks
            for r in t.info["resources"] if r["name"] == "gpus"]
    need(gpus == [1.0, 1.0], f"26 (a): gpus asked {gpus}")
    running = master.running_times()
    out = {"seconds": secs, "subscribe_to_running_s": running,
           "zk_requests": len(zk.requests), "plus": diag,
           "calls": sorted({c["type"] for c in master.calls})}
    say("  (a) " + json.dumps(out))
    say(f"  (a) tfrun -m zk:// -w 2 -s 0 ran plus in 2 Mesos tasks (gpus "
        f"1 each): both printed 42 on cuda:0 over gloo; SUBSCRIBE to both "
        f"tasks RUNNING {max(running) * 1e3:.1f} ms; {secs:.1f} s in all")
    return out


def edge_serve(cfg, params, reqs, master, check):
    """Phase 26 (b)-(d): ``tfserve --master`` with two gateway processes,
    the HTTP/SSE edge and the batch lane; its replicas are Mesos tasks."""
    import os
    import signal

    token = "edge-token"
    env = dict(os.environ, TPUMESOS_TOKEN=token)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TPUMESOS_TOKEN_FILE", None)
    env.pop("MESOS_MASTER", None)
    cli = [sys.executable, "-m", "tfmesos_tpu_torch.cli"]
    http_port = free_port()
    tasks_before = len(master.tasks)
    before = smi_apps()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cli + ["serve", "--master", master.addr, "--http-port",
               str(http_port)] + EDGE_SERVE,
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    out_lines = ProcLines(proc)
    replica_pids_ = []
    gws = {}
    try:
        t_up, banner = out_lines.wait_for(
            lambda x: x.startswith("tfserve: gateway on"), 300.0)
        need(banner is not None, f"26 (b): no banner:\n{out_lines.tail()}")
        up_s = t_up - t0
        need(f"+ http 127.0.0.1:{http_port}" in banner
             and "2 gateway process(es)" in banner,
             f"26 (b): banner {banner!r}")
        public = re.search(r"process\(es\) \(([^),]+)", banner).group(1)
        gws = gateway_procs(proc.pid)
        need(len(gws) == 2, f"26 (b): gateway processes {gws}")
        registry = {a[a.index("--registry") + 1] for a in gws.values()}
        need(len(registry) == 1, f"26 (b): registries {registry}")
        registry = registry.pop()
        http_pid = [p for p, a in gws.items() if "--http-port" in a]
        need(len(http_pid) == 1, f"26 (b): HTTP carriers {http_pid}")
        addrs = registry_replicas(registry, token)
        replica_pids_ = replica_pids([os.getpid()])
        need(len(addrs) == 2 and len(replica_pids_) == 2,
             f"26 (b): replicas {addrs}, processes {replica_pids_}")
        mesos_tasks = list(master.tasks.values())[tasks_before:]
        need(len(mesos_tasks) == 2
             and all(t.state == "TASK_RUNNING" for t in mesos_tasks)
             and all(any(r["name"] == "gpus" and r["scalar"]["value"] == 1.0
                         for r in t.info["resources"])
                     for t in mesos_tasks),
             f"26 (b): Mesos tasks "
             f"{[(t.state, t.info['resources']) for t in mesos_tasks]}")
        card = on_the_card(replica_stats(addrs, token), replica_pids_,
                           2 * tree_numel(params), before, "26 (b)")
        out = {"b": edge_traffic(cfg, reqs, token, public, http_port, addrs,
                                 check, up_s, card, mesos_tasks)}
        out["c"] = edge_batch(cfg, reqs, token, public, addrs, check, cli,
                              env)
        out["d"] = edge_kill(cfg, reqs, token, public, addrs, check, gws,
                             http_pid[0], out_lines)
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            # A failed part: tfserve dies without stopping its gateway
            # processes, so they go too (the fake agent kills the tasks).
            proc.kill()
            proc.wait()
            for pid in pids_alive(list(gws)):
                os.kill(pid, signal.SIGKILL)
    need(proc.returncode == 0, f"26: tfserve exit code {proc.returncode}:"
         f"\n{out_lines.tail()}")
    deadline = time.perf_counter() + 30.0
    while pids_alive(replica_pids_ + list(gws)) \
            and time.perf_counter() < deadline:
        time.sleep(0.2)
    need(not pids_alive(replica_pids_ + list(gws)),
         f"26: {pids_alive(replica_pids_ + list(gws))} outlived tfserve")
    ends = sorted({t.state for t in list(master.tasks.values())[
        tasks_before:]})
    need(ends == ["TASK_KILLED"], f"26: the replica tasks ended {ends}")
    out["teardown"] = {"task_states": ends,
                       "calls": sorted({c["type"] for c in master.calls})}
    return out


def edge_traffic(cfg, reqs, token, public, http_port, addrs, check, up_s,
                 card, mesos_tasks):
    """Phase 26 (b): phase 5's 16 requests as 8 JSON and 8 SSE
    completions through gateway process 0's HTTP edge (and the first two
    prompts both ways), then all 16 over the wire through the shared
    gateway port, streamed."""
    warm = [(1000 + i, list(range(1, 9)), 2, {}) for i in range(4)]
    wire_streams(public, token, warm)
    zero = replica_stats(addrs, token, reset=True)
    http_out = {}

    def one(key, stream):
        r = reqs[key % 100]
        http_out[(key, stream)] = http_completion(
            http_port, r.prompt, r.max_new_tokens, stream)

    jobs = [functools.partial(one, i, i >= 8) for i in range(16)]
    jobs += [functools.partial(one, 100 + i, True) for i in range(2)]
    t0 = time.perf_counter()
    run_threads(jobs)
    http_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    replies, first = wire_streams(
        public, token, [(i, r.prompt, r.max_new_tokens, {})
                        for i, r in enumerate(reqs)])
    wire_wall = time.perf_counter() - t0
    launches = replica_launches(cfg, zero, settled_stats(addrs, token),
                                "26 (b)")
    # Each stream is held to phase 5's by the margin rule below; two
    # streams of one prompt in other batch compositions may part at a
    # near-tie, so their agreement is counted, not required.
    got_http = {k: v[0] for (k, _), v in http_out.items()}
    sse_eq_json = sum(http_out[(100 + i, True)][0] == http_out[(i, False)][0]
                      for i in range(2))
    http_eq_wire = sum(got_http[i] == replies[i]["tokens"]
                       for i in range(16))
    identical, gaps = check(got_http, "26 (b) HTTP")
    wire_identical, wire_gaps = check(
        {i: r["tokens"] for i, r in replies.items()}, "26 (b) wire")
    sse_first = [v[1] for (k, s), v in http_out.items() if s]
    stats = {"fleet_up_s": up_s, "mesos_tasks": [t.id for t in mesos_tasks],
             "http_json_total_ms": ms_stats(v[2] for (k, s), v in
                                            http_out.items() if not s),
             "sse_first_event_ms": ms_stats(sse_first),
             "wire_client_ttft_ms": ms_stats(first.values()),
             "http_wall_s": http_wall, "wire_wall_s": wire_wall,
             "identical": identical, "gaps": gaps,
             "wire_identical": wire_identical, "wire_gaps": wire_gaps,
             "sse_equal_json_of_prompt": sse_eq_json,
             "http_equal_wire_of_request": http_eq_wire,
             "launches": launches, "card": card}
    say("  (b) " + json.dumps(stats))
    say(f"  (b) tfserve --master up in {up_s:.1f} s (2 replicas as Mesos "
        f"tasks, 2 gateway processes); HTTP {identical}/{len(got_http)} "
        f"and wire "
        f"{wire_identical}/16 streams identical to phase 5's (the rest "
        f"near-ties; SSE = JSON for {sse_eq_json}/2 prompts, HTTP = wire "
        f"for {http_eq_wire}/16); SSE first event mean "
        f"{stats['sse_first_event_ms']['mean']:.2f} p50 "
        f"{stats['sse_first_event_ms']['p50']:.2f} ms; wire client TTFT "
        f"mean {stats['wire_client_ttft_ms']['mean']:.2f} p50 "
        f"{stats['wire_client_ttft_ms']['p50']:.2f} ms; launches "
        f"{launches}")
    return stats


def edge_batch(cfg, reqs, token, public, addrs, check, cli, env):
    """Phase 26 (c): ``tfserve batch`` submits phase 5's 16 prompts on the
    ``batch`` class while 8 interactive requests arrive."""
    import subprocess
    import tempfile

    new = min(8, reqs[0].max_new_tokens)
    idle = [(200 + i, reqs[i].prompt, new, {}) for i in range(8)]
    _, idle_first = wire_streams(public, token, idle, threads=8)
    before = replica_stats(addrs, token)
    zero = replica_stats(addrs, token, reset=True)
    # Phase 5's 16 prompts, three times over: 48 batch requests, 24 in
    # flight, keep every row of both replicas busy (with batch work
    # queued behind them) for three waves.
    copies = 3
    with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                     delete=False) as f:
        for _ in range(copies):
            for r in reqs:
                f.write(",".join(str(int(x)) for x in r.prompt) + "\n")
        prompts = f.name
    from tfmesos_tpu_torch.fleet.client import MuxConnection

    links = {a: MuxConnection(a, token) for a in addrs}
    t0 = time.perf_counter()
    batch = subprocess.Popen(
        cli + ["batch", "-g", public, "--file", prompts, "-n",
               str(reqs[0].max_new_tokens), "--concurrency", "24"],
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        # Busy: both replicas' 16 rows admitted batch work (a prompt
        # the prefix cache holds admits as a tail prefill).
        busy_at = None
        while time.perf_counter() - t0 < 60.0 and busy_at is None:
            admitted = 0
            for a, link in links.items():
                c = link.call({"op": "stats"}, timeout=60.0)["counters"]
                admitted += sum(c[k] - zero[a]["counters"][k]
                                for k in ("prefills", "tail_prefills"))
            if admitted >= 16:
                busy_at = time.perf_counter() - t0
            else:
                time.sleep(0.005)
        need(busy_at is not None, "26 (c): the batch lane never filled "
             "the rows")
        busy = [(300 + i, reqs[i].prompt, new, {}) for i in range(8)]
        busy_replies, busy_first = wire_streams(public, token, busy,
                                                threads=8)
        stdout, stderr = batch.communicate(timeout=300)
    finally:
        for link in links.values():
            link.close()
        if batch.poll() is None:
            batch.kill()
            batch.wait()
        Path(prompts).unlink()
    wall = time.perf_counter() - t0
    need(batch.returncode == 0, f"26 (c): tfserve batch exit "
         f"{batch.returncode}: {stderr[-2000:]}")
    rows = [json.loads(x) for x in stdout.splitlines()]
    n = copies * len(reqs)
    need(sorted(r["index"] for r in rows) == list(range(n)),
         f"26 (c): batch rows {rows[:3]}")
    identical, gaps = check(
        {r["index"] // len(reqs) * 100 + r["index"] % len(reqs): r["tokens"]
         for r in rows}, "26 (c) batch")
    busy_identical, _ = check({k: r["tokens"]
                               for k, r in busy_replies.items()},
                              "26 (c) interactive")
    after = settled_stats(addrs, token)
    launches = replica_launches(cfg, zero, after, "26 (c)")
    pre = sum(s["counters"]["preemptions"] - zero[a]["counters"][
        "preemptions"] for a, s in after.items())
    res = sum(s["counters"]["resumes"] - zero[a]["counters"]["resumes"]
              for a, s in after.items())
    stats = {"interactive_ttft_ms_lane_idle": ms_stats(idle_first.values()),
             "interactive_ttft_ms_lane_busy": ms_stats(busy_first.values()),
             "batch_rows_preempted": pre, "batch_rows_resumed": res,
             "batch_identical": identical, "batch_gaps": gaps,
             "interactive_identical": busy_identical,
             "lane_busy_after_s": busy_at, "wall_s": wall,
             "launches": launches, "replica_counters_before": {
                 a: s["counters"] for a, s in before.items()}}
    say("  (c) " + json.dumps(stats))
    say(f"  (c) tfserve batch: {identical}/{n} batch completions identical "
        f"to phase 5's (the rest near-ties); interactive client TTFT with "
        f"the lane busy mean "
        f"{stats['interactive_ttft_ms_lane_busy']['mean']:.2f} p50 "
        f"{stats['interactive_ttft_ms_lane_busy']['p50']:.2f} ms against "
        f"idle mean {stats['interactive_ttft_ms_lane_idle']['mean']:.2f} "
        f"p50 {stats['interactive_ttft_ms_lane_idle']['p50']:.2f} ms; "
        f"{pre} batch rows preempted, {res} resumed; launches {launches}")
    return stats


def edge_kill(cfg, reqs, token, public, addrs, check, gws, http_pid,
              out_lines):
    """Phase 26 (d): SIGKILL the gateway process that holds a client's
    connection while its requests stream; the clients fail over, no
    request is lost, and the dead process's lease expires."""
    import os
    import signal
    import threading

    from tfmesos_tpu_torch.fleet.client import FleetClient

    zero = replica_stats(addrs, token, reset=True)
    clients = [FleetClient(public, token, timeout=300.0) for _ in range(4)]
    try:
        owners = [socket_owner(c._connection()._sock, list(gws))
                  for c in clients]
        need(all(o in gws for o in owners), f"26 (d): owners {owners}")
        victim = owners[0]
        on_victim = [k for k, o in enumerate(owners) if o == victim]
        replies, streamed, stamps = {}, {}, {}
        started = []

        errors = []

        def worker(k):
            try:
                for i in range(k, 16, 4):
                    got = streamed.setdefault(i, [])

                    def on_tokens(toks, i=i, got=got):
                        stamps.setdefault(k, []).append(time.perf_counter())
                        started.append(i)
                        got.extend(toks)

                    replies[i] = clients[k].generate(
                        [int(x) for x in reqs[i].prompt],
                        reqs[i].max_new_tokens, on_tokens=on_tokens)
            except BaseException as e:      # reported below
                errors.append(repr(e))

        pool = [threading.Thread(target=worker, args=(k,))
                for k in range(4)]
        for t in pool:
            t.start()
        deadline = time.perf_counter() + 60.0
        while not any(i % 4 in on_victim for i in started) \
                and time.perf_counter() < deadline:
            time.sleep(0.002)
        t_kill = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        for t in pool:
            t.join(timeout=600.0)
        need(len(replies) == 16, f"26 (d): {len(replies)} of 16 requests "
             f"completed ({errors})")
        moved = [clients[k].addrs for k in on_victim]
    finally:
        for c in clients:
            c.close()
    for i, r in replies.items():
        need(streamed[i] == r["tokens"], f"26 (d): request {i} streamed "
             f"{len(streamed[i])} tokens for a reply of {len(r['tokens'])}")
    identical, gaps = check({i: r["tokens"] for i, r in replies.items()},
                            "26 (d)")
    gap_ms = max((min([s for s in stamps.get(k, []) if s > t_kill]
                      or [t_kill]) - t_kill) * 1e3 for k in on_victim)
    t_lease, line = out_lines.wait_for(
        lambda x: "lease expired" in x and public in x, 30.0)
    need(line is not None, f"26 (d): no lease expiry after the kill:\n"
         f"{out_lines.tail()}")
    need(pids_alive([victim]) == [], f"26 (d): {victim} still alive")
    survivor = [p for p in gws if p != victim]
    need(pids_alive(survivor) == survivor, f"26 (d): the survivor "
         f"{survivor} died")
    launches = replica_launches(cfg, zero, settled_stats(addrs, token),
                                "26 (d)")
    stats = {"victim": victim, "victim_carried_http": victim == http_pid,
             "clients_on_victim": len(on_victim), "failover_gap_ms": gap_ms,
             "lease_expired_after_s": t_lease - t_kill,
             "completed": len(replies), "identical": identical,
             "gaps": gaps, "client_addrs_after": moved,
             "launches": launches}
    say("  (d) " + json.dumps(stats))
    say(f"  (d) SIGKILL of gateway process {victim} under traffic: "
        f"{len(on_victim)} of 4 clients failed over, 16/16 requests "
        f"completed ({identical} identical to phase 5's, the rest "
        f"near-ties, streamed tokens exactly once); failover gap "
        f"{gap_ms:.1f} ms; its lease expired after "
        f"{t_lease - t_kill:.2f} s; launches {launches}")
    return stats


def quant_entry(entry_of, launches_of, quant_rows, total, commit_rows):
    """The kernels-line entry of ``quant_int8.cu``: its quantize rows,
    then its commit rows, launches of both entries together (and each
    apart), and the nine leaves in one launch."""
    entry = entry_of("quant_int8", "tfmesos_tpu_torch/csrc/quant_int8.cu",
                     "tfmesos_tpu/ops/quant.py:40", quant_rows + commit_rows,
                     0, quantize_params_9_leaves=total)
    q, c = launches_of("quant_int8"), launches_of("quant_int8_commit")
    entry["launches"] = q["launches"] + c["launches"]
    entry["launches_by_path"] = {
        p: n + c["launches_by_path"][p]
        for p, n in q["launches_by_path"].items()}
    entry["quantize_launches"], entry["commit_launches"] = q, c
    return entry


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import tfmesos_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    pkg_root = Path(tfmesos_tpu_torch.__file__).resolve().parent.parent
    need(pkg_root == ROOT, f"tfmesos_tpu_torch imported from {pkg_root}, "
         f"not from this checkout ({ROOT})")

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 3)
        say(f"  ({name}: {seconds[name]} s)")
        return out

    smi = phase_device(torch)
    timed("build", phase_build)
    flash_rows, paged_rows = timed("kernels", phase_kernels, torch)
    (decode_rows, decode_cold_row, paged8_rows, quant_rows, quant_total,
     commit_rows) = timed("decode kernels", phase_decode_kernels, torch)
    bwd_rows, bwd_checks = timed("backward", phase_backward, torch)
    cfg, params, reqs, comps, stats = timed("serve", phase_serve, torch, np)
    timed("teacher-forced", phase_teacher_forced, torch, cfg, params, comps)
    timed("forward", phase_forward, torch)
    train_cfg, train = timed("train", phase_train, torch)
    timed("train vs cpu", phase_train_vs_cpu, torch, train_cfg)
    gen8 = timed("generate int8", phase_generate_int8, torch)
    gen_long = timed("generate long", phase_generate_long, torch)
    serve8, comps8 = timed("serve int8", phase_serve_int8, torch, np, reqs)
    sampled = timed("sampled", phase_sampled, torch, reqs)
    fleet, bases14 = timed("prefix cache and chunks", phase_prefix_chunked,
                           torch, np)
    moves = timed("export, preempt, rolling", phase_disagg_preempt_rolling,
                  torch, np)
    modes = timed("schedule modes", phase_schedule_modes, torch, np, reqs,
                  comps, comps8, stats, serve8, bases14, fleet)
    replica = timed("replica", phase_replica, torch, np, cfg, params, reqs,
                    streams(comps), stats)
    front = timed("front door", phase_front_door, torch, np, cfg, params,
                  reqs, streams(comps))
    sessions = timed("sessions", phase_sessions, torch, np)
    spec = timed("speculative", phase_spec, torch, np, reqs, streams(comps),
                 stats, bases14["prefix cache"], fleet["prefix cache"])
    control = timed("control loops", phase_control, torch, np, cfg, params,
                    reqs, streams(comps))
    ckpt = timed("checkpointed training", phase_checkpointed, torch, np,
                 train)
    # Phase 23's launches and phase 27's (b) and (c) start together;
    # this process computes (b) and (c)'s references, then phase 23 (c)
    # while they run.
    gc.collect()
    torch.cuda.empty_cache()
    launched = start_children(
        surface_argvs() + [moe_argv(k) for k in MOE_TRAIN], 900)
    say(f"(phase 23's launches and phase 27's {sorted(MOE_TRAIN)} "
        f"started)")
    moe_refs = timed("moe references", moe_references, torch)
    surface = timed("surface", phase_surface, torch, np, train,
                    launched[:3])
    moe = timed("moe", phase_moe, torch, np, reqs, launched[3:], moe_refs)
    # Phase 28's launches start with phase 24's (b)-(d) (phase 23's and
    # 27's leave no room on the card for them); phase 24 computes their
    # references while they run.
    train_dir = tempfile.mkdtemp(prefix="chip-smoke-train-")
    try:
        pp_smi = SmiMemory()
        mesh = timed("mesh", phase_mesh, torch, np, cfg, params, reqs,
                     comps, comps8, {"flash": flash_rows, "bwd": bwd_rows,
                                     "paged": paged_rows,
                                     "decode": decode_rows,
                                     "commit": commit_rows}, train_dir,
                     [pp_argv(k, train_dir) for k in PP_TRAIN], pp_smi)
        pipeline = timed("pipeline", phase_pipeline, torch, mesh["beside"],
                         mesh["refs"], train_dir, pp_smi)
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    gang = timed("gang", phase_gang, torch, np, cfg, params, reqs, comps,
                 comps8, replica["a"])
    edge = timed("edges", phase_edge, torch, cfg, params, reqs,
                 streams(comps), smi)
    say("phase seconds: " + json.dumps(seconds))

    paths = {"serve": stats["launches"], "train": train["launches"],
             "generate_int8": gen8["launches"],
             "generate_long": gen_long["launches"],
             "serve_int8": serve8["launches"],
             "generate_int8_sampled": sampled["generate"]["launches"],
             **{f"{label} (graphed)": row["graphed"]["launches"]
                for label, row in sampled.items()
                if label.startswith("serve")},
             **{f"serve {label} (graphed)": row["graphed"]["launches"]
                for label, row in fleet.items()},
             **{f"serve {label}": row["launches"]
                for label, row in moves.items() if label.startswith("import")},
             "serve preempt_all": moves["preempt"]["launches_preempt_all"],
             "serve resume": moves["preempt"]["launches_resume"],
             "generate windowed": moves["rolling"]["launches"],
             **{f"serve {label}": row["launches"]
                for label, row in modes.items()},
             "replica serve (wire)": replica["a"]["launches"],
             **{f"replica migrate {mode} (wire)": row["launches"]
                for mode, row in replica["b"].items()},
             "replica prefill export (wire)": replica["c"]["launches_export"],
             "replica decode import (wire)": replica["c"]["launches"],
             "front door unified (processes)": front["a"]["launches"],
             "front door migrate (processes)": front["b"]["launches"],
             "front door disaggregated (processes)": front["c"]["launches"],
             **{f"sessions (a) {label}": counts for label, counts
                in sessions["a"]["launches"].items()},
             **{f"sessions (b) {label}": row["launches"]
                for label, row in sessions["b"]["runs"].items()},
             "sessions (c) front door (processes)":
                 sessions["c"]["launches"],
             "sessions (d) fabric (processes)": sessions["d"]["launches"],
             **{f"spec {label}": spec[label]["launches"]
                for label in ("a preset draft", "b self-draft",
                              "c self-draft multi_step=8",
                              "d self-draft overlap",
                              "e self-draft int8 draft pool",
                              "f self-draft sampled", "g static prefix",
                              "h weight swaps")},
             **{f"spec i speculative_generate {name}":
                spec["i speculative_generate"][name]["launches"]
                for name in ("preset draft", "self-draft")},
             "spec j replica --draft (process)":
                 spec["j replica --draft"]["launches"],
             "control (a) autoscale (processes)": control["a"]["launches"],
             "control (b) rollout (processes)": control["b"]["launches"],
             "control (c) catalog (processes)": control["c"]["launches"],
             "train checkpointed (a)": ckpt["a"]["launches"],
             "train supervised (b)": ckpt["b"]["launches"],
             "train --data (c)": ckpt["c"]["launches"],
             "train remat (d)": ckpt["d"]["launches"],
             "surface (c) Mode A elastic chunks (processes)":
                 surface["c"]["launches"],
             "mesh (b) serve tp=2 bf16 (processes)":
                 mesh["b"]["bf16"]["launches"],
             "mesh (b) tp=2 KV surface (Mode A ranks)":
                 mesh["b"]["kv"]["launches"],
             "mesh (b) serve tp=2 int8 (processes)":
                 mesh["b"]["int8"]["launches"],
             "mesh (c) serve dp=2,tp=2 (processes)": mesh["c"]["launches"],
             "mesh (d) train tp=2 (processes)":
                 mesh["d"]["tp=2"]["launches"],
             "mesh (d) tfrun fsdp=2 (processes)":
                 mesh["d"]["fsdp=2"]["launches"],
             "gang (a) bf16 (processes)": gang["a"]["launches"],
             "gang (a) int8 (processes)": gang["a"]["int8"]["launches"],
             "gang (b) re-formed (processes)": gang["b"]["launches"],
             "gang (c) KV artifacts": gang["c"]["launches"],
             "edge (b) HTTP, SSE and wire (Mesos tasks)":
                 edge["b"]["launches"],
             "edge (c) batch lane (Mesos tasks)": edge["c"]["launches"],
             "edge (d) gateway SIGKILL (Mesos tasks)":
                 edge["d"]["launches"],
             "moe (a) quantize_params over the MoE tree":
                 moe["quantize"]["launches"],
             "moe (a) serve 8 experts top 2 (graphed)":
                 moe["a"]["launches"],
             "moe (b) train sp=2,ep=2 switch (processes)":
                 moe["b"]["launches"],
             "moe (c) train sp=2 ulysses (processes)":
                 moe["c"]["launches"],
             "pipeline (a) train pp=2 gpipe (processes)":
                 pipeline["a"]["launches"],
             "pipeline (b) train pp=2 1f1b (processes)":
                 pipeline["b"]["launches"],
             "pipeline (c) train pp=2 circular v=2 (processes)":
                 pipeline["c"]["launches"],
             "pipeline (d) train pp=2,ep=2 1f1b moe (processes)":
                 pipeline["d"]["launches"]}

    def launches_of(name):
        by_path = {p: counts[name] for p, counts in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    def entry_of(name, source, replaces, rows, rep, **extra):
        r = rows[rep]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **launches_of(name),
                "max_abs_err": max(x["max_abs_err"] for x in rows),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": r["shape"],
                "shapes": rows, **extra}

    def bwd_entry(name, key, replaces, errs):
        r = bwd_rows[0]                      # the training shape
        return {"name": name, "route": "cuda",
                "source": "tfmesos_tpu_torch/csrc/flash_bwd.cu",
                "replaces": replaces, **launches_of(name),
                "max_abs_err": max(r[f"{e}_err"] for e in errs),
                "ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                "bound_ms": r[f"{key}_bound_ms"],
                "bound_by": r[f"{key}_bound_by"],
                "library_ms": r["library_ms"],
                "library_covers": "SDPA backward: dq, dk and dv together",
                "kernel_route": r[f"{key}_route"][0],
                "block_rows": r[f"{key}_route"][1],
                "tile_rows": r[f"{key}_route"][2],
                "backward_ms": r["backward_ms"],
                "shape": r["shape"], "shapes": bwd_rows,
                "checks": bwd_checks}

    kernels = [
        entry_of("flash_fwd", "tfmesos_tpu_torch/csrc/flash_fwd.cu",
                 "tfmesos_tpu/ops/attention.py:127", flash_rows, 1,
                 routes={f"{r['shape']} kv {r['kv']} tk {r['tk']}":
                         [r["route"], r["block_rows"]] for r in flash_rows}),
        entry_of("flash_decode_paged",
                 "tfmesos_tpu_torch/csrc/flash_decode_paged.cu",
                 "tfmesos_tpu/ops/attention.py:871",
                 paged_rows + paged8_rows, 0,
                 splits=paged_rows[0]["splits"],
                 merge_launches=launches_of("flash_decode_paged_merge")),
        entry_of("flash_decode", "tfmesos_tpu_torch/csrc/flash_decode.cu",
                 "tfmesos_tpu/ops/attention.py:596", decode_rows, 0,
                 splits=decode_rows[0]["splits"],
                 merge_launches=launches_of("flash_decode_merge"),
                 cold_l2=decode_cold_row),
        bwd_entry("flash_bwd_dq", "dq", "tfmesos_tpu/ops/attention.py:246",
                  ("dq",)),
        bwd_entry("flash_bwd_dkv", "dkv", "tfmesos_tpu/ops/attention.py:302",
                  ("dk", "dv")),
        quant_entry(entry_of, launches_of, quant_rows, quant_total,
                    commit_rows),
    ]
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
