#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nine
   sources, thirteen kernel rows; one nvcc per source, started together) and
   print what ptxas reports. Both flash kernels must show wgmma
   (``HGMMA``, of TF32 type in the f32 one) and TMA loads (``UTMALDG``) in
   their SASS (``cuobjdump``) and no spills.
2. Hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (W=4 lanes, table [3, 224, 294912] bf16, a chain
   of K=4 positions, latent snapshots [5, 4, 32, 32, 4] f32), in f32 and
   bf16, and at shapes whose C is not a multiple of the block: the
   refresh, the rollback and the ring shift bitwise; the predict within
   one bf16 ulp (rtol 2^-8; f32: 1e-6) of the plain f32 sum; the chain
   predict within that rtol plus 2^-21·Σ|w·x| (FMA against
   multiply-then-add rounding of its larger extrapolation terms), and
   every chain position (K = 1 and 4) bitwise the depth-1 predict kernel;
   the verify error to rtol 1e-5 with equal accept bits
   wherever |e − τ| > 1e-5, in one kernel launch a call (the profiler
   counts them); the rollback also from a list of snapshots (the chain
   step's form). Time each kernel (CUDA events; for the verify and the
   rollback also their device time from ``torch.profiler``) beside its
   plain version, one PyTorch library call where one computes the same
   function, and its bound (bytes over 3.35 TB/s, f32 operations over 67
   TFLOP/s — the H100 SXM data sheet at 700 W); the rollback over the
   snapshot list in turns with the chain step's old restore (a
   ``torch.stack`` of the snapshots, then the stacked entry).
   The reference's scalar-anchor kernel surface runs here too, with the
   launch counts set to 0 just before and read just after: the table
   [3, 28, 2, 4, 256, 1152] bf16 as one whole-batch anchor with seeded
   weights, distinct and not powers of two, through
   ``ops.taylor_predict`` (within one bf16 ulp of its plain f32 sum and
   bitwise the lane predict with the weight column broadcast) and
   ``ops.taylor_update`` (bitwise), and the verify planes [4, 294912]
   through the τ-less ``ops.verify_sums`` and ``ops.verify_error`` (rtol
   1e-5; the error one kernel a call, bitwise ``verify_accept``'s err and
   the two-step finish over the sums, and timed beside that finish); each
   is also checked at the other shapes above. The mixed guided/unguided
   verify ``ops.verify_accept_mixed`` at the serving planes [4, 294912]
   and at W = 5 (odd tail) with N = 6149 and 3000 (not multiples of the
   chunk), in bf16 and f32, paired all-False, all-True and the first pair
   only, scales 1.5 and 4.0: rtol 1e-5 against its plain version with
   equal accept bits wherever |e − τ| > 1e-5, one kernel a call, its
   unpaired rows bitwise ``ops.verify_accept`` on the same planes and its
   paired rows bitwise ``ops.verify_accept`` on the plain f32 planes; timed
   in turns with the two-step it replaces (the plain planes, then
   ``ops.verify_accept``), by events and device time, beside its bound.
2a. The same kernels at the decode lanes' shapes (``decode_kernels``):
   the lane predict, the refresh, the chain predict (K = 1 and 4) and the
   ring shift on the bf16 table [3, 8, 2, 4, 1, 4096] of Llama-3-8B
   lanes (8 layers: phase 11's depth); the verify on [4, 1, 4096] planes
   (two of its 2,048-element chunks a row); the rollback on int32 token
   buffers [4, 64] and [4, 1] (lane axis 0) and on a bf16 K/V cache
   [8, 4, 192, 8, 128] (lane axis 1), from a snapshot list and stacked
   — under the bars above, each timed beside its plain version and its
   bound (device time also with the L2 flushed before each call: the
   table fits in it). The lane and chain predicts again on the table at
   Llama-3-8B's own 32 layers (``decode_32``). Every predict row also
   times its launch floor (``floor_ms``): the library's empty kernel on
   the grid, block and shared memory the predict takes for those
   arguments.
2b. Attention: ``full_attention(use_flash=True)`` at gemma3-27b's widths
   (32 query heads on 16 KV heads, head dim 128, S = 4096) with a local
   window of 1024 and globally, and ``ops.flash_attention(causal=False)``
   at DiT-XL/2's (4 lanes, 256 tokens, 16 heads of 72), in three routes:
   bf16 (the bf16 tensor-core kernel), the same values in f32, and inputs
   drawn in f32 (the 3×TF32 kernel; bf16 values fit in TF32, so only
   full-mantissa inputs show that the split is there), launch counts set
   to 0 just before and read just after (3 bf16 launches, 6 f32). Each
   output is held against the plain f32 attention (bf16 within one bf16
   ulp: rtol 2^-8, atol 1e-5; f32 within rtol = atol = 2e-5), the bf16
   one also against the port's own mask path or SDPA core (rtol 2^-7),
   and each is timed beside ``scaled_dot_product_attention`` on the same
   inputs. Bounds: 4·hd operations per visible pair over the dense bf16
   tensor cores' 989.4 TFLOP/s for bf16 operands; 12·hd (three TF32
   products per f32 product) over the dense TF32 rate of 494.7 TFLOP/s
   for f32 ones, with 4·hd over the f32 CUDA cores' 67 TFLOP/s beside.
3. Serve DiT-XL/2 at full width (28 layers, d 1152, bf16, 32×32×4
   latents, 50 DDIM steps) through ``SpeCaEngine.serve_batched``: 8
   requests at lanes=4, taylor_order=2, per-sample accept, fused verify.
   Weights are random from a seed; the AdaLN-Zero leaves, which the
   reference initialises to zero (every increment 0 ⇒ every draft
   accepted ⇒ a vacuous run), are drawn from small seeded noise here.
   Launch counts are reset just before this run and read just after:
   every kernel must have launched. The first 4 requests are served again
   at lanes=1 and must keep identical per-request counters and accept
   trajectories and samples within 1e-5. Should that gate fail, the W1
   probe (``_width_probe``: ``tools/width_probe.py`` on one forward of
   the 4 latents at once against each alone) names the first op whose
   output differs, with its row count M at both widths and max |Δ|,
   before the phase fails.
4. Deep speculation: the same model and requests on
   ``SpeCaEngine(max_draft_depth=4)`` with ``draft_depth`` 1, 2, 4, 4 by
   request. The chain predict and the rollback must have launched in this
   run, the rollback at most once a chain tick and never on a tick that
   drafted nothing (so the payload is never stacked); every request must
   keep phase 3's accept trajectory and counters with samples within
   1e-5 of phase 3's, in fewer ticks; the first 4 requests re-served at
   lanes=1 keep their counters.
5. The spectral forecaster: ``SpeCaEngine(forecaster="spectral",
   max_draft_depth=4)`` serves 4 depth-4 requests at lanes=4 (the ring
   shift and the chain predict must launch, the rollback as in phase 4)
   and at lanes=1, with identical counters.
6. Classifier-free guidance (``serve_guided``): 8 requests at lanes=4 —
   0-3 guided (scales 4.0, 1.5, 4.0, 1.5; request 2 with a negative
   prompt), 4-7 phase 3's requests 0-3 — queued alternately so that guided
   pairs and single lanes share ticks. ``verify_accept_mixed``, the lane
   predict and the refresh must launch and ``verify_accept`` must not;
   the unguided requests keep phase 3's trajectories, counters and
   samples (within 1e-5); lanes=2 keeps every counter; some guided draft
   must be accepted and some rejected (a guided request with more drafted
   steps than accepted ones). Then the 4 guided requests at draft depth 4
   on ``SpeCaEngine(max_draft_depth=4)``: the chain predict, the rollback
   (as in phase 4) and the mixed verify launch, some chain tick must have
   a paired lane reject a drafted position (its ``n_drafted`` above its
   ``n_spec``, so the rollback restored an earlier snapshot), the depth-1
   trajectories hold in fewer ticks, lanes=2 keeps the counters.
7. The closed-loop controller (``serve_controller``): 8 requests at
   lanes=4 on ``SpeCaEngine(controller=True, max_draft_depth=4)``, phase
   3's requests 0-3 controller-free beside 4-7 under ``ControllerPolicy``
   (the accept SLO at its defaults, ``target_accept=0.9``, the deadline
   SLO at 30 ticks with ``tau_max`` 2·τ0, ``order_max=1``), queued
   alternately. The chain predict and the rollback must launch; the
   controller-free requests keep phase 3's trajectories and counters
   (samples within 1e-5); a controlled request needs fewer service ticks
   than steps (its ``draft_k`` left 1); re-served at lanes=2 every counter
   holds, no accept-SLO lane holds τ0 above its base at any tick (and one
   drops below it), and every prediction under an order cap of 1 has
   zero order-2 weights, request 7's lane among them while warm.
8. The serving lifecycle (``serve_lifecycle``): ``warmup(mixed=True)``
   from a cleared library loader must load exactly the step's kernel
   libraries; then phase 3's 8 requests through ``submit`` and
   ``stream(previews=True)`` under FIFO at lanes=4 must equal phase 3's
   Results bitwise (the pair-capable session verifies through
   ``verify_accept_mixed``), with previews for every request and no
   library loaded; one slot serves a long request before two short ones
   with deadlines under FIFO, SJF and EDF (SJF's mean completion tick
   below FIFO's, EDF's deadline hit rate at least FIFO's, trajectories
   unchanged); ``QueueFull`` at ``max_queue``; ``shutdown`` reports the
   requests in flight and queued as dropped.
9. Observability (``serve_obs``): phase 8's traffic on fresh lifecycle
   engines, obs off, on, on, off in turns: each run equals phase 3's
   Results bitwise with phase 8's host syncs; on the first ``obs=True``
   run the snapshot's ``speca_obs_ticks_total`` equals the ticks,
   ``speca_n_spec_total``/``speca_full_total``/``speca_n_drafted_total``
   the Results' sums, the ``speca_chain_err`` count Σ ``num_drafted``
   (unguided: one lane per request), ``speca_requests_completed_total``
   8; ``speca_queue_depth`` has one point per tick, the first 8; each
   ``trace(ticket)`` has ``service_ticks`` tick spans; ``chrome_trace``
   and ``prometheus`` render (``chiprun_out/serve_obs_trace.json``,
   ``serve_obs_metrics.prom``) and the JSON loads back. Then phase 7's
   traffic on ``SpeCaEngine(controller=True, max_draft_depth=4,
   obs=True)``: phase 7's Results bitwise and its host syncs, the same
   totals, ``chain_err`` [4, 4], some tick span named ``rollback``.
   Every ``LaneAccumulator.update`` of these runs runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (shown live first: an
   ``.item()`` under it raises). Printed, not gated: one update's
   stream operations (kernel launches and copies) and device µs
   (torch.profiler) for a depth-1 and a chain tick's flags, and the
   lifecycle walls on and off.
10. ``speca_sample`` at batch 2 on the same model.
10a. ``flux_kernels``: the main path's kernels at the FLUX-like serving
    table [3, 38, 2, 4, 1024, 3072] bf16 (5.7 GB; 304 rows of 3.1 M,
    element offsets past 2^31): the lane predict and every chain position
    (K = 4) within one bf16 ulp (rtol 2^-8) of the plain f32 sum, each
    chain position also bitwise the lane predict with its weights, the
    refresh (bitwise), the verify on [4, 1024·3072] planes (rtol 1e-5,
    accept bits wherever |e − τ| > 1e-5) and the rollback bitwise on
    latent snapshots [5] × [4, 64, 64, 16] f32; each timed by CUDA events
    beside its plain version, a library call and its bound (the rows'
    ``flux`` entry).
10b. ``video_kernels``: the same at the HunyuanVideo-like serving table
    [3, 40, 2, 2, 2048, 3072] bf16 (6.0 GB; 160 rows of 6.3 M), the
    verify on [2, 2048·3072] planes and the rollback on the 5-D latent
    snapshots [5] × [2, 8, 32, 32, 16] f32 that phase 10d rolls back (the
    rows' ``video`` entry).
10c. Text-to-image (``serve_flux``): FLUX-like at full width and depth
    (``repro_torch.configs.FLUX_LIKE``: 38 layers, d 3072, 24 heads,
    d_ff 12288, 16 latent channels, ``cond_dim`` 768; bf16 random weights
    drawn on the card and tamed as in phase 3, the text projection at the
    reference's N(0, 1/768)), 50 rectified-flow steps on 64×64 latents
    (1024 tokens), each request with a seeded text stub [1, 8, 768] of
    scale 0.1, ``SpeCaConfig(taylor_order=2)`` (phase 3's τ0). (a) 4
    requests at lanes=4, the launch counts set to 0 just before and read
    just after: the lane predict, refresh and verify launch; (b) the same
    requests at lanes=2: equal accepts and counters, samples within 1e-5
    (where an accept differs, the first step and |e − τ| there are
    printed and recorded first); (c) one guided request (scale 3.5, null
    = the zeroed stub) beside (a)'s requests 0 and 1 at lanes=4:
    ``verify_accept_mixed`` launches and ``verify_accept`` does not, the
    unguided requests keep (a)'s trajectories and samples (1e-5). Some
    draft is accepted and some rejected over the phase. Recorded: walls,
    ticks, α, host syncs, peak memory, how far a stub moves t_emb, and one
    full and one speculative forward at lanes=4 (wall, kernels, device
    busy time from torch.profiler, the attention kernel) beside their
    bounds; each forward's reading is two traced windows of one call
    with equal kernel counts, counted in phase 13.
10d. Text-to-video (``serve_video``): HunyuanVideo-like at full width
    and depth (``HUNYUAN_VIDEO_LIKE``: 40 layers, otherwise as FLUX-like),
    8 latent frames of 32×32 (2048 tokens), 50 rectified-flow steps, 2
    requests at lanes=2: depth 1 (lane predict, refresh and verify
    launch), then on ``SpeCaEngine(max_draft_depth=4)`` at draft depth 4:
    the chain predict and the rollback launch (on the 5-D latent
    snapshots, once a chain tick that drafted and never on one that did
    not), accepts, counters and samples (1e-5) equal depth 1's, in fewer
    ticks. Recorded as for 10c. Each of 10a–10d frees its tensors and the
    allocator's cache before the next phase.
11. LLM decode lanes (``serve_decode``): Llama-3-8B at full width, its
    depth cut to DECODE_LAYERS = 8 of 32 to keep the run in time for the
    phases after it (``repro_torch.configs.LLAMA3_8B``: d 4096, 32 heads
    on 8 KV heads, d_ff 14336, vocabulary 128,256; bf16, random weights
    drawn on the card from a seed), 8 requests with seeded prompt
    lengths in 16–128 and token ids uniform over the vocabulary, 64 new
    tokens each, ``max_seq_len`` 192, ``SpeCaConfig(taylor_order=2)``.
    (a) τ0 = 0 at lanes=1: every request's tokens equal the port's greedy
    loop (``lm_forward`` prefill + ``lm_decode_step``), all 64 steps
    full; (b) at τ0 = the median error of (a)'s drafts, lanes=4 with the
    launch counts set to 0 just before and read just after: the lane
    predict, refresh and verify launch, some draft is accepted and some
    rejected; lanes=1 is served beside it and gives every request the
    same tokens and accepts (W2, decode products and RMSNorm on lanes
    padded to 8); (c) a
    raw ``build_workload_step`` loop at ``max_draft_depth=4`` and (d) the
    same with ``forecaster="spectral"`` land on their depth-1 runs bitwise
    (``tok``, ``tokens``, both caches, every counter) in fewer ticks, a
    chain tick launching the rollback once per payload leaf when some
    lane drafted and never when none did.
11a. The rest of decode (``serve_moe``, ``serve_ssm``, ``serve_hybrid``;
    11a–11c run after phase 12, once the Llama-3-8B weights are freed):
    granite-moe-1b-a400m (24 layers, d 1024, 16 heads on 8 KV heads, 32
    experts top-8, d_ff 512, vocabulary 49,155), mamba2-130m (24 layers,
    d 768, SSD state 128, 24 heads of 64) and hymba-1.5b (d 1600, 25
    heads on 5 KV heads, window 1024 with every 16th layer global, SSD
    state 16, d_ff 5504), each at full width; the first two at full
    depth, hymba at ``HYBRID_LAYERS`` = 16 of 32 layers. First
    the decode kernels at the family's own shapes against their plain
    versions, before its model is drawn: the lane predict, refresh and
    chain predict (K = 1 and 4) on its lane table [3, L, 2, 4, 1, d], the
    verify on [4, 1, d] planes (d 768 and 1600 end in a partial chunk),
    the rollback bitwise on seeded snapshots of every cache leaf (the f32
    ``ssm_state``, the 4-D ``conv_state``, bf16 K/V; lane axis 1), each
    timed under the rows' phase entry. Then bf16 random weights drawn on
    the card from a seed and freed after, the traffic of phase 11: (a)
    τ0 = 0 at lanes=1 on all 8 requests equals the port's greedy loop (the
    prefill's SSD state and conv tail taken whole); (b) at the
    median draft error, lanes=4, launch counts set to 0 just before and
    read just after: the lane predict, refresh and verify launch, drafts
    are accepted and rejected, lanes=1 equal (W2); then for mamba2 and
    hymba (c) a depth-4 chain on the raw loop lands bitwise on depth 1
    (``tok``, ``tokens``, ``ssm_state``, ``conv_state``, K/V, every
    counter) in fewer ticks, the rollback launched once per payload leaf
    on a chain tick where some lane drafted and never where none did.
    Recorded: walls, ticks, α, host syncs, peak memory, one full
    forward's wall, kernels and device busy time.
11b. ``decode_ring``: mixtral-8x7b at full width (d 4096, 32 heads on 8
    KV heads, 8 experts top-2, d_ff 14336, window 4096), its depth cut to
    4 of 32 layers (93 GB of bf16 does not fit 80 GB): 2 sequences of
    4,160 seeded tokens through ``lm_decode_step`` from position 0 on the
    ring-buffer cache (it wraps at 4,096) and on an absolute-position
    cache of 4,160 rows with the same window; the logits of the two runs
    bitwise before the wrap and within 2^-4 of their largest magnitude at
    every position past it (checked at every 64th position and all 64
    past the wrap); greedy tokens recorded. At layer 0 (K/V a function of
    token and position alone), at every position past the wrap, every
    ring slot is bitwise the absolute row it must hold, and the ring
    attention of a seeded f32 query lies within ``RING_ATTN_TOL`` of the
    absolute cache's, a bound that two faults planted in the same run (an
    off-by-one window, one stale slot) must exceed.
11c. ``decode_audio``: musicgen-medium at full width and depth (48
    layers, d 1536, 4 codebooks of 2,048, GELU): 2 requests, an
    ``lm_forward`` prefill of 32 frames, then 64 greedy ``lm_decode_step``s;
    the last step's logits [2, 1, 4, V] within 2^-4 of their largest
    magnitude of ``lm_forward`` over the whole sequence.
12. ``serve_mixed``: one lifecycle engine with the DiT-XL/2 quartet and
    ``workloads={"decode": ...}`` serves phase 3's requests 0-3 and the
    decode requests 0-3, submitted alternately, at lanes=4 each; each
    side's samples, tokens, counters and FLOPs equal its solo run's at
    the same width, and both sessions' kernels launch.
12a. ``shard_kernels``: the eight lane-sharded routings
    (``ops.*_sharded``) over D = 2 and 4 shards on this card (one card
    suffices: a ``LaneMesh`` may repeat a device), in bf16 and
    f32, at the serving shapes of phase 2 (the pair verifies on 2·D
    lanes): the blocks gathered are bitwise the unsharded kernel's
    result, held against the plain version as phase 2 holds it; one
    call launches the kernel D times (the routing's count and the
    kernel's); the pair verifies at 4 lanes on 4 shards raise the pair
    rule. bf16 ms a call (CUDA events) beside the unsharded call, under
    each kernel row's ``sharded`` entry.
12b. ``serve_sharded``: DiT-XL/2 on ``SpeCaEngine(mesh=)``: phase 3's 8
    requests at lanes=4 over D = 2 and 4 shards; at D = 2 phase 6's
    guided pairs beside unguided lanes (width 4 = 2·D), phase 4's
    depth-4 chains, phase 5's spectral chains, and phase 3's requests
    0-3 under ``accept_mode="batch"`` beside an unsharded batch run.
    Each run against its unsharded run: accepts, counters, FLOPs and
    host syncs equal, samples within 1e-5 (the max recorded); every
    kernel of its path launched, each launch through its routing.
12c. ``serve_decode_sharded``: Llama-3-8B decode lanes over 2 shards at
    phase 11's τ0: its 8 requests × 64 tokens at lanes=4 equal (b)'s
    tokens, accepts, counters and host syncs.
13a. ``train_dit``: DiT-XL/2 at full width and depth in f32 (28 layers,
    d 1152, 1,000 classes; 32×32×4 GM latents, DDPM cosine), 100 AdamW
    steps (global batch 8, lr 1e-4, warmup 10, seed 0) through
    ``train_diffusion``: every loss finite and the mean of the last 10
    below that of the first 10; one step at 2 of 28 layers, batch 2, on
    the card against the CPU from the same parameters and draws (loss
    within rtol 1e-5, every gradient leaf within 1e-4·max|g|). s/step,
    peak memory and the loss curve recorded.
13b. ``checkpoint``: the trained parameters saved in the repo's format to
    a temporary directory (deleted after), restored by
    ``restore_checkpoint`` and by ``params_from_checkpoint``: both bitwise
    the trained tree; size and seconds recorded.
13c. ``e2e_dit``: on the restored weights, 4 labels and one noise tensor
    through ``sample_full``, ``speca_sample`` (order 2, max_draft 8, τ0
    0.3, β 0.9; the lane predict and refresh must launch, counted in the
    rows' ``e2e_dit`` entry) and the baselines ``taylorseer`` 4 and 7,
    ``fora`` 4 and 7, ``ab2(4)``, ``teacache(0.3)`` and
    ``step_reduction_sample(0.5)``: every static baseline's anchor
    schedule as its interval and order imply, every latent finite,
    ``num_full + num_spec`` the step count; α, the relative L2 deviation
    from ``sample_full``, the FLOPs ratio and the wall time recorded, not
    gated.
13d. ``train_lm``: Qwen1.5-0.5B at full width and depth (bf16, tied
    embeddings) through ``launch/train.py``'s ``train`` with remat: batch
    8, sequence 256, 20 steps at lr 1e-3, finite and falling as 13a; one
    step at 2 of 24 layers in f32 on the card against the CPU as 13a;
    remat on against off in bf16 on the card: the same loss, gradients
    within 1e-6·max|g|.
13e. ``cli``: ``python -m repro_torch.launch.serve --mode diffusion
    --requests 4`` at ``--lanes 4`` and ``--lanes 1`` (per-request
    ``full=/spec=`` counters equal), at ``--lanes 4 --device cpu`` with
    ``--mesh 1`` and ``--mesh 2`` (equal counters), ``--mesh 2`` on the
    card (with one card visible it must exit non-zero naming the lane
    mesh), ``--mode lm --arch qwen1.5-0.5b``,
    and ``python -m repro_torch.launch.train --arch mamba2-130m --reduced
    --steps 5``, each as a subprocess that must exit 0.
13f. ``dryrun``: (a) the production-mesh dry run
    (``python -m repro_torch.launch.dryrun``) at full width on a fake
    process group, no tensor allocated, of one combination of each family
    and shape kind (``DRYRUN_CASES``: llama3-8b × train_4k, prefill_32k,
    decode_32k and long_500k (its +swa variant), mixtral-8x7b × decode_32k,
    mamba2-130m × long_500k, gemma3-27b × prefill_32k, hymba-1.5b ×
    train_4k) on pod16x16 and pod2x16x16, one process a combination
    (``--both-meshes``), ``DRYRUN_PROCS`` at a time; each must exit 0 and
    its records (FLOPs, bytes, wire bytes, temp GiB, trace seconds) are
    printed.
    (b) The card check: Llama-3-8B at ``DECODE_LAYERS`` layers, decode_32k
    at global batch 8 (the 32,768-slot cache fits one card), as a dry run
    on a (1, 1) fake mesh and for real through ``serve_step`` on seeded
    weights drawn on the card: the dry run's argument and output bytes
    equal the real arguments' and outputs', its FLOPs equal
    ``FlopCounterMode`` over the real call, logits finite, and no process
    group is left; its temp bytes are printed beside the card's peak
    allocation beyond what was live before the call (not gated).
    (c) The SpeCa-step dry run (``python -m
    repro_torch.launch.dryrun_speca``), one process a record, in the same
    pool as (a): ``SPECA_DRYRUN_CASES`` (FLUX-like at a bfloat16 and a
    float32 table, batch 16 on pod16x16 and batch 32 with ``--multi-pod
    --tag pod2x16x16``; DiT-XL/2 at latent 32, batch 16, bfloat16), each
    must exit 0 and print both steps; FLUX-like ``--multi-pod`` at batch
    16 must exit non-zero naming the batch that does not divide the 32
    data shards, as the reference's layout does.
    (d) The card check of the SpeCa steps: FLUX-like at full width and
    depth, batch ``SPECA_CARD_BATCH``, latent 128, a bfloat16 table, m =
    2, as a dry run on a (1, 1) fake mesh and for real through the same
    ``full_step`` and ``spec_step`` on phase 3's tamed weights drawn on
    the card, the table filled by three real anchors first: argument
    bytes, output bytes and FLOPs (``FlopCounterMode`` over the card step)
    equal the dry run's, x and the error finite; each step's temp ratio
    (dry temp against the card's peak beyond what was live) and card wall
    are printed.
14. ``profiler``: every kernel count and device time above is read from
    torch.profiler windows; a window with no CUDA event, or with a count
    that is no multiple of the calls, is recorded again (up to 5
    windows), as is a pair of one-call windows of a 10c/10d forward whose
    counts differ, and at most one reading in 10 may have needed that.
    The times at the FLUX-like and HunyuanVideo-like tables are CUDA
    events, not profiler readings.

Each serving phase resets the launch counts just before its run and
reads them just after, and asserts the kernels of its own path. A kernel
row's ``decode`` entry holds its decode-shape numbers and its launches in
``serve_decode``; its ``flux`` entry its numbers at the FLUX-like table
and its launches in ``serve_flux``; its ``video`` entry its numbers at
the HunyuanVideo-like table and its launches in ``serve_video``; its
``serve_moe``, ``serve_ssm`` and ``serve_hybrid`` entries its numbers at
that family's shapes and its launches in that phase; its ``sharded``
entry, per routing that launches it, the routing's launches a call and
ms at D = 2 and 4 (``shard_kernels``), its launches in the first
``serve_sharded`` run of its path and in ``serve_decode_sharded``. Every width
comparison of phases 3–7 and 10c (lanes 4 against 1 or 2) holds accepts
and counters (FLOPs too) and records the samples' largest difference;
phase 3 and 10c hold the samples within 1e-5 as well.

The last two lines of standard output are one JSON object of per-kernel
numbers and ``{"ok": true, "device": {...}}``; the line before them is
the card's name and power limit. Everything measured also goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
TF32_TC_FLOPS = 494.7e12         # H100 SXM, dense TF32 tensor cores
LANES = 4
N_REQUESTS = 8
CHAIN_K = 4                       # the deep phases' max_draft_depth
DEEP_DEPTHS = (1, 2, 4, 4)        # draft_depth of request i: [i % 4]
BF16_TC_FLOPS = 989.4e12          # H100 SXM, dense bf16 tensor cores
# gemma3-27b's attention as the reference configures it
# (src/repro/configs/gemma3_27b.py: 32 query heads, 16 KV heads, head dim
# 128, a sliding window of 1024 on local layers, every 6th layer global);
# (the port configures Llama-3-8B, not gemma3)
GEMMA3_HEADS, GEMMA3_KV_HEADS, GEMMA3_HEAD_DIM = 32, 16, 128
GEMMA3_WINDOW = 1024
ATTN_SEQ = 4096
# the decode phases: Llama-3-8B lanes serving chat-sized requests
DECODE_NEW = 64                   # new tokens a decode request asks for
DECODE_SEQ = 192                  # max_seq_len of a decode lane's cache
DECODE_PROMPT = (16, 128)         # seeded prompt lengths, inclusive
# Llama-3-8B's depth in the decode phases (of 32): the whole run must end
# well inside its time limit, and the decode phases are host-bound
DECODE_LAYERS = 8
DECODE_FULL_LAYERS = 32           # Llama-3-8B's own depth: decode_kernels
                                  # also times the predicts on its table
L2_FLUSH_BYTES = 128 * 2**20      # written between timed calls: > 50 MB L2
# hymba-1.5b's depth in serve_hybrid (of 32; layer 16 stays global): the
# host-bound phase took 210–256 s at full depth, the longest of the run
HYBRID_LAYERS = 16
# decode_ring: mixtral-8x7b at full width, its depth cut to fit the card,
# 4,160 positions through its 4,096-slot ring (64 past the wrap)
RING_LAYERS, RING_SEQ = 4, 4160
# decode_audio: musicgen-medium, a prefill of 32 frames and 64 decode steps
AUDIO_PROMPT, AUDIO_NEW = 32, 64
# bf16 bounds on max |Δ logits| / max |logits|: the ring against the
# absolute-position cache (the same keys summed in another slot order)
# and the last decode step against lm_forward over the whole sequence
# (another attention path over the same keys)
RING_TOL = AUDIO_TOL = 2.0 ** -4
# decode_ring, layer 0: max |Δ| / max |attention| of the ring's attention
# of an f32 query against the absolute cache's over the same bf16 keys
# (the same sum in another slot order)
RING_ATTN_TOL = 1e-4
# the text- and video-conditioned DiTs (serve_flux, serve_video)
TEXT_TOKENS, TEXT_SCALE = 8, 0.1  # a request's text stub [1, 8, cond_dim]
FLUX_LATENT = 64                  # 512×512 through an 8× VAE: 1024 tokens
FLUX_GUIDANCE = 3.5
# 29 frames at 256×256 through a 4× temporal, 8× spatial VAE: 8 latent
# frames of 32×32, 2048 tokens
VIDEO_FRAMES, VIDEO_LATENT, VIDEO_LANES = 8, 32, 2
# train_dit: DiT-XL/2 f32 AdamW steps; train_lm: Qwen1.5-0.5B bf16 steps
# and their LR (the launcher's 3e-4 moves a 152k-vocabulary loss from its
# initial ~12.1 by ~0.01 in 20 steps, inside the batches' noise)
TRAIN_DIT_STEPS, TRAIN_LM_STEPS, TRAIN_LM_LR = 100, 20, 1e-3
# dryrun: one combination of each family and shape kind, on both
# production meshes (a long_500k arch runs as long_context_arch picks)
DRYRUN_CASES = (("llama3-8b", "train_4k"), ("llama3-8b", "prefill_32k"),
                ("llama3-8b", "decode_32k"), ("llama3-8b", "long_500k"),
                ("mixtral-8x7b", "decode_32k"),
                ("mamba2-130m", "long_500k"),
                ("gemma3-27b", "prefill_32k"), ("hymba-1.5b", "train_4k"))
DRYRUN_PROCS = 8                  # dry-run processes at a time (CPU only)
DRYRUN_CARD_BATCH = 8             # the card check's decode_32k batch
# dryrun (c): the SpeCa-step records, (arch, latent, batch, table dtype,
# multi-pod); a multi-pod record runs at batch 32 (16 does not divide
# its 32 data shards) and is tagged with its mesh
SPECA_DRYRUN_CASES = (("flux-like", 128, 16, "bfloat16", False),
                      ("flux-like", 128, 16, "float32", False),
                      ("flux-like", 128, 32, "bfloat16", True),
                      ("flux-like", 128, 32, "float32", True),
                      ("dit-xl2", 32, 16, "bfloat16", False))
SPECA_CARD_BATCH = 2              # dryrun (d): FLUX-like's batch on the card
# the __global__ functions of the serving kernels, as the profiler names
# them
DEVICE_NAMES = {"taylor_predict_lanes": "predict_lanes_kernel",
                "taylor_update_lanes": "update_lanes_kernel",
                "verify_accept": "verify_kernel",
                "taylor_predict_chain_lanes": "predict_chain_kernel",
                "lane_rollback": "rollback_kernel",
                "spectral_update_lanes": "ring_update_kernel"}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuobjdump_path() -> str:
    """The CUDA toolkit's cuobjdump, or the copy Triton ships."""
    found = shutil.which("cuobjdump", path="/usr/local/cuda/bin")
    if found:
        return found
    import triton
    return str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
               / "cuobjdump")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
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


# windows each profiler reading took (see _cuda_events); held by the
# ``profiler`` phase
PROFILE_WINDOWS = []


def _cuda_events(torch, fn, iters: int, attempts: int = 5):
    """The CUDA events torch.profiler records over ``iters`` calls of
    ``fn`` after one warm call. The profiler now and then loses some or
    all events of a window, whatever runs in it
    (``tools/profiler_windows.py``): a window with no CUDA event, or with
    a count that is no multiple of ``iters`` (every call launches the
    same kernels), is no reading, so it is recorded again, up to
    ``attempts`` windows. The windows taken go to ``PROFILE_WINDOWS``;
    a window recorded again is printed."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for used in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and len(events) % iters == 0:
            break
        print(f"profiler: window {used} of {attempts} recorded "
              f"{len(events)} CUDA events for {iters} calls", flush=True)
    PROFILE_WINDOWS.append(used)
    return events


def _traced_call(torch, fn, attempts: int = 5):
    """The CUDA events of one call of ``fn``: torch.profiler traces two
    windows of one call each, each after a warm-up cycle of its own (a
    window that opens cold loses some of its first kernels: a speculative
    forward counted 201 kernels in a cold window of one call, 264.5 a call
    in one of two). Every call launches the same kernels, so two windows
    with no CUDA event or with different counts are no reading, and the
    pair is traced again, up to ``attempts`` times, and none agreeing is
    a failure. The tries go to ``PROFILE_WINDOWS`` as ``_cuda_events``'
    do; the second window's events are returned."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for used in range(1, attempts + 1):
        windows = []

        def keep(prof):
            windows.append([e for e in prof.events() if e.device_type
                            == torch.autograd.DeviceType.CUDA])
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=2),
                     on_trace_ready=keep) as prof:
            for _ in range(4):
                fn()
                torch.cuda.synchronize()
                prof.step()
        counts = [len(w) for w in windows]
        if len(counts) == 2 and counts[0] and counts[0] == counts[1]:
            break
        print(f"profiler: traced pair {used} of {attempts} recorded "
              f"{counts} CUDA events for one call each", flush=True)
    else:
        raise AssertionError(f"no two windows of {attempts} pairs agreed")
    PROFILE_WINDOWS.append(used)
    return windows[-1]


def device_spans(torch, fn, iters: int = 1):
    """Device time per call of ``fn`` of each CUDA kernel it runs, in µs,
    by name: the summed spans from torch.profiler over ``iters`` calls
    after one warm call (no host cost between launches)."""
    spans = {}
    for e in _cuda_events(torch, fn, iters):
        spans[e.name] = spans.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / iters
    return spans


def device_ms(torch, fn, names, iters: int = 100):
    """Device time per call of ``fn``: the summed spans of the CUDA kernels
    whose names contain one of ``names``."""
    total_us = sum(us for name, us in device_spans(torch, fn, iters).items()
                   if any(n in name for n in names))
    assert total_us > 0, f"the profiler saw no kernel named {names}"
    return total_us / 1e3


def kernels_per_call(torch, fn, iters: int = 10) -> float:
    """CUDA kernels launched per call of ``fn``, from torch.profiler."""
    return len(_cuda_events(torch, fn, iters)) / iters


def bound_ms(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


class Smoke:
    """The phases; ``cfg``/``dcfg`` are the served model and schedule
    (DiT-XL/2 and the DiffusionConfig defaults in a chip run)."""

    def __init__(self, torch, device, cfg, dcfg, lm_cfg=None):
        self.torch = torch
        self.dev = torch.device(device)
        self.cfg, self.dcfg = cfg, dcfg
        self.lm_cfg = lm_cfg            # the decode phases' LM
        self.failures = []
        self.record = {}
        self.kernels = {}

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            status = "ok"
        except Exception:                      # report, go on, fail at end
            traceback.print_exc()
            self.failures.append(name)
            status = "FAILED"
        dt = time.perf_counter() - t0
        self.record.setdefault("phase_s", {})[name] = dt
        print(f"[{name}] {status} in {dt:.1f} s", flush=True)

    def profiler(self):
        """Every profiler reading of the run and the windows it took: a
        window recorded again must stay rare (at most one reading in 10),
        or the counts and device times above stand on a profiler that
        loses windows."""
        n, again = len(PROFILE_WINDOWS), sum(w > 1 for w in PROFILE_WINDOWS)
        print(f"profiler: {n} readings, {again} took a second window "
              f"(windows {sum(PROFILE_WINDOWS)})")
        self.record["profiler"] = dict(readings=n, readings_retried=again,
                                       windows=sum(PROFILE_WINDOWS))
        assert n and again <= n // 10, (n, again)

    # --- phase 1 -------------------------------------------------------------
    def build(self):
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        paths = build.build_all()
        self.record["build_s"] = time.perf_counter() - t0
        self.record["ptxas"] = dict(build.build_logs)
        for name, path in paths.items():
            print(f"built {name}: {path.relative_to(ROOT)}")
            for line in build.build_logs.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {line.strip()}")
        for name in build.SOURCES:
            build.library(name)
        # both flash kernels: wgmma (HGMMA; of TF32 type in the f32 one)
        # and TMA loads (UTMALDG) in their SASS, and no spills
        for name, op in (("flash_attention_sm90", "HGMMA"),
                         ("flash_attention", "HGMMA.*TF32")):
            sass = subprocess.run([cuobjdump_path(), "-sass",
                                   str(paths[name])], capture_output=True,
                                  text=True, timeout=120).stdout
            counts = {k: len(re.findall(k, sass))
                      for k in (op, "UTMALDG")}
            log = build.build_logs.get(name, "")
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
            print(f"{name} SASS: {counts}; spill bytes {sum(spills)}")
            self.record[name] = dict(sass=counts, spill_bytes=spills)
            assert all(counts.values()), (name, counts)
            assert log and not any(spills), f"{name} ptxas: no log, or spills"

    # --- phase 2 -------------------------------------------------------------
    def _inputs(self, shape, dtype, seed):
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        m1, W = shape[0], shape[3]
        diffs = torch.randn(shape, generator=g, device=self.dev).to(dtype)
        feats = torch.randn(shape[1:], generator=g,
                            device=self.dev).to(dtype)
        w = self._weights(m1, W)
        mask = torch.arange(W, device=self.dev) % 2 == 0     # mixed
        return diffs, feats, w, mask

    def _weights(self, m1, W, K=None):
        """Taylor weights [m+1, W] of lanes at different anchor counts
        (lane 1 cold: order 0 only; lane 3 at n_anchors=2 — invalid orders
        are 0.0), or [m+1, K, W] for the K positions of a chain."""
        torch = self.torch
        d = torch.tensor([1.0, 2.0, 3.0, 1.0][:W] + [2.0] * max(W - 4, 0),
                         device=self.dev)
        gap = torch.tensor([1.0, 1.0, 2.0, 3.0][:W] + [1.0] * max(W - 4, 0),
                           device=self.dev)
        n = torch.tensor([3, 1, 4, 2][:W] + [3] * max(W - 4, 0),
                         device=self.dev)
        if K is not None:
            d = d + torch.arange(K, device=self.dev)[:, None]
        from repro_torch.core.taylor import prediction_weights
        return prediction_weights(m1 - 1, d, gap, n).contiguous()

    def _rollback_indices(self, W):
        """int32 restore indices that together cover 0..CHAIN_K."""
        torch = self.torch
        return [torch.tensor([(a * lane + b) % (CHAIN_K + 1)
                              for lane in range(W)], dtype=torch.int32,
                             device=self.dev)
                for a, b in ((1, 0), (3, 4), (2, 1))]

    def check_kernels(self):
        torch = self.torch
        from repro_torch.kernels import ops, ref
        main = (3, 28, 2, LANES, 256, 1152)    # the DiT-XL/2 serving table
        shapes = [(main, torch.bfloat16), (main, torch.float32),
                  ((3, 2, 2, LANES, 17, 33), torch.bfloat16),   # C = 561
                  ((3, 2, 2, LANES, 10, 80), torch.bfloat16),   # C = 800
                  ((3, 2, 2, LANES, 17, 33), torch.float32)]
        checks = []
        for shape, dtype in shapes:
            diffs, feats, w, mask = self._inputs(shape, dtype, 1)
            pk = ops.taylor_predict_lanes(diffs, w)
            p32 = ref.taylor_predict_lanes_ref(diffs.float(), w)
            pp = ref.taylor_predict_lanes_ref(diffs, w)
            tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
            torch.testing.assert_close(pk.float(), p32, rtol=tol, atol=1e-6)
            uk = ops.taylor_update_lanes(diffs, feats, mask)
            up = ref.taylor_update_lanes_ref(diffs, feats, mask)
            assert torch.equal(uk, up), f"refresh not bitwise at {shape}"
            vl_pred, vl_real = self._verify_planes(shape, dtype)
            err_p, _ = ref.verify_accept_ref(vl_pred, vl_real,
                                             torch.ones(LANES,
                                                        device=self.dev))
            tau = (err_p * torch.tensor([2.0, 0.5, 1.0, 0.9],
                                        device=self.dev)).contiguous()
            ek, ak = ops.verify_accept(vl_pred, vl_real, tau)
            ep, ap = ref.verify_accept_ref(vl_pred, vl_real, tau)
            torch.testing.assert_close(ek, ep, rtol=1e-5, atol=0.0)
            far = (ep - tau).abs() > 1e-5
            assert torch.equal(ak[far], ap[far]), "accept bits differ"
            torch.cuda.synchronize()
            row = {"shape": list(shape), "dtype": str(dtype),
                   "predict_max_abs_err": (pk.float() - pp.float()).abs()
                   .max().item(),
                   "update_max_abs_err": (uk.float() - up.float()).abs()
                   .max().item(),
                   "verify_max_abs_err": (ek - ep).abs().max().item()}
            row.update(self._check_chain_kernels(shape, dtype))
            if shape != main:        # the serving table's: driven below
                row.update(self._check_scalar_kernels(shape, dtype))
            checks.append(row)
            print(f"kernels == plain at {shape} {dtype}: {row}")
        # the serving rollback: latent snapshots, lane axis first
        for dtype in (torch.float32, torch.bfloat16):
            x = self._latent_chain(dtype)
            snaps = [t.clone() for t in x]
            for idx in self._rollback_indices(LANES):
                want = ref.lane_rollback_ref(x, idx, lane_axis=0)
                assert torch.equal(ops.lane_rollback(x, idx, lane_axis=0),
                                   want), \
                    f"rollback not bitwise on latents {dtype}"
                assert torch.equal(ops.lane_rollback(snaps, idx,
                                                     lane_axis=0), want), \
                    f"snapshot rollback not bitwise on latents {dtype}"
        self.record["kernel_checks"] = checks
        # the mixed guided/unguided verify: the serving planes, and W = 5
        # (odd tail) with N not a multiple of the chunk (6149: element
        # order everywhere; 3000: N % 8 == 4, so a bf16 launch sums its
        # paired rows in 4-element groups and the others element-wise)
        mixed = []
        for W, N in ((LANES, main[4] * main[5]), (5, 6149), (5, 3000)):
            for dtype in (torch.bfloat16, torch.float32):
                mixed.append(self._check_mixed_verify(W, N, dtype))
        self.record["mixed_verify_checks"] = mixed
        self._time_main(main, torch.bfloat16)
        self._time_mixed_verify(main[4] * main[5], torch.bfloat16)
        self._time_chain_kernels(main, torch.bfloat16)
        self._drive_and_time_scalar(main, torch.bfloat16)
        for name, k in self.kernels.items():
            print(f"{name}: {k}")

    def _latent_chain(self, dtype):
        """CHAIN_K+1 latent snapshots [K+1, W, 32, 32, 4] of the serve."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(5)
        size, ch = self.dcfg.latent_size, self.cfg.in_channels
        return torch.randn((CHAIN_K + 1, LANES, size, size, ch),
                           generator=g, device=self.dev).to(dtype)

    def _check_chain_kernels(self, shape, dtype):
        """The chain predict (K = 1 and CHAIN_K), the rollback and the ring
        shift against their plain versions at one table shape, and each
        chain position against the depth-1 kernel; returns the max
        |kernel − plain| of each."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        diffs, feats, _, mask = self._inputs(shape, dtype, 3)
        m1, W = shape[0], shape[3]
        tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
        errs = {}
        for K in (1, CHAIN_K):
            w = self._weights(m1, W, K)
            ck = ops.taylor_predict_chain_lanes(diffs, w)
            c32 = ref.taylor_predict_chain_lanes_ref(diffs.float(), w)
            # one rounding to the table dtype (rtol) plus the f32 rounding
            # by which an FMA chain and a multiply-then-add differ, which
            # scales with Σ|w·x|: extrapolated chain weights reach ~8, so
            # near-zero sums of large terms differ by more than a fixed
            # atol (the depth-1 check above keeps its fixed atol 1e-6)
            terms = ref.taylor_predict_chain_lanes_ref(diffs.float().abs(),
                                                       w.abs())
            excess = ((ck.float() - c32).abs() - tol * c32.abs()
                      - 2.0 ** -21 * terms).max().item()
            assert excess <= 0.0, \
                f"chain K={K} off the plain sum by {excess} at {shape}"
            for k in range(K):
                pk = ops.taylor_predict_lanes(diffs, w[:, k].contiguous())
                assert torch.equal(ck[k], pk), \
                    f"chain position {k} of {K} != depth-1 kernel at {shape}"
            cp = ref.taylor_predict_chain_lanes_ref(diffs, w)
            errs[f"chain_k{K}_max_abs_err"] = (
                ck.float() - cp.float()).abs().max().item()
        g = torch.Generator(device=self.dev).manual_seed(4)
        chain = torch.randn((CHAIN_K + 1,) + tuple(shape[1:]), generator=g,
                            device=self.dev).to(dtype)
        for idx in self._rollback_indices(W):
            want = ref.lane_rollback_ref(chain, idx, lane_axis=2)
            assert torch.equal(ops.lane_rollback(chain, idx), want), \
                f"rollback not bitwise at {shape}"
            assert torch.equal(ops.lane_rollback(list(chain), idx), want), \
                f"snapshot rollback not bitwise at {shape}"
        for m in (torch.ones_like(mask), torch.zeros_like(mask), mask):
            assert torch.equal(ops.spectral_update_lanes(diffs, feats, m),
                               ref.spectral_update_lanes_ref(diffs, feats,
                                                             m)), \
                f"ring shift not bitwise at {shape} mask {m.tolist()}"
        errs["rollback_max_abs_err"] = errs["ring_max_abs_err"] = 0.0
        return errs

    def _verify_planes(self, shape, dtype):
        """pred/real verify planes [W, T·D] as the lane step forms them."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(7)
        W, N = shape[3], shape[4] * shape[5]
        real = torch.randn((W, N), generator=g, device=self.dev)
        scale = torch.tensor([0.05, 0.2, 0.5, 1.0], device=self.dev)[:, None]
        pred = real + scale * torch.randn((W, N), generator=g,
                                          device=self.dev)
        return pred.to(dtype).contiguous(), real.to(dtype).contiguous()

    def _planes(self, W, N, dtype, seed=7):
        """pred/real verify planes [W, N], each row off by its own
        scale."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        real = torch.randn((W, N), generator=g, device=self.dev)
        scale = torch.linspace(0.05, 1.0, W, device=self.dev)[:, None]
        pred = real + scale * torch.randn((W, N), generator=g,
                                          device=self.dev)
        return pred.to(dtype).contiguous(), real.to(dtype).contiguous()

    def _mixed_inputs(self, W):
        """The masks of the mixed check (all-False, all-True, the first
        pair only; at odd W the tail lane's flag is set and must be
        ignored) and the scales (1.5 and 4.0 by pair)."""
        torch = self.torch
        masks = {"none": [False] * W, "all": [True] * W,
                 "first_pair": [True, True] + [False] * (W - 2)}
        if W % 2:
            masks["first_pair"][-1] = True
        gs = torch.tensor([1.5, 1.5, 4.0, 4.0, 1.5][:W] + [1.5] * (W - 5),
                          device=self.dev)
        return {k: torch.tensor(v, device=self.dev)
                for k, v in masks.items()}, gs

    def _check_mixed_verify(self, W, N, dtype):
        """``ops.verify_accept_mixed`` against its plain version (rtol
        1e-5, equal accept bits wherever |e − τ| > 1e-5, τ per row
        straddling its error), one kernel a call, and its two pins
        bitwise: unpaired rows (the tail of an odd W too) are
        ``ops.verify_accept`` on the same planes, paired rows
        ``ops.verify_accept`` on the plain f32 planes."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        pred, real = self._planes(W, N, dtype)
        masks, gs = self._mixed_inputs(W)
        out = {"W": W, "N": N, "dtype": str(dtype)}
        for name, paired in masks.items():
            eff = paired & (torch.arange(W, device=self.dev)
                            < 2 * (W // 2))
            e0, _ = ref.verify_accept_mixed_ref(
                pred, real, torch.ones(W, device=self.dev), gs, paired)
            tau = (e0 * torch.tensor([2.0, 0.5, 1.0, 0.9, 1.1][:W],
                                     device=self.dev)).contiguous()
            em, am = ops.verify_accept_mixed(pred, real, tau, gs, paired)
            er, ar = ref.verify_accept_mixed_ref(pred, real, tau, gs,
                                                 paired)
            torch.testing.assert_close(em, er, rtol=1e-5, atol=0.0)
            far = (er - tau).abs() > 1e-5
            assert torch.equal(am[far], ar[far]), f"mixed accept {name}"
            ev, av = ops.verify_accept(pred, real, tau)
            assert torch.equal(em[~eff], ev[~eff]) and \
                torch.equal(am[~eff], av[~eff]), \
                f"mixed {name}: unpaired rows != verify_accept ({W}, {N})"
            p32, r32 = ref.mixed_planes_ref(pred, real, gs, paired)
            eb, ab = ops.verify_accept(p32, r32, tau)
            assert torch.equal(em[eff], eb[eff]) and \
                torch.equal(am[eff], ab[eff]), \
                f"mixed {name}: paired rows != verify_accept on the f32 " \
                f"planes ({W}, {N})"
            per_call = kernels_per_call(torch, lambda: ops.verify_accept_mixed(
                pred, real, tau, gs, paired))
            assert per_call == 1, f"verify_accept_mixed: {per_call} a call"
            out[f"{name}_max_abs_err"] = (em - er).abs().max().item()
        print(f"verify_accept_mixed == plain, pins bitwise: {out}")
        return out

    def _time_mixed_verify(self, N, dtype):
        """The mixed verify at the serving planes [4, N]: the kernel and
        the two-step it replaces (the plain planes, then
        ``ops.verify_accept``) in turns, by events and by device time,
        with each mask's device time beside; the first pair alone paired
        is the headline (a guided pair beside two unguided lanes)."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        W = LANES
        pred, real = self._planes(W, N, dtype, seed=9)
        masks, gs = self._mixed_inputs(W)
        tau = torch.full((W,), 0.3, device=self.dev)
        paired = masks["first_pair"]
        paths = {"kernel": lambda: ops.verify_accept_mixed(pred, real, tau,
                                                           gs, paired),
                 "two_step": lambda: ops.verify_accept(
                     *ref.mixed_planes_ref(pred, real, gs, paired), tau)}
        turns = {n: {"event_ms": [], "device_ms": [], "kernels_per_call": []}
                 for n in paths}
        for n in ("kernel", "two_step", "two_step", "kernel"):
            fn = paths[n]
            turns[n]["event_ms"].append(time_ms(torch, fn, iters=100))
            turns[n]["device_ms"].append(
                sum(device_spans(torch, fn, iters=100).values()) / 1e3)
            turns[n]["kernels_per_call"].append(kernels_per_call(torch, fn))
        assert turns["kernel"]["kernels_per_call"] == [1, 1], turns
        ek, _ = paths["kernel"]()
        ep, _ = ref.verify_accept_mixed_ref(pred, real, tau, gs, paired)
        by_mask = {name: device_ms(torch, lambda m=m: ops.verify_accept_mixed(
            pred, real, tau, gs, m), ("verify_kernel",))
            for name, m in masks.items()}
        plain = time_ms(torch, lambda: ref.verify_accept_mixed_ref(
            pred, real, tau, gs, paired), iters=100)
        es = pred.element_size()
        # both planes read once (a pair's rows once for the pair), τ,
        # gscale and paired read, err and accept written
        vb, vf = bound_ms(2 * W * N * es + W * (4 + 4 + 1 + 4 + 1),
                          7.0 * W * N)
        mean = {n: {k: sum(v) / len(v) for k, v in t.items()}
                for n, t in turns.items()}
        self.kernels["verify_accept_mixed"] = dict(
            ms=mean["kernel"]["event_ms"],
            device_ms=mean["kernel"]["device_ms"],
            kernels_per_call=mean["kernel"]["kernels_per_call"],
            two_step_ms=mean["two_step"]["event_ms"],
            two_step_device_ms=mean["two_step"]["device_ms"],
            two_step_kernels_per_call=mean["two_step"]["kernels_per_call"],
            device_ms_by_mask=by_mask, turns=turns, plain_ms=plain,
            library_ms=None, bound_ms=vb, bound_by=vf,
            max_abs_err=(ek - ep).abs().max().item())

    def _time_main(self, shape, dtype):
        torch = self.torch
        from repro_torch.kernels import ops, ref
        diffs, feats, w, mask = self._inputs(shape, dtype, 2)
        m1, W = shape[0], shape[3]
        R = shape[1] * shape[2] * W
        C = shape[4] * shape[5]
        es = diffs.element_size()
        d4 = diffs.view(m1, shape[1] * shape[2], W, C)
        wb = w.to(dtype)
        p_k = time_ms(torch, lambda: ops.taylor_predict_lanes(diffs, w))
        p_p = time_ms(torch, lambda: ref.taylor_predict_lanes_ref(diffs, w))
        p_l = time_ms(torch, lambda: torch.einsum("zw,zgwc->gwc", wb, d4))
        pk = ops.taylor_predict_lanes(diffs, w)
        pp = ref.taylor_predict_lanes_ref(diffs, w)
        pb, pf = bound_ms((m1 * R * C + R * C) * es + m1 * W * 4,
                          2.0 * m1 * R * C)
        self.kernels["taylor_predict_lanes"] = dict(
            ms=p_k, plain_ms=p_p, library_ms=p_l, bound_ms=pb, bound_by=pf,
            floor_ms=device_ms(torch, lambda: ops.predict_launch_floor(
                diffs, w), ("floor_kernel",)),
            max_abs_err=(pk.float() - pp.float()).abs().max().item())

        u_k = time_ms(torch, lambda: ops.taylor_update_lanes(diffs, feats,
                                                             mask))
        u_p = time_ms(torch, lambda: ref.taylor_update_lanes_ref(
            diffs, feats, mask))
        uk = ops.taylor_update_lanes(diffs, feats, mask)
        up = ref.taylor_update_lanes_ref(diffs, feats, mask)
        fresh = int(mask.sum().item()) * R // W      # refreshed rows
        kept = R - fresh
        # what this mask needs: kept rows read all m+1 old planes, fresh
        # rows read m old planes and their features; all planes written
        ub, uf = bound_ms((kept * m1 * C + fresh * (m1 - 1) * C
                           + fresh * C + m1 * R * C) * es + W,
                          float((m1 - 1) * fresh * C))
        self.kernels["taylor_update_lanes"] = dict(
            ms=u_k, plain_ms=u_p, library_ms=None, bound_ms=ub, bound_by=uf,
            max_abs_err=(uk.float() - up.float()).abs().max().item())

        pred, real = self._verify_planes(shape, dtype)
        tau = torch.full((W,), 0.3, device=self.dev)
        N = pred.shape[1]
        v_k = time_ms(torch, lambda: ops.verify_accept(pred, real, tau),
                      iters=100)
        v_p = time_ms(torch, lambda: ref.verify_accept_ref(pred, real, tau),
                      iters=100)
        ek, _ = ops.verify_accept(pred, real, tau)
        ep, _ = ref.verify_accept_ref(pred, real, tau)
        vb, vf = bound_ms(2 * W * N * es + W * (4 + 4 + 1), 5.0 * W * N)
        def call():
            return ops.verify_accept(pred, real, tau)
        v_d = device_ms(torch, call, ("verify_kernel",))
        per_call = kernels_per_call(torch, call)
        assert per_call == 1, f"verify_accept: {per_call} kernels a call"
        self.kernels["verify_accept"] = dict(
            ms=v_k, device_ms=v_d, kernels_per_call=per_call, plain_ms=v_p,
            library_ms=None,
            bound_ms=vb, bound_by=vf,
            max_abs_err=(ek - ep).abs().max().item())

    def _time_chain_kernels(self, shape, dtype):
        """Times of the chain predict (K = CHAIN_K), the rollback (on the
        serve's latent snapshots) and the ring shift at the serving
        shapes, beside their plain versions, library calls and bounds."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        diffs, feats, _, mask = self._inputs(shape, dtype, 2)
        m1, W, K = shape[0], shape[3], CHAIN_K
        G = shape[1] * shape[2]
        R, C = G * W, shape[4] * shape[5]
        es = diffs.element_size()
        w = self._weights(m1, W, K)
        c_k = time_ms(torch, lambda: ops.taylor_predict_chain_lanes(diffs, w))
        c_p = time_ms(torch, lambda: ref.taylor_predict_chain_lanes_ref(
            diffs, w))
        wb, d4 = w.to(dtype), diffs.view(m1, G, W, C)
        c_l = time_ms(torch, lambda: torch.einsum("zkb,zgbc->kgbc", wb, d4))
        cols = [w[:, k].contiguous() for k in range(K)]
        c_1 = time_ms(torch, lambda: [ops.taylor_predict_lanes(diffs, c)
                                      for c in cols])
        ck = ops.taylor_predict_chain_lanes(diffs, w)
        cp = ref.taylor_predict_chain_lanes_ref(diffs, w)
        cb, cf = bound_ms((m1 + K) * R * C * es + m1 * K * W * 4,
                          2.0 * m1 * K * R * C)
        self.kernels["taylor_predict_chain_lanes"] = dict(
            ms=c_k, plain_ms=c_p, library_ms=c_l, bound_ms=cb, bound_by=cf,
            floor_ms=device_ms(torch, lambda: ops.predict_launch_floor(
                diffs, w), ("floor_kernel",)),
            depth1_x_k_ms=c_1, k=K,
            max_abs_err=(ck.float() - cp.float()).abs().max().item())

        x = self._latent_chain(torch.float32)
        snaps = [t.clone() for t in x]       # one allocation each, as served
        idx = self._rollback_indices(W)[1]
        xs = tuple(x.shape[1:])
        take = idx.long().reshape((1, W) + (1,) * (len(xs) - 1)) \
            .expand((1,) + xs)
        # the chain step's old restore (stack, then the stacked entry) and
        # the new one (the snapshot entry), in turns
        paths = {"old": lambda: ops.lane_rollback(torch.stack(snaps), idx,
                                                  lane_axis=0),
                 "new": lambda: ops.lane_rollback(snaps, idx, lane_axis=0)}
        turns = {n: {"event_ms": [], "device_ms": [], "kernels_per_call": []}
                 for n in paths}
        for n in ("old", "new", "new", "old"):
            fn = paths[n]
            turns[n]["event_ms"].append(time_ms(torch, fn, iters=100))
            turns[n]["device_ms"].append(
                sum(device_spans(torch, fn, iters=100).values()) / 1e3)
            turns[n]["kernels_per_call"].append(kernels_per_call(torch, fn))
        assert turns["new"]["kernels_per_call"] == [1, 1], turns
        r_p = time_ms(torch, lambda: ref.lane_rollback_ref(snaps, idx,
                                                           lane_axis=0),
                      iters=100)
        r_l = time_ms(torch, lambda: torch.take_along_dim(x, take, dim=0),
                      iters=100)
        rk = ops.lane_rollback(snaps, idx, lane_axis=0)
        rp = ref.lane_rollback_ref(snaps, idx, lane_axis=0)
        assert torch.equal(paths["old"](), rk), "old and new restore differ"
        # one selected row read and one row written per lane, and idx
        rb, rf = bound_ms(2 * x[0].numel() * x.element_size() + W * 4, 0.0)
        mean = {n: {k: sum(v) / len(v) for k, v in t.items()}
                for n, t in turns.items()}
        self.kernels["lane_rollback"] = dict(
            ms=mean["new"]["device_ms"], event_ms=mean["new"]["event_ms"],
            old_path_ms=mean["old"]["device_ms"],
            old_path_event_ms=mean["old"]["event_ms"],
            kernels_per_call=mean["new"]["kernels_per_call"],
            old_path_kernels_per_call=mean["old"]["kernels_per_call"],
            turns=turns, plain_ms=r_p, library_ms=r_l, bound_ms=rb,
            bound_by=rf, max_abs_err=(rk - rp).abs().max().item())

        s_k = time_ms(torch, lambda: ops.spectral_update_lanes(diffs, feats,
                                                               mask))
        s_p = time_ms(torch, lambda: ref.spectral_update_lanes_ref(
            diffs, feats, mask))
        sk = ops.spectral_update_lanes(diffs, feats, mask)
        sp = ref.spectral_update_lanes_ref(diffs, feats, mask)
        fresh = int(mask.sum().item()) * R // W
        kept = R - fresh
        # kept rows read m+1 old planes; fresh rows read their features
        # and old planes 0..m-1 (old plane m drops); all planes written
        sb, sf = bound_ms((kept * m1 * C + fresh * m1 * C + m1 * R * C)
                          * es + W, 0.0)
        self.kernels["spectral_update_lanes"] = dict(
            ms=s_k, plain_ms=s_p, library_ms=None, bound_ms=sb, bound_by=sf,
            max_abs_err=(sk.float() - sp.float()).abs().max().item())

    def _scalar_weights(self, m1):
        """Whole-batch weights [m+1] f32, seeded, distinct and not powers of
        two, so that a swapped plane or weight and an inexact product show."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(12)
        return torch.rand(m1, generator=g, device=self.dev) * 3.0 - 1.0

    def _scalar_surface(self, shape, dtype, seed):
        """Inputs of the scalar-anchor surface: a table as one whole-batch
        anchor, its features, weights and verify planes."""
        diffs, feats, _, _ = self._inputs(shape, dtype, seed)
        return (diffs, feats, self._scalar_weights(shape[0]),
                *self._verify_planes(shape, dtype))

    def _hold_scalar(self, shape, diffs, feats, w, pred, real, pk, uk, sk,
                     ek):
        """Hold the scalar-anchor predict and refresh over the whole table
        and the τ-less verify sums and error (``pk``, ``uk``, ``sk``,
        ``ek``) against their plain versions; the predict also bitwise the
        lane kernel with the weights broadcast. Returns the max
        |kernel − plain| of each."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        m1, W = shape[0], shape[3]
        p32 = ref.taylor_predict_ref(diffs.float(), w)
        # one rounding to the table dtype (rtol) plus the f32 rounding by
        # which an FMA chain and a multiply-then-add differ (as the chain)
        tol = 2.0 ** -8 if diffs.dtype == torch.bfloat16 else 1e-6
        terms = ref.taylor_predict_ref(diffs.float().abs(), w.abs())
        excess = ((pk.float() - p32).abs() - tol * p32.abs()
                  - 2.0 ** -21 * terms).max().item()
        assert excess <= 0.0, f"scalar predict off by {excess} at {shape}"
        lanes = ops.taylor_predict_lanes(diffs,
                                         w[:, None].expand(m1, W).contiguous())
        assert torch.equal(pk, lanes), \
            f"scalar predict != lane kernel with broadcast weights at {shape}"
        up = ref.taylor_update_ref(diffs, feats)
        assert torch.equal(uk, up), f"scalar refresh not bitwise at {shape}"
        f32 = feats.float()                   # f32 features into the table
        assert torch.equal(ops.taylor_update(diffs, f32),
                           ref.taylor_update_ref(diffs, f32)), \
            f"scalar refresh not bitwise at {shape}, f32 features"
        sp, ep = ref.verify_sums_ref(pred, real), ref.verify_error_ref(pred,
                                                                       real)
        torch.testing.assert_close(sk, sp, rtol=1e-5, atol=0.0)
        torch.testing.assert_close(ek, ep, rtol=1e-5, atol=0.0)
        pp = ref.taylor_predict_ref(diffs, w)
        return {"scalar_predict_max_abs_err":
                (pk.float() - pp.float()).abs().max().item(),
                "scalar_update_max_abs_err":
                (uk.float() - up.float()).abs().max().item(),
                "verify_sums_max_abs_err": (sk - sp).abs().max().item(),
                "verify_sums_max_rel_err":
                ((sk - sp).abs() / sp.abs()).max().item(),
                "verify_error_max_abs_err": (ek - ep).abs().max().item()}

    def _check_scalar_kernels(self, shape, dtype):
        """The scalar-anchor surface at a shape other than the serving
        table's (which ``_drive_and_time_scalar`` holds)."""
        from repro_torch.kernels import ops
        diffs, feats, w, pred, real = self._scalar_surface(shape, dtype, 6)
        return self._hold_scalar(
            shape, diffs, feats, w, pred, real, ops.taylor_predict(diffs, w),
            ops.taylor_update(diffs, feats), ops.verify_sums(pred, real),
            ops.verify_error(pred, real))

    def _drive_and_time_scalar(self, shape, dtype):
        """The reference's public scalar-anchor surface at the serving
        table's width: driven once with the launch counts set to 0 just
        before and read just after, its outputs held against their plain
        versions, then each kernel timed beside its plain version, a
        library call where one computes the same function, and its bound."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        diffs, feats, w, pred, real = self._scalar_surface(shape, dtype, 8)
        m1, es = shape[0], diffs.element_size()
        n = feats.numel()
        torch.cuda.synchronize()
        ops.reset_launch_counts()                    # this slice's path:
        pk = ops.taylor_predict(diffs, w)
        uk = ops.taylor_update(diffs, feats)
        sk = ops.verify_sums(pred, real)
        ek = ops.verify_error(pred, real)
        torch.cuda.synchronize()
        launches = ops.launch_counts()               # read just after
        print(f"scalar surface launches: {launches}")
        assert all(launches[k] == 1 for k in SCALAR_KEYS), launches
        assert torch.isfinite(pk).all() and torch.isfinite(uk).all()
        assert torch.isfinite(sk).all() and torch.isfinite(ek).all()
        errs = self._hold_scalar(shape, diffs, feats, w, pred, real, pk, uk,
                                 sk, ek)
        print(f"scalar surface == plain at {shape} {dtype}: {errs}")

        d32 = diffs.float()
        p_k = time_ms(torch, lambda: ops.taylor_predict(diffs, w))
        p_p = time_ms(torch, lambda: ref.taylor_predict_ref(diffs, w))
        p_l = time_ms(torch, lambda: torch.tensordot(w, d32, dims=1))
        pb, pf = bound_ms((m1 + 1) * n * es + m1 * 4, 2.0 * m1 * n)
        self.kernels["taylor_predict"] = dict(
            ms=p_k, plain_ms=p_p, library_ms=p_l, bound_ms=pb, bound_by=pf,
            launches=launches["taylor_predict"],
            max_abs_err=errs["scalar_predict_max_abs_err"])

        u_k = time_ms(torch, lambda: ops.taylor_update(diffs, feats))
        u_p = time_ms(torch, lambda: ref.taylor_update_ref(diffs, feats))
        # old planes 0..m-1 and the features read, m+1 planes written
        ub, uf = bound_ms(((m1 - 1) * n + n + m1 * n) * es,
                          float((m1 - 1) * n))
        self.kernels["taylor_update"] = dict(
            ms=u_k, plain_ms=u_p, library_ms=None, bound_ms=ub, bound_by=uf,
            launches=launches["taylor_update"],
            max_abs_err=errs["scalar_update_max_abs_err"])

        W, N = pred.shape
        v_k = time_ms(torch, lambda: ops.verify_sums(pred, real), iters=100)
        v_p = time_ms(torch, lambda: ref.verify_sums_ref(pred, real),
                      iters=100)
        v_d = device_ms(torch, lambda: ops.verify_sums(pred, real),
                        ("verify_kernel",))
        vb, vf = bound_ms(2 * W * N * es + W * 8, 5.0 * W * N)
        self.kernels["verify_sums"] = dict(
            ms=v_k, device_ms=v_d, plain_ms=v_p, library_ms=None,
            bound_ms=vb, bound_by=vf, launches=launches["verify_sums"],
            max_abs_err=errs["verify_sums_max_abs_err"])

        # the error in one kernel: bitwise the fused verify's err and the
        # two-step finish over the sums (the sums kernel and four torch
        # kernels), which is timed beside it
        def error():
            return ops.verify_error(pred, real)

        def two_step():
            s_ = ops.verify_sums(pred, real)
            return torch.sqrt(s_[:, 0]) / (torch.sqrt(s_[:, 1]) + 1e-8)
        tau = torch.full((W,), 0.3, device=self.dev)
        assert torch.equal(ek, ops.verify_accept(pred, real, tau)[0]), \
            "verify_error != verify_accept's err"
        assert torch.equal(ek, two_step()), "verify_error != two-step finish"
        per_call = kernels_per_call(torch, error)
        assert per_call == 1, f"verify_error: {per_call} kernels a call"
        e_k = time_ms(torch, error, iters=100)
        e_d = device_ms(torch, error, ("verify_kernel",))
        e_p = time_ms(torch, lambda: ref.verify_error_ref(pred, real),
                      iters=100)
        t_k = time_ms(torch, two_step, iters=100)
        t_d = sum(device_spans(torch, two_step, iters=100).values()) / 1e3
        eb, ef = bound_ms(2 * W * N * es + W * 4, 5.0 * W * N)
        self.kernels["verify_error"] = dict(
            ms=e_k, device_ms=e_d, kernels_per_call=per_call, plain_ms=e_p,
            library_ms=None, bound_ms=eb, bound_by=ef,
            launches=launches["verify_error"],
            max_abs_err=errs["verify_error_max_abs_err"],
            two_step_ms=t_k, two_step_device_ms=t_d,
            two_step_kernels_per_call=kernels_per_call(torch, two_step))

    # --- phase 2b ------------------------------------------------------------
    def attention(self):
        """Flash attention through this slice's entry points at gemma3-27b's
        and DiT-XL/2's widths: bf16 through the bf16 tensor-core kernel;
        the same values in f32, and inputs drawn in f32 (full mantissas,
        which TF32 does not hold), through the 3×TF32 kernel; each against
        the plain f32 attention, the bf16 one also against the port's
        non-flash paths, and each timed beside SDPA."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        from repro_torch.layers.attention import (attention_core,
                                                  full_attention, repeat_kv)
        bf16 = torch.bfloat16
        g = torch.Generator(device=self.dev).manual_seed(11)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=self.dev)
        S, H, KV, hd = ATTN_SEQ, GEMMA3_HEADS, GEMMA3_KV_HEADS, \
            GEMMA3_HEAD_DIM
        cfg = self.cfg
        dH, dhd = cfg.num_heads, cfg.d_model // cfg.num_heads
        dS = (self.dcfg.latent_size // cfg.patch_size) ** 2
        shapes = [(1, S, H, hd), (1, S, KV, hd), (1, S, KV, hd)] + \
            [(LANES, dS, dH, dhd)] * 3
        inputs = {"bf16": [randn(*sh).to(bf16) for sh in shapes]}
        inputs["f32"] = [x.float() for x in inputs["bf16"]]
        inputs["f32_full"] = [randn(*sh) for sh in shapes]

        def drive(a, b, c, e, f, h):
            return {"gemma3_local": full_attention(a, b, c, GEMMA3_WINDOW,
                                                   use_flash=True),
                    "gemma3_global": full_attention(a, b, c, 0,
                                                    use_flash=True),
                    "dit_xl2": ops.flash_attention(e, f, h, causal=False)}
        torch.cuda.synchronize()
        ops.reset_launch_counts()                    # this slice's path:
        outs = {route: drive(*xs) for route, xs in inputs.items()}
        torch.cuda.synchronize()
        launches = ops.launch_counts()               # read just after
        print(f"attention launches: {launches}")
        assert launches["flash_attention_sm90"] == 3, launches
        assert launches["flash_attention"] == 6, launches

        detail = {route: {} for route in inputs}
        for route, (q, k, v, qd, kd, vd) in inputs.items():
            kr, vr = repeat_kv(k, H // KV), repeat_kv(v, H // KV)
            cases = {"gemma3_local": (q, kr, vr, True, GEMMA3_WINDOW,
                                      lambda: full_attention(q, k, v,
                                                             GEMMA3_WINDOW)),
                     "gemma3_global": (q, kr, vr, True, 0,
                                       lambda: full_attention(q, k, v, 0)),
                     "dit_xl2": (qd, kd, vd, False, 0,
                                 lambda: attention_core(qd, kd, vd))}
            for name, (a, b, c, causal, window, other) in cases.items():
                kw = dict(causal=causal, window=window)
                out = outs[route][name]
                assert out.shape == a.shape and out.dtype == a.dtype
                assert torch.isfinite(out).all(), f"{name}: non-finite"
                plain = ref.flash_attention_ref(a.float(), b.float(),
                                                c.float(), **kw)
                err = (out.float() - plain).abs().max().item()
                if route == "bf16":
                    torch.testing.assert_close(out.float(), plain,
                                               rtol=2.0 ** -8, atol=1e-5)
                    # the port's own non-flash path (mask bias or SDPA
                    # core in f32, rounded to bf16 on its own): within one
                    # bf16 ulp
                    torch.testing.assert_close(out.float(),
                                               other().float(),
                                               rtol=2.0 ** -7, atol=1e-5)
                else:
                    torch.testing.assert_close(out, plain, rtol=2e-5,
                                               atol=2e-5)
                del plain
                detail[route][name] = self._time_attention(a, b, c, causal,
                                                           window)
                detail[route][name]["max_abs_err"] = err
                print(f"flash_attention {route} {name}: "
                      f"{detail[route][name]}")
        # each row: its headline case (gemma3 global, the first route)
        for key, routes in (("flash_attention_sm90", ("bf16",)),
                            ("flash_attention", ("f32_full", "f32"))):
            head = detail[routes[0]]["gemma3_global"]
            self.kernels[key] = dict(
                ms=head["ms"], plain_ms=head["plain_ms"],
                library_ms=head["library_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], launches=launches[key],
                device_ms=head["device_ms"],
                library_device_ms=head["library_device_ms"],
                max_abs_err=max(c["max_abs_err"] for r in routes
                                for c in detail[r].values()),
                cases={r: detail[r] for r in routes})
            if "bound_f32_cuda_core_ms" in head:
                self.kernels[key]["bound_f32_cuda_core_ms"] = \
                    head["bound_f32_cuda_core_ms"]
        self.record["attention"] = dict(launches=launches, cases=detail)

    def _time_attention(self, q, k, v, causal, window):
        """Kernel, plain and SDPA times of one attention case (equal head
        counts), and its bound from the visible pairs: bf16 operands over
        the dense bf16 tensor cores at 4·hd operations a pair (q·kᵀ of bf16
        values is exact in their f32 accumulator), f32 operands over the
        dense TF32 tensor cores at 12·hd (three TF32 products for each f32
        product), with the f32 CUDA cores' 4·hd over 67 TFLOP/s beside."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ops, ref
        B, S, H, hd = q.shape
        kw = dict(causal=causal, window=window)
        ms = time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                     iters=10, warmup=2)
        plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, **kw), iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if causal and window == 0:
            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
        elif causal or window:
            mask = ref.attention_mask(S, S, causal, window, q.device)

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        else:
            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt)
        library_ms = time_ms(torch, lib, iters=10, warmup=2)
        pairs = int(ref.attention_mask(S, S, causal, window, q.device)
                    .sum().item())
        flops = 4.0 * hd * pairs * B * H       # q·k and p·v per visible pair
        nbytes = 4 * B * S * H * hd * q.element_size()
        if q.dtype == torch.bfloat16:
            bound, by = bound_ms(nbytes, flops, BF16_TC_FLOPS)
            extra = {}
        else:
            bound, by = bound_ms(nbytes, 3 * flops, TF32_TC_FLOPS)
            extra = dict(bound_f32_cuda_core_ms=bound_ms(nbytes, flops)[0])
        # device time per call (the events above include the host's cost
        # of a call, which is of the order of the DiT-XL/2 case's kernel)
        spans = device_spans(torch, lib, iters=5)
        mine = device_spans(
            torch, lambda: ops.flash_attention(q, k, v, **kw), iters=5)
        return dict(shape=list(q.shape), dtype=str(q.dtype), causal=causal,
                    window=window, pairs_per_head=pairs, gflop=flops / 1e9,
                    ms=ms, device_ms=sum(mine.values()) / 1e3,
                    plain_ms=plain_ms, library_ms=library_ms,
                    library_device_ms=sum(spans.values()) / 1e3,
                    sdpa_kernel=max(spans, key=spans.get,
                                    default="not seen")[:120],
                    bound_ms=bound, bound_by=by, **extra)

    # --- phase 3 -------------------------------------------------------------
    def _model(self):
        return self._tamed_params(self.cfg, self.dcfg)

    def _tamed_params(self, cfg, dcfg):
        """Random parameters of ``cfg`` drawn on the card from seed 0, tamed
        so that drafts can be accepted (see the docstring); a continuous
        conditioning projection keeps the reference's N(0, 1/cond_dim)."""
        torch = self.torch
        from repro_torch.layers.model import init_params
        gen = torch.Generator(device=self.dev).manual_seed(0)
        params = init_params(cfg, gen, device=self.dev)
        d = cfg.d_model
        noise = torch.Generator(device=self.dev).manual_seed(1)

        def fill(t, scale):
            t.copy_(torch.randn(t.shape, generator=noise, device=self.dev)
                    * scale)
        # AdaLN-Zero leaves from small seeded noise (see the docstring)
        fill(params["blocks"]["mod_w"], 0.4 / math.sqrt(d))
        fill(params["blocks"]["mod_b"], 0.02)
        fill(params["head"]["mod_w"], 0.4 / math.sqrt(d))
        fill(params["head"]["mod_b"], 0.02)
        fill(params["head"]["w"], 1.0 / math.sqrt(d))
        fill(params["head"]["b"], 0.02)
        # Random weights on the fast sinusoids of the timestep embedding
        # make t_emb — and every AdaLN modulation — jump at random from one
        # sampler step to the next, which no trained DiT does and which
        # rejects every draft. Keep only the sinusoids that turn at most
        # 0.2 rad per sampler step (DDIM and rectified flow alike: the
        # model's t moves num_train_timesteps / steps a step).
        half = d // 2
        freq = torch.exp(-math.log(10_000.0)
                         * torch.arange(half, device=self.dev) / half)
        dt = dcfg.num_train_timesteps / dcfg.num_inference_steps
        keep = (dt * freq <= 0.2).to(torch.float32)
        params["embed"]["time"]["w1"] *= torch.cat([keep, keep])[:, None]
        return params

    def serve(self):
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.diffusion.pipeline import latent_shape
        from repro_torch.kernels import ops
        from repro_torch.serving import Request, SpeCaEngine
        cfg, dcfg = self.cfg, self.dcfg
        self.params = params = self._model()
        scfg = SpeCaConfig(taylor_order=2)
        S = dcfg.num_inference_steps
        engine = SpeCaEngine(cfg, params, dcfg, scfg,
                             accept_mode="per_sample",
                             verify_backend="fused", device=self.dev)
        reqs = [Request(request_id=i,
                        cond={"labels": torch.tensor([(37 * i)
                                                      % cfg.num_classes])},
                        seed=100 + i) for i in range(N_REQUESTS)]
        # warm the allocator, cuBLAS and the kernels outside the timed run
        engine.serve_batched(reqs[:LANES], lanes=LANES, max_ticks=5)
        torch.cuda.synchronize()
        syncs0 = engine.host_syncs
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()                       # the main path:
        t0 = time.perf_counter()
        res = engine.serve_batched(reqs, lanes=LANES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()                  # read just after
        syncs = engine.host_syncs - syncs0
        ticks = max(r.finish_tick for r in res)
        for name in SERVE_KERNELS:
            self.kernels.setdefault(name, {})["launches"] = launches[name]
        samples = torch.cat([r.sample for r in res])
        print(f"main path launches: {launches}")
        per_req = [{"request_id": r.request_id, "num_full": r.num_full,
                    "num_spec": r.num_spec, "alpha": r.alpha,
                    "accepts": "".join("1" if a else "0"
                                       for a in r.accepts)}
                   for r in res]
        for row in per_req:
            print(f"  request {row}")
        print(f"served {N_REQUESTS} requests at lanes={LANES} in "
              f"{wall:.3f} s: {N_REQUESTS / wall:.3f} req/s, "
              f"{syncs} host syncs over {ticks} ticks, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        assert all(launches[n] > 0 for n in SERVE_KERNELS), launches
        assert tuple(samples.shape) == latent_shape(cfg, dcfg, N_REQUESTS)
        assert torch.isfinite(samples).all(), "non-finite samples"
        assert all(r.completed and r.num_full + r.num_spec == S
                   for r in res)
        try:
            width = self._hold_width(
                "serve", res[:LANES],
                engine.serve_batched(reqs[:LANES], lanes=1), (LANES, 1),
                sample_tol=1e-5)
        except AssertionError:
            self._width_probe(params)       # name the op, then fail
            raise
        self.serve_results = res
        self.record["serve"] = dict(
            width=width,
            requests=per_req, wall_s=wall, req_per_s=N_REQUESTS / wall,
            host_syncs=syncs, ticks=ticks, launches=launches,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            sample_abs_max=samples.abs().max().item())

    def _width_probe(self, params):
        """W1 (ROADMAP Queue 3), run when ``serve``'s lanes-4-against-1
        gate fails: ``tools/width_probe.py`` on DiT-XL/2's forward of LANES
        seeded latents at once and of each alone names the first op whose
        output differs, its row count M at each width and max |Δ| (its
        own, re-run on the batched run's inputs); recorded and printed."""
        from tools.width_probe import dit_case, probe
        rec = probe(dit_case(self.dev, params))
        print(f"W1 probe: {json.dumps(rec)}", flush=True)
        self.record["w1_probe"] = rec

    def _requests(self, n, policy_of=lambda i: None):
        torch = self.torch
        from repro_torch.serving import Request
        return [Request(request_id=i,
                        cond={"labels": torch.tensor(
                            [(37 * i) % self.cfg.num_classes])},
                        seed=100 + i, policy=policy_of(i)) for i in range(n)]

    def _timed_serve(self, engine, reqs, lanes):
        """Serve ``reqs`` with the launch counts set to 0 just before and
        read just after; returns (results, launches, wall s, host syncs,
        peak GiB)."""
        torch = self.torch
        from repro_torch.kernels import ops
        torch.cuda.synchronize()
        syncs0 = engine.host_syncs
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = engine.serve_batched(reqs, lanes=lanes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        return (res, launches, wall, engine.host_syncs - syncs0,
                torch.cuda.max_memory_allocated() / 2**30)

    @contextlib.contextmanager
    def _chain_ticks(self):
        """Record each chain tick run inside: the rollback launches it
        made (the host-side count, no sync), its ``n_drafted`` and
        ``n_spec`` flags and the ``paired`` mask it ran with (device
        tensors, read after the run)."""
        from repro_torch.core import lane_step as LS
        from repro_torch.kernels import ops
        ticks = []
        call = LS.ChainStep.__call__

        def probe(step, state):
            before = ops.LAUNCHES["lane_rollback"]
            paired = state["paired"].clone() if "paired" in state else None
            new, flags = call(step, state)
            ticks.append((ops.LAUNCHES["lane_rollback"] - before,
                          flags["n_drafted"], flags["n_spec"], paired))
            return new, flags
        LS.ChainStep.__call__ = probe
        try:
            yield ticks
        finally:
            LS.ChainStep.__call__ = call

    def _hold_chain_ticks(self, name, ticks, launches):
        """A chain tick launches the rollback once when some lane drafted
        (one payload leaf, read from its snapshots: no stack) and not at
        all when none did; returns the counts to record, with the ticks
        on which some lane (some paired lane) had a drafted position
        rejected, so that the rollback restored a snapshot before it."""
        per_tick = [n for n, *_ in ticks]
        drafted = [int(d.sum().item()) > 0 for _, d, _, _ in ticks]
        idle = drafted.count(False)
        rejected = [d > a for _, d, a, _ in ticks]
        n_rejected = sum(bool(r.any().item()) for r in rejected)
        n_rejected_paired = sum(bool((r & p).any().item())
                                for r, (*_, p) in zip(rejected, ticks)
                                if p is not None)
        print(f"{name}: {len(ticks)} chain ticks, {idle} drafted nothing, "
              f"{n_rejected} rejected a drafted position ({n_rejected_paired}"
              f" in a guided pair); rollback launches "
              f"{launches['lane_rollback']} (per tick at most "
              f"{max(per_tick, default=0)})")
        assert all(n == int(d) for n, d in zip(per_tick, drafted)), \
            "a chain tick's rollback launches != (some lane drafted)"
        assert launches["lane_rollback"] == sum(per_tick) == \
            len(ticks) - idle, (launches, len(ticks), idle)
        return dict(chain_ticks=len(ticks), ticks_drafted_nothing=idle,
                    ticks_rejected=n_rejected,
                    ticks_rejected_paired=n_rejected_paired,
                    rollback_launches=launches["lane_rollback"])

    # --- phase 4 -------------------------------------------------------------
    def serve_deep(self):
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.serving import RequestPolicy, SpeCaEngine
        engine = SpeCaEngine(self.cfg, self.params, self.dcfg,
                             SpeCaConfig(taylor_order=2),
                             max_draft_depth=CHAIN_K, device=self.dev)
        reqs = self._requests(N_REQUESTS, lambda i: RequestPolicy(
            draft_depth=DEEP_DEPTHS[i % len(DEEP_DEPTHS)]))
        engine.serve_batched(reqs[:LANES], lanes=LANES, max_ticks=5)
        with self._chain_ticks() as chain_ticks:
            res, launches, wall, syncs, peak = self._timed_serve(
                engine, reqs, LANES)
        ticks = max(r.finish_tick for r in res)
        rollback = self._hold_chain_ticks("serve_deep", chain_ticks,
                                          launches)
        for name in DEEP_KERNELS:
            # a kernel's row keeps the count of the first path that runs it
            self.kernels.setdefault(name, {}).setdefault("launches",
                                                         launches[name])
        base = self.serve_results
        dmax = max((a.sample - b.sample).abs().max().item()
                   for a, b in zip(base, res))
        print(f"deep main path launches: {launches}")
        for r in res:
            print(f"  request {r.request_id}: depth "
                  f"{DEEP_DEPTHS[r.request_id % len(DEEP_DEPTHS)]} full "
                  f"{r.num_full} spec {r.num_spec} drafted {r.num_drafted} "
                  f"draft_accept_rate {r.draft_accept_rate:.3f} "
                  f"finish_tick {r.finish_tick}")
        print(f"served {N_REQUESTS} deep requests at lanes={LANES} in "
              f"{wall:.3f} s: {N_REQUESTS / wall:.3f} req/s, {syncs} host "
              f"syncs over {ticks} ticks (depth 1: "
              f"{self.record['serve']['ticks']}), peak {peak:.2f} GiB; "
              f"max |sample - depth-1 sample| = {dmax} (zero: "
              f"{dmax == 0.0})")
        assert all(launches[n] > 0 for n in DEEP_KERNELS), launches
        for a, b in zip(base, res):
            assert (a.accepts, a.num_full, a.num_spec) == \
                (b.accepts, b.num_full, b.num_spec), \
                f"request {a.request_id}: deep and depth-1 trajectories differ"
        assert dmax <= 1e-5, f"deep samples differ from depth-1 by {dmax}"
        assert ticks < self.record["serve"]["ticks"], "no fewer ticks"
        self.deep_results = res
        width = self._hold_width(
            "serve_deep", res[:LANES],
            engine.serve_batched(reqs[:LANES], lanes=1), (LANES, 1))
        self.record["serve_deep"] = dict(
            width=width,
            depths=list(DEEP_DEPTHS), wall_s=wall,
            req_per_s=N_REQUESTS / wall, host_syncs=syncs, ticks=ticks,
            launches=launches, peak_gib=peak, max_abs_diff_vs_depth1=dmax,
            **rollback,
            requests=[dict(request_id=r.request_id, num_full=r.num_full,
                           num_spec=r.num_spec, num_drafted=r.num_drafted,
                           finish_tick=r.finish_tick,
                           draft_accept_rate=r.draft_accept_rate)
                      for r in res])

    # --- phase 5 -------------------------------------------------------------
    def serve_spectral(self):
        from repro_torch.configs import SpeCaConfig
        from repro_torch.serving import RequestPolicy, SpeCaEngine
        engine = SpeCaEngine(self.cfg, self.params, self.dcfg,
                             SpeCaConfig(taylor_order=2),
                             forecaster="spectral", max_draft_depth=CHAIN_K,
                             device=self.dev)
        reqs = self._requests(LANES, lambda i: RequestPolicy(
            draft_depth=CHAIN_K))
        engine.serve_batched(reqs, lanes=LANES, max_ticks=5)
        with self._chain_ticks() as chain_ticks:
            res, launches, wall, syncs, peak = self._timed_serve(
                engine, reqs, LANES)
        ticks = max(r.finish_tick for r in res)
        rollback = self._hold_chain_ticks("serve_spectral", chain_ticks,
                                          launches)
        for name in SPECTRAL_KERNELS:
            self.kernels.setdefault(name, {}).setdefault("launches",
                                                         launches[name])
        print(f"spectral main path launches: {launches}")
        for r in res:
            print(f"  request {r.request_id}: alpha {r.alpha:.3f} full "
                  f"{r.num_full} spec {r.num_spec} drafted {r.num_drafted} "
                  f"draft_accept_rate {r.draft_accept_rate:.3f}")
        print(f"served {LANES} spectral depth-{CHAIN_K} requests at "
              f"lanes={LANES} in {wall:.3f} s: {syncs} host syncs over "
              f"{ticks} ticks, peak {peak:.2f} GiB")
        assert all(launches[n] > 0 for n in SPECTRAL_KERNELS), launches
        self.spectral_results = res
        width = self._hold_width(
            "serve_spectral", res, engine.serve_batched(reqs, lanes=1),
            (LANES, 1))
        self.record["serve_spectral"] = dict(
            width=width,
            wall_s=wall, host_syncs=syncs, ticks=ticks, launches=launches,
            **rollback,
            peak_gib=peak, alpha=[r.alpha for r in res],
            draft_accept_rate=[r.draft_accept_rate for r in res])

    # --- phase 6 -------------------------------------------------------------
    def _guided_requests(self, depth=None):
        """Requests 0-3 guided (scales 4.0, 1.5, 4.0, 1.5; request 2 with a
        negative prompt) and 4-7 phase 3's requests 0-3 (same cond, seed
        and τ), queued as 0, 4, 1, 5, 2, 6, 3, 7 so that guided pairs and
        single lanes share ticks. ``depth`` gives the guided ones alone
        at that draft depth."""
        torch = self.torch
        from repro_torch.serving import Request, RequestPolicy
        n = self.cfg.num_classes
        guided = []
        for i, gs in enumerate(GUIDED_SCALES):
            neg = {"labels": torch.tensor([(37 * i + 500) % n])} \
                if i == 2 else None
            guided.append(Request(
                request_id=i, cond={"labels": torch.tensor(
                    [(37 * i + 11) % n])}, seed=200 + i,
                policy=RequestPolicy(guidance_scale=gs, negative_cond=neg,
                                     draft_depth=depth)))
        if depth is not None:
            return guided
        plain = self._requests(len(GUIDED_SCALES))
        for i, r in enumerate(plain):
            r.request_id = len(GUIDED_SCALES) + i
        return [r for pair in zip(guided, plain) for r in pair]

    def serve_guided(self):
        """Classifier-free guidance: guided pairs and unguided lanes in one
        batch through the mixed program and ``ops.verify_accept_mixed``
        (``verify_accept`` must not launch: a paired session verifies
        every row through the mixed entry). The unguided requests keep
        phase 3's trajectories, counters and samples (within 1e-5); lanes
        2 keep lanes 4's counters; then the guided requests at depth 4
        keep their depth-1 trajectories in fewer ticks, through the chain
        predict and the rollback."""
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.serving import SpeCaEngine
        scfg = SpeCaConfig(taylor_order=2)
        S = self.dcfg.num_inference_steps
        engine = SpeCaEngine(self.cfg, self.params, self.dcfg, scfg,
                             device=self.dev)
        reqs = self._guided_requests()
        engine.serve_batched(reqs[:LANES], lanes=LANES, max_ticks=5)
        res, launches, wall, syncs, peak = self._timed_serve(engine, reqs,
                                                             LANES)
        ticks = max(r.finish_tick for r in res)
        print(f"guided main path launches: {launches}")
        assert all(launches[n] > 0 for n in GUIDED_KERNELS), launches
        assert launches["verify_accept"] == 0, launches
        for name in GUIDED_KERNELS:
            self.kernels.setdefault(name, {}).setdefault("launches",
                                                         launches[name])
        by_id = {r.request_id: r for r in res}
        n_g = len(GUIDED_SCALES)
        guided = [by_id[i] for i in range(n_g)]
        for r in sorted(res, key=lambda r: r.request_id):
            kind = f"guided s={GUIDED_SCALES[r.request_id]}" \
                if r.request_id < n_g else "unguided"
            print(f"  request {r.request_id}: {kind} alpha {r.alpha:.3f} "
                  f"full {r.num_full} spec {r.num_spec} drafted "
                  f"{r.num_drafted} accepts "
                  f"{''.join('1' if a else '0' for a in r.accepts)}")
        print(f"served {len(reqs)} requests ({n_g} guided) at lanes="
              f"{LANES} in {wall:.3f} s: {syncs} host syncs over {ticks} "
              f"ticks, peak {peak:.2f} GiB")
        samples = torch.cat([r.sample for r in res])
        assert torch.isfinite(samples).all(), "non-finite guided samples"
        assert all(r.completed and r.num_full + r.num_spec == S
                   for r in res)
        # not vacuous: a guided draft was accepted, and one was rejected
        # (drafted and not accepted; a cold full step is no rejection)
        assert any(r.num_spec > 0 for r in guided), "no guided accept"
        assert any(r.num_drafted > r.num_spec for r in guided), \
            "no guided draft rejected"
        # the unguided requests are phase 3's requests 0-3
        dmax = 0.0
        for i, base in enumerate(self.serve_results[:n_g]):
            r = by_id[n_g + i]
            assert (r.accepts, r.num_full, r.num_spec) == \
                (base.accepts, base.num_full, base.num_spec), \
                f"unguided request {n_g + i} left phase 3's trajectory"
            dmax = max(dmax, (r.sample - base.sample).abs().max().item())
        assert dmax <= 1e-5, f"unguided samples moved by {dmax}"
        self.guided_results = res
        width = self._hold_width("serve_guided", res,
                                 engine.serve_batched(reqs, lanes=2),
                                 (LANES, 2))
        print(f"unguided requests beside the guided ones == phase 3 (max "
              f"|sample diff| {dmax})")

        deep_engine = SpeCaEngine(self.cfg, self.params, self.dcfg, scfg,
                                  max_draft_depth=CHAIN_K, device=self.dev)
        deep_reqs = self._guided_requests(depth=CHAIN_K)
        deep_engine.serve_batched(deep_reqs, lanes=LANES, max_ticks=5)
        with self._chain_ticks() as chain_ticks:
            deep, dl, dwall, dsyncs, _ = self._timed_serve(
                deep_engine, deep_reqs, LANES)
        rollback = self._hold_chain_ticks("serve_guided deep", chain_ticks,
                                          dl)
        print(f"guided deep launches: {dl}")
        assert all(dl[n] > 0 for n in GUIDED_DEEP_KERNELS), dl
        assert dl["verify_accept"] == 0, dl
        assert any(r.num_spec > 0 for r in deep), "no deep guided accept"
        assert rollback["ticks_rejected_paired"] > 0, \
            "no guided chain position rejected and rolled back"
        ticks_in_flight = sum(r.timings.finish_tick - r.timings.admit_tick
                              for r in deep)
        for a, b in zip(guided, deep):
            assert (a.accepts, a.num_full, a.num_spec) == \
                (b.accepts, b.num_full, b.num_spec), \
                f"guided request {a.request_id}: depth {CHAIN_K} left " \
                "the depth-1 trajectory"
        assert ticks_in_flight < n_g * S, "no fewer ticks at depth 4"
        deep_width = self._hold_width(
            "serve_guided deep", deep,
            deep_engine.serve_batched(deep_reqs, lanes=2), (LANES, 2))
        for r in deep:
            print(f"  deep guided request {r.request_id}: alpha "
                  f"{r.alpha:.3f} drafted {r.num_drafted} "
                  f"draft_accept_rate {r.draft_accept_rate:.3f} ticks "
                  f"{r.timings.finish_tick - r.timings.admit_tick}")
        print(f"served {n_g} guided depth-{CHAIN_K} requests at lanes="
              f"{LANES} in {dwall:.3f} s, {dsyncs} host syncs, "
              f"{ticks_in_flight} request-ticks (depth 1: {n_g * S})")
        self.record["serve_guided"] = dict(
            width=width, deep_width=deep_width,
            wall_s=wall, host_syncs=syncs, ticks=ticks, launches=launches,
            peak_gib=peak, max_abs_diff_unguided_vs_phase3=dmax,
            requests=[dict(request_id=r.request_id,
                           guidance_scale=GUIDED_SCALES[r.request_id]
                           if r.request_id < n_g else None,
                           alpha=r.alpha, num_full=r.num_full,
                           num_spec=r.num_spec, num_drafted=r.num_drafted,
                           flops=r.flops)
                      for r in res],
            deep=dict(wall_s=dwall, host_syncs=dsyncs, launches=dl,
                      request_ticks=ticks_in_flight, **rollback,
                      alpha=[r.alpha for r in deep],
                      num_drafted=[r.num_drafted for r in deep],
                      draft_accept_rate=[r.draft_accept_rate
                                         for r in deep]))

    # --- phase 7 -------------------------------------------------------------
    def _controller_requests(self):
        """Phase 3's requests 0-7; 4-7 under ``CONTROLLER_POLICIES`` (the
        accept SLO at its defaults, a target that backs off, a deadline
        lane allowed up to 2·τ0, an order-1 cap), queued 0, 4, 1, 5, 2,
        6, 3, 7 so that controlled and controller-free lanes share
        ticks."""
        from repro_torch.configs import SpeCaConfig
        from repro_torch.core.controller import ControllerPolicy
        from repro_torch.serving import RequestPolicy
        tau0 = SpeCaConfig().tau0
        pols = [ControllerPolicy(), ControllerPolicy(target_accept=0.9),
                ControllerPolicy(slo="deadline", deadline_ticks=30,
                                 tau_max=2 * tau0),
                ControllerPolicy(order_max=1)]
        reqs = self._requests(N_REQUESTS, lambda i: RequestPolicy(
            controller=pols[i - LANES] if i >= LANES else None))
        return [r for pair in zip(reqs[:LANES], reqs[LANES:]) for r in pair]

    @contextlib.contextmanager
    def _controller_probe(self):
        """Record, on the device and read after the run, each chain tick's
        controller state after the tick (τ0, its base, the accept-SLO
        mask) and every capped prediction's weights with the cap, the
        lane's order bound and its anchor count."""
        from repro_torch.core import lane_step as LS
        from repro_torch.core import taylor
        ticks, weights, cur = [], [], {}
        call, pw = LS.ChainStep.__call__, taylor.prediction_weights

        def probe(step, state):
            cur["order_hi"] = state["ctl_order_hi"]
            cur["n_anchors"] = state["n_anchors"]
            new, flags = call(step, state)
            ticks.append((new["tau0"].clone(), new["ctl_tau_base"].clone(),
                          (new["ctl_on"] & ~new["ctl_dl"]).clone()))
            return new, flags

        def weights_probe(*a, order_cap=None, **k):
            w = pw(*a, order_cap=order_cap, **k)
            if order_cap is not None:
                weights.append((w.clone(), order_cap.clone(),
                                cur["order_hi"].clone(),
                                cur["n_anchors"].clone()))
            return w
        LS.ChainStep.__call__, taylor.prediction_weights = probe, \
            weights_probe
        try:
            yield ticks, weights
        finally:
            LS.ChainStep.__call__, taylor.prediction_weights = call, pw

    def serve_controller(self):
        """The closed-loop controller: ``SpeCaEngine(controller=True,
        max_draft_depth=4)`` at lanes=4 serves phase 3's requests 0-3
        controller-free beside 4-7 under controller policies. The
        controller-free requests keep phase 3's trajectories (phase 4's
        bar); a controlled lane speculates deeper (fewer service ticks
        than steps) through the chain predict and the rollback; no
        accept-SLO lane ever holds τ0 above its base; request 7's lane
        (its order bound 1) predicts with order-2 weights 0; lanes=2 keeps
        every request's counters."""
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.serving import SpeCaEngine
        S = self.dcfg.num_inference_steps
        engine = SpeCaEngine(self.cfg, self.params, self.dcfg,
                             SpeCaConfig(taylor_order=2), controller=True,
                             max_draft_depth=CHAIN_K, device=self.dev)
        reqs = self._controller_requests()
        engine.serve_batched(reqs[:LANES], lanes=LANES, max_ticks=5)
        res, launches, wall, syncs, peak = self._timed_serve(engine, reqs,
                                                             LANES)
        ticks = max(r.finish_tick for r in res)
        print(f"controller main path launches: {launches}")
        assert all(launches[n] > 0 for n in CONTROLLER_KERNELS), launches
        for name in CONTROLLER_KERNELS:
            self.kernels.setdefault(name, {}).setdefault("launches",
                                                         launches[name])
        by_id = {r.request_id: r for r in res}
        for r in sorted(res, key=lambda r: r.request_id):
            print(f"  request {r.request_id}: "
                  f"{'controlled' if r.request_id >= LANES else 'static'} "
                  f"alpha {r.alpha:.3f} full {r.num_full} spec {r.num_spec} "
                  f"drafted {r.num_drafted} service ticks "
                  f"{r.timings.service_ticks}")
        print(f"served {N_REQUESTS} requests (4 controlled) at lanes={LANES}"
              f" in {wall:.3f} s: {syncs} host syncs over {ticks} ticks "
              f"({syncs / ticks:.2f} a tick), peak {peak:.2f} GiB")
        samples = torch.cat([r.sample for r in res])
        assert torch.isfinite(samples).all(), "non-finite samples"
        assert all(r.completed and r.num_full + r.num_spec == S
                   for r in res)
        dmax = 0.0
        for base in self.serve_results[:LANES]:
            r = by_id[base.request_id]
            assert (r.accepts, r.num_full, r.num_spec) == \
                (base.accepts, base.num_full, base.num_spec), \
                f"controller-free request {r.request_id} left phase 3's " \
                "trajectory"
            dmax = max(dmax, (r.sample - base.sample).abs().max().item())
        assert dmax <= 1e-5, f"controller-free samples moved by {dmax}"
        controlled = [by_id[i] for i in range(LANES, N_REQUESTS)]
        assert any(r.timings.service_ticks < S for r in controlled), \
            "no controlled lane's draft_k left 1"
        with self._controller_probe() as (probe_ticks, weights):
            narrow = engine.serve_batched(reqs, lanes=2)
        width = self._hold_width("serve_controller", res, narrow, (LANES, 2))
        above = sum(bool((m & (t > base)).any().item())
                    for t, base, m in probe_ticks)
        moved = sum(bool((m & (t < base)).any().item())
                    for t, base, m in probe_ticks)
        capped = [(w, hi, n) for w, _, hi, n in weights]
        order1 = sum(bool(((hi == 1) & (n > 2)).any().item())
                     for _, hi, n in capped)
        for w, cap, hi, _ in weights:
            assert bool((cap[hi == 1] <= 1).all().item()), "cap above 1"
            assert bool((w[2][..., cap <= 1] == 0).all().item()), \
                "an order-2 weight under a cap of 1"
        print(f"controller (lanes=2 run): {len(probe_ticks)} ticks, "
              f"{moved} with an accept-SLO lane's τ0 below its base, "
              f"{above} above it; {len(weights)} capped predictions, "
              f"{order1} with request 7's lane warm at its order-1 cap; "
              f"controller-free requests == phase 3 (max |sample diff| "
              f"{dmax})")
        assert above == 0, "an accept-SLO lane held τ0 above its base"
        assert moved > 0 and order1 > 0, (moved, order1)
        self.controller_results, self.controller_syncs = res, syncs
        self.record["serve_controller"] = dict(
            width=width, wall_s=wall, host_syncs=syncs, ticks=ticks, launches=launches,
            peak_gib=peak, max_abs_diff_static_vs_phase3=dmax,
            ticks_tau_below_base=moved, capped_predictions=len(weights),
            requests=[dict(request_id=r.request_id, alpha=r.alpha,
                           num_full=r.num_full, num_spec=r.num_spec,
                           num_drafted=r.num_drafted,
                           service_ticks=r.timings.service_ticks)
                      for r in res])

    # --- phase 8 -------------------------------------------------------------
    def serve_lifecycle(self):
        """The serving lifecycle: after ``warmup`` (which must load every
        kernel library the step launches, from a cleared loader), phase
        3's 8 requests through ``submit`` and ``stream(previews=True)``
        under FIFO give phase 3's Results bitwise and load no library;
        SJF lowers the mean completion tick against FIFO and EDF's
        deadline hit rate is at least FIFO's on a mixed-``max_steps`` set;
        ``QueueFull`` at ``max_queue``; ``shutdown`` reports queued and
        in-flight requests dropped."""
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.kernels import build, ops
        from repro_torch.serving import (Preview, QueueFull, RequestPolicy,
                                         SpeCaEngine)
        S = self.dcfg.num_inference_steps
        engine = SpeCaEngine(self.cfg, self.params, self.dcfg,
                             SpeCaConfig(taylor_order=2), lanes=LANES,
                             device=self.dev)
        reqs = self._requests(N_REQUESTS)
        build._loaded.clear()            # as a fresh process finds it
        t0 = time.perf_counter()
        engine.warmup(reqs[0].cond, lanes=LANES, mixed=True)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        loaded = set(build._loaded)
        assert loaded == set(engine.kernel_sources()), loaded
        syncs0 = engine.host_syncs
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tickets = [engine.submit(r) for r in reqs]
        finals, previews = {}, {}
        for item in engine.stream(previews=True):
            if isinstance(item, Preview):
                previews.setdefault(item.ticket_id, []).append(item.step)
            else:
                finals[item.ticket_id] = item
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        syncs = engine.host_syncs - syncs0
        res = [finals[t.ticket_id] for t in tickets]
        ticks = max(r.finish_tick for r in res)
        print(f"lifecycle main path launches: {launches}")
        print(f"streamed {N_REQUESTS} requests at lanes={LANES} in "
              f"{wall:.3f} s (warmup {warm_s:.3f} s): {syncs} host syncs "
              f"over {ticks} ticks ({syncs / ticks:.2f} a tick), "
              f"{sum(map(len, previews.values()))} previews")
        assert all(launches[n] > 0 for n in LIFECYCLE_KERNELS), launches
        assert set(build._loaded) == loaded, "the timed serve loaded a kernel"
        for a, b in zip(self.serve_results, res):
            assert (a.accepts, a.num_full, a.num_spec, a.num_drafted) == \
                (b.accepts, b.num_full, b.num_spec, b.num_drafted), \
                f"request {a.request_id}: lifecycle and phase 3 differ"
            assert torch.equal(a.sample, b.sample), \
                f"request {a.request_id}: sample differs from phase 3's"
        for t in tickets:
            steps = previews.get(t.ticket_id, [])
            assert steps and steps == sorted(set(steps)) and steps[-1] < S
            assert engine.status(t) == "done"
        # schedulers on one slot: a long request queued before two short
        # ones with deadlines
        mixed = [self._requests(1)[0]] + self._requests(
            3, lambda i: RequestPolicy(max_steps=S // 4,
                                       deadline=float(i * S)))[1:]
        by = {name: engine.serve_batched(mixed, lanes=1, scheduler=name)
              for name in ("fifo", "sjf", "edf")}
        mean = {k: sum(r.finish_tick for r in v) / len(v)
                for k, v in by.items()}
        hit = {k: sum(bool(r.deadline_met) for r in v[1:]) / 2
               for k, v in by.items()}
        print(f"one slot: mean completion tick {mean}, deadline hit rate "
              f"{hit}")
        assert mean["sjf"] < mean["fifo"], mean
        assert hit["edf"] >= hit["fifo"], hit
        for name in ("sjf", "edf"):
            for a, b in zip(by["fifo"], by[name]):
                assert a.accepts == b.accepts, (name, a.request_id)
        # backpressure and shutdown: four in flight, two queued
        held = [engine.submit(r) for r in reqs[:LANES]]
        engine.tick()                                   # admits all four
        engine.max_queue = 2
        held += [engine.submit(r) for r in reqs[LANES:LANES + 2]]
        try:
            engine.submit(reqs[-1])
            raise AssertionError("no QueueFull at max_queue")
        except QueueFull:
            pass
        engine.tick(2)
        drained = engine.shutdown()
        assert {r.ticket_id for r in drained} == \
            {t.ticket_id for t in held}
        assert all(engine.status(t) == "dropped" for t in held)
        assert all(not r.completed for r in drained)
        assert sum(r.sample is None for r in drained) == 2
        print(f"QueueFull at max_queue=2; shutdown dropped {LANES} in "
              "flight and 2 queued")
        self.life_syncs, self.life_wall = syncs, wall
        self.record["serve_lifecycle"] = dict(
            wall_s=wall, warmup_s=warm_s, host_syncs=syncs, ticks=ticks,
            launches=launches, previews=sum(map(len, previews.values())),
            loaded=sorted(loaded), mean_completion_tick=mean,
            deadline_hit_rate=hit)

    # --- phase 9 -------------------------------------------------------------
    def _stream_lifecycle(self, obs):
        """Phase 8's traffic on a fresh lifecycle engine (``obs`` on or
        off): 8 requests at lanes=4 under FIFO through ``submit`` and
        ``stream(previews=True)``, launch counts set to 0 just before and
        read just after. Returns (engine, tickets, results, launches, wall
        s); each Result must equal phase 3's bitwise."""
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.kernels import ops
        from repro_torch.serving import Preview, SpeCaEngine
        engine = SpeCaEngine(self.cfg, self.params, self.dcfg,
                             SpeCaConfig(taylor_order=2), lanes=LANES,
                             obs=obs, device=self.dev)
        reqs = self._requests(N_REQUESTS)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tickets = [engine.submit(r) for r in reqs]
        finals = {item.ticket_id: item
                  for item in engine.stream(previews=True)
                  if not isinstance(item, Preview)}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        res = [finals[t.ticket_id] for t in tickets]
        assert all(launches[n] > 0 for n in LIFECYCLE_KERNELS), launches
        self._hold_bitwise(self.serve_results, res, "phase 3")
        return engine, tickets, res, launches, wall

    def _hold_bitwise(self, base, res, what):
        for a, b in zip(base, res):
            assert (a.accepts, a.num_full, a.num_spec, a.num_drafted) == \
                (b.accepts, b.num_full, b.num_spec, b.num_drafted), \
                f"request {a.request_id}: obs run and {what} differ"
            assert self.torch.equal(a.sample, b.sample), \
                f"request {a.request_id}: sample differs from {what}'s"

    @contextlib.contextmanager
    def _sync_checked_updates(self):
        """Run every ``LaneAccumulator.update`` inside under
        ``torch.cuda.set_sync_debug_mode("error")`` — a synchronizing CUDA
        call in it raises — and record the flags each received."""
        torch = self.torch
        from repro_torch.obs.lane_metrics import LaneAccumulator
        update, seen = LaneAccumulator.update, []

        def checked(acc, flags):
            seen.append(flags)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return update(acc, flags)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        LaneAccumulator.update = checked
        try:
            yield seen
        finally:
            LaneAccumulator.update = update

    @staticmethod
    def _metric(snap, name, key="value"):
        rows = [r for r in snap if r["name"] == name]
        assert rows, f"no metric {name}"
        return sum(r[key] for r in rows)

    def _hold_snapshot(self, snap, res, ticks, what):
        """Lane totals and request counters against the Results (unguided
        traffic: one lane per request)."""
        m = self._metric
        got = dict(ticks=m(snap, "speca_obs_ticks_total"),
                   n_spec=m(snap, "speca_n_spec_total"),
                   full=m(snap, "speca_full_total"),
                   n_drafted=m(snap, "speca_n_drafted_total"),
                   chain_err=m(snap, "speca_chain_err", "count"),
                   completed=m(snap, "speca_requests_completed_total"))
        want = dict(ticks=ticks, n_spec=sum(r.num_spec for r in res),
                    full=sum(r.num_full for r in res),
                    n_drafted=sum(r.num_drafted for r in res),
                    chain_err=sum(r.num_drafted for r in res),
                    completed=len(res))
        assert got == want, (what, got, want)
        return got

    def _update_cost(self, flags, iters: int = 100):
        """What one ``LaneAccumulator.update`` of ``flags`` costs, from one
        torch.profiler window of ``iters`` calls after a warm one: the
        operations it puts on the stream (the runtime's kernel-launch,
        copy and memset calls, counted on the host side, where none is
        lost), the CUDA events the window recorded, and their device µs,
        each a call. Not a ``_cuda_events`` reading: late in a long
        process the profiler's windows lost a few of this function's
        device events, so the count never came out a multiple of the
        calls."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.obs import LaneAccumulator
        acc = LaneAccumulator()
        acc.update(flags)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                acc.update(flags)
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        ops_ = sum(e.device_type != cuda and e.name.startswith(
            ("cudaLaunchKernel", "cudaMemcpy", "cudaMemset"))
            for e in prof.events())
        dev = [e for e in prof.events() if e.device_type == cuda]
        assert ops_ and dev, "the profiler saw no update"
        us = sum(e.time_range.end - e.time_range.start for e in dev)
        return ops_ / iters, len(dev) / iters, us / iters

    def serve_obs(self):
        """Observability on the card: phase 8's traffic on an ``obs=True``
        engine serves phase 3's Results bitwise with phase 8's host syncs,
        its lane totals equal the Results' sums, its queue-depth series
        has one point per tick, each trace one span per service tick, and
        the exporters render; phase 7's traffic on an ``obs=True``
        controller engine keeps phase 7's Results and host syncs and
        names rollback spans. Every accumulator update of both runs runs
        under sync-debug mode "error". Printed, not gated: the update's
        stream operations and device µs a tick, and the obs-on/off walls
        (in turns off, on, on, off: host-noisy)."""
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.serving import SpeCaEngine
        probe = torch.ones(1, device=self.dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            probe.item()
            raise AssertionError("sync-debug mode let a sync through")
        except RuntimeError:
            pass
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs, flags = [], []
        for obs in (False, True, True, False):
            with self._sync_checked_updates() as seen:
                runs.append((obs, self._stream_lifecycle(obs)))
            flags.append(seen)
        engine, tickets, res, launches, _ = runs[1][1]
        life_flags = flags[1]
        walls = {o: [r[4] for oo, r in runs if oo == o]
                 for o in (False, True)}
        syncs = {o: [r[0].host_syncs for oo, r in runs if oo == o]
                 for o in (False, True)}
        assert all(n == self.life_syncs for v in syncs.values() for n in v), \
            (syncs, self.life_syncs)
        ticks = max(r.finish_tick for r in res)
        snap = engine.metrics_snapshot()
        totals = self._hold_snapshot(snap, res, ticks, "lifecycle")
        assert len(life_flags) == ticks
        qd = engine.obs.metrics.series("speca_queue_depth")
        assert len(qd) == engine._tick_count == ticks, (len(qd), ticks)
        assert qd.points()[0][1] == N_REQUESTS, qd.points()[:2]
        for t, r in zip(tickets, res):
            tr = engine.trace(t)
            assert len(tr.tick_spans()) == r.timings.service_ticks, t
        doc = engine.obs.chrome_trace()
        text = json.dumps(doc)
        assert json.loads(text) == doc
        prom = engine.obs.prometheus()
        assert "speca_chain_err_bucket" in prom
        OUT.mkdir(exist_ok=True)
        (OUT / "serve_obs_trace.json").write_text(text)
        (OUT / "serve_obs_metrics.prom").write_text(prom)
        print(f"serve_obs lifecycle: obs on == phase 3 bitwise, host syncs "
              f"on {syncs[True]} off {syncs[False]} (phase 8 "
              f"{self.life_syncs}), totals {totals}, {len(qd)} queue-depth "
              f"points (first {qd.points()[0][1]}), {len(doc['traceEvents'])}"
              f" trace events, {len(prom.splitlines())} prometheus lines")
        # phase 7's controller traffic
        cengine = SpeCaEngine(self.cfg, self.params, self.dcfg,
                              SpeCaConfig(taylor_order=2), controller=True,
                              max_draft_depth=CHAIN_K, obs=True,
                              device=self.dev)
        with self._sync_checked_updates() as chain_flags:
            cres, claunches, cwall, csyncs, _ = self._timed_serve(
                cengine, self._controller_requests(), LANES)
        assert all(claunches[n] > 0 for n in CONTROLLER_KERNELS), claunches
        self._hold_bitwise(self.controller_results, cres, "phase 7")
        assert csyncs == self.controller_syncs, (csyncs,
                                                 self.controller_syncs)
        cticks = max(r.finish_tick for r in cres)
        ctotals = self._hold_snapshot(cengine.obs.snapshot(), cres, cticks,
                                      "controller")
        assert len(chain_flags) == cticks
        assert tuple(chain_flags[0]["chain_err"].shape) == (CHAIN_K, LANES)
        names = {s.name for tr in cengine.obs.recorder.traces()
                 for s in tr.tick_spans()}
        assert any("rollback" in n for n in names), names
        print(f"serve_obs controller: obs on == phase 7 bitwise, "
              f"{csyncs} host syncs (phase 7 {self.controller_syncs}), "
              f"totals {ctotals}, span names {sorted(names)}")
        # what one update costs on the device (not gated)
        n1, e1, us1 = self._update_cost(life_flags[0])
        nk, ek, usk = self._update_cost(chain_flags[0])
        on, off = (sum(walls[o]) / len(walls[o]) for o in (True, False))
        print(f"LaneAccumulator.update: {n1} stream operations ({e1} CUDA "
              f"events), {us1:.2f} µs on the device a depth-1 tick; {nk} "
              f"({ek}), {usk:.2f} µs a chain tick (K {CHAIN_K}); lifecycle "
              f"wall obs on {walls[True]} off {walls[False]} s (mean on/off "
              f"{on / off:.3f}, host-noisy)")
        self.record["serve_obs"] = dict(
            update_stream_ops_depth1=n1, update_cuda_events_depth1=e1,
            update_device_us_depth1=us1, update_stream_ops_chain=nk,
            update_cuda_events_chain=ek, update_device_us_chain=usk,
            lifecycle_wall_s_on=walls[True], lifecycle_wall_s_off=walls[False],
            lifecycle_host_syncs_on=syncs[True],
            lifecycle_host_syncs_off=syncs[False],
            lifecycle_host_syncs_phase8=self.life_syncs,
            lifecycle_ticks=ticks, lifecycle_totals=totals,
            lifecycle_launches=launches,
            controller_wall_s=cwall, controller_host_syncs=csyncs,
            controller_host_syncs_phase7=self.controller_syncs,
            controller_ticks=cticks, controller_totals=ctotals,
            controller_launches=claunches, span_names=sorted(names),
            sync_checked_updates=sum(map(len, flags)) + len(chain_flags))

    # --- phase 10 ------------------------------------------------------------
    def sample(self):
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.core.speca import speca_sample
        gen = torch.Generator(device=self.dev).manual_seed(3)
        x, st = speca_sample(self.cfg, self.params, self.dcfg,
                             SpeCaConfig(taylor_order=2),
                             {"labels": torch.tensor([1, 2],
                                                     device=self.dev)}, 2,
                             generator=gen, device=self.dev)
        torch.cuda.synchronize()
        alpha = st["alpha"].item()
        err = st["err"].float().cpu()
        err = err[torch.isfinite(err)]
        pct = torch.quantile(err, torch.tensor([0.1, 0.5, 0.9])).tolist() \
            if err.numel() else []
        tau = st["tau"].cpu()
        print(f"speca_sample batch 2: alpha={alpha:.3f} "
              f"num_spec={int(st['num_spec'])} err p10/p50/p90={pct} "
              f"tau {tau[0].item():.3f}..{tau[-1].item():.3f} finite="
              f"{bool(torch.isfinite(x).all())}")
        assert torch.isfinite(x).all()
        self.record["speca_sample"] = dict(
            alpha=alpha, num_spec=int(st["num_spec"]), err_p10_p50_p90=pct,
            tau_first_last=[tau[0].item(), tau[-1].item()])


    # --- text- and video-conditioned DiTs ------------------------------------
    def _hold_chain_plain(self, table, diffs):
        """The chain predict (K = CHAIN_K) on the bf16 table ``table``:
        every position within one bf16 ulp (rtol 2^-8) of its plain f32
        sum, a layer at a time (the f32 sums of a 6 GB table stay under
        0.5 GB so), and bitwise the lane predict with that position's
        weights. Returns the largest error against the plain bf16 sums."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        wk = self._weights(table[0], table[3], CHAIN_K)
        ck = ops.taylor_predict_chain_lanes(diffs, wk)
        err = 0.0
        for k in range(CHAIN_K):
            wcol = wk[:, k].contiguous()
            assert torch.equal(ck[k], ops.taylor_predict_lanes(diffs, wcol)), \
                f"chain position {k} != the lane predict at {table}"
            for layer in range(table[1]):
                want = ref.taylor_predict_lanes_ref(
                    diffs[:, layer].float(), wcol, lane_axis=1)
                got = ck[k, layer].float()
                torch.testing.assert_close(got, want, rtol=2.0 ** -8,
                                           atol=1e-6)
                err = max(err, (got - want.to(diffs.dtype).float())
                          .abs().max().item())
        return {f"chain_k{CHAIN_K}_max_abs_err": err}

    def _dit_kernels(self, key, cfg, lanes, tokens, lat, seed):
        """The main path's kernels at a text-conditioned DiT's serving
        table [3, L, 2, lanes, tokens, d] bf16 (``_table_kernels``, the
        chain by ``_hold_chain_plain``) and the rollback bitwise on its
        latent snapshots [CHAIN_K + 1] × ``lat`` f32 (lane axis 0); each
        timed by CUDA events beside its plain version, a library call and
        its bound under the rows' ``key`` entry."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        table = (3, cfg.num_layers, 2, lanes, tokens, cfg.d_model)
        t = self._table_kernels(
            key, table, seed, lambda diffs: self._hold_chain_plain(
                table, diffs), iters=10, profile=False)
        del t["diffs"], t["feats"]
        g = torch.Generator(device=self.dev).manual_seed(seed + 2)
        snaps = [torch.randn(lat, generator=g, device=self.dev)
                 for _ in range(CHAIN_K + 1)]
        for idx in self._rollback_indices(lanes):
            assert torch.equal(
                ops.lane_rollback(snaps, idx, lane_axis=0),
                ref.lane_rollback_ref(snaps, idx, lane_axis=0)), \
                f"rollback not bitwise on the {key} latents {lat}"
        idx = self._rollback_indices(lanes)[1]
        stacked = torch.stack(snaps)
        take = idx.long().reshape((1, lanes) + (1,) * (len(lat) - 1)
                                  ).expand((1,) + tuple(lat))
        self._shape_row(
            key, "lane_rollback", lat,
            lambda: ops.lane_rollback(snaps, idx, lane_axis=0),
            lambda: ref.lane_rollback_ref(snaps, idx, lane_axis=0),
            2 * snaps[0].numel() * snaps[0].element_size() + lanes * 4, 0.0,
            0.0, library=lambda: torch.take_along_dim(stacked, take, dim=0),
            iters=10, profile=False)
        for name, k in self.kernels.items():
            if key in k and "cold_ms" in k[key]:
                row = k[key]
                share = row["bound_ms"] / row["cold_ms"] \
                    if row["cold_ms"] > 0 else math.nan
                print(f"{name} at the {cfg.name} table: {row} ({share:.0%} "
                      "of its bound, cold)")
        self.record[f"{key}_kernel_checks"] = dict(
            table=list(table), latents=list(lat), **t["errs"],
            verify_max_abs_err=t["verify_err"])

    def check_flux_kernels(self):
        """The kernels at the FLUX-like table (lanes 4, 1024 tokens: [3,
        38, 2, 4, 1024, 3072], 5.7 GB; 304 rows of 3.1 M, element offsets
        past 2^31) and latents [4, 64, 64, 16]."""
        from repro_torch.configs import FLUX_LIKE
        self._dit_kernels("flux", FLUX_LIKE, LANES,
                          (FLUX_LATENT // FLUX_LIKE.patch_size) ** 2,
                          (LANES, FLUX_LATENT, FLUX_LATENT,
                           FLUX_LIKE.in_channels), 31)

    def check_video_kernels(self):
        """The kernels at the HunyuanVideo-like table (lanes 2, 2048
        tokens: [3, 40, 2, 2, 2048, 3072], 6.0 GB; 160 rows of 6.3 M) and
        the 5-D latents [2, 8, 32, 32, 16] that ``serve_video`` rolls
        back."""
        from repro_torch.configs import HUNYUAN_VIDEO_LIKE as cfg
        self._dit_kernels("video", cfg, VIDEO_LANES,
                          VIDEO_FRAMES * (VIDEO_LATENT // cfg.patch_size) ** 2,
                          (VIDEO_LANES, VIDEO_FRAMES, VIDEO_LATENT,
                           VIDEO_LATENT, cfg.in_channels), 41)

    def _text_requests(self, cfg, n, policy_of=lambda i: None, first=0):
        """Requests first..first+n-1, each with its seeded text stub
        ``cond`` [1, 8, cond_dim] of scale 0.1 (as the reference's
        ``cond_stub_batch``; a CPU generator seeded 400 + i) and noise seed
        300 + i."""
        torch = self.torch
        from repro_torch.serving import Request
        out = []
        for i in range(first, first + n):
            g = torch.Generator().manual_seed(400 + i)
            stub = torch.randn((1, TEXT_TOKENS, cfg.cond_dim),
                               generator=g) * TEXT_SCALE
            out.append(Request(request_id=i, cond={"cond": stub},
                               seed=300 + i, policy=policy_of(i)))
        return out

    def _cond_shift(self, cfg, dcfg, params, req):
        """How far a request's text stub moves the conditioning embedding:
        ‖t_emb(cond) − t_emb(no cond)‖ / ‖t_emb(no cond)‖ at the first
        sampler step."""
        torch = self.torch
        from repro_torch.diffusion.pipeline import latent_shape, make_stepper
        from repro_torch.layers.model import embed_inputs
        x = torch.zeros(latent_shape(cfg, dcfg, 1), device=self.dev)
        t = make_stepper(dcfg, self.dev).t_model[:1]
        c = req.cond["cond"].to(self.dev)
        with_c = embed_inputs(cfg, params, {"latents": x, "t": t,
                                            "cond": c})["t_emb"].float()
        without = embed_inputs(cfg, params, {"latents": x,
                                             "t": t})["t_emb"].float()
        return ((with_c - without).norm() / without.norm()).item()

    def _forward_profile(self, wl, lanes):
        """One full and one speculative forward of ``wl`` at ``lanes``
        (random latents and text stubs, step 3, forecasts of scale 0.05):
        host wall (synchronised, median of 3), kernels a call and the
        device busy time (the union of the kernels' spans) from one
        ``_traced_call`` reading, the busiest attention kernel, beside the
        forward's bound: the bf16 products over 989.4 TFLOP/s plus the f32
        attention over 67 TFLOP/s (one after the other), against the
        bytes it must read over 3.35 TB/s. The products are
        ``repro_torch.core.complexity``'s: the blocks the forward runs
        less their attention scores, the embeddings and the head, and the
        modulations of the blocks it runs; the text projection (38 MFLOP
        a request) is left out, which keeps the bound a lower one."""
        torch = self.torch
        from repro_torch.core import complexity as cx
        from repro_torch.diffusion.pipeline import latent_shape
        from tools.profile_torch_serve import busy_us, group_of
        cfg, dev, W = wl.cfg, self.dev, lanes
        T, d, L = wl.num_tokens, cfg.d_model, cfg.num_layers
        g = torch.Generator(device=dev).manual_seed(9)
        dyn = {"x": torch.randn(latent_shape(cfg, wl.dcfg, W), generator=g,
                                device=dev)}
        cond = {"cond": torch.randn((W, TEXT_TOKENS, cfg.cond_dim),
                                    generator=g, device=dev) * TEXT_SCALE}
        ctx = wl.step_context(None, torch.full((W,), 3, dtype=torch.int32,
                                               device=dev))
        preds = (torch.randn((L, 2, W, T, d), generator=g, device=dev)
                 * 0.05).to(wl.table_dtype)
        calls = {"full": lambda: wl.full_forward(dyn, cond, ctx),
                 "spec": lambda: wl.spec_forward(dyn, cond, ctx, preds)}
        attn = cx.attention_score_flops(cfg, T)         # f32, one layer
        es = 2
        layer_bytes = sum(t[0].numel() for t in _leaves(
            wl.params["blocks"])) * es
        other_bytes = sum(t.numel() * t.element_size() for t in _leaves(
            {k: wl.params[k] for k in ("embed", "head")}))
        layers = {"full": L, "spec": 1}
        extra = {"full": 0, "spec": preds.numel() * preds.element_size()}
        out = {}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            events = _traced_call(torch, fn)
            groups, att = {}, {}
            for e in events:
                span = (e.time_range.start, e.time_range.end)
                groups.setdefault(group_of(e.name), []).append(span)
                if group_of(e.name) == "attention":
                    att[e.name] = att.get(e.name, 0.0) + span[1] - span[0]
            n = layers[name]
            products = n * (cx.block_flops(cfg, T) - attn) \
                + cx.glue_flops(cfg, T) - (L - n) * cx.modulation_flops(cfg)
            mm_ms = W * products / BF16_TC_FLOPS * 1e3
            att_ms = W * n * attn / F32_FLOPS * 1e3
            bytes_ms = (n * layer_bytes + other_bytes + extra[name]) \
                / HBM_BYTES_PER_S * 1e3
            bound = max(mm_ms + att_ms, bytes_ms)
            busy = busy_us([x for v in groups.values() for x in v]) / 1e3
            out[name] = dict(
                wall_ms=sorted(walls)[1], kernels=len(events),
                busy_ms=busy, bound_ms=bound,
                bound_by="operations" if mm_ms + att_ms >= bytes_ms
                else "bytes",
                bf16_products_ms=mm_ms, f32_attention_ms=att_ms,
                bytes_ms=bytes_ms, bound_over_busy=bound / busy,
                attention_kernel=max(att, key=att.get) if att else None,
                busy_ms_by_group={g: busy_us(v) / 1e3
                                  for g, v in groups.items()})
            print(f"{cfg.name} {name} forward at lanes={W}, {T} tokens: "
                  f"{out[name]}", flush=True)
        return out

    def _hold_width(self, name, a, b, widths, flags=None, steps=0,
                    sample_tol=None):
        """Requests ``a`` served at lanes ``widths[0]`` and the same
        requests ``b`` at ``widths[1]``: equal accepts and counters (full,
        spec, drafted, FLOPs); the samples' largest difference recorded,
        and held within ``sample_tol`` where one is given. With
        ``flags``, the
        two runs' lane flags (``_lane_flags``; depth 1, every request
        ``steps`` long, so request r runs in lane r % W from tick
        (r // W)·steps), where an accept sequence differs the first step
        that differs and |e − τ| there in both runs are printed and
        recorded before the check fails. Returns the record."""
        wa, wb = widths
        diffs = []
        for ra, rb in zip(a, b):
            if flags is None or ra.accepts == rb.accepts:
                continue
            s = next(i for i, (x, y) in enumerate(zip(ra.accepts,
                                                      rb.accepts)) if x != y)
            at = []
            for f, W in zip(flags, widths):
                lane = ra.request_id % W
                row = f[(ra.request_id // W) * steps + s]
                at.append(abs(row["err"][lane] - row["tau"][lane]).item())
            diffs.append(dict(request_id=ra.request_id, step=s,
                              err_minus_tau=at))
        dmax = max((x.sample - y.sample).abs().max().item()
                   for x, y in zip(a, b))
        print(f"{name}: lanes={wa} against lanes={wb}: "
              + (f"{len(diffs)} accept sequences differ {diffs}; "
                 if flags is not None else "")
              + f"max |Δ sample| = {dmax}", flush=True)
        for x, y in zip(a, b):
            assert (x.accepts, x.num_full, x.num_spec, x.num_drafted,
                    x.flops) == (y.accepts, y.num_full, y.num_spec,
                                 y.num_drafted, y.flops), \
                f"{name} request {x.request_id}: lanes={wa} and {wb} differ"
        assert sample_tol is None or dmax <= sample_tol, \
            f"{name}: lanes={wa} and {wb} samples {dmax}"
        return dict(lanes=[wa, wb], differing=diffs, max_abs_diff=dmax)

    def _release(self):
        """Return the allocator's cached blocks to the card."""
        import gc
        gc.collect()
        self.torch.cuda.empty_cache()

    def _summary(self, res, launches, wall, syncs, peak):
        ticks = max(r.finish_tick for r in res)
        return dict(wall_s=wall, ticks=ticks, host_syncs=syncs,
                    syncs_per_tick=syncs / ticks, peak_gib=peak,
                    launches=launches, alpha=[r.alpha for r in res],
                    requests=[dict(request_id=r.request_id,
                                   num_full=r.num_full, num_spec=r.num_spec,
                                   num_drafted=r.num_drafted,
                                   finish_tick=r.finish_tick)
                              for r in res])

    def serve_flux(self):
        """FLUX-like text-to-image serving (see the docstring, phase 10c);
        the launch counts set to 0 just before each run and read just
        after."""
        torch = self.torch
        from repro_torch.configs import FLUX_LIKE, DiffusionConfig, SpeCaConfig
        from repro_torch.core.workload import DiffusionWorkload
        from repro_torch.serving import RequestPolicy, SpeCaEngine
        cfg = FLUX_LIKE
        dcfg = DiffusionConfig(schedule="rectified_flow",
                               latent_size=FLUX_LATENT)
        scfg = SpeCaConfig(taylor_order=2)
        S = dcfg.num_inference_steps
        t0 = time.perf_counter()
        params = self._tamed_params(cfg, dcfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights = sum(t.numel() * t.element_size() for t in _leaves(params))
        reqs = self._text_requests(cfg, LANES)
        shift = self._cond_shift(cfg, dcfg, params, reqs[0])
        print(f"flux-like: {weights / 1e9:.2f} GB of bf16 weights drawn in "
              f"{init_s:.1f} s; a text stub moves t_emb by {shift:.4f} of "
              "its norm (cond_w ~ N(0, 1/768))", flush=True)
        engine = SpeCaEngine(cfg, params, dcfg, scfg,
                             accept_mode="per_sample",
                             verify_backend="fused", device=self.dev)
        engine.serve_batched(reqs, lanes=LANES, max_ticks=3)    # warm up
        # (a) lanes=4: the main path at FLUX-like width
        with self._lane_flags() as f4:
            res, launches, wall, syncs, peak = self._timed_serve(
                engine, reqs, LANES)
        print(f"(a) flux main path launches: {launches}")
        for r in res:
            print(f"  request {r.request_id}: alpha {r.alpha:.3f} full "
                  f"{r.num_full} spec {r.num_spec} drafted {r.num_drafted} "
                  f"accepts {''.join('1' if x else '0' for x in r.accepts)}")
        a = self._summary(res, launches, wall, syncs, peak)
        print(f"(a) {LANES} requests at lanes={LANES}: {wall:.3f} s, "
              f"{a['ticks']} ticks, {syncs} host syncs, peak {peak:.2f} GiB",
              flush=True)
        assert all(launches[n] > 0 for n in SERVE_KERNELS), launches
        for r in res:
            assert r.completed and r.num_full + r.num_spec == S
            assert tuple(r.sample.shape) == (1, FLUX_LATENT, FLUX_LATENT,
                                             cfg.in_channels)
            assert torch.isfinite(r.sample).all(), "non-finite samples"
        # (b) lanes=2: the same trajectories
        with self._lane_flags() as f2:
            res2, _, wall2, syncs2, peak2 = self._timed_serve(engine, reqs, 2)
        b = self._summary(res2, {}, wall2, syncs2, peak2)
        print(f"(b) lanes=2: {wall2:.3f} s, {b['ticks']} ticks, {syncs2} "
              "host syncs", flush=True)
        self.record["serve_flux"] = dict(
            model=cfg.name, weights_gb=weights / 1e9, init_s=init_s,
            tokens=(FLUX_LATENT // cfg.patch_size) ** 2,
            cond_shift=shift, lanes4=a, lanes2=b)
        self.record["serve_flux"]["width"] = self._hold_width(
            "serve_flux", res, res2, (LANES, 2), (f4, f2), S,
            sample_tol=1e-5)
        del f4, f2
        # (c) a guided request beside (a)'s requests 0 and 1
        guided = self._text_requests(
            cfg, 1, lambda i: RequestPolicy(guidance_scale=FLUX_GUIDANCE),
            first=LANES)
        resg, launches_g, wallg, syncsg, peakg = self._timed_serve(
            engine, guided + reqs[:2], LANES)
        c = self._summary(resg, launches_g, wallg, syncsg, peakg)
        print(f"(c) guided launches: {launches_g}")
        print(f"(c) guided request alpha {resg[0].alpha:.3f} drafted "
              f"{resg[0].num_drafted} spec {resg[0].num_spec}; {wallg:.3f} "
              f"s, {c['ticks']} ticks", flush=True)
        assert all(launches_g[n] > 0 for n in GUIDED_KERNELS), launches_g
        assert launches_g["verify_accept"] == 0, launches_g
        for x, y in zip(res[:2], resg[1:]):
            assert (x.accepts, x.num_full, x.num_spec, x.num_drafted) == \
                (y.accepts, y.num_full, y.num_spec, y.num_drafted), \
                f"request {x.request_id} changed beside a guided pair"
            dmax = (x.sample - y.sample).abs().max().item()
            assert dmax <= 1e-5, f"request {x.request_id}: sample {dmax}"
        assert resg[0].completed and torch.isfinite(resg[0].sample).all()
        every = res + res2 + resg
        spec = sum(r.num_spec for r in every)
        rejected = sum(r.num_drafted - r.num_spec for r in every)
        print(f"serve_flux: {spec} accepted and {rejected} rejected drafts")
        assert spec > 0 and rejected > 0, (spec, rejected)
        for name in SERVE_KERNELS + GUIDED_KERNELS:
            self.kernels.setdefault(name, {}).setdefault("flux", {})[
                "launches"] = launches.get(name, 0) + launches_g.get(name, 0)
        forwards = self._forward_profile(
            DiffusionWorkload(cfg, params, dcfg, scfg, device=self.dev),
            LANES)
        self.record["serve_flux"].update(
            guided=c, accepted=spec, rejected=rejected, forwards=forwards)

    def serve_video(self):
        """HunyuanVideo-like text-to-video serving (see the docstring,
        phase 10d)."""
        torch = self.torch
        from repro_torch.configs import (HUNYUAN_VIDEO_LIKE, DiffusionConfig,
                                         SpeCaConfig)
        from repro_torch.core.workload import DiffusionWorkload
        from repro_torch.diffusion.pipeline import latent_shape
        from repro_torch.serving import RequestPolicy, SpeCaEngine
        cfg = HUNYUAN_VIDEO_LIKE
        dcfg = DiffusionConfig(schedule="rectified_flow",
                               latent_size=VIDEO_LATENT,
                               num_frames=VIDEO_FRAMES)
        scfg = SpeCaConfig(taylor_order=2)
        W, S = VIDEO_LANES, dcfg.num_inference_steps
        shape = latent_shape(cfg, dcfg, 1)
        t0 = time.perf_counter()
        params = self._tamed_params(cfg, dcfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights = sum(t.numel() * t.element_size() for t in _leaves(params))
        reqs = self._text_requests(cfg, W)
        engine = SpeCaEngine(cfg, params, dcfg, scfg, device=self.dev)
        engine.serve_batched(reqs, lanes=W, max_ticks=3)
        res, launches, wall, syncs, peak = self._timed_serve(engine, reqs, W)
        a = self._summary(res, launches, wall, syncs, peak)
        print(f"video depth 1 launches: {launches}; {wall:.3f} s, "
              f"{a['ticks']} ticks, {syncs} host syncs, peak {peak:.2f} "
              f"GiB ({weights / 1e9:.2f} GB of weights)", flush=True)
        assert all(launches[n] > 0 for n in SERVE_KERNELS), launches
        for r in res:
            assert r.completed and tuple(r.sample.shape) == shape
            assert torch.isfinite(r.sample).all(), "non-finite samples"
        deep = SpeCaEngine(cfg, params, dcfg, scfg, max_draft_depth=CHAIN_K,
                           device=self.dev)
        dreqs = self._text_requests(
            cfg, W, lambda i: RequestPolicy(draft_depth=CHAIN_K))
        deep.serve_batched(dreqs, lanes=W, max_ticks=3)
        with self._chain_ticks() as chain_ticks:
            resd, launches_d, walld, syncsd, peakd = self._timed_serve(
                deep, dreqs, W)
        d = self._summary(resd, launches_d, walld, syncsd, peakd)
        rollback = self._hold_chain_ticks("serve_video", chain_ticks,
                                          launches_d)
        print(f"video depth {CHAIN_K} launches: {launches_d}; {walld:.3f} s, "
              f"{d['ticks']} ticks, {syncsd} host syncs, peak {peakd:.2f} "
              "GiB", flush=True)
        for r in resd:
            print(f"  request {r.request_id}: alpha {r.alpha:.3f} full "
                  f"{r.num_full} spec {r.num_spec} drafted {r.num_drafted} "
                  f"finish_tick {r.finish_tick}")
        assert all(launches_d[n] > 0 for n in DEEP_KERNELS), launches_d
        dmax = max((x.sample - y.sample).abs().max().item()
                   for x, y in zip(res, resd))
        for x, y in zip(res, resd):
            assert (x.accepts, x.num_full, x.num_spec) == \
                (y.accepts, y.num_full, y.num_spec), \
                f"request {x.request_id}: depth {CHAIN_K} and 1 differ"
        assert dmax <= 1e-5, f"depth-{CHAIN_K} samples differ by {dmax}"
        assert d["ticks"] < a["ticks"], (d["ticks"], a["ticks"])
        print(f"video depth {CHAIN_K} == depth 1 in {d['ticks']} ticks "
              f"against {a['ticks']}; max |Δ sample| = {dmax}; rollback on "
              f"{len(shape)}-D latent snapshots {list((W,) + shape[1:])}")
        for name in DEEP_KERNELS + SERVE_KERNELS:
            self.kernels.setdefault(name, {}).setdefault("video", {})[
                "launches"] = launches.get(name, 0) + launches_d.get(name, 0)
        forwards = self._forward_profile(
            DiffusionWorkload(cfg, params, dcfg, scfg, device=self.dev), W)
        self.record["serve_video"] = dict(
            model=cfg.name, weights_gb=weights / 1e9, init_s=init_s,
            latent=list(shape), tokens=VIDEO_FRAMES
            * (VIDEO_LATENT // cfg.patch_size) ** 2, depth1=a,
            deep=dict(d, **rollback), max_abs_diff_vs_depth1=dmax,
            forwards=forwards)

    # --- decode shapes -------------------------------------------------------
    def _decode_shapes(self):
        """The decode phases' kernel shapes: the lane table [m+1, L, 2, W,
        1, D], one K/V cache [L, W, S, KV, hd] and the token buffer [W, new
        tokens]."""
        lm = self.lm_cfg
        return ((3, lm.num_layers, 2, LANES, 1, lm.d_model),
                (lm.num_layers, LANES, DECODE_SEQ, lm.num_kv_heads,
                 lm.resolved_head_dim),
                (LANES, DECODE_NEW))

    def _shape_row(self, key, name, shape, fn, plain, nbytes, flops, err,
                   library=None, iters=50, profile=True, floor=None):
        """Time a kernel at the shape of a path (CUDA events over
        back-to-back calls; its device time from torch.profiler, back to
        back and with the 50 MB L2 flushed before each call, as served:
        a tick's forwards stream GBs of weights between two calls) beside
        its plain version (and a library call where one computes the same
        function) and keep the numbers under the kernel's ``key`` entry
        (``"decode"``, ``"flux"``). ``profile=False`` takes the cold time
        from CUDA events instead (flush and call, less the flush alone):
        torch.profiler lost some kernels of every window at the FLUX-like
        table's shapes (4 of 10 or 20 events), which biases its mean.
        ``floor`` launches the kernel's empty counterpart on its grid: its
        device time is the row's ``floor_ms`` (by CUDA events over back-to-
        back launches where ``profile`` is False)."""
        torch = self.torch
        b, by = bound_ms(nbytes, flops)
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                            device=self.dev)

        def cold():
            flush.zero_()
            fn()
        row = dict(shape=list(shape), ms=time_ms(torch, fn, iters=iters))
        if profile:
            spans = device_spans(torch, cold, iters=min(iters, 20))
            row.update(
                device_ms=sum(device_spans(torch, fn,
                                           iters=iters).values()) / 1e3,
                cold_device_ms=sum(us for n, us in spans.items()
                                   if DEVICE_NAMES[name] in n) / 1e3)
        else:
            row["cold_ms"] = time_ms(torch, cold, iters=iters) - time_ms(
                torch, flush.zero_, iters=iters)
        if floor is not None:
            row["floor_ms"] = device_ms(
                torch, floor, ("floor_kernel",), iters=iters) if profile \
                else time_ms(torch, floor, iters=iters)
        row.update(plain_ms=time_ms(torch, plain, iters=iters),
                   library_ms=None if library is None
                   else time_ms(torch, library, iters=iters),
                   bound_ms=b, bound_by=by, max_abs_err=err)
        self.kernels.setdefault(name, {}).setdefault(key, {}).update(row)

    def _predict_rows(self, key, table, diffs, w, hold_chain, iters=50,
                      profile=True):
        """The lane predict (rtol 2^-8 of its plain f32 sum) on the bf16
        table ``diffs`` (``table`` [m+1, L, 2, W, T, D]) with weights
        ``w``, the chain predict (K = CHAIN_K) held by
        ``hold_chain(diffs)``, which returns its errors; both timed under
        ``key`` beside their plain versions, library calls, bounds and
        launch floors. Returns the chain's errors."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        bf16 = torch.bfloat16
        m1, K, W = table[0], CHAIN_K, table[3]
        R, C = table[1] * table[2] * W, table[4] * table[5]
        es = diffs.element_size()
        pk = ops.taylor_predict_lanes(diffs, w)
        torch.testing.assert_close(
            pk.float(), ref.taylor_predict_lanes_ref(diffs.float(), w),
            rtol=2.0 ** -8, atol=1e-6)
        errs = hold_chain(diffs)
        self._shape_row(
            key, "taylor_predict_lanes", table,
            lambda: ops.taylor_predict_lanes(diffs, w),
            lambda: ref.taylor_predict_lanes_ref(diffs, w),
            (m1 * R * C + R * C) * es + m1 * W * 4, 2.0 * m1 * R * C,
            (pk.float() - ref.taylor_predict_lanes_ref(diffs, w).float())
            .abs().max().item(),
            library=lambda: torch.einsum(
                "zw,zgwc->gwc", w.to(bf16), diffs.view(m1, R // W, W, C)),
            iters=iters, profile=profile,
            floor=lambda: ops.predict_launch_floor(diffs, w))
        del pk
        wk = self._weights(m1, W, K)
        self._shape_row(
            key, "taylor_predict_chain_lanes", table,
            lambda: ops.taylor_predict_chain_lanes(diffs, wk),
            lambda: ref.taylor_predict_chain_lanes_ref(diffs, wk),
            (m1 + K) * R * C * es + m1 * K * W * 4,
            2.0 * m1 * K * R * C, errs[f"chain_k{K}_max_abs_err"],
            library=lambda: torch.einsum(
                "zkb,zgbc->kgbc", wk.to(bf16), diffs.view(m1, R // W, W, C)),
            iters=iters, profile=profile,
            floor=lambda: ops.predict_launch_floor(diffs, wk))
        return errs

    def _table_kernels(self, key, table, seed, hold_chain, iters=50,
                       profile=True):
        """The lane and chain predicts (``_predict_rows``), the masked
        refresh (bitwise) and the verify on [W, T·D] planes (rtol 1e-5,
        equal accept bits wherever |e − τ| > 1e-5) against their plain
        versions on the bf16 table ``table`` [m+1, L, 2, W, T, D]; all
        four timed under ``key`` beside their plain versions and bounds.
        Returns the inputs and errors."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        bf16, dev = torch.bfloat16, self.dev
        m1, W = table[0], table[3]
        R, C = table[1] * table[2] * W, table[4] * table[5]
        diffs, feats, w, mask = self._inputs(table, bf16, seed)
        errs = self._predict_rows(key, table, diffs, w, hold_chain,
                                  iters=iters, profile=profile)
        uk = ops.taylor_update_lanes(diffs, feats, mask)
        assert torch.equal(uk, ref.taylor_update_lanes_ref(
            diffs, feats, mask)), f"refresh not bitwise at {table}"
        del uk
        pred, real = self._planes(W, C, bf16, seed=seed + 1)
        e0, _ = ref.verify_accept_ref(pred, real, torch.ones(W, device=dev))
        tau = (e0 * torch.tensor([2.0, 0.5, 1.0, 0.9], device=dev)[:W]
               ).contiguous()
        ek, ak = ops.verify_accept(pred, real, tau)
        ep, ap = ref.verify_accept_ref(pred, real, tau)
        torch.testing.assert_close(ek, ep, rtol=1e-5, atol=0.0)
        far = (ep - tau).abs() > 1e-5
        assert torch.equal(ak[far], ap[far]), f"accept bits differ at {table}"
        torch.cuda.synchronize()
        es = diffs.element_size()
        fresh = int(mask.sum().item()) * R // W
        kept = R - fresh
        self._shape_row(
            key, "taylor_update_lanes", table,
            lambda: ops.taylor_update_lanes(diffs, feats, mask),
            lambda: ref.taylor_update_lanes_ref(diffs, feats, mask),
            (kept * m1 * C + fresh * (m1 - 1) * C + fresh * C
             + m1 * R * C) * es + W, float((m1 - 1) * fresh * C), 0.0,
            iters=iters, profile=profile)
        self._shape_row(
            key, "verify_accept", (W, table[4], table[5]),
            lambda: ops.verify_accept(pred, real, tau),
            lambda: ref.verify_accept_ref(pred, real, tau),
            2 * W * C * es + W * 9, 5.0 * W * C,
            (ek - ep).abs().max().item(), iters=iters, profile=profile)
        return dict(diffs=diffs, feats=feats, mask=mask, kept=kept,
                    fresh=fresh, errs=errs,
                    verify_err=(ek - ep).abs().max().item())

    def _full_depth_predicts(self, table, seed):
        """The lane and chain predicts (``_predict_rows``; the chain at
        K = 1 and CHAIN_K, each position bitwise the lane predict) on the
        decode table at Llama-3-8B's full depth (DECODE_FULL_LAYERS),
        timed under ``decode_32``."""
        torch = self.torch
        full = (table[0], DECODE_FULL_LAYERS) + tuple(table[2:])
        diffs, _, w, _ = self._inputs(full, torch.bfloat16, seed)
        self._predict_rows(
            "decode_32", full, diffs, w,
            lambda d: self._check_chain_kernels(full, torch.bfloat16))
        for name in ("taylor_predict_lanes", "taylor_predict_chain_lanes"):
            print(f"{name} at the {DECODE_FULL_LAYERS}-layer decode table: "
                  f"{self.kernels[name]['decode_32']}")

    def check_decode_kernels(self):
        """Rows 1-6 at the shapes decode lanes give them, against their
        plain versions under the serving bars: the lane predict (rtol
        2^-8), the masked refresh, the chain predict (K = 1 and 4, each
        position bitwise the lane predict) and the ring shift on the bf16
        decode table; the verify on [W, 1, D] planes (rtol 1e-5, accept bits
        wherever |e − τ| > 1e-5); the rollback bitwise on int32 token
        buffers (lane axis 0) and on bf16 K/V caches (lane axis 1), from a
        snapshot list and stacked. Each is timed with its bound."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        table, cache, tokens = self._decode_shapes()
        bf16, dev = torch.bfloat16, self.dev
        m1, K = table[0], CHAIN_K
        t = self._table_kernels(
            "decode", table, 21,
            lambda diffs: self._check_chain_kernels(table, bf16))
        diffs, feats, mask = t["diffs"], t["feats"], t["mask"]
        g = torch.Generator(device=dev).manual_seed(23)
        chains = {
            "tokens": ([torch.randint(0, max(self.lm_cfg.vocab_size, 2),
                                      tokens, generator=g, device=dev,
                                      dtype=torch.int32)
                        for _ in range(K + 1)], 0),
            "tok": ([torch.randint(0, max(self.lm_cfg.vocab_size, 2),
                                   (LANES, 1), generator=g, device=dev,
                                   dtype=torch.int32)
                     for _ in range(K + 1)], 0),
            "cache": ([torch.randn(cache, generator=g, device=dev).to(bf16)
                       for _ in range(K + 1)], 1)}
        for what, (chain, axis) in chains.items():
            stacked = torch.stack(chain)
            for idx in self._rollback_indices(LANES):
                want = ref.lane_rollback_ref(chain, idx, lane_axis=axis)
                assert torch.equal(ops.lane_rollback(chain, idx,
                                                     lane_axis=axis), want), \
                    f"rollback not bitwise on the decode {what}"
                assert torch.equal(ops.lane_rollback(stacked, idx,
                                                     lane_axis=axis), want), \
                    f"stacked rollback not bitwise on the decode {what}"
        torch.cuda.synchronize()
        snaps, axis = chains["cache"]
        idx = self._rollback_indices(LANES)[1]
        stacked = torch.stack(snaps)
        take = idx.long().reshape((1, 1, LANES) + (1,) * (len(cache) - 2)
                                  ).expand((1,) + tuple(cache))
        self._shape_row(
            "decode", "lane_rollback", cache,
            lambda: ops.lane_rollback(snaps, idx, lane_axis=1),
            lambda: ref.lane_rollback_ref(snaps, idx, lane_axis=1),
            2 * snaps[0].numel() * snaps[0].element_size() + LANES * 4, 0.0,
            0.0, library=lambda: torch.take_along_dim(stacked, take, dim=0))
        R, C = table[1] * table[2] * LANES, table[4] * table[5]
        es = diffs.element_size()
        kept, fresh = t["kept"], t["fresh"]
        self._shape_row(
            "decode", "spectral_update_lanes", table,
            lambda: ops.spectral_update_lanes(diffs, feats, mask),
            lambda: ref.spectral_update_lanes_ref(diffs, feats, mask),
            (kept * m1 * C + fresh * m1 * C + m1 * R * C) * es + LANES,
            0.0, 0.0)
        self._full_depth_predicts(table, 25)
        out = {name: k["decode"] for name, k in self.kernels.items()
               if "decode" in k}
        for name, row in out.items():
            print(f"{name} at decode shapes: {row}")
        self.record["decode_kernel_checks"] = dict(
            table=list(table), cache=list(cache), tokens=list(tokens),
            **t["errs"], verify_max_abs_err=t["verify_err"])

    # --- decode lanes --------------------------------------------------------
    def _lm_params(self):
        """The LM's random bf16 weights, drawn on the card from a seed."""
        if getattr(self, "lm_params", None) is None:
            from repro_torch.layers.model import init_params
            gen = self.torch.Generator(device=self.dev).manual_seed(0)
            self.lm_params = init_params(self.lm_cfg, gen, device=self.dev)
        return self.lm_params

    def _decode_requests(self, n=N_REQUESTS, cfg=None, **policy):
        """Decode requests 0..n-1: seeded prompt lengths in DECODE_PROMPT,
        token ids uniform over ``cfg``'s vocabulary (default the decode
        phases' LM; CPU generator, seed 17)."""
        torch = self.torch
        from repro_torch.serving import Request, RequestPolicy
        vocab = (cfg or self.lm_cfg).vocab_size
        g = torch.Generator().manual_seed(17)
        lens = torch.randint(DECODE_PROMPT[0], DECODE_PROMPT[1] + 1,
                             (N_REQUESTS,), generator=g).tolist()
        prompts = [torch.randint(0, vocab, (1, n_), generator=g,
                                 dtype=torch.int32) for n_ in lens]
        return [Request(request_id=i, cond={"tokens": prompts[i]},
                        policy=RequestPolicy(workload="decode", **policy))
                for i in range(n)]

    def _decode_workload(self, tau0, cfg=None, params=None):
        """Decode lanes of ``cfg`` (default the Llama-3-8B phases' LM)."""
        from repro_torch.configs import SpeCaConfig
        from repro_torch.core.workload import DecodeWorkload
        return DecodeWorkload(cfg or self.lm_cfg, params or self._lm_params(),
                              SpeCaConfig(taylor_order=2, tau0=tau0),
                              max_new_tokens=DECODE_NEW,
                              max_seq_len=DECODE_SEQ, device=self.dev)

    def _greedy(self, prompt, cfg, params):
        """The port's plain greedy decode of one prompt: ``lm_forward``
        prefill (the prefix's K/V scattered, the SSD state and conv tail
        taken whole), then ``lm_decode_step`` token by token -> [new
        tokens]."""
        torch = self.torch
        from repro_torch.layers import model as M
        tokens = prompt.to(self.dev)
        P = tokens.shape[1]
        logits, ex = M.lm_forward(cfg, params, {"tokens": tokens},
                                  collect_cache=True)
        cache = M.init_cache(cfg, 1, DECODE_SEQ, self.dev)
        for k in cache:
            if k in ("k", "v"):
                cache[k][:, :, :P] = ex["cache"][k]
            else:
                cache[k] = ex["cache"][k]
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out = []
        for pos in range(P, P + DECODE_NEW):
            logits, cache = M.lm_decode_step(cfg, params, tok, cache, pos)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        return torch.cat(out, dim=1)[0].cpu()

    @contextlib.contextmanager
    def _lane_flags(self):
        """Collect the flags of every depth-1 lane step run inside (dicts
        of device tensors, read after the run)."""
        from repro_torch.core import lane_step as LS
        ticks = []
        call = LS.LaneStep.__call__

        def probe(step, state):
            new, flags = call(step, state)
            ticks.append(flags)
            return new, flags
        LS.LaneStep.__call__ = probe
        try:
            yield ticks
        finally:
            LS.LaneStep.__call__ = call

    def _raw_decode(self, wl, reqs, depth, forecaster=None):
        """Requests 0..W-1 through a raw ``build_workload_step`` loop at
        ``lanes=W`` and draft depth ``depth``: each lane filled, a lane
        leaves the batch when its schedule is done (as the engine releases
        it). Returns (state, per-lane counters, ticks, launches, wall s,
        per-tick rollback launches and drafting)."""
        torch = self.torch
        from repro_torch.core import lane_step as LS
        from repro_torch.kernels import ops
        W, S = len(reqs), wl.num_steps
        step = LS.build_workload_step(wl, lanes=W, verify_backend="fused",
                                      max_draft_depth=depth,
                                      forecaster=forecaster)
        state = LS.init_workload_state(wl, W, {}, active=True,
                                       forecaster=forecaster)
        state["draft_k"].fill_(depth)
        for lane, req in enumerate(reqs):
            state = wl.fill_payload(state, lane, req, S)
        tot = {k: torch.zeros(W, dtype=torch.int64, device=self.dev)
               for k in ("n_spec", "full", "n_drafted")}
        chain = []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ticks = 0
        while bool(state["active"].any()):
            before = ops.LAUNCHES["lane_rollback"]
            state, flags = step(state)
            chain.append((ops.LAUNCHES["lane_rollback"] - before,
                          flags["n_drafted"]))
            for k in tot:
                tot[k] += flags[k].to(torch.int64)
            state["active"] = state["active"] & (state["step"] < S)
            ticks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        return (state, {k: v.tolist() for k, v in tot.items()}, ticks,
                launches, wall, chain)

    def _hold_raw_deep(self, name, wl, reqs, forecaster):
        """Depth CHAIN_K against depth 1 on the raw loop: every dyn leaf
        bitwise, the counters equal, fewer ticks; a chain tick launches
        the rollback once per payload leaf when some lane drafted and not
        at all when none did."""
        torch = self.torch
        s1, c1, t1, _, w1, _ = self._raw_decode(wl, reqs, 1, forecaster)
        sk, ck, tk, lk, wk, chain = self._raw_decode(wl, reqs, CHAIN_K,
                                                     forecaster)
        leaves = len(wl.dyn_keys)
        drafted = [int(d.sum().item()) > 0 for _, d in chain]
        print(f"{name}: depth 1 {t1} ticks in {w1:.3f} s, depth {CHAIN_K} "
              f"{tk} ticks in {wk:.3f} s; counters {ck}; launches {lk}")
        for k in wl.dyn_keys:
            assert s1[k].dtype == sk[k].dtype and torch.equal(s1[k], sk[k]), \
                f"{name}: dyn leaf {k!r} differs between depth 1 and " \
                f"{CHAIN_K}"
        assert c1 == ck, f"{name}: counters differ: {c1} vs {ck}"
        assert tk < t1, f"{name}: no fewer ticks ({tk} vs {t1})"
        assert all(n == leaves * int(d) for (n, _), d in zip(chain, drafted))
        needs = DECODE_SPECTRAL_KERNELS if forecaster == "spectral" \
            else DECODE_DEEP_KERNELS
        assert all(lk[n] > 0 for n in needs), lk
        return dict(depth1_ticks=t1, deep_ticks=tk, depth1_wall_s=w1,
                    deep_wall_s=wk, counters=ck, launches=lk,
                    ticks_drafted_nothing=drafted.count(False))

    def _decode_forward_profile(self, wl):
        """One full decode forward of ``wl`` at LANES lanes (random input
        tokens at positions 100..103 over a zero cache): host wall
        (synchronised, median of 3), kernels a call and the device busy
        time (the union of the kernels' spans) from one ``_traced_call``
        reading."""
        torch = self.torch
        from tools.profile_torch_serve import busy_us
        g = torch.Generator(device=self.dev).manual_seed(9)
        dyn = wl.init_payload(LANES)
        dyn["tok"] = torch.randint(0, wl.cfg.vocab_size, (LANES, 1),
                                   generator=g, device=self.dev,
                                   dtype=torch.int32)
        ctx = torch.arange(100, 100 + LANES, dtype=torch.int32,
                           device=self.dev)

        def fn():
            return wl.full_forward(dyn, None, ctx)
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        events = _traced_call(torch, fn)
        return dict(wall_ms=sorted(walls)[1], kernels=len(events),
                    busy_ms=busy_us([(e.time_range.start, e.time_range.end)
                                     for e in events]) / 1e3)

    def _serve_lm(self, name, cfg, params, chains):
        """Decode lanes of ``cfg`` (bf16 random weights drawn on the card),
        8 requests of 64 new tokens: (a) τ0 = 0 at lanes=1 emits the port's
        greedy decode for every request, every step full;
        (b) at a τ0 where the run both
        accepts and rejects (the median verify error of (a)'s drafts) at
        lanes=4, with the launch counts set to 0 just before and read just
        after: the lane predict, refresh and verify launch; lanes=1 is
        measured beside it and must give every request the same tokens
        and accepts (W2); then a depth-4 chain on a raw
        lane-step loop per forecaster of ``chains`` ("taylor",
        "spectral") lands bitwise on depth 1 (tokens, counters, every cache
        leaf) in fewer ticks. Returns the record: its ``launches`` are
        (b)'s, ``deep`` and ``spectral`` the chains'."""
        torch = self.torch
        from repro_torch.serving import SpeCaEngine
        reqs = self._decode_requests(cfg=cfg)
        lens = [r.cond["tokens"].shape[1] for r in reqs]
        # (a) τ0 = 0: every draft rejected, the engine is a greedy decoder
        eng0 = SpeCaEngine(workloads={"decode": self._decode_workload(
            0.0, cfg, params)}, device=self.dev)
        eng0.serve_batched(reqs[:1], lanes=1, max_ticks=3)      # warm up
        with self._lane_flags() as flags:
            res0, l0, wall0, syncs0, _ = self._timed_serve(eng0, reqs, 1)
        t0 = time.perf_counter()
        want = [self._greedy(r.cond["tokens"], cfg, params) for r in reqs]
        greedy_s = time.perf_counter() - t0
        for r, want in zip(res0, want):
            assert r.completed and r.num_full == DECODE_NEW \
                and r.num_spec == 0, (r.request_id, r.num_full)
            assert torch.equal(r.sample, want.to(r.sample.dtype)), \
                f"{name} request {r.request_id}: τ0=0 tokens != greedy"
        err = torch.cat([f["err"] for f in flags]).float().cpu()
        err = err[torch.isfinite(err)]
        assert err.numel(), "no lane drafted at τ0 = 0"
        pct = torch.quantile(err, torch.tensor([0.1, 0.5, 0.9])).tolist()
        tau0 = pct[1]
        ticks0 = max(r.finish_tick for r in res0)
        print(f"{name} (a) τ0=0 lanes=1: tokens == greedy for {len(res0)} "
              f"requests (prompts {lens}); {wall0:.3f} s, {syncs0} host "
              f"syncs over {ticks0} ticks; greedy loop {greedy_s:.3f} s; "
              f"draft errors p10/p50/p90 {pct} -> τ0 = {tau0}")
        # (b) lanes=4 at τ0: accepts and rejects; the main decode path
        wl = self._decode_workload(tau0, cfg, params)
        eng = SpeCaEngine(workloads={"decode": wl}, device=self.dev)
        eng.serve_batched(reqs[:LANES], lanes=LANES, max_ticks=3)
        res, launches, wall, syncs, peak = self._timed_serve(eng, reqs,
                                                             LANES)
        ticks = max(r.finish_tick for r in res)
        print(f"{name} (b) main path launches: {launches}")
        for r in res:
            print(f"  request {r.request_id}: prompt {lens[r.request_id]} "
                  f"alpha {r.alpha:.3f} full {r.num_full} spec {r.num_spec} "
                  f"drafted {r.num_drafted} finish_tick {r.finish_tick}")
        spec = sum(r.num_spec for r in res)
        rejected = sum(r.num_drafted - r.num_spec for r in res)
        tok_s = N_REQUESTS * DECODE_NEW / wall
        print(f"{name} (b) τ0={tau0:.4f} lanes={LANES}: {wall:.3f} s "
              f"({tok_s:.1f} tokens/s), {syncs} host syncs over {ticks} "
              f"ticks ({syncs / ticks:.2f} a tick), {spec} accepted and "
              f"{rejected} rejected drafts, peak {peak:.2f} GiB")
        assert all(launches[n] > 0 for n in DECODE_KERNELS), launches
        assert spec > 0 and rejected > 0, (spec, rejected)
        self.lm_results = res
        for r in res:
            assert r.completed and r.sample.shape == (DECODE_NEW,)
            assert 0 <= int(r.sample.min()) and \
                int(r.sample.max()) < cfg.vocab_size
        solo, _, wall1, syncs1, _ = self._timed_serve(eng, reqs, 1)
        same = [torch.equal(a.sample, b.sample) and a.accepts == b.accepts
                for a, b in zip(res, solo)]
        print(f"{name}: lanes={LANES} against lanes=1: {sum(same)} of "
              f"{len(same)} requests identical; lanes=1 {wall1:.3f} s, "
              f"{syncs1} host syncs")
        # W2 (ROADMAP Queue 3): a lane's tokens and accepts do not depend
        # on the lane width
        assert all(same), f"{name}: lanes={LANES} and 1 differ: {same}"
        deep = {fc: self._hold_raw_deep(
            f"{name} depth-{CHAIN_K} {fc} chain", wl, reqs[:LANES],
            None if fc == "taylor" else fc) for fc in chains}
        forward = self._decode_forward_profile(wl)
        print(f"{name} full forward at lanes={LANES}: {forward}")
        return dict(
            model=cfg.name, weights_gib=sum(
                t.numel() * t.element_size() for t in _leaves(params))
            / 2**30, prompt_lens=lens, new_tokens=DECODE_NEW,
            max_seq_len=DECODE_SEQ,
            greedy=dict(wall_s=wall0, host_syncs=syncs0, ticks=ticks0,
                        greedy_loop_s=greedy_s, launches=l0,
                        err_p10_p50_p90=pct),
            tau0=tau0, wall_s=wall, tokens_per_s=tok_s, host_syncs=syncs,
            ticks=ticks, syncs_per_tick=syncs / ticks, launches=launches,
            peak_gib=peak, alpha=[r.alpha for r in res],
            requests=[dict(request_id=r.request_id, num_full=r.num_full,
                           num_spec=r.num_spec, num_drafted=r.num_drafted,
                           finish_tick=r.finish_tick) for r in res],
            lanes1=dict(wall_s=wall1, host_syncs=syncs1,
                        identical_requests=sum(same)),
            deep=deep.get("taylor"), spectral=deep.get("spectral"),
            full_forward=forward)

    def serve_decode(self):
        """Llama-3-8B decode lanes (full width, DECODE_LAYERS deep):
        ``_serve_lm`` with a Taylor and a spectral depth-4 chain."""
        torch = self.torch
        t0 = time.perf_counter()
        self._lm_params()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rec = self._serve_lm("serve_decode", self.lm_cfg, self._lm_params(),
                             ("taylor", "spectral"))
        deep, spectral = rec["deep"], rec["spectral"]
        for name in DECODE_KERNELS:
            self.kernels.setdefault(name, {}).setdefault(
                "decode", {})["launches"] = rec["launches"][name]
        for name in ("taylor_predict_chain_lanes", "lane_rollback"):
            self.kernels.setdefault(name, {}).setdefault(
                "decode", {})["launches"] = deep["launches"][name]
        self.kernels.setdefault("spectral_update_lanes", {}).setdefault(
            "decode", {})["launches"] = spectral["launches"][
                "spectral_update_lanes"]
        lm = self.lm_cfg
        self.decode_tau0 = rec["tau0"]
        self.decode_results = self.lm_results
        self.record["serve_decode"] = dict(
            rec, init_s=init_s, kv_cache_bytes=2 * lm.num_layers * LANES
            * DECODE_SEQ * lm.num_kv_heads * lm.resolved_head_dim * 2)

    def _family_kernels(self, key, cfg, seed):
        """The decode kernels at ``cfg``'s own shapes, against their plain
        versions under the serving bars: ``_table_kernels`` on its lane
        table [3, L, 2, LANES, 1, d] bf16 (the verify on [LANES, 1, d]
        planes; the chain predict at K = 1 and CHAIN_K by
        ``_check_chain_kernels``), and the rollback bitwise, from a
        snapshot list and stacked, on seeded snapshots of every decode
        cache leaf ``init_cache`` gives it (the f32 ``ssm_state`` [L,
        LANES, h, p, n], the 4-D ``conv_state``, the bf16 K/V caches; lane
        axis 1), the largest leaf timed. Rows under the kernels' ``key``
        entry; returns the record."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        from repro_torch.layers.model import init_cache
        table = (3, cfg.num_layers, 2, LANES, 1, cfg.d_model)
        t = self._table_kernels(
            key, table, seed,
            lambda diffs: self._check_chain_kernels(table, torch.bfloat16),
            iters=20, profile=False)
        del t["diffs"], t["feats"]
        g = torch.Generator(device=self.dev).manual_seed(seed + 2)
        leaves, shapes = {}, {}
        for leaf, z in init_cache(cfg, LANES, DECODE_SEQ, self.dev).items():
            shapes[leaf] = [str(z.dtype)] + list(z.shape)
            snaps = [torch.randn(z.shape, generator=g, device=self.dev)
                     .to(z.dtype) for _ in range(CHAIN_K + 1)]
            stacked = torch.stack(snaps)
            for idx in self._rollback_indices(LANES):
                want = ref.lane_rollback_ref(snaps, idx, lane_axis=1)
                assert torch.equal(ops.lane_rollback(snaps, idx,
                                                     lane_axis=1), want), \
                    f"rollback not bitwise on the {key} {leaf}"
                assert torch.equal(ops.lane_rollback(stacked, idx,
                                                     lane_axis=1), want), \
                    f"stacked rollback not bitwise on the {key} {leaf}"
            leaves[leaf] = (snaps, stacked)
        torch.cuda.synchronize()
        big = max(leaves, key=lambda k: leaves[k][0][0].numel()
                  * leaves[k][0][0].element_size())
        snaps, stacked = leaves.pop(big)
        del leaves
        shape = tuple(snaps[0].shape)
        idx = self._rollback_indices(LANES)[1]
        take = idx.long().reshape((1, 1, LANES) + (1,) * (len(shape) - 2)
                                  ).expand((1,) + shape)
        self._shape_row(
            key, "lane_rollback", shape,
            lambda: ops.lane_rollback(snaps, idx, lane_axis=1),
            lambda: ref.lane_rollback_ref(snaps, idx, lane_axis=1),
            2 * snaps[0].numel() * snaps[0].element_size() + LANES * 4, 0.0,
            0.0, library=lambda: torch.take_along_dim(stacked, take, dim=0),
            iters=20, profile=False)
        for name, k in self.kernels.items():
            if "shape" in k.get(key, {}):
                print(f"{name} at the {cfg.name} shapes: {k[key]}")
        return dict(table=list(table), rollback_leaves=shapes,
                    timed_leaf=big, **t["errs"],
                    verify_max_abs_err=t["verify_err"])

    def _serve_family(self, name, cfg, chains, seed):
        """The decode kernels held at ``cfg``'s shapes
        (``_family_kernels``), then ``_serve_lm`` on ``cfg`` at full width
        and depth, its bf16 weights drawn on the card from seed 0 and
        freed after; the kernel rows' ``name`` entry gets (b)'s launches
        and the chains'."""
        torch = self.torch
        from repro_torch.layers.model import init_params
        checks = self._family_kernels(name, cfg, seed)
        self._release()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(
            device=self.dev).manual_seed(0), device=self.dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rec = self._serve_lm(name, cfg, params, chains)
        for k in DECODE_KERNELS:
            self.kernels.setdefault(k, {}).setdefault(name, {})[
                "launches"] = rec["launches"][k]
        if rec["deep"] is not None:
            for k in ("taylor_predict_chain_lanes", "lane_rollback"):
                self.kernels.setdefault(k, {}).setdefault(name, {})[
                    "launches"] = rec["deep"]["launches"][k]
        self.record[name] = dict(rec, init_s=init_s, kernel_checks=checks,
                                 card=smi_line())

    def serve_moe(self):
        """granite-moe-1b-a400m decode lanes (24 layers, d 1024, 32
        experts top-8): (a) and (b) of ``_serve_lm``."""
        from repro_torch.configs import GRANITE_MOE_1B_A400M
        self._serve_family("serve_moe", GRANITE_MOE_1B_A400M, (), 51)

    def serve_ssm(self):
        """mamba2-130m decode lanes (24 layers, d 768, state 128, 24 heads
        of 64): (a), (b) and a depth-4 chain bitwise on depth 1, the f32
        SSD state and the conv state rolled back with the tokens."""
        from repro_torch.configs import MAMBA2_130M
        self._serve_family("serve_ssm", MAMBA2_130M, ("taylor",), 61)

    def serve_hybrid(self):
        """hymba-1.5b decode lanes at full width (d 1600, 25 heads on 5 KV
        heads, window 1024 with every 16th layer global, SSD state 16),
        HYBRID_LAYERS of 32 layers: (a), (b) and a depth-4 chain as
        ``serve_ssm``'s."""
        from repro_torch.configs import HYMBA_1_5B
        self._serve_family("serve_hybrid", dataclasses.replace(
            HYMBA_1_5B, num_layers=HYBRID_LAYERS), ("taylor",), 71)

    def decode_ring(self):
        """mixtral-8x7b at full width, its depth cut to RING_LAYERS of 32
        (93 GB of bf16 weights do not fit 80 GB): RING_SEQ seeded tokens
        in each of 2 sequences through ``lm_decode_step`` from position 0,
        once on an absolute-position cache of RING_SEQ rows and once on
        the ring-buffer cache (window W = 4096 slots, so it wraps), the
        same window on both. Gates:

        * logits: bitwise equal before the wrap (the same rows in the
          same slots), checked at every 64th position; at every position
          past it (W..RING_SEQ − 1: the same keys summed in another slot
          order) within RING_TOL of their largest magnitude at the 64th
          positions and the last, and wherever both runs send every token
          of every layer to the same top-2 experts. A rounding difference
          can tip a near tie of the router to another expert, a
          difference in kind: the other positions are counted and their
          logits recorded. Greedy tokens recorded;
        * layer 0, whose K/V depend only on a token and its position: at
          every position past the wrap, every ring slot i bitwise the
          absolute cache's row of the position it must hold, p_i = pos −
          ((pos − i) mod W); and the ring attention of a seeded f32 query
          [2, 1, 32, 128] over those slots within RING_ATTN_TOL of the
          largest magnitude of the windowed attention over the absolute
          cache. Two planted faults read above that bound in the same
          run (else the check could not see them): the absolute attention
          with a window of W − 1 (an off-by-one window) and the ring with
          the slot written at that position holding its stale row
          (position pos − W)."""
        import dataclasses
        torch = self.torch
        from repro_torch.configs import MIXTRAL_8X7B
        from repro_torch.layers import attention as A
        from repro_torch.layers import blocks as blk
        from repro_torch.layers import model as M
        cfg = dataclasses.replace(MIXTRAL_8X7B, num_layers=RING_LAYERS)
        W = cfg.attn_window
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(
            device=self.dev).manual_seed(0), device=self.dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        B = 2
        g = torch.Generator(device=self.dev).manual_seed(31)
        toks = torch.randint(0, cfg.vocab_size, (B, RING_SEQ), generator=g,
                             device=self.dev, dtype=torch.int32)
        q = torch.randn((B, 1, cfg.num_heads, cfg.resolved_head_dim),
                        generator=g, device=self.dev)
        at = sorted(set(range(0, RING_SEQ, 64)) | set(range(W, RING_SEQ)))
        assert blk.uses_ring_cache(cfg) and RING_SEQ > W

        def run(c, layer0):
            """-> (logits at ``at``, seconds, last cache, each past-wrap
            position's experts [L, B, 2], sorted)."""
            from torch.overrides import TorchFunctionMode

            class Routes(TorchFunctionMode):
                # the router's stable sort in ``moe_forward``, per layer
                def __torch_function__(self, func, types, args=(),
                                       kwargs=None):
                    out = func(*args, **(kwargs or {}))
                    if func is torch.sort:
                        self.idx.append(out.indices[:, :c.num_experts_per_tok]
                                        .sort(-1).values)
                    return out
            routes = {}
            cache = M.init_cache(c, B, RING_SEQ, self.dev)
            assert cache["k"].shape[2] == (W if blk.uses_ring_cache(c)
                                           else RING_SEQ)
            keep = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for pos in range(RING_SEQ):
                if pos < W:
                    logits, cache = M.lm_decode_step(
                        c, params, toks[:, pos:pos + 1], cache, pos)
                else:
                    with Routes() as r:
                        r.idx = []
                        logits, cache = M.lm_decode_step(
                            c, params, toks[:, pos:pos + 1], cache, pos)
                    routes[pos] = torch.stack(r.idx)
                if pos in at:
                    keep[pos] = logits[:, 0, :c.vocab_size].float()
                if pos >= W:
                    layer0(pos, cache["k"][0], cache["v"][0])
            torch.cuda.synchronize()
            return keep, time.perf_counter() - t0, cache, routes
        # the same windows on every layer, but "every (L+1)-th layer global"
        # names none and keeps the absolute-position cache
        att = {}

        def flat_attn(pos, k, v):
            att[pos] = [A.decode_attention(q, k, v, pos, w)
                        for w in (W, W - 1)]
        flat, flat_s, fc, flat_routes = run(dataclasses.replace(
            cfg, global_every=RING_LAYERS + 1), flat_attn)
        fk, fv = fc["k"][0], fc["v"][0]          # every position's row
        del fc
        slot = torch.arange(W, device=self.dev)
        l0 = {"slots_bitwise": 0, "sound": 0.0, "off_by_one": math.inf,
              "stale_slot": math.inf}

        def ring_attn(pos, k, v):
            p = pos - torch.remainder(pos - slot, W)
            l0["slots_bitwise"] += int(torch.equal(k, fk[:, p])
                                       and torch.equal(v, fv[:, p]))
            want, off = att[pos]
            scale = want.abs().max()
            stale_k, stale_v = k.clone(), v.clone()
            stale_k[:, pos % W], stale_v[:, pos % W] = fk[:, pos - W], \
                fv[:, pos - W]
            for key, got in (
                    ("sound", A.decode_attention_ring(q, k, v, pos)),
                    ("off_by_one", off),
                    ("stale_slot", A.decode_attention_ring(
                        q, stale_k, stale_v, pos))):
                r = ((got - want).abs().max() / scale).item()
                l0[key] = max(l0[key], r) if key == "sound" \
                    else min(l0[key], r)
        ring, ring_s, _, ring_routes = run(cfg, ring_attn)
        del fk, fv, att
        rel = {p: ((ring[p] - flat[p]).abs().max()
                   / flat[p].abs().max()).item() for p in at}
        agree = sum(torch.equal(ring[p].argmax(-1), flat[p].argmax(-1))
                    for p in at)
        past = [p for p in at if p >= W]
        routed = [p for p in past
                  if torch.equal(ring_routes[p], flat_routes[p])]
        tipped = {p: rel[p] for p in past if p not in routed}
        held = [p for p in past if p in routed or p % 64 == 0
                or p == RING_SEQ - 1]
        worst = max(held, key=rel.get)
        weights = sum(t.numel() * t.element_size() for t in _leaves(params))
        self.record["decode_ring"] = dict(
            model=cfg.name, layers=RING_LAYERS, weights_gb=weights / 1e9,
            init_s=init_s, seq=RING_SEQ, window=W,
            ring_s=ring_s, absolute_s=flat_s,
            ms_per_step=dict(ring=ring_s / RING_SEQ * 1e3,
                             absolute=flat_s / RING_SEQ * 1e3),
            rel_diff=rel, worst_held=worst, tol=RING_TOL,
            route_tipped=tipped,
            layer0=dict(l0, tol=RING_ATTN_TOL, positions=len(past)),
            greedy_agree=agree, positions=len(at),
            greedy_last=[ring[RING_SEQ - 1].argmax(-1).tolist(),
                         flat[RING_SEQ - 1].argmax(-1).tolist()],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            card=smi_line())
        print(f"decode_ring: {cfg.name} ({RING_LAYERS} layers) {B} × "
              f"{RING_SEQ} tokens, ring {ring_s:.2f} s, absolute "
              f"{flat_s:.2f} s; logits max |Δ| / max |logits| "
              f"{max(rel[p] for p in at if p < W)} before the wrap; past "
              f"it {rel[worst]} (position {worst}) at the {len(held)} "
              f"positions held ({len(routed)} of {len(past)} routed "
              f"alike); where a router tie tipped: {tipped}; greedy tokens "
              f"agree at {agree} of {len(at)} positions; layer 0 past the "
              f"wrap: slots bitwise at {l0['slots_bitwise']} of {len(past)}"
              f" positions, attention |Δ| / max: sound {l0['sound']}, "
              f"planted off-by-one window ≥ {l0['off_by_one']}, stale "
              f"slot ≥ {l0['stale_slot']} (bound {RING_ATTN_TOL})",
              flush=True)
        assert all(torch.isfinite(v).all() for v in ring.values())
        assert all(rel[p] == 0.0 for p in at if p < W), rel
        assert rel[worst] <= RING_TOL, (worst, rel[worst])
        assert l0["slots_bitwise"] == len(past), l0
        assert l0["sound"] <= RING_ATTN_TOL < min(
            l0["off_by_one"], l0["stale_slot"]), l0

    def decode_audio(self):
        """musicgen-medium at full width and depth (48 layers, d 1536, 4
        codebooks of 2,048, GELU), 2 requests: an ``lm_forward`` prefill of
        AUDIO_PROMPT frames, then AUDIO_NEW greedy ``lm_decode_step``s
        (each codebook's argmax the next frame's token). The last step's
        logits [2, 1, 4, V] lie within AUDIO_TOL of their largest
        magnitude of ``lm_forward`` over the whole sequence."""
        torch = self.torch
        from repro_torch.configs import MUSICGEN_MEDIUM
        from repro_torch.layers import model as M
        cfg, B, K = MUSICGEN_MEDIUM, 2, MUSICGEN_MEDIUM.num_codebooks
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(
            device=self.dev).manual_seed(0), device=self.dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        g = torch.Generator(device=self.dev).manual_seed(41)
        prompt = torch.randint(0, cfg.vocab_size, (B, K, AUDIO_PROMPT),
                               generator=g, device=self.dev,
                               dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, ex = M.lm_forward(cfg, params, {"tokens": prompt},
                                  collect_cache=True)
        cache = M.init_cache(cfg, B, AUDIO_PROMPT + AUDIO_NEW, self.dev)
        for k in cache:
            cache[k][:, :, :AUDIO_PROMPT] = ex["cache"][k]
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        frames = [prompt, tok.transpose(1, 2)]            # [B, K, 1]
        for pos in range(AUDIO_PROMPT, AUDIO_PROMPT + AUDIO_NEW):
            last, cache = M.lm_decode_step(cfg, params, frames[-1], cache,
                                           pos)
            frames.append(torch.argmax(last, dim=-1).to(
                torch.int32).transpose(1, 2))
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        seq = torch.cat(frames[:-1], dim=2)               # [B, K, P + new]
        full, _ = M.lm_forward(cfg, params, {"tokens": seq})
        assert tuple(last.shape) == (B, 1, K, cfg.padded_vocab)
        want = full[:, -1:, :, :cfg.vocab_size].float()
        rel = ((last[..., :cfg.vocab_size].float() - want).abs().max()
               / want.abs().max()).item()
        agree = torch.equal(last.argmax(-1), full[:, -1:].argmax(-1))
        print(f"decode_audio: {cfg.name} prefill {AUDIO_PROMPT} + "
              f"{AUDIO_NEW} steps in {dec_s:.2f} s; last step against "
              f"lm_forward: max |Δ| / max |logits| {rel}, argmax equal "
              f"{agree}", flush=True)
        assert torch.isfinite(last).all()
        assert rel <= AUDIO_TOL, rel
        self.record["decode_audio"] = dict(
            model=cfg.name, init_s=init_s, decode_s=dec_s,
            ms_per_step=dec_s / AUDIO_NEW * 1e3, rel_diff=rel,
            tol=AUDIO_TOL, argmax_equal=agree,
            tokens=seq[0, :, AUDIO_PROMPT:].tolist(),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            card=smi_line())

    def serve_mixed(self):
        """One lifecycle engine serves DiT-XL/2 (requests 0-3 of phase 3)
        and Llama-3-8B (decode requests 0-3 at phase serve_decode's τ0) at
        lanes=4 each, submitted alternately; each side's samples, tokens,
        counters and FLOPs equal its solo run's at the same width."""
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.kernels import ops
        from repro_torch.serving import SpeCaEngine
        dreqs = self._requests(LANES)
        treqs = self._decode_requests(LANES)
        wl = self._decode_workload(self.decode_tau0)

        def engine(diffusion, decode):
            args = (self.cfg, self.params, self.dcfg,
                    SpeCaConfig(taylor_order=2)) if diffusion else ()
            return SpeCaEngine(*args, lanes=LANES, device=self.dev,
                               workloads={"decode": wl} if decode else None)

        def run(eng, reqs):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            syncs0 = eng.host_syncs
            t0 = time.perf_counter()
            res = eng.results([eng.submit(r) for r in reqs])
            torch.cuda.synchronize()
            return (res, ops.launch_counts(), time.perf_counter() - t0,
                    eng.host_syncs - syncs0)
        both = [r for pair in zip(dreqs, treqs) for r in pair]
        res, launches, wall, syncs = run(engine(True, True), both)
        dres, _, dwall, _ = run(engine(True, False), dreqs)
        tres, _, twall, _ = run(engine(False, True), treqs)
        print(f"mixed launches: {launches}")
        assert all(launches[n] > 0 for n in MIXED_KERNELS), launches
        got = {r.request_id: r for r in res if r.workload == "diffusion"}, \
            {r.request_id: r for r in res if r.workload == "decode"}
        for side, solo in zip(got, (dres, tres)):
            for want in solo:
                r = side[want.request_id]
                assert (r.accepts, r.num_full, r.num_spec, r.num_drafted,
                        r.flops) == (want.accepts, want.num_full,
                                     want.num_spec, want.num_drafted,
                                     want.flops), \
                    f"{want.workload} request {want.request_id}: mixed " \
                    "and solo differ"
                assert torch.equal(r.sample, want.sample), \
                    f"{want.workload} request {want.request_id}: sample"
        ticks = max(r.finish_tick for r in res)
        print(f"mixed: {len(res)} requests in {wall:.3f} s ({syncs} host "
              f"syncs); solo diffusion {dwall:.3f} s, solo decode "
              f"{twall:.3f} s; each side equals its solo run")
        self.record["serve_mixed"] = dict(
            wall_s=wall, host_syncs=syncs, ticks=ticks, launches=launches,
            solo_diffusion_wall_s=dwall, solo_decode_wall_s=twall,
            alpha={r.workload + str(r.request_id): r.alpha for r in res})

    # --- lane sharding (D shards on one card) ------------------------------
    def _shard_mesh(self, D):
        """D lane shards on this card."""
        from repro_torch.launch.mesh import LaneMesh
        return LaneMesh([self.torch.device(
            "cuda", self.torch.cuda.current_device())] * D)

    def _shard_cases(self, dtype, D):
        """routing -> (its unsharded wrapper, (tensor, lane axis)
        arguments, the outputs' lane axes, the hold against the plain
        version, the plain result) at DiT-XL/2's serving shapes: the table
        [3, 28, 2, 4, 256, 1152], chains of K = CHAIN_K, the rollback on
        the latent snapshots [5, 4, 32, 32, 4] (lane axis 0: the routing
        and the wrapper are called with ``lane_axis=0``), the verify
        planes [4, 294912]; the pair verifies on 2·D lanes of [2·D,
        294912] (a pair never straddles a shard)."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        main = SHARD_TABLE
        diffs, feats, w, mask = self._inputs(main, dtype, 1)
        wc = self._weights(3, LANES, CHAIN_K)
        lat = self._latent_chain(dtype)
        idx = self._rollback_indices(LANES)[1]
        pred, real = self._verify_planes(main, dtype)
        ones = torch.ones(LANES, device=self.dev)
        tau = (ref.verify_accept_ref(pred, real, ones)[0] * torch.tensor(
            [2.0, 0.5, 1.0, 0.9], device=self.dev)).contiguous()
        W2 = 2 * D                     # the pair verifies' lanes
        ppred, preal = self._planes(W2, main[4] * main[5], dtype)
        paired = torch.tensor([True, True, False, False] * (W2 // 4),
                              device=self.dev)
        gs = torch.tensor([1.5, 1.5, 4.0, 4.0] * (W2 // 4), device=self.dev)
        ptau = (ref.verify_accept_mixed_ref(
            ppred, preal, torch.ones(W2, device=self.dev), gs, paired)[0]
            * torch.linspace(0.5, 2.0, W2, device=self.dev)).contiguous()
        tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6

        def near(got, want):
            torch.testing.assert_close(got.float(), want, rtol=tol,
                                       atol=1e-6)

        def chain_near(got, want):
            terms = ref.taylor_predict_chain_lanes_ref(diffs.float().abs(),
                                                       wc.abs())
            excess = ((got.float() - want).abs() - tol * want.abs()
                      - 2.0 ** -21 * terms).max().item()
            assert excess <= 0.0, f"chain off the plain sum by {excess}"

        def verify_near(t):
            def hold(got, want):
                torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                                           atol=0.0)
                far = (want[0] - t).abs() > 1e-5
                assert torch.equal(got[1][far], want[1][far]), "accepts"
            return hold

        def exact(got, want):
            assert torch.equal(got, want)
        pair_ref = ref.verify_accept_mixed_ref(
            ppred, preal, ptau[0::2].repeat_interleave(2), gs,
            torch.ones(W2, dtype=torch.bool, device=self.dev))
        return {
            "taylor_predict_lanes_sharded": (
                ops.taylor_predict_lanes, [(diffs, 3), (w, 1)], [2], near,
                ref.taylor_predict_lanes_ref(diffs.float(), w)),
            "taylor_predict_chain_lanes_sharded": (
                ops.taylor_predict_chain_lanes, [(diffs, 3), (wc, 2)], [3],
                chain_near, ref.taylor_predict_chain_lanes_ref(diffs.float(),
                                                               wc)),
            "lane_rollback_sharded": (
                ops.lane_rollback, [(lat, 1), (idx, 0)], [0], exact,
                ref.lane_rollback_ref(lat, idx, lane_axis=0)),
            "taylor_update_lanes_sharded": (
                ops.taylor_update_lanes, [(diffs, 3), (feats, 2), (mask, 0)],
                [3], exact, ref.taylor_update_lanes_ref(diffs, feats, mask)),
            "spectral_update_lanes_sharded": (
                ops.spectral_update_lanes,
                [(diffs, 3), (feats, 2), (mask, 0)], [3], exact,
                ref.spectral_update_lanes_ref(diffs, feats, mask)),
            "verify_accept_sharded": (
                ops.verify_accept, [(pred, 0), (real, 0), (tau, 0)], [0, 0],
                verify_near(tau), ref.verify_accept_ref(pred, real, tau)),
            "verify_accept_mixed_sharded": (
                ops.verify_accept_mixed,
                [(ppred, 0), (preal, 0), (ptau, 0), (gs, 0), (paired, 0)],
                [0, 0], verify_near(ptau),
                ref.verify_accept_mixed_ref(ppred, preal, ptau, gs, paired)),
            "verify_accept_pairs_sharded": (
                ops.verify_accept_pairs,
                [(ppred, 0), (preal, 0), (ptau[0::2].contiguous(), 0),
                 (gs[0::2].contiguous(), 0)], [0, 0],
                verify_near(ptau[0::2]), (pair_ref[0][0::2],
                                          pair_ref[1][0::2])),
        }

    def check_shard_kernels(self):
        """shard_kernels: each lane-sharded routing over D = 2 and 4 shards
        on this card, in bf16 and f32, at ``_shard_cases``' shapes: the
        blocks gathered are bitwise the unsharded kernel's result, which
        is held against the plain version as the ``kernels`` phase holds
        it; a call launches the kernel D times (the routing's count and
        the kernel's); the pair verifies at 4 lanes on 4 shards raise the
        pair rule. bf16 ms a call (CUDA events) beside the unsharded
        kernel's, under each kernel row's ``sharded`` entry."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.sharding import specs as SH
        rows = []
        for D in SHARD_COUNTS:
            mesh = self._shard_mesh(D)
            for dtype in (torch.bfloat16, torch.float32):
                cases = self._shard_cases(dtype, D)
                for name, (plain, args, axes, hold, want) in cases.items():
                    blocks = [SH.split_lanes(t, mesh, a) for t, a in args]
                    kw = {"lane_axis": 0} if name == "lane_rollback_sharded" \
                        else {}
                    fn = functools.partial(getattr(ops, name), **kw)
                    plain = functools.partial(plain, **kw)
                    unsharded = plain(*[t for t, _ in args])
                    torch.cuda.synchronize()
                    ops.reset_launch_counts()
                    got = fn(*blocks, mesh=mesh)
                    torch.cuda.synchronize()
                    n = ops.launch_counts()
                    kernel = SHARDED_KERNEL[name]
                    assert n[name] == D and n[kernel] == D \
                        and sum(n.values()) == 2 * D, (name, n)
                    got = got if isinstance(got, tuple) else (got,)
                    unsharded = unsharded if isinstance(unsharded, tuple) \
                        else (unsharded,)
                    joined = tuple(SH.gather_lanes(g, a)
                                   for g, a in zip(got, axes))
                    for j, u in zip(joined, unsharded):
                        assert torch.equal(j, u), \
                            f"{name} D={D} {dtype}: not the unsharded kernel"
                    hold(joined[0] if len(joined) == 1 else joined, want)
                    row = dict(routing=name, kernel=kernel, D=D,
                               dtype=str(dtype), launches_per_call=n[name],
                               bitwise_unsharded=True)
                    if dtype == torch.bfloat16:
                        row["ms"] = time_ms(torch,
                                            lambda: fn(*blocks, mesh=mesh))
                        row["unsharded_ms"] = time_ms(
                            torch, lambda: plain(*[t for t, _ in args]))
                        self.kernels.setdefault(kernel, {}).setdefault(
                            "sharded", {}).setdefault(name, {})[f"d{D}"] = \
                            {k: row[k] for k in ("launches_per_call", "ms",
                                                 "unsharded_ms")}
                    rows.append(row)
                    print(f"shard_kernels: {row}", flush=True)
        # the pair rule: 4 lanes on 4 shards would split every pair
        mesh = self._shard_mesh(4)
        p, r = self._planes(LANES, 64, torch.float32)
        v = torch.ones(LANES, device=self.dev)

        def lanes(t):
            return SH.split_lanes(t, mesh)
        for name, extra in (("verify_accept_mixed_sharded",
                             (lanes(v), lanes(v), lanes(v.bool()))),
                            ("verify_accept_pairs_sharded",
                             ([v[:0]] * 4, [v[:0]] * 4))):
            try:
                getattr(ops, name)(lanes(p), lanes(r), *extra, mesh=mesh)
            except ValueError as e:
                assert "2·D=8" in str(e), e
            else:
                raise AssertionError(f"{name}: 4 lanes on 4 shards ran")
        self.record["shard_kernels"] = rows

    def _hold_shards(self, name, base, base_syncs, run):
        """A sharded run (``_timed_serve``'s ``run``) against the unsharded
        run ``base`` of the same requests and width: equal accepts,
        counters and FLOPs, the same host syncs, samples within 1e-5
        (bitwise expected: W1's and W2's pins make a lane's result
        independent of the rows beside it); returns the run's record with
        the samples' largest difference."""
        res, launches, wall, syncs, peak = run
        for a, b in zip(base, res):
            assert (a.request_id, a.accepts, a.num_full, a.num_spec,
                    a.num_drafted, a.flops) == \
                (b.request_id, b.accepts, b.num_full, b.num_spec,
                 b.num_drafted, b.flops), \
                f"{name} request {a.request_id}: sharded != unsharded"
        dmax = max((a.sample.float() - b.sample.float()).abs().max().item()
                   for a, b in zip(base, res))
        ticks = max(r.finish_tick for r in res)
        print(f"{name}: {len(res)} requests in {wall:.3f} s, {ticks} ticks, "
              f"{syncs} host syncs ({syncs / ticks:.2f} a tick; unsharded "
              f"{base_syncs}), max |Δ sample| {dmax}, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        assert syncs == base_syncs, f"{name}: {syncs} host syncs"
        assert dmax <= SHARD_SAMPLE_TOL, f"{name}: samples differ by {dmax}"
        return dict(wall_s=wall, ticks=ticks, host_syncs=syncs,
                    syncs_per_tick=syncs / ticks, peak_gib=peak,
                    max_abs_diff=dmax, launches=launches)

    def _sharded_launches(self, name, launches, kernels):
        """Every kernel of the path launched, each launch through its
        routing (the routing's count is the kernel's)."""
        for k in kernels:
            routing = SHARDED_ROUTING[k]
            assert launches[routing] > 0 and \
                launches[routing] == launches[k], (name, k, launches)

    def serve_sharded(self):
        """serve_sharded: DiT-XL/2 on ``SpeCaEngine(mesh=)`` over D shards
        of this card: phase 3's 8 requests at lanes=4 over D = 2 and 4;
        then at D = 2 phase 6's guided pairs beside unguided lanes (width
        4 = 2·D), phase 4's depth-4 chains, phase 5's spectral chains and
        phase 3's first 4 requests under ``accept_mode="batch"`` (beside
        the same on an unsharded engine). Each run: launch counts set to 0
        just before and read just after, every kernel of its path
        launched once a shard through its routing, and ``_hold_shards``
        against the unsharded run."""
        from repro_torch.configs import SpeCaConfig
        from repro_torch.serving import RequestPolicy, SpeCaEngine
        scfg = SpeCaConfig(taylor_order=2)
        rec = self.record["serve_sharded"] = {}

        def engine(D, **kw):
            mesh = None if D is None else self._shard_mesh(D)
            return SpeCaEngine(self.cfg, self.params, self.dcfg, scfg,
                               mesh=mesh, device=self.dev, **kw)

        def run(key, D, reqs, base, base_syncs, kernels, **kw):
            eng = engine(D, **kw)
            eng.serve_batched(reqs[:LANES], lanes=LANES, max_ticks=3)
            out = self._timed_serve(eng, reqs, LANES)
            rec[key] = self._hold_shards(f"serve_sharded {key}", base,
                                         base_syncs, out)
            self._sharded_launches(key, out[1], kernels)
            for k in kernels:
                # a row keeps the count of the first sharded run of its
                # kernel
                r = SHARDED_ROUTING[k]
                self.kernels.setdefault(k, {}).setdefault("sharded", {}) \
                    .setdefault(r, {}).setdefault("launches", out[1][r])

        run("d2", 2, self._requests(N_REQUESTS), self.serve_results,
            self.record["serve"]["host_syncs"], SERVE_KERNELS)
        run("d4", 4, self._requests(N_REQUESTS), self.serve_results,
            self.record["serve"]["host_syncs"], SERVE_KERNELS)
        run("guided_d2", 2, self._guided_requests(), self.guided_results,
            self.record["serve_guided"]["host_syncs"], GUIDED_KERNELS)
        run("deep_d2", 2, self._requests(N_REQUESTS, lambda i: RequestPolicy(
            draft_depth=DEEP_DEPTHS[i % len(DEEP_DEPTHS)])),
            self.deep_results, self.record["serve_deep"]["host_syncs"],
            DEEP_KERNELS, max_draft_depth=CHAIN_K)
        run("spectral_d2", 2, self._requests(LANES, lambda i: RequestPolicy(
            draft_depth=CHAIN_K)), self.spectral_results,
            self.record["serve_spectral"]["host_syncs"], SPECTRAL_KERNELS,
            forecaster="spectral", max_draft_depth=CHAIN_K)
        reqs = self._requests(LANES)
        batch = engine(None, accept_mode="batch")
        batch.serve_batched(reqs, lanes=LANES, max_ticks=3)
        base = self._timed_serve(batch, reqs, LANES)
        rec["batch_unsharded"] = dict(wall_s=base[2], host_syncs=base[3])
        run("batch_d2", 2, reqs, base[0], base[3], SERVE_KERNELS,
            accept_mode="batch")
        assert any(r.num_spec > 0 for r in base[0]), "batch: no accept"

    def serve_decode_sharded(self):
        """serve_decode_sharded: Llama-3-8B decode lanes (DECODE_LAYERS
        deep) over 2 shards of this card at serve_decode's τ0: its 8
        requests × 64 tokens at lanes=4 give every request (b)'s tokens,
        accepts, counters and FLOPs at (b)'s host syncs; the launch counts
        set to 0 just before and read just after, the decode kernels
        launched through their routings."""
        from repro_torch.serving import SpeCaEngine
        reqs = self._decode_requests()
        eng = SpeCaEngine(workloads={"decode": self._decode_workload(
            self.decode_tau0)}, mesh=self._shard_mesh(2), device=self.dev)
        eng.serve_batched(reqs[:LANES], lanes=LANES, max_ticks=3)
        out = self._timed_serve(eng, reqs, LANES)
        for a, b in zip(self.decode_results, out[0]):
            assert self.torch.equal(a.sample, b.sample), \
                f"decode request {a.request_id}: sharded tokens differ"
        rec = self._hold_shards(
            "serve_decode_sharded", self.decode_results,
            self.record["serve_decode"]["host_syncs"], out)
        self._sharded_launches("serve_decode_sharded", out[1],
                               DECODE_KERNELS)
        rec["tokens_per_s"] = N_REQUESTS * DECODE_NEW / rec["wall_s"]
        rec["unsharded_wall_s"] = self.record["serve_decode"]["wall_s"]
        self.record["serve_decode_sharded"] = rec
        for k in DECODE_KERNELS:
            self.kernels.setdefault(k, {}).setdefault("sharded", {}) \
                .setdefault(SHARDED_ROUTING[k], {})["decode_launches"] = \
                out[1][SHARDED_ROUTING[k]]

    # --- training, checkpoints, baselines and the launchers -----------------
    def _falling(self, name, losses):
        """Every loss finite and the mean of the last 10 below the mean of
        the first 10."""
        assert all(math.isfinite(x) for x in losses), (name, losses)
        first, last = losses[:10], losses[-10:]
        assert sum(last) / len(last) < sum(first) / len(first), \
            (name, first, last)

    def _hold_step(self, name, loss_fn, params, tol, tol_grad):
        """``loss_fn(params, device)`` -> (loss, metrics) with its gradients
        (``value_and_grad``) on the card and on the CPU from the same
        parameters and draws: the loss within rtol ``tol``, every gradient
        leaf within ``tol_grad``·max|g| of the CPU's."""
        torch = self.torch
        from repro_torch.training.autodiff import value_and_grad
        from repro_torch.tree import tree_flatten_with_paths, tree_map
        cpu = tree_map(lambda t: t.cpu(), params)
        (lc, _), gc_ = value_and_grad(lambda p: loss_fn(p, "cpu"), cpu)
        (lg, _), gg = value_and_grad(lambda p: loss_fn(p, self.dev), params)
        rel = abs(lg.item() - lc.item()) / abs(lc.item())
        worst = 0.0
        for (k, a), (_, b) in zip(tree_flatten_with_paths(gg),
                                  tree_flatten_with_paths(gc_)):
            scale = b.abs().max().item() or 1.0
            worst = max(worst, (a.cpu() - b).abs().max().item() / scale)
        print(f"{name}: card vs CPU loss {lg.item():.6f} / {lc.item():.6f} "
              f"(rel {rel:.2e}), worst gradient |Δ|/max|g| {worst:.2e}")
        assert rel <= tol and worst <= tol_grad, (name, rel, worst)
        return dict(loss_card=lg.item(), loss_cpu=lc.item(), loss_rel=rel,
                    grad_worst_rel=worst)

    def train_dit(self):
        """DiT-XL/2 at full width and depth in f32 (28 layers, d 1152,
        1,000 classes; 32×32×4 GM latents, DDPM cosine), 100 AdamW steps at
        global batch 8, lr 1e-4, warmup 10, seed 0, through
        ``train_diffusion``: every loss finite, the last 10 below the first
        10 on average. Then one step from the same parameters and draws on
        the card and on the CPU at DiT-XL/2 width and 2 of 28 layers,
        batch 2: the loss within rtol 1e-5, every gradient leaf within
        1e-4·max|g|. Keeps the trained parameters for ``checkpoint``."""
        torch = self.torch
        from repro_torch.configs import DIT_XL2, DiffusionConfig, TrainConfig
        from repro_torch.data import synthetic as syn
        from repro_torch.diffusion.loss import diffusion_loss
        from repro_torch.layers.model import init_params
        from repro_torch.training.diffusion_trainer import train_diffusion
        cfg = dataclasses.replace(DIT_XL2, dtype="float32")
        dcfg = DiffusionConfig(latent_size=32, schedule="cosine")
        tcfg = TrainConfig(global_batch=8, steps=TRAIN_DIT_STEPS, lr=1e-4,
                           warmup=10, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train_diffusion(cfg, dcfg, tcfg, device=self.dev,
                              verbose=False)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses, step_s = out["losses"], out["step_s"]
        self._falling("train_dit", losses)
        med = sorted(step_s[2:])[len(step_s[2:]) // 2]
        print(f"train_dit: {len(losses)} steps in {wall:.1f} s, median "
              f"{med:.4f} s/step, peak {peak:.2f} GiB, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (first/last 10 mean "
              f"{sum(losses[:10]) / 10:.4f}/{sum(losses[-10:]) / 10:.4f})")
        self.trained = (cfg, out["state"]["params"])
        del out
        self._release()
        small = dataclasses.replace(cfg, num_layers=2)
        params = init_params(small, torch.Generator(
            device=self.dev).manual_seed(1), device=self.dev)
        gm = syn.GMLatentConfig(num_classes=cfg.num_classes, latent_size=32)
        batch = syn.gm_latent_batch(gm, [0, 1])
        gen = torch.Generator().manual_seed(2)
        t = torch.randint(0, 1000, (2,), generator=gen)
        noise = torch.randn(batch["latents"].shape, generator=gen)

        def loss_fn(p, dev):
            return diffusion_loss(small, dcfg, p, batch["latents"].to(dev),
                                  {"labels": batch["labels"].to(dev)},
                                  t=t.to(dev), noise=noise.to(dev))
        held = self._hold_step("train_dit", loss_fn, params, 1e-5, 1e-4)
        self.record["train_dit"] = dict(
            steps=len(losses), wall_s=wall, step_s_median=med,
            step_s=step_s, peak_gib=peak, losses=losses,
            card_vs_cpu=held, card=smi_line())

    def checkpoint(self):
        """The trained DiT-XL/2 parameters saved in the repo's format
        (``arrays.npz`` + ``manifest.json``) to a temporary directory,
        restored through ``restore_checkpoint`` and
        ``params_from_checkpoint``: both bitwise the trained tree. The
        directory is deleted after; size and seconds recorded."""
        import tempfile
        torch = self.torch
        from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
        from repro_torch.convert import params_from_checkpoint
        from repro_torch.tree import tree_flatten_with_paths
        cfg, params = self.trained
        path = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            t0 = time.perf_counter()
            save_checkpoint(path, params, step=TRAIN_DIT_STEPS)
            save_s = time.perf_counter() - t0
            size = sum(f.stat().st_size for f in Path(path).iterdir())
            t0 = time.perf_counter()
            back = restore_checkpoint(path, params, device=self.dev)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            conv = params_from_checkpoint(path, device=self.dev)
            torch.cuda.synchronize()
            convert_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(path, ignore_errors=True)
        want = tree_flatten_with_paths(params)
        for got in (back, conv):
            have = tree_flatten_with_paths(got)
            assert [k for k, _ in have] == [k for k, _ in want]
            for (k, a), (_, b) in zip(have, want):
                assert a.dtype == b.dtype and torch.equal(a, b), k
        print(f"checkpoint: {size / 2**30:.2f} GiB, save {save_s:.1f} s, "
              f"restore_checkpoint {restore_s:.1f} s, params_from_checkpoint "
              f"{convert_s:.1f} s; both bitwise the trained tree")
        self.trained = (cfg, conv)
        del back, params
        self._release()
        self.record["checkpoint"] = dict(bytes=size, save_s=save_s,
                                         restore_s=restore_s,
                                         params_from_checkpoint_s=convert_s)

    def e2e_dit(self):
        """The port's counterpart of ``examples/train_dit_speca_e2e.py`` at
        full size on the restored weights: 4 labels and one noise tensor
        through ``sample_full``, ``speca_sample`` (order 2, max_draft 8,
        τ0 0.3, β 0.9) and the baselines (``taylorseer`` at 4 and 7,
        ``fora`` at 4 and 7, ``ab2(4)``, ``teacache(0.3)``,
        ``step_reduction_sample(0.5)``). Gated: every static baseline's
        ``full_step`` is the schedule its interval and order imply, every
        latent is finite, ``num_full + num_spec`` is the step count.
        Recorded: α, the relative L2 deviation from ``sample_full``, the
        ``run_flops`` ratio to 50 full forwards, the wall time."""
        torch = self.torch
        from repro_torch.configs import DiffusionConfig, SpeCaConfig
        from repro_torch.core import baselines as B
        from repro_torch.core.complexity import run_flops
        from repro_torch.core.speca import speca_sample
        from repro_torch.diffusion.pipeline import latent_shape, sample_full
        from repro_torch.kernels import ops
        cfg, params = self.trained
        dcfg = DiffusionConfig()
        S = dcfg.num_inference_steps
        tokens = (dcfg.latent_size // cfg.patch_size) ** 2
        cond = {"labels": torch.tensor([c % cfg.num_classes
                                        for c in (1, 207, 360, 812)],
                                       device=self.dev)}
        noise = torch.randn(latent_shape(cfg, dcfg, 4),
                            generator=torch.Generator().manual_seed(5))
        kw = dict(noise=noise, device=self.dev)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        ref, ref_s = timed(lambda: sample_full(cfg, params, dcfg, cond, 4,
                                               **kw))
        assert torch.isfinite(ref).all()
        scfg = SpeCaConfig(taylor_order=2, max_draft=8, tau0=0.3, beta=0.9)
        ops.reset_launch_counts()                    # this phase's path:
        (x, st), wall = timed(lambda: speca_sample(cfg, params, dcfg, scfg,
                                                   cond, 4, **kw))
        launches = ops.launch_counts()               # read just after
        for k in ("taylor_predict_lanes", "taylor_update_lanes"):
            assert launches.get(k, 0) > 0, (k, launches)
            self.kernels.setdefault(k, {}).setdefault("e2e_dit", {})[
                "launches"] = launches[k]
        rows = {"sample_full": dict(alpha=0.0, dev=0.0, flops_ratio=1.0,
                                    wall_s=ref_s, num_full=S, num_spec=0)}
        full50 = S * run_flops(cfg, tokens, 1, 1)

        def row(name, x, num_full, num_spec, alpha, wall, steps=S):
            assert torch.isfinite(x).all(), name
            assert num_full + num_spec == steps, (name, num_full, num_spec)
            dev = ((x - ref).norm() / ref.norm()).item()
            rows[name] = dict(alpha=alpha, dev=dev, wall_s=wall,
                              num_full=num_full, num_spec=num_spec,
                              flops_ratio=run_flops(cfg, tokens, steps,
                                                    num_full) / full50)

        row("speca", x, int(st["num_full"]), int(st["num_spec"]),
            float(st["alpha"]), wall)
        policies = {"taylorseer4": B.taylorseer(4),
                    "taylorseer7": B.taylorseer(7), "fora4": B.fora(4),
                    "fora7": B.fora(7), "ab2_4": B.ab2(4),
                    "teacache0.3": B.teacache(0.3)}
        for name, pol in policies.items():
            (xb, sb), wall = timed(lambda: B.cached_sample(
                cfg, params, dcfg, pol, cond, 4, **kw))
            if pol.name != "teacache":
                want = [s <= pol.order or (s - pol.order) % pol.interval == 0
                        for s in range(S)]
                assert sb["full_step"].tolist() == want, (name, sb)
            row(name, xb, sb["num_full"], sb["num_spec"], sb["alpha"], wall)
        (xr, sr), wall = timed(lambda: B.step_reduction_sample(
            cfg, params, dcfg, 0.5, cond, 4, **kw))
        assert torch.isfinite(xr).all() and sr["num_steps"] == 25
        dev = ((xr - ref).norm() / ref.norm()).item()
        rows["step_reduction0.5"] = dict(
            alpha=0.0, dev=dev, wall_s=wall, num_full=25, num_spec=0,
            flops_ratio=run_flops(cfg, tokens, 25, 25) / full50)
        for name, r in rows.items():
            print(f"e2e_dit {name:18s} alpha={r['alpha']:.3f} "
                  f"full={r['num_full']:2d} rel-L2 dev={r['dev']:.3e} "
                  f"flops {r['flops_ratio']:.3f}× of 50 full "
                  f"wall {r['wall_s']:.2f} s")
        self.record["e2e_dit"] = dict(rows=rows, launches=launches,
                                      card=smi_line())
        self.trained = None
        self._release()

    def train_lm(self):
        """Qwen1.5-0.5B at full width and depth (24 layers, d 1024,
        vocabulary 151,936, bf16, tied embeddings) through
        ``launch/train.py``'s ``train``: remat on, batch 8, sequence 256,
        20 steps at lr 1e-3 on the LM stream; every loss finite and
        falling (the last
        10 below the first 10 on average). Then one step at 2 of 24 layers
        on the card against the CPU in f32 (TF32 off: both sides round the
        same f32 operations; bf16 products round in each library's own
        order) within rtol 1e-5 and 1e-4·max|g|, and remat on against off
        on the card in bf16: the same loss, gradients within
        1e-6·max|g|."""
        torch = self.torch
        from repro_torch.configs import QWEN1_5_0_5B
        from repro_torch.data import synthetic as syn
        from repro_torch.launch.train import train
        from repro_torch.layers.model import init_params
        from repro_torch.training import lm as T
        from repro_torch.training.autodiff import value_and_grad
        from repro_torch.tree import tree_flatten_with_paths
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train("qwen1.5-0.5b", steps=TRAIN_LM_STEPS, seq_len=256,
                    batch=8, lr=TRAIN_LM_LR, device=self.dev, log=False)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses, step_s = out["losses"], out["step_s"]
        del out
        self._release()
        self._falling("train_lm", losses)
        med = sorted(step_s[2:])[len(step_s[2:]) // 2]
        print(f"train_lm: {len(losses)} steps in {wall:.1f} s, median "
              f"{med:.4f} s/step, peak {peak:.2f} GiB, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (first/last 10 mean "
              f"{sum(losses[:10]) / 10:.4f}/{sum(losses[-10:]) / 10:.4f})")
        small = dataclasses.replace(QWEN1_5_0_5B, num_layers=2,
                                    dtype="float32")
        batch = syn.lm_batch(syn.LMStreamConfig(
            vocab_size=small.vocab_size, seq_len=256), [0, 1])
        params = init_params(small, torch.Generator(
            device=self.dev).manual_seed(3), device=self.dev)

        def loss_fn(p, dev, cfg=small, remat=True):
            return T.lm_loss(cfg, p, {k: v.to(dev) for k, v in batch.items()},
                             remat=remat)
        held = self._hold_step("train_lm", loss_fn, params, 1e-5, 1e-4)
        bf = dataclasses.replace(small, dtype="bfloat16")
        params = init_params(bf, torch.Generator(
            device=self.dev).manual_seed(3), device=self.dev)
        (l_on, _), g_on = value_and_grad(
            lambda p: loss_fn(p, self.dev, bf, True), params)
        (l_off, _), g_off = value_and_grad(
            lambda p: loss_fn(p, self.dev, bf, False), params)
        worst = 0.0
        for (k, a), (_, b) in zip(tree_flatten_with_paths(g_on),
                                  tree_flatten_with_paths(g_off)):
            scale = b.float().abs().max().item() or 1.0
            worst = max(worst, (a.float() - b.float()).abs().max().item()
                        / scale)
        print(f"train_lm: remat on/off loss {l_on.item()} / {l_off.item()}, "
              f"worst gradient |Δ|/max|g| {worst:.2e}")
        assert l_on.item() == l_off.item() and worst <= 1e-6, \
            (l_on.item(), l_off.item(), worst)
        self.record["train_lm"] = dict(
            steps=len(losses), wall_s=wall, step_s_median=med,
            step_s=step_s, peak_gib=peak, losses=losses, card_vs_cpu=held,
            remat_worst_rel=worst, card=smi_line())

    def cli(self):
        """The launchers as subprocesses: ``repro_torch.launch.serve --mode
        diffusion --requests 4`` at ``--lanes 4`` and ``--lanes 1`` (the
        per-request ``full=/spec=`` counters equal), the same at ``--lanes
        4 --device cpu`` with ``--mesh 1`` and ``--mesh 2`` (equal
        counters), ``--mode lm --arch qwen1.5-0.5b``, and
        ``repro_torch.launch.train --arch mamba2-130m --reduced --steps
        5``; each must exit 0. ``--mesh 2`` on the card must exit non-zero
        with the launcher's message when fewer than 2 cards are visible."""
        import os
        torch = self.torch
        env = dict(os.environ, PYTHONPATH=str(SRC))
        serve4 = ["serve", "--mode", "diffusion", "--requests", "4",
                  "--lanes", "4"]
        runs = {"serve_lanes4": serve4,
                "serve_lanes1": ["serve", "--mode", "diffusion",
                                 "--requests", "4", "--lanes", "1"],
                "serve_cpu_mesh1": serve4 + ["--device", "cpu"],
                "serve_cpu_mesh2": serve4 + ["--device", "cpu", "--mesh",
                                             "2"],
                "serve_mesh2": serve4 + ["--mesh", "2"],
                "serve_lm": ["serve", "--mode", "lm", "--arch",
                             "qwen1.5-0.5b"],
                "train": ["train", "--arch", "mamba2-130m", "--reduced",
                          "--steps", "5"]}
        # --mesh 2 on the card: too few cards is an error, before training
        fails = torch.cuda.device_count() < 2
        rec, counters = {}, {}
        for name, (mod, *args) in runs.items():
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", f"repro_torch.launch.{mod}", *args],
                env=env, cwd=ROOT, capture_output=True, text=True,
                timeout=600)
            rec[name] = dict(rc=p.returncode, wall_s=time.perf_counter() - t0,
                             stdout=p.stdout[-4000:], stderr=p.stderr[-4000:])
            print(f"cli {name}: rc {p.returncode} in "
                  f"{rec[name]['wall_s']:.1f} s; "
                  + " | ".join(p.stdout.strip().splitlines()[-3:]))
            if name == "serve_mesh2" and fails:
                assert p.returncode != 0 and \
                    "lane mesh over 2 devices" in p.stderr, p.stderr[-2000:]
                continue
            assert p.returncode == 0, (name, p.stderr[-2000:])
            counters[name] = re.findall(r"req (\d+): full=(\d+) spec=(\d+)",
                                        p.stdout)
        self.record["cli"] = rec
        assert len(counters["serve_lanes4"]) == 4, counters
        assert counters["serve_lanes4"] == counters["serve_lanes1"], counters
        assert len(counters["serve_cpu_mesh1"]) == 4, counters
        assert counters["serve_cpu_mesh1"] == counters["serve_cpu_mesh2"], \
            counters
        assert "x 2 shards" in rec["serve_cpu_mesh2"]["stdout"]

    def dryrun(self):
        """Phase 13f: (a) the fake-mesh dry run of ``DRYRUN_CASES`` on
        both production meshes; (b) the dry run of Llama-3-8B decode held
        against the same step on the card; (c) the SpeCa-step dry run's
        records and its refused layout; (d) the SpeCa steps of FLUX-like
        held against the card."""
        import os
        from concurrent.futures import ThreadPoolExecutor
        from repro_torch.launch.dryrun import arch_for_shape
        env = dict(os.environ, PYTHONPATH=str(SRC))
        out_dir = OUT / "dryrun"
        # the SpeCa records go to build/dryrun under their process's cwd
        speca_dir = OUT / "dryrun_speca"
        speca_dir.mkdir(parents=True, exist_ok=True)

        def run(case):
            arch, shape = case
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--both-meshes", "--out",
                 str(out_dir)], env=env, cwd=ROOT, capture_output=True,
                text=True, timeout=900)
            return case, p, time.perf_counter() - t0

        def run_speca(args):
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun_speca",
                 *args], env=env, cwd=speca_dir, capture_output=True,
                text=True, timeout=900)
            return args, p, time.perf_counter() - t0

        speca_args = [
            ["--arch", arch, "--latent", str(latent), "--batch", str(batch),
             "--table-dtype", dt]
            + (["--multi-pod", "--tag", "pod2x16x16"] if mp else [])
            for arch, latent, batch, dt, mp in SPECA_DRYRUN_CASES]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(DRYRUN_PROCS) as ex:
            pending = [ex.submit(run, c) for c in DRYRUN_CASES]
            pending_speca = [ex.submit(run_speca, a) for a in
                             speca_args + [["--multi-pod"]]]
            results = [f.result() for f in pending]
            speca = [f.result() for f in pending_speca]
        wall = time.perf_counter() - t0
        records, failed = [], []
        for (arch, shape), p, dt in results:
            print(f"dryrun {arch} {shape}: rc {p.returncode} in {dt:.1f} s",
                  flush=True)
            for x in p.stdout.splitlines():
                if x.startswith("[dryrun] ") and " × " in x:
                    print(f"  {x}", flush=True)
            if p.returncode:
                print(p.stderr.strip()[-2000:], flush=True)
                failed.append((arch, shape))
                continue
            eff = arch_for_shape(arch, shape)
            for mesh in ("pod16x16", "pod2x16x16"):
                records.append(json.loads((out_dir / (
                    f"{eff.replace('+', '_')}_{shape}_{mesh}.json"))
                    .read_text()))
        print(f"dryrun (a): {len(records)} of {2 * len(DRYRUN_CASES)} "
              f"records; (a) and (c) in {wall:.1f} s", flush=True)
        self.record["dryrun"] = dict(records=records, wall_s=wall,
                                     failed=failed)

        # (c) the SpeCa-step records
        speca_records = []
        for (arch, _, _, dt, mp), (args, p, dt_s) in zip(SPECA_DRYRUN_CASES,
                                                        speca):
            print(f"dryrun (c) {' '.join(args)}: rc {p.returncode} in "
                  f"{dt_s:.1f} s", flush=True)
            for x in p.stdout.splitlines():
                if x.startswith("[speca-dryrun"):
                    print(f"  {x}", flush=True)
            if p.returncode:
                print(p.stderr.strip()[-2000:], flush=True)
                failed.append(tuple(args))
                continue
            tag = "_pod2x16x16" if mp else ""
            speca_records.append(json.loads((
                speca_dir / "build" / "dryrun"
                / f"speca_step_{arch}_{dt}_m2{tag}.json").read_text()))
        _, refused, _ = speca[-1]
        print(f"dryrun (c) flux-like --multi-pod at batch 16: rc "
              f"{refused.returncode}: "
              f"{(refused.stderr.strip().splitlines() or [''])[-1]}",
              flush=True)
        self.record["dryrun"]["speca"] = dict(
            records=speca_records,
            refused=dict(rc=refused.returncode,
                         stderr=refused.stderr[-2000:]))

        # (b) the card check
        torch = self.torch
        import torch.distributed as dist
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.configs import DECODE_32K, LLAMA3_8B, ShapeConfig
        from repro_torch.launch import cost_analysis as C
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import fake_world, make_local_mesh
        from repro_torch.launch.steps import decode_position
        from repro_torch.layers.model import init_cache, init_params
        from repro_torch.training.lm import serve_step
        cfg = dataclasses.replace(LLAMA3_8B, num_layers=DECODE_LAYERS)
        shape = ShapeConfig(name="decode_32k_b8", seq_len=DECODE_32K.seq_len,
                            global_batch=DRYRUN_CARD_BATCH, kind="decode")
        with fake_world(1):
            dry = D.measure_step(cfg, shape, make_local_mesh((1, 1)))
        assert not dist.is_initialized()
        gen = torch.Generator(device=self.dev).manual_seed(11)
        params = init_params(cfg, gen, device=self.dev)
        tokens = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1),
                               generator=gen, device=self.dev,
                               dtype=torch.int32)
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           device=self.dev)
        arg_bytes = C.tree_bytes((params, tokens, cache))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            logits, new = serve_step(cfg, params, tokens, cache,
                                     decode_position(shape))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - live
        out_bytes = C.tree_bytes((logits, new))
        real = dict(argument_bytes=arg_bytes, output_bytes=out_bytes,
                    flops=fc.get_total_flops(), peak_beyond_live=peak,
                    live_before=live, step_s=step_s)
        ratio = dry["temp_bytes"] / peak if peak else None
        print(f"dryrun (b): Llama-3-8B {DECODE_LAYERS} layers decode_32k "
              f"batch {shape.global_batch}: argument bytes dry "
              f"{dry['argument_bytes']} / card {arg_bytes}; output bytes "
              f"{dry['output_bytes']} / {out_bytes}; FLOPs {dry['flops']} / "
              f"{real['flops']}; temp {dry['temp_bytes'] / 2**30:.3f} GiB "
              f"dry / {peak / 2**30:.3f} GiB card peak beyond the "
              f"{live / 2**30:.3f} GiB live (ratio {ratio}); card step "
              f"{step_s:.3f} s; {smi_line()}", flush=True)
        self.record["dryrun"]["card_check"] = dict(
            dry={k: v for k, v in dry.items() if k != "collectives"},
            card=real, temp_ratio=ratio, smi=smi_line())
        finite = bool(torch.isfinite(logits.float()).all())
        del params, cache, logits, new
        assert not failed, failed
        assert refused.returncode != 0 and "does not divide" in \
            refused.stderr, refused.stderr[-2000:]
        assert finite
        assert dry["argument_bytes"] == arg_bytes, (dry, real)
        assert dry["output_bytes"] == out_bytes, (dry, real)
        assert dry["flops"] == real["flops"], (dry, real)
        assert not dist.is_initialized()
        self._release()
        self._speca_card_check()

    def _speca_card_check(self):
        """Phase 13f (d): FLUX-like's ``full_step`` and ``spec_step`` as a
        dry run on a (1, 1) fake mesh and for real on the card."""
        torch = self.torch
        import torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.configs import FLUX_LIKE, DiffusionConfig, SpeCaConfig
        from repro_torch.core import taylor
        from repro_torch.launch import cost_analysis as C
        from repro_torch.launch import dryrun_speca as DSP
        from repro_torch.launch.dryrun import measure
        from repro_torch.launch.mesh import fake_world, make_local_mesh
        cfg, B = FLUX_LIKE, SPECA_CARD_BATCH
        dcfg = DiffusionConfig(num_inference_steps=50, latent_size=128,
                               schedule="rectified_flow")
        scfg = SpeCaConfig(taylor_order=2)
        names = ("full_step", "spec_step")
        with fake_world(1):
            mesh = make_local_mesh((1, 1))
            with FakeTensorMode():
                fns, args, _, outs = DSP.build(cfg, dcfg, scfg, batch=B,
                                               table_dtype=torch.bfloat16,
                                               mesh=mesh)
                dry = {n: measure(fn, args, o)
                       for n, fn, o in zip(names, fns, outs)}
            del fns, args
        assert not dist.is_initialized()

        full, spec = DSP.make_steps(cfg, dcfg, scfg, self.dev)
        params = self._tamed_params(cfg, dcfg)
        gen = torch.Generator(device=self.dev).manual_seed(12)
        lat = dcfg.latent_size
        x = torch.randn((B, lat, lat, cfg.in_channels), generator=gen,
                        device=self.dev)
        cond = {"cond": torch.randn((B, TEXT_TOKENS, cfg.cond_dim),
                                    generator=gen, device=self.dev)
                * TEXT_SCALE}
        n_tok = (lat // cfg.patch_size) ** 2
        tstate = taylor.init_state(
            scfg.taylor_order, taylor.feature_shape_for(
                cfg.num_layers, B, n_tok, cfg.d_model),
            torch.bfloat16, device=self.dev)

        def step(i):
            return torch.tensor(i, dtype=torch.int32, device=self.dev)

        def timed(fn, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        # three real anchors fill every plane of the table
        fill_s = []
        for i in range(scfg.taylor_order + 1):
            (x, tstate), dt = timed(full, params, x, tstate, step(i), cond)
            fill_s.append(dt)
        card = {}
        for name, fn, i in (("full_step", full, 3), ("spec_step", spec, 4)):
            a = (params, x, tstate, step(i), cond)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            with FlopCounterMode(display=False) as fc:
                out, counted_s = timed(fn, *a)
            peak = torch.cuda.max_memory_allocated() - live
            card[name] = dict(argument_bytes=C.tree_bytes(a),
                              output_bytes=C.tree_bytes(out),
                              flops=fc.get_total_flops(),
                              peak_beyond_live=peak, live_before=live,
                              flop_counter_wall_s=counted_s)
            del out
            _, card[name]["wall_s"] = timed(fn, *a)
            if name == "full_step":
                # the draft predicts from the table this anchor refreshed
                (x, tstate), _ = timed(fn, *a)
            else:
                (x_spec, err), _ = timed(fn, *a)
            del a
        ratio = {n: dry[n]["temp_bytes"] / card[n]["peak_beyond_live"]
                 for n in names}
        smi = smi_line()
        for n in names:
            d, c = dry[n], card[n]
            print(f"dryrun (d): FLUX-like {n} batch {B} latent {lat} bf16 "
                  f"table m={scfg.taylor_order}: argument bytes dry "
                  f"{d['argument_bytes']} / card {c['argument_bytes']}; "
                  f"output bytes {d['output_bytes']} / {c['output_bytes']}; "
                  f"FLOPs {d['flops']} / {c['flops']}; temp "
                  f"{d['temp_bytes'] / 2**30:.3f} GiB dry / "
                  f"{c['peak_beyond_live'] / 2**30:.3f} GiB card peak beyond "
                  f"the {c['live_before'] / 2**30:.3f} GiB live (ratio "
                  f"{ratio[n]:.4f}); card wall {c['wall_s']:.4f} s "
                  f"({c['flop_counter_wall_s']:.4f} s under "
                  f"FlopCounterMode); trace {d['trace_s']:.2f} s; {smi}",
                  flush=True)
        print(f"dryrun (d): fill anchors {[round(t, 4) for t in fill_s]} s; "
              f"err {err.tolist()}", flush=True)
        self.record["dryrun"]["speca_card_check"] = dict(
            dry={n: {k: v for k, v in dry[n].items() if k != "collectives"}
                 for n in names},
            card=card, temp_ratio=ratio, fill_s=fill_s, err=err.tolist(),
            smi=smi)
        finite = bool(torch.isfinite(x_spec).all()) and \
            bool(torch.isfinite(err).all())
        del params, tstate, x, x_spec
        assert finite, err
        for n in names:
            assert dry[n]["argument_bytes"] == card[n]["argument_bytes"], \
                (n, dry[n], card[n])
            assert dry[n]["output_bytes"] == card[n]["output_bytes"], \
                (n, dry[n], card[n])
            assert dry[n]["flops"] == card[n]["flops"], (n, dry[n], card[n])


def _leaves(tree):
    """The tensor leaves of a nested dict."""
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


KERNEL_META = {
    "taylor_predict_lanes": ("src/repro_torch/kernels/csrc/"
                             "taylor_predict_lanes.cu",
                             "src/repro/kernels/taylor_predict.py:70"),
    "taylor_update_lanes": ("src/repro_torch/kernels/csrc/"
                            "taylor_update_lanes.cu",
                            "src/repro/kernels/taylor_predict.py:215"),
    "verify_accept": ("src/repro_torch/kernels/csrc/verify_accept.cu",
                      "src/repro/kernels/verify_error.py:72"),
    # the guided verify: the reference reaches the same Pallas verify_sums
    # with tau through ops.verify_accept_mixed (src/repro/kernels/ops.py:320)
    "verify_accept_mixed": ("src/repro_torch/kernels/csrc/verify_accept.cu",
                            "src/repro/kernels/verify_error.py:72"),
    "taylor_predict_chain_lanes": ("src/repro_torch/kernels/csrc/"
                                   "taylor_predict_chain.cu",
                                   "src/repro/kernels/taylor_predict.py:117"),
    "lane_rollback": ("src/repro_torch/kernels/csrc/lane_rollback.cu",
                      "src/repro/kernels/taylor_predict.py:166"),
    "spectral_update_lanes": ("src/repro_torch/kernels/csrc/"
                              "spectral_update_lanes.cu",
                              "src/repro/kernels/spectral.py:51"),
    # the scalar predict is the lane kernel on a one-lane fold
    "taylor_predict": ("src/repro_torch/kernels/csrc/"
                       "taylor_predict_lanes.cu",
                       "src/repro/kernels/taylor_predict.py:37"),
    "taylor_update": ("src/repro_torch/kernels/csrc/taylor_update.cu",
                      "src/repro/kernels/taylor_predict.py:258"),
    "verify_sums": ("src/repro_torch/kernels/csrc/verify_accept.cu",
                    "src/repro/kernels/verify_error.py:72"),
    # the reference's verify_error reaches the τ-less verify_sums kernel;
    # here the verify kernel finishes the error itself (entry verify_error)
    "verify_error": ("src/repro_torch/kernels/csrc/verify_accept.cu",
                     "src/repro/kernels/verify_error.py:114"),
    # flash attention: f32 inputs on the CUDA cores, bf16 on the tensor
    # cores (ops.flash_attention dispatches by dtype)
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:68"),
    "flash_attention_sm90": ("src/repro_torch/kernels/csrc/"
                             "flash_attention_sm90.cu",
                             "src/repro/kernels/flash_attention.py:68"),
}
# the kernels each serving path must launch
SERVE_KERNELS = ("taylor_predict_lanes", "taylor_update_lanes",
                 "verify_accept")
DEEP_KERNELS = ("taylor_predict_chain_lanes", "lane_rollback",
                "taylor_update_lanes", "verify_accept")
SPECTRAL_KERNELS = ("spectral_update_lanes", "taylor_predict_chain_lanes",
                    "lane_rollback", "verify_accept")
GUIDED_KERNELS = ("taylor_predict_lanes", "taylor_update_lanes",
                  "verify_accept_mixed")
GUIDED_DEEP_KERNELS = ("taylor_predict_chain_lanes", "lane_rollback",
                       "verify_accept_mixed")
GUIDED_SCALES = (4.0, 1.5, 4.0, 1.5)       # serve_guided requests 0-3
CONTROLLER_KERNELS = ("taylor_predict_chain_lanes", "lane_rollback",
                      "taylor_update_lanes", "verify_accept")
# the lifecycle session is pair-capable: every row verifies through the
# mixed entry
LIFECYCLE_KERNELS = ("taylor_predict_lanes", "taylor_update_lanes",
                     "verify_accept_mixed")
# the kernels each decode path must launch: depth 1, a depth-4 chain, the
# spectral chain, and the mixed engine (a pair-capable diffusion session
# beside a plain decode session)
DECODE_KERNELS = ("taylor_predict_lanes", "taylor_update_lanes",
                  "verify_accept")
DECODE_DEEP_KERNELS = ("taylor_predict_chain_lanes", "lane_rollback",
                       "taylor_update_lanes", "verify_accept")
DECODE_SPECTRAL_KERNELS = ("spectral_update_lanes",
                           "taylor_predict_chain_lanes", "lane_rollback",
                           "verify_accept")
MIXED_KERNELS = ("taylor_predict_lanes", "taylor_update_lanes",
                 "verify_accept", "verify_accept_mixed")
# lane sharding: the shard counts on one card, and each sharded routing's
# kernel row (the launch-count key of the kernel it launches once a shard)
SHARD_COUNTS = (2, 4)
SHARD_TABLE = (3, 28, 2, LANES, 256, 1152)    # DiT-XL/2's serving table
SHARD_SAMPLE_TOL = 1e-5          # sharded against unsharded samples
SHARDED_KERNEL = {"taylor_predict_lanes_sharded": "taylor_predict_lanes",
                  "taylor_predict_chain_lanes_sharded":
                      "taylor_predict_chain_lanes",
                  "lane_rollback_sharded": "lane_rollback",
                  "taylor_update_lanes_sharded": "taylor_update_lanes",
                  "spectral_update_lanes_sharded": "spectral_update_lanes",
                  "verify_accept_sharded": "verify_accept",
                  "verify_accept_mixed_sharded": "verify_accept_mixed",
                  "verify_accept_pairs_sharded": "verify_accept_mixed"}
# the routing the sharded engine reaches each kernel through
SHARDED_ROUTING = {k: r for r, k in SHARDED_KERNEL.items()
                   if r != "verify_accept_pairs_sharded"}
# per-kernel numbers the kernels line carries beside the contract's keys
# ("decode", "flux": the kernel at the decode phases' shapes and at the
# FLUX-like table, with its launches in serve_decode and serve_flux;
# "video": its launches in serve_video)
ROW_EXTRAS = ("sharded", "decode", "decode_32", "floor_ms", "flux", "video",
              "serve_moe", "serve_ssm",
              "serve_hybrid", "e2e_dit", "device_ms", "event_ms",
              "kernels_per_call", "library_device_ms", "bound_f32_cuda_core_ms", "old_path_ms",
              "old_path_event_ms", "old_path_kernels_per_call",
              "two_step_ms", "two_step_device_ms",
              "two_step_kernels_per_call", "device_ms_by_mask")
# the launch-count keys of the reference's scalar-anchor surface
SCALAR_KEYS = ("taylor_predict", "taylor_update", "verify_sums",
               "verify_error")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # exact f32 products and f32 split-K reductions: the lane width must
    # not change a request's trajectory
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    import dataclasses
    from repro_torch.configs import DIT_XL2, LLAMA3_8B, DiffusionConfig
    smoke = Smoke(torch, "cuda", DIT_XL2, DiffusionConfig(),
                  dataclasses.replace(LLAMA3_8B, num_layers=DECODE_LAYERS))
    smoke.phase("build", smoke.build)
    if smoke.failures:
        return 1
    smoke.phase("kernels", smoke.check_kernels)
    smoke.phase("decode_kernels", smoke.check_decode_kernels)
    smoke.phase("attention", smoke.attention)
    smoke.phase("serve", smoke.serve)
    if "serve" not in smoke.failures:
        smoke.phase("serve_deep", smoke.serve_deep)
        smoke.phase("serve_spectral", smoke.serve_spectral)
        smoke.phase("serve_guided", smoke.serve_guided)
        smoke.phase("serve_controller", smoke.serve_controller)
        smoke.phase("serve_lifecycle", smoke.serve_lifecycle)
        smoke.phase("serve_obs", smoke.serve_obs)
        smoke.phase("speca_sample", smoke.sample)
    # each of these frees its tensors on return; the cache goes back to
    # the card before the next 13–14 GB model
    for name, fn in (("flux_kernels", smoke.check_flux_kernels),
                     ("video_kernels", smoke.check_video_kernels),
                     ("serve_flux", smoke.serve_flux),
                     ("serve_video", smoke.serve_video)):
        smoke.phase(name, fn)
        smoke._release()
    smoke.phase("serve_decode", smoke.serve_decode)
    if not {"serve", "serve_decode"} & set(smoke.failures):
        smoke.phase("serve_mixed", smoke.serve_mixed)
    # lane sharding: D shards on this card, held against the unsharded
    # phases above
    smoke.phase("shard_kernels", smoke.check_shard_kernels)
    if "serve" not in smoke.failures:
        smoke.phase("serve_sharded", smoke.serve_sharded)
    if "serve_decode" not in smoke.failures:
        smoke.phase("serve_decode_sharded", smoke.serve_decode_sharded)
    smoke.lm_params = None
    smoke._release()
    # the rest of decode: each draws its model on the card and frees it
    for name, fn in (("serve_moe", smoke.serve_moe),
                     ("serve_ssm", smoke.serve_ssm),
                     ("serve_hybrid", smoke.serve_hybrid),
                     ("decode_ring", smoke.decode_ring),
                     ("decode_audio", smoke.decode_audio)):
        torch.cuda.reset_peak_memory_stats()
        smoke.phase(name, fn)
        smoke._release()
    # training, checkpoints, the baselines and the launchers: the DiT-XL/2
    # training state is freed before Qwen's
    smoke.phase("train_dit", smoke.train_dit)
    if "train_dit" not in smoke.failures:
        smoke.phase("checkpoint", smoke.checkpoint)
        if "checkpoint" not in smoke.failures:
            smoke.phase("e2e_dit", smoke.e2e_dit)
    smoke.trained = None
    smoke._release()
    for name, fn in (("train_lm", smoke.train_lm), ("cli", smoke.cli),
                     ("dryrun", smoke.dryrun)):
        smoke.phase(name, fn)
        smoke._release()
    smoke.phase("profiler", smoke.profiler)
    card = smi_line()
    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        k = smoke.kernels.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": k.get("launches"),
                     "max_abs_err": k.get("max_abs_err"),
                     "ms": k.get("ms"), "plain_ms": k.get("plain_ms"),
                     "bound_ms": k.get("bound_ms"),
                     "bound_by": k.get("bound_by"),
                     "library_ms": k.get("library_ms")})
        rows[-1].update({x: k[x] for x in ROW_EXTRAS if x in k})
    OUT.mkdir(exist_ok=True)
    smoke.record.update(card=card, kernels=rows,
                        kernel_detail=smoke.kernels, failures=smoke.failures,
                        torch=torch.__version__, cuda=torch.version.cuda)
    (OUT / "chip_smoke.json").write_text(json.dumps(smoke.record, indent=1))
    if smoke.failures:
        print(f"chip_smoke: FAILED phases {smoke.failures}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
