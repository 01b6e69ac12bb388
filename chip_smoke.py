#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (raft_stereo_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero without them,
and imports nothing of JAX or of the JAX package.  Phases, each of which
fails the run when it fails:

1. print the card (name, power limit) and versions; build every CUDA
   kernel from csrc/, one nvcc per source, all started together; print
   each gate-kernel instantiation's registers, spills and shared memory,
   and read the gate library's SASS (``cuobjdump -sass``): every gate
   kernel must contain tensor-core instructions (HGMMA);
2. the pyramid-lookup kernel against its plain version at the main-path
   shapes (96 rows, W1 312, W2 312/156/78/39, radius 4), all four levels
   in one call and each level alone at scale 1/2^i;
3. the ConvGRU gate kernel in fp32 (3xTF32) against its plain version at
   every fp32 gate GEMM of the driven paths (gru08, gru16 and gru32 of a
   384x1248 input, and one training gru08 call at batch 8) and at the odd
   and narrow shapes of the card tests; at the GEMM rows also against an
   fp64 convolution: the kernel's error may be at most 4x the plain fp32
   version's, plus 1e-6 (a single TF32 pass lands ~100x above);
4. timings of both kernels at those shapes: the kernel, its plain
   version, one PyTorch library yardstick the port never calls, and the
   bound from bytes or operations (the gates: 3xTF32 on the tensor cores,
   the CUDA-core figure beside it); every row from CUDA-graph replays (the
   kernels' device time; the replay floor of a one-element kernel is
   printed; the short lookups also as 20 calls per replay with the
   flushes subtracted) and, kernel and library, from single calls, with
   the share of the bound and the factor against the library call (the
   gates also TFLOP/s and each launch's tile and blocks per SM); whether
   the fp32 lookup is slower than ``F.grid_sample`` by graph replay; the
   lookup wrapper's host microseconds per call, with its C entry bound
   once and rebound on every call;
5. the main path: ``InferenceRunner`` on the default config at full
   width with seeded random weights, on a 375x1242 pair (padded to
   384x1248) at 32 iterations; its first call runs the forward eagerly,
   captures it as a CUDA graph and replays it: checks the output and that
   the capture holds 32 lookups and 96 gate calls (the wrappers count the
   warm-up and the capture, twice that); prints seconds per pair by
   replay beside the eager forward (``eager_call``);
6. the same seeded model on the card and on the CPU (plain versions) at
   128x256 and 2 iterations, compared against a stated tolerance;
7. the kernels of the realtime preset against their plain versions at its
   shapes: the alt correlation in bf16 and fp32 (48 rows, W1 156, levels
   156/78/39/19, D 256; all levels in one call and each level alone at
   scale 1/2^l), the bf16 gates at gru08 (1,48,156, Cin 384) and gru16
   (1,24,78, Cin 256), at the training gru08 calls (8,80,180 and the
   realtime step's 8,40,90) and at the card tests' odd shapes, and the
   bf16 pyramid lookup at the shapes of phase 2;
8. timings of those kernels as in phase 4; the alt rows also on a
   coherent center field (``coherent_centers``: a smooth disparity field
   in [0, 24] px at 1/8 resolution, what the model's lookups see) beside
   the random centers, each field by one-call graph replay and as 20
   calls per replay with the flushes subtracted (every alt bound lies
   below the replay floor), with ``plan_fwd``'s tile, channel chunk and
   band rows; and the bf16 alt kernel at the realtime training step's
   shape (8x40 rows, W1 90, W2 90/45/22/11, D 256) on both fields;
9. the realtime path: ``InferenceRunner`` on ``RaftStereoConfig.realtime()``
   with seeded random weights on the 375x1242 pair at 7 iterations (7 alt
   launches, 21 bf16 gate calls, no pyramid lookup, read from the
   capture; seconds per pair by replay and eager, peak memory), then at
   16 iterations, where the runner turns ``corr_fp32`` on (16 alt
   launches in fp32);
10. the realtime preset on the card and on the CPU at 128x256 and 2
   iterations, held to 3x the card's own spread between bf16 and fp32
   correlation on the same input;
11. the backward kernels against their plain versions at the training
   shapes: the lookup backward in fp32 (640 rows, W1 180, levels
   180/90/45/22, and each level alone at 1/2^l), the alt backward in bf16
   and fp32 (320 rows, W1 90, levels 90/45/22/11, D 256, and an odd
   shape), and the gate Function's gradients against autograd through
   its plain twin at gru08 (8, 80, 180, Cin 384); two launches of the
   lookup backward bitwise equal;
12. timings of the backward kernels as in phase 4, the yardstick being
   the autograd backward of the ``F.grid_sample`` formulations (captured
   on the stream of their forwards), the alt backward's plan (channel
   chunk, pixel tile, tensor or CUDA cores), and beside the lookup
   backward a ``torch.zeros`` of its dV bytes, the write floor;
13. the default training step: ``train()`` with ``RaftStereoConfig()``
   fp32 and ``TrainConfig()`` (batch 8, 320x720, 22 iterations) on a
   seeded synthetic loader, one warm-up step and 1 timed step (timed at
   each step's end, ``on_step``, as the loop's prefetcher pulls batches
   ahead of the step); checks
   22 lookups, 22 lookup backwards and 132 gate calls per step (66
   forward, 66 in the remat recompute), finite loss and grad_norm, and
   that the parameters moved; prints seconds per step and peak memory;
14. the realtime training step the same way: 22 alt lookups, 22 alt
   backwards and 132 gate calls per step, all bf16, and no pyramid
   lookup;
15. one step on the card and on the CPU at 64x128 and 2 iterations, of
   the default config and of the realtime architecture in fp32 (which
   drives the fp32 alt backward): loss and grad_norm within stated
   tolerances, every gradient leaf within 3x the card's own spread on
   the same step (cuDNN vs native convolutions, the gate kernel vs plain
   gate convolutions, the weights moved by one fp32 ulp);
16. the quantized tier's kernels against their plain versions: the
   lookup over int8 and fp8 levels at phase 2's shapes (all levels and
   each alone), kernel #9 over int8 and fp8 features at phase 7's shapes
   (all levels, each alone, and an odd shape), each scaled output against
   the dequantize-then-sample reference, with the scale vector left out as
   a check that must fail; the int8 GEMM conv (the realtime cnet's 7x7/2
   conv1, conv2_out's 3x3 128->256) bit-equal to the exact CPU conv;
17. timings of the two 1-byte kernels as in phase 4, #9 also on the
   coherent field and as 20 calls per replay, as in phase 8;
18. the realtime ``int8_mxu`` path: ``InferenceRunner(..., quant=
   "int8_mxu")`` on the 375x1242 pair at 7 iterations (7 int8 #9
   launches, 21 bf16 gate calls, no pyramid lookup, one int8 GEMM per
   encoder conv, read from the capture; seconds per pair by replay and
   eager, and the first call's own peak memory, beside the unquantized
   bf16 path measured the same way), again with
   ``quant_act_scales`` from ``calibrate()`` on the pair, and with
   ``quant_corr_fp8`` (7 fp8 #9 launches);
19. the default ``int8`` path at 32 iterations (32 int8 #1 launches, 96
   gate calls, from the capture; beside the unquantized fp32 path), again
   with ``quant_corr_scales`` from ``calibrate()``, and with
   ``quant_corr_fp8`` (32 fp8 #1 launches);
20. card vs CPU at 128x256 and 2 iterations for the four variants
   (realtime int8_mxu and default int8, int8 and fp8 correlation), held
   to 3x the card's own spread with every weight moved by one fp32 ulp,
   with the share of correlation codes that flipped (the card's codes
   from the runner's eager warm-up);
21. the graphs of the main paths (the runners of phases 5 and 9): one
   capture each and 6 replays after the timed calls, the launch counts
   of each capture, the replay bitwise equal to the eager forward and to
   a second replay, the ``fetch_dtype="fp16"`` result bitwise equal to
   the fp32 result rounded, the capture's milliseconds, replay against
   eager seconds per pair, memory;
22. the graph cache: the three raw KITTI shapes on one graph; with
   ``max_cached_shapes=2`` over three padded shapes replayed A, B, A
   (bitwise equal), then C and B (evicting), the reserved memory after
   each shape, bounded; ``run_batch(4)`` against 4 single calls at
   128x256 and 2 iterations (phase 6's tolerance), and at 375x1242 its
   seconds per pair beside batch 1;
23. the evaluate path: a KITTI-shaped tree of 60 textured pairs in the
   three raw shapes (the right image a warp of the left by a smooth known
   disparity) written with the port's writers, ``cli/evaluate.py main``
   over it with a port checkpoint of the seeded default config at 32
   iterations: one capture for the whole tree (the wrappers count one
   warm-up and one capture), finite EPE and D1, pairs per second past
   the 50-image warm-up;
24. the training entry point: a SceneFlow-shaped tree (48 TRAIN pairs in
   the clean and the final pass, 8 TEST pairs, 540x960, right images
   warped by a smooth known disparity) written with the port's writers,
   ``cli/train.py main`` over it with the default config in fp32, batch
   8, 320x720, 22 iterations, 6 steps, validation on the TEST pairs every
   3 steps and keep-last-1 checkpoints: 22 lookups, 22 lookup backwards
   and 132 gate calls per step (phase 13's counts, the validations'
   launches taken out), finite losses, moved parameters, two validations
   with finite EPE on one runner, the checkpoints left (``6_...`` and the
   final one, manifests verified, none GOOD-stamped), the final
   checkpoint loaded by ``InferenceRunner``; seconds per step past the
   first, the loop's wait for each step's batch, the validation seconds,
   peak memory;
25. on the same tree with ``RaftStereoConfig.realtime()``: a run of 4
   steps against a run stopped by SIGTERM at step 3 and resumed with
   ``restore="latest"`` (the SHA-256 of every batch the loops consumed
   equal; the final parameters bit-equal, or within 3x the card's spread
   between two uninterrupted runs), the uninterrupted run's seconds and
   loader wait per step with the loader's thread workers, again with
   its process workers (the same batches), and over the same batches
   decoded before the run; the anomaly policy over 7 steps with
   NaN flow in the batches of steps 4-6 (the three updates skipped with
   every leaf bit-equal to the step-3 state, one rewind at step 6 to the
   step-4 checkpoint, the rest of the epoch reshuffled, the run finished;
   with ``anomaly_max_rewinds 0`` it raises ``TrainingDiverged``); the
   device jitter's draws on the card equal to the CPU's, one batch's
   ``apply_photometric`` card vs CPU within 1e-4 of 255, two
   ``device_photometric`` steps with finite loss;
26. early exit (``exit_threshold_px``) on the default path (fp32, cap
   32) and the realtime path (bf16, cap 7) at 375x1242, with the settling
   GRU (``settle_state``) on the seeded weights: the per-iteration deltas
   of an eager loop give a threshold between two iterations' deltas (an
   exit strictly between ``min_iters`` 2 and the cap); the exit graph (one
   graph, the loop a CUDA WHILE node whose predicate kernel
   ``exit_predicate`` of ``csrc/graph_loop.cu`` runs on the card): the
   replay bitwise equal to the eager exit loop and to a second replay,
   ``iters_used`` equal, the launches per iteration (one lookup or alt
   call, 3 gate calls, one predicate) and none outside the loop, per pair
   ``iters_used`` times those and equal to the eager loop's counts;
   seconds per pair of the exit graph and of the fixed-depth replay at the
   same depth, replayed in turns, and the exit graph's host overhead per
   iteration; before them the predicate kernel
   against its plain version (trip counts of WHILE loops over bounds,
   deltas and NaN) and its time per iteration beside the host loop's;
27. the confidence map (fixed depth and early exit) card vs CPU at
   128x256, 2 iterations (flows within phase 6's tolerance, the map
   within the bound that gives through exp(-score / 0.25)); ``run_stream``
   over three frames (cold, warm, warm with the hidden state) on the exit
   graphs, the last frame bitwise equal to its eager streaming program;
   ``cli/evaluate.py --sequence --exit_threshold_px --stream_out`` over a
   written KITTI-shaped sequence of 8 pairs: finite cold and warm EPE, the
   passes' mean ``iters_used`` and FPS, the record with the card's name;
28. the drift gates: ``tools/quant_drift --full --steps 10`` (the
   hermetic architecture trained 10 steps at 320x704, calibrated, the five
   variants at 384x1248, bands 48/96/192, depths 7 and 32) and the bf16
   drift's trained leg (the realtime architecture at full width trained
   300 steps, three variants), every row printed with the gate, its
   verdict and the seconds; fails on a missing variant, a non-finite row,
   or the quantized variants' gate kernels and int8 GEMMs not launching
   (the gate's pass or fail is a measurement, not a check); the records
   go to the tools' default, ``raft_stereo_tpu_torch/_build/records/``.
29. telemetry on the card, run right after phase 25 on its tree:
   ``cli/train.py main`` at phase 24's configuration for 7 steps with
   ``--metrics_port 0 --event_log --trace_sample_rate 1.0
   --cost_telemetry --stall_watchdog``, its endpoint scraped from a
   thread while it runs (the step counter and step-time histogram, device
   bytes in use, ``/healthz``, ``/debug/spans``, ``/debug/compiles``
   listing the step with the FLOP formula's count, the MFU gauge in (0,
   1.05]); ``POST /debug/trace`` after step 4, whose Chrome trace must
   name the gate, lookup and lookup-backward kernels; the event log
   replayed (run_start, step stats, run_end, no build inside a step);
   phase 24's launch counts per step, and the median step outside the
   trace window within 5% of the same run's with telemetry off (4 steps,
   just before; phase 24's median printed beside); then the default
   runner with a
   ``CompileRegistry`` at 375x1242 and 32 iterations: one record for its
   one capture, the capture's seconds and memory, FLOPs per pair, the MFU
   at replay time against the card's fp32 peak.
30. serving on the card (``serving/engine.py``, ``serving/http.py``).
   First every reference answer, from runners built for it and dropped
   after (so no runner launch lands in an engine's counts).  (a) the
   realtime preset's engine (bf16, 7 iterations, tiers quality,
   interactive and turbo, batch sizes 1/2/4/8) prewarmed at 375x1242 (one
   capture per distinct tier program and batch size, on the worker's
   thread while another thread scrapes ``/metrics``, ``/readyz`` and the
   device memory; ``/readyz`` 503 before, 200 after; the captures,
   seconds and reserved GiB printed); per tier, the pair alone bitwise
   equal to an ``InferenceRunner`` replay with its ``iters_used``, and
   batches of 2/4/8 distinct pairs, each row bitwise equal to the
   runner's ``run_batch`` of the same stack at the deepest member's
   depth; the quality rows also within phase 10's bound (3x the card's
   bf16 vs fp32-correlation spread on the main pair) of each pair's
   batch-1 answer; each tier's launches per dispatch from its program
   (#6 or #9, the bf16 gates, the predicate, the int8 GEMMs); (a') the
   exit tiers (interactive, and turbo on int8_mxu) at phase 26's
   realtime threshold on its settled weights, batch sizes 1/2/4, over
   the main pair at four contrasts: the same checks, every dispatch
   exiting below the cap, the members of each batch differing in depth
   alone, the batch at the deepest's; (b) the default config's engine
   (fp32, 32 iterations, batch sizes 1/2): the batch-1 answer bitwise
   equal to phase 5's runner's replay, 32 lookups and 96 gate calls per
   dispatch, a batch of two distinct pairs bitwise equal to a runner's
   ``run_batch``; phase 22's eviction check on an engine with
   ``max_cached_shapes=2`` (the reserved memory bounded, a replay and a
   recapture bitwise equal); (c) the HTTP front end: 16 client threads,
   each over a kept-alive connection (``closed_loop``), posting the pair
   as npz for about 5 s on the quality tier (requests
   per second, p50/p99 latency, the mean batch size, which must exceed
   1), a side-by-side PNG round trip (the 16-bit PNG of the batch-1
   answer, byte for byte), a burst past ``max_queue=4`` on the default
   engine (429 with ``Retry-After`` while every admitted request answers
   200), ``/metrics`` with the serve_* families, and ``begin_shutdown``
   then ``drain`` finishing in-flight requests (200) while a new one gets
   503.  The wrappers' counts are set to 0 just before each engine is
   built and read just after its last checked dispatch; the kernels line
   carries (a) plus (a') and (b) as ``launches_serving``.
31. streaming sessions on the serving engine (``serving/sessions.py``,
   ``ServingEngine.submit_session``).  First the references, from runners
   dropped after: ``InferenceRunner.run_stream`` over each chain, under
   the engine's keyframe rule.  (a) the realtime preset's engine on phase
   26's settled weights (bf16, cap 7, tiers quality and interactive at
   phase 26's realtime threshold, ``sessions=True``, batch sizes 1/2/4)
   prewarmed with the session families (state, warm); one session of 8
   frames of the main pair shifted one pixel a frame on the interactive
   tier, each frame bitwise equal to ``run_stream`` fed the same chain; a
   scene cut (the frame darkened to 30%: cold, delta > 40, then warm
   again); the keyframe guard on a tier that never exits (a warm frame at
   the cap reseeds the next one cold); 4 sessions x 8 frames of distinct
   pairs submitted concurrently (each ordered, 4 cold and 28 warm
   frames, mean batch > 1, every flow finite); then an engine with
   ``session_hidden`` (the warm_h family): the chain bitwise equal to
   ``run_stream`` with ``carry_hidden``, and its warm frames exiting
   before its cold one; then flow-only warm starts on trained weights
   (phase 28's bf16 leg: the realtime architecture after 300 steps) on
   the main pair and on a warped textured scene of the training's kind,
   an engine at a threshold from the cold frame's deltas (as phase 26
   takes it): the cold frame must exit there, and the warm frames'
   ``iters_used`` are printed, a measurement (300 steps teach no use of a
   warm start: PERF.md).  (c) HTTP over that engine: ``POST
   /v1/stream/<id>`` for 4 frames (X-Warm, X-Frame-Index), ``DELETE``
   returning the close stats, a 410 ``expired`` past a 2 s TTL, and a 400
   ``sessions_disabled`` from a stateless engine.  (b) the default config's
   engine (fp32, 32 iterations) with the context cache: a chain 4 grey
   levels brighter a frame (past the static gate: warm, not cached)
   bitwise equal to ``run_stream``, and a static scene of 4 frames whose 3
   warm frames hit the cache: the bundle the cold frame saved bitwise
   equal to ``run_stream``'s ``save_ctx`` bundle, each hit to
   ``run_stream`` with ``prev_ctx`` on the saved bundle, and the first
   hit to the plain warm frame from the same state (the context encoder
   run again on the same images).  Printed: seconds per frame
   by family, ``iters_used`` warm against cold, prewarm seconds and
   reserved GiB, launches per frame.  The wrappers' counts are set to 0
   before the realtime engines and before the default one; the kernels
   line carries them as ``launches_sessions``, and each kernel of the
   session path must have launched.
32. selective checkpointing (``remat_save``, models/remat.py), run right
   after phase 15: the default step at ``TrainConfig()`` under
   ``("corr_lookup",)``, ``("corr_lookup", "gru_gates")`` and
   ``("corr_lookup", "gru_gates", "motion_features")``, each one warm-up
   and one timed step: 22 lookups and 22 lookup backwards per step, and
   132 gate calls, or 66 with the gates kept (the recompute launches no
   gate kernel); finite losses, moved parameters; seconds per step and
   the allocator's peak printed per policy.  Then at phase 15's 64x128
   and 2 iterations under cuDNN's deterministic algorithms, each policy's
   loss, metrics and every gradient leaf bit for bit the default
   policy's.  The kernels line carries each policy's counts as
   ``launches_remat``.
33. the native decoders and the loader, run right after phase 29 on
   phase 24's tree: the decoders build at first use with ``g++ -lpng``
   (``raft_stereo_tpu_torch/native``), or the compiler's message is
   printed; where built, a sample of the tree's PNGs and PFMs decoded
   natively bitwise equal to the Python readers, then the realtime step
   over ``StereoLoader``'s thread workers with the native and the Python
   readers in turns (native, Python, native, Python; the Python readers
   by ``native.available`` patched to False), where not built the
   Python readers once: seconds per step and the loop's wait for each
   batch, 22 alt kernels, 22 alt backwards and 132 gate calls per step,
   finite losses.  The kernels line carries the last run's counts as
   ``launches_loader``.
34. the early-exit sweep as ``python -m
   raft_stereo_tpu_torch.tools.early_exit_report --steps 30`` runs it
   (``run``; the tool's default trains 200 steps): its brief training of
   the hermetic architecture (30 steps at 64x96 on warped textured
   scenes, the scenes' disparity range), then
   on those weights the four 60x90 benchmark trees, the fixed baseline at
   16 iterations, the nine thresholds, the chosen point and the tier
   latencies, every exit loop a WHILE-node graph; finite EPE, every
   ``iters_used`` at most the cap, the mean ``iters_used`` not rising as
   the threshold loosens, the gate kernel and the predicate launched and
   the lookup kernel not (the ``reg`` backend samples with the plain
   lookup); the record under ``_build/records/`` with the card's name and
   power limit.  The kernels line carries the run's counts, training
   included, as ``launches_sweep``.
35. the rest of serving's second slice, on the realtime preset (bf16,
   cap 7) and phase 26's settled weights unless stated.  (a) Tiles: a
   1988x2880 pair (Middlebury 2014 full-resolution scale) past
   ``tile_threshold_pixels`` 2,000,000 runs as four 640-row tiles (512
   owned, halo 64) in ONE batch-4 dispatch of the 640x2880 bucket; each
   tile row bitwise equal to the runner's ``run_batch`` of the four
   slices, the stitched flow to ``tiles.stitch`` of those rows; printed:
   the seam EPE, seconds per tiled request (5 requests), launches per
   dispatch (7 #6, 21 #5 bf16).  (b) The cascade: ``tier=auto`` with
   confidence, draft interactive (phase 26's threshold), escalate
   quality, the threshold at the widest gap between the contrast pairs'
   draft confidences: each draft bitwise equal to the exit runner's
   replay, each escalation to the quality runner's, both kinds occurring,
   the counters adding up to the requests; one tiled cascade request.
   Then ``tools/confidence_report`` on phase 34's trained weights (no
   second training): AUROC, Spearman, the cascade's cost and dEPE
   printed as measurements.  (c) The model store: two versions of other
   weights published and registered over ``POST /admin/models``, served
   by ``?model=`` and ``X-Model``, each answer bitwise equal to a runner
   on its weights; the default set, the other version retired under 4
   clients' load: every request 200 with the default's answer, the
   retired model's programs gone (404 after), the allocator's reserved
   bytes under load down by at least what its captures reserved.
   (d) The artifact store: ``tools/compile_farm`` fills a store; a
   ``cli/serve.py`` process from a copy of the package without
   ``_build/`` and the store read-only reaches ``/readyz`` with every
   library it loads fetched and no ``nvcc`` run, its answer bitwise equal
   to this process's; boot to ready printed beside a cold boot that runs
   ``nvcc``.  (e) Handoff: engine A serves 4 sessions (``session_hidden``:
   state_h, warm_h) 3 frames each, then each session's next frame from a
   copy of its state, drains and publishes; engine B adopts each session
   through ``X-Handoff-Artifact``, its next frame bitwise equal to A's
   from the same state; an engine at another depth refuses the blob as
   ``config_mismatch``.  The kernels line carries the realtime engines'
   counts and the report's as ``launches_serving_b``.
36. the fleet (``serving/fleet/``, ``cli/route.py``) over replicas on the
   card, each the port's ``cli/serve.py`` as its own process (launched by
   the fleet's ``LocalProcessLauncher`` from ``serve_argv_template``, from
   a copy of the package without ``_build/``) on phase 26's settled
   realtime weights: tiers quality and interactive at phase 26's
   threshold, batch 1/2, sessions, a shared writable artifact store that
   ``tools/compile_farm`` filled.  First the reference: an in-process
   engine of the replicas' own flags answers the pair on the quality tier
   (7 #6 and 21 #5 bf16 per dispatch, counted) and 4 session chains of 8
   frames shifted 1 px a frame on the exit tier.  (a) Two replicas boot
   in parallel to ``/readyz`` with every kernel library fetched from the
   store and no ``nvcc`` run; a primary router (``--ha_dir``) and a
   traced standby come up over them.  (b) The pair through the router
   byte-identical to the replica that served it directly, both bitwise
   equal to the reference (the replicas' bytes equal to a counted kernel
   run show that their kernels ran).  (f) A sampled request through the
   traced standby: its trace id in the router's ring and the replica's,
   the replica's ``serve.request`` a child of ``route.forward`` in the
   federated ``/debug/spans``, ``/metrics/fleet`` with both replicas'
   ``serve_*`` series under ``replica=`` and one HELP/TYPE per family.
   (h) Measurements: routed against direct latency (p50, p99) of 12
   sequential batch-1 requests, requests per second of 16 clients (each
   over a kept-alive connection) for 3 s through the router over two
   replicas beside one replica directly,
   the replicas' card memory (``nvidia-smi`` memory.used over this
   process's own); no router process opens the card (no ``/dev/nvidia*``
   file: no CUDA context) while the replicas do.
   (c) The 4 sessions through the router; the replica holding the most
   gets SIGTERM before frame 4: every frame 200 (zero 410s), the frame
   index continuous, each frame, the adopted ones included, bitwise equal
   to the reference chain; the drained replica exits 0.  (d) It restarts
   at its address and rejoins; under 4 closed-loop clients the replica
   holding the most of 6 new sessions gets kill -9: every stateless
   request 200, the degraded window (kill to marked dead) printed, each
   lost session 410 ``session_lost`` once and then a cold 200 on the
   survivor, one left owed.  (e) A second standby over the ledger; kill
   -9 of the primary under clients failing over: every request 200, the
   standby takes the lease (takeover seconds printed), the fired losses
   answer 200 (none fires twice) and the owed one 410 once.  (g) A router
   with ``--autoscale_cmd`` (the same serve template) over the survivor:
   16 clients past the engage watermark make it launch a replica, which
   boots from the store and joins rotation; when the load stops the
   scale-down drains it by handoff: zero typed losses, the sessions on it
   warm on the survivor.  Every process started is stopped.  The kernels
   line carries the reference engine's counts as ``launches_fleet``.
37. the banded encoder (``models/banded.py``) on the default config in
   fp32 at full width, seeded weights.  (a) The 1988x2880 pair of phase 35
   (padded to 2016x2880), banded (``default_band_rows``) against
   unbanded: the encoders' outputs (fmap1, fmap2, every context level)
   within 1e-4 of the unbanded ones' largest magnitude, the flows at 3
   iterations within 5e-3 px or 3x the card's own spread (the unbanded
   model with every weight moved by one ulp), whichever is larger; at 32
   iterations, with the allocator's peak
   reset before each, the seconds per pair and ``max_memory_allocated``
   of each (banded below unbanded) and the banded flows' max |d| (no
   bound); 32 #1 and 96 #5 fp32 launches over the banded pair; #1 and #5
   against their plain versions at this path's shapes.  (b) The band
   sweep (128, 256, 512 rows) of fnet's trunk alone on one image: seconds
   and the peak above the input, each band's own working set (the
   segment's last sweep on one band), the slope in bytes per band row and
   image column that ``default_band_rows`` uses, the fastest band.  (c)
   One default training step at ``TrainConfig()``, banded against
   unbanded from the same weights and batch: the losses within 1e-4
   (relative) or 3x the card's spread, whichever is larger, the peak of
   each; 22 #1, 22 #4 and 132 #5 launches.  The
   kernels line carries the counts as ``launches_banded``.
38. data-parallel training (``parallel/distributed.py``, DDP) of the
   default config in fp32 at ``TrainConfig()``'s crop, global batch 2,
   two steps through ``train()``, cuDNN deterministic.  (a) A world of
   one over NCCL in this process: bit for bit the same steps without a
   process group (losses and every parameter); seconds per step; 44 #1,
   44 #4 and 264 #5 launches.  (b) Two ranks of a gloo group on the one
   card, each ``chip_smoke.py --dp-rank`` in a process of its own with
   its slice of every global batch: the ranks bit for bit equal, against
   (a)'s steps without DDP, step by step, losses within 1e-5 (relative)
   and parameters within 5e-4, or 3x the card's own spread where larger
   (the same steps in one process from weights moved by one ulp); seconds
   per step.  (c) The same ranks stopped by a
   SIGTERM to rank 1 after step 1 (both stop at step 1; process 0 writes
   the one checkpoint) and resumed by both: bit for bit the run that
   never stopped.  The kernels line carries (a)'s counts as
   ``launches_data_parallel``.
39. Context parallelism over groups of two made of the one card named
   twice (``parallel/mesh.make_mesh(devices=["cuda:0"] * 2)``), default
   config, fp32.  (a) ``rows_shards=2, rows_gru=True`` on phase 37's
   1988x2880 pair and (b) ``corr_w2_shards=2`` (``reg_fused``) at the
   KITTI bucket, each at ``CP_ITERS`` iterations against the unsharded
   model, within 5e-3 px or 3x the card's own spread (the unsharded
   model on weights moved by one ulp) where larger; seconds and
   ``max_memory_allocated`` of each; 2 #1 launches an iteration (one per
   shard) and 3 #5 an iteration per shard of the loop.  The kernels at
   this slice's shapes against their plain versions: #1 on a rows
   shard's window, #1 at shard-shifted centres (windows wholly outside a
   shard included) against the plain sharded and the unsharded lookup,
   #5 on the windows.  (c) One default step's loss and gradients at
   ``TrainConfig()`` under each axis against the unsharded step (loss
   within 1e-4 relative, the worst per-leaf 99th percentile of the
   gradients' gap within 5e-3 of the leaf's scale, or 3x the one-ulp
   weights' where larger); 44 #1, 44 #4, and 264 (rows) or 132 (corr)
   #5 launches.  22 iterations of random weights are chaotic (the
   one-ulp gap alone is ~0.15 of a leaf's scale), so the same step at
   ``CP_GRAD_ITERS`` iterations holds the gradients where the spread is
   small: a lost halo row's gradient or a mis-reduced moment exchange
   shows there.  (d) An engine with ``xl_mesh="rows=2"`` over that group
   (``xl_devices``) answering a KITTI pair above ``xl_threshold_pixels``
   on the xl tier, and again with ``?tier=xl``, against ``make_forward``
   solo on the same padded pair, and a small pair solo; launch counts
   zeroed before the engine is built.  The kernels line carries each
   count as ``launches_context_parallel``.

The line before the last is a JSON object ``{"kernels": [...]}`` (times
by graph replay; a redesigned row names its design under ``design``; an
inference row's ``launches`` are the wrappers' counts over its path's
first call, the warm-up and the capture, twice the per-pair counts); the
last is ``{"ok": true, "device": {...}}``.  The fp32 path is full fp32:
TF32 is switched off for matmuls and cuDNN convs.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
RADIUS = 4
LEVELS = 4
ROWS, W1 = 96, 312                      # 1/4 of the 384x1248 padded pair
CH = 128
# The gate GEMMs of the driven paths, (name, B, H, W, Ch, Cx, calls per
# iteration of the timed path): the default path's three levels at 1/4,
# 1/8, 1/16 of 384x1248 and one training gru08 call (TrainConfig: batch
# 8, 320x720 at 1/4); the realtime preset's levels (gru16 twice per
# iteration) and training gru08 calls in bf16.
GATE_ROWS_FP32 = (("default gru08", 1, 96, 312, CH, 256, 1),
                  ("default gru16", 1, 48, 156, CH, 256, 1),
                  ("default gru32", 1, 24, 78, CH, 128, 1),
                  ("training gru08", 8, 80, 180, CH, 256, 0))
GATE_ROWS_BF16 = (("realtime gru08", 1, 48, 156, CH, 256, 1),
                  ("realtime gru16", 1, 24, 78, CH, 128, 2),
                  ("training gru08", 8, 80, 180, CH, 256, 0),
                  ("realtime training gru08", 8, 40, 90, CH, 256, 0))
# The odd and narrow gate shapes of tests/test_torch_cuda.py, (name, B, H,
# W, Ch, Cx), the TINY configs' hidden_dims=(32, 32, 32) among them.
GATE_ODD = (("odd", 2, 17, 35, 32, 160), ("odd", 2, 9, 20, 128, 256),
            ("odd", 2, 24, 78, 128, 128), ("odd", 2, 17, 35, 128, 256),
            ("TINY gru08", 2, 16, 32, 32, 160),
            ("TINY gru16", 2, 8, 16, 32, 64), ("TINY gru32", 2, 4, 8, 32, 32))
LOOKUP_ATOL = 1e-5
GATES_ATOL = 1e-4       # sums over up to 9*384 = 3456 fp32 products
# fp32 gates against an fp64 convolution: the kernel's error at most
# GATES_FP64_FACTOR x the plain fp32 version's + GATES_FP64_ATOL (room for
# the tensor cores' own accumulation order).
GATES_FP64_FACTOR, GATES_FP64_ATOL = 4.0, 1e-6
CARD_VS_CPU_ATOL = 1e-2  # two iterations of random weights; see phase 6
MAIN_HW = (375, 1242)
PADDED_HW = (384, 1248)
MAIN_ITERS = 32
# Realtime preset: 1/8 of the 384x1248 padded pair, fnet_dim 256.
RT_ROWS, RT_W1, RT_D = 48, 156, 256
RT_ITERS = 7
RT_DEEP_ITERS = 16      # the runner's corr_fp32 threshold
COHERENT_MAX_DISP = 24.0  # px at 1/8 resolution (phases 8 and 17)
ALT_ATOL = 1e-5         # fp32: dots of 256 products in another order
BF16_ULPS = 1           # bf16 alt and lookup: one ulp + BF16_ATOL
BF16_GATES_ULPS = 2     # bf16 gates: two ulps + BF16_GATES_ATOL (r*h)
BF16_ATOL = 1e-5
BF16_GATES_ATOL = 1e-3  # a flip of r*h moves qpre by a weight x its ulp
RT_SPREAD_FACTOR = 3.0  # phase 10
# Phases 21-23, the runner's CUDA graphs.  The raw KITTI-2015 shapes, all
# padded to 384x1248; three padded shapes of about one size for the
# cache's eviction (A, B, A replays; C evicts B; B evicts A), whose
# reserved memory after the evictions stays within CACHE_MEMORY_FACTOR of
# its value after the second shape (the shapes' buffers differ a little
# in size, so the pool's freed blocks need not fit exactly).
KITTI_SHAPES = ((375, 1242), (370, 1224), (376, 1241))
CACHE_SHAPES = {"A": (384, 1248), "B": (416, 1152), "C": (352, 1344)}
CACHE_ORDER = "ABACB"
CACHE_MEMORY_FACTOR = 1.25
BATCH = 4
KITTI_PAIRS = 60        # > the validator's 50-image warm-up
# Phases 24-25, the training entry point: a SceneFlow-shaped tree at
# SceneFlow's frame size; the CLI run's flags; the resume check's bound on
# the final parameters, a multiple of the card's own spread between two
# uninterrupted runs; the jitter's tolerance (of 255).
SF_HW = (540, 960)
SF_TRAIN_PAIRS, SF_TEST_PAIRS = 48, 8
CLI_STEPS, CLI_VAL_EVERY = 6, 3
RESUME_STEPS = 4
RESUME_SPREAD_FACTOR = 3.0
ANOMALY_STEPS, ANOMALY_POISON = 7, (4, 5, 6)
JITTER_ATOL = 1e-4 * 255
# Training (phases 11-15): TrainConfig()'s batch and crop; feature maps at
# 1/4 (default) and 1/8 (realtime).
TRAIN_B, TRAIN_HW, TRAIN_ITERS = 8, (320, 720), 22
TIMED_STEPS = 1
LOOKUP_BWD_ATOL = 1e-6   # the same taps and products, at most 2 per bin
ALT_BWD_RTOL = 1e-5      # fp32: of each gradient's scale (sum order)
ALT_BWD_BF16_RTOL = 1e-5  # bf16: one ulp + this share of the scale
GATES_BWD_RTOL = 1e-5    # the Function's VJP is the twin's autograd
# Phase 15, card vs CPU after one step: loss and grad_norm relative, and
# each gradient leaf over max(its scale, 1e-3 of the largest gradient),
# held to STEP_SPREAD_FACTOR x the card's own spread on the same step,
# and never below STEP_LEAF_RTOL (4x the JAX package's own spread in the
# CPU tests).  The spread is the largest of: cuDNN's convolutions vs
# native ones; the gate kernel vs the plain gate convolutions
# (fused_gru="off"); and every weight moved by one fp32 ulp.  The fnet
# gradients pass through instance norm's backward, whose cancellation
# amplifies rounding: card vs CPU measured 3.6e-2 on fnet trunk weights of
# the default step, where the first two spreads, which leave the
# instance-norm reductions as they are, gave 9.0e-3.
STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_LEAF_RTOL = 1e-4, 1e-3, 3e-2
STEP_SPREAD_FACTOR = 3.0
# Phases 16-20, the quantized tier.  Kernel vs plain, of the output's
# scale: #1 over 1-byte levels does the plain version's fp32 arithmetic
# (up to FMA contraction); #9 over int8 sums exact integer dots, over fp8
# inexact products in another order.  Card vs CPU: 3x the card's own
# spread when every weight moves by one fp32 ulp (codes flip where the
# card and the CPU round the encoders differently).
LOOKUP_Q_RTOL = 1e-6
ALT_Q_RTOL = {"int8": 1e-6, "fp8": 1e-5}
# The scaled output against the dequantized reference (fp32 products of
# scaled values in another order); leaving the scale vector out moves the
# output by the inverse of the scale, ~1e2-1e3.
SCALED_RTOL = 1e-5
Q_SPREAD_FACTOR = 3.0
# Phases 26-28, early exit, state carry and the drift gates.  The exit
# phases run the settling GRU (``settle_state``) so that the updates
# shrink and a threshold between two iterations' deltas exits strictly
# between EXIT_MIN_ITERS and the cap; the confidence map card vs CPU is
# held to CONF_ATOL, the bound the flows' CARD_VS_CPU_ATOL gives through
# exp(-score / 0.25) (score = dmag + ewma / 2 moves by 3x the flows' bound,
# the map by 4x that).  The sequence tree's pairs; the drift gate's budget.
SETTLE_Z_BIAS = -1.0
EXIT_MIN_ITERS = 2
CONF_ATOL = 12 * CARD_VS_CPU_ATOL
SEQ_PAIRS = 8
GATE_PX = 0.05
# Phase 29, telemetry on the card: the steps of the training run and of
# its telemetry-off control run just before it, the step after which the
# trace window opens and its length, the step time's bound against the
# control's (the instruments add host work only; phase 24's median is
# printed beside, but a default step ran 3.40 s before phase 24's first
# validation and 2.90 s after it, PERF.md section 6), and the kernels the
# window's trace must name (csrc/gru_gates.cu, csrc/corr_lookup.cu).
TELEMETRY_STEPS = 7
TELEMETRY_CONTROL_STEPS = 4
TELEMETRY_TRACE_AFTER = 4
TELEMETRY_TRACE_MS = 5000
TELEMETRY_STEP_RTOL = 0.05
TELEMETRY_KERNELS = ("gates_conv_kernel", "corr_lookup_kernel",
                     "corr_lookup_bwd_kernel")
# Phase 30, serving: the realtime engine's tiers and ladder, the closed
# loop's clients and seconds, the burst engine's queue bound, and the
# serve_* families /metrics must hold.
SERVE_TIERS = ("quality", "interactive", "turbo")
SERVE_SIZES = (1, 2, 4, 8)
# ... and the exit engine on settled weights (phase 26's realtime
# threshold): its ladder, and the contrasts of its pairs (1 exits after 5
# iterations, the others sooner), so that a batch's members differ in depth
SERVE_EXIT_SIZES = (1, 2, 4)
SERVE_CONTRASTS = (1.0, 0.25, 0.5, 0.1)
SERVE_CLIENTS = 16
SERVE_LOAD_S = 5.0
SERVE_BURST_QUEUE = 4
SESSION_FRAMES = 8       # phase 31: frames of a realtime chain
SESSION_CLIENTS = 4      # concurrent realtime sessions
SESSION_SIZES = (1, 2, 4)
SESSION_DEF_FRAMES = 4   # frames of a default-engine chain
SESSION_TTL_S = 2.0      # the HTTP leg's engine: a 410 after it
SCENE_CUT_DIM = 0.3      # a cut: the frame darkened to 30%
# Phase 32: the remat policies of a default step (TrainConfig()), each one
# warm-up and REMAT_TIMED_STEPS timed steps; gradients bit for bit at
# phase 15's shape under cuDNN's deterministic algorithms.
REMAT_POLICIES = (("corr_lookup",), ("corr_lookup", "gru_gates"),
                  ("corr_lookup", "gru_gates", "motion_features"))
REMAT_TIMED_STEPS = 1
# phase 28's quant gate trains this many steps, not --full's 300: the
# script's budget (its 300 took 217 s of a 1134 s run on a slow host)
DRIFT_GATE_STEPS = 10
SWEEP_TRAIN_STEPS = 30   # phase 34's training (the tool's default: 200)
# Phase 33: decoded files compared per kind, realtime steps per loader run
# and the turns (native and Python readers alternating in one process).
DECODE_SAMPLE = 8
LOADER_STEPS = 5
LOADER_TURNS = ("native", "python", "native", "python")
TILE_HW = (1988, 2880)   # phase 35: Middlebury 2014 full-resolution scale
TILE_THRESHOLD = 2_000_000
TILE_ROWS = 512
TILE_HALO = 64
TILE_REPS = 5            # timed tiled requests
MODEL_LOAD_CLIENTS = 4   # clients sending while a model retires
HANDOFF_SESSIONS = 4
HANDOFF_FRAMES = 3       # frames before the drain
FLEET_SESSIONS = 4       # phase 36 (c): sessions through the router
FLEET_FRAMES = 8         # frames a session, shifted 1 px a frame
FLEET_DRAIN_AT = 4       # frames before the SIGTERM
FLEET_KILL_SESSIONS = 6  # (d): sessions open when a replica is killed
FLEET_CLIENTS = 16       # (h): closed-loop clients
FLEET_LOAD_S = 3.0       # (h): seconds of each closed loop
FLEET_LATENCY_REPS = 12  # (h): sequential requests, routed and direct
# Phase 37, the banded encoder: flows compared at this depth (an untrained
# GRU amplifies reassociation from one iteration to the next), the
# encoders' bound (max |d| over max |ref|), the flows' bound (the JAX
# package's own banded-model bound at 64x96, tests/test_banded.py), the
# training step's loss bound, and the bands of the sweep.
BANDED_CHECK_ITERS = 3
BANDED_ENC_RTOL = 1e-4
BANDED_FLOW_ATOL = 5e-3
BANDED_LOSS_RTOL = 1e-4
BAND_SWEEP = (128, 256, 512)
# Random weights amplify reassociation from one iteration to the next: the
# flows at 3 iterations and the training step's loss may also lie within
# this factor of the card's own spread (every weight moved by one ulp).
BANDED_SPREAD_FACTOR = 3.0
# Phase 38, data parallelism at TrainConfig()'s crop: the global batch,
# the steps, the bounds of two ranks against one process (the gradient
# all-reduce sums in another order; AdamW turns that into parameter steps
# of order lr, tests/test_torch_distributed.py), and the ranks' time limit.
DP_BATCH = 2
DP_STEPS = 2
DP_LOSS_RTOL = 1e-5
DP_PARAM_ATOL = 5e-4
# ... or, where larger, this factor of the card's own spread over the same
# steps (one process from weights moved by one ulp): 22 iterations of
# random weights amplify the reassociation of a batch split in two.
DP_SPREAD_FACTOR = 3.0
DP_WORKER_TIMEOUT = 300
# phase 39: context parallelism over a group of two, the one card named
# twice (parallel/mesh.py)
CP_ITERS = 4              # (a), (b): iterations of the sharded pairs
CP_FLOW_ATOL = 5e-3       # px, or 3x the card's one-ulp spread if larger
CP_LOSS_RTOL = 1e-4       # (c): the step's loss, likewise
CP_GRAD_Q99 = 5e-3        # (c): per-leaf q99 of |d| / the leaf's scale
CP_SPREAD_FACTOR = 3.0
CP_GRAD_ITERS = 3         # (c): the step whose gradients are held tight
CP_XL_THRESHOLD = 400_000  # (d): the KITTI bucket, 384x1248, routes xl
SERVE_FAMILIES = ("serve_requests_admitted_total",
                  "serve_requests_completed_total", "serve_batches_total",
                  "serve_dispatches_total", "serve_queue_wait_seconds",
                  "serve_total_latency_seconds", "serve_device_seconds",
                  "serve_requests_rejected_queue_full_total",
                  "infer_gru_iters_used")
# Published peaks of the H100 SXM (NVIDIA data sheet, 700 W): memory
# bytes/s, fp32 FLOP/s on the CUDA cores, and on the tensor cores dense
# TF32 and bf16 FLOP/s and dense int8/fp8 operations/s.
MEM_RATE = 3.35e12
FP32_RATE = 67e12
TF32_RATE = 495e12
BF16_RATE = 989e12
INT8_RATE = 1979e12


def log(msg: str) -> None:
    print(msg, flush=True)


def smooth_noise(rng, h: int, w: int, cell: int) -> np.ndarray:
    """(h, w, 3) noise in [0, 1): a random grid of ``cell``-pixel cells,
    bilinearly interpolated."""
    g = rng.random((h // cell + 2, w // cell + 2, 3))
    ys, xs = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = ys.astype(np.int64), xs.astype(np.int64)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx
    bottom = g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bottom * fy


def kitti_pair(rng, canvas, hw):
    """``(left, right, disparity)``: a textured left image (a random crop
    of ``canvas``), and a right image that is a true warp of it by a
    smooth known disparity (5 to ~50 px), ``right[y, x] = left[y, x +
    d(y, x)]``."""
    h, w = hw
    y0 = int(rng.integers(0, canvas.shape[0] - h + 1))
    x0 = int(rng.integers(0, canvas.shape[1] - w + 1))
    left = canvas[y0:y0 + h, x0:x0 + w]
    y, x = np.mgrid[0:h, 0:w]
    disp = (5 + 40 * x / w + 6 * np.sin(2 * np.pi * y / h
                                        + rng.uniform(0, 2 * np.pi))
            ).astype(np.float32)
    src = np.clip(x + disp, 0, w - 1)
    xl = np.floor(src).astype(np.int64)
    xr = np.minimum(xl + 1, w - 1)
    fx = (src - xl)[..., None]
    right = ((1 - fx) * left[y, xl] + fx * left[y, xr]).astype(np.uint8)
    return np.ascontiguousarray(left), right, disp


def write_kitti_tree(root: str, n: int, seed: int) -> None:
    """``n`` pairs in the KITTI-2015 layout, cycling through the raw
    shapes, cropped from one textured canvas (noise at four scales), the
    GT written by the port's writer with 30% of it dropped (KITTI's GT is
    sparse; 0 = invalid)."""
    from PIL import Image

    from raft_stereo_tpu_torch.data.frame_utils import write_disp_kitti

    rng = np.random.default_rng(seed)
    ch = 2 * max(h for h, _ in KITTI_SHAPES)
    cw = 2 * max(w for _, w in KITTI_SHAPES)
    canvas = (255 * sum(weight * smooth_noise(rng, ch, cw, cell)
                        for cell, weight in ((64, 0.4), (16, 0.3), (4, 0.2),
                                             (1, 0.1)))).astype(np.uint8)
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, "training", sub))
    for i in range(n):
        left, right, disp = kitti_pair(rng, canvas, KITTI_SHAPES[i % 3])
        disp[rng.random(disp.shape) < 0.3] = 0.0
        name = f"{i:06d}_10.png"
        for sub, img in (("image_2", left), ("image_3", right)):
            Image.fromarray(img).save(
                os.path.join(root, "training", sub, name), compress_level=0)
        write_disp_kitti(os.path.join(root, "training", "disp_occ_0", name),
                         disp)


def write_sceneflow_tree(root: str, n_train: int, n_test: int,
                         seed: int) -> None:
    """A FlyingThings3D-shaped tree at ``SF_HW``: ``n_train`` TRAIN pairs
    in the clean and the final pass (the final pass hard-linked to the
    clean one), the passes ``build_training_mixture(("sceneflow",))``
    reads, and ``n_test`` TEST pairs in the final pass, which
    ``validate_things`` reads; textured left images cropped from one
    canvas, right images warped by a smooth known disparity, written as
    PFMs by the port's writer."""
    from PIL import Image

    from raft_stereo_tpu_torch.data.frame_utils import write_pfm

    rng = np.random.default_rng(seed)
    h, w = SF_HW
    canvas = (255 * sum(weight * smooth_noise(rng, 2 * h, 2 * w, cell)
                        for cell, weight in ((64, 0.4), (16, 0.3), (4, 0.2),
                                             (1, 0.1)))).astype(np.uint8)
    things = os.path.join(root, "FlyingThings3D")
    for split, n in (("TRAIN", n_train), ("TEST", n_test)):
        for i in range(n):
            left, right, disp = kitti_pair(rng, canvas, SF_HW)
            seq = os.path.join(split, "A", f"{i:04d}")
            passes = (("frames_cleanpass", "frames_finalpass")
                      if split == "TRAIN" else ("frames_finalpass",))
            for side, img in (("left", left), ("right", right)):
                first = None
                for dstype in passes:
                    d = os.path.join(things, dstype, seq, side)
                    os.makedirs(d)
                    path = os.path.join(d, "0006.png")
                    if first is None:
                        Image.fromarray(img).save(path, compress_level=1)
                        first = path
                    else:
                        os.link(first, path)
            d = os.path.join(things, "disparity", seq, "left")
            os.makedirs(d)
            write_pfm(os.path.join(d, "0006.pfm"), disp)


def batch_sha(batch) -> str:
    """SHA-256 over a host batch's arrays, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def zero_inference_counts() -> None:
    """Every inference kernel wrapper's launch count to 0."""
    from raft_stereo_tpu_torch.kernels.corr_alt import (alt_lookup_fused,
                                                        alt_lookup_fused_q)
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_fused, lookup_pyramid_fused_q)
    from raft_stereo_tpu_torch.kernels.gru_fused import gru_gates_fused
    from raft_stereo_tpu_torch.kernels.graph_loop import exit_predicate
    from raft_stereo_tpu_torch.quant.matmul import int8_conv_int32
    for fn in (lookup_pyramid_fused, lookup_pyramid_fused_q,
               alt_lookup_fused, alt_lookup_fused_q, gru_gates_fused,
               int8_conv_int32, exit_predicate):
        fn.launches = 0


def capture_pair(runner, left, right, keys):
    """The runner's first call at the pair's padded shape, with every
    inference wrapper's count set to 0 just before it and read just after.
    That call runs the forward twice through the wrappers, the warm-up and
    the capture, and then replays the graph.  Returns ``(flow, counts,
    per_pair)`` over ``keys``: the wrappers' counts, and the counts the
    capture saw (one forward's launches; a replay runs no wrapper)."""
    from raft_stereo_tpu_torch.eval.runner import launch_counts

    zero_inference_counts()
    captures = runner.captures
    flow, _ = runner(left, right)
    got = launch_counts()
    if runner.captures != captures + 1:
        raise AssertionError("a first call at a new shape must capture")
    graph = list(runner._compiled.values())[-1]    # the LRU's newest
    counts = {k: got[k] for k in keys}
    per_pair = {k: graph.launches[k] for k in keys}
    if counts != {k: 2 * v for k, v in per_pair.items()}:
        raise AssertionError(f"wrapper counts {counts} are not those of "
                             f"the warm-up and the capture {per_pair}")
    return flow, counts, per_pair


def eager_call(runner, left, right):
    """The runner's closure (``make_forward``) called eagerly, with no
    graph, on the runner's clock: host pad, upload, forward, copy to the
    host, unpad.  Returns ``(flow, seconds)``."""
    from raft_stereo_tpu_torch.eval.runner import make_forward
    from raft_stereo_tpu_torch.ops.padding import InputPadder

    t0 = time.perf_counter()
    padder = InputPadder((1, 3) + left.shape[:2], divis_by=runner.divis_by)
    pl, pr, pt, pb = padder.pads
    spec = ((pt, pb), (pl, pr), (0, 0))
    forward = make_forward(runner.model, runner.iters, runner.fetch_dtype)
    with torch.inference_mode():
        flow = forward(*[torch.from_numpy(np.pad(im, spec, mode="edge")[
            None]).to(runner.device) for im in (left, right)])
        if isinstance(flow, tuple):         # early exit: (flow, iters_used)
            runner.eager_iters_used = int(flow[1])
            flow = flow[0]
        out = padder.unpad(flow)[0].float().cpu().numpy()
    return out, time.perf_counter() - t0


def replay_and_eager_seconds(runner, left, right, reps: int = 5):
    """Seconds per pair of ``reps`` replays (after the capture) and of
    ``reps`` eager calls after one eager warm-up."""
    secs = [runner(left, right)[1] for _ in range(reps)]
    eager_call(runner, left, right)
    return secs, [eager_call(runner, left, right)[1] for _ in range(reps)]


def time_ms(fn, flush, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each after a
    write of a buffer larger than L2 so that the call finds L2 cold."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def window_bins(coords, w2s) -> int:
    """Distinct bins inside [0, W2_l - 1] that the windows of these
    centers touch, summed over pixels and levels."""
    total = 0
    for i, w2 in enumerate(w2s):
        c = coords.double() / 2 ** i
        lo = torch.floor(c - RADIUS).clamp(0, w2 - 1)
        hi = (torch.floor(c + RADIUS) + 1).clamp(0, w2 - 1)
        inside = (torch.floor(c + RADIUS) + 1 >= 0) & (
            torch.floor(c - RADIUS) <= w2 - 1)
        total += int(torch.where(inside, hi - lo + 1, 0).sum())
    return total


def coherent_centers(gen, b: int, rows: int, w1: int) -> torch.Tensor:
    """(b, rows, w1) centers c = x - d of a seeded smooth disparity field d
    in [0, COHERENT_MAX_DISP] px: a uniform grid with a node every 8
    pixels, upsampled bilinearly (so d stays in range).  At 1/8 resolution
    that is 0-192 px at full resolution, KITTI's range: what the model's
    lookups see, where the random centers of phase 7 are its worst case."""
    coarse = torch.rand((b, 1, rows // 8 + 2, w1 // 8 + 2),
                        generator=gen) * COHERENT_MAX_DISP
    d = F.interpolate(coarse, size=(rows, w1), mode="bilinear",
                      align_corners=True)[:, 0]
    return torch.arange(w1, dtype=torch.float32) - d


def lookup_bytes(coords, w2s, itemsize: int = 4) -> int:
    """Bytes the lookup must move for these centers: each distinct volume
    bin a window touches (read once), the centers, and the output."""
    k = len(w2s) * (2 * RADIUS + 1)
    return (window_bins(coords, w2s) * itemsize + coords.numel() * 4
            + coords.numel() * k * itemsize)


def bf16_ulp_error(got, want, ulps: int, atol: float):
    """(max |got - want|, whether every value is within ``ulps`` bf16
    ulps of ``want`` plus ``atol``)."""
    want = want.float()
    _, exp = torch.frexp(want.abs().clamp_min(torch.finfo(torch.float32).tiny))
    bound = ulps * torch.ldexp(torch.ones_like(want), exp - 8) + atol
    err = (got.float() - want).abs()
    return float(err.max()), bool((err <= bound).all())


def alt_library(f1, pyramid, coords):
    """The reference's PyTorch formulation of the no-volume correlation
    (PytorchAlternateCorrBlock1D): ``F.grid_sample`` of each pooled level
    of the right features at the window positions, then the dot with the
    left features, in fp32 (the reference runs it in fp32).  Each row is
    its own 1-row image, so the vertical coordinate is exact."""
    b, h, w1, d = f1.shape
    rows = b * h
    taps = torch.arange(-RADIUS, RADIUS + 1, device=f1.device,
                        dtype=torch.float32)
    f1t = f1.float().reshape(rows, w1, d).permute(0, 2, 1)[..., None]
    outs = []
    for i, f2 in enumerate(pyramid):
        w2 = f2.shape[2]
        x = coords.reshape(rows, w1, 1) / 2 ** i + taps
        gx = (2 * x / (w2 - 1) - 1).reshape(rows, 1, -1)
        grid = torch.stack([gx, torch.zeros_like(gx)], dim=-1)
        src = f2.float().reshape(rows, w2, d).permute(0, 2, 1)[:, :, None]
        s = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True).reshape(rows, d, w1, -1)
        outs.append((s * f1t).sum(1) / math.sqrt(d))
    return torch.cat(outs, dim=-1).reshape(b, h, w1, -1)


def max_rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def leaf_errs(got, want):
    """Gradient-leaf differences, largest first: (error, name), each over
    max(the leaf's scale, 1e-3 of the largest gradient).  The floor keeps
    conv biases in front of instance norm, whose gradient is rounding
    noise, from dividing by it."""
    scale = max(float(g.abs().max()) for g in want.values())
    return sorted(((float((got[n] - g).abs().max())
                    / max(float(g.abs().max()), 1e-3 * scale), n)
                   for n, g in want.items()), reverse=True)


def graph_ms(fn, flush, reps: int = 20, stream=None) -> float:
    """Median device time of ``fn`` replayed from a CUDA graph, each replay
    after a write of a buffer larger than L2: the time of its kernels
    without the host's launch overhead (``time_ms`` includes it, and where
    the host takes longer than the kernels it times the host).  ``stream``
    is the capture stream: an autograd backward runs its kernels on the
    stream of its forward, so a backward is captured on the stream its
    forward ran on."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_each_ms(fn, flush, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn`` without the replay's own floor:
    a graph of ``calls`` x (flush, ``fn``) against a graph of ``calls``
    flushes alone, replayed in turns; the median difference over ``reps``
    pairs of replays, per call.  Each call still finds L2 cold."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    both, flushes = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(both):
        for _ in range(calls):
            flush.zero_()
            fn()
    with torch.cuda.graph(flushes):
        for _ in range(calls):
            flush.zero_()

    def replay_ms(graph):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return statistics.median(replay_ms(both) - replay_ms(flushes)
                             for _ in range(reps)) / calls


def timed(kernel, plain, library, flush, lib_stream=None) -> dict:
    """A kernel, its plain version and its library call, each by CUDA-graph
    replay (``ms``, ``plain``, ``lib``: device time), the kernel and the
    library also as single calls (``single``, ``lib_single``: the host's
    launch work counts where it is slower than the device)."""
    return {"ms": graph_ms(kernel, flush), "single": time_ms(kernel, flush),
            "plain": graph_ms(plain, flush),
            "lib": graph_ms(library, flush, stream=lib_stream),
            "lib_single": time_ms(library, flush)}


def describe(t: dict, library: str, bound: float, by: str) -> str:
    """One log line's timing: graph replay, single call, bound and share."""
    return (f"kernel {t['ms']:.4f} ms by graph replay (single call "
            f"{t['single']:.4f}), plain {t['plain']:.4f}, {library} "
            f"{t['lib']:.4f} (single call {t['lib_single']:.4f}; "
            f"{t['lib'] / t['ms']:.2f}x the kernel), bound {bound:.5f} ms "
            f"({by}): {bound / t['ms']:.1%} of the bound")


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` (its launches queue on the
    device; the device is synchronised outside the timed loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def gate_args(gen, dev, shape, dtype):
    """Seeded gate inputs for (B, H, W, Ch, Cx): h = tanh(normal), x and cr
    normal, weights at He scale in ``dtype``, fp32 biases."""
    b, h, w, ch, cx = shape
    cin = ch + cx
    ws = (2 / (9 * cin)) ** 0.5

    def rnd(*shp, scale=1.0, dt=dtype):
        return (scale * torch.randn(shp, generator=gen)).to(dev, dt)

    return (torch.tanh(rnd(b, h, w, ch)), rnd(b, h, w, cx), rnd(b, h, w, ch),
            rnd(3, 3, cin, 2 * ch, scale=ws),
            rnd(2 * ch, scale=0.1, dt=torch.float32),
            rnd(3, 3, cin, ch, scale=ws), rnd(ch, scale=0.1, dt=torch.float32))


def gates_fp64(h, x, cr, wzr, bzr, wq, bq):
    """The gate function in fp64 (cuDNN's fp64 convolutions): the yardstick
    both the fp32 kernel and its plain fp32 version are held against."""
    def conv(inp, k):
        return F.conv2d(inp.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)

    ch = h.shape[-1]
    h, x, cr = h.double(), x.double(), cr.double()
    zr = conv(torch.cat([h, x], -1), wzr.double()) + bzr.double()
    r = torch.sigmoid(zr[..., ch:] + cr)
    return zr, conv(torch.cat([r * h, x], -1), wq.double()) + bq.double()


def gates_library(args):
    """One PyTorch call computing the gate function, the port never calls
    it: two ``F.conv2d`` (cuDNN) and the sigmoid coupling, NCHW, in the
    activations' dtype."""
    h, x, cr, wzr, bzr, wq, bq = args
    dt, ch = h.dtype, h.shape[-1]
    hh, xx, cc = (a.permute(0, 3, 1, 2).contiguous() for a in (h, x, cr))
    wz, wqq = (w.permute(3, 2, 0, 1).contiguous() for w in (wzr, wq))
    bz, bqq = bzr.to(dt), bq.to(dt)

    def call():
        zr = F.conv2d(torch.cat([hh, xx], 1), wz, bz, padding=1)
        r = torch.sigmoid(zr[:, ch:] + cc)
        return zr, F.conv2d(torch.cat([r * hh, xx], 1), wqq, bqq, padding=1)

    return call


_GATE_KERNEL = re.compile(r"gates_conv_kernelI(f|13__nv_bfloat16)Li(\d+)ELi"
                          r"(\d+)ELi(\d+)ELb([01])E")


def gate_instance(mangled: str):
    """'fp32 BN 128 WG 2 KS 1 zr' for a mangled gate-kernel name, else
    None."""
    m = _GATE_KERNEL.search(mangled)
    if m is None:
        return None
    return (f"{'fp32' if m.group(1) == 'f' else 'bf16'} BN {m.group(2)} WG "
            f"{m.group(3)} KS {m.group(4)} "
            f"{'zr' if m.group(5) == '1' else 'q'}")


def gate_ptxas(report: str):
    """{instance: 'N registers, ...'} from the gate library's ptxas -v."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            name = gate_instance(line)
        elif name and "spill" in line:
            out[name] = line.strip()
        elif name and "registers" in line:
            out[name] = f"{line.split(':', 1)[1].strip()}; {out.get(name, '')}"
    return out


def gate_sass(sass: str):
    """{instance: {tensor-core opcode: count}} from ``cuobjdump -sass``."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = gate_instance(line)
            if name:
                out[name] = {}
        elif name:
            m = re.search(r"\b(HGMMA|HMMA)(\.[\w.]+)?", line)
            if m:
                op = m.group(0)
                out[name][op] = out[name].get(op, 0) + 1
    return out


def cuobjdump(nvcc: str) -> str:
    """The toolkit's cuobjdump, else the copy in Triton's package."""
    found = [os.path.join(os.path.dirname(nvcc), "cuobjdump")]
    try:
        import triton
        found.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for path in found:
        if os.path.exists(path):
            return path
    raise RuntimeError(f"no cuobjdump (looked at {found})")


def settle_state(state):
    """A copy of a port state dict with a settling GRU: the candidate
    state q and the update gate's input weights zeroed, the gate held at
    sigmoid(SETTLE_Z_BIAS), the flow head's biases zeroed.  Every hidden
    state then decays by 0.73 an iteration and the disparity updates
    shrink geometrically, as a trained network's settle (random weights
    make them grow); the other weights stay random, every kernel runs."""
    state = {k: v.clone() for k, v in state.items()}
    for key in list(state):
        if key.endswith((".convq.weight", ".convq.bias",
                         "flow_head.conv1.bias", "flow_head.conv2.bias")):
            state[key].zero_()
        elif key.endswith((".convzr.weight", ".convzr.bias")):
            n = state[key].shape[0] // 2
            state[key][:n] = SETTLE_Z_BIAS if key.endswith("bias") else 0
        elif key.startswith("context_zqr_conv"):
            n = state[key].shape[0] // 3
            state[key][:n] = 0
            state[key][2 * n:] = 0
    return state


def padded_batch(runner, left, right):
    """The runner's padded (1, Hp, Wp, 3) inputs on its device."""
    from raft_stereo_tpu_torch.ops.padding import InputPadder

    pl, pr, pt, pb = InputPadder((1, 3) + left.shape[:2],
                                 divis_by=runner.divis_by).pads
    spec = ((pt, pb), (pl, pr), (0, 0))
    return [torch.from_numpy(np.pad(im, spec, mode="edge")[None]).to(
        runner.device) for im in (left, right)]


def loop_deltas(model, p1, p2, iters, flow_init=None):
    """``(deltas, disp)``: each iteration's exit quantity from an eager
    fixed-depth loop over ``model`` (from ``flow_init`` where given), and
    the final low-resolution disparity."""
    out = []
    with torch.inference_mode():
        step, net, disp, _ = model.begin(p1, p2, flow_init)
        for _ in range(iters):
            net, new, _mask = step(net, disp)
            out.append(float(model.batch_delta((new - disp).abs())))
            disp = new
    return out, disp


def iteration_deltas(runner, left, right, iters: int):
    """Each iteration's exit quantity (the worst member's mean |delta|),
    from an eager fixed-depth loop over the runner's model."""
    return loop_deltas(runner.model, *padded_batch(runner, left, right),
                       iters)[0]


def exit_threshold(deltas, min_iters: int, cap: int):
    """``(threshold, iters_used)``: the midpoint of the deltas of the
    iterations j - 1 and j, j the middle of (min_iters, cap), and the trip
    count the plain predicate gives with it (strictly between the
    bounds, or the deltas did not shrink)."""
    from raft_stereo_tpu_torch.kernels.graph_loop import exit_continues, f32

    j = (min_iters + cap + 1) // 2
    thr = f32((deltas[j - 2] + deltas[j - 1]) / 2)
    it, delta = 0, math.inf
    while exit_continues(it, delta, min_iters, cap, thr):
        delta, it = deltas[it], it + 1
    if not min_iters < it < cap:
        raise AssertionError(f"deltas {deltas} give no exit strictly "
                             f"between {min_iters} and {cap}")
    return thr, it


def phase_exit(what, cfg, state, cap, left, right, card, rounds: int = 10):
    """Phase 26 on one path: the exit loop's graph against the eager exit
    loop, bit for bit with ``iters_used``; launch counts; its seconds per
    pair beside the fixed-depth replay at the same depth (the two replayed
    in turns, fixed, while, while, fixed, ``rounds`` times), and its host
    overhead per iteration."""
    from raft_stereo_tpu_torch.eval.runner import (InferenceRunner,
                                                   launch_counts)

    settled = settle_state(state)
    probe = InferenceRunner(cfg, settled, iters=cap, device="cuda")
    deltas = iteration_deltas(probe, left, right, cap)
    del probe
    thr, used = exit_threshold(deltas, EXIT_MIN_ITERS, cap)
    corr = "alt" if cfg.corr_backend == "alt" else "lookup"
    per_iter = {corr: 1, "gates": 3}
    fixed = InferenceRunner(cfg, settled, iters=used, device="cuda")
    fixed_flow = fixed(left, right)[0]
    log(f"exit, {what} path (settled weights, cap {cap}, min_iters "
        f"{EXIT_MIN_ITERS}): per-iteration deltas "
        f"{[round(d, 5) for d in deltas]}, threshold {thr:.6g} -> "
        f"iters_used {used}")
    out = {"threshold": thr, "iters_used": used, "deltas": deltas}
    r = InferenceRunner(cfg, settled, iters=cap, device="cuda",
                        exit_threshold_px=thr, exit_min_iters=EXIT_MIN_ITERS)
    zero_inference_counts()
    flow = r(left, right)[0]
    counts = {k: v for k, v in launch_counts().items() if v}
    (entry,) = r._compiled.values()
    got_used = r.last_iters_used
    again = r(left, right)[0]
    zero_inference_counts()
    eager, _ = eager_call(r, left, right)
    eager_counts = {k: v for k, v in launch_counts().items() if v}
    body = {k: v for k, v in entry.body_launches.items() if v}
    outer = {k: v for k, v in entry.launches.items() if v}
    pair = {k: v for k, v in entry.pair_launches(got_used).items() if v}
    # the wrappers count the warm-up's eager loop (used iterations) and
    # the capture's one iteration
    want_counts = {k: (used + 1) * v for k, v in per_iter.items()}
    want_counts["exit"] = 1
    ok = (got_used == used == r.eager_iters_used
          and np.array_equal(flow, eager) and np.array_equal(flow, again)
          and body == dict(per_iter, exit=1) and not outer
          and {k: v for k, v in pair.items() if k != "exit"}
          == {k: used * v for k, v in per_iter.items()} == eager_counts
          and counts == want_counts)
    log(f"exit, {what}, WHILE graph: iters_used {got_used} (eager "
        f"{r.eager_iters_used}); replay bitwise equal to the eager exit "
        f"loop {np.array_equal(flow, eager)} (max |d| "
        f"{np.abs(flow - eager).max():.3e}), to a second replay "
        f"{np.array_equal(flow, again)}, to the fixed-depth replay at "
        f"{used} iterations {np.array_equal(flow, fixed_flow)}; launches "
        f"per iteration {body}, outside the loop {outer}, per pair "
        f"{pair}, eager per pair {eager_counts}; the wrappers' counts "
        f"over the first call {counts}; capture "
        f"{1e3 * entry.capture_s:.1f} ms: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"exit {what}: checks failed")
    runners = {"fixed": fixed, "while": r}
    secs = {k: [] for k in runners}
    for _ in range(rounds):
        for k in ("fixed", "while", "while", "fixed"):
            secs[k].append(runners[k](left, right)[1])
    fixed_s = statistics.median(secs["fixed"])
    s_ = statistics.median(secs["while"])
    out.update(fixed_s=fixed_s, counts=counts, pair=pair, s=s_,
               secs=secs["while"], overhead_ms=1e3 * (s_ - fixed_s) / used)
    log(f"exit, {what}: seconds per pair, medians of {2 * rounds} replays "
        f"in turns: fixed depth at {used} iterations {fixed_s:.5f} (runs "
        f"{[round(t, 5) for t in secs['fixed']]}); the WHILE graph "
        f"{s_:.5f} (runs {[round(t, 5) for t in secs['while']]}), host "
        f"overhead {out['overhead_ms']:.4f} ms per iteration on {card}")
    return out


def predicate_row(card):
    """The predicate kernel against its plain version (the trip counts of
    a WHILE node whose body is the kernel alone, over bounds, deltas and
    NaN), and its times: the kernel by a replay of a loop of LIMIT
    iterations, the plain version as the host loop's per-iteration cost
    (an event wait, the delta read, the predicate) over a graph of one
    tiny kernel, each per iteration."""
    from raft_stereo_tpu_torch.kernels.graph_loop import (WhileGraph,
                                                          exit_continues,
                                                          exit_predicate)

    dev = torch.device("cuda")
    stream = torch.cuda.Stream()
    pool = torch.cuda.graph_pool_handle()
    it = torch.zeros((), dtype=torch.int32, device=dev)
    delta = torch.zeros((), device=dev)
    err = 0
    cases = [(d, lo, lim, 0.5) for d in (0.3, 0.5, 0.7, math.nan)
             for lo, lim in ((1, 5), (3, 5), (2, 2), (1, 64))]
    loops = []
    for d, lo, lim, thr in cases:
        wg = WhileGraph()
        graphs = [torch.cuda.CUDAGraph(keep_graph=True) for _ in range(3)]
        with torch.cuda.graph(graphs[0], pool=pool, stream=stream):
            it.zero_()
            delta.fill_(d)
        with torch.cuda.graph(graphs[1], pool=pool, stream=stream):
            exit_predicate(wg.handle, it, delta, lo, lim, thr)
        with torch.cuda.graph(graphs[2], pool=pool, stream=stream):
            it.add_(0)
        wg.build(*graphs)
        wg.launch(torch.cuda.current_stream())
        got = int(it)
        n, dd = 0, math.inf
        while exit_continues(n, dd, lo, lim, thr):
            n, dd = n + 1, d
        err = max(err, abs(got - n))
        loops.append((wg, graphs, lim, d))
    wg = next(w for w, _, l_, d_ in loops if l_ == 64 and d_ == 0.7)
    for _ in range(3):
        wg.launch(torch.cuda.current_stream())
    torch.cuda.synchronize()
    reps = 50
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        wg.launch(torch.cuda.current_stream())
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps / 64
    host = torch.empty((), pin_memory=True)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, pool=pool, stream=stream):
        it.add_(1)
        host.copy_(delta, non_blocking=True)
    ev = torch.cuda.Event()
    for _ in range(10):
        g.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _ in range(reps):
        k, dd = 0, math.inf
        while exit_continues(k, dd, 1, 64, 0.5):
            g.replay()
            ev.record()
            ev.synchronize()
            k, dd = k + 1, float(host)
            n += 1
    plain_ms = 1e3 * (time.perf_counter() - t0) / n
    for w, *_ in loops:
        w.close()
    bound_ms = 1e3 * 12 / MEM_RATE             # 8 bytes read, 4 written
    log(f"exit predicate kernel vs plain over {len(cases)} cases (delta "
        f"0.3/0.5/0.7/NaN, bounds (1,5) (3,5) (2,2) (1,64), threshold "
        f"0.5): max |trip count error| {err}; the kernel "
        f"{1e3 * ms:.3f} us per iteration in a WHILE loop of 64 (replays "
        f"of the loop), the plain host loop {1e3 * plain_ms:.3f} us per "
        f"iteration on {card}")
    if err:
        raise AssertionError("the predicate kernel disagrees with its "
                             "plain version")
    return {"ms": ms, "plain": plain_ms, "bound": bound_ms, "by": "bytes",
            "lib": None, "err": float(err)}


def phase_stream(cfg, state, thr, cap, left, right, small, small_r, card):
    """Phase 27: confidence card vs CPU; ``run_stream`` over three frames
    (cold, warm, warm with the hidden state) on the exit graphs against
    the eager streaming closure, bit for bit; ``cli/evaluate.py
    --sequence --exit_threshold_px --stream_out`` over a written
    KITTI-shaped sequence."""
    from raft_stereo_tpu_torch.cli import evaluate
    from raft_stereo_tpu_torch.eval.runner import (InferenceRunner,
                                                   launch_counts,
                                                   make_forward)
    from raft_stereo_tpu_torch.io.jax_weights import save_checkpoint

    settled = settle_state(state)
    worst = {}
    for adaptive in (False, True):
        conf_cfg = (dataclasses.replace(cfg, exit_threshold_px=thr,
                                        exit_min_iters=1) if adaptive
                    else cfg)
        outs = []
        for device in ("cuda", "cpu"):
            r = InferenceRunner(conf_cfg, settled, iters=2, device=device)
            fwd = make_forward(r.model, 2, return_confidence=True)
            with torch.inference_mode():
                o = fwd(*padded_batch(r, small, small_r))
            flat = [o[0]] + ([o[1]] if adaptive else []) + list(o[-1])
            outs.append([t.float().cpu() for t in flat])
        (card_o, cpu_o) = outs
        worst[adaptive] = (float((card_o[0] - cpu_o[0]).abs().max()),
                           max(float((a - b).abs().max())
                               for a, b in zip(card_o[-2:], cpu_o[-2:])))
        if adaptive and int(card_o[1]) != int(cpu_o[1]):
            raise AssertionError("confidence: iters_used card vs CPU")
    ok = all(f <= CARD_VS_CPU_ATOL and c <= CONF_ATOL
             for f, c in worst.values())
    log(f"confidence card vs CPU, 128x256, iters 2 (fixed depth, then "
        f"early exit at threshold {thr:.6g}): max |dflow| / max |dconf| "
        f"{worst} (limits {CARD_VS_CPU_ATOL}, {CONF_ATOL}): "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("confidence card and CPU disagree")

    r = InferenceRunner(cfg, settled, iters=cap, device="cuda",
                        exit_threshold_px=thr, exit_min_iters=EXIT_MIN_ITERS)
    frames, prev, hidden = [], None, None
    rs = np.random.default_rng(SEED + 1)
    for i in range(3):
        shifted = np.roll(left, -i, axis=1)
        f = r.run_stream(shifted, np.roll(right, -i, axis=1),
                         prev_flow_low=prev, prev_hidden=hidden,
                         carry_hidden=i >= 1)
        frames.append(f)
        prev, hidden = f.flow_low, (f.hidden if i >= 1 else None)
    # the third frame's program eagerly: warm start and hidden state in
    fwd = make_forward(r.model, cap, warm_start=True, return_state=True,
                       hidden_init=True, return_hidden=True)
    with torch.inference_mode():
        imgs = padded_batch(r, np.roll(left, -2, axis=1),
                            np.roll(right, -2, axis=1))
        init = torch.from_numpy(frames[1].flow_low[None]).cuda()
        hid = tuple(torch.from_numpy(h[None]).cuda()
                    for h in frames[1].hidden)
        e_up, e_low, e_used, e_hid = fwd(*imgs, init, hid)
    same = (np.array_equal(e_low[0].cpu().numpy(), frames[2].flow_low)
            and int(e_used) == frames[2].iters_used
            and all(np.array_equal(a[0].float().cpu().numpy(),
                                   b.astype(np.float32))
                    for a, b in zip(e_hid, frames[2].hidden)))
    log(f"run_stream on the exit graphs (cap {cap}): frames "
        f"{[(f.warm, f.iters_used, round(f.seconds, 4)) for f in frames]} "
        f"(warm, iters_used, seconds); {len(r._stream_compiled)} stream "
        f"programs; the warm frame with the hidden state equal to its "
        f"eager program bit for bit (flow_low, iters_used, hidden): {same}")
    if not same or not all(np.isfinite(f.flow).all() for f in frames):
        raise AssertionError("run_stream failed its checks")

    tree = os.path.join(HERE, "_smoke_data")
    shutil.rmtree(tree, ignore_errors=True)
    try:
        write_kitti_tree(os.path.join(tree, "KITTI"), SEQ_PAIRS, SEED)
        save_checkpoint(os.path.join(tree, "ckpt"), cfg, settled)
        rec_path = os.path.join(tree, "stream.json")
        zero_inference_counts()
        t0 = time.perf_counter()
        res = evaluate.main(
            ["--restore_ckpt", os.path.join(tree, "ckpt"), "--dataset",
             "kitti", "--data_root", tree, "--valid_iters", str(cap),
             "--sequence", "--exit_threshold_px", repr(thr), "--min_iters",
             str(EXIT_MIN_ITERS), "--stream_out", rec_path])
        seq_s = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        rec = json.load(open(rec_path))
    finally:
        shutil.rmtree(tree, ignore_errors=True)
    ok = (all(math.isfinite(v) for v in res.values())
          and EXIT_MIN_ITERS <= res["kitti-iters-cold-mean"] <= cap
          and EXIT_MIN_ITERS <= res["kitti-iters-warm-mean"] <= cap
          and rec["run"]["device_kind"] == torch.cuda.get_device_name(0)
          and counts.get("lookup", 0) > 0 and counts.get("exit", 0) > 0)
    log(f"sequence (cli/evaluate.py --sequence --exit_threshold_px "
        f"{thr:.6g} --stream_out, {SEQ_PAIRS} KITTI-shaped pairs, cap "
        f"{cap}): {res}; {seq_s:.1f} s; the wrappers' counts {counts}; "
        f"record run block {rec['run']} on {card}: "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("the sequence path failed its checks")
    return res


def phase_telemetry(tree, p24_step_s, want_step, counts, zero_counts,
                    cfg, state, left, right, card):
    """Phase 29: telemetry on the card.  (a) ``cli/train.py main`` on
    phase 24's tree at ``RaftStereoConfig()`` and ``TrainConfig()``'s
    batch, crop and iterations with every telemetry option on; (b) its
    endpoint scraped from a thread while it runs; (c) ``POST
    /debug/trace`` once TELEMETRY_TRACE_AFTER steps are done, its Chrome
    trace naming the gate, lookup and lookup-backward kernels; (d) the
    event log replayed; (e) the median step outside the trace window
    within TELEMETRY_STEP_RTOL of a telemetry-off run of the same CLI just
    before it (phase 24's median printed beside), and phase 24's launch
    counts per step; (f) the default runner with a ``CompileRegistry`` at
    375x1242 and 32 iterations: one record per capture, its seconds, FLOPs
    and memory, and the MFU against the card's peak at replay time."""
    import threading
    import urllib.request

    from raft_stereo_tpu_torch.cli import train as train_cli
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner
    from raft_stereo_tpu_torch.telemetry import (CompileRegistry,
                                                 MetricsRegistry, replay)
    from raft_stereo_tpu_torch.telemetry.flops import (forward_flops,
                                                       train_step_flops)
    from raft_stereo_tpu_torch.training import train_loop as loop_mod

    def get(url):
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.read().decode()

    def post(url, body):
        req = urllib.request.Request(url, data=body.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def gauge(text, name):
        for line in text.splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
        return None

    run_dir = os.path.join(tree, "telemetry_run")
    events_path = os.path.join(run_dir, "events.jsonl")
    built, snaps, marks, scrapes = {}, [], [], {"metrics": [], "health": [],
                                                "spans": [], "compiles": []}
    real_build, real_train = train_cli.build_telemetry, loop_mod.train
    done = threading.Event()
    errors = []

    def capture(args, model_cfg, train_cfg):
        built["parts"] = real_build(args, model_cfg, train_cfg)
        return built["parts"]

    def on_step(step, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        snaps.append(counts())

    def scrape():
        while "parts" not in built and not done.is_set():
            time.sleep(0.05)
        if done.is_set():
            return
        url = built["parts"][1].url
        while not done.is_set():
            try:
                scrapes["metrics"].append(get(url + "/metrics"))
                scrapes["health"].append(json.loads(get(url + "/healthz")))
                scrapes["spans"].append(json.loads(get(url + "/debug/spans")))
                scrapes["compiles"].append(
                    json.loads(get(url + "/debug/compiles")))
                if ("trace" not in scrapes and len(snaps)
                        >= TELEMETRY_TRACE_AFTER):
                    scrapes["trace_post"] = time.perf_counter()
                    scrapes["trace"] = post(
                        url + "/debug/trace",
                        json.dumps({"duration_ms": TELEMETRY_TRACE_MS}))
            except OSError as e:      # the endpoint closes as the run ends
                if not done.is_set():
                    errors.append(repr(e))
            time.sleep(0.2)

    def argv(name, steps, val_every):
        return ["--data_root", tree, "--checkpoint_dir",
                os.path.join(run_dir, name), "--log_dir", run_dir,
                "--batch_size", str(TRAIN_B), "--image_size",
                str(TRAIN_HW[0]), str(TRAIN_HW[1]), "--train_iters",
                str(TRAIN_ITERS), "--num_steps", str(steps),
                "--validation_frequency", str(val_every)]

    loop_mod.train = lambda *a, **kw: real_train(*a, on_step=on_step, **kw)
    thread = threading.Thread(target=scrape, daemon=True)
    try:
        # the control: the same run with telemetry off, just before
        marks.append(time.perf_counter())
        train_cli.main(argv("ck_off", TELEMETRY_CONTROL_STEPS, 10_000))
        off_marks, off_snaps = marks[:], snaps[:]
        marks.clear()
        snaps.clear()
        train_cli.build_telemetry = capture
        thread.start()
        zero_counts()
        marks.append(time.perf_counter())
        t0 = time.perf_counter()
        train_cli.main(argv("ck", TELEMETRY_STEPS, CLI_VAL_EVERY) + [
            "--metrics_port", "0", "--event_log", events_path,
            "--trace_sample_rate", "1.0", "--cost_telemetry",
            "--stall_watchdog"])
        run_s = time.perf_counter() - t0
    finally:
        done.set()
        if thread.ident is not None:
            thread.join(timeout=60)
        train_cli.build_telemetry = real_build
        loop_mod.train = real_train
    tel = built["parts"][0]

    # (e) launch counts per step and the step time outside the window
    per_step, prev = [], {k: 0 for k in counts()}
    for snap in snaps:
        per_step.append({k: snap[k] - prev[k] for k in snap})
        prev = snap
    trace_info = scrapes.get("trace", {})
    trace_file = os.path.join(trace_info.get("trace_dir", run_dir),
                              "trace.json")
    window = (scrapes.get("trace_post", math.inf),
              (os.path.getmtime(trace_file) - time.time()
               + time.perf_counter()) if os.path.exists(trace_file)
              else math.inf)
    steps = {i: (marks[i - 1], marks[i]) for i in range(2, len(marks))}
    # past the first step, not after a drain and save, not in the window
    clean = {i: b - a for i, (a, b) in steps.items()
             if (i - 1) % CLI_VAL_EVERY and (b < window[0] or a > window[1])}
    step_s = statistics.median(clean.values()) if clean else math.nan
    # what the window (its profiler and its trace export) adds to training
    in_window = {i: b - a for i, (a, b) in steps.items()
                 if not (b < window[0] or a > window[1])}
    stall_s = sum(t - step_s for t in in_window.values())
    off_steps = [off_marks[i] - off_marks[i - 1]
                 for i in range(2, len(off_marks))]
    off_s = statistics.median(off_steps)
    # (b) the scrapes
    last = scrapes["metrics"][-1] if scrapes["metrics"] else ""
    seen_steps = max((gauge(m, "train_steps_total") or 0
                      for m in scrapes["metrics"]), default=0)
    device_bytes = max((gauge(m, "train_device_bytes_in_use") or 0
                        for m in scrapes["metrics"]), default=0)
    mfus = [gauge(m, "train_mfu") for m in scrapes["metrics"]]
    mfus = [m for m in mfus if m]
    step_counts = [gauge(m, "train_step_seconds_count") or 0
                   for m in scrapes["metrics"]]
    compiles = [c for c in scrapes["compiles"] if c["count"]]
    rec = compiles[-1]["executables"][0] if compiles else {}
    want_flops = train_step_flops(cfg, TRAIN_HW, TRAIN_B, TRAIN_ITERS)
    # (c) the Chrome trace of the window
    kernel_names = set()
    if os.path.exists(trace_file):
        for e in json.load(open(trace_file))["traceEvents"]:
            if e.get("cat") == "kernel":
                kernel_names.add(e.get("name", ""))
    named = {k: any(k in n for n in kernel_names) for k in TELEMETRY_KERNELS}
    # (d) the event log
    recs = list(replay(events_path))
    kinds = [r["event"] for r in recs]
    build_events = [r for r in recs if r["event"] == "compile"]
    ok = (len(per_step) == TELEMETRY_STEPS
          and all(c == want_step for c in per_step)
          and seen_steps >= TELEMETRY_TRACE_AFTER and max(step_counts,
                                                          default=0) >= 1
          and device_bytes > 0
          and any(h["status"] == "running" and h["step"] >= 1
                  for h in scrapes["health"])
          and any(s["traceEvents"] for s in scrapes["spans"])
          and rec.get("key") == "train.step" and rec.get("flops") == want_flops
          and not rec.get("degraded", True) and mfus
          and all(0 < m <= 1.05 for m in mfus)
          and trace_info.get("duration_ms") == TELEMETRY_TRACE_MS
          and all(named.values())
          and kinds[0] == "run_start" and kinds[-1] == "run_end"
          and "step_stats" in kinds
          and [r.get("site") for r in build_events] == ["train"]
          and tel.recompiles.value == 0
          and len(clean) >= 2 and len(off_snaps) == TELEMETRY_CONTROL_STEPS
          and abs(step_s - off_s) <= TELEMETRY_STEP_RTOL * off_s)
    log(f"telemetry on the card (cli/train.py main, default config fp32, "
        f"batch {TRAIN_B}, {TRAIN_HW[0]}x{TRAIN_HW[1]}, iters {TRAIN_ITERS}, "
        f"{TELEMETRY_STEPS} steps, --metrics_port 0 --event_log "
        f"--trace_sample_rate 1.0 --cost_telemetry --stall_watchdog): "
        f"launches per step {per_step}; {len(scrapes['metrics'])} scrapes, "
        f"steps seen {seen_steps}, device bytes in use {device_bytes:.0f}, "
        f"MFU readings {mfus}, health {scrapes['health'][-1:]}, span "
        f"traces {max((len(s['traceEvents']) for s in scrapes['spans']), default=0)} "
        f"events; /debug/compiles {json.dumps(rec)}; the formula's step "
        f"FLOPs {want_flops}; trace window {trace_info} holds the kernels "
        f"{named} ({len(kernel_names)} kernel names); event kinds "
        f"{sorted(set(kinds))}, compile events {build_events}, recompiles "
        f"{tel.recompiles.value}; scrape errors {errors[:3]}; seconds per "
        f"step {[round(b - a, 4) for a, b in steps.values()]}, clean "
        f"outside the window {clean}, median {step_s:.4f} against "
        f"{off_s:.4f} with telemetry off just before "
        f"({100 * (step_s / off_s - 1):+.2f}%; steps "
        f"{[round(t, 4) for t in off_steps]}) and phase 24's "
        f"{p24_step_s:.4f} ({100 * (step_s / p24_step_s - 1):+.2f}%); "
        f"the {TELEMETRY_TRACE_MS} ms trace window added {stall_s:.4f} s "
        f"to the steps it overlapped {in_window}; the step's MFU at that "
        f"median {want_flops / step_s / FP32_RATE:.4f} against the fp32 "
        f"peak; {run_s:.1f} s on {card}: "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("the training telemetry failed its checks")

    # (f) the default runner's cost records
    reg = CompileRegistry(registry=MetricsRegistry())
    runner = InferenceRunner(cfg, state, iters=MAIN_ITERS, device="cuda",
                             cost_registry=reg)
    zero_inference_counts()
    flow, _ = runner(left, right)
    times = [runner(left, right)[1] for _ in range(5)]
    replay_s = statistics.median(times)
    pair_flops = forward_flops(cfg, PADDED_HW, 1, MAIN_ITERS)
    rec = runner.compiled_cost(PADDED_HW)
    mfu = pair_flops / replay_s / reg.peak_flops if reg.peak_flops else 0.0
    ok = (runner.captures == 1 and len(reg.records()) == 1
          and rec is not None and rec.flops == pair_flops
          and not rec.degraded and rec.compile_s > 0 and rec.hbm_bytes > 0
          and rec.key == "eval.forward(384x1248,b1)"
          and bool(np.isfinite(flow).all()) and 0 < mfu <= 1.05)
    log(f"runner cost record (default fp32, {MAIN_HW[0]}x{MAIN_HW[1]}, iters "
        f"{MAIN_ITERS}): {json.dumps(rec.to_dict() if rec else None)}; "
        f"capture {rec.compile_s if rec else math.nan:.3f} s, "
        f"{pair_flops / 1e12:.4f} TFLOP per pair, replay median "
        f"{replay_s:.5f} s, MFU {mfu:.4f} against {reg.peak_flops} FLOP/s "
        f"on {card}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("the runner's cost records failed their checks")
    return {"step_s": step_s, "mfu_pair": mfu, "pair_flops": pair_flops,
            "step_flops": want_flops}


def phase_drift(card):
    """Phase 28: the drift gates on the card: ``tools/quant_drift --full``
    and the bf16 drift's trained leg.  Prints every row, the gate and
    their seconds; fails on a missing variant, a non-finite row, or the
    quantized variants' gate kernels and int8 GEMMs not launching.  The
    gate's verdict is a measurement, printed, not a check.  Returns the
    bf16 leg's trained realtime weights (phase 31 warm-starts on them)."""
    from raft_stereo_tpu_torch.eval import drift
    from raft_stereo_tpu_torch.eval.runner import launch_counts
    from raft_stereo_tpu_torch.tools import bf16_drift, quant_drift

    release()    # phases 26-27's runners
    zero_inference_counts()
    t0 = time.perf_counter()
    q = quant_drift.run(quant_drift.build_parser().parse_args(
        ["--full", "--steps", str(DRIFT_GATE_STEPS), "--device", "cuda"]))
    q_s = time.perf_counter() - t0
    q_counts = {k: v for k, v in launch_counts().items() if v}
    zero_inference_counts()
    t0 = time.perf_counter()
    trained = {}
    brief_train = drift.brief_train

    def keep(*args, **kwargs):
        trained.update(brief_train(*args, **kwargs))
        return trained

    drift.brief_train = keep
    try:
        b = bf16_drift.run(bf16_drift.build_parser().parse_args(
            ["--device", "cuda"]))
    finally:
        drift.brief_train = brief_train
    b_s = time.perf_counter() - t0
    b_counts = {k: v for k, v in launch_counts().items() if v}
    names = {"quant": ("fp32", "bf16", "int8", "int8_w", "int8_mxu"),
             "bf16": ("bf16_alt", "fp32corr_alt", "fp32_reg")}
    ok = True
    for tag, rows in (("quant", q["rows"]), ("bf16", b["rows"])):
        for row in rows:
            log(f"drift {tag}: {json.dumps(row)}")
            ok = ok and all(f"epe_{n}" in row for n in names[tag]) and all(
                math.isfinite(v) for k, v in row.items()
                if k.startswith(("epe", "depe", "drift")))
    ok = (ok and len(q["rows"]) == 6 and len(b["rows"]) == 6
          and q_counts.get("gates", 0) > 0 and q_counts.get("gemm", 0) > 0
          and b_counts.get("alt", 0) > 0 and b_counts.get("gates", 0) > 0)
    log(f"quant drift gate (--full, {q['train_steps']} training steps in "
        f"{q['train_seconds']} s, evaluation {q['eval_seconds']} s, "
        f"{q_s:.1f} s in all): {json.dumps(q['gate'])}; param bytes "
        f"{q['param_bytes']}; the wrappers' counts {q_counts} on {card}")
    log(f"bf16 drift, trained leg ({b['train_steps']} steps of the realtime "
        f"architecture in {b['train_seconds']} s, evaluation "
        f"{b['eval_seconds']} s, {b_s:.1f} s in all); the wrappers' counts "
        f"{b_counts}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("the drift gates failed their checks")
    return trained


def training_counts():
    """The training kernels' wrapper counts."""
    from raft_stereo_tpu_torch.kernels.corr_alt import (
        alt_lookup_bwd_fused, alt_lookup_fused)
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_bwd_fused, lookup_pyramid_fused)
    from raft_stereo_tpu_torch.kernels.gru_fused import gru_gates_fused
    return {"lookup": lookup_pyramid_fused.launches,
            "lookup_bwd": lookup_pyramid_bwd_fused.launches,
            "gates": gru_gates_fused.launches,
            "alt": alt_lookup_fused.launches,
            "alt_bwd": alt_lookup_bwd_fused.launches}


def zero_training_counts():
    from raft_stereo_tpu_torch.kernels.corr_alt import (
        alt_lookup_bwd_fused, alt_lookup_fused)
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_bwd_fused, lookup_pyramid_fused)
    from raft_stereo_tpu_torch.kernels.gru_fused import gru_gates_fused
    for fn in (lookup_pyramid_fused, lookup_pyramid_bwd_fused,
               gru_gates_fused, alt_lookup_fused, alt_lookup_bwd_fused):
        fn.launches = 0


def drive_training(model_cfg, what, timed_steps=TIMED_STEPS, dev="cuda"):
    """``train()`` on the card: a warm-up step, then ``timed_steps``
    steps with the launch counts zeroed before them; seconds per step
    from a synchronised host clock at the end of every step
    (``on_step``: the loop's prefetcher pulls batches ahead of the
    step).  Returns (launches, median seconds per step, peak GiB)."""
    from raft_stereo_tpu_torch.config import TrainConfig
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
    from raft_stereo_tpu_torch.training.state import create_train_state
    from raft_stereo_tpu_torch.training.train_loop import train

    train_cfg = dataclasses.replace(
        TrainConfig(), batch_size=TRAIN_B, image_size=TRAIN_HW,
        train_iters=TRAIN_ITERS)
    src = SyntheticStereoLoader(train_cfg.batch_size,
                                train_cfg.image_size, seed=SEED)
    batches = [src.batch(i) for i in range(1 + timed_steps)]
    marks = [time.perf_counter()]
    seen = []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        seen.append({k_: float(v) for k_, v in metrics.items()})
        if step == 1:
            zero_training_counts()
            torch.cuda.reset_peak_memory_stats()

    state = train(model_cfg, train_cfg, loader=batches, device=dev,
                  checkpoint_dir=None, log_dir=None, on_step=on_step)
    torch.cuda.synchronize()
    launched = training_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = [marks[i + 1] - marks[i] for i in range(1, 1 + timed_steps)]
    start = create_train_state(model_cfg, train_cfg, "cpu",
                               seed=train_cfg.seed).model.state_dict()
    moved = max(float((p.detach().cpu() - start[n]).abs().max())
                for n, p in state.model.named_parameters())
    log(f"{what} training step, batch {train_cfg.batch_size}, "
        f"{train_cfg.image_size[0]}x{train_cfg.image_size[1]}, iters "
        f"{train_cfg.train_iters}: seconds per step median "
        f"{statistics.median(steps):.4f} (steps {[round(t, 4) for t in steps]}"
        f"; warm-up {marks[1] - marks[0]:.3f}), peak memory {peak:.2f} "
        f"GiB, launches over {timed_steps} steps {launched}; losses "
        f"{[round(m['loss'], 4) for m in seen]}, grad_norms "
        f"{[round(m['grad_norm'], 3) for m in seen]}; largest "
        f"parameter move {moved:.3e}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in seen) or len(seen) != 1 + timed_steps:
        raise AssertionError(f"{what}: bad metrics {seen}")
    if not moved > 0:
        raise AssertionError(f"{what}: the parameters did not move")
    return launched, statistics.median(steps), peak


def phase_remat(small_tc, small_batch, card):
    """Phase 32 (module docstring).  Returns each policy's launches over
    its timed steps, keyed by the policy's names joined with '+'."""
    from raft_stereo_tpu_torch.config import RaftStereoConfig
    from raft_stereo_tpu_torch.training.state import create_train_state
    from raft_stereo_tpu_torch.training.step import train_step

    t_phase = time.perf_counter()
    launches, readings = {}, []
    for saves in REMAT_POLICIES:
        release()
        launched, step_s, peak = drive_training(
            RaftStereoConfig(remat_save=saves),
            f"default, remat_save={saves},", REMAT_TIMED_STEPS)
        gates = (3 if "gru_gates" in saves else 6) * TRAIN_ITERS
        want = {"lookup": TRAIN_ITERS, "lookup_bwd": TRAIN_ITERS,
                "gates": gates, "alt": 0, "alt_bwd": 0}
        if launched != {k: REMAT_TIMED_STEPS * v for k, v in want.items()}:
            raise AssertionError(f"remat_save={saves}: launches {launched}, "
                                 f"want {want} per step")
        launches["+".join(saves)] = launched
        readings.append((saves, step_s, peak))
    release()
    weights = create_train_state(RaftStereoConfig(), small_tc, "cpu",
                                 seed=SEED).model.state_dict()
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    steps = {}
    try:
        for saves in REMAT_POLICIES:
            st = create_train_state(RaftStereoConfig(remat_save=saves),
                                    small_tc, "cuda", state_dict=weights)
            zero_training_counts()
            st, m = train_step(st, small_batch, iters=2, loss_gamma=0.9,
                               max_flow=700.0)
            steps[saves] = ({k: float(v) for k, v in m.items()},
                            {n: p.grad.detach().clone()
                             for n, p in st.model.named_parameters()},
                            training_counts()["gates"])
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    base_m, base_g, _ = steps[REMAT_POLICIES[0]]
    unequal = {"+".join(saves): [n for n in base_g
                                 if not torch.equal(g[n], base_g[n])]
               for saves, (m, g, _) in steps.items()}
    ok = (all(not v for v in unequal.values())
          and all(m == base_m for m, _, _ in steps.values())
          and [c for _, _, c in steps.values()] == [12, 6, 6])
    for saves, step_s, peak in readings:
        log(f"remat_save={saves}: default step (batch {TRAIN_B}, "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, {TRAIN_ITERS} iterations) "
            f"{step_s:.4f} s median of {REMAT_TIMED_STEPS}, allocator peak "
            f"{peak:.2f} GiB on {card}")
    log(f"remat policies at 64x128, 2 iterations, cuDNN deterministic: "
        f"gate calls per step {[c for _, _, c in steps.values()]} (12, 6, "
        f"6 wanted); every gradient leaf bit for bit equal to "
        f"remat_save={REMAT_POLICIES[0]}'s: "
        f"{ {k: not v for k, v in unequal.items()} } (unequal leaves "
        f"{ {k: v[:3] for k, v in unequal.items() if v} }); phase 32 took "
        f"{time.perf_counter() - t_phase:.1f} s: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("the remat policies failed their checks")
    return launches


def phase_loader(tree, make_loader, rt_run, rt_tc, counts, zero_counts,
                 card):
    """Phase 33 (module docstring).  Returns the wrappers' counts over the
    last run's steps and the medians per way."""
    import glob

    from raft_stereo_tpu_torch import native
    from raft_stereo_tpu_torch.data import frame_utils as fu

    t_phase = time.perf_counter()
    built = native.available()
    things = os.path.join(tree, "FlyingThings3D")
    if built:
        pngs = sorted(glob.glob(os.path.join(
            things, "frames_cleanpass", "TRAIN", "A", "*", "*",
            "0006.png")))[:DECODE_SAMPLE]
        pfms = sorted(glob.glob(os.path.join(
            things, "disparity", "TRAIN", "A", "*", "left",
            "0006.pfm")))[:DECODE_SAMPLE]
        got = ([native.read_png_rgb8(f) for f in pngs]
               + [native.read_pfm(f) for f in pfms])
        real_available = native.available
        native.available = lambda: False
        try:
            want = ([fu.read_image(f) for f in pngs]
                    + [fu.read_pfm(f) for f in pfms])
        finally:
            native.available = real_available
        same = [a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(got, want)]
        log(f"native decoders ({native.library_path().name}): "
            f"{len(pngs)} PNGs and {len(pfms)} PFMs of the tree bitwise "
            f"equal to the Python readers: {sum(same)} of {len(same)}")
        if not (pngs and pfms and all(same)):
            raise AssertionError("the native decoders differ from the "
                                 "Python readers")
        turns = LOADER_TURNS
    else:
        log(f"native decoders unavailable on this host, so the loader "
            f"runs on the Python readers alone: "
            f"{native.unavailable_reason()}")
        turns = ("python",)
    tc = dataclasses.replace(rt_tc, num_steps=LOADER_STEPS)
    per_step = {"lookup": 0, "lookup_bwd": 0, "gates": 6 * TRAIN_ITERS,
                "alt": TRAIN_ITERS, "alt_bwd": TRAIN_ITERS}
    runs = {"native": [], "python": []}
    real_available = native.available
    for way in turns:
        marks, waits, losses = [], [], []
        if way == "python":
            native.available = lambda: False
        release()
        zero_counts()
        try:
            rt_run(tc, make_loader(tc), None, losses=losses,
                   step_marks=marks, waits=waits)
        finally:
            native.available = real_available
        torch.cuda.synchronize()
        launched = counts()
        steps_s = [b - a for a, b in zip(marks, marks[1:])]
        runs[way].append((steps_s, waits))
        log(f"realtime step over StereoLoader (4 thread workers, batch "
            f"{TRAIN_B}, {TRAIN_HW[0]}x{TRAIN_HW[1]}, {TRAIN_ITERS} "
            f"iterations), {way} readers: seconds per step past the first "
            f"{[round(t, 4) for t in steps_s]} (median "
            f"{statistics.median(steps_s):.4f}), the loop's wait for each "
            f"step's batch {[round(w, 4) for w in waits]} s, launches "
            f"{launched}")
        if not (launched == {k: LOADER_STEPS * v for k, v in per_step.items()}
                and len(losses) == LOADER_STEPS
                and all(math.isfinite(m["loss"]) for m in losses)):
            raise AssertionError(f"the loader's realtime run ({way}) failed "
                                 f"its checks: launches {launched}, losses "
                                 f"{losses}")
    medians = {way: statistics.median(t for steps_s, _ in r for t in steps_s)
               for way, r in runs.items() if r}
    waits = {way: statistics.median(w for _, ws in r for w in ws[1:])
             for way, r in runs.items() if r}
    log(f"loader, native against Python readers in turns {turns}: median "
        f"seconds per step {medians}, median wait per step past the first "
        f"{waits} on {card}; phase 33 took "
        f"{time.perf_counter() - t_phase:.1f} s: ok")
    return launched, medians


def phase_sweep(card):
    """Phase 34 (module docstring).  Returns the wrappers' counts over the
    tool's run and its trained ``(config, state, seconds)``, which phase
    35's confidence report measures."""
    from raft_stereo_tpu_torch.eval import runner as runner_mod
    from raft_stereo_tpu_torch.eval.runner import launch_counts
    from raft_stereo_tpu_torch.telemetry.events import default_path
    from raft_stereo_tpu_torch.tools import early_exit_report as ee

    release()
    t_phase = time.perf_counter()
    args = ee.build_parser().parse_args(
        ["--device", "cuda", "--steps", str(SWEEP_TRAIN_STEPS)])
    seen = []
    real_note = runner_mod.InferenceRunner._note_iters_used

    def note(self, iters_used):
        used = real_note(self, iters_used)
        seen.append((self.iters, used))
        return used

    runner_mod.InferenceRunner._note_iters_used = note
    zero_inference_counts()
    try:
        trained = ee.trained_state(args)
        rec = ee.run(args, trained)
    finally:
        runner_mod.InferenceRunner._note_iters_used = real_note
    launched = {k: v for k, v in launch_counts().items() if v}
    rows = rec["sweep"]
    means = [r["mean_iters_used"] for r in rows]
    epes = list(rec["fixed_baseline_epe"].values()) + [
        v for r in rows for v in r["epe"].values()]
    ok = (len(rows) == len(args.thresholds.split(","))
          and all(math.isfinite(e) for e in epes)
          and bool(seen) and all(u <= it for it, u in seen)
          and all(a <= b for a, b in zip(means, means[1:]))
          and launched.get("gates", 0) > 0 and launched.get("exit", 0) > 0
          and "lookup" not in launched)
    for r in rows:
        log(f"early-exit sweep row: {json.dumps(r)}")
    for r in rec["tier_latency"]:
        log(f"early-exit tier latency: {json.dumps(r)}")
    log(f"early-exit sweep (the tool's {rec['train_steps']} training steps "
        f"at {args.train_hw} in {rec['train_seconds']} s, cap {args.iters}, "
        f"min_iters {args.min_iters}, {args.images} images per validator "
        f"at {args.hw}): fixed baseline EPE {rec['fixed_baseline_epe']}; "
        f"mean iters_used loosest first {means}; chosen "
        f"{json.dumps(rec['chosen'])}; meets the 60% bar "
        f"{rec['meets_60pct_bar']}; calibrated interactive p50 speed-up "
        f"{rec['interactive_calibrated_p50_speedup_vs_fixed']}; "
        f"{len(seen)} exit-loop calls, the deepest "
        f"{max((u for _, u in seen), default=None)}; the wrappers' counts "
        f"{launched}; record {rec['card']!r} -> "
        f"{default_path(f'EARLY_EXIT_{args.tag}.json')}; phase 34 took "
        f"{time.perf_counter() - t_phase:.1f} s on {card}: "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("the early-exit sweep failed its checks")
    return launched, trained


def post(url: str, body: bytes, ctype: str = "application/x-npz",
         timeout: float = 120.0):
    """``(status, headers, body)`` of one POST."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def get(url: str, timeout: float = 30.0):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def npz_body(left, right) -> bytes:
    import io
    buf = io.BytesIO()
    np.savez(buf, left=left, right=right)
    return buf.getvalue()


def wait_depth(engine, n: int, timeout: float = 60.0) -> None:
    t_end = time.monotonic() + timeout
    while engine.queue.depth < n:
        if time.monotonic() > t_end:
            raise AssertionError(f"queue depth {engine.queue.depth} never "
                                 f"reached {n}")
        time.sleep(0.005)


def dispatch_counts(engine, bucket, n, tier, iters_used, family=None):
    """One dispatch's launches from its program: the capture's counts, or
    under early exit ``launches + iters_used * body_launches``."""
    entry = engine.program(bucket, n, tier, family=family)
    if hasattr(entry, "pair_launches"):
        return entry.pair_launches(iters_used)
    return dict(entry.launches)


def cache_check(cfg, state):
    """Phase 22's eviction check on the engine: one worker with
    ``max_cached_shapes=2`` over CACHE_SHAPES in CACHE_ORDER, the
    reserved memory after the evictions within CACHE_MEMORY_FACTOR of its
    value after the second shape, a replay and a recapture bitwise equal
    to the first answers."""
    import gc

    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    eng = ServingEngine(cfg, state, ServeConfig(
        iters=MAIN_ITERS, batch_sizes=(1,), max_batch=1,
        max_cached_shapes=2), device="cuda")
    rs = np.random.default_rng(SEED + 30)
    pairs = {}
    for key, hw in CACHE_SHAPES.items():
        l_ = rs.integers(0, 256, hw + (3,), dtype=np.uint8)
        pairs[key] = (l_, np.roll(l_, -4, axis=1))
    outs, held = {}, []
    for key in CACHE_ORDER:
        outs.setdefault(key, []).append(eng.infer(*pairs[key],
                                                  timeout=120).flow)
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_reserved() - base)
    programs = [k[1] for k in eng.cached_programs()]
    ok = (eng.captures == 4 and len(programs) == 2
          and np.array_equal(*outs["A"]) and np.array_equal(*outs["B"])
          and max(held[3:]) <= CACHE_MEMORY_FACTOR * held[1])
    log(f"serving cache (max_cached_shapes=2): order {CACHE_ORDER}, "
        f"{eng.captures} captures, programs {programs}; reserved memory "
        f"above the start after each shape "
        f"{[round(h / 2 ** 30, 3) for h in held]} GiB, after the evictions "
        f"at most {max(held[3:]) / max(held[1], 1):.3f}x its value after "
        f"the second shape (limit {CACHE_MEMORY_FACTOR}x); A replayed and "
        f"B recaptured bitwise equal: {'ok' if ok else 'FAILED'}")
    eng.close()
    if not ok:
        raise AssertionError("serving cache checks failed")


def serve_pairs(left, right, contrasts=None):
    """The ladder's distinct pairs at the main shape: the main pair first,
    then noise pairs of other seeds and shifts, or (``contrasts``) the
    main pair at each contrast about mid-grey (on settled weights a lower
    contrast exits earlier)."""
    if contrasts is not None:
        out = []
        for c in contrasts:
            l_ = (128 + (left.astype(np.float32) - 128) * c).astype(np.uint8)
            out.append((l_, np.roll(l_, -4, axis=1)))
        return out
    out = [(left, right)]
    for k in range(1, max(SERVE_SIZES)):
        l_ = np.random.default_rng(SEED + 300 + k).integers(
            0, 256, MAIN_HW + (3,), dtype=np.uint8)
        out.append((l_, np.roll(l_, -(2 + k), axis=1)))
    return out


def serve_references(cfg, state, iters, tiers, pairs, sizes):
    """Each tier's answers from an ``InferenceRunner`` of its knobs, made
    before the engine so that no runner launch lands in the engine's
    counts: ``{tier: (solo, stacked)}``, ``solo`` a ``(flow,
    iters_used)`` per pair alone, ``stacked[n]`` the ``(flows,
    iters_used)`` of the first ``n`` pairs in one ``run_batch``.  Each
    runner is dropped after its tier."""
    import gc

    from raft_stereo_tpu_torch.config import parse_tier
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner

    refs = {}
    for spec in tiers:
        t = parse_tier(spec)
        knobs = {} if t.exit_threshold_px <= 0 and t.quant == "off" else {
            "exit_threshold_px": t.exit_threshold_px,
            "exit_min_iters": t.min_iters,
            "quant": None if t.quant == "off" else t.quant}
        r = InferenceRunner(cfg, state, iters=iters, device="cuda", **knobs)
        solo = []
        for l_, r_ in pairs[:max(sizes)]:
            flow, _ = r(l_, r_)
            solo.append((flow, r.last_iters_used or iters))
        stacked = {}
        for n in sizes[1:]:
            flows, _ = r.run_batch([p[0] for p in pairs[:n]],
                                   [p[1] for p in pairs[:n]])
            stacked[n] = (flows, r.last_iters_used or iters)
        refs[t.name] = (solo, stacked)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def tier_dispatch_counts(counts, tier, iters_used):
    """The launches one dispatch of a realtime tier must make: #6 (or #9
    on a quantized tier) and three gate calls per iteration, the
    predicate per iteration of an exit tier, the int8 GEMMs only on a
    quantized one."""
    from raft_stereo_tpu_torch.config import parse_tier

    t = parse_tier(tier)
    k = iters_used
    quant = t.quant != "off"
    want = {"lookup": 0, "lookup_q": 0, "gates": 3 * k,
            "alt": 0 if quant else k, "alt_q": k if quant else 0,
            "exit": k if t.exit_threshold_px > 0 else 0}
    got = {c: counts[c] for c in want}
    if got != want or quant != (counts["gemm"] > 0):
        raise AssertionError(f"tier {t.name} launches per dispatch {counts},"
                             f" want {want}")


def check_tiers(eng, what, tiers, pairs, sizes, refs, cap, per_dispatch,
                spread=None, exits_below_cap=False):
    """Each tier on the engine: the first pair alone, bitwise equal to its
    runner's answer (with its ``iters_used``), and its launches per
    dispatch; then at each batch size ``n`` the first ``n`` pairs queued
    together, run as one batch, each row bitwise equal to the runner's
    ``run_batch`` of the same stack, every row at the batch's depth, which
    is the deepest member's alone.  ``spread``: the fixed-depth tier's
    rows must also stay within RT_SPREAD_FACTOR of it of each pair's
    batch-1 answer.  ``exits_below_cap``: an exit tier must exit before
    ``cap`` and its members' depths alone must differ in every batch.
    Returns the batch-1 results."""
    from raft_stereo_tpu_torch.config import parse_tier

    answers = {}
    bucket = PADDED_HW
    for spec in tiers:
        name = parse_tier(spec).name
        exits = parse_tier(spec).exit_threshold_px > 0
        solo, stacked = refs[name]
        res = eng.infer(*pairs[0], tier=name, timeout=120)
        if res.batch_size != 1 or not np.array_equal(res.flow, solo[0][0]):
            raise AssertionError(f"{what} {name}: batch-1 answer differs "
                                 f"from the runner's replay by "
                                 f"{np.abs(res.flow - solo[0][0]).max()}")
        if res.iters_used != solo[0][1]:
            raise AssertionError(f"{what} {name}: iters_used "
                                 f"{res.iters_used} vs the runner's "
                                 f"{solo[0][1]}")
        counts = dispatch_counts(eng, bucket, 1, name, res.iters_used)
        tier_dispatch_counts(counts, spec, res.iters_used)
        per_dispatch[f"{what} {name}"] = counts
        answers[name] = res
        depths = [d for _, d in solo]
        log(f"serving {what} {name}: batch 1 bitwise equal to the runner's "
            f"replay, iters_used {res.iters_used}, launches per dispatch "
            f"{counts}; each pair's depth alone {depths}")
        for n in sizes[1:]:
            eng.queue.pause()
            futs = [eng.submit(l_, r_, tier=name) for l_, r_ in pairs[:n]]
            eng.queue.resume()
            rows = [f.result(timeout=120) for f in futs]
            want, used = stacked[n]
            equal = [np.array_equal(r.flow, w) for r, w in zip(rows, want)]
            ok = ([r.batch_size for r in rows] == [n] * n and all(equal)
                  and {r.iters_used for r in rows} == {used}
                  and used == max(depths[:n]))
            if exits_below_cap:
                ok = ok and used < cap and len(set(depths[:n])) > 1
            msg = (f"serving {what} {name} batch {n} ({n} distinct pairs): "
                   f"sizes {[r.batch_size for r in rows]}, rows bitwise "
                   f"equal to the runner's run_batch {equal}, iters_used "
                   f"{sorted({r.iters_used for r in rows})} (runner {used},"
                   f" members alone {depths[:n]}, cap {cap})")
            if spread is not None and not exits:
                err = np.stack([np.abs(r.flow - solo[i][0])
                                for i, r in enumerate(rows)])
                ok = ok and (err.max() <= RT_SPREAD_FACTOR * spread.max()
                             and err.mean()
                             <= RT_SPREAD_FACTOR * spread.mean())
                msg += (f"; rows vs their pairs' batch-1 answers max / mean "
                        f"{err.max():.4e} / {err.mean():.4e} px (limit "
                        f"{RT_SPREAD_FACTOR}x the bf16 vs fp32-correlation "
                        f"spread {spread.max():.4e} / {spread.mean():.4e})")
            log(f"{msg}: {'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"{what} {name} batch {n} failed")
    return answers


def phase_serving(cfg, state, rt_cfg, rt_state, runner, left, right,
                  exit_thr):
    """Phase 30 (module docstring).  Returns the wrappers' counts over
    the realtime engines (a) and (a'), over (b), and the launches per
    dispatch of each program checked."""
    import gc
    import threading

    from raft_stereo_tpu_torch.eval.runner import (InferenceRunner,
                                                   launch_counts)
    from raft_stereo_tpu_torch.profiling import device_memory_stats
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
    from raft_stereo_tpu_torch.serving.http import (StereoHTTPServer,
                                                    _encode_disparity)

    t_phase = time.perf_counter()
    bucket = PADDED_HW
    per_dispatch = {}
    # ---- the runners' answers first, each runner dropped after its use
    pairs = serve_pairs(left, right)
    settled = settle_state(rt_state)
    thr = repr(float(exit_thr))
    exit_tiers = (f"interactive:{thr}:{EXIT_MIN_ITERS}",
                  f"turbo:{thr}:{EXIT_MIN_ITERS}:int8_mxu")
    exit_pairs = serve_pairs(left, right, SERVE_CONTRASTS)
    refs = serve_references(rt_cfg, rt_state, RT_ITERS, SERVE_TIERS, pairs,
                            SERVE_SIZES)
    exit_refs = serve_references(rt_cfg, settled, RT_ITERS, exit_tiers,
                                 exit_pairs, SERVE_EXIT_SIZES)
    fp32_corr = InferenceRunner(dataclasses.replace(rt_cfg, corr_fp32=True),
                                rt_state, iters=RT_ITERS, device="cuda")
    spread = np.abs(fp32_corr(left, right)[0] - refs["quality"][0][0][0])
    del fp32_corr
    want_b1, _ = runner(left, right)
    ref_b = InferenceRunner(cfg, state, iters=MAIN_ITERS, device="cuda")
    want_b2, _ = ref_b.run_batch([p[0] for p in pairs[:2]],
                                 [p[1] for p in pairs[:2]])
    del ref_b
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"serving references (runners, before the engines): "
        f"{time.perf_counter() - t_phase:.1f} s")
    # ---- (a) the realtime engine, three tiers, the 1/2/4/8 ladder
    reserved0 = torch.cuda.memory_reserved()
    zero_inference_counts()
    eng = ServingEngine(rt_cfg, rt_state, ServeConfig(
        iters=RT_ITERS, tiers=SERVE_TIERS, batch_sizes=SERVE_SIZES,
        max_batch=max(SERVE_SIZES), max_queue=64, warmup_shapes=(MAIN_HW,),
        prewarm_on_init=False, cost_telemetry=True), device="cuda")
    server = StereoHTTPServer(eng, port=0).start()
    code, _ = get(server.url + "/readyz")
    if code != 503 or eng.ready:
        raise AssertionError(f"/readyz answered {code} before prewarm")
    scrapes = {"n": 0, "errors": []}
    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            try:
                for route in ("/metrics", "/readyz", "/healthz"):
                    get(server.url + route)
                device_memory_stats()
                scrapes["n"] += 1
            except Exception as e:  # noqa: BLE001 - reported below
                scrapes["errors"].append(repr(e))
            time.sleep(0.02)

    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prewarm(MAIN_HW)
    prewarm_s = time.perf_counter() - t0
    stop.set()
    scraper.join(timeout=30)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    code, _ = get(server.url + "/readyz")
    programs = len(SERVE_SIZES) * len(eng._distinct_cache_tiers())
    log(f"serving prewarm at {MAIN_HW[0]}x{MAIN_HW[1]}: {eng.captures} "
        f"captures ({programs} programs: tiers {eng._distinct_cache_tiers()}"
        f" x batch sizes {SERVE_SIZES}) in {prewarm_s:.2f} s on the worker "
        f"thread, {scrapes['n']} scrapes meanwhile; reserved memory "
        f"{reserved / 2 ** 30:.2f} GiB, the engine's "
        f"{(reserved - reserved0) / 2 ** 30:.2f} GiB of it; /readyz {code}")
    if scrapes["errors"] or code != 200 or not eng.ready:
        raise AssertionError(f"prewarm: /readyz {code}, scrape errors "
                             f"{scrapes['errors'][:3]}")
    if eng.captures != programs:
        raise AssertionError(f"{eng.captures} captures, want {programs}")
    answers = check_tiers(eng, "realtime", SERVE_TIERS, pairs, SERVE_SIZES,
                          refs, RT_ITERS, per_dispatch, spread=spread)
    counts_a = launch_counts()
    log(f"serving (a) wrapper counts over the engine's prewarm and "
        f"dispatches: {counts_a}")
    # ---- (a') exit tiers on settled weights: exits below the cap
    zero_inference_counts()
    eng_x = ServingEngine(rt_cfg, settled, ServeConfig(
        iters=RT_ITERS, tiers=exit_tiers, batch_sizes=SERVE_EXIT_SIZES,
        max_batch=max(SERVE_EXIT_SIZES), prewarm_on_init=False),
        device="cuda")
    eng_x.prewarm(MAIN_HW)
    check_tiers(eng_x, "settled", exit_tiers, exit_pairs, SERVE_EXIT_SIZES,
                exit_refs, RT_ITERS, per_dispatch, exits_below_cap=True)
    counts_x = launch_counts()
    eng_x.close()
    del eng_x
    log(f"serving (a') wrapper counts over the settled engine's prewarm "
        f"and dispatches: {counts_x}")
    counts_a = {k: counts_a[k] + counts_x[k] for k in counts_a}
    # ---- (b) the default config, fp32, 32 iterations, batch sizes 1/2
    zero_inference_counts()
    eng_b = ServingEngine(cfg, state, ServeConfig(
        iters=MAIN_ITERS, batch_sizes=(1, 2), max_batch=2,
        max_queue=SERVE_BURST_QUEUE, warmup_shapes=(MAIN_HW,),
        prewarm_on_init=False), device="cuda")
    eng_b.prewarm(MAIN_HW)
    res = eng_b.infer(left, right, timeout=120)
    if not np.array_equal(res.flow, want_b1):
        raise AssertionError(f"default engine batch 1 differs from phase "
                             f"5's runner by "
                             f"{np.abs(res.flow - want_b1).max()}")
    counts = dispatch_counts(eng_b, bucket, 1, None, res.iters_used)
    per_dispatch["default"] = counts
    if (counts["lookup"], counts["gates"], counts["alt"]) != (
            MAIN_ITERS, 3 * MAIN_ITERS, 0):
        raise AssertionError(f"default engine launches per dispatch "
                             f"{counts}")
    eng_b.queue.pause()
    futs = [eng_b.submit(l_, r_) for l_, r_ in pairs[:2]]
    eng_b.queue.resume()
    rows = [f.result(timeout=120) for f in futs]
    equal = [np.array_equal(r.flow, w) for r, w in zip(rows, want_b2)]
    counts_b = launch_counts()
    log(f"serving default engine: batch 1 bitwise equal to phase 5's "
        f"runner, launches per dispatch {counts}; batch 2 of two distinct "
        f"pairs, sizes {[r.batch_size for r in rows]}, rows bitwise equal "
        f"to a runner's run_batch of the same stack {equal}; wrapper "
        f"counts over its prewarm and dispatches {counts_b}")
    if [r.batch_size for r in rows] != [2, 2] or not all(equal):
        raise AssertionError("default engine batch 2")
    cache_check(cfg, state)
    # ---- (c) HTTP: closed loop, PNG, burst past max_queue, drain
    body = npz_body(left, right)
    m = eng.metrics
    done0, batches0 = m.completed.value, m.batches.value
    t0 = time.perf_counter()
    got = closed_loop([server.url], body, SERVE_CLIENTS, SERVE_LOAD_S,
                      path="/v1/disparity?tier=quality")
    load_s = time.perf_counter() - t0
    latencies = [s_ for _, s_, _ in got]
    statuses = [c_ for c_, *_ in got]
    lock = threading.Lock()
    done, batches = m.completed.value - done0, m.batches.value - batches0
    mean_batch = done / max(batches, 1)
    lat = np.array(latencies) * 1e3
    log(f"serving closed loop: {SERVE_CLIENTS} clients x {load_s:.2f} s, "
        f"{len(latencies)} requests ({statuses.count(200)} answered 200): "
        f"{len(latencies) / load_s:.2f} requests/s, latency p50 "
        f"{np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f}"
        f" ms; {done} completed in {batches} dispatches, mean batch "
        f"{mean_batch:.3f}; dispatches by size "
        f"{ {n: m.dispatches_at(n) for n in SERVE_SIZES} }")
    if statuses.count(200) != len(statuses) or not mean_batch > 1:
        raise AssertionError(f"closed loop: statuses "
                             f"{sorted(set(statuses))}, mean batch "
                             f"{mean_batch}")
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.concatenate([left, right], axis=1)).save(buf, "PNG")
    code, hdr, raw = post(server.url + "/v1/disparity?format=png&tier="
                          "quality", buf.getvalue(), "image/png")
    want_png = _encode_disparity(answers["quality"].disparity, "png")[0]
    if code != 200 or raw != want_png:
        raise AssertionError(f"PNG round trip: {code}, bytes equal "
                             f"{raw == want_png}")
    server_b = StereoHTTPServer(eng_b, port=0).start()
    eng_b.queue.pause()
    held, held_out = [], []

    def held_post():
        out = post(server_b.url + "/v1/disparity", body)
        with lock:
            held_out.append(out[0])

    for _ in range(SERVE_BURST_QUEUE):
        held.append(threading.Thread(target=held_post, daemon=True))
        held[-1].start()
    wait_depth(eng_b, SERVE_BURST_QUEUE)
    burst = [post(server_b.url + "/v1/disparity", body) for _ in range(4)]
    eng_b.queue.resume()
    for t in held:
        t.join(timeout=120)
    shed = [(c, h.get("Retry-After"), json.loads(r)["error"])
            for c, h, r in burst]
    log(f"serving burst past max_queue={SERVE_BURST_QUEUE}: admitted "
        f"{held_out}, beyond the bound {shed}")
    if held_out != [200] * SERVE_BURST_QUEUE or any(
            s != (429, "1", "overloaded") for s in shed):
        raise AssertionError("burst past max_queue")
    code, text = get(server.url + "/metrics")
    missing = [f for f in SERVE_FAMILIES if f not in text.decode()]
    if code != 200 or missing:
        raise AssertionError(f"/metrics {code}, missing {missing}")
    eng.queue.pause()
    inflight, inflight_out = [], []

    def inflight_post():
        out = post(server.url + "/v1/disparity", body)
        with lock:
            inflight_out.append(out[0])

    for _ in range(5):
        inflight.append(threading.Thread(target=inflight_post, daemon=True))
        inflight[-1].start()
    wait_depth(eng, 5)
    eng.begin_shutdown()
    late = post(server.url + "/v1/disparity", body)[0]
    ready_code = get(server.url + "/readyz")[0]
    eng.queue.resume()
    drained = eng.drain(timeout=120)
    for t in inflight:
        t.join(timeout=120)
    log(f"serving drain: in-flight answers {inflight_out}, a request after "
        f"begin_shutdown {late}, /readyz {ready_code}, drained {drained}")
    if (inflight_out != [200] * 5 or late != 503 or ready_code != 503
            or not drained):
        raise AssertionError("begin_shutdown / drain")
    server.shutdown()
    server_b.shutdown()
    eng_b.close()
    phase_s = time.perf_counter() - t_phase
    log(f"phase 30 (serving) took {phase_s:.1f} s")
    return counts_a, counts_b, per_dispatch


def session_frames(left, right, n, brighten=0):
    """A coherent sequence: the pair shifted one pixel a frame (and, with
    ``brighten``, that many grey levels brighter a frame)."""
    out = []
    for k in range(n):
        pair = [np.roll(x, -k, axis=1) for x in (left, right)]
        if brighten:
            pair = [np.clip(x.astype(np.int16) + brighten * k, 0,
                            255).astype(np.uint8) for x in pair]
        out.append(tuple(pair))
    return out


def stream_reference(runner, frames, hidden=False, cap=None):
    """``InferenceRunner.run_stream`` over a chain, under the engine's
    rules: each frame warm from the one before, except after a warm frame
    that ran to ``cap`` (the keyframe guard: the next frame starts cold)."""
    out, prev, hid = [], None, None
    for l_, r_ in frames:
        f = runner.run_stream(l_, r_, prev_flow_low=prev, prev_hidden=hid,
                              carry_hidden=hidden)
        out.append(f)
        guard = cap is not None and f.warm and f.iters_used >= cap
        prev = None if guard else f.flow_low
        hid = None if guard else f.hidden
    return out


def check_chain(what, got, want):
    """Each engine frame bitwise equal to the runner's chain frame (flow,
    state, hidden state, warm flag, iters_used)."""
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not (np.array_equal(g.flow, w.flow)
                   and np.array_equal(g.flow_low, w.flow_low)
                   and g.warm == w.warm
                   and g.iters_used == (w.iters_used or g.iters_used)
                   and (w.hidden is None or all(
                       np.array_equal(a, b)
                       for a, b in zip(g.hidden, w.hidden))))]
    log(f"sessions {what}: {len(got)} frames (warm, iters_used) "
        f"{[(g.warm, g.iters_used) for g in got]}, each bitwise equal to "
        f"run_stream over the same chain: {'ok' if not bad else bad}")
    if bad or len(got) != len(want):
        raise AssertionError(f"sessions {what}: frames {bad} differ from "
                             f"run_stream")


def frame_seconds(results):
    """Median seconds per frame by family: admission to result, and the
    dispatch's device share."""
    by = {}
    for r in results:
        fam = ("warm" if r.warm else "cold") + ("_ctx" if r.ctx_cached
                                                 else "") + (
            "_h" if r.warm_hidden else "")
        by.setdefault(fam, []).append((r.total_s, r.device_s))
    return {k: (round(statistics.median(t for t, _ in v), 5),
                round(statistics.median(d for _, d in v), 5), len(v))
            for k, v in sorted(by.items())}


def program_ms(entry, card_last: int = 0, reps: int = 10):
    """One cached graph's parts, each a median of ``reps`` in ms: the
    upload of its inputs as a session frame gives them (from the host,
    but the last ``card_last``, a context bundle, device to device), the
    replay alone (CUDA events), and the fetch as the program does it (the
    outputs it keeps on the card cloned there)."""
    n_host = len(entry.specs) - card_last
    host = [np.zeros(shape, torch.empty(0, dtype=dtype).numpy().dtype)
            for shape, dtype in entry.specs]
    card = host[:n_host] + [torch.zeros(shape, dtype=dtype, device="cuda")
                            for shape, dtype in entry.specs[n_host:]]
    kept = entry.outputs[len(entry.outputs) - entry.keep_last:]
    times = {k: [] for k in ("upload_ms", "replay_ms", "fetch_ms")}

    def clock(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t0) * 1e3)

    for _ in range(reps):
        clock("upload_ms", lambda: entry._upload(card))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        entry._replay()
        b.record()
        b.synchronize()
        times["replay_ms"].append(a.elapsed_time(b))
        clock("fetch_ms", entry._fetch)
    out = {k: round(statistics.median(v), 4) for k, v in times.items()}
    out["in_MB"] = round(sum(x.nbytes for x in host) / 1e6, 3)
    out["kept_MB"] = round(sum(t.numel() * t.element_size()
                               for t in kept) / 1e6, 3)
    return out


def trained_warm(rt_cfg, trained, pairs):
    """Flow-only warm starts on trained realtime weights, per pair of
    ``pairs`` (name -> (left, right)): an engine whose exit tier's
    threshold is the midpoint of the cold frame's deltas at the middle of
    (EXIT_MIN_ITERS, RT_ITERS), as phase 26 takes it, and one session of
    SESSION_FRAMES frames of the pair shifted a pixel a frame.  Prints the
    cold frame's per-iteration deltas beside the first warm frame's (from
    the cold frame's disparity at its exit depth) and each frame's
    ``iters_used``; returns name -> (cold iters_used, warm iters_used)."""
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine

    out = {}
    for name, (left, right) in pairs.items():
        frames = session_frames(left, right, SESSION_FRAMES)
        probe = InferenceRunner(rt_cfg, trained, iters=RT_ITERS,
                                device="cuda")
        deltas = iteration_deltas(probe, left, right, RT_ITERS)
        thr, used = exit_threshold(deltas, EXIT_MIN_ITERS, RT_ITERS)
        _, disp = loop_deltas(probe.model, *padded_batch(probe, left, right),
                              used)
        warm_deltas, _ = loop_deltas(
            probe.model, *padded_batch(probe, *frames[1]), RT_ITERS, disp)
        del probe
        release()
        eng = ServingEngine(rt_cfg, trained, ServeConfig(
            iters=RT_ITERS, tiers=("quality",
                                   f"interactive:{thr!r}:{EXIT_MIN_ITERS}"),
            sessions=True, batch_sizes=(1,), max_batch=1), device="cuda")
        eng.prewarm(MAIN_HW, tiers=("interactive",))
        got = [eng.infer_session(name, l_, r_, tier="interactive",
                                 timeout=120) for l_, r_ in frames]
        eng.close()
        del eng
        release()
        if not (got[0].iters_used == used
                and all(np.isfinite(g.flow).all() for g in got)):
            raise AssertionError(f"trained {name}: cold frame at "
                                 f"{got[0].iters_used}, want {used}")
        out[name] = (got[0].iters_used, [g.iters_used for g in got[1:]])
        log(f"sessions iters_used on trained weights ({name}, flow-only "
            f"warm starts, threshold {thr:.6g}, cap {RT_ITERS}): cold "
            f"frame's per-iteration deltas {[round(d, 5) for d in deltas]}"
            f", the first warm frame's {[round(d, 5) for d in warm_deltas]}"
            f"; (warm, iters_used) {[(g.warm, g.iters_used) for g in got]}")
    return out


def release() -> None:
    """Collect dropped runners and engines now, on this thread, with the
    card idle: a graph destroyed by a collection that happens to run
    during another capture would invalidate that capture."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_sessions(cfg, state, rt_cfg, rt_state, left, right, exit_thr,
                   trained):
    """Phase 31 (module docstring); ``trained`` the realtime weights of
    phase 28's bf16 leg.  Returns the wrappers' counts over the realtime
    session engines and over the default one, and the launches per frame
    of each family checked."""
    import threading

    from torch.utils._pytree import tree_leaves

    from raft_stereo_tpu_torch.eval.drift import warped_scenes

    from raft_stereo_tpu_torch.eval.runner import (InferenceRunner,
                                                   launch_counts)
    from raft_stereo_tpu_torch.serving import (FAMILY_STATE,
                                               FAMILY_STATE_CTX,
                                               FAMILY_STATE_H, FAMILY_WARM,
                                               FAMILY_WARM_CTX,
                                               FAMILY_WARM_H, ServeConfig,
                                               ServingEngine)
    from raft_stereo_tpu_torch.serving.http import StereoHTTPServer

    release()    # phase 30's engines
    t_phase = time.perf_counter()
    bucket = PADDED_HW
    settled = settle_state(rt_state)
    thr = repr(float(exit_thr))
    tiers = ("quality", f"interactive:{thr}:{EXIT_MIN_ITERS}")
    never = f"never:1e-9:{EXIT_MIN_ITERS}"
    per_frame = {}
    # ---- the runners' chains first, each runner dropped after its use
    chain = session_frames(left, right, SESSION_FRAMES)
    drift = session_frames(left, right, SESSION_DEF_FRAMES, brighten=4)
    r = InferenceRunner(rt_cfg, settled, iters=RT_ITERS, device="cuda",
                        exit_threshold_px=float(exit_thr),
                        exit_min_iters=EXIT_MIN_ITERS)
    want_rt = stream_reference(r, chain, cap=RT_ITERS)
    want_h = stream_reference(r, chain, hidden=True, cap=RT_ITERS)
    solo_s = statistics.median(r(left, right)[1] for _ in range(6))
    del r
    release()
    r = InferenceRunner(cfg, state, iters=MAIN_ITERS, device="cuda")
    want_def = stream_reference(r, drift)
    def_s = statistics.median(r(left, right)[1] for _ in range(4))
    del r
    release()
    log(f"sessions references (run_stream, before the engines): "
        f"{time.perf_counter() - t_phase:.1f} s; realtime interactive "
        f"pair by replay {solo_s:.5f} s")
    # ---- (a) the realtime engine: chains, scene cut, guard, concurrency
    reserved0 = torch.cuda.memory_reserved()
    zero_inference_counts()
    eng = ServingEngine(rt_cfg, settled, ServeConfig(
        iters=RT_ITERS, tiers=tiers + (never,), sessions=True,
        batch_sizes=SESSION_SIZES, max_batch=max(SESSION_SIZES),
        max_cached_shapes=3 * len(SESSION_SIZES) * 3,
        warmup_shapes=(MAIN_HW,), prewarm_on_init=False), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prewarm(MAIN_HW, tiers=("quality", "interactive"))
    prewarm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    programs = len(SESSION_SIZES) * 2 * len(eng._families())
    log(f"sessions prewarm at {MAIN_HW[0]}x{MAIN_HW[1]}: {eng.captures} "
        f"captures ({programs}: tiers quality and interactive x batch "
        f"sizes {SESSION_SIZES} x families {eng._families()}) in "
        f"{prewarm_s:.2f} s; reserved memory {reserved / 2 ** 30:.2f} GiB, "
        f"the engine's {(reserved - reserved0) / 2 ** 30:.2f} GiB of it")
    if eng.captures != programs:
        raise AssertionError(f"{eng.captures} captures, want {programs}")
    got = [eng.infer_session("chain", l_, r_, tier="interactive",
                             timeout=120) for l_, r_ in chain]
    check_chain("realtime interactive chain", got, want_rt)
    cold_iters = got[0].iters_used
    warm_iters = [g.iters_used for g in got[1:]]
    results = list(got)
    for fam, res in ((FAMILY_STATE, got[0]), (FAMILY_WARM, got[1])):
        per_frame[f"realtime {fam}"] = dispatch_counts(
            eng, bucket, 1, "interactive", res.iters_used, fam)
    # a scene cut: the next frame darkened, then the stream goes on warm
    dark = [(x.astype(np.float32) * SCENE_CUT_DIM).astype(np.uint8)
            for x in chain[-1]]
    cut = [eng.infer_session("chain", *dark, tier="interactive",
                             timeout=120) for _ in range(2)]
    ok_cut = (not cut[0].warm and cut[0].scene_cut
              and cut[0].frame_delta > 40.0 and cut[1].warm
              and not cut[1].scene_cut and eng.metrics.scene_cuts.value == 1)
    flags = [(c.warm, c.scene_cut, c.frame_delta) for c in cut]
    log(f"sessions scene cut (the frame darkened to {SCENE_CUT_DIM}): "
        f"(warm, scene_cut, frame_delta) {flags}: "
        f"{'ok' if ok_cut else 'FAILED'}")
    # the keyframe guard: a tier that never exits, every warm frame at
    # the cap, so the frame after it starts cold
    guard = [eng.infer_session("guard", *chain[0], tier="never",
                               timeout=120) for _ in range(3)]
    ok_guard = ([g.warm for g in guard] == [False, True, False]
                and [g.iters_used for g in guard] == [RT_ITERS] * 3
                and eng.metrics.session_reseeds.value == 1)
    log(f"sessions keyframe guard (tier {never}): (warm, iters_used) "
        f"{[(g.warm, g.iters_used) for g in guard]}, reseeds "
        f"{eng.metrics.session_reseeds.value}: "
        f"{'ok' if ok_guard else 'FAILED'}")
    if not (ok_cut and ok_guard):
        raise AssertionError("scene cut or keyframe guard")
    # concurrency: SESSION_CLIENTS sessions, each its own chain
    m = eng.metrics
    done0, batches0 = m.completed.value, m.batches.value
    warm0, cold0 = m.session_frames("warm"), m.session_frames("cold")
    streams, errors = {}, []
    pairs = serve_pairs(left, right)

    def client(k):
        try:
            frames = session_frames(*pairs[k], SESSION_FRAMES)
            streams[k] = [eng.infer_session(f"c{k}", l_, r_,
                                            tier="interactive", timeout=120)
                          for l_, r_ in frames]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(SESSION_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    conc_s = time.perf_counter() - t0
    done, batches = m.completed.value - done0, m.batches.value - batches0
    warm_n = m.session_frames("warm") - warm0
    cold_n = m.session_frames("cold") - cold0
    ordered = all([x.frame_index for x in streams.get(k, [])]
                  == list(range(SESSION_FRAMES))
                  for k in range(SESSION_CLIENTS))
    finite = all(np.isfinite(x.flow).all() for v in streams.values()
                 for x in v)
    mean_batch = done / max(batches, 1)
    ok_conc = (not errors and ordered and finite and mean_batch > 1
               and (cold_n, warm_n) == (SESSION_CLIENTS, SESSION_CLIENTS
                                        * (SESSION_FRAMES - 1)))
    for v in streams.values():
        results += v
    log(f"sessions concurrency: {SESSION_CLIENTS} sessions x "
        f"{SESSION_FRAMES} frames in {conc_s:.2f} s, ordered per session "
        f"{ordered}, cold / warm {cold_n} / {warm_n} (predicted "
        f"{SESSION_CLIENTS} / {SESSION_CLIENTS * (SESSION_FRAMES - 1)}), "
        f"{done} frames in {batches} dispatches, mean batch "
        f"{mean_batch:.3f}, dispatches by size "
        f"{ {n: m.dispatches_at(n) for n in SESSION_SIZES} }, finite "
        f"{finite}, errors {errors[:2]}: {'ok' if ok_conc else 'FAILED'}")
    if not ok_conc:
        raise AssertionError("concurrent sessions")
    parts = {fam: program_ms(eng.program(bucket, 1, "interactive",
                                         family=fam))
             for fam in (FAMILY_STATE, FAMILY_WARM)}
    eng.close()
    del eng
    release()
    # the hidden-state carry, with the HTTP leg's short TTL
    eng_h = ServingEngine(rt_cfg, settled, ServeConfig(
        iters=RT_ITERS, tiers=tiers, sessions=True, session_hidden=True,
        session_ttl_s=SESSION_TTL_S, batch_sizes=(1,), max_batch=1),
        device="cuda")
    eng_h.prewarm(MAIN_HW, tiers=("interactive",))
    got_h = [eng_h.infer_session("chain", l_, r_, tier="interactive",
                                 timeout=120) for l_, r_ in chain]
    check_chain("realtime interactive chain, hidden carry", got_h, want_h)
    results += got_h
    per_frame[f"realtime {FAMILY_WARM_H}"] = dispatch_counts(
        eng_h, bucket, 1, "interactive", got_h[1].iters_used, FAMILY_WARM_H)
    per_frame[f"realtime {FAMILY_STATE_H}"] = dispatch_counts(
        eng_h, bucket, 1, "interactive", got_h[0].iters_used,
        FAMILY_STATE_H)
    parts.update({fam: program_ms(eng_h.program(bucket, 1, "interactive",
                                                 family=fam))
                  for fam in (FAMILY_STATE_H, FAMILY_WARM_H)})
    log(f"sessions realtime programs by part (ms; zero inputs, so the "
        f"replays exit at other depths than the chains'; the flow and the "
        f"hidden state ride the host): {parts}")
    h_iters = [g.iters_used for g in got_h[1:]]
    ok_iters = max(h_iters) < got_h[0].iters_used
    log(f"sessions iters_used on settled weights (threshold {thr}, cap "
        f"{RT_ITERS}): cold frame {cold_iters}, warm frames {warm_iters} "
        f"(the settling GRU's deltas follow its hidden state alone, so a "
        f"flow-only warm start exits where the cold frame does); with the "
        f"hidden state carried: cold {got_h[0].iters_used}, warm {h_iters}"
        f": warm below cold {'ok' if ok_iters else 'FAILED'}")
    if not ok_iters:
        raise AssertionError("warm frames did not exit earlier")
    counts_rt = launch_counts()
    log(f"sessions (a) wrapper counts over the realtime engines' prewarms "
        f"and frames: {counts_rt}")
    # ---- (c) HTTP on the card
    server = StereoHTTPServer(eng_h, port=0).start()
    http_codes = []
    for l_, r_ in chain[:4]:
        code, hdr, _ = post(server.url + "/v1/stream/cam0?tier=interactive",
                            npz_body(l_, r_))
        http_codes.append((code, hdr.get("X-Warm"), hdr.get("X-Frame-Index")))
    import urllib.request
    req = urllib.request.Request(server.url + "/v1/stream/cam0",
                                 method="DELETE")
    with urllib.request.urlopen(req, timeout=60) as resp:
        stats = json.loads(resp.read())
    code, _, _ = post(server.url + "/v1/stream/ttl", npz_body(*chain[0]))
    time.sleep(SESSION_TTL_S + 0.5)
    code_410, _, body_410 = post(server.url + "/v1/stream/ttl",
                                 npz_body(*chain[1]))
    body_410 = json.loads(body_410)
    stateless = ServingEngine(rt_cfg, rt_state, ServeConfig(
        iters=RT_ITERS), device="cuda")
    server_s = StereoHTTPServer(stateless, port=0).start()
    code_400, _, body_400 = post(server_s.url + "/v1/stream/cam0",
                                 npz_body(*chain[0]))
    body_400 = json.loads(body_400)
    ok_http = (http_codes == [(200, "0", "0"), (200, "1", "1"),
                              (200, "1", "2"), (200, "1", "3")]
               and stats["status"] == "closed" and stats["frames"] == 4
               and code == 200 and code_410 == 410
               and body_410["reason"] == "expired" and code_400 == 400
               and body_400["error"] == "sessions_disabled")
    log(f"sessions HTTP: 4 frames {http_codes}, DELETE {stats}; after the "
        f"{SESSION_TTL_S} s TTL {code_410} {body_410}; a stateless engine "
        f"{code_400} {body_400}: {'ok' if ok_http else 'FAILED'}")
    server.shutdown()
    server_s.shutdown()
    stateless.close()
    eng_h.close()
    del eng_h, stateless
    release()
    if not ok_http:
        raise AssertionError("the stream protocol on the card")
    textured = warped_scenes(MAIN_HW, 1, 6.0, seed=SEED)[0][:2]
    trained_iters = trained_warm(rt_cfg, trained, {
        "the main pair": (left, right),
        "a textured scene of the training's kind": tuple(
            np.clip(np.round(x), 0, 255).astype(np.uint8)
            for x in textured)})
    log(f"sessions iters_used on trained weights, (cold, warm frames) by "
        f"pair (a measurement: the brief training never saw a warm start, "
        f"and its first warm update overshoots): {trained_iters}")
    # ---- (b) the default engine, fp32, 32 iterations, with the ctx cache
    zero_inference_counts()
    eng_b = ServingEngine(cfg, state, ServeConfig(
        iters=MAIN_ITERS, sessions=True, session_ctx_cache=True,
        batch_sizes=(1,), max_batch=1), device="cuda")
    eng_b.prewarm(MAIN_HW)
    got_b = [eng_b.infer_session("drift", l_, r_, timeout=120)
             for l_, r_ in drift]
    check_chain("default chain (4 grey levels brighter a frame: past the "
                "ctx gate)", got_b, want_def)
    results_b = list(got_b)
    static, snaps = [], []
    for _ in range(SESSION_DEF_FRAMES):
        sess = eng_b.sessions.get_or_create("static")[0]
        snaps.append((None if sess.flow_low is None
                      else sess.flow_low.copy(), sess.ctx))
        static.append(eng_b.infer_session("static", left, right,
                                          timeout=120))
    results_b += static
    per_frame[f"default {FAMILY_STATE_CTX}"] = dispatch_counts(
        eng_b, bucket, 1, None, MAIN_ITERS, FAMILY_STATE_CTX)
    per_frame[f"default {FAMILY_WARM_CTX}"] = dispatch_counts(
        eng_b, bucket, 1, None, MAIN_ITERS, FAMILY_WARM_CTX)
    per_frame[f"default {FAMILY_WARM}"] = dispatch_counts(
        eng_b, bucket, 1, None, MAIN_ITERS, FAMILY_WARM)
    hits = eng_b.metrics.ctx_cache_hits.value
    counts_def = launch_counts()
    parts = {fam: program_ms(eng_b.program(bucket, 1, None, family=fam),
                             4 * cfg.n_gru_layers
                             if fam == FAMILY_WARM_CTX else 0)
             for fam in (FAMILY_STATE_CTX, FAMILY_WARM, FAMILY_WARM_CTX)}
    log(f"sessions default engine's programs by part (ms; the context "
        f"bundle stays on the card): {parts}")
    log(f"sessions (b) wrapper counts over the default engine's prewarm "
        f"and frames: {counts_def}")
    eng_b.close()
    del eng_b
    release()
    r = InferenceRunner(cfg, state, iters=MAIN_ITERS, device="cuda")
    cold_ref = r.run_stream(left, right, save_ctx=True)
    same = [np.array_equal(static[0].flow, cold_ref.flow)]
    bundle_same = all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                      for a, b in zip(tree_leaves(snaps[1][1]),
                                      tree_leaves(cold_ref.ctx)))
    for res, (flow_low, ctx) in zip(static[1:], snaps[1:]):
        ref = r.run_stream(left, right, prev_flow_low=flow_low,
                           prev_ctx=ctx)
        same.append(np.array_equal(res.flow, ref.flow)
                    and np.array_equal(res.flow_low, ref.flow_low))
    plain = r.run_stream(left, right, prev_flow_low=snaps[1][0])
    plain_d = float(np.abs(static[1].flow - plain.flow).max())
    del r, cold_ref
    release()
    ok_ctx = (all(same) and bundle_same and plain_d == 0.0
              and hits == SESSION_DEF_FRAMES - 1
              and [x.ctx_cached for x in static]
              == [False] + [True] * (SESSION_DEF_FRAMES - 1))
    log(f"sessions ctx cache (default engine, a static scene): hits {hits}"
        f" (predicted {SESSION_DEF_FRAMES - 1}: every warm frame at delta "
        f"0); the bundle the cold frame saved bitwise equal to run_stream's"
        f" save_ctx bundle {bundle_same}; the cold frame bitwise equal to "
        f"run_stream's and each hit to run_stream with prev_ctx on the "
        f"saved bundle {same}; the first hit against the plain warm frame "
        f"from the same state (the context encoder run again) max |d| "
        f"{plain_d:.3e} px (must be 0): {'ok' if ok_ctx else 'FAILED'}")
    if not ok_ctx:
        raise AssertionError("the ctx cache")
    log(f"sessions seconds per frame (median admission-to-result, median "
        f"device share, frames) by family: realtime "
        f"{frame_seconds(results)}, the interactive pair alone by the "
        f"runner's replay {solo_s:.5f} s; default {frame_seconds(results_b)}"
        f", the pair alone by the runner's replay {def_s:.5f} s")
    log(f"sessions launches per frame: {per_frame}")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 31 (sessions) took {phase_s:.1f} s")
    return counts_rt, counts_def, per_frame


T_START = time.perf_counter()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def boot_to_ready(pkg_root, ckpt, store=None, timeout=600.0):
    """Start ``cli/serve.py`` from the package copy at ``pkg_root`` (no
    ``_build/``) on the realtime checkpoint ``ckpt``, with the artifact
    store ``store`` read-only where given; ``(process, url, seconds from
    the start to /readyz 200)``."""
    port = free_port()
    cmd = [sys.executable, "-m", "raft_stereo_tpu_torch.cli.serve",
           "--restore_ckpt", ckpt, "--host", "127.0.0.1",
           "--port", str(port), "--valid_iters", str(RT_ITERS),
           "--tiers", "quality", "--batch_sizes", "1", "--max_batch", "1",
           "--warmup_shape", f"{MAIN_HW[0]}x{MAIN_HW[1]}"]
    if store is not None:
        cmd += ["--executable_cache_dir", store,
                "--executable_cache_read_only"]
    env = dict(os.environ, PYTHONPATH=pkg_root)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=pkg_root, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"serve exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-3000:]}")
        try:
            code, _ = get(url + "/readyz", timeout=5)
        except OSError:
            code = None
        if code == 200:
            return proc, url, time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            proc.kill()
            raise AssertionError(f"serve not ready in {timeout} s")
        time.sleep(0.25)


def stop_server(proc) -> int:
    """SIGTERM (the CLI's graceful drain), then wait; kill past 60 s."""
    import signal as signal_mod
    proc.send_signal(signal_mod.SIGTERM)
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait()


def npy_of(body: bytes) -> np.ndarray:
    import io
    return np.load(io.BytesIO(body), allow_pickle=False)


def phase_serving_b(rt_cfg, rt_state, left, right, exit_thr, sweep_trained,
                    card):
    """Phase 35 (module docstring).  Returns the wrappers' counts over
    the realtime engines and over the confidence report, and the printed
    measurements."""
    import tempfile
    import threading

    from raft_stereo_tpu_torch.eval.runner import (InferenceRunner,
                                                   launch_counts)
    from raft_stereo_tpu_torch.io.jax_weights import save_checkpoint
    from raft_stereo_tpu_torch.kernels import _build
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine
    from raft_stereo_tpu_torch.serving import tiles
    from raft_stereo_tpu_torch.serving.http import StereoHTTPServer
    import urllib.request
    from raft_stereo_tpu_torch.serving.models import ModelStore
    from raft_stereo_tpu_torch.tools import compile_farm
    from raft_stereo_tpu_torch.tools import confidence_report as cr

    t_phase = time.perf_counter()
    rt_counts, report_counts = {}, {}

    def take(into):
        for k_, v_ in launch_counts().items():
            into[k_] = into.get(k_, 0) + v_
        zero_inference_counts()

    settled = settle_state(rt_state)
    work = tempfile.mkdtemp(prefix="phase35-")
    out = {}
    try:
        # ---- (a) halo row tiles ------------------------------------------
        t_a = time.perf_counter()
        rs = np.random.default_rng(SEED + 35)
        big_l = rs.integers(0, 256, TILE_HW + (3,), dtype=np.uint8)
        big_r = np.roll(big_l, -4, axis=1)
        specs = tiles.plan_tiles(TILE_HW[0], TILE_ROWS, TILE_HALO)
        tile_hw = (specs[0].height, TILE_HW[1])
        sl = [np.ascontiguousarray(big_l[s_.src0:s_.src1]) for s_ in specs]
        sr = [np.ascontiguousarray(big_r[s_.src0:s_.src1]) for s_ in specs]
        ref = InferenceRunner(rt_cfg, settled, iters=RT_ITERS, device="cuda")
        rows, _ = ref.run_batch(sl, sr)
        rows = [np.asarray(r_) for r_ in rows]
        del ref
        release()
        tiling = dict(tile_threshold_pixels=TILE_THRESHOLD,
                      tile_rows=TILE_ROWS, tile_halo=TILE_HALO)
        zero_inference_counts()
        eng = ServingEngine(rt_cfg, settled, ServeConfig(
            iters=RT_ITERS, tiers=("quality",), batch_sizes=(1, 2, 4),
            max_batch=4, prewarm_on_init=False, **tiling), device="cuda")
        eng.prewarm(tile_hw, batch_sizes=(4,))
        b0 = eng.metrics.batches.value
        eng.queue.pause()
        fut = eng.submit(big_l, big_r)
        eng.queue.resume()
        res = fut.result(timeout=300)
        one_dispatch = eng.metrics.batches.value - b0 == 1
        eng.queue.pause()
        futs = [eng.submit(l_, r_) for l_, r_ in zip(sl, sr)]
        eng.queue.resume()
        tile_res = [f_.result(timeout=300) for f_ in futs]
        secs = []
        for _ in range(TILE_REPS):
            eng.queue.pause()
            fut = eng.submit(big_l, big_r)
            eng.queue.resume()
            secs.append(fut.result(timeout=300).total_s)
        per_dispatch = dispatch_counts(eng, tile_hw, 4, "quality",
                                       RT_ITERS)
        tier_dispatch_counts(per_dispatch, "quality", RT_ITERS)
        eng.close()
        del eng
        take(rt_counts)
        release()
        ok = (len(specs) == 4 and tile_hw == (640, 2880) and one_dispatch
              and res.tiles == 4 and res.batch_size == 4
              and all(t_.batch_size == 4 for t_ in tile_res)
              and all(np.array_equal(t_.flow, r_)
                      for t_, r_ in zip(tile_res, rows))
              and np.array_equal(res.flow, tiles.stitch(rows, specs))
              and res.seam_epe == tiles.seam_epe(rows, specs)
              and res.flow.shape == TILE_HW)
        out["tiles"] = {"seam_epe": res.seam_epe,
                        "seconds_per_request": secs,
                        "launches_per_dispatch": per_dispatch}
        log(f"tiles: a {TILE_HW[0]}x{TILE_HW[1]} pair past "
            f"{TILE_THRESHOLD} pixels as {len(specs)} tiles of "
            f"{tile_hw[0]} rows (owned {[s_.y1 - s_.y0 for s_ in specs]}, "
            f"halo {TILE_HALO}) in one batch-{res.batch_size} dispatch: "
            f"{one_dispatch}; each tile row bitwise equal to the runner's "
            f"run_batch of the four slices, the stitched flow to "
            f"tiles.stitch of those rows; seam EPE {res.seam_epe!r} px; "
            f"seconds per tiled request (admission to stitched, "
            f"{TILE_REPS} requests) {[round(x_, 5) for x_ in secs]}, "
            f"median {statistics.median(secs):.5f}; launches per dispatch "
            f"{per_dispatch}; (a) took {time.perf_counter() - t_a:.1f} s on "
            f"{card}: {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("tiles failed their checks")

        # ---- (b) the confidence-gated cascade ----------------------------
        t_b = time.perf_counter()
        exit_tier = f"interactive:{float(exit_thr)!r}:{EXIT_MIN_ITERS}"
        pairs = serve_pairs(left, right, SERVE_CONTRASTS)
        draft_r = InferenceRunner(rt_cfg, settled, iters=RT_ITERS,
                                  device="cuda", exit_threshold_px=exit_thr,
                                  exit_min_iters=EXIT_MIN_ITERS)
        drafts = [draft_r(l_, r_)[0] for l_, r_ in pairs]
        del draft_r
        release()
        quality_r = InferenceRunner(rt_cfg, settled, iters=RT_ITERS,
                                    device="cuda")
        quals = [quality_r(l_, r_)[0] for l_, r_ in pairs]
        del quality_r
        release()
        zero_inference_counts()
        base = dict(iters=RT_ITERS, tiers=("quality", exit_tier),
                    confidence=True, prewarm_on_init=False)
        probe = ServingEngine(rt_cfg, settled, ServeConfig(
            batch_sizes=(1,), max_batch=1, **base), device="cuda")
        confs = [probe.infer(l_, r_, tier="interactive",
                             timeout=120).confidence_mean
                 for l_, r_ in pairs]
        probe.close()
        del probe
        take(rt_counts)
        release()
        ordered = sorted(confs)
        gap = int(np.argmax(np.diff(ordered)))
        threshold = (ordered[gap] + ordered[gap + 1]) / 2
        eng = ServingEngine(rt_cfg, settled, ServeConfig(
            batch_sizes=(1, 2, 4), max_batch=4, cascade=True,
            cascade_threshold=threshold, **tiling, **base), device="cuda")
        got = [eng.infer(l_, r_, tier="auto", timeout=120)
               for l_, r_ in pairs]
        want_esc = [c_ < threshold for c_ in confs]
        ok = (eng._cascade_draft, eng._cascade_escalate) == (
            "interactive", "quality")
        for g_, d_, q_, e_ in zip(got, drafts, quals, want_esc):
            ok = (ok and g_.escalated == e_
                  and g_.draft_tier == "interactive"
                  and g_.tier == ("quality" if e_ else "interactive")
                  and np.array_equal(g_.flow, q_ if e_ else d_))
        big = eng.infer(big_l, big_r, tier="auto", timeout=300)
        n_draft = eng._cascade_drafts.value
        n_esc = eng._cascade_escalations.value
        ok = (ok and 0 < sum(want_esc) < len(pairs)
              and n_draft + n_esc == len(pairs) + len(specs)
              and big.tiles == len(specs) and big.flow.shape == TILE_HW
              and bool(np.isfinite(big.flow).all())
              and big.draft_tier == "interactive")
        eng.close()
        del eng
        take(rt_counts)
        release()
        log(f"cascade (tier=auto, draft interactive at {float(exit_thr):.6g}"
            f" px, escalate quality): draft confidences per contrast "
            f"{dict(zip(SERVE_CONTRASTS, [round(c_, 5) for c_ in confs]))},"
            f" threshold {threshold:.5f}; escalated "
            f"{[g_.escalated for g_ in got]}; drafts bitwise equal to the "
            f"exit runner's replay, escalations to the quality runner's; "
            f"the tiled request {big.tiles} tiles, escalated {big.escalated},"
            f" worst draft confidence {big.draft_confidence:.5f}; counters "
            f"draft {n_draft} + escalated {n_esc} = {n_draft + n_esc} "
            f"requests and tiles: {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("the cascade failed its checks")
        t_r = time.perf_counter()
        rep_args = cr.build_parser().parse_args(
            ["--device", "cuda", "--out",
             os.path.join(work, "CONFIDENCE_torch.json")])
        rec = cr.run(rep_args, trained=sweep_trained)
        take(report_counts)
        release()
        cal, cas = rec["calibration"], rec["cascade"]
        aurocs = [v_["auroc"] for v_ in cal.values()
                  if v_["auroc"] is not None]
        ok = (set(cal) == set(cr.VALIDATORS) and bool(aurocs)
              and all(0.0 <= a_ <= 1.0 for a_ in aurocs)
              and math.isfinite(cas["mean_epe_auto"])
              and cas["requests"] == 4 * rep_args.images)
        out["report"] = {"auroc": {k_: v_["auroc"] for k_, v_ in
                                   cal.items()},
                         "spearman": {k_: v_["spearman_conf_vs_err"]
                                      for k_, v_ in cal.items()},
                         "cascade": cas}
        log(f"confidence report on phase 34's weights (no second training;"
            f" {rep_args.images} images per validator at {rep_args.hw}, "
            f"static depth {rep_args.iters}, draft {rep_args.draft}): AUROC "
            f"{out['report']['auroc']}; Spearman "
            f"{out['report']['spearman']}; cascade cost "
            f"{cas['mean_cost_iters_auto']} against "
            f"{cas['mean_cost_iters_static']} iterations per request "
            f"(ratio {cas['cost_ratio_auto_vs_static']}), dEPE "
            f"{cas['depe_auto_vs_static']} px, escalated "
            f"{cas['escalated']} of {cas['requests']} (measurements); "
            f"{time.perf_counter() - t_r:.1f} s: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("the confidence report failed its checks")
        log(f"(b) took {time.perf_counter() - t_b:.1f} s")

        # ---- (c) the model store ----------------------------------------
        t_c = time.perf_counter()
        store = ModelStore(os.path.join(work, "store"))
        store.publish("rt-a", "v1", rt_cfg, rt_state)
        store.publish("rt-b", "v2", rt_cfg, settled)
        want = {}
        for name_, sd in (("rt-a", rt_state), ("rt-b", settled),
                          (None, rt_state)):
            r_ = InferenceRunner(rt_cfg, sd, iters=RT_ITERS, device="cuda")
            want[name_] = r_(left, right)[0]
            del r_
            release()
        zero_inference_counts()
        # batch 1 alone: every answer under load is the runner's program
        eng = ServingEngine(rt_cfg, rt_state, ServeConfig(
            iters=RT_ITERS, tiers=("quality",), batch_sizes=(1,),
            max_batch=1, model_store_dir=store.root,
            warmup_shapes=(MAIN_HW,), prewarm_on_init=False),
            device="cuda")
        eng.prewarm(MAIN_HW)
        server = StereoHTTPServer(eng, port=0).start()
        body = npz_body(left, right)

        def admin(payload):
            code_, _, raw_ = post(server.url + "/admin/models",
                                  json.dumps(payload).encode(),
                                  ctype="application/json")
            return code_, json.loads(raw_)

        codes = [admin({"action": "register", "model": "rt-b@v2"})[0]]
        release()
        r_weights0 = torch.cuda.memory_reserved()
        codes.append(admin({"action": "register", "model": "rt-a@v1",
                            "prewarm": False})[0])
        release()
        r_weights = torch.cuda.memory_reserved()
        eng.prewarm(MAIN_HW, models=["rt-a"])
        release()
        r_captured = torch.cuda.memory_reserved()
        cap_bytes = r_captured - r_weights
        answers = {}
        for how, url_, hdr in (
                ("?model=rt-a", "/v1/disparity?model=rt-a&format=npy", {}),
                ("X-Model: rt-b", "/v1/disparity?format=npy",
                 {"X-Model": "rt-b"}),
                ("unnamed", "/v1/disparity?format=npy", {})):
            req = urllib.request.Request(
                server.url + url_, data=body, method="POST",
                headers={"Content-Type": "application/x-npz", **hdr})
            with urllib.request.urlopen(req, timeout=120) as resp:
                answers[how] = (resp.status, dict(resp.headers),
                                npy_of(resp.read()))
        ok = (codes == [200, 200]
              and np.array_equal(-answers["?model=rt-a"][2], want["rt-a"])
              and answers["?model=rt-a"][1].get("X-Model-Version") == "v1"
              and np.array_equal(-answers["X-Model: rt-b"][2], want["rt-b"])
              and answers["X-Model: rt-b"][1].get("X-Model-Version") == "v2"
              and np.array_equal(-answers["unnamed"][2], want[None])
              and "X-Model" not in answers["unnamed"][1])
        main_flow = eng.infer(left, right, timeout=120).flow
        codes.append(admin({"action": "set_default", "model": "rt-b"})[0])
        load = {"codes": [], "equal": True, "stop": False}

        def client():
            while not load["stop"]:
                code_, _, raw_ = post(server.url + "/v1/disparity"
                                      "?format=npy", body)
                load["codes"].append(code_)
                if code_ == 200:
                    load["equal"] &= bool(np.array_equal(
                        -npy_of(raw_), want["rt-b"]))

        clients = [threading.Thread(target=client, daemon=True)
                   for _ in range(MODEL_LOAD_CLIENTS)]
        for c_ in clients:
            c_.start()
        time.sleep(1.0)
        # reserved under load, just before the retirement (what the load
        # itself reserved stays; the retirement must return at least what
        # rt-a's captures took)
        r_loaded = torch.cuda.memory_reserved()
        t_ret = time.perf_counter()
        code_ret, ret = admin({"action": "retire", "model": "rt-a"})
        retire_s = time.perf_counter() - t_ret
        time.sleep(1.0)
        load["stop"] = True
        for c_ in clients:
            c_.join(timeout=120)
        gone = "rt-a" not in eng._models
        after_404 = post(server.url + "/v1/disparity?model=rt-a&format=npy",
                         body)[0]
        release()
        r_after = torch.cuda.memory_reserved()
        server.shutdown()
        eng.close()
        ok = (ok and codes[2] == 200 and code_ret == 200 and gone
              and after_404 == 404 and len(load["codes"]) > 0
              and set(load["codes"]) == {200} and load["equal"]
              and r_loaded - r_after >= cap_bytes)
        del eng
        take(rt_counts)
        release()
        out["models"] = {"capture_bytes": cap_bytes,
                         "freed_bytes": r_loaded - r_after,
                         "retire_s": retire_s}
        log(f"model store: rt-a@v1 and rt-b@v2 published, registered over "
            f"POST /admin/models {codes[:2]}; ?model=rt-a, X-Model: rt-b and "
            f"the implicit model each bitwise equal to a runner on its "
            f"weights (X-Model-Version v1 / v2); default -> rt-b; rt-a "
            f"retired in {retire_s:.3f} s under {MODEL_LOAD_CLIENTS} "
            f"clients' load ({len(load['codes'])} requests, statuses "
            f"{sorted(set(load['codes']))}, answers rt-b's: "
            f"{load['equal']}), its programs gone: {gone}, then 404; "
            f"reserved {r_weights0 / 2 ** 30:.3f} GiB before rt-a, "
            f"{r_weights / 2 ** 30:.3f} with its weights, "
            f"{r_captured / 2 ** 30:.3f} with its captures "
            f"(+{cap_bytes / 2 ** 20:.1f} MiB), {r_loaded / 2 ** 30:.3f} "
            f"under load before the retirement, {r_after / 2 ** 30:.3f} "
            f"after it (freed {(r_loaded - r_after) / 2 ** 20:.1f} MiB): "
            f"{'ok' if ok else 'FAILED'}; (c) took "
            f"{time.perf_counter() - t_c:.1f} s")
        if not ok:
            raise AssertionError("the model store failed its checks")

        # ---- (d) the artifact store --------------------------------------
        t_d = time.perf_counter()
        farm_dir = os.path.join(work, "artifacts")
        farm_manifest = os.path.join(work, "farm.json")
        if compile_farm.main(["--out", farm_dir, "--manifest",
                              farm_manifest]) != 0:
            raise AssertionError("compile_farm failed")
        with open(farm_manifest) as f_:
            farm = json.load(f_)
        ckpt = os.path.join(work, "rt_ckpt")
        save_checkpoint(ckpt, rt_cfg, rt_state)
        boots = {}
        for how in ("store", "cold"):
            root = os.path.join(work, f"copy_{how}")
            shutil.copytree(
                os.path.join(HERE, "raft_stereo_tpu_torch"),
                os.path.join(root, "raft_stereo_tpu_torch"),
                ignore=shutil.ignore_patterns("_build", "__pycache__"))
            proc, url, boot_s = boot_to_ready(
                root, ckpt, farm_dir if how == "store" else None)
            try:
                code, ready = get(url + "/readyz")
                status, _, raw = post(url + "/v1/disparity?format=npy",
                                      npz_body(left, right))
            finally:
                rc = stop_server(proc)
            built = os.path.join(root, "raft_stereo_tpu_torch", "_build")
            names = os.listdir(built) if os.path.isdir(built) else []
            boots[how] = {
                "boot_s": boot_s, "rc": rc, "status": status,
                "equal": status == 200 and np.array_equal(-npy_of(raw),
                                                          main_flow),
                "libraries": sum(n_.endswith(".so") and "-" in n_
                                 and not n_.startswith("stereo_native")
                                 for n_ in names),
                "nvcc_logs": sum(n_.endswith(".log") for n_ in names),
                "cache": json.loads(ready).get("executable_cache")}
        n_src = len(_build.sources())
        st, cold = boots["store"], boots["cold"]
        # a process builds (or fetches) the libraries its path loads: the
        # realtime quality path's alt and gate kernels
        ok = (len(farm["libraries"]) == n_src and farm["stored"] == n_src
              and st["equal"] and cold["equal"]
              and st["libraries"] >= 2 and st["nvcc_logs"] == 0
              and st["cache"] is not None
              and st["cache"]["loads"] == st["libraries"]
              and st["cache"]["misses"] == 0 and st["cache"]["stores"] == 0
              and cold["nvcc_logs"] == cold["libraries"] >= 2
              and st["rc"] == 0 and cold["rc"] == 0)
        out["store"] = {"boot_store_s": st["boot_s"],
                        "boot_cold_s": cold["boot_s"]}
        log(f"artifact store: compile_farm stored {farm['stored']} of "
            f"{len(farm['libraries'])} libraries ({farm['nvcc_runs']} nvcc "
            f"runs: _build/ already held them; {farm['store_bytes']} bytes, "
            f"toolkit {farm['toolkit']}); cli/serve.py from a copy of the "
            f"package without _build/, the store read-only: /readyz 200 "
            f"(boot to ready, the realtime quality ladder at "
            f"{MAIN_HW[0]}x{MAIN_HW[1]}) "
            f"after {st['boot_s']:.2f} s, {st['libraries']} libraries "
            f"fetched, {st['nvcc_logs']} nvcc runs, store stats "
            f"{st['cache']}, its answer bitwise equal to this process's: "
            f"{st['equal']}; a cold boot (no store, nvcc) {cold['boot_s']:.2f}"
            f" s, {cold['nvcc_logs']} nvcc runs, answer equal: "
            f"{cold['equal']}; exits {st['rc']} / {cold['rc']}: "
            f"{'ok' if ok else 'FAILED'}; (d) took "
            f"{time.perf_counter() - t_d:.1f} s")
        if not ok:
            raise AssertionError("the artifact store failed its checks")

        # ---- (e) session handoff -----------------------------------------
        t_e = time.perf_counter()
        hdir = os.path.join(work, "handoff")
        kw = dict(iters=RT_ITERS, tiers=("quality",), sessions=True,
                  session_hidden=True, batch_sizes=(1,), max_batch=1,
                  executable_cache_dir=hdir, prewarm_on_init=False)
        sids = [f"cam{k}" for k in range(HANDOFF_SESSIONS)]
        chains = {sid: session_frames(l_, r_, HANDOFF_FRAMES + 1)
                  for sid, (l_, r_) in zip(sids, serve_pairs(left, right))}
        zero_inference_counts()
        eng_a = ServingEngine(rt_cfg, settled, ServeConfig(**kw),
                              device="cuda")
        for k in range(HANDOFF_FRAMES):
            for sid in sids:
                eng_a.infer_session(sid, *chains[sid][k], timeout=120)
        nexts = {}
        for sid in sids:
            meta, arrays = eng_a.sessions.get(sid).to_record()
            copy_id = f"copy-{sid}"
            sess, _ = eng_a.sessions.get_or_create(copy_id)
            with sess.order_lock:
                eng_a.sessions.adopt(sess, dict(meta), {
                    k_: (None if v_ is None else
                         tuple(x_.copy() for x_ in v_)
                         if isinstance(v_, tuple) else v_.copy())
                    for k_, v_ in arrays.items() if k_ != "ctx"})
            nexts[sid] = eng_a.infer_session(
                copy_id, *chains[sid][HANDOFF_FRAMES], timeout=120)
            eng_a.close_session(copy_id)
        eng_a.begin_shutdown()
        manifest = eng_a.publish_handoff()
        drained = eng_a.drain(timeout=60)
        del eng_a
        eng_b = ServingEngine(rt_cfg, settled, ServeConfig(**kw),
                              device="cuda")
        server = StereoHTTPServer(eng_b, port=0).start()
        adopted = {}
        for sid in sids:
            req = urllib.request.Request(
                server.url + f"/v1/stream/{sid}?format=npy",
                data=npz_body(*chains[sid][HANDOFF_FRAMES]), method="POST",
                headers={"Content-Type": "application/x-npz",
                         "X-Handoff-Artifact": manifest["artifact"]})
            with urllib.request.urlopen(req, timeout=120) as resp:
                adopted[sid] = (dict(resp.headers), npy_of(resp.read()))
        server.shutdown()
        n_adopted = eng_b.metrics.sessions_adopted.value
        eng_b.close()
        del eng_b
        eng_c = ServingEngine(rt_cfg, settled, ServeConfig(
            **dict(kw, iters=RT_ITERS + 1)), device="cuda")
        other = eng_c.infer_session(sids[0], *chains[sids[0]][
            HANDOFF_FRAMES], handoff_key=manifest["artifact"], timeout=120)
        mismatch = eng_c.metrics.handoff_skips("config_mismatch")
        eng_c.close()
        del eng_c
        take(rt_counts)
        release()
        ok = (drained and sorted(manifest["sessions"]) == sorted(sids)
              and manifest["count"] == len(sids)
              and n_adopted == len(sids)
              and not other.warm and mismatch == len(sids))
        for sid in sids:
            hdr, disp = adopted[sid]
            ok = (ok and hdr.get("X-Warm") == "1"
                  and hdr.get("X-Frame-Index") == str(HANDOFF_FRAMES)
                  and nexts[sid].warm and nexts[sid].warm_hidden
                  and np.array_equal(-disp, nexts[sid].flow))
        log(f"handoff: engine A served {len(sids)} sessions (state_h, "
            f"warm_h) {HANDOFF_FRAMES} frames each, drained ({drained}) and"
            f" published {manifest['count']} sessions under "
            f"{manifest['config_fingerprint'][:12]}; engine B adopted each "
            f"through X-Handoff-Artifact ({n_adopted}), its frame "
            f"{HANDOFF_FRAMES} warm and bitwise equal to A's next frame "
            f"from a copy of the same state; an engine at "
            f"{RT_ITERS + 1} iterations refused the blob as config_mismatch"
            f" ({mismatch} sessions) and started cold: "
            f"{'ok' if ok else 'FAILED'}; (e) took "
            f"{time.perf_counter() - t_e:.1f} s")
        if not ok:
            raise AssertionError("the session handoff failed its checks")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 35 wrapper counts: realtime engines {rt_counts}, the "
        f"confidence report {report_counts}; phase 35 took "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return rt_counts, report_counts, out


def fleet_copy(work: str, name: str) -> str:
    """A copy of the package without ``_build/`` under ``work``: a process
    started from it fetches every kernel library from the artifact store,
    or builds it (an ``nvcc`` run leaves a ``.log`` beside the library)."""
    root = os.path.join(work, f"pkg-{name}")
    shutil.copytree(os.path.join(HERE, "raft_stereo_tpu_torch"),
                    os.path.join(root, "raft_stereo_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return root


def built_in(root: str):
    """(kernel libraries, ``nvcc`` logs) in a package copy's ``_build/``."""
    built = os.path.join(root, "raft_stereo_tpu_torch", "_build")
    names = os.listdir(built) if os.path.isdir(built) else []
    return (sum(n_.endswith(".so") and "-" in n_
                and not n_.startswith("stereo_native") for n_ in names),
            sum(n_.endswith(".log") for n_ in names))


def log_tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, errors="replace") as f_:
            return f_.read()[-n:]
    except OSError:
        return ""


def wait_until(cond, what: str, timeout: float, alive=None, log_path=None,
               every: float = 0.05):
    """Poll ``cond()`` until it is true; seconds waited.  Fails past
    ``timeout`` or when ``alive()`` says the process under test exited."""
    t0 = time.perf_counter()
    while True:
        if alive is not None and not alive():
            raise AssertionError(f"{what}: the process exited; "
                                 f"{log_tail(log_path or '')}")
        try:
            if cond():
                return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s; "
                                 f"{log_tail(log_path or '')}")
        time.sleep(every)


def json_get(url: str):
    code, raw = get(url, timeout=10)
    return code, (json.loads(raw) if raw[:1] in (b"{", b"[") else raw)


def metric(text: str, name: str) -> float:
    hits = re.findall(rf"^{name}(?:{{[^}}]*}})?\s+([0-9.eE+-]+)$", text,
                      re.M)
    return sum(float(h_) for h_ in hits)


def start_router(work, name, replicas, extra=(), root=HERE):
    """``python -m raft_stereo_tpu_torch.cli.route`` from the package at
    ``root`` over ``replicas`` (name -> URL); ``(process, url, log)``."""
    port = free_port()
    log_path = os.path.join(work, f"{name}.log")
    # probes every 0.1 s, each allowed 3 s: a replica whose handler
    # threads decode 2.8 MB bodies under load can take longer than the
    # default 1 s to answer /healthz, and two late answers in a row would
    # read as a death (seen on one H100: a session typed lost that way)
    argv = [sys.executable, "-P", "-m", "raft_stereo_tpu_torch.cli.route",
            "--host", "127.0.0.1", "--port", str(port), "--name", name,
            "--health_poll_s", "0.1", "--health_timeout_s", "3",
            "--fail_after", "2",
            "--request_timeout_s", "120", "--no-fleet_brownout",
            "--lease_ttl_s", "2.0", "--federation_poll_s", "0.5"]
    for rname, url in replicas.items():
        argv += ["--replica", f"{rname}={url}"]
    with open(log_path, "w") as fh:
        proc = subprocess.Popen(argv + list(extra), cwd=root,
                                env=dict(os.environ, PYTHONPATH=root),
                                stdout=fh, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", log_path


def closed_loop(urls, body, clients: int, seconds: float, stop=None,
                path: str = "/v1/disparity?format=npy"):
    """``clients`` threads posting ``body`` as npz until ``seconds`` pass
    (or ``stop`` is set), each over one kept-alive connection per URL;
    each request tries ``urls`` in order from the one that last answered,
    the next one only on a transport failure (a client's failover).  Returns ``[(status, seconds,
    attempts)]``, ``attempts`` a ``(url index, status or error, seconds)``
    per URL tried.  Kept-alive: a connection per request that the server
    closes leaves the server's end in TIME_WAIT, and a new connection
    from the same port meets it (measured on one H100: single requests
    waited 63 s, the SYN retries' sum)."""
    import http.client
    import threading

    done, t_end = [], time.perf_counter() + seconds
    lock = threading.Lock()

    def client():
        conns = {}

        def send(url):
            conn = conns.get(url)
            if conn is None:
                host, port = url.rsplit("/", 1)[1].split(":")
                conn = conns[url] = http.client.HTTPConnection(
                    host, int(port), timeout=120)
            try:
                conn.request("POST", path, body,
                             {"Content-Type": "application/x-npz"})
                resp = conn.getresponse()
                resp.read()
                return resp.status
            except BaseException:
                conns.pop(url).close()
                raise

        first = 0               # a client stays with the URL that answered
        while time.perf_counter() < t_end and not (stop and stop.is_set()):
            t0 = time.perf_counter()
            status, attempts = None, []
            for i_ in range(first, len(urls)):
                t1 = time.perf_counter()
                try:
                    status = send(urls[i_])
                    attempts.append((i_, status, time.perf_counter() - t1))
                    first = i_
                    break
                except (OSError, http.client.HTTPException) as e:
                    # refused, reset or cut short: the next URL
                    attempts.append((i_, type(e).__name__,
                                     time.perf_counter() - t1))
            with lock:
                done.append((status, time.perf_counter() - t0, attempts))
        for conn in conns.values():
            conn.close()

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for t_ in threads:
        t_.start()
    for t_ in threads:
        t_.join(timeout=seconds + 300)
    return done


def listen_drops() -> int:
    """The host's TCP ListenOverflows + ListenDrops (``/proc/net/netstat``):
    connections a full accept backlog turned away (the client's SYN is
    retried 1, 3, 7... s later)."""
    try:
        with open("/proc/net/netstat") as f_:
            rows = [ln.split() for ln in f_ if ln.startswith("TcpExt:")]
        head, vals = rows[0], rows[1]
        return sum(int(vals[head.index(k_)])
                   for k_ in ("ListenOverflows", "ListenDrops"))
    except (OSError, IndexError, ValueError):
        return -1


def loop_stats(got) -> str:
    secs = [s_ for _, s_, _ in got]
    slow = [[(i_, o_, round(t_, 3)) for i_, o_, t_ in a_]
            for _, s_, a_ in got if s_ > 1.0]
    return (f"{len(got)} requests, statuses "
            f"{sorted({c_ for c_, *_ in got}, key=str)}, slowest "
            f"{max(secs, default=0.0):.3f} s, {len(slow)} over 1 s "
            f"(attempts: url, answer, s: {slow[:3]})")


def pcts(xs):
    xs = sorted(xs)
    return (xs[len(xs) // 2],
            xs[min(len(xs) - 1, int(math.ceil(0.99 * len(xs))) - 1)])


def gpu_apps():
    """``{pid: MiB}`` of the card's compute processes, or None where
    ``nvidia-smi`` lists none (a PID namespace can hide them)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    apps = {}
    for line in out.stdout.splitlines():
        parts = [p_.strip() for p_ in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = parts[1]
    return apps or None


def opens_card(pid: int) -> bool:
    """Whether the process holds a ``/dev/nvidia*`` file open: initializing
    CUDA opens them, importing torch does not."""
    fds = f"/proc/{pid}/fd"
    for fd in os.listdir(fds):
        try:
            if os.readlink(os.path.join(fds, fd)).startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def card_used_mib() -> int:
    """The card's memory in use (``nvidia-smi``), MiB, every process."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def kill_stragglers(work: str) -> int:
    """SIGKILL every process whose command line names ``work`` (a replica
    a router's autoscaler launched and a killed router left behind)."""
    import signal as signal_mod
    n = 0
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f_:
                cmd = f_.read()
        except OSError:
            continue
        if work.encode() in cmd:
            try:
                os.kill(int(pid), signal_mod.SIGKILL)
                n += 1
            except OSError:
                pass
    return n


def transitions(url: str, name: str):
    """A router's audit trail of one replica (``/fleet`` transitions)."""
    return [{k_: v_ for k_, v_ in t_.items() if k_ not in ("t", "replica")}
            for t_ in json_get(url + "/fleet")[1]["transitions"]
            if t_.get("replica") == name]


def phase_fleet(rt_cfg, rt_state, left, right, exit_thr, card,
                device="cuda"):
    """Phase 36 (module docstring).  Returns the wrappers' counts over the
    in-process reference engine and the printed measurements."""
    import signal as signal_mod
    import tempfile
    import threading

    from raft_stereo_tpu_torch.cli import serve as serve_cli
    from raft_stereo_tpu_torch.eval.runner import launch_counts
    from raft_stereo_tpu_torch.io.jax_weights import save_checkpoint
    from raft_stereo_tpu_torch.kernels import _build
    from raft_stereo_tpu_torch.serving import ServingEngine
    from raft_stereo_tpu_torch.serving.engine import FAMILY_WARM
    from raft_stereo_tpu_torch.serving.fleet import (HashRing,
                                                     LocalProcessLauncher,
                                                     serve_argv_template)
    from raft_stereo_tpu_torch.tools import compile_farm

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    if on_card:
        release()
    settled = settle_state(rt_state)
    work = tempfile.mkdtemp(prefix="phase36-")
    logs = os.path.join(work, "logs")
    store = os.path.join(work, "store")
    ckpt = os.path.join(work, "rt_ckpt")
    save_checkpoint(ckpt, rt_cfg, settled)
    exit_tier = f"interactive:{float(exit_thr)!r}:{EXIT_MIN_ITERS}"
    serve_args = [
        "--restore_ckpt", ckpt, "--device", device, "--host", "127.0.0.1",
        "--valid_iters", str(RT_ITERS), "--tiers", f"quality,{exit_tier}",
        "--default_tier", "quality", "--batch_sizes", "1,2",
        "--max_batch", "2", "--max_queue", "16", "--sessions",
        "--session_ttl_s", "600",
        "--warmup_shape", f"{MAIN_HW[0]}x{MAIN_HW[1]}",
        "--executable_cache_dir", store, "--handoff_linger_s", "30",
        "--drain_timeout_s", "60"]
    # every replica, and every one a router's autoscaler launches: the
    # port's serve CLI from the package copy on PYTHONPATH (-P: not from
    # the working directory)
    template = ("python -P -m raft_stereo_tpu_torch.cli.serve --port {port} "
                + " ".join(serve_args))
    out = {}
    counts = {}
    reps = {}
    routers = {}

    def launch(name, port=None):
        """One replica from a fresh package copy through the port's
        ``LocalProcessLauncher``; ``port`` restarts a replica at its old
        address (the launcher's own fresh port is then not used)."""
        root = fleet_copy(work, name if port is None else f"{name}-restart")
        argv_for = serve_argv_template(template)
        if port is not None:
            base = argv_for
            argv_for = (lambda n_, _p: base(n_, port))  # noqa: E731
        launcher = LocalProcessLauncher(
            argv_for, env=dict(os.environ, PYTHONPATH=root), log_dir=logs)
        url = launcher.launch(name)
        if port is not None:
            url = f"http://127.0.0.1:{port}"
        reps[name] = {"launcher": launcher, "url": url, "root": root,
                      "t0": time.perf_counter(),
                      "log": os.path.join(logs, f"{name}.log"),
                      "pid": launcher._procs[name].pid}

    def rep_alive(name):
        return reps[name]["launcher"].poll(name) is None

    def ready(name):
        code, _ = get(reps[name]["url"] + "/readyz", timeout=5)
        return code == 200

    def router_ready(name, n):
        code, h_ = json_get(routers[name][1] + "/healthz")
        return code == 200 and h_.get("ready_replicas") == n

    def stream(url, sid, pair):
        """One session frame on the exit tier (on settled weights a warm
        frame exits below the cap, so the keyframe guard stays off)."""
        return post(f"{url}/v1/stream/{sid}?format=npy&tier=interactive",
                    npz_body(*pair))

    try:
        # ---- the reference: an in-process engine of the replicas' flags
        t_ref = time.perf_counter()
        ref_args = serve_cli.build_parser().parse_args(["--port", "0"]
                                                       + serve_args)
        ref_cfg = dataclasses.replace(serve_cli.build_serve_config(ref_args),
                                      executable_cache_dir=None)
        pairs = serve_pairs(left, right, (1.0, 0.8, 0.6, 0.4))
        sids = [f"fleet-cam{k}" for k in range(FLEET_SESSIONS)]
        chains = {sid: session_frames(l_, r_, FLEET_FRAMES)
                  for sid, (l_, r_) in zip(sids, pairs)}
        zero_inference_counts()
        eng = ServingEngine(rt_cfg, settled, ref_cfg, device=device)
        ref_flow = eng.infer(left, right, tier="quality", timeout=300).flow
        per_dispatch = {}
        if on_card:
            per_dispatch["quality"] = dispatch_counts(
                eng, PADDED_HW, 1, "quality", RT_ITERS)
            tier_dispatch_counts(per_dispatch["quality"], "quality",
                                 RT_ITERS)
        ref_chain = {sid: [] for sid in sids}
        for k in range(FLEET_FRAMES):
            for sid in sids:
                res = eng.infer_session(sid, *chains[sid][k],
                                        tier="interactive", timeout=300)
                ref_chain[sid].append((res.flow, res.warm))
        if on_card:
            depth = res.iters_used
            per_dispatch["interactive warm"] = dispatch_counts(
                eng, PADDED_HW, 1, "interactive", depth, FAMILY_WARM)
            tier_dispatch_counts(per_dispatch["interactive warm"],
                                 exit_tier, depth)
        eng.close()
        del eng
        for k_, v_ in launch_counts().items():
            counts[k_] = counts.get(k_, 0) + v_
        zero_inference_counts()
        if on_card:
            release()
        # the adopted frames must be warm: the point of the handoff
        ok = (all(ref_chain[sid][FLEET_DRAIN_AT][1] for sid in sids)
              and not any(ref_chain[sid][0][1] for sid in sids))
        log(f"fleet reference: an in-process engine of the replicas' flags "
            f"(tiers quality and {exit_tier}, batch 1/2, sessions): the "
            f"pair on the quality tier and {FLEET_SESSIONS} chains of "
            f"{FLEET_FRAMES} frames on the exit tier (warm "
            f"{[[w_ for _, w_ in ref_chain[sid]] for sid in sids]}); "
            f"launches per dispatch "
            f"{per_dispatch}; wrappers' counts {counts}; "
            f"{time.perf_counter() - t_ref:.1f} s: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("the reference chains are not warm at "
                                 "the drain")

        # ---- (a) warm boot ----------------------------------------------
        t_a = time.perf_counter()
        farm = {"stored": 0, "libraries": {}}
        if on_card:
            farm_manifest = os.path.join(work, "farm.json")
            if compile_farm.main(["--out", store, "--manifest",
                                  farm_manifest]) != 0:
                raise AssertionError("compile_farm failed")
            with open(farm_manifest) as f_:
                farm = json.load(f_)
        used0 = card_used_mib() if on_card else 0
        for name in ("r0", "r1"):
            launch(name)
        ha_dir = os.path.join(store, "fleet")
        routers["rt-a"] = start_router(
            work, "rt-a", {n_: reps[n_]["url"] for n_ in ("r0", "r1")},
            ["--ha_dir", ha_dir])
        wait_until(lambda: get(routers["rt-a"][1] + "/healthz")[0] == 200,
                   "rt-a up", 120, lambda: routers["rt-a"][0].poll() is None,
                   routers["rt-a"][2])
        # the traced standby of (f): passive, it serves traffic all along
        routers["rt-b"] = start_router(
            work, "rt-b", {n_: reps[n_]["url"] for n_ in ("r0", "r1")},
            ["--ha_dir", ha_dir, "--standby", "--peer", routers["rt-a"][1],
             "--trace_sample_rate", "1.0"])
        boot = {}
        for name in ("r0", "r1"):
            wait_until(lambda: ready(name), f"replica {name} /readyz", 600,
                       lambda: rep_alive(name), reps[name]["log"], 0.25)
            boot[name] = time.perf_counter() - reps[name]["t0"]
        for rt in ("rt-a", "rt-b"):
            wait_until(lambda: router_ready(rt, 2), f"{rt} over 2 replicas",
                       60, lambda: routers[rt][0].poll() is None,
                       routers[rt][2])
        used_boot = card_used_mib() - used0 if on_card else 0
        stats = {}
        for name in ("r0", "r1"):
            code, st_ = json_get(reps[name]["url"] + "/readyz")
            stats[name] = (built_in(reps[name]["root"]),
                           st_.get("executable_cache"))
        _, fleet = json_get(routers["rt-a"][1] + "/fleet")
        _, fleet_b = json_get(routers["rt-b"][1] + "/fleet")
        ok = (fleet["role"] == "primary" and fleet_b["role"] == "standby"
              and sorted(fleet["in_rotation"]) == ["r0", "r1"])
        if on_card:
            n_src = len(_build.sources())
            ok = (ok and len(farm["libraries"]) == n_src
                  and farm["stored"] == n_src)
            for (libs, nvcc), cache in stats.values():
                ok = (ok and libs >= 2 and nvcc == 0 and cache is not None
                      and cache["loads"] == libs and cache["misses"] == 0)
        out["boot_s"] = boot
        log(f"(a) warm boot: two replicas (the port's serve CLI from copies "
            f"of the package without _build/, launched by "
            f"LocalProcessLauncher; tiers quality and {exit_tier}, batch "
            f"1/2, sessions, the ladder at {MAIN_HW[0]}x{MAIN_HW[1]}) "
            f"/readyz after {[round(boot[n_], 2) for n_ in ('r0', 'r1')]} s "
            f"in parallel; (libraries, nvcc runs) and store stats "
            f"{stats}; compile_farm stored {farm['stored']} of "
            f"{len(farm['libraries'])}; rt-a {fleet['role']}, rt-b "
            f"{fleet_b['role']} (traced), both over {fleet['in_rotation']}: "
            f"{'ok' if ok else 'FAILED'}; (a) took "
            f"{time.perf_counter() - t_a:.1f} s")
        if not ok:
            raise AssertionError("the fleet's warm boot failed its checks")

        # ---- (b) pass-through parity -------------------------------------
        body = npz_body(left, right)
        rt_a = routers["rt-a"][1]
        before = json_get(rt_a + "/fleet")[1]["replicas"]
        st_r, h_r, routed = post(rt_a + "/v1/disparity?format=npy", body)
        after = json_get(rt_a + "/fleet")[1]["replicas"]
        served = [n_ for n_ in after if after[n_]["requests_forwarded"]
                  > before[n_]["requests_forwarded"]]
        direct = {n_: post(reps[n_]["url"] + "/v1/disparity?format=npy",
                           body)[2] for n_ in ("r0", "r1")}
        ok = (st_r == 200 and len(served) == 1
              and routed == direct[served[0]] == direct["r0"] == direct["r1"]
              and np.array_equal(-npy_of(routed), ref_flow))
        log(f"(b) pass-through: the {MAIN_HW[0]}x{MAIN_HW[1]} pair through "
            f"rt-a (served by {served}) byte-identical to the replica "
            f"directly ({len(routed)} bytes), both replicas alike, and "
            f"bitwise equal to the in-process engine's quality dispatch "
            f"(7 #6 and 21 #5 bf16 counted there): "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("router pass-through parity failed")

        # ---- (f) observability (the traced standby, both replicas) -------
        rt_b = routers["rt-b"][1]
        st_t, h_t, traced_body = post(rt_b + "/v1/disparity?format=npy",
                                      body)
        tid = h_t.get("X-Trace-Id")

        def merged():
            code_, view_ = json_get(f"{rt_b}/debug/spans?trace={tid}")
            names_ = {(s_["process"], s_["name"]) for s_ in view_["spans"]}
            return (("router", "route.request") in names_
                    and any(p_ != "router" and n_ == "serve.request"
                            for p_, n_ in names_)) and view_

        wait_until(merged, "the federated trace", 10)
        view = merged()
        fwd = [s_ for s_ in view["spans"] if s_["process"] == "router"
               and s_["name"] == "route.forward"]
        serve_spans = [s_ for s_ in view["spans"]
                       if s_["name"] == "serve.request"]
        owner_t = serve_spans[0]["process"]
        _, own = json_get(f"{reps[owner_t]['url']}/debug/spans?trace={tid}")

        def federated():
            text_ = get(rt_b + "/metrics/fleet")[1].decode()
            return all(f'fleet_federation_up{{replica="{n_}"}} 1' in text_
                       and f'serve_requests_admitted_total{{replica="{n_}"'
                       in text_ for n_ in ("r0", "r1")) and text_

        wait_until(federated, "/metrics/fleet over both replicas", 15)
        text = federated()
        helps = [ln for ln in text.splitlines() if ln.startswith("# HELP ")]
        ok = (st_t == 200 and bool(tid) and traced_body == routed
              and len(fwd) == 1 and len(serve_spans) == 1
              and serve_spans[0]["parent_id"] == fwd[0]["span_id"]
              and serve_spans[0]["trace_id"] == tid
              and any(s_["name"] == "serve.request" for s_ in own["spans"])
              and len(helps) == len(set(helps))
              and text.count("# HELP serve_requests_admitted_total ") == 1)
        log(f"(f) observability: a sampled request through rt-b, trace "
            f"{tid}: the replica {owner_t}'s serve.request a child of the "
            f"router's route.forward in the federated /debug/spans "
            f"({len(view['spans'])} spans from {sorted(view['sources'])}), "
            f"and in {owner_t}'s own ring; the traced answer's bytes equal "
            f"the untraced one's; /metrics/fleet re-exposes both replicas' "
            f"serve_* series under replica= with one HELP/TYPE per family "
            f"({len(helps)} families): {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("fleet observability failed its checks")
        routers["rt-b"][0].send_signal(signal_mod.SIGTERM)
        routers["rt-b"][0].wait(timeout=60)

        # ---- (h) measurements over two replicas ---------------------------
        t_h = time.perf_counter()
        lat = {"routed": [], "direct": []}
        for _ in range(FLEET_LATENCY_REPS):
            for how, url in (("routed", rt_a), ("direct",
                                                reps["r0"]["url"])):
                t0 = time.perf_counter()
                code = post(url + "/v1/disparity?format=npy", body)[0]
                lat[how].append(time.perf_counter() - t0)
                if code != 200:
                    raise AssertionError(f"{how} request answered {code}")
        loops, loop_info = {}, {}
        for how, url in (("routed", rt_a), ("direct", reps["r0"]["url"])):
            drops0 = listen_drops()
            t0 = time.perf_counter()
            got = closed_loop([url], body, FLEET_CLIENTS, FLEET_LOAD_S)
            wall = time.perf_counter() - t0
            codes = sorted({c_ for c_, *_ in got}, key=str)
            if codes != [200]:
                raise AssertionError(f"{how} closed loop answered {codes}")
            loops[how] = len(got) / FLEET_LOAD_S
            loop_info[how] = (f"{loop_stats(got)}, {wall:.1f} s to the "
                              f"last answer, {listen_drops() - drops0} "
                              f"connections turned away by a full backlog")
        apps = gpu_apps() if on_card else None
        used_load = card_used_mib() - used0 if on_card else 0
        router_pids = {n_: r_[0].pid for n_, r_ in routers.items()
                       if r_[0].poll() is None}
        rep_pids = {n_: reps[n_]["pid"] for n_ in ("r0", "r1")}
        # the check is the routers' (no card device open); the replicas
        # opening theirs on the card shows that the probe sees it
        ok = (not any(opens_card(p_) for p_ in router_pids.values())
              and (all(opens_card(p_) for p_ in rep_pids.values())
                   or not on_card))
        out["latency_s"] = {k_: pcts(v_) for k_, v_ in lat.items()}
        out["requests_per_s"] = loops
        out["replicas_mib"] = {"after_boot": used_boot,
                               "after_load": used_load}
        log(f"(h) measurements: latency (p50, p99) over "
            f"{FLEET_LATENCY_REPS} sequential requests, batch 1, quality: "
            f"routed {[round(x_, 5) for x_ in out['latency_s']['routed']]} s,"
            f" direct {[round(x_, 5) for x_ in out['latency_s']['direct']]}"
            f" s; {FLEET_CLIENTS} clients for {FLEET_LOAD_S} s: through "
            f"rt-a over two replicas {loops['routed']:.2f} requests/s, one "
            f"replica directly {loops['direct']:.2f} ({loop_info}); the two "
            f"replicas' "
            f"card memory (nvidia-smi memory.used over this process's) "
            f"{used_boot} MiB after boot, {used_load} MiB after the loops "
            f"(--query-compute-apps lists {apps}); the router processes "
            f"{router_pids} open no /dev/nvidia* (no CUDA context), the "
            f"replicas {rep_pids} do: {'ok' if ok else 'FAILED'}; (h) took "
            f"{time.perf_counter() - t_h:.1f} s")
        if not ok:
            raise AssertionError("a router process holds a CUDA context")

        # ---- (c) sessions and a drain -------------------------------------
        t_c = time.perf_counter()
        ring = HashRing(["r0", "r1"])
        owner = {sid: ring.lookup(sid) for sid in sids}
        victim = max(("r0", "r1"),
                     key=lambda n_: sum(o_ == n_ for o_ in owner.values()))
        survivor = "r1" if victim == "r0" else "r0"
        moved = [sid for sid in sids if owner[sid] == victim]
        answers = {sid: [] for sid in sids}
        for k in range(FLEET_FRAMES):
            if k == FLEET_DRAIN_AT:
                reps[victim]["launcher"].drain(victim)
            for sid in sids:
                code, h_, raw = stream(rt_a, sid, chains[sid][k])
                answers[sid].append((code, h_.get("X-Warm"),
                                     h_.get("X-Frame-Index"),
                                     npy_of(raw) if code == 200 else raw))
        wait_until(lambda: not rep_alive(victim), "the drained replica's "
                   "exit", 120)
        rc = reps[victim]["launcher"].poll(victim)
        _, metrics_a = get(rt_a + "/metrics")
        metrics_a = metrics_a.decode()
        trail = transitions(rt_a, victim)
        ok = rc == 0 and bool(moved)
        bad = []
        for sid in sids:
            for k, (code, warm, idx, disp) in enumerate(answers[sid]):
                want_warm = "1" if ref_chain[sid][k][1] else "0"
                if not (code == 200 and warm == want_warm and idx == str(k)
                        and np.array_equal(-disp, ref_chain[sid][k][0])):
                    bad.append((sid, k, code, warm, idx))
        ok = (ok and not bad
              and metric(metrics_a, "fleet_sessions_lost_total") == 0
              # a frame that races the drain can apply the manifest a
              # second time (JAX's router; ROADMAP §C): counted twice
              and metric(metrics_a, "fleet_handoff_sessions_total")
              >= len(moved)
              and metric(metrics_a, "fleet_handoff_manifests_total") >= 1)
        log(f"(c) sessions: {FLEET_SESSIONS} sessions of {FLEET_FRAMES} "
            f"frames through rt-a, owners {owner}; SIGTERM to {victim} "
            f"before frame {FLEET_DRAIN_AT}: every frame 200 (zero 410s), "
            f"X-Frame-Index continuous, X-Warm the chain's, each frame "
            f"(the adopted ones on {survivor} too) bitwise equal to the "
            f"in-process chain; handed off {sorted(moved)} "
            f"(fleet_handoff_sessions_total "
            f"{metric(metrics_a, 'fleet_handoff_sessions_total'):g}, lost "
            f"{metric(metrics_a, 'fleet_sessions_lost_total'):g}; rt-a's "
            f"trail of {victim} {trail}); {victim} "
            f"exited {rc}; bad frames {bad}: {'ok' if ok else 'FAILED'}; "
            f"(c) took {time.perf_counter() - t_c:.1f} s")
        if not ok:
            raise AssertionError("the drain handoff failed its checks")

        # ---- (d) a replacement, then kill -9 under load -------------------
        t_d = time.perf_counter()
        port = int(reps[victim]["url"].rsplit(":", 1)[1])
        launch(victim, port=port)
        wait_until(lambda: ready(victim), "the replacement's /readyz", 600,
                   lambda: rep_alive(victim), reps[victim]["log"], 0.25)
        boot["replacement"] = time.perf_counter() - reps[victim]["t0"]
        wait_until(lambda: router_ready("rt-a", 2), "rt-a over 2 again", 30)
        dsids = [f"d-cam{k}" for k in range(FLEET_KILL_SESSIONS)]
        downer = {sid: ring.lookup(sid) for sid in dsids}
        target = max(("r0", "r1"),
                     key=lambda n_: sum(o_ == n_ for o_ in downer.values()))
        lost = [sid for sid in dsids if downer[sid] == target]
        kept = [sid for sid in dsids if downer[sid] != target]
        dframes = {sid: session_frames(*pairs[k % len(pairs)], 4)
                   for k, sid in enumerate(dsids)}
        for k in range(2):
            for sid in dsids:
                if stream(rt_a, sid, dframes[sid][k])[0] != 200:
                    raise AssertionError(f"{sid} frame {k} failed")
        stop = threading.Event()
        load = {}
        loader = threading.Thread(target=lambda: load.setdefault(
            "got", closed_loop([rt_a], body, 4, 60.0, stop)), daemon=True)
        loader.start()
        time.sleep(1.0)
        reps[target]["launcher"].destroy(target)      # SIGKILL
        degraded = wait_until(
            lambda: not json_get(rt_a + "/fleet")[1]["replicas"][target][
                "alive"], "rt-a marks the killed replica dead", 30,
            every=0.01)
        time.sleep(1.0)
        stop.set()
        loader.join(timeout=120)
        got = load.get("got", [])
        fired = []
        for sid in lost[:-1]:       # the last one stays owed for (e)
            code, _, raw = stream(rt_a, sid, dframes[sid][2])
            code2, h2, _ = stream(rt_a, sid, dframes[sid][3])
            fired.append((code, json.loads(raw).get("error")
                           if code == 410 else None, code2,
                           h2.get("X-Warm")))
        kept_ok = [stream(rt_a, sid, dframes[sid][2]) for sid in kept]
        ok = (len(lost) >= 2 and got and all(c_ == 200 for c_, *_ in got)
              and built_in(reps[victim]["root"])[1] == 0
              and all(f_ == (410, "session_lost", 200, "0") for f_ in fired)
              and all(c_ == 200 and h_.get("X-Warm") == "1"
                      for c_, h_, _ in kept_ok))
        out["degraded_s"] = degraded
        out["boot_s"] = boot
        log(f"(d) failover: {victim} restarted at its address, /readyz "
            f"after {boot['replacement']:.2f} s, back in rotation; "
            f"{FLEET_KILL_SESSIONS} sessions opened, kill -9 of {target} "
            f"(holding {lost}) under 4 closed-loop clients: "
            f"{loop_stats(got)}; degraded window "
            f"(kill to marked dead) {degraded:.3f} s; each lost session "
            f"(410 error, next frame, X-Warm) {fired}, {lost[-1]} left owed;"
            f" the survivor's sessions warm: {'ok' if ok else 'FAILED'}; "
            f"(d) took {time.perf_counter() - t_d:.1f} s")
        if not ok:
            raise AssertionError("failover failed its checks")

        # ---- (e) the HA pair -----------------------------------------------
        t_e = time.perf_counter()
        routers["rt-b2"] = start_router(
            work, "rt-b2", {n_: reps[n_]["url"] for n_ in ("r0", "r1")},
            ["--ha_dir", ha_dir, "--standby", "--peer", rt_a])
        rt_b2 = routers["rt-b2"][1]
        wait_until(lambda: router_ready("rt-b2", 1), "rt-b2 up", 120,
                   lambda: routers["rt-b2"][0].poll() is None,
                   routers["rt-b2"][2])
        role0 = json_get(rt_b2 + "/fleet")[1]["role"]
        stop = threading.Event()
        load = {}
        loader = threading.Thread(target=lambda: load.setdefault(
            "got", closed_loop([rt_a, rt_b2], body, 4, 60.0, stop)),
            daemon=True)
        loader.start()
        time.sleep(1.0)
        routers["rt-a"][0].kill()
        routers["rt-a"][0].wait(timeout=30)
        takeover = wait_until(
            lambda: json_get(rt_b2 + "/fleet")[1]["role"] == "primary",
            "rt-b2 takes the lease", 30, every=0.02)
        # the sessions at once: an owed loss expires after the router's
        # session_lost_ttl_s (60 s)
        again = [stream(rt_b2, sid, dframes[sid][3])[0] for sid in lost[:-1]]
        code, _, raw = stream(rt_b2, lost[-1], dframes[lost[-1]][2])
        owed = (code, json.loads(raw).get("error") if code == 410 else None)
        code2 = stream(rt_b2, lost[-1], dframes[lost[-1]][3])[0]
        time.sleep(1.0)
        stop.set()
        t_join = time.perf_counter()
        loader.join(timeout=300)
        t_join = time.perf_counter() - t_join
        got = load.get("got", [])
        _, fleet = json_get(rt_b2 + "/fleet")
        metrics_b = get(rt_b2 + "/metrics")[1].decode()
        ok = (role0 == "standby" and got and all(c_ == 200 for c_, *_ in got)
              and fleet["role"] == "primary" and fleet["epoch"] == 2
              and all(c_ == 200 for c_ in again)
              and owed == (410, "session_lost") and code2 == 200
              and metric(metrics_b, "fleet_router_takeovers_total") == 1)
        out["takeover_s"] = takeover
        log(f"(e) HA pair: rt-b2 started {role0} over --ha_dir; kill -9 of "
            f"the primary rt-a under 4 clients failing over to rt-b2: "
            f"{loop_stats(got)} ({t_join:.1f} s to stop); rt-b2 "
            f"{fleet['role']} at epoch {fleet['epoch']} after "
            f"{takeover:.3f} s (kill to lease); the sessions rt-a fired "
            f"answer {again} (no second 410); the owed {lost[-1]} {owed} "
            f"once, then {code2}: {'ok' if ok else 'FAILED'}; (e) took "
            f"{time.perf_counter() - t_e:.1f} s")
        if not ok:
            raise AssertionError("the HA pair failed its checks")
        routers["rt-b2"][0].send_signal(signal_mod.SIGTERM)
        routers["rt-b2"][0].wait(timeout=60)

        # ---- (g) the autoscaler ---------------------------------------------
        t_g = time.perf_counter()
        live = "r1" if target == "r0" else "r0"
        g_root = fleet_copy(work, "autoscaled")
        routers["rt-c"] = start_router(
            work, "rt-c", {live: reps[live]["url"]},
            ["--autoscale_cmd", template, "--autoscale_min", "1",
             "--autoscale_max", "2", "--autoscale_engage_fraction", "0.25",
             "--autoscale_engage_s", "1.0",
             "--autoscale_restore_fraction", "0.05",
             "--autoscale_restore_s", "3.0", "--autoscale_cooldown_s", "1.0",
             "--autoscale_log_dir", logs], root=g_root)
        rt_c = routers["rt-c"][1]
        wait_until(lambda: router_ready("rt-c", 1), "rt-c up", 120,
                   lambda: routers["rt-c"][0].poll() is None,
                   routers["rt-c"][2])
        stop = threading.Event()
        load = {}
        loader = threading.Thread(target=lambda: load.setdefault(
            "got", closed_loop([rt_c], body, FLEET_CLIENTS, 600.0, stop)),
            daemon=True)
        loader.start()
        joined = wait_until(
            lambda: "auto1" in json_get(rt_c + "/fleet")[1]["in_rotation"],
            "the autoscaled replica joins rotation", 240,
            lambda: routers["rt-c"][0].poll() is None, routers["rt-c"][2],
            0.25)
        gsids = [f"g-cam{k}" for k in range(FLEET_SESSIONS)]
        gring = HashRing([live, "auto1"])
        gmoved = [sid for sid in gsids if gring.lookup(sid) == "auto1"]
        gframes = {sid: session_frames(*pairs[k], 3)
                   for k, sid in enumerate(gsids)}
        g_first = [stream(rt_c, sid, gframes[sid][0])[0] for sid in gsids]
        stop.set()
        loader.join(timeout=300)
        got = load.get("got", [])
        gone = wait_until(
            lambda: "auto1" not in json_get(rt_c + "/fleet")[1]["replicas"],
            "the scale-down drains and deregisters auto1", 180,
            lambda: routers["rt-c"][0].poll() is None, routers["rt-c"][2],
            0.1)
        g_next = [stream(rt_c, sid, gframes[sid][1]) for sid in gsids]
        metrics_c = get(rt_c + "/metrics")[1].decode()
        trail = transitions(rt_c, "auto1")
        libs, nvcc = built_in(g_root)
        ok = (bool(gmoved) and all(c_ == 200 for c_, *_ in got)
              and g_first == [200] * len(gsids)
              and all(c_ == 200 and h_.get("X-Warm") == "1"
                      for c_, h_, _ in g_next)
              and metric(metrics_c, "fleet_autoscale_up_total") == 1
              and metric(metrics_c, "fleet_autoscale_down_total") == 1
              and metric(metrics_c, "fleet_sessions_lost_total") == 0
              and metric(metrics_c, "fleet_handoff_sessions_total")
              >= len(gmoved))
        if on_card:
            ok = ok and libs >= 2 and nvcc == 0
        out["autoscale"] = {"join_s": joined, "drain_s": gone}
        log(f"(g) autoscale: rt-c (the route CLI with --autoscale_cmd, the "
            f"port's serve template) over {live}; {FLEET_CLIENTS} clients "
            f"past the engage watermark: auto1 launched and in rotation "
            f"{joined:.1f} s after the load began (its package copy: "
            f"{libs} libraries fetched, {nvcc} nvcc runs); under load "
            f"{loop_stats(got)}; {len(gsids)} "
            f"sessions ({gmoved} on auto1); load stopped: auto1 drained by "
            f"handoff and deregistered after {gone:.1f} s, the sessions' "
            f"next frames {[(c_, h_.get('X-Warm')) for c_, h_, _ in g_next]}"
            f"; up {metric(metrics_c, 'fleet_autoscale_up_total'):g}, down "
            f"{metric(metrics_c, 'fleet_autoscale_down_total'):g}, lost "
            f"{metric(metrics_c, 'fleet_sessions_lost_total'):g}, handed "
            f"off {metric(metrics_c, 'fleet_handoff_sessions_total'):g}; "
            f"rt-c's trail of auto1 {trail}: {'ok' if ok else 'FAILED'}; "
            f"(g) took "
            f"{time.perf_counter() - t_g:.1f} s")
        if not ok:
            raise AssertionError("the autoscaler failed its checks")
        routers["rt-c"][0].send_signal(signal_mod.SIGTERM)
        routers["rt-c"][0].wait(timeout=60)
    except BaseException:
        for name_ in sorted(os.listdir(logs) if os.path.isdir(logs) else ()):
            log(f"---- {name_} ----\n{log_tail(os.path.join(logs, name_))}")
        for name_, r_ in routers.items():
            log(f"---- {name_} ----\n{log_tail(r_[2])}")
        raise
    finally:
        for r_ in routers.values():
            if r_[0].poll() is None:
                r_[0].send_signal(signal_mod.SIGTERM)
                try:
                    r_[0].wait(timeout=30)
                except subprocess.TimeoutExpired:
                    r_[0].kill()
                    r_[0].wait()
        for rep in reps.values():
            rep["launcher"].stop_all()
        stragglers = kill_stragglers(work)
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 36 wrapper counts (the in-process reference engine): "
        f"{counts}; stragglers killed {stragglers}; phase 36 took "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return counts, out


def padded_pair(hw, seed):
    """A seeded noise pair (right = left shifted 4 px) of ``hw``, padded
    to a multiple of 32 by edge replication as ``InputPadder`` pads: two
    (1, H, W, 3) fp32 tensors on the current card."""
    from raft_stereo_tpu_torch.ops.padding import InputPadder
    rs = np.random.default_rng(seed)
    left = rs.integers(0, 256, hw + (3,), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    l_, r_, t_, b_ = InputPadder((1, 3) + hw, divis_by=32).pads
    return [torch.from_numpy(np.pad(a, ((t_, b_), (l_, r_), (0, 0)),
                                    mode="edge")[None]).float().cuda()
            for a in (left, right)]


def peak_run(fn):
    """``fn()`` with the allocator's peak reset before it: (result,
    seconds, peak GiB, peak GiB above what was allocated before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return out, secs, peak / 2 ** 30, (peak - base) / 2 ** 30


def ulp_moved(state, seed):
    """A copy of ``state`` with every floating tensor moved by one fp32
    ulp up or down at random (the card's own spread, phases 15 and 20)."""
    gen = torch.Generator().manual_seed(seed)
    return {n: (t * (1 + 2.0 ** -23 * (2 * torch.randint(
        0, 2, t.shape, generator=gen) - 1)) if t.is_floating_point() else t)
        for n, t in state.items()}


def phase_banded(cfg, state, card):
    """Phase 37 (module docstring).  Returns the wrappers' counts over
    the banded pair at 32 iterations and over the banded training step,
    and the measurements."""
    from raft_stereo_tpu_torch.config import TrainConfig
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_fused, lookup_pyramid_xla)
    from raft_stereo_tpu_torch.kernels.gru_fused import (_gates_reference,
                                                         gru_gates_fused)
    from raft_stereo_tpu_torch.models import banded as banded_mod
    from raft_stereo_tpu_torch.models.corr import build_corr_pyramid
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    from raft_stereo_tpu_torch.training.loss import sequence_loss
    from raft_stereo_tpu_torch.training.state import create_train_state
    from raft_stereo_tpu_torch.training.step import make_train_step

    t_phase = time.perf_counter()
    release()
    out = {}
    img1, img2 = padded_pair(TILE_HW, SEED + 37)
    hp, wp = img1.shape[1:3]
    models = {}
    for what, on in (("unbanded", False), ("banded", True)):
        m = RAFTStereo(dataclasses.replace(cfg, banded_encoder=on))
        m.load_state_dict(state)
        models[what] = m.cuda().eval()
    band = banded_mod.default_band_rows(1, wp, "cuda")
    # the card's own spread: the unbanded model with every weight moved by
    # one fp32 ulp (phases 15 and 20), for the flows and the loss, which
    # random weights amplify iteration by iteration
    moved = ulp_moved(state, SEED + 37)
    models["ulp"] = RAFTStereo(cfg)
    models["ulp"].load_state_dict(moved)
    models["ulp"] = models["ulp"].cuda().eval()
    # (a) parity at two levels: the encoders, then 3 iterations
    with torch.inference_mode():
        enc = {k: models[k].encode(models[k].normalize(img1),
                                   models[k].normalize(img2))
               for k in ("banded", "unbanded")}
        pairs = [(enc["banded"][1], enc["unbanded"][1]),
                 (enc["banded"][2], enc["unbanded"][2])]
        pairs += [(g, w) for gl, wl in zip(enc["banded"][0],
                                           enc["unbanded"][0])
                  for g, w in zip(gl, wl)]
        enc_rel = max(float((g - w).abs().max()) / float(w.abs().max())
                      for g, w in pairs)
        del enc, pairs
        flows3 = {k: m(img1, img2, iters=BANDED_CHECK_ITERS)[1]
                  for k, m in models.items()}
        d3 = float((flows3["banded"] - flows3["unbanded"]).abs().max())
        spread3 = float((flows3["ulp"] - flows3["unbanded"]).abs().max())
        flow3_max = float(flows3["unbanded"].abs().max())
        del flows3
    del models["ulp"]
    release()
    flow_bound = max(BANDED_FLOW_ATOL, BANDED_SPREAD_FACTOR * spread3)
    runs = {}
    for what, m in models.items():
        zero_inference_counts()
        with torch.inference_mode():
            flow, secs, peak, above = peak_run(
                lambda: m(img1, img2, iters=MAIN_ITERS)[1])
        runs[what] = {"flow": flow, "seconds": secs, "peak_gib": peak,
                      "peak_above_inputs_gib": above,
                      "launches": {"lookup": lookup_pyramid_fused.launches,
                                   "gates": gru_gates_fused.launches}}
        release()
    d32 = float((runs["banded"]["flow"] - runs["unbanded"]["flow"]
                 ).abs().max())
    finite = all(bool(torch.isfinite(r["flow"]).all()) for r in runs.values())
    pair_counts = runs["banded"]["launches"]
    for r in runs.values():
        del r["flow"]
    out["pair"] = runs
    out["encoder_max_rel"] = enc_rel
    out["flow_max_abs_3"], out["flow_max_abs_32"] = d3, d32
    # the kernels at this path's shapes against their plain versions (not
    # counted: the counts above are the path's)
    gen = torch.Generator().manual_seed(SEED + 37)
    rows, w1 = hp // 4, wp // 4
    vol = torch.randn((1, rows, w1, w1), generator=gen).cuda()
    pyramid = build_corr_pyramid(vol, LEVELS)
    coords = (torch.rand((1, rows, w1), generator=gen) * (w1 + 20)
              - 10).cuda()
    lookup_err = float((lookup_pyramid_fused(pyramid, coords, RADIUS)
                        - lookup_pyramid_xla(pyramid, coords, RADIUS)
                        ).abs().max())
    del vol, pyramid, coords
    gate_err = 0.0
    for shape in ((1, rows, w1, CH, 256), (1, rows // 2, w1 // 2, CH, 256),
                  (1, rows // 4, w1 // 4, CH, 128)):
        args = gate_args(gen, torch.device("cuda"), shape, torch.float32)
        got = gru_gates_fused(*args)
        gate_err = max(gate_err, max(
            float((g - w).abs().max())
            for g, w in zip(got, _gates_reference(*args))))
    out["lookup_err"], out["gates_err"] = lookup_err, gate_err
    release()
    # (b) the band sweep: fnet's trunk alone on one image, and the working
    # set of one band (the segment's last sweep) at each band height
    trunk = models["banded"].fnet.trunk
    x = models["banded"].normalize(img1)
    halo = banded_mod._HALO
    unit = [(torch.zeros((1, 64, 1, 1), device="cuda"),
             torch.ones((1, 64, 1, 1), device="cuda"))] * 5
    sweep = {}
    with torch.inference_mode():
        trunk(x)        # warm-up
        _, secs, _, above = peak_run(lambda: trunk(x))
        sweep["unbanded"] = {"seconds": secs, "gib": above}
        for b in BAND_SWEEP:
            banded_mod.banded_trunk_apply(trunk, x, "instance", band=b)
            _, secs, _, above = peak_run(
                lambda: banded_mod.banded_trunk_apply(trunk, x, "instance",
                                                      band=b))
            mask = torch.ones(b + 2 * halo, dtype=torch.bool, device="cuda")
            _, _, _, seg = peak_run(lambda: banded_mod._segment(
                trunk, x[:, :, :b + 2 * halo], unit, 6, mask))
            sweep[b] = {"seconds": secs, "gib": above, "band_gib": seg}
    lo, hi = BAND_SWEEP[0], BAND_SWEEP[-1]
    slope = ((sweep[hi]["band_gib"] - sweep[lo]["band_gib"]) * 2 ** 30
             / ((hi - lo) * wp))
    fastest = min(BAND_SWEEP, key=lambda b: sweep[b]["seconds"])
    total = torch.cuda.get_device_properties(0).total_memory
    out["sweep"] = {str(k): v for k, v in sweep.items()}
    out["bytes_per_row_pixel"] = slope
    out["fastest_band"] = fastest
    out["fraction_for_fastest"] = fastest * wp * slope / total
    out["default_band"] = band
    del x, img1, img2, models
    release()
    # (c) one default training step at TrainConfig(), banded and not, and
    # unbanded from the moved weights (the card's spread)
    tc = TrainConfig()
    batch = SyntheticStereoLoader(tc.batch_size, tc.image_size,
                                  seed=SEED).batch(0)
    steps = {}
    for what, on in (("unbanded", False), ("banded", True)):
        st = create_train_state(dataclasses.replace(cfg, banded_encoder=on),
                                tc, "cuda", state_dict=state)
        zero_training_counts()
        (st, m), secs, peak, _ = peak_run(
            lambda: make_train_step(tc)(st, batch))
        steps[what] = {"loss": float(m["loss"]), "seconds": secs,
                       "peak_gib": peak, "launches": training_counts()}
        del st, m
        release()
    # the step's loss is its forward's: the moved weights' needs no backward
    st = create_train_state(cfg, tc, "cuda", state_dict=moved)
    dev_batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    with torch.no_grad():
        preds = st.model(dev_batch["image1"], dev_batch["image2"],
                         iters=tc.train_iters, test_mode=False)
        steps["ulp"] = {"loss": float(sequence_loss(
            preds, dev_batch["flow"].float(), dev_batch["valid"].float(),
            loss_gamma=tc.loss_gamma, max_flow=tc.max_flow)[0])}
    del st, preds, dev_batch
    release()
    out["step"] = steps
    step_counts = steps["banded"]["launches"]
    base_loss = abs(steps["unbanded"]["loss"])
    loss_rel = abs(steps["banded"]["loss"] - steps["unbanded"]["loss"]
                   ) / base_loss
    loss_spread = abs(steps["ulp"]["loss"] - steps["unbanded"]["loss"]
                      ) / base_loss
    loss_bound = max(BANDED_LOSS_RTOL, BANDED_SPREAD_FACTOR * loss_spread)
    out.update(flow_spread_3=spread3, flow_bound_3=flow_bound,
               loss_rel=loss_rel, loss_spread=loss_spread)
    want_pair = {"lookup": MAIN_ITERS, "gates": 3 * MAIN_ITERS}
    ok = (finite and enc_rel <= BANDED_ENC_RTOL
          and d3 <= flow_bound
          and runs["banded"]["peak_gib"] < runs["unbanded"]["peak_gib"]
          and runs["banded"]["launches"] == want_pair
          and lookup_err <= LOOKUP_ATOL and gate_err <= GATES_ATOL
          and loss_rel <= loss_bound
          and step_counts["lookup"] == tc.train_iters
          and step_counts["lookup_bwd"] == tc.train_iters
          and step_counts["gates"] == 6 * tc.train_iters)
    log(f"banded encoder, default config fp32, {TILE_HW[0]}x{TILE_HW[1]} "
        f"padded to {hp}x{wp}, band {band} rows (default_band_rows): "
        f"encoders (fmap1, fmap2, context levels) max |banded - unbanded| "
        f"/ max |unbanded| {enc_rel:.3e} (<= {BANDED_ENC_RTOL:g}); flows at "
        f"{BANDED_CHECK_ITERS} iterations (max |flow| {flow3_max:.2f} px) "
        f"max |d| {d3:.3e} px (<= {flow_bound:.3e}: the larger of "
        f"{BANDED_FLOW_ATOL:g} and {BANDED_SPREAD_FACTOR:g}x the card's spread "
        f"with every weight moved by one ulp, {spread3:.3e}), at "
        f"{MAIN_ITERS} {d32:.3e} px (no bound); "
        f"seconds per pair at {MAIN_ITERS} iterations unbanded "
        f"{runs['unbanded']['seconds']:.4f}, banded "
        f"{runs['banded']['seconds']:.4f}; max_memory_allocated unbanded "
        f"{runs['unbanded']['peak_gib']:.3f} GiB, banded "
        f"{runs['banded']['peak_gib']:.3f} GiB (above the weights and "
        f"inputs {runs['unbanded']['peak_above_inputs_gib']:.3f} / "
        f"{runs['banded']['peak_above_inputs_gib']:.3f}); launches over the "
        f"banded pair {pair_counts} (want {want_pair}); at this path's "
        f"shapes lookup max |kernel - plain| {lookup_err:.3e}, gates "
        f"{gate_err:.3e}")
    log(f"band sweep, fnet's trunk alone on one {hp}x{wp} image: "
        + "; ".join(f"{k}: {v['seconds']:.4f} s, peak above input "
                    f"{v['gib']:.4f} GiB"
                    + (f" (one band's working set {v['band_gib']:.4f} GiB)"
                       if "band_gib" in v else "")
                    for k, v in sweep.items())
        + f"; slope {slope:.1f} B per band row and image column; fastest "
        f"band {fastest}, the share of the card's {total / 2 ** 30:.1f} GiB "
        f"that gives it at width {wp}: {out['fraction_for_fastest']:.6f}")
    log(f"training step, TrainConfig() (batch {tc.batch_size}, "
        f"{tc.image_size[0]}x{tc.image_size[1]}, {tc.train_iters} "
        f"iterations): loss unbanded {steps['unbanded']['loss']:.6f}, "
        f"banded {steps['banded']['loss']:.6f} (rel {loss_rel:.2e} <= "
        f"{loss_bound:.2e}: the larger of {BANDED_LOSS_RTOL:g} and "
        f"{BANDED_SPREAD_FACTOR:g}x the card's spread, one ulp: "
        f"{steps['ulp']['loss']:.6f}, rel {loss_spread:.2e}); seconds "
        f"{steps['unbanded']['seconds']:.3f} "
        f"/ {steps['banded']['seconds']:.3f}; peak "
        f"{steps['unbanded']['peak_gib']:.3f} / "
        f"{steps['banded']['peak_gib']:.3f} GiB; banded launches "
        f"{step_counts}; phase 37 took {time.perf_counter() - t_phase:.1f} "
        f"s on {card}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("phase 37 (banded encoder) failed its checks")
    return pair_counts, step_counts, out


def dp_batches(n):
    """The data-parallel phase's global batches at ``TrainConfig()``'s
    crop."""
    from raft_stereo_tpu_torch.config import TrainConfig
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
    src = SyntheticStereoLoader(DP_BATCH, TrainConfig().image_size,
                                seed=SEED + 38)
    return [src.batch(i) for i in range(n)]


def dp_train(batches, ckpt=None, restore=None, stop_after=None,
             process_index=0, process_count=1):
    """``train()`` on the card at ``TrainConfig()``'s crop, global batch
    ``DP_BATCH``, over this process's slice of ``batches``: (state, per-step
    losses, per-step seconds).  ``stop_after``: process 1 sends itself
    SIGTERM after that step."""
    import signal

    from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.training.train_loop import train
    tc = dataclasses.replace(TrainConfig(), batch_size=DP_BATCH,
                             num_steps=DP_STEPS, validation_frequency=1000)
    local = DP_BATCH // process_count
    lo = process_index * local
    mine = [{k: v[lo:lo + local] for k, v in b.items()} for b in batches]
    losses, marks = {}, [time.perf_counter()]

    def on_step(step, m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses[step] = float(m["loss"])
        if step == stop_after and process_index == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    start = 0 if restore is None else 1
    state = train(RaftStereoConfig(), tc, name="dp", checkpoint_dir=ckpt,
                  restore=restore, log_dir=None, loader=mine[start:],
                  device="cuda", on_step=on_step)
    return (state, [losses[k] for k in sorted(losses)],
            [b - a for a, b in zip(marks, marks[1:])])


def dp_moved_steps(batches):
    """The same steps as ``dp_train`` in one process, from ``train()``'s
    initial weights moved by one ulp: (losses, flat parameters)."""
    from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.training.state import create_train_state
    from raft_stereo_tpu_torch.training.step import make_train_step
    tc = dataclasses.replace(TrainConfig(), batch_size=DP_BATCH,
                             num_steps=DP_STEPS, validation_frequency=1000)
    weights = create_train_state(RaftStereoConfig(), tc, "cpu",
                                 seed=tc.seed).model.state_dict()
    st = create_train_state(RaftStereoConfig(), tc, "cuda",
                            state_dict=ulp_moved(weights, SEED + 38))
    step = make_train_step(tc)
    losses = []
    for b in batches:
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    return losses, flat_params(st.model).cpu().numpy()


def flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def dp_worker(rank, world, port, out, ckpt):
    """One rank of phase 38 (b) and (c) (``chip_smoke.py --dp-rank``): a
    gloo group on the one card; two steps, then the same run stopped by a
    SIGTERM to rank 1 after step 1 and resumed from process 0's
    checkpoint.  Writes losses, seconds, parameters and launch counts."""
    sys.path.insert(0, HERE)
    from raft_stereo_tpu_torch.parallel import distributed
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    distributed.initialize(f"tcp://localhost:{port}", world_size=world,
                           rank=rank, backend="gloo", device="cuda")
    try:
        batches = dp_batches(DP_STEPS)
        kw = dict(process_index=rank, process_count=world)
        zero_training_counts()
        full, losses, secs = dp_train(batches, **kw)
        counts = training_counts()
        stopped, _, _ = dp_train(batches, ckpt=ckpt, stop_after=1, **kw)
        after_stop = sorted(os.listdir(ckpt))
        resumed, r_losses, _ = dp_train(batches, ckpt=ckpt,
                                        restore="latest", **kw)
        np.savez(out, losses=np.asarray(losses), seconds=np.asarray(secs),
                 params=flat_params(full.model).cpu().numpy(),
                 resumed=flat_params(resumed.model).cpu().numpy(),
                 resumed_losses=np.asarray(r_losses),
                 stopped_step=np.asarray(stopped.step),
                 resumed_step=np.asarray(resumed.step),
                 counts=np.asarray([counts[k] for k in sorted(counts)]),
                 count_keys=np.asarray(sorted(counts)),
                 after_stop=np.asarray(after_stop))
    finally:
        distributed.shutdown()
    return 0


def phase_data_parallel(card):
    """Phase 38 (module docstring).  Returns the wrappers' counts over the
    world-of-one DDP steps and the measurements."""
    from raft_stereo_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    release()
    out = {}
    batches = dp_batches(DP_STEPS)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        # (a) a world of one over NCCL against the same steps without DDP
        plain, plain_losses, plain_secs = dp_train(batches)
        plain_params = flat_params(plain.model)
        del plain
        release()
        # the card's own spread over the same two steps: train()'s initial
        # weights moved by one ulp (22 iterations of random weights
        # amplify any reassociation, the second step's loss also AdamW's
        # sign of noise-sized gradients)
        moved_losses, moved_params = dp_moved_steps(batches)
        release()
        distributed.initialize(f"tcp://localhost:{free_port()}",
                               world_size=1, rank=0, backend="nccl",
                               device="cuda")
        try:
            zero_training_counts()
            one, one_losses, one_secs = dp_train(batches)
            counts = training_counts()
            wrapped = type(one.ddp).__name__
            bitwise = (torch.equal(flat_params(one.model), plain_params)
                       and one_losses == plain_losses)
            del one
        finally:
            distributed.shutdown()
        release()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    # (b), (c): two gloo ranks on the one card, in processes of their own
    work = os.path.join(HERE, "_smoke_data", "dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    port = free_port()
    outs = [os.path.join(work, f"rank{r}.npz") for r in range(2)]
    t_spawn = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         "2", str(port), outs[r], os.path.join(work, "ck")],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_WORKER_TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    spawn_s = time.perf_counter() - t_spawn
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            log(text[-4000:])
            raise AssertionError(f"phase 38 rank exited {p.returncode}")
    r0, r1 = (np.load(o) for o in outs)
    ck_entries = [str(e) for e in r0["after_stop"]]
    shutil.rmtree(work, ignore_errors=True)
    plain_np = plain_params.cpu().numpy()
    ranks_equal = all(np.array_equal(r0[k], r1[k]) for k in (
        "params", "losses", "resumed", "resumed_losses"))
    base = np.abs(np.asarray(plain_losses))
    loss_rels = np.abs(r0["losses"] - np.asarray(plain_losses)) / base
    loss_spread = np.abs(np.asarray(moved_losses)
                         - np.asarray(plain_losses)) / base
    loss_bounds = np.maximum(DP_LOSS_RTOL, DP_SPREAD_FACTOR * loss_spread)
    param_abs = float(np.abs(r0["params"] - plain_np).max())
    param_spread = float(np.abs(moved_params - plain_np).max())
    param_bound = max(DP_PARAM_ATOL, DP_SPREAD_FACTOR * param_spread)
    resume_bitwise = (np.array_equal(r0["resumed"], r0["params"])
                      and float(r0["resumed_losses"][-1])
                      == float(r0["losses"][-1]))
    rank_counts = dict(zip((str(k) for k in r0["count_keys"]),
                           (int(c) for c in r0["counts"])))
    want = {"lookup": DP_STEPS * 22, "lookup_bwd": DP_STEPS * 22,
            "gates": DP_STEPS * 132}
    ok = (bitwise and wrapped == "DistributedDataParallel" and ranks_equal
          and bool((loss_rels <= loss_bounds).all())
          and param_abs <= param_bound
          and resume_bitwise and int(r0["stopped_step"]) == 1
          and int(r1["stopped_step"]) == 1
          and int(r0["resumed_step"]) == DP_STEPS
          and ck_entries == ["dp"]
          and all(counts[k] == v for k, v in want.items())
          and all(rank_counts[k] > 0 for k in want))
    out.update(one_step_s=one_secs, plain_step_s=plain_secs,
               two_rank_step_s=[float(s) for s in r0["seconds"]],
               two_rank_loss_rel=loss_rels.tolist(),
               loss_spread=loss_spread.tolist(),
               two_rank_param_abs=param_abs, param_spread=param_spread,
               spawn_s=spawn_s)
    log(f"data parallel, default config fp32, TrainConfig() crop, global "
        f"batch {DP_BATCH}, {DP_STEPS} steps, cuDNN deterministic: (a) a "
        f"world of one over NCCL ({wrapped}) bit for bit equal to the steps "
        f"without DDP: {bitwise} (losses {one_losses}); seconds per step "
        f"DDP {[round(s, 4) for s in one_secs]}, without "
        f"{[round(s, 4) for s in plain_secs]}; launches {counts} (want "
        f"{want}); (b) two gloo ranks on the one card: ranks bit for bit "
        f"equal {ranks_equal}; against one process at the global batch, "
        f"per step, losses rel {[f'{v:.2e}' for v in loss_rels]} (<= "
        f"{[f'{v:.2e}' for v in loss_bounds]}: the larger of "
        f"{DP_LOSS_RTOL:g} and {DP_SPREAD_FACTOR:g}x the card's spread, "
        f"one process from weights moved by one ulp: "
        f"{[f'{v:.2e}' for v in loss_spread]}), parameters max |d| "
        f"{param_abs:.3e} (<= {param_bound:.3e}: the larger of "
        f"{DP_PARAM_ATOL:g} and {DP_SPREAD_FACTOR:g}x the spread "
        f"{param_spread:.3e}); seconds per step "
        f"{[round(float(s), 4) for s in r0['seconds']]}; rank 0's launches "
        f"{rank_counts}; (c) SIGTERM to rank 1 after step 1: both stopped "
        f"at {int(r0['stopped_step'])}/{int(r1['stopped_step'])}, "
        f"checkpoints {ck_entries}, resumed by both ranks to "
        f"{int(r0['resumed_step'])} bit for bit equal to the run that never "
        f"stopped: {resume_bitwise}; the ranks' processes took "
        f"{spawn_s:.1f} s; phase 38 took {time.perf_counter() - t_phase:.1f} "
        f"s on {card}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("phase 38 (data parallel) failed its checks")
    return counts, out


def cp_grads(model, batch, tc, ctx=None):
    """One default training step's forward and backward (the step's
    loss, ``training/loss.sequence_loss``) under the mesh contexts
    ``ctx``: (loss, {name: grad}, seconds, peak GiB)."""
    import contextlib

    from raft_stereo_tpu_torch.training.loss import sequence_loss

    model.zero_grad(set_to_none=True)

    def run():
        with ctx or contextlib.nullcontext():
            preds = model(batch["image1"], batch["image2"],
                          iters=tc.train_iters, test_mode=False)
            loss = sequence_loss(preds, batch["flow"].float(),
                                 batch["valid"].float(),
                                 loss_gamma=tc.loss_gamma,
                                 max_flow=tc.max_flow)[0]
            loss.backward()
        return float(loss.detach())

    loss, secs, peak, _ = peak_run(run)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss, grads, secs, peak


def grad_gap(got, want) -> float:
    """The largest per-leaf 99th percentile of |got - want| over the
    leaf's own scale, over the leaves whose scale is at least 1e-3 of the
    largest (the others are the biases before instance norms, whose true
    gradient is zero)."""
    top = max(float(g.abs().max()) for g in want.values())
    worst = 0.0
    for k, w in want.items():
        scale = float(w.abs().max())
        if scale < 1e-3 * top:
            continue
        rel = ((got[k].to(w.device) - w).abs() / scale).flatten().float()
        if rel.numel() > 1_000_000:
            rel = rel[torch.randperm(rel.numel(), device=rel.device)[
                :1_000_000]]
        worst = max(worst, float(torch.quantile(rel, 0.99)))
    return worst


def phase_context_parallel(cfg, state, card):
    """Phase 39 (module docstring).  Returns the wrappers' counts over each
    sharded run, and the measurements."""
    import contextlib

    from raft_stereo_tpu_torch.config import TrainConfig
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
    from raft_stereo_tpu_torch.eval.runner import make_forward
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_fused, lookup_pyramid_xla)
    from raft_stereo_tpu_torch.kernels.gru_fused import (_gates_reference,
                                                         gru_gates_fused)
    from raft_stereo_tpu_torch.models.corr import (build_corr_pyramid,
                                                   make_corr_fn)
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    from raft_stereo_tpu_torch.parallel.corr_sharded import (
        make_corr_fn_w2_sharded)
    from raft_stereo_tpu_torch.parallel.mesh import (make_mesh,
                                                     mesh_contexts)
    from raft_stereo_tpu_torch.parallel.rows_gru import validate_rows_gru
    from raft_stereo_tpu_torch.serving import ServeConfig, ServingEngine

    t_phase = time.perf_counter()
    release()
    out, counts = {}, {}
    group = [torch.device("cuda", 0)] * 2
    meshes = {"rows": make_mesh(n_rows=2, devices=group),
              "corr": make_mesh(n_corr=2, devices=group)}
    cfgs = {"solo": cfg,
            "rows": dataclasses.replace(cfg, rows_shards=2, rows_gru=True),
            "corr": dataclasses.replace(cfg, corr_w2_shards=2)}

    def contexts(axis):
        return mesh_contexts(meshes[axis])

    def model_of(what, sd=state):
        m = RAFTStereo(cfgs[what])
        m.load_state_dict(sd)
        return m.cuda().eval()

    moved = ulp_moved(state, SEED + 39)
    checks = {}

    # (a) rows_shards=2 with rows_gru on phase 37's pair, and (b)
    # corr_w2_shards=2 at KITTI's bucket: each pair at CP_ITERS against
    # the unsharded model and against the unsharded model on weights moved
    # by one ulp (the card's own spread)
    for axis, hw in (("rows", TILE_HW), ("corr", MAIN_HW)):
        img1, img2 = padded_pair(hw, SEED + 39)
        runs = {}
        for what, sd in (("solo", state), (axis, state), ("ulp", moved)):
            m = model_of("solo" if what == "ulp" else what, sd)
            with torch.inference_mode(), (
                    contexts(axis) if what == axis
                    else contextlib.nullcontext()):
                m(img1, img2, iters=1)            # warm-up
                zero_inference_counts()
                flows, secs, peak, above = peak_run(
                    lambda: m(img1, img2, iters=CP_ITERS))
            runs[what] = {"flows": flows, "seconds": secs, "peak_gib": peak,
                          "peak_above_inputs_gib": above,
                          "launches": {
                              "lookup": lookup_pyramid_fused.launches,
                              "gates": gru_gates_fused.launches}}
            del m
            release()
        d = max(float((a - b).abs().max()) for a, b in zip(
            runs[axis]["flows"], runs["solo"]["flows"]))
        spread = max(float((a - b).abs().max()) for a, b in zip(
            runs["ulp"]["flows"], runs["solo"]["flows"]))
        bound = max(CP_FLOW_ATOL, CP_SPREAD_FACTOR * spread)
        finite = all(bool(torch.isfinite(f).all())
                     for r in runs.values() for f in r["flows"])
        shapes_ok = all(a.shape == b.shape for a, b in zip(
            runs[axis]["flows"], runs["solo"]["flows"]))
        counts[f"{axis}_pair"] = runs[axis]["launches"]
        # a lookup per shard and iteration; the corr axis runs the loop
        # unsharded (3 gate calls an iteration), the rows axis per shard
        want = {"lookup": 2 * CP_ITERS,
                "gates": (2 if axis == "rows" else 1) * 3 * CP_ITERS}
        checks[f"{axis} pair"] = (finite and shapes_ok and d <= bound
                                  and runs[axis]["launches"] == want)
        for r in runs.values():
            del r["flows"]
        out[f"{axis}_pair"] = dict(
            hw=list(img1.shape[1:3]), flow_max_abs=d, spread=spread,
            bound=bound, **{k: {kk: vv for kk, vv in v.items()}
                            for k, v in runs.items()})
        log(f"phase 39 ({'a' if axis == 'rows' else 'b'}) {axis} x2, "
            f"default config fp32, {img1.shape[1]}x{img1.shape[2]}, "
            f"{CP_ITERS} iterations: max |sharded - unsharded| {d:.3e} px "
            f"(<= {bound:.3e}: the larger of {CP_FLOW_ATOL:g} and "
            f"{CP_SPREAD_FACTOR:g}x the one-ulp spread {spread:.3e}); "
            f"seconds unsharded {runs['solo']['seconds']:.4f}, sharded "
            f"{runs[axis]['seconds']:.4f}; max_memory_allocated "
            f"{runs['solo']['peak_gib']:.3f} / {runs[axis]['peak_gib']:.3f} "
            f"GiB (above the inputs {runs['solo']['peak_above_inputs_gib']:.3f}"
            f" / {runs[axis]['peak_above_inputs_gib']:.3f}); launches "
            f"{runs[axis]['launches']} (want {want}): "
            f"{'ok' if checks[f'{axis} pair'] else 'FAILED'}")
        del img1, img2
        release()

    # the kernels at this slice's shapes against their plain versions (not
    # counted): #1 on a rows shard's windowed pyramid (2016/4/2 rows +
    # 2 halos), #1 with shard-shifted centres (the corr shards of the
    # KITTI bucket: windows wholly outside a shard included), against the
    # unsharded lookup and the plain sharded one, and #5 on the windows
    gen = torch.Generator().manual_seed(SEED + 39)
    h_f = TILE_HW[0] + (-TILE_HW[0]) % 32
    halo = validate_rows_gru(cfgs["rows"], h_f // 4, 2)
    rows_w, w1 = h_f // 8 + 2 * halo, (TILE_HW[1] + (-TILE_HW[1]) % 32) // 4
    vol = torch.randn((1, rows_w, w1, w1), generator=gen).cuda()
    pyramid = build_corr_pyramid(vol, LEVELS)
    coords = (torch.rand((1, rows_w, w1), generator=gen) * (w1 + 20)
              - 10).cuda()
    win_err = float((lookup_pyramid_fused(pyramid, coords, RADIUS)
                     - lookup_pyramid_xla(pyramid, coords, RADIUS)
                     ).abs().max())
    del vol, pyramid, coords
    hk, wk = PADDED_HW[0] // 4, PADDED_HW[1] // 4
    f1 = torch.randn((1, 256, hk, wk), generator=gen).cuda()
    f2 = torch.randn((1, 256, hk, wk), generator=gen).cuda()
    coords = (torch.rand((1, hk, wk), generator=gen) * (wk + 80)
              - 40).cuda()
    with torch.inference_mode():
        unsharded = make_corr_fn(cfg, f1, f2)(coords)
        sharded = make_corr_fn_w2_sharded(cfgs["corr"], f1, f2,
                                          meshes["corr"])(coords)
        plain = make_corr_fn_w2_sharded(
            dataclasses.replace(cfgs["corr"], corr_backend="reg"), f1, f2,
            meshes["corr"])(coords)
    shard_err = float((sharded - plain).abs().max())
    shard_vs_solo = float((sharded - unsharded).abs().max())
    del f1, f2, coords, unsharded, sharded, plain
    gate_err = 0.0
    for shape in ((1, rows_w, w1, CH, 256),
                  (1, rows_w // 2, w1 // 2, CH, 256),
                  (1, rows_w // 4, w1 // 4, CH, 128)):
        args = gate_args(gen, torch.device("cuda"), shape, torch.float32)
        got = gru_gates_fused(*args)
        gate_err = max(gate_err, max(
            float((g - w).abs().max())
            for g, w in zip(got, _gates_reference(*args))))
    checks["kernels"] = (win_err <= LOOKUP_ATOL and shard_err <= LOOKUP_ATOL
                         and shard_vs_solo <= LOOKUP_ATOL
                         and gate_err <= GATES_ATOL)
    out.update(lookup_window_err=win_err, lookup_shard_err=shard_err,
               lookup_shard_vs_unsharded=shard_vs_solo, gates_err=gate_err)
    log(f"phase 39 kernels at this slice's shapes: #1 on a rows window "
        f"(1, {rows_w}, {w1}, {w1}) max |kernel - plain| {win_err:.3e}; #1 "
        f"with shard-shifted centres over corr x2 at {hk}x{wk}: against "
        f"the plain sharded lookup {shard_err:.3e}, against the unsharded "
        f"lookup {shard_vs_solo:.3e} (<= {LOOKUP_ATOL:g}); #5 on the windows "
        f"{gate_err:.3e} (<= {GATES_ATOL:g})")
    release()

    # (c) one default training step's loss and gradients at TrainConfig()
    # under each axis against the unsharded step (and its one-ulp spread),
    # at the default 22 iterations and at CP_GRAD_ITERS
    tc = TrainConfig()
    host = SyntheticStereoLoader(tc.batch_size, tc.image_size,
                                 seed=SEED).batch(0)
    batch = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    out["step"] = {}
    for n in (tc.train_iters, CP_GRAD_ITERS):
        tc_n = dataclasses.replace(tc, train_iters=n)
        steps = {}
        ref = None
        for what, sd in (("solo", state), ("ulp", moved), ("rows", state),
                         ("corr", state)):
            m = model_of("solo" if what == "ulp" else what, sd).train()
            zero_training_counts()
            loss, grads, secs, peak = cp_grads(
                m, batch, tc_n, contexts(what) if what in meshes else None)
            steps[what] = {"loss": loss, "seconds": secs, "peak_gib": peak,
                           "launches": training_counts()}
            if what == "solo":
                ref = grads
            else:
                steps[what]["grad_q99"] = grad_gap(grads, ref)
            del m, grads
            release()
        del ref
        base = abs(steps["solo"]["loss"])
        loss_spread = abs(steps["ulp"]["loss"] - steps["solo"]["loss"]) / base
        loss_bound = max(CP_LOSS_RTOL, CP_SPREAD_FACTOR * loss_spread)
        grad_bound = max(CP_GRAD_Q99,
                         CP_SPREAD_FACTOR * steps["ulp"]["grad_q99"])
        for axis in meshes:
            st = steps[axis]
            st["loss_rel"] = abs(st["loss"] - steps["solo"]["loss"]) / base
            want = {"lookup": 2 * n, "lookup_bwd": 2 * n,
                    "gates": 2 * 6 * n if axis == "rows" else 6 * n,
                    "alt": 0, "alt_bwd": 0}
            if n == tc.train_iters:
                counts[f"{axis}_step"] = st["launches"]
            checks[f"{axis} step {n}"] = (st["loss_rel"] <= loss_bound
                                          and st["grad_q99"] <= grad_bound
                                          and st["launches"] == want)
            log(f"phase 39 (c) {axis} x2, one default step at TrainConfig()"
                f" (batch {tc.batch_size}, {tc.image_size[0]}x"
                f"{tc.image_size[1]}, {n} iterations): loss "
                f"{st['loss']:.6f} against {steps['solo']['loss']:.6f} (rel "
                f"{st['loss_rel']:.2e} <= {loss_bound:.2e}); gradients' "
                f"worst per-leaf q99 of |d| / scale {st['grad_q99']:.2e} "
                f"(<= {grad_bound:.2e}: the larger of {CP_GRAD_Q99:g} and "
                f"{CP_SPREAD_FACTOR:g}x the one-ulp weights' "
                f"{steps['ulp']['grad_q99']:.2e}); seconds "
                f"{steps['solo']['seconds']:.3f} / {st['seconds']:.3f}; peak "
                f"{steps['solo']['peak_gib']:.3f} / {st['peak_gib']:.3f} GiB;"
                f" launches {st['launches']} (want {want}): "
                f"{'ok' if checks[f'{axis} step {n}'] else 'FAILED'}")
        out["step"][n] = steps
    del batch

    # (d) an engine with xl_mesh rows=2 over the card named twice: a KITTI
    # pair above the threshold rides the xl tier, against make_forward
    # solo (and its one-ulp spread) on the same padded images
    left, right = (np.ascontiguousarray(x[0].cpu().numpy().astype(np.uint8))
                   for x in padded_pair(MAIN_HW, SEED + 39))
    solo_out = {}
    for what, sd in (("solo", state), ("ulp", moved)):
        m = model_of("solo", sd)
        with torch.inference_mode():
            solo_out[what] = make_forward(m, CP_ITERS)(
                *(torch.from_numpy(a[None]).cuda() for a in (left, right))
            )[0].cpu().numpy()
        del m
        release()
    zero_inference_counts()
    with ServingEngine(cfg, state, ServeConfig(
            iters=CP_ITERS, tiers=(), batch_sizes=(1,), max_batch=1,
            xl_mesh="rows=2", xl_threshold_pixels=CP_XL_THRESHOLD),
            device="cuda", xl_devices=group) as eng:
        status = eng.xl_status()
        res = eng.infer(left, right, timeout=600)
        forced = eng.infer(left, right, tier="xl", timeout=600)
        small = eng.infer(left[:96, :320], right[:96, :320], timeout=600)
    xl_counts = {"lookup": lookup_pyramid_fused.launches,
                 "gates": gru_gates_fused.launches}
    release()
    d_xl = float(np.abs(res.flow - solo_out["solo"]).max())
    spread_xl = float(np.abs(solo_out["ulp"] - solo_out["solo"]).max())
    xl_bound = max(CP_FLOW_ATOL, CP_SPREAD_FACTOR * spread_xl)
    counts["xl"] = xl_counts
    # two xl dispatches of CP_ITERS iterations on two shards each, and the
    # small pair's solo capture (a warm-up and a capture)
    want_xl = {"lookup": 2 * 2 * CP_ITERS + 2 * CP_ITERS,
               "gates": 2 * 2 * 3 * CP_ITERS + 2 * 3 * CP_ITERS}
    checks["xl"] = (status is not None and res.tier == "xl"
                    and res.mesh == "rows2" and forced.tier == "xl"
                    and np.array_equal(res.flow, forced.flow)
                    and small.tier is None and small.mesh is None
                    and d_xl <= xl_bound and xl_counts == want_xl)
    out["xl"] = dict(status=status, flow_max_abs=d_xl, spread=spread_xl,
                     bound=xl_bound, device_s=res.device_s,
                     total_s=res.total_s)
    log(f"phase 39 (d) engine xl_mesh=rows=2 over {group}: {status}; a "
        f"{MAIN_HW[0]}x{MAIN_HW[1]} request above {CP_XL_THRESHOLD} px on "
        f"tier {res.tier!r} mesh {res.mesh!r} ({res.device_s:.4f} s on the "
        f"group), max |xl - make_forward solo| {d_xl:.3e} px (<= "
        f"{xl_bound:.3e}, spread {spread_xl:.3e}); ?tier=xl the same "
        f"answer; a 96x320 request solo (tier {small.tier!r}); launches "
        f"{xl_counts} (want {want_xl}): {'ok' if checks['xl'] else 'FAILED'}")
    ok = all(checks.values())
    log(f"phase 39 took {time.perf_counter() - t_phase:.1f} s on {card}: "
        f"{'ok' if ok else 'FAILED ' + str([k for k, v in checks.items() if not v])}")
    if not ok:
        raise AssertionError("phase 39 (context parallelism) failed its "
                             "checks")
    return counts, out


def mark(what: str) -> None:
    """Log the script's elapsed seconds where ``what`` starts, and the
    card's memory held by tensors and by the allocator's cache there."""
    log(f"{what} starts at {time.perf_counter() - T_START:.1f} s (card "
        f"memory allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB, reserved {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB)")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "raft_stereo_tpu_torch")):
        print("chip_smoke.py needs the raft_stereo_tpu_torch package beside "
              "it", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    import raft_stereo_tpu_torch
    if not os.path.abspath(raft_stereo_tpu_torch.__file__).startswith(HERE):
        print("raft_stereo_tpu_torch resolved outside this checkout",
              file=sys.stderr)
        return 2
    from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner, full_fp32
    from raft_stereo_tpu_torch.kernels import _build
    from raft_stereo_tpu_torch.kernels.corr_alt import (
        alt_lookup_bwd_fused, alt_lookup_bwd_xla, alt_lookup_fused,
        alt_lookup_xla, plan_bwd, plan_fwd)
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_bwd_fused, lookup_pyramid_bwd_xla,
        lookup_pyramid_fused, lookup_pyramid_xla)
    from raft_stereo_tpu_torch.kernels.gru_fused import (TILES, _launch,
                                                         _gates_vjp,
                                                         _gates_reference,
                                                         _gates_twin, blocks,
                                                         gru_gates_fused,
                                                         smem_bytes, tile)
    from raft_stereo_tpu_torch.kernels.corr_alt import alt_lookup_fused_q
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_fused_q)
    from raft_stereo_tpu_torch.models import raft_stereo as raft_module
    from raft_stereo_tpu_torch.models.corr import (build_corr_pyramid,
                                                   pool_axis)
    from raft_stereo_tpu_torch.models.extractor import Conv2d
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    from raft_stereo_tpu_torch.quant import core as qcore
    from raft_stereo_tpu_torch.quant.calibrate import (calibrate,
                                                       conv_input_scales,
                                                       corr_scales)
    from raft_stereo_tpu_torch.quant.matmul import int8_conv_int32
    from raft_stereo_tpu_torch.training.state import create_train_state
    from raft_stereo_tpu_torch.training.step import train_step
    from raft_stereo_tpu_torch.training.train_loop import train

    # ------------------------------------------------------------ phase 1
    mark("phase 1")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    full_fp32()
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in built.items()})})")
    for src in _build.sources():
        if src == "gru_gates":    # reported per instantiation below
            continue
        report = _build.library_path(src).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")
    gate_lib = _build.library_path("gru_gates")
    for inst, line in sorted(gate_ptxas(
            gate_lib.with_suffix(".log").read_text()).items()):
        dt_, _, bn_, _, wg_, *_ = inst.split()
        smem = smem_bytes(torch.float32 if dt_ == "fp32" else torch.bfloat16,
                          int(bn_), int(wg_))
        log(f"  gates {inst}: {line}; dynamic shared memory {smem} B")
    sass = subprocess.run([cuobjdump(_build._nvcc()), "-sass", str(gate_lib)],
                          capture_output=True, text=True, check=True).stdout
    tensor_ops = gate_sass(sass)
    for inst, ops in sorted(tensor_ops.items()):
        log(f"  gates {inst} SASS tensor-core instructions: {ops}")
    bare = [i for i, ops in tensor_ops.items()
            if not any(op.startswith("HGMMA") for op in ops)]
    if len(tensor_ops) != 2 * 2 * len(TILES) or bare:
        raise AssertionError(f"gate kernels without HGMMA: {bare} (of "
                             f"{sorted(tensor_ops)})")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)

    def gate_timing(label, args, calls):
        """Time one gate call (graph replays and single calls), its plain
        version and the library call; print TFLOP/s, the share of the
        bound, the factor against the library and each launch's tile."""
        h_, x_ = args[0], args[1]
        b_, hh_, ww_, ch_ = h_.shape
        cin_ = ch_ + x_.shape[-1]
        fp32 = h_.dtype == torch.float32
        flops = 2 * b_ * hh_ * ww_ * 9 * cin_ * 3 * ch_
        item = h_.element_size()
        nbytes = (item * b_ * hh_ * ww_ * (cin_ + ch_ + 3 * ch_)
                  + item * 9 * cin_ * 3 * ch_ + 4 * 3 * ch_)
        ops_ms = (3 * flops / TF32_RATE if fp32 else flops / BF16_RATE) * 1e3
        bytes_ms = nbytes / MEM_RATE * 1e3
        bound = max(ops_ms, bytes_ms)
        lib_fn = gates_library(args)
        ms = graph_ms(lambda: gru_gates_fused(*args), flush)
        single = time_ms(lambda: gru_gates_fused(*args), flush)
        plain = graph_ms(lambda: _gates_reference(*args), flush)
        lib = graph_ms(lib_fn, flush)
        lib_single = time_ms(lib_fn, flush)
        grids = []
        for what, cout in (("zr", 2 * ch_), ("q", ch_)):
            bn, wg, ks = tile((b_, hh_, ww_), cout, sms)
            n = blocks((b_, hh_, ww_), cout, bn, wg, ks)
            grids.append(f"{what} {bn}x{wg}{f' K/{ks}' if ks > 1 else ''}: "
                         f"{n} blocks, {n / sms:.2f}/SM")
        log(f"gates {'fp32' if fp32 else 'bf16'} timing {label}"
            f"{f' (x{calls} per iteration)' if calls > 1 else ''}: kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} "
            f"of the bound; single call {single:.4f}), plain {plain:.4f}, "
            f"conv2d x2 {lib:.4f} (single call {lib_single:.4f}): "
            f"{lib / ms:.2f}x; bound {bound:.5f} ms ({flops / 1e9:.2f} GFLOP"
            f"{', 3xTF32 on the tensor cores' if fp32 else ''}; "
            f"{flops / FP32_RATE * 1e3:.4f} ms on the fp32 CUDA cores; "
            f"{nbytes / 1e6:.1f} MB: {bytes_ms:.5f} ms); {'; '.join(grids)}")
        return {"ms": ms, "plain": plain, "lib": lib, "bound": bound,
                "by": "operations" if ops_ms >= bytes_ms else "bytes"}

    def per_iteration(rows, times):
        """Sum over a path's levels, each times its calls per iteration."""
        tot = {k_: sum(c_ * times[n_][k_] for n_, c_ in rows if c_)
               for k_ in ("ms", "plain", "lib", "bound")}
        tot["by"] = ("bytes" if any(times[n_]["by"] == "bytes"
                                    for n_, c_ in rows if c_)
                     else "operations")
        return tot

    # ------------------------------------------------------------ phase 2
    mark("phase 2")
    vol = torch.randn((1, ROWS, W1, W1), generator=gen).to(dev)
    pyramid = build_corr_pyramid(vol, LEVELS)
    w2s = [v.shape[-1] for v in pyramid]
    coords = (torch.rand((1, ROWS, W1), generator=gen) * (W1 + 20) - 10).to(dev)
    got = lookup_pyramid_fused(pyramid, coords, RADIUS)
    torch.cuda.synchronize()
    lookup_err = float((got - lookup_pyramid_xla(pyramid, coords, RADIUS)
                        ).abs().max())
    log(f"lookup, 4 levels {w2s}: max |kernel - plain| = {lookup_err:.3e} "
        f"(atol {LOOKUP_ATOL})")
    for i, v in enumerate(pyramid):
        c = coords / 2 ** i
        one = lookup_pyramid_fused([v], c, RADIUS)
        torch.cuda.synchronize()
        err = float((one - lookup_pyramid_xla([v], c, RADIUS)).abs().max())
        log(f"lookup, level {i} alone (W2 {v.shape[-1]}, scale 1/{2 ** i}): "
            f"max |kernel - plain| = {err:.3e}")
        lookup_err = max(lookup_err, err)
    if not lookup_err <= LOOKUP_ATOL:
        raise AssertionError(f"lookup kernel disagrees: {lookup_err}")

    # ------------------------------------------------------------ phase 3
    mark("phase 3")
    gate_cases = {}
    gates_err = 0.0
    for name_, *shape, calls in GATE_ROWS_FP32 + tuple(
            o + (0,) for o in GATE_ODD):
        label = f"{name_} {tuple(shape[:3])} Ch {shape[3]} Cx {shape[4]}"
        args = gate_args(gen, dev, shape, torch.float32)
        got = gru_gates_fused(*args)
        torch.cuda.synchronize()
        want = _gates_reference(*args)
        err = max(float((g - wv).abs().max()) for g, wv in zip(got, want))
        line = (f"gates fp32 {label}: max |kernel - plain| = {err:.3e} "
                f"(atol {GATES_ATOL})")
        if not name_.startswith(("odd", "TINY")):
            ref = gates_fp64(*args)
            d_k = max(float((g.double() - r_).abs().max())
                      for g, r_ in zip(got, ref))
            d_p = max(float((wv.double() - r_).abs().max())
                      for wv, r_ in zip(want, ref))
            ok64 = d_k <= GATES_FP64_FACTOR * d_p + GATES_FP64_ATOL
            line += (f"; against fp64: kernel {d_k:.3e}, plain {d_p:.3e} "
                     f"(kernel <= {GATES_FP64_FACTOR:g} x plain + "
                     f"{GATES_FP64_ATOL:g}: {'ok' if ok64 else 'FAILED'})")
            del ref
            if not ok64:
                log(line)
                raise AssertionError(f"fp32 gates {label} not of fp32 "
                                     f"accuracy: {d_k} against {d_p}")
        log(line)
        gates_err = max(gates_err, err)
        gate_cases[label] = (args, calls)
    if not gates_err <= GATES_ATOL:
        raise AssertionError(f"gate kernel disagrees: {gates_err}")

    # ------------------------------------------------------------ phase 4
    mark("phase 4")
    k = 2 * RADIUS + 1
    taps = torch.arange(-RADIUS, RADIUS + 1, device=dev, dtype=torch.float32)
    grids, sources = [], []
    for i, v in enumerate(pyramid):
        x = coords[..., None] / 2 ** i + taps
        gx = (2 * x / (v.shape[-1] - 1) - 1).reshape(-1, 1, k, 1)
        grids.append(torch.cat([gx, torch.zeros_like(gx)], dim=-1))
        sources.append(v.reshape(-1, 1, 1, v.shape[-1]))

    def lookup_library():
        return torch.cat([F.grid_sample(s, g, mode="bilinear",
                                        padding_mode="zeros",
                                        align_corners=True)
                          for s, g in zip(sources, grids)], dim=-1)

    lib_err = float((lookup_library().reshape(1, ROWS, W1, -1)
                     - lookup_pyramid_xla(pyramid, coords, RADIUS)
                     ).abs().max())
    log(f"lookup yardstick grid_sample: max |library - plain| = "
        f"{lib_err:.3e}")
    lookup_t = timed(lambda: lookup_pyramid_fused(pyramid, coords, RADIUS),
                     lambda: lookup_pyramid_xla(pyramid, coords, RADIUS),
                     lookup_library, flush)
    lookup_bound_ms = lookup_bytes(coords, w2s) / MEM_RATE * 1e3
    log("lookup timing: "
        + describe(lookup_t, "grid_sample x4", lookup_bound_ms, "bytes"))
    log(f"rule 2 on the graph-replay times: lookup fp32 kernel "
        f"{lookup_t['ms']:.4f} ms vs grid_sample x4 {lookup_t['lib']:.4f} ms:"
        f" {'slower' if lookup_t['ms'] > lookup_t['lib'] else 'not slower'}")
    bound_once = host_us(lambda: lookup_pyramid_fused(pyramid, coords,
                                                      RADIUS))
    bound_per_call = host_us(lambda: (_build._entries.clear(),
                                      lookup_pyramid_fused(pyramid, coords,
                                                           RADIUS)))
    log(f"lookup fp32 wrapper, host time per call: {bound_once:.1f} us with "
        f"its C entry bound once, {bound_per_call:.1f} us binding the entry "
        f"on every call (the earlier wrappers)")
    class FunctionGates(torch.autograd.Function):
        """The kernel behind a bare ``autograd.Function``, the port's gate
        wrapper before ``raft_stereo::gru_gates``: its host cost beside
        the operator's."""

        @staticmethod
        def forward(ctx, *inputs):
            ctx.save_for_backward(*inputs)
            return _launch(*inputs)

        @staticmethod
        def backward(ctx, *grads):
            return _gates_vjp(ctx.saved_tensors, grads, ctx.needs_input_grad)

    g_label, (g_args, _) = next(iter(gate_cases.items()))
    g_grad = [t.detach().requires_grad_(True) for t in g_args]
    with torch.no_grad():
        op_us = host_us(lambda: gru_gates_fused(*g_args))
        fn_us = host_us(lambda: FunctionGates.apply(*g_args))
        bare_us = host_us(lambda: _launch(*g_args))
    op_grad_us = host_us(lambda: gru_gates_fused(*g_grad))
    fn_grad_us = host_us(lambda: FunctionGates.apply(*g_grad))
    log(f"gate wrapper ({g_label}), host time per call: {op_us:.1f} us "
        f"through the raft_stereo::gru_gates operator ({op_grad_us:.1f} us "
        f"recording its autograd node), {fn_us:.1f} us through a bare "
        f"autograd.Function ({fn_grad_us:.1f} us recording), {bare_us:.1f} "
        f"us for the ctypes launch alone (packing cached in all)")
    del g_grad
    tiny = torch.zeros(1, device=dev)
    floor_ms = graph_ms(tiny.zero_, tiny)
    log(f"graph replay of one one-element kernel: {floor_ms:.4f} ms (the "
        f"replay's own floor, inside every graph-replay time here)")

    def alone(label, fn, bound):
        """Print a short kernel's time without the replay floor."""
        ms_ = graph_each_ms(fn, flush)
        log(f"{label}, 20 calls per replay with the flushes subtracted: "
            f"{ms_:.4f} ms per call, {ms_ / bound:.1f}x the bound")

    alone("lookup fp32", lambda: lookup_pyramid_fused(pyramid, coords, RADIUS),
          lookup_bound_ms)

    gate_times = {label: gate_timing(label, args, calls)
                  for label, (args, calls) in gate_cases.items()}
    gates_fp32 = per_iteration([(lb, c_) for lb, (_, c_) in gate_cases.items()],
                               gate_times)
    log(f"gates fp32 per default iteration: kernel {gates_fp32['ms']:.4f} ms, "
        f"plain {gates_fp32['plain']:.4f}, conv2d {gates_fp32['lib']:.4f} "
        f"({gates_fp32['lib'] / gates_fp32['ms']:.2f}x), bound "
        f"{gates_fp32['bound']:.4f} ms (3xTF32)")
    del gate_cases

    # ------------------------------------------------------------ phase 5
    mark("phase 5")
    cfg = RaftStereoConfig()
    torch.manual_seed(SEED)
    model = RAFTStereo(cfg)
    state = {n: t.clone() for n, t in model.state_dict().items()}
    runner = InferenceRunner(cfg, model, iters=MAIN_ITERS, device="cuda")
    rs = np.random.default_rng(SEED)
    left = rs.integers(0, 256, MAIN_HW + (3,), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flow, launches, per_pair = capture_pair(runner, left, right,
                                            ("lookup", "gates", "alt"))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"main path {MAIN_HW[0]}x{MAIN_HW[1]} (padded 384x1248), "
        f"iters {MAIN_ITERS}: launches per pair {per_pair} (from the "
        f"capture; the wrappers' counts {launches}: warm-up and capture), "
        f"peak memory {peak_gib:.2f} GiB (warm-up and capture)")
    if flow.shape != MAIN_HW or not np.isfinite(flow).all():
        raise AssertionError(f"bad flow: shape {flow.shape}, finite "
                             f"{np.isfinite(flow).all()}")
    if per_pair != {"lookup": MAIN_ITERS, "gates": 3 * MAIN_ITERS,
                    "alt": 0}:
        raise AssertionError(f"main path kernel launches {per_pair}")
    secs, eager_secs = replay_and_eager_seconds(runner, left, right)
    replays_after_timing = {"default": runner.replays}
    log(f"main path seconds per pair: graph replay median "
        f"{statistics.median(secs):.4f} (runs "
        f"{[round(s, 4) for s in secs]}), eager median "
        f"{statistics.median(eager_secs):.4f} (runs "
        f"{[round(s, 4) for s in eager_secs]}); flow range "
        f"[{flow.min():.2f}, {flow.max():.2f}]")

    # ------------------------------------------------------------ phase 6
    mark("phase 6")
    small = rs.integers(0, 256, (128, 256, 3), dtype=np.uint8)
    small_r = np.roll(small, -4, axis=1)
    on_card = InferenceRunner(cfg, state, iters=2, device="cuda")(
        small, small_r)[0]
    on_cpu = InferenceRunner(cfg, state, iters=2, device="cpu")(
        small, small_r)[0]
    diff = float(np.abs(on_card - on_cpu).max())
    log(f"card vs CPU, 128x256, iters 2: max |Δflow| = {diff:.3e} px "
        f"(atol {CARD_VS_CPU_ATOL}; flow range [{on_cpu.min():.2f}, "
        f"{on_cpu.max():.2f}])")
    if not diff <= CARD_VS_CPU_ATOL:
        raise AssertionError(f"card and CPU disagree by {diff}")

    # ------------------------------------------------------------ phase 7
    mark("phase 7")
    def alt_case(dtype):
        def feats(w):
            return torch.randn((1, RT_ROWS, w, RT_D), generator=gen).to(
                dev, dtype)

        f1, pyr = feats(RT_W1), [feats(RT_W1)]
        for _ in range(LEVELS - 1):
            pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
        c = (torch.rand((1, RT_ROWS, RT_W1), generator=gen) * (RT_W1 + 20)
             - 10).to(dev)
        return f1, pyr, c

    alt_cases, alt_err = {}, {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        f1, pyr, c = alt_cases[tag] = alt_case(dtype)
        calls = [(pyr, c, "all levels")] + [
            ([v], c / 2 ** i, f"level {i} alone (scale 1/{2 ** i})")
            for i, v in enumerate(pyr)]
        worst, ok = 0.0, True
        for levels_, cc, what in calls:
            got = alt_lookup_fused(f1, levels_, cc, RADIUS)
            torch.cuda.synchronize()
            want = alt_lookup_xla(f1, levels_, cc, RADIUS)
            if got.dtype != dtype:
                raise AssertionError(f"alt kernel returned {got.dtype}")
            if dtype == torch.float32:
                err = float((got - want).abs().max())
                ok_ = err <= ALT_ATOL
            else:
                err, ok_ = bf16_ulp_error(got, want, BF16_ULPS, BF16_ATOL)
            log(f"alt {tag}, {what}, W2 {[v.shape[2] for v in levels_]}: "
                f"max |kernel - plain| = {err:.3e}")
            worst, ok = max(worst, err), ok and ok_
        alt_err[tag] = worst
        tol = (f"atol {ALT_ATOL}" if tag == "fp32"
               else f"{BF16_ULPS} bf16 ulp + {BF16_ATOL}")
        log(f"alt {tag}: worst {worst:.3e} ({tol}): "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"alt kernel ({tag}) disagrees: {worst}")

    rt_gate_cases = {}
    gates_bf16_err = 0.0
    for name_, *shape, calls in GATE_ROWS_BF16 + tuple(
            o + (0,) for o in GATE_ODD):
        label = f"{name_} {tuple(shape[:3])} Ch {shape[3]} Cx {shape[4]}"
        args = gate_args(gen, dev, shape, torch.bfloat16)
        got = gru_gates_fused(*args)
        torch.cuda.synchronize()
        errs = [bf16_ulp_error(g, wv, BF16_GATES_ULPS, BF16_GATES_ATOL)
                for g, wv in zip(got, _gates_reference(*args))]
        err = max(e for e, _ in errs)
        ok = all(o for _, o in errs) and all(
            g.dtype == torch.bfloat16 for g in got)
        log(f"gates bf16 {label}: max |kernel - plain| = {err:.3e} "
            f"({BF16_GATES_ULPS} bf16 ulps + {BF16_GATES_ATOL}): "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"bf16 gate kernel disagrees: {err}")
        gates_bf16_err = max(gates_bf16_err, err)
        rt_gate_cases[label] = (args, calls)

    pyr16 = build_corr_pyramid(vol.to(torch.bfloat16), LEVELS)
    got = lookup_pyramid_fused(pyr16, coords, RADIUS)
    torch.cuda.synchronize()
    lookup16_err, ok = bf16_ulp_error(
        got, lookup_pyramid_xla(pyr16, coords, RADIUS), BF16_ULPS, BF16_ATOL)
    log(f"lookup bf16, 4 levels {w2s}: max |kernel - plain| = "
        f"{lookup16_err:.3e} ({BF16_ULPS} bf16 ulp + {BF16_ATOL}): "
        f"{'ok' if ok and got.dtype == torch.bfloat16 else 'FAILED'}")
    if not ok or got.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 lookup kernel disagrees: {lookup16_err}")

    # ------------------------------------------------------------ phase 8
    mark("phase 8")
    def alt_bound(f1, pyr, c, out_item, quantized):
        """(bound ms, what bounds it, bytes, operations) of one alt call:
        the features, centers and output moved once; the window dots
        (2D per bin these centers touch) and, in fp32, the interpolation
        at the fp32 rate, or the dots alone at the int8/fp8 tensor rate."""
        k_ = LEVELS * (2 * RADIUS + 1)
        nbytes = ((f1.numel() + sum(v.numel() for v in pyr))
                  * f1.element_size() + c.numel() * 4
                  + c.numel() * k_ * out_item)
        ops = 2 * f1.shape[-1] * window_bins(c, [v.shape[2] for v in pyr])
        if not quantized:
            ops += 3 * c.numel() * k_
        bytes_ms = nbytes / MEM_RATE * 1e3
        ops_ms = ops / (INT8_RATE if quantized else FP32_RATE) * 1e3
        return (max(bytes_ms, ops_ms),
                "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)

    def alt_fields(label, call, f1, pyr, fields, out_item, quantized=False):
        """Time ``call(c)`` on each center field by one-call graph replay
        and as 20 calls per replay with the flushes subtracted, beside its
        bound (every alt bound lies below the replay floor)."""
        res = {}
        for fname, c_ in fields.items():
            bound, by, _, _ = alt_bound(f1, pyr, c_, out_item, quantized)
            one = graph_ms(lambda: call(c_), flush)
            each = graph_each_ms(lambda: call(c_), flush)
            log(f"{label}, {fname} centers: {one:.4f} ms by one-call graph "
                f"replay, {each:.4f} ms per call at 20 calls per replay; "
                f"bound {bound:.5f} ms ({by}): {each / bound:.1f}x the bound "
                f"by 20-call replay")
            res[fname] = {"ms": one, "ms_20": each, "bound_ms": bound,
                          "bound_by": by}
        return res

    alt_time = {}
    for tag, (f1, pyr, c) in alt_cases.items():
        lib_err = float((alt_library(f1, pyr, c)
                         - alt_lookup_xla(f1, pyr, c, RADIUS).float()
                         ).abs().max())
        t = timed(lambda: alt_lookup_fused(f1, pyr, c, RADIUS),
                  lambda: alt_lookup_xla(f1, pyr, c, RADIUS),
                  lambda: alt_library(f1, pyr, c), flush)
        t["bound"], t["by"], nbytes, flops = alt_bound(
            f1, pyr, c, f1.element_size(), False)
        alt_time[tag] = t
        log(f"alt {tag} timing: "
            f"{describe(t, 'grid_sample formulation', t['bound'], t['by'])}; "
            f"max |library - plain| {lib_err:.3e}; {nbytes / 1e6:.2f} MB: "
            f"{nbytes / MEM_RATE * 1e3:.5f} ms; {flops / 1e6:.1f} MFLOP at "
            f"the fp32 rate: {flops / FP32_RATE * 1e3:.5f} ms")
        plan = plan_fwd([v.shape[2] for v in pyr], RADIUS, RT_D, f1.dtype)
        log(f"alt {tag} plan_fwd at (1,{RT_ROWS},{RT_W1}): (pixel tile, "
            f"channel chunk, band rows per pass) {plan}")
        fields = {"random": c, "coherent": coherent_centers(
            gen, 1, RT_ROWS, RT_W1).to(dev)}
        t["fields"] = alt_fields(
            f"alt {tag} (1,{RT_ROWS},{RT_W1}) D {RT_D}",
            lambda c_: alt_lookup_fused(f1, pyr, c_, RADIUS), f1, pyr,
            fields, f1.element_size())
    # #6 at the realtime training step's shape (22 launches per step).
    tb_, th_, tw_ = TRAIN_B, TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    f1 = torch.randn((tb_, th_, tw_, RT_D), generator=gen).to(
        dev, torch.bfloat16)
    pyr = [torch.randn((tb_, th_, tw_, RT_D), generator=gen).to(
        dev, torch.bfloat16)]
    for _ in range(LEVELS - 1):
        pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
    fields = {"random": (torch.rand((tb_, th_, tw_), generator=gen)
                         * (tw_ + 20) - 10).to(dev),
              "coherent": coherent_centers(gen, tb_, th_, tw_).to(dev)}
    alt_time["bf16"]["fields"].update({
        f"training {n_}": v_ for n_, v_ in alt_fields(
            f"alt bf16 at the realtime training shape ({tb_},{th_},{tw_}) "
            f"D {RT_D}", lambda c_: alt_lookup_fused(f1, pyr, c_, RADIUS),
            f1, pyr, fields, 2).items()})
    del f1, pyr, fields

    g16_times = {label: gate_timing(label, args, calls)
                 for label, (args, calls) in rt_gate_cases.items()}
    gates_bf16 = per_iteration(
        [(lb, c_) for lb, (_, c_) in rt_gate_cases.items()], g16_times)
    log(f"gates bf16 per realtime iteration: kernel {gates_bf16['ms']:.4f} "
        f"ms, plain {gates_bf16['plain']:.4f}, conv2d {gates_bf16['lib']:.4f}"
        f" ({gates_bf16['lib'] / gates_bf16['ms']:.2f}x), bound "
        f"{gates_bf16['bound']:.5f} ms (bf16 tensor cores)")
    del rt_gate_cases

    src16 = [v.float().reshape(-1, 1, 1, v.shape[-1]) for v in pyr16]

    def lookup16_library():
        return torch.cat([F.grid_sample(s_, g_, mode="bilinear",
                                        padding_mode="zeros",
                                        align_corners=True)
                          for s_, g_ in zip(src16, grids)], dim=-1)

    l16_t = timed(lambda: lookup_pyramid_fused(pyr16, coords, RADIUS),
                  lambda: lookup_pyramid_xla(pyr16, coords, RADIUS),
                  lookup16_library, flush)
    l16_bound = lookup_bytes(coords, w2s, itemsize=2) / MEM_RATE * 1e3
    log("lookup bf16 timing: " + describe(
        l16_t, "grid_sample x4 (fp32 upcast)", l16_bound, "bytes"))
    alone("lookup bf16", lambda: lookup_pyramid_fused(pyr16, coords, RADIUS),
          l16_bound)

    # ------------------------------------------------------------ phase 9
    mark("phase 9")
    rt_cfg = RaftStereoConfig.realtime()
    torch.manual_seed(SEED)
    rt_model = RAFTStereo(rt_cfg)
    rt_state = {n: t.clone() for n, t in rt_model.state_dict().items()}
    rt_runner = InferenceRunner(rt_cfg, rt_model, iters=RT_ITERS,
                                device="cuda")
    if rt_runner.effective_config.corr_fp32:
        raise AssertionError("realtime at 7 iterations must keep bf16 "
                             "correlation")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt_flow, rt_launches, rt_per_pair = capture_pair(
        rt_runner, left, right, ("lookup", "gates", "alt"))
    rt_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"realtime path {MAIN_HW[0]}x{MAIN_HW[1]} (padded 384x1248), iters "
        f"{RT_ITERS}, bf16: launches per pair {rt_per_pair} (from the "
        f"capture; the wrappers' counts {rt_launches}), peak memory "
        f"{rt_peak_gib:.3f} GiB (warm-up and capture)")
    if rt_flow.shape != MAIN_HW or not np.isfinite(rt_flow).all():
        raise AssertionError(f"bad realtime flow: shape {rt_flow.shape}, "
                             f"finite {np.isfinite(rt_flow).all()}")
    if rt_per_pair != {"lookup": 0, "gates": 3 * RT_ITERS, "alt": RT_ITERS}:
        raise AssertionError(f"realtime path kernel launches {rt_per_pair}")
    rt_secs, rt_eager_secs = replay_and_eager_seconds(rt_runner, left, right)
    replays_after_timing["realtime"] = rt_runner.replays
    log(f"realtime path seconds per pair: graph replay median "
        f"{statistics.median(rt_secs):.5f} (runs "
        f"{[round(s, 5) for s in rt_secs]}), eager median "
        f"{statistics.median(rt_eager_secs):.5f} (runs "
        f"{[round(s, 5) for s in rt_eager_secs]}); flow range "
        f"[{rt_flow.min():.2f}, {rt_flow.max():.2f}]")

    deep = InferenceRunner(rt_cfg, rt_state, iters=RT_DEEP_ITERS,
                           device="cuda")
    if not deep.effective_config.corr_fp32:
        raise AssertionError(f"realtime at {RT_DEEP_ITERS} iterations must "
                             "turn corr_fp32 on")
    t0 = time.perf_counter()
    deep_flow, deep_launches, deep_per_pair = capture_pair(
        deep, left, right, ("lookup", "gates", "alt"))
    deep_s = time.perf_counter() - t0
    log(f"realtime path, iters {RT_DEEP_ITERS} (corr_fp32 on: fp32 alt): "
        f"launches per pair {deep_per_pair} (the wrappers' counts "
        f"{deep_launches}), {deep_s:.5f} s (first call: warm-up, capture, "
        f"replay)")
    if deep_flow.shape != MAIN_HW or not np.isfinite(deep_flow).all():
        raise AssertionError("bad realtime flow at corr_fp32")
    if deep_per_pair != {"lookup": 0, "gates": 3 * RT_DEEP_ITERS,
                         "alt": RT_DEEP_ITERS}:
        raise AssertionError(f"deep realtime launches {deep_per_pair}")

    # ----------------------------------------------------------- phase 10
    mark("phase 10")
    on_card = InferenceRunner(rt_cfg, rt_state, iters=2, device="cuda")(
        small, small_r)[0]
    card_fp32_corr = InferenceRunner(
        dataclasses.replace(rt_cfg, corr_fp32=True), rt_state, iters=2,
        device="cuda")(small, small_r)[0]
    on_cpu = InferenceRunner(rt_cfg, rt_state, iters=2, device="cpu")(
        small, small_r)[0]
    spread = np.abs(on_card - card_fp32_corr)
    err = np.abs(on_card - on_cpu)
    rt_ok = (err.max() <= RT_SPREAD_FACTOR * spread.max()
             and err.mean() <= RT_SPREAD_FACTOR * spread.mean())
    log(f"realtime card vs CPU, 128x256, iters 2: max / mean |Δflow| = "
        f"{err.max():.4e} / {err.mean():.4e} px; the card's bf16 vs fp32 "
        f"correlation spread {spread.max():.4e} / {spread.mean():.4e} px "
        f"(limit {RT_SPREAD_FACTOR}x); flow range [{on_cpu.min():.2f}, "
        f"{on_cpu.max():.2f}]: {'ok' if rt_ok else 'FAILED'}")
    if not rt_ok:
        raise AssertionError("realtime card and CPU disagree")

    # ----------------------------------------------------------- phase 11
    mark("phase 11")
    k = 2 * RADIUS + 1
    tb, th, tw = TRAIN_B, TRAIN_HW[0] // 4, TRAIN_HW[1] // 4
    tw2s = [tw // 2 ** i for i in range(LEVELS)]
    tcoords = (torch.rand((tb, th, tw), generator=gen) * (tw + 20)
               - 10).to(dev)
    tg = torch.randn((tb, th, tw, LEVELS * k), generator=gen).to(dev)
    got = lookup_pyramid_bwd_fused(tg, tcoords, tw2s, RADIUS, torch.float32)
    again = lookup_pyramid_bwd_fused(tg, tcoords, tw2s, RADIUS,
                                     torch.float32)
    torch.cuda.synchronize()
    lookup_bwd_same = all(torch.equal(a, b) for a, b in zip(got, again))
    lookup_bwd_err = max(
        float((a - b).abs().max()) for a, b in zip(
            got, lookup_pyramid_bwd_xla(tg, tcoords, tw2s, RADIUS,
                                        torch.float32)))
    log(f"lookup backward, {tb * th} rows, W1 {tw}, levels {tw2s}: max "
        f"|kernel - plain| = {lookup_bwd_err:.3e} (atol {LOOKUP_BWD_ATOL}); "
        f"a second launch bitwise equal: {lookup_bwd_same}")
    if not lookup_bwd_same:
        raise AssertionError("two launches of the lookup backward differ")
    del got, again
    for i, w2 in enumerate(tw2s):
        args_ = (tg[..., i * k:(i + 1) * k].contiguous(), tcoords / 2 ** i,
                 [w2], RADIUS, torch.float32)
        one, = lookup_pyramid_bwd_fused(*args_)
        torch.cuda.synchronize()
        err = float((one - lookup_pyramid_bwd_xla(*args_)[0]).abs().max())
        log(f"lookup backward, level {i} alone (W2 {w2}, scale 1/{2 ** i}): "
            f"max |kernel - plain| = {err:.3e}")
        lookup_bwd_err = max(lookup_bwd_err, err)
    if not lookup_bwd_err <= LOOKUP_BWD_ATOL:
        raise AssertionError(f"lookup backward disagrees: {lookup_bwd_err}")

    def alt_bwd_case(dtype, b, h, w1, w2, d):
        def feats(w):
            return torch.randn((b, h, w, d), generator=gen).to(dev, dtype)

        f1, pyr = feats(w1), [feats(w2)]
        for _ in range(LEVELS - 1):
            pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
        c = (torch.rand((b, h, w1), generator=gen) * (w2 + 20) - 10).to(dev)
        g = torch.randn((b, h, w1, LEVELS * k), generator=gen).to(dev, dtype)
        return f1, pyr, c, g

    alt_bwd_cases, alt_bwd_err = {}, {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        chunk, tile, tc = plan_bwd(tw // 2, [tw // 2 // 2 ** i
                                             for i in range(LEVELS)],
                                   RADIUS, RT_D, torch.tensor(
                                       [], dtype=dtype).element_size())
        log(f"alt backward {tag} plan at the training row: {chunk} channels "
            f"per block, tile {tile} pixels, "
            f"{'tensor cores' if tc else 'CUDA cores'}")
        worst, worst_abs, ok = 0.0, 0.0, True
        for shape in ((tb, th // 2, tw // 2, tw // 2, RT_D),
                      (1, 3, 37, 43, 64)):
            case = alt_bwd_case(dtype, *shape)
            if shape[0] == tb:
                alt_bwd_cases[tag] = case
            df1, df2 = alt_lookup_bwd_fused(*case, RADIUS)
            torch.cuda.synchronize()
            again = alt_lookup_bwd_fused(*case, RADIUS)
            same = torch.equal(again[0], df1) and all(
                torch.equal(a, b_) for a, b_ in zip(again[1], df2))
            want1, want2 = alt_lookup_bwd_xla(*case, RADIUS)
            for got_, want_ in [(df1, want1)] + list(zip(df2, want2)):
                if got_.dtype != dtype:
                    raise AssertionError(f"alt backward returned {got_.dtype}")
                scale = float(want_.float().abs().max())
                if dtype == torch.float32:
                    err_abs = float((got_ - want_).abs().max())
                    ok_ = err_abs <= ALT_BWD_RTOL * scale
                else:
                    err_abs, ok_ = bf16_ulp_error(got_, want_, BF16_ULPS,
                                                  ALT_BWD_BF16_RTOL * scale)
                worst = max(worst, err_abs / scale)
                worst_abs = max(worst_abs, err_abs)
                ok = ok and ok_ and same
            log(f"alt backward {tag}, (B,H,W1,W2,D) {shape}: worst |kernel - "
                f"plain| / scale = {worst:.3e}; a second launch bitwise "
                f"equal: {same}")
        alt_bwd_err[tag] = worst_abs
        tol = (f"{ALT_BWD_RTOL} of the scale" if tag == "fp32" else
               f"{BF16_ULPS} bf16 ulp + {ALT_BWD_BF16_RTOL} of the scale")
        log(f"alt backward {tag}: worst {worst:.3e} of the scale, "
            f"{worst_abs:.3e} absolute ({tol}): "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"alt backward ({tag}) disagrees: {worst}")

    cin = CH + 256
    ws = (2 / (9 * cin)) ** 0.5

    def leaf(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(
            dev).requires_grad_()

    gargs = (leaf(tb, th, tw, CH), leaf(tb, th, tw, 256), leaf(tb, th, tw, CH),
             leaf(3, 3, cin, 2 * CH, scale=ws), leaf(2 * CH, scale=0.1),
             leaf(3, 3, cin, CH, scale=ws), leaf(CH, scale=0.1))
    gouts = gru_gates_fused(*gargs)
    if any(o.grad_fn is None for o in gouts):
        raise AssertionError("gate outputs carry no grad_fn on the card")
    ggrads = [torch.randn(o.shape, generator=gen).to(dev) for o in gouts]
    got = torch.autograd.grad(gouts, gargs, ggrads)
    want = torch.autograd.grad(_gates_twin(*gargs), gargs, ggrads)
    gates_bwd_err = max(max_rel_err(a, b_) for a, b_ in zip(got, want))
    log(f"gate Function gradients, gru08 ({tb},{th},{tw}) Cin {cin}: max "
        f"|Function - autograd of the twin| / scale = {gates_bwd_err:.3e} "
        f"(rtol {GATES_BWD_RTOL})")
    if not gates_bwd_err <= GATES_BWD_RTOL:
        raise AssertionError(f"gate gradients disagree: {gates_bwd_err}")
    del gargs, gouts, ggrads, got, want

    # ----------------------------------------------------------- phase 12
    mark("phase 12")
    # The library backwards are captured on the stream their forwards ran
    # on (graph_ms).
    lib_stream = torch.cuda.Stream()
    lib_stream.wait_stream(torch.cuda.current_stream())
    n_pix = tb * th * tw
    srcs = [torch.zeros((n_pix, 1, 1, w2), device=dev, requires_grad=True)
            for w2 in tw2s]
    lib_out = []
    with torch.cuda.stream(lib_stream):
        for i, (src, w2) in enumerate(zip(srcs, tw2s)):
            x = tcoords[..., None] / 2 ** i + taps
            gx = (2 * x / (w2 - 1) - 1).reshape(-1, 1, k, 1)
            grid = torch.cat([gx, torch.zeros_like(gx)], dim=-1)
            lib_out.append(F.grid_sample(src, grid, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True))
        lib_out = torch.cat(lib_out, dim=-1)
    torch.cuda.current_stream().wait_stream(lib_stream)
    lib_g = tg.reshape(n_pix, 1, 1, LEVELS * k)

    def lookup_bwd_library():
        return torch.autograd.grad(lib_out, srcs, lib_g, retain_graph=True)

    lib_err = max(float((a.reshape(b_.shape) - b_).abs().max()) for a, b_ in
                  zip(lookup_bwd_library(), lookup_pyramid_bwd_xla(
                      tg, tcoords, tw2s, RADIUS, torch.float32)))
    lbwd_t = timed(lambda: lookup_pyramid_bwd_fused(
        tg, tcoords, tw2s, RADIUS, torch.float32),
        lambda: lookup_pyramid_bwd_xla(tg, tcoords, tw2s, RADIUS,
                                       torch.float32),
        lookup_bwd_library, flush, lib_stream)
    lbwd_bytes = n_pix * (sum(tw2s) * 4 + LEVELS * k * 4 + 4)
    lbwd_bound = lbwd_bytes / MEM_RATE * 1e3
    log(f"lookup backward timing: "
        f"{describe(lbwd_t, 'grid_sample backward x4', lbwd_bound, 'bytes')}"
        f"; max |library - plain| {lib_err:.3e}; {lbwd_bytes / 1e6:.1f} MB")
    # The practical write floor: one memset of the same dV bytes.
    dv_elems = n_pix * sum(tw2s)
    lbwd_t["write_floor_ms"] = graph_ms(
        lambda: torch.zeros(dv_elems, device=dev), flush)
    log(f"lookup backward: torch.zeros of its {dv_elems * 4 / 1e6:.1f} MB of "
        f"dV {lbwd_t['write_floor_ms']:.4f} ms by graph replay, the write "
        f"floor; the kernel {lbwd_t['ms'] / lbwd_t['write_floor_ms']:.2f}x "
        f"it, {lbwd_bound / lbwd_t['ms']:.1%} of the bound; faster than the "
        f"library's backward: {lbwd_t['ms'] < lbwd_t['lib']}")
    del srcs, lib_out

    alt_bwd_time = {}
    for tag, (f1, pyr, c, g) in alt_bwd_cases.items():
        f1l = f1.float().detach().requires_grad_()
        pyrl = [v.float().detach().requires_grad_() for v in pyr]
        lib_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(lib_stream):
            lib_out = alt_library(f1l, pyrl, c)
        torch.cuda.current_stream().wait_stream(lib_stream)

        def alt_bwd_library():
            return torch.autograd.grad(lib_out, [f1l] + pyrl, g.float(),
                                       retain_graph=True)

        t = timed(lambda: alt_lookup_bwd_fused(f1, pyr, c, g, RADIUS),
                  lambda: alt_lookup_bwd_xla(f1, pyr, c, g, RADIUS),
                  alt_bwd_library, flush, lib_stream)
        item = f1.element_size()
        feats = f1.numel() + sum(v.numel() for v in pyr)
        nbytes = 2 * feats * item + g.numel() * item + c.numel() * 4
        bins = window_bins(c, [v.shape[2] for v in pyr])
        flops = 4 * RT_D * bins
        bytes_ms, ops_ms = nbytes / MEM_RATE * 1e3, flops / FP32_RATE * 1e3
        t["bound"] = max(bytes_ms, ops_ms)
        t["by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        alt_bwd_time[tag] = t
        log(f"alt backward {tag} timing: "
            + describe(t, "grid_sample formulation backward", t["bound"],
                       t["by"]) +
            f"; {nbytes / 1e6:.2f} MB: {bytes_ms:.5f} ms; {flops / 1e6:.1f} "
            f"MFLOP at the fp32 rate: {ops_ms:.5f} ms")
        del lib_out

    # ------------------------------------------------------ phases 13, 14
    mark("phases 13, 14")
    counts, zero_counts = training_counts, zero_training_counts

    iters_t = TRAIN_ITERS
    train_launches, train_s, train_peak = drive_training(
        RaftStereoConfig(), "default")
    want = {"lookup": iters_t, "lookup_bwd": iters_t, "gates": 6 * iters_t,
            "alt": 0, "alt_bwd": 0}
    if train_launches != {n: TIMED_STEPS * v for n, v in want.items()}:
        raise AssertionError(f"default training launches {train_launches}")
    log(f"default training: lookup backward kernel share of the step "
        f"~{100 * iters_t * lbwd_t['ms'] / 1e3 / train_s:.1f}% ({iters_t} x "
        f"{lbwd_t['ms']:.4f} ms with L2 flushed)")

    rt_train_launches, rt_train_s, rt_train_peak = drive_training(
        RaftStereoConfig.realtime(), "realtime")
    want = {"lookup": 0, "lookup_bwd": 0, "gates": 6 * iters_t,
            "alt": iters_t, "alt_bwd": iters_t}
    if rt_train_launches != {n: TIMED_STEPS * v for n, v in want.items()}:
        raise AssertionError(f"realtime training launches "
                             f"{rt_train_launches}")
    log(f"realtime training: alt backward kernel share of the step "
        f"~{100 * iters_t * alt_bwd_time['bf16']['ms'] / 1e3 / rt_train_s:.1f}"
        f"%")

    # ----------------------------------------------------------- phase 15
    mark("phase 15")
    small_tc = TrainConfig(batch_size=1, train_iters=2, image_size=(64, 128))
    small_batch = SyntheticStereoLoader(1, (64, 128), seed=SEED).batch(0)
    step_launches = {}
    for what, cfg_ in (("default", RaftStereoConfig()),
                       ("realtime fp32", dataclasses.replace(
                           RaftStereoConfig.realtime(),
                           mixed_precision=False))):
        weights = create_train_state(cfg_, small_tc, "cpu",
                                     seed=SEED).model.state_dict()
        def one_step(dev_, cfg__=cfg_, w=weights):
            st = create_train_state(cfg__, small_tc, dev_, state_dict=w)
            st, m = train_step(st, small_batch, iters=2, loss_gamma=0.9,
                               max_flow=700.0)
            return ({k_: float(v) for k_, v in m.items()},
                    {n: p.grad.detach().cpu() for n, p in
                     st.model.named_parameters()})

        cm, cg = one_step(torch.device("cpu"))
        zero_counts()
        gm, gg = one_step(dev)
        step_launches[what] = counts()
        with torch.backends.cudnn.flags(enabled=False):
            _, native_g = one_step(dev)
        _, plain_g = one_step(dev, dataclasses.replace(cfg_,
                                                       fused_gru="off"))
        ulp_gen = torch.Generator().manual_seed(SEED)
        moved = {n: t * (1 + 2.0 ** -23 * (2 * torch.randint(
                     0, 2, t.shape, generator=ulp_gen) - 1))
                 for n, t in weights.items()}
        _, ulp_g = one_step(dev, w=moved)
        loss_err = abs(gm["loss"] - cm["loss"]) / cm["loss"]
        norm_err = abs(gm["grad_norm"] - cm["grad_norm"]) / cm["grad_norm"]
        gaps = leaf_errs(gg, cg)
        spreads = {"cuDNN vs native convs": leaf_errs(native_g, gg),
                   "gate kernel vs plain gate convs": leaf_errs(plain_g, gg),
                   "weights moved by one ulp": leaf_errs(ulp_g, gg)}
        spread = max(v[0][0] for v in spreads.values())
        leaf_limit = max(STEP_LEAF_RTOL, STEP_SPREAD_FACTOR * spread)
        ok = (loss_err <= STEP_LOSS_RTOL and norm_err <= STEP_NORM_RTOL
              and gaps[0][0] <= leaf_limit)

        def top(errs):
            return ", ".join(f"{n} {e:.2e}" for e, n in errs[:3])

        log(f"card vs CPU, one {what} step, 64x128, iters 2: loss "
            f"{gm['loss']:.6f} vs {cm['loss']:.6f} (rel {loss_err:.2e}, "
            f"limit {STEP_LOSS_RTOL}), grad_norm {gm['grad_norm']:.5f} vs "
            f"{cm['grad_norm']:.5f} (rel {norm_err:.2e}, limit "
            f"{STEP_NORM_RTOL}), largest leaf differences [{top(gaps)}] "
            f"against the card's own spread {spread:.3e} (limit "
            f"{leaf_limit:.3e}); card launches {step_launches[what]}: "
            f"{'ok' if ok else 'FAILED'}")
        for name_, errs in spreads.items():
            log(f"  card spread, {name_}: [{top(errs)}]")
        if not ok:
            raise AssertionError(f"{what} step: card and CPU disagree")
    if step_launches["realtime fp32"]["alt_bwd"] != 2:
        raise AssertionError("the realtime fp32 step must launch the fp32 "
                             "alt backward twice")

    # ----------------------------------------------------------- phase 32
    mark("phase 32")
    remat_launches = phase_remat(small_tc, small_batch, card)

    # ----------------------------------------------------------- phase 16
    mark("phase 16")
    def q_codes(x, q_dtype):
        """Per-tensor dynamic quantization in x's dtype, as the model does:
        (codes, scale)."""
        qmax = 127.0 if q_dtype == torch.int8 else qcore.FP8_QMAX
        sc = qcore.dynamic_scale(x, qmax=qmax)
        if q_dtype == torch.int8:
            return qcore.quantize_symmetric(x, sc), sc
        return qcore.quantize_fp8(x, sc, q_dtype), sc

    def rel_check(got, want, rtol):
        """(max |got - want| / max |want|, whether it is within rtol)."""
        err = max_rel_err(got, want)
        return err, err <= rtol

    q_types = ((torch.int8, "int8"), (torch.float8_e4m3fn, "fp8"))
    lq_cases, lq_err = {}, {}
    for q_dtype, tag in q_types:
        pairs = [q_codes(v, q_dtype) for v in pyramid]
        levels_q = [p_[0] for p_ in pairs]
        scales = torch.stack([p_[1].float() for p_ in pairs])
        lq_cases[tag] = levels_q
        calls = [(levels_q, coords, "all levels")] + [
            ([v], coords / 2 ** i, f"level {i} alone (scale 1/{2 ** i})")
            for i, v in enumerate(levels_q)]
        worst = 0.0
        for lv, cc, what in calls:
            got = lookup_pyramid_fused_q(lv, cc, RADIUS, torch.float32)
            torch.cuda.synchronize()
            want = lookup_pyramid_xla(lv, cc, RADIUS, torch.float32)
            err, ok = rel_check(got, want, LOOKUP_Q_RTOL)
            log(f"lookup {tag} levels, {what}: max |kernel - plain| / scale "
                f"= {err:.3e} (rtol {LOOKUP_Q_RTOL})")
            if got.dtype != torch.float32 or not ok:
                raise AssertionError(f"{tag} lookup kernel disagrees: {err}")
            worst = max(worst, float((got - want).abs().max()))
        # The scaled kernel output against the plain reference of the reg
        # backend (levels dequantized, then sampled); the same check must
        # catch the scale vector left out.
        raw = lookup_pyramid_fused_q(levels_q, coords, RADIUS, torch.float32)
        deq = [q_.float() * sc for q_, sc in zip(levels_q, scales)]
        ref = lookup_pyramid_xla(deq, coords, RADIUS)
        scale_vec = scales.repeat_interleave(2 * RADIUS + 1)
        err_scaled, ok_scaled = rel_check(raw * scale_vec, ref, SCALED_RTOL)
        err_unscaled, ok_unscaled = rel_check(raw, ref, SCALED_RTOL)
        log(f"lookup {tag}: kernel x scale vector vs dequantize-then-sample "
            f"{err_scaled:.3e}; without the scale vector {err_unscaled:.3e} "
            f"(must fail: {'caught' if not ok_unscaled else 'NOT caught'})")
        if not ok_scaled or ok_unscaled:
            raise AssertionError(f"{tag} lookup scale check")
        lq_err[tag] = worst

    def alt_q_case(q_dtype, b, h, w1, w2, d):
        """bf16 features pooled in bf16, each quantized per tensor (the
        model's alt path): (f1 codes, level codes, centers, the levels'
        combined scales s1*s2_l as the model computes them)."""
        f1 = torch.randn((b, h, w1, d), generator=gen).to(dev, torch.bfloat16)
        pyr = [torch.randn((b, h, w2, d), generator=gen).to(
            dev, torch.bfloat16)]
        for _ in range(LEVELS - 1):
            pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
        f1_q, s1 = q_codes(f1, q_dtype)
        pq = [q_codes(v, q_dtype) for v in pyr]
        c = (torch.rand((b, h, w1), generator=gen) * (w2 + 20) - 10).to(dev)
        combined = [(s1 * s2).float() for _, s2 in pq]
        return f1_q, [q_ for q_, _ in pq], c, combined

    aq_cases, aq_err = {}, {}
    for q_dtype, tag in q_types:
        rtol = ALT_Q_RTOL[tag]
        worst_abs = 0.0
        for shape in ((1, RT_ROWS, RT_W1, RT_W1, RT_D), (1, 3, 37, 43, 64)):
            f1_q, pq, c, combined = alt_q_case(q_dtype, *shape)
            if shape[1] == RT_ROWS:
                aq_cases[tag] = (f1_q, pq, c)
            calls = [(pq, c, "all levels")] + [
                ([v], c / 2 ** i, f"level {i} alone")
                for i, v in enumerate(pq)]
            for lv, cc, what in calls:
                got = alt_lookup_fused_q(f1_q, lv, cc, RADIUS, torch.float32)
                torch.cuda.synchronize()
                want = alt_lookup_xla(f1_q, lv, cc, RADIUS, torch.float32)
                err, ok = rel_check(got, want, rtol)
                log(f"alt {tag}, (B,H,W1,W2,D) {shape}, {what}: max |kernel "
                    f"- plain| / scale = {err:.3e} (rtol {rtol})")
                if got.dtype != torch.float32 or not ok:
                    raise AssertionError(f"{tag} alt kernel disagrees: {err}")
                worst_abs = max(worst_abs, float((got - want).abs().max()))
            # Dequantized features, level by level (left codes times the
            # level's combined scale), against the scaled kernel output.
            raw = alt_lookup_fused_q(f1_q, pq, c, RADIUS, torch.float32)
            ref = torch.cat([alt_lookup_xla(f1_q.float() * sc, [v], c / 2 ** i,
                                            RADIUS)
                             for i, (v, sc) in enumerate(zip(pq, combined))],
                            dim=-1)
            vec = torch.stack(combined).repeat_interleave(2 * RADIUS + 1)
            err_scaled, ok_scaled = rel_check(raw * vec, ref, SCALED_RTOL)
            err_unscaled, ok_unscaled = rel_check(raw, ref, SCALED_RTOL)
            log(f"alt {tag} {shape}: kernel x scale vector vs the dequantized "
                f"features {err_scaled:.3e}; without the scale vector "
                f"{err_unscaled:.3e} (must fail: "
                f"{'caught' if not ok_unscaled else 'NOT caught'})")
            if not ok_scaled or ok_unscaled:
                raise AssertionError(f"{tag} alt scale check")
        aq_err[tag] = worst_abs

    gemm_cases = [("realtime cnet conv1 7x7/2", (2, 3) + PADDED_HW, 64, 7,
                   2), ("conv2_out 3x3 128->256", (2, 128, RT_ROWS, RT_W1),
                        256, 3, 1)]
    for what, xshape, cout, kk, stride in gemm_cases:
        xq = torch.randint(-127, 128, xshape, generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, xshape[1], kk, kk),
                           generator=gen, dtype=torch.int8)
        got = int8_conv_int32(xq.to(dev), wq.to(dev), stride, kk // 2)
        torch.cuda.synchronize()
        want = int8_conv_int32(xq, wq, stride, kk // 2)
        same = torch.equal(got.cpu(), want)
        log(f"int8 GEMM conv, {what}, x {tuple(xshape)}: int32 accumulator "
            f"bit-equal to the exact CPU conv: {same}")
        if not same:
            raise AssertionError(f"int8 GEMM conv disagrees ({what})")

    # ----------------------------------------------------------- phase 17
    mark("phase 17")
    lq_time = {}
    for tag, levels_q in lq_cases.items():
        lsrc = [v.reshape(-1, 1, 1, v.shape[-1]) for v in levels_q]

        def lookup_q_library(src=lsrc):
            return torch.cat([F.grid_sample(s_.float(), g_, mode="bilinear",
                                            padding_mode="zeros",
                                            align_corners=True)
                              for s_, g_ in zip(src, grids)], dim=-1)

        t = timed(lambda: lookup_pyramid_fused_q(
            levels_q, coords, RADIUS, torch.float32),
            lambda: lookup_pyramid_xla(levels_q, coords, RADIUS,
                                       torch.float32),
            lookup_q_library, flush)
        k_out = LEVELS * (2 * RADIUS + 1)
        nbytes = (window_bins(coords, w2s) + coords.numel() * 4
                  + coords.numel() * k_out * 4)
        t["bound"], t["by"] = nbytes / MEM_RATE * 1e3, "bytes"
        lq_time[tag] = t
        log(f"lookup {tag} timing: "
            + describe(t, "grid_sample x4 (fp32 upcast)", t["bound"],
                       "bytes") +
            f"; {nbytes / 1e6:.2f} MB")
        alone(f"lookup {tag}", lambda: lookup_pyramid_fused_q(
            levels_q, coords, RADIUS, torch.float32), t["bound"])
    aq_time = {}
    for tag, (f1_q, pq, c) in aq_cases.items():
        t = timed(lambda: alt_lookup_fused_q(f1_q, pq, c, RADIUS,
                                             torch.float32),
                  lambda: alt_lookup_xla(f1_q, pq, c, RADIUS, torch.float32),
                  lambda: alt_library(f1_q, pq, c), flush)
        t["bound"], t["by"], nbytes, ops = alt_bound(f1_q, pq, c, 4, True)
        aq_time[tag] = t
        log(f"alt {tag} timing: "
            + describe(t, "grid_sample formulation (fp32 upcast)",
                       t["bound"], t["by"]) +
            f"; {nbytes / 1e6:.2f} MB: {nbytes / MEM_RATE * 1e3:.5f} ms; "
            f"{ops / 1e6:.1f} M operations at the int8/fp8 tensor rate: "
            f"{ops / INT8_RATE * 1e3:.6f} ms")
        fields = {"random": c, "coherent": coherent_centers(
            gen, 1, RT_ROWS, RT_W1).to(dev)}
        t["fields"] = alt_fields(
            f"alt {tag} (1,{RT_ROWS},{RT_W1}) D {RT_D}",
            lambda c_: alt_lookup_fused_q(f1_q, pq, c_, RADIUS,
                                          torch.float32),
            f1_q, pq, fields, 4, quantized=True)

    # ------------------------------------------------------ phases 18, 19
    mark("phases 18, 19")
    def drive_quant(what, cfg_, state_, iters, quant, want, **kw):
        """The runner on the 375x1242 pair: the first pair with the counts
        zeroed before it and read after it (warm-up and capture; the
        per-pair counts are the capture's), then 5 timed replays beside
        5 eager calls.  Returns (counts, median replay seconds, peak
        GiB), the peak being the first call's own: device memory
        allocated above what was allocated before it (earlier phases
        leave tensors alive)."""
        runner_ = InferenceRunner(cfg_, state_, iters=iters, device="cuda",
                                  quant=quant, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        flow_, got, per_pair = capture_pair(runner_, left, right,
                                            tuple(want))
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        secs_, eager_ = replay_and_eager_seconds(runner_, left, right)
        log(f"{what}, {MAIN_HW[0]}x{MAIN_HW[1]} (padded 384x1248), iters "
            f"{iters}: launches per pair {per_pair} (the wrappers' counts "
            f"{got}); seconds per pair, graph replay median "
            f"{statistics.median(secs_):.5f} (runs "
            f"{[round(t, 5) for t in secs_]}), eager median "
            f"{statistics.median(eager_):.5f}; peak memory {peak:.3f} GiB; "
            f"flow range [{flow_.min():.2f}, {flow_.max():.2f}]")
        if flow_.shape != MAIN_HW or not np.isfinite(flow_).all():
            raise AssertionError(f"{what}: bad flow")
        if per_pair != want:
            raise AssertionError(f"{what}: launches {per_pair}, want {want}")
        if runner_.captures != 1 or runner_.replays != 6:
            raise AssertionError(f"{what}: {runner_.captures} captures, "
                                 f"{runner_.replays} replays")
        return got, statistics.median(secs_), peak

    n_enc = sum(1 for m_ in RAFTStereo(dataclasses.replace(
        rt_cfg, quant="int8_mxu")).modules()
        if isinstance(m_, Conv2d) and m_.quant == "int8_mxu")
    log(f"realtime int8_mxu: {n_enc} encoder convs run the int8 GEMM, once "
        f"per pair each")
    want_rt = {"lookup": 0, "lookup_q": 0, "alt": 0, "alt_q": RT_ITERS,
               "gates": 3 * RT_ITERS, "gemm": n_enc}
    quant_runs = {}
    quant_runs["rt bf16"] = drive_quant(
        "realtime bf16, unquantized (for comparison)", rt_cfg, rt_state,
        RT_ITERS, "off", dict(want_rt, alt=RT_ITERS, alt_q=0, gemm=0))
    quant_runs["rt int8"] = drive_quant(
        "realtime int8_mxu (int8 features)", rt_cfg, rt_state, RT_ITERS,
        "int8_mxu", want_rt)
    t0 = time.perf_counter()
    rt_record = calibrate(rt_cfg, rt_state, [(left, right)], device="cuda")
    act_scales = conv_input_scales(rt_record)
    log(f"calibrate() of the realtime preset on the seeded pair: "
        f"{time.perf_counter() - t0:.1f} s, {len(rt_record['activations'])} "
        f"sites, {len(act_scales)} conv input scales")
    quant_runs["rt calibrated"] = drive_quant(
        "realtime int8_mxu, calibrated input scales", rt_cfg, rt_state,
        RT_ITERS, "int8_mxu", want_rt, quant_act_scales=act_scales)
    quant_runs["rt fp8"] = drive_quant(
        "realtime int8_mxu (fp8 features)",
        dataclasses.replace(rt_cfg, quant_corr_fp8=True), rt_state, RT_ITERS,
        "int8_mxu", want_rt)

    want_def = {"lookup": 0, "lookup_q": MAIN_ITERS, "alt": 0, "alt_q": 0,
                "gates": 3 * MAIN_ITERS, "gemm": 0}
    quant_runs["def fp32"] = drive_quant(
        "default fp32, unquantized (for comparison)", cfg, state,
        MAIN_ITERS, "off", dict(want_def, lookup=MAIN_ITERS, lookup_q=0))
    quant_runs["def int8"] = drive_quant(
        "default int8 (int8 pyramid)", cfg, state, MAIN_ITERS, "int8",
        want_def)
    t0 = time.perf_counter()
    def_scales = corr_scales(calibrate(cfg, state, [(left, right)],
                                       device="cuda"))
    log(f"calibrate() of the default config on the seeded pair: "
        f"{time.perf_counter() - t0:.1f} s; quant_corr_scales "
        f"{[round(x_, 6) for x_ in def_scales]}")
    quant_runs["def calibrated"] = drive_quant(
        "default int8, calibrated pyramid scales",
        dataclasses.replace(cfg, quant_corr_scales=def_scales), state,
        MAIN_ITERS, "int8", want_def)
    quant_runs["def fp8"] = drive_quant(
        "default int8 (fp8 pyramid)",
        dataclasses.replace(cfg, quant_corr_fp8=True), state, MAIN_ITERS,
        "int8", want_def)

    # ----------------------------------------------------------- phase 20
    mark("phase 20")
    captured = []
    real_make_corr_fn = raft_module.make_corr_fn

    def capturing_make_corr_fn(*args):
        # The card's codes come from the runner's eager warm-up forward
        # (a replay equals it bit for bit, phase 21): a capture may not
        # copy to the host.
        fn = real_make_corr_fn(*args)
        if not torch.cuda.is_current_stream_capturing():
            captured.append([c_.float().cpu() for c_ in fn.codes])
        return fn

    raft_module.make_corr_fn = capturing_make_corr_fn
    ulp_gen = torch.Generator().manual_seed(SEED)
    variants = (("realtime int8_mxu int8", rt_cfg, rt_state, "int8_mxu"),
                ("realtime int8_mxu fp8", dataclasses.replace(
                    rt_cfg, quant_corr_fp8=True), rt_state, "int8_mxu"),
                ("default int8 int8", cfg, state, "int8"),
                ("default int8 fp8", dataclasses.replace(
                    cfg, quant_corr_fp8=True), state, "int8"))
    try:
        for what, cfg_, state_, quant in variants:
            moved = {n_: t_ * (1 + 2.0 ** -23 * (2 * torch.randint(
                0, 2, t_.shape, generator=ulp_gen) - 1))
                for n_, t_ in state_.items()}
            captured.clear()
            on_card = InferenceRunner(cfg_, state_, iters=2, device="cuda",
                                      quant=quant)(small, small_r)[0]
            on_cpu = InferenceRunner(cfg_, state_, iters=2, device="cpu",
                                     quant=quant)(small, small_r)[0]
            card_codes, cpu_codes = captured
            ulp = InferenceRunner(cfg_, moved, iters=2, device="cuda",
                                  quant=quant)(small, small_r)[0]
            flipped = sum(int((a_ != b_).sum())
                          for a_, b_ in zip(card_codes, cpu_codes))
            total = sum(a_.numel() for a_ in card_codes)
            spread, err = np.abs(ulp - on_card), np.abs(on_card - on_cpu)
            ok = (err.max() <= Q_SPREAD_FACTOR * spread.max()
                  and err.mean() <= Q_SPREAD_FACTOR * spread.mean()
                  and np.isfinite(on_card).all())
            log(f"card vs CPU, {what}, 128x256, iters 2: max / mean |Δflow| "
                f"= {err.max():.4e} / {err.mean():.4e} px; the card's spread "
                f"(weights moved by one fp32 ulp) {spread.max():.4e} / "
                f"{spread.mean():.4e} px (limit {Q_SPREAD_FACTOR}x); "
                f"correlation codes flipped card vs CPU {flipped} of {total} "
                f"({100 * flipped / total:.4f}%); flow range "
                f"[{on_cpu.min():.2f}, {on_cpu.max():.2f}]: "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"{what}: card and CPU disagree")
    finally:
        raft_module.make_corr_fn = real_make_corr_fn

    # ----------------------------------------------------------- phase 21
    mark("phase 21")
    for what, r_, cfg_, state_, secs_, eager_ in (
            ("default", runner, cfg, state, secs, eager_secs),
            ("realtime", rt_runner, rt_cfg, rt_state, rt_secs,
             rt_eager_secs)):
        graph = r_._compiled[(PADDED_HW, 1)]
        one = r_(left, right)[0]
        two = r_(left, right)[0]
        eager_flow = eager_call(r_, left, right)[0]
        half = InferenceRunner(cfg_, state_, iters=r_.iters, device="cuda",
                               fetch_dtype="fp16")(left, right)[0]
        rounded = torch.from_numpy(one).half().float().numpy()
        ok = (r_.captures == 1 and replays_after_timing[what] == 6
              and np.array_equal(one, two)
              and np.array_equal(one, eager_flow)
              and np.array_equal(half, rounded))
        log(f"graphs, {what} path at {MAIN_HW[0]}x{MAIN_HW[1]}, iters "
            f"{r_.iters}: captures {r_.captures}, replays "
            f"{replays_after_timing[what]} after the 5 timed calls; launches "
            f"per pair from the capture {graph.launches}; capture (warm-up "
            f"forward and capture) {1e3 * graph.capture_s:.1f} ms; seconds "
            f"per pair, replay median {statistics.median(secs_):.5f} "
            f"against eager {statistics.median(eager_):.5f} "
            f"({statistics.median(eager_) / statistics.median(secs_):.2f}x);"
            f" replay bitwise equal to eager "
            f"{np.array_equal(one, eager_flow)} (max |d| "
            f"{np.abs(one - eager_flow).max():.3e}), two replays "
            f"{np.array_equal(one, two)}, fp16 fetch equal to the fp32 "
            f"result rounded {np.array_equal(half, rounded)}: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{what}: graph checks failed")
    log(f"graphs, memory after phase 21: allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB; the first "
        f"default call's peak {peak_gib:.2f} GiB, realtime "
        f"{rt_peak_gib:.3f} GiB")

    # ----------------------------------------------------------- phase 22
    mark("phase 22")
    captures = runner.captures
    for hw in KITTI_SHAPES:
        l_ = rs.integers(0, 256, hw + (3,), dtype=np.uint8)
        f_ = runner(l_, np.roll(l_, -4, axis=1))[0]
        if f_.shape != hw or not np.isfinite(f_).all():
            raise AssertionError(f"bad flow at {hw}")
    log(f"cache: raw shapes {KITTI_SHAPES} ran on "
        f"{runner.captures - captures} new captures; entries "
        f"{list(runner._compiled)}")
    if runner.captures != captures:
        raise AssertionError("the raw KITTI shapes must share one graph")
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    cache_runner = InferenceRunner(cfg, state, iters=MAIN_ITERS,
                                   device="cuda", max_cached_shapes=2)
    pairs = {}
    for key, hw in CACHE_SHAPES.items():
        l_ = rs.integers(0, 256, hw + (3,), dtype=np.uint8)
        pairs[key] = (l_, np.roll(l_, -4, axis=1))
    outs, held = {}, []
    for key in CACHE_ORDER:
        outs.setdefault(key, []).append(cache_runner(*pairs[key])[0])
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_reserved() - base)
        log(f"cache (max_cached_shapes=2): shape {key} "
            f"{CACHE_SHAPES[key]}: entries {list(cache_runner._compiled)}, "
            f"captures {cache_runner.captures}, memory reserved above the "
            f"phase's start {held[-1] / 2 ** 30:.3f} GiB, allocated "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    b_eager = eager_call(cache_runner, *pairs["B"])[0]
    ok = (cache_runner.captures == 4 and len(cache_runner._compiled) == 2
          and np.array_equal(outs["A"][0], outs["A"][1])
          and np.array_equal(outs["B"][0], b_eager)
          and np.array_equal(outs["B"][0], outs["B"][1])
          and max(held[3:]) <= CACHE_MEMORY_FACTOR * held[1])
    log(f"cache: order {CACHE_ORDER}, {cache_runner.captures} captures; A "
        f"replayed after B bitwise equal {np.array_equal(*outs['A'])}; B "
        f"equal to its eager forward {np.array_equal(outs['B'][0], b_eager)}"
        f", B recaptured after its eviction equal "
        f"{np.array_equal(*outs['B'])}; reserved memory after the "
        f"evictions at most {max(held[3:]) / max(held[1], 1):.3f}x its "
        f"value after the second shape (limit {CACHE_MEMORY_FACTOR}x): "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("graph cache checks failed")
    del cache_runner, outs

    b_runner = InferenceRunner(cfg, state, iters=2, device="cuda")
    smalls = [rs.integers(0, 256, (128, 256, 3), dtype=np.uint8)
              for _ in range(BATCH)]
    small_rs = [np.roll(x_, -4, axis=1) for x_ in smalls]
    flows4 = b_runner.run_batch(smalls, small_rs)[0]
    err = max(float(np.abs(flows4[i] - b_runner(smalls[i], small_rs[i])[0]
                            ).max()) for i in range(BATCH))
    log(f"run_batch({BATCH}) against {BATCH} single calls, 128x256, iters "
        f"2: max |Δflow| {err:.3e} px (atol {CARD_VS_CPU_ATOL})")
    if not err <= CARD_VS_CPU_ATOL:
        raise AssertionError("run_batch and single calls disagree")
    lefts = [rs.integers(0, 256, MAIN_HW + (3,), dtype=np.uint8)
             for _ in range(BATCH)]
    rights = [np.roll(x_, -4, axis=1) for x_ in lefts]
    runner.run_batch(lefts, rights)                        # capture
    batch_secs = [runner.run_batch(lefts, rights)[1] / BATCH
                  for _ in range(5)]
    log(f"run_batch({BATCH}) at {MAIN_HW[0]}x{MAIN_HW[1]}, default, iters "
        f"{MAIN_ITERS}: seconds per pair median "
        f"{statistics.median(batch_secs):.4f} (runs "
        f"{[round(t, 4) for t in batch_secs]}) against batch 1's "
        f"{statistics.median(secs):.4f}; reserved memory "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")

    # ----------------------------------------------------------- phase 23
    mark("phase 23")
    from raft_stereo_tpu_torch.cli import evaluate
    from raft_stereo_tpu_torch.eval.runner import launch_counts
    from raft_stereo_tpu_torch.eval.validate import WARMUP_IMAGES
    from raft_stereo_tpu_torch.io.jax_weights import save_checkpoint

    tree = os.path.join(HERE, "_smoke_data")
    shutil.rmtree(tree, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        write_kitti_tree(os.path.join(tree, "KITTI"), KITTI_PAIRS, SEED)
        save_checkpoint(os.path.join(tree, "ckpt"), cfg, state)
        log(f"evaluate: a KITTI-shaped tree of {KITTI_PAIRS} pairs in the "
            f"raw shapes {KITTI_SHAPES}, written in "
            f"{time.perf_counter() - t0:.1f} s")
        zero_inference_counts()
        t0 = time.perf_counter()
        result = evaluate.main(
            ["--restore_ckpt", os.path.join(tree, "ckpt"), "--dataset",
             "kitti", "--data_root", tree, "--valid_iters",
             str(MAIN_ITERS)])
        eval_s = time.perf_counter() - t0
        eval_launches = {k: v for k, v in launch_counts().items() if v}
    finally:
        shutil.rmtree(tree, ignore_errors=True)
    ok = (eval_launches == {"lookup": 2 * MAIN_ITERS,
                            "gates": 2 * 3 * MAIN_ITERS}
          and math.isfinite(result["kitti-epe"])
          and math.isfinite(result["kitti-d1"]) and "kitti-fps" in result)
    log(f"evaluate (cli/evaluate.py main, --dataset kitti, default config, "
        f"iters {MAIN_ITERS}, seeded random weights): {result}; "
        f"{eval_s:.1f} s for the tree; the wrappers' counts {eval_launches}"
        f" (one warm-up and one capture for the whole tree); "
        f"{result.get('kitti-fps', float('nan')):.3f} pairs per second "
        f"past the {WARMUP_IMAGES}-image warm-up on {card}: "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("the evaluate path failed its checks")

    # ------------------------------------------------------- phases 24, 25
    mark("phases 24, 25")
    import signal

    from raft_stereo_tpu_torch.cli import train as train_cli
    from raft_stereo_tpu_torch.data.datasets import build_training_mixture
    from raft_stereo_tpu_torch.data.device_jitter import (apply_photometric,
                                                          draw_factors,
                                                          params_for_datasets)
    from raft_stereo_tpu_torch.data.frame_utils import read_image
    from raft_stereo_tpu_torch.data.loader import StereoLoader
    from raft_stereo_tpu_torch.eval import validate as validate_mod
    from raft_stereo_tpu_torch.io.jax_weights import load_checkpoint
    from raft_stereo_tpu_torch.training import checkpoint as ckpt
    from raft_stereo_tpu_torch.training import train_loop as loop_mod
    from raft_stereo_tpu_torch.training.anomaly import TrainingDiverged

    def step_counts(snaps, extra):
        """Per-step launch counts from the counts at each step's end,
        less ``extra[i]`` (launches between steps i and i+1)."""
        out, prev = [], {k_: 0 for k_ in counts()}
        for i, snap in enumerate(snaps):
            out.append({k_: snap[k_] - prev[k_] - extra.get(i, {}).get(k_, 0)
                        for k_ in snap})
            prev = snap
        return out

    tree = os.path.join(HERE, "_smoke_data")
    shutil.rmtree(tree, ignore_errors=True)
    real_train = loop_mod.train
    real_make_val = validate_mod.make_validation_fn
    real_runner = validate_mod.InferenceRunner
    real_make_step = loop_mod.make_train_step
    try:
        t0 = time.perf_counter()
        write_sceneflow_tree(tree, SF_TRAIN_PAIRS, SF_TEST_PAIRS, SEED)
        log(f"training entry point: a SceneFlow-shaped tree of "
            f"{SF_TRAIN_PAIRS} TRAIN pairs (clean and final pass) and "
            f"{SF_TEST_PAIRS} TEST pairs at {SF_HW[0]}x{SF_HW[1]}, written "
            f"in {time.perf_counter() - t0:.1f} s")

        # ---------------------------------------------------- phase 24
        mark("phase 24")
        snaps, marks, seen, val_runs, runners = [], [], [], [], []

        def on_step(step, metrics):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            snaps.append(counts())
            seen.append({k_: float(v) for k_, v in metrics.items()})

        def counted_train(*a, **kw):
            return real_train(*a, on_step=on_step, **kw)

        def counted_validation(*a, **kw):
            fn = real_make_val(*a, **kw)

            def run(sd, cfg_=None):
                before, t = counts(), time.perf_counter()
                out = fn(sd, cfg_)
                val_runs.append((time.perf_counter() - t,
                                 {k_: v - before[k_]
                                  for k_, v in counts().items()}, out))
                return out
            return run

        class CountedRunner(real_runner):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                runners.append(self)

        loop_mod.train = counted_train
        validate_mod.make_validation_fn = counted_validation
        validate_mod.InferenceRunner = CountedRunner
        ck_dir = os.path.join(tree, "checkpoints")
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        marks.append(time.perf_counter())
        cli_state = train_cli.main(
            ["--data_root", tree, "--checkpoint_dir", ck_dir, "--log_dir",
             os.path.join(tree, "runs"), "--batch_size", str(TRAIN_B),
             "--image_size", str(TRAIN_HW[0]), str(TRAIN_HW[1]),
             "--train_iters", str(TRAIN_ITERS), "--num_steps",
             str(CLI_STEPS), "--validation_frequency", str(CLI_VAL_EVERY),
             "--validate_datasets", "things", "--validate_max_images",
             str(SF_TEST_PAIRS), "--checkpoint_keep", "1"])
        torch.cuda.synchronize()
        cli_total = time.perf_counter() - marks[0]
        cli_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        loop_mod.train = real_train
        validate_mod.make_validation_fn = real_make_val
        validate_mod.InferenceRunner = real_runner

        per_step = step_counts(snaps, {
            k_ * CLI_VAL_EVERY: val_runs[k_ - 1][1]
            for k_ in range(1, len(val_runs) + 1)})
        want_step = {"lookup": TRAIN_ITERS, "lookup_bwd": TRAIN_ITERS,
                     "gates": 6 * TRAIN_ITERS, "alt": 0, "alt_bwd": 0}
        intervals = [marks[i + 1] - marks[i] for i in range(1, len(marks) - 1)]
        # the interval of the step after a validation boundary also holds
        # the save and the validation
        clean = [t for i, t in enumerate(intervals, start=2)
                 if (i - 1) % CLI_VAL_EVERY]
        start_w = create_train_state(RaftStereoConfig(), TrainConfig(), "cpu",
                                     seed=TrainConfig().seed
                                     ).model.state_dict()
        cli_moved = max(float((p.detach().cpu() - start_w[n]).abs().max())
                        for n, p in cli_state.model.named_parameters())
        left_ck = sorted(e for e in os.listdir(ck_dir)
                         if os.path.isdir(os.path.join(ck_dir, e)))
        manifests = {e: ckpt.verify_manifest(os.path.join(ck_dir, e))
                     for e in left_ck}
        goods = [e for e in left_ck if ckpt.is_good(os.path.join(ck_dir, e))]
        fcfg, fweights = load_checkpoint(os.path.join(ck_dir, "raft-stereo"))
        test_dir = os.path.join(tree, "FlyingThings3D", "frames_finalpass",
                                "TEST", "A", "0000")
        flow_f, _ = InferenceRunner(fcfg, fweights, iters=MAIN_ITERS,
                                    device="cuda")(
            read_image(os.path.join(test_dir, "left", "0006.png")),
            read_image(os.path.join(test_dir, "right", "0006.png")))
        val_s = [v[0] for v in val_runs]
        val_epe = [v[2].get("things-epe", float("nan")) for v in val_runs]
        ok = (len(per_step) == CLI_STEPS
              and all(c == want_step for c in per_step)
              and all(math.isfinite(m["loss"]) for m in seen)
              and cli_moved > 0
              and len(val_runs) == 2 and len(runners) == 1
              and all(math.isfinite(e) for e in val_epe)
              and left_ck == [f"{CLI_STEPS}_raft-stereo", "raft-stereo"]
              and all(v == (True, "ok") for v in manifests.values())
              and not goods and flow_f.shape == SF_HW
              and bool(np.isfinite(flow_f).all()))
        log(f"training CLI (cli/train.py main, default config fp32, batch "
            f"{TRAIN_B}, {TRAIN_HW[0]}x{TRAIN_HW[1]}, iters {TRAIN_ITERS}, "
            f"{CLI_STEPS} steps over the ported StereoLoader, validation "
            f"every {CLI_VAL_EVERY}): launches per step {per_step}; losses "
            f"{[round(m['loss'], 4) for m in seen]}; largest parameter move "
            f"{cli_moved:.3e}; seconds per step past the first "
            f"{[round(t, 4) for t in intervals]}, median without the "
            f"boundaries {statistics.median(clean):.4f}; the loop's wait "
            f"for each step's batch {[round(m['loader_wait_s'], 4) for m in seen]}"
            f" s; validations {len(val_runs)} on "
            f"{len(runners)} runner(s), EPE {val_epe}, seconds "
            f"{[round(t, 3) for t in val_s]}, launches "
            f"{[v[1] for v in val_runs]}; checkpoints left {left_ck}, "
            f"manifests {manifests}, GOOD {goods}; the final checkpoint's "
            f"flow on a TEST pair finite; {cli_total:.1f} s in all, peak "
            f"memory {cli_peak:.2f} GiB on {card}: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("the training CLI failed its checks")
        p24_step_s = statistics.median(clean)

        # ---------------------------------------------------- phase 25
        mark("phase 25")
        rt_cfg = RaftStereoConfig.realtime()
        rt_tc = dataclasses.replace(
            TrainConfig(), batch_size=TRAIN_B, image_size=TRAIN_HW,
            train_iters=TRAIN_ITERS, num_steps=RESUME_STEPS,
            validation_frequency=3)

        class RecordingLoader(StereoLoader):
            """The hashes of each iteration's batches, before the flow of
            the first iteration's ``poison`` steps is set to NaN."""

            def __init__(self, *a, poison=(), **kw):
                super().__init__(*a, **kw)
                self.poison = poison
                self.iters = []

            def __iter__(self):
                hashes = []
                self.iters.append(hashes)
                first, offset = len(self.iters) == 1, self.start_offset
                for i, b in enumerate(super().__iter__()):
                    hashes.append(batch_sha(b))
                    if first and offset + i + 1 in self.poison:
                        b = dict(b, flow=np.full_like(b["flow"], np.nan))
                    yield b

        def rt_loader(tc, poison=(), **kw):
            return RecordingLoader(build_training_mixture(tc, tree),
                                   batch_size=tc.batch_size, seed=tc.seed,
                                   poison=poison, **kw)

        def rt_run(tc, ld, ck, restore=None, stop_at=None, losses=None,
                   step_marks=None, waits=None):
            def on_step_(step, metrics):
                if step_marks is not None:
                    torch.cuda.synchronize()
                    step_marks.append(time.perf_counter())
                if waits is not None:
                    waits.append(metrics["loader_wait_s"])
                if losses is not None:
                    losses.append({k_: float(v) for k_, v in
                                   metrics.items()})
                if step == stop_at:
                    signal.raise_signal(signal.SIGTERM)
            return train(rt_cfg, tc, name="rt", checkpoint_dir=ck,
                         log_dir=None, loader=ld, device=dev,
                         restore=restore, on_step=on_step_)

        t0 = time.perf_counter()
        ld_a, ld_a2, ld_b1, ld_b2 = (rt_loader(rt_tc) for _ in range(4))
        # the uninterrupted run over the loader's thread workers (its
        # default), and again over its spawned process workers
        rt_marks, rt_waits, rt_pmarks, rt_pwaits = [], [], [], []
        st_a = rt_run(rt_tc, ld_a, os.path.join(tree, "ck_a"),
                      step_marks=rt_marks, waits=rt_waits)
        ld_p = rt_loader(rt_tc, worker_type="process")
        rt_run(rt_tc, ld_p, os.path.join(tree, "ck_p"),
               step_marks=rt_pmarks, waits=rt_pwaits)
        # and over the same batches decoded before the run, so that no
        # decode worker runs beside the steps
        it = iter(rt_loader(rt_tc))
        decoded = [next(it) for _ in range(RESUME_STEPS)]
        it.close()
        rt_dmarks = []
        rt_run(rt_tc, decoded, os.path.join(tree, "ck_d"),
               step_marks=rt_dmarks)

        def past_first(marks_):
            # the step after the step-3 boundary also holds its save
            return [marks_[i] - marks_[i - 1]
                    for i in range(1, len(marks_)) if i != 3]
        rt_steps, rt_psteps, rt_dsteps = (past_first(rt_marks),
                                          past_first(rt_pmarks),
                                          past_first(rt_dmarks))
        st_b = rt_run(rt_tc, ld_b1, os.path.join(tree, "ck_b"), stop_at=3)
        stopped_at = st_b.step
        st_b = rt_run(rt_tc, ld_b2, os.path.join(tree, "ck_b"),
                      restore="latest")
        st_a2 = rt_run(rt_tc, ld_a2, os.path.join(tree, "ck_a2"))
        resume_s = time.perf_counter() - t0
        consumed_a = ld_a.iters[0][:RESUME_STEPS]
        consumed_b = ld_b1.iters[0][:stopped_at] + ld_b2.iters[0][
            :RESUME_STEPS - stopped_at]
        pa = dict(st_a.model.named_parameters())
        diff = max(float((p - pa[n]).abs().max())
                   for n, p in st_b.model.named_parameters())
        spread = max(float((p - pa[n]).abs().max())
                     for n, p in st_a2.model.named_parameters())
        bitwise = diff == 0.0
        ok = (stopped_at == 3 and st_b.step == st_a.step == RESUME_STEPS
              and consumed_a == consumed_b
              and ld_p.iters[0][:RESUME_STEPS] == consumed_a
              and (bitwise or diff <= RESUME_SPREAD_FACTOR * spread))
        log(f"resume (realtime bf16, {RESUME_STEPS} steps; SIGTERM at step "
            f"3, stopped at {stopped_at}, restore='latest'): the batch "
            f"hashes of both runs' loops equal: {consumed_a == consumed_b}; "
            f"final parameters "
            f"{'bit-equal' if bitwise else 'not bit-equal'}: max |diff| "
            f"{diff:.3e} against {RESUME_SPREAD_FACTOR} x the card's own "
            f"spread between two uninterrupted runs ({spread:.3e}); "
            f"{resume_s:.1f} s for the six runs; the uninterrupted run "
            f"over the ported StereoLoader's 4 thread workers: seconds per "
            f"step past the first {[round(t, 4) for t in rt_steps]} (median "
            f"{statistics.median(rt_steps):.4f}, the boundary step left "
            f"out), the loop's wait for each step's batch "
            f"{[round(w, 4) for w in rt_waits]} s; over 4 process workers "
            f"(batch hashes equal: "
            f"{ld_p.iters[0][:RESUME_STEPS] == consumed_a}): seconds per "
            f"step {[round(t, 4) for t in rt_psteps]} (median "
            f"{statistics.median(rt_psteps):.4f}), waits "
            f"{[round(w, 4) for w in rt_pwaits]} s; over the same batches "
            f"decoded before the run: seconds per step "
            f"{[round(t, 4) for t in rt_dsteps]} (median "
            f"{statistics.median(rt_dsteps):.4f}) on {card}: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("the resume check failed")

        snapshots = {}

        def recording_make_step(tc, anomaly=None):
            fn = real_make_step(tc, anomaly=anomaly)

            def step_(state, batch, ewma):
                state, metrics, ewma = fn(state, batch, ewma)
                if state.step not in snapshots:
                    opt_state = state.optimizer.state
                    snapshots[state.step] = (
                        [p.detach().clone() for p in state.model.parameters()]
                        + [t.clone() for p in state.model.parameters()
                           for t in (opt_state[p]["exp_avg"],
                                     opt_state[p]["exp_avg_sq"],
                                     opt_state[p]["step"])]
                        + [state.count.clone(), ewma.clone()])
                return state, metrics, ewma
            return step_

        an_tc = dataclasses.replace(
            rt_tc, num_steps=ANOMALY_STEPS, validation_frequency=2,
            anomaly_policy=True, anomaly_rewind_after=3)
        ld_an = rt_loader(an_tc, poison=ANOMALY_POISON)
        an_seen = []
        loop_mod.make_train_step = recording_make_step
        try:
            t0 = time.perf_counter()
            st_an = rt_run(an_tc, ld_an, os.path.join(tree, "ck_an"),
                           losses=an_seen)
            an_s = time.perf_counter() - t0
        finally:
            loop_mod.make_train_step = real_make_step
        base = snapshots[3]
        kept = {s_: all(torch.equal(a_, b_) for a_, b_ in
                        zip(snapshots[s_], base)) for s_ in ANOMALY_POISON}
        skipped = [int(m["skipped"]) for m in an_seen]
        history = ckpt.load_runtime_state(
            os.path.join(tree, "ck_an", "rt"))["anomaly"]
        rewinds = [r for r in history["recent"] if r["kind"] == "rewind"]
        target = os.path.join(tree, "ck_an", "4_rt")
        after_rewind = ld_an.iters[1][0] if len(ld_an.iters) > 1 else None
        ok = (all(kept.values())
              and skipped == [0, 0, 0, 1, 1, 1] + [0] * (ANOMALY_STEPS - 4)
              and history["rewinds"] == 1 and len(rewinds) == 1
              and rewinds[0]["step"] == 6 and rewinds[0]["to_step"] == 4
              and rewinds[0]["checkpoint"] == target and ckpt.is_good(target)
              and after_rewind is not None
              and after_rewind != ld_a.iters[0][4]
              and st_an.step == ANOMALY_STEPS
              and all(bool(torch.isfinite(p).all())
                      for p in st_an.model.parameters()))
        diverged = None
        try:
            rt_run(dataclasses.replace(an_tc, anomaly_max_rewinds=0),
                   rt_loader(an_tc, poison=ANOMALY_POISON),
                   os.path.join(tree, "ck_div"))
        except TrainingDiverged as e:
            diverged = e
        ok = ok and diverged is not None and diverged.step == 6
        log(f"anomaly policy (realtime, {ANOMALY_STEPS} steps, NaN flow in "
            f"the batches of steps {ANOMALY_POISON}): skipped flags "
            f"{skipped}; every leaf after steps 4-6 bit-equal to step 3's: "
            f"{kept}; rewinds {rewinds} (to the GOOD-stamped "
            f"{os.path.basename(target)}: {ckpt.is_good(target)}); the "
            f"first batch after the rewind differs from the uninterrupted "
            f"order's: {after_rewind != ld_a.iters[0][4]}; finished at step "
            f"{st_an.step} in {an_s:.1f} s; with max_rewinds 0: "
            f"{diverged!r} on {card}: {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("the anomaly policy failed its checks")

        jp = params_for_datasets(("sceneflow",))
        jbatch = next(iter(StereoLoader(build_training_mixture(rt_tc, tree),
                                        batch_size=TRAIN_B, num_workers=0,
                                        seed=SEED)))
        f_card = draw_factors(SEED, torch.full((), 5, device=dev), TRAIN_B,
                              jp)
        f_cpu = draw_factors(SEED, torch.tensor(5), TRAIN_B, jp)
        same_draws = all(torch.equal(f_card[k_].cpu(), f_cpu[k_])
                         for k_ in f_cpu)
        j_card = apply_photometric(
            torch.from_numpy(jbatch["image1"]).to(dev),
            torch.from_numpy(jbatch["image2"]).to(dev), f_card)
        j_cpu = apply_photometric(torch.from_numpy(jbatch["image1"]),
                                  torch.from_numpy(jbatch["image2"]), f_cpu)
        jitter_err = max(float((a_.cpu() - b_).abs().max())
                         for a_, b_ in zip(j_card, j_cpu))
        j_tc = dataclasses.replace(rt_tc, num_steps=2,
                                   device_photometric=True)
        j_seen = []
        rt_run(j_tc, rt_loader(j_tc), None, losses=j_seen)
        ok = (same_draws and jitter_err <= JITTER_ATOL and len(j_seen) == 2
              and all(math.isfinite(m["loss"]) for m in j_seen))
        log(f"device jitter: the card's factor draws equal the CPU's: "
            f"{same_draws}; apply_photometric on a batch of {TRAIN_B} at "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, card vs CPU max |diff| "
            f"{jitter_err:.3e} (tolerance {JITTER_ATOL:.4f}); two "
            f"device_photometric steps, losses "
            f"{[round(m['loss'], 4) for m in j_seen]}: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("the device jitter failed its checks")

        # ---------------------------------------------------- phase 29
        mark("phase 29")
        phase_telemetry(tree, p24_step_s, want_step, counts, zero_counts,
                        cfg, state, left, right, card)

        # ---------------------------------------------------- phase 33
        mark("phase 33")
        loader_launches, _ = phase_loader(
            tree, lambda tc: StereoLoader(build_training_mixture(tc, tree),
                                          batch_size=tc.batch_size,
                                          seed=tc.seed),
            rt_run, rt_tc, counts, zero_counts, card)
    finally:
        loop_mod.train = real_train
        validate_mod.make_validation_fn = real_make_val
        validate_mod.InferenceRunner = real_runner
        loop_mod.make_train_step = real_make_step
        shutil.rmtree(tree, ignore_errors=True)

    # ------------------------------------------------- phases 26, 27, 28
    mark("phases 26, 27, 28")
    pred_t = predicate_row(card)
    exit_runs = {}
    for what, cfg_, state_, cap in (("default", cfg, state, MAIN_ITERS),
                                    ("realtime", rt_cfg, rt_state,
                                     RT_ITERS)):
        exit_runs[what] = phase_exit(what, cfg_, state_, cap, left, right,
                                     card)
    phase_stream(cfg, state, exit_runs["default"]["threshold"], MAIN_ITERS,
                 left, right, small, small_r, card)
    trained = phase_drift(card)

    # ----------------------------------------------------------- phase 30
    mark("phase 30")
    serve_a, serve_b, serve_per_dispatch = phase_serving(
        cfg, state, rt_cfg, rt_state, runner, left, right,
        exit_runs["realtime"]["threshold"])

    # ----------------------------------------------------------- phase 31
    mark("phase 31")
    sess_rt, sess_def, sess_per_frame = phase_sessions(
        cfg, state, rt_cfg, rt_state, left, right,
        exit_runs["realtime"]["threshold"], trained)

    # ----------------------------------------------------------- phase 34
    mark("phase 34")
    sweep_launches, sweep_trained = phase_sweep(card)

    # ----------------------------------------------------------- phase 35
    mark("phase 35")
    serve_b_rt, serve_b_report, serve_b_out = phase_serving_b(
        rt_cfg, rt_state, left, right, exit_runs["realtime"]["threshold"],
        sweep_trained, card)

    # ----------------------------------------------------------- phase 36
    mark("phase 36")
    fleet_counts, fleet_out = phase_fleet(
        rt_cfg, rt_state, left, right, exit_runs["realtime"]["threshold"],
        card)

    # ----------------------------------------------------------- phase 37
    mark("phase 37")
    banded_pair, banded_step, banded_out = phase_banded(cfg, state, card)

    # ----------------------------------------------------------- phase 38
    mark("phase 38")
    dp_counts, dp_out = phase_data_parallel(card)

    # ----------------------------------------------------------- phase 39
    mark("phase 39")
    cp_counts, cp_out = phase_context_parallel(cfg, state, card)

    def row(name_, source, replaces, launched, err, t, design=None):
        """One entry of the kernels line; ``t`` holds graph-replay times."""
        out = {"name": name_, "route": "cuda",
               "source": f"raft_stereo_tpu_torch/csrc/{source}",
               "replaces": (replaces if replaces.startswith("raft_stereo_tpu/")
                            else f"raft_stereo_tpu/kernels/{replaces}"),
               "launches": launched, "max_abs_err": err, "ms": t["ms"],
               "plain_ms": t["plain"], "bound_ms": t["bound"],
               "bound_by": t["by"], "library_ms": t["lib"]}
        # the alt rows' center fields and 20-call replays (phases 8, 17),
        # the lookup backward's write floor (phase 12)
        for key in ("fields", "write_floor_ms"):
            if key in t:
                out[key] = t[key]
        if design:
            out["design"] = design
        out["launches_serving"] = serving.get(name_, 0)
        out["launches_sessions"] = sessions.get(name_, 0)
        out["launches_remat"] = remat.get(name_, {})
        out["launches_loader"] = loader.get(name_, 0)
        out["launches_sweep"] = sweep.get(name_, 0)
        out["launches_serving_b"] = serving_b.get(name_, 0)
        out["launches_fleet"] = fleet.get(name_, 0)
        out["launches_banded"] = banded.get(name_, {})
        out["launches_data_parallel"] = data_parallel.get(name_, 0)
        out["launches_context_parallel"] = context_parallel.get(name_, {})
        return out

    # the wrappers' counts over phase 30's engines (set to 0 before each)
    serving = {"corr_lookup": serve_b["lookup"],
               "gru_gates": serve_b["gates"],
               "gru_gates_bf16": serve_a["gates"],
               "corr_alt": serve_a["alt"],
               "corr_alt_q_int8": serve_a["alt_q"],
               "exit_predicate": serve_a["exit"]}
    # the wrappers' counts over phase 31's session engines (set to 0
    # before the realtime ones and before the default one); every kernel
    # of the session path must have launched
    sessions = {"corr_lookup": sess_def["lookup"],
                "gru_gates": sess_def["gates"],
                "gru_gates_bf16": sess_rt["gates"],
                "corr_alt": sess_rt["alt"],
                "corr_alt_q_int8": sess_rt["alt_q"],
                "exit_predicate": sess_rt["exit"]}
    idle = [k for k in ("corr_lookup", "gru_gates", "gru_gates_bf16",
                        "corr_alt", "exit_predicate") if not sessions[k]]
    if idle:
        raise AssertionError(f"session path kernels never launched: {idle}")
    # phase 32: each policy's counts over its timed default steps; phase
    # 33: the last realtime run over the loader; phase 34: the sweep tool's
    # run, its training included (the hermetic reg backend samples with the
    # plain lookup, so #1 is not among them)
    remat = {kernel: {policy: c[key] for policy, c in remat_launches.items()}
             for kernel, key in (("corr_lookup", "lookup"),
                                 ("corr_lookup_bwd", "lookup_bwd"),
                                 ("gru_gates", "gates"))}
    loader = {"corr_alt": loader_launches["alt"],
              "corr_alt_bwd": loader_launches["alt_bwd"],
              "gru_gates_bf16": loader_launches["gates"]}
    sweep = {"gru_gates": sweep_launches.get("gates", 0),
             "exit_predicate": sweep_launches.get("exit", 0)}
    # phase 35: the realtime engines (bf16: #6 and the gates; the cascade's
    # exit tier the predicate) and the confidence report's hermetic engines
    # (fp32 gates at hidden 32, the predicate; reg: no #1)
    serving_b = {"corr_alt": serve_b_rt.get("alt", 0),
                 "gru_gates_bf16": serve_b_rt.get("gates", 0),
                 "gru_gates": serve_b_report.get("gates", 0),
                 "exit_predicate": (serve_b_rt.get("exit", 0)
                                    + serve_b_report.get("exit", 0))}
    idle = [k for k in ("corr_alt", "gru_gates_bf16", "gru_gates",
                        "exit_predicate") if not serving_b[k]]
    if idle:
        raise AssertionError(f"phase 35 kernels never launched: {idle}")

    # phase 36: the in-process engine of the replicas' flags whose answers
    # the replicas' bytes equal bit for bit (#6 and the bf16 gates on both
    # tiers, the predicate on the exit tier's session frames)
    fleet = {"corr_alt": fleet_counts.get("alt", 0),
             "gru_gates_bf16": fleet_counts.get("gates", 0),
             "exit_predicate": fleet_counts.get("exit", 0)}
    idle = [k for k, v in fleet.items() if not v]
    if idle:
        raise AssertionError(f"phase 36 kernels never launched: {idle}")

    # phase 37: the banded default pair at 32 iterations and the banded
    # default training step; phase 38: the world-of-one DDP steps (every
    # count checked in its phase)
    banded = {"corr_lookup": {"pair": banded_pair["lookup"],
                              "step": banded_step["lookup"]},
              "gru_gates": {"pair": banded_pair["gates"],
                            "step": banded_step["gates"]},
              "corr_lookup_bwd": {"step": banded_step["lookup_bwd"]}}
    data_parallel = {"corr_lookup": dp_counts["lookup"],
                     "corr_lookup_bwd": dp_counts["lookup_bwd"],
                     "gru_gates": dp_counts["gates"]}
    # phase 39: each sharded pair, each sharded step and the xl engine's
    # three requests (every count checked in its phase)
    context_parallel = {
        "corr_lookup": {k: c["lookup"] for k, c in cp_counts.items()},
        "corr_lookup_bwd": {k: c["lookup_bwd"] for k, c in cp_counts.items()
                            if "lookup_bwd" in c},
        "gru_gates": {k: c["gates"] for k, c in cp_counts.items()}}

    lookup_t.update(bound=lookup_bound_ms, by="bytes")
    lbwd_t.update(bound=lbwd_bound, by="bytes")
    kernels = [
        row("corr_lookup", "corr_lookup.cu", "corr_lookup.py:293",
            launches["lookup"], lookup_err, lookup_t,
            "a thread per pixel and level"),
        row("gru_gates", "gru_gates.cu", "gru_fused.py:153",
            launches["gates"], gates_err, gates_fp32,
            "wgmma implicit GEMM, 3xTF32"),
        row("gru_gates_bf16", "gru_gates.cu", "gru_fused.py:153",
            rt_launches["gates"], gates_bf16_err, gates_bf16,
            "wgmma implicit GEMM"),
        row("corr_alt", "corr_alt.cu", "corr_alt.py:273", rt_launches["alt"],
            alt_err["bf16"], alt_time["bf16"],
            "row tiles, bands in shared memory, mma.sync bf16 dots"),
        row("corr_alt_fp32", "corr_alt.cu", "corr_alt.py:75",
            deep_launches["alt"], alt_err["fp32"], alt_time["fp32"],
            "row tiles, bands in shared memory, CUDA-core dots"),
        row("corr_lookup_bwd", "corr_lookup.cu", "corr_lookup.py:304",
            train_launches["lookup_bwd"], lookup_bwd_err, lbwd_t,
            "16-byte runs of the flat dV, window sums staged per block"),
        row("corr_alt_bwd", "corr_alt.cu", "corr_alt.py:90",
            rt_train_launches["alt_bwd"], alt_bwd_err["bf16"],
            alt_bwd_time["bf16"],
            "tensor cores, weights split in two bf16 parts"),
        row("corr_alt_bwd_fp32", "corr_alt.cu", "corr_alt.py:90",
            step_launches["realtime fp32"]["alt_bwd"], alt_bwd_err["fp32"],
            alt_bwd_time["fp32"],
            "CUDA cores, pixels bucketed by window start"),
    ]
    for tag in ("int8", "fp8"):
        kernels.append(row(f"corr_lookup_q_{tag}", "corr_lookup.cu",
                           "corr_lookup.py:321",
                           quant_runs[f"def {tag}"][0]["lookup_q"],
                           lq_err[tag], lq_time[tag],
                           "a thread per pixel and level"))
    for tag in ("int8", "fp8"):
        kernels.append(row(f"corr_alt_q_{tag}", "corr_alt.cu",
                           "corr_alt.py:411",
                           quant_runs[f"rt {tag}"][0]["alt_q"], aq_err[tag],
                           aq_time[tag],
                           "row tiles, bands in shared memory, mma.sync "
                           + ("s8 dots" if tag == "int8" else
                              "bf16 dots of the upcast codes")))
    kernels.append(row(
        "exit_predicate", "graph_loop.cu",
        "raft_stereo_tpu/models/raft_stereo.py:510",
        exit_runs["default"]["counts"]["exit"], pred_t["err"],
        pred_t, "the predicate of a CUDA graph WHILE node: it += 1, "
        "cudaGraphSetConditional"))
    log(f"serving launches per dispatch: {serve_per_dispatch}")
    log(f"sessions launches per frame: {sess_per_frame}")
    log(f"phase 35 measurements: {json.dumps(serve_b_out)}")
    log(f"phase 36 measurements: {json.dumps(fleet_out)}")
    log(f"phase 37 measurements: {json.dumps(banded_out)}")
    log(f"phase 38 measurements: {json.dumps(dp_out)}")
    log(f"phase 39 measurements: {json.dumps(cp_out)}")
    log(f"chip_smoke.py total {time.perf_counter() - T_START:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:    # one rank of phase 38 (b), (c)
        sys.exit(dp_worker(int(sys.argv[2]), int(sys.argv[3]),
                           int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    sys.exit(main())
