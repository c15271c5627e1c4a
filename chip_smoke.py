#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py
  python3 chip_smoke.py --compare LABEL=CSRC_DIR [LABEL=CSRC_DIR ...]
  python3 chip_smoke.py --step-timing REPEATS
  python3 chip_smoke.py --profile-cg ITERS [--full-mesh]
  python3 chip_smoke.py --serving
  python3 chip_smoke.py --full-mesh
  python3 chip_smoke.py --lm
  python3 chip_smoke.py --train
  python3 chip_smoke.py --lm-mesh [--dryrun]
  python3 chip_smoke.py --assembly-mesh
  python3 chip_smoke.py --dryrun

Runs from the root of a checkout and needs one CUDA card; with no card, or
without the rest of the checkout beside it, it exits nonzero and prints no
result.  Phases, in order (any failure exits nonzero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every kernel from ``src/repro_torch/csrc`` (``nvcc``, in
   parallel), with its seconds and, per kernel, the registers, stack frame
   and spills ``ptxas -v`` reports; every instantiation of the DIA SpMV
   kernels (the fold's too), of the axpy kernels and of the CG tail's
   cluster kernels must have no stack frame and no spills;
3. each kernel against its plain PyTorch version on the card: the three
   Krylov kernels for every (storage, accum) pair at the main path's two
   shapes and one small ragged shape (``n`` not a multiple of 8), the
   SpMV, SpMV+dot and axpy vectors bitwise, the SpMV+dot's and the axpy
   kernel's per-256-row partials bitwise against ``block_partials_plain``
   (the kernels' tree order) and the axpy wrapper's dots bitwise the sums
   of those; the value-update gather on the real 210^3 plans (pressure,
   alpha 30, and momentum, alpha 1) and a ragged shape, for
   float64/float32/bfloat16, bitwise; the momentum-assembly kernel at the
   coarse and fine 210^3 shapes, float64 and float32.  Then each kernel's
   time at the pressure shape for each dtype pair it runs in (the SpMV
   kernel at the momentum shape too, the SpMV+dot there in f64) beside its
   byte floor, the plain version's time, the host's microseconds per
   wrapper call and, where one PyTorch call computes the same function,
   that call's (a yardstick the port never calls); the axpy kernel is
   also timed alone, raw launches on preallocated outputs.  The device
   loop's kernels and forms: ``cg_direction`` bitwise its plain version
   and the eager ``z + beta.to(z.dtype) * p`` it replaces for every dtype
   pair at the three shapes, unguarded, under a True flag and writing
   nothing under a False one; the axpy kernel's in-place form and the
   guarded SpMV+dot and SpMV likewise; ``cg_direction`` timed beside its
   byte floor (wrapper, alone, the eager pair, the plain version,
   ``torch.add``), the in-place axpy alone against the out-of-place one
   in turns.  The direction update folded into the SpMV+dot (``spmv_dot_direction``, the
   CG loop's): bitwise its plain version and the unfused ``cg_direction``
   + ``spmv_dot`` launches for every dtype pair at the three shapes and
   the counts 0, 1, 2, unguarded, under a True flag and writing nothing
   under a False one, a cohort of 3 lanes bitwise each lane alone; timed
   at the pressure shape (wrapper, alone, plain, floor of 11 values a row)
   and alone in turns against the unfused pair.  (3c) The CG iteration's
   scalar tail, ``cg_alpha`` and ``cg_advance`` with the partials (one
   thread-block cluster a lane): bitwise their plain versions for f64 and
   f32 partials at 1, 3 and 30 lanes (36,176, 36,176 and 1,206 partials a
   lane) and 3 lanes of 7, each lane running, converging at its
   threshold, capped, NaN or frozen, two runs bitwise equal, the device
   counters once a launch (``cg_advance`` once in each lane that ran);
   then each timed at the main path's 36,176 partials (wrapper, alone,
   plain, as graph nodes) against the library calls it replaced
   (``torch.sum`` + ``torch.div``; two ``torch.sum``);
4. the main path at full size: 3 PISO steps of the 210^3 cavity, 30 fine
   parts fused with alpha = 30, through the launcher's code path, with the
   kernels: the step's six kernels' launch counters must move (the value
   update once a system a step: 3 serially, 2 on the pipelined schedule
   the launcher takes by default, which updates the pressure matrix once;
   the four CG kernels, the fold, ``cg_alpha``, the in-place axpy and
   ``cg_advance``, once per CG iteration, the unfused ``spmv_dot`` and
   ``cg_direction`` never: a
   launch under the loop's guard is counted by its kernel on the device,
   and every sweep's device counts must equal its iterations times the
   loop body's launches), every step converge with a continuity error
   below 1e-6, and every sweep of the device loop (route, K, its host
   reads, capture ms printed) read the device at most ``ceil(iterations /
   K) + 4`` times; then (4b) the device
   loop against the former host loop from the main run's state, with the
   kernels: the f64 pressure CG sweep, the three f64 momentum BiCGStab
   sweeps and an ``f32_ir`` pressure solve, then the ``f32_ir`` solve of
   the first pressure system from rest (its refinement diverges to NaN on
   both loops alike), ``x`` bitwise (the same bits, NaN payloads
   included: ``same_bits``) and identical counts and flags, and the
   pressure and momentum sweeps timed at
   K = 1, 2, 4, 8, 32 and 128 (ms per iteration, capture ms, host reads);
5. determinism: the kernel run again, step by step, bitwise equal;
6. parity: the plain-PyTorch backend takes each step from the kernel run's
   state (step 0 from the shared initial state) and must agree within
   1e-10 of each field's max, with identical Krylov counts and flags; its
   free run from the initial state is reported and held to the solver
   tolerance (the two backends round their dot products in different
   orders, and a Krylov solve only pins its answer to its tolerance, so
   free runs drift apart at that level); a small mesh on the card is held
   against the port's CPU run; one step is timed phase by phase (a
   synchronisation around each phase), and ``solver.timed_step`` (the
   instrumented executor: CUDA events at the phase boundaries) from the
   same state must give a bitwise equal state and a PhaseBreakdown whose
   total lies within 10 % of that walk's;
7. rebinding: from the main run's state, ``rebind_alpha(15)`` and one
   step, held to the alpha-30 step from the same state (1e-10, identical
   counts and flags); ``rebind_alpha(30)`` then builds nothing;
8. the refactoring baseline: ``momentum_bands`` from the main run's
   velocity on the coarse mesh (1 part) against fine assembly plus the
   alpha-30 value update, and on the fine mesh against the step's own
   momentum bands, within 1e-12; both paths timed;
9. precision on the main path: from the main run's state, one cavity
   step under ``f32_ir`` with the kernels (every solve converged, no cap,
   continuity below 1e-6, the step's kernels launched), beside the f64
   step from the same state (no ``bf16_ir`` on the cavity: the reference
   diverges there);
10. the 210^3 channel (inlet at z0, outlet at z1), 30 parts, alpha 30:
    one PISO step from rest under ``f64``, ``f32_ir`` and ``bf16_ir`` with
    the kernels, each converged with continuity below 1e-6; per policy the
    plain-PyTorch backend from the same state (f64: within 1e-10,
    identical counts and flags; refined: equal flags, within 1e-5, both
    counts printed); then the step's first pressure system solved alone
    under each policy, timed (outer and inner iterations, seconds, ms per
    inner iteration), the f64 outer replays counted as ``spmv_dia``
    launches;
11. SIMPLE on the 210^3 channel: ``run_steady(max_outer=4)`` with the
    kernels (capped, every Krylov solve converged), replayed outer
    iteration by outer iteration (bitwise the same end), each outer
    iteration's continuity error, velocity change and counts printed, and
    the plain backend taking each outer iteration from the kernel run's
    state (within 1e-10, identical counts and flags).

12. control at 210^3, from the main run's state on a fresh cavity solver
    with one ``PlanCache`` and the kernels: (12a) one ``timed_step`` at
    every divisor of 30 through ``rebind_alpha`` on the shared cache
    (alpha 30 first, bitwise the main path's timed step), printing each
    alpha's plan build, four phases and total, ms per CG iteration, one
    pressure value update alone and the counts, each held to the alpha-30
    step (1e-10, identical counts and flags), then every alpha revisited
    with the cache's misses held at 8; (12b) each field of the ``H100``
    cost-model spec as this card measures it (the f64 SpMV kernel alone,
    a least-squares line of the value update against alpha, the assembly
    seconds per dof fitted to the model, ms per iteration against rows
    per part as a bound on the knee, a pinned 256 MB host-to-device copy)
    beside the shipped constant, failing a field off by more than 2x (a
    bound: more than 2x above it); (12c) 3 steps (the 4th to the 6th from
    rest) through ``run_adaptive`` at the main path's settings under a
    controller over the divisors of 30 sampling every step from the
    static pick (every step converged with continuity below 1e-6, the
    kernels launched, every plan from the cache), printing the static
    pick, the trajectory, the final calibration and the sweep's fastest
    alpha; then the witness of the 7th step: that step with the kernels
    and with plain PyTorch held to each other (1e-10, identical counts and
    flags), and with the kernels at ``p_tol`` 1e-11 held below 1e-6 (at
    ``p_tol`` 1e-10 the continuity error passes 1e-6 at the 10th); (12d) the
    pressure CG for 50 iterations with the kernels and with plain PyTorch
    on cube meshes with parts of 512 to 308,700 rows (ms per iteration,
    and the rate per dof against the 210^3 mesh's), the kernels required
    to win at every size, as "auto" takes them at every size on the
    card.  Phase 12's checks are collected and fail the run after all
    four parts have printed.

13. serving: (13a) the lane-extended kernels (``spmv_dia``, ``spmv_dot``,
    the in-place ``axpy_precond``, ``cg_direction``, the fold
    ``spmv_dot_direction`` and the axpy reading its direction, at the
    counts 0, 1, 2 a lane, then ``cg_alpha`` and ``cg_advance`` on their
    partials) with 3 lanes at the momentum shape per lane, for every (storage, accum)
    pair: bitwise against their plain versions and against one launch per
    lane alone, a lane whose flag is off left unwritten, NaN in one lane
    leaving the other lanes bitwise; (13b) three tenants of the 210^3
    cavity (the main path's settings, non-adaptive, pipeline "auto") from
    the main run's state with dt = 0.5 h (1, 1.1, 1.2), each path warmed
    by an untimed step: 2 steps through
    the engine's ``step_all`` (one cohort, one dispatch a window) against
    each tenant alone through ``step_session`` (1e-10, identical counts
    and flags, continuity below 1e-6; whether each lane is bitwise
    printed), session-steps per second and ``max_memory_allocated`` for
    one tenant and three, then one tenant with pipeline "on" against
    "off" (2 and 1 + n_correctors value updates a step); (13c) 8 tenants of the serving mesh mix
    (64 x 64 x {32, 48, 64} in {8, 12, 16} parts, padded to 16 parts),
    mixed dt, 8 steps alone unpadded, alone padded and as a cohort, each
    warmed first (session-steps per second, dispatch counters, ms per CG
    iteration; each lane held to its padded solo run), then 7 of them with lane classes (a filler lane) held to the
    same solo runs; (13d) the serving launcher's arrivals mode in
    process (16 Poisson arrivals, cavity and channel, PISO and SIMPLE,
    lane classes): fewer dispatches than sessions, at least two
    multi-session cohorts, per-class p50/p99, two co-batched tenants held
    to their runs alone.  The launch counters are zeroed before 13b and
    read after 13d: every kernel of the step must have launched.  Phase
    13's checks are collected and fail the run after its parts have
    printed.

14. supervision: (14a) three supervised tenants at 13b's settings
    (windows of one step) from the main run's state, checkpointed there:
    one cohort window, then NaN in t2's ``U`` and a second: t2's events
    exactly a ``diverged`` fault and a degrade, ``DEGRADED`` at half dt
    with 2 steps, its retry solo and within 1e-10 (identical counts) of
    an unsupervised step at half dt from its checkpoint, converged with
    continuity below 1e-6; t0 and t1 within 1e-10 of 13b's end states with
    identical counts, healthy with no events; 2 cohort dispatches and 1
    solo; the windows' seconds, ``max_memory_allocated`` and the
    session-steps per second against 13b's warm cohort printed; (14b) one
    supervised ``bf16_ir`` tenant of the same cavity: its first window
    must fault by itself, the session climb to ``f32_ir`` (solver,
    controller and cost model) and its retry at half dt converge, within
    1e-10 (identical counts) of a tenant opened at ``f32_ir``; (14c) at
    13c's class: a persistent cap fault (budget 2) ending in a clean
    ``FAILED`` after exactly fault, degrade, fault, quarantine, fault,
    fail, its mate healthy; NaN twice with the ``"reference"`` fallback,
    then steps until healthy, the Krylov kernels' launch counters flat
    over the quarantined request and moving after recovery (the value
    update throughout), one cohort again; seeded ``blowup`` (recovers) and
    ``slow`` (no event) faults; 13c's mix supervised against unsupervised
    in turns; (14d) a snapshot of 14a's engine after its clean window
    (bytes and seconds), restored after 14a into a fresh engine with a
    fresh plan cache, one window: every tenant within 1e-10 of 13b's end
    state, supervisor, controller and tolerances round-tripped; then the
    serving launcher at ``--cfd-n 64 --parts 16``: an uninterrupted
    supervised run and one killed at a snapshot (its ``main`` in this
    process) and resumed in a process of its own, with equal ``digest``
    lines, and one seeded chaos run (in this process).  Phase 14's checks are
    collected and fail the run after all four parts have printed.

15. the full mesh, from the main run's state: the main path's solver and
    its full-mesh twin (``--solve-mode full_mesh``, the 30 row shards all
    on ``cuda:0``) through the launcher; (15a) the shard SpMV, with and
    without its dot, and the full-mesh bundle's SpMV+dot on the 210^3
    pressure bands (``p`` and a seeded random vector) within 1e-12 of the
    stacked kernels, each timed; (15b) one step at alpha 30 (1 x 30
    shards) and at alpha 15 (2 x 15) against the stacked step from the
    same state: identical counts and flags, ``U``, ``p``, ``phi`` within
    1e-10, no plain version called, the counters from 0 (every kernel of
    the step launched, every CG sweep's device counts its iterations
    times the loop body's launches), the fold and the shard SpMV one lane
    a shard; (15c) the full-mesh pressure sweep on the device loop
    bitwise its host loop; (15d) the stacked and the full-mesh step in
    turns (stacked, full, full, stacked): seconds a step, ms and guarded
    launches per CG iteration; (15e) a refined policy (at construction,
    and set later, at the step), a padded mesh and too few devices must
    raise; (15f) the fused full mesh over the card and the host's CPU (a
    rank a device, each holding its shards' rows): (a) 15b's alpha-30
    pressure system, one CG from ``x0 = p`` capped at 100 iterations, on
    the ``(1, 30)`` mesh with shards 28-29 on ``cpu``, against the
    one-device bundle's host loop on the same system and cap: iterations
    and flags equal, ``x`` within 1e-10 of max|x|, ``r.r`` within 1e-10
    relative, one SpMV+dot and one axpy launch an iteration on the card,
    each with its 28 lanes (the counters from 0 and a spy on the
    wrappers), the bytes carried between devices by kind the closed forms
    (705,600 B a product of ``solve_halo``; bands, diagonal, ``b``,
    ``x0`` and the solution back once) and the record's counts; ms per CG
    iteration against the card alone's, each rank's seconds and waits;
    (b) 19c's 12-part 64 x 64 x 48 mix mesh at alpha 4 on a ``(3, 4)``
    full mesh with shards 10-11 on ``cpu``, one PISO step from rest
    (``make_solver``, the default backend) against every shard on
    ``cuda:0``: counts and flags equal, ``U``, ``p``, ``phi`` within 1e-10
    of their maxima, continuity below 1e-6, the last step's copies the
    closed forms (65,536 B a product); s a step against the card alone.
    Phase 15's checks are collected and fail the run after its parts have
    printed.

16. LM serving, with TF32 off for matmuls and cuDNN (printed): (16a)
    every registry ``SMOKE`` config, float32, one set of parameters from
    a CPU ``torch.Generator`` through prefill and 4 greedy decode steps
    on the CPU and on the card: logits within 1e-4 of the largest
    |logit|, greedy tokens equal; (16b) qwen3-0.6b at full width and all
    28 layers in bfloat16 (parameters from a ``torch.Generator`` seed 0
    on the card), batch 8, prompt 512: ``generate`` of 64 new tokens
    (max_len 576), then two stepped runs that must give bitwise-equal
    tokens and logits, equal to ``generate``'s tokens; prefill seconds,
    decode ms a step and tokens/s, ``max_memory_allocated`` and the
    decode step's byte floor (every weight and the whole K/V cache read
    once); 4 decode steps under ``torch.profiler`` (launches and device
    busy ms a step, the idle share, device time by part, the five largest
    operations); a float32 copy of the weights: prefill plus 8 decode
    steps within 1e-4 of ``forward`` over the same sequence at each
    position with equal greedy tokens, and the bf16 prefill logits within
    5e-2 of the f32 copy's; (16c) mixtral-8x22b (depth cut to 1 layer),
    jamba-v0.1 (to its 8-layer period), rwkv6-1.6b, whisper-medium and
    paligemma-3b (whole) at full width in float32 (the largest, jamba,
    53 GB), batch 2, prompt 64: prefill plus 4 decode steps against
    ``forward`` within 1e-4 with equal greedy tokens (rwkv6 within 1e-3
    at 24 layers, its rounding growing with depth, and within 1e-4 cut to
    one layer); the MoE families' routes that differ between the two
    printed; jamba again in bfloat16, reported and not held (a top-2
    route flips on one bf16 rounding).  Each cut is printed.
    Phase 16's checks are collected and fail the run after its parts have
    printed; its results also go on a line of their own (``lm {...}``)
    before the summary.

17. LM training, with TF32 off for matmuls and cuDNN (printed): (17a)
    every registry ``SMOKE`` config, float32, one set of parameters from
    a CPU ``torch.Generator``, two steps of ``make_train_step(accum=2)``
    on ``batch_at(seed 0)`` on the CPU and on the card, compression off
    and on: loss and grad_norm within 1e-5 relative (grad_norm 1e-4 with
    compression: a value at a .5 tie rounds to the other int8 step on one
    device), the parameters by AdamW's rule (within 2 lr a step; without compression within 1e-2 lr
    where the gradient stayed above noise); (17b) qwen3-0.6b at full
    width, its depth cut from 28 layers to 8, in bfloat16 (281,431,040
    parameters from a ``torch.Generator`` seed 0 on the card),
    ``seq_len`` 4096 (train_4k's),
    global batch 8 (cut from train_4k's 256), ``accum`` 2, ``AdamW()``:
    one warm step and a timed step, all on ``batch_at(seed 0, step 0)``
    (tests/test_training.py's fixed batch: its loss must fall over them),
    and a second run of the first step, bitwise the first run's in its
    loss, grad_norm and every parameter leaf; s a step, tokens/s, 6 N
    tokens against the dense bf16 peak, and the analytical FLOPs of
    ``launch/analysis.py`` (train_4k's total and ideal, scaled linearly
    from its global batch of 256 to the 8 run here) against it too,
    ``max_memory_allocated`` against the prediction; one microbatch under ``torch.profiler`` (the device
    traced alone: launches, busy ms, idle share, device time by part, the
    five largest operations), the loss head and the AdamW update alone;
    one int8-compressed step (finite, error buffers filled); (17c) remat
    on the card: qwen3-0.6b cut to 2 layers
    (``seq_len`` 4096, batch 4) and rwkv6-1.6b cut to 2 layers
    (``seq_len`` 768, batch 2: three 256-step time chunks), gradients with
    remat bitwise those without, ``max_memory_allocated`` of each; (17d)
    qwen3-0.6b's full-width state cut to 2 layers written and restored
    in process (bytes, seconds, bitwise), then the training launcher's
    ``main`` in this process (qwen3-0.6b, ``--layers 2 --seq-len 512
    --batch 8``) run uninterrupted to step 2 and, in another directory,
    to step 1 and resumed to step 2: it must print ``resumed from step
    1`` and the two step-2 checkpoints must hold the same bytes.  Phase 17's checks are collected and fail the
    run after its parts have printed; its results also go on a line of
    their own (``train {...}``) before the summary.

18. the LM side over a device mesh, every position on ``cuda:0`` (one
    process's mesh; copies between positions are device-local), TF32 off:
    (18a) qwen3-0.6b's full state (28 layers, bf16, ``torch.Generator``
    seed 0) laid out on ``make_debug_mesh(2, 4)`` by ``param_shardings``:
    every position's bytes must equal the specs' shard shapes (188,022,784
    parameter bytes, twice that for each AdamW moment) and the state
    gathered back must be bitwise the original; (18b) qwen3-0.6b at full
    width cut 28 -> 4 layers, ``seq_len`` 1024, global batch 8, accum 1
    on the (2, 4) mesh, 2 steps on ``batch_at(seed 0, k)``, the step's
    parameters gathered a period at a time and its attention, MLP and
    vocabulary split over ``model``: every loss and grad_norm within
    ``PIPE_TOL`` of the one-device step's at accum 2 from the same state,
    every parameter within 2 lr k and the k bf16 roundings of its value
    each run may differ by, the mesh run twice bitwise; s a step
    for both, ``max_memory_allocated`` both ways and the step's peak above
    the state it starts from (the mesh's less than the whole-parameter
    copy above the one-device step's), the bytes a step moves by kind
    (gather below the earlier whole-parameter gather of 343,474,176 B);
    then ``launch/train.py --smoke`` (its ``main``, in this process) on
    one device (A) and on the mesh (M) to step 4, and on the mesh to
    step 2 resumed to step 4 on the mesh (B) and on one device (C): B's
    step-4 checkpoint bitwise M's,
    M's and C's parameters within 2 lr k of A's; (18e) phi3.5-moe at full
    width (d 4096, 16 experts, ``d_ff`` 6400, vocab 32064) cut 32 -> 1
    layer (its whole period), 18b's batches and mesh: its attention, MoE
    (the experts over ``data``, their ``d_ff`` over ``model``) and
    vocabulary split, to 18b's bars against the one-device step at accum
    2, the mesh run twice bitwise; the tokens whose routes differ between
    the two runs (bf16: one rounding can flip a top-2 route), s a step,
    both peaks, and the bytes a step moves by kind beside what
    ``mesh_step_moves`` composed for the schedule that ran the MoE whole
    (``MOE_WHOLE_MOVES``); the gather must fall below it and ``model``
    be above 0; (18f) jamba's Mamba mixer (``d_inner`` 8192, ``d_state``
    16, ``dt_rank`` 256) and MoE sublayer (16 experts, ``d_ff`` 14336) at
    full width in f32, 2 x 512, on one (2, 4) row: each split over
    ``model`` against the whole sublayer, the output and the gradients of
    the input and of every parameter within 1e-4 of each whole one's
    largest |value| (jamba's whole period does not fit the card twice for
    a train step; its mesh step runs at SMOKE width in the CPU tests);
    (18g) the ssm, vlm and audio families at full width cut to one layer
    on 18b's mesh and batches: rwkv6-1.6b (its heads through the WKV scan
    and its channel mix's ``d_ff`` over ``model``), paligemma-3b (its
    MQA attention, geglu MLP and tied vocabulary of 257,216 rows over
    its 256 patch rows and the 1024 tokens) and whisper-medium (one
    decoder and one encoder layer over 1500 frames: the encoder's
    attention and MLP, self- and cross-attention and MLP split), each to
    18b's bars against the one-device step at accum 2, the mesh run
    twice bitwise; s a step, both peaks, the bytes a step moves by kind
    beside the whole-product schedule's (``FAMILY_WHOLE_MOVES``): the
    gather below it, ``model`` above 0; (18h) 18e's cut with the sorted
    MoE dispatch at capacity factor 1.0, 2 x 4096 (two 2048-position
    chunks), row 0's labels masked from 2048, the (2, 4) mesh at accum 1
    against the one-device step at accum 1 (the same microbatch) to 18b's
    bars, the mesh run twice bitwise, the bytes a step moves equal to
    what ``mesh_step_moves`` composes (``routes`` too), assignments
    dropped, the mesh's kept set exactly what a stable sort over the
    microbatch's own recorded routes keeps; the dropped counts both ways,
    the tokens whose routes differ, s a step and both peaks;
    (18c) the GPipe
    forward of the same cut, 8 x 1024 on a (pod 2, data 2, model 2) mesh
    with 4 microbatches: bitwise ``hidden_states`` per slice, within 1e-2
    of the full batch's largest |value|, ms against ``hidden_states``;
    (18d) 16b's prefill cache (qwen3-0.6b, 28 layers, batch 8, prompt
    512, max_len 576) laid out by ``fine_spec`` and moved by
    ``repartition_cache`` under both schedules: bitwise the identity,
    coarse shard shapes, bytes moved between positions > 0 and equal to
    the count derived from the two specs (``host_buffer`` at least
    ``device_direct``'s), 8 decode steps giving the original cache's
    tokens, ms and bytes per schedule.  Phase 18's checks are collected
    and fail the run after its parts have printed; its results also go
    on a line of their own (``lm_mesh {...}``) before the summary.

19. the stacked solve over a ``(solve, assemble)`` mesh, from the main
    run's 3-step state, every position on ``cuda:0``: at alpha 30 and
    15 the main path's solver without a mesh and over the ``(30 /
    alpha, alpha)`` mesh (``--mesh-devices``) under ``device_direct`` and
    ``host_buffer``, one step each (without and with the mesh in turns),
    the mesh ones on the state in the assembly layout, plain versions
    refused and the launch counters from 0 for each step: every mesh step
    bitwise the step without a mesh (state, counts and flags, launch
    counters), its state back in the assembly layout, and its move record
    equal to the closed forms (a pressure update 499,964,640 /
    482,724,480 B between positions under ``device_direct``,
    0 between devices; ``host_buffer`` at least as much), beside the cost
    model's ``t_repartition`` volume and JAX's replicated solve layout;
    s a step with and without the mesh.  19b then runs the alpha-30
    ``(1, 30)`` and alpha-15 ``(2, 15)`` meshes over the card and the
    host's CPU (positions 28-29, and 14 and 29, on ``cpu``; every owner on
    the card), one timed step each from the same state, ``device_direct``
    on the first and ``host_buffer`` on the second (the CPU tests run both
    on every mesh), plain versions refused on the card only: each field
    within 1e-10 of
    its maximum of 19's step of the same mesh on the card alone, counts,
    flags and the card's launch counters equal, every kind's bytes copied
    between devices equal to its count between devices; it prints s a
    step, each rank's fine-phase, solve and update seconds (and the part
    spent waiting at collectives), each kind's bytes and seconds between
    devices (the pressure update host -> card above all) beside the
    card's name and power limit, and the host's cores.  19c runs the
    refined policies and a padded mesh over the card and its host, every
    owner on the card: (a) the main path's solver under ``f32_ir`` on the
    ``(1, 30)`` mesh (``device_direct``), one timed step from the same
    state, held to phase 9's ``f32_ir`` step from it (with
    ``--assembly-mesh``, to the same mesh naming ``cuda:0`` alone): each
    field within 1e-5 of its maximum, the flags and each refined solve's
    passes equal, each inner total within 25 %, the card's launch counters
    equal where every count is, carried = counted by kind and
    ``solve_halo`` equal to the closed form at 8 B (the f64 replays) and 4
    B (the inner sweeps); it prints what 19b prints and the momentum's
    share of the step; (b) 13c's 64 x 64 x 48 mesh of 12 parts padded to
    16, f64, alpha 4, on ``(4, 4)`` with positions 11 (real) and 15
    (padding) on ``cpu``, 2 steps: within 1e-10 of the same mesh on the
    card alone, counts and flags equal, the padding parts bitwise; (c) the
    same mesh unpadded under ``bf16_ir`` on ``(3, 4)`` with 7 and 11 on
    ``cpu``, ``p_maxiter`` 200, one step: the verdict and each solve's
    passes equal the card alone's, the fields compared where both are
    finite.  Its checks are collected and fail the run after it has
    printed; its results go on a line of their own (``assembly_mesh
    {...}``);
20. the port's dry-run on the card's host (``python -m
    repro_torch.launch.dryrun --all --mesh both`` into a temporary
    directory; it touches no device; the whole run starts it beside the
    kernels' build and waits for it before phase 3): 80 records, 66 ``ok``, 14
    ``skipped``, none in error, each under JAX's file name, the command's
    seconds, ``moves`` on every ``ok`` train cell; then the ``moves`` it
    composes at 18b's, 18e's, 18h's and 18g's configurations (qwen3-0.6b
    cut to 4 layers, phi3.5-moe cut to 1 (18h: sorted, 2 x 4096), rwkv6,
    paligemma and whisper cut to 1, a (2, 4) mesh naming ``cuda:0`` 8
    times, accum 1, 8 x 1024) against the ``MeshStepStats`` 18b, 18e, 18h
    and 18g measured (every kind, ``model`` and ``routes`` too), integer
    for integer.  Its results go on
    a line of their own (``dryrun {...}``).

In phases 9-14 every kernel wrapper's plain version is made to raise while
the kernel runs go: the card's path launches the kernels only (14c's
quarantined request runs on the plain ``"reference"`` backend by
configuration, which calls no wrapper).

The line before the last is the card's ``nvidia-smi`` name and power
limit, the one before that the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.

With ``--compare``, only phases 1 and 2 run, and then this tree's three
Krylov kernels are built beside those of each other ``csrc`` directory
(another checkout's ``src/repro_torch/csrc``), checked bitwise against the
plain versions, and timed in turns on this card (this tree, the others,
the others again in reverse, this tree) for every (storage, accum) pair
(a tree from before the lane arguments is launched with its own entry
points):
the two SpMV kernels at the pressure and momentum shapes, the axpy kernel
(raw launches) at the pressure shape; the last line is then the
comparison as JSON.  With ``--step-timing``, only phases 1 and 2 run, and then the main
path's first step from rest, walked phase by phase ``REPEATS`` times after
one untimed step, gives the ms per pressure-CG iteration, and phase 10's
pressure solves alone the ms per inner iteration of each policy; the last
line is those as JSON.  With ``--profile-cg``, only phases 1 and 2 run,
and then the main path's first pressure CG, capped at ``ITERS``
iterations, under ``torch.profiler``: device time per iteration by part
(the fold or SpMV+dot, axpy, partial sums, the p update, scalar ops, host
reads) and
the device's idle share.  Both modes use only what the port has had since
its fourth slice (the refinement loop and the channel), so a copy of this
script beside another such checkout's ``src`` measures that tree the same
way; with ``--full-mesh`` beside it, ``--profile-cg`` profiles phase 15's
full-mesh CG instead.  With ``--serving``, phases 1 and 2 run, then phases
13 and 14 from the main path's 3-step state; with ``--full-mesh`` alone,
phase 15; with ``--lm``, phase 16; with ``--train``, phase 17; with
``--lm-mesh``, phase 18; with ``--assembly-mesh``, phase 19 from the main
path's 3-step state; with ``--dryrun``, phase 20 (after phase 18 when
``--lm-mesh`` is given too, else without 18b's, 18e's and 18g's bytes to
compare).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the main path: the paper's smallest mesh, (2*3*5*7)^3 cells, 30 fine
# slabs fused into one coarse part.  At this size the pressure CG needs
# more than the default 2000 iterations and a 1e-8 relative tolerance
# leaves a continuity error above 1e-6, so the run tightens both.
N, PARTS, ALPHA = 210, 30, 30
MAIN_ARGS = ["--n", str(N), "--parts", str(PARTS), "--alpha", str(ALPHA),
             "--steps", "3",
             "--co", "0.5", "--p-tol", "1e-10", "--p-maxiter", "6000",
             "--device", "cuda"]
# the Krylov counts of the main path on the H100 (PERF.md): the SpMV
# kernels compute y and the p.Ap partials bit for bit as their plain
# versions do, so other counts mean the solver, not the speed, changed
MAIN_COUNTS = {"mom_iters": [59, 62, 68],
               "p_iters": [[2125, 2160], [2460, 2486], [2444, 2490]]}
PARITY = 1e-10        # fused vs plain backend, one step from one state,
#                       relative to the field's max
FREE_RUN_DRIFT = 1e-5  # free runs of the two backends: 100x mom_tol
CONTINUITY = 1e-6
# kernel vs plain version, relative to the output's max, per storage dtype
TOLERANCE = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 2e-2}
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20             # H100 SXM L2
FLOPS_PER_S = {"float64": 34e12,    # FP64 outside the tensor cores
               "float32": 67e12, "bfloat16": 67e12}
SOURCES = {"spmv_dia": "src/repro_torch/csrc/spmv_dia.cu",
           "spmv_dot": "src/repro_torch/csrc/krylov_fused.cu",
           "axpy_precond": "src/repro_torch/csrc/krylov_fused.cu",
           "coef_update": "src/repro_torch/csrc/coef_update.cu",
           "momentum_bands": "src/repro_torch/csrc/stencil_assembly.cu",
           "cg_direction": "src/repro_torch/csrc/krylov_loop.cu",
           "cg_advance": "src/repro_torch/csrc/krylov_loop.cu",
           "spmv_dot_direction": "src/repro_torch/csrc/krylov_fused.cu",
           "cg_alpha": "src/repro_torch/csrc/krylov_loop.cu"}
REPLACES = {"spmv_dia": "src/repro/kernels/spmv_dia/spmv_dia.py:53",
            "spmv_dot": "src/repro/kernels/krylov_fused/krylov_fused.py:118",
            "axpy_precond":
                "src/repro/kernels/krylov_fused/krylov_fused.py:189",
            "coef_update": "src/repro/kernels/coef_update/coef_update.py:37",
            "momentum_bands": "src/repro/kernels/stencil_assembly/"
                              "stencil_assembly.py:74",
            # port-only kernels: no TPU kernel does this work; the JAX
            # solver lines they replace
            "cg_direction": "src/repro/solvers/cg.py:74",
            "cg_advance": "src/repro/solvers/cg.py:78 + "
                          "src/repro/kernels/krylov_fused/ops.py:68",
            "cg_alpha": "src/repro/solvers/cg.py:74 + "
                        "src/repro/kernels/krylov_fused/ops.py:47",
            # the SpMV+dot's TPU kernel with the direction update folded in
            "spmv_dot_direction":
                "src/repro/kernels/krylov_fused/krylov_fused.py:118 + "
                "src/repro/solvers/cg.py:74"}
# the guarded launches one iteration of each device loop makes: every
# sweep's device counters must read these times its iterations (the CG
# loop's direction update runs inside spmv_dot_direction, its partial sums
# inside cg_alpha and cg_advance)
LOOP_LAUNCHES = {"cg": {"spmv_dot_direction": 1, "cg_alpha": 1,
                        "axpy_precond": 1, "cg_advance": 1},
                 "bicgstab": {"spmv_dia": 2}}
# the kernels a PISO step launches; the momentum-assembly kernel belongs to
# the refactoring baseline's entry point (phase 8)
STEP_KERNELS = ("spmv_dia", "spmv_dot_direction", "cg_alpha", "axpy_precond",
                "coef_update", "cg_advance")
# the unfused pair the fold replaced on the CG loop: held against it in
# phase 3 and 13a, never launched by a step
UNFUSED_KERNELS = ("spmv_dot", "cg_direction")
# kernels whose every instantiation must compile without a stack frame or
# spills (ptxas -v): the SpMV kernels read the band offsets at compile-time
# indices, the axpy kernel indexes its row arrays at compile-time indices
NO_FRAME_KERNELS = ("spmv_dia_kernel", "spmv_dot_kernel",
                    "axpy_precond_kernel")
# ... and, since the device-resident loop, the axpy kernel's in-place form
# and the CG direction update
LOOP_NO_FRAME_KERNELS = ("axpy_precond_inplace_kernel", "cg_direction_kernel")
# ... and, since the fold, the SpMV+dot with the direction update
FOLD_NO_FRAME_KERNELS = ("spmv_dot_direction_kernel",)
# ... and, since the scalar tail's cluster kernels, both of them
TAIL_NO_FRAME_KERNELS = ("cg_alpha_kernel", "cg_advance_kernel")
ASSEMBLY_PARITY = 1e-12  # momentum_bands vs assembly + update, elementwise
#                          rtol = atol (tests/test_kernels.py's bar)
# the policies whose 210^3 channel step must converge.  bf16_ir refines
# with bfloat16 bands (eps 4e-3) on a matrix whose condition number grows
# as n^2: at 210^3 its pressure CG stops at the outer cap (48 passes) on
# the kernels and on the plain backend alike, as the JAX reference's
# bf16_ir already fails on this channel at 16^3
# (tests/test_torch_precision.py); it is run, held to the plain backend's
# verdict and reported.
MUST_CONVERGE = ("f64", "f32_ir")


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: the build
# ---------------------------------------------------------------------------

_PTXAS_FUNCTION = re.compile(
    r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGISTERS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict:
    """``{function: {"stack", "spill_stores", "spill_loads", "registers"}}``
    (bytes, and registers per thread) from ``nvcc -Xptxas -v`` text; the
    function names are as ``ptxas`` prints them (mangled)."""
    out, name = {}, None
    for line in log.splitlines():
        m = _PTXAS_FUNCTION.search(line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = _PTXAS_FRAME.search(line)
        if m:
            out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                 map(int, m.groups())))
        m = _PTXAS_REGISTERS.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def base_name(mangled: str) -> str:
    """The unqualified function name of an Itanium-mangled name
    (``_Z15spmv_dia_kernelIddLi7EE...`` -> ``spmv_dia_kernel``)."""
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end():m.end() + int(m.group(1))] if m else mangled


def check_frames(report: dict, kernels=NO_FRAME_KERNELS) -> dict:
    """Require every instantiation of ``kernels`` in a :func:`ptxas_report`
    to have a complete record with no stack frame and no spills; returns
    ``{kernel: number of instantiations}``."""
    counts = {k: 0 for k in kernels}
    for fn, rec in report.items():
        k = base_name(fn)
        if k not in counts:
            continue
        counts[k] += 1
        require(all(f in rec for f in ("stack", "spill_stores",
                                       "spill_loads")),
                f"ptxas printed no frame line for {fn}")
        require(rec["stack"] == rec["spill_stores"] == rec["spill_loads"] == 0,
                f"{fn}: {rec['stack']} bytes stack frame, "
                f"{rec['spill_stores']}/{rec['spill_loads']} bytes spilled")
    require(all(counts.values()), f"ptxas reported no instance of some of "
                                  f"{kernels}: {counts}")
    return counts


# an atomic or reduction instruction in cuobjdump's SASS (ATOM, ATOMS,
# ATOMG, RED with their suffixes)
ATOMIC_SASS = re.compile(r"\b(?:ATOM|ATOMS|ATOMG|RED)\.")


def sass_atomics(sass: str, kernels) -> dict:
    """``{kernel: atomic instructions}`` over every instantiation of
    ``kernels`` in ``cuobjdump -sass`` text; requires code for each."""
    counts = {k: 0 for k in kernels}
    seen, current = set(), None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = base_name(m.group(1))
            if current in counts:
                seen.add(current)
        elif current in counts and ATOMIC_SASS.search(line):
            counts[current] += 1
    require(seen == set(counts), f"cuobjdump printed no code for "
                                 f"{sorted(set(counts) - seen)}")
    return counts


def check_tail_atomics() -> None:
    """The tail kernels' SASS holds no atomic instruction (their sums'
    order is fixed by the code alone), read by the ``cuobjdump`` beside
    ``nvcc`` or else on ``PATH``; fails when there is none."""
    from repro_torch.kernels._build import _lib_path, _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        tool = shutil.which("cuobjdump")
    require(tool is not None, "no cuobjdump beside nvcc or on PATH: the "
                              "tail kernels' SASS cannot be read")
    sass = subprocess.run([str(tool), "-sass", str(_lib_path("krylov_loop"))],
                          capture_output=True, text=True, check=True).stdout
    counts = sass_atomics(sass, TAIL_NO_FRAME_KERNELS)
    print(f"  atomic instructions in the tail kernels' SASS: {counts}")
    require(not any(counts.values()),
            f"the tail kernels use atomics: {counts}")


def print_record(label: str, fn: str, rec: dict) -> None:
    print(f"  {label}: {fn} {rec.get('registers')} registers, "
          f"{rec.get('stack')} B stack, {rec.get('spill_stores')}/"
          f"{rec.get('spill_loads')} B spill stores/loads")


def build_phase() -> None:
    """Phase 2: build, print each kernel's ptxas record, check the frames."""
    from repro_torch.kernels._build import build_all

    info = build_all()
    print(f"  built {info['built'] or 'nothing (cached)'} in "
          f"{info['seconds']:.1f} s")
    records = {}
    for src, log in info["ptxas"].items():
        for fn, rec in ptxas_report(log).items():
            records[fn] = rec
            if "registers" in rec:
                print_record(src, fn, rec)
    # a tree from before the device loop (timed by a copy of this script)
    # has neither the in-place axpy nor krylov_loop.cu, one from before the
    # fold no spmv_dot_direction_kernel
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels._build import SOURCES as built
    kernels = NO_FRAME_KERNELS + (LOOP_NO_FRAME_KERNELS
                                  if "krylov_loop" in built else ()) + (
        FOLD_NO_FRAME_KERNELS if "spmv_dot_direction" in WRAPPERS else ()) + (
        TAIL_NO_FRAME_KERNELS if "cg_alpha" in WRAPPERS else ())
    counts = check_frames(records, kernels)
    print(f"  no stack frame, no spills: {counts} instantiations")
    if "cg_alpha" in WRAPPERS:
        check_tail_atomics()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def shapes() -> list:
    """(label, P, m, nx, plane): the pressure and momentum systems of the
    main path, and a ragged shape (P*m not a multiple of 256)."""
    return [("pressure", PARTS // ALPHA, N ** 3 * ALPHA // PARTS, N, N ** 2),
            ("momentum", PARTS, N ** 3 // PARTS, N, N ** 2),
            ("ragged", 3, 777, 4, 16)]


def policy_pairs() -> list:
    """(storage, accum) of every precision policy: f64, f32_ir, bf16_ir."""
    from repro_torch.solvers.precision import POLICIES

    return [(p.storage_dtype, p.accum_dtype) for p in POLICIES.values()]


def offsets_for(nx: int, plane: int) -> tuple[int, ...]:
    return (-plane, -nx, -1, 0, 1, nx, plane)


def make_inputs(torch, P, m, gen, dev):
    """Positive random operands (every dot is a sum of positive terms, so a
    relative error is well defined), in float64."""
    def rnd(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           dtype=torch.float64, device=dev)
    return {"bands": rnd(P, 7, m), "x": rnd(P, m), "r": rnd(P, m),
            "p": rnd(P, m), "Ap": rnd(P, m), "inv": rnd(P, m, lo=0.5, hi=1.5),
            "alpha": torch.tensor(0.3, dtype=torch.float64, device=dev)}


def compare(torch, got, want) -> tuple[float, float]:
    """(max abs error, max error relative to the output's max |want|) over
    matching outputs."""
    abs_err = rel = 0.0
    for g, w in zip(got, want):
        err = float((g.double() - w.double()).abs().max())
        abs_err = max(abs_err, err)
        rel = max(rel, err / max(float(w.double().abs().max()), 1e-300))
    return abs_err, rel


AXPY_OPERANDS = ("x", "r", "p", "Ap", "inv")


def plain_versions() -> dict:
    """{kernel: plain PyTorch version} of the three Krylov kernels."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        fused_axpy_precond_plain, spmv_dot_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import spmv_dia_plain

    return {"spmv_dia": spmv_dia_plain, "spmv_dot": spmv_dot_plain,
            "axpy_precond": fused_axpy_precond_plain}


def kernel_calls(kernels, plain, inputs, offsets, plane, storage, accum):
    """{kernel: (kernel call, plain call)} on ``inputs`` cast to storage."""
    b = inputs["bands"].to(storage)
    x = inputs["x"].to(storage)
    vecs = [inputs[k].to(storage) for k in AXPY_OPERANDS]
    alpha = inputs["alpha"].to(accum)
    kw = dict(offsets=offsets, plane=plane, accum_dtype=accum)
    return {
        "spmv_dia": (lambda: (kernels["spmv_dia"](b, x, **kw),),
                     lambda: (plain["spmv_dia"](b, x, **kw),)),
        "spmv_dot": (lambda: kernels["spmv_dot"](b, x, **kw),
                     lambda: plain["spmv_dot"](b, x, **kw)),
        "axpy_precond": (
            lambda: kernels["axpy_precond"](*vecs, alpha, accum_dtype=accum),
            lambda: plain["axpy_precond"](*vecs, alpha, accum_dtype=accum)),
    }


def axpy_launcher(torch, lib, vecs, alpha, accum):
    """Raw launches of a loaded ``krylov_fused`` library's
    ``axpy_precond_launch`` into preallocated outputs (no check, no
    allocation, no sum, no launch count): a function that launches once and
    returns ``(x', r', z, rz_partials, rr_partials)``."""
    from repro_torch.kernels._build import dtype_code
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       stream_ptr)

    x = vecs[0]
    n = x.numel()
    outs = [torch.empty_like(x) for _ in range(3)] + [
        torch.empty(-(-n // KERNEL_BLOCK_ROWS), dtype=accum, device=x.device)
        for _ in range(2)]
    a = alpha.to(accum)
    args = (dtype_code(x.dtype, accum), *(v.data_ptr() for v in vecs),
            a.data_ptr(), *(o.data_ptr() for o in outs), n, stream_ptr(x))

    def launch(_operands=(a, *vecs)):
        rc = lib.axpy_precond_launch(*args)
        require(rc == 0, f"axpy_precond launch failed ({rc})")
        return outs
    return launch


def axpy_inplace_launchers(torch, vecs, alpha, accum):
    """The axpy kernel in the form the CG loop calls it, on copies of ``x``
    and ``r`` that it updates in place: ``(wrapper, raw, partials)`` —
    ``fused_update_step_into`` (the in-place launch into fixed buffers of
    partials, which the loop's ``cg_advance`` sums), a raw launch of
    ``axpy_precond_inplace_launch`` (no check, no launch count), and the
    two partial rows both write."""
    from repro_torch.kernels._build import dtype_code, load
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        fused_update_step_into, partials_buffers)
    from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr

    x, r = vecs[0].clone(), vecs[1].clone()
    n = x.numel()
    z = torch.empty_like(x)
    part = partials_buffers(n, accum, x.device)
    a = alpha.to(accum)
    lib = load("krylov_fused")
    p = vecs[2].data_ptr()
    args = (dtype_code(x.dtype, accum), x.data_ptr(), r.data_ptr(), p, p, 0,
            *(v.data_ptr() for v in vecs[3:]), a.data_ptr(), z.data_ptr(),
            part["rz"].data_ptr(), part["rr"].data_ptr(), n, 1,
            part["stride"], 0, 0, stream_ptr(x))

    def wrapper():
        fused_update_step_into(x, r, *vecs[2:], a, z, part,
                               accum_dtype=accum)

    def raw(_keep=(x, r, z, a, part, *vecs)):
        rc = lib.axpy_precond_inplace_launch(*args)
        require(rc == 0, f"axpy_precond in-place launch failed ({rc})")

    return wrapper, raw, (part["rz"], part["rr"])


def spmv_launcher(torch, name, bands, x, offsets, accum):
    """Raw launches of this tree's ``spmv_dia_launch`` or
    ``spmv_dot_launch`` (``name``: "spmv_dia" or "spmv_dot") into
    preallocated outputs: a function that launches once."""
    from repro_torch.kernels._build import dtype_code, load
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       _offsets_arg,
                                                       stream_ptr)

    P, nb, m = bands.shape
    y = torch.empty_like(x)
    part = torch.empty(-(-P * m // KERNEL_BLOCK_ROWS), dtype=accum,
                       device=x.device)
    head = (dtype_code(bands.dtype, accum), bands.data_ptr(), x.data_ptr(),
            y.data_ptr())
    tail = (P, m, _offsets_arg(offsets), nb, 1)  # one lane
    if name == "spmv_dia":
        fn = load("spmv_dia").spmv_dia_launch
        args = head + tail + (stream_ptr(x),)
    else:
        fn = load("krylov_fused").spmv_dot_launch
        args = (head + (part.data_ptr(),) + tail
                + (part.numel(), stream_ptr(x)))

    def launch(_keep=(bands, x, y, part)):
        rc = fn(*args)
        require(rc == 0, f"{name} launch failed ({rc})")
    return launch


def time_ms(torch, fn, n=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def host_us(torch, fn, n=20) -> float:
    """Host microseconds per call of ``fn``, called back to back with no
    synchronisation: above the card's time per call, the host and not the
    card bounds what :func:`time_ms` reads."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * secs / n


def csr_of_bands(torch, bands, offsets):
    """The (n, n) CSR matrix of stacked DIA bands (P, nb, m) on the flat
    vector, n = P*m: what the kernels compute, halos included."""
    P, nb, m = bands.shape
    n = P * m
    vals = bands.permute(1, 0, 2).reshape(nb, n)
    rows = torch.arange(n, device=bands.device)
    cols = rows[:, None] + torch.tensor(offsets, device=bands.device)[None, :]
    valid = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=bands.device)
    crow[1:] = torch.cumsum(valid.sum(dim=1), dim=0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols[valid], vals.T[valid],
                                       size=(n, n), check_invariants=False)


def check_spmv_bitwise(torch, label, sname, y_dia, y_dot, part, y_want,
                       part_want) -> None:
    """The two SpMV kernels' vectors and the SpMV+dot's partials against
    ``spmv_dot_partials_plain``, bit for bit."""
    same = {"spmv_dia y": torch.equal(y_dia, y_want),
            "spmv_dot y": torch.equal(y_dot, y_want),
            "spmv_dot partials": part.shape == part_want.shape
            and torch.equal(part, part_want)}
    print(f"  bitwise {label:9s} {sname:8s}: "
          + ", ".join(f"{k} {v}" for k, v in same.items()))
    require(all(same.values()), f"not bitwise at {label} {sname}: {same}")


def axpy_bitwise(torch, part_out, wrap_out, want) -> dict:
    """The axpy kernel against ``axpy_precond_partials_plain``'s ``want``
    (x', r', z, r.z partials, r.r partials), bit for bit: ``part_out`` is
    ``axpy_precond_partials``'s five outputs, ``wrap_out`` the wrapper's
    (x', r', z, r.z, r.r), whose dots must be ``torch.sum`` of ``want``'s
    partials.  ``{output: equal}``."""
    same = {name: torch.equal(part_out[i], want[i])
            and torch.equal(wrap_out[i], want[i])
            for i, name in enumerate(("x'", "r'", "z"))}
    for i, name in ((3, "r.z"), (4, "r.r")):
        same[f"{name} partials"] = torch.equal(part_out[i], want[i])
        same[name] = torch.equal(wrap_out[i], want[i].sum())
    return same


def check_kernels(torch, dev) -> dict:
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        axpy_precond_partials, axpy_precond_partials_plain,
        spmv_dot_partials, spmv_dot_partials_plain)

    plain = plain_versions()
    pairs = policy_pairs()
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {name: {} for name in plain}
    for label, P, m, nx, plane in shapes():
        inputs = make_inputs(torch, P, m, gen, dev)
        offsets = offsets_for(nx, plane)
        for storage, accum in pairs:
            sname = str(storage).removeprefix("torch.")
            calls = kernel_calls(WRAPPERS, plain, inputs, offsets, plane,
                                 storage, accum)
            got_all = {}
            for name, (k_fn, p_fn) in calls.items():
                got = got_all[name] = k_fn()
                torch.cuda.synchronize()
                abs_err, rel = compare(torch, got, p_fn())
                ok = rel <= TOLERANCE[sname]
                print(f"  {name:13s} {label:9s} {sname:8s}/"
                      f"{str(accum).removeprefix('torch.'):8s} "
                      f"max_abs_err={abs_err:.3e} rel={rel:.3e} "
                      f"(tol {TOLERANCE[sname]:.0e}) {'ok' if ok else 'FAIL'}")
                require(ok, f"{name} disagrees with its plain version at "
                            f"{label} {sname}: rel {rel:.3e}")
                if label == "pressure" and storage == torch.float64:
                    report[name]["max_abs_err"] = abs_err
            b, x = inputs["bands"].to(storage), inputs["x"].to(storage)
            kw = dict(offsets=offsets, plane=plane, accum_dtype=accum)
            _, part = spmv_dot_partials(b, x, **kw)
            check_spmv_bitwise(torch, label, sname, got_all["spmv_dia"][0],
                               got_all["spmv_dot"][0], part,
                               *spmv_dot_partials_plain(b, x, **kw))
            vecs = [inputs[k].to(storage) for k in AXPY_OPERANDS]
            alpha = inputs["alpha"].to(accum)
            same = axpy_bitwise(
                torch, axpy_precond_partials(*vecs, alpha, accum_dtype=accum),
                got_all["axpy_precond"],
                axpy_precond_partials_plain(*vecs, alpha, accum_dtype=accum))
            print(f"  bitwise {label:9s} {sname:8s}: axpy_precond "
                  + ", ".join(f"{k} {v}" for k, v in same.items()))
            require(all(same.values()),
                    f"axpy_precond not bitwise at {label} {sname}: {same}")
            del got_all, part, b, x, vecs
        if label != "ragged":
            time_kernels(torch, label, inputs, offsets, plane, pairs, report)
        del inputs
        torch.cuda.empty_cache()
    report["coef_update"] = check_coef_update(torch, dev)
    torch.cuda.empty_cache()
    report["momentum_bands"] = check_momentum_bands(torch, dev)
    torch.cuda.empty_cache()
    check_loop_kernels(torch, dev, report)
    torch.cuda.empty_cache()
    check_fold(torch, dev, report)
    torch.cuda.empty_cache()
    check_tail(torch, dev, report)
    torch.cuda.empty_cache()
    return report


def check_loop_kernels(torch, dev, report: dict) -> None:
    """The device loop's kernels and forms on the card, for every dtype pair
    at the three shapes: ``cg_direction`` bitwise its plain version and the
    eager pair it replaces (``z + beta.to(z.dtype) * p``), unguarded and
    under a True flag, and writing nothing under a False one; the axpy
    kernel's in-place form, the guarded SpMV+dot and SpMV likewise.  Then,
    at the pressure shape, ``cg_direction`` timed (wrapper, alone, the eager pair, the plain
    version, ``torch.add(z, p, alpha=beta)``) beside its byte floor and
    the in-place axpy alone against the out-of-place one in turns; the
    entries go into ``report``."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        axpy_precond_inplace, axpy_precond_partials_plain, spmv_dot_partials)
    from repro_torch.kernels.krylov_loop.krylov_loop import (
        cg_direction, cg_direction_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       spmv_dia_stacked)

    gen = torch.Generator(device=dev).manual_seed(3)
    on = torch.ones((), dtype=torch.bool, device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    report["cg_direction"] = {"max_abs_err": 0.0}
    for label, P, m, nx, plane in shapes():
        inputs = make_inputs(torch, P, m, gen, dev)
        offsets = offsets_for(nx, plane)
        for storage, accum in policy_pairs():
            sname = str(storage).removeprefix("torch.")
            p0, z = inputs["p"].to(storage), inputs["r"].to(storage)
            g_new = torch.tensor(0.37, dtype=accum, device=dev)
            g = torch.tensor(0.91, dtype=accum, device=dev)
            want = cg_direction_plain(p0.clone(), z, g_new, g)
            same = {"eager pair": torch.equal(
                want, z + (g_new / g).to(storage) * p0)}
            for tag, flag in (("unguarded", None), ("active", on)):
                p = p0.clone()
                cg_direction(p, z, g_new, g, flag)
                same[tag] = torch.equal(p, want)
            p = p0.clone()
            cg_direction(p, z, g_new, g, off)
            same["idle writes nothing"] = torch.equal(p, p0)
            print(f"  bitwise {label:9s} {sname:8s}: cg_direction "
                  + ", ".join(f"{k} {v}" for k, v in same.items()))
            require(all(same.values()),
                    f"cg_direction not bitwise at {label} {sname}: {same}")

            vecs = [inputs[k].to(storage) for k in AXPY_OPERANDS]
            alpha = inputs["alpha"].to(accum)
            want = axpy_precond_partials_plain(*vecs, alpha,
                                               accum_dtype=accum)
            nb = -(-vecs[0].numel() // KERNEL_BLOCK_ROWS)
            same = {}
            for tag, flag in (("active", on), ("idle", off)):
                x, r = vecs[0].clone(), vecs[1].clone()
                outs = [torch.zeros_like(x)] + [
                    torch.zeros(nb, dtype=accum, device=dev)
                    for _ in range(2)]
                axpy_precond_inplace(x, r, *vecs[2:], alpha, *outs,
                                     accum_dtype=accum, active=flag)
                if flag is on:
                    same[tag] = all(torch.equal(a, b) for a, b in zip(
                        (x, r, *outs), want))
                else:
                    same["idle writes nothing"] = (
                        torch.equal(x, vecs[0]) and torch.equal(r, vecs[1])
                        and not any(bool(o.any()) for o in outs))
            b, xx = inputs["bands"].to(storage), inputs["x"].to(storage)
            kw = dict(offsets=offsets, plane=plane, accum_dtype=accum)
            y_w, part_w = spmv_dot_partials(b, xx, **kw)
            ys_w = spmv_dia_stacked(b, xx, **kw)
            for tag, flag in (("active", on), ("idle", off)):
                y, part, ys = (torch.full_like(t, 7.0)
                               for t in (y_w, part_w, ys_w))
                spmv_dot_partials(b, xx, **kw, out=(y, part), active=flag)
                spmv_dia_stacked(b, xx, **kw, out=ys, active=flag)
                if flag is on:
                    same[f"spmv {tag}"] = (torch.equal(y, y_w)
                                           and torch.equal(part, part_w)
                                           and torch.equal(ys, ys_w))
                else:
                    same["spmv idle writes nothing"] = all(
                        bool((t == 7.0).all()) for t in (y, part, ys))
            print(f"  bitwise {label:9s} {sname:8s}: axpy in place, guarded "
                  "SpMVs: " + ", ".join(f"{k} {v}" for k, v in same.items()))
            require(all(same.values()), f"the in-place axpy or a guarded SpMV "
                                        f"is wrong at {label} {sname}: {same}")
            if label == "pressure":
                time_loop_kernels(torch, dev, report, sname, storage, accum,
                                  p0, z, g_new, g, vecs, alpha)
            del p0, z, vecs, want, b, xx, y_w, part_w, ys_w
        del inputs
        torch.cuda.empty_cache()


def time_loop_kernels(torch, dev, report, sname, storage, accum, p, z, g_new,
                      g, vecs, alpha) -> None:
    """Phase 3's times of the loop kernels at the pressure shape.

    ``cg_direction`` moves 3 values a row, and a (p, z) pair in bf16 or f32
    (37 or 74 MB) could stay in the 50 MB L2 from one call to the next: its
    calls rotate through copies of the pair, three times the L2 in all, so
    that each call reads from HBM."""
    from repro_torch.kernels._build import dtype_code, load
    from repro_torch.kernels.krylov_loop.krylov_loop import (
        cg_direction, cg_direction_cost, cg_direction_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr

    n, size = p.numel(), p.element_size()
    lib = load("krylov_loop")
    code = dtype_code(storage, accum)
    beta = float((g_new / g).to(storage))
    n_sets = max(2, -(-3 * L2_BYTES // (2 * n * size)))
    sets = [(p.clone(), z.clone()) for _ in range(n_sets)]
    turn = itertools.cycle(sets)

    def raw():
        p_, z_ = next(turn)
        rc = lib.cg_direction_launch(code, p_.data_ptr(), z_.data_ptr(),
                                     g_new.data_ptr(), g.data_ptr(), n, 1, 0,
                                     0, stream_ptr(p_))
        require(rc == 0, f"cg_direction launch failed ({rc})")

    def rotating(fn):
        return lambda: fn(*next(turn))

    rep = timing_report(
        torch, f"cg_direction @pressure {sname}",
        rotating(lambda p_, z_: cg_direction(p_, z_, g_new, g)),
        rotating(lambda p_, z_: cg_direction_plain(p_, z_, g_new, g)),
        cg_direction_cost(n, size),
        library=rotating(lambda p_, z_: torch.add(z_, p_, alpha=beta)),
        dtype=sname, raw=raw)
    rep["eager_pair_ms"] = time_ms(torch, rotating(
        lambda p_, z_: z_ + (g_new / g).to(storage) * p_))
    rep["l2_rotation"] = n_sets
    print(f"    the eager pair it replaces (z + beta.to(z.dtype) * p): "
          f"{rep['eager_pair_ms']:.4f} ms; every call on the next of "
          f"{n_sets} (p, z) copies")
    del sets, turn
    slot = report["cg_direction"]
    if storage == torch.float64:
        slot.update(rep)
    else:
        slot[sname] = rep

    # the axpy kernel alone: in place (the loop's) against out of place
    fns = {"out of place": axpy_launcher(torch, load("krylov_fused"), vecs,
                                         alpha, accum),
           "in place": axpy_inplace_launchers(torch, vecs, alpha, accum)[1]}
    times = {k: [] for k in fns}
    for k in ("out of place", "in place", "in place", "out of place"):
        times[k].append(time_ms(torch, fns[k]))
    means = {k: sum(v) / len(v) for k, v in times.items()}
    slot = report["axpy_precond"]
    if storage != torch.float64:
        slot = slot[sname]
    slot["inplace_alone"] = {"alone_ms": times, "mean_ms": means}
    print(f"    axpy_precond alone, in turns: out of place "
          f"{' '.join(f'{t:.4f}' for t in times['out of place'])}, in place "
          f"{' '.join(f'{t:.4f}' for t in times['in place'])} ms")


# phase 3, the CG iteration's scalar tail: (lanes, partials a lane) — one
# 210^3 pressure system, a cohort of three, the full mesh's 30 shards
# (308,700 rows each); and the lane states each lane count goes through
TAIL_CELLS = ((1, 36176), (3, 36176), (30, 1206), (3, 7))
TAIL_STATES = ("running", "converging", "capped", "nan", "frozen")
TAIL_MAXITER = 50


def tail_operands(torch, dev, acc, lanes, npl, shift, gen) -> dict:
    """The tail kernels' operands for ``lanes`` lanes of ``npl`` partials
    (a cohort's runs 128 elements apart), lane ``l`` in state
    ``TAIL_STATES[(l + shift) % 5]``: converging lanes get their ``r.r``
    sum as the threshold, capped lanes ``k = maxiter - 1``, NaN lanes a
    NaN partial in every run, frozen lanes a False flag."""
    from repro_torch.kernels.krylov_loop.krylov_loop import (
        lane_tree_sums_plain)

    stride = npl if lanes == 1 else -(-npl // 128) * 128
    size = lanes * stride

    def rnd(positive=False):
        v = torch.randn(size, generator=gen, device=dev, dtype=torch.float64)
        return (v.abs() + 0.1 if positive else v).to(acc)

    part = {"dot": rnd(True), "rz": rnd(True), "rr": rnd(True),
            "npl": npl, "stride": stride}
    states = [TAIL_STATES[(lane + shift) % 5] for lane in range(lanes)]
    rr_sum = lane_tree_sums_plain(part["rr"], npl, stride, lanes)
    thr = 0.5 * rr_sum
    k = torch.zeros(lanes, dtype=torch.int32, device=dev)
    active = torch.ones(lanes, dtype=torch.bool, device=dev)
    for lane, st in enumerate(states):
        if st == "converging":
            thr[lane] = rr_sum[lane]
        elif st == "capped":
            k[lane] = TAIL_MAXITER - 1
        elif st == "nan":
            for key in ("dot", "rz", "rr"):
                part[key][lane * stride + npl // 2] = float("nan")
        elif st == "frozen":
            active[lane] = False
    gamma = torch.rand(lanes, generator=gen, device=dev,
                       dtype=torch.float64).to(acc) + 0.5
    return {"part": part, "states": states, "thr": thr, "k": k,
            "active": active, "gamma": gamma}


def tail_runs(torch, o, plain=False) -> list:
    """``cg_alpha`` then ``cg_advance`` (guarded, with the partials) on
    fresh copies of ``o``'s carry, outputs starting at 7.0 (an unwritten
    lane shows), or their plain versions; returns every output."""
    from repro_torch.kernels.krylov_loop.krylov_loop import (
        cg_advance, cg_advance_plain, cg_alpha, cg_alpha_plain)

    alpha_fn, adv_fn = ((cg_alpha_plain, cg_advance_plain) if plain
                        else (cg_alpha, cg_advance))
    part, gamma = o["part"], o["gamma"]
    pAp, alpha, g_new, rr, rr_new, beta = (torch.full_like(gamma, 7.0)
                                           for _ in range(6))
    g, k, active = gamma.clone(), o["k"].clone(), o["active"].clone()
    alpha_fn(part["dot"], part["npl"], part["stride"], pAp, g, alpha, active)
    adv_fn(g, g_new, rr, rr_new, k, active, o["thr"], TAIL_MAXITER,
           beta=beta, part=part)
    torch.cuda.synchronize()
    return [pAp, alpha, g, g_new, rr, rr_new, beta, k, active]


def check_tail(torch, dev, report: dict) -> None:
    """Phase 3c: ``cg_alpha`` and ``cg_advance`` (the CG iteration's scalar
    tail, one cluster a lane) bitwise their plain versions for f64 and f32
    partials, at 1, 3 and 30 lanes with every lane state of
    :data:`TAIL_STATES` at every lane count, two runs bitwise equal, the
    launch counters (``cg_alpha`` once, ``cg_advance`` once in each lane
    that ran), then :func:`time_tail`."""
    from repro_torch.kernels.device_counts import (SLOTS, device_counts,
                                                   launched)

    gen = torch.Generator(device=dev).manual_seed(17)
    counts = device_counts(dev)
    for acc in (torch.float64, torch.float32):
        aname = str(acc).removeprefix("torch.")
        for lanes, npl in TAIL_CELLS:
            checks = {"vs_plain": True, "repeat": True, "counted": True}
            for shift in range(len(TAIL_STATES)):
                o = tail_operands(torch, dev, acc, lanes, npl, shift, gen)
                counts.zero_()
                with no_plain_versions():
                    got = tail_runs(torch, o)
                read = launched(counts.tolist(), lanes)
                again = tail_runs(torch, o)
                want = tail_runs(torch, o, plain=True)
                checks["vs_plain"] &= all(same_bits(torch, a, b)
                                          for a, b in zip(got, want))
                checks["repeat"] &= all(same_bits(torch, a, b)
                                        for a, b in zip(got, again))
                any_on = bool(o["active"].any())
                checks["counted"] &= (read["cg_alpha"] == int(any_on)
                                      and read["cg_advance"] == int(any_on)
                                      and sum(read[k] for k in SLOTS
                                              if k not in ("cg_alpha",
                                                           "cg_advance"))
                                      == 0)
            print(f"  [3c] cg_alpha + cg_advance {aname:7s} lanes={lanes:2d} "
                  f"npl={npl}: " + ", ".join(f"{k} {v}"
                                             for k, v in checks.items()))
            require(all(checks.values()), f"the tail kernels are wrong at "
                                          f"{aname}, {lanes} lanes: {checks}")
    for name in ("cg_alpha", "cg_advance"):
        report.setdefault(name, {})["max_abs_err"] = 0.0
    for acc in (torch.float64, torch.float32):
        time_tail(torch, dev, report, acc)


def time_tail(torch, dev, report: dict, acc) -> None:
    """The tail kernels at the 210^3 pressure system's 36,176 partials a
    run, one lane: each wrapper in the loop's guarded form, the kernel
    alone (raw launches), its plain version, and the library calls it
    replaced (its ``library_ms``) — ``torch.sum`` + ``torch.div`` for
    ``cg_alpha``, two ``torch.sum`` for ``cg_advance`` — as CUDA-event
    times of 20 calls after 3, and the wrapper and the library calls as nodes of a captured graph
    (``node_ms``, ``library_node_ms``)."""
    from repro_torch.kernels._build import dtype_code, load
    from repro_torch.kernels.device_counts import count_ptr
    from repro_torch.kernels.krylov_loop.krylov_loop import (
        cg_advance, cg_advance_cost, cg_advance_plain, cg_alpha,
        cg_alpha_cost, cg_alpha_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr

    aname = str(acc).removeprefix("torch.")
    npl = TAIL_CELLS[0][1]
    gen = torch.Generator(device=dev).manual_seed(19)
    o = tail_operands(torch, dev, acc, 1, npl, 0, gen)
    part, lib, code = o["part"], load("krylov_loop"), dtype_code(acc, acc)
    size = torch.finfo(acc).bits // 8
    one = lambda v: torch.full((1,), v, dtype=acc, device=dev)  # noqa: E731
    pAp, alpha, gamma = one(1.0), one(1.0), one(2.0)
    flag = torch.ones(1, dtype=torch.bool, device=dev)
    g, g_new, rr, rr_new, beta = (one(1.0) for _ in range(5))
    thr, k = one(0.0), torch.zeros(1, dtype=torch.int32, device=dev)
    s = stream_ptr(pAp)

    def alpha_wrapper():
        cg_alpha(part["dot"], npl, npl, pAp, gamma, alpha, flag)

    def alpha_raw():
        rc = lib.cg_alpha_launch(code, part["dot"].data_ptr(), npl, npl,
                            pAp.data_ptr(), gamma.data_ptr(),
                            alpha.data_ptr(), 1, flag.data_ptr(),
                            count_ptr("cg_alpha", dev, flag), s)
        require(rc == 0, f"cg_alpha launch failed ({rc})")

    def alpha_library():
        torch.div(gamma, torch.sum(part["dot"], dim=0, out=pAp[0]), out=alpha)

    def adv_wrapper():
        cg_advance(g, g_new, rr, rr_new, k, flag, thr, 2 ** 30, beta=beta,
                   part=part)

    def adv_raw():
        rc = lib.cg_advance_launch(code, g.data_ptr(), g_new.data_ptr(),
                              rr.data_ptr(), rr_new.data_ptr(), k.data_ptr(),
                              flag.data_ptr(), thr.data_ptr(), 2 ** 30,
                              beta.data_ptr(), part["rz"].data_ptr(),
                              part["rr"].data_ptr(), npl, npl, 1,
                              count_ptr("cg_advance", dev, flag), s)
        require(rc == 0, f"cg_advance launch failed ({rc})")

    def adv_sums():
        torch.sum(part["rz"], dim=0, out=g_new[0])
        torch.sum(part["rr"], dim=0, out=rr_new[0])

    rows = {
        "cg_alpha": (alpha_wrapper, alpha_raw, lambda: cg_alpha_plain(
            part["dot"], npl, npl, pAp, gamma, alpha, flag),
            alpha_library, cg_alpha_cost(npl, 1, size)),
        "cg_advance": (adv_wrapper, adv_raw, lambda: cg_advance_plain(
            g, g_new, rr, rr_new, k, flag, thr, 2 ** 30, beta=beta,
            part=part), adv_sums, cg_advance_cost(npl, 1, size))}
    for name, (wrap, raw, plain, library, cost) in rows.items():
        rep = timing_report(torch, f"{name} {aname} npl={npl}", wrap, plain,
                            cost, library=library, dtype=aname, raw=raw)
        rep["node_ms"] = graph_node_ms(torch, wrap)
        rep["library_node_ms"] = graph_node_ms(torch, library)
        require(bool(flag.all()), f"{name}: the timed lane stopped")
        print(f"    {name} {aname}: as graph nodes {rep['node_ms']:.4f} ms, "
              f"the library calls it replaced "
              f"{rep['library_node_ms']:.4f} ms")
        slot = report.setdefault(name, {})
        if acc == torch.float64:
            slot.update(rep)
        else:
            slot[aname] = rep


FOLD_LANES = 3     # phase 3: lanes of the fold's cohort check
FOLD_KS = (0, 1, 2)  # counts: the first direction, then both parities


def fold_operands(torch, inputs, storage, accum, lanes=1):
    """The fold's operands from phase 3's inputs at ``storage``: bands,
    ``z``, a direction pair (both buffers filled), ``gamma_new``,
    ``gamma`` and ``beta = gamma_new / gamma`` per lane (accum)."""
    dev = inputs["x"].device
    pair = torch.stack((inputs["p"], inputs["Ap"])).to(storage)
    g_new = torch.linspace(0.37, 0.61, lanes, dtype=torch.float64,
                           device=dev).to(accum)
    g = torch.linspace(0.91, 1.07, lanes, dtype=torch.float64,
                       device=dev).to(accum)
    if lanes == 1:
        g_new, g = g_new.reshape(()), g.reshape(())
    return {"bands": inputs["bands"].to(storage),
            "z": inputs["r"].to(storage), "pair": pair, "g_new": g_new,
            "g": g, "beta": g_new / g}


def unfused_launches(torch, o, k: int, offsets, plane, accum):
    """The pair the fold replaces, as kernel launches on one system: the
    direction ``z`` (k = 0) or ``cg_direction`` on a copy of the pair's
    buffer ``k % 2``, then ``spmv_dot_partials``; returns ``(p', A p',
    partials)``."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        spmv_dot_partials)
    from repro_torch.kernels.krylov_loop.krylov_loop import cg_direction

    p = o["pair"][k % 2].clone()
    if k == 0:
        p.copy_(o["z"])
    else:
        cg_direction(p, o["z"], o["g_new"], o["g"])
    y, part = spmv_dot_partials(o["bands"], p, offsets=offsets, plane=plane,
                                accum_dtype=accum)
    return p, y, part


def check_fold(torch, dev, report: dict) -> None:
    """Phase 3's check of the direction update folded into the SpMV+dot
    (``spmv_dot_direction``), for every dtype pair at the three shapes and
    the counts 0, 1 and 2: the new direction, ``A p'`` and the partials
    bitwise its plain version and the unfused launches it replaces
    (``cg_direction`` then ``spmv_dot``), unguarded and under a True flag,
    nothing written under a False one, the other buffer of the pair
    untouched; at the momentum and ragged shapes a cohort of
    ``FOLD_LANES`` lanes at the counts 0, 1, 2 bitwise the plain version
    and each lane's launch alone.  Then, at the pressure shape, the fold
    timed (:func:`time_fold`)."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        spmv_dot_direction, spmv_dot_direction_plain)

    gen = torch.Generator(device=dev).manual_seed(20)
    on = torch.ones((), dtype=torch.bool, device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    report["spmv_dot_direction"] = {"max_abs_err": 0.0}
    for label, P, m, nx, plane in shapes():
        inputs = make_inputs(torch, P, m, gen, dev)
        offsets = offsets_for(nx, plane)
        kw = dict(offsets=offsets, plane=plane)
        for storage, accum in policy_pairs():
            sname = str(storage).removeprefix("torch.")
            o = fold_operands(torch, inputs, storage, accum)
            same = {}
            for k in FOLD_KS:
                kk = torch.tensor(k, dtype=torch.int32, device=dev)
                new, y_w, part_w = spmv_dot_direction_plain(
                    o["bands"], o["z"], o["pair"], o["beta"], kk,
                    accum_dtype=accum, **kw)
                p_u, y_u, part_u = unfused_launches(torch, o, k, offsets,
                                                    plane, accum)
                torch.cuda.synchronize()
                same[f"k={k} plain vs unfused"] = (
                    torch.equal(new, p_u) and torch.equal(y_w, y_u)
                    and torch.equal(part_w, part_u))
                for tag, flag in (("unguarded", None), ("active", on),
                                  ("idle", off)):
                    pair = o["pair"].clone()
                    y, part = (torch.full_like(t, 7.0) for t in (y_w, part_w))
                    spmv_dot_direction(o["bands"], o["z"], pair, o["beta"],
                                       kk, accum_dtype=accum, out=(y, part),
                                       active=flag, **kw)
                    torch.cuda.synchronize()
                    if flag is off:
                        same[f"k={k} idle writes nothing"] = (
                            torch.equal(pair, o["pair"])
                            and bool((y == 7.0).all())
                            and bool((part == 7.0).all()))
                        continue
                    same[f"k={k} {tag}"] = (
                        torch.equal(pair[(k + 1) % 2], new)
                        and torch.equal(pair[k % 2], o["pair"][k % 2])
                        and torch.equal(y, y_w) and torch.equal(part, part_w))
                    if label == "pressure" and storage == torch.float64:
                        err = compare(torch, (pair[(k + 1) % 2], y, part),
                                      (new, y_w, part_w))[0]
                        slot = report["spmv_dot_direction"]
                        slot["max_abs_err"] = max(slot["max_abs_err"], err)
                del pair, y, part, new, y_w, part_w, p_u, y_u, part_u
            if P % FOLD_LANES == 0:
                same["lanes"] = fold_lanes_bitwise(torch, inputs, storage,
                                                   accum, kw)
            print(f"  bitwise {label:9s} {sname:8s}: spmv_dot_direction "
                  + ", ".join(f"{k} {v}" for k, v in same.items()))
            require(all(same.values()), f"spmv_dot_direction not bitwise at "
                                        f"{label} {sname}: {same}")
            if label == "pressure":
                time_fold(torch, report, sname, storage, accum, o, kw)
            del o
        del inputs
        torch.cuda.empty_cache()


def fold_lanes_bitwise(torch, inputs, storage, accum, kw) -> bool:
    """A cohort of ``FOLD_LANES`` lanes at the counts ``FOLD_KS`` under a
    True flag each: the pair, ``A p'`` and each lane's partials bitwise the
    plain version and the lane's launch alone."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        lane_partials, spmv_dot_direction, spmv_dot_direction_plain)
    from repro_torch.kernels.krylov_loop.krylov_loop import store_direction

    B = FOLD_LANES
    o = fold_operands(torch, inputs, storage, accum, B)
    dev = o["z"].device
    kk = torch.tensor(FOLD_KS, dtype=torch.int32, device=dev)
    flags = torch.ones(B, dtype=torch.bool, device=dev)
    pair = o["pair"].clone()
    y, part = spmv_dot_direction(o["bands"], o["z"], pair, o["beta"], kk,
                                 accum_dtype=accum, active=None, lanes=B,
                                 **kw)
    new, y_w, part_w = spmv_dot_direction_plain(
        o["bands"], o["z"], o["pair"], o["beta"], kk, accum_dtype=accum,
        lanes=B, **kw)
    pair_w = o["pair"].clone()
    store_direction(pair_w, new, kk, flags)
    ok = torch.equal(pair, pair_w) and torch.equal(y, y_w)
    P = o["bands"].shape[0] // B
    npl, stride = lane_partials(o["z"].numel(), B)
    for lane in range(B):
        rows = slice(lane * P, (lane + 1) * P)
        parts = slice(lane * stride, lane * stride + npl)  # a lane's run
        one = o["pair"][:, rows].clone()
        y1, part1 = spmv_dot_direction(
            o["bands"][rows].contiguous(), o["z"][rows].contiguous(), one,
            o["beta"][lane:lane + 1], kk[lane:lane + 1], accum_dtype=accum,
            **kw)
        ok = (ok and torch.equal(part[parts], part_w[parts])
              and torch.equal(one, pair[:, rows]) and torch.equal(y1, y[rows])
              and torch.equal(part1, part[parts]))
    torch.cuda.synchronize()
    return ok


def time_fold(torch, report, sname, storage, accum, o, kw) -> None:
    """Phase 3's times of the fold at the pressure shape (count 1: the
    update's arithmetic runs): the wrapper, its kernel alone (raw
    launches), the plain version, its floor (11 values a row), and in turns
    the kernel alone against the unfused pair it replaces, raw
    ``cg_direction`` then raw ``spmv_dot`` launches on the same operands
    (fold, pair, pair, fold).  The calls rotate through copies of ``z``
    and the pair, three times the 50 MB L2 in all (the bands stream past
    with an evict-first hint, so ``z`` and ``p`` could otherwise stay in
    L2 from one call to the next in bf16)."""
    from repro_torch.kernels._build import dtype_code, load
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        spmv_dot_direction, spmv_dot_direction_cost,
        spmv_dot_direction_plain, lane_partials)
    from repro_torch.kernels.spmv_dia.spmv_dia import (_offsets_arg,
                                                       stream_ptr)

    b, beta, g_new, g = o["bands"], o["beta"], o["g_new"], o["g"]
    P, nb, m = b.shape
    n, size = P * m, b.element_size()
    acc_size = torch.finfo(accum).bits // 8
    dev = b.device
    k1 = torch.ones((), dtype=torch.int32, device=dev)
    n_sets = max(2, -(-3 * L2_BYTES // (3 * n * size)))
    sets = [(o["z"].clone(), o["pair"].clone()) for _ in range(n_sets)]
    turn = itertools.cycle(sets)
    npl, _ = lane_partials(n, 1)
    y = torch.empty_like(o["z"])
    part = torch.empty(npl, dtype=accum, device=dev)
    code = dtype_code(storage, accum)
    fused_lib, loop_lib = load("krylov_fused"), load("krylov_loop")
    offs = _offsets_arg(kw["offsets"])

    def fold_raw():
        z, pair = next(turn)
        rc = fused_lib.spmv_dot_direction_launch(
            code, b.data_ptr(), z.data_ptr(), pair[0].data_ptr(),
            pair[1].data_ptr(), y.data_ptr(), part.data_ptr(),
            beta.data_ptr(), k1.data_ptr(), P, m, offs, nb, 1, npl, 0, 0,
            stream_ptr(z))
        require(rc == 0, f"spmv_dot_direction launch failed ({rc})")

    def pair_raw():
        z, pair = next(turn)
        rc = loop_lib.cg_direction_launch(
            code, pair[1].data_ptr(), z.data_ptr(), g_new.data_ptr(),
            g.data_ptr(), n, 1, 0, 0, stream_ptr(z))
        require(rc == 0, f"cg_direction launch failed ({rc})")
        rc = fused_lib.spmv_dot_launch(
            code, b.data_ptr(), pair[1].data_ptr(), y.data_ptr(),
            part.data_ptr(), P, m, offs, nb, 1, npl, stream_ptr(z))
        require(rc == 0, f"spmv_dot launch failed ({rc})")

    def rotating(fn):
        def call():
            z, pair = next(turn)
            return fn(z, pair)
        return call

    rep = timing_report(
        torch, f"spmv_dot_direction @pressure {sname}",
        rotating(lambda z, pair: spmv_dot_direction(
            b, z, pair, beta, k1, accum_dtype=accum, out=(y, part), **kw)),
        rotating(lambda z, pair: spmv_dot_direction_plain(
            b, z, pair, beta, k1, accum_dtype=accum, **kw)),
        spmv_dot_direction_cost(nb, n, size, acc_size), dtype=sname,
        raw=fold_raw)
    turns = {"fold": [], "pair": []}
    for k in ("fold", "pair", "pair", "fold"):
        turns[k].append(time_ms(torch, fold_raw if k == "fold"
                                else pair_raw))
    means = {k: sum(v) / len(v) for k, v in turns.items()}
    rep.update(alone_in_turns_ms=turns, alone_mean_ms=means,
               l2_rotation=n_sets,
               pair_floor_ms=(12 * n * size + npl * acc_size)
               / HBM_BYTES_PER_S * 1e3)
    print(f"    alone in turns (fold, pair, pair, fold): fold "
          f"{' '.join(f'{t:.4f}' for t in turns['fold'])}, unfused pair "
          f"(cg_direction + spmv_dot) "
          f"{' '.join(f'{t:.4f}' for t in turns['pair'])} ms: fold / pair "
          f"{means['fold'] / means['pair']:.3f}; floors {rep['bound_ms']:.4f}"
          f" / {rep['pair_floor_ms']:.4f} ms; every call on the next of "
          f"{n_sets} (z, pair) copies")
    slot = report["spmv_dot_direction"]
    if storage == torch.float64:
        slot.update(rep)
    else:
        slot[sname] = rep
    del sets, turn


def time_kernels(torch, label, inputs, offsets, plane, pairs, report) -> None:
    """The Krylov kernels' times at ``label``'s shape (inputs far above the
    50 MB L2) for every (storage, accum) pair, the floor at that storage
    width: all three at the pressure shape (``report[kernel]`` for f64,
    ``report[kernel][storage name]`` for the others), the SpMV kernel and,
    in f64, the SpMV+dot at the momentum shape
    (``report[kernel]["momentum"]``, the same way).  The axpy kernel is
    timed in the in-place form the CG loop launches, the out-of-place form
    beside it (``out_of_place``)."""
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels._build import load
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        fused_axpy_precond_cost, spmv_dot_cost)
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       spmv_dia_cost)

    P, _, m = inputs["bands"].shape
    n = P * m
    for storage, accum in pairs:
        sname = str(storage).removeprefix("torch.")
        size, acc = (torch.finfo(t).bits // 8 for t in (storage, accum))
        costs = {
            "spmv_dia": spmv_dia_cost(7, n, size),
            "spmv_dot": spmv_dot_cost(7, n, 0, size,
                                      block_rows=KERNEL_BLOCK_ROWS,
                                      accum_itemsize=acc),
            "axpy_precond": fused_axpy_precond_cost(
                n, size, block_rows=KERNEL_BLOCK_ROWS, accum_itemsize=acc),
        }
        calls = kernel_calls(WRAPPERS, plain_versions(), inputs, offsets,
                             plane, storage, accum)
        if label != "pressure":
            calls = {k: calls[k] for k in (
                ("spmv_dia", "spmv_dot") if storage == torch.float64
                else ("spmv_dia",))}
        # the SpMV's yardstick: a torch.sparse CSR product in its dtype
        csr = csr_of_bands(torch, inputs["bands"].to(storage), offsets)
        x_flat = inputs["x"].to(storage).reshape(-1)
        for name, (k_fn, p_fn) in calls.items():
            if name == "axpy_precond":
                # the form the CG loop launches: x and r in place, into
                # fixed buffers; the out-of-place wrapper and kernel (off
                # the loop's path) are timed beside it for comparison
                vecs = [inputs[k].to(storage) for k in AXPY_OPERANDS]
                oop_fn = k_fn
                oop_raw = axpy_launcher(torch, load("krylov_fused"), vecs,
                                        inputs["alpha"], accum)
                k_fn, raw, part = axpy_inplace_launchers(
                    torch, vecs, inputs["alpha"], accum)
            else:
                raw = spmv_launcher(torch, name, inputs["bands"].to(storage),
                                    inputs["x"].to(storage), offsets, accum)
            rep = timing_report(
                torch, f"{name} @{label} {sname}", k_fn, p_fn, costs[name],
                (lambda: csr @ x_flat) if name == "spmv_dia" else None,
                dtype=sname, raw=raw)
            if name == "axpy_precond":
                rep["out_of_place"] = {
                    "ms": time_ms(torch, oop_fn),
                    "kernel_alone_ms": time_ms(torch, oop_raw)}
                print(f"    out of place (off the loop's path): wrapper "
                      f"{rep['out_of_place']['ms']:.4f} ms, alone "
                      f"{rep['out_of_place']['kernel_alone_ms']:.4f} ms")
                # the wrapper's two torch.sum of the partials, alone
                sums = lambda: (part[0].sum(), part[1].sum())  # noqa: E731
                rep["sums_ms"] = time_ms(torch, sums)
                rep["sums_host_us"] = host_us(torch, sums)
                print(f"    its two torch.sum of the partials: "
                      f"{rep['sums_ms']:.4f} ms, host_us "
                      f"{rep['sums_host_us']:.1f}")
            slot = report[name]
            if label != "pressure":
                slot = slot.setdefault(label, {})
            if storage == torch.float64:
                slot.update(rep)
            else:
                slot[sname] = rep
        del csr, x_flat, calls


def timing_report(torch, name, k_fn, p_fn, cost, library=None,
                  dtype="float64", raw=None) -> dict:
    """Kernel (wrapper), plain and library times (CUDA events) beside the
    bound, and the host's microseconds per wrapper call; with ``raw``, a
    launch of the kernel alone, its time too."""
    t_bytes = cost["bytes_accessed"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["flops"] / FLOPS_PER_S[dtype] * 1e3
    rep = {"ms": time_ms(torch, k_fn), "plain_ms": time_ms(torch, p_fn),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None if library is None else time_ms(torch, library),
           "bytes": cost["bytes_accessed"], "host_us": host_us(torch, k_fn)}
    alone = ""
    if raw is not None:
        rep["kernel_alone_ms"] = time_ms(torch, raw)
        rep["kernel_alone_host_us"] = host_us(torch, raw)
        alone = (f" kernel_alone_ms={rep['kernel_alone_ms']:.4f} "
                 f"(host_us {rep['kernel_alone_host_us']:.1f})")
    print(f"  {name:22s} ms={rep['ms']:.4f}{alone} "
          f"plain_ms={rep['plain_ms']:.4f} bound_ms={rep['bound_ms']:.4f} "
          f"({rep['bound_by']}, {rep['bytes']} B; "
          f"{rep['bound_ms'] / rep['ms']:.1%} of floor) "
          f"library_ms={rep['library_ms']} host_us={rep['host_us']:.1f}")
    return rep


def check_coef_update(torch, dev) -> dict:
    """The value-update gather on the real 210^3 plans: bitwise equal to
    its plain version (a gather does no arithmetic) for every dtype."""
    from repro_torch.core.repartition import plan_for_mesh
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.kernels._build import load
    from repro_torch.kernels.coef_update.coef_update import (
        coef_update_cost, coef_update_plain, coef_update_stacked)
    from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr

    mesh = CavityMesh.cube(N, PARTS)
    t0 = time.perf_counter()
    plans = {"pressure": plan_for_mesh(mesh, ALPHA),
             "momentum": plan_for_mesh(mesh, 1)}
    print(f"  coef_update: the two {N}^3 plans built in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(label, mesh.n_parts // plan.alpha, plan.sentinel + 1,
              plan.src_on(dev)) for label, plan in plans.items()]
    ragged = torch.randint(0, 1001, (777,), generator=gen, device=dev,
                           dtype=torch.int32)
    ragged[::7] = 1000  # the sentinel slot
    cases.append(("ragged", 3, 1001, ragged))
    rep = {}
    for label, n_c, n_buf, src in cases:
        buf64 = torch.rand((n_c, n_buf), generator=gen, dtype=torch.float64,
                           device=dev)
        buf64[:, -1] = 0.0
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            buf = buf64.to(dtype)
            got = coef_update_stacked(buf, src)
            want = coef_update_plain(buf, src)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            abs_err = float((got.double() - want.double()).abs().max())
            print(f"  coef_update   {label:9s} {str(dtype)[6:]:8s} "
                  f"({n_c}, {n_buf}) -> {tuple(got.shape)} "
                  f"max_abs_err={abs_err:.3e} bitwise={same}")
            require(same, f"coef_update differs from its plain version at "
                          f"{label} {dtype}")
            if label == "pressure" and dtype == torch.float64:
                rep["max_abs_err"] = abs_err
            del buf, got, want
        if label == "pressure":
            n_out = src.shape[0]
            src64 = src.long()
            out = torch.empty((n_c, n_out), dtype=buf64.dtype, device=dev)
            lib = load("coef_update")

            def raw():
                rc = lib.coef_update_launch(
                    buf64.element_size(), buf64.data_ptr(), src.data_ptr(),
                    out.data_ptr(), n_c, n_buf, n_out, stream_ptr(buf64))
                require(rc == 0, f"coef_update launch failed ({rc})")

            rep.update(timing_report(
                torch, "coef_update", lambda: coef_update_stacked(buf64, src),
                lambda: coef_update_plain(buf64, src),
                coef_update_cost(n_c, n_buf, n_out),
                library=lambda: torch.index_select(buf64, 1, src), raw=raw))
            rep["int64_index_select_ms"] = time_ms(
                torch, lambda: buf64.index_select(1, src64))
            print(f"    int64-index index_select (the update before the "
                  f"kernel) {rep['int64_index_select_ms']:.4f} ms")
            del src64
        del buf64
    return rep


def check_momentum_bands(torch, dev) -> dict:
    """The momentum-assembly kernel at the coarse (1 part) and fine (30
    parts) 210^3 shapes against its plain version."""
    from repro_torch.kernels._build import DTYPE_CODES, load
    from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr
    from repro_torch.kernels.stencil_assembly.stencil_assembly import (
        momentum_bands_cost, momentum_bands_plain, momentum_bands_stacked)

    nx, plane = N, N ** 2
    h = 0.1 / N
    kw = dict(nx=nx, plane=plane, vdt=h ** 3 / (0.5 * h))  # V/dt, dt = 0.5 h
    gen = torch.Generator(device=dev).manual_seed(2)
    rep = {}
    for label, P, m in (("pressure", PARTS // ALPHA, N ** 3 * ALPHA // PARTS),
                        ("momentum", PARTS, N ** 3 // PARTS)):
        faces64 = [torch.rand((P, m), generator=gen, dtype=torch.float64,
                              device=dev) * 2 - 1 for _ in range(7)]
        for dtype in (torch.float64, torch.float32):
            faces = [f.to(dtype) for f in faces64]
            got = momentum_bands_stacked(*faces, **kw)
            want = momentum_bands_plain(*faces, **kw)
            torch.cuda.synchronize()
            abs_err, rel = compare(torch, [got], [want])
            sname = str(dtype).removeprefix("torch.")
            ok = rel <= TOLERANCE[sname]
            print(f"  momentum_bands {label:9s} {sname:8s} ({P}, {m}) "
                  f"max_abs_err={abs_err:.3e} rel={rel:.3e} (tol "
                  f"{TOLERANCE[sname]:.0e}) bitwise={torch.equal(got, want)} "
                  f"{'ok' if ok else 'FAIL'}")
            require(ok, f"momentum_bands disagrees with its plain version at "
                        f"{label} {sname}: rel {rel:.3e}")
            if label == "pressure" and dtype == torch.float64:
                rep["max_abs_err"] = abs_err
            del faces, got, want
        if label == "pressure":
            out = torch.empty((P, 7, m), dtype=torch.float64, device=dev)
            lib = load("stencil_assembly")

            def raw():
                rc = lib.momentum_bands_launch(
                    DTYPE_CODES[(torch.float64, torch.float64)],
                    *(f.data_ptr() for f in faces64), out.data_ptr(), P, m,
                    nx, plane, float(kw["vdt"]), stream_ptr(out))
                require(rc == 0, f"momentum_bands launch failed ({rc})")

            rep.update(timing_report(
                torch, "momentum_bands",
                lambda: momentum_bands_stacked(*faces64, **kw),
                lambda: momentum_bands_plain(*faces64, **kw),
                momentum_bands_cost(P * m), raw=raw))
        del faces64
    return rep


# ---------------------------------------------------------------------------
# --compare: this tree's Krylov kernels beside another checkout's
# ---------------------------------------------------------------------------

def lane_abi(csrc) -> bool:
    """Whether a ``csrc`` directory's SpMV entry points take a lane count
    (this tree's) or not (trees from before the lane arguments)."""
    return "long long lanes" in (Path(csrc) / "spmv_dia.cu").read_text()


def single_lane_signatures() -> dict:
    """The entry points --compare launches, as trees before the lane
    arguments declare them."""
    import ctypes

    P, I64 = ctypes.c_void_p, ctypes.c_longlong
    dia = [ctypes.c_int, P, P, P, I64, I64, ctypes.POINTER(I64),
           ctypes.c_int, P]
    return {"spmv_dia": {"spmv_dia_launch": dia},
            "krylov_fused": {
                "spmv_dot_launch": dia[:4] + [P] + dia[4:],
                "axpy_precond_launch": [ctypes.c_int] + [P] * 11 + [I64, P]}}


def compare_builds(torch, dev, others: dict) -> dict:
    """This tree's three Krylov kernels beside those of each csrc directory
    in ``others`` (``{label: dir}``) on this card: each bitwise against the
    plain versions, then timed in turns (this tree, the others, the others
    in reverse, this tree) for every (storage, accum) pair: the two SpMV
    kernels at the pressure and momentum shapes, the axpy kernel (raw
    launches) at the pressure shape."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels._build import (BUILD_ROOT, build_sources,
                                            dtype_code, load, load_library)
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        axpy_precond_partials_plain, fused_axpy_precond_cost, spmv_dot_cost,
        spmv_dot_partials_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       _offsets_arg,
                                                       spmv_dia_cost,
                                                       stream_ptr)

    names = ("spmv_dia", "krylov_fused")
    kernels = ("spmv_dia", "spmv_dot", "axpy_precond")

    def build(label, csrc):
        csrc = Path(csrc)
        h = hashlib.sha256()
        for f in sorted(csrc.iterdir()):
            if f.suffix in (".cu", ".cuh"):
                h.update(f.name.encode() + f.read_bytes())
        out = BUILD_ROOT.parent / "compare" / f"{label}-{h.hexdigest()[:12]}"
        info = build_sources(csrc, names, out)
        lanes = lane_abi(csrc)
        sigs = None if lanes else single_lane_signatures()
        return ({n: load_library(out / f"lib{n}.so", n,
                                 None if sigs is None else sigs[n])
                 for n in names} | {"lanes": lanes}), info

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(len(others), 1)) as pool:
        built = dict(zip(others, pool.map(lambda kv: build(*kv),
                                          others.items())))
    print(f"  built {list(others)} in {time.perf_counter() - t0:.1f} s")
    libs = {"tree": {n: load(n) for n in names} | {"lanes": True}}
    for label, (lib, info) in built.items():
        libs[label] = lib
        for log in info["ptxas"].values():
            for fn, rec in ptxas_report(log).items():
                if base_name(fn) in NO_FRAME_KERNELS:
                    print_record(label, fn, rec)

    def spmv(lib, code, b, x, offsets):
        P, nb, m = b.shape
        y = torch.empty_like(x)
        lanes = (1,) if lib["lanes"] else ()
        rc = lib["spmv_dia"].spmv_dia_launch(
            code, b.data_ptr(), x.data_ptr(), y.data_ptr(), P, m,
            _offsets_arg(offsets), nb, *lanes, stream_ptr(x))
        require(rc == 0, f"spmv_dia launch failed ({rc})")
        return y

    def spmv_dot(lib, code, b, x, offsets, accum):
        P, nb, m = b.shape
        y = torch.empty_like(x)
        part = torch.empty(-(-P * m // KERNEL_BLOCK_ROWS), dtype=accum,
                           device=x.device)
        lanes = (1, part.numel()) if lib["lanes"] else ()
        rc = lib["krylov_fused"].spmv_dot_launch(
            code, b.data_ptr(), x.data_ptr(), y.data_ptr(), part.data_ptr(),
            P, m, _offsets_arg(offsets), nb, *lanes, stream_ptr(x))
        require(rc == 0, f"spmv_dot launch failed ({rc})")
        return y, part

    gen = torch.Generator(device=dev).manual_seed(0)
    order = list(libs) + list(libs)[::-1]
    result = {label: {k: {} for k in kernels} for label in libs}
    result["bound_ms"] = {k: {} for k in kernels}

    def in_turns(kernel, cell, fns, cost):
        bound = cost["bytes_accessed"] / HBM_BYTES_PER_S * 1e3
        result["bound_ms"][kernel][cell] = bound
        for label in order:
            t = time_ms(torch, fns[label])
            result[label][kernel].setdefault(cell, []).append(t)
        for label in libs:
            ts = result[label][kernel][cell]
            mean = sum(ts) / len(ts)
            print(f"  {kernel} {cell:18s} {label:12s} ms "
                  + " ".join(f"{t:.4f}" for t in ts)
                  + f" (mean {mean:.4f}; floor {bound:.4f} = "
                    f"{bound / mean:.1%})")

    for shape, P, m, nx, plane in shapes()[:2]:
        inputs = make_inputs(torch, P, m, gen, dev)
        offsets = offsets_for(nx, plane)
        n = P * m
        for storage, accum in policy_pairs():
            sname = str(storage).removeprefix("torch.")
            cell = f"{shape}/{sname}"
            code = dtype_code(storage, accum)
            b, x = inputs["bands"].to(storage), inputs["x"].to(storage)
            want = spmv_dot_partials_plain(b, x, offsets=offsets,
                                           plane=plane, accum_dtype=accum)
            for label, lib in libs.items():
                y = spmv(lib, code, b, x, offsets)
                y_dot, part = spmv_dot(lib, code, b, x, offsets, accum)
                torch.cuda.synchronize()
                check_spmv_bitwise(torch, f"{label}@{shape}", sname, y,
                                   y_dot, part, *want)
            size, acc_size = b.element_size(), torch.finfo(accum).bits // 8
            in_turns("spmv_dia", cell, {
                label: (lambda lib=lib: spmv(lib, code, b, x, offsets))
                for label, lib in libs.items()}, spmv_dia_cost(7, n, size))
            in_turns("spmv_dot", cell, {
                label: (lambda lib=lib: spmv_dot(lib, code, b, x, offsets,
                                                 accum))
                for label, lib in libs.items()},
                spmv_dot_cost(7, n, 0, size, block_rows=KERNEL_BLOCK_ROWS,
                              accum_itemsize=acc_size))
            del b, x, want
            if shape == "pressure":
                vecs = [inputs[k].to(storage) for k in AXPY_OPERANDS]
                want = axpy_precond_partials_plain(
                    *vecs, inputs["alpha"].to(accum), accum_dtype=accum)
                launch = {label: axpy_launcher(torch, lib["krylov_fused"],
                                               vecs, inputs["alpha"], accum)
                          for label, lib in libs.items()}
                for label, fn in launch.items():
                    got = fn()
                    torch.cuda.synchronize()
                    same = [torch.equal(g, w) for g, w in zip(got, want)]
                    print(f"  bitwise {label}@{shape} {sname:8s}: "
                          f"axpy_precond x', r', z, r.z and r.r partials "
                          f"{same}")
                    require(all(same), f"{label}'s axpy_precond is not "
                                       f"bitwise at {sname}: {same}")
                in_turns("axpy_precond", cell, launch,
                         fused_axpy_precond_cost(
                             n, size, block_rows=KERNEL_BLOCK_ROWS,
                             accum_itemsize=acc_size))
                del vecs, want, launch
        del inputs
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def timed_step(torch, solver, state, dt) -> dict:
    """One step walked phase by phase with synchronised wall timers."""
    from repro_torch.fvm.step_program import _bind

    prog = solver.program
    env = prog.seed(state, dt)
    walls = {}
    for ph in prog.phases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _bind(env, ph, ph.fn(*(env[k] for k in ph.inputs)))
        torch.cuda.synchronize()
        walls[ph.label] = time.perf_counter() - t0
    state, stats = prog.finalize(env)
    return {"walls": walls, "p_iters": stats.p_iters.tolist(),
            "mom_iters": int(stats.mom_iters), "state": state,
            "stats": stats}


def check_steps(torch, stats, tag: str) -> None:
    require(bool(stats.converged.all()), f"{tag}: a step did not converge")
    require(not bool(stats.diverged.any()), f"{tag}: a step diverged")
    cont = float(stats.continuity_err.max())
    require(cont < CONTINUITY, f"{tag}: continuity {cont:.3e} >= {CONTINUITY}")


def small_mesh_parity(torch) -> None:
    """The kernels' main path on a small mesh against the port on the CPU."""
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.fvm.piso import PisoSolver

    runs = {}
    for dev, backend in (("cuda", "fused"), ("cpu", "reference")):
        s = PisoSolver(CavityMesh.cube(8, 4), alpha=2, solver_backend=backend,
                       device=dev)
        state, stats = s.run(3, 2e-4)
        runs[dev] = (state, stats)
    (sg, tg), (sc, tc) = runs["cuda"], runs["cpu"]
    for f in sg._fields:
        a, b = getattr(sg, f).cpu(), getattr(sc, f)
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
        require(err <= PARITY, f"small mesh: {f} differs by {err:.3e}")
    require(torch.equal(tg.p_iters.cpu(), tc.p_iters)
            and torch.equal(tg.mom_iters.cpu(), tc.mom_iters),
            "small mesh: Krylov counts differ from the CPU run")
    print(f"  small mesh 8^3/4 parts/alpha 2: card == cpu within {PARITY:.0e}, "
          f"p_iters {tc.p_iters.tolist()}")


def rel_diff(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


# (wrapper module, plain version) of every kernel wrapper the step runs
PLAIN_VERSIONS = (
    ("spmv_dia", "spmv_dia_plain"), ("krylov_fused", "spmv_dot_plain"),
    ("krylov_fused", "spmv_dot_partials_plain"),
    ("krylov_fused", "fused_axpy_precond_plain"),
    ("krylov_fused", "axpy_precond_partials_plain"),
    ("coef_update", "coef_update_plain"),
    ("krylov_loop", "cg_direction_plain"), ("krylov_loop", "cg_advance_plain"),
    ("krylov_fused", "spmv_dot_direction_plain"),
    ("krylov_loop", "next_direction_plain"), ("krylov_loop", "store_direction"),
    ("krylov_loop", "current_direction"), ("krylov_loop", "cg_alpha_plain"),
    ("krylov_loop", "lane_tree_sums_plain"))


@contextlib.contextmanager
def no_plain_versions(cuda_only: bool = False):
    """Make every kernel wrapper's plain version raise inside the block:
    on the card the wrappers must launch their kernels.  ``cuda_only``:
    raise only when a plain version is given a CUDA tensor (a mesh's CPU
    positions run the plain versions on their own tensors)."""
    import importlib

    import torch

    # the wrapper modules (each package re-exports a function of its name);
    # an older tree, timed by a copy of this script, may lack a name
    mods = {}
    for m in {m for m, _ in PLAIN_VERSIONS}:
        try:
            mods[m] = importlib.import_module(f"repro_torch.kernels.{m}.{m}")
        except ModuleNotFoundError:
            continue
    saved = [(mods[m], name, getattr(mods[m], name))
             for m, name in PLAIN_VERSIONS
             if m in mods and hasattr(mods[m], name)]

    def refuse(name, fn):
        def plain(*args, **kwargs):
            if not cuda_only or any(
                    isinstance(a, torch.Tensor) and a.is_cuda
                    for a in (*args, *kwargs.values())):
                raise SmokeFailure(f"{name} ran on the card's path")
            return fn(*args, **kwargs)
        return plain

    try:
        for mod, name, fn in saved:
            setattr(mod, name, refuse(name, fn))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def refined_solves():
    """Each refined solve run while the block is open, by thread (a rank's
    thread ``rank<r>`` of a mesh over distinct devices, else
    ``MainThread``): ``(kind, passes, inner total)``, ``kind`` ``"cg"`` or
    ``"bicgstab"``; read around the solvers' refinement loop."""
    import threading

    from repro_torch.solvers import bicgstab, cg

    got, lock, orig = {}, threading.Lock(), cg.refine

    def recorded(ops, sweep, *args, **kwargs):
        out = orig(ops, sweep, *args, **kwargs)
        row = ("cg" if "_cg_" in sweep.__name__ else "bicgstab",
               int(out[5]), int(out[1]))
        with lock:
            got.setdefault(threading.current_thread().name, []).append(row)
        return out

    cg.refine = bicgstab.refine = recorded
    try:
        yield got
    finally:
        cg.refine = bicgstab.refine = orig


def require_launched(counts: dict, tag: str) -> None:
    require(all(counts[k] > 0 for k in STEP_KERNELS),
            f"{tag}: a kernel of the path was never launched: {counts}")


def main_path(torch) -> tuple:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.case import (build_parser, build_solver,
                                         run_transient)
    from repro_torch.solvers.ops import resolve_backend

    args = build_parser().parse_args(MAIN_ARGS)
    t0 = time.perf_counter()
    solver = build_solver(args)
    print(f"  setup {time.perf_counter() - t0:.2f} s, repartition plans "
          f"(host) {solver.plan_seconds:.2f} s")
    require(resolve_backend(solver.solver_backend, solver.device) == "fused",
            "the default backend does not resolve to fused on the card")
    dt = args.co * solver.mesh.h
    n = args.steps

    def steps(backend, state, n_steps, at=0):
        solver.solver_backend = backend
        return run_transient(
            solver, dt, n_steps, state=state,
            log=lambda line: print(f"  {backend} from step {at}: {line}"))

    # the main drive: the launcher's loop with the kernels, counters from 0
    from repro_torch.solvers.device_loop import (loop_records,
                                                 reset_loop_records)
    state0 = solver.initial_state()
    reset_launch_counts()
    reset_loop_records()
    state_f, stats_f, walls_f = steps("auto", state0, n)
    counts = launch_counts()
    records = loop_records()
    print(f"  kernel launches over {n} steps: {counts}")
    require(all(counts[k] > 0 for k in STEP_KERNELS),
            f"a kernel of the main path was never launched: {counts}")
    # a value update per system a step: the momentum and each corrector's
    # pressure system serially, the pressure matrix once when pipelined
    updates = 1 + (1 if solver.pipelined else solver.n_correctors)
    require(counts["coef_update"] == updates * n,
            f"the value update launched {counts['coef_update']} times in "
            f"{n} steps, not {updates} a step")
    cg_iters = int(stats_f.p_iters.sum())
    require(counts["spmv_dot_direction"] == counts["cg_alpha"]
            == counts["axpy_precond"] == counts["cg_advance"] == cg_iters
            and not any(counts[k] for k in UNFUSED_KERNELS),
            f"the CG kernels' launches {counts} are not the {cg_iters} CG "
            f"iterations the steps ran, with the direction update folded")
    loop = loop_summary(records)
    print(f"  device loop: {len(records)} sweeps, (iterations, blocks, host "
          f"reads, capture ms) {loop['sweeps']}")
    check_steps(torch, stats_f, "fused")
    counts_f = {"mom_iters": stats_f.mom_iters.tolist(),
                "p_iters": stats_f.p_iters.tolist()}
    require(counts_f == MAIN_COUNTS, f"Krylov counts {counts_f}, expected "
                                     f"{MAIN_COUNTS}")

    # determinism: the same steps again, one at a time, bitwise equal; the
    # per-step states feed the parity check below
    print("  determinism: the kernel run again, step by step")
    fused = [(state0, None)]
    for k in range(n):
        st, stt, _ = steps("auto", fused[-1][0], 1, at=k)
        fused.append((st, stt))
    same = all(torch.equal(getattr(state_f, f), getattr(fused[-1][0], f))
               for f in state_f._fields)
    for k in range(n):
        same = same and all(torch.equal(a[k], b[0])
                            for a, b in zip(stats_f, fused[k + 1][1]))
    require(same, "the repeated kernel run is not bitwise equal")
    print("  repeated run bitwise equal: True")

    # parity, step by step: the plain-PyTorch backend takes each step from
    # the kernel run's state (step 0 from the shared initial state)
    print("  parity: plain-PyTorch backend, each step from the kernel "
          "run's state")
    per_step, walls_r = [], []
    for k in range(n):
        st_r, stt_r, w = steps("reference", fused[k][0], 1, at=k)
        walls_r += w
        if k == 0:
            first_ref = (st_r, stt_r)
        st_f, stt_f = fused[k + 1]
        check_steps(torch, stt_r, f"reference step {k}")
        diffs = {f: rel_diff(getattr(st_f, f), getattr(st_r, f))
                 for f in st_f._fields if f != "phi_b"}
        per_step.append(diffs)
        print(f"  step {k}: max|d|/max over U, p, phi, phi_if: "
              + ", ".join(f"{v:.3e}" for v in diffs.values()))
        require(max(diffs.values()) <= PARITY,
                f"step {k}: fused vs reference differ by {diffs}")
        for f in ("mom_iters", "p_iters", "converged", "hit_cap"):
            require(torch.equal(getattr(stt_f, f)[0], getattr(stt_r, f)[0]),
                    f"step {k}: {f} differs between the backends")

    # free run of the plain backend from the initial state: reported, and
    # held to the solver tolerances (each BiCGStab answer is only within
    # mom_tol of the exact one, so two free runs that round differently
    # drift apart at about that level and not at round-off)
    st_r, stt_r = first_ref
    free_stats = [stt_r]
    for k in range(1, n):
        st_r, stt_r, _ = steps("reference", st_r, 1, at=k)
        free_stats.append(stt_r)
    free = {f: rel_diff(getattr(state_f, f), getattr(st_r, f))
            for f in ("U", "p")}
    free_iters = {f: [int(x) for s_ in free_stats
                      for x in getattr(s_, f).reshape(-1)]
                  for f in ("mom_iters", "p_iters")}
    print(f"  free run after {n} steps: max|dU|/max|U| {free['U']:.3e}, "
          f"max|dp|/max|p| {free['p']:.3e}; reference counts {free_iters}")
    for s_ in free_stats:
        check_steps(torch, s_, "reference free run")
    require(max(free.values()) <= FREE_RUN_DRIFT,
            f"free runs drift apart by {free}")

    small_mesh_parity(torch)

    solver.solver_backend = "auto"
    breakdown = timed_step(torch, solver, state_f, dt)
    cg_s = sum(v for k, v in breakdown["walls"].items()
               if k.startswith("solve_p"))
    print("  timed step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in breakdown["walls"].items())
        + f" s; p_iters {breakdown['p_iters']}")
    instrumented = instrumented_phase(torch, solver, state_f, dt, breakdown)
    summary = {
        "loop": loop, "instrumented": instrumented,
        "plan_s": solver.plan_seconds,
        "s_per_step_fused": walls_f, "s_per_step_reference": walls_r,
        "mom_iters": stats_f.mom_iters.tolist(),
        "p_iters": stats_f.p_iters.tolist(),
        "continuity": stats_f.continuity_err.tolist(),
        "launches": counts,
        "launches_per_step": {k: v / n for k, v in counts.items()},
        "ms_per_cg_iter": 1e3 * cg_s / sum(breakdown["p_iters"]),
        "timed_step_s": breakdown["walls"],
        "per_step_parity": per_step, "free_run_drift": free,
        "free_run_reference_iters": free_iters,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"  seconds per step (kernels) {[round(w, 3) for w in walls_f]}, "
          f"(plain) {[round(w, 3) for w in walls_r]}; "
          f"{int(stats_f.p_iters.sum())} CG iterations; "
          f"{summary['ms_per_cg_iter']:.4f} ms per CG iteration (timed step)")
    summary["loop_check"] = loop_phase(torch, solver, state_f, dt)
    summary["rebind"] = rebind_phase(torch, solver, state_f, dt, breakdown)
    summary["baseline"] = baseline_phase(torch, solver, state_f, dt)
    summary["precision"], f32_step = precision_phase(torch, solver, state_f,
                                                     dt, breakdown)
    return summary, state_f, breakdown, f32_step


def loop_summary(records) -> dict:
    """The device loop's records of a run: each sweep's (iterations,
    blocks, host reads, capture ms), every sweep's host reads held to
    ``ceil(iterations / K) + 4``, and on the card every sweep's guarded
    launches, as the kernels counted them on the device, held to
    :data:`LOOP_LAUNCHES` times its iterations."""
    for rec in records:
        bound = -(-rec.iters // rec.K) + 4
        require(rec.host_reads <= bound,
                f"a sweep of {rec.iters} iterations read the device "
                f"{rec.host_reads} times (bound {bound} at K = {rec.K})")
        if rec.device == "cuda" and rec.iters:
            want = {name: LOOP_LAUNCHES[rec.solver].get(name, 0) * rec.iters
                    for name in rec.launches}
            require(set(LOOP_LAUNCHES[rec.solver]) <= set(rec.launches)
                    and rec.launches == want,
                    f"a {rec.solver} sweep of {rec.iters} iterations counted "
                    f"the launches {rec.launches} on the device, not {want}")
    return {"sweeps": [(r.iters, r.blocks, r.host_reads,
                        round(1e3 * r.capture_s, 3)) for r in records],
            "host_reads": sum(r.host_reads for r in records),
            "capture_ms": 1e3 * sum(r.capture_s for r in records),
            "K": sorted({r.K for r in records})}


def instrumented_phase(torch, solver, state, dt, walk) -> dict:
    """``solver.timed_step`` (the instrumented executor: CUDA events at the
    phase boundaries, one synchronisation) beside the synchronised walk
    ``walk`` from the same state: the state bitwise equal, the
    PhaseBreakdown's total within 10 % of the walk's."""
    st, stats, pb = solver.timed_step(state, dt)
    walk_s = sum(walk["walls"].values())
    same = all(torch.equal(getattr(st, f), getattr(walk["state"], f))
               for f in st._fields)
    same = same and all(torch.equal(a, b) for a, b in zip(stats,
                                                          walk["stats"]))
    print(f"  instrumented timed_step: {pb} (total {pb.total:.4f} s against "
          f"the synchronised walk's {walk_s:.4f} s); bitwise equal {same}")
    require(same, "timed_step's state or stats differ from the walk's")
    require(abs(pb.total - walk_s) <= 0.1 * walk_s,
            f"the PhaseBreakdown total {pb.total:.4f} s is not within 10 % "
            f"of the walk's {walk_s:.4f} s")
    return {"breakdown": dataclasses.asdict(pb), "total_s": pb.total,
            "walk_s": walk_s}


@contextlib.contextmanager
def host_sweeps():
    """Inside the block the solvers run their former host loops
    (``_cg_sweep_host``, ``_bicgstab_sweep_host``): the plain version of
    the device loop."""
    from repro_torch.solvers import bicgstab as bi_mod
    from repro_torch.solvers import cg as cg_mod

    saved = cg_mod._cg_sweep, bi_mod._bicgstab_sweep
    cg_mod._cg_sweep = cg_mod._cg_sweep_host
    bi_mod._bicgstab_sweep = bi_mod._bicgstab_sweep_host
    try:
        yield
    finally:
        cg_mod._cg_sweep, bi_mod._bicgstab_sweep = saved


def env_before(solver, state, dt, name: str) -> dict:
    """The env of one step of ``solver`` from ``state``, walked up to its
    first phase called ``name``."""
    from repro_torch.fvm.step_program import _bind

    prog = solver.program
    env = prog.seed(state, dt, *solver._extras())
    for ph in prog.phases:
        if ph.name == name:
            break
        _bind(env, ph, ph.fn(*(env[k] for k in ph.inputs)))
    return env


def momentum_system(solver, state, dt):
    """The momentum ``(bands, sysM)`` of one step of ``solver`` from
    ``state``."""
    env = env_before(solver, state, dt, "solve_mom")
    return env["bandsM"], env["sysM"]


def synced(torch, fn):
    """``(fn(), seconds)``, the call between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_bits(torch, a, b) -> bool:
    """``a`` and ``b`` hold the same bits: ``torch.equal`` of their integer
    views, so a NaN matches a NaN of the same payload (``torch.equal``
    never does) and -0.0 does not match +0.0."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}
        a = a.view(ints[a.element_size()])
        b = b.view(ints[b.element_size()])
    return torch.equal(a, b)


def loop_vs_host(torch, tag, device_fn, host_fn) -> dict:
    """One sweep ``(x, rr, k)`` on the device loop (``device_fn``) and on
    the host loop (``host_fn``): ``x`` and ``rr`` bit for bit, the same
    count, every sweep's reads and device-counted launches held by
    :func:`loop_summary`."""
    from repro_torch.solvers import device_loop

    device_loop.reset_loop_records()
    with no_plain_versions():
        (x_d, rr_d, k_d), s_d = synced(torch, device_fn)
        recs = device_loop.loop_records()
        (x_h, rr_h, k_h), s_h = synced(torch, host_fn)
    same = (same_bits(torch, x_d, x_h)
            and same_bits(torch, rr_d.reshape(()), rr_h.reshape(()))
            and int(k_d) == int(k_h))
    summ = loop_summary(recs)
    print(f"  {tag}: {int(k_d)} iterations, x and r.r bitwise {same}; "
          f"device loop {s_d:.3f} s ({1e3 * s_d / max(int(k_d), 1):.4f}"
          f" ms/iter), host loop {s_h:.3f} s "
          f"({1e3 * s_h / max(int(k_h), 1):.4f} ms/iter); (iterations, "
          f"blocks, host reads, capture ms) {summ['sweeps']}")
    require(same, f"{tag}: the device loop differs from the host loop")
    return {"iters": int(k_d), "s": s_d, "host_s": s_h, **summ}


def solves_match(torch, res_d, res_h) -> tuple[dict, bool]:
    """Two solver results: their counts and flags side by side, and whether
    they agree bit for bit (``x`` and ``residual`` by :func:`same_bits`)."""
    fields = {f: (int(getattr(res_d, f)), int(getattr(res_h, f)))
              for f in ("iters", "outer_iters", "converged", "hit_cap")}
    same = (same_bits(torch, res_d.x, res_h.x)
            and same_bits(torch, res_d.residual, res_h.residual)
            and all(a == b for a, b in fields.values()))
    return fields, same


def refined_vs_host(torch, tag, solver, bands, b, x0, diag) -> dict:
    """A whole ``f32_ir`` pressure solve of the system ``(bands, b, x0,
    diag)``, its inner sweeps on the device loop and then on the host loop,
    bit for bit (:func:`solves_match`)."""
    from repro_torch.solvers import cg as cg_mod
    from repro_torch.solvers import device_loop
    from repro_torch.solvers.cg import cg

    solver.precision = "f32_ir"
    try:
        ops32 = solver._solver_ops(solver.plan_p, bands, diag)
    finally:
        solver.precision = "f64"
    device_loop.reset_loop_records()
    sweep, rr_in = cg_mod._cg_sweep, []

    def recorded(ops, rhs, *args, **kw):
        # each pass's correction system: its right-hand side's r.r
        rr_in.append(float(ops.dots((rhs, rhs))[0]))
        return sweep(ops, rhs, *args, **kw)

    with no_plain_versions():
        cg_mod._cg_sweep = recorded
        try:
            res_d, s_d = synced(torch, lambda: cg(
                ops32, b, x0, tol=solver.p_tol, maxiter=solver.p_maxiter))
        finally:
            cg_mod._cg_sweep = sweep
        summ = loop_summary(device_loop.loop_records())
        with host_sweeps():
            res_h, s_h = synced(torch, lambda: cg(
                ops32, b, x0, tol=solver.p_tol, maxiter=solver.p_maxiter))
    fields, same = solves_match(torch, res_d, res_h)
    finite = bool(torch.isfinite(res_d.x).all())
    print(f"  {tag}: (device, host) {fields}; x bitwise {same}, finite "
          f"{finite}; device loop {s_d:.3f} s "
          f"({1e3 * s_d / max(fields['iters'][0], 1):.4f} ms per inner "
          f"iteration), host loop {s_h:.3f} s; (iterations, blocks, host "
          f"reads, capture ms) {summ['sweeps']}; each pass's correction "
          f"r.r {[f'{v:.3e}' for v in rr_in]}")
    require(same, f"{tag}: the device loop differs from the host loop")
    return {"fields": fields, "s": s_d, "host_s": s_h, "x_finite": finite,
            "correction_rr": rr_in, **summ}


def loop_phase(torch, solver, state, dt) -> dict:
    """Phase 4's device-loop check at full size, from ``state``: the f64
    pressure CG sweep, the three f64 momentum BiCGStab sweeps and an
    ``f32_ir`` pressure solve (from ``state`` and from rest), each on the
    device loop and on the host loop with the kernels — ``x`` bitwise
    (:func:`same_bits`), identical counts and flags, the host reads of
    every sweep within ``ceil(iterations / K) + 4`` — then the
    f64 pressure sweep and one momentum sweep timed at K = 1, 2, 4, 8, 32
    and 128 (ms per iteration and capture ms)."""
    from repro_torch.solvers import device_loop
    from repro_torch.solvers.bicgstab import (_bicgstab_sweep,
                                              _bicgstab_sweep_host)
    from repro_torch.solvers.cg import _cg_sweep, _cg_sweep_host
    from repro_torch.solvers.cg import threshold_sq

    print(f"[4b] the device loop ({device_loop.ROUTE}, K = {device_loop.K}) "
          f"against the host loop, {N}^3, kernels")
    solver.solver_backend = "auto"
    out = {"route": device_loop.ROUTE, "K": device_loop.K}
    bands, b, x0, diag = pressure_system(solver, state, dt)
    ops = solver._solver_ops(solver.plan_p, bands, diag)
    (bb,) = ops.dots((b, b))
    thr_p = threshold_sq(bb, solver.p_tol, 0.0)
    bandsM, sysM = momentum_system(solver, state, dt)
    opsM = solver._solver_ops(solver.plan_mom, bandsM, sysM.diag)
    mom = []
    for c in range(3):
        bm = sysM.source[..., c].contiguous()
        (bbm,) = opsM.dots((bm, bm))
        mom.append((bm, state.U[..., c].contiguous(),
                    threshold_sq(bbm, solver.mom_tol, 0.0)))

    out["p_f64"] = loop_vs_host(
        torch, "f64 pressure CG sweep",
        lambda: _cg_sweep(ops, b, x0, thr_p, solver.p_maxiter),
        lambda: _cg_sweep_host(ops, b, x0, thr_p, solver.p_maxiter))
    for c, (bm, xm, thr_m) in enumerate(mom):
        out[f"mom_{c}"] = loop_vs_host(
            torch, f"f64 momentum BiCGStab sweep, component {c}",
            lambda: _bicgstab_sweep(opsM, bm, xm, thr_m, solver.mom_maxiter),
            lambda: _bicgstab_sweep_host(opsM, bm, xm, thr_m,
                                         solver.mom_maxiter))

    # an f32_ir pressure solve: the whole refinement loop, its inner sweeps
    # on the device loop and then on the host loop; from this state and
    # from rest (there the refinement diverges to NaN on both loops: the
    # check compares bits)
    out["p_f32_ir"] = refined_vs_host(torch, "f32_ir pressure solve", solver,
                                      bands, b, x0, diag)
    bands0, b0, x00, diag0 = pressure_system(solver, solver.initial_state(),
                                             dt)
    out["p_f32_ir_from_rest"] = refined_vs_host(
        torch, "f32_ir pressure solve from rest", solver, bands0, b0, x00,
        diag0)
    del bands0, b0, x00, diag0

    # K: the f64 pressure sweep and momentum component 0 at six lengths
    k0 = device_loop.K
    out["K_trial"] = {}
    try:
        for k_len in (1, 2, 4, 8, 32, 128):
            device_loop.K = {"cg": k_len, "bicgstab": k_len}
            ops.loops.clear()  # each length captures anew
            opsM.loops.clear()
            rec = {}
            for tag, fn in (
                    ("pressure", lambda: _cg_sweep(ops, b, x0, thr_p,
                                                   solver.p_maxiter)),
                    ("momentum", lambda: _bicgstab_sweep(
                        opsM, *mom[0][:2], mom[0][2], solver.mom_maxiter))):
                device_loop.reset_loop_records()
                (_, _, k), secs = synced(torch, fn)
                (r,) = device_loop.loop_records()
                rec[tag] = {"iters": int(k), "s": secs,
                            "ms_per_iter": 1e3 * secs / int(k),
                            "capture_ms": 1e3 * r.capture_s,
                            "host_reads": r.host_reads, "blocks": r.blocks}
            out["K_trial"][k_len] = rec
            print(f"  K = {k_len:3d}: " + "; ".join(
                f"{t} {v['ms_per_iter']:.4f} ms/iter ({v['iters']} iters, "
                f"capture {v['capture_ms']:.1f} ms, {v['host_reads']} reads)"
                for t, v in rec.items()))
    finally:
        device_loop.K = k0
    out["node_floor"] = node_floor(torch, ops, b, x0, thr_p,
                                   solver.p_maxiter)
    return out


NODE_GRAPH = 256   # launches in the graph that times one node alone


def graph_node_ms(torch, fn, n: int = NODE_GRAPH) -> float:
    """ms per node of a CUDA graph of ``n`` calls of ``fn``, replayed."""
    fn()  # loads the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(torch, graph.replay) / n


def node_floor(torch, ops, b, x0, thr, maxiter) -> dict:
    """The floor of a node like ``cg_advance`` (a cluster a lane) in the
    CG loop's captured block: the f64 pressure sweep at the loop's K with
    and without one more guarded node an iteration that does nothing
    (``cg_advance`` under a flag that stays False: it reads the flag and
    returns), in turns (without, with, with, without; each timed on its
    second sweep, the block already captured); the difference per
    iteration is what such a node costs in the block.  Then graphs of
    ``NODE_GRAPH`` nodes alone: the empty node and a running
    ``cg_advance`` on runs of one partial (the full mesh's form)."""
    from repro_torch.kernels.krylov_loop.krylov_loop import cg_advance
    from repro_torch.solvers import cg as cg_mod
    from repro_torch.solvers import device_loop

    dev = b.device
    idle = [torch.ones((), dtype=thr.dtype, device=dev) for _ in range(5)]
    k_idle = torch.zeros((), dtype=torch.int32, device=dev)
    never = torch.zeros((), dtype=torch.bool, device=dev)
    one = {"rz": torch.ones(1, dtype=thr.dtype, device=dev),
           "rr": torch.ones(1, dtype=thr.dtype, device=dev),
           "npl": 1, "stride": 1}
    body0 = cg_mod._cg_body

    def empty_node():
        cg_advance(*idle[:4], k_idle, never, idle[4], 1, part=one)

    def with_node(ops_, st, maxiter_):
        body = body0(ops_, st, maxiter_)

        def run(flag):
            body(flag)
            empty_node()
        return run

    ms = {"without": [], "with": []}
    iters = set()
    try:
        for tag in ("without", "with", "with", "without"):
            cg_mod._cg_body = with_node if tag == "with" else body0
            ops.loops.clear()
            cg_mod._cg_sweep(ops, b, x0, thr, maxiter)  # captures
            (_, _, k), secs = synced(torch, lambda: cg_mod._cg_sweep(
                ops, b, x0, thr, maxiter))
            iters.add(int(k))
            ms[tag].append(1e3 * secs / int(k))
    finally:
        cg_mod._cg_body = body0
        ops.loops.clear()
    require(len(iters) == 1, f"the node changed the iterations: {iters}")
    mean = {t: sum(v) / len(v) for t, v in ms.items()}
    sc = [torch.ones((), dtype=thr.dtype, device=dev) for _ in range(4)]
    thr0 = torch.zeros((), dtype=thr.dtype, device=dev)
    k_run = torch.zeros((), dtype=torch.int32, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    out = {"K": device_loop.K["cg"], "iters": iters.pop(),
           "ms_per_iter": ms, "node_ms_in_block": mean["with"]
           - mean["without"], "empty_node_ms": graph_node_ms(
               torch, empty_node),
           "advance_node_ms": graph_node_ms(
               torch, lambda: cg_advance(*sc, k_run, on, thr0, 2 ** 30,
                                         part=one))}
    print(f"  node floor: f64 pressure sweep ms/iter without "
          f"{' '.join(f'{t:.4f}' for t in ms['without'])}, with an empty "
          f"guarded node {' '.join(f'{t:.4f}' for t in ms['with'])}: "
          f"{out['node_ms_in_block']:.4f} ms a node in the block; graphs "
          f"of {NODE_GRAPH}: empty node {out['empty_node_ms']:.4f} ms, "
          f"cg_advance {out['advance_node_ms']:.4f} ms")
    return out


def rebind_phase(torch, solver, state, dt, alpha30) -> dict:
    """One step at half the main ratio (alpha 15) from ``state`` against
    the main ratio's step from it (``alpha30``: the timed step); then back
    to the main ratio, memoised."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.case import run_transient

    half = ALPHA // 2
    print(f"[7] rebind_alpha({half}) at full width")
    plan30, prog30, secs = solver.plan_p, solver.program, solver.plan_seconds
    solver.rebind_alpha(half)
    plan_s = solver.plan_seconds - secs
    rows = solver.mesh.n_cells_global * half // PARTS
    require(solver.n_coarse == PARTS // half
            and solver.plan_p.m_coarse == rows,
            f"alpha {half} did not give {PARTS // half} coarse parts of "
            f"{rows} rows")
    print(f"  alpha-{half} plan built in {plan_s:.2f} s (host)")
    reset_launch_counts()
    st, stt, walls = run_transient(
        solver, dt, 1, state=state,
        log=lambda line: print(f"  alpha {half}: {line}"))
    counts = launch_counts()
    check_steps(torch, stt, f"alpha {half}")
    ref_state, ref_stats = alpha30["state"], alpha30["stats"]
    diffs = {f: rel_diff(getattr(st, f), getattr(ref_state, f))
             for f in st._fields if f != "phi_b"}
    bitwise = all(torch.equal(getattr(st, f), getattr(ref_state, f))
                  for f in st._fields)
    print(f"  vs the alpha-{ALPHA} step from the same state: max|d|/max "
          f"over U, "
          f"p, phi, phi_if: " + ", ".join(f"{v:.3e}" for v in diffs.values())
          + f"; bitwise {bitwise}; launches {counts}")
    require(max(diffs.values()) <= PARITY,
            f"alpha {half} vs alpha {ALPHA} differ by {diffs}")
    for f in ("mom_iters", "p_iters", "converged", "hit_cap"):
        require(torch.equal(getattr(stt, f)[0], getattr(ref_stats, f)),
                f"alpha {half} vs alpha {ALPHA}: {f} differs")
    secs_half = solver.plan_seconds
    solver.rebind_alpha(ALPHA)
    require(solver.plan_p is plan30 and solver.program is prog30
            and solver.plan_seconds == secs_half,
            f"rebind_alpha({ALPHA}) rebuilt what it had bound")
    print(f"  rebind_alpha({ALPHA}): memoised plan, index and program, "
          "no build")
    return {"plan_s": plan_s, "step_s": walls[0], "diffs": diffs,
            "bitwise": bitwise, "p_iters": stt.p_iters[0].tolist(),
            "launches": counts}


def baseline_phase(torch, solver, state, dt) -> dict:
    """The refactoring baseline at full width against the plugin path."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.stencil_assembly import momentum_bands

    print("[8] refactoring baseline: momentum_bands vs assembly + update")
    mesh, asm, U = solver.mesh, solver.asm, state.U
    plan30 = solver.plan_p
    require(plan30.alpha == ALPHA, f"the solver is not bound to alpha "
                                   f"{ALPHA}")
    coarse = mesh.with_parts(mesh.n_parts // ALPHA)

    def plugin(plan):  # fine assembly, then the plan's value update
        phi, phi_if = asm.face_flux(U)
        sysM = asm.assemble_momentum(U, phi, phi_if, state.p, dt,
                                     phi_b=state.phi_b)
        return solver._bands(plan, sysM.diag, sysM.upper, sysM.lower,
                             sysM.iface)

    def refactored(m):
        return momentum_bands(U.reshape(m.n_parts, m.n_cells, 3), mesh=m,
                              nu=solver.nu, dt=dt)

    reset_launch_counts()
    pairs = {f"coarse ({coarse.n_parts} part) vs fine + alpha-{ALPHA} update":
             (refactored(coarse), plugin(plan30)),
             f"fine ({mesh.n_parts} parts) vs the step's bandsM":
             (refactored(mesh), plugin(solver.plan_mom))}
    torch.cuda.synchronize()
    counts = launch_counts()
    out = {"launches": counts}
    for label, (b, a) in pairs.items():
        require(b.shape == a.shape, f"{label}: shapes {b.shape} {a.shape}")
        err = (b - a).abs()
        ok = bool((err <= ASSEMBLY_PARITY * (1 + a.abs())).all())
        out[label] = {"max_abs_err": float(err.max()),
                      "bitwise": torch.equal(a, b)}
        print(f"  {label}: max_abs_err {out[label]['max_abs_err']:.3e} "
              f"bitwise {out[label]['bitwise']} (tol {ASSEMBLY_PARITY:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{label}: momentum_bands differs from the assembly")
    del pairs
    print(f"  launches: {counts}")
    require(counts["momentum_bands"] == 2 and counts["coef_update"] == 2,
            f"baseline launches {counts}")

    def wall(fn, n=3):  # best of n synchronised runs
        best = float("inf")
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    out["seconds"] = {
        "plugin main ratio (assemble + update)":
            wall(lambda: plugin(plan30)),
        "refactored coarse (momentum_bands)": wall(lambda: refactored(coarse)),
        "plugin alpha 1 (assemble + update)":
            wall(lambda: plugin(solver.plan_mom)),
        "refactored fine (momentum_bands)": wall(lambda: refactored(mesh)),
    }
    print("  seconds (best of 3, synchronised): " + ", ".join(
        f"{k} {v:.4f}" for k, v in out["seconds"].items()))
    return out


# ---------------------------------------------------------------------------
# phases 9-11: the precision policies, the channel, SIMPLE
# ---------------------------------------------------------------------------

def case_args(case: str, program: str = "piso") -> list:
    """The main path's launcher arguments for another case or program."""
    return MAIN_ARGS + ["--case", case, "--program", program]


def state_diffs(st, ref) -> dict:
    return {f: rel_diff(getattr(st, f), getattr(ref, f))
            for f in st._fields if f != "phi_b"}


def kernel_step(torch, solver, state, dt, tag: str, must_converge=True):
    """One step of ``solver`` from ``state`` with the kernels, the launch
    counters read from 0, no plain version allowed; unless
    ``must_converge`` is False, every solve converged and no cap hit."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.case import run_transient

    solver.solver_backend = "auto"
    reset_launch_counts()
    with no_plain_versions():
        st, stt, walls = run_transient(
            solver, dt, 1, state=state,
            log=lambda line: print(f"  {tag}: {line}"))
    counts = launch_counts()
    require_launched(counts, tag)
    if must_converge:
        check_steps(torch, stt, tag)
        require(not bool(stt.hit_cap.any()), f"{tag}: a solve hit its cap")
    return st, stt, walls[0], counts


def flags(stats) -> str:
    return ", ".join(f"{f} {bool(getattr(stats, f).all())}"
                     for f in ("converged", "diverged", "hit_cap"))


def precision_phase(torch, solver, state, dt, f64_step) -> tuple:
    """Phase 9: one f32_ir cavity step from ``state`` against the f64 step
    from it (``f64_step``: the timed step).  Returns its record and the
    step itself (the state on the host, the stats, the launches, the
    seconds and each refined solve's passes and inner total), 19c(a)'s
    card-alone reference."""
    print(f"[9] precision on the main path: f32_ir, {N}^3 cavity, "
          f"alpha {ALPHA}")
    require(solver.alpha == ALPHA, "the solver is not at the main ratio")
    solver.precision = "f32_ir"
    try:
        with refined_solves() as solves:
            st, stt, wall, counts = kernel_step(torch, solver, state, dt,
                                                "f32_ir")
    finally:
        solver.precision = "f64"
    ref_st, ref_stats = f64_step["state"], f64_step["stats"]
    diffs = state_diffs(st, ref_st)
    print(f"  vs the f64 step from the same state: max|dU|/max|U| "
          f"{diffs['U']:.3e}, max|dp|/max|p| {diffs['p']:.3e}; counts "
          f"f32_ir mom {int(stt.mom_iters[0])} p {stt.p_iters[0].tolist()}"
          f", f64 mom {int(ref_stats.mom_iters)} p "
          f"{ref_stats.p_iters.tolist()}; launches {counts}")
    step = {"state": type(st)(*(t.cpu() for t in st)),
            "stats": type(stt)(*(t[0] for t in stt)), "launches": counts,
            "s": wall, "solves": solves.get("MainThread", [])}
    return {"step_s": wall, "diffs_vs_f64": diffs, "launches": counts,
            "mom_iters": int(stt.mom_iters[0]),
            "p_iters": stt.p_iters[0].tolist(),
            "continuity": float(stt.continuity_err[0])}, step


def pressure_system(solver, state, dt):
    """The first corrector's ``(bands, b, x0, diag)`` of one step of
    ``solver`` from ``state``, in the coarse layout."""
    env = env_before(solver, state, dt, "solve_p")
    n_c = solver.n_coarse
    sysP = env["sysP"]
    return (env["bandsP"], sysP.source.reshape(n_c, -1),
            env["p"].reshape(n_c, -1), sysP.diag.reshape(n_c, -1))


def pressure_solves(torch, solver, system) -> dict:
    """The pressure system solved alone under each policy, kernels only,
    timed; the f64 replays of a refined solve are ``spmv_dia`` launches
    (1 for the initial residual, then 2 per outer pass: the inner
    sweep's first residual and the replay)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solvers.cg import cg
    from repro_torch.solvers.precision import POLICIES

    bands, b, x0, diag = system
    out = {}
    solver.solver_backend = "auto"
    for pol in POLICIES:
        solver.precision = pol
        try:
            ops = solver._solver_ops(solver.plan_p, bands, diag)
            reset_launch_counts()
            with no_plain_versions():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = cg(ops, b, x0, tol=solver.p_tol,
                         maxiter=solver.p_maxiter)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
        finally:
            solver.precision = "f64"
        counts = launch_counts()
        # ints and bools: a tree before the device loop returns them as
        # such, this one as 0-d tensors
        outer, inner = int(res.outer_iters), int(res.iters)
        converged, hit_cap = bool(res.converged), bool(res.hit_cap)
        rec = {"outer": outer, "inner": inner, "s": secs,
               "ms_per_inner": 1e3 * secs / max(inner, 1),
               "launches": counts, "converged": converged}
        out[pol] = rec
        print(f"  pressure solve alone, {pol:7s}: outer {outer}, "
              f"inner {inner}, {secs:.3f} s, "
              f"{rec['ms_per_inner']:.4f} ms per inner iteration, "
              f"converged {converged}, hit_cap {hit_cap}, residual "
              f"{float(res.residual):.3e}; launches {counts}")
        rec["residual"] = float(res.residual)
        require(pol not in MUST_CONVERGE or (converged and not hit_cap),
                f"the {pol} pressure solve did not converge")
        replays = 2 * outer + 1 if outer else 1
        # the SpMV+dot of a CG iteration: the fold since it exists (a copy
        # of this script times older trees)
        dot = ("spmv_dot_direction" if "spmv_dot_direction" in counts
               else "spmv_dot")
        require(counts["spmv_dia"] == replays
                and counts[dot] == counts["axpy_precond"] == inner,
                f"{pol}: launches {counts} for {outer} outer and "
                f"{inner} inner iterations")
    return out


def channel_phase(torch) -> dict:
    """Phase 10: the 210^3 channel under each policy (see the module
    docstring)."""
    from repro_torch.launch.case import build_parser, build_solver
    from repro_torch.solvers.precision import POLICIES

    print(f"[10] the {N}^3 channel, {PARTS} parts, alpha {ALPHA}: PISO "
          "under f64, f32_ir, bf16_ir")
    args = build_parser().parse_args(case_args("channel"))
    solver = build_solver(args)
    print(f"  plans (host) {solver.plan_seconds:.2f} s")
    dt = args.co * solver.mesh.h
    state0 = solver.initial_state()
    out = {"plan_s": solver.plan_seconds}
    runs = {}
    for pol in POLICIES:
        solver.precision = pol
        try:
            runs[pol] = kernel_step(torch, solver, state0, dt, pol,
                                    must_converge=pol in MUST_CONVERGE)
        finally:
            solver.precision = "f64"
    st64 = runs["f64"][0]
    for pol, (st, stt, wall, counts) in runs.items():
        rec = out[pol] = {"step_s": wall, "launches": counts,
                          "mom_iters": int(stt.mom_iters[0]),
                          "p_iters": stt.p_iters[0].tolist(),
                          "continuity": float(stt.continuity_err[0]),
                          "converged": bool(stt.converged.all()),
                          "hit_cap": bool(stt.hit_cap.any()),
                          "diverged": bool(stt.diverged.any())}
        print(f"  {pol}: {flags(stt)}; launches {counts}")
        if pol != "f64":
            rec["diffs_vs_f64"] = state_diffs(st, st64)
            print(f"  {pol} vs f64 from the same state: max|dU|/max|U| "
                  f"{rec['diffs_vs_f64']['U']:.3e}, max|dp|/max|p| "
                  f"{rec['diffs_vs_f64']['p']:.3e}")

    # the plain backend per policy from the same state
    for pol, (st, stt, _, _) in runs.items():
        solver.precision, solver.solver_backend = pol, "reference"
        try:
            st_r, stt_r, w_r = solver_step(torch, solver, state0, dt)
        finally:
            solver.precision, solver.solver_backend = "f64", "auto"
        converged = bool(stt.converged.all())
        if pol in MUST_CONVERGE or converged:
            check_steps(torch, stt_r, f"{pol} plain")
        diffs = state_diffs(st, st_r)
        bar = PARITY if pol == "f64" else FREE_RUN_DRIFT
        print(f"  {pol} kernels vs plain: max|d|/max over U, p, phi, phi_if "
              + ", ".join(f"{v:.3e}" for v in diffs.values())
              + f" (bar {bar:.0e}{'' if converged else ', not held: unconverged'}"
              f"); counts kernels mom "
              f"{int(stt.mom_iters[0])} p {stt.p_iters[0].tolist()}, plain "
              f"mom {int(stt_r.mom_iters[0])} p {stt_r.p_iters[0].tolist()}"
              f"; plain {flags(stt_r)}; plain step {w_r:.3f} s")
        require(not converged or max(diffs.values()) <= bar,
                f"channel {pol}: kernels vs plain differ by {diffs}")
        fields = ("converged", "diverged", "hit_cap") + (
            ("mom_iters", "p_iters") if pol == "f64" else ())
        for f in fields:
            require(torch.equal(getattr(stt, f), getattr(stt_r, f)),
                    f"channel {pol}: {f} differs between the backends")
        out[pol].update(plain_step_s=w_r, plain_diffs=diffs,
                        plain_mom_iters=int(stt_r.mom_iters[0]),
                        plain_p_iters=stt_r.p_iters[0].tolist())
    del runs
    out["pressure_solve"] = pressure_solves(
        torch, solver, pressure_system(solver, state0, dt))
    return out


def solver_step(torch, solver, state, dt):
    """One synchronised ``solver.step``: ``(state, stats, seconds)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, stt = solver.step(state, dt)
    torch.cuda.synchronize()
    return st, type(stt)(*(t[None] for t in stt)), time.perf_counter() - t0


def simple_phase(torch) -> dict:
    """Phase 11: SIMPLE on the 210^3 channel, 4 outer iterations."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.case import (build_parser, build_solver,
                                         run_steady)

    n_outer = 4
    print(f"[11] SIMPLE on the {N}^3 channel, alpha {ALPHA}: "
          f"run_steady(max_outer={n_outer})")
    args = build_parser().parse_args(case_args("channel", "simple"))
    solver = build_solver(args)
    dt = args.co * solver.mesh.h
    state0 = solver.initial_state()
    reset_launch_counts()
    with no_plain_versions():
        st, stats, n, wall = run_steady(
            solver, dt, n_outer, state=state0,
            log=lambda line: print(f"  {line}"))
    counts = launch_counts()
    require_launched(counts, "simple")
    require(n == n_outer and not bool(solver.program.converged(stats)),
            f"SIMPLE ran {n} outer iterations, not capped at {n_outer}")
    require(bool(stats.converged) and not bool(stats.diverged)
            and not bool(stats.hit_cap),
            "SIMPLE: a Krylov solve did not converge")
    print(f"  launches {counts}")

    # outer iteration by outer iteration: the same run, each state kept
    states, per_outer = [state0], []
    with no_plain_versions():
        for k in range(n_outer):
            s_k, t_k, w_k = solver_step(torch, solver, states[-1], dt)
            states.append(s_k)
            per_outer.append({
                "continuity": float(t_k.continuity_err[0]),
                "u_delta": float(t_k.u_delta[0]),
                "mom_iters": int(t_k.mom_iters[0]),
                "p_iters": t_k.p_iters[0].tolist(), "s": w_k, "stats": t_k})
            print(f"  outer {k}: continuity {per_outer[-1]['continuity']:.3e}"
                  f" u_delta {per_outer[-1]['u_delta']:.3e} mom_iters "
                  f"{per_outer[-1]['mom_iters']} p_iters "
                  f"{per_outer[-1]['p_iters']} ({w_k:.3f} s)")
    require(all(torch.equal(getattr(st, f), getattr(states[-1], f))
                for f in st._fields),
            "SIMPLE: the outer-by-outer replay is not bitwise run_steady's")

    # the plain backend from each of the kernel run's states
    solver.solver_backend = "reference"
    worst = 0.0
    try:
        for k in range(n_outer):
            s_r, t_r, w_r = solver_step(torch, solver, states[k], dt)
            diffs = state_diffs(states[k + 1], s_r)
            worst = max(worst, max(diffs.values()))
            t_k = per_outer[k].pop("stats")
            per_outer[k].update(plain_s=w_r, plain_diffs=diffs)
            print(f"  outer {k} plain: max|d|/max over U, p, phi, phi_if "
                  + ", ".join(f"{v:.3e}" for v in diffs.values())
                  + f"; p_iters {t_r.p_iters[0].tolist()} ({w_r:.3f} s)")
            require(max(diffs.values()) <= PARITY,
                    f"SIMPLE outer {k}: kernels vs plain differ by {diffs}")
            for f in ("mom_iters", "p_iters", "converged", "diverged",
                      "hit_cap"):
                require(torch.equal(getattr(t_k, f), getattr(t_r, f)),
                        f"SIMPLE outer {k}: {f} differs between backends")
    finally:
        solver.solver_backend = "auto"
    return {"run_steady_s": wall, "launches": counts,
            "per_outer": per_outer, "plain_parity": worst,
            "plan_s": solver.plan_seconds}


def step_timing(torch, repeats: int) -> dict:
    """The main path's first f64 step from rest, walked phase by phase
    ``repeats`` times after one untimed step: ms per pressure-CG
    iteration (the ``solve_p`` walls over their iterations); then phase
    10's first channel pressure system solved alone under each policy
    (ms per inner iteration)."""
    from repro_torch.launch.case import build_parser, build_solver

    args = build_parser().parse_args(MAIN_ARGS)
    solver = build_solver(args)
    dt = args.co * solver.mesh.h
    state0 = solver.initial_state()
    solver.step(state0, dt)  # loads the kernels; not timed
    ms, p_iters, step_s, mom_s = [], None, [], []
    for _ in range(repeats):
        bd = timed_step(torch, solver, state0, dt)
        require(p_iters in (None, bd["p_iters"]),
                f"the repeated step's counts changed: {bd['p_iters']}")
        p_iters = bd["p_iters"]
        cg_s = sum(v for k, v in bd["walls"].items()
                   if k.startswith("solve_p"))
        ms.append(1e3 * cg_s / sum(p_iters))
        step_s.append(sum(bd["walls"].values()))
        mom_s.append(bd["walls"]["solve_mom"])
    print(f"  step from rest, p_iters {p_iters}: ms per CG iteration "
          + " ".join(f"{t:.4f}" for t in ms) + "; s per step (walk) "
          + " ".join(f"{t:.4f}" for t in step_s) + "; solve_mom s "
          + " ".join(f"{t:.4f}" for t in mom_s))
    del solver, state0
    free_device(torch)
    args = build_parser().parse_args(case_args("channel"))
    solver = build_solver(args)
    solves = pressure_solves(torch, solver, pressure_system(
        solver, solver.initial_state(), args.co * solver.mesh.h))
    return {"ms_per_cg_iter": ms, "p_iters": p_iters, "step_s": step_s,
            "solve_mom_s": mom_s,
            "ms_per_inner": {pol: rec["ms_per_inner"]
                             for pol, rec in solves.items()},
            "src": str(ROOT)}


# kernel-name fragments of the pressure CG's device work, in the order a
# name is tried; elementwise kernels split by their mean time into vector
# (the p update) and scalar work
CG_PROFILE_PARTS = (("spmv_dot_direction", ("spmv_dot_direction_kernel",)),
                    ("spmv_dot", ("spmv_dot_kernel",)),
                    ("axpy_precond", ("axpy_precond",)),
                    ("cg_direction", ("cg_direction_kernel",)),
                    ("cg_alpha", ("cg_alpha_kernel",)),
                    ("cg_advance", ("cg_advance_kernel",)),
                    ("partial sums", ("reduce_kernel",)),
                    ("host read", ("Memcpy DtoH", "memcpy32_post",
                                   "Memcpy DtoD")))


def profile_cg(torch, iters: int, full_mesh: bool = False) -> dict:
    """The main path's first pressure system (the cavity from rest), CG
    capped at ``iters`` iterations under ``torch.profiler``: each kernel's
    device time per iteration, sorted into the parts of an iteration, and
    the device's idle share of the window (1 - the kernels' summed time
    over the window's wall).  ``full_mesh``: the solver of phase 15 (the
    system's rows as 30 shards on ``MESH_DEVICE``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.case import build_parser, build_solver
    from repro_torch.solvers.cg import cg

    fm = (["--solve-mode", "full_mesh", "--mesh-devices",
           ",".join([MESH_DEVICE] * PARTS)] if full_mesh else [])
    args = build_parser().parse_args(MAIN_ARGS + fm)
    solver = build_solver(args)
    bands, b, x0, diag = pressure_system(solver, solver.initial_state(),
                                         args.co * solver.mesh.h)
    ops = solver._solver_ops(solver.plan_p, bands, diag)
    cg(ops, b, x0, tol=solver.p_tol, maxiter=iters)  # loads and captures
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg(ops, b, x0, tol=solver.p_tol, maxiter=iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = int(res.iters)
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0))
        # device-side events only (a CPU op's device time repeats its
        # kernels')
        if dev_us and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            kernels[evt.key] = (dev_us, evt.count)
    parts = {}
    for name, (us, count) in kernels.items():
        part = next((p for p, keys in CG_PROFILE_PARTS
                     if any(k in name for k in keys)), None)
        if part is None:
            part = ("p update (vector elementwise)" if us / count > 10
                    else "scalar ops")
        parts[part] = parts.get(part, 0.0) + us / 1e3 / n
    busy = sum(us for us, _ in kernels.values()) / 1e6
    out = {"iters": n, "wall_ms_per_iter": 1e3 * wall / n,
           "device_ms_per_iter": parts, "busy_ms_per_iter": 1e3 * busy / n,
           "idle_share": 1 - busy / wall,
           "kernels": {k: {"us": us, "count": c}
                       for k, (us, c) in sorted(kernels.items(),
                                                key=lambda kv: -kv[1][0])}}
    print(f"  CG capped at {iters}: {n} iterations, "
          f"{out['wall_ms_per_iter']:.4f} ms per iteration (wall), device "
          f"busy {out['busy_ms_per_iter']:.4f} ms, idle share "
          f"{out['idle_share']:.1%}")
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"    {part:32s} {ms:.4f} ms per iteration")
    for k, v in list(out["kernels"].items())[:14]:
        print(f"    {v['count']:6d} x {k[:70]:70s} {v['us'] / 1e3:9.3f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 12: the control plane at 210^3
# ---------------------------------------------------------------------------
# the ratios of the sweep and of the adaptive run: every divisor of PARTS
SWEEP_ALPHAS = (1, 2, 3, 5, 6, 10, 15, 30)
# the adaptive run takes the 4th to the 6th step from rest at the main
# path's settings (cut from 6 steps to hold the whole script's time); the
# witness after it takes the 7th with both backends and at WITNESS_P_TOL
# (at its p_tol of 1e-10 the cavity's continuity error passes the 1e-6 bar
# at the 10th step, PERF.md)
ADAPTIVE_STEPS = 3
WITNESS_P_TOL = 1e-11
UPDATE_REPS = 20         # CUDA-event reps of one pressure value update
H2D_BYTES = 256 * 2 ** 20
SPEC_FACTOR = 2.0        # a shipped H100 field within 2x of this card's
# a sweep whose every part size keeps this share of the largest parts'
# rate per iteration is flat: it bounds the knee, dofs_sat, from above
FLAT_RATE = 0.95
# the backend crossover: (n, parts) cube meshes whose fine parts have about
# 512, 2048, 8192, 32768 and (the main path's) 308,700 rows, the pressure
# CG on them at alpha 1 for CROSSOVER_ITERS iterations
CROSSOVER_MESHES = ((16, 8), (32, 16), (64, 32), (128, 64), (N, PARTS))
CROSSOVER_ITERS = 50


def fit_line(xs, ys) -> tuple[float, float, float]:
    """Least-squares ``y = c0 + c1 x``: ``(c0, c1, standard error of
    c1)``."""
    x = [float(v) for v in xs]
    y = [float(v) for v in ys]
    n = len(x)
    mx, my = sum(x) / n, sum(y) / n
    sxx = sum((a - mx) ** 2 for a in x)
    c1 = sum((a - mx) * (b - my) for a, b in zip(x, y)) / sxx
    c0 = my - c1 * mx
    resid = sum((b - c0 - c1 * a) ** 2 for a, b in zip(x, y))
    se = (resid / max(n - 2, 1) / sxx) ** 0.5
    return c0, c1, se


def measured_spec(sweep: list, n_dofs: int, parts: int, spmv_bytes: float,
                  spmv_s: float, h2d_bytes: float, h2d_s: float) -> dict:
    """What each measured field of the ``H100`` spec stands for, from this
    run (``src/repro_torch/core/cost_model.py`` says how each is read).

    ``sweep``: per alpha ``alpha``, ``rows`` per coarse part, ``assembly_s``
    (the step's assembly phase), ``update_s`` (one pressure value update
    alone) and ``ms_per_iter`` (the pressure CG).  Returns ``{field:
    (value, kind)}``, kind ``"value"`` (a rate measured), ``"fitted"``
    (the model solved for the field from a measured time) or, where the
    measurement only bounds the field from above, ``"at most"``.
    """
    from repro_torch.core.cost_model import CostModel as M

    bytes_per_dof, flops_per_dof = (M.assembly_bytes_per_dof,
                                    M.assembly_flops_per_dof)
    c0, c1, se = fit_line([r["alpha"] for r in sweep],
                          [r["update_s"] for r in sweep])
    # the model's bytes of one update (CostModel.t_repartition)
    update_bytes = (M.nnz_per_row + 1) * n_dofs * M.bytes_per_val
    assembly = sorted(r["assembly_s"] for r in sweep)[len(sweep) // 2]
    host_bw = bytes_per_dof * n_dofs * (0.001 + 1 / parts) / assembly
    # the ms per iteration at the largest parts is the saturated rate; a
    # flat sweep puts the knee at or below its smallest parts, else the
    # model's law (efficiency = sqrt(rows / dofs_sat)) places it
    top = max(sweep, key=lambda r: r["rows"])
    share = [(r["rows"], min(1.0, top["ms_per_iter"] / r["ms_per_iter"]))
             for r in sweep]
    if all(s >= FLAT_RATE for _, s in share):
        sat = (min(rows for rows, _ in share), "at most")
    else:
        sat = (min(rows / s ** 2 for rows, s in share), "fitted")
    resolved = c1 > 2 * se
    return {
        "hbm_bw": (spmv_bytes / spmv_s, "value"),
        "link_bw": (update_bytes / c0, "value"),
        "msg_latency": ((c1, "value") if resolved
                        else (max(c1, 0.0) + 2 * se, "at most")),
        "host_bw": (host_bw, "fitted"),
        "host_flops": (host_bw * flops_per_dof / bytes_per_dof, "fitted"),
        "dofs_sat": sat,
        "h2d_bw": (h2d_bytes / h2d_s, "value"),
    }


def check_spec(measured: dict, shipped) -> list:
    """The fields of ``shipped`` (a HardwareSpec) off by more than
    SPEC_FACTOR from ``measured`` (:func:`measured_spec`): a measured or
    fitted value must lie within a factor SPEC_FACTOR either way, a field
    measured as "at most" a bound no higher than SPEC_FACTOR times the
    bound."""
    bad = []
    for field, (value, kind) in measured.items():
        ship = getattr(shipped, field)
        if kind == "at most":
            ok = 0.0 <= ship <= SPEC_FACTOR * value
        else:
            ok = value / SPEC_FACTOR <= ship <= SPEC_FACTOR * value
        if not ok:
            bad.append(f"{field}: shipped {ship:.4g}, measured {kind} "
                       f"{value:.4g}")
    return bad


def crossover_rows(points: list) -> int | None:
    """The smallest part size (rows) from which the kernels are no slower
    than plain PyTorch at every larger size measured; ``points`` holds
    ``(rows, kernel ms per iteration, plain ms per iteration)``.  None if
    the kernels lose at the largest size."""
    best = None
    for rows, fused, ref in sorted(points, reverse=True):
        if fused > ref:
            break
        best = rows
    return best


def update_alone_s(torch, solver, sysP) -> float:
    """Seconds of one pressure value update (the bound program's
    ``update_p`` phase) on the step's system ``sysP``, CUDA events over
    UPDATE_REPS calls."""
    fn = next(ph.fn for ph in solver.program.phases if ph.name == "update_p")
    return time_ms(torch, lambda: fn(sysP), n=UPDATE_REPS) / 1e3


def alpha_sweep(torch, solver, state, dt, main_step, problems) -> list:
    """12a: one ``timed_step`` from ``state`` at every alpha of
    SWEEP_ALPHAS through ``rebind_alpha`` on the shared cache, alpha 30
    first; each held to the alpha-30 step (PARITY, identical counts and
    flags), the alpha-30 step bitwise the main path's timed step."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    sysP = env_before(solver, state, dt, "update_p")["sysP"]
    rows, ref = [], None
    for alpha in sorted(SWEEP_ALPHAS, reverse=True):
        secs = solver.plan_seconds
        solver.rebind_alpha(alpha)
        plan_s = solver.plan_seconds - secs
        reset_launch_counts()
        with no_plain_versions():
            st, stats, pb = solver.timed_step(state, dt)
        counts = launch_counts()
        iters = int(stats.p_iters.sum())
        rec = {"alpha": alpha, "rows": solver.plan_p.m_coarse,
               "n_coarse": solver.n_coarse, "plan_s": plan_s,
               "assembly_s": pb.assembly, "update_phase_s": pb.update,
               "halo_s": pb.halo, "solve_s": pb.solve, "total_s": pb.total,
               "ms_per_iter": 1e3 * pb.solve / iters,
               "update_s": update_alone_s(torch, solver, sysP),
               "mom_iters": int(stats.mom_iters),
               "p_iters": stats.p_iters.tolist(),
               "launches": counts}
        if ref is None:
            ref = (st, stats)
            same = all(torch.equal(a, b) for a, b in
                       zip(tuple(st) + tuple(stats),
                           tuple(main_step["state"])
                           + tuple(main_step["stats"])))
            rec["bitwise_main_step"] = same
            if not same:
                problems.append(f"alpha {alpha} from the cache is not "
                                "bitwise the main path's timed step")
        diffs = state_diffs(st, ref[0])
        rec["diffs"] = diffs
        rec["same_counts"] = all(
            torch.equal(getattr(stats, f), getattr(ref[1], f))
            for f in ("mom_iters", "p_iters", "converged", "hit_cap"))
        if max(diffs.values()) > PARITY or not rec["same_counts"]:
            problems.append(
                f"alpha {alpha}: p_iters {rec['p_iters']} against "
                f"{ref[1].p_iters.tolist()}, max|d|/max {diffs}")
        if not all(counts[k] > 0 for k in STEP_KERNELS):
            problems.append(f"alpha {alpha}: a kernel of the step was never "
                            f"launched: {counts}")
        print(f"  alpha {alpha:2d}: {solver.n_coarse:2d} x {rec['rows']:>9,} "
              f"rows; plan {plan_s:.2f} s; assembly {pb.assembly:.4f} "
              f"update {pb.update:.4f} halo {pb.halo:.4f} solve "
              f"{pb.solve:.4f} total {pb.total:.4f} s; "
              f"{rec['ms_per_iter']:.4f} ms per CG iteration; one value "
              f"update {1e3 * rec['update_s']:.4f} ms; mom_iters "
              f"{rec['mom_iters']} p_iters {rec['p_iters']}; vs alpha "
              f"{SWEEP_ALPHAS[-1]}: max|d|/max "
              f"{max(diffs.values()):.3e}, counts and flags identical "
              f"{rec['same_counts']}")
        rows.append(rec)
    return rows


def spec_phase(torch, sweep, report) -> dict:
    """12b: each measured field of the ``H100`` spec beside the shipped
    constant; a field off by more than SPEC_FACTOR fails."""
    from repro_torch.core.cost_model import H100

    src = torch.empty(H2D_BYTES // 8, dtype=torch.float64, pin_memory=True)
    dst = torch.empty(src.shape, dtype=src.dtype, device="cuda")
    h2d_s = time_ms(torch, lambda: dst.copy_(src, non_blocking=True),
                    n=10, warmup=2) / 1e3
    del src, dst
    spmv = report["spmv_dia"]
    measured = measured_spec(sweep, N ** 3, PARTS, spmv["bytes"],
                             spmv["kernel_alone_ms"] / 1e3, H2D_BYTES, h2d_s)
    c0, c1, se = fit_line([r["alpha"] for r in sweep],
                          [r["update_s"] for r in sweep])
    print(f"  value update against alpha: {1e3 * c0:.4f} ms + "
          f"{1e6 * c1:.4f} us x alpha (standard error {1e6 * se:.4f} us)")
    for field, (value, kind) in measured.items():
        print(f"  {field:12s} {kind:8s} {value:.4g}, shipped "
              f"{getattr(H100, field):.4g}")
    print(f"  peak_flops   shipped {H100.peak_flops:.4g} (data sheet, not "
          f"measured); oversub_penalty {H100.oversub_penalty} (one process)")
    bad = check_spec(measured, H100)
    return {"measured": {f: v for f, (v, _) in measured.items()},
            "kinds": {f: k for f, (_, k) in measured.items()},
            "shipped": dataclasses.asdict(H100),
            "update_fit": {"c0_s": c0, "c1_s": c1, "se_s": se},
            "off": bad}


def adaptive_phase(torch, solver, state, dt, sweep, problems) -> dict:
    """12c: ADAPTIVE_STEPS steps from ``state`` through ``run_adaptive``,
    a controller over SWEEP_ALPHAS sampling every step from the static
    pick; every step converged, the step's kernels launched, and every
    plan served from the cache the sweep filled.  Then the witness of the
    next step (:func:`continuity_witness`) from the run's last state."""
    from repro_torch.core.controller import (ControllerConfig,
                                             RepartitionController)
    from repro_torch.core.cost_model import H100, CostModel
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.case import run_adaptive

    cache = solver.plan_cache
    model = CostModel(H100, n_dofs=N ** 3, fused_solver=True)
    ctl = RepartitionController(
        model, n_cpu=PARTS, n_gpu=1, alpha0=None,
        config=ControllerConfig(alphas=SWEEP_ALPHAS, sample_every=1),
        cache=cache, fixed_fine=True, pipelined=False)
    static = ctl.alpha
    fastest = min(sweep, key=lambda r: r["total_s"])["alpha"]
    misses, secs = cache.misses, solver.plan_seconds
    print(f"  static pick (cost model, H100 spec): alpha {static}; the "
          f"sweep's fastest step: alpha {fastest}; p_tol {solver.p_tol}")
    reset_launch_counts()
    with no_plain_versions():
        st, stats, windows = run_adaptive(
            solver, ctl, dt, ADAPTIVE_STEPS, ADAPTIVE_STEPS, state=state,
            log=lambda line: print(f"  adaptive: {line}"))
    counts = launch_counts()
    s = ctl.stats()
    trajectory = [w[3] for w in windows]
    print(f"  trajectory {trajectory}, final alpha {ctl.alpha}, switches "
          f"{s['switches']}, calibration scales {s['scales']}, cache "
          f"{s['cache']}; launches {counts}")
    try:
        check_steps(torch, stats, "adaptive run")
        require_launched(counts, "adaptive run")
    except SmokeFailure as e:
        problems.append(str(e))
    if cache.misses != misses or solver.plan_seconds != secs:
        problems.append(f"the adaptive run built plans: misses {misses} -> "
                        f"{cache.misses}")
    return {"static_pick": static, "sweep_fastest": fastest,
            "trajectory": trajectory, "stats": s, "launches": counts,
            "p_iters": stats.p_iters.tolist(),
            "continuity": stats.continuity_err.tolist(),
            "witness": continuity_witness(torch, solver, st, dt, problems)}


def continuity_witness(torch, solver, state, dt, problems) -> dict:
    """The next step from ``state`` (the 7th from rest): with the kernels
    and with plain PyTorch at the main path's ``p_tol``, held to each
    other (PARITY, identical counts and flags), so a continuity error
    above CONTINUITY there is the tolerance's and not the kernels'; and
    with the kernels at WITNESS_P_TOL, held below CONTINUITY."""
    tol = solver.p_tol
    runs = {}
    st, stt, wall, _ = kernel_step(torch, solver, state, dt, "kernels",
                                   must_converge=False)
    runs["kernels"] = (st, stt, wall)
    solver.solver_backend = "reference"
    try:
        runs["plain"] = solver_step(torch, solver, state, dt)
    finally:
        solver.solver_backend = "auto"
    solver.p_tol = WITNESS_P_TOL
    try:
        st, stt, wall, _ = kernel_step(torch, solver, state, dt, "tighter",
                                       must_converge=False)
    finally:
        solver.p_tol = tol
    runs["tighter"] = (st, stt, wall)
    out = {}
    for tag, (st, stt, wall) in runs.items():
        out[tag] = {"p_tol": WITNESS_P_TOL if tag == "tighter" else tol,
                    "continuity": float(stt.continuity_err[0]),
                    "mom_iters": int(stt.mom_iters[0]),
                    "p_iters": stt.p_iters[0].tolist(), "step_s": wall}
        print(f"  witness, next step, {tag} at p_tol {out[tag]['p_tol']}: "
              f"continuity {out[tag]['continuity']:.3e} (bar "
              f"{CONTINUITY:.0e}); mom {out[tag]['mom_iters']} p "
              f"{out[tag]['p_iters']}; {flags(stt)}; {wall:.3f} s")
        if not bool(stt.converged.all()) or bool(stt.diverged.any()):
            problems.append(f"witness {tag}: a solve did not converge")
    (st_k, stt_k, _), (st_p, stt_p, _) = runs["kernels"], runs["plain"]
    diffs = out["diffs"] = state_diffs(st_k, st_p)
    same = all(torch.equal(getattr(stt_k, f), getattr(stt_p, f))
               for f in ("mom_iters", "p_iters", "converged", "hit_cap"))
    print(f"  witness, kernels vs plain: max|d|/max over U, p, phi, phi_if "
          + ", ".join(f"{v:.3e}" for v in diffs.values())
          + f" (bar {PARITY:.0e}); counts and flags identical {same}")
    if max(diffs.values()) > PARITY or not same:
        problems.append(f"witness: kernels vs plain differ by {diffs}, "
                        f"counts and flags identical {same}")
    if out["tighter"]["continuity"] >= CONTINUITY:
        problems.append(f"witness: continuity {out['tighter']['continuity']:.3e}"
                        f" at p_tol {WITNESS_P_TOL}")
    return out


def crossover_phase(torch, solver, state, dt, problems) -> dict:
    """12d: the pressure CG for CROSSOVER_ITERS iterations with the kernels
    and with plain PyTorch at alpha 1 on each mesh of CROSSOVER_MESHES (the
    last is ``solver``'s, from ``state``): ms per iteration, and each
    mesh's rate per dof against the last's.  "auto" takes the kernels at
    every part size on the card, so they must win at every size."""
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.fvm.piso import PisoSolver
    from repro_torch.solvers.cg import cg

    points, dofs = [], []
    for n, parts in CROSSOVER_MESHES:
        if (n, parts) == (N, PARTS):
            s, st = solver, state
            s.rebind_alpha(1)
        else:
            s = PisoSolver(CavityMesh.cube(n, parts), alpha=1,
                           device=solver.device)
            st = s.initial_state()
        bands, b, x0, diag = pressure_system(s, st, 0.5 * s.mesh.h)
        ms = {}
        for backend in ("fused", "reference"):
            s.solver_backend = backend
            ops = s._solver_ops(s.plan_p, bands, diag)

            def solve():
                return cg(ops, b, x0, tol=0.0, maxiter=CROSSOVER_ITERS)

            times = []
            with (no_plain_versions() if backend == "fused"
                  else contextlib.nullcontext()):
                solve()  # captures the loop's block; not timed
                for _ in range(3):
                    res, secs = synced(torch, solve)
                    times.append(secs)
            if int(res.iters) != CROSSOVER_ITERS:
                problems.append(f"crossover {n}^3/{parts}: {backend} ran "
                                f"{int(res.iters)} iterations")
            ms[backend] = 1e3 * sorted(times)[1] / CROSSOVER_ITERS
        s.solver_backend = "auto"
        rows = s.plan_p.m_coarse
        points.append((rows, ms["fused"], ms["reference"]))
        dofs.append(n ** 3)
        print(f"  {n}^3 / {parts} parts, {rows:,} rows a part: kernels "
              f"{ms['fused']:.4f}, plain PyTorch {ms['reference']:.4f} ms "
              f"per CG iteration")
        if s is not solver:
            del s, st, bands, b, x0, diag, ops
            free_device(torch)
    # the kernels' rate per dof on each mesh against the largest's: how
    # far below saturation the whole card runs at that size
    full = points[-1][1] / dofs[-1]
    rate = [full / (p[1] / d) for p, d in zip(points, dofs)]
    print("  kernels' rate per dof against the " + f"{N}^3 mesh's: " + ", ".join(
        f"{d:,} dofs {r:.3f}" for d, r in zip(dofs, rate)))
    read = crossover_rows(points)
    smallest = min(p[0] for p in points)
    print(f"  the kernels win from {read} rows a part (smallest measured "
          f"{smallest}); \"auto\" takes them at every size on the card")
    if read != smallest:
        problems.append(f"plain PyTorch beats the kernels below {read} "
                        f"rows a part, where \"auto\" takes the kernels: "
                        f"{points}")
    return {"points": points, "dofs": dofs, "rate_vs_largest": rate,
            "kernels_win_from_rows": read}


def control_phase(torch, state, main_step, report) -> dict:
    """Phase 12 (see the module docstring): from ``state`` (the main
    path's after its steps), a fresh 210^3 cavity solver at the main ratio
    with one PlanCache and the kernels."""
    from repro_torch.core.controller import PlanCache
    from repro_torch.launch.case import build_parser, build_solver

    print(f"[12] control at {N}^3: alpha sweep, the H100 spec, the adaptive "
          f"run, the backend crossover")
    args = build_parser().parse_args(MAIN_ARGS)
    cache = PlanCache()
    # at alpha 1 (the momentum plan serves the pressure too), so the sweep
    # times the build of every other alpha's plan, alpha 30's included
    solver = build_solver(args, alpha=1, plan_cache=cache)
    print(f"  [12a] alpha sweep; the alpha-1 plan built at setup in "
          f"{solver.plan_seconds:.2f} s")
    dt = args.co * solver.mesh.h
    problems = []
    out = {"alpha1_plan_s": solver.plan_seconds,
           "sweep": alpha_sweep(torch, solver, state, dt, main_step,
                                problems)}
    built = cache.misses
    secs = solver.plan_seconds
    for alpha in SWEEP_ALPHAS:
        solver.rebind_alpha(alpha)
    print(f"  revisiting every alpha: cache {cache.stats()}")
    if built != len(SWEEP_ALPHAS) or cache.misses != built \
            or solver.plan_seconds != secs:
        problems.append(f"the cache missed {cache.misses} times "
                        f"(built {built}) over {len(SWEEP_ALPHAS)} ratios")
    out["cache_after_sweep"] = cache.stats()
    print("  [12b] the H100 spec against this card")
    out["spec"] = spec_phase(torch, out["sweep"], report)
    problems += [f"H100 spec {b}" for b in out["spec"]["off"]]
    print("  [12c] adaptive run")
    out["adaptive"] = adaptive_phase(torch, solver, state, dt, out["sweep"],
                                     problems)
    print("  [12d] backend crossover")
    out["crossover"] = crossover_phase(torch, solver, state, dt, problems)
    for p in problems:
        print(f"  FAILED: {p}")
    require(not problems, f"phase 12: {len(problems)} check(s) failed")
    return out


# ---------------------------------------------------------------------------
# phase 13: serving
# ---------------------------------------------------------------------------

LANES = 3                  # 13a: lanes of the lane kernels' cohort
SERVE_STEPS = 2            # 13b: steps of the 210^3 cohort and solo runs
SMALL_ARGS = ["--cfd-n", "64", "--parts", "16"]  # 13c, 13d: the mesh mix
SMALL_TENANTS, SMALL_STEPS, SMALL_CLASS = 8, 8, 16
ARRIVAL_ARGS = SMALL_ARGS + ["--sessions", "16", "--steps", "8",
                             "--arrival-rate", "50", "--lane-classes",
                             "--cases", "cavity,channel",
                             "--programs", "piso,simple", "--seed", "0"]
# the outputs of each lane kernel that are reduction partials (laid out per
# lane, lane_partials); the others are vectors split evenly into lanes, or
# (cg_alpha, cg_advance) one scalar per lane
LANE_PARTIALS = {"spmv_dot": (1,), "axpy_precond": (3, 4),
                 "spmv_dot_direction": (3,), "axpy_precond_k": (3, 4)}
LANE_KS = (0, 1, 2)  # 13a: the lanes' CG counts (the fold's parities)


def lane_inputs(torch, dev, storage, accum, P, m, gen, lanes):
    """``lanes`` lanes of (P, m) operands of every lane kernel at
    ``storage``, the per-lane scalars at ``accum``."""
    inp = make_inputs(torch, lanes * P, m, gen, dev)
    out = {k: inp[k].to(storage) for k in ("bands", "x") + AXPY_OPERANDS}
    k = torch.arange(lanes, dtype=torch.float64, device=dev)
    out.update(alpha=(0.3 + 0.1 * k).to(accum), g=(1.0 + k).to(accum),
               g_new=(0.5 + 0.25 * k).to(accum),
               pair=torch.stack((out["p"], out["Ap"])),
               kk=torch.tensor(LANE_KS[:lanes], dtype=torch.int32,
                               device=dev))
    out["beta"] = out["g_new"] / out["g"]
    return out


def lane_of(inp: dict, lane: int, lanes: int, P: int) -> dict:
    """Lane ``lane`` of :func:`lane_inputs` as one system's operands."""
    def one(k, v):
        if k == "pair":
            return v.reshape(2, lanes, -1)[:, lane].reshape(
                (2, P) + tuple(v.shape[2:]))
        if v.dim() == 1:
            return v[lane:lane + 1]
        return v.reshape(lanes, -1)[lane].reshape((P,) + tuple(v.shape[1:]))
    return {k: one(k, v) for k, v in inp.items()}


def lane_scalars(torch, inp, active):
    """cg_advance's operands: gamma, gamma_new, rr, rr_new, k, the flags
    and thr, one per lane."""
    g, gn = inp["g"], inp["g_new"]
    return [g.clone(), gn.clone(), g * 3, gn.clone(),
            torch.zeros(g.shape, dtype=torch.int32, device=g.device),
            active.clone(), g * 0.1]


def lane_runs(torch, inp, offsets, plane, accum, active, lanes, plain=False):
    """Every lane kernel once on copies of ``inp`` under the flags
    ``active`` (fresh outputs start at 7.0, so an unwritten lane shows);
    ``plain``: the plain versions, stored as the kernels store.  Returns
    ``{kernel: outputs}``."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        axpy_precond_inplace, axpy_precond_partials_plain, partials_buffers,
        spmv_dot_direction, spmv_dot_direction_plain, spmv_dot_partials,
        spmv_dot_partials_plain)
    from repro_torch.kernels.krylov_loop.krylov_loop import (
        cg_advance, cg_advance_plain, cg_alpha, cg_alpha_plain, cg_direction,
        cg_direction_plain, current_direction, store_direction)
    from repro_torch.kernels.spmv_dia.spmv_dia import (guarded_store,
                                                       spmv_dia_plain,
                                                       spmv_dia_stacked)

    b, x = inp["bands"], inp["x"]
    kw = dict(offsets=offsets, plane=plane, accum_dtype=accum)
    part = partials_buffers(x.numel(), accum, x.device, lanes=lanes)
    y, yd = torch.full_like(x, 7.0), torch.full_like(x, 7.0)
    dot, rz, rr = (part[k].fill_(7.0) for k in ("dot", "rz", "rr"))
    xs, rs, z = inp["x"].clone(), inp["r"].clone(), torch.full_like(x, 7.0)
    p = inp["p"].clone()
    # the fold, then the in-place axpy reading the direction it wrote
    pair, kk = inp["pair"].clone(), inp["kk"]
    fold = partials_buffers(x.numel(), accum, x.device, lanes=lanes)
    yf, dotf = torch.full_like(x, 7.0), fold["dot"].fill_(7.0)
    xk, rk, zk = inp["x"].clone(), inp["r"].clone(), torch.full_like(x, 7.0)
    rzk, rrk = fold["rz"].fill_(7.0), fold["rr"].fill_(7.0)
    # then the scalar tail on the fold's and the axpy's partials
    pa, al = torch.full_like(inp["g"], 7.0), torch.full_like(inp["g"], 7.0)
    sc = lane_scalars(torch, inp, active)
    beta = torch.full_like(inp["g"], 7.0)
    tail = (fold["dot"], fold["npl"], fold["stride"], pa, inp["g"], al,
            active)
    if plain:
        guarded_store(y, spmv_dia_plain(b, x, lanes=lanes, **kw), active)
        for dst, new in zip((yd, dot), spmv_dot_partials_plain(
                b, x, lanes=lanes, **kw)):
            guarded_store(dst, new, active)
        new = axpy_precond_partials_plain(
            xs, rs, inp["p"], inp["Ap"], inp["inv"], inp["alpha"],
            accum_dtype=accum)
        for dst, val in zip((xs, rs, z, rz, rr), new):
            guarded_store(dst, val, active)
        cg_direction_plain(p, inp["x"], inp["g_new"], inp["g"], active)
        new, yy, pp = spmv_dot_direction_plain(b, inp["r"], pair, inp["beta"],
                                               kk, lanes=lanes, **kw)
        store_direction(pair, new, kk, active)
        guarded_store(yf, yy, active)
        guarded_store(dotf, pp, active)
        for dst, val in zip((xk, rk, zk, rzk, rrk), axpy_precond_partials_plain(
                xk, rk, current_direction(pair, kk), inp["Ap"], inp["inv"],
                inp["alpha"], accum_dtype=accum)):
            guarded_store(dst, val, active)
        cg_alpha_plain(*tail)
        cg_advance_plain(*sc, 5, beta=beta, part=fold)
    else:
        kw.update(active=active, lanes=lanes)
        spmv_dia_stacked(b, x, out=y, **kw)
        spmv_dot_partials(b, x, out=(yd, dot), **kw)
        axpy_precond_inplace(xs, rs, inp["p"], inp["Ap"], inp["inv"],
                             inp["alpha"], z, rz, rr, accum_dtype=accum,
                             active=active, lanes=lanes)
        cg_direction(p, inp["x"], inp["g_new"], inp["g"], active)
        spmv_dot_direction(b, inp["r"], pair, inp["beta"], kk, out=(yf, dotf),
                           **kw)
        axpy_precond_inplace(xk, rk, pair, inp["Ap"], inp["inv"],
                             inp["alpha"], zk, rzk, rrk, accum_dtype=accum,
                             active=active, lanes=lanes, k=kk)
        cg_alpha(*tail)
        cg_advance(*sc, 5, beta=beta, part=fold)
        torch.cuda.synchronize()
    return {"spmv_dia": (y,), "spmv_dot": (yd, dot.clone()),
            "axpy_precond": (xs, rs, z, rz.clone(), rr.clone()),
            "cg_direction": (p,),
            "spmv_dot_direction": (pair[0], pair[1], yf, dotf.clone()),
            "axpy_precond_k": (xk, rk, zk, rzk.clone(), rrk.clone()),
            "cg_alpha": (pa, al), "cg_advance": tuple(sc) + (beta,)}


def lane_part(name: str, outs: tuple, lane: int, lanes: int,
              layout: tuple) -> list:
    """Lane ``lane``'s part of each output of lane kernel ``name``:
    ``layout`` is ``(partials per lane, stride)``."""
    npl, stride = layout
    return [t[lane * stride:lane * stride + npl]
            if i in LANE_PARTIALS.get(name, ()) else
            t.reshape(lanes, -1)[lane] for i, t in enumerate(outs)]


def lane_kernel_phase(torch, dev, problems: list) -> dict:
    """13a: each lane-extended kernel with ``LANES`` lanes at the momentum
    shape per lane, for every (storage, accum) pair: bitwise against its
    plain version and against one launch per lane alone, with every lane
    on and with lane 1's flag off (that lane unwritten); NaN in lane 1
    leaves the other lanes bitwise.  The kernel runs go with every plain
    version refusing; the plain runs come after."""
    from repro_torch.kernels.krylov_fused.krylov_fused import lane_partials

    _, P, m, nx, plane = shapes()[1]
    offsets = offsets_for(nx, plane)
    gen = torch.Generator(device=dev).manual_seed(13)
    B = LANES
    cohort = lane_partials(B * P * m, B)
    one = lane_partials(P * m, 1)
    out = {}
    for storage, accum in policy_pairs():
        sname = str(storage).removeprefix("torch.")
        inp = lane_inputs(torch, dev, storage, accum, P, m, gen, B)
        on = torch.ones(B, dtype=torch.bool, device=dev)
        off = on.clone()
        off[1] = False
        nan = dict(inp, x=inp["x"].clone(), bands=inp["bands"].clone())
        nan["x"].view(B, -1)[1] = float("nan")
        nan["bands"].view(B, -1)[1] = float("nan")
        with no_plain_versions():
            full = lane_runs(torch, inp, offsets, plane, accum, on, B)
            masked = lane_runs(torch, inp, offsets, plane, accum, off, B)
            solo = [lane_runs(torch, lane_of(inp, lane, B, P), offsets,
                              plane, accum, on[:1], 1) for lane in range(B)]
            poisoned = lane_runs(torch, nan, offsets, plane, accum, on, B)
        plain = lane_runs(torch, inp, offsets, plane, accum, on, B, True)
        plain_off = lane_runs(torch, inp, offsets, plane, accum, off, B,
                              True)
        untouched = lane_runs(torch, inp, offsets, plane, accum,
                              torch.zeros_like(on), B, True)
        row = {}
        for name in full:
            def same(a, b, lanes_=range(B)):
                return all(torch.equal(g, w) for lane in lanes_
                           for g, w in zip(
                               lane_part(name, a, lane, B, cohort),
                               lane_part(name, b, lane, B, cohort)))
            checks = {
                "vs_plain": same(full[name], plain[name])
                and same(masked[name], plain_off[name]),
                "vs_solo": all(
                    torch.equal(g, w) for lane in range(B)
                    for g, w in zip(
                        lane_part(name, full[name], lane, B, cohort),
                        lane_part(name, solo[lane][name], 0, 1, one))),
                "flag_off_unwritten": same(masked[name], untouched[name],
                                           [1]),
                "nan_mates_bitwise": same(poisoned[name], full[name],
                                          [0, 2])}
            row[name] = checks
            print(f"  [13a] {name:13s} {sname:8s} B={B}: "
                  + ", ".join(f"{k} {v}" for k, v in checks.items()))
            problems += [f"13a {name} {sname}: {k}"
                         for k, v in checks.items() if not v]
        out[sname] = row
        del inp, nan, full, masked, solo, poisoned, plain, plain_off
        del untouched
        torch.cuda.empty_cache()
    return out


def serve_args(extra: list, dev):
    """The serving launcher's args (``launch.serve``) on ``dev``."""
    from repro_torch.launch.serve import build_parser

    return build_parser().parse_args(extra + ["--device", str(dev)])


def lane_report(torch, got, want, stats_got, stats_want, tag, problems):
    """One lane against its solo run: fields within ``PARITY`` of each
    field's max, identical counts and flags, continuity below 1e-6 (for
    PISO); returns whether it is bitwise."""
    diffs = {f: rel_diff(getattr(got, f), getattr(want, f))
             for f in got._fields}
    same = {f: torch.equal(getattr(got, f), getattr(want, f))
            for f in got._fields}
    counts = all(torch.equal(getattr(stats_got, f), getattr(stats_want, f))
                 for f in ("mom_iters", "p_iters", "converged", "diverged",
                           "hit_cap"))
    bitwise = all(same.values()) and counts
    worst = max(diffs.values())
    if not worst <= PARITY:
        problems.append(f"{tag}: {worst:.3e} from its solo run")
    if not counts:
        problems.append(f"{tag}: counts or flags differ from its solo run "
                        f"({stats_got.mom_iters.tolist()}, "
                        f"{stats_got.p_iters.tolist()} against "
                        f"{stats_want.mom_iters.tolist()}, "
                        f"{stats_want.p_iters.tolist()})")
    return bitwise, worst


def full_width_phase(torch, dev, state3, problems, ends) -> dict:
    """13b: three tenants of the 210^3 cavity (the main path's settings,
    non-adaptive, pipeline "auto") from the main run's 3-step state with
    dt = 0.5 h (1, 1.1, 1.2), each path warmed by one untimed step:
    ``SERVE_STEPS`` steps through ``step_all`` (one cohort, one dispatch a
    window) against each tenant alone through ``step_session`` from the
    same state, with each run's device-loop sweeps; then one tenant's
    ``SERVE_STEPS`` steps with pipeline "on" against "off", each
    schedule's value updates counted exactly.  ``ends`` receives each
    tenant's cohort end state and last-step stats (phase 14's reference)."""
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.fvm.piso import PisoState, make_solver
    from repro_torch.serving.engine import SimulationEngine
    from repro_torch.solvers.device_loop import (loop_records,
                                                 reset_loop_records)

    mesh = CavityMesh.cube(N, PARTS)
    h = mesh.h
    eng = SimulationEngine(device=dev)
    kw = dict(alpha0=ALPHA, adaptive=False, p_tol=1e-10, p_maxiter=6000)
    sids = [f"t{i}" for i in range(3)]
    t0 = time.perf_counter()
    for i, sid in enumerate(sids):
        eng.open_session(sid, mesh, dt=0.5 * h * (1 + 0.1 * i), **kw)
    setup = time.perf_counter() - t0

    def start():
        for sid in sids:
            s = eng.sessions[sid]
            s.state = PisoState(*(t.clone() for t in state3))
            s.steps_done = 0
        eng.reset_stats()

    def loops():
        """The timed run's device-loop sweeps: count, iterations (the
        slowest lane's), host reads, capture ms."""
        recs = loop_records()
        return {"sweeps": len(recs), "iters": sum(r.iters for r in recs),
                "host_reads": sum(r.host_reads for r in recs),
                "capture_ms": 1e3 * sum(r.capture_s for r in recs)}

    out = {"setup_s": setup, "cohorts": [len(g) for g in
                                         eng.cohorts().values()]}
    # one untimed step as a cohort and alone warms both paths
    start()
    eng.step_all(1)
    start()
    for sid in sids:
        eng.step_session(sid, 1)
    start()
    reset_loop_records()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with no_plain_versions():
        last_c = eng.step_all(SERVE_STEPS)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    peak_c = torch.cuda.max_memory_allocated()
    loops_c = loops()
    cohort = {sid: eng.sessions[sid].state for sid in sids}
    ends.update({sid: (cohort[sid], last_c[sid]) for sid in sids})
    counters = dict(eng.counters)
    windows = -(-SERVE_STEPS // eng.scan_window)
    if counters["cohort_dispatches"] != windows or \
            counters["solo_dispatches"]:
        problems.append(f"13b: {counters} for {windows} window(s) of one "
                        f"cohort")
    start()
    solo, last_s, wall_s = {}, {}, 0.0
    reset_loop_records()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for sid in sids:
        t0 = time.perf_counter()
        with no_plain_versions():
            last_s[sid] = eng.step_session(sid, SERVE_STEPS)
        torch.cuda.synchronize()
        wall_s += time.perf_counter() - t0
        solo[sid] = eng.sessions[sid].state
    peak_s = torch.cuda.max_memory_allocated()
    loops_s = loops()
    lanes = {}
    for sid in sids:
        bitwise, worst = lane_report(torch, cohort[sid], solo[sid],
                                     last_c[sid], last_s[sid], f"13b {sid}",
                                     problems)
        cont = float(last_c[sid].continuity_err)
        if not cont < CONTINUITY:
            problems.append(f"13b {sid}: continuity {cont:.3e}")
        lanes[sid] = {"bitwise": bitwise, "max_rel": worst,
                      "continuity": cont,
                      "mom_iters": int(last_c[sid].mom_iters),
                      "p_iters": last_c[sid].p_iters.tolist()}
        print(f"  [13b] {sid}: cohort lane bitwise its solo run {bitwise} "
              f"(max rel {worst:.2e}), continuity {cont:.2e}, last step "
              f"mom_iters {lanes[sid]['mom_iters']} p_iters "
              f"{lanes[sid]['p_iters']}")
    steps = len(sids) * SERVE_STEPS
    out.update(lanes=lanes, counters=counters,
               cohort_steps_per_s=steps / wall_c,
               solo_steps_per_s=steps / wall_s, cohort_s=wall_c,
               solo_s=wall_s, peak_gb={"1": peak_s / 2 ** 30,
                                       "3": peak_c / 2 ** 30},
               loops={"solo": loops_s, "cohort": loops_c})
    print(f"  [13b] session-steps/s: solo {steps / wall_s:.4f} "
          f"({wall_s:.2f} s), cohort {steps / wall_c:.4f} ({wall_c:.2f} s), "
          f"ratio {wall_s / wall_c:.3f}; counters {counters}; "
          f"max_memory_allocated 1 tenant {peak_s / 2 ** 30:.2f} GiB, 3 "
          f"tenants {peak_c / 2 ** 30:.2f} GiB")
    print(f"  [13b] device loops (sweeps, iterations, host reads, capture "
          f"ms): solo {tuple(loops_s.values())}, cohort "
          f"{tuple(loops_c.values())}")
    # pipeline on against off, one tenant; each schedule's value updates
    # counted exactly (1 + n_correctors a step serially, 2 pipelined)
    from repro_torch.kernels import launch_counts

    solvers = {mode: make_solver("piso", mesh, alpha=ALPHA, p_tol=1e-10,
                                 p_maxiter=6000, pipeline=mode,
                                 plan_cache=eng.plan_cache, device=dev)
               for mode in ("off", "on")}
    dt = 0.5 * h
    runs = {}
    for mode, solver in solvers.items():
        st = PisoState(*(t.clone() for t in state3))
        before = launch_counts()["coef_update"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_versions():
            st, stats = solver.run_steps(st, dt, SERVE_STEPS)
        torch.cuda.synchronize()
        runs[mode] = (st, stats, (time.perf_counter() - t0) / SERVE_STEPS)
        updates = launch_counts()["coef_update"] - before
        per_step = 2 if mode == "on" else 1 + solver.n_correctors
        if updates != per_step * SERVE_STEPS:
            problems.append(f"13b pipeline {mode}: {updates} value updates "
                            f"in {SERVE_STEPS} steps, not {per_step} a step")
    st, stats, secs = runs["on"]
    bitwise, worst = lane_report(torch, st, runs["off"][0],
                                 _last_step(stats), _last_step(runs["off"][1]),
                                 "13b pipeline on", problems)
    pipe = {"on": {"bitwise_vs_off": bitwise, "max_rel": worst,
                   "s_per_step": secs},
            "off": {"s_per_step": runs["off"][2]}}
    print(f"  [13b] pipeline: s per step off {runs['off'][2]:.4f}, on "
          f"{secs:.4f}; on bitwise off {bitwise} (max rel {worst:.2e})")
    out["pipeline"] = pipe
    del eng, solvers, runs, cohort, solo
    return out


def _last_step(stats):
    return type(stats)(*(t[-1] for t in stats))


def mix_engine(dev, meshes, n, pad=SMALL_CLASS, **eng_kw):
    """An engine of ``n`` tenants of the serving mesh ``meshes`` in turn,
    padded to class ``pad`` (None: unpadded), mixed dt, non-adaptive at
    alpha 1 (13c, 14c)."""
    from repro_torch.serving.engine import SimulationEngine

    eng = SimulationEngine(device=dev, **eng_kw)
    for i in range(n):
        mesh = meshes[i % len(meshes)]
        eng.open_session(f"s{i}", mesh, dt=0.5 * mesh.h * (1 + 0.05 * i),
                         alpha0=1, adaptive=False, pad_to_class=pad)
    return eng


def small_tenants_phase(torch, dev, problems) -> dict:
    """13c: ``SMALL_TENANTS`` tenants of the serving mesh mix
    (``mesh_mix`` at ``SMALL_ARGS``: 64 x 64 x {32, 48, 64} in {8, 12, 16}
    parts) padded to class ``SMALL_CLASS``, mixed dt, cavity, f64:
    ``SMALL_STEPS`` steps through ``step_session`` per tenant unpadded
    and padded, then through ``step_all`` from the same states (each path
    warmed by an untimed step), each lane held to its padded solo run;
    then the same mix with ``lane_classes`` and one tenant fewer (a
    filler lane) held to the same solo runs."""
    from repro_torch.fvm.piso import PisoState
    from repro_torch.launch.serve import mesh_mix
    from repro_torch.solvers.device_loop import (loop_records,
                                                 reset_loop_records)

    args = serve_args(SMALL_ARGS, dev)
    meshes = mesh_mix(args)
    out = {"meshes": [f"{m.nx}x{m.ny}x{m.nz}/{m.n_parts}" for m in meshes]}

    def cg_iters():
        return sum(r.iters for r in loop_records() if r.solver == "cg")

    def restart(eng, init):
        for sid, s in eng.sessions.items():
            s.state = PisoState(*(t.clone() for t in init[sid]))
            s.steps_done = 0
        eng.reset_stats()

    def solo_run(eng):
        """Each tenant alone, ``SMALL_STEPS`` steps: states, last-step
        stats, wall seconds, CG iterations, counters."""
        state, last = {}, {}
        reset_loop_records()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_versions():
            for sid in eng.sessions:
                last[sid] = eng.step_session(sid, SMALL_STEPS)
                state[sid] = eng.sessions[sid].state
        torch.cuda.synchronize()
        return (state, last, time.perf_counter() - t0, cg_iters(),
                dict(eng.counters))

    # each tenant unpadded through its own solver, warmed by one untimed
    # step each (the first captures and device indices)
    eng = mix_engine(dev, meshes, SMALL_TENANTS, pad=None)
    init_u = {sid: PisoState(*(t.clone() for t in s.state))
              for sid, s in eng.sessions.items()}
    for sid in eng.sessions:
        eng.step_session(sid, 1)
    restart(eng, init_u)
    state_u, last_u, wall_u, it_u, _ = solo_run(eng)
    del eng
    eng = mix_engine(dev, meshes, SMALL_TENANTS)
    init = {sid: PisoState(*(t.clone() for t in s.state))
            for sid, s in eng.sessions.items()}
    # one untimed step each, alone and as a cohort, warms both paths
    eng.step_all(1)
    restart(eng, init)
    for sid in eng.sessions:
        eng.step_session(sid, 1)
    restart(eng, init)
    solo, last_s, wall_s, it_s, solo_counters = solo_run(eng)
    restart(eng, init)
    reset_loop_records()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_plain_versions():
        last_c = eng.step_all(SMALL_STEPS)
    torch.cuda.synchronize()
    wall_c, it_c = time.perf_counter() - t0, cg_iters()
    cohort_counters = dict(eng.counters)
    bitwise = {}
    for sid in eng.sessions:
        bitwise[sid], _ = lane_report(torch, eng.sessions[sid].state,
                                      solo[sid], last_c[sid], last_s[sid],
                                      f"13c {sid}", problems)
    # padded against unpadded alone (reported, not held: padding changes
    # the grouping of each sum, so counts may move by round-off)
    unpadded = {}
    for sid, st in state_u.items():
        real = st.p.shape[0]
        unpadded[sid] = {
            "max_rel": max(rel_diff(getattr(solo[sid], f)[:real],
                                    getattr(st, f)) for f in st._fields),
            "counts": {f: (getattr(last_u[sid], f).tolist(),
                           getattr(last_s[sid], f).tolist())
                       for f in ("mom_iters", "p_iters")}}
    same_counts_u = all(a == b for u in unpadded.values()
                        for a, b in u["counts"].values())
    steps = SMALL_TENANTS * SMALL_STEPS
    out.update(solo_steps_per_s=steps / wall_s,
               unpadded_steps_per_s=steps / wall_u,
               cohort_steps_per_s=steps / wall_c, solo_s=wall_s,
               unpadded_s=wall_u, cohort_s=wall_c,
               solo_counters=solo_counters, cohort_counters=cohort_counters,
               solo_ms_per_cg_iter=1e3 * wall_s / it_s,
               unpadded_ms_per_cg_iter=1e3 * wall_u / it_u,
               cohort_ms_per_cg_iter=1e3 * wall_c / it_c,
               solo_cg_iters=it_s, unpadded_cg_iters=it_u,
               cohort_cg_iters=it_c, bitwise=bitwise,
               unpadded_same_counts=same_counts_u, unpadded=unpadded,
               cohorts=[len(g) for g in eng.cohorts().values()])
    print(f"  [13c] {SMALL_TENANTS} tenants x {SMALL_STEPS} steps, meshes "
          f"{out['meshes']}, warm: session-steps/s alone unpadded "
          f"{steps / wall_u:.2f} ({wall_u:.2f} s, {it_u} CG iterations, "
          f"{1e3 * wall_u / it_u:.4f} ms each; last-step counts those of "
          f"the padded runs {same_counts_u}), alone padded to {SMALL_CLASS} "
          f"{steps / wall_s:.2f} ({wall_s:.2f} s, {it_s} CG iterations, "
          f"{1e3 * wall_s / it_s:.4f} ms each), cohort {steps / wall_c:.2f} "
          f"({wall_c:.2f} s, {it_c} CG iterations of the cohort, "
          f"{1e3 * wall_c / it_c:.4f} ms each); cohort ratio "
          f"{wall_u / wall_c:.3f} against unpadded, {wall_s / wall_c:.3f} "
          f"against padded")
    print(f"  [13c] padded against unpadded alone: fields max rel "
          f"{max(u['max_rel'] for u in unpadded.values()):.2e}; last-step "
          f"(mom_iters, p_iters) unpadded / padded where they differ: "
          + ("; ".join(f"{sid} {u['counts']}" for sid, u in unpadded.items()
                       if any(a != b for a, b in u["counts"].values()))
             or "none"))
    print(f"  [13c] counters solo {solo_counters}, cohort {cohort_counters}; "
          f"lanes bitwise their solo runs {sum(bitwise.values())}/"
          f"{len(bitwise)}")
    if cohort_counters["cohort_dispatches"] >= SMALL_TENANTS * SMALL_STEPS:
        problems.append(f"13c: cohort dispatches {cohort_counters}")
    # a filler lane: one tenant fewer, lane classes on
    del eng
    eng = mix_engine(dev, meshes, SMALL_TENANTS - 1, lane_classes=True)
    for sid, s in eng.sessions.items():
        s.state = PisoState(*(t.clone() for t in init[sid]))
    with no_plain_versions():
        last_f = eng.step_all(SMALL_STEPS)
    torch.cuda.synchronize()
    same = {}
    for sid in eng.sessions:
        same[sid], _ = lane_report(torch, eng.sessions[sid].state, solo[sid],
                                   last_f[sid], last_s[sid],
                                   f"13c filler cohort {sid}", problems)
    out["filler"] = {"bitwise": same, "counters": dict(eng.counters)}
    print(f"  [13c] {SMALL_TENANTS - 1} tenants with lane classes (one "
          f"filler lane): bitwise their solo runs "
          f"{sum(same.values())}/{len(same)}; counters {eng.counters}")
    del eng
    return out


def arrivals_phase(torch, dev, problems) -> dict:
    """13d: the port's ``serve_cfd_arrivals`` in process at
    ``ARRIVAL_ARGS``; dispatches fewer than sessions, at least two
    multi-session cohorts, per-class p50/p99 printed; two tenants that
    shared a dispatch are run alone from the start and held to their
    served states."""
    from repro_torch.launch.serve import serve_cfd_arrivals
    from repro_torch.serving.engine import SimulationEngine

    args = serve_args(ARRIVAL_ARGS, dev)
    opened, closed = {}, {}
    open_session, close_session = (SimulationEngine.open_session,
                                   SimulationEngine.close_session)

    def spy_open(self, sid, mesh, **kw):
        opened[sid] = (mesh, kw)
        return open_session(self, sid, mesh, **kw)

    def spy_close(self, sid):
        s = self.sessions[sid]
        closed[sid] = (s.state, s.steps_done)
        return close_session(self, sid)

    SimulationEngine.open_session = spy_open
    SimulationEngine.close_session = spy_close
    try:
        with no_plain_versions():
            stats = serve_cfd_arrivals(args, log=lambda m: print(f"  [13d] "
                                                                 f"{m}"))
    finally:
        SimulationEngine.open_session = open_session
        SimulationEngine.close_session = close_session
    sched = stats.pop("sched")
    multi = {}
    for ev in sched.core.events:
        if ev["kind"] == "dispatch" and len(ev["sids"]) > 1:
            multi.setdefault(ev["key"], set()).update(ev["sids"])
    out = {"dispatches": stats["dispatches"], "rounds": stats["rounds"],
           "multi_session_cohorts": len(multi),
           "latency": stats["latency"]["classes"],
           "counters": stats["engine"]["counters"]}
    if not stats["dispatches"] < args.sessions:
        problems.append(f"13d: {stats['dispatches']} dispatches for "
                        f"{args.sessions} sessions")
    if len(multi) < 2:
        problems.append(f"13d: {len(multi)} multi-session cohort(s)")
    if len(closed) != args.sessions:
        problems.append(f"13d: {len(closed)} of {args.sessions} sessions "
                        f"finished")
    # two tenants of multi-session dispatches, alone from the start
    picks = sorted({sid for sids in multi.values() for sid in sids},
                   key=lambda s: int(s.removeprefix("tenant")))[:2]
    eng = SimulationEngine(device=dev)
    held = {}
    for sid in picks:
        mesh, kw = opened[sid]
        kw = {k: v for k, v in kw.items()
              if k not in ("priority", "deadline_ms")}
        s = eng.open_session(sid, mesh, **kw)
        with no_plain_versions():
            last = eng.step_session(sid, closed[sid][1])
        state = eng.sessions[sid].state
        got = closed[sid][0]
        worst = max(rel_diff(getattr(got, f), getattr(state, f))
                    for f in got._fields)
        bitwise = all(torch.equal(getattr(got, f), getattr(state, f))
                      for f in got._fields)
        held[sid] = {"program": s.solver.program_name,
                     "case": s.solver.case, "max_rel": worst,
                     "bitwise": bitwise}
        if not worst <= PARITY:
            problems.append(f"13d {sid}: {worst:.3e} from its solo run")
        del last
    out["held"] = held
    print(f"  [13d] multi-session cohorts {len(multi)}; held against solo "
          f"runs: {held}")
    return out


# ---------------------------------------------------------------------------
# phase 14: supervision
# ---------------------------------------------------------------------------

CAP_BUDGET = 2             # 14c: the persistent cap fault's retry budget
SUP_WINDOW = 4             # 14c: steps a window (JAX tests/test_supervision)
CHAOS_STEPS = 16           # 14c: steps of the seeded blowup/slow run
CLI_ARGS = SMALL_ARGS + ["--sessions", "2", "--scan-steps", "4",
                         "--adaptive"]                      # 14d
CLI_STEPS, CLI_KILL = 8, 4
CHAOS_ARGS = ["--chaos", "all", "--chaos-seed", "0", "--chaos-events", "2"]
CLI_TIMEOUT = 300
# the Krylov kernels of a step: flat while a session is quarantined on
# "reference", moving after it recovers
KRYLOV_KERNELS = ("spmv_dia", "spmv_dot_direction", "axpy_precond",
                  "cg_advance")


def group_timer(torch, eng) -> list:
    """Time every ``advance_group`` of ``eng`` (one cohort or solo window
    each, synchronised at its end): a list of (sids, seconds) the engine's
    ``step_all`` fills as it dispatches."""
    windows = []
    inner = eng.advance_group

    def timed(group, n_steps, last=None):
        t0 = time.perf_counter()
        out = inner(group, n_steps, last)
        torch.cuda.synchronize()
        windows.append((list(group), time.perf_counter() - t0))
        return out

    eng.advance_group = timed
    return windows


def event_kinds(sup) -> list:
    return [e.kind for e in sup.events]


def seed_state(sess, state) -> None:
    """Start a supervised session from a copy of ``state``, checkpointed
    there (without the checkpoint, its first fault would roll it back to
    rest)."""
    from repro_torch.fvm.piso import PisoState

    sess.state = PisoState(*(t.clone() for t in state))
    sess.supervisor.checkpoint(sess.state, sess.steps_done)


def hold_to_ends(torch, eng, last, ends, sids, tag, problems) -> dict:
    """Each of ``sids`` against 13b's cohort end state and last-step stats
    (1e-10, identical counts and flags); returns whether each is
    bitwise."""
    return {sid: lane_report(torch, eng.sessions[sid].state, ends[sid][0],
                             last[sid], ends[sid][1], f"{tag} {sid}",
                             problems)[0]
            for sid in sids}


def snapshot_posture(eng) -> dict:
    """What a snapshot must carry back: per session its supervisor,
    controller and tolerances."""
    out = {}
    for sid, s in eng.sessions.items():
        c, v = s.controller, s.solver
        out[sid] = {"supervisor": s.supervisor.to_dict(),
                    "controller": (c.alpha, c.step_count, c.last_switch_step,
                                   list(c.calibration._log_scales),
                                   c.calibration.n_obs, len(c.history)),
                    "tols": (v.mom_tol, v.p_tol, v.mom_maxiter,
                             v.p_maxiter),
                    "steps_done": s.steps_done}
    return out


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def nan_cohort_phase(torch, dev, state3, ends, warm, snap, problems) -> dict:
    """14a (and 14d's snapshot): three supervised 210^3 tenants at 13b's
    settings from the main run's state, one cohort window, a snapshot of
    the engine to ``snap``, then NaN into t2's ``U`` and a second window:
    t2 rolled back, retried solo at half dt, held to an unsupervised step
    from its checkpoint; t0 and t1 held to 13b's end states.  ``warm`` is
    13b's warm cohort rate and peak memory."""
    from repro_torch.faults import ChaosMonkey
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.fvm.piso import PisoState
    from repro_torch.serving.engine import SimulationEngine

    mesh = CavityMesh.cube(N, PARTS)
    eng = SimulationEngine(device=dev, supervise=True, scan_window=1)
    for i in range(3):
        sess = eng.open_session(f"t{i}", mesh,
                                dt=0.5 * mesh.h * (1 + 0.1 * i),
                                alpha0=ALPHA, adaptive=False, p_tol=1e-10,
                                p_maxiter=6000)
        seed_state(sess, state3)
    windows = group_timer(torch, eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with no_plain_versions():
        eng.step_all(1)
    clean_s = windows[-1][1]
    t0 = time.perf_counter()
    eng.snapshot(snap)
    write_s = time.perf_counter() - t0
    posture = snapshot_posture(eng)
    t2 = eng.sessions["t2"]
    ckpt = PisoState(*(t.clone() for t in t2.supervisor.last_good[0]))
    ChaosMonkey._inject_nan(t2)
    with no_plain_versions():
        last = eng.step_all(1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"windows": [(g, s) for g, s in windows], "clean_s": clean_s,
           "counters": dict(eng.counters), "peak_gib": peak,
           "steps_per_s": 3 / clean_s, "snapshot": {
               "bytes": dir_bytes(snap), "write_s": write_s}}
    if [g for g, _ in windows] != [["t0", "t1", "t2"], ["t0", "t1", "t2"],
                                   ["t2"]]:
        problems.append(f"14a: windows {[g for g, _ in windows]}, not two "
                        f"cohort windows and t2's solo retry")
    if (out["counters"]["cohort_dispatches"],
            out["counters"]["solo_dispatches"]) != (2, 1):
        problems.append(f"14a: counters {out['counters']}")
    sup = t2.supervisor
    kinds = [(e.kind, e.detail) for e in sup.events]
    if [k for k, _ in kinds] != ["fault", "degrade"] or \
            kinds[0][1] != "diverged":
        problems.append(f"14a t2: events {kinds}")
    if (sup.state, sup.dt_scale, t2.steps_done) != ("degraded", 0.5, 2):
        problems.append(f"14a t2: {sup.state}, dt_scale {sup.dt_scale}, "
                        f"{t2.steps_done} steps")
    # the retry against an unsupervised solo step from the checkpoint
    with no_plain_versions():
        ref, ref_stats = t2.solver.run_steps(ckpt, 0.5 * t2.dt, 1)
    torch.cuda.synchronize()
    t2_bitwise, t2_rel = lane_report(torch, t2.state, ref, last["t2"],
                                     _last_step(ref_stats), "14a t2 retry",
                                     problems)
    cont = float(last["t2"].continuity_err)
    if not (bool(last["t2"].converged) and cont < CONTINUITY):
        problems.append(f"14a t2 retry: converged "
                        f"{bool(last['t2'].converged)}, continuity "
                        f"{cont:.3e}")
    mates = hold_to_ends(torch, eng, last, ends, ("t0", "t1"), "14a",
                         problems)
    for sid in ("t0", "t1"):
        s = eng.sessions[sid].supervisor
        if s.state != "healthy" or s.events:
            problems.append(f"14a {sid}: {s.state}, events {s.events}")
    poisoned_s, retry_s = (windows[1][1], windows[2][1]) \
        if len(windows) == 3 else (float("nan"), float("nan"))
    out.update(poisoned_s=poisoned_s, retry_s=retry_s,
               t2={"bitwise": t2_bitwise, "max_rel": t2_rel,
                   "continuity": cont, "events": kinds},
               mates_bitwise=mates, posture=posture)
    print(f"  [14a] windows: clean cohort {clean_s:.3f} s, poisoned cohort "
          f"{poisoned_s:.3f} s ({poisoned_s / clean_s:.3f}x), t2's solo "
          f"retry {retry_s:.3f} s; counters {out['counters']}")
    print(f"  [14a] t2 events {kinds}, retry bitwise the unsupervised step "
          f"{t2_bitwise} (max rel {t2_rel:.2e}), continuity {cont:.2e}; t0, "
          f"t1 bitwise 13b's end states {mates}")
    print(f"  [14a] session-steps/s supervised {3 / clean_s:.4f} against "
          f"13b's warm cohort {warm['steps_per_s']:.4f} "
          f"({3 / clean_s / warm['steps_per_s']:.4f}x); max_memory_allocated "
          f"{peak:.2f} GiB against 13b's {warm['peak_gib']:.2f}")
    print(f"  [14d] snapshot after the clean window: "
          f"{out['snapshot']['bytes'] / 2 ** 30:.3f} GiB in {write_s:.2f} s")
    del eng, ckpt, ref
    return out


def resume_phase(torch, dev, ends, snap, posture, problems) -> dict:
    """14d in process: 14a's snapshot restored into a fresh engine with a
    fresh plan cache, one window with no fault, every tenant held to 13b's
    end state; supervisor, controller and tolerances round-tripped."""
    from repro_torch.core.controller import PlanCache
    from repro_torch.serving.engine import SimulationEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = SimulationEngine.restore(snap, plan_cache=PlanCache(), device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = snapshot_posture(eng)
    if got != posture:
        problems.append(f"14d: restored posture {got} != saved {posture}")
    with no_plain_versions():
        last = eng.step_all(1)
    torch.cuda.synchronize()
    bitwise = hold_to_ends(torch, eng, last, ends, ("t0", "t1", "t2"),
                           "14d", problems)
    out = {"restore_s": restore_s, "bitwise": bitwise,
           "posture_round_trip": got == posture,
           "counters": dict(eng.counters)}
    print(f"  [14d] restored in {restore_s:.2f} s (fresh plan cache); after "
          f"one window every tenant bitwise 13b's end state {bitwise}; "
          f"supervisor, controller and tolerances round-trip {got == posture}")
    del eng
    return out


def ladder_phase(torch, dev, state3, problems) -> dict:
    """14b: one supervised ``bf16_ir`` tenant of the 210^3 cavity from the
    main run's state, ``step_all(1)`` twice: the first window faults by
    itself, the session climbs to ``f32_ir`` and retries at half dt, held
    to an unsupervised tenant opened at ``f32_ir``."""
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.serving.engine import SimulationEngine

    mesh = CavityMesh.cube(N, PARTS)
    kw = dict(alpha0=ALPHA, adaptive=False, p_tol=1e-10, p_maxiter=6000)
    eng = SimulationEngine(device=dev, supervise=True, scan_window=1)
    sess = eng.open_session("bf", mesh, dt=0.5 * mesh.h,
                            precision="bf16_ir", **kw)
    seed_state(sess, state3)
    windows = group_timer(torch, eng)
    with no_plain_versions():
        first = eng.step_all(1)
    sup, c = sess.supervisor, sess.controller
    faulted_first = bool(sup.events)
    # the rung the retry ran on (a second clean window restores bf16_ir)
    rungs = (sess.solver.precision, c.precision, c.base_model.precision,
             sup.orig_precision)
    retry_state = type(state3)(*(t.clone() for t in sess.state))
    with no_plain_versions():
        second = eng.step_all(1)
    kinds = [(e.kind, e.detail) for e in sup.events]
    fault = kinds[0][1] if kinds else None
    if not faulted_first or [k for k, _ in kinds[:2]] != ["fault",
                                                          "degrade"]:
        problems.append(f"14b: the first bf16_ir window did not fault "
                        f"(events {kinds})")
    if rungs != ("f32_ir", "f32_ir", "f32_ir", "bf16_ir"):
        problems.append(f"14b: precision after the fault {rungs}")
    # an unsupervised tenant opened at f32_ir, one step at half dt
    ref = SimulationEngine(device=dev, plan_cache=eng.plan_cache)
    r = ref.open_session("ref", mesh, dt=sess.dt * 0.5, precision="f32_ir",
                         **kw)
    r.state = type(state3)(*(t.clone() for t in state3))
    with no_plain_versions():
        ref_last = ref.step_session("ref", 1)
    torch.cuda.synchronize()
    bitwise, worst = lane_report(torch, retry_state, r.state, first["bf"],
                                 ref_last, "14b retry", problems)
    cont = float(first["bf"].continuity_err)
    if not (bool(first["bf"].converged) and cont < CONTINUITY):
        problems.append(f"14b retry: converged {bool(first['bf'].converged)}"
                        f", continuity {cont:.3e}")
    out = {"fault": fault, "faulted_first": faulted_first, "events": kinds,
           "precision": rungs,
           "windows": [(g, s) for g, s in windows], "retry_bitwise": bitwise,
           "retry_max_rel": worst, "continuity": cont,
           "second_window": {"converged": bool(second["bf"].converged),
                             "continuity":
                                 float(second["bf"].continuity_err),
                             "precision": sess.solver.precision,
                             "state": sup.state}}
    secs = [round(w, 3) for _, w in windows]
    print(f"  [14b] bf16_ir's first window: {fault}; climbed to {rungs}; "
          f"f32_ir retry at half dt: continuity {cont:.2e}, bitwise the "
          f"tenant opened at f32_ir {bitwise} (max rel {worst:.2e}); second "
          f"window {out['second_window']}; window seconds (faulty, retry, "
          f"second) {secs}")
    del eng, ref
    return out


def krylov_moved(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in KRYLOV_KERNELS + ("coef_update",)}


def escalation_phase(torch, dev, problems) -> dict:
    """14c: at the 13c class, a persistent cap fault ending in a clean
    FAILED; quarantine on the configured "reference" fallback and
    recovery (the launch counters per request); seeded blowup and slow
    faults; supervised against unsupervised session-steps per second on
    13c's mix, in turns."""
    from repro_torch.faults import ChaosMonkey, FaultEvent
    from repro_torch.fvm.piso import PisoState
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import mesh_mix
    from repro_torch.serving.supervisor import SupervisorConfig

    meshes = mesh_mix(serve_args(SMALL_ARGS, dev))
    out = {}
    # a persistent cap fault: the budget burns down to a clean FAILED
    eng = mix_engine(dev, meshes, 2, supervise=True, scan_window=SUP_WINDOW,
                     supervisor_config=SupervisorConfig(
                         retry_budget=CAP_BUDGET))
    with no_plain_versions():
        eng.step_all(SUP_WINDOW)
        ChaosMonkey._inject_cap(eng.sessions["s0"])
        eng.step_all(2 * SUP_WINDOW)
    post = eng.failed.get("s0", {"events": []})
    kinds = [e["kind"] for e in post["events"]]
    faults = {e["detail"] for e in post["events"] if e["kind"] == "fault"}
    mate = eng.sessions["s1"]
    if kinds != ["fault", "degrade", "fault", "quarantine", "fault", "fail"] \
            or faults != {"hit_cap"}:
        problems.append(f"14c cap: events {post['events']}")
    if "s0" in eng.sessions or eng.stats()["failed"] != ["s0"]:
        problems.append(f"14c cap: failed {eng.stats()['failed']}")
    if (mate.supervisor.state, mate.steps_done) != ("healthy",
                                                    3 * SUP_WINDOW):
        problems.append(f"14c cap: mate {mate.supervisor.state}, "
                        f"{mate.steps_done} steps")
    out["cap"] = {"events": kinds, "faults": sorted(faults),
                  "failed": eng.stats()["failed"],
                  "counters": dict(eng.counters)}
    print(f"  [14c] persistent cap (budget {CAP_BUDGET}): events {kinds} "
          f"({sorted(faults)}); failed {eng.stats()['failed']}; mate "
          f"{mate.supervisor.state} at {mate.steps_done} steps")
    del eng

    # quarantine on "reference" and recovery, the kernels' counters per
    # request (the mate waits, so only the quarantined tenant runs).  The
    # second fault quarantines: its retry and the next request run on the
    # plain "reference" backend by configuration, so those two requests
    # run with the plain versions in place
    eng = mix_engine(dev, meshes, 2, supervise=True, scan_window=SUP_WINDOW,
                     supervisor_config=SupervisorConfig(
                         retry_budget=10, recovery_windows=2,
                         fallback_backend="reference"))
    q = eng.sessions["s0"]
    rows = []
    with no_plain_versions():
        eng.step_all(SUP_WINDOW)
    for request in range(5):
        if request < 2:
            ChaosMonkey._inject_nan(q)
        backend = q.solver.solver_backend
        before = launch_counts()
        with (contextlib.nullcontext() if request in (1, 2)
              else no_plain_versions()):
            eng.step_all(SUP_WINDOW, sids=["s0"])
        torch.cuda.synchronize()
        rows.append({"poisoned": request < 2, "backend_before": backend,
                     "backend_after": q.solver.solver_backend,
                     "state": q.supervisor.state,
                     "launches": krylov_moved(before, launch_counts())})
    with no_plain_versions():
        rejoin = eng.step_all(SUP_WINDOW)
    states = [r["state"] for r in rows]
    want = ["degraded", "quarantined", "degraded", "degraded", "healthy"]
    if states != want:
        problems.append(f"14c quarantine: states {states}, not {want}")
    if q.supervisor.orig_backend is not None or \
            q.solver.solver_backend != "auto":
        problems.append(f"14c quarantine: ends on {q.solver.solver_backend}")
    # request 3 ran wholly on "reference": the Krylov kernels stay flat,
    # the value update keeps moving; after recovery they move again
    quarantined = rows[2]
    if quarantined["backend_before"] != "reference" or any(
            quarantined["launches"][k] for k in KRYLOV_KERNELS) or \
            not quarantined["launches"]["coef_update"]:
        problems.append(f"14c quarantine: the quarantined request's "
                        f"launches {quarantined}")
    for r in rows[3:]:
        if not all(r["launches"][k] > 0 for k in KRYLOV_KERNELS):
            problems.append(f"14c quarantine: after recovery {r}")
    if not all(r["launches"]["coef_update"] > 0 for r in rows):
        problems.append(f"14c quarantine: a request without value updates "
                        f"{rows}")
    if len(eng.cohorts()) != 1 or eng.counters["cohort_dispatches"] < 2:
        problems.append(f"14c quarantine: no single cohort after recovery "
                        f"({[len(g) for g in eng.cohorts().values()]}, "
                        f"{eng.counters})")
    out["quarantine"] = {"requests": rows,
                         "events": event_kinds(q.supervisor),
                         "rejoined": sorted(rejoin),
                         "counters": dict(eng.counters)}
    for i, r in enumerate(rows):
        print(f"  [14c] quarantine request {i}: poisoned {r['poisoned']}, "
              f"{r['backend_before']} -> {r['backend_after']}, {r['state']}, "
              f"launches {r['launches']}")
    print(f"  [14c] events {event_kinds(q.supervisor)}; one cohort again: "
          f"{[len(g) for g in eng.cohorts().values()]}, counters "
          f"{eng.counters}")
    del eng

    # seeded blowup and slow faults on adaptive tenants
    eng = mix_engine(dev, meshes, 2, supervise=True, scan_window=SUP_WINDOW)
    for s in eng.sessions.values():
        s.adaptive = True
    monkey = ChaosMonkey(0, sorted(eng.sessions), kinds=("blowup", "slow"))
    monkey.events = [FaultEvent(SUP_WINDOW, "s0", "blowup"),
                     FaultEvent(SUP_WINDOW, "s1", "slow")]
    with no_plain_versions():
        while any(s.steps_done < CHAOS_STEPS for s in eng.sessions.values()):
            eng.step_all(SUP_WINDOW)
            monkey.poke(eng)
    blow, slow = eng.sessions["s0"], eng.sessions["s1"]
    if "fault" not in event_kinds(blow.supervisor) or \
            blow.supervisor.state != "healthy" or \
            not bool(torch.isfinite(blow.state.U).all()):
        problems.append(f"14c blowup: {blow.supervisor.state}, events "
                        f"{blow.supervisor.events}")
    if slow.supervisor.events:
        problems.append(f"14c slow: events {slow.supervisor.events}")
    out["chaos"] = {"applied": [(e.step, e.sid, e.kind)
                                for e in monkey.applied],
                    "blowup_events": event_kinds(blow.supervisor),
                    "slow_events": event_kinds(slow.supervisor),
                    "samples": eng.counters["sample_steps"]}
    print(f"  [14c] chaos {out['chaos']['applied']}: blowup events "
          f"{out['chaos']['blowup_events']} -> {blow.supervisor.state}; "
          f"slow events {out['chaos']['slow_events']}; "
          f"{eng.counters['sample_steps']} sampled steps")
    del eng

    # supervision's cost: 13c's mix, warm, in turns
    engines = {"unsupervised": mix_engine(dev, meshes, SMALL_TENANTS),
               "supervised": mix_engine(dev, meshes, SMALL_TENANTS,
                                        supervise=True)}
    init = {sid: PisoState(*(t.clone() for t in s.state))
            for sid, s in engines["unsupervised"].sessions.items()}

    def restart(eng):
        for sid, s in eng.sessions.items():
            s.steps_done = 0
            if s.supervisor is not None:
                seed_state(s, init[sid])
            else:
                s.state = PisoState(*(t.clone() for t in init[sid]))
        eng.reset_stats()

    rates = {k: [] for k in engines}
    # ABBA (cut from ABBAAB to hold the whole script's time)
    for name in ("unsupervised", "supervised", "supervised", "unsupervised"):
        eng = engines[name]
        restart(eng)
        if not rates[name]:
            eng.step_all(1)          # warm-up: captures, device indices
            restart(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_versions():
            eng.step_all(SMALL_STEPS)
        torch.cuda.synchronize()
        rates[name].append(SMALL_TENANTS * SMALL_STEPS
                           / (time.perf_counter() - t0))
    same = all(torch.equal(a, b) for sid in init for a, b in zip(
        engines["supervised"].sessions[sid].state,
        engines["unsupervised"].sessions[sid].state))
    if not same:
        problems.append("14c cost: the supervised mix is not bitwise the "
                        "unsupervised one")
    ratio = sum(rates["supervised"]) / sum(rates["unsupervised"])
    out["cost"] = {"rates": rates, "ratio": ratio, "bitwise": same}
    print(f"  [14c] {SMALL_TENANTS} tenants x {SMALL_STEPS} steps, "
          f"session-steps/s in turns: unsupervised "
          f"{[round(r, 3) for r in rates['unsupervised']]}, supervised "
          f"{[round(r, 3) for r in rates['supervised']]}; ratio "
          f"{ratio:.4f}; bitwise {same}")
    del engines, eng
    return out


def serve_cli(extra: list):
    """Start ``python -m repro_torch.launch.serve`` on the card."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def serve_main(args: list) -> tuple:
    """The serving launcher's ``main`` (what its command line runs) in
    this process: ``(returncode, what it printed, the error)``, as
    :func:`finish` gives a process's."""
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            serve.main(args)
    except SystemExit as e:
        if e.code not in (0, None):
            return 1, buf.getvalue(), f"SystemExit: {e}"
    except Exception as e:  # noqa: BLE001 — reported as the run's failure
        return 1, buf.getvalue(), f"{type(e).__name__}: {e}"
    return 0, buf.getvalue(), ""


def finish(procs: dict) -> dict:
    """Wait for every started process (killing one past ``CLI_TIMEOUT``);
    name -> (returncode, stdout, stderr)."""
    out = {}
    for name, proc in procs.items():
        try:
            so, se = proc.communicate(timeout=CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            so, se = proc.communicate()
        out[name] = (proc.returncode, so, se)
    return out


def digest_lines(text: str) -> list:
    return sorted(line.split()[1:] for line in text.splitlines()
                  if line.startswith("digest "))


def cli_phase(torch, tmp, problems) -> dict:
    """14d through the serving launcher: an uninterrupted supervised run
    with a snapshot directory against a run killed at a window-aligned
    snapshot (both its ``main`` in this process) and resumed by ``python
    -m repro_torch.launch.serve`` (a process of its own, beside a seeded
    chaos run in this process), the ``digest`` lines equal."""
    base = CLI_ARGS + ["--supervise"]
    t0 = time.perf_counter()
    runs = {"full": serve_main(base + ["--steps", str(CLI_STEPS),
                                       "--snapshot-dir",
                                       str(Path(tmp) / "full")]),
            "part": serve_main(base + ["--steps", str(CLI_KILL),
                                       "--snapshot-dir",
                                       str(Path(tmp) / "part")])}
    proc = serve_cli(CLI_ARGS + ["--resume", "--steps", str(CLI_STEPS),
                                 "--snapshot-dir", str(Path(tmp) / "part")])
    runs["chaos"] = serve_main(CLI_ARGS + ["--steps", str(CLI_STEPS)]
                               + CHAOS_ARGS)
    runs.update(finish({"resumed": proc}))
    wall = time.perf_counter() - t0
    for name, (rc, so, se) in runs.items():
        if rc != 0:
            problems.append(f"14d CLI {name}: exit {rc}: {se[-2000:]}")
    full, resumed = (digest_lines(runs[k][1]) for k in ("full", "resumed"))
    if not full or full != resumed:
        problems.append(f"14d CLI: digests {full} against resumed {resumed}")
    lines = [line for line in runs["chaos"][1].splitlines()
             if line.startswith(("chaos", "supervision:", "health "))]
    for line in lines:
        print(f"  [14d] CLI chaos: {line}")
    print(f"  [14d] CLI kill and resume at {' '.join(SMALL_ARGS)}: digests "
          f"equal {bool(full) and full == resumed} ({full}); four runs in "
          f"{wall:.1f} s (the resumed one a process of its own)")
    return {"digests": full, "resumed_equal": bool(full) and full == resumed,
            "chaos": lines, "s": wall}


def supervision_phase(torch, dev, state3, ends, warm) -> dict:
    """Phase 14 (see the module docstring); its checks are collected and
    fail the run after all four parts have printed."""
    import shutil
    import tempfile

    print("[14] supervision: NaN in a 210^3 cohort, the precision ladder, "
          "escalation and recovery, kill and resume")
    problems = []
    out = {}
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    try:
        snap = str(Path(tmp) / "engine")
        out["nan_cohort"] = nan_cohort_phase(torch, dev, state3, ends, warm,
                                             snap, problems)
        posture = out["nan_cohort"].pop("posture")
        free_device(torch)
        out["resume"] = resume_phase(torch, dev, ends, snap, posture,
                                     problems)
        shutil.rmtree(snap)
        free_device(torch)
        out["ladder"] = ladder_phase(torch, dev, state3, problems)
        free_device(torch)
        out["escalation"] = escalation_phase(torch, dev, problems)
        free_device(torch)
        out["cli"] = cli_phase(torch, tmp, problems)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"  [14] {out['seconds']:.1f} s")
    for p in problems:
        print(f"  FAILED: {p}")
    require(not problems, f"phase 14: {len(problems)} check(s) failed")
    return out


# ---------------------------------------------------------------------------
# phase 15: the full-mesh solve mode at 210^3
# ---------------------------------------------------------------------------
# the full mesh's ratios: 1 x 30 and 2 x 15 shards of one fine part's rows
FULL_MESH_ALPHAS = (30, 15)
MESH_DEVICE = "cuda:0"       # every shard on the one card
FULL_MESH_SPMV = 1e-12       # shard SpMV vs the stacked kernel, relative to
#                              the output's max (the halo terms are added
#                              after the local sum: another rounding order)
FULL_MESH_TURNS = ("stacked", "full", "full", "stacked")


class _LaneSpy:
    """A kernel wrapper's stand-in that records ``(name, lanes)`` of each
    call and forwards it; ``launches`` is the wrapper's own counter (the
    wrapper adds to it through its module's name, now this object)."""

    def __init__(self, name, fn, calls):
        self.name, self.fn, self.calls = name, fn, calls

    def __call__(self, *args, **kw):
        self.calls.append((self.name, kw.get("lanes", 1)))
        return self.fn(*args, **kw)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


@contextlib.contextmanager
def lane_spy():
    """Record ``(kernel, lanes)`` of every call of the SpMV and fold
    wrappers inside the block (:class:`_LaneSpy`)."""
    from repro_torch.kernels.krylov_fused import krylov_fused as kf
    from repro_torch.kernels.spmv_dia import spmv_dia as sd

    calls = []
    saved = [(sd, "spmv_dia_stacked"), (kf, "spmv_dot_direction")]
    originals = [getattr(m, n) for m, n in saved]
    try:
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, _LaneSpy(name, fn, calls))
        yield calls
    finally:
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, fn)


def lane_problems(calls, n_shards: int) -> list:
    """What the lane spy's record of a full-mesh step says went wrong: the
    fold ran other than one lane a shard, or the shards' SpMV never ran as
    one launch of ``n_shards`` lanes."""
    out = []
    fold = {lanes for name, lanes in calls if name == "spmv_dot_direction"}
    if fold != {n_shards}:
        out.append(f"the fold ran with lanes {sorted(fold)}, not "
                   f"{n_shards} (one a shard)")
    if n_shards not in {lanes for name, lanes in calls
                        if name == "spmv_dia_stacked"}:
        out.append(f"the shard SpMV never launched {n_shards} lanes")
    return out


def loop_launches_per_iter(records) -> dict:
    """The guarded launches per iteration of a run's CG sweeps, as the
    kernels counted them on the device."""
    iters = sum(r.iters for r in records if r.solver == "cg")
    total: dict = {}
    for r in records:
        if r.solver == "cg":
            for name, n in r.launches.items():
                total[name] = total.get(name, 0) + n
    return {name: n / iters for name, n in total.items() if n} if iters \
        else {}


def full_mesh_solvers(torch) -> tuple:
    """The main path's stacked solver and its full-mesh twin
    (``--solve-mode full_mesh --mesh-devices``, every shard on
    ``MESH_DEVICE``), both through the launcher, and ``dt``."""
    from repro_torch.launch.case import build_parser, build_solver

    args = build_parser().parse_args(MAIN_ARGS)
    stacked = build_solver(args)
    fm_args = build_parser().parse_args(
        MAIN_ARGS + ["--solve-mode", "full_mesh", "--mesh-devices",
                     ",".join([MESH_DEVICE] * PARTS)])
    return stacked, build_solver(fm_args), args.co * stacked.mesh.h


def full_mesh_spmv(torch, stacked, full, state, dt, problems) -> dict:
    """15a: the shard SpMV (and its dot form) on the 210^3 pressure bands
    from ``state``, and the fused bundle's ``matvec_dot``, against the
    stacked kernels, each timed."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        fused_matvec_dot)
    from repro_torch.kernels.spmv_dia.spmv_dia import spmv_dia_stacked
    from repro_torch.core.comm import to_shards
    from repro_torch.sparse.shardmap_spmv import make_spmv_full_mesh

    bands, b, x0, diag = pressure_system(stacked, state, dt)
    plan, mesh = full.plan_p, full.spmd_mesh
    offsets = tuple(int(o) for o in plan.dia_offsets)
    kw = dict(offsets=offsets, plane=plan.plane)
    fm = make_spmv_full_mesh(mesh, n_coarse=full.n_coarse, alpha=plan.alpha,
                             m_coarse=plan.m_coarse, with_dot=True, **kw)
    b_sh = to_shards(bands, plan.alpha)
    ops = full._solver_ops(plan, bands, diag)
    gen = torch.Generator(device=b.device).manual_seed(0)
    out = {}
    for tag, x in (("p", x0.contiguous()),
                   ("random", torch.randn(b.shape, generator=gen,
                                          dtype=b.dtype, device=b.device))):
        with no_plain_versions():
            y_ref = spmv_dia_stacked(bands, x, **kw)
            _, dot_ref = fused_matvec_dot(bands, x, **kw)
            y_fm, dot_fm = fm(b_sh, x)
            y_op, dot_op = ops.matvec_dot(x)
        torch.cuda.synchronize()
        errs = {"spmv": rel_diff(y_fm, y_ref), "bundle": rel_diff(y_op, y_ref),
                "dot": rel_diff(dot_fm, dot_ref),
                "bundle_dot": rel_diff(dot_op, dot_ref)}
        out[tag] = errs
        print(f"  15a shard SpMV on x = {tag}: relative to the stacked "
              f"kernels " + ", ".join(f"{k} {v:.3e}" for k, v in
                                      errs.items()))
        if max(errs.values()) > FULL_MESH_SPMV:
            problems.append(f"15a x = {tag}: the shard SpMV differs from "
                            f"the stacked kernel by {errs}")
    x = x0.contiguous()
    out["ms"] = {"stacked_spmv": time_ms(torch, lambda: spmv_dia_stacked(
        bands, x, **kw)), "shard_spmv": time_ms(torch, lambda: fm(b_sh, x)),
        "stacked_spmv_dot": time_ms(torch, lambda: fused_matvec_dot(
            bands, x, **kw)), "bundle_matvec_dot": time_ms(
                torch, lambda: ops.matvec_dot(x))}
    print("  15a ms per call: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                              out["ms"].items()))
    return out


def full_mesh_step(torch, stacked, full, state, dt, alpha, problems) -> dict:
    """15b: one PISO step of each solver at ``alpha`` from ``state``, the
    full-mesh one with its counters from 0, plain versions refused and the
    wrappers' lanes recorded: identical counts and flags, the state within
    1e-10, the fold one lane a shard, every CG sweep's device counts its
    iterations times :data:`LOOP_LAUNCHES`."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solvers import device_loop

    stacked.rebind_alpha(alpha)
    full.rebind_alpha(alpha)
    shape = dict(zip(full.spmd_mesh.axis_names, full.spmd_mesh.shape))
    with no_plain_versions():
        st_s, ss = stacked.step(state, dt)
    reset_launch_counts()
    device_loop.reset_loop_records()
    with no_plain_versions(), lane_spy() as calls:
        st_f, sf = full.step(state, dt)
    torch.cuda.synchronize()
    counts, records = launch_counts(), device_loop.loop_records()
    tag = f"15b alpha {alpha} ({shape})"
    try:
        loop_summary(records)
        require_launched(counts, tag)
    except SmokeFailure as e:
        problems.append(str(e))
    problems.extend(f"{tag}: {p}" for p in
                    lane_problems(calls, full.spmd_mesh.n_shards))
    same = {f: torch.equal(getattr(sf, f), getattr(ss, f))
            for f in ("mom_iters", "p_iters", "converged", "hit_cap")}
    diffs = {f: rel_diff(getattr(st_f, f), getattr(st_s, f))
             for f in ("U", "p", "phi")}
    if not all(same.values()):
        problems.append(f"{tag}: counts or flags differ from the stacked "
                        f"step: {same}")
    if max(diffs.values()) > PARITY:
        problems.append(f"{tag}: the state differs from the stacked step's "
                        f"by {diffs}")
    per_iter = loop_launches_per_iter(records)
    print(f"  {tag}: p_iters {sf.p_iters.tolist()} (stacked "
          f"{ss.p_iters.tolist()}), mom_iters {int(sf.mom_iters)}, counts "
          f"and flags equal {all(same.values())}; max|d|/max "
          + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
          + f"; launches {counts}; per CG iteration {per_iter}; lanes "
          f"{sorted(set(calls))}")
    return {"mesh": shape, "p_iters": sf.p_iters.tolist(),
            "same": same, "diffs": diffs, "launches": counts,
            "launches_per_cg_iter": per_iter}


def full_mesh_loop(torch, full, state, dt) -> dict:
    """15c: the full-mesh pressure sweep on the device loop against the
    host loop (:func:`loop_vs_host`)."""
    from repro_torch.solvers.cg import _cg_sweep, _cg_sweep_host
    from repro_torch.solvers.cg import threshold_sq

    bands, b, x0, diag = pressure_system(full, state, dt)
    ops = full._solver_ops(full.plan_p, bands, diag)
    (bb,) = ops.dots((b, b))
    thr = threshold_sq(bb, full.p_tol, 0.0)
    return loop_vs_host(
        torch, "15c full-mesh pressure CG sweep",
        lambda: _cg_sweep(ops, b, x0, thr, full.p_maxiter),
        lambda: _cg_sweep_host(ops, b, x0, thr, full.p_maxiter))


def full_mesh_timing(torch, stacked, full, state, dt) -> dict:
    """15d: the stacked and the full-mesh step from ``state`` walked phase
    by phase in turns (:data:`FULL_MESH_TURNS`): seconds a step and ms per
    CG iteration (the ``solve_p`` walls over their iterations), with the
    full mesh's guarded launches per CG iteration."""
    from repro_torch.solvers import device_loop

    out = {"stacked": [], "full": []}
    for tag in FULL_MESH_TURNS:
        solver = stacked if tag == "stacked" else full
        device_loop.reset_loop_records()
        walk = timed_step(torch, solver, state, dt)
        cg_s = sum(v for k, v in walk["walls"].items()
                   if k.startswith("solve_p"))
        out[tag].append({"step_s": sum(walk["walls"].values()),
                         "ms_per_cg_iter": 1e3 * cg_s
                         / sum(walk["p_iters"]),
                         "launches_per_cg_iter": loop_launches_per_iter(
                             device_loop.loop_records())})
    for tag, rows in out.items():
        print(f"  15d {tag}: s a step "
              + " ".join(f"{r['step_s']:.4f}" for r in rows)
              + ", ms per CG iteration "
              + " ".join(f"{r['ms_per_cg_iter']:.4f}" for r in rows)
              + f", guarded launches per CG iteration "
              f"{rows[0]['launches_per_cg_iter']}")
    return out


def full_mesh_errors(torch, full, state, dt, problems) -> dict:
    """15e: a refined policy (set on the full-mesh solver, and at
    construction), a padded mesh and too few devices must raise."""
    from repro_torch.core.comm import make_cfd_mesh
    from repro_torch.fvm.mesh import CavityMesh, PaddedCavityMesh
    from repro_torch.fvm.piso import PisoSolver

    small = CavityMesh.cube(8, 4)
    mesh4 = [MESH_DEVICE] * 4
    cases = {
        "f32_ir at the step": lambda: full.step(state, dt),
        "f32_ir at construction": lambda: PisoSolver(
            small, alpha=2, solve_mode="full_mesh", precision="f32_ir",
            spmd_mesh=make_cfd_mesh(2, 2, devices=mesh4),
            device=MESH_DEVICE),
        "padded mesh": lambda: PisoSolver(
            PaddedCavityMesh.pad(small, 8), alpha=2, solve_mode="full_mesh",
            spmd_mesh=make_cfd_mesh(4, 2, devices=[MESH_DEVICE] * 8),
            device=MESH_DEVICE),
        "too few devices": lambda: make_cfd_mesh(
            1, PARTS, devices=[MESH_DEVICE] * (PARTS - 1)),
    }
    out = {}
    for tag, fn in cases.items():
        if tag == "f32_ir at the step":
            full.precision = "f32_ir"
        try:
            fn()
            out[tag] = None
        except ValueError as e:
            out[tag] = str(e)
        finally:
            full.precision = "f64"
        if out[tag] is None:
            problems.append(f"15e: {tag} did not raise")
    print("  15e raised: " + "; ".join(f"{k}: {v}" for k, v in out.items()))
    return out


# 15f: the full mesh over the card and its host
RANKS_HOST_POSITIONS = (28, 29)     # (a): (1, 30), two shards on the host
RANKS_CAP = 100                     # (a): the CG's iterations, capped
#                                     (cut from 200 to keep the script
#                                     inside its time)
RANKS_PARITY = 1e-10                # (a): x of max|x|, r.r relative; (b)
#                                     each field of its maximum: the dots
#                                     are summed per shard on the host
RANKS_MIX_HOST_POSITIONS = (10, 11)  # (b): (3, 4) of the 12-part mix mesh
RANKS_MIX_STEPS = 1                 # (b): cut from 2 to keep the script
#                                     inside its time as phase 18 grew
RANKS_KERNELS = ("spmv_dot", "axpy_precond")  # (a): one launch an iteration


def ranks_forms(devices, m_loc: int, nb: int, plane: int, products: int,
                solves: int = 1) -> dict:
    """kind -> the bytes ``solves`` full-mesh CGs over ``devices`` (one a
    shard, in shard order) copy between devices: each shard off the first
    shard's device takes its bands (``nb`` values a row), diagonal, ``b``
    and ``x0`` rows and hands its solution rows back, 8 B a value; each of
    the ``products`` moves one plane each way across every boundary
    between two devices."""
    off = sum(d != devices[0] for d in devices)
    cuts = sum(a != b for a, b in zip(devices, devices[1:]))
    rows = 8 * m_loc * off * solves
    return {"bands_p": nb * rows, "diag_c": rows, "b_c": rows, "x0_c": rows,
            "x_back": rows, "solve_halo": products * cuts * 2 * plane * 8}


def carried_problems(carried: dict, forms: dict, tag: str) -> list:
    """A run's bytes carried between devices by kind (``carried``: kind ->
    [bytes, s]; the collectives' ``scalars`` aside) against ``forms``."""
    got = {k: v[0] for k, v in carried.items() if k != "scalars"}
    return [] if got == forms else [f"{tag}: carried {got} between devices, "
                                    f"the closed forms {forms}"]


def ranks_cg_problems(run: dict, ref: dict, forms: dict, tag: str) -> list:
    """What 15f(a)'s CG over the ranks says went wrong against ``ref``, the
    one-device bundle's host loop (each: ``x``, ``rr``, ``k``, ``flags``
    (converged, hit_cap); ``run`` also ``kinds`` (kind -> MoveStats) and
    ``carried``): the count and flags equal, ``x`` within
    :data:`RANKS_PARITY` of ``max|x|``, ``r.r`` within it relatively, the
    bytes carried the closed forms and the record's counts."""
    out = []
    if run["k"] != ref["k"] or run["flags"] != ref["flags"]:
        out.append(f"{tag}: {run['k']} iterations, flags {run['flags']}, "
                   f"against {ref['k']}, {ref['flags']}")
    x, x_ref = run["x"], ref["x"].to(run["x"].device)
    err = float((x - x_ref).abs().max()) / max(float(x_ref.abs().max()),
                                               1e-300)
    rr, rr_ref = float(run["rr"]), float(ref["rr"])
    rr_err = abs(rr - rr_ref) / max(abs(rr_ref), 1e-300)
    if not err <= RANKS_PARITY:
        out.append(f"{tag}: x off by {err:.3e} of max|x|")
    if not rr_err <= RANKS_PARITY:
        out.append(f"{tag}: r.r {rr!r} against {rr_ref!r}")
    return (out + carried_problems(run["carried"], forms, tag)
            + moved_problems(run, tag))


def ranks_launch_problems(launches: dict, calls, k: int, lanes: int,
                          tag: str) -> list:
    """The card rank's launches of a CG over the ranks: one SpMV+dot and
    one axpy an iteration (``launches``, the counters from 0), every call
    of their wrappers on the card with the rank's ``lanes`` (``calls``,
    the lane spy's ``(kernel, lanes)``)."""
    out = [f"{tag}: {name} launched {launches.get(name, 0)} times in {k} "
           f"iterations" for name in RANKS_KERNELS
           if launches.get(name, 0) != k]
    seen = {lanes_ for _, lanes_ in calls}
    if seen != {lanes}:
        out.append(f"{tag}: the card's kernels ran with lanes "
                   f"{sorted(seen)}, not {lanes} (one a shard it holds)")
    return out


@contextlib.contextmanager
def card_lane_spy():
    """Record ``(kernel, lanes)`` of every call of the SpMV+dot and axpy
    wrappers on CUDA tensors inside the block (a CPU rank's calls of the
    same wrappers take the plain versions, and are left out)."""
    from repro_torch.kernels.krylov_fused import krylov_fused as kf

    calls = []
    names = ("spmv_dot_partials", "axpy_precond_inplace")
    originals = [getattr(kf, n) for n in names]

    def spy(name, fn):
        def call(*args, **kw):
            if any(getattr(a, "is_cuda", False) for a in args):
                calls.append((name, kw.get("lanes", 1)))
            return fn(*args, **kw)
        return call

    try:
        for name, fn in zip(names, originals):
            setattr(kf, name, spy(name, fn))
        yield calls
    finally:
        for name, fn in zip(names, originals):
            setattr(kf, name, fn)


HOST_ALONE_ITERS = 20    # (a): the host's shards' CG alone, iterations


def host_share_ms(torch, bands, diag, b, x0, plan, sel) -> float:
    """ms per CG iteration of the host rank's shards ``sel`` (a slice of
    the shard layout) alone: the same rows, bands and plain versions as a
    one-device fused bundle of those shards on ``HOST_DEVICE``, its host
    loop run for :data:`HOST_ALONE_ITERS` iterations, no card and no
    barrier."""
    from repro_torch.core.comm import from_shards, make_cfd_mesh, to_shards
    from repro_torch.solvers.cg import _cg_sweep_host
    from repro_torch.sparse.shardmap_spmv import make_fused_ops_full_mesh

    alpha = plan.alpha
    n = sel.stop - sel.start
    m_loc = plan.m_coarse // alpha

    def rows(t):
        return t.reshape(-1, m_loc)[sel].reshape(1, n * m_loc).to("cpu")

    bands_h = from_shards(to_shards(bands, alpha)[sel].to("cpu"), n)
    ops = make_fused_ops_full_mesh(
        make_cfd_mesh(1, n, devices=[HOST_DEVICE] * n), bands_h, rows(diag),
        offsets=tuple(int(o) for o in plan.dia_offsets), plane=plan.plane,
        n_coarse=1, alpha=n, m_coarse=n * m_loc)
    zero = torch.zeros((), dtype=bands.dtype)
    t0 = time.perf_counter()
    *_, k = _cg_sweep_host(ops, rows(b), rows(x0), zero, HOST_ALONE_ITERS)
    return 1e3 * (time.perf_counter() - t0) / max(k, 1)


def ranks_cg_run(torch, full, state, dt, problems) -> dict:
    """15f(a): phase 15's first pressure system from ``state`` at alpha 30,
    one CG from ``x0 = p`` capped at :data:`RANKS_CAP`, on the one-device
    fused bundle's host loop and over the ``(1, 30)`` mesh with
    :data:`RANKS_HOST_POSITIONS` on the host (the fused bundle over the
    ranks, its copies booked), plain versions refused on the card, the
    counters from 0."""
    from repro_torch.core.comm import make_cfd_mesh
    from repro_torch.core.update import MoveRecord
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solvers.cg import (_cg_sweep_host, _cg_sweep_ranks,
                                        threshold_sq)
    from repro_torch.sparse.shardmap_spmv import make_fused_ops_full_mesh

    plan, n = full.plan_p, full.spmd_mesh.n_shards
    bands, b, x0, diag = pressure_system(full, state, dt)
    one = full._solver_ops(plan, bands, diag)
    (bb,) = one.dots((b, b))
    thr = threshold_sq(bb, full.p_tol, 0.0)

    def result(x, rr, k):
        conv = bool(rr <= thr)
        return {"x": x, "rr": rr, "k": int(k),
                "flags": (conv, int(k) >= RANKS_CAP and not conv)}

    with no_plain_versions():
        got, s_ref = synced(torch, lambda: _cg_sweep_host(one, b, x0, thr,
                                                          RANKS_CAP))
    ref = result(*got)
    del one
    devices = host_mesh_devices(n, RANKS_HOST_POSITIONS)
    mesh = make_cfd_mesh(full.n_coarse, plan.alpha, devices=devices)
    tag = f"15f(a) {tuple(mesh.shape)}, shards {list(RANKS_HOST_POSITIONS)}" \
          f" on {HOST_DEVICE}"
    moves = MoveRecord()
    ops, s_build = synced(torch, lambda: make_fused_ops_full_mesh(
        mesh, bands, diag, offsets=tuple(int(o) for o in plan.dia_offsets),
        plane=plan.plane, n_coarse=full.n_coarse, alpha=plan.alpha,
        m_coarse=plan.m_coarse, moves=moves))
    reset_launch_counts()
    with no_plain_versions(cuda_only=True), card_lane_spy() as calls:
        got, s = synced(torch, lambda: _cg_sweep_ranks(ops.ranks, b, x0, thr,
                                                      RANKS_CAP))
    launches = launch_counts()
    run = dict(result(*got), kinds=dict(moves.kinds),
               carried={k: list(v) for k, v in moves.carried.items()})
    m_loc = plan.m_coarse // plan.alpha
    host_ms = host_share_ms(torch, bands, diag, b, x0, plan,
                            ops.ranks.sel[-1])
    forms = ranks_forms(devices, m_loc,
                        len(plan.dia_offsets), plan.plane, 1 + run["k"])
    card = ops.ranks.group.parts[0]
    problems += ranks_cg_problems(run, ref, forms, tag)
    problems += ranks_launch_problems(launches, calls, run["k"], len(card),
                                      tag)
    ranks = ops.ranks.last_ranks
    rec = {"mesh": list(mesh.shape), "host_positions":
           list(RANKS_HOST_POSITIONS), "iters": run["k"],
           "flags": run["flags"], "s": s, "build_s": s_build,
           "ms_per_iter": 1e3 * s / max(run["k"], 1),
           "ms_per_iter_card_alone": 1e3 * s_ref / max(ref["k"], 1),
           "ms_per_iter_host_alone": host_ms,
           "x_err": float((run["x"] - ref["x"]).abs().max())
           / max(float(ref["x"].abs().max()), 1e-300),
           "launches": {k: launches[k] for k in RANKS_KERNELS},
           "ranks": ranks, "carried": carried_rates(run["carried"]),
           "forms": forms}
    print(f"  {tag}: {run['k']} iterations (card alone {ref['k']}), flags "
          f"{run['flags']}; {rec['ms_per_iter']:.4f} ms per CG iteration "
          f"against {rec['ms_per_iter_card_alone']:.4f} on the card "
          f"alone's host loop and {host_ms:.4f} for the host's shards "
          f"alone; the copies {s_build:.3f} s; x off by {rec['x_err']:.3e} of max|x|; card "
          f"launches {rec['launches']} over {len(card)} lanes")
    for r in ranks:
        print(f"    rank {r['device']} ({r['shards']} shards): "
              f"{r['s']:.3f} s, {r['waited_s']:.3f} s of it waiting")
    print("    carried between devices by kind: " + ", ".join(
        f"{k} {v['bytes']:,} B in {v['s']:.4f} s"
        for k, v in rec["carried"].items())
        + f"; solve_halo's closed form {forms['solve_halo']:,} B "
        f"({1 + run['k']} products)  [{smi_line()}; host "
        f"{os.cpu_count()} cores]")
    return rec


def ranks_mix_run(torch, problems) -> dict:
    """15f(b): 19c's mix mesh unpadded (``mix_mesh(False)``), alpha
    ``MIX_ALPHA``, full mesh, f64, :data:`RANKS_MIX_STEPS` PISO steps from
    rest, the solver made by the launcher's registry (``make_solver``) on
    the default backend, every shard on ``MESH_DEVICE`` and then with
    :data:`RANKS_MIX_HOST_POSITIONS` on the host: counts and flags equal,
    each field within :data:`RANKS_PARITY` of its maximum, continuity
    below ``CONTINUITY``, the last step's copies between devices the
    closed forms."""
    from repro_torch.core.comm import make_cfd_mesh
    from repro_torch.fvm.piso import make_solver
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfd = mix_mesh(padded=False)
    n_c = cfd.n_parts // MIX_ALPHA
    devices = host_mesh_devices(cfd.n_parts, RANKS_MIX_HOST_POSITIONS)
    tag = f"15f(b) ({n_c}, {MIX_ALPHA}) full mesh, shards " \
          f"{list(RANKS_MIX_HOST_POSITIONS)} on {HOST_DEVICE}"
    dt = 0.5 * cfd.h
    runs = []
    for devs in ([MESH_DEVICE] * cfd.n_parts, devices):
        solver = make_solver("piso", cfd, alpha=MIX_ALPHA, device=MESH_DEVICE,
                             solve_mode="full_mesh", spmd_mesh=make_cfd_mesh(
                                 n_c, MIX_ALPHA, devices=devs))
        st0 = solver.initial_state()
        reset_launch_counts()
        with no_plain_versions(cuda_only=True):
            (st, stats), s = synced(torch, lambda: solver.run(
                RANKS_MIX_STEPS, dt, st0))
        moves = solver.moves
        runs.append({"state": st, "stats": stats, "s": s,
                     "launches": launch_counts(),
                     "kinds": {} if moves is None else dict(moves.kinds),
                     "carried": {} if moves is None else
                     {k: list(v) for k, v in moves.carried.items()},
                     "plan": solver.plan_p})
        del solver
        free_device(torch)
    ref, run = runs
    out = []
    for f in ("mom_iters", "p_iters", "converged", "hit_cap"):
        a, b = getattr(run["stats"], f), getattr(ref["stats"], f)
        if not torch.equal(a.cpu(), b.cpu()):
            out.append(f"{tag}: {f} {a.tolist()} against {b.tolist()}")
    errs = field_errors(torch, run, ref)
    out += [f"{tag}: {k} off by {v:.3e} of its maximum"
            for k, v in errs.items() if not v <= RANKS_PARITY]
    cont = run["stats"].continuity_err.tolist()
    if not max(cont) < CONTINUITY:
        out.append(f"{tag}: continuity {cont}")
    plan = run["plan"]
    last = run["stats"].p_iters[-1].tolist()
    forms = ranks_forms(devices, plan.m_coarse // MIX_ALPHA,
                        len(plan.dia_offsets), plan.plane,
                        sum(1 + k for k in last), solves=len(last))
    out += carried_problems(run["carried"], forms, tag)
    out += moved_problems(run, tag)
    problems += out
    rec = {"mesh": [n_c, MIX_ALPHA], "host_positions":
           list(RANKS_MIX_HOST_POSITIONS), "s": run["s"],
           "s_card_alone": ref["s"], "p_iters": run["stats"].p_iters.tolist(),
           "mom_iters": run["stats"].mom_iters.tolist(), "continuity": cont,
           "max_err": errs, "carried": carried_rates(run["carried"]),
           "forms": forms, "launches": run["launches"]}
    print(f"  {tag}: {RANKS_MIX_STEPS} steps {run['s']:.3f} s, "
          f"{run['s'] / RANKS_MIX_STEPS:.3f} s a step (card alone "
          f"{ref['s'] / RANKS_MIX_STEPS:.3f} s); p_iters {rec['p_iters']}, "
          f"mom_iters {rec['mom_iters']}; max err "
          f"{max(errs.values()):.2e}; continuity {max(cont):.2e}; "
          f"solve_halo {run['carried'].get('solve_halo', [0])[0]:,} B in the "
          f"last step (closed form {forms['solve_halo']:,})")
    return rec


def full_mesh_ranks(torch, full, state, dt, problems) -> dict:
    """15f: (a) and (b), each timed; a part that raises is a problem."""
    out = {}
    print(f"  15f the full mesh over {MESH_DEVICE} and the host's CPU "
          f"({os.cpu_count()} cores, {torch.get_num_threads()} threads)")
    for key, part in (("a", lambda: ranks_cg_run(torch, full, state, dt,
                                                 problems)),
                      ("b", lambda: ranks_mix_run(torch, problems))):
        t0 = time.perf_counter()
        try:
            out[key] = part()
            out[key]["phase_s"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — collected, fails the phase
            traceback.print_exc()
            problems.append(f"15f({key}): {type(e).__name__}: {e}")
        free_device(torch)
    out["s"] = sum(v["phase_s"] for v in out.values())
    print(f"  15f {out['s']:.1f} s")
    return out


def full_mesh_phase(torch, state3) -> dict:
    """Phase 15 (see the module docstring); its checks are collected and
    fail the run after its parts have printed."""
    print(f"[15] the full mesh: {N}^3, {PARTS} shards on {MESH_DEVICE}")
    t0 = time.perf_counter()
    problems = []
    stacked, full, dt = full_mesh_solvers(torch)
    out = {"setup_s": time.perf_counter() - t0}
    out["spmv"] = full_mesh_spmv(torch, stacked, full, state3, dt, problems)
    out["steps"] = {alpha: full_mesh_step(torch, stacked, full, state3, dt,
                                          alpha, problems)
                    for alpha in FULL_MESH_ALPHAS}
    stacked.rebind_alpha(FULL_MESH_ALPHAS[0])
    full.rebind_alpha(FULL_MESH_ALPHAS[0])
    try:
        out["loop"] = full_mesh_loop(torch, full, state3, dt)
    except SmokeFailure as e:
        problems.append(str(e))
    out["timing"] = full_mesh_timing(torch, stacked, full, state3, dt)
    out["errors"] = full_mesh_errors(torch, full, state3, dt, problems)
    out["ranks"] = full_mesh_ranks(torch, full, state3, dt, problems)
    out["s"] = time.perf_counter() - t0
    print(f"  [15] {out['s']:.1f} s")
    for p in problems:
        print(f"  FAILED: {p}")
    require(not problems, f"phase 15: {len(problems)} check(s) failed")
    return out


# ---------------------------------------------------------------------------
# phase 19: the stacked solve over a (solve, assemble) mesh
# ---------------------------------------------------------------------------
ASSEMBLY_MESH_ALPHAS = (30, 15)     # 19b's references
# bytes between positions a pressure update moves on the (30 / alpha,
# alpha) mesh under device_direct, (alpha - 1) * n_coarse * L * 8 with L =
# 2,155,020 values a fine part (plan_for_mesh(CavityMesh.cube(210, 30)))
ASSEMBLY_MESH_BYTES = {30: 499_964_640, 15: 482_724_480}
MOVE_KINDS = ("update_mom", "update_p", "b_c", "x0_c", "diag_c", "x_back")


def mesh_move_forms(n_c: int, alpha: int, L: int, Lm: int, m: int,
                    updates: int, solves: int, itemsize: int = 8) -> dict:
    """Each move kind's bytes between positions in one step over the
    ``(n_c, alpha)`` mesh, by schedule, from the closed forms: a pressure
    update ``(alpha - 1) * n_c * L`` values (device_direct) or ``2 * n_c *
    alpha * L`` (host_buffer: to the host and on to the owner); the
    momentum update 0 (it stays in the fine layout) or ``2 * n_c * alpha *
    Lm``; each solve's ``b_c``, ``x0_c``, ``diag_c`` and the solution back
    ``(alpha - 1) * n_c * m`` values each."""
    P = n_c * alpha
    operand = solves * (alpha - 1) * n_c * m * itemsize
    same = dict.fromkeys(("b_c", "x0_c", "diag_c", "x_back"), operand)
    return {"device_direct": dict(same, update_mom=0, update_p=updates * (
        alpha - 1) * n_c * L * itemsize),
        "host_buffer": dict(same, update_mom=2 * P * Lm * itemsize,
                            update_p=updates * 2 * P * L * itemsize)}


def move_problems(got: dict, want: dict, tag: str) -> list:
    """What a step's move record says went wrong against the closed forms
    (``got``: kind -> MoveStats)."""
    out = [f"{tag}: {k} moved {got[k].positions if k in got else None} B "
           f"between positions, not {want[k]}"
           for k in MOVE_KINDS
           if k not in got or got[k].positions != want[k]]
    if "halo" not in got or got["halo"].positions <= 0:
        out.append(f"{tag}: no halo planes counted")
    return out


def assembly_mesh_solvers(alpha: int, cache) -> tuple:
    """The main path's solver at ``alpha`` without a mesh, and over the
    ``(30 / alpha, alpha)`` mesh on ``MESH_DEVICE`` under each schedule,
    all through the launcher (``--mesh-devices``), plans from ``cache``."""
    from repro_torch.launch.case import build_parser, build_solver

    base = list(MAIN_ARGS)
    base[base.index("--alpha") + 1] = str(alpha)
    mesh = ["--mesh-devices", ",".join([MESH_DEVICE] * PARTS)]
    args = build_parser().parse_args(base)
    plain = build_solver(args, plan_cache=cache)
    return (plain, build_solver(build_parser().parse_args(base + mesh),
                                plan_cache=cache),
            build_solver(build_parser().parse_args(
                base + mesh + ["--schedule", "host_buffer"]),
                plan_cache=cache), args.co * plain.mesh.h)


def assembly_mesh_alpha(torch, alpha, cache, state3, turn, problems,
                        keep=None) -> dict:
    """19 at one ``alpha``: a step of the solver without a mesh and of the
    mesh solvers from ``state3`` (the mesh ones on it in the assembly
    layout), plain versions refused, launch counters from 0 for each.
    ``keep`` receives the mesh runs by schedule, 19b's references."""
    from repro_torch.core.comm import assembly_layout, assembly_sharding
    from repro_torch.core.cost_model import H100, CostModel
    from repro_torch.core.layout import Sharded, unshard
    from repro_torch.fvm.piso import PisoState
    from repro_torch.kernels import launch_counts, reset_launch_counts

    plain, mesh, hb, dt = assembly_mesh_solvers(alpha, cache)
    n_c = PARTS // alpha
    grid = mesh.spmd_mesh
    laid = PisoState(*(assembly_layout(t, grid) for t in state3))
    order = ("plain", "mesh") if turn % 2 == 0 else ("mesh", "plain")
    runs = {}
    for tag in order + ("host_buffer",):
        solver = {"plain": plain, "mesh": mesh, "host_buffer": hb}[tag]
        st_in = state3 if tag == "plain" else laid
        reset_launch_counts()
        with no_plain_versions():
            (st, stats), s = synced(torch, lambda: solver.step(st_in, dt))
        if tag != "plain":
            if not all(isinstance(t, Sharded) and t.sharding
                       == assembly_sharding(grid, t.ndim - 1) for t in st):
                problems.append(f"19 alpha {alpha} {tag}: the state did not "
                                f"come back in the assembly layout")
            st = PisoState(*(unshard(t, MESH_DEVICE) for t in st))
        runs[tag] = {"state": st, "stats": stats, "s": s,
                     "launches": launch_counts(),
                     "moves": (None if solver.moves is None
                               else dict(solver.moves.kinds))}
    torch.cuda.synchronize()
    if keep is not None:
        keep.update(device_direct=runs["mesh"],
                    host_buffer=runs["host_buffer"])
    ref = runs["plain"]
    tag0 = f"19 alpha {alpha} ({n_c}, {alpha})"
    try:
        require_launched(ref["launches"], tag0)
    except SmokeFailure as e:
        problems.append(str(e))
    same = {}
    for tag in ("mesh", "host_buffer"):
        r = runs[tag]
        same[tag] = {
            "state": all(same_bits(torch, a, b)
                         for a, b in zip(r["state"], ref["state"])),
            "stats": all(same_bits(torch, a, b)
                         for a, b in zip(r["stats"], ref["stats"])),
            "launches": r["launches"] == ref["launches"]}
        if not all(same[tag].values()):
            problems.append(f"{tag0} {tag}: not the step without a mesh: "
                            f"{same[tag]}")
    plan = mesh.plan_p
    forms = mesh_move_forms(n_c, alpha, plan.buffer_len,
                            mesh.plan_mom.buffer_len, mesh.mesh.n_cells,
                            updates=1 if mesh.pipelined else
                            mesh.n_correctors, solves=mesh.n_correctors)
    dd, hbm = runs["mesh"]["moves"], runs["host_buffer"]["moves"]
    problems.extend(move_problems(dd, forms["device_direct"],
                                  f"{tag0} device_direct"))
    problems.extend(move_problems(hbm, forms["host_buffer"],
                                  f"{tag0} host_buffer"))
    if dd["update_p"].positions != ASSEMBLY_MESH_BYTES[alpha]:
        problems.append(f"{tag0}: a pressure update moved "
                        f"{dd['update_p'].positions:,} B, not "
                        f"{ASSEMBLY_MESH_BYTES[alpha]:,}")
    if any(v.devices for v in dd.values()):
        problems.append(f"{tag0}: device_direct moved bytes between "
                        f"devices: {dd}")
    if any(hbm[k].positions < dd[k].positions for k in dd):
        problems.append(f"{tag0}: host_buffer moved less than "
                        f"device_direct")
    model = CostModel(H100, n_dofs=N ** 3)
    owner = dd["update_p"].positions
    out = {
        "mesh": [n_c, alpha], "p_iters": ref["stats"].p_iters.tolist(),
        "mom_iters": int(ref["stats"].mom_iters),
        "same": same, "launches": runs["mesh"]["launches"],
        "s_plain": ref["s"], "s_mesh": runs["mesh"]["s"],
        "s_host_buffer": runs["host_buffer"]["s"],
        "moves": {tag: {k: v._asdict() for k, v in m.items()}
                  for tag, m in (("device_direct", dd),
                                 ("host_buffer", hbm))},
        "update_p_bytes": owner,
        # JAX's solve layout holds the row at every "assemble" position
        "replicated_update_p_bytes": alpha * owner,
        "model_bytes": (model.nnz_per_row + 1) * model.n_dofs
        * model.bytes_per_val,
        "model_t_repartition_s": model.t_repartition(PARTS, n_c),
        "total_moved": {tag: sum(v.positions for v in m.values())
                        for tag, m in (("device_direct", dd),
                                       ("host_buffer", hbm))}}
    print(f"  {tag0}: p_iters {out['p_iters']}, every step bitwise the step "
          f"without a mesh {same}; s a step without / with the mesh "
          f"{ref['s']:.4f} / {runs['mesh']['s']:.4f} (host_buffer "
          f"{runs['host_buffer']['s']:.4f}); a pressure update moves "
          f"{owner:,} B between positions (JAX's replicated layout "
          f"{alpha * owner:,}; t_repartition's volume "
          f"{out['model_bytes']:,}); host_buffer {hbm['update_p'].positions:,}"
          f" ({hbm['update_p'].devices:,} between devices); halo "
          f"{dd['halo'].positions:,}; the step in all "
          f"{out['total_moved']['device_direct']:,} B")
    return out


# 19b: (30 / alpha, alpha) meshes whose positions name the card and the
# host's CPU; every owner stays on the card, so the pressure CG is the
# card's and the CPU positions assemble, update and solve their momentum
DISTINCT_MESH_DEVICES = {
    30: [MESH_DEVICE] * 28 + ["cpu"] * 2,                             # (1, 30)
    15: [MESH_DEVICE] * 14 + ["cpu"] + [MESH_DEVICE] * 14 + ["cpu"],  # (2, 15)
}
DISTINCT_PARITY = 1e-10     # of each field's maximum, against the same mesh
#                             on the card alone: the momentum solve's dots
#                             are summed over the two devices
# 19b's schedule a mesh: both stay exercised on the card (the CPU tests
# run both on every mesh)
DISTINCT_SCHEDULES = {30: "device_direct", 15: "host_buffer"}
FINE_PHASES = ("assemble_mom", "assemble_p_mat", "assemble_p", "correct",
               "grad_p")
FIELD_NAMES = ("U", "p", "phi", "phi_if", "phi_b")


def distinct_problems(torch, run: dict, ref: dict, tag: str) -> list:
    """What a step over distinct devices says went wrong against the same
    mesh on the card alone (``run``/``ref``: ``state``, ``stats``,
    ``launches``; ``run`` also ``kinds`` (kind -> MoveStats) and
    ``carried`` (kind -> [bytes, s])): each field within
    :data:`DISTINCT_PARITY` of its maximum, the counts and flags equal,
    the card's launches the card-alone step's, and every kind's bytes
    copied between devices its count between devices."""
    out = []
    for name, a, b in zip(FIELD_NAMES, run["state"], ref["state"]):
        b = b.to(a.device)
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
        if not err <= DISTINCT_PARITY:
            out.append(f"{tag}: {name} off by {err:.3e} of its maximum")
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        a, b = getattr(run["stats"], f), getattr(ref["stats"], f)
        if not torch.equal(a.cpu(), b.cpu()):
            out.append(f"{tag}: {f} {a.tolist()} against {b.tolist()}")
    if run["launches"] != ref["launches"]:
        out.append(f"{tag}: the card launched {run['launches']}, alone "
                   f"{ref['launches']}")
    return out + moved_problems(run, tag)


def rank_seconds(last_ranks) -> list:
    """Each rank's seconds from a timed step's phase records: the fine
    phases' (and the part of them spent waiting at collectives), the
    momentum and pressure solves', the updates', the whole step's."""
    out = []
    for r in last_ranks:
        ph = r["phases"]

        def total(names, i=2):
            return sum(p[i] for p in ph if p[0].split("[")[0] in names)

        out.append({
            "device": r["device"], "parts": r["parts"],
            "fine_s": total(FINE_PHASES),
            "fine_waited_s": total(FINE_PHASES, 3),
            "solve_mom_s": total(("solve_mom",)),
            "solve_p_s": total(("solve_p",)),
            "update_s": total(("update_mom", "update_p")),
            "step_s": sum(p[2] for p in ph),
            "waited_s": sum(p[3] for p in ph)})
    return out


def moved_problems(run: dict, tag: str) -> list:
    """Every kind's bytes copied between devices its count between
    devices (``run``: ``kinds``, kind -> MoveStats, and ``carried``, kind
    -> [bytes, s])."""
    carried = {k: v[0] for k, v in run["carried"].items() if k != "scalars"}
    counted = {k: v.devices for k, v in run["kinds"].items() if v.devices}
    return ([] if carried == counted else
            [f"{tag}: carried {carried} between devices, counted {counted}"])


def carried_rates(carried: dict) -> dict:
    """kind -> bytes, seconds and GB/s copied between devices."""
    return {k: {"bytes": v[0], "s": v[1],
                "GB_per_s": v[0] / v[1] / 1e9 if v[1] > 0 else None}
            for k, v in carried.items()}


def print_ranks(ranks, moves, tail: str) -> None:
    """Each rank's seconds (:func:`rank_seconds`) and the bytes and
    seconds carried between devices by kind, ``tail`` after them."""
    for r in ranks:
        print(f"    rank {r['device']} ({r['parts']} parts): fine phases "
              f"{r['fine_s']:.3f} s ({r['fine_waited_s']:.3f} s of it "
              f"waiting), momentum solve {r['solve_mom_s']:.3f} s, pressure "
              f"solve {r['solve_p_s']:.3f} s, updates {r['update_s']:.3f} s,"
              f" the step {r['step_s']:.3f} s ({r['waited_s']:.3f} s "
              f"waiting)")
    print(f"    carried between devices by kind: " + ", ".join(
        f"{k} {v['bytes']:,} B in {v['s']:.4f} s" for k, v in moves.items())
        + tail)


def distinct_mesh_run(torch, alpha, schedule, cache, state3, ref,
                      problems) -> dict:
    """19b at one mesh and schedule: the main path's solver over the mesh
    of :data:`DISTINCT_MESH_DEVICES` through the launcher, one timed step
    from ``state3`` in the assembly layout (the card synchronised at each
    phase boundary and before each collective, so a copy's seconds are
    the copy's), plain versions refused on the card, launch counters from
    0, held to ``ref``, the same mesh's step on the card alone."""
    from repro_torch.core.comm import assembly_layout, assembly_sharding
    from repro_torch.core.layout import Sharded, unshard
    from repro_torch.fvm.piso import PisoState
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.case import build_parser, build_solver

    n_c = PARTS // alpha
    tag = f"19b ({n_c}, {alpha}) {schedule}"
    base = list(MAIN_ARGS)
    base[base.index("--alpha") + 1] = str(alpha)
    args = build_parser().parse_args(base + [
        "--mesh-devices", ",".join(DISTINCT_MESH_DEVICES[alpha]),
        "--schedule", schedule])
    solver = build_solver(args, plan_cache=cache)
    dt = args.co * solver.mesh.h
    grid = solver.spmd_mesh
    laid = PisoState(*(assembly_layout(t, grid) for t in state3))
    solver._distinct.timing = True
    reset_launch_counts()
    with no_plain_versions(cuda_only=True):
        (st, stats), s = synced(torch, lambda: solver.step(laid, dt))
    launches = launch_counts()
    if not all(isinstance(t, Sharded) and t.sharding
               == assembly_sharding(grid, t.ndim - 1) for t in st):
        problems.append(f"{tag}: the state did not come back in the "
                        f"assembly layout")
    on_cpu = [k for k, d in enumerate(grid.flat()) if d.type == "cpu"]
    if any(st.U.shards[k].device.type != "cpu" for k in on_cpu):
        problems.append(f"{tag}: a CPU position's state came back elsewhere")
    run = {"state": PisoState(*(unshard(t, MESH_DEVICE) for t in st)),
           "stats": stats, "launches": launches,
           "kinds": dict(solver.moves.kinds),
           "carried": {k: list(v) for k, v in solver.moves.carried.items()}}
    problems.extend(distinct_problems(torch, run, ref, tag))
    same = {name: same_bits(torch, a, b) for name, a, b in
            zip(FIELD_NAMES, run["state"], ref["state"])}
    ranks = rank_seconds(solver._distinct.last_ranks)
    moves = carried_rates(run["carried"])
    out = {"mesh": [n_c, alpha], "schedule": schedule,
           "cpu_positions": on_cpu, "s": s, "s_card_alone": ref["s"],
           "p_iters": stats.p_iters.tolist(),
           "mom_iters": int(stats.mom_iters),
           "bitwise": same, "launches": launches, "ranks": ranks,
           "carried": moves,
           "counted_devices": {k: v.devices for k, v in run["kinds"].items()},
           "max_err": {name: float((a - b).abs().max())
                       / max(float(b.abs().max()), 1e-300)
                       for name, a, b in zip(FIELD_NAMES, run["state"],
                                             ref["state"])}}
    upd = moves.get("update_p", {})
    print(f"  {tag}: CPU positions {on_cpu}; {s:.3f} s a step (card alone "
          f"{ref['s']:.3f} s); p_iters {out['p_iters']}, mom_iters "
          f"{out['mom_iters']}; bitwise {same}; max err "
          f"{max(out['max_err'].values()):.2e}")
    print_ranks(ranks, moves, f"; the pressure update host->card "
                f"{upd.get('bytes', 0):,} B at {upd.get('GB_per_s') or 0:.2f}"
                f" GB/s  [{smi_line()}]")
    return out


# 19c: the refined policies and a padded mesh over the card and its host,
# every owner on the card
REFINED_ALPHA = 30       # (a): 19b's (1, 30) mesh under f32_ir
REFINED_PARITY = 1e-5    # (a): of each field's maximum against the card
#                          alone (PERF.md §2: the card's refined bar)
REFINED_REL_SLACK = 0.25  # (a): a solve's inner total within this share of
#                          the card alone's (tests/test_torch_precision.py's
#                          PISO-level P_ITERS_REL_SLACK): the momentum's f32
#                          dots are summed over two devices
MIX_PARTS, MIX_ALPHA = 12, 4  # (b), (c): 13c's mix mesh of 12 parts
PADDED_HOST_POSITIONS = (11, 15)  # (b): (4, 4) padded to SMALL_CLASS: one
#                          real part and one padding part on the host
BF16_HOST_POSITIONS = (7, 11)    # (c): (3, 4), unpadded
BF16_P_MAXITER = 200
HOST_DEVICE = "cpu"


def host_mesh_devices(n: int, on_host) -> list:
    """``n`` positions on ``MESH_DEVICE``, those of ``on_host`` on
    ``HOST_DEVICE``."""
    return [HOST_DEVICE if k in on_host else MESH_DEVICE for k in range(n)]


def mix_mesh(padded: bool):
    """(b), (c): the ``MIX_PARTS``-part mesh of 13c's serving mix
    (``mesh_mix`` at ``SMALL_ARGS``), padded to ``SMALL_CLASS`` parts for
    (b)."""
    from repro_torch.fvm.mesh import PaddedCavityMesh
    from repro_torch.launch.serve import mesh_mix

    (mesh,) = [m for m in mesh_mix(serve_args(SMALL_ARGS, "cpu"))
               if m.n_parts == MIX_PARTS]
    return PaddedCavityMesh.pad(mesh, SMALL_CLASS) if padded else mesh


def refined_halo_bytes(solves, mesh, owners, plane: int,
                       itemsize: int) -> int:
    """The bytes between devices the ``solve_halo`` closed form counts for
    the refined solves ``solves`` (``refined_solves`` rows) of a system
    whose parts sit at the positions ``owners``: each solve's f64 replays
    (one, then one a pass) at 8 B a value, its inner sweeps' products (one
    a pass, then one a CG iteration or two a BiCGStab iteration) at
    ``itemsize``."""
    from repro_torch.core.update import solve_halo_moves

    f64 = solve_halo_moves(mesh, owners, plane * 8).devices
    low = solve_halo_moves(mesh, owners, plane * itemsize).devices
    return sum((1 + passes) * f64 + (passes + (1 if kind == "cg" else 2)
                                     * inner) * low
               for kind, passes, inner in solves)


def mesh_step(torch, solver, state, dt, steps: int):
    """``steps`` steps of ``solver`` from ``state`` (laid out over its
    mesh), plain versions refused on the card's tensors, the launch
    counters from 0: the state unsharded on ``MESH_DEVICE``,
    the stats (one step's; a step axis for more), the launches, the
    seconds, the refined solves of the card's rank, the moves."""
    from repro_torch.core.comm import assembly_layout
    from repro_torch.core.layout import unshard
    from repro_torch.fvm.piso import PisoState
    from repro_torch.kernels import launch_counts, reset_launch_counts

    laid = PisoState(*(assembly_layout(t, solver.spmd_mesh) for t in state))
    if solver._distinct is not None:
        solver._distinct.timing = True

    def go():
        if steps == 1:
            return solver.step(laid, dt)
        return solver.run(steps, dt, laid)

    reset_launch_counts()
    with refined_solves() as solves, no_plain_versions(cuda_only=True):
        (st, stats), s = synced(torch, go)
    return {"state": PisoState(*(unshard(t, MESH_DEVICE) for t in st)),
            "stats": stats, "launches": launch_counts(), "s": s,
            "solves": solves.get("rank0", solves.get("MainThread", [])),
            "kinds": dict(solver.moves.kinds),
            "carried": {k: list(v) for k, v in solver.moves.carried.items()}}


def field_errors(torch, run: dict, ref: dict, finite_only=False) -> dict:
    """Each field's largest difference over its largest value (where both
    are finite with ``finite_only``)."""
    out = {}
    for name, a, b in zip(FIELD_NAMES, run["state"], ref["state"]):
        b = b.to(a.device)
        if finite_only:
            keep = torch.isfinite(a) & torch.isfinite(b)
            a, b = a[keep], b[keep]
        out[name] = (float((a - b).abs().max())
                     / max(float(b.abs().max()), 1e-300)) if a.numel() \
            else None
    return out


def refined_main_run(torch, cache, state3, ref, problems) -> dict:
    """19c(a): the main path's solver under ``f32_ir`` over 19b's ``(1,
    30)`` mesh (``device_direct``), one timed step from ``state3``, held
    to ``ref`` (phase 9's ``f32_ir`` step from the same state; run here on
    the same mesh naming ``MESH_DEVICE`` alone when phase 9 did not run):
    each field within ``REFINED_PARITY`` of its maximum, the flags and
    each solve's passes equal, each inner total within
    ``REFINED_REL_SLACK``, the card's launches equal where every count is,
    carried = counted by kind and ``solve_halo`` the closed form at 8 and
    4 B."""
    from repro_torch.core.update import owner_positions, part_positions
    from repro_torch.launch.case import build_parser, build_solver

    alpha = REFINED_ALPHA
    n_c = PARTS // alpha
    tag = f"19c(a) ({n_c}, {alpha}) f32_ir"
    base = list(MAIN_ARGS)
    base[base.index("--alpha") + 1] = str(alpha)

    def build(devices):
        args = build_parser().parse_args(base + [
            "--mesh-devices", ",".join(devices)])
        solver = build_solver(args, plan_cache=cache)
        solver.precision = "f32_ir"
        return solver, args.co * solver.mesh.h

    if ref is None:
        alone, dt = build([MESH_DEVICE] * PARTS)
        ref = mesh_step(torch, alone, state3, dt, 1)
        del alone
        free_device(torch)
    solver, dt = build(DISTINCT_MESH_DEVICES[alpha])
    grid = solver.spmd_mesh
    run = mesh_step(torch, solver, state3, dt, 1)
    errs = field_errors(torch, run, ref)
    out = []
    for name, err in errs.items():
        if not err <= REFINED_PARITY:
            out.append(f"{tag}: {name} off by {err:.3e} of its maximum")
    for f in ("converged", "diverged", "hit_cap"):
        a, b = getattr(run["stats"], f), getattr(ref["stats"], f)
        if not torch.equal(a.cpu(), b.cpu()):
            out.append(f"{tag}: {f} {a.tolist()} against {b.tolist()}")
    rows, ref_rows = run["solves"], ref["solves"]
    if [r[:2] for r in rows] != [r[:2] for r in ref_rows]:
        out.append(f"{tag}: solves (kind, passes) {[r[:2] for r in rows]} "
                   f"against {[r[:2] for r in ref_rows]}")
    for r, w in zip(rows, ref_rows):
        if abs(r[2] - w[2]) > REFINED_REL_SLACK * w[2]:
            out.append(f"{tag}: a {r[0]} solve's inner total {r[2]} "
                       f"against {w[2]}")
    counts_equal = rows == ref_rows
    if counts_equal and run["launches"] != ref["launches"]:
        out.append(f"{tag}: the card launched {run['launches']}, alone "
                   f"{ref['launches']}")
    out += moved_problems(run, tag)
    plane = solver.mesh.plane
    co = solver._distinct.group.coarse(n_c)
    halo = refined_halo_bytes([r for r in rows if r[0] == "bicgstab"], grid,
                              part_positions(grid, PARTS), plane, 4)
    if co["local"] is None:
        halo += refined_halo_bytes([r for r in rows if r[0] == "cg"], grid,
                                   owner_positions(grid, n_c), plane, 4)
    got = run["carried"].get("solve_halo", [0])[0]
    if got != halo:
        out.append(f"{tag}: solve_halo carried {got:,} B, the closed forms "
                   f"at 8 and 4 B give {halo:,}")
    problems += out
    ranks = rank_seconds(solver._distinct.last_ranks)
    moves = carried_rates(run["carried"])
    stats = run["stats"]
    rec = {"mesh": [n_c, alpha], "schedule": solver.update_schedule,
           "s": run["s"], "s_card_alone": ref["s"],
           "p_iters": stats.p_iters.tolist(),
           "mom_iters": int(stats.mom_iters), "solves": rows,
           "solves_card_alone": ref_rows, "counts_equal": counts_equal,
           "launches": run["launches"], "launches_card_alone":
           ref["launches"], "max_err": errs, "ranks": ranks,
           "carried": moves, "solve_halo_closed_form": halo,
           "momentum_share": ranks[0]["solve_mom_s"] / ranks[0]["step_s"]
           if ranks[0]["step_s"] > 0 else None}
    print(f"  {tag}: {run['s']:.3f} s a step (card alone {ref['s']:.3f} s);"
          f" p_iters {rec['p_iters']}, mom_iters {rec['mom_iters']}; "
          f"(kind, passes, inner) {rows} against {ref_rows}; max err "
          f"{max(errs.values()):.2e}; launches {run['launches']} (alone "
          f"{ref['launches']}); the momentum's share of the card's step "
          f"{rec['momentum_share'] or 0:.3f}")
    print_ranks(ranks, moves, f"; solve_halo's closed form at 8 and 4 B "
                f"{halo:,} B  [{smi_line()}; host {os.cpu_count()} cores]")
    return rec


def mix_mesh_runs(torch, tag, cfd, n_c, on_host, steps, problems,
                  **kw) -> tuple:
    """(b), (c): ``cfd`` stepped ``steps`` times from rest over the ``(n_c,
    MIX_ALPHA)`` mesh naming ``MESH_DEVICE`` alone and with the positions
    ``on_host`` on ``HOST_DEVICE`` (every owner checked to be on the
    card), ``kw`` the solvers' settings; the two runs."""
    from repro_torch.core.comm import make_cfd_mesh
    from repro_torch.core.update import owner_positions
    from repro_torch.fvm.piso import PisoSolver

    n = n_c * MIX_ALPHA
    devices = host_mesh_devices(n, on_host)
    owners = owner_positions(make_cfd_mesh(n_c, MIX_ALPHA, devices=devices),
                             n_c)
    if any(devices[k] != MESH_DEVICE for k in owners):
        problems.append(f"{tag}: an owner off {MESH_DEVICE}: {owners}")
    dt = 0.5 * cfd.h
    runs = []
    for devs in ([MESH_DEVICE] * n, devices):
        solver = PisoSolver(cfd, alpha=MIX_ALPHA, device=MESH_DEVICE,
                            spmd_mesh=make_cfd_mesh(n_c, MIX_ALPHA,
                                                    devices=devs), **kw)
        runs.append(mesh_step(torch, solver, solver.initial_state(), dt,
                              steps))
        del solver
    return runs


def padded_mix_run(torch, problems) -> dict:
    """19c(b): the mix mesh padded to ``SMALL_CLASS``, f64, 2 steps, one
    real and one padding position on the host: within
    ``DISTINCT_PARITY`` of the card alone, counts and flags equal, the
    padding parts' fields bitwise the card alone's."""
    cfd = mix_mesh(padded=True)
    n_c = cfd.n_parts // MIX_ALPHA
    tag = f"19c(b) ({n_c}, {MIX_ALPHA}) padded {cfd.n_parts_real}->" \
          f"{cfd.n_parts}"
    ref, run = mix_mesh_runs(torch, tag, cfd, n_c, PADDED_HOST_POSITIONS, 2,
                             problems)
    errs = field_errors(torch, run, ref)
    out = [f"{tag}: {k} off by {v:.3e} of its maximum"
           for k, v in errs.items() if not v <= DISTINCT_PARITY]
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        a, b = getattr(run["stats"], f), getattr(ref["stats"], f)
        if not torch.equal(a.cpu(), b.cpu()):
            out.append(f"{tag}: {f} {a.tolist()} against {b.tolist()}")
    real = cfd.n_parts_real
    padding = all(same_bits(torch, a[real:], b[real:].to(a.device))
                  for a, b in zip(run["state"], ref["state"]))
    if not padding:
        out.append(f"{tag}: the padding parts' fields moved")
    out += moved_problems(run, tag)
    problems += out
    rec = {"mesh": [n_c, MIX_ALPHA], "parts": [real, cfd.n_parts],
           "host_positions": list(PADDED_HOST_POSITIONS), "s": run["s"],
           "s_card_alone": ref["s"], "p_iters": run["stats"].p_iters.tolist(),
           "mom_iters": run["stats"].mom_iters.tolist(), "max_err": errs,
           "padding_bitwise": padding}
    print(f"  {tag}: host positions {list(PADDED_HOST_POSITIONS)}; 2 steps "
          f"{run['s']:.3f} s (card alone {ref['s']:.3f} s); p_iters "
          f"{rec['p_iters']}; max err {max(errs.values()):.2e}; padding "
          f"parts bitwise {padding}")
    return rec


def bf16_mix_run(torch, problems) -> dict:
    """19c(c): the mix mesh unpadded under ``bf16_ir``, the pressure capped
    at ``BF16_P_MAXITER``, one step: its verdict and each solve's passes
    equal the card alone's; the fields compared where both are finite
    (reported, no bar)."""
    cfd = mix_mesh(padded=False)
    n_c = cfd.n_parts // MIX_ALPHA
    tag = f"19c(c) ({n_c}, {MIX_ALPHA}) bf16_ir"
    ref, run = mix_mesh_runs(torch, tag, cfd, n_c, BF16_HOST_POSITIONS, 1,
                             problems, precision="bf16_ir",
                             p_maxiter=BF16_P_MAXITER)
    out = []
    for f in ("converged", "diverged", "hit_cap"):
        a, b = getattr(run["stats"], f), getattr(ref["stats"], f)
        if not torch.equal(a.cpu(), b.cpu()):
            out.append(f"{tag}: {f} {a.tolist()} against {b.tolist()}")
    passes = [r[:2] for r in run["solves"]]
    if passes != [r[:2] for r in ref["solves"]]:
        out.append(f"{tag}: solves (kind, passes) {passes} against "
                   f"{[r[:2] for r in ref['solves']]}")
    out += moved_problems(run, tag)
    problems += out
    errs = field_errors(torch, run, ref, finite_only=True)
    rec = {"mesh": [n_c, MIX_ALPHA], "verdict": flags(run["stats"]),
           "solves": run["solves"], "solves_card_alone": ref["solves"],
           "s": run["s"], "s_card_alone": ref["s"], "max_err_finite": errs}
    print(f"  {tag}: {rec['verdict']} (card alone {flags(ref['stats'])}); "
          f"(kind, passes, inner) {run['solves']} against {ref['solves']}; "
          f"{run['s']:.3f} s (card alone {ref['s']:.3f} s); max err where "
          f"both are finite {errs}")
    return rec


def assembly_mesh_phase(torch, state3, f32_step=None) -> dict:
    """Phase 19 (see the module docstring); its checks are collected and
    fail the run after its parts have printed.  ``f32_step``: phase 9's
    ``f32_ir`` step from ``state3``, 19c(a)'s reference (None: 19c(a) runs
    its own)."""
    from repro_torch.core.controller import PlanCache

    print(f"[19] the stacked solve over a (solve, assemble) mesh: {N}^3, "
          f"{PARTS} positions on {MESH_DEVICE}, alpha "
          f"{ASSEMBLY_MESH_ALPHAS}")
    t0 = time.perf_counter()
    problems = []
    cache = PlanCache()
    out = {"alphas": {}, "distinct": {}, "refined": {}}
    refs = {alpha: {} for alpha in DISTINCT_MESH_DEVICES}
    for turn, alpha in enumerate(ASSEMBLY_MESH_ALPHAS):
        try:
            out["alphas"][alpha] = assembly_mesh_alpha(
                torch, alpha, cache, state3, turn, problems,
                keep=refs.get(alpha))
        except Exception as e:  # noqa: BLE001 — collected, fails the phase
            traceback.print_exc()
            problems.append(f"19 alpha {alpha}: {type(e).__name__}: {e}")
        free_device(torch)
    print(f"[19b] the same meshes over distinct devices: positions on "
          f"{MESH_DEVICE} and the host's CPU ({os.cpu_count()} cores, "
          f"{torch.get_num_threads()} threads), one step a mesh")
    for alpha, schedule in DISTINCT_SCHEDULES.items():
        tag = f"19b ({PARTS // alpha}, {alpha}) {schedule}"
        ref = refs[alpha].get(schedule)
        if ref is None:
            problems.append(f"{tag}: no run on {MESH_DEVICE} alone")
            continue
        try:
            out["distinct"][f"{alpha} {schedule}"] = distinct_mesh_run(
                torch, alpha, schedule, cache, state3, ref, problems)
        except Exception as e:  # noqa: BLE001 — collected
            traceback.print_exc()
            problems.append(f"{tag}: {type(e).__name__}: {e}")
        free_device(torch)
    refs.clear()
    free_device(torch)
    print(f"[19c] the refined policies and a padded mesh over "
          f"{MESH_DEVICE} and the host's CPU, every owner on the card")
    t19c = time.perf_counter()
    for key, part in (("a", lambda: refined_main_run(
            torch, cache, state3, f32_step, problems)),
                      ("b", lambda: padded_mix_run(torch, problems)),
                      ("c", lambda: bf16_mix_run(torch, problems))):
        t1 = time.perf_counter()
        try:
            out["refined"][key] = part()
            out["refined"][key]["phase_s"] = time.perf_counter() - t1
        except Exception as e:  # noqa: BLE001 — collected
            traceback.print_exc()
            problems.append(f"19c({key}): {type(e).__name__}: {e}")
        free_device(torch)
    out["refined"]["s"] = time.perf_counter() - t19c
    print(f"  [19c] {out['refined']['s']:.1f} s")
    out["s"] = time.perf_counter() - t0
    print("assembly_mesh " + json.dumps(out, default=str))
    print(f"  [19] {out['s']:.1f} s")
    for p in problems:
        print(f"  FAILED: {p}")
    require(not problems, f"phase 19: {len(problems)} check(s) failed")
    return out


# ---------------------------------------------------------------------------
# phase 16: LM serving (qwen3-0.6b at full width, every family on the card)
# ---------------------------------------------------------------------------
LM_TOL = 1e-4            # of the largest |logit|: f32 on the card against the
#                          CPU (16a), decode against forward (16b, 16c)
LM_BF16_TOL = 5e-2       # 16b: bf16 prefill logits against the f32 copy's
#                          (~6 bf16 ulps; 1.2-1.4e-2 on the CPU at 2-8
#                          layers of qwen3's width)
FAMILY_TOL = {"rwkv6-1.6b": 1e-3}  # 16c: f32 decode against forward where
#                          LM_TOL does not hold at the published depth: 24
#                          layers of f32 WKV state and per-head group norm
#                          (eps 6.4e-4) amplify rounding with depth; the
#                          family's 1-layer cut is held to LM_TOL too
BF16_FAMILY = "jamba-v0.1-52b"  # 16c: also run in bf16, its published dtype;
#                          no logit bound holds there (a top-2 router
#                          decision flips on one bf16 rounding and the
#                          token's error spreads through the recurrence),
#                          so it reports the error and the flipped routes
LM_SMOKE_BATCH, LM_SMOKE_PROMPT, LM_SMOKE_STEPS = 2, 12, 4  # 16a; the prompt
#                          is longer than mixtral-smoke's window of 8
QWEN = "qwen3-0.6b"
QWEN_BATCH, QWEN_PROMPT, QWEN_NEW = 8, 512, 64   # 16b: max_len 576
QWEN_CHECK_STEPS = 8     # 16b: f32 decode steps held to forward
PROFILE_STEPS = 4        # 16b: decode steps under torch.profiler
F32_WEIGHT_LIMIT = 60e9  # 16c: every family's f32 weights must fit in this
#                          many bytes of the card's 80 GB (jamba's 53 GB)
# 16c: each family at full width with its depth cut to these layers (the
# published depth where it is whole)
FAMILY_LAYERS = {"mixtral-8x22b": 1, "jamba-v0.1-52b": 8, "rwkv6-1.6b": 24,
                 "whisper-medium": 24, "paligemma-3b": 18}
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS = 2, 64, 4
# 16b: the decode step's device time by part (lower-case fragments of the
# kernels' names)
DECODE_PARTS = (("matmul", ("gemm", "gemv", "cutlass", "xmma", "sm90_",
                            "splitk")),
                ("softmax", ("softmax",)),
                ("reductions", ("reduce",)),
                ("copies and casts", ("copy", "memcpy", "memset")),
                ("indexing", ("index", "gather", "scatter", "embedding",
                              "arange", "where")),
                ("elementwise", ("elementwise", "vectorized", "unrolled")))


def tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_numel(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def kv_cache_bytes(cfg, batch: int, max_len: int) -> int:
    """Bytes of the attention layers' K and V caches (a ring buffer of the
    window where the arch has one)."""
    itemsize = {"float32": 4, "bfloat16": 2, "float16": 2}[cfg.dtype]
    klen = min(max_len, cfg.sliding_window or max_len)
    n_attn = cfg.attn_layers_per_period() * cfg.n_periods
    return n_attn * 2 * batch * klen * cfg.n_kv_heads * cfg.hd * itemsize


def decode_floor(cfg, batch: int, max_len: int, weight_bytes: int) -> dict:
    """A decode step's byte floor: every weight and the whole K/V cache
    read once (``attn_decode`` attends over every slot, masked), over the
    card's memory rate."""
    kv = kv_cache_bytes(cfg, batch, max_len)
    return {"weight_bytes": weight_bytes, "kv_bytes": kv,
            "bytes": weight_bytes + kv,
            "ms": 1e3 * (weight_bytes + kv) / HBM_BYTES_PER_S}


def family_config(arch: str, layers: int | None = None,
                  dtype: str = "float32"):
    """16c's config: the published widths with the depth cut to
    ``layers`` (default ``FAMILY_LAYERS``), in ``dtype``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import validate

    return validate(dataclasses.replace(
        get_config(arch), n_layers=layers or FAMILY_LAYERS[arch],
        dtype=dtype))


def lm_inputs(cfg, batch: int, length: int, seed: int = 0):
    """Seeded tokens (batch, length) and, for a stub frontend, its
    embeddings, as numpy (the JAX launcher's draws)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, length))
    frontend = None
    if cfg.frontend:
        frontend = (rng.standard_normal((batch, cfg.frontend_len,
                                         cfg.d_model)) * 0.02
                    ).astype(np.float32)
    return tokens, frontend


def greedy(torch, logits):
    """The engine's greedy pick: the first maximum, (B, 1) int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def on(torch, dev, tokens, frontend):
    return (torch.as_tensor(tokens, dtype=torch.int32, device=dev),
            None if frontend is None
            else torch.as_tensor(frontend, device=dev))


def n_prefix(cfg) -> int:
    return cfg.frontend_len if cfg.frontend == "vision_stub" else 0


def greedy_run(torch, cfg, params, prompts, frontend, n_new: int,
               dev) -> dict:
    """Prefill, then ``n_new - 1`` greedy decode steps (the engine's
    ``generate``, with every step's logits kept), timed: prefill seconds
    and decode ms a step, each ending in a synchronisation."""
    from repro_torch.models import lm

    max_len = prompts.shape[1] + n_new + n_prefix(cfg)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(cfg, params, prompts, max_len, frontend)
    toks = [greedy(torch, logits)]
    sync()
    t1 = time.perf_counter()
    all_logits = [logits]
    pos = prompts.shape[1] + n_prefix(cfg)
    for i in range(n_new - 1):
        logits, cache = lm.decode_step(cfg, params, cache, toks[-1], pos + i)
        toks.append(greedy(torch, logits))
        all_logits.append(logits)
    sync()
    t2 = time.perf_counter()
    return {"tokens": torch.cat(toks, dim=1), "logits": all_logits,
            "prefill_s": t1 - t0,
            "decode_ms": 1e3 * (t2 - t1) / max(n_new - 1, 1),
            "cache": cache}


def logit_err(torch, got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got, want = got.double(), want.double().to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def decode_vs_forward(torch, cfg, params, tokens, frontend, n_steps: int,
                      dev) -> dict:
    """Prefill the first ``len - n_steps`` tokens, then decode the rest
    (teacher-forced); each of the ``n_steps + 1`` logits against
    ``forward`` over the whole sequence at its position: the largest
    error over the largest |logit| there, and whether the greedy tokens
    agree."""
    from repro_torch.models import lm

    t, f = on(torch, dev, tokens, frontend)
    S = t.shape[1] - n_steps
    full = lm.forward(cfg, params, t, f)               # (B, len, V)
    logits, cache = lm.prefill(cfg, params, t[:, :S],
                               t.shape[1] + n_prefix(cfg), f)
    steps = [logits]
    for i in range(n_steps):
        logits, cache = lm.decode_step(cfg, params, cache, t[:, S + i:S + i + 1],
                                       S + n_prefix(cfg) + i)
        steps.append(logits)
    got = torch.stack(steps, dim=1)                     # (B, n+1, V)
    want = full[:, S - 1:]
    return {"err": logit_err(torch, got, want),
            "tokens_equal": bool(torch.equal(got.argmax(-1),
                                             want.argmax(-1))),
            "positions": int(got.shape[1]), "prefill_logits": steps[0]}


def smoke_arch_check(torch, arch: str, dev, ref_dev) -> dict:
    """16a for one arch: one set of float32 parameters (made on the CPU)
    through prefill and greedy decode steps on ``ref_dev`` and ``dev``;
    the largest logit error over the largest |logit| and whether every
    greedy token agrees."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import lm

    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    tokens, frontend = lm_inputs(cfg, LM_SMOKE_BATCH, LM_SMOKE_PROMPT)
    runs = []
    for d in (ref_dev, dev):
        p = tree_map(lambda x: x.to(d), params)
        runs.append(greedy_run(torch, cfg, p, *on(torch, d, tokens, frontend),
                               LM_SMOKE_STEPS + 1, d))
    ref, got = runs
    return {"err": max(logit_err(torch, a.cpu(), b.cpu())
                       for a, b in zip(got["logits"], ref["logits"])),
            "tokens_equal": bool(torch.equal(got["tokens"].cpu(),
                                             ref["tokens"].cpu()))}


def smoke_archs_phase(torch, dev, problems, ref_dev="cpu") -> dict:
    """16a: every registry SMOKE config on ``dev`` against ``ref_dev``."""
    from repro_torch.configs.registry import SMOKES

    out = {}
    for arch in SMOKES:
        r = smoke_arch_check(torch, arch, torch.device(dev),
                             torch.device(ref_dev))
        out[arch] = r
        print(f"  [16a] {arch:22s} prefill + {LM_SMOKE_STEPS} decode steps, "
              f"f32: logits {r['err']:.3e} of max|logit| (<= {LM_TOL:g}), "
              f"greedy tokens equal {r['tokens_equal']}")
        if not (r["err"] <= LM_TOL and r["tokens_equal"]):
            problems.append(f"16a {arch}: {r}")
    return out


def device_part(name: str, parts=DECODE_PARTS) -> str:
    """The part (of ``parts``: the first whose fragments the lower-case
    name holds) a device kernel belongs to."""
    name = name.lower()
    for part, keys in parts:
        if any(k in name for k in keys):
            return part
    return "other"


def profile_decode(torch, cfg, params, state, n_steps: int) -> dict:
    """``n_steps`` decode steps under ``torch.profiler`` (see
    :func:`profile_device`)."""
    from repro_torch.models import lm

    cache, last, pos = state
    at = {"cache": cache, "last": last, "i": 0}

    def step():
        logits, at["cache"] = lm.decode_step(cfg, params, at["cache"],
                                             at["last"], pos + at["i"])
        at["last"] = greedy(torch, logits)
        at["i"] += 1

    return profile_device(torch, step, n_steps, DECODE_PARTS)


def profile_device(torch, step, n_steps: int, parts, host=True) -> dict:
    """``n_steps`` calls of ``step`` under ``torch.profiler``: kernel
    launches and device busy ms a step, the device's idle share of the
    window (1 - the kernels' summed time over its wall), device ms a step
    by part (``parts``), and the five largest device operations.  Without
    ``host`` only the device is traced.  The device's activities are read
    from the raw trace: the profiler's own event tree (``key_averages``)
    takes over a minute to build for a window of ~10^5 launches."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}                      # name -> (device us, count)
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            us, count = kernels.get(evt.name(), (0.0, 0))
            kernels[evt.name()] = (us + evt.duration_ns() / 1e3, count + 1)
    by_part = {}
    for name, (us, _) in kernels.items():
        part = device_part(name, parts)
        by_part[part] = by_part.get(part, 0.0) + us / 1e3 / n_steps
    busy = sum(us for us, _ in kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    return {"launches_per_step": sum(c for _, c in kernels.values())
            / n_steps,
            "wall_ms_per_step": 1e3 * wall / n_steps,
            "busy_ms_per_step": 1e3 * busy / n_steps,
            "idle_share": 1 - busy / wall,
            "device_ms_per_step": by_part,
            "top5": [{"op": k[:120], "ms_per_step": us / 1e3 / n_steps,
                      "count_per_step": c / n_steps}
                     for k, (us, c) in top]}


def qwen_phase(torch, dev, problems) -> dict:
    """16b: qwen3-0.6b at full width and depth, bfloat16, on ``dev``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import generate

    cfg = get_config(QWEN)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen)
    n_params, w_bytes = tree_numel(params), tree_bytes(params)
    max_len = QWEN_PROMPT + QWEN_NEW
    floor = decode_floor(cfg, QWEN_BATCH, max_len, w_bytes)
    tokens, _ = lm_inputs(cfg, QWEN_BATCH, QWEN_PROMPT + QWEN_CHECK_STEPS)
    prompts, _ = on(torch, dev, tokens[:, :QWEN_PROMPT], None)
    print(f"  [16b] {QWEN}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {n_params:,} parameters "
          f"({w_bytes / 1e9:.4f} GB {cfg.dtype}; config total_params "
          f"{int(cfg.total_params()):,}); batch {QWEN_BATCH}, prompt "
          f"{QWEN_PROMPT}, {QWEN_NEW} new tokens (max_len {max_len})")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_tokens = generate(cfg, params, prompts, QWEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    runs = [greedy_run(torch, cfg, params, prompts, None, QWEN_NEW, dev)
            for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    a, b = runs
    same = (torch.equal(a["tokens"], b["tokens"])
            and all(torch.equal(x, y) for x, y in zip(a["logits"],
                                                      b["logits"])))
    gen_same = torch.equal(gen_tokens, a["tokens"])
    out = {"params": n_params, "weight_bytes": w_bytes,
           "floor": floor, "generate_s": gen_s,
           "generate_tok_per_s": QWEN_BATCH * QWEN_NEW / gen_s,
           "prefill_s": [r["prefill_s"] for r in runs],
           "decode_ms_per_step": [r["decode_ms"] for r in runs],
           "decode_tok_per_s": [1e3 * QWEN_BATCH / r["decode_ms"]
                                for r in runs],
           "peak_bytes": peak, "bitwise_repeat": same,
           "generate_equal": gen_same}
    print(f"  [16b] generate: {gen_s:.3f} s "
          f"({out['generate_tok_per_s']:.1f} tok/s end to end); prefill "
          f"{out['prefill_s'][0]:.4f} / {out['prefill_s'][1]:.4f} s; decode "
          f"{out['decode_ms_per_step'][0]:.3f} / "
          f"{out['decode_ms_per_step'][1]:.3f} ms a step "
          f"({out['decode_tok_per_s'][0]:.1f} tok/s) against a byte floor "
          f"of {floor['ms']:.4f} ms ({floor['weight_bytes'] / 1e9:.4f} GB "
          f"weights + {floor['kv_bytes'] / 1e9:.4f} GB K/V); "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB")
    print(f"  [16b] two runs bitwise (tokens and all {QWEN_NEW} logits): "
          f"{same}; generate's tokens equal theirs: {gen_same}")
    if not (same and gen_same):
        problems.append("16b: the bf16 runs are not deterministic or "
                        "generate differs from the stepped run")
    bf16_prefill = b["logits"][0]
    del runs, a, b
    free_device(torch)
    # the decode step under the profiler, from a fresh prefill
    logits, cache = lm.prefill(cfg, params, prompts, max_len)
    state = (cache, greedy(torch, logits), QWEN_PROMPT)
    prof = profile_decode(torch, cfg, params, state, PROFILE_STEPS)
    out["profile"] = prof
    print(f"  [16b] profile of {PROFILE_STEPS} decode steps: "
          f"{prof['launches_per_step']:.0f} kernel launches a step, device "
          f"busy {prof['busy_ms_per_step']:.3f} ms of "
          f"{prof['wall_ms_per_step']:.3f} ms a step, idle share "
          f"{prof['idle_share']:.1%}")
    for part, ms in sorted(prof["device_ms_per_step"].items(),
                           key=lambda kv: -kv[1]):
        print(f"    {part:20s} {ms:.4f} ms a step")
    for t in prof["top5"]:
        print(f"    {t['count_per_step']:6.1f} x {t['op'][:72]:72s} "
              f"{t['ms_per_step']:.4f} ms a step")
    del state, cache, logits
    free_device(torch)
    # a float32 copy of the same weights: decode against forward
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda x: x.float(), params)
    del params
    dvf = decode_vs_forward(torch, cfg32, params32, tokens, None,
                            QWEN_CHECK_STEPS, dev)
    out["bf16_vs_f32_prefill"] = logit_err(torch, bf16_prefill,
                                           dvf.pop("prefill_logits"))
    out["f32_decode_vs_forward"] = dvf
    print(f"  [16b] f32 copy: prefill + {QWEN_CHECK_STEPS} decode steps "
          f"against forward: {dvf['err']:.3e} of max|logit| (<= {LM_TOL:g}), "
          f"greedy tokens equal {dvf['tokens_equal']}; bf16 prefill logits "
          f"against the f32 copy's {out['bf16_vs_f32_prefill']:.3e} "
          f"(<= {LM_BF16_TOL:g})")
    if not (dvf["err"] <= LM_TOL and dvf["tokens_equal"]):
        problems.append(f"16b: f32 decode against forward {dvf}")
    if not out["bf16_vs_f32_prefill"] <= LM_BF16_TOL:
        problems.append(f"16b: bf16 prefill against f32 "
                        f"{out['bf16_vs_f32_prefill']:.3e}")
    return out


@contextlib.contextmanager
def router_record(torch, calls: list):
    """Record each MoE routing's routes (the sorted top-k expert ids of
    every token) while the LM stack runs: the whole sublayer's and the
    split one's (``moe_route`` in both modules)."""
    from repro_torch.models import layers
    from repro_torch.models import tensor_parallel as tp

    real = layers.moe_route

    def spy(router, x, top_k):
        combine, idx = real(router, x, top_k)
        calls.append(idx.detach().sort(dim=-1).values)
        return combine, idx

    layers.moe_route = tp.moe_route = spy
    try:
        yield calls
    finally:
        layers.moe_route = tp.moe_route = real


def routing_flips(calls: list, n_moe: int, S: int, n_steps: int) -> dict:
    """Tokens whose route differs between ``forward`` (the first
    ``n_moe`` records) and the prefill of ``S`` tokens plus ``n_steps``
    decode steps that follow it, over every MoE layer."""
    fwd, pre = calls[:n_moe], calls[n_moe:2 * n_moe]
    flips = routed = 0
    for li in range(n_moe):
        flips += int((fwd[li][:, :S] != pre[li]).any(-1).sum())
        for i in range(n_steps):
            dec = calls[(2 + i) * n_moe + li]
            flips += int((fwd[li][:, S + i] != dec[:, 0]).any(-1).sum())
        routed += fwd[li].shape[0] * (S + n_steps)
    return {"flips": flips, "routed": routed}


def family_check(torch, cfg, dev, count_routes: bool = False) -> dict:
    """16c for one config: decode against forward on ``dev``; with
    ``count_routes``, the MoE routes that differ between the two."""
    from repro_torch.models import lm

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens, frontend = lm_inputs(cfg, FAMILY_BATCH,
                                 FAMILY_PROMPT + FAMILY_STEPS)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls = []
    with (router_record(torch, calls) if count_routes
          else contextlib.nullcontext()):
        r = decode_vs_forward(torch, cfg, params, tokens, frontend,
                              FAMILY_STEPS, dev)
    r["finite"] = bool(torch.isfinite(r.pop("prefill_logits")).all())
    if count_routes:
        n_moe = sum(s.moe for s in cfg.period()) * cfg.n_periods
        r.update(routing_flips(calls, n_moe, FAMILY_PROMPT, FAMILY_STEPS))
    r.update(layers=cfg.n_layers, encoder_layers=cfg.encoder_layers,
             dtype=cfg.dtype, weight_bytes=tree_bytes(params),
             seconds=time.perf_counter() - t0)
    return r


def families_phase(torch, dev, problems) -> dict:
    """16c: the other families at full width in f32, each depth cut
    listed; a family with a looser bound also at one layer; jamba also in
    bf16 (reported)."""
    from repro_torch.configs.registry import get_config

    def report(arch, tag, r, tol):
        full = get_config(arch)
        cut = ("whole" if r["layers"] == full.n_layers
               else f"depth cut {full.n_layers} -> {r['layers']} layers")
        enc = f" + {r['encoder_layers']} encoder" if r["encoder_layers"] \
            else ""
        bound = (f"<= {tol:g}" if tol is not None else "not held")
        routes = (f", routes differing {r['flips']} of {r['routed']}"
                  if "flips" in r else "")
        print(f"  [16c] {tag:22s} {r['layers']}{enc} layers ({cut}), "
              f"{r['dtype']}, {r['weight_bytes'] / 1e9:.2f} GB: prefill "
              f"{FAMILY_PROMPT} + {FAMILY_STEPS} decode steps against "
              f"forward {r['err']:.3e} of max|logit| ({bound}), greedy "
              f"tokens equal {r['tokens_equal']}{routes}, "
              f"{r['seconds']:.1f} s")
        if tol is not None and not (r["err"] <= tol and r["tokens_equal"]):
            problems.append(f"16c {tag}: {r}")
        if not r["finite"]:
            problems.append(f"16c {tag}: non-finite logits")

    out = {}
    for arch in FAMILY_LAYERS:
        cfg = family_config(arch)
        require(4 * cfg.total_params() <= F32_WEIGHT_LIMIT,
                f"16c: {arch}'s f32 weights do not fit")
        runs = [(arch, cfg, FAMILY_TOL.get(arch, LM_TOL))]
        if arch in FAMILY_TOL:
            runs.append((f"{arch} (1 layer)", family_config(arch, layers=1),
                         LM_TOL))
        if arch == BF16_FAMILY:
            runs.append((f"{arch} (bf16)",
                         family_config(arch, dtype="bfloat16"), None))
        for tag, c, tol in runs:
            r = family_check(torch, c, dev, count_routes=c.n_experts > 0)
            out[tag] = dict(r, tol=tol)
            free_device(torch)
            report(arch, tag, r, tol)
    return out


def lm_phase(torch, dev) -> dict:
    """Phase 16 (see the module docstring).  Its checks are collected and
    fail the run after its parts have printed."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[16] LM serving: every SMOKE arch against the CPU, {QWEN} at "
          f"full width, the families at full width; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}")
    problems = []
    out = {"archs": smoke_archs_phase(torch, dev, problems)}
    free_device(torch)
    out["qwen3"] = qwen_phase(torch, dev, problems)
    free_device(torch)
    out["families"] = families_phase(torch, dev, problems)
    out["seconds"] = time.perf_counter() - t0
    print(f"  [16] {out['seconds']:.1f} s")
    for p in problems:
        print(f"  FAILED: {p}")
    require(not problems, f"phase 16: {len(problems)} check(s) failed")
    return out


# ---------------------------------------------------------------------------
# phase 17: LM training (every arch on the card against the CPU, qwen3-0.6b
# at full width, remat, kill and resume through the launcher)
# ---------------------------------------------------------------------------
TRAIN_SMOKE_SEQ, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_STEPS = 32, 4, 2  # 17a
TRAIN_REL = 1e-5         # 17a: loss and grad_norm, the card against the CPU
TRAIN_REL_INT8 = 1e-4    # 17a: grad_norm with int8 compression: where a
#                          value sits at a .5 tie on one device, its int8
#                          step rounds the other way on the other, moving
#                          the dequantised gradient by one scale
#                          (1.34e-5 seen on rwkv6-smoke)
TRAIN_NOISE = 1e-3       # 17a: sqrt(v_hat) below this share of its leaf's
#                          largest marks a gradient as rounding noise
TRAIN_TIGHT = 1e-2       # 17a: x lr, the parameters whose gradient stayed
#                          above noise (no compression); every other one
#                          within 2 lr a step (AdamW's first update is about
#                          sign(g); a noise gradient may take either sign)
TRAIN_SEQ = 4096         # 17b: the train_4k shape's length (configs/shapes.py)
TRAIN_BATCH, TRAIN_ACCUM = 8, 2   # 17b: global batch cut from train_4k's 256;
#                          microbatch 4
TRAIN_TIMED = 1          # 17b: timed steps after one warm step, all on
#                          batch_at(seed 0, step 0): tests/test_training.py's
#                          fixed batch, whose loss must fall over them (cut
#                          from 2; the second run's step is timed too)
TRAIN_REPEAT = 1         # 17b: the second run's steps (cut from 4: a step
#                          of all 28 layers took 21-27 s on the card)
TRAIN_LAYERS = 8         # 17b: qwen3-0.6b's depth cut 28 -> 8 to keep the
#                          script inside its time (a step of all 28 took
#                          21-27 s, host-bound)
TRAIN_MEM_GB = (43.0, 52.0)  # 17b: predicted max_memory_allocated (PERF.md)
BF16_DENSE_FLOPS = 989e12    # H100 SXM dense bf16 peak (NVIDIA data sheet,
#                              at 700 W)
# 17c: (arch, layers, seq_len, batch) — full width, depth cut
REMAT_RUNS = (("qwen3-0.6b", 2, 4096, 4), ("rwkv6-1.6b", 2, 768, 2))
#                          rwkv6's 2048 cut to 768: three 256-step time
#                          chunks still (its time loop runs eagerly)
RESUME_LAYERS = 2            # 17d: qwen3-0.6b's depth cut 28 -> 2 (28 layers
#                          wrote 6 GB a checkpoint, 118-142 s of phase; 8
#                          layers 2.8 GB, 92-105 s)
RESUME_ARGS = ["--arch", QWEN, "--layers", str(RESUME_LAYERS), "--seq-len",
               "512", "--batch", "8"]   # 17d
RESUME_STEPS, RESUME_KILL = 2, 1   # 17d: run to step 2; killed after 1
# 17b: a microbatch's device time by part (lower-case fragments of the
# kernels' names; the first part that matches takes the kernel)
TRAIN_PARTS = (("f32 products", ("sgemm", "f32f32", "sss")),
               ("bf16 products", ("bf16", "gemm", "nvjet", "xmma",
                                  "cutlass", "gemv")),
               ("softmax", ("softmax",)),
               ("reductions", ("reduce",)),
               ("copies and casts", ("copy", "memcpy", "memset", "cat")),
               ("indexing", ("index", "gather", "scatter", "embedding",
                             "where")),
               ("elementwise", ("elementwise", "vectorized", "unrolled")))


def train_flops(n_params: int, tokens: int) -> float:
    """A step's model FLOPs, 6 N tokens (forward 2 N, backward 4 N; the
    remat's recompute and the attention products not counted)."""
    return 6.0 * n_params * tokens


def analytical_step_flops(cfg, batch: int, shape: str = "train_4k") -> dict:
    """``launch/analysis.py``'s FLOPs of a step at ``shape``, scaled
    linearly from the shape's global batch to ``batch`` (every term counts
    tokens, and a row's attention spans the shape's whole sequence, so the
    scale is exact): ``total`` (the implementation: the full masked S x S
    attention, remat's recompute), ``ideal`` (the causal half) and
    ``model_flops_6nd`` (6 N_active tokens)."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.analysis import analytical_flops

    rep = analytical_flops(cfg, shape)
    k = batch / SHAPES[shape].global_batch
    return {"total": rep.total * k, "ideal": rep.ideal * k,
            "model_flops_6nd": rep.model_flops_6nd * k}


def train_static_bytes(n_params: int, param_bytes: int, accum: int) -> int:
    """The state a step holds besides its activations: the parameters,
    their gradients (the microbatch's, in the parameters' dtype), the f32
    accumulator when ``accum > 1``, and AdamW's two f32 moments."""
    return n_params * (2 * param_bytes + (4 if accum > 1 else 0) + 8)


def logits_bytes(cfg, micro_batch: int, seq_len: int) -> dict:
    """The loss's logits for one microbatch: in the model dtype and as
    the f32 upcast ``logsumexp`` reads (and its backward makes again)."""
    n = micro_batch * seq_len * cfg.vocab_size
    return {"model_dtype": 2 * n if cfg.dtype == "bfloat16" else 4 * n,
            "f32": 4 * n}


def params_problems(got, want, want_v, lr: float, k: int, above: list,
                    tight: bool) -> list:
    """AdamW's rule for two runs of ``k`` steps: every parameter within
    2 lr k; with ``tight``, those whose gradient stayed above noise at
    every step (``above``, updated here from ``want_v``) within
    ``TRAIN_TIGHT`` lr.  Returns the leaves that break it."""
    import numpy as np

    out = []
    bc2 = 1 - 0.95 ** k
    for i, (g, w, v) in enumerate(zip(got, want, want_v)):
        g = g.detach().cpu().double().numpy()
        w = w.detach().cpu().double().numpy()
        d = np.abs(g - w)
        sv = np.sqrt(v.detach().cpu().double().numpy() / bc2)
        a = sv >= TRAIN_NOISE * sv.max()
        above[i] = a if above[i] is None else above[i] & a
        if d.max() > 2 * lr * k + 1e-7:
            out.append(f"leaf {i}: {d.max():.3e} > 2 lr k")
        elif tight and above[i].any() and d[above[i]].max() > TRAIN_TIGHT * lr:
            out.append(f"leaf {i}: {d[above[i]].max():.3e} above noise")
    return out


def smoke_train_check(torch, arch: str, dev, ref_dev, compress: bool) -> dict:
    """17a for one arch: one set of float32 parameters (made on the CPU)
    through ``TRAIN_SMOKE_STEPS`` steps of ``make_train_step(accum=2)``
    on ``ref_dev`` and ``dev``; the largest relative loss and grad_norm
    differences and the parameters' problems under AdamW's rule."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.grad_compress import init_error
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import TrainState, make_train_step
    from repro_torch.training.tree import leaves, tree_map as tmap

    cfg = get_smoke_config(arch)
    opt = AdamW()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    state0 = TrainState(params, opt.init(params),
                        init_error(params) if compress else None)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SMOKE_SEQ,
                      global_batch=TRAIN_SMOKE_BATCH,
                      frontend_len=cfg.frontend_len if cfg.frontend else 0,
                      d_model=cfg.d_model)
    step = make_train_step(cfg, opt, compress=compress, accum=2)
    runs = []
    for d in (ref_dev, dev):
        st, out = tmap(lambda t: t.to(d), state0), []
        for k in range(TRAIN_SMOKE_STEPS):
            st, m = step(st, batch_at(dcfg, k, device=d))
            out.append((float(m["loss"]), float(m["grad_norm"]), st))
        runs.append(out)
    ref, got = runs
    problems, above = [], [None] * len(leaves(params))
    for k, ((l0, g0, s0), (l1, g1, s1)) in enumerate(zip(ref, got), 1):
        problems += params_problems(leaves(s1.params), leaves(s0.params),
                                    leaves(s0.opt.v), opt.lr, k, above,
                                    tight=not compress)
    return {"loss_rel": max(abs(a[0] - b[0]) / abs(b[0])
                            for a, b in zip(got, ref)),
            "gnorm_rel": max(abs(a[1] - b[1]) / abs(b[1])
                             for a, b in zip(got, ref)),
            "param_problems": problems}


def smoke_train_phase(torch, dev, problems, ref_dev="cpu") -> dict:
    """17a: every registry SMOKE config's train step on ``dev`` against
    ``ref_dev``, with compression off and on."""
    from repro_torch.configs.registry import SMOKES

    out = {}
    for arch in SMOKES:
        for compress in (False, True):
            r = smoke_train_check(torch, arch, torch.device(dev),
                                  torch.device(ref_dev), compress)
            tag = f"{arch}{' +int8' if compress else ''}"
            out[tag] = r
            gbound = TRAIN_REL_INT8 if compress else TRAIN_REL
            print(f"  [17a] {tag:28s} {TRAIN_SMOKE_STEPS} steps, accum 2, "
                  f"f32: loss {r['loss_rel']:.2e} (<= {TRAIN_REL:g}), "
                  f"grad_norm {r['gnorm_rel']:.2e} (<= {gbound:g}), "
                  f"parameters by AdamW's rule: "
                  f"{r['param_problems'] or 'ok'}")
            if not (r["loss_rel"] <= TRAIN_REL and r["gnorm_rel"] <= gbound
                    and not r["param_problems"]):
                problems.append(f"17a {tag}: {r}")
    return out


def same_leaves(torch, a, b) -> bool:
    """Whether two lists of tensors are equal bit for bit."""
    return all(same_bits(torch, x, y) for x, y in zip(a, b))


def train_run(torch, step, state, batches) -> tuple:
    """The steps on ``batches`` (each ending in a synchronisation):
    ``(state, [(loss, grad_norm) tensors], [seconds])``."""
    metrics, secs = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append((m["loss"], m["grad_norm"]))
    return state, metrics, secs


def microbatch_parts(torch, cfg, opt, state, batch) -> dict:
    """17b's profile: one microbatch's loss and gradients under
    ``torch.profiler`` (the device traced alone); the loss head (logits,
    ``logsumexp``, the gold rows) forward and backward alone and the
    AdamW update alone, each by CUDA events."""
    from repro_torch.models import lm
    from repro_torch.training.tree import leaves, tree_map as tmap, unflatten

    def microbatch():
        req = [p.detach().requires_grad_() for p in leaves(state.params)]
        loss = lm.loss_fn(cfg, unflatten(state.params, req), batch["tokens"],
                          batch["labels"])
        torch.autograd.grad(loss, req, materialize_grads=True)

    t0 = time.perf_counter()
    prof = profile_device(torch, microbatch, 1, TRAIN_PARTS, host=False)
    prof["trace_and_sort_s"] = time.perf_counter() - t0
    with torch.no_grad():
        x = lm.hidden_states(cfg, state.params, batch["tokens"])

    def head():
        heads = {k: state.params[k].detach().requires_grad_()
                 for k in ("embed", "lm_head") if k in state.params}
        xr = x.detach().requires_grad_()
        loss = lm.head_loss(cfg, dict(state.params, **heads), xr,
                            batch["labels"])
        torch.autograd.grad(loss, [xr, *heads.values()])

    # the update's cost does not depend on the gradients' values
    grads = tmap(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), state.params)
    prof["head_ms"] = time_ms(torch, head, n=2, warmup=1)
    prof["adamw_ms"] = time_ms(
        torch, lambda: opt.update(grads, state.opt, state.params), n=3,
        warmup=1)
    return prof


def full_train_phase(torch, dev, problems) -> dict:
    """17b: qwen3-0.6b at full width, its depth cut to
    :data:`TRAIN_LAYERS`, bfloat16, on ``dev``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import validate
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import init_state, make_train_step
    from repro_torch.training.tree import leaves

    cfg = validate(dataclasses.replace(get_config(QWEN),
                                       n_layers=TRAIN_LAYERS))
    opt = AdamW()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    batch = batch_at(dcfg, 0, device=dev)
    state0 = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))
    n = tree_numel(state0.params)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    static = train_static_bytes(n, 2, TRAIN_ACCUM)
    logit = logits_bytes(cfg, TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ)
    print(f"  [17b] {QWEN}: {cfg.n_layers} layers (depth cut from "
          f"{get_config(QWEN).n_layers}), d_model {cfg.d_model}, "
          f"{n:,} parameters ({cfg.dtype}); seq_len {TRAIN_SEQ} (train_4k), "
          f"global batch {TRAIN_BATCH} (cut from train_4k's 256), accum "
          f"{TRAIN_ACCUM} (microbatch {TRAIN_BATCH // TRAIN_ACCUM}); "
          f"AdamW() defaults; state besides activations "
          f"{static / 1e9:.2f} GB, a microbatch's logits "
          f"{logit['model_dtype'] / 1e9:.2f} GB ({logit['f32'] / 1e9:.2f} GB "
          f"as f32)")
    step = make_train_step(cfg, opt, accum=TRAIN_ACCUM)
    torch.cuda.reset_peak_memory_stats()
    st, m1, s1 = train_run(torch, step, state0, [batch] * TRAIN_REPEAT)
    p1 = leaves(st.params)           # after the steps the second run takes
    st, more, later = train_run(torch, step, st,
                                [batch] * (1 + TRAIN_TIMED - TRAIN_REPEAT))
    m1, s1 = m1 + more, s1 + later
    st2, m2, s2 = train_run(torch, step, state0, [batch] * TRAIN_REPEAT)
    peak = torch.cuda.max_memory_allocated()
    same = (same_leaves(torch, p1, leaves(st2.params))
            and all(same_bits(torch, a[0], b[0]) and same_bits(
                torch, a[1], b[1]) for a, b in zip(m1, m2)))
    del st2, p1
    losses = [float(m[0]) for m in m1]
    gnorms = [float(m[1]) for m in m1]
    finite = all(map(math.isfinite, losses + gnorms))
    timed = s1[1:] + s2      # the second run's steps are warm too
    s_step = sum(timed) / len(timed)
    out = {"params": n, "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
           "accum": TRAIN_ACCUM, "losses": losses, "grad_norms": gnorms,
           "step_s": timed, "warm_step_s": [s1[0], s2[0]],
           "s_per_step": s_step, "tokens_per_s": tokens / s_step,
           "flops_per_step": train_flops(n, tokens),
           "model_flops_share": train_flops(n, tokens) / s_step
           / BF16_DENSE_FLOPS,
           "peak_bytes": peak, "bitwise_repeat": same,
           "repeat_steps": TRAIN_REPEAT}
    ana = analytical_step_flops(cfg, TRAIN_BATCH)
    out["analytical"] = dict(ana, **{
        f"{k}_share": ana[k] / s_step / BF16_DENSE_FLOPS
        for k in ("total", "ideal")})
    free_device(torch)
    print(f"  [17b] {1 + TRAIN_TIMED} steps on batch 0: losses "
          f"{[f'{x:.4f}' for x in losses]}, grad_norms "
          f"{[f'{x:.3f}' for x in gnorms]}; warm step {s1[0]:.3f} s; "
          f"timed steps {[f'{x:.3f}' for x in timed]} s: "
          f"{s_step:.3f} s a step, {out['tokens_per_s']:.0f} tokens/s, "
          f"6 N tokens = {out['flops_per_step'] / 1e12:.1f} TFLOP a step, "
          f"{out['model_flops_share']:.2%} of the dense bf16 peak "
          f"({BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s, H100 SXM data sheet)")
    print(f"  [17b] launch/analysis.py at train_4k scaled linearly from its "
          f"global batch 256 to {TRAIN_BATCH}: total "
          f"{ana['total'] / 1e12:.1f} TFLOP a step "
          f"({out['analytical']['total_share']:.2%} of the peak), ideal "
          f"{ana['ideal'] / 1e12:.1f} "
          f"({out['analytical']['ideal_share']:.2%}), its 6 N_active tokens "
          f"{ana['model_flops_6nd'] / 1e12:.1f}")
    print(f"  [17b] max_memory_allocated {peak / 1e9:.2f} GB (predicted "
          f"{TRAIN_MEM_GB[0]:g}-{TRAIN_MEM_GB[1]:g}); a second run of the "
          f"first {TRAIN_REPEAT} step(s) bitwise the first run's (every "
          f"loss, grad_norm and parameter leaf): {same}")
    if not (same and finite):
        problems.append(f"17b: bitwise {same}, finite {finite}")
    # an update on the same batch lowers its loss
    if not losses[-1] < losses[0]:
        problems.append(f"17b: the loss did not fall on a fixed batch "
                        f"{losses}")
    half = {k: v[:TRAIN_BATCH // TRAIN_ACCUM] for k, v in batch.items()}
    prof = microbatch_parts(torch, cfg, opt, st, half)
    out["profile"] = prof
    del st
    free_device(torch)
    print(f"  [17b] profile of one microbatch (loss and gradients, "
          f"{TRAIN_BATCH // TRAIN_ACCUM} x {TRAIN_SEQ}): "
          f"{prof['launches_per_step']:.0f} kernel launches, device busy "
          f"{prof['busy_ms_per_step']:.1f} ms of {prof['wall_ms_per_step']:.1f}"
          f" ms, idle share {prof['idle_share']:.1%} (traced and sorted in "
          f"{prof['trace_and_sort_s']:.1f} s); the loss head alone "
          f"{prof['head_ms']:.1f} ms, the AdamW update {prof['adamw_ms']:.1f}"
          f" ms")
    for part, ms in sorted(prof["device_ms_per_step"].items(),
                           key=lambda kv: -kv[1]):
        print(f"    {part:20s} {ms:.1f} ms")
    for t in prof["top5"]:
        print(f"    {t['count_per_step']:8.0f} x {t['op'][:72]:72s} "
              f"{t['ms_per_step']:.1f} ms")
    # one compressed step: finite, error buffers filled
    cstate = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0),
                        compress=True)
    del state0
    free_device(torch)
    cstate, m = make_train_step(cfg, opt, compress=True,
                                accum=TRAIN_ACCUM)(cstate, batch)
    err_max = max(float(e.abs().max()) for e in leaves(cstate.err))
    out["compressed"] = {"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "err_max": err_max}
    print(f"  [17b] one int8-compressed step: loss {float(m['loss']):.4f}, "
          f"grad_norm {float(m['grad_norm']):.3f}, largest |error| "
          f"{err_max:.3e}")
    if not (math.isfinite(float(m["loss"])) and err_max > 0):
        problems.append(f"17b: compressed step {out['compressed']}")
    return out


@contextlib.contextmanager
def saving_everything():
    """Remat off: the LM stack's and the time scans' checkpoints call
    their function directly, so autograd saves every activation (17c's
    reference run)."""
    from repro_torch.models import lm, scan_utils

    def direct(fn, *args, use_reentrant, preserve_rng_state, **kw):
        return fn(*args, **kw)

    real = lm.checkpoint, scan_utils.checkpoint
    lm.checkpoint = scan_utils.checkpoint = direct
    try:
        yield
    finally:
        lm.checkpoint, scan_utils.checkpoint = real


def remat_check(torch, dev, arch: str, layers: int, seq_len: int,
                batch: int) -> dict:
    """17c for one cut: one batch's loss and gradients with remat and
    without, bitwise, and ``max_memory_allocated`` of each."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import validate
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.tree import leaves, unflatten

    cfg = validate(dataclasses.replace(get_config(arch), n_layers=layers))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    b = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                            global_batch=batch), 0, device=dev)
    runs = {}
    for remat in (True, False):
        free_device(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        req = [p.detach().requires_grad_() for p in leaves(params)]
        with contextlib.nullcontext() if remat else saving_everything():
            loss = lm.loss_fn(cfg, unflatten(params, req), b["tokens"],
                              b["labels"])
            grads = torch.autograd.grad(loss, req, materialize_grads=True)
        torch.cuda.synchronize()
        runs[remat] = (loss.detach(), grads,
                       torch.cuda.max_memory_allocated() - base)
        del loss, req
    (l1, g1, m1), (l0, g0, m0) = runs[True], runs[False]
    return {"arch": arch, "layers": layers, "seq_len": seq_len,
            "batch": batch, "dtype": cfg.dtype,
            "bitwise": same_bits(torch, l1, l0) and same_leaves(torch, g1, g0),
            "peak_remat_bytes": m1, "peak_saved_bytes": m0}


def remat_phase(torch, dev, problems) -> list:
    """17c: remat on the card, each cut listed."""
    out = []
    for run in REMAT_RUNS:
        r = remat_check(torch, dev, *run)
        out.append(r)
        free_device(torch)
        print(f"  [17c] {r['arch']} at full width, depth cut to "
              f"{r['layers']} layers, seq_len {r['seq_len']}, batch "
              f"{r['batch']}, {r['dtype']}: gradients with remat bitwise "
              f"those without {r['bitwise']}; max_memory_allocated above "
              f"the parameters {r['peak_remat_bytes'] / 1e9:.2f} GB with "
              f"remat, {r['peak_saved_bytes'] / 1e9:.2f} GB without")
        if not r["bitwise"]:
            problems.append(f"17c {r['arch']}: remat changes the gradients")
    return out


def train_main(args: list) -> tuple:
    """The training launcher's ``main`` (what its command line runs) in
    this process, on ``args``: ``(returncode, its lines, the error)``, as
    :func:`finish` gives a process's."""
    from repro_torch.launch import train

    lines = []
    try:
        train.main(args, log=lines.append)
    except Exception as e:  # noqa: BLE001 — reported as the run's failure
        return 1, "\n".join(lines), f"{type(e).__name__}: {e}"
    return 0, "\n".join(lines), ""


def same_checkpoint(a, b) -> bool:
    """Whether two checkpoint directories hold the same arrays, byte for
    byte (bfloat16 words included)."""
    import numpy as np

    with np.load(Path(a) / "shard-0.npz") as za, \
            np.load(Path(b) / "shard-0.npz") as zb:
        return za.files == zb.files and all(
            za[k].dtype == zb[k].dtype and np.array_equal(
                za[k].reshape(-1).view(np.uint8),
                zb[k].reshape(-1).view(np.uint8))
            for k in za.files)


def train_resume_phase(torch, dev, problems) -> dict:
    """17d: a checkpoint of qwen3-0.6b's full-width state (its depth cut
    to :data:`RESUME_LAYERS`) written and restored in process (bytes,
    seconds, bitwise), then the launcher's ``main`` at the same cut
    stopped after step 1 and resumed against an uninterrupted run, in
    this process."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import validate
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import init_state
    from repro_torch.training.tree import leaves

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        print(f"  [17d] {shutil.disk_usage(tmp).free / 1e9:.0f} GB free "
              f"under {tmp}")
        cfg = validate(dataclasses.replace(get_config(QWEN),
                                           n_layers=RESUME_LAYERS))
        state = init_state(cfg, AdamW(),
                           torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt_lib.save(os.path.join(tmp, "inproc"), 1, state)
        t1 = time.perf_counter()
        back, _ = ckpt_lib.restore(os.path.join(tmp, "inproc"), state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out["checkpoint"] = {
            "bytes": dir_bytes(path), "write_s": t1 - t0, "restore_s": t2 - t1,
            "bitwise": same_leaves(torch, leaves(state), leaves(back))}
        del state, back
        free_device(torch)
        shutil.rmtree(path)
        c = out["checkpoint"]
        print(f"  [17d] {QWEN} state, {RESUME_LAYERS} layers (bf16 "
              f"parameters, f32 moments): "
              f"{c['bytes'] / 1e9:.3f} GB written in {c['write_s']:.2f} s, "
              f"restored in {c['restore_s']:.2f} s, bitwise {c['bitwise']}")
        if not c["bitwise"]:
            problems.append("17d: the restored state differs")
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        # in this process, one after the other; B2 resumes B1's checkpoint
        runs = {}
        for tag, ckpt, steps, every in (
                ("A", a, RESUME_STEPS, RESUME_STEPS),
                ("B1", b, RESUME_KILL, RESUME_KILL),
                ("B2", b, RESUME_STEPS, RESUME_KILL)):
            runs[tag] = train_main([*RESUME_ARGS, "--ckpt", ckpt, "--steps",
                                    str(steps), "--ckpt-every", str(every)])
            free_device(torch)
        for tag, (rc, stdout, stderr) in runs.items():
            print(f"  [17d] launcher {tag}: rc {rc}; "
                  + " | ".join(stdout.strip().splitlines()))
            if rc != 0:
                problems.append(f"17d {tag}: rc {rc}: {stderr[-2000:]}")
        resumed = (f"resumed from step {RESUME_KILL}"
                   in runs["B2"][1].splitlines())
        last = f"step-{RESUME_STEPS}"
        try:
            equal = same_checkpoint(os.path.join(a, last),
                                    os.path.join(b, last))
        except OSError as e:
            equal = False
            problems.append(f"17d: no {last} checkpoint ({e})")
        out["launcher"] = {"resumed": resumed, "last_equal": equal}
        print(f"  [17d] B resumed from step {RESUME_KILL}: {resumed}; A's "
              f"and B's {last} checkpoints bitwise equal: {equal}")
        if not (resumed and equal):
            problems.append(f"17d: {out['launcher']}")
    return out


def train_phase(torch, dev) -> dict:
    """Phase 17 (see the module docstring).  Its checks are collected and
    fail the run after its parts have printed."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[17] LM training: every SMOKE arch's train step against the "
          f"CPU, {QWEN} at full width, remat, kill and resume; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}")
    print(f"  [17] memory_allocated at the start "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    problems = []
    out = {"part_s": {}}
    for key, part in (("archs", smoke_train_phase),
                      ("qwen3", full_train_phase),
                      ("remat", remat_phase), ("resume", train_resume_phase)):
        t1 = time.perf_counter()
        out[key] = part(torch, dev, problems)
        free_device(torch)
        out["part_s"][key] = time.perf_counter() - t1
        print(f"  [17] {key}: {out['part_s'][key]:.1f} s")
    out["seconds"] = time.perf_counter() - t0
    print(f"  [17] {out['seconds']:.1f} s")
    for p in problems:
        print(f"  FAILED: {p}")
    require(not problems, f"phase 17: {len(problems)} check(s) failed")
    return out


# ---------------------------------------------------------------------------
# phase 18: the LM side over a device mesh (every position on the card)
# ---------------------------------------------------------------------------
MESH_SHAPE = (2, 4)          # 18a, 18b, 18d: (data, model)
PIPE_MESH = (2, 2, 2)        # 18c: (pod, data, model)
MESH_QWEN_BYTES = 188_022_784  # 18a: qwen3-0.6b's parameter bytes at one
#                          (2, 4) position (JAX's shard_shape of its
#                          param_shardings; tests/test_torch_lm_sharding.py)
MESH_LAYERS = 4              # 18b, 18c: qwen3-0.6b's depth cut 28 -> 4
MESH_SEQ, MESH_BATCH = 1024, 8   # 18b, 18c
MESH_STEPS = 2               # 18b: steps from one state
PIPE_MICRO = 4               # 18c: microbatches (a slice is 1 row)
PIPE_TOL = 1e-2              # 18c: bf16 pipelined against the full batch's
#                          hidden_states, of its largest |value| (the
#                          microbatch products round differently)
KV_FINE, KV_ALPHA = 8, 4     # 18d: KVRepartitionPlan.build(8, 8, 4)
KV_DECODE = 8                # 18d: greedy decode steps from each cache
MESH_RESUME_ARGS = ["--arch", QWEN, "--smoke", "--batch", "8"]  # 18b
MESH_WHOLE_GATHER = 343_474_176  # 18b: the bytes the step gathered a step
#                          when each data row gathered every parameter
#                          whole (the earlier schedule; PERF.md)
MESH_WHOLE_COPY = 437_014_528   # 18b: the whole-parameter copy that
#                          schedule held on the row's device (4 layers)
PHI = "phi3.5-moe-42b-a6.6b"   # 18e
MOE_LAYERS = 1               # 18e: phi3.5-moe's depth cut 32 -> 1 (its
#                          whole period: attention and a 16-expert MoE)
MOE_WHOLE_MOVES = {          # 18e: what mesh_step_moves composes at 18e's
    "gather": [9_889_644_544, 0],   # configuration for the schedule that
    "reduce": [3_126_091_776, 0],   # ran the MoE family's products whole
    "scatter": [6_391_676_928, 0],  # on the row's first position
    "relayout": [0, 0], "model": [0, 0], "routes": [0, 0]}
JAMBA = "jamba-v0.1-52b"     # 18f
MIXER_BATCH, MIXER_SEQ = 2, 512  # 18f: the sublayers' input
MIXER_TOL = 1e-4             # 18f: f32 split against whole, of the largest
#                          |value| of each whole output or gradient
FAMILIES = ("rwkv6-1.6b", "paligemma-3b", "whisper-medium")  # 18g: the ssm,
#                          vlm and audio families, each cut to one layer
#                          (whisper: one decoder and one encoder layer), at
#                          full width on 18b's mesh and batches (paligemma's
#                          256 patch rows and whisper's 1500 encoder frames
#                          besides the 1024 tokens)
FAMILY_SEQ = {"rwkv6-1.6b": 256}  # 18g: rwkv6's sequence cut 1024 -> 256
#                          (its time loop runs eagerly, each position
#                          scanning its own heads: a mesh step of 1024
#                          tokens took 18-25 s on the card); the others 18b's
FAMILY_WHOLE_MOVES = {       # 18g: what mesh_step_moves composes at 18g's
    "rwkv6-1.6b": {          # configurations for the schedule that ran
        "gather": [1_188_298_752, 0],   # these families' products whole
        "reduce": [646_508_544, 0],     # on the row's first position
        "scatter": [2_073_387_008, 0], "relayout": [0, 0], "model": [0, 0],
        "routes": [0, 0]},
    "paligemma-3b": {
        "gather": [3_931_373_568, 0], "reduce": [1_273_769_984, 0],
        "scatter": [4_072_972_288, 0], "relayout": [0, 0], "model": [0, 0],
        "routes": [0, 0]},
    "whisper-medium": {
        "gather": [161_480_704, 0], "reduce": [271_173_632, 0],
        "scatter": [3_077_107_712, 0], "relayout": [0, 0], "model": [0, 0],
        "routes": [0, 0]}}


SORTED_SEQ, SORTED_BATCH = 4096, 2   # 18h: JAX's train_4k length (two
#                          2048-position chunks of the sorted dispatch), a
#                          batch row on each of the (2, 4) mesh's data rows
SORTED_CF = 1.0              # 18h: the capacity factor; at JAX's 1.25 a
#                          chunk's 4,096 tokens put ~512 assignments on
#                          each of 16 experts against C 640 (the 8,192
#                          tokens ~1,024 against 1,280): nothing drops
SORTED_MASK = SORTED_SEQ // 2  # 18h: row 0's labels masked from here on
#                          (the two data rows' valid counts differ)


def mesh_devices(n: int) -> list:
    """Every position of a mesh on the one card."""
    return ["cuda:0"] * n


def spec_move_bytes(src, dst, shape, itemsize: int) -> int:
    """The bytes a layout change from sharding ``src`` to ``dst`` must move
    between positions, from the two specs alone: each position's
    destination slice less its overlap with the slice it already holds."""
    total = 0
    for c in src.mesh.positions():
        d, s = dst.box(c, shape), src.box(c, shape)
        inter = math.prod(max(0, min(d1, s1) - max(d0, s0))
                          for (d0, d1), (s0, s1) in zip(d, s))
        total += (math.prod(d1 - d0 for d0, d1 in d) - inter) * itemsize
    return total


def spec_position_bytes(specs: dict, shardings: dict) -> int:
    """The bytes one position holds of a tree of (meta) tensors laid out
    by a sharding tree, from the specs' shard shapes."""
    return sum(math.prod(shardings[k].shard_shape(tuple(v.shape)))
               * v.element_size() for k, v in specs.items())


def flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (k,)))
        return out
    return {path: tree}


def mesh_policy_phase(torch, dev, problems) -> dict:
    """18a: qwen3-0.6b's full state laid out on the (2, 4) mesh."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import param_shardings
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import (init_state, shard_state,
                                                 unshard_state)
    from repro_torch.training.tree import leaves

    cfg = get_config(QWEN)
    mesh = make_debug_mesh(*MESH_SHAPE, devices=mesh_devices(8))
    specs = flat(lm.param_specs(cfg))
    sh = flat(param_shardings(mesh, lm.param_specs(cfg)))
    want = spec_position_bytes(specs, sh)
    state = init_state(cfg, AdamW(),
                       torch.Generator(device=dev).manual_seed(0))
    whole = {"params": tree_bytes(state.params), "m": tree_bytes(state.opt.m),
             "v": tree_bytes(state.opt.v)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = shard_state(state, mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    per_pos = {}
    for name, tree in (("params", placed.params), ("m", placed.opt.m),
                       ("v", placed.opt.v)):
        ls = leaves(tree)
        per_pos[name] = [sum(s.shards[k].numel() * s.shards[k].element_size()
                             for s in ls) for k in range(mesh.size)]
    back = unshard_state(placed, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bitwise = same_leaves(torch, leaves(state), leaves(back))
    out = {"mesh": list(MESH_SHAPE), "param_bytes_a_position":
           per_pos["params"][0], "spec_param_bytes": want,
           "whole_bytes": whole, "moment_bytes_a_position":
           [per_pos["m"][0], per_pos["v"][0]],
           "shard_s": t1 - t0, "unshard_s": t2 - t1, "bitwise": bitwise}
    print(f"  [18a] {QWEN}, {cfg.n_layers} layers, {cfg.dtype}, on a "
          f"{MESH_SHAPE} mesh naming cuda:0 8 times: "
          f"{per_pos['params'][0]:,} of {whole['params']:,} parameter bytes "
          f"a position ({whole['params'] / per_pos['params'][0]:.2f}x less; "
          f"the spec's shard shapes {want:,}), AdamW m and v "
          f"{per_pos['m'][0]:,} + {per_pos['v'][0]:,} of {whole['m']:,} + "
          f"{whole['v']:,}; laid out in {t1 - t0:.3f} s, gathered back in "
          f"{t2 - t1:.3f} s, bitwise {bitwise}")
    ok = (all(b == want for b in per_pos["params"]) and want == MESH_QWEN_BYTES
          and all(b == 2 * want for b in per_pos["m"] + per_pos["v"])
          and bitwise)
    if not ok:
        problems.append(f"18a: {out}, every position {per_pos}")
    return out


def mesh_train_run(extra: list, ckpt: str) -> tuple:
    """The training launcher (``--smoke``) in this process on the card:
    :func:`train_main`."""
    return train_main([*MESH_RESUME_ARGS, "--device", mesh_devices(1)[0],
                       "--ckpt", ckpt, *extra])


def checkpoint_params_err(a, b) -> float:
    """The largest |difference| between two float32 checkpoints'
    parameter leaves (by their manifests), or inf where they differ in
    shape."""
    import numpy as np

    def params(path):
        meta = json.loads((Path(path) / "manifest.json").read_text())
        with np.load(Path(path) / "shard-0.npz") as z:
            return [z[leaf["key"]] for leaf in meta["leaves"]
                    if leaf["path"].startswith(".params")]

    pa, pb = params(a), params(b)
    if len(pa) != len(pb) or any(x.shape != y.shape for x, y in zip(pa, pb)):
        return math.inf
    return max(float(np.abs(x.astype(np.float64) - y).max())
               for x, y in zip(pa, pb))


def storage_ulp(torch, t):
    """The spacing of ``t``'s dtype at each of its values' magnitude (a
    normal value's last mantissa bit)."""
    bits = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23,
            torch.float64: 52}[t.dtype]
    tiny = torch.finfo(t.dtype).tiny
    _, e = torch.frexp(t.double().abs().clamp_min(tiny))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float64),
                       e.to(torch.float64) - 1 - bits)


def params_within(torch, got, want, lr: float, k: int) -> dict:
    """Each leaf of ``got`` against ``want`` after ``k`` AdamW steps:
    within 2 lr k (each update moves a parameter by at most lr), plus the
    k roundings of its storage dtype each run may differ by (one unit in
    the last place of its larger value a step).  ``max`` the largest
    |difference|, ``excess`` the largest by which one passes the bound,
    ``over_2lrk`` how many elements pass 2 lr k alone."""
    out = {"max": 0.0, "excess": -math.inf, "over_2lrk": 0}
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs()
        ulp = storage_ulp(torch, torch.maximum(g.abs(), w.abs()))
        out["max"] = max(out["max"], float(d.max()))
        out["excess"] = max(out["excess"],
                            float((d - 2 * lr * k - k * ulp).max()))
        out["over_2lrk"] += int((d > 2 * lr * k).sum())
    return out


def mesh_step_runs(torch, dev, cfg, opt, batches, one_accum=None,
                   spies=None) -> dict:
    """18b's, 18e's, 18g's and 18h's runs, each from ``init_state`` (seed
    0) on ``dev``: the one-device step at accum D (the (2, 4) mesh's data
    rows; ``one_accum`` if given), then the mesh step at accum 1 twice.
    Returns both runs' losses and grad_norms (the first mesh run's),
    their largest relative differences (``rel``), :func:`params_within`
    of the first mesh run's parameters (``bar``), whether the two mesh
    runs are bitwise equal (state, losses, grad_norms), seconds a step,
    raw peaks, the resident state before each run and the last step's
    ``moved``.  ``spies``: two context managers' factories, around the
    one-device run and the first mesh run."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.sharding import Sharded, unshard
    from repro_torch.training.train_step import (data_rows, init_state,
                                                 make_train_step, shard_state)
    from repro_torch.training.tree import leaves

    mesh = make_debug_mesh(*MESH_SHAPE, devices=mesh_devices(8))
    D = len(data_rows(mesh))

    def fresh():
        return init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))

    def record(i):
        return spies[i]() if spies is not None else contextlib.nullcontext()

    state = fresh()
    resident_one = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with record(0):
        state, m_one, s_one = train_run(
            torch, make_train_step(cfg, opt, accum=D if one_accum is None
                                   else one_accum), state, batches)
    peak_one = torch.cuda.max_memory_allocated()
    want = leaves(state.params)
    del state
    free_device(torch)
    step = make_train_step(cfg, opt, accum=1)
    out = {"D": D, "resident_one": resident_one, "peak_one": peak_one,
           "s_one": s_one, "secs": [], "resident": [], "peaks": []}
    for rep in range(2):
        state = shard_state(fresh(), mesh)
        torch.cuda.synchronize()
        out["resident"].append(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        metrics, secs = [], []
        with record(1) if rep == 0 else contextlib.nullcontext():
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, b)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                metrics.append((m["loss"], m["grad_norm"]))
                out["moved"] = m["moved"]
        out["peaks"].append(torch.cuda.max_memory_allocated())
        out["secs"].append(secs)
        shards = [t for x in leaves(state)
                  for t in (x.shards if isinstance(x, Sharded) else [x])]
        if rep == 0:
            out["bar"] = params_within(
                torch, [unshard(p, dev) for p in leaves(state.params)],
                want, opt.lr, len(batches))
            first, m_mesh = shards, metrics
            del want
        else:
            out["repeat"] = (
                all(same_bits(torch, x[i], y[i]) for x, y in
                    zip(metrics, m_mesh) for i in (0, 1))
                and all(same_bits(torch, t, f)
                        for t, f in zip(shards, first)))
            del first, shards
        del state
        free_device(torch)
    out["rel"] = [max(abs(float(x[i]) - float(y[i])) / abs(float(y[i]))
                      for x, y in zip(m_mesh, m_one)) for i in (0, 1)]
    out.update(losses=[float(x[0]) for x in m_one],
               grad_norms=[float(x[1]) for x in m_one],
               mesh_losses=[float(x[0]) for x in m_mesh],
               mesh_grad_norms=[float(x[1]) for x in m_mesh])
    return out


def mesh_train_phase(torch, dev, problems) -> dict:
    """18b: the sharded train step at full width (4 layers), its products
    split over ``model`` and its parameters gathered a period at a time,
    against the one-device step at accum 2 (within ``PIPE_TOL`` of its
    losses and grad_norms, every parameter within 2 lr k and a bf16
    rounding a step: :func:`params_within`), twice (bitwise); then the
    launcher on the mesh."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import validate
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.optimizer import AdamW

    cfg = validate(dataclasses.replace(get_config(QWEN),
                                       n_layers=MESH_LAYERS))
    opt = AdamW()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_SEQ,
                      global_batch=MESH_BATCH, seed=0)
    batches = [batch_at(dcfg, k, device=dev) for k in range(MESH_STEPS)]
    r = mesh_step_runs(torch, dev, cfg, opt, batches)
    D, moved, bar, rel = r["D"], r["moved"], r["bar"], r["rel"]
    bound = 2 * opt.lr * MESH_STEPS
    # the step's own memory: its peak above the state it starts from
    step_one = r["peak_one"] - r["resident_one"]
    step_mesh = max(p - x for p, x in zip(r["peaks"], r["resident"]))
    out = {"layers": MESH_LAYERS, "seq_len": MESH_SEQ, "batch": MESH_BATCH,
           "losses": r["losses"], "grad_norms": r["grad_norms"],
           "mesh_losses": r["mesh_losses"],
           "mesh_grad_norms": r["mesh_grad_norms"],
           "rel_loss": rel[0], "rel_grad_norm": rel[1],
           "param_err": bar["max"], "param_bound": bound,
           "param_excess": bar["excess"], "over_2lrk": bar["over_2lrk"],
           "one_device_step_s": r["s_one"], "mesh_step_s": r["secs"],
           "peak_bytes_one_device": r["peak_one"],
           "peak_bytes_mesh": r["peaks"],
           "resident_bytes_one_device": r["resident_one"],
           "resident_bytes_mesh": r["resident"],
           "step_peak_one_device": step_one, "step_peak_mesh": step_mesh,
           "whole_gather_before": MESH_WHOLE_GATHER,
           "moved": {k: list(v) for k, v in moved._asdict().items()},
           "bitwise_repeat": r["repeat"]}
    print(f"  [18b] {QWEN} cut to {MESH_LAYERS} layers at full width, "
          f"{cfg.dtype}, seq_len {MESH_SEQ}, global batch {MESH_BATCH}: "
          f"losses {[f'{x:.4f}' for x in out['losses']]} one device, "
          f"{[f'{x:.4f}' for x in out['mesh_losses']]} on the mesh; one "
          f"device at accum {D}: {[f'{x:.3f}' for x in r['s_one']]} s a "
          f"step; the {MESH_SHAPE} mesh at accum 1 (split products, a "
          f"period's gather at a time): "
          f"{[[f'{x:.3f}' for x in s] for s in r['secs']]} s a step "
          f"(two runs); loss and grad_norm within {rel[0]:.2e} / "
          f"{rel[1]:.2e} of the one-device step's (bar {PIPE_TOL}), every "
          f"parameter within {bar['max']:.3e} (2 lr k = {bound:.1e}, passed "
          f"by {bar['over_2lrk']} elements; with {MESH_STEPS} bf16 "
          f"roundings the bar is passed by {bar['excess']:.3e}); the two "
          f"mesh runs bitwise: {r['repeat']}")
    print(f"  [18b] peak memory: one device {r['peak_one']:,} B "
          f"({r['resident_one']:,} resident, the step {step_one:,} above "
          f"it); the mesh {r['peaks']} B ({r['resident']} resident, the "
          f"step {step_mesh:,} above it); the mesh step's above the "
          f"one-device step's {step_mesh - step_one:,} B (bar: the "
          f"whole-parameter copy {MESH_WHOLE_COPY:,} B)")
    print(f"  [18b] bytes a mesh step moves between positions (between "
          f"devices): gather {moved.gather[0]:,} ({moved.gather[1]:,}; the "
          f"whole-parameter gather before: {MESH_WHOLE_GATHER:,}), reduce "
          f"{moved.reduce[0]:,} ({moved.reduce[1]:,}), scatter "
          f"{moved.scatter[0]:,} ({moved.scatter[1]:,}), relayout "
          f"{moved.relayout[0]:,}, model {moved.model[0]:,} "
          f"({moved.model[1]:,})")
    if not (max(rel) <= PIPE_TOL and bar["excess"] <= 0 and r["repeat"]):
        problems.append(f"18b: within {rel} of the one-device step's "
                        f"losses and grad_norms (bar {PIPE_TOL}), parameters "
                        f"{bar} (bar 2 lr k = {bound} and a storage "
                        f"rounding a step), repeat {r['repeat']}")
    if not moved.gather[0] < MESH_WHOLE_GATHER:
        problems.append(f"18b: gather {moved.gather[0]} B, not below the "
                        f"whole-parameter gather {MESH_WHOLE_GATHER}")
    if not step_mesh - step_one < MESH_WHOLE_COPY:
        problems.append(f"18b: the mesh step's memory exceeds the one-device "
                        f"step's by {step_mesh - step_one} B, not less than "
                        f"{MESH_WHOLE_COPY}")
    mesh_args = ["--mesh", ",".join(map(str, MESH_SHAPE)), "--mesh-devices",
                 ",".join(mesh_devices(8))]
    with tempfile.TemporaryDirectory() as tmp:
        a, b, c, m = (os.path.join(tmp, x) for x in "abcm")
        t0 = time.perf_counter()
        procs = {
            "A": mesh_train_run(["--steps", "4", "--ckpt-every", "2",
                                 "--accum", str(D)], a),
            "M": mesh_train_run(["--steps", "4", "--ckpt-every", "2",
                                 *mesh_args], m),
            "B1": mesh_train_run(["--steps", "2", "--ckpt-every", "2",
                                  *mesh_args], b)}
        if os.path.isdir(os.path.join(b, "step-2")):
            shutil.copytree(b, c)
        procs.update({
            "B2": mesh_train_run(["--steps", "4", "--ckpt-every", "2",
                                  *mesh_args], b),
            "C": mesh_train_run(["--steps", "4", "--ckpt-every", "2",
                                 "--accum", str(D)], c)})
        launch_s = time.perf_counter() - t0
        for tag, (rc, so, se) in procs.items():
            print(f"  [18b] launcher {tag}: rc {rc}; "
                  + " | ".join(so.strip().splitlines()))
            if rc != 0:
                problems.append(f"18b launcher {tag}: rc {rc}: {se[-2000:]}")
        resumed = all("resumed from step 2" in procs.get(t, (0, ""))[1]
                      .splitlines() for t in ("B2", "C"))
        lr_bound = 2 * AdamW().lr * 4
        try:
            equal = same_checkpoint(os.path.join(m, "step-4"),
                                    os.path.join(b, "step-4"))
            errs = [checkpoint_params_err(os.path.join(a, "step-4"),
                                          os.path.join(d, "step-4"))
                    for d in (m, c)]
        except OSError as e:
            equal, errs = False, [math.inf]
            problems.append(f"18b: a step-4 checkpoint is missing ({e})")
    out["launcher"] = {"resumed": resumed, "resumed_equal": equal,
                       "param_errs": errs, "bound": lr_bound, "s": launch_s}
    print(f"  [18b] the mesh run resumed on the mesh (B) and on one device "
          f"(C) from step 2: {resumed}; B's step-4 checkpoint bitwise the "
          f"uninterrupted mesh run's (M): {equal}; M's and C's parameters "
          f"within {errs} of the one-device run's at --accum {D} (bar "
          f"{lr_bound:.1e}); the five runs in process in {launch_s:.1f} s")
    if not (resumed and equal and max(errs) <= lr_bound):
        problems.append(f"18b launcher: {out['launcher']}")
    return out


def moe_mesh_config():
    """18e's configuration: phi3.5-moe at full width, one layer."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import validate

    return validate(dataclasses.replace(get_config(PHI), n_layers=MOE_LAYERS))


def moe_mesh_phase(torch, dev, problems) -> dict:
    """18e: phi3.5-moe at full width cut to one layer (its period), its
    attention, MoE (the experts over ``data``, their ``d_ff`` over
    ``model``) and vocabulary split on the (2, 4) mesh, against the
    one-device step at accum 2 with 18b's bars; the tokens whose routes
    differ between the two counted."""
    from repro_torch.models import lm
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.optimizer import AdamW

    cfg = moe_mesh_config()
    opt = AdamW()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_SEQ,
                      global_batch=MESH_BATCH, seed=0)
    batches = [batch_at(dcfg, k, device=dev) for k in range(MESH_STEPS)]
    routes = ([], [])
    r = mesh_step_runs(torch, dev, cfg, opt, batches, spies=(
        lambda: router_record(torch, routes[0]),
        lambda: router_record(torch, routes[1])))
    D, moved, bar, rel = r["D"], r["moved"], r["bar"], r["rel"]
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(*routes))
    routed = sum(a.shape[0] * a.shape[1] for a in routes[0])
    bound = 2 * opt.lr * MESH_STEPS
    n_params = sum(math.prod(t.shape) for t in tree_leaves(
        lm.param_specs(cfg)))
    out = {"layers": cfg.n_layers, "params": n_params, "seq_len": MESH_SEQ,
           "batch": MESH_BATCH, "losses": r["losses"],
           "grad_norms": r["grad_norms"], "mesh_losses": r["mesh_losses"],
           "mesh_grad_norms": r["mesh_grad_norms"], "rel_loss": rel[0],
           "rel_grad_norm": rel[1], "param_err": bar["max"],
           "param_bound": bound, "param_excess": bar["excess"],
           "over_2lrk": bar["over_2lrk"], "route_flips": flips,
           "routed": routed, "route_calls": len(routes[0]),
           "one_device_step_s": r["s_one"], "mesh_step_s": r["secs"],
           "peak_bytes_one_device": r["peak_one"],
           "peak_bytes_mesh": r["peaks"],
           "resident_bytes_one_device": r["resident_one"],
           "resident_bytes_mesh": r["resident"],
           "moved": {k: list(v) for k, v in moved._asdict().items()},
           "whole_moves": MOE_WHOLE_MOVES, "bitwise_repeat": r["repeat"]}
    print(f"  [18e] {PHI} at full width (d {cfg.d_model}, {cfg.n_experts} "
          f"experts, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) cut to "
          f"{cfg.n_layers} layer(s), {n_params:,} parameters, {cfg.dtype}, "
          f"seq_len {MESH_SEQ}, global batch {MESH_BATCH}: losses "
          f"{[f'{x:.4f}' for x in r['losses']]} one device at accum {D}, "
          f"{[f'{x:.4f}' for x in r['mesh_losses']]} on the {MESH_SHAPE} "
          f"mesh at accum 1; within {rel[0]:.2e} / {rel[1]:.2e} (loss / "
          f"grad_norm; bar {PIPE_TOL}); every parameter within "
          f"{bar['max']:.3e} (2 lr k = {bound:.1e}, passed by "
          f"{bar['over_2lrk']} elements; with {MESH_STEPS} bf16 roundings "
          f"passed by {bar['excess']:.3e}); tokens whose routes differ "
          f"{flips} of {routed} routed ({len(routes[0])} routings each way, "
          f"forward and recomputation); the two mesh runs bitwise: "
          f"{r['repeat']}")
    print(f"  [18e] s a step: one device "
          f"{[f'{x:.3f}' for x in r['s_one']]}, the mesh "
          f"{[[f'{x:.3f}' for x in s] for s in r['secs']]} (two runs); "
          f"peak memory one device {r['peak_one']:,} B "
          f"({r['resident_one']:,} resident), the mesh {r['peaks']} B "
          f"({r['resident']} resident)")
    print(f"  [18e] bytes a mesh step moves between positions (between "
          f"devices), against the whole-product schedule's composed "
          f"moves: " + ", ".join(
              f"{k} {v[0]:,} ({v[1]:,}; whole {MOE_WHOLE_MOVES[k][0]:,})"
              for k, v in out["moved"].items()))
    if not (max(rel) <= PIPE_TOL and bar["excess"] <= 0 and r["repeat"]):
        problems.append(f"18e: within {rel} of the one-device step's "
                        f"losses and grad_norms (bar {PIPE_TOL}), parameters "
                        f"{bar} (bar 2 lr k = {bound} and a storage "
                        f"rounding a step), repeat {r['repeat']}")
    if not (moved.model[0] > 0
            and moved.gather[0] < MOE_WHOLE_MOVES["gather"][0]):
        problems.append(f"18e: gather {moved.gather[0]} B (whole "
                        f"{MOE_WHOLE_MOVES['gather'][0]}), model "
                        f"{moved.model[0]} B")
    return out


def sorted_mesh_config():
    """18h's configuration: 18e's with the sorted dispatch at
    ``SORTED_CF``."""
    return dataclasses.replace(moe_mesh_config(), moe_dispatch="sorted",
                               moe_capacity_factor=SORTED_CF)


def sorted_batches(cfg, dev) -> list:
    """18h's batches: ``batch_at`` (seed 0) at ``SORTED_SEQ`` x
    ``SORTED_BATCH``, row 0's labels masked from ``SORTED_MASK`` on."""
    from repro_torch.models.lm import MASK_LABEL
    from repro_torch.training.data import DataConfig, batch_at

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SORTED_SEQ,
                      global_batch=SORTED_BATCH, seed=0)
    out = []
    for k in range(MESH_STEPS):
        b = batch_at(dcfg, k, device=dev)
        b["labels"][0, SORTED_MASK:] = MASK_LABEL
        out.append(b)
    return out


def sort_keep(torch, idx, C: int):
    """What JAX's ``_moe_sorted_block`` keeps of routes ``idx`` ``(N,
    k)`` at capacity ``C``: a stable sort by expert over their flat
    order, an assignment kept where its rank in its expert is below
    ``C`` (in the flat order)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    rank = (torch.arange(se.numel(), device=se.device)
            - torch.searchsorted(se, se))
    keep = torch.empty_like(flat, dtype=torch.bool)
    keep[order] = rank < C
    return keep


def capacity(cfg, n: int) -> int:
    """JAX's ``C`` for ``n`` tokens."""
    return int(cfg.moe_capacity_factor * n * cfg.experts_per_token
               / cfg.n_experts + 0.999)


@contextlib.contextmanager
def micro_record(calls: list):
    """Record each microbatch view the mesh step makes (its sorted
    dispatch's decisions, ``Micro.routes``)."""
    from repro_torch.models import tensor_parallel as tp

    real = tp.micro_view

    def spy(*args, **kw):
        trees, micro = real(*args, **kw)
        calls.append(micro)
        return trees, micro

    tp.micro_view = spy
    try:
        yield calls
    finally:
        tp.micro_view = real


@contextlib.contextmanager
def sorted_block_record(torch, cfg, calls: list):
    """Record each whole sorted block's ``(routes, kept)`` in the forward
    pass while the LM stack runs (the one-device step; not the backward
    pass's recomputation), the routes from the block's own router
    product."""
    from repro_torch.models import layers

    real = layers._moe_sorted_block

    def spy(p, x, **kw):
        if torch._C._current_graph_task_id() != -1:   # a recomputation
            return real(p, x, **kw)
        with torch.no_grad():
            logits = x.reshape(-1, x.shape[-1]).float() @ p["router"]
            idx = torch.topk(logits, kw["top_k"], dim=-1).indices
            calls.append((idx, sort_keep(torch, idx,
                                         capacity(cfg, idx.shape[0]))))
        return real(p, x, **kw)

    layers._moe_sorted_block = spy
    try:
        yield calls
    finally:
        layers._moe_sorted_block = real


def kept_set_check(torch, cfg, micros: list) -> tuple:
    """``(counts, problems)``: each microbatch's kept assignments (the
    mesh step's, recorded in its ``Micro``) against what a sort over the
    microbatch's own recorded routes keeps (:func:`sort_keep`, the rows'
    routes in row order, the microbatch's capacity), exactly; at least
    one assignment must drop.  ``busiest2``: the least and the most share
    of a (chunk, row)'s assignments that its two busiest experts take."""
    out = {"chunks": 0, "assignments": 0, "dropped": 0, "mismatched": 0}
    shares = []
    for micro in micros:
        for routes in micro.routes.values():
            for r in routes:
                loads = torch.bincount(r[0].flatten(),
                                       minlength=cfg.n_experts)
                shares.append(float(loads.sort(descending=True).values[:2]
                                    .sum()) / r[0].numel())
            idx = torch.cat([r[0] for r in routes])
            keep = torch.cat([r[1] for r in routes])
            want = sort_keep(torch, idx, capacity(cfg, idx.shape[0]))
            out["chunks"] += 1
            out["assignments"] += keep.numel()
            out["dropped"] += int((~keep).sum())
            out["mismatched"] += int((keep != want).sum())
    out["busiest2"] = [min(shares, default=0.0), max(shares, default=0.0)]
    problems = []
    if not out["chunks"] or out["mismatched"]:
        problems.append(f"18h: the mesh's kept set is not the microbatch "
                        f"sort's of its own routes: {out}")
    if not out["dropped"]:
        problems.append(f"18h: no assignment dropped: {out}")
    return out, problems


def sorted_mesh_phase(torch, dev, problems) -> dict:
    """18h: 18e's configuration with the sorted MoE dispatch at capacity
    factor ``SORTED_CF``, ``SORTED_BATCH`` x ``SORTED_SEQ`` (row 0's
    labels masked from ``SORTED_MASK`` on), the (2, 4) mesh at accum 1
    against the one-device step at accum 1 (the same microbatch) with
    18b's bars, the mesh run twice bitwise; the bytes a step moves equal
    to what ``mesh_step_moves`` composes; assignments dropped, and the
    mesh's kept set the microbatch sort's of its own recorded routes
    (:func:`kept_set_check`); the dropped counts both ways and the
    tokens whose routes differ between the two runs."""
    from repro_torch.training.optimizer import AdamW

    cfg = sorted_mesh_config()
    opt = AdamW()
    batches = sorted_batches(cfg, dev)
    micros, blocks = [], []
    r = mesh_step_runs(torch, dev, cfg, opt, batches, one_accum=1, spies=(
        lambda: sorted_block_record(torch, cfg, blocks),
        lambda: micro_record(micros)))
    moved, bar, rel = r["moved"], r["bar"], r["rel"]
    kept, found = kept_set_check(torch, cfg, micros)
    problems += found
    # the one-device step's blocks against the mesh's chunks, in order
    mesh = [torch.cat([x[0] for x in routes]) for micro in micros
            for routes in micro.routes.values()]
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for (a, _), b in zip(blocks, mesh))
    dropped_one = sum(int((~keep).sum()) for _, keep in blocks)
    if len(blocks) != len(mesh):
        problems.append(f"18h: {len(blocks)} sorted blocks on one device, "
                        f"{len(mesh)} on the mesh")
    bound = 2 * opt.lr * MESH_STEPS
    composed = composed_moves(cfg, SORTED_SEQ, SORTED_BATCH)
    measured = {k: list(v) for k, v in moved._asdict().items()}
    out = {"layers": cfg.n_layers, "seq_len": SORTED_SEQ,
           "batch": SORTED_BATCH, "capacity_factor": SORTED_CF,
           "capacity": capacity(cfg, SORTED_BATCH * min(SORTED_SEQ, 2048)),
           "losses": r["losses"], "grad_norms": r["grad_norms"],
           "mesh_losses": r["mesh_losses"],
           "mesh_grad_norms": r["mesh_grad_norms"], "rel_loss": rel[0],
           "rel_grad_norm": rel[1], "param_err": bar["max"],
           "param_bound": bound, "param_excess": bar["excess"],
           "over_2lrk": bar["over_2lrk"], "kept": kept,
           "dropped_one_device": dropped_one, "route_flips": flips,
           "one_device_step_s": r["s_one"], "mesh_step_s": r["secs"],
           "peak_bytes_one_device": r["peak_one"],
           "peak_bytes_mesh": r["peaks"],
           "resident_bytes_one_device": r["resident_one"],
           "resident_bytes_mesh": r["resident"], "moved": measured,
           "composed": composed, "bitwise_repeat": r["repeat"]}
    print(f"  [18h] {PHI} at full width cut to {cfg.n_layers} layer(s), "
          f"the sorted dispatch at capacity factor {SORTED_CF} (C "
          f"{out['capacity']} a 2048-position chunk), {cfg.dtype}, "
          f"{SORTED_BATCH} x {SORTED_SEQ}, row 0's labels masked from "
          f"{SORTED_MASK}: losses {[f'{x:.4f}' for x in r['losses']]} one "
          f"device at accum 1, {[f'{x:.4f}' for x in r['mesh_losses']]} on "
          f"the {MESH_SHAPE} mesh at accum 1; within {rel[0]:.2e} / "
          f"{rel[1]:.2e} (loss / grad_norm; bar {PIPE_TOL}); every "
          f"parameter within {bar['max']:.3e} (2 lr k = {bound:.1e}, "
          f"passed by {bar['over_2lrk']} elements; with {MESH_STEPS} bf16 "
          f"roundings passed by {bar['excess']:.3e}); the two mesh runs "
          f"bitwise: {r['repeat']}")
    print(f"  [18h] assignments dropped: the mesh {kept['dropped']} of "
          f"{kept['assignments']} ({kept['chunks']} chunks), one device "
          f"{dropped_one}; the mesh's kept set against the microbatch sort "
          f"of its own routes: {kept['mismatched']} differ; tokens whose "
          f"routes differ between the two runs {flips}; a (chunk, row)'s "
          f"two busiest experts take {kept['busiest2'][0]:.4f}-"
          f"{kept['busiest2'][1]:.4f} of its assignments")
    print(f"  [18h] s a step: one device "
          f"{[f'{x:.3f}' for x in r['s_one']]}, the mesh "
          f"{[[f'{x:.3f}' for x in s] for s in r['secs']]} (two runs); "
          f"peak memory one device {r['peak_one']:,} B "
          f"({r['resident_one']:,} resident), the mesh {r['peaks']} B "
          f"({r['resident']} resident); bytes a step moves (between "
          f"devices): " + ", ".join(f"{k} {v[0]:,} ({v[1]:,})"
                                    for k, v in measured.items())
          + f"; composed equal: {composed == measured}")
    if not (max(rel) <= PIPE_TOL and bar["excess"] <= 0 and r["repeat"]):
        problems.append(f"18h: within {rel} of the one-device step's "
                        f"losses and grad_norms (bar {PIPE_TOL}), parameters "
                        f"{bar} (bar 2 lr k = {bound} and a storage "
                        f"rounding a step), repeat {r['repeat']}")
    if composed != measured:
        problems.append(f"18h: moves composed {composed}, measured "
                        f"{measured}")
    return out


def mixer_split_phase(torch, dev, problems) -> dict:
    """18f: jamba's Mamba mixer and MoE sublayer at full width in f32 on
    one (2, 4) row, split over ``model``, against the whole sublayers on
    the same inputs: the output and the gradients of the input and of
    every parameter (a random cotangent) within ``MIXER_TOL`` of the
    largest |value| of each whole one."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.layers import moe_apply, moe_init
    from repro_torch.models.sharding import MoveStats, param_shardings, shard
    from repro_torch.models.ssm import mamba_apply, mamba_init
    from repro_torch.training.tree import leaves, unflatten

    cfg = dataclasses.replace(get_config(JAMBA), dtype="float32")
    d, f32 = cfg.d_model, torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    names = [f"l{i}" for i, s in enumerate(cfg.period())]
    mix = next(n for n, s in zip(names, cfg.period())
               if s.kind.value == "mamba")
    moe = next(n for n, s in zip(names, cfg.period()) if s.moe)
    mesh = make_debug_mesh(*MESH_SHAPE, devices=mesh_devices(8))
    out = {"d_model": d, "d_inner": cfg.d_inner,
           "d_state": cfg.ssm_d_state, "n_experts": cfg.n_experts,
           "d_ff": cfg.d_ff, "batch": MIXER_BATCH, "seq_len": MIXER_SEQ}

    def one(sub, layer, init, whole_fn, split_fn):
        t0 = time.perf_counter()
        params = {"blocks": {layer: {sub: {
            k: v.unsqueeze(0) for k, v in init().items()}}}}
        x = torch.randn((MIXER_BATCH, MIXER_SEQ, d), generator=gen,
                        dtype=f32, device=dev)
        g = torch.randn(x.shape, generator=gen, dtype=f32, device=dev)
        ls = leaves(params)
        placed = unflatten(params, [shard(t, s) for t, s in zip(
            ls, leaves(param_shardings(mesh, params)))])
        # the whole sublayer: its output and gradients, kept
        req = [t.requires_grad_() for t in ls]
        xw = x.clone().requires_grad_()
        p = lm._index(unflatten(params, req)["blocks"], 0)[layer][sub]
        y = whole_fn(p, xw)
        want = [y.detach()] + list(torch.autograd.grad((y * g).sum(),
                                                       [xw] + req))
        del params, ls, req, p, y, xw
        free_device(torch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stats = {"gather": MoveStats(), "model": MoveStats(),
             "routes": MoveStats()}
        tree, row = tp.row_view(cfg, placed, (0, 0), stats)
        sp = tp.materialize(cfg, lm._index(tree["blocks"], 0))[layer][sub]
        xs = x.clone().requires_grad_()
        y = split_fn(sp, xs)
        pieces = row.pieces()
        got = torch.autograd.grad((y * g).sum(),
                                  [xs] + [q[3] for q in pieces])
        torch.cuda.synchronize()
        t2 = time.perf_counter()

        def err(a, w):
            return float((a - w).abs().max() / w.abs().max())

        errs = {"y": err(y.detach(), want[0]), "x": err(got[0], want[1])}
        for (k, idx, _, _), gk in zip(pieces, got[1:]):
            name = f"param{k}"
            w = want[2 + k]
            e = float((gk - w[idx]).abs().max() / w.abs().max())
            errs[name] = max(errs.get(name, 0.0), e)
        r = {"split": tp.is_split(sp), "errs": errs,
             "max_err": max(errs.values()), "whole_s": t1 - t0,
             "split_s": t2 - t1, "pieces": len(pieces),
             "gather": list(stats["gather"]), "model": list(stats["model"])}
        print(f"  [18f] {sub} ({layer}) split over {MESH_SHAPE[1]} "
              f"positions: {r['split']}; output, input gradient and "
              f"{len(errs) - 2} parameter gradients within "
              f"{r['max_err']:.2e} of the whole sublayer's largest |value| "
              f"(bar {MIXER_TOL}); {len(pieces)} pieces, gather "
              f"{r['gather'][0]:,} B, model {r['model'][0]:,} B; "
              f"whole {t1 - t0:.2f} s, split {t2 - t1:.2f} s")
        if not (r["split"] and r["max_err"] <= MIXER_TOL):
            problems.append(f"18f {sub}: {r}")
        del placed, tree, row, sp, y, got, want, pieces
        free_device(torch)
        return r

    out["mamba"] = one(
        "mix", mix, lambda: mamba_init(gen, d, cfg.d_inner, cfg.ssm_d_state,
                                       lm.D_CONV, f32),
        lambda p, x: mamba_apply(p, x)[0],
        lambda p, x: tp.mamba_apply(p, x)[0])
    kw = {"top_k": cfg.experts_per_token, "act": cfg.act}
    out["moe"] = one(
        "ffn", moe, lambda: moe_init(gen, d, cfg.d_ff, cfg.n_experts,
                                     cfg.act_gated, f32),
        lambda p, x: moe_apply(p, x, **kw),
        lambda p, x: tp.moe_apply(p, x, **kw))
    print(f"  [18f] {JAMBA}'s sublayers at full width (d {d}, d_inner "
          f"{cfg.d_inner}, d_state {cfg.ssm_d_state}, {cfg.n_experts} "
          f"experts, d_ff {cfg.d_ff}) in f32, {MIXER_BATCH} x {MIXER_SEQ}, "
          f"on one {MESH_SHAPE} row")
    return out


def family_mesh_config(arch: str):
    """18g's configuration of ``arch``: full width, one layer (and at most
    one encoder layer)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import validate

    cfg = get_config(arch)
    return validate(dataclasses.replace(
        cfg, n_layers=1, encoder_layers=min(1, cfg.encoder_layers)))


def family_mesh_phase(torch, dev, problems) -> dict:
    """18g: rwkv6-1.6b (its heads and channel mix), paligemma-3b (its
    attention, MLP and vocabulary over its patch rows and text) and
    whisper-medium (its encoder, self- and cross-attention) at full width
    cut to one layer, their products split over ``model`` on 18b's mesh
    and batches (the patches and frames as the batch's frontend), each
    against the one-device step at accum 2 with 18b's bars, the mesh run
    twice bitwise; s a step, both peaks, the bytes a step moves by kind
    beside the whole-product schedule's (``FAMILY_WHOLE_MOVES``): the
    gather must fall below it and ``model`` be above 0."""
    from repro_torch.models import lm
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.optimizer import AdamW

    out = {}
    for arch in FAMILIES:
        t0 = time.perf_counter()
        cfg = family_mesh_config(arch)
        seq = FAMILY_SEQ.get(arch, MESH_SEQ)
        opt = AdamW()
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=MESH_BATCH, seed=0,
                          frontend_len=cfg.frontend_len if cfg.frontend
                          else 0, d_model=cfg.d_model)
        batches = [batch_at(dcfg, k, device=dev) for k in range(MESH_STEPS)]
        r = mesh_step_runs(torch, dev, cfg, opt, batches)
        del batches
        free_device(torch)
        D, moved, bar, rel = r["D"], r["moved"], r["bar"], r["rel"]
        bound = 2 * opt.lr * MESH_STEPS
        whole = FAMILY_WHOLE_MOVES[arch]
        n_params = sum(math.prod(t.shape) for t in tree_leaves(
            lm.param_specs(cfg)))
        rows = seq + (cfg.frontend_len if cfg.frontend == "vision_stub"
                      else 0)
        out[arch] = {
            "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
            "params": n_params, "seq_len": seq, "stack_rows": rows,
            "frontend_len": cfg.frontend_len, "batch": MESH_BATCH,
            "losses": r["losses"], "grad_norms": r["grad_norms"],
            "mesh_losses": r["mesh_losses"],
            "mesh_grad_norms": r["mesh_grad_norms"], "rel_loss": rel[0],
            "rel_grad_norm": rel[1], "param_err": bar["max"],
            "param_bound": bound, "param_excess": bar["excess"],
            "over_2lrk": bar["over_2lrk"], "one_device_step_s": r["s_one"],
            "mesh_step_s": r["secs"], "peak_bytes_one_device": r["peak_one"],
            "peak_bytes_mesh": r["peaks"],
            "resident_bytes_one_device": r["resident_one"],
            "resident_bytes_mesh": r["resident"],
            "moved": {k: list(v) for k, v in moved._asdict().items()},
            "whole_moves": whole, "bitwise_repeat": r["repeat"],
            "s": time.perf_counter() - t0}
        print(f"  [18g] {arch} ({cfg.family}) at full width (d "
              f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads} heads, vocab "
              f"{cfg.vocab_size}) cut to {cfg.n_layers} layer(s)"
              + (f" and {cfg.encoder_layers} encoder layer(s) over "
                 f"{cfg.frontend_len} frames" if cfg.encoder_layers else "")
              + f", {n_params:,} parameters, {cfg.dtype}, {MESH_BATCH} x "
              f"{rows} rows{' (patches and text)' if rows != seq else ''}"
              f": losses {[f'{x:.4f}' for x in r['losses']]} one device at "
              f"accum {D}, {[f'{x:.4f}' for x in r['mesh_losses']]} on the "
              f"{MESH_SHAPE} mesh at accum 1; within {rel[0]:.2e} / "
              f"{rel[1]:.2e} (loss / grad_norm; bar {PIPE_TOL}); every "
              f"parameter within {bar['max']:.3e} (2 lr k = {bound:.1e}, "
              f"passed by {bar['over_2lrk']} elements; with {MESH_STEPS} "
              f"bf16 roundings passed by {bar['excess']:.3e}); the two mesh "
              f"runs bitwise: {r['repeat']}")
        print(f"  [18g] {arch} s a step: one device "
              f"{[f'{x:.3f}' for x in r['s_one']]}, the mesh "
              f"{[[f'{x:.3f}' for x in s] for s in r['secs']]} (two runs); "
              f"peak memory one device {r['peak_one']:,} B "
              f"({r['resident_one']:,} resident), the mesh {r['peaks']} B "
              f"({r['resident']} resident); {out[arch]['s']:.1f} s in all")
        print(f"  [18g] {arch} bytes a mesh step moves between positions "
              f"(between devices), against the whole-product schedule's "
              f"composed moves: " + ", ".join(
                  f"{k} {v[0]:,} ({v[1]:,}; whole {whole[k][0]:,})"
                  for k, v in out[arch]["moved"].items()))
        if not (max(rel) <= PIPE_TOL and bar["excess"] <= 0 and r["repeat"]):
            problems.append(f"18g {arch}: within {rel} of the one-device "
                            f"step's losses and grad_norms (bar {PIPE_TOL}), "
                            f"parameters {bar} (bar 2 lr k = {bound} and a "
                            f"storage rounding a step), repeat {r['repeat']}")
        if not (moved.model[0] > 0 and moved.gather[0] < whole["gather"][0]):
            problems.append(f"18g {arch}: gather {moved.gather[0]} B (whole "
                            f"{whole['gather'][0]}), model {moved.model[0]} B")
        del r
        free_device(torch)
    return out


def pipeline_phase(torch, dev, problems) -> dict:
    """18c: the GPipe forward on the (pod, data, model) mesh against
    ``hidden_states`` per slice (bitwise) and on the full batch."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.config import validate
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.pipeline import pipelined_forward

    cfg = validate(dataclasses.replace(get_config(QWEN),
                                       n_layers=MESH_LAYERS))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_SEQ,
                                 global_batch=MESH_BATCH, seed=0), 0,
                      device=dev)["tokens"]
    mesh = make_mesh(PIPE_MESH, ("pod", "data", "model"), mesh_devices(8))
    D = mesh.shape["data"]
    b = MESH_BATCH // PIPE_MICRO // D
    stats = {}
    with torch.no_grad():
        def pipe():
            return pipelined_forward(cfg, params, tokens, mesh=mesh,
                                     n_micro=PIPE_MICRO, stats=stats)

        def full():
            return lm.hidden_states(cfg, params, tokens)

        y, ref = pipe(), full()          # warm
        ms = {"pipelined": [], "hidden_states": []}
        for _ in range(2):
            for name, fn in (("pipelined", pipe), ("hidden_states", full)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                ms[name].append(1e3 * (time.perf_counter() - t0))
                if name == "pipelined":
                    y = out
        slices = torch.cat([lm.hidden_states(cfg, params,
                                             tokens[j * b:(j + 1) * b])
                            for j in range(PIPE_MICRO * D)], 0)
    bitwise = same_bits(torch, y, slices)
    err = float((y.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    res = {"mesh": list(PIPE_MESH), "n_micro": PIPE_MICRO, "ms": ms,
           "bitwise_per_slice": bitwise, "err_vs_full": err,
           "tol": PIPE_TOL, "moved": stats}
    print(f"  [18c] {QWEN} ({MESH_LAYERS} layers, {cfg.dtype}), "
          f"{MESH_BATCH} x {MESH_SEQ} on a (pod, data, model) {PIPE_MESH} "
          f"mesh, {PIPE_MICRO} microbatches: pipelined "
          f"{[f'{x:.1f}' for x in ms['pipelined']]} ms against hidden_states "
          f"{[f'{x:.1f}' for x in ms['hidden_states']]} ms; bitwise "
          f"hidden_states per slice: {bitwise}; against the full batch "
          f"{err:.3e} of max (bound {PIPE_TOL:g}); bytes handed between "
          f"stages {stats['hop_bytes']:,}, broadcast "
          f"{stats['broadcast_bytes']:,}")
    if not (bitwise and err <= PIPE_TOL):
        problems.append(f"18c: {res}")
    return res


def kv_mesh_phase(torch, dev, problems) -> dict:
    """18d: the prefill cache repartitioned from the fine to the coarse
    layout under both schedules, then decoded."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import (NamedSharding, P, shard,
                                             unshard, unshard_tree)
    from repro_torch.serving.repartition_kv import (KVRepartitionPlan,
                                                    repartition_cache)

    cfg = get_config(QWEN)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    prompts, _ = on(torch, dev, *lm_inputs(cfg, QWEN_BATCH, QWEN_PROMPT))
    max_len = QWEN_PROMPT + QWEN_NEW
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, params, prompts, max_len)
    mesh = make_debug_mesh(*MESH_SHAPE, devices=mesh_devices(8))
    plan = KVRepartitionPlan.build(QWEN_BATCH, KV_FINE, KV_ALPHA)
    fine = NamedSharding(mesh, plan.fine_spec())
    coarse = NamedSharding(mesh, plan.coarse_spec())
    staged = NamedSharding(mesh, P(None, "data", None, None, None))
    placed = tree_map(lambda t: shard(t, fine), cache)
    kv = list(tree_leaves(cache))
    derived = {
        "device_direct": sum(spec_move_bytes(fine, coarse, tuple(t.shape),
                                             t.element_size()) for t in kv),
        "host_buffer": sum(spec_move_bytes(fine, staged, tuple(t.shape),
                                           t.element_size())
                           + spec_move_bytes(staged, coarse, tuple(t.shape),
                                             t.element_size()) for t in kv)}

    def decode(c):
        toks = [greedy(torch, logits)]
        with torch.no_grad():
            for i in range(KV_DECODE):
                lg, c = lm.decode_step(cfg, params, c, toks[-1],
                                       QWEN_PROMPT + i)
                toks.append(greedy(torch, lg))
        return torch.cat(toks, 1)

    want_tokens = decode(tree_map(lambda t: t.clone(), cache))
    out = {"bytes_whole": sum(t.numel() * t.element_size() for t in kv)}
    for schedule in ("device_direct", "host_buffer"):
        ms = []
        for _ in range(3):
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            moved = repartition_cache(plan, mesh, placed, schedule,
                                      stats=stats)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        got = list(tree_leaves(moved))
        identity = all(same_bits(torch, unshard(g, dev), t)
                       for g, t in zip(got, kv))
        shapes = all(tuple(s.shape) == coarse.shard_shape(g.shape)
                     for g in got for s in g.shards)
        tokens = decode(unshard_tree(moved, dev))
        same_tokens = bool(torch.equal(tokens, want_tokens))
        n = stats["moved"].positions
        out[schedule] = {"ms": ms, "bytes_moved": n,
                         "bytes_between_devices": stats["moved"].devices,
                         "derived_bytes": derived[schedule],
                         "identity": identity, "coarse_shapes": shapes,
                         "same_tokens": same_tokens}
        print(f"  [18d] {schedule}: {[f'{x:.2f}' for x in ms]} ms, "
              f"{n:,} bytes moved between positions (derived from the specs "
              f"{derived[schedule]:,}; between devices "
              f"{stats['moved'].devices:,}) of {out['bytes_whole']:,}; "
              f"identity {identity}, coarse shard shapes {shapes}, "
              f"{KV_DECODE} decode steps give the original's tokens: "
              f"{same_tokens}")
        if not (identity and shapes and same_tokens and n > 0
                and n == derived[schedule]):
            problems.append(f"18d {schedule}: {out[schedule]}")
        del moved, got
    if out["host_buffer"]["bytes_moved"] < out["device_direct"]["bytes_moved"]:
        problems.append("18d: host_buffer moved less than device_direct")
    print(f"  [18d] {QWEN}, {cfg.n_layers} layers, batch {QWEN_BATCH}, prompt "
          f"{QWEN_PROMPT}, max_len {max_len}: the cache laid out by "
          f"{plan.fine_spec()} and moved to {plan.coarse_spec()} "
          f"(KVRepartitionPlan.build({QWEN_BATCH}, {KV_FINE}, {KV_ALPHA}): "
          f"{plan.n_coarse} decode groups); device-local copies on one card, "
          f"a floor of the copy cost, not an interconnect figure")
    return out


def lm_mesh_phase(torch, dev) -> dict:
    """Phase 18 (see the module docstring).  Its checks are collected and
    fail the run after its parts have printed."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[18] the LM side over a device mesh: every position on cuda:0; "
          f"policy and layout, the sharded train step (dense, MoE), jamba's "
          f"split sublayers, the ssm, vlm and audio families' steps, the "
          f"GPipe forward, the KV repartition")
    problems = []
    out = {"part_s": {}}
    for key, part in (("policy", mesh_policy_phase),
                      ("train", mesh_train_phase),
                      ("moe", moe_mesh_phase), ("sorted", sorted_mesh_phase),
                      ("mixer", mixer_split_phase),
                      ("families", family_mesh_phase),
                      ("pipeline", pipeline_phase), ("kv", kv_mesh_phase)):
        t1 = time.perf_counter()
        try:
            out[key] = part(torch, dev, problems)
        except Exception as e:  # noqa: BLE001 — collected, fails the phase
            traceback.print_exc()
            problems.append(f"18 {key}: {type(e).__name__}: {e}")
        free_device(torch)
        out["part_s"][key] = time.perf_counter() - t1
        print(f"  [18] {key}: {out['part_s'][key]:.1f} s")
    out["seconds"] = time.perf_counter() - t0
    print(f"  [18] {out['seconds']:.1f} s")
    for p in problems:
        print(f"  FAILED: {p}")
    require(not problems, f"phase 18: {len(problems)} check(s) failed")
    return out


def main_state(torch):
    """The main path's state after its 3 steps from rest (the kernels)."""
    from repro_torch.launch.case import build_parser, build_solver

    args = build_parser().parse_args(MAIN_ARGS)
    solver = build_solver(args)
    dt = args.co * solver.mesh.h
    state, _ = solver.run_steps(solver.initial_state(), dt, 3)
    torch.cuda.synchronize()
    del solver
    free_device(torch)
    return state


def serving_phase(torch, dev, state3) -> tuple:
    """Phase 13 (see the module docstring); its checks are collected and
    fail the run after all four parts have printed.  The launch counters
    are zeroed before the serving runs (13b-13d) and read after them.
    Returns the phase's record and 13b's cohort end states (tenant ->
    (state, last-step stats))."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    print("[13] serving: lane kernels, 210^3 cohort, small tenants, "
          "arrivals")
    problems = []
    out = {"lane_kernels": lane_kernel_phase(torch, dev, problems)}
    free_device(torch)
    reset_launch_counts()
    ends = {}
    out["full_width"] = full_width_phase(torch, dev, state3, problems, ends)
    free_device(torch)
    out["small"] = small_tenants_phase(torch, dev, problems)
    free_device(torch)
    out["arrivals"] = arrivals_phase(torch, dev, problems)
    free_device(torch)
    out["launches"] = launch_counts()
    print(f"  [13] serving path launches: {out['launches']}")
    if not all(out["launches"][k] > 0 for k in STEP_KERNELS):
        problems.append(f"a kernel of the serving path was never launched: "
                        f"{out['launches']}")
    for p in problems:
        print(f"  FAILED: {p}")
    require(not problems, f"phase 13: {len(problems)} check(s) failed")
    return out, ends


def serving_phases(torch, dev, state3) -> dict:
    """Phases 13 and 14, from the main run's 3-step state."""
    serving, ends = serving_phase(torch, dev, state3)
    free_device(torch)
    fw = serving["full_width"]
    warm = {"steps_per_s": fw["cohort_steps_per_s"],
            "peak_gib": fw["peak_gb"]["3"]}
    serving["supervision"] = supervision_phase(torch, dev, state3, ends,
                                               warm)
    return serving


DRYRUN_STATUS = {"ok": 66, "skipped": 14, "error": 0}  # 20: 10 archs x 4
#                          shapes x 2 meshes; long_500k skipped for the 7
#                          full-attention archs on each mesh
DRYRUN_TIMEOUT = 300     # 20: s for the whole dry-run (about 11 s on one
#                          host core)


def dryrun_status(records: list) -> dict:
    return {k: sum(1 for r in records if r.get("status") == k)
            for k in DRYRUN_STATUS}


def dryrun_problems(records: list, names: list) -> list:
    """What is wrong with the dry-run's records (``names``: their file
    names): the count by status, a record in error, a name that is not
    JAX's ``{arch}__{shape}__{mesh}.json``."""
    out = []
    got = dryrun_status(records)
    if got != DRYRUN_STATUS or len(records) != sum(DRYRUN_STATUS.values()):
        out.append(f"20: {len(records)} records, {got}, want "
                   f"{DRYRUN_STATUS}")
    for r, name in zip(records, names):
        want = f"{r.get('arch')}__{r.get('shape')}__{r.get('mesh')}.json"
        if name != want:
            out.append(f"20: {name} holds the record of {want}")
        if r.get("status") == "error":
            out.append(f"20: {name}: {r.get('error')}")
    return out


def composed_moves(cfg, seq=None, batch=None) -> dict:
    """The moves :func:`mesh_step_moves` composes for 18b's, 18e's, 18g's
    and 18h's step of ``cfg`` (the (2, 4) mesh on the card, accum 1,
    ``batch`` x ``seq``, default ``MESH_BATCH`` x ``MESH_SEQ``), as those
    parts report what they measured."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training.train_step import mesh_step_moves

    mesh = make_debug_mesh(*MESH_SHAPE, devices=mesh_devices(8))
    moved = mesh_step_moves(cfg, mesh, 1,
                            MESH_BATCH if batch is None else batch,
                            MESH_SEQ if seq is None else seq)
    return {k: list(v) for k, v in moved._asdict().items()}


def composed_18b_moves() -> dict:
    """:func:`composed_moves` at 18b's configuration."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import validate

    return composed_moves(validate(dataclasses.replace(
        get_config(QWEN), n_layers=MESH_LAYERS)))


def composed_18e_moves() -> dict:
    """:func:`composed_moves` at 18e's configuration."""
    return composed_moves(moe_mesh_config())


def run_dryrun() -> tuple:
    """``python -m repro_torch.launch.dryrun --all --mesh both`` into a
    temporary directory: (the finished process, the records' file names,
    the records, its seconds)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "both", "--out", tmp], capture_output=True, text=True,
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            timeout=DRYRUN_TIMEOUT)
        paths = sorted(Path(tmp).glob("*.json"))
        records = [json.loads(p.read_text()) for p in paths]
    return proc, [p.name for p in paths], records, time.perf_counter() - t0


def start_dryrun():
    """:func:`run_dryrun` on a thread of its own (the whole run starts it
    beside the kernels' build, both host work, and waits for it before
    phase 3 times anything); a future of its result."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(run_dryrun)
    finally:
        pool.shutdown(wait=False)


def dryrun_phase(lm_mesh: dict | None = None, pending=None) -> dict:
    """Phase 20 (see the module docstring): the whole dry-run as a user
    runs it (``pending``: the future :func:`start_dryrun` gave, else run
    here), then, with phase 18's result, 18b's, 18e's, 18h's and 18g's
    bytes."""
    t0 = time.perf_counter()
    print("[20] the port's dry-run: every (arch x shape x mesh) cell on the "
          "production meshes, on the host"
          + (" (run beside the kernels' build)" if pending else ""))
    problems = []
    proc, names, records, seconds = (pending.result() if pending
                                     else run_dryrun())
    if proc.returncode != 0:
        problems.append(f"20: the dry-run exited {proc.returncode}: "
                        f"{proc.stderr[-2000:]}")
    problems += dryrun_problems(records, names)
    status = dryrun_status(records)
    out = {"records": len(records), "status": status, "dryrun_s": seconds,
           "moves_reason": sorted(f"{r['arch']} x {r['mesh']}"
                                  for r in records if "moves_reason" in r)}
    print(f"  [20] {len(records)} records {status} in {seconds:.1f} s "
          f"(the command, interpreter start included); train cells without "
          f"moves: {out['moves_reason']}")
    if out["moves_reason"]:
        problems.append(f"20: train cells without moves: "
                        f"{out['moves_reason']}")
    runs = [(("train",), "18b", composed_18b_moves),
            (("moe",), "18e", composed_18e_moves),
            (("sorted",), "18h", lambda: composed_moves(
                sorted_mesh_config(), SORTED_SEQ, SORTED_BATCH))] + [
        (("families", arch), f"18g {arch}", functools.partial(
            composed_moves, family_mesh_config(arch),
            FAMILY_SEQ.get(arch, MESH_SEQ))) for arch in FAMILIES]
    for keys, tag, compose in runs:
        part = lm_mesh or {}
        for k in keys:
            part = part.get(k, {})
        measured = part.get("moved")
        if measured is None:
            print(f"  [20] {tag} did not run in this invocation: its bytes "
                  f"are not compared")
            continue
        composed = compose()
        equal = composed == measured
        if not equal:
            problems.append(f"20: {tag}'s moves composed {composed}, "
                            f"measured {measured}")
        out[f"moves_{tag}"] = {"composed": composed, "measured": measured,
                               "equal": equal}
        print(f"  [20] {tag}'s mesh step, [between positions, between "
              f"devices] B: composed {composed}, measured {measured}; "
              f"equal {equal}")
    out["seconds"] = time.perf_counter() - t0
    print(f"  [20] {out['seconds']:.1f} s")
    for p in problems:
        print(f"  FAILED: {p}")
    require(not problems, f"phase 20: {len(problems)} check(s) failed")
    return out


def free_device(torch) -> None:
    """Collect the solvers (their programs close over them) and give the
    cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", action="append", metavar="LABEL=CSRC_DIR",
                    help="time this tree's Krylov kernels beside another "
                         "csrc directory's, in turns (repeatable)")
    ap.add_argument("--step-timing", type=int, metavar="REPEATS",
                    help="time the main path's first step REPEATS times "
                         "(ms per CG iteration) instead of the smoke test")
    ap.add_argument("--profile-cg", type=int, metavar="ITERS",
                    help="profile ITERS iterations of the main path's "
                         "first pressure CG instead of the smoke test")
    ap.add_argument("--serving", action="store_true",
                    help="phases 13 and 14 alone (after phases 1-2), from a "
                         "3-step state of the main path's solver")
    ap.add_argument("--full-mesh", action="store_true",
                    help="phase 15 alone (after phases 1-2; 15f the fused "
                         "full mesh over the card and its host), from a "
                         "3-step state of the main path's solver; with "
                         "--profile-cg, profile the full-mesh CG instead")
    ap.add_argument("--lm", action="store_true",
                    help="phase 16 (LM serving) alone, after phases 1-2")
    ap.add_argument("--train", action="store_true",
                    help="phase 17 (LM training) alone, after phases 1-2")
    ap.add_argument("--lm-mesh", action="store_true",
                    help="phase 18 (the LM side over a device mesh) alone, "
                         "after phases 1-2")
    ap.add_argument("--assembly-mesh", action="store_true",
                    help="phase 19 (the stacked solve over a (solve, "
                         "assemble) mesh) alone, after phases 1-2, from a "
                         "3-step state of the main path's solver")
    ap.add_argument("--dryrun", action="store_true",
                    help="phase 20 (the port's dry-run of every cell) "
                         "alone, after phases 1-2; with --lm-mesh, after "
                         "phase 18, checking 18b's, 18e's, 18g's and 18h's "
                         "bytes too")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not importable", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False — this smoke test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    try:
        import repro_torch.kernels._build  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable beside chip_smoke.py ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        dev = torch.device("cuda")
        smi = smi_line()
        print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
              f"conditional graph nodes (CUDAGraph.begin_capture_to_if_node)"
              f": {hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}")
        print("[2] build")
        alone = any(getattr(args, k) for k in (
            "compare", "step_timing", "profile_cg", "serving", "full_mesh",
            "assembly_mesh", "lm", "train", "lm_mesh", "dryrun"))
        dryrun = None if alone else start_dryrun()
        build_phase()
        if dryrun is not None:
            dryrun.exception()      # finished before phase 3 times anything
        if args.compare:
            others = dict(item.split("=", 1) for item in args.compare)
            result = compare_builds(torch, dev, others)
            print(smi_line())
            print(json.dumps({"compare": result}))
            return 0
        if args.step_timing:
            result = step_timing(torch, args.step_timing)
            print(smi_line())
            print(json.dumps({"step_timing": result}))
            return 0
        if args.profile_cg:
            result = profile_cg(torch, args.profile_cg, args.full_mesh)
            print(smi_line())
            print(json.dumps({"profile_cg": result}))
            return 0
        if args.serving:
            result = serving_phases(torch, dev, main_state(torch))
            print(f"done in {time.perf_counter() - t_start:.1f} s")
            print(smi_line())
            print(json.dumps({"serving": result}, default=str))
            return 0
        if args.full_mesh:
            result = full_mesh_phase(torch, main_state(torch))
            print(f"done in {time.perf_counter() - t_start:.1f} s")
            print(smi_line())
            print(json.dumps({"full_mesh": result}, default=str))
            return 0
        if args.assembly_mesh:
            result = assembly_mesh_phase(torch, main_state(torch))
            print(f"done in {time.perf_counter() - t_start:.1f} s")
            print(smi_line())
            print(ok_line(torch))
            return 0
        if args.lm:
            result = lm_phase(torch, dev)
            print(f"done in {time.perf_counter() - t_start:.1f} s")
            print("lm " + json.dumps(result, default=str))
            print(smi_line())
            print(json.dumps({"lm": result}, default=str))
            return 0
        if args.train:
            result = train_phase(torch, dev)
            print(f"done in {time.perf_counter() - t_start:.1f} s")
            print("train " + json.dumps(result, default=str))
            print(smi_line())
            print(ok_line(torch))
            return 0
        if args.lm_mesh or args.dryrun:
            result = lm_mesh_phase(torch, dev) if args.lm_mesh else None
            ran = dryrun_phase(result) if args.dryrun else None
            print(f"done in {time.perf_counter() - t_start:.1f} s")
            if result is not None:
                print("lm_mesh " + json.dumps(result, default=str))
            if ran is not None:
                print("dryrun " + json.dumps(ran, default=str))
            print(smi_line())
            print(ok_line(torch))
            return 0
        # the seconds of each phase (1-2: the card's query and the build)
        marks = [("build", time.perf_counter())]

        def mark(name):
            marks.append((name, time.perf_counter()))

        print("[3] kernels vs plain versions")
        report = check_kernels(torch, dev)
        mark("3")
        print("[4-6] main path: 210^3 cavity, 30 parts, alpha 30, 3 PISO "
              "steps; determinism; parity (then 7-8)")
        torch.cuda.reset_peak_memory_stats()
        summary, state3, main_step, f32_step = main_path(torch)
        free_device(torch)
        mark("4-8")
        summary["channel"] = channel_phase(torch)
        free_device(torch)
        mark("10")
        summary["simple"] = simple_phase(torch)
        free_device(torch)
        mark("11")
        summary["control"] = control_phase(torch, state3, main_step, report)
        free_device(torch)
        mark("12")
        summary["serving"] = serving_phases(torch, dev, state3)
        free_device(torch)
        mark("13-14")
        summary["full_mesh"] = full_mesh_phase(torch, state3)
        free_device(torch)
        mark("15")
        summary["assembly_mesh"] = assembly_mesh_phase(torch, state3,
                                                       f32_step)
        del state3, main_step, f32_step
        free_device(torch)
        mark("19")
        summary["lm"] = lm_phase(torch, dev)
        free_device(torch)
        mark("16")
        summary["train"] = train_phase(torch, dev)
        free_device(torch)
        mark("17")
        summary["lm_mesh"] = lm_mesh_phase(torch, dev)
        free_device(torch)
        mark("18")
        summary["dryrun"] = dryrun_phase(summary["lm_mesh"], dryrun)
        mark("20")
        summary["phase_s"] = {"1-2": marks[0][1] - t_start, **{
            name: t - marks[i][1]
            for i, (name, t) in enumerate(marks[1:])}}
        print("seconds by phase: " + ", ".join(
            f"{k} {v:.1f}" for k, v in summary["phase_s"].items()))
        print(f"done in {time.perf_counter() - t_start:.1f} s")
        print("lm " + json.dumps(summary["lm"], default=str))
        print("train " + json.dumps(summary["train"], default=str))
        print("lm_mesh " + json.dumps(summary["lm_mesh"], default=str))
        print("dryrun " + json.dumps(summary["dryrun"], default=str))
        summary["momentum_shape_times"] = {
            name: report[name]["momentum"] for name in report
            if "momentum" in report[name]}
        summary["low_precision_times"] = {
            name: {d: report[name][d] for d in ("float32", "bfloat16")
                   if d in report[name]}
            for name in report if "float32" in report[name]}
        print("summary " + json.dumps(summary, default=str))
        # launches: the main path's counts; the momentum-assembly kernel's
        # from the refactoring baseline's run (phase 8)
        launches = dict(summary["launches"],
                        momentum_bands=summary["baseline"]["launches"][
                            "momentum_bands"])
        kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name],
                    **{k: report[name][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")},
                    # the axpy kernel alone: raw launches, no wrapper
                    **{k: report[name][k] for k in ("kernel_alone_ms",)
                       if k in report[name]}}
                   for name in report]
        print(json.dumps({"kernels": kernels}))
        print(smi_line())
    except Exception:  # noqa: BLE001 — the smoke test's boundary: report, fail
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1
    print(ok_line(torch))
    return 0


def ok_line(torch) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
