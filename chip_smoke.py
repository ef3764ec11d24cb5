#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --partitioned-call [SRC]   # one timing: see partitioned_call

Phases, each of which raises on a failed check:

1. card: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (one nvcc per
   source, all started together) and print what ptxas reports (registers,
   shared memory, spills);
2. kernels: each kernel against its plain PyTorch version on the card,
   at rtol = atol = 2e-4: potrf (a batch, one tile, in place) and trsm
   (one L, one L a tile, each also in place) for t in {8, 16, 32, 64}; the
   band-Cholesky sweep for bt in {0, 1, 3}, nat in {0, 1, 3}, start_tile
   in {0, 2}, nchunks in {1, 3}, at clusters of at most 1, 2, 4, 8 and 16
   blocks, every cap bit for bit the same, plus a breakdown input whose
   status word must match exactly at every cap; solve_panel for both trans
   and k in {1, 7, 8, 9, 32, 33, 64} at every chunk width (1, 2, 4 or 8
   columns a block), every chunk and a second launch bit for bit the same;
   both band-solve sweeps on (ndt, bt, nat) in {(1,0,0), (5,1,0),
   (6,2,2), (9,4,1)}, k in {1, 33}, start_tile in {0, 2}, at clusters of
   at most 1, 2, 4, 8 and 16 blocks, every cap bit for bit the same and as a
   second launch; the selinv
   pre-pass and sweep for t in {16, 64}, bt in {0, 1, 4}, nat in {0, 1,
   4}, start_tile in {0, 2}, plus one column and fewer columns than band
   tiles, the recurrence in clusters of the default size (16), 4 and 8; gemm,
   syrk and geadd with batched, broadcast,
   in-place and strided operands (geadd bit for bit the plain version, its
   programmatic dependent launch on and off), gemm and syrk also at every split (1, 4,
   16 or 64 blocks a tile), every split bit for bit the same; the partitioned sweep for P in {1, 2,
   4, 7} with bt = 0, nat = 0 and ragged last partitions, also bit for
   bit against the fused kernel, at every cluster cap; band_update for b+1 in {1, 2, 3, 5, 6,
   9} against both plain versions, also on a strided batch of windows;
   selinv_step for (e_n, j_n) in {(1, 1), (1, 2), (4, 3), (3, 5), (8, 8),
   (2, 17), (1, 17)} and the empty shapes; trsm with one L a group of
   tiles, also in place; the fused and partitioned sweeps on a batch of three, each
   element also bit for bit against its unbatched launch; the θ-batch
   read-out's kernel forms on batches of 1 and 3, one launch each, each
   element bit for bit its unbatched launch: solve_panel with one L a panel
   (every t and k above, both directions), both band-solve sweeps on the
   shapes above at every cluster cap (the unbatched launch at the batch's
   chunk width), the selinv pre-pass and recurrence on the shapes above
   (default cluster, 4 and 8);
3. main paths at full size, each with the launch counts set to 0 just
   before it and read just after (a count is of launches on the card: the
   wrapper's count of its calls, less the calls a capture of the task list
   or of the solves' corner recorded into its graph, plus the launches its
   replays made):
   - Table II matrices 5 (n=10,200, bandwidth 200, arrow 200) and 2
     (n=10,010, bandwidth 200, arrow 10), seed 0, t=64:
     measure_arrowhead -> TileGrid -> BandedCTSF.from_sparse ->
     factorize_window -> logdet, then solve (k=1), solve_many (k=32),
     sample_gmrf_many (32 draws), selected_inverse and marginal_variances
     with both methods, each with its launch counts and checked on the
     card against float64 oracles (factor residual, logdet, solve residual
     and forward error, L^T x = z, every stored entry of Σ, the variances);
     a path a matrix; the solves' corner runs from CUDA graphs: the first
     pass captures one a (k, direction) key, then (not counted in the path)
     a second pass and a θ step 1.5 A + 0.25 I of the same grid pass every
     solve gate again with one call's launches and capture nothing, and
     the graphs' solves match the eager corner bit for bit or within rtol =
     atol = 2e-4;
   - the same two matrices through TileMatrix.from_sparse ->
     factorize_tasklist, tree reduction off and on (8 workers), whose first
     call warms up one launch of each tile kernel (and one tree update),
     captures the pattern's CUDA graph and replays it: launch counts
     derived from the symbolic task list and the warm-up, one capture,
     factor residual,
     agreement with the window factor, logdet from the tiles; then (not
     counted in the path) a second call, a call with impl="cuda" and a new
     TileMatrix of the same pattern (τ A + δ I) replay it with no capture
     (one call's launches each), the later calls bit for bit the first, the θ step's factor its
     own (residual against its matrix), and both bit for bit the eager
     loop's with the tree off (tree on: equal or rtol = atol = 2e-4);
   - Table II matrices 4 (n=10,200, bandwidth 100, arrow 200) and 1
     (n=10,010, bandwidth 100, arrow 10), block-diagonal, with the plan
     detect_partition_plan finds (7 partitions): the partitioned sweep bit
     for bit against the fused kernel at every cluster cap, then
     factorize_window with the plan
     (one partitioned launch, a geadd per tree level, the corner against
     the fused route's, factor residual, logdet);
   - the window route, factorize_window(sweep="window"), on matrices 5
     and 2: launch counts (a band_update, a potrf and two trsm a column,
     the corner's, three geadd), factor residual, logdet, agreement with
     the fused route's factor;
   - factorize_window_batched on 8 θ-candidates A_θ = τ A + δ I of
     matrix 5 (fused and window routes) and of matrix 4 (partitioned
     route): one sweep launch for the batch (the window route one
     band_update a column), each element against its unbatched call (the
     sweep bit for bit on the fused and partitioned routes) and its logdet
     against the candidate's float64 oracle; then the batched kernels
     against their plain versions on those batches: both sweeps,
     band_update on the window route's strided windows (each element also
     bit for bit against its unbatched launch), and the grouped trsm of a
     window panel and of the corner;
   - ops.selinv_step on the Takahashi operands of an interior column of
     matrix 5's selected inverse, against that column's Σ tiles;
   - "θ-batch solves and selected inverse, matrix 5": solve_many_batched
     at k = 1 and 32 on seeded panels and selinv_batched on the fused
     batched factor of matrix 5's 8 θ-candidates, each the launches of one
     call (forward 1, backward 1, solve_panel 2·nat; pre-pass 1, recurrence
     1); each element against the unbatched call on it, bit for bit where
     the band sweeps' chunk width (solves) or the corner seed (selinv) is
     the unbatched call's, else within rtol = atol = 2e-4 (a failed
     bit-identity fails the run after the timings); the float64 gates on
     elements 0 and 7 (solve residual and forward error, Σ error);
   - "breakdown recovery, matrix 5": the same θ-batch with element 2
     indefinite (a band diagonal tile dropped by 10 x its mean |diagonal|)
     and element 5 given a NaN: factorize_window_batched with
     regularize=True (statuses, tau, first bad tile, the healthy elements
     bit for bit the unregularized call, element 2's residual against its
     jittered matrix), solve_many_batched at k = 32 on it (one refinement
     pass; clean elements bit for bit an unrefined call's, element 2's
     residual per column at most the unrefined one's) and solve_many with
     a hand-built FactorInfo on matrix 5 (tau = 1e-2 diag_scale), the same
     column rule;
   - python -m repro_torch.quickstart's main, its task-list agreement;
   - "bucketing" (canonical-grid bucketing, GridBucketPolicy(), t = 64):
     matrix 5 embedded on its (256, 4, 4) rung, prefix 99:
     factorize_window -> logdet -> solve -> solve_many (k = 32) ->
     sample_gmrf_many (32 draws) -> selected_inverse -> marginal_variances
     (both methods), each with the plain path's launches and held in the
     source layout to the same call on the plain factor (rtol = atol =
     2e-4, logdet 1e-5 relative; the draws bit for bit or within 2e-4,
     recorded); matrix 4's partitioned route with its plan shifted past the
     prefix and matrix 5's window route, each restricted factor against its
     plain route's; a mixed stream (make_arrowhead at n = 10,200, 9,000 and
     8,456 with #5's bandwidth and arrow, all on one rung), each a θ-batch
     of 8 through factorize_window_batched(policy), solve_many_batched (k =
     32) and selinv_batched: one entry a cache (batched_window,
     batched_solve, batched_selinv) over the stream, the corner's graphs
     (cleared first) captured for the first grid only, each element against
     the unbucketed calls; stack_ctsf([#5, #4, #2], policy) through the
     concurrent entry points, one launch a sweep for the three, each
     element restricted against its own plain factor and read-out; a
     θ-batch of 5 with bucket=True: one sweep launch of 8, bit for bit
     bucket=False (factor, k = 32 solves, Σ; a failure is reported after
     the timings), and solves of 5, 6, 7 and 8 capturing the corner's
     graphs once;
   - "distributed, block-diagonal n = 13,000": make_arrowhead(13,000, 100,
     200, rho = 0, seed 0), Table II #4's shape at a size whose 200
     diagonal tiles split into 8 partitions of 25 (detect_partition_plan
     must find them), partition_banded(m, 8); world 1 in this process, an
     NCCL group of one on make_local_mesh(1, 1): distributed_factorize
     (counted: one sweep for the 8 partitions, nat potrf and trsm, no
     geadd) and assemble_factor, its panels and arrow rows bit for bit the
     partitioned route's and the fused route's, the coupling tiles exact
     zeros, the corner within 1e-4 of max|C|, residual and logdet, an NCCL
     all-reduce of one rank; then (process groups destroyed) worlds of 2
     and 4 gloo ranks sharing the card (launch/mesh.py::run_local, the
     ranks load the kernels built here): a sweep and log2(world) geadd a
     rank, the corner the same bits on every rank, panels bit for bit
     world 1's; the sharded concurrent calls on the data axis, #5's θ-batch
     of 8: one sweep launch a rank, each element's panels and R bit for bit
     factorize_window_batched's (corner within 1e-5), the logdets the same
     on every rank and within 1e-4 of float64 oracles, concurrent_selinv's
     Σ bit for bit selinv_batched's (or within 2e-4), and at world 4 the
     faulted θ-batch's FactorInfo (regularize=True) the unsharded call's on
     every rank;
   - "telemetry" (runtime/telemetry.py): with telemetry enabled, #5's main
     path, the faulted θ-batch and the mixed stream: every span, counter
     and label one the reference's code emits for those calls (the span
     tree of the main path exactly; the ladder's counters its attempts
     and outcomes; one rung hit and one cache hit a call in the stream),
     the results bit for bit the disabled calls'; kernel_report(
     factorize_window) on #5 equal to the device counts; the solves'
     corner graphs captured with telemetry enabled; the disabled surface
     of one request, times 3, under 5 % of a cached solve_many (k = 32)
     call, and the enabled call beside the disabled one, in turns;
   - "serving" (launch/rung_server.py): an INLA service, models
     make_arrowhead(n, 200, arrow, rho = 0.7, seed 0) at (n, arrow) in
     {(10,200, 200), (9,000, 200), (8,456, 200)} (the (256, 4, 4) rung) and
     {(10,010, 10), (8,500, 10)} (the (256, 4, 1) rung), t = 64, each request
     a θ step τ A + δ I of one model with its own k = 32 panel;
     request_stream(7, ..., 48, rate 4,000) into RungServer(max_batch 4,
     max_delay 2e-3) on a SimClock, replayed cold (counted; the corner's
     graphs cleared first) and warm: every future OK, full and deadline
     flushes, history and every x bit for bit across the passes, at most
     one batched_window and batched_solve entry a rung, the corner captured
     once a (nat, direction, padded batch) in the cold pass and never in the
     warm one, each batch the launches of one factorize_window_batched and
     one solve_many_batched call; each request against factorize_window
     (regularize) + solve_many on its source grid (x within 2e-4 of max|x|,
     logdet 1e-5, every sixth request's float64 residual ≤ 1e-4); a chaos
     pass of 16 requests, twice (one indefinite: RECOVERED, tau > 0, its
     factor's residual against A + tau I ≤ 1e-4; one poisoned by a
     DispatchFaultInjector: FAILED "dispatch_failed"; the others OK or
     RECOVERED; events, history and x equal across the passes, every future
     resolved once); a threaded pass on the wall clock (start(), the
     corner's graphs cleared, 4 client threads building their requests on
     the card and submitting while the pump captures, stop(): every future
     OK within 2e-4 of the replay); telemetry enabled over the warm stream
     (every serving span, counter, gauge and histogram the reference's
     server emits for it; the results bit for bit the disabled pass's);
   - "lm" (the LM substrate): lm-100m (examples/train_lm.py's model: 12
     layers, d_model 768, 12 heads, 4 KV heads, d_ff 2048, vocab 8192,
     qk_norm) at full width and depth on MarkovStream(8192, seed 0), batch
     8 x 256, bf16, RunConfig as train() builds it, through launch/train.py
     (init_state, build_precond + attach_precond, make_train_step): 30
     steps of AdamW, then 30 of the arrowhead optimizer (r = 32, band 2, a
     refresh every 10 steps) from the same initialisation; finite losses,
     the mean of the last 5 below the first 5's; each arrowhead step's
     launches (band forward 1, backward 1, solve_panel 2; a refresh step
     also the fused sweep, potrf and trsm 1 each); at steps 10 and 20 the
     damped matrix A in float64: factor residual <= 1e-4, A^-1 g (the
     sketch's solve) against a float64 dense solve <= 2e-3; with damping 1
     on a fresh state precondition is the identity (1e-6); step times
     (CUDA events), tokens a second, peak memory, the arrowhead's device
     time apart (sketch + update_stats, factorize, precondition: CUDA
     graphs) beside its host time, its six kernels at its shapes against
     their plain versions, three quiet steps (host enqueue against wall,
     a profiler's kernel sum), and the two optimizers' steps in turns (A, B,
     B, A, five rounds); qwen2-7b at its published widths with
     n_layers cut to 2 (1.56 B parameters; the grid clips the band to bt =
     ndt - 1 = 1), batch 2 x 256 of token_batch, 2 steps of each optimizer:
     finite losses, the same launches, peak memory; the dense LM server on
     lm-100m (batch 4, prompt 64, 32 generated) at float32, each decode
     step's logits against a full forward (<= 1e-3 of max|logit|, the same
     argmax where the top-2 margin exceeds that), then bf16: prefill ms and
     decode tokens a second; the INLA twin's main (the objective
     non-increasing, finite posterior summaries) and the distributed twin
     at world 1 over NCCL (its factor within 1e-4 of factorize_window's);
4. timings at the main paths' shapes: each kernel, its plain version and
   a one-call PyTorch yardstick where there is one (device time, for all
   three alike, from CUDA events around a CUDA graph of the calls; call
   time from CUDA events around the calls themselves), beside the
   kernel's bound; the band-Cholesky sweep on matrices 5 and 2 at every
   cluster cap (each against the plain version and bit for bit against
   clusters of 1, two launches bit for bit, how many clusters of that size
   the card holds at once), the partitioned sweep on matrix 4 at every
   cap, and beside the fused kernel on the same matrix and on its widest
   partition alone; where the factorization sweep's cycles go on ranks 0
   and 1 of its cluster, from a phase-marked build of its kernel;
   factorize_window, solve_many, selected_inverse and
   marginal_variances end to end; factorize_tasklist: the first call
   (capture included) and the memory its graph keeps, the call time against
   its kernels' device time and the graph's replay alone, a θ step of the
   same pattern, and the eager loop's call and device time; gemm and syrk
   at every split on the main path's task and on a batch of five tasks,
   beside torch.baddbmm; the one-call yardsticks of the band-Cholesky
   sweeps (torch.linalg.cholesky_ex on the band block) and of the selinv
   sweep (torch.cholesky_inverse of the dense factor); the partitioned
   factorize_window end to end; the
   window route end to end beside the fused route; the batched routes
   end to end against one candidate alone, and the batched sweep and
   band_update kernels against one element's launch (the sweeps also at
   clusters of 4, 8 and 16 beside how many the card holds at once;
   band_update beside one einsum over the batch's gathered operands); for
   the
   tile-sum kernels band_update and selinv_step, their launch plans, two
   launches on the main path's operands bit for bit, and the plans of
   cluster caps 1 (no contraction split), 2, 4 and 8 timed side by side;
   the band-solve sweeps on matrices 5 and 2 at k = 1 and 32 and every
   cluster cap (each against the plain version, bit for bit against
   clusters of 1) beside the plain version, and on matrix 5 beside their
   one-call yardstick, torch.linalg.solve_triangular on the band block
   assembled as one dense lower-triangular matrix beforehand (the backward
   call's Y - R^T Xa formed beforehand too);
   the selinv sweep on matrices 5 and 2 beside its plain version, its
   pre-pass and recurrence apart, the recurrence at clusters of 4, 8 and
   16, two launches bit for bit; potrf on the θ-batch's 8 corner tiles in
   one launch beside cholesky_ex; solve_panel on matrix 5's corner tile at
   k = 1 and 32, both directions, beside torch.linalg.solve_triangular on
   the same panel, and at k = 32, 256 and 1024 at every chunk width; geadd on the tree's
   first level and on matrix 4's partitioned leaves beside an empty kernel
   on its grid, and the tree's three levels as one chain, each with the
   programmatic launch on and off (the CUDA runtime's and driver's
   versions beside); solve_many (k = 1 and 32) and sample_gmrf_many on
   matrices 5 and 2, call time against device time with the corner's graph
   and eagerly, split into the two sweeps, the corner and the host; the
   θ-batch's read-out kernels on its own inputs (one launch for 8 against
   one element's and eight launches, each element bit for bit its launch
   alone), solve_many_batched (k = 1 and 32) and selinv_batched call and
   device time against one candidate's call and a loop of 8; and
   factorize_window_batched with regularize=True against the call without
   it on the clean θ-batch, in turns (at most 1.25 times); bucketing on
   matrix 5, canonical grid against source grid (call and device time,
   medians of 7): factorize_window + logdet, the sweep alone (and the
   canonical sweep with no prefix skipped), solve_many (k = 32),
   selected_inverse; the stream's padded flop overheads; a batch of 5 run
   as 8 against unpadded; world 1's distributed_factorize + logdet beside
   the partitioned and fused routes on the n = 13,000 matrix (call and
   device time), and the batched sweep of its 8 partitions beside the
   partitioned and fused kernels (gloo worlds sharing a card are checked,
   not timed: they say nothing of scaling); the serving path's warm pass:
   requests a second, wall p50/p99, each batch's span on the executor's
   stream (CUDA events) and host time in dispatch and finalize, each batch
   shape's device time from a CUDA graph and their sum against the pass's
   wall time, the same 48 requests as a sequential loop of
   factorize_window(regularize) + solve_many, the bytes a batch of 4's
   results keep on the card.

The second-to-last lines are the kernel JSON line and the card line; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero with no
result where there is no CUDA device or no checkout around the script.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet): fp32 without tensor cores,
# and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TOL = 2e-4          # rtol = atol, the tolerance of the repo's kernel tests
TILES = (8, 16, 32, 64)
TABLE2_IDS = (5, 2)
# limits of the main path's checks (PERF.md section 2): the factor's and
# the solves' relative residuals, the solve's forward error against
# float64 (test_solve_batched.py's rtol), Σ's error on its stored pattern
# relative to max|Σ|, and the variances' relative error (test_selinv.py)
RESIDUAL_LIMIT = 1e-4
SOLVE_RTOL = 2e-3
SIGMA_LIMIT = 1e-4
VARIANCE_RTOL = 1e-4
# the task list's factor against the window factor, relative to max|L|: the
# reference's backend agreement atol (tests/test_cholesky.py:57)
AGREEMENT_LIMIT = 5e-4
# the task list on TABLE2_IDS; the partitioned route on the block-diagonal
# matrices 4 (n=10,200, bandwidth 100, arrow 200) and 1 (n=10,010,
# bandwidth 100, arrow 10)
PARTITIONED_IDS = (4, 1)
SOLVE_SWEEPS = ((1, 0, 0), (5, 1, 0), (6, 2, 2), (9, 4, 1))   # (ndt, bt, nat)
# solve_panel's widths: one column, ragged chunks of every width, float4
# and scalar loads
PANEL_KS = (1, 7, 8, 9, 32, 33, 64)
# solve_panel's wide timings: the default chunk is 2 columns at 256, 8 at 1024
PANEL_WIDE_KS = (256, 1024)
# (ndt, bt, nat) of the selinv sweep's checks beside its ndt = 6 grid: one
# column, and fewer columns than band tiles
SELINV_EDGES = ((1, 4, 4), (1, 0, 0), (3, 4, 1), (2, 4, 0))
# θ-candidates of the batched factorization (factorize_window_batched)
BATCH = 8
# the batch sizes of the batched read-out kernels' checks (phase 2)
READ_BATCHES = (1, 3)
# the θ-batch's faults (breakdown recovery): an indefinite element and a NaN one
INDEFINITE, NAN_ELEMENT = 2, 5
# regularize=True on a clean θ-batch: its call against the call without it
CLEAN_OVERHEAD_LIMIT = 1.25
# canonical-grid bucketing: a logdet across the embedding against the plain
# path's, relative; the mixed stream's sizes, make_arrowhead with #5's
# bandwidth and arrow (ndt 157, 138 and 129: all on the (256, 4, 4) rung)
LOGDET_RTOL = 1e-5
STREAM_NS = (10200, 9000, 8456)
# (τ, δ) of the task list's second matrix of one pattern, τ A + δ I
THETA_STEP = (1.5, 0.25)
# the distributed path's matrix: Table II #4's shape (bandwidth 100, arrow
# 200, rho = 0, seed 0) at n = 12,800 + 200, whose 200 diagonal tiles split
# into 8 partitions of 25 (#4 itself has 157, a prime, and cannot be split)
DIST_N, DIST_PARTS = 13000, 8
# the worlds that share the one card over gloo (NCCL refuses two ranks on
# one device), each a spawned process a rank
GLOO_WORLDS = (2, 4)
# the disabled telemetry surface of one request, times 3, against a cached
# solve_many (k = 32) call: the reference's gate (tests/test_telemetry.py)
TELEMETRY_OVERHEAD_LIMIT = 0.05
# the serving path: an INLA service fitting a few models to datasets of
# several sizes, each request one θ candidate of one model with its own
# panel; (n, bandwidth, arrow) at t = 64: three on the (256, 4, 4) rung, two
# on (256, 4, 1)
SERVING_CASES = ((10200, 200, 200), (9000, 200, 200), (8456, 200, 200), (10010, 200, 10),
                 (8500, 200, 10))
SERVING_REQUESTS, SERVING_RATE, SERVING_K = 48, 4000.0, 32
SERVING_BATCH, SERVING_DELAY = 4, 2e-3
# a request's x against the sequential oracle (and the threaded pass's
# against the replay's), relative to max|x|
SERVING_X_RTOL = 2e-4
# the chaos pass: its requests, the one made indefinite, the one poisoned
CHAOS_REQUESTS, CHAOS_INDEFINITE, CHAOS_POISON = 16, 2, 5
SERVING_CLIENTS = 4
# the band-Cholesky sweep's cluster caps (kernels/band_cholesky.py::sweep_plan)
SWEEP_CLUSTERS = (1, 2, 4, 8, 16)
# the fused sweep's times before this cluster design (one block a matrix),
# for the kernel line: where they were measured
SWEEP_FIRST_DESIGN = ("one block a matrix; its times are PERF.md section 6's 'first design' "
                      "(chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W)")
SOLVE_FIRST_DESIGN = ("one block a 32-column chunk walking every row, all its products and a "
                      "one-warp substitution on the chain; its times are PERF.md section 6's "
                      "'first design' (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W)")
GEMM_FIRST_DESIGN = ("one block of 256 threads a tile, A and B staged through registers into "
                     "transposed shared memory; its time is PERF.md section 6's 'first design' "
                     "(chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W)")
PANEL_FIRST_DESIGN = ("a block of 64 threads a panel and 64 columns, a thread walking one "
                      "column through every row in registers; its time is PERF.md section 6's "
                      "'first design'")
TRSM_FIRST_DESIGN = ("a warp per 8 rows through a T-step shuffle loop; its time is PERF.md "
                     "section 6's 'first design' (chip_smoke.py on an NVIDIA H100 80GB HBM3, "
                     "700 W)")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def random_band_arrow(torch, ndt, bt, nat, t, seed, device, bad_tile=None, bounds=None):
    """Column-band tiles Ac (ndt, bt+1, t, t) and arrow rows R (ndt, nat, t,
    t) of a random diagonally dominant (so SPD) banded-arrowhead matrix;
    with ``bad_tile`` one diagonal entry of that band tile is negative; with
    ``bounds`` (partition boundaries) the band tiles across the cuts are
    zero, so the band is block-separable."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = (ndt + nat) * t
    tile = np.arange(n) // t
    ti, tj = tile[:, None], tile[None, :]
    part = np.searchsorted(np.asarray(bounds if bounds else (0, ndt)),
                           np.minimum(tile, ndt - 1), side="right")
    same = part[:, None] == part[None, :]
    mask = (((ti < ndt) & (tj < ndt) & (np.abs(ti - tj) <= bt) & same)
            | (ti >= ndt) | (tj >= ndt))
    a = np.where(mask, rng.standard_normal((n, n)), 0.0)
    a = np.tril(a) + np.tril(a, -1).T
    a[np.diag_indices(n)] = np.abs(a).sum(axis=1) + 1.0
    if bad_tile is not None:
        i = bad_tile * t + t // 2
        a[i, i] = -a[i, i]
    Ac = np.zeros((ndt, bt + 1, t, t), np.float32)
    R = np.zeros((ndt, nat, t, t), np.float32)
    for k in range(ndt):
        for e in range(bt + 1):
            if k + e < ndt:
                Ac[k, e] = a[(k + e) * t:(k + e + 1) * t, k * t:(k + 1) * t]
        for i in range(nat):
            R[k, i] = a[(ndt + i) * t:(ndt + i + 1) * t, k * t:(k + 1) * t]
    return (torch.from_numpy(Ac).to(device), torch.from_numpy(R).to(device))


def random_lower(torch, nb, t, seed, device):
    """Well-conditioned lower-triangular (nb, t, t) tiles."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = np.tril(rng.standard_normal((nb, t, t))) + t * np.eye(t)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def random_band_factor(torch, ndt, bt, nat, t, seed, device):
    """Row-band factor tiles Dr (ndt, bt+1, t, t), zero above the band,
    and arrow rows R (ndt, nat, t, t), as the repo's kernel tests make."""
    import numpy as np
    rng = np.random.default_rng(seed)
    Dr = rng.standard_normal((ndt, bt + 1, t, t)).astype(np.float32)
    Dr[:, 0] = random_lower(torch, ndt, t, seed + 1, "cpu").numpy()
    for m in range(ndt):
        Dr[m, min(m, bt) + 1:] = 0.0
    R = rng.standard_normal((ndt, nat, t, t)).astype(np.float32)
    return torch.from_numpy(Dr).to(device), torch.from_numpy(R).to(device)


def selinv_inputs(torch, ndt, bt, nat, t, seed, device):
    """A real factor's column view (ndt, bt+1, t, t), arrow rows and full
    corner Σ, from the float64 Cholesky factor of a random diagonally
    dominant banded-arrowhead matrix scaled to a unit mean diagonal."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = (ndt + nat) * t
    tile = np.arange(n) // t
    ti, tj = tile[:, None], tile[None, :]
    mask = ((ti < ndt) & (tj < ndt) & (np.abs(ti - tj) <= bt)) | (ti >= ndt) | (tj >= ndt)
    a = np.where(mask, rng.standard_normal((n, n)), 0.0)
    a = np.tril(a) + np.tril(a, -1).T
    a[np.diag_indices(n)] = np.abs(a).sum(axis=1) + 1.0
    L = np.linalg.cholesky(a / a.diagonal().mean())
    tl = lambda i, j: L[i * t:(i + 1) * t, j * t:(j + 1) * t]
    lcol = np.zeros((ndt, bt + 1, t, t))
    R = np.zeros((ndt, nat, t, t))
    for j in range(ndt):
        for d in range(bt + 1):
            if j + d < ndt:
                lcol[j, d] = tl(j + d, j)
        for i in range(nat):
            R[j, i] = tl(ndt + i, j)
    w = np.linalg.inv(L[ndt * t:, ndt * t:])
    sc = (w.T @ w).reshape(nat, t, nat, t).transpose(0, 2, 1, 3)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
                 for x in (lcol, R, sc))


def random_spd(torch, nb, t, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((nb, t, t), generator=g, dtype=torch.float64)
    return (x @ x.mT + t * torch.eye(t, dtype=torch.float64)).float().to(device)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def assert_close(torch, got, want, what, tol=TOL):
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.allclose(got, want, rtol=tol, atol=tol, equal_nan=True):
        err = (got - want).abs().nan_to_num(float("inf")).max().item()
        raise AssertionError(f"{what}: max abs err {err:.3e} over rtol=atol={tol}")
    diff = (got - want).abs()
    return diff[torch.isfinite(diff)].max().item() if diff.numel() else 0.0


def assert_update(got, want, scale, what):
    """``got`` against ``want`` relative to ``scale``, the size of what the
    kernel adds to its input (max|A B^T| of an update, the smaller operand's
    max of a sum), so a kernel that drops that part fails however small it
    is beside the rest; returns the relative error."""
    if not scale > 0:
        raise AssertionError(f"{what}: the kernel's own part is zero, the check would be vacuous")
    err = (got - want).abs().max().item() / scale
    if not err <= TOL:
        raise AssertionError(f"{what}: error {err:.3e} of the kernel's own part (limit {TOL})")
    return err


def largest_band_tasks(torch, tm, L, task_type, n=1):
    """The ``n`` GEMM or SYRK tasks of ``tm``'s task list in the band (every
    index below ndt) whose products ``L[row, n] L[k, n]^T`` are largest,
    largest first, from the factor's tile buffer ``L``: many band tiles of a
    Table II factor are zero or tiny, and a kernel's check on those could
    not tell a skipped product."""
    from repro_torch.core import TaskType
    ndt = tm.grid.n_diag_tiles
    row = (lambda x: x.m) if task_type == TaskType.GEMM else (lambda x: x.k)
    tasks = [x for x in tm.symbolic.tasks if x.type == task_type and row(x) < ndt]
    prods = torch.einsum("nab,ncb->nac", L[[tm.slot[(row(x), x.n)] for x in tasks]],
                         L[[tm.slot[(x.k, x.n)] for x in tasks]])
    order = torch.argsort(prods.abs().amax(dim=(1, 2)), descending=True, stable=True)
    return [tasks[int(i)] for i in order[:n]]


def largest_band_task(torch, tm, L, task_type):
    """The band task of :func:`largest_band_tasks` with the largest product."""
    return largest_band_tasks(torch, tm, L, task_type)[0]


def first_tree_operands(torch, tm, L, workers):
    """geadd's operands at the first level of the task list's first tree
    (the first accumulation chain on which ``should_use_tree`` holds, with
    ``workers`` workers), from the factor's tile buffer ``L``: the even and
    odd chunk partials, strided halves of a (workers, t, t) stack; and the
    tile (row, k) the chain updates."""
    from repro_torch.core import TaskType, should_use_tree
    chains = {}
    for task in tm.symbolic.tasks:
        if task.type in (TaskType.SYRK, TaskType.GEMM):
            row = task.k if task.type == TaskType.SYRK else task.m
            chains.setdefault((task.k, row), []).append(task.n)
    k, row, ns = next((k, row, ns) for (k, row), ns in chains.items()
                      if should_use_tree(len(ns), workers))
    t = tm.grid.t
    terms = torch.einsum("nab,ncb->nac", L[[tm.slot[(row, n)] for n in ns]],
                         L[[tm.slot[(k, n)] for n in ns]])
    terms = torch.cat([terms, terms.new_zeros(((-len(ns)) % workers, t, t))])
    partials = terms.reshape((workers, -1, t, t)).sum(dim=1)
    half = 2 * (workers // 2)
    return partials[0:half:2], partials[1:half:2], (row, k)


def check_status(got, want, what):
    g, w = got.tolist(), want.tolist()
    if g[1] != w[1] or g[2] != w[2]:
        raise AssertionError(f"{what}: status {g} != plain {w} (nonfinite, first_bad)")
    if not (g[0] == w[0] or abs(g[0] - w[0]) <= TOL * abs(w[0]) + 1e-6):
        raise AssertionError(f"{what}: min_pivot {g[0]} != plain {w[0]}")


def phase_kernels(torch, device, kern, ref):
    """Every kernel in ``kern`` (name -> wrapper) against its plain version."""
    nchecks = 0
    for t in TILES:
        a = random_spd(torch, 3, t, t, device)
        assert_close(torch, kern["potrf"](a), ref.potrf_ref(a), f"potrf t={t}")
        assert_close(torch, kern["potrf"](a[1]), ref.potrf_ref(a[1]), f"potrf t={t} one tile")
        inplace = a.clone()
        kern["potrf"](inplace, out=inplace)
        assert_close(torch, inplace, ref.potrf_ref(a), f"potrf t={t} in place")
        l = ref.potrf_ref(a)
        b = torch.randn((3, t, t), generator=torch.Generator().manual_seed(t)).to(device)
        for lk, mode in ((l[0], "one L"), (l, "one L a tile")):
            want = ref.trsm_ref(lk, b)
            assert_close(torch, kern["trsm"](lk, b), want, f"trsm t={t} {mode}")
            inplace = b.clone()
            kern["trsm"](lk, inplace, out=inplace)
            assert_close(torch, inplace, want, f"trsm t={t} {mode} in place")
        nchecks += 5
        for bt in (0, 1, 3):
            for nat in (0, 1, 3):
                ndt = 5
                Ac, R = random_band_arrow(torch, ndt, bt, nat, t, seed=100 * t + 10 * bt + nat,
                                          device=device)
                for start in (0, 2):
                    for nch in (1, 3):
                        what = f"sweep t={t} bt={bt} nat={nat} start={start} nchunks={nch}"
                        want = ref.band_cholesky_sweep_ref(Ac, R, nchunks=nch, start_tile=start)
                        # every cluster cap, each against the plain version
                        # and bit for bit against the first
                        first = None
                        for cap in SWEEP_CLUSTERS:
                            got = kern["band_cholesky_sweep"](Ac, R, nchunks=nch,
                                                              start_tile=start, max_cluster=cap)
                            for g, w, part in zip(got[:3], want[:3], ("panels", "R_out", "schur")):
                                assert_close(torch, g, w, f"{what} clusters of {cap} {part}")
                            check_status(got[3], want[3], f"{what} clusters of {cap}")
                            if first is None:
                                first = got
                            if not all(torch.equal(g, f) for g, f in zip(got, first)):
                                raise AssertionError(f"{what}: clusters of {cap} not "
                                                     "bit-identical to clusters of 1")
                            nchecks += 1
        # breakdown: a negative diagonal entry in band tile 2
        Ac, R = random_band_arrow(torch, 5, 1, 1, t, seed=7, device=device, bad_tile=2)
        want = ref.band_cholesky_sweep_ref(Ac, R, nchunks=3)
        if want[3][2].item() != 2.0 or want[3][1].item() != 1.0:
            raise AssertionError(f"breakdown t={t}: plain status {want[3].tolist()} does "
                                 "not flag tile 2")
        for cap in SWEEP_CLUSTERS:
            got = kern["band_cholesky_sweep"](Ac, R, nchunks=3, max_cluster=cap)
            check_status(got[3], want[3], f"breakdown t={t} clusters of {cap}")
            assert_close(torch, got[0][:2], want[0][:2],
                         f"breakdown t={t} clusters of {cap} clean panels")
            nchecks += 1
    return nchecks


# (ndt, bt, nat, boundaries) of the partitioned sweep's checks: P = 1, 2,
# 4 and 7, with bt = 0, nat = 0 and ragged last partitions
PARTITIONED_CASES = ((6, 2, 1, (0, 6)), (8, 0, 2, (0, 4, 8)), (9, 2, 0, (0, 3, 5, 7, 9)),
                     (15, 3, 2, (0, 2, 4, 6, 8, 10, 12, 15)), (10, 1, 3, (0, 3, 6, 9, 10)))


def check_gemm_splits(torch, t, kern, ref, x):
    """gemm and syrk at every split of ``GEMM_SPLITS[t]`` (blocks a tile):
    batched, A or B one tile broadcast, one tile, each also in place, each
    against its plain version and bit for bit against the first split;
    returns the number of comparisons."""
    from repro_torch.kernels.gemm import GEMM_SPLITS
    c, a, b = x(5, t, t), x(5, t, t), x(5, t, t)
    cases = (("gemm batched", "gemm", (c, a, b)), ("gemm broadcast A", "gemm", (c, a[0], b)),
             ("gemm broadcast B", "gemm", (c, a, b[1])), ("gemm one tile", "gemm", (c[2], a[0], b[1])),
             ("syrk batched", "syrk", (c, a)), ("syrk one tile", "syrk", (c[1], a[3])))
    plain = {what: getattr(ref, f"{name}_ref")(*args) for what, name, args in cases}
    first, n = {}, 0
    for split in GEMM_SPLITS[t]:
        for what, name, args in cases:
            got = kern[name](*args, split=split)
            inplace = args[0].clone()
            kern[name](inplace, *args[1:], out=inplace, split=split)
            for g, mode in ((got, ""), (inplace, " in place")):
                label = f"{what}{mode} t={t} split={split}"
                assert_close(torch, g, plain[what], label)
                if not torch.equal(g, first.setdefault(what, g)):
                    raise AssertionError(f"{label}: not bit-identical to split "
                                         f"{GEMM_SPLITS[t][0]}")
                n += 1
    return n


def phase_tasklist_kernels(torch, device, kern, ref):
    """The task list's tile kernels (gemm, syrk, geadd) and the partitioned
    sweep against their plain versions; the partitioned sweep also bit for
    bit against the fused kernel on block-separable input.  Returns the
    number of comparisons."""
    nchecks = 0
    for t in TILES:
        g = torch.Generator().manual_seed(t)
        x = lambda *shape: torch.randn(shape, generator=g).to(device)
        c, a, b = x(5, t, t), x(5, t, t), x(5, t, t)
        for what, got, want in (
                ("batched", kern["gemm"](c, a, b), ref.gemm_ref(c, a, b)),
                ("broadcast A", kern["gemm"](c, a[0], b), ref.gemm_ref(c, a[0], b)),
                ("broadcast B", kern["gemm"](c, a, b[1]), ref.gemm_ref(c, a, b[1])),
                ("one tile", kern["gemm"](c[2], a[0], b[1]), ref.gemm_ref(c[2], a[0], b[1]))):
            assert_close(torch, got, want, f"gemm t={t} {what}")
        assert_close(torch, kern["syrk"](c, a), ref.syrk_ref(c, a), f"syrk t={t} batched")
        assert_close(torch, kern["syrk"](c[1], a[3]), ref.syrk_ref(c[1], a[3]), f"syrk t={t}")
        want = ref.gemm_ref(c[0], a[1], b[2])
        kern["gemm"](c[0], a[1], b[2], out=c[0])
        assert_close(torch, c[0], want, f"gemm t={t} in place")
        nchecks += check_gemm_splits(torch, t, kern, ref, x)
        leaves = x(7, 2, 2, t, t)
        # geadd bit for bit the plain version, programmatic launch on and off
        for pdl in (False, True):
            for what, p, q in (("strided", leaves[0:6:2], leaves[1:6:2]), ("batched", a, b),
                               ("one tile", a[1], b[3])):
                if not torch.equal(kern["geadd"](p, q, pdl=pdl), ref.geadd_ref(p, q)):
                    raise AssertionError(f"geadd t={t} {what} pdl={pdl}: not bit-identical to "
                                         "the plain version")
                nchecks += 1
        nchecks += 7
        for ndt, bt, nat, bounds in PARTITIONED_CASES:
            Ac, R = random_band_arrow(torch, ndt, bt, nat, t, seed=7 * ndt + t, device=device,
                                      bounds=bounds)
            for start in (0, 3):
                what = f"partitioned sweep t={t} bt={bt} nat={nat} P={len(bounds) - 1} start={start}"
                want = ref.band_cholesky_partitioned_sweep_ref(Ac, R, bounds, start_tile=start)
                for cap in SWEEP_CLUSTERS:
                    got = kern["band_cholesky_partitioned_sweep"](Ac, R, bounds, start_tile=start,
                                                                  max_cluster=cap)
                    for gg, w, part in zip(got[:3], want[:3], ("panels", "R_out", "schur")):
                        assert_close(torch, gg, w, f"{what} clusters of {cap} {part}")
                    check_status(got[3], want[3], f"{what} clusters of {cap}")
                    fused = kern["band_cholesky_sweep"](Ac, R, nchunks=1, start_tile=start,
                                                        max_cluster=cap)
                    if not (torch.equal(got[0], fused[0]) and torch.equal(got[1], fused[1])
                            and got[3].tolist() == fused[3].tolist()):
                        raise AssertionError(f"{what} clusters of {cap}: not bit-identical to "
                                             "the fused kernel")
                    nchecks += 2
    return nchecks


def phase_solve_kernels(torch, device, kern, ref):
    """The solve and selected-inversion kernels against their plain
    versions; returns the number of comparisons."""
    nchecks = 0
    from repro_torch.kernels.trsm import PANEL_CHUNKS
    for t in TILES:
        l = random_lower(torch, 3, t, t, device)
        for k in PANEL_KS:
            b = torch.randn((3, t, k), generator=torch.Generator().manual_seed(k)).to(device)
            for trans in (False, True):
                what = f"solve_panel t={t} k={k} trans={trans}"
                want = ref.solve_panel_ref(l[0], b, trans=trans)
                first = kern["solve_panel"](l[0], b, trans=trans)
                assert_close(torch, first, want, what)
                # every chunk width the same bits as the default, and as a
                # second launch
                for chunk in PANEL_CHUNKS:
                    got = kern["solve_panel"](l[0], b, trans=trans, chunk=chunk)
                    assert_close(torch, got, want, f"{what} chunk={chunk}")
                    if not torch.equal(got, first):
                        raise AssertionError(f"{what}: chunk {chunk} not bit-identical to the "
                                             "default chunk")
                    nchecks += 1
                deterministic(torch, lambda: kern["solve_panel"](l[0], b, trans=trans), what)
                nchecks += 1
        for ndt, bt, nat in SOLVE_SWEEPS:
            Dr, R = random_band_factor(torch, ndt, bt, nat, t, 10 * ndt + bt, device)
            for k in (1, 33):
                g = torch.Generator().manual_seed(k)
                bd = torch.randn((ndt, t, k), generator=g).to(device)
                xa = torch.randn((nat, t, k), generator=g).to(device)
                for start in (0, 2):
                    start = min(start, ndt - 1)
                    b0 = bd.clone()
                    b0[:start] = 0.0
                    what = f"t={t} ndt={ndt} bt={bt} nat={nat} k={k} start={start}"
                    want = ref.band_forward_sweep_ref(Dr, R, b0, start) + (
                        ref.band_backward_sweep_ref(Dr, R, b0, xa, start),)
                    # every cluster cap against the plain version, bit for
                    # bit the same as clusters of 1 and as a second launch
                    first = None
                    for cap in SWEEP_CLUSTERS:
                        run = lambda: kern["band_forward_sweep"](Dr, R, b0, start, max_cluster=cap) \
                            + (kern["band_backward_sweep"](Dr, R, b0, xa, start, max_cluster=cap),)
                        got = run()
                        for a, w, part in zip(got, want, ("forward yd", "forward acc_a",
                                                          "backward xd")):
                            assert_close(torch, a, w, f"band sweeps {what} clusters of at most "
                                         f"{cap}: {part}")
                        first = got if first is None else first
                        if not all(torch.equal(a, b) for a, b in zip(got, first)) or not all(
                                torch.equal(a, b) for a, b in zip(got, run())):
                            raise AssertionError(f"band sweeps {what}: clusters of at most {cap} "
                                                 f"not bit-identical to clusters of 1 and to a "
                                                 f"second launch")
                        nchecks += 2
    for t in (16, 64):
        # the grid at ndt = 6, then one column and fewer columns than band tiles
        shapes = [(6, bt, nat) for bt in (0, 1, 4) for nat in (0, 1, 4)] + list(SELINV_EDGES)
        for ndt, bt, nat in shapes:
            lcol, R, sc = selinv_inputs(torch, ndt, bt, nat, t, 1000 + 10 * bt + nat, device)
            for start in (0, 2):
                what = f"selinv_sweep t={t} ndt={ndt} bt={bt} nat={nat} start={start}"
                assert_close(torch, kern["selinv_prepass"](lcol, R, sc, start),
                             ref.selinv_prepass_ref(lcol, R, sc, start), f"{what} pre-pass")
                want = ref.selinv_sweep_ref(lcol, R, sc, start)
                # the wrapper's cluster, and the other sizes the plan allows
                for cap in (None, 4, 8):
                    got = (kern["selinv_sweep"](lcol, R, sc, start) if cap is None else
                           kern["selinv_sweep"](lcol, R, sc, start, max_cluster=cap))
                    for a, w, part in zip(got, want, ("panels", "acols")):
                        assert_close(torch, a, w, f"{what} clusters of {cap or 'default'} {part}")
                    nchecks += 1
    return nchecks


def phase_batched_read_kernels(torch, device, kern, ref):
    """The θ-batch read-out's kernel forms against their plain versions, a
    batch of B in {1, 3}: solve_panel with one L a panel (t in {8, 16, 32,
    64}, every k of PANEL_KS, both directions); both band-solve sweeps on
    the phase's shapes (SOLVE_SWEEPS, k in {1, 33}, start_tile in {0, 2})
    at every cluster cap; the selinv pre-pass and recurrence on the
    phase's selinv shapes, at the default cluster and at 4 and 8.  Each is
    one launch for the batch, and each element bit for bit its unbatched
    launch (the band sweeps at the batch's chunk width).  Returns the
    number of comparisons."""
    from repro_torch.kernels.band_solve import card_solve_plan
    nchecks = 0
    for t in TILES:
        for nb in READ_BATCHES:
            l = random_lower(torch, nb, t, 10 * t + nb, device)
            for k in PANEL_KS:
                b = torch.randn((nb, t, k), generator=torch.Generator().manual_seed(k + nb)).to(
                    device)
                for trans in (False, True):
                    what = f"solve_panel one L a panel t={t} B={nb} k={k} trans={trans}"
                    before = kern["solve_panel"].launches
                    got = kern["solve_panel"](l, b, trans=trans)
                    if kern["solve_panel"].launches != before + 1:
                        raise AssertionError(f"{what}: not one launch")
                    assert_close(torch, got, ref.solve_panel_ref(l, b, trans=trans), what)
                    for i in range(nb):
                        if not torch.equal(got[i], kern["solve_panel"](l[i], b[i], trans=trans)):
                            raise AssertionError(f"{what}: element {i} not bit-identical to its "
                                                 "unbatched launch")
                    nchecks += 1
        for ndt, bt, nat in SOLVE_SWEEPS:
            for nb in READ_BATCHES:
                els = [random_band_factor(torch, ndt, bt, nat, t, 10 * ndt + bt + 7 * i, device)
                       for i in range(nb)]
                Dr, R = torch.stack([e[0] for e in els]), torch.stack([e[1] for e in els])
                for k in (1, 33):
                    g = torch.Generator().manual_seed(k + 100 * nb)
                    bd = torch.randn((nb, ndt, t, k), generator=g).to(device)
                    xa = torch.randn((nb, nat, t, k), generator=g).to(device)
                    for start in (0, 2):
                        start = min(start, ndt - 1)
                        b0 = bd.clone()
                        b0[:, :start] = 0.0
                        what = (f"batched band sweeps t={t} ndt={ndt} bt={bt} nat={nat} B={nb} "
                                f"k={k} start={start}")
                        want = ref.band_forward_sweep_ref(Dr, R, b0, start) + (
                            ref.band_backward_sweep_ref(Dr, R, b0, xa, start),)
                        for cap in SWEEP_CLUSTERS:
                            before = (kern["band_forward_sweep"].launches,
                                      kern["band_backward_sweep"].launches)
                            got = kern["band_forward_sweep"](Dr, R, b0, start, max_cluster=cap) \
                                + (kern["band_backward_sweep"](Dr, R, b0, xa, start,
                                                               max_cluster=cap),)
                            if (kern["band_forward_sweep"].launches,
                                    kern["band_backward_sweep"].launches) != (before[0] + 1,
                                                                              before[1] + 1):
                                raise AssertionError(f"{what}: not one launch a sweep")
                            for a, w, part in zip(got, want, ("forward yd", "forward acc_a",
                                                              "backward xd")):
                                assert_close(torch, a, w, f"{what} clusters of at most {cap}: "
                                             f"{part}")
                            width = card_solve_plan(t, bt, nat, k, cap, device, batch=nb).width
                            for i in range(nb):
                                one = kern["band_forward_sweep"](
                                    Dr[i], R[i], b0[i], start, max_cluster=cap, width=width) + (
                                    kern["band_backward_sweep"](Dr[i], R[i], b0[i], xa[i], start,
                                                                max_cluster=cap, width=width),)
                                if not all(torch.equal(a[i], o) for a, o in zip(got, one)):
                                    raise AssertionError(
                                        f"{what} clusters of at most {cap}: element {i} not "
                                        f"bit-identical to its unbatched launch at width {width}")
                            nchecks += 2
    for t in (16, 64):
        shapes = [(6, bt, nat) for bt in (0, 1, 4) for nat in (0, 1, 4)] + list(SELINV_EDGES)
        for ndt, bt, nat in shapes:
            for nb in READ_BATCHES:
                els = [selinv_inputs(torch, ndt, bt, nat, t, 1000 + 10 * bt + nat + 3 * i, device)
                       for i in range(nb)]
                lcol, R, sc = (torch.stack([e[q] for e in els]) for q in range(3))
                for start in (0, 2):
                    what = (f"batched selinv t={t} ndt={ndt} bt={bt} nat={nat} B={nb} "
                            f"start={start}")
                    before = kern["selinv_prepass"].launches
                    work = kern["selinv_prepass"](lcol, R, sc, start)
                    if kern["selinv_prepass"].launches != before + 1:
                        raise AssertionError(f"{what}: the pre-pass is not one launch")
                    assert_close(torch, work, ref.selinv_prepass_ref(lcol, R, sc, start),
                                 f"{what} pre-pass")
                    want = ref.selinv_sweep_ref(lcol, R, sc, start)
                    for cap in (None, 4, 8):
                        caps = {} if cap is None else {"max_cluster": cap}
                        got = kern["selinv_sweep"](lcol, R, sc, start, work=work, **caps)
                        for a, w, part in zip(got, want, ("panels", "acols")):
                            assert_close(torch, a, w, f"{what} clusters of {cap or 'default'} "
                                         f"{part}")
                        for i in range(nb):
                            one = kern["selinv_sweep"](lcol[i], R[i], sc[i], start, **caps)
                            if not all(torch.equal(a[i], o) for a, o in zip(got, one)):
                                raise AssertionError(f"{what} clusters of {cap or 'default'}: "
                                                     f"element {i} not bit-identical to its "
                                                     "unbatched launch")
                        nchecks += 1
                    for i in range(nb):
                        if not torch.equal(work[i], kern["selinv_prepass"](lcol[i], R[i], sc[i],
                                                                           start)):
                            raise AssertionError(f"{what}: pre-pass element {i} not "
                                                 "bit-identical to its unbatched launch")
    return nchecks


def phase_window_kernels(torch, device, kern, ref):
    """band_update, selinv_step, the trsm of one L per group of tiles and
    the batched sweeps against their plain versions; the batched sweeps
    also bit for bit against the unbatched launch on each element.
    Returns the number of comparisons."""
    nchecks = 0
    for t in TILES:
        g = torch.Generator().manual_seed(1000 + t)
        x = lambda *shape: torch.randn(shape, generator=g).to(device)
        for b1 in (1, 2, 3, 5, 6, 9):
            w = x(b1, b1, t, t)
            got = kern["band_update"](w)
            assert_close(torch, got, ref.band_update_unrolled_ref(w), f"band_update t={t} b+1={b1}")
            assert_close(torch, got, ref.band_update_ref(w), f"band_update t={t} b+1={b1} einsum")
            rows = x(3, 6 + b1, b1, t, t)      # a batch of padded band rows
            win = rows[:, 3:3 + b1]
            assert_close(torch, kern["band_update"](win), ref.band_update_unrolled_ref(win),
                         f"band_update t={t} b+1={b1} strided batch")
            nchecks += 3
        for e_n, j_n in ((1, 1), (1, 2), (4, 3), (3, 5), (8, 8), (2, 17), (1, 17)):
            s_row, g_col = x(e_n, j_n, t, t), x(j_n, t, t)
            assert_close(torch, kern["selinv_step"](s_row, g_col), ref.selinv_step_ref(s_row, g_col),
                         f"selinv_step t={t} e_n={e_n} j_n={j_n}")
            nchecks += 1
        for e_n, j_n in ((0, 3), (2, 0)):
            s_row, g_col = x(e_n, j_n, t, t), x(j_n, t, t)
            assert_close(torch, kern["selinv_step"](s_row, g_col), ref.selinv_step_ref(s_row, g_col),
                         f"selinv_step t={t} empty e_n={e_n} j_n={j_n}")
            nchecks += 1
        l = ref.potrf_ref(random_spd(torch, 4, t, t, device))[:, None]
        b = x(4, 3, t, t)
        want = ref.trsm_ref(l, b)
        assert_close(torch, kern["trsm"](l, b), want, f"trsm t={t} one L a group")
        inplace = b.clone()
        kern["trsm"](l, inplace, out=inplace)
        assert_close(torch, inplace, want, f"trsm t={t} one L a group in place")
        nchecks += 2
        for bt, nat in ((0, 2), (2, 0), (3, 3)):
            bounds = (0, 3, 6, 9)
            els = [random_band_arrow(torch, 9, bt, nat, t, seed=50 * t + 5 * bt + nat + i,
                                     device=device, bounds=bounds) for i in range(3)]
            Ac, R = (torch.stack(z) for z in zip(*els))
            for name, args in (("band_cholesky_sweep", dict(nchunks=3, start_tile=2)),
                               ("band_cholesky_partitioned_sweep", dict(boundaries=bounds,
                                                                        start_tile=2))):
                what = f"batched {name} t={t} bt={bt} nat={nat}"
                got = kern[name](Ac, R, **args)
                want = getattr(ref, f"{name}_ref")(Ac, R, **args)
                for gg, w, part in zip(got[:3], want[:3], ("panels", "R_out", "schur")):
                    assert_close(torch, gg, w, f"{what} {part}")
                for i in range(3):
                    check_status(got[3][i], want[3][i], f"{what} element {i}")
                    one = kern[name](Ac[i], R[i], **args)
                    if not all(torch.equal(gg[i], w) for gg, w in zip(got, one)):
                        raise AssertionError(f"{what}: element {i} not bit-identical to its "
                                             "unbatched launch")
                nchecks += 2
    return nchecks


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------

def dense_from_ctsf(torch, m, dtype, symmetric):
    """The padded dense matrix of a BandedCTSF, assembled on its device."""
    g = m.grid
    t, ndt, nat, bt = g.t, g.n_diag_tiles, g.n_arrow_tiles, g.band_tiles
    out = torch.zeros((g.padded_n, g.padded_n), dtype=dtype, device=m.device)
    for d in range(bt + 1):
        for k in range(d, ndt):
            out[k * t:(k + 1) * t, (k - d) * t:(k - d + 1) * t] = m.Dr[k, d]
    off = ndt * t
    for i in range(nat):
        out[off + i * t:off + (i + 1) * t, :off] = m.R[:, i].permute(1, 0, 2).reshape(t, off)
        for j in range(i + 1):
            out[off + i * t:off + (i + 1) * t, off + j * t:off + (j + 1) * t] = m.C[i, j]
    if symmetric:
        out = torch.tril(out) + torch.tril(out, -1).mT
    return out


def band_block_dense(torch, Dr):
    """The factor's band block as one dense lower-triangular (ndt t, ndt t)
    matrix: what the band sweeps' one-call library yardstick,
    ``torch.linalg.solve_triangular``, solves with."""
    ndt, b1, t, _ = Dr.shape
    Lb = Dr.new_zeros((ndt * t, ndt * t))
    for m in range(ndt):
        for j in range(min(b1 - 1, m) + 1):
            Lb[m * t:(m + 1) * t, (m - j) * t:(m - j + 1) * t] = Dr[m, j]
    return torch.tril(Lb)


def needed_flops(grid, boundaries=None):
    """Operations the factorization of ``grid`` needs, split into the band
    sweep's share and the dense corner's: the symbolic task list of its
    dense-band pattern (``core.symbolic``), a POTRF t^3/3, a SYRK t^3 (its
    product is symmetric, so one triangle is needed), a TRSM t^3 and a GEMM
    2 t^3.  The sweep owns every task on a band column and every
    corner-Schur update from one; the rest is the corner's.  With partition
    ``boundaries`` the band tiles across the cuts are zero, and so is their
    work."""
    import numpy as np
    from repro_torch.core import (TaskType, banded_arrowhead_tile_pattern,
                                  symbolic_factorize)
    t, ndt = grid.t, grid.n_diag_tiles
    cost = {TaskType.POTRF: t ** 3 / 3.0, TaskType.SYRK: float(t) ** 3,
            TaskType.TRSM: float(t) ** 3, TaskType.GEMM: 2.0 * t ** 3}
    pattern = banded_arrowhead_tile_pattern(grid)
    if boundaries is not None:
        part = np.searchsorted(np.asarray(boundaries), np.arange(ndt), side="right")
        pattern[:ndt, :ndt] &= part[:, None] == part[None, :]
    sweep = corner = 0.0
    for task in symbolic_factorize(pattern).tasks:
        if task.k < ndt or 0 <= task.n < ndt:
            sweep += cost[task.type]
        else:
            corner += cost[task.type]
    return sweep, corner


def band_sweep_bytes(grid, nleaves, nwords=1):
    """Bytes the fused or partitioned sweep moves at ``grid``'s shapes with
    ``nleaves`` Schur leaves and ``nwords`` status words: its band and arrow
    inputs read once, the panels, arrow rows, leaves and words written
    once."""
    t, ndt, bt, nat = grid.t, grid.n_diag_tiles, grid.band_tiles, grid.n_arrow_tiles
    return 4 * t * t * (2 * ndt * (bt + 1) + 2 * ndt * nat + nleaves * nat * nat) + 12 * nwords


def run_matrix(torch, matrix_id, device=None, scale=1.0, kern_counts=None):
    """One Table II matrix through the main path (on the card unless
    ``device`` says otherwise); returns its record."""
    from repro_torch.core import (BandedCTSF, TileGrid, factorize_window, logdet,
                                  measure_arrowhead)
    from repro_torch.data import table2_matrix

    t0 = time.perf_counter()
    A, st = table2_matrix(matrix_id, scale=scale, seed=0)
    measured = measure_arrowhead(A, arrow_hint=st.arrow)
    grid = TileGrid(measured, t=64 if scale == 1.0 else 16)
    m = BandedCTSF.from_sparse(A, grid, device=device)
    host_s = time.perf_counter() - t0
    ndt, bt, nat, t = grid.n_diag_tiles, grid.band_tiles, grid.n_arrow_tiles, grid.t

    before = kern_counts() if kern_counts else None
    f = factorize_window(m)
    ld = logdet(f)
    if m.device.type == "cuda":
        torch.cuda.synchronize()
    launches = None
    if kern_counts:
        after = kern_counts()
        launches = {k: after[k] - before[k] for k in after}
        want = {k: 0 for k in after}
        want.update(band_cholesky_sweep=1, potrf=nat, trsm=nat)
        if launches != want:
            raise AssertionError(f"matrix {matrix_id}: launches {launches} != {want}")

    # the factor: max|L L^T - A| / max|A| and logdet against a float64 oracle
    Ad = dense_from_ctsf(torch, m, torch.float64, symmetric=True)
    Ld = dense_from_ctsf(torch, f.ctsf, torch.float64, symmetric=False)
    resid = ((Ld @ Ld.mT - Ad).abs().max() / Ad.abs().max()).item()
    oracle = (2.0 * torch.log(torch.diagonal(torch.linalg.cholesky(Ad)))).sum().item()
    ld = ld.item()
    ld_rel = abs(ld - oracle) / abs(oracle)
    del Ad, Ld
    finite = all(torch.isfinite(x).all().item() for x in f.ctsf.arrays())
    status = f.status.tolist()
    if not finite or status[1:] != [0.0, -1.0] or resid > 1e-4 or ld_rel > 1e-4:
        raise AssertionError(f"matrix {matrix_id}: finite={finite} status={status} "
                             f"residual={resid:.3e} logdet={ld} oracle={oracle} "
                             f"rel={ld_rel:.3e}")
    rec = dict(matrix=matrix_id, n=measured.n, bandwidth=measured.bandwidth,
               arrow=measured.arrow, t=t, ndt=ndt, bt=bt, nat=nat,
               host_setup_s=round(host_s, 3), residual=resid, logdet=ld,
               logdet_oracle=oracle, logdet_rel_err=ld_rel, status=status,
               launches=launches)
    return rec, m, f


def launch_delta(kern_counts, fn, want, what):
    """Run ``fn`` and check the kernel launches it made against ``want``
    (name -> count, every kernel not named must stay at 0)."""
    before = kern_counts()
    out = fn()
    after = kern_counts()
    got = {k: after[k] - before[k] for k in after}
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{what}: launches {got} != {full}")
    return out, {k: v for k, v in got.items() if v}


def run_solves(torch, matrix_id, m, f, kern_counts):
    """The solve half of the main path on one factored Table II matrix:
    solve, solve_many, sample_gmrf_many, selected_inverse and both
    marginal_variances methods, each with its launch counts, checked
    against float64 oracles on the card; returns their record."""
    from repro_torch.core import (SolverOptions, marginal_variances, sample_gmrf_many,
                                  selected_inverse, solve, solve_many)
    g = m.grid
    n, ndt, nat, t = g.structure.n, g.n_diag_tiles, g.n_arrow_tiles, g.t
    dev = m.device
    per_solve = {"band_forward_sweep": 1, "band_backward_sweep": 1, "solve_panel": 2 * nat}
    Ad = dense_from_ctsf(torch, m, torch.float64, symmetric=True)
    Ld = dense_from_ctsf(torch, f.ctsf, torch.float64, symmetric=False)
    gen = torch.Generator(device=dev).manual_seed(matrix_id)
    B = torch.randn((g.padded_n, 32), generator=gen, device=dev)
    real = torch.zeros(g.padded_n, dtype=torch.bool, device=dev)
    real[:g.structure.n_diag] = True
    real[ndt * t:ndt * t + g.structure.arrow] = True
    B[~real] = 0.0
    rec, launches = {}, {}

    def solve_check(X, Bk, what):
        X64, B64 = X.double(), Bk.double()
        resid = ((Ad @ X64 - B64).abs().max() / (Ad.abs().max() * X64.abs().max())).item()
        exact = torch.cholesky_solve(B64, Ld)
        fwd = ((X64 - exact).abs().max() / exact.abs().max()).item()
        if not (resid <= RESIDUAL_LIMIT and fwd <= SOLVE_RTOL):
            raise AssertionError(f"matrix {matrix_id} {what}: residual {resid:.3e} "
                                 f"(limit {RESIDUAL_LIMIT}), forward error {fwd:.3e} "
                                 f"(limit {SOLVE_RTOL})")
        return resid, fwd

    x, launches["solve"] = launch_delta(kern_counts, lambda: solve(f, B[:, 0]), per_solve,
                                        f"matrix {matrix_id} solve")
    rec["solve_residual"], rec["solve_forward_error"] = solve_check(x[:, None], B[:, :1],
                                                                    "solve")
    X, launches["solve_many"] = launch_delta(kern_counts, lambda: solve_many(f, B), per_solve,
                                             f"matrix {matrix_id} solve_many")
    rec["solve_many_residual"], rec["solve_many_forward_error"] = solve_check(X, B, "solve_many")

    # posterior draws: x = L^{-T} z, z drawn again from the same seed
    Xs, launches["sample_gmrf_many"] = launch_delta(
        kern_counts, lambda: sample_gmrf_many(f, num=32, generator=torch.Generator(
            device=dev).manual_seed(7)),
        {"band_backward_sweep": 1, "solve_panel": nat}, f"matrix {matrix_id} sample_gmrf_many")
    z = torch.randn((g.padded_n, 32), generator=torch.Generator(device=dev).manual_seed(7),
                    dtype=torch.float32, device=dev).double()
    rec["sample_residual"] = ((Ld.mT @ Xs.double() - z).abs().max()
                              / (Ld.abs().max() * Xs.abs().max())).item()
    if not rec["sample_residual"] <= RESIDUAL_LIMIT:
        raise AssertionError(f"matrix {matrix_id} sample_gmrf_many: L^T x = z residual "
                             f"{rec['sample_residual']:.3e} (limit {RESIDUAL_LIMIT})")

    # every stored entry of the selected inverse against the float64 inverse
    inv = torch.cholesky_inverse(Ld)
    sigma, launches["selected_inverse"] = launch_delta(
        kern_counts, lambda: selected_inverse(f), {"selinv_sweep": 1, "selinv_prepass": 1},
        f"matrix {matrix_id} selected_inverse")
    from repro_torch.core import BandedCTSF
    Sd = dense_from_ctsf(torch, BandedCTSF(g, *sigma.arrays()), torch.float64, symmetric=True)
    ones = BandedCTSF(g, *(torch.ones_like(a) for a in sigma.arrays()))
    stored = dense_from_ctsf(torch, ones, torch.float64, symmetric=True) > 0
    rec["sigma_error"] = ((Sd - inv).abs()[stored].max() / inv.abs().max()).item()
    del Sd, stored
    if not rec["sigma_error"] <= SIGMA_LIMIT:
        raise AssertionError(f"matrix {matrix_id} selected_inverse: error "
                             f"{rec['sigma_error']:.3e} of max|Σ| (limit {SIGMA_LIMIT})")

    # marginal variances, both methods, against each other and the inverse
    idx = [0, n // 2, n - g.structure.arrow, n - 1]
    want = torch.diagonal(inv)[torch.as_tensor([g.padded_index(i) for i in idx], device=dev)]
    got = {}
    for method, expect in (("selinv", {"selinv_sweep": 1, "selinv_prepass": 1}),
                           ("panels", {"band_forward_sweep": 1, "solve_panel": nat})):
        got[method], launches[f"marginal_variances_{method}"] = launch_delta(
            kern_counts, lambda: marginal_variances(f, idx, options=SolverOptions(method=method)),
            expect, f"matrix {matrix_id} marginal_variances {method}")
        err = ((got[method].double() - want).abs() / want.abs()).max().item()
        rec[f"variance_rel_error_{method}"] = err
        if not err <= VARIANCE_RTOL:
            raise AssertionError(f"matrix {matrix_id} marginal_variances {method}: relative "
                                 f"error {err:.3e} (limit {VARIANCE_RTOL})")
    rec["variances_selinv_vs_panels"] = (
        (got["selinv"] - got["panels"]).abs() / got["panels"].abs()).max().item()
    if not rec["variances_selinv_vs_panels"] <= VARIANCE_RTOL:
        raise AssertionError(f"matrix {matrix_id}: the two marginal_variances methods differ "
                             f"by {rec['variances_selinv_vs_panels']:.3e}")
    rec["variances"] = got["selinv"].tolist()
    rec["variance_indices"] = idx
    rec["launches"] = launches
    del Ad, Ld, inv
    return rec


def eager_solve_many(f, B, backward_only=False):
    """solve_many (or with ``backward_only``, backward_solve_many) with the
    corner launched eagerly, a tile at a time from the host, as every call
    did before the corner's CUDA graph: the graph's yardstick.  The two
    sweeps and the corner's two loops, called directly."""
    from repro_torch.core.solve import (_backward_corner, _forward_corner, _merge_panels,
                                        _split_rhs)
    from repro_torch.kernels import ops
    c = f.ctsf
    yd, ya = _split_rhs(c.grid, B)
    if not backward_only:
        yd, acc_a = ops.band_forward_sweep(c.Dr, c.R, yd)
        ya = _forward_corner(c.C, ya, acc_a, None)
    xa = _backward_corner(c.C, ya, None)
    return _merge_panels(ops.band_backward_sweep(c.Dr, c.R, yd, xa.contiguous()), xa)


def theta_step(torch, m):
    """``THETA_STEP[0] A + THETA_STEP[1] I`` of a BandedCTSF, another INLA θ
    step of the same grid (the padding diagonal scaled too: it stays SPD
    and decoupled)."""
    from repro_torch.core import BandedCTSF
    tau, delta = THETA_STEP
    eye = delta * torch.eye(m.grid.t, device=m.device)
    Dr, C = tau * m.Dr, tau * m.C
    Dr[:, 0] += eye
    for i in range(C.shape[0]):
        C[i, i] += eye
    return BandedCTSF(m.grid, Dr, tau * m.R, C)


def check_solve_graph(torch, matrix_id, m, f, kern_counts, first_captures):
    """The solves' corner from its CUDA graphs on one factored matrix: the
    first pass of run_solves captured one graph a key; a second pass (every
    call a replay) and a θ step of the same grid pass every solve, sample
    and variance gate with one call's launches and capture nothing; each
    replay against the eager corner, bit for bit or within rtol = atol =
    2e-4 (cuBLAS may take another algorithm for the corner's products inside
    a capture).  Returns the record."""
    from repro_torch.core import factorize_window, sample_gmrf_many, solve_many
    from repro_torch.core.solve import corner_graphs
    g = m.grid
    # run_solves' keys: solve (k = 1) and solve_many (k = 32) both ways
    # (sample_gmrf_many's backward k = 32 is solve_many's), and the panels
    # method's forward solve of the four variance indices
    want = 5 if g.n_arrow_tiles else 0
    if first_captures != want:
        raise AssertionError(f"matrix {matrix_id}: the solves' first pass captured "
                             f"{first_captures} corner graphs, want one a key, {want}")
    captures = corner_graphs.captures
    again = run_solves(torch, matrix_id, m, f, kern_counts)
    m2 = theta_step(torch, m)
    f2 = factorize_window(m2)
    theta = run_solves(torch, matrix_id, m2, f2, kern_counts)
    if corner_graphs.captures != captures:
        raise AssertionError(f"matrix {matrix_id}: a second pass of the solves or a θ step "
                             f"captured {corner_graphs.captures - captures} corner graphs")
    dev = m.device
    B = torch.randn((g.padded_n, 32), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    agree = {}
    for what, ff in (("factor", f), ("theta_step", f2)):
        for name, graph_fn, eager_fn in (
                ("solve_many_k1", lambda: solve_many(ff, B[:, :1]),
                 lambda: eager_solve_many(ff, B[:, :1])),
                ("solve_many_k32", lambda: solve_many(ff, B), lambda: eager_solve_many(ff, B)),
                ("sample_gmrf_many", lambda: sample_gmrf_many(ff, num=32, z=B),
                 lambda: eager_solve_many(ff, B, backward_only=True))):
            got, ref_ = graph_fn(), eager_fn()
            agree[f"{what} {name}"] = dict(bit_identical=torch.equal(got, ref_),
                                          max_abs_diff=assert_close(
                                              torch, got, ref_, f"matrix {matrix_id} {what} "
                                              f"{name}: the corner's graph against the eager "
                                              "corner"))
    if corner_graphs.captures != captures:
        raise AssertionError(f"matrix {matrix_id}: the graph's checks captured again")
    keep = ("solve_residual", "solve_many_residual", "sample_residual",
            "variance_rel_error_panels", "launches")
    return dict(captures=first_captures, second_pass={k: again[k] for k in keep},
                theta_step={k: theta[k] for k in keep}, graph_vs_eager=agree)


def tree_levels(n_partials):
    """geadd launches of a tree over ``n_partials`` leaves: one a level."""
    levels = 0
    while n_partials > 1:
        n_partials, levels = (n_partials + 1) // 2, levels + 1
    return levels


def tasklist_launches(tm, workers):
    """The kernel launches of ``factorize_tasklist(tm)`` with ``workers``
    tree workers (0: no tree), derived from the symbolic task list: a
    launch per task, except that an accumulation chain on which
    ``should_use_tree`` holds is one batched product and a geadd per level
    of the tree over ``min(workers, chain)`` partials."""
    from repro_torch.core import TaskType, should_use_tree
    chains = {}
    want = dict(potrf=0, trsm=0, syrk=0, gemm=0, geadd=0)
    for task in tm.symbolic.tasks:
        name = task.type.name.lower()
        if task.type in (TaskType.SYRK, TaskType.GEMM):
            key = (task.k, task.k if task.type == TaskType.SYRK else task.m)
            chains.setdefault(key, [name, 0])[1] += 1
        else:
            want[name] += 1
    for name, n in chains.values():
        if should_use_tree(n, workers):
            want["geadd"] += tree_levels(min(workers, n))
        else:
            want[name] += n
    return want


def tasklist_warmup_launches(want, workers):
    """The launches the first call of a pattern makes before its capture:
    one of each tile kernel and, where ``want`` (one call's launches) has a
    tree, one tree update (its chains all have at least ``2 * workers``
    products, so a geadd per level over ``workers`` partials)."""
    return dict(potrf=1, trsm=1, syrk=1, gemm=1,
                geadd=tree_levels(workers) if want["geadd"] else 0)


def dense_from_tiles(torch, tm, tiles, dtype):
    """The padded dense lower factor of a TileMatrix's tile buffer, on its
    device."""
    t = tm.grid.t
    out = torch.zeros((tm.grid.padded_n, tm.grid.padded_n), dtype=dtype, device=tiles.device)
    for (i, j), idx in tm.slot.items():
        out[i * t:(i + 1) * t, j * t:(j + 1) * t] = tiles[idx]
    return torch.tril(out)


def run_tasklist(torch, matrix_id, m, f, rec, kern_counts):
    """The paper's task list on one factored Table II matrix, tree
    reduction off and on (8 workers): the first call of each, which captures
    the pattern's CUDA graph once and replays it, with its launch counts
    against the symbolic task list and the warm-up, the factor residual, the agreement with
    the window factor ``f`` and the logdet from the tiles; returns the
    records, the TileMatrix and the factors (by tree setting)."""
    from repro_torch.core import TileMatrix, factorize_tasklist
    from repro_torch.core.cholesky import tasklist_graphs
    from repro_torch.data import table2_matrix
    t0 = time.perf_counter()
    A, _ = table2_matrix(matrix_id, seed=0)
    tm = TileMatrix.from_sparse(A, m.grid)
    host_s = time.perf_counter() - t0
    Ad = dense_from_ctsf(torch, m, torch.float64, symmetric=True)
    Lw = dense_from_ctsf(torch, f.ctsf, torch.float64, symmetric=False)
    out, factors = {}, {}
    for tree in (False, True):
        workers = 8 if tree else 0
        what = f"matrix {matrix_id} factorize_tasklist tree={tree}"
        want = tasklist_launches(tm, workers)
        warm = tasklist_warmup_launches(want, workers)
        want = {k: want[k] + warm[k] for k in want}
        captures = tasklist_graphs.captures
        tiles, launches = launch_delta(
            kern_counts, lambda: factorize_tasklist(tm, tree_reduction=tree, tree_workers=8),
            want, what)
        if tasklist_graphs.captures != captures + 1:
            raise AssertionError(f"{what}: {tasklist_graphs.captures - captures} captures, "
                                 "want 1 for the pattern's first call")
        Lt = dense_from_tiles(torch, tm, tiles, torch.float64)
        resid = ((Lt @ Lt.mT - Ad).abs().max() / Ad.abs().max()).item()
        agree = ((Lt - Lw).abs().max() / Lw.abs().max()).item()
        ld = (2.0 * torch.log(torch.diagonal(Lt))).sum().item()
        ld_rel = abs(ld - rec["logdet_oracle"]) / abs(rec["logdet_oracle"])
        del Lt
        if not (resid <= RESIDUAL_LIMIT and agree <= AGREEMENT_LIMIT and ld_rel <= 1e-4):
            raise AssertionError(f"{what}: residual {resid:.3e} (limit {RESIDUAL_LIMIT}), "
                                 f"agreement with factorize_window {agree:.3e} (limit "
                                 f"{AGREEMENT_LIMIT}), logdet rel {ld_rel:.3e} (limit 1e-4)")
        key = f"tree_{'on' if tree else 'off'}"
        out[key] = dict(residual=resid, agreement=agree, logdet=ld, logdet_rel_err=ld_rel,
                        launches=launches)
        factors[key] = tiles
    del Ad, Lw
    return dict(n_tasks=len(tm.symbolic.tasks), n_alloc=tm.n_alloc, nbytes=tm.nbytes(),
                host_setup_s=round(host_s, 3), **out), tm, factors


def eager_tasklist(tm, workers):
    """The task list launched task by task from the host on the card, as
    every call did before the CUDA graph: the graph's yardstick."""
    from repro_torch.core.cholesky import _run_tasklist, _schedule
    return _run_tasklist(tm.tiles.clone(), _schedule(tm, workers), workers, None)


def same_pattern_matrix(torch, matrix_id, tm):
    """A TileMatrix of ``THETA_STEP[0] A + THETA_STEP[1] I``: another INLA θ
    step of one Table II matrix, the same sparsity pattern as ``tm``."""
    import scipy.sparse as sp
    from repro_torch.core import TileMatrix
    from repro_torch.data import table2_matrix
    A, _ = table2_matrix(matrix_id, seed=0)
    tau, delta = THETA_STEP
    return TileMatrix.from_sparse((tau * A + delta * sp.identity(A.shape[0])).tocsr(), tm.grid)


def check_tasklist_graph(torch, matrix_id, tm, factors, kern_counts):
    """The task list's CUDA graph on one matrix, tree off and on: a second
    call replays without a capture and gives the first call's bits, with
    one call's launches; a new TileMatrix of the same pattern (another θ)
    replays the same graph and gets its own factor (its residual against
    its own matrix); the graph's factors against the eager loop's, bit for
    bit with the tree off.  With the tree on, the chains' batched product is
    one cuBLAS call, which may take another algorithm inside a capture than
    outside it: equal, or within the kernels' tolerance.  Returns the
    record and the new TileMatrix."""
    from repro_torch.core import SolverOptions, factorize_tasklist
    from repro_torch.core.cholesky import tasklist_graph_key, tasklist_graphs
    tm2 = same_pattern_matrix(torch, matrix_id, tm)
    if tasklist_graph_key(tm2, 0) != tasklist_graph_key(tm, 0):
        raise AssertionError(f"matrix {matrix_id}: the θ step's pattern key differs")
    A2 = dense_from_tiles(torch, tm2, tm2.tiles, torch.float64)
    A2 = A2 + torch.tril(A2, -1).mT
    out = {}
    for tree in (False, True):
        workers = 8 if tree else 0
        key = f"tree_{'on' if tree else 'off'}"
        what = f"matrix {matrix_id} factorize_tasklist tree={tree}"
        want = tasklist_launches(tm, workers)
        call = lambda x: factorize_tasklist(x, tree_reduction=tree, tree_workers=8)
        captures = tasklist_graphs.captures
        again, l2 = launch_delta(kern_counts, lambda: call(tm), want, f"{what}, second call")
        f2, l3 = launch_delta(kern_counts, lambda: call(tm2), want, f"{what}, θ step")
        as_cuda = factorize_tasklist(tm, tree_reduction=tree, tree_workers=8,
                                     options=SolverOptions(impl="cuda"))
        if tasklist_graphs.captures != captures:
            raise AssertionError(f"{what}: a replay of a kept pattern (impl None or 'cuda') "
                                 "captured again")
        first = factors[key]
        if not (torch.equal(again, first) and torch.equal(as_cuda, first)):
            raise AssertionError(f"{what}: a later call differs from the first")
        if torch.equal(f2, first):
            raise AssertionError(f"{what}: the θ step returned the first matrix's factor")
        L2 = dense_from_tiles(torch, tm2, f2, torch.float64)
        resid2 = ((L2 @ L2.mT - A2).abs().max() / A2.abs().max()).item()
        del L2
        if not resid2 <= RESIDUAL_LIMIT:
            raise AssertionError(f"{what}, θ step: residual {resid2:.3e} (limit "
                                 f"{RESIDUAL_LIMIT})")
        rec = dict(second_call_launches=l2, theta_step_launches=l3, theta_step_residual=resid2)
        for name, got, x in (("graph", first, tm), ("theta_step", f2, tm2)):
            eager = eager_tasklist(x, workers)
            same = torch.equal(got, eager)
            if not same and not tree:
                raise AssertionError(f"{what} ({name}): the graph's factor is not the eager "
                                     "loop's bit for bit")
            rec[f"{name}_equal_to_eager"] = same
            rec[f"{name}_max_abs_diff_to_eager"] = assert_close(
                torch, got, eager, f"{what} ({name}) against the eager loop")
        out[key] = rec
    del A2
    return out, tm2


def partitioned_matrix(torch, matrix_id):
    """A block-diagonal Table II matrix on the card and the plan
    ``detect_partition_plan`` finds for it; returns ``(m, plan, seconds)``."""
    from repro_torch.core import BandedCTSF, TileGrid, detect_partition_plan, measure_arrowhead
    from repro_torch.data import table2_matrix
    t0 = time.perf_counter()
    A, st = table2_matrix(matrix_id, seed=0)
    measured = measure_arrowhead(A, arrow_hint=st.arrow)
    grid = TileGrid(measured, t=64)
    m = BandedCTSF.from_sparse(A, grid)
    plan = detect_partition_plan(A, measured, grid.t)
    if plan.n_partitions < 2:
        raise AssertionError(f"matrix {matrix_id}: detect_partition_plan found one partition")
    return m, plan, time.perf_counter() - t0


def run_partitioned(torch, matrix_id, m, plan, kern_counts):
    """``factorize_window`` with ``plan`` on one matrix, and its launches:
    one partitioned sweep, a geadd per level of the tree over the
    partitions' Schur leaves, nat potrf and nat trsm."""
    from repro_torch.core import SolverOptions, factorize_window
    nat = m.grid.n_arrow_tiles
    return launch_delta(
        kern_counts, lambda: factorize_window(m, options=SolverOptions(partition_plan=plan)),
        {"band_cholesky_partitioned_sweep": 1, "geadd": tree_levels(plan.n_partitions),
         "potrf": nat, "trsm": nat}, f"matrix {matrix_id} partitioned factorize_window")


def check_partitioned(torch, matrix_id, m, plan, f, launches, host_s):
    """The partitioned route's checks on one matrix: the partitioned sweep
    bit for bit against the fused kernel (panels, arrow rows, status) at
    every cluster cap, the factor ``f`` against the fused route's (band bit
    for bit, the corner within 1e-4 relative), its residual and logdet;
    returns the record."""
    from repro_torch.core import factorize_window, logdet
    from repro_torch.kernels.band_cholesky import (band_cholesky_partitioned_sweep_cuda,
                                                   band_cholesky_sweep_cuda)
    from repro_torch.kernels.ring import band_row_to_col
    what = f"matrix {matrix_id} partitioned"
    Ac = band_row_to_col(m.Dr)
    for cap in SWEEP_CLUSTERS:
        got = band_cholesky_partitioned_sweep_cuda(Ac, m.R, plan.boundaries, max_cluster=cap)
        fused = band_cholesky_sweep_cuda(Ac, m.R, nchunks=1, max_cluster=cap)
        if not (torch.equal(got[0], fused[0]) and torch.equal(got[1], fused[1])
                and got[3].tolist() == fused[3].tolist()):
            raise AssertionError(f"{what}: sweep at clusters of {cap} not bit-identical to "
                                 "the fused kernel")
    ff = factorize_window(m)
    corner = ((f.ctsf.C - ff.ctsf.C).abs().max() / ff.ctsf.C.abs().max()).item()
    ld = logdet(f).item()
    Ad = dense_from_ctsf(torch, m, torch.float64, symmetric=True)
    Ld = dense_from_ctsf(torch, f.ctsf, torch.float64, symmetric=False)
    resid = ((Ld @ Ld.mT - Ad).abs().max() / Ad.abs().max()).item()
    oracle = (2.0 * torch.log(torch.diagonal(torch.linalg.cholesky(Ad)))).sum().item()
    ld_rel = abs(ld - oracle) / abs(oracle)
    del Ad, Ld
    same = all(torch.equal(getattr(f.ctsf, x), getattr(ff.ctsf, x)) for x in ("Dr", "R"))
    status = f.status.tolist()
    if not (same and corner <= 1e-4 and resid <= RESIDUAL_LIMIT and ld_rel <= 1e-4
            and status[1:] == [0.0, -1.0]):
        raise AssertionError(f"{what}: band bit-identical to the fused route {same}, corner "
                             f"{corner:.3e} (limit 1e-4), residual {resid:.3e}, logdet rel "
                             f"{ld_rel:.3e}, status {status}")
    g = m.grid
    return dict(matrix=matrix_id, n=g.structure.n, bandwidth=g.structure.bandwidth,
                arrow=g.structure.arrow, t=g.t, ndt=g.n_diag_tiles, bt=g.band_tiles,
                nat=g.n_arrow_tiles, boundaries=list(plan.boundaries),
                partitions=plan.n_partitions, max_tiles=plan.max_tiles,
                sweep_bit_identical_to_fused_at_clusters=list(SWEEP_CLUSTERS),
                host_setup_s=round(host_s, 3), residual=resid, corner_rel_to_fused=corner,
                logdet=ld, logdet_oracle=oracle, logdet_rel_err=ld_rel, status=status,
                launches=launches)


def window_launches(grid):
    """Kernel launches of ``factorize_window`` with ``sweep="window"`` (one
    matrix or a batch alike): per band column one band_update, one potrf,
    one trsm of the bt band tiles (none when bt = 0) and one of the arrow
    row (none when nat = 0); the corner's nat potrf and nat trsm; a geadd
    per level of the Schur tree over min(8, ndt) partials where
    ``should_use_tree(ndt, 8)`` holds."""
    from repro_torch.core import should_use_tree
    ndt, bt, nat = grid.n_diag_tiles, grid.band_tiles, grid.n_arrow_tiles
    tree = nat and should_use_tree(ndt, 8)
    return {"band_update": ndt, "potrf": ndt + nat,
            "trsm": ndt * (int(bt > 0) + int(nat > 0)) + nat,
            "geadd": tree_levels(min(8, ndt)) if tree else 0}


def run_window(torch, matrix_id, m, kern_counts):
    """``factorize_window(sweep="window")`` on one matrix, and its launches."""
    from repro_torch.core import SolverOptions, factorize_window
    return launch_delta(kern_counts,
                        lambda: factorize_window(m, options=SolverOptions(sweep="window")),
                        window_launches(m.grid), f"matrix {matrix_id} window route")


def rel_diff(torch, got, want):
    """max over the arrays of |got - want|, over max|want|: how far one
    factor is from another, relative to the factor's size."""
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    return err / max(b.abs().max().item() for b in want)


def check_window(torch, matrix_id, m, f, fused, launches, rec):
    """The window route's checks on one matrix: the factor residual and the
    logdet against the float64 oracle of ``rec``, the agreement with the
    fused route's factor, a clean status; returns the record."""
    from repro_torch.core import logdet
    Ad = dense_from_ctsf(torch, m, torch.float64, symmetric=True)
    Ld = dense_from_ctsf(torch, f.ctsf, torch.float64, symmetric=False)
    resid = ((Ld @ Ld.mT - Ad).abs().max() / Ad.abs().max()).item()
    del Ad, Ld
    ld = logdet(f).item()
    ld_rel = abs(ld - rec["logdet_oracle"]) / abs(rec["logdet_oracle"])
    agree = rel_diff(torch, f.ctsf.arrays(), fused.ctsf.arrays())
    status = f.status.tolist()
    if not (resid <= RESIDUAL_LIMIT and ld_rel <= 1e-4 and agree <= AGREEMENT_LIMIT
            and status[1:] == [0.0, -1.0]):
        raise AssertionError(f"matrix {matrix_id} window route: residual {resid:.3e} (limit "
                             f"{RESIDUAL_LIMIT}), logdet rel {ld_rel:.3e} (limit 1e-4), "
                             f"agreement with the fused route {agree:.3e} (limit "
                             f"{AGREEMENT_LIMIT}), status {status}")
    return dict(matrix=matrix_id, residual=resid, logdet=ld, logdet_rel_err=ld_rel,
                agreement_with_fused=agree, status=status, launches=launches)


def theta_batch(torch, m, B, seed):
    """B θ-candidates of one matrix on its device, the INLA hyperparameter
    sweep over one sparsity pattern: ``A_θ = τ_θ A + δ_θ I`` with τ in
    [0.5, 2) and δ in [0, 0.5) drawn from ``seed``, so each stays SPD,
    stored as ``BandedCTSF.from_sparse`` stores it (the padding diagonal
    the identity, as in ``m``); returns the stacked BandedCTSF and the (τ,
    δ) pairs."""
    import numpy as np
    from repro_torch.core import BandedCTSF
    from repro_torch.core.ctsf import _padding_diagonal
    rng = np.random.default_rng(seed)
    tau, delta = rng.uniform(0.5, 2.0, B), rng.uniform(0.0, 0.5, B)
    g, dev = m.grid, m.device
    t = g.t
    tt = torch.as_tensor(tau, dtype=torch.float32, device=dev)
    di = torch.as_tensor(delta, dtype=torch.float32, device=dev)[:, None, None, None]
    di = di * torch.eye(t, device=dev)
    Dr = tt[:, None, None, None, None] * m.Dr
    Dr[:, :, 0] += di
    C = tt[:, None, None, None, None] * m.C
    for i in range(g.n_arrow_tiles):
        C[:, i, i] += di[:, 0]
    # τ and δ scale the matrix, not its padding: its diagonal stays 1
    pad, ndt_t = torch.as_tensor(_padding_diagonal(g), device=dev), g.n_diag_tiles * t
    band, arrow = pad[pad < ndt_t], pad[pad >= ndt_t] - ndt_t
    Dr[:, band // t, 0, band % t, band % t] = 1.0
    C[:, arrow // t, arrow // t, arrow % t, arrow % t] = 1.0
    return BandedCTSF(g, Dr, tt[:, None, None, None, None] * m.R, C), list(zip(tau, delta))


def element(mb, i):
    """Element ``i`` of a stacked BandedCTSF, as a matrix of its own."""
    from repro_torch.core import BandedCTSF
    return BandedCTSF(mb.grid, *(x[i] for x in mb.arrays()))


def run_batched(torch, mb5, mb4, plan4, kern_counts):
    """``factorize_window_batched`` on B θ-candidates: the fused and window
    routes on matrix 5's, the partitioned route on matrix 4's; each
    call's launches are checked (one sweep launch for the whole batch, the
    window route one band_update a column).  Returns the factors and the
    launches."""
    from repro_torch.core import SolverOptions, factorize_window_batched
    nat5, nat4 = mb5.grid.n_arrow_tiles, mb4.grid.n_arrow_tiles
    out = {}
    out["fused"] = launch_delta(kern_counts, lambda: factorize_window_batched(mb5),
                                {"band_cholesky_sweep": 1, "potrf": nat5, "trsm": nat5},
                                "batched fused route")
    out["window"] = launch_delta(
        kern_counts, lambda: factorize_window_batched(mb5, options=SolverOptions(sweep="window")),
        window_launches(mb5.grid), "batched window route")
    out["partitioned"] = launch_delta(
        kern_counts,
        lambda: factorize_window_batched(mb4, options=SolverOptions(partition_plan=plan4)),
        {"band_cholesky_partitioned_sweep": 1, "geadd": tree_levels(plan4.n_partitions),
         "potrf": nat4, "trsm": nat4}, "batched partitioned route")
    return out


def check_batched(torch, mb5, mb4, plan4, fbs):
    """Each element of the batched factors against the unbatched call on it.
    Fused and partitioned routes: the batched sweep kernel's panels, arrow
    rows and status word bit for bit the unbatched launch's, and so the
    factor's band and arrow rows; the corner (batched products, summed in
    another order) within 1e-5 relative, and the status word's pivot too.
    Window route: within AGREEMENT_LIMIT.  A clean status everywhere, and
    every element's logdet within 1e-4 relative of the float64 oracle of
    its candidate.  Returns the record."""
    from repro_torch.core import SolverOptions, factorize_window, logdet
    from repro_torch.kernels.band_cholesky import (band_cholesky_partitioned_sweep_cuda,
                                                   band_cholesky_sweep_cuda)
    from repro_torch.kernels.ring import band_row_to_col
    nch = max(1, min(8, mb5.grid.n_diag_tiles))
    sweeps = {"fused": lambda ac, r: band_cholesky_sweep_cuda(ac, r, nchunks=nch),
              "partitioned": lambda ac, r: band_cholesky_partitioned_sweep_cuda(
                  ac, r, plan4.boundaries)}
    # the float64 oracle of each candidate's logdet (the padded dense
    # matrix's; its identity padding adds nothing)
    oracles = {}
    for mb in (mb5, mb4):
        oracles[id(mb)] = []
        for i in range(mb.Dr.shape[0]):
            Ad = dense_from_ctsf(torch, element(mb, i), torch.float64, symmetric=True)
            oracles[id(mb)].append(
                (2.0 * torch.log(torch.diagonal(torch.linalg.cholesky(Ad)))).sum().item())
            del Ad
    rec = {}
    for route, mb, opts in (("fused", mb5, SolverOptions()),
                            ("window", mb5, SolverOptions(sweep="window")),
                            ("partitioned", mb4, SolverOptions(partition_plan=plan4))):
        fb, launches = fbs[route]
        nb = mb.Dr.shape[0]
        worst, same = 0.0, True
        if route in sweeps:
            Ac = band_row_to_col(mb.Dr)
            batched = sweeps[route](Ac, mb.R)
        for i in range(nb):
            one = factorize_window(element(mb, i), options=opts)
            got = [x[i] for x in fb.ctsf.arrays()]
            if route == "window":
                worst = max(worst, rel_diff(torch, got, one.ctsf.arrays()))
                continue
            alone = sweeps[route](Ac[i].contiguous(), mb.R[i].contiguous())
            same &= all(torch.equal(batched[q][i], alone[q]) for q in (0, 1, 3))
            same &= torch.equal(got[0], one.ctsf.Dr) and torch.equal(got[1], one.ctsf.R)
            same &= fb.status[i, 1:].tolist() == one.status[1:].tolist()
            worst = max(worst, rel_diff(torch, got[2:], [one.ctsf.C]),
                        abs(fb.status[i, 0].item() - one.status[0].item())
                        / abs(one.status[0].item()))
        clean = fb.status[:, 1:].tolist() == [[0.0, -1.0]] * nb
        limit = AGREEMENT_LIMIT if route == "window" else 1e-5
        lds = logdet(fb).tolist()
        ld_rel = max(abs(a - b) / abs(b) for a, b in zip(lds, oracles[id(mb)]))
        if not (same and clean and worst <= limit and ld_rel <= 1e-4):
            raise AssertionError(f"batched {route} route: bit-identical sweep and band {same}, "
                                 f"clean {clean}, worst element {worst:.3e} (limit {limit}), "
                                 f"worst logdet rel err {ld_rel:.3e} (limit 1e-4)")
        rec[route] = dict(batch=nb, matrix=5 if mb is mb5 else 4, elementwise=worst,
                          sweep_bit_identical=(route != "window") and same,
                          logdet_rel_err=ld_rel, launches=launches)
    return rec


def check_batched_kernels(torch, ref, mb5, mb4, plan4, fb_window):
    """The batched kernels against their plain versions on the inputs the
    batched routes give them, at TOL: the fused sweep on matrix 5's θ-batch
    and the partitioned sweep on matrix 4's (every output, each element's
    status word); on the window route's batch, band_update on the strided
    windows of the padded band rows at the panel whose update is largest
    (also relative to the update), and the grouped trsm of that panel, one
    L per element against its bt band tiles; the grouped trsm of the
    batched corner's first column, one L per element against its nat
    tiles.  The window route reads at panel k the factor's columns below k
    and the matrix's column k, so those are the operands.  Returns the
    errors and the batched window for the timings."""
    from repro_torch.kernels.band_cholesky import (band_cholesky_partitioned_sweep_cuda,
                                                   band_cholesky_sweep_cuda)
    from repro_torch.kernels.band_update import band_update_cuda
    from repro_torch.kernels.ring import band_row_to_col
    from repro_torch.kernels.trsm import trsm_cuda
    g = mb5.grid
    ndt, bt, t = g.n_diag_tiles, g.band_tiles, g.t
    nb, b1 = mb5.Dr.shape[0], bt + 1
    nch = max(1, min(8, ndt))
    errs = {}
    for name, mb, kernel, plain in (
            ("band_cholesky_sweep", mb5,
             lambda ac, r: band_cholesky_sweep_cuda(ac, r, nchunks=nch),
             lambda ac, r: ref.band_cholesky_sweep_ref(ac, r, nchunks=nch)),
            ("band_cholesky_partitioned_sweep", mb4,
             lambda ac, r: band_cholesky_partitioned_sweep_cuda(ac, r, plan4.boundaries),
             lambda ac, r: ref.band_cholesky_partitioned_sweep_ref(ac, r, plan4.boundaries))):
        Ac = band_row_to_col(mb.Dr)
        got, want = kernel(Ac, mb.R), plain(Ac, mb.R)
        errs[name] = max(assert_close(torch, a, b, f"batched {name} {p}")
                         for a, b, p in zip(got[:3], want[:3], ("panels", "R_out", "schur")))
        for i in range(nb):
            check_status(got[3][i], want[3][i], f"batched {name}, element {i}")
        if name == "band_cholesky_sweep":
            # the batched corner's first column, from the kernel's Schur chunks
            corner = mb.C - got[2].sum(dim=-5)
            lc = ref.potrf_ref(corner[:, 0, 0].contiguous())[:, None].contiguous()
            colc = corner[:, :, 0].contiguous()
            errs["trsm_corner"] = assert_close(torch, trsm_cuda(lc, colc),
                                               ref.trsm_ref(lc, colc), "batched corner trsm")
            errs["trsm_corner_shapes"] = [list(lc.shape), list(colc.shape)]
    zeros = mb5.Dr.new_zeros((nb, bt, b1, t, t))
    Drp_f = torch.cat([fb_window.ctsf.Dr, zeros], dim=1)
    Drp_a = torch.cat([mb5.Dr, zeros], dim=1)
    kwin = max(range(ndt), key=lambda k: ref.band_update_unrolled_ref(
        Drp_f[:, k:k + b1]).abs().max().item())
    w = Drp_f[:, kwin:kwin + b1]
    if w.is_contiguous():
        raise AssertionError("batched band_update: the windows should lie strided in the batch")
    got, want = band_update_cuda(w), ref.band_update_unrolled_ref(w)
    errs["band_update"] = assert_close(torch, got, want, "batched band_update")
    errs["band_update_rel"] = assert_update(got, want, want.abs().max().item(),
                                            "batched band_update")
    for i in range(nb):
        if not torch.equal(got[i], band_update_cuda(w[i])):
            raise AssertionError(f"batched band_update: element {i} not bit-identical to its "
                                 "unbatched launch")
    errs["band_update_bit_identical_per_element"] = True
    diag = torch.arange(1, b1, device=w.device)
    aw = Drp_a[:, kwin:kwin + b1]
    lw = ref.potrf_ref((aw[:, 0, 0] - want[:, 0]).contiguous())[:, None].contiguous()
    colw = (aw[:, diag, diag] - want[:, 1:]).contiguous()
    errs["trsm_window"] = assert_close(torch, trsm_cuda(lw, colw), ref.trsm_ref(lw, colw),
                                       "batched window-route trsm")
    errs["trsm_window_shapes"] = [list(lw.shape), list(colw.shape)]
    errs["band_update_window"] = dict(shape=list(w.shape), panel=kwin,
                                      batch_stride=w.stride(0))
    return errs, w


def theta_rhs(torch, g, nb, k, seed, device):
    """Seeded ``(nb, padded_n, k)`` right-hand sides, zero on the padding
    rows, as run_solves makes them."""
    B = torch.randn((nb, g.padded_n, k), generator=torch.Generator(device=device).manual_seed(
        seed), device=device)
    real = torch.zeros(g.padded_n, dtype=torch.bool, device=device)
    real[:g.structure.n_diag] = True
    real[g.n_diag_tiles * g.t:g.n_diag_tiles * g.t + g.structure.arrow] = True
    B[:, ~real] = 0.0
    return B


def element_factor(fb, i, info=False):
    """Element ``i`` of a batched factor as a factor of its own (its
    status word, and with ``info`` its FactorInfo with the kept matrix's
    element)."""
    from repro_torch.core import BandedCTSF, CholeskyFactor, FactorInfo
    c = fb.ctsf
    fi = None
    if info and fb.info is not None:
        m = fb.info.matrix
        fi = FactorInfo(*(getattr(fb.info, k)[i] for k in (
            "status", "attempts", "tau", "min_pivot", "first_bad_tile")),
            matrix=None if m is None else element(m, i))
    return CholeskyFactor(BandedCTSF(c.grid, *(x[i] for x in c.arrays())), fb.status[i], fi)


def run_theta_read(torch, fb, B32, kern_counts):
    """The θ-batch's read-out on its batched factor ``fb``:
    solve_many_batched at k = 1 and 32 (forward 1, backward 1, solve_panel
    2·nat launches each) and selinv_batched (pre-pass 1, recurrence 1).
    Returns the results and the launches."""
    from repro_torch.core import selinv_batched, solve_many_batched
    nat = fb.ctsf.grid.n_arrow_tiles
    per_solve = {"band_forward_sweep": 1, "band_backward_sweep": 1, "solve_panel": 2 * nat}
    out, launches = {}, {}
    for kk in (1, 32):
        Bk = B32[..., :kk].contiguous()
        out[f"k{kk}"], launches[f"solve_many_batched_k{kk}"] = launch_delta(
            kern_counts, lambda: solve_many_batched(fb, Bk), per_solve,
            f"solve_many_batched k={kk}")
    out["sigma"], launches["selinv_batched"] = launch_delta(
        kern_counts, lambda: selinv_batched(fb), {"selinv_sweep": 1, "selinv_prepass": 1},
        "selinv_batched")
    return out, launches


def float64_solve_gates(torch, m, f, X, Bk, what):
    """run_solves' float64 gates of one solve: the residual ``max|A X - B|
    / (max|A| max|X|)`` against ``m`` and the forward error against
    ``torch.cholesky_solve`` with the float64 factor of ``f``."""
    Ad = dense_from_ctsf(torch, m, torch.float64, symmetric=True)
    Ld = dense_from_ctsf(torch, f.ctsf, torch.float64, symmetric=False)
    X64, B64 = X.double(), Bk.double()
    resid = ((Ad @ X64 - B64).abs().max() / (Ad.abs().max() * X64.abs().max())).item()
    exact = torch.cholesky_solve(B64, Ld)
    fwd = ((X64 - exact).abs().max() / exact.abs().max()).item()
    if not (resid <= RESIDUAL_LIMIT and fwd <= SOLVE_RTOL):
        raise AssertionError(f"{what}: residual {resid:.3e} (limit {RESIDUAL_LIMIT}), forward "
                             f"error {fwd:.3e} (limit {SOLVE_RTOL})")
    return resid, fwd


def sigma_error(torch, f, sigma_arrays):
    """Σ's largest error over its stored band + arrow entries against the
    float64 inverse of the factor ``f``, relative to max|inv| (run_solves'
    gate)."""
    from repro_torch.core import BandedCTSF
    g = f.ctsf.grid
    Ld = dense_from_ctsf(torch, f.ctsf, torch.float64, symmetric=False)
    inv = torch.cholesky_inverse(Ld)
    Sd = dense_from_ctsf(torch, BandedCTSF(g, *sigma_arrays), torch.float64, symmetric=True)
    ones = BandedCTSF(g, *(torch.ones_like(a) for a in sigma_arrays))
    stored = dense_from_ctsf(torch, ones, torch.float64, symmetric=True) > 0
    return ((Sd - inv).abs()[stored].max() / inv.abs().max()).item()


def check_theta_read(torch, mb, fb, B32, out, deferred):
    """The θ-batch's read-out against the port's unbatched calls on each
    element: solve_many on the element's factor and panel, bit for bit
    where the batch's chunk width is the unbatched call's (rtol = atol =
    2e-4 where it is not), selected_inverse on the element's factor; the
    float64 gates on elements 0 and B - 1.  A bit-identity that fails is
    put on ``deferred`` (the run fails at its end, after its timings), a
    tolerance that fails raises.  Returns the record."""
    from repro_torch.core import selected_inverse, solve_many
    from repro_torch.kernels.band_solve import card_solve_plan
    g = mb.grid
    nb = mb.Dr.shape[0]
    rec = {}
    for kk in (1, 32):
        X = out[f"k{kk}"]
        widths = [card_solve_plan(g.t, g.band_tiles, g.n_arrow_tiles, kk, device=X.device,
                                  batch=b).width for b in (nb, 1)]
        same, worst = [], 0.0
        for i in range(nb):
            one = solve_many(element_factor(fb, i), B32[i, :, :kk].contiguous())
            worst = max(worst, assert_close(torch, X[i], one, f"solve_many_batched k={kk}, "
                                            f"element {i} against its unbatched call"))
            same.append(torch.equal(X[i], one))
        rec[f"solve_k{kk}"] = dict(width_batched=widths[0], width_alone=widths[1],
                                   bit_identical=same, max_abs_diff=worst)
        if widths[0] == widths[1] and not all(same):
            off = [i for i, s in enumerate(same) if not s]
            deferred.append(f"solve_many_batched k={kk}: elements {off} not bit-identical to "
                            f"their unbatched calls at the same width {widths[0]}")
        for i in (0, nb - 1):
            rec[f"solve_k{kk}"][f"element_{i}_residual"], rec[f"solve_k{kk}"][
                f"element_{i}_forward_error"] = float64_solve_gates(
                torch, element(mb, i), element_factor(fb, i), X[i], B32[i, :, :kk],
                f"solve_many_batched k={kk} element {i}")
    # selinv_batched: bit for bit the unbatched call wherever the corner
    # seed is (torch.linalg.solve_triangular and a product: cuBLAS's batched
    # forms may add in another order); its two kernels are held to their
    # unbatched launches on the same seed whatever it is
    from repro_torch.core.selinv import corner_sigma
    from repro_torch.kernels.ring import band_row_to_col
    from repro_torch.kernels.selinv import selinv_sweep_cuda
    sig = out["sigma"]
    c = fb.ctsf
    seeds = corner_sigma(c.C)
    lcol = band_row_to_col(c.Dr)
    swept = selinv_sweep_cuda(lcol, c.R, seeds)
    same, seed_same, worst = [], [], 0.0
    for i in range(nb):
        one = selected_inverse(element_factor(fb, i))
        for a, b, part in zip(sig.arrays(), one.arrays(), ("Dr", "R", "C")):
            worst = max(worst, assert_close(torch, a[i], b, f"selinv_batched element {i} {part} "
                                            "against its unbatched call"))
        same.append(all(torch.equal(a[i], b) for a, b in zip(sig.arrays(), one.arrays())))
        seed_same.append(torch.equal(seeds[i], corner_sigma(c.C[i])))
        alone = selinv_sweep_cuda(lcol[i], c.R[i], seeds[i])
        if not all(torch.equal(a[i], b) for a, b in zip(swept, alone)):
            raise AssertionError(f"selinv_batched element {i}: the batched sweep on the batch's "
                                 "corner seed is not bit-identical to its unbatched launch")
    rec["selinv"] = dict(bit_identical=same, corner_seed_bit_identical=seed_same,
                         sweep_bit_identical_on_the_same_seed=True, max_abs_diff=worst)
    off = [i for i in range(nb) if seed_same[i] and not same[i]]
    if off:
        deferred.append(f"selinv_batched: elements {off} not bit-identical to their unbatched "
                        "calls with the same corner seed")
    for i in (0, nb - 1):
        err = sigma_error(torch, element_factor(fb, i), [x[i] for x in sig.arrays()])
        rec["selinv"][f"element_{i}_sigma_error"] = err
        if not err <= SIGMA_LIMIT:
            raise AssertionError(f"selinv_batched element {i}: Σ error {err:.3e} of max|Σ| "
                                 f"(limit {SIGMA_LIMIT})")
    diag = sig.diagonal()
    if diag.shape != (nb, g.structure.n) or sig.covariance(0, 1).shape != (nb,):
        raise AssertionError(f"selinv_batched: diagonal {tuple(diag.shape)} and covariance "
                             "do not broadcast over the batch")
    return rec


def faulted_theta_batch(torch, mb):
    """The θ-batch with element INDEFINITE made indefinite (one band
    diagonal tile dropped by 10 x the element's mean |band diagonal|, as
    tests/test_robustness.py::_corrupt_diag) and element NAN_ELEMENT given
    a NaN on one structural nonzero of an arrow row (its largest entry; the
    arrow rows hold both halves of the symmetric matrix).  Returns the
    stacked BandedCTSF and the corrupted band tile."""
    from repro_torch.core import BandedCTSF
    Dr, R, C = (x.clone() for x in mb.arrays())
    g = mb.grid
    tile = g.n_diag_tiles // 2
    d = torch.diagonal(Dr[INDEFINITE, :, 0], dim1=-2, dim2=-1)
    Dr[INDEFINITE, tile, 0] -= 10.0 * d.abs().mean() * torch.eye(g.t, device=Dr.device)
    flat = R[NAN_ELEMENT].reshape(-1)
    flat[flat.abs().argmax()] = float("nan")
    return BandedCTSF(g, Dr, R, C), tile


def run_recovery(torch, mbf, m5, B32, kern_counts):
    """Breakdown recovery on matrix 5's θ-batch with its two faults:
    factorize_window_batched(regularize=True), then solve_many_batched at
    k = 32 on the recovered batch (the refinement pass: one more forward
    and backward sweep, 2·nat more solve_panel), then solve_many on
    matrix 5's factor of ``A + tau I`` (tau = 1e-2 diag_scale) with a
    hand-built FactorInfo keeping A (one refinement step alike).  Returns
    the results and the launches."""
    from repro_torch.core import (STATUS_RECOVERED, BandedCTSF, CholeskyFactor, FactorInfo,
                                  SolverOptions, factorize_window, factorize_window_batched,
                                  solve_many, solve_many_batched)
    from repro_torch.core.robustness import add_diagonal_jitter, diag_scale
    g = mbf.grid
    nat = g.n_arrow_tiles
    launches = {}
    # the ladder's attempts are known after the call: one launch sequence
    # (sweep, nat potrf, nat trsm) for the whole batch an attempt
    before = kern_counts()
    frec = factorize_window_batched(mbf, options=SolverOptions(regularize=True))
    after = kern_counts()
    rounds = int(frec.info.attempts.max())
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    want = {"band_cholesky_sweep": rounds, "potrf": rounds * nat, "trsm": rounds * nat}
    if got != want:
        raise AssertionError(f"regularized factorize_window_batched: launches {got} != {want} "
                             f"({rounds} attempts)")
    launches["factorize_window_batched_regularized"] = got
    refined = {"band_forward_sweep": 2, "band_backward_sweep": 2, "solve_panel": 4 * nat}
    X, launches["solve_many_batched_recovered"] = launch_delta(
        kern_counts, lambda: solve_many_batched(frec, B32), refined,
        "solve_many_batched on the recovered batch")
    tau = 1e-2 * diag_scale(m5.Dr, m5.C, g)
    DrJ, CJ = add_diagonal_jitter(m5.Dr, m5.C, g, tau)
    fJ = factorize_window(BandedCTSF(g, DrJ, m5.R, CJ))
    info = FactorInfo(status=torch.tensor(STATUS_RECOVERED, dtype=torch.int32, device=tau.device),
                      attempts=torch.tensor(2, dtype=torch.int32, device=tau.device), tau=tau,
                      min_pivot=fJ.status[0], first_bad_tile=torch.tensor(
                          0, dtype=torch.int32, device=tau.device), matrix=m5)
    B0 = B32[0]
    X1, launches["solve_many_refined"] = launch_delta(
        kern_counts, lambda: solve_many(CholeskyFactor(fJ.ctsf, fJ.status, info), B0), refined,
        "solve_many with a hand-built FactorInfo")
    return dict(factor=frec, X=X, fJ=fJ, X1=X1, tau=tau.item()), launches


def column_residuals(torch, m, X, Bk):
    """Each column's 2-norm residual ``|A x - b|`` against the matrix ``m``,
    in float64."""
    Ad = dense_from_ctsf(torch, m, torch.float64, symmetric=True)
    return torch.linalg.vector_norm(Ad @ X.double() - Bk.double(), dim=0)


def check_recovery(torch, mb, mbf, tile, m5, B32, res):
    """The recovery path's gates: statuses OK but RECOVERED at INDEFINITE
    and FAILED at NAN_ELEMENT, tau > 0 there, first_bad_tile -1 on the
    clean elements; healthy elements bit for bit the unregularized batched
    call; the recovered factor's residual against its jittered matrix ≤
    1e-4; the refined batched solve's clean elements bit for bit an
    unrefined call's and the recovered element's residual against its
    original matrix at most the unrefined one in every column; the same
    column rule for the unbatched refinement.  Returns the record."""
    from repro_torch.core import (STATUS_FAILED, STATUS_OK, STATUS_RECOVERED, BandedCTSF,
                                  CholeskyFactor, factorize_window_batched, solve_many,
                                  solve_many_batched)
    from repro_torch.core.robustness import add_diagonal_jitter
    frec = res["factor"]
    info = frec.info
    nb = mbf.Dr.shape[0]
    want = [STATUS_OK] * nb
    want[INDEFINITE], want[NAN_ELEMENT] = STATUS_RECOVERED, STATUS_FAILED
    clean = [i for i in range(nb) if want[i] == STATUS_OK]
    status = info.status.tolist()
    first_bad = info.first_bad_tile.tolist()
    tau = info.tau.tolist()
    if status != want or not tau[INDEFINITE] > 0 or any(first_bad[i] != -1 for i in clean):
        raise AssertionError(f"recovery: status {status} (want {want}), tau {tau}, "
                             f"first_bad_tile {first_bad}")
    plain = factorize_window_batched(mbf)
    if not all(torch.equal(a[clean], b[clean]) for a, b in zip(frec.ctsf.arrays(),
                                                                plain.ctsf.arrays())):
        raise AssertionError("recovery: a healthy element is not bit-identical to the "
                             "unregularized batched call")
    # the recovered factor against its jittered matrix A + tau I
    e = element(mbf, INDEFINITE)
    DrJ, CJ = add_diagonal_jitter(e.Dr, e.C, e.grid, info.tau[INDEFINITE])
    Ad = dense_from_ctsf(torch, BandedCTSF(e.grid, DrJ, e.R, CJ), torch.float64, symmetric=True)
    Ld = dense_from_ctsf(torch, element_factor(frec, INDEFINITE).ctsf, torch.float64,
                         symmetric=False)
    resid = ((Ld @ Ld.mT - Ad).abs().max() / Ad.abs().max()).item()
    del Ad, Ld
    if not resid <= RESIDUAL_LIMIT:
        raise AssertionError(f"recovery: element {INDEFINITE}'s factor residual {resid:.3e} "
                             f"against A + tau I (limit {RESIDUAL_LIMIT})")
    # the refined batched solve against an unrefined one
    X = res["X"]
    unrefined = solve_many_batched(CholeskyFactor(frec.ctsf, frec.status), B32)
    if not all(torch.equal(X[i], unrefined[i]) for i in clean):
        raise AssertionError("recovery: a clean element of the refined solve is not "
                             "bit-identical to the unrefined call")
    r_ref = column_residuals(torch, e, X[INDEFINITE], B32[INDEFINITE])
    r_plain = column_residuals(torch, e, unrefined[INDEFINITE], B32[INDEFINITE])
    if not bool((r_ref <= r_plain).all()):
        raise AssertionError(f"recovery: the refined residual exceeds the unrefined one in "
                             f"columns {torch.nonzero(r_ref > r_plain).flatten().tolist()}")
    # the unbatched refinement, hand-built FactorInfo on matrix 5
    B0 = B32[0]
    u_ref = column_residuals(torch, m5, res["X1"], B0)
    u_plain = column_residuals(torch, m5, solve_many(res["fJ"], B0), B0)
    if not bool((u_ref <= u_plain).all()):
        raise AssertionError(f"unbatched refinement: the refined residual exceeds the "
                             f"unrefined one in columns "
                             f"{torch.nonzero(u_ref > u_plain).flatten().tolist()}")
    return dict(status=status, attempts=info.attempts.tolist(), tau=tau,
                first_bad_tile=first_bad, corrupted_tile=tile, recovered_factor_residual=resid,
                refined_columns_taken=int((r_ref < r_plain).sum()),
                refined_residual_max=r_ref.max().item(), unrefined_residual_max=r_plain.max().item(),
                unbatched_tau=res["tau"], unbatched_refined_residual_max=u_ref.max().item(),
                unbatched_unrefined_residual_max=u_plain.max().item(),
                unbatched_columns_improved=int((u_ref < u_plain).sum()))


def band_update_gathered(torch, w):
    """The operands of band_update's library yardstick for windows ``w
    (..., b+1, b+1, t, t)``, gathered beforehand as ``band_update_ref``
    gathers them: ``(wsh, rhs)``, ``wsh[..., e, j] = w[..., e, e+j]`` where
    ``e + j <= b`` and ``j >= 1`` (else zero) and ``rhs[..., j] = w[..., 0,
    j]`` where ``j >= 1``, so that one ``torch.einsum("...ejab,...jcb->...eac",
    wsh, rhs)`` is the update."""
    b1 = w.shape[-4]
    idx = torch.arange(b1, device=w.device)
    wsh = w[..., idx[:, None], (idx[:, None] + idx[None, :]).clamp(max=b1 - 1), :, :]
    wsh = wsh * ((idx[:, None] + idx[None, :] < b1) & (idx[None, :] >= 1))[..., None, None]
    rhs = w[..., 0, :, :, :] * (idx >= 1)[:, None, None]
    return wsh.contiguous(), rhs.contiguous()


def deterministic(torch, fn, what):
    """Two launches of ``fn`` on the same inputs give the same bits."""
    if not torch.equal(fn(), fn()):
        raise AssertionError(f"{what}: two launches on the same input differ")
    return True


def capped_launch(torch, name, max_cluster, *tensors):
    """``name`` ("selinv_step" or "band_update", one window) launched on the
    plan ``tile_sum_plan(max_cluster=max_cluster)``, for the timing beside
    the wrapper's plan: 1 is the plan without the contraction split, one
    block a sub-tile over its whole chain.  Calls the C entry point
    directly, so it counts no launch.  Returns ``(fn, plan)``; ``fn()``
    returns the result."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.tile_sum import tile_sum_plan
    lib = _build.load(name)
    a = tensors[0]
    t = a.shape[-1]
    if name == "selinv_step":
        e_n, j_n = a.shape[:2]
        plan = tile_sum_plan(t, [j_n] * e_n, max_cluster=max_cluster)
        u = a.new_empty((e_n, t, t))
        call = lambda s: lib.stiles_selinv_step_f32(
            a.data_ptr(), tensors[1].data_ptr(), u.data_ptr(), e_n, j_n, t, plan.sub,
            plan.cluster, plan.per_rank, s)
    else:
        b1 = a.shape[0]
        plan = tile_sum_plan(t, [b1 - 1 - e for e in range(b1)], 1, max_cluster=max_cluster)
        u = a.new_empty((b1, t, t))
        call = lambda s: lib.stiles_band_update_f32(
            a.data_ptr(), u.data_ptr(), 1, b1, t, a.numel(), plan.sub, plan.cluster,
            plan.per_rank, s)

    def fn():
        _build.check(lib, call(torch.cuda.current_stream().cuda_stream),
                     f"{name}, clusters of at most {max_cluster}")
        return u
    return fn, plan


def takahashi_column(torch, f, sigma, j):
    """The operands of one column's Takahashi step, built from the factor
    ``f`` and its selected inverse ``sigma`` exactly as
    ``ref.selinv_sweep_ref`` builds them: ``(srow (bt+nat, bt+nat, t, t),
    gcat (bt+nat, t, t), want)``, ``want`` the column's Σ tiles below the
    diagonal and in the arrow, which ``-selinv_step(srow, gcat)`` gives."""
    from repro_torch.core.selinv import corner_sigma
    from repro_torch.kernels import ref
    from repro_torch.kernels.ring import band_row_to_col
    g = f.ctsf.grid
    bt, nat, t = g.band_tiles, g.n_arrow_tiles, g.t
    lcol, panels, acols = band_row_to_col(f.ctsf.Dr), band_row_to_col(sigma.Dr), sigma.R
    winv = ref.solve_panel_ref(lcol[j, 0], torch.eye(t, device=lcol.device))
    gcat = torch.cat([lcol[j, 1:] @ winv, f.ctsf.R[j] @ winv])
    srow = lcol.new_zeros((bt + nat, bt + nat, t, t))
    for e in range(1, bt + 1):
        for d in range(1, bt + 1):
            srow[e - 1, d - 1] = panels[j + d, e - d] if e >= d else panels[j + e, d - e].mT
        srow[e - 1, bt:] = acols[j + e].mT
    for d in range(1, bt + 1):
        srow[bt:, d - 1] = acols[j + d]
    srow[bt:, bt:] = corner_sigma(f.ctsf.C)
    return srow, gcat.contiguous(), torch.cat([panels[j, 1:], acols[j]])


# ---------------------------------------------------------------------------
# phase 3, bucketing: canonical-grid bucketing at full width
# ---------------------------------------------------------------------------

def close_all(torch, got, want, what, tol=TOL):
    """``assert_close`` over matching sequences of tensors; the largest
    difference."""
    return max(assert_close(torch, a, b, f"{what} [{i}]", tol=tol)
               for i, (a, b) in enumerate(zip(got, want)))


def logdet_gate(got, want, what):
    """The logdets' relative difference, at most LOGDET_RTOL."""
    rel = ((got - want).abs() / want.abs()).max().item()
    if not rel <= LOGDET_RTOL:
        raise AssertionError(f"{what}: logdet relative difference {rel:.3e} "
                             f"(limit {LOGDET_RTOL})")
    return rel


def run_bucketed_main(torch, m, kern_counts):
    """Table II matrix 5 under ``GridBucketPolicy()``: factorize_window ->
    logdet -> solve (k = 1) -> solve_many (k = 32) -> sample_gmrf_many (32
    draws) -> selected_inverse -> marginal_variances (both methods), each
    with the launches of the plain path's call.  Returns the embedded
    factor, the results and the launches."""
    from repro_torch.core import (GridBucketPolicy, SolverOptions, factorize_window, logdet,
                                  marginal_variances, sample_gmrf_many, selected_inverse,
                                  solve, solve_many)
    pol = SolverOptions(policy=GridBucketPolicy())
    g = m.grid
    nat, n, dev = g.n_arrow_tiles, g.structure.n, m.device
    per_solve = {"band_forward_sweep": 1, "band_backward_sweep": 1, "solve_panel": 2 * nat}
    launches, out = {}, {}
    fp, launches["factorize_window"] = launch_delta(
        kern_counts, lambda: factorize_window(m, options=pol),
        {"band_cholesky_sweep": 1, "potrf": nat, "trsm": nat}, "bucketed factorize_window")
    out["logdet"] = logdet(fp)
    out["B"] = B = theta_rhs(torch, g, 1, 32, seed=21, device=dev)[0]
    out["solve"], launches["solve"] = launch_delta(
        kern_counts, lambda: solve(fp, B[:, 0]), per_solve, "bucketed solve")
    out["solve_many"], launches["solve_many"] = launch_delta(
        kern_counts, lambda: solve_many(fp, B), per_solve, "bucketed solve_many")
    out["draws"], launches["sample_gmrf_many"] = launch_delta(
        kern_counts, lambda: sample_gmrf_many(fp, num=32, generator=torch.Generator(
            device=dev).manual_seed(7)),
        {"band_backward_sweep": 1, "solve_panel": nat}, "bucketed sample_gmrf_many")
    out["sigma"], launches["selected_inverse"] = launch_delta(
        kern_counts, lambda: selected_inverse(fp), {"selinv_sweep": 1, "selinv_prepass": 1},
        "bucketed selected_inverse")
    out["idx"] = idx = [0, n // 2, n - g.structure.arrow, n - 1]
    for method, expect in (("selinv", {"selinv_sweep": 1, "selinv_prepass": 1}),
                           ("panels", {"band_forward_sweep": 1, "solve_panel": nat})):
        opts = SolverOptions(policy=GridBucketPolicy(), method=method)
        out[method], launches[f"marginal_variances_{method}"] = launch_delta(
            kern_counts, lambda: marginal_variances(fp, idx, options=opts), expect,
            f"bucketed marginal_variances {method}")
    return fp, out, launches


def check_bucketed_main(torch, m, f, fp, out):
    """Every result of :func:`run_bucketed_main`, in the source layout,
    against the same call on the plain factor ``f`` of phase 3 (whose
    float64 gates it passed), at rtol = atol = TOL, logdet to LOGDET_RTOL
    relative; the draws bit for bit or at TOL (recorded).  Returns the
    record."""
    from repro_torch.core import (SolverOptions, logdet, marginal_variances, sample_gmrf_many,
                                  selected_inverse, solve, solve_many)
    g, cg = m.grid, fp.ctsf.grid
    rec = dict(source=[g.n_diag_tiles, g.band_tiles, g.n_arrow_tiles],
               canonical=[cg.n_diag_tiles, cg.band_tiles, cg.n_arrow_tiles],
               pad=cg.n_diag_tiles - g.n_diag_tiles, status=fp.status.tolist())
    if fp.source_grid != g or rec["status"][1:] != [0.0, -1.0]:
        raise AssertionError(f"bucketed factorize_window: source grid or status wrong: {rec}")
    rec["factor_max_abs_diff"] = close_all(torch, fp.restrict().ctsf.arrays(), f.ctsf.arrays(),
                                           "bucketed factor against the plain factor")
    rec["logdet_rel_diff"] = logdet_gate(out["logdet"], logdet(f), "bucketed factorize_window")
    B = out["B"]
    rec["solve_max_abs_diff"] = assert_close(torch, out["solve"], solve(f, B[:, 0]),
                                             "bucketed solve")
    rec["solve_many_max_abs_diff"] = assert_close(torch, out["solve_many"], solve_many(f, B),
                                                  "bucketed solve_many")
    draws = sample_gmrf_many(f, num=32, generator=torch.Generator(
        device=m.device).manual_seed(7))
    rec["draws_bit_identical"] = torch.equal(out["draws"], draws)
    rec["draws_max_abs_diff"] = assert_close(torch, out["draws"], draws,
                                             "bucketed sample_gmrf_many")
    if out["sigma"].grid != g:
        raise AssertionError("bucketed selected_inverse: Σ not on the source grid")
    rec["sigma_max_abs_diff"] = close_all(torch, out["sigma"].arrays(),
                                          selected_inverse(f).arrays(),
                                          "bucketed selected_inverse")
    for method in ("selinv", "panels"):
        rec[f"variances_{method}_max_abs_diff"] = assert_close(
            torch, out[method], marginal_variances(f, out["idx"], options=SolverOptions(
                method=method)), f"bucketed marginal_variances {method}")
    return rec


def run_bucketed_routes(torch, m5, wf5, m4, plan4, pf4, kern_counts):
    """The other routes under the policy: Table II #4's partitioned route
    with its plan shifted past the prefix (one partitioned sweep, a geadd a
    tree level) and #5's window route (the source grid's launches: the
    prefix columns launch nothing); each factor restricted against its
    plain route's factor, at TOL.  Returns the record."""
    from repro_torch.core import GridBucketPolicy, SolverOptions, factorize_window
    pol = GridBucketPolicy()
    nat4 = m4.grid.n_arrow_tiles
    f4, l4 = launch_delta(
        kern_counts, lambda: factorize_window(m4, options=SolverOptions(
            partition_plan=plan4, policy=pol)),
        {"band_cholesky_partitioned_sweep": 1, "geadd": tree_levels(plan4.n_partitions),
         "potrf": nat4, "trsm": nat4}, "bucketed partitioned factorize_window")
    pad4 = f4.ctsf.grid.n_diag_tiles - m4.grid.n_diag_tiles
    w5, l5 = launch_delta(
        kern_counts, lambda: factorize_window(m5, options=SolverOptions(sweep="window",
                                                                        policy=pol)),
        window_launches(m5.grid), "bucketed window route")
    cg4 = f4.ctsf.grid
    return dict(
        partitioned=dict(matrix=PARTITIONED_IDS[0], launches=l4,
                         canonical=[cg4.n_diag_tiles, cg4.band_tiles, cg4.n_arrow_tiles],
                         shifted_boundaries=list(plan4.shifted(pad4).boundaries),
                         max_abs_diff=close_all(torch, f4.restrict().ctsf.arrays(),
                                                pf4.ctsf.arrays(), "bucketed partitioned")),
        window=dict(matrix=TABLE2_IDS[0], launches=l5,
                    max_abs_diff=close_all(torch, w5.restrict().ctsf.arrays(),
                                           wf5.ctsf.arrays(), "bucketed window route")))


def stream_matrices(torch):
    """The mixed stream on one rung: ``make_arrowhead`` with Table II #5's
    bandwidth and arrow (200, 200) at each of STREAM_NS, t = 64, seed 0, on
    the card; each with its θ-batch of BATCH and seeded panels (k = 32)."""
    from repro_torch.core import BandedCTSF, TileGrid
    from repro_torch.data import make_arrowhead
    out = []
    for i, n in enumerate(STREAM_NS):
        A, st = make_arrowhead(n, 200, 200, seed=0)
        m = BandedCTSF.from_sparse(A, TileGrid(st, t=64))
        mb, _ = theta_batch(torch, m, BATCH, seed=100 + i)
        out.append((m, mb, theta_rhs(torch, m.grid, BATCH, 32, seed=200 + i, device=m.device)))
    return out


def batched_caches():
    from repro_torch.core.cholesky import _BATCHED_WINDOW_CACHE
    from repro_torch.core.selinv import _BATCHED_SELINV_CACHE
    from repro_torch.core.solve import _BATCHED_SOLVE_CACHE
    return {"batched_window": _BATCHED_WINDOW_CACHE, "batched_solve": _BATCHED_SOLVE_CACHE,
            "batched_selinv": _BATCHED_SELINV_CACHE}


def run_stream(torch, stream, kern_counts):
    """Each grid of the stream as a θ-batch through
    factorize_window_batched(policy) -> solve_many_batched (k = 32) ->
    selinv_batched, with one call's launches each; the three caches gain one
    entry each over the stream, and the corner's graphs (cleared first) are
    captured for the first grid only.  Returns the results and the
    record."""
    from repro_torch.core import (GridBucketPolicy, SolverOptions, factorize_window_batched,
                                  selinv_batched, solve_many_batched)
    from repro_torch.core.solve import corner_graphs
    pol = SolverOptions(policy=GridBucketPolicy())
    caches = batched_caches()
    before = {k: set(c.keys()) for k, c in caches.items()}
    corner_graphs.clear()
    outs, captures, rec = [], [], []
    for m, mb, B in stream:
        nat = m.grid.n_arrow_tiles
        c0 = corner_graphs.captures
        fb, lf = launch_delta(kern_counts, lambda: factorize_window_batched(mb, options=pol),
                              {"band_cholesky_sweep": 1, "potrf": nat, "trsm": nat},
                              "stream factorize_window_batched")
        X, ls = launch_delta(kern_counts, lambda: solve_many_batched(fb, B),
                             {"band_forward_sweep": 1, "band_backward_sweep": 1,
                              "solve_panel": 2 * nat}, "stream solve_many_batched")
        S, lsel = launch_delta(kern_counts, lambda: selinv_batched(fb),
                               {"selinv_sweep": 1, "selinv_prepass": 1}, "stream selinv_batched")
        captures.append(corner_graphs.captures - c0)
        g, cg = m.grid, fb.ctsf.grid
        rec.append(dict(n=g.structure.n, source=[g.n_diag_tiles, g.band_tiles, nat],
                        canonical=[cg.n_diag_tiles, cg.band_tiles, cg.n_arrow_tiles],
                        pad=cg.n_diag_tiles - g.n_diag_tiles, corner_captures=captures[-1],
                        launches=dict(factorize_window_batched=lf, solve_many_batched=ls,
                                      selinv_batched=lsel)))
        outs.append((fb, X, S))
    added = {k: len(set(c.keys()) - before[k]) for k, c in caches.items()}
    if any(v != 1 for v in added.values()):
        raise AssertionError(f"the stream added {added} cache entries, want one each")
    if captures[0] != 2 or any(captures[1:]):
        raise AssertionError(f"the stream's corner graphs were captured {captures} times a "
                             "grid, want 2 (k = 32 both ways) for the first and none after")
    if len({tuple(r["canonical"]) for r in rec}) != 1:
        raise AssertionError(f"the stream is not on one rung: {rec}")
    return outs, dict(grids=rec, cache_entries_added=added,
                      cache_stats={k: c.stats() for k, c in caches.items()})


def check_stream(torch, stream, outs):
    """Each element of the stream's bucketed results against the
    unbucketed calls on its θ-batch, at TOL."""
    from repro_torch.core import factorize_window_batched, selinv_batched, solve_many_batched
    errs = []
    for (m, mb, B), (fb, X, S) in zip(stream, outs):
        f0 = factorize_window_batched(mb)
        what = f"stream n={m.grid.structure.n}"
        errs.append(dict(
            n=m.grid.structure.n,
            factor=close_all(torch, fb.restrict().ctsf.arrays(), f0.ctsf.arrays(),
                             f"{what} factor"),
            logdet_rel=logdet_gate(fb.logdet(), f0.logdet(), what),
            solve=assert_close(torch, X, solve_many_batched(f0, B), f"{what} solve"),
            sigma=close_all(torch, S.arrays(), selinv_batched(f0).arrays(), f"{what} Σ")))
    return errs


def run_stacked(torch, mats, kern_counts):
    """``stack_ctsf([#5, #4, #2], policy)`` on their join and the concurrent
    entry points on it, each one call's launches for the three (the
    concurrent solve one sweep launch each way for all three, with B
    shared).  Returns the results and the launches."""
    from repro_torch.core import GridBucketPolicy, SolverOptions
    from repro_torch.core.concurrent import (concurrent_factorize, concurrent_logdet,
                                             concurrent_quadratic_forms, concurrent_selinv,
                                             concurrent_solve, stack_ctsf)
    pol = GridBucketPolicy()
    stacked = stack_ctsf([m for m, _ in mats], policy=pol)
    cg = stacked.grid
    nat = cg.n_arrow_tiles
    B = torch.randn((cg.padded_n, 32), generator=torch.Generator(
        device=stacked.device).manual_seed(31), device=stacked.device)
    launches = {}
    f, launches["concurrent_factorize"] = launch_delta(
        kern_counts, lambda: concurrent_factorize(stacked, options=SolverOptions(policy=pol)),
        {"band_cholesky_sweep": 1, "potrf": nat, "trsm": nat}, "concurrent_factorize")
    ld = concurrent_logdet(f)
    X, launches["concurrent_solve"] = launch_delta(
        kern_counts, lambda: concurrent_solve(f, B),
        {"band_forward_sweep": 1, "band_backward_sweep": 1, "solve_panel": 2 * nat},
        "concurrent_solve")
    q, launches["concurrent_quadratic_forms"] = launch_delta(
        kern_counts, lambda: concurrent_quadratic_forms(f, B[:, 0]),
        {"band_forward_sweep": 1, "solve_panel": nat}, "concurrent_quadratic_forms")
    S, launches["concurrent_selinv"] = launch_delta(
        kern_counts, lambda: concurrent_selinv(f), {"selinv_sweep": 1, "selinv_prepass": 1},
        "concurrent_selinv")
    return (stacked, f, ld, B, X, q, S), launches


def check_stacked(torch, mats, out):
    """Each element of the stacked batch, restricted to its own source
    grid, against its own plain factor and read-out at TOL (logdet to
    LOGDET_RTOL); the quadratic form against ``r^T A^{-1} r`` plus the
    identity rows' ``|y|^2``."""
    from repro_torch.core import (logdet, restrict_rhs, restrict_selinv, selected_inverse,
                                  solve_many)
    from repro_torch.core.gridpolicy import restrict_factor
    stacked, f, ld, B, X, q, S = out
    cg = stacked.grid
    errs = []
    for i, (m, f0) in enumerate(mats):
        g = m.grid
        what = f"stacked element {i}"
        fi = restrict_factor(element_factor(f, i), g)
        r = restrict_rhs(B, g, cg)
        x0 = solve_many(f0, r)
        y, ry = B[:, 0], r[:, 0]
        want_q = (ry * x0[:, 0]).sum() + (y * y).sum() - (ry * ry).sum()
        errs.append(dict(
            source=[g.n_diag_tiles, g.band_tiles, g.n_arrow_tiles],
            factor=close_all(torch, fi.ctsf.arrays(), f0.ctsf.arrays(), f"{what} factor"),
            logdet_rel=logdet_gate(ld[i], logdet(f0), what),
            solve=assert_close(torch, restrict_rhs(X[i], g, cg), x0, f"{what} solve"),
            quadratic_form_rel=abs((q[i] - want_q) / want_q).item(),
            sigma=close_all(torch, restrict_selinv(
                type(S)(cg, *(a[i] for a in S.arrays())), g).arrays(),
                selected_inverse(f0).arrays(), f"{what} Σ")))
        if not errs[-1]["quadratic_form_rel"] <= TOL:
            raise AssertionError(f"{what}: quadratic form {errs[-1]['quadratic_form_rel']:.3e} "
                                 f"from r^T A^-1 r (limit {TOL})")
    return dict(canonical=[cg.n_diag_tiles, cg.band_tiles, cg.n_arrow_tiles], elements=errs)


class SweepBatches:
    """Records the batch of every band-Cholesky sweep launched through
    ``kernels.ops`` while it is entered (the wrapper's own count is kept)."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        from repro_torch.kernels import ops
        self.real = ops.band_cholesky_sweep_cuda

        def spy(Ac, *a, **k):
            self.seen.append(Ac.shape[0] if Ac.dim() == 5 else None)
            return self.real(Ac, *a, **k)

        ops.band_cholesky_sweep_cuda = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.band_cholesky_sweep_cuda = self.real


def run_bucket(torch, mb5, B32, kern_counts):
    """``bucket=True`` on a θ-batch of 5 of #5: one sweep launch of 8, then
    solve_many_batched and selinv_batched on its factor; then
    solve_many_batched on batches of 5, 6, 7 and 8 of it with bucket=True,
    the corner's graphs (cleared first) captured once for all four.
    Returns the results and the record."""
    from repro_torch.core import (BandedCTSF, factorize_window_batched, selinv_batched,
                                  solve_many_batched)
    from repro_torch.core.solve import corner_graphs
    nat = mb5.grid.n_arrow_tiles
    five = BandedCTSF(mb5.grid, *(x[:5] for x in mb5.arrays()))
    with SweepBatches() as spy:
        fb, lf = launch_delta(kern_counts, lambda: factorize_window_batched(five, bucket=True),
                              {"band_cholesky_sweep": 1, "potrf": nat, "trsm": nat},
                              "bucket=True factorize_window_batched")
    if spy.seen != [BATCH]:
        raise AssertionError(f"bucket=True on a batch of 5: sweeps of {spy.seen}, want one of "
                             f"{BATCH}")
    per_solve = {"band_forward_sweep": 1, "band_backward_sweep": 1, "solve_panel": 2 * nat}
    corner_graphs.clear()
    captures = []
    X = {}
    for nb in (5, 6, 7, 8):
        c0 = corner_graphs.captures
        fbn = fb if nb == 5 else factorize_window_batched(
            BandedCTSF(mb5.grid, *(x[:nb] for x in mb5.arrays())))
        X[nb], _ = launch_delta(kern_counts, lambda: solve_many_batched(
            fbn, B32[:nb], bucket=True), per_solve, f"bucket=True solve_many_batched, {nb}")
        captures.append(corner_graphs.captures - c0)
    if captures != [2, 0, 0, 0]:
        raise AssertionError(f"bucket=True solves of 5, 6, 7 and 8 captured {captures} corner "
                             "graphs, want 2 (k = 32 both ways) for 5 and none after")
    S, ls = launch_delta(kern_counts, lambda: selinv_batched(fb, bucket=True),
                         {"selinv_sweep": 1, "selinv_prepass": 1}, "bucket=True selinv_batched")
    return (five, fb, X[5], S), dict(sweep_batches=spy.seen, corner_captures=captures,
                                     launches=dict(factorize_window_batched=lf,
                                                   selinv_batched=ls))


def check_bucket(torch, out, B32, deferred):
    """The batch of 5 with bucket=True against bucket=False: the factor,
    its status and logdet, the k = 32 solves and Σ, each bit for bit (a
    failure is deferred to after the timings, as phase 3's bit-identity
    gates are) and at TOL."""
    from repro_torch.core import factorize_window_batched, selinv_batched, solve_many_batched
    five, fb, X, S = out
    f0 = factorize_window_batched(five, bucket=False)
    X0 = solve_many_batched(f0, B32[:5], bucket=False)
    S0 = selinv_batched(f0, bucket=False)
    rec = {}
    for name, got, want in (("factor", fb.ctsf.arrays() + (fb.status, fb.logdet()),
                             f0.ctsf.arrays() + (f0.status, f0.logdet())),
                            ("solve_many_batched_k32", (X,), (X0,)),
                            ("selinv_batched", S.arrays(), S0.arrays())):
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        rec[name] = dict(bit_identical=same,
                         max_abs_diff=close_all(torch, got, want, f"bucket=True {name}"))
        if not same:
            deferred.append(f"bucket=True {name}: not bit-identical to bucket=False "
                            f"(max diff {rec[name]['max_abs_diff']:.3e})")
    return rec


def time_bucketing(torch, m, f, fp, stream, mb5, card):
    """Canonical grid against source grid on Table II #5, call time (CUDA
    events around the calls) and device time (around a CUDA graph's
    replay), medians of 7: factorize_window + logdet, the sweep alone (and
    the canonical sweep with no prefix skipped), solve_many at k = 32 and
    selected_inverse; the padded flop overhead of each grid of the stream;
    factorize_window_batched on a batch of 5 with bucket=True (run as 8)
    against bucket=False."""
    from repro_torch.core import (BandedCTSF, GridBucketPolicy, SolverOptions, embed_ctsf,
                                  factorize_window, factorize_window_batched, logdet,
                                  padded_flop_overhead, selected_inverse, solve_many)
    from repro_torch.kernels.band_cholesky import band_cholesky_sweep_cuda
    from repro_torch.kernels.ring import band_row_to_col
    pol = GridBucketPolicy()
    opts = SolverOptions(policy=pol)
    g = m.grid
    emb = embed_ctsf(m, fp.ctsf.grid)
    pad = emb.grid.n_diag_tiles - g.n_diag_tiles
    ac, ace = band_row_to_col(m.Dr), band_row_to_col(emb.Dr)
    nchunks = max(1, min(8, g.n_diag_tiles))
    B = theta_rhs(torch, g, 1, 32, seed=22, device=m.device)[0]
    five = BandedCTSF(mb5.grid, *(x[:5] for x in mb5.arrays()))
    pairs = {
        "factorize_window_logdet": (lambda: logdet(factorize_window(m, options=opts)),
                                    lambda: logdet(factorize_window(m))),
        "sweep": (lambda: band_cholesky_sweep_cuda(ace, emb.R, nchunks=8, start_tile=pad),
                  lambda: band_cholesky_sweep_cuda(ac, m.R, nchunks=nchunks)),
        "solve_many_k32": (lambda: solve_many(fp, B), lambda: solve_many(f, B)),
        "selected_inverse": (lambda: selected_inverse(fp), lambda: selected_inverse(f)),
        "batch_of_5": (lambda: factorize_window_batched(five, bucket=True),
                       lambda: factorize_window_batched(five, bucket=False))}
    out = {}
    for name, (canon, source) in pairs.items():
        side = ("bucket_8", "unpadded_5") if name == "batch_of_5" else ("canonical", "source")
        out[name] = {}
        for label, fn in zip(side, (canon, source)):
            out[name][label] = dict(call_ms=time_ms(torch, fn, reps=7, warmup=2),
                                    device_ms=device_ms(torch, fn, reps=7))
        a, b = (out[name][s]["device_ms"] for s in side)
        out[name]["device_ratio"] = a / b if a and b else None
    no_skip = lambda: band_cholesky_sweep_cuda(ace, emb.R, nchunks=8)
    out["sweep"]["canonical_no_skip"] = dict(call_ms=time_ms(torch, no_skip, reps=7, warmup=2),
                                             device_ms=device_ms(torch, no_skip, reps=7))
    out["padded_flop_overhead"] = {str(mm.grid.structure.n): padded_flop_overhead(
        mm.grid, pol.canonicalize(mm.grid)) for mm, _, _ in stream}
    out["pad"], out["canonical_ndt"] = pad, emb.grid.n_diag_tiles
    log("bucketing times, Table II #5 canonical against source (medians of 7): "
        + json.dumps(out) + f", card {card}")
    return out


# ---------------------------------------------------------------------------
# phase 4: timings
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the distributed path (core/distributed.py, the sharded concurrent calls)
# ---------------------------------------------------------------------------

def distributed_matrix(torch):
    """Table II #4's shape at n = DIST_N (bandwidth 100, arrow 200, rho =
    0, seed 0) on the card: ``make_arrowhead`` -> ``measure_arrowhead`` ->
    ``TileGrid`` (t = 64) -> ``BandedCTSF.from_sparse``, and the plan
    ``detect_partition_plan`` finds, which must be DIST_PARTS partitions
    of equal size (``partition_banded``'s split).  Returns ``(m, plan)``."""
    from repro_torch.core import BandedCTSF, TileGrid, detect_partition_plan, measure_arrowhead
    from repro_torch.data import make_arrowhead
    A, st = make_arrowhead(DIST_N, 100, 200, rho=0.0, seed=0)
    measured = measure_arrowhead(A, arrow_hint=st.arrow)
    grid = TileGrid(measured, t=64)
    m = BandedCTSF.from_sparse(A, grid)
    plan = detect_partition_plan(A, measured, grid.t)
    per = grid.n_diag_tiles // DIST_PARTS
    if tuple(plan.boundaries) != tuple(range(0, grid.n_diag_tiles + 1, per)):
        raise AssertionError(f"n = {DIST_N}: detect_partition_plan found {plan.boundaries}, "
                             f"not {DIST_PARTS} partitions of {per}")
    return m, plan


def nccl_world_of_one(torch, store_path):
    """This process as a world of one NCCL rank on card 0."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=600))


def coupling_zero(torch, Dr, boundaries, bt):
    """Whether every band tile that reaches across a partition boundary is
    an exact zero (the partitioned route's gate on block independence)."""
    for start in boundaries[1:-1]:
        for r in range(start, min(start + bt, Dr.shape[0])):
            for d in range(r - start + 1, bt + 1):
                if bool(Dr[r, d].any()):
                    return False
    return True


def check_distributed_world1(torch, m, plan, full, launches):
    """World 1's assembled factor against the partitioned route's on the
    same plan and the fused route's: panels and arrow rows bit for bit, the
    coupling tiles exact zeros, the corner within 1e-4 of max|C|; its
    residual and logdet against the float64 oracle.  Returns the record."""
    from repro_torch.core import SolverOptions, factorize_window
    what = f"distributed n = {DIST_N}, world 1"
    pf = factorize_window(m, options=SolverOptions(partition_plan=plan))
    ff = factorize_window(m)
    same = {route: all(torch.equal(getattr(full.ctsf, x), getattr(f.ctsf, x)) for x in ("Dr", "R"))
            for route, f in (("partitioned", pf), ("fused", ff))}
    corner = {route: ((full.ctsf.C - f.ctsf.C).abs().max() / f.ctsf.C.abs().max()).item()
              for route, f in (("partitioned", pf), ("fused", ff))}
    zero = coupling_zero(torch, full.ctsf.Dr, plan.boundaries, m.grid.band_tiles)
    Ad = dense_from_ctsf(torch, m, torch.float64, symmetric=True)
    Ld = dense_from_ctsf(torch, full.ctsf, torch.float64, symmetric=False)
    resid = ((Ld @ Ld.mT - Ad).abs().max() / Ad.abs().max()).item()
    oracle = (2.0 * torch.log(torch.diagonal(torch.linalg.cholesky(Ad)))).sum().item()
    del Ad, Ld
    ld = full.logdet().item()
    ld_rel = abs(ld - oracle) / abs(oracle)
    if not (all(same.values()) and zero and max(corner.values()) <= 1e-4
            and resid <= RESIDUAL_LIMIT and ld_rel <= 1e-4):
        raise AssertionError(f"{what}: panels and R bit-identical {same}, coupling zero {zero}, "
                             f"corner {corner} (limit 1e-4), residual {resid:.3e}, logdet rel "
                             f"{ld_rel:.3e}")
    g = m.grid
    return dict(n=g.structure.n, bandwidth=g.structure.bandwidth, arrow=g.structure.arrow,
                t=g.t, ndt=g.n_diag_tiles, bt=g.band_tiles, nat=g.n_arrow_tiles,
                partitions=DIST_PARTS, boundaries=list(plan.boundaries), launches=launches,
                bit_identical=same, coupling_tiles_zero=zero, corner_rel=corner,
                residual=resid, logdet=ld, logdet_oracle=oracle, logdet_rel_err=ld_rel)


def gloo_rank(pm_host, grid, theta_host, faulted_host, device):
    """One rank of a world that shares the card over gloo, its tensors on
    ``device``: the distributed factorization over the ``model`` axis of a
    ``(1, world)`` mesh and its assembly, then the sharded concurrent calls
    on #5's θ-batch over the ``data`` axis of a ``(world, 1)`` mesh (and
    ``regularize=True`` on the faulted batch when given), each with the
    launches it made on the card.  Returns what the parent checks."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import BandedCTSF, SolverOptions
    from repro_torch.core.concurrent import (concurrent_factorize, concurrent_logdet,
                                             concurrent_selinv)
    from repro_torch.core.distributed import (PartitionedCTSF, assemble_factor,
                                              distributed_factorize)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime.telemetry import count_launches
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    world = dist.get_world_size()

    def launched(fn):
        got = []
        launches = count_launches(lambda: got.append(fn()))
        return got[0], launches

    pm = PartitionedCTSF(pm_host.grid, pm_host.n_parts,
                         *(x.to(dev) for x in (pm_host.Dr, pm_host.R, pm_host.C)))
    model = make_local_mesh(1, world)
    f, dlaunch = launched(lambda: distributed_factorize(pm, model, "model"))
    full = assemble_factor(f, grid)
    out = dict(first=f.first, launches=dlaunch, Dr=f.Dr, R=f.R, C=f.C,
               full=full.ctsf.arrays())
    data = make_local_mesh(world, 1)
    batch = BandedCTSF(theta_host.grid, *(x.to(dev) for x in theta_host.arrays()))
    fc, claunch = launched(lambda: concurrent_factorize(batch, mesh=data))
    out["concurrent"] = dict(offset=fc.offset, launches=claunch, factor=fc.ctsf.arrays(),
                             status=fc.status, logdet=concurrent_logdet(fc),
                             sigma=concurrent_selinv(fc, mesh=data).arrays())
    if faulted_host is not None:
        bad = BandedCTSF(faulted_host.grid, *(x.to(dev) for x in faulted_host.arrays()))
        ff = concurrent_factorize(bad, mesh=data, options=SolverOptions(regularize=True))
        i = ff.info
        out["faulted"] = dict(status=ff.status, info=(i.status, i.attempts, i.tau, i.min_pivot,
                                                      i.first_bad_tile))
    return out


def same_bits(torch, a, b):
    """Equal element for element, NaN where NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def check_gloo_world(torch, world, outs, w1, fb5, sb5, oracles, ff5):
    """A gloo world's ranks against world 1 and the unsharded calls: the
    distributed factor's panels bit for bit world 1's and its corner the
    same bits on every rank (within 1e-4 of world 1's), a sweep and
    log2(world) geadd a rank; each θ-batch element's panels and R bit for
    bit ``factorize_window_batched``'s (the corner within 1e-5), the
    logdets the same on every rank and within 1e-4 of the oracles, Σ bit
    for bit ``selinv_batched``'s or within 2e-4, one sweep launch a rank;
    the faulted batch's FactorInfo the unsharded call's on every rank.
    Returns the record."""
    what = f"distributed, gloo world {world}"
    per = DIST_PARTS // world
    levels = world.bit_length() - 1
    nat_d, nat = w1[2].shape[0], fb5.ctsf.grid.n_arrow_tiles
    rec = dict(world=world, launches=outs[0]["launches"],
               concurrent_launches=outs[0]["concurrent"]["launches"])
    corner_same = all(torch.equal(o["C"], outs[0]["C"]) for o in outs)
    corner_rel = max(((o["C"] - w1[2]).abs().max() / w1[2].abs().max()).item() for o in outs)
    panels_same = all(
        torch.equal(o["Dr"], w1[0].reshape(DIST_PARTS, -1, *w1[0].shape[1:])[r * per:(r + 1) * per])
        and torch.equal(o["full"][0], w1[0]) and torch.equal(o["full"][1], w1[1])
        for r, o in enumerate(outs))
    want_d = {"band_cholesky_sweep": 1, "geadd": levels, "potrf": nat_d, "trsm": nat_d}
    want_c = {"band_cholesky_sweep": 1, "potrf": nat, "trsm": nat}
    launches_ok = all(o["launches"] == want_d and o["concurrent"]["launches"] == want_c
                      for o in outs)
    rec.update(corner_same_on_every_rank=corner_same, corner_rel_to_world1=corner_rel,
               panels_bit_identical_to_world1=panels_same)
    if not (corner_same and corner_rel <= 1e-4 and panels_same and launches_ok):
        raise AssertionError(f"{what}: {rec}, launches {[o['launches'] for o in outs]} "
                             f"(want {want_d}), concurrent "
                             f"{[o['concurrent']['launches'] for o in outs]} (want {want_c})")
    nb = fb5.ctsf.Dr.shape[0]
    el = nb // world
    ref_arrays = [x.cpu() for x in fb5.ctsf.arrays()]
    ref_sigma = [x.cpu() for x in sb5.arrays()]
    ld_ref = outs[0]["concurrent"]["logdet"]
    ok, corner_err, sigma_same, sigma_err = True, 0.0, True, 0.0
    for r, o in enumerate(outs):
        c = o["concurrent"]
        lo = r * el
        ok &= c["offset"] == lo and torch.equal(c["logdet"], ld_ref)
        ok &= all(torch.equal(c["factor"][k], ref_arrays[k][lo:lo + el]) for k in (0, 1))
        corner_err = max(corner_err, ((c["factor"][2] - ref_arrays[2][lo:lo + el]).abs().max()
                                      / ref_arrays[2][lo:lo + el].abs().max()).item())
        for a, b in zip(c["sigma"], ref_sigma):
            same = torch.equal(a, b[lo:lo + el])
            sigma_same &= same
            if not same:
                sigma_err = max(sigma_err, ((a - b[lo:lo + el]).abs().max()
                                            / b[lo:lo + el].abs().max()).item())
    ld_err = max(abs(float(ld_ref[i]) - oracles[i]) / abs(oracles[i]) for i in range(nb))
    rec["concurrent"] = dict(elements_per_rank=el, panels_bit_identical=ok,
                             corner_rel=corner_err, logdet_rel_err=ld_err,
                             sigma_bit_identical=sigma_same, sigma_rel=sigma_err)
    if not (ok and corner_err <= 1e-5 and ld_err <= 1e-4 and sigma_err <= TOL):
        raise AssertionError(f"{what}, the sharded θ-batch: {rec['concurrent']}")
    if ff5 is not None:
        want = (ff5.info.status, ff5.info.attempts, ff5.info.tau, ff5.info.min_pivot,
                ff5.info.first_bad_tile)
        want = [x.cpu() for x in want]
        exact = all(torch.equal(o["faulted"]["info"][k], want[k]) for o in outs for k in (0, 1, 4))
        bits = all(same_bits(torch, o["faulted"]["info"][k], want[k]) for o in outs
                   for k in (2, 3))
        close = all(torch.allclose(o["faulted"]["info"][k], want[k], rtol=1e-5, atol=0.0,
                                   equal_nan=True) for o in outs for k in (2, 3))
        rec["faulted"] = dict(status=want[0].tolist(), attempts=want[1].tolist(),
                              ints_equal=exact, tau_min_pivot_bit_identical=bits,
                              tau_min_pivot_within_1e5=close)
        if not (exact and close):
            raise AssertionError(f"{what}, the faulted θ-batch's FactorInfo on every rank: "
                                 f"{rec['faulted']}")
    return rec


def time_distributed(torch, m, plan, pm, mesh, card):
    """World 1's call and device time of ``distributed_factorize`` +
    ``assemble_factor`` + ``logdet`` beside the partitioned and fused
    routes' ``factorize_window`` + ``logdet`` on the same matrix, and the
    three sweeps alone: the batched sweep on the 8 partitions, the
    partitioned kernel on the same plan, the fused kernel over every
    column."""
    from repro_torch.core import SolverOptions, factorize_window, logdet
    from repro_torch.core.distributed import assemble_factor, distributed_factorize
    from repro_torch.kernels.band_cholesky import (band_cholesky_partitioned_sweep_cuda,
                                                   band_cholesky_sweep_cuda)
    from repro_torch.kernels.ring import band_row_to_col
    popts = SolverOptions(partition_plan=plan)
    calls = {
        "distributed": lambda: logdet(assemble_factor(distributed_factorize(pm, mesh, "model"),
                                                      m.grid)),
        "partitioned": lambda: logdet(factorize_window(m, options=popts)),
        "fused": lambda: logdet(factorize_window(m))}
    out = {}
    for name, fn in calls.items():
        out[name] = dict(call_ms=time_ms(torch, fn, reps=7, warmup=2),
                         device_ms=device_ms(torch, fn))
    Acp, Ac = band_row_to_col(pm.Dr), band_row_to_col(m.Dr)
    nch = max(1, min(8, pm.grid.n_diag_tiles))
    sweeps = {"batched_partitions": lambda: band_cholesky_sweep_cuda(Acp, pm.R, nchunks=nch),
              "partitioned_kernel": lambda: band_cholesky_partitioned_sweep_cuda(
                  Ac, m.R, plan.boundaries),
              "fused_kernel": lambda: band_cholesky_sweep_cuda(Ac, m.R, nchunks=8)}
    out["sweeps_device_ms"] = {k: device_ms(torch, fn) for k, fn in sweeps.items()}
    log(f"distributed n = {DIST_N}, world 1: call and device ms (medians of 7 and 5) "
        + json.dumps(out) + f", card {card}")
    return out


def theta_oracles(torch, mb):
    """The float64 logdet of each element of a θ-batch."""
    out = []
    for i in range(mb.Dr.shape[0]):
        Ad = dense_from_ctsf(torch, element(mb, i), torch.float64, symmetric=True)
        out.append((2.0 * torch.log(torch.diagonal(torch.linalg.cholesky(Ad)))).sum().item())
        del Ad
    return out


def phase_distributed(torch, run_path, mb5, fb5, mbf, card):
    """The phase "distributed, block-diagonal n = 13,000": world 1 in this
    process (an NCCL group of one, its path counted), then the gloo worlds
    of GLOO_WORLDS sharing the card in spawned ranks (their launches counted
    in each rank); every process group destroyed before the next world.
    Returns the record."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import SolverOptions, factorize_window_batched, selinv_batched
    from repro_torch.core.distributed import (PartitionedCTSF, assemble_factor,
                                              distributed_factorize, partition_banded)
    from repro_torch.launch.mesh import make_local_mesh, run_local
    from repro_torch.sharding.collectives import quantized_allreduce
    m, plan = distributed_matrix(torch)
    pm = partition_banded(m, DIST_PARTS)
    nat = m.grid.n_arrow_tiles
    rec = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        nccl_world_of_one(torch, Path(tmp) / "store")
        try:
            mesh = make_local_mesh(1, 1)
            name = f"distributed, block-diagonal n = {DIST_N}: world 1 (NCCL)"
            f = run_path(name, lambda: distributed_factorize(pm, mesh, "model"))
            launches = run_path.launches[name]
            want = {"band_cholesky_sweep": 1, "potrf": nat, "trsm": nat}
            if launches != want:
                raise AssertionError(f"{name}: launches {launches} != {want}")
            full = assemble_factor(f, m.grid)
            rec["world1"] = check_distributed_world1(torch, m, plan, full, launches)
            # the NCCL transport in place (a world of one's all-reduce)
            q = quantized_allreduce(full.ctsf.C, mesh.get_group("model"))
            rec["world1"]["nccl_quantized_rel"] = (
                (q - full.ctsf.C).abs().max() / full.ctsf.C.abs().max()).item()
            if not rec["world1"]["nccl_quantized_rel"] <= 0.02:
                raise AssertionError(f"{name}: the NCCL quantized all-reduce of one rank is "
                                     f"{rec['world1']['nccl_quantized_rel']:.3e} off")
            log(f"main path, {name}: " + json.dumps(rec["world1"]))
            rec["world1"]["times"] = time_distributed(torch, m, plan, pm, mesh, card)
        finally:
            dist.destroy_process_group()
    w1 = [x.cpu() for x in full.ctsf.arrays()]
    pm_host = PartitionedCTSF(pm.grid, pm.n_parts, *(x.cpu() for x in (pm.Dr, pm.R, pm.C)))
    sb5 = selinv_batched(fb5)
    ff5 = factorize_window_batched(mbf, options=SolverOptions(regularize=True))
    oracles = theta_oracles(torch, mb5)
    theta_host = type(mb5)(mb5.grid, *(x.cpu() for x in mb5.arrays()))
    faulted_host = type(mbf)(mbf.grid, *(x.cpu() for x in mbf.arrays()))
    del f, full
    for world in GLOO_WORLDS:
        t0 = time.perf_counter()
        outs = run_local(gloo_rank, pm_host, m.grid, theta_host,
                         faulted_host if world == GLOO_WORLDS[-1] else None, str(m.device),
                         world_size=world, backend="gloo", device_type=m.device.type,
                         timeout=600)
        rec[f"world{world}"] = check_gloo_world(torch, world, outs, w1, fb5, sb5, oracles,
                                                ff5 if world == GLOO_WORLDS[-1] else None)
        rec[f"world{world}"]["seconds"] = time.perf_counter() - t0
        del outs
        log(f"main path, distributed, gloo world {world} sharing the card: "
            + json.dumps(rec[f"world{world}"]))
    return rec


# ---------------------------------------------------------------------------
# telemetry (runtime/telemetry.py) on the main paths
# ---------------------------------------------------------------------------

# What the reference's code emits (src/repro/core/*.py, batching.py,
# gridpolicy.py, robustness.py, launch/rung_server.py on a clean stream):
# each span's tags, and each counter's and histogram's labels
REFERENCE_SPAN_TAGS = {
    "serving.dispatch": ({"rung", "b", "reason"},), "serving.finalize": ({"rung", "b"},),
    "factorize.window": ({"grid"}, {"grid", "rung"}),
    "factorize.window_batched": ({"b", "grid"}, {"b", "grid", "rung"}),
    "solve.forward_many": ({"k", "grid"},), "solve.backward_many": ({"k", "grid"},),
    "solve.solve_many": ({"k", "grid"},), "solve.solve_many_batched": ({"b", "k", "grid"},),
    "solve.sample_gmrf_many": ({"num"},), "solve.marginal_variances": ({"method", "k", "grid"},),
    "selinv.selected_inverse": ({"grid"},), "selinv.batched": ({"b", "grid"},)}
REFERENCE_COUNTER_LABELS = {
    "cache.hit": {"cache"}, "cache.miss": {"cache"}, "cache.eviction": {"cache"},
    "cache.duplicate_trace": {"cache"}, "gridpolicy.rung_hit": {"rung"},
    "robustness.attempts": set(), "robustness.status": {"outcome"},
    "serving.requests": set(), "serving.flush": {"reason"}, "serving.completed": {"outcome"}}
REFERENCE_HISTOGRAM_LABELS = {"cache.trace_seconds": {"cache"},
                              "gridpolicy.padded_flop_overhead": set(),
                              "serving.batch_size": set(), "serving.queue_wait": set(),
                              "serving.request_seconds": set(),
                              "serving.device_seconds": {"rung"}}


def telemetry_record(snap, what):
    """A snapshot's spans as ``(name, parent name)`` pairs with their tags,
    its counters and histogram counts, after checking every name, tag and
    label against the reference's; returns the record."""
    names = {s["id"]: s["name"] for s in snap["spans"]}
    for s in snap["spans"]:
        if set(s["tags"]) not in [set(x) for x in REFERENCE_SPAN_TAGS.get(s["name"], ())]:
            raise AssertionError(f"telemetry, {what}: span {s['name']} with tags "
                                 f"{sorted(s['tags'])} is not one the reference emits")
    for kind, allowed in (("counters", REFERENCE_COUNTER_LABELS),
                          ("histograms", REFERENCE_HISTOGRAM_LABELS)):
        for key in snap[kind]:
            name, _, labels = key.partition("{")
            keys = {kv.split("=")[0] for kv in labels.rstrip("}").split(",") if kv}
            if name not in allowed or keys != allowed[name]:
                raise AssertionError(f"telemetry, {what}: {kind[:-1]} {key} is not one the "
                                     "reference emits")
    return dict(spans=sorted(([s["name"], names.get(s["parent"]),
                               {k: str(v) for k, v in sorted(s["tags"].items())}]
                              for s in snap["spans"]), key=str),
                counters=snap["counters"],
                histograms={k: h["count"] for k, h in snap["histograms"].items()})


def phase_telemetry(torch, run_path, m5, f5, mbf, stream, B32, card):
    """The phase "telemetry": #5's main path, the faulted θ-batch with
    regularize=True and the mixed stream's θ-batches with telemetry
    enabled (their spans, counters and labels the reference's, the ladder's
    counts its attempts and outcomes, the results bit for bit the disabled
    calls'); kernel_report(factorize_window) on #5 against the device
    counts; the solves' corner graphs captured with telemetry enabled; the
    disabled surface of one request, times 3, against a cached solve_many
    (k = 32) call (at most TELEMETRY_OVERHEAD_LIMIT), and the enabled call
    beside the disabled one, in turns.  Returns the record."""
    import numpy as np
    from repro_torch.core import (GridBucketPolicy, SolverOptions, factorize_window,
                                  factorize_window_batched, logdet, marginal_variances,
                                  sample_gmrf_many, selected_inverse, selinv_batched, solve,
                                  solve_many, solve_many_batched)
    from repro_torch.core.solve import corner_graphs
    from repro_torch.runtime import telemetry
    from repro_torch.runtime.telemetry import kernel_report
    g = m5.grid
    tag = telemetry.rung_tag(g)
    idx = np.array([0, g.structure.n // 2, g.structure.n - g.structure.arrow, g.structure.n - 1])
    B = B32[0].contiguous()
    rec = {}

    def captured(fn, what):
        telemetry.reset()
        telemetry.enable()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            telemetry.disable()
        r = telemetry_record(telemetry.snapshot(), what)
        telemetry.reset()
        return out, r

    def main_path():
        f = factorize_window(m5)
        gen = torch.Generator(device=m5.device).manual_seed(5)
        return dict(f=f, ld=logdet(f), x=solve(f, B[:, 0].contiguous()), X=solve_many(f, B),
                    Z=sample_gmrf_many(f, num=32, generator=gen), S=selected_inverse(f),
                    v=marginal_variances(f, idx),
                    vp=marginal_variances(f, idx, options=SolverOptions(method="panels")))

    on, rec["main"] = captured(main_path, "#5's main path")
    off = main_path()
    same = all(torch.equal(a, b) for a, b in (
        (on["f"].ctsf.Dr, off["f"].ctsf.Dr), (on["f"].ctsf.C, off["f"].ctsf.C),
        (on["ld"], off["ld"]), (on["x"], off["x"]), (on["X"], off["X"]), (on["Z"], off["Z"]),
        (on["S"].Dr, off["S"].Dr), (on["v"], off["v"]), (on["vp"], off["vp"])))
    del on, off
    k, n_idx = str(B.shape[1]), str(len(idx))
    want = sorted([
        ["factorize.window", None, {"grid": tag}],
        ["solve.solve_many", None, {"grid": tag, "k": "1"}],
        ["solve.solve_many", None, {"grid": tag, "k": k}],
        ["solve.sample_gmrf_many", None, {"num": "32"}],
        ["solve.backward_many", "solve.sample_gmrf_many", {"grid": tag, "k": "32"}],
        ["selinv.selected_inverse", None, {"grid": tag}],
        ["solve.marginal_variances", None, {"grid": tag, "k": n_idx, "method": "selinv"}],
        ["selinv.selected_inverse", "solve.marginal_variances", {"grid": tag}],
        ["solve.marginal_variances", None, {"grid": tag, "k": n_idx, "method": "panels"}],
        ["solve.forward_many", "solve.marginal_variances", {"grid": tag, "k": n_idx}]],
        key=str)
    if not (same and sorted(rec["main"]["spans"], key=str) == want
            and not rec["main"]["counters"] and not rec["main"]["histograms"]):
        raise AssertionError(f"telemetry, #5's main path: results unchanged {same}, "
                             f"{rec['main']} (want spans {want} and nothing else)")
    # the faulted θ-batch: the ladder's counters are its attempts and outcomes
    ff, rec["faulted"] = captured(lambda: factorize_window_batched(
        mbf, options=SolverOptions(regularize=True)), "the faulted θ-batch")
    st = ff.info.status.cpu()
    want_c = {"robustness.attempts": float(ff.info.attempts.sum().item())}
    for code, outcome in ((0, "ok"), (1, "recovered"), (2, "failed")):
        if int((st == code).sum()):
            want_c[f"robustness.status{{outcome={outcome}}}"] = float((st == code).sum())
    got_c = {k: v for k, v in rec["faulted"]["counters"].items() if k.startswith("robustness")}
    cache_c = {k: v for k, v in rec["faulted"]["counters"].items() if k.startswith("cache")}
    if not (got_c == want_c and sum(cache_c.values()) == 1
            and [s[:2] for s in rec["faulted"]["spans"]] == [["factorize.window_batched",
                                                             None]]):
        raise AssertionError(f"telemetry, the faulted θ-batch: {rec['faulted']} (want the "
                             f"ladder's {want_c}, one batched_window lookup)")
    del ff
    # the mixed stream: the rung hits, one lookup a call in each batched cache
    pol = SolverOptions(policy=GridBucketPolicy())

    def stream_calls():
        for m, mb, Bs in stream:
            fb = factorize_window_batched(mb, options=pol)
            solve_many_batched(fb, Bs)
            selinv_batched(fb)

    _, rec["stream"] = captured(stream_calls, "the mixed stream")
    cg = GridBucketPolicy().canonicalize(stream[0][0].grid)
    want_s = {f"gridpolicy.rung_hit{{rung={telemetry.rung_tag(cg)}}}": 3.0,
              "cache.hit{cache=batched_window}": 3.0, "cache.hit{cache=batched_solve}": 3.0,
              "cache.hit{cache=batched_selinv}": 3.0}
    names = sorted(s[0] for s in rec["stream"]["spans"])
    if not (rec["stream"]["counters"] == want_s
            and rec["stream"]["histograms"] == {"gridpolicy.padded_flop_overhead": 3}
            and names == sorted(["factorize.window_batched", "solve.solve_many_batched",
                                 "selinv.batched"] * 3)):
        raise AssertionError(f"telemetry, the mixed stream: {rec['stream']} (want counters "
                             f"{want_s})")
    # kernel_report against the path's device counts
    name = "telemetry: kernel_report(factorize_window), matrix 5"
    rep = run_path(name, lambda: kernel_report(factorize_window, m5, grid=g, sweep="cholesky"))
    want_l = {"band_cholesky_sweep": 1, "potrf": g.n_arrow_tiles, "trsm": g.n_arrow_tiles}
    rec["kernel_report"] = rep.asdict()
    if not rep.launches == run_path.launches[name] == want_l:
        raise AssertionError(f"{name}: {rep.launches}, device counts "
                             f"{run_path.launches[name]}, want {want_l}")
    # the solves' corner graphs still capture with telemetry enabled
    corner_graphs.clear()
    c0 = corner_graphs.captures
    X, rec["corner_capture"] = captured(lambda: solve_many(f5, B), "a capturing solve_many")
    rec["corner_capture"]["captures"] = corner_graphs.captures - c0
    replay = solve_many(f5, B)
    rec["corner_capture"]["bit_identical_to_replay"] = torch.equal(X, replay)
    if not (rec["corner_capture"]["captures"] == 2
            and torch.allclose(X, replay, rtol=TOL, atol=TOL)):
        raise AssertionError(f"telemetry: the corner's capture with telemetry enabled: "
                             f"{rec['corner_capture']} (want 2 captures, the replay's values)")
    # the disabled surface against a cached solve_many (k = 32) call
    call_ms = time_ms(torch, lambda: solve_many(f5, B), reps=21, warmup=3)
    n = 5000
    t0 = time.perf_counter()
    for _ in range(n):
        with telemetry.span("solve.solve_many", k=32) as sp:
            sp.tag(grid=telemetry.rung_tag(g))
        telemetry.inc("cache.hit", cache="batched_window")
        telemetry.observe("lat", 1.0)
    per_request_ms = (time.perf_counter() - t0) / n * 1e3
    turns = {"disabled": [], "enabled": []}
    for _ in range(5):
        for key in ("disabled", "enabled", "enabled", "disabled"):
            if key == "enabled":
                telemetry.enable()
            try:
                turns[key].append(time_ms(torch, lambda: solve_many(f5, B), reps=5, warmup=1))
            finally:
                telemetry.disable()
                telemetry.reset()
    rec["overhead"] = dict(
        solve_many_k32_call_ms=call_ms, disabled_request_ms=per_request_ms,
        ratio=3 * per_request_ms / call_ms,
        disabled_call_ms=statistics.median(turns["disabled"]),
        enabled_call_ms=statistics.median(turns["enabled"]), turns=turns)
    rec["overhead"]["enabled_ratio"] = (rec["overhead"]["enabled_call_ms"]
                                        / rec["overhead"]["disabled_call_ms"])
    log("telemetry, disabled surface and enabled call against solve_many (k = 32) on #5: "
        + json.dumps(rec["overhead"]) + f", card {card}")
    if not rec["overhead"]["ratio"] < TELEMETRY_OVERHEAD_LIMIT:
        raise AssertionError(f"telemetry: the disabled surface of one request, times 3, is "
                             f"{rec['overhead']['ratio']:.4f} of a cached solve_many call "
                             f"(limit {TELEMETRY_OVERHEAD_LIMIT})")
    return rec


def serving_bases(torch):
    """The serving path's models: one ``make_arrowhead(n, bandwidth, arrow,
    rho=0.7, seed=0)`` a case of SERVING_CASES, built once on the card
    (t = 64), with the padded rows of each case's real entries."""
    import numpy as np
    from repro_torch.core import BandedCTSF, TileGrid
    from repro_torch.data import make_arrowhead
    out = {}
    for case in SERVING_CASES:
        A, st = make_arrowhead(*case, rho=0.7, seed=0)
        m = BandedCTSF.from_sparse(A, TileGrid(st, t=64))
        out[case] = (m, m.grid.padded_indices(np.arange(case[0])))
    return out


def serving_request(torch, bases, spec):
    """One request of the INLA service, on the card: the θ step ``τ A + δ
    I`` of its case's model, (τ, δ) drawn from its spec's seed as
    theta_batch draws them, and its k-column panel seeded as
    ``launch/rung_server.py::_build_arrivals`` seeds it."""
    import numpy as np
    m, rows = bases[spec["case"]]
    mb, _ = theta_batch(torch, m, 1, seed=spec["seed"])
    rng = np.random.default_rng(spec["seed"])
    rhs = np.zeros((m.grid.padded_n, spec["k"]), np.float32)
    rhs[rows] = rng.standard_normal((len(rows), spec["k"])).astype(np.float32)
    return element(mb, 0), torch.from_numpy(rhs).to(m.device)


def indefinite_request(torch, m):
    """A request's matrix made indefinite as faulted_theta_batch makes its
    element: the middle band diagonal tile dropped by 10 x the mean |band
    diagonal|."""
    from repro_torch.core import BandedCTSF
    Dr = m.Dr.clone()
    d = torch.diagonal(Dr[:, 0], dim1=-2, dim2=-1)
    Dr[m.grid.n_diag_tiles // 2, 0] -= 10.0 * d.abs().mean() * torch.eye(m.grid.t,
                                                                         device=Dr.device)
    return BandedCTSF(m.grid, Dr, m.R, m.C)


def serving_executor(torch, kern_counts):
    """A RungExecutor on the card (the server's default options: the jitter
    ladder on) that records, a batch, the launches its dispatch made (the
    device counts around it), the host seconds in dispatch and finalize,
    and CUDA events on its stream before its first and after its last
    launch; an exception a dispatch raises is recorded and raised on."""
    from repro_torch.launch.rung_server import RungExecutor

    class TimedExecutor(RungExecutor):
        def __init__(self):
            super().__init__()
            self.batches, self.errors = [], []

        def dispatch(self, batch, now):
            before = kern_counts()
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            t0 = time.perf_counter()
            try:
                inflight = super().dispatch(batch, now)
            except Exception as err:
                self.errors.append(f"{type(err).__name__}: {err}")
                raise
            host = time.perf_counter() - t0
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            after = kern_counts()
            inflight.record = dict(
                rids=[r.rid for r in batch.requests], nat=batch.key[0].n_arrow_tiles,
                reason=batch.reason, dispatch_host_s=host, events=(start, end),
                launches={k: after[k] - before[k] for k in after if after[k] - before[k]})
            self.batches.append(inflight.record)
            return inflight

        def finalize(self, inflight, now):
            t0 = time.perf_counter()
            out = super().finalize(inflight, now)
            inflight.record["finalize_host_s"] = time.perf_counter() - t0
            return out

    return TimedExecutor()


def serve_replay(torch, arrivals, executor=None, injector=None):
    """One replay of ``arrivals`` through a RungServer(max_batch =
    SERVING_BATCH, max_delay = SERVING_DELAY) on a SimClock (the default
    GridBucketPolicy, regularize on); returns the server, the futures and
    the replay's wall seconds (it ends in a drain, which waits on every
    batch's event)."""
    from repro_torch.launch.rung_server import RungServer, SimClock, replay
    clock = SimClock()
    server = RungServer(max_batch=SERVING_BATCH, max_delay=SERVING_DELAY, clock=clock,
                        executor=executor, injector=injector)
    t0 = time.perf_counter()
    futures = replay(server, clock, arrivals)
    return server, futures, time.perf_counter() - t0


def batch_launches(nat):
    """One factorize_window_batched plus one solve_many_batched call."""
    return {"band_cholesky_sweep": 1, "potrf": nat, "trsm": nat, "band_forward_sweep": 1,
            "band_backward_sweep": 1, "solve_panel": 2 * nat}


def held_bytes(torch, results):
    """The bytes the card's memory keeps for ``results``: every distinct
    storage their tensors view (x, the factor's arrays, its FactorInfo and
    kept matrix) once."""
    seen = {}
    for r in results:
        ts = [] if r.x is None else [r.x]
        if r.factor is not None:
            ts += list(r.factor.ctsf.arrays())
            info = r.factor.info
            if info is not None:
                ts += [info.status, info.attempts, info.tau, info.min_pivot,
                       info.first_bad_tile]
                if info.matrix is not None:
                    ts += list(info.matrix.arrays())
        for x in ts:
            s = x.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def phase_serving(torch, run_path, kern_counts, card):
    """The phase "serving": the INLA service of SERVING_CASES (5 grids on
    2 rungs) through RungServer at full width.  A stream of SERVING_REQUESTS
    requests (request_stream(7, ...)) replayed on a SimClock twice, cold
    (counted, the corner's graphs cleared first) then warm: every future
    OK, full and deadline flushes, the histories equal and every x bit for
    bit across the passes; batched_window and batched_solve gain at most
    one entry a rung; the corner captured once a (nat, direction, padded
    batch) the cold pass runs, the warm pass none; each batch the launches
    of one factorize_window_batched and one solve_many_batched call.  Each
    request against the sequential oracle (factorize_window(regularize)
    and solve_many on its source grid): x within SERVING_X_RTOL of max|x|,
    logdet 1e-5 relative, every sixth request's float64 residual ≤ 1e-4.
    The chaos pass, twice: CHAOS_REQUESTS requests, one indefinite, a
    DispatchFaultInjector poisoning one: the indefinite request RECOVERED
    with tau > 0 and its factor's residual against A + tau I ≤ 1e-4, the
    poisoned one FAILED "dispatch_failed", its siblings OK or RECOVERED,
    events, history and x the same in both passes, each future resolved
    once.  The threaded pass: start(), the corner's graphs cleared,
    SERVING_CLIENTS client threads building their requests on the card and
    submitting, stop(): every future OK within SERVING_X_RTOL of the
    replay's x.  Telemetry enabled over the warm stream: every serving
    span, counter, gauge and histogram the reference's server emits for
    it, results bit for bit the warm pass's.  Returns the record and what
    phase 4 times."""
    import threading
    from repro_torch.core import (STATUS_FAILED, STATUS_OK, STATUS_RECOVERED, BandedCTSF,
                                  SolverOptions, factorize_window, logdet, solve_many)
    from repro_torch.core.batching import next_pow2
    from repro_torch.core.robustness import add_diagonal_jitter
    from repro_torch.core.solve import corner_graphs
    from repro_torch.data import request_stream
    from repro_torch.launch.rung_server import RungServer
    from repro_torch.runtime import telemetry
    from repro_torch.runtime.fault_tolerance import DispatchFaultInjector
    rec = {}
    t0 = time.perf_counter()
    bases = serving_bases(torch)
    stream = request_stream(7, SERVING_CASES, SERVING_REQUESTS, rate=SERVING_RATE,
                            k=SERVING_K)
    reqs = [serving_request(torch, bases, s) for s in stream]
    arrivals = [(s["arrival"], m, b, s["deadline"]) for s, (m, b) in zip(stream, reqs)]
    torch.cuda.synchronize()
    rec["setup_host_s"] = time.perf_counter() - t0
    grids = {telemetry.rung_tag(m.grid) for m, _ in reqs}
    caches = batched_caches()

    # the cold pass, counted: the corner's graphs cleared first
    def cold():
        corner_graphs.clear()
        keys = {k: set(c.keys()) for k, c in caches.items()}
        c0 = corner_graphs.captures
        ex = serving_executor(torch, kern_counts)
        server, futs, wall = serve_replay(torch, arrivals, executor=ex)
        return (server, futs, ex, corner_graphs.captures - c0,
                {k: len(set(c.keys()) - keys[k]) for k, c in caches.items()})

    cold_server, cold_futs, cold_ex, captures, added = run_path("serving: cold replay", cold)
    cold_res = [f.result(timeout=0) for f in cold_futs]
    reasons = sorted({sig[3] for sig in cold_server.history})
    rungs = {sig[0] for sig in cold_server.history}
    want_captures = 2 * len({(b["nat"], next_pow2(len(b["rids"]))) for b in cold_ex.batches})
    bad_launches = [(b["rids"], b["launches"]) for b in cold_ex.batches
                    if b["launches"] != batch_launches(b["nat"])]
    if not (all(r.status == STATUS_OK for r in cold_res) and {"full", "deadline"} <= set(reasons)
            and len(rungs) == 2 and len(grids) == len(SERVING_CASES)
            and added["batched_window"] <= 2 and added["batched_solve"] <= 2
            and captures == want_captures and not bad_launches):
        raise AssertionError(
            f"serving, cold replay: statuses {[r.status for r in cold_res]}, flush reasons "
            f"{reasons} (want full and deadline), rungs {rungs}, grids {grids}, cache entries "
            f"added {added} (at most 2 each), corner captures {captures} (want "
            f"{want_captures}), batches off one call's launches {bad_launches}")
    rec["cold"] = dict(batches=len(cold_server.history), flush_reasons=reasons,
                       history=[list(h) for h in cold_server.history],
                       cache_entries_added=added, corner_captures=captures,
                       launches=run_path.launches["serving: cold replay"])
    del cold_ex
    # the warm pass: the same history, every x bit for bit, no capture
    c0 = corner_graphs.captures
    warm_ex = serving_executor(torch, kern_counts)
    warm_server, warm_futs, warm_wall = serve_replay(torch, arrivals, executor=warm_ex)
    warm_res = [f.result(timeout=0) for f in warm_futs]
    same = [torch.equal(a.x, b.x) for a, b in zip(cold_res, warm_res)]
    if not (warm_server.history == cold_server.history and all(same)
            and all(r.status == STATUS_OK for r in warm_res)
            and corner_graphs.captures == c0):
        raise AssertionError(f"serving, warm replay: history equal "
                             f"{warm_server.history == cold_server.history}, x bit for bit "
                             f"{same}, statuses {[r.status for r in warm_res]}, captures "
                             f"{corner_graphs.captures - c0}")
    del cold_res, cold_futs
    rec["warm"] = dict(bit_identical_to_cold=True, corner_captures=0)
    # against the sequential oracle on each request's source grid
    reg = SolverOptions(regularize=True)
    errs, lds, resids = [], [], []
    for i, ((m, b), r) in enumerate(zip(reqs, warm_res)):
        f = factorize_window(m, options=reg)
        X = solve_many(f, b)
        errs.append(((r.x - X).abs().max() / X.abs().max()).item())
        lds.append(logdet_gate(logdet(r.factor), logdet(f), f"serving request {i}"))
        if i % 6 == 0:
            Ad = dense_from_ctsf(torch, m, torch.float64, symmetric=True)
            x64 = r.x.double()
            resids.append(((Ad @ x64 - b.double()).abs().max()
                           / (Ad.abs().max() * x64.abs().max())).item())
            del Ad
    if not (max(errs) <= SERVING_X_RTOL and max(resids) <= RESIDUAL_LIMIT):
        raise AssertionError(f"serving against the sequential oracle: x {max(errs):.3e} of "
                             f"max|x| (limit {SERVING_X_RTOL}), residual {max(resids):.3e} "
                             f"(limit {RESIDUAL_LIMIT})")
    rec["oracle"] = dict(x_rel_max=max(errs), logdet_rel_max=max(lds),
                         residual_max=max(resids), residuals_checked=len(resids))
    log("serving, cold and warm replay against the oracle: "
        + json.dumps({k: rec[k] for k in ("cold", "warm", "oracle")}))

    # the chaos pass, twice: an indefinite request, a poisoned one
    cstream = request_stream(11, SERVING_CASES, CHAOS_REQUESTS, rate=SERVING_RATE,
                             k=SERVING_K)
    creqs = [serving_request(torch, bases, s) for s in cstream]
    creqs[CHAOS_INDEFINITE] = (indefinite_request(torch, creqs[CHAOS_INDEFINITE][0]),
                               creqs[CHAOS_INDEFINITE][1])
    carr = [(s["arrival"], m, b, s["deadline"]) for s, (m, b) in zip(cstream, creqs)]
    passes = []
    for _ in range(2):
        inj = DispatchFaultInjector(seed=3, transient_rate=0.25, poison_rids={CHAOS_POISON})
        server, futs, _ = serve_replay(torch, carr, injector=inj)
        passes.append((server, futs, [f.result(timeout=0) for f in futs]))
    (s1, f1, r1), (s2, f2, r2) = passes
    ind, poi = r1[CHAOS_INDEFINITE], r1[CHAOS_POISON]
    siblings = [r.status for i, r in enumerate(r1) if i != CHAOS_POISON]
    same_x = all((a.x is None and b.x is None) or torch.equal(a.x, b.x) for a, b in zip(r1, r2))
    resolved_once = all(f.done() and f.duplicate_resolves == 0 for f in f1 + f2)
    e = creqs[CHAOS_INDEFINITE][0]
    fr = ind.factor.restrict().ctsf
    DrJ, CJ = add_diagonal_jitter(e.Dr, e.C, e.grid, torch.tensor(ind.tau, device=e.Dr.device))
    Ad = dense_from_ctsf(torch, BandedCTSF(e.grid, DrJ, e.R, CJ), torch.float64, symmetric=True)
    Ld = dense_from_ctsf(torch, fr, torch.float64, symmetric=False)
    resid = ((Ld @ Ld.mT - Ad).abs().max() / Ad.abs().max()).item()
    del Ad, Ld
    if not (ind.status == STATUS_RECOVERED and ind.tau > 0 and resid <= RESIDUAL_LIMIT
            and torch.isfinite(ind.x).all()
            and poi.status == STATUS_FAILED and poi.detail == "dispatch_failed"
            and all(s in (STATUS_OK, STATUS_RECOVERED) for s in siblings)
            and s1.events == s2.events and s1.history == s2.history and same_x
            and resolved_once):
        raise AssertionError(
            f"serving, chaos pass: indefinite request {ind.status} tau {ind.tau} residual "
            f"{resid:.3e}; poisoned {poi.status} {poi.detail!r}; siblings {siblings}; "
            f"events equal {s1.events == s2.events}, history equal "
            f"{s1.history == s2.history}, x equal {same_x}, resolved once {resolved_once}")
    rec["chaos"] = dict(statuses=[r.status for r in r1], details=[r.detail for r in r1],
                        indefinite=dict(tau=ind.tau, attempts=ind.attempts,
                                        factor_residual=resid),
                        events=[list(map(str, ev)) for ev in s1.events],
                        batches=len(s1.history))
    del passes, r1, r2, f1, f2, s1, s2, carr, creqs
    log("serving, chaos pass: " + json.dumps(rec["chaos"]))

    # the threaded pass on the wall clock: clients build on the card while
    # the pump captures the corner's graphs
    server = RungServer(max_batch=SERVING_BATCH, max_delay=SERVING_DELAY,
                        executor=serving_executor(torch, kern_counts))
    server.start()
    corner_graphs.clear()
    c0 = corner_graphs.captures
    futs, errors = [None] * len(stream), []

    def client(j):
        try:
            for i in range(j, len(stream), SERVING_CLIENTS):
                m, b = serving_request(torch, bases, stream[i])
                futs[i] = server.submit(m, b)
        except Exception as err:                      # reported and raised below
            errors.append(f"client {j}: {type(err).__name__}: {err}")

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(j,)) for j in range(SERVING_CLIENTS)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=120)
    try:
        tres = [f.result(timeout=60) for f in futs if f is not None]
    finally:
        server.stop(timeout=60)
    threaded_wall = time.perf_counter() - t0
    alive = [c.name for c in clients if c.is_alive()]
    failed = (errors or alive or len(tres) != len(stream) or server.executor.inner.errors
              or any(r.status != STATUS_OK for r in tres))
    terr = [] if failed else [((r.x - w.x).abs().max() / w.x.abs().max()).item()
                              for r, w in zip(tres, warm_res)]
    if failed or max(terr) > SERVING_X_RTOL or server._outstanding:
        raise AssertionError(
            f"serving, threaded pass: client errors {errors}, clients alive {alive}, "
            f"dispatch errors {server.executor.inner.errors}, events {server.events}, "
            f"statuses {[r.status for r in tres]}, x against the replay {terr}")
    rec["threaded"] = dict(clients=SERVING_CLIENTS, batches=len(server.history),
                           corner_captures=corner_graphs.captures - c0,
                           x_rel_max_against_replay=max(terr), wall_s=threaded_wall,
                           flush_reasons=sorted({h[3] for h in server.history}))
    del tres
    log("serving, threaded pass: " + json.dumps(rec["threaded"]))

    # telemetry over the warm stream: the reference's serving names
    telemetry.reset()
    telemetry.enable()
    try:
        tserver, tfuts, _ = serve_replay(torch, arrivals)
        torch.cuda.synchronize()
    finally:
        telemetry.disable()
    snap = telemetry.snapshot()
    telemetry.reset()
    tres = [f.result(timeout=0) for f in tfuts]
    rec["telemetry"] = check_serving_telemetry(snap, tserver.history, len(stream))
    same = all(torch.equal(a.x, b.x) for a, b in zip(tres, warm_res))
    if not (same and tserver.history == warm_server.history):
        raise AssertionError("serving with telemetry enabled: results or history differ "
                             "from the disabled warm pass")
    rec["telemetry"]["bit_identical_to_disabled"] = True
    log("serving, telemetry: " + json.dumps(rec["telemetry"]))
    del tres, tfuts, tserver
    return rec, dict(arrivals=arrivals, reqs=reqs, warm=(warm_server, warm_res, warm_ex,
                                                         warm_wall))


def check_serving_telemetry(snap, history, n):
    """A telemetry snapshot of one clean replay against what the
    reference's server and core emit for it (the same names and labels,
    counted from the history): spans checked by telemetry_record, the
    serving counters, gauges and histogram counts exactly, each core span
    of a batch a child of its serving.dispatch.  Returns the record."""
    r = telemetry_record(snap, "the serving replay")
    by_rung = {}
    for sig in history:
        by_rung[sig[0]] = by_rung.get(sig[0], 0) + 1
    nb = len(history)
    want_c = {"serving.requests": float(n), "serving.completed{outcome=ok}": float(n)}
    for sig in history:
        key = f"serving.flush{{reason={sig[3]}}}"
        want_c[key] = want_c.get(key, 0.0) + 1.0
    want_h = {"serving.batch_size": nb, "serving.queue_wait": n, "serving.request_seconds": n,
              **{f"serving.device_seconds{{rung={k}}}": v for k, v in by_rung.items()}}
    got_c = {k: v for k, v in r["counters"].items() if k.startswith("serving.")}
    got_h = {k: v for k, v in r["histograms"].items() if k.startswith("serving.")}
    gauges = sorted(k for k in snap["gauges"] if k.startswith("serving."))
    names = {s["id"]: s["name"] for s in snap["spans"]}
    serving = [s for s in snap["spans"] if s["name"].startswith("serving.")]
    core_parents = {names.get(s["parent"]) for s in snap["spans"]
                    if s["name"] in ("factorize.window_batched", "solve.solve_many_batched")}
    if not (got_c == want_c and got_h == want_h
            and gauges == sorted(f"serving.queue_depth{{rung={k}}}" for k in by_rung)
            and sorted(s["name"] for s in serving) == sorted(
                ["serving.dispatch", "serving.finalize"] * nb)
            and core_parents == {"serving.dispatch"}):
        raise AssertionError(f"telemetry of the serving replay: counters {got_c} (want "
                             f"{want_c}), histograms {got_h} (want {want_h}), gauges {gauges}, "
                             f"core spans' parents {core_parents}")
    dur = {}
    for sp in snap["spans"]:
        dur.setdefault(sp["name"], []).append(sp["dur_us"] / 1e3)
    return dict(counters=got_c, histograms=got_h, gauges=gauges,
                spans=len(serving), core_spans_under_dispatch=True,
                span_ms_median={k: statistics.median(dur[k]) for k in (
                    "serving.dispatch", "factorize.window_batched",
                    "solve.solve_many_batched", "serving.finalize")})


def batch_device_ms(torch, arrivals):
    """The device time of one served batch's work, replayed from a CUDA
    graph: the requests of ``arrivals`` embedded on their rung, then
    factorize_window_batched and solve_many_batched as the executor calls
    them, without the ladder (its readback waits on the host)."""
    from repro_torch.core import (GridBucketPolicy, factorize_window_batched,
                                  solve_many_batched)
    from repro_torch.core.gridpolicy import assemble_rung_batch, assemble_rung_rhs
    mats, panels = [a[1] for a in arrivals], [a[2] for a in arrivals]
    cgrid = GridBucketPolicy().canonicalize(mats[0].grid)
    stacked, start = assemble_rung_batch(mats, cgrid)
    B = assemble_rung_rhs(panels, [m.grid for m in mats], cgrid)
    return device_ms(torch, lambda: solve_many_batched(
        factorize_window_batched(stacked, start_tile=start), B, start_tile=start))


def time_serving(torch, kern_counts, serving, card):
    """The serving path's times (phase 4): the warm pass's requests a
    second and wall p50/p99 (its replay on a SimClock, as fast as the host
    goes), each batch's span on the executor's stream (CUDA events) and
    host seconds in dispatch and finalize; the same requests as a
    sequential loop of factorize_window(regularize) + solve_many (three
    loops, the median); the bytes one batch's results keep on the card;
    each batch shape's device time from a CUDA graph (batch_device_ms) and
    their sum over the pass against its wall time.  Returns the record."""
    from repro_torch.core import SolverOptions, factorize_window, solve_many
    from repro_torch.core.batching import next_pow2
    server, res, ex, wall = serving["warm"]
    lat = sorted(r.wall_latency_s for r in res)
    n = len(res)
    pct = lambda q: lat[min(n - 1, int(q * n))] * 1e3
    batches = []
    for b in ex.batches:
        start, end = b["events"]
        batches.append(dict(b=len(b["rids"]), nat=b["nat"], reason=b["reason"],
                            stream_ms=start.elapsed_time(end),
                            dispatch_host_ms=b["dispatch_host_s"] * 1e3,
                            finalize_host_ms=b["finalize_host_s"] * 1e3))
    reg = SolverOptions(regularize=True)

    def loop():
        for m, b in serving["reqs"]:
            solve_many(factorize_window(m, options=reg), b)
        torch.cuda.synchronize()

    loops = []
    for _ in range(3):
        t0 = time.perf_counter()
        loop()
        loops.append(time.perf_counter() - t0)
    full = next(i for i, b in enumerate(ex.batches) if len(b["rids"]) == SERVING_BATCH)
    held = held_bytes(torch, [res[i] for i in ex.batches[full]["rids"]])
    # each batch shape's device time with no host gap: its factorization
    # (no ladder: the readback cannot be captured) and solve in a CUDA graph
    floors = {}
    for b in ex.batches:
        key = (b["nat"], next_pow2(len(b["rids"])))
        if key not in floors:
            floors[key] = batch_device_ms(torch, [serving["arrivals"][i] for i in b["rids"]])
    device_sum = sum(floors[(b["nat"], next_pow2(len(b["rids"])))] for b in ex.batches)
    rec = dict(requests=n, batches=len(batches), replay_wall_s=wall,
               requests_per_s=n / wall, wall_p50_ms=pct(0.5), wall_p99_ms=pct(0.99),
               batch_stream_ms_median=statistics.median(b["stream_ms"] for b in batches),
               dispatch_host_ms_median=statistics.median(b["dispatch_host_ms"] for b in batches),
               finalize_host_ms_median=statistics.median(b["finalize_host_ms"]
                                                         for b in batches),
               sequential_loop_s=statistics.median(loops), sequential_loops_s=loops,
               sequential_requests_per_s=n / statistics.median(loops),
               held_bytes_batch_of_4=held,
               batch_device_ms={f"nat{k[0]}_b{k[1]}": v for k, v in floors.items()},
               device_ms_sum=device_sum, device_busy_share=device_sum / (wall * 1e3),
               batch_times=batches)
    rec["speedup_over_sequential"] = rec["requests_per_s"] / rec["sequential_requests_per_s"]
    log(f"time serving, {n} requests of SERVING_CASES: " + json.dumps(rec) + f", card {card}")
    return rec


# ---------------------------------------------------------------------------
# the LM substrate: launch/train.py with AdamW and with the arrowhead
# preconditioner (optim/arrowhead.py on the band-Cholesky and band-solve
# kernels), launch/serve.py, the examples' twins
# ---------------------------------------------------------------------------

# lm-100m (examples/train_lm.py's model) at full width and depth on
# MarkovStream(8192, seed 0), the arrowhead's factor checked after these
# steps; qwen2-7b at its published widths, n_layers cut to 2, on
# token_batch (a Markov chain over its 152,064 tokens would not fit the
# host); the server's batch, prompt and generated tokens
LM_STEPS, LM_BATCH, LM_SEQ = 30, 8, 256
LM_CHECK_STEPS = (10, 20)
QWEN_LAYERS, QWEN_BATCH, QWEN_SEQ, QWEN_STEPS = 2, 2, 256, 2
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 64, 32
# with damping = 1 on a fresh state (A = I) precondition is the identity,
# relative to max|g|; the server's decode logits against a full forward,
# relative to max|logit|
IDENTITY_LIMIT = 1e-6
LOGIT_RTOL = 1e-3
# one arrowhead step's parameters against adamw_update(precondition(...))
# written out, relative to how far the raw gradient's update lands
PRECOND_STEP_TOL = 1e-3
ARROWHEAD_KERNELS = ("band_cholesky_sweep", "potrf", "trsm", "band_forward_sweep",
                     "band_backward_sweep", "solve_panel")


def arrowhead_step_launches(step, every):
    """The launches of one arrowhead train step: both band-solve sweeps and
    the corner's solve_panel pair every step; the fused sweep and the
    corner's potrf and trsm on a refresh step."""
    want = {"band_forward_sweep": 1, "band_backward_sweep": 1, "solve_panel": 2}
    if step % every == 0:
        want.update(band_cholesky_sweep=1, potrf=1, trsm=1)
    return want


def lm_train(torch, cfg, optimizer, batches, kern_counts, snapshot_at=(), dev="cuda:0"):
    """Train ``cfg`` from seed 0 through launch/train.py's entry points,
    with ``RunConfig`` as ``train()`` builds it (compute in bfloat16):
    ``init_state``, ``build_precond`` + ``attach_precond`` (arrowhead),
    ``make_train_step``, a step a batch.  Records each step's CUDA-event
    time, its launches (the device counts' difference across the call) and,
    at ``snapshot_at``, the arrowhead's statistics and factor.  The losses
    are read after the last step; the peak memory counts what the run
    allocated beyond what the card held when it began."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.train import attach_precond, init_state, make_train_step
    from repro_torch.optim.arrowhead import build_precond
    steps = len(batches)
    seq = batches[0]["tokens"].shape[1]
    run = RunConfig(optimizer=optimizer, remat="none", loss_chunk=128,
                    checkpoint_every=max(10, steps // 4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, run, max_seq=seq)
    precond = None
    if optimizer == "arrowhead":
        precond = build_precond(state.params, r=run.precond_proj_dim, band=run.precond_band,
                                seed=0)
        attach_precond(state, precond)
    step_fn = make_train_step(cfg, run, None, precond, total_steps=steps)
    events, launches, snaps, metrics = [], [], {}, []
    for s, b in enumerate(batches):
        before = kern_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step_fn(state, b)
        e1.record()
        after = kern_counts()
        events.append((e0, e1))
        launches.append({k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)})
        metrics.append(m)
        if precond is not None and s in snapshot_at:
            snaps[s] = {w: {k: v.clone() for k, v in getattr(state, w).items()}
                        for w in ("precond", "factor")}
    torch.cuda.synchronize()
    return dict(state=state, precond=precond, run=run, snaps=snaps, launches=launches,
                step_fn=step_fn,
                losses=[float(m["loss"]) for m in metrics],
                step_ms=[e0.elapsed_time(e1) for e0, e1 in events],
                peak_bytes=torch.cuda.max_memory_allocated() - start_bytes)


def probe_steps(torch, step_fn, state, batch, reps=3):
    """Train steps on a quiet card (after the measured run): the host's
    enqueue time (the call returns before the card is done) against the
    step's wall time to a synchronize, and the kernel time a profiler trace
    sums over one step (PyTorch's kernels: the repo's own kernels, launched
    through ctypes, do not show in it), hence the card's idle share."""
    from torch.profiler import ProfilerActivity, profile
    enq, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        enq.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    self_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    # the operators' rows: each kernel's time once, under the operator that
    # launched it (the trace's kernel rows repeat it)
    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                 key=self_us, reverse=True)
    dev_us = sum(self_us(e) for e in ops)
    rec = dict(host_enqueue_ms=statistics.median(enq), wall_ms=statistics.median(wall),
               profiled_kernel_ms=dev_us / 1e3 if dev_us else None,
               top_ops=[(e.key, self_us(e) / 1e3, e.count) for e in ops[:12]])
    if dev_us:
        rec["device_idle_share"] = 1.0 - rec["profiled_kernel_ms"] / rec["wall_ms"]
    return rec


def steps_in_turns(torch, runs, batch, rounds=5):
    """Train steps of each optimizer on a quiet card, in turns (A, B, B, A
    a round), each to a synchronize: host enqueue and wall ms, medians.
    ``runs`` maps a name to ``(step_fn, state)``."""
    (na, ra), (nb, rb) = runs.items()
    times = {na: ([], []), nb: ([], [])}
    for _ in range(rounds):
        for name, (fn, state) in ((na, ra), (nb, rb), (nb, rb), (na, ra)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(state, batch)
            times[name][0].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            times[name][1].append((time.perf_counter() - t0) * 1e3)
    rec = {n: dict(host_enqueue_ms=statistics.median(h), wall_ms=statistics.median(w),
                   wall_runs=w) for n, (h, w) in times.items()}
    rec["wall_ratio"] = rec[nb]["wall_ms"] / rec[na]["wall_ms"]
    return rec


def lm_grads(torch, cfg, run, params, batch):
    """The clipped gradient at ``params`` on ``batch``, as a train step
    sees it (the arrowhead's checks and timings read its sketch)."""
    from repro_torch import pytree
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import clip_by_global_norm
    dev = pytree.leaves(params)[0].device
    leaves = [p.detach().requires_grad_() for p in pytree.leaves(params)]
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    loss = get_model(cfg).loss(pytree.unflatten(params, leaves), b, cfg, run)
    grads = pytree.unflatten(params, list(torch.autograd.grad(loss, leaves)))
    return clip_by_global_norm(grads, run.grad_clip)[0]


def check_losses(losses, what):
    import numpy as np
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (all(math.isfinite(v) for v in losses) and last < first):
        raise AssertionError(f"{what}: losses finite and falling (mean of the last 5 below "
                             f"the first 5's): first {first:.4f}, last {last:.4f}, {losses}")
    return dict(first5_mean=first, last5_mean=last, losses=losses)


def check_step_launches(launches, precond, every, what):
    for s, got in enumerate(launches):
        want = arrowhead_step_launches(s, every) if precond is not None else {}
        if got != want:
            raise AssertionError(f"{what}: step {s} launched {got}, expected {want}")


def arrowhead_unit_stats(stats):
    """The statistics scaled to unit max, the damping left as it is.  The
    clipped gradients of the lm path give statistics some 1e-8 in size,
    which the damping of 1e-3 swamps (A is damping·I to six digits); at
    unit max the off-diagonal tiles weigh as much as the diagonal ones, so
    a factor, solve or kernel that dropped them fails the gates.  Returns
    the scaled statistics and the scale."""
    m = max(stats[k].abs().max().item() for k in ("Dr", "R", "C"))
    return {**stats, **{k: stats[k] / m for k in ("Dr", "R", "C")}}, m


def arrowhead_gates(torch, precond, stats, factor, lsk, ask):
    """Against A = ``damped(stats)`` assembled in float64: the factor
    residual ``max|L Lᵀ − A| / max|A|`` and the forward error of ``A⁻¹ ĝ``
    (``solve_sketch``, the path ``precondition`` takes) against a float64
    dense solve; beside them the same two numbers for the block-diagonal
    factor (each diagonal tile's Cholesky, every band and arrow tile
    dropped), what a sweep and solves that skipped every off-diagonal tile
    would score, and A's spectrum."""
    from repro_torch.core.ctsf import BandedCTSF
    g = precond.grid
    t = g.t
    dr, R, c = precond.damped(stats)
    A = dense_from_ctsf(torch, BandedCTSF(g, dr, R, c), torch.float64, symmetric=True)
    L = torch.tril(dense_from_ctsf(torch, BandedCTSF(g, factor["Dr"], factor["R"], factor["C"]),
                                   torch.float64, symmetric=False))
    rhs = torch.cat([lsk.reshape(-1), ask]).double()
    x64 = torch.linalg.solve(A, rhs)
    sol_l, sol_a = precond.solve_sketch(factor, lsk, ask)
    x = torch.cat([sol_l.reshape(-1), sol_a]).double()
    blk = torch.zeros_like(A)
    for i in range(g.n_diag_tiles + g.n_arrow_tiles):
        blk[i * t:(i + 1) * t, i * t:(i + 1) * t] = A[i * t:(i + 1) * t, i * t:(i + 1) * t]
    ev = torch.linalg.eigvalsh(A)
    scale, xs = A.abs().max(), x64.abs().max()
    return dict(residual=((L @ L.mT - A).abs().max() / scale).item(),
                solve_forward_error=((x - x64).abs().max() / xs).item(),
                blockdiag_residual=((blk - A).abs().max() / scale).item(),
                blockdiag_forward_error=((torch.linalg.solve(blk, rhs) - x64).abs().max()
                                         / xs).item(),
                stats_max=max(stats[k].abs().max().item() for k in ("Dr", "R", "C")),
                damping=precond.damping, min_eig=ev.min().item(), max_eig=ev.max().item())


def check_arrowhead_factor(torch, precond, snaps, grads):
    """At each snapshot, the gates of :func:`arrowhead_gates` (factor
    residual ≤ RESIDUAL_LIMIT, A⁻¹ĝ forward error ≤ SOLVE_RTOL) on the
    main path's own factor of the lm statistics, and on the card's
    ``factorize`` of the same statistics at unit max, where the
    block-diagonal factor must fail both gates (else they could not tell a
    factor that dropped the off-diagonal tiles); then with damping 1 on a
    fresh state (A = I) ``precondition`` returns ``grads``."""
    import dataclasses
    from repro_torch import pytree
    lsk, ask = precond.sketch(grads)
    out = {}
    for s, snap in sorted(snaps.items()):
        unit, _ = arrowhead_unit_stats(snap["precond"])
        for name, stats, factor in (("lm", snap["precond"], snap["factor"]),
                                    ("unit", unit, precond.factorize(unit))):
            rec = arrowhead_gates(torch, precond, stats, factor, lsk, ask)
            out[f"step{s}_{name}"] = rec
            if not (rec["residual"] <= RESIDUAL_LIMIT and rec["solve_forward_error"] <= SOLVE_RTOL):
                raise AssertionError(f"arrowhead at step {s}, {name} statistics: factor residual "
                                     f"{rec['residual']:.3e} (limit {RESIDUAL_LIMIT}), A⁻¹ĝ "
                                     f"forward error {rec['solve_forward_error']:.3e} (limit "
                                     f"{SOLVE_RTOL}): {rec}")
            if name == "unit" and not (rec["blockdiag_residual"] > RESIDUAL_LIMIT
                                       and rec["blockdiag_forward_error"] > SOLVE_RTOL):
                raise AssertionError(f"arrowhead at step {s}: on unit-max statistics a "
                                     f"block-diagonal factor passes the gates: {rec}")
    unit = dataclasses.replace(precond, damping=1.0)
    d = unit.precondition(unit.factorize(unit.init_state(lsk.device)), grads)
    ident = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(pytree.leaves(d), pytree.leaves(grads)))
    out["identity_rel_err"] = ident
    if not ident <= IDENTITY_LIMIT:
        raise AssertionError(f"arrowhead with A = I: precondition moved the gradient by "
                             f"{ident:.3e} of its max (limit {IDENTITY_LIMIT})")
    return out


def check_precond_reaches_update(torch, cfg, out, batch):
    """One arrowhead train step (a refresh step) on a copy of the trained
    state against the same step written out from the entry points: the
    clipped gradient, ``update_stats``, ``factorize``, ``precondition``,
    then ``adamw_update`` of the preconditioned gradient.  The parameters
    must agree with it, relative to how far the same update of the raw
    gradient lands from it (they differ at the plans' coordinates): a step
    that handed AdamW the raw gradient fails.  The step's statistics and
    factor must agree too."""
    import copy
    from repro_torch import pytree
    from repro_torch.optim.adamw import adamw_update
    state, precond, run = out["state"], out["precond"], out["run"]
    step = int(state.step)
    stepped = copy.deepcopy(state)
    _, m = out["step_fn"](stepped, batch)
    grads = lm_grads(torch, cfg, run, state.params, batch)
    stats = precond.update_stats(state.precond, grads)
    factor = precond.factorize(stats) if step % run.precond_every == 0 else state.factor
    explicit = {}
    for name, g in (("preconditioned", precond.precondition(factor, grads)), ("raw", grads)):
        s = copy.deepcopy(state)
        adamw_update(g, s.opt, s.params, m["lr"], weight_decay=run.weight_decay)
        explicit[name] = pytree.leaves(s.params)
    got = pytree.leaves(stepped.params)
    err = max((a - b).abs().max().item() for a, b in zip(got, explicit["preconditioned"]))
    gap = max((a - b).abs().max().item()
              for a, b in zip(explicit["raw"], explicit["preconditioned"]))
    stat_err = max(((stepped.precond[k] - stats[k]).abs().max()
                    / stats[k].abs().max()).item() for k in ("Dr", "R", "C"))
    fac_err = max(((stepped.factor[k] - factor[k]).abs().max()
                   / factor[k].abs().max()).item() for k in ("Dr", "R", "C"))
    rec = dict(step=step, refresh=step % run.precond_every == 0, param_err=err,
               raw_gradient_gap=gap, stats_rel_err=stat_err, factor_rel_err=fac_err)
    if not gap > 0:
        raise AssertionError(f"arrowhead step: the preconditioned and the raw gradient give "
                             f"the same update, the check would be vacuous: {rec}")
    rec["param_err_of_gap"] = err / gap
    if not (err <= PRECOND_STEP_TOL * gap and stat_err <= TOL and fac_err <= TOL):
        raise AssertionError(f"arrowhead step against adamw_update(precondition(...)): {rec} "
                             f"(limits {PRECOND_STEP_TOL} of the raw gradient's gap, {TOL})")
    return rec


def assert_parts(torch, got, want, diag, what):
    """``got`` against ``want``, each part relative to its own size in
    ``want``: with ``diag`` (a mask) the diagonal entries apart from every
    other, so the off-diagonal entries of a nearly diagonal factor are held
    to their own scale; a part that is zero in ``want`` must be zero in
    ``got``.  Returns the largest relative error."""
    parts = [torch.ones_like(want, dtype=torch.bool)] if diag is None else [diag, ~diag]
    errs = [0.0]
    for mask in parts:
        w, gm = want[mask], got[mask]
        scale = w.abs().max().item() if w.numel() else 0.0
        if scale == 0:
            if not torch.equal(gm, w):
                raise AssertionError(f"{what}: nonzero where the plain version is zero")
            continue
        errs.append(assert_update(gm, w, scale, what))
    return max(errs)


def arrowhead_kernel_cases(torch, ref, kern, precond, stats, factor, lsk, ask):
    """Each kernel of the arrowhead's path on the inputs the path gives it:
    the band-Cholesky sweep of ``damped(stats)``, the corner's potrf and
    trsm, both band-solve sweeps and solve_panel at k = 1 on ``factor`` and
    the sketch.  Name -> (kernel call, plain call, the plain call with every
    off-diagonal tile (a tile's off-diagonal entries, for the corner's
    tile kernels) of its factor input zeroed, the outputs' diagonal masks,
    calls a timing, flops, bytes)."""
    from repro_torch.kernels.ring import band_row_to_col, chunk_layout
    g = precond.grid
    t, ndt, nat = g.t, g.n_diag_tiles, g.n_arrow_tiles
    dr, R, c = precond.damped(stats)
    Ac = band_row_to_col(dr)
    nch = max(1, min(4, ndt))
    sweep = kern["band_cholesky_sweep"](Ac, R, nchunks=nch)
    corner = (c - sweep[2].sum(dim=0))[0, 0].contiguous()
    lkk = ref.potrf_ref(corner)
    col = (c - sweep[2].sum(dim=0))[:, 0].contiguous()
    bd = lsk.reshape(ndt, t, 1).contiguous()
    xa = ask.reshape(nat, t, 1).contiguous()
    lc = factor["C"][0, 0].contiguous()
    fdr, fr = factor["Dr"], factor["R"]
    # the inputs with their off-diagonal part dropped
    Ac0, fdr0 = Ac.clone(), fdr.clone()
    Ac0[:, 1:] = 0
    fdr0[:, 1:] = 0
    R0, fr0 = torch.zeros_like(R), torch.zeros_like(fr)
    diag_of = lambda x: torch.diag_embed(x.diagonal())
    eye = torch.eye(t, dtype=torch.bool, device=lc.device)
    band_diag = torch.zeros_like(Ac, dtype=torch.bool)
    band_diag[:, 0] = eye
    no = None
    return {
        "band_cholesky_sweep": (lambda: kern["band_cholesky_sweep"](Ac, R, nchunks=nch),
                                lambda: ref.band_cholesky_sweep_ref(Ac, R, nchunks=nch),
                                lambda: ref.band_cholesky_sweep_ref(Ac0, R0, nchunks=nch),
                                (band_diag, no, no, no), 1, needed_flops(g)[0],
                                band_sweep_bytes(g, chunk_layout(ndt, nch)[1])),
        "potrf": (lambda: kern["potrf"](corner), lambda: ref.potrf_ref(corner),
                  lambda: ref.potrf_ref(diag_of(corner)), (eye,), 20,
                  t ** 3 / 3.0, 2 * 4 * t * t),
        "trsm": (lambda: kern["trsm"](lkk, col), lambda: ref.trsm_ref(lkk, col),
                 lambda: ref.trsm_ref(diag_of(lkk), col), (no,), 20,
                 nat * float(t) ** 3, 4 * t * t * (1 + 2 * nat)),
        "band_forward_sweep": (lambda: kern["band_forward_sweep"](fdr, fr, bd),
                               lambda: ref.band_forward_sweep_ref(fdr, fr, bd),
                               lambda: ref.band_forward_sweep_ref(fdr0, fr0, bd), (no, no), 1,
                               *solve_work(g, 1)["band_forward_sweep"]),
        "band_backward_sweep": (lambda: kern["band_backward_sweep"](fdr, fr, bd, xa),
                                lambda: ref.band_backward_sweep_ref(fdr, fr, bd, xa),
                                lambda: ref.band_backward_sweep_ref(fdr0, fr0, bd, xa), (no,), 1,
                                *solve_work(g, 1)["band_backward_sweep"]),
        "solve_panel": (lambda: kern["solve_panel"](lc, xa[0]),
                        lambda: ref.solve_panel_ref(lc, xa[0]),
                        lambda: ref.solve_panel_ref(diag_of(lc), xa[0]), (no,), 20,
                        *solve_work(g, 1)["solve_panel"])}


def check_arrowhead_kernels(torch, ref, kern, precond, state, grads):
    """Each kernel of the arrowhead's path against its plain version, part
    by part (:func:`assert_parts`), on the lm statistics and the main
    path's factor, and on the statistics at unit max and their factor.
    ``dropped_off_diagonal`` is how far the plain version moves, relative
    to its output's max, when its factor input loses its off-diagonal part:
    on the unit-max inputs it must exceed TOL, so a kernel that skipped
    those updates fails.  Returns the records and the lm inputs' cases."""
    lsk, ask = precond.sketch(grads)
    unit, _ = arrowhead_unit_stats(state.precond)
    inputs = {"lm": (state.precond, state.factor), "unit": (unit, precond.factorize(unit))}
    rec, lm_cases = {}, None
    for which, (stats, factor) in inputs.items():
        cases = arrowhead_kernel_cases(torch, ref, kern, precond, stats, factor, lsk, ask)
        lm_cases = lm_cases or cases
        for name, (fk, fp, fp0, diags, *_rest) in cases.items():
            got, want, want0 = fk(), fp(), fp0()
            tup = lambda x: (x,) if torch.is_tensor(x) else tuple(x)
            got, want, want0 = tup(got), tup(want), tup(want0)
            what = f"arrowhead-shape {name}, {which} statistics"
            err = max(assert_parts(torch, a, b, m, what)
                      for a, b, m in zip(got, want, diags + (None,) * len(got)))
            dropped = max(((b - b0).abs().max() / b.abs().max()).item()
                          for b, b0 in zip(want, want0) if b.abs().max() > 0)
            abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
            rec.setdefault(name, {})[which] = dict(rel_err=err, max_abs_err=abs_err,
                                                   dropped_off_diagonal=dropped)
            if which == "unit" and not dropped > TOL:
                raise AssertionError(f"{what}: dropping the off-diagonal part moves the plain "
                                     f"version by {dropped:.3e} of its max, within the "
                                     f"tolerance {TOL}: the check could not see it")
    return rec, lm_cases


def time_arrowhead(torch, ref, kern, precond, state, grads, card):
    """The arrowhead's own device time apart (CUDA graphs of the calls):
    sketch + update_stats, factorize (a refresh step's), precondition; the
    host time of one step's arrowhead calls (enqueue, no synchronize)
    beside their device time; each of its kernels at the arrowhead's shapes
    checked against its plain version (:func:`check_arrowhead_kernels`) and
    timed on the lm inputs, with its bound."""
    g = precond.grid
    stats, factor = state.precond, state.factor
    calls = {"sketch_and_update_stats": lambda: precond.update_stats(stats, grads),
             "factorize": lambda: precond.factorize(stats),
             "precondition": lambda: precond.precondition(factor, grads)}
    rec = {k: device_ms(torch, fn) for k, fn in calls.items()}
    rec["call_ms"] = {k: time_ms(torch, fn) for k, fn in calls.items()}

    def every_step():
        precond.update_stats(stats, grads)
        precond.precondition(factor, grads)

    def refresh_step():
        precond.factorize(precond.update_stats(stats, grads))
        precond.precondition(factor, grads)

    for name, fn in (("step", every_step), ("refresh_step", refresh_step)):
        fn()
        torch.cuda.synchronize()
        host = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        rec[f"{name}_host_ms"] = statistics.median(host)
        rec[f"{name}_device_ms"] = device_ms(torch, fn)
    checks, cases = check_arrowhead_kernels(torch, ref, kern, precond, state, grads)
    kernels = {}
    for name, (fk, fp, _fp0, _diags, inner, flops, nbytes) in cases.items():
        b_ms, b_by = bound(flops, nbytes)
        kernels[name] = dict(shape=dict(t=g.t, ndt=g.n_diag_tiles, bt=g.band_tiles,
                                        nat=g.n_arrow_tiles, k=1),
                             max_abs_err=checks[name]["lm"]["max_abs_err"], checks=checks[name],
                             ms=device_ms(torch, fk, calls=inner),
                             plain_ms=device_ms(torch, fp, calls=inner),
                             bound_ms=b_ms, bound_by=b_by)
    rec["kernels"] = kernels
    log("time arrowhead (lm-100m, r = 32, band 2): " + json.dumps(rec) + f", card {card}")
    return rec


def serve_check(torch, cfg, dev):
    """The dense LM server at float32 (``Server.generate``'s tokens), then
    its prefill and decode steps replayed one by one: each step's logits
    against a full forward of the prompt and the tokens so far, at the last
    position; the same argmax wherever the top-2 margin exceeds the
    tolerance."""
    import numpy as np
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.serve import Server, _pad_caches
    run = RunConfig(compute_dtype="float32", remat="none", loss_chunk=128)
    server = Server(cfg, run, max_len=SERVE_PROMPT + SERVE_GEN, seed=0, device=dev)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))
    out = server.generate({"tokens": prompt}, SERVE_GEN)
    model = server.model
    toks = torch.as_tensor(prompt).to(dev)
    with torch.no_grad():
        logits, caches = model.prefill(toks)
        caches = _pad_caches(caches, server.max_len)
        steps, tok = [], torch.argmax(logits, -1)[:, None]
        gen = [tok]
        for i in range(SERVE_GEN - 1):
            logits, caches = model.decode_step(caches, tok, SERVE_PROMPT + i)
            steps.append(logits)
            tok = torch.argmax(logits, -1)[:, None]
            gen.append(tok)
        gen = torch.cat(gen, 1)
        if not np.array_equal(gen.cpu().numpy(), out["tokens"]):
            raise AssertionError("serve: the replayed decode's tokens differ from "
                                 "Server.generate's")
        seq = torch.cat([toks, gen], 1)
        errs, flips = [], 0
        for i, dec in enumerate(steps):
            full, _ = model.prefill(seq[:, :SERVE_PROMPT + i + 1])
            scale = full.abs().max()
            errs.append(((dec - full).abs().max() / scale).item())
            top2 = torch.topk(full, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > LOGIT_RTOL * scale
            flips += int((sure & (dec.argmax(-1) != full.argmax(-1))).sum())
    rec = dict(batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN, compute_dtype="float32",
               decode_logit_rel_err_max=max(errs), argmax_flips=flips)
    if not (max(errs) <= LOGIT_RTOL and flips == 0):
        raise AssertionError(f"serve: decode logits against the full forward: {rec}")
    del server, caches
    # bfloat16: a warm generate, then the timed one
    server = Server(cfg, RunConfig(remat="none", loss_chunk=128), max_len=SERVE_PROMPT + SERVE_GEN,
                    seed=0, device=dev)
    server.generate({"tokens": prompt}, SERVE_GEN)
    timed = server.generate({"tokens": prompt}, SERVE_GEN)
    rec["bf16"] = dict(prefill_ms=timed["prefill_s"] * 1e3, decode_s=timed["decode_s"],
                       decode_tok_per_s=timed["decode_tok_per_s"])
    return rec


def phase_lm(torch, run_path, kern, ref, counts, card):
    """The LM substrate on the card (see the module docstring, phase 3's
    "lm").  Returns the phase's record and its launches per call."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.synthetic import MarkovStream, token_batch
    from repro_torch.examples.train_lm import model_100m
    dev = "cuda:0"
    t_phase = time.perf_counter()
    cfg = model_100m()
    stream = MarkovStream(cfg.vocab, seed=0)
    batches = [stream.batch(s, LM_BATCH, LM_SEQ) for s in range(LM_STEPS)]
    rec, per_call, finals = {"lm-100m": {}}, [], {}
    for opt in ("adamw", "arrowhead"):
        out = run_path(f"lm: lm-100m, {opt}, {LM_STEPS} steps", lambda: lm_train(
            torch, cfg, opt, batches, counts, LM_CHECK_STEPS, dev))
        what = f"lm-100m {opt}"
        r = dict(steps=LM_STEPS, batch=LM_BATCH, seq=LM_SEQ, compute_dtype=out["run"].compute_dtype,
                 step_ms_median=statistics.median(out["step_ms"]), step_ms=out["step_ms"],
                 peak_bytes=out["peak_bytes"], **check_losses(out["losses"], what))
        r["tokens_per_s"] = LM_BATCH * LM_SEQ / (r["step_ms_median"] / 1e3)
        check_step_launches(out["launches"], out["precond"], out["run"].precond_every, what)
        r["launches_per_step"] = out["launches"][:2]
        if out["precond"] is not None:
            per_call += [("lm-100m", "arrowhead train step, refresh", out["launches"][0]),
                         ("lm-100m", "arrowhead train step", out["launches"][1])]
            grads = lm_grads(torch, cfg, out["run"], out["state"].params, batches[0])
            r["factor_checks"] = check_arrowhead_factor(torch, out["precond"], out["snaps"],
                                                        grads)
            r["update_check"] = check_precond_reaches_update(torch, cfg, out, batches[-1])
            r["times"] = time_arrowhead(torch, ref, kern, out["precond"], out["state"], grads,
                                        card)
            g = out["precond"].grid
            r["grid"] = dict(t=g.t, ndt=g.n_diag_tiles, bt=g.band_tiles, nat=g.n_arrow_tiles)
            del grads
        r["probe"] = probe_steps(torch, out["step_fn"], out["state"], batches[-1])
        rec["lm-100m"][opt] = r
        log(f"lm: lm-100m, {opt}: " + json.dumps({k: v for k, v in r.items() if k != "times"})
            + f", card {card}")
        finals[opt] = (out["step_fn"], out["state"])
        del out
    # the two optimizers' steps in turns on one card (host noise moves a
    # run's median by tens of percent between runs)
    rec["lm-100m"]["in_turns"] = steps_in_turns(torch, finals, batches[-1])
    log("lm: lm-100m, AdamW and arrowhead steps in turns: "
        + json.dumps(rec["lm-100m"]["in_turns"]) + f", card {card}")
    del finals
    torch.cuda.empty_cache()
    # qwen2-7b at its published widths, n_layers cut to 2 (band 2 over 2
    # layers: the grid clips the band to bt = ndt - 1 = 1)
    qcfg = dataclasses.replace(configs.get("qwen2-7b"), n_layers=QWEN_LAYERS)
    qbatches = [token_batch(0, s, QWEN_BATCH, QWEN_SEQ, qcfg.vocab) for s in range(QWEN_STEPS)]
    rec["qwen2-7b"] = dict(n_layers=QWEN_LAYERS, cut="n_layers 28 -> 2; widths as published")
    for opt in ("adamw", "arrowhead"):
        out = run_path(f"lm: qwen2-7b at 2 layers, {opt}", lambda: lm_train(
            torch, qcfg, opt, qbatches, counts, (), dev))
        what = f"qwen2-7b at 2 layers, {opt}"
        if not all(math.isfinite(v) for v in out["losses"]):
            raise AssertionError(f"{what}: losses {out['losses']}")
        check_step_launches(out["launches"], out["precond"], out["run"].precond_every, what)
        from repro_torch import pytree
        rec["qwen2-7b"]["params"] = sum(p.numel() for p in pytree.leaves(out["state"].params))
        rec["qwen2-7b"][opt] = dict(losses=out["losses"], step_ms=out["step_ms"],
                                    peak_bytes=out["peak_bytes"],
                                    launches_per_step=out["launches"])
        if out["precond"] is not None:
            g = out["precond"].grid
            rec["qwen2-7b"]["grid"] = dict(t=g.t, ndt=g.n_diag_tiles, bt=g.band_tiles,
                                           nat=g.n_arrow_tiles)
        log(f"lm: {what}: " + json.dumps(rec["qwen2-7b"][opt]) + f", card {card}")
        del out
        torch.cuda.empty_cache()
    rec["serve"] = run_path("lm: dense LM server, lm-100m", lambda: serve_check(torch, cfg, dev))
    log("lm: serve: " + json.dumps(rec["serve"]) + f", card {card}")
    # the examples' twins
    from repro_torch.examples import distributed_factorization, inla_gmrf
    inla = run_path("lm: INLA twin", lambda: inla_gmrf.main([]))
    f = inla["objective"]
    if not (all(math.isfinite(v) for v in f) and all(b <= a for a, b in zip(f, f[1:]))
            and np.isfinite([inla["sd_min"], inla["sd_max"]] + inla["corr"]).all()
            and inla["samples_finite"]):
        raise AssertionError(f"INLA twin: objective non-increasing and finite summaries: {inla}")
    rec["inla"] = inla

    def distributed_world1():
        import tempfile
        import torch.distributed as dist
        with tempfile.TemporaryDirectory(prefix="repro_torch_lm_store_") as tmp:
            nccl_world_of_one(torch, Path(tmp) / "store")
            try:
                return distributed_factorization.main([])
            finally:
                dist.destroy_process_group()

    dist_rec = run_path("lm: distributed twin, world 1 (NCCL)", distributed_world1)
    if not (dist_rec["window_rel_err"] <= 1e-4 and dist_rec["dense_max_err"] <= 1e-4):
        raise AssertionError(f"distributed twin at world 1: {dist_rec}")
    rec["distributed"] = dist_rec
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"phase lm: {rec['wall_s']:.1f} s; " + json.dumps(
        {k: v for k, v in rec.items() if k not in ("lm-100m",)}) + f", card {card}")
    return rec, per_call


def time_ms(torch, fn, inner=1, reps=7, warmup=2):
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls a rep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def device_ms(torch, fn, calls=1, reps=5):
    """Device time per call: ``calls`` calls captured in one CUDA graph and
    replayed between CUDA events, so no host launch gaps enter; median of
    ``reps`` replays.  The kernels and their plain versions are timed alike.
    None when ``fn`` cannot be captured (it waits on the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()        # handles and workspaces are made outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as err:
        log(f"  not captured: {str(err).splitlines()[0]}")
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    del graph
    return statistics.median(times)


def launches_per_call(records, precords, extra, name):
    """Launches of kernel ``name`` per call of each entry point on each
    matrix of the main paths; ``extra`` adds ``(matrix, call, launches)``
    entries of the paths without a record of their own."""
    out = {}
    for r in records:
        calls = [("factorize_window", r["launches"])] + list(r["solves"]["launches"].items())
        calls += [(f"factorize_tasklist_{k} first call", v["launches"])
                  for k, v in r["tasklist"].items() if isinstance(v, dict) and "launches" in v]
        out[str(r["matrix"])] = {c: n[name] for c, n in calls if n.get(name)}
    for r in precords:
        if r["launches"].get(name):
            out.setdefault(str(r["matrix"]), {})["factorize_window partitioned"] = \
                r["launches"][name]
    for matrix, call, launches in extra:
        if launches.get(name):
            out.setdefault(str(matrix), {})[call] = launches[name]
    return {k: v for k, v in out.items() if v}


def bound(flops, nbytes):
    tf, tb = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def solve_work(grid, k):
    """(operations, bytes) each new kernel needs at ``grid``'s shapes with
    k right-hand sides, counted from the tiles the data has: a panel
    product 2 t^2 k, a triangular solve t^2 per column; in selinv column j
    (d = band tiles below it) the (d + nat)^2 Σ-row products at 2 t^3, the
    d + nat products by the triangular W = L_jj^{-1} (TRMM, t^3), the
    d + nat products summed into the symmetric Σ_jj (SYRK, t^3), W^T W and
    the triangular inverse W (t^3 / 3 each); each input read once and each
    output written once."""
    t, ndt, bt, nat = grid.t, grid.n_diag_tiles, grid.band_tiles, grid.n_arrow_tiles
    tt, tk = t * t, t * k
    below = [min(bt, ndt - 1 - m) for m in range(ndt)]   # band tiles under column m
    band = sum(below)                                      # = band tiles above each row
    fwd_ops = 2 * tt * k * (band + nat * ndt) + tt * k * ndt
    sweep_bytes = 4 * ((band + ndt) * tt + ndt * nat * tt + 2 * ndt * tk + nat * tk)
    sel_ops = float(t) ** 3 * sum(2 * (d + nat) ** 2 + 2 * (d + nat) + 2 / 3.0 for d in below)
    sel_bytes = 4 * (2 * (band + ndt) * tt + 2 * ndt * nat * tt + nat * nat * tt)
    # the selinv pre-pass alone: W and W^T W (t^3 / 3 each), the d + nat
    # products by the triangular W (t^3), the nat^2 corner products (2 t^3);
    # reads the factor's band and arrow tiles and the corner seed, writes
    # bt + 2 nat + 2 work tiles a column
    pre_ops = float(t) ** 3 * sum(2 / 3.0 + d + nat + 2 * nat * nat for d in below)
    pre_bytes = 4 * tt * ((band + ndt) + ndt * nat + nat * nat + ndt * (bt + 2 * nat + 2))
    return {"solve_panel": (float(tt * k), 4 * (tt + 2 * tk)),
            "band_forward_sweep": (float(fwd_ops), sweep_bytes),
            "band_backward_sweep": (float(fwd_ops), sweep_bytes),
            "selinv_sweep": (sel_ops, sel_bytes),
            "selinv_prepass": (pre_ops, pre_bytes)}


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: no src/repro_torch beside this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on an H100", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.band_cholesky import (band_cholesky_partitioned_sweep_cuda,
                                                   band_cholesky_sweep_cuda)
    from repro_torch.kernels.band_solve import band_backward_sweep_cuda, band_forward_sweep_cuda
    from repro_torch.kernels.band_update import band_update_cuda
    from repro_torch.kernels.gemm import geadd_cuda, gemm_cuda, syrk_cuda
    from repro_torch.kernels.potrf import potrf_cuda
    from repro_torch.kernels.selinv import (selinv_prepass_cuda, selinv_step_cuda,
                                            selinv_sweep_cuda)
    from repro_torch.kernels.trsm import solve_panel_cuda, trsm_cuda
    from repro_torch.kernels.ring import band_row_to_col, chunk_layout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda:0"
    kern = {"potrf": potrf_cuda, "trsm": trsm_cuda, "band_cholesky_sweep": band_cholesky_sweep_cuda,
            "solve_panel": solve_panel_cuda, "band_forward_sweep": band_forward_sweep_cuda,
            "band_backward_sweep": band_backward_sweep_cuda, "selinv_sweep": selinv_sweep_cuda,
            "gemm": gemm_cuda, "syrk": syrk_cuda, "geadd": geadd_cuda,
            "band_cholesky_partitioned_sweep": band_cholesky_partitioned_sweep_cuda,
            "band_update": band_update_cuda, "selinv_step": selinv_step_cuda,
            "selinv_prepass": selinv_prepass_cuda}

    from repro_torch.core.cholesky import tasklist_graphs
    from repro_torch.runtime.telemetry import device_counts, graph_caches

    def counts():
        return device_counts(kern)

    path_launches = {}
    # bit-identity gates whose failure is reported after the timings
    deferred = []

    def run_path(name, fn):
        """One path of the main run: every count set to 0 just before it and
        read just after."""
        for k in kern.values():
            k.launches = 0
        for cache in graph_caches():
            cache.recorded.clear()
            cache.replayed.clear()
        out = fn()
        torch.cuda.synchronize()
        path_launches[name] = {k: v for k, v in counts().items() if v}
        log(f"launches, {name}: {json.dumps(path_launches[name])}")
        return out

    run_path.launches = path_launches

    # 1. card and build
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(_build.SOURCES)}")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    n = phase_kernels(torch, dev, kern, ref)
    n += phase_solve_kernels(torch, dev, kern, ref)
    n += phase_batched_read_kernels(torch, dev, kern, ref)
    n += phase_tasklist_kernels(torch, dev, kern, ref)
    n += phase_window_kernels(torch, dev, kern, ref)
    torch.cuda.synchronize()
    log(f"kernels: {n} comparisons with the plain versions pass "
        f"(rtol=atol={TOL}) in {time.perf_counter() - t0:.1f} s")

    # 3. main paths at full size, each with its counts reset just before
    #    and read just after: the window factorization and the solves, the
    #    task list, the partitioned route, the quickstart
    records, mats = [], {}

    from repro_torch.core.solve import corner_graphs

    def window_path(mid):
        rec, m, f = run_matrix(torch, mid, kern_counts=counts)
        records.append(rec)
        mats[mid] = (m, f)
        log(f"main path: Table II matrix {mid}: " + json.dumps(rec))
        captures = corner_graphs.captures
        rec["solves"] = run_solves(torch, mid, m, f, counts)
        log(f"main path, solves: Table II matrix {mid}: " + json.dumps(rec["solves"]))
        return rec, corner_graphs.captures - captures

    # a path a matrix, each followed (outside the counted path, as the task
    # list's graph checks below) by the corner's graphs replayed: a second
    # pass of the solves, a θ step, the graph against the eager corner; the
    # next matrix's keys would push this one's out of the cache
    for mid in TABLE2_IDS:
        rec, first_captures = run_path(f"factorize_window and solves, matrix {mid}",
                                       lambda: window_path(mid))
        rec["solve_graph"] = check_solve_graph(torch, mid, *mats[mid], counts, first_captures)
        log(f"main path, the solves' corner graphs: Table II matrix {mid}: "
            + json.dumps(rec["solve_graph"]))
    tms = {}

    tfactors, tm2s = {}, {}

    def tasklist_path():
        for rec in records:
            m, f = mats[rec["matrix"]]
            rec["tasklist"], tms[rec["matrix"]], tfactors[rec["matrix"]] = run_tasklist(
                torch, rec["matrix"], m, f, rec, counts)
            log(f"main path, task list: Table II matrix {rec['matrix']}: "
                + json.dumps(rec["tasklist"]))

    run_path("factorize_tasklist", tasklist_path)
    # the graph's later calls, a θ step of the same pattern, the eager loop
    for rec in records:
        mid = rec["matrix"]
        rec["tasklist"]["graph"], tm2s[mid] = check_tasklist_graph(
            torch, mid, tms[mid], tfactors.pop(mid), counts)
        log(f"main path, task list's CUDA graph: Table II matrix {mid}: "
            + json.dumps(rec["tasklist"]["graph"]))
    pmats = {mid: partitioned_matrix(torch, mid) for mid in PARTITIONED_IDS}
    pfs = run_path("partitioned factorize_window", lambda: {
        mid: run_partitioned(torch, mid, m, plan, counts) for mid, (m, plan, _) in pmats.items()})
    precords = []
    for mid, (m, plan, host_s) in pmats.items():
        precords.append(check_partitioned(torch, mid, m, plan, *pfs[mid], host_s))
        log(f"main path, partitioned: Table II matrix {mid}: " + json.dumps(precords[-1]))
    # the window route on the window path's two matrices, against the fused
    # route's factor of each
    wfs = run_path("factorize_window, sweep='window'", lambda: {
        mid: run_window(torch, mid, mats[mid][0], counts) for mid in TABLE2_IDS})
    extra_calls = []
    for rec in records:
        mid = rec["matrix"]
        rec["window"] = check_window(torch, mid, mats[mid][0], wfs[mid][0], mats[mid][1],
                                     wfs[mid][1], rec)
        extra_calls.append((mid, "factorize_window window", wfs[mid][1]))
        log(f"main path, window route: Table II matrix {mid}: " + json.dumps(rec["window"]))
    # the θ-sweep: BATCH candidates of matrix 5 (fused and window routes)
    # and of matrix 4 (partitioned route, its plan)
    m5, f5 = mats[TABLE2_IDS[0]]
    mp4, pplan4, _ = pmats[PARTITIONED_IDS[0]]
    mb5, thetas5 = theta_batch(torch, m5, BATCH, seed=TABLE2_IDS[0])
    mb4, thetas4 = theta_batch(torch, mp4, BATCH, seed=PARTITIONED_IDS[0])
    fbs = run_path("factorize_window_batched",
                   lambda: run_batched(torch, mb5, mb4, pplan4, counts))
    batched = check_batched(torch, mb5, mb4, pplan4, fbs)
    for route, r in batched.items():
        extra_calls.append((r["matrix"], f"factorize_window_batched {route}", r["launches"]))
    log("main path, factorize_window_batched: " + json.dumps(batched))
    # the batched kernels against their plain versions on the θ-batches
    batched_errs, w5b = check_batched_kernels(torch, ref, mb5, mb4, pplan4, fbs["window"][0])
    log("main path, batched kernels against their plain versions: " + json.dumps(batched_errs))
    # the θ-batch's read-out on its fused batched factor: solve_many_batched
    # (k = 1 and 32) and selinv_batched, each element against the unbatched
    # call on it
    fb5 = fbs["fused"][0]
    B32b = theta_rhs(torch, m5.grid, BATCH, 32, seed=TABLE2_IDS[0], device=dev)
    theta_out, theta_launches = run_path("θ-batch solves and selected inverse, matrix 5",
                                         lambda: run_theta_read(torch, fb5, B32b, counts))
    theta_read = check_theta_read(torch, mb5, fb5, B32b, theta_out, deferred)
    theta_read["launches"] = theta_launches
    for call, got in theta_launches.items():
        extra_calls.append((TABLE2_IDS[0], call, got))
    log("main path, θ-batch solves and selected inverse: " + json.dumps(theta_read))
    # breakdown recovery on the same batch with an indefinite and a NaN element
    mbf, ftile = faulted_theta_batch(torch, mb5)
    rec_out, rec_launches = run_path("breakdown recovery, matrix 5", lambda: run_recovery(
        torch, mbf, m5, B32b, counts))
    recovery = check_recovery(torch, mb5, mbf, ftile, m5, B32b, rec_out)
    recovery["launches"] = rec_launches
    for call, got in rec_launches.items():
        extra_calls.append((TABLE2_IDS[0], call, got))
    log("main path, breakdown recovery: " + json.dumps(recovery))
    # selinv_step on the Takahashi column of an interior column of matrix 5
    from repro_torch.core import selected_inverse
    from repro_torch.kernels import ops
    jcol = m5.grid.n_diag_tiles // 2
    srow, gcat, want_col = takahashi_column(torch, f5, selected_inverse(f5), jcol)
    col = run_path("selinv_step on a Takahashi column", lambda: -ops.selinv_step(srow, gcat))
    takahashi = dict(matrix=TABLE2_IDS[0], column=jcol, s_row=list(srow.shape),
                     rel_err=((col - want_col).abs().max() / want_col.abs().max()).item(),
                     launches=path_launches["selinv_step on a Takahashi column"])
    extra_calls.append((TABLE2_IDS[0], "ops.selinv_step", takahashi["launches"]))
    if not takahashi["rel_err"] <= 1e-4:
        raise AssertionError(f"selinv_step on column {jcol} of matrix 5's Σ: error "
                             f"{takahashi['rel_err']:.3e} of the column's max (limit 1e-4)")
    log("main path, Takahashi column: " + json.dumps(takahashi))
    from repro_torch.quickstart import main as quickstart
    qs = run_path("quickstart", lambda: quickstart([]))
    if not (qs["tasklist_agreement"] <= AGREEMENT_LIMIT
            and all(math.isfinite(v) for v in (qs["solve_residual"], qs["logdet"]))):
        raise AssertionError(f"quickstart: task-list agreement {qs['tasklist_agreement']:.3e} "
                             f"(limit {AGREEMENT_LIMIT}), {qs}")
    # canonical-grid bucketing at full width (GridBucketPolicy(), t = 64):
    # #5's main path on its (256, 4, 4) rung; the partitioned and window
    # routes; a mixed stream on one rung; a stacked mixed batch through the
    # concurrent entry points; bucket= on a θ-batch of 5
    bucketing = {}
    fp5, main_out, main_launches5 = run_path("bucketing: factorize_window and solves, matrix 5",
                                             lambda: run_bucketed_main(torch, m5, counts))
    bucketing["main"] = check_bucketed_main(torch, m5, f5, fp5, main_out)
    bucketing["main"]["launches"] = main_launches5
    del main_out
    for call, got in main_launches5.items():
        extra_calls.append((TABLE2_IDS[0], f"{call}, bucketed", got))
    log("main path, bucketing, matrix 5: " + json.dumps(bucketing["main"]))
    bucketing["routes"] = run_path("bucketing: partitioned and window routes",
                                   lambda: run_bucketed_routes(
                                       torch, m5, wfs[TABLE2_IDS[0]][0], mp4, pplan4,
                                       pfs[PARTITIONED_IDS[0]][0], counts))
    log("main path, bucketing, partitioned and window routes: "
        + json.dumps(bucketing["routes"]))
    stream = stream_matrices(torch)
    stream_out, bucketing["stream"] = run_path("bucketing: mixed stream on one rung",
                                               lambda: run_stream(torch, stream, counts))
    bucketing["stream"]["elements"] = check_stream(torch, stream, stream_out)
    del stream_out
    log("main path, bucketing, mixed stream: " + json.dumps(bucketing["stream"]))
    stacked_mats = [mats[TABLE2_IDS[0]], (mp4, pfs[PARTITIONED_IDS[0]][0]), mats[TABLE2_IDS[1]]]
    stacked_out, stacked_launches = run_path(
        "bucketing: stacked batch, concurrent entry points",
        lambda: run_stacked(torch, stacked_mats, counts))
    bucketing["stacked"] = check_stacked(torch, stacked_mats, stacked_out)
    bucketing["stacked"]["launches"] = stacked_launches
    del stacked_out
    log("main path, bucketing, stacked batch: " + json.dumps(bucketing["stacked"]))
    bucket_out, bucketing["bucket"] = run_path("bucketing: bucket=True",
                                               lambda: run_bucket(torch, mb5, B32b, counts))
    bucketing["bucket"]["against_unpadded"] = check_bucket(torch, bucket_out, B32b, deferred)
    del bucket_out
    log("main path, bucketing, bucket=True: " + json.dumps(bucketing["bucket"]))
    # the distributed path: world 1 in this process over NCCL, the gloo
    # worlds sharing the card; then telemetry on the main paths
    distributed = phase_distributed(torch, run_path, mb5, fb5, mbf, card)
    telemetry_rec = phase_telemetry(torch, run_path, m5, f5, mbf, stream, B32b, card)
    for what, r in (("distributed", distributed), ("telemetry", telemetry_rec)):
        log(f"phase {what}: " + json.dumps(r))
    # the rung server on a mixed-size INLA request stream
    serving_rec, serving = phase_serving(torch, run_path, counts, card)
    extra_calls.append(("serving", "RungServer, cold replay of 48 requests",
                        path_launches["serving: cold replay"]))
    # the LM substrate: lm-100m trained with AdamW and the arrowhead
    # preconditioner, qwen2-7b at 2 layers, the dense LM server, the twins
    lm_rec, lm_calls = phase_lm(torch, run_path, kern, ref, counts, card)
    extra_calls += lm_calls
    main_launches = {k: sum(p.get(k, 0) for p in path_launches.values()) for k in kern}
    unused = [k for k, v in main_launches.items() if not v]
    if unused:
        raise AssertionError(f"kernels the main paths never launched: {unused}")

    # 4. timings at the main path's shapes (matrix 5), kernel vs plain
    m, f = mats[TABLE2_IDS[0]]
    g = m.grid
    ndt, bt, nat, t = g.n_diag_tiles, g.band_tiles, g.n_arrow_tiles, g.t
    sweep_ops, _ = needed_flops(g)
    nchunks = max(1, min(8, ndt))
    Ac = band_row_to_col(m.Dr)
    sweep_k = lambda: band_cholesky_sweep_cuda(Ac, m.R, nchunks=nchunks)
    sweep_p = lambda: ref.band_cholesky_sweep_ref(Ac, m.R, nchunks=nchunks)
    got, want = sweep_k(), sweep_p()
    sweep_err = max(assert_close(torch, a, b, f"main-path sweep {p}")
                    for a, b, p in zip(got[:3], want[:3], ("panels", "R_out", "schur")))
    check_status(got[3], want[3], "main-path sweep")
    # the corner's first column: its potrf and trsm inputs
    corner = m.C - got[2].sum(dim=0)
    a_kk = corner[0, 0].contiguous()
    l_kk = ref.potrf_ref(a_kk)
    col = corner[:, 0].contiguous()
    potrf_err = assert_close(torch, potrf_cuda(a_kk), l_kk, "main-path potrf")
    trsm_err = assert_close(torch, trsm_cuda(l_kk, col), ref.trsm_ref(l_kk, col),
                            "main-path trsm")

    csz, nch = chunk_layout(ndt, nchunks)
    # the solve half's inputs at the same shapes: the factor, a k = 32 panel
    from repro_torch.core.selinv import corner_sigma
    from repro_torch.core.solve import _split_rhs
    fc = f.ctsf
    bd32, xa32 = _split_rhs(g, torch.randn((g.padded_n, 32), device=dev,
                                           generator=torch.Generator(device=dev).manual_seed(11)))
    xa32 = xa32.contiguous()
    bd1, xa1 = bd32[..., :1].contiguous(), xa32[..., :1].contiguous()
    l_c, b_c = fc.C[0, 0].contiguous(), xa32[0].contiguous()
    lcol, sc = band_row_to_col(fc.Dr), corner_sigma(fc.C)
    solve_k = {"solve_panel": lambda: solve_panel_cuda(l_c, b_c),
               "band_forward_sweep": lambda: band_forward_sweep_cuda(fc.Dr, fc.R, bd32),
               "band_backward_sweep": lambda: band_backward_sweep_cuda(fc.Dr, fc.R, bd32, xa32),
               "selinv_sweep": lambda: selinv_sweep_cuda(lcol, fc.R, sc)}
    solve_p = {"solve_panel": lambda: ref.solve_panel_ref(l_c, b_c),
               "band_forward_sweep": lambda: ref.band_forward_sweep_ref(fc.Dr, fc.R, bd32),
               "band_backward_sweep": lambda: ref.band_backward_sweep_ref(fc.Dr, fc.R, bd32, xa32),
               "selinv_sweep": lambda: ref.selinv_sweep_ref(lcol, fc.R, sc)}
    errs = {}
    for name in solve_k:
        got, want = solve_k[name](), solve_p[name]()
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        errs[name] = max(assert_close(torch, a, b, f"main-path {name}") for a, b in zip(got, want))
    # the band sweeps' library yardstick: one torch.linalg.solve_triangular
    # on the band block assembled as a dense lower-triangular matrix (once,
    # here); the backward call's right-hand side Y - R^T Xa is formed here
    # too.  It covers the band solve, not the forward sweep's arrow sums
    Lb = band_block_dense(torch, fc.Dr)
    yb = {kk: (b - torch.einsum("miab,iak->mbk", fc.R, x)).reshape(ndt * t, kk)
          for kk, b, x in ((32, bd32, xa32), (1, bd1, xa1))}
    lib_fwd = {kk: (lambda b=b: torch.linalg.solve_triangular(Lb, b.reshape(ndt * t, -1),
                                                               upper=False))
               for kk, b in ((32, bd32), (1, bd1))}
    lib_bwd = {kk: (lambda y=y: torch.linalg.solve_triangular(Lb.mT, y, upper=True))
               for kk, y in yb.items()}
    for kk, bd_k, xa_k in ((32, bd32, xa32), (1, bd1, xa1)):
        for name, got, want in (
                ("forward", lib_fwd[kk]().reshape(ndt, t, kk),
                 ref.band_forward_sweep_ref(fc.Dr, fc.R, bd_k)[0]),
                ("backward", lib_bwd[kk]().reshape(ndt, t, kk),
                 ref.band_backward_sweep_ref(fc.Dr, fc.R, bd_k, xa_k))):
            diff = rel_diff(torch, (got,), (want,))
            if not diff <= 1e-4:
                raise AssertionError(f"the {name} sweep's yardstick at k = {kk}: "
                                     f"{diff:.3e} from the plain version, relative to its max")
    work = solve_work(g, 32)
    prepass_k = lambda: selinv_prepass_cuda(lcol, fc.R, sc)
    prepass_p = lambda: ref.selinv_prepass_ref(lcol, fc.R, sc)
    errs["selinv_prepass"] = assert_close(torch, prepass_k(), prepass_p(), "main-path selinv_prepass")

    # the task list's tiles of matrix 5 as its band GEMM and SYRK tasks with
    # the largest products meet them: C from the matrix, A and B factored.
    # Each is held to its plain version, and also relative to its update
    # A B^T alone
    from repro_torch.core import TaskType, factorize_tasklist
    tm5 = tms[TABLE2_IDS[0]]
    L5 = factorize_tasklist(tm5)
    a_tile = lambda i, j: tm5.tiles[tm5.slot[(i, j)]]
    l_tile = lambda i, j: L5[tm5.slot[(i, j)]]
    gt, st_ = (largest_band_task(torch, tm5, L5, ty) for ty in (TaskType.GEMM, TaskType.SYRK))
    cg, ag, bg = a_tile(gt.m, gt.k), l_tile(gt.m, gt.n), l_tile(gt.k, gt.n)
    cs, as_ = a_tile(st_.k, st_.k), l_tile(st_.k, st_.n)
    # geadd on the operands the tree gives it: the first level's even and
    # odd partials of the first tree chain of matrix 5 (8 workers)
    ga, gb, tree_tile = first_tree_operands(torch, tm5, L5, 8)
    tl_k = {"gemm": lambda: gemm_cuda(cg, ag, bg), "syrk": lambda: syrk_cuda(cs, as_),
            "geadd": lambda: geadd_cuda(ga, gb)}
    tl_p = {"gemm": lambda: ref.gemm_ref(cg, ag, bg), "syrk": lambda: ref.syrk_ref(cs, as_),
            "geadd": lambda: ref.geadd_ref(ga, gb)}
    own = {"gemm": lambda want: (want - cg).abs().max().item(),
           "syrk": lambda want: (want - cs).abs().max().item(),
           "geadd": lambda want: min(ga.abs().max().item(), gb.abs().max().item())}
    rel_errs = {}
    for name in tl_k:
        got, want = tl_k[name](), tl_p[name]()
        errs[name] = assert_close(torch, got, want, f"main-path {name}")
        rel_errs[name] = assert_update(got, want, own[name](want), f"main-path {name}")
    # the partitioned sweep at matrix 4's shapes, with its plan
    pid = PARTITIONED_IDS[0]
    m4, plan4, _ = pmats[pid]
    g4 = m4.grid
    Ac4 = band_row_to_col(m4.Dr)
    part_k = lambda: band_cholesky_partitioned_sweep_cuda(Ac4, m4.R, plan4.boundaries)
    part_p = lambda: ref.band_cholesky_partitioned_sweep_ref(Ac4, m4.R, plan4.boundaries)
    got, want = part_k(), part_p()
    errs["band_cholesky_partitioned_sweep"] = max(
        assert_close(torch, a, b, f"main-path partitioned sweep {p}")
        for a, b, p in zip(got[:3], want[:3], ("panels", "R_out", "schur")))
    check_status(got[3], want[3], "main-path partitioned sweep")
    # geadd on the partitioned route's first tree level: the even and odd
    # Schur leaves, (P // 2, nat, nat, t, t) strided halves
    leaves = got[2]
    pl = 2 * (leaves.shape[0] // 2)
    la, lb = leaves[0:pl:2], leaves[1:pl:2]
    leaf_got, leaf_want = geadd_cuda(la, lb), ref.geadd_ref(la, lb)
    errs["geadd"] = max(errs["geadd"], assert_close(torch, leaf_got, leaf_want,
                                                    "main-path geadd, partitioned leaves"))
    rel_errs["geadd"] = max(rel_errs["geadd"], assert_update(
        leaf_got, leaf_want, min(la.abs().max().item(), lb.abs().max().item()),
        "main-path geadd, partitioned leaves"))
    # band_update on matrix 5's window route: the window of the padded band
    # rows of its factor whose update is largest (many band tiles of a Table
    # II factor are zero, and a kernel's check on those could not tell a
    # skipped product), held to the plain version ops takes at b + 1 = 5;
    # and on a random b + 1 = 9 window against the masked einsum
    b1 = bt + 1
    wf5 = wfs[TABLE2_IDS[0]][0]
    Drp = torch.cat([wf5.ctsf.Dr, wf5.ctsf.Dr.new_zeros((bt, b1, t, t))])
    kwin = max(range(ndt), key=lambda k: ref.band_update_unrolled_ref(
        Drp[k:k + b1]).abs().max().item())
    w5 = Drp[kwin:kwin + b1]
    got, want = band_update_cuda(w5), ref.band_update_unrolled_ref(w5)
    errs["band_update"] = assert_close(torch, got, want, "main-path band_update")
    rel_errs["band_update"] = assert_update(got, want, want.abs().max().item(),
                                            "main-path band_update")
    w9 = torch.randn((9, 9, t, t), generator=torch.Generator().manual_seed(9)).to(dev)
    w9_err = assert_close(torch, band_update_cuda(w9), ref.band_update_ref(w9),
                          "band_update b+1=9")
    # the library yardstick: one einsum over the operands gathered beforehand
    wsh, rhs = band_update_gathered(torch, w5)
    pairs = bt * b1 // 2
    # selinv_step on the Takahashi column's own operands
    got, want = selinv_step_cuda(srow, gcat), ref.selinv_step_ref(srow, gcat)
    errs["selinv_step"] = assert_close(torch, got, want, "main-path selinv_step")
    rel_errs["selinv_step"] = assert_update(got, want, want.abs().max().item(),
                                            "main-path selinv_step")
    # the one-call yardsticks of the band-Cholesky sweeps and the selinv
    # sweep: torch.linalg.cholesky_ex on the matrix's band block as one
    # dense matrix (the band factor only, not the arrow rows or the Schur
    # sums), assembled beforehand, held to the factor's band block; and
    # torch.cholesky_inverse of the dense factor (the whole inverse, a
    # superset of the selected one), held to Σ's diagonal tiles
    from repro_torch.core import factorize_window as _fw
    Ab5, Ab4 = band_block_dense(torch, m.Dr), band_block_dense(torch, m4.Dr)
    for what, Ab, Lf in (("#5", Ab5, fc.Dr), ("#4", Ab4, _fw(m4).ctsf.Dr)):
        diff = rel_diff(torch, (torch.linalg.cholesky_ex(Ab).L,), (band_block_dense(torch, Lf),))
        if not diff <= 1e-4:
            raise AssertionError(f"the band sweep's yardstick on {what}: {diff:.3e} from the "
                                 "factor's band block, relative to its max")
    Lf32 = dense_from_ctsf(torch, fc, torch.float32, symmetric=False)
    lib_inv = lambda: torch.cholesky_inverse(Lf32)
    sig_diag = torch.diagonal(selected_inverse(f).Dr[:, 0], dim1=-2, dim2=-1).reshape(-1)
    diff = ((torch.diagonal(lib_inv())[:ndt * t] - sig_diag).abs().max()
            / sig_diag.abs().max()).item()
    if not diff <= 1e-3:
        raise AssertionError(f"the selinv sweep's yardstick: its diagonal {diff:.3e} from Σ's, "
                             "relative to its max")
    e_n, j_n = srow.shape[:2]
    P4 = plan4.n_partitions
    part_bytes = band_sweep_bytes(g4, P4, P4)
    tt4 = 4 * t * t
    chol_lib = ("torch.linalg.cholesky_ex on the matrix's band block as one dense "
                "({n}, {n}) matrix, assembled beforehand: the band factor only, not the arrow "
                "rows or the corner-Schur sums")
    timed = {"band_cholesky_partitioned_sweep": dict(
        matrix=pid, ndt=g4.n_diag_tiles, bt=g4.band_tiles, nat=g4.n_arrow_tiles, t=g4.t,
        partitions=P4, max_tiles=plan4.max_tiles,
        library=chol_lib.format(n=g4.n_diag_tiles * g4.t)),
        "band_cholesky_sweep": dict(matrix=TABLE2_IDS[0], ndt=ndt, bt=bt, nat=nat, t=t,
                                    library=chol_lib.format(n=ndt * t)),
        "selinv_sweep": dict(matrix=TABLE2_IDS[0], ndt=ndt, bt=bt, nat=nat, t=t,
                             library=f"torch.cholesky_inverse of the dense ({g.padded_n}, "
                                     f"{g.padded_n}) factor, assembled beforehand: the whole "
                                     "inverse, a superset of the selected one"),
        "gemm": dict(matrix=TABLE2_IDS[0], t=t, tiles=1, task=[int(gt.m), gt.k, int(gt.n)]),
        "syrk": dict(matrix=TABLE2_IDS[0], t=t, tiles=1, task=[st_.k, int(st_.n)]),
        "geadd": dict(matrix=TABLE2_IDS[0], t=t, shape=list(ga.shape),
                      operands="partials[0:8:2] and partials[1:8:2] of the first tree "
                               f"chain's (8, {t}, {t}) stack, tile {[int(i) for i in tree_tile]}"),
        "band_update": dict(matrix=TABLE2_IDS[0], t=t, window=list(w5.shape), panel=kwin,
                            operands="the window route's factor, padded band rows "
                                     f"{kwin}..{kwin + bt}",
                            b9_random_max_abs_err_against_einsum=w9_err),
        **{name: dict(matrix=TABLE2_IDS[0], ndt=ndt, bt=bt, nat=nat, t=t, k=32,
                      library="torch.linalg.solve_triangular on the band block as one dense "
                              f"({ndt * t}, {ndt * t}) lower-triangular matrix, assembled "
                              "beforehand; it covers the band solve, not the arrow sums")
           for name in ("band_forward_sweep", "band_backward_sweep")},
        "selinv_step": dict(matrix=TABLE2_IDS[0], t=t, s_row=list(srow.shape), column=jcol,
                            library="the plain version is itself one torch.einsum; the "
                                    "library time is that call")}

    kernels = []
    sweeps = ("band_cholesky_sweep", "band_forward_sweep", "band_backward_sweep", "selinv_sweep",
              "band_cholesky_partitioned_sweep", "selinv_prepass")
    for name, src, replaces, fk, fp, flib, inner, flops, nbytes, err in (
            ("potrf", "src/repro_torch/kernels/csrc/potrf.cu", "src/repro/kernels/potrf.py:70",
             lambda: potrf_cuda(a_kk), lambda: ref.potrf_ref(a_kk),
             lambda: torch.linalg.cholesky_ex(a_kk).L, 20, t ** 3 / 3.0, 2 * 4 * t * t,
             potrf_err),
            ("trsm", "src/repro_torch/kernels/csrc/trsm.cu", "src/repro/kernels/trsm.py:82",
             lambda: trsm_cuda(l_kk, col), lambda: ref.trsm_ref(l_kk, col),
             lambda: torch.linalg.solve_triangular(l_kk, col.mT, upper=False),
             20, nat * float(t) ** 3, 4 * t * t * (1 + 2 * nat), trsm_err),
            ("band_cholesky_sweep", "src/repro_torch/kernels/csrc/band_cholesky.cu",
             "src/repro/kernels/band_cholesky.py:168", sweep_k, sweep_p,
             lambda: torch.linalg.cholesky_ex(Ab5).L, 1,
             sweep_ops, band_sweep_bytes(g, nch), sweep_err),
            ("solve_panel", "src/repro_torch/kernels/csrc/solve_panel.cu",
             "src/repro/kernels/trsm.py:111", solve_k["solve_panel"], solve_p["solve_panel"],
             lambda: torch.linalg.solve_triangular(l_c, b_c, upper=False), 20,
             *work["solve_panel"], errs["solve_panel"]),
            ("band_forward_sweep", "src/repro_torch/kernels/csrc/band_solve.cu",
             "src/repro/kernels/band_solve.py:106", solve_k["band_forward_sweep"],
             solve_p["band_forward_sweep"], lib_fwd[32], 1, *work["band_forward_sweep"],
             errs["band_forward_sweep"]),
            ("band_backward_sweep", "src/repro_torch/kernels/csrc/band_solve.cu",
             "src/repro/kernels/band_solve.py:202", solve_k["band_backward_sweep"],
             solve_p["band_backward_sweep"], lib_bwd[32], 1, *work["band_backward_sweep"],
             errs["band_backward_sweep"]),
            ("selinv_sweep", "src/repro_torch/kernels/csrc/selinv.cu",
             "src/repro/kernels/selinv.py:213", solve_k["selinv_sweep"], solve_p["selinv_sweep"],
             lib_inv, 1, *work["selinv_sweep"], errs["selinv_sweep"]),
            ("gemm", "src/repro_torch/kernels/csrc/gemm.cu", "src/repro/kernels/gemm.py:40",
             tl_k["gemm"], tl_p["gemm"],
             lambda: torch.baddbmm(cg[None], ag[None], bg.mT[None], alpha=-1.0), 20,
             2.0 * t ** 3, 4 * tt4, errs["gemm"]),
            ("syrk", "src/repro_torch/kernels/csrc/gemm.cu", "src/repro/kernels/gemm.py:68",
             tl_k["syrk"], tl_p["syrk"],
             lambda: torch.baddbmm(cs[None], as_[None], as_.mT[None], alpha=-1.0), 20,
             float(t) ** 3, 3 * tt4, errs["syrk"]),
            ("geadd", "src/repro_torch/kernels/csrc/gemm.cu", "src/repro/kernels/gemm.py:79",
             tl_k["geadd"], tl_p["geadd"], lambda: torch.add(ga, gb), 20, float(ga.numel()),
             3 * 4 * ga.numel(), errs["geadd"]),
            ("band_cholesky_partitioned_sweep", "src/repro_torch/kernels/csrc/band_cholesky.cu",
             "src/repro/kernels/band_cholesky.py:341", part_k, part_p,
             lambda: torch.linalg.cholesky_ex(Ab4).L, 1,
             needed_flops(g4, plan4.boundaries)[0], part_bytes,
             errs["band_cholesky_partitioned_sweep"]),
            ("band_update", "src/repro_torch/kernels/csrc/band_update.cu",
             "src/repro/kernels/band_update.py:59", lambda: band_update_cuda(w5),
             lambda: ref.band_update_unrolled_ref(w5),
             lambda: torch.einsum("ejab,jcb->eac", wsh, rhs), 20,
             float(t) ** 3 * (bt + 2 * (pairs - bt)), 4 * t * t * (pairs + b1),
             errs["band_update"]),
            ("selinv_step", "src/repro_torch/kernels/csrc/selinv_step.cu",
             "src/repro/kernels/selinv.py:75", lambda: selinv_step_cuda(srow, gcat),
             lambda: ref.selinv_step_ref(srow, gcat),
             lambda: torch.einsum("ejab,jbc->eac", srow, gcat), 20,
             2.0 * t ** 3 * e_n * j_n, 4 * t * t * (e_n * j_n + j_n + e_n),
             errs["selinv_step"]),
            ("selinv_prepass", "src/repro_torch/kernels/csrc/selinv.cu",
             "src/repro/kernels/selinv.py:213", prepass_k, prepass_p, None, 1,
             *work["selinv_prepass"], errs["selinv_prepass"])):
        # call time: CUDA events around `inner` calls, host overhead included;
        # device time: the calls replayed from a CUDA graph (device_ms)
        call = dict(kernel=time_ms(torch, fk, inner=inner),
                    plain=time_ms(torch, fp, inner=1 if name in sweeps else inner,
                                  reps=5, warmup=1),
                    library=time_ms(torch, flib, inner=inner) if flib else None)
        on_device = {what: device_ms(torch, fn, calls=1 if name in sweeps else inner)
                     for what, fn in (("kernel", fk), ("plain", fp), ("library", flib)) if fn}
        # a side whose calls could not be captured keeps its call time
        timing = {w: "graph" if on_device.get(w) is not None else "call"
                  for w in call if call[w] is not None}
        pick = {w: on_device.get(w) if timing.get(w) == "graph" else call[w] for w in call}
        b_ms, b_by = bound(flops, nbytes)
        # launches: the main path's total over every matrix it ran, and per
        # call of each entry point on each matrix; the times are at matrix
        # TABLE2_IDS[0]'s shapes
        per_call = launches_per_call(records, precords, extra_calls, name)
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=main_launches[name], launches_per_call=per_call,
                            max_abs_err=err,
                            **({"update_rel_err": rel_errs[name]} if name in rel_errs else {}),
                            ms=pick["kernel"], plain_ms=pick["plain"], bound_ms=b_ms,
                            bound_by=b_by, library_ms=pick.get("library"), timing=timing,
                            call_ms=call["kernel"], plain_call_ms=call["plain"],
                            library_call_ms=call["library"],
                            timed_shape=timed.get(name, dict(
                                matrix=TABLE2_IDS[0], ndt=ndt, bt=bt, nat=nat, t=t,
                                **({"k": 32} if name in solve_k else {})))))
        fmt = lambda v: "-" if v is None else f"{v:.4f}"
        log(f"time {name}: device {fmt(on_device.get('kernel'))} ms, call {fmt(call['kernel'])} ms; "
            f"plain device {fmt(on_device.get('plain'))} ms, call {fmt(call['plain'])} ms; library "
            f"device {fmt(on_device.get('library'))} ms, call {fmt(call['library'])} ms; bound "
            f"{b_ms:.5f} ms by {b_by}")

    # the arrowhead's kernels at its own shapes (lm-100m: t = 32, ndt = 12,
    # bt = 2, nat = 1, k = 1), measured in phase "lm"
    for entry in kernels:
        at = lm_rec["lm-100m"]["arrowhead"]["times"]["kernels"].get(entry["name"])
        if at is not None:
            entry["arrowhead"] = at
    # gemm and syrk at every split (blocks a tile): the main path's task (one
    # tile) and a batch of the five band tasks with the largest products,
    # each against its plain version and bit for bit across splits, beside
    # the plain version and torch.baddbmm
    from repro_torch.kernels.gemm import GEMM_SPLITS, gemm_split
    gb5, sb5 = (largest_band_tasks(torch, tm5, L5, ty, 5) for ty in (TaskType.GEMM, TaskType.SYRK))
    stack = lambda f, tasks: torch.stack([f(*ij) for ij in tasks])
    cases = {"gemm": {"one_tile": (cg, ag, bg),
                      "batch_5": (stack(a_tile, [(x.m, x.k) for x in gb5]),
                                  stack(l_tile, [(x.m, x.n) for x in gb5]),
                                  stack(l_tile, [(x.k, x.n) for x in gb5]))},
             "syrk": {"one_tile": (cs, as_),
                      "batch_5": (stack(a_tile, [(x.k, x.k) for x in sb5]),
                                  stack(l_tile, [(x.k, x.n) for x in sb5]))}}
    for name, kfn, plainf, per_tile in (("gemm", gemm_cuda, ref.gemm_ref, (2.0 * t ** 3, 4 * tt4)),
                                        ("syrk", syrk_cuda, ref.syrk_ref, (float(t) ** 3, 3 * tt4))):
        entry = next(k for k in kernels if k["name"] == name)
        entry["first_design"] = GEMM_FIRST_DESIGN
        entry["by_split"] = {}
        for shape, args in cases[name].items():
            nb = args[0].numel() // (t * t)
            cb, ab_, bb = (x.reshape(-1, t, t) for x in (args + args[1:])[:3])
            want, first, splits = plainf(*args), None, []
            for split in GEMM_SPLITS[t]:
                fn = lambda: kfn(*args, split=split)
                got = fn()
                what = f"main-path {name} {shape} split={split}"
                err = assert_close(torch, got, want, what)
                first = got if first is None else first
                if not torch.equal(got, first):
                    raise AssertionError(f"{what}: not bit-identical to split 1")
                splits.append(dict(split=split, sub=gemm_split(t, split)[1],
                                   blocks=nb * split, max_abs_err=err,
                                   ms=device_ms(torch, fn, calls=20)))
            entry["by_split"][shape] = dict(
                tiles=nb, default_split=gemm_split(t)[0], splits=splits,
                plain_ms=device_ms(torch, lambda: plainf(*args), calls=20),
                library_ms=device_ms(torch, lambda: torch.baddbmm(cb, ab_, bb.mT, alpha=-1.0),
                                     calls=20),
                bound_ms=bound(per_tile[0] * nb, per_tile[1] * nb)[0])
            log(f"time {name}, {shape}, by split: " + json.dumps(entry["by_split"][shape])
                + f", card {card}")

    # the tile-sum kernels (tile_sum.cuh): their plans, two launches on the
    # main path's operands bit for bit, and the same operands on the plans
    # of other cluster caps beside the wrapper's (cap 1: no contraction
    # split, one block a sub-tile over its whole chain)
    from repro_torch.kernels.tile_sum import MAX_CLUSTER, tile_sum_plan
    for name, fk, args, pair_counts in (
            ("band_update", lambda: band_update_cuda(w5), (w5,), [bt - e for e in range(b1)]),
            ("selinv_step", lambda: selinv_step_cuda(srow, gcat), (srow, gcat), [j_n] * e_n)):
        entry = next(k for k in kernels if k["name"] == name)
        plan = tile_sum_plan(t, pair_counts)
        caps = []
        for cap in (1, 2, MAX_CLUSTER, 8):
            cap_fn, cap_plan = capped_launch(torch, name, cap, *args)
            if cap != 1 and cap_plan.cluster == caps[-1]["cluster"]:
                continue      # the same plan as a smaller cap's
            assert_close(torch, cap_fn(), fk(), f"main-path {name}, clusters of at most {cap}")
            caps.append(dict(max_cluster=cap, cluster=cap_plan.cluster, blocks=cap_plan.blocks,
                             per_rank=cap_plan.per_rank, ms=device_ms(torch, cap_fn, calls=20)))
        entry.update(
            blocks=plan.blocks, cluster=plan.cluster, sub=plan.sub, per_rank=plan.per_rank,
            blocks_with_pairs=plan.subtiles * sum(
                1 for n in pair_counts for r in range(plan.cluster) if plan.pairs(r, n)),
            deterministic=deterministic(torch, fk, f"main-path {name}"), cluster_caps=caps)
        log(f"time {name}: plan {plan}, {entry['blocks_with_pairs']} blocks with pairs; two "
            f"launches bit-identical; by cluster cap: " + json.dumps(caps))

    # the selinv sweep on both matrices: its pre-pass and recurrence apart,
    # the recurrence on the plan of each cluster size the card allows (the
    # pre-pass's result reused), two launches bit for bit, the plain version
    from repro_torch.kernels.selinv import MAX_SELINV_CLUSTER, SELINV_CLUSTER, selinv_plan
    entry = next(k for k in kernels if k["name"] == "selinv_sweep")
    entry["by_matrix"] = {}
    for rec in records:
        mm, ff = mats[rec["matrix"]]
        gg = mm.grid
        lc, rr, ss = band_row_to_col(ff.ctsf.Dr), ff.ctsf.R, corner_sigma(ff.ctsf.C)
        wk = selinv_prepass_cuda(lc, rr, ss)
        want = ref.selinv_sweep_ref(lc, rr, ss)
        clusters = []
        for cap in (4, 8, MAX_SELINV_CLUSTER):
            plan = selinv_plan(gg.t, gg.band_tiles, gg.n_arrow_tiles, cap)
            rec_fn = lambda: selinv_sweep_cuda(lc, rr, ss, max_cluster=cap, work=wk)
            err = max(assert_close(torch, a, b, f"matrix {rec['matrix']} selinv recurrence, "
                                   f"clusters of {plan.cluster}") for a, b in zip(rec_fn(), want))
            clusters.append(dict(max_cluster=cap, cluster=plan.cluster,
                                 diag_split=plan.diag_split, max_abs_err=err,
                                 recurrence_ms=device_ms(torch, rec_fn)))
        whole = lambda: selinv_sweep_cuda(lc, rr, ss)
        flat = lambda: torch.cat([x.flatten() for x in whole()])
        entry["by_matrix"][str(rec["matrix"])] = dict(
            ndt=gg.n_diag_tiles, bt=gg.band_tiles, nat=gg.n_arrow_tiles,
            ms=device_ms(torch, whole), plain_ms=device_ms(torch, lambda: ref.selinv_sweep_ref(
                lc, rr, ss)), prepass_ms=device_ms(torch, lambda: selinv_prepass_cuda(lc, rr, ss)),
            recurrence_ms=next(c["recurrence_ms"] for c in clusters
                               if c["max_cluster"] == SELINV_CLUSTER),
            bound_ms=bound(*solve_work(gg, 32)["selinv_sweep"])[0], clusters=clusters,
            deterministic=deterministic(torch, flat, f"matrix {rec['matrix']} selinv sweep"))
        log(f"time selinv_sweep, Table II matrix {rec['matrix']}: "
            + json.dumps(entry["by_matrix"][str(rec["matrix"])]) + f", card {card}")

    # the band-Cholesky sweep on both matrices at every cluster cap: each
    # against the plain version and bit for bit against clusters of 1, two
    # launches bit for bit, timed beside its plain version and bound; how
    # many clusters of each size the card holds at once
    from repro_torch.kernels.band_cholesky import sweep_max_active_clusters, sweep_plan
    entry = next(k for k in kernels if k["name"] == "band_cholesky_sweep")
    entry["first_design"] = SWEEP_FIRST_DESIGN
    entry["by_matrix"] = {}
    for rec in records:
        mm, _ = mats[rec["matrix"]]
        gg = mm.grid
        ac = band_row_to_col(mm.Dr)
        want = ref.band_cholesky_sweep_ref(ac, mm.R, nchunks=nchunks)
        clusters, first = [], None
        for cap in SWEEP_CLUSTERS:
            plan = sweep_plan(gg.t, gg.band_tiles, gg.n_arrow_tiles, cap)
            fn = lambda: band_cholesky_sweep_cuda(ac, mm.R, nchunks=nchunks, max_cluster=cap)
            what = f"matrix {rec['matrix']} sweep, clusters of {plan.cluster}"
            got = fn()
            err = max(assert_close(torch, a, b, f"{what} {part}")
                      for a, b, part in zip(got[:3], want[:3], ("panels", "R_out", "schur")))
            check_status(got[3], want[3], what)
            first = got if first is None else first
            if not all(torch.equal(a, b) for a, b in zip(got, first)):
                raise AssertionError(f"{what}: not bit-identical to clusters of 1")
            clusters.append(dict(max_cluster=cap, cluster=plan.cluster, max_abs_err=err,
                                 ms=device_ms(torch, fn),
                                 max_active_clusters=sweep_max_active_clusters(gg.t, plan.cluster)))
        flat = lambda: torch.cat([x.flatten() for x in band_cholesky_sweep_cuda(
            ac, mm.R, nchunks=nchunks)])
        entry["by_matrix"][str(rec["matrix"])] = dict(
            ndt=gg.n_diag_tiles, bt=gg.band_tiles, nat=gg.n_arrow_tiles, clusters=clusters,
            bit_identical_across_clusters=True,
            deterministic=deterministic(torch, flat, f"matrix {rec['matrix']} sweep"),
            plain_ms=device_ms(torch, lambda: ref.band_cholesky_sweep_ref(ac, mm.R,
                                                                          nchunks=nchunks)),
            bound_ms=bound(needed_flops(gg)[0], band_sweep_bytes(gg, chunk_layout(
                gg.n_diag_tiles, nchunks)[1]))[0])
        log(f"time band_cholesky_sweep, Table II matrix {rec['matrix']}: "
            + json.dumps(entry["by_matrix"][str(rec["matrix"])]) + f", card {card}")
    # the partitioned sweep on matrix 4 at every cluster cap
    entry = next(k for k in kernels if k["name"] == "band_cholesky_partitioned_sweep")
    entry["first_design"] = SWEEP_FIRST_DESIGN
    entry["clusters"] = []
    want = ref.band_cholesky_partitioned_sweep_ref(Ac4, m4.R, plan4.boundaries)
    for cap in SWEEP_CLUSTERS:
        plan = sweep_plan(g4.t, g4.band_tiles, g4.n_arrow_tiles, cap)
        fn = lambda: band_cholesky_partitioned_sweep_cuda(Ac4, m4.R, plan4.boundaries,
                                                          max_cluster=cap)
        got = fn()
        err = max(assert_close(torch, a, b, f"matrix {pid} partitioned sweep, clusters of "
                               f"{plan.cluster} {part}")
                  for a, b, part in zip(got[:3], want[:3], ("panels", "R_out", "schur")))
        entry["clusters"].append(dict(max_cluster=cap, cluster=plan.cluster, max_abs_err=err,
                                      ms=device_ms(torch, fn)))
    log("time band_cholesky_partitioned_sweep by cluster cap: " + json.dumps(entry["clusters"])
        + f", card {card}")
    entry = next(k for k in kernels if k["name"] == "trsm")
    entry["first_design"] = TRSM_FIRST_DESIGN

    # the band-solve sweeps on both matrices at k = 1 and 32 and every
    # cluster cap: each against the plain version and bit for bit against
    # clusters of 1, timed beside the plain version and the bound
    from repro_torch.kernels.band_solve import card_solve_plan, solve_max_active_clusters
    for name in ("band_forward_sweep", "band_backward_sweep"):
        entry = next(k for k in kernels if k["name"] == name)
        entry["first_design"] = SOLVE_FIRST_DESIGN
        entry["by_matrix"] = {}
    # what the plans' chunk width rests on: clusters of each size that the
    # card holds at once, one block an SM
    at_once = {cl: solve_max_active_clusters(t, cl, dev) for cl in range(1, 17)}
    log(f"band sweeps: clusters the card holds at once, one block an SM, by size: "
        f"{json.dumps(at_once)}, card {card}")
    for rec in records:
        mm, ff = mats[rec["matrix"]]
        gg, fcc = mm.grid, ff.ctsf
        bdm, xam = _split_rhs(gg, torch.randn((gg.padded_n, 32), device=dev,
                                              generator=torch.Generator(device=dev).manual_seed(11)))
        for kk in (1, 32):
            bdk, xak = bdm[..., :kk].contiguous(), xam[..., :kk].contiguous()
            for name, kfn, pfn in (
                    ("band_forward_sweep",
                     lambda cap: band_forward_sweep_cuda(fcc.Dr, fcc.R, bdk, max_cluster=cap),
                     lambda: ref.band_forward_sweep_ref(fcc.Dr, fcc.R, bdk)),
                    ("band_backward_sweep",
                     lambda cap: (band_backward_sweep_cuda(fcc.Dr, fcc.R, bdk, xak, max_cluster=cap),),
                     lambda: (ref.band_backward_sweep_ref(fcc.Dr, fcc.R, bdk, xak),))):
                want, first, caps = pfn(), None, []
                for cap in SWEEP_CLUSTERS:
                    plan = card_solve_plan(gg.t, gg.band_tiles, gg.n_arrow_tiles, kk, cap, dev)
                    what = f"matrix {rec['matrix']} {name} k={kk}, clusters of {plan.cluster}"
                    got = kfn(cap)
                    err = max(assert_close(torch, a, b, what) for a, b in zip(got, want))
                    first = got if first is None else first
                    if not all(torch.equal(a, b) for a, b in zip(got, first)):
                        raise AssertionError(f"{what}: not bit-identical to clusters of 1")
                    caps.append(dict(max_cluster=cap, cluster=plan.cluster, max_abs_err=err,
                                     ms=device_ms(torch, lambda: kfn(cap))))
                entry = next(k for k in kernels if k["name"] == name)
                entry["by_matrix"].setdefault(str(rec["matrix"]), {})[f"k{kk}"] = dict(
                    ndt=gg.n_diag_tiles, bt=gg.band_tiles, nat=gg.n_arrow_tiles,
                    width=plan.width, chunks=plan.chunks,
                    max_active_clusters=at_once[plan.cluster], clusters=caps,
                    bit_identical_across_clusters=True,
                    deterministic=deterministic(torch, lambda: torch.cat(
                        [x.flatten() for x in kfn(SWEEP_CLUSTERS[-1])]), f"{what} launches"),
                    plain_ms=device_ms(torch, pfn),
                    bound_ms=bound(*solve_work(gg, kk)[name])[0])
                log(f"time {name}, Table II matrix {rec['matrix']}, k = {kk}: " + json.dumps(
                    entry["by_matrix"][str(rec["matrix"])][f"k{kk}"]) + f", card {card}")

    # the band sweeps at k = 1 (a single solve), beside their bound
    work1 = solve_work(g, 1)
    for entry, fk in ((kernels[4], lambda: band_forward_sweep_cuda(fc.Dr, fc.R, bd1)),
                      (kernels[5], lambda: band_backward_sweep_cuda(fc.Dr, fc.R, bd1, xa1))):
        b_ms, b_by = bound(*work1[entry["name"]])
        fp = ((lambda: ref.band_forward_sweep_ref(fc.Dr, fc.R, bd1))
              if entry["name"] == "band_forward_sweep"
              else (lambda: ref.band_backward_sweep_ref(fc.Dr, fc.R, bd1, xa1)))
        flib = lib_fwd[1] if entry["name"] == "band_forward_sweep" else lib_bwd[1]
        entry["k1"] = dict(ms=device_ms(torch, fk), call_ms=time_ms(torch, fk), bound_ms=b_ms,
                           bound_by=b_by, plain_ms=device_ms(torch, fp),
                           plain_call_ms=time_ms(torch, fp, reps=3, warmup=1),
                           library_ms=device_ms(torch, flib), library_call_ms=time_ms(torch, flib))
        log(f"time {entry['name']} k=1: " + json.dumps(entry["k1"]))

    # geadd on the partitioned route's leaves (matrix 4), beside its bound
    entry = next(k for k in kernels if k["name"] == "geadd")
    b_ms, b_by = bound(float(la.numel()), 3 * 4 * la.numel())
    entry["partitioned_leaves"] = dict(
        matrix=pid, shape=list(la.shape),
        ms=device_ms(torch, lambda: geadd_cuda(la, lb), calls=20),
        plain_ms=device_ms(torch, lambda: ref.geadd_ref(la, lb), calls=20),
        library_ms=device_ms(torch, lambda: torch.add(la, lb), calls=20),
        bound_ms=b_ms, bound_by=b_by)
    log("time geadd, partitioned leaves: " + json.dumps(entry["partitioned_leaves"]))

    # solve_panel on matrix 5's first corner tile at k = 1 and 32, both
    # directions, beside its plain version and torch.linalg.solve_triangular
    # on the same panel; at k = 32 every chunk width (columns a block)
    from repro_torch.kernels.trsm import PANEL_CHUNKS, solve_panel_chunk
    entry = next(k for k in kernels if k["name"] == "solve_panel")
    entry["first_design"] = PANEL_FIRST_DESIGN
    entry["by_k"] = {}
    for kk in (1, 32):
        bk = b_c[:, :kk].contiguous()
        for trans in (False, True):
            fk = lambda: solve_panel_cuda(l_c, bk, trans=trans)
            flib = ((lambda: torch.linalg.solve_triangular(l_c.mT, bk, upper=True)) if trans
                    else (lambda: torch.linalg.solve_triangular(l_c, bk, upper=False)))
            fp = lambda: ref.solve_panel_ref(l_c, bk, trans=trans)
            err = assert_close(torch, fk(), fp(), f"main-path solve_panel k={kk} trans={trans}")
            b_ms, b_by = bound(*solve_work(g, kk)["solve_panel"])
            chunk, chunks = solve_panel_chunk(1, kk, torch.cuda.get_device_properties(
                0).multi_processor_count)
            row = dict(chunk=chunk, blocks=chunks, max_abs_err=err,
                       ms=device_ms(torch, fk, calls=20), call_ms=time_ms(torch, fk, inner=20),
                       plain_ms=device_ms(torch, fp, calls=20),
                       library_ms=device_ms(torch, flib, calls=20), bound_ms=b_ms, bound_by=b_by)
            if kk == 32:
                row["by_chunk"] = {str(c): device_ms(
                    torch, lambda: solve_panel_cuda(l_c, bk, trans=trans, chunk=c), calls=20)
                    for c in PANEL_CHUNKS}
            entry["by_k"][f"k{kk}_{'trans' if trans else 'forward'}"] = row
            log(f"time solve_panel, k = {kk}, trans = {trans}: " + json.dumps(row)
                + f", card {card}")
    # wide panels on the same tile, every chunk width beside the default:
    # sample_gmrf_many(num=256) gives the corner k = 256, the first width
    # whose default is wider than one column
    entry["wide"] = {}
    for kk in PANEL_WIDE_KS:
        bk = torch.randn((t, kk), generator=torch.Generator(device=dev).manual_seed(kk),
                         device=dev)
        for trans in (False, True):
            chunk, _ = solve_panel_chunk(1, kk, torch.cuda.get_device_properties(
                0).multi_processor_count)
            row = dict(default_chunk=chunk, max_abs_err=assert_close(
                torch, solve_panel_cuda(l_c, bk, trans=trans),
                ref.solve_panel_ref(l_c, bk, trans=trans),
                f"solve_panel k={kk} trans={trans}"), by_chunk={str(c): device_ms(
                    torch, lambda: solve_panel_cuda(l_c, bk, trans=trans, chunk=c), calls=20)
                    for c in PANEL_CHUNKS})
            entry["wide"][f"k{kk}_{'trans' if trans else 'forward'}"] = row
            log(f"time solve_panel, k = {kk}, trans = {trans}, by chunk: " + json.dumps(row)
                + f", card {card}")

    # geadd against the empty kernel on its grid (the floor of a one-tile
    # launch), programmatic launch on and off: on the tree's first level and
    # on matrix 4's partitioned leaves, and the tree's three levels over
    # the first chain's 8 partials as one chain, 20 chains in one graph
    from repro_torch.kernels.gemm import cuda_versions, geadd_floor_cuda
    entry = next(k for k in kernels if k["name"] == "geadd")
    runtime, driver = cuda_versions()
    partials = torch.stack([ga, gb], dim=1).reshape(-1, t, t)

    def geadd_chain(pdl, kernel=geadd_cuda):
        x = partials
        while x.shape[0] > 1:
            y = kernel(x[0::2], x[1::2], pdl=pdl)
            x = x[0::2] if y is None else y
        return x[0]

    chain_want = partials
    while chain_want.shape[0] > 1:
        chain_want = ref.geadd_ref(chain_want[0::2], chain_want[1::2])
    chain_want = chain_want[0]
    entry["pdl"] = dict(cuda_runtime=runtime, cuda_driver=driver, default=geadd_cuda.__kwdefaults__["pdl"])
    for pdl in (False, True):
        if not torch.equal(geadd_chain(pdl), chain_want):
            raise AssertionError(f"the geadd chain, pdl={pdl}: not bit-identical to the plain "
                                 "version")
        key = "on" if pdl else "off"
        entry["pdl"][key] = dict(
            first_level_ms=device_ms(torch, lambda: geadd_cuda(ga, gb, pdl=pdl), calls=20),
            first_level_empty_ms=device_ms(torch, lambda: geadd_floor_cuda(ga, gb, pdl=pdl),
                                           calls=20),
            leaves_ms=device_ms(torch, lambda: geadd_cuda(la, lb, pdl=pdl), calls=20),
            leaves_empty_ms=device_ms(torch, lambda: geadd_floor_cuda(la, lb, pdl=pdl),
                                      calls=20),
            chain_ms=device_ms(torch, lambda: geadd_chain(pdl), calls=20),
            chain_empty_ms=device_ms(torch, lambda: geadd_chain(pdl, geadd_floor_cuda),
                                     calls=20))
    log(f"time geadd, programmatic launch off and on, CUDA runtime {runtime}, driver {driver}: "
        + json.dumps(entry["pdl"]) + f", card {card}")

    # where the sweep's time goes, from the phase-marked build of the kernel:
    # rank 0 (it factors L_kk) and rank 1 (it adds the Schur products then)
    from repro_torch.kernels.band_cholesky import sweep_phase_cycles
    for rec in records:
        mm, _ = mats[rec["matrix"]]
        rec["sweep_phase_cycles"] = {}
        for rank in (0, 1):
            cyc = sweep_phase_cycles(band_row_to_col(mm.Dr), mm.R, nchunks=nchunks, rank=rank)
            total = sum(cyc.values())
            rec["sweep_phase_cycles"][f"rank {rank}"] = cyc
            log(f"sweep phases: Table II matrix {rec['matrix']}, rank {rank}: "
                f"{total / 1e6:.2f} M cycles: " + ", ".join(
                    f"{k} {v / 1e6:.2f} M ({100 * v / total:.0f}%)" for k, v in cyc.items()))
    kernels[2]["phase_cycles"] = records[0]["sweep_phase_cycles"]

    # factorize_window end to end, and its peak memory, per matrix
    from repro_torch.core import factorize_window, logdet
    for rec in records:
        mm, _ = mats[rec["matrix"]]
        gg = mm.grid
        fw = lambda: logdet(factorize_window(mm))
        ms = time_ms(torch, fw, reps=7, warmup=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fw()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        fl = sum(needed_flops(gg))
        log(f"factorize_window+logdet: Table II matrix {rec['matrix']}: {ms:.3f} ms "
            f"median of 7, {fl / ms / 1e6:.1f} GFLOP/s ({fl / 1e9:.3f} GFLOP counted), "
            f"peak {peak / 2 ** 20:.1f} MiB above the inputs, card {card}")

    # the solve half end to end, per matrix: median of 7, CUDA events
    from repro_torch.core import (SolverOptions, marginal_variances, selected_inverse,
                                  solve_many)
    for rec in records:
        mm, ff = mats[rec["matrix"]]
        gg = mm.grid
        nn = gg.structure.n
        B32 = torch.randn((gg.padded_n, 32), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(5))
        B1 = B32[:, :1].contiguous()
        idx = [0, nn // 2, nn - gg.structure.arrow, nn - 1]
        e2e = {"solve_many_k1": lambda: solve_many(ff, B1),
               "solve_many_k32": lambda: solve_many(ff, B32),
               "selected_inverse": lambda: selected_inverse(ff),
               "marginal_variances_selinv": lambda: marginal_variances(
                   ff, idx, options=SolverOptions(method="selinv"))}
        rec["e2e_ms"] = {k: time_ms(torch, fn, reps=7, warmup=2) for k, fn in e2e.items()}
        log(f"solves end to end: Table II matrix {rec['matrix']}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in rec["e2e_ms"].items()) + f" (median of 7), card {card}")

    # solve_many (k = 1 and 32) and sample_gmrf_many (32 draws), per matrix:
    # call time with the corner's graph and with the eager corner, against
    # the device time of the same kernels (device_ms: the calls' launches
    # captured in one graph of their own); split into the two sweeps, the
    # corner (its kernels' device time) and the host (call less device);
    # the two corner graphs' replay alone
    from repro_torch.core import sample_gmrf_many
    from repro_torch.core.solve import _backward_corner, _forward_corner
    for rec in records:
        mm, ff = mats[rec["matrix"]]
        gg, fcc = mm.grid, ff.ctsf
        B32 = torch.randn((gg.padded_n, 32), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(5))
        rec["solve_split"] = {}
        for name, kk in (("solve_many_k1", 1), ("solve_many_k32", 32),
                         ("sample_gmrf_many", 32)):
            Bk = B32[:, :kk].contiguous()
            bdk, bak = _split_rhs(gg, Bk)
            sample = name == "sample_gmrf_many"
            call = ((lambda: sample_gmrf_many(ff, num=32, z=Bk)) if sample
                    else (lambda: solve_many(ff, Bk)))
            eager = lambda: eager_solve_many(ff, Bk, backward_only=sample)
            acc = torch.zeros_like(bak)
            sweeps = ((lambda: band_backward_sweep_cuda(fcc.Dr, fcc.R, bdk, bak)) if sample else
                      (lambda: (band_forward_sweep_cuda(fcc.Dr, fcc.R, bdk),
                                band_backward_sweep_cuda(fcc.Dr, fcc.R, bdk, bak))))
            corner = ((lambda: _backward_corner(fcc.C, bak, None)) if sample else
                      (lambda: _backward_corner(fcc.C, _forward_corner(fcc.C, bak, acc, None),
                                                None)))
            e = dict(call_ms=time_ms(torch, call, reps=7, warmup=2),
                     eager_call_ms=time_ms(torch, eager, reps=7, warmup=2),
                     device_ms=device_ms(torch, call), eager_device_ms=device_ms(torch, eager),
                     sweeps_device_ms=device_ms(torch, sweeps),
                     corner_device_ms=device_ms(torch, corner) if gg.n_arrow_tiles else 0.0)
            keys = [(kk, True)] + ([] if sample else [(kk, False)])
            entries = [corner_graphs.find((gg.t, gg.n_arrow_tiles, kk, bw, str(fcc.C.device)))
                       for kk, bw in keys] if gg.n_arrow_tiles else []
            if any(x is None for x in entries):
                raise AssertionError(f"matrix {rec['matrix']} {name}: no corner graph kept")
            if entries:
                e["corner_replay_call_ms"] = time_ms(
                    torch, lambda: [x.graph.replay() for x in entries], reps=7, warmup=2)
            e["call_over_device"] = e["call_ms"] / e["device_ms"]
            e["eager_call_over_device"] = e["eager_call_ms"] / e["eager_device_ms"]
            e["host_ms"] = e["call_ms"] - e["device_ms"]
            e["eager_host_ms"] = e["eager_call_ms"] - e["eager_device_ms"]
            rec["solve_split"][name] = e
            log(f"{name}: Table II matrix {rec['matrix']}: " + json.dumps(e)
                + f" (call medians of 7, device medians of 5), card {card}")

    # beside the partitioned sweep: the fused kernel on the same matrix, and
    # the fused kernel on the widest partition alone (one block's share)
    entry = next(k for k in kernels if k["name"] == "band_cholesky_partitioned_sweep")
    b = plan4.boundaries
    w = max(range(P4), key=lambda q: b[q + 1] - b[q])
    wide = (Ac4[b[w]:b[w + 1]].contiguous(), m4.R[b[w]:b[w + 1]].contiguous())
    entry["fused_ms"] = device_ms(torch, lambda: band_cholesky_sweep_cuda(Ac4, m4.R, nchunks=1))
    entry["widest_partition_ms"] = device_ms(
        torch, lambda: band_cholesky_sweep_cuda(*wide, nchunks=1))
    log(f"time band_cholesky_partitioned_sweep beside it: fused kernel on the same matrix "
        f"{entry['fused_ms']:.4f} ms, fused kernel on the widest partition alone "
        f"({b[w + 1] - b[w]} of {g4.n_diag_tiles} columns) {entry['widest_partition_ms']:.4f} ms")

    # the task list end to end, tree off and on: the first call of the
    # pattern (warm-up, capture and replay) and what its graph keeps; the
    # call time (a replay: the input copied in, the factor copied out)
    # against the device time of its kernels (device_ms, the eager loop's
    # launches captured in its own graph) and against the graph's replay
    # alone; a θ step of the same pattern; the eager loop launched task by
    # task from the host, call and device time
    from repro_torch.core.cholesky import tasklist_graphs
    for rec in records:
        tm, tm2 = tms[rec["matrix"]], tm2s[rec["matrix"]]
        for tree in (False, True):
            workers = 8 if tree else 0
            fn = lambda x=tm: factorize_tasklist(x, tree_reduction=tree, tree_workers=8)
            tasklist_graphs.clear()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            first = fn()
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            kept = torch.cuda.memory_allocated() - base - first.numel() * first.element_size()
            e = dict(first_call_ms=first_ms, graph_allocated_mib=kept / 2 ** 20,
                     graph_reserved_mib=(torch.cuda.memory_reserved() - reserved) / 2 ** 20,
                     first_call_peak_mib=(torch.cuda.max_memory_allocated() - base) / 2 ** 20)
            del first
            captures = tasklist_graphs.captures
            graph = tasklist_graphs.get(tm, workers).graph
            e.update(call_ms=time_ms(torch, fn, reps=7, warmup=2),
                     device_ms=device_ms(torch, fn),
                     graph_replay_ms=time_ms(torch, graph.replay, reps=7, warmup=2),
                     theta_step_call_ms=time_ms(torch, lambda: fn(tm2), reps=7, warmup=1),
                     eager_call_ms=time_ms(torch, lambda: eager_tasklist(tm, workers), reps=3,
                                           warmup=1),
                     eager_device_ms=device_ms(torch, lambda: eager_tasklist(tm, workers)))
            if tasklist_graphs.captures != captures:
                raise AssertionError(f"matrix {rec['matrix']}: the timed calls captured again")
            e["call_over_device"] = e["call_ms"] / e["device_ms"]
            key = f"tree_{'on' if tree else 'off'}"
            rec["tasklist"][key]["e2e"] = e
            log(f"factorize_tasklist {key}: Table II matrix {rec['matrix']}: "
                + json.dumps(e) + f" (medians of 7; eager call of 3), card {card}")
    # the partitioned route end to end, beside the fused route on the same matrix
    for rec in precords:
        mm, plan, _ = pmats[rec["matrix"]]
        opts = SolverOptions(partition_plan=plan)
        rec["e2e"] = {}
        for route, fn in (("partitioned", lambda: logdet(factorize_window(mm, options=opts))),
                          ("fused", lambda: logdet(factorize_window(mm)))):
            rec["e2e"][route] = dict(call_ms=time_ms(torch, fn, reps=7, warmup=2),
                                     device_ms=device_ms(torch, fn))
        log(f"factorize_window+logdet: Table II matrix {rec['matrix']} (P = {rec['partitions']}): "
            + json.dumps(rec["e2e"]) + f" (call median of 7, device median of 5), card {card}")

    # the window route end to end, beside the fused route on the same matrix
    wopts = SolverOptions(sweep="window")
    for rec in records:
        mm, _ = mats[rec["matrix"]]
        rec["window"]["e2e"] = {}
        for route, fn in (("window", lambda: logdet(factorize_window(mm, options=wopts))),
                          ("fused", lambda: logdet(factorize_window(mm)))):
            rec["window"]["e2e"][route] = dict(call_ms=time_ms(torch, fn, reps=5, warmup=1),
                                               device_ms=device_ms(torch, fn))
        log(f"factorize_window+logdet, sweep='window': Table II matrix {rec['matrix']}: "
            + json.dumps(rec["window"]["e2e"]) + f" (call median of 5, device median of 5), "
            f"card {card}")
    # the θ-sweep end to end: BATCH candidates in one call against one
    # candidate alone; and the batched sweep kernels alone
    from repro_torch.core import factorize_window_batched
    for route, mb, opts in (("fused", mb5, SolverOptions()), ("window", mb5, wopts),
                            ("partitioned", mb4, SolverOptions(partition_plan=pplan4))):
        one = element(mb, 0)
        fb = lambda: logdet(factorize_window_batched(mb, options=opts))
        f1 = lambda: logdet(factorize_window(one, options=opts))
        batched[route]["e2e"] = dict(
            batched_call_ms=time_ms(torch, fb, reps=5, warmup=1),
            batched_device_ms=device_ms(torch, fb),
            single_call_ms=time_ms(torch, f1, reps=5, warmup=1),
            single_device_ms=device_ms(torch, f1))
        log(f"factorize_window_batched+logdet, {route} route, B = {BATCH}: "
            + json.dumps(batched[route]["e2e"]) + f" (medians of 5), card {card}")
    Ac5b, Ac4b = band_row_to_col(mb5.Dr), band_row_to_col(mb4.Dr)
    wsh_b, rhs_b = band_update_gathered(torch, w5b)
    assert_close(torch, torch.einsum("...ejab,...jcb->...eac", wsh_b, rhs_b),
                 band_update_cuda(w5b), "batched band_update's yardstick")
    for name, fk, f1 in (
            ("band_cholesky_sweep", lambda: band_cholesky_sweep_cuda(Ac5b, mb5.R, nchunks=nchunks),
             lambda: band_cholesky_sweep_cuda(Ac5b[0], mb5.R[0], nchunks=nchunks)),
            ("band_cholesky_partitioned_sweep",
             lambda: band_cholesky_partitioned_sweep_cuda(Ac4b, mb4.R, pplan4.boundaries),
             lambda: band_cholesky_partitioned_sweep_cuda(Ac4b[0], mb4.R[0], pplan4.boundaries)),
            ("band_update", lambda: band_update_cuda(w5b), lambda: band_update_cuda(w5b[0]))):
        entry = next(k for k in kernels if k["name"] == name)
        calls = 20 if name == "band_update" else 1
        entry["batched"] = dict(batch=BATCH, max_abs_err=batched_errs[name],
                                **({"update_rel_err": batched_errs["band_update_rel"],
                                    "bit_identical_per_element":
                                        batched_errs["band_update_bit_identical_per_element"],
                                    **batched_errs["band_update_window"]}
                                   if name == "band_update" else {}),
                                ms=device_ms(torch, fk, calls=calls),
                                single_ms=device_ms(torch, f1, calls=calls))
        if name != "band_update":
            # the batch at smaller clusters, and whether the card holds the
            # batch's clusters at once
            mb, ac = (mb5, Ac5b) if name == "band_cholesky_sweep" else (mb4, Ac4b)
            gb = mb.grid
            entry["batched"]["clusters"] = []
            for cap in (4, 8, 16):
                plan = sweep_plan(gb.t, gb.band_tiles, gb.n_arrow_tiles, cap)
                fn = ((lambda: band_cholesky_sweep_cuda(ac, mb.R, nchunks=nchunks,
                                                        max_cluster=cap))
                      if name == "band_cholesky_sweep" else
                      (lambda: band_cholesky_partitioned_sweep_cuda(
                          ac, mb.R, pplan4.boundaries, max_cluster=cap)))
                entry["batched"]["clusters"].append(dict(
                    max_cluster=cap, cluster=plan.cluster,
                    clusters_launched=BATCH * (1 if name == "band_cholesky_sweep"
                                               else pplan4.n_partitions),
                    max_active_clusters=sweep_max_active_clusters(gb.t, plan.cluster),
                    ms=device_ms(torch, fn)))
        if name == "band_update":
            # one einsum over the batch's gathered operands, the yardstick
            entry["batched"].update(
                blocks=tile_sum_plan(t, [bt - e for e in range(b1)], BATCH).blocks,
                library_ms=device_ms(torch, lambda: torch.einsum(
                    "...ejab,...jcb->...eac", wsh_b, rhs_b), calls=calls))
        log(f"time {name}, a batch of {BATCH} in one launch: " + json.dumps(entry["batched"]))
    entry = next(k for k in kernels if k["name"] == "trsm")
    entry["batched"] = {k: v for k, v in batched_errs.items() if k.startswith("trsm")}
    # potrf on the θ-batch's first corner tiles, one launch for the batch
    # (what the batched fused route's corner gives it)
    entry = next(k for k in kernels if k["name"] == "potrf")
    schur_b = band_cholesky_sweep_cuda(Ac5b, mb5.R, nchunks=nchunks)[2]
    akk_b = (mb5.C - schur_b.sum(dim=1))[:, 0, 0].contiguous()
    entry["theta_batch"] = dict(
        batch=BATCH, shape=list(akk_b.shape),
        max_abs_err=assert_close(torch, potrf_cuda(akk_b), ref.potrf_ref(akk_b),
                                 "θ-batch corner potrf"),
        ms=device_ms(torch, lambda: potrf_cuda(akk_b), calls=20),
        plain_ms=device_ms(torch, lambda: ref.potrf_ref(akk_b), calls=20),
        library_ms=device_ms(torch, lambda: torch.linalg.cholesky_ex(akk_b).L, calls=20))
    log(f"time potrf, the θ-batch's {BATCH} corner tiles in one launch: "
        + json.dumps(entry["theta_batch"]) + f", card {card}")
    entry = next(k for k in kernels if k["name"] == "selinv_step")
    entry["takahashi_column"] = takahashi

    # the θ-batch's read-out kernels on its own inputs (the fused batched
    # factor of matrix 5, its seeded panels): one launch for the batch
    # against one element's launch, each element bit for bit its unbatched
    # launch (the band sweeps at the batch's chunk width), the batch
    # against the batched plain version
    from repro_torch.kernels.band_solve import card_solve_plan
    fbc = fb5.ctsf
    bdb = B32b[:, :ndt * t].reshape(BATCH, ndt, t, 32).contiguous()
    xab = B32b[:, ndt * t:].reshape(BATCH, nat, t, 32).contiguous()
    lcb, scb = band_row_to_col(fbc.Dr), corner_sigma(fbc.C)
    lpb = fbc.C[:, 0, 0].contiguous()
    read_cases = []
    for kk in (1, 32):
        bdk, xak = bdb[..., :kk].contiguous(), xab[..., :kk].contiguous()
        xpk = xak[:, 0].contiguous()          # each element's first arrow panel
        width = card_solve_plan(t, bt, nat, kk, device=dev, batch=BATCH).width
        read_cases += [
            ("band_forward_sweep", f"k{kk}",
             lambda bdk=bdk: band_forward_sweep_cuda(fbc.Dr, fbc.R, bdk),
             lambda n=BATCH, bdk=bdk, w=width: [band_forward_sweep_cuda(
                 fbc.Dr[i], fbc.R[i], bdk[i], width=w) for i in range(n)],
             lambda bdk=bdk: ref.band_forward_sweep_ref(fbc.Dr, fbc.R, bdk), width),
            ("band_backward_sweep", f"k{kk}",
             lambda bdk=bdk, xak=xak: (band_backward_sweep_cuda(fbc.Dr, fbc.R, bdk, xak),),
             lambda n=BATCH, bdk=bdk, xak=xak, w=width: [(band_backward_sweep_cuda(
                 fbc.Dr[i], fbc.R[i], bdk[i], xak[i], width=w),) for i in range(n)],
             lambda bdk=bdk, xak=xak: (ref.band_backward_sweep_ref(fbc.Dr, fbc.R, bdk, xak),),
             width),
            ("solve_panel", f"k{kk}", lambda xpk=xpk: (solve_panel_cuda(lpb, xpk),),
             lambda n=BATCH, xpk=xpk: [(solve_panel_cuda(lpb[i], xpk[i]),) for i in range(n)],
             lambda xpk=xpk: (ref.solve_panel_ref(lpb, xpk),), None)]
    read_cases += [
        ("selinv_sweep", "sweep", lambda: selinv_sweep_cuda(lcb, fbc.R, scb),
         lambda n=BATCH: [selinv_sweep_cuda(lcb[i], fbc.R[i], scb[i]) for i in range(n)],
         lambda: ref.selinv_sweep_ref(lcb, fbc.R, scb), None),
        ("selinv_prepass", "prepass", lambda: (selinv_prepass_cuda(lcb, fbc.R, scb),),
         lambda n=BATCH: [(selinv_prepass_cuda(lcb[i], fbc.R[i], scb[i]),) for i in range(n)],
         lambda: (ref.selinv_prepass_ref(lcb, fbc.R, scb),), None)]
    for name, case, fk, f_each, fp, width in read_cases:
        got, each = fk(), f_each()
        err = max(assert_close(torch, a, b, f"θ-batch {name} {case}") for a, b in zip(got, fp()))
        same = [all(torch.equal(a[i], o) for a, o in zip(got, each[i])) for i in range(BATCH)]
        if not all(same):
            raise AssertionError(f"θ-batch {name} {case}: elements "
                                 f"{[i for i, s_ in enumerate(same) if not s_]} not "
                                 "bit-identical to their unbatched launches")
        e = dict(batch=BATCH, max_abs_err=err, bit_identical_per_element=True,
                 ms=device_ms(torch, fk), single_ms=device_ms(torch, lambda: f_each(n=1)),
                 elements_one_by_one_ms=device_ms(torch, f_each))
        if width is not None:
            e["width"] = width
        entry = next(k for k in kernels if k["name"] == name)
        entry.setdefault("theta_batch", {})[case] = e
        log(f"time {name}, the θ-batch of {BATCH} ({case}) in one launch: " + json.dumps(e)
            + f", card {card}")

    # the θ-batch's read-out end to end: solve_many_batched (k = 1 and 32)
    # and selinv_batched against one candidate's call and a loop of B
    # unbatched calls; regularize=True against the call without it on the
    # clean θ-batch (the ladder's clean path: one readback), in turns
    from repro_torch.core import selinv_batched, solve_many_batched
    els = [element_factor(fb5, i) for i in range(BATCH)]
    e2e_read = {}
    for name, fb_, f1, floop in (
            ("solve_many_batched_k1", lambda: solve_many_batched(fb5, B32b[..., :1].contiguous()),
             lambda: solve_many(els[0], B32b[0, :, :1].contiguous()),
             lambda: [solve_many(els[i], B32b[i, :, :1].contiguous()) for i in range(BATCH)]),
            ("solve_many_batched_k32", lambda: solve_many_batched(fb5, B32b),
             lambda: solve_many(els[0], B32b[0]),
             lambda: [solve_many(els[i], B32b[i]) for i in range(BATCH)]),
            ("selinv_batched", lambda: selinv_batched(fb5), lambda: selected_inverse(els[0]),
             lambda: [selected_inverse(x) for x in els])):
        e2e_read[name] = dict(
            batched_call_ms=time_ms(torch, fb_, reps=7, warmup=2),
            batched_device_ms=device_ms(torch, fb_),
            single_call_ms=time_ms(torch, f1, reps=7, warmup=2),
            single_device_ms=device_ms(torch, f1),
            loop_call_ms=time_ms(torch, floop, reps=5, warmup=1),
            loop_device_ms=device_ms(torch, floop))
        log(f"{name}, B = {BATCH}: " + json.dumps(e2e_read[name])
            + f" (call medians of 7, loop of 5; device medians of 5), card {card}")
    theta_read["e2e"] = e2e_read
    reg = SolverOptions(regularize=True)
    turns = {"plain": [], "regularize": []}
    for _ in range(5):
        for key, opts in (("plain", None), ("regularize", reg), ("regularize", reg),
                          ("plain", None)):
            turns[key].append(time_ms(torch, lambda: factorize_window_batched(
                mb5, options=opts), reps=5, warmup=1))
    overhead = dict(plain_call_ms=statistics.median(turns["plain"]),
                    regularize_call_ms=statistics.median(turns["regularize"]),
                    plain_runs=turns["plain"], regularize_runs=turns["regularize"])
    overhead["ratio"] = overhead["regularize_call_ms"] / overhead["plain_call_ms"]
    recovery["clean_overhead"] = overhead
    log(f"factorize_window_batched, B = {BATCH}, clean θ-batch, regularize=True against "
        f"without (medians of 10 turns of 5 calls): " + json.dumps(overhead) + f", card {card}")
    if not overhead["ratio"] <= CLEAN_OVERHEAD_LIMIT:
        raise AssertionError(f"regularize=True on a clean θ-batch: {overhead['ratio']:.3f} "
                             f"times the call without it (limit {CLEAN_OVERHEAD_LIMIT})")
    # canonical-grid bucketing: canonical against source grid on #5
    bucketing["times"] = time_bucketing(torch, m5, f5, fp5, stream, mb5, card)
    # the serving path: the warm pass, the sequential loop, the bytes held
    serving_rec["times"] = time_serving(torch, counts, serving, card)
    del serving
    if deferred:
        raise AssertionError("; ".join(deferred))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def partitioned_call(src: Path, rounds: int = 9) -> int:
    """``python3 chip_smoke.py --partitioned-call [SRC]``: the partitioned
    route's call time on Table II matrix 4, ``logdet(factorize_window(m,
    options=SolverOptions(partition_plan=plan)))``, with the ``repro_torch``
    under SRC (default: this checkout's ``src``), so that two trees can be
    timed in one session on the card, parent and change in turn.  Each of
    ``rounds`` rounds takes the median of 21 calls (CUDA events around each
    call) in every mode: the geadd kernel as the route calls it (where
    ``geadd_cuda`` takes ``pdl=``, with the programmatic launch on and
    then off), and ``torch.add`` in its place (so a tree's own geadd can be
    told from the rest of the call).  Beside them the call's device time
    and the host time of one geadd call on (3, 4, 4, 64, 64) strided
    halves, as the route's first tree level has (the mean of 200 calls,
    issued without a synchronisation between), and a profile of the host's
    time over 21 calls (cProfile: calls a call, the 15 functions with the
    most time of their own).  Prints one JSON line."""
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke.py: no repro_torch under {src}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on an H100", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core import SolverOptions, factorize_window, logdet
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm import geadd_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    mid = PARTITIONED_IDS[0]
    m, plan, _ = partitioned_matrix(torch, mid)
    opts = SolverOptions(partition_plan=plan)
    fn = lambda: logdet(factorize_window(m, options=opts))
    defaults = geadd_cuda.__kwdefaults__ or {}
    modes = ("pdl_on", "pdl_off", "torch_add") if "pdl" in defaults else ("default",
                                                                           "torch_add")
    leaves = torch.randn((2 * 3, 4, 4, 64, 64), generator=torch.Generator(
        device="cuda").manual_seed(mid), device="cuda")
    la, lb = leaves[0::2], leaves[1::2]
    out = dict(src=str(src), matrix=mid, partitions=plan.n_partitions,
               device_ms=device_ms(torch, fn), call_ms={}, geadd_host_ms={})
    try:
        for _ in range(rounds):
            for mode in modes:
                ops.geadd_cuda = torch.add if mode == "torch_add" else geadd_cuda
                if "pdl" in defaults:
                    defaults["pdl"] = mode != "pdl_off"
                out["call_ms"].setdefault(mode, []).append(time_ms(torch, fn, reps=21))
                if mode == "torch_add":
                    continue
                geadd_cuda(la, lb)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    geadd_cuda(la, lb)
                out["geadd_host_ms"].setdefault(mode, []).append(
                    (time.perf_counter() - t0) / 200 * 1e3)
                torch.cuda.synchronize()
    finally:
        ops.geadd_cuda = geadd_cuda
        if "pdl" in defaults:
            defaults["pdl"] = True
    for key in ("call_ms", "geadd_host_ms"):
        out[f"median_{key}"] = {k: statistics.median(v) for k, v in out[key].items()}
    # where the host's time goes: a profile of 21 calls, the 15 functions
    # that take the most time of their own, per call
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(21):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    out["profile"] = dict(calls_per_call=stats.total_calls / 21,
                          seconds_per_call_ms=stats.total_tt / 21 * 1e3)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:15]
    out["profile"]["top"] = [
        dict(fn=f"{Path(f).name}:{line}:{name}", calls=nc / 21, own_ms=tt / 21 * 1e3,
             cum_ms=ct / 21 * 1e3) for (f, line, name), (_, nc, tt, ct, _) in top]
    print(f"partitioned call (medians of 21 calls a round), card {card_line()}: "
          + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--partitioned-call"]:
        sys.exit(partitioned_call(Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else SRC))
    sys.exit(main())
