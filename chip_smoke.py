#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``h2o3_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA device and the repository; without either it exits non-zero and
prints no result. It drives the port's GBM paths from ``Frame.from_numpy`` and from a
CSV file through ``import_file``, the XGBoost estimator (BASELINE
config #2) with a validation frame and early stopping, the sampled GBM
and XGBoost and the random forest (kernel threefry_uniform, the row,
column and per-node draws): packed codes
(``histogram_type="quantiles_global"``, kernels binned_level and
binned_route_only), adaptive bins (``packed_codes=False``, H2O's
default ``uniform_adaptive``, kernels adaptive_level and
adaptive_route_only in the [rows, F] and [F, rows] layouts), the
unpacked global sketch (nbins 1024, kernel global_hist), and the packed
and adaptive paths again with int8 fixed-point masses
(``H2O3_HIST_I8=1``, set around those trains only; kernels
binned_level_i8 and adaptive_level_i8), the packed and adaptive paths at
the wide lane widths (``packed_wide``: nbins 254, W = 256 int16 codes,
XGBoost's ``tree_method="hist"`` at max_bins 256; ``adaptive_wide``:
nbins 62 adaptive, W = 64, the bin count of its ``"auto"``, which itself
packs; the wide body of binned_level and adaptive_level), the same two with int8 masses (``packed_wide_i8``,
``adaptive_wide_i8``: the wide body's int8 instance of
binned_level_i8 and adaptive_level_i8), and, on the packed and global
paths, the deepest
level's per-leaf sums (segment_totals, the leaf-totals kernel without a
route). It also holds leaf_totals with a route, which no path launches,
against its plain version. Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: compile the CUDA kernels from ``h2o3_tpu_torch/csrc`` (one
   nvcc per source, in parallel); print each kernel's atomic, HMMA and
   IMMA opcodes from its SASS and require HMMA and no shared float CAS
   loop (``ATOMS.CAST.SPIN``) in every float tensor-core instance of the
   node-grouped level (adaptive and packed), IMMA and no atomics in every
   int8 instance of it, no atomics at all in every float instance of the
   wide level (level_wide_kernel), the leaf-totals kernel (every form),
   global_hist's node-grouped form, the route
   (adaptive_route_only_kernel in both layouts, with its loads-only
   floors) and the column level (level_column_kernel, K5 in [F, rows],
   its five instances counted on their own), and in every
   int8 instance of the wide level shared integer adds (``ATOMS.ADD``)
   and no other atomic; print ``-Xptxas -v``'s registers, shared memory
   and spills for the leaf-totals and route instances;
3. kernel vs plain on the card at 1M x 28, N in {1, 8, 32}: binned_level
   at W=16, 32, 64, 128 (int8) and 256 (int16), in the form the shapes
   pick and in every form forced (tensor-core node-grouped up to W=32,
   tiled, and from W=32 on the wide body),
   binned_route_only at N=64; adaptive_level at W in {16, 32, 64, 128,
   256} and adaptive_route_only at N=64, both layouts (in [rows, F] from
   W=32 on every grouped form forced too; in [F, rows] the column body,
   the form picked, and the tiled body forced, the column body launched
   twice with the same bits), plus a case with NaN, ±inf
   and zero-span features; a grouped form forced where it does not fit
   or has no instance (600 features, [F, rows], the wide body at W=16,
   the int8 wide body at W=16 and 32, the tensor-core body of the float
   and int8 levels at W=64, 128, 256) and the column body forced in
   [rows, F], on the packed level or where one feature's block does not
   fit (W = 256, N = 128) must raise;
   global_hist at B1 in {15 (uint8), 257, 1025
   (int32)}, N in {1, 8, 16, 32}, about 10% of the rows outside [0, N),
   NA codes, in the node-grouped form and with global atomics. With
   integer-valued (g, h, w) node ids and histograms must be bit-equal to
   the plain PyTorch version; with float (g, h, w) node ids bit-equal and
   each histogram bin within 1e-4 + 1e-5 x (its absolute mass) of the
   plain version accumulated in float64, for float32 and for
   bfloat16-rounded masses. binned_level_i8 and adaptive_level_i8 (both
   layouts) at W in {16, 32, 64, 128, 256}, one term at N = 1..32, two
   at N = 1..16, NA codes / NaN features, 5% of the rows off the window,
   in every form (tensor-core node-grouped at W <= 32, wide at W >= 64,
   tiled, each forced, and the one the kernel picks; [F, rows] has no
   grouped form): nid and histogram bit-equal to the plain version, the
   [rows, F] forms timed.
   leaf_totals at n_prev in {0, 32}, N in {1, 64}: nid bit-equal, totals
   within the float tolerance against float64; segment_totals at N in
   {1, 64, 512, 4096}, in both forms (lane columns, matched keys) at
   row counts with rows % 4 in {1, 2, 3} and with every row in one node
   at N in {1, 64}, picked with every row in one node at N = 4096, each
   also five launches with the same bits; the [rows, F] route bit-equal
   at a row count that is not a multiple of 4, at n_prev = 1, at
   n_prev = 2048 and on an unaligned nid, its loads-only floor returning
   nid unchanged;
4. the main paths at full width: 10M x 28 HIGGS-shaped rows ->
   Frame.from_numpy(device="cuda") -> bernoulli GBM, depth 6, 20 trees,
   min_rows 1, seed 7 -> training AUC -> predict; packed at nbins 14,
   adaptive at nbins 20 (W=32), then global at nbins 1024 with
   ``quantiles_global`` (B1 = 1025, int32 codes). Each path runs with the
   launch counters set to 0 just before and read just after (6 x 20
   level launches and 20 route launches of its own kernels on the packed
   and adaptive paths, 6 x 20 global_hist on the global path, 20
   segment_totals on the packed and global paths, 0 of any other kernel);
   then packed_i8 and adaptive_i8 on the same frame
   (6 x 20 int8 level launches, 20 route launches, 0 float level
   launches), each AUC within 0.005 of its path's bf16 AUC of this run;
   then packed_wide (nbins 254) and adaptive_wide (nbins 62) on the same
   frame, with the same launch counts as packed and adaptive; then
   packed_wide_i8 and adaptive_wide_i8 (the wide paths with
   ``H2O3_HIST_I8=1``: 6 x 20 int8 level launches, 20 route launches, 0
   float level launches), each AUC within 0.005 of its wide path's;
   from a file (after phase 5): CSV -> ``import_file(device="cuda")`` ->
   GBM -> AUC -> predict, the counters set to 0 before each import. The
   HIGGS shape at 250k rows (nine significant digits, so that every
   float32 comes back exactly): every column bit-equal to
   ``Frame.from_numpy`` of the same arrays and the packed train's trees
   and AUC bit-equal to that frame's (6 x 20 binned_level, 20
   binned_route_only, 20 segment_totals). The airlines shape at 10M rows
   (the column layout of the public airline benchmark's train-10m.csv,
   drawn from a seed; enum columns of 12, 31, 7, 22 and 300 levels, NA
   cells in DepTime and UniqueCarrier): types, domain sizes and NA
   counts as drawn; H2O's default bernoulli GBM (depth 6, 20 trees) on
   adaptive bins at W = 256 (6 x 20 adaptive_level, 20
   adaptive_route_only, 0 of any other), AUC above 0.5; two float32
   trains bit for bit; a warm, profiled retrain; card vs CPU on the
   file's first 200k rows at depth 4 (cut from 6 for the time limit;
   every split equal, |dAUC| <= 1e-4). Each
   file's write and import seconds, MB/s, rows/s, H2D seconds and the
   host's cores are printed; the files are kept in the temporary
   directory, keyed by their parameters;
5. card vs CPU, same code, each path: 200k rows, depth 6, float32
   histograms, 5 trees on each device (nbins 300 on the global path);
   every tree's splits equal, |dAUC| <= 1e-4; and packed vs global on the
   card (200k rows, nbins 14, ``quantiles_global``, float32,
   ``packed_codes`` True vs False): every tree's split features, bins
   and NA directions identical; the two int8 paths on card and CPU at
   200k rows, depth 6, 5 trees, bf16, ``H2O3_HIST_I8`` 1 and 2: |dAUC|
   <= 1e-4, and at one term (every level an integer sum) tree 0's
   splits equal; the number of identical trees is printed; the two wide
   paths as packed and adaptive, the two wide int8 paths as the int8
   ones;
6. timing of each kernel at the main paths' shapes (10M x 28, per level
   N = 1..32; the packed level at W = 16 node-grouped at bf16 and
   float32 beside the tiled body forced, each level checked against its
   plain version at 10M rows and launched five times with the same bits,
   with one ``index_add_`` and the grouping pass alone at N = 32, and at
   W = 32 the tensor-core, wide and tiled forms; the node-grouped
   adaptive level at bf16 and float32, each level checked against its
   plain version at 10M rows, beside its shared-atomics ablation and the
   [F, rows] tiled body; global_hist at the six build sizes N = 1, 1, 2,
   4, 8, 16 of the global path, each checked at 10M rows, node-grouped
   and with global atomics forced; the grouping pass alone) against its
   plain version and its bound (binned_level at W = 16, 32 and 256,
   adaptive_level and global_hist also against one ``index_add_``); the
   int8 levels per level N = 1..32 at one term and N = 1..16 at two, W =
   16, 32, 64, 128 and 256, in each form (tensor-core or wide, tiled,
   picked), each checked bit-equal at 10M rows, beside the float level
   on the same inputs in the same run (at the path's W and at every wide
   W), and at N = 32 one ``index_add_`` of the widened q into int32, the
   plain version and the bound at each of those W; the levels where the
   rule's form took more than 5% above the fastest forced form are
   printed; leaf_totals at n_prev = 32, N = 64; segment_totals at N = 64
   in each form beside one ``index_add_`` (these, the route's and its
   floor's times are the device's, ``tools.time_ms``); the route in each
   layout (K9, K6) at 28 and 8 features beside its loads-only floor;
   the [F, rows] level (K5) per level N = 1..32 at W = 32, bf16, in the
   column body (the form picked) and the tiled body forced, both checked
   against the plain version on the timed inputs, as device time and one
   call, and at N = 32 at W = 32, 64, 128, 256 beside K6's route followed
   by the column body on the routed ids (bit-equal), the plain version
   and the bound; the [F, rows] grower (``phase_f_rows_grower``): at
   W = 32 and 64, margin-0 bernoulli gradients, 200k rows float32 trees
   equal split for split in both layouts on the card and on the CPU, two
   10M-row float32 [F, rows] trees bit for bit (the first after NaN-filling
   the allocator), and one 10M-row bf16 tree's six levels and route timed
   in each layout on the same inputs; binned_level and adaptive_level at the wide
   widths W = 64, 128, 256, per level N = 1..32, both forms (wide,
   tiled) checked against the plain version at 10M rows and timed, the
   wide one launched five times with the same bits, the form the kernel
   picks, and at N = 32 the plain version, the bound and one
   ``index_add_``; the global_hist record comes last, after phase 7,
   whose warm global loop it is set against;
7. where the time goes: each main path's train again, warm (20 trees
   plain, three times, then 5 trees under torch.profiler: device time by
   kernel, device busy share); the packed, adaptive, global, packed_wide
   and adaptive_wide paths each trained three times at float32, the
   first right after the allocator is filled with NaN, then twice at
   'auto', and the four int8 paths twice at 'auto', with every pair of a
   path's trains required to agree bit for bit in split features, split
   keys, NA directions and leaf values (every float sum on these paths
   comes in a fixed order; integer sums in any).

8. XGBoost, BASELINE config #2 (``phase_xgboost``): the
   ``H2OXGBoostEstimator`` on the 10M x 28 frame with a 500k-row
   validation frame (another seed; HIGGS's own held-out size), the launch
   counters set to 0 just before each train and read just after.
   ``tree_method="hist"`` at XGBoost's defaults (50 trees, depth 6, eta
   0.3, min_child_weight 1, reg_lambda 1, max_bins 256): nbins 254 at
   W = 256, exactly 6 binned_level, 1 binned_route_only and 1
   segment_totals a tree, finite better-than-chance training and
   validation AUCs, cold and warm loop seconds and rows/s, the
   validation walk's ms a tree (its margins checked against
   ``predict``), the scoring's ms an interval, the AUC's bits equal over
   five calls and on the CPU, the peak device memory.
   ``tree_method="auto"`` (nbins 62 at W = 64) with early stopping on
   the validation AUC (3 rounds, an interval of 5 trees, tolerance
   1e-3, at most 500 trees): it stops at a multiple of 5 with one
   history entry an interval, the stopping rule recomputed here from the
   printed history says stop at the last entry and at no earlier one,
   the launch counts as above at its tree count; trained twice more at
   float32: the tree count, every tree array and every history value bit
   for bit. Card vs CPU at 200k rows (validation 50k), both tree
   methods with early stopping at float32: the same tree count and
   history, every split equal, |dAUC| <= 1e-6 (min_child_weight 10).

8a. the multinomial GBM (``phase_multinomial``): a covertype-shaped
   frame (the UCI Covertype data, H2O's ``covtype.data``: 581,012 rows,
   10 integer terrain columns in its ranges, 4 wilderness and 40 soil
   one-hot columns, 7 cover types at its class shares, drawn from a
   seed) on the card and H2O's default GBM on it (multinomial by the
   response; 50 iterations of 7 trees, depth 5, nbins 20, packed codes,
   'auto' precision), the launch counters set to 0 just before and read
   just after: exactly 5 x 50 x 7 binned_level and 350 each of
   binned_route_only and segment_totals, each level's form (the rule's
   pick) one that sums in a fixed order, the training logloss below the
   class-prior model's and the error below the majority class's, each
   row's probabilities summing to 1 within 1e-5 and predict's label
   their argmax; logloss, error, mean per-class error, macro OVR AUC,
   the loop's seconds, rows x iterations / s, trees / s and the peak
   memory printed. Card vs CPU at 100k rows, 5 iterations, depth 3 (cut
   from 5 for the time limit), float32:
   every tree's splits equal but below at most one node that split on
   rounding alone on both devices, |dlogloss| <= 1e-4. Two float32 trains
   and two 'auto' trains of the full frame, each pair bit for bit.

8b. the other families (``phase_families``): a freMTPL2freq-shaped
   frame (CASdatasets' French motor claims: 678,013 policies, VehPower,
   VehAge, DrivAge, BonusMalus, Density, the enums VehBrand (11), VehGas
   (2), Area (6) and Region (22), Exposure in (0, 1], ClaimNb a Poisson
   count at about 0.10 claims a policy-year, ClaimAmount a gamma total
   on the policies with claims) and H2O's default GBM (50 trees, depth
   5) for poisson on ClaimNb and tweedie (power 1.5) on ClaimAmount,
   both with offset_column log(Exposure), a custom poisson written in
   torch on the poisson inputs (its trees equal the built-in's bit for
   bit), and on the policies with claims gamma, gaussian, laplace,
   quantile (alpha 0.9) and huber (alpha 0.9) on the mean claim: each
   with exact launch counts (5 x 50, 50, 50), the rule's form a level,
   the training deviance below the intercept-only model's (f0 plus the
   offset), predictions finite (>= 0 for the log links); predict on a
   frame without the offset column and deploy of the poisson model
   raise. Card vs CPU at 100k policies, 5 trees, float32, for poisson
   with the offset, huber and quantile: every tree's splits equal (but
   below at most one such noise split), the training deviances within a
   relative 1e-5.

8c. sampling, ROADMAP item A4 (``phase_sampling``), on the 10M x 28
   frame, the launch counters set to 0 just before each train and read
   just after: the packed GBM (depth 6, 20 trees, seed 7) with
   sample_rate 0.8, col_sample_rate 0.8 and
   col_sample_rate_change_per_level 0.9 (120 binned_level, 20 each of
   binned_route_only and segment_totals, threefry_uniform 20 row samples,
   20 column masks and a per-node subset at each of levels 1-5); the
   adaptive GBM (nbins 20) with histogram_type "random" (120
   adaptive_level, 20 adaptive_route_only, 20 grid phases); XGBoost hist
   (50 trees, the 500k-row validation frame) with subsample 0.8 and
   colsample_bytree 0.8 (300, 50, 50 and 100 draws). Each: loop seconds,
   trees/s, a better-than-chance AUC, two float32 trains bit for bit,
   card vs CPU at 200k rows and 5 trees, depth 4 (cut from 6 for the
   time limit; float32): every split equal but
   below at most one noise split, |dAUC| <= 1e-4.

8d. the random forest (``phase_drf``, ``drf_case``), H2O's DRF at the
   JAX package's defaults (50 trees, depth 10, nbins 20, min_rows 1,
   sample_rate 0.632, mtries floor(sqrt F) or F // 3, packed codes at
   W = 32), seed 7, the launch counters set to 0 just before and read
   just after: drf_higgs (the 10M x 28 frame, its label as classes,
   mtries 5: 500 binned_level, 50 binned_route_only and segment_totals,
   550 draws), drf_covtype (phase 8a's frame: 20 forest trees of 7,
   mtries 7) and
   drf_regression (the HIGGS-shaped first feature, rounded to eighths, as
   the response of the other 27 at 1M rows, mtries 9; that response is
   independent of its features, so the out-of-bag RMSE must come within
   5% of its std; in eighths its sums are exact in any order, without
   which the card and the CPU split near ties of this pure-noise
   regression differently).
   Each: every level's form one that sums in a fixed order (printed),
   the out-of-bag metrics (AUC and logloss; logloss, error and mean
   per-class error; RMSE) better than the trivial model's, predict
   finite and of its shape, loop seconds, ms a tree, trees/s, peak
   memory, two float32 trains bit for bit (20 trees; covertype 5 forest
   trees), card vs CPU at float32, depth 6 (cut from 10; 200k rows
   and 5 trees; covertype 50k
   rows and one forest tree of 7) under the one-noise-split rule, the
   device busy share of a profiled ``train()`` of 5 trees (covertype one
   forest tree of 7). drf_higgs deployed at buckets 1 and
   64: each replay bit-equal to the eager predict, 64 rows served bit-
   equal to ``predict``. Then the forest's deep levels at 10M x 28, W =
   32, bf16 (``phase_deep_record``): binned_level in its picked form at
   N = 64, 128, 256, 512 against its plain version (nid bit-equal, every
   bin within the mass tolerance, five launches bit-equal), timed beside
   its bound and one ``index_add_``; binned_route_only from n_prev = 512
   bit-equal; segment_totals over 1024 leaves (the matched keys) within
   the tolerance, five launches bit-equal, beside ``index_add_``; and
   threefry_uniform at 10M rows (``phase_threefry_record``): the uniform
   and the fused row sample (a rate; per-class rates, codes out of range
   clamped) bit-equal to the plain version, timed beside it and the
   bound.

8e. checkpoints, ROADMAP item A3 (``phase_checkpoints``,
   ``ckpt_case``), on the 10M x 28 frame: the packed GBM (20 trees) with
   ``in_training_checkpoints_dir`` every 5 trees (four artifacts, the
   JAX loop's cadence), resumed from ``<key>_t10.zip`` through
   ``checkpoint=<path>``; the same with sample_rate 0.8 (the resumed
   trees' row draws keyed by their index in the whole model); drf_higgs
   (20 trees, every 10, resumed at 10: its out-of-bag sums resumed). The
   checkpointing and the resumed trains must equal the plain one in
   every bit of every tree and in the training (out-of-bag) AUC; the
   resumed train's launches with the counters set to 0 just before
   (packed 60, 10, 10; sampled also 10 draws; the forest 100, 10, 10 and
   110 draws). Each commit's seconds and bytes, the load's seconds, the
   loop with checkpoints off and on.

8f. constraints, A5 (``phase_constraints``): the packed GBM at full
   width (20 trees) with monotone constraints on f0, f4 (+1), f1, f3
   (-1) and three interaction groups covering the 28 features (launches
   as phase 4's packed path); on the card, 1000 rows x a 64-point sweep
   of each constrained feature: no step against its direction by more
   than 1e-5; every root-to-leaf path within one group; ms a tree beside
   the unconstrained train's. Card vs CPU at 200k rows, 5 trees, depth
   4 (cut from 6 for the time limit), float32
   on the packed, adaptive and global (nbins 300) growers, every split
   equal under the one-noise-split rule.

8g. cross-validation, class balancing and calibration, A7
   (``phase_cv``): the packed GBM with nfolds 5 (launches: the main
   model's and five folds'), CV AUC and logloss, each fold's
   ``Frame.rows``, train and holdout seconds; fold 0's training rows
   gathered on the card bit-equal to the host gather (both timed); each
   fold's holdout bit-equal to its model's ``predict`` on its rows.
   ``balance_classes`` on phase 8a's covertype frame (20 iterations):
   the prior class distribution the frame's shares, the balanced one
   uniform, 512 served rows bit-equal to ``predict`` with the
   correction. Platt and isotonic calibration of the packed GBM on a
   500k-row calibration frame: ``cal_p0``/``cal_p1`` finite
   probabilities, their logloss beside the raw ``p1``'s (Platt's no
   worse).

8h. the out-of-core GBM, item 13 (``phase_streaming``), on the 10M x 28
   frame under ``memman.reset(budget=...)``: the packed path streamed
   in one chunk its window holds, bit-equal to phase 4's dense packed
   train in trees, predictions and AUC; in 8 chunks with 4 resident
   (``H2O3_STREAM_RESIDENT``), beside a 5-tree ``H2O3_LEVELS_PER_PASS=1``
   train of the same configuration (its trees equal) and beside a train
   with no window (its trees equal); the adaptive path in 8 chunks with
   4 resident; each with its launches (a level kernel a level a chunk,
   the route and the totals a tree a chunk), its loop, the H2D bytes a
   tree and the share of the overflow copies' time the compute stream
   did not wait for (CUDA events on both streams), the AUC within 1e-3
   of the dense one's; every tree holding all rows' weight (root,
   children, leaves: exact) and the multi-chunk trains' first root
   split the dense train's; the L = 1 twin under torch.profiler (kernel
   and copy device time beside the loop). Then a real
   out-of-memory degrade: the allocator capped
   (``set_per_process_memory_fraction``, this process only) at what it
   holds plus 3 GiB, the dense packed train runs out, completes
   streamed with one warning and the resident train's first 5 trees;
   the cap lifted.
8i. item 14, the mesh (``phase_spmd``), on the 10M x 28 frame: (4, 1)
   virtual shards of the one card for the packed, adaptive (W = 32) and
   global (nbins 1024) paths, each level kernel, route and leaf-totals
   launch once a shard, each against the one-shard train in two ways:
   the two trains by ``layout_splits`` (``card_vs_cpu_splits``' rule
   between two layouts, which also lets a residue split explain a
   difference: one whose smaller child's hessian is within 4 ulps of
   the node's, so that the child's score and leaf are made by rounding;
   the trees after one train on other margins, so the comparison ends
   there), AUC within 1e-4 where no residue split ended it; and every
   tree of the one-shard train grown again at (4, 1) from that tree's
   own g, h and w (``regrown``), all 20 trees by the same rule, the
   one-shard model with those trees within 1e-4 of its AUC (a tree that
   a residue split sets apart kept as one shard's: the split is a fault
   of the float32 search on either layout, ROADMAP queue 3; the AUC
   with it regrown too is printed). Packed-i8
   at (4, 1), each shard its own int8 scale, AUC within 0.005 of the
   float packed path; the packed train at (4, 1) once more, unrecorded
   and bit-equal to the recorded one (the warm loop, the reduce's
   device time a level by CUDA events, shardstats' collective wait),
   and at (4, 2), bit-equal to (4, 1); a sampled GBM and a DRF at (4,
   1), 200k rows, card against CPU on the same mesh; an NCCL process
   group of one rank (``h2o3_tpu_torch.tools.multihost_worker``) whose
   1M-row packed train is the one-shard train's bit for bit, and two
   gloo processes on the one card, equal digests, equal to the
   in-process (2, 1) mesh's.

9. the probe tools (``phase_probes``; ``h2o3_tpu_torch/tools``, the
   Hopper counterparts of the JAX package's TPU probes P1-P6, their
   kernels in ``tools/csrc/probes.cu``, built in phase 2 beside the
   training path's, whose SASS check also holds every knock-out
   instance to its body's production instance: no fewer shared loads
   but the phase's own (``PHASE_LOADS``), the grouped body's HMMA/IMMA in
   every one but the adds knock-out). At a small size every probe kernel
   against its plain version: P1 (``mxu_probe``, bf16 within 1e-5 x the
   absolute mass, int8 exact), P5 (``gather_probe``, ``onehot_probe``,
   bit-equal, indices outside the table among them), and every
   knock-out (route, ranges, bins, adds, walk, gather) of every probed
   body (the tensor-core grouped body at W = 16 packed and W = 32
   adaptive, the wide body at W = 64 adaptive and W = 256 packed, both
   with float and with int8 masses, and the tiled [F, rows] body) at N =
   2 and 32 with integer masses, bit-equal, its production instance also
   bit-equal to the training path's wrapper, the walk again on float
   masses within the mass tolerance. Then each tool's entry point at the
   JAX tools' sizes with the launch counters set to 0 just before and
   read just after (each must launch its kernels): P1 at M = 6, 24, 96,
   128, 256 (bf16 and int8 at FW 896, bf16 at 448, bf16 chained L = 4),
   eager and as a CUDA graph, beside one torch product; P5 beside
   ``index_select``; P2 as the attribution of every probed body at N = 32
   and N = 2 (10M x 28: each knock-out's ms and share, the grouping pass
   and merge alone, the residual, bound, ``index_add_``); P3 (2.5M rows,
   L = 1, 2, 4, eager against one CUDA graph); P4; P6 (the deepest
   adaptive level in every form). Each tool holds each kernel's first
   output on its timed inputs to the plain version (P1 at every M, P5 at
   2.5M rows, every knock-out at 10M rows: int8 bit for bit, float
   within the mass tolerance) and times the device alone, its reps
   queued back to back (P3's eager chains keep the host's launch time on
   purpose; its shares are of the graph's times).

10. scoring and serving (``phase_serve``, run after phase 8d on the
   packed main path's model, XGBoost hist, the multinomial model of 8a
   and the airlines model; no K-kernel may launch in it): ``model.predict`` over the 10M x 28 frame
   for the first two, cold and the warm median of 3, rows/s, peak device
   memory and the bound (X read once, one 32-byte sector of X gathered
   and a 4-byte leaf id read and written a row, level and tree); each
   model deployed with the buckets 1/8/64/512/4096, one CUDA graph each:
   the capture's seconds, the replay's device time (median of 100), the
   eager predict at the same shape (median of 10), the device activities
   of one eager call (torch.profiler), the replay bit-equal to eager;
   4096 rows of each frame through ``predict_rows`` and
   ``predict_columnar`` bit-equal to ``predict`` (the airlines rows with
   string labels, one unknown level and a column missing, against
   predict of a frame of the same values; the multinomial rows in their
   label and all 7 probabilities, its replays timed over 10 and its
   eager calls over 2, its device activities counted at bucket 1); 16
   client threads x 256
   requests of 1-64 rows at max_batch 512, every answer bit-equal to
   predict, with no capture and no eager predict after deploy: rows/s,
   requests/s, p50, p99, batches, live rows a batch, stage totals.

Before its last lines it prints each phase's wall seconds. The last
two lines of stdout are the kernel record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
SRC = {"binned_level": "h2o3_tpu_torch/csrc/hist_binned.cu",
       "binned_route_only": "h2o3_tpu_torch/csrc/hist_binned.cu",
       "binned_level_i8": "h2o3_tpu_torch/csrc/hist_binned.cu",
       "adaptive_level": "h2o3_tpu_torch/csrc/hist_adaptive.cu",
       "adaptive_route_only": "h2o3_tpu_torch/csrc/hist_adaptive.cu",
       "adaptive_level_i8": "h2o3_tpu_torch/csrc/hist_adaptive.cu",
       "leaf_totals": "h2o3_tpu_torch/csrc/hist_adaptive.cu",
       "segment_totals": "h2o3_tpu_torch/csrc/hist_adaptive.cu",
       "global_hist": "h2o3_tpu_torch/csrc/hist_global.cu"}
# the TPU kernel each replaces (adaptive_level: K8, the training layout's,
# whose record times the node-grouped form); the adaptive kernels' layout
# parameter also covers the other layout (K5; K9 beside K6)
REPLACES = {"binned_level": "h2o3_tpu/ops/hist_adaptive.py:930",
            "binned_route_only": "h2o3_tpu/ops/hist_adaptive.py:1282",
            "binned_level_i8": "h2o3_tpu/ops/hist_adaptive.py:1154",
            "adaptive_level": "h2o3_tpu/ops/hist_adaptive.py:134",
            "adaptive_route_only": "h2o3_tpu/ops/hist_adaptive.py:755",
            "adaptive_level_i8": "h2o3_tpu/ops/hist_adaptive.py:500",
            "leaf_totals": "h2o3_tpu/ops/hist_adaptive.py:365",
            "segment_totals": "h2o3_tpu/ops/hist_adaptive.py:365",
            "global_hist": "h2o3_tpu/ops/hist_pallas.py:47"}
ALSO_REPLACES = {"binned_level": "h2o3_tpu/ops/hist_adaptive.py:1014",
                 "adaptive_level": "h2o3_tpu/ops/hist_adaptive.py:641",
                 "adaptive_route_only": "h2o3_tpu/ops/hist_adaptive.py:787"}
# the three GBM paths: their parameters and the kernels each launches
# (level: 6 a tree; route and the deepest level's totals: one a tree)
PATHS = {
    "packed": {"params": dict(nbins=14, histogram_type="quantiles_global"),
               "level": "binned_level", "route": "binned_route_only",
               "totals": "segment_totals", "split_key": "split_bin"},
    "adaptive": {"params": dict(nbins=20, packed_codes=False),
                 "level": "adaptive_level", "route": "adaptive_route_only",
                 "split_key": "thr"},
    "global": {"params": dict(nbins=1024, histogram_type="quantiles_global"),
               "level": "global_hist", "route": None,
               "totals": "segment_totals", "split_key": "split_bin"},
    # the packed and adaptive paths with H2O3_HIST_I8 (int8 fixed-point
    # masses, one term: every level of a depth-6 tree at bf16)
    "packed_i8": {"params": dict(nbins=14, histogram_type="quantiles_global"),
                  "level": "binned_level_i8", "route": "binned_route_only",
                  "totals": "segment_totals", "split_key": "split_bin",
                  "i8": 1},
    "adaptive_i8": {"params": dict(nbins=20, packed_codes=False),
                    "level": "adaptive_level_i8",
                    "route": "adaptive_route_only", "split_key": "thr",
                    "i8": 1},
    # the wide lane widths: nbins 254 packed (int16 codes, W = 256, the
    # wide body of binned_level; XGBoost's tree_method="hist" at
    # max_bins=256) and nbins 62 on adaptive bins (W = 64, the wide body
    # of adaptive_level; XGBoost's "auto" takes nbins 62 too, but packs
    # them: phase_xgboost)
    "packed_wide": {"params": dict(nbins=254,
                                   histogram_type="quantiles_global"),
                    "level": "binned_level", "route": "binned_route_only",
                    "totals": "segment_totals", "split_key": "split_bin"},
    "adaptive_wide": {"params": dict(nbins=62, packed_codes=False),
                      "level": "adaptive_level",
                      "route": "adaptive_route_only", "split_key": "thr"},
    # the wide paths with H2O3_HIST_I8 (one term: every level takes the
    # int8 kernel, on its wide body)
    "packed_wide_i8": {"params": dict(nbins=254,
                                      histogram_type="quantiles_global"),
                       "level": "binned_level_i8",
                       "route": "binned_route_only",
                       "totals": "segment_totals", "split_key": "split_bin",
                       "i8": 1},
    "adaptive_wide_i8": {"params": dict(nbins=62, packed_codes=False),
                         "level": "adaptive_level_i8",
                         "route": "adaptive_route_only", "split_key": "thr",
                         "i8": 1},
    # from a CSV file through import_file: the HIGGS shape on the packed
    # path, and the airlines shape (enum columns of about 300 levels, so
    # no packing: adaptive bins at W = 256, the wide adaptive level) with
    # H2O's defaults (nbins 20, min_rows 10)
    "higgs_csv": {"params": dict(nbins=14,
                                 histogram_type="quantiles_global"),
                  "level": "binned_level", "route": "binned_route_only",
                  "totals": "segment_totals", "split_key": "split_bin"},
    "airlines_csv": {"params": dict(min_rows=10.0),
                     "level": "adaptive_level",
                     "route": "adaptive_route_only", "split_key": "thr",
                     "y": "dep_delayed_15min"},
}
# the airlines file compressed (phase_ingest): the same train
PATHS["airlines_gzip"] = PATHS["airlines_zstd"] = PATHS["airlines_csv"]
# the float levels' wide lane widths
WIDE_W = (64, 128, 256)
LAYOUTS = ("rows_f", "f_rows")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------ timing


def time_cuda(fn, reps: int, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls, each between
    its own pair of CUDA events (with the L2 flushed before it when
    ``flush`` is given)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()        # evict the 50 MB L2 between launches
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def level_bound_ms(rows, F, itemsize, N, W, rows_in_level):
    """Least time for one level: each input read once (codes, nid, ghw),
    each output written once (nid', hist), or 3 float adds per
    (row in the level, feature), whichever takes longer."""
    nbytes = rows * (F * itemsize + 4 + 12 + 4) + 3 * N * F * W * 4
    ops = 3 * rows_in_level * F
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def route_bound_ms(rows, F, itemsize, layout="rows_f"):
    """The route reads one code (or raw value), one nid and writes one
    nid per row. In [rows, F] a row's codes are contiguous, so gathering
    one code a row moves the whole 32-byte sector that holds it:
    min(F x itemsize, 32) bytes a row; in [F, rows] a warp's rows read
    one feature's contiguous run, itemsize bytes a row."""
    code = min(F * itemsize, 32) if layout == "rows_f" else itemsize
    return rows * (code + 8) / HBM_BYTES_PER_S * 1e3, "bytes"


def adaptive_level_bound_ms(rows, F, N, W, rows_in_level):
    """Least time for one adaptive level: each input read once (float32
    features, nid, ghw), each output written once (nid', hist), or a
    subtract, a multiply and 3 float adds per (row in the level,
    feature), whichever takes longer."""
    nbytes = rows * (F * 4 + 4 + 12 + 4) + 3 * N * F * W * 4
    ops = 5 * rows_in_level * F
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def global_bound_ms(rows, F, itemsize, N, B1, rows_in_level):
    """Least time for one global-sketch histogram: every row's seg read
    once, the codes and ghw of the rows in [0, N) read once (no other
    row's are needed), the histogram written once; or 3 float adds per
    (row in [0, N), feature); whichever takes longer."""
    nbytes = (rows * 4 + rows_in_level * (F * itemsize + 12)
              + 3 * N * F * B1 * 4)
    ops = 3 * rows_in_level * F
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def mass_check(name, hk, hp, mass):
    """Float masses: each bin within 1e-4 + 1e-5 x its absolute mass of
    the float64 plain version."""
    excess = (hk.double() - hp).abs() - (1e-4 + 1e-5 * mass)
    if float(excess.max()) > 0:
        err = float((hk.double() - hp).abs().max())
        raise AssertionError(f"{name} float ghw: max abs err {err} beyond "
                             f"1e-4 + 1e-5 x bin mass")


# ------------------------------------------------- kernel vs plain


def torch_flush(dev):
    """A 96 MB buffer whose zeroing evicts the 50 MB L2 between timed
    launches."""
    import torch
    return torch.empty(96 << 20, dtype=torch.uint8, device=dev)


def level_inputs(rows, F, W, N, int_ghw, seed, dev):
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import code_dtype, make_tables
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, W - 1, (rows, F), generator=g, device=dev)
    na = torch.rand((rows, F), generator=g, device=dev) < 0.05
    codes = torch.where(na, W - 1, codes).to(code_dtype(W))
    n_prev, base = N // 2, N - 1
    if n_prev:
        nid = (base - n_prev + torch.randint(0, n_prev, (rows,), generator=g,
                                             device=dev)).to(torch.int32)
    else:
        nid = torch.zeros(rows, dtype=torch.int32, device=dev)
    if int_ghw:
        gg = torch.randint(-8, 9, (rows,), generator=g, device=dev).float()
        hh = torch.randint(0, 4, (rows,), generator=g, device=dev).float()
    else:
        gg = torch.randn(rows, generator=g, device=dev)
        hh = torch.rand(rows, generator=g, device=dev) * 0.25
    ghw = torch.stack([gg, hh, torch.ones(rows, device=dev)]).contiguous()
    m = max(n_prev, 1)
    tables = make_tables(
        torch.randint(0, F, (m,), generator=g, device=dev),
        torch.randint(1, W - 1, (m,), generator=g, device=dev),
        torch.rand(m, generator=g, device=dev) < 0.5,
        torch.rand(m, generator=g, device=dev) < 0.9).contiguous()
    return codes, nid, ghw, tables, n_prev, base


def binned_form(form):
    """The launch of one form of binned_level: "picked" (the training
    path's wrapper: the kernel picks from the shapes), or one forced by
    name (kernels.LEVEL_FORMS: "grouped", the tensor-core body; "wide";
    "tiled")."""
    from h2o3_tpu_torch.ops import kernels
    if form == "picked":
        return kernels.binned_level
    return lambda *a: kernels.binned_level_form(*a, form)


def adaptive_form(form):
    """The launch of one form of adaptive_level, as ``binned_form``."""
    from h2o3_tpu_torch.ops import kernels
    if form == "picked":
        return kernels.adaptive_level
    return lambda *a: kernels.adaptive_level_form(*a, form)


def check_level(rows, F, W, N, int_ghw, bf16, dev, seed, form="picked",
                inp=None):
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import binned_level_plain
    if inp is None:
        inp = level_inputs(rows, F, W, N, int_ghw, seed, dev)
    codes, nid, ghw, tables, n_prev, base = inp
    nk, hk = binned_form(form)(codes, nid, ghw, tables, n_prev, N, base, W,
                               bf16)
    # integer masses: the float32 plain version is exact in any order.
    # Float masses: the plain version accumulates in float64, and a bin
    # passes when |kernel - plain| <= 1e-4 + 1e-5 * (the bin's absolute
    # mass, sum |x|): a float32 sum of ~1e4 signed gradients is only
    # accurate relative to that mass, and near-cancelling bins make a
    # plain rtol on the signed sum fail for any summation order.
    npl, hp = binned_level_plain(codes, nid,
                                 ghw if int_ghw else ghw.double(), tables,
                                 n_prev, N, base, W, bf16)
    torch.cuda.synchronize()
    name = f"binned_level {form} W={W} N={N}"
    if not torch.equal(nk, npl):
        raise AssertionError(f"{name}: nid differs in "
                             f"{int((nk != npl).sum())} rows")
    err = float((hk.double() - hp.double()).abs().max())
    if int_ghw:
        if not torch.equal(hk, hp):
            raise AssertionError(f"{name} integer ghw: histogram not "
                                 f"bit-equal (max {err})")
    else:
        _n, mass = binned_level_plain(codes, nid, ghw.double().abs(),
                                      tables, n_prev, N, base, W, bf16)
        mass_check(name, hk, hp, mass)
    return err, inp


def check_forms(kind, inp, N, W, bf16, forms, layout="rows_f"):
    """Each of ``forms`` of a float level (kind "binned" on level_inputs,
    or "adaptive" on adaptive_inputs in ``layout``) against the plain
    version on the same inputs, computed once in float64: nid bit-equal,
    each bin within the float tolerance (mass_check). Returns the largest
    absolute error of each form."""
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_level_plain,
                                                  binned_level_plain)
    if kind == "binned":
        codes, nid, ghw, tables, n_prev, base = inp
        run = lambda f: binned_form(f)(codes, nid, ghw, tables, n_prev, N,
                                       base, W, bf16)
        plain = lambda g: binned_level_plain(codes, nid, g, tables, n_prev,
                                             N, base, W, bf16)
    else:
        x, nid, ghw, tables, lo, inv, n_prev, base = inp
        run = lambda f: adaptive_form(f)(x, nid, ghw, tables, lo, inv,
                                         n_prev, N, base, W, bf16, layout)
        plain = lambda g: adaptive_level_plain(x, nid, g, tables, lo, inv,
                                               n_prev, N, base, W, bf16,
                                               layout)
    npl, hp = plain(ghw.double())
    _n, mass = plain(ghw.double().abs())
    errs = {}
    for form in forms:
        nk, hk = run(form)
        torch.cuda.synchronize()
        name = f"{kind}_level {form} {layout} W={W} N={N}"
        if not torch.equal(nk, npl):
            raise AssertionError(f"{name}: nid differs in "
                                 f"{int((nk != npl).sum())} rows")
        mass_check(name, hk, hp, mass)
        errs[form] = float((hk.double() - hp).abs().max())
        del nk, hk
    return errs


def check_route(rows, F, W, N, dev, seed):
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import binned_route_only_plain
    codes, nid, _ghw, tables, n_prev, base = level_inputs(
        rows, F, W, N, True, seed, dev)
    rk = kernels.binned_route_only(codes, nid, tables, n_prev, base, W)
    rp = binned_route_only_plain(codes, nid, tables, n_prev, base, W)
    torch.cuda.synchronize()
    if not torch.equal(rk, rp):
        raise AssertionError(f"binned_route_only N={N}: nid differs")
    return 0.0, (codes, nid, tables, n_prev, base)


def level_forms(W):
    """The forced forms of a float level at lane width W: the tensor-core
    grouped body below W = 64, the wide body from W = 32 (at W = 32 the
    rule weighs the two), the tiled body."""
    if W >= 64:
        return ("wide", "tiled")
    return ("grouped", "wide", "tiled") if W == 32 else ("grouped", "tiled")


def phase_kernels(dev, rows=1_000_000, F=28):
    """Phase 3: every instance against its plain version at 1M rows; the
    packed level in the form the shapes pick and in every form forced."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (binned_level_plain,
                                                  binned_route_only_plain)
    flush = torch_flush(dev)
    seed = 0
    for W in (16, 32, 64, 128, 256):
        forms = level_forms(W)
        for N in (1, 8, 32):
            seed += 1
            for form in forms:
                check_level(rows, F, W, N, True, False, dev, seed, form)
            err, inp = check_level(rows, F, W, N, False, False, dev,
                                   seed + 100)
            err16, _ = check_level(rows, F, W, N, False, True, dev,
                                   seed + 200)
            codes, nid, ghw, tables, n_prev, base = inp
            for form in forms:
                check_level(rows, F, W, N, False, False, dev, 0, form, inp)
            ms = {form: time_cuda(lambda: binned_form(form)(
                codes, nid, ghw, tables, n_prev, N, base, W, False), 20,
                flush) for form in forms}
            pms = time_cuda(lambda: binned_level_plain(
                codes, nid, ghw, tables, n_prev, N, base, W, False), 3,
                flush)
            bound, by = level_bound_ms(rows, F, codes.element_size(), N, W,
                                       rows)
            print(f"binned_level {rows}x{F} W={W} N={N}: {json.dumps(ms)} "
                  f"ms (plain {pms:.6g} ms, bound {bound:.6g} ms by {by}) "
                  f"max abs err f32 {err:.3g} bf16 {err16:.3g}", flush=True)
            del inp
    _err, (codes, nid, tables, n_prev, base) = check_route(
        rows, F, 16, 64, dev, 7)
    ms = time_cuda(lambda: kernels.binned_route_only(
        codes, nid, tables, n_prev, base, 16), 20, flush)
    pms = time_cuda(lambda: binned_route_only_plain(
        codes, nid, tables, n_prev, base, 16), 3, flush)
    bound, by = route_bound_ms(rows, F, 1)
    print(f"binned_route_only {rows}x{F} N=64: {ms:.6g} ms (plain "
          f"{pms:.6g} ms, bound {bound:.6g} ms by {by})", flush=True)
    check_forms_refused(dev)


def check_forms_refused(dev):
    """A grouped form forced where it does not fit or has no instance
    raises, and nothing falls back: the packed level past 512 features,
    the adaptive level in [F, rows] (the int8 one too), the wide body of
    the float levels at W = 16 and of the int8 levels at W = 16 and 32,
    the tensor-core body of all four at W = 64, 128, 256; the column body
    in [rows, F], on the packed level and in [F, rows] where one feature's
    block does not fit (W = 256, N = 128) (the rule picks none of
    these)."""
    from h2o3_tpu_torch.ops import kernels
    codes, nid, ghw, tables, n_prev, base = level_inputs(2048, 600, 64, 4,
                                                         True, 3, dev)
    x, nidx, ghwx, tabx, lo, inv, n_px, base_x = adaptive_inputs(
        2048, 8, 64, 4, True, 3, dev, "f_rows")
    c16, n16, g16, t16, p16, b16 = level_inputs(2048, 8, 16, 4, True, 3, dev)
    x16, nx16, gx16, tx16, lo16, inv16, px16, bx16 = adaptive_inputs(
        2048, 8, 16, 4, True, 3, dev, "rows_f")
    launches = [(f"{kind} {form}", launch) for form in ("grouped", "wide")
                for kind, launch in (
                    ("binned_level 600 features",
                     lambda: kernels.binned_level_form(
                         codes, nid, ghw, tables, n_prev, 4, base, 64, True,
                         form)),
                    ("adaptive_level [F, rows]",
                     lambda: kernels.adaptive_level_form(
                         x, nidx, ghwx, tabx, lo, inv, n_px, 4, base_x, 64,
                         True, "f_rows", form)))]
    # the column body: [F, rows] only, and only where one feature's block
    # fits shared memory (not at W = 256, N = 128)
    xc, nxc, gxc, txc, loc, invc, pxc, bxc = adaptive_inputs(
        2048, 8, 256, 128, True, 3, dev, "f_rows")
    launches += [
        ("adaptive_level [rows, F] column",
         lambda: kernels.adaptive_level_form(
             x16, nx16, gx16, tx16, lo16, inv16, px16, 4, bx16, 16, True,
             "rows_f", "column")),
        ("adaptive_level [F, rows] W=256 N=128 column",
         lambda: kernels.adaptive_level_form(
             xc, nxc, gxc, txc, loc, invc, pxc, 128, bxc, 256, True,
             "f_rows", "column")),
        ("binned_level column", lambda: kernels.binned_level_form(
            c16, n16, g16, t16, p16, 4, b16, 16, True, "column"))]
    launches += [
        ("binned_level W=16 wide", lambda: kernels.binned_level_form(
            c16, n16, g16, t16, p16, 4, b16, 16, True, "wide")),
        ("adaptive_level W=16 wide", lambda: kernels.adaptive_level_form(
            x16, nx16, gx16, tx16, lo16, inv16, px16, 4, bx16, 16, True,
            "rows_f", "wide"))]
    # the int8 levels: the wide body below W = 64 and in [F, rows]
    from h2o3_tpu_torch.ops.hist_adaptive import quantize_ghw_i8
    for W in (16, 32):
        ci, ni, gi, ti, pi, bi = level_inputs(2048, 8, W, 4, True, 3, dev)
        xi, nxi, gxi, txi, loi, invi, pxi, bxi = adaptive_inputs(
            2048, 8, W, 4, True, 3, dev, "rows_f")
        launches += [
            (f"binned_level_i8 W={W} wide",
             lambda ci=ci, ni=ni, gi=gi, ti=ti, pi=pi, bi=bi, W=W:
             kernels.binned_level_i8_form(ci, ni, *quantize_ghw_i8(gi), ti,
                                          pi, 4, bi, W, "wide")),
            (f"adaptive_level_i8 W={W} wide",
             lambda xi=xi, nxi=nxi, gxi=gxi, txi=txi, loi=loi, invi=invi,
             pxi=pxi, bxi=bxi, W=W: kernels.adaptive_level_i8_form(
                 xi, nxi, *quantize_ghw_i8(gxi), txi, loi, invi, pxi, 4, bxi,
                 W, "rows_f", "wide"))]
    launches.append(("adaptive_level_i8 [F, rows] wide",
                     lambda: kernels.adaptive_level_i8_form(
                         x, nidx, *quantize_ghw_i8(ghwx), tabx, lo, inv,
                         n_px, 4, base_x, 64, "f_rows", "wide")))
    # the tensor-core body at W >= 64 (no instance: the wide body wins
    # every level there), float and int8
    for W in WIDE_W:
        cw, nw, gw, tw, pw, bw = level_inputs(2048, 8, W, 4, True, 3, dev)
        xw, nxw, gxw, txw, low, invw, pxw, bxw = adaptive_inputs(
            2048, 8, W, 4, True, 3, dev, "rows_f")
        launches += [
            (f"binned_level W={W} grouped",
             lambda cw=cw, nw=nw, gw=gw, tw=tw, pw=pw, bw=bw, W=W:
             kernels.binned_level_form(cw, nw, gw, tw, pw, 4, bw, W, True,
                                       "grouped")),
            (f"adaptive_level W={W} grouped",
             lambda xw=xw, nxw=nxw, gxw=gxw, txw=txw, low=low, invw=invw,
             pxw=pxw, bxw=bxw, W=W: kernels.adaptive_level_form(
                 xw, nxw, gxw, txw, low, invw, pxw, 4, bxw, W, True,
                 "rows_f", "grouped")),
            (f"binned_level_i8 W={W} grouped",
             lambda cw=cw, nw=nw, gw=gw, tw=tw, pw=pw, bw=bw, W=W:
             kernels.binned_level_i8_form(cw, nw, *quantize_ghw_i8(gw), tw,
                                          pw, 4, bw, W, "grouped")),
            (f"adaptive_level_i8 W={W} grouped",
             lambda xw=xw, nxw=nxw, gxw=gxw, txw=txw, low=low, invw=invw,
             pxw=pxw, bxw=bxw, W=W: kernels.adaptive_level_i8_form(
                 xw, nxw, *quantize_ghw_i8(gxw), txw, low, invw, pxw, 4,
                 bxw, W, "rows_f", "grouped"))]
    for name, launch in launches:
        try:
            launch()
        except (RuntimeError, ValueError):
            continue
        raise AssertionError(f"forced form {name} did not raise where it "
                             f"does not fit")
    print(f"forced grouped forms where they do not fit or have no instance "
          f"({len(launches)}: 600 features; [F, rows]; the column body in "
          f"[rows, F], on the packed level and in [F, rows] at W = 256, N = "
          f"128; the wide body of the float levels at W = 16 and of the int8 "
          f"levels at W = 16, 32; the tensor-core body at W = 64, 128, 256): "
          f"every one raised",
          flush=True)


def adaptive_inputs(rows, F, W, N, int_ghw, seed, dev, layout,
                    specials=False):
    """Raw HIGGS-like features (5% NaN) in ``layout``, nid in the
    previous level's window, (g, h, w), float32 split tables and per-node
    ranges that cover the bulk of the values. ``specials`` adds ±inf on a
    live range (feature 0) and on a zero-span feature (feature 1)."""
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import make_adaptive_tables
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (rows, F) if layout == "rows_f" else (F, rows)
    x = torch.randn(shape, generator=g, device=dev)
    x = torch.where(torch.rand(shape, generator=g, device=dev) < 0.05,
                    torch.nan, x)
    n_prev, base = N // 2, N - 1
    lo = -4.0 + 0.5 * torch.rand((N, F), generator=g, device=dev)
    inv = (W - 2) / (7.0 + torch.rand((N, F), generator=g, device=dev))
    if specials:
        xr = x if layout == "rows_f" else x.t()
        xr[:, 1] = 0.5
        xr[0::5, 1] = torch.inf
        xr[2::5, 1] = -torch.inf
        xr[1::7, 0] = torch.inf
        xr[3::7, 0] = -torch.inf
        lo[:, 1] = 0.5
        inv[:, 1] = 0.0
    if n_prev:
        nid = (base - n_prev + torch.randint(0, n_prev, (rows,), generator=g,
                                             device=dev)).to(torch.int32)
    else:
        nid = torch.zeros(rows, dtype=torch.int32, device=dev)
    if int_ghw:
        gg = torch.randint(-8, 9, (rows,), generator=g, device=dev).float()
        hh = torch.randint(0, 4, (rows,), generator=g, device=dev).float()
    else:
        gg = torch.randn(rows, generator=g, device=dev)
        hh = torch.rand(rows, generator=g, device=dev) * 0.25
    ghw = torch.stack([gg, hh, torch.ones(rows, device=dev)]).contiguous()
    m = max(n_prev, 1)
    tables = make_adaptive_tables(
        torch.randint(0, F, (m,), generator=g, device=dev),
        torch.randn(m, generator=g, device=dev),
        torch.rand(m, generator=g, device=dev) < 0.5,
        torch.rand(m, generator=g, device=dev) < 0.9).contiguous()
    return (x.contiguous(), nid, ghw, tables, lo.contiguous(),
            inv.contiguous(), n_prev, base)


def check_adaptive_level(rows, F, W, N, int_ghw, bf16, dev, seed, layout,
                         specials=False, form="picked"):
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import adaptive_level_plain
    inp = adaptive_inputs(rows, F, W, N, int_ghw, seed, dev, layout,
                          specials)
    x, nid, ghw, tables, lo, inv, n_prev, base = inp
    nk, hk = adaptive_form(form)(x, nid, ghw, tables, lo, inv, n_prev, N,
                                 base, W, bf16, layout)
    npl, hp = adaptive_level_plain(x, nid, ghw if int_ghw else ghw.double(),
                                   tables, lo, inv, n_prev, N, base, W, bf16,
                                   layout)
    torch.cuda.synchronize()
    name = f"adaptive_level {form} {layout} W={W} N={N}"
    if not torch.equal(nk, npl):
        raise AssertionError(f"{name}: nid differs in "
                             f"{int((nk != npl).sum())} rows")
    err = float((hk.double() - hp.double()).abs().max())
    if int_ghw:
        if not torch.equal(hk, hp):
            raise AssertionError(f"{name} integer ghw: histogram not "
                                 f"bit-equal (max {err})")
    else:
        _n, mass = adaptive_level_plain(x, nid, ghw.double().abs(), tables,
                                        lo, inv, n_prev, N, base, W, bf16,
                                        layout)
        mass_check(name, hk, hp, mass)
    return err, inp


def check_adaptive_route(rows, F, N, dev, seed, layout):
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import adaptive_route_only_plain
    x, nid, _g, tables, _lo, _inv, n_prev, base = adaptive_inputs(
        rows, F, 16, N, True, seed, dev, layout)
    rk = kernels.adaptive_route_only(x, nid, tables, n_prev, base, layout)
    rp = adaptive_route_only_plain(x, nid, tables, n_prev, base, layout)
    torch.cuda.synchronize()
    if not torch.equal(rk, rp):
        raise AssertionError(f"adaptive_route_only {layout} N={N}: nid "
                             f"differs")
    return (x, nid, tables, n_prev, base)


def check_route_cases(dev, F=28):
    """K9 (the [rows, F] route) bit-equal to its plain version at a row
    count that is not a multiple of 4, at n_prev = 1, at n_prev = 2048
    and on an nid that is not 16-byte aligned; its loads-only floor
    returns nid unchanged."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import adaptive_route_only_plain
    cases = {"ragged": (1_000_003, 64, False), "n_prev=1": (1_000_000, 2,
                                                            False),
             "n_prev=2048": (1_000_001, 4096, False),
             "unaligned": (1_000_002, 64, True)}
    for seed, (name, (rows, N, shift)) in enumerate(cases.items()):
        x, nid, _g, tables, _lo, _inv, n_prev, base = adaptive_inputs(
            rows, F, 16, N, True, 4400 + seed, dev, "rows_f")
        if shift:       # nid[1:]: a view whose start is 4 bytes past 16
            x, nid = x[1:], nid[1:]
        want = adaptive_route_only_plain(x, nid, tables, n_prev, base,
                                         "rows_f")
        got = kernels.adaptive_route_only(x, nid, tables, n_prev, base,
                                          "rows_f")
        floor = kernels.adaptive_route_floor(x, nid, tables, n_prev, base)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"adaptive_route_only rows_f {name}: nid "
                                 f"differs in {int((got != want).sum())} "
                                 f"rows")
        if not torch.equal(floor, nid):
            raise AssertionError(f"adaptive_route_floor {name}: nid changed")
    print(f"adaptive_route_only rows_f bit-equal at {sorted(cases)}; "
          f"loads-only floor keeps nid", flush=True)


def phase_adaptive_kernels(dev, rows=1_000_000, F=28):
    """Phase 3, adaptive half: every instance and layout against its
    plain version at 1M rows, timed with the L2 flushed."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    flush = torch_flush(dev)
    seed = 500
    for layout in LAYOUTS:
        for W in (16, 32, 64, 128, 256):
            for N in (1, 8, 32):
                seed += 1
                check_adaptive_level(rows, F, W, N, True, False, dev, seed,
                                     layout)
                # every form forced: in [rows, F] from W = 32 on; in
                # [F, rows] the column body (the form picked) and the tiled
                for form in (level_forms(W) if layout == "rows_f"
                             else ("column", "tiled")):
                    if layout == "rows_f" and W < 32:
                        break
                    check_adaptive_level(rows, F, W, N, True, False, dev,
                                         seed, layout, form=form)
                    check_adaptive_level(rows, F, W, N, False, True, dev,
                                         seed + 300, layout, form=form)
                err16, _ = check_adaptive_level(rows, F, W, N, False, True,
                                                dev, seed + 100, layout)
                err, inp = check_adaptive_level(rows, F, W, N, False, False,
                                                dev, seed + 200, layout)
                x, nid, ghw, tables, lo, inv, n_prev, base = inp
                if layout == "f_rows":   # the column body: the same bits
                    runs = [kernels.adaptive_level(
                        x, nid, ghw, tables, lo, inv, n_prev, N, base, W,
                        False, layout)[1] for _ in range(2)]
                    if not torch.equal(runs[0], runs[1]):
                        raise AssertionError(f"adaptive_level f_rows W={W} "
                                             f"N={N}: two launches differ")
                    del runs
                ms = time_cuda(lambda: kernels.adaptive_level(
                    x, nid, ghw, tables, lo, inv, n_prev, N, base, W, False,
                    layout), 20, flush)
                bound, by = adaptive_level_bound_ms(rows, F, N, W, rows)
                print(f"adaptive_level {layout} {rows}x{F} W={W} N={N}: "
                      f"{ms:.6g} ms (bound {bound:.6g} ms by {by}) max abs "
                      f"err f32 {err:.3g} bf16 {err16:.3g}", flush=True)
                del inp, x, nid, ghw
        check_adaptive_level(rows, 6, 16, 4, True, False, dev, 77, layout,
                             specials=True)
        r = check_adaptive_route(rows, F, 64, dev, 7, layout)
        ms = time_cuda(lambda: kernels.adaptive_route_only(*r, layout), 20,
                       flush)
        print(f"adaptive_route_only {layout} {rows}x{F} N=64: {ms:.6g} ms "
              f"(bound {route_bound_ms(rows, F, 4, layout)[0]:.6g} ms); "
              f"NaN/±inf/zero-span case bit-equal", flush=True)
    check_route_cases(dev, F)


def global_inputs(rows, F, B1, N, int_ghw, seed, dev, left_only=False):
    """Codes (uint8 below 256 bins, else int32) uniform over the real
    bins with 5% NA (the last bin), node ids and (g, h, w). About 10% of
    the rows lie outside [0, N); with ``left_only``, as at a sibling-
    subtraction level, half of them (the right children's rows)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, B1 - 1, (rows, F), generator=g, device=dev)
    na = torch.rand((rows, F), generator=g, device=dev) < 0.05
    dtype = torch.uint8 if B1 <= 256 else torch.int32
    codes = torch.where(na, B1 - 1, codes).to(dtype)
    if left_only:
        local = torch.randint(0, 2 * N, (rows,), generator=g, device=dev)
        seg = torch.where(local % 2 == 0, local // 2, -1)
    else:
        seg = torch.randint(0, N, (rows,), generator=g, device=dev)
        seg = torch.where(torch.rand(rows, generator=g, device=dev) < 0.1,
                          -1, seg)
    if int_ghw:
        gg = torch.randint(-8, 9, (rows,), generator=g, device=dev).float()
        hh = torch.randint(0, 4, (rows,), generator=g, device=dev).float()
    else:
        gg = torch.randn(rows, generator=g, device=dev)
        hh = torch.rand(rows, generator=g, device=dev) * 0.25
    ghw = torch.stack([gg, hh, torch.ones(rows, device=dev)]).contiguous()
    return codes, seg.to(torch.int32), ghw


def global_form(form):
    """The launch of one form of global_hist: "picked" (the training
    path's wrapper: the kernel picks from the shapes, node-grouped
    wherever a cell fits shared memory) or "global" (global atomics
    forced)."""
    from h2o3_tpu_torch.ops import kernels
    if form == "picked":
        return kernels.global_hist
    return lambda *a: kernels.global_hist_form(*a, False)


def check_global(rows, F, B1, N, int_ghw, bf16, dev, seed, left_only=False,
                 form="picked"):
    """global_hist against its plain version, in one form (global_form)."""
    import torch
    from h2o3_tpu_torch.ops.histogram import build_histograms_plain
    codes, seg, ghw = global_inputs(rows, F, B1, N, int_ghw, seed, dev,
                                    left_only)
    hk = global_form(form)(codes, seg, ghw, N, B1, bf16)
    hp = build_histograms_plain(codes, seg, ghw if int_ghw else ghw.double(),
                                N, B1, bf16)
    torch.cuda.synchronize()
    name = f"global_hist B1={B1} N={N} form={form}"
    err = float((hk.double() - hp.double()).abs().max())
    if int_ghw:
        if not torch.equal(hk, hp):
            raise AssertionError(f"{name} integer ghw: histogram not "
                                 f"bit-equal (max {err})")
    else:
        mass = build_histograms_plain(codes, seg, ghw.double().abs(), N, B1,
                                      bf16)
        mass_check(name, hk, hp, mass)
    return err, (codes, seg, ghw)


def phase_global_kernels(dev, rows=1_000_000, F=28):
    """Phase 3, global half: global_hist against its plain version at 1M
    rows, B1 in {15, 257, 1025}, N in {1, 8, 16, 32}, integer masses in
    both forms of the kernel (bit-equal), float masses within tolerance,
    timed with the L2 flushed in the picked (node-grouped) form and with
    global atomics forced."""
    from h2o3_tpu_torch.ops.histogram import build_histograms_plain
    import torch
    flush = torch_flush(dev)
    seed = 700
    for B1 in (15, 257, 1025):
        for N in (1, 8, 16, 32):
            seed += 1
            for form in ("picked", "global"):
                check_global(rows, F, B1, N, True, False, dev, seed,
                             form=form)
            err16, _ = check_global(rows, F, B1, N, False, True, dev,
                                    seed + 100)
            err, (codes, seg, ghw) = check_global(rows, F, B1, N, False,
                                                  False, dev, seed + 200)
            ms, ms_g = (time_cuda(lambda: global_form(form)(
                codes, seg, ghw, N, B1, False), 20, flush)
                for form in ("picked", "global"))
            pms = time_cuda(lambda: build_histograms_plain(
                codes, seg, ghw, N, B1, False), 3, flush)
            live = int(((seg >= 0) & (seg < N)).sum())
            bound, by = global_bound_ms(rows, F, codes.element_size(), N, B1,
                                        live)
            print(f"global_hist {rows}x{F} {str(codes.dtype)[6:]} B1={B1} "
                  f"N={N}: {ms:.6g} ms (global atomics forced {ms_g:.6g}; "
                  f"plain {pms:.6g} ms, bound {bound:.6g} ms by {by}) max "
                  f"abs err f32 {err:.3g} bf16 {err16:.3g}", flush=True)
            del codes, seg, ghw


def off_window(nid, seed):
    """5% of the rows moved outside every level's window."""
    import torch
    g = torch.Generator(device=nid.device).manual_seed(seed)
    out = torch.rand(nid.shape[0], generator=g, device=nid.device) < 0.05
    return torch.where(out, 1 << 20, nid).to(torch.int32).contiguous()


def i8_forms(layout, W):
    """The forms of an int8 level at lane width W, the forced ones first
    and the one the kernel picks last: in [rows, F] the tensor-core
    grouped body at W <= 32, the wide body at W >= 64, and the tiled
    body; [F, rows] has the tiled body alone."""
    if layout != "rows_f":
        return ("tiled", "picked")
    if W <= 32:
        return ("grouped", "tiled", "picked")
    return ("wide", "tiled", "picked")


def i8_level(kind, inp, qs, N, W, layout="rows_f", form="picked"):
    """One int8 level launch (kind "binned" or "adaptive") on the inputs
    of level_inputs / adaptive_inputs and ``qs`` = (q, scales), in one
    form: "picked" (the training path's wrapper: the kernel picks from the
    shapes), or one forced by name (kernels.LEVEL_FORMS)."""
    from h2o3_tpu_torch.ops import kernels
    if kind == "binned":
        codes, nid, _g, tables, n_prev, base = inp
        args = (codes, nid, *qs, tables, n_prev, N, base, W)
        if form == "picked":
            return kernels.binned_level_i8(*args)
        return kernels.binned_level_i8_form(*args, form)
    x, nid, _g, tables, lo, inv, n_prev, base = inp
    args = (x, nid, *qs, tables, lo, inv, n_prev, N, base, W, layout)
    if form == "picked":
        return kernels.adaptive_level_i8(*args)
    return kernels.adaptive_level_i8_form(*args, form)


def i8_plain(kind, inp, qs, N, W, layout="rows_f"):
    """The plain version of ``i8_level``."""
    from h2o3_tpu_torch.ops import hist_adaptive as H
    if kind == "binned":
        codes, nid, _g, tables, n_prev, base = inp
        return H.binned_level_i8_plain(codes, nid, *qs, tables, n_prev, N,
                                       base, W)
    x, nid, _g, tables, lo, inv, n_prev, base = inp
    return H.adaptive_level_i8_plain(x, nid, *qs, tables, lo, inv, n_prev,
                                     N, base, W, layout)


def i8_inputs(kind, rows, F, W, N, seed, dev, layout="rows_f"):
    """Float (g, h, w) level inputs with 5% of the rows off the window:
    packed codes with 5% NA, or raw features with 5% NaN."""
    if kind == "binned":
        inp = level_inputs(rows, F, W, N, False, seed, dev)
    else:
        inp = adaptive_inputs(rows, F, W, N, False, seed, dev, layout)
    return (inp[0], off_window(inp[1], seed)) + tuple(inp[2:])


def check_i8(kind, rows, F, W, N, terms, dev, seed, layout="rows_f",
             inp=None):
    """An int8 level against its plain version in each of its forms: nid
    and histogram bit-equal (integer sums, the same float32 flush)."""
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import quantize_ghw_i8
    if inp is None:
        inp = i8_inputs(kind, rows, F, W, N, seed, dev, layout)
    qs = quantize_ghw_i8(inp[2], terms)
    npl, hp = i8_plain(kind, inp, qs, N, W, layout)
    for form in i8_forms(layout, W):
        nk, hk = i8_level(kind, inp, qs, N, W, layout, form)
        torch.cuda.synchronize()
        name = f"{kind}_level_i8 {form} {layout} W={W} N={N} terms={terms}"
        if not torch.equal(nk, npl):
            raise AssertionError(f"{name}: nid differs in "
                                 f"{int((nk != npl).sum())} rows")
        if not torch.equal(hk, hp):
            err = float((hk.double() - hp.double()).abs().max())
            raise AssertionError(f"{name}: histogram not bit-equal (max "
                                 f"{err})")
        del nk, hk
    return inp, qs


I8_LEVELS = ((1, (1, 2, 4, 8, 16, 32)), (2, (1, 2, 4, 8, 16)))  # (terms, N)


def time_i8_forms(kind, inp, qs, N, W, reps, flush=None):
    """Median ms of each [rows, F] form of an int8 level on the same
    inputs."""
    return {form: time_cuda(lambda: i8_level(kind, inp, qs, N, W, "rows_f",
                                             form), reps, flush)
            for form in i8_forms("rows_f", W)}


I8_W = (16, 32, 64, 128, 256)


def phase_i8_kernels(dev, rows=1_000_000, F=28):
    """Phase 3, int8 levels: binned_level_i8 and adaptive_level_i8 (both
    layouts) at W in {16, 32, 64, 128, 256}, one term at N = 1..32, two at
    N = 1..16, with NA codes / NaN features and 5% of the rows off the
    window, in every form (``i8_forms``: the tensor-core grouped body
    below W = 64, the wide body from W = 64, the tiled body forced, and
    the one the kernel picks; [F, rows] has no grouped form): bit-equal
    to the plain version; the [rows, F] forms timed with the L2
    flushed."""
    flush = torch_flush(dev)
    seed, n = 1100, 0
    for W in I8_W:
        for terms, levels in I8_LEVELS:
            per = {"binned": {}, "adaptive": {}}
            for N in levels:
                seed += 1
                for kind in ("binned", "adaptive"):
                    inp, qs = check_i8(kind, rows, F, W, N, terms, dev,
                                       seed + (500 if kind == "adaptive"
                                               else 0))
                    per[kind][N] = time_i8_forms(kind, inp, qs, N, W, 20,
                                                 flush)
                    del inp, qs
                    n += len(i8_forms("rows_f", W))
                check_i8("adaptive", rows, F, W, N, terms, dev, seed + 500,
                         "f_rows")
                n += 2
            print(f"int8 levels {rows}x{F} W={W} terms={terms}, per level N "
                  f"and form (ms): {json.dumps(per)}", flush=True)
    print(f"int8 levels at {rows}x{F}: {n} (level, form) cases "
          f"(binned_level_i8, adaptive_level_i8 rows_f and f_rows; W "
          f"16/32/64/128/256; terms 1 at N 1..32, terms 2 at N 1..16; "
          f"every form and the picked one) bit-equal to the plain version",
          flush=True)


def totals_inputs(rows, F, n_prev, N, seed, dev):
    """Raw features (5% NaN), float (g, h, w), split tables of the
    previous level and nid in its window (in this level's when there is
    no route), 5% of the rows off every window."""
    import torch
    x, _n, ghw, tables, _lo, _inv, _p, _b = adaptive_inputs(
        rows, F, 16, 2 * max(n_prev, 1), False, seed, dev, "rows_f")
    g = torch.Generator(device=dev).manual_seed(seed)
    base = N - 1
    if n_prev:
        nid = base - n_prev + torch.randint(0, n_prev, (rows,), generator=g,
                                            device=dev)
    else:
        nid = base + torch.randint(0, N, (rows,), generator=g, device=dev)
    return x, off_window(nid, seed), ghw, tables, base


def check_totals(rows, F, n_prev, N, dev, seed):
    """leaf_totals against its plain version: nid bit-equal, each total
    within 1e-4 + 1e-5 x its absolute mass of the float64 plain
    version."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import leaf_totals_plain
    x, nid, ghw, tables, base = totals_inputs(rows, F, n_prev, N, seed, dev)
    nk, tk = kernels.leaf_totals(x, nid, ghw, tables, n_prev, N, base)
    npl, tp = leaf_totals_plain(x, nid, ghw.double(), tables, n_prev, N,
                                base)
    torch.cuda.synchronize()
    name = f"leaf_totals n_prev={n_prev} N={N}"
    if not torch.equal(nk, npl):
        raise AssertionError(f"{name}: nid differs in "
                             f"{int((nk != npl).sum())} rows")
    _n, mass = leaf_totals_plain(x, nid, ghw.double().abs(), tables, n_prev,
                                 N, base)
    mass_check(name, tk, tp, mass)
    return float((tk.double() - tp).abs().max()), (x, nid, ghw, tables, base)


def segment_inputs(rows, N, seed, dev, one_node=False):
    """nid over the N nodes of a level at base N - 1, 5% of the rows off
    it (``one_node``: every row in node N // 2), float (g, h, w)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    base = N - 1
    if one_node:
        nid = torch.full((rows,), base + N // 2, dtype=torch.int32,
                         device=dev)
    else:
        nid = off_window(base + torch.randint(0, N, (rows,), generator=g,
                                              device=dev), seed)
    ghw = torch.stack([torch.randn(rows, generator=g, device=dev),
                       torch.rand(rows, generator=g, device=dev) * 0.25,
                       torch.ones(rows, device=dev)]).contiguous()
    return nid, ghw, base


def check_segment(rows, N, dev, seed, form="picked", one_node=False):
    """segment_totals (the leaf-totals kernel without a route; its form
    picked or forced) against its plain version: within 1e-4 + 1e-5 x
    each node's absolute mass of the float64 plain version, and five
    launches with the same bits."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.common import segment_totals_plain
    nid, ghw, base = segment_inputs(rows, N, seed, dev, one_node)
    runs = [kernels.segment_totals_form(nid, ghw, N, base, form)
            for _ in range(5)]
    tp = segment_totals_plain(nid, ghw.double(), N, base)
    mass = segment_totals_plain(nid, ghw.double().abs(), N, base)
    torch.cuda.synchronize()
    name = f"segment_totals {form} rows={rows} N={N} one_node={one_node}"
    if not all(torch.equal(runs[0], r) for r in runs[1:]):
        raise AssertionError(f"{name}: five launches differ")
    mass_check(name, runs[0], tp, mass)
    return float((runs[0].double() - tp).abs().max()), (nid, ghw, base)


def phase_totals_kernel(dev, rows=1_000_000, F=28):
    """Phase 3, leaf_totals at n_prev in {0, 32}, N in {1, 64}, and its
    instance without a route, segment_totals, at N in {1, 64, 512,
    4096}; in both forms at row counts that are not a multiple of 4, and
    with every row in one node at N in {1, 64, 4096}."""
    errs = {}
    for n_prev in (0, 32):
        for N in (1, 64):
            errs[f"n_prev={n_prev} N={N}"] = check_totals(
                rows, F, n_prev, N, dev, 1200 + n_prev + N)[0]
    for N in (1, 64, 512, 4096):
        errs[f"segment N={N}"] = check_segment(rows, N, dev, 1250 + N)[0]
    for form in ("lanes", "match"):
        for extra in (1, 2, 3):
            errs[f"segment {form} rows={rows + extra} N=64"] = check_segment(
                rows + extra, 64, dev, 1260 + extra, form)[0]
        for N in (1, 64):
            errs[f"segment {form} N={N} one node"] = check_segment(
                rows + 1, N, dev, 1270 + N, form, one_node=True)[0]
    errs["segment N=4096 one node"] = check_segment(
        rows + 3, 4096, dev, 1280, one_node=True)[0]
    print(f"leaf_totals at {rows}x{F}: nid bit-equal, totals within "
          f"1e-4 + 1e-5 x mass of float64; segment_totals five launches "
          f"bit-equal; max abs err {json.dumps(errs)}", flush=True)


# ------------------------------------------------------- main path


def higgs_arrays(rows, seed=42):
    """The bench generator (bench.py _make_arrays): 28 HIGGS-shaped
    normal features and a logistic label."""
    rng = np.random.default_rng(seed)
    F = 28
    X = rng.normal(size=(rows, F)).astype(np.float32)
    logit = (X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
             + 0.3 * np.sin(3 * X[:, 4]))
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int32)
    return X, y, F


def frame_of(X, y, device):
    import h2o3_tpu_torch as h2o
    cols = {f"f{i}": X[:, i] for i in range(X.shape[1])}
    cols["label"] = y.astype(np.float32)
    return h2o.Frame.from_numpy(cols, device=device)


# ------------------------------------------------------------ CSV files

# the 22 carriers of the public airline on-time data, 2005-2007
CARRIERS = ("AA", "AQ", "AS", "B6", "CO", "DH", "DL", "EV", "F9", "FL", "HA",
            "HP", "MQ", "NW", "OH", "OO", "TZ", "UA", "US", "WN", "XE", "YV")
AIRLINES_NAMES = ("Month", "DayofMonth", "DayOfWeek", "DepTime",
                  "UniqueCarrier", "Origin", "Dest", "Distance",
                  "dep_delayed_15min")


def _table(labels):
    """A column's cell texts as a [k, width] uint8 matrix and lengths."""
    b = [lab.encode() for lab in labels]
    mat = np.zeros((len(b), max(len(x) for x in b)), np.uint8)
    for i, x in enumerate(b):
        mat[i, :len(x)] = np.frombuffer(x, np.uint8)
    return mat, np.array([len(x) for x in b], np.int64)


def _take(table, idx):
    return table[0][idx], table[1][idx]


def _sci9(x):
    """float32 values (finite) as nine-significant-digit e-notation
    cells, ``[-]d.dddddddde±XX``: a [rows, 15] uint8 matrix and lengths.
    Nine significant digits bring every float32 back exactly."""
    a = np.abs(x.astype(np.float64))
    nz = a > 0
    e = np.zeros(len(a), np.int64)
    e[nz] = np.floor(np.log10(a[nz])).astype(np.int64)
    m = np.rint(a / 10.0 ** (e - 8)).astype(np.int64)
    for fix, de in ((m >= 10 ** 9, 1), (nz & (m < 10 ** 8), -1)):
        e[fix] += de                      # log10 landed a decade off
        m[fix] = np.rint(a[fix] / 10.0 ** (e[fix] - 8)).astype(np.int64)
    body = np.empty((len(a), 14), np.uint8)
    for k in range(9):
        body[:, k + (k > 0)] = 48 + (m // 10 ** (8 - k)) % 10
    body[:, 1] = ord(".")
    body[:, 10] = ord("e")
    body[:, 11] = np.where(e < 0, ord("-"), ord("+"))
    body[:, 12] = 48 + np.abs(e) // 10
    body[:, 13] = 48 + np.abs(e) % 10
    neg = np.signbit(x)
    mat = np.zeros((len(a), 15), np.uint8)
    mat[neg, 0] = ord("-")
    mat[neg, 1:] = body[neg]
    mat[~neg, :14] = body[~neg]
    return mat, 14 + neg.astype(np.int64)


def _csv_block(cols, sep=b",") -> bytes:
    """CSV text of one block of rows: ``cols`` holds, per column, a
    [rows, width] uint8 matrix of the cells' bytes and the cells'
    lengths; cells are joined by ``sep`` (none where it is empty), each
    row ends in a newline (none where ``sep`` is empty: a record
    stream)."""
    seps = len(cols) if sep else 0
    row_len = sum(ln for _m, ln in cols) + seps
    pos = np.cumsum(row_len) - row_len
    out = np.empty(int(row_len.sum()), np.uint8)
    for j, (mat, ln) in enumerate(cols):
        short = int(ln.min())
        for k in range(mat.shape[1]):
            if k < short:
                out[pos + k] = mat[:, k]
            else:
                m = ln > k
                out[pos[m] + k] = mat[m, k]
        pos += ln
        if sep:
            out[pos] = ord("\n") if j == len(cols) - 1 else sep[0]
            pos += 1
    return out.tobytes()


def _write_csv(path, header, nrow, block_cols, block=1 << 18, sep=b",",
               head=None):
    """Write a CSV file by blocks of rows (``block_cols(lo, hi)`` gives a
    block's cells), to a file of its own first and then into place;
    ``head`` replaces the header line (ARFF's declarations)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(head if head is not None
                else (",".join(header) + "\n").encode())
        for lo in range(0, nrow, block):
            f.write(_csv_block(block_cols(lo, min(lo + block, nrow)), sep))
    os.replace(tmp, path)


def write_higgs_csv(path, X, y):
    """The HIGGS-shaped arrays as a CSV file: features f0..f{F-1} in
    nine-digit e-notation, the 0/1 label as an integer."""
    F = X.shape[1]
    digits = _table(["0", "1"])
    _write_csv(path, [f"f{i}" for i in range(F)] + ["label"], len(y),
               lambda lo, hi: [_sci9(X[lo:hi, i]) for i in range(F)]
               + [_take(digits, y[lo:hi])])


def airlines_columns(rows, seed=2024):
    """A synthetic table in the column layout of the public airline
    benchmark's train-10m.csv (szilard/benchm-ml), drawn from ``seed``:
    Month, DayofMonth and DayOfWeek as "c-N" strings, DepTime (hhmm) and
    Distance as integers, UniqueCarrier (22 levels), Origin and Dest
    (300 airport codes each, drawn with a skew), the label
    dep_delayed_15min as Y/N, depending on the hour, the month, the
    carrier, the airports and the distance. About 0.2% of DepTime and
    0.1% of UniqueCarrier are NA. Returns the columns as table indices
    (``tables``, ``idx``) and what a parse must find (``expect``)."""
    rng = np.random.default_rng(seed)
    codes = rng.choice(26 ** 3, size=300, replace=False)
    airports = ["".join(chr(65 + (c // 26 ** k) % 26) for k in (2, 1, 0))
                for c in codes]
    p_air = 1.0 / (np.arange(300) + 30.0)
    p_air /= p_air.sum()
    month = rng.integers(0, 12, rows)
    dom = rng.integers(0, 31, rows)
    dow = rng.integers(0, 7, rows)
    hour = np.clip(rng.normal(13.5, 4.5, rows), 0, 23).astype(np.int64)
    dep = hour * 100 + rng.integers(0, 60, rows)
    carrier = rng.integers(0, 22, rows)
    origin = rng.choice(300, size=rows, p=p_air)
    dest = rng.choice(300, size=rows, p=p_air)
    dist = np.clip(rng.lognormal(6.4, 0.6, rows), 30, 4962).astype(np.int64)
    dep_na = rng.random(rows) < 0.002
    car_na = rng.random(rows) < 0.001
    air_eff = rng.normal(0, 0.4, 300)
    car_eff = rng.normal(0, 0.3, 22)
    mon_eff = np.array([0.1, 0, -0.1, -0.2, -0.1, 0.3, 0.35, 0.2, -0.3,
                        -0.2, -0.1, 0.4])
    logit = (-1.7 + 0.1 * (np.where(dep_na, 13, hour) - 12)
             + mon_eff[month] + np.where(car_na, 0, car_eff[carrier])
             + air_eff[origin] + 0.5 * air_eff[dest]
             + 0.1 * (dow >= 4) + 0.05 * np.log(dist / 600))
    label = (rng.random(rows) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    tables = [_table([f"c-{i + 1}" for i in range(12)]),
              _table([f"c-{i + 1}" for i in range(31)]),
              _table([f"c-{i + 1}" for i in range(7)]),
              _table([str(i) for i in range(2400)] + ["NA"]),
              _table(list(CARRIERS) + ["NA"]), _table(airports),
              _table(airports), _table([str(i) for i in range(4963)]),
              _table(["N", "Y"])]
    idx = [month, dom, dow, np.where(dep_na, 2400, dep),
           np.where(car_na, 22, carrier), origin, dest, dist, label]
    expect = {"types": {n: ("int" if n in ("DepTime", "Distance")
                            else "enum") for n in AIRLINES_NAMES},
              "cards": {"Month": len(np.unique(month)),
                        "DayofMonth": len(np.unique(dom)),
                        "DayOfWeek": len(np.unique(dow)),
                        "UniqueCarrier": len(np.unique(carrier[~car_na])),
                        "Origin": len(np.unique(origin)),
                        "Dest": len(np.unique(dest)),
                        "dep_delayed_15min": len(np.unique(label))},
              "na": {n: 0 for n in AIRLINES_NAMES},
              "positives": int(label.sum())}
    expect["na"].update(DepTime=int(dep_na.sum()),
                        UniqueCarrier=int(car_na.sum()))
    return tables, idx, expect


def write_airlines_csv(path, tables, idx):
    _write_csv(path, AIRLINES_NAMES, len(idx[0]),
               lambda lo, hi: [_take(t, i[lo:hi])
                               for t, i in zip(tables, idx)])


def cached_csv(name, write):
    """A CSV file of the temporary directory, keyed by ``name`` (its
    parameters), written by ``write(path)`` unless it is there. Returns
    the path and the seconds the writing took (0 when cached)."""
    import tempfile
    path = os.path.join(tempfile.gettempdir(), f"h2o3_smoke_{name}.csv")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        write(path)
    return path, time.perf_counter() - t0


def csv_prefix(src, dst, rows):
    """The header and the first ``rows`` rows of ``src`` as a file."""
    with open(src, "rb") as f:
        head = f.read(64 * (rows + 1) + (1 << 20))
        nl = np.flatnonzero(np.frombuffer(head, np.uint8) == 10)
        if len(nl) <= rows:                 # longer rows: read on
            head += f.read()
            nl = np.flatnonzero(np.frombuffer(head, np.uint8) == 10)
    with open(dst, "wb") as f:
        f.write(head[:int(nl[rows]) + 1])


@contextlib.contextmanager
def hist_i8(terms):
    """``H2O3_HIST_I8`` set to ``terms`` (None: unset) for the trains
    inside, and restored after."""
    old = os.environ.pop("H2O3_HIST_I8", None)
    if terms:
        os.environ["H2O3_HIST_I8"] = str(terms)
    try:
        yield
    finally:
        os.environ.pop("H2O3_HIST_I8", None)
        if old is not None:
            os.environ["H2O3_HIST_I8"] = old


def train(fr, ntrees, path="packed", i8=None, **kw):
    """A GBM of ``path``'s parameters (and ``kw``) on ``path``'s response;
    ``H2O3_HIST_I8`` is ``i8`` or the path's own setting, for this train
    only."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    est = H2OGradientBoostingEstimator(
        ntrees=ntrees, distribution="bernoulli",
        **{"max_depth": 6, "learn_rate": 0.1, "seed": 7, "min_rows": 1.0,
           **PATHS[path]["params"], **kw})
    with hist_i8(i8 if i8 is not None else PATHS[path].get("i8")):
        est.train(y=PATHS[path].get("y", "label"), training_frame=fr)
    return est.model


def phase_main_path(card, path, fr=None, rows=10_000_000, ntrees=20,
                    depth=6, ref_auc=None, reset=True):
    """One GBM path at full width, launch counters set to 0 just before
    and read just after (``reset=False``: the caller set them to 0 before
    it made the frame); the frame is made here unless given. With
    ``ref_auc`` (the float path's AUC from this run) the AUC must lie
    within 0.005 of it."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    if fr is None:
        X, y, _F = higgs_arrays(rows)
        t0 = time.perf_counter()
        fr = frame_of(X, y, "cuda")
        torch.cuda.synchronize()
        log(f"frame {rows}x{fr.ncol} on cuda in "
            f"{time.perf_counter() - t0:.2f} s")
    F = fr.ncol - 1
    torch.cuda.reset_peak_memory_stats()
    if reset:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
    model = train(fr, ntrees, path)
    auc = model.training_metrics.auc
    pred = model.predict(fr)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    expected = {k: 0 for k in launches}
    expected[PATHS[path]["level"]] = depth * ntrees
    for one in ("route", "totals"):
        if PATHS[path].get(one):
            expected[PATHS[path][one]] = ntrees
    if launches != expected:
        raise AssertionError(f"{path} path launched {launches}, expected "
                             f"{expected}")
    if not np.isfinite(auc) or not 0.5 < auc <= 1.0:
        raise AssertionError(f"training AUC {auc} is not a finite "
                             f"better-than-chance value")
    if ref_auc is not None and abs(auc - ref_auc) > 0.005:
        raise AssertionError(f"{path}: AUC {auc} is more than 0.005 from "
                             f"the float path's {ref_auc}")
    p1 = pred.vec(pred.names[-1]).to_numpy()   # the positive class
    if p1.shape != (rows,) or not np.all(np.isfinite(p1)) \
            or p1.min() < 0 or p1.max() > 1:
        raise AssertionError("predict: p1 is not a finite probability per "
                             "row")
    loop_s = model.output["training_loop_seconds"]
    rps = rows * model.ntrees_built / loop_s
    i8 = f" H2O3_HIST_I8={PATHS[path]['i8']}" if "i8" in PATHS[path] else ""
    print(f"main path {path}: {rows}x{F} bernoulli GBM depth {depth} "
          f"{json.dumps(PATHS[path]['params'])}{i8} {ntrees} trees: AUC "
          f"{auc!r} "
          f"training_loop_seconds {loop_s!r} rows/s {rps!r} n_bins "
          f"{model.n_bins} packed_codes "
          f"{json.dumps(model.output['packed_codes'])} train_profile "
          f"{json.dumps(model.output['train_profile'])} launches "
          f"{launches} peak device memory in the train "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]",
          flush=True)
    return {"auc": auc, "loop_s": loop_s, "rows_per_s": rps,
            "launches": launches, "frame": fr, "trees": model.trees,
            "n_bins": model.n_bins, "model": model}


# the card-vs-CPU trains' depths: the CPU side's plain versions take
# most of those checks' time. Cut to make room for phase 8i within the
# 1200 s limit: the GBM checks of phases 8c and 8f and the airlines
# CSV's from depth 6 to 4, the multinomial's (8a) from 5 to 3, the
# forests' (8d, 8i) from 10 to 6. Phase 5's float and int8 checks keep
# depth 6, the only ones that reach the N = 32 level; the trains on the
# full frames keep their depths
CPU_DEPTH = 4
MULTI_CPU_DEPTH = 3
DRF_CPU_DEPTH = 6


def phase_card_vs_cpu(path, rows=200_000, ntrees=5, **kw):
    """A float path on the card and on the CPU at float32 histograms:
    every tree's splits (feature, split bin or threshold, NA side) must
    be equal, and |dAUC| <= 1e-4."""
    X, y, _F = higgs_arrays(rows, seed=11)
    card_vs_cpu(path, lambda dev: frame_of(X, y, dev), rows, ntrees, **kw)


def card_vs_cpu(path, frame, rows, ntrees, **kw):
    """``path`` trained at float32 histograms on ``frame("cuda")`` and on
    ``frame("cpu")``: every tree's splits must be equal, and |dAUC| <=
    1e-4."""
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = train(frame(dev), ntrees, path,
                            histogram_precision="float32", **kw)
    mc, mh = models["cuda"], models["cpu"]
    keys = ("feat", PATHS[path]["split_key"], "na_left")
    same = [all(np.array_equal(mc.trees[k][t], mh.trees[k][t])
                for k in keys) for t in range(ntrees)]
    if not all(same):
        t = same.index(False)
        raise AssertionError(
            f"{path}: {sum(same)} of {ntrees} trees' splits equal between "
            f"cuda and cpu, first differing: tree {t} "
            f"({split_flips(mc.trees, mh.trees)}): "
            + "; ".join(f"{k} {mc.trees[k][t]} vs {mh.trees[k][t]}"
                        for k in keys))
    d_auc = abs(mc.training_metrics.auc - mh.training_metrics.auc)
    if d_auc > 1e-4:
        raise AssertionError(f"{path}: |dAUC| cuda vs cpu = {d_auc}")
    print(f"card vs cpu, {path} {json.dumps(kw)}: {rows} rows, {ntrees} "
          f"trees, float32 histograms: {sum(same)} of "
          f"{ntrees} trees' splits identical "
          f"({split_flips(mc.trees, mh.trees)}), AUC cuda "
          f"{mc.training_metrics.auc!r} cpu {mh.training_metrics.auc!r} "
          f"|dAUC| {d_auc!r}", flush=True)


def frames_differ(a, b):
    """The columns of two frames that differ in name, type, domain or any
    bit of their device values (NaN payloads included)."""
    import torch
    if a.names != b.names:
        return [f"names {a.names} vs {b.names}"]
    out = []
    for n in a.names:
        va, vb = a.vec(n), b.vec(n)
        if not (va.type == vb.type and va.domain == vb.domain
                and va.data.dtype == vb.data.dtype
                and torch.equal(va.data.view(torch.int32),
                                vb.data.view(torch.int32))):
            out.append(f"{n} ({va.type} vs {vb.type})")
    return out


def timed_import(name, path, rows, write_s, card):
    """``import_file(path, device="cuda")``, timed, with the parse's
    profile printed: write and parse seconds, MB/s, rows/s, the
    host-to-device seconds and the host's core count."""
    import torch
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ingest import parse as parse_mod
    t0 = time.perf_counter()
    fr = h2o.import_file(path, device="cuda")
    torch.cuda.synchronize()
    parse_s = time.perf_counter() - t0
    prof = dict(parse_mod.LAST_PROFILE)
    mb = os.path.getsize(path) / 1e6
    if fr.nrow != rows or prof["fallback_ranges"]:
        raise AssertionError(f"csv {name}: {fr.nrow} rows (want {rows}), "
                             f"profile {prof}")
    print(f"csv {name}: {rows} rows, {fr.ncol} columns, {mb!r} MB; write "
          f"{write_s!r} s (0: cached); import_file {parse_s!r} s = "
          f"{mb / parse_s!r} MB/s, {rows / parse_s!r} rows/s, of it H2D "
          f"{prof['device_put_s']!r} s; {prof['chunks']} ranges on "
          f"{prof['workers']} threads, host cores {os.cpu_count()}; "
          f"profile {json.dumps(prof)} [{card}]", flush=True)
    return fr


@contextlib.contextmanager
def recorded_adaptive_calls(calls):
    """The adaptive grower's level and deepest-route calls, passed on and
    recorded into ``calls`` as (name, args) with every tensor but the
    feature matrix copied (the grower replaces nid and the tables level
    by level)."""
    import torch
    from h2o3_tpu_torch.models import tree
    names = ("adaptive_level", "adaptive_route_only")
    orig = {n: getattr(tree, n) for n in names}

    def recorder(name):
        def call(x, *a):
            calls.append((name, (x,) + tuple(
                t.clone() if torch.is_tensor(t) else t for t in a)))
            return orig[name](x, *a)
        return call
    for n in names:
        setattr(tree, n, recorder(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(tree, n, orig[n])


def check_train_levels(fr, path, card, flush):
    """K8 and K9 at the inputs a train of ``path`` on ``fr`` hands them:
    one tree trained with its calls recorded, then every level's
    adaptive_level (the form the training path picks, which must be the
    wide body) against adaptive_level_plain on the recorded inputs within
    the float tolerance (check_forms), and the deepest route against
    adaptive_route_only_plain bit for bit; each timed beside its plain
    version. Returns the kernels' ms for the tree."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_level_plain,
                                                  adaptive_route_only_plain)
    calls = []
    with recorded_adaptive_calls(calls):
        train(fr, 1, path)
    tree_ms = 0.0
    for name, a in calls:
        if name == "adaptive_level":
            (x, nid, ghw, tables, lo, inv, n_prev, N, base, W, bf16,
             layout, _qs) = a
            rows, F = x.shape
            pick = kernels.adaptive_level_picks(rows, F, W, n_prev, N,
                                                layout)
            if layout != "rows_f" or pick != "wide":
                raise AssertionError(f"{path}: level N={N} W={W} in "
                                     f"{layout} takes the {pick} form, "
                                     f"not the wide body in [rows, F]")
            inp = (x, nid, ghw, tables, lo, inv, n_prev, base)
            err = check_forms("adaptive", inp, N, W, bf16,
                              ("picked",))["picked"]
            ms = time_cuda(lambda: kernels.adaptive_level(
                x, nid, ghw, tables, lo, inv, n_prev, N, base, W, bf16,
                layout), 5, flush)
            pms = time_cuda(lambda: adaptive_level_plain(
                x, nid, ghw, tables, lo, inv, n_prev, N, base, W, bf16,
                layout), 3, flush)
            what = (f"adaptive_level {pick} W={W} N={N} bf16={bf16} "
                    f"max_abs_err {err!r}")
        else:
            x, nid, tables, n_prev, base, layout = a
            rk = kernels.adaptive_route_only(x, nid, tables, n_prev, base,
                                             layout)
            rp = adaptive_route_only_plain(x, nid, tables, n_prev, base,
                                           layout)
            if not torch.equal(rk, rp):
                raise AssertionError(f"{path}: adaptive_route_only differs "
                                     f"from its plain version in "
                                     f"{int((rk != rp).sum())} rows")
            del rk, rp
            ms = time_cuda(lambda: kernels.adaptive_route_only(
                x, nid, tables, n_prev, base, layout), 5, flush)
            pms = time_cuda(lambda: adaptive_route_only_plain(
                x, nid, tables, n_prev, base, layout), 3, flush)
            what = f"adaptive_route_only n_prev={n_prev} bit-equal"
        tree_ms += ms
        print(f"{path} train inputs [{x.shape[0]}, {x.shape[1]}]: {what}; "
              f"ms {ms!r} plain_ms {pms!r} [{card}]", flush=True)
    if [n for n, _a in calls].count("adaptive_level") != 6 \
            or calls[-1][0] != "adaptive_route_only":
        raise AssertionError(f"{path}: a tree made the calls "
                             f"{[n for n, _a in calls]}")
    print(f"{path}: the tree's 6 levels and route against their plain "
          f"versions on its own inputs; kernels {tree_ms!r} ms a tree "
          f"[{card}]", flush=True)
    return tree_ms


def phase_csv(card, higgs_rows=250_000, air_rows=10_000_000,
              cpu_rows=200_000):
    """The main path from a file: CSV -> ``import_file(device="cuda")``
    -> GBM -> AUC -> predict, the launch counters set to 0 before each
    import and read after its predict. The HIGGS shape at ``higgs_rows``
    (the 10M-row train already runs from ``from_numpy``): every column
    bit-equal to ``Frame.from_numpy`` of the same arrays, and the packed
    GBM's trees and AUC bit-equal to the same train from that frame. The
    airlines shape at ``air_rows``: types, domain sizes and NA counts as
    drawn, the default bernoulli GBM (depth 6, 20 trees) on adaptive bins
    at W = 256 (254 bins) with its launch counts, K8's wide body and K9
    held against their plain versions on a tree's own inputs
    (check_train_levels), two float32 trains bit for bit,
    its warm loop and profile, and card vs CPU on the file's first
    ``cpu_rows`` rows. Returns each path's launches, the airlines warm
    loop's seconds and its kernels' ms a tree."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ops import kernels
    t_phase = time.perf_counter()
    X, y, F = higgs_arrays(higgs_rows)
    path, write_s = cached_csv(f"higgs_{higgs_rows}_42",
                               lambda p: write_higgs_csv(p, X, y))
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    fr = timed_import("higgs", path, higgs_rows, write_s, card)
    higgs = phase_main_path(card, "higgs_csv", fr, rows=higgs_rows,
                            reset=False)
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = y
    ref_fr = h2o.Frame.from_numpy(cols, device="cuda")
    diffs = frames_differ(fr, ref_fr)
    ref = train(ref_fr, 20, "higgs_csv")
    trees = tree_diffs(higgs["trees"], ref.trees, "split_bin")
    print(f"csv higgs against from_numpy: columns that differ {diffs}; "
          f"tree entries that differ {json.dumps(trees)}; AUC "
          f"{higgs['auc']!r} vs {ref.training_metrics.auc!r}", flush=True)
    if diffs or any(trees.values()) or higgs["auc"] !=             ref.training_metrics.auc:
        raise AssertionError("csv higgs: the CSV frame or its train differs "
                             "from the from_numpy one")
    del fr, ref_fr, ref, cols, X, y, higgs["frame"]
    tables, idx, expect = airlines_columns(air_rows)
    path, write_s = cached_csv(
        f"airlines_{air_rows}_2024",
        lambda p: write_airlines_csv(p, tables, idx))
    del tables, idx
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    fr = timed_import("airlines", path, air_rows, write_s, card)
    got = {"types": fr.types,
           "cards": {n: fr.vec(n).cardinality for n in expect["cards"]},
           "na": {n: fr.vec(n).na_count() for n in fr.names},
           "positives": int((fr.vec("dep_delayed_15min").data == 1).sum())}
    if any(got[k] != expect[k] for k in expect):
        raise AssertionError(f"csv airlines: parsed {got}, drawn {expect}")
    air = phase_main_path(card, "airlines_csv", fr, rows=air_rows,
                          reset=False)
    if air["n_bins"] != 254:
        raise AssertionError(f"airlines_csv: n_bins {air['n_bins']}, not "
                             f"the 254 identity bins of the enum columns "
                             f"(W = 256)")
    level_ms = check_train_levels(fr, "airlines_csv", card,
                                  torch_flush("cuda"))
    runs = [train(fr, 20, "airlines_csv", histogram_precision="float32")
            for _ in range(2)]
    check_repeats(runs, "airlines_csv", "float32 x2")
    del runs
    warm_s = phase_warm_profile(fr, card, "airlines_csv", air["trees"])
    # rows of the frame for the serve phase (phase_serve)
    air_sample = fr.rows(np.sort(np.random.default_rng(SERVE_SEED).choice(
        fr.nrow, SERVE_ROWS, replace=False)))
    del fr, air["frame"]
    small = path[:-len(".csv")] + f"_head{cpu_rows}.csv"
    csv_prefix(path, small, cpu_rows)
    card_vs_cpu("airlines_csv",
                lambda dev: h2o.import_file(small, device=dev), cpu_rows, 5,
                max_depth=CPU_DEPTH)
    print(f"csv phase: {time.perf_counter() - t_phase!r} s wall, parsed "
          f"{json.dumps(got['cards'])} levels, NA {json.dumps(got['na'])}",
          flush=True)
    return {"higgs_csv": higgs["launches"], "airlines_csv": air["launches"],
            "airlines_warm_s": warm_s, "airlines_kernel_ms_tree": level_ms,
            "airlines_train": {"trees": air["trees"], "auc": air["auc"]},
            "airlines_model": air["model"], "airlines_sample": air_sample}


# ------------------------------------------------------------ ingest (B1-B5)

def _labels(table):
    mat, ln = table
    return [bytes(mat[i, :ln[i]]).decode() for i in range(len(ln))]


def _zz(n: int) -> bytes:
    """Avro's zigzag varint of ``n``."""
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        out.append(b | 0x80 if u else b)
        if not u:
            return bytes(out)


NUMERIC_AIRLINES = ("DepTime", "Distance")


def write_airlines_arff(path, tables, idx, declare=None):
    """The airlines columns as ARFF: nominal attributes declared in the
    table's order (or ``declare``'s levels, by column), DepTime and
    Distance numeric, ``?`` for NA."""
    head = ["@RELATION airlines"]
    arff_tables = []
    for n, t in zip(AIRLINES_NAMES, tables):
        labs = ["?" if lab == "NA" else lab for lab in _labels(t)]
        arff_tables.append(_table(labs))
        if n in NUMERIC_AIRLINES:
            head.append(f"@ATTRIBUTE {n} NUMERIC")
        else:
            levels = (declare or {}).get(n) or [x for x in labs if x != "?"]
            head.append(f"@ATTRIBUTE {n} {{{','.join(levels)}}}")
    head.append("@DATA\n")
    _write_csv(path, None, len(idx[0]),
               lambda lo, hi: [_take(t, i[lo:hi])
                               for t, i in zip(arff_tables, idx)],
               head="\n".join(head).encode())


def write_airlines_avro(path, tables, idx, codec, block_rows=1 << 16):
    """The airlines columns as an Avro object container file of records
    of nullable strings (DepTime and Distance: nullable longs), ``codec``
    null or deflate, ``block_rows`` records a block."""
    import zlib
    fields, enc = [], []
    for n, t in zip(AIRLINES_NAMES, tables):
        num = n in NUMERIC_AIRLINES
        fields.append({"name": n, "type": ["null", "long" if num
                                           else "string"]})
        cells = [b"\x00" if lab == "NA" else b"\x02" + (
            _zz(int(lab)) if num else _zz(len(lab)) + lab.encode())
            for lab in _labels(t)]
        mat = np.zeros((len(cells), max(map(len, cells))), np.uint8)
        for k, c in enumerate(cells):
            mat[k, :len(c)] = np.frombuffer(c, np.uint8)
        enc.append((mat, np.array([len(c) for c in cells], np.int64)))
    schema = {"type": "record", "name": "airlines", "fields": fields}
    meta = {b"avro.schema": json.dumps(schema).encode(),
            b"avro.codec": codec.encode()}
    sync = b"h2o3_smoke_sync!"
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"Obj\x01" + _zz(len(meta)))
        for k, v in meta.items():
            f.write(_zz(len(k)) + k + _zz(len(v)) + v)
        f.write(_zz(0) + sync)
        nrow = len(idx[0])
        for lo in range(0, nrow, block_rows):
            hi = min(lo + block_rows, nrow)
            payload = _csv_block([_take(e, i[lo:hi])
                                  for e, i in zip(enc, idx)], sep=b"")
            if codec == "deflate":
                co = zlib.compressobj(6, zlib.DEFLATED, -15)
                payload = co.compress(payload) + co.flush()
            f.write(_zz(hi - lo) + _zz(len(payload)) + payload + sync)
    os.replace(tmp, path)


def write_airlines_xlsx(path, tables, idx):
    """The airlines columns as an xlsx workbook: the names in the first
    row, labels as shared strings, DepTime and Distance as numbers, an NA
    cell left out."""
    import zipfile
    labels = [_labels(t) for t in tables]
    shared, sidx = [], {}
    for n, labs in zip(AIRLINES_NAMES, labels):
        for lab in [n] + ([] if n in NUMERIC_AIRLINES else labs):
            if lab != "NA" and lab not in sidx:
                sidx[lab] = len(shared)
                shared.append(lab)
    letters = "ABCDEFGHI"
    cell = []
    for n, labs in zip(AIRLINES_NAMES, labels):
        if n in NUMERIC_AIRLINES:
            cell.append(["" if lab == "NA" else f"<v>{lab}</v></c>"
                         for lab in labs])
        else:
            cell.append(["" if lab == "NA" else f'<v>{sidx[lab]}</v></c>'
                         for lab in labs])
    rows = ['<row r="1">' + "".join(
        f'<c r="{letters[j]}1" t="s"><v>{sidx[n]}</v></c>'
        for j, n in enumerate(AIRLINES_NAMES)) + "</row>"]
    for r in range(len(idx[0])):
        parts = [f'<row r="{r + 2}">']
        for j, n in enumerate(AIRLINES_NAMES):
            body = cell[j][idx[j][r]]
            if body:
                t = "" if n in NUMERIC_AIRLINES else ' t="s"'
                parts.append(f'<c r="{letters[j]}{r + 2}"{t}>{body}')
        parts.append("</row>")
        rows.append("".join(parts))
    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    sheet = (f'<?xml version="1.0"?><worksheet xmlns="{ns}"><sheetData>'
             + "\n".join(rows) + "</sheetData></worksheet>")
    sst = (f'<?xml version="1.0"?><sst xmlns="{ns}">' + "".join(
        f"<si><t>{s}</t></si>" for s in shared) + "</sst>")
    tmp = f"{path}.{os.getpid()}.tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("xl/worksheets/sheet1.xml", sheet)
        z.writestr("xl/sharedStrings.xml", sst)
        z.writestr("[Content_Types].xml", "<Types/>")
    os.replace(tmp, path)


def svmlight_from_csv(src, dst, F):
    """The HIGGS CSV file (features f0..f{F-1}, then the label) as
    SVMLight: the label, then ``j:value`` for every feature (1-based; no
    value is exactly 0, so none is left out), the cells' texts kept."""
    pre = [f"{j + 1}:".encode() for j in range(F)]
    with open(src, "rb") as f:
        lines = f.read().split(b"\n")[1:]
    out = [c[-1] + b" " + b" ".join(map(bytes.__add__, pre, c[:-1]))
           for c in (ln.split(b",") for ln in lines if ln)]
    with open(dst + ".tmp", "wb") as f:
        f.write(b"\n".join(out) + b"\n")
    os.replace(dst + ".tmp", dst)


def split_lines(src, dst_a, dst_b, n_a, n):
    """The first ``n_a`` of the first ``n`` lines of ``src`` into
    ``dst_a``, the rest of them into ``dst_b``."""
    with open(src, "rb") as f:
        data = f.read()
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    cut, end = nl[n_a - 1] + 1, nl[n - 1] + 1
    for dst, body in ((dst_a, data[:cut]), (dst_b, data[cut:end])):
        with open(dst + ".tmp", "wb") as f:
            f.write(body)
        os.replace(dst + ".tmp", dst)


def smoke_path(name):
    """A file of the temporary directory, named by ``name``."""
    import tempfile
    return os.path.join(tempfile.gettempdir(), f"h2o3_smoke_{name}")


def cached_file(name, write):
    """``cached_csv`` for a file of any extension (``name`` carries it)."""
    path = smoke_path(name)
    t0 = time.perf_counter()
    if not os.path.exists(path):
        write(path)
    return path, time.perf_counter() - t0


def values_differ(fr, ref, names=None):
    """Columns of ``fr`` (named ``names``, by default as in ``ref``) whose
    values differ from ``ref``'s: an enum's labels row by row, NA where
    NA; a number's float32 value, NaN where NaN. A format may type a
    column real where the CSV parse says int, and order a domain as
    declared: only the values are held."""
    import torch
    out = []
    for n, rn in zip(names or ref.names, ref.names):
        a, b = fr.vec(n), ref.vec(rn)
        if b.type == "enum":
            if a.type != "enum":
                out.append(f"{n}: {a.type}, not enum")
                continue
            pos = {lab: k for k, lab in enumerate(b.domain)}
            lut = torch.tensor([pos.get(lab, -2) for lab in a.domain]
                               + [-1], device=a.data.device)
            ca = a.data.long()
            mapped = lut[torch.where(ca < 0, len(a.domain), ca)]
            if not torch.equal(mapped, b.data.long()):
                out.append(f"{n}: {int((mapped != b.data.long()).sum())} "
                           f"labels differ")
            continue
        x, z = a.as_float(), b.as_float()
        nx, nz = torch.isnan(x), torch.isnan(z)
        if not (torch.equal(nx, nz) and torch.equal(x[~nx], z[~nz])):
            out.append(f"{n}: values differ")
    return out


def na_counts(fr):
    return {n: fr.vec(n).na_count() for n in fr.names}


def timed(fn):
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ingest_profile_line(prof):
    keys = ("tokenize_encode_s", "merge_s", "device_put_s",
            "h2d_overlap_ratio", "add_seconds", "assemble_seconds",
            "h2d_bytes", "ring_allocs", "fallback_cols", "chunks",
            "decompress_s", "degrade_reasons")
    return json.dumps({k: prof.get(k) for k in keys})


def ingest_compressed(card, csv_path, air_rows, ref, ref_train,
                      member_bytes=1 << 20):
    """The 10M-row airlines file as a 1 MiB-member gzip and a store-mode
    zstd: each import bit-equal to the CSV import in every column, type,
    domain and NA count, and the default GBM on it bit-equal to the CSV
    frame's in trees and AUC, with K8 (wide adaptive level) 120 and K9
    20 launches. Returns the launches of each and the files."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ingest import compress
    from h2o3_tpu_torch.ingest import parse as parse_mod
    from h2o3_tpu_torch.ops import kernels
    plain_mb = os.path.getsize(csv_path) / 1e6
    ref_na = na_counts(ref)
    out, paths = {}, {}
    writers = {
        "gzip": (".csv.gz", lambda d: compress.gzip_compress_members(
            d, member_bytes, workers=os.cpu_count() or 4)),
        "zstd": (".csv.zst", lambda d: compress.zstd_compress_store(
            d, member_bytes))}
    for kind, (ext, enc) in writers.items():
        def write(p):
            with open(csv_path, "rb") as f:
                blob = enc(f.read())
            with open(p + ".tmp", "wb") as f:
                f.write(blob)
            os.replace(p + ".tmp", p)
        path, write_s = cached_file(
            f"airlines_{air_rows}_2024_{member_bytes}{ext}", write)
        paths[kind] = path
        comp_mb = os.path.getsize(path) / 1e6
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        fr, s = timed(lambda: h2o.import_file(path, device="cuda"))
        prof = dict(parse_mod.LAST_PROFILE)
        (info,) = prof["compressed"]
        diffs = frames_differ(fr, ref)
        na = na_counts(fr)
        print(f"ingest {kind}: {air_rows} rows, {comp_mb!r} MB compressed "
              f"({info['members']} members, parallel {info['parallel']}, "
              f"ratio {info['ratio']!r}), {plain_mb!r} MB plain; write "
              f"{write_s!r} s (0: cached); import_file {s!r} s, of it "
              f"decompress {prof['decompress_s']!r} s; "
              f"{comp_mb / s!r} MB/s compressed, {plain_mb / s!r} MB/s "
              f"plain, {air_rows / s!r} rows/s; profile "
              f"{ingest_profile_line(prof)}; columns that differ from the "
              f"CSV import {diffs} [{card}]", flush=True)
        if diffs or na != ref_na or fr.types != ref.types \
                or not info["parallel"] or prof["fallback_ranges"]:
            raise AssertionError(f"ingest {kind}: the frame differs from "
                                 f"the CSV import ({diffs}; NA {na} vs "
                                 f"{ref_na}) or the inflate was serial "
                                 f"({info})")
        res = phase_main_path(card, f"airlines_{kind}", fr, rows=air_rows,
                              reset=False)
        trees = tree_diffs(res["trees"], ref_train["trees"], "thr")
        print(f"ingest {kind}: GBM against the CSV frame's: tree entries "
              f"that differ {json.dumps(trees)}; AUC {res['auc']!r} vs "
              f"{ref_train['auc']!r}; launches {res['launches']} "
              f"[{card}]", flush=True)
        if any(trees.values()) or res["auc"] != ref_train["auc"] \
                or res["launches"]["adaptive_level"] != 120 \
                or res["launches"]["adaptive_route_only"] != 20:
            raise AssertionError(f"ingest {kind}: the GBM differs from the "
                                 f"CSV frame's")
        out[f"airlines_{kind}"] = res["launches"]
        del fr, res
    return out, paths


def ingest_stream_on_off(card, csv_path, air_rows, bound_s=0.36):
    """The 10M-row CSV with ``H2O3_INGEST_STREAM`` 0 and 1, twice each,
    alternating: every frame bit-equal, each run's profile printed, and
    the saving against the bound of what streaming can hide."""
    import torch
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ingest import parse as parse_mod
    old = os.environ.get("H2O3_INGEST_STREAM")
    runs = {"0": [], "1": []}
    first = None
    try:
        for mode in ("0", "1", "0", "1"):
            os.environ["H2O3_INGEST_STREAM"] = mode
            fr, s = timed(lambda: h2o.import_file(csv_path, device="cuda"))
            prof = dict(parse_mod.LAST_PROFILE)
            if prof["streamed"] != (mode == "1") or prof["fallback_cols"]:
                raise AssertionError(f"stream {mode}: profile {prof}")
            diffs = [] if first is None else frames_differ(fr, first)
            print(f"ingest stream={mode}: import_file {s!r} s; profile "
                  f"{ingest_profile_line(prof)}; columns that differ from "
                  f"the first import {diffs} [{card}]", flush=True)
            if diffs:
                raise AssertionError(f"stream {mode}: the frame differs")
            first = first if first is not None else fr
            runs[mode].append(s)
            del fr
            torch.cuda.synchronize()
    finally:
        os.environ.pop("H2O3_INGEST_STREAM", None)
        if old is not None:
            os.environ["H2O3_INGEST_STREAM"] = old
    off, on = min(runs["0"]), min(runs["1"])
    print(f"ingest stream saving: off {runs['0']} s, on {runs['1']} s; "
          f"best off - best on = {off - on!r} s against the bound of about "
          f"{bound_s} s (the H2D and most of the numeric merge) "
          f"[{card}]", flush=True)
    return {"off_s": runs["0"], "on_s": runs["1"]}


def write_fallback_csv(path, rows):
    """id, a unique label a row (``u``), labels whose union is 160k
    (``v``), wide ints past 2^53 (``w``) and a real column."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=rows)
    with open(path + ".tmp", "w") as f:
        f.write("id,u,v,w,x\n")
        for lo in range(0, rows, 1 << 17):
            hi = min(lo + (1 << 17), rows)
            f.write("".join(
                f"{k},u{k},v{(k // 2) % 160_000},{(1 << 53) + 2 * k},"
                f"{x[k]:.6f}\n" for k in range(lo, hi)))
    os.replace(path + ".tmp", path)


def ingest_fallback_columns(card, rows=1_000_000):
    """A CSV whose ``u`` blows the chunk-local enum cap, ``v`` the union
    cap (the cap lowered to a tenth of the rows for the two imports) and
    ``w`` holds wide ints: the streamed import hands those three to the
    host merge and equals the unstreamed one bit for bit."""
    card_cap = rows // 10
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ingest import chunk as chunk_mod
    from h2o3_tpu_torch.ingest import parse as parse_mod
    path, write_s = cached_csv(f"fallback_{rows}",
                               lambda p: write_fallback_csv(p, rows))
    old_cap = chunk_mod.MAX_ENUM_CARDINALITY
    old_env = os.environ.get("H2O3_INGEST_STREAM")
    frames = {}
    try:
        chunk_mod.MAX_ENUM_CARDINALITY = card_cap
        for mode in ("0", "1"):
            os.environ["H2O3_INGEST_STREAM"] = mode
            frames[mode], s = timed(lambda: h2o.import_file(
                path, device="cuda"))
            prof = dict(parse_mod.LAST_PROFILE)
            print(f"ingest fallback columns, stream={mode}: {rows} rows, "
                  f"write {write_s!r} s; import_file {s!r} s; types "
                  f"{frames[mode].types}; profile "
                  f"{ingest_profile_line(prof)} [{card}]", flush=True)
        fb = prof["fallback_cols"]
    finally:
        chunk_mod.MAX_ENUM_CARDINALITY = old_cap
        os.environ.pop("H2O3_INGEST_STREAM", None)
        if old_env is not None:
            os.environ["H2O3_INGEST_STREAM"] = old_env
    a, b = frames["0"], frames["1"]
    diffs = [n for n in a.names if a.vec(n).type != "string"
             and frames_differ(a[[n]], b[[n]])]
    host = [n for n in a.names if not _same_host(a.vec(n), b.vec(n))]
    print(f"ingest fallback columns: host merge took {fb}; device columns "
          f"that differ {diffs}, host copies that differ {host} "
          f"[{card}]", flush=True)
    if fb != ["u", "v", "w"] or diffs or host or a.types != {
            "id": "int", "u": "string", "v": "string", "w": "int",
            "x": "real"}:
        raise AssertionError("ingest fallback columns: streamed and "
                             "unstreamed imports differ")


def _same_host(va, vb):
    if va.host_data is None or vb.host_data is None:
        return va.host_data is None and vb.host_data is None
    x, y = va.host_data, vb.host_data
    if x.dtype == object:
        return x.shape == y.shape and bool((x == y).all())
    return x.dtype == y.dtype and np.array_equal(x.view(np.uint8),
                                                 y.view(np.uint8))


def ingest_formats(card, rows=1_000_000, xlsx_rows=100_000,
                   higgs_rows=1_000_000):
    """ARFF, Avro (null, deflate), Parquet and ORC (where pyarrow is
    installed) of ``rows`` airlines-shaped rows, xlsx of ``xlsx_rows``
    and SVMLight of the HIGGS arrays at ``higgs_rows``, each held to the
    CSV import of the same rows; then each as a two-file list of a fifth
    as many rows (``_rbind``), half from the first 11 carriers and half
    from the rest, so that the files' carrier domains differ, held to
    the CSV import of those rows. Returns each import's rows/s."""
    import h2o3_tpu_torch as h2o
    tables, idx, _expect = airlines_columns(rows, seed=77)
    car = idx[4]
    in_b = (car >= 11) & (car != 22)             # B: the last 11 carriers
    perm = np.concatenate([np.flatnonzero(~in_b), np.flatnonzero(in_b)])
    idx = [i[perm] for i in idx]
    n_a = int((~in_b).sum())
    k = rows // 10
    car_labels = _labels(tables[4])
    part = {"": idx, "a": [i[:k] for i in idx],
            "b": [i[n_a:n_a + k] for i in idx]}
    declare = {h: {"UniqueCarrier": [car_labels[c] for c in sorted(
        set(part[h][4].tolist()) - {22})][::-1 if h == "b" else 1]}
        for h in "ab"}
    out = {}

    def check(fmt, files, refs, names=None):
        for what, fl, (ref_path, n) in (
                ("one file", files[:1], refs[0]),
                ("two files", files[1:], refs[1])):
            fr, s = timed(lambda: h2o.import_file(
                fl if len(fl) > 1 else fl[0], device="cuda"))
            diffs = values_differ(fr, h2o.import_file(ref_path,
                                                      device="cuda"), names)
            mb = sum(os.path.getsize(p) for p in fl) / 1e6
            print(f"ingest {fmt}, {what}: {n} rows, {fr.ncol} columns, "
                  f"{mb!r} MB; import_file {s!r} s = {n / s!r} rows/s, "
                  f"{mb / s!r} MB/s; columns that differ from the CSV "
                  f"import {diffs}; domains "
                  f"{json.dumps({c: fr.vec(c).cardinality for c in fr.names})}"
                  f" [{card}]", flush=True)
            if diffs or fr.nrow != n:
                raise AssertionError(f"ingest {fmt} ({what}): {diffs}")
            out[f"{fmt} {what}"] = n / s
            del fr

    csv_one, _ = cached_csv(f"airlines_fmt_{rows}_77", lambda p:
                            write_airlines_csv(p, tables, idx))
    lst = [np.concatenate([a, b]) for a, b in zip(part["a"], part["b"])]
    csv_list, _ = cached_csv(f"airlines_fmt_{rows}_77_list", lambda p:
                             write_airlines_csv(p, tables, lst))
    refs = ((csv_one, rows), (csv_list, 2 * k))
    for fmt, ext, write in (
            ("arff", "arff", lambda p, h: write_airlines_arff(
                p, tables, part[h], declare.get(h))),
            ("avro null", "avro", lambda p, h: write_airlines_avro(
                p, tables, part[h], "null")),
            ("avro deflate", "avro", lambda p, h: write_airlines_avro(
                p, tables, part[h], "deflate"))):
        tag = fmt.replace(" ", "_")
        files = [cached_file(f"airlines_fmt_{rows}_{tag}{h}.{ext}",
                             lambda p, h=h: write(p, h))[0]
                 for h in ("", "a", "b")]
        check(fmt, files, refs)
    # xlsx: half of the rows from each carrier group
    half, kx = xlsx_rows // 2, xlsx_rows // 10
    xi = [np.concatenate([i[:half], i[n_a:n_a + half]]) for i in idx]
    xparts = (("all", xi), ("a", [i[:kx] for i in xi]),
              ("b", [i[half:half + kx] for i in xi]))
    files = [cached_file(f"airlines_fmt_{xlsx_rows}_{h}.xlsx",
                         lambda p, ix=ix: write_airlines_xlsx(
                             p, tables, ix))[0] for h, ix in xparts]
    xrefs = [cached_csv(f"airlines_fmt_{xlsx_rows}_77_{h}_xlsx",
                        lambda p, ix=ix: write_airlines_csv(p, tables, ix))[0]
             for h, ix in (("all", xi), ("list", [np.concatenate(
                 [a, b]) for a, b in zip(xparts[1][1], xparts[2][1])]))]
    check("xlsx", files, ((xrefs[0], xlsx_rows), (xrefs[1], 2 * kx)))
    F, kh = 28, higgs_rows // 10
    higgs_path, _ = cached_csv(
        f"higgs_{higgs_rows}_42",
        lambda p: write_higgs_csv(p, *higgs_arrays(higgs_rows)[:2]))
    svm, _ = cached_file(f"higgs_{higgs_rows}_42.svm",
                         lambda p: svmlight_from_csv(higgs_path, p, F))
    svm_list = [smoke_path(f"higgs_{higgs_rows}_42_{h}.svm") for h in "ab"]
    higgs_list = smoke_path(f"higgs_{higgs_rows}_42_head{2 * kh}.csv")
    if not all(os.path.exists(p) for p in svm_list + [higgs_list]):
        split_lines(svm, *svm_list, kh, 2 * kh)
        csv_prefix(higgs_path, higgs_list, 2 * kh)
    check("svmlight", [svm] + svm_list,
          ((higgs_path, higgs_rows), (higgs_list, 2 * kh)),
          names=[f"C{j + 2}" for j in range(F)] + ["C1"])
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        print("ingest parquet, orc: not run, pyarrow is not installed on "
              "this machine (import_file of such a file raises here; the "
              "CPU tests hold both formats to the JAX package)", flush=True)
        return out
    import pyarrow as pa
    import pyarrow.orc as po
    import pyarrow.parquet as pq
    cols = {}
    for n, t, i in zip(AIRLINES_NAMES, tables, idx):
        labs = np.asarray(_labels(t), dtype=object)
        if n in NUMERIC_AIRLINES:
            cols[n] = np.array([np.nan if lab == "NA" else float(lab)
                                for lab in labs])[i]
        else:
            cols[n] = pa.array(np.where(labs == "NA", None, labs)[i]
                               ).dictionary_encode()
    table = pa.table(cols)
    for fmt, save in (("parquet", pq.write_table), ("orc", po.write_table)):
        def tbl(lo, n, fmt=fmt):
            t = table.slice(lo, n)
            if fmt == "orc":            # ORC has no dictionary type
                t = pa.table({c: (t.column(c).cast(pa.string())
                                  if pa.types.is_dictionary(t.column(c).type)
                                  else t.column(c)) for c in t.column_names})
            return t
        files = [cached_file(f"airlines_fmt_{rows}{h}.{fmt}",
                             lambda p, lo=lo, n=n: save(tbl(lo, n), p))[0]
                 for h, lo, n in (("", 0, rows), ("_a", 0, k),
                                  ("_b", n_a, k))]
        check(fmt, files, refs)
    return out


def ingest_remote(card, gz_path, ref):
    """The gzip file by ``file://`` and by an ``http://`` URL served from
    a thread on 127.0.0.1: both bit-equal to the local import."""
    import functools
    import http.server
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ingest import persist_uri
    root, name = os.path.split(gz_path)

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=root))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/{name}"
    try:
        for uri in (url, f"file://{gz_path}"):
            fr, s = timed(lambda: h2o.import_file(uri, device="cuda"))
            diffs = frames_differ(fr, ref)
            print(f"ingest {uri.split(':')[0]}: {fr.nrow} rows, "
                  f"import_file {s!r} s (download included); columns "
                  f"that differ from the local import {diffs} [{card}]",
                  flush=True)
            if diffs:
                raise AssertionError(f"ingest {uri}: the frame differs")
            del fr
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()
        # The served port is random, so the cached download is never
        # read again: leave no copy of it behind.
        cached = persist_uri._cache_path(url)
        if os.path.exists(cached):
            os.unlink(cached)


def ingest_sql(card, rows=1_000_000):
    """An sqlite3 table of airlines-shaped rows (an integer key, TEXT
    labels, INTEGER DepTime and Distance, NULL for NA) through
    ``import_sql_table`` in key-range mode and without a key (one
    fetch): both held to the source arrays. Two key ranges (three fetch
    threads with the NULL keys'): sqlite3 gives up the GIL around every
    row it steps, so fetch threads of an in-process database queue on
    it (1M rows on the H100's 8-core host: 193 s at eight ranges against
    7.6 s in one fetch; 16-24 s at two against 10-13 s in one fetch)."""
    import sqlite3
    import tempfile
    import torch
    import h2o3_tpu_torch as h2o
    tables, idx, _e = airlines_columns(rows, seed=31)
    labels = [_labels(t) for t in tables]
    src = []
    for n, labs, i in zip(AIRLINES_NAMES, labels, idx):
        vals = [None if lab == "NA" else (int(lab) if n in NUMERIC_AIRLINES
                                          else lab) for lab in labs]
        src.append([vals[k] for k in i.tolist()])
    db = os.path.join(tempfile.gettempdir(),
                      f"h2o3_smoke_airlines_{rows}_{os.getpid()}.db")
    t0 = time.perf_counter()
    con = sqlite3.connect(db)
    cols = ", ".join(f"{n} {'INTEGER' if n in NUMERIC_AIRLINES else 'TEXT'}"
                     for n in AIRLINES_NAMES)
    con.execute(f"CREATE TABLE air (id INTEGER, {cols})")
    con.executemany(f"INSERT INTO air VALUES (?{', ?' * len(src)})",
                    zip(range(rows), *src))
    con.commit()
    con.close()
    write_s = time.perf_counter() - t0
    try:
        for mode, key in (("key range", "id"), ("one fetch", None)):
            fr, s = timed(lambda: h2o.import_sql_table(
                lambda: sqlite3.connect(db), "air", key_column=key,
                fetch_chunks=2, device="cuda"))
            bad = []
            if not torch.equal(fr.vec("id").data.cpu(),
                               torch.arange(rows, dtype=torch.float32)):
                bad.append("id (row order)")
            for n, labs, i, col in zip(AIRLINES_NAMES, labels, idx, src):
                v = fr.vec(n)
                if n in NUMERIC_AIRLINES:
                    want = np.asarray([np.nan if x is None else x
                                       for x in col], np.float32)
                    got = v.data.cpu().numpy()
                    if not np.array_equal(got, want, equal_nan=True):
                        bad.append(n)
                else:
                    dom = np.asarray(list(v.domain) + [None], dtype=object)
                    codes = v.data.cpu().numpy()
                    got = dom[np.where(codes < 0, len(v.domain), codes)]
                    if list(got) != col:
                        bad.append(n)
            print(f"ingest sql, {mode}: {rows} rows, {fr.ncol} columns; "
                  f"table written in {write_s!r} s; import_sql_table "
                  f"{s!r} s = {rows / s!r} rows/s; columns that differ "
                  f"from the source {bad} [{card}]", flush=True)
            if bad or fr.nrow != rows:
                raise AssertionError(f"ingest sql ({mode}): {bad}")
            del fr
    finally:
        os.unlink(db)


def phase_ingest(card, csv_ref, air_rows=10_000_000, fmt_rows=100_000,
                 xlsx_rows=20_000, higgs_rows=100_000, fb_rows=1_000_000,
                 sql_rows=250_000, member_bytes=1 << 20):
    """The rest of ingest on the card (B1-B5), after ``phase_csv``, whose
    10M-row airlines file and default-GBM train (``csv_ref``: its trees
    and AUC) it reuses: gzip and zstd at full width through the GBM;
    streaming on and off; the fallback columns; the formats; URIs; SQL.
    Returns the compressed paths' launches."""
    import h2o3_tpu_torch as h2o
    t_phase = time.perf_counter()
    tables, idx, _expect = airlines_columns(air_rows)
    csv_path, _ = cached_csv(f"airlines_{air_rows}_2024",
                             lambda p: write_airlines_csv(p, tables, idx))
    del tables, idx
    ref = h2o.import_file(csv_path, device="cuda")
    launches, paths = ingest_compressed(card, csv_path, air_rows, ref,
                                        csv_ref, member_bytes)
    ingest_remote(card, paths["gzip"], ref)
    del ref
    ingest_stream_on_off(card, csv_path, air_rows)
    ingest_fallback_columns(card, fb_rows)
    ingest_formats(card, fmt_rows, xlsx_rows, higgs_rows=higgs_rows)
    ingest_sql(card, sql_rows)
    print(f"ingest phase: {time.perf_counter() - t_phase!r} s wall "
          f"[{card}]", flush=True)
    return launches


def phase_card_vs_cpu_i8(path, terms, rows=200_000, ntrees=5):
    """An int8 path on the card and on the CPU, bf16 histograms. At one
    term every split level is an exact integer sum on both devices: tree
    0's splits must be equal. At two terms the N = 32 level takes the
    float bf16 level, whose float sums differ in the last bits, so a
    near-tie there may flip a split: the differing splits are printed.
    |dAUC| <= 1e-4 at both."""
    X, y, _F = higgs_arrays(rows, seed=11)
    models = {dev: train(frame_of(X, y, dev), ntrees, path, i8=terms,
                         histogram_precision="bfloat16")
              for dev in ("cuda", "cpu")}
    mc, mh = models["cuda"], models["cpu"]
    keys = ("feat", PATHS[path]["split_key"], "na_left")
    same = [all(np.array_equal(mc.trees[k][t], mh.trees[k][t]) for k in keys)
            for t in range(ntrees)]
    if terms == 1 and not same[0]:
        raise AssertionError(f"{path} H2O3_HIST_I8=1: tree 0 differs "
                             f"between cuda and cpu")
    d_auc = abs(mc.training_metrics.auc - mh.training_metrics.auc)
    if d_auc > 1e-4:
        raise AssertionError(f"{path} H2O3_HIST_I8={terms}: |dAUC| cuda vs "
                             f"cpu = {d_auc}")
    print(f"card vs cpu, {path} H2O3_HIST_I8={terms}: {rows} rows, {ntrees} "
          f"trees, bf16 histograms: {sum(same)} of {ntrees} trees identical "
          f"({split_flips(mc.trees, mh.trees)}), AUC cuda "
          f"{mc.training_metrics.auc!r} cpu {mh.training_metrics.auc!r} "
          f"|dAUC| {d_auc!r}", flush=True)


def i8_level_bound_ms(kind, rows, F, N, W, terms, rows_in_level,
                      itemsize=1):
    """Least time for one int8 level: each input read once (codes or
    float32 x, nid, q at one byte a term), each output written once
    (nid', the float32 histogram), or its integer adds (3·terms per row in
    the level and feature, and the adaptive re-bin's subtract and
    multiply) at the float32 rate, whichever takes longer."""
    width = F * (itemsize if kind == "binned" else 4)
    nbytes = rows * (width + 4 + 3 * terms + 4) + 3 * N * F * W * 4
    ops = (3 * terms + (0 if kind == "binned" else 2)) * rows_in_level * F
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_i8_record(dev, launches, rows=10_000_000, F=28):
    """The int8 levels at the main paths' shapes (10M x 28; packed int8
    codes, int16 at W = 256; adaptive float32 features in the training
    layout), per level: one term at N = 1..32 and two at N = 1..16, at W =
    16, 32, 64, 128 and 256, every form (``i8_forms``: forced, and the one
    the kernel picks, named by ``*_i8_picks``) checked bit-equal to the
    plain version at 10M rows and timed on the same inputs. At one term,
    at the path's own W (16 packed, 32 adaptive) and at every wide W, the
    float kernel of the same level (bfloat16 masses, as the path takes it
    without the switch; the wide body at the wide W) on the same inputs in
    the same run, and at N = 32 the plain version, one ``index_add_`` of
    the rows' q widened to int32 into int32 over a precomputed flat (node,
    feature, bin) index (library_ms) and the bound; for the adaptive
    kernel at its path's W the [F, rows] layout (the tiled body). Prints
    the levels where the form the rule picks took more than 5% above the
    fastest forced form (each timed forced, on the same inputs).""" 
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import adaptive_bins_plain
    rec = []
    for kind, w_path in (("binned", 16), ("adaptive", 32)):
        name = f"{kind}_level_i8"
        picks_fn = (kernels.binned_level_i8_picks if kind == "binned"
                    else kernels.adaptive_level_i8_picks)
        times, float_ms, picked, slow = {}, {}, {}, []
        plain, lib, bound, other = {}, {}, {}, None
        for W in I8_W:
            forced = [f for f in i8_forms("rows_f", W) if f != "picked"]
            for terms, levels in I8_LEVELS:
                per = {form: {} for form in i8_forms("rows_f", W)}
                for N in levels:
                    seed = 1400 + 10 * W + 100 * terms + N
                    inp, qs = check_i8(kind, rows, F, W, N, terms, dev, seed)
                    for form, ms in time_i8_forms(kind, inp, qs, N, W,
                                                  20).items():
                        per[form][N] = ms
                    # the rule's form against the fastest forced form, each
                    # timed forced on these inputs
                    fastest = min(per[f][N] for f in forced)
                    rule = picks_fn(rows, F, W, N // 2, N, terms)
                    picked.setdefault(W, {}).setdefault(terms, {})[N] = rule
                    if per[rule][N] > 1.05 * fastest:
                        slow.append(f"W={W} terms={terms} N={N}")
                    if terms == 1 and (W == w_path or W >= 64):
                        if kind == "binned":
                            codes, nid, ghw, tables, n_prev, base = inp
                            float_ms.setdefault(W, {})[N] = time_cuda(
                                lambda: kernels.binned_level(
                                    codes, nid, ghw, tables, n_prev, N, base,
                                    W, True), 10)
                        else:
                            x, nid, ghw, tables, lo, inv, n_prev, base = inp
                            float_ms.setdefault(W, {})[N] = time_cuda(
                                lambda: kernels.adaptive_level(
                                    x, nid, ghw, tables, lo, inv, n_prev, N,
                                    base, W, True, "rows_f"), 10)
                    if terms == 1 and N == 32 and (W == w_path or W >= 64):
                        plain[W] = time_cuda(lambda: i8_plain(
                            kind, inp, qs, N, W), 3)
                        nid_out = i8_level(kind, inp, qs, N, W)[0]
                        bins = (inp[0] if kind == "binned" else
                                adaptive_bins_plain(inp[0], nid_out, inp[4],
                                                    inp[5], N, inp[7], W))
                        lib[W] = index_add_ms(bins, nid_out, qs[0].t().int(),
                                              N, inp[-1], W)
                        bound[W] = i8_level_bound_ms(
                            kind, rows, F, N, W, 1, rows,
                            inp[0].element_size())
                        del bins, nid_out
                        if kind == "adaptive" and W == w_path:
                            # the same values in [F, rows]
                            inp_o = (inp[0].t().contiguous(),) + \
                                tuple(inp[1:])
                            other = {"f_rows": time_cuda(
                                lambda: i8_level(kind, inp_o, qs, N, W,
                                                 "f_rows"), 10)}
                            del inp_o
                    del inp, qs
                times.setdefault(W, {})[terms] = per
                sums = {form: sum(v.values()) for form, v in per.items()}
                print(f"{name} at 10M x 28, W={W}, terms={terms}, per level "
                      f"N and form: {json.dumps(per)} ms; sum per tree "
                      f"{json.dumps(sums)} ms; picked "
                      f"{json.dumps(picked[W][terms])}", flush=True)
        tree = {w: {t: {form: sum(v.values()) for form, v in per.items()}
                    for t, per in by_t.items()}
                for w, by_t in times.items()}
        float_tree = {w: sum(v.values()) for w, v in float_ms.items()}
        by, rest = bound[w_path][1], {w: b[0] for w, b in bound.items()}
        print(f"{name} at 10M x 28, one term, sum per tree by W (int8 "
              f"forms) {json.dumps({w: t[1] for w, t in tree.items()})} ms, "
              f"the float level (bf16, picked) {json.dumps(float_tree)} ms; "
              f"N=32 by W: picked "
              f"{json.dumps({w: times[w][1]['picked'][32] for w in plain})} "
              f"ms, plain {json.dumps(plain)} ms, index_add_ "
              f"{json.dumps(lib)} ms, bound {json.dumps(rest)} ms"
              + (f", other layout {json.dumps(other)} ms" if other else "")
              + f"; picked form more than 5% above the fastest forced one "
              f"at {slow or 'no level'}", flush=True)
        rec.append({"name": name, "route": "cuda", "source": SRC[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name], "max_abs_err": 0.0,
                    "ms": times[w_path][1]["picked"][32],
                    "ms_tree": tree[w_path][1],
                    "ms_tree_terms2": tree[w_path][2],
                    "ms_tree_by_w": {w: t for w, t in tree.items()
                                     if w != w_path},
                    "float_level_ms_tree": float_tree[w_path],
                    "float_level_ms_tree_by_w": float_tree,
                    "plain_ms": plain[w_path], "bound_ms": rest[w_path],
                    "bound_by": by, "library_ms": lib[w_path],
                    "ms_by_w": {w: times[w][1]["picked"][32]
                                for w in plain},
                    "plain_ms_by_w": plain, "bound_ms_by_w": rest,
                    "library_ms_by_w": lib, "picked_by_w": picked,
                    "picked_slow": slow})
    return rec


def phase_totals_record(dev, launches, rows=10_000_000, F=28, n_prev=32,
                        N=64):
    """leaf_totals at 10M x 28 after a depth-6 tree's last split level
    (n_prev = 32, N = 64): time, plain version's time, bound (nid in and
    out, ghw, the one x value a row the route reads); no path launches it
    with a route, in either package. Its instance without a route,
    segment_totals, at the packed and global paths' deepest level (10M
    rows, N = 64): time in each form, plain version's time, one
    ``index_add_`` over the rows' node index (library_ms), bound (nid and
    ghw read once). The kernels' and the library call's times are the
    device's (``tools.time_ms``; ``ms_with_host`` beside segment_totals'
    is one call between two events, the wrapper's host time included)."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.common import segment_totals_plain
    from h2o3_tpu_torch.ops.hist_adaptive import leaf_totals_plain
    from h2o3_tpu_torch import tools
    err, (x, nid, ghw, tables, base) = check_totals(rows, F, n_prev, N, dev,
                                                   1500)
    ms = tools.time_ms(lambda: kernels.leaf_totals(x, nid, ghw, tables,
                                                   n_prev, N, base), dev, 20)
    pms = time_cuda(lambda: leaf_totals_plain(x, nid, ghw, tables, n_prev, N,
                                              base), 3)
    del x
    nbytes = rows * (4 + 4 + 12 + 4)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 3 * rows / F32_OPS_PER_S
    bound, by = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")
    print(f"leaf_totals at 10M x 28, n_prev={n_prev} N={N}, device: {ms!r} "
          f"ms, plain "
          f"{pms!r} ms, bound {bound!r} ms by {by}, max abs err {err!r}",
          flush=True)
    rec = [{"name": "leaf_totals", "route": "cuda",
            "source": SRC["leaf_totals"], "replaces": REPLACES["leaf_totals"],
            "launches": launches["leaf_totals"], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}]
    serr, (nid, ghw, base) = check_segment(rows, N, dev, 1501)
    sms = tools.time_ms(lambda: kernels.segment_totals(nid, ghw, N, base),
                        dev, 20)
    host_ms = time_cuda(lambda: kernels.segment_totals(nid, ghw, N, base), 20)
    # each form forced on the same inputs (the picked one among them)
    form_ms = {}
    for form in ("lanes", "match"):
        check_segment(rows, N, dev, 1501, form)
        form_ms[form] = tools.time_ms(lambda: kernels.segment_totals_form(
            nid, ghw, N, base, form), dev, 20)
    spms = time_cuda(lambda: segment_totals_plain(nid, ghw, N, base), 3)
    lid = nid.long() - base
    live = (lid >= 0) & (lid < N)
    idx = torch.where(live, lid, 0)
    vals = (ghw * live).t().contiguous()
    out = torch.zeros((N, 3), device=dev)
    lib_ms = tools.time_ms(lambda: out.index_add_(0, idx, vals), dev, 20)
    del lid, live, idx, vals, out
    t_b, t_o = rows * (4 + 12) / HBM_BYTES_PER_S, 3 * rows / F32_OPS_PER_S
    sbound, sby = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o
                                        else "operations")
    print(f"segment_totals at 10M rows, N={N}, device: {sms!r} ms (forms "
          f"{json.dumps(form_ms)} ms; with the host {host_ms!r} ms), plain "
          f"{spms!r} ms, index_add_ {lib_ms!r} ms, bound {sbound!r} ms by "
          f"{sby}, max abs err {serr!r}; five launches bit-equal",
          flush=True)
    rec.append({"name": "segment_totals", "route": "cuda",
                "source": SRC["segment_totals"],
                "replaces": REPLACES["segment_totals"],
                "launches": launches["segment_totals"], "max_abs_err": serr,
                "ms": sms, "ms_by_form": form_ms, "ms_with_host": host_ms,
                "plain_ms": spms,
                "bound_ms": sbound, "bound_by": sby, "library_ms": lib_ms})
    return rec


def index_add_ms(bins, nid_out, vals, N, base, W, reps=5):
    """The library yardstick of a level's histogram: one ``index_add_`` of
    the values ``vals`` [rows, C] of the rows in the level's window over
    their flat (node, feature, bin) index (``bins`` [rows, F], the codes
    or the adaptive bins), index and values built before the timing:
    float values into float32, int32 into int32. The port never calls
    it."""
    import torch
    F = bins.shape[1]
    lid = nid_out.long() - base
    live = (lid >= 0) & (lid < N)
    flat = ((lid[live][:, None] * F + torch.arange(F, device=bins.device))
            * W + bins[live].long()).reshape(-1)
    v = vals[live]
    v = v[:, None, :].expand(-1, F, v.shape[1]).reshape(-1, v.shape[1])
    v = v.contiguous()
    out = torch.zeros((N * F * W, v.shape[1]), dtype=v.dtype,
                      device=bins.device)
    ms = time_cuda(lambda: out.index_add_(0, flat, v), reps)
    del flat, v, out
    return ms


def bf16_rows(ghw):
    """(g, h, w) a row, bf16-rounded, as float32 [rows, 3]."""
    import torch
    return ghw.t().to(torch.bfloat16).float()


def phase_kernel_record(dev, launches, rows=10_000_000, F=28):
    """The packed kernels at the packed main path's shapes (10M x 28 int8
    codes, W = 16, bfloat16-rounded (g, h, w) as histogram_precision=
    'auto' picks at this size). binned_level per level N = 1..32: the
    form the path takes (node-grouped) and the tiled body forced, at bf16,
    and the grouped form at float32, each level checked against the plain
    version at 10M rows (both precisions, both forms at bf16) and launched
    five times with the same bits; at N = 32 the plain version's time,
    the bound, one ``index_add_`` (library_ms) and the grouping pass
    alone. The same per level at W = 32, bf16, in the tensor-core, the
    wide and the tiled form, and one ``index_add_`` at N = 32 (the wide
    widths: phase_wide_record): the form rule (level_form in
    csrc/level_wide.cuh) rests on these. The route at N = 64."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (binned_level_plain,
                                                  binned_route_only_plain)
    N = 32
    sums, errs, by_w, lib_by_w = {}, {}, {}, {}
    for W in (16, 32):
        forms = ("grouped", "tiled") + (("wide",) if W == 32 else ())
        per = {f"{form}_bf16": {} for form in forms}
        if W == 16:
            per["grouped_f32"] = {}
        for n_lvl in (1, 2, 4, 8, 16, 32):
            seed = 1234 + 7 * W + n_lvl
            inp = level_inputs(rows, F, W, n_lvl, False, seed, dev)
            for form, e in check_forms("binned", inp, n_lvl, W, True,
                                       forms).items():
                errs[f"W={W} {form} bf16 N={n_lvl}"] = e
            e = errs[f"W={W} grouped bf16 N={n_lvl}"]
            codes, nid, ghw, tables, n_prev, base = inp
            for form in forms:
                per[f"{form}_bf16"][n_lvl] = time_cuda(
                    lambda: binned_form(form)(codes, nid, ghw, tables,
                                              n_prev, n_lvl, base, W, True),
                    10)
            if W == 32 and n_lvl == N:
                nid_out = binned_form("picked")(codes, nid, ghw, tables,
                                                n_prev, N, base, W, True)[0]
                lib_by_w[W] = index_add_ms(codes, nid_out, bf16_rows(ghw), N,
                                           base, W)
                del nid_out
            if W == 16:
                e32, _ = check_level(rows, F, W, n_lvl, False, False, dev, 0,
                                     "grouped", inp)
                errs[f"W=16 f32 N={n_lvl}"] = e32
                per["grouped_f32"][n_lvl] = time_cuda(
                    lambda: binned_form("grouped")(
                        codes, nid, ghw, tables, n_prev, n_lvl, base, W,
                        False), 10)
                outs = [binned_form("grouped")(codes, nid, ghw, tables,
                                               n_prev, n_lvl, base, W, True)
                        for _ in range(5)]
                if not all(torch.equal(outs[0][1], o[1]) for o in outs[1:]):
                    raise AssertionError(f"binned_level grouped N={n_lvl}: "
                                         f"five launches differ")
                if n_lvl == N:
                    ms, err = per["grouped_bf16"][N], e
                    pms = time_cuda(lambda: binned_level_plain(
                        codes, nid, ghw, tables, n_prev, N, base, W, True),
                        3)
                    lib_ms = index_add_ms(codes, outs[0][0], bf16_rows(ghw),
                                          N, base, W)
                    lp = nid.long() - (base - n_prev)
                    keys = torch.where(
                        tables[3][lp.clamp(0, n_prev - 1)] != 0, lp,
                        -1).to(torch.int32)
                    group_ms = time_cuda(lambda: kernels.group_rows(
                        keys, n_prev + N, ghw), 10)
                    del lp, keys
                del outs
            del inp, codes, nid, ghw
        sums[W] = {k: sum(v.values()) for k, v in per.items()}
        by_w[W] = per
        print(f"binned_level at 10M x 28, W={W} (int8 codes), "
              f"per level N (grouped: the node-grouped tensor-core form; "
              f"wide: the wide body; tiled: the tiled body; all forced): "
              f"{json.dumps(per)} ms; sum per tree {json.dumps(sums[W])} ms",
              flush=True)
    bound, by = level_bound_ms(rows, F, 1, N, 16, rows)
    print(f"binned_level W=16 N={N}: {ms!r} ms, plain {pms!r} ms, "
          f"index_add_ {lib_ms!r} ms (W=32: {json.dumps(lib_by_w)}), "
          f"grouping pass alone {group_ms!r} ms, "
          f"bound {bound!r} ms by {by}; five launches bit-equal at every "
          f"level; max abs err vs plain {json.dumps(errs)}", flush=True)
    rec = [{"name": "binned_level", "route": "cuda",
            "source": SRC["binned_level"],
            "replaces": REPLACES["binned_level"],
            "also_replaces": ALSO_REPLACES["binned_level"],
            "launches": launches["binned_level"], "max_abs_err": err,
            "ms": ms, "ms_tree": sums[16]["grouped_bf16"],
            "ms_tree_tiled": sums[16]["tiled_bf16"],
            "ms_tree_f32": sums[16]["grouped_f32"],
            "ms_tree_by_w": {w: v for w, v in sums.items() if w != 16},
            "group_ms": group_ms, "plain_ms": pms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms,
            "library_ms_by_w": lib_by_w}]
    W = 16
    _e, (codes, nid, tables, n_prev, base) = check_route(
        rows, F, W, 2 * N, dev, 4321)
    ms = time_cuda(lambda: kernels.binned_route_only(
        codes, nid, tables, n_prev, base, W), 20)
    pms = time_cuda(lambda: binned_route_only_plain(
        codes, nid, tables, n_prev, base, W), 3)
    bound, by = route_bound_ms(rows, F, 1)
    rec.append({"name": "binned_route_only", "route": "cuda",
                "source": SRC["binned_route_only"],
                "replaces": REPLACES["binned_route_only"],
                "launches": launches["binned_route_only"],
                "max_abs_err": 0.0, "ms": ms, "plain_ms": pms,
                "bound_ms": bound, "bound_by": by, "library_ms": None})
    return rec


def phase_wide_record(dev, rows=10_000_000, F=28):
    """The float levels at the wide lane widths (W = 64, 128 with int8
    codes, 256 with int16 codes; K8 on float32 features in [rows, F]),
    10M x 28, bfloat16-rounded masses as histogram_precision='auto' picks
    at this size, per level N = 1..32: every form (the wide body, the
    tiled body) checked against the plain version at 10M rows and timed
    on the same inputs, the wide form launched five times with the same
    bits, and the form the kernel picks (``*_picks``); at N = 32 the
    plain version's time, the bound and one ``index_add_`` over a
    precomputed flat (node, feature, bin) index (library_ms). Returns,
    per kind, the record fields the kernel line carries."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_bins_plain,
                                                  adaptive_level_plain,
                                                  binned_level_plain)
    N = 32
    out = {}
    for kind in ("binned", "adaptive"):
        picks = (kernels.binned_level_picks if kind == "binned"
                 else kernels.adaptive_level_picks)
        rec = {"ms_level": {}, "ms_tree": {}, "picked": {},
               "ms_tree_picked": {}, "plain_ms": {}, "bound_ms": {},
               "bound_by": {}, "library_ms": {}, "max_abs_err": {}}
        for W in WIDE_W:
            per = {form: {} for form in level_forms(W)}
            picked = {}
            err = 0.0
            for n_lvl in (1, 2, 4, 8, 16, 32):
                seed = 2600 + 7 * W + n_lvl + (0 if kind == "binned" else 50)
                if kind == "binned":
                    inp = level_inputs(rows, F, W, n_lvl, False, seed, dev)
                    run = lambda f: binned_form(f)(
                        *inp[:4], inp[4], n_lvl, inp[5], W, True)
                    n_prev, base = inp[4], inp[5]
                else:
                    inp = adaptive_inputs(rows, F, W, n_lvl, False, seed,
                                          dev, "rows_f")
                    run = lambda f: adaptive_form(f)(
                        *inp[:6], inp[6], n_lvl, inp[7], W, True, "rows_f")
                    n_prev, base = inp[6], inp[7]
                errs = check_forms(kind, inp, n_lvl, W, True, level_forms(W))
                err = max(err, errs["wide"])
                outs = [run("wide") for _ in range(5)]
                if not all(torch.equal(outs[0][1], o[1]) and
                           torch.equal(outs[0][0], o[0]) for o in outs[1:]):
                    raise AssertionError(f"{kind}_level wide W={W} "
                                         f"N={n_lvl}: five launches differ")
                for form in level_forms(W):
                    per[form][n_lvl] = time_cuda(lambda: run(form), 10)
                picked[n_lvl] = picks(rows, F, W, n_prev, n_lvl)
                if n_lvl == N:
                    nid_out = outs[0][0]
                    if kind == "binned":
                        bins = inp[0]
                        rec["plain_ms"][W] = time_cuda(
                            lambda: binned_level_plain(
                                *inp[:4], n_prev, N, base, W, True), 3)
                        b = level_bound_ms(rows, F, inp[0].element_size(),
                                           N, W, rows)
                    else:
                        bins = adaptive_bins_plain(inp[0], nid_out, inp[4],
                                                   inp[5], N, base, W)
                        rec["plain_ms"][W] = time_cuda(
                            lambda: adaptive_level_plain(
                                *inp[:6], n_prev, N, base, W, True), 3)
                        b = adaptive_level_bound_ms(rows, F, N, W, rows)
                    rec["bound_ms"][W], rec["bound_by"][W] = b
                    rec["library_ms"][W] = index_add_ms(
                        bins, nid_out, bf16_rows(inp[2]), N, base, W)
                    del bins, nid_out
                del outs, inp
                torch.cuda.empty_cache()
            sums = {form: sum(v.values()) for form, v in per.items()}
            rec["ms_level"][W] = per
            rec["ms_tree"][W] = sums
            rec["picked"][W] = picked
            rec["ms_tree_picked"][W] = sum(per[picked[n]][n] for n in per[
                "wide"])
            rec["max_abs_err"][W] = err
            dtype = ("float32 x" if kind == "adaptive" else
                     "int16 codes" if W == 256 else "int8 codes")
            print(f"{kind}_level at 10M x 28, W={W} ({dtype}), bf16, per "
                  f"level N and form (wide: the wide body; tiled: the tiled "
                  f"body; both forced and checked against the plain "
                  f"version; wide five launches bit-equal): "
                  f"{json.dumps(per)} ms; sum per "
                  f"tree {json.dumps(sums)} ms; picked {json.dumps(picked)}, "
                  f"a tree {rec['ms_tree_picked'][W]!r} ms; N=32: plain "
                  f"{rec['plain_ms'][W]!r} ms, index_add_ "
                  f"{rec['library_ms'][W]!r} ms, bound "
                  f"{rec['bound_ms'][W]!r} ms by {rec['bound_by'][W]}",
                  flush=True)
        out[kind] = rec
    return out


def phase_adaptive_record(dev, launches, rows=10_000_000, F=28):
    """The adaptive kernels at the adaptive main path's shapes (10M x 28
    float32 features, W=32). In the training layout ([rows, F], the
    node-grouped tensor-core level): per level N = 1..32 at bfloat16
    (as histogram_precision='auto' picks at this size) and at float32,
    each checked against the plain version at 10M rows, and the grouped
    kernel's shared-atomics ablation on the same inputs (checked too), and
    the wide body forced at bfloat16 (checked: the form rule keeps the
    tensor-core body at this W); the grouping pass alone at N = 32; at
    N = 32 the plain version's time and the bound. In [F, rows] (K5) per
    level at bfloat16 the column body (the form picked) and the tiled
    body forced, both checked against the plain version on the timed
    inputs, as device time (``tools.time_ms``) with the one-call time
    beside; at N = 32 also at W = 64, 128, 256, beside K6's route
    followed by the column body on the routed ids (the route taken out of
    the level: checked bit-equal to the picked form), with the plain
    version and the bound. The route at N = 64 in both layouts (device
    time), and in each layout at 28 and 8 features beside its loads-only
    floor (``route_rows_record``)."""
    import torch
    from h2o3_tpu_torch import tools
    from h2o3_tpu_torch.models.gbm import ADAPTIVE_LAYOUT
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_bins_plain,
                                                  adaptive_level_plain,
                                                  adaptive_route_only_plain)
    W, N = 32, 32
    level_ms, route_ms = {}, {}
    per = {"bf16": {}, "f32": {}, "atomics_bf16": {}, "atomics_f32": {},
           "wide_bf16": {}, "f_rows_column": {}, "f_rows_tiled": {},
           "f_rows_column_one_call": {}, "f_rows_tiled_one_call": {}}
    errs = {}
    for n_lvl in (1, 2, 4, 8, 16, 32):
        for bf16 in (True, False):
            tag = "bf16" if bf16 else "f32"
            e, inp = check_adaptive_level(rows, F, W, n_lvl, False, bf16, dev,
                                          900 + n_lvl, "rows_f")
            errs[f"{tag} N={n_lvl}"] = e
            x, nid, ghw, tables, lo, inv, n_prev, base = inp
            per[tag][n_lvl] = time_cuda(
                lambda: kernels.adaptive_level(x, nid, ghw, tables, lo, inv,
                                               n_prev, n_lvl, base, W, bf16,
                                               "rows_f"), 10)
            if bf16:
                # the wide body at the path's W, where the rule keeps the
                # tensor-core body
                check_forms("adaptive", inp, n_lvl, W, True, ("wide",))
                per["wide_bf16"][n_lvl] = time_cuda(
                    lambda: adaptive_form("wide")(
                        x, nid, ghw, tables, lo, inv, n_prev, n_lvl, base, W,
                        True, "rows_f"), 10)
            _n, ha = kernels.adaptive_level_atomics(
                x, nid, ghw, tables, lo, inv, n_prev, n_lvl, base, W, bf16)
            _n, hp = adaptive_level_plain(x, nid, ghw.double(), tables, lo,
                                          inv, n_prev, n_lvl, base, W, bf16)
            _n, mass = adaptive_level_plain(x, nid, ghw.double().abs(),
                                            tables, lo, inv, n_prev, n_lvl,
                                            base, W, bf16)
            mass_check(f"adaptive_level atomics ablation {tag} N={n_lvl}",
                       ha, hp, mass)
            del ha, hp, mass
            per["atomics_" + tag][n_lvl] = time_cuda(
                lambda: kernels.adaptive_level_atomics(
                    x, nid, ghw, tables, lo, inv, n_prev, n_lvl, base, W,
                    bf16), 10)
            if n_lvl == N and bf16:
                err = e
                pms = time_cuda(lambda: adaptive_level_plain(
                    x, nid, ghw, tables, lo, inv, n_prev, N, base, W, True),
                    3)
                # the grouping pass alone: the level's keys (the parent of
                # a routed row), its G = n_prev + N groups
                lp = nid.long() - (base - n_prev)
                keys = torch.where(tables[3][lp.clamp(0, n_prev - 1)] > 0.5,
                                   lp, -1).to(torch.int32)
                group_ms = time_cuda(lambda: kernels.group_rows(
                    keys, n_prev + N, ghw), 10)
                del keys, lp
                # the library yardstick on the level's adaptive bins
                nid_out = kernels.adaptive_level(x, nid, ghw, tables, lo, inv,
                                                 n_prev, N, base, W, True,
                                                 "rows_f")[0]
                bins = adaptive_bins_plain(x, nid_out, lo, inv, N, base, W)
                lib_ms = index_add_ms(bins, nid_out, bf16_rows(ghw), N, base,
                                      W)
                del nid_out, bins
            del inp, x, nid, ghw
        per_f, err_f = f_rows_level_record(dev, rows, F, W, n_lvl,
                                           900 + n_lvl, route_first=False)
        for k, v in per_f.items():
            per["f_rows_" + k][n_lvl] = v
        errs[f"f_rows N={n_lvl}"] = err_f
    sums = {k: sum(v.values()) for k, v in per.items()}
    level_ms = {"rows_f": per["bf16"][N], "f_rows": per["f_rows_column"][N]}
    print(f"adaptive_level at 10M x 28, W=32, per level N (rows_f: "
          f"node-grouped tensor-core form, and its shared-atomics ablation; "
          f"wide: the wide body forced; f_rows: the column body, the form "
          f"picked, and the tiled body forced, bf16, device time and one "
          f"call): {json.dumps(per)} ms; sum per tree "
          f"{json.dumps(sums)} ms; grouping pass alone at N=32 "
          f"{group_ms!r} ms; index_add_ on the adaptive bins at N=32 "
          f"{lib_ms!r} ms; max abs err vs plain {json.dumps(errs)}",
          flush=True)
    # [F, rows] at N = 32: the route taken out of the level (K6, then the
    # column body on the routed ids) at every W, the tiled body beside
    f_rows_n32 = {}
    for Wf in (32,) + WIDE_W:
        f_rows_n32[str(Wf)], _e = f_rows_level_record(
            dev, rows, F, Wf, N, 950 + Wf, route_first=True)
        f_rows_n32[str(Wf)]["bound_ms"] = adaptive_level_bound_ms(
            rows, F, N, Wf, rows)[0]
    print(f"adaptive_level f_rows at 10M x 28, N=32, bf16, device ms by W "
          f"(column: the form picked, route in the level; route_first: K6's "
          f"route, then the column body on the routed ids; tiled forced): "
          f"{json.dumps(f_rows_n32)}", flush=True)
    for layout in LAYOUTS:
        x, nid, tables, n_prev, base = check_adaptive_route(rows, F, 2 * N,
                                                            dev, 4321, layout)
        route_ms[layout] = tools.time_ms(lambda: kernels.adaptive_route_only(
            x, nid, tables, n_prev, base, layout), dev, 20)
        if layout == ADAPTIVE_LAYOUT:
            rpms = time_cuda(lambda: adaptive_route_only_plain(
                x, nid, tables, n_prev, base, layout), 3)
        del x, nid
    print(f"adaptive layouts at 10M x 28 (training path: {ADAPTIVE_LAYOUT}):"
          f" level N=32 {json.dumps(level_ms)} ms, route N=64 "
          f"{json.dumps(route_ms)} ms", flush=True)
    route_rows = {lay: route_rows_record(dev, rows, (F, 8), 2 * N, lay)
                  for lay in LAYOUTS}
    bound, by = adaptive_level_bound_ms(rows, F, N, W, rows)
    rbound, rby = route_bound_ms(rows, F, 4, ADAPTIVE_LAYOUT)
    return [{"name": "adaptive_level", "route": "cuda",
             "source": SRC["adaptive_level"],
             "replaces": REPLACES["adaptive_level"],
             "also_replaces": ALSO_REPLACES["adaptive_level"],
             "launches": launches["adaptive_level"], "max_abs_err": err,
             "ms": level_ms[ADAPTIVE_LAYOUT], "ms_by_layout": level_ms,
             "ms_tree": sums["bf16"], "ms_tree_f32": sums["f32"],
             "ms_tree_atomics_ablation": sums["atomics_bf16"],
             "ms_tree_wide": sums["wide_bf16"],
             "forms": ["grouped", "wide", "tiled", "column"],
             "f_rows": {"ms_tree_column": sums["f_rows_column"],
                        "ms_tree_tiled": sums["f_rows_tiled"],
                        "n32_by_W": f_rows_n32},
             "group_ms": group_ms, "plain_ms": pms, "bound_ms": bound,
             "bound_by": by, "library_ms": lib_ms},
            {"name": "adaptive_route_only", "route": "cuda",
             "source": SRC["adaptive_route_only"],
             "replaces": REPLACES["adaptive_route_only"],
             "also_replaces": ALSO_REPLACES["adaptive_route_only"],
             "launches": launches["adaptive_route_only"], "max_abs_err": 0.0,
             "ms": route_ms[ADAPTIVE_LAYOUT], "ms_by_layout": route_ms,
             "rows_f_by_F": route_rows["rows_f"],
             "f_rows_by_F": route_rows["f_rows"],
             "plain_ms": rpms, "bound_ms": rbound, "bound_by": rby,
             "library_ms": None}]


def f_rows_level_record(dev, rows, F, W, N, seed, route_first):
    """K5 at one level in [F, rows], bf16: the column body (the form the
    kernel picks, which must be "column") and the tiled body forced, both
    checked against the plain version on the timed inputs (mass_check),
    each timed as device time (``tools.time_ms``) and as one call between
    two events (the host included). ``route_first``: also K6's route
    followed by the column body on the routed ids (n_prev 0), which must
    give the picked form's bits, and the plain version's time. Returns
    ({name: ms}, the largest error against the plain version)."""
    import torch
    from h2o3_tpu_torch import tools
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import adaptive_level_plain
    inp = adaptive_inputs(rows, F, W, N, False, seed, dev, "f_rows")
    x, nid, ghw, tables, lo, inv, n_prev, base = inp
    pick = kernels.adaptive_level_picks(rows, F, W, n_prev, N, "f_rows")
    if pick != "column":
        raise AssertionError(f"adaptive_level f_rows W={W} N={N} picks "
                             f"{pick}, not the column body")
    errs = check_forms("adaptive", inp, N, W, True, ("picked", "tiled"),
                       "f_rows")
    out = {}
    for form in ("column", "tiled"):
        def run(form=form):
            return adaptive_form(form)(x, nid, ghw, tables, lo, inv, n_prev,
                                       N, base, W, True, "f_rows")
        out[form] = tools.time_ms(run, dev, 10)
        out[form + "_one_call"] = time_cuda(run, 10)
    if route_first:
        root = tables[:, :1].contiguous()   # no route: one unused entry

        def routed():
            n1 = kernels.adaptive_route_only(x, nid, tables, n_prev, base,
                                             "f_rows")
            return adaptive_form("column")(x, n1, ghw, root, lo, inv, 0, N,
                                           base, W, True, "f_rows")
        a, b = routed(), kernels.adaptive_level(
            x, nid, ghw, tables, lo, inv, n_prev, N, base, W, True, "f_rows")
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"adaptive_level f_rows W={W} N={N}: the "
                                 f"route taken out of the level gives "
                                 f"other bits")
        del a, b
        out["route_first"] = tools.time_ms(routed, dev, 10)
        out["plain_ms"] = time_cuda(lambda: adaptive_level_plain(
            x, nid, ghw, tables, lo, inv, n_prev, N, base, W, True,
            "f_rows"), 3)
    return out, max(errs.values())


def route_rows_record(dev, rows, widths, N, layout="rows_f"):
    """The route in ``layout`` (K9 in [rows, F], K6 in [F, rows]) at each
    F of ``widths`` beside its loads-only floor (the same nid, table and
    x loads and nid stores, no compare), both checked on the timed inputs,
    and the bound; device times (``tools.time_ms``: the calls queued
    behind a device-side wait, the wrapper's host time out of the
    window)."""
    import torch
    from h2o3_tpu_torch import tools
    from h2o3_tpu_torch.ops import kernels
    out = {}
    for F in widths:
        x, nid, tables, n_prev, base = check_adaptive_route(
            rows, F, N, dev, 4321 + F, layout)
        if not torch.equal(kernels.adaptive_route_floor(
                x, nid, tables, n_prev, base, layout), nid):
            raise AssertionError(f"adaptive_route_floor {layout} at "
                                 f"{rows}x{F}: nid changed")
        r = {"ms": tools.time_ms(lambda: kernels.adaptive_route_only(
                 x, nid, tables, n_prev, base, layout), dev, 20),
             "floor_ms": tools.time_ms(lambda: kernels.adaptive_route_floor(
                 x, nid, tables, n_prev, base, layout), dev, 20),
             "ms_with_host": time_cuda(lambda: kernels.adaptive_route_only(
                 x, nid, tables, n_prev, base, layout), 20),
             "bound_ms": route_bound_ms(rows, F, 4, layout)[0]}
        out[str(F)] = r
        del x, nid
        print(f"adaptive_route_only {layout} at {rows}x{F}, n_prev={n_prev},"
              f" device: {r['ms']!r} ms, loads-only floor {r['floor_ms']!r} "
              f"ms; with the host {r['ms_with_host']!r} ms; bound "
              f"{r['bound_ms']!r} ms", flush=True)
    return out


GROWER_NBINS = {32: 20, 64: 62}   # W: the adaptive nbins that gives it


def grower_inputs(X, y, nbins, precision, depth=6):
    """The adaptive grower's inputs on the features X [rows, F] and the
    response y of the adaptive cell: the gradients of a bernoulli GBM's
    first tree at margin 0 (g = 0.5 - y, h = 0.25, w = 1), and the
    TreeConfig, root ranges and bin counts ``adaptive_setup`` gives at
    ``depth`` and ``nbins``."""
    from types import SimpleNamespace

    import torch
    from h2o3_tpu_torch.models.tree import adaptive_setup
    F = X.shape[1]
    spec = SimpleNamespace(X=X, names=[f"f{i}" for i in range(F)],
                           is_cat=[False] * F, cat_domains={}, n_features=F)
    params = {"nbins": nbins, "nbins_cats": 1024, "min_rows": 1.0,
              "min_split_improvement": 1e-5,
              "histogram_precision": precision}
    cfg, lo, hi, nb_f = adaptive_setup(spec, params, depth)
    g = (0.5 - y).to(torch.float32)
    return (g, torch.full_like(g, 0.25), torch.ones_like(g), cfg, lo, hi,
            nb_f)


def grow_layout(X, layout, inputs):
    """One adaptive tree on X [rows, F] grown in ``layout`` (``"f_rows"``
    on a transposed copy): (its arrays, every row's leaf id) as numpy."""
    from h2o3_tpu_torch.models.tree import grow_tree_adaptive
    g, h, w, cfg, lo, hi, nb_f = inputs
    x = X if layout == "rows_f" else X.t().contiguous()
    tree, nid = grow_tree_adaptive(x, g, h, w, cfg, lo, hi, nb_f=nb_f,
                                   layout=layout)
    return {k: v.cpu().numpy() for k, v in tree.items()}, nid.cpu().numpy()


def grower_diffs(a, b, keys=("feat", "thr", "na_left", "is_split")):
    """Entries of two grown trees that differ in any bit, per key, and in
    the rows' leaf ids (``nid``)."""
    (ta, na), (tb, nb) = a, b
    out = {k: int((np.asarray(ta[k]).view(np.uint8).reshape(len(ta[k]), -1)
                   != np.asarray(tb[k]).view(np.uint8).reshape(
                       len(tb[k]), -1)).any(axis=1).sum()) for k in keys}
    out["nid"] = int((na != nb).sum())
    return out


def phase_f_rows_grower(dev, fr, cpu_rows=200_000):
    """The [F, rows] grower on the card: ``grow_tree_adaptive(...,
    layout="f_rows")`` (the column body every level, K6 at the deepest)
    on the adaptive cell's data (``fr``: the bench generator's 28
    features, seed 42, 10M rows) with the gradients of a bernoulli GBM's
    first tree at margin 0. Those masses (g = +-0.5, h = 0.25, w = 1)
    make every histogram sum exact in float32 and in bf16 in any order,
    so no split is a near-tie of summation order on this seed's data. At
    W = 32 (nbins 20) and W = 64 (nbins 62):

    - the first ``cpu_rows`` rows, float32: the [F, rows] tree on the
      card equals the [rows, F] tree on the card and the CPU's plain
      [F, rows] tree in every split feature, threshold, NA direction and
      split flag (bit for bit), and every row's leaf id;
    - 10M rows, float32: two [F, rows] trees, the first right after the
      allocator is NaN-filled, bit for bit in every array and leaf id;
    - 10M rows, bf16: one [rows, F] tree's six level calls and its route
      recorded, each replayed in both layouts on the same inputs (the
      [F, rows] ones on a transposed copy; the column body, the form
      picked, checked against the plain version, and the tiled body
      forced; K9 and K6 bit-equal): device ms of each and a tree's sum
      (``tools.time_ms``), printed on one line per W.

    Returns {W: the timings}."""
    import torch
    from h2o3_tpu_torch import tools
    from h2o3_tpu_torch.models.model_base import build_training_spec
    from h2o3_tpu_torch.ops import kernels
    spec = build_training_spec(fr, "label")
    X, y = spec.X, spec.y
    Xc, yc = X[:cpu_rows].cpu(), y[:cpu_rows].cpu()
    xt = X.t().contiguous()
    out = {}
    for W, nbins in GROWER_NBINS.items():
        # card vs CPU at cpu_rows, float32
        small = grower_inputs(X[:cpu_rows], y[:cpu_rows], nbins, "float32")
        f_card = grow_layout(X[:cpu_rows], "f_rows", small)
        r_card = grow_layout(X[:cpu_rows], "rows_f", small)
        f_cpu = grow_layout(Xc, "f_rows", grower_inputs(Xc, yc, nbins,
                                                        "float32"))
        d = {"rows_f card": grower_diffs(f_card, r_card),
             "f_rows cpu": grower_diffs(f_card, f_cpu)}
        print(f"grower f_rows W={W} at {cpu_rows} rows, float32: entries "
              f"that differ from the f_rows card tree {json.dumps(d)}; "
              f"splits {int(f_card[0]['is_split'].sum())}", flush=True)
        if any(v for dd in d.values() for v in dd.values()) \
                or not f_card[0]["is_split"].any():
            raise AssertionError(f"grower f_rows W={W}: trees differ {d}")
        # 10M rows, float32, twice
        full = grower_inputs(X, y, nbins, "float32")
        poison_allocator(dev)
        runs = [grow_layout(X, "f_rows", full) for _ in range(2)]
        d = grower_diffs(runs[0], runs[1],
                         ("feat", "thr", "na_left", "is_split", "value",
                          "gain", "node_w"))
        print(f"grower f_rows W={W} at {X.shape[0]} rows, float32, twice "
              f"(first after NaN-filling the allocator): entries that "
              f"differ {json.dumps(d)}", flush=True)
        if any(d.values()):
            raise AssertionError(f"grower f_rows W={W}: two trees differ {d}")
        del runs, full
        # 10M rows, bf16: a [rows, F] tree's calls replayed in both layouts
        g, h, w, cfg, lo, hi, nb_f = grower_inputs(X, y, nbins, "bfloat16")
        calls = []
        with recorded_adaptive_calls(calls):
            from h2o3_tpu_torch.models.tree import grow_tree_adaptive
            grow_tree_adaptive(X, g, h, w, cfg, lo, hi, nb_f=nb_f,
                               layout="rows_f")
        ms = {"rows_f": [], "f_rows": [], "f_rows_tiled": []}
        for name, a in calls:
            if name == "adaptive_level":
                (_x, nid, ghw, tables, lo_d, inv_d, n_prev, N, base, Wl,
                 bf16, _lay, _qs) = a
                rest = (nid, ghw, tables, lo_d, inv_d, n_prev, N, base, Wl,
                        bf16)
                check_forms("adaptive", (xt, nid, ghw, tables, lo_d, inv_d,
                                         n_prev, base), N, Wl, bf16,
                            ("picked",), "f_rows")
                runs = {"rows_f": lambda: kernels.adaptive_level(
                            X, *rest, "rows_f"),
                        "f_rows": lambda: kernels.adaptive_level(
                            xt, *rest, "f_rows"),
                        "f_rows_tiled": lambda: kernels.adaptive_level_form(
                            xt, *rest, "f_rows", "tiled")}
            else:
                _x, nid, tables, n_prev, base, _lay = a
                rk = kernels.adaptive_route_only(X, nid, tables, n_prev,
                                                 base, "rows_f")
                if not torch.equal(rk, kernels.adaptive_route_only(
                        xt, nid, tables, n_prev, base, "f_rows")):
                    raise AssertionError(f"grower W={W}: K6 and K9 route "
                                         f"the deepest level apart")
                del rk
                runs = {lay: lambda lay=lay: kernels.adaptive_route_only(
                            X if lay == "rows_f" else xt, nid, tables,
                            n_prev, base, lay) for lay in LAYOUTS}
                runs["f_rows_tiled"] = runs["f_rows"]
            for k, run in runs.items():
                ms[k].append(tools.time_ms(run, dev, 10))
        if [n for n, _a in calls] != ["adaptive_level"] * 6 + [
                "adaptive_route_only"]:
            raise AssertionError(f"grower W={W}: a tree made the calls "
                                 f"{[n for n, _a in calls]}")
        del calls
        tree = {k: sum(v) for k, v in ms.items()}
        out[str(W)] = {"levels_and_route_ms": ms, "tree_ms": tree}
        print(f"grower at {X.shape[0]}x{X.shape[1]}, bf16, W={W}: device ms "
              f"a tree (six levels + route, one [rows, F] tree's inputs in "
              f"each layout): rows_f {tree['rows_f']!r}, f_rows (column) "
              f"{tree['f_rows']!r}, f_rows tiled {tree['f_rows_tiled']!r}; "
              f"per call {json.dumps(ms)}", flush=True)
    return out


def phase_packed_vs_global(rows=200_000, ntrees=5):
    """The two sketch paths on the card at float32 histograms and 14
    bins: the packed grower and the global-sketch grower must pick the
    same splits in every tree."""
    X, y, _F = higgs_arrays(rows, seed=12)
    fr = frame_of(X, y, "cuda")
    kw = dict(nbins=14, histogram_precision="float32")
    packed = train(fr, ntrees, "packed", packed_codes=True, **kw)
    glob = train(fr, ntrees, "global", packed_codes=False, **kw)
    if not (packed.output["packed_codes"]["enabled"]
            and not glob.output["packed_codes"]["enabled"]):
        raise AssertionError("packed vs global: the paths were not taken")
    for key in ("feat", "split_bin", "na_left"):
        a, b = packed.trees[key], glob.trees[key]
        if not np.array_equal(a, b):
            raise AssertionError(f"packed vs global: {key} differs in "
                                 f"{int((a != b).sum())} of {a.size} nodes")
    print(f"packed vs global on the card: {rows} rows, {ntrees} trees, "
          f"nbins 14, float32: feat, split_bin, na_left identical; AUC "
          f"{packed.training_metrics.auc!r} vs "
          f"{glob.training_metrics.auc!r}", flush=True)


def phase_global_record(dev, launches, loop_s, ntrees, rows=10_000_000,
                        F=28, B1=1025):
    """global_hist at the global path's shapes (10M x 28 int32 codes,
    B1 = 1025, bfloat16-rounded (g, h, w) as histogram_precision='auto'
    picks at this size): the six builds of a tree (N = 1 at level 0 over
    every row; then the left children, N = 1, 2, 4, 8, 16, over half the
    rows), each checked against the plain version and timed in the picked
    (node-grouped) form and with global atomics forced, their sum and its
    share of the loop; at N = 16 the grouping pass alone, the plain
    version's time, the bound and one ``index_add_`` over a precomputed
    flat (node, feature, bin) index of the rows in [0, N)."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.histogram import build_histograms_plain
    builds = [(1, False), (1, True), (2, True), (4, True), (8, True),
              (16, True)]
    forms = ("picked", "global")
    per_level = {f: [] for f in forms}
    for d, (n, left) in enumerate(builds):
        e, (codes, seg, ghw) = check_global(rows, F, B1, n, False, True, dev,
                                            1300 + d, left_only=left)
        for form in forms:
            per_level[form].append(time_cuda(lambda: global_form(form)(
                codes, seg, ghw, n, B1, True), 10))
        if d < len(builds) - 1:
            del codes, seg, ghw
    N = builds[-1][0]
    ms, err = per_level["picked"][-1], e
    group_ms = time_cuda(lambda: kernels.group_rows(seg, N, ghw), 10)
    pms = time_cuda(lambda: build_histograms_plain(codes, seg, ghw, N, B1,
                                                   True), 3)
    live = (seg >= 0) & (seg < N)
    bound, by = global_bound_ms(rows, F, codes.element_size(), N, B1,
                                int(live.sum()))
    # the library yardstick: one index_add_ of the bf16-rounded masses of
    # the rows in [0, N) over their flat (node, feature, bin) index; index
    # and values are built before the timing
    flat = ((seg[live].long()[:, None] * F + torch.arange(F, device=dev))
            * B1 + codes[live].long()).reshape(-1)
    vals = (ghw.t()[live].to(torch.bfloat16).float()[:, None, :]
            .expand(-1, F, 3).reshape(-1, 3).contiguous())
    out = torch.zeros((N * F * B1, 3), device=dev)
    lib_ms = time_cuda(lambda: out.index_add_(0, flat, vals), 5)
    del flat, vals, out, codes, seg, ghw, live
    sums = {f: sum(v) for f, v in per_level.items()}
    share = sums["picked"] * ntrees / (loop_s * 1e3)
    print(f"global_hist at 10M x 28, B1={B1}, per build N "
          f"{[n for n, _ in builds]}: {json.dumps(per_level)} ms; sum per "
          f"tree {json.dumps(sums)} ms, the picked form's {share!r} of the "
          f"warm loop ({loop_s!r} s for {ntrees} trees); N={N}: {ms!r} ms "
          f"(grouping pass alone {group_ms!r} ms), plain {pms!r} ms, "
          f"index_add_ {lib_ms!r} ms, bound {bound!r} ms by {by}",
          flush=True)
    return [{"name": "global_hist", "route": "cuda",
             "source": SRC["global_hist"],
             "replaces": REPLACES["global_hist"],
             "launches": launches["global_hist"], "max_abs_err": err,
             "ms": ms, "ms_tree": sums["picked"],
             "ms_tree_global_atomics": sums["global"], "group_ms": group_ms,
             "plain_ms": pms, "bound_ms": bound, "bound_by": by,
             "library_ms": lib_ms}]


def split_flips(a, b) -> str:
    """How two models' trees differ: split features that differ, and the
    first tree where any does (over the trees both have)."""
    n = min(len(a["feat"]), len(b["feat"]))
    diff = a["feat"][:n] != b["feat"][:n]
    first = int(np.argmax(diff.any(axis=1))) if diff.any() else None
    return f"{int(diff.sum())} of {diff.size} split features differ " \
           f"(first in tree {first})"


def poison_allocator(dev, gib=8):
    """Fill free memory of the caching allocator with NaN and give it back:
    a kernel or torch op that reads memory it never wrote then computes on
    NaN instead of on a previous run's values."""
    import torch
    free = torch.cuda.mem_get_info(dev)[0]
    n = min(gib << 30, free // 2) // 4
    t = torch.empty(n, dtype=torch.float32, device=dev)
    t.fill_(float("nan"))
    torch.cuda.synchronize()
    del t


def tree_diffs(a, b, split_key):
    """Entries of two models' trees that differ, per key: split feature,
    split key, NA direction and leaf value (bit for bit)."""
    out = {}
    for key in ("feat", split_key, "na_left", "value"):
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if key == "value":
            x, y = x.view(np.uint32), y.view(np.uint32)
        out[key] = int((x != y).sum())
    return out


def check_repeats(runs, path, what):
    """Every pair of ``runs`` (models of one path) must agree bit for bit
    in every tree's splits and leaf values."""
    key = PATHS[path]["split_key"]
    pairs = {f"{i}-{j}": tree_diffs(runs[i].trees, runs[j].trees, key)
             for i in range(len(runs)) for j in range(i + 1, len(runs))}
    aucs = [getattr(r.training_metrics, "auc", r.training_metrics.mse)
            for r in runs]
    print(f"repeatability {path}, {what}: entries that differ "
          f"{json.dumps(pairs)}, AUC (a regression's MSE) {aucs!r}",
          flush=True)
    bad = {p: d for p, d in pairs.items() if any(d.values())}
    if bad:
        raise AssertionError(f"{path} {what}: trains differ {bad}")


def phase_repeatability(fr, path, dev):
    """The same train three times at float32 histograms in one process,
    the first right after the allocator is filled with NaN, then twice at
    'auto' (bf16 masses): every float sum on the path comes in a fixed
    order (no float atomics), so every pair must agree bit for bit in
    every tree's splits and leaf values."""
    poison_allocator(dev)
    runs = [train(fr, 20, path, histogram_precision="float32")
            for _ in range(3)]
    check_repeats(runs, path, "float32 x3 (first after NaN-filling the "
                              "allocator)")
    runs = [train(fr, 20, path) for _ in range(2)]
    check_repeats(runs, path, "'auto' (bf16) x2")


def phase_repeatability_i8(fr):
    """The int8 paths (packed and adaptive, at their own and at the wide
    lane widths, H2O3_HIST_I8=1) each trained twice at 'auto' (bf16, every
    level an integer sum): they must agree bit for bit."""
    for path in ("packed_i8", "adaptive_i8", "packed_wide_i8",
                 "adaptive_wide_i8"):
        runs = [train(fr, 20, path) for _ in range(2)]
        check_repeats(runs, path, "H2O3_HIST_I8=1 at 'auto' x2")


def phase_warm_profile(fr, card, path, cold_trees, ntrees=5, reps=3):
    """Where the time goes: a main path's train again (warm: kernels
    loaded, allocator grown), ``reps`` times plain at 20 trees (the
    loop is host-bound and its time spreads from train to train) and
    once with 5 trees under torch.profiler. Prints the loop times and
    their median, the device time by kernel and the device busy share of
    the whole train() call, and how the first warm retrain's trees
    differ from the cold run's. Returns the median warm 20-tree loop's
    seconds."""
    loops = []
    for i in range(reps):
        warm = train(fr, 20, path)
        if i == 0:
            print(f"repeatability {path}, cold vs warm at 'auto': "
                  f"{split_flips(cold_trees, warm.trees)}", flush=True)
        loops.append(warm.output["training_loop_seconds"])
    w_loop = float(np.median(loops))
    print(f"warm retrain {path}: {fr.nrow} rows, 20 trees, x{reps}: "
          f"training_loop_seconds {loops!r}, median {w_loop!r} (rows/s "
          f"{fr.nrow * 20 / w_loop!r}), AUC {warm.training_metrics.auc!r} "
          f"[{card}]", flush=True)
    del warm
    profiled_train(card, path, lambda: train(fr, ntrees, path), fr.nrow,
                   ntrees)
    return w_loop


def profiled_train(card, what, fn, rows, trees):
    """``fn()`` (a train) under torch.profiler: its loop seconds, the
    train() call's wall, the device busy time and share of that wall,
    the device activities, and the device time of the top 8 kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    loop_s = model.output["training_loop_seconds"]
    by_name, n_dev = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3
            n_dev += e.count
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"warm profile {what}: {rows} rows, {trees} trees: "
          f"training_loop_seconds {loop_s!r} "
          f"(rows/s {rows * trees / loop_s!r}), train() wall "
          f"{wall * 1e3!r} ms, device busy {busy!r} ms "
          f"({busy / (wall * 1e3)!r} of the wall), device activities "
          f"{n_dev} ({n_dev / trees:.1f} a tree), train_profile "
          f"{json.dumps(model.output['train_profile'])} [{card}]",
          flush=True)
    for k, v in top:
        print(f"  device ms {v:10.3f}  {k[:100]}", flush=True)


# ------------------------------------------------------------- XGBoost

# BASELINE config #2: H2OXGBoost on HIGGS-10M at XGBoost's defaults (50
# trees, depth 6, eta 0.3, min_child_weight 1, reg_lambda 1, max_bins
# 256), tree_method "hist" (packed quantile codes, nbins 254, W = 256)
# and "auto" (packed uniform edges, nbins 62, W = 64), with a validation
# frame of HIGGS's own held-out size (UCI keeps the last 500k rows)
XGB_VALID_ROWS = 500_000
XGB_PATHS = {"hist": (254, 256), "auto": (62, 64)}
# train B: early stopping on the validation AUC at H2O's tolerance
XGB_STOP = dict(ntrees=500, stopping_rounds=3, score_tree_interval=5,
                stopping_metric="AUC")


def xgb_train(fr, vfr, **kw):
    """The XGBoost estimator (bernoulli, seed 7) on ``fr`` with ``vfr``
    as its validation frame."""
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
    est = H2OXGBoostEstimator(distribution="bernoulli", seed=7, **kw)
    est.train(y="label", training_frame=fr, validation_frame=vfr)
    return est.model


def xgb_check_launches(launches, built, what):
    """A packed XGBoost train launches six binned_level, one
    binned_route_only and one segment_totals a tree, and nothing else."""
    expected = {k: 0 for k in launches}
    expected.update(binned_level=6 * built, binned_route_only=built,
                    segment_totals=built)
    if launches != expected:
        raise AssertionError(f"{what}: launched {launches}, expected "
                             f"{expected} for {built} trees")


def xgb_check_model(m, tree_method, what):
    """The path the tree method takes, and finite better-than-chance
    training and validation AUCs."""
    n_bins, W = XGB_PATHS[tree_method]
    pc = m.output["packed_codes"]
    if m.n_bins != n_bins or not pc["enabled"] or pc["W"] != W:
        raise AssertionError(f"{what}: n_bins {m.n_bins}, packed_codes "
                             f"{pc}; expected n_bins {n_bins} at W {W}")
    for name, mm in (("training", m.training_metrics),
                     ("validation", m.validation_metrics)):
        if not np.isfinite(mm.auc) or not 0.5 < mm.auc <= 1.0:
            raise AssertionError(f"{what}: {name} AUC {mm.auc} is not a "
                                 f"finite better-than-chance value")


def stop_decisions(scores, rounds, tol, less_is_better):
    """H2O's stopping rule, recomputed here from a scoring history: after
    each entry, whether the mean of the last ``rounds`` scores fails to
    beat the mean of the ``rounds`` before them by ``tol`` relative."""
    out = []
    for i in range(1, len(scores) + 1):
        if i < 2 * rounds:
            out.append(False)
            continue
        recent = float(np.mean(scores[i - rounds:i]))
        prev = float(np.mean(scores[i - 2 * rounds:i - rounds]))
        margin = tol * abs(prev)
        out.append(recent >= prev - margin if less_is_better
                   else recent <= prev + margin)
    return out


def xgb_walk_and_score_ms(m, fr, vfr):
    """On train A's model: the validation walk of one tree over the
    validation rows (packed codes, six gathers) plus its margin update,
    in ms a tree, checked against ``predict`` over all trees; and one
    interval's scoring (deviance and AUC on the device, one copy to the
    host) in ms."""
    import torch
    from types import SimpleNamespace
    from h2o3_tpu_torch.models.distributions import Bernoulli
    from h2o3_tpu_torch.models.gbm import score_entry, valid_walk
    from h2o3_tpu_torch.models.metrics import auc_device
    from h2o3_tpu_torch.models.model_base import (build_training_spec,
                                                  build_validation_spec)
    from h2o3_tpu_torch.ops.hist_adaptive import pick_W
    spec = build_training_spec(fr, "label", classification=True)
    vspec = build_validation_spec(vfr, spec)
    walk = valid_walk(vspec.X, SimpleNamespace(edges=m.edges,
                                               n_bins=m.n_bins),
                      SimpleNamespace(W=pick_W(m.n_bins)), m.max_depth)
    trees = [{k: torch.as_tensor(m.trees[k][t], device=vfr.device)
              for k in ("feat", "split_bin", "na_left", "is_split",
                        "value")} for t in range(m.ntrees_built)]
    vm = torch.full((vfr.nrow,), float(m.f0), device=vfr.device)
    for t in trees:
        vm = vm + walk(t)
    p1 = m.predict(vfr).vec("p1").data
    err = float((torch.sigmoid(vm) - p1).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"validation walk: p1 {err} from predict's")
    walk_ms = time_cuda(lambda: vm + walk(trees[-1]), 20)
    dist = Bernoulli()
    score_ms = time_cuda(lambda: score_entry(vm, vspec, dist, 5,
                                             want_auc=True), 20)
    # the AUC that decides early stopping: the same bits in five calls on
    # the card, and on the CPU
    args = (dist.predict(vm), vspec.y.to(torch.float32), vspec.w)
    bits = {auc_device(*args).view(torch.int32).item() for _ in range(5)}
    cpu = auc_device(*(t.cpu() for t in args)).view(torch.int32).item()
    if bits != {cpu}:
        raise AssertionError(f"auc_device bits: card {bits}, cpu {cpu}")
    return walk_ms, score_ms, err


def phase_xgboost(card, fr, cpu_rows=200_000, cpu_valid_rows=50_000):
    """BASELINE config #2 on the card: the XGBoost estimator on the 10M x
    28 HIGGS-shaped frame ``fr`` with a 500k-row validation frame (another
    seed), the launch counters set to 0 just before each train and read
    just after. Train A: tree_method "hist" at XGBoost's defaults: n_bins
    254 at W = 256, 6 binned_level, 1 binned_route_only and 1
    segment_totals a tree and nothing else, finite better-than-chance
    training and validation AUCs; again twice warm (loop seconds,
    rows/s); the validation walk's ms a tree (checked against predict)
    and the scoring's ms an interval. Train B: tree_method "auto" (n_bins
    62 at W = 64) with early stopping on the validation AUC
    (``XGB_STOP``): it stops, at a multiple of 5 trees, with one history
    entry an interval, where the stopping rule recomputed here from the
    printed history says stop at the last entry and at no earlier one;
    its launches as A's at its tree count. B twice more at float32
    histograms: tree counts, every tree array and every history value bit
    for bit. Card vs CPU at ``cpu_rows`` (validation ``cpu_valid_rows``),
    both tree methods with early stopping at float32 and
    min_child_weight 10: the same tree count, every split equal, the same
    history, |dAUC| <= 1e-6."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    rows = fr.nrow
    Xv, yv, _F = higgs_arrays(XGB_VALID_ROWS, seed=43)
    vfr = frame_of(Xv, yv, "cuda")
    out = {}

    # train A: tree_method="hist" at the defaults
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    a = xgb_train(fr, vfr, tree_method="hist")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    xgb_check_launches(launches, a.ntrees_built, "xgboost hist")
    xgb_check_model(a, "hist", "xgboost hist")
    if a.ntrees_built != 50:
        raise AssertionError(f"xgboost hist built {a.ntrees_built} trees")
    out["hist"] = launches
    loops = [a.output["training_loop_seconds"]]
    for _ in range(2):
        loops.append(xgb_train(fr, vfr, tree_method="hist").output[
            "training_loop_seconds"])
    warm = float(np.median(loops[1:]))
    walk_ms, score_ms, walk_err = xgb_walk_and_score_ms(a, fr, vfr)
    print(f"xgboost hist: {rows}x{fr.ncol - 1} train, {vfr.nrow} "
          f"validation rows, 50 trees depth 6 eta 0.3 min_child_weight 1 "
          f"reg_lambda 1 max_bins 256: n_bins {a.n_bins} packed_codes "
          f"{json.dumps(a.output['packed_codes'])} launches {launches}; "
          f"training AUC {a.training_metrics.auc!r} validation AUC "
          f"{a.validation_metrics.auc!r} logloss "
          f"{a.validation_metrics.logloss!r}; training_loop_seconds cold "
          f"{loops[0]!r} warm {loops[1:]!r} median {warm!r} (rows/s "
          f"{rows * a.ntrees_built / warm!r}); train_profile "
          f"{json.dumps(a.output['train_profile'])}; validation walk "
          f"{walk_ms!r} ms a tree (p1 within {walk_err!r} of predict's); "
          f"scoring {score_ms!r} ms an interval (deviance + AUC over "
          f"{vfr.nrow} rows, one copy to the host; the AUC's bits equal in "
          f"five calls and on the CPU); peak device memory "
          f"{peak:.3f} GiB [{card}]", flush=True)

    # train B: tree_method="auto" with early stopping on the AUC
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    b = xgb_train(fr, vfr, tree_method="auto", **XGB_STOP)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    built = b.ntrees_built
    hist = json.loads(json.dumps(b.scoring_history))
    tol = b.params["stopping_tolerance"]
    rounds = XGB_STOP["stopping_rounds"]
    step = XGB_STOP["score_tree_interval"]
    print(f"xgboost auto, early stopping {json.dumps(XGB_STOP)} at "
          f"stopping_tolerance {tol!r}: {built} trees of "
          f"{XGB_STOP['ntrees']}; training_loop_seconds "
          f"{b.output['training_loop_seconds']!r} (rows/s "
          f"{rows * built / b.output['training_loop_seconds']!r}); "
          f"train_profile {json.dumps(b.output['train_profile'])}; "
          f"validation AUC {b.validation_metrics.auc!r}; launches "
          f"{launches}; scoring history {json.dumps(hist)} [{card}]",
          flush=True)
    xgb_check_launches(launches, built, "xgboost auto")
    xgb_check_model(b, "auto", "xgboost auto")
    if not (built < XGB_STOP["ntrees"] and built % step == 0
            and [e["ntrees"] for e in hist]
            == list(range(step, built + 1, step))):
        raise AssertionError(f"xgboost auto: {built} trees, history at "
                             f"{[e['ntrees'] for e in hist]}")
    rule = stop_decisions([e["auc"] for e in hist], rounds, tol, False)
    if rule != [False] * (len(hist) - 1) + [True]:
        raise AssertionError(f"xgboost auto: the stopping rule on the "
                             f"history says {rule}")
    out["auto"] = launches

    # B again twice at float32: bit for bit
    runs = [xgb_train(fr, vfr, tree_method="auto",
                      histogram_precision="float32", **XGB_STOP)
            for _ in range(2)]
    h0, h1 = runs[0].scoring_history, runs[1].scoring_history
    diffs = tree_diffs(runs[0].trees, runs[1].trees, "split_bin") \
        if runs[0].ntrees_built == runs[1].ntrees_built else "tree counts"
    same_hist = json.dumps(h0) == json.dumps(h1)
    print(f"repeatability xgboost auto with early stopping, float32 x2: "
          f"{runs[0].ntrees_built} and {runs[1].ntrees_built} trees, "
          f"entries that differ {diffs}, histories "
          f"{'equal' if same_hist else 'differ'}, validation AUC "
          f"{runs[0].validation_metrics.auc!r} "
          f"{runs[1].validation_metrics.auc!r}", flush=True)
    if isinstance(diffs, str) or any(diffs.values()) or not same_hist \
            or any(not np.array_equal(runs[0].trees[k], runs[1].trees[k])
                   for k in runs[0].trees):
        raise AssertionError("xgboost auto: float32 trains differ")
    del b, runs

    # card vs CPU at 200k rows, both tree methods, early stopping
    X, y, _F = higgs_arrays(cpu_rows, seed=11)
    Xv, yv, _F = higgs_arrays(cpu_valid_rows, seed=12)
    # min_child_weight 10, as the parity tests' min_rows: at XGBoost's 1
    # the card and the CPU took other splits from tree 11 of 30 on (|dAUC|
    # 2.3e-6), a float32 near-tie decided by each device's order of adds
    stop = dict(ntrees=60, stopping_rounds=2, score_tree_interval=3,
                stopping_metric="AUC", stopping_tolerance=3e-3,
                min_child_weight=10.0, histogram_precision="float32")
    for tree_method in ("hist", "auto"):
        ms = {dev: xgb_train(frame_of(X, y, dev), frame_of(Xv, yv, dev),
                             tree_method=tree_method, **stop)
              for dev in ("cuda", "cpu")}
        mc, mh = ms["cuda"], ms["cpu"]
        keys = ("feat", "split_bin", "na_left")
        same = (mc.ntrees_built == mh.ntrees_built
                and all(np.array_equal(mc.trees[k], mh.trees[k])
                        for k in keys))
        hc, hh = mc.scoring_history, mh.scoring_history
        d_hist = max((abs(a["auc"] - b["auc"]) for a, b in zip(hc, hh)),
                     default=0.0)
        d_auc = max(abs(mc.training_metrics.auc - mh.training_metrics.auc),
                    abs(mc.validation_metrics.auc
                        - mh.validation_metrics.auc))
        print(f"card vs cpu, xgboost {tree_method} {json.dumps(stop)}: "
              f"{cpu_rows} rows, validation {cpu_valid_rows}: trees cuda "
              f"{mc.ntrees_built} cpu {mh.ntrees_built}, splits "
              f"{'equal' if same else 'differ'} "
              f"({split_flips(mc.trees, mh.trees)}), |dAUC| training / "
              f"validation max {d_auc!r}, history |dAUC| max {d_hist!r}, "
              f"validation AUC cuda {mc.validation_metrics.auc!r} cpu "
              f"{mh.validation_metrics.auc!r}", flush=True)
        if not same or d_auc > 1e-6 or d_hist > 1e-6 \
                or [e["ntrees"] for e in hc] != [e["ntrees"] for e in hh]:
            n = min(mc.ntrees_built, mh.ntrees_built)
            diff = np.argwhere(mc.trees["feat"][:n] != mh.trees["feat"][:n])
            at = ("" if not len(diff) else
                  f"; first differing split: tree {diff[0][0]} node "
                  f"{diff[0][1]}, node weight cuda "
                  f"{mc.trees['node_w'][tuple(diff[0])]!r} cpu "
                  f"{mh.trees['node_w'][tuple(diff[0])]!r}")
            raise AssertionError(f"xgboost {tree_method}: card and cpu "
                                 f"differ{at}")
        if mc.ntrees_built >= stop["ntrees"]:
            raise AssertionError(f"xgboost {tree_method}: no early stop "
                                 f"at {cpu_rows} rows")
    return out, a


# ------------------------ 8a-8b. the multinomial GBM and the other families

# the UCI Covertype data (Blackard 1998; H2O's covtype.data): 581,012 rows,
# 10 integer terrain columns (name, least, greatest), 4 wilderness and 40
# soil one-hot columns, and the 7 cover types' shares of the rows
COVTYPE_ROWS = 581_012
COVTYPE_SEED = 23
COVTYPE_TERRAIN = (("Elevation", 1859, 3858), ("Aspect", 0, 360),
                   ("Slope", 0, 66),
                   ("Horizontal_Distance_To_Hydrology", 0, 1397),
                   ("Vertical_Distance_To_Hydrology", -173, 601),
                   ("Horizontal_Distance_To_Roadways", 0, 7117),
                   ("Hillshade_9am", 0, 254), ("Hillshade_Noon", 0, 254),
                   ("Hillshade_3pm", 0, 254),
                   ("Horizontal_Distance_To_Fire_Points", 0, 7173))
COVTYPE_SHARES = (0.3646, 0.4876, 0.0615, 0.0047, 0.0163, 0.0299, 0.0353)
COVTYPE_Y = "Cover_Type"


def covtype_columns(rows, seed=COVTYPE_SEED):
    """A covertype-shaped draw: the 10 terrain columns as integers in
    covertype's ranges, one wilderness area and one soil type a row
    (one-hot, skewed as in the data), and the cover type (codes 0..6 of
    the labels "1".."7") from a seeded function of them: per-class scores
    (elevation strongest), Gumbel noise, and class offsets fitted in a
    few steps so that the shares come out as covertype's. Returns the
    numeric columns {name: float32} and the label codes."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(rows, len(COVTYPE_TERRAIN)))
    cols = {}
    for j, (name, lo, hi) in enumerate(COVTYPE_TERRAIN):
        u = 0.5 + 0.5 * np.tanh(0.8 * z[:, j])
        cols[name] = np.round(lo + u * (hi - lo)).astype(np.float32)
    wild = rng.choice(4, size=rows, p=(0.45, 0.05, 0.44, 0.06))
    soil_p = rng.dirichlet(np.full(40, 0.4))
    soil = rng.choice(40, size=rows, p=soil_p)
    for k in range(4):
        cols[f"Wilderness_Area{k + 1}"] = (wild == k).astype(np.float32)
    for k in range(40):
        cols[f"Soil_Type{k + 1}"] = (soil == k).astype(np.float32)
    K = len(COVTYPE_SHARES)
    A = rng.normal(size=(z.shape[1], K))
    A[0] *= 3.0                                 # elevation leads
    s = (z @ A + 1.5 * rng.normal(size=(4, K))[wild]
         + rng.normal(size=(40, K))[soil])
    s += rng.gumbel(size=(rows, K)) * 1.5
    shares = np.asarray(COVTYPE_SHARES)
    bias = np.log(shares)
    for _ in range(12):
        got = np.bincount(np.argmax(s + bias, axis=1), minlength=K) / rows
        bias += np.log(shares / np.maximum(got, 1e-9))
    y = np.argmax(s + bias, axis=1).astype(np.int32)
    return cols, y


def frame_with_enums(cols, enums, device):
    """A frame of the float32 columns ``cols`` followed by enum columns
    ``enums`` ({name: (codes, domain)})."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.vec import Vec
    fr = h2o.Frame.from_numpy(cols, device=device)
    return h2o.Frame(
        fr.names + list(enums), [fr.vec(n) for n in fr.names] + [
            Vec.from_numpy(c, fr.device, vtype="enum", domain=list(d))
            for c, d in enums.values()])


def covtype_frame(rows, device, seed=COVTYPE_SEED):
    cols, y = covtype_columns(rows, seed)
    domain = [str(k + 1) for k in range(len(COVTYPE_SHARES))]
    return frame_with_enums(cols, {COVTYPE_Y: (y, domain)}, device), y


def gbm_default(fr, y, **kw):
    """H2O's default GBM (50 trees, depth 5, nbins 20, learn rate 0.1,
    min_rows 10, distribution auto; packed codes on the card) with
    ``kw`` on top, seed 7."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    x = kw.pop("x", None)
    est = H2OGradientBoostingEstimator(**{"seed": 7, **kw})
    est.train(x=x, y=y, training_frame=fr)
    return est.model


def launches_of(depth, trees):
    """The launch counts a packed train of ``trees`` trees of ``depth``
    makes: one binned_level a level, one binned_route_only and one
    segment_totals a tree, no other kernel."""
    from h2o3_tpu_torch.ops import kernels
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(binned_level=depth * trees, binned_route_only=trees,
                segment_totals=trees)
    return want


def check_packed_picks(what, model, rows, F, depth):
    """Every level of ``model``'s packed train took a form that sums in a
    fixed order: the form rule (``kernels.binned_level_picks``) names
    the node-grouped or the wide body at each level's shapes, never the
    tiled body (whose float adds follow the schedule)."""
    from h2o3_tpu_torch.ops import kernels
    pc = model.output["packed_codes"]
    if not pc.get("enabled"):
        raise AssertionError(f"{what}: not on the packed path: {pc}")
    W = int(pc["W"])
    picks = [kernels.binned_level_picks(rows, F, W, 2 ** d // 2 if d else 0,
                                        2 ** d) for d in range(depth)]
    if any(p == "tiled" for p in picks):
        raise AssertionError(f"{what}: the form rule picks {picks} at W "
                             f"{W}")
    return W, picks


@contextlib.contextmanager
def recorded_gains(store):
    """The packed grower's split search (``tree._find_splits``, one call
    a level) wrapped: each call appends to ``store`` the chosen gain and
    the parent's score |G^2 / H| of every node, as host arrays."""
    from h2o3_tpu_torch.models import tree
    orig = tree._find_splits

    def call(trip, cfg, col_mask, max_bin=None, mono=None):
        out = orig(trip, cfg, col_mask, max_bin, mono)
        parent = tree._leaf_score2(out[4], out[5], cfg)
        store.append((out[0].cpu().numpy(), parent.abs().cpu().numpy()))
        return out
    tree._find_splits = call
    try:
        yield store
    finally:
        tree._find_splits = orig


def noise_split(gains, t, m, depth):
    """Whether node ``m`` of tree ``t`` split on rounding alone: its gain
    at most 4 float32 ulps of its parent's score. A pure node's children
    score exactly its own score, so in float32 its gain is a few ulps,
    which pass min_split_improvement (1e-5, one ulp of a score past 128),
    and the order of the histogram's adds picks the feature."""
    d = int(np.log2(m + 1))
    gain, parent = gains[t * depth + d]
    n = m - (2 ** d - 1)
    return bool(gain[n] <= 4 * np.spacing(np.float32(parent[n])))


def card_vs_cpu_splits(what, mc, mh, gc, gh, n_trees, depth,
                       max_noise=1, split_key="split_bin"):
    """Every split of ``n_trees`` trees (feature, ``split_key``: the split
    bin or the raw threshold, NA side) equal between the card's model
    ``mc`` and the CPU's ``mh``, except below a node that split on
    rounding alone on both devices (``noise_split``; ``gc``, ``gh`` the
    recorded gains), and at most ``max_noise`` such nodes in the train.
    Returns (trees identical, nodes that differ, noise splits they lie
    below)."""
    same, differ, roots = 0, 0, set()
    M = 2 ** depth - 1                  # the split levels' nodes
    for t in range(n_trees):
        bad = [m for m in range(M) if any(
            mc.trees[k][t][m] != mh.trees[k][t][m]
            for k in ("feat", split_key, "na_left"))]
        same += not bad
        differ += len(bad)
        for m in bad:
            a = m
            while a >= 0 and not (noise_split(gc, t, a, depth)
                                  and noise_split(gh, t, a, depth)):
                a = (a - 1) // 2 if a else -1
            if a < 0:
                raise AssertionError(
                    f"{what}: card vs cpu: tree {t} node {m}: feat "
                    f"{mc.trees['feat'][t][m]} vs {mh.trees['feat'][t][m]}, "
                    f"{split_key} {mc.trees[split_key][t][m]} vs "
                    f"{mh.trees[split_key][t][m]}, not below a noise "
                    f"split")
            roots.add((t, a))
    if len(roots) > max_noise:
        raise AssertionError(f"{what}: card vs cpu: {len(roots)} noise "
                             f"splits with differing nodes at or below "
                             f"them (tree, node) {sorted(roots)}, more "
                             f"than {max_noise}")
    return same, differ, len(roots)


def phase_multinomial(card, rows=COVTYPE_ROWS, ntrees=50, depth=5,
                      cpu_rows=100_000, cpu_iters=5):
    """A1 at full size: the covertype-shaped frame on the card, H2O's
    default GBM (multinomial by the 7-level response; 50 iterations of 7
    trees, depth 5, nbins 20, precision 'auto': bf16 at this size) with
    the launch counters set to 0 just before and read just after. Exact
    launches (5 x 50 x 7 binned_level, 350 binned_route_only and
    segment_totals), every level's form one that sums in a fixed order,
    the training logloss below the class-prior model's, the error below
    the majority class's, every row's probabilities summing to 1 within
    1e-5 and predict's label their argmax. Then card vs CPU at
    ``cpu_rows`` rows, ``cpu_iters`` iterations, float32 (every tree's
    splits equal but below at most one noise split, |dlogloss| <= 1e-4),
    and two float32 trains and a
    second 'auto' train on the full frame, each pair bit for bit."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    fr, y = covtype_frame(rows, "cuda")
    torch.cuda.synchronize()
    K = len(COVTYPE_SHARES)
    F = fr.ncol - 1
    share = np.bincount(y, minlength=K) / rows
    log(f"multinomial: covtype-shaped frame {rows}x{F} on cuda in "
        f"{time.perf_counter() - t0:.2f} s, class shares {share.tolist()}")
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    model = gbm_default(fr, COVTYPE_Y, ntrees=ntrees, max_depth=depth)
    pred = model.predict(fr)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = launches_of(depth, ntrees * K)
    if launches != want or model.ntrees_built != ntrees \
            or model.trees["feat"].shape[0] != ntrees * K:
        raise AssertionError(f"multinomial: launched {launches}, expected "
                             f"{want}; {model.ntrees_built} iterations, "
                             f"{model.trees['feat'].shape[0]} trees")
    W, picks = check_packed_picks("multinomial", model, rows, F, depth)
    m = model.training_metrics
    prior_ll = float(-(share * np.log(np.maximum(share, 1e-9))).sum())
    major_err = float(1.0 - share.max())
    if not (np.isfinite(m.logloss) and m.logloss < prior_ll
            and m.error < major_err):
        raise AssertionError(f"multinomial: logloss {m.logloss} (class "
                             f"prior {prior_ll}), error {m.error} "
                             f"(majority {major_err})")
    dom = list(model.response_domain)
    labels, probs = predict_probs(pred, dom)
    del pred
    if probs.shape != (rows, K) or not np.all(np.isfinite(probs)) \
            or np.abs(probs.sum(axis=1) - 1.0).max() > 1e-5 \
            or not np.array_equal(labels, np.argmax(probs, axis=1)):
        raise AssertionError(
            f"multinomial predict: max |sum p - 1| "
            f"{np.abs(probs.sum(axis=1) - 1.0).max()}, labels off argmax "
            f"{int((labels != np.argmax(probs, axis=1)).sum())}")
    loop_s = model.output["training_loop_seconds"]
    print(f"multinomial_covtype: {rows}x{F} (10 terrain, 4 wilderness, 40 "
          f"soil), {K} classes, H2O's default GBM {ntrees} iterations x "
          f"{K} trees depth {depth} nbins 20 on packed codes W={W} (level "
          f"forms {picks}): training logloss {m.logloss!r} (class prior "
          f"{prior_ll!r}), error {m.error!r} (majority class "
          f"{major_err!r}), mean per-class error "
          f"{m.mean_per_class_error!r}, macro OVR AUC {m.auc!r}, hit "
          f"ratios {m.hit_ratios.tolist()!r}; training_loop_seconds "
          f"{loop_s!r}, rows x iterations / s {rows * ntrees / loop_s!r}, "
          f"trees / s {ntrees * K / loop_s!r}, train_profile "
          f"{json.dumps(model.output['train_profile'])}; launches "
          f"{launches}; peak device memory in the train and predict "
          f"{peak:.3f} GiB [{card}]", flush=True)

    # card vs cpu at cpu_rows, float32 histograms
    models, gains = {}, {}
    for d in ("cuda", "cpu"):
        with recorded_gains(gains.setdefault(d, [])):
            models[d] = gbm_default(
                covtype_frame(cpu_rows, d, seed=COVTYPE_SEED + 1)[0],
                COVTYPE_Y, ntrees=cpu_iters, max_depth=MULTI_CPU_DEPTH,
                histogram_precision="float32")
    mc, mh = models["cuda"], models["cpu"]
    same, differ, noise = card_vs_cpu_splits(
        "multinomial", mc, mh, gains["cuda"], gains["cpu"], cpu_iters * K,
        MULTI_CPU_DEPTH)
    d_ll = abs(mc.training_metrics.logloss - mh.training_metrics.logloss)
    print(f"card vs cpu, multinomial_covtype: {cpu_rows} rows, {cpu_iters} "
          f"iterations x {K} trees, float32: {same} of {cpu_iters * K} "
          f"trees' splits identical; {differ} split nodes differ, each at "
          f"or below one of {noise} nodes that split on rounding alone on "
          f"both devices (gain within 4 float32 ulps of the parent's "
          f"score); logloss cuda {mc.training_metrics.logloss!r} cpu "
          f"{mh.training_metrics.logloss!r} |dlogloss| {d_ll!r} [{card}]",
          flush=True)
    if d_ll > 1e-4:
        raise AssertionError(f"multinomial: card vs cpu: |dlogloss| {d_ll}")
    del models, mc, mh

    # repeatability on the full frame
    kw = dict(ntrees=ntrees, max_depth=depth)
    runs = [gbm_default(fr, COVTYPE_Y, histogram_precision="float32", **kw)
            for _ in range(2)]
    check_repeats(runs, "packed", "multinomial_covtype float32 x2")
    check_repeats([model, gbm_default(fr, COVTYPE_Y, **kw)], "packed",
                  "multinomial_covtype 'auto' (bf16) x2")
    # where the time goes: 2 iterations (14 trees) under the profiler
    profiled_train(card, "multinomial_covtype", lambda: gbm_default(
        fr, COVTYPE_Y, ntrees=2, max_depth=depth), rows, 2 * K)
    return {"model": model, "frame": fr, "launches": launches,
            "loop_s": loop_s}


# the French motor third-party-liability claim-frequency data (CASdatasets
# freMTPL2freq, with its claim amounts from freMTPL2sev): 678,013 policies;
# the levels of its enum columns as in the data
FREMTPL2_ROWS = 678_013
FREMTPL2_SEED = 29
FREMTPL2_ENUMS = {
    "VehBrand": ("B1", "B10", "B11", "B12", "B13", "B14", "B2", "B3", "B4",
                 "B5", "B6"),
    "VehGas": ("Diesel", "Regular"),
    "Area": ("A", "B", "C", "D", "E", "F"),
    "Region": ("R11", "R21", "R22", "R23", "R24", "R25", "R26", "R31",
               "R41", "R42", "R43", "R52", "R53", "R54", "R72", "R73",
               "R74", "R82", "R83", "R91", "R93", "R94"),
}
FREMTPL2_X = ("VehPower", "VehAge", "DrivAge", "BonusMalus", "Density",
              "VehBrand", "VehGas", "Area", "Region")


def fremtpl2_columns(rows, seed=FREMTPL2_SEED):
    """A freMTPL2freq-shaped draw: VehPower 4-15, VehAge 0-100, DrivAge
    18-100, BonusMalus 50-230 (most at 50), Density 1-27,000 (log-normal),
    the four enums (codes over ``FREMTPL2_ENUMS``), Exposure in (0, 1]
    and its log, ClaimNb ~ Poisson(Exposure x 0.10 x exp(f(x))) (f
    centred: about 0.10 claims a policy-year) and ClaimAmount, a gamma
    total of ClaimNb claims (mean about 2,000 each, heavy in shape) on
    the policies with claims, 0 elsewhere. Returns ({numeric column:
    float32}, {enum column: codes})."""
    rng = np.random.default_rng(seed)
    veh_power = rng.choice(np.arange(4, 16), size=rows,
                           p=np.array([17, 18, 22, 20, 10, 5, 3, 2, 1, 1,
                                       0.5, 0.5]) / 100.0)
    veh_age = np.minimum(np.round(rng.gamma(2.0, 3.5, rows)), 100)
    drv_age = np.minimum(np.round(18 + rng.gamma(4.0, 7.0, rows)), 100)
    bm = np.where(rng.random(rows) < 0.6, 50,
                  np.minimum(np.round(50 + rng.gamma(1.5, 15.0, rows)), 230))
    density = np.clip(np.round(np.exp(rng.normal(6.0, 2.0, rows))), 1,
                      27_000)
    enums = {n: rng.integers(0, len(d), rows).astype(np.int32)
             for n, d in FREMTPL2_ENUMS.items()}
    expo = np.where(rng.random(rows) < 0.25, 1.0,
                    np.maximum(rng.beta(0.9, 1.3, rows), 1 / 365))
    f = (0.02 * (bm - 50) + 0.15 * np.log(density) - 0.012 * (drv_age - 45)
         + 0.03 * (veh_power - 6) + 0.2 * (enums["VehGas"] == 1)
         + 0.1 * np.sin(enums["Region"]) - 0.015 * veh_age)
    lam = 0.10 * np.exp(f) / np.exp(f).mean()
    nb = np.minimum(rng.poisson(expo * lam), 16)
    sev_mean = 2000.0 * np.exp(0.004 * (bm - 50) - 0.1 * (enums["Area"]
                                                          - 2.5) / 2.5)
    shape = 1.2
    amount = np.where(nb > 0, rng.gamma(shape * np.maximum(nb, 1),
                                        sev_mean / shape), 0.0)
    num = {"VehPower": veh_power, "VehAge": veh_age, "DrivAge": drv_age,
           "BonusMalus": bm, "Density": density, "Exposure": expo,
           "LogExposure": np.log(expo), "ClaimNb": nb,
           "ClaimAmount": amount}
    return {k: np.asarray(v, np.float32) for k, v in num.items()}, enums


def fremtpl2_frame(rows, device, seed=FREMTPL2_SEED, claims_only=False):
    """The freMTPL2-shaped frame (``claims_only``: the policies with a
    claim, with Severity = ClaimAmount / ClaimNb)."""
    num, enums = fremtpl2_columns(rows, seed)
    if claims_only:
        keep = num["ClaimNb"] > 0
        num = {k: v[keep] for k, v in num.items()}
        enums = {k: v[keep] for k, v in enums.items()}
        num["Severity"] = (num["ClaimAmount"] / num["ClaimNb"]).astype(
            np.float32)
    return frame_with_enums(
        num, {n: (c, FREMTPL2_ENUMS[n]) for n, c in enums.items()}, device)


class FremtplPoisson:
    """A user's poisson family written in torch, registered as
    ``custom:fremtpl2_poisson``: its trees must be the built-in
    poisson's, bit for bit."""
    name = "fremtpl2_poisson"

    def init_f0(self, y, w):
        import torch
        return torch.log(torch.clamp((w * y).sum() / w.sum(), min=1e-9))

    def grad_hess(self, f, y):
        import torch
        mu = torch.exp(f)
        return mu - y, torch.clamp(mu, min=1e-9)

    def predict(self, f):
        import torch
        return torch.exp(f)

    def deviance(self, w, y, mu):
        from h2o3_tpu_torch.models.distributions import Poisson
        return Poisson().deviance(w, y, mu)


# the families' trains: (distribution, response, offset, on the claim
# rows only, the family's own parameters)
FAMILY_TRAINS = {
    "poisson": ("poisson", "ClaimNb", True, False, {}),
    "tweedie": ("tweedie", "ClaimAmount", True, False,
                {"tweedie_power": 1.5}),
    "custom": ("custom:fremtpl2_poisson", "ClaimNb", True, False, {}),
    "gamma": ("gamma", "Severity", False, True, {}),
    "gaussian": ("gaussian", "Severity", False, True, {}),
    "laplace": ("laplace", "Severity", False, True, {}),
    "quantile": ("quantile", "Severity", False, True,
                 {"quantile_alpha": 0.9}),
    "huber": ("huber", "Severity", False, True, {"huber_alpha": 0.9}),
}
LOG_LINK = ("poisson", "tweedie", "custom", "gamma")
# card vs CPU: the training deviances' relative difference (float32 sums
# over 100k rows in two orders; 1e-7 measured on the H100)
FAMILY_DEV_RTOL = 1e-5


def family_train(fr, name, **kw):
    dist, y, offset, _claims, extra = FAMILY_TRAINS[name]
    if offset:
        kw["offset_column"] = "LogExposure"
    return gbm_default(fr, y, x=list(FREMTPL2_X), distribution=dist,
                       **extra, **kw)


def intercept_deviance(model, fr, name):
    """The deviance of the intercept-only model: f0 plus the offset, on
    the model's training rows."""
    import torch
    from h2o3_tpu_torch.models.distributions import get_distribution
    dist_name, y, offset, _claims, extra = FAMILY_TRAINS[name]
    dist = get_distribution(dist_name, extra.get("tweedie_power", 1.5),
                            extra.get("quantile_alpha", 0.5),
                            model.output.get("huber_delta", 1.0))
    yv = fr.vec(y).as_float()
    f = torch.full_like(yv, float(model.f0))
    if offset:
        f = f + fr.vec("LogExposure").as_float()
    return float(dist.deviance(torch.ones_like(yv), yv, dist.predict(f)))


def phase_families(card, rows=FREMTPL2_ROWS, ntrees=50, depth=5,
                   cpu_rows=100_000, cpu_trees=5):
    """A6 at full size: the freMTPL2-shaped frame on the card and H2O's
    default GBM (50 trees, depth 5) on it for poisson on ClaimNb and
    tweedie (power 1.5) on ClaimAmount, both with offset_column =
    log(Exposure), a custom poisson (``FremtplPoisson``) on the poisson
    inputs, and on the policies with claims gamma, gaussian, laplace,
    quantile (alpha 0.9) and huber (alpha 0.9) on the mean claim amount.
    Each with the launch counters set to 0 just before and read just
    after (exact: 5 x 50 binned_level, 50 binned_route_only, 50
    segment_totals), every level's form one that sums in a fixed order,
    the training deviance below the intercept-only model's (f0 plus the
    offset), predictions finite (and >= 0 for the log-link families).
    The custom family's trees equal poisson's bit for bit; predict of
    the poisson model on a frame without the offset column and its
    deploy must raise. Then card vs CPU at ``cpu_rows`` policies,
    ``cpu_trees`` trees, float32, for poisson with the offset, huber and
    quantile: every tree's splits equal (but below at most one noise
    split, ``card_vs_cpu_splits``) and the training deviances within
    ``FAMILY_DEV_RTOL`` of each other. Returns each train's launches by
    name."""
    import torch
    from h2o3_tpu_torch import serve
    from h2o3_tpu_torch.models.distributions import (
        _CUSTOM, register_custom_distribution)
    from h2o3_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    frames = {False: fremtpl2_frame(rows, "cuda"),
              True: fremtpl2_frame(rows, "cuda", claims_only=True)}
    torch.cuda.synchronize()
    pol = frames[False]
    log(f"families: freMTPL2-shaped frame {pol.nrow} policies "
        f"({frames[True].nrow} with claims, "
        f"{float(pol.vec('ClaimNb').as_float().sum()) / float(pol.vec('Exposure').as_float().sum())!r} "
        f"claims a policy-year) on cuda in {time.perf_counter() - t0:.2f} s")
    register_custom_distribution("fremtpl2_poisson", FremtplPoisson())
    out, models = {}, {}
    try:
        for name, (_d, y, offset, claims, _e) in FAMILY_TRAINS.items():
            fr = frames[claims]
            torch.cuda.reset_peak_memory_stats()
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            model = family_train(fr, name, ntrees=ntrees, max_depth=depth)
            pred = model.predict(fr).vec("predict").to_numpy()
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            want = launches_of(depth, ntrees)
            if launches != want or model.ntrees_built != ntrees:
                raise AssertionError(f"{name}: launched {launches}, "
                                     f"expected {want}")
            W, picks = check_packed_picks(name, model, fr.nrow,
                                          len(FREMTPL2_X), depth)
            dev = model.training_metrics.mean_residual_deviance
            dev0 = intercept_deviance(model, fr, name)
            if not (np.isfinite(dev) and dev < dev0):
                raise AssertionError(f"{name}: deviance {dev}, intercept "
                                     f"only {dev0}")
            if not np.all(np.isfinite(pred)) or (
                    name in LOG_LINK and pred.min() < 0):
                raise AssertionError(f"{name}: predictions not finite or "
                                     f"negative: min {np.nanmin(pred)}")
            loop_s = model.output["training_loop_seconds"]
            extra = ({"huber_delta": model.output["huber_delta"]}
                     if "huber_delta" in model.output else {})
            print(f"fremtpl2_{name}: {fr.nrow} rows x {len(FREMTPL2_X)} "
                  f"features, {model.dist_name} on {y}"
                  f"{' with offset log(Exposure)' if offset else ''}, "
                  f"{ntrees} trees depth {depth} on packed codes W={W} "
                  f"(level forms {picks}){' ' + json.dumps(extra) if extra else ''}: "
                  f"f0 {float(model.f0)!r}, training deviance {dev!r} "
                  f"(intercept only {dev0!r}), predict min "
                  f"{float(pred.min())!r} mean {float(pred.mean())!r}; "
                  f"training_loop_seconds {loop_s!r}, rows x trees / s "
                  f"{fr.nrow * ntrees / loop_s!r}; launches {launches}; "
                  f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
                  f"GiB [{card}]", flush=True)
            out[name] = launches
            models[name] = model
        diffs = tree_diffs(models["custom"].trees, models["poisson"].trees,
                           "split_bin")
        if any(diffs.values()) or not np.array_equal(
                models["custom"].f0, models["poisson"].f0):
            raise AssertionError(f"custom poisson differs from poisson: "
                                 f"{diffs}")
        bare = [n for n in pol.names if n != "LogExposure"]
        import h2o3_tpu_torch as h2o
        for what, call in (
                ("predict without the offset column", lambda: models[
                    "poisson"].predict(h2o.Frame(bare, [pol.vec(n)
                                                        for n in bare]))),
                ("deploy", lambda: serve.deploy(
                    "fremtpl2_poisson", model=models["poisson"],
                    buckets=(1, 8), max_batch=8))):
            try:
                call()
            except ValueError as e:
                print(f"fremtpl2_poisson: {what} raises: {e}", flush=True)
            else:
                raise AssertionError(f"fremtpl2_poisson: {what} did not "
                                     f"raise")
        print(f"fremtpl2_custom: {ntrees} trees equal poisson's bit for "
              f"bit", flush=True)
        del models

        # card vs cpu at cpu_rows policies, float32 histograms
        for name in ("poisson", "huber", "quantile"):
            claims = FAMILY_TRAINS[name][3]
            models, gains = {}, {}
            for d in ("cuda", "cpu"):
                with recorded_gains(gains.setdefault(d, [])):
                    models[d] = family_train(
                        fremtpl2_frame(cpu_rows, d, seed=FREMTPL2_SEED + 1,
                                       claims_only=claims), name,
                        ntrees=cpu_trees, max_depth=depth,
                        histogram_precision="float32")
            mc, mh = models["cuda"], models["cpu"]
            same, differ, noise = card_vs_cpu_splits(
                name, mc, mh, gains["cuda"], gains["cpu"], cpu_trees, depth)
            print(f"card vs cpu, fremtpl2_{name}: {cpu_rows} policies"
                  f"{' (the claim rows)' if claims else ''}, {cpu_trees} "
                  f"trees, float32: {same} of {cpu_trees} trees' splits "
                  f"identical; {differ} split nodes differ, each at or "
                  f"below one of {noise} nodes that split on rounding "
                  f"alone on both devices; deviance cuda "
                  f"{mc.training_metrics.mean_residual_deviance!r} cpu "
                  f"{mh.training_metrics.mean_residual_deviance!r} "
                  f"[{card}]", flush=True)
            dc = mc.training_metrics.mean_residual_deviance
            dh = mh.training_metrics.mean_residual_deviance
            if not abs(dc - dh) <= FAMILY_DEV_RTOL * abs(dh):
                raise AssertionError(
                    f"{name}: card vs cpu: deviance {dc} vs {dh}, past "
                    f"rtol {FAMILY_DEV_RTOL}")
    finally:
        _CUSTOM.pop("fremtpl2_poisson", None)
    return out


# --------------------------- 8c-8d. sampling (A4) and the random forest

# the sampling values most often tuned (XGBoost's and H2O's own tuning
# guides): rows and columns at 0.8, the column rate shrinking 0.9 a level
SAMPLING_GBM = dict(sample_rate=0.8, col_sample_rate=0.8,
                    col_sample_rate_change_per_level=0.9)
SAMPLING_XGB = dict(subsample=0.8, colsample_bytree=0.8)
# H2O's DRF at the JAX package's defaults (DRF_DEFAULTS: 50 trees, depth
# 10, nbins 20, min_rows 1, sample_rate 0.632, mtries floor(sqrt F) or
# F // 3), seed 7; the regression forest's rows
DRF_DEPTH = 10
DRF_TREES = 50
DRF_REG_ROWS = 1_000_000
# the regression forest's response, the generator's first feature, is
# independent of the other 27: no forest beats the response's mean, and
# the out-of-bag RMSE must come within this factor of its std. It is
# rounded to eighths: every split of a pure-noise regression is a near
# tie, and with a float response the card's and the CPU's orders of adds
# picked different features at tree 0, node 18 (depth 4); in eighths
# every sum of the response is exact in float32, whatever the order
DRF_REG_RMSE_RATIO = 1.05
DRF_REG_STEP = 0.125


def draws_of(iterations, depth, F, K=1, rate=1.0, col_rate=1.0,
             mtries=0, col_change=1.0, random_grid=False):
    """The threefry launches of a train of ``iterations`` iterations (a
    forest's trees) of K trees: an iteration's row sample where
    ``rate`` < 1 and its column mask where ``col_rate`` < 1; a tree's
    grid phase with ``random_grid``, and one per-node subset draw at each
    level whose subset size (``tree._level_mtries``) is above 0."""
    from h2o3_tpu_torch.models.tree import TreeConfig, _level_mtries
    cfg = TreeConfig(max_depth=depth, n_bins=2, n_features=F, mtries=mtries,
                     col_rate_change=col_change)
    levels = sum(_level_mtries(cfg, d, F) > 0 for d in range(depth))
    return iterations * (int(rate < 1.0) + int(col_rate < 1.0)
                         + K * (int(random_grid) + levels))


def check_launches(what, launches, want):
    from h2o3_tpu_torch.ops import kernels
    full = {k: 0 for k in kernels.LAUNCHES}
    full.update(want)
    if launches != full:
        raise AssertionError(f"{what}: launched {launches}, expected {full}")


def zero_launches():
    from h2o3_tpu_torch.ops import kernels
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0


def card_vs_cpu_recorded(what, fit, frame, n_trees, depth, split_key,
                         metric):
    """``fit(frame(dev))`` on the card and on the CPU (float32
    histograms, the caller's), every split equal under the one-noise-split
    rule (``card_vs_cpu_splits``), and the two models' ``metric`` within
    1e-4. Returns the line's text."""
    models, gains = {}, {}
    for d in ("cuda", "cpu"):
        with recorded_gains(gains.setdefault(d, [])):
            models[d] = fit(frame(d))
    mc, mh = models["cuda"], models["cpu"]
    same, differ, noise = card_vs_cpu_splits(
        what, mc, mh, gains["cuda"], gains["cpu"], n_trees, depth,
        split_key=split_key)
    vc, vh = metric(mc), metric(mh)
    if not abs(vc - vh) <= 1e-4:
        raise AssertionError(f"{what}: card vs cpu: {vc} vs {vh}")
    return (f"{same} of {n_trees} trees' splits identical; {differ} split "
            f"nodes differ, each at or below one of {noise} nodes that "
            f"split on rounding alone on both devices; cuda {vc!r} cpu "
            f"{vh!r}")


def phase_sampling(card, fr, cpu_rows=200_000, cpu_trees=5):
    """A4 on the card (8c), on the 10M x 28 frame ``fr``, each train with
    the launch counters set to 0 just before and read just after: (a) the
    packed GBM (depth 6, 20 trees, seed 7) with ``SAMPLING_GBM``: 120
    binned_level, 20 binned_route_only and segment_totals, and
    threefry_uniform 20 row samples, 20 column masks and a subset a level
    whose size round(28 x 0.9^d) is below 28 (levels 1-5); (b) the
    adaptive GBM (nbins 20) with histogram_type "random": 120
    adaptive_level, 20 adaptive_route_only, 20 grid phases; (c) XGBoost
    hist (50 trees, the 500k-row validation frame of phase 8) with
    ``SAMPLING_XGB``: 300 binned_level, 50 binned_route_only and
    segment_totals, 100 draws. For each: loop seconds, trees/s, launches,
    a better-than-chance AUC; two float32 trains bit for bit; card vs CPU
    at ``cpu_rows`` rows and ``cpu_trees`` trees, float32, every split
    equal under the one-noise-split rule and |dAUC| <= 1e-4. Returns the
    launches by path."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    rows, F = fr.nrow, fr.ncol - 1

    def auc(m):
        return m.training_metrics.auc
    X, y, _F = higgs_arrays(cpu_rows, seed=11)
    Xv, yv, _F = higgs_arrays(XGB_VALID_ROWS, seed=43)
    vfr = frame_of(Xv, yv, "cuda")
    Xcv, ycv, _F = higgs_arrays(cpu_rows // 4, seed=12)
    def packed(f, ntrees=20, **k):
        return train(f, ntrees, "packed", **SAMPLING_GBM, **k)

    def random_grid(f, ntrees=20, **k):
        return train(f, ntrees, "adaptive", histogram_type="random", **k)

    def xgboost(f, vf=vfr, **k):
        return xgb_train(f, vf, tree_method="hist", **SAMPLING_XGB, **k)

    cases = {
        "sampled_packed": dict(
            fit=packed, path="packed", depth=6,
            want=dict(binned_level=120, binned_route_only=20,
                      segment_totals=20,
                      threefry_uniform=draws_of(20, 6, F, rate=0.8,
                                                col_rate=0.8,
                                                col_change=0.9))),
        "random_adaptive": dict(
            fit=random_grid, path="adaptive", depth=6,
            want=dict(adaptive_level=120, adaptive_route_only=20,
                      threefry_uniform=draws_of(20, 6, F,
                                                random_grid=True))),
        "sampled_xgboost_hist": dict(
            fit=xgboost, path="packed", depth=6,
            want=dict(binned_level=300, binned_route_only=50,
                      segment_totals=50,
                      threefry_uniform=draws_of(50, 6, F, rate=0.8,
                                                col_rate=0.8))),
    }
    out = {}
    for name, c in cases.items():
        clock = PhaseClock()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        m = c["fit"](fr)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        check_launches(name, launches, c["want"])
        if not np.isfinite(auc(m)) or not 0.5 < auc(m) <= 1.0:
            raise AssertionError(f"{name}: AUC {auc(m)}")
        loop_s = m.output["training_loop_seconds"]
        print(f"sampling {name}: {rows}x{F}, {m.ntrees_built} trees depth "
              f"{c['depth']}, {json.dumps(m.params.get('sample_rate'))} "
              f"rows, column rates {m.params.get('col_sample_rate')!r} x "
              f"{m.params.get('col_sample_rate_per_tree')!r} (change "
              f"{m.params.get('col_sample_rate_change_per_level')!r} a "
              f"level), histogram_type {m.params.get('histogram_type')}: "
              f"training AUC {auc(m)!r}, training_loop_seconds {loop_s!r}, "
              f"trees/s {m.ntrees_built / loop_s!r}, rows/s "
              f"{rows * m.ntrees_built / loop_s!r}, train_profile "
              f"{json.dumps(m.output['train_profile'])}, launches "
              f"{launches}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
              f"[{card}]", flush=True)
        out[name] = launches
        runs = [c["fit"](fr, histogram_precision="float32")
                for _ in range(2)]
        check_repeats(runs, c["path"], f"{name} float32 x2")
        del runs, m
        clock.lap("train, checks, float32 x2")
        if name == "sampled_xgboost_hist":
            def frame(d):
                return frame_of(X, y, d), frame_of(Xcv, ycv, d)

            def fit(fv, c=c):
                return c["fit"](fv[0], fv[1], ntrees=cpu_trees,
                                max_depth=CPU_DEPTH,
                                histogram_precision="float32")
        else:
            def frame(d):
                return frame_of(X, y, d)

            def fit(f, c=c):
                return c["fit"](f, ntrees=cpu_trees, max_depth=CPU_DEPTH,
                                histogram_precision="float32")
        text = card_vs_cpu_recorded(name, fit, frame, cpu_trees, CPU_DEPTH,
                                    PATHS[c["path"]]["split_key"], auc)
        clock.lap(f"card vs cpu, {cpu_trees} trees")
        print(f"card vs cpu, sampling {name}: {cpu_rows} rows, {cpu_trees} "
              f"trees, float32: {text} (AUC) [{card}]; seconds "
              f"{json.dumps(clock.laps)}", flush=True)
    return out


def as_classes(fr, y):
    """``fr`` with its response ``y`` as an enum column (a numeric
    response trains a regression forest)."""
    import h2o3_tpu_torch as h2o
    return h2o.Frame(fr.names, [fr.vec(n).asfactor() if n == y
                                else fr.vec(n) for n in fr.names])


def drf_train(fr, y, **kw):
    """H2O's DRF at the JAX package's defaults (and ``kw``), seed 7."""
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    est = H2ORandomForestEstimator(**{"seed": 7, "ntrees": DRF_TREES,
                                       **kw})
    est.train(y=y, training_frame=fr)
    return est.model


def oob_line(m, nclasses):
    """The out-of-bag metrics as printed: AUC and logloss (binomial),
    logloss, error and mean per-class error (multinomial), RMSE
    (regression)."""
    t = m.training_metrics
    if nclasses == 2:
        return {"auc": t.auc, "logloss": t.logloss, "nobs": t.nobs}
    if nclasses > 2:
        return {"logloss": t.logloss, "error": t.error,
                "mean_per_class_error": t.mean_per_class_error,
                "nobs": t.nobs}
    return {"rmse": t.rmse, "mse": t.mse, "nobs": t.nobs}


def drf_case(card, name, fr, y, K, nclasses, cpu_frame, cpu_trees,
             ntrees=DRF_TREES, repeat_trees=None, profile_trees=5):
    """One forest at the defaults on the card with the launch counters
    set to 0 just before and read just after (10 binned_level a tree, one
    binned_route_only and segment_totals a tree, threefry_uniform one row
    sample a forest tree and a subset draw a level a tree), every level's
    form one that sums in a fixed order, predict finite and of its shape,
    the out-of-bag metrics better than the trivial model's (regression:
    within ``DRF_REG_RMSE_RATIO`` of the response's std); two float32
    trains of ``repeat_trees`` trees bit for bit; card vs CPU on
    ``cpu_frame(dev)`` at ``cpu_trees`` forest trees, float32; a
    profiled train() of ``profile_trees`` forest trees. Prints the
    seconds of each step. Returns (model, launches, predict frame)."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    rows, F = fr.nrow, fr.ncol - 1
    clock = PhaseClock()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    m = drf_train(fr, y, ntrees=ntrees)
    pred = m.predict(fr)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    T = ntrees * K
    mt = m.output["mtries"]
    check_launches(name, launches, dict(
        binned_level=DRF_DEPTH * T, binned_route_only=T, segment_totals=T,
        threefry_uniform=draws_of(ntrees, DRF_DEPTH, F, K, rate=0.632,
                                  mtries=mt)))
    W, picks = check_packed_picks(name, m, rows, F, DRF_DEPTH)
    oob = oob_line(m, nclasses)
    if not m.output["oob_metrics"] or not all(
            np.isfinite(v) for v in oob.values()):
        raise AssertionError(f"{name}: out-of-bag metrics {oob}, "
                             f"{m.output['oob_metrics']}")
    yh = fr.vec(y).to_numpy()
    if nclasses == 2:
        ok = oob["auc"] > 0.5
        out = pred.vec(pred.names[-1]).to_numpy()[:, None]
    elif nclasses > 2:
        share = np.bincount(yh[yh >= 0].astype(int),
                            minlength=nclasses) / rows
        ok = oob["error"] < 1.0 - share.max()
        out = np.stack([pred.vec(n).to_numpy() for n in pred.names[1:]], 1)
    else:
        ok = oob["rmse"] < DRF_REG_RMSE_RATIO * np.nanstd(yh)
        out = pred.vec("predict").to_numpy()[:, None]
    if not ok or out.shape[0] != rows or not np.all(np.isfinite(out)):
        raise AssertionError(f"{name}: out-of-bag {oob}, predict shape "
                             f"{out.shape}, finite {np.isfinite(out).all()}")
    loop_s = m.output["training_loop_seconds"]
    task = f"{nclasses} classes" if nclasses > 1 else "regression"
    print(f"drf {name}: {rows}x{F}, {task}, {ntrees} "
          f"trees x {K} depth {DRF_DEPTH} nbins 20 sample_rate 0.632 "
          f"mtries {mt} on packed codes W={W} (level forms {picks}): "
          f"out-of-bag {json.dumps(oob)}; training_loop_seconds {loop_s!r}, "
          f"ms a tree {loop_s * 1e3 / T!r}, trees/s {T / loop_s!r}, "
          f"train_profile {json.dumps(m.output['train_profile'])}; "
          f"launches {launches}; peak device memory in the train and "
          f"predict {peak:.3f} GiB [{card}]", flush=True)
    clock.lap("train, predict, checks")
    repeat_trees = repeat_trees or ntrees
    runs = [drf_train(fr, y, ntrees=repeat_trees,
                      histogram_precision="float32") for _ in range(2)]
    check_repeats(runs, "packed", f"drf {name} float32 x2, {repeat_trees} "
                                  f"trees")
    del runs
    clock.lap(f"float32 x2, {repeat_trees} trees")
    metric = ((lambda mm: mm.training_metrics.auc) if nclasses == 2 else
              (lambda mm: mm.training_metrics.logloss) if nclasses > 2 else
              (lambda mm: mm.training_metrics.rmse
               / float(np.nanstd(yh))))
    text = card_vs_cpu_recorded(
        name, lambda f: drf_train(f, y, ntrees=cpu_trees,
                                  max_depth=DRF_CPU_DEPTH,
                                  histogram_precision="float32"),
        cpu_frame, cpu_trees * K, DRF_CPU_DEPTH, "split_bin", metric)
    what = {2: "AUC", 1: "RMSE / std"}.get(nclasses, "logloss")
    print(f"card vs cpu, drf {name}: {cpu_trees} trees x {K}, float32: "
          f"{text} (out-of-bag {what}) [{card}]", flush=True)
    clock.lap(f"card vs cpu, {cpu_trees} trees")
    profiled_train(card, f"drf {name}", lambda: drf_train(
        fr, y, ntrees=profile_trees), rows, profile_trees * K)
    clock.lap(f"profile, {profile_trees} trees")
    print(f"drf {name} seconds: {json.dumps(clock.laps)}", flush=True)
    return m, launches, pred


def drf_serve(card, m, fr, pred):
    """``m`` deployed at buckets 1 and 64: each bucket's replay against
    the eager predict bit for bit, and 64 rows of ``fr`` served (rows
    and columnar) bit-equal to ``pred``, with no capture and no eager
    predict after deploy."""
    from h2o3_tpu_torch import serve
    names = m.feature_names
    idx = np.sort(np.random.default_rng(SERVE_SEED).choice(
        fr.nrow, 64, replace=False))
    dom = list(m.response_domain)
    labels, probs = predict_probs(pred, dom)
    dep = serve.deploy("serve_drf", model=m, buckets=(1, 64), max_batch=64)
    try:
        bucket_record(card, "drf_higgs", dep, fr.rows(idx).as_matrix(names),
                      reps=(20, 3), activities_once=True)
        caps, eager = dep.scorer.captures, dep.scorer.eager_calls
        served_vs_predicted("drf_higgs", dep, host_rows(fr, names, idx),
                            labels[idx], probs[idx], dom)
        if (dep.scorer.captures, dep.scorer.eager_calls) != (caps, eager):
            raise AssertionError("serve drf_higgs: served rows captured or "
                                 "ran an eager predict")
    finally:
        serve.undeploy("serve_drf")
    print(f"serve drf_higgs: 64 rows served (rows and columnar) bit-equal "
          f"to predict over the whole frame, buckets 1 and 64 [{card}]",
          flush=True)


def phase_drf(card, fr, cov_fr, cpu_rows=200_000, cpu_trees=5,
              repeat_trees=20, cov_trees=20, cov_cpu_rows=50_000,
              cov_cpu_trees=1, cov_repeat_trees=5):
    """The random forest on the card (8d), at the JAX package's DRF
    defaults (``drf_case``), the float32 repeats at ``repeat_trees``
    trees: (a) drf_higgs, binomial on the 10M x 28 frame ``fr`` (its
    label as classes; mtries 5), deployed at buckets 1 and 64
    (``drf_serve``); (b) drf_covtype, the multinomial on phase 8a's
    covertype-shaped frame ``cov_fr`` (7 classes, ``cov_trees`` forest
    trees, mtries 7; card vs CPU at ``cov_cpu_rows`` rows and
    ``cov_cpu_trees`` forest tree, the repeat at ``cov_repeat_trees``,
    the profile at 1); (c) drf_regression, the
    HIGGS-shaped frame's first feature (in steps of ``DRF_REG_STEP``) as
    the response of the other 27 at 1M rows (mtries 9). Returns {name:
    launches}."""
    Xc, yc, _F = higgs_arrays(cpu_rows, seed=11)
    hfr = as_classes(fr, "label")
    out = {}
    m, out["drf_higgs"], pred = drf_case(
        card, "drf_higgs", hfr, "label", 1, 2,
        lambda d: as_classes(frame_of(Xc, yc, d), "label"), cpu_trees,
        repeat_trees=repeat_trees)
    drf_serve(card, m, hfr, pred)
    del m, pred, hfr
    _m, out["drf_covtype"], _p = drf_case(
        card, "drf_covtype", cov_fr, COVTYPE_Y, len(COVTYPE_SHARES),
        len(COVTYPE_SHARES),
        lambda d: covtype_frame(cov_cpu_rows, d, seed=COVTYPE_SEED + 1)[0],
        cov_cpu_trees, cov_trees, cov_repeat_trees, profile_trees=1)
    del _m, _p
    X, _y, _F = higgs_arrays(DRF_REG_ROWS)

    def reg_frame(Xr, d):
        import h2o3_tpu_torch as h2o
        cols = {f"f{i}": Xr[:, i] for i in range(1, Xr.shape[1])}
        cols["y"] = (np.round(Xr[:, 0] / DRF_REG_STEP)
                     * DRF_REG_STEP).astype(np.float32)
        return h2o.Frame.from_numpy(cols, device=d)
    _m, out["drf_regression"], _p = drf_case(
        card, "drf_regression", reg_frame(X, "cuda"), "y", 1, 1,
        lambda d: reg_frame(Xc, d), cpu_trees, repeat_trees=repeat_trees)
    return out


# ------------------------------------------------- A3, A5, A7 (8e-8g)

# 8e: the packed GBM's checkpoints every CKPT_INTERVAL of CKPT_TREES
# trees, resumed at CKPT_RESUME; the forest's every DRF_CKPT_INTERVAL
CKPT_TREES, CKPT_INTERVAL, CKPT_RESUME = 20, 5, 10
DRF_CKPT_TREES, DRF_CKPT_INTERVAL = 20, 10
# 8f: two features rising and two falling with the label's logit (f0 and
# f1 as the generator has them; f4's sin and f3's product bind), and
# three interaction groups covering every feature
MONOTONE = {"f0": 1, "f4": 1, "f1": -1, "f3": -1}
GROUPS = ([f"f{i}" for i in range(4)], [f"f{i}" for i in range(4, 16)],
          [f"f{i}" for i in range(16, 28)])
SWEEP_ROWS, SWEEP_POINTS = 1000, 64
# 8g: the folds, the balanced covtype GBM's iterations, the calibration
# frame's rows
CV_FOLDS, BALANCE_TREES, CAL_ROWS = 5, 20, 500_000


def same_trees_bits(what, a, b):
    """Every tree entry of two models equal in every bit (values and
    node weights as their bits)."""
    bad = {}
    for k in ("feat", "thr", "na_left", "is_split", "value", "node_w"):
        x, y = np.asarray(a.trees[k]), np.asarray(b.trees[k])
        if x.dtype == np.float32:
            x, y = x.view(np.uint32), y.view(np.uint32)
        if x.shape != y.shape or (x != y).any():
            bad[k] = int((x != y).sum()) if x.shape == y.shape else "shape"
    if bad or a.ntrees_built != b.ntrees_built:
        raise AssertionError(f"{what}: trees differ {bad}, "
                             f"{a.ntrees_built} vs {b.ntrees_built} trees")


def ckpt_case(card, name, fit, split_key, want, ntrees, interval, resume,
              metric):
    """One checkpoint case (8e): ``fit(**kw)`` without checkpoints, with
    ``in_training_checkpoints_dir`` every ``interval`` trees (the
    artifacts at each commit of the JAX loop's cadence), and resumed from
    ``<key>_t<resume>.zip`` through ``checkpoint=<path>``; the last with
    the launch counters set to 0 just before and read just after (``want``
    for its ``ntrees - resume`` trees). The checkpointing and the resumed
    trains must equal the plain one in every bit of every tree and in
    ``metric``. Prints the loops off and on, each commit's seconds and
    bytes, the load's seconds. Returns the resumed train's launches."""
    import shutil
    import tempfile
    import torch
    from h2o3_tpu_torch import persist
    from h2o3_tpu_torch.ops import kernels
    d = tempfile.mkdtemp(prefix="h2o3_ckpt_")
    try:
        off = fit()
        on = fit(model_id=name, in_training_checkpoints_dir=d,
                 in_training_checkpoints_tree_interval=interval)
        names = sorted(os.listdir(d))
        commits = on.output["checkpoints"]
        t0 = time.perf_counter()
        prior = persist.load_model(os.path.join(d, f"{name}_t{resume}.zip"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if prior.ntrees_built != resume:
            raise AssertionError(f"{name}: t{resume} holds "
                                 f"{prior.ntrees_built} trees")
        del prior
        zero_launches()
        res = fit(checkpoint=os.path.join(d, f"{name}_t{resume}.zip"))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check_launches(f"{name} resumed", launches, want)
    for what, m in (("checkpointing", on), ("resumed", res)):
        same_trees_bits(f"{name} {what} vs plain", m, off)
        if metric(m) != metric(off):
            raise AssertionError(f"{name} {what}: {metric(m)!r} vs "
                                 f"{metric(off)!r}")
    print(f"checkpoints {name}: {ntrees} trees, every {interval}: "
          f"artifacts {names}; commits (trees, seconds, bytes) "
          f"{[(c['trees'], c['seconds'], c['bytes']) for c in commits]}; "
          f"load t{resume} {load_s!r} s; loop seconds off "
          f"{off.output['training_loop_seconds']!r} on "
          f"{on.output['training_loop_seconds']!r} resumed "
          f"{res.output['training_loop_seconds']!r} ({ntrees - resume} "
          f"trees); checkpointing and resumed trains bit-equal to the "
          f"plain one in every tree and in {metric(off)!r}; resumed "
          f"launches {launches} [{card}]", flush=True)
    return launches


def phase_checkpoints(card, fr):
    """A3 on the card (8e), on the 10M x 28 frame ``fr``: the packed GBM
    (``CKPT_TREES`` trees, checkpoints every ``CKPT_INTERVAL``, resumed
    at ``CKPT_RESUME``), the same with sample_rate 0.8 (the row draws of
    the resumed trees keyed by their index in the whole model), and
    drf_higgs (``DRF_CKPT_TREES`` trees, every ``DRF_CKPT_INTERVAL``,
    resumed at the first; its out-of-bag sums resumed: the OOB AUC bit
    for bit). Returns the resumed trains' launches by path."""
    F = fr.ncol - 1
    hfr = as_classes(fr, "label")
    new = CKPT_TREES - CKPT_RESUME
    packed_want = dict(binned_level=6 * new, binned_route_only=new,
                       segment_totals=new)
    drf_new = DRF_CKPT_TREES - DRF_CKPT_INTERVAL
    out = {}

    def auc(m):
        return m.training_metrics.auc
    out["resumed_packed"] = ckpt_case(
        card, "ckpt_packed", lambda **k: train(fr, CKPT_TREES, "packed",
                                               **k),
        "split_bin", packed_want, CKPT_TREES, CKPT_INTERVAL, CKPT_RESUME,
        auc)
    out["resumed_sampled"] = ckpt_case(
        card, "ckpt_sampled", lambda **k: train(fr, CKPT_TREES, "packed",
                                                sample_rate=0.8, **k),
        "split_bin", dict(packed_want, threefry_uniform=draws_of(
            new, 6, F, rate=0.8)), CKPT_TREES, CKPT_INTERVAL, CKPT_RESUME,
        auc)
    out["resumed_drf_higgs"] = ckpt_case(
        card, "ckpt_drf", lambda **k: drf_train(hfr, "label",
                                                ntrees=DRF_CKPT_TREES, **k),
        "split_bin", dict(
            binned_level=DRF_DEPTH * drf_new, binned_route_only=drf_new,
            segment_totals=drf_new, threefry_uniform=draws_of(
                drf_new, DRF_DEPTH, F, rate=0.632, mtries=5)),
        DRF_CKPT_TREES, DRF_CKPT_INTERVAL, DRF_CKPT_INTERVAL, auc)
    return out


def tree_paths(trees):
    """Each tree's root-to-leaf sets of split features."""
    feat, split = trees["feat"], trees["is_split"]
    out = []
    for t in range(feat.shape[0]):
        stack = [(0, frozenset())]
        while stack:
            node, used = stack.pop()
            if node >= feat.shape[1] or not split[t, node]:
                if used:
                    out.append(used)
                continue
            u = used | {int(feat[t, node])}
            stack += [(2 * node + 1, u), (2 * node + 2, u)]
    return out


def monotone_sweep(model, fr, names):
    """``SWEEP_ROWS`` rows of ``fr`` with each constrained feature swept
    over ``SWEEP_POINTS`` points from its minimum to its maximum there,
    scored on the card: the largest step against the feature's direction
    of each (<= 1e-5 required)."""
    import h2o3_tpu_torch as h2o
    import torch
    from h2o3_tpu_torch.frame.vec import Vec
    X = fr.rows(np.arange(SWEEP_ROWS)).as_matrix(names)
    worst = {}
    for col, sign in MONOTONE.items():
        j = names.index(col)
        grid = torch.linspace(float(X[:, j].min()), float(X[:, j].max()),
                              SWEEP_POINTS, device=X.device)
        Xs = X.repeat_interleave(SWEEP_POINTS, dim=0)
        Xs[:, j] = grid.repeat(SWEEP_ROWS)
        sweep = h2o.Frame(names, [Vec(Xs[:, i].contiguous())
                                  for i in range(len(names))])
        p1 = model.predict(sweep).vec("p1").data.reshape(SWEEP_ROWS,
                                                         SWEEP_POINTS)
        against = -sign * torch.diff(p1.double(), dim=1)
        worst[col] = float(against.max())
        if worst[col] > 1e-5:
            raise AssertionError(f"monotone {col} ({sign:+d}): a step of "
                                 f"{worst[col]!r} against its direction")
    return worst


def phase_constraints(card, fr, cpu_rows=200_000, cpu_trees=5):
    """A5 on the card (8f): the packed GBM at full width (20 trees, depth
    6) with ``MONOTONE`` and ``GROUPS``, the launch counters set to 0
    just before and read just after (120 binned_level, 20
    binned_route_only and segment_totals); the monotone property on the
    card (``monotone_sweep``) and every root-to-leaf path within one
    group; then card vs CPU at ``cpu_rows`` rows and ``cpu_trees``
    trees, float32, on the packed, adaptive and global growers, every
    split equal under the one-noise-split rule. Returns the launches."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    kw = dict(monotone_constraints=MONOTONE,
              interaction_constraints=[list(g) for g in GROUPS])
    names = [f"f{i}" for i in range(fr.ncol - 1)]
    zero_launches()
    m = train(fr, 20, "packed", **kw)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("constrained_packed", launches, launches_of(6, 20))
    free = train(fr, 20, "packed")
    groups = [{names.index(c) for c in g} for g in GROUPS]
    paths = tree_paths(m.trees)
    mixed = [sorted(p) for p in paths if not any(p <= g for g in groups)]
    if mixed or not paths:
        raise AssertionError(f"constraints: {len(mixed)} of {len(paths)} "
                             f"paths mix groups, first {mixed[:3]}")
    worst = monotone_sweep(m, fr, names)
    loop_s = m.output["training_loop_seconds"]
    print(f"constraints: {fr.nrow}x{len(names)} packed GBM depth 6, 20 "
          f"trees, monotone {json.dumps(MONOTONE)}, {len(GROUPS)} "
          f"interaction groups: training AUC {m.training_metrics.auc!r} "
          f"(unconstrained {free.training_metrics.auc!r}); "
          f"training_loop_seconds {loop_s!r} (unconstrained "
          f"{free.output['training_loop_seconds']!r}), ms a tree "
          f"{loop_s * 1e3 / 20!r}; largest step against each direction "
          f"over {SWEEP_ROWS} rows x {SWEEP_POINTS} points "
          f"{json.dumps(worst)}; {len(paths)} root-to-leaf paths, each "
          f"within one group; launches {launches} [{card}]", flush=True)
    del m, free
    X, y, _F = higgs_arrays(cpu_rows, seed=11)

    def auc(mm):
        return mm.training_metrics.auc
    for path, extra in (("packed", {}), ("adaptive", {}),
                        ("global", dict(nbins=300))):
        text = card_vs_cpu_recorded(
            f"constrained {path}",
            lambda f, path=path, extra=extra: train(
                f, cpu_trees, path, histogram_precision="float32",
                max_depth=CPU_DEPTH, **extra, **kw),
            lambda d: frame_of(X, y, d), cpu_trees, CPU_DEPTH,
            PATHS[path]["split_key"], auc)
        print(f"card vs cpu, constrained {path}: {cpu_rows} rows, "
              f"{cpu_trees} trees, float32: {text} (AUC) [{card}]",
              flush=True)
    return launches


def logloss_of(p1, y):
    p = np.clip(np.asarray(p1, np.float64), 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def phase_cv(card, fr, cov_fr):
    """A7 on the card (8g). (a) The packed GBM (20 trees, depth 6) with
    nfolds ``CV_FOLDS`` on the 10M x 28 frame ``fr``, the launch
    counters set to 0 just before and read just after (the main model
    and each fold's: 6 x 120 binned_level, 6 x 20 binned_route_only and
    segment_totals): CV AUC and logloss, each fold's seconds and its
    ``Frame.rows`` seconds, one fold's training rows gathered on the
    host against the card's gather (bit-equal), each fold's holdout
    against its model's ``predict`` on its rows (bit-equal). (b)
    balance_classes on the covertype-shaped frame ``cov_fr`` (H2O's
    default GBM, ``BALANCE_TREES`` iterations): the prior class
    distribution as the frame's shares, the balanced one uniform, 512
    served rows bit-equal to ``predict`` with the correction. (c) Platt
    and isotonic calibration of the packed GBM on a ``CAL_ROWS``-row
    calibration frame: the calibrated columns' logloss beside the raw
    one (Platt's no worse). Returns the launches by path."""
    import torch
    from h2o3_tpu_torch import serve
    from h2o3_tpu_torch.ops import kernels
    out = {}
    clock = PhaseClock()
    zero_launches()
    m = train(fr, 20, "packed", nfolds=CV_FOLDS)
    torch.cuda.synchronize()
    out["cv_packed"] = dict(kernels.LAUNCHES)
    check_launches("cv_packed", out["cv_packed"],
                   launches_of(6, 20 * (CV_FOLDS + 1)))
    clock.lap("cv train")
    fold = m.output["cv_fold_assignment"]
    ho = m.output["cross_validation_holdout_predictions"]
    for fid, fm in enumerate(m.output["cross_validation_models"]):
        idx = np.nonzero(fold == fid)[0]
        p1 = fm.predict(fr.rows(idx)).vec("p1").to_numpy()
        if p1.view(np.uint32).tolist() != ho[idx, 1].view(
                np.uint32).tolist():
            raise AssertionError(f"cv fold {fid}: holdout differs from the "
                                 f"fold model's predict")
    clock.lap("holdout vs fold predict")
    mask = fold != 0
    t0 = time.perf_counter()
    dev_rows = fr.rows(mask)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_rows_fr = fr.rows_host(mask)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    diff = frames_differ(dev_rows, host_rows_fr)
    if diff:
        raise AssertionError(f"Frame.rows on the card vs the host gather: "
                             f"{diff}")
    del dev_rows, host_rows_fr
    clock.lap("rows card vs host")
    cvm = m.cross_validation_metrics
    prof = m.output["cross_validation_profile"]
    if not 0.5 < cvm.auc <= m.training_metrics.auc or cvm.nobs != fr.nrow:
        raise AssertionError(f"cv: AUC {cvm.auc} (training "
                             f"{m.training_metrics.auc}), nobs {cvm.nobs}")
    print(f"cross-validation: {fr.nrow}x{fr.ncol - 1} packed GBM, 20 "
          f"trees, nfolds {CV_FOLDS} (random assignment, seed 7): CV AUC "
          f"{cvm.auc!r} logloss {cvm.logloss!r} (training AUC "
          f"{m.training_metrics.auc!r}); main loop "
          f"{m.output['training_loop_seconds']!r} s; folds (rows_s, "
          f"train_s, predict_s) "
          f"{[(p['rows_s'], p['train_s'], p['predict_s']) for p in prof]}; "
          f"Frame.rows of fold 0's training rows on the card {dev_s!r} s, "
          f"through the host {host_s!r} s, bit-equal; launches "
          f"{out['cv_packed']}; seconds {json.dumps(clock.laps)} [{card}]",
          flush=True)
    del m
    # (b) balance_classes
    zero_launches()
    bm = gbm_default(cov_fr, COVTYPE_Y, ntrees=BALANCE_TREES,
                     balance_classes=True)
    torch.cuda.synchronize()
    out["balanced_covtype"] = dict(kernels.LAUNCHES)
    K = len(COVTYPE_SHARES)
    check_launches("balanced_covtype", out["balanced_covtype"],
                   launches_of(5, BALANCE_TREES * K))
    yc = cov_fr.vec(COVTYPE_Y).to_numpy()
    share = np.bincount(yc[yc >= 0], minlength=K) / (yc >= 0).sum()
    prior_d = np.asarray(bm.output["prior_class_dist"])
    model_d = np.asarray(bm.output["model_class_dist"])
    if np.abs(prior_d - share).max() > 1e-12 \
            or np.abs(model_d - 1.0 / K).max() > 1e-9:
        raise AssertionError(f"balance: prior {prior_d} vs shares {share}, "
                             f"model {model_d}")
    names = bm.feature_names
    idx = np.sort(np.random.default_rng(SERVE_SEED).choice(
        cov_fr.nrow, 512, replace=False))
    dom = list(bm.response_domain)
    labels, probs = predict_probs(bm.predict(cov_fr), dom)
    dep = serve.deploy("serve_balanced", model=bm, buckets=(1, 64, 512),
                       max_batch=512)
    try:
        served_vs_predicted("balanced", dep, host_rows(cov_fr, names, idx),
                            labels[idx], probs[idx], dom)
    finally:
        serve.undeploy("serve_balanced")
    print(f"balance_classes: covtype {cov_fr.nrow}x{len(names)}, {K} "
          f"classes, {BALANCE_TREES} iterations: prior class distribution "
          f"{prior_d.tolist()!r}, balanced {model_d.tolist()!r}; training "
          f"logloss {bm.training_metrics.logloss!r} (balanced weights); "
          f"loop {bm.output['training_loop_seconds']!r} s; 512 served rows "
          f"bit-equal to predict with the correction; launches "
          f"{out['balanced_covtype']} [{card}]", flush=True)
    del bm
    clock.lap("balance")
    # (c) calibration
    Xc, ycal, _F = higgs_arrays(CAL_ROWS, seed=44)
    cal_fr = frame_of(Xc, ycal, "cuda")
    lines = []
    for method in ("PlattScaling", "IsotonicRegression"):
        zero_launches()
        cm = train(fr, 20, "packed", calibrate_model=True,
                   calibration_frame=cal_fr, calibration_method=method)
        pred = cm.predict(cal_fr)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        check_launches(f"calibrated {method}", launches, launches_of(6, 20))
        out[f"calibrated_{cm.output['calibration']['method']}"] = launches
        p1 = pred.vec("p1").to_numpy()
        q1 = pred.vec("cal_p1").to_numpy()
        if pred.names[-2:] != ["cal_p0", "cal_p1"] or not np.all(
                np.isfinite(q1)) or q1.min() < 0 or q1.max() > 1:
            raise AssertionError(f"calibration {method}: columns "
                                 f"{pred.names}, cal_p1 in "
                                 f"[{q1.min()}, {q1.max()}]")
        raw, cal = logloss_of(p1, ycal), logloss_of(q1, ycal)
        if method == "PlattScaling" and cal > raw + 1e-6:
            raise AssertionError(f"Platt: calibrated logloss {cal} above "
                                 f"the raw {raw}")
        c = cm.output["calibration"]
        lines.append(f"{c['method']} "
                     + (f"a {c['a']!r} b {c['b']!r}" if "a" in c
                        else f"{len(c['tx'])} knots")
                     + f": logloss cal_p1 {cal!r} vs p1 {raw!r}")
        del cm, pred
    clock.lap("calibration")
    print(f"calibration: packed GBM, 20 trees, on a {CAL_ROWS}-row frame: "
          f"{'; '.join(lines)}; seconds {json.dumps(clock.laps)} [{card}]",
          flush=True)
    return out


def phase_deep_record(dev, rows=10_000_000, F=28, W=32):
    """The packed kernels at the forest's deep levels, 10M x 28 int8
    codes at W = 32 (nbins 20), bf16-rounded masses: binned_level in the
    form the kernel picks at N = 64, 128, 256, 512 (each against its
    plain version: nid bit-equal, every bin within the float tolerance
    of the float64 plain version; five launches with the same bits; the
    time, the bound and one ``index_add_``), binned_route_only from
    n_prev = 512 into 1024 leaves (bit-equal) and segment_totals over
    1024 leaves (within the float tolerance, five launches bit-equal;
    index_add_ beside it). Returns the rows to add to the kernels'
    records: {name: {...}}."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.common import segment_totals_plain
    from h2o3_tpu_torch.ops.hist_adaptive import (binned_level_plain,
                                                  binned_route_only_plain)
    from h2o3_tpu_torch import tools
    level = {}
    for N in (64, 128, 256, 512):
        inp = level_inputs(rows, F, W, N, False, 2600 + N, dev)
        codes, nid, ghw, tables, n_prev, base = inp
        form = kernels.binned_level_picks(rows, F, W, n_prev, N)
        err = check_forms("binned", inp, N, W, True, ("picked",))["picked"]
        outs = [kernels.binned_level(codes, nid, ghw, tables, n_prev, N,
                                     base, W, True) for _ in range(5)]
        if not all(torch.equal(outs[0][1], o[1]) for o in outs[1:]):
            raise AssertionError(f"binned_level N={N}: five launches "
                                 f"differ")
        ms = time_cuda(lambda: kernels.binned_level(
            codes, nid, ghw, tables, n_prev, N, base, W, True), 10)
        pms = time_cuda(lambda: binned_level_plain(
            codes, nid, ghw, tables, n_prev, N, base, W, True), 2)
        lib = index_add_ms(codes, outs[0][0], bf16_rows(ghw), N, base, W, 3)
        bound, by = level_bound_ms(rows, F, 1, N, W, rows)
        level[N] = {"form": form, "ms": ms, "plain_ms": pms,
                    "library_ms": lib, "bound_ms": bound, "bound_by": by,
                    "max_abs_err": err}
        del inp, codes, nid, ghw, outs
    print(f"binned_level at the forest's deep levels, {rows} x {F}, W={W}, "
          f"bf16, picked form (device ms, plain, index_add_, bound, max abs "
          f"err): {json.dumps(level)}; five launches bit-equal at each",
          flush=True)
    _e, (codes, nid, tables, n_prev, base) = check_route(rows, F, W, 1024,
                                                         dev, 2700)
    r_ms = time_cuda(lambda: kernels.binned_route_only(
        codes, nid, tables, n_prev, base, W), 20)
    r_pms = time_cuda(lambda: binned_route_only_plain(
        codes, nid, tables, n_prev, base, W), 3)
    r_bound, r_by = route_bound_ms(rows, F, 1)
    del codes, nid, tables
    N = 1024
    s_err, (nid, ghw, base) = check_segment(rows, N, dev, 2701)
    # past the lane columns' node count the kernel takes the matched keys
    if not same_bits(kernels.segment_totals(nid, ghw, N, base),
                     kernels.segment_totals_form(nid, ghw, N, base,
                                                 "match")):
        raise AssertionError("segment_totals over 1024 leaves: the picked "
                             "form's sums are not the matched keys'")
    s_ms = tools.time_ms(lambda: kernels.segment_totals(nid, ghw, N, base),
                         dev, 20)
    s_pms = time_cuda(lambda: segment_totals_plain(nid, ghw, N, base), 3)
    lid = nid.long() - base
    live = (lid >= 0) & (lid < N)
    idx = torch.where(live, lid, 0)
    vals = (ghw * live).t().contiguous()
    acc = torch.zeros((N, 3), device=dev)
    s_lib = tools.time_ms(lambda: acc.index_add_(0, idx, vals), dev, 20)
    del lid, live, idx, vals, acc, nid, ghw
    t_b, t_o = rows * (4 + 12) / HBM_BYTES_PER_S, 3 * rows / F32_OPS_PER_S
    s_bound, s_by = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o
                                          else "operations")
    print(f"binned_route_only n_prev=512 into 1024 leaves at {rows} x {F}: "
          f"{r_ms!r} ms, plain {r_pms!r} ms, bound {r_bound!r} ms by "
          f"{r_by}, bit-equal; segment_totals over 1024 leaves at {rows} "
          f"rows (device): {s_ms!r} ms, plain {s_pms!r} ms, index_add_ "
          f"{s_lib!r} ms, bound {s_bound!r} ms by {s_by}, max abs err "
          f"{s_err!r}, five launches bit-equal", flush=True)
    return {"binned_level": {"deep": level},
            "binned_route_only": {"deep": {
                "n_prev": 512, "ms": r_ms, "plain_ms": r_pms,
                "bound_ms": r_bound, "bound_by": r_by, "max_abs_err": 0.0}},
            "segment_totals": {"deep": {
                "n_nodes": N, "ms": s_ms, "plain_ms": s_pms,
                "library_ms": s_lib, "bound_ms": s_bound, "bound_by": s_by,
                "max_abs_err": s_err}}}


# ~76 32-bit integer operations a row: the key injections, 20 rounds of
# add, rotate and xor, and the float's assembly
THREEFRY_OPS = 76


def phase_threefry_record(dev, launches, rows=10_000_000):
    """The threefry kernel at the row draw's shape, 10M rows: its uniform
    and its fused row sample (a rate; per-class rates, with codes out of
    range clamped) bit-equal to the plain version (threefry on int64
    tensors, run here on the card) on the same key, then timed (CUDA
    events, medians) beside the plain version and the bound: 4 bytes
    written a row (uniform), 4 read and 4 written (fused sample), or
    ``THREEFRY_OPS`` integer operations a row at the card's 32-bit
    scalar rate, whichever takes longer. No PyTorch call computes
    threefry (torch.rand is another generator): library_ms null."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops import random as trandom
    key = trandom.fold_in(trandom.prng_key(7), 3)
    u_k = kernels.threefry_uniform(key, (rows,), dev)
    u_p = trandom.uniform_plain(key, (rows,), dev)
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.rand(rows, generator=g, device=dev) * 2.0
    y = torch.randint(-1, 8, (rows,), generator=g, device=dev,
                      dtype=torch.int32)
    rates = torch.linspace(0.2, 0.9, 7, device=dev)
    s_k = kernels.threefry_sample(key, w, 0.632)
    s_p = trandom.sample_weights_plain(key, w, 0.632)
    c_k = kernels.threefry_sample(key, w, 1.0, y, rates)
    c_p = trandom.sample_weights_plain(key, w, 1.0, y, rates)
    torch.cuda.synchronize()
    for what, a, b in (("uniform", u_k, u_p), ("sample", s_k, s_p),
                       ("per-class sample", c_k, c_p)):
        if not same_bits(a, b):
            raise AssertionError(f"threefry {what}: the kernel differs from "
                                 f"the plain version in "
                                 f"{int((a != b).sum())} rows")
    del u_p, s_p, c_p
    ms = time_cuda(lambda: kernels.threefry_uniform(key, (rows,), dev), 20)
    s_ms = time_cuda(lambda: kernels.threefry_sample(key, w, 0.632), 20)
    pms = time_cuda(lambda: trandom.uniform_plain(key, (rows,), dev), 3)
    s_pms = time_cuda(lambda: trandom.sample_weights_plain(key, w, 0.632), 3)
    t_o = rows * THREEFRY_OPS / F32_OPS_PER_S
    bounds = {}
    for what, nbytes in (("uniform", rows * 4), ("sample", rows * 8)):
        t_b = nbytes / HBM_BYTES_PER_S
        bounds[what] = (max(t_b, t_o) * 1e3,
                        "bytes" if t_b >= t_o else "operations")
    print(f"threefry_uniform at {rows} rows (device): uniform {ms!r} ms "
          f"(plain {pms!r} ms, bound {bounds['uniform'][0]!r} ms by "
          f"{bounds['uniform'][1]}), fused row sample {s_ms!r} ms (plain "
          f"{s_pms!r} ms, bound {bounds['sample'][0]!r} ms by "
          f"{bounds['sample'][1]}); uniform, sample and per-class sample "
          f"bit-equal to the plain version; launches by path "
          f"{json.dumps(launches)}", flush=True)
    return [{"name": "threefry_uniform", "route": "cuda",
             "source": "h2o3_tpu_torch/csrc/threefry.cu",
             "replaces": "none (jax.random.uniform, fused by XLA in "
                         "h2o3_tpu/models/gbm.py:326 and drf.py:225)",
             "launches": sum(launches.values()),
             "launches_by_path": launches, "max_abs_err": 0.0,
             "ms": ms, "plain_ms": pms, "bound_ms": bounds["uniform"][0],
             "bound_by": bounds["uniform"][1], "library_ms": None,
             "sample_ms": s_ms, "sample_plain_ms": s_pms,
             "sample_bound_ms": bounds["sample"][0]}]


# ------------------------------------------------- 10. scoring and serving

SERVE_SEED = 17           # the sampled rows and the load's request sizes
SERVE_ROWS = 4096         # rows sampled from each frame for serve == predict
LOAD = dict(clients=16, requests=256, min_rows=1, max_rows=64,
            max_batch=512, max_delay_ms=2.0)


def predict_bound_ms(rows, F, trees, depth):
    """Least time of a predict over ``rows``: X read once, and per row,
    level and tree one 32-byte sector of X gathered and a 4-byte leaf id
    read and written, over the card's memory rate."""
    nbytes = rows * F * 4 + rows * trees * depth * (32 + 4 + 4)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def predict_at_scale(card, name, model, fr, reps=3):
    """``model.predict(fr)`` at the frame's full size: the first call,
    then the median of ``reps`` (each synchronised), rows/s, the peak
    device memory above what was resident, and the bound. Returns the
    predict frame of the last call."""
    import torch
    rows = fr.nrow
    times = []
    for i in range(reps + 1):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = model.predict(fr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    warm = float(np.median(times[1:]))
    F = len(model.feature_names)
    bound_ms, nbytes = predict_bound_ms(rows, F, model.ntrees_built,
                                        model.max_depth)
    print(f"predict {name}: {rows}x{F}, {model.ntrees_built} trees depth "
          f"{model.max_depth}: cold {times[0]!r} s, warm median of {reps} "
          f"{warm!r} s ({times[1:]!r}), rows/s {rows / warm!r}, peak "
          f"device memory above the resident {peak:.3f} GiB; bound "
          f"{bound_ms!r} ms ({nbytes} bytes: X read once, one 32-byte "
          f"sector of X gathered and a 4-byte leaf id read and written a "
          f"row, level and tree, at {HBM_BYTES_PER_S:.3g} B/s), "
          f"{bound_ms / (warm * 1e3):.4f} of it [{card}]", flush=True)
    return pred


def eager_kernel_count(fn):
    """Device activities (kernels, copies, fills) in one call of ``fn``,
    as torch.profiler traces them; None where it saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def bucket_record(card, name, dep, X_pool, reps=(100, 10),
                  activities_once=False):
    """Each bucket of a deployment on the card: the capture's seconds
    (eager warm-ups and capture), the replay's device time (CUDA events,
    median of ``reps[0]``), the eager masked predict at the same shape
    (median of ``reps[1]``), the device activities of one eager call (at
    the first bucket only with ``activities_once``: the count does not
    depend on the shape, and profiling a large model's call takes
    seconds), and the replay against eager bit for bit on rows of the
    frame, half the bucket live."""
    import torch
    sc = dep.scorer
    if not sc.graphed or sc.captures != len(sc.buckets):
        raise AssertionError(f"serve {name}: graphed {sc.graphed}, "
                             f"{sc.captures} captures for {sc.buckets}")
    for b in sc.buckets:
        bk = sc.bucket(b)
        bk.x.copy_(X_pool[:b])
        bk.n.fill_(b // 2 + 1)
        bk.graph.replay()
        got = bk.out.clone()
        want = sc._masked(bk.x, bk.n)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"serve {name}: bucket {b}: the replay "
                                 f"differs from the eager predict")
        bk.n.fill_(b)
        replay_ms = time_cuda(bk.graph.replay, reps[0])
        eager_ms = time_cuda(lambda: sc._masked(bk.x, bk.n), reps[1])
        kernels_n = (eager_kernel_count(lambda: sc._masked(bk.x, bk.n))
                     if b == sc.buckets[0] or not activities_once
                     else "as the first bucket's")
        print(f"serve {name} bucket {b}: capture (3 eager warm-ups and the "
              f"capture) {sc.warm_seconds[b]!r} s, replay {replay_ms!r} ms "
              f"(device, median of {reps[0]}), eager {eager_ms!r} ms "
              f"(median of {reps[1]}), device activities in one eager call "
              f"{kernels_n if kernels_n else 'not measured'}, replay == "
              f"eager bit for bit [{card}]", flush=True)


def served_vs_predicted(name, dep, rows, labels, probs, domain):
    """Rows through predict_rows and predict_columnar against predict's
    labels and class probabilities of the same rows, bit for bit."""
    served = dep.predict_rows(rows)
    cols = dep.predict_columnar(rows)
    lab = [domain[int(c)] for c in labels]
    bad = [i for i, p in enumerate(served)
           if p["label"] != lab[i]
           or any(p["classProbabilities"][d] != float(probs[i, k])
                  for k, d in enumerate(domain))]
    bad_c = [i for i in range(len(rows))
             if cols["predict"][i] != lab[i]
             or any(cols[f"p{d}"][i] != float(probs[i, k])
                    for k, d in enumerate(domain))]
    if bad or bad_c or len(served) != len(rows):
        raise AssertionError(f"serve {name}: {len(bad)} rows and {len(bad_c)} "
                             f"columnar rows differ from predict (first "
                             f"{(bad or bad_c)[:5]})")


def host_rows(fr, names, idx):
    """Rows ``idx`` of ``fr`` as request dicts: numbers as floats, enum
    cells as their labels, NA as None."""
    cols = {}
    for n in names:
        v = fr.vec(n)
        if v.type == "enum":
            cols[n] = v.to_strings()[idx]
        else:
            x = v.to_numpy()[idx].astype(np.float64)
            cols[n] = [None if np.isnan(a) else float(a) for a in x]
    return [{n: cols[n][i] for n in names} for i in range(len(idx))]


def predict_probs(pred, domain):
    return (pred.vec("predict").to_numpy(),
            np.stack([pred.vec(f"p{d}").to_numpy() for d in domain], 1))


def serve_load(card, dep, rows, labels, probs, domain):
    """``LOAD["clients"]`` threads, each sending ``LOAD["requests"]``
    requests of 1-64 rows (sizes and offsets drawn from SERVE_SEED) to
    ``dep``; every answer held against predict's rows bit for bit."""
    rng = np.random.default_rng(SERVE_SEED)
    plans = [[(int(rng.integers(0, len(rows) - LOAD["max_rows"])),
               int(rng.integers(LOAD["min_rows"], LOAD["max_rows"] + 1)))
              for _ in range(LOAD["requests"])]
             for _ in range(LOAD["clients"])]
    lab = [domain[int(c)] for c in labels]
    errs, bad = [], []

    def client(plan):
        try:
            for off, n in plan:
                got = dep.predict_rows(rows[off:off + n])
                for i, p in enumerate(got):
                    j = off + i
                    if p["label"] != lab[j] or any(
                            p["classProbabilities"][d] != float(probs[j, k])
                            for k, d in enumerate(domain)):
                        bad.append(j)
        except Exception as e:  # re-raised below, on the main thread
            errs.append(e)

    threads = [threading.Thread(target=client, args=(p,)) for p in plans]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in threads) or bad:
        raise AssertionError(f"serve load: clients alive "
                             f"{sum(t.is_alive() for t in threads)}, "
                             f"{len(bad)} rows differ from predict")
    n_rows = sum(n for p in plans for _o, n in p)
    n_req = LOAD["clients"] * LOAD["requests"]
    snap = dep.stats.snapshot()
    print(f"serve load: {LOAD['clients']} clients x {LOAD['requests']} "
          f"requests of {LOAD['min_rows']}-{LOAD['max_rows']} rows (seed "
          f"{SERVE_SEED}), max_batch {LOAD['max_batch']}, max_delay_ms "
          f"{LOAD['max_delay_ms']}: {n_rows} rows in {wall!r} s, rows/s "
          f"{n_rows / wall!r}, requests/s {n_req / wall!r}, p50 "
          f"{snap['p50_ms']!r} ms p99 {snap['p99_ms']!r} ms, batches "
          f"{snap['batches']}, mean live rows a batch "
          f"{snap['mean_batch_occupancy']!r}, bucket fill "
          f"{snap['bucket_fill']!r}, stage ms totals "
          f"{json.dumps(snap['stage_ms'])} [{card}]", flush=True)
    return snap


def serve_multinomial(card, rng, mmodel, mfr):
    """The multinomial model deployed at the buckets 1-4096: each
    bucket's replay against eager bit for bit, and SERVE_ROWS rows of
    its frame (drawn with ``rng``) served bit-equal to predict over the
    whole frame, in the label and all K probabilities, with no capture
    and no eager predict after deploy."""
    from h2o3_tpu_torch import serve
    names = mmodel.feature_names
    midx = np.sort(rng.choice(mfr.nrow, SERVE_ROWS, replace=False))
    dom = list(mmodel.response_domain)
    labels, probs = predict_probs(mmodel.predict(mfr), dom)
    labels, probs = labels[midx], probs[midx]
    dep = serve.deploy("serve_multinomial", model=mmodel, max_batch=4096)
    # 350 trees: a replay runs ~27,000 small kernels, so fewer reps
    bucket_record(card, "multinomial", dep,
                  mfr.rows(midx).as_matrix(names), reps=(10, 2),
                  activities_once=True)
    caps, eager = dep.scorer.captures, dep.scorer.eager_calls
    served_vs_predicted("multinomial", dep, host_rows(mfr, names, midx),
                        labels, probs, dom)
    if (dep.scorer.captures, dep.scorer.eager_calls) != (caps, eager) \
            or dep.scorer.out_k != len(dom):
        raise AssertionError("serve multinomial: served rows captured or "
                             "ran an eager predict, or the output is not "
                             f"{len(dom)} wide")
    serve.undeploy("serve_multinomial")
    print(f"serve multinomial: {SERVE_ROWS} rows served (rows and "
          f"columnar) bit-equal to predict over the whole frame, label and "
          f"all {len(dom)} probabilities [{card}]", flush=True)


def phase_serve(card, fr, packed, xgb, airlines, air_sample, multinomial):
    """Scoring and serving on the card. ``packed`` and ``xgb`` are the
    packed main path's GBM and XGBoost "hist" (both on the 10M x 28
    frame ``fr``), ``airlines`` the airlines GBM from the CSV phase and
    ``air_sample`` rows of its frame, ``multinomial`` the covertype
    model and its frame (phase_multinomial). Predict over the whole frame
    for the first two (timed, with its bound); each model deployed with
    the buckets 1-4096, one CUDA graph each, per bucket its times and the
    replay against eager bit for bit; SERVE_ROWS rows of each frame
    served (rows and columnar) bit-equal to predict's (the airlines rows
    with string labels, one unknown level and one column missing,
    against predict of a frame of the same values; the multinomial rows
    in their label and all 7 probabilities); then a concurrent load on
    the packed model with its own deployment (max_batch 512), every
    answer checked, no capture and no eager predict after deploy. The
    K-kernels' launch counters must not move in the whole phase."""
    import h2o3_tpu_torch as h2o
    import torch
    from h2o3_tpu_torch import serve
    from h2o3_tpu_torch.ops import kernels
    t_phase = time.perf_counter()
    launches0 = dict(kernels.LAUNCHES)
    rng = np.random.default_rng(SERVE_SEED)
    idx = np.sort(rng.choice(fr.nrow, SERVE_ROWS, replace=False))
    names = packed.feature_names
    rows = host_rows(fr, names, idx)
    X_pool = fr.rows(idx).as_matrix(names)
    for name, model in (("packed", packed), ("xgboost_hist", xgb)):
        pred = predict_at_scale(card, name, model, fr)
        dom = list(model.response_domain)
        labels, probs = predict_probs(pred, dom)
        labels, probs = labels[idx], probs[idx]
        del pred
        dep = serve.deploy(f"serve_{name}", model=model, max_batch=4096)
        bucket_record(card, name, dep, X_pool)
        caps, eager = dep.scorer.captures, dep.scorer.eager_calls
        served_vs_predicted(name, dep, rows, labels, probs, dom)
        if (dep.scorer.captures, dep.scorer.eager_calls) != (caps, eager):
            raise AssertionError(f"serve {name}: served rows captured or "
                                 f"ran an eager predict")
        if name == "packed":
            pool = (rows, labels, probs, dom)
        serve.undeploy(f"serve_{name}")
        print(f"serve {name}: {SERVE_ROWS} rows served (rows and columnar) "
              f"bit-equal to predict over the whole frame [{card}]",
              flush=True)

    # the multinomial model: [rows, 7] probabilities a batch
    serve_multinomial(card, rng, *multinomial)

    # airlines: string labels, one unknown level, one column missing
    names = airlines.feature_names
    dropped = "DayOfWeek"
    arows = host_rows(air_sample, names, np.arange(air_sample.nrow))
    arows[0]["Origin"] = "Z?Z"
    for r in arows:
        del r[dropped]
    cols = {}
    for n in names:
        if n == dropped:
            continue
        vals = [r[n] for r in arows]
        cols[n] = (np.array(vals, dtype=object)
                   if air_sample.vec(n).type == "enum"
                   else np.array([np.nan if v is None else v for v in vals],
                                 np.float32))
    afr = h2o.Frame.from_numpy(cols, device="cuda")
    dom = list(airlines.response_domain)
    labels, probs = predict_probs(airlines.predict(afr), dom)
    dep = serve.deploy("serve_airlines", model=airlines, max_batch=4096)
    bucket_record(card, "airlines", dep, air_sample.as_matrix(names))
    served_vs_predicted("airlines", dep, arows, labels, probs, dom)
    if dep.codec.unknown_categorical_levels_seen != {"Origin": 2}:
        raise AssertionError(f"serve airlines: unknown levels seen "
                             f"{dep.codec.unknown_categorical_levels_seen}")
    serve.undeploy("serve_airlines")
    print(f"serve airlines: {len(arows)} rows with string labels, Origin "
          f"'Z?Z' unknown in one, {dropped} missing in all, served (rows "
          f"and columnar) bit-equal to predict of a frame of the same "
          f"values [{card}]", flush=True)

    # the concurrent load, on its own deployment of the packed model
    dep = serve.deploy("serve_load", model=packed,
                       max_batch=LOAD["max_batch"],
                       max_delay_ms=LOAD["max_delay_ms"])
    caps, eager = dep.scorer.captures, dep.scorer.eager_calls
    snap = serve_load(card, dep, *pool)
    if (dep.scorer.captures, dep.scorer.eager_calls) != (caps, eager) \
            or dep.scorer.replays != snap["batches"]:
        raise AssertionError(
            f"serve load: captures {dep.scorer.captures - caps}, eager "
            f"{dep.scorer.eager_calls - eager}, replays "
            f"{dep.scorer.replays} for {snap['batches']} batches")
    serve.shutdown_all()
    torch.cuda.synchronize()
    if dict(kernels.LAUNCHES) != launches0:
        raise AssertionError(f"serve: kernel launches moved: "
                             f"{launches0} -> {dict(kernels.LAUNCHES)}")
    print(f"serve phase: {time.perf_counter() - t_phase!r} s wall; no "
          f"K-kernel launched [{card}]", flush=True)


# ------------------------------------------------- 9. the probe tools

PROBE_SRC = "h2o3_tpu_torch/tools/csrc/probes.cu"
# the probe tools' kernels: the TPU probe each replaces, and the tool
# module (h2o3_tpu_torch/tools) that is its entry point
PROBES = {
    "mxu_probe": ("tools/kern_mxu_probe.py:47", "kern_mxu_probe"),
    "gather_probe": ("tools/kern_gather_probe.py:45", "kern_gather_probe"),
    "onehot_probe": ("tools/kern_gather_probe.py:45", "kern_gather_probe"),
    "level_knockouts_P2": ("tools/kern_ablate.py:129", "kern_ablate"),
    "level_knockouts_P3": ("tools/kern_ablate.py:233", "kern_ablate"),
    "level_knockouts_P4": ("tools/kern_ablate_t.py:120", "kern_ablate_t"),
    "level_variants_P6": ("tools/kern_variants.py:130", "kern_variants"),
}


# Shared loads (LDS, LDSM) that a knock-out instance may have fewer of
# than its body's production instance (kNone), because the phase it
# removes owns them: (body, knock-out) -> loads, as nvcc 12 for sm_90a
# counts them in the probes libraries. Any other knock-out keeps at least
# the production instance's shared loads; in the tensor-core grouped body
# it also keeps its HMMA or IMMA, which only kAdds removes.
PHASE_LOADS = {
    # the tiled body: the cell's lo and inv (ranges; bins does no re-bin),
    # the old value that each shared-add CAS loop reads (adds)
    ("tiled_adaptive", "ranges"): 2,
    ("tiled_adaptive", "bins"): 2,
    ("tiled_adaptive", "adds"): 3,
    # the grouped body: the children's lo and inv (ranges); bins also
    # drops the staged row ids and slots that the value or code loads read
    ("grouped_adaptive", "ranges"): 6,
    ("grouped_adaptive", "bins"): 18,
    ("grouped_packed", "bins"): 12,
    # its int8 instance: the children's lo and inv, and the staged split
    # feature's value that the route reads
    ("grouped_i8_adaptive", "route"): 2,
    ("grouped_i8_adaptive", "ranges"): 20,
    ("grouped_i8_adaptive", "bins"): 20,
    ("grouped_i8_packed", "route"): 2,
    # the wide body: the slot's lo and inv, a pair for each value of the
    # unrolled load window (ranges; bins does no re-bin)
    ("wide_adaptive", "ranges"): 32,
    ("wide_adaptive", "bins"): 32,
    ("wide_i8_adaptive", "ranges"): 32,
    ("wide_i8_adaptive", "bins"): 32,
}


def check_probe_sass(by_fn):
    """The knock-out instances of the probes libraries (mangled
    ``6AblateE<k>E``, k the Ablate value) against the production instance
    (k = 0) of the same body: no fewer shared loads (LDS, LDSM) than it,
    apart from the phase's own (``PHASE_LOADS``), so that the compiler
    dropped nothing upstream of the knocked-out phase; in the tensor-core
    grouped body no fewer HMMA (float) or IMMA (int8) products, and none
    under kAdds (4), which removes them. Prints every instance's counts
    beside the production instance's; raises with every instance that
    fails."""
    import re
    from h2o3_tpu_torch.tools._probes import ABLATES, BODIES
    names = {v: k for k, v in ABLATES.items()}

    def ops(c, *prefixes):
        return sum(v for k, v in c.items() if k.startswith(prefixes))
    inst = {}
    for name, c in by_fn.items():
        m = re.search(r"6AblateE(\d)E", name)
        form = next((f for f, k in (("grouped", "level_grouped_kernel"),
                                     ("wide", "level_wide_kernel"),
                                     ("tiled", "adaptive_level_kernel"))
                     if k in name), None)
        if m is None or form is None:
            continue
        kind = "packed" if "CodeBins" in name else "adaptive"
        body = f"{form}{'_i8' if 'I8Mass' in name else ''}_{kind}"
        key = (body, names[int(m.group(1))])
        if key in inst:
            raise AssertionError(f"SASS: two instances of {key}")
        inst[key] = (ops(c, "LDS"), ops(c, "HMMA", "IMMA"))
    want = {(b, a) for b, body in BODIES.items() for a in body.ablates}
    if set(inst) != want:
        raise AssertionError(f"SASS: knock-out instances missing "
                             f"{sorted(want - set(inst))} or unknown "
                             f"{sorted(set(inst) - want)}")
    rows, bad = [], []
    for (b, a), (lds, mma) in sorted(inst.items()):
        if a == "none":
            continue
        lds0, mma0 = inst[(b, "none")]
        rows.append(f"{b} {a} LDS {lds}/{lds0} MMA {mma}/{mma0}")
        if lds < lds0 - PHASE_LOADS.get((b, a), 0):
            bad.append(f"{b} {a}: {lds} shared loads against {lds0}")
        if b.startswith("grouped") and (
                (a == "adds" and mma) or (a != "adds" and mma < mma0)
                or not mma0):
            bad.append(f"{b} {a}: {mma} tensor-core products against "
                       f"{mma0}")
    print("SASS of the knock-out instances against their production "
          "instance (knock-out/production): " + "; ".join(rows),
          flush=True)
    if bad:
        raise AssertionError("SASS of the knock-out instances: "
                             + "; ".join(bad))


def probe_level_checks(dev, rows=3000, F=28):
    """Every knock-out of every probed body against its plain version at
    N = 2 and 32: integer-valued masses (every float sum exact) with nid
    and histogram bit-equal; the production instance ("none") also
    bit-equal to the training path's wrapper in the same form; the walk
    knock-out again on float masses, each bin within 1e-4 + 1e-5 x its
    absolute mass of the float64 plain version. Returns {body: max abs
    err}."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.tools import kern_ablate
    from h2o3_tpu_torch.tools._probes import BODIES
    errs = {}
    for body_name, body in BODIES.items():
        errs[body_name] = 0.0
        for N in (2, 32):
            inp = kern_ablate.level_inputs(body_name, rows, F, N, 90 + N, dev,
                                           int_ghw=True)
            for ab in body.ablates:
                nk, hk = kern_ablate.knockout(body_name, ab, inp)
                npl, hp = kern_ablate.knockout_plain(body_name, ab, inp)
                torch.cuda.synchronize()
                what = f"{body_name} {ab} N={N}"
                if not torch.equal(nk, npl):
                    raise AssertionError(f"{what}: nid differs in "
                                         f"{int((nk != npl).sum())} rows")
                if not torch.equal(hk, hp.float()):
                    raise AssertionError(
                        f"{what}: histogram not bit-equal (max "
                        f"{float((hk - hp.float()).abs().max())})")
            # the probes' production instance is the training path's
            if body.kind == "adaptive" and body.mass == "float":
                ref = kernels.adaptive_level_form(
                    inp.vals, inp.nid, inp.ghw, inp.tables, inp.lo, inp.inv,
                    inp.n_prev, N, inp.level_base, body.W, True, body.layout,
                    body.form)
            elif body.kind == "adaptive":
                ref = kernels.adaptive_level_i8_form(
                    inp.vals, inp.nid, inp.q, inp.scales, inp.tables, inp.lo,
                    inp.inv, inp.n_prev, N, inp.level_base, body.W,
                    body.layout, body.form)
            elif body.mass == "float":
                ref = kernels.binned_level_form(
                    inp.vals, inp.nid, inp.ghw, inp.tables, inp.n_prev, N,
                    inp.level_base, body.W, True, body.form)
            else:
                ref = kernels.binned_level_i8_form(
                    inp.vals, inp.nid, inp.q, inp.scales, inp.tables,
                    inp.n_prev, N, inp.level_base, body.W, body.form)
            mine = kern_ablate.knockout(body_name, "none", inp)
            if not (torch.equal(ref[0], mine[0])
                    and torch.equal(ref[1], mine[1])):
                raise AssertionError(f"{body_name} N={N}: the probes' "
                                     f"production instance differs from "
                                     f"the training path's")
            if "walk" in body.ablates:
                fin = kern_ablate.level_inputs(body_name, rows, F, N, 190 + N,
                                               dev)
                _n, hk = kern_ablate.knockout(body_name, "walk", fin)
                g64 = fin.ghw
                fin.ghw = g64.double()
                _n, hp = kern_ablate.knockout_plain(body_name, "walk", fin)
                fin.ghw = g64.double().abs()
                _n, mass = kern_ablate.knockout_plain(body_name, "walk", fin)
                mass_check(f"{body_name} walk N={N}", hk, hp, mass)
                errs[body_name] = max(errs[body_name], float(
                    (hk.double() - hp).abs().max()))
            del inp
    return errs


def probe_kernel_checks(dev):
    """P1 and P5 against their plain versions at small sizes (the tools
    check them again at their own sizes): P1 at M = 6 and 24, FW 64 and
    128, K 1024, n_tiles 3, int8 exact and bf16 within 1e-5 x the absolute
    mass (``kern_mxu_probe.check``); P5 at 10,001 rows with indices outside
    [0, N) among them, bit-equal. Returns the largest absolute errors."""
    from h2o3_tpu_torch.tools import kern_gather_probe, kern_mxu_probe
    errs = {"mxu_probe": 0.0}
    for dt in ("bf16", "i8"):
        for M, FW in ((6, 64), (24, 128)):
            L, R = kern_mxu_probe.operands(M, FW, 1024, dt, dev)
            errs["mxu_probe"] = max(errs["mxu_probe"], kern_mxu_probe.check(
                L, R, 3, kern_mxu_probe.mxu(L, R, 3)))
    tab, idx = kern_gather_probe.operands(10_001, dev)
    idx[::97] = -1
    idx[5::89] = 32
    for name, onehot in (("gather_probe", False), ("onehot_probe", True)):
        errs[name] = kern_gather_probe.check(
            tab, idx, onehot, kern_gather_probe.lookup(tab, idx, onehot))
    return errs


def driven(tool, argv, need):
    """Run a probe tool's entry point (``tool.main(argv)``) with every
    launch count set to 0 just before and read just after; fails where a
    kernel of ``need`` was launched no time. Returns (result, counts)."""
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.tools import _probes
    for counts in (kernels.LAUNCHES, _probes.LAUNCHES):
        for k in counts:
            counts[k] = 0
    res = tool.main(argv)
    got = {**{k: v for k, v in kernels.LAUNCHES.items() if v},
           **{k: v for k, v in _probes.LAUNCHES.items() if v}}
    missing = [k for k in need if not got.get(k)]
    if missing:
        raise AssertionError(f"{tool.__name__} {argv}: no launch of "
                             f"{missing} ({got})")
    return res, got


def phase_probes(card, dev):
    """9. The probe tools (h2o3_tpu_torch/tools), P1-P6: every probe
    kernel and every knock-out instance held to its plain version at a
    small size, then each tool's entry point driven at the JAX tools' own
    sizes with the launch counts read around it, each tool holding every
    kernel's first output on its timed inputs to the plain version (the
    records' max_abs_err is the largest of both sizes): P1 at M = 6, 24, 96, 128,
    256 (bf16 and int8 at FW 896, bf16 at FW 448, bf16 chained L = 4), P5,
    P2 as the attribution of every probed body at N = 32 and N = 2 (10M x
    28), P3 at L = 1, 2, 4, P4, P6. Returns the kernel records."""
    import torch
    from h2o3_tpu_torch.tools import (kern_ablate, kern_ablate_t,
                                      kern_gather_probe, kern_mxu_probe,
                                      kern_variants)
    errs = probe_kernel_checks(dev)
    level_errs = probe_level_checks(dev)
    print(f"probes vs plain at small sizes (again at the timed sizes "
          f"below): P1 and P5 {json.dumps(errs)}; "
          f"every knock-out of every body bit-equal (integer masses), the "
          f"walk within the mass tolerance (float masses, max abs err "
          f"{json.dumps(level_errs)}); [{card}]", flush=True)
    recs = []

    def rec(name, launches, err, ms, plain_ms, bound_ms, bound_by,
            library_ms, **extra):
        replaces, tool = PROBES[name]
        r = {"name": name, "route": "cuda", "source": PROBE_SRC,
             "replaces": replaces, "tool": f"h2o3_tpu_torch.tools.{tool}",
             "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms, **extra}
        recs.append(r)
        return r

    # P1
    mxu, launches, err = {}, 0, errs["mxu_probe"]
    for argv in (["--dt", "bf16"], ["--dt", "i8"], ["--fw", "448"],
                 ["--L", "4", "--reps", "10"]):
        res, got = driven(kern_mxu_probe, argv, ["mxu_probe"])
        launches += got["mxu_probe"]
        mxu[" ".join(argv)] = res["mxu"]
        err = max([err, *(r["max_abs_err"] for r in res["mxu"])])
    top = mxu["--dt bf16"][-1]
    L, R = kern_mxu_probe.operands(top["M"], top["FW"], kern_mxu_probe.TILE,
                                   "bf16", dev)
    n_tiles = kern_mxu_probe.ROWS // kern_mxu_probe.TILE
    plain_ms = time_cuda(lambda: kern_mxu_probe.mxu_plain(L, R, n_tiles), 3)
    del L, R
    rec("mxu_probe", launches, err, top["ms"], plain_ms,
        top["bound_ms"], "operations", top["library_ms"], by_run=mxu)
    print(f"P1 mxu_probe: M=256 bf16 FW 896 {top['ms']:.4f} ms a "
          f"contraction ({top['rate']:.1f} TFLOP/s, bound "
          f"{top['bound_ms']:.4f} ms) ; every M, dt, FW, L: "
          f"{json.dumps(mxu, default=float)} [{card}]", flush=True)

    # P5
    res, got = driven(kern_gather_probe, [],
                      ["gather_probe", "onehot_probe"])
    tab, idx = kern_gather_probe.operands(kern_gather_probe.ROWS, dev)
    for name, key, plain in (
            ("gather_probe", "lane-gather", kern_gather_probe.gather_plain),
            ("onehot_probe", "onehot-matmul",
             kern_gather_probe.onehot_plain)):
        pms = time_cuda(lambda: plain(tab, idx), 3)
        lib = res["library_ms"]
        if name == "onehot_probe":
            tb = tab.to(torch.bfloat16).float()
            lib = time_cuda(lambda: torch.index_select(tb, 1, idx), 10)
        rec(name, got[name], max(errs[name], res[f"{key} max_abs_err"]),
            res[key], pms, res["bound_ms"], "bytes", lib)
    del tab, idx
    print(f"P5 gather_probe / onehot_probe at {res['rows']} rows: "
          f"{res['lane-gather']:.4f} / {res['onehot-matmul']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms, index_select {res['library_ms']:.4f} "
          f"ms [{card}]", flush=True)

    # P2: the attribution of every probed body at N = 32 and N = 2
    res, got = driven(kern_ablate, ["--bodies", "all", "--nodes", "32,2"],
                      ["level_knockout"])
    att = res["attribution"]
    # P2's own level: the [rows, F] adaptive one on the grouped body, N = 32
    p2 = next(a for a in att
              if a["body"] == "grouped_adaptive" and a["N"] == 32)
    rec("level_knockouts_P2", got["level_knockout"],
        max([*level_errs.values(),
             *(e for a in att for e in a["errs"].values())]),
        p2["ms"]["none"], p2["plain_ms"],
        p2["bound_ms"], p2["bound_by"], p2["library_ms"], attribution=att)
    print(f"P2 attribution (10M x 28; ms a level, shares of the base) "
          f"[{card}]: {json.dumps(att, default=float)}", flush=True)

    # P3: chained packed levels, eager against one CUDA graph
    res, got = driven(kern_ablate, ["--levels", "1,2,4"], ["level_knockout"])
    lv = res["levels"]
    inp = kern_ablate.level_inputs("grouped_packed", kern_ablate.LROWS, 28,
                                   32, 77, dev)
    pms = time_cuda(lambda: kern_ablate.knockout_plain(
        "grouped_packed", "none", inp), 3)
    lib, in_level = kern_ablate.index_add_ms("grouped_packed", inp, dev)
    bound, by = kern_ablate.level_bound_ms("grouped_packed",
                                           kern_ablate.LROWS, 28, 32,
                                           in_level)
    del inp
    rec("level_knockouts_P3", got["level_knockout"],
        max([level_errs["grouped_packed"], level_errs["wide_packed"],
             *(r["max_abs_err"] for r in lv)]),
        lv[0]["graph"]["none"], pms, bound, by, lib, levels=lv)
    print(f"P3 chained levels (2.5M x 28, N=32) [{card}]: "
          f"{json.dumps(lv, default=float)}", flush=True)

    # P4: the tiled [F, rows] body
    res, got = driven(kern_ablate_t, [], ["level_knockout"])
    rec("level_knockouts_P4", got["level_knockout"],
        max(level_errs["tiled_adaptive"], *res["errs"].values()),
        res["ms"]["none"], res["plain_ms"],
        res["bound_ms"], res["bound_by"], res["library_ms"], attribution=res)
    print(f"P4 tiled [F, rows] body (2.5M x 28, N=32) [{card}]: "
          f"{json.dumps(res, default=float)}", flush=True)

    # P6: the deepest adaptive level's forms
    res, got = driven(kern_variants, [], ["level_knockout", "adaptive_level"])
    inp = kern_ablate.level_inputs("grouped_adaptive", kern_variants.ROWS,
                                   28, 32, 1600, dev)
    pms = time_cuda(lambda: kern_ablate.knockout_plain(
        "grouped_adaptive", "none", inp), 3)
    lib, in_level = kern_ablate.index_add_ms("grouped_adaptive", inp, dev)
    bound, by = kern_ablate.level_bound_ms("grouped_adaptive",
                                           kern_variants.ROWS, 28, 32,
                                           in_level)
    del inp
    rec("level_variants_P6", got["level_knockout"] + got["adaptive_level"],
        max(v["max_abs_err"] for v in res.values()), res["grouped"]["ms"],
        pms, bound, by, lib, variants=res)
    print(f"P6 variants (10M x 28, N=32) [{card}]: "
          f"{json.dumps(res, default=float)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return recs


def sass_functions(lib_path):
    """{function: its SASS} of a built library (``cuobjdump``), None
    without the tool."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {fn.split(chr(10))[0].strip(): fn
            for fn in sass.split("Function : ")[1:]}


def sass_atomics(lib_path):
    """The atomic, tensor-core and shared-load (LDS, LDSM) opcodes in each
    built kernel's SASS (``cuobjdump``), e.g. whether a shared-memory float
    add is native or a CAS loop. Returns (the printable summary of the
    atomic and tensor-core ones, {function: {opcode: count}})."""
    import re
    fns = sass_functions(lib_path)
    if fns is None:
        return "cuobjdump not found: SASS summary not printed", {}
    lines, by_fn = [], {}
    for name, fn in fns.items():
        ops = re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED|HMMA|IMMA)\."
                         r"[A-Z0-9_.]+|LDSM?(?![A-Z0-9_])(?:\.[A-Z0-9_.]+)?)",
                         fn)
        counts = dict(sorted(collections.Counter(ops).items()))
        by_fn[name] = counts
        shown = {k: v for k, v in counts.items() if not k.startswith("LDS")}
        lines.append(f"  {name[:80]}: {shown}")
    return "SASS atomics per kernel:\n" + "\n".join(lines), by_fn


def check_sass(by_fn):
    """The SASS of the kernels whose float sums must come in a fixed order:
    every float tensor-core instance of the node-grouped level (mass
    policy FloatMass with kMma, mangled ``9FloatMass`` and ``Lb1E``), the
    adaptive level's (AdaptiveBins) and the packed level's (CodeBins), has
    HMMA and no shared float CAS loop (``ATOMS.CAST.SPIN``); every int8
    instance (``I8Mass``) of both has IMMA and no shared or global atomics
    at all; every float instance of the wide level (``level_wide_kernel``,
    both bin sources, every W), the leaf-totals kernel (each of its eight
    instances), global_hist's node-grouped form, the route (K9, K6 and
    their loads-only floors) and the column level (``level_column_kernel``,
    K5 in [F, rows], all five W, counted on its own) have no atomics at
    all;
    every int8 instance of the wide level (``I8Mass``, both bin sources, W
    = 64, 128, 256, one and two terms) has shared integer adds
    (``ATOMS.ADD``) and no other atomic: no CAS loop, no float atomic, no
    global atomic."""
    def mma(counts, op):
        return sum(v for k, v in counts.items() if k.startswith(op))

    def atomics(counts):
        return {k: v for k, v in counts.items()
                if k.startswith(("ATOM", "RED"))}
    per_src = {}
    for src in ("AdaptiveBins", "CodeBins"):
        grouped = {n: c for n, c in by_fn.items()
                   if "level_grouped_kernel" in n and src in n}
        fmma = {n: c for n, c in grouped.items()
                if "9FloatMass" in n and "Lb1E" in n}
        imma = {n: c for n, c in grouped.items() if "6I8Mass" in n}
        if not fmma or not imma:
            raise AssertionError(f"SASS: no float or no int8 tensor-core "
                                 f"{src} instance")
        for name, counts in fmma.items():
            if mma(counts, "HMMA") == 0 or "ATOMS.CAST.SPIN" in counts:
                raise AssertionError(f"SASS of {name}: {counts}")
        for name, counts in imma.items():
            if mma(counts, "IMMA") == 0 or atomics(counts):
                raise AssertionError(f"SASS of {name}: {counts}")
        per_src[src] = {"HMMA": [mma(c, "HMMA") for c in fmma.values()],
                        "IMMA": [mma(c, "IMMA") for c in imma.values()]}
    wide = {n: c for n, c in by_fn.items()
            if "level_wide_kernel" in n and "I8Mass" not in n}
    if len(wide) < 8:
        raise AssertionError(f"SASS: wide level instances missing: "
                             f"{sorted(wide)}")
    wide_atomics = {n: atomics(c) for n, c in wide.items() if atomics(c)}
    if wide_atomics:
        raise AssertionError(f"SASS of the wide level: atomics "
                             f"{wide_atomics}")
    # the int8 wide instances: integer sums in any order, so native shared
    # integer adds (ATOMS.ADD) are allowed; no CAS loop, no float atomic,
    # no global atomic
    wide_i8 = {n: c for n, c in by_fn.items()
               if "level_wide_kernel" in n and "I8Mass" in n}
    if len(wide_i8) < 12:
        raise AssertionError(f"SASS: int8 wide level instances missing: "
                             f"{sorted(wide_i8)}")
    for name, counts in wide_i8.items():
        bad = {k: v for k, v in atomics(counts).items()
               if not k.startswith("ATOMS.ADD")
               or any(t in k for t in ("F32", "F16", "F64", "FTZ", "CAS"))}
        if bad:
            raise AssertionError(f"SASS of {name}: atomics {bad}")
    ordered = {n: c for n, c in by_fn.items()
               if "leaf_totals_kernel" in n
               or "global_hist_grouped_kernel" in n}
    # leaf_totals: route or not x lane columns or matched keys x 16-byte
    # or scalar loads; global_hist grouped: uint8 and int32 codes
    n_leaf = sum("leaf_totals_kernel" in n for n in ordered)
    if n_leaf < 8 or len(ordered) - n_leaf < 2:
        raise AssertionError(f"SASS: leaf_totals (8) / global_hist grouped "
                             f"(2) instances missing: {sorted(ordered)}")
    for name, counts in ordered.items():
        if atomics(counts) or mma(counts, "HMMA") or mma(counts, "IMMA"):
            raise AssertionError(f"SASS of {name}: atomics {counts}")
    # the route (K9 in [rows, F] and its loads-only floor, K6 in
    # [F, rows]): no atomics
    route = {n: c for n, c in by_fn.items()
             if "adaptive_route_only_kernel" in n}
    if len(route) < 4:
        raise AssertionError(f"SASS: adaptive_route_only instances missing: "
                             f"{sorted(route)}")
    for name, counts in route.items():
        if atomics(counts):
            raise AssertionError(f"SASS of {name}: atomics {counts}")
    # the column body (K5 in [F, rows]), its own family: one instance a W
    # (16, 32, 64, 128, 256), no atomics at all (no shared CAS loop, no
    # float RED or ATOM, no global atomics)
    column = {n: c for n, c in by_fn.items() if "level_column_kernel" in n}
    if len(column) != 5:
        raise AssertionError(f"SASS: level_column_kernel instances: "
                             f"{sorted(column)} (5 expected)")
    for name, counts in column.items():
        if atomics(counts):
            raise AssertionError(f"SASS of {name}: atomics {counts}")
    print(f"SASS check: tensor-core grouped level instances, HMMA per "
          f"float instance (no ATOMS.CAST.SPIN) and IMMA per int8 instance "
          f"(no atomics) {json.dumps(per_src)}; ATOMS/RED in the "
          f"{len(wide)} wide level instances (level_wide_kernel): "
          f"{sum(sum(atomics(c).values()) for c in wide.values())}; "
          f"shared integer ATOMS.ADD (and no other atomic) in the "
          f"{len(wide_i8)} int8 wide instances: "
          f"{sum(sum(atomics(c).values()) for c in wide_i8.values())}; "
          f"{len(ordered)} leaf_totals / global_hist grouped instances "
          f"without atomics; {len(route)} adaptive_route_only instances "
          f"without atomics; {len(column)} column level instances "
          f"(level_column_kernel) without atomics", flush=True)


def ptxas_usage(log, names):
    """What ``-Xptxas -v`` reported (registers, barriers, shared memory;
    stack frame and spills) for each kernel of the build log whose mangled
    name holds one of ``names``: {function: [its lines]}."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
        elif cur and ("spill" in line or "Used " in line):
            out.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    return out


# ------------------------------------------------- the streamed GBM (8h)

# the overflow chunks of the half-resident trains, and how many of them
# the window keeps (H2O3_STREAM_RESIDENT: at 28 packed features the
# budget's own window formula keeps none wherever it cuts more than one
# chunk)
STREAM_TREES = 20
STREAM_CHUNKS = 8
STREAM_HALF = 4
STREAM_L1_TREES = 5          # the H2O3_LEVELS_PER_PASS=1 comparison
STREAM_DEGRADE_TREES = 5
STREAM_DEGRADE_HEADROOM = 3 << 30    # the allocator's cap over what is held


@contextlib.contextmanager
def env(**kv):
    """Environment variables set (None: unset) for the block, restored
    after."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def streamed_train(card, tag, fr, path, ntrees, budget, want, auc_ref=None,
                   profiled=False, **env_kv):
    """One streamed train of ``path`` on ``fr`` under ``memman.reset(
    budget)`` and ``env_kv``, the launch counters set to 0 just before
    and read just after (they must equal ``want``, every other kernel
    0); prints its loop, the H2D bytes a tree, the copies' unwaited share
    and the AUC (within 1e-3 of ``auc_ref`` where given). ``profiled``:
    the train under torch.profiler (``stream_device_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from h2o3_tpu_torch import memman
    from h2o3_tpu_torch.ops import kernels
    memman.reset(budget=budget)
    try:
        with env(**env_kv), (profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
                else contextlib.nullcontext()) as prof:
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            m = train(fr, ntrees, path)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
    finally:
        memman.reset()
    if profiled:
        stream_device_ms(card, tag, prof, m, ntrees)
    if not m.output.get("streamed"):
        raise AssertionError(f"{tag}: the train did not stream")
    expected = {k: 0 for k in launches}
    expected.update(want)
    if launches != expected:
        raise AssertionError(f"{tag}: launched {launches}, expected "
                             f"{expected}")
    auc = m.training_metrics.auc
    if not np.isfinite(auc) or not 0.5 < auc <= 1.0:
        raise AssertionError(f"{tag}: AUC {auc}")
    if auc_ref is not None and abs(auc - auc_ref) > 1e-3:
        raise AssertionError(f"{tag}: AUC {auc!r} is more than 1e-3 from "
                             f"the dense train's {auc_ref!r}")
    sp = m.output["stream_profile"]
    rows = fr.nrow
    print(f"streamed {tag}: {rows}x{fr.ncol - 1} {path} "
          f"{json.dumps(PATHS[path]['params'])} {ntrees} trees, budget "
          f"{budget} {json.dumps(env_kv)}: training_loop_seconds "
          f"{m.output['training_loop_seconds']!r} rows/s "
          f"{rows * ntrees / m.output['training_loop_seconds']!r} wall "
          f"{wall!r} train_profile {json.dumps(m.output['train_profile'])} "
          f"AUC {auc!r} stream_profile {json.dumps(sp)} launches "
          f"{launches} [{card}]", flush=True)
    return {"model": m, "launches": launches, "auc": auc, "profile": sp}


def same_trees(a, b, what, n=None, keys=("feat", "thr", "value", "na_left",
                                         "is_split")):
    for k in keys:
        x, y = a[k][:n], b[k][:n]
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: {k} differs in "
                                 f"{int((x != y).sum())} entries")


def stream_device_ms(card, tag, prof, m, ntrees):
    """The device time of a streamed train's kernels and host-to-device
    copies (these on the side stream) as torch.profiler traced them,
    beside its loop and its stream profile's copy time and unwaited
    share. The kernels' time over the loop is the compute stream's busy
    share; kernel and copy time summed past the loop would be overlap
    that the trace itself shows."""
    from torch.autograd import DeviceType
    kern_ms = copy_ms = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if "HtoD" in e.key:
            copy_ms += t / 1e3
        elif not e.key.startswith("Memcpy") and not e.key.startswith(
                "Memset"):
            kern_ms += t / 1e3
    sp = m.output["stream_profile"]
    loop_ms = m.output["training_loop_seconds"] * 1e3
    print(f"streamed profile {tag}: {ntrees} trees under torch.profiler: "
          f"loop {loop_ms!r} ms; kernels {kern_ms!r} ms "
          f"({kern_ms / loop_ms!r} of the loop), H2D copies {copy_ms!r} ms "
          f"({copy_ms / loop_ms!r} of the loop); stream_profile copy_ms "
          f"{sp.get('copy_ms')!r} unwaited_copy_share "
          f"{sp.get('unwaited_copy_share')!r} staging_s "
          f"{sp.get('staging_s')!r} [{card}]", flush=True)
    if not kern_ms > 0 or not copy_ms > 0:
        raise AssertionError(f"streamed profile {tag}: kernels {kern_ms} "
                             f"ms, copies {copy_ms} ms traced")


def whole_weight(what, trees, total, depth):
    """Every tree of ``trees`` (heap layout, ``depth`` split levels) holds
    the weight of all ``total`` rows: the root's node_w is ``total``, each
    split node's is its two children's sum, and the reachable nodes that
    do not split hold ``total`` between them. Exact: unit weights and
    counts below 2^24 add exactly in float32. A chunk whose histogram or
    leaf totals a level dropped or added twice breaks one of the three."""
    w = np.asarray(trees["node_w"], np.float64)
    split = np.asarray(trees["is_split"], bool)
    for t in range(w.shape[0]):
        reach = np.zeros(w.shape[1], bool)
        reach[0] = True
        for m in range(2 ** depth - 1):
            if reach[m] and split[t, m]:
                reach[2 * m + 1] = reach[2 * m + 2] = True
                if w[t, 2 * m + 1] + w[t, 2 * m + 2] != w[t, m]:
                    raise AssertionError(
                        f"{what}: tree {t} node {m}: node_w {float(w[t, m])}, "
                        f"its children {float(w[t, 2 * m + 1])} + "
                        f"{float(w[t, 2 * m + 2])}")
        leaves = w[t, reach & ~split[t]].sum()
        if w[t, 0] != total or leaves != total:
            raise AssertionError(f"{what}: tree {t}: root node_w "
                                 f"{float(w[t, 0])}, leaves {float(leaves)}, "
                                 f"rows {total}")


def same_root_split(what, a, b, split_key):
    """The first tree's root split (feature, ``split_key``) of ``a`` and
    ``b`` equal."""
    got = (int(a["feat"][0][0]), a[split_key][0][0])
    ref = (int(b["feat"][0][0]), b[split_key][0][0])
    if got != ref:
        raise AssertionError(f"{what}: first root split (feat, {split_key}) "
                             f"{got} against the dense train's {ref}")


def phase_streaming(card, fr, dense, dense_adaptive):
    """Item 13 on the card (8h), on the 10M x 28 frame ``fr``: the
    streamed packed GBM (1) whose window holds the frame in one chunk,
    bit-equal to the dense train ``dense`` of phase 4 in trees and
    predictions; (2) over ``STREAM_CHUNKS`` chunks with ``STREAM_HALF``
    resident, beside a ``H2O3_LEVELS_PER_PASS=1`` train of the same
    configuration (its first trees equal) under torch.profiler (the
    kernels' and the copies' device time beside the loop); (3) with no window; (4) the adaptive path at half
    resident; and (5) a real out-of-memory degrade: the allocator capped
    over what the process holds, the dense train runs out, the train
    completes streamed with one warning and the trees of (1). Every
    streamed train holds every row's weight in every tree
    (``whole_weight``), and those over several chunks split the first
    root as the dense train of their path (``dense``, ``dense_adaptive``,
    phase 4) does. Returns the launches by path."""
    import logging

    import torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    rows, F = fr.nrow, fr.ncol - 1
    D = 6
    gc.collect()
    torch.cuda.empty_cache()
    cr = -(-rows // STREAM_CHUNKS)
    out = {}

    def want(path, ntrees, C):
        level, route = PATHS[path]["level"], PATHS[path]["route"]
        w = {level: D * ntrees * C, route: ntrees * C}
        if PATHS[path].get("totals"):
            w[PATHS[path]["totals"]] = ntrees * C
        return w

    # 1. the whole frame in the window, one chunk: past 0.9 of the budget
    # with the design matrix, within it with the codes
    res = streamed_train(card, "resident", fr, "packed", STREAM_TREES,
                         rows * F * 4 + 1, want("packed", STREAM_TREES, 1),
                         dense["auc"])
    if res["profile"]["chunks"] != 1 or res["profile"]["resident_chunks"] \
            != 1:
        raise AssertionError(f"resident: {res['profile']}")
    same_trees(res["model"].trees, dense["trees"], "resident vs dense",
               keys=("feat", "thr", "split_bin", "value", "na_left",
                     "is_split", "node_w"))
    p_dense = dense["model"].predict(fr).vec("p1").to_numpy()
    p_res = res["model"].predict(fr).vec("p1").to_numpy()
    if not np.array_equal(p_dense, p_res):
        raise AssertionError("resident vs dense: predictions differ")
    if res["model"].training_metrics.auc != dense["auc"]:
        raise AssertionError("resident vs dense: AUC differs")
    print(f"streamed resident == dense packed: trees, predictions and AUC "
          f"bit for bit [{card}]", flush=True)
    out["streamed_resident"] = res["launches"]

    # 2. half resident; 3. no window (and one level a window)
    C = -(-rows // cr)
    budget = cr * F * 4
    half = streamed_train(card, "half_resident", fr, "packed", STREAM_TREES,
                          budget, want("packed", STREAM_TREES, C),
                          dense["auc"], H2O3_STREAM_RESIDENT=STREAM_HALF)
    l1 = streamed_train(card, "half_resident_L1", fr, "packed",
                        STREAM_L1_TREES, budget,
                        want("packed", STREAM_L1_TREES, C), profiled=True,
                        H2O3_STREAM_RESIDENT=STREAM_HALF,
                        H2O3_LEVELS_PER_PASS=1)
    same_trees(l1["model"].trees, half["model"].trees, "L=1 vs auto",
               n=STREAM_L1_TREES)
    none = streamed_train(card, "no_window", fr, "packed", STREAM_TREES,
                          budget, want("packed", STREAM_TREES, C),
                          dense["auc"], H2O3_STREAM_RESIDENT=0)
    same_trees(none["model"].trees, half["model"].trees,
               "no window vs half resident")
    for tag, r in (("half_resident", half), ("no_window", none)):
        sp = r["profile"]
        if (sp["chunks"], sp["resident_chunks"]) != (
                C, STREAM_HALF if tag == "half_resident" else 0):
            raise AssertionError(f"{tag}: {sp}")
        out[f"streamed_{tag}"] = r["launches"]

    # 4. the adaptive path at half resident (float32 features)
    ad = streamed_train(card, "adaptive_half_resident", fr, "adaptive",
                        STREAM_TREES, cr * F * 16,
                        want("adaptive", STREAM_TREES, C),
                        dense_adaptive["auc"],
                        H2O3_STREAM_RESIDENT=STREAM_HALF)
    out["streamed_adaptive_half_resident"] = ad["launches"]
    for tag, r in (("resident", res), ("half resident", half),
                   ("L=1", l1), ("no window", none), ("adaptive", ad)):
        whole_weight(f"streamed {tag}", r["model"].trees, rows, D)
    for tag, r in (("half resident", half), ("no window", none)):
        same_root_split(f"streamed {tag}", r["model"].trees, dense["trees"],
                        "split_bin")
    same_root_split("streamed adaptive", ad["model"].trees,
                    dense_adaptive["trees"], "thr")
    print(f"streamed trains over {C} chunks: every tree holds the {rows} "
          f"rows' weight (root, children and leaves), the first root split "
          f"as the dense train's [{card}]", flush=True)

    # 5. a real out-of-memory degrade, under a cap on this process's
    # allocator only
    del half, none, l1, ad
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    frac = (held + STREAM_DEGRADE_HEADROOM) / total
    log_ = logging.getLogger("h2o3_tpu_torch")
    said = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda r: said.append(r.getMessage())
    log_.addHandler(handler)
    torch.cuda.set_per_process_memory_fraction(frac)
    try:
        est = H2OGradientBoostingEstimator(
            ntrees=STREAM_DEGRADE_TREES, max_depth=D,
            distribution="bernoulli", learn_rate=0.1, seed=7, min_rows=1.0,
            **PATHS["packed"]["params"])
        t0 = time.perf_counter()
        est.train(y="label", training_frame=fr)
        torch.cuda.synchronize()
        degrade_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_reserved()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        log_.removeHandler(handler)
    m = est.model
    warned = [s for s in said if "degrading to the streamed" in s]
    if not m.output.get("streamed") or len(warned) != 1:
        raise AssertionError(f"degrade: streamed {m.output.get('streamed')}, "
                             f"warnings {said}")
    same_trees(m.trees, res["model"].trees, "degrade vs resident",
               n=STREAM_DEGRADE_TREES)
    whole_weight("streamed degrade", m.trees, rows, D)
    print(f"streamed degrade: dense train of {rows}x{F} under a cap of "
          f"{frac:.4f} of {total} bytes ({held} held + "
          f"{STREAM_DEGRADE_HEADROOM}) ran out of memory and completed "
          f"streamed in {degrade_s!r} s ({STREAM_DEGRADE_TREES} trees, "
          f"warning: {warned[0][:160]!r}), trees equal the resident "
          f"train's; stream_profile {json.dumps(m.output['stream_profile'])}"
          f" train_profile {json.dumps(m.output['train_profile'])}; peak "
          f"reserved {peak} [{card}]", flush=True)
    return out


class PhaseClock:
    """Wall seconds of each phase of the run (the cost of each phase)."""

    def __init__(self, echo=False):
        self.t = time.perf_counter()
        self.laps = {}
        self.echo = echo

    def lap(self, name):
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now
        if self.echo:
            log(f"phase {name}: {self.laps[name]:.1f} s")


# 8i: item 14, the data x model mesh. Virtual shards on the one card
# (the script needs one card): each shard a quarter of the rows, its
# level kernels launched once a shard.
SPMD_TREES, SPMD_DEPTH = 20, 6
SPMD_CPU_ROWS, SPMD_CPU_TREES = 200_000, 3
SPMD_PROC_ROWS, SPMD_PROC_TREES = 1_000_000, 5


@contextlib.contextmanager
def on_mesh(shape, device):
    """The port's mesh set to ``shape`` = (n_data, n_model) virtual shards
    of ``device`` for the block; the previous mesh after it."""
    from h2o3_tpu_torch.parallel import mesh
    old = mesh._MESH
    mesh.set_mesh(mesh.make_mesh(n_data=shape[0], n_model=shape[1],
                                 devices=[device] * (shape[0] * shape[1])))
    try:
        yield mesh.current_mesh()
    finally:
        mesh.set_mesh(old)


@contextlib.contextmanager
def recorded_splits(store):
    """The split search (``tree._find_splits``, one call a level) wrapped:
    each call appends the chosen gain, the parent's score |G^2 / H|, the
    node's hessian total H and the chosen split's smaller child hessian,
    as host arrays (the left child's H summed again from the level's
    histogram as the search sums it, the right one's H - H_left)."""
    import torch
    from h2o3_tpu_torch.models import tree
    orig = tree._find_splits

    def call(trip, cfg, col_mask, max_bin=None, mono=None):
        out = orig(trip, cfg, col_mask, max_bin, mono)
        B, F = cfg.n_bins, cfg.n_features
        h = trip[1][:, :F, :]
        n = torch.arange(h.shape[0], device=h.device)
        f = out[1].long()
        hl = (tree._cumsum_bins(h[..., :B])[n, f, out[2].long() - 1]
              + torch.where(out[3], h[n, f, B], torch.zeros(
                  (), dtype=h.dtype, device=h.device)))
        parent = tree._leaf_score2(out[4], out[5], cfg).abs()
        child = torch.minimum(hl, out[5] - hl)
        store.append(tuple(a.cpu().numpy()
                           for a in (out[0], parent, out[5], child)))
        return out
    tree._find_splits = call
    try:
        yield store
    finally:
        tree._find_splits = orig


def rounding_split(rec, t, m, depth):
    """How node ``m`` of tree ``t`` chose its split when rounding chose
    it, else None: "noise" where its gain is within 4 float32 ulps of
    its parent's score (``noise_split``), "residue" where the chosen
    split's smaller child has a hessian within 4 ulps of the node's
    total: a right child's H - H_left is then a residue of the
    subtraction, and its score (G^2 / H) and gain are made by rounding
    (at 10M rows a one-row child's hessian is an ulp or two of the
    node's)."""
    d = int(np.log2(m + 1))
    gain, parent, htot, child = rec[t * depth + d]
    n = m - (2 ** d - 1)
    if gain[n] <= 4 * np.spacing(np.float32(parent[n])):
        return "noise"
    if child[n] <= 4 * np.spacing(np.float32(htot[n])):
        return "residue"
    return None


def layout_splits(what, ta, tb, ra, rb, n_trees, depth, split_key,
                  forced=False, max_rounding=2):
    """``card_vs_cpu_splits``' rule between two layouts of one train
    (their trees ``ta``, ``tb``: arrays [T, M] by key; their
    ``recorded_splits`` ``ra``, ``rb``): every split equal, except at or
    below a node that rounding chose: a noise split on both layouts, or
    a residue split on either. A residue split gives its one-row child a
    leaf of about G / 1e-12, so the later trees of two trains train on
    other margins: the comparison ends with the tree that has one. With
    ``forced`` each tree of ``tb`` was grown from the inputs of ``ta``'s
    tree (``regrown``), so a residue moves no later tree and every tree
    is compared. At most ``max_rounding`` such nodes. Returns (trees
    compared, trees identical, nodes that differ, the rounding splits by
    kind)."""
    same, differ, roots = 0, 0, {}
    M = 2 ** depth - 1
    compared = n_trees
    for t in range(n_trees):
        bad = [m for m in range(M) if any(
            ta[k][t][m] != tb[k][t][m] for k in ("feat", split_key,
                                                  "na_left"))]
        same += not bad
        differ += len(bad)
        for m in bad:
            a = m
            while a >= 0:
                ka = rounding_split(ra, t, a, depth)
                kb = rounding_split(rb, t, a, depth)
                kind = ("residue" if "residue" in (ka, kb) else "noise"
                        if ka == kb == "noise" else None)
                if kind:
                    roots[(t, a)] = kind
                    break
                a = (a - 1) // 2 if a else -1
            if a < 0:
                raise AssertionError(
                    f"{what}: tree {t} node {m}: feat {ta['feat'][t][m]} "
                    f"vs {tb['feat'][t][m]}, {split_key} "
                    f"{ta[split_key][t][m]} vs {tb[split_key][t][m]}, not "
                    f"below a split that rounding chose")
        if not forced and any(k == "residue" for (tt, _a), k
                              in roots.items() if tt == t):
            compared = t + 1
            break
    if len(roots) > max_rounding:
        raise AssertionError(f"{what}: {len(roots)} rounding splits with "
                             f"differing nodes at or below them "
                             f"{sorted(roots.items())}")
    kinds = {f"{k} (tree, node)": [tn for tn, v in sorted(roots.items())
                                   if v == k] for k in ("noise", "residue")}
    return compared, same, differ, kinds


# the grower each main path's train calls, by its name in ``models.gbm``
GROWERS = {"packed": "grow_tree_binned", "adaptive": "grow_tree_adaptive",
           "global": "grow_tree"}


@contextlib.contextmanager
def recorded_grows(name, store):
    """The GBM's grower ``name`` (``GROWERS``) wrapped: each call (one a
    tree) appends its arguments by name and the tree it returned."""
    import inspect
    from h2o3_tpu_torch.models import gbm
    orig = getattr(gbm, name)
    sig = inspect.signature(orig)

    def call(*args, **kw):
        tree, nid = orig(*args, **kw)
        store.append((dict(sig.bind(*args, **kw).arguments), tree))
        return tree, nid
    setattr(gbm, name, call)
    try:
        yield store
    finally:
        setattr(gbm, name, orig)


def regrown(name, calls, mesh):
    """Each of a one-shard train's ``recorded_grows`` calls grown again on
    ``mesh``, from the same inputs: its row blocks (the matrix, g, h, w)
    cut over the mesh's data shards as a train cuts them, every other
    argument as recorded. Returns the trees."""
    from h2o3_tpu_torch.models import tree
    from h2o3_tpu_torch.models.model_base import RowShards
    grower = getattr(tree, name)
    out = []
    for args, _tree in calls:
        a = dict(args, mesh=mesh)
        if a.get("layout", "rows_f") != "rows_f":
            raise AssertionError(f"regrown: layout {a['layout']}")
        blocks = list(a)[:4]                       # matrix, g, h, w
        one = [a[k][0] if isinstance(a[k], list) else a[k] for k in blocks]
        rows = RowShards(mesh, one[0].shape[0], one[0].device)
        if rows.padded != rows.nrow:
            raise AssertionError(f"regrown: {rows.nrow} rows need pad rows")
        for k, v in zip(blocks, one):
            a[k] = rows.split(v, 0)
        out.append(grower(**a)[0])
    return out


def stacked_trees(trees):
    """A list of grown trees as host arrays [T, M] by key."""
    return {k: np.stack([t[k].cpu().numpy() for t in trees])
            for k in trees[0]}


def with_trees(m, trees, lr):
    """A copy of the GBM ``m`` whose trees are ``trees`` (as grown: split
    bins unbinned through ``m``'s edges, leaf values scaled by ``lr`` as
    the train's finalize scales them)."""
    import copy
    import torch
    from h2o3_tpu_torch.models.tree import bins_to_thresholds_stacked
    th = stacked_trees(trees)
    host = dict(m.trees)
    for k in ("feat", "na_left", "is_split"):
        host[k] = th[k]
    host["value"] = (th["value"].astype(np.float64) * lr).astype(np.float32)
    if "thr" in th:
        host["thr"] = th["thr"]
    else:
        host["split_bin"] = th["split_bin"]
        host["thr"] = bins_to_thresholds_stacked(th["split_bin"], th["feat"],
                                                 m.edges)
    new = copy.copy(m)
    new.trees = host
    dev = m.device
    new._feat = torch.tensor(host["feat"], device=dev).long()
    new._thr = torch.tensor(host["thr"], device=dev)
    new._na_left = torch.tensor(host["na_left"], device=dev).bool()
    new._is_split = torch.tensor(host["is_split"], device=dev).bool()
    new._value = torch.tensor(host["value"], device=dev)
    return new


def spmd_launches(path, shards, ntrees=SPMD_TREES, depth=SPMD_DEPTH):
    """A path's launches on ``shards`` data shards: each level kernel,
    route and leaf-totals launch once a shard."""
    want = {PATHS[path]["level"]: shards * depth * ntrees}
    for one in ("route", "totals"):
        if PATHS[path].get(one):
            want[PATHS[path][one]] = shards * ntrees
    return want


def worker_digests(nproc, backend, device, rows, trees):
    """``nproc`` processes of ``h2o3_tpu_torch.tools.multihost_worker`` on
    ``device`` over ``backend``, started together; each must exit 0 and
    print one digest. Returns (digests, seconds); every process is ended
    before it returns."""
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "h2o3_tpu_torch.tools.multihost_worker",
         str(i), str(nproc), str(port), "--device", device, "--backend",
         backend, "--rows", str(rows), "--trees", str(trees)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    digests = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("DIGEST ")]
        if p.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"{backend} worker {i}/{nproc} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
        log(out.strip())
        digests.append(lines[0].split()[1])
    return digests, seconds


def phase_spmd(card, fr, ones, dev="cuda", cpu_rows=SPMD_CPU_ROWS,
               cpu_trees=SPMD_CPU_TREES, proc_rows=SPMD_PROC_ROWS,
               proc_trees=SPMD_PROC_TREES):
    """8i, item 14 on the card, on the 10M x 28 frame ``fr`` (phase 4's;
    ``ones`` its packed result, whose AUC the int8 mesh train is held
    to). (4, 1) virtual shards of one card for the packed, adaptive
    (W = 32) and global (nbins 1024) paths, each against the one-shard
    train of the same parameters in two ways, both trains' split
    searches recorded: the two trains by ``layout_splits`` and AUC
    within 1e-4 (a residue split ends that comparison: the later trees
    train on other margins); and every tree of the one-shard train grown
    again at (4, 1) from its own inputs (``regrown``), all 20 trees by
    the same rule, the one-shard model with those trees (``with_trees``;
    a tree that a residue split sets apart kept as one shard's, its own
    effect printed) within 1e-4 of its AUC. Each launch a shard's
    (``spmd_launches``).
    Packed-i8 at (4, 1): each shard its own int8 scale, AUC within 0.005
    of the float packed path. The packed train again at (4, 1),
    unrecorded (the warm loop, the reduce's device time a level by CUDA
    events, shardstats' collective wait), bit-equal to the recorded one,
    and at (4, 2), bit-equal to (4, 1). Then a sampled GBM and a DRF at
    (4, 1) on ``cpu_rows`` rows (the forest at ``DRF_CPU_DEPTH``), card
    against CPU on the same mesh; an NCCL group of one rank (a worker
    process) whose packed train is the one-shard train's bit for bit;
    two gloo processes on the one card (NCCL refuses two ranks on one
    device; gloo's CUDA tensors go through the host), equal digests,
    equal to the in-process (2, 1) mesh's. Returns the launches by
    path."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.parallel import collectives
    from h2o3_tpu_torch.tools import multihost_worker
    rows, F = fr.nrow, fr.ncol - 1
    out = {}
    keys = ("feat", "split_bin", "thr", "na_left", "is_split", "value")

    def auc(m):
        return m.training_metrics.auc

    def spmd_line(m):
        return json.dumps(m.output["spmd"])

    for path in ("packed", "adaptive", "global"):
        clock = PhaseClock()
        key = PATHS[path]["split_key"]
        g1, g4, gf, calls = [], [], [], []
        with recorded_splits(g1), recorded_grows(GROWERS[path], calls):
            m1 = train(fr, SPMD_TREES, path)
        zero_launches()
        with on_mesh((4, 1), dev), recorded_splits(g4):
            m4 = train(fr, SPMD_TREES, path)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        check_launches(f"spmd41_{path}", launches, spmd_launches(path, 4))
        out[f"spmd41_{path}"] = launches
        compared, same, differ, kinds = layout_splits(
            f"spmd (4, 1) {path} vs one shard", m4.trees, m1.trees, g4, g1,
            SPMD_TREES, SPMD_DEPTH, key)
        if compared == SPMD_TREES and not abs(auc(m4) - auc(m1)) <= 1e-4:
            raise AssertionError(f"spmd (4, 1) {path}: AUC {auc(m4)} vs one "
                                 f"shard {auc(m1)}")
        if not min(auc(m4), auc(m1)) > 0.5:
            raise AssertionError(f"spmd (4, 1) {path}: AUC {auc(m4)}, one "
                                 f"shard {auc(m1)}")
        clock.lap("one shard + (4, 1), searches recorded")
        with on_mesh((4, 1), dev) as mesh, recorded_splits(gf):
            forced = regrown(GROWERS[path], calls, mesh)
        one_trees = [tr for _a, tr in calls]
        del calls
        _c, f_same, f_differ, f_kinds = layout_splits(
            f"spmd (4, 1) {path} regrown vs one shard", stacked_trees(forced),
            stacked_trees(one_trees), gf, g1, SPMD_TREES, SPMD_DEPTH, key,
            forced=True)
        # a tree that a residue split sets apart is a fault of the float32
        # search on either layout (ROADMAP queue 3), not of the reduce:
        # the AUC bound holds the regrown model with those trees kept as
        # one shard's; their own effect is printed
        lr = float(m1.params["learn_rate"])
        apart = {t for t, _m in f_kinds["residue (tree, node)"]}
        a1 = m1.model_performance(fr).auc
        ak = with_trees(m1, [one_trees[t] if t in apart else tr
                             for t, tr in enumerate(forced)],
                        lr).model_performance(fr).auc
        af = (with_trees(m1, forced, lr).model_performance(fr).auc
              if apart else ak)
        if not abs(ak - a1) <= 1e-4:
            raise AssertionError(f"spmd (4, 1) {path} regrown: AUC {ak} vs "
                                 f"one shard {a1}")
        clock.lap("regrown at (4, 1)")
        print(f"spmd {path}: {rows}x{F}, {SPMD_TREES} trees depth "
              f"{SPMD_DEPTH}, (4, 1) virtual shards on {dev} against one "
              f"shard: the two trains {compared} trees compared, {same} "
              f"with identical splits, {differ} split nodes differ, each at "
              f"or below a split that rounding chose {json.dumps(kinds)}, "
              f"AUC (4, 1) {auc(m4)!r} one shard {auc(m1)!r}; each "
              f"one-shard tree regrown at (4, 1) from its inputs: "
              f"{SPMD_TREES} trees compared, {f_same} identical, "
              f"{f_differ} split nodes differ {json.dumps(f_kinds)}, AUC "
              f"{ak!r} one shard {a1!r} (with the {len(apart)} trees a "
              f"residue split sets apart regrown too: {af!r}); loops "
              f"(split searches recorded: a "
              f"host copy a level) (4, 1) "
              f"{m4.output['training_loop_seconds']!r} s, one shard "
              f"{m1.output['training_loop_seconds']!r} s; spmd "
              f"{spmd_line(m4)}; launches {launches} [{card}]; seconds "
              f"{json.dumps(clock.laps)}", flush=True)
        if path == "packed":
            packed4 = m4
        del m1, m4, g1, g4, gf, forced, one_trees

    zero_launches()
    with on_mesh((4, 1), dev):
        m8 = train(fr, SPMD_TREES, "packed_i8")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("spmd41_packed_i8", launches,
                   spmd_launches("packed_i8", 4))
    out["spmd41_packed_i8"] = launches
    if not abs(auc(m8) - ones["auc"]) <= 0.005:
        raise AssertionError(f"spmd (4, 1) packed_i8: AUC {auc(m8)} more "
                             f"than 0.005 from the float path's "
                             f"{ones['auc']}")
    print(f"spmd packed_i8 (H2O3_HIST_I8=1, each shard its own scale): "
          f"(4, 1) AUC {auc(m8)!r}, float one shard {ones['auc']!r}; "
          f"training_loop_seconds {m8.output['training_loop_seconds']!r}; "
          f"spmd {spmd_line(m8)}; launches {launches} [{card}]", flush=True)
    del m8

    zero_launches()
    with on_mesh((4, 1), dev), collectives.timing() as rec:
        m4 = train(fr, SPMD_TREES, "packed")
        torch.cuda.synchronize()
        reduce_ms = collectives.elapsed_ms(rec)
    check_repeats([packed4, m4], "packed", "spmd (4, 1) packed x2")
    per_tree = SPMD_DEPTH + 1
    if len(reduce_ms) != SPMD_TREES * per_tree:
        raise AssertionError(f"spmd: {len(reduce_ms)} reduces timed, "
                             f"expected {SPMD_TREES * per_tree}")
    level_ms = [float(np.median(reduce_ms[d::per_tree]))
                for d in range(per_tree)]
    zero_launches()
    with on_mesh((4, 2), dev):
        m42 = train(fr, SPMD_TREES, "packed")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("spmd42_packed", launches, spmd_launches("packed", 4))
    for k in keys:
        if k in m4.trees and not np.array_equal(m42.trees[k], m4.trees[k]):
            raise AssertionError(f"spmd (4, 2) packed: {k} differs from "
                                 f"(4, 1)")
    out["spmd42_packed"] = launches
    if not m42.output["spmd"]["model_axis_split_search"]:
        raise AssertionError("spmd (4, 2): no model-axis record")
    print(f"spmd packed warm loops: (4, 1) "
          f"{m4.output['training_loop_seconds']!r} s (one shard, phase 4: "
          f"{ones['loop_s']!r} s), (4, 2) "
          f"{m42.output['training_loop_seconds']!r} s, (4, 2) trees "
          f"bit-equal to (4, 1); reduce a level over the 4 shards (CUDA "
          f"events, median over {SPMD_TREES} trees; levels 0-5, then the "
          f"leaf totals): {[round(x, 4) for x in level_ms]} ms, "
          f"{sum(reduce_ms) / SPMD_TREES!r} ms a tree; shardstats "
          f"{json.dumps(m4.output['spmd'].get('collective'))}; (4, 2) "
          f"spmd {spmd_line(m42)} [{card}]", flush=True)
    del m4, m42, packed4

    X, y, _F = higgs_arrays(cpu_rows, seed=11)

    def sampled(f):
        with on_mesh((4, 1), f.device):
            return train(f, cpu_trees, "packed",
                         histogram_precision="float32", **SAMPLING_GBM)

    def forest(f):
        with on_mesh((4, 1), f.device):
            return drf_train(as_classes(f, "label"), "label",
                             ntrees=cpu_trees, max_depth=DRF_CPU_DEPTH,
                             histogram_precision="float32")

    for name, fit, depth, key in (("sampled_packed", sampled, 6,
                                   "split_bin"),
                                  ("drf", forest, DRF_CPU_DEPTH, "thr")):
        t0 = time.perf_counter()
        text = card_vs_cpu_recorded(f"spmd (4, 1) {name}", fit,
                                    lambda d: frame_of(X, y, d), cpu_trees,
                                    depth, key, auc)
        print(f"card vs cpu, spmd (4, 1) {name}: {cpu_rows} rows, "
              f"{cpu_trees} trees, float32, each shard's own row draw: "
              f"{text} (AUC) [{card}]; {time.perf_counter() - t0:.1f} s",
              flush=True)

    # the one-rank NCCL group and the two gloo processes run at once, the
    # in-process references meanwhile
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        one = pool.submit(worker_digests, 1,
                          "nccl" if dev == "cuda" else "gloo", dev,
                          proc_rows, proc_trees)
        two = pool.submit(worker_digests, 2, "gloo", dev, proc_rows,
                          proc_trees)
        ref1 = multihost_worker.train_digest(1, dev, proc_rows, proc_trees)
        ref2 = multihost_worker.train_digest(2, dev, proc_rows, proc_trees)
        (nccl, s1), (gloo, s2) = one.result(), two.result()
    if nccl != [ref1]:
        raise AssertionError(f"spmd: the one-rank process group's train "
                             f"{nccl} is not the one-shard train {ref1}")
    if gloo != [ref2, ref2]:
        raise AssertionError(f"spmd: two gloo processes' digests {gloo}, "
                             f"the in-process (2, 1) mesh's {ref2}")
    print(f"spmd processes: {proc_rows} rows, {proc_trees} packed trees: "
          f"NCCL group of one rank = one shard ({ref1}; {s1:.1f} s with "
          f"the process's start), two gloo processes on one card = the "
          f"in-process (2, 1) mesh ({ref2}; {s2:.1f} s; both groups and "
          f"the references at once) [{card}]",
          flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import h2o3_tpu_torch  # noqa: F401 — fails outside a checkout
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.tools import _probes

    # 1. device
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} [{card}]; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build: the training path's libraries and the probe tools' (phase
    # 9), every nvcc started together
    clock = PhaseClock(echo=True)
    t0 = time.perf_counter()
    probes_built = []

    def build_probes():
        try:
            probes_built.append(_probes.build())
        except BaseException as e:  # re-raised below, on this thread
            probes_built.append(e)
    probes_thread = threading.Thread(target=build_probes, daemon=True)
    probes_thread.start()
    kernels.build()
    probes_thread.join()
    if isinstance(probes_built[0], BaseException):
        raise probes_built[0]
    log(f"build: {time.perf_counter() - t0:.2f} s\n{kernels.build_log()}\n"
        f"{_probes.build_log()}")
    usage = ptxas_usage(kernels.build_log(), ("leaf_totals_kernel",
                                              "adaptive_route_only_kernel"))
    if not usage:
        raise AssertionError("ptxas -v: no leaf_totals / adaptive_route_only "
                             "entry in the build log")
    print("ptxas -v, leaf totals and route instances:\n" +
          "\n".join(f"  {fn}: {'; '.join(lines)}"
                    for fn, lines in sorted(usage.items())), flush=True)
    # every library's cuobjdump at once
    libs = list(kernels.library_paths().values())
    probe_libs = list(_probes.library_paths().values())
    with concurrent.futures.ThreadPoolExecutor(len(libs) + len(probe_libs)
                                               ) as pool:
        sass = list(pool.map(sass_atomics, libs + probe_libs))
    by_fn = {}
    for text, counts in sass[:len(libs)]:
        print(text, flush=True)
        by_fn.update(counts)
    if by_fn:
        check_sass(by_fn)
    probe_fns = {}
    for _text, counts in sass[len(libs):]:
        probe_fns.update(counts)
    if probe_fns:
        check_probe_sass(probe_fns)

    clock.lap("2 build + SASS")

    # 3. kernel vs plain
    phase_kernels(dev)
    clock.lap("3 packed kernels")
    phase_adaptive_kernels(dev)
    clock.lap("3 adaptive kernels")
    phase_global_kernels(dev)
    clock.lap("3 global kernels")
    phase_i8_kernels(dev)
    phase_totals_kernel(dev)
    clock.lap("3 int8 + totals kernels")

    # 4. the main paths, each with its own launch counts
    packed = phase_main_path(card, "packed")
    fr = packed.pop("frame")
    clock.lap("4 packed (frame included)")
    adaptive = phase_main_path(card, "adaptive", fr)
    del adaptive["frame"]
    clock.lap("4 adaptive")
    glob = phase_main_path(card, "global", fr)
    del glob["frame"]
    clock.lap("4 global")
    # the int8 paths, against the same path's bf16 AUC of this run
    packed_i8 = phase_main_path(card, "packed_i8", fr, ref_auc=packed["auc"])
    del packed_i8["frame"]
    adaptive_i8 = phase_main_path(card, "adaptive_i8", fr,
                                  ref_auc=adaptive["auc"])
    del adaptive_i8["frame"]
    clock.lap("4 packed_i8 + adaptive_i8")
    # the wide lane widths (nbins 254 packed, 62 adaptive)
    packed_wide = phase_main_path(card, "packed_wide", fr)
    del packed_wide["frame"]
    adaptive_wide = phase_main_path(card, "adaptive_wide", fr)
    del adaptive_wide["frame"]
    clock.lap("4 packed_wide + adaptive_wide")
    # the wide paths with int8 masses, against their float paths' AUC
    packed_wide_i8 = phase_main_path(card, "packed_wide_i8", fr,
                                     ref_auc=packed_wide["auc"])
    del packed_wide_i8["frame"]
    adaptive_wide_i8 = phase_main_path(card, "adaptive_wide_i8", fr,
                                       ref_auc=adaptive_wide["auc"])
    del adaptive_wide_i8["frame"]
    clock.lap("4 packed_wide_i8 + adaptive_wide_i8")

    # 5. card vs cpu; the two sketch paths against each other
    phase_card_vs_cpu("packed")
    phase_card_vs_cpu("adaptive")
    clock.lap("5 packed + adaptive card vs cpu")
    phase_card_vs_cpu("global", nbins=300)
    clock.lap("5 global card vs cpu")
    phase_packed_vs_global()
    clock.lap("5 packed vs global")
    for path in ("packed_i8", "adaptive_i8"):
        for terms in (1, 2):
            phase_card_vs_cpu_i8(path, terms)
    clock.lap("5 int8 card vs cpu")
    phase_card_vs_cpu("packed_wide")
    phase_card_vs_cpu("adaptive_wide")
    clock.lap("5 wide card vs cpu")
    for path in ("packed_wide_i8", "adaptive_wide_i8"):
        for terms in (1, 2):
            phase_card_vs_cpu_i8(path, terms)
    clock.lap("5 wide int8 card vs cpu")

    # 4-5 from a file: CSV -> import_file -> GBM, HIGGS and airlines shapes
    csv = phase_csv(card)
    clock.lap("4-5 csv (files, parse, trains, profile, card vs cpu)")
    # the rest of ingest: compressed files through the GBM, streaming on
    # and off, the formats, URIs, SQL
    ingest = phase_ingest(card, csv["airlines_train"])
    clock.lap("4-5 ingest (gzip, zstd, stream, formats, uri, sql)")

    # 6. kernels at the main paths' shapes
    rec = phase_kernel_record(dev, packed["launches"])
    rec += phase_adaptive_record(dev, adaptive["launches"])
    clock.lap("6 packed + adaptive record")
    rec += phase_i8_record(dev, {
        "binned_level_i8": packed_i8["launches"]["binned_level_i8"],
        "adaptive_level_i8": adaptive_i8["launches"]["adaptive_level_i8"]})
    rec += phase_totals_record(dev, {
        "leaf_totals": packed["launches"]["leaf_totals"],
        "segment_totals": packed["launches"]["segment_totals"]})
    clock.lap("6 int8 + totals record")
    wide = phase_wide_record(dev)
    by_name = {r["name"]: r for r in rec}
    by_name["binned_level"]["wide"] = wide["binned"]
    by_name["adaptive_level"]["wide"] = wide["adaptive"]
    for path, res in (("packed", packed), ("adaptive", adaptive),
                      ("packed_wide", packed_wide),
                      ("adaptive_wide", adaptive_wide),
                      ("packed_i8", packed_i8), ("adaptive_i8", adaptive_i8),
                      ("packed_wide_i8", packed_wide_i8),
                      ("adaptive_wide_i8", adaptive_wide_i8),
                      ("higgs_csv", {"launches": csv["higgs_csv"]}),
                      ("airlines_csv", {"launches": csv["airlines_csv"]}),
                      ("airlines_gzip", {"launches": ingest["airlines_gzip"]}),
                      ("airlines_zstd",
                       {"launches": ingest["airlines_zstd"]})):
        for k in ("level", "route", "totals"):
            kernel = PATHS[path].get(k)
            if kernel:
                by_name[kernel].setdefault("launches_by_path", {})[path] = \
                    res["launches"][kernel]
    clock.lap("6 wide record")
    by_name["adaptive_level"]["f_rows"]["grower"] = phase_f_rows_grower(
        dev, fr)
    clock.lap("6 f_rows grower")

    # 7. where the time goes: a warm, profiled retrain of each main path,
    # after giving back the cached blocks of phase 6's large inputs (the
    # trains then grow the allocator's cache again in their first run)
    gc.collect()
    torch.cuda.empty_cache()
    phase_warm_profile(fr, card, "packed", packed["trees"])
    phase_warm_profile(fr, card, "adaptive", adaptive["trees"])
    clock.lap("7 packed + adaptive profile")
    phase_warm_profile(fr, card, "packed_i8", packed_i8["trees"])
    phase_warm_profile(fr, card, "adaptive_i8", adaptive_i8["trees"])
    clock.lap("7 packed_i8 + adaptive_i8 profile")
    warm_s = phase_warm_profile(fr, card, "global", glob["trees"])
    clock.lap("7 global profile")
    phase_warm_profile(fr, card, "packed_wide", packed_wide["trees"])
    phase_warm_profile(fr, card, "adaptive_wide", adaptive_wide["trees"])
    clock.lap("7 packed_wide + adaptive_wide profile")
    phase_warm_profile(fr, card, "packed_wide_i8", packed_wide_i8["trees"])
    phase_warm_profile(fr, card, "adaptive_wide_i8",
                       adaptive_wide_i8["trees"])
    clock.lap("7 packed_wide_i8 + adaptive_wide_i8 profile")
    for path in ("packed", "adaptive", "global", "packed_wide",
                 "adaptive_wide"):
        phase_repeatability(fr, path, dev)
    phase_repeatability_i8(fr)
    clock.lap("7 repeatability")

    # 8. XGBoost (BASELINE config #2): validation frame, early stopping
    xgb, xgb_hist = phase_xgboost(card, fr)
    for path, launches in xgb.items():
        for kernel in ("binned_level", "binned_route_only",
                       "segment_totals"):
            by_name[kernel].setdefault("launches_by_path", {})[
                f"xgboost_{path}"] = launches[kernel]
    clock.lap("8 xgboost")
    # 8a-8b. A1 and A6: the multinomial GBM on a covertype-shaped frame,
    # the other families (with offsets) on a freMTPL2-shaped one
    multi = phase_multinomial(card)
    clock.lap("8a multinomial")
    fams = phase_families(card)
    clock.lap("8b families")
    for path, launches in [("multinomial_covtype", multi["launches"])] + [
            (f"fremtpl2_{n}", v) for n, v in fams.items()]:
        for kernel in ("binned_level", "binned_route_only",
                       "segment_totals"):
            by_name[kernel].setdefault("launches_by_path", {})[path] = \
                launches[kernel]
    # 8c-8d. A4 and the random forest: sampled GBM and XGBoost trains on
    # the 10M-row frame, the forest at the JAX package's defaults (HIGGS
    # binomial, covertype multinomial, a regression), the forest's deep
    # levels and the draws against their plain versions
    sampling = phase_sampling(card, fr)
    clock.lap("8c sampling")
    forests = phase_drf(card, fr, multi["frame"])
    clock.lap("8d drf")
    # 8e-8g. A3, A5, A7: checkpoints resumed bit for bit, constrained
    # trees, cross-validation, class balancing and calibration
    resumed = phase_checkpoints(card, fr)
    clock.lap("8e checkpoints")
    constrained = phase_constraints(card, fr)
    clock.lap("8f constraints")
    cv = phase_cv(card, fr, multi["frame"])
    clock.lap("8g cv, balance, calibration")
    # 8h. item 13: the streamed GBM, against the dense packed train
    streamed = phase_streaming(card, fr, packed, adaptive)
    clock.lap("8h streaming")
    # 8i. item 14: the mesh, virtual shards on the card, the process groups
    spmd = phase_spmd(card, fr, packed)
    clock.lap("8i spmd")
    for path, launches in spmd.items():
        for kernel in ("binned_level", "binned_route_only",
                       "segment_totals", "adaptive_level",
                       "adaptive_route_only", "binned_level_i8"):
            if launches[kernel]:
                by_name[kernel].setdefault("launches_by_path", {})[
                    path] = launches[kernel]
    for kernel, extra in phase_deep_record(dev).items():
        by_name[kernel].update(extra)
    slice20 = {**resumed, "constrained_packed": constrained, **cv,
               **streamed}
    for path, launches in {**sampling, **forests, **slice20}.items():
        for kernel in ("binned_level", "binned_route_only",
                       "segment_totals", "adaptive_level",
                       "adaptive_route_only"):
            if launches[kernel]:
                by_name[kernel].setdefault("launches_by_path", {})[
                    path] = launches[kernel]
    rec += phase_threefry_record(dev, {
        path: launches["threefry_uniform"]
        for path, launches in {**sampling, **forests, **slice20}.items()
        if launches["threefry_uniform"]})
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("8d deep levels + threefry record")
    # 10. scoring and serving: predict at 10M rows, one CUDA graph a
    # batch bucket, served rows against predict, a concurrent load
    phase_serve(card, fr, packed["model"], xgb_hist,
                csv["airlines_model"], csv["airlines_sample"],
                (multi["model"], multi["frame"]))
    del fr, xgb_hist, csv, multi
    clock.lap("10 serve")
    # 9. the probe tools, P1-P6
    rec += phase_probes(card, dev)
    clock.lap("9 probes")
    rec += phase_global_record(dev, glob["launches"], warm_s, 20)
    rec[-1].setdefault("launches_by_path", {})["spmd41_global"] = \
        spmd["spmd41_global"]["global_hist"]
    clock.lap("6 global record")
    print(f"phase seconds: {json.dumps(clock.laps)}", flush=True)
    print("kernels run: binned_level[W=16,32 x node-grouped, tiled; "
          "W=32,64,128,256 x wide, tiled; W=16 node-grouped: bf16, "
          "float32] binned_route_only "
          "binned_level_i8[W=16,32,64,128,256 x terms=1,2 x node-grouped "
          "(W<=32) or wide (W>=64), tiled, picked] "
          "adaptive_level[rows_f,f_rows x W=16,32,64,128,256; rows_f "
          "node-grouped: bf16, float32, shared-atomics ablation; rows_f x "
          "W=32 x wide, node-grouped, tiled; W=64,128,256 x wide, tiled; "
          "f_rows x column, tiled; f_rows N=32 x route first; f_rows "
          "grower W=32,64] "
          "adaptive_route_only[rows_f,f_rows; each with its loads-only "
          "floor x F=28,8; ragged, n_prev=1, n_prev=2048, unaligned] "
          "adaptive_level_i8[rows_f x W=16,32,64,128,256 x terms=1,2 x "
          "node-grouped (W<=32) or wide (W>=64), tiled, picked; f_rows x "
          "W=16,32,64,128,256 x terms=1,2 x tiled, picked] "
          "leaf_totals[n_prev=0,32 x N=1,64] "
          "segment_totals[N=1,64,512,4096; lanes, match x rows%4=1,2,3, "
          "one node at N=1,64; one node at N=4096] "
          "global_hist[B1=15 uint8,257,1025 int32; node-grouped, global "
          "atomics] group_rows[alone] threefry_uniform[10M rows: uniform, "
          "row sample, per-class row sample] binned_level[deep: W=32 x "
          "N=64,128,256,512 picked] binned_route_only[n_prev=512] "
          "segment_totals[N=1024, picked = match]; index_add_ beside "
          "binned_level "
          "(W=16,32,64,128,256), adaptive_level (W=32,64,128,256), "
          "binned_level_i8 (W=16,64,128,256) and adaptive_level_i8 "
          "(W=32,64,128,256), segment_totals, global_hist; "
          "probes: mxu_probe[M=6,24,96,128,256 x bf16,int8 x FW=896,448 x "
          "L=1,4] gather_probe onehot_probe level_knockouts[grouped W=16,32 "
          "x float,int8; wide W=64,256 x float,int8; tiled f_rows W=32 x "
          "none,route,ranges,bins,adds,walk,gather x N=2,32; P3 L=1,2,4 "
          "eager, graph] level_variants[grouped, wide, tiled, atomics, "
          "noroute, noloinv]", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rec}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
