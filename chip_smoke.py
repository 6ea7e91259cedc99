#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's paths. First the fused two-stage serve path, at the
repository's large serve configuration (``bench.py::bench_serve_e2e_large``): 6,040
users, a 1,000,000-item catalog, two towers of width 128, a bf16 fused
index with the item-bias column, the MLP LambdaRank ranker (128, 64) over
52 features with query norm and blend 1, top-500 candidates, top-100
output, the seen filter. Weights and data are random, made from ``--seed``
and written in the JAX package's file formats.

Then the same serve path with the index stored in int8 (``INDEX_DTYPE=int8``,
the int8 window kernel for batches of 1,024 users); then the request path:
both pipelines behind the port's HTTP app and micro-batcher
(``serving/app.py``, ``MICRO_BATCH_MAX=1024``), driven over the loopback by
closed-loop clients, so that live ``/recommend`` traffic reaches the window
kernels in 1,024-user dispatches; the bf16 serve path again with the
histogram GBDT ranker (``RANKER_TYPE=gbdt``, 200 trees of depth 6, random
from ``--seed``); and the int8 capacity
shape of ``scripts/capacity_30m.py``: 30,000,000 random unit rows x 128,
window 512, k=500, Q=1024, which the port's retrieval drivers run (with
``recall_10m``'s 10M x 128 bf16 and the 1M-row ones).

Then, over the same saved bf16 corpus, the three kernels no serve or train
path runs: the queries-major window kernel (``mips_topk_window``), the fold
kernel (``mips_topk_fused``) and the row gather (``gather_rows``) over the
serve's packed item table; then the kernel probe
(``recommendit_tpu_torch.scripts.kernel_probe``, the counterpart of
``scripts/pallas_probe.py``) in its four variants at 1M x 128, the path
that drives the queries-major window and fold kernels.

Then the verified index mode (``INDEX_MODE=verified``) over the same 1M
catalog in f32, and host-table training (``HOST_TABLE=True``) at the
``ml25m`` configuration of ``scripts/host_table_scale.py`` (dim 256, batch
2,048: the BPR kernels at their widest rows).

Then two-tower training and the offline pipeline, at the repository's BPR training configuration
(``bench.py::bench_bpr_train``, ML-1M shape): 6,040 users, 3,952 items,
towers 64/128, batch 1,024, dropout 0.2, AdamW under a cosine schedule with
global-norm clipping at 1.0, ``LOSS_MODE=in_batch``, on synthetic ML-1M
data (1,000,209 ratings requested) made from ``--seed``; then the pipeline
CLI's ``all`` on the same data (the ML-1M shape: 6,040 users, 3,952 items;
2 tower epochs, not 60): data, features, embeddings, index, ranker (two
inner towers, the LambdaRank MLP (128, 64) over 52 features trained),
load_features, skew, evaluate; then ``ranker`` with ``RANKER_TYPE=gbdt``
(its own two inner towers, the GBDT trained on the card) and ``evaluate``
again; then ``embeddings`` and ``index`` with ``HOST_TABLE=True``.

Then the Criteo-style CTR family at ``make ctr``'s configuration
(``scripts/ctr_train.py``: 500,000 synthetic impressions from ``--seed``
over 20,000 users x 5,000 items, 5 epochs, batch 4,096, embed 16,
retrieval 32, top (256, 128), the sparse table mode; a 26,660-row stacked
table), joint and plain, and the table-scale shape of RESULTS.md's CTR rows
(1,101,660 rows x 32 at batch 8,192, one epoch).

Last, the multi-device layer (``recommendit_tpu_torch/parallel``) at world
size 1 on NCCL (one card cannot hold two NCCL ranks): the sharded
two-tower step at ``scripts/scale_smoke.py``'s ``ml25m`` widths (the BPR
kernels at 2,048 x 256), both sharded merges over the 1M-item catalog,
the sharded serve function on the serve configuration and a joint CTR
step at ``make ctr``'s widths, each against the port's single-device
functions, and a CTR checkpoint resumed across a restart of the process
group.

Phases (each failure raises, so the exit code is not 0):

1. build the CUDA kernels from ``recommendit_tpu_torch/csrc`` (one nvcc per
   source, all started together); then, while this process holds nothing
   on the card, each in a fresh process (``parallel/launch.spawn``, one
   NCCL rank): the BPR kernel phase (16 below), then the web100m_shard
   phase, one rank of
   ``scale_smoke --config web100m --full --nproc 4``
   (``scale_smoke.train_shard`` with ``of_shards=4`` on a (1, 1) mesh:
   25,000,001 user and 2,500,001 item rows, dim 128, hidden 256, batch
   4,096, dropout 0.2, clipping 1.0, AdamW 1e-3 / decay 1e-4, the item
   bias and genre table at all 10,000,004 rows), 6 steps; checks: no
   out-of-memory error, the losses finite, kernels 5 and 6 once each a
   step (at (4,096, 128)) and within the BPR phase's tolerances of their
   twins on the step's own towers, the optimizer's kernel
   (``csrc/adamw.cu``) once a step, the peak allocated above the state
   (params, grads, two moments) within ``shard_peak_bound_gib``; then the
   adamw_fused phase: the optimizer's kernel at that rank's exact params
   (``web100m_shard_shapes``: the towers, the item bias at 10,000,004
   rows, 25,000,001 and 2,500,001 table rows x 128; 3.53 G elements)
   against its foreach path, every chunk group bit-equal after one step
   by row ranges, then the groups of each param's last rows and of
   element 2^31 bit-equal after the step's one launch over the whole
   tensors, its ms against its bound (28 bytes an element) and the
   foreach path's, the clip's norm's and ``torch._fused_adamw_``'s ms;
   then the dlrm_bags phase: DLRM-DCNv2's bags and table update
   (``csrc/embedding_bag.cu``) at the benchmark cell's shape (one card's
   51,137,046 x 128 rows, 16,384 examples of 214 Zipf(1.05) ids): the
   forward bit-equal to the plain sum, the update within 1e-4 by norm of
   the plain update of the touched rows from a warm and a zero
   accumulator, the rows one slot names bit-equal; the kernels', the
   sort's, the plain versions' and ``F.embedding_bag``'s ms; then
   ``dcn_step`` over the same table: one launch of each kernel a step, no
   wait for the host, the counter of rows updated, ms a step
   (:func:`dlrm_bags_phase`);
2. write the artifacts, embed the catalog with the port's item tower and
   build + save the fused bf16 index and, from the same embeddings and
   bias, the fused int8 index (quant seed ``--seed``);
3. kernel phase: at Q in {256, 1024} over the 1M x 129 (136 padded) bf16
   corpus, W=64, k=500, the kernel (its tensor-core body, ``tc_route``)
   against its plain twin — window maxima within 1e-3, top-500 id overlap
   >= 0.99, recall@500 >= 0.98 against the exact top-500 of the same
   scores — and both times (CUDA events), the share of the bound reached,
   and ``gemm_only_ms``: the product alone as cuBLAS bf16 matmuls into f32
   (a yardstick the port never calls);
4. serve phase: ``batch_recommend`` for 2,048 users at batch 1,024 (the
   kernel route: one launch per batch) and 20 single requests (the scan
   route: none), with the launch counts read around exactly that run; then
   ``MIPSIndex.search_device`` (results left on the card) on the first
   batch's 1,024 user-tower rows, twice, against ``batch_search`` on the
   same queries: ids equal after ``canonical_tie_order``, scores within
   1e-3, one kernel-1 launch a call (``_WindowLaunches``); then
   ``torch.profiler`` over 10 ``serve_batch`` calls of 1,024 users: device
   time per call by kernel group, host clock, the device's idle share;
5. quantize phase: at 1M x 129, the catalog's augmented f32 rows, the
   quantize kernel against its twin (int8 values and scales equal), and
   the times of both and of the build quantizer (threefry);
6. int8 kernel phase: at Q in {256, 1024} over the saved 1M x 129 (144
   padded) int8 corpus, W=64, k=500, the int8 window kernel (its
   tensor-core body, ``tc_route``) against its twin — window maxima and
   positions equal, top-500 ids equal — recall@500 >= 0.98 against the
   exact top-500 of the same int8 scores and >= 0.95 against the exact
   top-500 of the unquantised f32 rows; the times of the kernel, the twin,
   ``int8_gemm_only_ms`` (``torch._int_mm``, the int8 product alone: a
   yardstick the port never calls) and the dp4a body through its own entry
   (``dp4a_ms``, its output equal to the twin's too); ptxas's registers and
   spills of the int8 library; then the dp4a body where the wrapper takes
   it, rows of 400 columns, equal to the twin;
7. int8 serve phase: the serve phase over the int8 index, with exactly one
   int8 window launch per batch and none of the bf16 kernel, and its
   ``search_device`` check with one kernel-3 launch a call; then the
   profile of step 4 over 10 int8 batches (``serve_profile_int8``);
8. HTTP phase: the bf16 serve phase's pipeline behind the port's app
   (``serving/app.py``) on the threaded server at 127.0.0.1, a free port,
   micro-batching on (``MICRO_BATCH_MAX=1024``, a wait of
   ``HTTP_WAIT_MS``): ``/health`` loaded, then closed-loop clients at 1,
   64 and 512 in flight (4, 128 and 2,048 requests, one distinct user
   each, ``use_cache`` false), the launch counts set to 0 just before each
   level and read just after; every returned list equal to the direct
   ``serve_batch`` of the bucket it was served in (the same users in the
   same rows; scores within 1e-4, ids equal up to ties within 1e-4); at
   512 at least one live dispatch of more than 256 requests (the 1,024
   bucket), each such dispatch exactly one window-kernel launch; no error
   record (a serve failure answered from popularity logs one); then
   ``/recommend/batch`` for 100 users equal to ``batch_recommend``,
   ``/model/info``, ``/items/{id}`` and a user-feature update that changes
   that user's next list. QPS and p50/p99 per level, batch sizes, the
   first live batch's time and a fresh thread's first and second
   1,024-user batch. Then the 512 level once over the int8 serve phase's
   pipeline (kernel 3); last, a ``{"feature_store": ...}`` line: the
   backend the served pipelines' stores chose (Redis where the ``redis``
   package is there and the server answers, else ``in-memory``) and the
   wire format (``msgpack`` where that package is there, else ``json``);
9. GBDT serve phase: the bf16 serve path with a random GBDT ranker in
   JAX's format (``write_random_gbdt``: 200 full trees of depth 6 over the
   52 columns, 64 bins whose edges are quantiles of rows assembled from
   the packed tables; ``RANKER_TYPE=gbdt``'s defaults): ``batch_recommend``
   for 1,024 users at batch 1,024 (one kernel-1 launch) and 20 single
   requests (none), counted around exactly that run; every list against a
   reference from the same candidates scored by the GBDT's host
   ``predict`` (in spawned processes), the same blend and seen mask,
   scores within 1e-4; the device scores within rtol 1e-4 / atol 1e-5 of
   the host's; ``torch.profiler`` over 5 batches, the tree descent alone
   by CUDA events, the batch's peak memory;
10. queries-major window phase: at Q in {256, 1024} over the saved bf16
   corpus, W=64, the queries-major kernel against its twin (maxima within
   1e-3, top-500 id overlap >= 0.99) and against the items-major kernel
   (maxima and positions equal to its transpose); then Q=1024 at W=128, its
   default, timed with its twin;
   then the router's two routes (``mips_topk_fused_route``: the dense scan
   and the window kernel) timed at Q in {1, 16, 64, ..., 1024} beside the
   route the router takes (its constants unchanged);
11. fold phase: ``mips_topk_fused`` at Q=1024 over the valid rows, block
   2048, R=64: the tensor-core body (``tc_route``: the f32 queries split
   into three bf16 pieces by the split kernel, equal to its twin bit for
   bit) with candidates within 1e-4 (relative to the largest) of the twin,
   every checked score within 2e-6·Σ|q_k·x_k| of f64 (``f64_err``), also on
   queries whose third piece moves each score by ~4e-6·Σ|q_k·x_k|
   (``lo_case``), where the twin of the first two pieces alone must exceed
   that limit (``two_piece_f64_err``: a kernel without the third piece would
   fail); recall@500 >= 0.98 against the exact top-500 of the same f32-query
   scores; integer-valued inputs full of ties (f32 and bf16, bins narrower
   and wider than a tile, a bias pad, a bf16 case of the tensor-core body
   with a block of one real row) equal to the twin, through the wrapper's
   body and through the CUDA-core entry; the times of the kernel, its twin,
   the CUDA-core body (``cuda_cores_ms``), the kernel at R=32 and the
   split; ptxas's registers and spills of the fold library;
12. gather phase: ``gather_rows`` of a (1024, 500) int64 index into the
   packed item table (1,000,001 x 64 f32) — the counted run — equal to the
   twin, and with out-of-range and int32 indices, a 23-wide f32 and a bf16
   table; the times of the kernel, the twin and ``torch.index_select``;
13. probe phase: the kernel probe's four variants in-process at N=1M,
   D=128, Q=1024, k=500, block 2048, W=64, bf16, each exiting 0, with the
   window and fold launch counts read around exactly that run;
14. verified phase (``INDEX_MODE=verified``): the catalog's augmented f32
   rows (129 wide, 136 on the card) built into a verified and an exact f32
   index; at Q in {1, 256, 1024}, k=500, the verified device searcher
   (``mips_topk_certified``, count method) and the bound method against
   the exact top-500: values within C.22's bound 2(D−1)·2⁻²⁴·Σ|q_k·x_k|,
   ids equal after ``canonical_tie_order`` or tied within the bound; the
   escalations counted (none expected), one forced escalation (a broken
   engine) equal to exact; ms per call of verified, bound, exact and the
   fused bf16 route; then a 1,024-user ``serve_batch`` of a verified
   pipeline against an exact one, every list equal, scores within 1e-4;
15. drivers phase: the seven retrieval drivers of
   ``recommendit_tpu_torch/scripts`` (the counterparts of ``scripts/``'s) in
   one process at their defaults but ``fused_decomp``'s Q=1,024 only
   (``DRIVER_ARGS``),
   each corpus freed before the next, each report and its seconds printed,
   kernel 1's and 3's launches counted around exactly each run:
   ``recall_10m`` (10M x 128 bf16 unit rows made on the card, Q=64, kernel
   1 at W=512 over 10,002,432 padded rows, the tail masked: its
   tensor-core body; on 8 queries its window maxima within 1e-5 of the
   twin's, computed in row chunks, and its positions equal but for ties
   within 1e-5; recall@500's mean at most 0.01 under the bin model's
   1 − 499·512/(2·10⁷); kernel 1's time at Q=64 and its bound);
   ``capacity_30m`` (the capacity checks: 30M x 128 random unit rows made
   and quantised on the card in chunks, kernel 3's tensor-core body at
   W=512, Q=1024 timed, on 64 queries recall@500 >= 0.98 against
   int8-exact, and on them kernel 3's maxima and positions equal to the
   twin's); ``mips_ab``
   (2^20 x 128, Q=256 and 1,024: the dense route and kernel 1 over the f32
   corpus, its CUDA-core body, and the bf16 one, its tensor cores; both
   bodies against the twin on 8 queries as above, no mask); ``fused_decomp``
   at Q=1,024 (kernel 1 at W=64 and 32 masked, unmasked, the auto entry;
   the tail top-k; then kernel 1's tensor cores at W=32 over the 1M
   padded rows, the tail masked, against the twin on 8 queries as above); ``recall_curve``
   (1M x 128, batch 256: exact, verified, four approx rows, int8-exact);
   ``bound_turf`` (d = 128, 512, 1,024); ``tail_probe``;
16. BPR kernel phase (run in step 1, in a fresh process: late in a long
   process every ``torch.profiler`` session of it lost its first launches,
   ROADMAP B.17): at B=1024 and a ragged B=1000, D=64 f32, the forward
   and backward kernels against their twins — the loss within 1e-5
   relative, du and dv within 1e-4 of the twin's largest entry, a second
   call equal bit for bit — all four times by CUDA events and, since by
   events a call of these wrappers is bound by its host side, by
   ``torch.profiler`` (the kernels' own device time, which the kernels
   line reports), ``gemm_only_ms`` (``u @ v.T`` in full f32: a yardstick
   the port never calls), the bounds (f32, and 3xTF32 at the TF32 peak)
   and the bpr library's ptxas registers and spills; also at (2048, 256),
   the host-table path's shape; at each shape ``TwoTower.in_batch_bpr_loss``
   forward and backward against the twins at the same tolerances, each
   kernel launched once (``two_tower``);
   From here to the parallel phase (17, 18, 20, 22-24) every
   ``OptaxAdamW.step`` on the card is counted around each phase and must
   launch the optimizer's kernel once (``_AdamWSteps``; the kernels
   line's ``<phase>_launches`` of ``adamw_fused``);
17. host-table phase: ``scripts/host_table_scale.py`` at ``ml25m``
   (162,541 users, 62,423 items, dim 256, hidden 512, batch 2,048, 1M
   positives from ``--seed``, ``LOSS_MODE=in_batch``, adagrad rows at lr
   0.05, prefetch 2, dropout 0, 2 epochs), the tables (166 + 64 MB) on the
   host: one launch of each BPR kernel a step (976), the losses finite and
   falling, examples/s and the host-clock parts of a step (gather, wait,
   step, d2h, apply_grad); the catalog streamed through the item head equal
   to ``to_model()``'s within 1e-6 and an index built from it; then the
   in-HBM ``EmbeddingTrainer`` on the same stream (``--mode hbm``);
18. train phase: the synthetic data, its 0.9 temporal train view, 2 epochs
   of in-batch BPR (the loss finite, falling, below ln 2; one forward and
   one backward kernel launch per step, counted around exactly that run),
   then 1 epoch of the default softmax loss (no BPR launch); then
   ``torch.profiler`` over a 67-step in-batch epoch with the kernels and
   with the twins: device µs per step by kernel group, host ms per step;
19. index phase: ``IndexBuilder`` on the in-batch model (exact f32 index),
   ``batch_search`` for 1,024 users with held-out positives: valid ids,
   and Recall@20 of the held-out 10 % positives (train items filtered)
   above a random ranking's;
20. pipeline phase: the pipeline CLI's ``all``
   (``recommendit_tpu_torch.pipelines.run_pipeline``) on the train phase's
   data written as ML-1M ``.dat`` files (read back equal) and zipped as
   GroupLens's archive lays them out (``ml-1m/ratings.dat``, ...):
   ``data`` fetches that archive from its ``file://`` address
   (``MOVIELENS_1M_URL`` pointed there for the run and restored after,
   every socket connect refused) and extracts it into an empty
   ``ml-1m/``, the files byte-equal to those written; ``features``;
   ``embeddings`` (Settings defaults but ``LOSS_MODE=in_batch``, 2 epochs
   not 60); ``index`` (exact f32);
   ``ranker`` (candidate mode: two inner towers on the 0.9 and 0.8
   histories, their exact indexes, 200 negatives a query, the LambdaRank
   MLP (128, 64) over 52 features with query norm, 40 epochs with early
   stopping); ``load_features`` (the store and ``features.fsnap``);
   ``skew``; ``evaluate``. Each BPR kernel launched once a step of the
   three tower trainings (the wrappers' counts set to 0 just before
   ``all`` and read just after; ``torch.profiler`` over a window of each
   training's steps, ``TRAIN_PROFILE_WINDOW``: windows of 100 steps to its end, one exact, the
   records lost over all of them within ``PROFILER_RECORD_LOSS``),
   every tower loss finite and below ln 2; every ranker epoch's loss
   finite, a best epoch, the holdout NDCG@10 above a seeded random
   scorer's on the same groups; ``features.fsnap`` equal to the feature
   files; a second ``embeddings`` run resuming from
   ``two_tower_ckpt/best`` with no step and the same model; the packed
   tables equal, bit for bit, to those ``RecommendationPipeline.load``
   recomputes; then ``index`` and ``evaluate`` again for the fused bf16
   and int8 index, the window kernels' launches counted around each
   evaluate (none at this catalog: JAX's window rule gives W=4 over 3,952
   rows at k=500, and the fused route scans exactly). Every evaluate run
   covers every user with held-out positives — every value finite, the
   full and popularity lists 20 distinct unrated items, the
   retrieval-only lists the first 20 unrated
   items of the index's top-500, and its NDCG@10 and Recall@20 above a
   seeded random ranking's — and ``skew`` reads max KL 0.0 over 50
   features. It prints the stage times, the ranker's holdout report, best
   epoch and epochs run, the three rows (full, popularity,
   retrieval-only) of each report with the paired NDCG@10 full minus
   retrieval-only, and int8 minus bf16 of the retrieval-only row.
21. GBDT pipeline phase: ``--stage ranker`` with ``RANKER_TYPE=gbdt`` at
   the GBDT defaults (200 trees, depth 6, 64 bins, learning rate 0.1,
   subsample and colsample 0.8), then ``--stage evaluate``, on the
   pipeline phase's data and directories: the device backend; its own two
   inner towers with one launch of each BPR kernel a step, as many steps
   as the MLP ranker stage's; trees, a best iteration, finite validation
   NDCG@10; the holdout NDCG@10 above a random scorer's; the device scorer
   against the host ``predict`` on every holdout row (rtol 1e-4, atol
   1e-5); ``save`` → ``load_ranker`` → ``predict`` equal; the first tree
   grown again from the same inputs on the CPU (any differing split a
   near-tie within its f32 bound) and twice on the card (whether repeat
   runs agree is printed); the evaluate report checked as in 20, its full
   row printed beside the MLP's, popularity's and retrieval-only's; the
   stage's parts (inner towers, candidate builds, binning, boosting, the
   grower's ms a tree, the host's validation a round);
22. host-table pipeline phase: ``--stage embeddings`` and ``--stage index``
   with ``HOST_TABLE=True`` on the pipeline phase's ``.dat`` files (1
   epoch, in-batch BPR, the train cell's widths): one launch of each BPR
   kernel a step, the model and index written, Recall@20 of the index
   above a random ranking's.
23. CTR phase: (a) ``make ctr`` through the port's ``ctr_train`` code,
   joint and plain: the losses finite and falling, AUC above 0.55 and
   logloss below the constant predictor's + 0.05 (``tests/test_ctr.py``'s
   limits), joint recall@10 and @50 above a seeded random ranking's;
   examples/s per epoch and ms a step; (b) the first 3 sparse joint steps
   on the card and on the CPU from the same params and batches
   (``ctr_card_vs_cpu``: each param's, the table's and the accumulator's
   L2 distance within 5 % of its move, the losses within 1e-6); (c) ``torch.profiler``
   over 20 sparse joint steps: launches and device µs a step by part of
   the step, the top kernels, the device's idle share; (d) one epoch in
   each table mode (sparse, dense) at 1,101,660 x 32, batch 8,192: ms a
   step, examples/s, peak device memory, dense over sparse.
24. parallel phase: a process group of one rank (NCCL through a
   ``file://`` store under the workdir) and a (1, 1) mesh, then (a) 3
   steps of the sharded two-tower step (``make_sharded_train_step``:
   162,541 x 62,423 x 256, hidden 512, batch 2,048, dropout 0.2, clipping
   1.0, AdamW 1e-3 / decay 1e-4, random weights from ``--seed``) against
   the single-device step composed from the port's towers,
   ``in_batch_bpr_loss``, ``clip_by_global_norm_`` and ``OptaxAdamW``
   from the same weights, batches and dropout generator: one launch of
   each BPR kernel a sharded step (counted around exactly each), the
   losses within 1e-5 relative, each param's distance within 1 % of its
   move; ms a step of both in blocks of 10 (sharded, single, single,
   sharded), then ``torch.profiler`` over 5 steps of each (the host clock,
   the kernels' device time, launches, idle share); (b) both merges (``canonical=True``) at Q=256, k=500 over the
   1M x 129 catalog rows, ids and values equal to ``mips_topk`` in
   ``canonical_tie_order``, the three times; (c) the sharded serve of
   1,024 users (the two-tower, the catalog's unit rows, the packed tables,
   a random MLP (128, 64) over the 50 columns; top-500, top-100) against
   the single-device composition, every list by ``check_list``, both
   times; (d) one joint CTR step at ``make ctr``'s widths (26,660 x 16,
   batch 4,096) against the single-device joint step, as (a); (e)
   ``scripts/multiproc_smoke.py``'s 4 CTR steps with the state saved at
   step 2, the process group destroyed and made anew, steps 2-3 resumed
   with losses equal; (f) the ``OptaxAdamW`` step (on the card its kernel;
   its foreach path cuts the tables into 56 groups at chunk 2^20) against
   its one-pass form at (a)'s params over 3 steps of seeded gradients:
   params, mu and nu bit-equal, and both times.
25. quality phase: the port's
   ``scripts/quality_at_scale.py`` at the ``ml25m`` catalog's full width
   (162,541 x 62,423, dim 64) with the script's own overrides
   ``LOSS_MODE=in_batch``, ``INDEX_MODE=fused``, ``INDEX_DTYPE=bfloat16``
   (kernels 5 and 6 every step of the host-table tower and of the ranker
   stage's inner towers; kernel 1 for every evaluate batch: 62,423 rows
   take the kernel route at any batch size); depth cut (``QUALITY_ARGS``,
   printed as ``quality_cuts``); checks: the ladder finite, the evaluate
   stage's lists as the pipeline phase checks them (``check_eval_lists``:
   the retrieval-only lists the index's own search, its NDCG@10 above a
   seeded random ranking's of the same users' unseen items), kernel 1
   against its twins on the run's own index and the evaluate stage's
   user-tower queries at both shapes the stage gave it (a batch of 256
   and the retrieval-only search of every evaluated user), the sharded
   ids identical to the single device's (world size 1 on NCCL), the
   wrappers' counts equal to the steps and the evaluate batches; then ``scripts/ranker_ab.py`` (one variant at
   beta 1, 2) over that work-dir and ``scripts/seed_variance.py`` (2 seeds
   at its full width, epochs cut); then exact ``mips_topk`` at Q=1,024
   over 20,000,000 x 128 f32 unit rows (``C58_SHAPE``: 82 GB of scores in
   one product, so it runs in column chunks of ``_SCORE_BUDGET`` entries),
   the peak memory above the corpus under two chunks' scores, 16 queries'
   values and ids equal to ``_scan_topk`` at "highest" up to ties.
26. sweeps phase: the last six drivers of ``recommendit_tpu_torch/scripts``
   through their ``run``, at their own default widths with depth cut
   (``SWEEPS_ARGS``, printed as ``sweeps_cuts``), the wrappers' counts set
   to 0 just before each and read just after: ``tower_sweep`` (q3k, 3,000
   x 2,000 x 400k, ``LOSS_MODE=in_batch``: kernels 5 and 6 once a tower
   step; its retrieval-only NDCG@10 above a seeded random ranking's of the
   same users, its popularity row equal to the same computation on the
   CPU over its ``.dat`` files); ``blend_sweep`` at beta 0, 1, 2 over the
   quality phase's work-dir (kernel 1 at each evaluate call's own count,
   against its twins on that index; the ``retrieval_only_*`` fields equal
   across beta, every full row finite); ``ladder_sweep`` under the
   generator weights ``SWEEPS_WEIGHTS`` (kernels 5, 6 once a step of the
   towers and the ranker stage's inner towers; the ladder finite; its
   ``.dat`` files bit-equal to the port's generator on the CPU under the
   same weights); ``ranker_headroom`` over its models (six finite
   orderings; the fitted M's expected presents within 1 % of the realized
   ratings); ``real_data`` with no data set in ``--data-dir`` (the golden
   fixture: every stage, kernels 5, 6 once a step, the report written);
   ``train_scope_bench`` at ML-1M shape (kernels 5, 6 once a step; its
   line printed beside the card).

Each phase starts with a ``{"phase_start": ...}`` line (the seconds since
the start, the live threads, the host's resident memory, the card's
reserved memory), and a ``{"phase_records": [...]}`` line before the
kernels line sums them.

Usage, from the repository root: ``python3 chip_smoke.py [--seed N]``.
After the build it prints ptxas's registers, spills and shared memory of
the window kernels (the int8 ones in the int8 kernel phase).
Prints the card's name and power limit, a ``{"kernels": [...]}`` line (each
kernel's launches on its path, error against its twin, time, twin's time
— by CUDA events, for the BPR kernels by ``torch.profiler`` —, bound and,
where one PyTorch call computes the same function, that call's time; the
script fails rather than print a kernel time under its bound) and, last,
``{"ok": true, "device": {...}}``. Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import logging
import math
import multiprocessing
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

N_USERS, N_ITEMS, DIM, HIDDEN = 6040, 1_000_000, 128, 128
N_RATINGS = 1_000_209            # the ML-1M rating count
RANKER_HIDDEN = (128, 64)
TOP_K_CANDIDATES = 500
INDEX_BLOCK = 4096
WINDOW = 64
KERNEL_QS = (256, 1024)
BATCH = 1024
N_BATCH_USERS = 2048
N_REQUESTS = 20
REQUEST_K = 20

KERNEL_SOURCE = "recommendit_tpu_torch/csrc/window_mips.cu"
KERNEL_REPLACES = "recommendit_tpu/ops/pallas_mips.py:359"
BPR_SOURCE = "recommendit_tpu_torch/csrc/bpr.cu"
BPR_REPLACES = {"bpr_fwd": "recommendit_tpu/ops/bpr.py:53",
                "bpr_bwd": "recommendit_tpu/ops/bpr.py:123"}
I8_SOURCE = "recommendit_tpu_torch/csrc/window_mips_i8.cu"
I8_REPLACES = "recommendit_tpu/ops/pallas_mips.py:470"
QUANT_SOURCE = "recommendit_tpu_torch/csrc/quantize_i8.cu"
QUANT_REPLACES = "recommendit_tpu/ops/quantize.py:60"
QM_REPLACES = "recommendit_tpu/ops/pallas_mips.py:233"
FOLD_SOURCE = "recommendit_tpu_torch/csrc/fold_mips.cu"
FOLD_REPLACES = "recommendit_tpu/ops/pallas_mips.py:57"
GATHER_SOURCE = "recommendit_tpu_torch/csrc/gather_rows.cu"
GATHER_REPLACES = "recommendit_tpu/ops/gather.py:27"
ADAMW_SOURCE = "recommendit_tpu_torch/csrc/adamw.cu"
ADAMW_REPLACES = None             # no TPU kernel: XLA fuses optax's update
BAGS_SOURCE = "recommendit_tpu_torch/csrc/embedding_bag.cu"
BAGS_REPLACES = None              # no TPU kernel: JAX's CTR model looks up one id a field
LIBRARIES = ("window_mips", "bpr", "window_mips_i8", "quantize_i8",
             "fold_mips", "gather_rows", "adamw", "embedding_bag")

# the router's two routes (mips_topk_fused_auto) timed at these batch sizes
ROUTER_QS = (1, 16, 64, 128, 256, 384, 512, 1024)

# the kernels no serve or train path runs
QM_WINDOW = 128                   # mips_topk_window's default window
QM_BLOCK = 16384                  # ... and block
FOLD_Q, FOLD_BLOCK, FOLD_R = 1024, 2048, 64
FOLD_JAX_R = 32                   # mips_topk_fused's default reduction
FOLD_F64_Q = 256                  # the fold's queries checked against f64
FOLD_F64_LIMIT = 2e-6             # ... each score's error over its Σ|q_k·x_k|
FOLD_LO_CASE = (65_536, 136, 256)  # (N, D, Q) of the lo-heavy inputs
GATHER_SHAPE = (1024, 500)        # a batch of users x their candidates
PROBE_ARGS = ("--n", "1000000", "--d", "128", "--q", "1024", "--k", "500",
              "--block", "2048", "--window", "64", "--dtype", "bfloat16")

# the H100 SXM's published peaks (dense), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12,
                  "tf32": 495e12}
INDEX_PATHS = {"bfloat16": "index_path", "int8": "index_i8_path"}
# the HTTP phase: closed-loop clients in flight and requests per level, the
# micro-batcher's largest bucket and its wait (ms). A dispatch fills the
# 1,024 bucket only when more than 256 requests arrive within one wait, and
# the threaded server answers about 300 requests a second on the GPU
# machine's host (PERF.md section 5): hence a wait of 0.7 s.
HTTP_LEVELS = ((1, 4), (64, 128), (512, 2048))
HTTP_MAX_BATCH = 1024
HTTP_WAIT_MS = 700.0
HTTP_BATCH_USERS = 100            # the /recommend/batch check
HTTP_TOL = 1e-4
SERVE_KERNELS = {"bfloat16": "window_mips", "int8": "window_mips_i8"}

# the GBDT ranker (RANKER_TYPE=gbdt) at the JAX package's defaults
# (config.py GBDT_*): 200 trees of depth 6 over 64 bins, learning rate 0.1
GBDT_TREES, GBDT_DEPTH, GBDT_BINS, GBDT_LR = 200, 6, 64, 0.1
GBDT_EDGE_ROWS = 65_536           # (user, item) rows whose quantiles are the edges
GBDT_RTOL, GBDT_ATOL = 1e-4, 1e-5  # host predict vs the device scorer (test_gbdt.py)
GBDT_ROUND_TRIP_ROWS = 20_000     # rows predicted again from the saved file
GBDT_SERVE_USERS = 1024           # one batch of the kernel route
GBDT_HOST_WORKERS = 8             # processes of the host-predict reference

# the int8 kernel's extra check: the dp4a body where the wrapper takes it
# (rows past the tensor cores' 384 columns)
WIDE_I8_DIM, WIDE_I8_ROWS = 400, 262_144

# capacity: scripts/capacity_30m.py
CAPACITY_ROWS, CAPACITY_DIM, CAPACITY_WINDOW = 30_000_000, 128, 512
CAPACITY_Q, CAPACITY_CHECK_Q = 1024, 64
CAPACITY_CHUNK = 1 << 21          # rows made and quantised at a time
CAPACITY_ITERS = 10               # chained batches a round (the script's default)

# the retrieval drivers (recommendit_tpu_torch/scripts) at their defaults
# but fused_decomp's batches (Q=1,024 only); the phase took 36-40 s at these
# on an H100 80GB HBM3 at 700 W
DRIVER_ARGS = {
    "recall_10m": (),
    "mips_ab": (),
    "fused_decomp": ("--qs", "1024"),
    "recall_curve": (),
    "bound_turf": (),
    "tail_probe": (),
}
DRIVER_CHECK_Q = 8                # queries of kernel 1's twin checks
DRIVER_CHECK_SEED = 17
# kernel 1 against its twin: the products are exact (bf16 x bf16, or f32
# FMAs against cuBLAS f32), the f32 sums of 128 run in another order
DRIVER_TWIN_TOL = 1e-5
FUSED_CHECK_WINDOW = 32           # fused_decomp's window that no other path runs
TIMER_CHAIN_SHAPE = (256, 500, 128)   # (Q, k, d) of the timer's own-cost probe
RECALL_10M_MAX_DROP = 0.01        # mean recall@500 under the bin model's at most

# training: bench.py::bench_bpr_train at ML-1M shape
TRAIN_USERS, TRAIN_ITEMS = 6040, 3952
TRAIN_DIM, TRAIN_HIDDEN, TRAIN_BATCH, TRAIN_DROPOUT = 64, 128, 1024, 0.2
TRAIN_EPOCHS = 2
TRAIN_SPLIT = 0.9
# the host-table phase's shape first: its kernels line reports it
BPR_SHAPES = ((2048, 256), (1024, TRAIN_DIM), (1000, TRAIN_DIM))
PROFILE_STEPS = 67                # steps of the profiled training epochs
PROFILE_TRIES = 3                 # torch.profiler sessions before one counts as empty
INDEX_USERS, RECALL_K = 1024, 20

# host-table training: scripts/host_table_scale.py's ml25m configuration
# (162,541 users, 62,423 items, dim 256, hidden 512, batch 2,048), 1M
# positives from --seed, in-batch BPR, adagrad rows, prefetch 2, dropout 0
HOST_SCALE_ARGS = ("--config", "ml25m", "--ratings", "1000000", "--epochs", "2",
                   "--prefetch", "2", "--loss-mode", "in_batch")
HOST_CATALOG_TOL = 1e-6           # streamed catalog vs to_model()'s
HOST_PIPELINE_EPOCHS = 1

# the verified index mode over the serve phase's 1M-item catalog (f32)
VERIFIED_QS = (1, 256, 1024)

# the CTR family: `make ctr` (scripts/ctr_train.py: 500,000 impressions over
# 20,000 users x 5,000 items, 5 epochs, batch 4,096; Settings' CTR defaults:
# embed 16, retrieval 32, top (256, 128), joint, sparse table mode)
CTR_TRAIN_ARGS = ("--examples", "500000", "--users", "20000", "--items", "5000",
                  "--epochs", "5", "--batch-size", "4096")
CTR_MIN_AUC, CTR_LOGLOSS_SLACK = 0.55, 0.05   # tests/test_ctr.py's limits
CTR_RECALL_KS = (10, 50)
CTR_CHECK_STEPS = 3               # sparse joint steps, the card against the CPU
# the card against the CPU after those steps (see ctr_card_vs_cpu): each
# tensor's distance from the CPU's within CTR_REL_L2 of its move, the
# losses within CTR_LOSS_RTOL; entries beyond CTR_TIGHT_TOL are counted
CTR_REL_L2, CTR_LOSS_RTOL, CTR_TIGHT_TOL = 0.05, 1e-6, 1e-5
CTR_PROFILE_STEPS = 20
# the table-scale shape of RESULTS.md's CTR rows: a 1,101,660-row stacked
# table x 32 at batch 8,192, 26 fields, one epoch a table mode
CTR_SCALE_DATA = dict(n_examples=1_000_000, n_users=1_000_000, n_items=100_000)
CTR_SCALE_DIM, CTR_SCALE_BATCH = 32, 8192
# the multi-device layer (parallel/*) at world size 1 on NCCL: the sharded
# two-tower step at scripts/scale_smoke.py's ml25m widths (162,541 users,
# 62,423 items, dim 256, hidden 512, batch 2,048), dropout 0.2, clipping at
# 1.0 and AdamW (1e-3, decay 1e-4), against the single-device step
PAR_TWO_TOWER = (162_541, 62_423, 256, 512, 2048)
PAR_CHECK_STEPS = 3
PAR_TIMED_STEPS = 10              # a block; blocks run sharded, single, single, sharded
PAR_PROFILE_STEPS = 5             # steps of each under torch.profiler
PAR_LOSS_RTOL = 1e-5              # the sharded loss against the single-device one
PAR_REL_L2 = 0.01                 # each param's distance within 1 % of its move
PAR_MERGE_Q = 256                 # both merges over the 1M x 129 catalog rows
PAR_SERVE_K = 100                 # the serve configuration's top-100 output
# one joint CTR step at `make ctr`'s widths (20,000 users x 5,000 items:
# the 26,660-row table; embed 16, retrieval 32, top (256, 128), batch 4,096)
PAR_CTR = dict(n_users=20_000, n_items=5_000, batch=4096, embed=16,
               retrieval=32, top=(256, 128))
PAR_ADAM_CHUNK = 1 << 20          # the chunked step's chunk in the bit-equality check
# one rank of `scale_smoke --config web100m --full --nproc 4` on one card
# (the configuration, and the model axis the tables are laid out over):
# 25,000,001 user and 2,500,001 item rows at dim 128, hidden 256, batch
# 4,096; the item bias and genre table at all 10,000,004 rows
SHARD_RUN = ("web100m", 4)
SHARD_TIMEOUT_S = 600
ADAMW_REPS = 10                   # the adamw_fused phase's timed steps: the kernel
ADAMW_PLAIN_REPS = 3              # ... and its foreach path
BPR_TIMEOUT_S = 300               # the BPR phase's fresh process


def _demangle(symbol: str):
    """(the innermost name, its template arguments' mangled text or "") of
    an Itanium-mangled kernel symbol: the names of a nested name are read
    by their length prefixes."""
    i, name = (3 if symbol.startswith("_ZN") else 2), ""
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while j < len(symbol) and symbol[j].isdigit():
            j += 1
        i, name = j + int(symbol[i:j]), symbol[j:j + int(symbol[i:j])]
    m = re.match(r"I(\w*?)EEv", symbol[i:])
    return name, m.group(1) if m else ""


def ptxas_summary(log: str):
    """Registers, spill bytes and static shared memory of each kernel in a
    ``ptxas -v`` report, by kernel and template arguments."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(_Z\w+)'", line)
        if m:
            base, targs = _demangle(m.group(1))
            kinds = (["bf16"] if targs.startswith("13__nv_bfloat16")
                     else ["f32"] if targs.startswith("f") else [])
            kinds += re.findall(r"L[ib](\d+)E", targs)
            name = f"{base}<{','.join(kinds)}>" if targs else base
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
        elif name and (m := re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)):
            out[name]["registers"] = int(m.group(1))
            out[name]["static_smem"] = int(m.group(2) or 0)
    return out


PHASE_RECORDS = []


def _status_gib(keys=("VmRSS", "VmHWM")) -> dict:
    """This process's ``/proc/self/status`` sizes ``keys`` in GiB (none
    where the file is not there)."""
    out = {}
    try:
        lines = Path("/proc/self/status").read_text().splitlines()
    except OSError:
        return out
    for line in lines:
        key, _, val = line.partition(":")
        if key in keys:
            out[key] = int(val.split()[0]) / 2**20      # kB
    return out


def phase_start(name: str, t_start: float) -> dict:
    """One record at a phase's start, printed and kept in
    ``PHASE_RECORDS``: the seconds since the script began, the live threads
    (counted by name, digits folded), the host's resident memory now and at
    its peak, and what the caching allocator holds on the card (B.19)."""
    names = {}
    for t in threading.enumerate():
        key = re.sub(r"\d+", "N", t.name)
        names[key] = names.get(key, 0) + 1
    mem = _status_gib()
    rec = {"phase": name, "since_start_s": time.perf_counter() - t_start,
           "threads": sum(names.values()), "thread_names": names,
           "rss_gib": mem.get("VmRSS"), "rss_peak_gib": mem.get("VmHWM"),
           "cuda_reserved_gib": (torch.cuda.memory_reserved() / 2**30
                                 if torch.cuda.is_available() else None)}
    PHASE_RECORDS.append(rec)
    print(json.dumps({"phase_start": rec}), flush=True)
    return rec


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _glorot(rng, shape):
    limit = float(np.sqrt(6.0 / (shape[0] + shape[-1])))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def write_random_ranker(path: str, rng, device) -> None:
    """The serve configuration's ranker, random: an MLP (128, 64) with query
    norm over the 50 features and the two retrieval columns, Glorot weights
    and a random standardisation, drawn from ``rng``."""
    from recommendit_tpu_torch.features.schema import FEATURE_COLUMNS
    from recommendit_tpu_torch.models import LambdaRankScorer

    names = FEATURE_COLUMNS + ["retrieval_score", "retrieval_rank"]
    ranker = LambdaRankScorer(feature_names=names, hidden_dims=RANKER_HIDDEN,
                              query_norm=True, device=device)
    dims = [len(names), *RANKER_HIDDEN, 1]
    ranker.params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ranker.params[f"w{i}"] = torch.as_tensor(_glorot(rng, (a, b)))
        ranker.params[f"b{i}"] = torch.zeros(b)
    ranker.feat_mean = rng.standard_normal(len(names), np.float32)
    ranker.feat_std = rng.uniform(0.5, 2.0, len(names)).astype(np.float32)
    ranker.save(path)


def _random_tree(rng, n_feat: int, n_bins: int, depth: int):
    """A full tree of ``depth`` in the numpy grower's layout (node ids
    allocated depth-first): random split features, thresholds and gains,
    standard-normal leaf values."""
    import itertools

    from recommendit_tpu_torch.models.gbdt import _Tree

    n_split = (1 << depth) - 1
    splits = iter(zip(rng.integers(0, n_feat, n_split), rng.integers(0, n_bins - 1, n_split),
                      rng.random(n_split)))
    leaves = iter(rng.standard_normal(1 << depth).astype(np.float32))
    ids = itertools.count(1)
    tree = _Tree(1 << (depth + 1))

    def emit(node: int, d: int):
        if d == depth:
            tree.value[node] = next(leaves)
            return
        left, right = next(ids), next(ids)
        tree.feature[node], tree.bin_threshold[node], tree.gain[node] = next(splits)
        tree.left[node], tree.right[node] = left, right
        emit(left, d + 1)
        emit(right, d + 1)

    emit(0, 0)
    return tree


def write_random_gbdt(path: str, rng, user_packed, item_packed,
                      n_trees: int = GBDT_TREES, depth: int = GBDT_DEPTH,
                      n_bins: int = GBDT_BINS) -> None:
    """The serve configuration's GBDT ranker, random, in JAX's file format:
    ``n_trees`` full trees of ``depth`` (no depth cut) over the 50 features
    and the two retrieval columns. Bin edges are the quantiles of
    ``GBDT_EDGE_ROWS`` rows assembled from the packed tables (random user
    and item rows), a standard-normal retrieval score and the log rank of a
    top-500 position; split features, thresholds and leaf values are drawn
    from ``rng``."""
    from recommendit_tpu_torch.features.schema import FEATURE_COLUMNS, assemble_packed
    from recommendit_tpu_torch.models import HistGBDTRanker

    names = FEATURE_COLUMNS + ["retrieval_score", "retrieval_rank"]
    users = rng.integers(0, len(user_packed), GBDT_EDGE_ROWS)
    items = rng.integers(0, len(item_packed), GBDT_EDGE_ROWS)
    rows = assemble_packed(torch.as_tensor(np.asarray(user_packed[users])),
                           torch.as_tensor(np.asarray(item_packed[items]))[:, None, :])
    X = np.concatenate([
        rows[:, 0].numpy(),
        rng.standard_normal((GBDT_EDGE_ROWS, 1), np.float32),
        np.log1p(rng.integers(0, TOP_K_CANDIDATES, (GBDT_EDGE_ROWS, 1))).astype(np.float32),
    ], axis=1)
    ranker = HistGBDTRanker(n_estimators=n_trees, learning_rate=GBDT_LR,
                            max_depth=depth, n_bins=n_bins, device="cpu")
    ranker._bin(X, fit=True)
    ranker.feature_names = names
    ranker.trees = [_random_tree(rng, len(names), n_bins, depth) for _ in range(n_trees)]
    ranker.best_iteration = n_trees
    ranker._trained = True
    ranker.save(path)


def make_artifacts(workdir: Path, seed: int, device, n_users: int = N_USERS,
                   n_items: int = N_ITEMS, dim: int = DIM,
                   hidden: int = HIDDEN, n_ratings: int = N_RATINGS,
                   block_size: int = INDEX_BLOCK, gbdt_trees: int = GBDT_TREES):
    """Random two-tower, fused bf16 and int8 indexes, rankers (the MLP and,
    drawn last, the GBDT of ``gbdt_trees`` trees), packed feature tables
    and ratings, in the JAX package's formats, and the catalog's augmented
    f32 rows (normalised embedding and bias column) as ``catalog.npy``.
    Returns (paths, ServeData)."""
    from recommendit_tpu_torch.features.schema import (
        GENRES,
        ITEM_PACKED_DIM,
        N_GENRES,
        USER_PACKED_DIM,
    )
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.serving.recommender import ServeData

    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    params = {
        "user_embed": 0.1 * rng.standard_normal((n_users + 1, dim), np.float32),
        "item_embed": 0.1 * rng.standard_normal((n_items + 1, dim), np.float32),
        "user_w1": _glorot(rng, (dim, hidden)),
        "user_b1": np.zeros(hidden, np.float32),
        "user_w2": _glorot(rng, (hidden, dim)),
        "user_b2": np.zeros(dim, np.float32),
        "item_w1": _glorot(rng, (dim + N_GENRES, hidden)),
        "item_b1": np.zeros(hidden, np.float32),
        "item_w2": _glorot(rng, (hidden, dim)),
        "item_b2": np.zeros(dim, np.float32),
        "item_bias": rng.standard_normal(n_items + 1, np.float32),
    }
    params["user_embed"][0] = 0.0
    params["item_embed"][0] = 0.0
    model = TwoTower.from_numpy(params, n_users, n_items, dim, hidden,
                                device=device)
    paths = {"model_path": str(workdir / "two_tower.npz"),
             "index_path": str(workdir / "mips.index.npz"),
             "index_i8_path": str(workdir / "mips_i8.index.npz"),
             "catalog_path": str(workdir / "catalog.npy"),
             "ranker_path": str(workdir / "ranker.npz"),
             "gbdt_path": str(workdir / "ranker_gbdt.npz"),
             "features_dir": str(workdir / "features")}
    model.save(paths["model_path"])

    # catalog: 1-3 genres per item
    item_ids = np.arange(1, n_items + 1)
    genres = np.zeros((n_items, N_GENRES), np.float32)
    n_gen = rng.integers(1, 4, n_items)
    for j in range(3):
        g = rng.integers(0, N_GENRES, n_items)
        genres[np.arange(n_items)[n_gen > j], g[n_gen > j]] = 1.0
    embs = model.get_item_embeddings(item_ids, genres)
    bias = 0.05 * model.item_bias_np(item_ids)
    for dtype in INDEX_PATHS:
        index = MIPSIndex(dim, block_size, "fused", dtype, quant_seed=seed,
                          device=device)
        index.build(embs, item_ids, bias=bias)
        index.save(paths[INDEX_PATHS[dtype]])
    unit = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
    np.save(paths["catalog_path"],
            np.concatenate([unit, bias[:, None]], axis=1).astype(np.float32))
    del model, index, embs, unit

    write_random_ranker(paths["ranker_path"], rng, device)

    feats = Path(paths["features_dir"])
    feats.mkdir(parents=True, exist_ok=True)
    user_packed = rng.standard_normal((n_users + 1, USER_PACKED_DIM), np.float32)
    item_packed = rng.standard_normal((n_items + 1, ITEM_PACKED_DIM), np.float32)
    np.save(feats / "user_packed.npy", user_packed)
    np.save(feats / "item_packed.npy", item_packed)

    # ratings: half uniform over the catalog, half on a popular head
    head = max(1, n_items // 50)
    users = rng.integers(1, n_users + 1, n_ratings)
    items = np.where(rng.random(n_ratings) < 0.5,
                     rng.integers(1, n_items + 1, n_ratings),
                     rng.integers(1, head + 1, n_ratings))
    # the catalog's titles and genre names, as the responses carry them
    titles = {int(i): f"Synthetic Item {i}" for i in item_ids}
    item_genres = {int(i): [] for i in item_ids}
    for row, g in zip(*np.nonzero(genres)):
        item_genres[int(item_ids[row])].append(GENRES[g])
    write_random_gbdt(paths["gbdt_path"], rng, user_packed, item_packed,
                      n_trees=gbdt_trees)
    return paths, ServeData(user_id=users, item_id=items, n_users=n_users,
                            n_items=n_items, titles=titles, genres=item_genres)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean per-row share of ``a``'s ids that are in ``b``'s row."""
    width = int(max(a.max(), b.max())) + 1
    rows = torch.arange(a.shape[0], device=a.device)[:, None] * width
    return float(torch.isin(a + rows, b + rows).float().mean())


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_events(prof):
    """(name, device µs, launches) of each device kernel a
    ``torch.profiler`` run recorded (``record_function`` ranges, which the
    profiler also lists on the device, left out)."""
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if (dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            yield evt.key, dev_us, evt.count


def profiled(body, keep=None, tries: int = PROFILE_TRIES, setup=None, whole=None):
    """``body()`` under ``torch.profiler`` (CPU and CUDA activity), taken
    again while the session is not whole, at most ``tries`` sessions: on
    an H100 a session now and then comes back with no kernel record at
    all, or with the records of only some calls, between sessions that
    record every kernel. ``whole(kept)`` judges the session from the
    ``(name, device µs, count)`` of the kernels whose short name ``keep``
    accepts (any kernel where ``keep`` is None); by default a session is
    whole where it recorded any of them. ``setup()``, where given, runs
    before each session, outside it, and ``body`` then takes its result.
    Returns the last session and ``body``'s result in it; the caller sees
    an empty session as no device events."""
    from torch.profiler import ProfilerActivity, profile

    whole = whole or bool
    for n in range(1, tries + 1):
        args = () if setup is None else (setup(),)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = body(*args)
            torch.cuda.synchronize()
        kept = [(key, us, count) for key, us, count in device_events(prof)
                if keep is None or keep(_short_kernel_name(key))]
        if whole(kept):
            break
        print(json.dumps({"profiler_session_empty" if not kept else "profiler_session_short": {
            "session": n, "of": tries,
            "records": {_short_kernel_name(k): c for k, _, c in kept}}}), flush=True)
    return prof, res


def device_kernel_ms(fn, reps: int, keep=None):
    """Device time per call of ``fn()`` in ms, by kernel name (its template
    arguments dropped; only names ``keep`` accepts, where given): the
    kernels' own time under ``torch.profiler`` (:func:`profiled`) over
    ``reps`` calls after a warm one, launch gaps and host time left out.
    A session is whole where it holds a record of every call's launches —
    each kernel's count a positive multiple of ``reps`` — and is retaken
    where not: one that kept the records of some calls only, read as if it
    had all ``reps``, once put kernel 6 at (1,024, 64) below its bound (its
    tile and finish kernels both at 15 % of their time). Empty where no
    session was whole."""
    fn()

    def body():
        for _ in range(reps):
            fn()

    def every_call(kept):
        return bool(kept) and all(count % reps == 0 for _, _, count in kept)

    prof, _ = profiled(body, keep, whole=every_call)
    kept = [(key, us, count) for key, us, count in device_events(prof)
            if keep is None or keep(_short_kernel_name(key))]
    if not every_call(kept):
        return {}
    out = {}
    for key, dev_us, _ in kept:
        name = _short_kernel_name(key)
        out[name] = out.get(name, 0.0) + dev_us / 1e3 / reps
    return out


def gemm_only_i8(q8: torch.Tensor, corpus: torch.Tensor, chunk: int = 256):
    """The int8 product alone, a yardstick the port never calls: (chunk, D)
    x (D, N) int8 into int32 sums, one ``torch._int_mm`` per chunk; no
    scale, no window max."""
    for s in range(0, q8.shape[0], chunk):
        torch._int_mm(q8[s:s + chunk], corpus.T)


def gemm_only(q: torch.Tensor, corpus: torch.Tensor, chunk: int = 256):
    """The product alone, a yardstick the port never calls: (chunk, D) x
    (D, N) in the corpus dtype into f32 scores (one cuBLAS call per chunk on
    the card; f32 on the CPU, which has no such call), no window max."""
    qc = q.to(corpus.dtype)
    for s in range(0, qc.shape[0], chunk):
        if corpus.is_cuda:
            torch.mm(qc[s:s + chunk], corpus.T, torch.float32)
        else:
            qc[s:s + chunk].float() @ corpus.T.float()


def kernel_phase(paths, device, seed: int, qs=KERNEL_QS, k=TOP_K_CANDIDATES,
                 window=WINDOW, timer=cuda_ms, min_recall=0.98):
    """The kernel against its twin on the index's own corpus and user-tower
    queries; recall@k against the exact top-k of the same scores must reach
    ``min_recall`` (the bin model gives 0.984 at the serve shape). Returns
    one record per batch size."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.topk import fast_topk, score_matrix

    model = TwoTower.load(paths["model_path"], device=device)
    index = MIPSIndex.load(paths["index_path"], device=device)
    corpus, n_valid = index._embs, index.n_total
    rng = np.random.default_rng(seed + 1)
    out = []
    for n_q in qs:
        uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q),
                               device=device)
        q = index._augment(model.user_tower(uids))
        kv, ka = mw.window_candidates(q, corpus, window, n_valid)
        rv, ra = mw.window_candidates_ref(q, corpus, window, n_valid)
        err = float((kv - rv).abs().max())
        v, i = mw.mips_topk_window_im(q, corpus, k, INDEX_BLOCK, window,
                                      n_valid=n_valid)
        tv, ti = mw.mips_topk_window_im_ref(q, corpus, k, INDEX_BLOCK, window,
                                            n_valid=n_valid)
        _, ei = fast_topk(score_matrix(q, corpus[:n_valid], "default"), k)
        _, fi = fast_topk(score_matrix(q, corpus[:n_valid], "highest"), k)
        rec = {
            "q": n_q, "n": n_valid, "d": int(corpus.shape[1]),
            "d_func": index._width, "window": window, "k": k,
            "dtype": str(corpus.dtype), "window_max_abs_err": err,
            "topk_value_abs_err": float((v - tv).abs().max()),
            "id_overlap_vs_twin": _overlap(i, ti),
            "recall_vs_exact": _overlap(i, ei),
            "recall_vs_exact_f32_queries": _overlap(i, fi),
            "bin_model_recall": 1 - (k - 1) * window / (2 * n_valid),
            "args_equal_share": float((ka == ra).float().mean()),
            "tc_route": mw.window_body(corpus.dtype, "default",
                                       int(corpus.shape[1])) == "tensor_cores",
        }
        del kv, ka, rv, ra, ei, fi
        reps = 20 if n_q <= 256 else 10
        rec["kernel_ms"] = timer(
            lambda: mw.window_candidates(q, corpus, window, n_valid), reps)
        rec["bound_share"] = window_bound(rec, 2, 4, "bf16")[0] / rec["kernel_ms"]
        rec["gemm_only_ms"] = timer(lambda: gemm_only(q, corpus), reps)
        rec["twin_ms"] = timer(
            lambda: mw.window_candidates_ref(q, corpus, window, n_valid), 3)
        rec["kernel_topk_ms"] = timer(
            lambda: mw.mips_topk_window_im(q, corpus, k, INDEX_BLOCK, window,
                                           n_valid=n_valid), reps)
        rec["twin_topk_ms"] = timer(
            lambda: mw.mips_topk_window_im_ref(q, corpus, k, INDEX_BLOCK,
                                               window, n_valid=n_valid), 3)
        print(json.dumps({"kernel_check": rec}), flush=True)
        if corpus.dtype == torch.bfloat16 and not rec["tc_route"]:
            raise AssertionError(f"the bf16 corpus missed the tensor cores: {rec}")
        if err > 1e-3:
            raise AssertionError(f"window maxima differ by {err} (> 1e-3)")
        if rec["topk_value_abs_err"] > 1e-3:
            raise AssertionError(f"top-{k} values differ: {rec}")
        if rec["id_overlap_vs_twin"] < 0.99:
            raise AssertionError(f"top-{k} id overlap with the twin < 0.99: {rec}")
        if rec["recall_vs_exact"] < min_recall:
            raise AssertionError(f"recall@{k} < {min_recall}: {rec}")
        out.append(rec)
    return out


def load_pipeline(paths, data, device, dtype: str = "bfloat16",
                  k: int = REQUEST_K, ranker: str = "ranker_path",
                  mode: str = "fused", index_path=None):
    """The port's pipeline over the ``mode`` index of ``dtype`` (the fused
    one of ``paths`` unless ``index_path`` names another) with the ranker
    at ``paths[ranker]``, loaded."""
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    cfg = Settings(EMBEDDING_DIM=DIM, HIDDEN_DIM=HIDDEN, INDEX_MODE=mode,
                   INDEX_DTYPE=dtype, TOP_K_CANDIDATES=TOP_K_CANDIDATES,
                   TOP_K_RESULTS=k, FILTER_SEEN=True,
                   RANKER_BLEND_RETRIEVAL=1.0, RANKER_QUERY_NORM=True,
                   STAGE_RECAL_EVERY=0)
    pipe = RecommendationPipeline(cfg=cfg, device=device, model_path=paths["model_path"],
                                  ranker_path=paths[ranker],
                                  features_dir=paths["features_dir"],
                                  index_path=index_path or paths[INDEX_PATHS[dtype]])
    pipe.load(data)
    return pipe


def serve_phase(paths, data, device, n_batch_users: int = N_BATCH_USERS,
                batch: int = BATCH, n_requests: int = N_REQUESTS,
                k: int = REQUEST_K, dtype: str = "bfloat16"):
    """Load the port's pipeline over the fused index of ``dtype`` and drive
    its main path: batch_recommend at ``batch`` and ``n_requests`` single
    requests. Checks what comes out and the launch counts of exactly that
    run — on the card one launch of the dtype's window kernel per batch,
    none for the single requests (the scan route) and none of the other
    kernel — and returns the measurements and the counts, and the loaded
    pipeline."""
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.topk import quantize_queries

    t0 = time.perf_counter()
    pipe = load_pipeline(paths, data, device, dtype, k)
    load_s = time.perf_counter() - t0
    n_users, n_items = pipe._n_users, pipe.index.n_total
    rng = np.random.default_rng(7)
    users = rng.choice(np.arange(1, n_users + 1), size=n_batch_users,
                       replace=n_batch_users > n_users).tolist()

    # a warm batch (outside the counted run), then the checks on its output
    ids, scores, rvals = pipe.serve_batch(users[:batch])
    if ids.shape != (batch, min(100, TOP_K_CANDIDATES)):
        raise AssertionError(f"serve_batch shape {tuple(ids.shape)}")
    fin = torch.isfinite(scores)
    if not bool(fin[:, 0].all()):
        raise AssertionError("a user has no unseen candidate")
    if not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        raise AssertionError("serve_batch scores are not sorted")
    if int(ids.min()) < 1 or int(ids.max()) > n_items:
        raise AssertionError("item id out of range")
    # each returned retrieval score is the tower query times the item's
    # row, the query rounded to the corpus dtype except on the small-corpus
    # exact route; over int8, (q_i8 · e_i8) · s_item · s_q
    pos = torch.searchsorted(pipe.index._ids_dev, ids)
    q = pipe.index._augment(pipe.model.user_tower(
        torch.as_tensor(users[:batch], device=device)))
    rows = pipe.index._embs[pos]
    if dtype == "int8":
        q8, q_scale = quantize_queries(q)
        dot = (rows.float() * q8.float()[:, None, :]).sum(-1)
        want = dot * pipe.index._scales[pos] * q_scale[:, None]
    else:
        if mw.fused_route(batch, n_items, TOP_K_CANDIDATES)[0] != "exact":
            q = q.to(rows.dtype)
        want = (rows.float() * q.float()[:, None, :]).sum(-1)
    rerr = float((want - rvals).abs().max())
    if rerr > 1e-3:
        raise AssertionError(f"retrieval scores disagree with the corpus: {rerr}")

    for name in mw.LAUNCHES:
        mw.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    recs = pipe.batch_recommend(users, k=k, batch_size=batch)
    batch_s = time.perf_counter() - t0
    batch_launches = dict(mw.LAUNCHES)
    lat = []
    singles = {}
    for u in users[:n_requests]:
        t0 = time.perf_counter()
        singles[u] = pipe.get_recommendations(u, k=k, use_cache=False)
        lat.append((time.perf_counter() - t0) * 1e3)
    cold = pipe.get_recommendations(n_users + 1000, k=k, use_cache=False)
    launches = dict(mw.LAUNCHES)

    n_batches = -(-len(users) // batch)
    expect = {name: 0 for name in mw.LAUNCHES}
    if torch.device(device).type == "cuda":
        expect[SERVE_KERNELS[dtype]] = n_batches
    if batch_launches != expect or launches != expect:
        raise AssertionError(
            f"expected launches {expect} ({n_batches} batches, none for the "
            f"single requests), got {batch_launches} after the batches and "
            f"{launches} after the requests")

    for u, got in singles.items():
        ids_u = [r.item_id for r in got]
        if len(ids_u) != k or len(set(ids_u)) != k:
            raise AssertionError(f"user {u}: {len(ids_u)} items, expected {k}")
        if min(ids_u) < 1 or max(ids_u) > n_items:
            raise AssertionError(f"user {u}: item id out of range")
        if pipe._seen.contains(np.full(k, u), np.asarray(ids_u)).any():
            raise AssertionError(f"user {u}: a seen item was recommended")
    if [r.item_id for r in cold] != pipe._popularity_fallback[:k]:
        raise AssertionError("unknown user did not get the popularity fallback")
    if len(recs) != len(set(users)) or any(len(v) != k for v in recs.values()):
        raise AssertionError("batch_recommend returned short lists")
    agree = float(np.mean([
        len(set(recs[u]) & {r.item_id for r in singles[u]}) / k
        for u in singles]))
    search = search_device_check(pipe, users[:batch], device)
    print(json.dumps({f"search_device_{dtype}": search}), flush=True)
    return {
        "index_dtype": dtype, "load_s": load_s,
        "batch_users": len(users), "batch_size": batch,
        "batch_s": batch_s, "users_per_s": len(users) / batch_s,
        "requests": len(lat), "request_p50_ms": float(np.median(lat)),
        "request_max_ms": float(np.max(lat)),
        "batch_vs_single_top_k_agreement": agree,
        "retrieval_score_abs_err": rerr,
        "stage_split": pipe.get_stats()["stage_split"],
        "launches": launches, "search_device": search,
    }, pipe


def search_device_check(pipe, users, device, k: int = TOP_K_CANDIDATES,
                        calls: int = 2):
    """``MIPSIndex.search_device`` (scores and item ids left on the device)
    against ``batch_search`` on the same queries, the batch's user-tower
    rows: ``calls`` calls, each with the launches of the index's window
    kernel counted by :class:`_WindowLaunches` (one a call on the card over
    the fused index; no other window kernel); ids equal after
    ``canonical_tie_order`` and scores within the phase's 1e-3 (the same
    kernel on the same query bits: expected equal)."""
    from recommendit_tpu_torch.models.retrieval import _l2_normalize_np
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.topk import canonical_tie_order

    index = pipe.index
    kernel = SERVE_KERNELS[index.dtype]
    raw = pipe.model.user_tower(torch.as_tensor(users, device=device)).cpu().numpy()
    # the query bits batch_search searches with
    q = torch.as_tensor(_l2_normalize_np(raw), device=device)
    _reset(mw.LAUNCHES)
    with _WindowLaunches(kernel, ("search_device",)) as window:
        outs = [index.search_device(q, k) for _ in range(calls)]
    launches = dict(mw.LAUNCHES)
    by = window.check(f"search_device over {index.dtype}", launches[kernel],
                      torch.device(device).type == "cuda")
    if any(n for name, n in launches.items() if name != kernel):
        raise AssertionError(f"search_device launched another window kernel: {launches}")
    vals, ids = outs[0]
    if vals.device != q.device or ids.device != q.device:
        raise AssertionError(f"search_device left the device: {vals.device}, {ids.device}")
    bv, bid = index.batch_search(raw, k)
    got_v, got_i = canonical_tie_order(vals.float().cpu(), ids.cpu())
    want_v, want_i = canonical_tie_order(torch.as_tensor(bv).float(), torch.as_tensor(bid))
    err = float((got_v - want_v).abs().max())
    rec = {"queries": len(users), "k": k, "index_dtype": index.dtype,
           "calls": calls, "launches": by.get("search_device", 0),
           "ids_equal": bool(torch.equal(got_i, want_i)), "max_abs_err": err,
           "repeat_bit_identical": all(torch.equal(a, b) for o in outs[1:]
                                       for a, b in zip(o, outs[0]))}
    if not rec["ids_equal"] or err > 1e-3 or not rec["repeat_bit_identical"]:
        raise AssertionError(f"search_device differs from batch_search: {rec}")
    return rec


def _predict_rows(job):
    """One worker's share of the host reference: the saved GBDT's host
    ``predict`` of ``rows``."""
    from recommendit_tpu_torch.models import HistGBDTRanker

    path, rows = job
    return HistGBDTRanker.load(path, device="cpu").predict(rows)


def host_predict(path: str, rows: np.ndarray, workers: int = GBDT_HOST_WORKERS):
    """The GBDT at ``path``'s host ``predict`` of ``rows`` (n, F), split
    over ``workers`` spawned processes (threads would share one interpreter
    lock); the rows are independent, so the result is that of one call."""
    if workers <= 1 or len(rows) < 2 * workers:
        return _predict_rows((path, rows))
    from concurrent.futures import ProcessPoolExecutor

    # a worker that dies raises here (BrokenProcessPool) instead of hanging
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = list(pool.map(_predict_rows,
                              [(path, r) for r in np.array_split(rows, workers)]))
    return np.concatenate(parts)


def serve_inputs(pipe, users):
    """The first half of ``serve_batch`` for ``users``: the candidates,
    their retrieval scores, the seen mask and the (B, C, F) ranker
    features, as the pipeline builds them."""
    from recommendit_tpu_torch.features.schema import assemble_packed
    from recommendit_tpu_torch.ops.seen import seen_mask
    from recommendit_tpu_torch.serving.recommender import _with_extras

    uids = torch.as_tensor(users, device=pipe.device).long()
    rvals, pos = pipe._retrieve(pipe.model.user_tower(uids))
    cand = pipe._item_ids_dev[pos]
    feats = assemble_packed(pipe._user_packed[uids], pipe._item_packed[cand])
    indptr, cols = pipe._seen_dev
    seen = seen_mask(indptr, cols, pipe._seen_steps, uids[:, None], cand)
    return _with_extras(feats, rvals, ~seen, pipe._extra_feats), rvals, seen, cand


def gbdt_serve_phase(paths, data, device, n_batch_users: int = GBDT_SERVE_USERS,
                     batch: int = BATCH, n_requests: int = N_REQUESTS,
                     k: int = REQUEST_K, workers: int = GBDT_HOST_WORKERS,
                     profile_calls: int = 5):
    """The bf16 serve path with the random GBDT (``paths["gbdt_path"]``) as
    its ranker: ``batch_recommend`` for ``n_batch_users`` users at
    ``batch`` and ``n_requests`` single requests, the launch counts read
    around exactly that run (one kernel-1 launch per batch on the card,
    none for the single requests). Then each batch's ranked lists against a
    reference built from the same candidates: the GBDT's host ``predict``
    of the same features, the same blend and the same seen mask — scores
    within 1e-4 and ids equal up to ties within 1e-4 (``check_list``) —
    and the device scorer's raw scores against the host's (rtol 1e-4, atol
    1e-5). On the card: ``torch.profiler`` over ``profile_calls`` batches,
    the tree descent alone by CUDA events (its share of the batch) and the
    batch's peak memory above what the pipeline holds."""
    from recommendit_tpu_torch.models import HistGBDTRanker
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.serving.recommender import _blend

    t0 = time.perf_counter()
    pipe = load_pipeline(paths, data, device, "bfloat16", k, ranker="gbdt_path")
    load_s = time.perf_counter() - t0
    ranker = pipe.ranker
    if not isinstance(ranker, HistGBDTRanker):
        raise AssertionError(f"the GBDT file loaded as {type(ranker).__name__}")
    n_users = pipe._n_users
    rng = np.random.default_rng(13)
    users = rng.choice(np.arange(1, n_users + 1), size=n_batch_users,
                       replace=n_batch_users > n_users).tolist()
    pipe.serve_batch(users[:batch])      # warm, outside the counted run

    for name in mw.LAUNCHES:
        mw.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    recs = pipe.batch_recommend(users, k=k, batch_size=batch)
    batch_s = time.perf_counter() - t0
    batch_launches = dict(mw.LAUNCHES)
    lat = []
    for u in users[:n_requests]:
        t0 = time.perf_counter()
        got = pipe.get_recommendations(u, k=k, use_cache=False)
        lat.append((time.perf_counter() - t0) * 1e3)
        if len(got) != k or len({r.item_id for r in got}) != k:
            raise AssertionError(f"user {u}: {len(got)} items, expected {k}")
    launches = dict(mw.LAUNCHES)
    n_batches = -(-len(users) // batch)
    expect = {name: 0 for name in mw.LAUNCHES}
    if torch.device(device).type == "cuda":
        expect["window_mips"] = n_batches
    if batch_launches != expect or launches != expect:
        raise AssertionError(
            f"expected launches {expect} ({n_batches} batches, none for the "
            f"single requests), got {batch_launches} after the batches and "
            f"{launches} after the requests")
    if len(recs) != len(set(users)) or any(len(v) != k for v in recs.values()):
        raise AssertionError("batch_recommend returned short lists")

    t0 = time.perf_counter()
    raw_err = 0.0
    rows_checked = 0
    for b0 in range(0, len(users), batch):
        ub = users[b0:b0 + batch]
        ids, scores, _ = pipe.serve_batch(ub)
        feats, rvals, seen, cand = serve_inputs(pipe, ub)
        dev_raw = pipe._score_fn(feats).cpu().numpy().astype(np.float64)
        host = host_predict(paths["gbdt_path"], feats.reshape(-1, feats.shape[-1])
                            .cpu().numpy(), workers).reshape(dev_raw.shape)
        if not np.allclose(dev_raw, host, rtol=GBDT_RTOL, atol=GBDT_ATOL):
            raise AssertionError(f"device GBDT scores off the host's by "
                                 f"{np.abs(dev_raw - host).max()}")
        raw_err = max(raw_err, float(np.abs(dev_raw - host).max()))
        ref = _blend(torch.as_tensor(host, dtype=torch.float32, device=rvals.device),
                     rvals, ~seen, pipe._beta).masked_fill(seen, float("-inf"))
        ref_scores, sel = torch.topk(ref, ids.shape[1])
        ref_ids = torch.gather(cand, 1, sel).cpu().numpy()
        ids, scores, ref_scores = (t.cpu().numpy() for t in (ids, scores, ref_scores))
        for r in range(len(ub)):
            check_list(ids[r].tolist(), scores[r], ref_ids[r].tolist(), ref_scores[r],
                       tol=HTTP_TOL)
        rows_checked += len(ub)
    rec = {"load_s": load_s, "trees": len(ranker.trees), "depth": ranker.max_depth,
           "bins": ranker.n_bins, "features": ranker.n_features,
           "batch_users": len(users), "batch_size": batch, "batch_s": batch_s,
           "users_per_s": len(users) / batch_s, "requests": len(lat),
           "request_p50_ms": float(np.median(lat)), "request_max_ms": float(np.max(lat)),
           "launches": launches, "users_checked": rows_checked,
           "raw_score_max_abs_err": raw_err, "reference_s": time.perf_counter() - t0}
    if torch.device(device).type == "cuda":
        prof = profile_phase(paths, data, device, n_calls=profile_calls, batch=batch,
                             pipe=pipe, label="serve_profile_gbdt")
        feats, _, _, _ = serve_inputs(pipe, users[:batch])
        descent_ms = cuda_ms(lambda: pipe._score_fn(feats), reps=profile_calls)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pipe.serve_batch(users[:batch])
        torch.cuda.synchronize()
        rec.update(device_ms_per_batch=prof["device_ms_per_call"],
                   descent_ms=descent_ms,
                   descent_share=descent_ms / prof["device_ms_per_call"],
                   peak_mb_above_pipeline=(torch.cuda.max_memory_allocated() - base) / 2**20)
    return rec, pipe


class _ErrorRecords(logging.Handler):
    """Keeps every record of ERROR or above: a failed serve call that the
    pipeline or the app answers with the popularity list logs one."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _http_post(url: str, body, timeout: float = 60.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace")


def _http_get(url: str, timeout: float = 60.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace")


def http_level(url: str, clients: int, users, k: int):
    """``len(users)`` POST /recommend, one per user, from ``clients``
    closed-loop client threads (``use_cache`` false) → the wall time, each
    request's host latency and each user's status and payload."""
    lock = threading.Lock()
    cursor = [0]
    lat, out = [], {}

    def worker():
        while True:
            with lock:
                i = cursor[0]
                cursor[0] += 1
            if i >= len(users):
                return
            u = users[i]
            t0 = time.perf_counter()
            got = _http_post(f"{url}/recommend",
                             {"user_id": u, "k": k, "use_cache": False})
            dt = (time.perf_counter() - t0) * 1e3
            with lock:
                lat.append(dt)
                out[u] = got

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, lat, out


def check_list(got_ids, got_scores, want_ids, want_scores, tol: float = HTTP_TOL):
    """Scores within ``tol`` position by position, and the ids equal once
    each run of scores tied within ``tol`` is put in id order
    (``canonical_tie_order`` with ties up to ``tol``). Raises on a
    difference."""
    if len(got_ids) != len(want_ids):
        raise AssertionError(f"{len(got_ids)} items, expected {len(want_ids)}")
    g = np.asarray(got_scores, np.float64)
    w = np.asarray(want_scores, np.float64)
    fin = np.isfinite(w)
    if not (np.array_equal(np.isfinite(g), fin)
            and np.all(np.abs(g[fin] - w[fin]) <= tol)):
        raise AssertionError(f"scores differ: {g.tolist()} vs {w.tolist()}")
    start = 0
    for end in range(1, len(w) + 1):
        if end == len(w) or not (
                not (fin[end] or fin[end - 1])
                or (fin[end] and fin[end - 1] and w[end - 1] - w[end] <= tol)):
            if sorted(got_ids[start:end]) != sorted(want_ids[start:end]):
                raise AssertionError(
                    f"ids differ: {list(got_ids)} vs {list(want_ids)}")
            start = end


def check_http_batches(pipe, batches, bodies, k: int) -> int:
    """Every list returned over HTTP against the direct ``serve_batch`` of
    the bucket its request was served in (the same users in the same rows,
    padded with user 1): ``check_list`` on the first ``k`` finite rows, the
    popularity backfill as the pipeline adds it. Returns the lists
    checked."""
    n_checked = 0
    for users, bucket, _ in batches:
        ids, scores, _ = pipe._serve_rows(list(users) + [1] * (bucket - len(users)))
        for row, u in enumerate(users):
            status, body = bodies[u]
            if status != 200:
                raise AssertionError(f"user {u}: HTTP {status}: {body}")
            fin = np.isfinite(scores[row])
            want = ids[row][fin][:k].tolist()
            want_s = scores[row][fin][:k].tolist()
            fill = pipe._unseen_popularity(u, k, exclude=set(want))
            want_s += [float("-inf")] * min(k - len(want), len(fill))
            want += fill[: k - len(want)]
            recs = body["recommendations"]
            check_list([r["item_id"] for r in recs], [r["score"] for r in recs],
                       want, want_s)
            n_checked += 1
    return n_checked


def _log_batches(pipe, log):
    """Wrap the pipeline's micro-batcher so that each dispatch appends (the
    users, their bucket, host ms) to ``log``; only this script reads it."""
    from recommendit_tpu_torch.serving.recommender import micro_batch_buckets

    batcher = pipe._batcher
    inner = batcher.batch_fn
    buckets = micro_batch_buckets(batcher.max_batch)

    def logged(user_ids):
        t0 = time.perf_counter()
        out = inner(user_ids)
        bucket = next((b for b in buckets if b >= len(user_ids)), buckets[-1])
        log.append((list(user_ids), bucket, (time.perf_counter() - t0) * 1e3))
        return out

    batcher.batch_fn = logged


def _new_thread_ms(pipe, bucket: int):
    """Host ms of the first and the second ``serve_batch`` of ``bucket``
    users (brought to the host) on a thread that has never served: what a
    dispatch thread not warmed itself would pay on its first batch."""
    out = []

    def run():
        for _ in range(2):
            t0 = time.perf_counter()
            pipe._serve_rows([1] * bucket)
            out.append((time.perf_counter() - t0) * 1e3)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    return out


def _percentiles(lat):
    a = np.asarray(lat)
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def http_serve(pipe, device, label: str, levels, users_pool, k: int, max_batch: int,
               wait_ms: float, extra_checks: bool, clients):
    """One pipeline behind the port's app and threaded server: micro-batching
    on (``max_batch``, ``wait_ms``), ``/health``, then each level of
    closed-loop clients (``http_level`` in the process pool ``clients``)
    with the launch counts set to 0 just before it and read just after,
    every list against its direct bucket; with
    ``extra_checks`` also ``/recommend/batch``, ``/model/info``,
    ``/items/{id}`` and a user-feature update. The last level must send at
    least one live dispatch to the largest bucket (on the card, with
    ``max_batch`` 1,024, each one launches the index's window kernel)."""
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.serving.app import HTTPServer, RecommendItApp, make_handler
    from recommendit_tpu_torch.serving.recommender import micro_batch_buckets

    big = micro_batch_buckets(max_batch)[-1]

    kernel = SERVE_KERNELS[pipe.index.dtype]
    on_card = torch.device(device).type == "cuda"
    errors = _ErrorRecords()
    log_root = logging.getLogger("recommendit_tpu_torch")
    log_root.addHandler(errors)
    pipe.enable_micro_batching(max_batch, wait_ms)
    warm = dict(pipe.get_stats()["micro_batcher"])
    batches = []
    _log_batches(pipe, batches)
    server = HTTPServer(("127.0.0.1", 0), make_handler(RecommendItApp(pipeline=pipe)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    rec = {"index_dtype": pipe.index.dtype, "wait_ms": wait_ms,
           "max_batch": max_batch, "warm_s": warm["warm_s"],
           "warm_on_dispatch_thread": warm["warm_thread"] != threading.current_thread().name,
           "levels": []}
    try:
        status, health = _http_get(f"{url}/health")
        if status != 200 or health.get("pipeline_loaded") is not True:
            raise AssertionError(f"/health: {status} {health}")
        cursor = 0
        for n_clients, n_req in levels:
            users = users_pool[cursor: cursor + n_req]
            cursor += n_req
            before = dict(pipe.get_stats()["micro_batcher"])
            batches.clear()
            for name in mw.LAUNCHES:
                mw.LAUNCHES[name] = 0
            wall, lat, bodies = clients.apply(http_level, (url, n_clients, users, k))
            launches = dict(mw.LAUNCHES)
            after = pipe.get_stats()["micro_batcher"]
            sizes = [len(b[0]) for b in batches]
            big_dispatches = sum(1 for _, b, _ in batches if b == big)
            served = after["requests_served"] - before["requests_served"]
            n_batches = after["batches_dispatched"] - before["batches_dispatched"]
            checked = check_http_batches(pipe, batches, bodies, k)
            p50, p99 = _percentiles(lat)
            level = {
                "clients": n_clients, "requests": len(users), "qps": len(users) / wall,
                "p50_ms": p50, "p99_ms": p99, "max_ms": float(np.max(lat)),
                "batches": n_batches, "avg_batch_size": served / max(1, n_batches),
                "max_batch_size": max(sizes), "bucket_dispatches": {
                    str(b): sum(1 for _, bb, _ in batches if bb == b)
                    for b in sorted({bb for _, bb, _ in batches})},
                "batch_ms_median_by_bucket": {
                    str(b): float(np.median([ms for _, bb, ms in batches if bb == b]))
                    for b in sorted({bb for _, bb, _ in batches})},
                "lists_checked": checked, "launches": launches,
            }
            if checked != len(users) or served != len(users):
                raise AssertionError(f"{label}: {checked} lists checked, {served} "
                                     f"served, {len(users)} sent")
            expect = {name: 0 for name in mw.LAUNCHES}
            if on_card:
                expect[kernel] = big_dispatches if big == 1024 else 0
            if launches != expect:
                raise AssertionError(f"{label}, {n_clients} clients: launches {launches}, "
                                     f"expected {expect} ({big_dispatches} dispatches "
                                     f"to the {big} bucket)")
            rec["levels"].append(level)
            print(json.dumps({f"http_{label}_level": level}), flush=True)
        if not big_dispatches:
            raise AssertionError(f"{label}: no live dispatch to the {big} bucket at "
                                 f"{levels[-1][0]} clients: "
                                 f"{rec['levels'][-1]['bucket_dispatches']}")
        rec["big_bucket_dispatches"] = big_dispatches
        rec["first_big_batch_ms"] = next(ms for _, b, ms in batches if b == big)
        rec["first_live_batch_ms"] = after["first_live_batch_ms"]
        rec["first_live_batch_size"] = after["first_live_batch_size"]
        rec["new_thread_ms"] = _new_thread_ms(pipe, big)

        if extra_checks:
            rec.update(http_extra_checks(pipe, url, users_pool[cursor:], k))
        if errors.records:
            raise AssertionError(
                f"{label}: {len(errors.records)} serve failures answered from "
                f"popularity, first: {errors.records[0].getMessage()}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        pipe._batcher.close()
        log_root.removeHandler(errors)
    return rec


def http_extra_checks(pipe, url: str, users, k: int):
    """/recommend/batch (the scan route) against ``batch_recommend``,
    /model/info, /items/{id}, and a user-feature update that must change
    that user's next list (the packed row written on the device)."""
    batch_users = [int(u) for u in users[:HTTP_BATCH_USERS]]
    status, body = _http_post(f"{url}/recommend/batch",
                              {"user_ids": batch_users, "k": k})
    want = pipe.batch_recommend(batch_users, k=k)
    if status != 200 or body["recommendations"] != {str(u): want[u] for u in batch_users}:
        raise AssertionError(f"/recommend/batch disagrees with batch_recommend ({status})")
    status, info = _http_get(f"{url}/model/info")
    if (status != 200 or info["index_stats"] != pipe.index.stats()
            or info["n_items"] != pipe.model.n_items
            or "micro_batcher" not in info["pipeline_stats"]):
        raise AssertionError(f"/model/info: {status} {info}")
    item = int(pipe.index.item_ids[len(pipe.index.item_ids) // 2])
    status, body = _http_get(f"{url}/items/{item}")
    if status != 200 or body["title"] != pipe._item_titles[item] or not body["genres"]:
        raise AssertionError(f"/items/{item}: {status} {body}")
    user = int(users[HTTP_BATCH_USERS])
    req = {"user_id": user, "k": k, "use_cache": False}
    _, before = _http_post(f"{url}/recommend", req)
    status, _ = _http_post(f"{url}/users/{user}/features", {
        "avg_rating": 5.0, "log_rating_count": 8.0, "recency_score": 1.0,
        "gender_encoded": 1.0, "age_normalized": 1.0,
        "occupation_normalized": 1.0, "genre_pref": [1.0] * 9 + [0.0] * 9})
    _, after = _http_post(f"{url}/recommend", req)
    if status != 200 or ([r["score"] for r in after["recommendations"]]
                         == [r["score"] for r in before["recommendations"]]):
        raise AssertionError("a user-feature update did not change the next list")
    ids, scores, _ = pipe._serve_rows([user] + [1] * 7)
    fin = np.isfinite(scores[0])
    check_list([r["item_id"] for r in after["recommendations"]],
               [r["score"] for r in after["recommendations"]],
               ids[0][fin][:k].tolist(), scores[0][fin][:k].tolist())
    return {"batch_route_users": len(batch_users), "model_info": "ok",
            "item_checked": item, "feature_update_user": user}


def http_phase(pipe, pipe_i8, device, levels=HTTP_LEVELS, k: int = REQUEST_K,
               max_batch: int = HTTP_MAX_BATCH, wait_ms: float = HTTP_WAIT_MS,
               seed: int = 0):
    """The request path: the bf16 pipeline behind the port's HTTP app at each
    level of ``levels`` (clients in flight, requests), every request a
    distinct user, then the last level once over the int8 pipeline
    (``http_serve``). The clients run in a process of their own, as they
    would against a real server: in this one their threads would compete
    with the server's for the interpreter lock. Returns the two records."""
    rng = np.random.default_rng(seed + 11)
    n_users = pipe._n_users
    need = sum(n for _, n in levels) + HTTP_BATCH_USERS + 1
    if need > n_users:
        raise ValueError(f"the levels need {need} distinct users, there are {n_users}")
    with multiprocessing.get_context("spawn").Pool(1) as clients:
        pool = (rng.permutation(n_users) + 1).tolist()
        out = {"bf16": http_serve(pipe, device, "bf16", levels, pool, k, max_batch,
                                  wait_ms, extra_checks=True, clients=clients)}
        pool = (rng.permutation(n_users) + 1).tolist()
        out["int8"] = http_serve(pipe_i8, device, "int8", levels[-1:], pool, k,
                                 max_batch, wait_ms, extra_checks=False,
                                 clients=clients)
    out["feature_store"] = feature_store_record((pipe, pipe_i8))
    print(json.dumps({"feature_store": out["feature_store"]}), flush=True)
    return out


def feature_store_record(pipes) -> dict:
    """The backend the served pipelines' feature stores chose (Redis where
    the ``redis`` package is there and the server answers, else memory) and
    the wire format they write (msgpack where the package is there, else
    JSON), as ``features/store.py`` decided them in this process."""
    from recommendit_tpu_torch.features import store

    backends = {p.feature_store.stats()["backend"] for p in pipes}
    if len(backends) != 1:
        raise AssertionError(f"the served pipelines' stores differ: {backends}")
    return {"backend": backends.pop(),
            "codec": "msgpack" if store.MSGPACK_AVAILABLE else "json",
            "redis_package": store.REDIS_AVAILABLE,
            "msgpack_package": store.MSGPACK_AVAILABLE}


def quantize_phase(paths, device, seed: int, timer=cuda_ms):
    """Kernel 7 on the catalog's augmented f32 rows: one launch through its
    wrapper (the counted run), then its int8 values and scales against the
    twin's, which must be equal, and the times of the kernel, the twin and
    the build quantizer (threefry, ``quantize_int8``), whose scales must
    equal the kernel's and whose rows must be the saved int8 index's."""
    from recommendit_tpu_torch.ops import quantize as qz

    x = torch.as_tensor(np.load(paths["catalog_path"]), device=device)
    for name in qz.LAUNCHES:
        qz.LAUNCHES[name] = 0
    vals, scales = qz.quantize_int8_hash(x, seed)
    launches = dict(qz.LAUNCHES)
    rv, rs = qz.quantize_int8_hash_ref(x, seed)
    bv, bs = qz.quantize_int8(x, seed)
    with np.load(paths["index_i8_path"]) as saved:
        built_equal = bool(np.array_equal(
            saved["embeddings_i8"][: x.shape[0]], bv.cpu().numpy()))
    rec = {
        "n": x.shape[0], "d": x.shape[1], "seed": seed,
        "values_equal": bool(torch.equal(vals, rv)),
        "scales_equal": bool(torch.equal(scales, rs)),
        "max_abs_err": float(max((vals.int() - rv.int()).abs().max(),
                                 (scales - rs).abs().max())),
        "build_scales_equal": bool(torch.equal(bs, scales)),
        "build_equals_saved_index": built_equal,
        "mean_abs_dequant_err": float(
            (qz.dequantize_int8(vals, scales) - x).abs().mean()),
        "launches": launches,
    }
    del rv, rs, bv, bs
    rec["kernel_ms"] = timer(lambda: qz.quantize_int8_hash(x, seed), 20)
    rec["twin_ms"] = timer(lambda: qz.quantize_int8_hash_ref(x, seed), 3)
    rec["build_quantizer_ms"] = timer(lambda: qz.quantize_int8(x, seed), 3)
    print(json.dumps({"quantize_check": rec}), flush=True)
    if not (rec["values_equal"] and rec["scales_equal"]):
        raise AssertionError(f"the quantize kernel differs from its twin: {rec}")
    if not (rec["build_scales_equal"] and built_equal):
        raise AssertionError(f"the build quantizer disagrees: {rec}")
    want = 1 if torch.device(device).type == "cuda" else 0
    if launches != {"quantize_i8": want}:
        raise AssertionError(f"expected {want} quantize launch, got {launches}")
    return rec


def int8_kernel_phase(paths, device, seed: int, qs=KERNEL_QS,
                      k=TOP_K_CANDIDATES, window=WINDOW, timer=cuda_ms,
                      min_recall=0.98, min_f32_recall=0.95,
                      wide_dim=WIDE_I8_DIM, wide_rows=WIDE_I8_ROWS):
    """The int8 window kernel against its twin on the saved int8 index and
    user-tower queries: window maxima and positions equal, the top-k ids
    equal after ``canonical_tie_order``; recall@k against the exact top-k
    of the same int8 scores (``min_recall``) and of the unquantised f32
    rows (``min_f32_recall``); the body the wrapper launched (``tc_route``:
    the tensor cores, on the card; the twin launches none) and the times of
    the kernel, the twin and the int8 product alone (``int8_gemm_only_ms``).
    On the card also the dp4a body through its own entry (equal to the twin,
    and timed). Then, once, the dp4a body where the wrapper takes it, at
    ``wide_dim`` columns (the saved rows and queries widened with random
    int8 columns, ``wide_rows`` rows), equal to the twin. Returns (one
    record per batch size, the wide check)."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import _build
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.topk import (
        canonical_tie_order,
        fast_topk,
        mips_topk_int8,
        quantize_queries,
        score_matrix,
    )

    model = TwoTower.load(paths["model_path"], device=device)
    index = MIPSIndex.load(paths["index_i8_path"], device=device)
    corpus, scales, n_valid = index._embs, index._scales, index.n_total
    rows_f32 = torch.as_tensor(np.load(paths["catalog_path"]), device=device)
    width = rows_f32.shape[1]
    d = int(corpus.shape[1])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        stages = ctypes.c_int(0)
        smem = _build.load_library("window_mips_i8").window_mips_i8_tc_smem(
            d, ctypes.byref(stages))
        print(json.dumps({"ptxas_window_mips_i8": ptxas_summary(
            _build.ptxas_logs.get("window_mips_i8", "")), "window_i8_tc_smem": {
                "d": d, "dynamic_bytes": smem, "stages": stages.value}}), flush=True)
    rng = np.random.default_rng(seed + 1)
    out = []
    for n_q in qs:
        uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q),
                               device=device)
        q = index._augment(model.user_tower(uids))
        q8, _ = quantize_queries(q)
        mw.LAST_BODY["window_mips_i8"] = None
        kv, ka = mw.window_candidates_i8(q8, corpus, scales, window, n_valid)
        body = mw.LAST_BODY["window_mips_i8"]
        rv, ra = mw.window_candidates_i8_ref(q8, corpus, scales, window, n_valid)
        args = (q, corpus, scales, k, INDEX_BLOCK, window, n_valid)
        v, i = mw.mips_topk_window_im_int8(*args)
        tv, ti = mw.mips_topk_window_im_int8_ref(*args)
        (cv, ci), (ctv, cti) = canonical_tie_order(v, i), canonical_tie_order(tv, ti)
        _, ei = mips_topk_int8(q, corpus[:n_valid], scales[:n_valid], k)
        _, fi = fast_topk(score_matrix(q[:, :width], rows_f32, "highest"), k)
        rec = {
            "q": n_q, "n": n_valid, "d": int(corpus.shape[1]),
            "d_func": index._width, "window": window, "k": k,
            "dtype": str(corpus.dtype),
            "window_max_equal": bool(torch.equal(kv, rv)),
            "window_arg_equal": bool(torch.equal(ka, ra)),
            "window_max_abs_err": float((kv - rv).abs().max()),
            "topk_ids_equal": bool(torch.equal(ci, cti)),
            "topk_values_equal": bool(torch.equal(cv, ctv)),
            "recall_vs_int8_exact": _overlap(i, ei),
            "recall_vs_f32_exact": _overlap(i, fi),
            "bin_model_recall": 1 - (k - 1) * window / (2 * n_valid),
            "body": body,
            "tc_route": body == "tensor_cores",
        }
        reps = 20 if n_q <= 256 else 10
        if on_card:
            dv, da = mw._window_candidates_i8_cuda(q8, corpus, scales, window,
                                                   n_valid, body="cuda_cores")
            rec["dp4a_equal"] = bool(torch.equal(dv, rv) and torch.equal(da, ra))
            del dv, da
            rec["dp4a_ms"] = timer(lambda: mw._window_candidates_i8_cuda(
                q8, corpus, scales, window, n_valid, body="cuda_cores"), reps)
        del kv, ka, rv, ra, ei, fi
        rec["kernel_ms"] = timer(
            lambda: mw.window_candidates_i8(q8, corpus, scales, window, n_valid),
            reps)
        rec["bound_share"] = (window_bound(rec, 1, 1, "int8", scales=True)[0]
                              / rec["kernel_ms"])
        rec["int8_gemm_only_ms"] = timer(lambda: gemm_only_i8(q8, corpus), reps)
        rec["twin_ms"] = timer(
            lambda: mw.window_candidates_i8_ref(q8, corpus, scales, window,
                                                n_valid), 3)
        rec["kernel_topk_ms"] = timer(lambda: mw.mips_topk_window_im_int8(*args),
                                      reps)
        rec["twin_topk_ms"] = timer(
            lambda: mw.mips_topk_window_im_int8_ref(*args), 3)
        print(json.dumps({"int8_kernel_check": rec}), flush=True)
        if on_card and not rec["tc_route"]:
            raise AssertionError(f"the int8 corpus missed the tensor cores: {rec}")
        if not (rec["window_max_equal"] and rec["window_arg_equal"]):
            raise AssertionError(f"int8 window maxima differ from the twin: {rec}")
        if not rec.get("dp4a_equal", True):
            raise AssertionError(f"the dp4a body differs from the twin: {rec}")
        if not (rec["topk_ids_equal"] and rec["topk_values_equal"]):
            raise AssertionError(f"int8 top-{k} differs from the twin: {rec}")
        if rec["recall_vs_int8_exact"] < min_recall:
            raise AssertionError(f"recall@{k} vs int8-exact < {min_recall}: {rec}")
        if rec["recall_vs_f32_exact"] < min_f32_recall:
            raise AssertionError(f"recall@{k} vs f32-exact < {min_f32_recall}: {rec}")
        out.append(rec)

    # the dp4a body where the wrapper takes it: rows wider than the
    # tensor-core limit
    gen = torch.Generator().manual_seed(seed + 10)
    n_w = min(wide_rows, corpus.shape[0])
    extra = torch.randint(-127, 128, (n_w + q8.shape[0], wide_dim - d),
                          generator=gen, dtype=torch.int8).to(device)
    wq = torch.cat([q8, extra[n_w:]], 1)
    wc = torch.cat([corpus[:n_w], extra[:n_w]], 1)
    mw.LAST_BODY["window_mips_i8"] = None
    wv, wa = mw.window_candidates_i8(wq, wc, scales[:n_w], window)
    tv, ta = mw.window_candidates_i8_ref(wq, wc, scales[:n_w], window)
    wide = {"q": wq.shape[0], "n": n_w, "d": wide_dim, "window": window,
            "body": mw.LAST_BODY["window_mips_i8"],
            "equal": bool(torch.equal(wv, tv) and torch.equal(wa, ta))}
    print(json.dumps({"int8_wide_check": wide}), flush=True)
    if (on_card and wide["body"] != "cuda_cores") or not wide["equal"]:
        raise AssertionError(f"the dp4a body at width {wide_dim}: {wide}")
    return out, wide


def qm_window_phase(paths, device, seed: int, qs=KERNEL_QS, k=TOP_K_CANDIDATES,
                    window=WINDOW, default_window=QM_WINDOW, block=QM_BLOCK,
                    timer=cuda_ms):
    """Kernel 2 (the queries-major window kernel) on the saved bf16 corpus
    and user-tower queries: at each Q and ``window`` its maxima within 1e-3
    of the twin, its top-k ids overlapping the twin's by >= 0.99, and its
    maxima and positions equal to kernel 1's transposed (the same tiles and
    arithmetic); then at the largest Q and ``default_window`` the same
    checks and both times. Returns one record per (Q, window)."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.topk import fast_topk, score_matrix

    model = TwoTower.load(paths["model_path"], device=device)
    index = MIPSIndex.load(paths["index_path"], device=device)
    corpus, n_valid = index._embs, index.n_total
    rng = np.random.default_rng(seed + 6)
    out = []
    for n_q, w in [(n_q, window) for n_q in qs] + [(qs[-1], default_window)]:
        uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q),
                               device=device)
        q = index._augment(model.user_tower(uids))
        kv, ka = mw.window_candidates_qm(q, corpus, w, n_valid)
        rv, ra = mw.window_candidates_qm_ref(q, corpus, w, n_valid)
        iv, ia = mw.window_candidates(q, corpus, w, n_valid)
        v, i = mw.mips_topk_window(q, corpus, k, block, w, n_valid=n_valid)
        tv, ti = mw.mips_topk_window_ref(q, corpus, k, block, w, n_valid=n_valid)
        _, ei = fast_topk(score_matrix(q, corpus[:n_valid], "default"), k)
        rec = {
            "q": n_q, "n": n_valid, "d": int(corpus.shape[1]),
            "d_func": index._width, "window": w, "k": k,
            "dtype": str(corpus.dtype),
            "window_max_abs_err": float((kv - rv).abs().max()),
            "equals_items_major_transposed": bool(
                torch.equal(kv, iv.T) and torch.equal(ka, ia.T)),
            "args_equal_share": float((ka == ra).float().mean()),
            "topk_value_abs_err": float((v - tv).abs().max()),
            "id_overlap_vs_twin": _overlap(i, ti),
            "recall_vs_exact": _overlap(i, ei),
            "bin_model_recall": 1 - (k - 1) * w / (2 * n_valid),
        }
        del kv, ka, rv, ra, iv, ia, ei
        if w == default_window:
            rec["kernel_ms"] = timer(
                lambda: mw.window_candidates_qm(q, corpus, w, n_valid), 10)
            rec["twin_ms"] = timer(
                lambda: mw.window_candidates_qm_ref(q, corpus, w, n_valid), 3)
        print(json.dumps({"qm_window_check": rec}), flush=True)
        if rec["window_max_abs_err"] > 1e-3:
            raise AssertionError(f"queries-major maxima differ from the twin: {rec}")
        if not rec["equals_items_major_transposed"]:
            raise AssertionError(f"kernel 2 differs from kernel 1 transposed: {rec}")
        if rec["id_overlap_vs_twin"] < 0.99:
            raise AssertionError(f"top-{k} id overlap with the twin < 0.99: {rec}")
        out.append(rec)
    return out


def router_phase(paths, device, seed: int, qs=ROUTER_QS, k=TOP_K_CANDIDATES,
                 block=INDEX_BLOCK, timer=cuda_ms):
    """Both routes of ``mips_topk_fused_auto`` over the saved bf16 corpus,
    each run as the router runs it (``mips_topk_fused_route``), timed at
    every batch size in ``qs``, beside the route the router takes there
    (its constants are the TPU's and stay so: the kernel route is the
    approximate answer). Returns (records, the smallest Q from which the
    kernel route is the faster at every larger measured Q, or None)."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import mips_window as mw

    model = TwoTower.load(paths["model_path"], device=device)
    index = MIPSIndex.load(paths["index_path"], device=device)
    corpus, n_valid = index._embs, index.n_total
    window = mw.fused_window(n_valid, k)
    rng = np.random.default_rng(seed + 9)
    out = []
    for n_q in qs:
        uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q),
                               device=device)
        q = index._augment(model.user_tower(uids))
        rec = {"q": n_q, "n": n_valid, "window": window, "k": k,
               "router_takes": mw.fused_route(n_q, n_valid, k)[0]}
        for route, w in (("scan", 0), ("kernel", window)):
            rec[f"{route}_ms"] = timer(lambda: mw.mips_topk_fused_route(
                route, w, q, corpus, k, block, "default", n_valid), 10)
        out.append(rec)
    crossover = None
    for rec in reversed(out):
        if rec["kernel_ms"] >= rec["scan_ms"]:
            break
        crossover = rec["q"]
    print(json.dumps({"router_check": out, "kernel_faster_from_q": crossover}),
          flush=True)
    return out, crossover


KERNEL_GROUPS = (("window_tc_kernel", "window kernel"), ("window_mips", "window kernel"),
                 ("gemm", "cuBLAS GEMMs"), ("topk", "top-k"), ("sort", "top-k"),
                 ("CatArray", "cat"), ("gather", "gathers and indexing"),
                 ("index", "gathers and indexing"), ("reduce_kernel", "reductions"))


def _kernel_group(name: str) -> str:
    """The part of a serve batch a device kernel belongs to, by its name."""
    return next((g for key, g in KERNEL_GROUPS if key in name), "elementwise")


def _short_kernel_name(name: str) -> str:
    """A device kernel's name without its template arguments, with the
    functor of an elementwise kernel kept (``elementwise_kernel:add``)."""
    base = re.sub(r"^void |at::native::|\(anonymous namespace\)::", "", name)
    base = re.split(r"[<(]", base, maxsplit=1)[0]
    op = re.search(r"CUDAFunctor_(\w+?)<|binary_internal::(\w+?)Functor|launch_(\w+?)_scalar"
                   r"|(direct_copy)_kernel|(\w+?)_kernel_cuda", name)
    return f"{base}:{next(g for g in op.groups() if g)}" if op and "elementwise" in base else base


def profile_phase(paths, data, device, n_calls: int = 10, batch: int = BATCH,
                  top: int = 12, dtype: str = "bfloat16", pipe=None,
                  label: str = None):
    """``torch.profiler`` over ``n_calls`` ``serve_batch`` calls of
    ``batch`` users over the fused index of ``dtype`` (of ``pipe`` where
    given), after a warm one: device time per call by kernel group and by
    kernel (the ``top`` largest), all device kernels, the host clock per
    call and the share of it the device is idle. Printed as ``label``, by
    default ``serve_profile`` (bf16) or ``serve_profile_int8``."""
    if pipe is None:
        pipe = load_pipeline(paths, data, device, dtype)
    rng = np.random.default_rng(11)
    users = rng.integers(1, pipe._n_users + 1, batch).tolist()
    pipe.serve_batch(users)

    def body():
        t0 = time.perf_counter()
        for _ in range(n_calls):
            pipe.serve_batch(users)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_calls

    prof, host_ms = profiled(body)
    kernels, groups, launches = {}, {}, 0
    for key, dev_us, count in device_events(prof):
        ms = dev_us / 1e3 / n_calls
        name = _short_kernel_name(key)
        kernels[name] = kernels.get(name, 0.0) + ms
        group = _kernel_group(key)
        groups[group] = groups.get(group, 0.0) + ms
        launches += count
    device_ms = sum(kernels.values())
    rec = {"index_dtype": dtype, "batch": batch, "calls": n_calls,
           "host_ms_per_call": host_ms,
           "device_ms_per_call": device_ms,
           "device_idle_share": 1 - device_ms / host_ms,
           "kernel_launches_per_call": launches / n_calls,
           "groups_ms_per_call": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "kernels_ms_per_call": dict(sorted(kernels.items(),
                                              key=lambda kv: -kv[1])[:top])}
    label = label or ("serve_profile_int8" if dtype == "int8" else "serve_profile")
    print(json.dumps({label: rec}), flush=True)
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return rec


def _tie_inputs(n, d, n_q, dtype, device, seed):
    """Integer-valued queries and rows in {-1, 0, 1}: every score is an
    exact small integer, so bins are full of ties."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(-1, 2, (n_q, d), generator=g).float()
    items = torch.randint(-1, 2, (n, d), generator=g).float().to(dtype)
    return q.to(device), items.to(device)


def lo_heavy_inputs(n, d, n_q, device, seed):
    """f32 queries whose third bf16 piece (``lo`` of ``split_bf16x3``) is
    near the largest the split allows, 2⁻¹⁸–2⁻¹⁷ of the element, and has the
    sign of the row element it multiplies, while the terms' own signs are
    random: in every score the lo products add up to ~4e-6·Σ|q_k·x_k| and
    the partial sums stay small. Rows s_k·u with u > 0, unit, bf16."""
    g = torch.Generator().manual_seed(seed)
    s = torch.randint(0, 2, (d,), generator=g).float() * 2 - 1
    u = torch.rand(n, d, generator=g) + 0.25
    items = (s * u / u.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    hi = torch.randn(n_q, d, generator=g).to(torch.bfloat16).float()
    ulp = torch.ldexp(torch.ones_like(hi), torch.frexp(hi).exponent - 8)
    sign = torch.randint(0, 2, (n_q, d), generator=g).float() * 2 - 1
    # mid just under half of hi's ulp, lo just under half of mid's
    q = hi + sign * ulp * (2.0 ** -1 - 2.0 ** -8) + s * ulp * (2.0 ** -10 - 2.0 ** -16)
    return q.to(device), items.to(device)


def fold_f64_err(q, items, vals, ids, chunk: int = 16) -> float:
    """The largest error of a fold's scores against f64, relative to each
    score's Σ|q_k·x_k| (the scale of f32 rounding; C.22): every candidate
    of a real row against the f64 dot product of its query and that row.
    Candidates of pad rows (ids ≥ N) must hold ``pad_score`` exactly."""
    from recommendit_tpu_torch.ops.mips_fold import pad_score

    n = items.shape[0]
    worst = 0.0
    for s in range(0, q.shape[0], chunk):
        i = ids[s:s + chunk].long()
        v = vals[s:s + chunk]
        real = i < n
        if not bool((v[~real] == pad_score(items.dtype)).all()):
            raise AssertionError("a bin of pad rows holds no pad score")
        terms = q[s:s + chunk].double()[:, None, :] * items[i.clamp(max=n - 1)].double()
        exact, mag = terms.sum(-1), terms.abs().sum(-1)
        err = (v.double() - exact).abs()
        err = torch.where(mag > 0, err / mag, err)[real]
        if err.numel():
            worst = max(worst, float(err.max()))
    return worst


# (N, D, Q, block, R): bins narrower than a 64-row tile (bn/R = 32) and
# wider (256), both with a bias pad (N % bn != 0), a tiny block, and
# N = 2·bn + 1 at the path's width (bf16: the tensor-core body, with a block
# of one real row and tiles wholly past the corpus; a ragged query tile)
TIE_CASES = ((5000, 8, 100, 256, 8), (9000, 12, 70, 2048, 8),
             (301, 4, 3, 16, 4), (4097, 136, 129, 2048, 64))


def fold_phase(paths, device, seed: int, n_q: int = FOLD_Q,
               k: int = TOP_K_CANDIDATES, block: int = FOLD_BLOCK,
               reduction: int = FOLD_R, timer=cuda_ms, min_recall=0.98,
               tie_cases=TIE_CASES, jax_reduction: int = FOLD_JAX_R,
               f64_q: int = FOLD_F64_Q, lo_case=FOLD_LO_CASE):
    """Kernel 4 (the fold) through ``mips_topk_fused`` on the valid rows of
    the saved bf16 corpus and user-tower queries: the body the wrapper
    launched (``tc_route``: the tensor cores, on the card; the twin launches
    none), candidates within 1e-4 of the twin relative to the largest; on
    ``f64_q`` queries every score within ``FOLD_F64_LIMIT`` of f64
    (:func:`fold_f64_err`), and so on the ``lo_case`` inputs
    (:func:`lo_heavy_inputs`), where the control — the twin fed the first
    two bf16 pieces alone, what a kernel without the third computes — must
    read above the limit; recall@k against the exact top-k of the same
    f32-query scores; the query
    split equal to its twin; on integer-valued inputs full of ties the
    candidates equal to the twin's (values and ids), on the card also
    through the CUDA-core entry. The times of the kernel, the twin, the
    CUDA-core body (``cuda_cores_ms``), the kernel at ``jax_reduction`` (JAX's
    default R) and the split with its twin."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import _build
    from recommendit_tpu_torch.ops import mips_fold as mf
    from recommendit_tpu_torch.ops.topk import fast_topk, score_matrix

    model = TwoTower.load(paths["model_path"], device=device)
    index = MIPSIndex.load(paths["index_path"], device=device)
    corpus = index._embs[:index.n_total]
    n = corpus.shape[0]
    rng = np.random.default_rng(seed + 7)
    uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q), device=device)
    q = index._augment(model.user_tower(uids))
    on_card = torch.device(device).type == "cuda"
    mf.LAST_BODY["fold_mips"] = None
    cv, ci = mf.fold_candidates(q, corpus, block, reduction)
    body = mf.LAST_BODY["fold_mips"]
    rv, ri = mf.fold_candidates_ref(q, corpus, block, reduction)
    v, i = mf.mips_topk_fused(q, corpus, k, block, reduction)
    _, ei = fast_topk(score_matrix(q, corpus, "highest"), k)
    bn, out, n_blocks = mf.fold_shape(n, k, block, reduction)
    split, split_twin = mf.split_queries(q), mf.split_bf16x3(q)
    rec = {
        "q": n_q, "n": n, "d": int(corpus.shape[1]), "d_func": index._width,
        "block": bn,
        "reduction": reduction, "k": k, "dtype": str(corpus.dtype),
        "n_cand": n_blocks * out,
        "body": body, "tc_route": body == "tensor_cores",
        "max_abs_err": float((cv - rv).abs().max()),
        "rel_err": float((cv - rv).abs().max() / rv.abs().max()),
        "ids_equal_share": float((ci == ri).float().mean()),
        "recall_vs_exact": _overlap(i, ei),
        "bin_model_recall": 1 - (k - 1) * reduction / (2 * n),
        "split_equal": bool(torch.equal(split.view(torch.int16),
                                        split_twin.view(torch.int16))),
        "split_max_abs_err": float((split.float() - split_twin.float()).abs().max()),
    }

    def two_pieces(queries, items):
        """The control: the twin fed hi + mid, a kernel without lo."""
        hi, mid, _ = mf.split_bf16x3(queries).float()
        return mf.fold_candidates_ref(hi + mid, items, block, reduction)

    nc = min(n_q, f64_q)
    v2, i2 = two_pieces(q[:nc], corpus)
    rec["f64_q"] = nc
    rec["f64_err"] = fold_f64_err(q[:nc], corpus, cv[:nc], ci[:nc])
    rec["two_piece_f64_err"] = fold_f64_err(q[:nc], corpus, v2, i2)
    rec["two_piece_rel_err"] = float((v2 - rv[:nc]).abs().max() / rv.abs().max())
    del cv, ci, rv, ri, ei, split, split_twin, v2, i2
    lq, li = lo_heavy_inputs(*lo_case, device, seed + 9)
    mf.LAST_BODY["fold_mips"] = None
    lv, lid = mf.fold_candidates(lq, li, block, reduction)
    rec["lo_case"] = {"n": lo_case[0], "d": lo_case[1], "q": lo_case[2],
                      "body": mf.LAST_BODY["fold_mips"],
                      "f64_err": fold_f64_err(lq, li, lv, lid),
                      "two_piece_f64_err": fold_f64_err(lq, li, *two_pieces(lq, li))}
    del lq, li, lv, lid
    ties, ties_cc = [], []
    for j, (tn, td, tq, tb, tr) in enumerate(tie_cases):
        for dtype in (torch.float32, torch.bfloat16):
            tq_, ti_ = _tie_inputs(tn, td, tq, dtype, device, seed + j)
            b = mf.fold_candidates_ref(tq_, ti_, tb, tr)
            got = [mf.fold_candidates(tq_, ti_, tb, tr)]
            if on_card:
                got.append(mf._fold_candidates_cuda(tq_, ti_, tb, tr,
                                                    body="cuda_cores"))
            same = [bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
                    for a in got]
            ties.append(same[0])
            ties_cc += same[1:]
    rec["ties_equal"] = ties
    if on_card:
        rec["ties_equal_cuda_cores"] = ties_cc
        rec["ptxas"] = ptxas_summary(_build.ptxas_logs.get("fold_mips", ""))
        rec["cuda_cores_ms"] = timer(lambda: mf._fold_candidates_cuda(
            q, corpus, block, reduction, body="cuda_cores"), 5)
    rec["kernel_ms"] = timer(
        lambda: mf.fold_candidates(q, corpus, block, reduction), 10)
    mf.LAST_BODY["fold_mips"] = None
    rec["jax_reduction"] = jax_reduction
    rec["jax_reduction_kernel_ms"] = timer(
        lambda: mf.fold_candidates(q, corpus, block, jax_reduction), 10)
    rec["jax_reduction_body"] = mf.LAST_BODY["fold_mips"]
    rec["split_ms"] = timer(lambda: mf.split_queries(q), 50)
    rec["split_twin_ms"] = timer(lambda: mf.split_bf16x3(q), 50)
    rec["twin_ms"] = timer(
        lambda: mf.fold_candidates_ref(q, corpus, block, reduction), 3)
    rec["kernel_topk_ms"] = timer(
        lambda: mf.mips_topk_fused(q, corpus, k, block, reduction), 10)
    rec["bound_ms"], rec["bound_by"], rec["bound_f32_ms"] = fold_bounds(rec)
    print(json.dumps({"fold_check": rec}), flush=True)
    lo = rec["lo_case"]
    if on_card and corpus.dtype == torch.bfloat16 and not (
            rec["tc_route"] and rec["jax_reduction_body"] == "tensor_cores"
            and lo["body"] == "tensor_cores"):
        raise AssertionError(f"the bf16 corpus missed the tensor cores: {rec}")
    if not rec["split_equal"]:
        raise AssertionError(f"the query split differs from its twin: {rec}")
    if not all(ties_cc):
        raise AssertionError(f"the CUDA-core fold's ties differ from the twin: {rec}")
    if rec["rel_err"] > 1e-4:
        raise AssertionError(f"fold candidates differ from the twin: {rec}")
    if max(rec["f64_err"], lo["f64_err"]) > FOLD_F64_LIMIT:
        raise AssertionError(f"fold scores are not f32-grade: {rec}")
    if lo["two_piece_f64_err"] <= FOLD_F64_LIMIT:
        raise AssertionError(f"the f64 check cannot tell two pieces from three: {rec}")
    if rec["ids_equal_share"] < 0.999:
        raise AssertionError(f"fold rows differ from the twin's: {rec}")
    if not all(ties):
        raise AssertionError(f"fold ties differ from the twin: {rec}")
    if rec["recall_vs_exact"] < min_recall:
        raise AssertionError(f"recall@{k} < {min_recall}: {rec}")
    return rec


def gather_phase(paths, device, seed: int, shape=GATHER_SHAPE, timer=cuda_ms):
    """Kernel 8 on the serve's packed item table (padded to 64 columns):
    one launch through ``gather_rows`` with a ``shape`` int64 index (the
    counted run), equal to the twin; out-of-range and int32 indices, the
    unpadded 23-wide f32 table and a bf16 table, each equal to the twin;
    the times of the kernel, the twin and ``torch.index_select``, and the
    bytes this index must move (each distinct row read once, the output
    written once, the index read once)."""
    from recommendit_tpu_torch.features.schema import pad_packed_width
    from recommendit_tpu_torch.ops import gather

    raw = np.load(Path(paths["features_dir"]) / "item_packed.npy")
    table = torch.as_tensor(pad_packed_width(raw), device=device)
    rng = np.random.default_rng(seed + 8)
    idx = torch.as_tensor(rng.integers(0, table.shape[0], size=shape),
                          device=device)
    for name in gather.LAUNCHES:
        gather.LAUNCHES[name] = 0
    got = gather.gather_rows(table, idx)
    launches = dict(gather.LAUNCHES)
    want = gather.gather_rows_ref(table, idx)
    bad = torch.tensor([-5, table.shape[0], 10 ** 12, -10 ** 12], device=device)
    wild = idx.clone()
    at = torch.arange(0, wild.numel(), 997, device=device)
    wild.view(-1)[at] = bad[torch.arange(len(at), device=device) % len(bad)]
    narrow = torch.as_tensor(raw, device=device)
    variants = {
        "out_of_range": (table, wild),
        "int32": (table, wild.clamp(-2 ** 31, 2 ** 31 - 1).int()),
        "f32_23_wide": (narrow, wild),
        "bf16": (table.to(torch.bfloat16), wild),
        "zero_dim": (narrow, idx[0, 0]),
    }
    equal = {k: bool(torch.equal(gather.gather_rows(t, i), gather.gather_rows_ref(t, i)))
             for k, (t, i) in variants.items()}
    row_bytes = table.shape[1] * table.element_size()
    rec = {
        "table": list(table.shape), "index": list(shape),
        "equal": bool(torch.equal(got, want)), "variants_equal": equal,
        "max_abs_err": float((got - want).abs().max()),
        "bytes": (int(torch.unique(idx).numel()) * row_bytes
                  + idx.numel() * row_bytes + idx.numel() * idx.element_size()),
        "launches": launches,
    }
    flat = idx.view(-1)
    rec["kernel_ms"] = timer(lambda: gather.gather_rows(table, idx), 50)
    rec["twin_ms"] = timer(lambda: gather.gather_rows_ref(table, idx), 20)
    rec["library_ms"] = timer(lambda: torch.index_select(table, 0, flat), 50)
    print(json.dumps({"gather_check": rec}), flush=True)
    if not rec["equal"] or not all(equal.values()):
        raise AssertionError(f"gather_rows differs from its twin: {rec}")
    want_launches = 1 if torch.device(device).type == "cuda" else 0
    if launches != {"gather_rows": want_launches}:
        raise AssertionError(f"expected {want_launches} gather launch, got {launches}")
    return rec


def probe_phase(device, probe_args=PROBE_ARGS):
    """The kernel probe's four variants in-process (the path of kernels 2
    and 4), each of which must exit 0; the window and fold launch counts
    are read around exactly this run. Returns (records, launches)."""
    from recommendit_tpu_torch.ops import mips_fold as mf
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.scripts import kernel_probe

    dev = torch.device(device).type
    for counts in (mw.LAUNCHES, mf.LAUNCHES):
        for name in counts:
            counts[name] = 0
    recs = []
    for variant in kernel_probe.VARIANTS:
        code, rec = kernel_probe.probe(["--variant", variant, *probe_args,
                                        "--device", dev])
        print(json.dumps(rec), flush=True)
        if code != 0:
            raise AssertionError(f"kernel probe {variant} exited {code}: {rec}")
        recs.append(rec)
    launches = {**mw.LAUNCHES, **mf.LAUNCHES}
    if dev == "cuda" and not all(launches.values()):
        raise AssertionError(f"the probe missed a kernel: {launches}")
    return recs, launches


def capacity_phase(device, seed: int, n_rows: int = CAPACITY_ROWS,
                   dim: int = CAPACITY_DIM, window: int = CAPACITY_WINDOW,
                   n_q: int = CAPACITY_Q, n_check: int = CAPACITY_CHECK_Q,
                   k: int = TOP_K_CANDIDATES, chunk: int = CAPACITY_CHUNK,
                   block: int = INDEX_BLOCK, timer=cuda_ms, min_recall=0.98,
                   iters: int = CAPACITY_ITERS, out=None):
    """``scripts/capacity_30m.py`` through the port's script
    (``recommendit_tpu_torch/scripts/capacity_30m.py``): ``n_rows`` random
    unit rows made, normalised and quantised on the device chunk by chunk
    (the threefry counter offset by each chunk's first row), padded with
    scale-0 rows to a ``block`` multiple (``make_corpus``); the script's
    run (recall@k on ``n_check`` queries against int8-exact, the chained
    batch time at ``n_q`` queries, ``iters`` a round) with kernel 3's
    launches counted around exactly that run (``launches``); its recall and
    chained batch time are the phase's; then on the same ``n_check``
    queries kernel 3's maxima and positions equal to the twin's
    (row-chunked) and the body it launched (``body``: the tensor cores, on
    the card); kernel 3 alone timed at ``n_q`` queries."""
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.topk import quantize_queries
    from recommendit_tpu_torch.scripts import capacity_30m

    dev = torch.device(device)
    args = capacity_30m.parse_args([
        "--n", str(n_rows), "--d", str(dim), "--k", str(k), "--block", str(block),
        "--q", str(n_q), "--recall-queries", str(n_check), "--iters", str(iters),
        "--seed", str(seed), "--device", dev.type,
        *(("--out", str(out)) if out else ())])
    t0 = time.perf_counter()
    corpus, scales = capacity_30m.make_corpus(n_rows, dim, block, seed, dev, chunk)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    _reset(mw.LAUNCHES)
    t0 = time.perf_counter()
    report = capacity_30m.run(args, (corpus, scales), window=window)
    script_s = time.perf_counter() - t0
    launches = mw.LAUNCHES["window_mips_i8"]
    if out:
        capacity_30m.write_report(report, args.out)

    qc, q = capacity_30m.make_queries(args, dev)
    q8, _ = quantize_queries(qc)
    mw.LAST_BODY["window_mips_i8"] = None
    kv, ka = mw.window_candidates_i8(q8, corpus, scales, window, n_rows)
    body = mw.LAST_BODY["window_mips_i8"]
    rv, ra = mw.window_candidates_i8_ref(q8, corpus, scales, window, n_rows)
    rec = {
        "n": n_rows, "d": dim, "window": window, "k": k, "q": n_q,
        "check_q": n_check, "corpus_bytes": corpus.numel() + 4 * scales.numel(),
        "build_s": build_s, "script_s": script_s, "script": report,
        "launches": launches,
        "window_max_equal": bool(torch.equal(kv, rv)),
        "window_arg_equal": bool(torch.equal(ka, ra)),
        "recall_vs_int8_exact": report["recall_at_500_vs_int8_exact_mean"],
        "bin_model_recall": 1 - (k - 1) * window / (2 * n_rows),
        "body": body,
        "queries_per_s": report["qps"],
    }
    del kv, ka, rv, ra
    q8, _ = quantize_queries(q)
    rec["kernel_ms"] = timer(
        lambda: mw.window_candidates_i8(q8, corpus, scales, window, n_rows), 3)
    print(json.dumps({"capacity_check": rec}), flush=True)
    if dev.type == "cuda" and body != "tensor_cores":
        raise AssertionError(f"the capacity corpus missed the tensor cores: {rec}")
    if dev.type == "cuda" and not launches:
        raise AssertionError(f"capacity_30m launched no int8 window kernel: {rec}")
    if not (rec["window_max_equal"] and rec["window_arg_equal"]):
        raise AssertionError(f"int8 window maxima differ from the twin: {rec}")
    if rec["recall_vs_int8_exact"] < min_recall:
        raise AssertionError(f"recall@{k} vs int8-exact < {min_recall}: {rec}")
    return rec


def window_twin_chunked(q, items, window: int, n_valid: int, precision: str = "default",
                        rows: int = CAPACITY_CHUNK):
    """Kernel 1's twin (``window_candidates_ref``) over window-aligned row
    chunks of ``items``, so that no widened copy of a large corpus is live
    whole → (n_cand, Q) maxima and positions."""
    from recommendit_tpu_torch.ops import mips_window as mw

    rows = max(window, rows // window * window)
    vals, args = [], []
    for r0 in range(0, items.shape[0], rows):
        r1 = min(items.shape[0], r0 + rows)
        v, a = mw.window_candidates_ref(q, items[r0:r1], window,
                                        max(0, min(n_valid, r1) - r0), precision)
        vals.append(v)
        args.append(a)
    return torch.cat(vals), torch.cat(args)


def window_agreement(q, items, kv, ka, rv, ra, window: int, n_valid: int,
                     precision: str = "default") -> dict:
    """Kernel 1's maxima and positions against the twin's: the largest
    difference of the maxima, the share of equal positions, and where the
    positions differ, the largest gap between the twin's maximum and the
    score at the kernel's position (a tie within the f32 sums' rounding
    where it is small)."""
    from recommendit_tpu_torch.ops.topk import round_queries

    diff = (ka != ra).nonzero()
    gap = 0.0
    if len(diff):
        cand, col = diff[:, 0], diff[:, 1]
        rows = cand.long() * window + ka[cand, col].long()
        qq = round_queries(q[col], items.dtype, precision)
        score = (qq * items[rows.clamp(max=items.shape[0] - 1)].float()).sum(dim=1)
        score = torch.where(rows >= n_valid, torch.full_like(score, -3e38), score)
        gap = float((score - rv[cand, col]).abs().max())
    return {"window_max_abs_err": float((kv - rv).abs().max()),
            "args_equal_share": 1.0 - len(diff) / ka.numel(),
            "args_tie_gap": gap}


def _check_agreement(label: str, rec: dict, tol: float = DRIVER_TWIN_TOL) -> None:
    if not (rec["window_max_abs_err"] <= tol and rec["args_tie_gap"] <= tol):
        raise AssertionError(f"{label}: kernel 1 against its twin beyond {tol}: {rec}")


def kernel1_twin_check(q, items, window: int, n_valid: int) -> dict:
    """Kernel 1 on ``q`` over ``items`` against its row-chunked twin: the
    body the wrapper launched (``check_body``; None on the CPU) and
    :func:`window_agreement`."""
    from recommendit_tpu_torch.ops import mips_window as mw

    with torch.no_grad():
        mw.LAST_BODY["window_mips"] = None
        kv, ka = mw.window_candidates(q, items, window, n_valid)
        body = mw.LAST_BODY["window_mips"]
        rv, ra = window_twin_chunked(q, items, window, n_valid)
        return {"check_body": body,
                **window_agreement(q, items, kv, ka, rv, ra, window, n_valid)}


def timer_chain_cost(device, shape=TIMER_CHAIN_SHAPE, iters: int = 20,
                     rounds: int = 4) -> dict:
    """The drivers' timer (``device_loop_time``) around a step that launches
    nothing, returning a (Q, k) constant: the chain's own ms an iteration
    (best and every round) and the host's ms to enqueue it."""
    from recommendit_tpu_torch.utils.profiling import device_loop_time

    q, k, d = shape
    dev = torch.device(device)
    const = torch.ones((q, k), device=dev)
    stats = {}
    best = device_loop_time(lambda qq: (const,), torch.zeros((q, d), device=dev),
                            iters=iters, rounds=rounds, stats=stats)
    rec = {"shape": shape, "best_ms": best * 1e3, **stats}
    print(json.dumps({"timer_chain": rec}), flush=True)
    return rec


def _driver_args(module, name: str, extra, device, workdir: Path):
    return module.parse_args([*extra, "--device", torch.device(device).type,
                              "--out", str(workdir / "drivers" / f"{name}.json")])


def _run_driver(name: str, fn, device):
    """``fn()`` with the window wrappers' counts set to 0 just before and
    read just after → (report, seconds, launches); prints both."""
    from recommendit_tpu_torch.ops import mips_window as mw

    _reset(mw.LAUNCHES)
    t0 = time.perf_counter()
    report = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(mw.LAUNCHES)
    print(json.dumps({"driver": name, "report": report}), flush=True)
    print(json.dumps({"driver": name, "seconds": seconds, "launches": launches}),
          flush=True)
    return report, seconds, launches


def recall_10m_check(device, args, workdir: Path, n_check: int = DRIVER_CHECK_Q,
                     timer=cuda_ms, max_drop: float = RECALL_10M_MAX_DROP) -> dict:
    """``scripts/recall_10m.py`` through the port's script: the corpus made
    on the device (``make_corpus``), the script's run with kernel 1's
    launches counted around exactly it, then on ``n_check`` of its queries
    kernel 1's window maxima and positions at window 512 against the twin's
    (row-chunked; :func:`window_agreement`), the body the run launched (the
    tensor cores, on the card), kernel 1's time at the script's batch and
    its bound; recall@k's mean no more than ``max_drop`` under the bin
    model's."""
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.scripts import recall_10m

    dev = torch.device(device)
    t0 = time.perf_counter()
    items = recall_10m.make_corpus(args.n, args.d, args.block, args.seed, dev)
    build_s = time.perf_counter() - t0
    mw.LAST_BODY["window_mips"] = None
    report, seconds, launches = _run_driver(
        "recall_10m", lambda: recall_10m.run(args, items), dev)
    recall_10m.write_report(report, args.out)
    body = mw.LAST_BODY["window_mips"]

    n, w = args.n, recall_10m.WINDOW
    q = recall_10m.make_queries(args.queries, args.d, dev)
    rec = {"n": n, "n_pad": items.shape[0], "d": args.d, "d_func": args.d,
           "window": w, "q": args.queries, "check_q": n_check, "body": body,
           "build_s": build_s, "seconds": seconds,
           "launches": launches["window_mips"],
           **kernel1_twin_check(q[:n_check], items, w, n)}
    with torch.no_grad():
        rec["kernel_ms"] = timer(lambda: mw.window_candidates(q, items, w, n), 5)
    rec["bound_ms"], rec["bound_by"] = window_bound(rec, 2, 4, "bf16")
    rec["recall_at_500"] = {key: report[f"kernel_recall_at_500_{key}"]
                            for key in ("mean", "min", "p10")}
    rec["bin_model_recall"] = report["bin_model_recall"]
    print(json.dumps({"recall_10m_check": rec}), flush=True)
    del items
    _check_agreement("recall_10m", rec)
    if dev.type == "cuda" and (body != "tensor_cores" or launches["window_mips"] < 1
                               or rec["check_body"] != "tensor_cores"):
        raise AssertionError(f"recall_10m missed kernel 1's tensor cores: {rec}")
    if rec["recall_at_500"]["mean"] < rec["bin_model_recall"] - max_drop:
        raise AssertionError(f"recall@500 at {n} rows more than {max_drop} under "
                             f"the bin model: {rec}")
    return rec


def _check_queries(n_check: int, d: int, device) -> torch.Tensor:
    """``n_check`` raw normal queries of the twin checks (``DRIVER_CHECK_SEED``)."""
    return torch.as_tensor(np.random.default_rng(DRIVER_CHECK_SEED).normal(
        size=(n_check, d)).astype(np.float32), device=device)


def mips_ab_check(device, args, n_check: int = DRIVER_CHECK_Q) -> dict:
    """``scripts/mips_ab.py`` through the port's script (kernel 1's launches
    counted around exactly its run), then kernel 1 over its f32 corpus (the
    CUDA-core body, on the card) and its bf16 one (the tensor cores), no
    mask, each against the twin on ``n_check`` queries."""
    from recommendit_tpu_torch.scripts import mips_ab

    dev = torch.device(device)
    data = mips_ab.make_corpus(args)
    report, seconds, launches = _run_driver("mips_ab", lambda: mips_ab.run(args, data), dev)
    mips_ab.write_report(report, args.out)
    items = torch.as_tensor(data[1], device=dev)
    del data
    q = _check_queries(n_check, args.d, dev)
    rec = {"seconds": seconds, "launches": launches["window_mips"], "check_q": n_check,
           "f32": kernel1_twin_check(q, items, args.window, args.n),
           "bf16": kernel1_twin_check(q, items.to(torch.bfloat16), args.window, args.n)}
    print(json.dumps({"mips_ab_check": rec}), flush=True)
    _check_agreement("mips_ab (f32 corpus)", rec["f32"])
    _check_agreement("mips_ab (bf16 corpus)", rec["bf16"])
    if dev.type == "cuda" and (rec["f32"]["check_body"] != "cuda_cores"
                               or rec["bf16"]["check_body"] != "tensor_cores"
                               or not launches["window_mips"]):
        raise AssertionError(f"mips_ab missed a body of kernel 1: {rec}")
    return rec


def fused_decomp_check(device, args, n_check: int = DRIVER_CHECK_Q,
                       window: int = FUSED_CHECK_WINDOW) -> dict:
    """``scripts/fused_decomp.py`` through the port's script (kernel 1's
    launches counted around exactly its run), then kernel 1 at ``window``
    over its decimal corpus, the padded tail masked (``--n-dec`` valid
    rows), against the twin on ``n_check`` queries (the tensor cores, on
    the card)."""
    from recommendit_tpu_torch.scripts import fused_decomp

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    items_dec, items_bin = fused_decomp.make_corpora(rng, args, dev)
    report, seconds, launches = _run_driver(
        "fused_decomp", lambda: fused_decomp.run(args, (rng, items_dec, items_bin)), dev)
    fused_decomp.write_report(report, args.out)
    del items_bin
    rec = {"seconds": seconds, "launches": launches["window_mips"], "report": report,
           "check_q": n_check, "window": window, "n_valid": args.n_dec,
           **kernel1_twin_check(_check_queries(n_check, args.d, dev), items_dec,
                                window, args.n_dec)}
    print(json.dumps({"fused_decomp_check": {k: v for k, v in rec.items()
                                             if k != "report"}}), flush=True)
    _check_agreement(f"fused_decomp (window {window}, masked)", rec)
    if dev.type == "cuda" and (rec["check_body"] != "tensor_cores"
                               or not launches["window_mips"]):
        raise AssertionError(f"fused_decomp missed kernel 1's tensor cores: {rec}")
    return rec


def drivers_phase(device, seed: int, workdir: Path, card: str, args=DRIVER_ARGS,
                  capacity=None, timer=cuda_ms) -> dict:
    """The seven retrieval drivers of ``recommendit_tpu_torch/scripts`` in one
    process, each corpus freed before the next: ``recall_10m`` (kernel 1 at
    window 512, :func:`recall_10m_check`), ``capacity_30m`` (kernel 3,
    :func:`capacity_phase`), ``mips_ab`` (kernel 1's f32 and bf16 bodies,
    :func:`mips_ab_check`), ``fused_decomp`` (kernel 1 at window 32, the
    tail masked, :func:`fused_decomp_check`), ``recall_curve``,
    ``bound_turf`` and ``tail_probe``, then the timer's own cost
    (:func:`timer_chain_cost`); ``args`` holds each driver's arguments. Each report and its seconds on
    lines of their own; kernel 1's and 3's launches by driver."""
    from recommendit_tpu_torch.scripts import (
        bound_turf,
        fused_decomp,
        mips_ab,
        recall_10m,
        recall_curve,
        tail_probe,
    )

    dev = torch.device(device)
    t0 = time.perf_counter()
    out = {"recall_10m": recall_10m_check(
        dev, _driver_args(recall_10m, "recall_10m", args["recall_10m"], dev, workdir),
        workdir, timer=timer)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["capacity_30m"] = capacity_phase(
        dev, seed, timer=timer, out=workdir / "drivers" / "capacity_30m.json",
        **(capacity or {}))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["mips_ab"] = mips_ab_check(
        dev, _driver_args(mips_ab, "mips_ab", args["mips_ab"], dev, workdir))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["fused_decomp"] = fused_decomp_check(
        dev, _driver_args(fused_decomp, "fused_decomp", args["fused_decomp"], dev,
                          workdir))
    for name, module in (("recall_curve", recall_curve), ("bound_turf", bound_turf),
                         ("tail_probe", tail_probe)):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        a = _driver_args(module, name, args[name], dev, workdir)
        report, seconds, launches = _run_driver(name, lambda: module.run(a), dev)
        module.write_report(report, a.out)
        out[name] = {"seconds": seconds, "launches": launches["window_mips"],
                     "report": report}
    out["timer_chain"] = timer_chain_cost(dev)
    out["launches"] = {"window_mips": {name: out[name]["launches"] for name in
                                       ("recall_10m", "mips_ab", "fused_decomp")},
                       "window_mips_i8": {"capacity_30m": out["capacity_30m"]["launches"]}}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"drivers": {"seconds": out["seconds"],
                                  "launches": out["launches"], "card": card}}), flush=True)
    return out


def bpr_bounds(b: int, d: int):
    """{"fwd": (bound_ms, bound_by), "bwd": ...} of the BPR kernels at (B,
    D) f32, counting only the products (forward: the B×B scores; backward:
    those, W·V and Wᵀ·U) at the f32 peak; with ``_3xtf32`` beside them: the
    same products three times (the 3xTF32 split) at the TF32 peak."""
    out = {}
    for name, n_bytes, ops in (("fwd", 2 * b * d * 4 + 4, 2.0 * b * b * d),
                               ("bwd", 4 * b * d * 4 + 4, 6.0 * b * b * d)):
        out[name] = bound(n_bytes, ops, "f32")
        out[f"{name}_3xtf32"] = bound(n_bytes, 3 * ops, "tf32")
    return out


def bpr_device_ms(name: str, fn, keep=None) -> dict:
    """``{name}_device_ms``: the device time per call of ``fn()`` in the
    kernels ``keep`` accepts, by ``torch.profiler`` (``_device_kernels_ms``
    by kernel); by CUDA events where no profiler session recorded them
    (``_device_ms_by`` says which)."""
    kernels = device_kernel_ms(fn, 50, keep)
    return {f"{name}_device_kernels_ms": kernels,
            f"{name}_device_ms_by": "profiler" if kernels else "events",
            f"{name}_device_ms": sum(kernels.values()) if kernels else cuda_ms(fn, 50)}


def bpr_pair_check(u: torch.Tensor, v: torch.Tensor, timer=cuda_ms) -> dict:
    """Kernels 5 and 6 (``bpr_forward``, ``bpr_backward``) against their
    twins on (B, D) rows ``u``, ``v``: the loss's relative error, each
    gradient's largest error over the twin's largest, a second call
    bit-identical to the first; the time of each and of its twin by
    ``timer`` over 50 calls (None without one)."""
    from recommendit_tpu_torch.ops import bpr

    g = torch.tensor(1.0, device=u.device)
    loss = bpr.bpr_forward(u, v)
    ref = bpr.in_batch_bpr_loss_ref(u, v)
    du, dv = bpr.bpr_backward(u, v, g)
    rdu, rdv = bpr._bpr_bwd_ref(u, v, g)
    again = (bpr.bpr_forward(u, v), *bpr.bpr_backward(u, v, g))
    rec = {
        "b": u.shape[0], "d": u.shape[1], "loss": float(loss), "twin_loss": float(ref),
        "loss_rel_err": abs(float(loss) - float(ref)) / abs(float(ref)),
        "du_err": float((du - rdu).abs().max() / rdu.abs().max()),
        "dv_err": float((dv - rdv).abs().max() / rdv.abs().max()),
        "grad_max_abs_err": float(max((du - rdu).abs().max(),
                                      (dv - rdv).abs().max())),
        "repeat_bit_identical": all(torch.equal(x, y) for x, y in
                                    zip((loss, du, dv), again)),
    }
    calls = {"fwd": lambda: bpr.bpr_forward(u, v),
             "twin_fwd": lambda: bpr.in_batch_bpr_loss_ref(u, v),
             "bwd": lambda: bpr.bpr_backward(u, v, g),
             "twin_bwd": lambda: bpr._bpr_bwd_ref(u, v, g)}
    for name, fn in calls.items():
        rec[f"{name}_ms"] = timer(fn, 50) if timer else None
    return rec


def check_bpr_pair(rec: dict) -> None:
    """The BPR phase's tolerances: the loss within 1e-5 of the twin's,
    relative; each gradient within 1e-4 of the twin's largest; two calls
    bit-identical."""
    if not rec["loss_rel_err"] <= 1e-5:
        raise AssertionError(f"BPR loss differs from the twin: {rec}")
    if not max(rec["du_err"], rec["dv_err"]) <= 1e-4:
        raise AssertionError(f"BPR gradients differ from the twin: {rec}")
    if not rec["repeat_bit_identical"]:
        raise AssertionError(f"BPR kernels differ between two calls: {rec}")


def bpr_kernel_phase(device, seed: int, shapes=BPR_SHAPES, timer=cuda_ms):
    """The BPR forward and backward (kernels on the card) against their
    twins on seeded unit rows, a second call equal to the first bit for
    bit (:func:`bpr_pair_check`); the times of both and of ``u @ v.T``
    alone (``gemm_only_ms``, full f32), the bounds and the bpr library's
    ptxas report. Returns one record per (B, D)."""
    from recommendit_tpu_torch.ops import _build, bpr
    from recommendit_tpu_torch.ops.topk import full_f32_matmul

    if torch.device(device).type == "cuda":
        print(json.dumps({"ptxas_bpr": ptxas_summary(
            _build.ptxas_logs.get("bpr", ""))}), flush=True)
    gen = torch.Generator().manual_seed(seed + 2)
    out = []
    for b, d in shapes:
        u, v = (torch.nn.functional.normalize(torch.randn(b, d, generator=gen),
                                              dim=1).to(device) for _ in "uv")
        g = torch.tensor(1.0, device=device)
        rec = bpr_pair_check(u, v, timer)
        with full_f32_matmul():
            rec["gemm_only_ms"] = timer(lambda: u @ v.T, 50)
        for name, (ms, by) in bpr_bounds(b, d).items():
            rec[f"bound_{name}_ms"] = ms
            rec[f"bound_{name}_by"] = by
        if torch.device(device).type == "cuda":
            # by events a call is bound by its host side; the device's own time
            calls = {"fwd": lambda: bpr.bpr_forward(u, v),
                     "bwd": lambda: bpr.bpr_backward(u, v, g),
                     "twin_fwd": lambda: bpr.in_batch_bpr_loss_ref(u, v),
                     "twin_bwd": lambda: bpr._bpr_bwd_ref(u, v, g)}
            for name, fn in calls.items():
                # the wrapper's loss mean is no part of the kernel's time
                rec.update(bpr_device_ms(name, fn, None if name.startswith("twin")
                                         else lambda k: "bpr_" in k))
            with full_f32_matmul():
                rec.update(bpr_device_ms("gemm_only", lambda: u @ v.T))
            rec["fwd_device_bound_share"] = rec["bound_fwd_ms"] / rec["fwd_device_ms"]
            rec["bwd_device_bound_share"] = rec["bound_bwd_ms"] / rec["bwd_device_ms"]
        rec["fwd_bound_share"] = rec["bound_fwd_ms"] / rec["fwd_ms"]
        rec["bwd_bound_share"] = rec["bound_bwd_ms"] / rec["bwd_ms"]
        rec["two_tower"] = two_tower_bpr_check(u, v, device)
        print(json.dumps({"bpr_check": rec}), flush=True)
        check_bpr_pair(rec)
        out.append(rec)
    return out


def host_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean host-clock time of ``fn()`` in ms after warm-up: the timer
    where there are no CUDA events (the CPU)."""
    for _ in range(warm):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def bpr_kernel_rank(device_type: str, seed: int, shapes) -> list:
    """The rank of the BPR phase (a fresh process of its own):
    :func:`bpr_kernel_phase` on this rank's device, timed by CUDA events on
    the card and by the host clock on the CPU."""
    from recommendit_tpu_torch.ops import _build

    on_card = device_type == "cuda"
    if on_card:
        _build.load_library("bpr")     # built by the parent: its ptxas report
    return bpr_kernel_phase(torch.device(device_type), seed, shapes,
                            timer=cuda_ms if on_card else host_ms)


def bpr_phase(device, seed: int, card: str, shapes=BPR_SHAPES,
              timeout: float = BPR_TIMEOUT_S) -> list:
    """:func:`bpr_kernel_phase` in a fresh process
    (``parallel/launch.spawn``, one rank): late in a long process every
    ``torch.profiler`` session of it lost its first 10–14 launches, where
    in a fresh one every session is whole (ROADMAP B.17), so the kernels'
    own device times are read there. Its checks and records unchanged."""
    from recommendit_tpu_torch.parallel.launch import spawn

    dev = torch.device(device).type
    t0 = time.perf_counter()
    recs = spawn(bpr_kernel_rank, 1, (dev, seed, shapes), device=dev,
                 timeout=timeout)[0]
    print(json.dumps({"bpr_phase_s": time.perf_counter() - t0, "card": card}),
          flush=True)
    return recs


def two_tower_bpr_check(u: torch.Tensor, v: torch.Tensor, device) -> dict:
    """``TwoTower.in_batch_bpr_loss`` (the model's loss surface) forward and
    backward on (B, D) rows, with the BPR wrappers' counts set to 0 just
    before and read just after (one launch of each kernel on the card),
    against ``in_batch_bpr_loss_ref`` and its twin backward at the phase's
    tolerances (loss 1e-5 relative, gradients 1e-4 of the twin's largest)."""
    from recommendit_tpu_torch.models.two_tower import TwoTower
    from recommendit_tpu_torch.ops import bpr

    ut, vt = (x.detach().clone().requires_grad_(True) for x in (u, v))
    _reset(bpr.LAUNCHES)
    loss = TwoTower.in_batch_bpr_loss(ut, vt)
    loss.backward()
    launches = dict(bpr.LAUNCHES)
    ref = bpr.in_batch_bpr_loss_ref(u, v)
    rdu, rdv = bpr._bpr_bwd_ref(u, v, torch.tensor(1.0, device=u.device))
    rec = {"launches": launches,
           "loss_rel_err": abs(float(loss.detach()) - float(ref)) / abs(float(ref)),
           "du_err": float((ut.grad - rdu).abs().max() / rdu.abs().max()),
           "dv_err": float((vt.grad - rdv).abs().max() / rdv.abs().max())}
    once = 1 if torch.device(device).type == "cuda" else 0
    if launches != {"bpr_fwd": once, "bpr_bwd": once}:
        raise AssertionError(f"TwoTower.in_batch_bpr_loss launched {launches}, "
                             f"expected each BPR kernel {once} time(s)")
    if not (rec["loss_rel_err"] <= 1e-5 and max(rec["du_err"], rec["dv_err"]) <= 1e-4):
        raise AssertionError(f"TwoTower.in_batch_bpr_loss differs from the twin: {rec}")
    return rec


def bound(n_bytes: float, ops: float = 0.0, kind: str = "f32"):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``n_bytes`` over the HBM rate and ``ops`` over the peak rate of
    their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_time_bounds(kern: dict):
    """(time key, bound key) of each kernel time of a kernels-line entry:
    ``ms`` and each ``ms_<shape>`` against ``bound_ms`` and
    ``bound_ms_<shape>``, each ``<path>_ms`` against ``<path>_bound_ms``
    (plain, library and bound times are not the kernel's)."""
    for key in kern:
        if key == "ms" or key.startswith("ms_"):
            yield key, "bound_" + key
        elif (key.endswith("_ms") and not key.endswith("_bound_ms")
              and not key.startswith(("plain_", "library_", "bound_"))):
            yield key, key[:-len("ms")] + "bound_ms"


def check_kernel_times(kernels) -> None:
    """Refuse a kernels line that prints a time no card can give: every
    kernel time has its bound, and none is under it."""
    bad = []
    for kern in kernels:
        for t, b in kernel_time_bounds(kern):
            if b not in kern:
                bad.append(f"{kern['name']}.{t}: no {b}")
            elif not kern[t] >= kern[b]:
                bad.append(f"{kern['name']}.{t} = {kern[t]} ms, under its bound "
                           f"{b} = {kern[b]} ms")
    if bad:
        raise AssertionError("kernels line: " + "; ".join(bad))


def fold_bounds(rec):
    """(bound_ms, bound_by, bound_f32_ms) of a fold call: the valid bf16
    corpus rows, the f32 queries and the (Q, n_cand) values and ids moved
    once, against
    the operations f32-grade scores take on the tensor cores — three bf16
    passes of 2·Q·N·D — and, beside it, against 2·Q·N·D f32 operations at
    the f32 rate (the CUDA-core body's bound). D is the function's width."""
    q, n, d = rec["q"], rec["n"], rec["d_func"]
    n_bytes = n * d * 2 + q * d * 4 + rec["n_cand"] * q * 8
    return (*bound(n_bytes, 3 * 2.0 * q * n * d, "bf16"),
            bound(n_bytes, 2.0 * q * n * d, "f32")[0])


def window_bound(rec, corpus_bytes: int, query_bytes: int, kind: str,
                 scales: bool = False):
    """Bound of a window kernel call: the valid corpus rows (and their
    scales), the queries and the (n_cand, Q) values and positions moved
    once; 2·Q·N·D multiply-adds of ``kind``. D is the function's width
    (``d_func``: the embedding and the bias column), not the device rows'
    zero-padded one."""
    q, n, d = rec["q"], rec["n"], rec["d_func"]
    n_cand = -(-n // rec["window"])
    n_bytes = (n * d * corpus_bytes + q * d * query_bytes + n_cand * q * 8
               + (4 * n if scales else 0))
    return bound(n_bytes, 2.0 * q * n * d, kind)


def make_train_data(seed: int, n_users: int = TRAIN_USERS,
                    n_items: int = TRAIN_ITEMS, n_ratings: int = N_RATINGS):
    """Synthetic ML-1M-shaped data and its temporal train view."""
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens

    data = make_synthetic_movielens(n_users, n_items, n_ratings, seed=seed)
    return data, data.train_view(TRAIN_SPLIT)


def _train_cfg(seed: int, loss_mode: str, dim: int, hidden: int, batch: int):
    from recommendit_tpu_torch.config import Settings

    return Settings(LOSS_MODE=loss_mode, EMBEDDING_DIM=dim, HIDDEN_DIM=hidden,
                    BATCH_SIZE=batch, DROPOUT=TRAIN_DROPOUT, USE_PALLAS=True,
                    SEED=seed, INDEX_MODE="exact", INDEX_DTYPE="float32")


def train_phase(view, device, seed: int, workdir: Path, epochs: int = TRAIN_EPOCHS,
                dim: int = TRAIN_DIM, hidden: int = TRAIN_HIDDEN,
                batch: int = TRAIN_BATCH):
    """In-batch BPR training (the main path), with the kernel launch counts
    read around exactly that run — one forward and one backward launch per
    step on the card, none on the CPU (the twins) — then one softmax epoch.
    Returns the in-batch model and the measurements."""
    from recommendit_tpu_torch.ops import bpr
    from recommendit_tpu_torch.training import EmbeddingTrainer

    workdir.mkdir(parents=True, exist_ok=True)
    trainer = EmbeddingTrainer(view, _train_cfg(seed, "in_batch", dim, hidden,
                                                batch),
                               model_output_path=str(workdir / "two_tower_bpr.npz"),
                               device=device)
    for name in bpr.LAUNCHES:
        bpr.LAUNCHES[name] = 0
    model = trainer.train(epochs=epochs)
    launches = dict(bpr.LAUNCHES)
    hist = trainer.history
    steps = sum(h["steps"] for h in hist)
    losses = [h["loss"] for h in hist]
    rec = {
        "positives": len(trainer.pos_users), "steps": steps,
        "losses": losses, "seconds": [h["seconds"] for h in hist],
        "examples_per_s": [h["examples_per_s"] for h in hist],
        "ms_per_step": [1e3 * h["seconds"] / h["steps"] for h in hist],
        "launches": launches,
    }
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not losses[-1] < np.log(2.0):
        raise AssertionError(f"the loss {losses[-1]} is not below ln 2")
    per_step = steps if torch.device(device).type == "cuda" else 0
    if launches != {"bpr_fwd": per_step, "bpr_bwd": per_step}:
        raise AssertionError(
            f"expected {per_step} forward and backward launches ({steps} "
            f"steps), got {launches}")

    soft = EmbeddingTrainer(view, _train_cfg(seed, "softmax", dim, hidden, batch),
                            model_output_path="", device=device)
    soft.train(epochs=1)
    rec["softmax_loss"] = soft.history[0]["loss"]
    rec["softmax_examples_per_s"] = soft.history[0]["examples_per_s"]
    rec["softmax_launches"] = dict(bpr.LAUNCHES)
    if not np.isfinite(rec["softmax_loss"]):
        raise AssertionError(f"non-finite softmax loss: {rec['softmax_loss']}")
    if rec["softmax_launches"] != launches:
        raise AssertionError("the softmax epoch launched a BPR kernel")
    return model, rec


TRAIN_KERNEL_GROUPS = (("bpr_", "BPR kernels"), ("foreach", "clipping and optimizer"),
                       ("multi_tensor", "clipping and optimizer"), ("gemm", "GEMMs"),
                       ("reduce_kernel", "reductions"), ("index", "gathers and index backward"),
                       ("gather", "gathers and index backward"),
                       ("scatter", "gathers and index backward"))


def _train_kernel_group(name: str) -> str:
    """The part of a training step a device kernel belongs to, by its name."""
    return next((g for key, g in TRAIN_KERNEL_GROUPS if key in name), "elementwise")


def profile_view(view, steps: int, batch: int):
    """The earliest temporal slice of ``view`` whose positives (rating >= 4)
    fill about ``steps`` batches of ``batch``."""
    n_pos = int((view.rating >= 4).sum())
    return view.train_view(min(1.0, (steps + 0.5) * batch / n_pos))


def train_profile_phase(view, device, seed: int, steps: int = PROFILE_STEPS,
                        dim: int = TRAIN_DIM, hidden: int = TRAIN_HIDDEN,
                        batch: int = TRAIN_BATCH):
    """``torch.profiler`` over one in-batch BPR epoch of about ``steps``
    steps (``profile_view``), once with the kernels and once with the twins
    (``USE_PALLAS`` off): device µs per step by kernel group and in all, the
    host clock per step and the share of it the device is idle. The epoch's
    close (the loss read-back, the catalog embedding of the returned model)
    is inside the window. On the card only."""
    from recommendit_tpu_torch.training import EmbeddingTrainer

    small = profile_view(view, steps, batch)
    rec = {}
    for mode, use_kernel in (("kernels", True), ("twins", False)):
        cfg = _train_cfg(seed, "in_batch", dim, hidden, batch)
        cfg = cfg.replace(USE_PALLAS=use_kernel)

        def body(trainer):
            trainer.train(epochs=1)
            return trainer

        prof, trainer = profiled(body, setup=lambda: EmbeddingTrainer(
            small, cfg, model_output_path="", device=device))
        hist = trainer.history[0]
        n = hist["steps"]
        groups, bpr_kernels, launches = {}, {}, 0
        for key, dev_us, count in device_events(prof):
            group = _train_kernel_group(key)
            groups[group] = groups.get(group, 0.0) + dev_us / n
            if group == "BPR kernels":
                name = _short_kernel_name(key)
                bpr_kernels[name] = bpr_kernels.get(name, 0.0) + dev_us / n
            launches += count
        device_us = sum(groups.values())
        host_ms = 1e3 * hist["seconds"] / n
        rec[mode] = {"steps": n, "device_us_per_step": device_us,
                     "host_ms_per_step": host_ms,
                     "device_idle_share": 1 - device_us / 1e3 / host_ms,
                     "kernel_launches_per_step": launches / n,
                     "groups_us_per_step": dict(sorted(groups.items(),
                                                       key=lambda kv: -kv[1])),
                     "bpr_us_per_step": bpr_kernels}
        if device_us <= 0:
            raise AssertionError(f"the profiler saw no device time: {rec}")
    print(json.dumps({"train_profile": rec}), flush=True)
    if "BPR kernels" not in rec["kernels"]["groups_us_per_step"]:
        raise AssertionError(f"the profiled epoch ran no BPR kernel: {rec}")
    return rec


def index_phase(model, data, view, device, seed: int, workdir: Path,
                n_users: int = INDEX_USERS, k: int = RECALL_K):
    """Build the exact f32 index from the trained towers and search it for
    users with held-out positives: Recall@k of those positives, the items
    each user rated in the train view filtered out, against a random
    ranking of the same unrated items."""
    from recommendit_tpu_torch.training import IndexBuilder

    cfg = _train_cfg(seed, "in_batch", model.embed_dim, model.hidden_dim, 0)
    index = IndexBuilder(view, cfg, index_output_path=str(workdir / "bpr.index.npz"),
                         device=device).build(model=model)
    return recall_check(index, model, data, view, device, seed, n_users, k)


def recall_check(index, model, data, view, device, seed: int,
                 n_users: int = INDEX_USERS, k: int = RECALL_K):
    """``batch_search`` of ``index`` over the whole catalog for users with
    held-out positives: valid ids, every item once, and Recall@k of the
    held-out positives (the train view's items filtered) above a seeded
    random ranking's."""
    from recommendit_tpu_torch.data.movielens import timestamp_order

    n_items = model.n_items
    seen = np.zeros((model.n_users + 1, n_items + 1), dtype=bool)
    seen[view.user_id, view.item_id] = True
    # held out: the positives past the train view's timestamp cut
    rows = timestamp_order(data.timestamp)[len(view):]
    rows = rows[data.rating[rows] >= 4]
    held = np.zeros_like(seen)
    held[data.user_id[rows], data.item_id[rows]] = True
    held &= ~seen
    cand = np.flatnonzero(held.any(axis=1))
    users = np.random.default_rng(seed + 3).choice(
        cand, size=min(n_users, len(cand)), replace=False)

    q = model.user_tower(torch.as_tensor(users, device=device)).cpu().numpy()
    scores, ids = index.batch_search(q, k=n_items)
    if ids.shape != (len(users), n_items):
        raise AssertionError(f"batch_search returned {ids.shape}")
    if ids.min() < 1 or ids.max() > n_items or not np.isfinite(scores).all():
        raise AssertionError("batch_search returned an invalid id or score")
    if not (np.sort(ids, axis=1) == np.arange(1, n_items + 1)).all():
        raise AssertionError("a full-catalog search repeated or lost an item")

    def recall(ranked):
        unseen = ~seen[users[:, None], ranked]
        top = unseen & (np.cumsum(unseen, axis=1) <= k)
        hits = (held[users[:, None], ranked] & top).sum(axis=1)
        return float(np.mean(hits / held[users].sum(axis=1)))

    rnd = np.argsort(np.random.default_rng(seed + 4).random(ids.shape), axis=1) + 1
    rec = {"users": len(users), "index_items": index.n_total,
           "index_has_bias": index.has_bias,
           f"recall@{k}": recall(ids), f"random_recall@{k}": recall(rnd)}
    if not rec[f"recall@{k}"] > rec[f"random_recall@{k}"]:
        raise AssertionError(f"retrieval does not beat a random ranking: {rec}")
    return rec


def host_table_phase(device, seed: int, workdir: Path, card: str,
                     args=HOST_SCALE_ARGS):
    """Host-table training at the ml25m configuration through
    ``scripts/host_table_scale.py`` (``--mode host``, then ``--mode hbm``
    on the same stream): the BPR kernels counted around exactly each run —
    one forward and one backward launch a step on the card — the losses
    finite and falling, examples/s and the host-clock parts of a step; then
    the catalog streamed through the item head as the index stage streams
    it, equal to ``to_model()``'s within ``HOST_CATALOG_TOL``, and an exact
    index built from it (``IndexBuilder.build(embeddings=…)``)."""
    from recommendit_tpu_torch.ops import bpr
    from recommendit_tpu_torch.scripts import host_table_scale as hts
    from recommendit_tpu_torch.training import IndexBuilder

    base = [*args, "--seed", str(seed), "--device", str(device)]
    on_card = torch.device(device).type == "cuda"
    rec = {}
    for mode in ("host", "hbm"):
        for name in bpr.LAUNCHES:
            bpr.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        out, trainers = hts.run(hts.parse_args([*base, "--mode", mode]))
        seconds = time.perf_counter() - t0
        launches = dict(bpr.LAUNCHES)
        hist = out[f"{mode}_history"]
        steps = sum(h["steps"] for h in hist)
        losses = [h["loss"] for h in hist]
        rec[mode] = {"seconds": seconds, "steps": steps, "losses": losses,
                     "examples_per_s": [h["examples_per_s"] for h in hist],
                     "steady_examples_per_s": out[f"{mode}_ex_per_s"],
                     "launches": launches}
        if mode == "host":
            rec.update({k: out[k] for k in ("config", "table_gib", "batch", "dim")})
            rec["host"]["parts_ms_per_step"] = [
                {k: 1e3 * v / h["steps"] for k, v in h["parts_s"].items()} for h in hist]
            tr = trainers["host"]
            rec["tables"] = {"users": tr.n_users, "items": tr.n_items,
                             "positives": len(tr.pos_users),
                             "host_mb": (tr.user_table.table.nbytes
                                         + tr.item_table.table.nbytes) / 1e6}
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{mode} losses {losses}: not finite or not falling")
        per_step = steps if on_card else 0
        if launches != {"bpr_fwd": per_step, "bpr_bwd": per_step}:
            raise AssertionError(f"{mode}: expected {per_step} launches of each BPR "
                                 f"kernel ({steps} steps), got {launches}")
        if mode == "host":
            t0 = time.perf_counter()
            model = tr.to_model()
            streamed = tr.embed_catalog()
            rec["catalog_s"] = time.perf_counter() - t0
            err = float(np.abs(streamed - model._item_embeddings).max())
            index = IndexBuilder(tr.data, tr.cfg.replace(INDEX_MODE="exact",
                                                         INDEX_DTYPE="float32"),
                                 index_output_path=str(workdir / "host_ml25m.index.npz"),
                                 device=device).build(embeddings=streamed)
            rec["catalog_max_abs_err"] = err
            rec["index_items"] = index.n_total
            if not err <= HOST_CATALOG_TOL:
                raise AssertionError(f"the streamed catalog differs from to_model()'s "
                                     f"by {err} (> {HOST_CATALOG_TOL})")
            if index.n_total != tr.n_items or index.has_bias:
                raise AssertionError(f"the streamed index: {index.n_total} items, "
                                     f"bias {index.has_bias}")
            del model, streamed, index
        del trainers
        torch.cuda.empty_cache()
    print(json.dumps({"host_table": rec, "card": card}), flush=True)
    h, m = rec["host"], rec["hbm"]
    print(f"host-table ml25m ({card}): host {h['steady_examples_per_s']} ex/s, "
          f"hbm {m['steady_examples_per_s']} ex/s; host losses {h['losses']}; "
          f"ms a step (last epoch): " + ", ".join(
              f"{k} {v:.3f}" for k, v in h["parts_ms_per_step"][-1].items())
          + f"; BPR launches {h['launches']}", flush=True)
    return rec


def host_pipeline_phase(data, device, seed: int, workdir: Path, card: str,
                        epochs: int = HOST_PIPELINE_EPOCHS, dim: int = TRAIN_DIM,
                        hidden: int = TRAIN_HIDDEN, batch: int = TRAIN_BATCH):
    """``--stage embeddings`` and ``--stage index`` with ``HOST_TABLE=True``
    on the pipeline phase's ML-1M ``.dat`` files (Settings defaults but
    ``LOSS_MODE=in_batch``, the train cell's widths, ``epochs``): one launch
    of each BPR kernel a step, the model and the index written, and
    Recall@20 of the index above a random ranking's."""
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import bpr
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator

    root = workdir / "pipeline"
    cfg = Settings(LOSS_MODE="in_batch", TRAIN_EPOCHS=epochs, SEED=seed,
                   EMBEDDING_DIM=dim, HIDDEN_DIM=hidden, BATCH_SIZE=batch,
                   HOST_TABLE=True)
    orch = PipelineOrchestrator(cfg=cfg, data_dir=str(root / "ml-1m"),
                                models_dir=str(root / "models_host"),
                                features_dir=str(root / "features"), device=device)
    for name in bpr.LAUNCHES:
        bpr.LAUNCHES[name] = 0
    hist = orch.run_stage("embeddings")
    orch.run_stage("index")
    launches = dict(bpr.LAUNCHES)
    steps = sum(h["steps"] for h in hist)
    per_step = steps if torch.device(device).type == "cuda" else 0
    if launches != {"bpr_fwd": per_step, "bpr_bwd": per_step}:
        raise AssertionError(f"host-table embeddings: expected {per_step} launches "
                             f"of each BPR kernel, got {launches}")
    losses = [h["loss"] for h in hist]
    if not np.isfinite(losses).all():
        raise AssertionError(f"host-table pipeline losses {losses}")
    model = TwoTower.load(orch.cfg.EMBEDDING_MODEL_PATH, device=device)
    index = MIPSIndex.load(orch.cfg.INDEX_PATH, device=device)
    if index.n_total != model.n_items:
        raise AssertionError(f"the index holds {index.n_total} items, the model "
                             f"{model.n_items}")
    rec = {"stage_s": dict(orch.stage_times), "steps": steps, "losses": losses,
           "launches": launches, "parts_s": [h["parts_s"] for h in hist],
           "examples_per_s": [h["examples_per_s"] for h in hist],
           **recall_check(index, model, data, orch._train_view(), device, seed)}
    print(json.dumps({"host_pipeline": rec, "card": card}), flush=True)
    return rec


def _ctr_profile_groups(prof):
    """Device µs of a profiled CTR run by part of the step: the kernels
    launched in each outermost ``ctr::`` range of the port's step (gather,
    towers, mlp, interaction, softmax, loss, adamw, sparse_update) and by
    the autograd engine's functions (backward); the ranges' own spans on
    the device (user annotations, which include the gaps between their
    kernels) are left out."""
    def kernel_us(evt):        # the kernels it and its children launched
        return (sum(k.duration for k in evt.kernels if not k.name.startswith("ctr::"))
                + sum(kernel_us(child) for child in evt.cpu_children))

    groups = {}
    for evt in prof.events():
        name = evt.name
        if name.startswith("ctr::"):
            parent = evt.cpu_parent
            while parent is not None and not parent.name.startswith("ctr::"):
                parent = parent.cpu_parent
            if parent is not None:
                continue
            group = name[len("ctr::"):]
        elif name.startswith("autograd::engine::evaluate_function") and evt.cpu_parent is None:
            group = "backward"
        else:
            continue
        groups[group] = groups.get(group, 0.0) + kernel_us(evt)
    return groups


def _ctr_steps(data, cfg, device, init, seed: int, steps: int, profile: bool = False):
    """``steps`` joint steps of the port's trainer (``cfg``'s table mode)
    from ``init`` over the epoch batches of ``np.random.default_rng(seed)``:
    the final state, the losses and, with ``profile``, the profiler and the
    host seconds."""
    from torch.profiler import ProfilerActivity, profile as profiler

    from recommendit_tpu_torch.training.train_ctr import CTRTrainer

    tr = CTRTrainer(data, cfg=cfg, joint=True, device=device)
    state = tr.start(init)
    batches = tr.epoch_batches(np.random.default_rng(seed), tr.batch_size())
    decay = cfg.CTR_EPOCHS * batches[0].shape[0]
    on_card = torch.device(device).type == "cuda"
    prof, seconds = None, None
    if profile:
        for s in range(2):                 # warm-up steps outside the window
            tr.step(state, [b[s] for b in batches], decay)
        if on_card:
            torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profiler(activities=acts) as prof:
            t0 = time.perf_counter()
            losses = [tr.step(state, [b[2 + s] for b in batches], decay)
                      for s in range(steps)]
            if on_card:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    else:
        losses = [tr.step(state, [b[s] for b in batches], decay) for s in range(steps)]
    return state, torch.stack(losses).cpu().numpy(), prof, seconds


def ctr_card_vs_cpu(data, cfg, device, seed: int, steps: int):
    """``steps`` joint steps of the port's trainer on ``device`` and on the
    CPU from the same params (``init_ctr_params`` from ``seed``) and
    batches, then each param, the table and the accumulator compared.

    The step is not smooth and not well conditioned entry by entry: a
    pre-activation within rounding of 0 takes the other side of a ReLU on
    the other device, which moves that example's gradient by a step, and
    AdamW and adagrad divide by the gradient's own size, so an entry whose
    gradient is small or cancelling turns a small difference into a visible
    share of its move (ROADMAP C.53). A tolerance on every entry either
    fails or says nothing. So the bound is on each tensor as a whole: the
    L2 distance between the card's and the CPU's values within
    ``CTR_REL_L2`` of the L2 length of the CPU's move from ``init`` (of the
    accumulator's values, for the accumulator), and the losses within
    ``CTR_LOSS_RTOL``; a fault of a kernel or of the update's semantics
    moves a whole tensor by about its move. Entries beyond
    ``CTR_TIGHT_TOL`` are counted. Raises otherwise."""
    from recommendit_tpu_torch.models.ctr import init_ctr_params

    init = init_ctr_params(torch.Generator().manual_seed(seed), data.vocab_sizes,
                           cfg.CTR_EMBED_DIM, top_hidden=cfg.CTR_TOP_HIDDEN,
                           retrieval_dim=cfg.CTR_RETRIEVAL_DIM, device="cpu")
    (card, card_losses, _, _), (cpu, cpu_losses, _, _) = (
        _ctr_steps(data, cfg, dev, init, seed, steps) for dev in (device, "cpu"))
    pairs = {k: (card.params[k].detach().cpu(), v.detach(), init[k])
             for k, v in cpu.params.items()}
    if cpu.accum is not None:
        pairs["accum"] = (card.accum.cpu(), cpu.accum, torch.zeros_like(cpu.accum))
    rec = {"steps": steps, "mode": cfg.CTR_TABLE_UPDATE, "losses": card_losses.tolist(),
           "cpu_losses": cpu_losses.tolist(), "tensors": {}}
    bad = []
    for name, (got, want, start) in pairs.items():
        err = (got - want).abs()
        rel_l2 = float(torch.linalg.vector_norm(err)
                       / torch.linalg.vector_norm(want - start))
        rec["tensors"][name] = {"rel_l2": rel_l2, "max_abs_err": float(err.max()),
                                "max_move": float((want - start).abs().max()),
                                "entries": err.numel(),
                                "beyond_tight": int((err > CTR_TIGHT_TOL).sum())}
        if not rel_l2 <= CTR_REL_L2:
            bad.append(name)
    loss_err = float(np.max(np.abs(card_losses / cpu_losses - 1)))
    rec["loss_max_rel_err"] = loss_err
    if bad or not loss_err <= CTR_LOSS_RTOL:
        raise AssertionError(f"ctr: {steps} steps on {device} against the CPU, "
                             f"{bad or 'losses'} outside the bound: {rec}")
    return rec


def ctr_phase(device, seed: int, card: str, train_args=CTR_TRAIN_ARGS,
              scale_data=CTR_SCALE_DATA, scale_dim: int = CTR_SCALE_DIM,
              scale_batch: int = CTR_SCALE_BATCH, check_steps: int = CTR_CHECK_STEPS,
              profile_steps: int = CTR_PROFILE_STEPS):
    """The CTR family (``make ctr``) through the port's ``ctr_train`` code:
    (a) train and evaluate, joint and plain: the losses finite and falling,
    AUC above ``CTR_MIN_AUC``, logloss below the train CTR's constant
    predictor's + ``CTR_LOGLOSS_SLACK``, joint recall@10 and @50 above a
    seeded random ranking's (the true item's place drawn uniformly);
    examples/s per epoch and ms a step. (b) ``check_steps`` sparse joint
    steps on ``device`` and on the CPU from the same params and batches:
    every param, the table and the accumulator within the bound of
    ``ctr_card_vs_cpu``. (c) ``torch.profiler`` over
    ``profile_steps`` sparse joint steps: launches and device µs a step by
    part (``_ctr_profile_groups``), the device's idle share. (d) one epoch
    in each table mode at ``scale_data`` with embed ``scale_dim`` and batch
    ``scale_batch`` (joint): ms a step, examples/s, peak device memory."""
    from recommendit_tpu_torch.config import settings
    from recommendit_tpu_torch.data.ctr import make_ctr_dataset
    from recommendit_tpu_torch.evaluation.metrics import binary_logloss
    from recommendit_tpu_torch.scripts import ctr_train
    from recommendit_tpu_torch.training.train_ctr import CTRTrainer

    on_card = torch.device(device).type == "cuda"
    args = ctr_train.parse_args([*train_args, "--seed", str(seed), "--device", str(device)])
    t0 = time.perf_counter()
    data = make_ctr_dataset(n_examples=args.examples, n_users=args.users,
                            n_items=args.items, seed=args.seed)
    rec = {"data_s": time.perf_counter() - t0, "examples": args.examples,
           "users": args.users, "items": args.items,
           "table_rows": int(sum(data.vocab_sizes)), "batch": args.batch_size}

    # (a) make ctr, joint and plain
    for joint in (True, False):
        args.no_joint = not joint
        report, tr = ctr_train.run(args, data=data)
        hist = tr.history
        n_batches = len(tr.train_data.labels) // tr.batch_size()
        losses = [h["loss"] for h in hist]
        const = binary_logloss(tr.test_data.labels, np.full_like(
            tr.test_data.labels, tr.train_data.labels.mean()))
        out = {"report": report, "losses": losses, "steps_per_epoch": n_batches,
               "examples_per_s": [h["examples_per_s"] for h in hist],
               "ms_per_step": [1e3 * h["seconds"] / n_batches for h in hist],
               "constant_logloss": const}
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"ctr joint={joint}: losses {losses}")
        if not report["auc"] > CTR_MIN_AUC:
            raise AssertionError(f"ctr joint={joint}: AUC {report['auc']}")
        if not report["logloss"] < const + CTR_LOGLOSS_SLACK:
            raise AssertionError(f"ctr joint={joint}: logloss {report['logloss']} "
                                 f"against the constant predictor's {const}")
        if joint:
            n_q = int((tr.test_data.labels > 0.5).sum())
            place = np.random.default_rng(seed).integers(0, data.n_items, size=n_q)
            for k in CTR_RECALL_KS:
                out[f"random_recall@{k}"] = float((place < k).mean())
                if not report[f"recall@{k}"] > out[f"random_recall@{k}"]:
                    raise AssertionError(f"ctr recall@{k} {report[f'recall@{k}']} "
                                         f"not above random {out[f'random_recall@{k}']}")
        rec["joint" if joint else "plain"] = out
        print(f"ctr {'joint' if joint else 'plain'} ({card}): examples/s per epoch "
              f"{[round(x) for x in out['examples_per_s']]}, ms a step "
              f"{[round(x, 3) for x in out['ms_per_step']]}, losses "
              f"{[round(x, 4) for x in losses]}, {report}", flush=True)
        del tr
    if on_card:
        torch.cuda.empty_cache()

    # (b) the first steps on the card against the same steps on the CPU
    cfg = settings.replace(CTR_EPOCHS=args.epochs, CTR_BATCH_SIZE=args.batch_size,
                           SEED=seed)
    rec["card_vs_cpu"] = ctr_card_vs_cpu(data, cfg, device, seed, check_steps)

    # (c) the profile of the sparse joint step
    state, _, prof, seconds = _ctr_steps(data, cfg, device, None, seed, profile_steps,
                                         profile=True)
    groups = {k: v / profile_steps for k, v in _ctr_profile_groups(prof).items()}
    kernels = {}
    for key, dev_us, n in device_events(prof):
        name = _short_kernel_name(key)
        us, count = kernels.get(name, (0.0, 0))
        kernels[name] = (us + dev_us / profile_steps, count + n / profile_steps)
    device_us = sum(us for us, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    groups["other"] = device_us - sum(groups.values())
    host_ms = 1e3 * seconds / profile_steps
    rec["profile"] = {"steps": profile_steps, "launches_per_step": launches,
                      "device_us_per_step": device_us, "host_ms_per_step": host_ms,
                      "device_idle_share": (1 - device_us / 1e3 / host_ms
                                            if on_card else None),
                      "groups_us_per_step": dict(sorted(groups.items(),
                                                        key=lambda kv: -kv[1])),
                      "top_kernels_us_launches_per_step": dict(sorted(
                          kernels.items(), key=lambda kv: -kv[1][0])[:12])}
    if on_card and not (device_us > 0 and launches > 0):
        raise AssertionError(f"ctr: the profiler saw no device time: {rec['profile']}")
    print(json.dumps({"ctr_profile": rec["profile"], "card": card}), flush=True)
    del state, prof, data

    # (d) table scale, one epoch in each table mode
    t0 = time.perf_counter()
    big = make_ctr_dataset(**scale_data, seed=seed)
    rec["scale"] = {"data_s": time.perf_counter() - t0,
                    "table_rows": int(sum(big.vocab_sizes)), "dim": scale_dim,
                    "batch": scale_batch, **scale_data}
    for mode in ("sparse", "dense"):
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg = settings.replace(CTR_EMBED_DIM=scale_dim, CTR_BATCH_SIZE=scale_batch,
                               CTR_EPOCHS=1, CTR_TABLE_UPDATE=mode, SEED=seed)
        tr = CTRTrainer(big, cfg=cfg, joint=True, device=device)
        tr.train()
        h = tr.history[0]
        n_batches = len(tr.train_data.labels) // tr.batch_size()
        rec["scale"][mode] = {
            "steps": n_batches, "loss": h["loss"], "seconds": h["seconds"],
            "ms_per_step": 1e3 * h["seconds"] / n_batches,
            "examples_per_s": h["examples_per_s"],
            "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                             if on_card else None)}
        if not np.isfinite(h["loss"]):
            raise AssertionError(f"ctr scale {mode}: loss {h['loss']}")
        del tr
    sc = rec["scale"]
    sc["dense_over_sparse_ms"] = sc["dense"]["ms_per_step"] / sc["sparse"]["ms_per_step"]
    print(json.dumps({"ctr": rec, "card": card}), flush=True)
    print(f"ctr table scale ({card}): {sc['table_rows']} rows x {scale_dim}, batch "
          f"{scale_batch}: sparse {sc['sparse']['ms_per_step']:.3f} ms a step "
          f"({sc['sparse']['examples_per_s']:.0f} ex/s), dense "
          f"{sc['dense']['ms_per_step']:.3f} ms ({sc['dense']['examples_per_s']:.0f} "
          f"ex/s): dense / sparse {sc['dense_over_sparse_ms']:.2f}", flush=True)
    return rec


def _certified_check(got, want, q, corpus, d_func: int):
    """A certified top-k (``got``: values, positions) against exact mode's
    (``want``) over ``q`` · ``corpus``ᵀ: after the canonical tie order the
    values within C.22's bound 2(D−1)·2⁻²⁴·Σ|q_k·x_k| at every rank, and the
    positions equal or, where they differ, both rows' f64 scores within
    twice the bound of the rank's value. Returns the errors."""
    from recommendit_tpu_torch.ops.topk import canonical_tie_order

    gv, gi = canonical_tie_order(*got)
    wv, wi = canonical_tie_order(*want)

    def abs_dot(ids):
        return (q.abs()[:, None, :] * corpus[ids].abs()).sum(-1).double()

    tol = 2 * (d_func - 1) * 2.0 ** -24 * torch.maximum(abs_dot(wi), abs_dot(gi))
    err = (gv.double() - wv.double()).abs()
    diff = gi != wi
    out = {"max_abs_err": float(err.max()), "max_err_over_bound": float((err / tol).max()),
           "ids_differ": int(diff.sum())}
    if not bool((err <= tol).all()):
        raise AssertionError(f"certified values outside C.22's bound: {out}")
    if out["ids_differ"]:
        for ids in (gi, wi):
            true = (corpus[ids].double() * q.double()[:, None, :]).sum(-1)
            if not bool(((true - wv.double()).abs()[diff] <= 2 * tol[diff]).all()):
                raise AssertionError(f"certified ids differ beyond a near-tie: {out}")
    return out


class _BrokenEngine:
    """Within the block, ``topk.<name>`` returns garbage and fails every
    certificate, so ``mips_topk_certified`` must escalate."""

    def __init__(self, name: str):
        from recommendit_tpu_torch.ops import topk

        self.mod, self.name = topk, name
        self.real = getattr(topk, name)

    def __enter__(self):
        real = self.real

        def broken(*args):
            v, i, _ = real(*args)
            return v * 0 - 1.0, i * 0, torch.zeros(v.shape[0], dtype=torch.bool,
                                                   device=v.device)

        setattr(self.mod, self.name, broken)

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def verified_phase(paths, data, device, seed: int, card: str, qs=VERIFIED_QS,
                   k: int = TOP_K_CANDIDATES, batch: int = BATCH, timer=cuda_ms):
    """``INDEX_MODE=verified`` over the serve phase's 1M-item catalog: an f32
    index of the augmented rows (129 columns, 136 on the card) built in
    verified mode and, from the same rows, in exact mode. At each Q the
    device searcher of each (``mips_topk_certified``, count method, and
    the full-f32 exact top-k) on the user tower's queries: values within
    C.22's bound, ids tie-aware, the escalations counted (none expected);
    one forced escalation (a broken engine) equal to exact; the bound
    method certified at the same shapes; ms per call of verified, bound,
    exact and the fused bf16 route. Then a 1,024-user ``serve_batch`` of a
    verified pipeline against an exact one: every list equal, scores within
    ``HTTP_TOL``."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import topk

    catalog = np.load(paths["catalog_path"])
    item_ids = np.arange(1, len(catalog) + 1)
    dim = catalog.shape[1] - 1                 # the last column is the bias
    idx, index_paths = {}, {}
    t0 = time.perf_counter()
    for mode in ("verified", "exact"):
        index = MIPSIndex(dim, INDEX_BLOCK, mode, "float32", device=device)
        index.build(catalog[:, :dim], item_ids, bias=catalog[:, dim])
        index_paths[mode] = str(Path(paths["index_path"]).with_name(
            f"mips_{mode}_f32.index.npz"))
        index.save(index_paths[mode])
        idx[mode] = index
    build_s = time.perf_counter() - t0
    del catalog
    fused = MIPSIndex.load(paths["index_path"], device=device)
    model = TwoTower.load(paths["model_path"], device=device)
    corpus, d_func = idx["verified"]._embs, idx["verified"]._width
    search = {name: ix.make_device_searcher(k) for name, ix in
              (("verified", idx["verified"]), ("exact", idx["exact"]), ("fused", fused))}
    rng = np.random.default_rng(seed + 11)
    checks = []
    for n_q in qs:
        uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q), device=device)
        u = model.user_tower(uids)
        q = idx["verified"]._augment(u)
        before = dict(topk.ESCALATIONS)
        got = search["verified"](u)
        want = search["exact"](u)
        bound = topk.mips_topk_certified(q, corpus, k, INDEX_BLOCK, method="bound")
        rec = {"q": n_q, "n": idx["verified"].n_total, "d": int(corpus.shape[1]),
               "d_func": d_func, "k": k,
               "escalations": {m: topk.ESCALATIONS[m] - before[m] for m in before},
               "count": _certified_check(got, want, q, corpus, d_func),
               "bound": _certified_check(bound, want, q, corpus, d_func)}
        with _BrokenEngine("_verified_topk"):
            forced = search["verified"](u)
        rec["forced_escalations"] = topk.ESCALATIONS["count"] - before["count"] \
            - rec["escalations"]["count"]
        rec["forced"] = _certified_check(forced, want, q, corpus, d_func)
        reps = 10 if n_q <= 256 else 5
        before = dict(topk.ESCALATIONS)
        for name in ("verified", "exact", "fused"):
            rec[f"{name}_ms"] = timer(lambda: search[name](u), reps)
        rec["bound_ms"] = timer(lambda: topk.mips_topk_certified(
            q, corpus, k, INDEX_BLOCK, method="bound"), reps)
        rec["timed_escalations"] = {m: topk.ESCALATIONS[m] - before[m] for m in before}
        print(json.dumps({"verified_check": rec}), flush=True)
        if rec["forced_escalations"] != 1:
            raise AssertionError(f"the broken engine did not escalate once: {rec}")
        checks.append(rec)
        del got, want, bound, forced, q, u
    torch.cuda.empty_cache()

    users = np.random.default_rng(7).choice(np.arange(1, model.n_users + 1),
                                            size=min(batch, model.n_users), replace=False)
    lists = {}
    before = dict(topk.ESCALATIONS)
    for mode in ("verified", "exact"):
        pipe = load_pipeline(paths, data, device, "float32", mode=mode,
                             index_path=index_paths[mode])
        ids, scores, _ = pipe.serve_batch(users)
        lists[mode] = (ids.cpu().numpy(), scores.cpu().numpy())
        del pipe
        torch.cuda.empty_cache()
    for r in range(len(users)):
        check_list(lists["verified"][0][r], lists["verified"][1][r],
                   lists["exact"][0][r], lists["exact"][1][r])
    serve = {"users": len(users), "lists_equal": True,
             "ids_equal_share": float((lists["verified"][0] == lists["exact"][0]).mean()),
             "max_score_abs_err": float(np.nanmax(np.abs(
                 np.where(np.isfinite(lists["exact"][1]),
                          lists["verified"][1] - lists["exact"][1], 0.0)))),
             "escalations": {m: topk.ESCALATIONS[m] - before[m] for m in before}}
    rec = {"build_s": build_s, "checks": checks, "serve": serve}
    print(json.dumps({"verified": {"build_s": build_s, "serve": serve}, "card": card}),
          flush=True)
    print(f"verified index ({card}): " + "; ".join(
        f"Q={c['q']} verified {c['verified_ms']:.3f} ms, bound {c['bound_ms']:.3f}, "
        f"exact {c['exact_ms']:.3f}, fused {c['fused_ms']:.3f}, escalations "
        f"{c['escalations']}" for c in checks), flush=True)
    return rec


# torch.profiler on the GPU machine loses kernel records: up to 13 of 800
# a kernel in runs of 800 BPR steps (tools/profiler_record_loss.py), 40 of
# 1,010 in one run, and in a window of 200 steps two whole steps of all four
# BPR kernels. So each tower training is profiled in bounded windows of
# steps that run to its end (torch.profiler's schedule: TRAIN_PROFILE_WINDOW
# = steps skipped, then windows of (warm-up, recorded) steps, repeated; 0
# repeats: until the training ends), the card synchronised at each window's
# edges, and each window's recorded steps counted as the profiler saw them.
# The windows must be the schedule's; no window may count a BPR kernel more
# often than its steps; one full window must count each exactly once a
# step; and the records lost over all windows, which cover every step but
# one warm-up step a window, stay within PROFILER_RECORD_LOSS of their
# steps, as the whole-run count did. The wrappers' own counts over the
# whole run are held exactly beside it.
TRAIN_PROFILE_WINDOW = (0, 1, 100, 0)
PROFILER_RECORD_LOSS = 0.03
SNAPSHOT_NATIVE_USERS = 500      # user rows the native reader looks up
PIPELINE_INDEXES = (("exact", "float32"), ("fused", "bfloat16"), ("fused", "int8"))
BPR_KERNELS = ("bpr_fwd_tile_kernel", "bpr_fwd_finish_kernel",
               "bpr_bwd_tile_kernel", "bpr_bwd_finish_kernel")
# the full row ranks with the ranker the ranker stage trained
REPORT_ROWS = {"full": ("ndcg@10", "recall@20", "mrr"),
               "popularity": ("popularity_ndcg@10", "popularity_recall@20",
                              "popularity_mrr"),
               "retrieval_only": ("retrieval_only_ndcg@10",
                                  "retrieval_only_recall@20", "retrieval_only_mrr")}
HOLDOUT_KEYS = ("ndcg@10", "ndcg@20", "recall@20", "base_ndcg@10", "n_queries")
EVAL_K = 20


def _held_out_truth(data, split: float = 0.9):
    """The evaluate stage's truth, computed here on its own: each user's
    positives (rating >= 4) in the last 10 % of the ratings by time."""
    from recommendit_tpu_torch.data.movielens import timestamp_order

    rows = timestamp_order(data.timestamp)[int(len(data) * split):]
    rows = rows[data.rating[rows] >= 4]
    truth = {}
    for u, i in zip(data.user_id[rows].tolist(), data.item_id[rows].tolist()):
        truth.setdefault(u, []).append(i)
    return truth


def check_eval_lists(orch, seen, truth, device, seed: int, k: int = EVAL_K):
    """The evaluate stage's ranked lists: the full and popularity rows hold
    ``k`` distinct items the user did not rate in the train view; the
    retrieval-only row is exactly the first ``k`` such items of the index's
    top-C search (C = min(TOP_K_CANDIDATES, items)), so a user who rated
    most of the C gets fewer, as in the reference. Then NDCG@10 and
    Recall@20 of the retrieval-only row against a seeded random ranking of
    the same users' unseen items. Returns the random ranking's row."""
    from recommendit_tpu_torch.evaluation.metrics import evaluate_model
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower

    lists = orch.eval_lists
    for row in ("full", "popularity"):
        for u, items in lists[row].items():
            arr = np.asarray(items, dtype=np.int64)
            if len(arr) != k or len(np.unique(arr)) != k or seen[u, arr].any():
                raise AssertionError(f"{row} list of user {u}: {items}")
    model = TwoTower.load(orch.cfg.EMBEDDING_MODEL_PATH, device=device)
    index = MIPSIndex.load(orch.cfg.INDEX_PATH, device=device)
    retr = lists["retrieval_only"]
    users = list(retr)
    q = np.stack([model.get_user_embedding(u) for u in users])
    _, ids = index.batch_search(q, k=min(orch.cfg.TOP_K_CANDIDATES, index.n_total))
    short = 0
    for row, u in enumerate(users):
        unseen = ids[row][~seen[u, ids[row]]]
        if retr[u] != unseen[:k].tolist():
            raise AssertionError(f"retrieval-only list of user {u}: {retr[u]}")
        short += len(unseen) < k
    rng = np.random.default_rng(seed + 5)
    rand = {u: (rng.permutation(np.flatnonzero(~seen[u, 1:]) + 1)[:k]).tolist()
            for u in users}
    rand_report = evaluate_model(rand, truth, k_values=[10, 20])
    return {"random_ndcg@10": rand_report["ndcg@10"],
            "random_recall@20": rand_report["recall@20"],
            "retrieval_only_short_lists": short}


class _TowerTrainings:
    """Around every ``EmbeddingTrainer.train`` call while installed (the
    ``embeddings`` stage's and the ranker stage's inner towers): its steps,
    its seconds and, on the card, ``torch.profiler`` over the windows
    ``TRAIN_PROFILE_WINDOW`` of its steps (stepped by the optimizer's
    ``step``): the launches of each BPR kernel each window recorded
    (``bpr_profiled``, a list), the steps each recorded
    (``profiled_steps``) and the
    seconds the profiler took to collect and sum its trace
    (``profiler_s``, which the stage times include and the net times take
    out); with ``profile`` false, no profiler."""

    def __init__(self, device, profile: bool = True, window=TRAIN_PROFILE_WINDOW):
        from recommendit_tpu_torch.training.train_embeddings import (
            EmbeddingTrainer,
            OptaxAdamW,
        )

        self.cls, self.train = EmbeddingTrainer, EmbeddingTrainer.train
        self.opt_cls, self.opt_step = OptaxAdamW, OptaxAdamW.step
        self.on_card = torch.device(device).type == "cuda"
        self.profile = profile
        self.window = window
        self.runs = []

    def _profiled(self, trainer, args, kwargs):
        """``train`` under a profiler whose schedule records the windows;
        the card synchronised where a step enters and leaves each, so a
        window holds exactly its steps' kernels unless records are lost;
        the steps each window recorded are those the profiler was
        recording through."""
        from torch.profiler import ProfilerAction, ProfilerActivity, profile, schedule

        skip, warmup, active, repeat = self.window
        cycle = warmup + active
        out = {"counts": [], "collect_s": 0.0, "recorded": []}
        done, recorded = [0], [0]
        recording = (ProfilerAction.RECORD, ProfilerAction.RECORD_AND_SAVE)
        opt_step = self.opt_step

        def on_edge(s: int) -> bool:
            s -= skip
            return (s >= 0 and (repeat == 0 or s < repeat * cycle)
                    and s % cycle in (warmup - 1, cycle - 1))

        def on_trace_ready(prof):
            t0 = time.perf_counter()
            counts = {}
            for key, _, count in device_events(prof):
                name = _short_kernel_name(key)
                if name.startswith("bpr_"):
                    counts[name] = counts.get(name, 0) + count
            out["counts"].append(counts)
            out["recorded"].append(recorded[0])
            recorded[0] = 0
            out["collect_s"] += time.perf_counter() - t0

        with profile(activities=[ProfilerActivity.CUDA], on_trace_ready=on_trace_ready,
                     schedule=schedule(skip_first=skip, wait=0, warmup=warmup,
                                       active=active, repeat=repeat)) as prof:
            def step(opt, *a, **k):
                res = opt_step(opt, *a, **k)
                if on_edge(done[0]):
                    torch.cuda.synchronize()
                recorded[0] += prof.current_action in recording
                done[0] += 1
                prof.step()
                return res

            self.opt_cls.step = step
            try:
                model = self.train(trainer, *args, **kwargs)
            finally:
                self.opt_cls.step = opt_step
            torch.cuda.synchronize()
            t_train = time.perf_counter()
        return model, t_train, out

    def __enter__(self):
        outer = self

        def train(trainer, *args, **kwargs):
            out = {"counts": [], "collect_s": 0.0, "recorded": []}
            t0 = time.perf_counter()
            if outer.on_card and outer.profile:
                torch.cuda.synchronize()
                model, t_train, out = outer._profiled(trainer, args, kwargs)
            else:
                model = outer.train(trainer, *args, **kwargs)
                if outer.on_card:
                    torch.cuda.synchronize()
                t_train = time.perf_counter()
            outer.runs.append({"steps": sum(h["steps"] for h in trainer.history),
                               "losses": [h["loss"] for h in trainer.history],
                               "epoch_s": [h["seconds"] for h in trainer.history],
                               "train_s": t_train - t0 - out["collect_s"],
                               "profiler_s": time.perf_counter() - t_train
                               + out["collect_s"],
                               "bpr_profiled": out["counts"],
                               "profiled_steps": out["recorded"]})
            return model

        self.cls.train = train
        return self

    def __exit__(self, *exc):
        self.cls.train = self.train


class _MethodTimes:
    """Host seconds and calls of each named method while installed, the
    card synchronised around each call, and each method's last result
    (``last``): where the ranker stage's time goes."""

    def __init__(self, device, targets):
        self.on_card = torch.device(device).type == "cuda"
        self.targets = targets          # {label: (class, method name)}
        self.seconds = {label: 0.0 for label in targets}
        self.calls = {label: 0 for label in targets}
        self.durations = {label: [] for label in targets}
        self.last = {}
        self._saved = {}

    def __enter__(self):
        for label, (cls, name) in self.targets.items():
            raw = cls.__dict__[name]
            self._saved[label] = (cls, name, raw)
            if isinstance(raw, staticmethod):
                setattr(cls, name, staticmethod(self._wrap(label, raw.__func__)))
            else:
                setattr(cls, name, self._wrap(label, raw))
        return self

    def _wrap(self, label, fn):
        def timed(*args, **kwargs):
            if self.on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.on_card:
                torch.cuda.synchronize()
            self.durations[label].append(time.perf_counter() - t0)
            self.seconds[label] += self.durations[label][-1]
            self.calls[label] += 1
            self.last[label] = out
            return out
        return timed

    def __exit__(self, *exc):
        for cls, name, fn in self._saved.values():
            setattr(cls, name, fn)


class _GrowerCalls:
    """While installed, each device tree grower the GBDT builds
    (``models/gbdt.py::_make_grow_tree_device``) times its calls, the card
    synchronised around each (``ms``), and keeps the first call's inputs
    (``first``) and the factory's arguments (``args``)."""

    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self.ms, self.first, self.args = [], None, None

    def __enter__(self):
        from recommendit_tpu_torch.models import gbdt

        self.module, self.make = gbdt, gbdt._make_grow_tree_device
        outer = self

        def make(*args):
            grow = outer.make(*args)
            outer.args = args

            def timed(*inputs):
                if outer.first is None:
                    outer.first = tuple(t.clone() for t in inputs)
                if outer.on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = grow(*inputs)
                if outer.on_card:
                    torch.cuda.synchronize()
                outer.ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return timed

        gbdt._make_grow_tree_device = make
        return self

    def __exit__(self, *exc):
        self.module._make_grow_tree_device = self.make


def _levels_np(levels):
    return [{k: v.cpu().numpy() for k, v in lv.items()} for lv in levels]


def _levels_equal(a, b) -> bool:
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def _split_gap(inputs, args, card, cpu):
    """Where the card's and the CPU's first tree (``_levels_np``) from the
    same inputs first choose differently: at that depth, for each node
    whose split differs, the exact (f64) gain of each side's choice over
    the node's rows and its f32 error bound; the two are a near-tie that
    summation order may flip when their gap is within the sum of the
    bounds. Each histogram sum of a node of n rows is within
    ε = 2(n−1)·2⁻²⁴ of Σ|g| (or Σh) of its exact value (ROADMAP C.22); a
    term S²/(Q+λ) then moves by at most (2|S|ΔS + ΔS²)/(Q+λ−ΔQ) +
    S²ΔQ/((Q+λ)(Q+λ−ΔQ)), and each of the gain's four roundings by 2⁻²⁴ of
    its terms. Returns (depth or None, [per-node records])."""
    n_feat, n_bins, max_depth, min_child, lam = args
    binned, grad, hess, row_mask, _ = (t.cpu().numpy() for t in inputs)
    g = grad.astype(np.float64) * row_mask
    h = hess.astype(np.float64) * row_mask
    n = len(g)
    node = np.zeros(n, np.int64)
    frozen = np.zeros(n, bool)
    for depth, (c, p) in enumerate(zip(card, cpu)):
        keys = ("best_f", "best_b", "do_split")
        differ = np.nonzero(~np.all([c[k] == p[k] for k in keys], axis=0))[0]
        if len(differ):
            out = []
            for pos in differ.tolist():
                rows = ~frozen & (node == pos)
                gs, hs, cnt = g[rows], h[rows], int(row_mask[rows].sum())
                eps = 2 * max(cnt - 1, 0) * 2.0 ** -24
                dg, dh = eps * np.abs(gs).sum(), eps * hs.sum()

                def term(sg, sh):
                    q = sh + lam
                    return (sg * sg / q, (2 * abs(sg) * dg + dg * dg) / max(q - dh, 1e-30)
                            + sg * sg * dh / (q * max(q - dh, 1e-30)))

                def exact(lv):
                    if not lv["do_split"][pos]:
                        return 0.0, 0.0
                    f, b = int(lv["best_f"][pos]), int(lv["best_b"][pos])
                    left = binned[f, rows] <= b
                    parts = [term(gs[m].sum(), hs[m].sum()) for m in (left, ~left)]
                    parent = term(gs.sum(), hs.sum())
                    gain = parts[0][0] + parts[1][0] - parent[0]
                    size = parts[0][0] + parts[1][0] + parent[0]
                    return gain, parts[0][1] + parts[1][1] + parent[1] + 4 * 2.0 ** -24 * size

                (gc, bc), (gp, bp) = exact(c), exact(p)
                out.append({"node": pos, "rows": cnt,
                            "card": [int(c["best_f"][pos]), int(c["best_b"][pos]),
                                     float(c["gain"][pos])],
                            "cpu": [int(p["best_f"][pos]), int(p["best_b"][pos]),
                                    float(p["gain"][pos])],
                            "exact_card": gc, "exact_cpu": gp, "gap": abs(gc - gp),
                            "bound": bc + bp, "within": abs(gc - gp) <= bc + bp})
            return depth, out
        if depth == max_depth:
            break
        split = p["do_split"][node] & ~frozen
        frozen |= ~frozen & ~p["do_split"][node]
        f_row = np.maximum(p["best_f"][node], 0)
        right = binned[f_row, np.arange(n)] > p["best_b"][node]
        node = np.where(split, 2 * node + right, node)
    return None, []


class _RandomScorer:
    """A ranker whose scores are seeded uniform draws."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def predict(self, frame):
        return self.rng.random(len(frame["label"])).astype(np.float32)


def check_snapshot(features_dir: Path):
    """``features.fsnap`` read back: each section's ids and rows equal the
    feature files' columns (the genre blocks last), and one user's and one
    item's dicts equal their file rows; the native reader
    (``native/feature_snapshot.cpp``, built at first use), where it builds,
    gives the numpy reader's item rows and user rows."""
    from recommendit_tpu_torch.features.snapshot import FeatureSnapshot

    snap = FeatureSnapshot(str(features_dir / "features.fsnap"), prefer_native=False)
    for sec, (name, key, drop, cols) in enumerate((
            ("user_features.npz", "user_id", ("user_id",), snap.user_cols),
            ("item_features.npz", "item_id", ("item_id", "title"), snap.item_cols))):
        with np.load(features_dir / name) as z:
            table = {c: z[c] for c in z.files}
        vec = [c for c in table if c.startswith(("genre_pref_", "genre_vec_"))]
        names = [c for c in table if c not in drop and c not in vec] + vec
        want = np.stack([table[c].astype(np.float64) for c in names], 1).astype(np.float32)
        order = np.argsort(table[key], kind="stable")
        ids, rows = snap.backend.sections[sec]
        if not (np.array_equal(ids, table[key][order])
                and np.array_equal(rows, want[order]) and len(cols) == len(names)):
            raise AssertionError(f"features.fsnap section {sec} differs from {name}")
    u, i = (int(snap.backend.sections[sec][0][0]) for sec in (0, 1))
    if snap.user_dict(u) is None or snap.item_dict(i) is None:
        raise AssertionError("features.fsnap lost a user or an item")
    nat = FeatureSnapshot(str(features_dir / "features.fsnap"))
    if nat.native:
        (uids, urows), (iids, irows) = snap.backend.sections
        got, found = nat.gather_items(iids)
        if not (found.all() and np.array_equal(got, irows) and all(
                np.array_equal(nat.user_row(int(x)), urows[j])
                for j, x in enumerate(uids[:SNAPSHOT_NATIVE_USERS]))):
            raise AssertionError("the native snapshot reader differs from numpy's")
    nat.close()
    return {"users": snap.n_users(), "items": snap.n_items(), "native": nat.native}


def schedule_windows(steps: int, window=TRAIN_PROFILE_WINDOW):
    """The recorded steps of each window ``torch.profiler``'s schedule
    ``window`` makes over a training of ``steps`` steps (a window cut by
    the training's end holds the steps it got: none where the training
    ends just as the window starts)."""
    skip, warmup, active, repeat = window
    out, c = [], 0
    while repeat == 0 or c < repeat:
        start = skip + c * (warmup + active) + warmup
        if start > steps:
            break
        out.append(min(active, steps - start))
        c += 1
    return out


def check_profiled_windows(run, window=TRAIN_PROFILE_WINDOW):
    """A tower training's profiled windows (``_TowerTrainings``): the steps
    each recorded those of the schedule, no window counting a BPR kernel
    more often than its steps, one full window counting each exactly once a
    step, and the records lost over all windows within
    ``PROFILER_RECORD_LOSS`` of their steps; → the records lost, by
    kernel."""
    active = window[2]
    wins, steps = run["bpr_profiled"], run["profiled_steps"]
    lost = {n: sum(s - w.get(n, 0) for w, s in zip(wins, steps)) for n in BPR_KERNELS}
    allowed = int(PROFILER_RECORD_LOSS * sum(steps))
    if not (steps == schedule_windows(run["steps"], window) and len(wins) == len(steps)
            and all(w.get(n, 0) <= s for w, s in zip(wins, steps) for n in BPR_KERNELS)
            and any(s == active and all(w.get(n, 0) == s for n in BPR_KERNELS)
                    for w, s in zip(wins, steps))
            and max(lost.values()) <= allowed):
        raise AssertionError(f"the profiler's windows of {steps} steps (of {run['steps']}; "
                             f"the schedule's {schedule_windows(run['steps'], window)}) "
                             f"saw BPR kernels {wins}: expected one full window with "
                             f"each {active} times and at most {allowed} records lost "
                             "a kernel")
    return lost


ML1M_FILES = ("ratings.dat", "users.dat", "movies.dat", "README")


def write_ml1m_archive(src: Path, path: Path) -> Path:
    """The four ML-1M files of ``src`` zipped at ``path`` as GroupLens's
    archive lays them out (``ml-1m/<name>``, deflated)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name in ML1M_FILES:
            zf.write(src / name, f"ml-1m/{name}")
    return path


def _refuse_connect(*args, **kwargs):
    raise AssertionError(f"a socket connect in an offline stage: {args}")


def offline(fn):
    """``fn`` with every socket connect refused while it runs."""
    def run(*args, **kwargs):
        saved = socket.socket.connect, socket.create_connection
        socket.socket.connect = socket.create_connection = _refuse_connect
        try:
            return fn(*args, **kwargs)
        finally:
            socket.socket.connect, socket.create_connection = saved
    return run


def check_download(staged: Path, data_dir: Path, archive: Path, seconds: float) -> dict:
    """The ``data`` stage's download: every file it extracted into
    ``data_dir`` byte-equal to the one archived from ``staged``, and the
    fetched zip removed from beside it."""
    unequal = [name for name in ML1M_FILES
               if (data_dir / name).read_bytes() != (staged / name).read_bytes()]
    left = sorted(p.name for p in data_dir.parent.glob("*.zip"))
    if unequal or left:
        raise AssertionError(f"the data stage's download: files {unequal} differ "
                             f"from the archived ones, zips {left} left beside them")
    return {"archive_bytes": archive.stat().st_size,
            "files_bytes": sum((data_dir / n).stat().st_size for n in ML1M_FILES),
            "files_equal": True, "data_stage_s": seconds}


def pipeline_phase(data, device, seed: int, workdir: Path, card: str,
                   epochs: int = TRAIN_EPOCHS, dim: int = TRAIN_DIM,
                   hidden: int = TRAIN_HIDDEN, batch: int = TRAIN_BATCH,
                   ranker_cfg=None):
    """The pipeline CLI on ``data`` (the train phase's synthetic ML-1M-shape
    set), as ``python -m recommendit_tpu_torch.pipelines.run_pipeline
    --stage all`` runs it: the ``.dat`` files written and read back equal,
    then zipped as GroupLens's archive and ``MOVIELENS_1M_URL`` pointed at
    that ``file://`` path for the run (restored after); ``all`` over an
    empty ``<root>/ml-1m`` (Settings defaults but ``LOSS_MODE=in_batch``
    and ``epochs``, and ``ranker_cfg`` where given): data (the archive
    fetched and extracted with every socket connect refused, the files
    byte-equal to those archived), features,
    embeddings, index (exact f32), ranker (two inner towers, the ranker
    trained), load_features, skew, evaluate; one launch of each BPR kernel
    per step of the three tower trainings, by the wrappers' counts and the
    profiler's; every ranker epoch's loss finite, a best epoch, the holdout
    NDCG@10 above a seeded random scorer's on the same groups; the snapshot
    equal to the feature files; a second ``embeddings`` run resuming from
    the checkpoint with no step and writing the same model; the packed
    tables equal to those ``RecommendationPipeline.load`` recomputes; then
    ``index`` and ``evaluate`` again for the fused bf16 and int8 index,
    the window kernels' launches counted around exactly each evaluate (none
    where JAX's window rule sends the catalog to the exact route)."""
    import dataclasses
    import shutil

    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.data import movielens
    from recommendit_tpu_torch.features.schema import ITEM_PACKED_DIM
    from recommendit_tpu_torch.ops import bpr
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    root = workdir / "pipeline"
    shutil.rmtree(root, ignore_errors=True)
    rec = {"ratings": len(data), "users": data.n_users, "items": data.n_items}
    staged = root / "dat"
    t0 = time.perf_counter()
    movielens.save_movielens(data, str(staged))
    rec["save_dat_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = movielens.load_movielens(str(staged))
    rec["load_dat_s"] = time.perf_counter() - t0
    for f in dataclasses.fields(data):
        if not np.array_equal(getattr(again, f.name), getattr(data, f.name)):
            raise AssertionError(f"the .dat round trip changed {f.name}")
    t0 = time.perf_counter()
    archive = write_ml1m_archive(staged, root / "archive" / "ml-1m.zip")
    rec["archive_s"] = time.perf_counter() - t0

    cfg = Settings(LOSS_MODE="in_batch", TRAIN_EPOCHS=epochs, SEED=seed,
                   EMBEDDING_DIM=dim, HIDDEN_DIM=hidden, BATCH_SIZE=batch,
                   **(ranker_cfg or {}))
    data_dir = root / "ml-1m"
    orch = PipelineOrchestrator(cfg=cfg, data_dir=str(data_dir),
                                models_dir=str(root / "models"),
                                features_dir=str(root / "features"),
                                eval_users=data.n_users + 1, device=device)
    orch.run_data = offline(orch.run_data)
    from recommendit_tpu_torch.models.ranker import LambdaRankScorer
    from recommendit_tpu_torch.training.train_ranker import RankerTrainer

    # the ranker stage's parts; a fold's frame includes its inner tower
    ranker_parts = {
        "fold_frames": (RankerTrainer, "_fold_candidate_frames"),
        "ranker_train": (LambdaRankScorer, "train"),
        "holdout": (RankerTrainer, "_evaluate_holdout"),
        "importance": (LambdaRankScorer, "top_features")}
    url = movielens.MOVIELENS_1M_URL
    movielens.MOVIELENS_1M_URL = archive.resolve().as_uri()
    for name in bpr.LAUNCHES:
        bpr.LAUNCHES[name] = 0
    try:
        with _TowerTrainings(device) as towers, \
                _MethodTimes(device, ranker_parts) as parts:
            report = orch.run_stage("all")
    finally:
        movielens.MOVIELENS_1M_URL = url
    launches = dict(bpr.LAUNCHES)
    rec["download"] = check_download(staged, data_dir, archive, orch.stage_times["data"])
    print(f"pipeline data stage ({card}): {archive.name} ({rec['download']['archive_bytes']:,} "
          f"bytes) fetched from file:// and extracted into {data_dir.name}/ in "
          f"{rec['download']['data_stage_s']:.3f} s, the {len(ML1M_FILES)} files "
          f"({rec['download']['files_bytes']:,} bytes) byte-equal to those archived",
          flush=True)
    rec["stage_s"] = dict(orch.stage_times)
    rec["ranker_parts_s"] = parts.seconds
    rec["ranker_parts_calls"] = parts.calls
    on_card = torch.device(device).type == "cuda"
    steps = [r["steps"] for r in towers.runs]
    profiler_s = [r["profiler_s"] for r in towers.runs]
    rec["stage_net_s"] = dict(rec["stage_s"], embeddings=rec["stage_s"]["embeddings"]
                              - profiler_s[0], ranker=rec["stage_s"]["ranker"]
                              - sum(profiler_s[1:]))
    rec["ranker_parts_s"]["fold_frames_net"] = (rec["ranker_parts_s"]["fold_frames"]
                                                - sum(profiler_s[1:]))
    rec.update(tower_steps=steps, tower_losses=[r["losses"] for r in towers.runs],
               tower_epoch_s=[r["epoch_s"] for r in towers.runs],
               tower_train_s=[r["train_s"] for r in towers.runs],
               tower_profiler_s=profiler_s, bpr_launches=launches,
               bpr_profiled=[r["bpr_profiled"] for r in towers.runs],
               profiled_steps=[r["profiled_steps"] for r in towers.runs])
    if len(steps) != 1 + cfg.RANKER_CAND_FOLDS:
        raise AssertionError(f"expected the embeddings stage's and "
                             f"{cfg.RANKER_CAND_FOLDS} inner towers, got {steps}")
    for r in towers.runs:
        if not (np.isfinite(r["losses"]).all() and r["losses"][-1] < np.log(2.0)):
            raise AssertionError(f"tower loss {r['losses']}: not finite or not "
                                 "below ln 2")
        if on_card:
            rec.setdefault("profiler_lost", []).append(check_profiled_windows(r))
    per_step = sum(steps) if on_card else 0
    if launches != {"bpr_fwd": per_step, "bpr_bwd": per_step}:
        raise AssertionError(f"expected {per_step} launches of each BPR "
                             f"wrapper ({steps} steps), got {launches}")

    trainer = orch.ranker_trainer
    ranker = trainer.ranker
    hold = trainer.holdout_metrics
    rand = trainer._evaluate_holdout(_RandomScorer(seed + 7), trainer.test_feats,
                                     trainer.feature_cols)
    rec["ranker"] = {
        "holdout": {k: hold.get(k) for k in HOLDOUT_KEYS},
        "random_ndcg@10": rand["ndcg@10"], "best_iteration": ranker.best_iteration,
        "epochs_run": len(ranker.evals_result["train_loss"]),
        "train_loss": ranker.evals_result["train_loss"],
        "valid_ndcg@10": ranker.evals_result["valid_ndcg@10"],
        "holdout_rows": len(trainer.test_feats["label"])}
    if not np.isfinite(ranker.evals_result["train_loss"]).all():
        raise AssertionError(f"ranker loss {ranker.evals_result['train_loss']}")
    if ranker.best_iteration < 1:
        raise AssertionError("the ranker has no best epoch")
    if not (hold["n_queries"] > 0 and hold["ndcg@10"] > rand["ndcg@10"]):
        raise AssertionError(f"holdout {hold} does not beat a random scorer's "
                             f"NDCG@10 {rand['ndcg@10']}")
    rec["snapshot"] = check_snapshot(root / "features")

    # a second embeddings run resumes from the best checkpoint: the last
    # epoch, so no step, and the same model
    model_path = Path(orch.cfg.EMBEDDING_MODEL_PATH)
    with np.load(model_path) as z:
        first = {k: z[k] for k in z.files}
    for name in bpr.LAUNCHES:
        bpr.LAUNCHES[name] = 0
    hist = orch.run_stage("embeddings")
    with np.load(model_path) as z:
        same = sorted(z.files) == sorted(first) and all(
            np.array_equal(z[k], first[k]) for k in z.files)
    rec["resume"] = {"steps": sum(h["steps"] for h in hist),
                     "launches": dict(bpr.LAUNCHES), "same_model": same,
                     "seconds": orch.stage_times["embeddings"]}
    if hist or any(bpr.LAUNCHES.values()) or not same:
        raise AssertionError(f"the resumed embeddings run: {rec['resume']}")

    view = orch._train_view()
    seen = np.zeros((data.n_users + 1, data.n_items + 1), dtype=bool)
    seen[view.user_id, view.item_id] = True
    truth = _held_out_truth(orch._load_data())
    rec["eval_users"] = len(truth)
    reports = {}
    for mode, dtype in PIPELINE_INDEXES:
        name = f"{mode}_{dtype}"
        if mode == "exact":
            # the index and evaluate stages of all; the packed tables,
            # written by the features stage, recomputed by a load that has
            # no features directory
            t0 = time.perf_counter()
            pipe = RecommendationPipeline(
                model_path=orch.cfg.EMBEDDING_MODEL_PATH,
                index_path=orch.cfg.INDEX_PATH,
                ranker_path=orch.cfg.RANKER_MODEL_PATH, cfg=orch.cfg,
                device=device)
            pipe.load(view)
            rec["load_recompute_s"] = time.perf_counter() - t0
            up = pipe._user_packed.cpu().numpy()
            ip = pipe._item_packed.cpu().numpy()
            if not (np.array_equal(up, np.load(root / "features" / "user_packed.npy"))
                    and np.array_equal(ip[:, :ITEM_PACKED_DIM],
                                       np.load(root / "features" / "item_packed.npy"))
                    and not ip[:, ITEM_PACKED_DIM:].any()):
                raise AssertionError("the recomputed packed tables differ from "
                                     "the features stage's")
            del pipe
            index_s, evaluate_s = rec["stage_s"]["index"], rec["stage_s"]["evaluate"]
        else:
            orch.cfg = orch.cfg.replace(
                INDEX_MODE=mode, INDEX_DTYPE=dtype,
                INDEX_PATH=str(root / "models" / f"mips_{name}.index.npz"))
            orch.run_stage("index")
            _reset(mw.LAUNCHES)
            report = orch.run_stage("evaluate")
            window_launches = mw.LAUNCHES[SERVE_KERNELS[dtype]]
            index_s, evaluate_s = orch.stage_times["index"], orch.stage_times["evaluate"]
            # JAX's window rule: below a window of 8 the fused route scans exactly
            window = mw.fused_window(len(data.item_ids), orch.cfg.TOP_K_CANDIDATES)
            if (window < 8 and window_launches) or (window >= 8 and on_card
                                                     and not window_launches):
                raise AssertionError(f"{name}: {window_launches} launches of "
                                     f"{SERVE_KERNELS[dtype]} at window {window}")
        bad = [k for k, v in report.items()
               if not isinstance(v, list) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{name}: non-finite report values {bad}")
        if report["n_users"] != len(truth):
            raise AssertionError(f"{name}: {report['n_users']} users evaluated, "
                                 f"{len(truth)} have held-out positives")
        rand = check_eval_lists(orch, seen, truth, device, seed)
        for key in ("ndcg@10", "recall@20"):
            if not report[f"retrieval_only_{key}"] > rand[f"random_{key}"]:
                raise AssertionError(f"{name}: retrieval-only {key} "
                                     f"{report[f'retrieval_only_{key}']} does not "
                                     f"beat a random ranking's {rand[f'random_{key}']}")
        reports[name] = {
            "rows": {row: {k: report[k] for k in keys}
                     for row, keys in REPORT_ROWS.items()},
            **rand, "coverage": report["coverage"],
            "paired_ndcg10_full_minus_retrieval":
                report.get("paired_ndcg10_full_minus_retrieval"),
            "paired_ndcg10_se": report.get("paired_ndcg10_se"),
            "index_s": index_s, "evaluate_s": evaluate_s}
        if mode != "exact":
            reports[name].update(window=window, window_launches=window_launches)
    skew = json.loads((root / "models" / "skew_report.json").read_text())
    if skew["max_kl"] != 0.0 or skew["skew_detected"] or \
            skew["n_features_checked"] != 50:
        raise AssertionError(f"skew report: {skew}")
    rec["skew"] = {k: skew[k] for k in ("max_kl", "skew_detected",
                                        "n_features_checked")}
    rec["reports"] = reports
    i8, bf = (reports["fused_int8"]["rows"]["retrieval_only"],
              reports["fused_bfloat16"]["rows"]["retrieval_only"])
    rec["int8_minus_bf16_retrieval_only"] = {
        k: i8[f"retrieval_only_{k}"] - bf[f"retrieval_only_{k}"]
        for k in ("ndcg@10", "recall@20")}
    print(json.dumps({"pipeline": rec, "card": card}), flush=True)
    print(f"pipeline stage seconds, net of the profiler's trace collection "
          f"({card}): " + ", ".join(f"{k} {v:.3f}" for k, v in rec["stage_net_s"].items()),
          flush=True)
    r = rec["ranker"]
    print(f"pipeline ranker holdout ({card}): " + ", ".join(
        f"{k}={v}" for k, v in r["holdout"].items())
        + f"; random ndcg@10={r['random_ndcg@10']}; best epoch "
        f"{r['best_iteration']} of {r['epochs_run']} run", flush=True)
    for name, r in reports.items():
        print(f"pipeline {name} ({card}): " + "; ".join(
            f"{row} " + ", ".join(f"{k.split('_')[-1]}={v:.5f}"
                                  for k, v in vals.items())
            for row, vals in r["rows"].items())
            + f"; paired ndcg@10 full - retrieval-only="
            f"{r['paired_ndcg10_full_minus_retrieval']}"
            + (f"; {SERVE_KERNELS[name.split('_')[1]]} launches in its evaluate "
               f"{r['window_launches']} (window {r['window']})" if "window" in r else ""),
            flush=True)
    return rec


def gbdt_pipeline_phase(data, device, seed: int, workdir: Path, card: str, mlp,
                        epochs: int = TRAIN_EPOCHS, dim: int = TRAIN_DIM,
                        hidden: int = TRAIN_HIDDEN, batch: int = TRAIN_BATCH,
                        ranker_cfg=None):
    """``--stage ranker`` with ``RANKER_TYPE=gbdt`` at the GBDT defaults,
    then ``--stage evaluate``, on the pipeline phase's data and models
    directory (``mlp`` is that phase's record), as the CLI runs them. The
    ranker stage trains its own two inner towers: one launch of each BPR
    kernel per step, and as many steps as the MLP ranker stage's. Checks:
    on the card the device backend; trees grown, a best iteration, every
    validation NDCG@10 finite; the holdout NDCG@10 above a seeded random
    scorer's; the device scorer against the host ``predict`` on every
    holdout row (rtol 1e-4, atol 1e-5); ``load_ranker`` of the saved file
    predicting the same on ``GBDT_ROUND_TRIP_ROWS`` rows; the first tree
    grown again from the same inputs by the same grower on the CPU, any
    differing split a near-tie within its f32 bound (``_split_gap``), and
    twice more on the device (repeat-run equality, written down, not
    held); the evaluate report finite over every user with held-out
    positives and its lists as ``check_eval_lists`` holds them. Prints the
    full row beside the MLP's, popularity's and retrieval-only's, and the
    stage's parts."""
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.models import HistGBDTRanker, gbdt, load_ranker
    from recommendit_tpu_torch.models.ranker import feature_matrix
    from recommendit_tpu_torch.ops import bpr
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator
    from recommendit_tpu_torch.training.train_ranker import RankerTrainer

    root = workdir / "pipeline"
    on_card = torch.device(device).type == "cuda"
    cfg = Settings(LOSS_MODE="in_batch", TRAIN_EPOCHS=epochs, SEED=seed,
                   EMBEDDING_DIM=dim, HIDDEN_DIM=hidden, BATCH_SIZE=batch,
                   RANKER_TYPE="gbdt", **(ranker_cfg or {}))
    orch = PipelineOrchestrator(cfg=cfg, data_dir=str(root / "ml-1m"),
                                models_dir=str(root / "models"),
                                features_dir=str(root / "features"),
                                eval_users=data.n_users + 1, device=device)
    parts = {"fold_frames": (RankerTrainer, "_fold_candidate_frames"),
             "gbdt_train": (HistGBDTRanker, "train"),
             "binning": (HistGBDTRanker, "_bin"),
             "gradients": (HistGBDTRanker, "_round_grad"),
             "valid_ndcg": (HistGBDTRanker, "_ndcg10"),
             "predict_tree": (HistGBDTRanker, "_predict_tree"),
             "host_predict": (HistGBDTRanker, "predict"),
             "holdout": (RankerTrainer, "_evaluate_holdout")}
    for name in bpr.LAUNCHES:
        bpr.LAUNCHES[name] = 0
    with _TowerTrainings(device, profile=False) as towers, \
            _MethodTimes(device, parts) as times, _GrowerCalls(device) as grower:
        hold = orch.run_stage("ranker")
    launches = dict(bpr.LAUNCHES)
    trainer = orch.ranker_trainer
    ranker = trainer.ranker
    steps = [r["steps"] for r in towers.runs]
    evals = ranker.evals_result
    rec = {"backend": ranker.backend_used, "trees": len(ranker.trees),
           "best_iteration": ranker.best_iteration,
           "rounds": len(evals["valid_ndcg@10"]),
           "features": ranker.n_features,
           "tower_steps": steps, "bpr_launches": launches,
           "holdout": {k: hold.get(k) for k in HOLDOUT_KEYS},
           "valid_ndcg@10": evals["valid_ndcg@10"],
           "train_ndcg@10": evals["train_ndcg@10"]}
    if on_card and ranker.backend_used != "device":
        raise AssertionError(f"the GBDT took the {ranker.backend_used} backend on "
                             "the card")
    if len(steps) != cfg.RANKER_CAND_FOLDS or sum(steps) != sum(mlp["tower_steps"][1:]):
        raise AssertionError(f"inner tower steps {steps}, the MLP ranker stage's "
                             f"{mlp['tower_steps'][1:]}")
    per_step = sum(steps) if on_card else 0
    if launches != {"bpr_fwd": per_step, "bpr_bwd": per_step}:
        raise AssertionError(f"expected {per_step} launches of each BPR wrapper "
                             f"({steps} inner-tower steps), got {launches}")
    if not (ranker.trees and ranker.best_iteration >= 1
            and np.isfinite(evals["valid_ndcg@10"]).all()):
        raise AssertionError(f"GBDT training: {len(ranker.trees)} trees, best "
                             f"{ranker.best_iteration}, {evals['valid_ndcg@10']}")
    rand = trainer._evaluate_holdout(_RandomScorer(seed + 7), trainer.test_feats,
                                     trainer.feature_cols)
    rec["random_ndcg@10"] = rand["ndcg@10"]
    if not (hold["n_queries"] > 0 and hold["ndcg@10"] > rand["ndcg@10"]):
        raise AssertionError(f"holdout {hold} does not beat a random scorer's "
                             f"NDCG@10 {rand['ndcg@10']}")

    # the holdout's host scores (the trainer's own predict) against the
    # device scorer on the same rows
    x = feature_matrix(trainer.test_feats, ranker.feature_names)
    host = times.last["host_predict"]
    if host.shape != (len(x),):
        raise AssertionError("the last host predict was not the holdout's")
    t0 = time.perf_counter()
    dev = ranker.make_device_scorer()(torch.as_tensor(x, device=device)).cpu().numpy()
    rec["device_score_s"] = time.perf_counter() - t0
    rec["holdout_rows"] = len(x)
    rec["host_device_max_abs_err"] = float(np.abs(dev - host).max())
    if not np.allclose(dev, host, rtol=GBDT_RTOL, atol=GBDT_ATOL):
        raise AssertionError(f"device and host GBDT scores differ by "
                             f"{rec['host_device_max_abs_err']}")
    back = load_ranker(orch.cfg.RANKER_MODEL_PATH, device=device)
    n_rt = min(len(x), GBDT_ROUND_TRIP_ROWS)
    if not (isinstance(back, HistGBDTRanker)
            and np.array_equal(back.predict(x[:n_rt]), host[:n_rt])):
        raise AssertionError("save -> load_ranker -> predict changed the scores")

    # the first tree again: on the CPU from the same inputs, and twice on
    # the device
    if grower.first is None:
        raise AssertionError("no device tree grower ran")
    rec["train_rows"] = int(grower.first[0].shape[1])
    make = grower.make
    t0 = time.perf_counter()
    cpu_levels, cpu_rv = make(*grower.args)(*(t.cpu() for t in grower.first))
    rec["cpu_tree_s"] = time.perf_counter() - t0
    runs = [make(*grower.args)(*grower.first) for _ in range(2)]
    on_dev = [_levels_np(lv) for lv, _ in runs]
    cpu = _levels_np(cpu_levels)
    depth, gaps = _split_gap(grower.first, grower.args, on_dev[0], cpu)
    rec["first_tree"] = {
        "splits_equal_cpu": depth is None, "differs_at_depth": depth, "gaps": gaps,
        "leaf_max_abs_diff_cpu": max(float(np.abs(a["leaf_value"] - b["leaf_value"]).max())
                                     for a, b in zip(on_dev[0], cpu)),
        "repeat_levels_equal": _levels_equal(on_dev[0], on_dev[1]),
        "repeat_splits_equal": all(
            np.array_equal(a[k], b[k]) for a, b in zip(on_dev[0], on_dev[1])
            for k in ("best_f", "best_b", "do_split")),
        "repeat_row_value_equal": bool(torch.equal(runs[0][1], runs[1][1])),
        "training_tree_equals_repeat": all(
            np.array_equal(getattr(ranker.trees[0], a), getattr(t, a))
            for t in [gbdt._tree_from_levels(on_dev[0], ranker.max_depth)]
            for a in ("feature", "bin_threshold", "left", "right", "value", "gain")),
        "cpu_row_value_max_abs_diff": float((runs[0][1].cpu() - cpu_rv).abs().max())}
    if not all(gap["within"] for gap in gaps):
        raise AssertionError(f"the first tree's splits differ from the CPU's beyond "
                             f"the f32 bound: {gaps}")

    ts = times.seconds
    tower_s = sum(r["train_s"] for r in towers.runs)
    rec["stage_s"] = orch.stage_times["ranker"]
    rec["parts_s"] = {
        "inner_towers": tower_s, "candidate_builds": ts["fold_frames"] - tower_s,
        "gbdt_train": ts["gbdt_train"], "binning": ts["binning"],
        # train's own binning: the train and the valid frame, its first calls
        "boosting": ts["gbdt_train"] - sum(times.durations["binning"][:2]),
        "gradients": ts["gradients"], "grower": sum(grower.ms) / 1e3,
        "valid_ndcg": ts["valid_ndcg"], "predict_tree": ts["predict_tree"],
        "holdout": ts["holdout"]}
    rec["grower_ms_per_tree"] = float(np.mean(grower.ms))
    rec["gradients_ms_per_round"] = ts["gradients"] * 1e3 / max(1, times.calls["gradients"])
    rec["valid_ndcg_ms_per_round"] = ts["valid_ndcg"] * 1e3 / max(1, rec["rounds"])

    view = orch._train_view()
    seen = np.zeros((data.n_users + 1, data.n_items + 1), dtype=bool)
    seen[view.user_id, view.item_id] = True
    truth = _held_out_truth(orch._load_data())
    report = orch.run_stage("evaluate")
    rec["evaluate_s"] = orch.stage_times["evaluate"]
    bad = [k for k, v in report.items() if not isinstance(v, list) and not np.isfinite(v)]
    if bad or report["n_users"] != len(truth):
        raise AssertionError(f"GBDT evaluate: non-finite {bad}, {report['n_users']} "
                             f"users of {len(truth)}")
    check_eval_lists(orch, seen, truth, device, seed)
    mlp_rows = mlp["reports"]["exact_float32"]["rows"]
    rec["rows"] = {"gbdt_full": {k: report[k] for k in REPORT_ROWS["full"]},
                   "mlp_full": mlp_rows["full"], "popularity": mlp_rows["popularity"],
                   "retrieval_only": mlp_rows["retrieval_only"]}
    rec["paired_ndcg10_full_minus_retrieval"] = report.get(
        "paired_ndcg10_full_minus_retrieval")
    print(json.dumps({"gbdt_pipeline": rec, "card": card}), flush=True)
    print(f"gbdt ranker ({card}): backend {rec['backend']}, "
          f"{rec['trees']} trees, best {rec['best_iteration']} of {rec['rounds']} rounds; "
          f"holdout ndcg@10={hold['ndcg@10']:.5f} (random {rand['ndcg@10']:.5f}); "
          + "; ".join(f"{row} " + ", ".join(f"{k.split('_')[-1]}={v:.5f}"
                                           for k, v in vals.items())
                      for row, vals in rec["rows"].items()), flush=True)
    return rec


def _rel_l2(got: dict, want: dict, start: dict):
    """Per tensor: the L2 distance of ``got`` from ``want`` over ``want``'s
    move from ``start``, and the largest absolute difference."""
    out = {}
    for k, w in want.items():
        w = w.detach().float()
        move = float(torch.linalg.vector_norm(w - start[k].to(w.device)))
        diff = got[k].detach().float() - w
        out[k] = {"rel_l2": float(torch.linalg.vector_norm(diff)) / max(move, 1e-30),
                  "max_abs": float(diff.abs().max()) if diff.numel() else 0.0}
    return out


def _check_rel_l2(name: str, errs: dict, limit: float = PAR_REL_L2):
    bad = {k: v for k, v in errs.items() if not v["rel_l2"] <= limit}
    if bad:
        raise AssertionError(f"{name}: params off the single-device step's: {bad}")


def _timed_steps(fn, batches, device) -> float:
    """ms per call of ``fn(batch)`` over ``batches``, host clock around a
    synchronised run."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    for b in batches:
        fn(b)
    sync()
    return 1e3 * (time.perf_counter() - t0) / len(batches)


def _profile_steps(fn, batches):
    """``torch.profiler`` over ``fn(b)`` for each of ``batches``: per step,
    the host clock (ms), the device's kernel time (µs) and launches, the
    idle share, and the 5 kernels with the most device time."""
    def body():
        t0 = time.perf_counter()
        for b in batches:
            fn(b)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / len(batches)

    prof, host_ms = profiled(body)
    kernels, launches = {}, 0
    for key, dev_us, count in device_events(prof):
        name = _short_kernel_name(key)
        kernels[name] = kernels.get(name, 0.0) + dev_us / len(batches)
        launches += count
    device_us = sum(kernels.values())
    if device_us <= 0:
        raise AssertionError("the profiler saw no device time")
    return {"host_ms_per_step": host_ms, "device_us_per_step": device_us,
            "launches_per_step": launches / len(batches),
            "device_idle_share": 1 - device_us / 1e3 / host_ms,
            "top_us_per_step": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:5])}


def parallel_train_check(mesh, device, seed: int, two_tower=PAR_TWO_TOWER,
                         steps: int = PAR_CHECK_STEPS, timed: int = PAR_TIMED_STEPS,
                         profiled: int = PAR_PROFILE_STEPS):
    """The sharded two-tower step (``parallel.make_sharded_train_step``)
    against the single-device step composed from the port's functions (the
    towers, ``in_batch_bpr_loss``, ``clip_by_global_norm_``, ``OptaxAdamW``)
    from the same weights, batches and dropout generator: ``steps`` steps,
    the BPR kernels counted around exactly the sharded ones (one of each a
    step on the card), the losses within ``PAR_LOSS_RTOL``, each param
    within ``PAR_REL_L2`` of its move; then ms a step of both, in blocks of
    ``timed`` steps: sharded, single, single, sharded; on the card,
    :func:`_profile_steps` over ``profiled`` steps of each."""
    from recommendit_tpu_torch.models.two_tower import init_params, item_tower, user_tower
    from recommendit_tpu_torch.ops import bpr
    from recommendit_tpu_torch.ops.topk import full_f32_matmul
    from recommendit_tpu_torch.parallel import AdamW, init_sharded_state, make_sharded_train_step
    from recommendit_tpu_torch.parallel.train import dropout_generator
    from recommendit_tpu_torch.training.train_embeddings import (
        OptaxAdamW,
        clip_by_global_norm_,
    )

    device = torch.device(device)
    n_users, n_items, dim, hidden, batch = two_tower
    lr, wd, clip = 1e-3, 1e-4, 1.0
    start = init_params(torch.Generator().manual_seed(seed), n_users, n_items, dim,
                        hidden, device="cpu")
    rng = np.random.default_rng(seed)
    genre = torch.as_tensor((rng.random((n_items + 1, 18)) < 0.2).astype(np.float32),
                            device=device)
    batches = [tuple(torch.as_tensor(rng.integers(1, n + 1, batch), device=device)
                     for n in (n_users, n_items)) for _ in range(steps + timed)]

    tx = AdamW(lr, weight_decay=wd, clip_norm=clip)
    sp, so = init_sharded_state(mesh, tx, start)
    step = make_sharded_train_step(mesh, tx, genre, dropout_rate=TRAIN_DROPOUT)
    gen_s = dropout_generator(mesh, seed)

    params = {k: v.to(device, copy=True).requires_grad_(True) for k, v in start.items()}
    plist = list(params.values())
    opt = OptaxAdamW(plist, [True] * len(plist), wd)
    gen_1 = torch.Generator(device=device).manual_seed(seed)

    def single_step(b):
        u, i = b
        with full_f32_matmul():
            ue = user_tower(params, u, TRAIN_DROPOUT, gen_1)
            ie = item_tower(params, i, genre[i], TRAIN_DROPOUT, gen_1)
            loss = bpr.in_batch_bpr_loss(ue, ie)
            grads = torch.autograd.grad(loss, plist, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(plist, grads)]
            clip_by_global_norm_(grads, clip)
            opt.step(grads, lr)
        return loss.detach()

    def sharded_step(b):
        return step(sp, so, b, gen_s)[2]

    losses_s, losses_1 = [], []
    per_step = 1 if device.type == "cuda" else 0
    launches = {name: 0 for name in bpr.LAUNCHES}
    for b in batches[:steps]:
        for name in bpr.LAUNCHES:
            bpr.LAUNCHES[name] = 0
        losses_s.append(float(sharded_step(b)))
        if bpr.LAUNCHES != {"bpr_fwd": per_step, "bpr_bwd": per_step}:
            raise AssertionError(f"sharded step: expected {per_step} launch of each "
                                 f"BPR kernel, got {bpr.LAUNCHES}")
        for name in launches:
            launches[name] += bpr.LAUNCHES[name]
        losses_1.append(float(single_step(b)))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses_s, losses_1)]
    errs = _rel_l2(sp, params, start)
    rec = {"shape": dict(zip(("users", "items", "dim", "hidden", "batch"), two_tower)),
           "steps": steps, "launches": launches, "losses": losses_s,
           "single_losses": losses_1, "loss_rel_err": max(rel),
           "param_rel_l2": max(e["rel_l2"] for e in errs.values()),
           "param_max_abs": max(e["max_abs"] for e in errs.values())}
    if not (np.isfinite(losses_s).all() and max(rel) <= PAR_LOSS_RTOL):
        raise AssertionError(f"sharded losses {losses_s} against {losses_1}")
    _check_rel_l2("sharded two-tower step", errs)
    timed_b = batches[steps:]
    t = [_timed_steps(sharded_step, timed_b, device), _timed_steps(single_step, timed_b, device),
         _timed_steps(single_step, timed_b, device), _timed_steps(sharded_step, timed_b, device)]
    ms_s, ms_1 = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    rec.update(ms_blocks=t, sharded_ms=ms_s, single_ms=ms_1,
               sharded_examples_per_s=batch / ms_s * 1e3,
               single_examples_per_s=batch / ms_1 * 1e3,
               sharded_over_single=ms_s / ms_1)
    if device.type == "cuda":
        rec["profile"] = {name: _profile_steps(fn, timed_b[:profiled]) for name, fn in
                          (("sharded", sharded_step), ("single", single_step))}
    return rec


def parallel_merge_check(mesh, paths, device, seed: int, n_q: int = PAR_MERGE_Q,
                         k: int = TOP_K_CANDIDATES, timer=cuda_ms):
    """Both merges (``sharded_mips_topk``, ``..._ring``, ``canonical=True``)
    over the catalog's augmented f32 rows against the port's ``mips_topk``
    in ``canonical_tie_order``: ids and values equal; the times of all
    three."""
    from recommendit_tpu_torch.models import TwoTower
    from recommendit_tpu_torch.ops.topk import canonical_tie_order, mips_topk
    from recommendit_tpu_torch.parallel import (
        row_sharded,
        sharded_mips_topk,
        sharded_mips_topk_ring,
    )

    corpus = torch.from_numpy(np.load(paths["catalog_path"]))
    items = row_sharded(mesh).shard(corpus)       # this rank's rows: all of them
    model = TwoTower.load(paths["model_path"], device=device)
    rng = np.random.default_rng(seed)
    uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q), device=device)
    with torch.no_grad():
        q = model.user_tower(uids)
    q = torch.cat([q, torch.ones_like(q[:, :1])], dim=1)     # the bias column
    want_v, want_i = canonical_tie_order(*mips_topk(q, items, k))
    rec = {"n": int(items.shape[0]), "d": int(items.shape[1]), "q": n_q, "k": k}
    for name, fn in (("allgather", sharded_mips_topk), ("ring", sharded_mips_topk_ring)):
        v, i = fn(q, items, k, mesh, canonical=True)
        if not (torch.equal(i, want_i) and torch.equal(v, want_v)):
            raise AssertionError(f"the {name} merge differs from mips_topk: "
                                 f"{int((i != want_i).sum())} ids")
        rec[f"{name}_ms"] = timer(lambda: fn(q, items, k, mesh, canonical=True), 5)
    rec["mips_topk_ms"] = timer(lambda: canonical_tie_order(*mips_topk(q, items, k)), 5)
    return rec


def parallel_serve_check(mesh, paths, device, seed: int, n_users: int = BATCH,
                         n_candidates: int = TOP_K_CANDIDATES, k_out: int = PAR_SERVE_K,
                         timer=cuda_ms):
    """``parallel.make_sharded_serve_fn`` on the serve configuration (the
    two-tower, the catalog's unit rows, the packed tables, a random MLP
    ranker (128, 64) over the 50 assembled columns from ``seed``) for one
    batch of ``n_users`` users, against the same composition from the
    port's single-device functions: every list by ``check_list``; the
    times of both."""
    from recommendit_tpu_torch.features.schema import assemble_packed
    from recommendit_tpu_torch.models import TwoTower
    from recommendit_tpu_torch.models.ranker import init_mlp, mlp_score
    from recommendit_tpu_torch.models.two_tower import user_tower
    from recommendit_tpu_torch.ops.topk import fast_topk, full_f32_matmul, mips_topk
    from recommendit_tpu_torch.parallel import make_sharded_serve_fn, row_sharded

    model = TwoTower.load(paths["model_path"], device=device)
    params = model.params()
    corpus = torch.from_numpy(np.load(paths["catalog_path"]))[:, :model.embed_dim]
    corpus_d = corpus.to(device).contiguous()
    item_ids = torch.arange(1, corpus.shape[0] + 1, device=device)
    feats_dir = Path(paths["features_dir"])
    up = torch.as_tensor(np.load(feats_dir / "user_packed.npy"), device=device)
    ip = torch.as_tensor(np.load(feats_dir / "item_packed.npy"), device=device)
    rparams = {k: v.to(device) for k, v in init_mlp(
        torch.Generator().manual_seed(seed), 50, RANKER_HIDDEN).items()}

    def score_fn(f):
        return mlp_score(rparams, f)

    serve = make_sharded_serve_fn(mesh, params, row_sharded(mesh).shard(corpus),
                                  item_ids, up, ip, score_fn, n_candidates, k_out)
    rng = np.random.default_rng(seed)
    uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_users), device=device)

    @torch.no_grad()
    def reference():
        with full_f32_matmul():
            _, pos = mips_topk(user_tower(params, uids), corpus_d, n_candidates)
            cand = item_ids[pos]
            scores = score_fn(assemble_packed(up[uids], ip[cand]))
            top, sel = fast_topk(scores, k_out)
        return torch.gather(cand, 1, sel), top

    ids, scores, _ = serve(uids)
    want_ids, want_scores = reference()
    got_i, got_s = ids.cpu().numpy(), scores.cpu().numpy()
    want_i, want_s = want_ids.cpu().numpy(), want_scores.cpu().numpy()
    for row in range(n_users):
        check_list(got_i[row].tolist(), got_s[row], want_i[row].tolist(), want_s[row])
    return {"users": n_users, "n_candidates": n_candidates, "k_out": k_out,
            "identical": bool(np.array_equal(got_i, want_i) and np.array_equal(got_s, want_s)),
            "score_max_abs_err": float(np.abs(got_s - want_s).max()),
            "sharded_ms": timer(lambda: serve(uids), 5),
            "single_ms": timer(reference, 5)}


def parallel_ctr_check(mesh, device, seed: int, ctr=PAR_CTR, timed: int = PAR_TIMED_STEPS):
    """One joint step of ``parallel.make_ctr_sharded_train_step`` at ``make
    ctr``'s widths against the single-device joint step composed from
    ``models/ctr`` (``ctr_forward``, ``bce_loss``,
    ``weighted_in_batch_softmax``) and ``OptaxAdamW`` (adam 1e-3) from the
    same params and batch: the loss within ``PAR_LOSS_RTOL``, each param
    within ``PAR_REL_L2`` of its move; then ms a sharded step."""
    from recommendit_tpu_torch.data.ctr import make_ctr_dataset
    from recommendit_tpu_torch.models.ctr import (
        bce_loss,
        ctr_forward,
        field_offsets,
        init_ctr_params,
        weighted_in_batch_softmax,
    )
    from recommendit_tpu_torch.ops.topk import full_f32_matmul
    from recommendit_tpu_torch.parallel import (
        AdamW,
        init_ctr_sharded_state,
        make_ctr_sharded_train_step,
    )
    from recommendit_tpu_torch.training.train_embeddings import OptaxAdamW

    device = torch.device(device)
    lr = 1e-3
    data = make_ctr_dataset(n_examples=ctr["batch"], n_users=ctr["n_users"],
                            n_items=ctr["n_items"], seed=seed)
    vocab = data.vocab_sizes
    start = init_ctr_params(torch.Generator().manual_seed(seed), vocab,
                            embed_dim=ctr["embed"], top_hidden=ctr["top"],
                            retrieval_dim=ctr["retrieval"], device="cpu")
    counts = np.bincount(data.item_ids, minlength=ctr["n_items"])
    log_q = np.log(np.maximum(counts / counts.sum(), 1e-12)).astype(np.float32)
    batch = tuple(torch.as_tensor(a, device=device) for a in (
        data.dense, (data.sparse + field_offsets(vocab)[None, :]).astype(np.int64),
        data.labels, log_q[data.item_ids]))

    tx = AdamW(lr)
    cp, co = init_ctr_sharded_state(mesh, tx, start)
    step = make_ctr_sharded_train_step(mesh, tx, n_user_fields=8, joint=True)
    loss_s = float(step(cp, co, batch)[2])

    params = {k: v.to(device, copy=True).requires_grad_(True) for k, v in start.items()}
    plist = list(params.values())
    opt = OptaxAdamW(plist, [True] * len(plist), 0.0)
    dense, ids, labels, lq = batch
    with full_f32_matmul():
        logits, ue, ie = ctr_forward(params, dense, ids, joint=True)
        loss = (bce_loss(logits, labels)
                + 0.5 * weighted_in_batch_softmax(ue, ie, labels, lq, temperature=0.1))
        opt.step(list(torch.autograd.grad(loss, plist)), lr)
    loss_1 = float(loss.detach())
    errs = _rel_l2(cp, params, start)
    rec = {"table_rows": int(start["embed"].shape[0]), "batch": ctr["batch"],
           "loss": loss_s, "single_loss": loss_1,
           "loss_rel_err": abs(loss_s - loss_1) / abs(loss_1),
           "param_rel_l2": max(e["rel_l2"] for e in errs.values()),
           "param_max_abs": max(e["max_abs"] for e in errs.values())}
    if not rec["loss_rel_err"] <= PAR_LOSS_RTOL:
        raise AssertionError(f"sharded CTR loss {loss_s} against {loss_1}")
    _check_rel_l2("sharded CTR step", errs)
    ms = _timed_steps(lambda b: step(cp, co, b), [batch] * timed, device)
    rec.update(sharded_ms=ms, sharded_examples_per_s=ctr["batch"] / ms * 1e3)
    return rec


def parallel_phase(paths, device, seed: int, workdir: Path, card: str,
                   two_tower=PAR_TWO_TOWER, steps: int = PAR_CHECK_STEPS,
                   timed: int = PAR_TIMED_STEPS, merge_q: int = PAR_MERGE_Q,
                   serve_users: int = BATCH, ctr=PAR_CTR, adam_chunk: int = PAR_ADAM_CHUNK,
                   timer=cuda_ms):
    """The multi-device layer (``recommendit_tpu_torch/parallel``) at world
    size 1 — NCCL on the card, a ``(1, 1)`` mesh (one card cannot hold two
    NCCL ranks) — through its entry points: ``distributed_init``,
    ``create_mesh``, then :func:`parallel_train_check` (kernels 5 and 6 once
    a sharded step), :func:`parallel_merge_check`,
    :func:`parallel_serve_check`, :func:`parallel_ctr_check`, and the
    checkpoint resumed across a restart of the process group
    (``scripts/multiproc_smoke.py``'s ``ctr_run`` / ``ctr_resume``: 4 CTR
    steps, the state saved at step 2, the group destroyed and made anew,
    steps 2-3 again with losses equal); after the train check,
    :func:`adamw_chunk_check` at the same widths (the chunked ``OptaxAdamW``
    step bit-equal to its one-pass form at ``adam_chunk``)."""
    import tempfile

    import torch.distributed as dist

    from recommendit_tpu_torch.parallel import create_mesh, distributed_init
    from recommendit_tpu_torch.scripts import multiproc_smoke as mps

    store = (workdir / "parallel").resolve()      # file:// takes an absolute path
    store.mkdir(parents=True, exist_ok=True)

    def new_group(name: str):
        (store / name).unlink(missing_ok=True)
        distributed_init(f"file://{store / name}", 1, 0, device)
        return create_mesh(shape=(1, 1))

    t_phase = time.perf_counter()
    mesh = new_group("group_a")
    rec = {"backend": dist.get_backend(), "mesh": {"data": 1, "model": 1}}
    try:
        t0 = time.perf_counter()
        rec["train"] = parallel_train_check(mesh, device, seed, two_tower, steps, timed)
        rec["train_s"] = time.perf_counter() - t0
        rec["adamw_chunks"] = adamw_chunk_check(device, seed, two_tower, steps,
                                                adam_chunk, timer)
        torch.cuda.empty_cache()
        rec["merges"] = parallel_merge_check(mesh, paths, device, seed, merge_q,
                                             timer=timer)
        torch.cuda.empty_cache()
        rec["serve"] = parallel_serve_check(mesh, paths, device, seed, serve_users,
                                            timer=timer)
        torch.cuda.empty_cache()
        rec["ctr"] = parallel_ctr_check(mesh, device, seed, ctr, timed)
        with tempfile.TemporaryDirectory(dir=store) as ckpt:
            straight = mps.ctr_run(mesh, ckpt, 0)
            dist.destroy_process_group()
            mesh = new_group("group_b")
            at, resumed = mps.ctr_resume(mesh, ckpt, 0)
        rec["resume"] = {"straight": straight, "resumed_from": at, "resumed": resumed}
        if resumed != straight[at:]:
            raise AssertionError(f"resumed CTR losses {resumed} != {straight[at:]}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"parallel": rec, "card": card}), flush=True)
    tr = rec["train"]
    print(f"parallel world 1 ({card}): sharded two-tower step {tr['sharded_ms']:.3f} ms "
          f"({tr['sharded_examples_per_s']:.0f} ex/s) vs single-device "
          f"{tr['single_ms']:.3f} ms ({tr['single_examples_per_s']:.0f} ex/s); BPR "
          f"launches in {tr['steps']} steps {tr['launches']}; merges all-gather "
          f"{rec['merges']['allgather_ms']:.3f} / ring {rec['merges']['ring_ms']:.3f} / "
          f"mips_topk {rec['merges']['mips_topk_ms']:.3f} ms; serve "
          f"{rec['serve']['sharded_ms']:.3f} vs {rec['serve']['single_ms']:.3f} ms; "
          f"CTR step {rec['ctr']['sharded_ms']:.3f} ms", flush=True)
    for name, p in tr.get("profile", {}).items():
        print(f"parallel profile ({card}), {name} step: {p['host_ms_per_step']:.3f} ms "
              f"host clock, {p['device_us_per_step']:.1f} us of kernels in "
              f"{p['launches_per_step']:.1f} launches, idle {p['device_idle_share']:.1%}",
              flush=True)
    return rec


def adamw_chunk_check(device, seed: int, two_tower=PAR_TWO_TOWER,
                      steps: int = PAR_CHECK_STEPS, chunk: int = PAR_ADAM_CHUNK,
                      timer=cuda_ms) -> dict:
    """``OptaxAdamW.step`` (on the card one launch of ``csrc/adamw.cu``;
    elsewhere its foreach path, a ``chunk`` at a time) against its one-pass
    form (``_step_unchunked``) at the two-tower's params (``init_params`` at
    ``two_tower``'s widths), from the same params over ``steps`` steps of
    seeded gradients (the tables' rows 80 % zero, as a lookup's are):
    params, mu and nu bit-equal after each step; then ms a step of both
    (``timer``)."""
    from recommendit_tpu_torch.models.two_tower import init_params
    from recommendit_tpu_torch.training.train_embeddings import OptaxAdamW

    device = torch.device(device)
    n_users, n_items, dim, hidden, _ = two_tower
    start = init_params(torch.Generator().manual_seed(seed), n_users, n_items, dim,
                        hidden, device="cpu")
    names = list(start)
    decay = [k != "item_bias" for k in names]
    chunked = OptaxAdamW([start[k].to(device, copy=True) for k in names], decay, 1e-4,
                         chunk=chunk)
    one_pass = OptaxAdamW([start[k].to(device, copy=True) for k in names], decay, 1e-4)
    gen = torch.Generator(device=device).manual_seed(seed + 3)

    def grads():
        out = []
        for p in chunked.params:
            g = torch.randn(p.shape, generator=gen, device=device)
            if p.dim() == 2 and p.shape[0] > 1000:
                g *= torch.rand(p.shape[0], 1, generator=gen, device=device) < 0.2
            out.append(g)
        return out

    equal = []
    for _ in range(steps):
        g = grads()
        chunked.step(g, 1e-3)
        one_pass._step_unchunked(g, 1e-3)
        equal.append(all(torch.equal(a, b) for x, y in
                         ((chunked.params, one_pass.params), (chunked.mu, one_pass.mu),
                          (chunked.nu, one_pass.nu)) for a, b in zip(x, y)))
    rec = {"params": sum(p.numel() for p in chunked.params), "chunk": chunk,
           "groups": len(chunked.groups), "steps": steps, "bit_equal": equal}
    if not all(equal):
        raise AssertionError(f"the chunked AdamW step differs from the one-pass: {rec}")
    g = grads()
    rec["chunked_ms"] = timer(lambda: chunked.step(g, 1e-3), 5)
    rec["one_pass_ms"] = timer(lambda: one_pass._step_unchunked(g, 1e-3), 5)
    return rec


def shard_peak_bound_gib(rows: int, batch: int, dim: int, hidden: int) -> dict:
    """What a sharded two-tower step on the card may hold above its state
    (params, grads, two moments), in GiB, worked out from the shapes: the
    genre table on the card (``rows`` x 18 f32); the towers' activations,
    counted generously as 64 f32 tensors of (batch, max(dim, hidden)); two
    (batch, batch) f32 matrices of the loss. The optimizer adds nothing
    (one launch of ``csrc/adamw.cu``, no temporary) and the gradients are
    summed in place (nothing at one data rank)."""
    terms = {"genre_table": rows * 18 * 4,
             "tower_activations": 64 * batch * max(dim, hidden) * 4,
             "loss_matrices": 2 * batch * batch * 4}
    out = {k: v / 2**30 for k, v in terms.items()}
    out["bound"] = sum(terms.values()) / 2**30
    return out


def web100m_shard_rank(config: str, full: bool, row_cap: int, of_shards: int,
                       seed: int) -> dict:
    """The rank of the web100m_shard phase (a fresh process of its own):
    ``scale_smoke.train_shard`` on a (1, 1) mesh laid out as one rank of
    ``of_shards``, the BPR wrappers' counts set to 0 just before and read
    just after, with the optimizer kernel's (``adamw_launches``); then
    kernels 5 and 6 against their twins on the last step's gathered
    towers, the (B, D) the step gave them."""
    from recommendit_tpu_torch.ops import adamw, bpr
    from recommendit_tpu_torch.parallel import create_mesh
    from recommendit_tpu_torch.scripts.scale_smoke import train_shard

    mesh = create_mesh(shape=(1, 1))
    seen = {}

    def loss_fn(u, v):
        seen["u"], seen["v"] = u.detach(), v.detach()
        return bpr.in_batch_bpr_loss(u, v)

    _reset(bpr.LAUNCHES, adamw.LAUNCHES)
    rec = train_shard(mesh, config, full, row_cap, of_shards, loss_fn=loss_fn, seed=seed)
    rec["launches"] = dict(bpr.LAUNCHES)
    rec["adamw_launches"] = adamw.LAUNCHES["adamw_fused"]
    on_card = seen["u"].device.type == "cuda"
    rec["twins"] = bpr_pair_check(seen["u"], seen["v"], cuda_ms if on_card else None)
    return rec


def web100m_shard_phase(device, seed: int, card: str, run=SHARD_RUN, full: bool = True,
                        row_cap: int = 4096, timeout: float = SHARD_TIMEOUT_S) -> dict:
    """One rank of ``scale_smoke --config web100m --full --nproc 4`` on one
    card, in a fresh process (``parallel/launch.spawn``, one NCCL rank, so
    the allocator starts empty): ``make_sharded_train_step`` at web100m's
    widths over exactly the rows that rank holds (``run``: the
    configuration and the model axis). Checks: the step runs (an
    out-of-memory error fails the phase), every loss finite, kernels 5 and
    6 and the optimizer's kernel once each a step (none on the CPU), 5 and
    6 within the BPR phase's tolerances of their twins
    at the step's (B, D); on the card, the peak allocated
    (``torch.cuda.max_memory_allocated``) above the state (params, grads,
    two moments) within :func:`shard_peak_bound_gib`."""
    from recommendit_tpu_torch.parallel.launch import spawn
    from recommendit_tpu_torch.scripts.scale_smoke import CONFIGS

    config, of_shards = run
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    rec = spawn(web100m_shard_rank, 1, (config, full, row_cap, of_shards, seed),
                device=torch.device(device).type, timeout=timeout)[0]
    rec["seconds"] = time.perf_counter() - t0
    _, _, dim, hidden, _, _ = CONFIGS[config]
    rec["peak_bound_gib"] = shard_peak_bound_gib(rec["items"] + 1, rec["batch"], dim,
                                                 hidden)
    if on_card:
        rec["peak_over_state_gib"] = rec["peak_gib"] - rec["state_gib"]
    print(json.dumps({"web100m_shard": rec, "card": card}), flush=True)
    steps = len(rec["losses"])
    if not np.isfinite(rec["losses"]).all():
        raise AssertionError(f"web100m_shard: non-finite losses {rec['losses']}")
    want = steps if on_card else 0
    if rec["launches"] != {"bpr_fwd": want, "bpr_bwd": want}:
        raise AssertionError(f"web100m_shard: launches {rec['launches']}, expected "
                             f"{want} of each BPR kernel ({steps} steps)")
    if rec["adamw_launches"] != want:
        raise AssertionError(f"web100m_shard: {rec['adamw_launches']} launches of the "
                             f"optimizer's kernel, expected {want} ({steps} steps)")
    check_bpr_pair(rec["twins"])
    if on_card and not rec["peak_over_state_gib"] <= rec["peak_bound_gib"]["bound"]:
        raise AssertionError(
            f"web100m_shard: peak {rec['peak_gib']:.3f} GiB is "
            f"{rec['peak_over_state_gib']:.3f} GiB over the state, above the bound "
            f"{rec['peak_bound_gib']}")
    if on_card:
        print(f"web100m_shard ({card}): {rec['user_rows']:,} + {rec['item_rows']:,} rows "
              f"of {of_shards} shards, state {rec['state_gib']:.3f} GiB, peak "
              f"{rec['peak_gib']:.3f} GiB ({rec['peak_over_state_gib']:.3f} over, bound "
              f"{rec['peak_bound_gib']['bound']:.3f}); {rec['step_ms']:.1f} ms a step; "
              f"BPR launches {rec['launches']} in {steps} steps", flush=True)
    return rec


def web100m_shard_shapes(run=SHARD_RUN) -> dict:
    """The shape of each param of one rank of ``run`` (configuration,
    model shards), in ``scale_smoke.train_shard``'s order: the towers, the
    item bias at every row, the rank's user and item table shards."""
    from recommendit_tpu_torch.models.two_tower import init_params
    from recommendit_tpu_torch.scripts.scale_smoke import CONFIGS, padded_rows

    config, of_shards = run
    n_users, n_items, dim, hidden, _, _ = CONFIGS[config]
    users, items = padded_rows(n_users, of_shards), padded_rows(n_items, of_shards)
    towers = init_params(torch.Generator().manual_seed(0), 1, 1, dim, hidden, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in towers.items()
              if not k.endswith("_embed") and k != "item_bias"}
    shapes["item_bias"] = (items + 1,)
    shapes["user_embed"] = ((users + 1) // of_shards, dim)
    shapes["item_embed"] = ((items + 1) // of_shards, dim)
    return shapes


def _launch_groups(opt, big: int = 1 << 31) -> list:
    """The ``chunk_groups`` groups of ``opt`` that hold the last element of
    a param, or element ``big`` (2^31: past 32-bit offsets) of one."""
    out = []
    for gi, group in enumerate(opt.groups):
        for i, a, b, _ in group:
            p = opt.params[i]
            row = math.prod(p.shape[1:])
            if b * row == p.numel() or a * row <= big < b * row:
                out.append(gi)
                break
    return out


def adamw_fused_rank(shapes: dict, seed: int, reps: int, plain_reps: int) -> dict:
    """The rank of the adamw_fused phase (a fresh process of its own): an
    ``OptaxAdamW`` over params of ``shapes`` (weight decay 1e-4 on every
    param, as the sharded step's) with random params and gradients drawn on
    the device, the clip's factors from ``sharded_global_norm`` (the tables
    as shards) at 1.0. Bit-equality of a step, twice: group by group
    (``chunk_groups``), the foreach update (``clip_`` + ``_adamw_update``)
    of a copy of the group's params and moments against the kernel's
    (``adamw_fused_`` on the group's row ranges); then ``OptaxAdamW.step``
    as the sharded step makes it, one launch over the whole tensors
    (launches counted), against the foreach update of copies of the groups
    of :func:`_launch_groups` (each param's last rows, and where a param
    passes 2^31 elements the rows around element 2^31). On the CPU the
    step is the foreach path on both sides. ``max_abs_err``: the largest
    difference of any compared element. Then, by CUDA events, ms a step of
    ``OptaxAdamW.step`` (the kernel), of its foreach path
    ``_step_foreach``, of the norm with the factors, and of PyTorch's own
    fused AdamW (``torch._fused_adamw_``, no clip) over the foreach path's
    row ranges (``library_ms``)."""
    import torch.distributed as dist

    from recommendit_tpu_torch.ops import adamw
    from recommendit_tpu_torch.parallel.mesh import sharded_global_norm
    from recommendit_tpu_torch.training.train_embeddings import (
        ADAM_B1,
        ADAM_B2,
        ADAM_EPS,
        OptaxAdamW,
        _adamw_update,
        clip_,
        clip_factors,
    )

    on_card = dist.get_backend() == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    names = list(shapes)
    params = [0.1 * torch.randn(shapes[k], generator=gen, device=dev) for k in names]
    grads = [torch.randn(shapes[k], generator=gen, device=dev) for k in names]
    opt = OptaxAdamW(params, [True] * len(names), 1e-4)
    sharded = [k.endswith("_embed") for k in names]

    def factors():
        return clip_factors(sharded_global_norm(grads, sharded, dist.group.WORLD), 1.0)

    def views(group):
        return [[t[i] if whole else t[i][a:b] for i, a, b, whole in group]
                for t in (opt.params, grads, opt.mu, opt.nu)]

    def compare(got, want) -> tuple:
        """(bit-equal, largest difference) of p, m, v against ``want``'s."""
        pairs = [(x, y) for k in (0, 2, 3) for x, y in zip(got[k], want[k])]
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in pairs)
        err = max(float((x - y).abs().max()) for x, y in pairs if x.numel())
        return same, err

    clip = factors()
    s = opt._scalars(1e-3)
    equal, errs = [], []
    for group, decayed in zip(opt.groups, opt._group_decayed):
        got = views(group)
        want = [[x.clone() for x in xs] for xs in got]
        clip_(want[1], clip)
        _adamw_update(*want, decayed, opt.weight_decay, s)
        p, g, m, v = got
        if on_card:
            adamw.adamw_fused_(p, g, m, v, [True] * len(p), s, opt.weight_decay,
                               ADAM_EPS, clip)
        else:
            g = [x.clone() for x in g]
            clip_(g, clip)
            _adamw_update(p, g, m, v, decayed, opt.weight_decay, s)
        same, err = compare(got, want)
        equal.append(same)
        errs.append(err)
        del want
    # the step as the sharded step makes it, held against copies of a few
    # groups updated by the foreach path
    picked = _launch_groups(opt)
    wants = [[[x.clone() for x in xs] for xs in views(opt.groups[gi])] for gi in picked]
    s = opt._scalars(1e-3)
    opt.count -= 1                       # the step below advances it again
    before = adamw.LAUNCHES["adamw_fused"]
    opt.step(grads, 1e-3, clip=clip)
    launches = adamw.LAUNCHES["adamw_fused"] - before
    launch_equal = []
    for gi, want in zip(picked, wants):
        clip_(want[1], clip)
        _adamw_update(*want, opt._group_decayed[gi], opt.weight_decay, s)
        same, err = compare(views(opt.groups[gi]), want)
        launch_equal.append(same)
        errs.append(err)
    del wants
    rec = {"shapes": {k: list(v) for k, v in shapes.items()},
           "numel": sum(p.numel() for p in params), "groups": len(opt.groups),
           "bit_equal_groups": sum(equal), "launch_groups": picked,
           "launch_bit_equal_groups": sum(launch_equal),
           "bit_equal": all(equal) and all(launch_equal), "max_abs_err": max(errs),
           "route": "cuda" if adamw.on_card({"param": params, "gradient": grads,
                                             "clip factor": clip}) else "foreach",
           "launches": launches}
    if on_card:
        rec["kernel_ms"] = cuda_ms(lambda: opt.step(grads, 1e-3, clip=clip), reps)
        # the foreach path clips the gradients in place: from here they shrink
        rec["foreach_ms"] = cuda_ms(lambda: opt._step_foreach(grads, 1e-3, clip), plain_reps)
        rec["norm_ms"] = cuda_ms(factors, reps)
        lib = [[], [], [], []]
        for group in opt.groups:
            for xs, ys in zip(lib, views(group)):
                xs.extend(ys)
        steps = [torch.ones((), device=dev) for _ in lib[0]]
        rec["library_ms"] = cuda_ms(lambda: torch._fused_adamw_(
            *lib, [], steps, lr=1e-3, beta1=ADAM_B1, beta2=ADAM_B2,
            weight_decay=opt.weight_decay, eps=ADAM_EPS, amsgrad=False,
            maximize=False), reps)
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return rec


def adamw_fused_phase(device, seed: int, card: str, shapes=None, reps: int = ADAMW_REPS,
                      plain_reps: int = ADAMW_PLAIN_REPS,
                      timeout: float = SHARD_TIMEOUT_S) -> dict:
    """The optimizer's one-pass kernel (``csrc/adamw.cu``) at one web100m
    rank's exact params (``web100m_shard_shapes``; ``shapes`` to override)
    in a fresh process (one NCCL rank, the allocator empty):
    :func:`adamw_fused_rank`. Checks: every group bit-equal to the foreach
    path, by row ranges and after the step's one launch over the whole
    tensors; on the card one launch a step and the kernel's time at or
    above its bound, 28 bytes an element (p, g, m, v read; p, m, v
    written)."""
    from recommendit_tpu_torch.parallel.launch import spawn

    shapes = web100m_shard_shapes() if shapes is None else shapes
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    rec = spawn(adamw_fused_rank, 1, (shapes, seed, reps, plain_reps),
                device=torch.device(device).type, timeout=timeout)[0]
    rec["seconds"] = time.perf_counter() - t0
    rec["bound_ms"], rec["bound_by"] = bound(28 * rec["numel"])
    print(json.dumps({"adamw_fused": rec, "card": card}), flush=True)
    if not rec["bit_equal"]:
        picked = len(rec["launch_groups"])
        raise AssertionError(
            f"adamw_fused: {rec['groups'] - rec['bit_equal_groups']} of {rec['groups']} "
            f"groups by row ranges and {picked - rec['launch_bit_equal_groups']} of "
            f"{picked} after the whole launch differ from the foreach path (max abs "
            f"err {rec['max_abs_err']})")
    if rec["launches"] != (1 if on_card else 0):
        raise AssertionError(f"adamw_fused: {rec['launches']} launches in a step")
    if on_card:
        print(f"adamw_fused ({card}): {rec['numel']:,} elements, {rec['kernel_ms']:.3f} ms "
              f"a step ({100 * rec['bound_ms'] / rec['kernel_ms']:.1f} % of the bound "
              f"{rec['bound_ms']:.3f}), foreach {rec['foreach_ms']:.3f} ms, torch's fused "
              f"AdamW {rec['library_ms']:.3f} ms, norm {rec['norm_ms']:.3f} ms; every group "
              f"bit-equal, {len(rec['launch_groups'])} of them after the whole launch",
              flush=True)
    return rec


# the dlrm_bags phase: DLRM-DCNv2's id block at the benchmark cell's shape
# (one card's rows of a four-card host, 16,384 examples, Zipf(1.05) ids)
DLRM_BATCH = 16384
DLRM_ZIPF_S = 1.05
DLRM_REPS = 10
DLRM_STEPS = 5            # dcn_step calls counted


def dlrm_rows(published, shards: int = 4, whole_below: int = 65536):
    """One card's rows of each table, split by rows over ``shards`` cards
    above ``whole_below`` rows (torchrec's row-wise sharding)."""
    return tuple(v if v <= whole_below else -(-v // shards) for v in published)


def _update_pair(table, acc, ids, grad, lay, uniq, inv) -> dict:
    """The update (``bag_adagrad_``: the sort, then the two kernels) against
    the plain update of the touched rows, copied out and addressed by their
    place among the distinct ids: the accumulators' and the steps' changes
    by norm, and whether every row that one slot names comes out bit-equal
    (its gradient is one slot's, summed in no order)."""
    from recommendit_tpu_torch.ops import embedding_bag as eb

    t_rows, a_rows = table[uniq], acc[uniq]
    w0, a0 = t_rows.clone(), a_rows.clone()
    eb.bag_adagrad_(table, acc, ids, grad, lay, 0.005, 1e-8)
    eb.bag_adagrad_plain_(t_rows, a_rows, inv.view(ids.shape), grad, lay, 0.005, 1e-8)
    once = torch.bincount(inv) == 1
    return {"acc_rel_err": float((acc[uniq] - a_rows).norm() / (a_rows - a0).norm()),
            "acc_max_rel_err": float(((acc[uniq] - a_rows).abs()
                                      / (a_rows - a0).abs().clamp(min=1e-30)).max()),
            "step_rel_err": float((table[uniq] - t_rows).norm() / (t_rows - w0).norm()),
            "rows_once": int(once.sum()),
            "once_equal": bool(torch.equal(table[uniq][once], t_rows[once])
                               and torch.equal(acc[uniq][once], a_rows[once]))}


def dlrm_bags_rank(vocab, bags, dim: int, batch: int, seed: int, reps: int,
                   steps: int = DLRM_STEPS) -> dict:
    """The dlrm_bags phase's work (a fresh process of its own, or here on
    the CPU): a (Σ rows, dim) table, one Zipf id block (the benchmark
    cell's draw), a pooled gradient. ``bag_fwd_kernel`` against the plain
    sum, bit for bit. The update against the plain update (:func:`_update_pair`)
    twice: from a warm accumulator, U[0.5, 1.5) (``warm``), and from zero,
    the published run's start (``zero``: Adagrad's first step is then
    lr · g / (|g| + eps), sign-like where the summed g nears 0, so the steps
    compare by norm and the rows one slot names bit for bit). Then, by CUDA
    events, ms a call: the kernel, the plain sum and ``F.embedding_bag``
    (the library yardstick); the update, its sort alone, and the plain
    update. Last, the model's own path: a ``DCNState`` of DLRM-DCNv2's
    widths over the same table, one ``dcn_step`` to warm, then ``steps``
    steps with the launch counters set to 0 just before and, on the card,
    any call that waits for the host an error
    (``torch.cuda.set_sync_debug_mode``): their launches of each kernel,
    ms a step, and the device count of rows updated."""
    import dataclasses

    from perfbench.ctr_inputs import batches
    from recommendit_tpu_torch.models.ctr import DLRM_DCNV2, init_dcn_params
    from recommendit_tpu_torch.ops import embedding_bag as eb
    from recommendit_tpu_torch.training.train_ctr import DCNState, dcn_step

    dev = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    lay = eb.BagLayout(tuple(vocab), tuple(bags))
    table = torch.randn((lay.rows, dim), generator=gen, device=dev)
    acc = torch.rand((lay.rows, dim), generator=gen, device=dev) + 0.5
    # the benchmark cell's id draw (Zipf over a permutation of each field's rows)
    (dense, ids, labels), = batches(
        {"vocab_sizes": vocab, "bag_sizes": bags, "dense_in": 13},
        {"batch": batch, "pool": 1, "ids": {"s": DLRM_ZIPF_S}, "dense": {"mean": 10.0},
         "click_rate": 0.25}, seed, dev)
    grad = torch.randn((batch, lay.n_fields, dim), generator=gen, device=dev)
    uniq, inv = torch.unique(ids.reshape(-1).long(), return_inverse=True)
    out = eb.pool_bags(table, ids, lay)
    want = eb.pool_bags_plain(table, ids.long(), lay)
    rec = {"rows": lay.rows, "dim": dim, "batch": batch, "slots": lay.slots,
           "fields": lay.n_fields, "unique_rows": uniq.numel(),
           "hottest_row_hits": int(torch.bincount(inv).max()),
           "fwd_equal": bool(torch.equal(out, want)),
           "fwd_max_abs_err": float((out - want).abs().max()),
           "route": "cuda" if dev.type == "cuda" else "plain"}
    del out, want
    rec["warm"] = _update_pair(table, acc, ids, grad, lay, uniq, inv)
    acc.zero_()
    rec["zero"] = _update_pair(table, acc, ids, grad, lay, uniq, inv)
    if dev.type == "cuda":
        offsets = (torch.arange(batch, device=dev)[:, None] * lay.slots
                   + torch.as_tensor(lay.bag_start[:-1], device=dev)[None, :]).reshape(-1)
        flat = ids.reshape(-1).long()
        rec["fwd_ms"] = cuda_ms(lambda: eb.pool_bags(table, ids, lay), reps)
        rec["fwd_plain_ms"] = cuda_ms(lambda: eb.pool_bags_plain(table, ids.long(), lay), 2)
        rec["fwd_library_ms"] = cuda_ms(lambda: torch.nn.functional.embedding_bag(
            flat, table, offsets, mode="sum"), reps)
        rec["update_ms"] = cuda_ms(lambda: eb.bag_adagrad_(table, acc, ids, grad, lay, 0.005,
                                                           1e-8), reps)
        rec["sort_ms"] = cuda_ms(lambda: torch.sort(ids.reshape(-1), stable=True), reps)
        rec["update_plain_ms"] = cuda_ms(lambda: eb.bag_adagrad_plain_(
            table, acc, ids, grad, lay, 0.005, 1e-8), 2)
        del offsets, flat
    del acc, grad, uniq, inv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the model's own path over the same table
    arch = dataclasses.replace(DLRM_DCNV2, vocab_sizes=tuple(vocab), bag_sizes=tuple(bags),
                               embed_dim=dim)
    params = init_dcn_params(torch.Generator().manual_seed(seed),
                             dataclasses.replace(arch, vocab_sizes=(1,) * lay.n_fields), dev)
    params["embed"] = table
    state = DCNState(params, arch)
    dcn_step(state, dense, ids, labels)
    syncs = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    for k in eb.LAUNCHES:
        eb.LAUNCHES[k] = 0
    try:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        for _ in range(steps):
            dcn_step(state, dense, ids, labels)
        syncs = 0 if dev.type == "cuda" else None
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        syncs = str(e).splitlines()[0]
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    rec["steps"] = steps
    rec["step_launches"] = dict(eb.LAUNCHES)
    rec["step_syncs"] = syncs
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        rec["step_ms"] = start.elapsed_time(end) / steps
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    rec["step_rows_updated"] = int(state.rows_updated)
    return rec


def dlrm_bags_phase(device, seed: int, card: str, vocab=None, bags=None, dim: int = 128,
                    batch: int = DLRM_BATCH, reps: int = DLRM_REPS,
                    timeout: float = SHARD_TIMEOUT_S) -> dict:
    """DLRM-DCNv2's two kernels (``csrc/embedding_bag.cu``) at the
    benchmark cell's shape (``models/ctr.DLRM_DCNV2``'s bags and widths
    over one card's rows of a four-card host: 51,137,046 x 128, 16,384
    examples) in a fresh process: :func:`dlrm_bags_rank`. Checks: the
    forward bit-equal to the plain sum; the update's accumulators' and
    steps' changes within 1e-4 by norm of the plain update's, from a warm
    accumulator and from zero (f32 sums of up to ~140,000 terms in another
    order; ``acc_max_rel_err``, the worst element, is recorded), and the
    rows one slot names bit-equal; in ``steps`` calls of ``dcn_step``, the
    model's path, one launch of each kernel a step and no wait for the
    host, the counter of rows updated equal to the distinct ids a step; on
    the card every time at or above its bound (the bytes of
    ``perfbench/metrics/bag_*_roofline.py``)."""
    from recommendit_tpu_torch.models.ctr import DLRM_DCNV2
    from recommendit_tpu_torch.parallel.launch import spawn

    vocab = dlrm_rows(DLRM_DCNV2.vocab_sizes) if vocab is None else vocab
    bags = DLRM_DCNV2.bag_sizes if bags is None else bags
    t0 = time.perf_counter()
    rec = spawn(dlrm_bags_rank, 1, (tuple(vocab), tuple(bags), dim, batch, seed, reps),
                device=torch.device(device).type, timeout=timeout)[0]
    rec["seconds"] = time.perf_counter() - t0
    check_dlrm_bags(rec, torch.device(device).type == "cuda")
    print(json.dumps({"dlrm_bags": rec, "card": card}), flush=True)
    return rec


def check_dlrm_bags(rec: dict, on_card: bool) -> None:
    """Add the bounds to a dlrm_bags record and raise where it fails."""
    b, s, d, u = rec["batch"], rec["slots"], rec["dim"], rec["unique_rows"]
    n_fields = rec["fields"]
    rec["fwd_bound_ms"], rec["fwd_bound_by"] = bound(4.0 * (u * d + b * s + b * n_fields * d))
    rec["update_bound_ms"], rec["update_bound_by"] = bound(
        4.0 * (b * n_fields * d + b * s + 4 * u * d))
    # the sort: the keys and their positions read and written once
    rec["sort_bound_ms"], _ = bound(2.0 * b * s * (4 + 8))
    n = rec["steps"]
    bad = []
    if not rec["fwd_equal"]:
        bad.append(f"the pooled bags differ from the plain sum by {rec['fwd_max_abs_err']}")
    for start in ("warm", "zero"):
        r = rec[start]
        if not (r["acc_rel_err"] <= 1e-4 and r["step_rel_err"] <= 1e-4):
            bad.append(f"the update from a {start} accumulator differs from the plain one: "
                       f"accumulators {r['acc_rel_err']}, steps {r['step_rel_err']}")
        if not r["once_equal"]:
            bad.append(f"the {r['rows_once']} rows one slot names differ from the plain "
                       f"update from a {start} accumulator")
    want = {"bag_fwd": n, "bag_update": n} if on_card else {"bag_fwd": 0, "bag_update": 0}
    if rec["step_launches"] != want:
        bad.append(f"launches {rec['step_launches']} in {n} dcn_step calls, not {want}")
    if on_card and rec["step_syncs"] != 0:
        bad.append(f"dcn_step waited for the host: {rec['step_syncs']}")
    if rec["step_rows_updated"] != (n + 1) * u:
        bad.append(f"{rec['step_rows_updated']} rows counted in {n + 1} steps of {u}")
    if bad:
        raise AssertionError("dlrm_bags: " + "; ".join(bad))


# 5,000 evaluation users, not the script's 500: at 1M ratings over 162,541
# users the retrieval-only NDCG@10 of 500 users reads near 0.0002 (a random
# ranking's 0.0), too near zero to hold the two apart reliably
QUALITY_ARGS = ("--ratings", "1000000", "--epochs", "1", "--eval-users", "5000",
                "--cfg", "LOSS_MODE=in_batch", "--cfg", "INDEX_MODE=fused",
                "--cfg", "INDEX_DTYPE=bfloat16", "--cfg", "RANKER_EPOCHS=3",
                "--cfg", "RANKER_MAX_QUERIES=2000", "--nproc", "1")
# the cuts of depth against the scripts' defaults (the widths are theirs)
QUALITY_CUTS = {"quality_at_scale": {"ratings": "1,000,000 of 4,000,000",
                                     "eval_users": "5,000 (the default 500)",
                                     "epochs": "1 of 10", "RANKER_EPOCHS": "3 of 40",
                                     "RANKER_MAX_QUERIES": "2,000 of 8,000"},
                "ranker_ab": {"TRAIN_EPOCHS": "1 of 5", "RANKER_EPOCHS": "3 of 40",
                              "RANKER_MAX_QUERIES": "2,000 of 20,000"},
                "seed_variance": {"seeds": "2 of 3", "epochs": "2 of 60"}}
QUALITY_AB_ARGS = ("--name", "smoke", "--betas", "1,2", "--eval-users", "500",
                   "--cfg", "LOSS_MODE=in_batch", "--cfg", "TRAIN_EPOCHS=1",
                   "--cfg", "RANKER_EPOCHS=3", "--cfg", "RANKER_MAX_QUERIES=2000")
SEEDVAR_ARGS = ("--seeds", "2", "--epochs", "2")
SERVE_BATCH = 256                  # batch_recommend's batch of users
C58_SHAPE = (20_000_000, 128, 1024)  # corpus rows, width, queries
C58_K = 500
C58_CHECK_Q = 16                   # queries held against _scan_topk
C58_SCAN_BLOCK = 1 << 16


class _SeenRows:
    """The train view's (user, item) pairs of ``users``, read as
    ``seen[u, cols]`` reads a dense (users + 1, items + 1) mask (what
    :func:`check_eval_lists` takes), one user's row made at a time: the
    dense mask of the ml25m catalog would take 10 GB."""

    def __init__(self, view, users, n_items: int):
        wanted = np.isin(view.user_id, list(users))
        self.n_items, self.items = n_items, {}
        for u, i in zip(view.user_id[wanted].tolist(), view.item_id[wanted].tolist()):
            self.items.setdefault(u, []).append(i)

    def __getitem__(self, key):
        u, cols = key
        row = np.zeros(self.n_items + 1, dtype=bool)
        row[np.asarray(self.items.get(u, []), dtype=np.int64)] = True
        return row[cols]


def quality_kernel_check(orch, device):
    """Kernel 1 against its twins on the quality run's own fused index and
    the evaluate stage's user-tower queries, at both shapes the stage gave
    it: one ``batch_recommend`` batch (the first ``SERVE_BATCH`` evaluated
    users) and the retrieval-only search (every evaluated user), each with
    the window and block the router picks for it, held to
    :func:`kernel_phase`'s tolerances. On the card both shapes must take
    the kernel route; on the CPU a shape the router sends elsewhere is
    recorded and not compared. → one record per shape."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import mips_window as mw

    model = TwoTower.load(orch.cfg.EMBEDDING_MODEL_PATH, device=device)
    index = MIPSIndex.load(orch.cfg.INDEX_PATH, device=device)
    corpus, n_valid = index._embs, index.n_total
    k = min(orch.cfg.TOP_K_CANDIDATES, n_valid)
    users = list(orch.eval_lists["retrieval_only"])
    on_card = torch.device(device).type == "cuda"
    out = []
    for shape, batch in (("batch_recommend", users[:SERVE_BATCH]),
                         ("retrieval_only", users)):
        route, window = mw.fused_route(len(batch), n_valid, k)
        rec = {"shape": shape, "q": len(batch), "n": n_valid, "k": k,
               "route": route, "window": window}
        out.append(rec)
        if route != "kernel":
            if on_card:
                raise AssertionError(f"the quality index's {shape} search took the "
                                     f"{route} route: {rec}")
            continue
        block = max(window, index.block_size - index.block_size % window)
        with torch.no_grad():
            q = index._augment(model.user_tower(torch.as_tensor(batch, device=device)))
            kv, _ = mw.window_candidates(q, corpus, window, n_valid)
            rv, _ = mw.window_candidates_ref(q, corpus, window, n_valid)
            v, i = mw.mips_topk_window_im(q, corpus, k, block, window, n_valid=n_valid)
            tv, ti = mw.mips_topk_window_im_ref(q, corpus, k, block, window,
                                                n_valid=n_valid)
        rec.update(block=block, window_max_abs_err=float((kv - rv).abs().max()),
                   topk_value_abs_err=float((v - tv).abs().max()),
                   id_overlap_vs_twin=_overlap(i, ti))
        if not (rec["window_max_abs_err"] <= 1e-3 and rec["topk_value_abs_err"] <= 1e-3
                and rec["id_overlap_vs_twin"] >= 0.99):
            raise AssertionError(f"kernel 1 against its twins on the quality index: {rec}")
    return out


class _Orchestrators:
    """The ``PipelineOrchestrator`` instances the scripts make while
    installed (``orchs``)."""

    def __enter__(self):
        from recommendit_tpu_torch.pipelines import run_pipeline

        self.mod, self.cls, self.orchs = run_pipeline, run_pipeline.PipelineOrchestrator, []
        outer = self

        class Recorded(self.cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                outer.orchs.append(self)

        run_pipeline.PipelineOrchestrator = Recorded
        return self

    def __exit__(self, *exc):
        self.mod.PipelineOrchestrator = self.cls


class _HostTrainings:
    """The steps of every ``HostTableEmbeddingTrainer.train`` call while
    installed (``steps``)."""

    def __enter__(self):
        from recommendit_tpu_torch.training.host_train import HostTableEmbeddingTrainer

        self.cls, self.train, self.steps = (HostTableEmbeddingTrainer,
                                            HostTableEmbeddingTrainer.train, [])
        outer = self

        def train(trainer, *a, **k):
            out = outer.train(trainer, *a, **k)
            outer.steps.append(sum(h["steps"] for h in trainer.history))
            return out

        self.cls.train = train
        return self

    def __exit__(self, *exc):
        self.cls.train = self.train


class _AdamWSteps:
    """Every ``OptaxAdamW.step`` call while installed, by the device of its
    params (``steps``: {"cuda": n, "cpu": n}), and the optimizer kernel's
    launches, its wrapper's count set to 0 on entry (``launches``). On
    leaving without an error it checks one launch a step on the card and
    none on the CPU, and at least one step on the card where ``on_card``:
    a trainer whose step left the kernel would fail here."""

    def __init__(self, name: str, on_card: bool):
        self.name, self.on_card = name, on_card

    def __enter__(self):
        from recommendit_tpu_torch.ops import adamw
        from recommendit_tpu_torch.training.train_embeddings import OptaxAdamW

        self.counts, self.cls, self.step = adamw.LAUNCHES, OptaxAdamW, OptaxAdamW.step
        self.steps = {"cuda": 0, "cpu": 0}
        outer = self

        def step(opt, *a, **k):
            kind = opt.params[0].device.type if opt.params else "cpu"
            outer.steps[kind] = outer.steps.get(kind, 0) + 1
            return outer.step(opt, *a, **k)

        _reset(self.counts)
        self.cls.step = step
        return self

    def __exit__(self, exc_type, *exc):
        self.cls.step = self.step
        self.launches = self.counts["adamw_fused"]
        if exc_type is None and (self.launches != self.steps["cuda"]
                                 or (self.on_card and not self.steps["cuda"])):
            raise AssertionError(f"{self.name}: {self.launches} launches of the optimizer's "
                                 f"kernel in {self.steps} OptaxAdamW steps by device; "
                                 f"expected one a step on the card")

    def record(self) -> dict:
        return {"steps": self.steps, "launches": self.launches}


class _WindowLaunches:
    """A window kernel's launches (its wrapper's count; kernel 1's unless
    ``kernel`` names another) inside each call of the wrapped methods of
    the fused index's users while installed. By default the evaluate
    stage's three: ``RecommendationPipeline._build_serve_fn`` (its warm-up
    serve and the 15 + 15 serves of ``recalibrate_stage_split``),
    ``batch_recommend`` (one batch of ``SERVE_BATCH`` users a launch) and
    ``MIPSIndex.batch_search`` (the retrieval-only row: one launch over a
    fused index; the ranker stage's exact indexes none); ``methods`` may
    name ``MIPSIndex.search_device`` instead (one launch a call of at least
    384 queries over a fused index). Over an exact index none of them
    launches it. ``calls`` holds (method, launches, users, index mode) per
    call."""

    EVALUATE_METHODS = ("_build_serve_fn", "batch_recommend", "batch_search")

    def __init__(self, kernel: str = "window_mips", methods=EVALUATE_METHODS):
        self.kernel, self.methods = kernel, methods

    def __enter__(self):
        from recommendit_tpu_torch.models.retrieval import MIPSIndex
        from recommendit_tpu_torch.ops import mips_window as mw
        from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

        owners = {"_build_serve_fn": RecommendationPipeline,
                  "batch_recommend": RecommendationPipeline,
                  "batch_search": MIPSIndex, "search_device": MIPSIndex}
        self.calls, self._saved = [], []
        for name in self.methods:
            cls = owners[name]
            raw = cls.__dict__[name]
            self._saved.append((cls, name, raw))
            setattr(cls, name, self._wrap(name, raw, mw.LAUNCHES))
        return self

    def _wrap(self, name, fn, launches):
        calls, kernel = self.calls, self.kernel

        def wrapped(obj, *a, **k):
            before = launches[kernel]
            out = fn(obj, *a, **k)
            users = len(a[0]) if a else 0
            # an index's mode, or a pipeline's index's
            mode = getattr(obj, "mode", None) or getattr(
                getattr(obj, "index", None), "mode", None)
            calls.append((name, launches[kernel] - before, users, mode))
            return out

        return wrapped

    def __exit__(self, *exc):
        for cls, name, raw in self._saved:
            setattr(cls, name, raw)

    def check(self, label: str, total: int, on_card: bool) -> dict:
        """Each call's launches as its code makes them, and no launch
        outside them; → launches by method."""
        want = {"_build_serve_fn": lambda u: 31,
                "batch_recommend": lambda u: -(-u // SERVE_BATCH),
                "batch_search": lambda u: 1, "search_device": lambda u: 1}
        by = {}
        for name, got, users, mode in self.calls:
            exp = want[name](users) if on_card and mode == "fused" else 0
            if got != exp:
                raise AssertionError(f"{label}: {name} on {users} users launched "
                                     f"{self.kernel} {got} times, expected {exp}")
            by[name] = by.get(name, 0) + got
        if sum(by.values()) != total:
            raise AssertionError(f"{label}: {total} launches of {self.kernel}, {by} "
                                 f"in the calls of {self.methods}")
        return by


def _reset(*tables):
    for table in tables:
        for name in table:
            table[name] = 0


def _script_run(fn, device):
    """``fn()`` with the BPR and window wrappers' counts set to 0 just
    before and read just after, the tower trainings' and the host-table
    trainings' steps and the orchestrators it made → (result, record)."""
    from recommendit_tpu_torch.ops import bpr
    from recommendit_tpu_torch.ops import mips_window as mw

    _reset(bpr.LAUNCHES, mw.LAUNCHES)
    t0 = time.perf_counter()
    with _TowerTrainings(device, profile=False) as towers, _HostTrainings() as host, \
            _Orchestrators() as orchs, _WindowLaunches() as window:
        out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    steps = sum(host.steps) + sum(r["steps"] for r in towers.runs)
    rec = {"seconds": time.perf_counter() - t0, "host_steps": host.steps,
           "tower_steps": [r["steps"] for r in towers.runs],
           "launches": {**bpr.LAUNCHES, "window_mips": mw.LAUNCHES["window_mips"]}}
    evals = [o for o in orchs.orchs if "evaluate" in o.stage_times]
    return out, rec, steps, evals, window


def _check_script_launches(name, rec, steps, window, on_card):
    """One launch of each BPR kernel a tower step, and kernel 1's launches
    each as the evaluate stage's calls make them (:class:`_WindowLaunches`),
    on the card; none on the CPU."""
    want = {"bpr_fwd": steps, "bpr_bwd": steps} if on_card else {"bpr_fwd": 0,
                                                                 "bpr_bwd": 0}
    got = {k: rec["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want} "
                             f"({steps} tower steps)")
    rec["window_by_call"] = window.check(name, rec["launches"]["window_mips"], on_card)
    if on_card and not rec["window_by_call"].get("batch_recommend"):
        raise AssertionError(f"{name}: no evaluate batch launched the window kernel")


def exact_topk_memory_check(device, seed: int, shape=C58_SHAPE, k: int = C58_K,
                            n_check: int = C58_CHECK_Q, timer=cuda_ms):
    """Exact ``mips_topk`` at Q queries over N x D f32 unit rows, where one
    (Q, N) product would not fit: the peak memory above the corpus under
    two chunks' scores (``_SCORE_BUDGET`` f32 entries each), and
    ``n_check`` queries' values and ids equal to ``_scan_topk`` at
    "highest" up to ties (ids may differ only where the values are equal)."""
    from recommendit_tpu_torch.ops import topk

    n, d, n_q = shape
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed + 58)
    items = torch.empty((n, d), device=dev)
    for s in range(0, n, CAPACITY_CHUNK):
        rows = torch.randn((min(CAPACITY_CHUNK, n - s), d), generator=gen, device=dev)
        items[s:s + len(rows)] = torch.nn.functional.normalize(rows, dim=1)
    q = torch.nn.functional.normalize(
        torch.randn((n_q, d), generator=gen, device=dev), dim=1)
    del rows
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    vals, ids = topk.mips_topk(q, items, k, 4096)
    if on_card:
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) if on_card else 0
    budget = 2 * topk._SCORE_BUDGET * 4
    rec = {"n": n, "d": d, "q": n_q, "k": k, "first_call_s": first_s,
           "peak_above_corpus_bytes": peak, "limit_bytes": budget,
           "one_product_bytes": n * n_q * 4,
           "chunks": -(-n // topk._score_chunk(n_q))}
    if on_card and not peak < budget:
        raise AssertionError(f"exact top-k peak {peak} bytes above the corpus, "
                             f"limit {budget}")
    sv, si = topk._scan_topk(q[:n_check], items, k, C58_SCAN_BLOCK, 1.0, "highest")
    gv, gi = vals[:n_check], ids[:n_check]
    ties_only = bool(((gi == si) | (gv == sv)).all())
    rec.update(values_equal=bool(torch.equal(gv, sv)), ids_equal_up_to_ties=ties_only,
               id_mismatches_at_ties=int((gi != si).sum()))
    if not (rec["values_equal"] and ties_only and bool(torch.isfinite(vals).all())):
        raise AssertionError(f"exact top-k over {n} rows against _scan_topk: {rec}")
    rec["ms"] = timer(lambda: topk.mips_topk(q, items, k, 4096), 2)
    del items, vals, ids
    return rec


def quality_phase(device, seed: int, workdir: Path, card: str, qas_args=QUALITY_ARGS,
                  ab_args=QUALITY_AB_ARGS, seedvar_args=SEEDVAR_ARGS, c58_shape=C58_SHAPE,
                  timer=cuda_ms):
    """The quality scripts through their entry points (``run`` of
    ``scripts/quality_at_scale.py``, ``ranker_ab.py`` and
    ``seed_variance.py``, the arguments a user passes), each with the
    wrappers' counts set to 0 just before and read just after, then
    :func:`exact_topk_memory_check`."""
    import shutil

    from recommendit_tpu_torch.scripts import quality_at_scale as qas
    from recommendit_tpu_torch.scripts import ranker_ab, seed_variance

    root = workdir / "quality"
    shutil.rmtree(root, ignore_errors=True)
    on_card = torch.device(device).type == "cuda"
    base = ["--seed", str(seed), "--device", str(device)]
    print(json.dumps({"quality_cuts": QUALITY_CUTS, "card": card}), flush=True)
    rec = {}

    args = qas.parse_args([*qas_args, *base, "--work-dir", str(root / "qscale")])
    report, run, steps, evals, window = _script_run(lambda: qas.run(args), device)
    orch = evals[-1]
    _check_script_launches("quality_at_scale", run, steps, window, on_card)
    ladder = report["ladder"]
    if not all(np.isfinite(v) for v in ladder.values()):
        raise AssertionError(f"quality_at_scale ladder not finite: {ladder}")
    data = orch._load_data()
    seen = _SeenRows(orch._train_view(), orch.eval_lists["full"], data.n_items)
    rand = check_eval_lists(orch, seen, _held_out_truth(data), device, seed)
    twins = quality_kernel_check(orch, device)
    if not ladder["retrieval_only_ndcg@10"] > rand["random_ndcg@10"]:
        raise AssertionError(f"retrieval-only NDCG@10 {ladder['retrieval_only_ndcg@10']} "
                             f"does not beat a random ranking's {rand['random_ndcg@10']}")
    sr = report["sharded_retrieval"]
    if not all(sr[m]["identical_to_single_device"] for m in ("allgather", "ring")):
        raise AssertionError(f"sharded retrieval differs from the single device: {sr}")
    rec["quality_at_scale"] = {**run, "report": report, **rand, "kernel_twins": twins,
                               "eval_users": len(orch.eval_lists["full"])}
    print(json.dumps({"quality_at_scale": rec["quality_at_scale"], "card": card}),
          flush=True)

    args = ranker_ab.parse_args([*ab_args, "--seed", str(seed), "--device", str(device),
                                 "--work-dir", str(root / "qscale"),
                                 "--log", str(root / "ranker_ab.jsonl")])
    result, run, steps, evals, window = _script_run(lambda: ranker_ab.run(args), device)
    lines = (root / "ranker_ab.jsonl").read_text().splitlines()
    if len(lines) != 1 or not Path(str(root / "qscale" / "models" /
                                       "ranker_smoke.npz")).exists():
        raise AssertionError(f"ranker_ab: {len(lines)} log lines or no variant ranker")
    rows = result["serving"]
    if [r["beta"] for r in rows] != [1.0, 2.0] or not all(
            np.isfinite(r["full_ndcg@10"]) for r in rows):
        raise AssertionError(f"ranker_ab rows {rows}")
    _check_script_launches("ranker_ab", run, steps, window, on_card)
    rec["ranker_ab"] = {**run, "result": result}
    print(json.dumps({"ranker_ab": rec["ranker_ab"], "card": card}), flush=True)

    args = seed_variance.parse_args([*seedvar_args, "--device", str(device),
                                     "--work-dir", str(root / "seedvar"),
                                     "--data-dir", str(root / "seedvar" / "ml")])
    result, run, steps, _, _ = _script_run(lambda: seed_variance.run(args), device)
    if not all(np.isfinite(m["mean"]) for m in result["metrics"].values()):
        raise AssertionError(f"seed_variance metrics {result['metrics']}")
    rec["seed_variance"] = {**run, "metrics": result["metrics"]}
    print(json.dumps({"seed_variance": rec["seed_variance"], "card": card}), flush=True)

    if on_card:
        torch.cuda.empty_cache()
    rec["exact_topk"] = exact_topk_memory_check(device, seed, c58_shape, timer=timer)
    print(json.dumps({"exact_topk_20m": rec["exact_topk"], "card": card}), flush=True)
    if on_card:
        torch.cuda.empty_cache()
    q = rec["quality_at_scale"]
    rec["launches"] = {n: q["launches"][n] + rec["ranker_ab"]["launches"][n]
                       for n in ("bpr_fwd", "bpr_bwd", "window_mips")}
    print(f"quality ladder ({card}): " + ", ".join(
        f"{k}={v:.5f}" for k, v in q["report"]["ladder"].items())
        + f"; random ndcg@10={q['random_ndcg@10']:.5f}; stage s "
        + json.dumps(q["report"]["stage_seconds"]), flush=True)
    return rec


# the sweeps phase: the last six drivers, each at its own default widths
# with depth cut (SWEEPS_CUTS), in the order ROADMAP A.14 lists them
SWEEPS_WEIGHTS = '{"exposure_quality": 0.2, "latent": 1.1}'
SWEEPS_ARGS = {
    "tower_sweep": ("--name", "smoke", "--seeds", "1", "--cfg", "LOSS_MODE=in_batch",
                    "--cfg", "TRAIN_EPOCHS=10"),
    "blend_sweep": ("--betas", "0,1,2", "--users", "162541", "--items", "62423"),
    "ladder_sweep": ("--name", "smoke", "--weights", SWEEPS_WEIGHTS, "--epochs", "5",
                     "--cfg", "LOSS_MODE=in_batch", "--cfg", "RANKER_EPOCHS=5"),
    "ranker_headroom": ("--weights", SWEEPS_WEIGHTS),
    "real_data": ("--cfg", "LOSS_MODE=in_batch"),
    "train_scope_bench": ("chunk", "2", "--cfg", "LOSS_MODE=in_batch"),
}
SWEEPS_CUTS = {"tower_sweep": {"TRAIN_EPOCHS": "10 of 60", "seeds": "1 (the default)"},
               "blend_sweep": {"betas": "0,1,2 of 0,0.5,1,2,4",
                               "work-dir": "the quality phase's (its depth cut)"},
               "ladder_sweep": {"epochs": "5 of 60", "RANKER_EPOCHS": "5 of 40"},
               "ranker_headroom": {"models": "ladder_sweep's (5 epochs)"},
               "real_data": {"data": "the golden fixture (no ML-1M set; the "
                                     "download's URL a missing local file)"},
               "train_scope_bench": {"epochs": "2 of 5"}}
SWEEPS_BPR = ("bpr_fwd", "bpr_bwd")
DAT_FILES = ("ratings.dat", "users.dat", "movies.dat")


def check_steps_launches(name: str, launches: dict, steps: int, on_card: bool) -> None:
    """Kernels 5 and 6: exactly one launch each a tower step on the card,
    none on the CPU."""
    want = {k: (steps if on_card else 0) for k in SWEEPS_BPR}
    got = {k: launches[k] for k in SWEEPS_BPR}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want} ({steps} "
                             "tower steps)")


def check_tower_row(row: dict, popularity_ndcg: float, random_ndcg: float) -> None:
    """tower_sweep's row: its popularity NDCG@10 equal to the same
    computation on the CPU, its retrieval-only NDCG@10 above a seeded
    random ranking's of the same users."""
    if row["popularity_ndcg@10"] != popularity_ndcg:
        raise AssertionError(f"tower_sweep popularity NDCG@10 "
                             f"{row['popularity_ndcg@10']} != {popularity_ndcg} on the CPU")
    if not row["retrieval_ndcg@10"] > random_ndcg:
        raise AssertionError(f"tower_sweep retrieval-only NDCG@10 "
                             f"{row['retrieval_ndcg@10']} does not beat a random "
                             f"ranking's {random_ndcg}")


def check_blend_rows(rows: list, betas: list) -> None:
    """blend_sweep's rows: one a β, the ``retrieval_only_*`` fields equal
    across β (the blend does not touch them), every full row finite."""
    if [r["beta"] for r in rows] != betas:
        raise AssertionError(f"blend_sweep betas {[r['beta'] for r in rows]}")
    for key in ("retrieval_only_ndcg@10", "retrieval_only_recall@20"):
        if len({r[key] for r in rows}) != 1:
            raise AssertionError(f"blend_sweep {key} moves with beta: "
                                 f"{[r[key] for r in rows]}")
    for r in rows:
        if not all(np.isfinite(r[k]) for k in ("full_ndcg@10", "full_recall@20",
                                               "full_mrr")):
            raise AssertionError(f"blend_sweep row not finite: {r}")


def check_ladder(lines: list, keys) -> None:
    """ladder_sweep's lines: every ladder field of every seed and of the
    aggregate finite."""
    for line in lines:
        bad = {k: line.get(k) for k in keys if not np.isfinite(line.get(k, np.nan))}
        if bad:
            raise AssertionError(f"ladder_sweep ladder not finite: {bad}")


def check_headroom(out: dict, orderings) -> None:
    """ranker_headroom: six finite rows; the fitted M's expected presents
    within 1 % of the realized ratings."""
    if list(out["rows"]) != list(orderings):
        raise AssertionError(f"ranker_headroom rows {list(out['rows'])}")
    for name, rep in out["rows"].items():
        if not all(np.isfinite(rep[k]) for k in ("ndcg@10", "recall@20", "mrr")):
            raise AssertionError(f"ranker_headroom row {name} not finite: {rep}")
    if not abs(out["expected_presents"] - out["realized"]) <= 0.01 * out["realized"]:
        raise AssertionError(f"ranker_headroom: M {out['M']} expects "
                             f"{out['expected_presents']} presents, realized "
                             f"{out['realized']}")


def check_real_data(report: dict, out: Path, stages) -> None:
    """real_data on a data dir without a data set and a download that
    fails: the golden-fixture mode with the download's error, every stage
    timed, the report written where ``--out`` says."""
    if report["mode"] != "golden-fixture" or report["comparable_to_reference"]:
        raise AssertionError(f"real_data mode {report['mode']}")
    if not (report["blocked_syscall"] or "").startswith("download_movielens: "):
        raise AssertionError(f"real_data: no download error {report['blocked_syscall']}")
    if list(report["stage_seconds"]) != [*stages, "evaluate"]:
        raise AssertionError(f"real_data stages {list(report['stage_seconds'])}")
    if not out.exists() or json.loads(out.read_text()) != report:
        raise AssertionError(f"real_data report not written at {out}")


def _same_files(a: Path, b: Path, names=DAT_FILES) -> None:
    for name in names:
        if (a / name).read_bytes() != (b / name).read_bytes():
            raise AssertionError(f"{a / name} differs from {b / name}")


def _tower_sweep_baselines(args, row, seed: int) -> dict:
    """The popularity row recomputed on the CPU from the driver's ``.dat``
    files, and a seeded random ranking of the same users' unseen items."""
    from recommendit_tpu_torch.data.movielens import load_movielens
    from recommendit_tpu_torch.evaluation.metrics import evaluate_model
    from recommendit_tpu_torch.pipelines.run_pipeline import first_unseen, temporal_split
    from recommendit_tpu_torch.scripts import tower_sweep

    data = load_movielens(f"{args.work_dir}/data")
    split = temporal_split(data, args.eval_users, filter_seen=True)
    meta = json.loads(Path(f"{args.work_dir}/{args.name}_s{row['seed']}/models/"
                           "two_tower.npz.meta.json").read_text())
    known = [u for u in split.users if 1 <= u <= meta["n_users"]]
    pop = tower_sweep.popularity_report(data, split, known)
    rng = np.random.default_rng(seed + 5)
    items = np.asarray(data.item_ids, np.int64)
    rand = {u: first_unseen(split.seen_train, u, rng.permutation(items), EVAL_K)
            for u in known}
    rand_rep = evaluate_model(rand, split.truth, k_values=[10, 20])
    return {"popularity_ndcg@10": pop["ndcg@10"], "random_ndcg@10": rand_rep["ndcg@10"],
            "users": len(known)}


def sweeps_phase(device, seed: int, workdir: Path, card: str, args=SWEEPS_ARGS,
                 blend_work: Path = None, scope_sizes=None):
    """The last six drivers through their ``run`` with the arguments a user
    passes (``args``; depth cut as ``SWEEPS_CUTS`` prints), each with the
    wrappers' counts set to 0 just before and read just after
    (``_script_run``): ``tower_sweep`` (q3k), ``blend_sweep`` over the
    quality phase's work-dir (``blend_work``), ``ladder_sweep`` under
    non-default generator weights, ``ranker_headroom`` over its models,
    ``real_data`` on the golden fixture, ``train_scope_bench`` at ML-1M
    shape (``scope_sizes`` overrides the sizes)."""
    import shutil

    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.data import movielens
    from recommendit_tpu_torch.data.movielens import save_movielens
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
    from recommendit_tpu_torch.scripts import (
        blend_sweep,
        ladder_sweep,
        ranker_headroom,
        real_data,
        tower_sweep,
        train_scope_bench,
    )
    from recommendit_tpu_torch.scripts.quality_at_scale import apply_overrides

    root = workdir / "sweeps"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    on_card = torch.device(device).type == "cuda"
    dev = ["--device", str(device)]
    print(json.dumps({"sweeps_cuts": SWEEPS_CUTS, "card": card}), flush=True)
    t_phase = time.perf_counter()
    rec, launches = {}, {k: 0 for k in (*SWEEPS_BPR, "window_mips")}

    def done(name, run, **extra):
        rec[name] = {**run, **extra}
        for k in launches:
            launches[k] += run["launches"][k]
        print(json.dumps({name: rec[name], "card": card}, default=float), flush=True)

    # tower_sweep: q3k, one seed
    a = tower_sweep.parse_args([*args["tower_sweep"], "--seed-base", str(seed), *dev,
                                "--work-dir", str(root / "tower"),
                                "--log", str(root / "tower_sweep.jsonl")])
    lines, run, steps, _, window = _script_run(lambda: tower_sweep.run(a), device)
    check_steps_launches("tower_sweep", run["launches"], steps, on_card)
    window.check("tower_sweep", run["launches"]["window_mips"], on_card)
    base = _tower_sweep_baselines(a, lines[0], seed)
    check_tower_row(lines[0], base["popularity_ndcg@10"], base["random_ndcg@10"])
    done("tower_sweep", run, steps=steps, row=lines[0], **base)

    # blend_sweep over the quality phase's work-dir
    a = blend_sweep.parse_args([*args["blend_sweep"], *dev, "--work-dir",
                                str(blend_work or workdir / "quality" / "qscale"),
                                "--out", str(root / "blend_sweep.json")])
    rows, run, steps, evals, window = _script_run(lambda: blend_sweep.run(a), device)
    check_steps_launches("blend_sweep", run["launches"], 0, on_card)
    by_call = window.check("blend_sweep", run["launches"]["window_mips"], on_card)
    if on_card and not by_call.get("batch_recommend"):
        raise AssertionError("blend_sweep: no evaluate batch launched the window kernel")
    check_blend_rows(rows, [float(b) for b in a.betas.split(",")])
    twins = quality_kernel_check(evals[-1], device)
    done("blend_sweep", run, rows=rows, window_by_call=by_call, kernel_twins=twins,
         evaluate_calls=len(evals))

    # ladder_sweep under non-default weights, then ranker_headroom on its models
    a = ladder_sweep.parse_args([*args["ladder_sweep"], "--seed-base", str(seed), *dev,
                                 "--work-dir", str(root / "ladder"),
                                 "--log", str(root / "ladder_sweep.jsonl")])
    out, run, steps, _, window = _script_run(lambda: ladder_sweep.run(a), device)
    check_steps_launches("ladder_sweep", run["launches"], steps, on_card)
    window.check("ladder_sweep", run["launches"]["window_mips"], on_card)
    check_ladder([*out["lines"], out["summary"]], ladder_sweep.KEYS)
    cfg = apply_overrides(Settings(), a.cfg)
    weights = json.loads(a.weights)
    save_movielens(make_synthetic_movielens(cfg.SYNTH_USERS, cfg.SYNTH_ITEMS,
                                            cfg.SYNTH_RATINGS, a.data_seed,
                                            weights=weights), str(root / "ladder_cpu"))
    _same_files(root / "ladder" / f"{a.name}_data", root / "ladder_cpu")
    done("ladder_sweep", run, steps=steps, lines=out["lines"], summary=out["summary"],
         dat_equal_to_cpu=True)

    models = root / "ladder" / f"{a.name}_s{seed}" / "models"
    h = ranker_headroom.parse_args([*args["ranker_headroom"], *dev, "--seed",
                                    str(a.data_seed), "--models-dir", str(models),
                                    "--data-dir", str(root / "ladder" / f"{a.name}_data")])
    out, run, steps, _, _ = _script_run(lambda: ranker_headroom.run(h), device)
    check_steps_launches("ranker_headroom", run["launches"], 0, on_card)
    if run["launches"]["window_mips"]:
        raise AssertionError(f"ranker_headroom launched kernel 1: {run['launches']}")
    check_headroom(out, ranker_headroom.ORDERINGS)
    done("ranker_headroom", run, M=out["M"], expected_presents=out["expected_presents"],
         realized=out["realized"], rows=out["rows"])

    # real_data: a data dir with no data set; its download from a missing
    # local file fails (no socket), so it takes the golden fixture
    real = root / "real"
    a = real_data.parse_args([*args["real_data"], *dev,
                              "--data-dir", str(real / "ml-1m"),
                              "--models-dir", str(real / "models"),
                              "--features-dir", str(real / "features"),
                              "--out", str(real / "REALDATA.json")])
    url = movielens.MOVIELENS_1M_URL
    movielens.MOVIELENS_1M_URL = (real / "no-such-ml-1m.zip").resolve().as_uri()
    try:
        report, run, steps, _, window = _script_run(lambda: real_data.run(a), device)
    finally:
        movielens.MOVIELENS_1M_URL = url
    check_steps_launches("real_data", run["launches"], steps, on_card)
    if on_card and not steps:
        raise AssertionError("real_data trained no tower step")
    window.check("real_data", run["launches"]["window_mips"], on_card)
    check_real_data(report, real / "REALDATA.json", real_data.STAGES)
    done("real_data", run, steps=steps, report=report)

    # train_scope_bench at ML-1M shape
    a = train_scope_bench.parse_args([*args["train_scope_bench"], *dev])
    out, run, steps, _, _ = _script_run(lambda: train_scope_bench.run(
        a.scope, a.epochs, a.cfg, a.device, seed=0, **(scope_sizes or {})), device)
    check_steps_launches("train_scope_bench", run["launches"], steps, on_card)
    if steps != sum(h["steps"] for h in out["history"]) or not steps:
        raise AssertionError(f"train_scope_bench: {steps} tower steps, history "
                             f"{out['history']}")
    line = {k: v for k, v in out.items() if k != "history"}
    done("train_scope_bench", run, steps=steps, line=line)
    print(json.dumps({"train_scope_bench": line, "card": card}), flush=True)

    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="artifact directory (default: "
                         "recommendit_tpu_torch/build/chip_smoke)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from recommendit_tpu_torch.ops import _build

    root = Path(__file__).resolve().parent
    workdir = Path(args.workdir or root / "recommendit_tpu_torch" / "build"
                   / "chip_smoke")
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)

    t_start = t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(_build.load_library, LIBRARIES))
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "nvcc_s": {n: _build.build_seconds[n] for n in LIBRARIES}}),
          flush=True)
    # first, while this process holds nothing on the card, each in a fresh
    # process: the BPR kernels' own times, then one web100m rank
    phase_start("bpr", t_start)
    bpr_checks = bpr_phase(device, args.seed, card)
    phase_start("web100m_shard", t_start)
    shard = web100m_shard_phase(device, args.seed, card)
    phase_start("adamw_fused", t_start)
    adamw_rec = adamw_fused_phase(device, args.seed, card)
    phase_start("dlrm_bags", t_start)
    bags_rec = dlrm_bags_phase(device, args.seed, card)
    stages = ctypes.c_int(0)
    d_dev = -(-(DIM + 1) // 8) * 8           # the bias column, padded to 8
    smem = _build.load_library("window_mips").window_mips_bf16_smem(
        d_dev, ctypes.byref(stages))
    print(json.dumps({"ptxas_window_mips": ptxas_summary(
        _build.ptxas_logs.get("window_mips", "")), "window_tc_smem": {
            "d": d_dev, "dynamic_bytes": smem, "stages": stages.value}}),
          flush=True)

    phase_start("artifacts", t_start)
    t0 = time.perf_counter()
    paths, data = make_artifacts(workdir, args.seed, device)
    print(json.dumps({"artifacts_s": time.perf_counter() - t0}), flush=True)

    phase_start("kernel", t_start)
    checks = kernel_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    phase_start("serve", t_start)
    serve, pipe = serve_phase(paths, data, device)
    print(json.dumps({"serve": serve, "card": card}), flush=True)
    torch.cuda.empty_cache()
    phase_start("serve_profile", t_start)
    profile_phase(paths, data, device)
    torch.cuda.empty_cache()

    phase_start("quantize", t_start)
    quant = quantize_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    phase_start("int8_kernel", t_start)
    checks_i8, _ = int8_kernel_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    phase_start("serve_int8", t_start)
    serve_i8, pipe_i8 = serve_phase(paths, data, device, dtype="int8")
    print(json.dumps({"serve_int8": serve_i8, "card": card}), flush=True)
    torch.cuda.empty_cache()
    phase_start("serve_profile_int8", t_start)
    profile_phase(paths, data, device, dtype="int8")
    torch.cuda.empty_cache()

    phase_start("http", t_start)
    t0 = time.perf_counter()
    http = http_phase(pipe, pipe_i8, device, seed=args.seed)
    print(json.dumps({"http": http, "http_s": time.perf_counter() - t0,
                      "card": card}), flush=True)
    del pipe, pipe_i8
    torch.cuda.empty_cache()
    phase_start("serve_gbdt", t_start)
    t0 = time.perf_counter()
    gbdt_serve, pipe = gbdt_serve_phase(paths, data, device)
    print(json.dumps({"serve_gbdt": gbdt_serve, "serve_gbdt_s": time.perf_counter() - t0,
                      "card": card}), flush=True)
    del pipe
    torch.cuda.empty_cache()

    phase_start("qm_window", t_start)
    checks_qm = qm_window_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    phase_start("router", t_start)
    router_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    phase_start("fold", t_start)
    fold = fold_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    phase_start("gather", t_start)
    gath = gather_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    phase_start("probe", t_start)
    probes, probe_launches = probe_phase(device)
    print(json.dumps({"probe_launches": probe_launches, "card": card}),
          flush=True)
    phase_start("verified", t_start)
    t0 = time.perf_counter()
    verified = verified_phase(paths, data, device, args.seed, card)
    print(json.dumps({"verified_s": time.perf_counter() - t0}), flush=True)
    del data      # the parallel phase, last, reads paths' files again
    torch.cuda.empty_cache()

    phase_start("drivers", t_start)
    drivers = drivers_phase(device, args.seed, workdir, card)
    capacity = drivers["capacity_30m"]
    print(json.dumps({"capacity": capacity, "card": card}), flush=True)
    torch.cuda.empty_cache()

    # the optimizer's kernel once a step of every trainer the phases below run
    adamw_steps = {}
    phase_start("host_table", t_start)
    t0 = time.perf_counter()
    with _AdamWSteps("host_table", True) as counted:
        host = host_table_phase(device, args.seed, workdir, card)
    adamw_steps["host_table"] = counted.record()
    print(json.dumps({"host_table_s": time.perf_counter() - t0}), flush=True)
    torch.cuda.empty_cache()
    phase_start("train", t_start)
    t0 = time.perf_counter()
    data, view = make_train_data(args.seed)
    print(json.dumps({"train_data": {
        "ratings": len(data), "train_view": len(view), "users": data.n_users,
        "items": data.n_items, "seconds": time.perf_counter() - t0}}),
        flush=True)
    with _AdamWSteps("train", True) as counted:
        model, train = train_phase(view, device, args.seed, workdir)
    adamw_steps["train"] = counted.record()
    print(json.dumps({"train": train, "card": card}), flush=True)
    phase_start("train_profile", t_start)
    with _AdamWSteps("train_profile", True) as counted:
        train_profile_phase(view, device, args.seed)
    adamw_steps["train_profile"] = counted.record()
    phase_start("index", t_start)
    index = index_phase(model, data, view, device, args.seed, workdir)
    print(json.dumps({"index": index}), flush=True)
    del model
    torch.cuda.empty_cache()
    phase_start("pipeline", t_start)
    t0 = time.perf_counter()
    with _AdamWSteps("pipeline", True) as counted:      # the towers and the ranker
        pipeline = pipeline_phase(data, device, args.seed, workdir, card)
    adamw_steps["pipeline"] = counted.record()
    print(json.dumps({"pipeline_s": time.perf_counter() - t0,
                      "pipeline_bpr_launches": pipeline["bpr_launches"],
                      "pipeline_tower_steps": pipeline["tower_steps"]}),
          flush=True)
    phase_start("gbdt_pipeline", t_start)
    t0 = time.perf_counter()
    gbdt_pipe = gbdt_pipeline_phase(data, device, args.seed, workdir, card, pipeline)
    print(json.dumps({"gbdt_pipeline_s": time.perf_counter() - t0,
                      "gbdt_bpr_launches": gbdt_pipe["bpr_launches"]}), flush=True)
    phase_start("host_pipeline", t_start)
    t0 = time.perf_counter()
    with _AdamWSteps("host_pipeline", True) as counted:
        host_pipe = host_pipeline_phase(data, device, args.seed, workdir, card)
    adamw_steps["host_pipeline"] = counted.record()
    print(json.dumps({"host_pipeline_s": time.perf_counter() - t0,
                      "host_pipeline_bpr_launches": host_pipe["launches"]}), flush=True)
    del data, view
    torch.cuda.empty_cache()
    phase_start("ctr", t_start)
    t0 = time.perf_counter()
    with _AdamWSteps("ctr", True) as counted:
        ctr_phase(device, args.seed, card)
    adamw_steps["ctr"] = counted.record()
    print(json.dumps({"ctr_s": time.perf_counter() - t0}), flush=True)
    torch.cuda.empty_cache()
    phase_start("parallel", t_start)
    with _AdamWSteps("parallel", True) as counted:
        par = parallel_phase(paths, device, args.seed, workdir, card)
    adamw_steps["parallel"] = counted.record()
    print(json.dumps({"adamw_steps": adamw_steps, "card": card}), flush=True)
    print(json.dumps({"parallel_s": par["seconds"]}), flush=True)
    torch.cuda.empty_cache()
    phase_start("quality", t_start)
    t0 = time.perf_counter()
    quality = quality_phase(device, args.seed, workdir, card)
    print(json.dumps({"quality_s": time.perf_counter() - t0,
                      "quality_launches": quality["launches"]}), flush=True)
    torch.cuda.empty_cache()
    phase_start("sweeps", t_start)
    sweeps = sweeps_phase(device, args.seed, workdir, card)
    print(json.dumps({"sweeps_s": sweeps["seconds"],
                      "sweeps_launches": sweeps["launches"]}), flush=True)

    print(json.dumps({"total_s": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"phase_records": [
        {k: r[k] for k in ("phase", "since_start_s", "threads", "rss_gib",
                           "cuda_reserved_gib")} for r in PHASE_RECORDS]}), flush=True)
    main_q = checks[-1]
    main_i8 = checks_i8[-1]
    main_b, train_b = bpr_checks[0], bpr_checks[1]   # (2048, 256), (1024, 64)
    shard_b = shard["twins"]                          # (4096, 128)
    main_qm = checks_qm[-1]
    b, d = main_b["b"], main_b["d"]
    b_train, b_shard = (bpr_bounds(r["b"], r["d"]) for r in (train_b, shard_b))
    shape_train, shape_shard = (f"{r['b']}x{r['d']}" for r in (train_b, shard_b))
    kernels = [{
        "name": "window_mips", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": serve["launches"]["window_mips"],
        "search_device_launches": serve["search_device"]["launches"],
        "http_launches": sum(lv["launches"]["window_mips"]
                             for lv in http["bf16"]["levels"]),
        "gbdt_launches": gbdt_serve["launches"]["window_mips"],
        "quality_launches": quality["launches"]["window_mips"],
        "sweeps_launches": sweeps["launches"]["window_mips"],
        # the retrieval drivers: window 512 over 10M rows (recall_10m), the
        # f32 and bf16 bodies (mips_ab), windows 64 and 32 (fused_decomp)
        **{f"{name}_launches": n for name, n in
           drivers["launches"]["window_mips"].items()},
        "w512_10m_ms": drivers["recall_10m"]["kernel_ms"],
        "w512_10m_bound_ms": drivers["recall_10m"]["bound_ms"],
        "max_abs_err": max(c["window_max_abs_err"] for c in checks),
        "ms": main_q["kernel_ms"], "plain_ms": main_q["twin_ms"],
        "bound": window_bound(main_q, 2, 4, "bf16"), "library_ms": None,
    }, {
        "name": "window_mips_qm", "source": KERNEL_SOURCE, "replaces": QM_REPLACES,
        "launches": probe_launches["window_mips_qm"],
        "max_abs_err": max(c["window_max_abs_err"] for c in checks_qm),
        "ms": main_qm["kernel_ms"], "plain_ms": main_qm["twin_ms"],
        "bound": window_bound(main_qm, 2, 4, "bf16"), "library_ms": None,
    }, {
        "name": "window_mips_i8", "source": I8_SOURCE, "replaces": I8_REPLACES,
        "launches": serve_i8["launches"]["window_mips_i8"],
        "search_device_launches": serve_i8["search_device"]["launches"],
        "http_launches": sum(lv["launches"]["window_mips_i8"]
                             for lv in http["int8"]["levels"]),
        "capacity_launches": capacity["launches"],
        "max_abs_err": max(c["window_max_abs_err"] for c in checks_i8),
        "ms": main_i8["kernel_ms"], "plain_ms": main_i8["twin_ms"],
        "bound": window_bound(main_i8, 1, 1, "int8", scales=True),
        "library_ms": None,
    }, {
        "name": "fold_mips", "source": FOLD_SOURCE, "replaces": FOLD_REPLACES,
        "launches": probe_launches["fold_mips"],
        "max_abs_err": fold["max_abs_err"],
        "ms": fold["kernel_ms"], "plain_ms": fold["twin_ms"],
        # f32-grade scores on the tensor cores: three bf16 passes; the f32
        # operations' bound (the CUDA-core body's) beside it
        "bound": (fold["bound_ms"], fold["bound_by"]),
        "bound_f32_ms": fold["bound_f32_ms"], "library_ms": None,
    }, {
        "name": "fold_split", "source": FOLD_SOURCE, "replaces": FOLD_REPLACES,
        "launches": probe_launches["fold_split"],
        "max_abs_err": fold["split_max_abs_err"],
        "ms": fold["split_ms"], "plain_ms": fold["split_twin_ms"],
        # the f32 queries read once, the three bf16 pieces written once
        "bound": bound(fold["q"] * fold["d"] * (4 + 3 * 2)), "library_ms": None,
    }, {
        "name": "bpr_fwd", "source": BPR_SOURCE, "replaces": BPR_REPLACES["bpr_fwd"],
        # the host-table path at (2048, 256); the earlier paths beside it
        "launches": host["host"]["launches"]["bpr_fwd"],
        "hbm_launches": host["hbm"]["launches"]["bpr_fwd"],
        "host_pipeline_launches": host_pipe["launches"]["bpr_fwd"],
        "train_launches": train["launches"]["bpr_fwd"],
        "pipeline_launches": pipeline["bpr_launches"]["bpr_fwd"],
        "gbdt_pipeline_launches": gbdt_pipe["bpr_launches"]["bpr_fwd"],
        "parallel_launches": par["train"]["launches"]["bpr_fwd"],
        "quality_launches": quality["launches"]["bpr_fwd"],
        "sweeps_launches": sweeps["launches"]["bpr_fwd"],
        "two_tower_loss_launches": sum(c["two_tower"]["launches"]["bpr_fwd"]
                                       for c in bpr_checks),
        "web100m_shard_launches": shard["launches"]["bpr_fwd"],
        "max_abs_err": max(abs(c["loss"] - c["twin_loss"]) for c in [*bpr_checks, shard_b]),
        "ms": main_b["fwd_device_ms"], "plain_ms": main_b["twin_fwd_device_ms"],
        f"ms_{shape_train}": train_b["fwd_device_ms"],
        f"plain_ms_{shape_train}": train_b["twin_fwd_device_ms"],
        f"bound_ms_{shape_train}": b_train["fwd"][0],
        # the web100m shard's (B, D), by CUDA events
        f"ms_{shape_shard}": shard_b["fwd_ms"],
        f"plain_ms_{shape_shard}": shard_b["twin_fwd_ms"],
        f"bound_ms_{shape_shard}": b_shard["fwd"][0],
        # the (B, B) score matrix; the softplus per pair is not counted
        "bound": bpr_bounds(b, d)["fwd"], "library_ms": None,
    }, {
        "name": "bpr_bwd", "source": BPR_SOURCE, "replaces": BPR_REPLACES["bpr_bwd"],
        # the host-table path at (2048, 256); the earlier paths beside it
        "launches": host["host"]["launches"]["bpr_bwd"],
        "hbm_launches": host["hbm"]["launches"]["bpr_bwd"],
        "host_pipeline_launches": host_pipe["launches"]["bpr_bwd"],
        "train_launches": train["launches"]["bpr_bwd"],
        "pipeline_launches": pipeline["bpr_launches"]["bpr_bwd"],
        "gbdt_pipeline_launches": gbdt_pipe["bpr_launches"]["bpr_bwd"],
        "parallel_launches": par["train"]["launches"]["bpr_bwd"],
        "quality_launches": quality["launches"]["bpr_bwd"],
        "sweeps_launches": sweeps["launches"]["bpr_bwd"],
        "two_tower_loss_launches": sum(c["two_tower"]["launches"]["bpr_bwd"]
                                       for c in bpr_checks),
        "web100m_shard_launches": shard["launches"]["bpr_bwd"],
        "max_abs_err": max(c["grad_max_abs_err"] for c in [*bpr_checks, shard_b]),
        "ms": main_b["bwd_device_ms"], "plain_ms": main_b["twin_bwd_device_ms"],
        f"ms_{shape_train}": train_b["bwd_device_ms"],
        f"plain_ms_{shape_train}": train_b["twin_bwd_device_ms"],
        f"bound_ms_{shape_train}": b_train["bwd"][0],
        f"ms_{shape_shard}": shard_b["bwd_ms"],
        f"plain_ms_{shape_shard}": shard_b["twin_bwd_ms"],
        f"bound_ms_{shape_shard}": b_shard["bwd"][0],
        # the scores, then du = G V and dv = G^T U
        "bound": bpr_bounds(b, d)["bwd"], "library_ms": None,
    }, {
        "name": "adamw_fused", "source": ADAMW_SOURCE, "replaces": ADAMW_REPLACES,
        # one a step of the sharded step (web100m_shard) and of the phase's
        "launches": adamw_rec["launches"],
        "web100m_shard_launches": shard["adamw_launches"],
        # each trainer phase's launches, one a step of its OptaxAdamW
        **{f"{name}_launches": r["launches"] for name, r in adamw_steps.items()},
        "max_abs_err": adamw_rec["max_abs_err"],
        "numel": adamw_rec["numel"], "ms": adamw_rec["kernel_ms"],
        "plain_ms": adamw_rec["foreach_ms"],
        # the clip's norm, beside it: the gradients read once
        "norm_ms": adamw_rec["norm_ms"], "norm_bound_ms": bound(4 * adamw_rec["numel"])[0],
        # p, g, m, v read and p, m, v written once: 28 bytes an element
        # torch._fused_adamw_ over the foreach path's row ranges, without the clip
        "bound": (adamw_rec["bound_ms"], adamw_rec["bound_by"]),
        "library_ms": adamw_rec["library_ms"],
    }, {
        "name": "bag_fwd", "source": BAGS_SOURCE, "replaces": BAGS_REPLACES,
        # in `steps` dcn_step calls at the DLRM cell's shape, counted from 0
        "launches": bags_rec["step_launches"]["bag_fwd"], "steps": bags_rec["steps"],
        "shape": [
            bags_rec["batch"], bags_rec["slots"], bags_rec["rows"], bags_rec["dim"]],
        "max_abs_err": bags_rec["fwd_max_abs_err"],
        "ms": bags_rec["fwd_ms"], "plain_ms": bags_rec["fwd_plain_ms"],
        # each distinct row read once, the ids, the pooled output written once
        "bound": (bags_rec["fwd_bound_ms"], bags_rec["fwd_bound_by"]),
        "library_ms": bags_rec["fwd_library_ms"],
    }, {
        "name": "bag_update", "source": BAGS_SOURCE, "replaces": BAGS_REPLACES,
        # the sort and the two update kernels, one call a dcn_step
        "launches": bags_rec["step_launches"]["bag_update"], "steps": bags_rec["steps"],
        "unique_rows": bags_rec["unique_rows"],
        "hottest_row_hits": bags_rec["hottest_row_hits"],
        "max_rel_err": max(bags_rec["warm"]["acc_rel_err"], bags_rec["zero"]["acc_rel_err"]),
        "ms": bags_rec["update_ms"], "plain_ms": bags_rec["update_plain_ms"],
        "sort_ms": bags_rec["sort_ms"], "sort_bound_ms": bags_rec["sort_bound_ms"],
        # the pooled gradient and the ids read once, each distinct row's
        # weights and accumulator read and written once
        "bound": (bags_rec["update_bound_ms"], bags_rec["update_bound_by"]),
        "library_ms": None,
    }, {
        "name": "quantize_i8", "source": QUANT_SOURCE, "replaces": QUANT_REPLACES,
        "launches": quant["launches"]["quantize_i8"],
        "max_abs_err": quant["max_abs_err"],
        "ms": quant["kernel_ms"], "plain_ms": quant["twin_ms"],
        "bound": bound(quant["n"] * quant["d"] * 5 + quant["n"] * 4),
        "library_ms": None,
    }, {
        "name": "gather_rows", "source": GATHER_SOURCE, "replaces": GATHER_REPLACES,
        "launches": gath["launches"]["gather_rows"],
        "max_abs_err": gath["max_abs_err"],
        "ms": gath["kernel_ms"], "plain_ms": gath["twin_ms"],
        "bound": bound(gath["bytes"]), "library_ms": gath["library_ms"],
    }]
    for kern in kernels:
        kern["route"] = "cuda"
        kern["bound_ms"], kern["bound_by"] = kern.pop("bound")
    check_kernel_times(kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
