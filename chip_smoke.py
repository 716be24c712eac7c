#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``tikv_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``tikv_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together; timed, with the ptxas report and the shared
   atomics in ``hash_agg``'s and ``agg_fold``'s SASS — none a float64
   compare-and-swap loop in ``agg_fold``'s integer shared route — and, in
   ``psum_kernel<4>``'s, the four sources' 16-byte loads all issued
   before the float64 pair path's first add, and ``merge_kernel<4>``'s
   order printed);
3. every kernel against its plain PyTorch version on the card over the
   edge cases of the CPU tests: ``hash_agg`` exactly (integer states) in
   both cell formats, at 2^24 rows, on one hot slot over 2^24 rows at the
   int32 (packed cells) and int16 (split cells) extremes, with repeated
   lanes and validity planes, planes 1-3 rows off a 16-byte boundary (at
   one phase or at several), ``n`` not a multiple of 4, and 4096 slots over
   several launches; ``twolevel`` exactly for its int8 planes and within
   1e-9·Σ|v| per cell for its float planes (float64 sums in another
   order) through both entries: the fused entry over raw columns (int32,
   int64 and sparse keys, NULL keys, no / partial / all-false selection,
   1-4 and 8 byte planes with their extremes, REAL lanes, aliased
   validity, 4n's repeated planes, the overflow flag) at slot counts that
   take each of its routes (1026: shared, 65,538: cluster, 2^20 + 2:
   global; the route is printed, and each must be taken), with a hot slot
   past the per-table row cap; and the planes entry, also at the shapes of
   the Pallas prototypes it replaces, with each prototype's own check
   (count by ``bincount``, sum rebuilt with the prototype's bias formula,
   against numpy);
4. the aggregation path (run while ``selection.cu`` builds, after the
   early mesh cells of step 14: none launches a kernel of that source)
   through ``DeviceRunner().handle_request`` for
   eight configurations (``tikv_tpu_torch.testing.configs``): 3
   (50·2^20 rows), 4, 4n and 4w (100·2^20 rows), and 4s, 4r, 4m and 3n
   (2^24 rows), each request wire-encoded first, each answer held against
   a numpy truth (exactly for integer and MIN/MAX results, within 1e-9 of
   the error scale of ``configs.truth`` for REAL sums and variances): one
   cold and five warm requests, the kernels' launch counts read around
   the run (each config must launch the kernels of its route and no
   other), the peak device memory of one more warm request beyond what
   was resident before it, and one profiled warm request (traced again
   until the trace holds the route's kernels); for 3, 4 and 4s
   one line of host-clock phases of a warm request (analyze, inputs,
   launch, D2H wait, finalize);
5. each kernel against its plain version at the main path's shapes, and
   timed there with CUDA events beside its bound and one library call
   that computes the same function (a yardstick the port never calls):
   ``hash_agg`` at configs 3, 4 and 4s (4 and 4s also with packed cells);
   ``twolevel``'s fused entry at 4n, 4w and 4r on the runner's own
   arguments, also beside the planes path it replaced (``slot_index`` +
   ``make_planes`` + the planes kernel, on the same inputs), with the
   peak device memory of each, and on every route its table can take;
6. the selection and top-k kernels against their plain versions on the
   card, exactly (every output is an integer or a copied element):
   ``sel_pred`` (random predicates nested two or three deep over
   NULL-bearing int32 — with its extremes —, int64 and float32 planes,
   narrowed by the columns' bounds and not, at ragged sizes, on and off a
   16-byte boundary, with and without the bool mask; and the predicates of
   configs 1, 2, 2s and 5t at 10·2^20 rows), ``sel_mask`` (n not a
   multiple of 8, one and many blocks, all-false and all-true masks, a
   mask off a 16-byte boundary, config 2's 10·2^20 rows; then 128 calls
   back to back on one stream over random masks and sizes, each call's
   count, block counts and packed bytes against the plain version's: a
   tally that failed to reset would show), ``sel_compact`` in index mode
   (capacity above and below the count: the overflow flag; one below, at
   and one above it) and in planes
   mode (int32, int64, float64 and bool planes), over 100·2^20 rows at 1%
   (3,200 blocks) too, its whole buffer (header, -1 fill, 0 tails and the
   gaps between planes) against the plain version's, each call under
   ``set_sync_debug_mode("error")`` (no wait on the card), ``topn_select`` (DESC and ASC, int32, int64 and float64
   keys, NULLs first and last, a selection inside, a limit beyond the live
   rows, 10·2^20 tied keys and 10·2^20 NULL keys, the int64 extremes, -0.0
   beside 0.0, n not a multiple of the segment, config 5's 100·2^20 rows,
   a crossing bin of exactly the candidate buffer's rows and one row more,
   narrow int32 keys with and without their bounds, misaligned planes; the
   route each case takes equals ``topn.plan_route``'s, and both the common
   and the overflow route are taken), and ``agg_fold`` (every state kind
   over int32, int64, float32 and float64 values with NULLs, no / partial /
   all-false selections, dense keys with NULL keys, sparse slot ids and
   the simple mode with FIRST, at 1026, 65,538 and 2^20 + 2 slots, lanes
   sharing a values plane, an int64 key, the overflow flag, hot slots over
   2^24 rows at the int32 extremes, value bounds that shrink the shared
   cells (|v| <= 300 and 1000, and 2^31), n not a multiple of 4, planes 1-3
   elements off a 16-byte boundary; integer, MIN/MAX and FIRST states
   exactly, float64 sums within 1e-9·Σ|v| per cell, FIRST also where the
   first selected row is NULL and whole warps' selected rows are NULL; the
   route of each case is printed and every route, shared, global and
   registers, is taken);
7. the selection, top-k and index-scan routes through
   ``DeviceRunner().handle_request`` (``configs.ROW_CONFIGS``): configs 1
   (its probe over 2^20 rows), 2 (10·2^20), 5 (an IndexScan, 100·2^20) and
   5t (100·2^20), and config 2s (10·2^20 rows at 0.1%, 1%, 10% and 50%
   selected, which must take the compact, index, mask and mask routes),
   each request's selection through ``sel_pred`` (its predicate route
   counted per request), and config 2's table under a predicate outside
   ``sel_pred``'s signatures (``v DIV 3 > 266``: the torch route, then
   ``sel_mask``), each answer held exactly against a numpy truth, with the
   same cold / warm / peak / profile / launch-count lines as step 4 and a
   line of host-clock phases of a warm request (``row_phases``); then the
   time types (``run_time_types``, ``configs.TIME_CELLS``: one table of
   10·2^20 rows with a DATETIME and a DURATION column): t2 (a 1994 range
   of ``d`` in ``sel_pred``, COUNT/MIN/MAX in ``agg_fold``), t4m (GROUP BY
   k, MIN(d), MAX(u): ``agg_fold``), t5 (ORDER BY u DESC LIMIT 1000:
   ``topn_select``) and tshift (``(k << 40) >> 38 > 1000``: the shifts on
   the torch route) with the same lines, ``sel_pred``, ``agg_fold`` and
   ``topn_select`` each against its plain version on the runner's own
   arguments at those cells and timed there; th (``Year(d) = 1995``)
   through the endpoint: answered on the host, no launch; and a year-9999
   variant of ``d``: the endpoint answers on the host, a forced request
   raises ``FeedBeyondInt64``; then cell tj (``run_tj``, 2^20 rows with a
   JSON column ``doc``): tj1 on the card (``sel_pred``, ``hash_agg``; its
   feed equal to the table's without ``doc``), tj2 (a JSON predicate)
   refused by the runner and answered on the host with no launch, tj3
   (ANALYZE of every column: the ``analyze`` kernel for the INT columns,
   the host half for ``doc``) and tjp (tj1's selection in pages of 4096
   rows on the host, followed to ``is_drained``, equal to the card's
   unpaged answer), each against its numpy truth;
8. each of those kernels timed at the main path's shapes beside its
   bound, its plain version and a library yardstick the port never calls:
   ``sel_pred`` at config 2 (``v > 800``, packed mask) and 5t (``k <
   512`` over 100·2^20 rows, the bool mask too) beside the torch
   comparison alone, ``sel_mask`` at config 2 (``torch.count_nonzero``)
   beside the launch floor,
   ``sel_compact`` at
   config 2s's 1% (index mode) and 0.1% (planes mode) (``torch.nonzero``)
   beside the launch floor (``launch_floor_ms``: an empty kernel,
   ``csrc/floor.cu``, queued like every kernel),
   ``topn_select`` at configs 5 and 5t (``torch.topk`` on the (segments,
   segment length) view), with its route and its reads of the order plane
   per row (and at config 5 the overflow route's time on the same
   inputs); ``agg_fold`` at configs 4m and 3n on the runner's own
   arguments, with its route and peak bytes (no single PyTorch call
   computes the fold: one ``scatter_reduce_`` (amax) over the same keys
   and values is the yardstick);
9. the cold MVCC path (run while ``selection.cu`` builds, after the
   aggregation configs of step 4: none of it launches a kernel of that
   source): ``plane_digest`` and ``patch_rows`` against their
   plain versions over every feed dtype (and int8, int16), the digest
   over full and partial ranges of planes 0-7 elements off a 16-byte
   boundary up to 2^24 + 3 rows, the patch at 1, 1000 and 65,536 rows
   with and without digests; ``patch_feed_rows`` (every feed dtype at
   once, and int32 + int64 + bool; 1 to 65,536 rows, one block a plane and
   several; host and card values; recorded digests by value and by
   address; 120 planes) in one launch a call; ``patch_feed_spans`` the
   same way over K of 1, 4 and 300 spans (300: past the parameter room)
   of 1 to 65,536 rows, P 3, 7 and 120; ``mvcc_resolve`` against its
   plain version
   over the CPU tests' histories (deletes, rollbacks, locks, versions
   above read_ts, NULLs, INT, REAL and unsigned columns, every key
   deleted, an empty result, two versions of a key at one commit_ts, a
   key of 50,000 versions among short keys, a run of keys of 300 versions
   each, tiles at the kernel's shared budget of versions and one past
   it), a schema of 100 output planes, 2^20 keys, and the same planes
   resident in padded ``DeviceVersionPlanes`` buffers — all bit for bit; a mint
   with CF_DEFAULT spill rows (one ``patch_feed_rows`` launch in the
   mint) against the upload of its host mirror; then configs 6c (10·2^20 keys, one PUT a
   key) and 4h (100·2^20 keys, a chosen version mix at about 1.15
   versions a key; ``tikv_tpu_torch/testing/mvcc.py``) through
   ``build_region_columnar_device`` and ``DeviceRunner().handle_request``:
   cold + 5 warm requests from a feed minted by ``mvcc_resolve``
   (``feed_routes`` {device_resolve: 1}), each answer against the
   generator's truth, then the scrub — clean, kept clean by a
   ``_patch_plane`` over two 1-row spans and its undo (each one
   ``patch_feed_spans`` launch, bit-equal to the plain version on a copy,
   R' included), and naming the plane ``corrupt_resident_plane`` flipped
   (one ``patch_feed_rows`` launch) — with the kernels' launch counts
   read around that main path (``mvcc_resolve``, ``plane_digest``,
   ``patch_rows`` and ``patch_spans`` must each launch); then rounds of
   the device, upload and resident routes (6c two, the second in reverse
   order; 4h one, for the time limit; the planes in
   ``DeviceVersionPlanes``, filled in chunks of 2^20 keys), each
   route a fresh snapshot by ``build_region_columnar_device``, every feed
   bit-equal to the main path's and that one to the plain version; cold
   ms by phase for each route in each round; and the three kernels timed
   at this shape beside their bounds, plain versions and yardsticks
   (``patch_rows``: 2 rows with digests, 65,536 rows with and without,
   three planes in one launch beside three calls, ``_patch_plane`` end to
   end queued and as issued);
10. the plan IR: ``sort_perm`` and ``join_build`` (``csrc/sort.cu``),
   ``join_probe`` (``csrc/join.cu``) and ``window_scan``
   (``csrc/window.cu``) against their plain versions, bit for bit: one to
   eight keys over the int64 extremes, ties, float64 with ±0.0, ±inf and
   NaN, byte and constant keys, keys that pack into 31, 32, 33, 64 and 65
   bits (one or two packed images), n = 1, 2, 2049, 4095-4097, 12,289
   (a last tile of one row), 100,003 and 10·2^20; the build dictionary
   with NULL keys, duplicates, keys equal to
   the int64.max sentinel, rows past n_live and no valid row, and the
   valid count and key range it reads in its one wait; the probe on both
   routes (``join_index``'s direct index of dense build keys, launched
   under ``set_sync_debug_mode("error")`` from the build's key range and
   held against its plain version, and the search of sparse ones) with NULL keys on both
   sides, with and without a mask, at a capacity above and below the total
   (the exact total beside the pairs that fit), over dense keys with gaps,
   duplicates, one hot build key, a negative least key, keys at int64.min
   and int64.max − 1, a valid int64.max build key and a span one past the
   threshold (both the sparse route), a span at it and no valid key; the
   window over
   int64 and float64 partition keys (NaN, -0.0), none, one partition over
   every row, a partition on each row, counts, int64 sums, LAG / LEAD of
   int64 and float64 within the kernel's halo and past it (±100, ±5000),
   n around its tile (1279-1281) and at 10·2^20; then config 7 (a 10·2^20-row
   probe table against 2^20 build rows, ``bench.py:243-312``, seed 11:
   ``WHERE v > 0``, inner join on ``k = bk``, ``GROUP BY w``) and its
   cells 7s (``ORDER BY k DESC, v ASC``) and 7w (``PARTITION BY k ORDER
   BY v``: row_number, count, sum, avg, lag 2, lead 1) through
   ``Endpoint.handle_plan(force_backend="device")``, each plan
   wire-encoded first: cold + 5 warm, each answer against a numpy truth,
   the device join counted in ``join_backends``, no degrade, the kernels
   of each cell launched and no other (config 7: ``join_build`` and
   ``join_index`` once, then the cache; ``join_probe`` (the dense route)
   and ``sel_pred`` six times), with the host-clock phases of the cold and
   the median warm request; and the five kernels timed at those shapes
   beside their bounds, plain versions and, for the sorts, composed
   ``torch.argsort(stable=True)`` (and for ``sort_perm`` one
   ``torch.argsort(stable=True)`` over the packed int64 image, packed
   outside the timing), for ``join_index`` (queued, and as issued beside
   the library call) one ``torch.searchsorted`` of the span's keys, for
   ``join_probe`` two (left and right) of the probe
   keys, which compute the runs but not the pairs; ``join_probe`` on both
   routes (config 7's dense build, and its keys spread by 2^20), its bound
   counting the -1 fill up to k_cap, printed beside the count without
   it;
11. ANALYZE and CHECKSUM: ``analyze_column`` (``csrc/analyze.cu``: its
   counting route and its partition route, whose sample is sorted by
   ``csrc/onesweep.cuh``'s pass, shared with ``sort_perm`` and
   ``join_build``: step 10 holds both to their plain versions) against its
   plain version on the card over the CPU tests' edge cases of every
   device dtype (int32, int64, uint32, uint64, float64: NULLs, NaN, −NaN,
   ±0.0, ±inf, the dtype's max, all NULL, one valid row, fewer valid rows
   than buckets, one bucket, one row, ties, padding rows marked valid), n
   around the pass tiles, float64 specials, a full-span int64 column, keys
   of 32 and 33 bits, one value, uint64 past 2^63, 2^20 and 2^22 rows,
   and the routes' own cases (the counting limit and one past it, one
   value on 90%, an4s's and an4r's shapes, a bucket past its shared table,
   ascending ids): rank words, n_valid and distinct counts bit for bit, the
   bounds the unpacking keeps by value, each partition case's counts equal
   to the numpy model's, every route taken; then the cells an4 and an4n
   (config 4's and
   4n's tables, 100·2^20 rows), an4s and an4r (2^24 rows) and an6c
   (config 6c's cold-minted snapshot after its rounds, 10·2^20 keys), each
   every column at 256 buckets through ``Endpoint.handle_analyze``: cold +
   5 warm, each answer equal to the numpy truth, ``analyze`` launched once
   per column and request and no other kernel, one range wait a request,
   no degrade, the host-clock phases of the cold and the median warm
   request; CHECKSUM over 2^16
   rows (the crc64-xz check value, the fold in another order, two
   replicas, a partial range; the native fold against the Python one,
   both timed); and ``analyze`` timed at an4's id, k and v,
   an4s's k and an4r's v as issued and its kernels alone (each column's
   route, each of its kernels' times), beside its bound, the design's own
   bytes, plain version and one ``torch.sort`` of the sentinelled column;
12. the serving path: ``sel_pred_batched`` (``csrc/sel_batched.cu``'s
   terms kernel, ``csrc/selection.cu``'s interpreter) against its plain
   version (the whole buffer, bit for bit) and against G solo ``sel_pred``
   launches (each lane's count and packed mask), over G of 1, 2, 3, 16, 17
   and the lane limit, random programs, int32 extremes, int64 and REAL
   constants, range, int64 and NULL-constant terms, REAL Ne, NULL-bearing
   planes, n not a multiple of 8 or of 32, planes off a 16-byte boundary,
   one block and many; both routes must be taken; then the feed budget
   (``DeviceRunner(hbm_budget_bytes=...)`` with room for one feed of config
   3's plan at 2^20 rows): a second snapshot's feed is refused while a
   deferred request pins the first one's, and evicts it after that fetch,
   every answer against numpy; then 32 deferred requests over configs 2, 3
   and 4's tables (2^22 rows each) dispatched before any wait, each equal
   to its serial answer, with the pinned stager's stats, a
   ``device::before_fetch`` inside one fetch (that request degrades, the
   next does not) and whether an event wait releases the interpreter lock;
   then cell 6b-ep (``bench.py:1130-1300``'s config 6b at the endpoint:
   three tables of 10·2^20 rows, 64 client threads × 6 requests of the
   seeded schedule, 60 s deadlines) through ``Endpoint.handle_async(...)
   .wait()``, once with the coalescer unwired and once bound (window 150
   ms, groups ≤ 16): every answer against numpy, no late ack, no degrade,
   no solo retry, ``sel_pred_batched`` launched in the coalesced phase
   only, mean occupancy above 1.5; p50, p99, requests/s, groups,
   occupancy, router decisions, launches and per-request phases printed;
   and ``sel_pred_batched`` timed at 6b-ep's shape beside its bound, its
   plain version, its interpreter on the same masks, 16 solo ``sel_pred``
   launches and one broadcast ``torch.gt``;
13. the device split: ``split_planes`` (``csrc/split.cu``) against its
   plain version, bit for bit — planes, zero tails and fused digests, the
   digests also against ``plane_digest`` of the child — over bool, int32,
   float32, int64 and float64 planes, both children, pos 0, 1, odd, n − 1
   and off every alignment, children of one row, child pads below and
   equal to the parent's, one block and many, P from 1 to 256 in one
   launch, and a corrupted parent row whose fused digest must expose it;
   then cell 6c-split (``run_split``: config 6c's region of 10·2^20 keys
   through the port's cache, endpoint and ``CoprocessorHost``; split at
   n/2, the right child again at 90% of its rows, then the fallback route
   with ``device::device_split`` armed), every answer against numpy, the
   first request of each child and plan labelled ``split`` (``upload`` on
   the fallback route), no ``columnar_build`` for a split child, every
   stash consumed, the parent feeds dropped, the supervisor's counts
   exact, no degrade, the split's wall and phases and the arena's bytes
   printed; and ``split_planes`` timed at split 1's shape beside its
   bound, plain version and a ``copy_`` + ``plane_digest`` yardstick;
   then cell 6c-delta (``run_delta``: the same history through a cache
   with a ``DeltaSink`` on the observer host; five committed writes
   applied through ``notify_apply_write``, each followed by both plans:
   one UPDATE, 4,096 UPDATEs in 4 runs, 65,536 INSERTs into the slack —
   each patched in place, one ``patch_feed_spans`` launch a feed, no
   upload, no build —, a ROLLBACK (patched, no launch) and a DELETE
   (uploaded); a read below the first write's commit from the line's
   history; a clean scrub; a demotion (the next reads ``hit`` the
   resident feeds), a promotion (one ``plane_digest`` a resident plane,
   no build) and a promotion with ``copr::replica_promote`` armed (the
   region invalidated, the next request one cold mint); then
   ``device::feed_corrupt``: one divergence, the next request on the
   host, the one after uploaded; after each write the memo's record:
   dtypes, hash bounds and byte-plane widths kept after w1-w4, dropped
   after the DELETE), every answer
   against the numpy model, the host ms of ``delta_apply``,
   ``feed_patch`` and the DELETE's upload, and the scrub's, printed; and
   ``patch_feed_spans`` at its three writes' shapes held bit for bit
   against its plain version, then timed queued beside the same rows
   through ``patch_feed_rows`` and a ``copy_`` a plane a span, all from
   the same host values (and the kernel and ``copy_`` again with the
   values on the card), beside its bound and plain version; then cell
   6c-ingest (``run_ingest``, a runner of its own: config 6c's region of
   10·2^20 keys bulk-loaded as ten 2^20-key SST v2 blobs through the apply
   path, a ``ColdStreamBuilder`` parsing each chunk and appending its
   planes to the card; GROUP BY c0 cold and 5 warm through three fresh
   caches: (a) the device rung fed by the stream's take — one mint, one
   ``mvcc_resolve``, no upload —, (b) the device rung parsing at build
   time, (c) the native rung; then a region of 2^16 keys with a tenth of
   its rows in CF_DEFAULT through the device rung — one
   ``patch_feed_rows`` launch, the feed bit for bit against the upload of
   its host mirror —, a clean scrub, and CHECKSUM of its rows through the
   native fold against the Python fold), every answer against numpy, the
   load's seconds and each read's cold ms by phase and warm p50 printed;
   then cell srv (``run_srv``, a runner of its own: the port's ``Node``
   and ``KvService`` in process, one region of partitioned-raft-kv's
   size, 10·2^20 keys bulk-loaded through ``ImportUpload`` /
   ``ImportIngest``, reads, a 2PC write patched in place, point reads,
   ANALYZE, CHECKSUM, a forced host read) with its step 6: ``SplitRegion``
   at handle 5·2^20 (raft apply slices the resident feeds: four
   ``split_planes``, no mint, no upload, no fallback), both plans on each
   child cold + 2 warm against the numpy truth of its handles, then
   ``MergeRegion`` back (both lines drop, the merged region's read mints
   once), the split's phases and the merge's ms printed; then cell rs3
   (``run_rs3``: three stores of the port's ``Cluster`` at TiKV's classic
   raft-kv defaults, stores 1 and 2 each with a runner of its own, 6c's
   table at 2^22 keys in four raft ingest entries, the logs compacted:
   the split checker's half-split and a PD split at 90% of the right
   child, each slicing store 1's feeds by ``split_planes`` with no mint
   and no upload; a 4,096-row 2PC write patched in place; a leader round
   trip to store 2 and back, the promotion one ``plane_digest`` a
   resident plane with no rebuild and no mint; ``check_consistency`` on
   every region; store 3's peer removed and added back, caught up by a
   raft snapshot, its CFs equal to store 1's; a merge dropping both
   lines, the merged read minting once), every answer against numpy, the
   RSS around the load and each step's ms printed; then cell net
   (``run_net``: TiKV's minimum deployment on loopback in this process, a
   ``PdServer`` and three ``TikvServer``s, each node with a runner of its
   own on the card; region 1's peers added over gRPC, 6c's table at 2^22
   keys through ``TxnClient.ingest_sst`` replicated by ``BatchRaft``, the
   checker's split, both plans on every region, a region's selection
   through ``CoprocessorStream`` and its GROUP BY on a ``BatchCommands``
   stream, a 4,096-row 2PC, a split, a leader round trip and a merge
   over RPC, the stop leaving no thread), every answer against numpy; and
   phase cli (``start_cli`` before net, ``run_cli`` after: ``python -m
   tikv_tpu_torch.server pd`` and ``tikv`` on the card with the config
   template, ``ctl``'s commands, a GROUP BY from the card, the status
   server's ``/status`` and ``/config``, SIGTERM exiting 0, no kernel
   rebuilt);
14. the mesh (its merge checks and the cells m3, m4, m4n and m4s, which
   launch no kernel of ``selection.cu``, run while that source builds,
   after the ANALYZE cells): ``shard_psum``, ``shard_bucket_merge`` and
   ``shard_merge`` (``csrc/shard_merge.cu``) against their plain versions,
   bit for bit, over S of 1, 2, 3, 4 and 8 sources, int64 words with the
   extremes, float64 words with ±0.0, ±inf and NaN, W of 1, 3, 1027 and
   65,537 words, mixed int64 / float64 segments, sum and min/max segments
   mixed in one launch (``shard_merge``), sources off a 16-byte boundary
   (on one phase and on mixed phases) and more segments than one launch
   takes; then the mesh cells (``configs.MESH_CELLS``) through
   ``DeviceRunner(mesh=make_mesh([card] * 4, shape=(2, 2)))``: m3, m4,
   m4x (``dryrun_multichip``'s shape), m4n, m4s, m2s (``v > 800``, then
   2s's 0.1%, whose warm requests take the index route) and m5t, each
   plan one cold and five warm wire-encoded requests, each answer against
   the numpy truth and against the single runner's answer, the launch
   counts read around the run (each shard's kernels S times as often as on
   the single runner, the merges of the route and no other kernel: at m4x
   one ``shard_merge`` launch a request, counted as ``shard_bucket_merge``,
   and no ``shard_psum``), the
   peak device memory and a profile, and the tracker phases of a warm
   request (a GROUP BY's MIN/MAX merge on the card: no host merge phase);
   no degrade; the ``device::shard_launch`` failpoint at shard 1 (the
   host pipeline answers, the lock is free, the next request runs on the
   card); one request through ``Endpoint.handle(force_backend="device")``;
   a simple MIN/MAX whose S stacked rows the host merges (phase
   ``shard_merge``) against the truth and the single runner; where the
   machine has more cards, m4, m4x and m5t over a mesh of every card; and
   at m4, m4n and m4x the per-shard launches beside the single launch,
   ``shard_psum`` (m4, m4n) and ``shard_merge`` (m4x: the fold's summed
   and MIN/MAX rows in one launch) on the runner's own arguments beside
   their bounds, plain versions and a ``torch.stack`` yardstick, each as
   issued (host clock), at m4 the psum's marginal time in the chain of the
   four per-shard ``hash_agg`` calls, launched programmatically and not,
   and at m4x the marginal time after the four ``agg_fold`` calls of the
   one merge launch, of the psum of the summed rows alone and of the two
   launches (psum, then bucket merge) it replaced;
15. the scale-out mesh (cell so8): ``feed_verify`` (``csrc/digest.cu``)
   against its plain version and one ``plane_digest`` a plane, bit for
   bit, over P of 1 to 200 planes (past 96 its descriptors go through a
   device table), every feed width, planes off a 16-byte boundary, ragged
   and empty ranges, up to 2^24 + 3 rows; then a placement runner
   (``DeviceRunner(mesh=make_mesh([card] * 4, shape=(2, 2)),
   placement=True, slice_latency_outlier_s=1.0)``, its slices spread over
   every visible card) behind
   ``Endpoint.handle_async(...).wait()``: eight regions of 6b-ep's
   ``int_table(2)`` shape at 2^21 rows (one region at
   ``region_split_size_mb = 96``; each placed whole on a slice) and one of
   10·2^20 rows (the whole-mesh route), each plan cold once, then 6b-ep's
   mix (Zipf 2.0 over the nine regions, 75% ``c1 > thr``, 25% ``GROUP BY
   c0``) as 256 requests from 16 threads, twice (warm p50 and p99 by
   route from the second pass); a
   forced ``rebalance()`` and one timed migration (host copy, verify and
   install ms; ``feed_verify`` once a feed); ``device::feed_migrate``
   armed once (the migration ends "corrupt", the anchor's next request is
   answered on the host, then both feeds are minted again);
   ``device::slice_dead`` on slice 1 until it trips (its anchors drain by
   migration, the whole-mesh region runs on the degraded submesh); the
   fault lifted and a canary re-admitting slice 1 with a decayed score,
   the whole mesh restored.  Every answer equals the numpy truth, the
   whole-mesh region's also the single runner's; no degrade outside the
   armed failpoints (and the corrupt move's quarantine); ``feed_verify`` launched once a migrated feed (and
   once for the corrupt one); the kernel timed queued at the moved
   selection feed (three int32 planes, 2^21 rows) beside its bound, its
   plain version and P ``plane_digest`` launches, and the copy beside its
   bound;
16. one JSON line listing every ported kernel: launches on the main path,
   largest difference from the plain version, kernel / plain / library
   times at its main shape (config 4 for ``hash_agg``, with configs 3, 4
   and 4s under ``configs``; config 4n for ``twolevel``'s fused entry, with
   its route at each config; config 2 for ``sel_pred``, with 5t under
   ``configs``; config 2 for ``sel_mask``; config 2s's 1% for
   ``sel_compact``; config 5 for ``topn_select``; config 4m for
   ``agg_fold``, with 3n under ``configs``; config 4h for
   ``mvcc_resolve``, ``plane_digest`` and ``patch_rows``, with 6c under
   ``configs``; configs 7, 7s and 7w for ``join_build`` / ``join_index``
   / ``join_probe``, ``sort_perm`` and ``window_scan``; an4's id for
   ``analyze``, with the other timed columns under ``configs``; 6b-ep's
   shape for ``sel_pred_batched``; 6c-split's split 1 for
   ``split_planes``, with both children under ``configs``; 6c-delta's
   65,536-row insert for ``patch_spans``, with its other writes under
   ``configs``; m4 for
   ``shard_psum``, with m4n under ``configs``; m4x's one ``shard_merge``
   launch for ``shard_bucket_merge``; so8's moved selection feed for
   ``feed_verify``), and the least time the card could take; beside the
   launch-bound rows the launch floor and the empty kernel with their
   parameter blocks' sizes (``param_floors``);
17. the last line: ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import ctypes
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
SCALAR_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit peak
SF_TOL = 1e-9                   # float cells: × Σ|v| of the cell
HEADER_BYTES = 16               # sel_compact's count and overflow flag
CLOCK_HZ = 1.98e9               # H100 SXM boost clock (sleep cycles)

KERNELS = ("hash_agg", "twolevel", "sel_pred", "sel_pred_batched",
           "sel_mask", "sel_compact",
           "topn_select", "agg_fold", "mvcc_resolve", "plane_digest",
           "patch_rows", "join_build", "join_index", "join_probe",
           "sort_perm", "window_scan", "analyze", "split_planes",
           "shard_psum", "shard_bucket_merge", "feed_verify",
           "patch_spans")
# config → rows on the card; the route's kernel counts must be > 0
SIZES = {"3": 50 << 20, "4": 100 << 20, "4s": 1 << 24, "4n": 100 << 20,
         "4w": 100 << 20, "4r": 1 << 24, "4m": 1 << 24, "3n": 1 << 24}
ROUTE = {"3": "hash_agg", "4": "hash_agg", "4s": "hash_agg",
         "4n": "twolevel", "4w": "twolevel", "4r": "twolevel",
         "4m": "agg_fold", "3n": "agg_fold"}
# the configs that return rows: rows on the card, the kernels they launch
ROW_SIZES = {"1": 1 << 20, "2": 10 << 20, "5": 100 << 20, "5t": 100 << 20}
ROW_ROUTE = {"1": {"sel_pred"}, "2": {"sel_pred"}, "5": {"topn_select"},
             "5t": {"topn_select", "sel_pred"}}
SWEEP_ROWS = 10 << 20
# config 2s: the route each selectivity must take once its EWMA is warm
SWEEP_ROUTE = {"0.1%": "compact", "1%": "index", "10%": "mask",
               "50%": "mask"}


def cuda_ms(fn, iters: int, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    ``queued``: ``fn`` never waits for the device, and its calls are
    queued behind a device sleep six times as long as the host takes to
    issue them (the slowest of three issues, so a slow moment of a shared
    host does not outlast it), so the device runs them back to back and
    the host's Python does not show (fails if the sleep ended first).
    Otherwise the calls run as issued (for the plain versions and library
    calls, whose device time dwarfs their host time)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event()
    if queued:
        issue_s = 0.0
        for _ in range(3):              # the host's issue time
            t0 = time.perf_counter()
            fn()
            issue_s = max(issue_s, time.perf_counter() - t0)
            torch.cuda.synchronize()
        torch.cuda._sleep(int(max(1 << 24, 6 * iters * issue_s * CLOCK_HZ)))
        slept.record()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    assert not (queued and slept.query()), \
        "the host issued the calls too slowly to time"
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: float, ops: float) -> dict:
    b_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    b_ops = ops / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


def counts() -> dict:
    from tikv_tpu_torch.device import (agg_fold, analyze, digest, hash_agg,
                                       join_probe, mvcc, selection, shard,
                                       sort, split, topn, twolevel, window)
    return {"hash_agg": hash_agg.launches, "twolevel": twolevel.launches,
            "sel_pred": selection.pred_launches,
            "sel_pred_batched": selection.batched_launches,
            "sel_mask": selection.mask_launches,
            "sel_compact": selection.compact_launches,
            "topn_select": topn.launches, "agg_fold": agg_fold.launches,
            "mvcc_resolve": mvcc.resolve_launches,
            "plane_digest": digest.digest_launches,
            "patch_rows": digest.patch_launches,
            "join_build": sort.build_launches,
            "join_index": join_probe.index_launches,
            "join_probe": join_probe.launches,
            "sort_perm": sort.sort_launches,
            "window_scan": window.launches,
            "analyze": analyze.analyze_launches,
            "split_planes": split.launches,
            "shard_psum": shard.psum_launches,
            "shard_bucket_merge": shard.merge_launches,
            "feed_verify": digest.verify_launches,
            "patch_spans": digest.span_launches}


def set_counts(values: dict) -> None:
    from tikv_tpu_torch.device import (agg_fold, analyze, digest, hash_agg,
                                       join_probe, mvcc, selection, shard,
                                       sort, split, topn, twolevel, window)
    hash_agg.launches = values["hash_agg"]
    twolevel.launches = values["twolevel"]
    selection.pred_launches = values["sel_pred"]
    selection.batched_launches = values["sel_pred_batched"]
    selection.mask_launches = values["sel_mask"]
    selection.compact_launches = values["sel_compact"]
    topn.launches = values["topn_select"]
    agg_fold.launches = values["agg_fold"]
    mvcc.resolve_launches = values["mvcc_resolve"]
    digest.digest_launches = values["plane_digest"]
    digest.patch_launches = values["patch_rows"]
    sort.build_launches = values["join_build"]
    join_probe.index_launches = values["join_index"]
    join_probe.launches = values["join_probe"]
    sort.sort_launches = values["sort_perm"]
    window.launches = values["window_scan"]
    analyze.analyze_launches = values["analyze"]
    split.launches = values["split_planes"]
    shard.psum_launches = values["shard_psum"]
    shard.merge_launches = values["shard_bucket_merge"]
    digest.verify_launches = values["feed_verify"]
    digest.span_launches = values["patch_spans"]


# the builds still running after build_kernels(defer=...): name → future
_PENDING_BUILDS: dict = {}


def build_kernels(defer: tuple = ()) -> None:
    """One ``nvcc`` per source, all started together; returns once every
    source but those in ``defer`` is built (``await_builds`` waits for
    those), so the checks of the built kernels run while a slow source
    (``selection.cu``, minutes) still compiles.  No kernel of a deferred
    source may be loaded before ``await_builds``."""
    from tikv_tpu_torch.device import build

    def one(name):
        t0 = time.perf_counter()
        log = build.build(name)
        print(f"build: {name} in {time.perf_counter() - t0:.3f} s",
              flush=True)
        print(f"ptxas {name}: {ptxas_summary(log)}", flush=True)

    pool = ThreadPoolExecutor(len(build.SOURCES))
    futures = {name: pool.submit(one, name) for name in build.SOURCES}
    pool.shutdown(wait=False)
    for name, fut in futures.items():
        if name in defer:
            _PENDING_BUILDS[name] = fut
        else:
            fut.result()
    shared_atomics("hash_agg")
    fold = shared_atomics("agg_fold")
    # the shared route of an all-integer launch (4m's) keeps no float64
    # shared add (a compare-and-swap loop, ATOMS.CAS / ATOMS.CAST)
    ints_only = {k: v for f, kinds in fold.items()
                 if "fold_shared" in f and "Lb0E" in f
                 for k, v in kinds.items()}
    assert ints_only and not any("CAS" in k for k in ints_only), \
        f"agg_fold's integer shared route: {ints_only}"
    print(f"sass agg_fold integer shared route: shared atomics " + " ".join(
        f"{k}x{v}" for k, v in sorted(ints_only.items())) +
        " (no float64 compare-and-swap loop)", flush=True)
    order = psum_loads_first(4)
    assert order["loads_before_add"] >= 4, \
        f"psum_kernel<4> adds before its sources' loads are issued: {order}"
    # printed, not held: ptxas interleaves the mixed kernel's float64 pair
    # path (its int64 sums, m4x's, issue every load first)
    psum_loads_first(4, "merge_kernel")


def await_builds() -> None:
    """Wait for the builds ``build_kernels`` deferred (raises if one
    failed)."""
    while _PENDING_BUILDS:
        _PENDING_BUILDS.popitem()[1].result()


def ptxas_summary(log: str) -> str:
    """One line from ``-Xptxas -v``'s report: kernels, the most registers
    any uses, and the largest stack frame and spills."""
    regs, frames, spills, kernels = [0], [0], [0], 0
    for line in log.splitlines():
        words = line.replace(",", " ").split()
        if "Compiling entry function" in line:
            kernels += 1
        for i, w in enumerate(words[1:], 1):
            if w == "registers" and words[i - 1].isdigit():
                regs.append(int(words[i - 1]))
            if w == "bytes" and words[i - 1].isdigit() and i + 1 < len(words):
                if words[i + 1] == "stack":
                    frames.append(int(words[i - 1]))
                elif words[i + 1] == "spill":
                    spills.append(int(words[i - 1]))
    return (f"{kernels} kernels, at most {max(regs)} registers, largest "
            f"stack frame {max(frames)} B, largest spill {max(spills)} B")


def shared_atomics(name: str) -> dict:
    """Print the shared-memory atomic instructions of a built library's
    SASS by kind (``cuobjdump -sass``), e.g. whether a 64-bit add is one
    ATOMS.ADD.64 or a compare-and-swap loop; → per device function (its
    mangled name) its kinds and counts."""
    from tikv_tpu_torch.device import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.lib_path(name))],
                          capture_output=True, text=True).stdout
    kinds: dict = {}
    per_fn: dict = {}
    fn = ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            per_fn.setdefault(fn, {})
        for word in line.replace(";", " ").split():
            if word.startswith("ATOMS"):
                kinds[word] = kinds.get(word, 0) + 1
                per_fn.setdefault(fn, {})
                per_fn[fn][word] = per_fn[fn].get(word, 0) + 1
    print(f"sass {name}: shared atomics " + (" ".join(
        f"{k}x{v}" for k, v in sorted(kinds.items())) or "none"), flush=True)
    return per_fn


def psum_loads_first(S: int = 4, kernel: str = "psum_kernel") -> dict:
    """The order of the global loads and float64 adds on the float64 word
    pair path of ``kernel<S>``'s SASS (``psum_kernel`` or
    ``merge_kernel``, whose float64 adds are its sum_f64 path's;
    ``cuobjdump -sass``): how many 16-byte loads are issued back to back
    before that path's first add (S: every source's load in flight at
    once) → {"loads_before_add": k, "sequence": run-length opcodes}."""
    from tikv_tpu_torch.device import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.lib_path("shard_merge"))],
                          capture_output=True, text=True).stdout
    ops, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = f"{kernel}ILi{S}E" in line
            continue
        if not inside:
            continue
        for word in line.replace(";", " ").split():
            if word.startswith(("LDG", "DADD", "STG")):
                ops.append(word)
    runs = []
    for op in ops:
        if runs and runs[-1][0] == op:
            runs[-1][1] += 1
        else:
            runs.append([op, 1])
    # the first add that follows a 16-byte load: the pair path's
    first = next((i for i in range(1, len(runs))
                  if runs[i][0].startswith("DADD") and
                  runs[i - 1][0] == "LDG.E.128"), None)
    res = {"loads_before_add": 0 if first is None else runs[first - 1][1],
           "sequence": " ".join(f"{op}x{k}" for op, k in runs)}
    print(f"sass shard_merge {kernel}<{S}>: {res['loads_before_add']} "
          f"16-byte loads issued before the float64 pair path's first add; "
          f"{res['sequence']}", flush=True)
    return res


# ---------------------------------------------------------------------------
# hash_agg against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(dev, big: int):
    """(name, hash_agg keyword arguments) pairs on the card."""
    from tikv_tpu_torch.device.hash_agg import Lane
    g = torch.Generator(device="cpu").manual_seed(11)
    B = 1 << 18

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g,
                             dtype=torch.int64).to(torch.int32).to(dev)

    def bools(p, n):
        return (torch.rand(n, generator=g) < p).to(dev)

    k, v = ints(0, 1000, B), ints(-1000, 1000, B)
    dense = dict(mode="dense", n=B, slots=1026, n_slots=1024, key=k,
                 base=0, capacity=1024)
    yield "dense", dict(dense, lanes=[Lane(values=v)])
    yield "dense_expr_key", dict(
        dense, n_slots=1025, key=ints(-3, 1003, B), key_ok=bools(0.9, B),
        base=-3, mask=bools(0.7, B),
        lanes=[Lane(values=v, ok=bools(0.8, B)), Lane(ok=bools(0.5, B))])
    yield "sparse", dict(mode="sparse", n=B, slots=1026, n_slots=1025,
                         key=ints(0, 1026, B), capacity=1024,
                         lanes=[Lane(values=v)])
    yield "simple", dict(mode="simple", n=B, slots=1, n_slots=1,
                         lanes=[Lane(values=v), Lane(values=v,
                                                     ok=bools(0.5, B)),
                                Lane(ok=bools(0.3, B))])
    yield "selection_keeps_nothing", dict(
        dense, mask=torch.zeros(B, dtype=torch.bool, device=dev),
        lanes=[Lane(values=v)])
    yield "ragged_n", dict(dense, n=B - 12345, lanes=[Lane(values=v)])
    edge = torch.tensor([2**31 - 1, -(2**31 - 1)], dtype=torch.int32,
                        device=dev)
    yield "int32_extremes", dict(
        dense, lanes=[Lane(values=edge[ints(0, 2, B).long()])])
    yield "count_sum_avg", dict(
        dense, mask=bools(0.5, B),
        lanes=[Lane(ok=bools(0.6, B)), Lane(values=v, ok=bools(0.6, B)),
               Lane(values=ints(-5, 5, B))])
    yield "4096_slots_split_lanes", dict(
        mode="dense", n=B, slots=4098, n_slots=4096, key=ints(0, 4096, B),
        base=0, capacity=4096,
        lanes=[Lane(values=ints(-100, 100, B), ok=bools(0.5, B))
               for _ in range(6)])
    kb, vb = ints(0, 1024, big), ints(-1000, 1000, big)
    yield f"dense_{big}_rows", dict(mode="dense", n=big, slots=1026,
                                    n_slots=1024, key=kb, base=0,
                                    capacity=1024, lanes=[Lane(values=vb)])
    # the redesign's edges: one hot slot over 2^24 rows at the int32
    # extremes (the packed cells fold every 2^15 rows), in each mode
    hot = 1 << 24
    ext = torch.tensor([2**31 - 1, -2**31], dtype=torch.int32,
                       device=dev)[ints(0, 2, hot).long()]
    ext[: hot // 2] = 2**31 - 1                 # a sum far past int32
    for mode, key in (("dense", torch.full((hot,), 1000, dtype=torch.int32,
                                           device=dev)),
                      ("sparse", torch.full((hot,), 7, dtype=torch.int32,
                                            device=dev))):
        yield f"hot_slot_{mode}_int32_extremes_{hot}_rows", dict(
            mode=mode, n=hot, slots=1026, n_slots=1024, key=key, base=0,
            capacity=1024, lanes=[Lane(values=ext), Lane(values=ext),
                                  Lane(ok=bools(0.5, hot))])
    yield f"hot_slot_simple_int32_extremes_{hot}_rows", dict(
        mode="simple", n=hot, slots=1, n_slots=1,
        lanes=[Lane(values=ext), Lane(values=ext, ok=bools(0.5, hot))])
    yield f"hot_slot_narrow_values_{hot}_rows", dict(
        mode="dense", n=hot, slots=1026, n_slots=1024, value_bytes=1,
        key=torch.full((hot,), 3, dtype=torch.int32, device=dev), base=0,
        capacity=1024, lanes=[Lane(values=torch.full(
            (hot,), -128, dtype=torch.int32, device=dev))])
    del ext
    # values of 2 bytes: 32-bit split cells, folded every 2^16 rows
    e16 = torch.tensor([2**15 - 1, -2**15], dtype=torch.int32,
                       device=dev)[ints(0, 2, hot).long()]
    for mode, key in (("dense", torch.full((hot,), 1023, dtype=torch.int32,
                                           device=dev)),
                      ("sparse", torch.zeros(hot, dtype=torch.int32,
                                             device=dev))):
        yield f"hot_slot_{mode}_int16_extremes_{hot}_rows_split", dict(
            mode=mode, n=hot, slots=1026, n_slots=1024, key=key, base=0,
            capacity=1024, value_bytes=2,
            lanes=[Lane(values=e16), Lane(values=e16, ok=bools(0.5, hot)),
                   Lane(ok=bools(0.5, hot))])
    del e16
    yield "dense_split", dict(dense, value_bytes=2, lanes=[Lane(values=v)])
    yield "sparse_split", dict(mode="sparse", n=B, slots=1026, n_slots=1025,
                               key=ints(0, 1026, B), capacity=1024,
                               value_bytes=2, lanes=[Lane(values=v)])
    yield "dense_expr_key_split", dict(
        dense, n_slots=1025, key=ints(-3, 1003, B), key_ok=bools(0.9, B),
        base=-3, mask=bools(0.7, B), value_bytes=2,
        lanes=[Lane(values=v, ok=bools(0.8, B)), Lane(ok=bools(0.5, B))])
    yield "4096_slots_split_cells_3_lanes", dict(
        mode="dense", n=B, slots=4098, n_slots=4096, key=ints(0, 4096, B),
        base=0, capacity=4096, value_bytes=1,
        lanes=[Lane(values=ints(-128, 128, B)) for _ in range(3)])
    # repeated lanes: one values plane under two validity planes, a lane
    # repeated, and a COUNT lane sharing a validity plane
    a, b = bools(0.6, B), bools(0.3, B)
    for vb in (2, 4):
        yield f"repeated_lanes_two_validities_{vb}_byte_values", dict(
            dense, mask=bools(0.8, B), value_bytes=vb,
            lanes=[Lane(values=v, ok=a), Lane(values=v, ok=b),
                   Lane(values=v, ok=a), Lane(ok=b), Lane(values=v)])
    yield "config_3_lanes_one_plane", dict(
        mode="simple", n=B, slots=1, n_slots=1, value_bytes=2,
        lanes=[Lane(values=v), Lane(values=v)])
    # planes 1-3 elements off a 16-byte boundary: all at one phase (a
    # scalar head, then 16-byte loads), or at different phases (scalar)
    K, V = ints(0, 1024, B + 8), ints(-1000, 1000, B + 8)
    M, O = bools(0.7, B + 8), bools(0.6, B + 8)
    for off in (1, 2, 3):
        for mode, vb in (("dense", 4), ("dense", 2), ("simple", 4)):
            yield f"{mode}_{vb}_byte_planes_off_by_{off}", dict(
                dense, mode=mode, n=B - 5, key=K[off:], mask=M[off:],
                slots=1026 if mode == "dense" else 1,
                n_slots=1024 if mode == "dense" else 1, value_bytes=vb,
                lanes=[Lane(values=V[off:], ok=O[off:])])
            yield f"{mode}_{vb}_byte_planes_off_by_{off}_phases_differ", dict(
                dense, mode=mode, n=B - 5, key=K[off:], mask=M[4 - off:],
                slots=1026 if mode == "dense" else 1,
                n_slots=1024 if mode == "dense" else 1, value_bytes=vb,
                lanes=[Lane(values=V[(off + 1) % 4:])])
    for n in (1, 3, 4097, B - 1):
        for vb in (2, 4):
            yield f"n_{n}_not_a_multiple_of_4_{vb}_byte_values", dict(
                dense, n=n, mask=M, value_bytes=vb, lanes=[Lane(values=v)])
    yield "4096_slots_8_lanes", dict(
        mode="dense", n=B, slots=4098, n_slots=4096, key=ints(0, 4096, B),
        base=0, capacity=4096,
        lanes=[Lane(values=ints(-(1 << 30), 1 << 30, B), ok=bools(0.5, B))
               for _ in range(8)])


def plain_args(kw: dict) -> dict:
    """hash_agg's arguments without the kernel's value width."""
    return {k: v for k, v in kw.items() if k != "value_bytes"}


def max_abs_diff(got, want) -> int:
    (c1, o1), (c2, o2) = got, want
    worst = int((c1 - c2).abs().max())
    for a, b in zip(o1, o2):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                worst = max(worst, int((x - y).abs().max()))
    return worst


def check_kernels(dev, big: int) -> int:
    from tikv_tpu_torch.device import hash_agg as ha
    worst = 0
    for name, kw in kernel_cases(dev, big):
        got = ha.hash_agg(device=dev, **kw)
        torch.cuda.synchronize()
        want = ha.hash_agg_plain(device=dev, **plain_args(kw))
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        print(f"kernel hash_agg {name}: max_abs_err={err}", flush=True)
        assert err == 0, f"hash_agg {name} disagrees with its plain version"
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# twolevel against its plain version
# ---------------------------------------------------------------------------

def twolevel_err(idx, L8, Lf, LO, HI) -> float:
    """Kernel against plain version: S8 exactly; Sf within SF_TOL·Σ|v| per
    cell.  Returns the largest absolute difference."""
    from tikv_tpu_torch.device import twolevel as tl
    got8, gotf = tl.twolevel(idx, L8, Lf, LO, HI)
    torch.cuda.synchronize()
    want8, wantf = tl.twolevel_plain(idx, L8, Lf, LO, HI)
    assert torch.equal(got8, want8), "twolevel int8 planes disagree"
    if Lf is None:
        assert gotf is None
        return 0.0
    _w, mag = tl.twolevel_plain(idx, L8[:1], Lf.abs(), LO, HI)
    diff = (gotf - wantf).abs()
    assert bool((diff <= SF_TOL * mag).all()), \
        "twolevel float planes beyond tolerance"
    return float(diff.max())


def twolevel_cases(dev):
    """(name, idx, L8, Lf, LO, HI) on the card: the CPU tests' edge cases
    (plane counts, both routes, NULL/scrap/out-of-range slots, padding
    rows, int8 extremes, a hot slot past the per-block row cap)."""
    from tikv_tpu_torch.device import kernels as kn
    g = torch.Generator(device="cpu").manual_seed(12)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int64).to(dtype).to(dev)

    def floats(shape):
        return (torch.randn(shape, generator=g) * 1000).to(dev)

    n = 1 << 18
    for p8, pf in ((1, 0), (3, 1), (8, 2), (32, 0)):
        for slots in (1026, 65538, (1 << 20) + 2):
            LO, HI = kn.twolevel_dims(slots, p8, pf)
            idx = ints(-2, HI * LO + 3, (n,))           # beyond both ends
            L8 = ints(-128, 128, (p8, n), torch.int8)
            Lf = floats((pf, n)) if pf else None
            yield f"p8={p8}_pf={pf}_slots={slots}", idx, L8, Lf, LO, HI
    LO, HI = 16, 72
    idx = torch.full((n,), 1025, dtype=torch.int32, device=dev)  # scrap
    idx[: n // 2] = 1024                                         # NULL slot
    yield "null_and_scrap_slots", idx, ints(-128, 128, (8, n), torch.int8), \
        None, LO, HI
    yield "ragged_n", ints(0, 1026, (n - 12345,)), \
        ints(-128, 128, (8, n - 12345), torch.int8), None, LO, HI
    yield "one_row", ints(0, 1026, (1,)), ints(-128, 128, (3, 1), torch.int8), \
        floats((1, 1)), 32, 40
    hot = (1 << 24) + 777
    extremes = torch.tensor([-128, 127], dtype=torch.int8,
                            device=dev)[ints(0, 2, (hot,)).long()]
    yield "hot_slot_int8_extremes", \
        torch.zeros(hot, dtype=torch.int32, device=dev), \
        torch.stack([torch.full((hot,), -128, dtype=torch.int8, device=dev),
                     extremes]), None, 32, 40


# the Pallas prototypes' shapes: rows, HI, LO, numpy seed of their data
PROTOTYPES = {"prof_pallas": (1 << 23, 32, 32, 0),
              "prof_pl": (100 << 20, 40, 32, 7)}


def prototype_inputs(name: str, dev):
    """A Pallas prototype's own shape and data, as (idx, L8, LO, HI, k, v):
    ``prof/prof_pallas.py`` (planes [mask, mask, b0, b1]) or
    ``prof/prof_pl.py`` (planes [mask, b0, b1]; idx = k), with k uniform
    over 1024 slots and v over [-1000, 1000)."""
    N, HI, LO, seed = PROTOTYPES[name]
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1024, N).astype(np.int32)
    v = rng.integers(-1000, 1000, N).astype(np.int32)
    kt = torch.from_numpy(k).to(dev)
    biased = torch.from_numpy(v).to(dev) + (1 << 15)
    mask = torch.ones(N, dtype=torch.int8, device=dev)
    b0 = ((biased & 0xFF) - 128).to(torch.int8)
    b1 = (((biased >> 8) & 0xFF) - 128).to(torch.int8)
    planes = [mask, mask, b0, b1] if name == "prof_pallas" \
        else [mask, b0, b1]
    return kt, torch.stack(planes), LO, HI, k, v


def prototype_check(name: str, S8, LO: int, HI: int, k, v) -> None:
    """The prototype's own check: count by bincount and the sum rebuilt
    with its bias formula equal numpy's."""
    P = S8.shape[1] // LO
    S = S8.cpu().numpy().reshape(HI, P, LO).transpose(1, 0, 2) \
        .reshape(P, HI * LO)[:, :1024]
    want_cnt = np.bincount(k, minlength=1024)
    want_sum = np.bincount(k, weights=v, minlength=1024).astype(np.int64)
    if name == "prof_pallas":
        ok = S[1]
        cnt = S[0]
        got_sum = (S[2] + 128 * ok) + 256 * (S[3] + 128 * ok) - (1 << 15) * ok
    else:
        cnt = S[0]
        got_sum = S[1] + (S[2] << 8) + S[0] * (128 + (128 << 8) - (1 << 15))
    assert np.array_equal(cnt, want_cnt), f"{name}: count differs"
    assert np.array_equal(got_sum, want_sum), f"{name}: sum differs"
    print(f"prototype {name}: count exact, sum exact", flush=True)


def check_twolevel(dev) -> float:
    worst = 0.0
    for name, idx, L8, Lf, LO, HI in twolevel_cases(dev):
        err = twolevel_err(idx, L8, Lf, LO, HI)
        print(f"kernel twolevel {name}: max_abs_err={err} (int8 planes "
              f"exact, float planes within {SF_TOL}·Σ|v|)", flush=True)
        worst = max(worst, err)
    for name in PROTOTYPES:
        idx, L8, LO, HI, k, v = prototype_inputs(name, dev)
        err = twolevel_err(idx, L8, None, LO, HI)
        from tikv_tpu_torch.device import twolevel as tl
        prototype_check(name, tl.twolevel(idx, L8, None, LO, HI)[0],
                        LO, HI, k, v)
        print(f"kernel twolevel {name} shape ({idx.shape[0]} rows): "
              f"max_abs_err={err}", flush=True)
        del idx, L8
        gc.collect()
    return worst


# ---------------------------------------------------------------------------
# twolevel's fused entry against its plain version
# ---------------------------------------------------------------------------

def fused_route(n, layouts, cols, LO, HI, kw, dev) -> str:
    """The route the fused kernel takes for these arguments."""
    from tikv_tpu_torch.device import twolevel as tl
    _lanes, src8, srcf = tl.plan_lanes(layouts, cols)
    source = "sparse" if kw.get("slot_ids") is not None else \
        "dense32" if kw["key"].dtype == torch.int32 else "dense64"
    name, cs = tl.route(max(src8) + 1, max(srcf, default=-1) + 1, LO, HI,
                        source, dev)
    return name if name != "cluster" else f"cluster{cs}"


def fused_err(n, layouts, cols, LO, HI, kw) -> float:
    """Fused kernel against its plain version: S8 exactly, the overflow
    flag, Sf within SF_TOL·Σ|v| per cell.  Returns the largest absolute
    difference."""
    from tikv_tpu_torch.device import twolevel as tl
    got8, gotf, got_ovf = tl.twolevel_fused(n, layouts, cols, LO, HI, **kw)
    torch.cuda.synchronize()
    want8, wantf, want_ovf = tl.twolevel_fused_plain(n, layouts, cols, LO,
                                                     HI, **kw)
    assert torch.equal(got8, want8), "twolevel_fused int8 planes disagree"
    assert (got_ovf is None) == (want_ovf is None)
    assert got_ovf is None or bool(got_ovf) == bool(want_ovf), \
        "twolevel_fused overflow flag disagrees"
    if wantf is None:
        assert gotf is None
        return 0.0
    mags = [col if col is None or not col[0].is_floating_point()
            else (col[0].abs(), col[1]) for col in cols]
    mag = tl.twolevel_fused_plain(n, layouts, mags, LO, HI, **kw)[1]
    diff = (gotf - wantf).abs()
    assert bool((diff <= SF_TOL * mag).all()), \
        "twolevel_fused float planes beyond tolerance"
    return float(diff.max())


def fused_cases(dev):
    """(name, n, layouts, cols, LO, HI, keyword arguments) on the card: the
    CPU tests' cases at slot counts that take each route, a hot slot past
    the per-table row cap, and a live key out of range."""
    from tikv_tpu_torch.device import kernels as kn
    from tikv_tpu_torch.ops.agg import AggSpec
    g = torch.Generator(device="cpu").manual_seed(13)
    n = 1 << 18

    def ints(lo, hi, count, dtype=torch.int32):
        return torch.randint(lo, hi, (count,), generator=g,
                             dtype=torch.int64).to(dtype).to(dev)

    def bools(p, count):
        return (torch.rand(count, generator=g) < p).to(dev)

    def column(nb, dtype, nullable, count=n):
        lo, hi = -(1 << (8 * nb - 1)), (1 << (8 * nb - 1)) - 1
        v = torch.randint(lo, hi, (count,), generator=g, dtype=torch.int64)
        v[:4] = torch.tensor([lo, hi, 0, -1])
        ok = bools(0.85, count) if nullable else \
            torch.ones(count, dtype=torch.bool, device=dev)
        return v.to(dtype).to(dev), ok, nb

    def case(aggs, columns, slots, key_kind="int32", mask_kind="partial",
             count=n):
        specs = [AggSpec(kind, i) for i, (kind, _c) in enumerate(aggs)]
        real = [c is not None and columns[c][0].is_floating_point()
                for _k, c in aggs]
        nbytes = [0 if c is None or r or k == "count" else columns[c][2]
                  for (k, c), r in zip(aggs, real)]
        aliased = [c is not None and bool(columns[c][1].all())
                   for _k, c in aggs]
        layouts, p8, pf = kn.build_layouts(specs, real, nbytes, aliased)
        LO, HI = kn.twolevel_dims(slots, p8, pf)
        capacity = slots - 2
        pairs = {c: (v, ok) for c, (v, ok, _nb) in columns.items()}
        cols = [None if c is None else pairs[c] for _k, c in aggs]
        kw = {"capacity": capacity, "mask": {
            "none": None, "partial": bools(0.7, count),
            "all_false": torch.zeros(count, dtype=torch.bool, device=dev),
        }[mask_kind]}
        if key_kind == "sparse":
            kw["slot_ids"] = ints(0, capacity + 2, count)
        else:
            base = -300 if key_kind == "int32" else (1 << 40) - 300
            dtype = torch.int32 if key_kind == "int32" else torch.int64
            kw.update(base=base, key=(base + ints(0, capacity, count,
                                                  torch.int64)).to(dtype),
                      key_ok=bools(0.92, count))
        return count, layouts, cols, LO, HI, kw

    four_w = [("count_star", None), ("sum", "a")]
    four_n = [("count_star", None), ("count", "v"), ("sum", "v"),
              ("avg", "v")]
    for slots in (1026, 65538, (1 << 20) + 2):
        cols = {"a": column(2, torch.int32, False),
                "v": column(2, torch.int32, True)}
        for key_kind in ("int32", "int64", "sparse"):
            for mask_kind in ("none", "partial", "all_false"):
                yield (f"4w_aggs_slots={slots}_{key_kind}_key_{mask_kind}",
                       *case(four_w, cols, slots, key_kind, mask_kind))
        yield f"4n_aggs_slots={slots}", *case(four_n, cols, slots)
        r = (torch.randn(n, generator=g) * 1000).to(dev)
        r_ok = bools(0.8, n)
        yield f"real_lanes_slots={slots}", *case(
            [("sum", "r"), ("avg", "r"), ("count", "r"), ("sum", "q")],
            {"r": (torch.where(r_ok, r, 0.0), r_ok, 0),
             "q": (r, torch.ones(n, dtype=torch.bool, device=dev), 0)},
            slots)
        if slots > 65538:
            continue
        for nb, dtype in ((1, torch.int32), (2, torch.int32),
                          (3, torch.int32), (4, torch.int32),
                          (3, torch.int64), (8, torch.int64)):
            yield f"bytes_nb={nb}_{dtype}_slots={slots}", *case(
                [("sum", "w"), ("count", "w"), ("avg", "a")],
                {"w": column(nb, dtype, True), "a": column(nb, dtype, False)},
                slots, "int64" if dtype == torch.int64 else "int32")
    # a live key outside [base, base + capacity): the overflow flag
    count, layouts, cols, LO, HI, kw = case(four_w, {
        "a": column(2, torch.int32, False)}, 1026)
    kw["key"][kw["mask"].nonzero()[:3, 0]] = -300 + 5000
    kw["key_ok"][kw["mask"].nonzero()[:3, 0]] = True
    yield "overflow", count, layouts, cols, LO, HI, kw
    # one hot slot, every byte -128, past the per-table row cap (2^23)
    hot = (1 << 24) + 777
    low = torch.full((hot,), -(1 << 15), dtype=torch.int32, device=dev)
    for slots in (1026, 65538):
        count, layouts, cols, LO, HI, kw = case(
            four_w, {"a": (low, torch.ones(hot, dtype=torch.bool,
                                           device=dev), 2)},
            slots, "int32", "none", hot)
        kw.update(key=torch.full((hot,), 777, dtype=torch.int32, device=dev),
                  key_ok=None, base=0)
        yield f"hot_slot_slots={slots}", count, layouts, cols, LO, HI, kw


def check_fused(dev) -> float:
    worst, routes = 0.0, set()
    for name, n, layouts, cols, LO, HI, kw in fused_cases(dev):
        err = fused_err(n, layouts, cols, LO, HI, kw)
        route = fused_route(n, layouts, cols, LO, HI, kw, dev)
        routes.add(route.rstrip("2468"))
        print(f"kernel twolevel_fused {name}: route={route} "
              f"max_abs_err={err} (int8 planes exact, float planes within "
              f"{SF_TOL}·Σ|v|)", flush=True)
        worst = max(worst, err)
        del cols, kw
    assert routes == {"shared", "cluster", "global"}, routes
    gc.collect()
    return worst


# ---------------------------------------------------------------------------
# the aggregation path
# ---------------------------------------------------------------------------

def serve(label: str, n: int, runner, dag, snap, answer, agrees,
          expect: set, shards: int = 1, **extra) -> dict:
    """One cold and five warm requests of ``dag``, each ``answer(result)``
    (inside the timed window) held against the truth by ``agrees``; the
    kernels of ``expect`` must launch and no other (``sel_compact`` may
    beside ``sel_mask``: the route decides); the route of each request
    (``runner.sel_routes``), peak bytes of one more and one profile.
    ``shards``: the runner's shards (each evaluates its selection)."""
    set_counts({k: 0 for k in KERNELS})
    routes0 = dict(runner.sel_routes)
    preds0 = dict(runner.pred_routes)
    t0 = time.perf_counter()
    got = answer(runner.handle_request(dag, snap))
    cold = time.perf_counter() - t0
    assert agrees(got), f"config {label}: wrong answer on the cold request"
    warm, last = [], {}
    for _ in range(5):
        before = dict(runner.sel_routes)
        t0 = time.perf_counter()
        got = answer(runner.handle_request(dag, snap))
        warm.append(time.perf_counter() - t0)
        assert agrees(got), f"config {label}: wrong answer when warm"
        last = {k: v - before.get(k, 0) for k, v in runner.sel_routes.items()
                if v != before.get(k, 0)}
    launches = counts()
    selection = bool(expect & {"sel_pred", "sel_mask"})
    for name in KERNELS:
        if name in expect:
            assert launches[name] > 0, f"config {label} never launched {name}"
        elif name != "sel_compact" or not selection:
            assert launches[name] == 0, f"config {label} launched {name}"
    p50 = float(np.percentile(warm, 50))
    out = {"config": label, "rows": n, **extra, "cold_ms": cold * 1e3,
           "warm_p50_ms": p50 * 1e3, "rows_per_s": n / p50,
           "launches": launches}
    if selection and "topn_select" not in expect:
        out["routes"] = {k: v - routes0.get(k, 0)
                         for k, v in runner.sel_routes.items()
                         if v != routes0.get(k, 0)}
        out["last_route"] = last
    # each request's predicate route (sel_pred, or torch then sel_mask)
    out["pred_routes"] = {k: v - preds0.get(k, 0)
                          for k, v in runner.pred_routes.items()
                          if v != preds0.get(k, 0)}
    if selection:
        want = "torch" if "sel_mask" in expect else "sel_pred"
        assert out["pred_routes"] == {want: 6 * shards}, \
            f"config {label}: predicate routes {out['pred_routes']}"
    out["peak_request_bytes"] = peak_request_bytes(runner, dag, snap)
    print(f"config {label}: " + " ".join(f"{k}={v}" for k, v in out.items()
                                         if k != "config"), flush=True)
    out["profile"] = profile_request(label, runner, dag, snap,
                                     {k for k in expect
                                      if k != "sel_compact"})
    return out


def run_config(config: str, n: int, runner) -> dict:
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf

    build, make = cf.CONFIGS[config]
    table, snap = build(n)
    dag = dag_from_wire(enc_dag(make(table)))
    want, scales = cf.truth(config, snap)
    built = {}
    build_flat = runner._build_flat

    def record(host_cols, n_rows):
        built.update(host_cols=host_cols, n=n_rows)
        return build_flat(host_cols, n_rows)

    runner._build_flat = record
    try:
        out = serve(config, n, runner, dag, snap, lambda r: r.rows(),
                    lambda rows: cf.rows_agree(rows, want, scales, SF_TOL),
                    {ROUTE[config]} - {None}, groups=len(want))
    finally:
        del runner._build_flat
    if ROUTE[config] == "hash_agg":
        out["host_phases_ms"] = host_phases(runner, dag, snap)
    if config == "4":
        out["feed_build_ms"] = feed_build_cost(runner, **built)
        print(f"feed build config {config} (ms, host clock): "
              + json.dumps(out["feed_build_ms"]), flush=True)
    del snap, built
    gc.collect()
    return out


def feed_build_cost(runner, host_cols, n: int, repeats: int = 3) -> dict:
    """The cold request's feed build on the host clock (ms, the median of
    ``repeats`` rounds): the planes' uploads alone, ``_build_flat`` (the
    same uploads while a thread pool hashes the planes' digests) and the
    digests hashed one plane after another on one thread."""
    from tikv_tpu_torch.device.supervisor import host_plane_digest
    hosts = [a for v, ok in host_cols
             for a in ((v, ok) if not ok.all() else (v,))]
    n_pad = runner._pad_rows(n)
    runs = []
    for _ in range(repeats):
        ms = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planes = [runner._upload(a, n_pad) for a in hosts]
        torch.cuda.synchronize()
        ms["uploads"] = (time.perf_counter() - t0) * 1e3
        del planes
        t0 = time.perf_counter()
        feed = runner._build_flat(host_cols, n)
        torch.cuda.synchronize()
        ms["build_flat"] = (time.perf_counter() - t0) * 1e3
        del feed
        t0 = time.perf_counter()
        for a in hosts:
            host_plane_digest(a, n)
        ms["serial_digests"] = (time.perf_counter() - t0) * 1e3
        runs.append(ms)
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def host_phases(runner, dag, snap, repeats: int = 5) -> dict:
    """Host-clock phases (ms, the median of ``repeats`` warm requests) of a
    request on the hash_agg route: analyze (``_analyze``), inputs
    (``_inputs``: the feed's planes and the selection), launch
    (``hash_agg``: lane plan and kernel launch), stage (the rest of
    ``_aggregate_launch`` — the lane list and the stack of the outputs —
    and the start of the copy to pinned memory), d2h_wait (``_readback``:
    the wait for the copy, which waits for the kernel), finalize
    (``states_from_lanes`` and the result columns) and other (the rest of
    ``handle_request``: the dispatch lock, feed and meta lookups)."""
    from tikv_tpu_torch.device import hash_agg as ha
    from tikv_tpu_torch.device.deferred import HOST_STAGER
    saved = counts()
    names = ("_analyze", "_inputs", "_aggregate_launch", "_readback",
             "_simple_result", "_hash_result")
    runs = []
    for _ in range(repeats):
        spent = dict.fromkeys(names + ("stage", "hash_agg",
                                       "states_from_lanes"), 0.0)

        def timed(name, fn):
            def wrap(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[name] += time.perf_counter() - t0
            return wrap

        originals = {n: getattr(ha, n) for n in ("hash_agg",
                                                 "states_from_lanes")}
        for n in names:
            setattr(runner, n, timed(n, getattr(runner, n)))
        HOST_STAGER.stage = timed("stage", HOST_STAGER.stage)
        for n, fn in originals.items():
            setattr(ha, n, timed(n, fn))
        try:
            t0 = time.perf_counter()
            runner.handle_request(dag, snap)
            total = time.perf_counter() - t0
        finally:
            for n in names:
                delattr(runner, n)
            del HOST_STAGER.stage
            for n, fn in originals.items():
                setattr(ha, n, fn)
        ms = {k: v * 1e3 for k, v in spent.items()}
        result = ms["_simple_result"] + ms["_hash_result"]
        runs.append({
            "analyze": ms["_analyze"], "inputs": ms["_inputs"],
            "launch": ms["hash_agg"],
            "stage": ms["_aggregate_launch"] - ms["_inputs"]
            - ms["hash_agg"] + ms["stage"],
            "d2h_wait": ms["_readback"],
            "finalize": ms["states_from_lanes"] + result,
            "other": total * 1e3 - ms["_analyze"] - ms["_aggregate_launch"]
            - ms["stage"] - ms["_readback"] - ms["states_from_lanes"]
            - result,
            "total": total * 1e3})
    set_counts(saved)
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def peak_bytes(fn) -> int:
    """Peak device memory of one call of ``fn`` beyond what was resident
    before it; its launches do not count."""
    saved = counts()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    set_counts(saved)
    return torch.cuda.max_memory_allocated() - resident


def peak_request_bytes(runner, dag, snap) -> int:
    """Peak device memory of one warm request beyond the resident feed."""
    return peak_bytes(lambda: runner.handle_request(dag, snap))


# kernel → substrings of its device functions' names in a trace
SYMBOLS = {"hash_agg": ("table_kernel", "simple_kernel"),
           "twolevel": ("twolevel_kernel",),
           "sel_pred": ("sel_pred_kernel",),
           "sel_mask": ("sel_mask_kernel",),
           "sel_compact": ("sel_compact_kernel",),
           "topn_select": ("topn_hist",),
           "agg_fold": ("fold_shared", "fold_global", "fold_simple"),
           "join_probe": ("probe_kernel",), "sort_perm": ("onesweep_kernel",),
           "window_scan": ("window_kernel",),
           "shard_psum": ("psum_kernel",),
           "shard_bucket_merge": ("merge_kernel",)}


def profile_request(config: str, runner, dag, snap, expect=(),
                    call=None) -> dict:
    """One warm request (``runner.handle_request(dag, snap)``, or
    ``call()``) under torch.profiler: device time by kernel and the
    device's idle share of the (profiled) request wall.  The trace must
    hold a device function of every kernel in ``expect``: the tracer now
    and then misses them, so the request is traced again (up to three
    times with CPU and CUDA activity, then up to three times with CUDA
    activity alone); the line says whether it ever held them."""
    from torch.profiler import ProfilerActivity, profile
    saved = counts()
    attempts = [[ProfilerActivity.CPU, ProfilerActivity.CUDA]] * 3 + \
        [[ProfilerActivity.CUDA]] * 3
    for tried, activities in enumerate(attempts, 1):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            if call is None:
                runner.handle_request(dag, snap)
            else:
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        names = [e.key for e in events]
        seen = all(any(sym in k for k in names for sym in SYMBOLS[name])
                   for name in expect)
        if seen and any(not k.startswith(("Memcpy", "Memset"))
                        for k in names):
            break
    set_counts(saved)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    print(f"profile config {config}: wall_ms={wall_ms} device_ms={dev_ms} "
          f"idle_share={1 - dev_ms / wall_ms} traces={tried} "
          f"route_kernels_traced={seen} top=" + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3}ms"
              for e in top), flush=True)
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "traced": seen}


# ---------------------------------------------------------------------------
# kernels at the main path's shapes
# ---------------------------------------------------------------------------

def main_path_inputs(config: str, n: int, dev) -> dict:
    """hash_agg's arguments exactly as the runner builds them for one
    config: the int32 feed planes, the slot layout, one lane per SUM/AVG
    (config 3's SUM(v) and AVG(v) are two lanes over one plane) and the
    value width of ``_arg_nbytes`` (v's range)."""
    from tikv_tpu_torch.device import hash_agg as ha
    from tikv_tpu_torch.device import kernels as kn
    from tikv_tpu_torch.testing import configs as cf
    _table, snap = cf.CONFIGS[config][0](n)
    vn = snap.columns[3].values
    v = torch.from_numpy(vn.astype(np.int32)).to(dev)
    kw = dict(n=n, device=dev, value_bytes=kn.int_planes_needed(
        int(vn.min()), int(vn.max())))
    if config == "3":
        kw.update(mode="simple", slots=1, n_slots=1,
                  lanes=[ha.Lane(values=v), ha.Lane(values=v)])
    elif config == "4":
        k = torch.from_numpy(snap.columns[2].values.astype(np.int32))
        kw.update(mode="dense", slots=1026, n_slots=1024, key=k.to(dev),
                  base=0, capacity=1024, lanes=[ha.Lane(values=v)])
    else:
        _uniq, inv = np.unique(snap.columns[2].values, return_inverse=True)
        kw.update(mode="sparse", slots=1026, n_slots=1025, capacity=1024,
                  key=torch.from_numpy(inv.astype(np.int32)).to(dev),
                  lanes=[ha.Lane(values=v)])
    return kw


def kernel_at_main_shapes(dev) -> tuple:
    """hash_agg against its plain version (exact) and timed, at each of
    configs 3, 4 and 4s's main-path shapes; → (largest difference,
    config → timing)."""
    from tikv_tpu_torch.device import hash_agg as ha
    worst, timings = 0, {}
    for config in ("3", "4", "4s"):
        n = SIZES[config]
        kw = main_path_inputs(config, n, dev)
        saved = counts()
        err = max_abs_diff(ha.hash_agg(**kw),
                           ha.hash_agg_plain(**plain_args(kw)))
        assert err == 0, f"hash_agg disagrees with its plain version " \
            f"at config {config}'s shape"
        worst = max(worst, err)
        plan = ha.plan_lanes(kw["lanes"])
        ms = cuda_ms(lambda: ha.hash_agg(**kw), 20, queued=True)
        fmt = "registers" if kw["mode"] == "simple" else ha.plan_launches(
            kw["mode"], kw["n_slots"], plan.lanes,
            ha._smem_limit(ha._kernel_lib(), dev.index or 0),
            kw["value_bytes"])[0].fmt
        other = {}
        if config != "3":               # packed cells on the same inputs
            chosen = ha.cell_format
            ha.cell_format = lambda *_a: ha.FMT_PACKED
            try:
                assert max_abs_diff(ha.hash_agg(**kw), ha.hash_agg_plain(
                    **plain_args(kw))) == 0
                other["packed_ms"] = cuda_ms(lambda: ha.hash_agg(**kw), 20,
                                             queued=True)
            finally:
                ha.cell_format = chosen
        set_counts(saved)               # measurement launches do not count
        plain_ms = cuda_ms(lambda: ha.hash_agg_plain(**plain_args(kw)), 3)
        # inputs read once (config 3's two lanes share one plane), states
        # written once; ops: slot, count add, one add per lane
        planes = 1 if config == "3" else 2
        lanes = len(kw["lanes"])
        out = {"ms": ms, "plain_ms": plain_ms,
               **bound_ms(4 * n * planes + 8 * kw["slots"] * (1 + lanes),
                          n * (2 + lanes)),
               "distinct_lanes": len(plan.lanes),
               "value_bytes": kw["value_bytes"], "cell_format": fmt,
               **other}
        # yardstick only (the port never calls it): one library call over
        # the same values: an int64 sum (config 3; its COUNT is n), or a
        # scatter-add into the 1026 int64 slots by key or slot id
        v = kw["lanes"][0].values
        if config == "3":
            out["library_ms"] = cuda_ms(
                lambda: torch.sum(v, dtype=torch.int64), 20)
        else:
            slots64, v64 = kw["key"].to(torch.int64), v.to(torch.int64)
            out["library_ms"] = cuda_ms(lambda: torch.zeros(
                1026, dtype=torch.int64, device=dev).index_add_(
                    0, slots64, v64), 10)
            del slots64, v64
        out["rows"] = n
        timings[config] = out
        print(f"kernel hash_agg at config {config} shape ({n} rows): "
              f"max_abs_err={err} tolerance=0 (integer states) " +
              " ".join(f"{k}={v}" for k, v in out.items()), flush=True)
        del kw, v
        gc.collect()
    return worst, timings


def captured_calls(owner, name: str, call) -> list:
    """(args, kwargs) of every call of ``owner.name`` during ``call()``
    (its launches not counted)."""
    seen = []
    real = getattr(owner, name)

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    saved = counts()
    setattr(owner, name, record)
    try:
        call()
    finally:
        setattr(owner, name, real)
        set_counts(saved)
    return seen


def captured_inputs(config: str, runner, name: str) -> tuple:
    """(args, kwargs) of the runner's call of ``name`` (``twolevel_fused``
    or ``agg_fold``, as ``device/runner.py`` imports them) on one request
    of ``config`` (recorded around the call; not counted)."""
    import tikv_tpu_torch.device.runner as rmod
    from tikv_tpu_torch.testing import configs as cf
    build, make = cf.CONFIGS[config]
    table, snap = build(SIZES[config])
    return captured_calls(rmod, name,
                          lambda: runner.handle_request(make(table), snap))[0]


def fused_bytes(n, layouts, cols, LO, HI, kw) -> int:
    """Bytes the fused entry must move: each distinct raw column read once
    (rows [0, n)), the int64 / float64 states written once."""
    from tikv_tpu_torch.device import twolevel as tl
    lanes, _src8, _srcf = tl.plan_lanes(layouts, cols)
    inputs = [kw.get("key"), kw.get("key_ok"), kw.get("slot_ids"),
              kw.get("mask")] + [t for ln in lanes for t in (ln.values,
                                                              ln.ok)]
    seen, total = set(), 0
    for t in inputs:
        if t is not None and t.stride(0) != 0 and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += n * t.element_size()
    p8, pf = tl.plane_counts(layouts)
    return total + 8 * HI * LO * (p8 + pf)


def planes_path(n, layouts, cols, LO, HI, kw, dev):
    """The planes path on the same inputs: slot ids and planes built by
    torch ops (``slot_index``, ``make_planes``), then the planes kernel —
    the runner's path before the fused entry."""
    from tikv_tpu_torch.device import kernels as kn
    from tikv_tpu_torch.device import twolevel as tl
    mask = kw["mask"] if kw["mask"] is not None else \
        torch.ones(n, dtype=torch.bool, device=dev)
    if kw.get("slot_ids") is not None:
        idx = torch.where(mask, kw["slot_ids"][:n],
                          torch.full((), kw["capacity"] + 1,
                                     dtype=torch.int32, device=dev))
    else:
        km = kw["key_ok"] if kw["key_ok"] is not None else \
            torch.ones((), dtype=torch.bool, device=dev)
        idx, _ovf = kn.slot_index((kw["key"], km), kw["capacity"],
                                  kw["base"], mask)
    L8, Lf = kn.make_planes(layouts, cols, mask)
    return idx.contiguous(), L8, Lf, tl.twolevel(idx.contiguous(), L8, Lf,
                                                 LO, HI)


def time_fused(config: str, args, kwargs, dev) -> dict:
    """The fused entry against its plain version and timed at one config's
    shape, beside the planes path it replaced, its bound and a library
    yardstick."""
    from tikv_tpu_torch.device import twolevel as tl
    n, layouts, cols, LO, HI, capacity = args
    kw = dict(kwargs, capacity=capacity)
    saved = counts()
    err = fused_err(n, layouts, cols, LO, HI, kw)
    route = fused_route(n, layouts, cols, LO, HI, kw, dev)
    ms = cuda_ms(lambda: tl.twolevel_fused(n, layouts, cols, LO, HI, **kw),
                 10, queued=True)
    planes_ms = cuda_ms(
        lambda: planes_path(n, layouts, cols, LO, HI, kw, dev), 5,
        queued=True)
    set_counts(saved)
    peaks = {"fused_peak_bytes": peak_bytes(
        lambda: tl.twolevel_fused(n, layouts, cols, LO, HI, **kw)),
             "planes_peak_bytes": peak_bytes(
        lambda: planes_path(n, layouts, cols, LO, HI, kw, dev))}
    plain_ms = cuda_ms(lambda: tl.twolevel_fused_plain(
        n, layouts, cols, LO, HI, **kw), 2)
    p8, pf = tl.plane_counts(layouts)
    lanes, src8, srcf = tl.plan_lanes(layouts, cols)
    d8, df = max(src8) + 1, max(srcf, default=-1) + 1
    # bytes: the raw columns read once and the states written once; ops:
    # one add per distinct plane and row
    out = {"ms": ms, "plain_ms": plain_ms, "planes_ms": planes_ms,
           **bound_ms(fused_bytes(n, layouts, cols, LO, HI, kw),
                      n * (d8 + df))}
    # yardstick only (the port never calls it): one index_add_ of the
    # stacked int64 planes into (p8, slots) along dim 1, the planes built
    # beforehand
    idx, L8, _Lf, _S = planes_path(n, layouts, cols, LO, HI, kw, dev)
    set_counts(saved)
    idx64, L64 = idx.to(torch.int64), L8.to(torch.int64)
    del L8, _Lf, _S
    out["library_ms"] = cuda_ms(lambda: torch.zeros(
        p8, HI * LO, dtype=torch.int64, device=dev).index_add_(
            1, idx64, L64), 5)
    del idx, idx64, L64
    route_sweep(config, args, kw, dev)
    out["max_abs_err"] = err
    out["table_route"] = route
    print(f"kernel twolevel_fused at config {config} shape ({n} rows, "
          f"p8={p8} pf={pf} distinct={d8}+{df} LO={LO} HI={HI}): " +
          " ".join(f"{k}={v}" for k, v in {**out, **peaks}.items()),
          flush=True)
    return out


def route_sweep(config: str, args, kw, dev) -> dict:
    """The fused kernel at one config's shape on every route its table can
    take (the launcher's choice replaced; a route the card refuses is
    skipped), each held against the plain version: route → ms."""
    from tikv_tpu_torch.device import twolevel as tl
    n, layouts, cols, LO, HI, _capacity = args
    chosen, out = tl.route, {}
    want = tl.twolevel_fused_plain(n, layouts, cols, LO, HI, **kw)[0]
    saved = counts()
    try:
        for name, cs in (("shared", 1), ("cluster", 2), ("cluster", 4),
                         ("cluster", 8), ("global", 0)):
            tl.route = lambda *_a, _r=(name, cs), **_k: _r
            try:
                got = tl.twolevel_fused(n, layouts, cols, LO, HI, **kw)[0]
                torch.cuda.synchronize()
            except RuntimeError:        # refused: the table does not fit
                continue
            assert torch.equal(got, want), f"{config} {name}{cs} disagrees"
            out[f"{name}{cs if name == 'cluster' else ''}"] = cuda_ms(
                lambda: tl.twolevel_fused(n, layouts, cols, LO, HI, **kw),
                10, queued=True)
    finally:
        tl.route = chosen
        set_counts(saved)
    print(f"kernel twolevel_fused at config {config} shape, every route "
          f"(ms): " + " ".join(f"{k}={v}" for k, v in out.items()),
          flush=True)
    return out


def time_twolevel(label: str, idx, L8, Lf, LO, HI, dev) -> dict:
    """The planes entry against its plain version and timed at one
    shape."""
    from tikv_tpu_torch.device import twolevel as tl
    saved = counts()
    err = twolevel_err(idx, L8, Lf, LO, HI)
    ms = cuda_ms(lambda: tl.twolevel(idx, L8, Lf, LO, HI), 10, queued=True)
    set_counts(saved)
    plain_ms = cuda_ms(lambda: tl.twolevel_plain(idx, L8, Lf, LO, HI), 2)
    n, p8 = idx.shape[0], L8.shape[0]
    pf = 0 if Lf is None else Lf.shape[0]
    # bytes: slot id, p8 int8 and pf float32 values per row read once, the
    # int64/float64 states written once; ops: one add per plane and row
    out = {"ms": ms, "plain_ms": plain_ms,
           **bound_ms(n * (4 + p8 + 4 * pf) + 8 * HI * LO * (p8 + pf),
                      n * (p8 + pf))}
    # yardstick only (the port never calls it): one index_add_ of the
    # stacked int64 planes into (p8, slots) along dim 1
    idx64, L64 = idx.to(torch.int64), L8.to(torch.int64)
    out["library_ms"] = cuda_ms(lambda: torch.zeros(
        p8, HI * LO, dtype=torch.int64, device=dev).index_add_(
            1, idx64, L64), 5)
    del idx64, L64
    out["max_abs_err"] = err
    name, cs = tl.route(p8, pf, LO, HI, "planes", dev)
    print(f"kernel twolevel at {label} ({n} rows, p8={p8} pf={pf} LO={LO} "
          f"HI={HI}, route={name}{cs if cs > 1 else ''}): " +
          " ".join(f"{k}={v}" for k, v in out.items()), flush=True)
    return out


def twolevel_at_main_shapes(runner, dev) -> tuple:
    """→ (largest difference, config 4n timing with the route per
    config)."""
    worst, timing, routes = 0.0, None, {}
    for config in ("4n", "4w", "4r"):
        args, kwargs = captured_inputs(config, runner, "twolevel_fused")
        out = time_fused(config, args, kwargs, dev)
        worst = max(worst, out.pop("max_abs_err"))
        routes[config] = out.pop("table_route")
        if config == "4n":
            timing = out
        del args, kwargs
        gc.collect()
    for name in PROTOTYPES:
        idx, L8, LO, HI, _k, _v = prototype_inputs(name, dev)
        out = time_twolevel(f"{name} shape", idx, L8, None, LO, HI, dev)
        worst = max(worst, out["max_abs_err"])
        del idx, L8
        gc.collect()
    timing["table_routes"] = routes
    return worst, timing


def fold_bytes(kw: dict) -> int:
    """Bytes the fold must move: the key (or slot ids), the selection and
    each distinct lane's values and validity read once over rows [0, n),
    the state buffer written once."""
    from tikv_tpu_torch.device import agg_fold as af
    plan = af.plan_fold(kw["specs"], kw["cols"], kw["mode"])
    n = kw["n"]
    planes = [kw.get("key"), kw.get("key_ok"), kw.get("slot_ids"),
              kw.get("mask")] + [t for ln in plan.lanes
                                 for t in (ln.values, ln.ok)]
    slots = 1 if kw["mode"] == "simple" else kw["capacity"] + 2
    return sum(n * t.element_size() for t in planes if t is not None) + \
        8 * (1 + len(plan.rows) * slots)


def fold_at_main_shapes(runner, dev) -> tuple:
    """agg_fold at configs 4m and 3n on the runner's own arguments, against
    its plain version and timed beside its bound, its plain version and a
    yardstick; → (largest difference, config 4m's timing with 3n's under
    ``configs``)."""
    from tikv_tpu_torch.device import agg_fold as af
    worst, timings = 0.0, {}
    for config in ("4m", "3n"):
        (specs, cols, n, mode), kw = captured_inputs(config, runner,
                                                     "agg_fold")
        kw = dict(specs=specs, cols=cols, n=n, mode=mode,
                  **{k: v for k, v in kw.items() if k != "device"})
        saved = counts()
        err = fold_err(kw, dev)
        slots = 1 if kw["mode"] == "simple" else kw["capacity"] + 2
        route = af.route(kw["specs"], kw["cols"], kw["mode"], slots, dev,
                         kw.get("value_bound"))
        ms = cuda_ms(lambda: af.agg_fold(**kw, device=dev), 20, queued=True)
        peak = peak_bytes(lambda: af.agg_fold(**kw, device=dev))
        set_counts(saved)
        plain_ms = cuda_ms(lambda: af.agg_fold_plain(**kw, device=dev), 3)
        plan = af.plan_fold(kw["specs"], kw["cols"], kw["mode"])
        n = kw["n"]
        # ops: a slot and one update per state row and row
        out = {"ms": ms, "plain_ms": plain_ms,
               **bound_ms(fold_bytes(kw), n * len(plan.rows)),
               "rows": n, "slots": slots, "state_rows": len(plan.rows),
               "lanes": len(plan.lanes), "fold_route": route,
               "peak_bytes": peak}
        # yardstick only (the port never calls it, and no one PyTorch call
        # computes the fold): one scatter_reduce_ (amax) of the same values
        # over the same keys (slot 0 for 3n's single group)
        v = plan.lanes[0].values[:n]
        index = torch.zeros(n, dtype=torch.int64, device=dev) \
            if kw["mode"] == "simple" else \
            (kw["key"][:n].to(torch.int64) - kw.get("base", 0))
        out["library_ms"] = cuda_ms(lambda: torch.full(
            (slots,), -(1 << 31), dtype=v.dtype, device=dev).scatter_reduce_(
                0, index, v, reduce="amax"), 10)
        out["library_call"] = "scatter_reduce_ amax (yardstick)"
        out["max_abs_err"] = err
        worst = max(worst, err)
        timings[config] = out
        print(f"kernel agg_fold at config {config} shape ({n} rows): " +
              " ".join(f"{k}={x}" for k, x in out.items()), flush=True)
        del kw, v, index
        gc.collect()
    timing = {k: x for k, x in timings["4m"].items()
              if k not in ("max_abs_err",)}
    timing["configs"] = timings
    return worst, timing


# ---------------------------------------------------------------------------
# selection and top-k kernels against their plain versions
# ---------------------------------------------------------------------------

def mask_equal(got, want) -> bool:
    """sel_mask outputs: the count, the packed region and the per-block
    counts (the header's pad bytes are not outputs)."""
    return bool(got.count == want.count) and \
        torch.equal(got.packed, want.packed) and \
        torch.equal(got.block_counts, want.block_counts)


def selection_cases(dev):
    """(name, pred, n, [(k_cap, planes), ...]) on the card: the CPU
    tests' edge cases and config 2's size."""
    g = torch.Generator(device="cpu").manual_seed(14)

    def bools(p, count):
        return (torch.rand(count, generator=g) < p).to(dev)

    def plane(dtype, count):
        if dtype == torch.bool:
            return bools(0.5, count)
        if dtype == torch.float64:
            return torch.randn(count, generator=g, dtype=dtype).to(dev)
        return torch.randint(-(1 << 30), 1 << 30, (count,), generator=g,
                             dtype=torch.int64).to(dtype).to(dev)

    for n in (1, 7, 8, 9, 4095, 32767, 32768, 32769, (1 << 20) + 3):
        pred = bools(0.3, n)
        planes = [plane(d, n) for d in (torch.int32, torch.int64,
                                         torch.float64, torch.bool)]
        yield f"n={n}", pred, n, [(64, ()), (1 << 21, ()), (64, planes),
                                  (1 << 21, planes)]
    n = 100_003
    yield "all_false", torch.zeros(n, dtype=torch.bool, device=dev), n, \
        [(64, ()), (64, [plane(torch.int32, n)])]
    yield "all_true", torch.ones(n, dtype=torch.bool, device=dev), n, \
        [(64, ()), (1 << 17, ()), (1 << 17, [plane(torch.int64, n)])]
    base = bools(0.5, n + 16)
    yield "pred_off_16_bytes", base[3:], n, [(1 << 16, ())]
    big = SWEEP_ROWS
    pred = bools(0.1, big)
    yield f"config_2_size_{big}", pred, big, [
        (1 << 17, ()), (1 << 21, ()), (1 << 14, [plane(torch.int32, big)])]


PRED_CMPS = ("Gt", "Ge", "Lt", "Le", "Eq", "Ne", "NullEq")


def pred_spec(rng, depth: int, kind: str = "bool"):
    """A random predicate over columns a (int32), b (int64), r (float32),
    nested up to ``depth``, as a nested tuple (see ``pred_tree``)."""
    if kind == "int" or kind == "real":
        real = kind == "real"
        if depth <= 0 or rng.random() < 0.4:
            roll = rng.random()
            if roll < 0.55:
                return ("col", 2 if real else int(rng.integers(0, 2)))
            if roll < 0.95:
                return ("const", float(rng.integers(-400, 400)) / 4.0
                        if real else int(rng.integers(-120, 120)))
            return ("null", kind)
        t = "Real" if real else "Int"
        if rng.random() < 0.8:
            return (str(rng.choice(["Plus", "Minus", "Multiply"])) + t,
                    pred_spec(rng, depth - 1, kind),
                    pred_spec(rng, depth - 1, kind))
        return ("UnaryMinus" + t, pred_spec(rng, depth - 1, kind))
    sub = "real" if rng.random() < 0.35 else "int"
    t = "Real" if sub == "real" else "Int"
    roll = rng.random()
    if depth <= 1 or roll < 0.45:
        return (str(rng.choice(PRED_CMPS)) + t,
                pred_spec(rng, depth - 1, sub),
                pred_spec(rng, max(depth - 2, 0), sub))
    if roll < 0.7:
        return (str(rng.choice(["LogicalAnd", "LogicalOr", "LogicalXor"])),
                pred_spec(rng, depth - 1), pred_spec(rng, depth - 1))
    if roll < 0.85:
        return (str(rng.choice(["UnaryNot", "IsNull"])) + t,
                pred_spec(rng, depth - 1, sub))
    if roll < 0.93:
        return (t + str(rng.choice(["IsTrue", "IsFalse"])),
                pred_spec(rng, depth - 1, sub))
    items = [("const", float(rng.integers(-400, 400)) / 4.0 if sub == "real"
              else int(rng.integers(-100, 100)))
             for _ in range(int(rng.integers(1, 6)))]
    if rng.random() < 0.2:
        items.append(("null", sub))
    return ("In" + t, pred_spec(rng, 1, sub), *items)


def pred_tree(spec):
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.expr import Expr
    kind = spec[0]
    if kind == "col":
        return Expr.column(spec[1], EvalType.REAL if spec[1] == 2
                           else EvalType.INT)
    if kind == "const":
        return Expr.const(spec[1], EvalType.REAL if isinstance(
            spec[1], float) else EvalType.INT)
    if kind == "null":
        return Expr.null(EvalType.REAL if spec[1] == "real" else EvalType.INT)
    return Expr.call(kind, *[pred_tree(c) for c in spec[1:]])


def pred_cases(dev):
    """(name, program, planes, n, bools) on the card: random predicates
    nested two or three deep (every covered signature among them) over
    NULL-bearing int32 (with its extremes), int64 and float32 planes, at
    ragged sizes, on and off a 16-byte boundary, and the predicates of
    configs 1, 2, 2s and 5t at config 2's 10·2^20 rows."""
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.expr import Expr, build_rpn
    from tikv_tpu_torch.expr.eval import narrow_int32
    rng = np.random.default_rng(21)
    for n in (1, 17, 4095, 32769, (1 << 20) + 3):
        a = rng.integers(-100, 100, n + 4).astype(np.int32)
        a[rng.choice(n + 4, min(n + 4, 8), replace=False)] = rng.choice(
            [-(1 << 31), 1 - (1 << 31), (1 << 31) - 1], min(n + 4, 8))
        b = rng.integers(-(1 << 33), 1 << 33, n + 4)
        b[: (n + 4) // 3] = rng.integers(-100, 100, (n + 4) // 3)
        r = (rng.integers(-400, 400, n + 4) / 4.0).astype(np.float32)
        cols = []
        for v in (a, b, r):
            ok = rng.random(n + 4) > 0.15
            cols.append((torch.from_numpy(np.where(ok, v, 0).astype(
                v.dtype)).to(dev), torch.from_numpy(ok).to(dev)))
        bounds = [(int(a.min()), int(a.max())), (int(b.min()), int(b.max())),
                  None]
        for off in (0, 1):
            planes = [(v[off:], ok[off:]) for v, ok in cols]
            dts = [v.dtype for v, _ok in planes]
            made = 0
            while made < 8:
                specs = [pred_spec(rng, int(rng.integers(2, 4)))
                         for _ in range(int(rng.integers(1, 3)))]
                rpns = [build_rpn(pred_tree(sp)) for sp in specs]
                if sm.pred_covered(rpns):
                    continue
                if made % 2:
                    rpns = [narrow_int32(rp, bounds) for rp in rpns]
                made += 1
                yield (f"random_n={n}_off={off}_{made}",
                       sm.encode_predicate(rpns, dts), planes, n,
                       bool(made % 3))
    n = SWEEP_ROWS
    v = torch.randint(-1000, 1000, (n,), generator=torch.Generator()
                      .manual_seed(3), dtype=torch.int32).to(dev)
    for name, e, bools in (
            ("config_1", Expr.column(0) > Expr.const(-10 ** 9, EvalType.INT),
             False),
            ("config_2", Expr.column(0) > Expr.const(800, EvalType.INT),
             False),
            ("config_2s_0.1%", Expr.column(0) > Expr.const(997,
                                                           EvalType.INT),
             False),
            ("config_5t", Expr.column(0) < Expr.const(512, EvalType.INT),
             True)):
        yield name, sm.encode_predicate([build_rpn(e)], [torch.int32]), \
            [(v, None)], n, bools


def check_pred(dev) -> int:
    """sel_pred against its plain version (the same program run op by op in
    torch on the card): count, packed mask, block counts and bool mask
    equal bit for bit.  → 0 or raises."""
    from tikv_tpu_torch.device import selection as sm
    cases = 0
    for name, prog, planes, n, bools in pred_cases(dev):
        got, got_b = sm.sel_pred(prog, planes, n, bools)
        torch.cuda.synchronize()
        want, want_b = sm.sel_pred_plain(prog, planes, n, bools)
        assert mask_equal(got, want), f"sel_pred {name} disagrees"
        assert (got_b is None) == (not bools)
        if bools:
            assert torch.equal(got_b, want_b), f"sel_pred {name} bools"
        cases += 1
        if name.startswith("config") or cases % 16 == 0:
            print(f"kernel sel_pred {name}: ops={len(prog.ops)} "
                  f"depth={prog.depth} count={int(got.count)} "
                  f"bools={bools} max_abs_err=0", flush=True)
    print(f"kernel sel_pred: {cases} cases equal to the plain version",
          flush=True)
    gc.collect()
    return 0


def relane(spec, rng, wide: bool = False):
    """``spec`` with every constant redrawn (one lane of a stacked group:
    the same program, other constants of the same device dtype)."""
    if spec[0] == "const":
        v = spec[1]
        if isinstance(v, float):
            return ("const", float(rng.integers(-400, 400)) / 4.0)
        if wide:
            return ("const", int(rng.integers(-(1 << 40), 1 << 40)))
        if abs(v) >= 1 << 30:
            return ("const", int(rng.choice([-(1 << 31), 1 - (1 << 31), -1,
                                             0, (1 << 31) - 2,
                                             (1 << 31) - 1])))
        return ("const", int(rng.integers(-120, 120)))
    if spec[0] in ("col", "null"):
        return spec
    return (spec[0], *[relane(c, rng, wide) for c in spec[1:]])


def lane_programs(specs, G: int, rng, dts, wide: bool = False) -> list:
    """G programs of ``specs``: lanes 0 and 1 equal, the rest redrawn."""
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.expr import build_rpn
    out = []
    for g in range(G):
        lane = specs if g < 2 else [relane(sp, rng, wide) for sp in specs]
        out.append(sm.encode_predicate(
            [build_rpn(pred_tree(sp)) for sp in lane], dts))
    return out


def batched_cases(dev):
    """(name, programs, planes, n) on the card: G of 1, 2, 3, 16, 17 and
    the lane limit over NULL-bearing int32 (with its extremes), int64 and
    float32 planes; random programs, an int32-extremes comparison, a wide
    (int64 constants) range, terms over the int64 plane and REAL
    comparisons (Gt, Ne); equal and different lanes; n not a multiple of 8
    or of the terms kernel's 32-row word, planes off a 16-byte boundary,
    one block and many."""
    from tikv_tpu_torch.device import selection as sm
    rng = np.random.default_rng(41)
    fixed = {"extremes": [("GeInt", ("col", 0), ("const", (1 << 31) - 1))],
             "wide": [("LogicalAnd",
                       ("GeInt", ("col", 1), ("const", -(1 << 40))),
                       ("LtInt", ("col", 1), ("const", 1 << 39)))],
             "real": [("GtReal", ("col", 2), ("const", 12.25))],
             "range": [("GeInt", ("col", 0), ("const", -50)),
                       ("LtInt", ("col", 0), ("const", 50))],
             "null_const": [("NeInt", ("col", 0), ("null", "int"))],
             "wide_terms": [("GeInt", ("col", 1), ("const", -(1 << 40))),
                            ("LeInt", ("col", 1), ("const", 1 << 39))],
             "real_ne": [("NeReal", ("col", 2), ("const", 12.25))]}
    for n in (1, 13, 33, 4099, 32768, 32769, (1 << 20) + 3, SWEEP_ROWS):
        a = rng.integers(-100, 100, n + 4).astype(np.int32)
        a[rng.choice(n + 4, min(n + 4, 8), replace=False)] = rng.choice(
            [-(1 << 31), 1 - (1 << 31), (1 << 31) - 1], min(n + 4, 8))
        b = rng.integers(-(1 << 41), 1 << 41, n + 4)
        r = (rng.integers(-400, 400, n + 4) / 4.0).astype(np.float32)
        cols = []
        for v in (a, b, r):
            ok = rng.random(n + 4) > 0.15
            cols.append((torch.from_numpy(np.where(ok, v, 0).astype(
                v.dtype)).to(dev), torch.from_numpy(ok).to(dev)))
        big = n >= 1 << 20
        for off in ((0,) if big else (0, 1)):
            planes = [(v[off:], ok[off:]) for v, ok in cols]
            if off == 0 and n == 4099:
                planes[0] = (planes[0][0], None)     # a plane without NULLs
            dts = [v.dtype for v, _ok in planes]
            for G in ((1, 16, 17, sm.BATCH_MAX_LANES) if big else
                      (1, 2, 3, 16, 17, sm.BATCH_MAX_LANES)):
                for kind, specs in fixed.items():
                    yield (f"{kind}_n={n}_off={off}_G={G}",
                           lane_programs(specs, G, rng, dts,
                                         wide=kind.startswith("wide")),
                           planes, n)
                made = 0
                while made < (1 if big else 3):
                    specs = [pred_spec(rng, int(rng.integers(2, 4)))
                             for _ in range(int(rng.integers(1, 3)))]
                    try:
                        progs = lane_programs(specs, G, rng, dts)
                        sm.check_lanes(progs)
                    except (sm.Uncovered, sm.LanesDiffer):
                        continue     # past the limits, or a width changed
                    made += 1
                    yield f"random_n={n}_off={off}_G={G}_{made}", progs, \
                        planes, n


def route_of(prog, planes) -> str:
    """sel_pred_batched's route for a group of ``prog``."""
    from tikv_tpu_torch.device import selection as sm
    return "terms" if sm.terms_route(prog, planes) else "interpreter"


def check_batched(dev) -> int:
    """sel_pred_batched against its plain version (the whole output
    buffer, bit for bit) and against G solo sel_pred launches (each lane's
    count and packed mask).  → 0 or raises."""
    from tikv_tpu_torch.device import selection as sm
    cases = 0
    simple = 0
    for name, progs, planes, n in batched_cases(dev):
        simple += sm.terms_route(progs[0], planes)
        got = sm.sel_pred_batched(progs, planes, n)
        torch.cuda.synchronize()
        want = sm.sel_pred_batched_plain(progs, planes, n)
        assert torch.equal(got.buf, want.buf), \
            f"sel_pred_batched {name} disagrees with its plain version"
        for g, q in enumerate(progs):
            solo = sm.sel_pred(q, planes, n)[0]
            assert bool(got.counts[g] == solo.count) and torch.equal(
                got.packed(g), solo.packed), \
                f"sel_pred_batched {name} lane {g} disagrees with sel_pred"
        cases += 1
        if cases % 12 == 0 or n >= 1 << 20:
            print(f"kernel sel_pred_batched {name}: ops={len(progs[0].ops)} "
                  f"wide={progs[0].wide} "
                  f"route={route_of(progs[0], planes)} counts="
                  f"{got.counts[:4].tolist()} max_abs_err=0", flush=True)
    print(f"kernel sel_pred_batched: {cases} cases ({simple} on the terms "
          f"route, {cases - simple} on the interpreter) equal to the plain "
          f"version and to solo sel_pred", flush=True)
    assert 0 < simple < cases, "both evaluations must be taken"
    gc.collect()
    return 0


def batched_at_main_shape(dev) -> dict:
    """sel_pred_batched at cell 6b-ep's shape (10·2^20 int32 rows of c1,
    G = 16 thresholds of its palette), exact against its plain version and
    timed beside its bound (the plane read once, G packed masks and G
    counts written once), its plain version, the 16 solo sel_pred launches
    it replaces, and one broadcast torch.gt of the plane against the (G, 1)
    thresholds (a yardstick the port never calls); and the same masks from
    programs that take its interpreter (``NOT (c1 <= thr)``)."""
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.expr import Expr, build_rpn
    n, G = SWEEP_ROWS, 16
    h = np.arange(n, dtype=np.int64) * 2654435761 % (1 << 32)
    c1 = torch.from_numpy((h % 1000).astype(np.int32)).to(dev)
    thrs = [980 + (g % 16) for g in range(G)]
    progs = [sm.encode_predicate(
        [build_rpn(Expr.column(0) > Expr.const(t, EvalType.INT))],
        [torch.int32]) for t in thrs]
    # the same masks through the interpreter: NOT (c1 <= thr) is no
    # simple term
    interp = [sm.encode_predicate([build_rpn(Expr.call(
        "UnaryNotInt", Expr.column(0) <= Expr.const(t, EvalType.INT)))],
        [torch.int32]) for t in thrs]
    planes = [(c1, None)]
    assert route_of(progs[0], planes) == "terms" and \
        route_of(interp[0], planes) == "interpreter"
    saved = counts()
    got = sm.sel_pred_batched(progs, planes, n)
    assert torch.equal(got.buf, sm.sel_pred_batched_plain(
        progs, planes, n).buf), "sel_pred_batched disagrees at 6b-ep"
    assert torch.equal(got.buf, sm.sel_pred_batched(interp, planes, n).buf)
    thr_t = torch.tensor(thrs, dtype=torch.int32, device=dev)[:, None]
    t = {"ms": cuda_ms(lambda: sm.sel_pred_batched(progs, planes, n), 50,
                       queued=True),
         "interpreter_ms": cuda_ms(lambda: sm.sel_pred_batched(
             interp, planes, n), 50, queued=True),
         "plain_ms": cuda_ms(lambda: sm.sel_pred_batched_plain(
             progs, planes, n), 3),
         "solo_ms": cuda_ms(lambda: [sm.sel_pred(q, planes, n)
                                     for q in progs], 20, queued=True),
         "library_ms": cuda_ms(lambda: torch.gt(c1, thr_t), 50),
         "library_call": "torch.gt of the plane against the (G, 1) "
                         "thresholds (yardstick)",
         **bound_ms(4 * n + G * -(-n // 8) + 8 * G, G * n),
         "rows": n, "lanes": G, "lane_route": route_of(progs[0], planes),
         "selected": got.counts.tolist(),
         "peak_bytes": peak_bytes(lambda: sm.sel_pred_batched(
             progs, planes, n))}
    set_counts(saved)
    print(f"kernel sel_pred_batched at 6b-ep shape ({n} rows, G={G}): "
          f"max_abs_err=0 " + " ".join(f"{k}={x}" for k, x in t.items()),
          flush=True)
    return t


def compact_cases(dev):
    """(name, pred, n, [(k_cap or a function of the total, planes), ...])
    beyond ``selection_cases``: the capacity one below, at and one above
    the total, with planes of 1, 4 and 8 bytes, at n not a multiple of
    32,768; and 100·2^20 rows at 1% (3,200 blocks) in index mode and
    with an int32 plane."""
    g = torch.Generator(device=dev).manual_seed(19)
    n = 5 * 32768 + 4099
    planes = [torch.rand(n, generator=g, device=dev) < 0.5,
              torch.randint(-(1 << 30), 1 << 30, (n,), generator=g,
                            device=dev, dtype=torch.int32),
              torch.randint(-(1 << 62), 1 << 62, (n,), generator=g,
                            device=dev, dtype=torch.int64)]
    caps = [(lambda c, d=d: max(1, c + d), ps) for d in (-1, 0, 1)
            for ps in ((), planes)]
    yield f"n={n} at the total", torch.rand(n, generator=g, device=dev) \
        < 0.2, n, caps
    big = 100 << 20
    pred = torch.rand(big, generator=g, device=dev) < 0.01
    plane = torch.randint(-(1 << 30), 1 << 30, (big,), generator=g,
                          device=dev, dtype=torch.int32)
    yield f"{big} rows at 1%", pred, big, [
        (lambda c: 1 << (int(c * 1.5 + 64) - 1).bit_length(), ()),
        (lambda c: c - 7, ()), (lambda c: c + 3, [plane])]


def check_selection(dev) -> tuple:
    """→ (largest difference of sel_mask, of sel_compact): 0 or raises.
    Every ``sel_compact`` runs under ``no_host_wait`` and its whole buffer
    (header, indices, -1 fill, planes, their 0 tails and the gaps between
    them) must equal the plain version's."""
    from tikv_tpu_torch.device import selection as sm
    check_sync_debug(dev)
    for name, pred, n, compacts in itertools.chain(selection_cases(dev),
                                                   compact_cases(dev)):
        got = sm.sel_mask(pred, n)
        torch.cuda.synchronize()
        want = sm.sel_mask_plain(pred, n)
        assert mask_equal(got, want), f"sel_mask {name} disagrees"
        for k_cap, planes in compacts:
            if callable(k_cap):
                k_cap = k_cap(int(want.count))
            c_got = no_host_wait(lambda: sm.sel_compact(got, k_cap, planes))
            torch.cuda.synchronize()
            c_want = sm.sel_compact_plain(want, k_cap, planes)
            assert torch.equal(c_got.buf, c_want.buf), \
                f"sel_compact {name} k_cap={k_cap} disagrees"
            print(f"kernel sel_compact {name} k_cap={k_cap} planes="
                  f"{[str(t.dtype) for t in planes]}: count="
                  f"{int(c_got.count)} overflow={int(c_got.overflow)} "
                  f"blocks={sm.n_blocks(n)} max_abs_err=0", flush=True)
            del c_got
        print(f"kernel sel_mask {name}: count={int(got.count)} "
              f"max_abs_err=0", flush=True)
        del got, want, pred
    mask_run(dev)
    gc.collect()
    return 0, 0


def mask_run(dev, calls: int = 128) -> None:
    """``sel_mask`` called ``calls`` times back to back on one stream, no
    wait between, over random masks (sizes from one row to 2^22 + 5,
    densities 0 to 1, some off a 16-byte boundary), then each call's count
    and block counts and packed bytes against the plain version's: the
    count comes from the last CTA's tally, so a tally that failed to reset,
    or two calls that shared one, would show."""
    from tikv_tpu_torch.device import selection as sm
    g = torch.Generator(device="cpu").manual_seed(21)
    gd = torch.Generator(device=dev).manual_seed(22)
    sizes = torch.randint(1, (1 << 22) + 6, (calls,), generator=g).tolist()
    sizes[:4] = [1, 32768, 32769, (1 << 22) + 5]
    preds, outs = [], []
    for i, n in enumerate(sizes):
        p = float(torch.rand((), generator=g)) if i % 5 else float(i % 2)
        off = 3 if i % 7 == 0 else 0
        base = torch.rand(n + off, generator=gd, device=dev) < p
        preds.append(base[off:])
    torch.cuda.synchronize()
    saved = counts()
    for pred, n in zip(preds, sizes):
        outs.append(sm.sel_mask(pred, n))
    launched = counts()["sel_mask"] - saved["sel_mask"]
    set_counts(saved)
    assert launched == calls, f"sel_mask run: {launched} launches"
    torch.cuda.synchronize()
    for i, (pred, n, got) in enumerate(zip(preds, sizes, outs)):
        assert mask_equal(got, sm.sel_mask_plain(pred, n)), \
            f"sel_mask run: call {i} of {calls} (n={n}) disagrees"
    print(f"kernel sel_mask run: {calls} calls back to back on one stream, "
          f"n from {min(sizes)} to {max(sizes)}, each count, block count "
          f"and packed byte equal to the plain version's max_abs_err=0",
          flush=True)


def topn_cases(dev):
    """(name, keyword arguments of topn_select) on the card."""
    from tikv_tpu_torch.device import topn as tn
    g = torch.Generator(device="cpu").manual_seed(15)

    def bools(p, count):
        return (torch.rand(count, generator=g) < p).to(dev)

    def values(dtype, count, lo=-1000, hi=1000):
        if dtype == torch.float64:
            return (torch.randn(count, generator=g, dtype=dtype) * 1000
                    ).to(dev)
        return torch.randint(lo, hi, (count,), generator=g,
                             dtype=torch.int64).to(dtype).to(dev)

    def case(vals, n, k, desc=True, ok=None, mask=None, n_pad=None,
             bounds="data"):
        """``bounds``: "data" (the valid values' least and greatest, as the
        runner passes a bare column's), a pair, or None (the default
        placement)."""
        n_used, seglen = tn.segments(n, n_pad or -(-n // (1 << 18)) * (1 << 18))
        if bounds == "data":
            live = vals[:n] if ok is None else vals[:n][ok[:n]]
            bounds = (live.min().item(), live.max().item()) \
                if live.numel() else None
        return dict(values=vals, ok=ok, mask=mask, desc=desc, n=n,
                    n_used=n_used, seglen=seglen, k=k,
                    placement=tn.digit_placement(vals.dtype, desc, bounds))

    n = 5 * (1 << 17) + 777
    for dtype in (torch.int32, torch.int64, torch.float64):
        for desc in (True, False):
            d = "desc" if desc else "asc"
            v = values(dtype, n)
            yield f"{dtype}_{d}", case(v, n, 1000, desc)
            yield f"{dtype}_{d}_nulls_selection", case(
                v, n, 1000, desc, ok=bools(0.9, n), mask=bools(0.5, n))
    yield "small_n", case(values(torch.float64, 1000), 1000, 10)
    yield "limit_past_live_rows", case(values(torch.int32, n), n, 1000,
                                       mask=bools(1e-4, n))
    yield "limit_16384", case(values(torch.float64, n), n, 1 << 14, False,
                              ok=bools(0.7, n))
    ext = torch.tensor([-(1 << 63), -(1 << 63) + 1, -(1 << 63) + 2,
                        (1 << 63) - 1, (1 << 63) - 2, 0, -1], dtype=torch.int64,
                       device=dev)
    idx = torch.randint(0, 7, (n,), generator=g).to(dev)
    for desc in (True, False):
        yield f"int64_extremes_{'desc' if desc else 'asc'}", case(
            ext[idx], n, 1000, desc, ok=bools(0.95, n))
    zeros = torch.tensor([0.0, -0.0, 1.0, -1.0], dtype=torch.float64,
                         device=dev)[torch.randint(0, 4, (n,),
                                                   generator=g).to(dev)]
    yield "minus_zero_ties_zero", case(zeros, n, 1 << 14)
    big = 10 << 20
    tied = torch.full((big,), 1.5, dtype=torch.float64, device=dev)
    for desc in (True, False):
        d = "desc" if desc else "asc"
        yield f"10M_tied_keys_{d}", case(tied, big, 1000, desc)
        yield f"10M_null_keys_{d}", case(
            tied, big, 1000, desc,
            ok=torch.zeros(big, dtype=torch.bool, device=dev))
    # the common route's buffer: a crossing bin of exactly its rows, and
    # one row more (one value per bin: bounds (0, 1000))
    cap = tn.cand_capacity(1000)
    n = 3 << 20
    for extra, label in ((0, "at"), (1, "one_past")):
        v = torch.zeros(n, dtype=torch.int32, device=dev)
        v[torch.randperm(n, generator=g)[:cap + extra].to(dev)] = 1000
        yield f"crossing_bin_{label}_the_buffer", case(v, n, 1000)
    # narrow int32 keys: with their bounds one value per bin (common); with
    # the default placement a few bins hold every row (overflow)
    n = 1 << 22
    v = values(torch.int32, n, -100, 100)
    for desc in (True, False):
        d = "desc" if desc else "asc"
        yield f"narrow_int32_{d}_with_bounds", case(v, n, 1000, desc)
        yield f"narrow_int32_{d}_default_placement", case(v, n, 1000, desc,
                                                          bounds=None)
    yield "misaligned_planes", case(
        values(torch.float64, n + 3)[3:], n, 1000,
        ok=bools(0.9, n + 1)[1:], mask=bools(0.7, n + 2)[2:])


def check_topn(dev) -> int:
    """Every case equal to the plain version, the route the kernel took
    equal to ``plan_route``'s, and both routes taken."""
    from tikv_tpu_torch.device import topn as tn
    routes = set()
    for name, kw in topn_cases(dev):
        passes = torch.zeros(2, dtype=torch.int64, device=dev)
        got = tn.topn_select(**kw, passes=passes)
        torch.cuda.synchronize()
        want = tn.topn_plain(kw["values"], kw["ok"], kw["mask"], kw["desc"],
                             kw["n"], kw["n_used"], kw["k"])
        assert torch.equal(got, want), f"topn_select {name} disagrees"
        route, _bin, cands = tn.plan_route(
            kw["values"], kw["ok"], kw["mask"], kw["desc"], kw["n"],
            kw["n_used"], kw["k"], kw["placement"])
        took = (tn.ROUTE_COMMON, tn.ROUTE_OVERFLOW)[int(passes[1])]
        assert took == route, f"topn_select {name} took {took}, not {route}"
        routes.add(took)
        print(f"kernel topn_select {name}: n={kw['n']} k={kw['k']} "
              f"live={int((got[1] & 1).sum())} route={took} "
              f"candidates={cands} reads_per_row={int(passes[0]) / kw['n']} "
              f"max_abs_err=0", flush=True)
    assert routes == {tn.ROUTE_COMMON, tn.ROUTE_OVERFLOW}, routes
    gc.collect()
    return 0


# ---------------------------------------------------------------------------
# agg_fold against its plain version
# ---------------------------------------------------------------------------

FOLD_KINDS = ("count", "count_star", "sum", "avg", "min", "max", "var_pop",
              "var_samp", "stddev_pop", "stddev_samp")


def fold_mag(kw: dict, dev):
    """The plain fold over |v| (each distinct values tensor replaced by one
    tensor of its magnitudes, so the lanes stay the same): per float64
    cell the Σ|v| its tolerance scales with."""
    from tikv_tpu_torch.device import agg_fold as af
    absolute: dict = {}

    def mag(t):
        if t.data_ptr() not in absolute:
            absolute[t.data_ptr()] = t.abs()
        return absolute[t.data_ptr()]

    cols = [None if c is None else (mag(c[0]), c[1]) for c in kw["cols"]]
    return af.agg_fold_plain(**dict(kw, cols=cols), device=dev)


def fold_err(kw: dict, dev) -> float:
    """agg_fold against its plain version: every integer, MIN/MAX, FIRST
    and count row bit-equal (MIN/MAX images fold -0.0 into +0.0 on both
    sides), the float64 sums within SF_TOL·Σ|v| of their cell.  Returns
    the largest difference."""
    from tikv_tpu_torch.device import agg_fold as af
    got = af.agg_fold(**kw, device=dev)
    torch.cuda.synchronize()
    want = af.agg_fold_plain(**kw, device=dev)
    assert got.plan.rows == want.plan.rows
    S = got.n_slots
    g, w = got.buf[1:].view(-1, S), want.buf[1:].view(-1, S)
    assert int(got.buf[0]) == int(want.buf[0]), "agg_fold overflow flag"
    floats = [r for r, (state, _j) in enumerate(got.plan.rows)
              if state in ("fsum", "sumsq")]
    ints = [r for r in range(len(got.plan.rows)) if r not in floats]
    assert torch.equal(g[ints], w[ints]), "agg_fold integer states disagree"
    if not floats:
        return 0.0
    m = fold_mag(kw, dev).buf[1:].view(-1, S)[floats].view(torch.float64)
    diff = (g[floats].view(torch.float64) - w[floats].view(torch.float64)
            ).abs()
    assert bool((diff <= SF_TOL * m).all()), \
        "agg_fold float64 sums beyond tolerance"
    print(f"  float64 sums: largest difference over its cell's Σ|v| "
          f"{float((diff / m.clamp(min=1e-300)).max())}", flush=True)
    return float(diff.max())


def agg_fold_cases(dev):
    """(name, agg_fold keyword arguments) on the card: every state kind
    and value dtype, NULLs, selections, dense / sparse / simple slots at
    1026, 65,538 and 2^20 + 2 slots, the overflow flag, hot slots over
    2^24 rows, int32 extremes, ragged n and misaligned planes."""
    from tikv_tpu_torch.ops.agg import AggSpec
    g = torch.Generator(device="cpu").manual_seed(16)
    n = 1 << 18

    def bools(p, count=n):
        return (torch.rand(count, generator=g) < p).to(dev)

    def col(dtype, count=n, lo=-1000, hi=1000):
        if dtype.is_floating_point:
            return (torch.randn(count, generator=g, dtype=torch.float64)
                    * 1000).to(dtype).to(dev)
        return torch.randint(lo, hi, (count,), generator=g,
                             dtype=torch.int64).to(dtype).to(dev)

    def spec_cols(kinds, v, ok, real):
        from tikv_tpu_torch.datatype import EvalType
        et = EvalType.REAL if real else EvalType.INT
        specs = [AggSpec(k, i, et) for i, k in enumerate(kinds)]
        return specs, [None if k == "count_star" else (v, ok) for k in kinds]

    for dtype in (torch.int32, torch.int64, torch.float32, torch.float64):
        v, ok = col(dtype), bools(0.85)
        specs, cols = spec_cols(FOLD_KINDS, v, ok, dtype.is_floating_point)
        for slots in (1026, 65538, (1 << 20) + 2):
            cap = slots - 2
            for mask_kind in ("none", "partial", "all_false"):
                mask = {"none": None, "partial": bools(0.7),
                        "all_false": torch.zeros(n, dtype=torch.bool,
                                                 device=dev)}[mask_kind]
                key = (-300 + torch.randint(0, cap, (n,), generator=g)
                       ).to(dev)
                yield (f"{dtype}_dense_slots={slots}_{mask_kind}", dict(
                    specs=specs, cols=cols, n=n, mode="dense",
                    key=key.to(torch.int32), key_ok=bools(0.95), base=-300,
                    capacity=cap, mask=mask))
            yield f"{dtype}_sparse_slots={slots}", dict(
                specs=specs, cols=cols, n=n, mode="sparse",
                slot_ids=torch.randint(0, slots, (n,), generator=g).to(
                    torch.int32).to(dev), capacity=cap, mask=bools(0.6))
        fspecs, fcols = spec_cols(FOLD_KINDS + ("first",), v, ok,
                                  dtype.is_floating_point)
        yield f"{dtype}_simple", dict(specs=fspecs, cols=fcols, n=n,
                                      mode="simple", mask=bools(0.5))
        yield f"{dtype}_simple_no_validity", dict(
            specs=fspecs, cols=[None if c is None else (v, None)
                                for c in fcols], n=n, mode="simple")
    # FIRST where the first selected row is NULL, and the first tiles'
    # selected rows all NULL (the answer is NULL, not a later row's value)
    for dtype in (torch.int32, torch.float64):
        v, ok, mask = col(dtype), bools(0.85), bools(0.5)
        ok[:8192] = False
        mask[:3] = False
        fspecs, fcols = spec_cols(("first", "count", "count_star"), v, ok,
                                  dtype.is_floating_point)
        yield f"{dtype}_simple_first_null", dict(
            specs=fspecs, cols=fcols, n=n, mode="simple", mask=mask)
    # two lanes sharing a values plane, an int64 key, and the overflow flag
    v, a, b = col(torch.int32), bools(0.6), bools(0.3)
    specs = [AggSpec("min", 0), AggSpec("sum", 1), AggSpec("var_pop", 2),
             AggSpec("max", 3), AggSpec("count_star", 4)]
    cols = [(v, a), (v, b), (v, a), (v, None), None]
    key = (torch.randint(0, 1024, (n,), generator=g) + (1 << 40)).to(dev)
    key[:5] = (1 << 40) + 5000                  # live keys out of range
    yield "shared_values_int64_key_overflow", dict(
        specs=specs, cols=cols, n=n, mode="dense", key=key, base=1 << 40,
        capacity=1024)
    # hot slots over 2^24 rows at the int32 extremes
    hot = 1 << 24
    ext = torch.tensor([2**31 - 1, -2**31], dtype=torch.int32,
                       device=dev)[torch.randint(0, 2, (hot,), generator=g)
                                   .to(dev)]
    ext[: hot // 2] = 2**31 - 1
    specs, cols = spec_cols(("sum", "min", "max", "var_pop", "count"), ext,
                            bools(0.5, hot), False)
    for slots in (1026, 65538):
        yield f"hot_slot_int32_extremes_{hot}_rows_slots={slots}", dict(
            specs=specs, cols=cols, n=hot, mode="dense",
            key=torch.full((hot,), 7, dtype=torch.int32, device=dev),
            base=0, capacity=slots - 2)
    # the same rows spread over 1024 slots, the bound given (2^31)
    yield f"int32_extremes_{hot}_rows_bound=2^31", dict(
        specs=specs, cols=cols, n=hot, mode="dense",
        key=torch.randint(0, 1024, (hot,), generator=g).to(
            torch.int32).to(dev), capacity=1024, value_bound=1 << 31)
    sspecs, scols = spec_cols(("sum", "min", "max", "first", "avg"), ext,
                              bools(0.5, hot), False)
    yield f"simple_int32_extremes_{hot}_rows", dict(
        specs=sspecs, cols=scols, n=hot, mode="simple")
    del ext
    # value bounds that shrink the shared route's cells: one signed sum
    # cell and one v² cell (|v| <= 300), one sum cell and two limbs (|v| <=
    # 1000, 4m's), the split sum and four limbs (the int32 extremes)
    for lo, bound in ((-300, 300), (-1000, 1000)):
        vb = col(torch.int32, lo=lo, hi=bound + 1)
        vb[:2] = torch.tensor([lo, bound], dtype=torch.int32)
        specs, cols = spec_cols(FOLD_KINDS, vb, bools(0.9), False)
        for slots in (1026, 4098):
            yield f"int32_bound={bound}_slots={slots}", dict(
                specs=specs, cols=cols, n=n, mode="dense",
                key=torch.randint(0, slots - 2, (n,), generator=g).to(
                    torch.int32).to(dev), capacity=slots - 2,
                mask=bools(0.8), value_bound=bound)
        yield f"int32_bound={bound}_hot_slot", dict(
            specs=specs, cols=cols, n=n, mode="dense",
            key=torch.full((n,), 3, dtype=torch.int32, device=dev),
            capacity=1024, value_bound=bound)
        yield f"int32_bound={bound}_simple", dict(
            specs=specs, cols=cols, n=n, mode="simple", value_bound=bound)
    # ragged n and planes 1-3 elements off a 16-byte boundary
    big = col(torch.float32, n + 8)
    ks = torch.randint(0, 1024, (n + 8,), generator=g).to(torch.int32).to(dev)
    okb, mb = bools(0.8, n + 8), bools(0.7, n + 8)
    for off in (1, 2, 3):
        specs, cols = spec_cols(FOLD_KINDS, big[off:], okb[4 - off:], True)
        for count in (n - 5, 4097, 3, 1):
            yield f"off_by_{off}_n={count}", dict(
                specs=specs, cols=cols, n=count, mode="dense",
                key=ks[off:], base=0, capacity=1024, mask=mb[off:])


def check_agg_fold(dev) -> float:
    from tikv_tpu_torch.device import agg_fold as af
    worst, routes = 0.0, set()
    for name, kw in agg_fold_cases(dev):
        err = fold_err(kw, dev)
        route = af.route(kw["specs"], kw["cols"], kw["mode"],
                         1 if kw["mode"] == "simple" else kw["capacity"] + 2,
                         dev, kw.get("value_bound"))
        routes.add(route)
        print(f"kernel agg_fold {name}: route={route} max_abs_err={err} "
              f"(integer, MIN/MAX, FIRST states exact; float64 sums within "
              f"{SF_TOL}·Σ|v|)", flush=True)
        worst = max(worst, err)
    assert routes == {af.ROUTE_SHARED, af.ROUTE_GLOBAL,
                      af.ROUTE_REGISTERS}, routes
    gc.collect()
    return worst


# ---------------------------------------------------------------------------
# the selection, top-k and index-scan routes
# ---------------------------------------------------------------------------

def row_phases(runner, dag, snap, repeats: int = 5) -> dict:
    """Host-clock phases (ms, the median of ``repeats`` warm requests) of a
    request on the selection or top-k route: analyze (``_analyze``),
    inputs (``_inputs``: the feed's planes, and a top-k's selection
    outside its wrapper), launch (the ``sel_pred``/``sel_mask``/
    ``sel_compact``/``topn_select`` wrappers), kernel_wait (a synchronize
    right after each wrapper: the device work queued so far), d2h (the
    selection's one copy of its result buffer; a top-k's copy is in
    "other"), rows (the host gather or take of the result rows, and for a
    top-k the scan's views) and other (the rest: EWMA, unpacking, the
    top-k refine).  A phase inside another counts only in the inner one.
    The copies to the host start at dispatch (pinned staging, in
    "other"); d2h is the wait for them (``_readback``), and the packed
    mask's copy where an index capacity overflowed."""
    from tikv_tpu_torch.datatype import ColumnBatch
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.device import topn as tn
    saved = counts()
    runs = []
    for _ in range(repeats):
        spent = dict.fromkeys(("analyze", "inputs", "launch", "kernel_wait",
                               "d2h", "rows"), 0.0)
        patched = []
        inner = [0.0]           # time of the phases inside the open one

        def timed(owner, name, phase, wait=False):
            fn = getattr(owner, name)

            def wrap(*a, **k):
                outer, inner[0] = inner[0], 0.0
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    took = time.perf_counter() - t0
                    spent[phase] += took - inner[0]
                    if wait:
                        t1 = time.perf_counter()
                        torch.cuda.synchronize()
                        spent["kernel_wait"] += time.perf_counter() - t1
                        took += time.perf_counter() - t1
                    inner[0] = outer + took
            patched.append((owner, name, owner.__dict__.get(name)))
            setattr(owner, name, wrap)

        timed(runner, "_analyze", "analyze")
        timed(runner, "_inputs", "inputs")
        for owner, name in ((sm, "sel_pred"), (sm, "sel_mask"),
                            (sm, "sel_compact"), (tn, "topn_select")):
            timed(owner, name, "launch", wait=True)
        timed(runner, "_readback", "d2h")
        timed(sm.MaskOut, "host", "d2h")
        for name in ("gather_rows", "scan_columns"):
            timed(snap, name, "rows")
        for name in ("take", "filter"):
            timed(ColumnBatch, name, "rows")
        try:
            t0 = time.perf_counter()
            runner.handle_request(dag, snap)
            total = time.perf_counter() - t0
        finally:     # a module's or class's own attribute comes back;
            # an instance's shadow of its class's method goes
            for owner, name, own in reversed(patched):
                if own is None:
                    delattr(owner, name)
                else:
                    setattr(owner, name, own)
        ms = {k: v * 1e3 for k, v in spent.items()}
        ms["other"] = total * 1e3 - sum(ms.values())
        ms["total"] = total * 1e3
        runs.append(ms)
    set_counts(saved)
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def run_row_config(config: str, n: int, runner) -> dict:
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf
    build, make = cf.ROW_CONFIGS[config]
    t0 = time.perf_counter()
    table, snap = build(n)
    dag = dag_from_wire(enc_dag(make(table)))
    want = cf.row_truth_columns(config, snap)
    print(f"config {config}: table and truth in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    out = serve(config, n, runner, dag, snap, lambda r: r.batch,
                lambda batch: cf.columns_agree(batch, want),
                ROW_ROUTE[config], selected=len(want[0][0]))
    out["host_phases_ms"] = row_phases(runner, dag, snap)
    del snap
    gc.collect()
    return out


def run_sweep(runner) -> list:
    """Config 2s: config 2's table at each selectivity of the sweep; the
    last warm request must take the route of ``SWEEP_ROUTE``."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf
    table, snap = cf.build_table(SWEEP_ROWS)
    runs = []
    for point, frac in cf.SWEEP.items():
        thr = cf.sweep_threshold(snap, frac)
        dag = dag_from_wire(enc_dag(cf.dag_selection(table, thr)))
        want = cf.row_truth_columns("2s", snap, thr)
        out = serve(f"2s@{point}", SWEEP_ROWS, runner, dag, snap,
                    lambda r: r.batch,
                    lambda batch: cf.columns_agree(batch, want),
                    {"sel_pred"}, selected=len(want[0][0]))
        assert set(out["last_route"]) == {SWEEP_ROUTE[point]}, \
            f"config 2s@{point} took {out['last_route']}"
        out["host_phases_ms"] = row_phases(runner, dag, snap)
        runs.append(out)
    del snap
    gc.collect()
    return runs


def run_uncovered(runner) -> dict:
    """Config 2's table with a predicate outside sel_pred's signatures
    (``v DIV 3 > 266``, IntDivideInt): the torch route, then sel_mask;
    each answer held exactly against numpy."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.expr import Expr
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.testing.dag import DagSelect
    table, snap = cf.build_table(SWEEP_ROWS)
    s = DagSelect.from_table(table, [c.name for c in table.columns])
    dag = dag_from_wire(enc_dag(s.where(Expr.call(
        "GtInt", Expr.call("IntDivideInt", s.col("v"),
                           Expr.const(3, EvalType.INT)),
        Expr.const(266, EvalType.INT))).build()))
    v = snap.columns[3].values.astype(np.int64)
    div = np.where(v >= 0, v // 3, -(-v // 3))          # toward zero
    keep = np.flatnonzero(snap.columns[3].validity & (div > 266))
    want = [(snap.handles[keep], np.ones(len(keep), np.bool_))] + [
        (snap.columns[c].values[keep], snap.columns[c].validity[keep])
        for c in (2, 3)]
    out = serve("2 (IntDivideInt)", SWEEP_ROWS, runner, dag, snap,
                lambda r: r.batch,
                lambda batch: cf.columns_agree(batch, want),
                {"sel_mask"}, selected=len(keep))
    del snap
    gc.collect()
    return out


def time_types_kernels(runner, dag, snap, dev, owner, name: str,
                       label: str) -> float:
    """The runner's call of ``name`` on one warm request of ``dag``
    (recorded, not counted), run again as the kernel and as its plain
    version on the card: bit for bit (integer states) → 0.0; both timed
    at that shape and printed."""
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.device import topn as tn
    args, kw = captured_calls(owner, name,
                              lambda: runner.handle_request(dag, snap))[0]
    saved = counts()
    if name == "sel_pred":
        prog, planes, n, bools = args
        got, want = sm.sel_pred(*args), sm.sel_pred_plain(*args)
        assert mask_equal(got[0], want[0]) and (
            got[1] is None or torch.equal(got[1], want[1])), \
            f"sel_pred disagrees at cell {label}"
        kernel = (lambda: sm.sel_pred(*args))
        plain = (lambda: sm.sel_pred_plain(*args))
        err = 0.0
    elif name == "agg_fold":
        specs, cols, n, mode = args
        kw = dict(specs=specs, cols=cols, n=n, mode=mode,
                  **{k: v for k, v in kw.items() if k != "device"})
        from tikv_tpu_torch.device import agg_fold as af
        err = fold_err(kw, dev)
        kernel = (lambda: af.agg_fold(**kw, device=dev))
        plain = (lambda: af.agg_fold_plain(**kw, device=dev))
    else:
        values, ok, mask, desc, n, n_used, _seglen, k = args
        got = tn.topn_select(*args, **kw)
        want = tn.topn_plain(values, ok, mask, desc, n, n_used, k)
        assert torch.equal(got, want), f"topn_select disagrees at {label}"
        kernel = (lambda: tn.topn_select(*args, **kw))
        plain = (lambda: tn.topn_plain(values, ok, mask, desc, n, n_used,
                                       k))
        err = 0.0
    ms = cuda_ms(kernel, 10, queued=True)
    plain_ms = cuda_ms(plain, 3)
    set_counts(saved)
    print(f"kernel {name} at cell {label} shape ({n} rows): max_abs_err="
          f"{err} ms={ms} plain_ms={plain_ms}", flush=True)
    return err


def run_time_types(runner, dev) -> tuple:
    """The time-types cells (``configs.TIME_CELLS``) on one table of
    ``configs.TIME_ROWS`` rows: t2, t4m and t5 through
    ``DeviceRunner().handle_request`` (``sel_pred`` over a time compare,
    ``agg_fold``, ``topn_select``), each kernel of the three then held
    against its plain version on the runner's own arguments; tshift's
    shifts on the torch route; th (a host-only ``Year``) through the
    endpoint, which answers on the host with no launch; and a year-9999
    variant of ``d`` (2^20 rows), which the endpoint answers on the host
    and which raises ``FeedBeyondInt64`` when the device is forced.  Every
    answer exactly against numpy → (the runs, each kernel's largest
    difference)."""
    import tikv_tpu_torch.device.runner as rmod
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.endpoint import (REQ_TYPE_DAG, CopRequest,
                                              Endpoint)
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.device import topn as tn
    from tikv_tpu_torch.testing import configs as cf
    t0 = time.perf_counter()
    table, snap = cf.build_time_table(cf.TIME_ROWS)
    n = cf.TIME_ROWS
    dags = {c: dag_from_wire(enc_dag(cf.dag_time(table, c)))
            for c in cf.TIME_CELLS}
    truth = {c: cf.time_truth(c, snap) for c in cf.TIME_CELLS}
    print(f"time types: table and truth in {time.perf_counter() - t0:.3f} "
          f"s", flush=True)

    def ints(rows):
        return [tuple(int(x) for x in r) for r in rows]

    runs = []
    for cell, expect in (("t2", {"sel_pred", "agg_fold"}),
                         ("t4m", {"sel_pred", "agg_fold"}),
                         ("t5", {"sel_pred", "topn_select"})):
        want = truth[cell]
        # groups and top-k rows come out in the truth's order
        runs.append(serve(cell, n, runner, dags[cell], snap,
                          lambda r: ints(r.rows()),
                          lambda rows, w=want: rows == w, expect,
                          groups=len(want)))
    worst = {
        "sel_pred": time_types_kernels(runner, dags["t2"], snap, dev, sm,
                                       "sel_pred", "t2"),
        "agg_fold": time_types_kernels(runner, dags["t4m"], snap, dev, rmod,
                                       "agg_fold", "t4m"),
        "topn_select": time_types_kernels(runner, dags["t5"], snap, dev, tn,
                                          "topn_select", "t5")}
    # the shifts: the torch route; the fold is whichever the plan's gate
    # picks on the card, the same for every request
    set_counts({k: 0 for k in KERNELS})
    assert ints(runner.handle_request(dags["tshift"], snap).rows()) == \
        truth["tshift"], "tshift: wrong answer"
    route = {k for k, v in counts().items() if v}
    assert route and route <= {"hash_agg", "agg_fold"}, \
        f"tshift launched {route}"
    out = serve("tshift", n, runner, dags["tshift"], snap,
                lambda r: ints(r.rows()),
                lambda rows: rows == truth["tshift"], route)
    assert out["pred_routes"] == {"torch": 6}, out["pred_routes"]
    runs.append(out)
    # th: a host-only sig; the endpoint answers on the host at any size
    ep = Endpoint(lambda req: snap, device_runner=runner,
                  device_row_threshold=1)
    set_counts({k: 0 for k in KERNELS})
    walls = []
    for _ in range(6):
        t1 = time.perf_counter()
        resp = ep.handle(CopRequest(REQ_TYPE_DAG, dags["th"]))
        walls.append(time.perf_counter() - t1)
        assert resp.backend == "host" and \
            ints(resp.rows()) == truth["th"], "th: wrong answer or backend"
    launches = counts()
    assert not any(launches.values()), f"th launched {launches}"
    th = {"config": "th", "rows": n, "backend": "host",
          "cold_ms": walls[0] * 1e3,
          "warm_p50_ms": float(np.percentile(walls[1:], 50)) * 1e3,
          "rows_per_s": n / float(np.percentile(walls[1:], 50)),
          "launches": launches, "device_ops": 0}
    print("config th: " + " ".join(f"{k}={v}" for k, v in th.items()
                                   if k != "config"), flush=True)
    runs.append(th)
    del snap
    gc.collect()
    # the feed guard: a year-9999 core (above 2^63) in d
    table, snap = cf.build_time_table(1 << 20, year_9999_at=7)
    dag = dag_from_wire(enc_dag(cf.dag_time(table, "t2")))
    ep = Endpoint(lambda req: snap, device_runner=runner,
                  device_row_threshold=1)
    set_counts({k: 0 for k in KERNELS})
    resp = ep.handle(CopRequest(REQ_TYPE_DAG, dag))
    assert resp.backend == "host" and ints(resp.rows()) == \
        cf.time_truth("t2", snap), "year 9999: wrong answer or backend"
    try:
        ep.handle(CopRequest(REQ_TYPE_DAG, dag, "device"))
        raise AssertionError("year 9999: the forced request did not raise")
    except rmod.FeedBeyondInt64:
        pass
    assert ep.degrades == {"beyond_int64": 1}, ep.degrades
    assert not any(counts().values()), "year 9999 launched a kernel"
    print("time types: year 9999 answered on the host, forced device "
          "raised FeedBeyondInt64", flush=True)
    del snap
    gc.collect()
    return runs, worst


# ---------------------------------------------------------------------------
# selection and top-k kernels at the main path's shapes
# ---------------------------------------------------------------------------

def time_pred(config: str, prog, planes, n: int, bools: bool, library,
              dev) -> dict:
    """sel_pred at one config's shape: against its plain version (exact)
    and timed beside its bound (the planes the program reads, read once;
    the packed mask, block counts and count — and the bool mask — written
    once; one operation per op and row), its plain version and one
    library call (``library``: the predicate's torch comparison, which
    writes the bool mask and neither counts nor packs it; a yardstick the
    port never calls)."""
    from tikv_tpu_torch.device import selection as sm
    saved = counts()
    got, got_b = sm.sel_pred(prog, planes, n, bools)
    want, want_b = sm.sel_pred_plain(prog, planes, n, bools)
    assert mask_equal(got, want) and (not bools or torch.equal(
        got_b, want_b)), f"sel_pred disagrees at config {config}'s shape"
    nb = sm.n_blocks(n)
    read = sum(n * t.element_size() for ci in prog.cols
               for t in planes[ci] if t is not None)
    t = {"ms": cuda_ms(lambda: sm.sel_pred(prog, planes, n, bools), 50,
                       queued=True),
         "plain_ms": cuda_ms(lambda: sm.sel_pred_plain(prog, planes, n,
                                                       bools), 5),
         "library_ms": cuda_ms(library, 50),
         "library_call": "the torch comparison (yardstick)",
         **bound_ms(read + -(-n // 8) + 4 * nb + 8 + (n if bools else 0),
                    n * len(prog.ops)),
         "rows": n, "selected": int(got.count), "bools": bools,
         "ops": len(prog.ops),
         "peak_bytes": peak_bytes(lambda: sm.sel_pred(prog, planes, n,
                                                      bools))}
    set_counts(saved)
    print(f"kernel sel_pred at config {config} shape ({n} rows): "
          f"max_abs_err=0 " + " ".join(f"{k}={x}" for k, x in t.items()),
          flush=True)
    return t


def launch_floor(dev) -> float:
    """The least device time of one launch: an empty kernel
    (``csrc/floor.cu``) timed as every kernel is, queued behind the device
    sleep; printed as ``launch_floor_ms``."""
    from tikv_tpu_torch.device import build
    lib = build.load_checked("floor", {}, "floor_error_string")
    lib.floor_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.floor_launch.restype = ctypes.c_int
    index = dev.index

    def launch():
        build.raise_on(lib, "floor_error_string", lib.floor_launch(
            index, torch.cuda.current_stream(dev).cuda_stream),
            "floor launch")
    ms = cuda_ms(launch, 200, queued=True)
    print(f"launch_floor_ms={ms} (an empty kernel, queued)", flush=True)
    return ms


def param_floors(dev) -> dict:
    """The empty kernel (``csrc/floor.cu``) queued with a parameter block
    of a launch-bound kernel's size: ``shard_psum``'s 256 bytes (S = 4),
    bare and launched programmatically as the psum is, and its former
    1,880; ``patch_rows``' classes of 64, 256 and 4,096 → {label: ms}."""
    from tikv_tpu_torch.device import build
    lib = build.load_checked("floor", {}, "floor_error_string")
    lib.floor_params_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
    lib.floor_params_launch.restype = ctypes.c_int
    out = {}
    for nbytes, dep in ((256, 0), (256, 1), (1880, 0), (64, 0),
                        (4096, 0)):
        def launch():
            build.raise_on(lib, "floor_error_string", lib.floor_params_launch(
                dev.index, nbytes, dep,
                torch.cuda.current_stream(dev).cuda_stream), "floor launch")
        out[f"{nbytes} B" + (" programmatic" if dep else "")] = cuda_ms(
            launch, 200, queued=True)
    print("launch floor with parameters (ms, queued): " + json.dumps(out),
          flush=True)
    return out


def selection_at_main_shapes(dev, floor_ms: float) -> tuple:
    """sel_pred and sel_mask at config 2 and sel_compact at config 2s's 1%
    (index mode) and 0.1% (planes mode), exact against their plain versions
    and timed (sel_mask and sel_compact beside ``floor_ms``, the launch
    floor); →
    (sel_pred timing, sel_mask timing, sel_compact timing)."""
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.expr import Expr, build_rpn
    from tikv_tpu_torch.testing import configs as cf
    _table, snap = cf.build_table(SWEEP_ROWS)
    n = SWEEP_ROWS
    planes = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        snap.handles, snap.columns[2].values, snap.columns[3].values)]
    v = planes[2]
    saved = counts()
    pred_t = time_pred("2", sm.encode_predicate(
        [build_rpn(Expr.column(0) > Expr.const(800, EvalType.INT))],
        [torch.int32]), [(v, None)], n, False, lambda: torch.gt(v, 800),
        dev)
    pred = v > 800
    got = sm.sel_mask(pred, n)
    assert mask_equal(got, sm.sel_mask_plain(pred, n)), \
        "sel_mask disagrees at config 2's shape"
    nb = sm.n_blocks(n)
    mask_t = {"ms": cuda_ms(lambda: sm.sel_mask(pred, n), 50, queued=True),
              "plain_ms": cuda_ms(lambda: sm.sel_mask_plain(pred, n), 5),
              "library_ms": cuda_ms(lambda: torch.count_nonzero(pred), 50),
              # the bools read once, the packed bytes, counts and count
              # written once; one pack step per row
              **bound_ms(n + -(-n // 8) + 4 * nb + 8, n),
              "launch_floor_ms": floor_ms,
              "rows": n, "selected": int(got.count)}
    print(f"kernel sel_mask at config 2 shape ({n} rows): max_abs_err=0 " +
          " ".join(f"{k}={x}" for k, x in mask_t.items()), flush=True)
    modes = {}
    for point, planes_here in (("1%", []), ("0.1%", planes)):
        pred = v > cf.sweep_threshold(snap, cf.SWEEP[point])
        mout = sm.sel_mask(pred, n)
        k = int(mout.count)
        cap = sm.index_capacity(k * 1.5 + 64, n)
        c_got = sm.sel_compact(mout, cap, planes_here)
        assert torch.equal(c_got.buf, sm.sel_compact_plain(
            sm.sel_mask_plain(pred, n), cap, planes_here).buf), \
            f"sel_compact disagrees at config 2s {point}"
        esize = sum(t.element_size() for t in planes_here)
        t = {"ms": cuda_ms(lambda: sm.sel_compact(mout, cap, planes_here),
                           50, queued=True),
             "plain_ms": cuda_ms(lambda: sm.sel_compact_plain(
                 mout, cap, planes_here), 5),
             "library_ms": cuda_ms(lambda: torch.nonzero(pred), 20),
             # the packed mask and block counts read once, each selected
             # row's plane elements gathered once; the header, indices and
             # gathered planes written once; a scan step per row
             **bound_ms(-(-n // 8) + 4 * nb + min(k, cap) * esize
                        + HEADER_BYTES + cap * (4 + esize), n),
             "launch_floor_ms": floor_ms,
             "rows": n, "selected": k, "k_cap": cap,
             "planes": len(planes_here)}
        modes["index" if not planes_here else "planes"] = t
        print(f"kernel sel_compact at config 2s {point} shape ({n} rows, "
              f"{len(planes_here)} planes): max_abs_err=0 " +
              " ".join(f"{k}={x}" for k, x in t.items()), flush=True)
    set_counts(saved)
    compact_t = {k: x for k, x in modes["index"].items()}
    compact_t["modes"] = modes
    del snap, planes, v, pred
    gc.collect()
    return pred_t, mask_t, compact_t


def topn_at_main_shapes(runner, dev) -> tuple:
    """topn_select at configs 5 and 5t on the runner's own feed planes,
    exact against its plain version and timed, and sel_pred at 5t's
    predicate (``k < 512``, the bool mask written); → (config 5's timing
    with 5t's under ``configs``, sel_pred's timing at 5t)."""
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.device import topn as tn
    from tikv_tpu_torch.expr import Expr, build_rpn
    from tikv_tpu_torch.testing import configs as cf
    timings = {}
    for config in ("5", "5t"):
        n = ROW_SIZES[config]
        _table, snap = cf.ROW_CONFIGS[config][0](n)
        vcol, kcol = snap.columns[3], snap.columns[2]
        n_pad = runner._pad_rows(n)
        values = torch.zeros(n_pad, dtype=torch.float64, device=dev)
        values[:n] = torch.from_numpy(vcol.values).to(dev)
        ok = mask = None
        if config == "5t":
            ok = torch.from_numpy(vcol.validity).to(dev)
            k32 = torch.from_numpy(kcol.values.astype(np.int32)).to(dev)
            pred_5t = time_pred("5t", sm.encode_predicate(
                [build_rpn(Expr.column(0) < Expr.const(512, EvalType.INT))],
                [torch.int32]), [(k32, None)], n, True,
                lambda: torch.lt(k32, 512), dev)
            mask = torch.from_numpy(kcol.values < 512).to(dev)
            del k32
        n_used, seglen = tn.segments(n, n_pad)
        k = cf.TOPN_LIMIT
        # the runner's placement: the valid values' bounds
        live = vcol.values[vcol.validity]
        kw = dict(values=values, ok=ok, mask=mask, desc=True, n=n,
                  n_used=n_used, seglen=seglen, k=k,
                  placement=tn.digit_placement(
                      torch.float64, True,
                      (float(live.min()), float(live.max()))))
        saved = counts()
        passes = torch.zeros(2, dtype=torch.int64, device=dev)
        got = tn.topn_select(**kw, passes=passes)
        want = tn.topn_plain(values, ok, mask, True, n, n_used, k)
        assert torch.equal(got, want), \
            f"topn_select disagrees at config {config}'s shape"
        nseg = n_used // seglen
        ms = cuda_ms(lambda: tn.topn_select(**kw), 10, queued=True)
        plain_ms = cuda_ms(lambda: tn.topn_plain(values, ok, mask, True, n,
                                                 n_used, k), 2)
        view = values[:n_used].view(nseg, seglen)
        library_ms = cuda_ms(lambda: torch.topk(view, min(k, seglen), dim=1),
                             5)
        extra = n * ((ok is not None) + (mask is not None))
        t = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
             # the order plane (and validity and selection) read once, the
             # result written once; one key and compare per row
             **bound_ms(8 * n + extra + 16 * min(k, n_used), n),
             "rows": n, "k": k,
             "topn_route": (tn.ROUTE_COMMON, tn.ROUTE_OVERFLOW)[
                 int(passes[1])],
             "reads_per_row": int(passes[0]) / n}
        if config == "5":
            # the overflow route alone on the same inputs (a placement that
            # puts every row in one bin), beside the common route
            flat = dict(kw, placement=(0, 63))
            assert torch.equal(tn.topn_select(**flat), want)
            t["overflow_route_ms"] = cuda_ms(lambda: tn.topn_select(**flat),
                                             5, queued=True)
        set_counts(saved)
        timings[config] = t
        print(f"kernel topn_select at config {config} shape ({n} rows): "
              f"max_abs_err=0 " + " ".join(f"{k}={x}" for k, x in t.items()),
              flush=True)
        del values, ok, mask, view, snap, want, got
        gc.collect()
    out = dict(timings["5"])
    out["configs"] = timings
    return out, pred_5t


# ---------------------------------------------------------------------------
# the cold MVCC path: mvcc_resolve, plane_digest, patch_rows
# ---------------------------------------------------------------------------

# config → keys on the card (bench.py's 6c default, 4h's 100·2^20)
COLD_SIZES = {"6c": 10 << 20, "4h": 100 << 20}
# DeviceVersionPlanes' chunks: at most 2^20 keys each, at least 4
CHUNK_KEYS = 1 << 20
FEED_DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32,
               torch.int64, torch.float32, torch.float64)
U64 = 1 << 64


def digest_err(got, want) -> int:
    """0 for two equal digests, else their distance mod 2^64."""
    from tikv_tpu_torch.device.digest import as_u64
    d = (as_u64(got) - as_u64(want)) % U64
    return min(d, U64 - d)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a NaN equals its own bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bool or a.element_size() == 1:
        return torch.equal(a, b)
    iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(iv), b.view(iv))


def random_plane(dtype, n: int, gen, dev) -> torch.Tensor:
    if dtype == torch.bool:
        t = torch.rand(n, generator=gen) < 0.5
    elif dtype.is_floating_point:
        t = (torch.randn(n, generator=gen, dtype=torch.float64) * 1e6) \
            .to(dtype)
    else:
        info = torch.iinfo(dtype)
        t = torch.randint(max(info.min, -(1 << 62)), min(info.max, 1 << 62),
                          (n,), generator=gen, dtype=torch.int64).to(dtype)
        t[:2] = torch.tensor([info.min, info.max]).to(dtype)[:n]
    return t.to(dev)


def check_digest(dev) -> tuple:
    """plane_digest and patch_rows against their plain versions on the
    card, on every feed dtype (and int8, int16): the digest over full and
    partial ranges of planes 0-7 elements off a 16-byte boundary, ragged
    and 2^24 + 3 rows long; patch_rows with and without digests at 1, 1000
    and 65,536 positions; then ``patch_feed_rows`` (``check_patch_feed``)
    → (worst digest distance, worst patch: elements that differ or a
    digest distance)."""
    from tikv_tpu_torch.device import digest as dg
    gen = torch.Generator().manual_seed(17)
    worst_d = worst_p = 0
    for dt in FEED_DTYPES:
        for n in (1, 15, 4097, (1 << 24) + 3):
            base = random_plane(dt, n + 8, gen, dev)
            for off in (0, 1, 3, 7):
                a = base[off:off + n]
                for lo, hi in ((0, n), (1, max(1, n - 1)),
                               (n // 3, n // 2), (n, n)):
                    worst_d = max(worst_d, digest_err(
                        dg.plane_digest(a, lo, hi),
                        dg.plane_digest_plain(a, lo, hi)))
        plane = random_plane(dt, 1 << 20, gen, dev)
        for m in (1, 1000, 1 << 16):
            pos = torch.randperm(1 << 20, generator=gen)[:m]
            vals = random_plane(dt, m, gen, dev)
            for digest in (True, False):
                a, b = plane.clone(), plane.clone()
                got = dg.patch_rows(a, pos, vals, digest=digest)
                want = dg.patch_rows_plain(b, pos.to(dev), vals, digest)
                bad = 0 if same_bits(a, b) else 1
                if digest:
                    bad = max(bad, digest_err(got[0], want[0]),
                              digest_err(got[1], want[1]))
                else:
                    bad = max(bad, int(got is not None))
                worst_p = max(worst_p, bad)
    torch.cuda.synchronize()
    print(f"check plane_digest: {len(FEED_DTYPES)} dtypes, 4 lengths, 4 "
          f"offsets, 4 ranges: worst digest distance {worst_d}", flush=True)
    print(f"check patch_rows: {len(FEED_DTYPES)} dtypes, m 1 / 1000 / "
          f"65536, with and without digests: worst {worst_p}", flush=True)
    worst_p = max(worst_p, check_patch_feed(dev))
    worst_s = check_patch_spans(dev)
    assert worst_d == 0 and worst_p == 0 and worst_s == 0, \
        "digest kernels disagree"
    return worst_d, worst_p, worst_s


def patch_err(planes, want_planes, got, want) -> int:
    """0 when every plane equals its plain twin bit for bit and the (P, 3)
    digests agree, else the planes that differ or the worst digest
    distance."""
    bad = sum(not same_bits(a, b) for a, b in zip(planes, want_planes))
    if (got is None) != (want is None):
        return max(bad, 1)
    if got is not None:
        bad = max(bad, max(digest_err(g, w) for g, w in zip(
            got.reshape(-1).tolist(), want.reshape(-1).tolist())))
    return bad


def check_patch_feed(dev) -> int:
    """``patch_feed_rows`` against its plain version on the card, bit for
    bit: every feed dtype together (P = 7, a bool validity plane among
    them) and three planes (int32, int64, bool), at 1, 2, 257, 1024, 1025
    and 65,536 rows, with digests (recorded digests by value and, for
    every other plane, the last call's R' by address) and without; values
    from the host and values on the card; planes of unequal length and 0-7
    elements off a 16-byte boundary; P = 120 planes of 2 rows (their
    descriptors past the parameter block) → the worst difference (0).
    Every call is one launch (the patch counter)."""
    from tikv_tpu_torch.device import digest as dg
    gen = torch.Generator().manual_seed(19)
    rng = np.random.default_rng(19)
    worst = n_cases = 0
    three = (torch.int32, torch.int64, torch.bool)
    for dtypes, m, digest, on_card in itertools.product(
            (FEED_DTYPES, three), (1, 2, 257, 1024, 1025, 1 << 16),
            (True, False), (False, True)):
        n = (1 << 17) + 5
        planes = [random_plane(dt, n + 8 + i, gen, dev)[i % 8:i % 8 + n - i]
                  for i, dt in enumerate(dtypes)]
        pos = rng.choice(n - len(dtypes), m, replace=False)
        vals = [random_plane(dt, m, gen, dev) for dt in dtypes]
        if not on_card:
            vals = [v.cpu() for v in vals]
        recs = None
        if digest:
            recs = [int(rng.integers(0, 1 << 62)) for _ in dtypes]
            prev = torch.tensor([[1, 2, 3]], dtype=torch.int64, device=dev)
            recs = [prev[0, 2] if i % 2 else r for i, r in enumerate(recs)]
        want_planes = [a.clone() for a in planes]
        want = dg.patch_feed_rows_plain(
            want_planes, torch.from_numpy(pos).to(dev),
            [v.to(dev) for v in vals], recs)
        before = dg.patch_launches
        got = dg.patch_feed_rows(planes, pos, vals, recs)
        worst = max(worst, patch_err(planes, want_planes, got, want),
                    int(dg.patch_launches - before != 1))
        n_cases += 1
    planes = [random_plane(torch.int32, 4096, gen, dev) for _ in range(120)]
    vals = [random_plane(torch.int32, 2, gen, dev) for _ in range(120)]
    want_planes = [a.clone() for a in planes]
    recs = list(range(120))
    want = dg.patch_feed_rows_plain(want_planes, torch.tensor(
        [7, 4000], device=dev), vals, recs)
    got = dg.patch_feed_rows(planes, [7, 4000], vals, recs)
    worst = max(worst, patch_err(planes, want_planes, got, want))
    torch.cuda.synchronize()
    print(f"check patch_feed_rows: {n_cases + 1} cases (P 3, 7 and 120; m "
          f"1 to 65536; host and card values; digests by value and by "
          f"address): worst {worst}", flush=True)
    return worst


def check_patch_spans(dev) -> int:
    """``patch_feed_spans`` against its plain version on the card, bit for
    bit: every feed dtype together (P = 7) and three planes (int32, int64,
    bool), K of 1, 4 and 300 spans (300 is past the parameter room: the
    descriptors go through the pinned copy) of 1, 257, 1,025 and 65,536
    rows (K 300 at the two short lengths), with digests (by value and, for
    every other plane, the last call's R' by address) and without, values
    from the host and on the card, planes of unequal length 0-7 elements
    off a 16-byte boundary; then P = 120 planes of 2-row spans at K 1, 4
    and 300 → the worst difference (0).  Every call is one launch (the
    span counter)."""
    from tikv_tpu_torch.device import digest as dg
    gen = torch.Generator().manual_seed(23)
    rng = np.random.default_rng(23)
    worst = n_cases = 0
    three = (torch.int32, torch.int64, torch.bool)
    shapes = [(k, r) for k in (1, 4) for r in (1, 257, 1025, 1 << 16)] + \
        [(300, 1), (300, 257)]

    def spans_of(k, rows, n):
        gaps = rng.integers(1, 40, k)
        lo = np.cumsum(gaps) + np.arange(k) * rows
        assert lo[-1] + rows <= n
        return [(int(a), int(a) + rows) for a in lo]

    for dtypes, (k, rows), digest, on_card in itertools.product(
            (FEED_DTYPES, three), shapes, (True, False), (False, True)):
        n = max((1 << 17) + 5, k * (rows + 40) + 16)
        planes = [random_plane(dt, n + 8 + i, gen, dev)[i % 8:i % 8 + n - i]
                  for i, dt in enumerate(dtypes)]
        spans = spans_of(k, rows, n - len(dtypes))
        vals = [random_plane(dt, k * rows, gen, dev) for dt in dtypes]
        if not on_card:
            vals = [v.cpu() for v in vals]
        recs = None
        if digest:
            recs = [int(rng.integers(0, 1 << 62)) for _ in dtypes]
            prev = torch.tensor([[1, 2, 3]], dtype=torch.int64, device=dev)
            recs = [prev[0, 2] if i % 2 else r for i, r in enumerate(recs)]
        want_planes = [a.clone() for a in planes]
        want = dg.patch_feed_spans_plain(want_planes, spans,
                                         [v.to(dev) for v in vals], recs)
        before = dg.span_launches
        got = dg.patch_feed_spans(planes, spans, vals, recs)
        worst = max(worst, patch_err(planes, want_planes, got, want),
                    int(dg.span_launches - before != 1))
        n_cases += 1
    for k in (1, 4, 300):
        planes = [random_plane(torch.int32, 4096, gen, dev)
                  for _ in range(120)]
        spans = [(7 + 12 * i, 9 + 12 * i) for i in range(k)]
        vals = [random_plane(torch.int32, 2 * k, gen, dev).cpu()
                for _ in range(120)]
        want_planes = [a.clone() for a in planes]
        recs = list(range(120))
        want = dg.patch_feed_spans_plain(want_planes, spans,
                                         [v.to(dev) for v in vals], recs)
        before = dg.span_launches
        got = dg.patch_feed_spans(planes, spans, vals, recs)
        worst = max(worst, patch_err(planes, want_planes, got, want),
                    int(dg.span_launches - before != 1))
        n_cases += 1
    torch.cuda.synchronize()
    print(f"check patch_feed_spans: {n_cases} cases (P 3, 7 and 120; K 1, "
          f"4 and 300; spans of 1 to 65536 rows; host and card values; "
          f"digests by value and by address): worst {worst}", flush=True)
    return worst


def full_spec(planes, dev) -> tuple:
    """Every column's value plane in each feed dtype its kind takes and
    its validity plane, and the handle → (sources, kinds, spec)."""
    from tikv_tpu_torch.device import mvcc as pm
    sources, kinds, spec = [], [], [("h", torch.int64), ("h", torch.int32)]
    for cid in planes.col_ids:
        kind, vals, valid = planes.cols[cid]
        sources += [pm._to_device(vals, dev), pm._to_device(valid, dev)]
        kinds += [kind, pm._SRC_BOOL]
        vi = len(sources) - 2
        spec += [("v", vi, dt) for dt in (
            (torch.float32, torch.float64) if kind == 1
            else (torch.int32, torch.int64))] + [("m", vi + 1)]
    return sources, kinds, spec


def check_mvcc(dev) -> int:
    """mvcc_resolve against its plain version on the card, exactly: seeded
    histories of deletes, rollbacks and locks, versions above read_ts,
    NULLs, INT, REAL and unsigned columns, every key deleted, an empty
    result, two versions of a key at one commit_ts, long segments (a key
    of 50,000 versions, a run of keys of 300, tiles at the shared budget
    and one version past it), a schema of 100 output planes (two
    launches), 2^20 keys, and the same planes resident in padded
    ``DeviceVersionPlanes`` buffers → the number of differing outputs
    (0)."""
    from tikv_tpu_torch.device import mvcc as pm
    from tikv_tpu_torch.testing import mvcc as tm
    rng = np.random.default_rng(23)
    kinds3 = {2: 0, 3: 1, 4: 3}
    cases = []
    for label, n_keys, shares, read_ts in (
            ("mixed", 700, None, 1000), ("deletes", 700, {1: 1.0}, 1000),
            ("rollbacks_locks", 700, {2: 0.5, 3: 0.5}, 1000),
            ("above_read_ts", 700, None, 45), ("empty", 700, None, 5),
            ("2^20 keys", 1 << 20, None, 45)):
        ev = tm.random_history(rng, n_keys, kinds3, 6, shares=shares)
        cases.append((label, tm.version_history(
            np.arange(n_keys) * 3 + 7, ev, kinds3, read_ts)[0], read_ts))
    keys = np.arange(500)
    cases.append(("every_key_deleted", tm.version_history(keys, [
        tm.Event(10, 0, keys, {2: (keys, np.ones(500, np.bool_))}),
        tm.Event(20, 1, keys)], {2: 0}, 100)[0], 100))
    cases.append(("equal_commit_ts", tm.equal_ts_planes(), 60))
    # long segments: a hot key of 50,000 versions, a run of keys of 300
    # each (tiles past the kernel's shared budget), and one key each of
    # 1025 and 1026 versions among keys of one (its tile at exactly the
    # budget, 2048 versions, and one past it)
    for label in ("hot_key", "long_run"):
        cases.append((label, *tm.long_segment_planes(label, kinds3)))
    lengths = np.ones(5000, np.int64)
    lengths[2500], lengths[4000] = 1025, 1026
    cases.append(("budget edge", tm.segment_history(rng, lengths, kinds3),
                  6000))
    wide = {c: 0 for c in range(2, 35)}
    cases.append(("100 outputs", tm.version_history(keys, tm.random_history(
        rng, 500, wide, 3), wide, 1000)[0], 1000))
    bad = 0
    for label, planes, read_ts in cases:
        sources, kinds, spec = full_spec(planes, dev)
        fixed = [pm._to_device(a, dev) for a in (
            planes.commit_ts, planes.wtype, planes.seg_start,
            planes.handles)]
        n_pad = max(1024, planes.n_keys + 5)
        got, count = pm.mvcc_resolve(*fixed, sources, kinds, spec, read_ts,
                                     planes.n_keys, n_pad)
        want, wcount = pm.mvcc_resolve_plain(*fixed, sources, kinds, spec,
                                             read_ts, planes.n_keys, n_pad)
        n = len(pm.resolve_host(planes, read_ts))
        diff = sum(not same_bits(g, w) for g, w in zip(got, want))
        diff += int(int(count) != n) + int(int(wcount) != n)
        if label == "2^20 keys":
            # the same planes resident, in 4 chunks, padded buffers
            dvp = pm.DeviceVersionPlanes(dev)
            for part in tm.split_planes(planes, -(-planes.n_keys // 4)):
                dvp.append(part)
            res = [dvp.bufs[k] for k in ("commit_ts", "wtype", "seg_start",
                                         "handles")]
            names = [n_ for c in planes.col_ids for n_ in (f"v{c}",
                                                          f"m{c}")]
            got2, count2 = pm.mvcc_resolve(
                *res, [dvp.bufs[nm] for nm in names], kinds, spec, read_ts,
                planes.n_keys, n_pad)
            diff += sum(not same_bits(g, w) for g, w in zip(got2, want))
            diff += int(int(count2) != n)
        print(f"check mvcc_resolve {label}: {planes.n_ver} versions, "
              f"{planes.n_keys} keys, {n} visible, {len(spec)} outputs: "
              f"{diff} differ", flush=True)
        bad += diff
    assert bad == 0, "mvcc_resolve disagrees with its plain version"
    return bad


def check_spill(runner, dev) -> int:
    """A mint with CF_DEFAULT spill rows on the card (every 7th visible
    row's cells supplied as ``defaults``): equal to the upload of its host
    mirror, bit for bit → the planes that differ (0)."""
    from tikv_tpu_torch.copr.region_cache import build_region_columnar_device
    from tikv_tpu_torch.device import digest as dg
    from tikv_tpu_torch.device import mvcc as pm
    from tikv_tpu_torch.testing import mvcc as tm
    from tikv_tpu_torch.testing.dag import DagSelect
    table, planes, _h, _t, read_ts = tm.history_4h(1 << 16)
    spilled, defaults = tm.spill(planes, pm.resolve_host(planes,
                                                         read_ts)[::7])
    infos = DagSelect.from_table(table, ["id", "k", "v"]).build() \
        .executors[0].columns
    saved = counts()
    tbl, _safe, bundle = build_region_columnar_device(
        spilled, table, infos, read_ts, runner.mvcc_resolver(),
        defaults=defaults)
    n = len(tbl)
    dtypes = ["int64", "int32", "int32"]
    launched = dg.patch_launches
    feed = bundle.mint(runner, infos, dtypes, n, runner._pad_rows(n))
    patches = dg.patch_launches - launched
    host = [(np.ascontiguousarray(
        (tbl.handles if i.is_pk_handle else tbl.columns[i.col_id].values)
        .astype(d)), np.ones(n, np.bool_) if i.is_pk_handle
        else tbl.columns[i.col_id].validity) for i, d in zip(infos, dtypes)]
    up = runner._build_flat(host, n)
    set_counts(saved)
    diff = sum(not same_bits(a, b) for a, b in zip(feed["flat"], up["flat"]))
    diff += int(feed["digests"] != up["digests"])
    print(f"check spill mint: {n} rows, {len(bundle.spill_patches)} spilled,"
          f" {patches} patch_rows launches: {diff} planes differ",
          flush=True)
    assert diff == 0 and patches > 0, "the spill mint disagrees"
    return diff


def cold_dag(config: str, table):
    """6c: GROUP BY c0: COUNT(*), SUM(c1) (bench.py:537-545); 4h: config
    4's GROUP BY k: COUNT(*), SUM(v)."""
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.testing.dag import DagSelect
    if config == "4h":
        return cf.dag_hash_agg(table)
    s = DagSelect.from_table(table, ["id", "c0", "c1"])
    return s.aggregate([s.col("c0")], [("count_star", None),
                                       ("sum", s.col("c1"))]).build()


def only_feed(runner, snap) -> tuple:
    feeds = runner.resident_feeds(snap)
    assert len(feeds) == 1, f"{len(feeds)} feeds"
    return next(iter(feeds.items()))


def feed_diff(a: dict, b: dict) -> int:
    """The planes (and the digest record) in which two feeds differ."""
    diff = sum(not same_bits(x, y) for x, y in zip(a["flat"], b["flat"]))
    diff += abs(len(a["flat"]) - len(b["flat"]))
    return diff + int([digest_err(x, 0) for x in a["digests"]] !=
                      [digest_err(x, 0) for x in b["digests"]])


def serve_cold(label, runner, dag, snap, agrees, expect_route) -> tuple:
    """A cold and five warm requests → (cold ms, warm ms list, the mint's
    phases); the feed must be built once, by ``expect_route``."""
    routes0 = dict(runner.feed_routes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = runner.handle_request(dag, snap).rows()
    cold = (time.perf_counter() - t0) * 1e3
    phases = dict(runner.mvcc_resolver().phases_ms)
    assert agrees(got), f"{label}: wrong answer on the cold request"
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = runner.handle_request(dag, snap).rows()
        warm.append((time.perf_counter() - t0) * 1e3)
        assert agrees(got), f"{label}: wrong answer when warm"
    routes = {k: v - routes0.get(k, 0) for k, v in runner.feed_routes.items()
              if v != routes0.get(k, 0)}
    assert routes == {expect_route: 1}, f"{label}: feed routes {routes}"
    return cold, warm, phases


# the routes of a cold request, in the order of each round: the second
# round reverses the first, so each route is timed at both ends
COLD_ROUNDS = (("device", "upload", "resident"),
               ("resident", "upload", "device"))


def run_cold(config: str, n_keys: int, runner) -> dict:
    """One cold-path configuration: its version history on the host, then
    rounds of three routes (6c two, 4h one), each route a fresh snapshot by
    ``build_region_columnar_device`` (its host mirror timed) serving cold
    + 5 warm requests: the device route (a feed minted by
    ``mvcc_resolve`` from planes uploaded at the mint), the upload route
    (``_build_flat`` of the mirror) and the resident route (the mint from
    ``DeviceVersionPlanes``).  Round 1's device route is the main path,
    counted, and its feed is scrubbed (clean, a patch and its undo kept
    by the digest rule, a corruption it must name); every other feed and
    the plain version must equal it bit for bit.  Then the kernels timed
    at this shape."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.region_cache import (MvccColumnarSnapshot,
                                                  build_region_columnar_device)
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.device import digest as dg
    from tikv_tpu_torch.device import mvcc as pm
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.testing import mvcc as tm
    dev = runner.device
    t0 = time.perf_counter()
    make = tm.history_6c if config == "6c" else tm.history_4h
    table, planes, th, truth, read_ts = make(n_keys)
    gen_s = time.perf_counter() - t0
    want, scales = cf.truth("4", tm.truth_table(table, th, truth,
                                                tm.ETS_INT))
    del th, truth
    dag = dag_from_wire(enc_dag(cold_dag(config, table)))
    infos = dag.executors[0].columns
    resolver = runner.mvcc_resolver()
    resident = {}

    def agrees(rows):
        return cf.rows_agree(rows, want, scales, SF_TOL)

    def serve(route: str) -> tuple:
        """A fresh snapshot for ``route`` and its cold + 5 warm requests
        → (snapshot, its feed, timings)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tbl, safe, bundle = build_region_columnar_device(
            planes, table, infos, read_ts, resolver,
            device_planes=resident.get("dvp") if route == "resident"
            else None)
        mirror_ms = (time.perf_counter() - t0) * 1e3
        if route == "upload":
            bundle.release()
            bundle = None
        snap = MvccColumnarSnapshot(tbl, read_ts, safe, bundle)
        cold, warm, phases = serve_cold(
            f"{config} {route}", runner, dag, snap, agrees,
            "upload" if route == "upload" else "device_resolve")
        row = {"host_mirror_ms": mirror_ms, "request_ms": cold,
               "cold_ms": mirror_ms + cold,
               "warm_p50_ms": float(np.percentile(warm, 50))}
        if route != "upload":
            assert (phases["h2d"] == 0.0) == (route == "resident"), \
                f"{config} {route}: planes H2D {phases['h2d']} ms"
            row.update(planes_h2d_ms=phases["h2d"],
                       resolve_ms=phases["resolve"],
                       patch_ms=phases["patch"],
                       digests_wait_ms=phases["digests"],
                       rest_ms=cold - sum(phases.values()))
        return snap, only_feed(runner, snap), row

    # the main path: counts from 0, read after the scrub
    set_counts({k: 0 for k in KERNELS})
    snap, (feed_key, feed), first = serve("device")
    n = feed["n_live"]
    assert runner.scrub_feed(feed) == [], f"{config}: scrub not clean"
    plane0 = feed["flat"][0]
    old = plane0[[0, n - 1]].clone()
    ends = [(0, 1), (n - 1, n)]
    patched = scrub_patch(runner, feed, ends, old + 1)
    assert runner.scrub_feed(feed) == [], f"{config}: patch broke a digest"
    patched += scrub_patch(runner, feed, ends, old)
    victim = len(feed["flat"]) - 1
    flips = dg.patch_launches
    runner.corrupt_resident_plane(feed, victim)
    named = runner.scrub_feed(feed)
    assert named == [victim], f"{config}: the scrub named {named}"
    runner.corrupt_resident_plane(feed, victim)      # flipped back
    assert dg.patch_launches - flips == 2, "a corruption is one launch"
    assert runner.scrub_feed(feed) == [], f"{config}: not restored"
    assert patched == 0, f"{config}: a scrub patch differs ({patched})"
    launches = counts()
    for name in ("mvcc_resolve", "plane_digest", "patch_rows",
                 "patch_spans"):
        assert launches[name] > 0, f"{config} never launched {name}"
    saved = counts()

    # the plain version on the same inputs
    col_ids, dtypes = feed_key[1], feed_key[2]
    used = [next(i for i in infos if i.col_id == c) for c in col_ids]
    has_nulls = {c: not bool(col.validity.all())
                 for c, col in snap._tbl.columns.items()}
    del snap
    args, _flags, _res = pm.resolve_inputs(planes, None, used, dtypes,
                                           has_nulls, dev)
    plain, pcount = pm.mvcc_resolve_plain(*args, read_ts, planes.n_keys,
                                          feed["n_pad"])
    diff = sum(not same_bits(a, b) for a, b in zip(plain, feed["flat"]))
    diff += int(int(pcount) != n)
    del plain, args

    rounds = []
    # 4h's second round (three routes over 100·2^20 keys, about 27 s) is
    # cut for the smoke's time limit; 6c's two rounds give the order's
    # spread
    orders = COLD_ROUNDS if config == "6c" else COLD_ROUNDS[:1]
    for order in orders:
        rows = {}
        for route in order:
            if route == "device" and not rounds:
                rows[route] = first
                continue
            if route == "resident" and "dvp" not in resident:
                # the planes resident before the query: chunks of ≤ 2^20
                # keys
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dvp = pm.DeviceVersionPlanes(dev)
                parts = tm.split_planes(planes, min(
                    CHUNK_KEYS, -(-planes.n_keys // 4)))
                for part in parts:
                    dvp.append(part)
                torch.cuda.synchronize()
                resident.update(dvp=dvp, chunks=len(parts), fill_ms=(
                    time.perf_counter() - t0) * 1e3)
                del dvp, parts
            other, (_k, other_feed), rows[route] = serve(route)
            diff += feed_diff(other_feed, feed)
            last = other                # ANALYZE reads the last one
            del other, other_feed
        rounds.append(rows)
    set_counts(saved)
    assert diff == 0, f"{config}: the minted feed differs ({diff})"
    timing = time_cold_kernels(config, planes, resident["dvp"], used, dtypes,
                               has_nulls, read_ts, n, feed, runner)
    routes = {}
    for route in COLD_ROUNDS[0]:
        runs = [r[route] for r in rounds]
        req = [r["request_ms"] for r in runs]
        routes[route] = {"runs": runs, "request_ms_spread":
                         max(req) - min(req)}
    routes["resident"].update(planes_fill_ms=resident["fill_ms"],
                              chunks=resident["chunks"])
    out = {"config": config, "keys": planes.n_keys, "versions": planes.n_ver,
           "rows": n, "generate_s": gen_s, "planes_bytes":
           tm.planes_nbytes(planes), "rounds": [list(o) for o in orders],
           "routes": routes, "launches": launches, "scrub_named": named,
           "timing": timing}
    print(f"cold config {config}: " + json.dumps(
        {k: v for k, v in out.items() if k != "timing"}), flush=True)
    if config == "6c":
        out["snapshot"] = last          # the cell an6c analyzes it
    del feed, resident, planes, last
    gc.collect()
    torch.cuda.empty_cache()
    return out


def scrub_patch(runner, feed: dict, spans, vals) -> int:
    """``runner._patch_plane(feed, spans, [vals], [0])`` (the patch that
    serves a write) against the plain version on a copy of the plane and
    its recorded digest: the plane bit for bit and R' → 0, or what
    differs; the patch must be one ``patch_feed_spans`` launch."""
    from tikv_tpu_torch.device import digest as dg
    plane = feed["flat"][0]
    twin = plane.clone()
    want = dg.patch_feed_spans_plain([twin], spans, [vals],
                                     [feed["digests"][0]])
    before = dg.span_launches
    runner._patch_plane(feed, spans, [vals], [0])
    assert dg.span_launches - before == 1, "_patch_plane is one launch"
    return int(not same_bits(plane, twin)) + digest_err(
        feed["digests"][0], want[0, 2])


def time_cold_kernels(config, planes, dvp, used, dtypes, has_nulls,
                      read_ts, n, feed, runner) -> dict:
    """mvcc_resolve on the resident planes of this shape, plane_digest on
    the feed's first plane and patch_rows on a copy of it (the two rows
    ``_patch_plane`` writes with digests, and 65,536 rows with and without
    digests; three planes of two rows in one ``patch_feed_rows`` launch,
    beside three one-plane calls; ``_patch_plane`` end to end): CUDA
    events, queued behind a device sleep, beside each bound, plain version
    and yardstick."""
    from tikv_tpu_torch.device import digest as dg
    from tikv_tpu_torch.device import mvcc as pm
    dev = runner.device
    saved = counts()
    args, _flags, resident = pm.resolve_inputs(planes, dvp, used, dtypes,
                                               has_nulls, dev)
    assert resident
    n_pad, K = feed["n_pad"], planes.n_keys
    spec = args[6]
    src_bytes = sum(args[4][s[1]].element_size() for s in spec
                    if s[0] != "h") + sum(8 for s in spec if s[0] == "h")
    out_bytes = sum(t.element_size() for t in feed["flat"])
    resolve_bytes = planes.n_ver * 9 + (K + 1) * 8 + n * src_bytes + \
        n_pad * out_bytes
    t = {"mvcc_resolve": {
        "ms": cuda_ms(lambda: pm.mvcc_resolve(*args, read_ts, K, n_pad), 10,
                      queued=True),
        "plain_ms": cuda_ms(lambda: pm.mvcc_resolve_plain(
            *args, read_ts, K, n_pad), 3),
        "library_ms": None, **bound_ms(resolve_bytes, 0),
        "versions": planes.n_ver, "keys": K, "rows": n, "n_pad": n_pad,
        "outputs": len(spec), "bytes": resolve_bytes,
        "peak_bytes": peak_bytes(lambda: pm.mvcc_resolve(*args, read_ts, K,
                                                         n_pad))}}
    del args
    p0 = feed["flat"][0]
    bits = dg._bits(p0[:n])
    w = 2 * torch.arange(n, dtype=torch.int64, device=dev) + 1
    t["plane_digest"] = {
        "ms": cuda_ms(lambda: dg.plane_digest(p0, 0, n), 50, queued=True),
        "plain_ms": cuda_ms(lambda: dg.plane_digest_plain(p0, 0, n), 5),
        "library_ms": None,
        "yardstick_ms": cuda_ms(lambda: (bits * w).sum(), 20),
        "yardstick": "(bits * (2i+1)).sum() in int64 on pre-widened bits",
        **bound_ms(n * p0.element_size(), 0), "rows": n,
        "dtype": str(p0.dtype)}
    del bits, w
    plane = p0.clone()
    pt = {}
    es = plane.element_size()
    for m, digest in ((2, True), (1 << 16, True), (1 << 16, False)):
        pos_d = torch.randperm(n, device=dev)[:m].sort().values
        pos = pos_d.cpu().numpy()
        vals = plane[pos_d].clone()
        case = {"ms": cuda_ms(lambda: dg.patch_rows(plane, pos, vals,
                                                    digest), 50,
                              queued=True),
                "plain_ms": cuda_ms(lambda: dg.patch_rows_plain(
                    plane, pos_d, vals, digest), 20),
                "library_ms": cuda_ms(lambda: plane.index_put_((pos_d,),
                                                               vals), 50),
                "library_call": "index_put_ (writes, no digests)",
                **bound_ms(m * (8 + 2 * es + (es if digest else 0)), 0),
                "rows": m, "digest": digest}
        pt[f"{m} rows{' with digests' if digest else ''}"] = case
    # three planes of a feed (int32, int64 and a bool validity plane), the
    # two rows _patch_plane writes, with digests: one launch, beside three
    # one-plane calls
    rows = min(n, 1 << 24)
    pos = np.array([0, rows - 1], np.int64)
    three = [plane, torch.zeros(rows, dtype=torch.int64, device=dev),
             torch.zeros(rows, dtype=torch.bool, device=dev)]
    v3 = [a[:2].clone() for a in three]
    recs = [0, 0, 0]
    w3 = sum(a.element_size() for a in three)
    pt["3 planes, 2 rows with digests"] = {
        "ms": cuda_ms(lambda: dg.patch_feed_rows(three, pos, v3, recs), 50,
                      queued=True),
        "three_calls_ms": cuda_ms(lambda: [dg.patch_rows(
            a, pos, v, True) for a, v in zip(three, v3)], 50, queued=True),
        "plain_ms": cuda_ms(lambda: dg.patch_feed_rows_plain(
            three, torch.from_numpy(pos).to(dev), v3, recs), 20),
        "library_ms": cuda_ms(lambda: [a.index_put_((
            torch.from_numpy(pos).to(dev),), v) for a, v in zip(three, v3)],
            20),
        "library_call": "index_put_ a plane (writes, no digests)",
        **bound_ms(2 * 8 + 2 * 3 * w3, 0), "rows": 2, "planes": 3,
        "digest": True}
    # _patch_plane end to end (the patch that serves a write): rows and the
    # recorded digest in one patch_feed_spans launch, two 1-row spans
    f = {"flat": (plane,), "digests": (feed["digests"][0],)}
    ends = plane[[0, n - 1]].clone()
    spans = [(0, 1), (n - 1, n)]
    pt["_patch_plane"] = {
        "ms": cuda_ms(lambda: runner._patch_plane(f, spans, [ends]),
                      50, queued=True),
        "issued_ms": cuda_ms(lambda: runner._patch_plane(
            f, spans, [ends]), 50),
        "rows": 2, **bound_ms(2 * 16 + 2 * 3 * es + 24, 0)}
    del three, v3
    t["patch_rows"] = dict(pt["2 rows with digests"], configs=pt)
    set_counts(saved)
    print(f"kernels at cold config {config} shape: " + json.dumps(t),
          flush=True)
    return t


# ---------------------------------------------------------------------------
# the plan IR: sort_perm, join_build, join_probe, window_scan
# ---------------------------------------------------------------------------

PLAN_ROWS = {"probe": 10 << 20, "build": 1 << 20}
# cell → the kernels its requests launch (and no other)
PLAN_ROUTE = {"7": {"join_build", "join_index", "join_probe", "sel_pred"},
              "7s": {"sort_perm"}, "7w": {"sort_perm", "window_scan"}}
I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)


def diff_count(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements that differ bit for bit (a float compares by its bits, so
    NaN equals NaN); a shape mismatch counts every element."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel(), 1)
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return int((a != b).sum())


def dictionary_diff(got, want) -> int:
    """Two ``join_build`` dictionaries: the elements of sk, perm and
    prefix that differ, plus 1 if their host ``BuildKeys`` differ."""
    return sum(diff_count(a, b) for a, b in zip(got[:3], want[:3])) + \
        int(tuple(got.keys) != tuple(want.keys))


def no_host_wait(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: raises
    if it makes torch wait for the card (a read back, a synchronizing
    op)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def check_sync_debug(dev) -> None:
    """The window ``no_host_wait`` opens does catch a wait: a read back of
    three numbers raises inside it."""
    x = torch.arange(8, device=dev)
    try:
        no_host_wait(lambda: torch.cat([x[-1:], x[:1]]).tolist())
    except RuntimeError:
        return
    raise AssertionError("set_sync_debug_mode('error') let a read back by")


def of_width(rng, n: int, bits: int, lo: int) -> np.ndarray:
    """int64 keys whose images span exactly ``bits`` bits from ``lo``."""
    span = (1 << bits) - 1
    k = lo + (rng.integers(0, 1 << 62, n) % (span + 1)).astype(np.int64)
    k[0], k[1 % n] = lo, lo + span
    return k


def sort_key_cases(rng, n: int, dev) -> dict:
    """Named key tensors of n rows on the card: int64 over the whole range
    with its extremes, int64 ties, float64 with ±0.0, ±inf and NaN, a byte
    key, a constant key, and int64 keys of exact widths ("w20": 20 bits),
    which pack into images of 31 to 65 bits."""
    wide = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
    wide[rng.random(n) < 0.05] = I64.min
    wide[rng.random(n) < 0.05] = I64.max
    wide[rng.random(n) < 0.02] = I64.min + 2
    f = rng.normal(0, 1e3, n)
    for val, share in ((0.0, 0.05), (-0.0, 0.05), (np.inf, 0.02),
                       (-np.inf, 0.02), (np.nan, 0.03), (-np.nan, 0.02)):
        f[rng.random(n) < share] = val
    keys = {"i64_wide": wide, "i64_ties": rng.integers(-3, 3, n),
            "f64": f, "const": np.full(n, 7, np.int64)}
    for bits in (11, 20, 21, 22, 32, 33):
        keys[f"w{bits}"] = of_width(rng, n, bits, -(1 << (bits - 1)))
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
           for k, v in keys.items()}
    out["byte"] = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    return out


def check_sort(dev) -> int:
    """sort_perm and join_build against their plain versions on the card,
    bit for bit: 1-8 keys over int64 extremes, ties, ±0.0 / ±inf / NaN,
    byte and constant keys, keys packing into 31, 32, 33, 64 and 65 bits,
    n = 1, 2, 2049, 4095-4097, 12,289 (last tiles of one row: the dynamic
    tile counter's last tile), 100,003 and 10·2^20 (7s's two int64 keys);
    join_build with NULL keys, duplicates, valid keys equal to the
    int64.max sentinel, rows past n_live and no valid row; its host
    ``BuildKeys`` (valid count, least and greatest valid key) equal to the
    plain version's."""
    from tikv_tpu_torch.device import sort as srt
    rng = np.random.default_rng(71)
    saved = counts()
    worst = 0
    combos = (("i64_wide",), ("f64",), ("byte",), ("const",),
              ("i64_ties", "f64"), ("byte", "i64_wide", "i64_ties"),
              ("f64", "i64_ties", "byte"), ("w20", "w11"), ("w21", "w11"),
              ("w22", "w11"), ("w32", "w32"), ("w33", "w32"),
              ("byte", "w20", "const", "i64_ties", "f64", "w11", "w33",
               "i64_wide"))
    sizes = (1, 2, srt.TILE64 + 1, srt.TILE32 - 1, srt.TILE32,
             srt.TILE32 + 1, 3 * srt.TILE32 + 1, 100_003)
    for n in sizes:
        keys = sort_key_cases(rng, n, dev)
        for combo in combos:
            ks = [keys[c] for c in combo]
            err = diff_count(srt.sort_perm(ks, n),
                             srt.sort_perm_plain(ks, n))
            torch.cuda.synchronize()
            assert err == 0, f"sort_perm {combo} n={n}: {err} rows differ"
    bits = {"+".join(c): [g[2] for g in srt.pack_groups(
        [srt.key_width(int(i.min()), int(i.max())) for i in
         (srt.order_image(keys[k]) for k in c)])] for c in combos}
    print(f"kernel sort_perm: {len(combos)} key combinations x n in "
          f"{sizes}: max_abs_err=0 tolerance=0 (permutations); packed "
          f"images' bits at n={sizes[-1]}: {json.dumps(bits)}", flush=True)
    n = PLAN_ROWS["probe"]
    ks = [torch.from_numpy(-rng.integers(0, PLAN_ROWS["build"], n)).to(dev),
          torch.from_numpy(rng.integers(-1000, 1000, n)).to(dev)]
    err = diff_count(srt.sort_perm(ks, n), srt.sort_perm_plain(ks, n))
    assert err == 0, f"sort_perm at 7s's shape: {err} rows differ"
    print(f"kernel sort_perm at 7s's shape ({n} rows, two int64 keys): "
          f"max_abs_err={err}", flush=True)
    del ks
    for n, live, dup in ((1, 1, 1), (5, 3, 2), (4097, 4000, 7),
                         (100_003, 100_003, 1000), (1 << 20, 1 << 20, 0),
                         (9, 0, 3)):
        keys = np.arange(n, dtype=np.int64) if dup == 0 else \
            rng.integers(-dup, dup, n)
        valid = np.ones(n, np.bool_) if dup == 0 else rng.random(n) > 0.2
        if dup:
            keys[rng.random(n) < 0.1] = I64.max     # sentinel collisions
            keys[rng.random(n) < 0.05] = I64.min
        kt = torch.from_numpy(keys).to(dev)
        vt = torch.from_numpy(valid).to(dev)
        got = srt.join_build(kt, vt, live)
        want = srt.join_build_plain(kt, vt, live)
        torch.cuda.synchronize()
        err = dictionary_diff(got, want)
        assert err == 0, f"join_build n={n} live={live}: {err} differ"
        worst = max(worst, err)
        print(f"kernel join_build n={n} n_live={live}: max_abs_err={err} "
              f"tolerance=0 (sk, perm, prefix; keys {tuple(got.keys)})",
              flush=True)
    set_counts(saved)
    return worst


def join_index_cases(rng) -> list:
    """The direct index's edge cases → (label, build keys, build validity,
    probe keys, capacities, whether the build takes the index)."""
    def span_keys(nv, span):
        inner = rng.choice(np.arange(1, span - 1), nv - 2, replace=False)
        return rng.permutation(np.concatenate([[0, span - 1], inner]))

    npr = 100_003
    out = []
    for label, bk, pk, caps, dense in (
            ("dense", rng.permutation(50_000),
             rng.integers(-100, 50_100, npr), (1 << 17, 12_345), True),
            ("dense with gaps", rng.permutation(
                rng.choice(75_000, 50_000, replace=False)),
             rng.integers(-100, 75_100, npr), (1 << 17, 20_001), True),
            ("duplicates", rng.integers(0, 10_000, 50_000),
             rng.integers(0, 10_500, npr), (1 << 20, 99_999), True),
            ("negative least key", rng.permutation(50_000) - 25_000,
             rng.integers(-25_100, 25_100, npr), (1 << 17,), True),
            ("int64.min", I64.min + rng.permutation(5000),
             np.concatenate([[I64.max, I64.max - 1, 0, -1, I64.min],
                             I64.min + rng.integers(0, 6000, npr - 5)]),
             (1 << 17,), True),
            ("int64.max - 1", I64.max - 1 - rng.permutation(5000),
             np.concatenate([[I64.min, I64.min + 1, 0, -1, I64.max],
                             I64.max - rng.integers(0, 6000, npr - 5)]),
             (1 << 17,), True),
            ("a valid int64.max build key",
             np.concatenate([[I64.max] * 3, rng.permutation(5000)]),
             np.concatenate([[I64.max] * 40, rng.integers(0, 5100,
                                                          npr - 40)]),
             (1 << 17,), False),
            ("span at the threshold", span_keys(1000, 2 * 1000 + 1024),
             rng.integers(-5, 3030, npr), (1 << 17,), True),
            ("span one past it", span_keys(1000, 2 * 1000 + 1025),
             rng.integers(-5, 3030, npr), (1 << 17,), False),
            ("one hot build key", np.concatenate(
                [np.full(5000, 7), rng.permutation(100)]),
             rng.integers(0, 120, npr), (1 << 22, 777_777), True),
            ("one row", np.asarray([3]), np.asarray([3]), (1, 64), True),
            ("no valid key", rng.permutation(5000),
             rng.integers(0, 5100, npr), (1 << 17,), False)):
        bk = np.asarray(bk, np.int64)
        bvalid = rng.random(len(bk)) > 0.1
        bvalid[:1] = True
        if label.startswith("span") or label == "one row":
            bvalid[:] = True        # the span counts valid keys only
        if label == "no valid key":
            bvalid[:] = False
        out.append((label, bk, bvalid, np.asarray(pk, np.int64), caps,
                    dense))
    return out


def check_join(dev) -> int:
    """join_probe against its plain version on the card, bit for bit
    (pairs and total), on both routes: duplicate build keys, NULL keys on
    both sides, the sentinel key, with and without a mask, a capacity
    above the total and one below it (the exact total beside the pairs
    that fit, the cut inside a tile); the direct index (``join_index``)
    against its plain version and the dense route over its edge cases
    (``join_index_cases``: gaps, duplicates, a negative least key, keys at
    int64.min and int64.max − 1, a valid int64.max key and a span one past
    the threshold, which must take the sparse route, a span at it, one
    hot build key, no valid key), ``join_index`` fed the host
    ``BuildKeys`` that ``join_build`` read in its one wait, each call
    under ``no_host_wait`` (the index waits for nothing); then the
    joiner's re-dispatch on an overflow (``check_join_redispatch``)."""
    from tikv_tpu_torch.device import join_probe as jp
    from tikv_tpu_torch.device import sort as srt
    rng = np.random.default_rng(72)
    saved = counts()
    cases = []
    for npr, nb, dom, caps in ((1, 1, 1, (64,)), (5000, 300, 50, (1, 64)),
                               (100_003, 4097, 2000, (1 << 17, 1 << 12)),
                               (1 << 20, 1 << 16, 1 << 16, (1 << 21,))):
        bk = rng.integers(0, dom, nb)
        bk[rng.random(nb) < 0.05] = I64.max
        pk = rng.integers(0, dom, npr)
        pk[rng.random(npr) < 0.01] = I64.max
        cases.append((f"{npr}x{nb}", bk, rng.random(nb) > 0.1, pk, caps,
                      None))
    cases += join_index_cases(rng)
    check_sync_debug(dev)
    for label, bk, bvalid, pk, caps, dense in cases:
        npr, nb = len(pk), len(bk)
        pvalid = torch.from_numpy(rng.random(npr) > 0.1).to(dev)
        mask = torch.from_numpy(rng.random(npr) > 0.5).to(dev)
        built = srt.join_build(torch.from_numpy(bk).to(dev),
                               torch.from_numpy(bvalid).to(dev), nb)
        assert tuple(built.keys) == srt.build_keys_plain(
            built.sk, built.prefix), f"join_build {label}: {built.keys}"
        index = no_host_wait(lambda: jp.join_index(built.sk, built.prefix,
                                                   built.keys))
        want_index = jp.join_index_plain(built.sk, built.prefix)
        err = int((index is None) != (want_index is None))
        if index is not None and want_index is not None:
            err += int(index[1:] != want_index[1:]) + \
                diff_count(index.off, want_index.off)
        assert err == 0, f"join_index {label}: {err}"
        route = "sparse" if index is None else "dense"
        assert dense is None or dense == (index is not None), \
            f"join_index {label}: the {route} route"
        pkt = torch.from_numpy(pk).to(dev)
        for cap in caps:
            for pv, m in ((pvalid, mask), (None, None)):
                want = jp.join_probe_plain(*built[:3], pkt, pv, m, cap)
                for idx in ((index, None) if index is not None
                            else (None,)):
                    got = jp.join_probe(*built[:3], pkt, pv, m, cap, idx)
                    torch.cuda.synchronize()
                    err = diff_count(got[0], want[0]) + \
                        diff_count(got[1], want[1])
                    assert err == 0, f"join_probe {label} cap={cap}: {err}"
                print(f"kernel join_probe {label} ({npr}x{nb}) k_cap={cap} "
                      f"total={int(want[1])} mask={m is not None} "
                      f"routes={'dense+sparse' if index is not None else route}"
                      f": max_abs_err=0 tolerance=0", flush=True)
    worst = check_join_redispatch(dev)
    set_counts(saved)
    return worst


def check_join_redispatch(dev) -> int:
    """``DeviceJoiner.join`` on the card over four keys on both sides:
    20,000 probe rows × 16 build rows a key overflow the first capacity
    (next_pow2(20,000·1.5 + 64) = 32,768 slots for 320,000-odd pairs); the
    exact total re-dispatches once, and the pairs equal a numpy truth."""
    from tikv_tpu_torch.device.runner import DeviceRunner
    from tikv_tpu_torch.testing import configs as cf
    rng = np.random.default_rng(74)
    pt, psnap, bt, bsnap = cf.build_join_pair(20_000, 64)
    k = rng.integers(0, 4, 20_000)
    bk = np.repeat(np.arange(4), 16)
    rng.shuffle(bk)
    psnap.columns[2].values[:] = k
    bsnap.columns[2].values[:] = bk
    joiner = DeviceRunner(device=dev).joiner()
    probe, build = cf.scan_node(pt), cf.scan_node(bt)
    got = joiner.join(probe.scan, probe.ranges, psnap, (), 1, build.scan,
                      build.ranges, bsnap, 1)
    # truth: probe rows in order, each with its key's build rows in order
    by_key = [np.flatnonzero(bk == key) for key in range(4)]
    want_p = np.repeat(np.arange(20_000), [len(by_key[x]) for x in k])
    want_b = np.concatenate([by_key[x] for x in k])
    assert joiner.overflow_redispatches == 1, joiner.stats()
    err = int((got[0] != want_p).sum() + (got[1] != want_b).sum()) \
        if got[0].shape == want_p.shape else len(want_p)
    assert err == 0, f"DeviceJoiner.join re-dispatch: {err} pairs differ"
    print(f"kernel join_probe through DeviceJoiner.join: {len(want_p)} "
          f"pairs past k_cap=32768, overflow_redispatches="
          f"{joiner.overflow_redispatches}: max_abs_err={err} tolerance=0",
          flush=True)
    return err


def check_window(dev) -> int:
    """window_scan against its plain version on the card, bit for bit:
    int64 and float64 (NaN, ±0.0) partition keys, none, one partition over
    every row (the longest look-back chain), a partition on each row,
    counts, int64 sums with NULLs, LAG / LEAD of int64 and float64 over
    offsets 1, 2 and 5 (the kernel's halo) and ±100 and ±5000 (past
    ``window.CAP``: its second pass), n = 1, the tile's rows -1, 0 and +1,
    1023-1025, 100,003 and 10·2^20."""
    from tikv_tpu_torch.device import sort as srt
    from tikv_tpu_torch.device import window as win
    rng = np.random.default_rng(73)
    saved = counts()
    sizes = (1, 1023, 1024, 1025, win.TILE - 1, win.TILE, win.TILE + 1,
             100_003, PLAN_ROWS["probe"])
    for n in sizes:
        k = torch.from_numpy(rng.integers(0, max(1, n // 20), n)).to(dev)
        f = rng.normal(0, 1, n).round(1)
        f[rng.random(n) < 0.05] = np.nan
        f[rng.random(n) < 0.05] = -0.0
        fk = torch.from_numpy(f).to(dev)
        one = torch.zeros(n, dtype=torch.int64, device=dev)
        each = torch.from_numpy(rng.permutation(n)).to(dev)
        v = torch.from_numpy(rng.integers(-1000, 1000, n)).to(dev)
        ok = torch.from_numpy(rng.random(n) > 0.2).to(dev)
        fv = torch.from_numpy(rng.normal(0, 1, n)).to(dev)
        for parts in ([k], [k, fk], [fk], [], [one], [each]):
            perm = srt.sort_perm(parts + [v], n)
            chans = [("count", None, ok), ("sum", v, ok),
                     ("count", None, ok)]
            shifts = [(-2, v, ok), (1, v, ok), (-1, fv, ok), (5, fv, ok),
                      (-100, v, ok), (100, fv, ok), (-5000, fv, ok),
                      (5000, v, ok)]
            got = win.window_scan(perm, parts, True, chans, shifts)
            want = win.window_scan_plain(perm, parts, True, chans, shifts)
            torch.cuda.synchronize()
            err = diff_count(got[0], want[0]) + sum(
                diff_count(a, b) for a, b in zip(got[1], want[1])) + sum(
                diff_count(a, b) + diff_count(c, d)
                for (a, c), (b, d) in zip(got[2], want[2]))
            assert err == 0, f"window_scan n={n} parts={len(parts)}: {err}"
        print(f"kernel window_scan n={n}: 6 partitionings (one over every "
              f"row, one a row), 3 channels, 8 shifts (4 past the halo): "
              f"max_abs_err=0 tolerance=0", flush=True)
        del k, fk, one, each, v, ok, fv
    set_counts(saved)
    return 0


def plan_endpoint(runner):
    """An endpoint over config 7's snapshots (full size), and them."""
    from tikv_tpu_torch.copr.endpoint import Endpoint
    from tikv_tpu_torch.testing import configs as cf
    pair = cf.build_join_pair(PLAN_ROWS["probe"], PLAN_ROWS["build"])
    by = {pair[0].table_id: pair[1], pair[2].table_id: pair[3]}
    ep = Endpoint(lambda req: by[req.dag.executors[0].table_id], runner)
    return ep, pair


def run_plan(cell: str, ep, pair) -> dict:
    """Cell ``cell`` through ``Endpoint.handle_plan(force_backend=
    "device")``, its request wire-encoded first: one cold and five warm
    requests, each answer against the numpy truth; the kernels of its
    route must launch and no other; no degrade; config 7 must join on the
    device and build its dictionary once."""
    from tikv_tpu_torch.convert import plan_from_wire
    from tikv_tpu_torch.copr.wire import enc_plan
    from tikv_tpu_torch.testing import configs as cf
    probe_t, probe, build_t, build = pair
    preq = plan_from_wire(enc_plan(cf.PLAN_CELLS[cell](probe_t, build_t)))
    t0 = time.perf_counter()
    want = cf.plan_truth(cell, probe, build)
    truth_s = time.perf_counter() - t0
    ex = ep.plan_executor
    joiner = ep._device_runner.joiner()
    jb0 = dict(ex.join_backends)
    hits0 = joiner.build_cache_hits
    routes0 = joiner.probe_routes.get("dense", 0)
    set_counts({k: 0 for k in KERNELS})
    times, phases = [], []
    for _ in range(6):
        t0 = time.perf_counter()
        got = ep.handle_plan(preq, force_backend="device").result.batch
        times.append(time.perf_counter() - t0)
        assert cf.columns_agree(got, want), \
            f"cell {cell}: wrong answer (request {len(times)})"
        phases.append({**{f"plan.{k}": v for k, v in ex.phases_ms.items()},
                       **{f"device.{k}": v
                          for k, v in joiner.phases_ms.items()}})
    launches = counts()
    for name in KERNELS:
        if name in PLAN_ROUTE[cell]:
            assert launches[name] > 0, f"cell {cell} never launched {name}"
        else:
            assert launches[name] == 0, f"cell {cell} launched {name}"
    assert not ep.degrades, f"cell {cell}: degrades {ep.degrades}"
    if cell == "7":
        jb = {k: v - jb0.get(k, 0) for k, v in ex.join_backends.items()}
        assert jb.get("device", 0) >= 1 and set(jb) == {"device"}, jb
        assert launches["join_build"] == 1 and \
            launches["join_index"] == 1 and \
            launches["join_probe"] == 6, launches
        assert joiner.build_cache_hits - hits0 == 5
        # config 7's build keys are 0..2^20 - 1: the direct index serves
        assert joiner.probe_routes.get("dense", 0) - routes0 == 6, \
            joiner.probe_routes
    else:
        assert launches["sort_perm"] == 6, launches
    out = {"config": cell, "rows": PLAN_ROWS["probe"],
           "build_rows": PLAN_ROWS["build"] if cell == "7" else 0,
           "out_rows": got.num_rows, "cold_ms": times[0] * 1e3,
           "warm_p50_ms": float(np.percentile(times[1:], 50)) * 1e3,
           "launches": launches, "truth_s": truth_s,
           "cold_phases_ms": phases[0],
           "warm_phases_ms": {k: float(np.median([p.get(k, 0.0)
                                                  for p in phases[1:]]))
                              for k in phases[-1]},
           "degrades": dict(ep.degrades)}
    # a warm request under the profiler (join_build is cached by then)
    out["profile"] = profile_request(
        cell, None, None, None, PLAN_ROUTE[cell] & set(SYMBOLS),
        call=lambda: ep.handle_plan(preq, force_backend="device"))
    print(f"cell {cell}: " + " ".join(
        f"{k}={json.dumps(v) if isinstance(v, dict) else v}"
        for k, v in out.items() if k != "config"), flush=True)
    return out


def index_launch(jp, index, sk, n_valid: int) -> None:
    """The index kernel alone over the dictionary ``sk`` (``n_valid``
    valid keys) into ``index.off`` (what ``join_index`` launches, with no
    wrapper around it)."""
    lib = jp._kernel_lib()
    p = jp._IndexParams(sk=sk.data_ptr(), n_valid=n_valid,
                        key_lo=index.lo, span=index.span,
                        off=index.off.data_ptr())
    at = jp._where(sk.device)
    assert lib.join_index_launch(at[0], ctypes.byref(p), at[1]) == 0


def plan_kernels_at_main_shapes(pair, dev) -> tuple:
    """The five kernels at config 7's / 7s's / 7w's shapes: checked
    against their plain versions there (bit for bit) and timed with CUDA
    events (the probe, the window and ``join_index`` queued behind a
    device sleep, ``join_index`` also as issued; the sorts as issued,
    since they read back from the card), beside each bound (inputs read
    once, outputs written once at
    3.35 TB/s), plain version and library yardstick (composed
    torch.argsort(stable=True) for the sorts; torch.searchsorted for the
    index and, left and right, for the probe's runs; none computes the
    window).  ``join_probe`` on both routes: the dense build (its direct
    index) and the same keys spread by 2^20 (sparse)."""
    from tikv_tpu_torch.device import join_probe as jp
    from tikv_tpu_torch.device import sort as srt
    from tikv_tpu_torch.device import window as win
    probe_t, probe, build_t, build = pair
    saved = counts()
    n, nb = len(probe), len(build)
    k = torch.from_numpy(probe.columns[2].values).to(dev)
    v = torch.from_numpy(probe.columns[3].values).to(dev)
    bk = torch.from_numpy(build.columns[2].values).to(dev)
    bvalid = torch.ones(nb, dtype=torch.bool, device=dev)
    t, errs = {}, {}

    def argsorts(keys):
        p = torch.arange(keys[0].shape[0], device=dev)
        for key in reversed(keys):
            p = p[torch.argsort(key[p], stable=True)]
        return p

    built = srt.join_build(bk, bvalid, nb)
    errs["join_build"] = dictionary_diff(
        built, srt.join_build_plain(bk, bvalid, nb))
    nsv = torch.zeros(nb, dtype=torch.int64, device=dev)
    t["join_build"] = {
        "ms": cuda_ms(lambda: srt.join_build(bk, bvalid, nb), 20),
        "plain_ms": cuda_ms(lambda: srt.join_build_plain(bk, bvalid, nb), 5),
        "library_ms": cuda_ms(lambda: argsorts([bk, nsv]), 5),
        "library_call": "torch.argsort(stable=True) composed over (key, "
                        "not valid)",
        **bound_ms(nb * (8 + 1 + 8 + 4 + 8) + 8, 0), "rows": nb}
    mask = v > 0
    k_cap = 1 << (int(n * 1.5 + 64) - 1).bit_length()
    sk, perm, prefix, bkeys = built
    index = no_host_wait(lambda: jp.join_index(sk, prefix, bkeys))
    want_index = jp.join_index_plain(sk, prefix)
    assert index is not None, "config 7's build must take the direct index"
    errs["join_index"] = diff_count(index.off, want_index.off) + int(
        index[1:] != want_index[1:])
    t["join_index"] = {
        "ms": cuda_ms(lambda: jp.join_index(sk, prefix, bkeys), 50,
                      queued=True),
        "issued_ms": cuda_ms(lambda: jp.join_index(sk, prefix, bkeys), 50),
        "kernel_ms": cuda_ms(lambda: index_launch(jp, index, sk, nb), 50,
                             queued=True),
        "plain_ms": cuda_ms(lambda: jp.join_index_plain(sk, prefix), 5),
        "library_ms": cuda_ms(lambda: torch.searchsorted(
            sk, torch.arange(index.span + 1, device=dev) + index.lo), 5),
        "library_call": "torch.searchsorted of every key of the span, "
                        "as issued",
        # sk read once, 4 B an entry written
        **bound_ms(nb * 8 + (index.span + 1) * 4, 0),
        "rows": nb, "span": index.span,
        "timed": "ms: the wrapper, queued; issued_ms: the wrapper as "
                 "issued (no read back: its keys come from join_build's "
                 "one wait), beside library_ms; kernel_ms: the kernel "
                 "alone, queued"}
    print(f"join_index at config 7: as issued {t['join_index']['issued_ms']}"
          f" ms, torch.searchsorted of the span as issued "
          f"{t['join_index']['library_ms']} ms, queued "
          f"{t['join_index']['ms']} ms", flush=True)
    del want_index
    want = jp.join_probe_plain(sk, perm, prefix, k, None, mask, k_cap)
    total = int(want[1])
    # the function's bytes: probe keys and mask read once, the dictionary
    # once, each pair slot up to k_cap written once (the pairs, then the
    # -1 fill), the total; the count without the fill is printed beside
    old_bytes = n * (8 + 1) + nb * (8 + 4 + 8) + 8 + 8 * total + 8
    new_bytes = old_bytes + 8 * (k_cap - total)
    routes, errs["join_probe"] = {}, 0
    for route, keys_of in (("dense", lambda x: x), ("sparse",
                                                    lambda x: x << 20)):
        kr, bkr = keys_of(k), keys_of(bk)
        built_r = built if route == "dense" else \
            srt.join_build(bkr, bvalid, nb)
        idx = jp.join_index(built_r.sk, built_r.prefix,
                            built_r.keys)
        assert (idx is not None) == (route == "dense"), route
        got = jp.join_probe(*built_r[:3], kr, None, mask, k_cap, idx)
        errs["join_probe"] += diff_count(got[0], want[0]) + \
            diff_count(got[1], want[1])
        del got
        routes[route] = {
            "ms": cuda_ms(lambda: jp.join_probe(*built_r[:3], kr, None,
                                                mask, k_cap, idx), 10,
                          queued=True),
            "library_ms": cuda_ms(lambda: (
                torch.searchsorted(built_r.sk, kr, right=False),
                torch.searchsorted(built_r.sk, kr, right=True)), 5),
            "library_call": "torch.searchsorted left and right of the "
                            "route's probe keys into its sk (the runs, "
                            "not the pairs)",
            "build_keys": "0..2^20-1" if route == "dense"
            else "(0..2^20-1) << 20, probe keys likewise"}
        print(f"join_probe at config 7: route {route}, "
              f"{routes[route]['ms']} ms, searchsorted left + right "
              f"{routes[route]['library_ms']} ms", flush=True)
        del built_r, kr, bkr
    del want
    t["join_probe"] = {
        "ms": routes["dense"]["ms"],
        "plain_ms": cuda_ms(lambda: jp.join_probe_plain(
            sk, perm, prefix, k, None, mask, k_cap), 3),
        "library_ms": cuda_ms(lambda: (
            torch.searchsorted(sk, k, right=False),
            torch.searchsorted(sk, k, right=True)), 5),
        "library_call": "torch.searchsorted left and right of the probe "
                        "keys into sk: a yardstick that computes the runs, "
                        "not the pairs",
        **bound_ms(new_bytes, 0),
        "bound_ms_without_fill": bound_ms(old_bytes, 0)["bound_ms"],
        "routes": routes, "rows": n, "build_rows": nb, "pairs": total,
        "k_cap": k_cap}
    print(f"join_probe bound at config 7: {t['join_probe']['bound_ms']} ms "
          f"with the -1 fill up to k_cap ({new_bytes} B), "
          f"{t['join_probe']['bound_ms_without_fill']} ms without it "
          f"({old_bytes} B)", flush=True)
    del built, mask
    keys = [-k, v]
    errs["sort_perm"] = diff_count(srt.sort_perm(keys, n),
                                   srt.sort_perm_plain(keys, n))
    # the kernel's one packed image, built outside the timing
    images = [srt.order_image(key) for key in keys]
    los = [int(i.min()) for i in images]
    groups = srt.pack_groups([srt.key_width(lo, int(i.max()))
                              for lo, i in zip(los, images)])
    assert len(groups) == 1, groups
    packed = srt.packed_image(images, los, groups[0])
    del images
    errs["sort_perm"] += diff_count(
        torch.argsort(packed, stable=True).to(torch.int32),
        srt.sort_perm_plain(keys, n))
    t["sort_perm"] = {
        "ms": cuda_ms(lambda: srt.sort_perm(keys, n), 10),
        "plain_ms": cuda_ms(lambda: srt.sort_perm_plain(keys, n), 3),
        "library_ms": cuda_ms(lambda: argsorts(keys), 3),
        "library_call": "torch.argsort(stable=True) composed over the keys",
        "packed_argsort_ms": cuda_ms(
            lambda: torch.argsort(packed, stable=True), 3),
        "packed_bits": groups[0][2],
        **bound_ms(n * (8 + 8 + 4), 0), "rows": n, "keys": 2}
    del packed
    perm = srt.sort_perm([k, v], n)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    # 7w's launch: count(v), sum(v) and avg(v) share two channels
    chans = [("count", None, ok), ("sum", v, ok)]
    shifts = [(-2, v, ok), (1, v, ok)]
    got = win.window_scan(perm, [k], True, chans, shifts)
    want = win.window_scan_plain(perm, [k], True, chans, shifts)
    errs["window_scan"] = diff_count(got[0], want[0]) + sum(
        diff_count(a, b) for a, b in zip(got[1], want[1])) + sum(
        diff_count(a, b) + diff_count(c, d)
        for (a, c), (b, d) in zip(got[2], want[2]))
    del got, want
    t["window_scan"] = {
        "ms": cuda_ms(lambda: win.window_scan(perm, [k], True, chans,
                                              shifts), 10, queued=True),
        "plain_ms": cuda_ms(lambda: win.window_scan_plain(
            perm, [k], True, chans, shifts), 3),
        "library_ms": None,
        # reads: perm, k, v, ok once; writes: rn, 2 channels, 2 shifts
        **bound_ms(n * (4 + 8 + 8 + 1) + n * (8 + 2 * 8 + 2 * 9), 0),
        "rows": n, "channels": len(chans), "shifts": len(shifts)}
    set_counts(saved)
    for name, e in errs.items():
        assert e == 0, f"{name} disagrees with its plain version at its " \
            f"main shape: {e}"
    print("plan kernels at main shapes: " + json.dumps(t), flush=True)
    return errs, t


# ---------------------------------------------------------------------------
# ANALYZE and CHECKSUM: analyze_column, the cells an4, an4n, an4s, an4r, an6c
# ---------------------------------------------------------------------------

# cell → rows of its table (an6c: config 6c's cold snapshot, COLD_SIZES)
ANALYZE_ROWS = {"an4": 100 << 20, "an4n": 100 << 20, "an4s": 1 << 24,
                "an4r": 1 << 24}
# n around the pass tiles (2048 rows of 64-bit keys, 4096 of 32-bit ones)
ANALYZE_SIZES = (1, 2, 2047, 2048, 2049, 4095, 4096, 4097, 12_289, 100_003,
                 1 << 20)
CHECKSUM_ROWS = 1 << 16


def analyze_cases(dev):
    """(label, values, validity, n, buckets) on the card: each device dtype
    over the CPU tests' edge cases (NULLs, NaN, −NaN, ±0.0, ±inf, the
    dtype's max, all NULL, one valid row, five, one bucket, one row, ties,
    padding marked valid); each dtype at n around the pass tiles (random
    values, NULLs on 20%); then over 2^20 rows: float64 with NaN, −NaN,
    ±0.0 and ±inf on 5% each, int64 over its whole range with NULLs (the
    NULL key all ones), int64 keys of exactly 32 and 33 bits, one value on
    every row, uint64 at and past 2^63, and 2^22 rows with 256 buckets;
    then the routes' own cases over 2^20 rows: one value on 90% of the
    rows and random int32 values on the rest, an4s's shape (1024 values
    over 62 bits), an4r's (normal float64), int64 keys spanning the
    counting route's limit and one past it, a column whose first bucket
    passes its shared hash table (``configs.analyze_oversized_case``) and
    ascending ids (the unstaged scatter of sorted rows)."""
    from tikv_tpu_torch.device import analyze as an
    from tikv_tpu_torch.testing import configs as cf

    def up(v, ok, n, b):
        return (torch.from_numpy(np.ascontiguousarray(v)).to(dev),
                torch.from_numpy(np.ascontiguousarray(ok)).to(dev), n, b)

    for kind in cf.ANALYZE_KINDS:
        for case in cf.ANALYZE_EDGE_CASES:
            yield (f"{kind}/{case}",
                   *up(*cf.analyze_edge_case(kind, case)))
        for rows in ANALYZE_SIZES:
            v, ok, _n, b = cf.analyze_edge_case(kind, "random", rows)
            yield f"{kind}/n={rows}", *up(v, ok, rows, b)
    rng = np.random.default_rng(104)
    m = 1 << 20
    f = rng.normal(0, 1e3, m)
    for val in (np.nan, np.copysign(np.nan, -1), 0.0, -0.0, np.inf,
                -np.inf):
        f[rng.random(m) < 0.05] = val
    yield "float64/specials/2^20", *up(f, rng.random(m) > 0.1, m, 256)
    wide = rng.integers(I64.min, I64.max, m, dtype=np.int64, endpoint=True)
    wide[:2] = (I64.min, I64.max)
    ok = rng.random(m) > 0.1
    ok[:2] = True
    yield "int64/full span/2^20", *up(wide, ok, m, 256)
    for bits, span in ((32, (1 << 32) - 2), (33, (1 << 32) - 1)):
        k = -77 + rng.integers(0, span + 1, m)
        k[:2] = (-77, -77 + span)
        yield f"int64/{bits}-bit keys/2^20", *up(k, np.ones(m, np.bool_),
                                                 m, 256)
    yield "int32/one value/2^20", *up(np.full(m, 5, np.int32),
                                      np.ones(m, np.bool_), m, 256)
    u = rng.integers(0, 1 << 63, m, dtype=np.uint64)
    u[rng.random(m) < 0.5] |= np.uint64(1 << 63)
    yield "uint64/past 2^63/2^20", *up(u, rng.random(m) > 0.1, m, 256)
    m = 1 << 22
    yield "int32/2^22", *up(rng.integers(-(1 << 31), 1 << 31, m,
                                         dtype=np.int32),
                            rng.random(m) > 0.1, m - 5, 256)
    m = 1 << 20
    heavy = rng.integers(I32.min, I32.max, m, dtype=np.int32, endpoint=True)
    heavy[rng.random(m) < 0.9] = 5
    yield "int32/one value on 90%/2^20", *up(heavy, rng.random(m) > 0.05, m,
                                            256)
    _t, s4s = cf.build_sparse_table(m)
    yield "int64/an4s shape/2^20", *up(s4s.columns[2].values,
                                       np.ones(m, np.bool_), m, 256)
    yield "float64/an4r shape/2^20", *up(rng.normal(0.0, 1000.0, m),
                                         rng.random(m) > 0.05, m, 256)
    for extra, what in ((0, "at"), (1, "past")):
        span = an.COUNT_SPAN + extra
        k = -(1 << 40) + rng.integers(0, span, m)
        k[:2] = (-(1 << 40), -(1 << 40) + span - 1)
        yield f"int64/span {what} the counting limit/2^20", *up(
            k, np.ones(m, np.bool_), m, 256)
    yield "int32/oversized bucket/2^20", *up(*cf.analyze_oversized_case(m))
    yield "int32/ascending ids/2^20", *up(np.arange(m, dtype=np.int32),
                                          rng.random(m) > 0.05, m, 256)


def check_analyze(dev) -> float:
    """analyze_column against its plain version on the card over
    ``analyze_cases``: every rank word, n_valid and the distinct count bit
    for bit, the bound of every bucket the unpacking keeps by value
    (``analyze.packed_max_diff``; tolerance 0).  Each case's route is run
    again through ``ColumnLaunch``: on the partition route its distinct
    splitters, sorted buckets and oversized buckets must equal the numpy
    model's (``analyze.route_model``); the counting route, the partition
    route and its oversized buckets must each be taken."""
    from tikv_tpu_torch.device import analyze as an
    saved = counts()
    worst, n_cases, bits, routes = 0.0, 0, {}, {}
    for label, v, ok, n, b in analyze_cases(dev):
        got = an.analyze_column(v, ok, n, b)
        want = an.analyze_column_plain(v, ok, n, b)
        torch.cuda.synchronize()
        err = an.packed_max_diff(got, want, b, v.dtype == torch.float64)
        assert err == 0, f"analyze {label}: differs by {err}"
        worst = max(worst, err)
        n_cases += 1
        col = an.ColumnLaunch(v, ok, n, b)
        col.range()
        plan = col.read_range()
        col.run()
        assert torch.equal(col.out, got), f"analyze {label}: reruns differ"
        route = plan.route
        if route == "partition":
            st = col.partition_stats()
            _m, info = an.route_model(v.cpu().numpy(), ok.cpu().numpy(), n,
                                      b)
            model = {k: info[k] for k in st}
            assert st == model, f"analyze {label}: {st} != model {model}"
            if st["oversized"]:
                route = "partition+oversized"
        routes[route] = routes.get(route, 0) + 1
        if "2^2" in label:
            bits[label] = an.key_plan(v, ok, n)[3]
            print(f"kernel analyze {label}: route={route} "
                  f"n_split={plan.n_split} key_bytes={plan.key_bytes}"
                  + (f" {json.dumps(st)}" if plan.route == "partition"
                     else "") + " max_abs_err=0", flush=True)
        del got, want, col
    set_counts(saved)
    print(f"kernel analyze: {n_cases} cases (edge cases of every dtype, "
          f"n in {ANALYZE_SIZES}, 2^20 and 2^22 rows): max_abs_err={worst} "
          f"tolerance=0 (ranks, counts bit for bit; kept bounds by value); "
          f"routes {json.dumps(routes)}; key bits {json.dumps(bits)}",
          flush=True)
    for route in ("count", "partition", "partition+oversized"):
        assert routes.get(route), f"analyze: no case took route {route}"
    return worst


def stats_equal(got, want) -> bool:
    """ColumnStats lists equal: ids, totals, NULL and distinct counts, and
    every bucket's bound and count (by value; no cell holds a NaN)."""
    return len(got) == len(want) and all(
        (g.col_id, g.total, g.null_count, g.distinct, g.buckets) ==
        (w.col_id, w.total, w.null_count, w.distinct, w.buckets)
        for g, w in zip(got, want))


def run_analyze(cell: str, runner, table=None, snap=None) -> dict:
    """ANALYZE cell ``cell`` (every column, 256 buckets) through
    ``Endpoint.handle_analyze`` at a row threshold of the snapshot's rows:
    one cold and five warm requests, each answer against the numpy truth
    (``configs.analyze_truth``); ``analyze`` must launch once per column
    and request and no other kernel; one range wait a request; no
    degrade; the host-clock phases of the cold and the median warm
    request."""
    from tikv_tpu_torch.copr.endpoint import Endpoint
    from tikv_tpu_torch.testing import configs as cf
    t0 = time.perf_counter()
    if snap is None:
        table, snap = cf.ANALYZE_CELLS[cell](ANALYZE_ROWS[cell])
    build_s = time.perf_counter() - t0
    areq = cf.analyze_request(table)
    t0 = time.perf_counter()
    want = cf.analyze_truth(areq, snap)
    truth_s = time.perf_counter() - t0
    rows = snap.estimated_rows()
    ep = Endpoint(lambda req: snap, runner, device_row_threshold=rows)
    set_counts({k: 0 for k in KERNELS})
    times, phases = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ep.handle_analyze(areq)["columns"]
        times.append((time.perf_counter() - t0) * 1e3)
        assert stats_equal(got, want), \
            f"cell {cell}: wrong answer (request {len(times)})"
        phases.append(dict(runner.analyze_phases_ms))
    launches = counts()
    cols = len(areq.scan.columns)
    assert launches["analyze"] == 6 * cols, launches
    assert all(v == 0 for k, v in launches.items() if k != "analyze"), \
        f"cell {cell} launched {launches}"
    assert not ep.degrades, f"cell {cell}: degrades {ep.degrades}"
    # one range wait a request, whatever its columns
    assert all(p.get("range_waits") == 1 for p in phases), \
        f"cell {cell}: range waits {[p.get('range_waits') for p in phases]}"
    out = {"config": cell, "rows": rows, "columns": cols,
           "buckets": areq.buckets, "cold_ms": times[0],
           "warm_p50_ms": float(np.percentile(times[1:], 50)),
           "launches": launches, "build_s": build_s, "truth_s": truth_s,
           "distinct": [s.distinct for s in got],
           "null_count": [s.null_count for s in got],
           "cold_phases_ms": phases[0],
           "warm_phases_ms": {k: float(np.median([p.get(k, 0.0)
                                                  for p in phases[1:]]))
                              for k in phases[-1]},
           "degrades": dict(ep.degrades)}
    print(f"cell {cell}: " + " ".join(
        f"{k}={json.dumps(v) if isinstance(v, (dict, list)) else v}"
        for k, v in out.items() if k != "config"), flush=True)
    return out


def run_checksum() -> dict:
    """CHECKSUM over config 4's table at 2^16 rows: the crc64-xz check
    value, the fold of the pairs in another order, two replicas of the
    same rows (built apart from one seed) and a partial range against the
    fold of its pairs; on the host, as in the reference.  The fold runs in
    the native module; the Python ``crc64`` fold of the same pairs is held
    against it and timed beside it (``plain_ms``)."""
    from tikv_tpu_torch.codec.keys import table_record_key
    from tikv_tpu_torch.copr.analyze import (ChecksumReq, checksum_kv_pairs,
                                             checksum_kv_pairs_plain, crc64)
    from tikv_tpu_torch.copr.endpoint import Endpoint
    from tikv_tpu_torch.executors.ranges import KeyRange
    from tikv_tpu_torch.testing import configs as cf
    assert crc64(b"123456789") == 0x995DC9BBDF1939FA
    table, snap = cf.build_table(CHECKSUM_ROWS)
    _t, replica = cf.build_table(CHECKSUM_ROWS)
    areq = cf.analyze_request(table)
    req = ChecksumReq(areq.scan, areq.ranges)
    t0 = time.perf_counter()
    one = Endpoint(lambda r: snap).handle_checksum(req)
    wall_ms = (time.perf_counter() - t0) * 1e3
    two = Endpoint(lambda r: replica).handle_checksum(req)
    assert one == two and one["total_kvs"] == CHECKSUM_ROWS, (one, two)
    pairs = snap.to_kv_pairs()[::-1]
    assert checksum_kv_pairs([k for k, _ in pairs],
                             [v for _, v in pairs]) == one
    part = (KeyRange(table_record_key(table.table_id, 100),
                     table_record_key(table.table_id, 5000)),)
    sub = Endpoint(lambda r: snap).handle_checksum(
        ChecksumReq(areq.scan, part))
    pairs = snap.to_kv_pairs(part)
    assert sub["total_kvs"] == 4900 and sub == checksum_kv_pairs(
        [k for k, _ in pairs], [v for _, v in pairs])
    pairs = snap.to_kv_pairs()
    keys, vals = [k for k, _ in pairs], [v for _, v in pairs]
    t0 = time.perf_counter()
    native = checksum_kv_pairs(keys, vals)
    fold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = checksum_kv_pairs_plain(keys, vals)
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert native == plain == one, (native, plain, one)
    out = {"rows": CHECKSUM_ROWS, "checksum": one["checksum"],
           "total_bytes": one["total_bytes"], "wall_ms": wall_ms,
           "fold_ms": fold_ms, "plain_ms": plain_ms,
           "replicas_agree": True}
    print("checksum: " + json.dumps(out), flush=True)
    return out


DEFERRED_ROWS = 1 << 22
EP_ROWS = 10 << 20
EP_CLIENTS, EP_REQS = 64, 6
EP_WINDOW_MS, EP_GROUP = 150.0, 16
EP_DEADLINE_MS = 60_000


def gil_released_by_event_wait() -> float:
    """The share of a Python loop's free-running rate that the main thread
    keeps while another thread waits in ``torch.cuda.Event.synchronize``
    on 0.2 s of device sleep (near 1: the wait releases the interpreter
    lock, so completion workers overlap their waits)."""
    import threading
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 0.05:
        n += 1
    rate = n / (time.perf_counter() - t0)
    torch.cuda._sleep(int(0.2 * CLOCK_HZ))
    ev = torch.cuda.Event()
    ev.record()
    done = threading.Event()
    waiter = threading.Thread(target=lambda: (ev.synchronize(), done.set()))
    t0 = time.perf_counter()
    waiter.start()
    n = 0
    while not done.is_set():
        n += 1
    spent = time.perf_counter() - t0
    waiter.join(timeout=10)
    return n / (rate * spent)


def check_budget(dev, n: int = 1 << 20) -> dict:
    """``DeviceRunner(hbm_budget_bytes=...)`` on the card, with room for
    one feed of config 3's plan (``n`` rows): while a deferred request on
    snapshot A pins A's feed, B's feed is refused a place and A stays;
    after A's fetch, B's next request evicts A.  Every answer equals the
    numpy truth → the arena's stats after each step."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.device import DeviceRunner
    from tikv_tpu_torch.testing import configs as cf
    build, plan = cf.CONFIGS["3"]
    table, snap_a = build(n)
    _t, snap_b = build(n)
    dag = dag_from_wire(enc_dag(plan(table)))
    want, scales = cf.truth("3", snap_a)
    saved = counts()
    probe = DeviceRunner(dev)
    probe.handle_request(dag, snap_a)
    one = probe.hbm_stats()["resident_bytes"]
    del probe
    budget = one + one // 2
    runner = DeviceRunner(dev, hbm_budget_bytes=budget)
    keys = ("resident_lines", "pinned_lines", "evictions", "rejections")
    steps, answers = [], []

    def note(resident_a: bool, resident_b: bool) -> None:
        st = runner.hbm_stats()
        assert st["resident_bytes"] <= budget, st
        assert (runner._arena.bucket(snap_a, create=False) is not None,
                runner._arena.bucket(snap_b, create=False) is not None) \
            == (resident_a, resident_b), (resident_a, resident_b)
        steps.append([st[k] for k in keys])

    pending = runner.handle_request(dag, snap_a, deferred=True)
    note(True, False)
    answers.append(runner.handle_request(dag, snap_b).rows())
    note(True, False)
    answers.append(pending.result().rows())
    note(True, False)
    answers.append(runner.handle_request(dag, snap_b).rows())
    note(False, True)
    set_counts(saved)
    assert all(cf.rows_agree(r, want, scales, SF_TOL) for r in answers), \
        "an answer under the budget differs from the truth"
    assert steps == [[1, 1, 0, 0], [1, 1, 0, 1], [1, 0, 0, 1],
                     [1, 0, 1, 1]], steps
    out = {"rows": n, "feed_bytes": one, "budget_bytes": budget,
           "steps": dict(zip(("a deferred", "b refused", "a fetched",
                              "b evicts a"), steps)), "keys": keys}
    print(f"check budget: {json.dumps(out)}", flush=True)
    return out


def run_deferred(runner) -> dict:
    """Thirty-two deferred requests over configs 2, 3 and 4's tables
    (``DEFERRED_ROWS`` rows each), every one dispatched before any wait,
    each equal to its serial answer; the pinned stager's stats; a
    ``device::before_fetch`` inside one deferred fetch degrades that
    request only; and whether a completion worker's event wait releases
    the interpreter lock."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.device.deferred import HOST_STAGER, DeferredResult
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.utils import failpoint
    n = DEFERRED_ROWS
    t2, s2 = cf.ROW_CONFIGS["2"][0](n)
    t3, s3 = cf.CONFIGS["3"][0](n)
    t4, s4 = cf.CONFIGS["4"][0](n)
    plans = [(cf.dag_selection(t2, thr), s2)
             for thr in (800, 900, 990, 998, 500)]
    plans += [(cf.CONFIGS["3"][1](t3), s3), (cf.CONFIGS["4"][1](t4), s4)]
    plans = [(dag_from_wire(enc_dag(d)), snap) for d, snap in plans]
    def columns(result) -> list:
        return [(c.values, c.validity) for c in result.batch.columns]

    def same(result, want) -> bool:
        got = columns(result)
        return len(got) == len(want) and all(
            np.array_equal(v, wv, equal_nan=v.dtype.kind == "f") and
            np.array_equal(m, wm) for (v, m), (wv, wm) in zip(got, want))

    serial = []
    for dag, snap in plans:
        for _ in range(3):              # warm: feeds and selectivities
            r = runner.handle_request(dag, snap)
        serial.append(columns(r))
    st0 = HOST_STAGER.stats()
    set_counts({k: 0 for k in KERNELS})
    t0 = time.perf_counter()
    pending = [runner.handle_request(*plans[i % len(plans)], deferred=True)
               for i in range(32)]
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    assert all(isinstance(d, DeferredResult) for d in pending)
    for i, d in reversed(list(enumerate(pending))):
        assert same(d.result(), serial[i % len(plans)]), \
            f"deferred request {i} differs from its serial answer"
        assert d.degraded is None
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    st1 = HOST_STAGER.stats()
    # a fault inside one deferred fetch degrades that request only
    a = runner.handle_request(*plans[0], deferred=True)
    b = runner.handle_request(*plans[5], deferred=True)
    failpoint.cfg("device::before_fetch", "1*return->off")
    try:
        got_a, got_b = a.result(), b.result()
    finally:
        failpoint.teardown()
    assert a.degraded == "fetch" and b.degraded is None
    assert same(got_a, serial[0]) and same(got_b, serial[5])
    share = gil_released_by_event_wait()
    assert share > 0.3, f"an event wait holds the interpreter lock ({share})"
    out = {"config": "deferred", "rows": n, "requests": 32,
           "dispatch_ms": dispatch_ms, "wall_ms": wall_ms,
           "launches": launches,
           "stager": {k: st1[k] - st0.get(k, 0) if k in ("staged",
                                                         "staged_bytes")
                      else st1[k] for k in st1},
           "loop_share_during_event_wait": share}
    print("deferred: " + " ".join(f"{k}={v}" for k, v in out.items()
                                  if k != "config"), flush=True)
    del s2, s3, s4, plans, pending
    gc.collect()
    return out


def serve_phase(ep, tables, schedule, check) -> dict:
    """One run of the 6b schedule through ``Endpoint.handle_async(...)
    .wait()``: EP_CLIENTS threads of EP_REQS requests each, started
    together, each request under a deadline of EP_DEADLINE_MS; answers are
    kept and held against their truths after the run (``check``)."""
    import threading
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.utils import deadline as dl_mod
    dags = {}
    for ti, pi, is_sel in schedule:
        key = (ti, pi if is_sel else None)
        if key not in dags:
            dags[key] = dag_from_wire(enc_dag(cf.dag_serving(
                tables[ti][0], cf.SERVE_PALETTE[pi] if is_sel else None)))
    lat, late, errors, answers, phases = [], [0], {}, {}, {}
    mu = threading.Lock()
    start = threading.Barrier(EP_CLIENTS)

    def worker(ci):
        start.wait(timeout=60)
        for r in range(EP_REQS):
            i = ci * EP_REQS + r
            ti, pi, is_sel = schedule[i]
            dag = dags[(ti, pi if is_sel else None)]
            dl = dl_mod.Deadline.after_ms(EP_DEADLINE_MS)
            tok = dl_mod.install(dl)
            t0 = time.perf_counter()
            try:
                resp = ep.handle_async(CopRequest(REQ_TYPE_DAG, dag)).wait()
            except Exception as e:      # noqa: BLE001 — counted, fails below
                with mu:
                    errors[type(e).__name__] = \
                        errors.get(type(e).__name__, 0) + 1
                continue
            finally:
                dl_mod.uninstall(tok)
            dt = time.perf_counter() - t0
            with mu:
                lat.append(dt)
                late[0] += int(dl.expired())
                answers[i] = resp
                for k, v in resp.tracker.phases.items():
                    phases[k] = phases.get(k, 0) + v

    ts = [threading.Thread(target=worker, args=(ci,))
          for ci in range(EP_CLIENTS)]
    set_counts({k: 0 for k in KERNELS})
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = counts()
    assert not any(t.is_alive() for t in ts), "a 6b-ep client never ended"
    assert not errors, f"6b-ep errors: {errors}"
    a = np.asarray(lat)
    bad = [i for i, resp in answers.items() if not check(schedule[i], resp)]
    assert not bad, f"6b-ep: {len(bad)} wrong answers, first {bad[:4]}"
    served = len(answers)
    return {"requests": len(schedule), "served": served,
            "p50_ms": float(np.percentile(a, 50)) * 1e3,
            "p99_ms": float(np.percentile(a, 99)) * 1e3,
            "wall_s": wall, "req_per_s": served / wall,
            "late_acks": late[0], "launches": launches,
            "backends": {b: sum(r.backend == b for r in answers.values())
                         for b in ("device", "host")},
            "phase_mean_ms": {k: v / served / 1e6
                              for k, v in sorted(phases.items())}}


def run_6b_ep(runner) -> list:
    """Cell 6b-ep: config 6b (bench.py:1130-1300) at the endpoint, three
    tables of 10·2^20 rows, the seeded schedule run twice — the coalescer
    unwired (every device request solo, deferred), then bound (window 150
    ms, groups of at most 16).  Every answer equals its numpy truth; no
    late ack, no degrade, no solo retry; sel_pred_batched launches in the
    coalesced phase only, and its mean occupancy is above 1.5."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, \
        Endpoint
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.server.coalescer import RequestCoalescer
    from tikv_tpu_torch.testing import configs as cf
    t0 = time.perf_counter()
    tables = [cf.serving_table(EP_ROWS, tid) for tid in cf.SERVE_TABLE_IDS]
    by_id = {t.table_id: snap for t, snap in tables}
    truths = {thr: cf.serving_truth(EP_ROWS, thr)
              for thr in cf.SERVE_PALETTE + (None,)}
    schedule = cf.serving_schedule(EP_CLIENTS * EP_REQS)
    print(f"6b-ep: tables and truths in {time.perf_counter() - t0:.3f} s",
          flush=True)

    def check(item, resp) -> bool:
        _ti, pi, is_sel = item
        if is_sel:
            return cf.columns_agree(resp.result.batch,
                                    truths[cf.SERVE_PALETTE[pi]])
        return sorted(resp.rows()) == truths[None]

    coal = RequestCoalescer(runner, window_ms=EP_WINDOW_MS,
                            max_group=EP_GROUP)
    ep = Endpoint(lambda req: by_id[req.dag.executors[0].table_id], runner,
                  coalescer=coal)
    out = []
    try:
        ep.coalescer = None
        for ti, (table, _snap) in enumerate(tables):     # warm every table
            for thr in (cf.SERVE_PALETTE[0], None):
                dag = dag_from_wire(enc_dag(cf.dag_serving(table, thr)))
                resp = ep.handle(CopRequest(REQ_TYPE_DAG, dag))
                assert resp.backend == "device"
                assert check((ti, 0, thr is not None), resp)
        for phase in ("solo", "coalesced"):
            ep.coalescer = coal if phase == "coalesced" else None
            st0 = coal.stats()
            deg0 = dict(ep.degrades)
            got = serve_phase(ep, tables, schedule, check)
            st = coal.stats()
            groups = st["groups_dispatched"] - st0["groups_dispatched"]
            members = st["requests_coalesced"] - st0["requests_coalesced"]
            got.update(config=f"6b-ep {phase}", rows=EP_ROWS,
                       groups=groups,
                       mean_occupancy=members / groups if groups else 0.0,
                       max_occupancy=st["max_occupancy"],
                       solo_retries=st["solo_degrade"] -
                       st0["solo_degrade"],
                       router=st["router"]["decisions"],
                       closes=st["closes"],
                       degrades={k: v - deg0.get(k, 0)
                                 for k, v in ep.degrades.items()
                                 if v != deg0.get(k, 0)})
            print(f"cell 6b-ep {phase}: " + " ".join(
                f"{k}={v}" for k, v in got.items() if k != "config"),
                flush=True)
            assert got["late_acks"] == 0 and not got["degrades"] and \
                got["solo_retries"] == 0, f"6b-ep {phase}: {got}"
            assert got["backends"]["host"] == 0, f"6b-ep {phase}: {got}"
            assert got["launches"]["hash_agg"] > 0, \
                f"6b-ep {phase} never launched hash_agg"
            if phase == "solo":
                assert got["launches"]["sel_pred"] > 0, \
                    "6b-ep solo never launched sel_pred"
                assert got["launches"]["sel_pred_batched"] == 0 and \
                    groups == 0, f"6b-ep solo: {got}"
            else:
                assert got["launches"]["sel_pred_batched"] > 0, \
                    "6b-ep coalesced never launched sel_pred_batched"
                assert got["mean_occupancy"] > 1.5, \
                    f"6b-ep mean occupancy {got['mean_occupancy']}"
            out.append(got)
    finally:
        ep.close()
    del tables, by_id, truths
    gc.collect()
    return out


def analyze_design_bytes(plan, n: int, value_bytes: int, n_keys: int,
                         n_buckets: int) -> int:
    """The bytes the route's kernels move at least: the range's read of
    each value and validity byte, then the counting route's second read
    and its counters, or the partition route's sample, its reads in
    classify and scatter, each between-bucket key written once and read
    once (``n_keys``), and its per-bucket tables."""
    row = n * (value_bytes + 1)
    head = (2 * n_buckets + 2) * 8
    if plan.route == "count":
        return 2 * row + 8 * plan.span + head
    if plan.route != "partition":
        return row + head
    kb, nbk = plan.key_bytes, plan.n_bucket
    return 3 * row + 2 * kb * n_keys + plan.n_sample * (value_bytes + 1) \
        + 4 * kb * plan.n_sample + 32 * nbk + head


def analyze_at_main_shapes(runner, dev) -> dict:
    """analyze_column at an4's id, k and v (104,857,600 int32 rows), an4s's
    k (2^24 int64) and an4r's v (2^24 float64), the columns padded as the
    runner uploads them: checked against the plain version there, and
    timed with CUDA events: as issued (``ms``: the wrapper waits once, for
    the range read) and its kernels alone, queued behind a device sleep
    (``kernel_ms``: the range launch plus the route's launches), each of
    the route's kernels (``stage_ms``: the difference of two prefixes of
    its launches), beside the bound (each value and validity byte read
    once, the packed vector written once, at 3.35 TB/s), the design's own
    bytes (``design_bytes``, ``design_bound_ms``), the plain version and
    one ``torch.sort`` of the same sentinelled column (a yardstick the
    port never calls); the route and, on the partition route, its
    distinct splitters, sorted buckets and oversized buckets."""
    from tikv_tpu_torch.datatype.tile import _device_dtype
    from tikv_tpu_torch.device import analyze as an
    from tikv_tpu_torch.testing import configs as cf
    saved = counts()
    b = cf.ANALYZE_BUCKETS
    out, errs = {}, {}
    shapes = (("an4", ("id", "k", "v")), ("an4s", ("k",)),
              ("an4r", ("v",)))
    for cell, names in shapes:
        table, snap = cf.ANALYZE_CELLS[cell](ANALYZE_ROWS[cell])
        batch = snap.scan_columns(cf.analyze_request(table).scan, ())
        n = batch.num_rows
        n_pad = runner._pad_rows(n)
        for name in names:
            col = batch.columns[[c.name for c in table.columns].index(name)]
            # the runner's choice: REAL as float64, else the feed dtype
            dt = np.float64 if col.eval_type.value == "real" else \
                _device_dtype(col.eval_type, col.values)
            v = runner._upload(col.values.astype(dt, copy=False), n_pad)
            ok = runner._upload(col.validity, n_pad)
            real = v.dtype == torch.float64
            label = f"{cell} {name}"
            errs[label] = an.packed_max_diff(
                an.analyze_column(v, ok, n, b),
                an.analyze_column_plain(v, ok, n, b), b, real)
            launch = an.ColumnLaunch(v, ok, n, b)
            launch.range()
            plan = launch.read_range()
            launch.run()
            stats = launch.partition_stats() \
                if plan.route == "partition" else {}
            range_ms = cuda_ms(launch.range, 20, queued=True)
            run_ms = cuda_ms(launch.run, 10, queued=True)
            stage_ms, before = {}, 0.0
            stages = an.STAGES[plan.route]
            for k, stage in enumerate(stages, 1):
                upto = run_ms if k == len(stages) else cuda_ms(
                    lambda: launch.run(k), 10, queued=True)
                stage_ms[stage] = upto - before
                before = upto
            # the keys written to buckets: the rows of between buckets
            n_keys = 0
            if plan.route == "partition":
                launch.run()
                at, size = an.scratch_layout(plan)[0]["totals"]
                tot = launch.scratch[at:at + size].view(torch.int64)
                n_keys = int(tot[:2 * stats["splitters"] + 1:2].sum())
            design = analyze_design_bytes(plan, n, v.element_size(), n_keys,
                                          b)
            mask = (torch.arange(n_pad, device=dev) < n) & ok
            sent = math.nan if real else torch.iinfo(v.dtype).max
            key = torch.where(mask, v, torch.full_like(v, sent))
            out[label] = {
                "ms": cuda_ms(lambda: an.analyze_column(v, ok, n, b), 10),
                "kernel_ms": range_ms + run_ms, "range_ms": range_ms,
                "run_ms": run_ms, "column_route": plan.route,
                "stage_ms": stage_ms, **stats, "bucket_keys": n_keys,
                "n_split": plan.n_split, "key_bytes": plan.key_bytes,
                "design_bytes": design,
                "design_bound_ms": design / HBM_BYTES_PER_S * 1e3,
                "plain_ms": cuda_ms(
                    lambda: an.analyze_column_plain(v, ok, n, b), 3),
                "library_ms": cuda_ms(lambda: torch.sort(key), 5),
                "library_call": "torch.sort of the sentinelled column",
                **bound_ms(n * (v.element_size() + 1) + (2 * b + 2) * 8, 0),
                "rows": n, "dtype": str(v.dtype).replace("torch.", ""),
                "key_bits": plan.bits, "n_valid": plan.n_valid,
                "timed": "ms: the wrapper as issued (it waits once, for the "
                         "range read); kernel_ms: range + route launches "
                         "queued; stage_ms: prefix differences"}
            print(f"analyze at {label}: {json.dumps(out[label])}",
                  flush=True)
            del v, ok, key, mask, launch
        del table, snap, batch
        gc.collect()
        torch.cuda.empty_cache()
    set_counts(saved)
    for label, e in errs.items():
        assert e == 0, f"analyze disagrees with its plain version at " \
            f"{label}: {e}"
    return out, max(errs.values())


# ---------------------------------------------------------------------------
# the device split: split_planes, cell 6c-split
# ---------------------------------------------------------------------------

SPLIT_DTYPES = (torch.bool, torch.int32, torch.float32, torch.int64,
                torch.float64)
SPLIT_KEYS = 10 << 20


def split_cases(n: int) -> list:
    """(right, pos, n_child) over a parent of ``n`` live rows: pos 0, 1,
    odd, n − 1, n, and 3 and 5 (no 4-element boundary for any width)."""
    out = []
    for pos in sorted({0, 1, 3, 5, n // 3 | 1, n // 2, n - 1, n}):
        for right in (False, True):
            n_child = n - pos if right else pos
            if n_child > 0:
                out.append((right, pos, n_child))
    return out


def split_err(planes, pos, n_child, n_pad, right, dev) -> int:
    """Elements and digests in which ``split_planes`` differs from its
    plain version (whole child planes, zero tails included), plus fused
    digests that differ from ``plane_digest`` of the child."""
    from tikv_tpu_torch.device import digest as dg
    from tikv_tpu_torch.device import split as sp
    got, gd = sp.split_planes(planes, pos, n_child, n_pad, right)
    want, wd = sp.split_planes_plain(planes, pos, n_child, n_pad, right)
    bad = sum(int((g.view(torch.uint8) if g.dtype == torch.bool else g)
                  .ne(w.view(torch.uint8) if w.dtype == torch.bool else w)
                  .sum()) if not same_bits(g, w) else 0
              for g, w in zip(got, want))
    bad += int(gd.ne(wd).sum())
    bad += sum(digest_err(d, dg.plane_digest(g, 0, n_child)) != 0
               for d, g in zip(gd, got))
    return bad


def check_split(dev) -> int:
    """split_planes against its plain version on the card, bit for bit
    (planes, zero tails, fused digests; the digests also against
    ``plane_digest`` of the child): bool, int32, float32, int64 and
    float64 planes, left and right children, pos 0, 1, odd, n − 1 and off
    every alignment, children of one row, child pads below and equal to
    the parent's, one block (1,000 rows) and many (3·2^20 + 17), P from 1
    to ``MAX_PLANES`` in one launch; and a corrupted parent row inside a
    child, whose fused digest must differ from the child's host digest
    (the split's verify refuses it) → elements and digests that differ."""
    from tikv_tpu_torch.device import split as sp
    from tikv_tpu_torch.device.digest import as_u64
    from tikv_tpu_torch.device.supervisor import host_plane_digest
    gen = torch.Generator().manual_seed(23)
    worst, cases = 0, 0
    for n in (1000, (3 << 20) + 17):
        n_pad = -(-n // 1024) * 1024 + 1024
        planes = [random_plane(dt, n_pad, gen, dev) for dt in SPLIT_DTYPES]
        for x in planes:
            x[n:] = 0
        for right, pos, n_child in split_cases(n):
            for pad in sorted({-(-n_child // 8) * 8, n_pad}):
                worst = max(worst, split_err(planes, pos, n_child, pad,
                                             right, dev))
                cases += 1
    # P from 1 to the limit in one launch, mixed dtypes
    n = 4099
    many = [random_plane(SPLIT_DTYPES[i % 5], n, gen, dev)
            for i in range(sp.MAX_PLANES)]
    for P in (1, 2, 7, 64, sp.MAX_PLANES):
        worst = max(worst, split_err(many[:P], 1023, n - 1023, 3080, True,
                                     dev))
        cases += 1
    # a corrupted parent row inside the right child: its verify refuses
    parent = random_plane(torch.int32, 1 << 20, gen, dev)
    pos, n_child = 1 << 19, 1 << 19
    truth = parent[pos:pos + n_child].cpu().numpy().copy()
    parent[pos + 12345] ^= 1
    _out, d = sp.split_planes([parent], pos, n_child, n_child, True)
    refused = as_u64(d[0]) != host_plane_digest(truth, n_child)
    torch.cuda.synchronize()
    print(f"check split_planes: {cases} cases (5 dtypes, both sides, "
          f"{len(split_cases(1000))} positions at 1,000 and 3·2^20 + 17 "
          f"rows, two pads each, P up to {sp.MAX_PLANES}): worst {worst}; "
          f"a corrupted parent row refused: {refused}", flush=True)
    assert worst == 0, "split_planes disagrees with its plain version"
    assert refused, "the split's verify passed a corrupted parent row"
    return worst


def split_truth(lo: int, hi: int, plan: str):
    """6c's answer over handles [lo, hi): GROUP BY c0: COUNT(*), SUM(c1)
    rows sorted by c0, or the ids of ``c1 > 990``."""
    from tikv_tpu_torch.testing import configs as cf
    h = np.arange(lo, hi, dtype=np.int64)
    if plan == "sel":
        return h[h % 1000 > 990]
    c0 = h % cf.GROUPS
    cnt = np.bincount(c0, minlength=cf.GROUPS)
    s = np.bincount(c0, weights=(h % 1000).astype(np.float64),
                    minlength=cf.GROUPS)
    return [(int(cnt[g]), int(s[g]), g) for g in range(cf.GROUPS)
            if cnt[g]]


class SplitCell:
    """Cell 6c-split: config 6c's region (``bench.py:501-560``,
    ``testing.mvcc.history_6c``) behind the port's region lifecycle —
    ``RegionSnapshot`` → ``RegionColumnarCache.get`` → ``Endpoint`` →
    ``CoprocessorHost.notify_region_split`` / ``notify_region_changed`` →
    the children's requests.

    The history is version planes held in no engine (cell 6c-ingest,
    ``run_ingest``, drives the build from the engine), so the cache's
    builder (``region_cache.build_region_columnar_ex``, looked up at call
    time, the seam of the reference's own tests) is substituted: a build
    of the whole region returns 6c's cold build
    (``build_region_columnar_device`` over its version planes, with its
    ``ColdFeedBundle``: the parent feed is minted on the card); a build of
    a part (the fallback route's children) returns that slice of the cold
    build's host mirror, with no bundle (its feeds upload)."""

    def __init__(self, runner, n_keys: int, source=None,
                 delta_source=None):
        """``source``: (table, version planes, read_ts) of another cell's
        history, to build a fresh parent from; ``delta_source``: a
        ``DeltaSink`` the cache bridges its lines with (registered on the
        observer host before the supervisor)."""
        from tikv_tpu_torch.copr import region_cache as rc
        from tikv_tpu_torch.copr.endpoint import Endpoint
        from tikv_tpu_torch.device.supervisor import DeviceStateSupervisor
        from tikv_tpu_torch.engine.memory import MemoryEngine
        from tikv_tpu_torch.raftstore.metapb import Region
        from tikv_tpu_torch.raftstore.observer import CoprocessorHost
        from tikv_tpu_torch.testing import mvcc as tm
        self.runner = runner
        if source is None:
            table, planes, _th, _truth, read_ts = tm.history_6c(n_keys)
            source = (table, planes, read_ts)
        self.table, self.planes, self.read_ts = source
        self.n = n_keys
        self.engine = MemoryEngine()
        self.cache = rc.RegionColumnarCache(delta_source=delta_source)
        self.sup = DeviceStateSupervisor(runner, self.cache, delta_source)
        self.host = CoprocessorHost()
        if delta_source is not None:
            self.host.register(delta_source)
        self.host.register(self.sup)
        self.region = Region(1)
        self.data_index = 100
        self.builds = []            # (region id, rows) of each build
        self.mirror = None
        self.ep = Endpoint(self._provider, runner)
        self._rc = rc

    def snap(self, region, data_index=None):
        """The engine snapshot of ``region`` at ``data_index`` (default: the
        cell's, 100 until a write moves it)."""
        from tikv_tpu_torch.raftstore.peer import RegionSnapshot
        rs = RegionSnapshot(self.engine.snapshot(), region)
        rs.data_index = self.data_index if data_index is None \
            else data_index
        return rs

    def _provider(self, req):
        return self.cache.get(self.snap(self.region), req.dag)

    def build(self, snap, table_id, col_infos, read_ts,
              device_resolver=None, stream_source=None):
        """The substituted ``build_region_columnar_ex``."""
        from tikv_tpu_torch.codec.keys import decode_record_handle
        from tikv_tpu_torch.executors.columnar import ColumnarTable
        from tikv_tpu_torch.storage.txn_types import decode_key
        region = snap.region
        assert read_ts == self.read_ts and table_id == self.table.table_id
        if not region.start_key and not region.end_key:
            tbl, safe, bundle = self._rc.build_region_columnar_device(
                self.planes, self.table, col_infos, read_ts,
                self.runner.mvcc_resolver())
            self.mirror = tbl
            self.builds.append((region.id, len(tbl)))
            return tbl, safe, [], bundle
        lo = decode_record_handle(decode_key(region.start_key)) \
            if region.start_key else 0
        hi = decode_record_handle(decode_key(region.end_key)) \
            if region.end_key else self.n
        m = self.mirror
        cols = {cid: type(c)(c.eval_type, c.values[lo:hi],
                             c.validity[lo:hi])
                for cid, c in m.columns.items()}
        tbl = ColumnarTable(m.table, m.handles[lo:hi], cols)
        self.builds.append((region.id, len(tbl)))
        return tbl, int(self.planes.safe_ts), [], None

    def dag(self, plan: str, ts=None):
        """``plan`` ("sel": ``c1 > 990``; else GROUP BY c0: COUNT(*),
        SUM(c1)) at ``ts`` (default: the history's read_ts)."""
        from tikv_tpu_torch.convert import dag_from_wire
        from tikv_tpu_torch.copr.wire import enc_dag
        from tikv_tpu_torch.testing.dag import DagSelect
        s = DagSelect.from_table(self.table, ["id", "c0", "c1"])
        if plan == "sel":
            d = s.where(s.col("c1") > 990)
        else:
            d = s.aggregate([s.col("c0")], [("count_star", None),
                                            ("sum", s.col("c1"))])
        return dag_from_wire(enc_dag(d.build(
            self.read_ts if ts is None else ts)))

    def bounds(self, region) -> tuple:
        from tikv_tpu_torch.codec.keys import decode_record_handle
        from tikv_tpu_torch.storage.txn_types import decode_key
        lo = decode_record_handle(decode_key(region.start_key)) \
            if region.start_key else 0
        hi = decode_record_handle(decode_key(region.end_key)) \
            if region.end_key else self.n
        return lo, hi

    def serve(self, region, plan: str, warm: int = 2) -> dict:
        """A cold and ``warm`` warm requests of ``plan`` on ``region``,
        forced to the device, each answer against its truth → cold ms,
        warm ms, the feed labels, the cold request's phases (ms)."""
        from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
        self.region = region
        lo, hi = self.bounds(region)
        want = split_truth(lo, hi, plan)
        dag = self.dag(plan)
        times, labels, phases = [], [], None
        for i in range(1 + warm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resp = self.ep.handle(CopRequest(REQ_TYPE_DAG, dag,
                                             force_backend="device"))
            if plan == "sel":
                got = np.asarray(resp.result.batch.columns[0].values)
            else:
                got = sorted(resp.rows(), key=lambda r: r[2])
            times.append((time.perf_counter() - t0) * 1e3)
            assert resp.backend == "device", resp.backend
            ok = np.array_equal(got, want) if plan == "sel" else got == want
            assert ok, f"6c-split {plan} on [{lo}, {hi}): wrong answer"
            labels.append(resp.tracker.labels.get("device_feed"))
            if i == 0:
                phases = {k: v / 1e6 for k, v in
                          resp.tracker.phases.items()}
        return {"cold_ms": times[0], "warm_ms": times[1:],
                "labels": labels, "cold_phases_ms": phases}

    def split(self, left, right, left_index=100, right_index=100) -> dict:
        """The split in the reference's order → its host-clock wall and
        phases, and the arena's resident bytes around it."""
        before = self.runner.hbm_stats()["resident_bytes"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.host.notify_region_split(left, right, left_index, right_index)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_split = self.runner.hbm_stats()["resident_bytes"]
        allocated = torch.cuda.memory_allocated()
        self.host.notify_region_changed(left)
        t2 = time.perf_counter()
        return {"split_ms": (t1 - t0) * 1e3,
                # the stashed children are not in the arena until their
                # first request takes them: parent and children are all
                # on the card until the region change drops the parent
                "stash_bytes": self.stash_bytes(),
                "cuda_allocated_after_split": allocated,
                "cuda_allocated_after_region_changed":
                    torch.cuda.memory_allocated(),
                "region_changed_ms": (t2 - t1) * 1e3,
                "phases_ms": dict(self.sup.split_phases_ms,
                                  **{f"runner_{k}": v for k, v in
                                     self.runner.split_phases_ms.items()}),
                "resident_bytes": {
                    "before": before, "after_split": after_split,
                    "after_region_changed":
                        self.runner.hbm_stats()["resident_bytes"]}}

    def stash_bytes(self) -> int:
        return sum(sum(t.nbytes for t in c["feed"]["flat"])
                   for line in self.cache._lines.values()
                   if line.state is not None
                   for c in line.state.lineage.split_stash or [])

    def stash_left(self) -> int:
        return sum(len(line.state.lineage.split_stash or [])
                   for line in self.cache._lines.values()
                   if line.state is not None)


def run_split(runner, n_keys: int = SPLIT_KEYS) -> dict:
    """Cell 6c-split: config 6c's region at ``n_keys``
    keys built through the port cache (the builder substituted, see
    ``SplitCell``) and minted on the card; the aggregation and the
    selection warmed on it (cold + 2 warm each); split 1 at handle n/2
    (epoch 2) through a ``CoprocessorHost``: ``notify_region_split(left,
    right, 100, 100)``, then ``notify_region_changed(left)``; both plans on
    both children (cold + 2 warm); split 2 of the right child at 90% of
    its rows (an odd row: unaligned planes) and both plans on both of its
    children; then the fallback route: a fresh parent split with
    ``device::device_split`` armed, whose children rebuild their lines on
    the host and upload.  Every answer against numpy; each child's first
    request labelled ``split`` (``upload`` on the fallback route); no
    ``columnar_build`` for a split child; every stash consumed, the parent
    feeds gone from the arena; the supervisor's counts exactly as
    expected; no degrade.  Counts from 0 before the path, read after."""
    from tikv_tpu_torch.codec.keys import table_record_key
    from tikv_tpu_torch.raftstore.metapb import Region, RegionEpoch
    from tikv_tpu_torch.storage.txn_types import encode_key
    from tikv_tpu_torch.utils import failpoint
    t0 = time.perf_counter()
    cell = SplitCell(runner, n_keys)
    gen_s = time.perf_counter() - t0
    n, tid = n_keys, cell.table.table_id

    def key(h):
        return encode_key(table_record_key(tid, h))

    orig = cell._rc.build_region_columnar_ex
    cell._rc.build_region_columnar_ex = cell.build
    routes0 = dict(runner.feed_routes)
    out = {"config": "6c-split", "keys": n, "generate_s": gen_s}
    try:
        set_counts({k: 0 for k in KERNELS})
        parent = Region(1)
        out["parent"] = {p: cell.serve(parent, p) for p in ("agg", "sel")}
        parent_lineage = cell.cache._lines[next(iter(cell.cache._lines))] \
            .state.lineage
        assert [b[0] for b in cell.builds] == [1], cell.builds
        # split 1: at handle n/2
        mid = n // 2
        left = Region(1, b"", key(mid), RegionEpoch(1, 2))
        right = Region(2, key(mid), b"", RegionEpoch(1, 2))
        out["split1"] = cell.split(left, right)
        assert (cell.sup.splits, cell.sup.split_fallbacks) == (1, 0), \
            cell.sup.stats()
        assert runner._arena.bucket(parent_lineage, create=False) is None, \
            "the parent feeds outlived the split"
        for side, reg in (("left", left), ("right", right)):
            out["split1"][side] = {p: cell.serve(reg, p) for p in
                                   ("agg", "sel")}
        # the smoke's cross-check of the fused digests: a child feed's
        # planes re-hashed by plane_digest equal the split's record
        child = next(iter(runner.resident_feeds(
            cell.cache.get(cell.snap(right), cell.dag("sel"))).values()))
        assert runner.scrub_feed(child) == [], "a split child's digests"
        # split 2: the right child at 90% of its rows, an odd row
        h2 = mid + (int(0.9 * (n - mid)) | 1)
        cell.region = right
        left2 = Region(2, key(mid), key(h2), RegionEpoch(1, 3))
        right2 = Region(3, key(h2), b"", RegionEpoch(1, 3))
        out["split2"] = cell.split(left2, right2)
        out["split2"]["pos"] = h2 - mid
        assert (cell.sup.splits, cell.sup.split_fallbacks) == (2, 0)
        for side, reg in (("right", right2), ("left", left2)):
            out["split2"][side] = {p: cell.serve(reg, p) for p in
                                   ("agg", "sel")}
        launches = counts()     # the split route's; the fallback adds
        for name in ("split_planes", "mvcc_resolve", "plane_digest",
                     "hash_agg", "sel_pred", "sel_compact"):
            assert launches[name] > 0, f"6c-split never launched {name}"
        assert launches["split_planes"] == 8, launches["split_planes"]
        labels1 = [r["labels"][0] for s in ("left", "right")
                   for r in out["split1"][s].values()]
        labels2 = [r["labels"][0] for r in out["split2"]["right"].values()]
        assert labels1 == ["split"] * 4 and labels2 == ["split"] * 2, \
            (labels1, labels2)
        assert [r["labels"][0] for r in out["split2"]["left"].values()] \
            == ["split"] * 2
        assert [b[0] for b in cell.builds] == [1], \
            f"a split child ran columnar_build: {cell.builds}"
        assert cell.stash_left() == 0, "a stash was not consumed"
        routes = {k: v - routes0.get(k, 0) for k, v in
                  runner.feed_routes.items() if v != routes0.get(k, 0)}
        assert routes == {"device_resolve": 1, "upload": 1, "split": 8}, \
            routes
        out["feed_routes"] = routes
        out["supervisor"] = {"splits": cell.sup.splits,
                             "split_fallbacks": cell.sup.split_fallbacks}
        # the fallback route: a fresh parent, split with the device split
        # armed; its children rebuild on the host and upload
        for rid in (1, 2, 3):
            cell.cache.invalidate_region(rid)
        fb = SplitCell(runner, n, (cell.table, cell.planes, cell.read_ts))
        cell._rc.build_region_columnar_ex = fb.build
        out["fallback"] = {"parent": {p: fb.serve(parent, p, warm=0)
                                      for p in ("agg", "sel")}}
        failpoint.cfg("device::device_split", "return")
        try:
            out["fallback"]["split"] = fb.split(left, right)
        finally:
            failpoint.teardown()
        assert (fb.sup.splits, fb.sup.split_fallbacks) == (0, 1)
        for side, reg in (("left", left), ("right", right)):
            out["fallback"][side] = {p: fb.serve(reg, p) for p in
                                     ("agg", "sel")}
            assert [r["labels"][0] for r in
                    out["fallback"][side].values()] == ["upload"] * 2
        assert sorted(b[0] for b in fb.builds) == [1, 1, 2], fb.builds
        assert cell.ep.degrades == {} and fb.ep.degrades == {}, \
            (cell.ep.degrades, fb.ep.degrades)
        out["fallback_supervisor"] = {
            "splits": fb.sup.splits, "split_fallbacks": fb.sup.split_fallbacks}
        out["launches"] = counts()
    finally:
        cell._rc.build_region_columnar_ex = orig
        failpoint.teardown()
    cold = {"split": [out["split1"][s][p]["cold_ms"] for s in
                      ("left", "right") for p in ("agg", "sel")],
            "fallback": [out["fallback"][s][p]["cold_ms"] for s in
                         ("left", "right") for p in ("agg", "sel")]}
    summary = {k: v for k, v in out.items() if k not in
               ("parent", "split1", "split2", "fallback")}
    summary.update(
        split1={k: out["split1"][k] for k in
                ("split_ms", "region_changed_ms", "phases_ms",
                 "resident_bytes", "stash_bytes",
                 "cuda_allocated_after_split",
                 "cuda_allocated_after_region_changed")},
        split2={k: out["split2"][k] for k in
                ("pos", "split_ms", "phases_ms", "resident_bytes",
                 "stash_bytes")},
        child_cold_ms=cold,
        child_warm_p50_ms={
            s: {p: float(np.percentile(out["split1"][s][p]["warm_ms"], 50))
                for p in ("agg", "sel")} for s in ("left", "right")},
        parent_cold_ms={p: out["parent"][p]["cold_ms"]
                        for p in ("agg", "sel")},
        fallback_child_build_ms=[
            out["fallback"][s][p]["cold_phases_ms"].get("columnar_build", 0)
            for s in ("left", "right") for p in ("agg", "sel")])
    print("split cell 6c-split: " + json.dumps(summary), flush=True)
    source = (cell.table, cell.planes, cell.read_ts)
    del cell, fb
    gc.collect()
    torch.cuda.empty_cache()
    # the history rides on to cell 6c-delta (the caller pops it)
    return dict(summary, launches=out["launches"], source=source)


def split_at_main_shape(runner, dev) -> dict:
    """split_planes at 6c-split's split 1 shape: each child of 5·2^20 rows
    over the selection feed's planes (id, c0, c1: int32 at 6c's values) of
    the 10·2^20-row parent, against its plain version; CUDA events, queued
    behind a device sleep, beside its bound (Σ_planes (n_child +
    n_pad_child)·w + 8·P bytes at 3.35 TB/s), the plain version, and a
    yardstick the port never calls: one ``copy_`` of the slice into a
    zeroed child and one ``plane_digest`` a plane."""
    from tikv_tpu_torch.device import digest as dg
    from tikv_tpu_torch.device import split as sp
    saved = counts()
    n = SPLIT_KEYS
    n_pad = runner._pad_rows(n)
    h = torch.arange(n_pad, dtype=torch.int64, device=dev)
    live = h < n
    planes = [torch.where(live, x, 0).to(torch.int32).contiguous()
              for x in (h, h % 1024, h % 1000)]
    del h, live
    out = {}
    worst = 0
    for right in (False, True):
        pos = n // 2
        n_child = n - pos if right else pos
        n_pad_child = runner._pad_rows(n_child)
        worst = max(worst, split_err(planes, pos, n_child, n_pad_child,
                                     right, dev))
        lo = pos if right else 0
        dst = [torch.zeros(n_pad_child, dtype=x.dtype, device=dev)
               for x in planes]

        def yardstick():
            for x, y in zip(planes, dst):
                y[:n_child].copy_(x[lo:lo + n_child])
                dg.plane_digest(y, 0, n_child)
        nbytes = sum((n_child + n_pad_child) * x.element_size()
                     for x in planes) + 8 * len(planes)
        out["right" if right else "left"] = {
            "ms": cuda_ms(lambda: sp.split_planes(
                planes, pos, n_child, n_pad_child, right), 20, queued=True),
            "plain_ms": cuda_ms(lambda: sp.split_planes_plain(
                planes, pos, n_child, n_pad_child, right), 3),
            "yardstick_ms": cuda_ms(yardstick, 20),
            "yardstick": "copy_ of the slice into a zeroed child + "
                         "plane_digest, a plane",
            "library_ms": None, **bound_ms(nbytes, 0),
            "bytes": nbytes, "planes": len(planes), "n_child": n_child,
            "n_pad_child": n_pad_child, "pos": pos}
        del dst
    set_counts(saved)
    assert worst == 0, "split_planes disagrees at the main shape"
    print("split_planes at 6c-split's shape: " + json.dumps(out),
          flush=True)
    del planes
    torch.cuda.empty_cache()
    return dict(out["right"], configs=out, max_abs_err=worst)


# ---------------------------------------------------------------------------
# cell 6c-delta: writes reach the card as patches
# ---------------------------------------------------------------------------

# w2's four runs of 1,024 consecutive handles, and w3's inserts
DELTA_RUNS = (1 << 20, 3 << 20, 5 << 20, 7 << 20)
DELTA_RUN_ROWS = 1 << 10
DELTA_INSERTS = 1 << 16


class DeltaModel:
    """Cell 6c-delta's rows in numpy (handles ascending, c0, c1), each
    write applied as the cache must see it."""

    def __init__(self, n: int):
        from tikv_tpu_torch.testing import configs as cf
        self.groups = cf.GROUPS
        self.h = np.arange(n, dtype=np.int64)
        self.c0 = self.h % self.groups
        self.c1 = self.h % 1000

    def truth(self, plan: str):
        """The ids of ``c1 > 990``, or GROUP BY c0: COUNT(*), SUM(c1) rows
        sorted by c0."""
        if plan == "sel":
            return self.h[self.c1 > 990]
        cnt = np.bincount(self.c0, minlength=self.groups)
        s = np.bincount(self.c0, weights=self.c1.astype(np.float64),
                        minlength=self.groups)
        return [(int(cnt[g]), int(s[g]), g) for g in range(self.groups)
                if cnt[g]]

    def update(self, hs, c1) -> None:
        pos = np.searchsorted(self.h, hs)
        self.c1[pos] = c1

    def insert(self, hs) -> None:
        self.h = np.concatenate([self.h, hs])
        self.c0 = np.concatenate([self.c0, hs % self.groups])
        self.c1 = np.concatenate([self.c1, hs % 1000])

    def delete(self, hs) -> None:
        keep = ~np.isin(self.h, hs)
        self.h, self.c0, self.c1 = self.h[keep], self.c0[keep], self.c1[keep]


def delta_puts(tid: int, hs, c0, c1, commit_ts: int) -> list:
    """Committed PUTs of rows ``hs`` (inline short values): the engine
    records of one applied entry."""
    from tikv_tpu_torch.testing import mvcc as tm
    ones = np.ones(len(hs), np.bool_)
    return tm.kv_history(tid, np.asarray(hs, np.int64), [tm.Event(
        commit_ts, tm.WT_PUT, np.arange(len(hs)),
        {2: (np.asarray(c0), ones), 3: (np.asarray(c1), ones)})])


def run_delta(runner, source) -> dict:
    """Cell 6c-delta: config 6c's region (``bench.py:501-560``, the history
    6c-split made, through ``SplitCell``'s build seam) served through the
    port's ``RegionColumnarCache(delta_source=sink)``, with a ``DeltaSink``
    and the ``DeviceStateSupervisor`` on one ``CoprocessorHost``; the feed
    is minted on the card by the cold build.  Five writes, each a committed
    batch of CF_WRITE records applied to the engine and handed to the host
    (``notify_apply_write``), each followed by both plans (GROUP BY c0:
    COUNT(*), SUM(c1); ``c1 > 990``) at a read ts above its commit:

    - w1 (index 101): one UPDATE of one row's c1 → ``patch``, one span
      launch a feed; then a read below w1's commit_ts, served by the old
      generation from the line's history (no build);
    - w2 (102): 4,096 UPDATEs in 4 runs of 1,024 handles → 4 spans, one
      launch a feed;
    - w3 (103): 65,536 INSERTs past the greatest handle, into the line's
      slack and inside the feed's pad bucket → ``patch``, ``n_live``
      grows;
    - the scrub: one clean pass over every resident plane, then
      ``device::feed_corrupt`` once: one divergence, region 1 quarantined;
      the next request is answered on the host (one ``quarantined``
      degrade), the one after uploads on the card;
    - the replica feed: a demotion (``on_role_change(1, False)``), after
      which a read serves from the resident feed (``hit``, no upload, no
      build); a promotion, timed: one ``plane_digest`` a resident plane,
      no build, ``promotion_rebuilds`` 0; a promotion with
      ``copr::replica_promote`` armed once: the region invalidates and the
      next request pays one cold mint (``mvcc_resolve``; the cell's
      substituted build takes version planes of the rows as they now
      stand);
    - w4 (104): a ROLLBACK record → safe_ts advances, ``patch``, no launch;
    - w5 (105): one DELETE → structural: ``upload``.

    After each write, the first request of each plan rolls its memo
    forward: the record (``runner.last_refresh``) says which of the plane
    dtypes, the hash bounds and the byte-plane widths it kept.  Every
    answer equals the numpy model; w1-w4's requests have no
    ``feed_upload`` phase; the cache builds twice (the cold mint, the
    forced rebuild's) and rebuilds never.  ``runner`` holds no other anchor
    (the scrub's verdicts are this cell's).  Counts from 0 before the path,
    read after."""
    from tikv_tpu_torch.copr.delta import DeltaSink
    from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
    from tikv_tpu_torch.device import digest as dg
    from tikv_tpu_torch.testing import mvcc as tm
    from tikv_tpu_torch.utils import failpoint
    t_start = time.perf_counter()
    sink = DeltaSink(max_rows=1 << 17)
    cell = SplitCell(runner, SPLIT_KEYS, source, delta_source=sink)
    n, tid = cell.n, cell.table.table_id
    model = DeltaModel(n)
    out = {"config": "6c-delta", "keys": n,
           "pad_rows": {"n": runner._pad_rows(n),
                        "after w3": runner._pad_rows(n + DELTA_INSERTS)}}

    def ask(plan: str, ts: int, label=None, backend="device", want=None):
        dag = cell.dag(plan, ts)
        runner.last_refresh = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = cell.ep.handle(CopRequest(REQ_TYPE_DAG, dag))
        if plan == "sel":
            got = np.asarray(resp.result.batch.columns[0].values)
        else:
            got = sorted(resp.rows(), key=lambda r: r[2])
        ms = (time.perf_counter() - t0) * 1e3
        want = model.truth(plan) if want is None else want
        ok = np.array_equal(got, want) if plan == "sel" else got == want
        assert ok, f"6c-delta {plan} at ts {ts}: wrong answer"
        assert resp.backend == backend, (plan, ts, resp.backend)
        lab = resp.tracker.labels.get("device_feed")
        assert label is None or lab == label, (plan, ts, lab, label)
        return {"ms": ms, "label": lab,
                "copr_cache": resp.tracker.labels.get("copr_cache"),
                "memo": runner.last_refresh,
                "phases_ms": {k: v / 1e6 for k, v in
                              resp.tracker.phases.items()}}

    writes: dict = {}

    def write(name: str, triples, commit_ts: int) -> None:
        cell.data_index += 1
        t0 = time.perf_counter()
        tm.apply_write(cell.engine, cell.host, 1, cell.data_index, triples)
        writes[name] = {"index": cell.data_index, "commit_ts": commit_ts,
                        "records": len(triples),
                        "apply_ms": (time.perf_counter() - t0) * 1e3}

    def serve_both(name: str, ts: int, label: str, span_calls: int,
                   memo: str) -> None:
        before = dg.span_launches
        got = {p: ask(p, ts, label) for p in ("agg", "sel")}
        calls = dg.span_launches - before
        assert calls == span_calls, (name, calls, span_calls)
        for p, r in got.items():
            # the memo rolled forward across the write: kept or dropped
            rec = r["memo"]
            assert rec is not None and rec["kept"] is (memo == "kept"), \
                (name, p, rec)
        if label == "patch":
            for p, r in got.items():
                assert "feed_upload" not in r["phases_ms"], (name, p)
                assert "columnar_build" not in r["phases_ms"], (name, p)
        writes[name].update(requests=got, span_launches=calls)

    orig = cell._rc.build_region_columnar_ex
    cell._rc.build_region_columnar_ex = cell.build
    r1, r4, r5 = 12_345, 23_456, 54_321
    try:
        set_counts({k: 0 for k in KERNELS})
        ts = cell.read_ts
        out["cold"] = {p: ask(p, ts) for p in ("agg", "sel")}
        assert [b[0] for b in cell.builds] == [1], cell.builds
        lineage = next(iter(cell.cache._lines.values())).state.lineage
        old_sel = model.truth("sel")
        # w1: one UPDATE of one row's c1
        write("w1", delta_puts(tid, [r1], [r1 % model.groups], [995], 300),
              300)
        model.update([r1], [995])
        serve_both("w1", 310, "patch", 2, "kept")
        # a read below w1's commit: the old generation, from the history
        out["history_read"] = ask("sel", ts, want=old_sel)
        assert cell.cache.misses == 1, cell.cache.stats()
        # w2: 4 runs of 1,024 consecutive handles
        hs = np.concatenate([np.arange(a, a + DELTA_RUN_ROWS)
                             for a in DELTA_RUNS])
        c1 = (hs * 7 + 1) % 1000
        write("w2", delta_puts(tid, hs, hs % model.groups, c1, 320), 320)
        model.update(hs, c1)
        serve_both("w2", 330, "patch", 2, "kept")
        assert len(lineage._patches[-1]["spans"]) == len(DELTA_RUNS)
        # w3: 65,536 INSERTs past the greatest handle
        hs = np.arange(n, n + DELTA_INSERTS, dtype=np.int64)
        write("w3", delta_puts(tid, hs, hs % model.groups, hs % 1000, 340),
              340)
        model.insert(hs)
        serve_both("w3", 350, "patch", 2, "kept")
        feeds = runner.resident_feeds(cell.cache.get(
            cell.snap(cell.region), cell.dag("sel", 350)))
        assert {f["n_live"] for f in feeds.values()} == {n + DELTA_INSERTS}
        # the scrub: clean, then the injected flip
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean = cell.sup.scrub()
        out["scrub_ms"] = (time.perf_counter() - t0) * 1e3
        assert clean["divergences"] == 0 and clean["lines"] == 1 and \
            clean["planes"] == 5, clean
        out["replica"] = replica_feed_steps(cell, runner, model, 350)
        failpoint.cfg("device::feed_corrupt", "1*return")
        try:
            caught = cell.sup.scrub()
        finally:
            failpoint.teardown()
        assert caught["divergences"] == 1 and \
            caught["quarantined_regions"] == [1], caught
        out["scrub"] = {"clean": clean, "caught": caught}
        out["quarantine"] = {
            "next": ask("agg", 350, "quarantined", backend="host"),
            "after": ask("agg", 350, "upload")}
        assert cell.ep.degrades == {"quarantined": 1}, cell.ep.degrades
        out["quarantine"]["sel after"] = ask("sel", 350, "upload")
        # w4: a ROLLBACK record
        write("w4", tm.kv_history(tid, np.asarray([r4], np.int64), [
            tm.Event(360, tm.WT_ROLLBACK, np.arange(1))]), 360)
        serve_both("w4", 370, "patch", 0, "kept")
        assert cell.cache._lines[next(iter(cell.cache._lines))] \
            .snap.safe_ts == 360
        assert cell.cache.stats()["rebuilds"] == 0
        # w5: one DELETE
        write("w5", tm.kv_history(tid, np.asarray([r5], np.int64), [
            tm.Event(380, tm.WT_DELETE, np.arange(1))]), 380)
        model.delete([r5])
        serve_both("w5", 390, "upload", 0, "dropped")
        st = cell.cache.stats()
        assert (st["misses"], st["rebuilds"], st["deltas"]) == (2, 0, 5), st
        assert [b[0] for b in cell.builds] == [1, 1], cell.builds
        launches = counts()
        for name in ("mvcc_resolve", "hash_agg", "sel_pred", "plane_digest",
                     "patch_spans"):
            assert launches[name] > 0, f"6c-delta never launched {name}"
        assert launches["patch_spans"] == 6, launches["patch_spans"]
        out["launches"] = launches
    finally:
        cell._rc.build_region_columnar_ex = orig
        failpoint.teardown()
    out["writes"] = writes
    out["wall_s"] = time.perf_counter() - t_start
    host = {w: {"delta_apply_ms": writes[w]["requests"]["agg"]["phases_ms"]
                .get("delta_apply"),
                "feed_patch_ms": {p: writes[w]["requests"][p]["phases_ms"]
                                  .get("feed_patch") for p in ("agg", "sel")},
                "request_ms": {p: writes[w]["requests"][p]["ms"]
                               for p in ("agg", "sel")}}
            for w in ("w1", "w2", "w3", "w4")}
    host["w5"] = {"delta_apply_ms": writes["w5"]["requests"]["agg"][
        "phases_ms"].get("delta_apply"),
        "feed_upload_ms": {p: writes["w5"]["requests"][p]["phases_ms"]
                           .get("feed_upload") for p in ("agg", "sel")}}
    summary = {k: v for k, v in out.items() if k not in ("writes",)}
    summary["host_ms"] = host
    summary["apply_ms"] = {w: writes[w]["apply_ms"] for w in writes}
    summary["labels"] = {w: {p: writes[w]["requests"][p]["label"]
                             for p in ("agg", "sel")} for w in writes}
    summary["memo"] = {w: {p: {k: writes[w]["requests"][p]["memo"][k]
                               for k in ("dtypes", "hash_bounds",
                                         "arg_nbytes")}
                           for p in ("agg", "sel")} for w in writes}
    print("delta cell 6c-delta: " + json.dumps(summary, default=str),
          flush=True)
    shapes = {"w1": [(r1, r1 + 1)],
              "w2": [(a, a + DELTA_RUN_ROWS) for a in DELTA_RUNS],
              "w3": [(n, n + DELTA_INSERTS)]}
    del cell, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": "6c-delta", "launches": out["launches"],
            "shapes": shapes, "n_pad": out["pad_rows"]["n"],
            "host_ms": host, "scrub_ms": out["scrub_ms"],
            "memo": summary["memo"], "replica": out["replica"]}


def replica_feed_steps(cell, runner, model, ts: int) -> dict:
    """6c-delta's replica feed after w3's clean scrub: demote, read,
    promote, then a promotion with ``copr::replica_promote`` armed once and
    the one cold mint that follows (the cell's substituted build given
    version planes of the model's rows at ``ts``, as the engine now holds
    them)."""
    from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
    from tikv_tpu_torch.testing import mvcc as tm
    from tikv_tpu_torch.utils import failpoint
    sup = cell.sup
    out = {}

    def read(plan: str, label: str) -> dict:
        routes = dict(runner.feed_routes)
        builds = len(cell.builds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = cell.ep.handle(CopRequest(REQ_TYPE_DAG, cell.dag(plan, ts)))
        ms = (time.perf_counter() - t0) * 1e3
        if plan == "sel":
            ok = np.array_equal(resp.result.batch.columns[0].values,
                                model.truth("sel"))
        else:
            ok = sorted(resp.rows(), key=lambda r: r[2]) == \
                model.truth("agg")
        lab = resp.tracker.labels.get("device_feed")
        assert ok and resp.backend == "device", (plan, label, resp.backend)
        assert lab == label, (plan, lab, label)
        if label == "hit":
            assert runner.feed_routes == routes and \
                len(cell.builds) == builds, "a replica read built or uploaded"
        return {"ms": ms, "label": lab}

    sup.on_role_change(1, False)
    assert sup.demotions == 1 and cell.cache.region_resident(1) == 1
    out["demoted_read"] = {p: read(p, "hit") for p in ("agg", "sel")}
    planes = sum(len(f["digests"]) for f in runner.resident_feeds(
        cell.cache.get(cell.snap(cell.region), cell.dag("sel", ts))
    ).values())
    before = counts()["plane_digest"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sup.on_role_change(1, True)
    torch.cuda.synchronize()
    out["promote_ms"] = (time.perf_counter() - t0) * 1e3
    out["promote_planes"] = planes
    out["promote_digest_launches"] = counts()["plane_digest"] - before
    assert out["promote_digest_launches"] == planes == 5, out
    assert (sup.promotions, sup.promotion_rebuilds) == (1, 0)
    assert sup.last_promotion["divergences"] == 0
    out["promoted_read"] = {p: read(p, "hit") for p in ("agg", "sel")}
    # the forced rebuild: the build's version planes become the rows as
    # they stand at ts (w1-w3 applied)
    ones = np.ones(len(model.h), np.bool_)
    cell.planes, _th, _truth = tm.version_history(
        model.h, [tm.Event(ts - 5, tm.WT_PUT, np.arange(len(model.h)),
                           {2: (model.c0, ones), 3: (model.c1, ones)})],
        {2: 0, 3: 0}, ts, cell.table.table_id)
    cell.read_ts = ts
    sup.on_role_change(1, False)
    failpoint.cfg("copr::replica_promote", "1*return")
    try:
        sup.on_role_change(1, True)
    finally:
        failpoint.teardown()
    assert (sup.promotions, sup.promotion_rebuilds) == (2, 1)
    assert cell.cache.region_resident(1) == 0
    mints = counts()["mvcc_resolve"]
    out["rebuild_read"] = {"agg": read("agg", "device_resolve"),
                           "sel": read("sel", "upload")}
    out["rebuild_mint_launches"] = counts()["mvcc_resolve"] - mints
    assert out["rebuild_mint_launches"] > 0
    out["stats"] = {k: v for k, v in sup.stats().items()
                    if k in ("promotions", "promotion_rebuilds",
                             "demotions", "replica_feeds", "quarantines")}
    print("delta cell 6c-delta replica feed: " + json.dumps(out), flush=True)
    return out


TJ_ROWS = 1 << 20
TJ_PAGE = 4096


def run_tj(runner) -> dict:
    """Cell tj: a table with a JSON column (``configs.build_json_table``,
    2^20 rows: ``doc`` never reaches the card, and its Python documents
    cost host memory and time, so the cell is 2^20 rows where config 2 is
    10·2^20).  Each answer against its numpy truth, on its stated route:

    - tj1 on the card (``sel_pred``, ``hash_agg``; ``serve``: warm p50,
      the profile's idle share), through the endpoint too; its feed holds
      the same bytes as the same plan's over the table without ``doc``;
    - tj2, a JSON predicate: the runner refuses the plan, the endpoint
      answers on the host, no launch;
    - tj3, ANALYZE of every column: ``id``, ``k``, ``v`` by the ``analyze``
      kernel, ``doc`` by the host half;
    - tjp, tj1's selection alone, paged: pages of ``TJ_PAGE`` rows served
      on the host, followed to ``is_drained``, whose rows concatenate to
      the card's unpaged answer.
    Counts from 0 before the path, read after."""
    from tikv_tpu_torch.copr.analyze import AnalyzeReq
    from tikv_tpu_torch.copr.endpoint import (REQ_TYPE_DAG, CopRequest,
                                              Endpoint)
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.testing.dag import DagSelect
    t0 = time.perf_counter()
    n = TJ_ROWS
    table, snap, plain = cf.build_json_table(n)
    dags = {c: cf.dag_json(table, c) for c in cf.JSON_CELLS}
    out = {"config": "tj", "rows": n, "build_s": time.perf_counter() - t0}
    ep = Endpoint(lambda req: snap, runner, device_row_threshold=n)
    set_counts({k: 0 for k in KERNELS})
    launches = {k: 0 for k in KERNELS}

    def add(got: dict) -> None:
        for k, v in got.items():
            launches[k] += v

    # tj1: on the card
    want = cf.json_truth("tj1", snap)
    tj1 = serve("tj1", n, runner, dags["tj1"], snap,
                lambda r: sorted(r.rows(), key=lambda x: x[2]),
                lambda rows: rows == want, {"sel_pred", "hash_agg"},
                groups=len(want))
    add(tj1["launches"])
    set_counts({k: 0 for k in KERNELS})
    resp = ep.handle(CopRequest(REQ_TYPE_DAG, dags["tj1"]))
    assert resp.backend == "device" and \
        sorted(resp.rows(), key=lambda x: x[2]) == want, "tj1 via endpoint"
    assert runner.handle_request(dags["tj1"], plain).rows() == resp.rows()
    add(counts())
    feeds = [runner.resident_feeds(s) for s in (snap, plain)]
    assert list(feeds[0]) == list(feeds[1]) and all(
        4 not in key[1] for key in feeds[0]), "tj1's feed keys"
    for key, f in feeds[0].items():
        g = feeds[1][key]
        assert len(f["flat"]) == len(g["flat"]) and all(
            same_bits(a, b) for a, b in zip(f["flat"], g["flat"])), \
            "tj1's feed differs from the table's without doc"
    prof = tj1.pop("profile")
    out["tj1"] = {"warm_p50_ms": tj1["warm_p50_ms"],
                  "cold_ms": tj1["cold_ms"],
                  "idle_share": 1 - prof["device_ms"] / prof["wall_ms"],
                  "launches": {k: v for k, v in tj1["launches"].items()
                               if v}}
    # tj2: a JSON predicate, on the host
    assert not runner.supports(dags["tj2"])
    set_counts({k: 0 for k in KERNELS})
    t1 = time.perf_counter()
    resp = ep.handle(CopRequest(REQ_TYPE_DAG, dags["tj2"]))
    out["tj2"] = {"host_ms": (time.perf_counter() - t1) * 1e3,
                  "backend": resp.backend}
    assert resp.backend == "host" and sorted(
        resp.rows(), key=lambda x: x[1]) == cf.json_truth("tj2", snap), \
        "tj2: wrong answer or backend"
    assert not any(counts().values()), f"tj2 launched {counts()}"
    # tj3: ANALYZE of every column
    areq = AnalyzeReq(DagSelect.from_table(table).build().executors[0], (),
                      256)
    set_counts({k: 0 for k in KERNELS})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = ep.handle_analyze(areq)["columns"]
    out["tj3"] = {"ms": (time.perf_counter() - t1) * 1e3,
                  "phases_ms": dict(runner.analyze_phases_ms)}
    got = counts()
    assert got["analyze"] == 3 and not ep.degrades, (got, ep.degrades)
    add(got)
    t1 = time.perf_counter()
    batch = snap.scan_columns(areq.scan, ())
    want = [cf.column_stats_truth(info.col_id, col.values, col.validity,
                                  areq.buckets)
            for info, col in zip(areq.scan.columns[:3], batch.columns[:3])]
    want.append(cf.json_doc_stats_truth(snap, areq.buckets))
    out["tj3"]["truth_s"] = time.perf_counter() - t1
    assert stats_equal(stats[:3], want[:3]) and \
        repr(stats[3]) == repr(want[3]), "tj3: wrong statistics"
    # tjp: pages on the host against the card's unpaged answer
    set_counts({k: 0 for k in KERNELS})
    resp = ep.handle(CopRequest(REQ_TYPE_DAG, dags["tjp"]))
    assert resp.backend == "device"
    add(counts())
    whole = resp.result.batch
    ids = cf.json_truth("tjp", snap)
    assert np.array_equal(whole.columns[0].values, ids), "tjp: card answer"
    set_counts({k: 0 for k in KERNELS})
    pages, token = [], None
    t1 = time.perf_counter()
    while True:
        resp = ep.handle(CopRequest(REQ_TYPE_DAG, dags["tjp"],
                                    paging_size=TJ_PAGE,
                                    resume_token=token))
        assert resp.backend == "host"
        pages.append(resp.result.batch)
        token = resp.resume_token
        if resp.is_drained:
            break
        assert resp.result.batch.num_rows >= TJ_PAGE
    out["tjp"] = {"host_ms": (time.perf_counter() - t1) * 1e3,
                  "pages": len(pages), "rows": int(len(ids))}
    assert not any(counts().values()), "a paged request launched"
    for c in range(3):
        assert np.array_equal(
            np.concatenate([p.columns[c].values for p in pages]),
            whole.columns[c].values), "tjp: the pages differ"
    out["wall_s"] = time.perf_counter() - t0
    print("cell tj: " + json.dumps(out), flush=True)
    del snap, plain, batch, whole, pages
    gc.collect()
    return {"config": "tj", "launches": launches, **out}


INGEST_KEYS = 10 << 20         # 6c's region (bench.py:501-560)
INGEST_CHUNK = 1 << 20          # bench.py:448's SST chunk
INGEST_WARM = 5
SPILL_KEYS = 1 << 16
SPILL_EVERY = 10                # a tenth of the rows spill to CF_DEFAULT


def ingest_ask(ep, dag, want, label: str) -> dict:
    """One request through the endpoint, forced to the device → its ms
    (host clock), labels and phases (ms); the answer against ``want``."""
    from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp = ep.handle(CopRequest(REQ_TYPE_DAG, dag, force_backend="device"))
    got = sorted(map(list, resp.rows()), key=lambda r: r[2])
    ms = (time.perf_counter() - t0) * 1e3
    assert resp.backend == "device", (label, resp.backend)
    assert got == want, f"6c-ingest {label}: wrong answer"
    return {"ms": ms, "labels": dict(resp.tracker.labels),
            "phases_ms": {k: v / 1e6 for k, v in
                          resp.tracker.phases.items()}}


def run_ingest(runner) -> dict:
    """Cell 6c-ingest: config 6c's region (``bench.py:501-560``:
    ``int_table(2)``, ``c0 = h % 1024``, ``c1 = h % 1000``, one PUT a key,
    10·2^20 keys) bulk-loaded as ``bench.py:448``'s 2^20-key SST v2 blobs
    (``fast_mvcc_table_sst``), each applied through the apply path
    (``testing.mvcc.apply_ingest``) to one ``MemoryEngine`` region at a
    rising index while a ``ColdStreamBuilder`` on the card parses each
    chunk and appends its planes to the card.  Then GROUP BY c0: COUNT(*),
    SUM(c1), cold and ``INGEST_WARM`` warm, through three fresh caches, one
    after another, each freed before the next:

    - (a) the device rung fed by the stream: ``cold_build`` device, one
      take and no miss, planes already on the card (``h2d_bytes`` > 0, the
      mint's ``h2d`` 0), one mint, one ``mvcc_resolve`` launch and no
      ``feed_upload``;
    - (b) the device rung with no stream: the parse at build time
      (``mvcc_parse``), the planes uploaded at the mint;
    - (c) no resolver: the native rung (``cold_build`` native), the feed
      uploaded.

    Then a region of ``SPILL_KEYS`` keys where every ``SPILL_EVERY``-th row
    keeps its row in CF_DEFAULT (an unrequested 300-byte column) through
    the device rung: one ``patch_feed_rows`` launch writes the spilled
    rows, and the feed equals the upload of the host mirror bit for bit;
    a clean scrub of it (``plane_digest``); and CHECKSUM of its 2^16 rows
    through the native fold, equal to the Python fold.  Every answer
    equals the numpy truth.  Counts from 0 before the path, read after."""
    from tikv_tpu_torch.codec.keys import table_record_key
    from tikv_tpu_torch.codec.row import encode_row
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch import native
    from tikv_tpu_torch.copr import region_cache as rc
    from tikv_tpu_torch.copr.analyze import (ChecksumReq, checksum_kv_pairs,
                                             checksum_kv_pairs_plain)
    from tikv_tpu_torch.copr.endpoint import Endpoint
    from tikv_tpu_torch.copr.stream_build import ColdStreamBuilder
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.device.supervisor import DeviceStateSupervisor
    from tikv_tpu_torch.engine.memory import MemoryEngine
    from tikv_tpu_torch.raftstore.metapb import Region
    from tikv_tpu_torch.raftstore.observer import CoprocessorHost
    from tikv_tpu_torch.raftstore.peer import RegionSnapshot
    from tikv_tpu_torch.sst_importer import (build_sst_v2,
                                             fast_mvcc_table_sst, mvcc_sst)
    from tikv_tpu_torch.testing import mvcc as tm
    from tikv_tpu_torch.testing.dag import DagSelect
    t_start = time.perf_counter()
    table = tm.table_6c()
    tid = table.table_id
    resolver = runner.mvcc_resolver()
    engine, host = MemoryEngine(), CoprocessorHost()
    # the device leg is shed past half of max_bytes: room for the region's
    # planes (≈ 43 bytes a version on the card, 48 on the host)
    stream = ColdStreamBuilder(resolver, max_bytes=4 << 30)
    host.register(stream)
    out = {"config": "6c-ingest", "keys": INGEST_KEYS,
           "chunk_keys": INGEST_CHUNK}
    set_counts({k: 0 for k in KERNELS})
    t0 = time.perf_counter()
    native.module()             # g++ builds it at first use
    native_s = time.perf_counter() - t0
    build_s = apply_s = 0.0
    index = 100
    t0 = time.perf_counter()
    for lo in range(0, INGEST_KEYS, INGEST_CHUNK):
        h = np.arange(lo, lo + INGEST_CHUNK, dtype=np.int64)
        t1 = time.perf_counter()
        blob = fast_mvcc_table_sst(tid, h, [(2, h % 1024, None),
                                            (3, h % 1000, None)], tm.TS_6C)
        t2 = time.perf_counter()
        index += 1
        tm.apply_ingest(engine, host, 1, index, blob)
        build_s += t2 - t1
        apply_s += time.perf_counter() - t2
        del blob
    t1 = time.perf_counter()
    assert stream.wait_idle(600.0), "the stream did not drain"
    torch.cuda.synchronize()
    out["load_s"] = {"native_module_build": native_s,
                     "total": time.perf_counter() - t0, "sst_build": build_s,
                     "apply": apply_s,
                     "stream_drain": time.perf_counter() - t1}
    st = stream.stats()
    assert st["chunks_parsed"] == INGEST_KEYS // INGEST_CHUNK and \
        st["regions"][1]["device"] and st["h2d_bytes"] > 0, st
    hs = np.arange(INGEST_KEYS, dtype=np.int64)
    want = [[int(c), int(s_), g] for g, (c, s_) in enumerate(zip(
        np.bincount(hs % 1024, minlength=1024),
        np.bincount(hs % 1024, weights=hs % 1000, minlength=1024)))]
    del hs
    sel = DagSelect.from_table(table, ["id", "c0", "c1"])
    dag = dag_from_wire(enc_dag(sel.aggregate(
        [sel.col("c0")], [("count_star", None), ("sum", sel.col("c1"))])
        .build(tm.READ_TS_6C)))

    def read(name: str, res, src) -> dict:
        cache = rc.RegionColumnarCache()
        cache.device_resolver, cache.stream_source = res, src
        sup = DeviceStateSupervisor(runner, cache)

        def provider(req):
            rs = RegionSnapshot(engine.snapshot(), Region(1))
            rs.data_index = index
            return cache.get(rs, req.dag)

        ep = Endpoint(provider, runner)
        mints = resolver.mints
        cold = ingest_ask(ep, dag, want, f"({name}) cold")
        mint = dict(resolver.phases_ms) if resolver.mints > mints else {}
        warm = [ingest_ask(ep, dag, want, f"({name}) warm")["ms"]
                for _ in range(INGEST_WARM)]
        cache.invalidate_region(1)      # its feeds go with its line
        del sup, cache, ep
        gc.collect()
        torch.cuda.empty_cache()
        return {"cold_ms": cold["ms"], "labels": cold["labels"],
                "phases_ms": cold["phases_ms"], "mint_ms": mint,
                "mints": resolver.mints - mints,
                "warm_ms": warm, "warm_p50_ms": float(np.median(warm))}

    before = counts()
    a = read("a", resolver, stream)
    launched = {k: v - before[k] for k, v in counts().items()}
    assert a["labels"]["cold_build"] == "device" and \
        a["labels"]["device_feed"] == "device_resolve", a["labels"]
    assert "stream_take" in a["phases_ms"] and \
        "mvcc_parse" not in a["phases_ms"] and \
        "feed_upload" not in a["phases_ms"], a["phases_ms"]
    st = stream.stats()
    assert (st["takes"], st["take_misses"]) == (1, 0), st
    out["stream"] = {k: v for k, v in st.items() if k != "regions"}
    assert a["mints"] == 1 and a["mint_ms"]["h2d"] == 0.0, a
    assert launched["mvcc_resolve"] == 1, launched
    a["launches"] = {k: v for k, v in launched.items() if v}
    stream.stop()
    b = read("b", resolver, None)
    assert b["labels"]["cold_build"] == "device" and \
        "mvcc_parse" in b["phases_ms"] and b["mints"] == 1, b
    c = read("c", None, None)
    assert c["labels"]["cold_build"] == "native" and \
        c["labels"]["device_feed"] == "upload" and \
        "feed_upload" in c["phases_ms"], c
    out["reads"] = {"a": a, "b": b, "c": c}
    del engine, host, stream
    gc.collect()

    # the spill region: a tenth of the rows past the short-value limit
    t0 = time.perf_counter()
    h = np.arange(SPILL_KEYS, dtype=np.int64)
    rows = [(table_record_key(tid, int(x)), encode_row(
        {2: int(x) % 1024, 3: int(x) % 1000, **(
            {4: b"B" * 300} if x % SPILL_EVERY == 0 else {})}))
        for x in h]
    by_cf: dict = {}
    for cf, k, v in sorted(mvcc_sst(rows, tm.TS_6C)._pairs):
        got = by_cf.setdefault(cf, ([], []))
        got[0].append(k)
        got[1].append(v)
    engine, host = MemoryEngine(), CoprocessorHost()
    tm.apply_ingest(engine, host, 2, 100, build_sst_v2(by_cf))
    out["spill_load_s"] = time.perf_counter() - t0
    cache = rc.RegionColumnarCache()
    cache.device_resolver = resolver
    sup = DeviceStateSupervisor(runner, cache)

    def snap():
        rs = RegionSnapshot(engine.snapshot(), Region(2))
        rs.data_index = 100
        return rs

    ep = Endpoint(lambda req: cache.get(snap(), req.dag), runner)
    swant = [[int(c_), int(s_), g] for g, (c_, s_) in enumerate(zip(
        np.bincount(h % 1024, minlength=1024),
        np.bincount(h % 1024, weights=h % 1000, minlength=1024)))]
    patched = counts()["patch_rows"]
    spill = ingest_ask(ep, dag, swant, "spill")
    spill["patch_rows_launches"] = counts()["patch_rows"] - patched
    assert spill["labels"]["cold_build"] == "device" and \
        spill["patch_rows_launches"] == 1, spill
    served = cache.get(snap(), dag)
    feed_key, feed = only_feed(runner, served)
    infos = dag.executors[0].columns
    n = len(served._tbl)
    host_planes = []
    for col_id, ds in zip(feed_key[1], feed_key[2]):
        info = next(i for i in infos if i.col_id == col_id)
        if info.is_pk_handle:
            v, ok = served._tbl.handles, np.ones(n, np.bool_)
        else:
            col = served._tbl.columns[col_id]
            v, ok = col.values, col.validity
        host_planes.append((np.ascontiguousarray(v.astype(ds)), ok))
    saved = counts()
    up = runner._build_flat(host_planes, n)
    set_counts(saved)
    spill["feed_planes_differ"] = feed_diff(feed, up)
    assert spill["feed_planes_differ"] == 0, "the spill feed differs"
    spill["spilled_rows"] = SPILL_KEYS // SPILL_EVERY
    del up, feed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clean = sup.scrub()
    spill["scrub_ms"] = (time.perf_counter() - t0) * 1e3
    assert clean["divergences"] == 0 and clean["lines"] == 1, clean
    # CHECKSUM of the region's 2^16 rows: the native fold and the Python one
    pairs = served.to_kv_pairs()
    keys, vals = [k for k, _ in pairs], [v for _, v in pairs]
    t0 = time.perf_counter()
    native = checksum_kv_pairs(keys, vals)
    fold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = checksum_kv_pairs_plain(keys, vals)
    plain_ms = (time.perf_counter() - t0) * 1e3
    areq = ChecksumReq(dag.executors[0], dag.ranges, tm.READ_TS_6C)
    t0 = time.perf_counter()
    via_ep = ep.handle_checksum(areq)
    ep_ms = (time.perf_counter() - t0) * 1e3
    assert native == plain == via_ep and \
        native["total_kvs"] == SPILL_KEYS, (native, plain, via_ep)
    out["checksum"] = {"rows": SPILL_KEYS, "fold_ms": fold_ms,
                       "plain_ms": plain_ms, "endpoint_ms": ep_ms}
    out["spill"] = spill
    launches = counts()
    for name in ("mvcc_resolve", "hash_agg", "patch_rows", "plane_digest"):
        assert launches[name] > 0, f"6c-ingest never launched {name}"
    out["launches"] = launches
    cache.invalidate_region(2)
    del sup, cache, ep, served, engine, host, rows, by_cf
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_start
    print("ingest cell 6c-ingest: " + json.dumps(out, default=str),
          flush=True)
    return {"config": "6c-ingest", "launches": launches,
            "load_s": out["load_s"], "reads": {
                k: {x: r[x] for x in ("cold_ms", "warm_p50_ms", "phases_ms",
                                      "mint_ms")}
                for k, r in out["reads"].items()},
            "checksum": out["checksum"], "wall_s": out["wall_s"]}


SRV_KEYS = INGEST_KEYS          # 6c's region, one region of 10 GiB
SRV_CHUNK = INGEST_CHUNK        # bench.py:448's SST chunk
SRV_PART = 4 << 20              # ImportUpload's part
SRV_WARM = 5
SRV_BUCKETS = 256               # TiDB's ANALYZE buckets
SRV_BATCH = 64
SRV_SCAN = 1000
SRV_CHECKSUM = 1 << 16
# partitioned-raft-kv's region size (TiKV's configuration documentation:
# coprocessor.region-split-size 10 GiB, region-max-size 15 GiB)
SRV_SPLIT_MB = 10 << 10
SRV_MAX_MB = 15 << 10


def srv_call(svc, method: str, req: dict, raw: bool = True) -> tuple:
    """One request through ``KvService`` (packed bytes through
    ``handle_raw``, or the dict through ``handle``) → (response, ms on
    the host clock, a fast-path hit's packed answer unpacked within it);
    an error response raises."""
    from tikv_tpu_torch.server import wire
    body = wire.pack(req) if raw else req
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp = svc.handle_raw(method, body) if raw else svc.handle(method, body)
    if isinstance(resp, bytes):
        resp = wire.unpack(resp)
    ms = (time.perf_counter() - t0) * 1e3
    assert isinstance(resp, dict) and not resp.get("error"), \
        (method, resp.get("error") if isinstance(resp, dict) else resp)
    return resp, ms


def srv_logical_pairs(tid: int, h, c0, c1) -> tuple:
    """The logical KV pairs of rows (``h``, ``c0``, ``c1``) — record key,
    ``encode_row({2: c0, 3: c1})`` — built with numpy, independently of
    the store (CHECKSUM folds XOR, so the pairs may come in any order):
    → (keys, values) lists of bytes."""
    sign = np.uint64(1 << 63)
    n = len(h)
    key = np.empty((n, 19), np.uint8)
    key[:, 0] = ord("t")
    key[:, 1:9] = np.frombuffer(
        ((tid + (1 << 63)) % (1 << 64)).to_bytes(8, "big"), np.uint8)
    key[:, 9], key[:, 10] = ord("_"), ord("r")
    key[:, 11:] = (h.astype(np.uint64) ^ sign).astype(">u8").view(
        np.uint8).reshape(n, 8)

    def packed(v):
        """msgpack's positive fixint / uint8 / uint16 forms of ``v``."""
        w = np.where(v < 128, 1, np.where(v < 256, 2, 3))
        out = np.zeros((len(v), 3), np.uint8)
        out[w == 1, 0] = v[w == 1]
        out[w == 2, 0], out[w == 2, 1] = 0xCC, v[w == 2]
        out[w == 3, 0] = 0xCD
        out[w == 3, 1], out[w == 3, 2] = v[w == 3] >> 8, v[w == 3] & 0xFF
        return out, w

    p0, w0 = packed(np.asarray(c0, np.int64))
    p1, w1 = packed(np.asarray(c1, np.int64))
    keys, vals = [], []
    for a in (1, 2, 3):
        for b in (1, 2, 3):
            sel = (w0 == a) & (w1 == b)
            m = int(sel.sum())
            if not m:
                continue
            row = np.empty((m, 3 + a + b), np.uint8)
            row[:, 0], row[:, 1] = 0x82, 0x02
            row[:, 2:2 + a] = p0[sel, :a]
            row[:, 2 + a] = 0x03
            row[:, 3 + a:] = p1[sel, :b]
            kb, vb, vw = key[sel].tobytes(), row.tobytes(), 3 + a + b
            keys += [kb[i:i + 19] for i in range(0, len(kb), 19)]
            vals += [vb[i:i + vw] for i in range(0, len(vb), vw)]
    return keys, vals


def run_srv(runner) -> dict:
    """Cell srv: the port's store in process on the card — ``Node`` over
    ``MockPd`` with the port's ``DeviceRunner()`` and ``KvService``, every
    request a user's RPC body.  The region's size is partitioned-raft-kv's
    (TiKV's configuration documentation, ``coprocessor.region-split-size``
    10 GiB and ``region-max-size`` 15 GiB when ``storage.engine`` is
    ``partitioned-raft-kv``): the drive loop's split checker scans the
    loaded region and leaves it whole.  The config's other defaults:
    coalescer window 2 ms, ``device_row_threshold`` 131072.

    1. load: ``ImportSwitchMode(True)``; 6c's table (``int_table(2)``,
       ``c0 = h % 1024``, ``c1 = h % 1000``, 10·2^20 keys) as ten 2^20-key
       SST v2 blobs (``fast_mvcc_table_sst``), each through
       ``ImportUpload`` (4 MiB parts) and ``ImportIngest(region_id=1)`` —
       one raft entry a blob, applied while the node's
       ``ColdStreamBuilder`` parses and uploads each chunk —, then
       ``ImportSwitchMode(False)``; the load's time by part and the host's
       RSS after it (the raft log keeps the blobs); then the wait for the
       drive loop's split checker, whose first pass out of import mode
       scans the region (its approximate size and buckets printed; no
       split at 10 GiB);
    2. read: GROUP BY c0: COUNT(*), SUM(c1) and the rows of ``c1 > 990``,
       packed (``wire.pack``) through ``handle_raw("Coprocessor")``, cold
       + 5 warm each: ``backend`` device, the numpy truth (every returned
       row ``(id, c0, c1)`` of the selection), the cold build's rung (the
       stream's take);
    3. write: one transaction of 4,096 UPDATEs of c1 in 4 runs of 1,024
       handles (6c-delta's w2) through ``KvPrewrite`` and ``KvCommit`` at
       ``MockPd.tso()`` timestamps; both plans again: device, the new
       truth, the feed patched in place (``feed_routes`` one patch, no
       upload; no second ``mvcc_resolve``);
    4. point reads: ``KvGet`` of an updated key, ``KvBatchGet`` of 64
       keys, ``KvScan`` of 1,000 keys, against the model;
    5. ANALYZE (tp 104, 256 buckets; ``analyze`` launches) of the region
       and CHECKSUM (tp 105) of 2^16 rows around the first updated run,
       against numpy truths (the CHECKSUM truth: the native fold over the
       model's logical pairs, built apart from the store); one
       GROUP BY with ``force_backend="host"``: the same answer, ``backend``
       host;
    6. split and merge through raft: ``SplitRegion`` at handle 5·2^20
       through ``KvService.handle``; the node's raft apply splits the
       region and its supervisor slices the resident feeds with
       ``split_planes`` (two children × two feeds: no ``mvcc_resolve``, no
       upload, ``split_fallbacks`` 0); both plans on each child, cold + 2
       warm through ``handle_raw`` with the child's range, each against
       the numpy truth over its handles (step 3's write included; the
       children's first requests take the sliced feeds); then
       ``MergeRegion`` back: both children's lines drop, and the merged
       region's next read mints once (``mvcc_resolve``) and equals the
       truth; the split's phases (``split_lines``, ``device_split``), the
       merge in ms and the launches printed;
    7. ``node.stop()``: no thread of the node left, the arena pin-free and
       empty.

    Counts from 0 before the path, read after."""
    import threading

    from tikv_tpu_torch.codec.keys import table_record_key
    from tikv_tpu_torch.codec.row import decode_row, encode_row
    from tikv_tpu_torch.config import TikvConfig
    from tikv_tpu_torch.copr.analyze import checksum_kv_pairs
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.pd.client import MockPd
    from tikv_tpu_torch.server.node import Node
    from tikv_tpu_torch.server.service import KvService
    from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.testing import mvcc as tm
    from tikv_tpu_torch.testing.dag import DagSelect
    t_start = time.perf_counter()
    table = tm.table_6c()
    tid = table.table_id
    cfg = TikvConfig()
    cfg.raftstore.region_split_size_mb = SRV_SPLIT_MB
    cfg.raftstore.region_max_size_mb = SRV_MAX_MB
    cfg.validate()
    pd = MockPd()
    threads_before = {t.ident for t in threading.enumerate()}
    set_counts({k: 0 for k in KERNELS})
    node = Node("srv:0", pd, device_runner=runner, config=cfg)
    node.start()
    svc = KvService(node)
    out = {"config": "srv", "keys": SRV_KEYS, "chunk_keys": SRV_CHUNK,
           "part_bytes": SRV_PART}
    model = DeltaModel(SRV_KEYS)
    try:
        # -- 1. load --------------------------------------------------
        assert node.cold_stream is not None, "no cold stream on the node"
        srv_call(svc, "ImportSwitchMode", {"import": True}, raw=False)
        load_ts = pd.tso()
        build_s = upload_s = ingest_s = 0.0
        blob_bytes = 0
        t0 = time.perf_counter()
        for lo in range(0, SRV_KEYS, SRV_CHUNK):
            h = np.arange(lo, lo + SRV_CHUNK, dtype=np.int64)
            t1 = time.perf_counter()
            blob = fast_mvcc_table_sst(tid, h, [(2, h % 1024, None),
                                                (3, h % 1000, None)],
                                       load_ts)
            t2 = time.perf_counter()
            uuid = f"srv-{lo}"
            parts = -(-len(blob) // SRV_PART)
            for i in range(parts):
                resp, _ = srv_call(svc, "ImportUpload", {
                    "uuid": uuid, "seq": i, "total": parts,
                    "data": blob[i * SRV_PART:(i + 1) * SRV_PART]},
                    raw=False)
            assert resp["staged"] is True, resp
            t3 = time.perf_counter()
            resp, _ = srv_call(svc, "ImportIngest",
                               {"uuid": uuid, "region_id": 1}, raw=False)
            assert resp["ingested"] == SRV_CHUNK, resp
            build_s += t2 - t1
            upload_s += t3 - t2
            ingest_s += time.perf_counter() - t3
            blob_bytes += len(blob)
            del blob
        t1 = time.perf_counter()
        assert node.cold_stream.wait_idle(600.0), "the stream did not drain"
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t1
        srv_call(svc, "ImportSwitchMode", {"import": False}, raw=False)
        # out of import mode, the drive loop's split checker scans the
        # loaded region (its size_diff_hint is past region_split_check_
        # diff) under the node lock, and leaves it whole at 10 GiB: wait
        # for that pass, so that the reads below do not share the host
        # with it
        t1 = time.perf_counter()
        while True:
            with node.lock:
                peer = node.raft_store.region_peer(1)
                checked = (peer.approximate_size, len(peer.buckets),
                           len(node.raft_store.peers))
            if checked[0]:
                break
            assert time.perf_counter() - t1 < 120, "no split check ran"
            time.sleep(0.01)
        assert checked[2] == 1, f"srv: the checker split the region {checked}"
        out["split_check"] = {"wait_s": time.perf_counter() - t1,
                              "approximate_size": checked[0],
                              "buckets": checked[1]}
        rss = rss_bytes()
        out["load_s"] = {"total": time.perf_counter() - t0,
                         "sst_build": build_s, "upload": upload_s,
                         "propose_apply": ingest_s, "stream_drain": drain_s}
        out["blob_bytes"] = blob_bytes
        out["host_rss_bytes_after_load"] = rss
        st = node.cold_stream.stats()
        assert st["chunks_parsed"] == SRV_KEYS // SRV_CHUNK, st
        print(f"srv load: {json.dumps(out['load_s'])} rss "
              f"{rss / 2**30:.2f} GiB blobs {blob_bytes / 2**20:.1f} MiB; "
              f"split check {json.dumps(out['split_check'])}", flush=True)

        # -- 2. read --------------------------------------------------
        def dag(plan: str, ts: int, force=None) -> dict:
            s = DagSelect.from_table(table, ["id", "c0", "c1"])
            if plan == "sel":
                d = s.where(s.col("c1") > 990)
            else:
                d = s.aggregate([s.col("c0")], [("count_star", None),
                                                ("sum", s.col("c1"))])
            req = {"dag": enc_dag(d.build(ts))}
            if force is not None:
                req["force_backend"] = force
            return req

        def ask(plan: str, backend: str = "device", force=None) -> dict:
            resp, ms = srv_call(svc, "Coprocessor",
                                dag(plan, pd.tso(), force))
            assert resp["backend"] == backend, (plan, resp["backend"])
            if plan == "sel":
                # every returned row (id, c0, c1) against the model's rows
                # at its mask
                got = np.asarray(resp["rows"], np.int64).reshape(-1, 3)
                m = model.c1 > 990
                assert np.array_equal(got, np.stack(
                    [model.h[m], model.c0[m], model.c1[m]], 1)), \
                    "srv: wrong selection"
            else:
                got = sorted(map(tuple, resp["rows"]), key=lambda r: r[2])
                assert got == model.truth("agg"), "srv: wrong GROUP BY"
            td = resp["time_detail"]
            return {"ms": ms, "labels": td["labels"],
                    "phases_ms": td["phases_ms"], "rows": len(resp["rows"])}

        resolver = node.copr_cache.device_resolver
        routes0 = dict(runner.feed_routes)
        reads = {}
        for plan in ("agg", "sel"):
            cold = ask(plan)
            warm = [ask(plan)["ms"] for _ in range(SRV_WARM)]
            reads[plan] = {"cold_ms": cold["ms"], "labels": cold["labels"],
                           "phases_ms": cold["phases_ms"],
                           "rows": cold["rows"], "warm_ms": warm,
                           "warm_p50_ms": float(np.median(warm))}
        # the cache's rung rides the request's labels and phases; the
        # feed's route is the runner's (a coalesced dispatch runs on the
        # coalescer's thread): the GROUP BY's feed minted from the
        # stream's planes, the selection's (its own planes) uploaded from
        # the line's host mirror
        lab = reads["agg"]["labels"]
        assert lab.get("cold_build") == "device", lab
        assert "stream_take" in reads["agg"]["phases_ms"] and \
            "mvcc_parse" not in reads["agg"]["phases_ms"], \
            reads["agg"]["phases_ms"]
        routes = {k: v - routes0.get(k, 0)
                  for k, v in runner.feed_routes.items()
                  if v - routes0.get(k, 0)}
        assert routes == {"device_resolve": 1, "upload": 1}, routes
        out["feed_routes"] = routes
        st = node.cold_stream.stats()
        assert (st["takes"], st["take_misses"]) == (1, 0), st
        out["stream"] = {k: v for k, v in st.items() if k != "regions"}
        out["mints"] = resolver.mints
        assert resolver.mints == 1, resolver.mints
        out["reads"] = reads
        read_launches = counts()
        assert read_launches["mvcc_resolve"] == 1, read_launches
        print("srv reads: " + " ".join(
            f"{p}: cold {r['cold_ms']:.2f} ms warm p50 "
            f"{r['warm_p50_ms']:.3f} ms" for p, r in reads.items()) +
            f"; rung {lab.get('cold_build')}, feed {json.dumps(routes)}; "
            f"launches {json.dumps({k: v for k, v in read_launches.items() if v})}",
            flush=True)

        # -- 3. write: one 2PC transaction of 6c-delta's w2 -------------
        hs = np.concatenate([np.arange(a, a + DELTA_RUN_ROWS)
                             for a in DELTA_RUNS])
        c1 = (hs * 7 + 1) % 1000
        muts = [{"op": "put", "key": table_record_key(tid, int(x)),
                 "value": encode_row({2: int(x) % model.groups,
                                      3: int(y)})}
                for x, y in zip(hs.tolist(), c1.tolist())]
        routes_w = dict(runner.feed_routes)
        spans0 = counts()["patch_spans"]
        start = pd.tso()
        _, prewrite_ms = srv_call(svc, "KvPrewrite", {
            "mutations": muts, "primary": muts[0]["key"],
            "start_version": start})
        resp, commit_ms = srv_call(svc, "KvCommit", {
            "keys": [m["key"] for m in muts], "start_version": start,
            "commit_version": pd.tso()})
        model.update(hs, c1)
        after = {p: ask(p) for p in ("agg", "sel")}
        first = after["agg"]
        assert first["labels"].get("copr_cache") == "delta", \
            first["labels"]
        assert "feed_upload" not in first["phases_ms"] and \
            "columnar_build" not in first["phases_ms"], first["phases_ms"]
        # each plan's feed patched in place: one patch a feed, no upload
        now = dict(runner.feed_routes)
        assert now.get("patch", 0) == routes_w.get("patch", 0) + 2 and \
            now.get("upload", 0) == routes_w.get("upload", 0), \
            (routes_w, now)
        assert counts()["mvcc_resolve"] == 1, "a second mint"
        assert counts()["patch_spans"] - spans0 == 2, counts()
        assert resolver.mints == 1, resolver.mints
        out["write"] = {"rows": len(muts), "prewrite_ms": prewrite_ms,
                        "commit_ms": commit_ms,
                        "first_read_ms": first["ms"],
                        "first_read_phases_ms": first["phases_ms"],
                        "sel_after_ms": after["sel"]["ms"],
                        "feed_routes": now}
        print(f"srv write: prewrite {prewrite_ms:.1f} ms commit "
              f"{commit_ms:.1f} ms, first GROUP BY after it "
              f"{first['ms']:.2f} ms (delta_apply "
              f"{first['phases_ms'].get('delta_apply', 0):.2f}, "
              f"feed_patch {first['phases_ms'].get('feed_patch', 0):.2f}), "
              f"selection {after['sel']['ms']:.2f} ms", flush=True)

        # -- 4. point reads -------------------------------------------
        def row_of(hh: int) -> dict:
            return {2: int(model.c0[hh]), 3: int(model.c1[hh])}

        k0 = int(hs[0])
        resp, get_ms = srv_call(svc, "KvGet", {
            "key": table_record_key(tid, k0), "version": pd.tso()})
        assert decode_row(resp["value"]) == row_of(k0), resp
        rng = np.random.default_rng(26)
        pick = np.concatenate([rng.choice(hs, SRV_BATCH // 2, False),
                               rng.choice(SRV_KEYS, SRV_BATCH // 2, False)])
        resp, batch_ms = srv_call(svc, "KvBatchGet", {
            "keys": [table_record_key(tid, int(x)) for x in pick],
            "version": pd.tso()})
        assert [decode_row(p["value"]) for p in resp["pairs"]] == \
            [row_of(int(x)) for x in pick], "srv: KvBatchGet"
        lo = DELTA_RUNS[0] - SRV_SCAN // 2
        resp, scan_ms = srv_call(svc, "KvScan", {
            "start_key": table_record_key(tid, lo), "limit": SRV_SCAN,
            "version": pd.tso()})
        assert [p["key"] for p in resp["pairs"]] == \
            [table_record_key(tid, x) for x in range(lo, lo + SRV_SCAN)]
        assert [decode_row(p["value"]) for p in resp["pairs"]] == \
            [row_of(x) for x in range(lo, lo + SRV_SCAN)], "srv: KvScan"
        out["point_ms"] = {"get": get_ms, "batch_get": batch_ms,
                           "scan": scan_ms}

        # -- 5. ANALYZE, CHECKSUM, a forced host read ------------------
        full = enc_dag(DagSelect.from_table(table).build(pd.tso()))
        before = counts()["analyze"]
        resp, analyze_ms = srv_call(svc, "Coprocessor", {
            "tp": 104, "dag": full, "buckets": SRV_BUCKETS})
        assert counts()["analyze"] - before == 3, counts()["analyze"]
        ones = np.ones(SRV_KEYS, np.bool_)
        want = [cf.column_stats_truth(c, v, ones, SRV_BUCKETS)
                for c, v in ((1, model.h), (2, model.c0), (3, model.c1))]
        assert resp["columns"] == [
            {"col_id": s.col_id, "total": s.total,
             "null_count": s.null_count, "distinct": s.distinct,
             "buckets": [[b, c] for b, c in s.buckets]} for s in want], \
            "srv: wrong ANALYZE"
        # CHECKSUM of 2^16 rows around the first updated run (the host
        # re-encodes each row of the range: the whole region would take
        # minutes)
        lo = DELTA_RUNS[0] - SRV_CHECKSUM // 2
        part = enc_dag(DagSelect.from_table(table).build(pd.tso()))
        part["ranges"] = [{"s": table_record_key(tid, lo),
                           "e": table_record_key(tid, lo + SRV_CHECKSUM)}]
        resp, checksum_ms = srv_call(svc, "Coprocessor",
                                     {"tp": 105, "dag": part})
        t0 = time.perf_counter()
        at = slice(lo, lo + SRV_CHECKSUM)
        keys, vals = srv_logical_pairs(tid, model.h[at], model.c0[at],
                                       model.c1[at])
        truth = checksum_kv_pairs(keys, vals)
        truth_s = time.perf_counter() - t0
        del keys, vals
        got = {k: resp[k] for k in ("checksum", "total_kvs", "total_bytes")}
        assert got == truth and truth["total_kvs"] == SRV_CHECKSUM, \
            (got, truth)
        host = ask("agg", backend="host", force="host")
        out["other_ms"] = {"analyze": analyze_ms, "checksum": checksum_ms,
                           "checksum_rows": SRV_CHECKSUM,
                           "checksum_truth_s": truth_s,
                           "group_by_on_host": host["ms"]}
        assert node.device_runner.hbm_stats()["pinned_lines"] == 0

        # -- 6. split and merge through raft --------------------------
        out["split_merge"] = srv_split_merge(node, svc, runner, model,
                                             pd, table, dag, ask)
    finally:
        # -- 7. stop ----------------------------------------------------
        t0 = time.perf_counter()
        node.stop()
        out["stop_ms"] = (time.perf_counter() - t0) * 1e3
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    assert not left, f"srv: threads left after stop: {left}"
    hbm = runner.hbm_stats()
    assert hbm["pinned_lines"] == 0 and hbm["resident_lines"] == 0, hbm
    launches = counts()
    for name in ("hash_agg", "sel_pred", "sel_compact", "mvcc_resolve",
                 "patch_spans", "analyze"):
        assert launches[name] > 0, f"srv never launched {name}"
    out["launches"] = launches
    del node, svc, model
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_start
    print("srv cell: " + json.dumps(out, default=str), flush=True)
    return {"config": "srv", "launches": launches, "load_s": out["load_s"],
            "reads": {p: {x: r[x] for x in ("cold_ms", "warm_p50_ms")}
                      for p, r in out["reads"].items()},
            "write": {k: out["write"][k] for k in
                      ("prewrite_ms", "commit_ms", "first_read_ms")},
            "wall_s": out["wall_s"]}


def srv_split_merge(node, svc, runner, model, pd, table, dag, ask) -> dict:
    """Step 6 of cell srv (``run_srv``): ``SplitRegion`` at handle
    ``SRV_KEYS // 2``, both plans on each child, ``MergeRegion`` back, the
    merged region's read → the figures."""
    from tikv_tpu_torch.codec.keys import table_record_key
    tid = table.table_id
    mid = SRV_KEYS // 2
    sup = node.device_supervisor
    resolver = node.copr_cache.device_resolver
    c0, routes0, mints0 = counts(), dict(runner.feed_routes), resolver.mints
    splits0 = (sup.splits, sup.split_fallbacks)
    resp, split_ms = srv_call(svc, "SplitRegion", {
        "split_key": table_record_key(tid, mid)}, raw=False)
    right = resp["right"]["id"]
    assert (sup.splits - splits0[0], sup.split_fallbacks - splits0[1]) == \
        (1, 0), (sup.splits, sup.split_fallbacks)
    split_phases = dict(sup.split_phases_ms)
    launches = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
    # two children × two feeds (the GROUP BY's and the selection's)
    assert launches == {"split_planes": 4}, launches

    def ask_range(plan: str, lo: int, hi: int) -> dict:
        """``plan`` over handles [lo, hi) → the request's figures; the
        answer against the model's rows in the range."""
        rng = {"s": table_record_key(tid, lo), "e": table_record_key(tid, hi)}
        req = dag(plan, pd.tso())
        req["dag"]["ranges"] = [rng]
        resp, ms = srv_call(svc, "Coprocessor", req)
        assert resp["backend"] == "device", (plan, resp["backend"])
        m = (model.h >= lo) & (model.h < hi)
        if plan == "sel":
            got = np.asarray(resp["rows"], np.int64).reshape(-1, 3)
            m &= model.c1 > 990
            assert np.array_equal(got, np.stack(
                [model.h[m], model.c0[m], model.c1[m]], 1)), \
                f"srv: wrong selection on [{lo}, {hi})"
        else:
            got = sorted(map(tuple, resp["rows"]), key=lambda r: r[2])
            cnt = np.bincount(model.c0[m], minlength=model.groups)
            sm = np.bincount(model.c0[m], weights=model.c1[m].astype(
                np.float64), minlength=model.groups)
            assert got == [(int(cnt[g]), int(sm[g]), g)
                           for g in range(model.groups) if cnt[g]], \
                f"srv: wrong GROUP BY on [{lo}, {hi})"
        return {"ms": ms, "labels": resp["time_detail"]["labels"]}

    children = {}
    for name, lo, hi in (("left", 0, mid), ("right", mid, SRV_KEYS)):
        for plan in ("agg", "sel"):
            runs = [ask_range(plan, lo, hi) for _ in range(3)]
            children[f"{name} {plan}"] = {
                "cold_ms": runs[0]["ms"],
                "warm_ms": [r["ms"] for r in runs[1:]]}
    routes = {k: v - routes0.get(k, 0) for k, v in runner.feed_routes.items()
              if v - routes0.get(k, 0)}
    # each child's first request of each plan took its sliced feed
    assert routes == {"split": 4}, routes
    assert counts()["mvcc_resolve"] == c0["mvcc_resolve"] and \
        resolver.mints == mints0, "a child minted"
    inv0 = sup.lifecycle_invalidations
    resp, merge_ms = srv_call(svc, "MergeRegion", {
        "source_id": right, "target_id": 1}, raw=False)
    assert (resp["region"]["start"], resp["region"]["end"]) == (b"", b"")
    dropped = sup.lifecycle_invalidations - inv0
    assert dropped >= 2 and node.copr_cache.region_resident(right) == 0, \
        (dropped, node.copr_cache.region_resident(right))
    with node.lock:
        assert right not in node.raft_store.peers
    c1 = counts()
    merged = {plan: ask(plan) for plan in ("agg", "sel")}
    assert counts()["mvcc_resolve"] - c1["mvcc_resolve"] == 1, \
        "the merged region did not mint once"
    assert resolver.mints == mints0 + 1, resolver.mints
    launches = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
    out = {"split_ms": split_ms, "split_phases_ms": split_phases,
           "runner_split_phases_ms": dict(runner.split_phases_ms),
           "children": children, "feed_routes": routes,
           "merge_ms": merge_ms, "lines_dropped": dropped,
           "merged_cold_ms": {p: r["ms"] for p, r in merged.items()},
           "launches": launches}
    print(f"srv split/merge: split {split_ms:.1f} ms "
          f"{json.dumps(split_phases)}, children cold "
          + " ".join(f"{k} {v['cold_ms']:.1f}" for k, v in children.items())
          + f" ms; merge {merge_ms:.1f} ms, merged cold "
          f"{merged['agg']['ms']:.1f} / {merged['sel']['ms']:.1f} ms; "
          f"launches {json.dumps(launches)}", flush=True)
    return out


RS3_KEYS = 1 << 22              # 6c's table, about 240 MiB of it
RS3_BLOBS = 4                   # 2^20 keys a blob (bench.py:448's chunk)
RS3_WARM = 2


class Rs3:
    """Cell rs3's rig: the port's ``Cluster(n_stores=3, seed=0)`` at TiKV's
    classic raft-kv defaults (the port's ``RaftstoreConfig``: region-split
    -size 96 MiB, region-max-size 144 MiB; PD's 3 replicas), stores 1 and
    2 each with a ``DeltaSink``, a ``RegionColumnarCache`` with the device
    rung of the cold build, a ``DeviceStateSupervisor`` on the store's
    coprocessor host and a ``DeviceRunner()`` of its own on ``cuda:0``;
    store 3 host-only.  A read is the endpoint over a lease-read snapshot
    of the store's ``RaftKv``, as ``Node._copr_snapshot`` takes it."""

    def __init__(self):
        from tikv_tpu_torch.copr.delta import DeltaSink
        from tikv_tpu_torch.copr.endpoint import Endpoint
        from tikv_tpu_torch.copr.region_cache import RegionColumnarCache
        from tikv_tpu_torch.device import DeviceRunner
        from tikv_tpu_torch.device.supervisor import DeviceStateSupervisor
        from tikv_tpu_torch.testing import mvcc as tm
        from tikv_tpu_torch.testing.cluster import Cluster
        self.table = tm.table_6c()
        self.tid = self.table.table_id
        self.c = Cluster(n_stores=3, seed=0)
        self.c.bootstrap()
        self.c.start()
        self.model = DeltaModel(RS3_KEYS)
        self.ts = 100
        self.dev = {}
        for sid in (1, 2):
            runner = DeviceRunner()
            sink = DeltaSink()
            cache = RegionColumnarCache(delta_source=sink)
            cache.device_resolver = runner.mvcc_resolver()
            sup = DeviceStateSupervisor(runner=runner, copr_cache=cache,
                                        delta_sink=sink)
            host = self.c.stores[sid].coprocessor_host
            host.register(sink)
            host.register(sup)
            self.dev[sid] = {"runner": runner, "cache": cache, "sup": sup,
                             "region": 1}
            self.dev[sid]["ep"] = Endpoint(
                lambda req, sid=sid: self._provider(sid, req), runner)

    def _provider(self, sid: int, req):
        from tikv_tpu_torch.kv.engine import SnapContext
        snap = self.c.kvs[sid].snapshot(
            SnapContext(region_id=self.dev[sid]["region"]))
        return self.dev[sid]["cache"].get(snap, req.dag)

    def propose(self, region_id: int, make):
        peer = self.c.leader_peer(region_id)
        box: dict = {}
        peer.propose(make(peer.region), lambda r: box.__setitem__("r", r))
        self.c._drive_until(lambda: "r" in box)
        if isinstance(box["r"], Exception):
            raise box["r"]
        return box["r"]

    def compact(self, region_id: int) -> None:
        from tikv_tpu_torch.raftstore import AdminCmd, RaftCmd
        applied = self.c.leader_peer(region_id).node.applied
        self.propose(region_id, lambda r: RaftCmd(
            region_id, r.epoch, admin=AdminCmd("compact_log",
                                               compact_index=applied)))

    def bounds(self, region_id: int) -> tuple:
        from tikv_tpu_torch.codec.keys import decode_record_handle
        from tikv_tpu_torch.storage.txn_types import decode_key
        r = self.c.stores[1].peers[region_id].region
        lo = decode_record_handle(decode_key(r.start_key)) \
            if r.start_key else 0
        hi = decode_record_handle(decode_key(r.end_key)) \
            if r.end_key else RS3_KEYS
        return lo, hi

    def ask(self, sid: int, region_id: int, plan: str) -> dict:
        """One request of ``plan`` on ``region_id`` at store ``sid``, the
        answer against the model over the region's handles → ms, the feed
        label, the cache's label."""
        from tikv_tpu_torch.convert import dag_from_wire
        from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
        from tikv_tpu_torch.copr.wire import enc_dag
        from tikv_tpu_torch.testing.dag import DagSelect
        from tikv_tpu_torch.utils import tracker
        lo, hi = self.bounds(region_id)
        self.dev[sid]["region"] = region_id
        s = DagSelect.from_table(self.table, ["id", "c0", "c1"])
        d = s.where(s.col("c1") > 990) if plan == "sel" else s.aggregate(
            [s.col("c0")], [("count_star", None), ("sum", s.col("c1"))])
        dag = dag_from_wire(enc_dag(d.build(self.ts + 5)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr, tok = tracker.install()
        try:
            resp = self.dev[sid]["ep"].handle(CopRequest(
                REQ_TYPE_DAG, dag, force_backend="device"))
        finally:
            tracker.uninstall(tok)
        ms = (time.perf_counter() - t0) * 1e3
        assert resp.backend == "device", resp.backend
        m = (self.model.h >= lo) & (self.model.h < hi)
        if plan == "sel":
            m &= self.model.c1 > 990
            got = np.stack([np.asarray(col.values)
                            for col in resp.result.batch.columns], 1)
            assert np.array_equal(got, np.stack(
                [self.model.h[m], self.model.c0[m], self.model.c1[m]], 1)), \
                f"rs3: wrong selection on region {region_id} at {sid}"
        else:
            got = sorted(resp.rows(), key=lambda r: r[2])
            c0, c1 = self.model.c0[m], self.model.c1[m]
            cnt = np.bincount(c0, minlength=self.model.groups)
            sm = np.bincount(c0, weights=c1.astype(np.float64),
                             minlength=self.model.groups)
            assert got == [(int(cnt[g]), int(sm[g]), g)
                           for g in range(self.model.groups) if cnt[g]], \
                f"rs3: wrong GROUP BY on region {region_id} at {sid}"
        return {"ms": ms, "feed": tr.labels.get("device_feed"),
                "cache": tr.labels.get("copr_cache")}

    def both_plans(self, sid: int, region_id: int, warm: int = RS3_WARM):
        """Both plans, cold + ``warm`` warm → {plan: [figures, ...]}."""
        return {plan: [self.ask(sid, region_id, plan)
                       for _ in range(1 + warm)]
                for plan in ("agg", "sel")}

    def update(self, hs, c1) -> float:
        """One 2PC transaction of UPDATEs of c1 at the leader of the rows'
        region → ms."""
        from tikv_tpu_torch.codec.keys import table_record_key
        from tikv_tpu_torch.codec.row import encode_row
        self.ts += 10
        muts = [("put", table_record_key(self.tid, int(h)),
                 encode_row({2: int(h) % self.model.groups, 3: int(v)}))
                for h, v in zip(hs, c1)]
        t0 = time.perf_counter()
        self.c.txn_write(muts, start_ts=self.ts, commit_ts=self.ts + 1)
        self.ts += 2
        self.model.update(np.asarray(hs), np.asarray(c1))
        return (time.perf_counter() - t0) * 1e3

    def feed_regions(self, sid: int) -> set:
        return {getattr(a, "region_hint", None)
                for a, b in self.dev[sid]["runner"].arena_items()
                if any(isinstance(v, dict) and "flat" in v
                       for v in b.values())}

    def sup_counts(self, sid: int) -> dict:
        sup = self.dev[sid]["sup"]
        return {"splits": sup.splits,
                "split_fallbacks": sup.split_fallbacks,
                "promotions": sup.promotions,
                "promotion_rebuilds": sup.promotion_rebuilds,
                "demotions": sup.demotions,
                "invalidations": sup.lifecycle_invalidations}

    def close(self) -> None:
        for d in self.dev.values():
            d["ep"].close()
            d["runner"].close()


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) << 10 for line in f
                    if line.startswith("VmRSS:"))


def run_rs3() -> dict:
    """Cell rs3: three replicas at TiKV's classic raft-kv defaults
    (``Rs3``), regions splitting, merging and moving under the card:

    1. load: 6c's table (``int_table(2)``, ``c0 = h % 1024``, ``c1 = h %
       1000``) at 2^22 keys as four 2^20-key SST v2 blobs
       (``fast_mvcc_table_sst``), each one raft ingest entry on region 1
       proposed at store 1 and applied on all three; then region 1's log
       compacted to its applied index on every store; the host RSS
       before and after;
    2. read region 1: both plans (GROUP BY c0: COUNT(*), SUM(c1); ``c1 >
       990``) at store 1, cold + 2 warm: only the cold requests mint;
    3. split by the checker: ``split_check_all`` (region 1 at about 240
       MiB is past 96 MiB: one half-split; the children wait for
       ``region_split_check_diff`` bytes of writes before the next
       check); store 1's resident feeds sliced by ``split_planes``; both
       plans on both children (each child's truth, no ``mvcc_resolve``,
       no upload);
    4. split by PD: ``Cluster.split_region`` on the right child at 90% of
       its rows (an odd handle): ``split_planes`` again, three regions
       that each answer;
    5. write: one 2PC transaction of 4,096 UPDATEs of c1 (4 runs of 1,024
       handles inside the middle region) through the port's ``Storage``
       over store 1's ``RaftKv``; both plans on that region: one
       ``patch_spans`` a feed, no upload;
    6. leader round trip: the middle region's leader to store 2, both
       plans there (cold: store 2's own mint), one more UPDATE committed
       through store 2 (store 1, a follower, takes it through its delta
       sink), the leader back to store 1: its supervisor promotes the
       region — one ``plane_digest`` a resident plane, ``promotions`` 1,
       ``promotion_rebuilds`` 0, no mint — and both plans equal the truth
       with both writes;
    7. consistency: ``check_consistency`` on every region, every replica
       the same hash;
    8. snapshot catch-up: store 3's peer of the left region removed, the
       log compacted, the peer added back: it catches up through
       ``generate_snapshot`` / ``apply_snapshot``, and its CFs for the
       region equal store 1's;
    9. merge: the right region into the middle one (prepare, then
       commit): on store 1 both lines drop, and the merged region's read
       mints once and equals the truth; the source's peer is destroyed on
       every store, and no arena holds a feed of it.

    Counts from 0 before the path, read after."""
    from tikv_tpu_torch.raftstore import Peer, RaftCmd, WriteOp
    from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst
    t_start = time.perf_counter()
    set_counts({k: 0 for k in KERNELS})
    out = {"config": "rs3", "keys": RS3_KEYS, "blobs": RS3_BLOBS}
    cell = Rs3()
    c, model = cell.c, cell.model
    steps: dict = {}
    try:
        # -- 1. load --------------------------------------------------
        rss0 = rss_bytes()
        t0 = time.perf_counter()
        chunk = RS3_KEYS // RS3_BLOBS
        for lo in range(0, RS3_KEYS, chunk):
            h = model.h[lo:lo + chunk]
            blob = fast_mvcc_table_sst(cell.tid, h, [(2, model.c0[h], None),
                                                     (3, model.c1[h], None)],
                                       cell.ts)
            cell.propose(1, lambda r, b=blob: RaftCmd(
                1, r.epoch, (WriteOp("ingest", "", b"", b),)))
            del blob
        load_s = time.perf_counter() - t0
        rss_loaded = rss_bytes()
        t1 = time.perf_counter()
        cell.compact(1)
        c.pump()
        compact_ms = (time.perf_counter() - t1) * 1e3
        gc.collect()
        out["load"] = {"s": load_s, "compact_ms": compact_ms,
                       "rss_before": rss0, "rss_after_load": rss_loaded,
                       "rss_after_compact": rss_bytes()}
        for sid in c.stores:
            assert c.stores[sid].peers[1].node.storage.first_index() > 1
        print(f"rs3 load: {load_s:.2f} s, RSS {rss0 / 2**30:.2f} → "
              f"{rss_loaded / 2**30:.2f} GiB → compacted "
              f"{out['load']['rss_after_compact'] / 2**30:.2f} GiB",
              flush=True)

        # -- 2. read region 1 -----------------------------------------
        c0 = counts()
        reads = cell.both_plans(1, 1)
        assert [r["feed"] for r in reads["agg"]] == \
            ["device_resolve", "hit", "hit"], reads["agg"]
        assert [r["feed"] for r in reads["sel"]] == \
            ["upload", "hit", "hit"], reads["sel"]
        assert counts()["mvcc_resolve"] - c0["mvcc_resolve"] == 1
        steps["read"] = reads

        # -- 3. split by the checker ----------------------------------
        peer1 = c.stores[1].peers[1]
        c0, sup0 = counts(), cell.sup_counts(1)
        t0 = time.perf_counter()
        n_checked = c.split_check_all()
        check_ms = (time.perf_counter() - t0) * 1e3
        assert n_checked == 1, n_checked
        rids = sorted(c.stores[1].peers)
        assert len(rids) == 2, rids
        left_id = 1
        right_id = next(r for r in rids if r != 1)
        split1 = {"checker_splits": n_checked, "ms": check_ms,
                  "approximate_size": peer1.approximate_size,
                  "buckets": len(peer1.buckets),
                  "phases_ms": dict(cell.dev[1]["sup"].split_phases_ms),
                  "bounds": {r: cell.bounds(r) for r in rids}}
        kids = {r: cell.both_plans(1, r) for r in (left_id, right_id)}
        for r, got in kids.items():
            for plan, runs in got.items():
                assert [x["feed"] for x in runs] == ["split", "hit", "hit"], \
                    (r, plan, runs)
        d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        assert d.get("split_planes") == 4 and "mvcc_resolve" not in d, d
        sup1 = cell.sup_counts(1)
        assert sup1["splits"] - sup0["splits"] == 1 and \
            sup1["split_fallbacks"] == 0, sup1
        split1["children"] = kids
        split1["launches"] = d
        steps["split_checker"] = split1
        print(f"rs3 split by the checker: {check_ms:.1f} ms, size "
              f"{peer1.approximate_size / 2**20:.1f} MiB, "
              f"{len(peer1.buckets)} buckets, phases "
              f"{json.dumps(split1['phases_ms'])}, bounds "
              f"{split1['bounds']}", flush=True)

        # -- 4. split by PD -------------------------------------------
        lo, hi = cell.bounds(right_id)
        at = lo + int((hi - lo) * 0.9)
        at += (at % 2 == 0)
        from tikv_tpu_torch.codec.keys import table_record_key
        from tikv_tpu_torch.storage.txn_types import encode_key
        c0 = counts()
        t0 = time.perf_counter()
        new_right = c.split_region(right_id, encode_key(
            table_record_key(cell.tid, at)))
        pd_split_ms = (time.perf_counter() - t0) * 1e3
        c.pump()
        mid_id, far_id = right_id, new_right.id
        regions = {r: cell.both_plans(1, r, warm=0)
                   for r in (left_id, mid_id, far_id)}
        for r in (mid_id, far_id):
            assert [x["feed"] for p in regions[r].values() for x in p] == \
                ["split", "split"], regions[r]
        d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        assert d.get("split_planes") == 4 and "mvcc_resolve" not in d, d
        steps["split_pd"] = {"ms": pd_split_ms, "at": at,
                             "phases_ms": dict(
                                 cell.dev[1]["sup"].split_phases_ms),
                             "launches": d}

        # -- 5. write -------------------------------------------------
        lo, hi = cell.bounds(mid_id)
        step = (hi - lo) // 4
        hs = np.concatenate([np.arange(lo + i * step + step // 2,
                                       lo + i * step + step // 2 + 1024)
                             for i in range(4)])
        c0 = counts()
        write_ms = cell.update(hs, (hs * 7 + 1) % 1000)
        after = cell.both_plans(1, mid_id, warm=0)
        assert [after[p][0]["feed"] for p in ("agg", "sel")] == \
            ["patch", "patch"], after
        d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        assert d.get("patch_spans") == 2 and "mvcc_resolve" not in d, d
        steps["write"] = {"ms": write_ms, "rows": len(hs),
                          "first_read_ms": {p: after[p][0]["ms"]
                                            for p in after},
                          "launches": d}

        # -- 6. leader round trip -------------------------------------
        c0, sup0 = counts(), cell.sup_counts(1)
        t0 = time.perf_counter()
        c.transfer_leader(mid_id, 2)
        assert c.leader_store(mid_id) == 2
        away_ms = (time.perf_counter() - t0) * 1e3
        at2 = cell.both_plans(2, mid_id, warm=0)
        assert [at2[p][0]["feed"] for p in ("agg", "sel")] == \
            ["device_resolve", "upload"], at2
        d2 = counts()
        assert d2["mvcc_resolve"] - c0["mvcc_resolve"] == 1, "store 2's mint"
        one = int(hs[0]) + 1
        store2_write_ms = cell.update([one], [993])
        planes = sum(len(f["digests"])
                     for _a, b in cell.dev[1]["runner"].arena_items()
                     for f in b.values()
                     if isinstance(f, dict) and "flat" in f and
                     _a.region_hint == mid_id)
        digests0 = counts()["plane_digest"]
        t0 = time.perf_counter()
        c.transfer_leader(mid_id, 1)
        assert c.leader_store(mid_id) == 1
        back_ms = (time.perf_counter() - t0) * 1e3
        promote = cell.dev[1]["sup"].last_promotion
        sup1 = cell.sup_counts(1)
        assert sup1["promotions"] - sup0["promotions"] == 1 and \
            sup1["promotion_rebuilds"] == sup0["promotion_rebuilds"], sup1
        assert counts()["plane_digest"] - digests0 == planes > 0, \
            (counts()["plane_digest"] - digests0, planes)
        back = cell.both_plans(1, mid_id, warm=0)
        assert [back[p][0]["feed"] for p in ("agg", "sel")] == \
            ["patch", "patch"], back
        d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        assert d["mvcc_resolve"] == 1, d        # store 2's, no other
        steps["round_trip"] = {
            "to_store2_ms": away_ms, "store2_cold_ms": {
                p: at2[p][0]["ms"] for p in at2},
            "store2_write_ms": store2_write_ms, "back_ms": back_ms,
            "promotion": promote, "planes": planes,
            "first_read_back_ms": {p: back[p][0]["ms"] for p in back},
            "supervisor": sup1, "launches": d}
        print(f"rs3 round trip: away {away_ms:.1f} ms, store 2 cold "
              f"{at2['agg'][0]['ms']:.1f} / {at2['sel'][0]['ms']:.1f} ms, "
              f"back {back_ms:.1f} ms, promotion {json.dumps(promote)}",
              flush=True)

        # -- 7. consistency -------------------------------------------
        t0 = time.perf_counter()
        hashes = {}
        for rid in sorted(c.stores[1].peers):
            hashes[rid] = c.check_consistency(rid)
            states = {s.peers[rid].consistency_state
                      for s in c.stores.values() if rid in s.peers}
            assert len(states) == 1, (rid, states)
        steps["consistency"] = {"ms": (time.perf_counter() - t0) * 1e3,
                                "hashes": hashes}

        # -- 8. snapshot catch-up -------------------------------------
        t0 = time.perf_counter()
        victim = c.stores[3].peers[left_id].meta
        c.change_peer(left_id, "remove", victim)
        c.pump()
        assert left_id not in c.stores[3].peers
        cell.compact(left_id)
        c.change_peer(left_id, "add", Peer(c.pd.alloc_id(), 3))
        c._drive_until(lambda: left_id in c.stores[3].peers and
                       c.stores[3].peers[left_id].applied_engine >=
                       c.leader_peer(left_id).node.commit)
        snap_ms = (time.perf_counter() - t0) * 1e3
        from tikv_tpu_torch.raftstore.peer_storage import region_data_bounds
        lo_k, hi_k = region_data_bounds(c.stores[1].peers[left_id].region)
        for cf in ("default", "lock", "write"):
            a = c.engines[1].range_cf(cf, lo_k, hi_k)[:2]
            b = c.engines[3].range_cf(cf, lo_k, hi_k)[:2]
            assert a[0] == b[0] and a[1] == b[1], f"rs3: store 3's {cf}"
        steps["snapshot"] = {"ms": snap_ms,
                             "rows": len(c.engines[3].range_cf(
                                 "write", lo_k, hi_k)[0])}

        # -- 9. merge -------------------------------------------------
        c0, inv0 = counts(), cell.sup_counts(1)["invalidations"]
        t0 = time.perf_counter()
        merged = c.merge_region(far_id, mid_id)
        merge_ms = (time.perf_counter() - t0) * 1e3
        dropped = cell.sup_counts(1)["invalidations"] - inv0
        assert dropped >= 2, dropped
        for s in c.stores.values():
            assert far_id not in s.peers
        for sid in (1, 2):
            assert far_id not in cell.feed_regions(sid), sid
        re_read = cell.both_plans(1, merged.id, warm=0)
        d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        assert d.get("mvcc_resolve") == 1, d
        steps["merge"] = {"ms": merge_ms, "lines_dropped": dropped,
                          "merged_cold_ms": {p: re_read[p][0]["ms"]
                                             for p in re_read},
                          "launches": d}
    finally:
        cell.close()
    launches = counts()
    for name in ("split_planes", "plane_digest", "mvcc_resolve",
                 "patch_spans", "hash_agg", "sel_pred"):
        assert launches[name] > 0, f"rs3 never launched {name}"
    out["steps"] = steps
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_start
    del cell, c, model
    gc.collect()
    torch.cuda.empty_cache()
    print("rs3 cell: " + json.dumps(out, default=str), flush=True)
    return {"config": "rs3", "launches": launches, "wall_s": out["wall_s"],
            "load_s": out["load"]["s"]}


# ---------------------------------------------------------------------------
# cell net and phase cli: the networked tikv-server
# ---------------------------------------------------------------------------

NET_KEYS = 1 << 22              # rs3's: 6c's table, about 240 MiB of it
NET_BLOBS = 4                   # 2^20 keys a blob (bench.py:448's chunk)
NET_PART = 4 << 20              # ImportUpload's part (srv's)
NET_WARM = 2
NET_RUN_ROWS = 1 << 10          # the write: 4 runs of 1,024 (w2's shape)
NET_ELECTION_TICKS = 1000       # TiKV's 10 s election timeout at 10 ms


class Net:
    """Cell net's rig: TiKV's documented minimum deployment — one PD and
    three TiKV stores, PD's ``replication.max-replicas = 3`` — at classic
    raft-kv's region-split-size 96 MiB and region-max-size 144 MiB (the
    port's ``RaftstoreConfig`` defaults, as rs3), all on loopback in this
    process so that the kernels' counts see every launch: a ``PdServer``
    and three ``TikvServer``s, each ``Node`` with its default runner, a
    ``DeviceRunner()`` of its own on ``cuda:0``.  The election timeout is
    TiKV's default 10 s (``raft-election-timeout-ticks`` 10 of
    ``raft-base-tick-interval`` 1 s) at the port's 10 ms tick: 1,000
    ticks.  At the port's default 10 ticks (100 ms) a leader holding the
    node lock through the split checker's scan of the loaded region (1.5
    to 3.5 s) misses its heartbeats, the followers elect another leader,
    and that leader scans and splits again.  Every request below is
    an RPC through ``TxnClient`` (or ``BatchCommandsClient``), and raft
    runs between the stores over ``GrpcTransport``'s ``BatchRaft``."""

    def __init__(self):
        from tikv_tpu_torch.config import TikvConfig
        from tikv_tpu_torch.raftstore.metapb import Store
        from tikv_tpu_torch.server import (Node, PdServer, RemotePdClient,
                                           TikvServer, TxnClient)
        from tikv_tpu_torch.testing import mvcc as tm
        self.table = tm.table_6c()
        self.tid = self.table.table_id
        self.model = DeltaModel(NET_KEYS)
        self.pd = PdServer("127.0.0.1:0")
        self.pd.start()
        self.pd_addr = f"127.0.0.1:{self.pd.port}"
        self.servers = []
        for _ in range(3):
            cfg = TikvConfig()
            cfg.raftstore.raft_election_timeout_ticks = NET_ELECTION_TICKS
            node = Node("127.0.0.1:0", RemotePdClient(self.pd_addr),
                        config=cfg)
            srv = TikvServer(node)
            # the bound port into the node's address and PD before the
            # start, or its peers dial port 0
            node.addr = f"127.0.0.1:{srv.port}"
            node.pd.put_store(Store(node.store_id, node.addr))
            srv.start()
            self.servers.append(srv)
        self.store = {s.node.store_id: s for s in self.servers}
        self.sids = [s.node.store_id for s in self.servers]
        self.client = TxnClient(self.pd_addr)

    def key(self, h: int) -> bytes:
        from tikv_tpu_torch.codec.keys import table_record_key
        return table_record_key(self.tid, int(h))

    def regions(self) -> list:
        """The table's regions as PD routes them, in key order → [(region
        id, first handle, end handle, leader's store)]."""
        from tikv_tpu_torch.codec.keys import decode_record_handle
        from tikv_tpu_torch.storage.txn_types import decode_key, encode_key
        out, h = [], 0
        while h < NET_KEYS:
            region, leader = self.client.pd.get_region_with_leader(
                encode_key(self.key(h)))
            end = region.end_key
            hi = NET_KEYS if not end else min(
                NET_KEYS, decode_record_handle(decode_key(end)))
            out.append((region.id, h, hi, leader.store_id))
            h = hi
        return out

    def wait_regions(self, n: int, timeout: float = 120.0) -> list:
        """Wait until PD routes the table over ``n`` regions, every one of
        them with a peer on each store → the regions."""
        t0 = time.perf_counter()
        while True:
            try:
                regs = self.regions()
            except Exception:   # noqa: BLE001 — a split's routing gap
                regs = []
            if len(regs) == n and all(
                    self.peer(s, r[0]) is not None
                    for s in self.servers for r in regs):
                return regs
            assert time.perf_counter() - t0 < timeout, \
                f"net: PD routes {regs}, not {n} regions on every store"
            time.sleep(0.05)

    @staticmethod
    def peer(srv, region_id: int):
        with srv.node.lock:
            return srv.node.raft_store.peers.get(region_id)

    def leader_store(self, region_id: int):
        """The store whose peer leads the region, once no other store's
        peer believes it leads (a transfer's old leader refuses proposals
        until it steps down); None meanwhile."""
        leads = [s.node.store_id for s in self.servers
                 if self.peer(s, region_id) is not None and
                 self.peer(s, region_id).is_leader()]
        return leads[0] if len(leads) == 1 else None

    def applied_everywhere(self, region_id: int) -> bool:
        with self.servers[0].node.lock:
            want = self.servers[0].node.raft_store.peers[region_id] \
                .node.applied
        return all(self.peer(s, region_id) is not None and
                   self.peer(s, region_id).node.applied >= want
                   for s in self.servers)

    def dag(self, plan: str, lo: int, hi: int, thr: int = 990, ts=None):
        """``sel``: the rows of ``c1 > thr``; ``agg``: GROUP BY c0:
        COUNT(*), SUM(c1); ``fagg``: the same GROUP BY ``WHERE c1 > thr``
        — over handles [lo, hi), at ``ts`` (a fresh TSO by default)."""
        import dataclasses

        from tikv_tpu_torch.executors.ranges import KeyRange
        from tikv_tpu_torch.testing.dag import DagSelect
        s = DagSelect.from_table(self.table, ["id", "c0", "c1"])
        if plan in ("sel", "fagg"):
            s = s.where(s.col("c1") > thr)
        if plan != "sel":
            s = s.aggregate([s.col("c0")], [("count_star", None),
                                            ("sum", s.col("c1"))])
        return dataclasses.replace(
            s.build(self.client.tso() if ts is None else ts),
            ranges=(KeyRange(self.key(lo), self.key(hi)),))

    def check(self, plan: str, lo: int, hi: int, rows,
              thr: int = 990) -> None:
        """``rows`` against the model over handles [lo, hi)."""
        m = (self.model.h >= lo) & (self.model.h < hi)
        if plan in ("sel", "fagg"):
            m &= self.model.c1 > thr
        if plan == "sel":
            got = np.asarray(rows, np.int64).reshape(-1, 3)
            assert np.array_equal(got, np.stack(
                [self.model.h[m], self.model.c0[m], self.model.c1[m]], 1)), \
                f"net: wrong selection on [{lo}, {hi})"
        else:
            c0, c1 = self.model.c0[m], self.model.c1[m]
            cnt = np.bincount(c0, minlength=self.model.groups)
            sm = np.bincount(c0, weights=c1.astype(np.float64),
                             minlength=self.model.groups)
            got = sorted(map(tuple, rows), key=lambda r: r[2])
            assert got == [(int(cnt[g]), int(sm[g]), g)
                           for g in range(self.model.groups) if cnt[g]], \
                f"net: wrong GROUP BY on [{lo}, {hi})"

    def ask(self, plan: str, lo: int, hi: int) -> dict:
        """One ``plan`` over handles [lo, hi) through ``TxnClient
        .coprocessor`` → ms on the host clock and the response's labels;
        the answer against the model, served from the card."""
        dag = self.dag(plan, lo, hi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = self.client.coprocessor(dag, timeout=120)
        ms = (time.perf_counter() - t0) * 1e3
        assert resp["backend"] == "device", (plan, lo, hi, resp["backend"])
        self.check(plan, lo, hi, resp["rows"])
        return {"ms": ms, "labels": resp["time_detail"]["labels"]}

    def both_plans(self, lo: int, hi: int, warm: int = NET_WARM) -> dict:
        return {plan: [self.ask(plan, lo, hi) for _ in range(1 + warm)]
                for plan in ("agg", "sel")}

    def feed_routes(self) -> dict:
        out: dict = {}
        for s in self.servers:
            for k, v in s.node.device_runner.feed_routes.items():
                out[k] = out.get(k, 0) + v
        return out

    def raft_calls(self) -> dict:
        return {"batch_raft": sum(s.service.raft_batches
                                  for s in self.servers),
                "snapshot_chunk": sum(s.service.snap_chunks
                                      for s in self.servers),
                "raft_msgs": sum(s.service.raft_msgs for s in self.servers),
                "drops": [dict(s.node.transport.drops)
                          for s in self.servers]}

    def update(self, hs, c1) -> float:
        """One 2PC transaction of UPDATEs of c1 through ``TxnClient
        .txn_write`` → ms."""
        from tikv_tpu_torch.codec.row import encode_row
        muts = [("put", self.key(h),
                 encode_row({2: int(h) % self.model.groups, 3: int(v)}))
                for h, v in zip(np.asarray(hs).tolist(),
                                np.asarray(c1).tolist())]
        t0 = time.perf_counter()
        self.client.txn_write(muts)
        ms = (time.perf_counter() - t0) * 1e3
        self.model.update(np.asarray(hs), np.asarray(c1))
        return ms

    def transfer(self, region_id: int, to_store: int) -> float:
        """The region's leader to ``to_store`` through the
        ``TransferLeader`` RPC → ms until that store leads it."""
        region = self.client.pd.get_region_by_id(region_id)
        to_peer = next(p for p in region.peers if p.store_id == to_store)
        t0 = time.perf_counter()
        self.client._call_leader_by_region(region, "TransferLeader", {
            "region_id": region_id, "to_peer_id": to_peer.id})
        while self.leader_store(region_id) != to_store:
            assert time.perf_counter() - t0 < 30, \
                f"net: region {region_id} did not move to {to_store}"
            time.sleep(0.005)
        return (time.perf_counter() - t0) * 1e3

    def fast_stats(self) -> dict:
        """The three stores' fast-path counts, summed (reasons merged)."""
        out: dict = {"learned": 0, "hit": 0, "miss": 0, "bypass": 0,
                     "fallback": 0, "invalidate": 0, "reasons": {}}
        for s in self.servers:
            st = s.node.fastpath.stats()
            for k in out:
                if k != "reasons":
                    out[k] += st[k]
            for k, v in st["reasons"].items():
                out["reasons"][k] = out["reasons"].get(k, 0) + v
        return out

    def set_fastpath(self, classes: int) -> None:
        """``coprocessor.fastpath_classes`` on every store, through the
        online config (each applied diff also bumps ``config_gen``)."""
        for s in self.servers:
            s.node.config_controller.update(
                {"coprocessor.fastpath_classes": classes})

    def followers(self, region_id: int) -> list:
        lead = self.leader_store(region_id)
        return [sid for sid in self.sids if sid != lead]

    def wait_resolved(self, ts: int, want: dict,
                      timeout: float = 30.0) -> float:
        """Wait until each store of ``want`` ({region id: [store ids]})
        reports, through ``Status``, a resolved_ts at or above ``ts`` for
        the region → s waited."""
        t0 = time.perf_counter()
        while True:
            behind = []
            for rid, sids in want.items():
                for sid in sids:
                    regions = self.client.status(sid)["regions"]
                    rts = next((r["resolved_ts"] for r in regions
                                if r["region"]["id"] == rid), 0)
                    if rts < ts:
                        behind.append((rid, sid, rts))
            if not behind:
                return time.perf_counter() - t0
            assert time.perf_counter() - t0 < timeout, \
                f"net: resolved_ts behind {ts}: {behind}"
            time.sleep(0.01)

    def replica(self, plan: str, lo: int, hi: int, store_id: int,
                ts: int) -> dict:
        """One stale read of ``plan`` at ``ts`` from ``store_id``'s own
        feed (``TxnClient.coprocessor_replica``) → ms on the host clock
        and the labels; the answer against the model, from the card."""
        dag = self.dag(plan, lo, hi, ts=ts)
        t0 = time.perf_counter()
        resp = self.client.coprocessor_replica(dag, store_id=store_id,
                                               timeout=120)
        ms = (time.perf_counter() - t0) * 1e3
        assert resp["backend"] == "device", (plan, store_id,
                                             resp["backend"])
        self.check(plan, lo, hi, resp["rows"])
        return {"ms": ms, "labels": resp["time_detail"]["labels"]}

    def stop(self) -> None:
        self.client.close()
        for s in self.servers:
            s.stop()
        self.pd.stop()


NET_THRESHOLDS = range(980, 996)    # 6b-ep's: 16 constants a shape
NET_SLOW_LEADER_MS = 500            # the leader's slowed read (failpoint)


def net_fast_path(cell: Net, regs: list) -> dict:
    """Cell net's step 5a: the compiled request fast path.  On each
    region, the GROUP BY c0: COUNT(*), SUM(c1) ``WHERE c1 > thr`` and the
    rows of ``c1 > thr``, ``thr`` over 980..995, each through
    ``TxnClient.coprocessor`` (the raw ``Coprocessor`` method: packed
    bytes into ``KvService.handle_raw``) and against the model: a first
    pass (each shape learns, the rest hit), the timed pass of hits, and
    the same sequence with ``coprocessor.fastpath_classes`` 0 (the full
    decode); the cache back on — the next request misses and learns; one
    2PC UPDATE in region 1 — the next request falls back (``generation``)
    with the write in its answer, the one after learns, the third hits."""
    def ask(plan, lo, hi, thr):
        dag = cell.dag(plan, lo, hi, thr)
        t0 = time.perf_counter()
        resp = cell.client.coprocessor(dag, timeout=120)
        ms = (time.perf_counter() - t0) * 1e3
        assert resp["backend"] == "device", (plan, thr, resp["backend"])
        cell.check(plan, lo, hi, resp["rows"], thr)
        return ms, resp["time_detail"]["labels"].get("fastpath")

    def sequence():
        out = []
        for _rid, lo, hi, _ in regs:
            for plan in ("fagg", "sel"):
                for thr in NET_THRESHOLDS:
                    out.append((plan,) + ask(plan, lo, hi, thr))
        return out

    st0, c0 = cell.fast_stats(), counts()
    first = sequence()
    d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
    # every (region, shape) learns on its first request at most; the
    # rest hit, on hash_agg and sel_pred
    per = len(NET_THRESHOLDS)
    for i in range(0, len(first), per):
        assert all(leg == "hit" for _p, _ms, leg in first[i + 1:i + per]), \
            first[i:i + per]
    assert d.get("hash_agg") and d.get("sel_pred"), d
    # timed once every constant's plan has been seen (its memo warm), as
    # the full decode's pass below sees them: each request a hit
    fast = sequence()
    assert all(leg == "hit" for _p, _ms, leg in fast), fast
    st1 = cell.fast_stats()
    cell.set_fastpath(0)
    full = sequence()
    assert all(leg is None for _p, _ms, leg in full), full
    cell.set_fastpath(64)
    rid, lo, hi, _ = regs[0]
    st2 = cell.fast_stats()
    _ms, leg = ask("sel", lo, hi, 985)
    st3 = cell.fast_stats()
    assert leg is None and st3["miss"] == st2["miss"] + 1 and \
        st3["learned"] == st2["learned"] + 1, (st2, st3)
    # one UPDATE of a row of region 1 into the selection
    h = lo + int(np.argmax(cell.model.c1[lo:hi] <= 980))
    write_ms = cell.update([h], [999])
    legs = [ask("sel", lo, hi, thr) for thr in (985, 986, 987)]
    st4 = cell.fast_stats()
    assert [leg for _ms, leg in legs] == ["fallback", None, "hit"], legs
    assert st4["reasons"].get("fallback:generation", 0) == \
        st3["reasons"].get("fallback:generation", 0) + 1, st4
    assert st4["learned"] == st3["learned"] + 1, (st3, st4)

    def p50(rows, plan, hit):
        return float(np.median([ms for p, ms, leg in rows
                                if p == plan and (leg == "hit") == hit]))
    out = {"hit_p50_ms": {p: p50(fast, p, True) for p in ("fagg", "sel")},
           "full_decode_p50_ms": {p: p50(full, p, False)
                                  for p in ("fagg", "sel")},
           "first_pass_hit_p50_ms": {p: p50(first, p, True)
                                     for p in ("fagg", "sel")},
           "requests": 3 * len(fast) + 4, "launches": d,
           "write_ms": write_ms,
           "after_write_ms": [ms for ms, _leg in legs],
           "stats": {k: cell.fast_stats()[k] - st0[k] for k in st0
                     if k != "reasons"},
           "reasons": {k: v - st0["reasons"].get(k, 0)
                       for k, v in cell.fast_stats()["reasons"].items()
                       if v - st0["reasons"].get(k, 0)},
           "hits_before_off": st1["hit"] - st0["hit"]}
    print(f"net fast path: hit p50 GROUP BY {out['hit_p50_ms']['fagg']:.3f}"
          f" / selection {out['hit_p50_ms']['sel']:.3f} ms beside the full "
          f"decode's {out['full_decode_p50_ms']['fagg']:.3f} / "
          f"{out['full_decode_p50_ms']['sel']:.3f} ms (host clock, gRPC, "
          f"{len(fast)} requests each; the first pass's hits, each "
          f"constant's first request: "
          f"{out['first_pass_hit_p50_ms']['fagg']:.3f} / "
          f"{out['first_pass_hit_p50_ms']['sel']:.3f} ms); after the "
          f"UPDATE: fallback "
          f"{legs[0][0]:.1f}, learn {legs[1][0]:.1f}, hit {legs[2][0]:.1f} "
          f"ms; stats {json.dumps(out['stats'])} reasons "
          f"{json.dumps(out['reasons'])}; launches of the hits "
          f"{json.dumps(d)}", flush=True)
    return out


def net_stale_reads(cell: Net, regs: list) -> dict:
    """Cell net's step 5b: stale reads under resolved-ts.  The wait until
    every follower reports (``Status``) a resolved_ts at or above a fresh
    TSO; both plans on each region from each follower's own feed
    (``TxnClient.coprocessor_replica``: each follower mints its feed,
    ``mvcc_resolve``); a read above the watermark refused with
    ``DataIsNotReady``; a hedged read (``TxnClient(hedge_reads=True)``,
    the leader slowed by the ``read::before_leader_read`` failpoint) whose
    follower refuses — above the watermark, then under
    ``device::replica_stale`` — answered by the leader; one UPDATE, the
    watermark past it, and a stale read that holds it from the
    follower's patched feed (``patch_spans``, no mint); a hedged get,
    the leader slowed, answered by the follower."""
    from tikv_tpu_torch.codec.row import decode_row
    from tikv_tpu_torch.server import RemoteError, TxnClient
    from tikv_tpu_torch.storage.txn_types import compose_ts
    from tikv_tpu_torch.utils import failpoint
    follow = {rid: cell.followers(rid) for rid, *_ in regs}
    ts = cell.client.tso()
    wait_s = cell.wait_resolved(ts, follow)
    c0 = counts()
    routes0 = {sid: dict(cell.store[sid].node.device_runner.feed_routes)
               for sid in cell.sids}
    reads = {}
    for rid, lo, hi, _ in regs:
        for sid in follow[rid]:
            for plan in ("agg", "sel"):
                reads[f"{rid}/{sid}/{plan}"] = cell.replica(plan, lo, hi,
                                                            sid, ts)
    d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
    n_feeds = sum(len(v) for v in follow.values())
    # each follower mints its own feed of each region it follows
    assert d.get("mvcc_resolve") == n_feeds and d.get("hash_agg") and \
        d.get("sel_pred"), d
    routes = {sid: {k: v - routes0[sid].get(k, 0) for k, v in
                    cell.store[sid].node.device_runner.feed_routes.items()
                    if v - routes0[sid].get(k, 0)} for sid in cell.sids}
    for sid in set(s for v in follow.values() for s in v):
        served = cell.store[sid].node.replica_serving_stats()
        want = {rid for rid, sids in follow.items() if sid in sids}
        assert want <= set(served["replica_regions"]), (sid, served)
    # refusals, and the hedge's fall-through to the leader
    rid, lo, hi, _ = regs[0]
    future = compose_ts(int(time.time() * 1000) + 10_000, 0)
    try:
        cell.client.coprocessor_replica(cell.dag("sel", lo, hi, ts=future),
                                        store_id=follow[rid][0])
        raise AssertionError("net: a stale read above the watermark served")
    except RemoteError as e:
        refusal = dict(e.err)
    assert refusal["kind"] == "data_is_not_ready" and \
        refusal["region_id"] == rid and refusal["read_ts"] == future and \
        0 < refusal["safe_ts"] < future, refusal
    hc = TxnClient(cell.pd_addr, hedge_reads=True)
    hedged = {}
    try:
        for case, read_ts, arm in (("above", future, None),
                                   ("replica_stale", ts,
                                    "device::replica_stale")):
            failpoint.cfg("read::before_leader_read",
                          f"1*sleep({NET_SLOW_LEADER_MS})")
            if arm is not None:
                failpoint.cfg(arm, "1*return")
            t0 = time.perf_counter()
            r = hc.coprocessor(cell.dag("sel", lo, hi, ts=read_ts),
                               timeout=120)
            hedged[case] = (time.perf_counter() - t0) * 1e3
            failpoint.teardown()
            cell.check("sel", lo, hi, r["rows"])
        assert hc.hedges == {"copr_fired": 2, "copr_stale_refused": 2,
                             "copr_leader_won": 2}, hc.hedges
    finally:
        failpoint.teardown()
        hc.close()
    # a write reaches the followers' feeds as a patch
    h = lo + int(np.argmax(cell.model.c1[lo:hi] <= 990))
    cell.update([h], [995])
    ts2 = cell.client.tso()
    cell.wait_resolved(ts2, {rid: follow[rid]})
    c0 = counts()
    routes0 = {sid: dict(cell.store[sid].node.device_runner.feed_routes)
               for sid in follow[rid]}
    patched = {sid: cell.replica("sel", lo, hi, sid, ts2)
               for sid in follow[rid]}
    dw = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
    assert dw.get("patch_spans") and "mvcc_resolve" not in dw, dw
    for sid, r in patched.items():
        # the runner's own labels stay on the coalescer's thread: its
        # feed routes say how the feed was brought forward
        got = {k: v - routes0[sid].get(k, 0) for k, v in
               cell.store[sid].node.device_runner.feed_routes.items()
               if v - routes0[sid].get(k, 0)}
        assert r["labels"].get("copr_cache") == "delta" and \
            got == {"patch": 1}, (sid, r, got)
    # a hedged get, the leader slowed: the follower's stale read answers
    h2 = lo + 7
    ts3 = cell.client.tso()
    cell.wait_resolved(ts3, {rid: follow[rid]})
    hc = TxnClient(cell.pd_addr, hedge_reads=True)
    try:
        failpoint.cfg("read::before_leader_read",
                      f"1*sleep({2 * NET_SLOW_LEADER_MS})")
        value = hc.get(cell.key(h2), version=ts3)
    finally:
        failpoint.teardown()
        hc.close()
    assert decode_row(value) == {2: int(cell.model.c0[h2]),
                                 3: int(cell.model.c1[h2])}, value
    assert hc.hedges == {"fired": 1, "follower_won": 1}, hc.hedges
    out = {"wait_s": wait_s, "reads": reads, "launches": d,
           "feed_routes": routes, "refusal": refusal,
           "hedged_ms": hedged, "patched": patched, "patch_launches": dw,
           "replica_serving": {sid: cell.store[sid].node
                               .replica_serving_stats()
                               for sid in cell.sids}}
    cold = [r["ms"] for k, r in reads.items()]
    print(f"net stale reads: watermark wait {wait_s:.3f} s; follower reads "
          + " ".join(f"{k}: {r['ms']:.1f}" for k, r in reads.items())
          + f" ms (first of each store and region cold, max "
          f"{max(cold):.1f}); launches {json.dumps(d)}, feed routes "
          f"{json.dumps(routes)}; refusal {json.dumps(refusal)}; hedged "
          f"fall-through ms {json.dumps(hedged)}; after a write the "
          f"followers' reads " + " ".join(
              f"{sid}: {r['ms']:.1f} ms" for sid, r in patched.items())
          + f" (launches {json.dumps(dw)}); the hedged get answered by a "
          f"follower", flush=True)
    return out


def run_net(srv: dict) -> dict:
    """Cell net: the networked tikv-server on the card (``Net``), every
    hop a real RPC on loopback:

    1. replicas: region 1 given peers on stores 2 and 3 through
       ``TxnClient.add_peer`` (``ChangePeer`` over gRPC), before the load;
    2. load: ``ImportSwitchMode(True)`` on every store; 6c's table at
       rs3's 2^22 keys as four 2^20-key SST v2 blobs, each through
       ``TxnClient.ingest_sst`` (``ImportUpload`` parts of 4 MiB, then
       ``ImportIngest``: one raft entry a blob, of tens of MB, replicated
       to the followers through ``BatchRaft``); the wait until all three
       stores have applied it, and until each store's cold stream has
       parsed and uploaded what it applied; import mode off, and the wait for the
       leader's split checker to half-split the region (PD routing two
       regions, each with a peer on every store; no write follows, so
       neither half is scanned again); RSS before and after;
    3. reads: on every region both plans (GROUP BY c0: COUNT(*), SUM(c1);
       the rows of ``c1 > 990``) through ``TxnClient.coprocessor``, cold +
       2 warm, each from the card and against the numpy model;
    4. other routes: one region's selection through
       ``TxnClient.coprocessor_stream`` (the host's pages over one
       snapshot), and its GROUP BY through ``BatchCommandsClient``
       together with a ``KvGet``;
    5. write: one 2PC transaction of 6c-delta's w2 shape (4,096 UPDATEs in
       4 runs of 1,024 at 1/8, 3/8, 5/8 and 7/8 of the keys) through
       ``TxnClient.txn_write``; both plans on every region again;
    5a. the compiled request fast path (``net_fast_path``);
    5b. stale reads under resolved-ts on the followers' own feeds, the
       refusals and the hedged reads (``net_stale_reads``);
    6. region moves over RPC: ``TxnClient.split`` at an odd handle (90% of
       the right region), both plans on each child; store 2's stale reads
       of the middle child (its sliced replica feed), the middle region's
       leader to store 2 (``TransferLeader``: the replica feed promoted by
       ``plane_digest``, no mint, no upload, no rebuild) and back, both
       plans after each; ``TxnClient.merge`` of the right child into the
       middle one, the merged region's read;
    7. ``stop``: every server and PD stops, and no thread is left.

    Printed: the load's s by part, cold ms and warm p50 per plan through
    gRPC beside srv's in process, the write's and each move's ms, the fast
    path's hit p50 beside the full decode's and its counts, the follower
    reads' ms, the promotion's ms and store 2's first reads after it, the
    launches and ``feed_routes``, the ``BatchRaft`` and ``SnapshotChunk``
    calls, RSS.  Counts from 0 before the path, read after."""
    import threading

    from tikv_tpu_torch.server.client import BatchCommandsClient
    from tikv_tpu_torch.server import wire
    from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst
    t_start = time.perf_counter()
    threads_before = {t.ident for t in threading.enumerate()}
    set_counts({k: 0 for k in KERNELS})
    out = {"config": "net", "keys": NET_KEYS, "blobs": NET_BLOBS}
    cell = Net()
    model = cell.model
    steps: dict = {}
    try:
        # -- 1. replicas ----------------------------------------------
        t0 = time.perf_counter()
        for sid in cell.sids[1:]:
            cell.client.add_peer(1, sid)
        cell.wait_regions(1)
        steps["add_peers_ms"] = (time.perf_counter() - t0) * 1e3

        # -- 2. load --------------------------------------------------
        rss0 = rss_bytes()
        for sid in cell.sids:
            assert cell.client.import_switch_mode(sid, True) is True
        timings: dict = {}
        build_s = 0.0
        load_ts = cell.client.tso()
        t0 = time.perf_counter()
        chunk = NET_KEYS // NET_BLOBS
        blob_bytes = 0
        for lo in range(0, NET_KEYS, chunk):
            h = model.h[lo:lo + chunk]
            t1 = time.perf_counter()
            blob = fast_mvcc_table_sst(cell.tid, h, [(2, model.c0[h], None),
                                                     (3, model.c1[h], None)],
                                       load_ts)
            build_s += time.perf_counter() - t1
            blob_bytes += len(blob)
            n = cell.client.ingest_sst(blob, cell.key(lo), chunk=NET_PART,
                                       timings=timings)
            assert n == chunk, n
            del blob
        ingest_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        while not cell.applied_everywhere(1):
            assert time.perf_counter() - t1 < 300, "net: a store lags"
            time.sleep(0.01)
        replicate_s = time.perf_counter() - t1
        # every store's cold stream parses and uploads the chunks it
        # applied, followers' too: the reads below wait for the three
        t1 = time.perf_counter()
        for srv_ in cell.servers:
            cs_ = srv_.node.cold_stream
            assert cs_ is None or cs_.wait_idle(600.0), \
                "net: a store's stream did not drain"
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t1
        rss_loaded = rss_bytes()
        for sid in cell.sids:
            assert cell.client.import_switch_mode(sid, False) is False
        t1 = time.perf_counter()
        regs = cell.wait_regions(2, timeout=300)
        split_wait_s = time.perf_counter() - t1
        load = {"total_s": time.perf_counter() - t0, "sst_build_s": build_s,
                "upload_s": timings["upload_s"],
                "ingest_s": timings["ingest_s"],
                "replicate_s": replicate_s, "stream_drain_s": drain_s,
                "split_wait_s": split_wait_s,
                "blob_bytes": blob_bytes, "rss_before": rss0,
                "rss_after_load": rss_loaded, "raft": cell.raft_calls()}
        out["load"] = load
        print(f"net load: {ingest_s:.2f} s through the leader (SST build "
              f"{build_s:.2f}, uploads {timings['upload_s']:.2f}, ingests "
              f"{timings['ingest_s']:.2f}), replication "
              f"{replicate_s:.2f} s, the streams' drain {drain_s:.2f} s, "
              f"split wait {split_wait_s:.2f} s, "
              f"blobs {blob_bytes / 2**20:.1f} MiB, RSS "
              f"{rss0 / 2**30:.2f} → {rss_loaded / 2**30:.2f} GiB, raft "
              f"{json.dumps(load['raft'])}; regions {regs}", flush=True)

        # -- 3. reads -------------------------------------------------
        c0 = counts()
        reads = {rid: cell.both_plans(lo, hi) for rid, lo, hi, _ in regs}
        d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        assert d.get("hash_agg") and d.get("sel_pred"), d
        steps["reads"] = {"regions": regs, "runs": reads, "launches": d}
        figures = {}
        for plan in ("agg", "sel"):
            runs = [r[plan] for r in reads.values()]
            warm = [x["ms"] for r in runs for x in r[1:]]
            figures[plan] = {"cold_ms": [r[0]["ms"] for r in runs],
                             "warm_p50_ms": float(np.median(warm))}
        out["reads"] = figures
        print("net reads through gRPC: " + "; ".join(
            f"{p}: cold {' / '.join(f'{x:.1f}' for x in f['cold_ms'])} ms, "
            f"warm p50 {f['warm_p50_ms']:.3f} ms (srv in process: cold "
            f"{srv['reads'][p]['cold_ms']:.1f}, warm p50 "
            f"{srv['reads'][p]['warm_p50_ms']:.3f})"
            for p, f in figures.items()) +
            f"; launches {json.dumps(d)}", flush=True)

        # -- 4. the stream and the mux --------------------------------
        rid, lo, hi, _ = regs[0]
        # about four pages of the region's selected rows
        n_sel = int(((model.h >= lo) & (model.h < hi) &
                     (model.c1 > 990)).sum())
        t0 = time.perf_counter()
        pages = list(cell.client.coprocessor_stream(
            cell.dag("sel", lo, hi), paging_size=max(1, n_sel // 4),
            timeout=300))
        stream_ms = (time.perf_counter() - t0) * 1e3
        assert len(pages) >= 2 and pages[-1]["is_drained"], len(pages)
        cell.check("sel", lo, hi, [r for p in pages for r in p["rows"]])
        leader = cell.store[cell.leader_store(rid)].node
        mux = BatchCommandsClient(leader.addr)
        try:
            got = {}
            ts = cell.client.tso()

            def one(name, method, req):
                got[name] = mux.call(method, req, timeout=120)
            t0 = time.perf_counter()
            threads = [threading.Thread(target=one, args=(
                "copr", "Coprocessor",
                {"tp": 103, "dag": wire.enc_dag(cell.dag("agg", lo, hi))})),
                threading.Thread(target=one, args=(
                    "get", "KvGet", {"key": cell.key(lo + 7),
                                     "version": ts}))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            mux_ms = (time.perf_counter() - t0) * 1e3
        finally:
            mux.close()
        assert got["copr"]["backend"] == "device", got["copr"]["backend"]
        cell.check("agg", lo, hi, got["copr"]["rows"])
        from tikv_tpu_torch.codec.row import decode_row
        assert decode_row(got["get"]["value"]) == {
            2: int(model.c0[lo + 7]), 3: int(model.c1[lo + 7])}
        steps["stream"] = {"ms": stream_ms, "pages": len(pages),
                           "rows": n_sel}
        steps["mux_ms"] = mux_ms

        # -- 5. write -------------------------------------------------
        hs = np.concatenate([
            np.arange(NET_KEYS * (2 * i + 1) // 8,
                      NET_KEYS * (2 * i + 1) // 8 + NET_RUN_ROWS)
            for i in range(4)])
        c0 = counts()
        write_ms = cell.update(hs, (hs * 7 + 1) % 1000)
        after = {rid: cell.both_plans(lo, hi, warm=0)
                 for rid, lo, hi, _ in regs}
        d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        assert d.get("patch_spans") and "mvcc_resolve" not in d, d
        steps["write"] = {"ms": write_ms, "rows": len(hs),
                          "first_read": {r: {p: a[p][0] for p in a}
                                         for r, a in after.items()},
                          "launches": d}
        print(f"net write: {write_ms:.1f} ms for {len(hs)} rows over "
              f"{len(regs)} regions; first reads after it " + " ".join(
                  f"{r}: {a['agg'][0]['ms']:.1f} / {a['sel'][0]['ms']:.1f}"
                  f" ms ({a['agg'][0]['labels'].get('copr_cache')})"
                  for r, a in after.items()) +
              f"; launches {json.dumps(d)}", flush=True)

        # -- 5a. the fast path -----------------------------------------
        steps["fast_path"] = net_fast_path(cell, regs)
        out["fast_path"] = {k: steps["fast_path"][k] for k in
                            ("hit_p50_ms", "full_decode_p50_ms")}

        # -- 5b. stale reads under resolved-ts ---------------------------
        steps["stale_reads"] = net_stale_reads(cell, regs)

        # -- 6. region moves over RPC ---------------------------------
        mid_id, lo, hi, _ = regs[-1]
        at = lo + int((hi - lo) * 0.9)
        at += (at % 2 == 0)
        c0 = counts()
        t0 = time.perf_counter()
        right = cell.client.split(cell.key(at))
        split_ms = (time.perf_counter() - t0) * 1e3
        regs = cell.wait_regions(len(regs) + 1)
        far_id = right.id
        kids = {r: cell.both_plans(l, h, warm=0)
                for r, l, h, _ in regs if r in (mid_id, far_id)}
        d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        assert d.get("split_planes") and "mvcc_resolve" not in d, d
        steps["split"] = {"ms": split_ms, "at": at, "regions": regs,
                          "children": kids, "launches": d}
        mlo, mhi = next((l, h) for r, l, h, _ in regs if r == mid_id)
        # store 2 follows the middle child: a stale read there takes the
        # feeds its split sliced (a replica feed the transfer promotes)
        s2 = cell.sids[1]
        node2 = cell.store[s2].node
        ts = cell.client.tso()
        cell.wait_resolved(ts, {mid_id: [s2]})
        replica2 = {p: cell.replica(p, mlo, mhi, s2, ts)
                    for p in ("agg", "sel")}
        sup2 = node2.device_supervisor
        promos0, rebuilds0 = sup2.promotions, sup2.promotion_rebuilds
        routes0 = dict(node2.device_runner.feed_routes)
        c0 = counts()
        away_ms = cell.transfer(mid_id, s2)
        at2 = cell.both_plans(mlo, mhi, warm=0)
        d2 = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        routes2 = {k: v - routes0.get(k, 0) for k, v in
                   node2.device_runner.feed_routes.items()
                   if v - routes0.get(k, 0)}
        promotion = dict(sup2.last_promotion)
        assert sup2.promotions > promos0 and \
            sup2.promotion_rebuilds == rebuilds0 == 0, sup2.stats()
        assert d2.get("plane_digest") and "mvcc_resolve" not in d2 and \
            promotion.get("planes"), (d2, promotion)
        assert not routes2.get("upload") and \
            not routes2.get("device_resolve"), routes2
        back_ms = cell.transfer(mid_id, cell.sids[0])
        back = cell.both_plans(mlo, mhi, warm=0)
        d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        steps["round_trip"] = {"replica_at_store2": replica2,
                               "to_store2_ms": away_ms, "at_store2": at2,
                               "promotion": promotion,
                               "store2_launches": d2,
                               "store2_feed_routes": routes2,
                               "back_ms": back_ms, "back": back,
                               "launches": d}
        # the merge runs at a store that leads both regions
        for rid in (far_id, mid_id):
            if cell.leader_store(rid) != cell.sids[0]:
                cell.transfer(rid, cell.sids[0])
        c0 = counts()
        t0 = time.perf_counter()
        merged = cell.client.merge(far_id, mid_id)
        merge_ms = (time.perf_counter() - t0) * 1e3
        regs = cell.wait_regions(len(regs) - 1)
        # every store destroys its source peer as it applies the commit
        t0 = time.perf_counter()
        while any(cell.peer(s, far_id) is not None for s in cell.servers):
            assert time.perf_counter() - t0 < 30, "net: the source lives"
            time.sleep(0.01)
        mlo, mhi = next((l, h) for r, l, h, _ in regs if r == merged.id)
        merged_read = cell.both_plans(mlo, mhi, warm=0)
        d = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        steps["merge"] = {"ms": merge_ms, "read": merged_read,
                          "launches": d}
        print(f"net moves: split {split_ms:.1f} ms at {at} (children cold "
              + " ".join(f"{r}: {k['agg'][0]['ms']:.1f} / "
                         f"{k['sel'][0]['ms']:.1f}" for r, k in kids.items())
              + f" ms), store 2's replica reads "
              f"{replica2['agg']['ms']:.1f} / {replica2['sel']['ms']:.1f} ms, "
              f"leader to "
              f"store 2 {away_ms:.1f} ms (promotion {promotion.get('ms', 0):.2f}"
              f" ms, {promotion.get('planes')} planes; read "
              f"{at2['agg'][0]['ms']:.1f} / {at2['sel'][0]['ms']:.1f} ms, "
              f"launches {json.dumps(d2)}, feed routes "
              f"{json.dumps(routes2)}), "
              f"back {back_ms:.1f} ms (read {back['agg'][0]['ms']:.1f} / "
              f"{back['sel'][0]['ms']:.1f} ms), merge {merge_ms:.1f} ms "
              f"(read {merged_read['agg'][0]['ms']:.1f} / "
              f"{merged_read['sel'][0]['ms']:.1f} ms)", flush=True)
        out["raft"] = cell.raft_calls()
        out["feed_routes"] = cell.feed_routes()
        out["rss_end"] = rss_bytes()
    finally:
        # -- 7. stop ----------------------------------------------------
        t0 = time.perf_counter()
        cell.stop()
        out["stop_ms"] = (time.perf_counter() - t0) * 1e3
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before and t.is_alive()]
    assert not left, f"net: threads left after stop: {left}"
    launches = counts()
    for name in ("hash_agg", "sel_pred", "mvcc_resolve", "patch_spans",
                 "split_planes"):
        assert launches[name] > 0, f"net never launched {name}"
    out["launches"] = launches
    out["steps"] = steps
    out["wall_s"] = time.perf_counter() - t_start
    del cell, model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"net: launches {json.dumps({k: v for k, v in launches.items() if v})}"
          f", feed_routes {json.dumps(out['feed_routes'])}, raft calls "
          f"{json.dumps(out['raft'])}, RSS at the end "
          f"{out['rss_end'] / 2**30:.2f} GiB, stop {out['stop_ms']:.1f} ms, "
          f"{out['wall_s']:.1f} s", flush=True)
    print("net cell: " + json.dumps(out, default=str), flush=True)
    return {"config": "net", "launches": launches, "wall_s": out["wall_s"],
            "load": {k: v for k, v in out["load"].items() if k != "raft"},
            "reads": out["reads"]}


CLI_KEYS = 1 << 16
CLI_STOP_S = 60.0               # SIGTERM to exit, at most


class _Proc:
    """A subprocess of ``python -m tikv_tpu_torch.server``, its output
    read line by line on a thread (the pipe never fills)."""

    def __init__(self, *args):
        import threading
        root = os.path.dirname(os.path.abspath(__file__))
        self.p = subprocess.Popen(
            [sys.executable, "-m", "tikv_tpu_torch.server", *args],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.lines: list = []
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self) -> None:
        for line in self.p.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, prefix: str, timeout: float) -> str:
        t0 = time.perf_counter()
        while True:
            for line in self.lines:
                if line.startswith(prefix):
                    return line
            assert self.p.poll() is None, \
                f"cli: exited {self.p.returncode}: {self.lines[-20:]}"
            assert time.perf_counter() - t0 < timeout, \
                f"cli: no {prefix!r} in {timeout} s: {self.lines[-20:]}"
            time.sleep(0.05)

    def stop(self, sig, timeout: float) -> int:
        self.p.send_signal(sig)
        rc = self.p.wait(timeout=timeout)
        self._t.join(timeout=5)
        return rc

    def kill(self) -> None:
        if self.p.poll() is None:
            self.p.kill()
            self.p.wait(timeout=30)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_cli() -> dict:
    """Phase cli's processes, started before cell net so that their start
    (the store's imports, its CUDA context and runner) overlaps net:
    ``python -m tikv_tpu_torch.server pd``, and once it listens ``...
    tikv --pd ... --status-addr ... --config etc/config-template.toml`` on
    free ports, the store on the card by default (a mesh runner over the
    card, from the file's knobs).  ``run_cli`` waits for the store."""
    from tikv_tpu_torch.device import build
    out = {"libs": sorted(os.listdir(build.BUILD_DIR)),
           "pd_addr": f"127.0.0.1:{free_port()}",
           "kv_addr": f"127.0.0.1:{free_port()}",
           "st_addr": f"127.0.0.1:{free_port()}",
           "t0": time.perf_counter(), "procs": []}
    try:
        pd = _Proc("pd", "--addr", out["pd_addr"])
        out["procs"].append(pd)
        pd.wait_for("pd listening", 120)
        out["procs"].append(_Proc(
            "tikv", "--addr", out["kv_addr"], "--pd", out["pd_addr"],
            "--status-addr", out["st_addr"],
            "--config", "etc/config-template.toml"))
    except BaseException:
        for p in out["procs"]:
            p.kill()
        raise
    return out


def run_cli(started: dict) -> dict:
    """Phase cli: the entry point as processes (``start_cli``'s): the
    store, on the card, loads the kernels this smoke built (the build
    directory must not change); ``ctl`` with ``put``, ``get``, ``region``,
    ``split``, ``stores``, ``store-status`` and ``tso``, each output
    checked; 2^16 rows of 6c's table ingested through this process's
    ``TxnClient``, the GROUP BY (``force_backend`` device: the template's
    ``device-row-threshold`` is 262,144) equal to the truth with
    ``backend == "device"``; ``GET /status`` and ``/config``, ``POST
    /config`` of ``coprocessor.region-cache-capacity`` read back, and a
    field that is not online refused; then SIGTERM: the store exits 0
    within ``CLI_STOP_S``."""
    import signal
    import urllib.error
    import urllib.request

    from tikv_tpu_torch.device import build
    from tikv_tpu_torch.server import TxnClient
    from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst
    from tikv_tpu_torch.testing import mvcc as tm
    from tikv_tpu_torch.testing.dag import DagSelect
    t_start = time.perf_counter()
    libs0 = started["libs"]
    pd_addr, kv_addr, st_addr = (started["pd_addr"], started["kv_addr"],
                                 started["st_addr"])
    out: dict = {"config": "cli"}
    procs = started["procs"]
    pd, kv = procs
    client = None
    try:
        line = kv.wait_for("tikv store ", 300)
        store_id = int(line.split()[2])
        # from the start to the store listening, and what of it the
        # phases between did not hide
        out["start_s"] = time.perf_counter() - started["t0"]
        out["start_wait_s"] = time.perf_counter() - t_start

        def ctl(*args) -> str:
            r = subprocess.run(
                [sys.executable, "-m", "tikv_tpu_torch.server", "ctl",
                 "--pd", pd_addr, *args],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=300)
            assert r.returncode == 0, (args, r.returncode, r.stderr[-2000:])
            return r.stdout.strip()

        t0 = time.perf_counter()
        assert ctl("put", "cli-k", "cli-v") == "OK"
        with ThreadPoolExecutor(4) as ex:
            got = dict(zip(("get", "region", "stores", "tso"), ex.map(
                lambda a: ctl(*a), (("get", "cli-k"),
                                    ("region", "--key", "cli-k"),
                                    ("stores",), ("tso",)))))
        assert got["get"] == "cli-v", got["get"]
        region = json.loads(got["region"])
        assert region["id"] == 1 and region["peers"][0][1] == store_id, \
            region
        assert got["stores"] == f"{store_id} {kv_addr}", got["stores"]
        ts = int(got["tso"])
        split = ctl("split", "cli-m")
        assert split.startswith("new region "), split
        right_id = int(split.split()[2])
        status = json.loads(ctl("store-status", str(store_id)))
        assert status["store_id"] == store_id and \
            {r["region"]["id"] for r in status["regions"]} == {1, right_id}, \
            status
        assert int(ctl("tso")) > ts
        out["ctl_s"] = time.perf_counter() - t0

        # 2^16 rows of 6c's table, then the GROUP BY on the card
        table = tm.table_6c()
        client = TxnClient(pd_addr)
        h = np.arange(CLI_KEYS, dtype=np.int64)
        c0, c1 = h % 1024, h % 1000
        blob = fast_mvcc_table_sst(table.table_id, h,
                                   [(2, c0, None), (3, c1, None)],
                                   client.tso())
        t0 = time.perf_counter()
        from tikv_tpu_torch.codec.keys import table_record_key
        assert client.ingest_sst(blob, table_record_key(
            table.table_id, 0)) == CLI_KEYS
        out["ingest_ms"] = (time.perf_counter() - t0) * 1e3
        s = DagSelect.from_table(table, ["id", "c0", "c1"])
        dag = s.aggregate([s.col("c0")], [("count_star", None),
                                          ("sum", s.col("c1"))]).build(
            client.tso())
        t0 = time.perf_counter()
        resp = client.coprocessor(dag, force_backend="device", timeout=300)
        out["group_by_cold_ms"] = (time.perf_counter() - t0) * 1e3
        assert resp["backend"] == "device", resp["backend"]
        cnt = np.bincount(c0, minlength=1024)
        sm = np.bincount(c0, weights=c1.astype(np.float64), minlength=1024)
        assert sorted(map(tuple, resp["rows"]), key=lambda r: r[2]) == \
            [(int(cnt[g]), int(sm[g]), g) for g in range(1024)], \
            "cli: wrong GROUP BY"

        # the status server
        base = f"http://{st_addr}"

        def http(path: str, body=None) -> tuple:
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(base + path, data=data,
                                         method="GET" if body is None
                                         else "POST")
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code, st = http("/status")
        assert code == 200 and st["store_id"] == store_id, (code, st)
        code, cfg = http("/config")
        assert code == 200 and \
            cfg["coprocessor"]["region_cache_capacity"] == 8, cfg
        code, r = http("/config", {"coprocessor.region-cache-capacity": 4})
        assert code == 200 and r["applied"] == {
            "coprocessor.region_cache_capacity": 4}, (code, r)
        assert http("/config")[1]["coprocessor"][
            "region_cache_capacity"] == 4
        code, r = http("/config", {"storage.data-dir": "/x"})
        assert code == 400 and "not an online-config field" in r["error"], \
            (code, r)

        # SIGTERM: a graceful exit
        t0 = time.perf_counter()
        rc = kv.stop(signal.SIGTERM, CLI_STOP_S)
        out["sigterm_s"] = time.perf_counter() - t0
        assert rc == 0, (rc, kv.lines[-20:])
        pd.kill()
    finally:
        if client is not None:
            client.close()
        for p in procs:
            p.kill()
    assert sorted(os.listdir(build.BUILD_DIR)) == libs0, \
        "cli: the store rebuilt a kernel"
    out["wall_s"] = time.perf_counter() - t_start
    print("cli phase: " + json.dumps(out), flush=True)
    return {"config": "cli", "launches": {k: 0 for k in KERNELS},
            "wall_s": out["wall_s"], "figures": out}


def spans_at_main_shapes(dev, n_pad: int, shapes: dict) -> tuple:
    """``patch_feed_spans`` at 6c-delta's w1, w2 and w3 shapes over the
    selection feed's planes (three int32 planes of ``n_pad`` rows), values
    from the host as the runner gives them, the recorded digests by
    address (the last patch's R'): first held against the plain version
    on clones of the planes, planes and (P, 3) digests bit for bit; then
    every form timed queued on the same inputs — the kernel, the same
    rows through ``patch_feed_rows`` with host positions, and the library
    yardstick ``plane[lo:hi].copy_(vals)`` a plane a span (no digests)
    from the same values in pinned host memory, and the rows form's,
    ``index_put_`` a plane at the positions — and once more with the
    values on the card (the kernel and ``copy_``); the plain version as
    issued; the bound: rows × the planes' widths × 2 plus the payload, at
    3.35 TB/s → (the timings, the worst difference: 0).  Launches made
    here are not counted."""
    from tikv_tpu_torch.device import digest as dg
    saved = counts()
    gen = torch.Generator().manual_seed(29)
    planes = [random_plane(torch.int32, n_pad, gen, dev) for _ in range(3)]
    recs = list(torch.zeros((3, 3), dtype=torch.int64, device=dev)[:, 2])
    out, worst = {}, 0
    for w, spans in shapes.items():
        m = sum(hi - lo for lo, hi in spans)
        vals = [random_plane(torch.int32, m, gen, dev) for _ in planes]
        host = [v.cpu().numpy() for v in vals]
        pinned = [v.cpu().pin_memory() for v in vals]
        twins = [a.clone() for a in planes]
        want = dg.patch_feed_spans_plain(twins, spans, vals, recs)
        got = dg.patch_feed_spans(planes, spans, host, recs)
        err = patch_err(planes, twins, got, want)
        del twins
        assert err == 0, f"patch_feed_spans at {w}'s shape differs ({err})"
        worst = max(worst, err)
        pos = dg.span_positions(spans)
        lay = dg.plan_spans([4] * 3, len(spans), m, [True] * 3, True)
        iters = 20 if m > 4096 else 50
        offs = np.concatenate([[0], np.cumsum([hi - lo for lo, hi in spans])])
        pinned_pos = torch.as_tensor(np.asarray(pos, np.int64)).pin_memory()

        def index_put_rows():
            """The rows form's yardstick: ``index_put_`` a plane, the
            positions and values copied from pinned host memory."""
            at = pinned_pos.to(dev, non_blocking=True)
            for a, v in zip(planes, pinned):
                a.index_put_((at,), v.to(dev, non_blocking=True))

        def copy_from(src):
            def library():
                for a, v in zip(planes, src):
                    for (lo, hi), o in zip(spans, offs[:-1].tolist()):
                        a[lo:hi].copy_(v[o:o + hi - lo], non_blocking=True)
            return library

        out[w] = {"ms": cuda_ms(lambda: dg.patch_feed_spans(
                      planes, spans, host, recs), iters, queued=True),
                  "rows_form_ms": cuda_ms(lambda: dg.patch_feed_rows(
                      planes, pos, host, recs), iters, queued=True),
                  "rows_form_library_ms": cuda_ms(index_put_rows, iters,
                                                  queued=True),
                  "rows_form_library_call": "index_put_ a plane at the "
                                            "positions, positions and "
                                            "values from pinned host "
                                            "memory (no digests)",
                  "plain_ms": cuda_ms(lambda: dg.patch_feed_spans_plain(
                      planes, spans, vals, recs), 10),
                  "library_ms": cuda_ms(copy_from(pinned), iters,
                                        queued=True),
                  "library_call": "plane[lo:hi].copy_(vals) a plane a span "
                                  "from pinned host values (no digests)",
                  "card_values": {
                      "ms": cuda_ms(lambda: dg.patch_feed_spans(
                          planes, spans, vals, recs), iters, queued=True),
                      "library_ms": cuda_ms(copy_from(vals), iters,
                                            queued=True)},
                  **bound_ms(m * 4 * 3 * 2 + lay.size, 0),
                  "rows": m, "spans": len(spans), "planes": 3,
                  "payload_bytes": lay.size,
                  "inline": lay.inline is not None}
    set_counts(saved)
    print("patch_feed_spans at 6c-delta's shapes (all queued; the kernel "
          "and copy_ from the same host values, and with values on the "
          "card): " + json.dumps(out), flush=True)
    return out, worst


# ---------------------------------------------------------------------------
# the mesh: a row-sharded feed, per-shard kernels, the cross-shard merges
# ---------------------------------------------------------------------------

# the smoke's mesh: four shards of one card, 2×2 (with more cards, a mesh
# over every card as well)
MESH_SHAPE = (2, 2)
# mesh cell → (the kernels each shard launches, the merges it launches)
MESH_ROUTE = {"m3": ({"hash_agg"}, {"shard_psum"}),
              "m4": ({"hash_agg"}, {"shard_psum"}),
              # one shard_merge launch: the fold's sums and MIN/MAX rows
              "m4x": ({"sel_pred", "agg_fold"}, {"shard_bucket_merge"}),
              "m4n": ({"twolevel"}, {"shard_psum"}),
              "m4s": ({"hash_agg"}, {"shard_psum"}),
              "m2s": ({"sel_pred"}, set()),
              "m5t": ({"sel_pred", "topn_select"}, set())}
# kernels whose launches a request makes once a shard (the others' count
# depends on the route each shard takes)
ONCE_A_SHARD = ("hash_agg", "twolevel", "agg_fold", "sel_pred")


def shard_merge_cases(dev):
    """(name, kind, sources, segments) over S of 1, 2, 3, 4 and 8: int64
    words with the extremes (the psum wraps), float64 words with ±0.0,
    ±inf and NaN, W not a multiple of 2 or 4, mixed int64 / float64
    segments in one launch, sum and min/max segments in one launch (kind
    "mixed": ``shard_merge``), sources on one 16-byte phase off the
    boundary and on mixed phases."""
    rng = np.random.default_rng(51)
    i64 = np.iinfo(np.int64)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0,
                         -1.0, 5e-324, 1.7e308])

    def words(W, kind):
        if kind == "f64":
            x = rng.normal(0.0, 1e3, W)
            hit = rng.random(W) < 0.2
            x[hit] = rng.choice(specials, int(hit.sum()))
            return x.view(np.int64)
        x = rng.integers(i64.min, i64.max, W, dtype=np.int64,
                         endpoint=True)
        hit = rng.random(W) < 0.2
        x[hit] = rng.choice(np.array([i64.min, i64.max, -1, 0, 1]),
                            int(hit.sum()))
        return x

    def sources(S, W, kind, phases):
        out = []
        for s in range(S):
            off = phases[s % len(phases)]
            buf = torch.from_numpy(np.concatenate(
                [words(off, kind), words(W, kind), words(3, kind)])).to(dev)
            out.append(buf[off:off + W])        # off a 16-byte boundary
        return out

    for S in (1, 2, 3, 4, 8):
        for W in (1, 3, 1027, 65537):
            for phases in ((0,), (1,), (0, 1)):
                tag = f"S={S} W={W} phases={phases}"
                yield f"psum i64 {tag}", "psum", sources(
                    S, W, "i64", phases), [(0, W, "sum_i64")]
                yield f"psum f64 {tag}", "psum", sources(
                    S, W, "f64", phases), [(0, W, "sum_f64")]
                h = W // 2
                yield f"psum mixed {tag}", "psum", sources(
                    S, W, "f64", phases), [(0, h, "sum_i64"),
                                           (h, W - h, "sum_f64")]
                for op in ("min", "max"):
                    yield f"merge {op} i64 {tag}", "merge", sources(
                        S, W, "i64", phases), [(0, W, f"{op}_i64")]
                    yield f"merge {op} f64 {tag}", "merge", sources(
                        S, W, "f64", phases), [(0, W, f"{op}_f64")]
    # sum and min/max segments in one launch (shard_merge): int64 and
    # float64 words side by side, S = 2, 4, 8 and the general path
    for S in (2, 3, 4, 8):
        for W in (1027, 65537):
            for phases in ((0,), (1,), (0, 1)):
                tag = f"S={S} W={W} phases={phases}"
                x = sources(S, W, "i64", phases)
                f = sources(S, W, "f64", phases)
                q = W // 6
                for s in range(S):
                    x[s][q:3 * q] = f[s][q:3 * q]
                    x[s][5 * q:] = f[s][5 * q:]
                yield f"mixed {tag}", "mixed", x, [
                    (0, q, "sum_i64"), (q, q, "sum_f64"),
                    (2 * q, q, "min_f64"), (3 * q, q, "max_i64"),
                    (4 * q, q, "min_i64"), (5 * q, W - 5 * q, "max_f64")]
                yield f"mixed m4x-like {tag}", "mixed", sources(
                    S, W, "i64", phases), [
                    (0, W // 2, "sum_i64"), (W // 2, W // 4, "min_i64"),
                    (W // 2 + W // 4, W - W // 2 - W // 4, "max_i64")]
    # past the segments a parameter block holds: a table on the card
    parts = sources(3, 400, "i64", (1,))
    yield "psum 100 segments", "psum", parts, [(4 * i, 4, "sum_i64")
                                               for i in range(100)]
    parts = sources(5, 400, "f64", (0, 1))
    yield "merge 9 segments", "merge", parts, [
        (40 * i + i, 33, ("min_f64", "max_i64")[i % 2]) for i in range(9)]
    parts = sources(4, 600, "f64", (0,))
    yield "mixed 12 segments", "mixed", parts, [
        (50 * i, 41, ("sum_f64", "min_f64", "max_f64", "sum_i64",
                      "min_i64", "max_i64")[i % 6]) for i in range(12)]


def check_shard_merge(dev) -> int:
    """``shard_psum``, ``shard_bucket_merge`` and ``shard_merge`` against
    their plain versions on the card, bit for bit (every word, the ones
    outside the segments left as they were); a mixed launch also against
    the psum of its sum segments followed by the bucket merge of the rest;
    → 0."""
    from tikv_tpu_torch.device import shard as sh
    saved = counts()
    n_cases = {}
    for name, kind, parts, segs in shard_merge_cases(dev):
        init = torch.randint(-9, 9, (parts[0].numel(),), dtype=torch.int64,
                             device=dev)
        run, plain = {
            "psum": (sh.shard_psum, sh.shard_psum_plain),
            "merge": (sh.shard_bucket_merge, sh.shard_bucket_merge_plain),
            "mixed": (sh.shard_merge, sh.shard_merge_plain)}[kind]
        before = counts()
        got = run(parts, segs, out=init.clone())
        after = counts()
        want = plain(parts, segs, out=init.clone())
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"shard merge case {name} differs"
        one = "shard_psum" if kind == "psum" else "shard_bucket_merge"
        assert after[one] == before[one] + 1 and sum(
            after[k] - before[k] for k in KERNELS) == 1, \
            f"shard merge case {name}: not one launch"
        if kind == "mixed":
            two = sh.shard_psum(parts, [g for g in segs
                                        if g[2].startswith("sum")],
                                out=init.clone())
            sh.shard_bucket_merge(parts, [g for g in segs
                                          if not g[2].startswith("sum")],
                                  out=two)
            torch.cuda.synchronize()
            assert torch.equal(got, two), \
                f"shard merge case {name}: one launch and two differ"
        n_cases[kind] = n_cases.get(kind, 0) + 1
    set_counts(saved)
    print(f"check shard_merge: {sum(n_cases.values())} cases ({n_cases}) "
          f"bit-equal to the plain versions", flush=True)
    return 0


def mesh_cell_plans(cell: str, table, snap) -> list:
    """(label, wire-decoded DAG, answer, agrees, extra) of each plan of a
    mesh cell; m2s: config 2's ``v > 800``, then 2s's 0.1%."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf
    config, _n = cf.MESH_CELLS[cell]
    if config == "2s":
        out = []
        for point, thr in (("10%", 800), ("0.1%", cf.sweep_threshold(
                snap, cf.SWEEP["0.1%"]))):
            want = cf.row_truth_columns("2s", snap, thr)
            out.append((f"{cell}@{point}", dag_from_wire(enc_dag(
                cf.dag_selection(table, thr))), lambda r: r.batch,
                lambda b, w=want: cf.columns_agree(b, w),
                {"selected": len(want[0][0])}))
        return out
    if config in cf.ROW_CONFIGS:
        want = cf.row_truth_columns(config, snap)
        return [(cell, dag_from_wire(enc_dag(cf.ROW_CONFIGS[config][1](
            table))), lambda r: r.batch,
            lambda b: cf.columns_agree(b, want),
            {"selected": len(want[0][0])})]
    make = cf.MESH_AGGS[config][1] if config in cf.MESH_AGGS \
        else cf.CONFIGS[config][1]
    want, scales = cf.truth(config, snap)
    return [(cell, dag_from_wire(enc_dag(make(table))), lambda r: r.rows(),
             lambda rows: cf.rows_agree(rows, want, scales, SF_TOL),
             {"groups": len(want)})]


def mesh_table(cell: str):
    from tikv_tpu_torch.testing import configs as cf
    config, n = cf.MESH_CELLS[cell]
    if config in cf.MESH_AGGS:
        build = cf.MESH_AGGS[config][0]
    elif config == "2s":
        build = cf.build_table
    elif config in cf.ROW_CONFIGS:
        build = cf.ROW_CONFIGS[config][0]
    else:
        build = cf.CONFIGS[config][0]
    return build(n)


def same_answer(a, b) -> bool:
    """Two runners' answers: the same rows, NaN equal to NaN."""
    ra, rb = a.rows(), b.rows()
    return len(ra) == len(rb) and all(
        len(x) == len(y) and all(
            u == v or (isinstance(u, float) and isinstance(v, float) and
                       math.isnan(u) and math.isnan(v))
            for u, v in zip(x, y)) for x, y in zip(ra, rb))


def mesh_phases(runner, dag, snap) -> dict:
    """The per-request tracker phases (ms) of one warm request."""
    from tikv_tpu_torch.utils import tracker
    saved = counts()
    tr, tok = tracker.install()
    try:
        runner.handle_request(dag, snap)
    finally:
        tracker.uninstall(tok)
    set_counts(saved)
    return {k: v / 1e6 for k, v in tr.phases.items()}


def run_mesh_cell(cell: str, mesh_runner, single, tag: str = "",
                  timings: dict = None) -> list:
    """One mesh cell: its table and truth, then per plan the single
    runner's answer to the request (its launches counted), and one cold and
    five warm wire-encoded requests on the mesh runner (``serve``: each
    answer against the truth, the launch counts read around the run): the
    same answer as the single runner, each per-shard kernel launched S
    times as often as on the single runner where it launches once a shard,
    the merges of the route, the tracker phases of a warm request, no
    degrade.  ``timings``: where the
    cell's main-shape timings go (``mesh_timing``), if it has some."""
    from tikv_tpu_torch.testing import configs as cf
    _config, n = cf.MESH_CELLS[cell]
    S = mesh_runner._nshards()
    t0 = time.perf_counter()
    table, snap = mesh_table(cell)
    plans = mesh_cell_plans(cell, table, snap)
    print(f"mesh {tag}{cell}: table and truth in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    per_shard, merges = MESH_ROUTE[cell]
    runs = []
    for label, dag, answer, agrees, extra in plans:
        saved = counts()
        set_counts({k: 0 for k in KERNELS})
        want = single.handle_request(dag, snap)
        once = counts()
        set_counts(saved)
        assert agrees(answer(want)), f"mesh {label}: the single runner"
        out = serve(f"{tag}{label}", n, mesh_runner, dag, snap, answer,
                    agrees, per_shard | merges, shards=S,
                    mesh=tag.strip() or "x".join(map(str, MESH_SHAPE)),
                    **extra)
        got = mesh_runner.handle_request(dag, snap)
        assert same_answer(got, want), \
            f"mesh {label}: the mesh and the single runner differ"
        launches = out["launches"]
        for name in per_shard:
            assert launches[name] % S == 0, \
                f"mesh {label}: {name} launched {launches[name]} times"
            if name in ONCE_A_SHARD:
                assert launches[name] == 6 * S * once[name], \
                    f"mesh {label}: {name} launched {launches[name]} " \
                    f"times, the single runner {once[name]} a request"
        if "0.1%" in label:
            assert set(out["last_route"]) == {"index"}, \
                f"mesh {label} took {out['last_route']}"
        assert mesh_runner.degrades == {}, mesh_runner.degrades
        out["phases_ms"] = mesh_phases(mesh_runner, dag, snap)
        print(f"mesh {tag}{label}: same answer as the single runner; "
              f"phases " + " ".join(f"{k}={v}" for k, v in
                                    out["phases_ms"].items()), flush=True)
        runs.append(out)
        if timings is not None and cell in MESH_TIMED:
            timings[cell] = mesh_timing(cell, mesh_runner, single, dag,
                                        snap)
    del snap
    gc.collect()
    return runs


def run_shard_launch_degrade(mesh_runner) -> None:
    """``device::shard_launch`` armed at shard 1 on a warm m4 request: the
    host pipeline answers the whole request (equal to the truth), nothing
    of the shards that launched is used, the dispatch lock is free after,
    and the next request runs on the card again."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.utils import failpoint
    table, snap = cf.build_table(1 << 22)
    dag = dag_from_wire(enc_dag(cf.dag_hash_agg(table)))
    want, scales = cf.truth("4", snap)
    assert cf.rows_agree(mesh_runner.handle_request(dag, snap).rows(), want,
                         scales, SF_TOL)
    before = dict(mesh_runner.degrades)
    saved = counts()
    failpoint.cfg("device::shard_launch", "return(1)")
    try:
        got = mesh_runner.handle_request(dag, snap).rows()
    finally:
        failpoint.teardown()
    # the host pipeline's groups come in first-seen order
    assert cf.rows_agree(sorted(got, key=lambda r: r[-1]), want, scales,
                         SF_TOL), "degraded answer"
    assert mesh_runner.degrades.get("shard_launch", 0) == \
        before.get("shard_launch", 0) + 1, mesh_runner.degrades
    degraded = counts()
    assert degraded["shard_psum"] == saved["shard_psum"], \
        "a degraded request merged its shards"
    assert mesh_runner._dispatch_mu.acquire(timeout=5), "dispatch lock held"
    mesh_runner._dispatch_mu.release()
    assert cf.rows_agree(mesh_runner.handle_request(dag, snap).rows(), want,
                         scales, SF_TOL)
    assert counts()["shard_psum"] == degraded["shard_psum"] + 1
    set_counts(saved)
    mesh_runner.degrades.pop("shard_launch")
    print(f"mesh shard_launch: shard 1's launches failed, the host "
          f"pipeline answered; launches on the shards before it "
          f"{degraded['hash_agg'] - saved['hash_agg']}; the next request "
          f"ran on the card", flush=True)


def run_mesh_endpoint(mesh_runner) -> None:
    """One 4x request through ``Endpoint.handle(force_backend="device")``
    over the mesh runner: the truth, no degrade."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.endpoint import CopRequest, Endpoint
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf
    table, snap = cf.build_multichip_table(1 << 22)
    dag = dag_from_wire(enc_dag(cf.dag_4x(table)))
    want, scales = cf.truth("4x", snap)
    ep = Endpoint(lambda req: snap, mesh_runner, device_row_threshold=1)
    try:
        resp = ep.handle(CopRequest(103, dag, force_backend="device"))
    finally:
        ep.close()
    assert resp.backend == "device" and not ep.degrades, ep.degrades
    assert cf.rows_agree(resp.rows(), want, scales, SF_TOL), \
        "the endpoint over the mesh"
    print(f"mesh endpoint: backend={resp.backend} rows={len(resp.rows())} "
          f"degrades={ep.degrades}", flush=True)


def run_mesh_host_merge(mesh_runner, single) -> None:
    """A simple aggregation's MIN and MAX (``WHERE v > 0: COUNT(*), MIN(v),
    MAX(v)`` over 4x's table at 2^22 rows) on the mesh: the S stacked rows
    reduced on the host in the ``shard_merge`` phase, the answer equal to
    the numpy truth and to the single runner's (launches not counted)."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.testing.dag import DagSelect
    table, snap = cf.build_multichip_table(1 << 22)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = dag_from_wire(enc_dag(s.where(s.col("v") > 0).aggregate(
        [], [("count_star", None), ("min", s.col("v")),
             ("max", s.col("v"))]).build()))
    v = snap.columns[3].values
    v = v[v > 0]
    want = [[int(v.size), int(v.min()), int(v.max())]]
    saved = counts()
    got = mesh_runner.handle_request(dag, snap)
    one = single.handle_request(dag, snap)
    set_counts(saved)
    assert [list(r) for r in got.rows()] == want, (got.rows(), want)
    assert same_answer(got, one), "host merge: the mesh and the single runner"
    phases = mesh_phases(mesh_runner, dag, snap)
    assert "shard_merge" in phases, phases
    assert mesh_runner.degrades == {}, mesh_runner.degrades
    print("mesh host merge (simple MIN/MAX): same answer as the single "
          "runner; phases " + " ".join(f"{k}={x}" for k, x in
                                       phases.items()), flush=True)


def time_merge(label: str, run, plain, parts, segs, library,
               library_call: str) -> dict:
    """A merge on the runner's own arguments: against its plain version
    (bit for bit) and timed beside its bound (each source's words of the
    segments read once, the output's written once; S − 1 operations a
    word), its plain version and ``library``."""
    out = parts[0].clone()
    got = run(parts, segs, out=out.clone())
    want = plain(parts, segs, out=out.clone())
    assert torch.equal(got, want), f"{label} differs at its main shape"
    words = sum(n for _o, n, _op in segs)
    b, ops = 8 * words * (len(parts) + 1), words * max(len(parts) - 1, 1)
    t = {"ms": cuda_ms(lambda: run(parts, segs, out=out), 200, queued=True),
         "plain_ms": cuda_ms(lambda: plain(parts, segs, out=out), 20),
         "library_ms": cuda_ms(library, 20), "library_call": library_call,
         **bound_ms(b, ops), "shards": len(parts),
         "words": sum(n for _o, n, _op in segs), "segments": len(segs)}
    print(f"kernel {label}: max_abs_err=0 " + " ".join(
        f"{k}={x}" for k, x in t.items()), flush=True)
    return t


def psum_issue(parts, segs, run=None) -> dict:
    """``run`` (``shard_psum`` by default, or ``shard_merge``) as issued:
    host-clock ms a call over 200 calls (the wrapper's checks, the cached
    layout, the launch), and the packed parameter block's bytes."""
    from tikv_tpu_torch.device import shard as sh
    run = sh.shard_psum if run is None else run
    out = parts[0].clone()
    saved = counts()
    run(parts, segs, out=out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        run(parts, segs, out=out)
    torch.cuda.synchronize()
    set_counts(saved)
    lay = sh._layout(parts[0].device, parts, segs, out)
    return {"issued_host_ms": (time.perf_counter() - t0) * 1e3 / 200,
            "param_bytes": ctypes.sizeof(lay.args)}


def merge_chain(cell: str, fn, shards, merges: dict,
                rounds: int = 3) -> dict:
    """A mesh cell's chain: its per-shard kernel calls ``shards`` (of
    ``fn``: m4's four ``hash_agg``, m4x's four ``agg_fold``), then each of
    ``merges`` (label → the launches it makes), queued; minus the shard
    calls alone → each one's marginal ms (medians of ``rounds``
    interleaved rounds of 50 chains)."""
    saved = counts()

    def run(merge):
        def chain():
            for a, k in shards:
                fn(*a, **k)
            if merge is not None:
                merge()
        return chain

    got = {label: [] for label in ("shards", *merges)}
    for _ in range(rounds):
        for label, merge in (("shards", None), *merges.items()):
            got[label].append(cuda_ms(run(merge), 50, queued=True))
    set_counts(saved)
    med = {k: float(np.median(v)) for k, v in got.items()}
    res = {"shards_ms": med["shards"],
           **{f"{k} chain_ms": med[k] for k in merges},
           **{f"{k} marginal_ms": med[k] - med["shards"] for k in merges},
           "runs": got}
    print(f"chain {cell} ({len(shards)} {fn.__name__} + merge, queued): " +
          json.dumps(res), flush=True)
    return res


# mesh cell → the per-shard kernel timed beside the single launch, and the
# merge timed there
MESH_TIMED = {"m4": ("hash_agg", "shard_psum"),
              "m4n": ("twolevel_fused", "shard_psum"),
              "m4x": ("agg_fold", "shard_merge")}


def mesh_timing(cell: str, mesh_runner, single, dag, snap) -> dict:
    """At m4, m4n and m4x: the sum of the per-shard launches
    (``hash_agg``, ``twolevel_fused``, ``agg_fold``) beside the single
    runner's one launch over the whole feed, on the runners' own
    arguments; ``shard_psum`` (m4, m4n) and ``shard_merge`` (m4x) on the
    mesh runner's own arguments, against their plain versions, beside
    their bounds and a yardstick the port never calls
    (``torch.stack(parts).sum(0)``; and ``.amin(0)`` / ``.amax(0)`` of
    each stacked row), as issued, and in the chain after the per-shard
    kernels."""
    import tikv_tpu_torch.device.runner as rmod
    from tikv_tpu_torch.device import hash_agg as ha
    from tikv_tpu_torch.device import shard as sh
    kernel, merge = MESH_TIMED[cell]
    out = {}
    if kernel is not None:
        owner = ha if kernel == "hash_agg" else rmod
        fn = getattr(owner, kernel)
        shards = captured_calls(owner, kernel,
                                lambda: mesh_runner.handle_request(dag, snap))
        one = captured_calls(owner, kernel,
                             lambda: single.handle_request(dag, snap))
        saved = counts()
        out = {"kernel": kernel, "launches": len(shards),
               "shards_ms": cuda_ms(lambda: [fn(*a, **k) for a, k in shards],
                                    20, queued=True),
               "single_ms": cuda_ms(lambda: [fn(*a, **k) for a, k in one],
                                    20, queued=True)}
        set_counts(saved)
        print(f"mesh {cell}: {kernel} over {len(shards)} shards "
              f"{out['shards_ms']} ms, one launch over the whole feed "
              f"{out['single_ms']} ms", flush=True)
    (args, kw), = captured_calls(sh, merge,
                                 lambda: mesh_runner.handle_request(dag, snap))
    parts = list(args[0])
    segs = (args[1] if len(args) > 1 else kw.get("segments")) or \
        sh._default_segments(parts)
    if merge == "shard_psum":
        out["merge"] = time_merge(
            f"shard_psum at {cell}", sh.shard_psum, sh.shard_psum_plain,
            parts, segs, lambda: torch.stack(parts).sum(0),
            "torch.stack(parts).sum(0) (yardstick)")
        out["merge"].update(psum_issue(parts, segs))
        if kernel == "hash_agg":
            res = parts[0].clone()
            # the psum launched as the wrapper does (programmatically) and
            # not
            out["merge"]["chain"] = merge_chain(cell, fn, shards, {
                f"psum {kind}": lambda dep=dep: sh._launch(
                    parts, segs, res, True, dependent=dep)
                for kind, dep in (("programmatic", True),
                                  ("plain launch", False))})
        return out
    rows = [(op, [p[o:o + n] for p in parts]) for o, n, op in segs]

    def library():
        for op, r in rows:
            st = torch.stack(r)
            st.sum(0) if op.startswith("sum") else \
                st.amin(0) if op.startswith("min") else st.amax(0)

    out["merge"] = time_merge(
        f"shard_merge at {cell}", sh.shard_merge, sh.shard_merge_plain,
        parts, segs, library, "torch.stack(segment parts).sum(0) / "
        ".amin(0) / .amax(0) a segment (yardstick)")
    out["merge"].update(psum_issue(parts, segs, sh.shard_merge))
    sums = [g for g in segs if g[2].startswith("sum")]
    stacked = [g for g in segs if not g[2].startswith("sum")]
    res = parts[0].clone()
    out["merge"]["chain"] = merge_chain(cell, fn, shards, {
        "one launch": lambda: sh.shard_merge(parts, segs, out=res),
        "psum alone": lambda: sh.shard_psum(parts, sums, out=res),
        "psum then bucket merge": lambda: (
            sh.shard_psum(parts, sums, out=res),
            sh.shard_bucket_merge(parts, stacked, out=res))})
    return out


# the mesh cells that launch no kernel of selection.cu: they run while it
# builds
MESH_EARLY = ("m3", "m4", "m4n", "m4s")


def run_mesh(mesh_runner, single, cells, timings: dict) -> list:
    """The mesh cells ``cells`` on ``mesh_runner`` (their main-shape
    timings into ``timings``) → their runs."""
    runs = []
    for cell in cells:
        runs += run_mesh_cell(cell, mesh_runner, single, timings=timings)
    return runs


def run_mesh_rest(mesh_runner, single) -> list:
    """The ``shard_launch`` degrade, the endpoint over the mesh, a simple
    MIN/MAX merged on the host, and, where the machine has more than one card, m4, m4x and m5t over a mesh of
    every card → their runs."""
    from tikv_tpu_torch.device import DeviceRunner
    from tikv_tpu_torch.parallel import make_mesh
    run_shard_launch_degrade(mesh_runner)
    run_mesh_endpoint(mesh_runner)
    run_mesh_host_merge(mesh_runner, single)
    runs = []
    if torch.cuda.device_count() > 1:
        every = DeviceRunner(mesh=make_mesh())
        tag = "x".join(map(str, every._mesh.devices.shape)) + " cards "
        for cell in ("m4", "m4x", "m5t"):
            runs += run_mesh_cell(cell, every, single, tag)
        del every
        gc.collect()
    return runs


# ---------------------------------------------------------------------------
# the scale-out mesh: feed_verify and cell so8
# ---------------------------------------------------------------------------

# cell so8: eight regions of int_table(2)'s shape (6b-ep's tables) of 2^21
# rows — one region at region_split_size_mb = 96, below placement_rows =
# 2^22, so each is placed whole on one slice — and one of 10·2^20 rows
# (6b-ep's size), which takes the whole-mesh route
SO8_ROWS, SO8_BIG_ROWS = 1 << 21, 10 << 20
SO8_TABLE_IDS = tuple(range(9930, 9939))
# Zipf rank → table: the whole-mesh region is the third most requested
SO8_RANK = (0, 1, 8, 2, 3, 4, 5, 6, 7)
SO8_CLIENTS, SO8_REQS = 16, 16
SO8_COOLDOWN_S = 0.05
# a served fetch this slow strikes its slice 0.25: some 17 times so8's
# warm p50, so a card that stalls is struck and one that queues is not
SO8_LATENCY_OUTLIER_S = 1.0
SO8_DEAD = 1            # the slice device::slice_dead kills


def check_feed_verify(dev) -> int:
    """``feed_verify`` against its plain version and against one
    ``plane_digest`` launch a plane, bit for bit: P of 1, 3, 7 (every feed
    width: bool, int8, int16, int32, int64, float32, float64), 96 (the most
    the launch parameters hold), 97 and 200 (the device table), planes 0-7
    elements off a 16-byte boundary on mixed phases, n of 1, 15, 4097 and
    2^24 + 3 (P ≤ 7), ranges full, ragged and empty → the worst digest
    distance."""
    from tikv_tpu_torch.device import digest as dg
    gen = torch.Generator().manual_seed(23)
    saved = counts()
    worst = cases = 0
    for n in (1, 15, 4097, (1 << 24) + 3):
        for P in (1, 3, 7, 96, 97, 200):
            if n > 4097 and P > 7:
                continue
            planes = []
            for p in range(P):
                off = (3 * p) % 8
                planes.append(random_plane(FEED_DTYPES[p % len(FEED_DTYPES)],
                                           n + 8, gen, dev)[off:off + n])
            for lo, hi in ((0, n), (1, max(1, n - 1)), (n // 3, n // 2),
                           (n, n)):
                got = dg.feed_verify(planes, lo, hi).tolist()
                want = dg.feed_verify_plain(planes, lo, hi).tolist()
                one = [dg.plane_digest(a, lo, hi) for a in planes]
                for g, w, o in zip(got, want, one):
                    worst = max(worst, digest_err(g, w), digest_err(g, o))
                cases += 1
            del planes
    torch.cuda.synchronize()
    set_counts(saved)
    print(f"check feed_verify: {cases} cases (P 1-200, 7 widths, 4 "
          f"lengths, 4 ranges): worst digest distance {worst}", flush=True)
    assert worst == 0, "feed_verify disagrees"
    return worst


def queued_ms(fn, iters: int, tries: int = 3) -> float:
    """``cuda_ms(fn, iters, queued=True)``, taken again (at most ``tries``
    times) when the shared host issued the calls too slowly to time."""
    for left in range(tries - 1, -1, -1):
        try:
            return cuda_ms(fn, iters, queued=True)
        except AssertionError:
            if not left:
                raise
            print("timing: the host was slow, timing again", flush=True)


def feed_verify_at_main_shape(feed: dict) -> tuple:
    """``feed_verify`` over a so8 feed's resident planes (a migrated
    selection feed: three int32 planes, 2^21 live rows) against its plain
    version and one ``plane_digest`` a plane, bit for bit; timed queued
    beside its bound (the live bytes read once at 3.35 TB/s; a multiply
    and an add an element), its plain version and the P launches it
    replaces (the reference checks plane by plane); and the copy
    ``install_feeds`` makes of those planes (``copy_`` into storage of the
    destination's own) beside its bound, the padded planes' bytes read
    and written once → (timings, worst digest distance)."""
    from tikv_tpu_torch.device import digest as dg
    planes, n = list(feed["flat"]), feed["n_live"]
    saved = counts()
    got = dg.feed_verify(planes, 0, n).tolist()
    err = max([digest_err(g, w) for g, w in zip(
        got, dg.feed_verify_plain(planes, 0, n).tolist())] +
        [digest_err(g, dg.plane_digest(a, 0, n)) for g, a in zip(got,
                                                                 planes)])
    live = sum(n * a.element_size() for a in planes)
    padded = sum(a.numel() * a.element_size() for a in planes)
    dst = [torch.empty_like(a) for a in planes]
    gc.collect()
    t = {"ms": queued_ms(lambda: dg.feed_verify(planes, 0, n), 200),
         "plain_ms": cuda_ms(lambda: dg.feed_verify_plain(planes, 0, n), 10),
         "library_ms": None,
         "yardstick_ms": queued_ms(lambda: [dg.plane_digest(a, 0, n)
                                            for a in planes], 100),
         "yardstick": f"{len(planes)} plane_digest launches, one a plane",
         **bound_ms(live, 2 * n * len(planes)), "planes": len(planes),
         "rows": n, "n_pad": feed["n_pad"],
         "dtypes": [str(a.dtype) for a in planes], "bytes": live,
         "copy_ms": queued_ms(lambda: [b.copy_(a, non_blocking=True)
                                       for a, b in zip(planes, dst)], 100),
         "copy_bound_ms": 2 * padded / HBM_BYTES_PER_S * 1e3,
         "copy_bytes": padded}
    del dst
    set_counts(saved)
    print(f"kernel feed_verify at so8: max_abs_err={err} " + " ".join(
        f"{k}={v}" for k, v in t.items()), flush=True)
    return t, err


def so8_runner():
    """The placement runner of so8: ``make_mesh([card] * 4, shape=(2, 2))``
    with its four slices spread over every visible card."""
    from tikv_tpu_torch.device import DeviceRunner
    from tikv_tpu_torch.parallel import make_mesh
    cards = torch.cuda.device_count()
    devs = [torch.device("cuda", i % cards) for i in range(4)]
    return DeviceRunner(mesh=make_mesh(devs, shape=MESH_SHAPE),
                        placement=True,
                        slice_probe_cooldown_s=SO8_COOLDOWN_S,
                        slice_latency_outlier_s=SO8_LATENCY_OUTLIER_S)


class So8:
    """Cell so8's tables, truths, requests and checks around one placement
    runner and its endpoint; ``single`` answers the whole-mesh region once
    per plan, the yardstick of its answers."""

    def __init__(self, single):
        from tikv_tpu_torch.convert import dag_from_wire
        from tikv_tpu_torch.copr.endpoint import Endpoint
        from tikv_tpu_torch.copr.wire import enc_dag
        from tikv_tpu_torch.testing import configs as cf
        t0 = time.perf_counter()
        self.n = [SO8_ROWS] * 8 + [SO8_BIG_ROWS]
        self.tables = [cf.serving_table(n, tid)
                       for n, tid in zip(self.n, SO8_TABLE_IDS)]
        self.truths = {n: {thr: cf.serving_truth(n, thr)
                           for thr in cf.SERVE_PALETTE + (None,)}
                       for n in (SO8_ROWS, SO8_BIG_ROWS)}
        self.schedule = [(SO8_RANK[ti], cf.SERVE_PALETTE[pi] if sel else None)
                         for ti, pi, sel in cf.serving_schedule(
                             SO8_CLIENTS * SO8_REQS, n_tables=9)]
        self.dags = {(ti, thr): dag_from_wire(enc_dag(cf.dag_serving(
            self.tables[ti][0], thr))) for ti in range(9)
            for thr in cf.SERVE_PALETTE + (None,)}
        big = self.tables[8][1]
        self.single = {thr: single.handle_request(self.dags[(8, thr)], big)
                       for thr in cf.SERVE_PALETTE + (None,)}
        self.runner = so8_runner()
        self.placer = self.runner.placer
        by_id = {t.table_id: snap for t, snap in self.tables}
        self.ep = Endpoint(lambda req: by_id[req.dag.executors[0].table_id],
                           self.runner, device_row_threshold=1)
        print(f"so8: tables, truths and the single runner's whole-mesh "
              f"answers in {time.perf_counter() - t0:.3f} s", flush=True)

    def snap(self, ti: int):
        return self.tables[ti][1]

    def agrees(self, ti: int, thr, result) -> bool:
        """The numpy truth, and for the whole-mesh region the single
        runner's answer too."""
        from tikv_tpu_torch.testing import configs as cf
        want = self.truths[self.n[ti]][thr]
        ok = sorted(result.rows()) == want if thr is None else \
            cf.columns_agree(result.batch, want)
        return ok and (ti != 8 or same_answer(result, self.single[thr]))

    def ask(self, ti: int, thr, phases: bool = False,
            backend: str = "device"):
        """One request through the endpoint, held to its answers and its
        backend → (ms, tracker phases)."""
        from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
        t0 = time.perf_counter()
        resp = self.ep.handle_async(CopRequest(
            REQ_TYPE_DAG, self.dags[(ti, thr)])).wait()
        ms = (time.perf_counter() - t0) * 1e3
        assert resp.backend == backend, (ti, thr, resp.backend)
        assert self.agrees(ti, thr, resp.result), f"so8 table {ti} thr {thr}"
        return ms, {k: v / 1e6 for k, v in resp.tracker.phases.items()} \
            if phases else None

    def both(self, ti: int) -> None:
        from tikv_tpu_torch.testing import configs as cf
        self.ask(ti, cf.SERVE_PALETTE[0])
        self.ask(ti, None)

    def slice_of(self, ti: int) -> int:
        owner = self.placer.owner(self.runner._feed_anchor(self.snap(ti)))
        return -1 if owner is None else self.placer.slices.index(owner)

    def feeds_on(self, ti: int) -> dict:
        return self.placer.slices[self.slice_of(ti)].resident_feeds(
            self.snap(ti))

    def traffic(self) -> dict:
        """SO8_CLIENTS threads of SO8_REQS requests of the schedule, started
        together; the answers are kept and checked after the run (a check
        inside it would hold the interpreter lock against the clients) →
        latencies by route."""
        import threading
        from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
        lat = {"slice": [], "whole_mesh": []}
        errors, answers, mu = [], [], threading.Lock()
        start = threading.Barrier(SO8_CLIENTS)

        def worker(ci):
            start.wait(timeout=60)
            for r in range(SO8_REQS):
                ti, thr = self.schedule[ci * SO8_REQS + r]
                t0 = time.perf_counter()
                try:
                    resp = self.ep.handle_async(CopRequest(
                        REQ_TYPE_DAG, self.dags[(ti, thr)])).wait()
                except Exception as e:      # noqa: BLE001 — fails below
                    with mu:
                        errors.append(repr(e))
                    continue
                ms = (time.perf_counter() - t0) * 1e3
                with mu:
                    lat["whole_mesh" if ti == 8 else "slice"].append(ms)
                    answers.append((ti, thr, resp))

        ts = [threading.Thread(target=worker, args=(ci,))
              for ci in range(SO8_CLIENTS)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        assert not any(t.is_alive() for t in ts), "an so8 client never ended"
        assert not errors, f"so8: {errors[:4]}"
        bad = [(ti, thr) for ti, thr, resp in answers
               if resp.backend != "device" or
               not self.agrees(ti, thr, resp.result)]
        assert not bad and len(answers) == len(self.schedule), \
            f"so8: {len(bad)} wrong answers, first {bad[:4]}"
        return {"requests": len(self.schedule), "wall_s": wall,
                "req_per_s": len(self.schedule) / wall,
                **{f"p50_ms_{k}": float(np.percentile(v, 50))
                   for k, v in lat.items()},
                **{f"p99_ms_{k}": float(np.percentile(v, 99))
                   for k, v in lat.items()},
                "requests_by_route": {k: len(v) for k, v in lat.items()}}


def run_so8(single) -> dict:
    """Cell so8 (``So8``) through ``Endpoint.handle_async(...).wait()`` over a
    placement runner: every table's plans cold once, then the schedule's
    256 requests from 16 threads twice (the first pass meets each slice's
    plans cold; warm p50 and p99 by route, a slice or the whole mesh, from
    the second); then, in order, (1) a forced ``rebalance()`` and one timed
    migration of table 0's feeds to the coolest other slice (``feed_verify``
    launched once a feed; copy, verify and install ms on the host clock;
    the kernel and the copy timed on the moved planes), (2)
    ``device::feed_migrate`` armed once: the migration of table 1's feeds
    ends "corrupt", the anchor is quarantined (its next request answered on
    the host, one ``quarantined`` degrade) and both feeds are minted again,
    (3) ``device::slice_dead`` on
    slice 1 until it trips: its anchors drain by migration, the whole-mesh
    region runs on the degraded submesh of slices 0 and 2, (4) the fault
    lifted, one canary re-admits slice 1 with a decayed score and the whole
    mesh is restored.  Every answer equals the numpy truth (the whole-mesh
    region's also the single runner's); no degrade outside the armed
    failpoints; the launches of the run are counted from zero."""
    from tikv_tpu_torch.device import digest as dg
    from tikv_tpu_torch.pd.scheduler import pick_slice
    from tikv_tpu_torch.utils import failpoint
    cell = So8(single)
    runner, placer, ep = cell.runner, cell.placer, cell.ep
    out = {"config": "so8", "rows": SO8_ROWS, "big_rows": SO8_BIG_ROWS}
    set_counts({k: 0 for k in KERNELS})
    try:
        t0 = time.perf_counter()
        cold = {ti: cell.ask(ti, None)[0] for ti in range(9)}
        for ti in range(9):
            cell.ask(ti, 990)
        out["cold_ms"] = {"slice_median": float(np.median(
            [cold[ti] for ti in range(8)])), "whole_mesh": cold[8]}
        out["warm_up_s"] = time.perf_counter() - t0
        assert {cell.slice_of(ti) for ti in range(8)} == {0, 1, 2, 3} \
            and cell.slice_of(8) == -1, [cell.slice_of(ti) for ti in range(9)]
        # the schedule twice: its first pass meets each slice's plans and
        # the pinned readback pool cold; the second is the warm pass
        out["first_pass"] = cell.traffic()
        out.update(cell.traffic())
        out["latency_strikes"] = sum(h["strikes"].get("latency", 0)
                                     for h in runner._board.stats())
        print("so8 traffic: " + " ".join(f"{k}={v}" for k, v in out.items()
                                         if k != "config"), flush=True)
        assert runner.route_stats()["degrades"] == {} and not ep.degrades

        # (1) a forced rebalance, then one timed migration
        out["rebalanced"] = placer.rebalance()
        src = cell.slice_of(0)
        dst = pick_slice(placer.scores(), {src})
        feeds = cell.feeds_on(0)
        v0, uploads = dg.verify_launches, \
            runner.route_stats()["feed_routes"]["upload"]
        assert placer.migrate(runner._feed_anchor(cell.snap(0)), src, dst)
        assert dg.verify_launches - v0 == len(feeds) == 2
        assert cell.slice_of(0) == dst
        st = placer.stats()
        out["migration"] = {"from": src, "to": dst, "feeds": len(feeds),
                            "ms": st["last_migration_ms"],
                            "phases_ms": st["last_migration_phases"]}
        cell.both(0)
        assert runner.route_stats()["feed_routes"]["upload"] == uploads, \
            "a migrated feed was uploaded again"
        moved = next(f for f in cell.feeds_on(0).values()
                     if len(f["flat"]) == 3)

        # (2) a bit flipped on arrival: "corrupt", quarantined (the next
        # request on the host), then minted again
        src1 = cell.slice_of(1)
        dst1 = pick_slice(placer.scores(), {src1})
        v0 = dg.verify_launches
        failpoint.cfg("device::feed_migrate", "1*return")
        try:
            assert not placer.migrate(runner._feed_anchor(cell.snap(1)),
                                      src1, dst1)
        finally:
            failpoint.teardown()
        assert dg.verify_launches - v0 == 1
        assert placer.stats()["migration_failures"] == 1
        assert not cell.placer.slices[dst1].resident_feeds(cell.snap(1))
        assert not cell.placer.slices[src1].resident_feeds(cell.snap(1))
        cell.ask(1, None, backend="host")
        assert ep.degrades == {"quarantined": 1}, ep.degrades
        cell.both(1)
        assert runner.route_stats()["feed_routes"]["upload"] == \
            uploads + 2, "the corrupt feeds were not minted again"
        out["corrupt"] = {"from": src1, "to": dst1,
                          "strikes": runner._board.slice(src1).stats()
                          ["strikes"]}

        # (3) slice 1 dies: strikes until it trips, the drain, the submesh
        victims = [ti for ti in range(8) if cell.slice_of(ti) == SO8_DEAD]
        st0 = placer.stats()
        v0 = dg.verify_launches
        failpoint.cfg("device::slice_dead", f"return({SO8_DEAD})")
        try:
            asked, t_trip = 0, time.perf_counter()
            while SO8_DEAD not in runner._board.quarantined_set():
                assert asked < 12, "slice 1 never tripped"
                cell.ask([*victims, 8][asked % (len(victims) + 1)], None)
                asked += 1
            trip_ms = (time.perf_counter() - t_trip) * 1e3
            st = placer.stats()
            dead = st["slices"][SO8_DEAD]
            assert dead["quarantined"] and dead["placed_anchors"] == 0 and \
                dead["resident_lines"] == 0, st
            drained = st["feeds_moved"] - st0["feeds_moved"]
            assert st["migrations"] > st0["migrations"] and drained > 0
            assert dg.verify_launches - v0 == drained, \
                "feed_verify did not launch once a drained feed"
            _ms, ph = cell.ask(8, None, phases=True)
            assert "mesh_rebuild" in ph, ph
            assert runner.device_health()["degraded"] == \
                {"dead_slices": [SO8_DEAD], "healthy_devices": 2}
            cell.ask(8, 985)
            for ti in victims:
                cell.both(ti)
                assert cell.slice_of(ti) not in (SO8_DEAD, -1)
            out["slice_dead"] = {
                "requests_to_trip": asked, "trip_ms": trip_ms,
                "anchors_drained": st["drained"] - st0["drained"],
                "feeds_moved": drained,
                "drain_migration_ms": st["migration_ms"] -
                st0["migration_ms"],
                "degrades": runner.route_stats()["degrades"]}
        finally:
            failpoint.teardown()

        # (4) the fault lifted: a canary re-admits slice 1
        time.sleep(2 * SO8_COOLDOWN_S)
        t = time.perf_counter()
        assert runner.probe_quarantined() == 1
        readmit_ms = (time.perf_counter() - t) * 1e3
        h = runner._board.slice(SO8_DEAD).stats()
        assert h["state"] == "healthy" and h["score"] == 2.0, h
        cell.ask(8, None)
        assert "degraded" not in runner.device_health()
        assert runner.failure_events == {"mesh_downsize": 1,
                                         "mesh_restore": 1}, \
            runner.failure_events
        for ti in range(8):
            cell.ask(ti, None)
        out["readmit"] = {"canary_ms": readmit_ms, "score": h["score"],
                          "readmits": h["readmits"]}
        out["launches"] = counts()
    finally:
        failpoint.teardown()
        ep.close()
    degrades = runner.route_stats()["degrades"]
    assert set(degrades) == {"slice_dead"} and \
        ep.degrades == {"quarantined": 1}, (degrades, ep.degrades)
    launches = out["launches"]
    st = placer.stats()
    assert launches["feed_verify"] == st["feeds_moved"] + 1
    for name in ("hash_agg", "sel_pred", "feed_verify"):
        assert launches[name] > 0, f"so8 never launched {name}"
    out["placer"] = {k: v for k, v in st.items() if k != "slices"}
    out["timing"], out["max_abs_err"] = feed_verify_at_main_shape(moved)
    print("cell so8: " + " ".join(f"{k}={v}" for k, v in out.items()
                                  if k not in ("config", "timing")),
          flush=True)
    runner.close()
    del cell, moved
    gc.collect()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tikv_tpu_torch.device import DeviceRunner

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    # the selection source compiles for minutes: the other kernels' checks
    # run meanwhile, and none of them loads it
    build_kernels(defer=("selection",))

    dev = torch.device("cuda", 0)
    worst = {"hash_agg": check_kernels(dev, 1 << 24),
             "twolevel": max(check_fused(dev), check_twolevel(dev))}
    worst["topn_select"] = check_topn(dev)
    worst["agg_fold"] = check_agg_fold(dev)
    worst["plane_digest"], worst["patch_rows"], worst["patch_spans"] = \
        check_digest(dev)
    worst["feed_verify"] = check_feed_verify(dev)
    worst["mvcc_resolve"] = check_mvcc(dev)
    worst["sort_perm"] = worst["join_build"] = check_sort(dev)
    worst["join_probe"] = worst["join_index"] = check_join(dev)
    worst["window_scan"] = check_window(dev)
    worst["split_planes"] = check_split(dev)
    # ANALYZE loads no selection kernel: its checks, cells (but an6c, which
    # needs the cold path's snapshot), CHECKSUM and timings run while the
    # selection source compiles
    runner = DeviceRunner()
    worst["analyze"] = check_analyze(dev)
    analyze_runs = [run_analyze(c, runner) for c in ANALYZE_ROWS]
    run_checksum()
    analyze_timing, err = analyze_at_main_shapes(runner, dev)
    worst["analyze"] = max(worst["analyze"], err)
    # the mesh: its merges, and the cells that launch no selection kernel
    worst["shard_merge"] = check_shard_merge(dev)
    from tikv_tpu_torch.parallel import make_mesh
    mesh_runner = DeviceRunner(mesh=make_mesh(
        [dev] * (MESH_SHAPE[0] * MESH_SHAPE[1]), shape=MESH_SHAPE))
    mesh_timings: dict = {}
    mesh_runs = run_mesh(mesh_runner, runner, MESH_EARLY, mesh_timings)
    # the aggregation configs launch no selection kernel either
    config_runs = [run_config(c, SIZES[c], runner) for c in SIZES]
    # nor does the cold path (its plans aggregate; the spill mint patches)
    worst["patch_rows"] = max(worst["patch_rows"], check_spill(runner, dev))
    print(f"elapsed: {time.perf_counter() - t0:.1f} s before the cold path",
          flush=True)
    cold = {c: run_cold(c, COLD_SIZES[c], runner) for c in COLD_SIZES}
    snap6c = cold["6c"].pop("snapshot")
    print(f"elapsed: {time.perf_counter() - t0:.1f} s at the selection "
          f"build's wait", flush=True)
    await_builds()
    print(f"elapsed: {time.perf_counter() - t0:.1f} s after it", flush=True)
    worst["sel_pred"] = check_pred(dev)
    worst["sel_pred_batched"] = check_batched(dev)
    worst["sel_mask"], worst["sel_compact"] = check_selection(dev)

    def elapsed(what: str) -> None:
        print(f"elapsed: {time.perf_counter() - t0:.1f} s {what}",
              flush=True)

    elapsed("before the DAG configs")
    runs = analyze_runs + config_runs
    runs += [run_row_config(c, ROW_SIZES[c], runner) for c in ROW_SIZES]
    runs += run_sweep(runner)
    runs.append(run_uncovered(runner))
    elapsed("before the time types")
    time_runs, time_worst = run_time_types(runner, dev)
    runs += time_runs
    for name, err in time_worst.items():
        worst[name] = max(worst[name], err)
    elapsed("before the JSON cell")
    runs.append(run_tj(runner))
    runs += cold.values()
    elapsed("before the plan IR")
    ep, pair = plan_endpoint(runner)
    runs += [run_plan(c, ep, pair) for c in PLAN_ROUTE]
    runs.append(run_analyze("an6c", runner, snap6c._tbl.table, snap6c))
    del snap6c
    elapsed("before the serving path")
    check_budget(dev)
    runs.append(run_deferred(runner))
    runs += run_6b_ep(runner)
    elapsed("before the split")
    split = run_split(runner)
    source = split.pop("source")
    runs.append(split)
    elapsed("before the delta cell")
    # a runner of its own: the scrub covers every anchor of its runner
    delta = run_delta(DeviceRunner(), source)
    del source
    delta_shape = (delta.pop("n_pad"), delta.pop("shapes"))
    runs.append(delta)
    elapsed("before the ingest cell")
    # a runner of its own: the cell's scrub covers its runner's anchors
    runs.append(run_ingest(DeviceRunner()))
    elapsed("before the store in process")
    # a runner of its own: the node closes it at its stop
    srv = run_srv(DeviceRunner())
    runs.append(srv)
    elapsed("before the three replicas")
    # runners of their own, closed at the cell's end
    runs.append(run_rs3())
    elapsed("before the networked store")
    # the CLI's processes start while net runs
    cli = start_cli()
    try:
        # three servers, each node with a runner of its own on the card
        runs.append(run_net(srv))
    except BaseException:
        for p in cli["procs"]:
            p.kill()
        raise
    elapsed("before the CLI")
    # processes of their own: the store's launches are not this process's
    runs.append(run_cli(cli))
    elapsed("before the mesh")
    from tikv_tpu_torch.testing import configs as cf
    mesh_runs += run_mesh(mesh_runner, runner, [
        c for c in cf.MESH_CELLS if c not in MESH_EARLY], mesh_timings)
    mesh_runs += run_mesh_rest(mesh_runner, runner)
    del mesh_runner
    gc.collect()
    runs += mesh_runs
    elapsed("before the scale-out mesh")
    so8 = run_so8(runner)
    runs.append(so8)
    worst["feed_verify"] = max(worst["feed_verify"], so8["max_abs_err"])
    elapsed("before the kernel timings")
    launches = {k: sum(r["launches"][k] for r in runs) for k in KERNELS}
    print("host phases of one warm request (ms, host clock, median of 5): "
          + "; ".join(f"config {r['config']}: " + " ".join(
              f"{k}={v}" for k, v in r["host_phases_ms"].items())
                      for r in runs if "host_phases_ms" in r), flush=True)
    err, hash_timings = kernel_at_main_shapes(dev)
    worst["hash_agg"] = max(worst["hash_agg"], err)
    hash_timing = {k: v for k, v in hash_timings["4"].items()
                   if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")}
    hash_timing["configs"] = hash_timings
    err, two_timing = twolevel_at_main_shapes(runner, dev)
    worst["twolevel"] = max(worst["twolevel"], err)
    floor_ms = launch_floor(dev)
    floors = param_floors(dev)
    pred_timing, mask_timing, compact_timing = selection_at_main_shapes(
        dev, floor_ms)
    batched_timing = batched_at_main_shape(dev)
    topn_timing, pred_timing_5t = topn_at_main_shapes(runner, dev)
    pred_timing = dict(pred_timing, configs={"2": dict(pred_timing),
                                             "5t": pred_timing_5t})
    err, fold_timing = fold_at_main_shapes(runner, dev)
    worst["agg_fold"] = max(worst["agg_fold"], err)
    split_timing = split_at_main_shape(runner, dev)
    worst["split_planes"] = max(worst["split_planes"],
                                split_timing.pop("max_abs_err"))
    span_timing, err = spans_at_main_shapes(dev, *delta_shape)
    worst["patch_spans"] = max(worst["patch_spans"], err)

    kernels = [
        {"name": "hash_agg", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/hash_agg.cu",
         "replaces": "tikv_tpu/device/pallas_hash.py:199",
         "launches": launches["hash_agg"], "max_abs_err": worst["hash_agg"],
         **hash_timing},
        {"name": "twolevel", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/twolevel.cu",
         "replaces": "prof/prof_pl.py:44, prof/prof_pl2.py:43, "
                     "prof/prof_pallas.py:92 and :147",
         "launches": launches["twolevel"], "max_abs_err": worst["twolevel"],
         **two_timing},
        {"name": "sel_pred", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/selection.cu",
         "replaces": "tikv_tpu/device/selection.py:227",
         "launches": launches["sel_pred"], "max_abs_err": worst["sel_pred"],
         **pred_timing},
        {"name": "sel_pred_batched", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/sel_batched.cu",
         "interpreter_source": "tikv_tpu_torch/csrc/selection.cu",
         "replaces": "tikv_tpu/device/selection.py:273",
         "launches": launches["sel_pred_batched"],
         "max_abs_err": worst["sel_pred_batched"], **batched_timing},
        {"name": "sel_mask", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/sel_mask.cu",
         "replaces": "tikv_tpu/device/selection.py:227",
         "launches": launches["sel_mask"], "max_abs_err": worst["sel_mask"],
         **mask_timing},
        {"name": "sel_compact", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/selection.cu",
         "replaces": "tikv_tpu/device/selection.py:323 and :357",
         "launches": launches["sel_compact"],
         "max_abs_err": worst["sel_compact"], **compact_timing},
        {"name": "topn_select", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/topn.cu",
         "replaces": "tikv_tpu/device/runner.py:2825",
         "launches": launches["topn_select"],
         "max_abs_err": worst["topn_select"], **topn_timing},
        {"name": "agg_fold", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/agg_fold.cu",
         "replaces": "tikv_tpu/device/runner.py:2701 and :2668",
         "launches": launches["agg_fold"], "max_abs_err": worst["agg_fold"],
         **fold_timing}]
    for name, source, replaces in (
            ("mvcc_resolve", "mvcc.cu", "tikv_tpu/device/mvcc.py:531"),
            ("plane_digest", "digest.cu", "tikv_tpu/device/runner.py:1981"),
            ("patch_rows", "digest.cu",
             "tikv_tpu/device/runner.py:1816 and :2023, "
             "tikv_tpu/device/mvcc.py:514")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tikv_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst[name],
            **cold["4h"]["timing"][name],
            "configs": {c: r["timing"][name] for c, r in cold.items()}})
        if name == "patch_rows":
            kernels[-1].update(launch_floor_ms=floor_ms,
                               floor_params_ms=floors)
    errs, plan_timing = plan_kernels_at_main_shapes(pair, dev)
    del ep, pair
    for name, source, replaces in (
            ("join_build", "sort.cu", "tikv_tpu/device/join.py:257"),
            ("join_index", "join.cu",
             "tikv_tpu/device/join.py:276 (the searchsorted of "
             "_probe_kernel, once per build)"),
            ("join_probe", "join.cu", "tikv_tpu/device/join.py:276"),
            ("sort_perm", "sort.cu", "tikv_tpu/device/join.py:479"),
            ("window_scan", "window.cu", "tikv_tpu/device/join.py:508")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tikv_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(worst[name], errs[name]),
            **plan_timing[name]})
    kernels.append({
        "name": "analyze", "route": "cuda",
        "source": "tikv_tpu_torch/csrc/analyze.cu",
        "replaces": "tikv_tpu/device/runner.py:4478",
        "launches": launches["analyze"], "max_abs_err": worst["analyze"],
        **{k: v for k, v in analyze_timing["an4 id"].items()
           if k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_call", "rows", "dtype",
                    "column_route", "design_bytes", "design_bound_ms")},
        "configs": analyze_timing})
    kernels.append({
        "name": "split_planes", "route": "cuda",
        "source": "tikv_tpu_torch/csrc/split.cu",
        "replaces": "tikv_tpu/device/runner.py:2168",
        "launches": launches["split_planes"],
        "max_abs_err": worst["split_planes"], **split_timing})
    for name, cell, replaces in (
            ("shard_psum", "m4",
             "tikv_tpu/device/runner.py:3930 (_pallas_sharded_wrap's psum) "
             "and :2599 (_finalize_psum_summed)"),
            ("shard_bucket_merge", "m4x",
             "tikv_tpu/device/runner.py:2606 "
             "(_finalize_hash_bucket_merge; at m4x the same launch as "
             "_finalize_psum_summed's psum, :2599)")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tikv_tpu_torch/csrc/shard_merge.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst["shard_merge"],
            **mesh_timings[cell]["merge"], "launch_floor_ms": floor_ms,
            "floor_params_ms": floors,
            "configs": {c: t for c, t in mesh_timings.items()
                        if (c == "m4x") == (name == "shard_bucket_merge")}})
    kernels.append({
        "name": "patch_spans", "route": "cuda",
        "source": "tikv_tpu_torch/csrc/digest.cu",
        "replaces": "tikv_tpu/device/runner.py:1816 (_dus over each "
                    "journal span) and :1793-1814 (_patch_plane's range "
                    "digests and R')",
        "launches": launches["patch_spans"],
        "max_abs_err": worst["patch_spans"],
        **{k: span_timing["w3"][k] for k in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "rows_form_ms", "rows", "spans")},
        "configs": span_timing})
    kernels.append({
        "name": "feed_verify", "route": "cuda",
        "source": "tikv_tpu_torch/csrc/digest.cu",
        "replaces": "tikv_tpu/device/runner.py:2108 (install_feeds)",
        "launches": launches["feed_verify"],
        "max_abs_err": worst["feed_verify"], **so8["timing"]})
    assert all(k["route"] == "cuda" for k in kernels), "a timing key clash"
    elapsed("in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
