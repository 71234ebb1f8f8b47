#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (distributed_faiss_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--nq 10000]
                          [--nprobe-from 1] [--profile]

Phases, in order; any failure raises and the script exits nonzero:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, the host compiler's version, and the build of every
   kernel source under ``distributed_faiss_tpu_torch/csrc`` (one nvcc per
   source, started together) with nvcc's register/spill report, beside
   the g++ build of the hnswsq graph (``native/hnsw.cpp``) into
   ``build/torch_native/``.
2. Kernel phase, every kernel against its plain PyTorch version on the
   card, both timed with CUDA events after warm-up (``time_ms``: back-to-
   back calls that take copies of the inputs in turn, so many that no call
   finds its inputs in L2, with the card kept busy while the host issues
   the timed calls):
   - the flat list scan (K1, ``csrc/flat_scan.cu``), every variant
     (f32/f16/sq8 lists x l2 with stored norms, l2 with recomputed norms,
     dot; plus scan_bf16), at d=128 and d=768, nq=256, g=1..4, cap=2048:
     identical -inf masks, finite scores within rtol/atol 1e-4
     (5e-2/5e-1 for scan_bf16);
   - the ADC scans (``csrc/adc_scan.cu``): K2 at m=4 and 12, K3 at m=8 and
     64, each with an f32 and a bf16 LUT, P=256 pairs, L=1, 1000 and 2048
     code rows, then K2 at m=190 and K3 at m=256 with an f32 LUT (wider
     than a block's shared memory: several subspace slices, the count
     logged): scores within rtol/atol 1e-4 (both sides sum the same LUT
     values in fp32, bf16 tables included); K3 over the probed lists
     themselves (``adc_scan_lists``: it reads li, stops at each list's
     size and masks -1 ids) at m=8 and 64, f32 and bf16 LUT, 64 lists of
     capacity 1000 and 2048 with sizes from 0 to the capacity, 128
     queries x 2 probes, then at m=256 with an f32 LUT (slices):
     identical -inf masks, scores within rtol/atol 1e-4; the shared-list
     scan K4 at
     m=16 and 64, f32 and bf16 LUT, nq=4 and 256 queries, L=13, 5000 and
     65536 rows, and at m=128 f32, nq=256, L=65536 (slices): bit-exact
     (both sides add the same fp32 values in subspace order).
3. ``ivfsq`` path (K1): one port ``IndexServer(device="cuda")`` on a
   loopback port and an ``IndexClient`` over a discovery file.
   create_index with the README Quickstart cfg on the ``ivfsq`` builder,
   add ``--n`` clustered rows (the generator of bench.py, 1024 centers)
   with metadata in batches, wait for the threshold training and the add
   drain, sweep nprobe by doubling from ``--nprobe-from`` until recall@10
   >= 0.95 against the port's exact FlatIndex on the card, serve ``--nq``
   queries at top-10 from concurrent clients (QPS and p50/p99 request
   latency), and save -> drop -> load and check the same ids come back.
   This server stays up for phases b and c.
4. ``knnlm`` path (K3): a second server and client. The ``knnlm`` builder
   at BASELINE.json config 3's widths (d=768, 4096 centroids, PQ m=64,
   8-bit) with a bf16 LUT and an exact refine of 8x the shortlist, over
   ``KNNLM_N`` (500,000) rows of the low-intrinsic-dimension corpus of
   benchmarks/baseline_configs.py (queries from the same generator): add,
   wait, sweep nprobe by doubling from ``--nprobe-from`` until recall@10
   >= 0.95 (failing at nprobe 4096), serve ``--nq`` queries, save -> drop
   -> load with identical ids and distances.
5. K2 path: an ``IVF1024,PQ12,RFlat`` index (m=12, so K2's geometry) on
   the same server over the first ``K2_N`` (100,000) rows of that corpus; a few
   requests are served and checked, and its recall is logged.
6. Flat-PQ path (K4): a ``PQ64,RFlat`` index (one list, config 3's PQ
   widths, the factory's 8x exact refine, train_num 100,000) on the same
   server over phase 4's rows, queries and ground truth: recall@10 >= 0.95
   on the 1000 eval queries, ``--nq`` queries served, save -> drop -> load
   identical.
7. Pre-transform path: an ``OPQ64,PQ64,RFlat`` index over phase 5's rows
   (train_num 50,000): a few requests checked, recall@10 logged, save ->
   drop -> load identical (the ``pretransform`` snapshot kind).
8. Wide flat PQ: a ``PQ128,RFlat`` index over phase 5's rows (an f32
   LUT wider than a block's shared memory, so K4 runs in subspace slices):
   a few requests checked, recall@10 logged, the slice count logged.
9. Each kernel at its path's own shapes (the loaded index's lists and one
   query block's first probe group, or for K4 its LUT and first chunk of
   the list, built by the model's own helpers): kernel vs plain time, its
   bound, its max error, and the kernels JSON line. On the knnlm path K3
   runs twice: over the probed lists, with the group step it replaced
   timed beside it (the gather of the probed lists' codes, K3 over the
   gathered copy, the mask), and over the gathered codes (that entry's
   row reports its own launches, none on the knnlm path); the kernel's
   time on
   one set of inputs, which back-to-back calls may find in L2, is logged
   beside it, labelled. For K2, K3 over gathered codes and K4 one PyTorch
   call that computes the same sums (``embedding_bag``; for K2 and K3 over
   one flattened table of every pair's LUT, per-pair offsets in its index,
   the index and table built and timed apart) is timed as a yardstick
   (``library_ms``); the port never calls it.

After phase 8, the rest of one rank's serving surface:

a. Surface: an ``ivfsq`` index over the first ``SURFACE_N`` (100,000) rows
   of phase 3's corpus, metadata ``(row, row % 4)``, on phase 3's server:
   ``search_with_filter(filter_pos=1, filter_value=0)`` of 1000 queries
   equals the unfiltered top-30 filtered on the host (or, for a row the
   first fetch leaves short, the client's requery), keeps no tag 0;
   ``get_ids`` is every row id; ``get_centroids``, ``index_loaded`` and
   ``add_buffer_to_index`` answer.
b. Wire A/B: ``--nq`` queries on phase 3's index through the negotiated
   client (binary skeletons) and through a client built under
   DFT_RPC_WIRE=pickle, in ``WIRE_PAIRS`` (10) pairs of runs whose first
   side alternates: QPS and p50/p99 of each run, their medians and the
   pairs binary won, the server offering ``binary``, the negotiated
   stub's ``peer_wire`` true and the other's false, and phase 3's ids in
   every run.
c. Direct path: a third server with ``SchedulerCfg(enabled=False)`` loads
   phase 3's snapshot and serves ``--nq`` queries through
   ``engine.Index.search`` and its natural batcher: phase 3's ids, and
   the engine's rows per launch logged.
d. ``hnswsq``: the builder at its defaults (graph degree 128,
   efConstruction 100, exact rerank of 8x the shortlist on the card) over
   the first ``HNSW_N`` (200,000) rows of phase 3's corpus: build time,
   efSearch doubled from 16 until recall@10 >= 0.95 against the exact
   FlatIndex (failing at 4096), ``--nq`` queries served, save -> drop ->
   load identical, and the graph library built from ``native/hnsw.cpp``
   into ``build/``.

Every model search on the card, in every phase, runs as captured
programs (``utils/programs.py``: one CUDA graph a query block or a
multi-block window, replayed; the mesh's routed mode one a routed block),
except inside ``programs.eager()`` and under GRAFT_SANITIZE=1 (phase
i.3). After phase 9,
on the servers of phases 3 and 4:

j. Programs against op by op (``GRAPH_NPROBES``): the ``ivfsq`` (K1) and
   ``knnlm`` (K3 over the lists) indexes at nprobe 1 and 32 and the
   ``PQ64,RFlat`` index (K4) at its default, each served twice, with its
   captured programs and inside ``programs.eager()``: after a warm
   1000-query run, ``--nq`` queries as 100-row requests from 8 threads
   (QPS, p50/p99, the scheduler's windows, replays a window, K1 / K3 / K4
   launched and counted by the replays, the model's captures, capture
   seconds, programs held and graph pool bytes; no capture inside the
   timed window, no replay in the eager run), then the same queries at
   top-11: the same top-10 ids on every tie-free query of the two modes.
   Then one direct ``engine.search`` of ``DIRECT_ROWS`` (4096) queries on
   each index: after a warm call, one replay (the window program of its
   nblocks bucket) and no capture, and the per-block path's ids on the
   tie-free queries. With ``--profile``, the nprobe=32 cells and flat PQ
   are profiled with graphs on (the device's busy share).

After phase j, the servers of phases 3 and 4 still up:

e. Mutation: on phase 3's index, ``save_index`` and ``pin_generations``;
   ``remove_ids`` of every 10th id (100,000), timed; no deleted id in the
   top-10 of the 1000 eval queries, ``get_ids`` counts 900,000, recall@10
   >= 0.95 against the exact top-10 over the survivors (the port's
   FlatIndex on the card twice, over every row with the deleted ones
   removed through ``remove_rows`` and over the survivors alone, which
   must agree); ``--nq`` queries served from 8 clients right before the
   deletes and after them (no deleted id), QPS and p50/p99 of both beside
   phase 3's; ``upsert`` of 1000 deleted ids with
   each eval query's own vector, polled through ``read_your_writes=True``
   searches until each is its query's top-1 (a refusal other than the
   drain's fails); ``search_at_generation(pins)`` serves phase 3's ids;
   ``compact_index`` keeps every query's ids and distances; save -> drop
   -> load serves no deleted id and every upserted row. On phase 4's
   knnlm index and phase 6's PQ64,RFlat index: ``remove_ids`` of every
   10th id (50,000), no deleted id served, recall@10 over the survivors
   (>= 0.95 on knnlm, logged on PQ64,RFlat), and the knnlm index
   compacted with the same ids. Every index's metadata is ``(row,)``: the
   id sits at ``custom_meta_id_idx`` 0.
g. Observability, the serial client, the selector loop and link faults,
   on the same two servers:
   1. Traced serving on the ``ivfsq`` (K1) and ``knnlm`` (K3 over the
      lists) indexes, at nprobe 1 and 32: ``TRACE_PAIRS`` (4) pairs of
      ``TRACE_QUERIES``-query runs (2000, 100-row requests from 8 threads)
      with DFT_TRACE_SAMPLE at 0 and 1 in this process, the first side
      alternating: identical ids, each side's median QPS (the tracing
      cost, a reading). Then one more traced run under torch.profiler:
      every request's merged timeline holds the seven spans
      (``SPAN_NAMES``), queue + device + write <= client.rpc <=
      client.search within ``CLOCK_SLACK_S``, the median split (queue,
      device, launch, write, the rest of the wire) is logged, and the
      run's distinct windows' server.device time must be at least the scan
      kernel's device time in the profile. The server's e2e_s p99
      exemplar (``get_perf_stats(raw=True)``; the slowest bucket's
      exemplar when the p99 of the server's whole life has none) is
      fetched with ``get_trace_spans`` and checked the same way.
   2. Phase 3's server, built with a metrics listener on a free port:
      ``GET /metrics`` answers 200 with ``_bucket{le="`` series and the
      engine's device_search_s count of ``get_perf_stats``; dfstat's stats
      view and its ``--trace`` view of the exemplar exit 0.
   3. A second server runs the selector loop (``IndexServer.start`` in a
      thread) over phase 3's storage; ``--nq`` queries from 8 threads in
      four arms, {threaded, selector} x {mux, serial} (DFT_RPC_MUX at each
      client's construction): identical ids, QPS and p50/p99 of each, K1
      launched and the calls counted by dialect on each server.
   4. A ``ChaosProxy`` in front of phase 3's server: latency 0.05 s (an
      ``IndexClient`` over a discovery file naming the proxy: the same ids,
      each search >= 0.05 s); a reset on the redial healed by the
      ``RetryPolicy``; garble, cut and garble-down: the first call fails
      with a transport error (or answers) and the next connection serves
      the same ids; a blackhole under a 1 s deadline fails within the
      deadline + ``DEADLINE_GRACE`` + 0.25 s.

After phase g, its servers closed:

f. Replicas: the first ``REPLICA_N`` (250,000) rows of phase 3's corpus
   (a depth cut) and its cfg on ``REPLICA_RANKS`` (4) rank
   processes on the card (the port's ``ServerHarness``, ``--device cuda
   --discovery``, DFT_ANTIENTROPY_INTERVAL=1), two groups of R = 2 under an
   ``IndexClient`` with ``ReplicationCfg(replication=2, write_quorum=1)``:
   ingest in 10,000-row batches (125,000 rows a group, on both replicas),
   save, recall@10 >= 0.95 on the eval queries, each replica's own top-10
   compared with its twin's, ``--nq`` queries served (QPS, p50/p99), K1
   launched on every rank (``ping()["kernels"]``). SIGKILL of one replica
   of group 0 under an 8-thread ``QueryStorm``: no request fails; ``--nq``
   queries served during the outage; 1000 rows, 1000 deletes (ids the
   healthy cluster served) and 20 upserts into group 0 at quorum 1; the
   victim restarted with its storage (``--load-index``,
   DFT_SHARD_GROUP=0) heals by delta under a storm pinned on it (its drain
   refusals fail over), digests polled equal within
   ``CONVERGE_LIMIT_S``. SIGKILL of one replica of group 1, 20,000 rows
   into the group, the victim restarted empty heals by a full shard
   transfer (rows, MB of arrays, seconds, the donor's peak RSS). Pinned on
   both healed ranks: no deleted id, every upserted row top-1, recall@10
   >= 0.95 over the survivors, the full-transfer rank serving its donor's
   ids (the delta-healed one its twin's where the healthy twins agreed),
   K1 launches rising; ``--nq`` queries served healed; who holds each
   group's compaction lease (``get_health``).
   f.3, SIGKILL mid-compaction, on the same four ranks before they close:
   ``save_index``, then ``remove_ids`` of ``F3_DELETE_SHARE`` (30%) of group
   0's live ids (drawn from ``--seed``); one replica of group 0 SIGKILLed
   and restarted with its storage under DFT_COMPACT_TEST_DELAY_S =
   ``F3_DELAY_S`` (4), DFT_COMPACT=0 and DFT_SHARD_GROUP=0, its tombstones
   restored. Under a storm of ``F3_STORM_THREADS`` (8) ``QueryStorm``
   threads, each with a 50-row query block of its own at top-11 and group
   0's reads pinned on the victim, ``compact_index`` is sent to it and the
   rank SIGKILLed half the delay later, inside the rebuild: no storm
   request fails, none serves a deleted id, and each result is its own
   block's pre-kill answer from one of the two replicas (the same top-10
   ids and distances within 1e-3 on the answer's tie-free rows), so no
   result crossed callers; the victim's newest generation is still the
   pre-compaction one. Restarted with its storage: ``compactions`` 0 and
   the pre-kill ``live_fraction``, its own pre-kill top-10 ids on the
   tie-free eval queries, its twin's ids on at least the share of queries
   they agreed on before the kill, no deleted id, K1 launches rising
   (``ping``). ``compact_index`` on both replicas then leaves no tombstone
   (a replica whose watcher compacted first answers False) and each
   serves its pre-compaction top-10 ids on the tie-free queries. The
   seconds of each step are logged.

After phase f:

l. The snapshot kill-9 sweep on the card: ``SAVER_TRIALS`` (5) children
   of this script (``--saver-child``), started together, each load phase
   3's kept ``ivfsq`` snapshot from a fresh link of it (``keep_for_witness``)
   on the card and loop: add ``SAVER_BATCH`` (10,000) new rows of phase
   3's generator (its own seed a trial), wait for the drain, save, print
   the generation committed. The parent SIGKILLs each one at a share,
   drawn from ``--seed``, of its first loop's seconds after its first new
   generation committed. Then, for each trial, the port's
   ``Index.from_storage_dir(..., device="cuda")`` must load the dir, at a
   generation at least the last one the child reported, with ``ntotal``
   equal to the metadata count, an empty buffer and whole batches of new
   rows; the files it quarantined are logged; the 1000 eval queries at
   phase 3's nprobe serve only ids of that generation's rows, at
   recall@10 >= 0.95 against the exact FlatIndex over those rows (phase
   3's and the child's, regenerated), and K1 launches.

After phase l:

k. The 65,536-list tier: the repo's own ingest configuration
   (``scripts/idx_cfg.json``: ``IVF{centroids},SQ8`` at 65,536 centroids,
   d = 768, train_num 1,000,000, nprobe 32, buffer_bsz 50,000), read and
   never written:
   1. ``TIER_N`` (1,000,000) rows of the low-rank corpus (r 64, 8192
      latent clusters) written as an fp16 memmap under ``build/``, and
      ``--nq`` queries from the same generator. The port's
      ``scripts/load_data.py`` ``main`` in this process (``--cfg`` that
      file, ``--dtype fp16 --dim 768 --bs 50000 --device cuda``) into a
      port server on a loopback port: 50,000-row adds, the threshold
      training on every row, the add drain, the smoke search and the
      save; ingest, train and add seconds from the engine's state
      changes; the model must be IVF-Flat over sq8 lists at 65,536 lists;
      its largest list, cap and padded bytes logged. The nprobe sweep
      from ``--nprobe-from`` to recall@10 >= 0.95 against the exact
      FlatIndex over the rows as served; ``--nq`` queries through the
      captured programs as in phase j (exactly 1.000 replays a window, no
      capture in the timed window); the programs logged; save -> drop ->
      load with the same ids. K1 must have launched on the path, K2, K3
      and K4 not. K1 at the loaded model's shape against its plain
      version (``k1_main_shape``: the timed calls rotate over the probe
      groups of successive query blocks, the lists being too large to
      copy), with its bound and the ptxas report of its sq8 d = 768
      instantiation.
   2. ``sharded_kmeans`` at 65,536 centroids (the random-seed branch, one
      Lloyd step) over the phase's rows on ``MESH_SHARDS`` virtual shards:
      finite, inside the rows' bounding box, not collapsed. A routed
      ``ShardedIVFFlatIndex`` (fp32 lists) on those centroids over the
      first ``TIER_MESH_N`` (200,000) rows (a depth cut) serves the
      unsharded IVF-Flat index's top-10 ids at the cfg's nprobe (32) on
      the tie-free queries, K1 launched on every shard.

After phase k:

h. The mesh (``parallel/mesh.py``), ``MESH_SHARDS`` (4) virtual shards on
   the one card (``mesh_devices=4, mesh_virtual=True`` in each cfg;
   DFT_MESH_DEVICES=4 and DFT_MESH_VIRTUAL=1 for the restores), through a
   port IndexServer and IndexClient:
   1. ``ivf_tpu`` over phase 3's corpus (1M x 128, fp32 lists, 1024 lists,
      train_num 100,000; coarse k-means sharded): the nprobe sweep from
      ``--nprobe-from`` to recall@10 >= 0.95, ``--nq`` queries served, K1
      launched.
   2. The same lists and centroids as kind ``sharded_ivf_flat`` (h.1's
      snapshot committed with ``import_snapshot`` and loaded, masked):
      recall@10 >= 0.95, the same top-10 ids as h.1 at its nprobe on the
      tie-free queries (top-11 distances all apart), ``--nq`` queries
      served, K1 launched on every shard (``shard_launches``).
   3. ``knnlm`` with ``shard_lists`` over phase 4's rows (PQ m=64, 4096
      lists, bf16 LUT, refine 8x): the sweep to recall@10 >= 0.95, ``--nq``
      queries served, K3 over the lists launched on every shard, neither
      K2 nor K4.
   4. Masked and routed mode for the indexes of h.2 and h.3 at nprobe
      32, masked served first; routed served twice (``routed_mode``), with
      its captured programs (one a block bucket and pair bucket,
      ``_sharded_ivf_*_search_routed``) and inside ``programs.eager()``:
      QPS and p50/p99 of each, the routed blocks, relaunches and replays
      (exactly one replay a block), no capture in a timed window, the
      masked mode's top-10 ids on the tie-free queries (and the same ids
      in both routed modes), every shard launched; then 2000 queries under
      DFT_XFERCHECK (no implicit sync, one upload and one fetch a block);
      each routed capture a registered ``utils/jitreg.py`` row within its
      budget; the model's programs and graph pool logged. The skew arm
      (after h.2's index is dropped): ``SKEW_ROWS`` (4096) rows in one list
      of a 64-list index on the 4 shards, the lists every query probes
      (nprobe 8) all shard 0's: the first 256-row search relaunches at
      grown pair buckets and answers as the exact scan on the tie-free
      queries; seven more such searches capture nothing and relaunch no
      more.
   5. ``flat`` with ``mesh_shards`` over phase 3's first 200,000 rows: the
      same top-10 ids as the single-device exact FlatIndex on the tie-free
      queries, ``--nq`` queries served.
   6. On h.3's index: ``remove_ids`` of every 10th id, no deleted id
      served, save -> drop -> load serving the same ids.
   7. K1 (on h.2's index) and K3 over the lists (on h.3's) on each shard's
      own inputs (one query block's first probe group remapped to the
      shard's local slots and owned sizes) against their plain versions
      (rtol/atol 1e-4), timed, with their bounds.

After phase h:

i. The runtime witnesses (``utils/{lockdep,racecheck,threadcheck,xfercheck,
   sanitize,compilecheck}.py``) on the card, in two child processes of this
   script (``--witness-child``), so their instrumentation stays out of the
   timings above. Both load phase 3's and phase 4's storage dirs, linked
   right after each path's save (``keep_for_witness``, under
   ``build/chip_smoke_witness``), with the queries and the ids those
   phases served: nothing is rebuilt, and each index serves at its
   recall-clearing nprobe through an ``IndexServer(device="cuda")``, the
   scheduler and an ``IndexClient`` from 8 client threads.
   The first child starts with DFT_LOCKDEP, DFT_RACECHECK, DFT_THREADCHECK,
   DFT_XFERCHECK and DFT_COMPILECHECK set:
   1. Doctored faults, each caught as its own error type: ``.item()`` on a
      card tensor inside ``xfercheck.guarded("doctored")`` on a worker
      raises ImplicitTransferError naming the label and a line of this
      file, while the same call inside ``explicit()`` and on an unguarded
      thread at the same moment passes; under GRAFT_SANITIZE=1 an li of
      nlist and a size of cap + 1 to K1 and to K3 over the lists, and codes
      past ksub or of another width to K2 and K4, raise SanitizeError with
      no launch, after which a correct K1 launch matches its plain version
      (the CUDA context survived); a NaN query through the client fails its
      own request on each index and the next request serves the kept ids;
      an ABBA order on two ``lockdep.lock``s raises LockOrderError.
   2. After a warm-up, compilecheck's snapshot; ``--nq`` queries on each
      index: the parent's ids, no race, no implicit sync inside the
      guarded sections, an acyclic lock-order graph, K1 (``ivfsq``) and K3
      over the lists (``knnlm``) launched, and each ``explicit()`` site
      that fired, with its syncs a window (the designed syncs of the
      served path).
   3. The same under GRAFT_SANITIZE=1: the same ids; then no kernel built
      or loaded since the snapshot, and no non-daemon thread left when the
      servers are closed.
   The second child starts with every knob off:
   4. ``--nq`` queries on the ``ivfsq`` index with each witness alone and
      with none: QPS and p50/p99 a run (readings, not bounds), the same
      ids in each. xfercheck and sanitize on one server between two runs
      with none; lockdep and racecheck (which turns lockdep's factories
      on too) each on a server made under its knob.
   A child that exits nonzero or prints no result fails the script.

Before each of phases 3-8, a-d, each arm of j and each part of e and g
every kernel's launch count is zeroed (phase b reads none), and it is
read after the phase (a replay adds the launches its graph holds): K1
must have launched on the ivfsq path, the surface index, the direct path, the ivfsq part of phase e and each ivfsq part of phase g
(each nprobe of part 1, parts 2-4) and phase k's tier path (the
whole of k.1, and neither K2, K3 nor K4 there; in k.2 on every shard),
K3 over the lists on phase g's knnlm
part, K3 on the knnlm path through
``adc_scan_lists`` (and neither K2 nor K4: the dispatch is fixed by the
geometry) and on phase e's knnlm part, K2 on the K2 path, K4 on the
flat-PQ path (and neither K2 nor K3), the pre-transform path, the wide
flat-PQ path and phase e's PQ64,RFlat part; on the hnswsq path no kernel
may launch (its graph is host C++). Phase f's launches happen in its rank
processes, which start at 0 and report them through ``ping``. In phase h
each arm zeroes the counts and reads them after, with the sharded
model's ``shard_launches``: K1 on the ``ivf_tpu`` arms (on every shard of
the sharded ones), K3 over the lists on every shard of the ``knnlm`` arms
(and neither K2 nor K4). Phase i's first child zeroes its own counts
before each index's witnessed serve and reads them after: K1 on the
``ivfsq`` serve, K3 over the lists on the ``knnlm`` one. Phase l zeroes
them before each trial's load and reads them after its search: K1.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}. Without
CUDA, or outside a checkout of the repo, the script exits nonzero before
printing any result.
"""

import argparse
import contextlib
import functools
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# rate outside the tensor cores. The kernels do fp32 FMAs and adds on
# CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# at most the SM clock (1.98 GHz boost): a spin of this many cycles per
# second asked for lasts at least that long at any clock
SLEEP_CYCLES_PER_S = 2e9

K1_REPLACES = "distributed_faiss_tpu/ops/flat_pallas.py:113"
K1_SOURCE = "distributed_faiss_tpu_torch/csrc/flat_scan.cu"
K2_REPLACES = "distributed_faiss_tpu/ops/adc_pallas.py:139"
K3_REPLACES = "distributed_faiss_tpu/ops/adc_pallas.py:209"
K4_REPLACES = "distributed_faiss_tpu/ops/adc_pallas.py:110"
ADC_SOURCE = "distributed_faiss_tpu_torch/csrc/adc_scan.cu"

# the nibble-supported geometry only takes ksub = 256; so do both kernels'
# phases here
KSUB = 256

# rows of the knnlm shard (the repo's full-size knnlm row) and of the
# IVF1024,PQ12,RFlat index (the first rows of the same corpus)
KNNLM_N = 500_000
K2_N = 100_000

# rows of the ivfsq corpus behind the surface index (phase a) and the
# hnswsq index (phase d): the first rows of phase 3's corpus
SURFACE_N = 100_000
HNSW_N = 200_000

# H100 L2 is 50 MB: timed calls that read four times that before they take
# the same inputs again find none of them there, and read them from HBM as
# their bound assumes
L2_ROTATE_BYTES = 200 * 1024 * 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def l2_copies(args: tuple, nbytes: int) -> list:
    """``args`` and enough copies of it (tensors cloned) that calls reading
    ``nbytes`` each and taking the copies in turn read ``L2_ROTATE_BYTES``
    before a copy comes round again."""
    n = max(2, -(-L2_ROTATE_BYTES // max(1, nbytes)) + 1)
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                     for _ in range(n - 1)]


def time_ms(call, arg_sets: list, warmup: int = 3, iters: int = 20,
            queued: bool = True) -> float:
    """Mean time of one ``call(*args)``, from CUDA events around back-to-back
    calls after ``warmup`` calls, taking ``arg_sets`` in turn for at least
    one round. Given ``l2_copies`` the calls read their inputs from HBM;
    given one set, inputs that fit the 50 MB L2 may be read from there.

    ``queued``: the card first spins for longer than the host takes to
    issue the timed calls, so they run back to back on the card and the
    events see device time only. Without it the events also see the host's
    time between launches wherever issuing a call (Python, checks,
    allocation) takes longer than running it."""
    n = len(arg_sets)
    iters = max(iters, n)
    for i in range(warmup):
        call(*arg_sets[i % n])
    torch.cuda.synchronize()
    if queued:
        t0 = time.perf_counter()
        call(*arg_sets[0])
        torch.cuda.synchronize()
        one_call_s = time.perf_counter() - t0
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * (2 * iters * one_call_s + 1e-3)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        call(*arg_sets[i % n])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_bound(q, list_data, li, list_sizes, stored_norms: bool):
    """(bound_ms, bound_by, bytes, flops) of one K1 call on these inputs.
    Bytes: each input byte the call needs read once — the live rows
    (payload + id + stored norm) of every distinct probed list, the query
    block, the probe indices and their fill counts — and the (nq, g, cap)
    fp32 scores written once. Operations: 2*d flops (the dot) for each
    (query, probe, live row) triple; decode and the l2 combine add a few
    more per row, which are left out."""
    nq, d = q.shape
    g = li.shape[1]
    cap = list_data.shape[1]
    sizes = list_sizes.clamp(max=cap)
    unique_live = int(sizes[torch.unique(li.long())].sum().item())
    pair_live = int(sizes[li.long()].sum().item())
    row_bytes = d * list_data.element_size() + 4 + (4 if stored_norms else 0)
    nbytes = unique_live * row_bytes + nq * g * cap * 4 + nq * d * 4 + 2 * nq * g * 4
    flops = pair_live * 2 * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def adc_bound(lut, codes):
    """(bound_ms, bound_by, bytes, ops) of one K2/K3 call on these inputs.
    Bytes: every pair's LUT (P * m * ksub * itemsize) and every code row it
    is given (P * L * m) read once, the (P, L) fp32 scores written once.
    Operations: one fp32 add per code byte (P * L * m); the table lookups
    are loads, not arithmetic."""
    P, m, _ = lut.shape
    L = codes.shape[1]
    nbytes = lut.numel() * lut.element_size() + codes.numel() + P * L * 4
    ops = P * L * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def lists_bound(lut, list_codes, li, list_sizes):
    """(bound_ms, bound_by, bytes, ops) of one ``adc_scan_lists`` call on
    these inputs. Bytes: every pair's LUT, the live code rows and ids of
    every distinct probed list, the probe indices and their fill counts,
    each read once, and the (nq, g, cap) fp32 scores written once.
    Operations: one fp32 add per code byte of each (pair, live row)."""
    nq, g = li.shape
    m = lut.shape[1]
    cap = list_codes.shape[1]
    sizes = list_sizes.clamp(min=0, max=cap)
    unique_live = int(sizes[torch.unique(li.long())].sum().item())
    pair_live = int(sizes[li.long()].sum().item())
    nbytes = (lut.numel() * lut.element_size() + unique_live * (m + 4) + 2 * nq * g * 4
              + nq * g * cap * 4)
    ops = pair_live * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def shared_bound(lut, codes):
    """(bound_ms, bound_by, bytes, ops) of one K4 call on these inputs.
    Bytes: the (L, m) codes, the (nq, m, ksub) LUTs and the (nq, L) fp32
    scores, each once. Operations: one fp32 add per (query, code byte)."""
    nq, m, _ = lut.shape
    L = codes.shape[0]
    nbytes = codes.numel() + lut.numel() * lut.element_size() + nq * L * 4
    ops = nq * L * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def compare_scores(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
                   what: str) -> float:
    """Identical -inf masks and allclose finite scores; returns the max
    absolute error over the finite entries."""
    got_inf, want_inf = torch.isinf(got), torch.isinf(want)
    if not torch.equal(got_inf, want_inf):
        bad = int((got_inf != want_inf).sum().item())
        raise AssertionError(f"{what}: -inf masks differ in {bad} slots")
    if not bool(torch.isfinite(got[~got_inf]).all()):
        raise AssertionError(f"{what}: NaN in kernel scores")
    f = ~want_inf
    if not bool(f.any()):
        return 0.0
    err = (got[f] - want[f]).abs()
    lim = atol + rtol * want[f].abs()
    if not bool((err <= lim).all()):
        i = int(torch.argmax(err - lim).item())
        raise AssertionError(
            f"{what}: scores disagree beyond rtol={rtol} atol={atol}: max abs err "
            f"{float(err.max()):.4g}, worst {float(got[f][i]):.6g} vs {float(want[f][i]):.6g}")
    return float(err.max().item())


def launch_counters(flat_scan, adc):
    """name -> the wrapper that counts that kernel's launches."""
    return {"K1": flat_scan.flat_list_scan, "K2": adc.adc_scan, "K3": adc.adc_scan_nibble,
            "K3 lists": adc.adc_scan_lists, "K4": adc.adc_scan_shared}


def zero_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


# ---------------------------------------------------------------- phase 2


def kernel_variants():
    """(codec, metric, stored_norms, scan_bf16): every K1 variant."""
    out = []
    for codec in ("f32", "f16", "sq8"):
        out.append((codec, "l2", True, False))
        out.append((codec, "l2", False, False))
        out.append((codec, "dot", False, False))
        out.append((codec, "l2", True, True))
    return out


def kernel_phase(flat_scan, distance, seed: int) -> list:
    """K1 vs its plain version for every variant at d=128 and d=768."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    nq, cap, nlist = 256, 2048, 32
    rows = []
    for d in (128, 768):
        for vi, (codec, metric, stored, bf16) in enumerate(kernel_variants()):
            g = 1 + vi % 4
            dev = "cuda"
            q = torch.randn((nq, d), generator=gen, device=dev)
            if codec == "sq8":
                data = torch.randint(0, 256, (nlist, cap, d), generator=gen, device=dev,
                                     dtype=torch.int32).to(torch.uint8)
                vmin = torch.randn((d,), generator=gen, device=dev)
                span = torch.rand((d,), generator=gen, device=dev) + 0.5
                decoded = vmin + data.float() * (span / 255.0)
            else:
                vmin = span = None
                data = torch.randn((nlist, cap, d), generator=gen, device=dev).to(
                    flat_scan.CODECS[codec][1])
                decoded = data.float()
            norms = distance.row_norms_f32(decoded) if (metric == "l2" and stored) else None
            del decoded
            ids = torch.randint(0, 1 << 20, (nlist, cap), generator=gen, device=dev,
                                dtype=torch.int32)
            ids[torch.rand((nlist, cap), generator=gen, device=dev) < 0.05] = -1
            sizes = torch.randint(0, cap + 1, (nlist,), generator=gen, device=dev,
                                  dtype=torch.int32)
            sizes[0] = cap  # one full list
            li = torch.randint(0, nlist, (nq, g), generator=gen, device=dev,
                               dtype=torch.int32)
            li[0, 0] = 0
            sizes_g = sizes[li.long()].contiguous()
            args = (q, data, ids, li, sizes_g, norms, vmin, span)
            kw = dict(metric=metric, codec=codec, scan_bf16=bf16)
            got = flat_scan.flat_list_scan(*args, **kw)
            want = flat_scan.flat_list_scan_plain(*args, **kw)
            torch.cuda.synchronize()
            rtol, atol = (5e-2, 5e-1) if bf16 else (1e-4, 1e-4)
            name = (f"d={d} {codec} {metric}"
                    f"{' stored' if stored else (' recompute' if metric == 'l2' else '')}"
                    f"{' bf16' if bf16 else ''} g={g}")
            err = compare_scores(got, want, rtol, atol, f"K1 {name}")
            bound_ms, bound_by, nbytes, _ = k1_bound(q, data, li, sizes, norms is not None)
            sets = l2_copies(args, nbytes)
            ms = time_ms(functools.partial(flat_scan.flat_list_scan, **kw), sets)
            plain_ms = time_ms(functools.partial(flat_scan.flat_list_scan_plain, **kw), sets,
                               warmup=1, iters=5)
            rows.append(dict(variant=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            log(f"K1 {name}: ok max_abs_err={err:.3g} (rtol={rtol} atol={atol}) "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
            del args, sets, got, want, data, ids, norms
        torch.cuda.empty_cache()
    return rows


def adc_kernel_phase(adc, seed: int) -> list:
    """K2 (m=4, 12) and K3 (m=8, 64) vs the plain version, f32 and bf16
    LUT, P=256 pairs, L=1, 1000, 2048 code rows; then K2 at m=190 and K3 at
    m=256, f32 LUT, L=1000: wider than a block's shared memory, so scored
    in subspace slices."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    P = 256
    rows = []
    cases = [(kid, fn, m, dtype, L)
             for kid, fn, ms_ in (("K2", adc.adc_scan, (4, 12)),
                                  ("K3", adc.adc_scan_nibble, (8, 64)))
             for m in ms_ for dtype in (torch.float32, torch.bfloat16) for L in (1, 1000, 2048)]
    cases += [("K2", adc.adc_scan, 190, torch.float32, 1000),
              ("K3", adc.adc_scan_nibble, 256, torch.float32, 1000)]
    for kid, fn, m, dtype, L in cases:
        lut = torch.randn((P, m, KSUB), generator=gen, device="cuda").to(dtype)
        codes = torch.randint(0, KSUB, (P, L, m), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.uint8)
        got = fn(lut, codes)
        want = adc.adc_scan_plain(lut, codes)
        torch.cuda.synchronize()
        name = (f"{kid} m={m} {'bf16' if dtype == torch.bfloat16 else 'f32'} L={L} "
                f"slices={fn.slices}")
        err = compare_scores(got, want, 1e-4, 1e-4, name)
        bound_ms, bound_by, nbytes, _ = adc_bound(lut, codes)
        sets = l2_copies((lut, codes), nbytes)
        ms = time_ms(fn, sets)
        plain_ms = time_ms(adc.adc_scan_plain, sets, warmup=1, iters=5)
        rows.append(dict(variant=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"{name}: ok max_abs_err={err:.3g} (rtol=0.0001 atol=0.0001) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {nbytes} bytes)")
        del lut, codes, sets, got, want
    torch.cuda.empty_cache()
    return rows


def lists_kernel_phase(adc, seed: int) -> list:
    """K3 over the probed lists (``adc_scan_lists``) vs its plain version:
    m=8 and 64, f32 and bf16 LUT, 64 lists of capacity 1000 and 2048
    (sizes from 0 to the capacity, 5% of the ids -1), 128 queries x 2
    probes with a list probed twice; then m=256 with an f32 LUT, wider
    than a block's shared memory, so scored in subspace slices."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 3)
    nq, g, nlist = 128, 2, 64
    rows = []
    cases = [(m, dtype, cap) for m in (8, 64) for dtype in (torch.float32, torch.bfloat16)
             for cap in (1000, 2048)]
    cases.append((256, torch.float32, 1000))
    for m, dtype, cap in cases:
        lut = torch.randn((nq * g, m, KSUB), generator=gen, device="cuda").to(dtype)
        list_codes = torch.randint(0, KSUB, (nlist, cap, m), generator=gen, device="cuda",
                                   dtype=torch.int32).to(torch.uint8)
        list_ids = torch.randint(0, 1 << 20, (nlist, cap), generator=gen, device="cuda",
                                 dtype=torch.int32)
        list_ids[torch.rand((nlist, cap), generator=gen, device="cuda") < 0.05] = -1
        sizes = torch.randint(0, cap + 1, (nlist,), generator=gen, device="cuda",
                              dtype=torch.int32)
        sizes[:3] = torch.tensor([cap, 0, 1], dtype=torch.int32, device="cuda")
        li = torch.randint(0, nlist, (nq, g), generator=gen, device="cuda", dtype=torch.int32)
        li[0] = 0  # the full list, twice
        li[1, 0] = 1
        li[2, 0] = 2
        args = (lut, list_codes, li, sizes[li.long()].contiguous(), list_ids)
        got = adc.adc_scan_lists(*args)
        want = adc.adc_scan_lists_plain(*args)
        torch.cuda.synchronize()
        name = (f"K3 lists m={m} {'bf16' if dtype == torch.bfloat16 else 'f32'} cap={cap} "
                f"slices={adc.adc_scan_lists.slices}")
        err = compare_scores(got, want, 1e-4, 1e-4, name)
        bound_ms, bound_by, nbytes, _ = lists_bound(lut, list_codes, li, sizes)
        sets = l2_copies(args, nbytes)
        ms = time_ms(adc.adc_scan_lists, sets)
        plain_ms = time_ms(adc.adc_scan_lists_plain, sets[:8], warmup=1, iters=5)
        rows.append(dict(variant=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"{name}: ok max_abs_err={err:.3g} (rtol=0.0001 atol=0.0001, -inf masks "
            f"identical) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {nbytes} bytes)")
        del args, sets, got, want, lut, list_codes, list_ids
    torch.cuda.empty_cache()
    return rows


def shared_kernel_phase(adc, seed: int) -> list:
    """K4 vs its plain version at tpu_validate.py's shared geometries: m=16
    and 64, f32 and bf16 LUT, nq=4 and 256 queries, L=13, 5000 and 65536
    code rows; then m=128 with an f32 LUT at nq=256, L=65536, wider than a
    block's shared memory, so scored in subspace slices. Bit-exact: both
    sides add the same fp32 values in subspace order."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2)
    rows = []
    cases = [(m, dtype, nq, L) for m in (16, 64) for dtype in (torch.float32, torch.bfloat16)
             for nq in (4, 256) for L in (13, 5000, 65536)]
    cases.append((128, torch.float32, 256, 65536))
    for m, dtype, nq, L in cases:
        lut = torch.randn((nq, m, KSUB), generator=gen, device="cuda").to(dtype)
        codes = torch.randint(0, KSUB, (L, m), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.uint8)
        got = adc.adc_scan_shared(lut, codes)
        want = adc.adc_scan_shared_plain(lut, codes)
        torch.cuda.synchronize()
        name = (f"K4 m={m} {'bf16' if dtype == torch.bfloat16 else 'f32'} "
                f"nq={nq} L={L} slices={adc.adc_scan_shared.slices}")
        err = compare_scores(got, want, 0.0, 0.0, name)
        bound_ms, bound_by, nbytes, _ = shared_bound(lut, codes)
        sets = l2_copies((lut, codes), nbytes)
        ms = time_ms(adc.adc_scan_shared, sets)
        # the plain version's time on a few of the copies: at small inputs
        # a whole rotation would be thousands of host-paced calls
        plain_ms = time_ms(adc.adc_scan_shared_plain, sets[:8], warmup=1, iters=5)
        rows.append(dict(variant=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"{name}: ok, bit-exact, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes), "
            f"{nq * L * m / (ms * 1e-3) / 1e9:.1f} G lookups/s")
        del lut, codes, sets, got, want
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phases 3-8


def make_corpus(rng, n: int, d: int, centers: np.ndarray) -> np.ndarray:
    """bench.py's generator: points drawn from gaussian-mixture centers."""
    assign = rng.integers(0, centers.shape[0], n)
    return (centers[assign] + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def make_lowrank_corpus(rng, d: int, r: int, n_latent_clusters: int,
                        ambient_sigma: float = 0.05):
    """The knnlm corpus of benchmarks/baseline_configs.py (a copy: this
    script imports nothing of the JAX package): a mixture of
    ``n_latent_clusters`` gaussians in r dims, embedded by a fixed random
    orthonormal (r, d) map, plus small isotropic ambient noise. A model's
    hidden states concentrate on such a low-dimensional manifold; an
    isotropic 768-d mixture cannot reach recall@10 0.95 under any
    quantizer. Returns gen(n) -> (n, d) fp32."""
    W = np.linalg.qr(rng.standard_normal((d, r)))[0].T.astype(np.float32)
    centers_z = rng.standard_normal((n_latent_clusters, r)).astype(np.float32) * 4.0

    def gen(nn):
        a = rng.integers(0, centers_z.shape[0], nn)
        z = centers_z[a] + rng.standard_normal((nn, r)).astype(np.float32)
        x = z @ W + ambient_sigma * rng.standard_normal((nn, d)).astype(np.float32)
        return x.astype(np.float32)

    return gen


def check_result(D: np.ndarray, meta, nq: int, k: int, what: str) -> None:
    """(nq, k) l2 distances, ascending, finite where a row was found and
    +inf where fewer than k candidates were live (metadata None)."""
    live = np.array([[m is not None for m in row] for row in meta], bool)
    with np.errstate(invalid="ignore"):  # inf - inf between two pad slots
        unsorted = (np.diff(D, axis=1) < 0).any()
    if (D.shape != (nq, k) or live.shape != (nq, k) or not np.isfinite(D[live]).all()
            or not np.isposinf(D[~live]).all() or unsorted):
        raise AssertionError(f"bad {what} result")


def recall_at_10(meta, gt_ids: np.ndarray) -> float:
    """Share of the ground truth's ids among the served rows' ids (meta[0],
    or the metadata itself where it is the id, as ``load_data`` adds it)."""
    hits = 0
    for i, row in enumerate(meta):
        ids = {m if isinstance(m, int) else m[0] for m in row if m is not None}
        hits += len(ids & set(gt_ids[i].tolist()))
    return hits / (10 * len(meta))


def serve_queries(client, q: np.ndarray, index_id: str, rows_per_request: int,
                  concurrency: int, k: int = 10):
    """Send ``q`` as requests of ``rows_per_request`` rows from
    ``concurrency`` threads at top-``k``; returns (wall seconds, request
    latencies, per-request (D, meta))."""
    starts = list(range(0, q.shape[0], rows_per_request))
    lat = [0.0] * len(starts)
    results = [None] * len(starts)
    errors = []
    next_i = iter(range(len(starts)))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next(next_i, None)
            if i is None:
                return
            s = starts[i]
            t0 = time.perf_counter()
            try:
                results[i] = client.search(q[s:s + rows_per_request], k, index_id)
            except Exception as e:  # re-raised below, on the main thread
                errors.append(e)
                return
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=worker, name=f"smoke-client-{t}")
               for t in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, np.asarray(lat), results


class Serving:
    """One port IndexServer on a loopback port, serving from a thread, and
    an IndexClient over a discovery file under ``work``; closed on exit."""

    def __init__(self, work: str, store: str = None, scheduler_cfg=None, tracing_cfg=None):
        from distributed_faiss_tpu_torch.parallel.client import IndexClient
        from distributed_faiss_tpu_torch.parallel.server import IndexServer

        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        self.work = work
        self.store = store or os.path.join(work, "store")
        self.server = IndexServer(0, self.store, scheduler_cfg=scheduler_cfg, device="cuda",
                                  tracing_cfg=tracing_cfg)
        self.port = port = self.server.bind(0)
        self.thread = threading.Thread(target=self.server.start_blocking,
                                       name="smoke-server", daemon=True)
        self.thread.start()
        self.client = None
        try:
            self.disc = os.path.join(work, "discovery.txt")
            with open(self.disc, "w") as f:
                f.write(f"1\nlocalhost,{port}\n")
            self.client = IndexClient(self.disc)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self.client is not None:
            self.client.close()
        self.server.stop()
        self.thread.join(timeout=10)
        shutil.rmtree(self.work, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def build_index(client, iid: str, cfg, x: np.ndarray, what: str, meta=None) -> None:
    """create_index, add ``x`` with ``meta`` (default: ``(row,)`` tuples, the
    row number being the id at ``custom_meta_id_idx`` 0) as metadata in
    50,000-row batches, and wait for the threshold training and the add
    drain."""
    from distributed_faiss_tpu_torch.utils.state import IndexState

    n = x.shape[0]
    if client.create_index(iid, cfg) != [True]:
        raise AssertionError(f"{what}: create_index failed")
    t0 = time.perf_counter()
    bsz = 50_000
    for s in range(0, n, bsz):
        client.add_index_data(iid, x[s:s + bsz], [(r,) for r in range(s, min(n, s + bsz))]
                              if meta is None else meta[s:s + bsz])
    sent_s = time.perf_counter() - t0
    deadline = time.monotonic() + 900
    while True:
        state = client.get_state(iid)
        if (state == IndexState.TRAINED and client.get_buffer_depth(iid) == 0
                and client.get_ntotal(iid) == n):
            break
        if time.monotonic() > deadline:
            raise RuntimeError(f"{what}: index not built in time: state {state}, "
                               f"ntotal {client.get_ntotal(iid)}")
        time.sleep(0.2)
    log(f"{what}: added {n} rows in {sent_s:.2f} s of RPC; trained + indexed after "
        f"{time.perf_counter() - t0:.2f} s")


def exact_ground_truth(x: np.ndarray, q: np.ndarray, k: int, what: str) -> np.ndarray:
    """Top-k ids of the port's exact FlatIndex on the card."""
    from distributed_faiss_tpu_torch.models.flat import FlatIndex

    t0 = time.perf_counter()
    exact = FlatIndex(x.shape[1], "l2", device="cuda")
    exact.add(x)
    gt_d, gt_ids = exact.search(q, k)
    del exact
    torch.cuda.empty_cache()
    if not np.isfinite(gt_d).all() or gt_ids.shape != (q.shape[0], k):
        raise AssertionError(f"{what}: exact FlatIndex returned bad results")
    log(f"{what}: exact FlatIndex ground truth in {time.perf_counter() - t0:.2f} s")
    return gt_ids


def sweep_nprobe(client, iid: str, q_eval: np.ndarray, gt_ids: np.ndarray, start: int,
                 nlist: int, what: str):
    """Double nprobe from ``start`` until recall@10 >= 0.95; fails when
    nprobe reaches ``nlist`` first. Returns (nprobe, recall)."""
    nprobe = start
    while True:
        client.set_nprobe(iid, nprobe)
        D, meta = client.search(q_eval, 10, iid)
        check_result(D, meta, q_eval.shape[0], 10, f"{what} search at nprobe={nprobe}")
        rec = recall_at_10(meta, gt_ids)
        log(f"{what}: nprobe={nprobe} recall@10={rec:.4f}")
        if rec >= 0.95:
            return nprobe, rec
        if nprobe >= nlist:
            raise AssertionError(f"{what}: recall@10 < 0.95 even at nprobe = {nlist}")
        nprobe = min(2 * nprobe, nlist)


def serve_and_report(args, client, iid: str, q_all: np.ndarray, nprobe: int, card: str,
                     what: str) -> dict:
    serve_queries(client, q_all[:1000], iid, 100, 8)  # warm
    qps, p50, p99, meta = timed_serve(client, q_all, iid, what, card, f", nprobe={nprobe}")
    if args.profile:
        profile_window(client, q_all[:2000], iid)
    return dict(qps=qps, p50_ms=p50, p99_ms=p99, meta=meta)


def timed_serve(client, q_all: np.ndarray, iid: str, what: str, card: str, detail: str = ""):
    """One timed run of ``q_all`` as 100-row requests from 8 threads, each
    result checked: (QPS, p50 ms, p99 ms, the per-request metadata)."""
    wall, lat, results = serve_queries(client, q_all, iid, 100, 8)
    for D, meta in results:
        check_result(D, meta, 100, 10, f"{what} served search")
    qps = q_all.shape[0] / wall
    p50, p99 = (float(np.percentile(lat, p) * 1e3) for p in (50, 99))
    log(f"{what}: served {q_all.shape[0]} queries at top-10{detail}: "
        f"{qps:.1f} QPS, request p50 {p50:.3f} ms p99 {p99:.3f} ms "
        f"(100-row requests, 8 concurrent clients) on {card}")
    return qps, p50, p99, [m for _d, m in results]


def log_programs(s, iid: str, what: str) -> dict:
    """The served model's program cache: programs held, captures and their
    seconds, replays, evictions and the graph pool's bytes."""
    stats = s.server.indexes[iid].model.program_stats()
    log(f"{what}: captured programs {json.dumps(stats)}")
    return stats


def save_drop_load(client, iid: str, q_eval: np.ndarray, nprobe: int, what: str) -> None:
    D1, meta1 = client.search(q_eval, 10, iid)
    client.save_index(iid)
    client.drop_index(iid)
    if not client.load_index(iid):
        raise AssertionError(f"{what}: load_index failed")
    client.set_nprobe(iid, nprobe)
    D2, meta2 = client.search(q_eval, 10, iid)
    if meta1 != meta2:
        raise AssertionError(f"{what}: ids after save/drop/load differ from before")
    np.testing.assert_array_equal(D1, D2)
    log(f"{what}: save -> drop -> load served identical ids and distances")


def ivfsq_path(args, counters, card: str) -> dict:
    """Phase 3: the Quickstart shard on the ivfsq builder (K1). Its server
    (``out["serving"]``, closed by the caller, with a metrics listener on a
    free port) stays up for phases b, c, e and g, and the corpus's first
    200,000 rows and the queries are kept for phases a and d."""
    from distributed_faiss_tpu_torch.utils.config import IndexCfg, TracingCfg

    d, n, what = 128, args.n, "ivfsq"
    rng = np.random.default_rng(args.seed)
    centers = rng.standard_normal((1024, d)).astype(np.float32) * 4.0
    t0 = time.perf_counter()
    x = make_corpus(rng, n, d, centers)
    q_all = make_corpus(rng, args.nq, d, centers)
    q_eval = q_all[:1000]
    log(f"{what}: made {n} x {d} corpus and {args.nq} queries in "
        f"{time.perf_counter() - t0:.2f} s (seed {args.seed})")
    s = Serving(os.path.join(REPO, "build", "chip_smoke"),
                tracing_cfg=TracingCfg(metrics_port=free_base(1)))
    try:
        iid = "quickstart"
        cfg = IndexCfg(index_builder_type="ivfsq", dim=d, metric="l2", train_num=100_000,
                       centroids=1024, nprobe=32, pallas_flat=True)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x, what)
        gt_ids = exact_ground_truth(x, q_eval, 10, what)
        nprobe, rec = sweep_nprobe(s.client, iid, q_eval, gt_ids, args.nprobe_from, 1024, what)
        out = serve_and_report(args, s.client, iid, q_all, nprobe, card, what)
        out["programs"] = log_programs(s, iid, what)
        save_drop_load(s.client, iid, q_eval, nprobe, what)
        out.update(counts=read_counts(counters), recall=rec)
        keep_for_witness(s, iid, what, q_all, out["meta"], nprobe)
        if out["counts"]["K1"] <= 0:
            raise AssertionError(f"{what}: K1 was not launched on this path")
        # the loaded model's tensors, for timing K1 at the path's shapes
        # (read after the counts above, so those launches do not count)
        out["model"] = s.server.indexes[iid].model
    except BaseException:
        s.close()
        raise
    out.update(q_block=q_all[:256], serving=s, iid=iid, nprobe=nprobe, q_all=q_all,
               x_head=x[:HNSW_N], x=x, gt=gt_ids, centers=centers)
    log(f"{what}: launches {out['counts']}")
    return out


def check_requests(client, iid: str, q_all: np.ndarray, what: str) -> None:
    """Four 100-row requests, each (100, 10) finite ascending distances."""
    for r in range(4):
        D, meta = client.search(q_all[r * 100:(r + 1) * 100], 10, iid)
        check_result(D, meta, 100, 10, f"{what} request {r}")


def knnlm_path(args, counters, card: str) -> dict:
    """Phases 4-8 on one server over the low-rank corpus: the knnlm shard
    (K3), IVF1024,PQ12,RFlat (K2), flat PQ64,RFlat (K4),
    OPQ64,PQ64,RFlat (K4 behind the OPQ rotation) and flat PQ128,RFlat
    (K4 in subspace slices). The server (``out["serving"]``, closed by the
    caller) stays up for phase e, and the corpus, the eval queries and
    their exact top-10 are kept for it."""
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    d, n, what = 768, KNNLM_N, "knnlm"
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    gen = make_lowrank_corpus(rng, d, r=64, n_latent_clusters=8192)
    x = gen(n)
    q_all = gen(args.nq)
    q_eval = q_all[:1000]
    log(f"{what}: made {n} x {d} low-rank corpus and {args.nq} queries in "
        f"{time.perf_counter() - t0:.2f} s (seed {args.seed})")
    out = {}
    s = Serving(os.path.join(REPO, "build", "chip_smoke_pq"))
    try:
        iid = "knnlm"
        cfg = IndexCfg(index_builder_type="knnlm", dim=d, metric="l2", centroids=4096,
                       train_num=100_000, nprobe=32, code_size=64, pallas_adc=True,
                       adc_lut_bf16=True, refine_k_factor=8)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x, what)
        gt_full = exact_ground_truth(x, q_eval, 10, what)
        nprobe, rec = sweep_nprobe(s.client, iid, q_eval, gt_full, args.nprobe_from, 4096,
                                   what)
        pq_out = serve_and_report(args, s.client, iid, q_all, nprobe, card, what)
        pq_out["programs"] = log_programs(s, iid, what)
        save_drop_load(s.client, iid, q_eval, nprobe, what)
        pq_out.update(counts=read_counts(counters), recall=rec)
        keep_for_witness(s, iid, what, q_all, pq_out["meta"], nprobe)
        log(f"{what}: launches {pq_out['counts']}")
        if pq_out["counts"]["K3"] <= 0 or pq_out["counts"]["K3 lists"] <= 0:
            raise AssertionError(f"{what}: K3 was not launched over the probed lists on "
                                 "this path")
        if pq_out["counts"]["K2"] != 0 or pq_out["counts"]["K4"] != 0:
            raise AssertionError(f"{what}: K2 or K4 launched on a path whose geometry is K3's")
        pq_out.update(model=s.server.indexes[iid].model, q_block=q_all[:256])
        out["knnlm"] = pq_out

        what, iid, n2 = "IVF1024,PQ12,RFlat", "k2", K2_N
        cfg = IndexCfg(faiss_factory="IVF1024,PQ12,RFlat", dim=d, metric="l2",
                       train_num=50_000, nprobe=32)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x[:n2], what)
        check_requests(s.client, iid, q_all, what)
        D, meta = s.client.search(q_eval, 10, iid)
        check_result(D, meta, q_eval.shape[0], 10, f"{what} recall request")
        k2_out = dict(counts=read_counts(counters))
        log(f"{what}: launches {k2_out['counts']}")
        if k2_out["counts"]["K2"] <= 0:
            raise AssertionError(f"{what}: K2 was not launched on this path")
        gt_head = exact_ground_truth(x[:n2], q_eval, 10, what)
        k2_out["recall"] = recall_at_10(meta, gt_head)
        log(f"{what}: recall@10={k2_out['recall']:.4f} at nprobe=32 (logged, not gated)")
        k2_out.update(model=s.server.indexes[iid].model, q_block=q_all[:256])
        out["k2"] = k2_out

        # phase 6: flat PQ (K4) over the whole corpus, phase 4's queries and
        # ground truth
        what, iid = "PQ64,RFlat", "flatpq"
        cfg = IndexCfg(faiss_factory="PQ64,RFlat", dim=d, metric="l2", train_num=100_000)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x, what)
        D, meta = s.client.search(q_eval, 10, iid)
        check_result(D, meta, q_eval.shape[0], 10, f"{what} recall request")
        rec = recall_at_10(meta, gt_full)
        log(f"{what}: recall@10={rec:.4f} (one list, every row scored)")
        if rec < 0.95:
            raise AssertionError(f"{what}: recall@10 {rec:.4f} < 0.95")
        flat_out = serve_and_report(args, s.client, iid, q_all, 1, card, what)
        flat_out["programs"] = log_programs(s, iid, what)
        save_drop_load(s.client, iid, q_eval, 1, what)
        flat_out.update(counts=read_counts(counters), recall=rec)
        log(f"{what}: launches {flat_out['counts']}")
        if flat_out["counts"]["K4"] <= 0:
            raise AssertionError(f"{what}: K4 was not launched on this path")
        if flat_out["counts"]["K2"] != 0 or flat_out["counts"]["K3"] != 0:
            raise AssertionError(f"{what}: K2 or K3 launched on the one-list path")
        flat_out.update(model=s.server.indexes[iid].model, q_block=q_all[:256])
        out["flatpq"] = flat_out

        # phase 7: the OPQ rotation in front of flat PQ, over the K2 path's
        # rows and ground truth
        what, iid = "OPQ64,PQ64,RFlat", "opq"
        cfg = IndexCfg(faiss_factory="OPQ64,PQ64,RFlat", dim=d, metric="l2",
                       train_num=50_000)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x[:n2], what)
        check_requests(s.client, iid, q_all, what)
        D, meta = s.client.search(q_eval, 10, iid)
        check_result(D, meta, q_eval.shape[0], 10, f"{what} recall request")
        save_drop_load(s.client, iid, q_eval, 1, what)
        opq_out = dict(counts=read_counts(counters), recall=recall_at_10(meta, gt_head))
        log(f"{what}: recall@10={opq_out['recall']:.4f} (logged, not gated); "
            f"launches {opq_out['counts']}")
        if opq_out["counts"]["K4"] <= 0:
            raise AssertionError(f"{what}: K4 was not launched on this path")
        out["opq"] = opq_out

        # phase 8: flat PQ at m=128, whose f32 LUT is wider than a block's
        # shared memory: K4 runs in subspace slices; the K2 path's rows
        what, iid = "PQ128,RFlat", "flatpq128"
        cfg = IndexCfg(faiss_factory="PQ128,RFlat", dim=d, metric="l2", train_num=50_000)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x[:n2], what)
        check_requests(s.client, iid, q_all, what)
        D, meta = s.client.search(q_eval, 10, iid)
        check_result(D, meta, q_eval.shape[0], 10, f"{what} recall request")
        wide_out = dict(counts=read_counts(counters), recall=recall_at_10(meta, gt_head))
        slices = counters["K4"].slices
        log(f"{what}: recall@10={wide_out['recall']:.4f} (logged, not gated); "
            f"launches {wide_out['counts']}, {slices} subspace slices a K4 call")
        if wide_out["counts"]["K4"] <= 0 or slices < 2:
            raise AssertionError(f"{what}: K4 did not run in subspace slices on this path")
        out["flatpq128"] = wide_out
        # only phase e's indexes stay on the card
        for iid in ("k2", "opq", "flatpq128"):
            s.client.drop_index(iid)
    except BaseException:
        s.close()
        raise
    out.update(serving=s, x=x, q_eval=q_eval, q_all=q_all, nprobe=nprobe, gt=gt_full)
    return out


# ---------------------------------------------------------------- phases a-d


def host_filter(meta_row, k: int) -> list:
    """The first ``k`` hits of one unfiltered result row whose tag
    (meta[1]) is not 0: what search_with_filter keeps."""
    return [m for m in meta_row if m is not None and m[1] != 0][:k]


def surface_phase(sq: dict, counters) -> dict:
    """Phase a: the rest of one rank's surface over an ivfsq index of the
    first SURFACE_N rows of phase 3's corpus, metadata (row, row % 4):
    search_with_filter against the unfiltered top-k filtered on the host,
    get_ids, get_centroids, index_loaded and add_buffer_to_index."""
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    what, iid, n, k, max_requery = "surface", "surface", SURFACE_N, 10, 2
    client = sq["serving"].client
    x = sq["x_head"][:n]
    q = sq["q_all"][:1000]
    cfg = IndexCfg(index_builder_type="ivfsq", dim=x.shape[1], metric="l2", train_num=n,
                   centroids=1024, nprobe=sq["nprobe"], pallas_flat=True)
    zero_counts(counters)
    build_index(client, iid, cfg, x, what, [(r, r % 4) for r in range(n)])
    t0 = time.perf_counter()
    scores, kept = client.search_with_filter(q, k, iid, filter_pos=1, filter_value=0,
                                             max_requery=max_requery)
    filter_s = time.perf_counter() - t0
    _, plain = client.search(q, 3 * k, iid)
    short = 0
    for i, row in enumerate(kept):
        if any(m[1] == 0 for m in row):
            raise AssertionError(f"{what}: query {i} kept a row whose tag is 0")
        if not (np.isfinite(scores[i]).all() and (np.diff(scores[i][:, 0]) >= 0).all()):
            raise AssertionError(f"{what}: query {i}'s filtered scores are not ascending")
        want = host_filter(plain[i], k)
        factor = 3
        for _ in range(max_requery):
            if len(want) == k:
                break
            factor *= 3  # the client's requery step
            want = host_filter(client.search(q[i:i + 1], min(factor * k, n), iid)[1][0], k)
        if row != want:
            raise AssertionError(f"{what}: query {i}: search_with_filter kept {row[:3]}..., "
                                 f"the host filter {want[:3]}...")
        short += len(row) < k
    log(f"{what}: search_with_filter of {q.shape[0]} queries at top-{k} in "
        f"{filter_s * 1e3:.1f} ms matches the unfiltered top-{3 * k} filtered on the host; "
        f"{short} rows short after {max_requery} requeries")
    if client.get_ids(iid) != set(range(n)):
        raise AssertionError(f"{what}: get_ids is not the {n} row ids")
    cents = client.get_centroids(iid)
    if len(cents) != 1 or cents[0].shape != (1024, x.shape[1]):
        raise AssertionError(f"{what}: get_centroids returned {[c.shape for c in cents]}")
    stub = client.sub_indexes[0]
    if stub.index_loaded(iid) is not True or stub.index_loaded("absent") is not False:
        raise AssertionError(f"{what}: index_loaded answered wrong")
    client.add_buffer_to_index(iid)
    counts = read_counts(counters)
    log(f"{what}: get_ids, get_centroids, index_loaded and add_buffer_to_index answered; "
        f"launches {counts}")
    if counts["K1"] <= 0:
        raise AssertionError(f"{what}: K1 was not launched on this path")
    client.drop_index(iid)
    return dict(counts=counts, short=short, filter_ms=filter_s * 1e3)


WIRE_PAIRS = 10


def wire_phase(sq: dict, card: str) -> dict:
    """Phase b: phase 3's index served to a negotiated client (binary
    skeletons) and to a pickle-only client (DFT_RPC_WIRE=pickle at its
    construction) in WIRE_PAIRS pairs of runs, the side that runs first
    alternating; the ids are identical to each other and to phase 3's."""
    from distributed_faiss_tpu_torch.parallel.client import IndexClient

    s, iid, q_all = sq["serving"], sq["iid"], sq["q_all"]
    saved = os.environ.get("DFT_RPC_WIRE")
    os.environ["DFT_RPC_WIRE"] = "pickle"
    try:
        pickled = IndexClient(s.disc)
    finally:
        if saved is None:
            del os.environ["DFT_RPC_WIRE"]
        else:
            os.environ["DFT_RPC_WIRE"] = saved
    pickled.cfg = s.client.cfg
    clients = {"binary": s.client, "pickle": pickled}
    out = {"binary": [], "pickle": []}
    try:
        for c in clients.values():
            serve_queries(c, q_all[:1000], iid, 100, 8)  # warm
        for pair in range(WIRE_PAIRS):
            for name in (("pickle", "binary") if pair % 2 == 0 else ("binary", "pickle")):
                qps, p50, p99, meta = timed_serve(clients[name], q_all, iid,
                                                  f"wire {name} (pair {pair})", card)
                if meta != sq["meta"]:
                    raise AssertionError(f"wire {name}: ids differ from phase 3's")
                out[name].append(dict(qps=qps, p50_ms=p50, p99_ms=p99))
        server_wire = s.client.get_perf_stats()[0]["rpc"]["wire"]
        peer = {name: c.sub_indexes[0].rpc_stats()["peer_wire"] for name, c in clients.items()}
    finally:
        pickled.close()
    wins = sum(b["qps"] > p["qps"] for b, p in zip(out["binary"], out["pickle"]))
    med = {name: {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
           for name, runs in out.items()}
    quartiles = {name: [float(np.percentile([r["qps"] for r in runs], p)) for p in (25, 75)]
                 for name, runs in out.items()}
    log(f"wire: server offers {server_wire}; peer_wire {peer}; medians over "
        f"{WIRE_PAIRS} pairs: binary {med['binary']}, pickle {med['pickle']}; QPS quartiles "
        f"{quartiles}; binary's QPS higher in {wins} of {WIRE_PAIRS} pairs")
    if server_wire != "binary" or peer != {"binary": True, "pickle": False}:
        raise AssertionError("wire: the negotiated client did not negotiate, or the "
                             "pickle-only one did")
    return out


def direct_phase(sq: dict, counters, card: str) -> dict:
    """Phase c: a third server without the scheduler (SchedulerCfg(enabled=
    False)) loads phase 3's snapshot and serves ``--nq`` queries through
    engine.search and its natural batcher: phase 3's ids, K1 launched."""
    from distributed_faiss_tpu_torch.utils.config import SchedulerCfg

    iid, q_all, what = sq["iid"], sq["q_all"], "direct"
    with Serving(os.path.join(REPO, "build", "chip_smoke_direct"), store=sq["serving"].store,
                 scheduler_cfg=SchedulerCfg(enabled=False)) as s:
        if not s.client.load_index(iid):
            raise AssertionError(f"{what}: load_index of phase 3's snapshot failed")
        s.client.set_nprobe(iid, sq["nprobe"])
        zero_counts(counters)
        serve_queries(s.client, q_all[:1000], iid, 100, 8)  # warm

        def rows():
            r = s.client.get_perf_stats()[0]["engine"][iid]["device_search_rows"]
            return r["count"], r["total_s"]  # launches, rows

        n0, r0 = rows()
        qps, p50, p99, meta = timed_serve(s.client, q_all, iid, what, card)
        n1, r1 = rows()
        counts = read_counts(counters)
        if "scheduler" in s.client.get_perf_stats()[0]:
            raise AssertionError(f"{what}: the server runs a scheduler")
    rows_per_launch = (r1 - r0) / max(1, n1 - n0)
    log(f"{what}: {n1 - n0} engine launches for {r1 - r0:.0f} rows, {rows_per_launch:.1f} "
        f"rows a launch (100-row requests); launches {counts}")
    if meta != sq["meta"]:
        raise AssertionError(f"{what}: ids differ from phase 3's")
    if counts["K1"] <= 0:
        raise AssertionError(f"{what}: K1 was not launched on this path")
    return dict(qps=qps, p50_ms=p50, p99_ms=p99, rows_per_launch=rows_per_launch,
                counts=counts)


def hnswsq_phase(args, sq: dict, counters, card: str) -> dict:
    """Phase d: the hnswsq builder at its defaults over the first HNSW_N
    rows of phase 3's corpus; efSearch swept by doubling from 16 until
    recall@10 >= 0.95 (failing at 4096), ``--nq`` queries served, save ->
    drop -> load identical, the graph library built from native/hnsw.cpp
    into build/, and no kernel of the port launched."""
    from distributed_faiss_tpu_torch.models import hnsw
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    what, iid = "hnswsq", "hnswsq"
    x, q_all = sq["x_head"], sq["q_all"]
    q_eval = q_all[:1000]
    with Serving(os.path.join(REPO, "build", "chip_smoke_hnsw")) as s:
        cfg = IndexCfg(index_builder_type="hnswsq", dim=x.shape[1], metric="l2",
                       train_num=100_000)
        zero_counts(counters)
        t0 = time.perf_counter()
        build_index(s.client, iid, cfg, x, what)
        build_s = time.perf_counter() - t0
        model = s.server.indexes[iid].model
        if not isinstance(model, hnsw.HNSWSQIndex) or (
                model.M, model.ef_construction, model.refine_k_factor) != (128, 100, 8):
            raise AssertionError(f"{what}: the builder did not build the default graph")
        lib = hnsw.library_path()
        if (str(hnsw.SOURCE) != os.path.join(REPO, "native", "hnsw.cpp") or not lib.is_file()
                or not str(lib).startswith(os.path.join(REPO, "build") + os.sep)
                or os.path.realpath(hnsw.load_library()._name) != os.path.realpath(lib)):
            raise AssertionError(f"{what}: the graph library is not {lib}")
        gt_ids = exact_ground_truth(x, q_eval, 10, what)
        ef, rec = sweep_nprobe(s.client, iid, q_eval, gt_ids, 16, 4096, what)
        out = serve_and_report(args, s.client, iid, q_all, ef, card, what)
        save_drop_load(s.client, iid, q_eval, ef, what)
        counts = read_counts(counters)
    log(f"{what}: {x.shape[0]} rows built in {build_s:.2f} s (M=128, efConstruction=100, "
        f"exact rerank of 8x the shortlist on the card), efSearch={ef} recall@10={rec:.4f}; "
        f"graph library {os.path.relpath(lib, REPO)}; launches {counts}")
    if any(counts.values()):
        raise AssertionError(f"{what}: a kernel of the port launched on the graph path")
    out.update(build_s=build_s, ef=ef, recall=rec, counts=counts)
    return out


def host_stats(client) -> dict:
    """{layer/op: (count, total)} of the server's latency counters and the
    client stub's: rpc ops on the server, the scheduler's queue wait and
    window sizes, the engine's locked device search."""
    stats = client.get_perf_stats()[0]
    out = {}
    sections = [("server", {k: v for k, v in stats.items() if isinstance(v, dict)
                            and "count" in v}),
                ("scheduler", stats.get("scheduler", {}).get("queues", {})),
                ("client-rpc", stats.get("rpc", {}).get("client", {}))]
    sections += [(f"engine[{iid}]", v) for iid, v in stats.get("engine", {}).items()]
    for layer, ops in sections:
        for op, v in ops.items():
            if isinstance(v, dict) and "count" in v:
                out[f"{layer} {op}"] = (v["count"], v["total_s"])
    return out


def profile_window(client, q: np.ndarray, index_id: str) -> None:
    """--profile: serve ``q`` once more under torch.profiler and print the
    device's busy share of the window and its kernel time by name."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_faiss_tpu_torch.ops import adc_scan, flat_scan

    counters = launch_counters(flat_scan, adc_scan)
    before, launched = host_stats(client), read_counts(counters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _, _ = serve_queries(client, q, index_id, 100, 8)
        torch.cuda.synchronize()
    after = host_stats(client)
    launched = {k: n - launched[k] for k, n in read_counts(counters).items() if n > launched[k]}
    log(f"profile[{index_id}]: wrapper launches in the window {launched}")
    for name, (n, total) in after.items():
        n0, total0 = before.get(name, (0, 0.0))
        if n > n0:
            mean = (total - total0) / (n - n0)
            counts = name.endswith(("_rows", "_requests", "_depth"))
            value = f"{mean:.1f}" if counts else f"{mean * 1e3:.3f} ms"
            log(f"profile[{index_id}]: host {name}: {n - n0} x mean {value}")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"profile[{index_id}]: the profiler recorded no device activity: not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    total_us = sum(t for _, t in by_name.values())
    log(f"profile[{index_id}]: {q.shape[0]} queries in {wall * 1e3:.3f} ms of host time; "
        f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / wall:.1f}% of the "
        f"window), {len(kernels)} kernel launches")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"profile[{index_id}]:   {t / 1e3:9.3f} ms {100 * t / total_us:5.1f}% {n:6d}x "
            f"{name[:90]}")


# ---------------------------------------------------------------- phase 9


def k1_main_shape(flat_scan, ivf, model, q_block: np.ndarray, q_more: np.ndarray = None,
                  what: str = "ivfsq") -> dict:
    """K1 and its plain version on a path's own inputs: the loaded index's
    lists and the first probe group of one query block, built by the
    model's own helpers. The timed calls take ``l2_copies`` of them in
    turn; with ``q_more`` (lists too large to clone, as at the 65,536-list
    tier) they take the probe groups of successive blocks of ``q_more``
    instead, each reading other rows of the same lists, until the sets
    read ``L2_ROTATE_BYTES``; bound, bytes and flops are then the sets'
    mean."""
    nprobe, nb, g = model._search_plan()
    opts = model._scan_options()
    stored = opts["list_norms"] is not None

    def groups(qb: np.ndarray):
        q = torch.from_numpy(np.ascontiguousarray(qb[:nb])).cuda()
        for li in ivf._probe_groups(model.centroids, q, nprobe, g, model.metric):
            li = li.contiguous()
            yield (q, model.lists.data, model.lists.ids, li,
                   model.lists.sizes[li.long()].contiguous(), opts["list_norms"],
                   opts.get("vmin"), opts.get("span"))

    args = next(groups(q_block))
    q, li, sizes_g = args[0], args[3], args[4]
    kw = dict(metric=model.metric, codec=model.codec, scan_bf16=opts["scan_bf16"])
    got = flat_scan.flat_list_scan(*args, **kw)
    want = flat_scan.flat_list_scan_plain(*args, **kw)
    err = compare_scores(got, want, 1e-4, 1e-4, f"K1 {what}-path shape")
    bound_ms, bound_by, nbytes, flops = k1_bound(q, model.lists.data, li, model.lists.sizes,
                                                 stored)
    if q_more is None:
        sets = l2_copies(args, nbytes)
    else:
        sets, bounds = [], []
        for a in (a for s in range(0, q_more.shape[0] - nb + 1, nb)
                  for a in groups(q_more[s:s + nb])):
            sets.append(a)
            bounds.append(k1_bound(a[0], model.lists.data, a[3], model.lists.sizes, stored))
            if sum(b[2] for b in bounds) >= L2_ROTATE_BYTES:
                break
        bound_ms, nbytes, flops = (float(np.mean([b[i] for b in bounds])) for i in (0, 2, 3))
        bound_by = max(("bytes", "operations"), key=[b[1] for b in bounds].count)
    kernel = functools.partial(flat_scan.flat_list_scan, **kw)
    ms = time_ms(kernel, sets, iters=50)
    warm_ms = time_ms(kernel, [args], iters=50)
    call_ms = time_ms(kernel, [args], iters=50, queued=False)
    plain_ms = time_ms(functools.partial(flat_scan.flat_list_scan_plain, **kw), sets,
                       iters=10)
    n_sets = len(sets)
    del sets
    cap = model.lists.cap
    log(f"K1 {what}-path shape: nq={q.shape[0]} g={g} cap={cap} d={model.dim} "
        f"codec={model.codec} live rows={int(sizes_g.sum())}, {n_sets} input sets: kernel "
        f"{ms:.4f} ms (L2-warm back to back {warm_ms:.4f} ms; {call_ms:.4f} ms a call when "
        f"the host issues them), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes:.0f} bytes, {flops:.0f} flops), "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, max_abs_err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def adc_main_shape(adc, ivf, model, q_block: np.ndarray, what: str) -> dict:
    """The ADC kernel the model dispatches to, and the plain version, on
    the path's own inputs: the first probe group of one query block, its
    LUT and gathered code rows built by the model's own helpers."""
    nprobe, nb, g = model._search_plan()
    q = torch.from_numpy(np.ascontiguousarray(q_block[:nb])).cuda()
    li = ivf._probe_groups(model.centroids, q, nprobe, g, model.metric)[0].contiguous()
    lut, codes = ivf._pq_group_inputs(model.centroids, model.codebooks, model.lists.data, q,
                                      li, model.metric, model.lut_bf16)
    P, m, ksub = lut.shape
    nibble = adc.nibble_supported(m, ksub)
    fn = adc.adc_scan_nibble if nibble else adc.adc_scan
    kid = "K3" if nibble else "K2"
    got = fn(lut, codes)
    want = adc.adc_scan_plain(lut, codes)
    err = compare_scores(got, want, 1e-4, 1e-4, f"{kid} {what}-path shape")
    bound_ms, bound_by, nbytes, ops = adc_bound(lut, codes)
    sets = l2_copies((lut, codes), nbytes)
    ms = time_ms(fn, sets, iters=50)
    warm_ms = time_ms(fn, [(lut, codes)], iters=50)
    call_ms = time_ms(fn, [(lut, codes)], iters=50, queued=False)
    plain_ms = time_ms(adc.adc_scan_plain, sets, iters=10)
    del sets
    # the yardstick: one PyTorch call computing the same sums, the (P * L)
    # bags of m lookups into one flattened fp32 table of every pair's LUT
    # (per-pair offsets in the index); the index and table are built, and
    # timed, apart from the call; used nowhere in the port
    L = codes.shape[1]
    bag = functools.partial(torch.nn.functional.embedding_bag, mode="sum")

    def build_bags(lut, codes):
        offs = (torch.arange(P, device=codes.device) * (m * ksub))[:, None, None] \
            + torch.arange(m, device=codes.device) * ksub
        return ((codes.long() + offs).reshape(P * L, m),
                lut.float().reshape(P * m * ksub, 1).contiguous())

    index_ms = time_ms(build_bags, [(lut, codes)], iters=10, queued=False)
    index, table = build_bags(lut, codes)
    lib_err = compare_scores(bag(index, table).reshape(P, L), want, 1e-4, 1e-4,
                             f"{kid} embedding_bag")
    lib_bytes = index.numel() * 8 + table.numel() * 4 + P * L * 4
    lib_sets = l2_copies((index, table), lib_bytes)
    library_ms = time_ms(bag, lib_sets)
    del lib_sets, index, table
    log(f"{kid} {what}-path shape: P={P} (nq={q.shape[0]} g={g}) L={L} m={m} "
        f"lut={'bf16' if model.lut_bf16 else 'f32'} "
        f"live rows={int(model.lists.sizes[li.long()].sum())}: kernel {ms:.4f} ms "
        f"(L2-warm back to back {warm_ms:.4f} ms; {call_ms:.4f} ms a call when the host "
        f"issues them), plain {plain_ms:.4f} ms, embedding_bag {library_ms:.4f} ms (its "
        f"index and table built in {index_ms:.4f} ms apart; max_abs_err {lib_err:.3g}), "
        f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {ops} adds), "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, max_abs_err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _old_group_step(adc, lut, list_codes, li, sizes_g, list_ids):
    """The knnlm path's probe group step before K3 read the lists itself:
    the probed lists' code rows gathered, K3 over the gathered copy, the
    mask."""
    nq, g = li.shape
    _, cap, m = list_codes.shape
    codes = list_codes[li.long()].reshape(nq * g, cap, m)
    s = adc.adc_scan_nibble(lut, codes).reshape(nq, g, cap)
    return adc.mask_lists(s, li, sizes_g, list_ids)


def lists_main_shape(adc, ivf, model, q_block: np.ndarray) -> dict:
    """K3 over the probed lists, its plain version and the group step it
    replaced, on the knnlm path's own inputs: the first probe group of one
    query block and its LUT, built by the model's own helpers, and the
    index's lists."""
    nprobe, nb, g = model._search_plan()
    q = torch.from_numpy(np.ascontiguousarray(q_block[:nb])).cuda()
    li = ivf._probe_groups(model.centroids, q, nprobe, g, model.metric)[0].contiguous()
    lut = ivf._pq_group_lut(model.centroids, model.codebooks, q, li, model.metric,
                            model.lut_bf16)
    sizes_g = model.lists.sizes[li.long()].contiguous()
    args = (lut, model.lists.data, li, sizes_g, model.lists.ids)
    got = adc.adc_scan_lists(*args)
    want = adc.adc_scan_lists_plain(*args)
    err = compare_scores(got, want, 1e-4, 1e-4, "K3 lists knnlm-path shape")
    old = functools.partial(_old_group_step, adc)
    compare_scores(old(*args), want, 1e-4, 1e-4, "the old group step")
    bound_ms, bound_by, nbytes, ops = lists_bound(lut, model.lists.data, li, model.lists.sizes)
    sets = l2_copies(args, nbytes)
    ms = time_ms(adc.adc_scan_lists, sets, iters=50)
    old_ms = time_ms(old, sets, iters=50)
    warm_ms = time_ms(adc.adc_scan_lists, [args], iters=50)
    call_ms = time_ms(adc.adc_scan_lists, [args], iters=50, queued=False)
    plain_ms = time_ms(adc.adc_scan_lists_plain, sets, iters=10)
    del sets
    P, m, _ = lut.shape
    log(f"K3 lists knnlm-path shape: P={P} (nq={q.shape[0]} g={g}) cap={model.lists.cap} "
        f"m={m} lut={'bf16' if model.lut_bf16 else 'f32'} live rows={int(sizes_g.sum())}: "
        f"kernel {ms:.4f} ms against the old group step (gather + K3 + mask) {old_ms:.4f} ms "
        f"({old_ms / ms:.2f}x) (L2-warm back to back {warm_ms:.4f} ms; {call_ms:.4f} ms a "
        f"call when the host issues them), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} bytes, of which LUT {lut.numel() * lut.element_size()}; "
        f"{ops} adds), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, max_abs_err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def shared_main_shape(adc, ivf, model, q_block: np.ndarray) -> dict:
    """K4, its plain version and the library yardstick on the flat-PQ
    path's own inputs: one query block's LUT and the first chunk of the
    list, built by the model's own helpers."""
    _, nb, _ = model._search_plan()
    q = torch.from_numpy(np.ascontiguousarray(q_block[:nb])).cuda()
    lut, codes = ivf._pq_shared_inputs(model.centroids, model.codebooks, model.lists.data,
                                       int(model.lists.sizes_host[0]), q, model.metric,
                                       model.lut_bf16)
    codes = codes[:ivf.shared_chunk_rows(nb)]
    got = adc.adc_scan_shared(lut, codes)
    want = adc.adc_scan_shared_plain(lut, codes)
    err = compare_scores(got, want, 0.0, 0.0, "K4 flat-PQ-path shape")
    bound_ms, bound_by, nbytes, ops = shared_bound(lut, codes)
    sets = l2_copies((lut, codes), nbytes)
    ms = time_ms(adc.adc_scan_shared, sets)
    warm_ms = time_ms(adc.adc_scan_shared, [(lut, codes)])
    plain_ms = time_ms(adc.adc_scan_shared_plain, sets, warmup=1, iters=5)
    del sets
    # the yardstick: one PyTorch call computing the same sums, (L, nq),
    # its index and table built beforehand, in f32; used nowhere in the port
    nq, m, ksub = lut.shape
    index = codes.long() + torch.arange(m, device=codes.device) * ksub
    table = lut.float().reshape(nq, m * ksub).T.contiguous()
    bag = functools.partial(torch.nn.functional.embedding_bag, mode="sum")
    lib_err = compare_scores(bag(index, table).T, want, 1e-4, 1e-4, "embedding_bag")
    lib_bytes = index.numel() * 8 + table.numel() * 4 + nq * codes.shape[0] * 4
    lib_sets = l2_copies((index, table), lib_bytes)
    library_ms = time_ms(bag, lib_sets)
    del lib_sets, index, table
    log(f"K4 flat-PQ-path shape: nq={nq} L={codes.shape[0]} m={m} "
        f"lut={'bf16' if model.lut_bf16 else 'f32'}: kernel {ms:.4f} ms (L2-warm back to "
        f"back {warm_ms:.4f} ms), plain {plain_ms:.4f} ms, embedding_bag {library_ms:.4f} ms "
        f"(max_abs_err {lib_err:.3g}), bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, "
        f"{ops} adds), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
        f"{ops / (ms * 1e-3) / 1e9:.1f} G lookups/s, max_abs_err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# ---------------------------------------------------------------- phase e


def served_ids(meta) -> set:
    return {m[0] for row in meta for m in row if m is not None}


def refused_while_draining(e: Exception) -> bool:
    """The single rank's refusal of a search while its add buffer drains
    (state ADD), which the caller retries; anything else, a stale-read
    refusal included, is a failure."""
    return "not trained. state: IndexState.ADD" in str(e)


def same_sets(meta_a, d_a, meta_b, d_b, what: str) -> None:
    """Per query the same ids, and distances within 1e-3."""
    for i, (ra, rb) in enumerate(zip(meta_a, meta_b)):
        if set(ra) != set(rb):
            raise AssertionError(f"{what}: query {i}'s ids differ: {ra} vs {rb}")
    np.testing.assert_allclose(np.sort(d_a, axis=1), np.sort(d_b, axis=1), rtol=1e-3,
                               atol=1e-3, err_msg=what)


def survivors_ground_truth(x: np.ndarray, q: np.ndarray, dead: np.ndarray, what: str):
    """The exact top-10 over the rows not in ``dead`` from the port's
    FlatIndex on the card, twice: over every row with ``dead`` removed
    through ``remove_rows`` (the flat live mask), and over the survivors
    alone. Both must give the same ids."""
    from distributed_faiss_tpu_torch.models.flat import FlatIndex

    t0 = time.perf_counter()
    masked = FlatIndex(x.shape[1], "l2", device="cuda")
    masked.add(x)
    masked.remove_rows(dead)
    d_m, i_m = masked.search(q, 10)
    del masked
    keep = np.ones(x.shape[0], bool)
    keep[dead] = False
    survivors = np.flatnonzero(keep)
    alone = FlatIndex(x.shape[1], "l2", device="cuda")
    alone.add(x[survivors])
    d_s, i_s = alone.search(q, 10)
    del alone
    torch.cuda.empty_cache()
    if not np.array_equal(i_m, survivors[i_s]) or not np.isfinite(d_m).all():
        raise AssertionError(f"{what}: the masked FlatIndex and the one over the survivors "
                             "disagree")
    np.testing.assert_allclose(d_m, d_s, rtol=1e-5, atol=1e-5, err_msg=what)
    log(f"{what}: exact top-10 over {survivors.size} survivors, masked and rebuilt "
        f"FlatIndex agree ({time.perf_counter() - t0:.2f} s)")
    return i_m


def mutation_phase(args, sq: dict, pq: dict, counters, card: str) -> dict:
    """Phase e: deletes, upserts, pinned reads and compaction on the ivfsq
    index of phase 3 (K1), the knnlm index of phase 4 (K3 over the lists)
    and the flat PQ64,RFlat index of phase 6 (K4), through the client."""
    out = {}
    # ---- ivfsq (K1) ----
    what = "mutation ivfsq"
    s, iid, nprobe, q_all, x = sq["serving"], sq["iid"], sq["nprobe"], sq["q_all"], sq["x"]
    client, q_eval, n = s.client, sq["q_all"][:1000], sq["x"].shape[0]
    zero_counts(counters)
    client.save_index(iid)
    pins = client.pin_generations(iid)
    d0, meta0 = client.search(q_eval, 10, iid)
    # the same serving run right before the deletes: the reading after
    # them compares with this one, not with phase 3's, run many phases
    # earlier on the same server
    qps0, p50_0, p99_0, _ = timed_serve(client, q_all, iid, f"{what} (before the deletes)",
                                        card)
    dead = np.arange(0, n, 10)
    t0 = time.perf_counter()
    removed = client.remove_ids(iid, dead.tolist())
    remove_s = time.perf_counter() - t0
    if removed != dead.size:
        raise AssertionError(f"{what}: remove_ids tombstoned {removed} rows, not {dead.size}")
    d1, meta1 = client.search(q_eval, 10, iid)
    check_result(d1, meta1, 1000, 10, f"{what} search")
    dead_set = set(dead.tolist())
    if served_ids(meta1) & dead_set:
        raise AssertionError(f"{what}: a deleted id served")
    live_n = len(client.get_ids(iid))
    if live_n != n - dead.size:
        raise AssertionError(f"{what}: get_ids counts {live_n}, not {n - dead.size}")
    gt = survivors_ground_truth(x, q_eval, dead, what)
    rec = recall_at_10(meta1, gt)
    sidecar_mb = os.path.getsize(os.path.join(s.store, iid, "0", "tombstones.json")) / 1e6
    log(f"{what}: remove_ids of {dead.size} ids in {remove_s:.3f} s on {card} (the sidecar it "
        f"rewrote: {sidecar_mb:.1f} MB); get_ids counts {live_n}; recall@10 {rec:.4f} over "
        f"the survivors at nprobe={nprobe}")
    if rec < 0.95:
        raise AssertionError(f"{what}: recall@10 {rec:.4f} < 0.95 over the survivors")
    qps, p50, p99, metas = timed_serve(client, q_all, iid, what, card)
    if any(served_ids(m) & dead_set for m in metas):
        raise AssertionError(f"{what}: a deleted id served under load")
    log(f"{what}: served after the deletes {qps:.1f} QPS, p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
        f"right before them {qps0:.1f} QPS, p50 {p50_0:.3f} ms, p99 {p99_0:.3f} ms; phase 3 "
        f"on the same call {sq['qps']:.1f} QPS, p50 {sq['p50_ms']:.3f} ms, "
        f"p99 {sq['p99_ms']:.3f} ms, on {card}")

    # upsert 1000 deleted ids with each eval query's own vector: its top-1
    up_ids = dead[:1000].tolist()
    t0 = time.perf_counter()
    client.upsert(iid, up_ids, q_eval)
    ack_s = time.perf_counter() - t0
    drain_refusals, ryw_answered_s = 0, None
    while True:
        try:
            d_up, meta_up = client.search(q_eval, 10, iid, read_your_writes=True)
        except Exception as e:
            if not refused_while_draining(e):
                raise
            drain_refusals += 1
            meta_up = None
        else:
            ryw_answered_s = ryw_answered_s or time.perf_counter() - t0
        if meta_up is not None and all(row[0] == (i,) for row, i in zip(meta_up, up_ids)):
            break
        if time.perf_counter() - t0 > 120:
            raise AssertionError(f"{what}: the upserted rows did not become top-1")
        time.sleep(0.005)
    visible_s = time.perf_counter() - t0
    log(f"{what}: upsert of {len(up_ids)} deleted ids acknowledged in {ack_s:.3f} s; the "
        f"first read-your-writes search answered {ryw_answered_s:.3f} s after the call "
        f"({drain_refusals} refusals while the buffer drained, none stale); every "
        f"upserted row top-1 for its query {visible_s:.3f} s after the call, on {card}")

    d_pin, meta_pin = client.search_at_generation(q_eval, 10, iid, pins=pins)
    if meta_pin != meta0:
        raise AssertionError(f"{what}: the pinned generation did not serve phase 3's ids")
    np.testing.assert_allclose(d_pin, d0, rtol=1e-3, atol=1e-3, err_msg=f"{what} pinned")
    log(f"{what}: search_at_generation({pins}) served phase 3's ids for the eval queries")

    d_pre, meta_pre = client.search(q_eval, 10, iid)
    t0 = time.perf_counter()
    if client.compact_index(iid) != [True]:
        raise AssertionError(f"{what}: compact_index committed nothing")
    compact_s = time.perf_counter() - t0
    gen = client.pin_generations(iid)
    d_post, meta_post = client.search(q_eval, 10, iid)
    same_sets(meta_pre, d_pre, meta_post, d_post, f"{what} across the compaction")
    mstats = client.get_perf_stats()[0]["mutation"][iid]
    log(f"{what}: compact_index in {compact_s:.3f} s into generation {gen}, "
        f"{mstats['tombstoned_rows']} tombstones left; same ids and distances before and "
        f"after, on {card}")

    t0 = time.perf_counter()
    client.save_index(iid)
    save_s = time.perf_counter() - t0
    client.drop_index(iid)
    t0 = time.perf_counter()
    if not client.load_index(iid):
        raise AssertionError(f"{what}: load_index failed")
    load_s = time.perf_counter() - t0
    client.set_nprobe(iid, nprobe)
    d_l, meta_l = client.search(q_eval, 10, iid)
    if served_ids(meta_l) & (dead_set - set(up_ids)):
        raise AssertionError(f"{what}: a deleted id served after save -> drop -> load")
    if not all(row[0] == (i,) for row, i in zip(meta_l, up_ids)):
        raise AssertionError(f"{what}: an upserted row lost its top-1 after the reload")
    counts = read_counts(counters)
    log(f"{what}: save ({save_s:.3f} s) -> drop -> load ({load_s:.3f} s) serves no deleted "
        f"id and every upserted row; launches over the phase {counts}")
    if counts["K1"] <= 0:
        raise AssertionError(f"{what}: K1 was not launched in this phase")
    out["ivfsq"] = dict(remove_s=remove_s, sidecar_mb=sidecar_mb, recall=rec, qps=qps,
                        p50_ms=p50, p99_ms=p99, qps_before=qps0,
                        upsert_ack_s=ack_s, visible_s=visible_s, compact_s=compact_s,
                        counts=counts)

    # ---- knnlm (K3 over the lists) and flat PQ64,RFlat (K4) ----
    s, x, q_eval = pq["serving"], pq["x"], pq["q_eval"]
    client, n = s.client, pq["x"].shape[0]
    dead = np.arange(0, n, 10)
    dead_set = set(dead.tolist())
    gt = survivors_ground_truth(x, q_eval, dead, "mutation knnlm corpus")
    for iid, what, kernel in (("knnlm", "mutation knnlm", "K3 lists"),
                              ("flatpq", "mutation PQ64,RFlat", "K4")):
        zero_counts(counters)
        t0 = time.perf_counter()
        removed = client.remove_ids(iid, dead.tolist())
        remove_s = time.perf_counter() - t0
        if removed != dead.size:
            raise AssertionError(f"{what}: remove_ids tombstoned {removed} rows")
        d1, meta1 = client.search(q_eval, 10, iid)
        check_result(d1, meta1, 1000, 10, f"{what} search")
        if served_ids(meta1) & dead_set:
            raise AssertionError(f"{what}: a deleted id served")
        rec = recall_at_10(meta1, gt)
        row = dict(remove_s=remove_s, recall=rec)
        log(f"{what}: remove_ids of {dead.size} ids in {remove_s:.3f} s; no deleted id in "
            f"the top-10 of 1000 queries; recall@10 {rec:.4f} over the survivors, on {card}")
        if iid == "knnlm":
            if rec < 0.95:
                raise AssertionError(f"{what}: recall@10 {rec:.4f} < 0.95 over the survivors")
            t0 = time.perf_counter()
            if client.compact_index(iid) != [True]:
                raise AssertionError(f"{what}: compact_index committed nothing")
            row["compact_s"] = time.perf_counter() - t0
            d2, meta2 = client.search(q_eval, 10, iid)
            same_sets(meta1, d1, meta2, d2, f"{what} across the compaction")
            log(f"{what}: compact_index in {row['compact_s']:.3f} s; same ids and distances "
                f"before and after, on {card}")
        row["counts"] = read_counts(counters)
        log(f"{what}: launches over the phase {row['counts']}")
        if row["counts"][kernel] <= 0:
            raise AssertionError(f"{what}: {kernel} was not launched in this phase")
        out[iid] = row
    return out


# ---------------------------------------------------------------- phase g

# traced serving: pairs of runs with DFT_TRACE_SAMPLE at 0 and 1 in this
# process, each of TRACE_QUERIES queries, at both nprobes
TRACE_PAIRS = 4
TRACE_QUERIES = 2000
TRACE_NPROBES = (1, 32)
SPAN_NAMES = ("client.search", "client.pack", "client.rpc", "server.queue", "server.device",
              "engine.launch", "server.write")
SERVER_STAGES = ("server.queue", "server.device", "server.write")
# the durations compared come from two monotonic clocks of one host
# (perf_counter, monotonic) read on several threads
CLOCK_SLACK_S = 1e-3
# the CUDA symbol of each traced path's scan kernel, for the profiler
KERNEL_SYMBOLS = {"K1": "flat_scan_kernel", "K3 lists": "adc_scan_lists_kernel"}


@contextlib.contextmanager
def env_set(name: str, value: str):
    """``os.environ[name] = value`` for the block, restored after."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


def trace_timeline(client, tid: str, timeout: float = 30.0) -> list:
    """The merged timeline of ``tid`` once the server's write span, which
    the server records after its send, has landed."""
    deadline = time.monotonic() + timeout
    while True:
        timeline = client.get_trace_spans(tid)
        if {"server.write", "client.search"} <= {s["name"] for s in timeline}:
            return timeline
        if time.monotonic() > deadline:
            raise AssertionError(f"trace {tid}: spans {sorted({s['name'] for s in timeline})}")
        time.sleep(0.01)


def request_split(timeline: list, what: str) -> dict:
    """One traced request's ms by stage: queue, device, launch, write, the
    rest of the wire (client.rpc less the three server stages) and the
    whole (client.search); raises when the stages do not nest."""
    by = {}
    for s in timeline:
        by.setdefault(s["name"], []).append(s)
    missing = [n for n in SPAN_NAMES if n not in by]
    if missing:
        raise AssertionError(f"{what}: the trace lacks {missing}")
    dur = {n: max(s["dur_s"] for s in by[n]) for n in SPAN_NAMES}
    stages = sum(dur[n] for n in SERVER_STAGES)
    if stages > dur["client.rpc"] + CLOCK_SLACK_S or \
            dur["client.rpc"] > dur["client.search"] + CLOCK_SLACK_S:
        raise AssertionError(f"{what}: queue + device + write {stages:.6f} s, client.rpc "
                             f"{dur['client.rpc']:.6f} s, client.search "
                             f"{dur['client.search']:.6f} s do not nest")
    return dict(queue_ms=dur["server.queue"] * 1e3, device_ms=dur["server.device"] * 1e3,
                launch_ms=dur["engine.launch"] * 1e3, write_ms=dur["server.write"] * 1e3,
                wire_ms=(dur["client.rpc"] - stages) * 1e3,
                search_ms=dur["client.search"] * 1e3,
                window=by["server.device"][0]["extra"]["window"],
                device_s=dur["server.device"])


def fmt_split(split: dict) -> str:
    return ", ".join(f"{k[:-3]} {split[k]:.3f} ms" for k in
                     ("queue_ms", "device_ms", "launch_ms", "write_ms", "wire_ms", "search_ms"))


def kernel_device_ms(prof, symbol: str) -> tuple:
    """(launches, summed device ms) of the profiled kernels named ``symbol``."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and symbol in e.name]
    return len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3


def traced_serving(path: dict, counters, card: str) -> dict:
    """Phase g part 1 on one path: at each nprobe, TRACE_PAIRS pairs of
    runs untraced and traced (the first side alternating) with identical
    ids; then one more traced run under torch.profiler, every request's
    timeline fetched: the seven spans, their nesting, the median split, and
    the distinct windows' server.device time against the scan kernel's
    device time in the same run. Finally the p99 exemplar of the server's
    e2e_s is fetched and checked the same way."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_faiss_tpu_torch.observability import spans as obs_spans

    what, client, iid, q, kernel = (path["what"], path["client"], path["iid"], path["q"],
                                    path["kernel"])
    out = {}
    for nprobe in TRACE_NPROBES:
        client.set_nprobe(iid, nprobe)
        with env_set("DFT_TRACE_SAMPLE", "0"):
            serve_queries(client, q[:1000], iid, 100, 8)  # warm at this nprobe
        zero_counts(counters)
        qps, ids = {"0": [], "1": []}, None
        for pair in range(TRACE_PAIRS):
            for rate in (("0", "1") if pair % 2 == 0 else ("1", "0")):
                with env_set("DFT_TRACE_SAMPLE", rate):
                    wall, _lat, results = serve_queries(client, q, iid, 100, 8)
                for D, meta in results:
                    check_result(D, meta, 100, 10, f"{what} traced={rate} search")
                metas = [m for _d, m in results]
                if ids is None:
                    ids = metas
                elif metas != ids:
                    raise AssertionError(f"{what} nprobe={nprobe}: ids of the traced and "
                                         "untraced runs differ")
                qps[rate].append(q.shape[0] / wall)
        t_lo = time.time()
        windows0 = client.get_perf_stats()[0]["scheduler"]["counters"]["batches"]
        with env_set("DFT_TRACE_SAMPLE", "1"), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall, _lat, results = serve_queries(client, q, iid, 100, 8)
            torch.cuda.synchronize()
        windows = client.get_perf_stats()[0]["scheduler"]["counters"]["batches"] - windows0
        if [m for _d, m in results] != ids:
            raise AssertionError(f"{what} nprobe={nprobe}: the profiled run's ids differ")
        counts = read_counts(counters)
        if counts[kernel] <= 0:
            raise AssertionError(f"{what}: {kernel} was not launched in the traced runs")
        tids = [s["trace_id"] for s in obs_spans.local_buffer().snapshot()
                if s["name"] == "client.search" and s["start_s"] >= t_lo]
        if len(tids) != len(results):
            raise AssertionError(f"{what}: {len(tids)} traced searches for {len(results)} "
                                 "requests")
        splits = [request_split(trace_timeline(client, t), f"{what} request") for t in tids]
        med = {k: float(np.median([s[k] for s in splits])) for k in splits[0]
               if k.endswith("_ms")}
        device_by_window = {s["window"]: s["device_s"] for s in splits}
        device_ms = sum(device_by_window.values()) * 1e3
        k_launches, k_ms = kernel_device_ms(prof, KERNEL_SYMBOLS[kernel])
        if k_launches == 0:
            raise AssertionError(f"{what}: the profiler recorded no {kernel} kernel")
        if device_ms < k_ms:
            raise AssertionError(f"{what}: server.device over {len(device_by_window)} windows "
                                 f"{device_ms:.3f} ms < the {kernel} device time {k_ms:.3f} ms")
        med_qps = {r: float(np.median(v)) for r, v in qps.items()}
        log(f"{what} traced serving, nprobe={nprobe}: {TRACE_PAIRS} pairs of "
            f"{q.shape[0]}-query runs, median QPS untraced {med_qps['0']:.1f}, traced "
            f"{med_qps['1']:.1f} (traced/untraced {med_qps['1'] / med_qps['0']:.4f}; all "
            f"QPS {qps}); identical ids; launches {counts}, on {card}")
        log(f"{what} request split, nprobe={nprobe} (median of {len(splits)} traced "
            f"100-row requests): {fmt_split(med)}; {len(device_by_window)} windows "
            f"({windows} counted by the scheduler): server.device {device_ms:.3f} ms >= "
            f"{kernel} device time {k_ms:.3f} ms in {k_launches} launches "
            f"({100 * k_ms / device_ms:.1f}%), on {card}")
        out[nprobe] = dict(qps=med_qps, split=med, device_ms=device_ms, kernel_ms=k_ms,
                           kernel_launches=k_launches, windows=len(device_by_window))
    raw = client.sub_indexes[0].generic_fun("get_perf_stats", (), {"raw": True})
    e2e = raw["scheduler"]["queues"]["e2e_s"]
    exemplar, which = e2e.get("p99_exemplar"), "p99_exemplar"
    if exemplar is None:
        # the tail of this server's whole life may predate every sampled
        # request: take the slowest bucket that holds one
        if not e2e["exemplars"]:
            raise AssertionError(f"{what}: e2e_s holds no exemplar")
        exemplar, which = e2e["exemplars"][max(e2e["exemplars"])], "slowest exemplar"
    timeline = trace_timeline(client, exemplar)
    split = request_split(timeline, f"{what} exemplar")
    log(f"{what}: {which} {exemplar} of e2e_s (p99 {e2e['p99_s'] * 1e3:.3f} ms): spans "
        f"{sorted({s['name'] for s in timeline})}; {fmt_split(split)}, on {card}")
    out["exemplar"] = exemplar
    return out


def metrics_and_dfstat(sq: dict, exemplar: str, counters) -> None:
    """Phase g part 2 on phase 3's server: /metrics and dfstat."""
    import io
    import urllib.request

    from distributed_faiss_tpu_torch.observability import dfstat

    s, iid, what = sq["serving"], sq["iid"], "metrics"
    zero_counts(counters)
    check_requests(s.client, iid, sq["q_all"], what)
    port = s.client.get_perf_stats()[0]["tracing"]["metrics_port"]
    count = s.client.get_perf_stats()[0]["engine"][iid]["device_search_s"]["count"]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
        status, body = resp.status, resp.read().decode()
    line = f'dft_engine_{iid}_device_search_s_count{{rank="0"}} {count}'
    buckets = sum('_bucket{le="' in ln for ln in body.splitlines())
    log(f"{what}: GET /metrics on :{port} answered {status}, {len(body)} bytes, "
        f"{buckets} _bucket series; engine device_search_s count {count} in both")
    if status != 200 or not buckets or line not in body.splitlines():
        raise AssertionError(f"{what}: /metrics lacks '{line}' or its buckets")
    for argv, needed in ((["--discovery", s.disc, "--count", "1"], ("srch/s",)),
                         (["--discovery", s.disc, "--trace", exemplar],
                          SERVER_STAGES + ("engine.launch",))):
        buf = io.StringIO()
        rc = dfstat.main(argv, out=buf)
        text = buf.getvalue()
        for ln in text.splitlines():
            log(f"dfstat {argv[2:]}: {ln}")
        if rc != 0 or not all(n in text for n in needed):
            raise AssertionError(f"dfstat {argv[2:]} exited {rc} or lacks {needed}")
    if read_counts(counters)["K1"] <= 0:
        raise AssertionError(f"{what}: K1 was not launched in this part")


def loops_and_dialects(sq: dict, counters, card: str) -> dict:
    """Phase g part 3: a second server running the selector loop over phase
    3's storage, and the four arms {threaded, selector} x {mux, serial},
    each ``--nq`` queries from 8 threads: identical ids, K1 on both."""
    from distributed_faiss_tpu_torch.parallel.client import IndexClient
    from distributed_faiss_tpu_torch.parallel.server import IndexServer

    s, iid, q_all, nprobe = sq["serving"], sq["iid"], sq["q_all"], sq["nprobe"]
    selector = IndexServer(0, s.store, device="cuda")
    port = selector.bind(0)
    thread = threading.Thread(target=selector.start, name="smoke-selector", daemon=True)
    thread.start()
    disc = os.path.join(s.work, "discovery_selector.txt")
    with open(disc, "w") as f:
        f.write(f"1\nlocalhost,{port}\n")
    servers = {"threaded": s.server, "selector": selector}
    clients, out = {}, {}
    try:
        for loop, path in (("threaded", s.disc), ("selector", disc)):
            for dialect in ("mux", "serial"):
                with env_set("DFT_RPC_MUX", "1" if dialect == "mux" else "0"):
                    clients[(loop, dialect)] = IndexClient(path)
        t0 = time.perf_counter()
        if not clients[("selector", "mux")].load_index(iid):
            raise AssertionError("selector: load_index of phase 3's snapshot failed")
        log(f"selector: loaded phase 3's index on the selector-loop server in "
            f"{time.perf_counter() - t0:.2f} s")
        for c in clients.values():
            c.cfg = s.client.cfg
        s.client.set_nprobe(iid, nprobe)
        clients[("selector", "mux")].set_nprobe(iid, nprobe)
        ids = None
        for (loop, dialect), c in clients.items():
            what = f"{loop} loop, {dialect} client"
            if c.sub_indexes[0].rpc_stats()["mux"] != (dialect == "mux"):
                raise AssertionError(f"{what}: the stub is not {dialect}")
            serve_queries(c, q_all[:1000], iid, 100, 8)  # warm
            rpc0 = servers[loop].get_perf_stats()["rpc"]
            dev0 = servers[loop].indexes[iid].perf_stats()["device_search_s"]["count"]
            zero_counts(counters)
            qps, p50, p99, metas = timed_serve(c, q_all, iid, what, card)
            counts = read_counts(counters)
            rpc1 = servers[loop].get_perf_stats()["rpc"]
            dev1 = servers[loop].indexes[iid].perf_stats()["device_search_s"]["count"]
            served = rpc1[f"{'mux' if dialect == 'mux' else 'legacy'}_calls"] - \
                rpc0[f"{'mux' if dialect == 'mux' else 'legacy'}_calls"]
            if ids is None:
                ids = metas
            elif metas != ids:
                raise AssertionError(f"{what}: ids differ from the first arm's")
            if counts["K1"] <= 0 or dev1 <= dev0:
                raise AssertionError(f"{what}: K1 was not launched on this server")
            if served < q_all.shape[0] // 100:
                raise AssertionError(f"{what}: the server counted {served} calls of this "
                                     "dialect")
            log(f"{what}: {dev1 - dev0} engine launches, {served} {dialect} calls; "
                f"launches {counts}")
            out[f"{loop}/{dialect}"] = dict(qps=qps, p50_ms=p50, p99_ms=p99)
    finally:
        for c in clients.values():
            c.close()
        selector.stop()
        thread.join(timeout=30)
    log(f"loops x dialects: identical ids in all four arms; {out}, on {card}")
    return out


def link_faults(sq: dict, counters, card: str) -> dict:
    """Phase g part 4: a ChaosProxy in front of phase 3's server."""
    from distributed_faiss_tpu_torch.parallel import rpc
    from distributed_faiss_tpu_torch.parallel.client import IndexClient
    from distributed_faiss_tpu_torch.testing.chaos import ChaosProxy, Fault

    s, iid, q = sq["serving"], sq["iid"], sq["q_all"][:100]
    zero_counts(counters)
    _d, want, _e = s.client.sub_indexes[0].generic_fun("search", (iid, q, 10))
    out = {}
    with ChaosProxy("127.0.0.1", s.port) as proxy:
        proxy.set_fault(Fault("latency", delay=0.05, direction="up"))
        disc = os.path.join(s.work, "discovery_proxy.txt")
        with open(disc, "w") as f:
            f.write(f"1\nlocalhost,{proxy.port}\n")
        c = IndexClient(disc)
        try:
            c.cfg = s.client.cfg
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                _d, meta = c.search(q, 10, iid)
                times.append(time.perf_counter() - t0)
                if meta != want:
                    raise AssertionError("latency: ids differ through the proxy")
            rt = c.sub_indexes[0].rpc_stats()["round_trip_s"]
        finally:
            c.close()
    if min(times) < 0.05:
        raise AssertionError(f"latency: a search took {min(times):.4f} s < the 0.05 s injected")
    out["latency_s"] = times
    log(f"link latency 0.05 s: 5 searches through the proxy, same ids, "
        f"{min(times):.4f}-{max(times):.4f} s each; stub round trips p50 "
        f"{rt.get('p50_s', 0) * 1e3:.3f} ms")

    with ChaosProxy("127.0.0.1", s.port, plan=[None, Fault("reset")]) as proxy:
        stub = rpc.Client(0, "localhost", proxy.port)
        try:
            stub.sock.shutdown(socket.SHUT_RDWR)  # the live connection dies
            policy = rpc.RetryPolicy(max_attempts=4, base_delay=0.05, jitter=0.0)
            meta = policy.run(stub.generic_fun, "search", (iid, q, 10))[1]
            seen = proxy.connections_seen()
        finally:
            stub.close()
    if meta != want or seen < 3:
        raise AssertionError(f"reset: ids differ or the retry did not redial ({seen})")
    log(f"link reset: the retry redialed through the RST ({seen} connections) to the same "
        "ids")

    faults = {"garble": Fault("garble", after_bytes=2, nbytes=6, direction="up"),
              "cut": Fault("cut", after_bytes=7, direction="up"),
              "garble-down": Fault("garble", after_bytes=0, nbytes=4, direction="down")}
    for name, fault in faults.items():
        with ChaosProxy("127.0.0.1", s.port, plan=[fault]) as proxy:
            stub = rpc.Client(0, "localhost", proxy.port)
            try:
                try:
                    first = stub.generic_fun("search", (iid, q, 10), timeout=30.0)[1]
                    outcome = "answered"
                except rpc.TRANSPORT_ERRORS as e:
                    first, outcome = None, type(e).__name__
                meta = stub.generic_fun("search", (iid, q, 10), timeout=30.0)[1]
            finally:
                stub.close()
        if meta != want or first not in (None, want):
            raise AssertionError(f"{name}: the next connection served other ids")
        _d, direct, _e = s.client.sub_indexes[0].generic_fun("search", (iid, q, 10))
        if direct != want:
            raise AssertionError(f"{name}: the server serves other ids after the fault")
        out[name] = outcome
        log(f"link {name}: first call {outcome}; the next connection served the same ids")

    with ChaosProxy("127.0.0.1", s.port, plan=[Fault("blackhole")]) as proxy:
        stub = rpc.Client(0, "localhost", proxy.port)
        t0 = time.perf_counter()
        try:
            stub.generic_fun("search", (iid, q, 10), deadline=time.time() + 1.0)
        except (rpc.DeadlineExceeded,) + rpc.TRANSPORT_ERRORS as e:
            took, err = time.perf_counter() - t0, type(e).__name__
        else:
            raise AssertionError("blackhole: the call answered")
        finally:
            stub.close()
    bound = 1.0 + rpc.Client.DEADLINE_GRACE
    if took > bound + 0.25:
        raise AssertionError(f"blackhole: {err} after {took:.3f} s > {bound} s")
    out["blackhole_s"] = took
    counts = read_counts(counters)
    log(f"link blackhole under a 1.0 s deadline: {err} after {took:.3f} s (bound "
        f"{bound} s + 0.25 s); launches over the link faults {counts}, on {card}")
    if counts["K1"] <= 0:
        raise AssertionError("link faults: K1 was not launched in this part")
    return out


def observability_phase(args, sq: dict, pq: dict, counters, card: str) -> dict:
    """Phase g, on the servers of phases 3 and 4 after phase e."""
    out = {}
    for path in (dict(what="ivfsq", client=sq["serving"].client, iid=sq["iid"],
                      q=sq["q_all"][:TRACE_QUERIES], kernel="K1"),
                 dict(what="knnlm", client=pq["serving"].client, iid="knnlm",
                      q=pq["q_all"][:TRACE_QUERIES], kernel="K3 lists")):
        t0 = time.perf_counter()
        out[path["what"]] = traced_serving(path, counters, card)
        log(f"phase g traced serving on {path['what']}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    metrics_and_dfstat(sq, out["ivfsq"]["exemplar"], counters)
    out["loops"] = loops_and_dialects(sq, counters, card)
    out["faults"] = link_faults(sq, counters, card)
    log(f"phase g metrics, loops and link faults: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------- phase f

# the replicated cluster: 2 groups x 2 replicas, each rank its own process on
# the card; batches of REPLICA_BATCH rows alternate between the groups
REPLICA_RANKS = 4
REPLICA_BATCH = 10_000
# rows of phase 3's corpus the replicas hold (its first rows): a depth cut
# that makes room for phase k in the script's time limit
REPLICA_N = 250_000
# group 0's divergence while one replica is down: below the sweeper's
# delta bound (DFT_ANTIENTROPY_DELTA_MAX, 1024 missing rows), so it heals by
# delta; group 1's (FULL_ROWS new rows) above it, after an empty restart
DELTA_ROWS, DELTA_DELETES, DELTA_UPSERTS = 1000, 1000, 20
FULL_ROWS = 20_000
# the time the sweepers (DFT_ANTIENTROPY_INTERVAL=1) get to make a healed
# replica's digests equal its survivor's
CONVERGE_LIMIT_S = 180.0


def free_base(n: int) -> int:
    """A base port below the ephemeral range whose next ``n`` ports bind now."""
    rng = np.random.default_rng()
    while True:
        base = int(rng.integers(20000, 29000))
        try:
            for p in range(base, base + n):
                socket.create_server(("", p)).close()
            return base
        except OSError:
            continue


def rank_call(client, pos_of, rank: int, fname: str, *args, timeout: float = 120.0):
    return client.sub_indexes[pos_of[rank]].generic_fun(fname, args, timeout=timeout)


def wait_answers(client, pos_of, rank: int, timeout: float = 300.0) -> None:
    """Until the rank's stub answers (its redial cooldown after the failed
    dials of the outage is over)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            rank_call(client, pos_of, rank, "get_rank", timeout=5.0)
            return
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def wait_converged(h, a: int, b: int, iid: str, what: str) -> float:
    """Poll both ranks' digests (digest_exchange) until live_hash,
    live_vhash and dead_hash are equal; the seconds it took."""
    from distributed_faiss_tpu_torch.parallel import rpc

    keys = ("live_n", "live_hash", "live_vhash", "dead_hash")
    t0 = time.perf_counter()
    while True:
        try:
            da, db = (rpc.digest_exchange("localhost", h.port(r), {"want": [iid]},
                                          timeout=30.0)["digests"].get(iid)
                      for r in (a, b))
        except rpc.TRANSPORT_ERRORS:
            da = db = None
        if da and db and all(da[k] == db[k] for k in keys):
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > CONVERGE_LIMIT_S:
            raise AssertionError(f"{what}: digests of ranks {a} and {b} not equal within "
                                 f"{CONVERGE_LIMIT_S:.0f} s: {da} vs {db}")
        time.sleep(0.2)


def rank_ids(client, pos_of, rank: int, iid: str, q: np.ndarray) -> list:
    """One rank's own top-10 ids for ``q`` (its group's rows only)."""
    _d, meta, _e = rank_call(client, pos_of, rank, "search", iid, q, 10, False)
    return [[m[0] for m in row if m is not None] for row in meta]


def sweeper_cost(client, pos_of, ranks) -> dict:
    """Per rank: the digest requests it answered (count, seconds on its host
    clock), its own sweeps, and the seconds its add_index_data calls took."""
    out = {}
    for r in ranks:
        st = rank_call(client, pos_of, r, "get_perf_stats")
        dg, add = st.get("digest_exchange", {}), st.get("add_index_data", {})
        out[r] = {"digests": dg.get("count", 0), "digest_s": round(dg.get("total_s", 0.0), 3),
                  "sweeps": st["antientropy"].get("sweeps", 0),
                  "add_s": round(add.get("total_s", 0.0), 3)}
    return out


def same_share(ids_a: list, ids_b: list) -> float:
    return sum(set(a) == set(b) for a, b in zip(ids_a, ids_b)) / max(1, len(ids_a))


# f.3: the victim's widened rebuild window (DFT_COMPACT_TEST_DELAY_S), the
# share of group 0's live ids deleted before it, and the storm: one thread a
# query block of its own, so a result crossed between callers shows
F3_DELAY_S = 4.0
F3_DELETE_SHARE = 0.3
F3_STORM_THREADS = 8
F3_STORM_ROWS = 50


def top10_ids(meta) -> list:
    return [[m[0] if m is not None else -1 for m in row[:10]] for row in meta]


def storm_matches(D: np.ndarray, meta, goldens: list) -> bool:
    """A top-11 answer of one query block agrees with one of ``goldens``
    ((D, meta) answers of the same block): on every row tie-free in that
    golden, the same top-10 ids and distances within 1e-3."""
    got = top10_ids(meta)
    for Dg, Mg in goldens:
        want = top10_ids(Mg)
        rows = np.flatnonzero(tie_free_rows(Dg))
        if all(got[i] == want[i] for i in rows) and np.allclose(
                D[rows, :10], Dg[rows, :10], rtol=1e-3, atol=1e-3):
            return True
    return False


def rank_top11(client, pos_of, rank: int, iid: str, q: np.ndarray):
    """One rank's own top-11 (distances, metadata) for ``q``."""
    D, meta, _e = rank_call(client, pos_of, rank, "search", iid, q, 11, False)
    return np.asarray(D), meta


def compaction_kill_arm(h, client, pos_of, groups, iid: str, q_all: np.ndarray, store: str,
                        rng) -> dict:
    """f.3: SIGKILL of a group-0 rank inside its compaction's rebuild under a
    storm, its restart on the pre-compaction generation, then compaction on
    both replicas (see the module docstring)."""
    from distributed_faiss_tpu_torch.testing.chaos import QueryStorm
    from distributed_faiss_tpu_torch.utils import serialization

    what = "replicas f.3"
    victim, twin = groups[0]
    steps = {}
    t_arm = t = time.perf_counter()
    client.save_index(iid)
    live0 = sorted(rank_call(client, pos_of, twin, "get_ids", iid))
    doomed = sorted(int(i) for i in rng.choice(live0, int(F3_DELETE_SHARE * len(live0)),
                                               replace=False))
    dead = set(doomed)
    removed = client.remove_ids(iid, doomed)
    if removed != len(doomed):
        raise AssertionError(f"{what}: remove_ids removed {removed} of {len(doomed)}")
    steps["save_and_delete"] = time.perf_counter() - t

    # restart the victim with its storage, the rebuild window widened
    t = time.perf_counter()
    h.kill(victim)
    env0 = {"DFT_SHARD_GROUP": "0", "DFT_COMPACT": "0"}
    h.restart(victim, load_index=True,
              extra_env=dict(env0, DFT_COMPACT_TEST_DELAY_S=str(F3_DELAY_S)))
    h.wait_port(victim, timeout=300)
    wait_answers(client, pos_of, victim)
    mu0 = rank_call(client, pos_of, victim, "get_perf_stats")["mutation"][iid]
    if mu0["tombstoned_rows"] < len(doomed):
        raise AssertionError(f"{what}: rank {victim} restarted without its tombstones: {mu0}")
    steps["restart_with_delay"] = time.perf_counter() - t
    victim_dir = os.path.join(store, iid, str(victim))
    gen_pre = serialization.list_generations(victim_dir)[0][0]
    q_eval = q_all[:1000]
    pre = {r: rank_top11(client, pos_of, r, iid, q_eval) for r in (victim, twin)}
    if any(served_ids(m) & dead for _d, m in pre.values()):
        raise AssertionError(f"{what}: a deleted id served before the compaction")
    blocks = [q_all[1000 + i * F3_STORM_ROWS:1000 + (i + 1) * F3_STORM_ROWS]
              for i in range(F3_STORM_THREADS)]
    goldens = {}
    for r in (twin, victim):  # left pinned on the victim
        with client._lock:
            client._preferred[0] = pos_of[r]
        goldens[r] = [client.search(b, 11, iid) for b in blocks]

    # ---- the storm, compact_index on the victim, SIGKILL inside the rebuild
    t = time.perf_counter()
    storms = [QueryStorm(client, iid, b, 11, threads=1).start() for b in blocks]
    time.sleep(1.0)
    called = {}

    def trigger():
        try:
            called["result"] = rank_call(client, pos_of, victim, "compact_index", iid,
                                         timeout=60.0)
        except Exception as e:  # the kill lands mid-call
            called["error"] = e

    caller = threading.Thread(target=trigger, name="smoke-compact", daemon=True)
    t_call = time.perf_counter()
    caller.start()
    time.sleep(F3_DELAY_S / 2)
    h.kill(victim)
    kill_after = time.perf_counter() - t_call
    time.sleep(2.0)  # the storm runs on against the outage
    outcomes = [st.stop() for st in storms]
    caller.join(timeout=60)
    steps["storm_and_kill"] = time.perf_counter() - t
    if "result" in called:
        raise AssertionError(f"{what}: compact_index returned {called['result']} before the "
                             "kill")
    errors = [e for _r, errs in outcomes for e in errs]
    if errors:
        raise AssertionError(f"{what}: {len(errors)} storm requests failed, first "
                             f"{errors[0]!r}")
    n_req = 0
    for i, (results, _e) in enumerate(outcomes):
        for D, meta in results:
            check_result(D, meta, F3_STORM_ROWS, 11, f"{what} storm search")
            if served_ids(meta) & dead:
                raise AssertionError(f"{what}: the storm served a deleted id")
            if not storm_matches(D, meta, [goldens[victim][i], goldens[twin][i]]):
                raise AssertionError(f"{what}: a storm result of block {i} is neither "
                                     "replica's pre-kill answer for it")
        n_req += len(results)
        if not results:
            raise AssertionError(f"{what}: storm thread {i} got no answer")
    gen_post = serialization.list_generations(victim_dir)[0][0]
    if gen_post != gen_pre:
        raise AssertionError(f"{what}: the killed compaction committed generation {gen_post} "
                             f"(pre-compaction {gen_pre})")
    log(f"{what}: {len(doomed)} of group 0's {len(live0)} live ids deleted; rank {victim} "
        f"restarted with DFT_COMPACT_TEST_DELAY_S={F3_DELAY_S:g}, compact_index sent and "
        f"the rank SIGKILLed {kill_after:.2f} s later inside the rebuild ({called['error']!r}); "
        f"{n_req} storm requests from {F3_STORM_THREADS} threads answered, 0 failed, no "
        f"deleted id, each its own block's pre-kill answer; newest generation still "
        f"{gen_pre}")

    # ---- restart from storage: the pre-compaction generation and tombstones
    t = time.perf_counter()
    h.restart(victim, load_index=True, extra_env=env0)
    h.wait_port(victim, timeout=300)
    wait_answers(client, pos_of, victim)
    k1_before = rank_call(client, pos_of, victim, "ping")["kernels"]["flat_list_scan"]
    D_v, M_v = rank_top11(client, pos_of, victim, iid, q_eval)
    steps["restart_to_serving"] = time.perf_counter() - t
    mu1 = rank_call(client, pos_of, victim, "get_perf_stats")["mutation"][iid]
    if mu1["compactions"] != 0 or mu1["live_fraction"] != mu0["live_fraction"]:
        raise AssertionError(f"{what}: rank {victim} did not restart pre-compaction: {mu1} "
                             f"(before the kill {mu0})")
    if served_ids(M_v) & dead:
        raise AssertionError(f"{what}: the restarted rank served a deleted id")
    same_top10(D_v, M_v, *pre[victim], f"{what} restarted rank {victim} vs its pre-kill answers")
    twin_share = same_share(top10_ids(M_v), top10_ids(pre[twin][1]))
    pre_share = same_share(top10_ids(pre[victim][1]), top10_ids(pre[twin][1]))
    if twin_share < pre_share:
        raise AssertionError(f"{what}: restarted rank {victim} agrees with its twin on "
                             f"{twin_share:.3f} of the queries, {pre_share:.3f} before the kill")
    k1_after = rank_call(client, pos_of, victim, "ping")["kernels"]["flat_list_scan"]
    if k1_after <= k1_before:
        raise AssertionError(f"{what}: K1 launches did not rise on the restarted rank: "
                             f"{k1_before} -> {k1_after}")
    log(f"{what}: rank {victim} back on generation {gen_pre} with {mu1['tombstoned_rows']} "
        f"tombstones, compactions 0, live_fraction {mu1['live_fraction']:.4f} (before the "
        f"kill {mu0['live_fraction']:.4f}), serving {steps['restart_to_serving']:.2f} s after "
        f"its restart; share of queries with its twin's ids {twin_share:.3f} "
        f"({pre_share:.3f} before the kill); K1 launches {k1_before} -> {k1_after}")

    # ---- compaction on both replicas commits and serves the same ids
    t = time.perf_counter()
    done = {r: rank_call(client, pos_of, r, "compact_index", iid, timeout=600.0)
            for r in (victim, twin)}
    steps["compaction"] = time.perf_counter() - t
    for r in (victim, twin):
        mu = rank_call(client, pos_of, r, "get_perf_stats")["mutation"][iid]
        if mu["compactions"] < 1 or mu["tombstoned_rows"] != 0:
            raise AssertionError(f"{what}: rank {r} did not compact: {done[r]}, {mu}")
        D_c, M_c = rank_top11(client, pos_of, r, iid, q_eval)
        if served_ids(M_c) & dead:
            raise AssertionError(f"{what}: rank {r} served a deleted id after compacting")
        same_top10(D_c, M_c, *pre[r], f"{what} rank {r} compacted vs before")
    if serialization.list_generations(victim_dir)[0][0] <= gen_pre:
        raise AssertionError(f"{what}: the victim's compaction committed no generation")
    steps["arm"] = time.perf_counter() - t_arm
    log(f"{what}: compact_index {done} (a False: that rank's watcher had compacted); step "
        "seconds " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    return dict(steps_s=steps, storm_requests=n_req, deleted=len(doomed),
                kill_after_s=kill_after, twin_share=twin_share, k1=[k1_before, k1_after])


def replica_phase(args, sq: dict, card: str, device: str = "cuda") -> dict:
    """Phase f: phase 3's corpus on four rank processes in two groups of
    R = 2 (``ServerHarness``), a SIGKILL under a query storm, a delta heal
    and a full shard transfer, through the client."""
    from distributed_faiss_tpu_torch.parallel.client import IndexClient
    from distributed_faiss_tpu_torch.testing.chaos import QueryStorm, ServerHarness
    from distributed_faiss_tpu_torch.utils.config import IndexCfg, ReplicationCfg

    what = "replicas"
    x, q_all, nprobe = sq["x"][:REPLICA_N], sq["q_all"], sq["nprobe"]
    n, d = x.shape
    q_eval = q_all[:1000]
    rng = np.random.default_rng(args.seed + 7)
    work = os.path.join(REPO, "build", "chip_smoke_replicas")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    disc, store = os.path.join(work, "discovery.txt"), os.path.join(work, "store")
    env = {"PYTHONPATH": REPO, "DFT_ANTIENTROPY_INTERVAL": "1"}
    h = ServerHarness(REPLICA_RANKS, disc, store, base_port=free_base(REPLICA_RANKS), env=env,
                      device=device)
    out = {}
    client = None
    t_phase = time.perf_counter()
    h.start()
    try:
        t0 = time.perf_counter()
        for r in range(REPLICA_RANKS):
            h.wait_port(r, timeout=300)
        client = IndexClient(disc, replication_cfg=ReplicationCfg(replication=2, write_quorum=1))
        pos_of = client.index_rank_to_id
        groups = {g: [r for r in range(REPLICA_RANKS)
                      if client.membership.group_of(pos_of[r]) == g] for g in (0, 1)}
        devices = {r: rank_call(client, pos_of, r, "ping")["device"] for r in range(REPLICA_RANKS)}
        if any(not str(dv).startswith(device) for dv in devices.values()) or any(
                len(g) != 2 for g in groups.values()):
            raise AssertionError(f"{what}: ranks {devices}, groups {groups}")
        log(f"{what}: {REPLICA_RANKS} rank processes up in {time.perf_counter() - t0:.2f} s on "
            f"{devices}; groups (by rank) {groups}, write quorum {client.quorum}")

        # ---- ingest and the healthy cluster ----
        iid = "default"  # what a restarted rank's --load-index loads
        cfg = IndexCfg(index_builder_type="ivfsq", dim=d, metric="l2", train_num=100_000,
                       centroids=1024, nprobe=nprobe, pallas_flat=True)
        if client.create_index(iid, cfg) != [True] * REPLICA_RANKS:
            raise AssertionError(f"{what}: create_index failed")
        client.cur_server_ids[iid] = 0  # batch b lands on group b % 2
        t0 = time.perf_counter()
        for s in range(0, n, REPLICA_BATCH):
            client.add_index_data(iid, x[s:s + REPLICA_BATCH],
                                  [(r,) for r in range(s, min(n, s + REPLICA_BATCH))])
        sent_s = time.perf_counter() - t0
        from distributed_faiss_tpu_torch.utils.state import IndexState

        deadline = time.monotonic() + 900
        while not (client.get_state(iid) == IndexState.TRAINED
                   and client.get_buffer_depth(iid) == 0 and client.get_ntotal(iid) == n):
            if time.monotonic() > deadline:
                raise AssertionError(f"{what}: the replicas never built the index")
            time.sleep(0.2)
        per_rank = {r: rank_call(client, pos_of, r, "get_ntotal", iid)
                    for r in range(REPLICA_RANKS)}
        log(f"{what}: ingested {n} rows as {REPLICA_BATCH}-row batches to both replicas of a "
            f"group in {sent_s:.2f} s of RPC; trained + indexed on every rank after "
            f"{time.perf_counter() - t0:.2f} s; rows per rank {per_rank}; get_ntotal "
            f"{client.get_ntotal(iid)}")
        cost = sweeper_cost(client, pos_of, range(REPLICA_RANKS))
        log(f"{what}: the sweepers during the ingest, per rank: digest requests answered and "
            f"their seconds, sweeps, add_index_data seconds: {cost}")
        out["sweeper_ingest"] = cost
        client.save_index(iid)
        gt_ids = exact_ground_truth(x, q_eval, 10, what)
        d0, meta0 = client.search(q_eval, 10, iid)
        check_result(d0, meta0, 1000, 10, f"{what} healthy search")
        rec0 = recall_at_10(meta0, gt_ids)
        if rec0 < 0.95:
            raise AssertionError(f"{what}: recall@10 {rec0:.4f} < 0.95 on the healthy cluster")
        # each replica's own answers: every rank serves, and whether the two
        # replicas of a group (each trained its own k-means) agree
        own = {r: rank_ids(client, pos_of, r, iid, q_eval) for r in range(REPLICA_RANKS)}
        twin = {g: same_share(own[a], own[b]) for g, (a, b) in groups.items()}
        log(f"{what}: healthy recall@10 {rec0:.4f} at nprobe={nprobe}; share of eval queries "
            f"whose top-10 ids are the same on both replicas of a group {twin}")
        serve_queries(client, q_all[:1000], iid, 100, 8)  # warm
        qps_h, p50_h, p99_h, _m = timed_serve(client, q_all, iid, f"{what} healthy", card)
        k1 = {r: rank_call(client, pos_of, r, "ping")["kernels"]["flat_list_scan"]
              for r in range(REPLICA_RANKS)}
        log(f"{what}: K1 launches per rank (ping) after the healthy serving: {k1}")
        if min(k1.values()) <= 0:
            raise AssertionError(f"{what}: a rank that served launched no K1")
        out.update(recall_healthy=rec0, qps_healthy=qps_h, p50_healthy_ms=p50_h,
                   p99_healthy_ms=p99_h, k1_healthy=k1, twin_share=twin)

        # ---- SIGKILL one replica of group 0 under a query storm ----
        v0, s0 = groups[0]
        storm = QueryStorm(client, iid, q_all[:100], 10, threads=8).start()
        time.sleep(2.0)
        h.kill(v0)
        t_kill = time.perf_counter()
        time.sleep(3.0)
        results, errors = storm.stop()
        if errors:
            raise AssertionError(f"{what}: {len(errors)} storm requests failed across the "
                                 f"SIGKILL, first {errors[0]!r}")
        for D, meta in results:
            check_result(D, meta, 100, 10, f"{what} storm search")
        log(f"{what}: SIGKILL of rank {v0} (group 0) under an 8-thread storm: {len(results)} "
            f"requests answered, 0 failed ({time.perf_counter() - t_kill:.1f} s after the kill "
            f"included)")
        qps_o, p50_o, p99_o, _m = timed_serve(client, q_all, iid, f"{what} outage", card,
                                              f", rank {v0} dead")
        # the divergence: rows, deletes and upserts into group 0 at quorum 1
        grp0 = sorted({m[0] for row in meta0 for m in row if m is not None
                       and (m[0] // REPLICA_BATCH) % 2 == 0})
        deleted = np.asarray(grp0[:DELTA_DELETES], np.int64)
        dead = set(deleted.tolist())
        upserted = [r for r in range(0, n, 1000)
                    if (r // REPLICA_BATCH) % 2 == 0 and r not in dead][:DELTA_UPSERTS]
        if deleted.size < DELTA_DELETES:
            raise AssertionError(f"{what}: only {deleted.size} group-0 ids served to delete")
        new0 = (x[rng.integers(0, n, DELTA_ROWS)]
                + rng.standard_normal((DELTA_ROWS, d)).astype(np.float32) * 0.5)
        client.cur_server_ids[iid] = 0
        client.add_index_data(iid, new0, [(n + i,) for i in range(DELTA_ROWS)])
        client.remove_ids(iid, deleted.tolist())
        client.cur_server_ids[iid] = 0
        client.upsert(iid, upserted, q_eval[:DELTA_UPSERTS])
        repl = client.get_replication_stats()
        if repl["counters"]["under_replicated"] < 3:
            raise AssertionError(f"{what}: the writes missing rank {v0} were not recorded: "
                                 f"{repl['counters']}")
        log(f"{what}: with rank {v0} down: {DELTA_ROWS} rows added, {deleted.size} ids deleted, "
            f"{len(upserted)} upserted, acked at quorum {client.quorum}; client counters "
            f"{repl['counters']}, repair queue {repl['repair']}")

        # ---- restart it with its storage: the sweeper heals it by delta ----
        t0 = time.perf_counter()
        h.restart(v0, load_index=True, extra_env={"DFT_SHARD_GROUP": "0"})
        h.wait_port(v0, timeout=300)
        up_s = time.perf_counter() - t0
        wait_answers(client, pos_of, v0)
        with client._lock:
            client._preferred[0] = pos_of[v0]  # its drain refusals must fail over
        storm = QueryStorm(client, iid, q_all[:100], 10, threads=4).start()
        delta_s = wait_converged(h, v0, s0, iid, f"{what} delta heal")
        results, errors = storm.stop()
        if errors:
            raise AssertionError(f"{what}: {len(errors)} requests failed during the delta heal, "
                                 f"first {errors[0]!r}")
        ae0 = rank_call(client, pos_of, v0, "get_perf_stats")["antientropy"]
        if ae0["full_syncs"] != 0 or ae0["rows_repaired"] < DELTA_ROWS:
            raise AssertionError(f"{what}: rank {v0} did not heal by delta: {ae0}")
        log(f"{what}: rank {v0} back with its storage in {up_s:.2f} s (load included); "
            f"digests equal to rank {s0}'s {delta_s:.2f} s later by delta: "
            f"{ae0['rows_repaired']} rows pulled, {ae0['rows_refreshed']} refreshed, "
            f"{ae0['full_syncs']} full syncs; {len(results)} storm requests answered during "
            f"the heal, 0 failed")
        cost = sweeper_cost(client, pos_of, (v0, s0))
        log(f"{what}: the sweepers of group 0 since rank {v0}'s restart (its own) and since the "
            f"start (rank {s0}): {cost}")
        out.update(qps_outage=qps_o, p50_outage_ms=p50_o, p99_outage_ms=p99_o,
                   restart_load_s=up_s, delta_converge_s=delta_s, sweeper_delta=cost)

        # ---- SIGKILL one replica of group 1, add FULL_ROWS, restart it empty ----
        v1, s1 = groups[1]
        h.kill(v1)
        new1 = (x[rng.integers(0, n, FULL_ROWS)]
                + rng.standard_normal((FULL_ROWS, d)).astype(np.float32) * 0.5)
        base1 = n + DELTA_ROWS
        for s in range(0, FULL_ROWS, REPLICA_BATCH):
            client.cur_server_ids[iid] = 1
            client.add_index_data(iid, new1[s:s + REPLICA_BATCH],
                                  [(base1 + r,) for r in range(s, s + REPLICA_BATCH)])
        shutil.rmtree(os.path.join(store, iid, str(v1)), ignore_errors=True)
        t0 = time.perf_counter()
        h.restart(v1, extra_env={"DFT_SHARD_GROUP": "1"})
        h.wait_port(v1, timeout=300)
        full_s = wait_converged(h, v1, s1, iid, f"{what} full transfer")
        wait_answers(client, pos_of, v1)
        st1 = rank_call(client, pos_of, v1, "get_perf_stats")
        xfer, ae1 = st1["replication"]["last_transfer"], st1["antientropy"]
        if ae1["full_syncs"] != 1 or not xfer:
            raise AssertionError(f"{what}: rank {v1} did not heal by a full transfer: {ae1}")
        donor_rss = rank_call(client, pos_of, s1, "get_perf_stats")["process"]["peak_rss_mb"]
        log(f"{what}: rank {v1} restarted empty; digests equal to rank {s1}'s "
            f"{time.perf_counter() - t0:.2f} s after the restart ({full_s:.2f} s after its port "
            f"opened): full shard transfer of {xfer['ntotal']} rows, "
            f"{xfer['array_bytes'] / 1e6:.1f} MB of arrays in {xfer['seconds']:.2f} s "
            f"(fetch {xfer['fetch_seconds']:.2f} s, then commit + restore); donor rank {s1} "
            f"peak RSS {donor_rss:.0f} MB")
        out.update(full_converge_s=full_s, transfer_s=xfer["seconds"],
                   transfer_fetch_s=xfer["fetch_seconds"], transfer_mb=xfer["array_bytes"] / 1e6,
                   transfer_rows=xfer["ntotal"], donor_rss_mb=donor_rss)

        # ---- correctness on the healed ranks ----
        k1_before = {r: rank_call(client, pos_of, r, "ping")["kernels"]["flat_list_scan"]
                     for r in (v0, v1)}
        with client._lock:
            client._preferred.update({0: pos_of[v0], 1: pos_of[v1]})
        d1, meta1 = client.search(q_eval, 10, iid)
        check_result(d1, meta1, 1000, 10, f"{what} search pinned on the healed ranks")
        dead_set = set(deleted.tolist())
        if served_ids(meta1) & dead_set:
            raise AssertionError(f"{what}: a healed rank served a deleted id")
        top1 = [meta1[i][0][0] if meta1[i][0] else None for i in range(len(upserted))]
        if top1 != upserted:
            raise AssertionError(f"{what}: upserted rows not top-1 on the healed ranks: {top1}")
        x_full = np.concatenate([x, new0, new1])
        x_full[upserted] = q_eval[:len(upserted)]
        gt1 = survivors_ground_truth(x_full, q_eval, deleted, f"{what} survivors")
        rec1 = recall_at_10(meta1, gt1)
        if rec1 < 0.95:
            raise AssertionError(f"{what}: recall@10 {rec1:.4f} < 0.95 over the survivors")
        same = {}
        for g, (healed, surv) in ((0, (v0, s0)), (1, (v1, s1))):
            same[g] = same_share(rank_ids(client, pos_of, healed, iid, q_eval),
                                 rank_ids(client, pos_of, surv, iid, q_eval))
        # a carried state (the full transfer) serves its donor's ids; a
        # delta-healed replica kept its own k-means, so it matches its peer
        # only as far as the healthy twins did
        if same[1] != 1.0 or (twin[0] == 1.0 and same[0] != 1.0):
            raise AssertionError(f"{what}: pinned ids of healed vs survivor replicas {same}, "
                                 f"healthy twins {twin}")
        k1_after = {r: rank_call(client, pos_of, r, "ping")["kernels"]["flat_list_scan"]
                    for r in (v0, v1)}
        if any(k1_after[r] <= k1_before[r] for r in (v0, v1)):
            raise AssertionError(f"{what}: K1 launches did not rise on the healed ranks: "
                                 f"{k1_before} -> {k1_after}")
        log(f"{what}: pinned on the healed ranks {v0} and {v1}: no deleted id, every upserted "
            f"row top-1, recall@10 {rec1:.4f} over the {x_full.shape[0] - deleted.size} "
            f"survivors; share of queries with the same ids as the survivor replica {same}; "
            f"K1 launches {k1_before} -> {k1_after}")
        with client._lock:
            client._preferred.clear()
        qps_r, p50_r, p99_r, _m = timed_serve(client, q_all, iid, f"{what} healed", card)
        k1_end = {r: rank_call(client, pos_of, r, "ping")["kernels"]["flat_list_scan"]
                  for r in range(REPLICA_RANKS)}
        lease = {r: rank_call(client, pos_of, r, "get_health")["compaction"]["held"]
                 for r in range(REPLICA_RANKS)}
        log(f"{what}: K1 launches per rank at the end {k1_end}; compaction lease held by "
            f"{sorted(r for r, held in lease.items() if held)} (groups {groups}); phase "
            f"{time.perf_counter() - t_phase:.1f} s")
        out.update(recall_healed=rec1, same_ids=same, qps_healed=qps_r, p50_healed_ms=p50_r,
                   p99_healed_ms=p99_r, k1_end=k1_end, lease=lease)
        out["f3"] = compaction_kill_arm(h, client, pos_of, groups, iid, q_all, store, rng)
    finally:
        if client is not None:
            client.close()
        h.stop()
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------- phase l

# the savers' work dir, their row batch and trial count; the kill lands at
# a share, drawn from --seed, of a save loop's first iteration after the
# first new generation committed
SAVER_DIR = os.path.join(REPO, "build", "chip_smoke_saver")
SAVER_BATCH = 10_000
SAVER_TRIALS = 5
SAVER_FIRST_LIMIT_S = 300.0


def saver_rows(seed: int, trial: int, centers: np.ndarray, batches: int) -> np.ndarray:
    """The rows a trial's saver adds in its first ``batches`` loops."""
    rng = np.random.default_rng(seed + 1000 + trial)
    d = centers.shape[1]
    return np.concatenate([make_corpus(rng, SAVER_BATCH, d, centers) for _ in range(batches)]
                          or [np.zeros((0, d), np.float32)])


def saver_child(args) -> int:
    """The entry of a phase l child (``--saver-child DIR``): load the linked
    snapshot in DIR on the card, then add SAVER_BATCH rows of phase 3's
    generator, wait for the drain and save, in a loop, printing each
    committed generation, until it is killed."""
    sys.path.insert(0, REPO)
    from distributed_faiss_tpu_torch.engine import Index
    from distributed_faiss_tpu_torch.utils.config import IndexCfg
    from distributed_faiss_tpu_torch.utils.device import resolve_device
    from distributed_faiss_tpu_torch.utils.state import IndexState

    resolve_device("cuda")
    storage = args.saver_child
    centers = np.load(os.path.join(SAVER_DIR, "centers.npy"))
    cfg = IndexCfg.from_json(os.path.join(storage, "cfg.json"))
    cfg.index_storage_dir = storage
    t0 = time.perf_counter()
    idx = Index.from_storage_dir(storage, cfg=cfg, device="cuda")
    rows = idx.model.ntotal
    print(f"SAVER_READY {idx.current_generation()} {rows} {time.perf_counter() - t0:.3f}",
          flush=True)
    rng = np.random.default_rng(args.seed + 1000 + args.trial)
    while True:
        t0 = time.perf_counter()
        x = make_corpus(rng, SAVER_BATCH, centers.shape[1], centers)
        idx.add_batch(x, [(rows + i,) for i in range(SAVER_BATCH)])
        rows += SAVER_BATCH
        while not (idx.get_state() == IndexState.TRAINED
                   and idx.get_idx_data_num() == (0, rows)):
            time.sleep(0.005)
        if not idx.save():
            raise RuntimeError(f"save at {rows} rows committed no generation")
        print(f"SAVER_COMMITTED {idx.current_generation()} {rows} "
              f"{time.perf_counter() - t0:.3f}", flush=True)


def read_saver(proc, lines: list, first: threading.Event) -> None:
    for line in proc.stdout:
        lines.append(line.rstrip("\n"))
        if line.startswith("SAVER_COMMITTED"):
            first.set()


def snapshot_kill_phase(args, sq: dict, counters, card: str) -> dict:
    """Phase l: the snapshot kill-9 sweep on the card (module docstring)."""
    from distributed_faiss_tpu_torch.engine import Index
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    what = "phase l"
    src = os.path.join(WITNESS_DIR, "ivfsq")
    with open(os.path.join(src, "path.json")) as f:
        spec = json.load(f)
    iid, nprobe = spec["iid"], spec["nprobe"]
    x, q_eval, centers = sq["x"], sq["q_all"][:1000], sq["centers"]
    shutil.rmtree(SAVER_DIR, ignore_errors=True)
    os.makedirs(SAVER_DIR)
    np.save(os.path.join(SAVER_DIR, "centers.npy"), centers)
    kill_rng = np.random.default_rng(args.seed + 11)
    shares = kill_rng.uniform(0.0, 1.0, SAVER_TRIALS)
    dirs, procs, lines, first = [], [], [], []
    trials = []
    t_phase = time.perf_counter()
    try:
        # every trial's saver starts at once, each on a fresh link of the
        # snapshot; each is killed at its own drawn moment
        for trial in range(SAVER_TRIALS):
            # the rank-0 shard of the one-server store
            d = os.path.join(SAVER_DIR, f"trial{trial}", iid, "0")
            shutil.copytree(os.path.join(src, "store", iid, "0"), d,
                            copy_function=_link_or_copy)
            dirs.append(d)
            cmd = [sys.executable, os.path.abspath(__file__), "--saver-child", d,
                   "--trial", str(trial), "--seed", str(args.seed)]
            procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, text=True))
            lines.append([])
            first.append(threading.Event())
            threading.Thread(target=read_saver, args=(procs[-1], lines[-1], first[-1]),
                             name=f"smoke-saver-{trial}", daemon=True).start()

        killed_at = [None] * SAVER_TRIALS

        def kill_when_due(trial: int) -> None:
            deadline = time.monotonic() + SAVER_FIRST_LIMIT_S
            while not first[trial].wait(0.2):
                if procs[trial].poll() is not None or time.monotonic() > deadline:
                    procs[trial].kill()  # checked below: no generation committed
                    return
            loop_s = float(next(ln for ln in lines[trial]
                                if ln.startswith("SAVER_COMMITTED")).split()[3])
            time.sleep(shares[trial] * loop_s)
            procs[trial].kill()
            killed_at[trial] = time.perf_counter() - t_phase

        killers = [threading.Thread(target=kill_when_due, args=(t,), daemon=True)
                   for t in range(SAVER_TRIALS)]
        for k in killers:
            k.start()
        n0 = x.shape[0]
        # each dir is loaded as soon as its saver is dead, the others
        # running on meanwhile
        for trial, d in enumerate(dirs):
            killers[trial].join(SAVER_FIRST_LIMIT_S + 120)
            procs[trial].wait(timeout=60)
            ready = [ln for ln in lines[trial] if ln.startswith("SAVER_READY")]
            committed = [ln.split() for ln in lines[trial] if ln.startswith("SAVER_COMMITTED")]
            if procs[trial].returncode != -9 or not ready or not committed:
                raise AssertionError(f"{what} trial {trial}: the saver exited "
                                     f"{procs[trial].returncode} with {len(committed)} "
                                     f"generations committed: {lines[trial][-3:]}")
            last_gen = int(committed[-1][1])
            cfg = IndexCfg.from_json(os.path.join(d, "cfg.json"))
            cfg.index_storage_dir = d
            zero_counts(counters)
            t0 = time.perf_counter()
            loaded = Index.from_storage_dir(d, cfg=cfg, device="cuda")
            load_s = time.perf_counter() - t0
            try:
                if loaded is None:
                    raise AssertionError(f"{what} trial {trial}: nothing loadable")
                gen, n = loaded.current_generation(), loaded.model.ntotal
                extra = n - n0
                qdir = os.path.join(d, "quarantine")
                orphans = sorted(os.listdir(qdir)) if os.path.isdir(qdir) else []
                if (gen < last_gen or len(loaded.id_to_metadata) != n
                        or extra < SAVER_BATCH or extra % SAVER_BATCH
                        or loaded.get_idx_data_num() != (0, n)):
                    raise AssertionError(
                        f"{what} trial {trial}: generation {gen} (last committed "
                        f"{last_gen}), ntotal {n}, metadata {len(loaded.id_to_metadata)}, "
                        f"buffer and index {loaded.get_idx_data_num()}")
                loaded.set_nprobe(nprobe)
                D, meta, _e = loaded.search(q_eval, 10)
                check_result(D, meta, q_eval.shape[0], 10, f"{what} trial {trial} search")
                ids = served_ids(meta)
                if min(ids) < 0 or max(ids) >= n:
                    raise AssertionError(f"{what} trial {trial}: served ids outside the "
                                         f"{n} rows of generation {gen}")
                counts = read_counts(counters)
            finally:
                if loaded is not None:
                    loaded.retire()
                del loaded
                torch.cuda.empty_cache()
            x_all = np.concatenate([x, saver_rows(args.seed, trial, centers,
                                                  extra // SAVER_BATCH)])
            gt = exact_ground_truth(x_all, q_eval, 10, f"{what} trial {trial}")
            rec = recall_at_10(meta, gt)
            if rec < 0.95 or counts["K1"] <= 0:
                raise AssertionError(f"{what} trial {trial}: recall@10 {rec:.4f}, K1 "
                                     f"launches {counts['K1']}")
            log(f"{what} trial {trial}: saver killed at {shares[trial]:.3f} of a save loop, "
                f"{killed_at[trial]:.1f} s into the phase, after {len(committed)} "
                f"generation(s) committed (last {last_gen}); loaded "
                f"generation {gen} in {load_s:.2f} s ({extra} of its {n} rows added by the "
                f"saver), {len(orphans)} file(s) quarantined {orphans}; recall@10 {rec:.4f} "
                f"at nprobe {nprobe} against the exact FlatIndex over those rows; K1 "
                f"launches {counts['K1']}")
            trials.append(dict(trial=trial, generation=gen, last_committed=last_gen,
                               rows=n, orphans=len(orphans), load_s=load_s, recall=rec,
                               k1=counts["K1"], committed=len(committed),
                               killed_at_s=killed_at[trial],
                               saver_load_s=float(ready[0].split()[3])))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(SAVER_DIR, ignore_errors=True)
    log(f"{what}: {SAVER_TRIALS} of {SAVER_TRIALS} killed savers loadable; phase "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return dict(trials=trials)


# ---------------------------------------------------------------- phase k

# the repo's own ingest configuration: IVF{centroids},SQ8 at 65,536
# centroids, d = 768, train_num 1,000,000, nprobe 32, buffer_bsz 50,000
TIER_CFG = os.path.join(REPO, "scripts", "idx_cfg.json")
# the tier's first shard size (engine.infer_n_centroids) and the cfg's
# train_num; the mesh arm holds the first TIER_MESH_N of its rows
TIER_N = 1_000_000
TIER_MESH_N = 200_000
TIER_BATCH = 50_000
# K1's instantiation for sq8 rows read in 16-byte chunks, 2 chunks a lane
# (d = 768), in nvcc's mangled kernel names
K1_SQ8_768 = "flat_scan_kernelIhLb1ELi2ELi2E"


def ptxas_entry(cuda_build, name: str, fragment: str) -> str:
    """nvcc's register and spill lines for the kernel instantiation of
    ``csrc/<name>.cu`` whose mangled name holds ``fragment``."""
    lines = cuda_build.build_log(name).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and fragment in line:
            return "; ".join(l.split(":", 1)[-1].strip() for l in lines[i + 1:i + 5]
                             if "registers" in l or "spill" in l)
    raise AssertionError(f"no {fragment} in the ptxas report of {name}")


def state_times(engine_of, stop: threading.Event) -> tuple:
    """Poll an index's engine state every 20 ms until ``stop``, in a
    thread: (the list of (perf_counter, state) of every change, in order;
    the thread)."""
    seen = []

    def poll():
        while not stop.is_set():
            eng = engine_of()
            state = getattr(eng, "state", None)
            if state is not None and (not seen or seen[-1][1] != state):
                seen.append((time.perf_counter(), state))
            time.sleep(0.02)

    t = threading.Thread(target=poll, name="smoke-state-poll", daemon=True)
    t.start()
    return seen, t


def tier_phase(args, counters, card: str, cuda_build) -> dict:
    """Phase k (module docstring): scripts/idx_cfg.json at the 65,536-list
    tier through the port's load_data, served through K1's sq8 branch;
    then the mesh's tier (k.2)."""
    import logging

    from distributed_faiss_tpu_torch.models import ivf
    from distributed_faiss_tpu_torch.ops import flat_scan
    from distributed_faiss_tpu_torch.parallel.client import IndexClient
    from distributed_faiss_tpu_torch.scripts import load_data
    from distributed_faiss_tpu_torch.utils import compilecheck
    from distributed_faiss_tpu_torch.utils.state import IndexState

    what, d, n, iid = "tier", 768, TIER_N, "tier"
    with open(TIER_CFG) as f:
        cfg = json.load(f)
    nlist = int(cfg["centroids"])
    if (cfg["dim"], nlist, cfg["train_num"]) != (d, 65_536, n):
        raise AssertionError(f"{what}: {TIER_CFG} is not the 65,536-list d=768 cfg: {cfg}")
    work = os.path.join(REPO, "build", "chip_smoke_tier")
    rng = np.random.default_rng(args.seed + 11)
    t0 = time.perf_counter()
    gen = make_lowrank_corpus(rng, d, 64, 8192)
    s = Serving(work)
    out = {}
    try:
        rows = os.path.join(work, "rows.f16")
        mm = np.memmap(rows, dtype=np.float16, mode="w+", shape=(n, d))
        for b in range(0, n, 100_000):
            mm[b:b + 100_000] = gen(min(100_000, n - b)).astype(np.float16)
        mm.flush()
        x = np.asarray(mm, np.float32)  # the rows as load_data sends them
        del mm
        q_all = gen(args.nq)
        q_eval = q_all[:1000]
        log(f"{what}: made {n} x {d} rows of the low-rank corpus (r 64, 8192 clusters) as "
            f"an fp16 memmap of {os.path.getsize(rows)} bytes and {args.nq} queries in "
            f"{time.perf_counter() - t0:.2f} s (seed {args.seed} + 11)")

        # ---- ingest through load_data, the train and the add timed apart ----
        zero_counts(counters)
        stop = threading.Event()
        seen, poller = state_times(lambda: s.server.indexes.get(iid), stop)
        root = logging.getLogger()
        handlers, level = list(root.handlers), root.level
        t0 = time.perf_counter()
        try:
            rc = load_data.main(["--data", rows, "--dtype", "fp16", "--dim", str(d),
                                 "--bs", str(TIER_BATCH), "--discovery", s.disc,
                                 "--index-id", iid, "--cfg", TIER_CFG, "--device", "cuda"])
        finally:
            # load_data configures the root logger for its own process
            for h in root.handlers[len(handlers):]:
                root.removeHandler(h)
            root.setLevel(level)
        load_s = time.perf_counter() - t0
        # a client that knows the index's cfg (its metric), as load_data's
        s.client.close()
        s.client = IndexClient(s.disc, cfg_path=TIER_CFG)
        deadline = time.monotonic() + 300
        while s.client.get_ntotal(iid) != n:
            if time.monotonic() > deadline:
                raise AssertionError(f"{what}: ntotal {s.client.get_ntotal(iid)} != {n}")
            time.sleep(0.2)
        stop.set()
        poller.join()
        at = {}
        for t, state in seen:
            at.setdefault(state, t)
        if rc != 0 or IndexState.TRAINING not in at or IndexState.ADD not in at:
            raise AssertionError(f"{what}: load_data returned {rc}; states seen {seen}")
        trained_after_add = [t for t, st in seen if st == IndexState.TRAINED
                             and t > at[IndexState.ADD]]
        ingest_s = at[IndexState.TRAINING] - t0
        train_s = at[IndexState.ADD] - at[IndexState.TRAINING]
        add_s = trained_after_add[0] - at[IndexState.ADD]
        model = s.server.indexes[iid].model
        if (type(model).__name__, model.nlist, model.codec, model.ntotal) != (
                "IVFFlatIndex", nlist, "sq8", n):
            raise AssertionError(f"{what}: served {type(model).__name__} nlist "
                                 f"{model.nlist} codec {model.codec} ntotal {model.ntotal}")
        lists = model.lists
        padded = (lists.data.numel() * lists.data.element_size() + lists.ids.numel() * 4
                  + (model.norm_lists.data.numel() * 4 if model.norm_lists is not None else 0))
        out.update(load_s=load_s, ingest_s=ingest_s, train_s=train_s, add_s=add_s,
                   cap=lists.cap, largest_list=int(lists.sizes_host.max()),
                   empty_lists=int((lists.sizes_host == 0).sum()), padded_bytes=padded)
        log(f"{what}: load_data (IVF{nlist},SQ8, --bs {TIER_BATCH}) returned after "
            f"{load_s:.2f} s: ingest {ingest_s:.2f} s (until the threshold training "
            f"started), train {train_s:.2f} s, add {add_s:.2f} s; {nlist} lists, codec "
            f"{model.codec}, largest list {out['largest_list']} rows (mean "
            f"{n / nlist:.1f}, {out['empty_lists']} empty), cap {lists.cap}, padded lists "
            f"+ ids + norms {padded} bytes; {torch.cuda.memory_allocated()} bytes "
            f"allocated on the card, peak {torch.cuda.max_memory_allocated()}")

        # ---- serve ----
        gt_ids = exact_ground_truth(x, q_eval, 10, what)
        nprobe, rec = sweep_nprobe(s.client, iid, q_eval, gt_ids, args.nprobe_from, nlist,
                                   what)
        before = read_counts(counters)
        compilecheck.install()
        try:
            arm = graph_arm(s, iid, q_all, counters, "K1", "graphs", card, what)
        finally:
            compilecheck.uninstall()
        arm.pop("D"), arm.pop("M")
        if arm["replays_per_window"] != 1.0:
            raise AssertionError(f"{what}: {arm['replays_per_window']} replays a window")
        out["programs"] = log_programs(s, iid, what)
        save_drop_load(s.client, iid, q_eval, nprobe, what)
        after = read_counts(counters)
        counts = {k: before[k] + after[k] for k in before}
        if counts["K1"] <= 0 or any(counts[k] for k in ("K2", "K3", "K3 lists", "K4")):
            raise AssertionError(f"{what}: launches on the path {counts}: K1 only expected")
        model = s.server.indexes[iid].model
        if model.codec != "sq8":
            raise AssertionError(f"{what}: the loaded model's codec is {model.codec}")
        out.update(nprobe=nprobe, recall=rec, counts=counts,
                   serve={k: arm[k] for k in ("qps", "p50_ms", "p99_ms", "windows",
                                              "replays_per_window", "launches")})
        log(f"{what}: launches on the path {counts}")
        out["k1"] = k1_main_shape(flat_scan, ivf, model, q_all, q_more=q_all, what=what)
        out["k1"]["launches"] = counts["K1"]
        out["k1_ptxas"] = ptxas_entry(cuda_build, "flat_scan", K1_SQ8_768)
        log(f"{what}: ptxas for K1's sq8 d=768 instantiation ({K1_SQ8_768}): "
            f"{out['k1_ptxas']}")
        del model, lists
    finally:
        s.close()
    torch.cuda.empty_cache()
    out["mesh"] = tier_mesh_arm(x, q_eval, int(cfg["nprobe"]), counters, card)
    return out


def tier_mesh_arm(x: np.ndarray, q_eval: np.ndarray, nprobe: int, counters,
                  card: str) -> dict:
    """Phase k.2: ``sharded_kmeans`` at 65,536 centroids (its random-seed
    branch, one Lloyd step) on MESH_SHARDS virtual shards, with the JAX
    test's invariants; then a routed ShardedIVFFlatIndex on those centroids
    over the first TIER_MESH_N rows, against the unsharded IVF-Flat index's
    top-10 ids at ``nprobe`` (the cfg's: the arm's rows fill a list a
    fifth as deep as the phase's) on the tie-free queries."""
    from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex
    from distributed_faiss_tpu_torch.parallel import mesh as tmesh

    what, nlist, d = "tier mesh", 65_536, x.shape[1]
    mesh = tmesh.make_mesh(MESH_SHARDS, device="cuda", virtual=True)
    t0 = time.perf_counter()
    cent = tmesh.sharded_kmeans(mesh, x, nlist, iters=1)
    torch.cuda.synchronize()
    km_s = time.perf_counter() - t0
    c = cent.cpu().numpy()
    lo, hi = x.min(0) - 1e-3, x.max(0) + 1e-3
    sample = c[np.random.default_rng(1).permutation(nlist)[:4096]]
    spread = float(np.median(np.linalg.norm(sample[:-1] - sample[1:], axis=1)))
    if (c.shape != (nlist, d) or not np.isfinite(c).all() or (c < lo).any() or (c > hi).any()
            or spread <= 1e-3):
        raise AssertionError(f"{what}: sharded_kmeans centroids fail the tier's invariants "
                             f"(median spread {spread})")
    log(f"{what}: sharded_kmeans k={nlist} iters=1 over {x.shape[0]} rows on {MESH_SHARDS} "
        f"shards in {km_s:.2f} s: finite, inside the rows' bounding box, median spread "
        f"{spread:.4f}, on {card}")
    xm, q11 = x[:TIER_MESH_N], q_eval
    one = IVFFlatIndex(d, nlist, "l2", "f32", device="cuda")
    one.centroids = cent.clone()
    one.lists = one._make_lists()
    one.add(xm)
    one.set_nprobe(nprobe)
    Dw, Iw = one.search(q11, 11)
    cap_one = one.lists.cap
    del one
    torch.cuda.empty_cache()
    idx = tmesh.ShardedIVFFlatIndex(d, nlist, "l2", mesh=mesh, probe_routing=True,
                                    device="cuda")
    idx.centroids = cent
    idx.lists = idx._make_lists()
    t0 = time.perf_counter()
    idx.add(xm)
    add_s = time.perf_counter() - t0
    idx.set_nprobe(nprobe)
    idx.search(q11, 11)  # warm: the routed programs' captures
    zero_counts(counters)
    launches0, relaunches0 = idx.launches, idx.routed_relaunches
    shard0 = idx.shard_launches.copy()
    t0 = time.perf_counter()
    Dg, Ig = idx.search(q11, 11)
    search_s = time.perf_counter() - t0
    counts = read_counts(counters)
    shard_k1 = (idx.shard_launches - shard0).tolist()
    meta = [[[None if i < 0 else (int(i),) for i in row] for row in I] for I in (Ig, Iw)]
    share = same_top10(Dg, meta[0], Dw, meta[1], f"{what}: routed {MESH_SHARDS}-shard "
                       f"IVF-Flat against the unsharded index at nprobe={nprobe}")
    if counts["K1"] <= 0 or min(shard_k1) <= 0:
        raise AssertionError(f"{what}: K1 launches {counts['K1']}, by shard {shard_k1}")
    out = dict(kmeans_s=km_s, spread=spread, add_s=add_s, search_s=search_s, tie_free=share,
               cap=idx.lists.cap, cap_unsharded=cap_one, launches=counts["K1"],
               shard_launches=shard_k1, blocks=idx.launches - launches0,
               relaunches=idx.routed_relaunches - relaunches0, programs=idx.program_stats())
    log(f"{what}: routed ShardedIVFFlatIndex over {TIER_MESH_N} rows (cap {idx.lists.cap}, "
        f"unsharded cap {cap_one}), added in {add_s:.2f} s; {q11.shape[0]} queries in "
        f"{search_s * 1e3:.3f} ms after a warm search, {out['blocks']} routed blocks "
        f"({out['relaunches']} relaunches), K1 "
        f"{counts['K1']} launches, shards' K1 {shard_k1}, programs "
        f"{json.dumps(out['programs'])}")
    del idx
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase h

MESH_SHARDS = 4
# consecutive distances closer than this share of the row's scale count as
# a tie: the order of tied rows is not defined (torch.topk)
TIE_REL = 1e-6


def tie_free_rows(D: np.ndarray) -> np.ndarray:
    """Rows of an (nq, 11) ascending distance block whose 11 distances are
    all apart: on these rows the top-10 ids are defined without ties."""
    with np.errstate(invalid="ignore"):
        scale = np.maximum(np.abs(D).max(axis=1), 1e-30)
        return np.isfinite(D).all(axis=1) & (np.diff(D, axis=1)
                                             > TIE_REL * scale[:, None]).all(axis=1)


def same_top10(Da, Ma, Db, Mb, what: str, min_share: float = 0.9) -> float:
    """Top-11 results of the same queries from two paths: the top-10 ids of
    every row tie-free on both sides agree; returns the tie-free share,
    which must reach ``min_share``."""
    ok = tie_free_rows(Da) & tie_free_rows(Db)
    share = float(ok.mean())
    if share < min_share:
        raise AssertionError(f"{what}: only {share:.3f} of the queries are tie-free")
    ids = [top10_ids(M) for M in (Ma, Mb)]
    bad = [i for i in np.flatnonzero(ok) if ids[0][i] != ids[1][i]]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {int(ok.sum())} tie-free queries differ "
                             f"(first: {bad[0]})")
    log(f"{what}: the same top-10 ids on all {int(ok.sum())} tie-free queries "
        f"({share:.3f} of {len(ok)})")
    return share


def bound_of(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes over HBM and ops over fp32."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def shard_kernel_checks(model, q_block: np.ndarray, kernel: str) -> list:
    """h.7: the kernel of a sharded model's path (K1 or K3 over the lists)
    on each shard's own inputs (the first probe group of one query block,
    remapped to the shard's local slots and owned sizes by the model's
    ``_owned``) against its plain version, with its time and bound."""
    from distributed_faiss_tpu_torch.models import ivf
    from distributed_faiss_tpu_torch.ops import adc_scan, flat_scan
    from distributed_faiss_tpu_torch.parallel import mesh

    nprobe, nb, g = model._search_plan()
    q = torch.from_numpy(np.ascontiguousarray(q_block[:nb])).cuda()
    li = ivf._probe_groups(model.centroids, q, nprobe, g, model.metric)[0].contiguous()
    S, cap = model.mesh.size, model.lists.cap
    nq = q.shape[0]
    lut = None
    if kernel == "K3 lists":
        lut = ivf._pq_group_lut(model.centroids, model.codebooks, q, li, model.metric,
                                model.lut_bf16)
    rows = []
    for s in range(S):
        slot, sizes = mesh._owned(li, model.lists.sizes[s], S, s)
        owned = sizes > 0
        # what this shard's data needs: the owned pairs' live rows, LUTs
        # and queries (a kernel skips a pair of size 0 before reading them)
        unique_live = int(model.lists.sizes[s][torch.unique(slot[owned].long())].sum().item())
        pair_live = int(sizes.sum().item())
        owned_pairs = int(owned.sum().item())
        owned_queries = int(owned.any(dim=1).sum().item())
        if kernel == "K1":
            norms = model._scan_norms()
            args = (q, model.lists.data[s], model.lists.ids[s], slot, sizes,
                    None if norms is None else norms[s])
            kw = dict(metric=model.metric, codec="f32", scan_bf16=model.scan_bf16)
            fn = functools.partial(flat_scan.flat_list_scan, **kw)
            plain = functools.partial(flat_scan.flat_list_scan_plain, **kw)
            row_bytes = model.dim * 4 + 4 + (4 if norms is not None else 0)
            nbytes = (unique_live * row_bytes + nq * g * cap * 4 + owned_queries * model.dim * 4
                      + 2 * nq * g * 4)
            ops = pair_live * 2 * model.dim
        else:
            args = (lut, model.lists.data[s], slot, sizes, model.lists.ids[s])
            fn, plain = adc_scan.adc_scan_lists, adc_scan.adc_scan_lists_plain
            nbytes = (owned_pairs * model.m * lut.shape[2] * lut.element_size()
                      + unique_live * (model.m + 4) + 2 * nq * g * 4 + nq * g * cap * 4)
            ops = pair_live * model.m
        err = compare_scores(fn(*args), plain(*args), 1e-4, 1e-4, f"h.7 {kernel} shard {s}")
        bound_ms, bound_by = bound_of(nbytes, ops)
        sets = l2_copies(args, nbytes)
        ms = time_ms(fn, sets, iters=20)
        del sets
        rows.append(dict(shard=s, owned_pairs=owned_pairs, live_rows=pair_live,
                         ms=ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))
        log(f"h.7 {kernel} shard {s}/{S}: nq={nq} g={g} cap={cap} owned pairs "
            f"{rows[-1]['owned_pairs']} of {nq * g}, live rows {pair_live}: kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {ops} ops), "
            f"max_abs_err {err:.3g} (plain version, rtol/atol 1e-4)")
    return rows


def arm(args, s, counters, iid: str, q_all: np.ndarray, nprobe: int, card: str, what: str,
        model, kernel: str, gt: np.ndarray = None) -> dict:
    """Serve one phase h arm (``nprobe`` set): recall@10 on the first 1000
    queries against ``gt`` (>= 0.95), ``--nq`` queries timed, the path's
    kernel launched (and, on a sharded model, on every shard)."""
    s.client.set_nprobe(iid, nprobe)
    zero_counts(counters)
    shard0 = getattr(model, "shard_launches", None)
    shard0 = None if shard0 is None else shard0.copy()
    out = {}
    if gt is not None:
        D, meta = s.client.search(q_all[:1000], 10, iid)
        check_result(D, meta, 1000, 10, f"{what} recall request")
        out["recall"] = recall_at_10(meta, gt)
        log(f"{what}: recall@10={out['recall']:.4f} at nprobe={nprobe}")
        if out["recall"] < 0.95:
            raise AssertionError(f"{what}: recall@10 {out['recall']:.4f} < 0.95")
    out.update(serve_and_report(args, s.client, iid, q_all, nprobe, card, what))
    out.pop("meta")
    out.update(counts=read_counts(counters), nprobe=nprobe)
    if kernel and out["counts"][kernel] <= 0:
        raise AssertionError(f"{what}: {kernel} was not launched on this path")
    if shard0 is not None:
        out["shard_launches"] = (model.shard_launches - shard0).tolist()
        if kernel and min(out["shard_launches"]) <= 0:
            raise AssertionError(f"{what}: {kernel} did not launch on every shard: "
                                 f"{out['shard_launches']}")
    log(f"{what}: launches {out['counts']}"
        + (f", per shard {out['shard_launches']}" if shard0 is not None else ""))
    return out


def routed_mode(s, iid: str, q_all: np.ndarray, counters, kernel: str, mode: str, card: str,
                what: str, model) -> dict:
    """h.4: the routed model served in one mode (``graph_arm``: a warm run,
    ``--nq`` queries timed with no capture, the same queries at top-11),
    with its routed blocks (counted launches), relaunches and replays:
    with programs exactly one replay a block, and every shard launched."""
    launches0, relaunches0 = model.launches, model.routed_relaunches
    shard0, st0 = model.shard_launches.copy(), model.program_stats()
    out = graph_arm(s, iid, q_all, counters, kernel, mode, card, what)
    st1 = model.program_stats()
    blocks = model.launches - launches0
    replays = st1["replays"] - st0["replays"]
    out.update(blocks=blocks, relaunches=model.routed_relaunches - relaunches0,
               replays_per_block=replays / max(blocks, 1),
               shard_launches=(model.shard_launches - shard0).tolist())
    if mode == "graphs" and replays != blocks:
        raise AssertionError(f"{what} [{mode}]: {replays} replays for {blocks} routed blocks")
    if min(out["shard_launches"]) <= 0:
        raise AssertionError(f"{what} [{mode}]: {kernel} did not launch on every shard: "
                             f"{out['shard_launches']}")
    log(f"{what} [{mode}]: {blocks} routed blocks, {out['relaunches']} relaunches, "
        f"{out['replays_per_block']:.3f} replays a block, {kernel} per shard "
        f"{out['shard_launches']}, on {card}")
    return out


def routed_syncs(s, iid: str, q: np.ndarray, model, what: str) -> dict:
    """h.4: ``q`` served with DFT_XFERCHECK=1: no implicit sync, and the
    designed syncs are exactly one ``program query upload`` and one
    ``program result fetch`` a routed block."""
    from distributed_faiss_tpu_torch.utils import xfercheck

    xfercheck.reset()
    launches0 = model.launches
    try:
        with env_set("DFT_XFERCHECK", "1"):
            serve_queries(s.client, q, iid, 100, 8)
        violations, sites = xfercheck.drain(), xfercheck.syncs()
    finally:
        xfercheck.reset()
    blocks = model.launches - launches0
    by_reason = {}
    for site, n in sites.items():
        reason = site.split(" (")[0]
        by_reason[reason] = by_reason.get(reason, 0) + n
    if violations:
        raise AssertionError(f"{what}: implicit syncs under xfercheck: {violations[:3]}")
    if by_reason != {"program query upload": blocks, "program result fetch": blocks}:
        raise AssertionError(f"{what}: designed syncs {by_reason} for {blocks} routed blocks")
    log(f"{what}: under xfercheck {blocks} routed blocks, {by_reason['program query upload']} "
        f"uploads and {by_reason['program result fetch']} fetches, no implicit sync")
    return dict(blocks=blocks, **by_reason)


def routed_arm(args, s, counters, iid: str, q_all: np.ndarray, card: str, what: str, model,
               kernel: str) -> dict:
    """h.4: the same index at nprobe 32, masked, then probe-routed (the
    served model's mode switched in place) with its captured programs and
    inside ``programs.eager()``: each mode's QPS and p50/p99, one replay a
    routed block, no capture in a timed window, the masked top-10 ids on
    the tie-free queries (and eager's), one upload and one fetch a block
    under xfercheck, each routed capture registered and within its budget,
    the model's programs and graph pool."""
    from distributed_faiss_tpu_torch.utils import compilecheck, jitreg

    q_eval = q_all[:1000]
    s.client.set_nprobe(iid, 32)
    Dm, Mm = s.client.search(q_eval, 11, iid)
    masked = arm(args, s, counters, iid, q_all, 32, card, f"{what} (masked)", model, kernel)
    model.probe_routing = True
    compilecheck.reset()
    compilecheck.install()
    try:
        modes = {mode: routed_mode(s, iid, q_all, counters, kernel, mode, card, what, model)
                 for mode in ("graphs", "eager")}
        g, e = modes["graphs"], modes["eager"]
        share = same_top10(Dm, Mm, g["D"][:1000], g["M"][:1000],
                           f"{what}: routed (graphs) vs masked at nprobe=32")
        same_top10(g.pop("D"), g.pop("M"), e.pop("D"), e.pop("M"),
                   f"{what}: routed graphs against programs.eager()", min_share=0.5)
        syncs = routed_syncs(s, iid, q_all[:2000], model, what)
        captured = compilecheck.by_entry()
        unregistered = compilecheck.unregistered()
    finally:
        compilecheck.uninstall()
        compilecheck.reset()
        model.probe_routing = False
    name = ROUTED_PROGRAMS[type(model).__name__]
    budget = jitreg.row_of(name)["budget"]
    if unregistered or not 0 < captured.get(name, 0) <= budget:
        raise AssertionError(f"{what}: captures {captured} (unregistered {unregistered}); "
                             f"{name} may capture 1..{budget}")
    programs = log_programs(s, iid, what)
    log(f"{what}: graphs {g['qps']:.1f} QPS (p50 {g['p50_ms']:.3f} / p99 {g['p99_ms']:.3f} ms) "
        f"against eager {e['qps']:.1f} QPS (p50 {e['p50_ms']:.3f} / p99 {e['p99_ms']:.3f} ms): "
        f"{g['qps'] / e['qps']:.4f}x; {name} captured {captured[name]} of its budget "
        f"{budget}; graph pool {programs['pool_bytes']} bytes, on {card}")
    return dict(graphs=g, eager=e, tie_free_share=share, masked=masked, syncs=syncs,
                captures=captured, programs=programs)


# each routed model's program (utils/jitreg.py)
ROUTED_PROGRAMS = {"ShardedIVFFlatIndex": "sharded_ivf_flat.routed",
                   "ShardedIVFPQIndex": "sharded_ivf_pq.routed"}
SKEW_ROWS, SKEW_LISTS, SKEW_NPROBE, SKEW_BLOCK = 4096, 64, 8, 256


def skew_arm(card: str, counters) -> dict:
    """h.4's skew arm: on MESH_SHARDS virtual shards, every row in list 0
    and shard 0's lists (l % S == 0) the nearest to every query, so shard
    0 owns every pair. The first SKEW_BLOCK-row search relaunches at grown
    pair buckets; it answers as the exact scan on the tie-free queries;
    then the remaining searches capture nothing and relaunch no more."""
    from distributed_faiss_tpu_torch.models.flat import FlatIndex
    from distributed_faiss_tpu_torch.parallel import mesh
    from distributed_faiss_tpu_torch.utils import compilecheck

    what, d = "h.4 skew arm", 128
    rng = np.random.default_rng(4242)
    base = rng.standard_normal(d).astype(np.float32)
    cents = base + 60.0 * rng.standard_normal((SKEW_LISTS, d)).astype(np.float32)
    cents[::MESH_SHARDS] = base + 3.0 * rng.standard_normal(
        (SKEW_LISTS // MESH_SHARDS, d)).astype(np.float32)
    cents[0] = base
    x = base + 0.5 * rng.standard_normal((SKEW_ROWS, d)).astype(np.float32)
    q = base + 0.5 * rng.standard_normal((8 * SKEW_BLOCK, d)).astype(np.float32)
    model = mesh.ShardedIVFFlatIndex(d, SKEW_LISTS, "l2", mesh=mesh.make_mesh(
        MESH_SHARDS, device="cuda", virtual=True), probe_routing=True)
    model.centroids = torch.as_tensor(cents, device="cuda")
    model.lists = model._make_lists()
    model.add(x)
    model.set_nprobe(SKEW_NPROBE)
    if int(model.lists.sizes_host[0]) != SKEW_ROWS:
        raise AssertionError(f"{what}: list 0 holds {model.lists.sizes_host[0]} rows")
    zero_counts(counters)
    D, I = model.search(q[:SKEW_BLOCK], 11)
    first = dict(launches=model.launches, relaunches=model.routed_relaunches,
                 captures=model.program_stats()["captures"], slack=model._routed_slack)
    if first["relaunches"] < 1 or first["captures"] != first["launches"]:
        raise AssertionError(f"{what}: the first search: {first}")
    exact = FlatIndex(d, "l2", device="cuda")
    exact.add(x)
    De, Ie = exact.search(q[:SKEW_BLOCK], 11)
    del exact
    meta = lambda ids: [[(int(i),) for i in row] for row in ids]
    share = same_top10(De, meta(Ie), D, meta(I), f"{what}: routed vs the exact scan")
    compilecheck.install()
    snap, st0 = compilecheck.snapshot(), model.program_stats()
    launches0, relaunches0 = model.launches, model.routed_relaunches
    try:
        t0 = time.perf_counter()
        for s0 in range(SKEW_BLOCK, q.shape[0], SKEW_BLOCK):
            Dr, Ir = model.search(q[s0:s0 + SKEW_BLOCK], 11)
            check_result(Dr, meta(Ir), SKEW_BLOCK, 11, f"{what} search")
        wall = time.perf_counter() - t0
        captured = compilecheck.new_since(snap)
    finally:
        compilecheck.uninstall()
    st1 = model.program_stats()
    steady = dict(searches=q.shape[0] // SKEW_BLOCK - 1, launches=model.launches - launches0,
                  relaunches=model.routed_relaunches - relaunches0,
                  replays=st1["replays"] - st0["replays"], captures=captured, wall_s=wall)
    if captured or steady["relaunches"] or steady["replays"] != steady["launches"]:
        raise AssertionError(f"{what}: the steady searches: {steady}")
    counts = read_counts(counters)
    if counts["K1"] <= 0:
        raise AssertionError(f"{what}: K1 was not launched")
    log(f"{what}: {SKEW_ROWS} rows in list 0 of {SKEW_LISTS} on {MESH_SHARDS} shards, nprobe "
        f"{SKEW_NPROBE}: the first {SKEW_BLOCK}-row search {first}; then {steady}; K1 "
        f"{counts['K1']} launches; pool {st1['pool_bytes']} bytes, on {card}")
    out = dict(first=first, steady=steady, tie_free_share=share, k1=counts["K1"],
               pool_bytes=st1["pool_bytes"])
    model.release_programs()
    del model
    torch.cuda.empty_cache()
    return out


def mesh_phase(args, sq: dict, pq: dict, counters, card: str) -> dict:
    """Phase h: the mesh on the card, MESH_SHARDS virtual shards on the one
    card (``mesh_devices``/``mesh_virtual`` in each cfg, DFT_MESH_DEVICES and
    DFT_MESH_VIRTUAL for the restores) through a port IndexServer and
    IndexClient (see the module docstring)."""
    from distributed_faiss_tpu_torch.engine import Index
    from distributed_faiss_tpu_torch.models.flat import FlatIndex
    from distributed_faiss_tpu_torch.parallel import mesh
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    mesh_kw = dict(mesh_devices=MESH_SHARDS, mesh_virtual=True)
    out = {}
    with env_set("DFT_MESH_DEVICES", str(MESH_SHARDS)), env_set("DFT_MESH_VIRTUAL", "1"), \
            Serving(os.path.join(REPO, "build", "chip_smoke_mesh")) as s:
        # ---- h.1: ivf_tpu over phase 3's corpus ----
        x, q_all, gt = sq["x"], sq["q_all"], sq["gt"]
        q_eval = q_all[:1000]
        d = x.shape[1]
        what, iid = "h.1 ivf_tpu", "ivf_tpu"
        cfg = IndexCfg(index_builder_type="ivf_tpu", dim=d, metric="l2", train_num=100_000,
                       centroids=1024, nprobe=32, **mesh_kw)
        t0 = time.perf_counter()
        build_index(s.client, iid, cfg, x, what)
        model1 = s.server.indexes[iid].model
        if type(model1) is not mesh.IvfTpuIndex or model1.mesh.size != MESH_SHARDS:
            raise AssertionError(f"{what}: served {type(model1).__name__} on {model1.mesh}")
        nprobe, _ = sweep_nprobe(s.client, iid, q_eval, gt, args.nprobe_from, 1024, what)
        out["h.1"] = arm(args, s, counters, iid, q_all, nprobe, card, what, model1, "K1", gt)
        out["h.1"]["build_s"] = time.perf_counter() - t0

        # ---- h.2: the same lists and centroids, sharded (masked) ----
        what, iid2 = "h.2 ivf_tpu shard_lists (masked)", "ivf_tpu_sharded"
        t0 = time.perf_counter()
        snap = s.server.indexes[iid].export_snapshot()
        cfg2 = IndexCfg(index_builder_type="ivf_tpu", dim=d, metric="l2", train_num=100_000,
                        centroids=1024, nprobe=nprobe, shard_lists=True, probe_routing=False,
                        **mesh_kw)
        snap.update(state=dict(snap["state"], kind="sharded_ivf_flat", probe_routing=False),
                    cfg_json=cfg2.to_json_string())
        Index.import_snapshot(snap, os.path.join(s.store, iid2, "0"), device="cuda").retire()
        del snap
        torch.cuda.empty_cache()
        if not s.client.load_index(iid2):
            raise AssertionError(f"{what}: load_index failed")
        model2 = s.server.indexes[iid2].model
        if type(model2) is not mesh.ShardedIVFFlatIndex or model2.mesh.size != MESH_SHARDS:
            raise AssertionError(f"{what}: served {type(model2).__name__}")
        log(f"{what}: h.1's snapshot as kind sharded_ivf_flat committed and loaded in "
            f"{time.perf_counter() - t0:.2f} s; list sizes per shard "
            f"{[int(z.sum()) for z in model2.lists.sizes]}")
        s.client.set_nprobe(iid, nprobe)
        s.client.set_nprobe(iid2, nprobe)
        D1, M1 = s.client.search(q_eval, 11, iid)
        D2, M2 = s.client.search(q_eval, 11, iid2)
        share = same_top10(D1, M1, D2, M2, f"{what} vs h.1 at nprobe={nprobe}")
        out["h.2"] = arm(args, s, counters, iid2, q_all, nprobe, card, what, model2, "K1", gt)
        out["h.2"]["tie_free_share"] = share
        out["h.4 ivf_tpu"] = routed_arm(args, s, counters, iid2, q_all, card,
                                        "h.4 routed ivf_tpu shard_lists", model2, "K1")
        out["h.7 K1"] = shard_kernel_checks(model2, q_all[:1024], "K1")
        del model1, model2
        for i in (iid, iid2):
            s.client.drop_index(i)
        torch.cuda.empty_cache()
        out["h.4 skew"] = skew_arm(card, counters)

        # ---- h.5: flat with mesh_shards over phase 3's first 200,000 rows ----
        what, iid5 = "h.5 flat mesh_shards", "flat_mesh"
        x5 = x[:HNSW_N]
        cfg5 = IndexCfg(index_builder_type="flat", dim=d, metric="l2", train_num=1000,
                        mesh_shards=True, **mesh_kw)
        build_index(s.client, iid5, cfg5, x5, what)
        model5 = s.server.indexes[iid5].model
        if type(model5) is not mesh.ShardedFlatIndex or model5.nshards != MESH_SHARDS:
            raise AssertionError(f"{what}: served {type(model5).__name__}")
        D5, M5 = s.client.search(q_eval, 11, iid5)
        exact = FlatIndex(d, "l2", device="cuda")
        exact.add(x5)
        De, Ie = exact.search(q_eval, 11)
        del exact
        share = same_top10(De, [[(int(i),) for i in row] for row in Ie], D5, M5,
                           f"{what} vs the single-device exact FlatIndex")
        launches0 = model5.launches
        out["h.5"] = arm(args, s, counters, iid5, q_all, 1, card, what, model5, None)
        out["h.5"].update(tie_free_share=share, model_launches=model5.launches - launches0)
        del model5
        s.client.drop_index(iid5)
        torch.cuda.empty_cache()

        # ---- h.3: knnlm with shard_lists over phase 4's rows ----
        x3, q3_all, gt3 = pq["x"], pq["q_all"], pq["gt"]
        what, iid3 = "h.3 knnlm shard_lists (masked)", "knnlm_sharded"
        cfg3 = IndexCfg(index_builder_type="knnlm", dim=x3.shape[1], metric="l2",
                        centroids=4096, train_num=100_000, nprobe=32, code_size=64,
                        pallas_adc=True, adc_lut_bf16=True, refine_k_factor=8,
                        shard_lists=True, probe_routing=False, **mesh_kw)
        t0 = time.perf_counter()
        build_index(s.client, iid3, cfg3, x3, what)
        model3 = s.server.indexes[iid3].model
        if type(model3) is not mesh.ShardedIVFPQIndex or model3.mesh.size != MESH_SHARDS:
            raise AssertionError(f"{what}: served {type(model3).__name__}")
        nprobe3, _ = sweep_nprobe(s.client, iid3, q3_all[:1000], gt3, args.nprobe_from, 4096,
                                  what)
        out["h.3"] = arm(args, s, counters, iid3, q3_all, nprobe3, card, what, model3,
                         "K3 lists", gt3)
        out["h.3"]["build_s"] = time.perf_counter() - t0
        if out["h.3"]["counts"]["K2"] or out["h.3"]["counts"]["K4"]:
            raise AssertionError(f"{what}: K2 or K4 launched on a path whose geometry is K3's")
        out["h.4 knnlm"] = routed_arm(args, s, counters, iid3, q3_all, card,
                                      "h.4 routed knnlm shard_lists", model3, "K3 lists")
        out["h.7 K3 lists"] = shard_kernel_checks(model3, q3_all[:1024], "K3 lists")
        del model3

        # ---- h.6: deletes, then save -> drop -> load ----
        what = "h.6 knnlm shard_lists deletes"
        s.client.set_nprobe(iid3, nprobe3)
        dead = np.arange(0, x3.shape[0], 10)
        t0 = time.perf_counter()
        removed = s.client.remove_ids(iid3, dead.tolist())
        remove_s = time.perf_counter() - t0
        if removed != dead.size:
            raise AssertionError(f"{what}: remove_ids tombstoned {removed} rows, not {dead.size}")
        D6, M6 = s.client.search(q3_all[:1000], 10, iid3)
        check_result(D6, M6, 1000, 10, f"{what} search")
        if served_ids(M6) & set(dead.tolist()):
            raise AssertionError(f"{what}: a deleted id was served")
        log(f"{what}: remove_ids of {dead.size} ids in {remove_s:.3f} s; no deleted id served")
        save_drop_load(s.client, iid3, q3_all[:1000], nprobe3, what)
        loaded = s.server.indexes[iid3].model
        if type(loaded) is not mesh.ShardedIVFPQIndex or loaded.mesh.size != MESH_SHARDS:
            raise AssertionError(f"{what}: reloaded as {type(loaded).__name__}")
        out["h.6"] = dict(removed=int(removed), remove_s=remove_s)
        del loaded
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase i

# the witness knobs of phase i.2, set in the child's environment before it
# imports the port
WITNESS_KNOBS = ("DFT_LOCKDEP", "DFT_RACECHECK", "DFT_THREADCHECK", "DFT_XFERCHECK",
                 "DFT_COMPILECHECK")
# phase 3's and phase 4's committed storage dirs (hard links, taken right
# after their save), their queries and served ids, for phase i's children
WITNESS_DIR = os.path.join(REPO, "build", "chip_smoke_witness")
WITNESS_TIMEOUT_S = 600
# i.4's arms, in order: the per-call witnesses alone on one server between
# two runs with none, then the witnesses that act at construction, each on
# a server made under its knob (racecheck turns lockdep's factories on too)
READING_ARMS_SHARED = ("none", "xfercheck", "sanitize", "none")
READING_ARMS_FRESH = ("lockdep", "racecheck")


def served_id_array(meta_per_request) -> np.ndarray:
    """(nq, 10) int64 ids of the served rows' metadata ``(row,)``, -1 where a
    slot is empty."""
    rows = [row for req in meta_per_request for row in req]
    return np.asarray([[m[0] if m is not None else -1 for m in row] for row in rows],
                      np.int64)


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def keep_for_witness(s, iid: str, name: str, q_all: np.ndarray, meta, nprobe: int) -> None:
    """Right after a path's save: link its committed storage dir (every
    later write replaces files whole, so the links keep this generation),
    and keep its queries and the ids it served them for phase i."""
    dst = os.path.join(WITNESS_DIR, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(s.store, iid), os.path.join(dst, "store", iid),
                    copy_function=_link_or_copy)
    np.savez(os.path.join(dst, "served.npz"), q=q_all, ids=served_id_array(meta))
    with open(os.path.join(dst, "path.json"), "w") as f:
        json.dump({"iid": iid, "nprobe": int(nprobe)}, f)


def witnessed_path(name: str, mode: str) -> dict:
    """A fresh server over a kept storage dir, its index loaded at the path's
    nprobe: dict(serving, iid, nprobe, q, ids)."""
    src = os.path.join(WITNESS_DIR, name)
    with open(os.path.join(src, "path.json")) as f:
        spec = json.load(f)
    kept = np.load(os.path.join(src, "served.npz"))
    t0 = time.perf_counter()
    s = Serving(os.path.join(src, f"serve-{mode}"), store=os.path.join(src, "store"))
    try:
        if not s.client.load_index(spec["iid"]):
            raise AssertionError(f"phase i {name}: load_index of the kept storage dir failed")
        s.client.set_nprobe(spec["iid"], spec["nprobe"])
    except BaseException:
        s.close()
        raise
    log(f"phase i {name}: loaded in {time.perf_counter() - t0:.2f} s, nprobe {spec['nprobe']}")
    return dict(serving=s, iid=spec["iid"], nprobe=spec["nprobe"], q=kept["q"],
                ids=kept["ids"], name=name)


def serve_same_ids(p: dict, card: str, what: str):
    """``--nq`` queries of the kept path, timed; the ids must be the ones the
    parent's phase 3 or 4 served for them. Returns (QPS, p50, p99)."""
    qps, p50, p99, meta = timed_serve(p["serving"].client, p["q"], p["iid"], what, card)
    got = served_id_array(meta)
    if not np.array_equal(got, p["ids"]):
        bad = int((got != p["ids"]).any(axis=1).sum())
        raise AssertionError(f"{what}: {bad} of {got.shape[0]} queries served other ids "
                             "than the parent's phase")
    return qps, p50, p99


def windows(p: dict) -> int:
    stats = p["serving"].server.scheduler.perf_stats()
    return stats["counters"]["batches"]


def acyclic(edges) -> bool:
    graph = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    state = {}

    def visit(n):
        state[n] = 1
        for m in graph.get(n, ()):
            if state.get(m) == 1 or (m not in state and not visit(m)):
                return False
        state[n] = 2
        return True

    return all(n in state or visit(n) for n in list(graph))


def doctored_sync(xfercheck) -> dict:
    """i.1: ``.item()`` inside guarded() on a worker raises, naming the label
    and this file's line; inside explicit(), and on an unguarded thread
    while the guard is armed, it passes."""
    x = torch.ones(8, device="cuda")
    armed, other_done = threading.Event(), threading.Event()
    box = {}

    def unguarded():
        armed.wait(30.0)
        try:
            box["other"] = x.sum().item()
        except BaseException as e:  # checked below
            box["other_err"] = repr(e)
        other_done.set()

    def guarded():
        try:
            with xfercheck.guarded("doctored"):
                box["mode"] = torch.cuda.get_sync_debug_mode()
                armed.set()
                other_done.wait(30.0)
                with xfercheck.explicit("doctored fetch"):
                    box["explicit"] = x.sum().item()
                x.sum().item()
        except xfercheck.ImplicitTransferError as e:
            box["err"] = str(e)

    ts = [threading.Thread(target=guarded, name="smoke-doctored-guarded"),
          threading.Thread(target=unguarded, name="smoke-doctored-free")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60.0)
    err = box.get("err", "")
    if (box.get("other") != 8.0 or box.get("explicit") != 8.0 or box.get("mode") != 1
            or "'doctored'" not in err or "chip_smoke.py:" not in err):
        raise AssertionError(f"i.1: the doctored sync was not caught as expected: {box}")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("i.1: the sync debug mode was not restored")
    leaks = xfercheck.drain()
    if len(leaks) != 1:
        raise AssertionError(f"i.1: {len(leaks)} recorded violations, expected the one")
    xfercheck.reset()
    site = re.search(r" at (\S+:\d+): ", err).group(1)
    log(f"i.1 xfercheck: .item() in guarded('doctored') raised ImplicitTransferError at "
        f"{site}; inside explicit() and on an unguarded thread it passed")
    return {"raised_at": site}


def doctored_operands(sq: dict, pq: dict, sanitize, counters) -> dict:
    """i.1: under GRAFT_SANITIZE=1 an li of nlist and a size of cap + 1 to K1
    and K3 over the lists, and codes past ksub or of another width to K2
    and K4, raise SanitizeError before any launch; then a correct K1
    launch matches its plain version (the CUDA context is intact)."""
    from distributed_faiss_tpu_torch.models import ivf
    from distributed_faiss_tpu_torch.ops import adc_scan, flat_scan

    sm = sq["serving"].server.indexes[sq["iid"]].model
    pm = pq["serving"].server.indexes[pq["iid"]].model
    qb = torch.as_tensor(sq["q"][:64], device="cuda")
    li = ivf._probe_groups(sm.centroids, qb, 1, 1, "l2")[0].contiguous()
    sizes = sm.lists.sizes[li.long()].contiguous()
    opts = sm._scan_options()
    nlist, cap = sm.lists.data.shape[0], sm.lists.data.shape[1]
    pli = ivf._probe_groups(pm.centroids, torch.as_tensor(pq["q"][:64], device="cuda"),
                            1, 1, "l2")[0].contiguous()
    psizes = pm.lists.sizes[pli.long()].contiguous()
    lut = torch.zeros((64, pm.m, 256), dtype=torch.bfloat16, device="cuda")
    pnlist, pcap = pm.lists.data.shape[0], pm.lists.data.shape[1]

    def k1(li_, sizes_):
        return flat_scan.flat_list_scan(qb, sm.lists.data, sm.lists.ids, li_, sizes_,
                                        metric="l2", codec=sm.codec, **opts)

    def k3(li_, sizes_):
        return adc_scan.adc_scan_lists(lut, pm.lists.data, li_, sizes_, pm.lists.ids)

    small_lut = torch.randn(8, 12, 16, device="cuda")
    codes = torch.randint(0, 16, (8, 40, 12), dtype=torch.uint8, device="cuda")
    past = codes.clone()
    past.view(-1)[7] = 16
    cases = {
        "K1 li=nlist": lambda: k1(torch.full_like(li, nlist), sizes),
        "K1 sizes=cap+1": lambda: k1(li, torch.full_like(sizes, cap + 1)),
        "K3 lists li=nlist": lambda: k3(torch.full_like(pli, pnlist), psizes),
        "K3 lists sizes=cap+1": lambda: k3(pli, torch.full_like(psizes, pcap + 1)),
        "K2 code=ksub": lambda: adc_scan.adc_scan(small_lut, past),
        "K2 codes of another m": lambda: adc_scan.adc_scan(small_lut,
                                                           codes[..., :11].contiguous()),
        "K4 code=ksub": lambda: adc_scan.adc_scan_shared(small_lut, past[0].contiguous()),
        "K4 codes of another m": lambda: adc_scan.adc_scan_shared(
            small_lut, codes[0, :, :11].contiguous()),
    }
    os.environ["GRAFT_SANITIZE"] = "1"
    try:
        zero_counts(counters)
        caught = {}
        for name, call in cases.items():
            try:
                call()
            except sanitize.SanitizeError as e:
                caught[name] = str(e)
                continue
            raise AssertionError(f"i.1: {name} reached the kernel under GRAFT_SANITIZE=1")
        torch.cuda.synchronize()
        launched = read_counts(counters)
        if any(launched.values()):
            raise AssertionError(f"i.1: a sanitized bad operand launched a kernel: {launched}")
        got = k1(li, sizes)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("GRAFT_SANITIZE", None)
    want = flat_scan.flat_list_scan_plain(qb, sm.lists.data, sm.lists.ids, li, sizes,
                                          metric="l2", codec=sm.codec, **opts)
    err = compare_scores(got, want, 1e-4, 1e-4, "i.1 K1 after the sanitizer cases")
    log(f"i.1 sanitize: {len(caught)} bad operands raised SanitizeError with no launch ("
        + "; ".join(caught) + f"); a correct K1 launch then matched its plain version, max "
        f"abs err {err:.3g}")
    return {"caught": sorted(caught), "k1_after_max_abs_err": err}


def doctored_nan(paths, sanitize) -> dict:
    """i.1: under GRAFT_SANITIZE=1 a NaN query fails its own request, and
    the rank goes on serving the kept ids."""
    out = {}
    os.environ["GRAFT_SANITIZE"] = "1"
    try:
        for p in paths:
            q = p["q"][:100].copy()
            q[3, 5] = np.nan
            try:
                p["serving"].client.search(q, 10, p["iid"])
            except Exception as e:  # the rank's SanitizeError, carried by the rpc error
                if "SanitizeError" not in repr(e) and "NaN" not in str(e):
                    raise AssertionError(f"i.1 {p['name']}: the NaN query failed "
                                         f"otherwise: {e!r}") from e
                out[p["name"]] = type(e).__name__
            else:
                raise AssertionError(f"i.1 {p['name']}: a NaN query was served")
            _, meta = p["serving"].client.search(p["q"][:100], 10, p["iid"])
            if not np.array_equal(served_id_array([meta]), p["ids"][:100]):
                raise AssertionError(f"i.1 {p['name']}: the rank served other ids after the "
                                     "NaN query")
    finally:
        os.environ.pop("GRAFT_SANITIZE", None)
    log(f"i.1 sanitize: a NaN query failed its request alone on each index ({out}); "
        "the next request served the kept ids")
    return out


def doctored_abba(lockdep) -> str:
    a, b = lockdep.lock("smoke.a"), lockdep.lock("smoke.b")
    with a:
        with b:
            pass
    with b:
        try:
            a.acquire()
        except lockdep.LockOrderError as e:
            msg = str(e)
        else:
            a.release()
            raise AssertionError("i.1: an ABBA order on two lockdep locks did not raise")
    lockdep.reset()
    log("i.1 lockdep: an ABBA order on two lockdep.lock()s raised LockOrderError")
    return msg.split(" (at ")[0]


def witness_checks(args, card: str) -> dict:
    """Phase i.1-i.3, in a child with every witness knob set before the port
    was imported (the module docstring)."""
    from distributed_faiss_tpu_torch.ops import adc_scan, flat_scan
    from distributed_faiss_tpu_torch.utils import (compilecheck, lockdep, racecheck,
                                                   sanitize, threadcheck, xfercheck)

    missing = [k for k in WITNESS_KNOBS if os.environ.get(k) != "1"]
    if missing:
        raise AssertionError(f"phase i checks: knobs not set: {missing}")
    threadcheck.install()
    racecheck.install()
    compilecheck.install()
    counters = launch_counters(flat_scan, adc_scan)
    threads0 = threadcheck.snapshot()
    out = {}
    paths = []
    try:
        for name in ("ivfsq", "knnlm"):
            paths.append(witnessed_path(name, "checks"))
        for p in paths:
            serve_queries(p["serving"].client, p["q"][:1000], p["iid"], 100, 8)  # warm
        sq, pq = paths
        out["i.1"] = dict(xfercheck=doctored_sync(xfercheck),
                          sanitize=doctored_operands(sq, pq, sanitize, counters),
                          nan=doctored_nan(paths, sanitize), lockdep=doctored_abba(lockdep))
        if racecheck.drain():
            raise AssertionError("i.1: racecheck recorded a race in the doctored cases")
        snap = compilecheck.snapshot()
        log(f"i.2: compilecheck after warm-up: {snap}")
        out["i.2"] = {}
        for p, kernel in ((sq, "K1"), (pq, "K3 lists")):
            what = f"i.2 {p['name']} witnessed"
            xfercheck.reset()
            w0 = windows(p)
            zero_counts(counters)
            qps, p50, p99 = serve_same_ids(p, card, what)
            counts = read_counts(counters)
            n_windows = windows(p) - w0
            syncs = {site: n / n_windows for site, n in sorted(xfercheck.syncs().items())}
            races, leaks = racecheck.drain(), xfercheck.drain()
            if races or leaks:
                raise AssertionError(f"{what}: {len(races)} races, {len(leaks)} implicit "
                                     f"syncs:\n" + "\n".join(races + leaks))
            if counts[kernel] <= 0:
                raise AssertionError(f"{what}: {kernel} was not launched: {counts}")
            log(f"{what}: 0 races, 0 implicit syncs in the guarded sections, launches "
                f"{counts}, {n_windows} windows; designed syncs a window:")
            for site, n in syncs.items():
                log(f"    {n:.3f}  {site}")
            out["i.2"][p["name"]] = dict(qps=qps, p50_ms=p50, p99_ms=p99, counts=counts,
                                         windows=n_windows, syncs_per_window=syncs)
        edges = set(lockdep.edges())
        if not acyclic(edges):
            raise AssertionError(f"i.2: the lock-order graph has a cycle: {sorted(edges)}")
        log(f"i.2 lockdep: {len(edges)} acquisition edges, acyclic, no LockOrderError")
        out["i.2"]["lock_edges"] = sorted(f"{a} -> {b}" for a, b in edges)
        os.environ["GRAFT_SANITIZE"] = "1"
        try:
            out["i.3"] = {}
            for p in paths:
                qps, p50, p99 = serve_same_ids(p, card, f"i.3 {p['name']} GRAFT_SANITIZE=1")
                out["i.3"][p["name"]] = dict(qps=qps, p50_ms=p50, p99_ms=p99)
        finally:
            os.environ.pop("GRAFT_SANITIZE", None)
        new = compilecheck.new_since(snap)
        # a window whose bucket the warm-up did not meet captures its
        # program: a capture, not a build or a load, logged apart
        captured = {n: c for n, c in new.items() if n.startswith("capture:")}
        built = {n: c for n, c in new.items() if n not in captured}
        races, leaks = racecheck.drain(), xfercheck.drain()
        if built or races or leaks:
            raise AssertionError(f"i.2/i.3: new builds or loads {built}, {len(races)} races, "
                                 f"{len(leaks)} implicit syncs")
        log(f"i.2/i.3: no kernel built or loaded after warm-up; programs captured after it "
            f"(new window buckets): {captured}")
    finally:
        for p in paths:
            p["serving"].close()
    threadcheck.check(threads0)
    log("i.2 threadcheck: no non-daemon thread outlived the servers")
    return out


def witness_readings(args, card: str) -> dict:
    """Phase i.4: the ivfsq path served with each witness alone and with none,
    in one child that imported the port with every knob off (so the
    module-level locks stay plain in every arm). xfercheck and sanitize
    read their knob per call: their arms share one server with the two
    unwitnessed runs. lockdep's and racecheck's act when locks and
    instances are made: each gets a fresh server made under its knob."""
    from distributed_faiss_tpu_torch.utils import racecheck

    knobs = {"lockdep": "DFT_LOCKDEP", "racecheck": "DFT_RACECHECK",
             "xfercheck": "DFT_XFERCHECK", "sanitize": "GRAFT_SANITIZE"}
    readings = []

    def reading(p, arm):
        knob = knobs.get(arm)
        if knob:
            os.environ[knob] = "1"
        try:
            serve_queries(p["serving"].client, p["q"][:1000], p["iid"], 100, 8)  # warm
            qps, p50, p99 = serve_same_ids(p, card, f"i.4 ivfsq, witness: {arm}")
        finally:
            if knob:
                os.environ.pop(knob)
        readings.append(dict(arm=arm, qps=qps, p50_ms=p50, p99_ms=p99))

    p = witnessed_path("ivfsq", "readings")
    try:
        for arm in READING_ARMS_SHARED:
            reading(p, arm)
    finally:
        p["serving"].close()
    for arm in READING_ARMS_FRESH:
        os.environ[knobs[arm]] = "1"
        if arm == "racecheck":
            racecheck.install()
        try:
            p = witnessed_path("ivfsq", f"readings-{arm}")
            try:
                reading(p, arm)
            finally:
                p["serving"].close()
        finally:
            if arm == "racecheck":
                racecheck.uninstall()
            os.environ.pop(knobs[arm], None)
    base = float(np.mean([r["qps"] for r in readings if r["arm"] == "none"]))
    for r in readings:
        r["qps_over_none"] = r["qps"] / base
    log("i.4 readings (ivfsq, --nq queries, QPS over the mean of the two 'none' runs) on "
        f"{card}: " + ", ".join(f"{r['arm']} {r['qps']:.1f} ({r['qps_over_none']:.3f})"
                                for r in readings))
    return {"readings": readings}


def run_witness_child(args, mode: str, env: dict) -> dict:
    """Run one phase i child and return its result; fails when it exits
    nonzero or prints no result. Its lines are logged with a prefix."""
    cmd = [sys.executable, os.path.abspath(__file__), "--witness-child", mode,
           "--seed", str(args.seed), "--nq", str(args.nq)]
    proc = subprocess.run(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE, text=True,
                          timeout=WITNESS_TIMEOUT_S)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith("WITNESS_RESULT "):
            result = json.loads(line[len("WITNESS_RESULT "):])
        else:
            log(f"  [{mode}] {line}")
    if proc.returncode != 0 or result is None:
        raise AssertionError(f"phase i {mode} child failed: exit {proc.returncode}, "
                             f"result {'present' if result is not None else 'missing'}")
    return result


def witness_phase(args, card: str) -> dict:
    """Phase i: the witnesses on the card, in two child processes over the
    kept storage dirs of phases 3 and 4 (see the module docstring)."""
    torch.cuda.empty_cache()
    base = {k: v for k, v in os.environ.items()
            if k not in WITNESS_KNOBS + ("GRAFT_SANITIZE", "DFT_XFERCHECK_SCOPE")}
    t0 = time.perf_counter()
    checks = run_witness_child(args, "checks", dict(base, **{k: "1" for k in WITNESS_KNOBS}))
    t1 = time.perf_counter()
    readings = run_witness_child(args, "readings", base)
    log(f"phase i: checks {t1 - t0:.1f} s, readings {time.perf_counter() - t1:.1f} s")
    return dict(checks=checks, **readings)


def witness_child(args) -> int:
    """The entry of a phase i child (``--witness-child``)."""
    sys.path.insert(0, REPO)
    from distributed_faiss_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # TF32 off, as in the parent
    card = nvidia_smi_line()
    fn = {"checks": witness_checks, "readings": witness_readings}[args.witness_child]
    result = fn(args, card)
    print("WITNESS_RESULT " + json.dumps(result), flush=True)
    return 0


# ---------------------------------------------------------------- phase j

GRAPH_NPROBES = (1, 32)
DIRECT_ROWS = 4096


def windows_served(client) -> int:
    return client.get_perf_stats()[0]["scheduler"]["counters"]["batches"]


def graph_arm(s, iid: str, q: np.ndarray, counters, kernel: str, mode: str, card: str,
              what: str) -> dict:
    """One mode of a phase j cell: a warm 1000-query run, then ``q`` timed
    as 100-row requests from 8 threads (QPS, p50/p99, windows, replays and
    captures in the timed window, the kernel's launches, the pool's
    bytes), then ``q`` again at top-11 for the ids check."""
    from distributed_faiss_tpu_torch.utils import compilecheck, programs

    ctx = programs.eager() if mode == "eager" else contextlib.nullcontext()
    with ctx:
        serve_queries(s.client, q[:1000], iid, 100, 8)  # warm: the captures land here
        # a window holds whole 100-row requests, at most one a client: warm
        # every size the timed run can merge, so its buckets are all held
        engine = s.server.indexes[iid]
        for rows in range(100, 801, 100):
            engine.search_batched(q[:rows], 10)
        model = engine.model
        st0, snap, w0 = model.program_stats(), compilecheck.snapshot(), windows_served(s.client)
        zero_counts(counters)
        qps, p50, p99, _meta = timed_serve(s.client, q, iid, f"{what} [{mode}]", card)
        counts = read_counts(counters)
        windows = windows_served(s.client) - w0
        st1 = model.program_stats()
        captured = {n: c for n, c in compilecheck.new_since(snap).items()
                    if n.startswith("capture:")}
        _wall, _lat, results = serve_queries(s.client, q, iid, 100, 8, k=11)
    replays = st1["replays"] - st0["replays"]
    if counts[kernel] <= 0:
        raise AssertionError(f"{what} [{mode}]: {kernel} was not launched")
    if captured or st1["captures"] != st0["captures"]:
        raise AssertionError(f"{what} [{mode}]: captured inside the timed window: {captured}")
    if mode == "graphs" and replays < windows:
        raise AssertionError(f"{what}: {replays} replays for {windows} windows")
    if mode == "eager" and replays:
        raise AssertionError(f"{what}: {replays} replays inside programs.eager()")
    out = dict(qps=qps, p50_ms=p50, p99_ms=p99, windows=windows,
               replays_per_window=replays / max(windows, 1), launches=counts[kernel],
               captures=st1["captures"], capture_s=st1["capture_s"],
               pool_bytes=st1["pool_bytes"], programs=st1["programs"])
    log(f"{what} [{mode}]: {windows} windows, {out['replays_per_window']:.3f} replays a "
        f"window, {kernel} {counts[kernel]} launches; the model's programs so far: "
        f"{st1['programs']} held, {st1['captures']} captures in {st1['capture_s']:.3f} s, "
        f"{st1['replays']} replays, pool {st1['pool_bytes']} bytes; none captured in the "
        f"timed window, on {card}")
    out["D"] = np.concatenate([d for d, _m in results])
    out["M"] = [row for _d, m in results for row in m]
    return out


def direct_window(s, iid: str, q: np.ndarray, what: str) -> dict:
    """One direct ``engine.search`` of DIRECT_ROWS queries: after a warm
    call, one replay of the window program (its nblocks bucket) and no
    capture; the per-block path's ids on the tie-free queries."""
    from distributed_faiss_tpu_torch.models import base

    engine = s.server.indexes[iid]
    q = q[:DIRECT_ROWS]
    engine.search(q, 11)  # warm: captures the window program
    st0 = engine.model.program_stats()
    t0 = time.perf_counter()
    D, M, _ = engine.search(q, 11)
    wall = time.perf_counter() - t0
    st1 = engine.model.program_stats()
    if (st1["replays"] - st0["replays"], st1["captures"] - st0["captures"]) != (1, 0):
        raise AssertionError(f"{what}: a {DIRECT_ROWS}-row search took "
                             f"{st1['replays'] - st0['replays']} replays and "
                             f"{st1['captures'] - st0['captures']} captures, not 1 and 0")
    blocked_search = base.blocked_search

    def blocks_only(*a, fused_fn=None, **kw):
        return blocked_search(*a, **kw)

    base.blocked_search = blocks_only
    try:
        with engine.index_lock:
            Db, Ib = engine.model.search(q, 11)
    finally:
        base.blocked_search = blocked_search
    Mb = [[None if i < 0 else (int(i),) for i in row] for row in Ib]
    Mi = [[None if m is None else (m[0],) for m in row] for row in M]
    share = same_top10(D, Mi, Db, Mb, f"{what}: one {DIRECT_ROWS}-row window against the "
                       "per-block path", min_share=0.5)
    log(f"{what}: one direct {DIRECT_ROWS}-row search: 1 replay, 0 captures, "
        f"{wall * 1e3:.3f} ms of host time")
    return dict(direct_ms=wall * 1e3, direct_tie_free=share)


def graph_phase(args, sq: dict, pq: dict, counters, card: str) -> dict:
    """Phase j (module docstring): the captured programs against op by op
    on the full-width ivfsq, knnlm and PQ64,RFlat cells."""
    from distributed_faiss_tpu_torch.utils import compilecheck

    cells = [("ivfsq", sq["serving"], sq["iid"], sq["q_all"], "K1", GRAPH_NPROBES,
              sq["nprobe"]),
             ("knnlm", pq["serving"], "knnlm", pq["q_all"], "K3 lists", GRAPH_NPROBES,
              pq["nprobe"]),
             ("PQ64,RFlat", pq["serving"], "flatpq", pq["q_all"], "K4", (None,), None)]
    compilecheck.install()
    out = {}
    try:
        for what, s, iid, q, kernel, nprobes, restore in cells:
            for nprobe in nprobes:
                if nprobe is not None:
                    s.client.set_nprobe(iid, nprobe)
                cell = f"{what} nprobe={nprobe}" if nprobe is not None else what
                arms = {mode: graph_arm(s, iid, q, counters, kernel, mode, card, cell)
                        for mode in ("graphs", "eager")}
                share = same_top10(arms["graphs"].pop("D"), arms["graphs"].pop("M"),
                                   arms["eager"].pop("D"), arms["eager"].pop("M"),
                                   f"{cell}: graphs against programs.eager()", min_share=0.5)
                g, e = arms["graphs"], arms["eager"]
                log(f"{cell}: graphs {g['qps']:.1f} QPS (p50 {g['p50_ms']:.3f} / p99 "
                    f"{g['p99_ms']:.3f} ms) against eager {e['qps']:.1f} QPS (p50 "
                    f"{e['p50_ms']:.3f} / p99 {e['p99_ms']:.3f} ms): "
                    f"{g['qps'] / e['qps']:.4f}x, on {card}")
                if args.profile and nprobe != 1:
                    profile_window(s.client, q[:2000], iid)
                out[cell] = dict(arms, tie_free=share)
            out[cell].update(direct_window(s, iid, q, what))
            if restore is not None:
                s.client.set_nprobe(iid, restore)
    finally:
        compilecheck.uninstall()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000, help="rows in the ivfsq index")
    ap.add_argument("--nq", type=int, default=10_000, help="queries served on each path")
    ap.add_argument("--nprobe-from", type=int, default=1,
                    help="first nprobe of the ivfsq and knnlm recall sweeps (both cfgs "
                         "say 32)")
    ap.add_argument("--profile", action="store_true",
                    help="also serve 2000 queries on the ivfsq, knnlm and flat-PQ paths "
                         "under torch.profiler and print where the device time goes")
    # phase i's and phase l's child processes (run by the script itself)
    ap.add_argument("--witness-child", choices=("checks", "readings"), help=argparse.SUPPRESS)
    ap.add_argument("--saver-child", help=argparse.SUPPRESS)
    ap.add_argument("--trial", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.nq < 1000:
        ap.error("--nq must be >= 1000 (the recall sweeps use the first 1000)")
    if not 1 <= args.nprobe_from <= 1024:
        ap.error("--nprobe-from must be in 1..1024 (the ivfsq index has 1024 lists)")
    if not os.path.isdir(os.path.join(REPO, "distributed_faiss_tpu_torch", "csrc")):
        print(f"chip_smoke: {REPO} is not a checkout of the repo (no "
              "distributed_faiss_tpu_torch/csrc beside this script)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    if args.witness_child:
        return witness_child(args)
    if args.saver_child:
        return saver_child(args)
    sys.path.insert(0, REPO)
    from distributed_faiss_tpu_torch.models import hnsw, ivf
    from distributed_faiss_tpu_torch.ops import adc_scan, cuda_build, distance, flat_scan
    from distributed_faiss_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    shutil.rmtree(WITNESS_DIR, ignore_errors=True)
    resolve_device("cuda")  # pins TF32 off for the plain versions' matmuls
    card = nvidia_smi_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()[0]
    log(f"host compiler for the hnswsq graph: {gxx}")
    t0 = time.perf_counter()
    graph_build = {}

    def build_graph():
        t = time.perf_counter()
        try:
            graph_build["lib"] = hnsw.build_library()
        except BaseException as e:  # re-raised below, on the main thread
            graph_build["error"] = e
        graph_build["s"] = time.perf_counter() - t

    graph_thread = threading.Thread(target=build_graph, name="smoke-g++")
    graph_thread.start()
    libs = cuda_build.build()
    graph_thread.join()
    if "error" in graph_build:
        raise graph_build["error"]
    log(f"hnswsq graph library built in {graph_build['s']:.2f} s: "
        f"{os.path.relpath(graph_build['lib'], REPO)}")
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{name} -> {os.path.relpath(p, REPO)}" for name, p in libs.items()))
    for name in libs:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    variants = kernel_phase(flat_scan, distance, args.seed)
    adc_variants = adc_kernel_phase(adc_scan, args.seed)
    lists_variants = lists_kernel_phase(adc_scan, args.seed)
    shared_variants = shared_kernel_phase(adc_scan, args.seed)
    log(f"kernel phase: {len(variants)} K1 variants, {len(adc_variants)} K2/K3 cases, "
        f"{len(lists_variants)} K3-over-the-lists cases and {len(shared_variants)} K4 cases "
        f"agree with the plain version ({time.perf_counter() - t0:.1f} s)")

    counters = launch_counters(flat_scan, adc_scan)
    t0 = time.perf_counter()
    sq_out = ivfsq_path(args, counters, card)
    log(f"ivfsq path: {time.perf_counter() - t0:.1f} s")
    outs = None
    try:
        t0 = time.perf_counter()
        outs = knnlm_path(args, counters, card)
        pq_out, k2_out, flat_out = outs["knnlm"], outs["k2"], outs["flatpq"]
        log(f"knnlm, IVF1024,PQ12,RFlat, PQ64,RFlat, OPQ64,PQ64,RFlat and PQ128,RFlat "
            f"paths: {time.perf_counter() - t0:.1f} s")
        for name, phase in (("surface", lambda: surface_phase(sq_out, counters)),
                            ("wire A/B", lambda: wire_phase(sq_out, card)),
                            ("direct path", lambda: direct_phase(sq_out, counters, card)),
                            ("hnswsq", lambda: hnswsq_phase(args, sq_out, counters, card))):
            t0 = time.perf_counter()
            phase()
            log(f"{name} phase: {time.perf_counter() - t0:.1f} s")

        k1 = k1_main_shape(flat_scan, ivf, sq_out["model"], sq_out["q_block"])
        k3 = adc_main_shape(adc_scan, ivf, pq_out["model"], pq_out["q_block"], "knnlm")
        k3_lists = lists_main_shape(adc_scan, ivf, pq_out["model"], pq_out["q_block"])
        k2 = adc_main_shape(adc_scan, ivf, k2_out["model"], k2_out["q_block"],
                            "IVF1024,PQ12,RFlat")
        k4 = shared_main_shape(adc_scan, ivf, flat_out["model"], flat_out["q_block"])

        t0 = time.perf_counter()
        graph_out = graph_phase(args, sq_out, outs, counters, card)
        log(f"graph phase: {time.perf_counter() - t0:.1f} s")
        log("graph phase readings: " + json.dumps(graph_out))

        t0 = time.perf_counter()
        mutation_phase(args, sq_out, outs, counters, card)
        log(f"mutation phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        observability_phase(args, sq_out, outs, counters, card)
        log(f"observability phase: {time.perf_counter() - t0:.1f} s")
    finally:
        if outs is not None:
            outs["serving"].close()
        sq_out["serving"].close()
    for o in (sq_out, pq_out, k2_out, flat_out):
        o.pop("model", None)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    replica_out = replica_phase(args, sq_out, card)
    log(f"replica phase: {time.perf_counter() - t0:.1f} s")
    log("replica phase f.3 readings: " + json.dumps(replica_out["f3"]))
    t0 = time.perf_counter()
    saver_out = snapshot_kill_phase(args, sq_out, counters, card)
    log(f"snapshot kill phase: {time.perf_counter() - t0:.1f} s")
    log("snapshot kill phase readings: " + json.dumps(saver_out))
    t0 = time.perf_counter()
    tier_out = tier_phase(args, counters, card, cuda_build)
    log(f"tier phase: {time.perf_counter() - t0:.1f} s")
    log("tier phase readings: " + json.dumps(tier_out))
    t0 = time.perf_counter()
    mesh_out = mesh_phase(args, sq_out, outs, counters, card)
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    log("mesh phase readings: " + json.dumps(mesh_out))
    t0 = time.perf_counter()
    try:
        witness_out = witness_phase(args, card)
    finally:
        shutil.rmtree(WITNESS_DIR, ignore_errors=True)
    log(f"witness phase: {time.perf_counter() - t0:.1f} s")
    log("witness phase readings: " + json.dumps(witness_out))
    kernels = [
        dict(name="flat_list_scan", route="cuda", source=K1_SOURCE, replaces=K1_REPLACES,
             launches=sq_out["counts"]["K1"], **k1, library_ms=None),
        dict(name="adc_scan", route="cuda", source=ADC_SOURCE, replaces=K2_REPLACES,
             launches=k2_out["counts"]["K2"], **k2),
        # K3's counter counts both of its entries; this row is the gathered
        # entry alone (0 on the knnlm path, which scores over the lists)
        dict(name="adc_scan_nibble", route="cuda", source=ADC_SOURCE, replaces=K3_REPLACES,
             launches=pq_out["counts"]["K3"] - pq_out["counts"]["K3 lists"], **k3),
        dict(name="adc_scan_lists", route="cuda", source=ADC_SOURCE, replaces=K3_REPLACES,
             launches=pq_out["counts"]["K3 lists"], **k3_lists, library_ms=None),
        dict(name="adc_scan_shared", route="cuda", source=ADC_SOURCE, replaces=K4_REPLACES,
             launches=flat_out["counts"]["K4"], **k4),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
