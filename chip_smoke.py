#!/usr/bin/env python3
"""Smoke test of dmlc_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's main path at full width, from the sources in this
checkout, and fails (non-zero exit, no result line) on any fault:

1. environment: needs ``torch.cuda.is_available()``; prints the card's
   name and power limit as nvidia-smi reports them;
2. build: the CUDA kernels (nvcc, sm_90a) and the native parse engine
   (g++), at once, each timed;
3. kernels: K1 ``csr_spmv`` and K2 ``csr_spmv_t`` against their plain
   PyTorch versions at the main path's shapes, edge cases included
   (empty rows, a padded tail, an index at F-1, an out-of-range index, a
   u64 index), with times beside their bound and a library call's (K2
   and its zero fill apart); K1 there through its half route (16 lanes a
   row) and, with the bucket grown past 64 a row, its warp route, and
   through both on a batch of rows of 0-1000 nonzeros (ROW_LENGTHS);
   K2 also on a narrow model's edge batch (137
   weights, rows of indices 1-136 with duplicates, empty rows, an
   invalid index in the padded tail, u32 and u64 index), where it must
   take its private route, as at 10^6 weights its global one;
   then K8 (``logistic_step`` on one part; ``logistic_sums`` and
   ``logistic_grad``, the sharded step's two launches) against its plain
   versions at the first batch's labels and weights and on edge cases (a
   margin of exactly 0, {0,1} labels, an all-padded batch, 0 < W < 1,
   |m| of 88 and 3e38, a NaN margin), one part and [4, 2048]; on one part
   also at 1, 511, 513, 8181 rows and at its grid route's cap and one row
   past it, each route read from the trace (one launch of the grid, or
   the split into the sharded step's two launches); K9 (``sgd_update``)
   at l2 = 0 and 0.01 on the parameters of all four models at full width
   (FFM's 624 MB V), on a parameter one float off its allocation with its
   gradient aligned alike and apart, and by its narrow route on the
   ranking model's 137 + 1 floats, on the bias alone, on [137, 1] one
   float off its allocation and at the widest parameters it takes, with
   one unit more taking the wide route, each route read from the trace;
   each timed beside its bound, its plain version and one PyTorch call
   (``F.binary_cross_entropy_with_logits(..., reduction="sum")``,
   ``torch._foreach_add_``), K9 at the ranking width by its narrow route;
4. main path: a seeded Criteo-shaped libsvm file of about 256 MB through
   the port's ``Pipeline``, the chain bench.py builds:
   ``Pipeline.from_uri(path).parse(engine="native").batch(8192, pad=True,
   nnz_bucket=368640).to_device(cuda, window="auto")
   .build(autotune=True)`` (native parse → the engine's ABI-5 padded
   batches → pinned async H2D) → ``SparseLinearModel(1_000_000)
   .train_step`` for one epoch; the loss must fall and each kernel (K1,
   K2, K8, K9) must have launched once per step; then parse-only epochs
   through the ``Pipeline`` and through the ``device_prefetch(size=2)``
   loop this script drove before, in turns, each GB/s printed; every
   path prints
   its pipeline's stats snapshot, and every path's epochs run through
   its ``Pipeline``; one step on the first batch is traced: its launches
   and device µs by kernel; then the transfer probe
   (``dmlc_tpu_torch.bench_transfer.probe``, 3 interleaved rounds at 64
   MB a cell: the port's put, a pinned staging slot and a copy stream,
   at 1-8 MB chunks, on 2 and 4 threads, in one 64 MB put, beside a host
   memcpy), its JSON on a line;
4b. the trace plane and the split planes, right after the main path
   (profiler traces lose records late in a run): ``trace_path``, one
   training epoch of the main path's chain inside ``built.trace(json)``
   and ``cuda_trace("epoch", log_dir)``: the recorder's Chrome JSON loads,
   each stage has a ``pull/<stage>`` span per item it delivered and one
   ``pull/<stage>.end``, the engine's spans sit on the native thread
   tracks beside its counter track, ``to_device.drain`` and
   ``device.xfer`` spans a batch, the profiler's ``epoch`` span, nothing
   dropped, and the torch.profiler trace under log_dir shows K1, K2, K8
   and K9 once a step (its record counts; a trace that lost records is
   taken again, up to PROFILE_ATTEMPTS epochs); one step inside
   ``cuda_trace("step")`` under this script's profiler, whose annotation
   must cover the step's four kernels; parse-only epochs with tracing
   off and on in turns (off, on, on, off), GB/s and events recorded of
   each; then ``split_path``: each of 4 parts of the corpus through the
   plain split, a ``#cache`` URI twice (write, then replay) and
   ``ThreadedInputSplit``, the records' sha256 equal in all four passes
   and the cache entry ``.p{k}-4`` and its ``.meta.json`` stamp on disk;
   ``InputSplitShuffle(num_shuffle_parts=8, seed=7)`` over the whole
   file, the same order from two creations, the plain records as a
   multiset and another order in its second epoch; GB/s of every pass;
   then two epochs of ``SparseLinearModel(10^6)`` over the corpus's first
   32 MB through ``Pipeline.from_uri(p).shuffle(num_shuffle_parts=8,
   seed=7).parse(format="libsvm").batch(8192, pad=True,
   nnz_bucket=368640).to_device(cuda, window="auto")``: K1, K2, K8 and
   K9 once a step, the loss falling, each epoch's rows those of the
   unshuffled python chain, the two orders different, epoch 1's batches
   those of the shuffled host chain (``prefetch`` in place of
   ``to_device``; both references from a worker process, beside the
   epochs), GB/s of each epoch;
5. parity: native padded batches byte-identical to the Python parser's
   ``pad_single``; 3 steps on the card allclose to 3 steps of the plain
   CPU path;
6. the factor models' path: a seeded Criteo-shaped libfm file of about
   128 MB (33-39 of 39 fields a row); K5 (``fm_pair_fwd``/``_bwd``) and
   K6 (``ffm_pair_fwd``/``_bwd``) against their plain versions with the
   same edge cases plus fields out of range, timed beside their bounds
   (K5 backward's kernel and its zero fill apart; K5's vector route at 8
   and 40 factors, its scalar route at 3 and for a misaligned V, forward
   and backward; K5 forward also at 1-40 factors on the rows of 0-1000
   nonzeros, and timed by its scalar route; K1 held and timed at this
   batch);
   K5 and K6 also at other shapes (3 and 40 factors; 3 colliding
   fields; 60 fields, past 48 KB of shared memory; 50 fields of 6
   factors, more columns than a block's threads, rows longer than a
   staged chunk; 39 fields of 40 factors, 120 of 4 and 300 of 1, past a
   block's shared memory, through K6's global route, which is timed);
   one epoch each of ``SparseFMModel(1_000_000, num_factors=8)`` and
   ``SparseFFMModel(1_000_000, 39, num_factors=4)`` through native
   padded batches with ``field`` and pinned async H2D (the loss must
   fall, each of the model's kernels launch once a step); libfm padded
   batches byte-identical to ``pad_single``; 3 steps of each model with
   the kernels allclose to 3 through the plain versions on the card;
   ``SparseFFMModel(10^6, 39, K=4)`` (628 MB of V) saved by
   ``ShardedCheckpoint`` and restored into a fresh model on the card bit
   for bit, one step on the first libfm batch on each agreeing (K6, K8
   and K9 launching), save and restore GB/s printed;
7. the ranking path: a seeded libsvm-with-qid file of about 128 MB shaped
   like MSLR-WEB30K (136 features a row, graded labels 0-4, queries of
   1-240 documents); K7 (``pair_sums``/``pair_sums_grad``) against its
   plain versions on the path's first batch with edge cases (a padded
   tail, an all-padded batch, a query of equal labels, a query split into
   non-contiguous rows, all-zero margins, a NaN margin, a -inf margin, two
   margins of +-3e38, a NaN weight on a padded row, a weight of 2e19, one
   query over the batch, every row its own query, interleaved queries;
   the gradient also at a cotangent of inf), the share of tiles each
   block skips, and K7 timed at two batches where no tile can be skipped;
   K2 on the batch (137 weights: its private route) against its plain
   version, timed beside ``A.t() @ g``; K1 (136 a row: its warp route)
   held and timed there too; K3
   (``sdot_rows``) and K4 (``csr_to_dense``) on the same batch, each
   timed beside its bound, K4 by its tile route (no fill) and, at a
   matrix of 8192 columns, by its global route, each route read from
   the trace and both held to the plain version on an edge batch too
   (a repeated column, invalid indices, a padded tail, empty and flat
   rows, corrupt offsets, u32 and u64); one epoch of
   ``SparseRankingModel(137)`` through padded batches with ``qid`` (4096
   rows, the reference's ``max_row_bucket``): the loss must
   fall, the pairwise accuracy on the first batch rise, and K1, K2, K7
   forward and backward launch once a step; then the trained scores of
   the first batch through K3 (padded rows) and K4 (dense) must equal
   K1's; qid padded batches byte-identical to ``pad_single``; 3 steps
   with the kernels allclose to 3 through the plain versions on the card;
8. the sharded path, in this one process over a world-1 NCCL group
   (``init_from_env`` under a world-1 env, a TCP store on localhost): a
   ``Mesh`` of 4 parts on the card; three epochs of the linear corpus
   through ``Pipeline.from_uri(path).parse(engine="native").shard(mesh,
   row_bucket=8192, nnz_bucket=368640)`` into
   ``SparseLinearModel(1_000_000).make_sharded_train_step(mesh)``: the
   loss must fall, K1 and K2 launch once a part a step and K8 twice and
   K9 once a step (the launch counters, and one step's trace, whose
   launches and device µs by kernel are printed)
   and the step's all-reduces show in its trace; epoch 2 re-parses and
   tees, epoch 3 replays from memory with batches hashing equal to epoch
   1's; 3 sharded steps allclose to 3 flat ``train_step``s over the same
   rows, and 3 sharded steps of FM, FFM and ranking at their paths'
   widths allclose to the same steps through the plain versions on the
   card; ``graft.dryrun_multichip(8)`` on the card. Its steps/s, GB/s
   and the all-reduce's device time a step are printed beside the
   single-part main path's;
9. the page tier, on the linear corpus, right after the sharded path
   (the same mesh): five epochs of the sharded step through
   ``Pipeline.from_uri(path).parse(engine="native").shard(mesh,
   row_bucket=8192, nnz_bucket=368640, agreement_cache_bytes=1 << 20,
   first_epoch_cache="never", spill_dir=<work>/spill)``: epoch 1
   streams, epoch 2 re-parses and spills its rounds to a page file,
   epochs 3-5 replay the pages (tiers parse, parse, pages x 3, page
   replay epochs >= 3); every epoch's batches hash equal to epoch 1's,
   K1 and K2 launch once a part a step and K8's two launches and K9 once
   a step in every epoch, the loss falls, the page file is there while
   the store lives and gone after ``close()``, each page epoch's serve
   thread work printed in wall and thread CPU seconds, and the serve
   thread's work of a page epoch timed pass by pass over the page file
   (read; read and decode; and pad+stack; and the pad+stack into pinned
   slots with the copy to the card), 5 rounds interleaved, each led by
   the host memcpy gauge; then three
   epochs of ``SparseLinearModel(10^6).train_step`` through
   ``parse(engine="native").cache(memory_budget_bytes=0).batch(8192,
   pad=True, nnz_bucket=368640).to_device(cuda)``: every epoch served by
   pages, its batches hashing equal to the same chain's without the
   cache, K1, K2, K8 and K9 once a step, the loss falling; each epoch's
   GB/s and steps/s printed beside the memory-replay epoch and the main
   path of the run; then the checkpoint path: ``SparseLinearModel(10^6)``
   trains one epoch, is saved by ``ShardedCheckpoint`` and by
   ``save_pytree`` and restored by each into a fresh model on the card
   bit for bit, and 3 steps on each restored model match 3 on the model
   never interrupted (K1, K2, K8 and K9 launching); the FFM's 628 MB
   state saved locally and to an ``obj://`` root (the object-store
   plane's multipart writer, 8 MB parts, 4 at once) and restored to the
   card bit for bit from each (from the page store the save filled, and
   cold, over the wire), save and restore GB/s of each;
10. the RecordIO paths, over corpora of about 256 MB each written at
   the bench suite's shapes (config 3's 4 parts of 60-140 KB records,
   config 14's dense rows of 24-47 values with an escaped magic every
   251st row, config 18's 32x32x3 images, and a dense training corpus of
   config 14's rows with labels in {0, 1}): ``cuda_ingest``, the linear
   corpus through ``create_stream("cuda://...").device_chunks`` at 1, 4
   and 16 MB chunks, each chunk on the card, their checksum computed on
   the card equal to numpy's over the file, and config 3's 4 parts through
   ``recordio_device_batches`` (the native reader must serve it), every
   record read back from the card hashing as the host reader's, GB/s of
   each; ``recordio_decode``, configs 14's and 18's corpora through
   ``Pipeline.from_uri(rec).parse(format="recordio_dense" /
   "recordio_image", engine="native").batch(8192 / 256, pad=True,
   nnz_bucket=8192 * 48 / 256 * 3072).to_device(cuda)``, assembled in the
   engine, every batch on the card hashing as the host's padded batch,
   the first image batch's ``value.view(256, 32, 32, 3)`` holding the
   records' pixels; ``dense_train``, K1, K2, K8 and K9 at the dense batch
   against their plain versions (half, private, grid and narrow routes)
   and timed, then ``SparseLinearModel(48).train_step`` for one epoch of
   the training corpus through the same chain: one step agreeing with the
   plain versions' on the card, K1, K2, K8 and K9 once a step, the loss
   falling, and the final weights agreeing with an epoch through the
   plain versions; GB/s and steps/s;
10b. the format matrix (``format_path``), over a HIGGS-shaped csv of
   about 256 MB (a {0, 1} label and 28 cells of "%.6f" a row, labels
   from a seeded hidden weight vector), a sparse variant of 64 MB (30% of
   the cells exactly 0), config 5's Parquet table (a "label" and 28
   float32 columns, 128 MB in 16 row groups) and config 17's (20 float32
   columns with 10% nulls, row groups of 4000, 64 MB), both written by
   ``write_parquet`` with numpy alone (V1 PLAIN uncompressed pages,
   definition levels for the optional columns: the card's machine has
   no pyarrow), and config 6's indexed RecordIO (128 MB of 60-140 KB
   records and its ``.idx``): K1, K2, K8 and K9 at the csv batch (8192
   rows of 28 nonzeros, 28 weights and the bias) against their plain
   versions by the half, private, grid and narrow routes read from the
   trace, timed among the run's first traces beside the dense batch's;
   the csv's native padded batches byte-identical to ``pad_single`` over
   the Python ``CSVParser``, dense and sparse, and its ``shards=2``
   stream to the one-parser stream; ``SparseLinearModel(28)`` for one
   epoch through ``Pipeline.from_uri(csv).parse(format="csv",
   engine="native", label_column=0).batch(8192, pad=True,
   nnz_bucket=8192 * 28).to_device(cuda, window="auto")`` (as
   ``dense_train``: K1, K2, K8 and K9 once a step, the loss falling, the
   first step and the epoch equal to the plain versions'), parse-only
   epochs of both csvs beside it; the Parquet tables through
   ``format="parquet_native", engine="native", label_column="label"``,
   every block bit for bit the columns written (NaN at the nulls) at 1,
   2 and 4 shards (config 5's) with ``outstanding() == 0`` after each
   epoch, and config 5's table trained on for one epoch the same way;
   ``IndexedRecordIOSplit(shuffle=True, seed=11, batch_size=64)`` and
   ``NativeIndexedRecordIOReader`` giving the same records in the same
   order (config 6's digest), seeds 11 and 12 two orders of the same
   records; GB/s of each;
11. last, after every traced phase, configs 4 (``prefetch``), 7
   (``multiprocess``: two worker processes over a gloo group, each a
   mesh of 2 parts on this card), 8 (``page_replay``) and 10 (``spill_replay``, both with
   the memcpy gauge before each epoch) of ``dmlc_tpu_torch.bench_suite``
   at 256 MB over the linear corpus (linked to the name the suite reads,
   so it writes no corpus of its own), then 3 (``recordio``), 14
   (``recio_native``) and 18 (``image_record``, both gauged) over the
   RecordIO corpora, then 1 (``libsvm``, a1a-shaped, 256 MB), 2 (``csv``,
   HIGGS-shaped, dense and sparse, 256 MB) and 6 (``indexed_shuffled``,
   over format_path's indexed RecordIO, its digest equal to
   format_path's), each JSON on a line, their own checks holding
   (content hashes against a direct parse; page replay epochs >= 3;
   config 7's epochs 2-3 replayed; config 3 through the native reader,
   its records' hash equal to the host reader's in ``cuda_ingest``;
   configs 14 and 18 assembled in the engine, their native and sharded
   streams equal to the python golden's); then configs 15
   (``peer_hydrate``, a 2-process gang reading the 256 MB linear corpus
   from ``obj://`` through the peer tier) and 21
   (``ckpt_restore_fanout``, a 3-writer save under a rendezvous and a
   2-rank fanout restore of 64 MB, and the multipart leg: 48 MB up as
   8 MB parts, 8 at once, on a wire shaped to 2 ms and 0.05 GB/s, in
   ``/dev/shm`` where it exists, read back equal, at least 2x faster
   than one single-shot PUT, the reference's bar), their own checks
   holding; then configs 20 (``elastic_reshard``, a 2→3→2 gang under
   a rendezvous over 64 MB of ``obj://`` parts, resuming adopted parts
   from the committed prefix) and 23 (``global_shuffle``, a 2-process
   gang draining one seeded global order of 64 MB of RecordIO in 2 MB
   windows through the peers' ``/pages``), host-only gangs as in the
   reference, their own checks holding and at least two reshards,
   resumed bytes, gang wire at most 1.3 of the corpus (20), at least 8
   windows, peer bytes on each rank, gang wire at most 1.6 (23);
11b. the object-store plane (``remote_path``), over one on-disk
   emulator under the run's directory behind the reference's modeled
   wire (2 ms a request, 4 GB/s; 4 MB blocks, 4 coalesced, 4 GETs at
   once): config 11 (``remote_hydrate``) at 256 MB over the linear
   corpus (a cold ``obj://`` epoch of ``InputSplit`` bytes, three warm
   epochs with no GET, the codec variant at level 6 moving fewer wire
   bytes with a wire-free second epoch, every epoch's sha256 the local
   file's); ``SparseLinearModel(10^6)`` trained from ``obj://`` on the
   first 32 MB of the linear corpus cut at a line (an ``obj://`` epoch
   parses in Python) through ``Pipeline.from_uri("obj://...")
   .parse(format="libsvm").batch(8192, pad=True, nnz_bucket=368640)
   .to_device(cuda)``: a cold and a warm epoch from the same fresh model,
   their padded batches hashing as the same chain's over the local copy,
   the warm epoch with no GET, K1, K2, K8 and K9 once a step, the loss
   falling, the two epochs' weights within the step tolerance, GB/s and
   steps/s beside the local chain's; the trained model saved to
   ``obj://`` by ``ShardedCheckpoint`` and restored to the card bit for
   bit (from the page store and cold, the local and wire bytes adding
   up to the checkpoint's pages), an unchanged re-save with no page PUT,
   and 3 steps on each restored model matching 3 on the model never
   interrupted;
11c. the gang plane (``gang_path``), over a second on-disk emulator
   behind the same wire: a ``launch_local(2, ..., serve_ports=True,
   rendezvous=True)`` gang of CUDA processes (two on this card, no
   ``torch.distributed`` group between them), each rank with its own
   page store, status server and rendezvous client, reads the first
   32 MB of the linear corpus from ``obj://`` cold through the objstore
   peer tier (1 MB blocks in groups of 4, owned by rank in turn) and
   warm: each rank's wire bytes at most 0.60 of the object, peer bytes
   on both, no GET warm, every read's sha256 the local file's; each rank
   trains its own ``SparseLinearModel(10^6)`` on the parts
   ``rendezvous.elastic.assign_parts(4, world, rank)`` gives it under
   its rendezvous view (K1, K2, K8 and K9 once a step, the loss
   falling, its padded batches hashing as the local chain's over the
   same parts); rank 0 scrapes rank 1's ``/metrics`` (a valid
   exposition, ``dmlc_objstore_peer_get_total`` > 0) and ``/healthz``
   and its own ``/gang`` (``membership.world`` 2) while the gang is
   alive; the ranks save their models to ``obj://`` as one 2-writer
   ``ShardedCheckpoint`` (``meta.json`` stamped with the rendezvous
   membership); then a second 2-rank gang with fresh page stores runs
   ``prefetch``, a barrier and ``restore`` onto the card: the weights
   bit for bit the saved ones, the ranks' splits complementary (each
   page over the wire once in the gang: no local bytes, one rank's
   wire the other's peer), gang wire at most 1.3x the checkpoint, peer
   bytes > 0, and one step each through K1, K2, K8 and K9 on a batch of
   the local corpus;
11d. the global shuffle plane (``shuffle_path``), over the first 32 MB
   of the linear corpus cut at a line: ``GlobalShuffleSplit(path, 0, 1,
   "text", seed=0, window_bytes=2 MB)`` drained on the host (at least
   16 windows) gives the corpus's lines as a multiset in
   ``GlobalShuffle``'s order, its displacement against a uniform
   permutation printed, and the same order through the host chain
   (``Pipeline.from_uri(p).shuffle(global_seed=0, window_bytes=2 MB)
   .parse(format="libsvm").batch(8192, pad=True, nnz_bucket=368640)``)
   gives the world-1 rows; then a ``launch_local(2, ...,
   serve_ports=True)`` gang of CUDA processes on this card, each rank
   its own page store and status server, builds that chain as part
   ``rank`` of 2 with ``.to_device(cuda, window="auto")`` and trains
   its own ``SparseLinearModel(10^6)`` for a cold and a warm epoch: K1,
   K2, K8 and K9 once a step, the loss falling from 0.6931, peer bytes
   on each rank in the cold epoch (windows from the other rank's
   ``/pages``), no wire or peer byte in the warm epoch, the ranks' cold
   rows merged by position (position p is rank p % 2's) the world-1
   rows, the warm rows the corpus's in another order; GB/s cold and
   warm, steps/s a rank, the peer fraction and the gang's wire as a
   fraction of the 32 MB;
12. the resilience plane (``chaos_path``), after the bench configs:
   the spill linear path (the mesh of 4 parts, 1 MB replay budget; parse,
   parse and spill, pages x 3) over a directory holding the linear
   corpus, one epoch of ``cache(path=...)`` pages, and the trained model
   saved and restored by ``ShardedCheckpoint`` and ``save_pytree``, run
   once fault-free and once with CHAOS_PLAN armed (an ioerror at
   ``io.filesys.list``/``stat``, ``spill.commit``, ``data.pages.build``/
   ``commit``, ``io.stream.open``, ``io.stream.read`` on the serve
   thread's page reads, ``checkpoint.save``/``restore``): every armed
   site retried, the faults injected equal to the plan's log and the
   retries, every batch equal to the fault-free run's in order, the
   final weights within the step tolerance, the restores bit for bit,
   K1, K2, K8 and K9 once a step (a part); a page epoch with a
   ``fault=delay`` read past a ``Watchdog``'s threshold: one stall
   report naming the blocked pull and one ``FlightRecorder`` bundle;
   a gang of 2 workers (``launch_local``, each parsing its half and
   training its own ``SparseLinearModel(10^6)`` on the card) run
   fault-free and with rank 1 crashing at its third batch under a
   ``RestartPolicy``: exit codes [0, 0], one restart in the counter and
   on ``trace-gang.json``, each rank's batches and weights as the
   fault-free gang's; config 10 through ``bench_suite.main`` under
   ``--chaos`` with no ``error``; parse-only epochs with and without an
   installed watchdog, in turns.

Every kernel check holds the index rule (ROADMAP C6): indices u32
2^32-1 and 2^31 and u64 2^32+3, and in the FFM a field of 2^31, are
written into the batches, and each kernel must read them as its plain
version does.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it the kernels' JSON record (every kernel: K1-K9, K8's
three launches apart, K9 at the linear width and, by its narrow route,
at the ranking width; K1, K2, K8 and K9 again at the dense batch and at
the csv batch). Imports nothing of JAX or of the ``dmlc_tpu`` package, nor
pyarrow.
"""

import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

NUM_FEATURES = 1_000_000       # LIBSVM's criteo, as BASELINE.json names it
ROW_BUCKET = 8192              # bench.py's batch rows
NNZ_BUCKET = ROW_BUCKET * 45   # bench.py's worst-case nnz bound (< 45/row)
FILE_MB = 256                  # bench.py's default corpus size
# The factor models at the public widths: SparseFMModel's defaults over the
# Criteo feature space, and the Criteo setting of Juan et al., "Field-aware
# Factorization Machines for CTR Prediction" (RecSys 2016): 39 fields (13
# integer, 26 categorical) hashed into 10^6 features, k = 4.
FM_FACTORS = 8
FFM_FIELDS, FFM_FACTORS = 39, 4
NUMERIC_FIELDS = 13            # fields 0-12 carry a float, 13-38 carry 1
LIBFM_MB = 128
LIBFM_NNZ_BUCKET = ROW_BUCKET * 40  # at most one nonzero per field
INIT_SCALE = 0.05              # V ~ N(0, 0.05^2) in the kernel checks
# The ranking path at the shape of MSLR-WEB30K (Microsoft Learning to Rank
# Datasets): 136 features in every row, written as indices 1-136, so the
# model has 137 weights under the default indexing_mode 0; graded labels
# 0-4; queries of 1-240 documents. Batches at the reference's
# max_row_bucket.
RANK_FEATURES = 136
RANK_NUM_FEATURES = RANK_FEATURES + 1
RANK_ROW_BUCKET = 4096
RANK_NNZ_BUCKET = RANK_ROW_BUCKET * RANK_FEATURES  # 557,056
RANK_MB = 128
RANK_LEARNING_RATE = 3.0
# The index rule's edge values (ROADMAP C6): u32 2^32-1 reads the last
# entry, u32 2^31 is invalid, u64 2^32+3 reads entry 3 (a u32 copy of the
# batch holds its low 32 bits, 3, which reads the same), and a field of
# 2^31 wraps negative and reads field 0.
WRAP_LAST, WRAP_BAD, WRAP_U64 = 2**32 - 1, 2**31, 2**32 + 3
SEED = 0
PROFILE_ATTEMPTS = 3
# A trace that kept no kernel at all is taken again at once, up to this
# many times in all. On the card such traces come in runs (3, 5 and 6 in
# a row at retries 1 s apart, in two runs of this script), and waiting
# does not help: in scripts/trace_probe.py's runs a probe trace that kept no
# kernel was followed by a full one at once 3 times of 7, after 5 s idle
# once of 7. So none waits, and each measured trace follows a throwaway
# one at once.
EMPTY_TRACE_ATTEMPTS = 6
# The sharded phase: a mesh of this many parts of the path's batch on the
# card, one process over a world-1 NCCL group; the dry run's mesh.
SHARD_PARTS = 4
DRYRUN_PARTS = 8
# The sharded linear step's all-reduces: the (loss, weight) sums, then the
# gradients of w and of b.
SHARD_ALLREDUCES = 3
# The kernel of each route of K1, K2, K4 and K5, as the profiler names it;
# the route a call took is read from its trace. FILL is torch's zero fill,
# which the routes in ZEROED launch once a call for their output.
ROUTE_KERNELS = {
    "csr_spmv": {"half": "csr_spmv_half_kernel",
                 "warp": "csr_spmv_warp_kernel"},
    "csr_spmv_t": {"global": "csr_spmv_t_kernel",
                   "private": "csr_spmv_t_private_kernel"},
    "fm_pair_fwd": {"scalar": "fm_pair_fwd_kernel",
                    "vector": "fm_pair_fwd_vec_kernel"},
    "fm_pair_bwd": {"scalar": "fm_pair_bwd_kernel",
                    "vector": "fm_pair_bwd_vec_kernel"},
    "csr_to_dense": {"tile": "csr_to_dense_tile_kernel",
                     "global": "csr_to_dense_kernel"},
    "sgd_update": {"narrow": "sgd_update_narrow_kernel",
                   "wide": "sgd_update_kernel"},
}
# K8 on one part: its routes' launches, by kernel (ops.step.objective_route).
OBJECTIVE_ROUTE_CALLS = {
    "grid": {"logistic_step_kernel": 1, "logistic_sums_kernel": 0,
             "logistic_grad_kernel": 0},
    "split": {"logistic_step_kernel": 0, "logistic_sums_kernel": 1,
              "logistic_grad_kernel": 1},
}
ZEROED = {"csr_spmv_t": ("global", "private"),
          "fm_pair_bwd": ("scalar", "vector"),
          "csr_to_dense": ("global",)}  # the tile route writes every entry
FILL = "FillFunctor"
SPIN = "spin_kernel"  # torch.cuda._sleep's kernel
# Launches of SPIN that open each measured trace, left out of its result:
# late in a run a trace loses the records of its first launches, more of
# them the later (scripts/trace_probe.py: a probe trace of 3 kernels
# kept 3 early in a run, 2 from its page-tier phases on, and none
# at some points near its end), and these absorb the loss.
SPIN_LAUNCHES = 32
# The launches a call of each wrapper of one route makes, by kernel (see
# _launched): its kernels, and a zero fill where it zeroes its output.
KERNEL_CALLS = {
    "ffm_pair_fwd": {"ffm_pair_fwd_kernel": 1},
    "ffm_pair_bwd": {"ffm_pair_bwd_kernel": 1, FILL: 1},
    "pair_sums": {"tile_table_kernel": 1, "pair_rows_fwd_kernel": 1},
    "pair_sums_grad": {"pair_rows_bwd_kernel": 1},
    "sdot_rows": {"sdot_rows_kernel": 1},
}
# One rate for w and b. The bias sets the ceiling: its curvature is at
# most 1/4, so SGD on it diverges above a rate of 8. The 10^6 weights each
# see a few rows a batch, so at the reference's default of 0.1 the loss
# would not move visibly in one epoch.
LEARNING_RATE = 6.0
# Card peaks (H100 SXM data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# The card's L2. A kernel whose bound counts its bytes at HBM_BYTES_PER_S
# is timed cold, rotating over copies of its inputs that pass twice this
# together (at most COLD_COPIES copies).
L2_BYTES = 50 * 2**20
COLD_COPIES = 16
# Tolerances, each with its reason:
# K1 sums each row in another fp32 order (warp lanes + shuffle tree with
# fma) than the plain version (index_add_, atomics on the card). The
# rounding error of a sum scales with the sum of its terms' magnitudes,
# not with the result, so K1's rtol applies to sum_k |value[k]*w[index[k]]|:
# a row whose terms cancel (|y| << the terms) differs by as much as a
# row whose terms do not.
K1_RTOL, K1_ATOL = 1e-5, 1e-6
# K2 adds with fp32 atomics whose order varies from run to run. On a
# narrow model (137 weights, about 4096 terms each, of either sign) a
# weight's sum may cancel, so there, as for K1, the rtol applies to each
# weight's sum of |terms|; at 10^6 weights (a few terms each) to the
# result.
K2_RTOL, K2_ATOL = 1e-4, 1e-6
# K5 and K6 forward sum each row in another fp32 order than the plain
# versions (lane partials and shuffle trees; per-column sums over the
# fields and a block reduction; the plain FFM takes its diagonal off as
# the kernel does, the plain FM sums by index_add_). As for K1, the
# rounding error scales with the sum of the terms' magnitudes, so the rtol
# applies to each row's sum|terms|: for FM 1/2 sum_f (s_abs^2 + sq), for
# FFM 1/2 (sum_ab <S,S^T>_abs + diag).
PAIR_RTOL, PAIR_ATOL = 1e-5, 1e-6
# K5 and K6 backward add into gV with fp32 atomics whose order varies from
# run to run, as K2 does.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# K4 adds a row's duplicate columns with fp32 atomics in another order than
# its plain version (index_put_ with accumulation); every other entry is one
# value added to 0, and exact.
K4_RTOL, K4_ATOL = 1e-6, 0.0
# A matrix too wide for K4's tile route (8 rows of 8192 floats pass a
# block's shared memory on an H100): its global route.
K4_WIDE_COLS = 8192
# K7 forward sums non-negative terms (softplus * pw, and pw), so its rtol
# applies to the result itself; the backward's terms cancel, so as for K1
# its rtol applies to each row's sum of |terms| (s * pw * sp' over both
# directions). K7 sums in another order than its plain version.
RANK_RTOL, RANK_ATOL = 1e-5, 1e-6
# K8 sums non-negative terms (weight * loss, and the weights), so its loss
# is held to an rtol of itself; g = (w / W) * d with d in [-1, 1] formed by
# expf/log1pf and a few roundings in the kernel and by torch's exp and
# sigmoid in the plain version, so |err| of g is held to K8_DTOL of w / W;
# the bias's sum g, whose terms cancel, to K8_RTOL of sum|g|.
K8_RTOL, K8_ATOL, K8_DTOL = 1e-5, 1e-6, 1e-6
# About 24 fp32 operations a row: the margin's adds, exp and log1p (about
# 8 each in library code), sigma's divide, the products and the three sums.
K8_OPS_PER_ROW = 24
# K9 computes p - lr (g + 2 l2 p) with two fmas, the plain version with
# four roundings: |err| to K9_RTOL of |p| + lr |g| + 2 lr l2 |p|. Its l2
# term sums p^2 (non-negative) in another order: rtol of itself.
K9_RTOL, K9_LOSS_RTOL = 1e-6, 1e-5
# The widest w that K9's narrow route takes beside the bias: 255 float4s
# and the bias fill a block's 256 units (ops.step._SGD_THREADS); 1021
# floats are 256 units alone.
NARROW_WIDEST = 1020
# 3 SGD steps on the card against the plain path (the CPU for the linear
# model; the plain versions on the card for FM and FFM): the kernels' sums
# and the card's reductions of the loss run in other orders.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
# The RecordIO paths (cuda_ingest, recordio_decode, dense_train; configs 3,
# 14 and 18): the bench suite's corpora at its shapes, each about
# RECORDIO_MB, written once at the names the suite reads: config 3's 4
# parts of 60-140 KB binary records; config 14's dense rows of 24-47
# values, a value carrying the frame magic's bits every 251st row;
# config 18's 32x32x3 images, the magic spelled in every 101st; and a
# dense training corpus at config 14's row shape (write_dense_corpus).
RECORDIO_MB = 128  # at 256 the run took past 180 s (PERF.md)
INGEST_CHUNKS = (1 << 20, 4 << 20, 16 << 20)  # device_chunks' chunk sweep
DENSE_FEATURES = 48           # config 14's widest row
DENSE_ROW_BUCKET = 8192       # config 14's batch rows
IMAGE_SHAPE = (32, 32, 3)     # config 18's images
IMAGE_ROW_BUCKET = 256        # config 18's batch rows
# SGD on 48 features that are each present in most rows with values in
# [0, 1): the loss's curvature in w is up to 1/4 of the largest eigenvalue
# of E[x x^T], about 36 * 0.25 = 9, so a rate above 2 / (9 / 4) ~ 0.9
# diverges; 0.5 sits below it.
DENSE_LEARNING_RATE = 0.5
# One epoch (about 200 steps) through the kernels against one through the
# plain versions on the card: every step's sums (K1's rows, K2's atomics,
# K8's loss) run in other fp32 orders, and SGD carries each difference
# into the next step, where the loss's curvature damps it: on the CPU, an
# epoch whose batches' rows (and each row's values) were taken in another
# order stayed within 5.4e-7 of the first in every weight over 53 steps
# of this corpus at 64 MB, without growing. So the final w and b are held
# to STEP_RTOL and an atol of about 20 times that drift.
DENSE_EPOCH_RTOL, DENSE_EPOCH_ATOL = STEP_RTOL, 1e-5
# The format path (format_path; bench configs 1, 2, 5, 6 and 17) at the
# shape of HIGGS (Baldi, Sadowski and Whiteson, "Searching for Exotic
# Particles in High-Energy Physics with Deep Learning", Nature
# Communications 2014; the UCI table XGBoost benchmarks on): a label and
# 28 float columns a row. The csv writes each cell "%.6f" (config 2's
# make_csv), labels drawn with the probability a seeded hidden weight
# vector gives the centred row, so the loss can fall; the sparse variant
# has a share of cells exactly zero. The Parquet table is config 5's
# (make_parquet: a "label" column and f0-f27, float32, in 16 row groups),
# written by write_parquet (no pyarrow on the card's machine); the
# decode-bound table config 17's (make_parquet_decode_bound: 20 float32
# columns with 10% nulls beside the label, row groups of 4000). The
# indexed RecordIO is config 6's (make_indexed_recordio: 60-140 KB
# records and a .idx), read with its seed and batch.
HIGGS_FEATURES = 28
CSV_MB, SPARSE_CSV_MB, CSV_ZERO_FRAC = 256, 64, 0.3
CSV_ROW_BUCKET = 8192
CSV_NNZ_BUCKET = CSV_ROW_BUCKET * HIGGS_FEATURES
CSV_PARITY_BATCHES = 2  # batches held to pad_single over the Python parser
PARQUET_MB, PARQUET_GROUPS = 128, 16
DECODE_MB, DECODE_COLUMNS, DECODE_NULLS, DECODE_GROUP_ROWS = 64, 20, 0.1, 4000
INDEXED_MB, INDEXED_SEEDS, INDEXED_BATCH = 128, (11, 12), 64
# 28 features in [0, 1) present in every row: the loss's curvature in w is
# up to 1/4 of the largest eigenvalue of E[x x^T], about 27 / 4 + 1 / 3,
# so a rate above 2 / 1.8 ~ 1.1 diverges; 0.5 sits below it (as for the
# dense path).
HIGGS_LEARNING_RATE = 0.5
# The object-store plane (remote_path, phase 11b): one on-disk emulator
# under the run's directory, behind config 11's modeled wire (the
# reference's bench_remote_hydrate: 2 ms a request, 4 GB/s) with the
# objstore's default 4 MB blocks, 4 coalesced, 4 GETs at once. The
# training leg uploads the first REMOTE_TRAIN_MB of the linear corpus,
# cut at a line: an obj:// epoch parses in Python (the native engine
# reads local files only), about 7 MB/s.
REMOTE_LATENCY_S, REMOTE_GBPS = 0.002, 4.0
REMOTE_TRAIN_MB = 32
# The gang plane (gang_path, phase 11c): gangs of GANG_RANKS CUDA
# processes on this card behind remote_path's wire, each rank its own
# page store. The training gang reads the first REMOTE_TRAIN_MB of the
# linear corpus through the peer tier in GANG_BLOCK_MB blocks, groups of
# GANG_COALESCE owned by rank in turn (config 15's reference settings),
# a rank's wire bytes at most GANG_PEER_SLACK of the object; a non-owner
# waits on a 404 for the owner's hydration as the reference's worker
# does (GANG_PEER_ATTEMPTS, 0.05-0.4 s apart) before it takes the wire.
# It trains on the parts of GANG_PARTS that assign_parts gives each
# rank. The restore gang's wire is at most GANG_CKPT_WIRE_MAX of the
# checkpoint (config 21's bar). bench_twins runs config 15 at
# PEER_HYDRATE_MB over the linear corpus and config 21 at CKPT_FANOUT_MB
# (the reference's default --mb).
GANG_RANKS, GANG_PARTS, GANG_TIMEOUT_S = 2, 4, 300
GANG_BLOCK_MB, GANG_COALESCE, GANG_PEER_ATTEMPTS = 1, 4, 8
GANG_PEER_SLACK, GANG_CKPT_WIRE_MAX = 0.60, 1.3
PEER_HYDRATE_MB, CKPT_FANOUT_MB = 256, 64
# The global shuffle plane (shuffle_path, phase 11d): a gang of
# GANG_RANKS CUDA processes on this card, each its own page store,
# trains on one seeded global order (SEED) of the first REMOTE_TRAIN_MB
# of the linear corpus in SHUFFLE_WINDOW_MB windows (config 23's), a
# cold and a warm epoch; SHUFFLE_MIN_WINDOWS is the corpus cut by that
# window. bench_twins runs configs 20 and 23 at ELASTIC_MB and
# GLOBAL_SHUFFLE_MB (the reference's default --mb).
SHUFFLE_WINDOW_MB, SHUFFLE_MIN_WINDOWS = 2, 16
ELASTIC_MB, GLOBAL_SHUFFLE_MB = 64, 64


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------- phase 1

def environment():
    import torch
    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is false: this script needs a CUDA "
            "card")
    require(os.path.isdir(os.path.join(REPO, "dmlc_tpu_torch")),
            f"the dmlc_tpu_torch package is not beside {__file__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; card {card}")
    return card


# --------------------------------------------------------------- phase 2

def build_all():
    """Build the kernels and the engine at once; returns their times."""
    from dmlc_tpu_torch.native import build
    times, errors = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors[name] = e
        times[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=("kernels",
                                                  build.build_kernels)),
               threading.Thread(target=run, args=("engine", build.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, e in errors.items():
        fail(f"{name} build failed: {e}")
    for line in open(build.kernels_path() + ".log").read().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"build: kernels {times['kernels']:.1f} s, engine "
        f"{times['engine']:.1f} s")
    return times


# --------------------------------------------------------------- data

def _distinct_sorted(rng, n: int, k: int):
    """k distinct values drawn uniformly from [0, n), sorted (Floyd's
    algorithm): the distribution of bench.py's
    ``np.sort(rng.choice(n, k, replace=False))``, without the full
    permutation of n that choice draws for every row."""
    import numpy as np
    chosen = set()
    for j in range(n - k, n):
        t = int(rng.randint(0, j + 1))
        chosen.add(j if t in chosen else t)
    return np.array(sorted(chosen), np.int64)


def write_corpus(path: str) -> int:
    """bench.py's Criteo-shaped recipe (4000 seeded rows of 25-44
    distinct sorted indices below 10^6 with uniform values, repeated to
    the size), with labels from a seeded hidden weight vector as in
    __graft_entry__.py."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    w_true = np.random.RandomState(7).randn(NUM_FEATURES)
    rows, margins = [], []
    for _ in range(4000):
        nnz = rng.randint(25, 45)
        idx = _distinct_sorted(rng, NUM_FEATURES, nnz)
        vals = rng.rand(nnz)
        rows.append((idx, vals))
        margins.append(float((vals * w_true[idx]).sum()))
    median = float(np.median(margins))
    block = ("\n".join(
        f"{1 if m > median else -1} " + " ".join(
            f"{j}:{v:.6f}" for j, v in zip(idx, vals))
        for (idx, vals), m in zip(rows, margins)) + "\n").encode()
    reps = max(1, (FILE_MB << 20) // len(block))
    with open(path, "wb") as f:
        for _ in range(reps):
            f.write(block)
    return os.path.getsize(path)


def write_libfm_corpus(path: str) -> int:
    """A Criteo-shaped libfm file: 4000 seeded template rows repeated to
    LIBFM_MB, as write_corpus does. Each row holds 33-39 of the 39 fields,
    one nonzero each, the field's feature drawn below 10^6, valued by a
    uniform float in the 13 numeric fields and 1 in the 26 categorical
    ones. Labels split at the median margin of a seeded hidden FM teacher
    (w ~ N(0, 1), V ~ N(0, 0.3^2), K = 8), so the pair term carries signal."""
    import numpy as np
    rng = np.random.RandomState(SEED + 2)
    w_true = np.random.RandomState(8).randn(NUM_FEATURES)
    v_true = 0.3 * np.random.RandomState(9).randn(NUM_FEATURES, FM_FACTORS)
    rows, margins = [], []
    for _ in range(4000):
        fields = np.sort(rng.choice(FFM_FIELDS, rng.randint(33, 40),
                                    replace=False))
        idx = rng.randint(0, NUM_FEATURES, fields.size)
        vals = np.where(fields < NUMERIC_FIELDS, rng.rand(fields.size), 1.0)
        vx = vals[:, None] * v_true[idx]
        pair = 0.5 * float((vx.sum(0) ** 2 - (vx * vx).sum(0)).sum())
        rows.append((fields, idx, vals))
        margins.append(float((vals * w_true[idx]).sum()) + pair)
    median = float(np.median(margins))
    block = ("\n".join(
        f"{1 if m > median else -1} " + " ".join(
            f"{f}:{j}:{v:.6f}" if f < NUMERIC_FIELDS else f"{f}:{j}:1"
            for f, j, v in zip(*row))
        for row, m in zip(rows, margins)) + "\n").encode()
    reps = max(1, (LIBFM_MB << 20) // len(block))
    with open(path, "wb") as f:
        for _ in range(reps):
            f.write(block)
    return os.path.getsize(path)


def write_ranking_corpus(path: str) -> int:
    """A libsvm-with-qid file shaped like MSLR-WEB30K, about RANK_MB: 4000
    seeded template documents of 136 features each (indices 1-136, values
    uniform in [0, 1) to 4 decimals), graded 0-4 by a seeded hidden linear
    scorer plus noise at about the dataset's label shares (51%, 32%, 13%,
    3%, 1%), written as contiguous queries of 1-240 documents (mean about
    120), each under a fresh qid. Each template's feature text is made
    once; the queries repeat the templates in turn."""
    import numpy as np
    rng = np.random.RandomState(SEED + 6)
    templates = 4000
    X = np.round(rng.rand(templates, RANK_FEATURES), 4)
    w_true = np.random.RandomState(11).randn(RANK_FEATURES)
    score = X @ w_true
    score = (score - score.mean()) / score.std() + rng.randn(templates)
    labels = np.digitize(score, np.quantile(score, [0.51, 0.83, 0.96, 0.99]))
    feats = [" ".join(f"{j}:{v:.4f}" for j, v in
                      zip(range(1, RANK_FEATURES + 1), row)) for row in X]
    target = RANK_MB << 20
    written, qid, t = 0, 1, 0
    with open(path, "wb") as f:
        while written < target:
            lines = []
            for _ in range(rng.randint(1, 241)):
                lines.append(f"{labels[t]} qid:{qid} {feats[t]}\n")
                t = (t + 1) % templates
            chunk = "".join(lines).encode()
            f.write(chunk)
            written += len(chunk)
            qid += 1
    return os.path.getsize(path)


def write_dense_corpus(path: str) -> int:
    """The dense training corpus, about RECORDIO_MB, through the port's
    DenseRecordWriter: config 14's rows (24-47 values a row, uniform in
    [0, 1)), labels in {0, 1} drawn by a seeded rng with the probability
    that a seeded hidden weight vector gives the centred row, so the loss
    can fall. Unlike config 14's corpus it carries no value with the frame
    magic's bits: such a value (about -1.8e9) every 251st row would throw
    the weights off by 1e5 a step (recordio_decode and config 14 run the
    escaped records)."""
    import numpy as np
    from dmlc_tpu_torch.io.recordio import DenseRecordWriter
    from dmlc_tpu_torch.io.stream import create_stream
    rng = np.random.RandomState(SEED + 14)
    w_true = rng.standard_normal(DENSE_FEATURES).astype(np.float32)
    rows = (RECORDIO_MB << 20) // (16 + 4 * 35)  # a frame of 35.5 values
    n = rng.randint(24, 48, rows)
    off = np.concatenate([[0], np.cumsum(n)])
    vals = rng.rand(int(off[-1])).astype(np.float32)
    cols = np.arange(int(off[-1])) - np.repeat(off[:-1], n)
    margins = np.add.reduceat((vals - 0.5) * w_true[cols], off[:-1])
    labels = (rng.rand(rows) < 1 / (1 + np.exp(-margins))).astype(np.float32)
    with create_stream(path, "w") as s:
        w = DenseRecordWriter(s)
        for i in range(rows):
            w.write(labels[i], vals[off[i]:off[i + 1]])
    return os.path.getsize(path)


def _higgs_labels(rng, x):
    """{0, 1} labels for the rows of ``x`` (values in [0, 1)), each 1 with
    the probability a seeded hidden weight vector gives the centred row."""
    import numpy as np
    w_true = np.random.RandomState(SEED + 28).standard_normal(x.shape[1])
    p = 1 / (1 + np.exp(-((x - 0.5) @ w_true)))
    return rng.rand(len(x)) < p


CSV_ROW_BYTES = 2 + HIGGS_FEATURES * 9  # "y," then "0.dddddd," a cell


def write_higgs_csv(path: str, mb: int, seed: int,
                    zero_frac: float = 0.0) -> int:
    """A HIGGS-shaped csv of about ``mb`` MB: a {0, 1} label and 28 cells
    of "0.dddddd" a row (uniform millionths in [0, 1), ``zero_frac`` of
    them exactly 0), labels by _higgs_labels; formatted by numpy, 64K
    rows at a time."""
    import numpy as np
    rng = np.random.RandomState(seed)
    rows = (mb << 20) // CSV_ROW_BYTES
    place = 10 ** np.arange(5, -1, -1)
    with open(path, "wb") as f:
        for start in range(0, rows, 1 << 16):
            n = min(1 << 16, rows - start)
            k = rng.randint(0, 10 ** 6, (n, HIGGS_FEATURES))
            if zero_frac:
                k[rng.rand(n, HIGGS_FEATURES) < zero_frac] = 0
            label = _higgs_labels(rng, k / 1e6)
            out = np.empty((n, CSV_ROW_BYTES), np.uint8)
            out[:, 0] = ord("0") + label
            out[:, 1] = ord(",")
            cells = out[:, 2:].reshape(n, HIGGS_FEATURES, 9)
            cells[:, :, 0] = ord("0")
            cells[:, :, 1] = ord(".")
            cells[:, :, 2:8] = ord("0") + (k[:, :, None] // place) % 10
            cells[:, :, 8] = ord(",")
            out[:, -1] = ord("\n")
            f.write(out.tobytes())
    return os.path.getsize(path)


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


class _Thrift:
    """A thrift compact-protocol struct writer: the fields write_parquet's
    page headers and footer use (i32, i64, string, struct, list), each
    field header in the short form (ids ascending by at most 15)."""

    I32, I64, BINARY, LIST, STRUCT = 5, 6, 8, 9, 12

    def __init__(self):
        self.out = bytearray()
        self.last = 0

    def field(self, fid: int, kind: int) -> "_Thrift":
        self.out.append(((fid - self.last) << 4) | kind)
        self.last = fid
        return self

    def num(self, fid: int, v: int, kind: int = I32) -> "_Thrift":
        self.field(fid, kind).out += _zigzag(v)
        return self

    def string(self, fid: int, s: str) -> "_Thrift":
        b = s.encode()
        self.field(fid, self.BINARY).out += _varint(len(b)) + b
        return self

    def struct(self, fid: int, body: bytes) -> "_Thrift":
        self.field(fid, self.STRUCT).out += body
        return self

    def seq(self, fid: int, kind: int, items) -> "_Thrift":
        self.field(fid, self.LIST)
        n = len(items)
        self.out += (bytes([(n << 4) | kind]) if n < 15
                     else bytes([0xF0 | kind]) + _varint(n))
        for item in items:
            self.out += item
        return self

    def end(self) -> bytes:
        return bytes(self.out) + b"\0"


def _zigzag(v: int) -> bytes:
    return _varint((v << 1) ^ (v >> 63))


def write_parquet(path: str, columns, group_rows: int, nulls=None) -> int:
    """A Parquet file of float32 columns, written with numpy alone: what
    the engine's page decoder takes (ABI 8) and pyarrow reads. ``columns``
    maps each name to its float32 values (all of one length), in schema
    order; ``nulls`` maps some names to a bool mask (True: null), and
    those columns are OPTIONAL, with RLE/bit-packed definition levels
    (one bit-packed run, bit width 1), the others REQUIRED. Each row
    group of ``group_rows`` rows holds one V1 DATA_PAGE a column: PLAIN,
    UNCOMPRESSED, the non-null values only. ``PAR1`` at both ends, the
    thrift compact footer between. Returns the file's size."""
    import numpy as np
    nulls = nulls or {}
    names = list(columns)
    nrows = len(columns[names[0]])
    groups = []  # [(num_rows, [(start, size, num_values)] a column)]
    with open(path, "wb") as f:
        f.write(b"PAR1")
        pos = 4
        for lo in range(0, nrows, group_rows):
            hi = min(lo + group_rows, nrows)
            chunks = []
            for name in names:
                vals = np.ascontiguousarray(columns[name][lo:hi], "<f4")
                body = b""
                if name in nulls:
                    present = ~np.asarray(nulls[name][lo:hi], bool)
                    levels = (_varint((-(-(hi - lo) // 8) << 1) | 1)
                              + np.packbits(present,
                                            bitorder="little").tobytes())
                    body = len(levels).to_bytes(4, "little") + levels
                    vals = vals[present]
                body += vals.tobytes()
                page = (_Thrift().num(1, 0)           # DATA_PAGE
                        .num(2, len(body)).num(3, len(body))
                        .struct(5, _Thrift().num(1, hi - lo)
                                .num(2, 0)             # PLAIN
                                .num(3, 3).num(4, 3)   # levels: RLE
                                .end())
                        .end())
                f.write(page + body)
                chunks.append((pos, len(page) + len(body)))
                pos += len(page) + len(body)
            groups.append((hi - lo, chunks))
        schema = [_Thrift().string(4, "schema").num(5, len(names)).end()]
        schema += [_Thrift().num(1, 4)                 # FLOAT
                   .num(3, 1 if name in nulls else 0)  # OPTIONAL/REQUIRED
                   .string(4, name).end() for name in names]
        row_groups = []
        for num_rows, chunks in groups:
            metas = []
            for name, (start, size) in zip(names, chunks):
                meta = (_Thrift().num(1, 4)
                        .seq(2, _Thrift.I32, [_zigzag(0), _zigzag(3)])
                        .seq(3, _Thrift.BINARY,
                              [_varint(len(name)) + name.encode()])
                        .num(4, 0)                     # UNCOMPRESSED
                        .num(5, num_rows, _Thrift.I64)
                        .num(6, size, _Thrift.I64)
                        .num(7, size, _Thrift.I64)
                        .num(9, start, _Thrift.I64)    # data_page_offset
                        .end())
                metas.append(_Thrift().num(2, start, _Thrift.I64)
                             .struct(3, meta).end())
            row_groups.append(
                _Thrift().seq(1, _Thrift.STRUCT, metas)
                .num(2, sum(size for _, size in chunks), _Thrift.I64)
                .num(3, num_rows, _Thrift.I64).end())
        footer = (_Thrift().num(1, 1)
                  .seq(2, _Thrift.STRUCT, schema)
                  .num(3, nrows, _Thrift.I64)
                  .seq(4, _Thrift.STRUCT, row_groups)
                  .end())
        f.write(footer + len(footer).to_bytes(4, "little") + b"PAR1")
    return os.path.getsize(path)


def higgs_table(mb: int, seed: int):
    """Config 5's table at about ``mb`` MB: {"label", "f0".."f27"} of
    float32 (uniform in [0, 1), labels by _higgs_labels), as columns."""
    import numpy as np
    rng = np.random.RandomState(seed)
    rows = (mb << 20) // 120  # make_parquet's ~30 float32 columns a row
    x = rng.rand(rows, HIGGS_FEATURES).astype(np.float32)
    cols = {"label": _higgs_labels(rng, x).astype(np.float32)}
    cols.update((f"f{c}", np.ascontiguousarray(x[:, c]))
                for c in range(HIGGS_FEATURES))
    return cols


def decode_table(mb: int, seed: int):
    """Config 17's table at about ``mb`` MB: a float32 label and f0-f19
    of float32 with DECODE_NULLS of each column null. Returns (columns,
    nulls)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    rows = (mb << 20) // (DECODE_COLUMNS * 4 + 8)
    cols = {"label": rng.rand(rows).astype(np.float32)}
    nulls = {}
    for c in range(DECODE_COLUMNS):
        cols[f"f{c}"] = rng.rand(rows).astype(np.float32)
        nulls[f"f{c}"] = rng.rand(rows) < DECODE_NULLS
    return cols, nulls


# Each path's padded batch: the file's format, the row and nnz buckets,
# and the columns it forces.
LAYOUT = {"libsvm": ("libsvm", ROW_BUCKET, NNZ_BUCKET, {}),
          "libfm": ("libfm", ROW_BUCKET, LIBFM_NNZ_BUCKET,
                    {"want_field": True}),
          "ranking": ("libsvm", RANK_ROW_BUCKET, RANK_NNZ_BUCKET,
                      {"want_qid": True}),
          "dense": ("recordio_dense", DENSE_ROW_BUCKET,
                    DENSE_ROW_BUCKET * DENSE_FEATURES, {}),
          "image": ("recordio_image", IMAGE_ROW_BUCKET,
                    IMAGE_ROW_BUCKET * IMAGE_SHAPE[0] * IMAGE_SHAPE[1]
                    * IMAGE_SHAPE[2], {}),
          "csv": ("csv", CSV_ROW_BUCKET, CSV_NNZ_BUCKET, {}),
          "csv_sparse": ("csv", CSV_ROW_BUCKET, CSV_NNZ_BUCKET, {}),
          "parquet": ("parquet_native", CSV_ROW_BUCKET, CSV_NNZ_BUCKET, {})}
# The format options each path's parse takes (the label's column).
PARSE_KW = {"csv": {"label_column": 0},
            "csv_sparse": {"label_column": 0, "sparse": True},
            "parquet": {"label_column": "label"}}
# The linear model's paths over dense rows (check_dense_kernels,
# dense_train): the rows a batch, the features, the learning rate and the
# kernel checks' seed.
DENSE_PATHS = {"dense": (DENSE_ROW_BUCKET, DENSE_FEATURES,
                         DENSE_LEARNING_RATE, SEED + 15),
               "csv": (CSV_ROW_BUCKET, HIGGS_FEATURES, HIGGS_LEARNING_RATE,
                       SEED + 16),
               "parquet": (CSV_ROW_BUCKET, HIGGS_FEATURES,
                           HIGGS_LEARNING_RATE, SEED + 17)}


def padded_batches(parser, fmt="libsvm"):
    _, rows, nnz_bucket, want = LAYOUT[fmt]
    while True:
        batch = parser.next_padded(rows, nnz_bucket=nnz_bucket, **want)
        if batch is None:
            return
        yield batch


def first_batch(path, fmt="libsvm"):
    """The native parser's first padded batch, copied out of its lease."""
    from dmlc_tpu_torch.data.parser import Parser
    parser = Parser.create(path, 0, 1, format=LAYOUT[fmt][0],
                           engine="native", **PARSE_KW.get(fmt, {}))
    batch = next(padded_batches(parser, fmt)).copy()
    parser.destroy()
    return batch


def batch_hash(batch) -> str:
    import numpy as np
    h = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(np.asarray(batch[k]))
        h.update(k.encode() + a.dtype.str.encode())
        h.update(a.tobytes())
    return h.hexdigest()


# --------------------------------------------------------------- phase 3

def call_ms(fn, iters: int = 100) -> float:
    """Milliseconds a call takes back to back, host launch included:
    CUDA events around ``iters`` calls."""
    import torch
    for _ in range(10):
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


def _launched(key, kernel):
    """Whether the profiler's ``key`` names ``kernel``: a kernel of the
    port ("(anonymous namespace)::name<...>(...)"), or torch's fill
    (FILL) or spin kernel (SPIN)."""
    return f"::{kernel}<" in key or f"::{kernel}(" in key


def _device_us_by_kernel(fn, iters: int = 1, calls=None):
    """{kernel name: (device µs, launches)} of one piece of the work that
    ``fn`` repeats ``iters`` times on the card, from a torch.profiler
    trace of device activity only (so no host op is counted beside the
    kernels it launched). ``calls`` maps kernels (see _launched) to the
    launches a piece must show of them, 0 for a kernel that must not run.

    Late in a run on the card, a trace loses the records of its first
    launches (of 100 launches, 49 and 50 records of K7 forward's two
    kernels; a single K2 call without its fill), so each trace opens with
    SPIN_LAUNCHES launches of torch's spin kernel (SPIN), left out of the
    result. A
    kernel's launches a piece are its records over ``iters``, rounded,
    and its time a piece the mean of the records it kept times those
    launches; a trace in which a kernel kept fewer than nine tenths of
    its launches' records, or more than them, or that shows launches
    other than ``calls`` is taken again, up to PROFILE_ATTEMPTS times, and
    then fails; one that kept no kernel at all, up to
    EMPTY_TRACE_ATTEMPTS times. Each follows a throwaway trace at once
    (see EMPTY_TRACE_ATTEMPTS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    want = dict(calls or {})
    attempts = empty = 0
    while True:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(SPIN_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        by_kernel, lost = {}, {}
        for e in prof.key_averages():
            per = round(e.count / iters)
            if (e.self_device_time_total <= 0 or per == 0
                    or _launched(e.key, SPIN)):
                continue
            by_kernel[e.key] = (e.self_device_time_total / e.count * per, per)
            if not 0 <= per * iters - e.count <= per * iters // 10:
                lost[e.key[:60]] = f"{e.count} of {per * iters}"
        seen = {k: sum(n for key, (_, n) in by_kernel.items()
                       if _launched(key, k)) for k in want}
        if by_kernel and seen == want and not lost:
            return by_kernel
        attempts += bool(by_kernel)
        empty += not by_kernel
        log(f"  trace {attempts + empty} ({empty} with no kernel): "
            f"{len(by_kernel)} kernels, launches a piece {seen} (want "
            f"{want}), records kept out of launches {lost}")
        if attempts >= PROFILE_ATTEMPTS or empty >= EMPTY_TRACE_ATTEMPTS:
            fail(f"no trace of {attempts + empty} showed the launches "
                 f"wanted: {want} a piece of {iters}")


def rotating(inputs, nbytes):
    """A function that returns ``inputs`` and its copies in turn: as many
    copies (``inputs`` counted) as pass 2 * L2_BYTES together at
    ``nbytes`` each, at most COLD_COPIES, so a kernel timed on them reads
    its inputs from HBM, not from L2. ``inputs``: a list of tensors or of
    lists of tensors. Returns (the function, the number of copies)."""
    import itertools

    def clone(x):
        return x.clone() if hasattr(x, "clone") else [clone(y) for y in x]

    copies = max(1, min(COLD_COPIES, -(-2 * L2_BYTES // max(nbytes, 1))))
    turn = itertools.cycle([inputs] + [clone(inputs)
                                       for _ in range(copies - 1)])
    return lambda: next(turn), copies


def device_ms(fn, iters: int = 50, calls=None) -> float:
    """Device milliseconds per call of ``fn``: the summed device time of
    every kernel, copy and fill it runs, from ``iters`` calls, each of
    which launches ``calls`` (see _device_us_by_kernel)."""
    for _ in range(10):
        fn()

    def loop():
        for _ in range(iters):
            fn()

    by_kernel = _device_us_by_kernel(loop, iters, calls)
    return sum(t for t, _ in by_kernel.values()) / 1e3


def route_calls(op, route):
    """The launches a call of the wrapper ``op`` makes by ``route``: one
    of that route's kernel, none of its other routes' kernels, and for a
    wrapper in ZEROED one zero fill of its output where that route zeroes
    it, none where it does not."""
    calls = {k: int(r == route) for r, k in ROUTE_KERNELS[op].items()}
    if op in ZEROED:
        calls[FILL] = int(route in ZEROED[op])
    return calls


def on_route(op, route, fn):
    """``fn()``, one call of the wrapper ``op``, run under the profiler;
    fails unless its trace shows that it took ``route``."""
    out = []
    _device_us_by_kernel(lambda: out.append(fn()), 1, route_calls(op, route))
    return out[-1]


def _fill_and_kernel(fn, op, route, iters: int = 50):
    """(the fill, the kernel) of the device milliseconds a call of ``fn``
    takes, a call of the wrapper ``op`` by ``route``: the route's kernel
    apart from the zero fill of its output."""
    for _ in range(10):
        fn()
    by_kernel = _device_us_by_kernel(lambda: [fn() for _ in range(iters)],
                                     iters, route_calls(op, route))
    mine = sum(t for k, (t, _) in by_kernel.items()
               if _launched(k, ROUTE_KERNELS[op][route]))
    rest = sum(t for t, _ in by_kernel.values()) - mine
    return rest / 1e3, mine / 1e3


def bound_ms(nbytes, ops):
    """The least time the card could take for a function: the bytes it
    must move over the memory rate, or its fp32 operations over the peak,
    whichever is larger; and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def edge_case_batch(first):
    """The main path's first padded batch with edge cases written in:
    rows 3 and 7 emptied, the last 100 rows made padding, an index at F-1
    in row 10, one out of range in row 20, and the index rule's edges
    (C6): 2^32-1 in row 50 (reads F-1), 2^31 in row 60 (invalid) and
    2^32+3 in row 70 (reads 3); where the batch has a field column, a
    field past the FFM's fields in row 30, one below 0 in row 40 and 2^31
    in row 80 (all clipped), and 2^31 (invalid) at the first nonzero of
    the padded tail, which belongs to no row and must add nothing to a
    gradient (ROADMAP C7). The index is returned as u64; its u32 copy
    keeps the low 32 bits. Returns (offset, index, value, field or None,
    the rows of invalid indices)."""
    import numpy as np
    off = first["offset"]
    require(int(first["num_rows"]) == ROW_BUCKET,
            f"first batch has {int(first['num_rows'])} rows, want "
            f"{ROW_BUCKET}")
    old_lens = np.diff(off)
    lens = old_lens.copy()
    lens[[3, 7]] = 0
    lens[ROW_BUCKET - 100:] = 0
    keep = np.repeat(lens > 0, old_lens)
    nnz = int(lens.sum())
    new_off = np.zeros_like(off)
    new_off[1:] = np.cumsum(lens)
    idx = np.zeros(first["index"].shape, np.uint64)
    val = np.zeros_like(first["value"])
    idx[:nnz] = first["index"][:int(off[-1])][keep]
    val[:nnz] = first["value"][:int(off[-1])][keep]
    idx[new_off[10]] = NUM_FEATURES - 1
    idx[new_off[20] + 1] = NUM_FEATURES + 12345
    idx[new_off[50] + 1] = WRAP_LAST
    idx[new_off[60] + 2] = WRAP_BAD
    idx[new_off[70]] = WRAP_U64
    fld = None
    if "field" in first:
        fld = np.zeros_like(first["field"])
        fld[:nnz] = first["field"][:int(off[-1])][keep]
        fld[new_off[30]] = FFM_FIELDS + 4
        fld[new_off[40] + 2] = -3
        fld[new_off[80] + 1] = WRAP_BAD
        require(nnz < idx.size, "the factor batch has no padded tail")
        idx[nnz] = WRAP_BAD
    return new_off, idx, val, fld, [20, 60]


def _check_narrow_k2(name, offset, index, value, g, F=RANK_NUM_FEATURES):
    """K2 on a narrow model's batch (``F`` weights) against its plain
    version, with the rtol of each weight's sum|terms| (see K2_RTOL);
    returns max |err|."""
    import torch
    from dmlc_tpu_torch.ops import csr
    gw = on_route("csr_spmv_t", "private",
                  lambda: csr.csr_spmv_t(offset, index, value, g, F))
    plain = csr.csr_spmv_t_plain(offset, index, value, g, F)
    scale = csr.csr_spmv_t_plain(offset, index, value.abs(), g.abs(), F)
    torch.cuda.synchronize()
    err = (gw - plain).abs()
    require(bool(torch.isfinite(gw).all())
            and bool((err <= K2_ATOL + K2_RTOL * scale).all()),
            f"K2 {name} (private route) disagrees with its plain version: "
            f"max |err| {err.max().item()}, max |err| / sum|terms| "
            f"{(err / scale).nan_to_num().max().item()}")
    return err.max().item()


def narrow_edge_batch():
    """A batch of a narrow model (137 weights) with K2's edge cases: 4096
    rows, each of the indices 1-136 and 0-7 more of them again (duplicates
    within the row), rows 3 and 7 emptied, the last 100 rows padding, and
    the index rule's edges (C6): 2^32-1 in row 50 (reads F-1), 2^31 in row
    60 (invalid) and 2^32+3 in row 70 (reads 3); then a padded tail of 64
    nonzeros whose first holds 2^31 (invalid) and whose second index 5
    with value 1, which must add nothing. Returns (offset, index as u64,
    value, g)."""
    import numpy as np
    rng = np.random.RandomState(SEED + 11)
    n = RANK_ROW_BUCKET
    lens = RANK_FEATURES + rng.randint(0, 8, n)
    lens[[3, 7]] = 0
    lens[n - 100:] = 0
    off = np.zeros(n + 1, np.int64)
    off[1:] = np.cumsum(lens)
    nnz = int(off[-1])
    idx = np.zeros(nnz + 64, np.uint64)
    val = np.zeros(nnz + 64, np.float32)
    idx[:nnz] = np.concatenate([
        np.concatenate([np.arange(1, RANK_NUM_FEATURES),
                        rng.randint(1, RANK_NUM_FEATURES,
                                    m - RANK_FEATURES)])
        for m in lens if m])
    val[:nnz] = rng.rand(nnz)
    idx[off[50] + 1] = WRAP_LAST
    idx[off[60] + 2] = WRAP_BAD
    idx[off[70]] = WRAP_U64
    idx[nnz], idx[nnz + 1], val[nnz + 1] = WRAP_BAD, 5, 1.0
    return off, idx, val, rng.randn(n).astype(np.float32)


# Rows about K1's lane counts (16 and 32 lanes a row; 64 and 160 nonzeros a
# pass) and K5 forward's window (48 nonzeros), the ranking path's 136, and
# 1000, over a small model.
ROW_LENGTHS = (0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 136, 1000)
ROW_LENGTH_FEATURES = 500


def row_length_batch(bucket_per_row):
    """A seeded batch of the ROW_LENGTHS rows, each twice, and as many
    empty rows, in a seeded order, over ROW_LENGTH_FEATURES features; its
    bucket padded to ``bucket_per_row`` nonzeros a row, so that K1 takes
    its half route at up to 64 and its warp route past it. The padded tail
    starts with 2^31 (invalid), which no row may read. The index rule's
    edges (C6): 2^32-1 (reads F-1) first in the first row of 1000, 2^31
    (invalid: a NaN row) first in the first row of 136, 2^32+3 (reads 3)
    first in the first row of 33. Returns (offset, index as u64, value,
    the rows of invalid indices)."""
    import numpy as np
    rng = np.random.RandomState(SEED + 13)
    lens = rng.permutation(np.array(ROW_LENGTHS * 2 + (0,) * 26))
    off = np.zeros(lens.size + 1, np.int64)
    off[1:] = np.cumsum(lens)
    nnz = int(off[-1])
    bucket = bucket_per_row * lens.size
    require(bucket > nnz, "the row-length batch has no padded tail")
    idx = np.zeros(bucket, np.uint64)
    val = np.zeros(bucket, np.float32)
    idx[:nnz] = rng.randint(0, ROW_LENGTH_FEATURES, nnz)
    val[:nnz] = rng.rand(nnz) * 2 - 0.5
    idx[nnz] = WRAP_BAD
    first_of = {n: int(np.flatnonzero(lens == n)[0]) for n in (1000, 136, 33)}
    idx[off[first_of[1000]]] = WRAP_LAST
    idx[off[first_of[136]]] = WRAP_BAD
    idx[off[first_of[33]]] = WRAP_U64
    return off, idx, val, [first_of[136]]


def _check_k1(name, offset, index, value, w, route, bad_rows):
    """K1 by ``route`` (read from the call's trace) against its plain
    version: NaN in the rows of invalid indices only, 0 in empty rows,
    |err| <= atol + rtol * each row's sum|terms|. Returns (max |err|, max
    |err| / sum|terms|)."""
    import torch
    from dmlc_tpu_torch.ops import csr
    y = on_route("csr_spmv", route,
                 lambda: csr.csr_spmv(offset, index, value, w))
    plain = csr.csr_spmv_plain(offset, index, value, w)
    scale = csr.csr_spmv_plain(offset, index, value.abs(),
                               w.abs()).nan_to_num()
    torch.cuda.synchronize()
    nan_rows = torch.isnan(y).nonzero().flatten().tolist()
    require(nan_rows == bad_rows,
            f"K1 {name} ({route} route): NaN rows {nan_rows}, want "
            f"{bad_rows}")
    require(torch.isnan(plain).nonzero().flatten().tolist() == nan_rows,
            f"K1 {name}: the plain version's NaN rows differ")
    empty = offset[1:] == offset[:-1]
    require(bool((y[empty] == 0).all()),
            f"K1 {name} ({route} route): empty or padded rows are not 0")
    err = (y - plain).nan_to_num().abs()
    require(bool((err <= K1_ATOL + K1_RTOL * scale).all()),
            f"K1 {name} ({route} route) disagrees with its plain version: "
            f"max |err| {err.max().item()}, max |err| / sum|terms| "
            f"{(err / scale).nan_to_num().max().item()}")
    return err.max().item(), (err / scale).nan_to_num().max().item()


def check_kernels(first):
    """Phase 3: K1/K2 against their plain versions on the card."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.ops import csr

    cuda = torch.device("cuda")
    rng = np.random.RandomState(SEED + 1)
    off, idx, val, _, bad_rows = edge_case_batch(first)
    w = torch.from_numpy(rng.randn(NUM_FEATURES).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(ROW_BUCKET).astype(np.float32)).to(cuda)
    t_off = torch.from_numpy(off).to(cuda)
    t_val = torch.from_numpy(val).to(cuda)
    before = (csr.csr_spmv.launches, csr.csr_spmv_t.launches)
    # K1's warp route on the same rows: the bucket grown past 64 a row
    warp_bucket = (csr.K1_HALF_MAX_PER_ROW + 1) * ROW_BUCKET
    grown = warp_bucket - idx.size
    w_val = torch.from_numpy(
        np.concatenate([val, np.zeros(grown, val.dtype)])).to(cuda)
    k1_errs = {}
    for dtype in (np.uint32, np.uint64):
        t_idx = torch.from_numpy(idx.astype(dtype)).to(cuda)
        name = np.dtype(dtype).name
        k1_errs[name] = _check_k1(name, t_off, t_idx, t_val, w, "half",
                                  bad_rows)
        w_idx = torch.from_numpy(np.concatenate(
            [idx, np.zeros(grown, idx.dtype)]).astype(dtype)).to(cuda)
        _check_k1(f"{name}, bucket of {warp_bucket}", t_off, w_idx, w_val,
                  w, "warp", bad_rows)
        gw = on_route("csr_spmv_t", "global", lambda: csr.csr_spmv_t(
            t_off, t_idx, t_val, g, NUM_FEATURES))
        gw_plain = csr.csr_spmv_t_plain(t_off, t_idx, t_val, g, NUM_FEATURES)
        torch.cuda.synchronize()
        require(torch.isfinite(gw).all().item(),
                f"K2 {name}: non-finite gradient")
        require(torch.allclose(gw, gw_plain, rtol=K2_RTOL, atol=K2_ATOL),
                f"K2 {name} disagrees with its plain version: max "
                f"|err| {(gw - gw_plain).abs().max().item()}")
        require(gw[NUM_FEATURES - 1].item() != 0.0,
                f"K2 {name}: the index at F-1 got no gradient")
        if dtype is np.uint32:
            k2_err = (gw - gw_plain).abs().max().item()
    k1_err, k1_rel = k1_errs["uint32"]
    log(f"kernels agree with their plain versions (u32 and u64 index; "
        f"indices 2^32-1, 2^31 and 2^32+3 among the edge cases): "
        f"K1 (half route; the warp route too, on a bucket of "
        f"{warp_bucket}) max |err| {k1_err:.3g}, max |err| / sum|terms| "
        f"{k1_rel:.3g} (rtol {K1_RTOL} of sum|terms|, atol {K1_ATOL}), "
        f"K2 (global route) max |err| {k2_err:.3g} (rtol {K2_RTOL}, atol "
        f"{K2_ATOL})")
    n_off, n_idx, n_val, n_g = narrow_edge_batch()
    t_off, t_val, t_g = (torch.from_numpy(a).to(cuda)
                         for a in (n_off, n_val, n_g))
    narrow_err = {}
    for dtype in (np.uint32, np.uint64):
        name = np.dtype(dtype).name
        t_idx = torch.from_numpy(n_idx.astype(dtype)).to(cuda)
        narrow_err[name] = _check_narrow_k2(f"narrow {name}", t_off, t_idx,
                                            t_val, t_g)
    log(f"K2 agrees with its plain version on a narrow model's edge batch "
        f"through its private route ({RANK_NUM_FEATURES} weights, "
        f"{RANK_ROW_BUCKET} rows of indices 1-{RANK_FEATURES} with "
        f"duplicates, empty rows, indices 2^32-1, 2^31 and 2^32+3, an "
        f"invalid index in the padded tail): max |err| u32 "
        f"{narrow_err['uint32']:.3g}, u64 {narrow_err['uint64']:.3g} (rtol "
        f"{K2_RTOL} of sum|terms|, atol {K2_ATOL})")
    w_small = torch.from_numpy(
        rng.randn(ROW_LENGTH_FEATURES).astype(np.float32)).to(cuda)
    lengths_err = {}
    for route, per_row in (("half", csr.K1_HALF_MAX_PER_ROW),
                           ("warp", csr.K1_HALF_MAX_PER_ROW + 1)):
        r_off, r_idx, r_val, r_bad = row_length_batch(per_row)
        for dtype in (np.uint32, np.uint64):
            lengths_err[route, np.dtype(dtype).name] = _check_k1(
                f"rows of {ROW_LENGTHS} nonzeros", *(
                    torch.from_numpy(a).to(cuda)
                    for a in (r_off, r_idx.astype(dtype), r_val)),
                w_small, route, r_bad)[0]
    log(f"K1 agrees with its plain version on rows of {ROW_LENGTHS} "
        f"nonzeros through both routes, u32 and u64, with indices 2^32-1, "
        f"2^31 and 2^32+3 and an invalid index in the padded tail: max "
        f"|err| " + ", ".join(f"{r} {d} {e:.3g}"
                              for (r, d), e in lengths_err.items()))

    # Timing, at the main path's batch as it came from the parser.
    b_off = torch.from_numpy(first["offset"]).to(cuda)
    b_idx = torch.from_numpy(first["index"]).to(cuda)
    b_val = torch.from_numpy(first["value"]).to(cuda)
    n, nnz = ROW_BUCKET, int(first["num_nnz"])
    distinct = int(np.unique(first["index"][:nnz]).size)
    k1_bytes = (n + 1) * 8 + nnz * (4 + 4) + distinct * 4 + n * 4
    k2_bytes = (n + 1) * 8 + nnz * (4 + 4) + n * 4 + NUM_FEATURES * 4
    flops = 2 * nnz

    def k1():
        return csr.csr_spmv(b_off, b_idx, b_val, w)

    def k2():
        return csr.csr_spmv_t(b_off, b_idx, b_val, g, NUM_FEATURES)

    k1_ms = device_ms(k1, calls=route_calls("csr_spmv", "half"))
    k1_call = call_ms(k1)
    k1_plain = device_ms(lambda: csr.csr_spmv_plain(b_off, b_idx, b_val, w))
    k2_fill, k2_kernel = _fill_and_kernel(k2, "csr_spmv_t", "global")
    k2_ms, k2_call = k2_fill + k2_kernel, call_ms(k2)
    log(f"csr_spmv_t at the main path's batch (global route): kernel "
        f"{k2_kernel * 1e3:.2f} us, zero fill {k2_fill * 1e3:.2f} us on the "
        "device")
    k2_plain = device_ms(lambda: csr.csr_spmv_t_plain(b_off, b_idx, b_val, g,
                                                      NUM_FEATURES))
    # the library yardstick: one torch.sparse CSR product on the same
    # rows (the padded tail trimmed: a CSR tensor holds exactly nnz)
    a = torch.sparse_csr_tensor(b_off, b_idx[:nnz].to(torch.int64),
                                b_val[:nnz], size=(n, NUM_FEATURES))
    y_lib = a @ w
    torch.cuda.synchronize()
    lib_err = (y_lib - csr.csr_spmv(b_off, b_idx, b_val, w)).abs()
    lib_scale = csr.csr_spmv_plain(b_off, b_idx, b_val.abs(), w.abs())
    require(bool((lib_err <= K1_ATOL + K1_RTOL * lib_scale).all()),
            "K1 disagrees with torch.sparse on the main path's batch")
    k1_lib = device_ms(lambda: a @ w)
    try:
        at = a.t()
        at @ g
        k2_lib = device_ms(lambda: at @ g)
    except RuntimeError as e:
        log(f"library K2 (sparse CSR transpose @ dense) not timed: {e}")
        k2_lib = None
    after = (csr.csr_spmv.launches, csr.csr_spmv_t.launches)
    require(after[0] > before[0] and after[1] > before[1],
            "the kernel wrappers did not count their launches")

    log(f"timed at the main path's first batch: {n} rows, {nnz} nonzeros "
        f"of {NNZ_BUCKET}, {distinct} distinct features")
    k1_bound, k1_by = bound_ms(k1_bytes, flops)
    k2_bound, k2_by = bound_ms(k2_bytes, flops)
    rows = [
        {"name": "csr_spmv", "route": "cuda",
         "source": "dmlc_tpu_torch/csrc/csr_spmv.cu",
         "replaces": "dmlc_tpu/ops/csr.py:46",
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib,
         "call_ms": k1_call},
        {"name": "csr_spmv_t", "route": "cuda",
         "source": "dmlc_tpu_torch/csrc/csr_spmv.cu",
         "replaces": "dmlc_tpu/models/common.py:89",
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib,
         "call_ms": k2_call},
    ]
    return rows


# --------------------------------------------------------------- phase 3b

# The objective's and the update's edge cases (K8, K9): see
# objective_cases and check_step_kernels.
def objective_cases(label, weight):
    """K8's inputs at the main path's first batch (its labels ±1 and
    weights), with edge cases written in: {name: (t0, t1 or None, bias or
    None, label, weight)}, float32 numpy of the batch's rows."""
    import numpy as np
    rng = np.random.RandomState(SEED + 8)
    n = label.size
    t0 = rng.randn(n).astype(np.float32)
    t1 = (0.5 * rng.randn(n)).astype(np.float32)
    bias = np.float32(0.1)
    zero = np.zeros(n, np.float32)
    large = t0.copy()
    large_w = weight.copy()
    large[:8] = [88.0, -88.0, 3e38, -3e38, 3e38, -3e38, 88.0, -88.0]
    large_label = label.copy()
    large_label[:8] = [1, -1, 1, -1, -1, 1, -1, 1]
    large_w[:8] = 1.0
    large_w[4:6] = 1e-3  # their losses are 3e38: keep the sums finite
    nan = t0.copy()
    nan[10] = np.nan
    return {
        "first_batch": (t0, None, bias, label, weight),
        "two_terms": (t0, t1, bias, label, weight),
        "zero_margin": (zero, zero, np.float32(0.0), label, weight),
        "labels01": (t0, t1, bias, (label > 0).astype(np.float32), weight),
        "all_padded": (t0, None, bias, label, np.zeros(n, np.float32)),
        "small_weight": (t0, None, bias, label,
                         (weight * (0.37 / max(weight.sum(), 1.0))
                          ).astype(np.float32)),
        "large_margin": (large, None, None, large_label, large_w),
        "nan_margin": (nan, t1, bias, label, weight),
    }


def _on_card(case, shape=None):
    import torch
    t0, t1, bias, label, weight = case
    cuda = torch.device("cuda")

    def put(a):
        t = torch.from_numpy(a).to(cuda)
        return t if shape is None else t.reshape(shape)

    return ([put(t0)] + ([] if t1 is None else [put(t1)]),
            None if bias is None else torch.tensor(bias, device=cuda),
            put(label), put(weight))


def _first_rows(case, count):
    """A K8 case (see objective_cases) cut to its first ``count`` rows."""
    t0, t1, bias, label, weight = case
    return (t0[:count], None if t1 is None else t1[:count], bias,
            label[:count], weight[:count])


def _resized(case, count):
    """A K8 case (see objective_cases) with its rows cut or repeated to
    ``count``."""
    import numpy as np
    t0, t1, bias, label, weight = case
    return (np.resize(t0, count), None if t1 is None else np.resize(t1, count),
            bias, np.resize(label, count), np.resize(weight, count))


def _check_objective(name, got, want, weight):
    """K8's (loss, g, gb) against its plain version's: NaN where the plain
    version's is; the loss (a sum of non-negative terms) to K8_RTOL of
    itself; g to K8_DTOL of weight / W (the rounding of d in [-1, 1]);
    gb to K8_RTOL of sum|g| (0 where every weight is 0). Returns the max
    |err| of g."""
    import torch
    loss, g, gb = got
    p_loss, p_g, p_gb = want
    torch.cuda.synchronize()
    wsum = weight.sum()
    unit = weight.abs() / torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    for what, a, b in (("loss", loss, p_loss), ("g", g, p_g),
                       ("sum g", gb, p_gb)):
        require(torch.equal(torch.isnan(a), torch.isnan(b)),
                f"K8 {name}: {what} is NaN where its plain version's is "
                "not, or the other way round")
    g_err = (g - p_g).abs().nan_to_num()
    ok = (bool((loss - p_loss).abs().nan_to_num()
               <= K8_RTOL * p_loss.abs().nan_to_num() + K8_ATOL)
          and bool((g_err <= K8_DTOL * unit.reshape(g.shape)).all())
          and bool((gb - p_gb).abs().nan_to_num()
                   <= K8_RTOL * p_g.abs().nan_to_num().sum()))
    require(ok, f"K8 {name} disagrees with its plain version: loss "
            f"{loss.item()} vs {p_loss.item()}, g max |err| "
            f"{g_err.max().item()}, sum g {gb.item()} vs {p_gb.item()}")
    return g_err.max().item()


def _check_sgd(name, params, grads, decay, lr, l2, route):
    """K9 on copies of ``params`` against its plain version on others,
    with the loss's l2 term: each parameter to K9_RTOL of |p| + lr·|g| +
    2·lr·l2·|p| (a few roundings of each), the loss to K9_LOSS_RTOL; the
    kernel's call must take ``route`` (read from its trace). Returns the
    max |err| of the parameters."""
    import torch
    from dmlc_tpu_torch.ops import step as step_ops

    def copy(p):
        # a copy at p's offset from a 16-byte boundary (a clone would
        # start on one): K9 cuts a parameter by its alignment
        floats = p.data_ptr() % 16 // 4
        buf = torch.empty(p.numel() + 4, device=p.device)
        return buf[floats:floats + p.numel()].view(p.shape).copy_(p)

    got = [copy(p) for p in params]
    want = [copy(p) for p in params]
    require(all(a.data_ptr() % 16 == p.data_ptr() % 16
                for a, p in zip(got, params)),
            f"K9 {name}: the copies lost the parameters' alignment")
    loss = torch.tensor(0.5, device=params[0].device)
    p_loss = loss.clone()

    def update():
        # from the parameters each time: a trace taken again reruns it
        for a, p in zip(got, params):
            a.copy_(p)
        loss.fill_(0.5)
        step_ops.sgd_update(got, grads, decay, lr, l2, loss)

    on_route("sgd_update", route, update)
    step_ops.sgd_update_plain(want, grads, decay, lr, l2, p_loss)
    torch.cuda.synchronize()
    err = 0.0
    for p, g, a, b, dk in zip(params, grads, got, want, decay):
        scale = p.abs() * (1 + 2 * lr * l2 * dk) + lr * g.abs()
        e = (a - b).abs()
        require(bool((e <= K9_RTOL * scale).all()),
                f"K9 {name} disagrees with its plain version: max |err| "
                f"{e.max().item()}, max |err| / scale "
                f"{(e / scale).nan_to_num().max().item()}")
        err = max(err, e.max().item())
        del e, scale
    require(abs(loss.item() - p_loss.item())
            <= K9_LOSS_RTOL * abs(p_loss.item()),
            f"K9 {name}: the loss with its l2 term {loss.item()} vs the "
            f"plain version's {p_loss.item()}")
    if not l2:
        require(loss.item() == 0.5, f"K9 {name}: l2 = 0 changed the loss")
    del got, want
    return err


def model_params(kind, device, gen):
    """Random parameters and gradients at a model's full width: w and b,
    and V of FM [10^6, 8] or FFM [10^6, 39, 4] (624 MB); the ranking
    model's 137 weights. Returns (params, grads, decay)."""
    import torch
    width = {"linear": (NUM_FEATURES,), "fm": (NUM_FEATURES,),
             "ffm": (NUM_FEATURES,), "ranking": (RANK_NUM_FEATURES,)}[kind]
    shapes = [width, ()]
    if kind == "fm":
        shapes.append((NUM_FEATURES, FM_FACTORS))
    if kind == "ffm":
        shapes.append((NUM_FEATURES, FFM_FIELDS, FFM_FACTORS))
    params = [torch.randn(s, device=device, generator=gen) * 0.1
              for s in shapes]
    grads = [torch.randn(s, device=device, generator=gen) * 1e-3
             for s in shapes]
    return params, grads, [len(s) > 0 for s in shapes]


def check_step_kernels(first):
    """Phase 3b: K8 (the objective and its margin gradient, one launch a
    part and two a sharded step) and K9 (the SGD update, one launch for
    every parameter) against their plain versions on the card, at the main
    path's first batch and edge cases, at the sharded [4, 8192] layout and
    a grid with a partial last block ([3, 2727]), and K9 at the four
    models' widths; then each timed beside its bound, its plain version
    and one PyTorch call, K9 with its inputs cold in L2 (rotating)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dmlc_tpu_torch.ops import step as step_ops
    cuda = torch.device("cuda")
    n = ROW_BUCKET
    label = np.asarray(first["label"], np.float32)
    weight = np.asarray(first["weight"], np.float32)
    require(label.size == n and set(np.unique(label)) <= {-1.0, 1.0},
            "the main path's first batch has other labels than +-1")
    cases = objective_cases(label, weight)
    errs = {}
    for name, case in cases.items():
        args = _on_card(case)
        before = step_ops.logistic_step.launches
        got = step_ops.logistic_step(*args)
        require(step_ops.logistic_step.launches == before + 1,
                f"K8 {name}: the wrapper did not count its launch")
        errs[name] = _check_objective(
            name, got, step_ops.logistic_step_plain(*args), args[3])
        # the sharded layout: [4, rows / 4] of one process
        sh = _on_card(case, (SHARD_PARTS, n // SHARD_PARTS))
        total = step_ops.logistic_sums(*sh)
        p_total = step_ops.logistic_sums_plain(*sh)
        torch.cuda.synchronize()
        require(bool(torch.allclose(total, p_total, rtol=K8_RTOL,
                                    atol=K8_ATOL, equal_nan=True)),
                f"K8 sums {name}: {total.tolist()} vs the plain version's "
                f"{p_total.tolist()}")
        _check_objective(f"{name}, sharded", step_ops.logistic_grad(
            *sh, p_total), step_ops.logistic_grad_plain(*sh, p_total),
            sh[3])
        # a grid whose last block is partial: [3, 2727] of the rows
        odd = _on_card(_first_rows(case, 3 * 2727), (3, 2727))
        odd_total = step_ops.logistic_sums(*odd)
        p_odd = step_ops.logistic_sums_plain(*odd)
        torch.cuda.synchronize()
        require(bool(torch.allclose(odd_total, p_odd, rtol=K8_RTOL,
                                    atol=K8_ATOL, equal_nan=True)),
                f"K8 sums {name} over [3, 2727]: {odd_total.tolist()} vs "
                f"the plain version's {p_odd.tolist()}")
        _check_objective(f"{name}, sharded [3, 2727]",
                         step_ops.logistic_grad(*odd, p_odd),
                         step_ops.logistic_grad_plain(*odd, p_odd), odd[3])
    zl, zg, _ = step_ops.logistic_step(*_on_card(cases["zero_margin"]))
    y = torch.from_numpy((label > 0).astype(np.float32)).to(cuda)
    w = torch.from_numpy(weight).to(cuda)
    require(bool(torch.allclose(zg, -y * w / w.sum(), rtol=1e-6, atol=0)),
            "K8 at m = 0: g is not -y * w / W (ROADMAP C4)")
    # one part at other row counts: partial blocks of the grid route, its
    # cap and one row past it (the split route); each case's arrays cut or
    # repeated to the rows
    cap = step_ops.OBJECTIVE_STEP_MAX_ROWS
    counts = (1, 511, 513, 8181, cap, cap + 1)
    for count in counts:
        route = step_ops.objective_route(count)
        for name, case in cases.items():
            args = _on_card(_resized(case, count))
            if name == "two_terms":  # the route, from the trace
                out = []
                _device_us_by_kernel(
                    lambda: out.append(step_ops.logistic_step(*args)), 1,
                    OBJECTIVE_ROUTE_CALLS[route])
                got = out[-1]
            else:
                got = step_ops.logistic_step(*args)
            _check_objective(f"{name} at {count} rows ({route} route)", got,
                             step_ops.logistic_step_plain(*args), args[3])
    # the grid route with its inputs one float off their allocation, so
    # the blocks sum the weights by scalar loads
    def off(t):
        return torch.empty(t.numel() + 1, device=cuda)[1:].copy_(t)

    terms, bias, y_off, w_off = _on_card(cases["two_terms"])
    args = ([off(t) for t in terms], bias, off(y_off), off(w_off))
    out = []
    _device_us_by_kernel(lambda: out.append(step_ops.logistic_step(*args)), 1,
                         OBJECTIVE_ROUTE_CALLS["grid"])
    _check_objective("two_terms one float off the allocation", out[-1],
                     step_ops.logistic_step_plain(*args), args[3])
    log(f"K8 on one part agrees with its plain version on every case at "
        f"{', '.join(map(str, counts))} rows, each route read from the "
        f"trace: grid up to {cap} rows, split past it; and at {n} rows "
        "with its inputs one float off their allocation")
    log("K8 agrees with its plain version (one part, and its two sharded "
        f"launches over [{SHARD_PARTS}, {n // SHARD_PARTS}] and "
        "[3, 2727]) on "
        + ", ".join(f"{k} (g max |err| {v:.3g})" for k, v in errs.items())
        + f"; at m = 0, g = -y w / W (rtol {K8_RTOL} of the loss, "
        f"{K8_DTOL} of w / W for g)")

    gen = torch.Generator(device=cuda).manual_seed(SEED + 9)
    sgd_errs = {}
    routes = {"linear": "wide", "fm": "wide", "ffm": "wide",
              "ranking": "narrow"}
    for kind in ("linear", "fm", "ffm", "ranking"):
        params, grads, decay = model_params(kind, cuda, gen)
        for l2 in (0.0, 0.01):
            sgd_errs[kind, l2] = _check_sgd(f"{kind} l2={l2}", params, grads,
                                            decay, 0.5, l2, routes[kind])
        del params, grads
        torch.cuda.empty_cache()
    # the float4 body and the scalar head and tail: a parameter one float
    # off its allocation (and of a length not a multiple of 4), its
    # gradient aligned alike or not, beside the bias
    buf = torch.randn(NUM_FEATURES + 8, device=cuda, generator=gen)
    gbuf = torch.randn(NUM_FEATURES + 8, device=cuda, generator=gen)
    span = NUM_FEATURES + 3
    for what, g in (("aligned alike", gbuf[1:1 + span]),
                    ("aligned apart", gbuf[2:2 + span])):
        sgd_errs[what, 0.01] = _check_sgd(
            f"one float off its allocation, gradient {what}",
            [buf[1:1 + span], buf[-1]], [g, gbuf[-1]], [True, False], 0.5,
            0.01, "wide")
    # the narrow route: the bias alone; the ranking model's w one float off
    # its allocation, its gradient aligned alike and apart; the widest w
    # beside the bias that it takes (NARROW_WIDEST) and one float more,
    # which takes the wide route
    buf = torch.randn(RANK_NUM_FEATURES + 8, device=cuda, generator=gen)
    gbuf = torch.randn(RANK_NUM_FEATURES + 8, device=cuda, generator=gen)
    span = RANK_NUM_FEATURES
    narrow = {"bias alone": ([buf[-1]], [gbuf[-1]], [False], "narrow")}
    for what, g in (("aligned alike", gbuf[1:1 + span]),
                    ("aligned apart", gbuf[2:2 + span])):
        narrow[f"[{span}, 1] one float off its allocation, gradient "
               f"{what}"] = ([buf[1:1 + span], buf[-1]], [g, gbuf[-1]],
                             [True, False], "narrow")
    for width, route in ((NARROW_WIDEST, "narrow"),
                         (NARROW_WIDEST + 1, "wide")):
        p = [torch.randn(width, device=cuda, generator=gen),
             torch.randn((), device=cuda, generator=gen)]
        narrow[f"[{width}, 1]"] = (p, [torch.randn_like(x) for x in p],
                                   [True, False], route)
    for what, (p, g, dk, route) in narrow.items():
        require(step_ops.sgd_route([x.numel() for x in p],
                                   [(x.data_ptr(), y.data_ptr())
                                    for x, y in zip(p, g)]) == route,
                f"K9 {what}: sgd_route does not pick the {route} route")
        for l2 in (0.0, 0.01):
            sgd_errs[what, l2] = _check_sgd(f"{what} ({route}) l2={l2}", p,
                                            g, dk, 0.5, l2, route)
    log("K9 agrees with its plain version at l2 = 0 and 0.01 on the "
        "parameters of the linear model, FM (V 8e6 floats), FFM (V "
        f"{NUM_FEATURES * FFM_FIELDS * FFM_FACTORS} floats) and the ranking "
        "model, on a parameter one float off its allocation, and on the "
        "narrow route's edges, each route read from the trace: "
        + ", ".join(f"{k} l2={l2} {v:.3g}"
                    for (k, l2), v in sgd_errs.items())
        + f" (rtol {K9_RTOL} of |p| + lr |g| + 2 lr l2 |p|; the loss's l2 "
        f"term rtol {K9_LOSS_RTOL})")

    # Timing: K8 at the main path's first batch (margins = K1's + b) and
    # at the sharded layout; K9 at each model's width, l2 = 0
    rows = []
    t = _on_card(cases["first_batch"])
    m = t[0][0] + t[1]
    y01 = (t[2] > 0).to(torch.float32)
    k8_bytes = n * 16 + 4 + 3 * 4
    k8_ops = n * K8_OPS_PER_ROW
    k8_ms = device_ms(lambda: step_ops.logistic_step(*t),
                      calls={"logistic_step_kernel": 1})
    k8_call = call_ms(lambda: step_ops.logistic_step(*t))
    k8_plain = device_ms(lambda: step_ops.logistic_step_plain(*t))
    k8_lib = device_ms(lambda: F.binary_cross_entropy_with_logits(
        m, y01, t[3], reduction="sum"))
    bound, by = bound_ms(k8_bytes, k8_ops)
    rows.append({"name": "logistic_step", "route": "cuda",
                 "source": "dmlc_tpu_torch/csrc/step.cu",
                 "replaces": "dmlc_tpu/models/common.py:28",
                 "max_abs_err": errs["first_batch"], "ms": k8_ms,
                 "plain_ms": k8_plain, "bound_ms": bound, "bound_by": by,
                 "library_ms": k8_lib, "call_ms": k8_call})
    sh = _on_card((np.tile(cases["first_batch"][0], SHARD_PARTS), None,
                   np.float32(0.1), np.tile(label, SHARD_PARTS),
                   np.tile(weight, SHARD_PARTS)), (SHARD_PARTS, n))
    total = step_ops.logistic_sums(*sh)
    sh_m = sh[0][0] + sh[1]
    sh_y = (sh[2] > 0).to(torch.float32)
    for name, replaces, fn, plain, nbytes in (
            ("logistic_sums", "dmlc_tpu/models/common.py:18",
             lambda: step_ops.logistic_sums(*sh),
             lambda: step_ops.logistic_sums_plain(*sh),
             SHARD_PARTS * n * 12 + 4 + 8),
            ("logistic_grad", "dmlc_tpu/models/common.py:132",
             lambda: step_ops.logistic_grad(*sh, total),
             lambda: step_ops.logistic_grad_plain(*sh, total),
             SHARD_PARTS * n * 16 + 4 + 8 + 3 * 4)):
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        if name == "logistic_sums":
            err = (got - want).abs().max().item()
        else:
            err = _check_objective("sharded timing batch", got, want, sh[3])
        k_ms = device_ms(fn, calls={f"{name}_kernel": 1})
        bound, by = bound_ms(nbytes, SHARD_PARTS * n * K8_OPS_PER_ROW)
        rows.append({"name": name, "route": "cuda",
                     "source": "dmlc_tpu_torch/csrc/step.cu",
                     "replaces": replaces, "max_abs_err": err, "ms": k_ms,
                     "plain_ms": device_ms(plain), "bound_ms": bound,
                     "bound_by": by,
                     "library_ms": device_ms(
                         lambda: F.binary_cross_entropy_with_logits(
                             sh_m, sh_y, sh[3], reduction="sum")),
                     "call_ms": call_ms(fn)})
    log(f"K8 timed at the main path's first batch ({n} rows) and at the "
        f"sharded layout [{SHARD_PARTS}, {n}]; library: "
        "F.binary_cross_entropy_with_logits(m, y, weight, reduction='sum') "
        "on the summed margins")
    for kind in ("linear", "fm", "ffm", "ranking"):
        params, grads, decay = model_params(kind, cuda, gen)
        floats = sum(p.numel() for p in params)
        # cold: at the linear width p and g (8 MB) would stay in L2 from
        # one call to the next, and the kernel would beat its HBM bound
        turn, copies = rotating([params, grads], floats * 8)

        def k9():
            p, g = turn()
            step_ops.sgd_update(p, g, decay, LEARNING_RATE, 0.0)

        def k9_plain():
            p, g = turn()
            step_ops.sgd_update_plain(p, g, decay, LEARNING_RATE, 0.0)

        def k9_lib():
            p, g = turn()
            torch._foreach_add_(p, g, alpha=-LEARNING_RATE)

        k9_ms = device_ms(k9, iters=20,
                          calls=route_calls("sgd_update", routes[kind]))
        k9_plain_ms = device_ms(k9_plain, iters=20)
        k9_lib = device_ms(k9_lib, iters=20)
        bound, by = bound_ms(floats * 12, floats * 2)
        log(f"K9 at the {kind} model's {floats} floats ({routes[kind]} "
            f"route), rotating over {copies} copies of p and g: kernel "
            f"{k9_ms * 1e3:.2f} us, plain {k9_plain_ms * 1e3:.2f} us, "
            f"torch._foreach_add_ {k9_lib * 1e3:.2f} us, bound "
            f"{bound * 1e3:.2f} us ({by})")
        if kind in ("linear", "ranking"):
            # the ranking width's row (the narrow route) is reported with
            # the ranking path's launches
            rows.append({"name": "sgd_update", "route": "cuda",
                         "source": "dmlc_tpu_torch/csrc/step.cu",
                         "replaces": "dmlc_tpu/models/common.py:91",
                         "max_abs_err": sgd_errs[kind, 0.0],
                         "ms": k9_ms, "plain_ms": k9_plain_ms,
                         "bound_ms": bound, "bound_by": by,
                         "library_ms": k9_lib, "call_ms": call_ms(k9),
                         "path": kind})
        del params, grads, turn
        torch.cuda.empty_cache()
    return rows


def _row_sums(offset, per_nnz):
    """Per-row sums of a per-nonzero tensor (the padded tail dropped)."""
    from dmlc_tpu_torch.ops import csr
    n = offset.numel() - 1
    rows = csr.csr_row_ids(offset, per_nnz.shape[0]).clamp(0, n)
    out = per_nnz.new_zeros((n + 1,) + tuple(per_nnz.shape[1:]))
    return out.index_add_(0, rows, per_nnz)[:n]


def _check_pair(name, pair, plain, scale, bad_rows, finite_rows):
    """A forward's pair against its plain version: NaN in the rows of
    invalid indices only, 0 in empty and padded rows, |err| <= atol + rtol
    * scale (each row's sum|terms|). Returns (max |err|, max |err| /
    scale)."""
    import torch
    nan_rows = torch.isnan(pair).nonzero().flatten().tolist()
    require(nan_rows == bad_rows,
            f"{name}: NaN rows {nan_rows}, want {bad_rows}")
    require(torch.isnan(plain).nonzero().flatten().tolist() == nan_rows,
            f"{name}: the plain version's NaN rows differ")
    require(bool((pair[[3, 7]] == 0).all())
            and bool((pair[ROW_BUCKET - 100:] == 0).all()),
            f"{name}: empty or padded rows are not 0")
    require(bool(torch.isfinite(pair[finite_rows]).all()),
            f"{name}: rows {finite_rows} are not finite")
    err = (pair - plain).nan_to_num().abs()
    scale = scale.nan_to_num()
    require(bool((err <= PAIR_ATOL + PAIR_RTOL * scale).all()),
            f"{name} disagrees with its plain version: max |err| "
            f"{err.max().item()}, max |err| / sum|terms| "
            f"{(err / scale).nan_to_num().max().item()}")
    return err.max().item(), (err / scale).nan_to_num().max().item()


def _check_grad(name, gV, plain, want_nan):
    """A backward's gV against its plain version: NaN exactly where the
    reference's gradient is NaN (``want_nan``, over gV's leading dims),
    allclose elsewhere. Returns max |err|."""
    import torch
    nan = torch.isnan(gV)
    require(torch.equal(nan, torch.isnan(plain)),
            f"{name}: NaN entries differ from the plain version's")
    require(torch.equal(nan.any(-1), want_nan)
            and torch.equal(nan.all(-1), want_nan),
            f"{name}: NaN at {int(nan.any(-1).sum())} places, want "
            f"{int(want_nan.sum())} (the out-of-range row's features)")
    require(torch.allclose(gV, plain, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                           equal_nan=True),
            f"{name} disagrees with its plain version: max |err| "
            f"{(gV - plain).nan_to_num().abs().max().item()}")
    require(bool((gV[NUM_FEATURES - 1] != 0).any()),
            f"{name}: the index at F-1 got no gradient")
    return (gV - plain).nan_to_num().abs().max().item()


def check_factor_kernels(first):
    """K5 and K6, forward and backward, against their plain versions on
    the card, at the libfm path's shapes with edge cases written in, u32
    and u64 index; then each timed at the path's first batch."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.ops import csr, fm
    from dmlc_tpu_torch.ops.index import clip_field, wrap_index

    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED + 3)
    off, idx, val, fld, bad_rows = edge_case_batch(first)
    t_off, t_val, t_fld = (torch.from_numpy(a).to(cuda)
                           for a in (off, val, fld))
    g = torch.randn(ROW_BUCKET, generator=gen, device=cuda)
    V5 = INIT_SCALE * torch.randn(NUM_FEATURES, FM_FACTORS, generator=gen,
                                  device=cuda)
    V6 = INIT_SCALE * torch.randn(NUM_FEATURES, FFM_FIELDS, FFM_FACTORS,
                                  generator=gen, device=cuda)
    # where the reference's gradient is NaN: at the features of the
    # invalid rows' other nonzeros (FM), and there for the bad nonzero's
    # own field only (FFM)
    nan5 = torch.zeros(NUM_FEATURES, dtype=torch.bool, device=cuda)
    nan6 = torch.zeros(NUM_FEATURES, FFM_FIELDS, dtype=torch.bool,
                       device=cuda)
    for row in bad_rows:
        lo, hi = int(off[row]), int(off[row + 1])
        entries, valid = wrap_index(torch.from_numpy(idx[lo:hi]),
                                    NUM_FEATURES)
        require(int((~valid).sum()) == 1, f"row {row}: not one invalid index")
        bad_k = lo + int((~valid).nonzero()[0, 0])
        others = entries[valid].to(cuda)
        nan5[others] = True
        nan6[others, int(clip_field(torch.tensor(int(fld[bad_k])),
                                    FFM_FIELDS))] = True
    clipped_rows = [30, 40, 50, 70, 80]
    errs = {}
    for dtype in (np.uint32, np.uint64):
        t_idx = torch.from_numpy(idx.astype(dtype)).to(cuda)
        name = np.dtype(dtype).name
        args = (t_off, t_idx, t_val)
        abs_args = (t_off, t_idx, t_val.abs())
        # K5 forward and backward
        pair, s = on_route("fm_pair_fwd", "vector",
                           lambda: fm.fm_pair_fwd(*args, V5))
        pair_p, s_p = fm.fm_pair_fwd_plain(*args, V5)
        pair_a, s_a = fm.fm_pair_fwd_plain(*abs_args, V5.abs())
        torch.cuda.synchronize()
        e5 = _check_pair(f"fm_pair_fwd {name}", pair, pair_p,
                         (s_a * s_a).sum(-1) - pair_a, bad_rows,
                         clipped_rows)
        s_err = (s - s_p).nan_to_num().abs()
        require(bool((s_err <= PAIR_ATOL
                      + PAIR_RTOL * s_a.nan_to_num()).all())
                and torch.equal(torch.isnan(s), torch.isnan(s_p)),
                f"fm_pair_fwd {name}: s disagrees with the plain version's: "
                f"max |err| {s_err.max().item()}")
        gv = on_route("fm_pair_bwd", "vector",
                      lambda: fm.fm_pair_bwd(*args, V5, s, g))
        gv_p = fm.fm_pair_bwd_plain(*args, V5, s, g)
        torch.cuda.synchronize()
        g5 = _check_grad(f"fm_pair_bwd {name} (vector route)", gv, gv_p,
                         nan5)
        del gv, gv_p
        # K6 forward and backward
        pair = fm.ffm_pair_fwd(*args, t_fld, V6)
        pair_p = fm.ffm_pair_fwd_plain(*args, t_fld, V6)
        pair_a = fm.ffm_pair_fwd_plain(*abs_args, t_fld, V6.abs())
        v_own = V6.abs()[wrap_index(t_idx, NUM_FEATURES)[0],
                         clip_field(t_fld, FFM_FIELDS)]
        diag_a = _row_sums(t_off, (t_val[:, None] * v_own).pow(2).sum(-1))
        torch.cuda.synchronize()
        e6 = _check_pair(f"ffm_pair_fwd {name}", pair, pair_p,
                         pair_a + diag_a, bad_rows, clipped_rows)
        gv = fm.ffm_pair_bwd(*args, t_fld, V6, g)
        gv_p = fm.ffm_pair_bwd_plain(*args, t_fld, V6, g)
        torch.cuda.synchronize()
        g6 = _check_grad(f"ffm_pair_bwd {name}", gv, gv_p, nan6)
        del gv, gv_p, v_own
        if dtype is np.uint32:
            errs = {"fm_pair_fwd": e5, "fm_pair_bwd": g5,
                    "ffm_pair_fwd": e6, "ffm_pair_bwd": g6}
    torch.cuda.empty_cache()
    log("factor kernels agree with their plain versions (u32 and u64 "
        "index; empty rows, padded tail with an invalid index, index at "
        "F-1, an out-of-range index, indices 2^32-1, 2^31 and 2^32+3, "
        "fields past the fields, below 0 and at 2^31): "
        + ", ".join(f"{k} max |err| {v[0]:.3g} (/ sum|terms| {v[1]:.3g})"
                    if isinstance(v, tuple) else f"{k} max |err| {v:.3g}"
                    for k, v in errs.items())
        + f"; forward rtol {PAIR_RTOL} of sum|terms|, atol {PAIR_ATOL}; "
        f"backward rtol {GRAD_RTOL}, atol {GRAD_ATOL}")

    # Timing, at the libfm path's first batch as it came from the parser.
    b_off, b_idx, b_val, b_fld = (torch.from_numpy(first[k]).to(cuda)
                                  for k in ("offset", "index", "value",
                                            "field"))
    n, nnz = ROW_BUCKET, int(first["num_nnz"])
    distinct = int(np.unique(first["index"][:nnz]).size)
    rows_of = np.repeat(np.arange(n), np.diff(first["offset"]))
    fields_present = np.unique(rows_of * FFM_FIELDS
                               + first["field"][:nnz]) // FFM_FIELDS
    pairs_needed = int((np.bincount(fields_present, minlength=n) ** 2).sum())
    csr_bytes = (n + 1) * 8 + nnz * (4 + 4)
    K, nf, K6 = FM_FACTORS, FFM_FIELDS, FFM_FACTORS
    args = (b_off, b_idx, b_val)
    _, s_b = fm.fm_pair_fwd(*args, V5)
    work = {
        "fm_pair_fwd": (
            lambda: fm.fm_pair_fwd(*args, V5),
            lambda: fm.fm_pair_fwd_plain(*args, V5),
            csr_bytes + distinct * K * 4 + n * 4 + n * K * 4,
            4 * nnz * K + 3 * n * K),
        "fm_pair_bwd": (
            lambda: fm.fm_pair_bwd(*args, V5, s_b, g),
            lambda: fm.fm_pair_bwd_plain(*args, V5, s_b, g),
            csr_bytes + distinct * K * 4 + n * K * 4 + n * 4
            + NUM_FEATURES * K * 4,
            5 * nnz * K),
        "ffm_pair_fwd": (
            lambda: fm.ffm_pair_fwd(*args, b_fld, V6),
            lambda: fm.ffm_pair_fwd_plain(*args, b_fld, V6),
            csr_bytes + nnz * 8 + distinct * nf * K6 * 4 + n * 4,
            2 * nnz * nf * K6 + 2 * pairs_needed * K6 + 2 * nnz * K6),
        "ffm_pair_bwd": (
            lambda: fm.ffm_pair_bwd(*args, b_fld, V6, g),
            lambda: fm.ffm_pair_bwd_plain(*args, b_fld, V6, g),
            csr_bytes + nnz * 8 + distinct * nf * K6 * 4 + n * 4
            + NUM_FEATURES * nf * K6 * 4,
            5 * nnz * nf * K6 + 2 * nnz * K6),
    }
    # The library yardstick for K5 forward: two cuSPARSE products compute
    # its sums s = A V and sq = (A∘A)(V∘V) (not the pair, which needs one
    # more elementwise pass). No single PyTorch call computes K5 backward
    # or K6.
    a1 = torch.sparse_csr_tensor(b_off, b_idx[:nnz].to(torch.int64),
                                 b_val[:nnz], size=(n, NUM_FEATURES))
    a2 = torch.sparse_csr_tensor(b_off, b_idx[:nnz].to(torch.int64),
                                 b_val[:nnz] * b_val[:nnz],
                                 size=(n, NUM_FEATURES))
    V5sq = V5 * V5
    s_lib = a1 @ V5
    _, s_abs = fm.fm_pair_fwd_plain(b_off, b_idx, b_val.abs(), V5.abs())
    require(bool(((s_lib - s_b).abs() <= PAIR_ATOL
                  + PAIR_RTOL * s_abs).all()),
            "fm_pair_fwd's s disagrees with torch.sparse on the path's batch")
    library = {"fm_pair_fwd": device_ms(lambda: (a1 @ V5, a2 @ V5sq))}
    k5_fill, k5_kernel = _fill_and_kernel(
        lambda: fm.fm_pair_bwd(*args, V5, s_b, g), "fm_pair_bwd", "vector")
    log(f"fm_pair_bwd at the libfm path's batch (vector route): kernel "
        f"{k5_kernel * 1e3:.2f} us, zero fill {k5_fill * 1e3:.2f} us on the "
        "device")
    # K5 forward's scalar route at the same batch: V viewed one float off
    # its allocation
    V5_off = torch.empty(V5.numel() + 1, device=cuda)[1:].view(V5.shape)
    V5_off.copy_(V5)
    pair_off, _ = on_route("fm_pair_fwd", "scalar",
                           lambda: fm.fm_pair_fwd(*args, V5_off))
    pair_vec, _ = fm.fm_pair_fwd(*args, V5)
    torch.cuda.synchronize()
    _, s_abs_b = fm.fm_pair_fwd_plain(*args, V5.abs())
    require(bool(((pair_off - pair_vec).abs() <= PAIR_ATOL + PAIR_RTOL
                  * (s_abs_b * s_abs_b).sum(-1)).all()),
            "fm_pair_fwd's scalar route disagrees with its vector route at "
            "the path's batch")
    k5_scalar = device_ms(lambda: fm.fm_pair_fwd(*args, V5_off),
                          calls=route_calls("fm_pair_fwd", "scalar"))
    del V5_off
    log(f"fm_pair_fwd at the libfm path's batch by its scalar route (V one "
        f"float off its allocation): {k5_scalar * 1e3:.2f} us on the device")
    # K1 at this batch (its half route): held to its plain version, timed
    w1 = torch.randn(NUM_FEATURES, generator=gen, device=cuda)
    k1_err = _check_k1("at the libfm path's batch", *args, w1, "half", [])
    k1_bound, k1_by = bound_ms(csr_bytes + distinct * 4 + n * 4, 2 * nnz)
    k1_ms = device_ms(lambda: csr.csr_spmv(*args, w1),
                      calls=route_calls("csr_spmv", "half"))
    log(f"csr_spmv at the libfm path's batch (half route; max |err| "
        f"{k1_err[0]:.3g}): {k1_ms * 1e3:.2f} us on the device, bound "
        f"{k1_bound * 1e3:.2f} us ({k1_by})")
    del w1
    log(f"factor kernels timed at the libfm path's first batch: {n} rows, "
        f"{nnz} nonzeros of {LIBFM_NNZ_BUCKET}, {distinct} distinct "
        f"features, {pairs_needed} (row, field, field) pairs present")
    replaces = {"fm_pair_fwd": "dmlc_tpu/models/fm.py:43",
                "fm_pair_bwd": "dmlc_tpu/models/fm.py:43",
                "ffm_pair_fwd": "dmlc_tpu/models/fm.py:117",
                "ffm_pair_bwd": "dmlc_tpu/models/fm.py:117"}
    calls = dict(KERNEL_CALLS,
                 fm_pair_fwd=route_calls("fm_pair_fwd", "vector"),
                 fm_pair_bwd=route_calls("fm_pair_bwd", "vector"))
    rows = []
    for name, (kernel, plain, nbytes, ops) in work.items():
        b, by = bound_ms(nbytes, ops)
        err = errs[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "dmlc_tpu_torch/csrc/fm.cu",
            "replaces": replaces[name],
            "max_abs_err": err[0] if isinstance(err, tuple) else err,
            "ms": device_ms(kernel, calls=calls[name]),
            "plain_ms": device_ms(plain),
            "bound_ms": b, "bound_by": by,
            "library_ms": library.get(name), "call_ms": call_ms(kernel)})
    del V6, a1, a2
    torch.cuda.empty_cache()
    return rows


def _check_k5_row_lengths():
    """K5 forward against its plain version on the row-length batch (see
    row_length_batch) at 1, 3, 4, 8, 12, 32, 33 and 40 factors, u32 and
    u64 index: pair and s, NaN in the invalid index's row only, 0 in empty
    rows, the route read from the trace (vector where K % 4 == 0, else
    scalar), and at K % 4 == 0 also on a V viewed one float off its
    allocation (scalar). Returns what it checked."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.ops import fm
    cuda = torch.device("cuda")
    rng = np.random.RandomState(SEED + 17)
    off, idx, val, bad = row_length_batch(64)
    t_off, t_val = (torch.from_numpy(a).to(cuda) for a in (off, val))
    empty = (t_off[1:] == t_off[:-1]).nonzero().flatten().tolist()
    worst = 0.0
    for K in (1, 3, 4, 8, 12, 32, 33, 40):
        V = torch.from_numpy((0.3 * rng.randn(ROW_LENGTH_FEATURES, K))
                             .astype(np.float32)).to(cuda)
        views = [("vector" if K % 4 == 0 else "scalar", V)]
        if K % 4 == 0:
            V_off = torch.empty(V.numel() + 1, device=cuda)[1:].view(V.shape)
            V_off.copy_(V)
            views.append(("scalar", V_off))
        for dtype in (np.uint32, np.uint64):
            t_idx = torch.from_numpy(idx.astype(dtype)).to(cuda)
            args = (t_off, t_idx, t_val)
            pair_p, s_p = fm.fm_pair_fwd_plain(*args, V)
            pair_a, s_a = fm.fm_pair_fwd_plain(t_off, t_idx, t_val.abs(),
                                               V.abs())
            scale = ((s_a * s_a).sum(-1) - pair_a).nan_to_num()
            for route, Vr in views:
                what = (f"K5 forward with {K} factors, rows of "
                        f"{ROW_LENGTHS} nonzeros, {np.dtype(dtype).name}, "
                        f"{route} route")
                pair, s = on_route("fm_pair_fwd", route,
                                   lambda: fm.fm_pair_fwd(*args, Vr))
                torch.cuda.synchronize()
                require(torch.isnan(pair).nonzero().flatten().tolist() == bad
                        and torch.equal(torch.isnan(s), torch.isnan(s_p)),
                        f"{what}: NaN rows differ from {bad}")
                require(bool((pair[empty] == 0).all()),
                        f"{what}: empty rows are not 0")
                err = (pair - pair_p).nan_to_num().abs()
                s_err = (s - s_p).nan_to_num().abs()
                require(bool((err <= PAIR_ATOL + PAIR_RTOL * scale).all())
                        and bool((s_err <= PAIR_ATOL + PAIR_RTOL
                                  * s_a.nan_to_num()).all()),
                        f"{what} disagrees with its plain version: max "
                        f"|err| {err.max().item()}, s {s_err.max().item()}")
                worst = max(worst, (err / scale).nan_to_num().max().item())
    return (f"K5 forward on rows of {ROW_LENGTHS} nonzeros at 1, 3, 4, 8, "
            f"12, 32, 33 and 40 factors, u32 and u64, V aligned and one "
            f"float off (max |err| / sum|terms| {worst:.3g})")


def check_factor_shapes():
    """K5 and K6 against their plain versions at shapes other than the
    path's, on small seeded batches: K5 with 3 and 40 factors (not a power
    of two; more than a warp's lanes), K6 with 3 fields of 5 factors
    (several nonzeros of a row in one field add into one entry of S),
    with 60 fields (S and D take 58.6 KB, past the 48 KB default: the
    opt-in size) and with 50 fields of 6 factors, rows of up to 150
    nonzeros (300 columns of S, more than a block's 256 threads, and 256 %
    6 != 0, so a thread's second column wraps its factor; 61.2 KB; 64
    nonzeros staged at a time); and K6 at 39 fields of 40 factors, 120 of
    4 and 300 of 1, whose S and D pass a block's shared memory (ROADMAP
    C8): they take the global route, S in a workspace in device memory,
    and must match too, while 39 of 4 keeps the shared route. Then the
    global route timed at 39 x 40 on a batch of 2048 rows."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.ops import fm
    from dmlc_tpu_torch.ops.kernels import max_shared_bytes
    cuda = torch.device("cuda")
    rng = np.random.RandomState(SEED + 5)

    def batch(rows, features, fields, factors, max_nnz):
        lens = rng.randint(0, max_nnz + 1, rows)
        off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        nnz = int(off[-1])
        shape = ((features, factors) if fields is None
                 else (features, fields, factors))
        return [torch.from_numpy(a).to(cuda) for a in (
            off, rng.randint(0, features, nnz).astype(np.uint32),
            rng.rand(nnz).astype(np.float32),
            rng.randint(0, fields or 1, nnz).astype(np.int64),
            (0.3 * rng.randn(*shape)).astype(np.float32),
            rng.randn(rows).astype(np.float32))]

    most = max_shared_bytes(cuda) - fm.FFM_STATIC_SHARED_BYTES
    routes = {(f, k): fm.ffm_route(f, k, most)
              for f, k in ((FFM_FIELDS, FFM_FACTORS), (39, 40), (120, 4),
                           (300, 1))}
    require(routes == {(FFM_FIELDS, FFM_FACTORS): "shared", (39, 40): "global",
                       (120, 4): "global", (300, 1): "global"},
            f"K6 routes at {most} bytes of shared memory a block: {routes}")
    done = []
    for fields, factors, max_nnz in ((None, 3, 30), (None, 40, 70),
                                     (3, 5, 30), (60, 4, 40), (50, 6, 150),
                                     (39, 40, 39), (120, 4, 80),
                                     (300, 1, 60)):
        off, idx, val, fld, V, g = batch(300, 500, fields, factors, max_nnz)
        csr_cols, abs_cols = (off, idx, val), (off, idx, val.abs())
        if fields is None:
            route = "vector" if factors % 4 == 0 else "scalar"
            pair, s = on_route("fm_pair_fwd", route,
                               lambda: fm.fm_pair_fwd(*csr_cols, V))
            plain, _ = fm.fm_pair_fwd_plain(*csr_cols, V)
            pair_a, s_a = fm.fm_pair_fwd_plain(*abs_cols, V.abs())
            scale = (s_a * s_a).sum(-1) - pair_a
            gv = on_route("fm_pair_bwd", route,
                          lambda: fm.fm_pair_bwd(*csr_cols, V, s, g))
            gv_p = fm.fm_pair_bwd_plain(*csr_cols, V, s, g)
        else:
            pair = fm.ffm_pair_fwd(*csr_cols, fld, V)
            plain = fm.ffm_pair_fwd_plain(*csr_cols, fld, V)
            v_own = V.abs()[idx.to(torch.int64), fld]
            scale = (fm.ffm_pair_fwd_plain(*abs_cols, fld, V.abs())
                     + _row_sums(off, (val[:, None] * v_own).pow(2).sum(-1)))
            gv = fm.ffm_pair_bwd(*csr_cols, fld, V, g)
            gv_p = fm.ffm_pair_bwd_plain(*csr_cols, fld, V, g)
        torch.cuda.synchronize()
        what = (f"K5 with {factors} factors ({route} backward)"
                if fields is None
                else f"K6 with {fields} fields of {factors} factors ("
                f"{fm.ffm_route(fields, factors, most)} route)")
        require(bool(((pair - plain).abs()
                      <= PAIR_ATOL + PAIR_RTOL * scale).all()),
                f"{what}: the forward disagrees with its plain version: "
                f"max |err| {(pair - plain).abs().max().item()}")
        require(torch.allclose(gv, gv_p, rtol=GRAD_RTOL, atol=GRAD_ATOL),
                f"{what}: the backward disagrees with its plain version: "
                f"max |err| {(gv - gv_p).abs().max().item()}")
        done.append(what)
        del pair, plain, gv, gv_p, scale
    # V as a view one float past the allocator's alignment: K5 forward and
    # backward must take their scalar routes, and agree
    off, idx, val, _, V, g = batch(300, 500, None, FM_FACTORS, 30)
    V_off = torch.empty(V.numel() + 1, device=cuda)[1:].view(V.shape)
    V_off.copy_(V)
    _, s = on_route("fm_pair_fwd", "scalar",
                    lambda: fm.fm_pair_fwd(off, idx, val, V_off))
    gv = on_route("fm_pair_bwd", "scalar",
                  lambda: fm.fm_pair_bwd(off, idx, val, V_off, s, g))
    gv_p = fm.fm_pair_bwd_plain(off, idx, val, V_off, s, g)
    torch.cuda.synchronize()
    require(torch.allclose(gv, gv_p, rtol=GRAD_RTOL, atol=GRAD_ATOL),
            f"K5 backward on a misaligned V disagrees with its plain "
            f"version: max |err| {(gv - gv_p).abs().max().item()}")
    done.append(f"K5 with {FM_FACTORS} factors, V misaligned (scalar "
                "forward and backward)")
    del V_off, gv, gv_p
    done.append(_check_k5_row_lengths())
    torch.cuda.empty_cache()
    log(f"factor kernels agree with their plain versions at other shapes "
        f"({'; '.join(done)}; u32 index, {most} bytes of shared memory a "
        "block)")
    off, idx, val, fld, V, g = batch(2048, 20000, 39, 40, 39)
    nnz = int(off[-1])
    fwd_ms = device_ms(lambda: fm.ffm_pair_fwd(off, idx, val, fld, V),
                       calls=KERNEL_CALLS["ffm_pair_fwd"])
    bwd = _device_us_by_kernel(
        lambda: [fm.ffm_pair_bwd(off, idx, val, fld, V, g)
                 for _ in range(20)], 20, KERNEL_CALLS["ffm_pair_bwd"])
    bwd_kernel = sum(t for k, (t, _) in bwd.items()
                     if _launched(k, "ffm_pair_bwd_kernel"))
    log(f"K6 global route at 39 fields x 40 factors, 2048 rows, {nnz} "
        f"nonzeros, V [20000, 39, 40]: forward {fwd_ms * 1e3:.2f} us on the "
        f"device, backward {sum(t for t, _ in bwd.values()):.2f} us "
        f"({bwd_kernel:.2f} us of it the kernel, the rest the fill of gV)")
    del off, idx, val, fld, V, g
    torch.cuda.empty_cache()


def report_kernels(rows, launches, steps):
    for r in rows:
        r["launches"] = launches[r["name"]]
        lib = ("none: no single PyTorch call computes it"
               if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.2f} us")
        log(f"{r['name']}: kernel {r['ms'] * 1e3:.2f} us on the device "
            f"({r['call_ms'] * 1e3:.1f} us a call back to back, launch "
            f"included), plain {r['plain_ms'] * 1e3:.2f} us, library {lib}, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"{r['launches']} launches in the path's {steps} steps")


# --------------------------------------------------------------- phase 4

def build_pipeline(path, fmt="libsvm"):
    """The port's Pipeline over ``path`` in ``fmt``'s padded layout, the
    chain bench.py builds: native parse → the engine's padded batch
    assembly → pinned async H2D to the card, window "auto", autotuned
    between epochs."""
    import torch
    from dmlc_tpu_torch.pipeline import Pipeline
    file_fmt, rows, nnz_bucket, want = LAYOUT[fmt]
    return (Pipeline.from_uri(path)
            .parse(format=file_fmt, engine="native", **PARSE_KW.get(fmt, {}))
            .batch(rows, pad=True, row_bucket=rows, nnz_bucket=nnz_bucket,
                   **want)
            .to_device(torch.device("cuda"), window="auto")
            .build(autotune=True))


def warm_up(built, model, check=None):
    """One batch of ``built`` through ``check`` and a train step of
    ``model`` (first launches, the allocator, pinned slots); the epoch is
    abandoned."""
    import torch
    it = iter(built)
    batch = next(it)
    if check is not None:
        check(batch)
    model.train_step(batch)
    torch.cuda.synchronize()
    it.close()


def train_epoch(built, model, train: bool):
    """One epoch of ``built`` (build_pipeline), with a train step of
    ``model`` a batch where ``train``. Returns (seconds, losses, batches,
    bytes moved)."""
    import torch
    losses, batches, moved = [], 0, 0
    t0 = time.perf_counter()
    for batch in built:
        batches += 1
        moved += sum(t.numel() * t.element_size() for t in batch.values())
        if train:
            losses.append(model.train_step(batch))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assembly = built.stats()["stages"][0]["extra"]["assembly_path"]
    require(assembly == "native-padded",
            f"the pipeline assembled its batches by {assembly}, not in the "
            "native engine")
    return secs, [float(x) for x in losses], batches, moved


def prefetch_epoch(path, fmt="libsvm"):
    """A parse-only epoch through the loop this script drove before the
    Pipeline: the native parser's ``next_padded`` into
    ``device_prefetch(size=2, staging=True)``. Returns (seconds,
    batches)."""
    import torch
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.native import bindings
    from dmlc_tpu_torch.parallel.device_iter import device_prefetch
    parser = Parser.create(path, 0, 1, format=LAYOUT[fmt][0],
                           engine="native", **PARSE_KW.get(fmt, {}))
    require(isinstance(parser, bindings.NativeTextParser),
            f"engine='native' gave {type(parser).__name__}")
    batches = 0
    t0 = time.perf_counter()
    for _ in device_prefetch(padded_batches(parser, fmt), size=2,
                             device=torch.device("cuda"), staging=True):
        batches += 1
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    parser.destroy()
    return secs, batches


def log_pipeline_stats(name, built):
    """The stats snapshot of ``built``'s last epoch, on one line."""
    log(f"{name} pipeline stats of the last epoch: "
        f"{json.dumps(built.stats())}")


def h2d_gbps(first) -> float:
    """One padded batch copied from its pinned staging slot to the card:
    its bytes over the copies' device time, over 50 copies."""
    from dmlc_tpu_torch.parallel.device_iter import HostStaging
    slot = HostStaging(pin=True).stage(first)
    nbytes = sum(t.numel() * t.element_size() for t in slot.values())
    ms = device_ms(lambda: [t.to("cuda", non_blocking=True)
                            for t in slot.values()])
    return nbytes / (ms * 1e-3) / 1e9


def main_path(path, size, lr, first):
    """One training epoch of SparseLinearModel(10^6) through the port's
    Pipeline; then parse-only epochs through the Pipeline and through the
    old device_prefetch loop in turns (Pipeline, loop, loop, Pipeline);
    then a profiled training epoch, and a profiled step on ``first``, the
    path's first batch."""
    import statistics
    import numpy as np
    import torch
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    from dmlc_tpu_torch.ops import csr
    from dmlc_tpu_torch.ops import step as step_ops
    cuda = torch.device("cuda")
    wrappers = {"csr_spmv": csr.csr_spmv, "csr_spmv_t": csr.csr_spmv_t,
                "logistic_step": step_ops.logistic_step,
                "logistic_sums": step_ops.logistic_sums,
                "logistic_grad": step_ops.logistic_grad,
                "sgd_update": step_ops.sgd_update}
    built = build_pipeline(path)
    warm_up(built, SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                                     device=cuda))

    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    for fn in wrappers.values():
        fn.launches = 0
    secs, losses, steps, moved = train_epoch(built, model, train=True)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    require(steps > 0, "the epoch yielded no batch")
    want = {k: steps if k in PATH_KERNELS["linear"] else 0
            for k in launches}
    require(launches == want,
            f"launch counts {launches} != {want}: the main path did not go "
            "through the kernels once per step")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"non-finite loss in {losses}")
    require(losses[-1] < losses[0],
            f"the loss did not fall: first {losses[0]}, last {losses[-1]}")
    w = model.w.detach()
    require(bool(torch.isfinite(w).all()), "non-finite weights")
    log(f"main path: {steps} steps at learning rate {lr}, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (min {min(losses):.4f}); "
        f"launches {launches}")
    log(f"  losses: {[round(x, 4) for x in losses]}")
    # the parse-only epoch through each entry point, in turns
    runs = {"pipeline": [], "device_prefetch": []}
    for entry in ("pipeline", "device_prefetch", "device_prefetch",
                  "pipeline"):
        if entry == "pipeline":
            parse_secs, _, batches2, _ = train_epoch(built, None,
                                                     train=False)
        else:
            parse_secs, batches2 = prefetch_epoch(path)
        require(batches2 == steps, f"a parse-only epoch through {entry} "
                f"gave {batches2} batches, the training epoch {steps}")
        runs[entry].append(size / parse_secs / 1e9)
    log_pipeline_stats("linear", built)
    stats = {
        "text_bytes": size, "steps": steps,
        "epoch_s": secs, "parse_to_device_gbps_training": size / secs / 1e9,
        "parse_to_device_gbps": statistics.mean(runs["pipeline"]),
        "parse_to_device_gbps_runs": runs,
        "steps_per_s": steps / secs,
        "h2d_bytes_per_batch": moved // steps,
        "knobs": built.knob_values(),
    }
    log(f"parse-to-device with training: "
        f"{stats['parse_to_device_gbps_training']:.3f} GB/s ({size} text "
        f"bytes in {secs:.3f} s), {stats['steps_per_s']:.2f} steps/s; "
        f"without training, in turns: the Pipeline "
        + " / ".join(f"{x:.3f}" for x in runs["pipeline"])
        + " GB/s, the device_prefetch(size=2) loop "
        + " / ".join(f"{x:.3f}" for x in runs["device_prefetch"])
        + " GB/s")
    stats["device"] = device_time(
        built, SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                                 device=cuda), secs)
    built.close()
    batch = {k: torch.from_numpy(np.asarray(v)).to(cuda)
             for k, v in first.items()}
    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    for _ in range(3):
        model.train_step(batch)
    stats["step"] = step_trace("linear", lambda: model.train_step(batch),
                               STEP_CALLS["linear"])
    return launches, stats


def _launch_kind(key):
    """What a step trace's kernel is: a kernel of the port (its name), or
    torch's fill, reduction, elementwise, cat or NCCL kernels, or a
    copy."""
    for prefix in ("(anonymous namespace)::", "void (anonymous namespace)::"):
        if key.startswith(prefix):
            return key[len(prefix):].split("<")[0].split("(")[0]
    for part, kind in ((FILL, "fill"), ("reduce_kernel", "reduction"),
                       ("CatArrayBatchedCopy", "cat"),
                       ("elementwise", "elementwise"), ("nccl", "nccl"),
                       ("Memcpy", "copy"), ("Memset", "memset")):
        if part in key:
            return kind
    return "other"


def step_trace(name, fn, calls=None):
    """One step, ``fn()``, under the profiler: its total launches and its
    device µs, by kind of kernel (_launch_kind) and by kernel, logged and
    returned ({"launches", "device_us", "by_kind": {kind: [µs, n]}}).
    ``calls``: the launches it must show (see _device_us_by_kernel)."""
    by_kernel = _device_us_by_kernel(fn, 1, calls)
    kinds = {}
    for key, (t, n) in by_kernel.items():
        us, count = kinds.get(_launch_kind(key), (0.0, 0))
        kinds[_launch_kind(key)] = (us + t, count + n)
    out = {"launches": sum(n for _, n in by_kernel.values()),
           "device_us": sum(t for t, _ in by_kernel.values()),
           "by_kind": {k: [round(us, 3), n] for k, (us, n) in kinds.items()}}
    log(f"{name} step trace: {out['launches']} launches, "
        f"{out['device_us']:.2f} us of device time; by kind: "
        + ", ".join(f"{k} {n} x {us:.2f} us" for k, (us, n) in
                    sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    for key, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]):
        log(f"  {t:9.2f} us  {n:3d} calls  {key[:90]}")
    return out


def device_time(built, model, epoch_s):
    """Where the card's time goes: the device time of one more training
    epoch of ``model`` through ``built``, traced by torch.profiler and
    summed by kernel, and its share of the unprofiled epoch's wall time
    (copies overlapping compute count twice)."""
    by_kernel = _device_us_by_kernel(
        lambda: train_epoch(built, model, train=True))
    total_us = sum(t for t, _ in by_kernel.values())
    log(f"device time over a training epoch: {total_us / 1e3:.3f} ms, "
        f"busy share {total_us / 1e6 / epoch_s:.4f} of the "
        f"{epoch_s:.3f} s epoch; by kernel:")
    for key, (t, n) in sorted(by_kernel.items(),
                              key=lambda kv: -kv[1][0])[:12]:
        log(f"  {t / 1e3:9.3f} ms  {n:5d} calls  {key[:90]}")
    return {"device_ms": total_us / 1e3,
            "busy_share": total_us / 1e6 / epoch_s}


# --------------------------------------------------------------- phase 4b

def _chrome(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _kernel_counts(events, names):
    """{kernel: launches} of a torch.profiler Chrome trace's kernel
    events, for each kernel in ``names`` (see _launched)."""
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {k: sum(_launched(n, k) for n in kernels) for k in names}


def check_recorder_trace(path, stats, profiled):
    """The checks of a pipeline epoch's Chrome trace (``built.trace``):
    one ``pull/<stage>`` span per item each stage delivered and one
    ``pull/<stage>.end``; the engine's spans on the native thread tracks
    and its counter track; the to_device stage's ``to_device.drain`` and
    ``device.xfer`` spans; the profiler's span ``profiled``; nothing
    dropped. Returns the event count by category."""
    from dmlc_tpu_torch.native.bindings import _TRACE_KINDS
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    require(doc["otherData"]["dropped"] == 0,
            f"the pipeline trace dropped {doc['otherData']['dropped']} "
            "events")
    spans = {}
    for e in events:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    for st in stats["stages"]:
        name = f"pull/{st['name']}"
        require(spans.get(name, 0) == st["items"],
                f"{spans.get(name, 0)} {name} spans for the stage's "
                f"{st['items']} items")
        require(spans.get(name + ".end", 0) == 1,
                f"{spans.get(name + '.end', 0)} {name}.end spans, not 1")
    threads = {e["tid"]: e["args"]["name"] for e in events
               if e["ph"] == "M" and e["name"] == "thread_name"}
    native = [e for e in events if e.get("cat") == "native"
              and e["ph"] in ("X", "i")]
    kinds = {name for _, name in _TRACE_KINDS.values()}
    require(native and all(e["name"] in kinds for e in native),
            "no native engine span, or one the engine does not name")
    require(all(threads.get(e["tid"], "").startswith("native/")
                for e in native),
            "a native span off the native thread tracks")
    require(any(e["ph"] == "C" and e["name"] == "engine" for e in events),
            "no engine counter track")
    n_out = [st for st in stats["stages"] if st["name"] == "to_device"][0]
    for name in ("to_device.drain", "device.xfer"):
        require(spans.get(name, 0) == n_out["items"],
                f"{spans.get(name, 0)} {name} spans for "
                f"{n_out['items']} batches")
    require(any(e["ph"] == "X" and e["name"] == profiled
                and e.get("cat") == "profiler" for e in events),
            f"no profiler span {profiled!r}")
    cats = {}
    for e in events:
        if e["ph"] != "M":
            cats[e.get("cat", "")] = cats.get(e.get("cat", ""), 0) + 1
    return cats


def _annotation_covers(events, name, kernels):
    """Whether the user annotation ``name`` of a torch.profiler Chrome
    trace covers one launch of each of ``kernels``: each kernel lies in
    the annotation's device range (``gpu_user_annotation``) or was
    launched from inside its host range (the runtime call with the
    kernel's correlation id). Returns (covered, how)."""
    found = {k: [e for e in events if e.get("cat") == "kernel"
                 and _launched(e["name"], k)] for k in kernels}
    if any(len(v) != 1 for v in found.values()):
        return False, f"launches {({k: len(v) for k, v in found.items()})}"
    gpu = [e for e in events if e.get("cat") == "gpu_user_annotation"
           and e["name"] == name]
    if gpu:
        lo = min(e["ts"] for e in gpu)
        hi = max(e["ts"] + e["dur"] for e in gpu)
        return all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                   for v in found.values() for e in v), "device range"
    host = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] == name]
    if not host:
        return False, "no annotation"
    lo, hi = host[0]["ts"], host[0]["ts"] + host[0]["dur"]
    calls = {e["args"].get("correlation"): e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    ok = True
    for v in found.values():
        call = calls.get(v[0]["args"].get("correlation"))
        ok &= call is not None and lo <= call["ts"] <= hi
    return ok, "host range"


def trace_path(path, size, lr, work):
    """The trace plane on the main path: one training epoch of
    SparseLinearModel(10^6) through build_pipeline inside
    ``built.trace(json)`` and ``cuda_trace("epoch", log_dir)``: the
    recorder's Chrome JSON (check_recorder_trace) and the torch.profiler
    trace under log_dir (K1, K2, K8 and K9 once a step); one step inside
    ``cuda_trace("step")`` under a profiler of this script, whose
    annotation must cover the step's kernels; parse-only epochs with
    tracing off and on in turns (off, on, on, off), GB/s and span count
    of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    from dmlc_tpu_torch.obs.trace import cuda_trace, profiler
    cuda = torch.device("cuda")
    wrappers = _wrappers()
    kernels = STEP_CALLS["linear"]
    built = build_pipeline(path)
    warm_up(built, SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                                     device=cuda))
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        json_path = os.path.join(work, f"trace_epoch_{attempt}.json")
        log_dir = os.path.join(work, f"cuda_trace_{attempt}")
        model = SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                                  device=cuda)
        for fn in wrappers.values():
            fn.launches = 0
        profiler.reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):  # throwaway
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        with built.trace(json_path):
            with cuda_trace("epoch", log_dir):
                secs, losses, steps, _ = train_epoch(built, model,
                                                     train=True)
        launches = {k: fn.launches for k, fn in wrappers.items()}
        want = {k: steps if k in PATH_KERNELS["linear"] else 0
                for k in launches}
        require(launches == want,
                f"traced epoch: launch counts {launches} != {want}")
        require(losses[-1] < losses[0],
                f"traced epoch: the loss did not fall ({losses[0]} -> "
                f"{losses[-1]})")
        cats = check_recorder_trace(json_path, built.stats(), "epoch")
        require(profiler.stats()["epoch"].calls == 1,
                "cuda_trace did not feed the profiler")
        files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
        require(len(files) == 1 and files[0].endswith(".pt.trace.json"),
                f"cuda_trace wrote {files}, not one Chrome trace")
        counts = _kernel_counts(_chrome(files[0]), kernels)
        wanted = {k: n * steps for k, n in kernels.items()}
        if counts == wanted:
            break
        log(f"  traced epoch {attempt}: kernel records {counts} (want "
            f"{wanted})")
        require(attempt < PROFILE_ATTEMPTS,
                f"no torch.profiler trace of {attempt} traced epochs "
                "showed K1, K2, K8 and K9 once a step")
    log(f"trace_path: traced epoch {size / secs / 1e9:.3f} GB/s, {steps} "
        f"steps, recorder events by category {cats}; the torch.profiler "
        f"trace shows {counts} ({os.path.getsize(files[0])} bytes)")

    # one step under this script's profiler, annotated by cuda_trace
    it = iter(built)
    batch = {k: v.clone() for k, v in next(it).items()}
    it.close()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        step_json = os.path.join(work, f"trace_step_{attempt}.json")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with cuda_trace("step"):
                model.train_step(batch)
            torch.cuda.synchronize()
        prof.export_chrome_trace(step_json)
        covered, how = _annotation_covers(
            _chrome(step_json), "step",
            [k for k, n in kernels.items() if n])
        if covered:
            break
        log(f"  annotated step {attempt}: not covered ({how})")
        require(attempt < PROFILE_ATTEMPTS,
                "the cuda_trace annotation 'step' did not cover the "
                "step's kernels")
    log(f"trace_path: the annotation 'step' covers K1, K2, K8 and K9 (by "
        f"its {how})")

    # parse-only epochs with tracing off and on, in turns
    runs = {"off": [], "on": []}
    spans = []
    for turn, mode in enumerate(("off", "on", "on", "off")):
        if mode == "on":
            with built.trace(os.path.join(work, f"parse_{turn}.json")) \
                    as rec:
                parse_secs, _, batches, _ = train_epoch(built, None,
                                                        train=False)
            spans.append(rec.recorded)
        else:
            parse_secs, _, batches, _ = train_epoch(built, None,
                                                    train=False)
        require(batches == steps, f"a parse-only epoch gave {batches} "
                f"batches, the training epoch {steps}")
        runs[mode].append(size / parse_secs / 1e9)
    built.close()
    log("trace_path: parse-only epochs, tracing off "
        + " / ".join(f"{x:.3f}" for x in runs["off"]) + " GB/s, on "
        + " / ".join(f"{x:.3f}" for x in runs["on"])
        + f" GB/s ({spans} events recorded)")
    return {"traced_epoch_gbps": size / secs / 1e9, "steps": steps,
            "recorder_events": cats, "kernel_records": counts,
            "annotation": how, "parse_gbps": runs, "parse_events": spans}


SPLIT_PARTS = 4
SHUFFLE_PARTS, SHUFFLE_SEED = 8, 7
SHUFFLE_MB = 32  # the shuffled epoch's corpus (the python parser reads it)


def _ordered(recs):
    h = hashlib.sha256()
    for r in recs:
        h.update(r)
        h.update(b"\n")
    return h.hexdigest()


def _multiset(recs):
    """A hash of the records as a multiset: their 64-bit hashes summed."""
    return sum(int.from_bytes(hashlib.blake2b(r, digest_size=8).digest(),
                              "little") for r in recs) % (1 << 64)


def _split_pass(split):
    """(records, seconds, bytes read) of one pass over ``split``."""
    t0 = time.perf_counter()
    recs = [bytes(r) for r in split]
    return recs, time.perf_counter() - t0, split.bytes_read


def row_hashes(batch):
    """The sha256 of each real row of a padded batch (label, weight, its
    indices and values)."""
    import numpy as np
    b = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
         for k, v in batch.items()}
    off = b["offset"]
    out = []
    for r in range(int(b["num_rows"])):
        s, e = int(off[r]), int(off[r + 1])
        out.append(hashlib.sha256(
            b["label"][r].tobytes() + b["weight"][r].tobytes()
            + b["index"][s:e].tobytes()
            + b["value"][s:e].tobytes()).hexdigest())
    return out


def _padded_chain(path, shuffle):
    """The python parse of ``path`` into padded linear batches, shuffled
    by the shuffled epoch's parts and seed when ``shuffle``."""
    from dmlc_tpu_torch.pipeline import Pipeline
    pipe = Pipeline.from_uri(path)
    if shuffle:
        pipe = pipe.shuffle(num_shuffle_parts=SHUFFLE_PARTS,
                            seed=SHUFFLE_SEED)
    return pipe.parse(format="libsvm", engine="python").batch(
        ROW_BUCKET, pad=True, row_bucket=ROW_BUCKET, nnz_bucket=NNZ_BUCKET)


def host_references(path):
    """In a worker process: the batch hashes of epoch 1 of the shuffled
    host chain (``prefetch`` in place of ``to_device``) and the sorted
    row hashes of the unshuffled python chain over ``path``."""
    shuffled = _padded_chain(path, True).prefetch().build()
    epoch1 = [batch_hash(b) for b in shuffled]
    shuffled.close()
    plain = _padded_chain(path, False).prefetch().build()
    rows = sorted(r for b in plain for r in row_hashes(b))
    plain.close()
    return epoch1, rows


def split_path(path, size, lr, work):
    """The split planes over the linear corpus, then a shuffled training
    epoch. Part 1: for each of SPLIT_PARTS parts the plain split and a
    '#cache' URI twice (a write pass, then a replay pass), the records'
    sha256 equal across the three and the cache entry and its stamp on
    disk; ThreadedInputSplit giving each part's records unchanged;
    InputSplitShuffle(SHUFFLE_PARTS, SHUFFLE_SEED) over the whole file
    giving the same order from two creations, the plain split's records
    as a multiset, and another order in its second epoch; GB/s of every
    pass. Part 2: the first SHUFFLE_MB of the corpus through
    ``Pipeline...shuffle(...).parse(format="libsvm").batch(...)
    .to_device(cuda)`` into SparseLinearModel(10^6) for two epochs: K1,
    K2, K8 and K9 once a step, the loss falling, each epoch's rows those
    of the unshuffled python chain, the two orders different, and epoch
    1's batches those of the shuffled host chain (the last two from a
    worker process, beside the epochs)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import torch
    from dmlc_tpu_torch.io.input_split import InputSplit
    from dmlc_tpu_torch.io.input_split_shuffle import InputSplitShuffle
    from dmlc_tpu_torch.io.threaded_split import ThreadedInputSplit
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    cuda = torch.device("cuda")
    small = os.path.join(work, "criteo_shaped_shuffle.libsvm")
    with open(path, "rb") as src:
        head = src.read(SHUFFLE_MB << 20)
    with open(small, "wb") as dst:
        dst.write(head[:head.rfind(b"\n") + 1])
    small_size = os.path.getsize(small)
    del head
    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        host = pool.submit(host_references, small)
        out = _split_planes(path, work, InputSplit, InputSplitShuffle,
                            ThreadedInputSplit)
        out.update(_shuffled_epochs(small, small_size, lr, cuda, host,
                                    SparseLinearModel))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    os.unlink(small)
    return out


def _split_planes(path, work, InputSplit, InputSplitShuffle,
                  ThreadedInputSplit):
    gbps = {"plain": [], "cache_write": [], "cache_replay": [],
            "threaded": []}
    whole = 0
    cache = os.path.join(work, "split.cache")
    for k in range(SPLIT_PARTS):
        recs, secs, nbytes = _split_pass(InputSplit.create(path, k,
                                                           SPLIT_PARTS))
        gbps["plain"].append(nbytes / secs / 1e9)
        want = _ordered(recs)
        whole = (whole + _multiset(recs)) % (1 << 64)
        split = InputSplit.create(f"{path}#{cache}", k, SPLIT_PARTS)
        for name in ("cache_write", "cache_replay"):
            recs, secs, nbytes = _split_pass(split)
            gbps[name].append(nbytes / secs / 1e9)
            require(_ordered(recs) == want,
                    f"part {k}: the {name} pass's records differ from the "
                    "plain split's")
        require(split._reader is not None,
                f"part {k}: the second pass did not replay the cache")
        entry = f"{cache}.p{k}-{SPLIT_PARTS}"
        require(os.path.exists(entry)
                and os.path.exists(entry + ".meta.json"),
                f"part {k}: no committed cache entry and stamp at {entry}")
        os.unlink(entry)
        threaded = ThreadedInputSplit(InputSplit.create(path, k,
                                                        SPLIT_PARTS))
        recs, secs, nbytes = _split_pass(threaded)
        threaded.destroy()
        gbps["threaded"].append(nbytes / secs / 1e9)
        require(_ordered(recs) == want,
                f"part {k}: ThreadedInputSplit changed the records")
    log("split_path: GB/s a part, " + "; ".join(
        f"{name} " + " / ".join(f"{x:.3f}" for x in v)
        for name, v in gbps.items()))
    orders, shuffle_gbps = [], []
    first = None
    for creation in range(2):
        split = InputSplitShuffle.create(
            path, 0, 1, "text", num_shuffle_parts=SHUFFLE_PARTS,
            seed=SHUFFLE_SEED)
        for epoch in range(2 if creation == 0 else 1):
            recs, secs, nbytes = _split_pass(split)
            shuffle_gbps.append(nbytes / secs / 1e9)
            orders.append(_ordered(recs))
            if first is None:
                first = _multiset(recs)
            del recs
    require(orders[0] == orders[2],
            "two InputSplitShuffle creations gave different orders")
    require(orders[1] != orders[0],
            "InputSplitShuffle's second epoch kept the first's order")
    require(first == whole,
            "InputSplitShuffle's records are not the plain split's")
    log("split_path: InputSplitShuffle(8 parts, seed 7) over the whole "
        "file, epochs 1, 2 and a second creation's 1: "
        + " / ".join(f"{x:.3f}" for x in shuffle_gbps) + " GB/s")
    return {"split_gbps": gbps, "shuffle_split_gbps": shuffle_gbps}


def _shuffled_epochs(small, small_size, lr, cuda, host, SparseLinearModel):
    import torch
    wrappers = _wrappers()
    built = _padded_chain(small, True).to_device(
        cuda, window="auto").build()
    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    for fn in wrappers.values():
        fn.launches = 0
    losses, epochs, secs = [], [], []
    for _ in range(2):
        kept = []
        t0 = time.perf_counter()
        for batch in built:
            kept.append(batch)
            losses.append(model.train_step(batch))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        epochs.append(kept)
    stages = {st["name"]: st for st in built.stats()["stages"]}
    built.close()
    steps = sum(len(e) for e in epochs)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    want = {k: steps if k in PATH_KERNELS["linear"] else 0
            for k in launches}
    require(launches == want,
            f"shuffled epochs: launch counts {launches} != {want}")
    losses = [float(x) for x in losses]
    require(all(x == x for x in losses) and losses[-1] < losses[0],
            f"shuffled epochs: the loss did not fall ({losses})")
    require(stages["assemble"]["extra"]["assembly_path"] == "python-fused",
            "the shuffled chain did not pad through the python golden")
    hashes = [[batch_hash({k: v.cpu() for k, v in b.items()}) for b in e]
              for e in epochs]
    rows = [sorted(r for b in e for r in row_hashes(b)) for e in epochs]
    host_epoch1, plain_rows = host.result()
    require(hashes[0] == host_epoch1,
            "shuffled epoch 1's batches on the card differ from the "
            "shuffled host chain's")
    require(rows[0] == plain_rows and rows[1] == plain_rows,
            "a shuffled epoch's rows differ from the unshuffled chain's")
    require(hashes[0] != hashes[1], "the two shuffled epochs' orders match")
    gbps = [small_size / s / 1e9 for s in secs]
    log(f"split_path: shuffled training epochs over {small_size} bytes, "
        f"{steps} steps: " + " / ".join(f"{x:.4f}" for x in gbps)
        + f" GB/s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; batches of "
        "epoch 1 equal to the host chain's, rows of both equal to the "
        "unshuffled chain's")
    return {"shuffled_gbps": gbps, "shuffled_steps": steps,
            "shuffled_bytes": small_size}


# --------------------------------------------------------------- phase 5

def parity(path, lr):
    import numpy as np
    import torch
    from dmlc_tpu_torch.data.padding import pad_single
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    native = Parser.create(path, 0, 1, format="libsvm", engine="native")
    firsts = []
    for batch in padded_batches(native):
        firsts.append(batch.copy())
        if len(firsts) == 4:
            break
    native.destroy()
    golden = Parser.create(path, 0, 1, format="libsvm", engine="python",
                           prefetch=False)
    cont = RowBlockContainer(np.uint32)
    for block in golden:
        cont.push_block(block)
        if cont.size >= 4 * ROW_BUCKET:
            break
    rows = cont.get_block()
    for i, nat in enumerate(firsts):
        gold = pad_single(rows.slice(i * ROW_BUCKET, (i + 1) * ROW_BUCKET),
                          ROW_BUCKET, NNZ_BUCKET)
        require(batch_hash(nat) == batch_hash(gold),
                f"native padded batch {i} differs from pad_single over the "
                "Python parser")
    log("parity: the first 4 native padded batches are byte-identical to "
        "pad_single over the Python parser")

    results = {}
    for dev in ("cuda", "cpu"):
        model = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=dev)
        losses = []
        for batch in firsts[:3]:
            t = {k: torch.from_numpy(np.asarray(v)).to(dev)
                 for k, v in batch.items()}
            losses.append(model.train_step(t))
        results[dev] = (torch.stack(losses).cpu(), model.w.detach().cpu(),
                        model.b.detach().cpu())
    (lc, wc, bc), (lp, wp, bp) = results["cuda"], results["cpu"]
    for name, a, b in (("losses", lc, lp), ("w", wc, wp), ("b", bc, bp)):
        require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                f"3 steps on the card vs the CPU plain path: {name} max "
                f"|err| {(a - b).abs().max().item()}")
    log(f"parity: 3 steps on the card match the CPU plain path (losses "
        f"{[round(float(x), 6) for x in lc]}, w max |err| "
        f"{(wc - wp).abs().max().item():.3g}, rtol {STEP_RTOL}, atol "
        f"{STEP_ATOL})")


# --------------------------------------------------------------- phase 6

# The kernels each model's single-part step launches once: K8 on the
# logistic models, K9 on every model.
PATH_KERNELS = {"linear": ("csr_spmv", "csr_spmv_t", "logistic_step",
                           "sgd_update"),
                "fm": ("csr_spmv", "csr_spmv_t", "fm_pair_fwd",
                       "fm_pair_bwd", "logistic_step", "sgd_update"),
                "ffm": ("csr_spmv", "csr_spmv_t", "ffm_pair_fwd",
                        "ffm_pair_bwd", "logistic_step", "sgd_update"),
                "ranking": ("csr_spmv", "csr_spmv_t", "pair_sums",
                            "pair_sums_grad", "sgd_update")}
# The kernels a traced step must launch, by kernel: the linear single-part
# step's, the sharded linear step's over SHARD_PARTS parts (K1 and K2
# once a part, K8 twice, K9 once), and the ranking step's K9 (its narrow
# route).
STEP_CALLS = {
    "linear": {"csr_spmv_half_kernel": 1, "csr_spmv_warp_kernel": 0,
               "csr_spmv_t_kernel": 1, "csr_spmv_t_private_kernel": 0,
               "logistic_step_kernel": 1, "logistic_sums_kernel": 0,
               "logistic_grad_kernel": 0, "sgd_update_kernel": 1,
               "sgd_update_narrow_kernel": 0},
    "sharded": {"csr_spmv_half_kernel": SHARD_PARTS,
                "csr_spmv_warp_kernel": 0,
                "csr_spmv_t_kernel": SHARD_PARTS,
                "csr_spmv_t_private_kernel": 0, "logistic_step_kernel": 0,
                "logistic_sums_kernel": 1, "logistic_grad_kernel": 1,
                "sgd_update_kernel": 1, "sgd_update_narrow_kernel": 0},
    "ranking": {"sgd_update_narrow_kernel": 1, "sgd_update_kernel": 0},
}


def _wrappers():
    from dmlc_tpu_torch.ops import csr, fm, ranking
    from dmlc_tpu_torch.ops import step as step_ops
    return {"csr_spmv": csr.csr_spmv, "csr_spmv_t": csr.csr_spmv_t,
            "sdot_rows": csr.sdot_rows, "csr_to_dense": csr.csr_to_dense,
            "fm_pair_fwd": fm.fm_pair_fwd, "fm_pair_bwd": fm.fm_pair_bwd,
            "ffm_pair_fwd": fm.ffm_pair_fwd, "ffm_pair_bwd": fm.ffm_pair_bwd,
            "pair_sums": ranking.pair_sums,
            "pair_sums_grad": ranking.pair_sums_grad,
            "logistic_step": step_ops.logistic_step,
            "logistic_sums": step_ops.logistic_sums,
            "logistic_grad": step_ops.logistic_grad,
            "sgd_update": step_ops.sgd_update}


class plain_step_ops:
    """Within it, ``ops.step``'s wrappers are their plain versions, so a
    model's step runs the plain K8 and K9 on the card's tensors."""

    NAMES = ("logistic_step", "logistic_sums", "logistic_grad",
             "sgd_update")

    def __enter__(self):
        from dmlc_tpu_torch.ops import step as step_ops
        self.saved = {n: getattr(step_ops, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(step_ops, n, getattr(step_ops, n + "_plain"))

    def __exit__(self, *exc):
        from dmlc_tpu_torch.ops import step as step_ops
        for n, fn in self.saved.items():
            setattr(step_ops, n, fn)


def _plain_steps(cls):
    """``cls`` whose steps, single-part and sharded, run the plain K8 and
    K9 (plain_step_ops)."""

    class PlainSteps(cls):
        def train_step(self, batch):
            with plain_step_ops():
                return super().train_step(batch)

        def make_sharded_train_step(self, mesh, axis="data"):
            step = super().make_sharded_train_step(mesh, axis)

            def plain(batch):
                with plain_step_ops():
                    return step(batch)
            return plain

    return PlainSteps


def make_factor_model(kind, lr, cls=None):
    """SparseFMModel(10^6, K=8) or SparseFFMModel(10^6, 39 fields, K=4) on
    the card, V drawn from a seeded CUDA generator (``cls``: a subclass)."""
    import torch
    from dmlc_tpu_torch.models import SparseFFMModel, SparseFMModel
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED + 4)
    if kind == "fm":
        return (cls or SparseFMModel)(NUM_FEATURES, num_factors=FM_FACTORS,
                                      learning_rate=lr, device=cuda,
                                      generator=gen)
    return (cls or SparseFFMModel)(NUM_FEATURES, FFM_FIELDS,
                                   num_factors=FFM_FACTORS, learning_rate=lr,
                                   device=cuda, generator=gen)


def _plain_linear():
    """An autograd Function: CSR · w through the plain versions of K1
    (forward) and K2 (backward)."""
    import torch
    from dmlc_tpu_torch.ops import csr

    class Linear(torch.autograd.Function):
        @staticmethod
        def forward(ctx, off, idx, val, w):
            ctx.save_for_backward(off, idx, val)
            ctx.features = w.numel()
            return csr.csr_spmv_plain(off, idx, val, w)

        @staticmethod
        def backward(ctx, g):
            off, idx, val = ctx.saved_tensors
            return None, None, None, csr.csr_spmv_t_plain(
                off, idx, val, g.contiguous(), ctx.features)

    return Linear


def plain_factor_model(kind, lr):
    """The same model whose margins run the plain versions of K1/K2 and of
    K5 or K6, forward and backward, and whose steps the plain K8 and K9,
    on the card's tensors."""
    import torch
    from dmlc_tpu_torch.models import SparseFFMModel, SparseFMModel
    from dmlc_tpu_torch.ops import fm

    Linear = _plain_linear()

    class Pair(torch.autograd.Function):
        @staticmethod
        def forward(ctx, off, idx, val, fld, V):
            if kind == "fm":
                pair, s = fm.fm_pair_fwd_plain(off, idx, val, V)
            else:
                pair, s = fm.ffm_pair_fwd_plain(off, idx, val, fld, V), None
            ctx.save_for_backward(off, idx, val, fld, V, s)
            return pair

        @staticmethod
        def backward(ctx, g):
            off, idx, val, fld, V, s = ctx.saved_tensors
            if kind == "fm":
                gV = fm.fm_pair_bwd_plain(off, idx, val, V, s, g.contiguous())
            else:
                gV = fm.ffm_pair_bwd_plain(off, idx, val, fld, V,
                                           g.contiguous())
            return None, None, None, None, gV

    base = SparseFMModel if kind == "fm" else SparseFFMModel

    class Plain(_plain_steps(base)):
        def _margin_terms(self, batch):
            csr_cols = (batch["offset"], batch["index"], batch["value"])
            return [Linear.apply(*csr_cols, self.w),
                    Pair.apply(*csr_cols, batch["field"], self.V)]

    return make_factor_model(kind, lr, cls=Plain)


def factor_path(path, size, kind, lr):
    """One epoch of the factor model over the libfm corpus through the
    port's Pipeline (native parse, padded batches with field, pinned async
    H2D); the loss must fall and each of the model's kernels launch once a
    step. Then the same epoch without the step, and a profiled training
    epoch."""
    import statistics
    import torch
    built = build_pipeline(path, "libfm")
    model = make_factor_model(kind, lr)
    warm_up(built, model,
            model.validate_batch if kind == "ffm" else None)
    del model
    torch.cuda.empty_cache()

    gc.collect()
    model = make_factor_model(kind, lr)
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    held = torch.cuda.memory_allocated()  # the model, and anything left
    torch.cuda.reset_peak_memory_stats()
    secs, losses, steps, moved = train_epoch(built, model, train=True)
    # read before the checks below: isfinite(V) makes about 1 GB of
    # temporaries at the FFM width
    peak = torch.cuda.max_memory_allocated()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    want = {k: steps if k in PATH_KERNELS[kind] else 0 for k in launches}
    require(steps >= 20, f"{kind}: the epoch gave {steps} steps, want >= 20")
    require(launches == want,
            f"{kind}: launch counts {launches} != {want}: the path did not "
            "go through its kernels once per step")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"{kind}: non-finite loss in {losses}")
    first10, last10 = (statistics.mean(losses[:10]),
                       statistics.mean(losses[-10:]))
    require(last10 < first10, f"{kind}: the loss did not fall: mean of the "
            f"first 10 steps {first10}, of the last 10 {last10}")
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            f"{kind}: non-finite parameters")
    log(f"{kind} path: {type(model).__name__} ({NUM_FEATURES} features, V "
        f"{tuple(model.V.shape)}), {steps} steps at learning rate {lr}, "
        f"loss mean of the first 10 steps {first10:.4f} -> of the last 10 "
        f"{last10:.4f}; launches {launches}; peak device memory "
        f"{peak / 2**20:.0f} MiB, {held / 2**20:.0f} MiB of it held before "
        "the epoch")
    log(f"  losses: {[round(x, 4) for x in losses]}")
    parse_secs, _, batches2, _ = train_epoch(built, None, train=False)
    require(batches2 == steps, f"{kind}: second epoch gave {batches2} "
            f"batches, first {steps}")
    log_pipeline_stats(kind, built)
    stats = {
        "text_bytes": size, "steps": steps, "epoch_s": secs,
        "parse_to_device_gbps_training": size / secs / 1e9,
        "parse_to_device_gbps": size / parse_secs / 1e9,
        "steps_per_s": steps / secs, "h2d_bytes_per_batch": moved // steps,
        "peak_device_bytes": peak, "held_before_epoch_bytes": held,
        "loss_first10": first10, "loss_last10": last10,
        "knobs": built.knob_values(),
    }
    log(f"{kind} parse-to-device with training: "
        f"{stats['parse_to_device_gbps_training']:.3f} GB/s ({size} text "
        f"bytes in {secs:.3f} s), {stats['steps_per_s']:.2f} steps/s; "
        f"without training: {stats['parse_to_device_gbps']:.3f} GB/s "
        f"({parse_secs:.3f} s); {stats['h2d_bytes_per_batch']} H2D bytes "
        "per batch")
    stats["device"] = device_time(built, model, secs)
    built.close()
    del model
    torch.cuda.empty_cache()
    return launches, stats


def libfm_parity(path, lr):
    """Native libfm padded batches (with field) byte-identical to
    pad_single over the Python parser; 3 SGD steps of each factor model
    on the card allclose to 3 steps through the plain versions."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.data.padding import pad_single
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    native = Parser.create(path, 0, 1, format="libfm", engine="native")
    firsts = []
    for batch in padded_batches(native, "libfm"):
        firsts.append(batch.copy())
        if len(firsts) == 4:
            break
    native.destroy()
    golden = Parser.create(path, 0, 1, format="libfm", engine="python",
                           prefetch=False)
    cont = RowBlockContainer(np.uint32)
    for block in golden:
        cont.push_block(block)
        if cont.size >= 4 * ROW_BUCKET:
            break
    rows = cont.get_block()
    for i, nat in enumerate(firsts):
        gold = pad_single(rows.slice(i * ROW_BUCKET, (i + 1) * ROW_BUCKET),
                          ROW_BUCKET, LIBFM_NNZ_BUCKET, want_field=True)
        require("field" in nat and batch_hash(nat) == batch_hash(gold),
                f"native libfm padded batch {i} differs from pad_single "
                "over the Python parser")
    log("parity: the first 4 native libfm padded batches (with field) are "
        "byte-identical to pad_single over the Python parser")

    cuda = torch.device("cuda")
    batches = [{k: torch.from_numpy(np.asarray(v)).to(cuda)
                for k, v in b.items()} for b in firsts[:3]]
    for kind in ("fm", "ffm"):
        results = []
        for model in (make_factor_model(kind, lr),
                      plain_factor_model(kind, lr)):
            losses = torch.stack([model.train_step(b) for b in batches])
            results.append([losses] + [p.detach() for p in
                                       (model.w, model.b, model.V)])
            del model
        errs = {}
        for name, a, b in zip(("losses", "w", "b", "V"), *results):
            require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                    f"{kind}: 3 steps with the kernels vs the plain "
                    f"versions: {name} max |err| "
                    f"{(a - b).abs().max().item()}")
            errs[name] = (a - b).abs().max().item()
        log(f"parity: 3 {kind} steps with the kernels match 3 through the "
            f"plain versions on the card (losses "
            f"{[round(float(x), 6) for x in results[0][0]]}, max |err| "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; rtol {STEP_RTOL}, atol {STEP_ATOL})")
        del results
        torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 7

def _rank_tensors(batch, device):
    """A padded batch's columns as tensors on ``device``."""
    import numpy as np
    import torch
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _query_rows(qid):
    """The rows of each query of a batch, in order, padding left out."""
    import numpy as np
    order = [q for q in dict.fromkeys(qid.tolist()) if q >= 0]
    return [np.flatnonzero(qid == q) for q in order]


def _grad_scale(margins, label, qid, weight, s):
    """Per row, the sum of |terms| of K7's gradient: |s|·pw·σ over the
    row's pairs in both directions."""
    import torch
    from dmlc_tpu_torch.ops import ranking
    pw = ranking.pair_weights_plain(label, qid, weight)
    ct = s.abs() * pw * torch.sigmoid(margins[None, :] - margins[:, None])
    return (ct.sum(0) + ct.sum(1)).nan_to_num()


def _k7_shape():
    """(T, R): the documents of a tile and the rows of a block that
    csrc/ranking.cu compiles in."""
    import re
    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "dmlc_tpu_torch", "csrc", "ranking.cu")).read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
                 for name in ("kTile", "kRows"))


def k7_tiles(first, args, s):
    """K7 at the ranking path's first batch: the share of tiles each block
    skips and the pairs in the tiles it visits, worked out on the host by
    the skip rule from the tile table that the forward wrote on the device
    (the kernel counts nothing); then K7 against its plain versions and
    timed at the batch as it came and at two batches where no tile can be
    skipped: one query over the batch, and the batch's qids shuffled
    across its rows. Returns the tile table of the first batch."""
    import collections
    import numpy as np
    import torch
    from dmlc_tpu_torch.ops import ranking
    cuda = torch.device("cuda")
    n = RANK_ROW_BUCKET
    T, R = _k7_shape()
    _, _, table = ranking.pair_sums(*args)
    tb = table.cpu().numpy()
    require(len(tb) == 2 + 2 * -(-n // T),
            f"K7's tile table has {len(tb)} entries at tiles of {T}")
    tiles = tb[2:].reshape(-1, 2)  # after the flag and the block count
    qid = np.asarray(first["qid"])
    skipped, visited_pairs, row_pairs = [], 0, 0
    for r0 in range(0, n, R):
        rq = qid[r0:r0 + R]
        valid = rq[rq >= 0]
        lo, hi = ((valid.min(), valid.max()) if valid.size
                  else (np.iinfo(np.int64).max, -1))
        skip = ((tiles[:, 0] > hi) | (tiles[:, 1] < lo)) if tb[0] else (
            np.zeros(len(tiles), bool))
        skipped.append(float(skip.mean()))
        for t in np.flatnonzero(~skip):
            docs = min(n, (t + 1) * T) - t * T
            visited_pairs += len(rq) * docs
            row_pairs += int(((rq >= tiles[t, 0]) & (rq <= tiles[t, 1])).sum()
                             ) * docs
    visits = collections.Counter(
        int(round((1 - x) * len(tiles))) for x in skipped)
    log(f"K7 at the first batch, by the skip rule applied on the host to "
        f"the tile table the forward wrote on the device (no counter in the "
        f"kernel): safe flag {int(tb[0])}; each block of {R} rows skips on "
        f"average {np.mean(skipped):.4f} of {len(tiles)} tiles of {T} "
        f"documents (least {min(skipped):.4f}, most {max(skipped):.4f}); "
        f"blocks by tiles visited {dict(sorted(visits.items()))}; pairs in "
        f"visited tiles {visited_pairs}, of them in rows whose qid the tile "
        f"holds {row_pairs}, of {n * n}")
    perm = torch.from_numpy(np.random.RandomState(SEED + 8).permutation(n))
    batches = {
        "as it came": args,
        "one query": (args[0], args[1], torch.full_like(
            args[2], int(qid[0])), args[3]),
        "shuffled qids": (args[0], args[1], args[2][perm.to(cuda)], args[3]),
    }
    for name, a in batches.items():
        lsum, wsum, tb_a = ranking.pair_sums(*a)
        lsum_q, wsum_q = (float(x) for x in ranking.pair_sums_plain(*a))
        g = ranking.pair_sums_grad(*a, s, tb_a)
        g_q = ranking.pair_sums_grad_plain(*a, s)
        torch.cuda.synchronize()
        require(abs(float(lsum) - lsum_q) <= RANK_ATOL + RANK_RTOL * abs(lsum_q)
                and abs(float(wsum) - wsum_q)
                <= RANK_ATOL + RANK_RTOL * abs(wsum_q)
                and bool(((g - g_q).abs() <= RANK_ATOL + RANK_RTOL
                          * _grad_scale(*a, s)).all()),
                f"K7 at the first batch, {name}, disagrees with its plain "
                "versions")
        pw = ranking.pair_weights_plain(*a[1:])
        weighted = int((pw != 0).sum())
        del pw
        fwd_ms = device_ms(lambda: ranking.pair_sums(*a),
                           calls=KERNEL_CALLS["pair_sums"])
        bwd_ms = device_ms(lambda: ranking.pair_sums_grad(*a, s, tb_a),
                           calls=KERNEL_CALLS["pair_sums_grad"])
        log(f"K7 at the first batch, {name} ({weighted} weighted pairs; "
            f"safe flag {int(tb_a[0])}): forward {fwd_ms * 1e3:.2f} us, "
            f"backward {bwd_ms * 1e3:.2f} us on the device")
    return table


def check_k4_edges():
    """K4 by each route (tile at 137 columns, global at K4_WIDE_COLS),
    u32 and u64 index, against its plain version on a batch of edges:
    rows of 0-44 nonzeros, empty rows, a row repeating one column five
    times, indices 2^32-1 (the last column), 2^31 (invalid), 2^32+3
    (column 3) and one past the columns, a padded tail of 50 nonzeros
    (an invalid index among them) and 7 flat rows after the last; then
    corrupt offsets (backwards, negative, past nnz), which each route
    clamps into [0, nnz]. Returns the max |err|."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.ops import csr
    cuda = torch.device("cuda")
    rng = np.random.RandomState(SEED + 8)
    lens = rng.randint(0, 40, 203)
    lens[[4, 9, 10]] = 0
    lens[[5, 6, 7, 8, 11]] += 5  # the rows that carry the edges
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    nnz = int(off[-1])
    val = np.concatenate([rng.rand(nnz), np.ones(50)]).astype(np.float32)
    err = 0.0
    for cols, route in ((RANK_NUM_FEATURES, "tile"),
                        (K4_WIDE_COLS, "global")):
        idx = rng.randint(0, cols, nnz).astype(np.uint64)
        idx[off[5]:off[5] + 5] = 7
        idx[off[6]], idx[off[7]] = WRAP_LAST, WRAP_BAD
        idx[off[8]], idx[off[11]] = WRAP_U64, cols + 5
        idx = np.concatenate([idx, np.full(50, WRAP_BAD + 1, np.uint64)])
        flat = np.concatenate([off, np.full(7, nnz)])
        for dtype in (np.uint32, np.uint64):
            o, i, v = (torch.from_numpy(a).to(cuda)
                       for a in (flat, idx.astype(dtype), val))
            rows = o.numel() - 1
            d = on_route("csr_to_dense", route, lambda: csr.csr_to_dense(
                o, i, v, rows, cols))
            d_p = csr.csr_to_dense_plain(o, i, v, cols)
            torch.cuda.synchronize()
            require(torch.allclose(d, d_p, rtol=K4_RTOL, atol=K4_ATOL),
                    f"K4 {route} route, {np.dtype(dtype).name}, on the edge "
                    f"batch: max |err| {(d - d_p).abs().max().item()}")
            require(float(d[5, 7]) > 0 and not bool(d[-7:].any()),
                    f"K4 {route} route: the repeated column or the flat "
                    "rows are wrong")
            err = max(err, (d - d_p).abs().max().item())
    # corrupt offsets: each row's range clamped into [0, nnz], as the
    # plain version's row ids read them where the offsets are monotone
    o = torch.tensor([0, 5, 3, -2, 40, 9], dtype=torch.int64, device=cuda)
    i = torch.arange(10, dtype=torch.int32).to(torch.uint32).to(cuda)
    v = torch.ones(10, device=cuda)
    want = torch.zeros(5, 12)
    for r, (a, b) in enumerate(zip([0, 5, 3, -2, 40], [5, 3, -2, 40, 9])):
        a = min(max(a, 0), 10)
        want[r, a:min(max(b, a), 10)] = 1.0
    for route, cols in (("tile", 12), ("global", K4_WIDE_COLS)):
        d = on_route("csr_to_dense", route,
                     lambda: csr.csr_to_dense(o, i, v, 5, cols))
        require(torch.equal(d[:, :12].cpu(), want) and not bool(
            d[:, 12:].any()), f"K4 {route} route with corrupt offsets")
    log(f"K4 agrees with its plain version by its tile and global routes on "
        f"the edge batch (u32 and u64; rtol {K4_RTOL}, atol {K4_ATOL}) and "
        f"clamps corrupt offsets: max |err| {err:.3g}")
    return err


def check_ranking_kernels(first):
    """K7 forward and backward against their plain versions on the ranking
    path's first batch, the margins from a seeded w through K1's plain
    version, with edge cases written in; K3 on the batch's padded rows and
    K4 to its dense matrix, against their plain versions and K1, with the
    index rule's edges; then each timed at the batch as it came."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dmlc_tpu_torch.ops import csr, ranking
    cuda = torch.device("cuda")
    n = RANK_ROW_BUCKET
    require(int(first["num_rows"]) == n,
            f"first ranking batch has {int(first['num_rows'])} rows, want {n}")
    b = _rank_tensors(first, cuda)
    gen = torch.Generator(device=cuda).manual_seed(SEED + 7)
    w = 0.1 * torch.randn(RANK_NUM_FEATURES, generator=gen, device=cuda)
    margins = csr.csr_spmv_plain(b["offset"], b["index"], b["value"], w) + 0.3
    s = torch.tensor(0.37, device=cuda)

    # K7: the batch with edge cases, and batches of one edge each
    queries = _query_rows(first["qid"])
    many = [q for q in queries if len(q) >= 2]
    require(len(many) >= 4, "the first ranking batch has < 4 queries of 2+")
    label, qid, weight = (b[k].clone() for k in ("label", "qid", "weight"))
    label[torch.from_numpy(many[0]).to(cuda)] = 2.0  # a query of ties
    # query 1's id on query 3's rows too: one qid, rows not contiguous
    qid[torch.from_numpy(many[3]).to(cuda)] = int(first["qid"][many[1][0]])
    tail = slice(n - 100, n)  # a padded tail of 100 rows
    qid[tail], weight[tail], label[tail] = -1, 0.0, 0.0

    def margin_at(i, v):
        out = margins.clone()
        out[i] = v
        return out

    # +-3e38 at the first document of the first and of the last query: each
    # finite, their difference not
    huge = margins.clone()
    huge[int(queries[0][0])], huge[int(queries[-1][0])] = 3e38, -3e38
    nan_pad = weight.clone()
    nan_pad[n - 3] = float("nan")  # a padded row's weight
    big = b["weight"].clone()
    big[10] = 2e19  # its square overflows
    rows_t = torch.arange(n, device=cuda)
    batch = (b["label"], b["qid"], b["weight"])
    cases = {
        "edges": (margins, label, qid, weight),
        "all_padded": (margins, torch.zeros_like(label),
                       torch.full_like(qid, -1), torch.zeros_like(weight)),
        "zero_margins": (torch.zeros_like(margins),) + batch,
        "nan_margin": (margin_at(57, float("nan")),) + batch,
        "neg_inf_margin": (margin_at(57, float("-inf")),) + batch,
        "huge_margins": (huge,) + batch,
        "nan_weight_padded": (margins, label, qid, nan_pad),
        "big_weight": (margins, b["label"], b["qid"], big),
        "one_query": (margins, b["label"], torch.full_like(
            b["qid"], int(first["qid"][0])), b["weight"]),
        "own_queries": (margins, b["label"], rows_t, b["weight"]),
        "interleaved": (margins, b["label"], rows_t % 37, b["weight"]),
    }
    unsafe = {"nan_margin", "neg_inf_margin", "huge_margins",
              "nan_weight_padded", "big_weight"}
    s_inf = torch.tensor(float("inf"), device=cuda)
    fwd_err = bwd_err = 0.0
    for name, args in cases.items():
        lsum, wsum, table = ranking.pair_sums(*args)
        lsum_p, wsum_p = ranking.pair_sums_plain(*args)
        torch.cuda.synchronize()
        for what, a, p in (("lsum", lsum, lsum_p), ("wsum", wsum, wsum_p)):
            a, p = float(a), float(p)
            require((a != a) == (p != p),
                    f"K7 {name}: {what} {a}, plain {p} (NaN on one side)")
            if p == p:
                require(abs(a - p) <= RANK_ATOL + RANK_RTOL * abs(p),
                        f"K7 {name}: {what} {a}, plain {p}")
                fwd_err = max(fwd_err, abs(a - p))
        require(int(table[0]) == (name not in unsafe),
                f"K7 {name}: the safe flag is {int(table[0])}")
        for s_ in (s, s_inf):
            g_p = ranking.pair_sums_grad_plain(*args, s_)
            g = ranking.pair_sums_grad(*args, s_, table)
            torch.cuda.synchronize()
            require(torch.equal(torch.isnan(g), torch.isnan(g_p)),
                    f"K7 {name}, s = {float(s_)}: the gradient's NaN "
                    "entries differ from the plain version's")
            err = (g - g_p).nan_to_num().abs()
            scale = _grad_scale(*args, s_)
            require(bool((err <= RANK_ATOL + RANK_RTOL * scale).all()),
                    f"K7 {name}, s = {float(s_)}: the gradient disagrees "
                    f"with its plain version: max |err| {err.max().item()}")
            bwd_err = max(bwd_err, err.max().item())
            if s_ is s_inf:
                require(bool(torch.isnan(g).any()) or name == "all_padded",
                        f"K7 {name}: no NaN in the gradient at s = inf")
        g = ranking.pair_sums_grad(*args, s, table)
        if name == "all_padded":
            require(float(lsum) == 0.0 and float(wsum) == 0.0
                    and not bool(g.any()),
                    f"K7 all padded: lsum {float(lsum)}, wsum {float(wsum)}")
        if name == "nan_margin":
            require(float(lsum) != float(lsum)
                    and bool(torch.isnan(g).all()),
                    "K7 with a NaN margin: lsum or a gradient is not NaN")
        if name == "edges":
            require(bool(torch.isfinite(g).all()) and float(wsum) > 0,
                    "K7 edges: a non-finite gradient or no pairs")
            require(bool((g[tail] == 0).all()) and bool(
                (g[torch.from_numpy(many[0]).to(cuda)] == 0).all()),
                "K7 edges: padded rows or a query of ties got a gradient")
    log(f"K7 agrees with its plain versions on the ranking batch (a padded "
        f"tail, a query of ties, a split query; all padded; zero margins; "
        f"a NaN margin; a -inf margin; margins of +-3e38; a NaN weight on a "
        f"padded row; a weight of 2e19; one query; every row its own query; "
        f"interleaved queries; the gradient at s = 0.37 and s = inf, with "
        f"the forward's tile table): lsum/wsum max |err| "
        f"{fwd_err:.3g} (rtol {RANK_RTOL}, atol {RANK_ATOL}), gradient max "
        f"|err| {bwd_err:.3g} (rtol {RANK_RTOL} of each row's sum|terms|, "
        f"atol {RANK_ATOL}); the safe flag clear exactly in the "
        f"{len(unsafe)} unsafe cases")

    # K3 on the padded rows and K4 to the dense matrix, with the index
    # rule's edges: 2^32-1 in row 5 (reads w[136]), 2^31 in row 6
    # (invalid) and 2^32+3 in row 7 (reads w[3])
    nnz = int(first["num_nnz"])
    pi, pv, _ = csr.csr_to_padded_rows(first["offset"], first["index"],
                                       first["value"])
    require(pi.shape == (n, RANK_FEATURES), f"padded rows {pi.shape}")
    t_pi, t_pv = (torch.from_numpy(a).to(cuda) for a in (pi, pv))
    y1 = csr.csr_spmv(b["offset"], b["index"], b["value"], w)
    y3 = csr.sdot_rows(t_pi, t_pv, w)
    y3_p = csr.sdot_rows_plain(t_pi, t_pv, w)
    scale3 = csr.sdot_rows_plain(t_pi, t_pv.abs(), w.abs())
    d4 = on_route("csr_to_dense", "tile", lambda: csr.csr_to_dense(
        b["offset"], b["index"], b["value"], n, RANK_NUM_FEATURES))
    d4_p = csr.csr_to_dense_plain(b["offset"], b["index"], b["value"],
                                  RANK_NUM_FEATURES)
    torch.cuda.synchronize()
    k3_err = (y3 - y3_p).abs()
    require(bool((k3_err <= K1_ATOL + K1_RTOL * scale3).all()),
            f"K3 disagrees with its plain version: max |err| "
            f"{k3_err.max().item()}")
    require(bool(((y3 - y1).abs() <= K1_ATOL + K1_RTOL * scale3).all()),
            "K3 on the padded rows disagrees with K1 on the CSR batch")
    # each entry of the dense matrix is one value added to 0: exact
    require(torch.equal(d4, d4_p), "K4 disagrees with its plain version")
    require(bool(((d4 @ w - y1).abs() <= K1_ATOL + K1_RTOL * scale3).all()),
            "K4's dense matrix times w disagrees with K1")
    ell = pi.astype(np.uint64)
    ell[5, 0], ell[6, 1], ell[7, 2] = WRAP_LAST, WRAP_BAD, WRAP_U64
    flat = np.asarray(first["index"]).astype(np.uint64)
    off = first["offset"]
    flat[off[5]], flat[off[6] + 1], flat[off[7] + 2] = (WRAP_LAST, WRAP_BAD,
                                                         WRAP_U64)
    for dtype in (np.int32, np.uint32, np.uint64):
        e_pi = torch.from_numpy(ell.astype(np.uint32).view(np.int32)
                                if dtype is np.int32
                                else ell.astype(dtype)).to(cuda)
        y = csr.sdot_rows(e_pi, t_pv, w)
        y_p = csr.sdot_rows_plain(e_pi, t_pv, w)
        torch.cuda.synchronize()
        name = np.dtype(dtype).name
        nan_rows = torch.isnan(y).nonzero().flatten().tolist()
        require(nan_rows == [6] and torch.equal(torch.isnan(y_p),
                                                torch.isnan(y)),
                f"K3 {name} with the index rule's edges: NaN rows {nan_rows}")
        require(bool(((y - y_p).nan_to_num().abs()
                      <= K1_ATOL + K1_RTOL * scale3).all()),
                f"K3 {name} with the index rule's edges disagrees with its "
                "plain version")
        if dtype is np.int32:
            continue
        e_idx = torch.from_numpy(flat.astype(dtype)).to(cuda)
        for route, cols in (("tile", RANK_NUM_FEATURES),
                            ("global", K4_WIDE_COLS)):
            d = on_route("csr_to_dense", route, lambda: csr.csr_to_dense(
                b["offset"], e_idx, b["value"], n, cols))
            d_p = csr.csr_to_dense_plain(b["offset"], e_idx, b["value"],
                                         cols)
            torch.cuda.synchronize()
            require(torch.equal(d, d_p),
                    f"K4 {name}, {route} route, with the index rule's edges "
                    "disagrees with its plain version")
            del d, d_p
    k4_err = max((d4 - d4_p).abs().max().item(), check_k4_edges())
    log(f"K3 and K4 agree with their plain versions on the ranking batch "
        f"(K3 [{n}, {RANK_FEATURES}] int32, u32 and u64, K3 also with K1; "
        f"K4 to [{n}, {RANK_NUM_FEATURES}] by its tile route and to [{n}, "
        f"{K4_WIDE_COLS}] by its global route, exact; indices 2^32-1, 2^31 "
        f"and 2^32+3): K3 max |err| {k3_err.max().item():.3g} (rtol "
        f"{K1_RTOL} of sum|terms|, atol {K1_ATOL}), K4 max |err| "
        f"{k4_err:.3g}")

    # Timing, at the batch as it came from the parser.
    args = (margins, b["label"], b["qid"], b["weight"])
    table = k7_tiles(first, args, s)
    pw = ranking.pair_weights_plain(*args[1:])
    weighted = int((pw != 0).sum())
    del pw
    distinct = int(np.unique(first["index"][:nnz]).size)
    k = pi.shape[1]
    rows_of = csr.csr_row_ids(b["offset"], nnz)
    cols_of = b["index"][:nnz].to(torch.int64)
    vals = b["value"][:nnz]
    emb = F.embedding_bag(t_pi, w[:, None], per_sample_weights=t_pv,
                          mode="sum")[:, 0]
    dense_lib = torch.zeros(n, RANK_NUM_FEATURES, device=cuda).index_put_(
        (rows_of, cols_of), vals, accumulate=True)
    torch.cuda.synchronize()
    require(bool(((emb - y3).abs() <= K1_ATOL + K1_RTOL * scale3).all())
            and torch.equal(dense_lib, d4),
            "the library yardsticks of K3/K4 disagree with the kernels")
    doc_bytes = n * (4 + 4 + 4 + 8)  # margin, label, weight, qid
    work = {
        # per weighted pair: the difference, softplus (|x|, exp, log1p,
        # max, add), w_i·w_j and the pair mask, the product, two sums
        "pair_sums": (lambda: ranking.pair_sums(*args),
                      lambda: ranking.pair_sums_plain(*args),
                      doc_bytes + 8, 11 * weighted,
                      "dmlc_tpu/models/ranking.py:64",
                      "dmlc_tpu_torch/csrc/ranking.cu", None, fwd_err),
        # per weighted pair: the difference, softplus (5), its derivative
        # exp(x - sp) (2), s·w_i·w_j·mask (3), the product, two sums
        "pair_sums_grad": (lambda: ranking.pair_sums_grad(*args, s, table),
                           lambda: ranking.pair_sums_grad_plain(*args, s),
                           doc_bytes + 4 + n * 4, 14 * weighted,
                           "dmlc_tpu/models/ranking.py:64",
                           "dmlc_tpu_torch/csrc/ranking.cu", None, bwd_err),
        "sdot_rows": (lambda: csr.sdot_rows(t_pi, t_pv, w),
                      lambda: csr.sdot_rows_plain(t_pi, t_pv, w),
                      n * k * (4 + 4) + distinct * 4 + n * 4, 2 * n * k,
                      "dmlc_tpu/ops/csr.py:107",
                      "dmlc_tpu_torch/csrc/csr_ops.cu",
                      lambda: F.embedding_bag(t_pi, w[:, None],
                                              per_sample_weights=t_pv,
                                              mode="sum"),
                      k3_err.max().item()),
        "csr_to_dense": (lambda: csr.csr_to_dense(
                             b["offset"], b["index"], b["value"], n,
                             RANK_NUM_FEATURES),
                         lambda: csr.csr_to_dense_plain(
                             b["offset"], b["index"], b["value"],
                             RANK_NUM_FEATURES),
                         (n + 1) * 8 + nnz * (4 + 4)
                         + n * RANK_NUM_FEATURES * 4, nnz,
                         "dmlc_tpu/ops/csr.py:68",
                         "dmlc_tpu_torch/csrc/csr_ops.cu",
                         lambda: torch.zeros(
                             n, RANK_NUM_FEATURES, device=cuda).index_put_(
                             (rows_of, cols_of), vals, accumulate=True),
                         k4_err),
    }
    log(f"ranking kernels timed at the path's first batch: {n} rows, {nnz} "
        f"nonzeros, {distinct} distinct features, {weighted} weighted pairs "
        f"of {n * n}")
    calls = dict(KERNEL_CALLS,
                 csr_to_dense=route_calls("csr_to_dense", "tile"))
    # K4's global route at a wide shape: the batch's nonzeros spread over
    # K4_WIDE_COLS columns
    wide = torch.from_numpy(np.random.RandomState(SEED + 9).randint(
        0, K4_WIDE_COLS, nnz).astype(np.uint32)).to(cuda)
    wide_fill, wide_kernel = _fill_and_kernel(
        lambda: csr.csr_to_dense(b["offset"], wide, vals, n, K4_WIDE_COLS),
        "csr_to_dense", "global")
    wide_bound, wide_by = bound_ms((n + 1) * 8 + nnz * (4 + 4)
                                   + n * K4_WIDE_COLS * 4, nnz)
    log(f"csr_to_dense by its global route at [{n}, {K4_WIDE_COLS}] "
        f"({nnz} nonzeros): {(wide_fill + wide_kernel) * 1e3:.2f} us on the "
        f"device (kernel {wide_kernel * 1e3:.2f} us, zero fill "
        f"{wide_fill * 1e3:.2f} us), bound {wide_bound * 1e3:.2f} us "
        f"({wide_by})")
    del wide
    # K2 on this batch: a model of 137 weights, its private route
    g = torch.randn(n, generator=gen, device=cuda)
    k2_err = _check_narrow_k2("at the ranking batch", b["offset"],
                              b["index"], b["value"], g)
    k2_bound, k2_by = bound_ms((n + 1) * 8 + nnz * (4 + 4) + n * 4
                               + RANK_NUM_FEATURES * 4, 2 * nnz)

    def k2():
        return csr.csr_spmv_t(b["offset"], b["index"], b["value"], g,
                              RANK_NUM_FEATURES)

    k2_fill, k2_kernel = _fill_and_kernel(k2, "csr_spmv_t", "private")
    k2_ms = k2_fill + k2_kernel
    k2_plain = device_ms(lambda: csr.csr_spmv_t_plain(
        b["offset"], b["index"], b["value"], g, RANK_NUM_FEATURES))
    a = torch.sparse_csr_tensor(b["offset"], cols_of, vals,
                                size=(n, RANK_NUM_FEATURES))
    try:
        at = a.t()
        at @ g
        k2_lib = f"{device_ms(lambda: at @ g) * 1e3:.2f} us"
    except RuntimeError as e:
        k2_lib = f"not timed ({e})"
    log(f"csr_spmv_t at the ranking batch ({RANK_NUM_FEATURES} weights, "
        f"private route; max |err| {k2_err:.3g}): {k2_ms * 1e3:.2f} us on "
        f"the device (kernel {k2_kernel * 1e3:.2f} us, zero fill "
        f"{k2_fill * 1e3:.2f} us), plain {k2_plain * 1e3:.2f} us, library "
        f"A.t() @ g {k2_lib}, bound {k2_bound * 1e3:.2f} us ({k2_by})")
    # K1 on this batch: 136 nonzeros a row, its warp route
    k1_err = _check_k1("at the ranking batch", b["offset"], b["index"],
                       b["value"], w, "warp", [])
    k1_bound, k1_by = bound_ms((n + 1) * 8 + nnz * (4 + 4) + distinct * 4
                               + n * 4, 2 * nnz)
    k1_ms = device_ms(lambda: csr.csr_spmv(b["offset"], b["index"],
                                           b["value"], w),
                      calls=route_calls("csr_spmv", "warp"))
    log(f"csr_spmv at the ranking batch ({RANK_NUM_FEATURES} weights, warp "
        f"route; max |err| {k1_err[0]:.3g}): {k1_ms * 1e3:.2f} us on the "
        f"device, bound {k1_bound * 1e3:.2f} us ({k1_by})")
    rows = []
    for name, (kernel, plain, nbytes, ops, replaces, source, lib,
               err) in work.items():
        bound, by = bound_ms(nbytes, ops)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err,
            "ms": device_ms(kernel, calls=calls[name]),
            "plain_ms": device_ms(plain),
            "bound_ms": bound, "bound_by": by,
            "library_ms": device_ms(lib) if lib else None,
            "call_ms": call_ms(kernel)})
    return rows


def plain_ranking_model(lr):
    """SparseRankingModel whose scores and pair sums run the plain
    versions of K1/K2 and of K7, forward and backward, and whose steps the
    plain K9, on the card."""
    import torch
    from dmlc_tpu_torch.models import SparseRankingModel
    from dmlc_tpu_torch.ops import ranking

    Linear = _plain_linear()

    class Pairs(torch.autograd.Function):
        @staticmethod
        def forward(ctx, m, label, qid, weight):
            ctx.save_for_backward(m, label, qid, weight)
            lsum, wsum = ranking.pair_sums_plain(m, label, qid, weight)
            ctx.mark_non_differentiable(wsum)
            return lsum, wsum

        @staticmethod
        def backward(ctx, g, _):
            return (ranking.pair_sums_grad_plain(*ctx.saved_tensors, g),
                    None, None, None)

    class Plain(_plain_steps(SparseRankingModel)):
        def _margin_terms(self, batch):
            return [Linear.apply(batch["offset"], batch["index"],
                                 batch["value"], self.w)]

        def _block_objective(self, batch):
            return Pairs.apply(self(batch), batch["label"], batch["qid"],
                               batch["weight"])

    return Plain(RANK_NUM_FEATURES, learning_rate=lr,
                 device=torch.device("cuda"))


def ranking_path(path, size, lr):
    """One epoch of SparseRankingModel(137) over the MSLR-shaped corpus
    through the port's Pipeline (native parse, padded batches with qid of
    4096 rows, pinned async H2D): the loss must fall and K1, K2, K7 forward and K7
    backward launch once a step. Then, in the same run, the evaluation of
    the first batch: the pairwise accuracy must rise above that after the
    first step, and the trained scores through K3 (padded rows) and K4
    (dense) must equal K1's. Then the epoch without the step, and a
    profiled training epoch."""
    import statistics
    import numpy as np
    import torch
    from dmlc_tpu_torch.models import SparseRankingModel
    from dmlc_tpu_torch.ops import csr
    cuda = torch.device("cuda")
    first = first_batch(path, "ranking")
    first_t = _rank_tensors(first, cuda)
    built = build_pipeline(path, "ranking")
    model = SparseRankingModel(RANK_NUM_FEATURES, learning_rate=lr,
                               device=cuda)
    warm_up(built, model, model.validate_batch)
    acc_first_step = model.pairwise_accuracy(first_t)  # one step on it

    model = SparseRankingModel(RANK_NUM_FEATURES, learning_rate=lr,
                               device=cuda)
    acc_init = model.pairwise_accuracy(first_t)
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    secs, losses, steps, moved = train_epoch(built, model, train=True)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    want = {k: steps if k in PATH_KERNELS["ranking"] else 0
            for k in launches}
    require(steps >= 10, f"ranking: the epoch gave {steps} steps, want >= 10")
    require(launches == want,
            f"ranking: launch counts {launches} != {want}: the path did not "
            "go through its kernels once per step")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"ranking: non-finite loss in {losses}")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    require(last5 < first5, f"ranking: the loss did not fall: mean of the "
            f"first 5 steps {first5}, of the last 5 {last5}")
    # the evaluation of the first batch, in the same run
    acc = model.pairwise_accuracy(first_t)
    require(acc > acc_first_step and acc > 0.5,
            f"ranking: pairwise accuracy on the first batch {acc}, after the "
            f"first step {acc_first_step}, at the zero init {acc_init}")
    with torch.no_grad():
        y1 = model(first_t)
        pi, pv, _ = csr.csr_to_padded_rows(first["offset"], first["index"],
                                           first["value"])
        t_pi, t_pv = (torch.from_numpy(a).to(cuda) for a in (pi, pv))
        y3 = csr.sdot_rows(t_pi, t_pv, model.w) + model.b
        dense = csr.csr_to_dense(first_t["offset"], first_t["index"],
                                 first_t["value"], RANK_ROW_BUCKET,
                                 RANK_NUM_FEATURES)
        y4 = dense @ model.w + model.b
        scale = csr.sdot_rows_plain(t_pi, t_pv.abs(),
                                    model.w.abs()) + model.b.abs()
    torch.cuda.synchronize()
    for name, y in (("K3 (padded rows)", y3), ("K4 (dense)", y4)):
        require(bool(((y - y1).abs() <= K1_ATOL + K1_RTOL * scale).all()),
                f"ranking: the trained scores through {name} disagree with "
                f"K1's: max |err| {(y - y1).abs().max().item()}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    require(launches["sdot_rows"] == 1 and launches["csr_to_dense"] == 1,
            f"ranking: the evaluation did not launch K3 and K4: {launches}")
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            "ranking: non-finite parameters")
    log(f"ranking path: SparseRankingModel ({RANK_NUM_FEATURES} features), "
        f"{steps} steps at learning rate {lr}, loss mean of the first 5 steps "
        f"{first5:.4f} -> of the last 5 {last5:.4f}; pairwise accuracy on the "
        f"first batch {acc_init:.4f} at the zero init (every score ties), "
        f"{acc_first_step:.4f} after the first step, {acc:.4f} after the "
        f"epoch; the trained scores through K3 and K4 equal K1's; launches "
        f"{launches}")
    log(f"  losses: {[round(x, 4) for x in losses]}")
    parse_secs, _, batches2, _ = train_epoch(built, None, train=False)
    require(batches2 == steps, f"ranking: second epoch gave {batches2} "
            f"batches, first {steps}")
    log_pipeline_stats("ranking", built)
    stats = {
        "text_bytes": size, "steps": steps, "epoch_s": secs,
        "parse_to_device_gbps_training": size / secs / 1e9,
        "parse_to_device_gbps": size / parse_secs / 1e9,
        "steps_per_s": steps / secs, "h2d_bytes_per_batch": moved // steps,
        "loss_first5": first5, "loss_last5": last5,
        "pairwise_accuracy": [acc_init, acc_first_step, acc],
        "queries_in_first_batch": len(_query_rows(np.asarray(first["qid"]))),
        "knobs": built.knob_values(),
    }
    log(f"ranking parse-to-device with training: "
        f"{stats['parse_to_device_gbps_training']:.3f} GB/s ({size} text "
        f"bytes in {secs:.3f} s), {stats['steps_per_s']:.2f} steps/s; "
        f"without training: {stats['parse_to_device_gbps']:.3f} GB/s "
        f"({parse_secs:.3f} s); {stats['h2d_bytes_per_batch']} H2D bytes "
        "per batch")
    stats["step"] = step_trace("ranking",
                               lambda: model.train_step(first_t),
                               STEP_CALLS["ranking"])
    stats["device"] = device_time(built, model, secs)
    built.close()
    del model
    torch.cuda.empty_cache()
    return launches, stats


def ranking_parity(path, lr):
    """Native qid padded batches byte-identical to pad_single(want_qid)
    over the Python parser; 3 SGD steps of SparseRankingModel on the card
    allclose to 3 through the plain versions."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.data.padding import pad_single
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    from dmlc_tpu_torch.models import SparseRankingModel
    native = Parser.create(path, 0, 1, format="libsvm", engine="native")
    firsts = []
    for batch in padded_batches(native, "ranking"):
        firsts.append(batch.copy())
        if len(firsts) == 3:
            break
    native.destroy()
    golden = Parser.create(path, 0, 1, format="libsvm", engine="python",
                           prefetch=False)
    cont = RowBlockContainer(np.uint32)
    for block in golden:
        cont.push_block(block)
        if cont.size >= 3 * RANK_ROW_BUCKET:
            break
    rows = cont.get_block()
    for i, nat in enumerate(firsts):
        gold = pad_single(rows.slice(i * RANK_ROW_BUCKET,
                                     (i + 1) * RANK_ROW_BUCKET),
                          RANK_ROW_BUCKET, RANK_NNZ_BUCKET, want_qid=True)
        require("qid" in nat and batch_hash(nat) == batch_hash(gold),
                f"native qid padded batch {i} differs from pad_single over "
                "the Python parser")
    log("parity: the first 3 native qid padded batches are byte-identical "
        "to pad_single over the Python parser")

    cuda = torch.device("cuda")
    batches = [_rank_tensors(b, cuda) for b in firsts]
    results = []
    for model in (SparseRankingModel(RANK_NUM_FEATURES, learning_rate=lr,
                                     device=cuda),
                  plain_ranking_model(lr)):
        losses = torch.stack([model.train_step(b) for b in batches])
        results.append([losses, model.w.detach(), model.b.detach()])
    errs = {}
    for name, a, b in zip(("losses", "w", "b"), *results):
        require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                f"ranking: 3 steps with the kernels vs the plain versions: "
                f"{name} max |err| {(a - b).abs().max().item()}")
        errs[name] = (a - b).abs().max().item()
    log(f"parity: 3 ranking steps with the kernels match 3 through the plain "
        f"versions on the card (losses "
        f"{[round(float(x), 6) for x in results[0][0]]}, max |err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; rtol {STEP_RTOL}, atol {STEP_ATOL})")


# --------------------------------------------------------------- phase 8

def init_nccl():
    """This process as the one rank of a NCCL group: ``init_from_env``
    under a world-1 env whose coordinator is a TCP store on localhost.
    Returns the group's mesh of SHARD_PARTS parts on the card."""
    import torch
    import torch.distributed as dist
    from dmlc_tpu_torch.parallel.launch import (
        find_free_port, init_from_env, worker_envs,
    )
    from dmlc_tpu_torch.parallel.sharded import Mesh
    os.environ.update(worker_envs(f"127.0.0.1:{find_free_port()}", 1, 0))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    rank, world = init_from_env()
    require((rank, world) == (0, 1) and dist.get_backend() == "nccl",
            f"init_from_env gave rank {rank} of {world} over "
            f"{dist.get_backend()}, want 0 of 1 over nccl")
    mesh = Mesh((SHARD_PARTS,), ("data",), group=dist.group.WORLD,
                device=torch.device("cuda"))
    log(f"sharded: {mesh} over {dist.get_backend()}")
    return mesh


def first_sharded_batches(path, mesh, fmt, count=3):
    """The first ``count`` batches of a ShardedRowBlockIter over ``path``
    in ``fmt``'s layout on ``mesh``, streamed (the epoch is abandoned)."""
    from dmlc_tpu_torch.parallel.sharded import ShardedRowBlockIter
    file_fmt, rows, nnz_bucket, _ = LAYOUT[fmt]
    it = ShardedRowBlockIter(path, mesh, format=file_fmt, row_bucket=rows,
                             nnz_bucket=nnz_bucket, engine="native",
                             first_epoch_cache="never")
    out = []
    for batch in it:
        out.append(batch)
        if len(out) == count:
            break
    it.close()
    require(len(out) == count, f"{fmt}: the sharded iterator gave "
            f"{len(out)} batches, want {count}")
    return out


def _flat_batch(batch, device):
    """The rows of a sharded batch's parts, in part order, as one flat
    padded batch of their total buckets."""
    import numpy as np
    import torch
    host = {k: v.cpu().numpy() for k, v in batch.items()}
    parts, rb = host["label"].shape
    nb = host["index"].shape[1]
    out = {"offset": np.zeros(parts * rb + 1, np.int64),
           "label": np.zeros(parts * rb, np.float32),
           "weight": np.zeros(parts * rb, np.float32),
           "index": np.zeros(parts * nb, host["index"].dtype),
           "value": np.zeros(parts * nb, np.float32)}
    r = z = 0
    for p in range(parts):
        n, nz = int(host["num_rows"][p]), int(host["num_nnz"][p])
        out["offset"][r + 1:r + n + 1] = host["offset"][p, 1:n + 1] + z
        for k in ("label", "weight"):
            out[k][r:r + n] = host[k][p, :n]
        for k in ("index", "value"):
            out[k][z:z + nz] = host[k][p, :nz]
        r, z = r + n, z + nz
    out["offset"][r + 1:] = z
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def allreduce_trace(fn, per_call):
    """One call of ``fn`` under the profiler, host and device activity:
    the all-reduce ops it ran (each key naming an all-reduce, with its
    count) and the device µs of the NCCL kernels. Fails unless some key
    counts ``per_call`` all-reduces."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, nccl_us = {}, 0.0
    for e in prof.key_averages():
        low = e.key.lower()
        if "allreduce" in low or "all_reduce" in low:
            ops[e.key[:60]] = e.count
        if "nccl" in low and e.self_device_time_total > 0:
            nccl_us += e.self_device_time_total
    require(per_call in ops.values(),
            f"the trace of a sharded step shows all-reduce ops {ops}, "
            f"none {per_call} times")
    return ops, nccl_us


def sharded_path(path, size, lr, mesh, single):
    """Three epochs of SparseLinearModel(10^6)'s sharded step over the
    linear corpus through ``Pipeline.shard`` on ``mesh``; then one step's
    traces, and 3 sharded steps against 3 flat ones. ``single``: the
    single-part main path's stats of this run, printed beside."""
    import torch
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    from dmlc_tpu_torch.pipeline import Pipeline
    cuda = mesh.device
    wrappers = {k: fn for k, fn in _wrappers().items()
                if k in PATH_KERNELS["linear"] + ("logistic_sums",
                                                  "logistic_grad")}
    built = (Pipeline.from_uri(path)
             .parse(format="libsvm", engine="native")
             .shard(mesh, row_bucket=ROW_BUCKET, nnz_bucket=NNZ_BUCKET)
             .build(autotune=True))
    # the first launches and the communicator on an abandoned epoch
    warm = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    it = iter(built)
    warm.make_sharded_train_step(mesh)(next(it))
    torch.cuda.synchronize()
    it.close()

    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    step = model.make_sharded_train_step(mesh)
    epochs = []
    for epoch in range(3):
        for fn in wrappers.values():
            fn.launches = 0
        kept, losses, moved = [], [], 0
        t0 = time.perf_counter()
        for batch in built:
            kept.append(batch)
            moved += sum(t.numel() * t.element_size() for t in batch.values())
            losses.append(step(batch))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        hashes = [batch_hash({k: v.cpu().numpy() for k, v in b.items()})
                  for b in kept]
        shard = built.stats()["stages"][0]
        epochs.append({"secs": secs, "steps": len(kept),
                       "losses": [float(x) for x in losses],
                       "launches": launches, "hashes": hashes,
                       "moved": moved, "tier": shard["extra"]["replay_tier"],
                       "replay_epochs": shard["extra"]["replay_epochs"]})
        del kept
    e1, e2, e3 = epochs
    steps = e1["steps"]
    require(steps > 0, "the sharded epoch yielded no batch")
    want = {"csr_spmv": SHARD_PARTS * steps,
            "csr_spmv_t": SHARD_PARTS * steps, "logistic_step": 0,
            "logistic_sums": steps, "logistic_grad": steps,
            "sgd_update": steps}
    require(e1["launches"] == want,
            f"sharded launch counts {e1['launches']} != {want}: K1 and K2 "
            f"did not launch once a part a step, or K8's two launches and "
            f"K9 once a step")
    losses = e1["losses"]
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"sharded: non-finite loss in {losses}")
    require(losses[-1] < losses[0], f"sharded: the loss did not fall: "
            f"first {losses[0]}, last {losses[-1]}")
    require([e["tier"] for e in epochs] == ["parse", "parse", "memory"]
            and e3["replay_epochs"] >= 1,
            f"sharded: the epochs were served by "
            f"{[e['tier'] for e in epochs]}, replay epochs "
            f"{e3['replay_epochs']}; want parse, parse (the tee), memory")
    require(e1["hashes"] == e2["hashes"] == e3["hashes"],
            "sharded: the replayed epoch's batches differ from epoch 1's")
    log(f"sharded path: {SHARD_PARTS} parts of {ROW_BUCKET} rows, {steps} "
        f"steps an epoch at learning rate {lr}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches {e1['launches']}; epochs served by "
        f"{[e['tier'] for e in epochs]}, epoch 3's {steps} batches hash "
        "equal to epoch 1's")
    log(f"  losses: {[round(x, 4) for x in losses]}")
    log_pipeline_stats("sharded", built)

    # one step's traces: K1 and K2 once a part, each by its route, K8's
    # two launches and K9; then the all-reduces, with host activity on
    gen = iter(built)
    batch = next(gen)
    gen.close()
    traced = step_trace("sharded", lambda: step(batch),
                        STEP_CALLS["sharded"])
    step_us = traced["device_us"]
    ops, nccl_us = allreduce_trace(lambda: step(batch), SHARD_ALLREDUCES)
    log(f"sharded step: all-reduce ops {ops}, NCCL kernels {nccl_us:.2f} "
        "us of device time a step")
    built.close()

    gbps = [size / e["secs"] / 1e9 for e in epochs]
    sps = [e["steps"] / e["secs"] for e in epochs]
    stats = {"parts": SHARD_PARTS, "steps": steps,
             "epoch_s": [e["secs"] for e in epochs],
             "parse_to_device_gbps_training": gbps, "steps_per_s": sps,
             "rows_per_s": [r * SHARD_PARTS * ROW_BUCKET for r in sps],
             "h2d_bytes_per_batch": e1["moved"] // steps,
             "allreduce_device_us_per_step": nccl_us,
             "allreduce_ops": ops, "step_device_us": step_us,
             "step": traced, "launches": e1["launches"],
             "knobs": built.knob_values()}
    log(f"sharded parse-to-device with training: epochs 1 (parse), 2 "
        f"(parse, tee), 3 (memory replay): "
        + " / ".join(f"{x:.3f}" for x in gbps) + " GB/s, "
        + " / ".join(f"{x:.2f}" for x in sps) + f" steps/s of "
        f"{SHARD_PARTS} x {ROW_BUCKET} rows; all-reduce {nccl_us:.2f} us "
        f"of device time a step; the single-part main path of this run: "
        f"{single['parse_to_device_gbps_training']:.3f} GB/s, "
        f"{single['steps_per_s']:.2f} steps/s of {ROW_BUCKET} rows, no "
        "all-reduce")

    # 3 sharded steps against 3 flat steps over the same rows
    batches = first_sharded_batches(path, mesh, "libsvm")
    sharded = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    flat = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    step = sharded.make_sharded_train_step(mesh)
    ls = torch.stack([step(b) for b in batches])
    lf = torch.stack([flat.train_step(_flat_batch(b, cuda))
                      for b in batches])
    errs = {}
    for name, a, b in (("losses", ls, lf), ("w", sharded.w, flat.w),
                       ("b", sharded.b, flat.b)):
        a, b = a.detach(), b.detach()
        require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                f"3 sharded steps vs 3 flat steps: {name} max |err| "
                f"{(a - b).abs().max().item()}")
        errs[name] = (a - b).abs().max().item()
    log(f"parity: 3 sharded linear steps ({SHARD_PARTS} parts) match 3 "
        f"flat train_steps over the same {SHARD_PARTS * ROW_BUCKET} rows a "
        f"step (losses {[round(float(x), 6) for x in ls]}, max |err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; rtol {STEP_RTOL}, atol {STEP_ATOL})")
    return stats


def sharded_parity(path, fmt, kinds, mesh, lr):
    """3 sharded steps of each model of ``kinds`` over the first batches
    of ``path`` on ``mesh``, with the kernels and through the plain
    versions on the card, allclose."""
    import torch
    batches = first_sharded_batches(path, mesh, fmt)
    for kind in kinds:
        if kind == "ranking":
            from dmlc_tpu_torch.models import SparseRankingModel
            models = (SparseRankingModel(RANK_NUM_FEATURES, learning_rate=lr,
                                         device=mesh.device),
                      plain_ranking_model(lr))
        else:
            models = (make_factor_model(kind, lr),
                      plain_factor_model(kind, lr))
        names = ["losses"] + sorted(n for n, _ in
                                    models[0].named_parameters())
        results = []
        for model in models:
            step = model.make_sharded_train_step(mesh)
            losses = torch.stack([step(b) for b in batches])
            params = dict(model.named_parameters())
            results.append([losses] + [params[n].detach()
                                       for n in names[1:]])
        del models, model, step, params
        errs = {}
        for name, a, b in zip(names, *results):
            require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                    f"{kind}: 3 sharded steps with the kernels vs the plain "
                    f"versions: {name} max |err| "
                    f"{(a - b).abs().max().item()}")
            errs[name] = (a - b).abs().max().item()
        log(f"parity: 3 sharded {kind} steps ({SHARD_PARTS} parts) with the "
            f"kernels match 3 through the plain versions on the card "
            f"(losses {[round(float(x), 6) for x in results[0][0]]}, max "
            "|err| " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; rtol {STEP_RTOL}, atol {STEP_ATOL})")
        del results
        torch.cuda.empty_cache()


def sharded_dryrun(mesh):
    """``graft.dryrun_multichip(8)`` on the card, over the NCCL group."""
    from dmlc_tpu_torch import graft
    try:
        out = graft.dryrun_multichip(DRYRUN_PARTS, device=mesh.device,
                                     group=mesh.group)
    except AssertionError as e:
        fail(f"dryrun_multichip({DRYRUN_PARTS}) on the card: {e}")
    log(f"dryrun_multichip({DRYRUN_PARTS}) on the card passed: loss "
        f"{out['loss0']:.4f} -> {out['loss5']:.4f}, {out['batches']} "
        f"batches, {out['replay_epochs']} epoch(s) replayed")


# --------------------------------------------------------------- phase 9

SPILL_EPOCHS = 5
SPILL_TIERS = ["parse", "parse"] + ["pages"] * (SPILL_EPOCHS - 2)
CACHE_EPOCHS = 3


def _epoch_gbps(size, epochs):
    return [size / e["secs"] / 1e9 for e in epochs]


def _epoch_sps(epochs):
    return [e["steps"] / e["secs"] for e in epochs]


def _hashes(kept):
    return [batch_hash({k: v.cpu().numpy() for k, v in b.items()})
            for b in kept]


def spill_path(path, size, lr, mesh, work, sharded):
    """SPILL_EPOCHS epochs of SparseLinearModel(10^6)'s sharded step over
    the linear corpus through ``Pipeline.shard`` with a 1 MB replay
    budget: epoch 1 streams, epoch 2 re-parses and spills its rounds to
    a page file under ``<work>/spill``, epochs 3+ replay the pages.
    ``sharded``: sharded_path's stats of this run, whose memory-replay
    epoch is printed beside."""
    import torch
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    from dmlc_tpu_torch.pipeline import Pipeline
    spill_dir = os.path.join(work, "spill")
    wrappers = {k: fn for k, fn in _wrappers().items()
                if k in PATH_KERNELS["linear"] + ("logistic_sums",
                                                  "logistic_grad")}
    built = (Pipeline.from_uri(path)
             .parse(format="libsvm", engine="native")
             .shard(mesh, row_bucket=ROW_BUCKET, nnz_bucket=NNZ_BUCKET,
                    agreement_cache_bytes=1 << 20,
                    first_epoch_cache="never", spill_dir=spill_dir)
             .build(autotune=True))
    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                              device=mesh.device)
    step = model.make_sharded_train_step(mesh)
    epochs = []
    for epoch in range(SPILL_EPOCHS):
        for fn in wrappers.values():
            fn.launches = 0
        kept, losses = [], []
        t0 = time.perf_counter()
        for batch in built:
            kept.append(batch)
            losses.append(step(batch))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        shard = built.stats()["stages"][0]["extra"]
        epochs.append({"secs": secs, "steps": len(kept),
                       "losses": [float(x) for x in losses],
                       "launches": launches, "hashes": _hashes(kept),
                       "tier": shard["replay_tier"],
                       "page_replay_epochs": shard["page_replay_epochs"],
                       "serve": shard.get("serve")})
        del kept
    steps = epochs[0]["steps"]
    require(steps > 0, "spill: the epoch yielded no batch")
    tiers = [e["tier"] for e in epochs]
    require(tiers == SPILL_TIERS
            and epochs[-1]["page_replay_epochs"] >= SPILL_EPOCHS - 2,
            f"spill: the epochs were served by {tiers}, page replay epochs "
            f"{epochs[-1]['page_replay_epochs']}; want {SPILL_TIERS}")
    want = {"csr_spmv": SHARD_PARTS * steps,
            "csr_spmv_t": SHARD_PARTS * steps, "logistic_step": 0,
            "logistic_sums": steps, "logistic_grad": steps,
            "sgd_update": steps}
    for i, e in enumerate(epochs):
        require(e["steps"] == steps and e["launches"] == want,
                f"spill: epoch {i + 1} ({e['tier']}) took {e['steps']} "
                f"steps with launch counts {e['launches']}; want {steps} "
                f"and {want}")
        require(e["hashes"] == epochs[0]["hashes"],
                f"spill: epoch {i + 1}'s ({e['tier']}) batches differ from "
                "epoch 1's")
    losses = [x for e in epochs for x in e["losses"]]
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"spill: non-finite loss in {losses}")
    require(losses[-1] < losses[0], f"spill: the loss did not fall: "
            f"first {losses[0]}, last {losses[-1]}")
    files = [n for n in os.listdir(spill_dir) if n.endswith(".pages")]
    require(len(files) == 1, f"spill: {spill_dir} holds {files}, want one "
            "page file while the store lives")
    page_bytes = os.path.getsize(os.path.join(spill_dir, files[0]))
    split = page_serve_split(os.path.join(spill_dir, files[0]), steps,
                             mesh)
    log_pipeline_stats("spill", built)
    built.close()
    left = [n for n in os.listdir(spill_dir) if n.endswith(".pages")]
    require(left == [], f"spill: close() left {left} in {spill_dir}")
    gbps, sps = _epoch_gbps(size, epochs), _epoch_sps(epochs)
    memory = sharded["parse_to_device_gbps_training"][2]
    log(f"spill path: {SHARD_PARTS} parts of {ROW_BUCKET} rows, {steps} "
        f"steps an epoch, agreement_cache_bytes 1 MB; epochs served by "
        f"{tiers}, every epoch's batches hash equal to epoch 1's; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches an epoch "
        f"{epochs[-1]['launches']}; page file {page_bytes} bytes "
        f"({page_bytes / size:.3f} of the text), deleted by close()")
    log(f"spill parse-to-device with training, epochs "
        + ", ".join(f"{i + 1} ({t})" for i, t in enumerate(tiers)) + ": "
        + " / ".join(f"{x:.3f}" for x in gbps) + " GB/s, "
        + " / ".join(f"{x:.2f}" for x in sps) + f" steps/s of "
        f"{SHARD_PARTS} x {ROW_BUCKET} rows; the sharded path's memory-"
        f"replay epoch of this run: {memory:.3f} GB/s, "
        f"{sharded['steps_per_s'][2]:.2f} steps/s")
    for i, e in enumerate(epochs):
        log(f"  spill epoch {i + 1} ({e['tier']}) serve: "
            f"{json.dumps(e['serve'])}")
    for i, e in enumerate(epochs):
        if e["tier"] == "pages":
            log(f"spill page epoch {i + 1}: {e['secs']:.4f} s with its "
                f"steps; the serve thread's work {e['serve']['work_s']:.4f}"
                f" s of wall, {e['serve']['work_cpu_s']:.4f} s of its CPU, "
                f"blocked on a full queue "
                f"{e['serve']['producer_block_s']:.4f} s")
    fmt = lambda xs: " / ".join(f"{x:.4f}" for x in xs)  # noqa: E731
    log(f"spill serve thread's work of a page epoch, by pass over the "
        f"page file with no step, {SERVE_SPLIT_ROUNDS} rounds interleaved "
        f"(memcpy gauge {fmt(split['gauges'])} GB/s): read "
        f"{fmt(split['read_s'])} s; read and decode "
        f"{fmt(split['read_decode_s'])} s; read, decode and pad+stack "
        f"{fmt(split['read_decode_stack_s'])} s; read, decode and the "
        f"pad+stack into pinned slots and the copy to the card "
        f"{fmt(split['read_decode_stack_copy_s'])} s (its thread CPU "
        f"{fmt(split['read_decode_stack_copy_cpu_s'])} s)")
    return {"steps": steps, "tiers": tiers, "epoch_s":
            [e["secs"] for e in epochs],
            "parse_to_device_gbps_training": gbps, "steps_per_s": sps,
            "page_bytes": page_bytes, "memory_replay_gbps": memory,
            "serve": [e["serve"] for e in epochs], "serve_split": split}


SERVE_SPLIT_ROUNDS = 5
SERVE_PASSES = ("read_s", "read_decode_s", "read_decode_stack_s",
                "read_decode_stack_copy_s")


def page_serve_split(spill, rounds, mesh):
    """The serve thread's work in a page epoch, pass by pass over the
    spill file (warm in the host's page cache), on this thread with no
    step between batches: the file's read alone; the read and decode
    (``RoundSpillFile.iter_rows``); both with the pad+stack
    (``stack_padded_rows``); and all of that as the serve thread stages
    a round (``stage_round``: the pad+stack straight into a pinned slot,
    then ``make_global_batch(staged=True)`` on a copy stream, each batch
    waited on as the consumer does). The four passes run
    SERVE_SPLIT_ROUNDS times, interleaved (one of each a round), each
    round led by ``bench_transfer.memcpy_gauge`` (the host's memcpy
    GB/s then). Seconds a pass, a list a pass; the last pass's thread
    CPU seconds too."""
    import torch
    from dmlc_tpu_torch.bench_transfer import memcpy_gauge
    from dmlc_tpu_torch.data.row_iter import RoundSpillFile
    from dmlc_tpu_torch.parallel.device_iter import HostStaging, wait_copy
    from dmlc_tpu_torch.parallel.sharded import make_global_batch, \
        stack_padded_rows, stage_round
    buf = bytearray(1 << 20)
    pages = RoundSpillFile(spill, SHARD_PARTS, rounds)
    on_cuda = mesh.device.type == "cuda"
    pool = HostStaging(3, pin=on_cuda, alias_unsafe=not on_cuda)
    stream = torch.cuda.Stream(mesh.device) if on_cuda else None

    def read():
        with open(spill, "rb", buffering=0) as f:
            while f.readinto(buf):
                pass

    def decode():
        for _row in pages.iter_rows():
            pass

    def stack():
        for row in pages.iter_rows():
            stack_padded_rows(row, ROW_BUCKET, NNZ_BUCKET, False, False)

    def stage():
        for row in pages.iter_rows():
            slot = stage_round(row, ROW_BUCKET, NNZ_BUCKET, False, False,
                               pool)
            wait_copy(make_global_batch(slot, mesh, staging=pool,
                                        copy_stream=stream, staged=True),
                      mesh.device)
        if on_cuda:
            torch.cuda.synchronize(mesh.device)

    passes = dict(zip(SERVE_PASSES, (read, decode, stack, stage)))
    out = {k: [] for k in SERVE_PASSES}
    out["gauges"], out["read_decode_stack_copy_cpu_s"] = [], []
    for _ in range(SERVE_SPLIT_ROUNDS):
        out["gauges"].append(memcpy_gauge())
        for name, fn in passes.items():
            t0, c0 = time.perf_counter(), time.thread_time()
            fn()
            out[name].append(time.perf_counter() - t0)
        out["read_decode_stack_copy_cpu_s"].append(time.thread_time() - c0)
    return out


def cache_path(path, size, lr, single):
    """CACHE_EPOCHS training epochs of SparseLinearModel(10^6) through
    ``Pipeline...cache(memory_budget_bytes=0)``: the parse builds a page
    cache (under the port's page store root) and every epoch replays it,
    padded by the Python fused golden. Its batches must hash equal to
    the chain without the cache. ``single``: the main path's stats of
    this run, printed beside."""
    import torch
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    from dmlc_tpu_torch.pipeline import Pipeline
    cuda = torch.device("cuda")
    wrappers = {k: fn for k, fn in _wrappers().items()
                if k in PATH_KERNELS["linear"] + ("logistic_sums",
                                                  "logistic_grad")}
    plain = build_pipeline(path)
    want_hashes = _hashes(list(plain))
    plain.close()
    t0 = time.perf_counter()
    built = (Pipeline.from_uri(path)
             .parse(format="libsvm", engine="native")
             .cache(memory_budget_bytes=0)
             .batch(ROW_BUCKET, pad=True, nnz_bucket=NNZ_BUCKET)
             .to_device(cuda, window="auto")
             .build(autotune=True))
    build_s = time.perf_counter() - t0
    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    epochs = []
    for epoch in range(CACHE_EPOCHS):
        for fn in wrappers.values():
            fn.launches = 0
        kept, losses = [], []
        t0 = time.perf_counter()
        for batch in built:
            kept.append(batch)
            losses.append(model.train_step(batch))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        stages = {s["kind"]: s["extra"] for s in built.stats()["stages"]}
        epochs.append({"secs": secs, "steps": len(kept),
                       "losses": [float(x) for x in losses],
                       "launches": launches, "hashes": _hashes(kept),
                       "tier": stages["cache"]["replay_tier"],
                       "assembly": stages["assemble"]["assembly_path"]})
        del kept
    steps = len(want_hashes)
    want = {k: steps if k in PATH_KERNELS["linear"] else 0
            for k in wrappers}
    for i, e in enumerate(epochs):
        require(e["tier"] == "pages",
                f"cache: epoch {i + 1} was served by {e['tier']}, not pages")
        require(e["hashes"] == want_hashes,
                f"cache: epoch {i + 1}'s {e['steps']} batches differ from "
                f"the {steps} of the same chain without the cache")
        require(e["launches"] == want,
                f"cache: epoch {i + 1}'s launch counts {e['launches']} != "
                f"{want}: not once a step")
    losses = [x for e in epochs for x in e["losses"]]
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"cache: non-finite loss in {losses}")
    require(losses[-1] < losses[0], f"cache: the loss did not fall: "
            f"first {losses[0]}, last {losses[-1]}")
    log_pipeline_stats("cache", built)
    built.close()
    gbps, sps = _epoch_gbps(size, epochs), _epoch_sps(epochs)
    log(f"cache path: the page cache built in {build_s:.3f} s; "
        f"{CACHE_EPOCHS} epochs of {steps} steps served by pages, padded "
        f"by {epochs[0]['assembly']}, batches hash equal to the chain "
        f"without the cache; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"launches an epoch {epochs[-1]['launches']}")
    log(f"cache parse-to-device with training, epochs 1-{CACHE_EPOCHS} "
        "(pages): " + " / ".join(f"{x:.3f}" for x in gbps) + " GB/s, "
        + " / ".join(f"{x:.2f}" for x in sps) + " steps/s; the main "
        f"path of this run: "
        f"{single['parse_to_device_gbps_training']:.3f} GB/s, "
        f"{single['steps_per_s']:.2f} steps/s")
    return {"steps": steps, "build_s": build_s,
            "epoch_s": [e["secs"] for e in epochs],
            "parse_to_device_gbps_training": gbps, "steps_per_s": sps}


def bench_twins(path, work, records_hash, indexed_hash):
    """Configs 4 (``prefetch``), 7 (``multiprocess``), 8 (``page_replay``)
    and 10 (``spill_replay``) of the port's bench suite at 256 MB on the
    card, over the linear corpus ``path``, linked to the name the suite
    reads (so it writes no corpus of its own); 8 and 10 tag their epochs
    with ``bench_transfer.memcpy_gauge``. Their own checks must hold
    (config 4's content hash against a direct parse, config 7's two
    ranks agreeing on their batches, 8's replay hash, 10's page replay
    epochs) and 4's and 10's hashes and rounds stand beside the corpus.
    Config 7 runs two worker processes over a gloo group, each a Mesh of
    2 parts on this card (NCCL refuses two ranks on one card). Then
    configs 3 (``recordio``), 14 (``recio_native``) and 18
    (``image_record``) at RECORDIO_MB over the corpora that
    write_recordio_corpora put at the suite's names, 14 and 18 with the
    gauge: 3 through the native reader, its coverage hash equal to
    ``records_hash`` (cuda_ingest's, of the host reader's records); 14's
    and 18's native and sharded streams each equal to the python golden's
    (their own checks) and assembled in the engine. Then configs 1
    (``libsvm``, a1a-shaped) at 256 MB and 2 (``csv``, HIGGS-shaped, dense
    and sparse) at CSV_MB, each writing its corpus, and 6
    (``indexed_shuffled``) over the indexed RecordIO that
    write_format_corpora put at the suite's name: through the native
    reader, its order and content equal to the Python split's (its own
    check) and its digest ``indexed_hash`` (indexed_leg's). Then config
    15 (``peer_hydrate``) at PEER_HYDRATE_MB over the linear corpus (a
    2-process gang through the peer tier: each rank's wire at most
    GANG_PEER_SLACK of it, peer bytes on both, warm epochs with no GET)
    and config 21 (``ckpt_restore_fanout``) at CKPT_FANOUT_MB (a
    3-writer save under a rendezvous, a 2-rank fanout restore, an
    incremental re-save, the multipart leg), then config 20
    (``elastic_reshard``) at ELASTIC_MB (a 2→3→2 gang under a
    rendezvous resuming adopted parts from the committed prefix: at
    least two reshards, resumed bytes, gang wire at most 1.3 of the
    corpus) and config 23 (``global_shuffle``) at GLOBAL_SHUFFLE_MB (a
    2-rank gang draining one seeded global order of a RecordIO corpus:
    at least 8 windows, peer bytes on each rank, gang wire at most 1.6
    of the corpus), host-only gangs as in the reference, each holding
    its own checks and these. Each JSON is printed as a line. The
    suite's files are removed after."""
    from dmlc_tpu_torch.bench_suite import (
        bench_ckpt_restore_fanout, bench_csv, bench_elastic_reshard,
        bench_global_shuffle, bench_image_record, bench_indexed_shuffled,
        bench_libsvm, bench_multiprocess_ingest, bench_page_replay,
        bench_peer_hydrate, bench_prefetch, bench_recio_native,
        bench_recordio, bench_spill_replay,
    )
    from dmlc_tpu_torch.bench_transfer import memcpy_gauge
    prefix = "dmlc_tpu_torch_bench_suite."
    os.link(path, os.path.join(work, prefix + "criteo.libsvm"))
    configs = (("prefetch", lambda: bench_prefetch(256, work=work)),
               ("multiprocess",
                lambda: bench_multiprocess_ingest(256, work=work)),
               ("page_replay", lambda: bench_page_replay(
                   256, gauge_fn=memcpy_gauge, work=work)),
               ("spill_replay", lambda: bench_spill_replay(
                   256, gauge_fn=memcpy_gauge, work=work)),
               ("recordio", lambda: bench_recordio(RECORDIO_MB, work=work)),
               ("recio_native", lambda: bench_recio_native(
                   RECORDIO_MB, gauge_fn=memcpy_gauge, work=work)),
               ("image_record", lambda: bench_image_record(
                   RECORDIO_MB, gauge_fn=memcpy_gauge, work=work)),
               ("libsvm", lambda: bench_libsvm(FILE_MB, work=work)),
               ("csv", lambda: bench_csv(CSV_MB, work=work)),
               ("indexed_shuffled", lambda: bench_indexed_shuffled(
                   INDEXED_MB, work=work)),
               ("peer_hydrate", lambda: bench_peer_hydrate(
                   PEER_HYDRATE_MB, work=work)),
               ("ckpt_restore_fanout", lambda: bench_ckpt_restore_fanout(
                   CKPT_FANOUT_MB, work=work)),
               ("elastic_reshard", lambda: bench_elastic_reshard(
                   ELASTIC_MB, work=work)),
               ("global_shuffle", lambda: bench_global_shuffle(
                   GLOBAL_SHUFFLE_MB, work=work)))
    out = {}
    try:
        for name, fn in configs:
            t0 = time.perf_counter()
            out[name] = fn()
            log(f"bench config {name} ({time.perf_counter() - t0:.1f} s):")
            log(json.dumps(out[name]))
    finally:
        for n in os.listdir(work):
            if n.startswith(prefix):
                p = os.path.join(work, n)
                if os.path.isdir(p):
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    os.unlink(p)
    require(out["prefetch"]["to_device"] and out["prefetch"]["hosts"] == 4,
            f"config 4: {out['prefetch']}")
    require(out["multiprocess"]["replay_epochs"] == 2,
            f"config 7: epochs 2-3 were not replayed: {out['multiprocess']}")
    for name in ("page_replay", "spill_replay"):
        require(out[name]["epoch_gauges"] is not None
                and out[name]["platform"] == "gpu",
                f"config {name}: no gauges or not on the card: {out[name]}")
    require(out["recordio"]["engine"] == "native"
            and out["recordio"]["hash"] == records_hash,
            f"config 3: engine {out['recordio']['engine']}, hash "
            f"{out['recordio']['hash']} != the host reader's {records_hash}")
    for name in ("recio_native", "image_record"):
        require(out[name]["native"] is not None
                and out[name]["native"]["assembly_path"] == "native-padded"
                and out[name]["sharded"]["hash"] == out[name]["hash"],
                f"config {name}: the native decode did not run, or not in "
                f"the engine: {out[name]}")
    require(out["libsvm"]["rows"] > 0 and len(out["libsvm"]["hash"]) == 64,
            f"config 1: {out['libsvm']}")
    require(out["csv"]["rows"] > 0 and out["csv"]["nnz"] == out["csv"]["rows"]
            * HIGGS_FEATURES and abs(out["csv"]["sparse_nnz_frac"]
                                     - (1 - CSV_ZERO_FRAC)) < 0.01,
            f"config 2: {out['csv']}")
    require(out["indexed_shuffled"]["engine"] == "native"
            and out["indexed_shuffled"]["hash"] == indexed_hash,
            f"config 6: {out['indexed_shuffled']} (indexed_leg's digest "
            f"{indexed_hash})")
    peer = out["peer_hydrate"]
    require(peer["warm_gets"] == [0, 0]
            and all(b > 0 for b in peer["peer_bytes_per_rank"])
            and max(peer["single_rank_wire_frac"]) <= GANG_PEER_SLACK,
            f"config 15: {peer}")
    fan = out["ckpt_restore_fanout"]
    require(fan["per_rank_wire_frac"] <= GANG_PEER_SLACK
            and fan["gang_wire_frac"] <= GANG_CKPT_WIRE_MAX
            and fan["restore_split"]["peer"] > 0
            and fan["incremental_frac"] <= 0.2,
            f"config 21: {fan}")
    require_shuffle_configs(out["elastic_reshard"], out["global_shuffle"])
    return out


def require_shuffle_configs(el, gs):
    """Config 20's and config 23's bars beyond their own checks."""
    require(el["reshard_count"] >= 2 and el["resume_saved_bytes"] > 0
            and el["gang_wire_frac"] <= 1.3,
            f"config 20: {el}")
    require(gs["windows"] >= 8
            and all(f > 0 for f in gs["peer_frac_per_rank"])
            and gs["gang_wire_frac"] <= 1.6,
            f"config 23: {gs}")


# --------------------------------------------------------------- phase 11b

def remote_config11(linear, work):
    """Config 11 (``bench_remote_hydrate``) at FILE_MB over the linear
    corpus, linked to the name the suite reads: its own checks (every
    epoch's sha256 the local file's, warm epochs and the codec variant's
    second epoch with no GET, the codec moving fewer wire bytes) hold;
    its JSON printed. The hydrated pages are dropped after."""
    from dmlc_tpu_torch.bench_suite import bench_remote_hydrate
    from dmlc_tpu_torch.io.pagestore import PageStore
    prefix = os.path.join(work, "dmlc_tpu_torch_bench_suite.")
    os.link(linear, prefix + "criteo.libsvm")
    t0 = time.perf_counter()
    try:
        out = bench_remote_hydrate(FILE_MB, work=work)
    finally:
        os.unlink(prefix + "criteo.libsvm")
        shutil.rmtree(prefix + "objroot", ignore_errors=True)
        store = PageStore.default()
        for name in os.listdir(store.root):
            if name.startswith("obj-"):
                store.delete(name)
    require(out["cold_gets"] > 0 and out["warm_gets"] == 0
            and out["compressed"]["warm_gets"] == 0
            and out["compressed"]["wire_ratio"] > 1
            and out["pagestore_hit_rate"] == 1.0,
            f"config 11: {out}")
    log(f"bench config remote_hydrate ({time.perf_counter() - t0:.1f} s): "
        f"cold {out['hydrate_gbps']} GB/s in {out['cold_gets']} GETs, "
        f"warm {out['gbps']:.4f} GB/s with {out['warm_gets']} GETs; codec "
        f"level 6: cold {out['compressed']['hydrate_gbps']} GB/s, wire "
        f"bytes / {out['compressed']['wire_ratio']}")
    log(json.dumps(out))
    return out


def remote_chain(uri, part=0, parts=1):
    """The obj:// training chain: the golden parse (engine "auto" on a
    remote URI), the Python padded assembly, pinned async H2D; of a
    local path, the native parse and padded assembly. ``part`` of
    ``parts`` of the input."""
    import torch
    from dmlc_tpu_torch.pipeline import Pipeline
    return (Pipeline.from_uri(uri, part_index=part, num_parts=parts)
            .parse(format="libsvm")
            .batch(ROW_BUCKET, pad=True, row_bucket=ROW_BUCKET,
                   nnz_bucket=NNZ_BUCKET)
            .to_device(torch.device("cuda"), window="auto").build())


def remote_epoch(built, lr, em):
    """One epoch of ``built`` training a fresh SparseLinearModel(10^6),
    the kernels' counts set to 0 just before it and read just after.
    Returns (model, seconds, losses, batch hashes, GETs, launches, the
    epoch's batches). The batches are hashed after the timed region. The
    GETs are counted from the caller's last reset of ``em``'s counters:
    a parser starts reading ahead when its chain is built."""
    import torch
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                              device=torch.device("cuda"))
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    kept, losses = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in built:
        kept.append(batch)
        losses.append(model.train_step(batch))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    gets = em.counters()["gets"]
    hashes = [batch_hash({k: v.cpu() for k, v in b.items()}) for b in kept]
    return (model, secs, [float(x) for x in losses], hashes, gets,
            launches, kept)


def remote_train(linear, lr, work, em):
    """``SparseLinearModel(10^6)`` trained from ``obj://`` on the first
    REMOTE_TRAIN_MB of the linear corpus (cut at a line): a cold and a
    warm epoch of remote_chain, each from a fresh model, and one epoch
    of the same chain over the local copy. Checks: every epoch's padded
    batches hash alike; the warm epoch makes no GET; K1, K2, K8 and K9
    launch once a step and no other kernel launches; the loss falls;
    the epochs' final weights agree within the step tolerance. Returns
    (launches of the cold epoch, stats, the warm epoch's model, three of
    its batches)."""
    import torch
    with open(linear, "rb") as f:
        head = f.read(REMOTE_TRAIN_MB << 20)
    head = head[:head.rindex(b"\n") + 1]
    local = os.path.join(work, "remote_train.libsvm")
    with open(local, "wb") as f:
        f.write(head)
    uri = "obj://smoke/criteo/train.libsvm"
    em.put("smoke", "criteo/train.libsvm", head)
    runs = {}
    em.reset_counters()
    built = remote_chain(uri)
    for name in ("cold", "warm"):
        runs[name] = remote_epoch(built, lr, em)
        em.reset_counters()
    built.close()
    with remote_chain(local) as built:
        runs["local"] = remote_epoch(built, lr, em)
    os.unlink(local)
    model, _, _, hashes, _, _, kept = runs["warm"]
    steps = len(hashes)
    require(steps > 1, f"the obj:// epoch gave {steps} batches")
    want = {k: steps if k in PATH_KERNELS["linear"] else 0
            for k in _wrappers()}
    base = runs["local"][0]
    for name, (m, secs, losses, h, gets, launches, _) in runs.items():
        require(h == hashes, f"obj:// training: the {name} epoch's padded "
                "batches differ from the warm obj:// epoch's")
        require(launches == want, f"obj:// training: {name} epoch "
                f"launches {launches} != {want}")
        require(all(x == x and abs(x) != float("inf") for x in losses)
                and losses[-1] < losses[0],
                f"obj:// training: {name} losses {losses}")
        for label, a, b in (("w", m.w, base.w), ("b", m.b, base.b)):
            a, b = a.detach().cpu(), b.detach().cpu()
            require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                    f"obj:// training: the {name} epoch's {label} vs the "
                    f"local chain's: max |err| {(a - b).abs().max().item()}")
    require(runs["cold"][4] > 0 and runs["warm"][4] == 0,
            f"obj:// training: GETs cold {runs['cold'][4]}, warm "
            f"{runs['warm'][4]} (want > 0, 0)")
    size = len(head)
    stats = {name: {"gbps": size / r[1] / 1e9, "steps_per_s": steps / r[1],
                    "seconds": r[1], "gets": r[4],
                    "loss": [r[2][0], r[2][-1]]}
             for name, r in runs.items()}
    stats.update(bytes=size, steps=steps)
    log(f"obj:// training: SparseLinearModel(10^6) over {size} bytes "
        f"({steps} steps a epoch): cold {stats['cold']['gbps']:.4f} GB/s, "
        f"{stats['cold']['steps_per_s']:.2f} steps/s, {runs['cold'][4]} GETs;"
        f" warm {stats['warm']['gbps']:.4f} GB/s, "
        f"{stats['warm']['steps_per_s']:.2f} steps/s, 0 GETs; the local "
        f"chain {stats['local']['gbps']:.4f} GB/s, "
        f"{stats['local']['steps_per_s']:.2f} steps/s; loss "
        f"{runs['warm'][2][0]:.4f} -> {runs['warm'][2][-1]:.4f}; padded "
        f"batches hash alike; launches {runs['cold'][5]}")
    return runs["cold"][5], stats, model, kept[:3]


def remote_checkpoint(model, resume, lr, work, em, step):
    """The trained linear model saved to ``obj://smoke/ck`` by
    ShardedCheckpoint and restored into fresh models on the card, from
    the page store the save filled and cold (a fresh page store), bit for
    bit, each restore's local and wire bytes adding up to the
    checkpoint's pages; a re-save of the unchanged state puts no page;
    then 3 steps on each restored model and on ``model`` agree within
    the step tolerance."""
    import torch
    from dmlc_tpu_torch.io import pagestore
    from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    cuda = torch.device("cuda")
    ck = ShardedCheckpoint("obj://smoke/ck")
    em.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(step, model.state_dict(), metadata={"epoch": 2})
    save_s = time.perf_counter() - t0
    page_bytes = sum(o.size for o in em.list("smoke", "ck/pages"))
    nbytes = sum(v.numel() * v.element_size()
                 for v in model.state_dict().values())
    restored, times = {}, {}
    env = os.environ.get(pagestore.ENV_STORE_DIR)
    try:
        for tier in ("local", "wire"):
            if tier == "wire":
                os.environ[pagestore.ENV_STORE_DIR] = os.path.join(
                    work, "pages_cold")
            c = ShardedCheckpoint("obj://smoke/ck")
            fresh = SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                                      device=cuda)
            t0 = time.perf_counter()
            state, user = c.restore(like=fresh.state_dict())
            fresh.load_state_dict(state)
            torch.cuda.synchronize()
            times[tier] = time.perf_counter() - t0
            require(c.latest_step() == step and user == {"epoch": 2}
                    and all(v.device.type == "cuda"
                            for v in state.values()),
                    f"obj:// checkpoint ({tier}): step {c.latest_step()}, "
                    f"user {user}")
            _same_state(f"obj:// ({tier})", fresh.state_dict(),
                        model.state_dict())
            split = {"local": c.last_restore_local_bytes,
                     "wire": c.last_restore_wire_bytes}
            require(split["local"] + split["wire"] == page_bytes
                    and split[tier] == page_bytes,
                    f"obj:// checkpoint ({tier}): restore split {split}, "
                    f"the pages {page_bytes} bytes")
            restored[tier] = fresh
    finally:
        if env is None:
            os.environ.pop(pagestore.ENV_STORE_DIR, None)
        else:
            os.environ[pagestore.ENV_STORE_DIR] = env
        shutil.rmtree(os.path.join(work, "pages_cold"), ignore_errors=True)
    em.reset_counters()
    ck.save(step + 1, model.state_dict(), metadata={"epoch": 2})
    resave = em.counters()
    require(ck.last_save_bytes_written == 0 and resave["put_parts"] == 0
            and resave["puts"] == 3,
            f"obj:// checkpoint: the unchanged re-save wrote "
            f"{ck.last_save_bytes_written} page bytes, counters {resave} "
            "(want only the index, meta.json and COMMIT)")
    after = {}
    for name, m in [("uninterrupted", model)] + list(restored.items()):
        ls = [m.train_step(b) for b in resume]
        after[name] = (torch.stack(ls).cpu(), m.w.detach().cpu(),
                       m.b.detach().cpu())
    for name in restored:
        for label, a, b in zip(("losses", "w", "b"), after[name],
                               after["uninterrupted"]):
            require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                    f"obj:// checkpoint: 3 steps after the {name} restore "
                    f"vs the uninterrupted model: {label} max |err| "
                    f"{(a - b).abs().max().item()}")
    log(f"obj:// checkpoint: {nbytes} bytes of parameters ({page_bytes} "
        f"of pages) saved in {save_s:.4f} s ({nbytes / save_s / 1e9:.3f} "
        f"GB/s); restored bit for bit from the page store in "
        f"{times['local']:.4f} s ({page_bytes / times['local'] / 1e9:.3f} "
        f"GB/s) and cold over the wire in {times['wire']:.4f} s "
        f"({page_bytes / times['wire'] / 1e9:.3f} GB/s); the unchanged "
        f"re-save put no page ({resave['puts']} PUTs, "
        f"{resave['put_bytes']} bytes); 3 steps after each restore match "
        f"the uninterrupted model's")
    return {"bytes": nbytes, "page_bytes": page_bytes, "save_s": save_s,
            "restore_s": times, "resave": resave}


def remote_path(linear, lr, work):
    """Phase 11b: config 11, training from obj:// and the remote
    checkpoint (see the module docstring). Returns
    (the obj:// training epoch's launches, stats)."""
    import dmlc_tpu_torch.io.objstore as objstore
    t0 = time.perf_counter()
    out = {"config11": remote_config11(linear, work)}
    objroot = os.path.join(work, "objroot")
    em = objstore.configure(root=objroot, latency_s=REMOTE_LATENCY_S,
                            bandwidth_gbps=REMOTE_GBPS)
    try:
        launches, out["train"], model, resume = remote_train(
            linear, lr, work, em)
        out["checkpoint"] = remote_checkpoint(
            model, resume, lr, work, em, out["train"]["steps"])
    finally:
        objstore.configure(None)
        shutil.rmtree(objroot, ignore_errors=True)
    log(f"remote path: {time.perf_counter() - t0:.1f} s")
    return launches, out


# --------------------------------------------------------------- phase 11c

GANG_PEER_WORKER = r"""
import hashlib, json, os, sys, time
t_start = time.time()
(mode, uri, local, ck_uri, out_dir, rows, nnz_bucket, features, lr, parts,
 block_bytes, coalesce, attempts) = sys.argv[1:14]
rows, nnz_bucket, features, parts = (int(rows), int(nnz_bucket),
                                     int(features), int(parts))
rank = int(os.environ["DMLC_TPU_TASK_ID"])
world = int(os.environ["DMLC_TPU_NUM_WORKER"])
# each rank its own page store, named before the package is imported: a
# shared store would serve peers' pages through the filesystem
os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(
    out_dir, f"store-{mode}-{rank}")
import numpy as np
import torch
if not torch.cuda.is_available():
    raise RuntimeError("gang worker: no CUDA card")
cuda = torch.device("cuda")
import dmlc_tpu_torch.io.objstore as objstore
from dmlc_tpu_torch import rendezvous
from dmlc_tpu_torch.bench_ckpt_worker import fanout_restore
from dmlc_tpu_torch.bench_peer_worker import barrier, epoch
from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.obs.serve import scrape, serve_if_env
from dmlc_tpu_torch.ops import csr
from dmlc_tpu_torch.ops import step as step_ops
from dmlc_tpu_torch.pipeline import Pipeline
from dmlc_tpu_torch.rendezvous.elastic import assign_parts
from dmlc_tpu_torch.resilience import RetryPolicy, set_policy
wrappers = {"csr_spmv": csr.csr_spmv, "csr_spmv_t": csr.csr_spmv_t,
            "logistic_step": step_ops.logistic_step,
            "sgd_update": step_ops.sgd_update}

def gang_barrier(phase):
    barrier(out_dir, f"{mode}-{phase}", rank, world, timeout_s=240.0)

def batch_hash(batch):
    h = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(batch[k].cpu().numpy())
        h.update(k.encode() + a.dtype.str.encode())
        h.update(a.tobytes())
    return h.hexdigest()

def chain(path, part):
    return (Pipeline.from_uri(path, part_index=part, num_parts=parts)
            .parse(format="libsvm")
            .batch(rows, pad=True, row_bucket=rows, nnz_bucket=nnz_bucket)
            .to_device(cuda, window="auto").build())

def save_npy(prefix, state):
    for k, v in state.items():
        np.save(os.path.join(out_dir, f"{prefix}-{k}.npy"),
                v.detach().cpu().numpy())

srv = serve_if_env()
if srv is None:
    raise RuntimeError("gang worker needs launch_local(serve_ports=...)")
objstore.configure(block_bytes=int(block_bytes), coalesce=int(coalesce))
# patience at the peer seam: a 404 is usually the owner mid-hydration
set_policy("io.objstore.peer", RetryPolicy(
    max_attempts=int(attempts), base_delay_s=0.05, max_delay_s=0.4))
out = {"rank": rank, "mode": mode}
if mode == "train":
    cli = rendezvous.install_if_env()
    if cli is None:
        raise RuntimeError("gang worker needs launch_local(rendezvous=True)")
    # the whole gang in this member's view before the first read: the
    # roster orders the peer tier's owners, the same order on every rank
    deadline = time.monotonic() + 30
    while cli.world < world:
        if time.monotonic() > deadline:
            raise TimeoutError(f"rendezvous world {cli.world}")
        cli.heartbeat()
        time.sleep(0.05)
    gang_barrier("start")
    out["cold"] = epoch(uri)
    gang_barrier("cold")
    out["warm"] = epoch(uri)
    # ownership of the parts, from one view
    view = cli.view()
    mine = assign_parts(parts, view["world"], view["rank"])
    model = SparseLinearModel(features, learning_rate=float(lr),
                              device=cuda)
    for fn in wrappers.values():
        fn.launches = 0
    kept, losses = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in mine:
        with chain(uri, p) as built:
            for batch in built:
                kept.append((p, batch))
                losses.append(model.train_step(batch))
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    hashes = {}
    for p, b in kept:
        hashes.setdefault(str(p), []).append(batch_hash(b))
    losses = [float(x) for x in losses]
    out.update(parts=mine, view=view, steps=len(kept), hashes=hashes,
               loss_first=losses[0], loss_last=losses[-1],
               finite=all(x == x and abs(x) != float("inf")
                          for x in losses))
    gang_barrier("trained")
    if rank == 0:
        # the gang is alive: rank 1 waits at the "done" barrier
        from urllib.request import urlopen
        ports = [int(p) for p in
                 os.environ["DMLC_TPU_SERVE_PORTS"].split(",")]
        with urlopen(f"http://127.0.0.1:{ports[1]}/metrics",
                     timeout=10) as r:
            text = r.read().decode()
        values = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                values[name] = float(value)
        out["scrape"] = {
            "metrics_lines": len(text.splitlines()),
            "peer_get_total": values.get("dmlc_objstore_peer_get_total"),
            "healthz": scrape(ports[1], path="/healthz"),
            "gang": scrape(ports[0], path="/gang")}
    state = {k: v for k, v in model.state_dict().items()}
    save_npy(f"train-{rank}", state)
    t0 = time.perf_counter()
    ShardedCheckpoint(ck_uri).save(1, {f"rank{rank}": state},
                                   metadata={"parts": str(mine)},
                                   writer=rank, num_writers=world)
    out["save_s"] = time.perf_counter() - t0
    out["save_bytes"] = sum(v.numel() * v.element_size()
                            for v in state.values())
else:
    ck = ShardedCheckpoint(ck_uri)
    like = {f"rank{r}": SparseLinearModel(features, device=cuda).state_dict()
            for r in range(world)}
    state, user, report = fanout_restore(ck, out_dir, rank, world,
                                         like=like,
                                         sync=torch.cuda.synchronize)
    out.update(report, on_card=all(v.device.type == "cuda"
                                   for leaves in state.values()
                                   for v in leaves.values()))
    for r in range(world):
        save_npy(f"restore-{rank}-{r}", state[f"rank{r}"])
    # one step on this rank's restored model, a batch of the local copy
    model = SparseLinearModel(features, learning_rate=float(lr),
                              device=cuda)
    model.load_state_dict(state[f"rank{rank}"])
    with chain(local, rank) as built:
        batch = next(iter(built))
        for fn in wrappers.values():
            fn.launches = 0
        loss = float(model.train_step(batch))
        torch.cuda.synchronize()
    out["step"] = {"loss": loss,
                   "launches": {k: fn.launches for k, fn in wrappers.items()}}
out["worker_s"] = time.time() - t_start
gang_barrier("done")
tmp = os.path.join(out_dir, f"{mode}-{rank}.tmp")
with open(tmp, "w") as f:
    json.dump(out, f)
os.replace(tmp, os.path.join(out_dir, f"{mode}-{rank}.json"))
"""


def _gang(script, args, out_dir, prefix, env=None, **kw):
    """One launch_local gang of GANG_RANKS processes of ``script`` with
    ``args`` (this checkout first on PYTHONPATH, ``env`` beside it); every
    rank must exit 0. Returns (each rank's ``<prefix>-<rank>.json`` in
    ``out_dir``, spawn-to-exit seconds)."""
    from dmlc_tpu_torch.parallel.launch import launch_local
    t0 = time.perf_counter()
    codes = launch_local(GANG_RANKS, [sys.executable, script] + args,
                         env={"PYTHONPATH": REPO, **(env or {})},
                         timeout=GANG_TIMEOUT_S, **kw)
    secs = time.perf_counter() - t0
    require(codes == [0] * GANG_RANKS,
            f"gang: the gang writing {prefix}-*.json in {out_dir} exited "
            f"{codes}")
    outs = []
    for r in range(GANG_RANKS):
        with open(os.path.join(out_dir, f"{prefix}-{r}.json")) as f:
            outs.append(json.load(f))
    return outs, secs


def _local_part_hashes(local):
    """The padded batches' hashes of the local chain over each of
    GANG_PARTS parts."""
    out = {}
    for p in range(GANG_PARTS):
        with remote_chain(local, p, GANG_PARTS) as built:
            out[str(p)] = [batch_hash({k: v.cpu() for k, v in b.items()})
                           for b in built]
    return out


def gang_path(linear, lr, work):
    """Phase 11c: the gang plane (see the module docstring): a training
    gang that hydrates its corpus through the objstore peer tier, trains
    a model a rank on the card and saves them as one 2-writer checkpoint
    (``train`` mode of GANG_PEER_WORKER, under ``serve_ports=True,
    rendezvous=True``), then a restore gang with the checkpoint fanout
    (``restore`` mode). Returns the phase's numbers."""
    import numpy as np
    import dmlc_tpu_torch.io.objstore as objstore
    t_phase = time.perf_counter()
    script = os.path.join(work, "gang_peer_worker.py")
    with open(script, "w") as f:
        f.write(GANG_PEER_WORKER)
    with open(linear, "rb") as f:
        head = f.read(REMOTE_TRAIN_MB << 20)
    head = head[:head.rindex(b"\n") + 1]
    local = os.path.join(work, "gang_train.libsvm")
    with open(local, "wb") as f:
        f.write(head)
    size = len(head)
    local_sha = hashlib.sha256(head).hexdigest()
    objroot = os.path.join(work, "gang_objroot")
    em = objstore.configure(root=objroot)
    try:
        em.put("smoke", "gang/train.libsvm", head)
    finally:
        objstore.configure(None)
    out_dir = os.path.join(work, "gang")
    os.makedirs(out_dir)
    env = {objstore.ENV_ROOT: objroot,
           objstore.ENV_LATENCY: str(REMOTE_LATENCY_S),
           objstore.ENV_GBPS: str(REMOTE_GBPS)}
    ck_uri = "obj://smoke/gang/ck"
    args = ["obj://smoke/gang/train.libsvm", local, ck_uri, out_dir,
            str(ROW_BUCKET), str(NNZ_BUCKET), str(NUM_FEATURES), str(lr),
            str(GANG_PARTS), str(GANG_BLOCK_MB << 20), str(GANG_COALESCE),
            str(GANG_PEER_ATTEMPTS)]
    try:
        train, train_s = _gang(script, ["train"] + args, out_dir, "train",
                               env, serve_ports=True, rendezvous=True)
        want = _local_part_hashes(local)
        # 1. the peer-hydrated read
        for r in train:
            cold, warm = r["cold"], r["warm"]
            require(cold["sha256"] == warm["sha256"] == local_sha
                    and cold["bytes"] == size,
                    f"gang path: rank {r['rank']}'s obj:// reads differ "
                    "from the local file")
            require(cold["counters"]["objstore.bytes"]
                    <= GANG_PEER_SLACK * size,
                    f"gang path: rank {r['rank']} moved "
                    f"{cold['counters']['objstore.bytes']} wire bytes of "
                    f"{size} (> {GANG_PEER_SLACK}); the ranks' cold reads: "
                    f"{[(x['cold']['counters'], x['cold']['wall_s']) for x in train]}")
            require(cold["counters"]["objstore.peer.bytes"] > 0,
                    f"gang path: rank {r['rank']}'s peer tier is inert: "
                    f"{cold['counters']}")
            require(warm["counters"]["objstore.get"] == 0,
                    f"gang path: rank {r['rank']}'s warm read made "
                    f"{warm['counters']['objstore.get']} GETs")
        # 2. the training
        seen = sorted(p for r in train for p in r["parts"])
        require(seen == list(range(GANG_PARTS)),
                f"gang path: the ranks' parts {seen} do not cover "
                f"{GANG_PARTS} parts once")
        for r in train:
            steps = r["steps"]
            require(steps > 0 and r["launches"]
                    == {k: steps for k in PATH_KERNELS["linear"]},
                    f"gang path: rank {r['rank']} took {steps} steps with "
                    f"launches {r['launches']}")
            require(r["finite"] and r["loss_last"] < r["loss_first"],
                    f"gang path: rank {r['rank']}'s loss "
                    f"{r['loss_first']} -> {r['loss_last']}")
            for p in r["parts"]:
                require(r["hashes"][str(p)] == want[str(p)],
                        f"gang path: rank {r['rank']}'s padded batches of "
                        f"part {p} differ from the local chain's")
        sc = train[0]["scrape"]
        require(sc["metrics_lines"] > 10 and sc["peer_get_total"]
                and sc["peer_get_total"] > 0,
                f"gang path: rank 1's /metrics as rank 0 scraped it: {sc}")
        require(sc["healthz"]["ok"] is True and sc["healthz"]["rank"] == 1,
                f"gang path: rank 1's /healthz: {sc['healthz']}")
        require(sc["gang"]["membership"]["world"] == GANG_RANKS,
                f"gang path: rank 0's /gang: {sc['gang']}")
        with open(os.path.join(objroot, "smoke", "gang", "ck",
                               "step-00000001", "meta.json")) as f:
            meta = json.load(f)
        stamp = meta.get("rendezvous") or {}
        require(stamp.get("gang") == "local"
                and stamp.get("member") == "worker-0"
                and meta["num_processes"] == GANG_RANKS,
                f"gang path: the checkpoint's meta.json {meta}")
        page_bytes = sum(
            os.path.getsize(os.path.join(d, n))
            for d, _, names in os.walk(os.path.join(objroot, "smoke",
                                                    "gang", "ck", "pages"))
            for n in names)
        # 3. the fanout restore
        restore, restore_s = _gang(script, ["restore"] + args, out_dir,
                                   "restore", env, serve_ports=True)
        for r in range(GANG_RANKS):
            for k in ("w", "b"):
                saved = np.load(os.path.join(out_dir, f"train-{r}-{k}.npy"))
                for q in range(GANG_RANKS):
                    got = np.load(os.path.join(out_dir,
                                               f"restore-{q}-{r}-{k}.npy"))
                    require(got.dtype == saved.dtype
                            and got.shape == saved.shape
                            and got.tobytes() == saved.tobytes(),
                            f"gang path: rank {q} restored rank {r}'s {k} "
                            "not bit for bit")
        s0, s1 = restore[0]["split"], restore[1]["split"]
        require(s0["local"] == s1["local"] == 0
                and s0["wire"] == s1["peer"] and s1["wire"] == s0["peer"]
                and s0["wire"] + s1["wire"] == restore[0]["restored_bytes"],
                f"gang path: the restore splits are not complementary: "
                f"{s0}, {s1}")
        gang_wire = sum(r["wire_bytes"] for r in restore)
        require(gang_wire <= GANG_CKPT_WIRE_MAX * page_bytes
                and s0["peer"] + s1["peer"] > 0,
                f"gang path: the restore gang moved {gang_wire} wire bytes "
                f"for {page_bytes} of pages, peer {s0['peer'] + s1['peer']}")
        for r in restore:
            require(r["on_card"] and r["step"]["launches"]
                    == {k: 1 for k in PATH_KERNELS["linear"]}
                    and r["step"]["loss"] == r["step"]["loss"],
                    f"gang path: rank {r['rank']}'s restored step: "
                    f"{r['step']}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(objroot, ignore_errors=True)
        os.unlink(local)
    cold_s = max(r["cold"]["wall_s"] for r in train)
    warm_s = max(r["warm"]["wall_s"] for r in train)
    stats = {
        "bytes": size, "cold_gbps": size / cold_s / 1e9,
        "warm_gbps": size / warm_s / 1e9,
        "wire_bytes": [r["cold"]["counters"]["objstore.bytes"]
                       for r in train],
        "peer_bytes": [r["cold"]["counters"]["objstore.peer.bytes"]
                       for r in train],
        "served_bytes": [r["cold"]["counters"]["objstore.peer.served_bytes"]
                         for r in train],
        "peer_miss": [r["cold"]["counters"]["objstore.peer.miss"]
                      for r in train],
        "steps": [r["steps"] for r in train],
        "steps_per_s": [r["steps"] / r["train_s"] for r in train],
        "save_gbps": [r["save_bytes"] / r["save_s"] / 1e9 for r in train],
        "page_bytes": page_bytes,
        "restore_gbps": [r["restored_bytes"] / r["restore_s"] / 1e9
                         for r in restore],
        "fanout_gbps": [r["restored_bytes"] / r["wall_s"] / 1e9
                        for r in restore],
        "restore_split": [r["split"] for r in restore],
        "restore_wire": [r["wire_bytes"] for r in restore],
        "gang_s": {"train": train_s, "restore": restore_s},
        "worker_wall_s": {"train": [r["worker_s"] for r in train],
                          "restore": [r["worker_s"] for r in restore]},
    }
    log(f"gang path: 2 CUDA processes on the card, each its own page store, "
        f"over {size} bytes of obj://: cold {stats['cold_gbps']:.4f} GB/s, "
        f"warm {stats['warm_gbps']:.4f} GB/s (the slower rank); wire bytes "
        f"{stats['wire_bytes']}, peer bytes {stats['peer_bytes']}, served "
        f"{stats['served_bytes']}, peer misses {stats['peer_miss']}; "
        f"SparseLinearModel(10^6) a rank on parts "
        f"{[r['parts'] for r in train]}: steps {stats['steps']}, "
        f"{[round(x, 2) for x in stats['steps_per_s']]} steps/s, losses "
        f"{[(round(r['loss_first'], 4), round(r['loss_last'], 4)) for r in train]}"
        f", batches hashing as the local chain's; /metrics of rank 1 "
        f"({sc['metrics_lines']} lines, peer GETs {sc['peer_get_total']}), "
        f"/healthz, /gang world {sc['gang']['membership']['world']}; saved "
        f"at {[round(x, 3) for x in stats['save_gbps']]} GB/s a writer "
        f"({page_bytes} bytes of pages, meta.json stamped); restored bit "
        f"for bit onto the card at "
        f"{[round(x, 3) for x in stats['restore_gbps']]} GB/s (with the "
        f"prefetch and barrier {[round(x, 3) for x in stats['fanout_gbps']]}"
        f"), splits {stats['restore_split']}, restore wire "
        f"{stats['restore_wire']}; one step a rank after; gangs spawn to "
        f"exit {train_s:.2f} s and {restore_s:.2f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return stats


SHUFFLE_GANG_WORKER = r"""
import hashlib, json, os, sys, time
t_start = time.time()
(path, out_dir, seed, window_bytes, rows, nnz_bucket, features, lr,
 attempts) = sys.argv[1:10]
rows, nnz_bucket, features = int(rows), int(nnz_bucket), int(features)
rank = int(os.environ["DMLC_TPU_TASK_ID"])
world = int(os.environ["DMLC_TPU_NUM_WORKER"])
# each rank its own page store, named before the package is imported: a
# shared store would hand windows over through the filesystem
os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(
    out_dir, f"store-{rank}")
import torch
if not torch.cuda.is_available():
    raise RuntimeError("shuffle gang worker: no CUDA card")
cuda = torch.device("cuda")
from dmlc_tpu_torch.bench_peer_worker import barrier, counters, delta
from dmlc_tpu_torch.bench_shuffle_worker import SHUFFLE_COUNTERS
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.obs.serve import serve_if_env
from dmlc_tpu_torch.ops import csr
from dmlc_tpu_torch.ops import step as step_ops
from dmlc_tpu_torch.pipeline import Pipeline
from dmlc_tpu_torch.resilience import RetryPolicy, set_policy
wrappers = {"csr_spmv": csr.csr_spmv, "csr_spmv_t": csr.csr_spmv_t,
            "logistic_step": step_ops.logistic_step,
            "sgd_update": step_ops.sgd_update}

def row_hashes(batch):
    b = {k: v.cpu().numpy() for k, v in batch.items()}
    off = b["offset"]
    out = []
    for r in range(int(b["num_rows"])):
        s, e = int(off[r]), int(off[r + 1])
        out.append(hashlib.sha256(
            b["label"][r].tobytes() + b["weight"][r].tobytes()
            + b["index"][s:e].tobytes()
            + b["value"][s:e].tobytes()).hexdigest())
    return out

srv = serve_if_env()
if srv is None:
    raise RuntimeError("shuffle gang worker needs "
                       "launch_local(serve_ports=...)")
# patience at the peer seam: a 404 is usually the window's owner still
# assembling it (the ranks walk the same window order)
set_policy("io.objstore.peer", RetryPolicy(
    max_attempts=int(attempts), base_delay_s=0.05, max_delay_s=0.4))
model = SparseLinearModel(features, learning_rate=float(lr), device=cuda)
torch.cuda.synchronize()  # the CUDA context before the first epoch
out = {"rank": rank}
# both servers up before a rank reads: the chain reads ahead once built
barrier(out_dir, "start", rank, world, timeout_s=240.0)
built = None
for name in ("cold", "warm"):
    before = counters(SHUFFLE_COUNTERS)
    for fn in wrappers.values():
        fn.launches = 0
    kept, losses = [], []
    t0 = time.perf_counter()
    if built is None:  # the cold epoch's bytes and wall count the build
        built = (Pipeline.from_uri(path, part_index=rank, num_parts=world)
                 .shuffle(global_seed=int(seed),
                          window_bytes=int(window_bytes))
                 .parse(format="libsvm")
                 .batch(rows, pad=True, row_bucket=rows,
                        nnz_bucket=nnz_bucket)
                 .to_device(cuda, window="auto").build())
    for batch in built:  # each pass is the global order's next epoch
        kept.append(batch)
        losses.append(model.train_step(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    out[name] = {
        "wall_s": wall, "steps": len(kept),
        "counters": delta(before, counters(SHUFFLE_COUNTERS)),
        "launches": {k: fn.launches for k, fn in wrappers.items()},
        "rows": [h for b in kept for h in row_hashes(b)],
        "loss_first": losses[0], "loss_last": losses[-1],
        "finite": all(x == x and abs(x) != float("inf") for x in losses)}
    kept.clear()
    barrier(out_dir, name, rank, world, timeout_s=240.0)
from dmlc_tpu_torch import shuffle
out["view"] = shuffle.view()
built.close()
out["worker_s"] = time.time() - t_start
barrier(out_dir, "done", rank, world, timeout_s=240.0)
tmp = os.path.join(out_dir, f"shuffle-{rank}.tmp")
with open(tmp, "w") as f:
    json.dump(out, f)
os.replace(tmp, os.path.join(out_dir, f"shuffle-{rank}.json"))
"""


def shuffle_path(linear, lr, work):
    """Phase 11d: the global shuffle plane (see the module docstring):
    the world-1 golden of the seeded global order on the host, then a
    2-rank gang of SHUFFLE_GANG_WORKER under ``serve_ports=True`` (each
    rank its own page store, windows through the peers' ``/pages``)
    training a model a rank on its half of that order, cold and warm.
    Returns the phase's numbers."""
    from dmlc_tpu_torch.pipeline import Pipeline
    from dmlc_tpu_torch.shuffle import (
        GlobalShuffle, GlobalShuffleSplit, build_record_index,
        displacement_stats,
    )
    t_phase = time.perf_counter()
    window_bytes = SHUFFLE_WINDOW_MB << 20
    with open(linear, "rb") as f:
        head = f.read(REMOTE_TRAIN_MB << 20)
    head = head[:head.rindex(b"\n") + 1]
    local = os.path.join(work, "shuffle_train.libsvm")
    with open(local, "wb") as f:
        f.write(head)
    size = len(head)
    lines = head.split(b"\n")[:-1]
    del head
    out_dir = os.path.join(work, "shuffle")
    os.makedirs(out_dir)
    try:
        # 1. the world-1 golden: the split's records are the corpus's
        # lines, in the order GlobalShuffle draws, and the host chain's
        # rows over the same split
        t0 = time.perf_counter()
        sp = GlobalShuffleSplit(local, 0, 1, "text", seed=SEED,
                                window_bytes=window_bytes)
        recs = list(sp)
        drain_s = time.perf_counter() - t0
        windows = sp.reader.num_windows
        del sp
        require(windows >= SHUFFLE_MIN_WINDOWS,
                f"shuffle path: {windows} windows of {window_bytes} bytes "
                f"over {size} bytes")
        require(sorted(recs) == sorted(lines),
                "shuffle path: the world-1 drain is not the corpus's lines "
                "as a multiset")
        order = GlobalShuffle(build_record_index(local, "text").sizes, SEED,
                              window_bytes).order(0)
        require(recs == [lines[k] for k in order],
                "shuffle path: the world-1 drain is not GlobalShuffle's "
                "order")
        disp = displacement_stats(order)
        del recs, lines
        t0 = time.perf_counter()
        with (Pipeline.from_uri(local)
              .shuffle(global_seed=SEED, window_bytes=window_bytes)
              .parse(format="libsvm")
              .batch(ROW_BUCKET, pad=True, row_bucket=ROW_BUCKET,
                     nnz_bucket=NNZ_BUCKET).build()) as built:
            golden = [h for b in built for h in row_hashes(b)]
        golden_s = time.perf_counter() - t0
        require(len(golden) == len(order),
                f"shuffle path: the world-1 chain gave {len(golden)} rows "
                f"of {len(order)} lines")
        # 2. the gang
        script = os.path.join(work, "shuffle_gang_worker.py")
        with open(script, "w") as f:
            f.write(SHUFFLE_GANG_WORKER)
        gang, gang_s = _gang(
            script, [local, out_dir, str(SEED), str(window_bytes),
                     str(ROW_BUCKET), str(NNZ_BUCKET), str(NUM_FEATURES),
                     str(lr), str(GANG_PEER_ATTEMPTS)],
            out_dir, "shuffle", serve_ports=True)
        for r in gang:
            for name in ("cold", "warm"):
                e = r[name]
                require(e["steps"] > 0 and e["launches"]
                        == {k: e["steps"] for k in PATH_KERNELS["linear"]},
                        f"shuffle path: rank {r['rank']}'s {name} epoch took "
                        f"{e['steps']} steps with launches {e['launches']}")
                require(e["finite"], f"shuffle path: rank {r['rank']}'s "
                        f"{name} losses are not finite")
            require(abs(r["cold"]["loss_first"] - 0.6931) < 1e-3
                    and r["warm"]["loss_last"] < r["cold"]["loss_first"],
                    f"shuffle path: rank {r['rank']}'s loss "
                    f"{r['cold']['loss_first']} -> {r['warm']['loss_last']}")
            cold, warm = r["cold"]["counters"], r["warm"]["counters"]
            require(cold["shuffle.bytes.peer"] > 0,
                    f"shuffle path: rank {r['rank']} fetched no window from "
                    f"a peer: {cold}")
            require(warm["shuffle.bytes.wire"] == 0
                    and warm["shuffle.bytes.peer"] == 0,
                    f"shuffle path: rank {r['rank']}'s warm epoch left its "
                    f"page store: {warm}")
            v = r["view"]
            require((v["seed"], v["world"], v["rank"], v["position"])
                    == (SEED, GANG_RANKS, r["rank"], v["records"])
                    and v["delivered"] == len(r["warm"]["rows"]),
                    f"shuffle path: rank {r['rank']}'s /shuffle view after "
                    f"the warm epoch: {r['view']}")
        warm = [h for r in gang for h in r["warm"]["rows"]]
        require(sorted(warm) == sorted(golden)
                and warm != [h for r in gang for h in r["cold"]["rows"]],
                "shuffle path: the warm epoch's rows are not the corpus's "
                "in a new order")
        streams = [r["cold"]["rows"] for r in gang]
        require([len(x) for x in streams]
                == [len(range(q, len(golden), GANG_RANKS))
                    for q in range(GANG_RANKS)],
                f"shuffle path: the ranks' rows {[len(x) for x in streams]} "
                f"of {len(golden)}")
        merged = [streams[p % GANG_RANKS][p // GANG_RANKS]
                  for p in range(len(golden))]
        require(merged == golden,
                "shuffle path: the ranks' rows merged by position differ "
                "from the world-1 order")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        os.unlink(local)
    wire = [r["cold"]["counters"]["shuffle.bytes.wire"] for r in gang]
    peer = [r["cold"]["counters"]["shuffle.bytes.peer"] for r in gang]
    cold_s = max(r["cold"]["wall_s"] for r in gang)
    warm_s = max(r["warm"]["wall_s"] for r in gang)
    stats = {
        "bytes": size, "windows": windows, "rows": len(golden),
        "displacement_normalized": disp["normalized_mean"],
        "drain_gbps": size / drain_s / 1e9,
        "golden_gbps": size / golden_s / 1e9,
        "cold_gbps": size / cold_s / 1e9, "warm_gbps": size / warm_s / 1e9,
        "steps": [[r["cold"]["steps"], r["warm"]["steps"]] for r in gang],
        "steps_per_s": [[r[e]["steps"] / r[e]["wall_s"]
                         for e in ("cold", "warm")] for r in gang],
        "losses": [[r["cold"]["loss_first"], r["warm"]["loss_last"]]
                   for r in gang],
        "wire_bytes": wire, "peer_bytes": peer,
        "peer_frac": [p / (p + w) if p + w else 0.0
                      for p, w in zip(peer, wire)],
        "gang_wire_frac": sum(wire) / size,
        "windows_built": [r["cold"]["counters"]["shuffle.windows.built"]
                          for r in gang],
        "windows_fetched": [r["cold"]["counters"]["shuffle.windows.fetched"]
                            for r in gang],
        "gang_s": gang_s,
        "worker_s": [r["worker_s"] for r in gang],
    }
    log(f"shuffle path: the world-1 drain of {size} bytes in {windows} "
        f"windows of {window_bytes} at {stats['drain_gbps']:.4f} GB/s "
        f"(displacement {disp['normalized_mean']:.4f} of uniform), its "
        f"host chain of {len(golden)} rows at {stats['golden_gbps']:.4f} "
        f"GB/s; 2 CUDA processes on the card, each its own page store, "
        f"training SparseLinearModel(10^6) a rank on its half of the "
        f"order: cold {stats['cold_gbps']:.4f} GB/s, warm "
        f"{stats['warm_gbps']:.4f} GB/s (the slower rank), steps "
        f"{stats['steps']}, steps/s "
        f"{[[round(x, 2) for x in r] for r in stats['steps_per_s']]}, "
        f"losses {[[round(x, 4) for x in r] for r in stats['losses']]}, "
        f"K1, K2, K8 and K9 once a step; cold wire bytes {wire}, peer "
        f"bytes {peer} (peer fraction "
        f"{[round(x, 4) for x in stats['peer_frac']]}), windows built "
        f"{stats['windows_built']} and fetched {stats['windows_fetched']}, "
        f"gang wire {stats['gang_wire_frac']:.4f} of the corpus; warm "
        f"epochs with no wire or peer byte; the merged rows the world-1 "
        f"order's; gang spawn to exit {gang_s:.2f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return stats


def transfer_probe():
    """A8's probe on the card, 3 interleaved rounds at 64 MB a cell: the
    port's put (a pinned HostStaging slot, a copy stream, an event) one
    stream at chunks of 1-8 MB, 2 and 4 streams at once, one 64 MB put,
    the process's CPU share and a stream beside a host memcpy; the
    table (with each single-stream cell's pageable rate) and the JSON
    line printed."""
    import torch
    from dmlc_tpu_torch.bench_transfer import probe
    t0 = time.perf_counter()
    rec = probe(torch.device("cuda"), reps=3, mb=64)
    require(all(v > 0 for v in rec["cells"].values()),
            f"transfer probe: a cell without a rate: {rec}")
    log(f"transfer probe ({time.perf_counter() - t0:.1f} s):")
    log(json.dumps(rec))
    return rec


def _same_state(name, got, want):
    """Each tensor of ``got`` equals ``want``'s bit for bit."""
    import torch
    for k, w in want.items():
        g = got[k]
        require(g.shape == w.shape and g.dtype == w.dtype
                and torch.equal(g, w),
                f"checkpoint: {name}: {k} restored differs from the saved")


def checkpoint_path(path, lr, work):
    """A9 on the card, linear: ``SparseLinearModel(10^6)`` trains one
    epoch of the linear corpus (the main path's Pipeline), is saved by
    ``ShardedCheckpoint.save`` and by ``save_pytree``, and restored by
    each into a fresh model on the card (``restore(like=...)`` /
    ``load_pytree(like=...)``, then ``load_state_dict``): bit for bit the
    saved state. Then the same 3 batches take 3 steps on the model never
    interrupted and on each restored one; they agree within the step
    tolerance (K2's atomics). K1, K2, K8 and K9 must launch in the
    epoch and the resume steps."""
    import torch
    from dmlc_tpu_torch.io.checkpoint import (
        ShardedCheckpoint, load_pytree, save_pytree,
    )
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    cuda = torch.device("cuda")
    wrappers = {k: fn for k, fn in _wrappers().items()
                if k in PATH_KERNELS["linear"]}
    for fn in wrappers.values():
        fn.launches = 0
    built = build_pipeline(path)
    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    secs, losses, steps, _ = train_epoch(built, model, train=True)
    it = iter(built)
    resume = [next(it) for _ in range(3)]
    it.close()
    built.close()
    root = os.path.join(work, "ckpt")
    ck = ShardedCheckpoint(root)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(steps, model.state_dict(), metadata={"epoch": 1})
    save_s = time.perf_counter() - t0
    pytree = os.path.join(work, "linear.pytree")
    save_pytree(model.state_dict(), pytree)
    restored = {}
    for name in ("sharded", "pytree"):
        fresh = SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                                  device=cuda)
        t0 = time.perf_counter()
        if name == "sharded":
            state, user = ck.restore(like=fresh.state_dict())
            require(ck.latest_step() == steps and user == {"epoch": 1},
                    f"checkpoint: latest step {ck.latest_step()}, user "
                    f"{user}")
        else:
            state = load_pytree(pytree, like=fresh.state_dict())
        fresh.load_state_dict(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(all(v.device.type == "cuda" for v in state.values()),
                f"checkpoint: {name} restored leaves off the card")
        _same_state(name, fresh.state_dict(), model.state_dict())
        restored[name] = (fresh, restore_s)
    runs = {"uninterrupted": model}
    runs.update({k: m for k, (m, _) in restored.items()})
    after = {}
    for name, m in runs.items():
        ls = [m.train_step(b) for b in resume]
        after[name] = (torch.stack(ls).cpu(), m.w.detach().cpu(),
                       m.b.detach().cpu())
    base = after["uninterrupted"]
    for name in restored:
        for label, a, b in zip(("losses", "w", "b"), after[name], base):
            require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                    f"checkpoint: 3 steps after the {name} restore vs the "
                    f"uninterrupted model: {label} max |err| "
                    f"{(a - b).abs().max().item()}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    require(all(launches[k] >= steps + 9 for k in PATH_KERNELS["linear"]),
            f"checkpoint: launches {launches}, want each of "
            f"{PATH_KERNELS['linear']} at least {steps} + 9")
    nbytes = sum(v.numel() * v.element_size()
                 for v in model.state_dict().values())
    log(f"checkpoint path: SparseLinearModel(10^6) trained {steps} steps "
        f"(loss {losses[0]:.4f} -> {losses[-1]:.4f}), saved at step "
        f"{steps} ({nbytes} bytes) in {save_s:.4f} s "
        f"({nbytes / save_s / 1e9:.3f} GB/s); restored bit for bit by "
        f"ShardedCheckpoint in {restored['sharded'][1]:.4f} s "
        f"({ck.last_restore_bytes_read} bytes read) and by load_pytree in "
        f"{restored['pytree'][1]:.4f} s; 3 steps after each restore match "
        f"the uninterrupted model's (losses "
        f"{[round(float(x), 6) for x in base[0]]}, rtol {STEP_RTOL}, atol "
        f"{STEP_ATOL}); launches {launches}")
    shutil.rmtree(root)
    os.unlink(pytree)
    return {"steps": steps, "bytes": nbytes, "save_s": save_s,
            "restore_s": restored["sharded"][1],
            "pytree_restore_s": restored["pytree"][1],
            "launches": launches}


def checkpoint_ffm(path, lr, work):
    """A9 on the card, FFM: ``SparseFFMModel(10^6, 39, K=4)`` (628 MB of
    V) saved by ``ShardedCheckpoint`` and restored into a fresh model on
    the card, bit for bit; one step on the first libfm batch, on the
    saved model and on the restored one, agrees within the step
    tolerance (K6 forward and backward, K8 and K9 launch in it). Save
    and restore GB/s are printed, restore's over
    ``last_restore_bytes_read``. Then the same state through the
    object-store plane (remote_ffm)."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
    wrappers = {k: fn for k, fn in _wrappers().items()
                if k in PATH_KERNELS["ffm"]}
    for fn in wrappers.values():
        fn.launches = 0
    batch = first_batch(path, "libfm")
    cuda = torch.device("cuda")
    batch = {k: torch.from_numpy(np.asarray(v)).to(cuda)
             for k, v in batch.items()}
    model = make_factor_model("ffm", lr)
    root = os.path.join(work, "ckpt_ffm")
    ck = ShardedCheckpoint(root)
    nbytes = sum(v.numel() * v.element_size()
                 for v in model.state_dict().values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(1, model.state_dict())
    save_s = time.perf_counter() - t0
    fresh = make_factor_model("ffm", lr)
    with torch.no_grad():
        fresh.V.zero_()
    t0 = time.perf_counter()
    state, _ = ck.restore(like=fresh.state_dict())
    fresh.load_state_dict(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del state
    _same_state("ffm", fresh.state_dict(), model.state_dict())
    out = {}
    for name, m in (("saved", model), ("restored", fresh)):
        loss = m.train_step(batch)
        out[name] = (loss.reshape(1).cpu(), m.V.detach()[:4096].cpu(),
                     m.w.detach().cpu())
    for label, a, b in zip(("loss", "V", "w"), out["restored"],
                           out["saved"]):
        require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                f"checkpoint: the FFM step after the restore: {label} max "
                f"|err| {(a - b).abs().max().item()}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    require(all(launches[k] >= 2 for k in ("ffm_pair_fwd", "ffm_pair_bwd",
                                           "logistic_step", "sgd_update")),
            f"checkpoint: FFM resume step launches {launches}")
    read = ck.last_restore_bytes_read
    log(f"checkpoint FFM: SparseFFMModel(10^6, 39, K=4), {nbytes} bytes of "
        f"parameters: save {save_s:.4f} s ({nbytes / save_s / 1e9:.3f} "
        f"GB/s), restore to the card {restore_s:.4f} s ({read} bytes read, "
        f"{read / restore_s / 1e9:.3f} GB/s), bit for bit; one step on each "
        f"agrees (loss {float(out['saved'][0][0]):.6f}); launches "
        f"{launches}")
    shutil.rmtree(root)
    del fresh
    remote = remote_ffm(model, lr, work, nbytes, save_s, read / restore_s)
    return {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "restore_bytes_read": read, "launches": launches,
            "remote": remote}


def remote_ffm(model, lr, work, nbytes, local_save_s, local_restore_bps):
    """The FFM's state through the object-store plane: saved to
    ``obj://smoke/ckpt_ffm`` on the run's emulator (REMOTE_* wire; the
    628 MB V page goes up through the multipart writer, 8 MB parts, 4 at
    once), restored to a fresh model on the card from the page store
    the save filled, then cold (a fresh page store: every page over the
    wire), bit for bit each time. Save and restore GB/s printed beside
    the local plane's."""
    import torch
    import dmlc_tpu_torch.io.objstore as objstore
    from dmlc_tpu_torch.io import pagestore
    from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
    objroot = os.path.join(work, "objroot")
    em = objstore.configure(root=objroot, latency_s=REMOTE_LATENCY_S,
                            bandwidth_gbps=REMOTE_GBPS)
    part_bytes = objstore.options()["put_part_bytes"]
    env = os.environ.get(pagestore.ENV_STORE_DIR)
    try:
        ck = ShardedCheckpoint("obj://smoke/ckpt_ffm")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, model.state_dict())
        save_s = time.perf_counter() - t0
        counts = em.counters()
        require(counts["put_parts"] >= nbytes // part_bytes
                and ck.last_save_bytes_written >= nbytes,
                f"remote FFM save: {counts}, "
                f"{ck.last_save_bytes_written} bytes written")
        runs = {}
        for tier in ("local", "wire"):
            if tier == "wire":
                # a cold process: a page store that holds no page
                os.environ[pagestore.ENV_STORE_DIR] = os.path.join(
                    work, "pages_cold")
            fresh = make_factor_model("ffm", lr)
            with torch.no_grad():
                fresh.V.zero_()
            t0 = time.perf_counter()
            state, _ = ck.restore(like=fresh.state_dict())
            fresh.load_state_dict(state)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            del state
            _same_state(f"ffm obj:// ({tier})", fresh.state_dict(),
                        model.state_dict())
            split = (ck.last_restore_local_bytes,
                     ck.last_restore_wire_bytes)
            want = ((ck.last_restore_bytes_read, 0) if tier == "local"
                    else (0, ck.last_restore_bytes_read))
            require(split == want and ck.last_restore_bytes_read
                    >= nbytes, f"remote FFM restore ({tier}): local, wire "
                    f"bytes {split}, want {want}")
            runs[tier] = {"restore_s": secs, "gbps":
                          ck.last_restore_bytes_read / secs / 1e9}
            del fresh
    finally:
        if env is None:
            os.environ.pop(pagestore.ENV_STORE_DIR, None)
        else:
            os.environ[pagestore.ENV_STORE_DIR] = env
        objstore.configure(None)
        shutil.rmtree(os.path.join(objroot, "smoke", "ckpt_ffm"),
                      ignore_errors=True)
        shutil.rmtree(os.path.join(work, "pages_cold"), ignore_errors=True)
    log(f"checkpoint FFM over obj://: save {save_s:.4f} s "
        f"({nbytes / save_s / 1e9:.3f} GB/s; local "
        f"{nbytes / local_save_s / 1e9:.3f}), {counts['put_parts']} parts "
        f"of {part_bytes} bytes; restore to the card from the page store "
        f"{runs['local']['restore_s']:.4f} s "
        f"({runs['local']['gbps']:.3f} GB/s), cold over the wire "
        f"{runs['wire']['restore_s']:.4f} s ({runs['wire']['gbps']:.3f} "
        f"GB/s; local plane {local_restore_bps / 1e9:.3f}), bit for bit")
    return {"save_s": save_s, "save_gbps": nbytes / save_s / 1e9,
            "put_parts": counts["put_parts"], "restore": runs}


# --------------------------------------------------------------- phase 11

def write_recordio_corpora(work):
    """Configs 3, 14 and 18's corpora (RECORDIO_MB each), written by the
    bench suite's makers at the names the suite reads (so bench_twins
    writes none of its own). Returns {"recordio": [4 part paths],
    "dense", "image"}."""
    from dmlc_tpu_torch import bench_suite
    prefix = os.path.join(work, "dmlc_tpu_torch_bench_suite")
    paths, secs = {}, {}
    t0 = time.perf_counter()
    paths["recordio"] = bench_suite.make_recordio(f"{prefix}.imagenet",
                                                  RECORDIO_MB, nparts=4)
    secs["recordio"] = time.perf_counter() - t0
    paths["dense"] = f"{prefix}.dense.rec"
    t0 = time.perf_counter()
    bench_suite.make_dense_recordio(paths["dense"], RECORDIO_MB, seed=11)
    secs["dense"] = time.perf_counter() - t0
    paths["image"] = f"{prefix}.images.rec"
    t0 = time.perf_counter()
    bench_suite.make_image_recordio(paths["image"], RECORDIO_MB, seed=18,
                                    shape=IMAGE_SHAPE)
    secs["image"] = time.perf_counter() - t0
    sizes = {k: sum(map(os.path.getsize, v)) if isinstance(v, list)
             else os.path.getsize(v) for k, v in paths.items()}
    log("RecordIO corpora: " + ", ".join(
        f"{k} {sizes[k]} bytes in {secs[k]:.1f} s" for k in paths))
    return paths


# The checksum of cuda_ingest: a byte's weight cycles with its position
# modulo this prime, so a reordered, lost or repeated chunk shows.
CHECK_MOD = 65521


def _host_checksum(path):
    """(bytes, sum b, sum b * (position mod CHECK_MOD + 1)) of a file,
    by numpy on the host."""
    import numpy as np
    n = s1 = s2 = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(16 << 20)
            if not buf:
                return n, s1, s2
            x = np.frombuffer(buf, np.uint8).astype(np.int64)
            pos = np.arange(n, n + x.size, dtype=np.int64) % CHECK_MOD + 1
            s1 += int(x.sum())
            s2 += int((x * pos).sum())
            n += x.size


def _card_checksum(chunks):
    """_host_checksum of the uint8 tensors that ``chunks`` yields in
    turn, summed on their device (read once, at the end)."""
    import torch
    n, s1, s2 = 0, 0, 0
    for c in chunks:
        x = c.to(torch.int64)
        pos = torch.arange(n, n + x.numel(), device=c.device) % CHECK_MOD + 1
        s1 = s1 + x.sum()
        s2 = s2 + (x * pos).sum()
        n += x.numel()
    return n, int(s1), int(s2)


def cuda_ingest(path, parts):
    """A10's ``cuda://`` on the card. ``device_chunks`` over ``path`` (the
    256 MB linear corpus) through ``create_stream("cuda://...")`` at
    INGEST_CHUNKS, each chunk a uint8 tensor on the card: their checksum,
    computed on the card, must equal numpy's over the file; then GB/s of
    each (the file over a second pass's wall, ended by a synchronize,
    each chunk dropped as it comes), beside the same reads alone into a
    pinned buffer. Then
    ``recordio_device_batches`` over each of config 3's 4 parts
    (``parts``, as cuda:// URIs): each record read back from the card
    must hash (sha256) as the host reader's (``NativeRecordIOReader``)
    record does; then GB/s of record bytes a part (a second pass, each
    batch dropped as it comes), beside the reader's own pass over the
    part (no copy).
    The native engine must serve it (no fall to the Python split).
    Returns the rates, and config 3's coverage hash of the host's
    records."""
    import hashlib
    import torch
    from dmlc_tpu_torch.io.cuda_fs import (
        CUDASeekStream, recordio_device_batches,
    )
    from dmlc_tpu_torch.io.stream import create_stream
    from dmlc_tpu_torch.native import native_available
    from dmlc_tpu_torch.native.bindings import NativeRecordIOReader
    from dmlc_tpu_torch.utils.memory import thread_local_pool
    require(native_available(), "cuda_ingest: the native engine is not "
            "available: recordio_device_batches would take the Python split")
    want = _host_checksum(path)
    size = want[0]
    chunk_gbps = {}
    for chunk in INGEST_CHUNKS:
        def chunks():
            with create_stream(f"cuda://{path}", "r") as s:
                require(isinstance(s, CUDASeekStream),
                        f"cuda:// opened a {type(s).__name__}")
                for c in s.device_chunks(chunk):
                    require(c.is_cuda and c.dtype == torch.uint8,
                            "device_chunks gave a chunk off the card or "
                            "not uint8")
                    yield c

        # the bytes, in an untimed pass (which also fills the thread's
        # pinned pool and the allocator's cache at this size)
        card = _card_checksum(chunks())
        require(card == want, f"device_chunks at {chunk} bytes: the card's "
                f"checksum {card} != the file's {want}")
        # the rate, with a consumer that drops each chunk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in chunks():
            pass
        torch.cuda.synchronize()
        chunk_gbps[chunk >> 20] = size / (time.perf_counter() - t0) / 1e9
    # the host's part alone: the same in-place reads into one pinned
    # buffer of the pool, no copy to the card
    read_gbps = {}
    for chunk in INGEST_CHUNKS:
        buf = memoryview(thread_local_pool(pin=True).acquire(chunk))[:chunk]
        with create_stream(path, "r") as s:
            t0 = time.perf_counter()
            while s.readinto(buf):
                pass
            read_gbps[chunk >> 20] = size / (time.perf_counter() - t0) / 1e9
    log(f"cuda_ingest: device_chunks over {size} bytes, the card's checksum "
        f"equal to the file's at each chunk; GB/s by chunk MB "
        + ", ".join(f"{k} MB {v:.3f}" for k, v in chunk_gbps.items())
        + "; the reads alone into a pinned buffer "
        + ", ".join(f"{k} MB {v:.3f}" for k, v in read_gbps.items()))
    uri = ";".join(f"cuda://{p}" for p in parts)
    coverage = hashlib.sha256()  # config 3's: sha256 of records' sha256
    per_part = []
    for k in range(len(parts)):
        r = NativeRecordIOReader(uri, k, len(parts))
        want_part = [hashlib.sha256(rec).digest() for rec in r.records()]
        # the host's part alone: the reader's batches, no copy
        r.before_first()
        t0 = time.perf_counter()
        while r.next_batch() is not None:
            pass
        read_secs = time.perf_counter() - t0
        r.destroy()
        # the records, in an untimed pass
        got_part, nbatches = [], 0
        for b in recordio_device_batches(uri, k, len(parts)):
            require(all(t.is_cuda for t in b.values()),
                    "recordio_device_batches gave a batch off the card")
            payload = b["payload"].cpu().numpy()
            for s, e in zip(b["starts"].tolist(), b["ends"].tolist()):
                got_part.append(hashlib.sha256(payload[s:e]).digest())
            nbatches += 1
        require(got_part == want_part,
                f"cuda_ingest part {k}: {len(got_part)} records on the card, "
                f"{len(want_part)} from the host reader, or a record differs")
        for d in want_part:
            coverage.update(d)
        # the rate, with a consumer that drops each batch
        nbytes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in recordio_device_batches(uri, k, len(parts)):
            nbytes += b["payload"].numel()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        per_part.append({"records": len(got_part), "batches": nbatches,
                         "bytes": nbytes, "gbps": nbytes / secs / 1e9,
                         "reader_gbps": nbytes / read_secs / 1e9})
    log(f"cuda_ingest: recordio_device_batches, {len(parts)} parts of config "
        f"3's corpus, each record on the card equal to the host reader's "
        f"(sha256): " + "; ".join(
            f"part {k} {p['records']} records in {p['batches']} batches, "
            f"{p['gbps']:.3f} GB/s (the reader alone {p['reader_gbps']:.3f})"
            for k, p in enumerate(per_part)))
    return {"bytes": size, "chunk_gbps": chunk_gbps,
            "read_gbps": read_gbps, "parts": per_part,
            "records": sum(p["records"] for p in per_part),
            "records_hash": coverage.hexdigest()[:16]}


def recordio_decode(paths):
    """The dense and image record decode on the card: config 14's and
    config 18's corpora through ``Pipeline.from_uri(rec)
    .parse(format="recordio_dense" / "recordio_image", engine="native")
    .batch(8192 / 256, pad=True, nnz_bucket=8192 * 48 / 256 * 3072)
    .to_device(cuda)`` (build_pipeline): one timed epoch (the engine must
    assemble, ``native-padded``), then one in which every batch read back
    from the card hashes as the same chain's host padded batch does; the
    first image batch's ``value.view(256, 32, 32, 3)`` must hold the first
    256 records' pixels and ``label`` their labels. GB/s of each."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.io.recordio import RecordIOReader, decode_image_record
    from dmlc_tpu_torch.io.stream import create_stream
    from dmlc_tpu_torch.pipeline import Pipeline
    with create_stream(paths["image"], "r") as s:
        reader = RecordIOReader(s)
        first_images = [decode_image_record(reader.next_record())
                        for _ in range(IMAGE_ROW_BUCKET)]
    out = {}
    for fmt in ("dense", "image"):
        path = paths[fmt]
        size = os.path.getsize(path)
        file_fmt, rows, nnz_bucket, _ = LAYOUT[fmt]
        host = (Pipeline.from_uri(path).parse(format=file_fmt, engine="native")
                .batch(rows, pad=True, nnz_bucket=nnz_bucket).build())
        want = [batch_hash(b) for b in host]
        host.close()
        built = build_pipeline(path, fmt)
        secs, _, batches, moved = train_epoch(built, None, train=False)
        require(batches == len(want), f"recordio_decode {fmt}: {batches} "
                f"batches on the card, {len(want)} on the host")
        got = []
        for b in built:
            require(all(t.is_cuda for t in b.values()),
                    f"recordio_decode {fmt}: a batch off the card")
            if fmt == "image" and not got:
                px = b["value"].view(rows, *IMAGE_SHAPE)
                want_px = torch.from_numpy(np.stack(
                    [p for _, p in first_images]).astype(np.float32))
                want_label = torch.from_numpy(
                    np.float32([label for label, _ in first_images]))
                require(torch.equal(px.cpu(), want_px)
                        and torch.equal(b["label"].cpu(), want_label),
                        "recordio_decode: the first image batch's "
                        "value.view(256, 32, 32, 3) or label differs from "
                        "the records' pixels")
            got.append(batch_hash({k: v.cpu().numpy()
                                   for k, v in b.items()}))
        require(got == want, f"recordio_decode {fmt}: "
                f"{sum(a != b for a, b in zip(got, want))} of {len(want)} "
                "batches on the card differ from the host's padded batches")
        log_pipeline_stats(f"recordio_decode {fmt}", built)
        built.close()
        out[fmt] = {"bytes": size, "batches": batches,
                    "gbps": size / secs / 1e9,
                    "bytes_to_card": moved}
    log("recordio_decode: every padded batch on the card equal to the host's "
        "(sha256), native-padded, image pixels in place; " + "; ".join(
            f"{k} {v['batches']} batches, {v['gbps']:.3f} GB/s of records"
            for k, v in out.items()))
    return out


def plain_linear_model(num_features, lr):
    """SparseLinearModel on the card whose margins run the plain versions
    of K1 and K2 and whose steps the plain K8 and K9."""
    import torch
    from dmlc_tpu_torch.models.linear import SparseLinearModel

    Linear = _plain_linear()

    class Plain(_plain_steps(SparseLinearModel)):
        def _margin_terms(self, batch):
            return [Linear.apply(batch["offset"], batch["index"],
                                 batch["value"], self.w)]

    return Plain(num_features, learning_rate=lr, device=torch.device("cuda"))


def check_dense_kernels(first, path="dense"):
    """K1, K2, K8 and K9 at the first batch of a path over dense rows
    (DENSE_PATHS: "dense", 8192 rows of 24-47 values, 48 weights and the
    bias; "csv", 8192 rows of 28 values, 28 weights and the bias): each
    against its plain version on the card (K1 by its half route and K2 by
    its private route, K8 by its grid route, K9 by its narrow route, each
    read from the call's trace), then timed as check_kernels and
    check_step_kernels time them, beside its bound, its plain version and
    one PyTorch call. Returns their kernel rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dmlc_tpu_torch.ops import csr
    from dmlc_tpu_torch.ops import step as step_ops
    cuda = torch.device("cuda")
    n, feats, lr, seed = DENSE_PATHS[path]
    require(int(first["num_rows"]) == n,
            f"the {path} path's first batch has {int(first['num_rows'])} "
            "rows")
    b = {k: torch.from_numpy(np.asarray(first[k])).to(cuda)
         for k in ("offset", "index", "value", "label", "weight")}
    off, idx, val = b["offset"], b["index"], b["value"]
    nnz = int(first["num_nnz"])
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(feats, device=cuda, generator=gen)
    g = torch.randn(n, device=cuda, generator=gen)
    k1_err = _check_k1(f"at the {path} batch", off, idx, val, w, "half", [])
    k2_err = _check_narrow_k2(f"at the {path} batch", off, idx, val, g,
                              feats)
    margins = csr.csr_spmv_plain(off, idx, val, w)
    t = ([margins], torch.tensor(0.1, device=cuda), b["label"], b["weight"])
    out = []
    _device_us_by_kernel(lambda: out.append(step_ops.logistic_step(*t)), 1,
                         OBJECTIVE_ROUTE_CALLS["grid"])
    k8_err = _check_objective(f"at the {path} batch", out[-1],
                              step_ops.logistic_step_plain(*t), t[3])
    params = [torch.randn(feats, device=cuda, generator=gen) * 0.1,
              torch.randn((), device=cuda, generator=gen) * 0.1]
    grads = [torch.randn_like(p) * 1e-3 for p in params]
    decay = [True, False]
    require(step_ops.sgd_route([p.numel() for p in params],
                               [(p.data_ptr(), q.data_ptr())
                                for p, q in zip(params, grads)]) == "narrow",
            f"K9 at the {path} model does not take its narrow route")
    k9_err = max(_check_sgd(f"{path} l2={l2}", params, grads, decay, 0.5,
                            l2, "narrow") for l2 in (0.0, 0.01))
    log(f"{path} kernels agree with their plain versions at the first batch "
        f"({n} rows, {nnz} nonzeros, {feats} weights): K1 half route max "
        f"|err| {k1_err[0]:.3g}, K2 private route {k2_err:.3g}, K8 grid "
        f"route g {k8_err:.3g}, K9 narrow route {k9_err:.3g}")

    # Timing, at the batch as it came from the parser.
    y01 = (b["label"] > 0).to(torch.float32)
    m = margins + t[1]
    a = torch.sparse_csr_tensor(off, idx[:nnz].to(torch.int64), val[:nnz],
                                size=(n, feats))
    try:
        at = a.t()
        at @ g
        k2_lib = lambda: at @ g  # noqa: E731
    except RuntimeError as e:
        log(f"library K2 at the {path} batch not timed: {e}")
        k2_lib = None
    turn, copies = rotating([params, grads], (feats + 1) * 8)

    def k9():
        p, q = turn()
        step_ops.sgd_update(p, q, decay, lr, 0.0)

    def k9_plain():
        p, q = turn()
        step_ops.sgd_update_plain(p, q, decay, lr, 0.0)

    def k9_lib():
        p, q = turn()
        torch._foreach_add_(p, q, alpha=-lr)

    csr_bytes = (n + 1) * 8 + nnz * (4 + 4)
    work = {
        "csr_spmv": (
            lambda: csr.csr_spmv(off, idx, val, w),
            lambda: csr.csr_spmv_plain(off, idx, val, w),
            lambda: a @ w, route_calls("csr_spmv", "half"),
            csr_bytes + feats * 4 + n * 4, 2 * nnz,
            "dmlc_tpu_torch/csrc/csr_spmv.cu", "dmlc_tpu/ops/csr.py:46",
            k1_err[0]),
        "csr_spmv_t": (
            lambda: csr.csr_spmv_t(off, idx, val, g, feats),
            lambda: csr.csr_spmv_t_plain(off, idx, val, g, feats),
            k2_lib, route_calls("csr_spmv_t", "private"),
            csr_bytes + n * 4 + feats * 4, 2 * nnz,
            "dmlc_tpu_torch/csrc/csr_spmv.cu",
            "dmlc_tpu/models/common.py:89", k2_err),
        "logistic_step": (
            lambda: step_ops.logistic_step(*t),
            lambda: step_ops.logistic_step_plain(*t),
            lambda: F.binary_cross_entropy_with_logits(
                m, y01, t[3], reduction="sum"),
            {"logistic_step_kernel": 1}, n * 16 + 4 + 3 * 4,
            n * K8_OPS_PER_ROW, "dmlc_tpu_torch/csrc/step.cu",
            "dmlc_tpu/models/common.py:28", k8_err),
        "sgd_update": (
            k9, k9_plain, k9_lib, route_calls("sgd_update", "narrow"),
            (feats + 1) * 12, (feats + 1) * 2,
            "dmlc_tpu_torch/csrc/step.cu", "dmlc_tpu/models/common.py:91",
            k9_err),
    }
    rows = []
    for name, (kernel, plain, lib, calls, nbytes, ops, source, replaces,
               err) in work.items():
        bound, by = bound_ms(nbytes, ops)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err,
            "ms": device_ms(kernel, calls=calls),
            "plain_ms": device_ms(plain), "bound_ms": bound, "bound_by": by,
            "library_ms": device_ms(lib) if lib else None,
            "call_ms": call_ms(kernel), "path": path})
    log(f"{path} kernels timed at the first batch (K9 rotating over {copies} "
        "copies of p and g); library calls: torch.sparse CSR @ w, its "
        "transpose @ g, F.binary_cross_entropy_with_logits(reduction='sum'), "
        "torch._foreach_add_")
    return rows


def dense_train(path, lr, fmt="dense"):
    """The linear model trained on the card from a file of dense rows
    (DENSE_PATHS: a dense ``.rec``, the HIGGS-shaped csv or the Parquet
    table): ``SparseLinearModel(48)`` (or 28) through ``fmt``'s chain of
    build_pipeline (native parse or decode → the engine's padded batches
    → pinned async H2D), ``train_step`` a batch, for one epoch. First one step on the first
    batch through the kernels and one through their plain versions on the
    card agree (STEP_RTOL, STEP_ATOL); then the epoch: K1, K2, K8 and K9
    each launch once a step (the counters), the loss falls; then one epoch
    of a fresh model through the plain versions (no kernel launching) ends
    at the same weights (DENSE_EPOCH_RTOL, DENSE_EPOCH_ATOL). GB/s (the
    file over the epoch's wall) and steps/s."""
    import torch
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    cuda = torch.device("cuda")
    size = os.path.getsize(path)
    features = DENSE_PATHS[fmt][1]
    wrappers = {k: fn for k, fn in _wrappers().items()
                if k in PATH_KERNELS["linear"] + ("logistic_sums",
                                                   "logistic_grad")}
    built = build_pipeline(path, fmt)
    it = iter(built)
    batch = next(it)
    it.close()
    kernels = SparseLinearModel(features, learning_rate=lr, device=cuda)
    plain = plain_linear_model(features, lr)
    got = (kernels.train_step(batch).reshape(1), kernels.w.detach(),
           kernels.b.detach().reshape(1))
    want = (plain.train_step(batch).reshape(1), plain.w.detach(),
            plain.b.detach().reshape(1))
    for what, x, y in zip(("loss", "w", "b"), got, want):
        require(torch.allclose(x, y, rtol=STEP_RTOL, atol=STEP_ATOL),
                f"{fmt}_train: the first step through the kernels vs the "
                f"plain versions: {what} max |err| "
                f"{(x - y).abs().max().item()}")

    model = SparseLinearModel(features, learning_rate=lr, device=cuda)
    for fn in wrappers.values():
        fn.launches = 0
    secs, losses, steps, _ = train_epoch(built, model, train=True)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    want_launches = {k: steps if k in PATH_KERNELS["linear"] else 0
                     for k in launches}
    require(steps > 0 and launches == want_launches,
            f"{fmt}_train: launches {launches} != {want_launches}: the "
            "epoch did not go through K1, K2, K8 and K9 once a step")
    tail = sum(losses[-10:]) / len(losses[-10:])
    require(all(x == x and abs(x) != float("inf") for x in losses)
            and tail < losses[0],
            f"{fmt}_train: the loss did not fall: first {losses[0]}, mean "
            f"of the last 10 {tail}")
    reference = plain_linear_model(features, lr)
    _, plain_losses, plain_steps, _ = train_epoch(built, reference,
                                                  train=True)
    built.close()
    require(plain_steps == steps and all(
        fn.launches == launches[k] for k, fn in wrappers.items()),
        f"{fmt}_train: the plain epoch launched a kernel or took other "
        "steps")
    w_err = (model.w - reference.w).detach().abs().max().item()
    for what, x, y in (("w", model.w.detach(), reference.w.detach()),
                       ("b", model.b.detach(), reference.b.detach())):
        require(torch.allclose(x, y, rtol=DENSE_EPOCH_RTOL,
                               atol=DENSE_EPOCH_ATOL),
                f"{fmt}_train: after the epoch, {what} through the kernels "
                f"vs the plain versions: max |err| "
                f"{(x - y).abs().max().item()}")
    stats = {"bytes": size, "steps": steps, "epoch_s": secs,
             "gbps": size / secs / 1e9, "steps_per_s": steps / secs,
             "loss_first": losses[0], "loss_last10": tail, "w_err": w_err,
             "plain_loss_last": plain_losses[-1]}
    log(f"{fmt}_train: SparseLinearModel({features}) at learning rate "
        f"{lr}, {steps} steps over {size} bytes of {fmt}: "
        f"{stats['gbps']:.3f} GB/s, {stats['steps_per_s']:.2f} steps/s; loss "
        f"{losses[0]:.4f} -> {tail:.4f} (mean of the last 10); the first "
        f"step equal to the plain versions' (rtol {STEP_RTOL}, atol "
        f"{STEP_ATOL}); after the epoch w max |err| {w_err:.3g} against the "
        f"plain versions' epoch (rtol {DENSE_EPOCH_RTOL}, atol "
        f"{DENSE_EPOCH_ATOL}); launches {launches}")
    return launches, stats


# --------------------------------------------------------------- phase 10b

def write_format_corpora(work):
    """The format path's corpora but the dense csv (written with the run's
    first corpora, for its kernel checks): the sparse csv (SPARSE_CSV_MB,
    CSV_ZERO_FRAC of the cells exactly 0), config 5's table (PARQUET_MB in
    PARQUET_GROUPS row groups) and config 17's (DECODE_MB, row groups of
    DECODE_GROUP_ROWS) through write_parquet, and config 6's indexed
    RecordIO (INDEXED_MB, ``make_indexed_recordio``) at the name the bench
    suite reads, so config 6 writes none. Returns ({name: path}, {name:
    (columns, nulls)} of the two tables)."""
    from dmlc_tpu_torch import bench_suite
    paths = {"csv_sparse": os.path.join(work, "higgs_sparse.csv"),
             "parquet": os.path.join(work, "higgs.parquet"),
             "decode": os.path.join(work, "decode.parquet"),
             "indexed": os.path.join(
                 work, "dmlc_tpu_torch_bench_suite.imagenet.indexed.rec")}
    secs, tables = {}, {}
    t0 = time.perf_counter()
    write_higgs_csv(paths["csv_sparse"], SPARSE_CSV_MB, SEED + 2,
                    CSV_ZERO_FRAC)
    secs["csv_sparse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cols = higgs_table(PARQUET_MB, SEED + 5)
    rows = len(cols["label"])
    write_parquet(paths["parquet"], cols, rows // PARQUET_GROUPS)
    tables["parquet"] = (cols, {})
    secs["parquet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables["decode"] = decode_table(DECODE_MB, SEED + 17)
    write_parquet(paths["decode"], tables["decode"][0], DECODE_GROUP_ROWS,
                  tables["decode"][1])
    secs["decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench_suite.make_indexed_recordio(paths["indexed"], INDEXED_MB)
    secs["indexed"] = time.perf_counter() - t0
    log("format corpora: " + ", ".join(
        f"{k} {os.path.getsize(p)} bytes in {secs[k]:.1f} s"
        for k, p in paths.items()))
    return paths, tables


def _padded_hashes(parser, fmt):
    """The sha256 of each padded batch of ``parser``'s epoch in ``fmt``'s
    layout; the parser is destroyed after."""
    hashes = [batch_hash(b) for b in padded_batches(parser, fmt)]
    parser.destroy()
    return hashes


def csv_parity(path, fmt):
    """The csv's native padded batches (``fmt``: "csv" or "csv_sparse")
    against ``pad_single`` over the Python CSVParser's rows, byte for byte,
    for the first CSV_PARITY_BATCHES batches; then the whole file's padded
    stream through ``shards=2`` (the gang) equal, batch by batch, to the
    one-parser stream. Returns the batches of the epoch."""
    import numpy as np
    from dmlc_tpu_torch.data.csv_parser import CSVParser
    from dmlc_tpu_torch.data.padding import pad_single
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    from dmlc_tpu_torch.native import bindings
    kw = PARSE_KW[fmt]
    golden = Parser.create(path, 0, 1, format="csv", engine="python",
                           prefetch=False, chunk_size=4 << 20, **kw)
    require(isinstance(golden, CSVParser),
            f"engine='python' gave {type(golden).__name__}")
    want = CSV_PARITY_BATCHES * CSV_ROW_BUCKET
    cont = RowBlockContainer(np.uint32)
    for block in golden:
        cont.push_block(block)
        if cont.size >= want:
            break
    rows = cont.get_block()
    native = Parser.create(path, 0, 1, format="csv", engine="native", **kw)
    require(isinstance(native, bindings.NativeCSVParser),
            f"engine='native' gave {type(native).__name__}")
    one = _padded_hashes(native, fmt)
    for i in range(CSV_PARITY_BATCHES):
        gold = pad_single(rows.slice(i * CSV_ROW_BUCKET,
                                     (i + 1) * CSV_ROW_BUCKET),
                          CSV_ROW_BUCKET, CSV_NNZ_BUCKET)
        require(one[i] == batch_hash(gold),
                f"csv_parity {fmt}: native padded batch {i} differs from "
                "pad_single over the Python CSVParser")
    sharded = Parser.create(path, 0, 1, format="csv", engine="native",
                            shards=2, **kw)
    require(isinstance(sharded, bindings.NativeShardedTextParser),
            f"shards=2 gave {type(sharded).__name__}")
    two = _padded_hashes(sharded, fmt)
    require(two == one, f"csv_parity {fmt}: the shards=2 stream "
            f"({len(two)} batches) differs from the one-parser stream "
            f"({len(one)})")
    log(f"csv_parity {fmt}: the first {CSV_PARITY_BATCHES} native padded "
        "batches byte-identical to pad_single over the Python CSVParser; "
        f"the shards=2 stream's {len(two)} batches equal the one-parser "
        "stream's")
    return len(one)


def _block_bits(block, columns, nulls, pos):
    """Whether ``block`` (rows from ``pos``) holds the table's label and
    feature columns bit for bit, NaN (0x7fc00000, the engine's and
    numpy's) at the nulls, in the dense layout."""
    import numpy as np
    n = block.size
    feats = [c for c in columns if c != "label"]
    want = np.stack([columns[c][pos:pos + n] for c in feats], axis=1)
    for j, c in enumerate(feats):
        if c in nulls:
            want[nulls[c][pos:pos + n], j] = np.float32("nan")
    return (np.array_equal(np.asarray(block.offset),
                           np.arange(n + 1) * len(feats))
            and np.array_equal(np.asarray(block.index),
                               np.tile(np.arange(len(feats)), n))
            and np.array_equal(np.asarray(block.label).view(np.uint32),
                               columns["label"][pos:pos + n].view(np.uint32))
            and np.array_equal(np.asarray(block.value).view(np.uint32),
                               want.reshape(-1).view(np.uint32)))


def parquet_decode(path, table, shards=(1, 2, 4)):
    """The Parquet file through ``format="parquet_native"``,
    ``engine="native"``, ``label_column="label"``, two epochs of blocks at
    each of ``shards``: in the first every block bit for bit the columns
    write_parquet wrote (_block_bits), every row once; the second timed,
    the blocks only counted; ``outstanding() == 0`` after each epoch.
    Returns GB/s (the file over the timed epoch's wall) by shards."""
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.native import bindings
    columns, nulls = table
    size = os.path.getsize(path)
    rows = len(columns["label"])
    gbps = {}
    for n in shards:
        kw = {"shards": n} if n > 1 else {}
        parser = Parser.create(path, 0, 1, format="parquet_native",
                               engine="native", label_column="label", **kw)
        require(isinstance(parser, (bindings.NativeParquetParser,
                                    bindings.NativeShardedTextParser)),
                f"engine='native' gave {type(parser).__name__}")
        pos, bad = 0, []
        for block in parser:
            if not _block_bits(block, columns, nulls, pos):
                bad.append(pos)
            pos += block.size
        leases = [parser.outstanding()]
        timed = 0
        t0 = time.perf_counter()
        for block in parser:
            timed += block.size
        secs = time.perf_counter() - t0
        leases.append(parser.outstanding())
        parser.destroy()
        require(not bad and pos == rows == timed,
                f"parquet_decode {os.path.basename(path)} shards={n}: "
                f"{pos} and {timed} rows of {rows}, blocks from rows "
                f"{bad[:5]} differ from the columns written")
        require(leases == [0, 0], f"parquet_decode shards={n}: {leases} "
                "leases outstanding after the epochs")
        gbps[n] = size / secs / 1e9
    log(f"parquet_decode {os.path.basename(path)}: {rows} rows, every block "
        "bit for bit the columns written (NaN at the nulls), outstanding() "
        "0 after each epoch; GB/s by shards " + ", ".join(
            f"{n}: {g:.3f}" for n, g in gbps.items()))
    return gbps


def _records_digest(digests):
    """Config 6's digest of records whose sha256 digests are ``digests``,
    in order: the sha256 over them, 16 hex."""
    return hashlib.sha256(b"".join(digests)).hexdigest()[:16]


def indexed_leg(path):
    """Config 6's access pattern on the host: the indexed RecordIO through
    ``IndexedRecordIOSplit(shuffle=True, seed=11, batch_size=64)`` and
    ``NativeIndexedRecordIOReader`` with the same arguments, the same
    records in the same order (config 6's digest); seeds 11 and 12 give
    two orders, each the unshuffled records as a multiset. GB/s of each
    epoch's reads (the digests outside the timed reads)."""
    from dmlc_tpu_torch.io.indexed_recordio_split import IndexedRecordIOSplit
    from dmlc_tpu_torch.native.bindings import NativeIndexedRecordIOReader
    size = os.path.getsize(path)
    plain = IndexedRecordIOSplit(path, 0, 1)
    multiset = sorted(hashlib.sha256(r).digest()
                      for r in iter(plain.next_record, None))
    kw = {"shuffle": True, "batch_size": INDEXED_BATCH}
    split = IndexedRecordIOSplit(path, 0, 1, seed=INDEXED_SEEDS[0], **kw)
    t0 = time.perf_counter()
    py = list(iter(split.next_record, None))
    py_s = time.perf_counter() - t0
    py_hash = _records_digest([hashlib.sha256(r).digest() for r in py])
    orders, native_s = {}, {}
    for seed in INDEXED_SEEDS:
        reader = NativeIndexedRecordIOReader(path, 0, 1, seed=seed, **kw)
        held = []
        t0 = time.perf_counter()
        while True:
            batch = reader.next_batch()
            if batch is None:
                break
            held.append((batch, reader.detach()))
        native_s[seed] = time.perf_counter() - t0
        recs = []
        for (data, starts, ends), lease in held:
            view = memoryview(data)
            recs += [view[int(a):int(b)] for a, b in zip(starts, ends)]
        orders[seed] = [hashlib.sha256(r).digest() for r in recs]
        digest = _records_digest(orders[seed])
        for _, lease in held:
            lease.release()
        reader.destroy()
        if seed == INDEXED_SEEDS[0]:
            require(len(recs) == len(py) and digest == py_hash,
                    f"indexed_leg: the native reader's {len(recs)} records "
                    f"({digest}) are not the split's {len(py)} ({py_hash})")
        require(sorted(orders[seed]) == multiset,
                f"indexed_leg: seed {seed}'s records are not the file's")
    a, b = (orders[s] for s in INDEXED_SEEDS)
    require(a != b, f"indexed_leg: seeds {INDEXED_SEEDS} gave one order")
    stats = {"bytes": size, "records": len(py), "hash": py_hash,
             "python_gbps": size / py_s / 1e9,
             "native_gbps": size / native_s[INDEXED_SEEDS[0]] / 1e9}
    log(f"indexed_leg: {len(py)} records ({size} bytes), the native "
        f"reader's order and content the split's (digest {py_hash}); seeds "
        f"{INDEXED_SEEDS} two orders of the same records; "
        f"python {stats['python_gbps']:.3f} GB/s, native "
        f"{stats['native_gbps']:.3f} GB/s")
    return stats


def format_path(csv, work):
    """The format matrix on the card and the host (phase 10b): the
    HIGGS-shaped csv (dense, and sparse in csv_parity) held to the Python
    CSVParser and its gang, ``SparseLinearModel(28)`` trained one epoch
    from it (dense_train: K1, K2, K8 and K9 once a step, the loss
    falling, one step and the epoch equal to the plain versions'), a
    parse-only epoch of each csv beside it; config 5's Parquet table
    decoded bit for bit at 1, 2 and 4 shards and trained on the same way;
    config 17's table (nulls) decoded bit for bit; config 6's indexed
    RecordIO (indexed_leg). Returns (the csv epoch's launches, stats)."""
    paths, tables = write_format_corpora(work)
    out = {"csv_batches": csv_parity(csv, "csv"),
           "csv_sparse_batches": csv_parity(paths["csv_sparse"],
                                            "csv_sparse")}
    launches, out["csv_train"] = dense_train(csv, HIGGS_LEARNING_RATE, "csv")
    for name, p, fmt in (("csv", csv, "csv"),
                         ("csv_sparse", paths["csv_sparse"], "csv_sparse")):
        built = build_pipeline(p, fmt)
        secs, _, batches, _ = train_epoch(built, None, train=False)
        built.close()
        out[f"{name}_parse_gbps"] = os.path.getsize(p) / secs / 1e9
    log(f"format_path csv: training epoch {out['csv_train']['gbps']:.3f} "
        f"GB/s, {out['csv_train']['steps_per_s']:.2f} steps/s; parse-only "
        f"epochs through the Pipeline {out['csv_parse_gbps']:.3f} GB/s "
        f"(dense), {out['csv_sparse_parse_gbps']:.3f} GB/s (sparse)")
    out["parquet_gbps"] = parquet_decode(paths["parquet"], tables["parquet"])
    _, out["parquet_train"] = dense_train(paths["parquet"],
                                          HIGGS_LEARNING_RATE, "parquet")
    out["decode_gbps"] = parquet_decode(paths["decode"], tables["decode"],
                                        shards=(1,))
    out["indexed"] = indexed_leg(paths["indexed"])
    for name in ("csv_sparse", "parquet", "decode"):
        os.unlink(paths[name])
    return launches, out


# --------------------------------------------------------------- phase 12

# The chaos phase's fault plan: an ioerror at every host I/O seam the
# spill path, the page cache and the checkpoint cross, each at least once
# (the page reads on the serve thread by a seeded coin); every fault is
# retried under CHAOS_POLICY's attempts, with a backoff short enough not
# to show in an epoch.
CHAOS_PLAN = ";".join([
    "site=io.filesys.list,fault=ioerror,times=1",
    "site=io.filesys.stat,fault=ioerror,nth=2",
    "site=spill.commit,fault=ioerror,times=2",
    "site=data.pages.build,fault=ioerror,times=1",
    "site=data.pages.commit,fault=ioerror,times=1",
    "site=io.stream.open,fault=ioerror,nth=3",
    "site=io.stream.read,fault=ioerror,p=0.002",
    "site=checkpoint.save,fault=ioerror,times=1",
    "site=checkpoint.restore,fault=ioerror,times=1"])
CHAOS_SITES = ("io.filesys.list", "io.filesys.stat", "spill.commit",
               "data.pages.build", "data.pages.commit", "io.stream.open",
               "io.stream.read", "checkpoint.save", "checkpoint.restore")
CHAOS_SEED = 17
CHAOS_ATTEMPTS = 6
# a page read of the stall epoch sleeps STALL_DELAY_S, past the
# watchdog's threshold; the watchdog polls every STALL_POLL_S
STALL_DELAY_S, STALL_THRESHOLD_S, STALL_POLL_S = 3.0, 1.0, 0.25
STALL_NTH_READ = 200
# the gang: rank 1 hard-crashes at its third batch, before its first
# restart only
GANG_FAULTS = "site=gang.block,fault=crash,nth=3,rank=1,attempt=0"
# config 10 under --chaos: page reads, the spill's commit and a stat
BENCH_CHAOS_PLAN = ("site=io.stream.read,fault=ioerror,p=0.002;"
                    "site=spill.commit,fault=ioerror,times=1;"
                    "site=io.filesys.stat,fault=ioerror,times=1")
BENCH_CHAOS_SITES = ("io.stream.read", "spill.commit", "io.filesys.stat")
WATCHDOG_EPOCHS = ("off", "on", "on", "off")


def _chaos_policy():
    """Every site retries CHAOS_ATTEMPTS times, 1-10 ms apart."""
    from dmlc_tpu_torch.resilience import RetryPolicy, set_policy
    set_policy("*", RetryPolicy(max_attempts=CHAOS_ATTEMPTS,
                                base_delay_s=0.001, max_delay_s=0.01))


def _retry_delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def chaos_spill_run(uri, lr, mesh, work, tag, plan_spec=None):
    """The spill linear path (``spill_path``'s chain over ``uri``, a
    directory holding the corpus, SPILL_EPOCHS epochs: parse, parse and
    spill, pages), one epoch of ``Pipeline...cache(path=...)`` (a
    DiskRowIter page cache built and replayed), then the trained model
    saved by ``ShardedCheckpoint`` and ``save_pytree`` and restored by
    each into a fresh model on the card. With ``plan_spec`` the fault
    plan is armed (seed CHAOS_SEED) before the pipeline is built and
    disarmed after the restores, which must be bit for bit. Returns each
    epoch's batch hashes, launches, tier, seconds and retries, the
    run's faults and retries, and the final w and b on the host."""
    import torch
    from dmlc_tpu_torch.io.checkpoint import (
        ShardedCheckpoint, load_pytree, save_pytree,
    )
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    from dmlc_tpu_torch.obs.metrics import REGISTRY
    from dmlc_tpu_torch.pipeline import Pipeline
    from dmlc_tpu_torch.resilience import inject, retry_counts
    cuda = torch.device("cuda")
    root = os.path.join(work, f"chaos_{tag}")
    os.makedirs(root)
    wrappers = {k: fn for k, fn in _wrappers().items()
                if k in PATH_KERNELS["linear"] + ("logistic_sums",
                                                  "logistic_grad")}
    injected0 = REGISTRY.counter("resilience.fault.injected").value
    retries0 = retry_counts()
    plan = (inject.install(plan_spec, seed=CHAOS_SEED)
            if plan_spec is not None else None)
    try:
        built = (Pipeline.from_uri(uri)
                 .parse(format="libsvm", engine="native")
                 .shard(mesh, row_bucket=ROW_BUCKET, nnz_bucket=NNZ_BUCKET,
                        agreement_cache_bytes=1 << 20,
                        first_epoch_cache="never",
                        spill_dir=os.path.join(root, "spill"))
                 .build(autotune=True))
        model = SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                                  device=mesh.device)
        step = model.make_sharded_train_step(mesh)
        epochs = []
        for _ in range(SPILL_EPOCHS):
            for fn in wrappers.values():
                fn.launches = 0
            before = retry_counts()
            kept, losses = [], []
            t0 = time.perf_counter()
            for batch in built:
                kept.append(batch)
                losses.append(step(batch))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            shard = built.stats()["stages"][0]["extra"]
            epochs.append({"secs": secs, "steps": len(kept),
                           "losses": [float(x) for x in losses],
                           "launches": {k: fn.launches
                                        for k, fn in wrappers.items()},
                           "hashes": _hashes(kept),
                           "tier": shard["replay_tier"],
                           "retries": _retry_delta(retry_counts(), before)})
            del kept
        built.close()
        cached = (Pipeline.from_uri(uri)
                  .parse(format="libsvm", engine="native")
                  .cache(path=os.path.join(root, "cache.pages"),
                         memory_budget_bytes=0)
                  .batch(ROW_BUCKET, pad=True, nnz_bucket=NNZ_BUCKET)
                  .to_device(cuda, window="auto")
                  .build(autotune=True))
        for fn in wrappers.values():
            fn.launches = 0
        kept, cache_losses = [], []
        t0 = time.perf_counter()
        for batch in cached:
            kept.append(batch)
            cache_losses.append(model.train_step(batch))
        torch.cuda.synchronize()
        cache_s = time.perf_counter() - t0
        stages = {s["kind"]: s["extra"] for s in cached.stats()["stages"]}
        cache_epoch = {"secs": cache_s, "steps": len(kept),
                       "hashes": _hashes(kept),
                       "losses": [float(x) for x in cache_losses],
                       "tier": stages["cache"]["replay_tier"],
                       "launches": {k: fn.launches
                                    for k, fn in wrappers.items()}}
        del kept
        cached.close()
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        ck = ShardedCheckpoint(os.path.join(root, "ckpt"))
        ck.save(1, model.state_dict(), metadata={"tag": tag})
        pytree = os.path.join(root, "linear.pytree")
        save_pytree(model.state_dict(), pytree)
        for name in ("sharded", "pytree"):
            fresh = SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                                      device=cuda)
            if name == "sharded":
                got, user = ck.restore(like=fresh.state_dict())
                require(user == {"tag": tag},
                        f"chaos {tag}: restored metadata {user}")
            else:
                got = load_pytree(pytree, like=fresh.state_dict())
            fresh.load_state_dict(got)
            _same_state(f"chaos {tag} {name}", fresh.state_dict(), state)
    finally:
        if plan is not None:
            inject.uninstall()
    injected = REGISTRY.counter("resilience.fault.injected").value - injected0
    return {"epochs": epochs, "cache": cache_epoch,
            "w": model.w.detach().cpu(), "b": model.b.detach().cpu(),
            "plan": plan, "injected": injected,
            "retries": _retry_delta(retry_counts(), retries0)}


def _check_chaos_run(tag, run, want_steps):
    """One chaos_spill_run's own checks: the tiers, the launch counts
    (K1 and K2 once a part a step, K8's two launches and K9 once a step
    on the mesh; K1, K2, K8 and K9 once a step in the cache epoch), every
    epoch's batches equal to its epoch 1's and the loss falling (the
    run itself held both restores bit for bit)."""
    epochs = run["epochs"]
    tiers = [e["tier"] for e in epochs]
    require(tiers == SPILL_TIERS,
            f"chaos {tag}: the epochs were served by {tiers}, want "
            f"{SPILL_TIERS}")
    steps = epochs[0]["steps"]
    require(want_steps is None or steps == want_steps,
            f"chaos {tag}: {steps} steps an epoch, want {want_steps}")
    want = {"csr_spmv": SHARD_PARTS * steps,
            "csr_spmv_t": SHARD_PARTS * steps, "logistic_step": 0,
            "logistic_sums": steps, "logistic_grad": steps,
            "sgd_update": steps}
    for i, e in enumerate(epochs):
        require(e["steps"] == steps and e["launches"] == want,
                f"chaos {tag}: epoch {i + 1} ({e['tier']}) took {e['steps']}"
                f" steps with launches {e['launches']}; want {want}")
        require(e["hashes"] == epochs[0]["hashes"],
                f"chaos {tag}: epoch {i + 1}'s batches differ from epoch 1's")
    c = run["cache"]
    csteps = c["steps"]
    cwant = {k: csteps if k in PATH_KERNELS["linear"] else 0
             for k in want}
    require(c["tier"] == "pages" and c["launches"] == cwant,
            f"chaos {tag}: the cache epoch was served by {c['tier']} with "
            f"launches {c['launches']}, want pages and {cwant}")
    losses = [x for e in epochs for x in e["losses"]] + c["losses"]
    require(all(x == x and abs(x) != float("inf") for x in losses)
            and losses[-1] < losses[0],
            f"chaos {tag}: losses {losses[0]} -> {losses[-1]}")
    return steps


def stall_epoch(uri, lr, mesh, work):
    """One page epoch of the spill path with a ``fault=delay`` clause of
    STALL_DELAY_S on the STALL_NTH_READ-th stream read (a page read on
    the ``shard.serve`` thread), a ``Watchdog`` of STALL_THRESHOLD_S and
    a ``FlightRecorder`` installed for that epoch alone: exactly one
    stall report naming the blocked pull, and one bundle whose
    ``trace.json``, ``metrics.json`` and ``faults.json`` load. The
    epoch's batches must hash equal to its parse epoch's."""
    import torch
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    from dmlc_tpu_torch.obs import flight
    from dmlc_tpu_torch.obs.watchdog import Watchdog
    from dmlc_tpu_torch.pipeline import Pipeline
    from dmlc_tpu_torch.resilience import inject
    root = os.path.join(work, "chaos_stall")
    built = (Pipeline.from_uri(uri)
             .parse(format="libsvm", engine="native")
             .shard(mesh, row_bucket=ROW_BUCKET, nnz_bucket=NNZ_BUCKET,
                    agreement_cache_bytes=1 << 20, first_epoch_cache="never",
                    spill_dir=os.path.join(root, "spill"))
             .build(autotune=True))
    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                              device=mesh.device)
    step = model.make_sharded_train_step(mesh)
    hashes = []
    for _ in range(3):  # parse, parse and spill, pages
        kept = [b for b in built]
        for b in kept:
            step(b)
        hashes.append(_hashes(kept))
        del kept
    tier = built.stats()["stages"][0]["extra"]["replay_tier"]
    require(tier == "pages", f"stall: the third epoch was served by {tier}")
    out_dir = os.path.join(root, "flight")
    plan = inject.install(f"site=io.stream.read,fault=delay,"
                          f"delay_s={STALL_DELAY_S},nth={STALL_NTH_READ}")
    recorder = flight.install(out_dir=out_dir)
    wd = Watchdog(threshold_s=STALL_THRESHOLD_S, interval_s=STALL_POLL_S)
    try:
        with wd:
            kept = []
            t0 = time.perf_counter()
            for b in built:
                kept.append(b)
                step(b)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        flight.uninstall()
        inject.uninstall()
    tier = built.stats()["stages"][0]["extra"]["replay_tier"]
    built.close()
    require(tier == "pages" and _hashes(kept) == hashes[0],
            f"stall: the delayed epoch ({tier}) differs from the parse "
            "epoch's batches")
    del kept
    require(plan.injected == 1 and plan.events()[0]["fault"] == "delay",
            f"stall: the plan injected {plan.events()}")
    require(len(wd.reports) == 1,
            f"stall: {len(wd.reports)} stall reports, want one")
    blocked = [b["name"] for b in wd.reports[0]["blocked"]]
    require(any(n.startswith("pull/") for n in blocked),
            f"stall: the report names {blocked}, no blocked pull")
    bundles = [d for d in os.listdir(out_dir) if d.startswith("flight-")]
    require(len(bundles) == 1 and recorder.dumped,
            f"stall: flight bundles {bundles}")
    d = os.path.join(out_dir, bundles[0])
    docs = {}
    for name in ("trace.json", "metrics.json", "faults.json",
                 "MANIFEST.json", "watchdog.json"):
        with open(os.path.join(d, name)) as f:
            docs[name] = json.load(f)
    events = docs["trace.json"]["traceEvents"]
    require(events and all(all(k in e for k in ("ph", "ts", "pid", "tid",
                                                 "name")) for e in events),
            "stall: the bundle's trace.json lacks Chrome keys")
    require(docs["MANIFEST.json"]["reason"] == "watchdog_stall"
            and docs["faults.json"]["injected"] == 1
            and docs["faults.json"]["events"][0]["site"] == "io.stream.read"
            and "counters" in docs["metrics.json"]["current"],
            f"stall: the bundle's manifest {docs['MANIFEST.json']}, faults "
            f"{docs['faults.json']}")
    report = wd.reports[0]
    log(f"chaos stall: a page read delayed {STALL_DELAY_S} s (the "
        f"{STALL_NTH_READ}th read of the epoch) under a watchdog of "
        f"{STALL_THRESHOLD_S} s: one stall report naming {blocked} (blocked "
        f"{[b['blocked_s'] for b in report['blocked']]} s when reported); "
        f"one flight bundle ({sorted(os.listdir(d))}, {len(events)} trace "
        f"events); the epoch {secs:.3f} s, its batches equal to the parse "
        "epoch's")
    return {"epoch_s": secs, "blocked": blocked,
            "bundle_files": sorted(os.listdir(d))}


GANG_WORKER = r'''
import hashlib, json, os, sys, time
t_start = time.time()
import numpy as np
import torch
from dmlc_tpu_torch.resilience import inject
inject.install_if_env()
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.ops import csr
from dmlc_tpu_torch.ops import step as step_ops
uri, out_dir, rows, nnz_bucket, features, lr = sys.argv[1:7]
rank = int(os.environ["DMLC_TPU_TASK_ID"])
nparts = int(os.environ["DMLC_TPU_NUM_WORKER"])
cuda = torch.device("cuda")
wrappers = {"csr_spmv": csr.csr_spmv, "csr_spmv_t": csr.csr_spmv_t,
            "logistic_step": step_ops.logistic_step,
            "sgd_update": step_ops.sgd_update}
for fn in wrappers.values():
    fn.launches = 0
model = SparseLinearModel(int(features), learning_rate=float(lr),
                          device=cuda)
parser = Parser.create(uri, rank, nparts, format="libsvm", engine="native")
h = hashlib.sha256()
count, losses = 0, []
while True:
    batch = parser.next_padded(int(rows), nnz_bucket=int(nnz_bucket))
    if batch is None:
        break
    inject.fire("gang.block")      # the armed mid-epoch crash site
    batch = batch.copy()
    bh = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(batch[k])
        bh.update(k.encode() + a.dtype.str.encode())
        bh.update(a.tobytes())
    h.update(bh.hexdigest().encode())
    losses.append(model.train_step(
        {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}))
    count += 1
torch.cuda.synchronize()
parser.destroy()
np.save(os.path.join(out_dir, f"w-{rank}.npy"), model.w.detach().cpu().numpy())
np.save(os.path.join(out_dir, f"b-{rank}.npy"), model.b.detach().cpu().numpy())
out = {"count": count, "sha256": h.hexdigest(),
       "launches": {k: fn.launches for k, fn in wrappers.items()},
       "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
       "attempt": int(os.environ["DMLC_TPU_ATTEMPT"]),
       "wall_s": time.time() - t_start}
tmp = os.path.join(out_dir, f"out-{rank}.tmp")
with open(tmp, "w") as f:
    json.dump(out, f)
os.replace(tmp, os.path.join(out_dir, f"out-{rank}.json"))
'''


def chaos_gang(path, work, lr):
    """A fault-free gang of 2 workers, then the same gang with rank 1
    crashing (``os._exit``) at its third batch and restarted by the
    supervisor (``RestartPolicy(max_restarts=2, backoff_base_s=0.05)``):
    exit codes [0, 0], one restart in the ``resilience.restart`` counter
    and on ``trace-gang.json``, each rank's batch count and hash equal to
    the fault-free gang's, its weights within the step tolerance, K1,
    K2, K8 and K9 once a step in every worker. The workers form no
    ``torch.distributed`` group."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.obs.metrics import REGISTRY
    from dmlc_tpu_torch.resilience import RestartPolicy
    script = os.path.join(work, "gang_worker.py")
    with open(script, "w") as f:
        f.write(GANG_WORKER)

    def run(name, **kw):
        out_dir = os.path.join(work, name)
        os.makedirs(out_dir)
        outs, secs = _gang(
            script, [path, out_dir, str(ROW_BUCKET), str(NNZ_BUCKET),
                     str(NUM_FEATURES), str(lr)], out_dir, "out", **kw)
        weights = [tuple(np.load(os.path.join(out_dir, f"{k}-{r}.npy"))
                         for k in ("w", "b")) for r in range(GANG_RANKS)]
        return outs, weights, secs

    clean, clean_w, clean_s = run("gang_clean")
    trace_dir = os.path.join(work, "gang_trace")
    before = REGISTRY.counter("resilience.restart").value
    chaos, chaos_w, chaos_s = run(
        "gang_chaos", faults=GANG_FAULTS, trace_dir=trace_dir,
        restart_policy=RestartPolicy(max_restarts=2, backoff_base_s=0.05))
    restarts = REGISTRY.counter("resilience.restart").value - before
    require(restarts == 1,
            f"gang: the crashed gang exited [0, 0] after {restarts} "
            "restarts; want one")
    with open(os.path.join(trace_dir, "trace-gang.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    require(names.count("gang/restart/worker-1") == 1
            and any(n and n.startswith("gang/spawn/") for n in names),
            "gang: trace-gang.json lacks one gang/restart/worker-1 or a "
            "gang/spawn event")
    require(chaos[1]["attempt"] == 1 and chaos[0]["attempt"] == 0,
            f"gang: attempts {[chaos[r]['attempt'] for r in range(2)]}")
    for r in range(2):
        require((chaos[r]["count"], chaos[r]["sha256"])
                == (clean[r]["count"], clean[r]["sha256"]),
                f"gang: rank {r}'s batches after the crash differ from the "
                f"fault-free gang's: {chaos[r]} vs {clean[r]}")
        for out in (clean[r], chaos[r]):
            steps = out["count"]
            require(steps > 3 and out["launches"]
                    == {k: steps for k in PATH_KERNELS["linear"]},
                    f"gang: rank {r} took {steps} steps with launches "
                    f"{out['launches']}")
            require(out["loss_last"] < out["loss_first"],
                    f"gang: rank {r}'s loss {out['loss_first']} -> "
                    f"{out['loss_last']}")
        for what, a, b in zip(("w", "b"), chaos_w[r], clean_w[r]):
            a, b = torch.from_numpy(a), torch.from_numpy(b)
            require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                    f"gang: rank {r}'s {what} after the crash vs the "
                    f"fault-free gang's: max |err| "
                    f"{(a - b).abs().max().item()}")
    # spawn-to-exit times of each member, from the supervisor's track
    spans = {}
    for e in events:
        n = e.get("name") or ""
        if n.startswith(("gang/spawn/", "gang/exit/")):
            kind, member = n.split("/")[1:3]
            spans.setdefault(member, []).append((e["ts"], kind))
    lives = {}
    for member, evs in spans.items():
        evs.sort()
        starts = [t for t, k in evs if k == "spawn"]
        end = max(t for t, _ in evs)
        lives[member] = [round((end - s) / 1e6, 3) for s in starts]
    log(f"chaos gang: 2 workers, each its half of the corpus "
        f"(Parser.create(uri, rank, 2), native) into its own "
        f"SparseLinearModel(10^6) on the card; fault-free gang "
        f"{clean_s:.2f} s, crashed gang {chaos_s:.2f} s (rank 1 crashed "
        f"at its third batch, exit 77, restarted once: attempt 1); ranks' "
        f"batches {[chaos[r]['count'] for r in range(2)]}, hashes and "
        f"counts equal to the fault-free gang's, weights within rtol "
        f"{STEP_RTOL}, atol {STEP_ATOL}; launches {chaos[0]['launches']} "
        f"and {chaos[1]['launches']}; spawn-to-exit seconds by member "
        f"(the restarted member's from each spawn) {lives}; worker wall "
        f"seconds, fault-free {[round(clean[r]['wall_s'], 2) for r in range(2)]},"
        f" crashed {[round(chaos[r]['wall_s'], 2) for r in range(2)]}")
    return {"clean_s": clean_s, "chaos_s": chaos_s, "restarts": restarts,
            "lives_s": lives, "counts": [chaos[r]["count"] for r in range(2)]}


def chaos_bench(path, work):
    """Config 10 (``spill_replay``) through ``bench_suite.main(["--config",
    "10", "--chaos", BENCH_CHAOS_PLAN])`` over the linear corpus (linked
    to the name the suite reads, in a temporary directory the suite is
    pointed at): its JSON has no ``error``, injected faults and retries
    at each armed site."""
    import contextlib
    import io
    from dmlc_tpu_torch import bench_suite
    from dmlc_tpu_torch.resilience import inject
    d = os.path.join(work, "chaos_bench")
    os.makedirs(d)
    os.link(path, os.path.join(d, "dmlc_tpu_torch_bench_suite.criteo.libsvm"))
    saved, tempfile.tempdir = tempfile.tempdir, d
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            bench_suite.main(["--config", "10", "--mb", "256",
                              "--chaos", BENCH_CHAOS_PLAN])
    finally:
        tempfile.tempdir = saved
        inject.uninstall()
        shutil.rmtree(d)
    secs = time.perf_counter() - t0
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    require(len(lines) == 1, f"chaos bench: {len(lines)} JSON lines")
    rec = lines[0]
    require("error" not in rec, f"chaos bench: config 10 failed: {rec}")
    chaos = rec.get("chaos") or {}
    require(chaos.get("injected", 0) > 0
            and all(chaos["retries"].get(s, 0) > 0
                    for s in BENCH_CHAOS_SITES),
            f"chaos bench: faults and retries {chaos}")
    log(f"chaos bench config 10 under --chaos ({secs:.1f} s):")
    log(json.dumps(rec))
    return rec


def watchdog_parse_epochs(path):
    """Parse-only epochs of the main path's chain with no watchdog and
    with one installed (threshold 30 s: it reports nothing), in turns
    (WATCHDOG_EPOCHS); GB/s of each."""
    from dmlc_tpu_torch.obs.watchdog import Watchdog
    built = build_pipeline(path)
    size = os.path.getsize(path)
    train_epoch(built, None, train=False)  # untimed: first allocations
    gbps = []
    for mode in WATCHDOG_EPOCHS:
        wd = Watchdog(threshold_s=30.0).start() if mode == "on" else None
        try:
            secs, _, batches, _ = train_epoch(built, None, train=False)
        finally:
            if wd is not None:
                wd.stop()
        if wd is not None:
            require(wd.reports == [], f"watchdog: a report on a parse "
                    f"epoch: {wd.reports}")
        gbps.append(size / secs / 1e9)
    built.close()
    log("parse-only epochs, watchdog " + ", ".join(WATCHDOG_EPOCHS) + ": "
        + " / ".join(f"{x:.3f}" for x in gbps) + " GB/s")
    return dict(zip(("off1", "on1", "on2", "off2"), gbps))


def chaos_path(path, size, lr, mesh, work, spill):
    """The resilience plane on the card (see the module docstring, 12).
    ``spill``: spill_path's stats of this run (its page epochs, with no
    plan armed, are printed beside PR 16's)."""
    import torch
    from dmlc_tpu_torch.resilience import reset_policies
    src = os.path.join(work, "chaos_src")
    os.makedirs(src)
    os.link(path, os.path.join(src, os.path.basename(path)))
    _chaos_policy()
    try:
        clean = chaos_spill_run(src, lr, mesh, work, "clean")
        steps = _check_chaos_run("clean", clean, None)
        chaos = chaos_spill_run(src, lr, mesh, work, "chaos", CHAOS_PLAN)
        _check_chaos_run("chaos", chaos, steps)
        plan = chaos["plan"]
        require(clean["injected"] == 0 and clean["retries"] == {},
                f"chaos: the fault-free run injected {clean['injected']} and "
                f"retried {clean['retries']}")
        missing = [s for s in CHAOS_SITES if chaos["retries"].get(s, 0) < 1]
        require(not missing, f"chaos: no retry at {missing}: "
                f"{chaos['retries']}")
        require(plan.injected == len(plan.events()) == chaos["injected"]
                == sum(chaos["retries"].values()),
                f"chaos: {plan.injected} injected, {len(plan.events())} in "
                f"the plan's log, {chaos['injected']} counted, "
                f"{sum(chaos['retries'].values())} retries")
        page_reads = sum(e["retries"].get("io.stream.read", 0)
                         for e in chaos["epochs"] if e["tier"] == "pages")
        require(page_reads > 0, "chaos: no page read of a page epoch (the "
                "shard.serve thread) was retried")
        for i, (a, b) in enumerate(zip(chaos["epochs"], clean["epochs"])):
            require(a["hashes"] == b["hashes"],
                    f"chaos: epoch {i + 1}'s batches differ from the "
                    "fault-free run's")
        require(chaos["cache"]["hashes"] == clean["cache"]["hashes"],
                "chaos: the cache epoch's batches differ from the "
                "fault-free run's")
        for what in ("w", "b"):
            a, b = chaos[what], clean[what]
            require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                    f"chaos: the final {what} vs the fault-free run's: max "
                    f"|err| {(a - b).abs().max().item()}")
        by_site = {}
        for ev in plan.events():
            by_site[ev["site"]] = by_site.get(ev["site"], 0) + 1
        gb = lambda run: [size / e["secs"] / 1e9  # noqa: E731
                          for e in run["epochs"]]
        fmt = lambda xs: " / ".join(f"{x:.3f}" for x in xs)  # noqa: E731
        w_err = (chaos["w"] - clean["w"]).abs().max().item()
        log(f"chaos spill: {SHARD_PARTS} parts of {ROW_BUCKET} rows over a "
            f"directory holding the corpus, {steps} steps an epoch, tiers "
            f"{SPILL_TIERS}, a cache epoch of {chaos['cache']['steps']} "
            f"steps, then ShardedCheckpoint and save_pytree saved and "
            f"restored bit for bit; plan {CHAOS_PLAN} (seed {CHAOS_SEED}), "
            f"{CHAOS_ATTEMPTS} attempts a site: faults injected by site "
            f"{by_site}, retries by site {chaos['retries']} ({page_reads} of "
            f"them page reads of the page epochs); every batch equal to the "
            f"fault-free run's, in order; final w max |err| {w_err:.3g} "
            f"(rtol {STEP_RTOL}, atol {STEP_ATOL}); launches an epoch "
            f"{chaos['epochs'][-1]['launches']}")
        log(f"chaos spill parse-to-device with training, epochs "
            + ", ".join(f"{i + 1} ({t})" for i, t in enumerate(SPILL_TIERS))
            + f": faulted {fmt(gb(chaos))} GB/s, fault-free "
            f"{fmt(gb(clean))} GB/s; cache epoch faulted "
            f"{size / chaos['cache']['secs'] / 1e9:.3f}, fault-free "
            f"{size / clean['cache']['secs'] / 1e9:.3f} GB/s")
        pages = [g for g, t in zip(spill["parse_to_device_gbps_training"],
                                   spill["tiers"]) if t == "pages"]
        log(f"page epochs with no plan armed (every page read through "
            f"guarded): spill_path {fmt(pages)} GB/s, the chaos phase's "
            f"fault-free run {fmt(gb(clean)[2:])} GB/s; PR 16's proof16 "
            "1.765 / 1.483 / 1.555 GB/s")
        stall = stall_epoch(src, lr, mesh, work)
    finally:
        reset_policies()
    gang = chaos_gang(path, work, lr)
    bench = chaos_bench(path, work)
    watch = watchdog_parse_epochs(path)
    return {"steps": steps, "injected": chaos["injected"],
            "retries": chaos["retries"],
            "faulted_gbps": [size / e["secs"] / 1e9 for e in chaos["epochs"]],
            "clean_gbps": [size / e["secs"] / 1e9 for e in clean["epochs"]],
            "stall": stall, "gang": gang,
            "bench_chaos": bench.get("chaos"), "watchdog_gbps": watch}


# --------------------------------------------------------------- main

def main() -> None:
    # Keep CUPTI set up between profiler traces. With kineto's default
    # teardown after each trace, a trace late in a run on an H100
    # (torch 2.11, CUDA 12.8) came back with no device activity, and so
    # did every later one of the process (two of four runs on one card
    # failed so); without the teardown an empty trace was followed by a
    # full one (four of four runs on the next card passed).
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    card = environment()
    sys.path.insert(0, REPO)
    import torch
    build_all()
    work = tempfile.mkdtemp(prefix="dmlc_chip_smoke_")
    # the port's default page-store root (Pipeline.cache's derived page
    # files) under the run's directory, so the rmtree below removes it
    os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(work, "pages")
    try:
        path = os.path.join(work, "criteo_shaped.libsvm")
        t0 = time.perf_counter()
        size = write_corpus(path)
        log(f"corpus: {size} bytes in {time.perf_counter() - t0:.1f} s")
        train = os.path.join(work, "dense_train.rec")
        t0 = time.perf_counter()
        train_size = write_dense_corpus(train)
        log(f"dense training corpus: {train_size} bytes in "
            f"{time.perf_counter() - t0:.1f} s")
        csv = os.path.join(work, "higgs.csv")
        t0 = time.perf_counter()
        csv_size = write_higgs_csv(csv, CSV_MB, SEED + 1)
        log(f"HIGGS-shaped csv: {csv_size} bytes in "
            f"{time.perf_counter() - t0:.1f} s")
        first = first_batch(path)
        rows = check_kernels(first) + check_step_kernels(first)
        # the dense path's kernels here, among the run's first traces: a
        # trace taken long after the one before it (in one run, after the
        # RecordIO corpora's writes) came back with no device activity
        dense_rows = check_dense_kernels(first_batch(train, "dense"))
        csv_rows = check_dense_kernels(first_batch(csv, "csv"), "csv")
        launches, stats = main_path(path, size, LEARNING_RATE, first)
        sharded_rows = [r for r in rows
                        if r["name"] in ("logistic_sums", "logistic_grad")]
        narrow_rows = [r for r in rows if r.get("path") == "ranking"]
        report_kernels([r for r in rows
                        if r not in sharded_rows + narrow_rows], launches,
                       stats["steps"])
        # the trace plane and the split planes over the same corpus,
        # early: profiler traces lose records late in a run
        stats["trace"] = trace_path(path, size, LEARNING_RATE, work)
        stats["split"] = split_path(path, size, LEARNING_RATE, work)
        stats["h2d_gbps"] = h2d_gbps(first)
        log(f"H2D from pinned slots: {stats['h2d_gbps']:.2f} GB/s "
            f"({stats['h2d_bytes_per_batch']} bytes per batch)")
        stats["transfer"] = transfer_probe()
        parity(path, LEARNING_RATE)
        mesh = init_nccl()
        stats["sharded"] = sharded_path(path, size, LEARNING_RATE, mesh,
                                        stats)
        report_kernels(sharded_rows, stats["sharded"]["launches"],
                       stats["sharded"]["steps"])
        stats["spill"] = spill_path(path, size, LEARNING_RATE, mesh, work,
                                    stats["sharded"])
        stats["cache"] = cache_path(path, size, LEARNING_RATE, stats)
        stats["checkpoint"] = checkpoint_path(path, LEARNING_RATE, work)
        linear, linear_size = path, size

        # the factor models' path: libfm → FM and FFM
        path = os.path.join(work, "criteo_shaped.libfm")
        t0 = time.perf_counter()
        size = write_libfm_corpus(path)
        log(f"libfm corpus: {size} bytes in {time.perf_counter() - t0:.1f} s")
        factor_rows = check_factor_kernels(first_batch(path, "libfm"))
        check_factor_shapes()
        for kind in ("fm", "ffm"):
            launches, stats[kind] = factor_path(path, size, kind,
                                                LEARNING_RATE)
            report_kernels([r for r in factor_rows
                            if r["name"] in PATH_KERNELS[kind]],
                           launches, stats[kind]["steps"])
        libfm_parity(path, LEARNING_RATE)
        stats["checkpoint_ffm"] = checkpoint_ffm(path, LEARNING_RATE, work)
        sharded_parity(path, "libfm", ("fm", "ffm"), mesh, LEARNING_RATE)
        rows += factor_rows
        os.unlink(path)

        # the ranking path: libsvm with qid → SparseRankingModel
        path = os.path.join(work, "mslr_shaped.libsvm")
        t0 = time.perf_counter()
        size = write_ranking_corpus(path)
        log(f"ranking corpus: {size} bytes in {time.perf_counter() - t0:.1f} "
            "s")
        rank_rows = check_ranking_kernels(first_batch(path, "ranking"))
        launches, stats["ranking"] = ranking_path(path, size,
                                                  RANK_LEARNING_RATE)
        report_kernels(rank_rows + narrow_rows, launches,
                       stats["ranking"]["steps"])
        ranking_parity(path, RANK_LEARNING_RATE)
        sharded_parity(path, "ranking", ("ranking",), mesh,
                       RANK_LEARNING_RATE)
        rows += rank_rows
        sharded_dryrun(mesh)

        # the RecordIO paths: cuda:// ingest, the dense and image decode,
        # the linear model trained from dense records
        corpora = write_recordio_corpora(work)
        stats["cuda_ingest"] = cuda_ingest(linear, corpora["recordio"])
        stats["recordio_decode"] = recordio_decode(corpora)
        launches, stats["dense_train"] = dense_train(train,
                                                     DENSE_LEARNING_RATE)
        report_kernels(dense_rows, launches, stats["dense_train"]["steps"])
        rows += dense_rows
        os.unlink(train)
        # the format matrix: csv, Parquet and indexed RecordIO
        launches, stats["format"] = format_path(csv, work)
        report_kernels(csv_rows, launches,
                       stats["format"]["csv_train"]["steps"])
        rows += csv_rows
        os.unlink(csv)
        # the bench configs last, after every traced phase: in a run with
        # them before the factor path (config 7's two worker processes on
        # the card among them), the factor kernels' profiler traces came
        # back with no device activity
        stats["bench"] = bench_twins(linear, work,
                                     stats["cuda_ingest"]["records_hash"],
                                     stats["format"]["indexed"]["hash"])
        # the object-store plane: config 11, the linear model trained
        # from obj:// and its remote checkpoint
        _, stats["remote"] = remote_path(linear, LEARNING_RATE, work)
        # the gang plane: a peer-hydrated training gang and a fanout
        # restore gang, two CUDA processes each on this card
        stats["gang"] = gang_path(linear, LEARNING_RATE, work)
        # the global shuffle plane: a training gang on one seeded global
        # order, windows exchanged between the two CUDA processes' stores
        stats["shuffle"] = shuffle_path(linear, LEARNING_RATE, work)
        # the resilience plane last: its gang's worker processes and its
        # chaos-armed bench config come after every traced phase
        stats["chaos"] = chaos_path(linear, linear_size, LEARNING_RATE,
                                    mesh, work, stats["spill"])
        os.unlink(linear)
        from dmlc_tpu_torch.parallel.launch import finalize
        finalize()
    finally:
        shutil.rmtree(work, ignore_errors=True)
        import torch.distributed as dist
        if dist.is_initialized():  # a failed phase: no barrier
            dist.destroy_process_group()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("main path: " + json.dumps(stats))
    log(card)
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
