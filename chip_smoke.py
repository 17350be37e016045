#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each
printing one line or a few:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the four CUDA kernels from ``csrc/``, one ``nvcc`` call a
   source, all started together, then one link (bf16 K1, K2, K3 on
   Hopper's tensor cores at head dims 32, 64 and 128:
   ``flash_fwd_sm90.cu``, ``flash_bwd_dq_sm90.cu``, ``flash_bwd_sm90.cu``;
   float32 K1-K3 on the FP32 cores at 16, 32, 64 and 128: ``flash_fwd.cu``,
   ``flash_bwd.cu``; K4 ``normalize.cu``);
3. kernels: the registers and spills of each kernel (``ptxas -v``); K1
   (forward), K2 (dq) and K3 (dk/dv) against their plain PyTorch twins run
   in float32 on the same values, at the training shape (8, 8, 2048, 64)
   bf16 causal and at edge shapes in bf16 and in float32 (ragged L=300,
   non-causal 300 x 170, GQA 8->2, segment ids with a fully masked row,
   window 128), at a tensor-parallel rank's 4 heads of 8 (4, 4, 2048, 64)
   bf16, and the float32 head-dim-16 build at the dry run's chunk pair
   (2, 2, 32, 16), causal, non-causal and GQA 2->1. Float32 outputs:
   atol = rtol = 1e-4. bf16 o, dq, dk and dv
   come from the tensor-core kernels, which round p (K1), ds (K2), or p and
   ds (K3) to bf16 before the second product: within half a bf16 ulp of
   the twin + 2^-8 B + 1e-5 (1 + |ref|) (``kernels.flash_gate_limit``, B
   what that rounding can move the output); and on non-negative q, k, v
   and do with delta = 0 (so p, ds and every term of o, dq, dk and dv are
   non-negative), the mean signed error within +-0.1 of the mean 2^-8 B
   (``kernels.BIAS_LIMIT``: rounding to nearest has no bias; truncation
   has). K4 (image normalisation) against its
   twin bit for bit, over every uint8 value in every channel (mean 0 / std 1
   in bf16, ImageNet mean/std in bf16 and in float32), at the image line's
   batch shape (64, 224, 224, 3) and on a misaligned input with a tail;
4. reference: the full-width LM's loss and gradients on a small input,
   flash kernels against the plain blockwise attention; the full-width image
   CNN's loss on 8 images of 224 x 224 with K4 and with the twin's
   normalisation, bit for bit;
5. LM main path: a Parquet token store written with ``materialize_dataset``,
   read through ``make_reader`` (NGram) -> ``TorchDataLoader`` ->
   ``prefetch_to_device``, and AdamW steps of the flagship transformer LM
   (vocab 32000, d_model 512, 8 heads, 4 layers, d_ff 2048, L 2048, bf16,
   ``attention='flash'``), with each kernel's launch count over those steps
   and each step's goodput split (the loader's monitor, the step fenced on
   a CUDA event) beside the consumer's own (batch wait, dispatch, fence);
   the reader reads one epoch, its batches hold no ``'_provenance'`` (NGram
   windows span rows), and its coverage audit is complete;
6. image main path: a png ``CompressedImageCodec`` store of 256 synthetic
   variable-size images (375 x 500, each side +-20%), trained on by the
   example's ``train()`` on the card: ``make_columnar_reader`` with the
   resize to 224 x 224 on 8 worker threads -> ``TorchDataLoader`` ->
   ``prefetch_to_device``, and SGD steps of the image CNN (widths
   64/128/256, 2 blocks, 16 classes, bf16, batch 64), with K4's launch
   count and the device's busy share over 2 profiled steps;
7. MNIST line: a 2048-row store read row by row through ``make_reader`` ->
   ``TorchDataLoader`` (shuffling) -> MLP SGD steps for one epoch;
8. batch line: a 60,000-row MNIST-size store (``idx``, ``digit``, and the
   28 x 28 image under ``ArrowListCodec``, about 47 row groups) read
   through ``make_batch_reader`` with ``filters`` (``idx`` < 54000: the
   last 6,000 rows held out by footer statistics and the residual
   predicate), a hash split (``in_pseudorandom_split``, 0.9) and shard 0
   of 2 -> ``TorchDataLoader`` (shuffling, batch 512, ``drop_last``) ->
   ``prefetch_to_device`` -> MLP SGD steps. The delivered ``idx`` set is
   held against one worked out with pyarrow and ``hashlib`` alone; the
   reader alone is timed over one more pass; and a small hive-partitioned
   plain store is read with a partition filter and held against
   ``pq.read_table(filters=...)``;
9. legacy store: the committed store written by original petastorm
   (``tests/data/legacy/legacy_dataset``, a pickled schema) read through
   ``make_reader``, ``make_columnar_reader`` and ``make_batch_reader`` ->
   ``TorchDataLoader`` -> ``prefetch_to_device``: 24 rows equal to the
   fixture's formula, and the stored schema (``image_png`` a png
   ``CompressedImageCodec`` of (8, 6, 3));
10. jpeg image line: the image line's 256 synthetic images in a jpeg store,
   read by ``make_columnar_reader`` with ``decode_hints={'image': {'scale':
   2}}``: without a transform each image equals ``cv2.imdecode(...,
   IMREAD_REDUCED_COLOR_2)`` of its stored bytes, bit for bit, at (ceil
   h/2, ceil w/2); the reader alone is timed with and without the hint;
   then the 224 x 224 resize -> ``TorchDataLoader`` -> ``prefetch_to_device``
   -> 4 CNN steps on K4;
11. flagship under selection, then decode: a 320-row token store read by
   ``make_reader`` with an NGram of two steps, a hash split
   (``in_pseudorandom_split`` 0.9, subset 0), ``filters`` (``step`` < 288)
   and 2 row-drop partitions, window by window -> ``TorchDataLoader`` ->
   ``prefetch_to_device`` -> 5 AdamW steps of the flagship LM on K1-K3; the
   set of window start steps of one reader pass is held against one worked
   out with pyarrow and ``hashlib`` alone. Then ``generate`` continues 8
   held-out prompts (subset 1) of 128 tokens by 64: greedy on a float32
   copy of the trained weights, its logits held against the teacher-forced
   ``forward`` (float32 K1), and sampled in bf16 (temperature 0.8, top-p
   0.9), then a short decode (23 steps) profiled for the device's busy
   share;
12. packed MoE line: 2,048 documents of log-normal length (median 384, sigma
   1, clipped to 32-2048) in a ragged ``tokens`` store, read by
   ``make_reader`` -> ``make_torch_loader`` (``pad_spec`` to 2048, a
   ``transform_fn`` that unpads and packs the 32 documents of a batch into
   rows of 2048 with ``pack_documents`` and ``packed_lm_targets``,
   ``inmemory_cache_all``) -> ``prefetch_to_device`` -> AdamW steps of the
   flagship LM with grouped-query attention (8 -> 2 kv heads) and 8 experts
   of top-2 routing (Mixtral 8x7B's routing and head ratio) on packed
   documents: K1-K3 in bf16 with GQA and segment ids at L = 2048, every
   step. Per step the loss, the aux loss, the units dropped and the goodput
   split. One pass reads the store; the second comes from the loader's
   cache (no transform call, no reader reset). Gates: every document's
   tokens once, in order, positions from 0, against the store's generator
   and a pyarrow read; the sparse MoE FFN against its dense oracle on one
   layer's input (float32, capacity factor 8, 1e-5); the packed MoE + GQA
   loss and gradients with the kernels against the plain blockwise path on
   a small input (1e-2, 5e-2): top-2 in float32 and, on the bf16 kernels,
   a router consulting every expert (top-2 routing is discontinuous, so
   bf16 rounding flips choices); the float32 greedy MoE decode against
   teacher forcing (float32 K1; logits within 2^-10 (1 + |ref|), each
   greedy token the forward's argmax or tied with it within that); a bf16
   top-p decode, timed;
13. columnar token line: 8,192 rows of ``tokens`` int32 (2049,) under
   ``NdarrayCodec`` and ``idx`` int64, in row groups of about 2 MB, read by
   ``make_columnar_reader`` (4 workers) -> ``TorchDataLoader`` (batch 8) ->
   ``iter_prefetched`` under the thread and the process pool with
   ``PETASTORM_TPU_DEVICE_DECODE`` on and off: each pass equals the
   generator bit for bit (sorted by ``idx``); under "on" the reader plans
   ``tokens`` alone (``idx`` declines), the staging hands the decode the
   uint8 ``(8, stride)`` grid on the card once a batch, and ``tokens``
   comes out int32 on the card; rows/s, bytes staged a batch and the
   decode's time (CUDA events around a call, kernel time by the
   profiler). Then 5 AdamW steps of the flagship LM from the process
   pool's batches decoded on the card through a ``device=True``
   ``TransformSpec`` that casts ``tokens`` to int64 (K1-K3 every step),
   and the png image store's reader alone, 2 epochs on 8 worker processes
   against 8 threads;
14. cache and readahead line: ``df -B1 /dev/shm``; the png image store
   (with an ``idx`` field) read by ``make_columnar_reader`` with the
   example's resize, 8 thread workers, ``io_readahead='auto'`` and
   ``cache_type='shared'`` on a fresh root, into 3 epochs of the CNN on K4
   (a reader each): epoch 1 fills one segment a row group, epochs 2 and 3
   only hit and give epoch 1's images bit for bit (by ``idx``), then a
   process-pool reader on the root adds no fill and gives them again
   (images/s, median step, the step alone, tier-0 and tier-1 bytes). The
   columnar token store: ``io_readahead`` 0, 2 and ``'auto'`` on 1 and 4
   thread workers and 2 on the process pool, device decode on, each pass
   equal to the generator (sorted by ``idx``), one worker's order that of
   readahead off, rows/s and the workers' readahead hits and misses; the
   shared cache with device decode on, then off, on one root: 2 x 33
   fills (raw grids and decoded arrays never serve each other), each
   second pass all hits, the staged raw grid from a hit; a tier 0 below
   the pass's raw grids: segments spill to disk and come back, the pass
   exact; 5 LM steps from the cached grids decoded on the card (K1-K3).
   The MNIST row line for 2 epochs and an NGram pass twice on a
   local-disk cache, equal; a shared cache under
   ``PETASTORM_TPU_SHARED_CACHE=0`` leaves no file;
15. lineage line: the indexed png store with 3 ``image`` cells overwritten
   with garbage in 2 row groups. ``on_decode_error='raise'`` raises,
   ``'skip'`` gives the 253 other rows and no record; under
   ``'quarantine'`` on 8 threads and on 8 worker processes, the resize ->
   ``TorchDataLoader`` (shuffling) -> ``prefetch_to_device`` -> CNN steps on
   K4 (batch 64): the 253 clean rows once, quarantine records naming the 3
   cells (stage ``decode``, field ``image``, path, row group, row
   offsets), a complete coverage audit, each staged row resolved through
   its ``'_provenance'`` to the (file, row group, offset) whose ``idx`` it
   holds, and ``reader.replay`` of a shuffled batch bit-equal to it; the
   step against the step alone. Then the columnar token store with
   ``PETASTORM_TPU_LINEAGE`` on and off on the thread and the process pool,
   2 passes each (device decode planned, each pass == the generator, each
   audit complete; rows/s and their on / off ratio); under
   ``'quarantine'`` device decode declines with the JAX package's reason
   and a pass decodes on the host; 5 LM steps on K1-K3 from lineage-on
   batches, and ``goodput.explain_step`` naming a source row group. The
   card's name and power limit stand beside each number;
16. times: each kernel's time at its path shape beside its bound, its plain
   twin's time, and a library call's time as a yardstick (never used by
   the port): ``scaled_dot_product_attention`` for the forward, aten's
   flash-attention backward (dq, dk and dv in one call) for K2 and K3
   together, and none for K4 (no PyTorch call computes it; ``x.to(bf16)``,
   which moves the same bytes, is printed as a yardstick of bytes);
17. observability line (run before the times): the stats, latency and
   tracing planes. The metered LM line: a token store of 8 files of 9
   rows (64 NGram windows) read by ``make_reader`` (4 threads) ->
   ``TorchDataLoader`` (batch 8) -> ``prefetch_to_device(stats=, tracer=,
   goodput=)`` -> 8 AdamW steps of the full-width flagship LM on K1-K3,
   each fenced through the goodput monitor, 2 runs under each of three
   settings: ``PETASTORM_TPU_LATENCY=0`` with no trace, the default, and
   ``trace=<file>`` + ``metrics_interval=0.5`` (Prometheus text, then JSON
   lines) + an ``slo``. A traced run holds: the Chrome trace is JSON with
   ``process_item``, ``queue_wait``, ``infeed_wait``, ``train_step``,
   ``device_stage`` and goodput ``'step'`` spans, one ``train_step`` and
   one ``'step'`` a step; ``items_out`` == the items ventilated; the
   ``train_step`` histogram holds one count a step and its p99 lies
   within ``QUANTILE_REL_ERROR_BOUND`` of the largest hold measured on the
   host clock; the ``.prom`` file parses and names
   ``petastorm_tpu_items_out``; ``reader.slo.evaluate()`` gives a verdict,
   ``infeed_diagnosis`` names a bottleneck and ``explain_step(snapshot=)``
   a chain. The metered png pass: the lineage store's 3 garbage cells
   under ``'quarantine'`` on 8 threads into CNN steps on K4,
   ``rows_quarantined`` == the audit's. The metered token line: the
   columnar token store on the process pool, traced, device decode on:
   ``payload_copies`` 0, ``bytes_moved`` > 0, ``rows_decoded_device`` ==
   rows x 1 planned column, ``bytes_shipped_raw`` == the raw bytes
   staged, worker spans with the workers' pids. The planes' cost: the LM
   steady step (median of steps 2-8 a run) and token rows/s on the
   thread pool (2 passes each, the traced passes writing JSON lines every
   0.1 s) under the three settings, each ratio to latency off beside the
   passes' spread;
18. health line (run before the times): the live health plane. The
   watched LM: the store of phase 17 read by ``make_reader`` (4 threads,
   ``stall_timeout=2.0``, ``debug_port=0``, a flight-record directory, an
   ``slo`` it meets with ``fail_healthz``) -> ``TorchDataLoader`` ->
   ``prefetch_to_device(health=reader.health, goodput=)`` -> 16 epochs,
   128 AdamW steps on K1-K3 (several stall timeouts), a client thread
   GETting ``/healthz`` every 0.1 s: replies covering the steps at half
   the poller's rate or more, every one 200 and none stalled, at least two
   watchdog ticks seen during the steps; ``/diagnostics`` names the
   ``ventilator``, ``worker-*`` and ``loader-prefetch`` entities,
   ``/metrics`` ``items_out`` equals ``reader.stats``, ``/coverage`` 16
   complete epochs, ``/goodput`` 128 steps, ``/stacks`` the staging
   thread, and
   ``/profile`` 200 (a profile over a cached calibration, never probing),
   ``/observe/snapshot`` 200 (the pod plane is on by default),
   ``/autotune`` (no controller) and ``/podmetrics`` (no peer list) 404;
   the largest age a ``staging`` beat reached. The wedged LM: the
   same with ``stall_timeout=1.0`` and a row ``TransformSpec`` that blocks
   the store's third row group on a gate file: ``/healthz`` 503 naming one
   ``worker-*`` in ``decode``, exactly one flight record (heartbeats,
   stats, a stack in the gate, latency, goodput, SLO and lineage),
   ``infeed_diagnosis(heartbeats=)`` ``stalled``, one SLO stall episode;
   the gate opened, 200 within 2 s, the 8 steps finish with a finite loss
   and the audit is complete. The wedged process pool: the store on 4
   worker interpreters with the gate, ``stall_timeout=5.0``, staged to
   the card: the verdict names a ``worker-*`` whose pid is a worker's
   (seen only through the workers' liveness frames); the gate opened,
   every window arrives and the verdict is ``healthy``. The plane's cost:
   the LM steady step under ``PETASTORM_TPU_HEALTH=0``, the default and
   the watchdog + server + poller, 10 runs each in turns (off, default,
   watched, then the reverse), each ratio to
   heartbeats off beside the off runs' spread;
19. autotune and roofline line (after phase 18; calibration and
   autotune scratch directories temporary; an ERROR record of
   ``petastorm_tpu_torch.autotune``, a failed tick or calibration, fails
   it). (a) The png store (256 images, ``idx``) through
   ``make_columnar_reader`` with the resize on ONE worker thread and
   ``autotune`` (0.5 s ticks, cooldown 1, at most 8 workers, lineage on)
   into CNN steps on K4, epoch after epoch until about 20 ticks (15 s at
   most); the results queue's bound set to 8 live before the last epoch:
   it reads back 8, the controller took a ``workers_count`` move up that
   its report graded, the pool ends on more than one worker, every epoch
   delivers each image once and audits complete, K4 runs every batch;
   images/s of each epoch, every action record and the model's error
   printed. (b) The LM store of phase 17 as NGram windows on 2 worker
   interpreters, ``autotune`` (0.5 s ticks; its first model tick
   calibrates, staging to the card from the controller's thread),
   ``debug_port=0``, ``trace=True`` and a flight-record directory, 6
   epochs into AdamW steps from ``prefetch_to_device(stats=, tracer=)``;
   from step 4 a thread calls ``resize(4)``, ``resize(1)``,
   ``set_readahead_depth(2)`` and widens the ventilation window: each
   reads back (and readahead hits rise), losses are finite, K1-K3 launch
   every step, the audit is complete; ``reader.profile(device='cuda',
   samples_per_sec=<measured windows/s>)`` is calibrated, its staging
   probe names the card ``nvidia-smi`` names at a positive rate, its
   binding stage is a ``CEILING_STAGES`` one and its fraction at most
   ``SANE_FRACTION_LIMIT`` (or it carries the drained-window warning);
   ``explain_throughput()`` gives the sentence; ``/profile`` and
   ``/autotune`` answer 200, ``/metrics`` holds the ceilings, the
   fraction, the binding stage and the controller's gauges; the flight
   record has ``roofline`` and ``autotune``; ``infeed_diagnosis(
   roofline=)`` a ``roofline`` section. (c) ``PETASTORM_TPU_AUTOTUNE=0``
   with ``autotune=True``: no controller, thread or scratch file;
   ``PETASTORM_TPU_PROFILER=0``: ``/profile`` 404 and ``profile()``
   raises JAX's ``RuntimeError``. (d) The LM steady step (2 epochs on 4
   threads) with autotune off and on (``calibrate='force'``: each run's
   first model tick probes the card while steps are in flight), 6 pairs
   in turns, both ratios beside the off runs' spread;
20. resilience line (after phase 19; every scenario armed through
   ``PETASTORM_TPU_CHAOS`` with a seed derived from ``--seed`` and
   printed). (a) The LM store of phase 17 on 4 threads with
   ``io_readahead=2`` -> ``TorchDataLoader`` -> ``prefetch_to_device`` ->
   16 AdamW steps on K1-K3, under ``transient-errors``, under
   ``truncated-reads`` and clean: every window equals the clean run's bit
   for bit on the host (keyed by its ``step``: a 4-thread pool's batch
   order varies run to run), the injector fired, ``io_retries`` > 0,
   ``io_permanent_failures`` 0, the audits complete, losses finite. (b)
   The token store of phase 13 on 4 threads under ``read-hangs``
   (``hang_rate=0.1,hang_s=0.3``) with ``hedge=0.05`` and without: rows
   == the generator in both, ``io_hedges`` and ``io_hedge_wins`` > 0 with
   the hedge; each pass's wall time. (c) The LM on 4 worker interpreters,
   staged to the card, lineage on, 2 epochs: one frozen (SIGSTOP) when
   the first batch arrives and SIGKILLed at the second, so it dies
   holding the items sent to it meanwhile; then ``worker-kill``
   (``kill_after_reads=6,max_kills=2``): ``worker_respawns`` and
   ``items_redispatched`` >= 1, every
   window once an epoch, ``classify_pipeline`` ``degraded`` naming
   ``worker-respawns``; the seconds from the kill (or the detected death)
   to the first redispatched delivery. (d) The png store on 2 threads
   through ``make_reader`` with a row transform that raises
   ``SimulatedWorkerCrash`` on one row group's rows, ``worker_recovery=
   dict(poison_threshold=2, max_respawns=5)``, into CNN steps on K4:
   ``poison_items_quarantined`` 1, ``worker_respawns`` 2, one
   ``worker-crash`` record of that row group, every other image once, K4
   every step. (e) A removed data file raises ``FileNotFoundError`` on its
   first attempt (``io_permanent_failures`` 1, ``io_retries`` and
   ``worker_respawns`` 0); a SIGKILL under ``worker_recovery=False``
   raises ``RuntimeError`` naming the exit codes; a spent budget of 2
   respawns raises within 60 s. (f) The LM steady step (2 epochs, 4
   threads) with ``retry=False`` and the default, 6 pairs in turns, the
   ratio beside the off runs' spread. K1-K3 launch on every LM step;
21. remote line (after phase 20; local stores read as an object store under
   the recorded ``s3-us-east-1`` trace, ``trace-replay`` armed through
   ``PETASTORM_TPU_CHAOS`` from a seed derived from ``--seed``). (a) The
   token store of phase 13 (8,192 rows, 33 row groups of about 2 MB)
   through ``make_columnar_reader`` on 4 threads under ``remote_read``
   ``'serial'``, ``'prebuffer'``, ``'ranged'`` and ``'ranged'`` with
   ``io_readahead=2``: each pass == the generator bit for bit (by
   ``idx``), ``io_range_requests`` > 0 exactly under ``'ranged'``; each
   pass's rows/s, store reads and bytes (the workers' chaos wrappers), the
   replayed reads and seconds, the ``io_range_*`` counters and the
   ``io_range`` p99; then ``'ranged'`` on 4 worker processes, and 16 AdamW
   steps of the flagship LM (full width, bf16, flash) on K1-K3 from a
   ranged process-pool reader's batches. (b) A second same-seed ranged
   pass: its replayed reads, replayed seconds (to the us) and
   ``io_range_requests`` equal the first's. (c) One thread under
   ``read-hangs`` with ``remote_read='ranged'``, ``hedge=0.05`` and
   without: rows == the generator in both, ``io_hedges`` >= 1 hedged; both
   wall times. (d) The pod tier: the png store (256 images, with ``idx``)
   over 3 shared-cache roots ("hosts"), each serving ``serve_peers()`` on
   127.0.0.1 and listing the other two as ``peers``; the cold host's
   reader (2 threads) first, then the other two hosts' at once: over the
   three roots ``fills`` == the row groups and ``peer_hits`` == 2 x the row
   groups; 4 CNN steps on K4 from host 3's batches, whose images equal
   the cold host's byte for byte; a reader whose first peer is
   ``127.0.0.1:9`` counts ``peer_errors`` 1, then ``peer_skipped_dead``,
   and reads every image. (e) ``reader.profile(calibrate='force')`` over a
   ranged reader gives a numeric ``parquet_ranged_rows_per_s``; a typo in
   ``remote_read``, a ``file://tmp/x`` URL and an ``ftp://`` URL raise
   ``ValueError`` with JAX's words;
22. resume line (after phase 21; the flagship LM at full width, bf16,
   flash, fed 8 NGram windows a step from the LM store of phase 5 and a
   second one written from ``--seed`` + 1, every batch staged by
   ``prefetch_to_device``). Each part runs A uninterrupted, and B stopped,
   checkpointed (params, ``optimizer.state_dict()`` and the data state
   through JSON, with ``torch.save``), dropped, rebuilt from the file and
   resumed; B's token batches equal A's bit for bit (``torch.equal`` on
   the card) and its losses A's within 1e-3 relative and, on the card,
   bit for bit (the step is a function of its inputs there, so a restore
   that lost the optimizer's moments shows even within 1e-3). (a) ``make_indexed_ngram_loader`` (2 epochs of
   39 batches, 4 workers): A 44 steps, B 20 + 24 across the epoch
   boundary, restored on 1 worker, whose loader assembles no batch before
   its cursor. (b) ``WeightedIndexedMixture`` (0.75, 0.25) over the two
   stores' indexed loaders: A 24 steps, B 10 + 14; each step's source,
   told by its tokens, is ``draw_index(normalize_cumulative(p),
   default_rng((seed, k)).random())``. (c) ``CheckpointableLoader`` over
   ``make_reader`` (dummy pool, seeded) + ``TorchDataLoader``: A 12 steps,
   B 5 + 7 (the restore replays 5 batches). Each part prints the steady
   step, the restore's seconds to its first staged batch and the
   bit-equality; K1-K3 launch once a layer on each of the 160 steps;
23. pod line (after phase 22). (a) An elastic pod feeds the flagship LM
   (full width, bf16, flash): a token store of 1,024 rows x 2,049 int32
   (about 8.4 MB in 9 row groups of about 1 MB) read by the port's
   ``IndexedDatasetReader``, one ``ElasticPodSim`` a run (batch 8, JAX's
   default ``min(row groups, 2 k)`` leases) over a coordination directory
   beside the store. Clean runs of 3 and 2 hosts keep their batches on the
   host: each equals ``plan.batch_rows(lease, 0, batch)`` of the store
   read with pyarrow alone. ``host-death`` on 3 hosts and ``host-join``
   from 2: each delivered batch staged to the card (``stage_to_device``:
   pinned, ``non_blocking``) equals the clean run's and pyarrow's rows
   bit for bit and drives one AdamW step on K1-K3 (126 a run); the
   certificate holds in every run, one death (hosts died, leases
   rebalanced) and one join (the joiner delivers); a host-only rerun under
   the same chaos seed gives the same deaths, joins and counters. Each run
   prints its epoch's wall time, the LM's steady step and the lease
   plane's time a batch (``ElasticHost.step`` less its gather and its
   consumer); the death run the seconds from the death to the first batch
   on a moved lease. ``make_reader(elastic=)``: two registered hosts read
   disjoint shards 0 and 1 of 2 whose union is the store; under
   ``PETASTORM_TPU_ELASTIC=0`` no member file; beside ``cur_shard``,
   ``ElasticConfigError`` with JAX's words. (b) Pod observability: the png
   store (256 images) over 3 shared-cache roots serving ``serve_peers()``,
   each host's reader (2 threads, traced) with ``debug_port=0``, the third
   on a port reserved before it starts and with
   ``PETASTORM_TPU_PODOBS_PEERS`` naming the three: each
   ``/observe/snapshot`` one JSON with ``X-Petastorm-Clock-S`` and the sent
   ``X-Petastorm-Trace`` echoed; ``/podmetrics`` and
   ``PodObserver(peers).report()``: fills == the row groups, peer hits ==
   2 x the row groups, the certificate ok, the pod ``peer_fetch`` p99 ==
   ``state_percentiles(merge_histogram_states(...))`` of the hosts'
   states, each clock offset within its poll's round trip; with
   ``127.0.0.1:9`` added, ``partial_pod`` naming it and
   ``assert_certificate`` raising; ``export_pod_chrome_trace`` one track a
   host, host 3's peer fetches all recorded by the serving roots under
   its cache's trace id; under ``PETASTORM_TPU_PODOBS=0`` both routes 404
   with JAX's text, no trace header and no ``io_attempt`` span of a
   hedged traced reader (which records them with the plane on); 4 CNN
   steps on K4 from host 3's batches, images == the cold host's.
24. parallel line (after phase 23; data and sequence parallelism, every
   rank a process on the one card: several ranks cannot form a NCCL group
   on one GPU, so they form a gloo group and CUDA tensors cross through
   pinned host memory; the kernels are built before the ranks start).
   (a) + (b) on 4 ranks. (a) Ring attention alone on q, k, v, do (8, 8,
   2048, 64) bf16 from ``--seed``, over ``{'seq': 4}`` and over the seq
   groups of ``{'data': 2, 'seq': 2}``, causal and not, MHA and GQA 8 ->
   2: o, lse, dq, dk, dv gathered equal one process's K1 over the whole
   sequence and K2 + K3 on the ring's (o, lse), within ``2
   flash_gate_limit + 2^-9 B + n 1e-5`` (lse ``2 TOL_F32 (1 + |lse|)``:
   the ring rounds each chunk pair's output to bf16 before its float32
   merge), and the twins' ring in float32 within ``flash_gate_limit +
   2^-9 B + n 1e-5`` (``ring_gates``); K1-K3 launch n(n+1)/2 times a seq
   group causal and n^2 not; each rank's ring ms forward and backward and
   the bytes rotated. (b) The flagship LM (``TransformerConfig``'s
   defaults, ``attention='ring'``) on ``{'data': 2, 'seq': 2}`` fed by
   ``make_indexed_ngram_loader(mesh=)`` (global batch 8, the 320-row
   token store), 8 AdamW steps: the seq ranks of a data group stage equal
   batches and the data groups' union is the unsharded loader's global
   batch bit for bit; each step's loss within 2e-3 of a one-process flash
   step on the gathered batch from the same parameters; step 1's summed
   gradient within 5e-2 (relative norm a leaf) of that step's, and its
   ``gather_params`` within 2 lr of its parameters, every one more than
   lr/2 apart where the two gradients differ in sign or one is within 100
   eps of zero (AdamW's first step moves a parameter by about lr
   sign(g)); the step ms a rank and the gloo transport's share. (c) 2
   ranks: a token store of 288 rows x 2,049 in 9 row groups,
   ``make_reader(shard_by_jax_process=True)`` -> ``make_torch_loader(
   mesh={'data': 2})`` -> the LM (flash) for 4 steps, then the loader to
   its lockstep stop: both ranks the same steps, the surplus drained, a
   second pass after the reset the same, each rank's rows == shard r of 2
   read with pyarrow, each loss within 2e-3 of a one-process step on the
   concatenated batch. (d) 2 ring steps on a one-rank NCCL mesh
   ``{'data': 1, 'seq': 1}`` == the flash steps bit for bit.
25. tensor, expert and pipeline parallel line (after phase 24; ranks on
   the one card over gloo as there). (a) + (b) + (c) on 4 ranks. (a) The
   flagship LM (flash, bf16) on ``{'data': 2, 'model': 2}`` fed by
   ``make_indexed_ngram_loader(mesh=)`` (global batch 8), 4 AdamW steps:
   each rank's logits block (4, 2048, 16000); the model ranks of a data
   group stage equal batches and the data groups' union is the unsharded
   loader's; each loss within 2e-3 of a one-process step on the gathered
   batch from the same parameters; step 1's gathered gradient within 5e-2
   and its ``gather_params`` through phase 24 (b)'s AdamW gate
   (``adamw_gate``); K1 on the rank's (4, 4) heads; the step ms a rank,
   the transport's share and the bytes a step (activation collectives,
   gradient sums). (b) Phase 12's MoE (GQA 8 -> 2, 8 experts top-2) on
   ``{'data': 2, 'expert': 2}``, fed and gated as (a); on a float32 copy
   of layer 0 every unit's expert, slot and drop == one process's on the
   gathered batch; in bf16 step 1 every unit routed otherwise lies within
   2^-6 of a tie and units of untouched experts drop alike, while no
   earlier layer differed (``route_gates``); units dropped and the bytes
   gathered for routing. (c) ``make_pipeline_fn`` on ``{'pipe': 2,
   'data': 2}`` with stages of 2 flagship layers (flash), 8 microbatches
   of 2 rows a data rank, 2 steps: 9 sends forward and 8 back a step;
   outputs within 2^-8 max |ref| and each stage's gradients within 1e-3 of
   one process running the stages in order; the ms and bytes a step and
   the bubble share. (d) ``parallel.dryrun.dryrun_multichip(8)`` on the
   card prints JAX's three lines; each loss within 1e-4 of one process's
   unsharded step; the ring runs the float32 head-dim-16 K1-K3.
26. adapter line (after phase 25; one process). (a) A 256-row token store
   (``idx``, 2,049 int32 tokens under ``NdarrayCodec``, row groups of about
   0.25 MB) -> ``make_reader(workers_count=4)`` -> ``pytorch.DataLoader(
   batch_size=8, shuffling_queue_capacity=64, seed=--seed)`` -> 8 AdamW
   steps of the flagship LM (flash, bf16): every batch's ``tokens`` a CUDA
   int32 (8, 2049) tensor whose rows are the tokens written for their
   ``idx``, all 256 ``idx`` once in the pass (32 batches), step 1's loss
   within 1e-2 relative of the plain blockwise attention's on the same
   batch and parameters, K1-K3 launched 8 x 4 times each; two same-seed
   ``DataLoader``s on the dummy pool give one order; the median steady
   step and batch wait. (b) 256 png images of 224 x 224 with ``idx`` ->
   ``make_reader(workers_count=8)`` -> ``DataLoader(batch_size=64)`` -> 3
   SGD steps of the image CNN: images CUDA uint8 (64, 224, 224, 3) equal
   to ``cv2.imdecode`` of the cells pyarrow reads for their ``idx``; K4
   launched 3 times. (c) The batch line's 60,000-row store ->
   ``make_batch_reader`` -> ``BatchedDataLoader(batch_size=512,
   shuffling_queue_capacity=4096, inmemory_cache_all=True)`` -> 2 epochs
   of MLP SGD steps: epoch 1's ``idx`` multiset is the store's; epoch 2's
   batches are epoch 1's bit for bit, with no reader pass. (d)
   ``make_dataset_converter`` over a 10,000-row pandas frame (``idx``,
   ``digit``, 16 float64 features from ``--seed``, ``precision=
   'float32'``): ``make_torch_dataloader(batch_size=512)``'s CUDA float32
   rows == the frame's, cast; a second call returns the cached handle and
   writes no directory; ``make_torch_loader``'s rows the same;
   ``delete()`` removes the directory. (e) On the host: ``copy_dataset``
   of (a)'s store (``field_regex``, ``rows_per_file``) read back through
   (a)'s ``DataLoader`` on the card == the source; ``metadata_util
   --schema --row-groups`` prints pyarrow's row-group count;
   ``generate_metadata`` on a plain pyarrow store, then
   ``get_schema_from_dataset_url`` and ``make_reader``; a
   ``DataframeColumnCodec`` subclass passed to ``register_codec``
   round-trips a store to the card.
27. instruments line (after phase 26; one process, stores written
   again). (a) ``profiler.calibrate`` on phase 13's token store (8,192
   rows x 2,049 int32 under ``NdarrayCodec`` and ``idx``, ``tokens``
   device-planned) on the card: the ``device_decode`` probe (the fused
   decode of one row group's raw grids already on the card) and the
   ``ingest`` probe (their pinned, side-stream copy), each rep ended by a
   CUDA event: rows/s, MB/s and seconds beside the ``device_stage``
   ceiling; both non-``None``, positive, ``path == 'device'``. (b)
   ``northstar.run_transformer_train_bench`` on that store at
   ``TransformerConfig``'s widths (blockwise attention, JAX's bench's),
   batch 8, fed by ``prefetch_batches``, ``dispatch_ahead=2``: 16 measured
   steps after 3, then the 26-step sync probe; tokens/s, the stall share
   and the sync overlap; K1-K3 not launched. Then the mnist (16,384 png
   rows) and imagenet (256 synthetic images) train benches at JAX's
   defaults for 8 and 6 steps; K4 once an imagenet step. (c)
   ``python -m petastorm_tpu_torch.benchmark.cli`` on the token store
   (``--read-method torch --profile -d``, 4 workers, batch 8): samples/s >
   0 and ``diagnosis['roofline']`` naming a binding stage. (d)
   ``run_device_decode_bench(quick=True)`` and
   ``run_goodput_bench(quick=True)`` on the card with their own checks:
   both decode modes bit-equal over the epoch, ``device_decode_fraction``
   1.0 on and 0 off; the goodput verdicts, the pod merge and the kill
   switch (its overhead printed: 2 pairs of millisecond passes cannot
   resolve its 15% gate, see ``instruments_line``).
28. benchmark twins line (after phase 27; ``benchmark_twins_line``, one
   table a twin in ``twin_table``): the fifteen twins of JAX's
   ``benchmark/`` modules with ``check=False``, in four groups, each
   group's seconds logged: decode and read (``decode_batch`` and
   ``roofline`` at JAX's full 16,384 png rows, staging to the card;
   ``transport``, ``readahead``, ``shared_cache`` quick), control and
   fault (``autotune`` quick, calibrating on the card; ``chaos``,
   ``object_store`` quick), the overheads (``lineage_`` and
   ``latency_overhead`` quick with their loaders on the card, ``trace_``
   and ``health_overhead`` quick), pod and scaling (``podobs``,
   ``podelastic`` quick; ``scaling`` at JAX's accelerator sizes, 16,384
   rows, batch 512, hidden 2048, on 1, 2, 4 and 8 workers, 20 steps
   instead of 60). Gates: each module's ``_check_exact`` (each column
   decoded bit-identically and every cell batched; zero-copy strictly
   fewer pool copies than pickle, no in-process copy, pickle 2.0 a item;
   readahead hits; fills == row groups, hits >= (K-1) x groups, a warm
   pass with no miss; a calibration, the binding stage and a monotone
   advisor; a controller action and every model check; hedges fired and
   won; bit-identical planes, no clean-path hedge, exact pod fills and
   peer hits, three determinism flags; provenance and a complete audit,
   spans and a valid Chrome trace, populated histograms and an SLO
   verdict, ``healthy`` over the ventilator and workers; the pod
   certificate, bit-identical merged percentiles, ``partial_pod``
   refused; a death, exactly-once, a lease moved; samples/s > 0 at every
   worker count) and no flash-kernel launch. Each timing bar a twin
   states (its ``_bars``: JAX's bar for the run's size) is printed with
   its value, held or missed, not gated.
29. head-dim line (after phase 28; ``head_dim_line``). (a) K1-K3 at head
   dims 32 and 128, bf16 and float32, against their float32 twins over
   phase 3's edge shapes, and in bf16 at the causal path shapes
   (8, 16, 2048, 32) and (8, 4, 2048, 128) (H x D = 512, the flagship's
   d_model), under phase 3's gates; (b) the padded head dims 80 and 96,
   bf16 and float32, through the wrappers against the twins at the true
   head dim, each kernel launched; (c) the flagship LM with 128-wide heads
   (``TransformerConfig(attention='flash', n_heads=4)``): ``reference_check``
   at that config, then phase 5's main path (NGram ``make_reader`` ->
   ``TorchDataLoader`` -> ``prefetch_to_device``, 5 AdamW steps of 8
   windows), its losses finite and K1-K3 launched 5 x 4 times each; (d)
   the north-star LM at JAX's bench widths (vocab 8192, d_model 256 over 8
   heads: head dim 32, 4 layers, d_ff 1024, L 256) on flash and on
   blockwise attention, fed as phase 27's run (``make_columnar_reader`` ->
   ``TorchDataLoader`` -> ``prefetch_batches``, batch 8, 3 + 16 steps
   through ``measure_infeed_overlap``, ``dispatch_ahead`` 2): the first
   batch's flash loss and gradients against blockwise on the same params
   at ``reference_check``'s tolerances, K1-K3 launched 19 x 4 times each
   on flash and never on blockwise, each steady step beside phase 27's;
   (e) K4 at 8 channels, a distinct mean and std a channel, bit for bit
   against its twin. The timing phase then also times K1-K3 at the two
   path shapes, each beside SDPA and aten's flash backward on the same
   operands, and K4 at (64, 224, 224, 8); the kernel table has a row for
   each kernel at each bf16 head dim (32, 64, 128), each with the
   registers and spills of that kernel's instantiations.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing results.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12            # float32 outside the tensor cores

PATH_SHAPE = (8, 8, 2048, 64)     # B, H, L, head_dim of the LM's attention
TOL_F32 = 1e-4                    # atol = rtol: float32 sums in other order
STEPS = 5                         # main-path train steps (the first warms up)
BATCH = 8                         # windows of 2048 tokens per step
ROWS = 320                        # store rows: 2 row groups, 318 windows
REPS = 20                         # timed launches per kernel (median)

IMAGE_CODEC = 'png'               # cv2 is on the card: decode runs there
IMAGE_ROWS = 256                  # image store rows (~12 row groups)
IMAGE_BATCH = 64
IMAGE_SIZE = 224
IMAGE_CLASSES = 16
IMAGE_STEPS = 6                   # image main-path steps (the first warms up)
IMAGE_WORKERS = 8
K4_SHAPE = (IMAGE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
K4_LOOP = 100                     # K4 launches between two events
MNIST_ROWS = 2048
LEGACY_PATH = os.path.join(ROOT, 'tests', 'data', 'legacy', 'legacy_dataset')
LEGACY_ROWS = 24
JPEG_SCALE = 2                    # decode_hints={'image': {'scale': 2}}
# jpeg cells are about 11x smaller than png's: 0.75 MB row groups hold the
# png store's ~21 images each (12 row groups), so 8 workers share the store
JPEG_ROW_GROUP_MB = 0.75
JPEG_STEPS = 4
SEL_HOLDOUT = 288                 # filters keep step < 288
SEL_SPLIT = 0.9                   # in_pseudorandom_split([0.9, 0.1], ...)
SEL_DROP = 2                      # shuffle_row_drop_partitions
SEL_PROMPTS = 8                   # held-out prompts (subset 1)
SEL_PROMPT_LEN = 128
SEL_NEW = 64
# Decode against teacher forcing, float32, no TF32: a sum of up to
# d_ff = 2048 terms taken in another order moves by at most 2048 x 2^-24 =
# 2^-13 of the sum of |terms|; the residual stream passes 8 such sums (4
# layers x attention and FFN) before the unembedding, so the logits are
# held to 8 x 2^-13 = 2^-10 (atol and rtol).
DECODE_TOL = 2.0 ** -10
BATCH_LINE_ROWS = 60000           # MNIST's training set
BATCH_LINE_HOLDOUT = 54000        # filters keep idx < 54000
BATCH_LINE_SPLIT = 0.9            # in_pseudorandom_split([0.9, 0.1], 0)
BATCH_LINE_SHARDS = 2             # cur_shard 0 of 2
BATCH_LINE_BATCH = 512
BATCH_LINE_LR = 0.1
PACKED_DOCS = 2048                # documents in the packed line's store
PACKED_MEDIAN = 384               # log-normal length median, sigma 1
PACKED_MIN_LEN = 32
PACKED_BATCH = 32                 # documents a loader batch, ~10 rows
PACKED_PROMPTS = 8
PACKED_PROMPT_LEN = 64
PACKED_NEW = 32
PACKED_GATE_ROWS = 4              # rows of 512 in the flash-vs-plain gate
TOKEN_ROWS = 8192                 # columnar token store: 16.8 M tokens
TOKEN_GROUP_MB = 2                # row groups of about 2 MB
TOKEN_WORKERS = 4
TOKEN_BATCH = 8
TOKEN_STEPS = 5

KERNELS = {
    'flash_fwd': ('petastorm_tpu_torch/csrc/flash_fwd_sm90.cu',
                  'petastorm_tpu/ops/attention.py:260'),
    'flash_bwd_dq': ('petastorm_tpu_torch/csrc/flash_bwd_dq_sm90.cu',
                     'petastorm_tpu/ops/attention.py:658'),
    'flash_bwd_dkdv': ('petastorm_tpu_torch/csrc/flash_bwd_sm90.cu',
                       'petastorm_tpu/ops/attention.py:706'),
    'normalize': ('petastorm_tpu_torch/csrc/normalize.cu',
                  'petastorm_tpu/ops/normalize.py:21'),
}


FLASH = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkdv')


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# phase 3: kernels against plain twins
# ---------------------------------------------------------------------------

def _operands(torch, gen, b, h, hkv, lq, lk, d, dtype, nonneg=False):
    """q, k, v, do; with ``nonneg`` each is |randn|."""
    def rnd(*shape):
        x = torch.randn(*shape, generator=gen, device='cuda')
        return (x.abs() if nonneg else x).to(dtype)
    return (rnd(b * h, lq, d), rnd(b * hkv, lk, d), rnd(b * hkv, lk, d),
            rnd(b * h, lq, d))


def _max_err(torch, got, ref, label, kernels=None, bound=None):
    """Max abs error of a kernel output against the float32 twin. Given a
    ``bound`` (a bf16 output of a tensor-core kernel, which rounds p or ds
    to bf16 before its second product): ``kernels.flash_gate_limit``. Else
    (a float32 output) atol = rtol = TOL_F32."""
    check(bool(torch.isfinite(got).all()), '%s: non-finite output' % label)
    ref = ref.float()
    err = (got.float() - ref).abs()
    if bound is not None:
        limit = kernels.flash_gate_limit(ref, bound, got.dtype)
    else:
        limit = TOL_F32 * (1 + ref.abs())
    bad = err > limit
    check(not bool(bad.any()),
          '%s: %d elements beyond the limit (max abs err %.3g)'
          % (label, int(bad.sum()), float(err.max())))
    return float(err.max()) if err.numel() else 0.0


def compare_case(torch, kernels, label, gen, *, b, h, hkv, lq, lk, d, dtype,
                 causal=True, window=None, segmented=False, nonneg=False):
    """Each kernel on ``dtype`` operands against its twin on the same
    values widened to float32 (exact), so the twin's sums stand before any
    rounding to ``dtype``. With ``nonneg`` the backward passes get delta =
    0, so ds = p (do v^T) scale >= 0 and a truncated ds biases dq and dk.
    Returns the max abs error per kernel."""
    q, k, v, do = _operands(torch, gen, b, h, hkv, lq, lk, d, dtype, nonneg)
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    kw = dict(n_heads=h, n_kv_heads=hkv, causal=causal, window=window)
    if segmented:
        seg = (torch.arange(lq, device='cuda') >= lq // 2).int()
        kw['seg_q'] = seg.expand(b * h, lq).contiguous()
        seg_kv = (torch.arange(lk, device='cuda') >= lk // 2).int()
        seg_kv[0] = 7            # q row 0 sees only k=0: fully masked
        kw['seg_kv'] = seg_kv.expand(b * hkv, lk).contiguous()
    o, lse = kernels.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = kernels.flash_fwd_plain(q32, k32, v32, **kw)
    # both backward passes see the twin's o and lse
    delta = (do32 * o_ref).sum(-1) * (0.0 if nonneg else 1.0)
    bound = ({} if dtype == torch.float32 else
             kernels.flash_rounding_bounds(q32, k32, v32, do32, lse_ref,
                                           delta, **kw))
    torch.cuda.synchronize()
    errs = {'flash_fwd': max(
        _max_err(torch, o, o_ref, label + ' o', kernels, bound.get('o')),
        _max_err(torch, lse, lse_ref, label + ' lse'))}
    if segmented:
        check(bool((lse[:, 0] == kernels.NEG_INF).all())
              and not bool(o[:, 0].any()),
              '%s: fully masked row must give o=0, lse=-1e30' % label)
    dq = kernels.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
    dq_ref = kernels.flash_bwd_dq_plain(q32, k32, v32, do32, lse_ref, delta,
                                        **kw)
    dk, dv = kernels.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = kernels.flash_bwd_dkdv_plain(q32, k32, v32, do32,
                                                  lse_ref, delta, **kw)
    torch.cuda.synchronize()
    want = torch.float32 if h != hkv else dtype   # GQA: float32 partials
    check(dk.dtype == want and dq.dtype == dtype and o.dtype == dtype,
          '%s: output dtypes o %s dq %s dk %s' % (label, o.dtype, dq.dtype,
                                                  dk.dtype))
    errs['flash_bwd_dq'] = _max_err(torch, dq, dq_ref, label + ' dq',
                                    kernels, bound.get('dq'))
    errs['flash_bwd_dkdv'] = max(
        _max_err(torch, dk, dk_ref, label + ' dk', kernels, bound.get('dk')),
        _max_err(torch, dv, dv_ref, label + ' dv', kernels, bound.get('dv')))
    bias = ''
    if nonneg:
        ratios = {n: kernels.rounding_bias(g, r, bound[n]) for n, g, r in
                  (('o', o, o_ref), ('dq', dq, dq_ref), ('dk', dk, dk_ref),
                   ('dv', dv, dv_ref))}
        bias = '; bias o %+.4f dq %+.4f dk %+.4f dv %+.4f (limit +-%g)' % (
            ratios['o'], ratios['dq'], ratios['dk'], ratios['dv'],
            kernels.BIAS_LIMIT)
        check(all(abs(r) < kernels.BIAS_LIMIT for r in ratios.values()),
              '%s: rounding bias beyond +-%g: %r'
              % (label, kernels.BIAS_LIMIT, ratios))
    if dtype == torch.float32:
        limits = 'atol=rtol=%g' % TOL_F32
    else:
        limits = 'o, dq, dk, dv: half bf16 ulp + 2^-8 B + 1e-5(1+|ref|)'
    log('kernels %-26s max_abs_err fwd %.3g dq %.3g dkdv %.3g (limit %s)%s'
        % (label, errs['flash_fwd'], errs['flash_bwd_dq'],
           errs['flash_bwd_dkdv'], limits, bias))
    return errs


def ptxas_summary(log_text):
    """One line per kernel entry from nvcc's ``-Xptxas -v`` report: its
    (mangled) name, registers and spill stores/loads."""
    import re
    entry = re.compile(r"entry function '(\S+)'.*?(\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads.*?Used (\d+) registers", re.S)
    return ['%s: %s registers, spill %s/%s B' % (name, regs, st, ld)
            for name, st, ld, regs in entry.findall(log_text)]


# ---------------------------------------------------------------------------
# phase 4 / 5: LM reference and main path
# ---------------------------------------------------------------------------

def reference_check(torch, tlm, seed, cfg=None, params=None, tokens=None,
                    targets=None, label='reference'):
    """Full-width model (``cfg``, the flagship's by default) on a (1, 256)
    input, or on ``tokens`` and ``targets``: the flash path's loss and
    gradients against the plain blockwise attention's on the same
    ``params`` (made from ``seed`` when not given)."""
    import dataclasses
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        params = tlm.init(cfg, gen, device='cuda')
    if tokens is None:
        toks = torch.randint(0, cfg.vocab_size, (2, 1, 256), generator=gen)
        tokens, targets = toks[0].cuda(), toks[1].cuda()
    results = []
    for mode in ('flash', 'blockwise'):
        leaves = tlm.parameters(params)
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        c = dataclasses.replace(cfg, attention=mode)
        loss = tlm.loss_fn(params, tokens, targets, c)
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in leaves]))
    for p in tlm.parameters(params):
        p.grad = None
    (lf, gf), (lb, gb) = results
    check(math.isfinite(lf) and abs(lf - lb) < 1e-2,
          '%s: flash loss %r vs blockwise %r' % (label, lf, lb))
    rel = max(float((a - b).norm() / (b.norm() + 1e-12))
              for a, b in zip(gf, gb))
    check(rel < 5e-2, '%s: gradient relative error %.3g' % (label, rel))
    log('%s loss flash %.6f blockwise %.6f |dL| %.3g, max grad '
        'rel err %.3g (tol loss 1e-2, grad 5e-2)' % (label, lf, lb,
                                                     abs(lf - lb), rel))


def write_store(np, url, seq_len, vocab, rows, seed, rows_per_file=None):
    """Write ``rows`` rows of ``step`` and random ``tokens`` (from
    ``seed``) to ``url``; returns the tokens, (rows, seq_len) int32."""
    from petastorm_tpu_torch import materialize_dataset
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('TokenSchema', [
        UnischemaField('step', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (seq_len,), NdarrayCodec(),
                       False)])
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (rows, seq_len), dtype=np.int32)
    with materialize_dataset(url, schema,
                             rows_per_file=rows_per_file or rows // 2,
                             row_group_size_mb=64) as w:
        w.write_rows({'step': np.int64(i), 'tokens': tokens[i]}
                     for i in range(rows))
    return tokens


def main_path(torch, np, tlm, kernels, args, cfg=None, label='LM',
              stats=None):
    """Phase 5 (and phase 29 (c) at ``cfg``): the LM's main path; returns
    the launches of its steps and puts the steady step's seconds in
    ``stats['steady_s']``."""
    from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.ngram import NGram
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        url = 'file://' + os.path.join(d, 'tokens')
        start = time.perf_counter()
        write_store(np, url, cfg.max_seq_len, cfg.vocab_size, ROWS,
                    args.seed)
        log('store %d rows x %d tokens written in %.2f s'
            % (ROWS, cfg.max_seq_len, time.perf_counter() - start))
        params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                          device='cuda')
        _, step = tlm.make_train_step(cfg, params)
        ngram = NGram(fields={0: ['step', 'tokens'], 1: ['tokens']},
                      delta_threshold=1, timestamp_field='step')
        losses, times, splits = [], [], []
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with make_reader(url, schema_fields=ngram, num_epochs=1,
                         workers_count=4, seed=args.seed) as reader:
            loader = TorchDataLoader(reader, batch_size=BATCH,
                                     drop_last=True, device='cuda')
            goodput = loader.goodput
            batches = prefetch_to_device(iter(loader), size=2,
                                         goodput=goodput)
            with contextlib.closing(batches):
                for i in range(STEPS):
                    t0 = time.perf_counter()
                    batch = next(batches)
                    t1 = time.perf_counter()
                    tokens = batch[0]['tokens']
                    nxt = batch[1]['tokens'][:, 0]
                    targets = torch.cat([tokens[:, 1:], nxt[:, None]], 1)
                    check('_provenance' not in batch,
                          'an NGram batch holds provenance')
                    check(tokens.is_cuda and tuple(tokens.shape)
                          == (BATCH, cfg.max_seq_len),
                          'batch tokens %s on %s'
                          % (tuple(tokens.shape), tokens.device))
                    out = step(tokens, targets)
                    t2 = time.perf_counter()
                    loss = float(goodput.fence(out))
                    dt = time.perf_counter() - t0
                    losses.append(loss)
                    times.append(dt)
                    splits.append((t1 - t0, t2 - t1, dt - (t2 - t0)))
                    log('%sstep %d loss %.6f time %.2f ms tokens/s %.0f; '
                        'consumer: batch wait %.2f ms, dispatch %.2f ms, '
                        'fence %.2f ms'
                        % ('' if label == 'LM' else label + ' ', i, loss,
                           dt * 1e3,
                           BATCH * cfg.max_seq_len / dt,
                           *(x * 1e3 for x in splits[-1])))
                launches = dict(kernels.LAUNCHES)
                if args.profile:
                    def run_step():
                        batch = next(batches)
                        tokens = batch[0]['tokens']
                        nxt = batch[1]['tokens'][:, :1]
                        step(tokens, torch.cat([tokens[:, 1:], nxt], 1))
                    profile_steps(torch, run_step, 2, 'flash', label)
            # the epoch's items the loader did not take, read and dropped:
            # then every item was delivered once and the audit is complete
            rest = sum(1 for _ in reader.iter_ngram_chunks())
            report = reader.audit().assert_complete()
    epoch = report['epochs'][0]
    log('%s reader audit complete: %d items, %d windows delivered in epoch '
        '0 (%d items read after the steps); no batch held _provenance'
        % (label, epoch['items_delivered'], epoch['rows_delivered'], rest))
    log_goodput(goodput, label)
    check(all(math.isfinite(x) for x in losses), 'non-finite loss')
    check(all(launches[k] > 0 for k in FLASH),
          'a kernel was not launched on the main path: %r' % launches)
    steady = times[1:] or times
    if stats is not None:
        stats['steady_s'] = statistics.median(steady)
    log('%s %d steps, loss %.4f -> %.4f, steady step %.2f ms, '
        '%.0f tokens/s, launches %s'
        % ('main path' if label == 'LM' else label + ' main path',
           len(losses), losses[0], losses[-1],
           statistics.median(steady) * 1e3,
           BATCH * cfg.max_seq_len / statistics.median(steady),
           json.dumps(launches)))
    return launches


def log_goodput(goodput, label, first=0):
    """One line per ring entry of the loader's goodput monitor from step
    ``first``: the split of the step's wall, in ms, and its verdict. The
    loader runs on the prefetch thread, so its fetch overlaps the previous
    step's compute and its train wall is the consumer's step period."""
    from petastorm_tpu_torch.goodput import classify_step
    entries = [e for e in goodput.steps() if e['step'] >= first]
    for e in entries:
        log('goodput %s step %d: total %.2f ms = infeed_wait %.2f (stall '
            '%.2f + h2d_stage %.2f) + device_step %.2f + host_overhead %.2f;'
            ' fenced %s, %s'
            % (label, e['step'], e['total_s'] * 1e3, e['infeed_wait_s'] * 1e3,
               e['stall_s'] * 1e3, e['h2d_stage_s'] * 1e3,
               e['device_step_s'] * 1e3, e['host_overhead_s'] * 1e3,
               e['fenced'], classify_step(e)))
    summary = goodput.summary()
    log('goodput %s: %d steps (%d fenced), goodput fraction %s, data stall '
        'fraction %s' % (label, summary['steps'], summary['fenced_steps'],
                         summary['goodput_fraction'],
                         summary['data_stall_fraction']))
    return entries


def profile_steps(torch, run_step, n, match, label):
    """Profile ``n`` more train steps (``run_step()`` runs one): device time
    by kernel (top 12) to standard error, and one line with the device's
    busy share of the wall time and the share of device time in kernels
    whose name contains ``match``. Returns the busy share (%)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType
    # device-side events only: CPU ops and autograd ranges carry the time
    # of the kernels they launched too, and would count it twice
    dev = [(getattr(e, 'self_device_time_total', None)
            or getattr(e, 'self_cuda_time_total', 0), e.key)
           for e in prof.key_averages()
           if getattr(e, 'device_type', None) == DeviceType.CUDA]
    dev = sorted((t, k) for t, k in dev if t > 0)[::-1]
    busy = sum(t for t, _ in dev)
    print('profile %s, %d steps: wall %.0f us, device busy %.0f us (%.1f%%)'
          % (label, n, wall_us, busy, 100 * busy / wall_us), file=sys.stderr)
    for t, k in dev[:12]:
        print('  %10.0f us %5.1f%%  %s' % (t, 100 * t / max(busy, 1), k[:90]),
              file=sys.stderr)
    log('profile %s %d steps: wall %.0f us, device busy %.1f%% of wall, '
        '%s kernels %.1f%% of device time'
        % (label, n, wall_us, 100 * busy / wall_us, match,
           100 * sum(t for t, k in dev if match in k) / max(busy, 1)))
    return 100 * busy / wall_us


# ---------------------------------------------------------------------------
# phase 6 / 7: image and MNIST lines
# ---------------------------------------------------------------------------

def k4_check(torch, kernels, seed):
    """K4 against its twin, bit for bit; returns the max abs error (0)."""
    from petastorm_tpu_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
    v = torch.arange(256, dtype=torch.uint8).reshape(2, 16, 8)
    exhaustive = torch.stack([v, v.roll(1), v.roll(2)], -1).cuda()
    gen = torch.Generator(device='cuda').manual_seed(seed)
    batch = torch.randint(0, 256, K4_SHAPE, generator=gen, device='cuda',
                          dtype=torch.uint8)
    flat = torch.arange(1 + 7 * 5 * 3, device='cuda').to(torch.uint8)
    tail = flat[1:].view(1, 7, 5, 3)    # storage offset 1, 105 = 6 x 16 + 9
    zero_one = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    imagenet = (IMAGENET_MEAN, IMAGENET_STD)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [('all uint8 x 3 ch, 0/1 bf16', exhaustive, zero_one, bf16),
             ('all uint8 x 3 ch, imagenet bf16', exhaustive, imagenet, bf16),
             ('all uint8 x 3 ch, imagenet f32', exhaustive, imagenet, f32),
             ('batch %s 0/1 bf16' % (K4_SHAPE,), batch, zero_one, bf16),
             ('batch %s imagenet bf16' % (K4_SHAPE,), batch, imagenet, bf16),
             ('misaligned + tail, imagenet f32', tail, imagenet, f32)]
    worst = 0.0
    for label, x, (mean, std), dtype in cases:
        m = torch.tensor(mean, dtype=torch.float32)
        inv = 1.0 / torch.tensor(std, dtype=torch.float32)
        got = kernels.normalize(x, m, inv, dtype)
        ref = kernels.normalize_plain(x, m, inv, dtype)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == bf16 else torch.int32
        differ = int((got.view(bits) != ref.view(bits)).sum())
        err = float((got.float() - ref.float()).abs().max())
        worst = max(worst, err)
        log('kernels normalize %-36s %d of %d elements differ in any bit, '
            'max_abs_err %.3g (limit: bit-equal)'
            % (label, differ, got.numel(), err))
        check(differ == 0 and got.dtype == dtype and got.shape == x.shape,
              'normalize %s: %d elements differ from the twin'
              % (label, differ))
    return worst


def image_reference_check(torch, kernels, seed):
    """The full-width CNN's loss on 8 images of 224 x 224, with K4 and with
    the twin's normalisation, on the same parameters: bit for bit."""
    from petastorm_tpu_torch.models import image_cnn as cnn
    from petastorm_tpu_torch.ops.normalize import normalize_images
    params = cnn.init(torch.Generator().manual_seed(seed),
                      num_classes=IMAGE_CLASSES, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(seed + 1)
    x = torch.randint(0, 256, (8, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen,
                      device='cuda', dtype=torch.uint8)
    labels = torch.randint(0, IMAGE_CLASSES, (8,), generator=gen,
                           device='cuda')
    zero, one = torch.zeros(3), torch.ones(3)
    with torch.no_grad():
        k4 = cnn.loss_fn(params, normalize_images(x, (0.0, 0.0, 0.0),
                                                  (1.0, 1.0, 1.0)), labels)
        plain = cnn.loss_fn(params, kernels.normalize_plain(
            x, zero, one, torch.bfloat16), labels)
    check(math.isfinite(k4.item()) and torch.equal(k4, plain),
          'image reference: K4 loss %r vs twin %r' % (k4.item(),
                                                      plain.item()))
    log('reference image CNN loss with K4 %.9f, with the twin %.9f '
        '(limit: bit-equal)' % (k4.item(), plain.item()))


def image_main_path(torch, kernels, args):
    """The example's ``train()`` on the card at its defaults, from a png
    store; two more steps profiled on the same pipeline."""
    from petastorm_tpu_torch.examples.imagenet.generate_imagenet import (
        generate, synthetic_rows)
    from petastorm_tpu_torch.examples.imagenet.main import train
    from petastorm_tpu_torch.models import image_cnn as cnn
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        url = 'file://' + os.path.join(d, 'images')
        start = time.perf_counter()
        n = generate(url, synthetic_rows(IMAGE_ROWS, classes=IMAGE_CLASSES,
                                         seed=args.seed),
                     row_group_size_mb=8, image_codec=IMAGE_CODEC)
        log('store %d rows, image (None, None, 3) uint8 under '
            'CompressedImageCodec(%r), 375 x 500 +-20%%, written in %.2f s'
            % (n, IMAGE_CODEC, time.perf_counter() - start))
        seen = {}

        def then(batches, step):
            seen['launches'] = dict(kernels.LAUNCHES)

            def run_step():
                b = next(batches)
                images = b['image']
                check(images.is_cuda and images.dtype == torch.uint8
                      and tuple(images.shape) == K4_SHAPE,
                      'image batch %s %s on %s' % (
                          images.dtype, tuple(images.shape), images.device))
                step(images, b['label'])
            seen['busy'] = profile_steps(torch, run_step, 2, 'normalize',
                                         'image')

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        params, losses, times = train(
            url, batch_size=IMAGE_BATCH, steps=IMAGE_STEPS,
            workers_count=IMAGE_WORKERS, num_classes=IMAGE_CLASSES,
            image_size=IMAGE_SIZE, seed=args.seed, log_every=1,
            log=lambda line: log('image ' + line), then=then)
    launches = seen['launches']
    # a step on a batch already on the card with the reader gone: what the
    # step costs without the input pipeline beside it
    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    images = torch.randint(0, 256, K4_SHAPE, generator=gen, device='cuda',
                           dtype=torch.uint8)
    labels = torch.randint(0, IMAGE_CLASSES, (IMAGE_BATCH,), generator=gen,
                           device='cuda')
    step = cnn.make_train_step(params, lr=1e-3)
    alone = []
    for _ in range(4):
        t0 = time.perf_counter()
        step(images, labels)
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - t0)
    check(all(math.isfinite(x) for x in losses), 'image: non-finite loss')
    check(launches['normalize'] == IMAGE_STEPS,
          'K4 launched %d times in %d image steps'
          % (launches['normalize'], IMAGE_STEPS))
    steady = statistics.median(t for _, t in times[1:])
    log('image main path %d steps, loss %.4f -> %.4f, steady step %.2f ms '
        '(batch wait %.2f ms), %.0f images/s, device busy %.1f%%, K4 '
        'launches %d; step alone on a batch on the card, reader stopped: '
        '%.2f ms'
        % (len(losses), losses[0], losses[-1], steady * 1e3,
           statistics.median(w for w, _ in times[1:]) * 1e3,
           IMAGE_BATCH / steady, seen['busy'], launches['normalize'],
           statistics.median(alone[1:]) * 1e3))
    return launches


def mnist_line(torch, args):
    from petastorm_tpu_torch.examples.mnist.main import (
        generate_synthetic_mnist, train)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        url = 'file://' + os.path.join(d, 'mnist')
        generate_synthetic_mnist(url, n=MNIST_ROWS, seed=args.seed)
        start = time.perf_counter()
        params, losses, acc = train(url, epochs=1, device='cuda',
                                    seed=args.seed, log=log)
        torch.cuda.synchronize()
        dt = time.perf_counter() - start
    check(params['w1'].is_cuda, 'MNIST params are not on the card')
    check(all(math.isfinite(x) for x in losses), 'MNIST: non-finite loss')
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    check(last < first, 'MNIST loss did not fall: %.4f -> %.4f'
          % (first, last))
    log('mnist %d rows, %d steps in %.2f s, loss %.4f -> %.4f (first and '
        'last 4 steps), accuracy %.3f' % (MNIST_ROWS, len(losses), dt, first,
                                          last, acc))


def write_mnist_list_store(np, url, rows, seed):
    """The MNIST example's rows, the image stored as an arrow list."""
    from petastorm_tpu_torch import materialize_dataset
    from petastorm_tpu_torch.codecs import ArrowListCodec, ScalarCodec
    from petastorm_tpu_torch.examples.mnist.main import synthetic_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('MnistListSchema', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('digit', np.int64, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (28, 28), ArrowListCodec(),
                       False)])
    with materialize_dataset(url, schema, row_group_size_mb=1) as w:
        w.write_rows(synthetic_rows(rows, seed))


def expected_selection(path, holdout, split, shards):
    """What the batch line's reader must deliver, worked out with pyarrow
    and hashlib alone: ``(row groups, row groups whose min idx < holdout,
    row groups of shard 0, set of idx)``. The row groups in (file, row
    group) order; those whose footer min ``idx`` is below the holdout;
    every ``shards``-th of them from the first; of their rows, those with
    ``idx`` < holdout whose md5 bucket lies in [0, split)."""
    import hashlib
    import pyarrow.parquet as pq
    groups = []
    for name in sorted(os.listdir(path)):
        if name.endswith('.parquet') and not name.startswith(('_', '.')):
            md = pq.ParquetFile(os.path.join(path, name)).metadata
            col = md.schema.names.index('idx')
            groups.extend((os.path.join(path, name), rg,
                           md.row_group(rg).column(col).statistics.min)
                          for rg in range(md.num_row_groups))
    kept = [(f, rg) for f, rg, lo in groups if lo < holdout]
    shard = kept[::shards]
    want = set()
    for f, rg in shard:
        for idx in pq.ParquetFile(f).read_row_group(
                rg, columns=['idx']).column('idx').to_pylist():
            bucket = (int(hashlib.md5(str(idx).encode('utf-8')).hexdigest(),
                          16) / float(1 << 128))
            if idx < holdout and bucket < split:
                want.add(idx)
    return [(f, rg) for f, rg, _ in groups], kept, shard, want


def hive_filter_check(np, root):
    """A plain hive-partitioned store (no metadata) read with a partition
    filter: the same rows as ``pq.read_table(filters=...)``."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from petastorm_tpu_torch import make_batch_reader
    n = 2000
    ids = np.arange(n, dtype=np.int64)
    table = pa.table({'id': ids, 'value': ids * 0.5,
                      'name': ['row_%d' % i for i in ids],
                      'split': np.where(ids % 5 == 0, 'val', 'train')})
    pq.write_to_dataset(table, root, partition_cols=['split'])
    filters = [('split', '=', 'train')]
    with make_batch_reader('file://' + root, filters=filters,
                           workers_count=2) as reader:
        got = {}
        for b in reader:
            for i, v, name, split in zip(b.id, b.value, b.name, b.split):
                check(int(i) not in got, 'hive: id %d read twice' % i)
                got[int(i)] = (float(v), name, split)
    ref = pq.read_table(root, filters=filters).to_pydict()
    want = {i: (v, name, str(s)) for i, v, name, s in
            zip(ref['id'], ref['value'], ref['name'], ref['split'])}
    check(got == want and len(want) == 1600,
          'hive: %d rows, pyarrow %d, equal %s' % (len(got), len(want),
                                                   got == want))
    return len(got)


def batch_line(torch, np, args, device='cuda', rows=BATCH_LINE_ROWS,
               holdout=BATCH_LINE_HOLDOUT):
    """The selection surface at MNIST's size: store -> make_batch_reader
    (filters, hash split, shard) -> TorchDataLoader -> prefetch_to_device
    -> MLP SGD steps on ``device``. The reader-alone pass must deliver the
    independently reckoned ``idx`` set exactly; the training pass, which
    drops the last short batch, a subset short by less than one batch."""
    from petastorm_tpu_torch import (TorchDataLoader, make_batch_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.models import mnist_mlp
    from petastorm_tpu_torch.predicates import in_pseudorandom_split
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        path = os.path.join(d, 'mnist')
        url = 'file://' + path
        start = time.perf_counter()
        write_mnist_list_store(np, url, rows, args.seed)
        log('batch store %d rows (idx, digit, image 28 x 28 uint8 under '
            'ArrowListCodec) written in %.2f s'
            % (rows, time.perf_counter() - start))
        groups, kept, shard, want = expected_selection(
            path, holdout, BATCH_LINE_SPLIT, BATCH_LINE_SHARDS)
        filters = [('idx', '<', holdout)]

        def reader(**kw):
            return make_batch_reader(
                url, filters=filters, predicate=in_pseudorandom_split(
                    [BATCH_LINE_SPLIT, 1 - BATCH_LINE_SPLIT], 0, 'idx'),
                num_epochs=1, seed=args.seed, workers_count=4, **kw)

        with reader() as r:
            pruned = [(p.path, p.row_group) for p in r.pieces]
        check(pruned == kept, 'batch: %d row groups after pruning, the '
              'footers say %d' % (len(pruned), len(kept)))
        start = time.perf_counter()
        seen = []
        with reader(cur_shard=0, shard_count=BATCH_LINE_SHARDS) as r:
            sharded = [(p.path, p.row_group) for p in r.pieces]
            for b in r:
                seen.append(b.idx)
        alone = time.perf_counter() - start
        seen = np.concatenate(seen)
        check(sharded == shard, 'batch: shard 0 holds %d row groups, the '
              'footers say %d' % (len(sharded), len(shard)))
        check(len(np.unique(seen)) == len(seen) and set(seen.tolist()) == want,
              'batch: reader delivered %d idx (%d unique), reckoned %d'
              % (len(seen), len(np.unique(seen)), len(want)))
        log('batch row groups %d, after pruning %d, after sharding %d; '
            'reader alone (no model) %d rows in %.3f s, %.0f rows/s; '
            'delivered idx set == reckoned (%d rows)'
            % (len(groups), len(pruned), len(sharded), len(seen), alone,
               len(seen) / alone, len(want)))

        params = mnist_mlp.init(torch.Generator().manual_seed(args.seed),
                                device=device)
        losses, delivered = [], []
        start = time.perf_counter()
        with reader(cur_shard=0, shard_count=BATCH_LINE_SHARDS) as r:
            loader = TorchDataLoader(r, batch_size=BATCH_LINE_BATCH,
                                     shuffling_queue_capacity=4096,
                                     drop_last=True, seed=args.seed,
                                     device=device)
            batches = prefetch_to_device(iter(loader), size=2, device=device)
            with contextlib.closing(batches):
                for batch in batches:
                    images = batch['image']
                    check(images.device.type == device
                          and images.dtype == torch.uint8
                          and tuple(images.shape) == (BATCH_LINE_BATCH, 28,
                                                      28),
                          'batch: images %s %s on %s' % (
                              images.dtype, tuple(images.shape),
                              images.device))
                    x = images.reshape(BATCH_LINE_BATCH, -1).float() / 255.0
                    losses.append(mnist_mlp.train_step(
                        params, x, batch['digit'], BATCH_LINE_LR))
                    delivered.append(batch['idx'])
        losses = [float(x) for x in losses]
        if device == 'cuda':
            torch.cuda.synchronize()
        wall = time.perf_counter() - start
    delivered = torch.cat(delivered).cpu().numpy()
    check(params['w1'].device.type == device,
          'batch: parameters are not on %s' % device)
    check(len(np.unique(delivered)) == len(delivered)
          and set(delivered.tolist()) <= want
          and len(want) - len(delivered) == len(want) % BATCH_LINE_BATCH,
          'batch: trained on %d idx (%d unique) of %d reckoned'
          % (len(delivered), len(np.unique(delivered)), len(want)))
    check(all(math.isfinite(x) for x in losses), 'batch: non-finite loss')
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    check(last < first, 'batch: loss did not fall: %.4f -> %.4f'
          % (first, last))
    log('batch line %d steps of %d on %s in %.2f s (%.0f rows/s), loss '
        '%.4f -> %.4f (first and last 4 steps); losses %s'
        % (len(losses), BATCH_LINE_BATCH, device, wall,
           len(delivered) / wall, first, last,
           ' '.join('%.4f' % x for x in losses)))
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        n = hive_filter_check(np, os.path.join(d, 'hive'))
    log('batch hive store: split=train read with a partition filter, %d '
        'rows == pq.read_table(filters=...)' % n)


# ---------------------------------------------------------------------------
# phase 9-11: legacy store, jpeg image line, flagship under selection
# ---------------------------------------------------------------------------

def legacy_expected(np, i):
    """Row ``i`` of the committed legacy fixture (the formula of its
    generator, ``tests/data/legacy/generate_fixture.py``)."""
    image = ((np.arange(8 * 6 * 3, dtype=np.int64).reshape(8, 6, 3)
              * (i + 1)) % 251).astype(np.uint8)
    matrix = np.arange(12, dtype=np.float32).reshape(3, 4) + i / 8.0
    return {'sensor_name': 'sensor_{:02d}'.format(i % 4),
            'image_png': image, 'matrix': matrix}


def legacy_line(torch, np, device='cuda'):
    """The store written by original petastorm through the three readers
    and the loader onto ``device``: 24 rows equal to the formula, the
    stored schema. The batch reader yields the stored bytes, decoded here
    with the codecs of its schema."""
    from petastorm_tpu_torch import (TorchDataLoader, make_batch_reader,
                                     make_columnar_reader, make_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.codecs import CompressedImageCodec
    for factory in (make_reader, make_columnar_reader, make_batch_reader):
        name = factory.__name__
        with factory('file://' + LEGACY_PATH, workers_count=2) as reader:
            schema = reader.schema
            image_field = schema.fields['image_png']
            check(image_field.codec == CompressedImageCodec('png')
                  and image_field.shape == (8, 6, 3),
                  'legacy %s: image_png is %r' % (name, image_field))
            loader = TorchDataLoader(reader, batch_size=LEGACY_ROWS,
                                     device=device)
            batches = prefetch_to_device(iter(loader), size=2, device=device)
            got = {}
            with contextlib.closing(batches):
                for b in batches:
                    check(b['id'].device.type == device,
                          'legacy %s: ids on %s' % (name, b['id'].device))
                    for j, i in enumerate(b['id'].tolist()):
                        check(i not in got, 'legacy %s: id %d twice'
                              % (name, i))
                        got[i] = {k: v[j] for k, v in b.items()
                                  if k != '_provenance'}
        check(sorted(got) == list(range(LEGACY_ROWS)),
              'legacy %s: ids %s' % (name, sorted(got)))
        for i, row in got.items():
            want = legacy_expected(np, i)
            image, matrix = row['image_png'], row['matrix']
            if factory is make_batch_reader:
                image = image_field.codec.decode(image_field, image)
                matrix = schema.fields['matrix'].codec.decode(
                    schema.fields['matrix'], matrix)
            else:
                check(image.device.type == device
                      and matrix.device.type == device,
                      'legacy %s: columns not on %s' % (name, device))
                image, matrix = image.cpu().numpy(), matrix.cpu().numpy()
            check(row['sensor_name'] == want['sensor_name']
                  and np.array_equal(image, want['image_png'])
                  and image.dtype == np.uint8
                  and np.array_equal(matrix, want['matrix'])
                  and matrix.dtype == np.float32,
                  'legacy %s: row %d differs from the formula' % (name, i))
        log('legacy %s: %d rows == formula; image_png %r %s'
            % (name, len(got), image_field.codec, image_field.shape))


def jpeg_line(torch, np, kernels, args, device='cuda', rows=IMAGE_ROWS,
              batch=IMAGE_BATCH, size=IMAGE_SIZE, steps=JPEG_STEPS):
    """The image line from a jpeg store with ``decode_hints``: the reduced
    decode against cv2's of the stored bytes, the reader alone with and
    without the hint, then CNN steps on ``device``. Returns the launch
    counts of the steps."""
    import cv2
    import pyarrow.parquet as pq
    from petastorm_tpu_torch import (TorchDataLoader, make_columnar_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.examples.imagenet.generate_imagenet import (
        generate, synthetic_rows)
    from petastorm_tpu_torch.examples.imagenet.main import \
        make_resize_transform
    from petastorm_tpu_torch.models import image_cnn as cnn
    hints = {'image': {'scale': JPEG_SCALE}}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        path = os.path.join(d, 'images_jpeg')
        url = 'file://' + path
        shapes = []

        def recorded():
            for row in synthetic_rows(rows, classes=IMAGE_CLASSES,
                                      seed=args.seed):
                shapes.append(row['image'].shape)
                yield row

        start = time.perf_counter()
        generate(url, recorded(), row_group_size_mb=JPEG_ROW_GROUP_MB,
                 image_codec='jpeg')
        groups = sum(pq.ParquetFile(os.path.join(path, n)).num_row_groups
                     for n in os.listdir(path) if n.endswith('.parquet')
                     and not n.startswith(('_', '.')))
        log('jpeg store %d rows in %d row groups, image (None, None, 3) '
            "uint8 under CompressedImageCodec('jpeg', quality=80), written "
            'in %.2f s' % (rows, groups, time.perf_counter() - start))
        # the stored bytes in file order, as pyarrow reads them
        cells = []
        for name in sorted(os.listdir(path)):
            if name.endswith('.parquet') and not name.startswith(('_', '.')):
                cells.extend(pq.read_table(os.path.join(path, name),
                                           columns=['image'])
                             .column('image').to_pylist())
        with make_columnar_reader(url, schema_fields=['image'],
                                  decode_hints=hints, workers_count=1,
                                  shuffle_row_groups=False) as reader:
            check(reader.schema.fields['image'].shape == (None, None, 3),
                  'jpeg: hinted schema %r' % reader.schema.fields['image'])
            got = [img for b in reader for img in b.image]
        check(len(got) == len(cells) == len(shapes) == rows,
              'jpeg: %d images read, %d stored' % (len(got), len(cells)))
        for k, (img, cell, shape) in enumerate(zip(got, cells, shapes)):
            ref = cv2.cvtColor(cv2.imdecode(np.frombuffer(cell, np.uint8),
                                            cv2.IMREAD_REDUCED_COLOR_2),
                               cv2.COLOR_BGR2RGB)
            want = (-(-shape[0] // JPEG_SCALE), -(-shape[1] // JPEG_SCALE), 3)
            check(img.shape == want and np.array_equal(img, ref),
                  'jpeg: image %d %s differs from cv2 reduced decode %s'
                  % (k, img.shape, ref.shape))
        log('jpeg hinted decode: %d images == cv2.imdecode(IMREAD_REDUCED_'
            'COLOR_2) of the stored bytes, bit for bit, each (ceil h/2, '
            'ceil w/2, 3)' % len(got))
        rates = {}
        for label, kw in (('full decode', {}), ('scale 2', {'decode_hints':
                                                            hints})):
            start = time.perf_counter()
            n = 0
            with make_columnar_reader(url, schema_fields=['image'],
                                      workers_count=IMAGE_WORKERS,
                                      seed=args.seed, **kw) as reader:
                for b in reader:
                    n += len(b.image)
            rates[label] = n / (time.perf_counter() - start)
            check(n == rows, 'jpeg: reader alone read %d of %d' % (n, rows))
        log('jpeg reader alone (%d workers, no model): full decode %.0f '
            'images/s, scale 2 %.0f images/s (%.2fx)'
            % (IMAGE_WORKERS, rates['full decode'], rates['scale 2'],
               rates['scale 2'] / rates['full decode']))

        params = cnn.init(torch.Generator().manual_seed(args.seed),
                          num_classes=IMAGE_CLASSES, device=device)
        step = cnn.make_train_step(params, lr=1e-3)
        losses, times = [], []
        if device == 'cuda':
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with make_columnar_reader(url, num_epochs=None,
                                  workers_count=IMAGE_WORKERS, seed=args.seed,
                                  transform_spec=make_resize_transform(size),
                                  decode_hints=hints) as reader:
            loader = TorchDataLoader(reader, batch_size=batch, drop_last=True,
                                     device=device)
            batches = prefetch_to_device(iter(loader), size=2, device=device)
            with contextlib.closing(batches):
                for _ in range(steps):
                    t0 = time.perf_counter()
                    b = next(batches)
                    images = b['image']
                    check(images.device.type == device
                          and images.dtype == torch.uint8
                          and tuple(images.shape) == (batch, size, size, 3),
                          'jpeg: batch %s %s on %s' % (
                              images.dtype, tuple(images.shape),
                              images.device))
                    losses.append(float(step(images, b['label'])))
                    times.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
    check(all(math.isfinite(x) for x in losses), 'jpeg: non-finite loss')
    steady = statistics.median(times[1:] or times)
    log('jpeg image line %d steps, loss %.4f -> %.4f, steady step %.2f ms, '
        '%.0f images/s, launches %s'
        % (len(losses), losses[0], losses[-1], steady * 1e3, batch / steady,
           json.dumps(launches)))
    return launches


def md5_bucket(value):
    """``in_pseudorandom_split``'s bucket of a value, from hashlib alone."""
    import hashlib
    return (int(hashlib.md5(str(value).encode('utf-8')).hexdigest(), 16)
            / float(1 << 128))


def expected_windows(path, holdout, split):
    """The start steps of the selection line's windows, worked out with
    pyarrow and hashlib alone: per row group, the steps below ``holdout``
    whose bucket lies in [0, ``split``), then each kept step whose
    successor is kept in the same row group (delta_threshold 1)."""
    import pyarrow.parquet as pq
    starts = set()
    for name in sorted(os.listdir(path)):
        if not name.endswith('.parquet') or name.startswith(('_', '.')):
            continue
        f = pq.ParquetFile(os.path.join(path, name))
        for rg in range(f.metadata.num_row_groups):
            steps = f.read_row_group(rg, columns=['step']).column(
                'step').to_pylist()
            kept = {s for s in steps if s < holdout and md5_bucket(s) < split}
            starts.update(s for s in kept if s + 1 in kept)
    return starts


def selection_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
                   rows=ROWS, prompt_len=SEL_PROMPT_LEN, new=SEL_NEW):
    """The flagship LM trained on the NGram line under a hash split,
    residual filters and row-drop partitions, then ``generate`` on held-out
    prompts. Returns ``(launches of the training steps, launches of the
    teacher-forced forward)``."""
    import dataclasses
    from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.predicates import in_pseudorandom_split
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    split = [SEL_SPLIT, 1 - SEL_SPLIT]
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        path = os.path.join(d, 'tokens')
        url = 'file://' + path
        write_store(np, url, cfg.max_seq_len, cfg.vocab_size, rows,
                    args.seed)
        want = expected_windows(path, SEL_HOLDOUT, SEL_SPLIT)

        def reader(**kw):
            return make_reader(
                url, schema_fields=NGram({0: ['step', 'tokens'],
                                          1: ['tokens']}, 1, 'step'),
                predicate=in_pseudorandom_split(split, 0, 'step'),
                filters=[('step', '<', SEL_HOLDOUT)],
                shuffle_row_drop_partitions=SEL_DROP, seed=args.seed,
                workers_count=4, **kw)

        start = time.perf_counter()
        with reader() as r:
            check(not r.ngram_chunked, 'selection: the reader is chunked')
            seen = [int(w[0].step) for w in r]
        alone = time.perf_counter() - start
        check(len(seen) == len(set(seen)) and set(seen) == want,
              'selection: %d windows (%d unique), reckoned %d'
              % (len(seen), len(set(seen)), len(want)))
        log('selection windows: %d, == reckoned, none twice; reader alone '
            '(no model) %.3f s, %.0f windows/s'
            % (len(seen), alone, len(seen) / alone))

        params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                          device=device)
        _, step = tlm.make_train_step(cfg, params)
        losses, times, trained_on = [], [], []
        if device == 'cuda':
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with reader(num_epochs=None) as r:
            loader = TorchDataLoader(r, batch_size=BATCH, drop_last=True,
                                     device=device)
            batches = prefetch_to_device(iter(loader), size=2, device=device)
            with contextlib.closing(batches):
                for _ in range(STEPS):
                    t0 = time.perf_counter()
                    batch = next(batches)
                    tokens = batch[0]['tokens']
                    check(tokens.device.type == device and tuple(tokens.shape)
                          == (BATCH, cfg.max_seq_len),
                          'selection: tokens %s on %s'
                          % (tuple(tokens.shape), tokens.device))
                    nxt = batch[1]['tokens'][:, :1]
                    losses.append(float(step(
                        tokens, torch.cat([tokens[:, 1:], nxt], 1))))
                    if device == 'cuda':
                        torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    trained_on.extend(batch[0]['step'].tolist())
        launches = dict(kernels.LAUNCHES)
        check(all(math.isfinite(x) for x in losses),
              'selection: non-finite loss')
        check(set(trained_on) <= want, 'selection: trained on a window '
              'outside the reckoning')
        steady = statistics.median(times[1:] or times)
        log('selection LM %d steps, loss %.4f -> %.4f, steady step %.2f ms, '
            '%.0f tokens/s, launches %s'
            % (len(losses), losses[0], losses[-1], steady * 1e3,
               BATCH * cfg.max_seq_len / steady, json.dumps(launches)))

        with make_reader(url, schema_fields=['step', 'tokens'],
                         predicate=in_pseudorandom_split(split, 1, 'step'),
                         workers_count=1, shuffle_row_groups=False) as r:
            held = sorted((int(x.step), x.tokens) for x in r)[:SEL_PROMPTS]
    check(len(held) == SEL_PROMPTS
          and all(md5_bucket(s) >= SEL_SPLIT for s, _ in held),
          'selection: held-out prompts %s' % [s for s, _ in held])
    prompts = torch.from_numpy(np.stack([t[:prompt_len] for _, t in held])
                               ).to(device)

    def decode(p, c, **kw):
        gen = torch.Generator(device=device).manual_seed(args.seed)
        if device == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, logits = tlm.generate(p, prompts, c, new, generator=gen,
                                   return_logits=True, **kw)
        if device == 'cuda':
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = prompt_len + new - 1
        check(tuple(out.shape) == (SEL_PROMPTS, new)
              and int(out.min()) >= 0 and int(out.max()) < c.vocab_size
              and bool(torch.isfinite(logits).all()),
              'generate: tokens %s in [%d, %d], finite logits %s'
              % (tuple(out.shape), int(out.min()), int(out.max()),
                 bool(torch.isfinite(logits).all())))
        return out, logits, wall, steps

    def timing(wall, steps):
        return ('%.3f ms per step (one token of each of %d sequences, %d '
                'steps: prompt %d + %d new - 1), %.0f tokens/s, %.0f new '
                'tokens/s' % (wall / steps * 1e3, SEL_PROMPTS, steps,
                              prompt_len, new,
                              SEL_PROMPTS * steps / wall,
                              SEL_PROMPTS * new / wall))

    # greedy on a float32 copy, against the teacher-forced forward
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: ([{n: w.detach().clone() for n, w in layer.items()}
                for layer in v] if k == 'layers' else v.detach().clone())
           for k, v in params.items()}
    kernels.reset_launch_counts()
    out, logits, wall, steps = decode(p32, c32)
    check(not any(kernels.LAUNCHES.values()),
          'generate launched kernels: %r' % kernels.LAUNCHES)
    log('generate float32 greedy: ' + timing(wall, steps))
    with torch.no_grad():
        kernels.reset_launch_counts()
        full = torch.cat([prompts, out], 1)
        forced = tlm.forward(p32, full[:, :-1], c32)[:, prompt_len - 1:]
        forced_launches = dict(kernels.LAUNCHES)
    err = (logits - forced).abs()
    limit = DECODE_TOL * (1 + forced.abs())
    check(not bool((err > limit).any()),
          'generate: decode logits off teacher forcing by %.3g (%d beyond '
          'the limit)' % (float(err.max()), int((err > limit).sum())))
    top2 = forced.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * DECODE_TOL * (
        1 + top2[..., 0].abs())
    agree = out.long() == forced.argmax(-1)
    check(bool(agree[clear].all()),
          'generate: %d greedy tokens differ from the forward argmax where '
          'its margin is clear' % int((~agree & clear).sum()))
    log('generate float32 decode logits == teacher-forced forward (float32 '
        'K1, launches %s): max abs err %.3g (limit 2^-10 (1 + |ref|)); '
        'tokens == forward argmax at %d of %d positions with a clear top-2 '
        'margin, %d in all'
        % (json.dumps(forced_launches), float(err.max()), int(clear.sum()),
           clear.numel(), int(agree.sum())))
    out, logits, wall, steps = decode(params, cfg, temperature=0.8,
                                      top_p=0.9)
    log('generate bf16 sampled (temperature 0.8, top-p 0.9): tokens in '
        'range, logits finite; ' + timing(wall, steps))
    if device == 'cuda':
        # the device's share of a short decode (16 + 8 tokens: 23 steps)
        profile_steps(torch, lambda: tlm.generate(
            params, prompts[:, :16], cfg, 8, temperature=0.8, top_p=0.9,
            generator=torch.Generator(device=device).manual_seed(0)),
            1, 'gemv', 'decode bf16 top-p, 23 steps')
    return launches, forced_launches


# ---------------------------------------------------------------------------
# phase 12: packed MoE line
# ---------------------------------------------------------------------------

def packed_docs(np, seed, n, vocab, median, longest):
    """The packed line's documents, the store's generator formula: lengths
    from a log-normal (``median``, sigma 1) rounded and clipped to
    [``PACKED_MIN_LEN``, ``longest``], token ids uniform in [0, ``vocab``),
    one draw for all documents, cut in order."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(np.rint(rng.lognormal(math.log(median), 1.0, n)),
                      PACKED_MIN_LEN, longest).astype(np.int64)
    flat = rng.integers(0, vocab, int(lengths.sum()), dtype=np.int32)
    return np.split(flat, np.cumsum(lengths)[:-1])


def write_doc_store(np, url, docs):
    from petastorm_tpu_torch import materialize_dataset
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('DocSchema', [
        UnischemaField('doc_id', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (None,), NdarrayCodec(), False)])
    with materialize_dataset(url, schema, row_group_size_mb=1) as w:
        w.write_rows({'doc_id': np.int64(i), 'tokens': doc}
                     for i, doc in enumerate(docs))


def check_doc_store(np, path, docs):
    """The store read with pyarrow alone (``np.load`` of each cell) equals
    the generator's documents; returns the row-group count."""
    import io
    import pyarrow.parquet as pq
    seen, groups = {}, 0
    for name in sorted(os.listdir(path)):
        if name.endswith('.parquet') and not name.startswith(('_', '.')):
            f = pq.ParquetFile(os.path.join(path, name))
            groups += f.metadata.num_row_groups
            table = f.read(columns=['doc_id', 'tokens']).to_pydict()
            for i, cell in zip(table['doc_id'], table['tokens']):
                check(i not in seen, 'packed store: doc %d twice' % i)
                seen[i] = np.load(io.BytesIO(cell))
    check(sorted(seen) == list(range(len(docs)))
          and all(np.array_equal(seen[i], d) and seen[i].dtype == np.int32
                  for i, d in enumerate(docs)),
          'packed store: the pyarrow read differs from the generator')
    return groups


def check_packed_batch(np, batch, docs, seen):
    """Every document of a packed batch is one segment holding its tokens in
    order, at positions 0, 1, ...; ``seen`` collects the doc ids."""
    tokens, seg, pos = (batch[k].cpu().numpy() for k in
                        ('tokens', 'segment_ids', 'positions'))
    want = {docs[int(i)].tobytes(): int(i) for i in batch['doc_id'].tolist()}
    check(len(want) == len(batch['doc_id']), 'packed: duplicate documents')
    for row in range(tokens.shape[0]):
        for s in np.unique(seg[row][seg[row] > 0]):
            mask = seg[row] == s
            key = tokens[row][mask].tobytes()
            check(key in want, 'packed: a segment is no document of the batch')
            i = want.pop(key)
            check(i not in seen, 'packed: document %d twice' % i)
            seen.add(i)
            check(np.array_equal(pos[row][mask], np.arange(mask.sum())),
                  'packed: positions of document %d do not start at 0' % i)
    check(not want, 'packed: %d documents of the batch missing' % len(want))


def packed_gates(torch, np, tlm, cfg, docs, seed, device):
    """Before training, on fresh weights: the sparse MoE FFN against its
    dense oracle on one layer's input (float32), and the packed MoE + GQA
    loss and gradients with the kernels against the plain blockwise path."""
    import dataclasses
    from petastorm_tpu_torch.packing import pack_documents, packed_lm_targets
    L = cfg.max_seq_len
    params = tlm.init(cfg, torch.Generator().manual_seed(seed), device=device)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    packed = pack_documents(docs[:PACKED_BATCH], L, device=device)
    layer = params['layers'][0]
    with torch.no_grad():
        x = params['embed'][packed.tokens.long()]
        x = x + tlm._attention(tlm._rms_norm(x, layer['ln1']), layer, c32,
                               packed.positions, packed.segment_ids)
        h = tlm._rms_norm(x, layer['ln2'])
        stats = {}
        sparse, _ = tlm._moe_ffn(h, layer, dataclasses.replace(
            c32, moe_capacity_factor=8.0), stats=stats)
        dense = tlm._moe_ffn_dense(h, layer, c32)
    err = (sparse - dense).abs()
    check(int(stats['dropped']) == 0
          and not bool((err > 1e-5 * (1 + dense.abs())).any()),
          'packed: sparse MoE FFN off its dense oracle by %.3g (%d dropped)'
          % (float(err.max()), int(stats['dropped'])))
    log('packed gate: sparse MoE FFN == dense oracle on layer 0 of a packed '
        'batch %s (float32, capacity factor 8, 0 dropped): max abs err %.3g '
        '(limit 1e-5 (1 + |ref|))' % (tuple(h.shape), float(err.max())))

    # The router's top-k is discontinuous: bf16 rounding that differs
    # between the two attention paths flips some tokens' second expert, and
    # one flip moves the router's gradient by O(1) (0.36 relative on the
    # card). So the line's top-2 routing is held in float32 (float32
    # K1-K3), and the bf16 tensor-core kernels under a router that
    # consults every expert (top-8: continuous in its inputs, nothing
    # dropped at capacity 1.25).
    short = [d for d in docs if len(d) <= 256][:6 * PACKED_GATE_ROWS]
    small = pack_documents(short, min(L, 512), device=device)
    small = [t[:PACKED_GATE_ROWS] for t in small]
    targets, weights = packed_lm_targets(small[0], small[1])
    for label, c in (('top-2 float32', c32),
                     ('top-%d bf16' % cfg.n_experts, dataclasses.replace(
                         cfg, moe_top_k=cfg.n_experts))):
        results = []
        for mode in ('flash', 'blockwise'):
            leaves = tlm.parameters(params)
            for p in leaves:
                p.grad = None
                p.requires_grad_(True)
            loss = tlm.loss_fn(params, small[0], targets,
                               dataclasses.replace(c, attention=mode),
                               positions=small[2], segment_ids=small[1],
                               weights=weights)
            loss.backward()
            results.append((loss.item(), [p.grad.clone() for p in leaves]))
        (lf, gf), (lb, gb) = results
        rel = max(float((a - b).norm() / (b.norm() + 1e-12))
                  for a, b in zip(gf, gb))
        check(math.isfinite(lf) and abs(lf - lb) < 1e-2 and rel < 5e-2,
              'packed gate %s: flash loss %r vs blockwise %r, gradient rel '
              'err %.3g' % (label, lf, lb, rel))
        log('packed gate: MoE %s + GQA packed loss %s flash %.6f blockwise '
            '%.6f |dL| %.3g, max grad rel err %.3g over %d leaves (tol loss '
            '1e-2, grad 5e-2)' % (label, tuple(small[0].shape), lf, lb,
                                  abs(lf - lb), rel, len(gf)))


def packed_moe_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
                    n_docs=PACKED_DOCS, median=PACKED_MEDIAN,
                    prompt_len=PACKED_PROMPT_LEN, new=PACKED_NEW):
    """The flagship LM with GQA and top-2 MoE trained on packed documents
    through the loader contract (``pad_spec``, ``transform_fn``,
    ``inmemory_cache_all``, goodput), two passes, then its decode. Returns
    ``(launches of the training steps, launches of the teacher-forced
    forward)``."""
    import dataclasses
    from petastorm_tpu_torch import (make_reader, make_torch_loader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.packing import pack_documents, packed_lm_targets
    cfg = cfg or tlm.TransformerConfig(attention='flash', n_kv_heads=2,
                                       n_experts=8, moe_top_k=2)
    L = cfg.max_seq_len
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    docs = packed_docs(np, args.seed, n_docs, cfg.vocab_size, median, L)
    lengths = np.array([len(d) for d in docs])
    packed_gates(torch, np, tlm, cfg, docs, args.seed, device)
    calls = []

    def transform(batch):
        calls.append(1)
        lens = batch['tokens_len'].tolist()
        packed = pack_documents([batch['tokens'][i, :n]
                                 for i, n in enumerate(lens)], L,
                                device='cpu')
        targets, weights = packed_lm_targets(packed.tokens,
                                             packed.segment_ids)
        return {'doc_id': batch['doc_id'], 'tokens': packed.tokens,
                'segment_ids': packed.segment_ids,
                'positions': packed.positions, 'targets': targets,
                'weights': weights}

    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        path = os.path.join(d, 'docs')
        start = time.perf_counter()
        write_doc_store(np, 'file://' + path, docs)
        groups = check_doc_store(np, path, docs)
        log('packed store %d documents (%d tokens, length median %d, mean '
            '%.1f, %d..%d) in %d row groups, written and read back with '
            'pyarrow == generator in %.2f s'
            % (n_docs, lengths.sum(), np.median(lengths), lengths.mean(),
               lengths.min(), lengths.max(), groups,
               time.perf_counter() - start))
        params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                          device=device)
        _, step = tlm.make_train_step(cfg, params)
        n_params = sum(p.numel() for p in tlm.parameters(params))
        sync()
        kernels.reset_launch_counts()
        steps, seen = [], set()
        with make_reader('file://' + path, num_epochs=1, workers_count=4,
                         seed=args.seed) as reader:
            loader = make_torch_loader(
                reader, batch_size=PACKED_BATCH,
                pad_spec={'tokens': {'max_len': L}}, transform_fn=transform,
                inmemory_cache_all=True, device=device)
            goodput = loader.goodput
            for pass_no in (1, 2):
                first = goodput.state()['steps']
                n_calls = len(calls)
                batches = prefetch_to_device(iter(loader), device=device,
                                             goodput=goodput)
                with contextlib.closing(batches):
                    t_end = time.perf_counter()
                    for i, batch in enumerate(batches):
                        t0 = time.perf_counter()
                        stats = {}
                        out = step(batch['tokens'], batch['targets'],
                                   positions=batch['positions'],
                                   segment_ids=batch['segment_ids'],
                                   weights=batch['weights'], moe_stats=stats)
                        t1 = time.perf_counter()
                        goodput.fence(out)
                        t2 = time.perf_counter()
                        rows = batch['tokens'].shape[0]
                        steps.append({
                            'pass': pass_no, 'step': i, 'rows': rows,
                            'loss': float(out), 'aux': float(stats['aux']),
                            'dropped': int(stats['dropped']),
                            'units': rows * L * cfg.moe_top_k
                            * cfg.n_layers,
                            'fill': float(batch['weights'].sum())
                            / (rows * L), 'ms': (t2 - t_end) * 1e3,
                            'split': (t0 - t_end, t1 - t0, t2 - t1)})
                        if pass_no == 2:
                            check_packed_batch(np, batch, docs, seen)
                        t_end = time.perf_counter()
                mine = [x for x in steps if x['pass'] == pass_no]
                for x in mine:
                    log('packed pass %d step %d: %d rows, fill %.3f, loss '
                        '%.4f, aux %.4f, dropped %d of %d units, %.2f ms '
                        '(batch wait %.2f, dispatch %.2f, fence %.2f)'
                        % (pass_no, x['step'], x['rows'], x['fill'],
                           x['loss'], x['aux'], x['dropped'], x['units'],
                           x['ms'], *(t * 1e3 for t in x['split'])))
                log_goodput(goodput, 'packed MoE pass %d' % pass_no, first)
                steady = statistics.median(x['ms'] for x in mine[1:] or mine)
                tokens = sum(x['fill'] * x['rows'] * L for x in mine)
                log('packed pass %d: %d steps, %d transform calls, rows a '
                    'batch %.2f, fill %.3f, units dropped %d of %d, steady '
                    'step %.2f ms, %.0f weighted tokens/s, loss %.4f -> %.4f'
                    % (pass_no, len(mine), len(calls) - n_calls,
                       statistics.mean(x['rows'] for x in mine),
                       statistics.mean(x['fill'] for x in mine),
                       sum(x['dropped'] for x in mine),
                       sum(x['units'] for x in mine), steady,
                       tokens / sum(x['ms'] for x in mine) * 1e3,
                       mine[0]['loss'], mine[-1]['loss']))
                if pass_no == 1:
                    check(len(calls) == len(mine) == n_docs // PACKED_BATCH,
                          'packed: pass 1 took %d batches, %d transform calls'
                          % (len(mine), len(calls)))
                else:
                    check(len(calls) == n_calls and len(mine) == len(
                        [x for x in steps if x['pass'] == 1]),
                          'packed: pass 2 read the reader (%d transform '
                          'calls)' % (len(calls) - n_calls))
            check(reader.last_row_consumed, 'packed: reader not drained')
            try:
                next(reader)
                delivered_more = True
            except StopIteration:
                delivered_more = False
            check(not delivered_more, 'packed: the reader had rows left')
        launches = dict(kernels.LAUNCHES)
    check(seen == set(range(n_docs)),
          'packed: %d of %d documents came back' % (len(seen), n_docs))
    check(all(math.isfinite(x['loss']) and math.isfinite(x['aux'])
              for x in steps), 'packed: non-finite loss')
    check(device != 'cuda'
          or all(launches[k] == cfg.n_layers * len(steps) for k in FLASH),
          'packed: K1-K3 not launched on every step: %r in %d steps'
          % (launches, len(steps)))
    log('packed line: %d float32 parameters, %d steps over 2 passes (pass 2 '
        'from the loader cache, the reader drained), every document once, '
        'in order, positions from 0; launches %s (GQA %d -> %d, segment '
        'ids, L %d)' % (n_params, len(steps), json.dumps(launches),
                        cfg.n_heads, cfg.kv_heads, L))

    prompts = torch.from_numpy(np.stack(
        [d[:prompt_len] for d in docs if len(d) >= prompt_len
         ][:PACKED_PROMPTS])).to(device)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: ([{n: w.detach().clone() for n, w in layer.items()}
                for layer in v] if k == 'layers' else v.detach().clone())
           for k, v in params.items()}

    def decode(p, c, **kw):
        gen = torch.Generator(device=device).manual_seed(args.seed)
        sync()
        t0 = time.perf_counter()
        out, logits = tlm.generate(p, prompts, c, new, generator=gen,
                                   return_logits=True, **kw)
        sync()
        wall = time.perf_counter() - t0
        check(tuple(out.shape) == (len(prompts), new)
              and int(out.min()) >= 0 and int(out.max()) < c.vocab_size
              and bool(torch.isfinite(logits).all()),
              'packed decode: tokens %s, finite logits %s'
              % (tuple(out.shape), bool(torch.isfinite(logits).all())))
        return out, logits, wall / (prompt_len + new - 1)

    out, logits, ms = decode(p32, c32)
    kernels.reset_launch_counts()
    with torch.no_grad():
        full = torch.cat([prompts, out], 1)
        forced = tlm.forward(p32, full[:, :-1], dataclasses.replace(
            c32, moe_capacity_factor=float(cfg.n_experts)))[:, prompt_len - 1:]
    forced_launches = dict(kernels.LAUNCHES)
    err = (logits - forced).abs()
    limit = DECODE_TOL * (1 + forced.abs())
    check(not bool((err > limit).any()),
          'packed decode: logits off teacher forcing by %.3g (%d beyond the '
          'limit)' % (float(err.max()), int((err > limit).sum())))
    top = forced.max(-1).values
    chosen = torch.gather(forced, -1, out.long()[..., None])[..., 0]
    exact = out.long() == forced.argmax(-1)
    tied = (top - chosen) <= 2 * DECODE_TOL * (1 + top.abs())
    check(bool((exact | tied).all()),
          'packed decode: %d greedy tokens are not the forward argmax'
          % int((~(exact | tied)).sum()))
    log('packed decode float32 greedy (%d prompts of %d, %d new): %.3f ms a '
        'step; logits == teacher-forced forward (capacity for every unit, '
        'float32 K1, launches %s) within %.3g (limit 2^-10 (1 + |ref|)); '
        'greedy token == forward argmax at %d of %d, the rest tied within '
        'the limit' % (len(prompts), prompt_len, new, ms * 1e3,
                       json.dumps(forced_launches), float(err.max()),
                       int(exact.sum()), exact.numel()))
    out, logits, ms = decode(params, cfg, temperature=0.8, top_p=0.9)
    log('packed decode bf16 sampled (temperature 0.8, top-p 0.9): tokens in '
        'range, logits finite; %.3f ms a step, %.0f tokens/s'
        % (ms * 1e3, len(prompts) / ms))
    return launches, forced_launches


# ---------------------------------------------------------------------------
# phase 13: columnar token line (device decode, process pool)
# ---------------------------------------------------------------------------

def write_token_rows(np, url, rows, seq_len, vocab, seed, group_mb=None):
    """``idx`` int64 (ScalarCodec) and ``tokens`` int32 ``(seq_len,)``
    (NdarrayCodec, non-nullable) in one file of row groups of about
    ``group_mb`` MB (default :data:`TOKEN_GROUP_MB`); returns the tokens
    written."""
    from petastorm_tpu_torch import materialize_dataset
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('TokenRows', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (seq_len,), NdarrayCodec(),
                       False)])
    tokens = np.random.default_rng(seed).integers(0, vocab, (rows, seq_len),
                                                  dtype=np.int32)
    with materialize_dataset(url, schema,
                             row_group_size_mb=group_mb or TOKEN_GROUP_MB,
                             rows_per_file=rows) as w:
        w.write_rows({'idx': np.int64(i), 'tokens': tokens[i]}
                     for i in range(rows))
    return tokens


def token_pass(torch, np, url, tokens, pool, switch, device, batch,
               label='token', workers=TOKEN_WORKERS, audit=False,
               **reader_kw):
    """One epoch of ``make_columnar_reader(**reader_kw)`` (unshuffled) ->
    ``TorchDataLoader`` -> ``iter_prefetched`` with ``pool``, ``workers``
    and the device-decode switch: the reader's plans, what was staged, the
    rows against the generator, and the pass's rows/s. With ``audit``, each
    batch holds ``'_provenance'`` exactly when the reader's lineage is on,
    and then the pass's coverage audit is complete. Returns ``{'rate':
    rows/s, 'grid': a staged grid, 'fused': the loader's decode, 'order':
    the delivered idx, 'staged': (dtype, shape, device, bytes) a batch,
    'tallies': the thread workers' readahead (hits, misses) or None,
    'diagnostics': the reader's stats snapshot after the pass, 'tracer':
    its tracer, 'pids': its worker processes' pids, 'store': (reads,
    bytes) of the thread workers' chaos-wrapped filesystems, or None}``."""
    from petastorm_tpu_torch import TorchDataLoader, make_columnar_reader
    from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
    os.environ[DEVICE_DECODE_ENV_VAR] = switch
    label = '%s %s pool, device decode %s' % (label, pool, switch)
    # (dtype, shape, device type) of what the staging handed the decode,
    # and the last grid: keeping every grid alive would make the caching
    # allocator grow through the pass
    staged, last = [], {}
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    start = time.perf_counter()
    with make_columnar_reader(url, num_epochs=1, shuffle_row_groups=False,
                              workers_count=workers, reader_pool_type=pool,
                              **reader_kw) as reader:
        opened = time.perf_counter()
        plans = reader.device_decode_plans
        declined = reader.device_decode_declined
        if switch == 'on':
            check(set(plans) == {'tokens'} and 'idx' in declined,
                  '%s: plans %s, declined %s' % (label, set(plans), declined))
        else:
            check(not plans and '*' in declined,
                  '%s: plans %s, declined %s' % (label, set(plans), declined))
        loader = TorchDataLoader(reader, batch_size=batch, device=device)
        fused = loader._fused
        if fused is not None:
            def spy(columns):            # what the staging handed the decode
                grid = last['grid'] = columns['tokens']
                staged.append((grid.dtype, tuple(grid.shape),
                               grid.device.type, grid.nbytes))
                return fused(columns)
            loader._fused = spy
        got_tokens, got_idx, nbytes = [], [], 0
        for b in loader.iter_prefetched():
            if audit:
                check(('_provenance' in b) == reader.lineage.enabled,
                      '%s: provenance %s with lineage %s'
                      % (label, '_provenance' in b, reader.lineage.enabled))
            if not got_tokens:
                first = time.perf_counter()
                nbytes = (staged[0][3] if staged else b['tokens'].nbytes) \
                    + b['idx'].nbytes
            got_tokens.append(b['tokens'])
            got_idx.append(b['idx'])
        sync()
        end = time.perf_counter()
        wall = end - opened
        readaheads = [w.readahead.tallies()
                      for w in getattr(reader._pool, 'workers', [])
                      if w.readahead is not None]
        diagnostics = reader.diagnostics
        tracer = reader.tracer
        pids = {p.pid for p in getattr(reader._pool, '_processes', [])}
        if audit and reader.lineage.enabled:
            report = reader.audit().assert_complete()
            check(report['epochs'][0]['rows_delivered'] == len(tokens),
                  '%s: audit %s' % (label, report['epochs'][0]))
        # the store reads the workers' filesystems counted (a chaos
        # wrapper counts; a thread worker's only: a process's is its own)
        filesystems = [w.filesystem for w in getattr(reader._pool, 'workers',
                                                     [])]
        store = ((sum(f.read_calls for f in filesystems),
                  sum(f.bytes_read for f in filesystems))
                 if filesystems and all(hasattr(f, 'read_calls')
                                        for f in filesystems) else None)
    tallies = (sum(t['readahead_hits'] for t in readaheads),
               sum(t['readahead_misses'] for t in readaheads)) \
        if readaheads else None
    rows = sum(len(t) for t in got_tokens)
    check(rows == len(tokens), '%s: %d rows of %d' % (label, rows,
                                                       len(tokens)))
    check(all(t.device.type == device and t.dtype == torch.int32
              for t in got_tokens),
          '%s: tokens %s on %s' % (label, got_tokens[0].dtype,
                                   got_tokens[0].device))
    if switch == 'on':
        stride = plans['tokens'].stride
        check(len(staged) == len(got_tokens) and all(
            g[:3] == (torch.uint8, (len(t), stride), device)
            for g, t in zip(staged, got_tokens)),
            '%s: the staging decoded %d of %d batches, first %s'
            % (label, len(staged), len(got_tokens), staged[0][:3]))
    idx = torch.cat(got_idx).cpu().numpy()
    order = np.argsort(idx, kind='stable')
    host = torch.cat(got_tokens).cpu().numpy()[order]
    check(np.array_equal(idx[order], np.arange(len(tokens)))
          and host.tobytes() == tokens.tobytes(),
          '%s: rows differ from the generator' % label)
    log('%s: %d rows in %.3f s, %.0f rows/s (first batch after %.3f s, '
        'then %.0f rows/s; reader opened in %.2f s); staged %d bytes a batch '
        '(%s)%s; == generator bit for bit'
        % (label, rows, wall, rows / wall, first - opened,
           (rows - len(got_tokens[0])) / (end - first), opened - start,
           nbytes,
           'uint8 grid (%d, %d) decoded on %s' % (batch, stride, device)
           if switch == 'on' else 'decoded int32 tokens',
           '; readahead hits %d, misses %d' % tallies if tallies else ''))
    return {'rate': rows / wall, 'grid': last.get('grid'), 'fused': fused,
            'order': idx, 'staged': staged, 'tallies': tallies,
            'diagnostics': diagnostics, 'tracer': tracer, 'pids': pids,
            'store': store}


def decode_kernel_us(torch, fused, grid, n):
    """Device time of the decode's kernels a call, in us: ``n`` calls under
    ``torch.profiler``, the CUDA kernels' self time summed over ``n``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fused({'tokens': grid})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fused({'tokens': grid})
        torch.cuda.synchronize()
    total = sum(getattr(e, 'self_device_time_total', None)
                or getattr(e, 'self_cuda_time_total', 0)
                for e in prof.key_averages()
                if getattr(e, 'device_type', None) == DeviceType.CUDA)
    check(total > 0, 'the profiler saw no device time of the decode')
    return total / n


@contextlib.contextmanager
def sample_threads(tally, interval=0.002):
    """Sample every other thread's Python stack each ``interval`` s while
    the block runs: ``tally[role][where]`` counts the samples, ``role``
    being the thread's name (the pool's worker threads pooled as
    ``workers``) and ``where`` the innermost frame of this repo, with the
    innermost frame outside it when that differs (a wait, a torch call)."""
    import threading
    stop = threading.Event()
    repo = os.path.join(ROOT, '')

    def where(frame):
        leaf, own = frame, None
        while frame is not None and own is None:
            if frame.f_code.co_filename.startswith(repo):
                own = frame
            frame = frame.f_back
        name = '%s:%d %s' % (os.path.basename(own.f_code.co_filename),
                             own.f_lineno, own.f_code.co_name) if own else '-'
        if leaf is not own:
            name += ' > %s %s' % (os.path.basename(leaf.f_code.co_filename),
                                  leaf.f_code.co_name)
        return name

    def run():
        me = threading.get_ident()
        while not stop.wait(interval):
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                role = names.get(ident, '?')
                if role.startswith('petastorm-torch-worker'):
                    role = 'workers'
                counts = tally.setdefault(role, {})
                key = where(frame)
                counts[key] = counts.get(key, 0) + 1

    sampler = threading.Thread(target=run, name='smoke-sampler',
                               daemon=True)
    sampler.start()
    try:
        yield tally
    finally:
        stop.set()
        sampler.join()


def token_thread_profile(torch, np, url, tokens, device):
    """Where the host time of the thread pool's token passes goes, decode
    on against off: passes in the order on, off, off, on under the default
    GIL switch interval, then on, off under 0.5 ms, each with the process's
    CPU seconds a batch (``getrusage``) and the share of each thread's
    samples by frame (``sample_threads``, top 8 a thread to standard
    error, the top 3 of the staging thread to the log)."""
    import resource
    default = sys.getswitchinterval()
    for switch, interval in (('on', default), ('off', default),
                             ('off', default), ('on', default),
                             ('on', 0.0005), ('off', 0.0005)):
        sys.setswitchinterval(interval)
        tally = {}
        before = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        try:
            with sample_threads(tally):
                token_pass(torch, np, url, tokens, 'thread', switch, device,
                           TOKEN_BATCH)
        finally:
            sys.setswitchinterval(default)
        wall = time.perf_counter() - t0
        after = resource.getrusage(resource.RUSAGE_SELF)
        cpu = (after.ru_utime - before.ru_utime
               + after.ru_stime - before.ru_stime)
        batches = len(tokens) // TOKEN_BATCH
        label = 'token profile, thread pool, decode %s, switch interval ' \
            '%.4f s' % (switch, interval)
        print('%s: wall %.3f s, process CPU %.3f s (%.4f ms a batch), '
              'context switches %d voluntary, %d involuntary'
              % (label, wall, cpu, cpu / batches * 1e3,
                 after.ru_nvcsw - before.ru_nvcsw,
                 after.ru_nivcsw - before.ru_nivcsw), file=sys.stderr)
        tops = {}
        for role in sorted(tally):
            counts = tally[role]
            n = sum(counts.values())
            top = sorted(counts.items(), key=lambda kv: -kv[1])[:8]
            tops[role] = top
            print('  %s, %d samples:' % (role, n), file=sys.stderr)
            for key, c in top:
                print('    %5.1f%%  %s' % (100 * c / n, key), file=sys.stderr)
        stage = tops.get('petastorm-torch-prefetch', [])
        n = sum(tally.get('petastorm-torch-prefetch', {}).values()) or 1
        log('%s: wall %.3f s, process CPU %.4f ms a batch; staging thread '
            '%s' % (label, wall, cpu / batches * 1e3, '; '.join(
                '%.1f%% %s' % (100 * c / n, k) for k, c in stage[:3])))


def token_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
               rows=TOKEN_ROWS, image_rows=IMAGE_ROWS, steps=TOKEN_STEPS):
    """The columnar token line: the store; the reader + loader alone under
    the thread and process pools with device decode on and off; the decode's
    device time; 5 LM steps from the process pool's device-decoded batches
    through a device ``TransformSpec``; and the png image store's reader
    alone under 8 processes against 8 threads. Returns the launch counts of
    the LM steps."""
    from petastorm_tpu_torch import (TorchDataLoader, TransformSpec,
                                     make_columnar_reader)
    from petastorm_tpu_torch.examples.imagenet.generate_imagenet import (
        generate, synthetic_rows)
    from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    seq = cfg.max_seq_len + 1
    saved = os.environ.get(DEVICE_DECODE_ENV_VAR)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix='.smoke-store-') as d:
            url = 'file://' + os.path.join(d, 'token_rows')
            start = time.perf_counter()
            tokens = write_token_rows(np, url, rows, seq, cfg.vocab_size,
                                      args.seed)
            log('token store %d rows x %d int32 tokens (%.1f M tokens, %.1f '
                'MB) written in %.2f s'
                % (rows, seq, rows * seq / 1e6, tokens.nbytes / 1e6,
                   time.perf_counter() - start))
            # the process's first pass imports pandas (through pyarrow's
            # to_numpy) and initialises torch's views: pay that once here,
            # outside the passes that are compared
            log('token warm-up pass (not compared):')
            token_pass(torch, np, url, tokens, 'thread', 'on', device,
                       TOKEN_BATCH)
            rates, grid, fused = {}, None, None
            for pool in ('thread', 'process'):
                for switch in ('on', 'off'):
                    got = token_pass(torch, np, url, tokens, pool, switch,
                                     device, TOKEN_BATCH)
                    rates[pool, switch] = got['rate']
                    if got['grid'] is not None:
                        grid, fused = got['grid'], got['fused']
            log('token reader + loader alone, rows/s: %s' % ', '.join(
                '%s/%s %.0f' % (p, s, r) for (p, s), r in rates.items()))
            if device == 'cuda':
                ms = time_ms(torch, lambda: fused({'tokens': grid}), 200)
                kernel_us = decode_kernel_us(torch, fused, grid, 200)
                log('token decode on the card: %.4f ms a batch of %d rows '
                    'between CUDA events around one call (median of 200, '
                    'grid %s); its kernels %.2f us a call of device time '
                    '(profiler, 200 calls)'
                    % (ms, TOKEN_BATCH, tuple(grid.shape), kernel_us))
                if args.profile:
                    token_thread_profile(torch, np, url, tokens, device)

            os.environ[DEVICE_DECODE_ENV_VAR] = 'on'
            spec = TransformSpec(
                lambda c: dict(c, tokens=c['tokens'].to(torch.int64)),
                edit_fields=[('tokens', np.int64, (seq,), False)],
                device=True)
            params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                              device=device)
            _, step = tlm.make_train_step(cfg, params)
            losses = []
            if device == 'cuda':
                torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with make_columnar_reader(url, num_epochs=None,
                                      workers_count=TOKEN_WORKERS,
                                      reader_pool_type='process',
                                      transform_spec=spec,
                                      seed=args.seed) as reader:
                check(set(reader.device_decode_plans) == {'tokens'},
                      'token LM: plans %s' % reader.device_decode_plans)
                loader = TorchDataLoader(reader, batch_size=TOKEN_BATCH,
                                         drop_last=True, device=device)
                batches = loader.iter_prefetched()
                with contextlib.closing(batches):
                    for i in range(steps):
                        t0 = time.perf_counter()
                        b = next(batches)['tokens']
                        check(b.device.type == device
                              and b.dtype == torch.int64
                              and tuple(b.shape) == (TOKEN_BATCH, seq),
                              'token LM batch %s %s on %s'
                              % (b.dtype, tuple(b.shape), b.device))
                        loss = float(loader.goodput.fence(
                            step(b[:, :-1], b[:, 1:])))
                        losses.append(loss)
                        log('token LM step %d loss %.6f time %.2f ms'
                            % (i, loss, (time.perf_counter() - t0) * 1e3))
                launches = dict(kernels.LAUNCHES)
            check(all(math.isfinite(x) for x in losses),
                  'token LM: non-finite loss')
            log('token LM %d steps from the process pool, decoded on the '
                'card, tokens cast to int64 by a device TransformSpec: loss '
                '%.4f -> %.4f, launches %s'
                % (len(losses), losses[0], losses[-1], json.dumps(launches)))

            url = 'file://' + os.path.join(d, 'images_png')
            start = time.perf_counter()
            generate(url, synthetic_rows(image_rows, classes=IMAGE_CLASSES,
                                         seed=args.seed),
                     row_group_size_mb=8, image_codec='png')
            log('png store %d images written in %.2f s'
                % (image_rows, time.perf_counter() - start))
            for pool in ('process', 'thread'):
                start = time.perf_counter()
                with make_columnar_reader(url, schema_fields=['image'],
                                          workers_count=IMAGE_WORKERS,
                                          reader_pool_type=pool, num_epochs=2,
                                          seed=args.seed) as reader:
                    opened = time.perf_counter()
                    n, marks = 0, []
                    for b in reader:
                        n += len(b.image)
                        if n >= image_rows * (len(marks) + 1):
                            marks.append(time.perf_counter())
                check(n == 2 * image_rows and len(marks) == 2,
                      'png %s pool read %d of %d' % (pool, n, 2 * image_rows))
                log('png reader alone, %d %s workers: epoch 1 %.0f images/s, '
                    'epoch 2 %.0f images/s (%d images each; reader opened in '
                    '%.2f s)' % (IMAGE_WORKERS, pool,
                                 image_rows / (marks[0] - opened),
                                 image_rows / (marks[1] - marks[0]),
                                 image_rows, opened - start))
    finally:
        if saved is None:
            os.environ.pop(DEVICE_DECODE_ENV_VAR, None)
        else:
            os.environ[DEVICE_DECODE_ENV_VAR] = saved
    return launches


# ---------------------------------------------------------------------------
# phase 14: the cache and readahead line
# ---------------------------------------------------------------------------

CACHE_EPOCHS = 3                  # image epochs: one fills, two hit
CACHE_LIMIT = 4 << 30             # tier 1's budget (disk)
IMAGE_TIER0 = 1 << 30             # tier 0 of the image line, at most
SPILL_TIER0 = 24 << 20            # tier 0 of the spill passes, at most:
                                  # a third of a token pass's raw grids
CACHE_WORKERS = (1, 4)            # thread workers of the readahead passes


def shm_free_bytes():
    """Free bytes of ``/dev/shm``, where tier 0 lives; 0 without one."""
    try:
        st = os.statvfs('/dev/shm')
    except OSError:
        return 0
    return st.f_bavail * st.f_frsize


def row_groups(path):
    import pyarrow.parquet as pq
    return sum(pq.ParquetFile(os.path.join(path, n)).num_row_groups
               for n in os.listdir(path)
               if n.endswith('.parquet') and not n.startswith(('_', '.')))


class SharedRoots:
    """The shared-cache roots of the phase, each fresh; :meth:`remove`
    deletes their tier-0 directories (a root's own directory goes with the
    phase's temporary directory)."""

    def __init__(self, d):
        self.d, self.roots = d, []

    def kw(self, name, tier0):
        """Reader arguments of a fresh root whose tier 0 holds at most
        ``tier0`` bytes and a quarter of the free ``/dev/shm`` (attached
        segments stay pinned past the budget, up to 16 an instance)."""
        root = os.path.join(self.d, name)
        self.roots.append(root)
        free = shm_free_bytes()
        mem = min(tier0, free // 4) if free >= 4 else tier0
        return root, dict(cache_type='shared', cache_location=root,
                          cache_size_limit=CACHE_LIMIT,
                          cache_extra_settings={'mem_size_limit_bytes': mem})

    @staticmethod
    def counters(root):
        from petastorm_tpu_torch.sharedcache import SharedRowGroupCache
        return SharedRowGroupCache.global_counters(root)

    @staticmethod
    def tier_bytes(root, kw):
        """``(tier 0, tier 1)`` bytes held under ``root``."""
        from petastorm_tpu_torch.sharedcache import SharedRowGroupCache
        cache = SharedRowGroupCache(root, CACHE_LIMIT,
                                    **kw['cache_extra_settings'])
        try:
            return cache.tier_bytes()
        finally:
            cache.close()

    def remove(self):
        """Delete the tier-0 directories of the roots made so far."""
        import shutil
        from petastorm_tpu_torch.sharedcache import SharedRowGroupCache
        for root in self.roots:
            shutil.rmtree(SharedRowGroupCache._default_mem_dir(
                os.path.abspath(root)), ignore_errors=True)
        self.roots = []


def write_indexed_images(np, url, rows, seed, group_mb=8):
    """The image line's png rows (256 synthetic 375 x 500 images) under the
    ImageNet schema with an ``idx`` field, in row groups of about
    ``group_mb`` MB."""
    from petastorm_tpu_torch import materialize_dataset
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.examples.imagenet.generate_imagenet import \
        synthetic_rows
    from petastorm_tpu_torch.examples.imagenet.schema import \
        make_imagenet_schema
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('ImagenetIdx', list(
        make_imagenet_schema('png').fields.values()) + [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False)])
    with materialize_dataset(url, schema, row_group_size_mb=group_mb) as w:
        w.write_rows(dict(row, idx=np.int64(i)) for i, row in enumerate(
            synthetic_rows(rows, classes=IMAGE_CLASSES, seed=seed)))


def cached_image_line(torch, np, kernels, args, d, roots, device, rows,
                      batch, size, workers):
    """The png image line on a shared cache: ``CACHE_EPOCHS`` epochs of the
    CNN, a reader each on one fresh root, ``io_readahead='auto'``; epoch 1
    fills a segment a row group, the later epochs only hit and give epoch
    1's images bit for bit (by ``idx``); then a process-pool reader on the
    root adds no fill and gives the same images. Returns the launch counts
    of the CNN steps."""
    from petastorm_tpu_torch import (TorchDataLoader, TransformSpec,
                                     make_columnar_reader, prefetch_to_device)
    from petastorm_tpu_torch.examples.imagenet.main import \
        make_resize_transform
    from petastorm_tpu_torch.models import image_cnn as cnn
    path = os.path.join(d, 'images_idx')
    url = 'file://' + path
    start = time.perf_counter()
    write_indexed_images(np, url, rows, args.seed)
    groups = row_groups(path)
    log('cache image store %d png rows (+ idx) in %d row groups, written '
        'in %.2f s' % (rows, groups, time.perf_counter() - start))
    resize = make_resize_transform(size)
    spec = TransformSpec(resize.func, edit_fields=resize.edit_fields,
                         selected_fields=['idx', 'image', 'label'])
    root, kw = roots.kw('image_cache', IMAGE_TIER0)
    params = cnn.init(torch.Generator().manual_seed(args.seed),
                      num_classes=IMAGE_CLASSES, device=device)
    step = cnn.make_train_step(params, lr=1e-3)
    ref = torch.zeros((rows, size, size, 3), dtype=torch.uint8,
                      device=device)
    steps = 0
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for epoch in range(1, CACHE_EPOCHS + 1):
        times, seen = [], []
        with make_columnar_reader(url, num_epochs=1, workers_count=workers,
                                  seed=args.seed + epoch,
                                  transform_spec=spec, io_readahead='auto',
                                  **kw) as reader:
            loader = TorchDataLoader(reader, batch_size=batch, device=device)
            batches = prefetch_to_device(iter(loader), size=2, device=device)
            with contextlib.closing(batches):
                for b in iter(lambda: next(batches, None), None):
                    t1 = time.perf_counter()
                    loss = float(step(b['image'], b['label']))
                    t2 = time.perf_counter()
                    times.append((t1, t2))
                    idx = b['idx']
                    if epoch == 1:
                        ref[idx] = b['image']
                    else:
                        check(torch.equal(b['image'], ref[idx]),
                              'cache image epoch %d: images differ from '
                              "epoch 1's" % epoch)
                    seen.append(idx.cpu())
                    steps += 1
        check(math.isfinite(loss), 'cache image: non-finite loss')
        seen = torch.cat(seen).numpy()
        check(np.array_equal(np.sort(seen), np.arange(rows)),
              'cache image epoch %d: %d images, not each once'
              % (epoch, len(seen)))
        c = roots.counters(root)
        want_hits = groups * (epoch - 1)
        check(c.get('fills') == groups and c.get('hits') == want_hits,
              'cache image epoch %d: fills %s, hits %s (want %d, %d)'
              % (epoch, c.get('fills'), c.get('hits'), groups, want_hits))
        # a step's time: from the end of the previous step (the batch wait
        # included) to its loss on the host
        step_s = [t2 - t1 for t1, t2 in times]
        whole = [b - a for (_, a), (_, b) in zip(times, times[1:])]
        log('cache image epoch %d: %d images, %d steps, median step %.2f ms '
            '(with the batch wait %s ms), %.0f images/s over the steps '
            'after the first; fills %d, hits %d'
            % (epoch, len(seen), len(times), statistics.median(step_s) * 1e3,
               '%.2f' % (statistics.median(whole) * 1e3) if whole else 'n/a',
               batch * len(whole) / sum(whole) if whole else float('nan'),
               c['fills'], c['hits']))
    launches = dict(kernels.LAUNCHES)
    if device == 'cuda':
        check(launches['normalize'] == steps,
              'K4 launched %d times in %d cached image steps'
              % (launches['normalize'], steps))
    # the step alone, on a batch on the card with the reader gone
    images, labels = ref[:batch], torch.arange(batch, device=device) % \
        IMAGE_CLASSES
    alone = []
    for _ in range(4):
        t0 = time.perf_counter()
        float(step(images, labels))
        alone.append(time.perf_counter() - t0)
    host_ref = ref.cpu().numpy()
    start = time.perf_counter()
    n = 0
    with make_columnar_reader(url, num_epochs=1, workers_count=workers,
                              reader_pool_type='process', transform_spec=spec,
                              io_readahead='auto', **kw) as reader:
        for b in reader:
            check(np.array_equal(b.image, host_ref[b.idx]),
                  'cache image process pool: images differ from epoch 1')
            n += len(b.idx)
    c = roots.counters(root)
    check(n == rows and c['fills'] == groups
          and c['hits'] == groups * CACHE_EPOCHS,
          'cache image process pool: %d images, fills %d, hits %d'
          % (n, c['fills'], c['hits']))
    tier0, tier1 = roots.tier_bytes(root, kw)
    log('cache image: step alone %.2f ms; process-pool reader (%d '
        'workers) %d images == epoch 1, %.2f s, fills +0; tier 0 %d bytes, '
        'tier 1 %d bytes (tier-0 budget %d)'
        % (statistics.median(alone[1:]) * 1e3, workers, n,
           time.perf_counter() - start, tier0, tier1,
           kw['cache_extra_settings']['mem_size_limit_bytes']))
    return launches


def cached_token_line(torch, np, tlm, kernels, args, d, roots, device, cfg,
                      rows, steps):
    """The columnar token store read ahead and through the shared cache:
    readahead passes; the two representations (raw grids, decoded arrays)
    on one root; a tier 0 below the working set (spill and promotion); 5
    LM steps from the cached raw grids decoded on the card. Returns the
    launch counts of the LM steps and the store's url and tokens."""
    from petastorm_tpu_torch import (TorchDataLoader, TransformSpec,
                                     make_columnar_reader)
    seq = cfg.max_seq_len + 1
    path = os.path.join(d, 'token_rows')
    url = 'file://' + path
    tokens = write_token_rows(np, url, rows, seq, cfg.vocab_size, args.seed)
    groups = row_groups(path)
    log('cache token store %d rows x %d int32 in %d row groups'
        % (rows, seq, groups))
    passes = {}
    for workers in CACHE_WORKERS:
        for depth in (0, 2, 'auto'):
            passes[workers, depth] = token_pass(
                torch, np, url, tokens, 'thread', 'on', device, TOKEN_BATCH,
                'cache token %d workers, io_readahead=%r,' % (workers, depth),
                workers, io_readahead=depth)
    for depth in (2, 'auto'):
        one = passes[1, depth]
        check(np.array_equal(one['order'], passes[1, 0]['order'])
              and one['tallies'] == (groups, 0),
              'cache token 1 worker, io_readahead=%r: order or tallies %s'
              % (depth, one['tallies']))
    for workers in CACHE_WORKERS[1:]:
        check(passes[workers, 2]['tallies'][0] > 0,
              'cache token %d workers: no readahead hit' % workers)
    passes['process', 2] = token_pass(
        torch, np, url, tokens, 'process', 'on', device, TOKEN_BATCH,
        'cache token io_readahead=2,', io_readahead=2)
    log('cache token rows/s: %s' % ', '.join(
        '%s/%r %.0f' % (w, r, p['rate']) for (w, r), p in passes.items()))

    # raw grids (decode on) and decoded arrays (off) on one root
    root, kw = roots.kw('token_cache', CACHE_LIMIT)
    stride = None
    for switch in ('on', 'off'):
        for label in ('fill', 'hit'):
            before = roots.counters(root)
            got = token_pass(
                torch, np, url, tokens, 'thread', switch, device, TOKEN_BATCH,
                'cache token shared, %s pass,' % label, io_readahead=2, **kw)
            after = roots.counters(root)
            fills = after.get('fills', 0) - before.get('fills', 0)
            hits = after.get('hits', 0) - before.get('hits', 0)
            check((fills, hits) == ((groups, 0) if label == 'fill'
                                    else (0, groups)),
                  'cache token decode %s %s pass: fills %d, hits %d'
                  % (switch, label, fills, hits))
            if switch == 'on':      # token_pass checked each staged grid
                stride = got['staged'][0][1][1]
    c = roots.counters(root)
    check(c['fills'] == 2 * groups,
          'cache token: fills %d over both representations, not %d'
          % (c['fills'], 2 * groups))
    log('cache token shared: fills %d = 2 x %d row groups (raw grids and '
        'decoded arrays never serve each other), hits %d; the staged grid '
        '(%d, %s) uint8 came from a hit; tier 0 %d, tier 1 %d bytes'
        % (c['fills'], groups, c['hits'], TOKEN_BATCH, stride,
           *roots.tier_bytes(root, kw)))

    # tier 0 below the working set: segments spill to disk, come back
    # (one worker: two would race a promotion against a spill of the same
    # segment, which may fill it again; the count gates below are exact)
    spill_root, spill_kw = roots.kw('spill_cache', SPILL_TIER0)
    for label in ('fill', 'hit'):
        token_pass(torch, np, url, tokens, 'thread', 'on', device,
                   TOKEN_BATCH, 'cache token spill, %s pass,' % label, 1,
                   io_readahead=2, **spill_kw)
    c = roots.counters(spill_root)
    check(c['fills'] == groups and c['hits'] == groups and c['spills'] > 0,
          'cache token spill: %r' % c)
    log('cache token spill: tier 0 of %d bytes; fills %d, hits %d, spills '
        '%d, evictions %d; tier 0 %d, tier 1 %d bytes'
        % (spill_kw['cache_extra_settings']['mem_size_limit_bytes'],
           c['fills'], c['hits'], c['spills'], c['evictions'],
           *roots.tier_bytes(spill_root, spill_kw)))

    # the LM from the cached raw grids, decoded on the card (the spill
    # passes left device decode on)
    spec = TransformSpec(
        lambda cols: dict(cols, tokens=cols['tokens'].to(torch.int64)),
        edit_fields=[('tokens', np.int64, (seq,), False)], device=True)
    params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                      device=device)
    _, step = tlm.make_train_step(cfg, params)
    losses = []
    fills = roots.counters(root)['fills']
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with make_columnar_reader(url, num_epochs=None, workers_count=TOKEN_WORKERS,
                              transform_spec=spec, io_readahead=2,
                              seed=args.seed, **kw) as reader:
        loader = TorchDataLoader(reader, batch_size=TOKEN_BATCH,
                                 drop_last=True, device=device)
        batches = loader.iter_prefetched()
        with contextlib.closing(batches):
            for i in range(steps):
                t0 = time.perf_counter()
                b = next(batches)['tokens']
                check(b.device.type == device and b.dtype == torch.int64
                      and tuple(b.shape) == (TOKEN_BATCH, seq),
                      'cache token LM batch %s %s' % (b.dtype,
                                                      tuple(b.shape)))
                losses.append(float(loader.goodput.fence(
                    step(b[:, :-1], b[:, 1:]))))
                log('cache token LM step %d loss %.6f time %.2f ms'
                    % (i, losses[-1], (time.perf_counter() - t0) * 1e3))
        launches = dict(kernels.LAUNCHES)
    check(all(math.isfinite(x) for x in losses), 'cache token LM: non-finite')
    check(roots.counters(root)['fills'] == fills,
          'cache token LM: its batches were not all hits')
    log('cache token LM %d steps from cached raw grids decoded on %s: loss '
        '%.4f -> %.4f, launches %s' % (len(losses), device, losses[0],
                                       losses[-1], json.dumps(launches)))
    return launches, url, tokens


def local_cache_and_kill_switch(torch, np, args, d, roots, token_url, tokens,
                                mnist_rows):
    """The MNIST row line for 2 epochs on a local-disk cache (``'rowgroup'``
    payloads), an NGram pass twice (``'ngram_cols'``), and a shared-cache
    pass under the kill switch, which leaves no file."""
    from petastorm_tpu_torch import make_columnar_reader, make_reader
    from petastorm_tpu_torch.examples.mnist.main import \
        generate_synthetic_mnist
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.sharedcache import (SHARED_CACHE_ENV_VAR,
                                                 SharedRowGroupCache)
    url = 'file://' + os.path.join(d, 'mnist')
    generate_synthetic_mnist(url, n=mnist_rows, seed=args.seed)
    local = dict(cache_type='local-disk', cache_size_limit=CACHE_LIMIT)
    start = time.perf_counter()
    epochs = []
    with make_reader(url, workers_count=4, seed=args.seed,
                     cache_location=os.path.join(d, 'mnist_cache'),
                     **local) as reader:
        for epoch in range(2):
            if epoch:
                reader.reset()
            epochs.append({int(r.idx): (int(r.digit), r.image.tobytes())
                           for r in reader})
    check(len(epochs[0]) == mnist_rows and epochs[0] == epochs[1],
          'cache MNIST: epoch 2 differs from epoch 1')
    log('cache MNIST row line, local-disk: 2 epochs of %d rows, epoch 2 == '
        'epoch 1, %.2f s' % (mnist_rows, time.perf_counter() - start))
    start = time.perf_counter()
    passes = []
    with make_reader(token_url, schema_fields=NGram({0: ['idx', 'tokens'],
                                                     1: ['idx']}, 1, 'idx'),
                     workers_count=4, seed=args.seed,
                     cache_location=os.path.join(d, 'ngram_cache'),
                     **local) as reader:
        for i in range(2):
            if i:
                reader.reset()
            got = {}
            for chunk in reader.iter_ngram_chunks():
                cols = chunk.columns
                for s in chunk.starts:
                    got[int(cols['idx'][s])] = cols['tokens'][s].tobytes()
            passes.append(got)
    check(passes[0] == passes[1] and len(passes[0]) > 0 and all(
        v == tokens[k].tobytes() for k, v in passes[0].items()),
        'cache NGram: the second pass differs')
    log('cache NGram, local-disk: %d windows twice, equal, %.2f s'
        % (len(passes[0]), time.perf_counter() - start))
    killed = os.path.join(d, 'killed_cache')
    saved = os.environ.get(SHARED_CACHE_ENV_VAR)
    os.environ[SHARED_CACHE_ENV_VAR] = '0'
    try:
        with make_columnar_reader(token_url, num_epochs=1, workers_count=4,
                                  cache_type='shared', cache_location=killed,
                                  cache_size_limit=CACHE_LIMIT) as reader:
            n = sum(len(b.idx) for b in reader)
    finally:
        if saved is None:
            os.environ.pop(SHARED_CACHE_ENV_VAR, None)
        else:
            os.environ[SHARED_CACHE_ENV_VAR] = saved
    check(n == len(tokens) and not os.path.exists(killed)
          and not os.path.exists(SharedRowGroupCache._default_mem_dir(
              os.path.abspath(killed))),
          'cache kill switch: %d rows, files left' % n)
    log('cache kill switch %s=0: %d rows read uncached, no file under the '
        'root or in /dev/shm' % (SHARED_CACHE_ENV_VAR, n))


def cache_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
               image_rows=IMAGE_ROWS, image_batch=IMAGE_BATCH,
               image_size=IMAGE_SIZE, rows=TOKEN_ROWS, steps=TOKEN_STEPS,
               mnist_rows=MNIST_ROWS):
    """Phase 14: readahead and the row-group caches. Returns the launch
    counts of the cached image steps (K4) and of the LM steps (K1-K3)."""
    from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    df = subprocess.run(['df', '-B1', '/dev/shm'], capture_output=True,
                        text=True, timeout=60)
    log('cache /dev/shm: %s' % ' | '.join(
        line.strip() for line in (df.stdout or df.stderr).splitlines()))
    saved = os.environ.get(DEVICE_DECODE_ENV_VAR)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        roots = SharedRoots(d)
        try:
            image = cached_image_line(torch, np, kernels, args, d, roots,
                                      device, image_rows, image_batch,
                                      image_size, IMAGE_WORKERS)
            roots.remove()
            lm, token_url, tokens = cached_token_line(
                torch, np, tlm, kernels, args, d, roots, device, cfg, rows,
                steps)
            roots.remove()
            local_cache_and_kill_switch(torch, np, args, d, roots, token_url,
                                        tokens, mnist_rows)
        finally:
            roots.remove()
            if saved is None:
                os.environ.pop(DEVICE_DECODE_ENV_VAR, None)
            else:
                os.environ[DEVICE_DECODE_ENV_VAR] = saved
    return image, lm


# ---------------------------------------------------------------------------
# phase 15: the lineage line (provenance, audit, replay, quarantine)
# ---------------------------------------------------------------------------

#: (row group, row) of the png store's cells overwritten with garbage
LINEAGE_POISON = ((1, 2), (1, 5), (4, 0))
LINEAGE_PASSES = 2                # token passes a pool and lineage setting
#: JAX's device-decode decline under a quarantine policy, word for word
LINEAGE_DECLINE = ('on_decode_error quarantines per-cell codec failures, '
                   'which only the host decode can observe')
#: the card's name and power limit, printed beside every number of the
#: phase (set from ``nvidia-smi`` by main)
CARD = 'no card'


def corrupt_cells(path, field, targets):
    """Garbage bytes in ``field`` at each ``(row group, row)`` of
    ``targets`` of the one-file store at ``path``, its row groups kept as
    they were. Returns ``{(file, row group, row): idx}`` of those rows."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    (name,) = [os.path.join(path, n) for n in os.listdir(path)
               if n.endswith('.parquet')]
    pf = pq.ParquetFile(name)
    groups = [pf.read_row_group(rg) for rg in range(pf.num_row_groups)]
    schema = pf.schema_arrow
    pf.close()
    poisoned = {}
    with pq.ParquetWriter(name, schema) as writer:
        for rg, table in enumerate(groups):
            rows = [row for g, row in targets if g == rg]
            if rows:
                cells = table.column(field).to_pylist()
                for row in rows:
                    cells[row] = b'garbage-not-an-encoded-image'
                    poisoned[name, rg, row] = table.column('idx')[row].as_py()
                table = table.set_column(
                    table.column_names.index(field), schema.field(field),
                    pa.array(cells, type=schema.field(field).type))
            writer.write_table(table)
    return poisoned


def source_idx(path):
    """``{(file, row group): idx array in file order}`` of a store."""
    import pyarrow.parquet as pq
    out = {}
    for n in sorted(os.listdir(path)):
        if n.endswith('.parquet'):
            name = os.path.join(path, n)
            pf = pq.ParquetFile(name)
            for rg in range(pf.num_row_groups):
                out[name, rg] = pf.read_row_group(
                    rg, columns=['idx']).column('idx').to_numpy()
    return out


def check_batch_sources(np, batch, sources, poisoned, label):
    """Each row of ``batch`` resolves through its ``'_provenance'`` to the
    (file, row group, offset) whose ``idx`` it holds. An opaque selection
    (a transform ran on the whole row group) names payload offsets: the
    offsets left after the quarantined rows were dropped."""
    from petastorm_tpu_torch.lineage import BatchProvenance, selection_offsets
    prov = batch['_provenance']
    idx = batch['idx'].cpu().numpy()
    check(isinstance(prov, BatchProvenance) and len(prov) == len(idx),
          '%s: batch provenance %r' % (label, type(prov)))
    offsets = prov.offsets()
    for i in range(len(idx)):
        record = prov.record_for_row(i)
        key = (record.path, record.row_group)
        kept = selection_offsets(record.selection)
        if kept is None:
            dropped = {row for (p, g, row) in poisoned if (p, g) == key}
            kept = [o for o in range(len(sources[key])) if o not in dropped]
        source = int(kept[int(offsets[i])])
        check(int(sources[key][source]) == int(idx[i]),
              '%s: row %d resolves to %s rg%d offset %d (idx %d), holds idx '
              '%d' % (label, i, record.path, record.row_group, source,
                      sources[key][source], idx[i]))


def quarantined_image_line(torch, np, kernels, args, d, device, rows, batch,
                           size, workers):
    """The png store with 3 garbage ``image`` cells in 2 row groups: under
    ``'raise'`` the reader raises, under ``'skip'`` it gives the other rows
    and no record; under ``'quarantine'`` on the thread and the process
    pool the CNN trains on K4 from staged batches whose ``'_provenance'``
    names each row's source, the records name the 3 cells, the audit is
    complete, and a replay of one shuffled batch equals it bit for bit.
    Returns the launch counts of the CNN steps."""
    from petastorm_tpu_torch import (TorchDataLoader, TransformSpec,
                                     make_columnar_reader, prefetch_to_device)
    from petastorm_tpu_torch.examples.imagenet.main import \
        make_resize_transform
    from petastorm_tpu_torch.models import image_cnn as cnn
    path = os.path.join(d, 'images_poisoned')
    url = 'file://' + path
    start = time.perf_counter()
    write_indexed_images(np, url, rows, args.seed)
    poisoned = corrupt_cells(path, 'image', LINEAGE_POISON)
    sources = source_idx(path)
    want = sorted(set(range(rows)) - set(poisoned.values()))
    log('lineage png store %d rows in %d row groups, %d image cells '
        'overwritten with garbage (idx %s), in %.2f s'
        % (rows, len(sources), len(poisoned), sorted(poisoned.values()),
           time.perf_counter() - start))
    resize = make_resize_transform(size)
    spec = TransformSpec(resize.func, edit_fields=resize.edit_fields,
                         selected_fields=['idx', 'image', 'label'])
    kw = dict(num_epochs=1, workers_count=workers, seed=args.seed,
              transform_spec=spec)
    try:
        with make_columnar_reader(url, **kw) as reader:
            for _ in reader:
                pass
        raised = None
    except ValueError as e:
        raised = e
    check(raised is not None and 'imdecode' in str(raised),
          "lineage png 'raise': the corrupt store did not raise (%r)"
          % raised)
    start = time.perf_counter()
    with make_columnar_reader(url, on_decode_error='skip', **kw) as reader:
        got = sorted(int(i) for b in reader for i in b.idx)
        records = reader.lineage.quarantines()
    check(got == want and records == [],
          "lineage png 'skip': %d rows, %d records" % (len(got), len(records)))
    log("lineage png 'raise' raised %s: %s; 'skip' gave %d rows and no "
        'record in %.2f s' % (type(raised).__name__, raised, len(got),
                              time.perf_counter() - start))
    params = cnn.init(torch.Generator().manual_seed(args.seed),
                      num_classes=IMAGE_CLASSES, device=device)
    step = cnn.make_train_step(params, lr=1e-3)
    steps, times, whole = 0, [], []
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for pool in ('thread', 'process'):
        label = 'lineage png %s pool' % pool
        seen, replayed, ended = [], None, None
        start = time.perf_counter()
        with make_columnar_reader(url, reader_pool_type=pool,
                                  on_decode_error='quarantine',
                                  **kw) as reader:
            loader = TorchDataLoader(reader, batch_size=batch,
                                     shuffling_queue_capacity=2 * batch,
                                     seed=args.seed, device=device)
            batches = prefetch_to_device(iter(loader), size=2, device=device)
            with contextlib.closing(batches):
                for b in iter(lambda: next(batches, None), None):
                    t1 = time.perf_counter()
                    loss = float(step(b['image'], b['label']))
                    t2 = time.perf_counter()
                    times.append(t2 - t1)
                    if ended is not None:
                        whole.append(t2 - ended)
                    steps += 1
                    check(b['image'].device.type == device,
                          '%s: images on %s' % (label, b['image'].device))
                    check_batch_sources(np, b, sources, poisoned, label)
                    seen.append(b['idx'].cpu())
                    if replayed is None and len(b['_provenance'].records()) > 1:
                        r0 = time.perf_counter()
                        again = reader.replay(b)
                        replayed = (time.perf_counter() - r0,
                                    len(b['_provenance'].records()))
                        for name in ('image', 'idx'):
                            host = b[name].cpu().numpy()
                            check(again[name].dtype == host.dtype
                                  and again[name].tobytes() == host.tobytes(),
                                  '%s: replay of %s differs' % (label, name))
                    ended = time.perf_counter()
            wall = time.perf_counter() - start
            records = reader.lineage.quarantines()
            report = reader.audit().assert_complete()
        check(math.isfinite(loss), '%s: non-finite loss' % label)
        seen = sorted(torch.cat(seen).numpy().tolist())
        check(seen == want, '%s: %d rows, not the %d clean ones once'
              % (label, len(seen), len(want)))
        cells = {(r['path'], r['row_group'], o)
                 for r in records for o in r.get('row_offsets', ())}
        check(all(r['stage'] == 'decode' and r.get('field') == 'image'
                  for r in records)
              and cells == set(poisoned)
              and sum(r['rows'] for r in records) == len(poisoned),
              '%s: quarantine records %s' % (label, records))
        check(replayed is not None, '%s: no batch was replayed' % label)
        epoch = report['epochs'][0]
        log('%s: %d rows (== store less the %d quarantined), %d quarantine '
            'records (%s), audit complete (%d items, %d rows delivered, %d '
            'quarantined), each row resolved to its source; replay of a '
            'shuffled batch from %d row groups == the staged batch, %.3f s; '
            'pass %.2f s [%s]'
            % (label, len(seen), len(poisoned), len(records), '; '.join(
                '%s rg%d rows %s' % (os.path.basename(r['path']),
                                     r['row_group'], r['row_offsets'])
                for r in records),
               epoch['items_delivered'], epoch['rows_delivered'],
               epoch['rows_quarantined'], replayed[1], replayed[0], wall,
               CARD))
    launches = dict(kernels.LAUNCHES)
    if device == 'cuda':
        check(launches['normalize'] == steps,
              'K4 launched %d times in %d lineage png steps'
              % (launches['normalize'], steps))
    images = torch.zeros((batch, size, size, 3), dtype=torch.uint8,
                         device=device)
    labels = torch.arange(batch, device=device) % IMAGE_CLASSES
    alone = []
    for _ in range(4):
        t0 = time.perf_counter()
        float(step(images, labels))
        alone.append(time.perf_counter() - t0)
    log('lineage png: %d CNN steps on K4, median step %.2f ms (from the '
        'batch on the card to the loss on the host), %s ms with the batch '
        'wait (from the end of the previous step\'s checks), against the '
        'step alone %.2f ms [%s]'
        % (steps, statistics.median(times) * 1e3,
           '%.2f' % (statistics.median(whole) * 1e3) if whole else 'n/a',
           statistics.median(alone[1:]) * 1e3, CARD))
    return launches


def audited_token_line(torch, np, tlm, kernels, args, d, device, cfg, rows,
                       steps):
    """The columnar token store: passes with lineage on and with
    ``PETASTORM_TPU_LINEAGE=0`` on the thread and the process pool (device
    decode planned, each pass == the generator, each audit complete);
    under ``'quarantine'`` device decode declines with JAX's reason and a
    pass decodes on the host; then 5 LM steps from lineage-on batches, and
    ``explain_step`` names a source row group. Returns the LM's launch
    counts."""
    from petastorm_tpu_torch import TorchDataLoader, make_columnar_reader
    from petastorm_tpu_torch.lineage import LINEAGE_ENV_VAR
    from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
    seq = cfg.max_seq_len + 1
    url = 'file://' + os.path.join(d, 'token_rows')
    start = time.perf_counter()
    tokens = write_token_rows(np, url, rows, seq, cfg.vocab_size, args.seed)
    log('lineage token store %d rows x %d int32 tokens in %.2f s'
        % (rows, seq, time.perf_counter() - start))
    rates = {}
    for pool in ('thread', 'process'):
        for lineage in ('on', 'off'):
            os.environ[LINEAGE_ENV_VAR] = '1' if lineage == 'on' else '0'
            for n in range(LINEAGE_PASSES):
                got = token_pass(
                    torch, np, url, tokens, pool, 'on', device, TOKEN_BATCH,
                    label='lineage %s pass %d, token' % (lineage, n),
                    audit=True)
                rates.setdefault((pool, lineage), []).append(got['rate'])
    os.environ.pop(LINEAGE_ENV_VAR, None)
    for pool in ('thread', 'process'):
        on, off = rates[pool, 'on'], rates[pool, 'off']
        log('lineage token %s pool rows/s: on %s, off %s; on / off %.4f '
            '(mean of %d passes each) [%s]'
            % (pool, ' '.join('%.0f' % r for r in on),
               ' '.join('%.0f' % r for r in off),
               statistics.mean(on) / statistics.mean(off), len(on), CARD))
    os.environ[DEVICE_DECODE_ENV_VAR] = 'on'
    with make_columnar_reader(url, num_epochs=1, shuffle_row_groups=False,
                              workers_count=TOKEN_WORKERS,
                              on_decode_error='quarantine') as reader:
        declined = reader.device_decode_declined
        check(not reader.device_decode_plans
              and declined == {'*': LINEAGE_DECLINE},
              'lineage token quarantine: plans %s, declined %s'
              % (reader.device_decode_plans, declined))
        got, idx = [], []
        for b in TorchDataLoader(reader, batch_size=TOKEN_BATCH,
                                 device=device).iter_prefetched():
            got.append(b['tokens'])
            idx.append(b['idx'])
        reader.audit().assert_complete()
        records = reader.lineage.quarantines()
    idx = torch.cat(idx).cpu().numpy()
    order = np.argsort(idx, kind='stable')
    host = torch.cat(got).cpu().numpy()[order]
    check(np.array_equal(idx[order], np.arange(rows))
          and host.tobytes() == tokens.tobytes() and not records,
          'lineage token quarantine: rows differ from the generator')
    log("lineage token on_decode_error='quarantine': device decode declined "
        '(%s); a pass decoded on the host == generator, audit complete'
        % declined['*'])
    params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                      device=device)
    _, step = tlm.make_train_step(cfg, params)
    losses = []
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with make_columnar_reader(url, num_epochs=1, workers_count=TOKEN_WORKERS,
                              seed=args.seed) as reader:
        check(reader.lineage.enabled
              and set(reader.device_decode_plans) == {'tokens'},
              'lineage token LM: lineage %s, plans %s'
              % (reader.lineage.enabled, reader.device_decode_plans))
        loader = TorchDataLoader(reader, batch_size=TOKEN_BATCH,
                                 drop_last=True, device=device)
        batches = loader.iter_prefetched()
        with contextlib.closing(batches):
            for i in range(steps):
                b = next(batches)
                check('_provenance' in b, 'lineage token LM: no provenance')
                t = b['tokens'].to(torch.int64)
                losses.append(float(loader.goodput.fence(
                    step(t[:, :-1], t[:, 1:]))))
        launches = dict(kernels.LAUNCHES)
        explained = loader.goodput.explain_step()
    check(all(math.isfinite(x) for x in losses), 'lineage token LM: loss')
    source = (explained.get('provenance') or {}).get('sources', [{}])[0]
    check(source.get('path') and isinstance(source.get('row_group'), int)
          and (not explained['chain']
               or explained['chain'][-1].endswith(
                   'rg%d)' % source['row_group'])),
          'lineage token LM: explain_step names no row group: %r'
          % explained)
    log('lineage token LM %d steps from lineage-on batches: loss %.4f -> '
        '%.4f, launches %s; explain_step: %s (chain %s; first source %s '
        'rg%d, %d rows)'
        % (len(losses), losses[0], losses[-1], json.dumps(launches),
           explained['explanation'], explained['chain'],
           os.path.basename(source['path']), source['row_group'],
           source['rows']))
    return launches


def lineage_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
                 image_rows=IMAGE_ROWS, image_batch=IMAGE_BATCH,
                 image_size=IMAGE_SIZE, rows=TOKEN_ROWS, steps=TOKEN_STEPS):
    """Phase 15: sample lineage and quarantine. Returns the launch counts
    of the quarantined png line's CNN steps (K4) and of the audited token
    line's LM steps (K1-K3)."""
    from petastorm_tpu_torch.lineage import LINEAGE_ENV_VAR
    from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    saved = {k: os.environ.get(k)
             for k in (DEVICE_DECODE_ENV_VAR, LINEAGE_ENV_VAR)}
    try:
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix='.smoke-store-') as d:
            image = quarantined_image_line(torch, np, kernels, args, d,
                                           device, image_rows, image_batch,
                                           image_size, IMAGE_WORKERS)
            lm = audited_token_line(torch, np, tlm, kernels, args, d, device,
                                    cfg, rows, steps)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return image, lm


# ---------------------------------------------------------------------------
# phase 17: the observability line
# ---------------------------------------------------------------------------

OBS_FILES = 8                     # LM store: 8 files of 9 rows, 8 windows
OBS_ROWS_PER_FILE = 9             # each: 64 windows, 8 batches of 8
OBS_RUNS = 2                      # LM runs and token passes a setting
OBS_INTERVAL = 0.5                # metrics_interval of the LM, seconds
OBS_TOKEN_INTERVAL = 0.1          # of a token pass (0.4-2 s a pass)
#: the planes' settings whose cost is measured: the latency kill switch
#: with no trace, the default (latency on, no trace), trace plus metrics
OBS_SETTINGS = ('off', 'default', 'traced')


def _obs_env(setting):
    """``PETASTORM_TPU_LATENCY`` of a setting (read when a reader is made)."""
    from petastorm_tpu_torch.latency import LATENCY_ENV_VAR
    if setting == 'off':
        os.environ[LATENCY_ENV_VAR] = '0'
    else:
        os.environ.pop(LATENCY_ENV_VAR, None)


def _held(iterator, out):
    """``iterator``'s items, appending to ``out`` how long the consumer of
    each (the staging thread) held it: the interval the loader's
    ``train_step`` latency measures, on the host clock from outside."""
    for item in iterator:
        t = time.perf_counter()
        yield item
        out.append(time.perf_counter() - t)


def metered_lm_run(torch, np, tlm, url, cfg, params, step, setting, d, n,
                   device, args):
    """One epoch of the LM store (8 batches) through ``make_reader``
    (NGram, thread pool) -> ``TorchDataLoader`` -> ``prefetch_to_device``
    with the reader's stats, tracer and the loader's goodput, the step
    fenced through the goodput monitor. Under ``'traced'`` the reader
    traces into a Chrome trace file, writes metrics every 0.5 s (the first
    run Prometheus text, the second JSON lines) and evaluates an SLO, and
    the run's gates are held. Returns ``(consumer step times, paths)``."""
    from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.latency import QUANTILE_REL_ERROR_BOUND
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.torch_utils import infeed_diagnosis
    _obs_env(setting)
    traced = setting == 'traced'
    paths = {}
    kw = {}
    if traced:
        paths = {'trace': os.path.join(d, 'trace%d.json' % n),
                 'metrics': os.path.join(
                     d, 'm%d.%s' % (n, 'prom' if n == 0 else 'jsonl'))}
        kw = dict(trace=paths['trace'], metrics_interval=OBS_INTERVAL,
                  metrics_out=paths['metrics'],
                  slo={'p99_e2e_ms': 1000.0, 'min_samples_per_s': 1.0,
                       'eval_interval_s': 0})
    ngram = NGram(fields={0: ['step', 'tokens'], 1: ['tokens']},
                  delta_threshold=1, timestamp_field='step')
    label = 'observability LM %s run %d' % (setting, n)
    times, held = [], []
    with make_reader(url, schema_fields=ngram, num_epochs=1, workers_count=4,
                     seed=args.seed, **kw) as reader:
        loader = TorchDataLoader(reader, batch_size=BATCH, drop_last=True,
                                 device=device)
        goodput = loader.goodput
        batches = prefetch_to_device(_held(iter(loader), held), size=2,
                                     device=device, stats=reader.stats,
                                     tracer=reader.tracer, goodput=goodput)
        with contextlib.closing(batches):
            for batch in batches:
                t0 = time.perf_counter()
                tokens = batch[0]['tokens']
                targets = torch.cat([tokens[:, 1:],
                                     batch[1]['tokens'][:, :1]], 1)
                loss = float(goodput.fence(step(tokens, targets)))
                times.append(time.perf_counter() - t0)
                check(math.isfinite(loss), '%s: non-finite loss' % label)
        check(len(times) == OBS_FILES,
              '%s: %d steps, not %d' % (label, len(times), OBS_FILES))
        snapshot = reader.diagnostics
        latency = reader.latency
        check((latency is None) == (setting == 'off'),
              '%s: latency plane %s' % (label, latency))
        if traced:
            verdict = reader.slo.evaluate()
            diagnosis = infeed_diagnosis(snapshot, latency=latency,
                                         slo=verdict)
            explained = goodput.explain_step(snapshot=snapshot)
            ventilated = sum(reader.lineage.epoch_ledger(0)[
                'ventilated'].values())
            train = latency.histograms['train_step']
            p99 = train.quantile(0.99)
    if not traced:
        return times, paths
    check(snapshot['items_out'] == ventilated == OBS_FILES,
          '%s: items_out %d, ventilated %d' % (label, snapshot['items_out'],
                                               ventilated))
    check(train.count == len(times) == len(held),
          '%s: train_step holds %d observations for %d steps'
          % (label, train.count, len(times)))
    err = abs(p99 - max(held)) / max(held)
    check(err <= QUANTILE_REL_ERROR_BOUND,
          '%s: train_step p99 %.3f ms, host clock max %.3f ms (%.3f > %.3f)'
          % (label, p99 * 1e3, max(held) * 1e3, err,
             QUANTILE_REL_ERROR_BOUND))
    with open(paths['trace']) as f:
        doc = json.load(f)
    spans = [e for e in doc['traceEvents'] if e['ph'] == 'X']
    names = {}
    for e in spans:
        names[e['name']] = names.get(e['name'], 0) + 1
    for name in ('process_item', 'queue_wait', 'infeed_wait', 'train_step',
                 'device_stage', 'step'):
        check(names.get(name, 0) > 0, '%s: no %s span in the trace: %s'
              % (label, name, names))
    check(names['train_step'] == names['step'] == len(times),
          '%s: %d train_step and %d step spans for %d steps'
          % (label, names['train_step'], names['step'], len(times)))
    with open(paths['metrics']) as f:
        text = f.read()
    if n == 0:
        samples = [line.split() for line in text.splitlines()
                   if line and not line.startswith('#')]
        try:        # each sample: a name (with labels) and a float value
            parsed = all(len(x) == 2 and float(x[1]) is not None
                         for x in samples)
        except ValueError:
            parsed = False
        check(parsed, '%s: the .prom file does not parse' % label)
        check(any(x[0] == 'petastorm_tpu_items_out' for x in samples),
              '%s: the .prom file names no petastorm_tpu_items_out' % label)
        metrics = '%d Prometheus samples' % len(samples)
    else:
        lines = [json.loads(line) for line in text.splitlines()]
        check(lines and lines[-1]['items_out'] == OBS_FILES,
              '%s: .jsonl lines %d' % (label, len(lines)))
        metrics = '%d JSON lines' % len(lines)
    check(verdict is not None and 'breached' in verdict,
          '%s: no SLO verdict' % label)
    check(diagnosis.get('bottleneck') not in (None, ''),
          '%s: infeed_diagnosis named no bottleneck' % label)
    check(explained.get('chain') is not None,
          '%s: explain_step gave no chain: %r' % (label, explained))
    log('%s: trace %d spans (%s), metrics %s, items_out %d == ventilated; '
        'train_step p99 %.3f ms against the host clock max %.3f ms (within '
        '%.3f); SLO %s (checks %s, skipped %s); infeed_diagnosis: %s; '
        'explain_step: %s (chain %s) [%s]'
        % (label, len(spans), json.dumps(names, sort_keys=True), metrics,
           snapshot['items_out'], p99 * 1e3, max(held) * 1e3, err,
           'breached' if verdict['breached'] else 'held',
           sorted(verdict['checks']), verdict['skipped_checks'],
           diagnosis['bottleneck'], explained['explanation'],
           explained['chain'], CARD))
    return times, paths


def metered_png_pass(torch, np, kernels, args, d, device, rows, batch, size,
                     workers):
    """One pass over the lineage phase's png store (3 garbage ``image``
    cells) on the thread pool under ``'quarantine'``, into CNN steps on K4:
    ``rows_quarantined`` is the audit's. Returns the launch counts."""
    from petastorm_tpu_torch import (TorchDataLoader, TransformSpec,
                                     make_columnar_reader, prefetch_to_device)
    from petastorm_tpu_torch.examples.imagenet.main import \
        make_resize_transform
    from petastorm_tpu_torch.models import image_cnn as cnn
    path = os.path.join(d, 'images_poisoned')
    url = 'file://' + path
    write_indexed_images(np, url, rows, args.seed)
    poisoned = corrupt_cells(path, 'image', LINEAGE_POISON)
    resize = make_resize_transform(size)
    spec = TransformSpec(resize.func, edit_fields=resize.edit_fields,
                         selected_fields=['idx', 'image', 'label'])
    params = cnn.init(torch.Generator().manual_seed(args.seed),
                      num_classes=IMAGE_CLASSES, device=device)
    step = cnn.make_train_step(params, lr=1e-3)
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    steps = 0
    with make_columnar_reader(url, num_epochs=1, workers_count=workers,
                              seed=args.seed, transform_spec=spec,
                              on_decode_error='quarantine') as reader:
        loader = TorchDataLoader(reader, batch_size=batch, device=device)
        batches = prefetch_to_device(iter(loader), size=2, device=device,
                                     stats=reader.stats,
                                     goodput=loader.goodput)
        with contextlib.closing(batches):
            for b in batches:
                loss = float(loader.goodput.fence(step(b['image'],
                                                       b['label'])))
                steps += 1
        snapshot = reader.diagnostics
        report = reader.audit().assert_complete()
    launches = dict(kernels.LAUNCHES)
    check(math.isfinite(loss), 'observability png: non-finite loss')
    quarantined = report['rows_quarantined_total']
    check(snapshot['rows_quarantined'] == quarantined == len(poisoned),
          'observability png: rows_quarantined %d, audit %d, cells %d'
          % (snapshot['rows_quarantined'], quarantined, len(poisoned)))
    if device == 'cuda':
        check(launches['normalize'] == steps,
              'K4 launched %d times in %d observability png steps'
              % (launches['normalize'], steps))
    log('observability png thread pool: %d CNN steps on K4; rows_quarantined '
        '%d == audit %d (items_quarantined %d); decoded %d rows batched, %d '
        'cell by cell; e2e_batch p99 %.2f ms, queue_wait p99 %.3f ms [%s]'
        % (steps, snapshot['rows_quarantined'], quarantined,
           snapshot['items_quarantined'], snapshot['rows_decoded_batched'],
           snapshot['rows_decoded_percell'],
           snapshot['e2e_latency_p99_s'] * 1e3,
           snapshot['queue_wait_p99_s'] * 1e3, CARD))
    return launches


def metered_token_line(torch, np, d, device, rows, seq, vocab, seed):
    """The columnar token store: one traced pass on the process pool with
    device decode on, its transport and decode counters and the workers'
    spans held; then the cost of the planes on the thread pool, 2 passes
    each under the three settings. Returns ``{setting: [rows/s]}``."""
    from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
    url = 'file://' + os.path.join(d, 'token_rows')
    start = time.perf_counter()
    tokens = write_token_rows(np, url, rows, seq, vocab, seed)
    log('observability token store %d rows x %d int32 tokens in %.2f s'
        % (rows, seq, time.perf_counter() - start))
    os.environ[DEVICE_DECODE_ENV_VAR] = 'on'
    _obs_env('default')
    got = token_pass(torch, np, url, tokens, 'process', 'on', device,
                     TOKEN_BATCH, label='observability traced token',
                     trace=True)
    snap, tracer, pids = got['diagnostics'], got['tracer'], got['pids']
    raw_staged = sum(g[3] for g in got['staged'])
    label = 'observability token process pool'
    check(snap['payload_copies'] == 0,
          '%s: %d payload copies on the zero-copy path'
          % (label, snap['payload_copies']))
    check(snap['bytes_moved'] > 0, '%s: bytes_moved 0' % label)
    check(snap['rows_decoded_device'] == rows * 1,
          '%s: rows_decoded_device %d, not rows x 1 planned column (%d)'
          % (label, snap['rows_decoded_device'], rows))
    check(snap['bytes_shipped_raw'] == raw_staged,
          '%s: bytes_shipped_raw %d, raw bytes staged %d'
          % (label, snap['bytes_shipped_raw'], raw_staged))
    worker_spans = [s for s in tracer.spans()
                    if s[0] in ('process_item', 'serialize', 'parquet_read',
                                'decode_columns')]
    span_pids = {s[4] for s in worker_spans}
    check(worker_spans and span_pids <= pids and len(span_pids) > 1,
          '%s: worker span pids %s, workers %s' % (label, span_pids, pids))
    log('%s: payload_copies %d, bytes_moved %d in %d frames, '
        'rows_decoded_device %d == rows x 1 planned column, '
        'bytes_shipped_raw %d == raw bytes staged; %d worker spans from '
        'pids %s (the workers\') [%s]'
        % (label, snap['payload_copies'], snap['bytes_moved'],
           snap['payload_frames'], snap['rows_decoded_device'],
           snap['bytes_shipped_raw'], len(worker_spans), sorted(span_pids),
           CARD))
    rates = {}
    for n in range(OBS_RUNS):
        for setting in OBS_SETTINGS:
            _obs_env(setting)
            kw = {}
            if setting == 'traced':
                jsonl = os.path.join(d, 'token%d.jsonl' % n)
                kw = dict(trace=True, metrics_interval=OBS_TOKEN_INTERVAL,
                          metrics_out=jsonl)
            got = token_pass(torch, np, url, tokens, 'thread', 'on', device,
                             TOKEN_BATCH,
                             label='observability %s pass %d, token'
                             % (setting, n), **kw)
            rates.setdefault(setting, []).append(got['rate'])
            if setting == 'traced':
                with open(jsonl) as f:
                    lines = [json.loads(line) for line in f]
                check(len(lines) >= 2 and lines[-1]['items_out'] > 0,
                      'observability token: %d JSON lines, not one and the '
                      'final one' % len(lines))
                log('observability token traced pass %d: %d JSON lines of '
                    'metrics (every %g s and the final one)'
                    % (n, len(lines), OBS_TOKEN_INTERVAL))
    return rates


def observability_line(torch, np, tlm, kernels, args, device='cuda',
                       cfg=None, image_rows=IMAGE_ROWS,
                       image_batch=IMAGE_BATCH, image_size=IMAGE_SIZE,
                       rows=TOKEN_ROWS):
    """Phase 17: the stats, latency and tracing planes on the card. The
    metered LM line (full width, 8 steps a run on K1-K3, runs under the
    three settings), the metered token line and the metered png pass (K4),
    and the cost of the planes. Returns the launch counts of the LM runs
    and of the png pass."""
    from petastorm_tpu_torch.latency import LATENCY_ENV_VAR
    from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    saved = {k: os.environ.get(k)
             for k in (DEVICE_DECODE_ENV_VAR, LATENCY_ENV_VAR)}
    try:
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix='.smoke-store-') as d:
            url = 'file://' + os.path.join(d, 'tokens')
            write_store(np, url, cfg.max_seq_len, cfg.vocab_size,
                        OBS_FILES * OBS_ROWS_PER_FILE, args.seed,
                        rows_per_file=OBS_ROWS_PER_FILE)
            params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                              device=device)
            _, step = tlm.make_train_step(cfg, params)
            steps = {}
            if device == 'cuda':
                torch.cuda.synchronize()
            kernels.reset_launch_counts()
            for n in range(OBS_RUNS):
                for setting in OBS_SETTINGS:
                    times, _ = metered_lm_run(torch, np, tlm, url, cfg,
                                              params, step, setting, d, n,
                                              device, args)
                    steps.setdefault(setting, []).append(
                        statistics.median(times[1:]))
            lm = dict(kernels.LAUNCHES)
            runs = OBS_RUNS * len(OBS_SETTINGS) * OBS_FILES
            if device == 'cuda':
                check(all(lm[k] == runs * cfg.n_layers for k in FLASH),
                      'observability LM launches %r for %d steps of %d '
                      'layers' % (lm, runs, cfg.n_layers))
            png = metered_png_pass(torch, np, kernels, args, d, device,
                                   image_rows, image_batch, image_size,
                                   IMAGE_WORKERS)
            rates = metered_token_line(torch, np, d, device, rows,
                                       cfg.max_seq_len + 1, cfg.vocab_size,
                                       args.seed)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    base = statistics.mean(steps['off'])
    for setting in OBS_SETTINGS:
        log('observability cost LM steady step (median of steps 2-%d) %s: '
            '%s ms; / latency off %.4f (runs of off: %s ms) [%s]'
            % (OBS_FILES, setting,
               ' '.join('%.3f' % (t * 1e3) for t in steps[setting]),
               statistics.mean(steps[setting]) / base,
               ' '.join('%.3f' % (t * 1e3) for t in steps['off']), CARD))
    base = statistics.mean(rates['off'])
    for setting in OBS_SETTINGS:
        spread = max(rates[setting]) / min(rates[setting])
        log('observability cost token rows/s, thread pool, %s: %s; / latency '
            'off %.4f (spread of its passes %.4f, of off\'s %.4f) [%s]'
            % (setting, ' '.join('%.0f' % r for r in rates[setting]),
               statistics.mean(rates[setting]) / base, spread,
               max(rates['off']) / min(rates['off']), CARD))
    log('observability LM launches %s (%d steps); png %s'
        % (json.dumps(lm), OBS_RUNS * len(OBS_SETTINGS) * OBS_FILES,
           json.dumps(png)))
    return lm, png


# ---------------------------------------------------------------------------
# phase 18: the health line
# ---------------------------------------------------------------------------

HEALTH_POLL_S = 0.1               # the /healthz poller's period
HEALTH_STALL = 2.0                # stall_timeout of the watched LM
HEALTH_WEDGE_STALL = 1.0          # of the wedged LM (thread pool)
HEALTH_PROCESS_STALL = 5.0        # of the wedged pass (process pool)
HEALTH_RECOVER_S = 2.0            # /healthz is 200 again this soon
#: epochs of the watched healthy LM: 128 steps of about 35 ms, several
#: stall timeouts, so a false stall of a healthy entity would show
HEALTH_EPOCHS = 16
#: the poller's replies must cover the steps at this share of its rate
HEALTH_POLL_SHARE = 0.5
#: runs a setting in the cost measurement, in turns (off, default,
#: watched, then the reverse); 2 runs cannot tell a few % from noise
HEALTH_ROUNDS = 10
#: heartbeats off, the default (heartbeats on, no watchdog thread), and a
#: watchdog + debug server + the 0.1 s poller
HEALTH_SETTINGS = ('off', 'default', 'watched')
#: the rows of the LM store's third row group (files of 9 rows)
HEALTH_GATED = (2 * OBS_ROWS_PER_FILE, 3 * OBS_ROWS_PER_FILE)
HEALTH_ABSENT = ('/autotune', '/podmetrics')

#: a row transform that blocks on the rows whose ``step`` lies in [lo, hi)
#: until a gate file exists; written into the store's directory and
#: imported from there, so worker interpreters import it too (they inherit
#: ``sys.path``); ``tests/test_torch_health.py`` holds the same gate for
#: the JAX package's readers
HEALTH_GATE_MODULE = '''
import os
import time


class FileGate:
    """A row transform that blocks on the rows whose ``step`` lies in
    ``[lo, hi)`` until the file ``path`` exists."""

    def __init__(self, path, lo, hi):
        self.path, self.lo, self.hi = path, lo, hi

    def __call__(self, row):
        if self.lo <= int(row['step']) < self.hi:
            deadline = time.monotonic() + 120
            while (not os.path.exists(self.path)
                   and time.monotonic() < deadline):
                time.sleep(0.02)
        return row
'''


def http_get(port, route):
    """``(status, body)`` of ``GET route`` on the debug endpoint."""
    return http_exchange(port, route)[:2]


def http_exchange(port, route, headers=None):
    """``(status, body, reply headers)`` of ``GET route`` with ``headers``."""
    from http.client import HTTPConnection
    conn = HTTPConnection('127.0.0.1', port, timeout=10)
    try:
        conn.request('GET', route, headers=headers or {})
        response = conn.getresponse()
        return (response.status, response.read().decode('utf-8'),
                dict(response.getheaders()))
    finally:
        conn.close()


class HealthzPoller:
    """A thread that GETs ``/healthz`` every :data:`HEALTH_POLL_S` and keeps
    ``(time, status, verdict)``; with ``monitor`` (``reader.health``) it
    also keeps the largest age a ``loader-prefetch`` ``staging`` beat
    reached. Never touches the card."""

    def __init__(self, port, monitor=None):
        self.replies = []
        self.staging_max_age_s = 0.0
        self._port = port
        self._monitor = monitor
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='smoke-healthz-poller')
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            status, body = http_get(self._port, '/healthz')
            self.replies.append((time.perf_counter(), status,
                                 json.loads(body)))
            if self._monitor is not None:
                beat = self._monitor.heartbeats().get('loader-prefetch')
                if beat is not None and beat['stage'] == 'staging':
                    self.staging_max_age_s = max(self.staging_max_age_s,
                                                 beat['age_s'])
            self._stop.wait(HEALTH_POLL_S)

    def stop(self):
        self._stop.set()
        self._thread.join(30)
        check(not self._thread.is_alive(), 'the /healthz poller hung')


def watched_lm_run(torch, url, cfg, step, setting, d, device, args,
                   gate=None, label='health LM', epochs=1):
    """``epochs`` of the LM store (8 batches of 8 NGram windows each) through
    ``make_reader`` (4 threads) -> ``TorchDataLoader`` ->
    ``prefetch_to_device(health=reader.health, goodput=)`` -> 8 AdamW steps
    fenced through the goodput monitor. ``setting`` as
    :data:`HEALTH_SETTINGS`; ``'watched'`` adds ``stall_timeout`` (1.0 s
    with a ``gate``, else 2.0 s), ``debug_port=0``, a flight-record
    directory, an ``slo`` and the poller. With ``gate`` (the gate file's
    path) the transform blocks the third row group: a keeper thread waits
    for ``/healthz`` to turn 503, reads the flight record and
    ``infeed_diagnosis``, then opens the gate. Returns
    ``(steady step times, facts)``; ``facts['span']`` is the steps' first
    start and last end."""
    from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.health import HEALTH_ENV_VAR
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.torch_utils import infeed_diagnosis
    from petastorm_tpu_torch.transform import TransformSpec
    if setting == 'off':
        os.environ[HEALTH_ENV_VAR] = '0'
    else:
        os.environ.pop(HEALTH_ENV_VAR, None)
    watched = setting == 'watched'
    stall = HEALTH_WEDGE_STALL if gate else HEALTH_STALL
    flights = tempfile.mkdtemp(dir=d, prefix='flight-') if watched else None
    kw = {}
    if watched:
        kw = dict(stall_timeout=stall, debug_port=0,
                  flight_record_dir=flights)
        # a target the run meets; fail_healthz arms the SLO's 503 in the
        # healthy run (a stall episode would spend it, so not when wedged)
        kw['slo'] = ({'p99_queue_wait_ms': 60000.0, 'eval_interval_s': 0}
                     if gate else
                     {'p99_queue_wait_ms': 60000.0, 'max_stall_episodes': 0,
                      'fail_healthz': True, 'eval_interval_s': 0.25,
                      'min_evaluations': 1})
    if gate:
        import health_gate
        kw['transform_spec'] = TransformSpec(
            health_gate.FileGate(gate, *HEALTH_GATED))
    ngram = NGram(fields={0: ['step', 'tokens'], 1: ['tokens']},
                  delta_threshold=1, timestamp_field='step')
    times, facts = [], {}
    with make_reader(url, schema_fields=ngram, num_epochs=epochs,
                     workers_count=4, seed=args.seed, **kw) as reader:
        port = reader.debug_port
        if watched:
            check(isinstance(port, int),
                  '%s: the debug server did not bind (%r)' % (label, port))
        loader = TorchDataLoader(reader, batch_size=BATCH, drop_last=True,
                                 device=device)
        goodput = loader.goodput
        poller = (HealthzPoller(port, reader.health if not gate else None)
                  if watched else None)
        keeper = None
        if gate:
            keeper = threading.Thread(
                target=_keep_gate, args=(reader, poller, gate, flights,
                                         stall, facts, label),
                daemon=True, name='smoke-gate-keeper')
            keeper.start()
        batches = prefetch_to_device(iter(loader), size=2, device=device,
                                     goodput=goodput, health=reader.health)
        try:
            with contextlib.closing(batches):
                for i, batch in enumerate(batches):
                    t0 = time.perf_counter()
                    tokens = batch[0]['tokens']
                    targets = torch.cat([tokens[:, 1:],
                                         batch[1]['tokens'][:, :1]], 1)
                    loss = float(goodput.fence(step(tokens, targets)))
                    t1 = time.perf_counter()
                    times.append(t1 - t0)
                    facts['span'] = (facts.get('span', (t0,))[0], t1)
                    check(math.isfinite(loss), '%s: non-finite loss' % label)
                    if watched and i == 3 and not gate:
                        facts['stacks'] = http_get(port, '/stacks')
        finally:
            if keeper is not None:
                keeper.join(60)
                check(not keeper.is_alive(), '%s: the keeper hung' % label)
                # the last steps may end before the next poll: keep
                # polling until a reply after the gate opened
                deadline = time.monotonic() + HEALTH_RECOVER_S + 1.0
                while (time.monotonic() < deadline and not any(
                        t > facts['opened'] and s == 200
                        for t, s, _ in list(poller.replies))):
                    time.sleep(0.02)
            if poller is not None:
                poller.stop()
        check(len(times) == epochs * OBS_FILES,
              '%s: %d steps, not %d' % (label, len(times),
                                        epochs * OBS_FILES))
        report = reader.audit().assert_complete()
        if watched:
            facts['replies'] = poller.replies
            facts['staging_max_age_s'] = poller.staging_max_age_s
            facts['routes'] = {r: http_get(port, r) for r in (
                '/diagnostics', '/metrics', '/coverage', '/goodput', '/slo',
                '/observe/snapshot') + HEALTH_ABSENT}
            if device == 'cuda':
                # the profiler stages to the card unless told otherwise
                facts['routes']['/profile'] = http_get(port, '/profile')
            facts['items_out'] = reader.stats.snapshot()['items_out']
            facts['final'] = reader.watchdog.evaluate()
            facts['slo'] = reader.slo.evaluate()
        if gate:
            facts['flights'] = sorted(os.listdir(flights))
        facts['rows'] = [e['rows_delivered']
                         for _, e in sorted(report['epochs'].items())]
        facts['diagnosis'] = infeed_diagnosis(
            reader.diagnostics, heartbeats=reader.health.heartbeats(),
            stall_after_s=stall)
    os.environ.pop(HEALTH_ENV_VAR, None)
    return times[1:], facts


def _keep_gate(reader, poller, gate, flights, stall, facts, label):
    """The wedged run's keeper: wait for a 503, read what the stall left
    (the verdict, the flight record, ``infeed_diagnosis``, the SLO), open
    the gate and time the return to 200. Runs beside the blocked steps;
    touches no tensor."""
    from petastorm_tpu_torch.torch_utils import infeed_diagnosis
    try:
        deadline = time.monotonic() + 60
        stalled = None
        while stalled is None and time.monotonic() < deadline:
            for t, status, verdict in list(poller.replies):
                if status == 503:
                    stalled = (t, verdict)
                    break
            time.sleep(0.02)
        check(stalled is not None, '%s: /healthz never turned 503' % label)
        facts['stalled_verdict'] = stalled[1]
        while not os.listdir(flights) and time.monotonic() < deadline:
            time.sleep(0.02)
        facts['stall_diagnosis'] = infeed_diagnosis(
            reader.diagnostics, heartbeats=reader.health.heartbeats(),
            stall_after_s=stall)
        # a few more watchdog ticks: the episode must not dump again
        time.sleep(stall)
        names = sorted(os.listdir(flights))
        check(names, '%s: no flight record was written' % label)
        with open(os.path.join(flights, names[0])) as f:
            facts['flight'] = json.load(f)
        facts['slo_during'] = reader.slo.evaluate()
    finally:
        opened = time.perf_counter()
        with open(gate, 'w') as f:
            f.write('open')
        facts['opened'] = opened


def wedged_process_pass(torch, url, d, device, args, gate):
    """The LM store on the process pool (4 worker interpreters) with the
    file gate, staged to the card: the wedged item never completes, so its
    beat reaches the consumer only in the workers' liveness frames (every
    2 s). Returns the stalled verdict, the pass's rows and its staging."""
    from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.transform import TransformSpec
    import health_gate
    label = 'health wedged process pool'
    ngram = NGram(fields={0: ['step', 'tokens'], 1: ['tokens']},
                  delta_threshold=1, timestamp_field='step')
    facts = {}
    start = time.perf_counter()
    with make_reader(url, schema_fields=ngram, num_epochs=1, workers_count=4,
                     seed=args.seed, reader_pool_type='process',
                     stall_timeout=HEALTH_PROCESS_STALL,
                     flight_record_dir=tempfile.mkdtemp(dir=d),
                     transform_spec=TransformSpec(
                         health_gate.FileGate(gate, *HEALTH_GATED))
                     ) as reader:
        watchdog = reader.watchdog

        def keeper():
            try:
                deadline = time.monotonic() + 90
                while time.monotonic() < deadline:
                    verdict = watchdog.last_verdict
                    if verdict is not None and verdict['state'] == 'stalled':
                        facts['verdict'] = verdict
                        facts['beats'] = reader.health.heartbeats()
                        facts['stalled_at'] = time.perf_counter() - start
                        break
                    time.sleep(0.05)
            finally:
                with open(gate, 'w') as f:
                    f.write('open')

        thread = threading.Thread(target=keeper, daemon=True,
                                  name='smoke-process-keeper')
        thread.start()
        loader = TorchDataLoader(reader, batch_size=BATCH, drop_last=True,
                                 device=device)
        steps = set()
        batches = prefetch_to_device(iter(loader), size=2, device=device,
                                     health=reader.health)
        with contextlib.closing(batches):
            for batch in batches:
                tokens = batch[0]['tokens']
                check(tokens.device.type == device and len(tokens) == BATCH,
                      '%s: a batch of %d on %s' % (label, len(tokens),
                                                   tokens.device))
                steps.update(int(s) for s in batch[0]['step'].tolist())
        thread.join(60)
        check(not thread.is_alive(), '%s: the keeper hung' % label)
        report = reader.audit().assert_complete()
        facts['final'] = reader.watchdog.evaluate()
        facts['rows'] = report['epochs'][0]['rows_delivered']
        facts['steps'] = steps
    facts['seconds'] = time.perf_counter() - start
    return facts


def health_line(torch, np, tlm, kernels, args, device='cuda', cfg=None):
    """Phase 18: the live health plane on the card. The watched LM (full
    width, 128 steps on K1-K3 under a watchdog, the debug server and a
    0.1 s ``/healthz`` poller), the same LM with a worker wedged by a file
    gate on the thread pool, the wedged process pool staged to the card,
    and the plane's cost. Returns the launch counts of the LM runs."""
    from petastorm_tpu_torch.health import HEALTH_ENV_VAR
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    saved = os.environ.get(HEALTH_ENV_VAR)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix='.smoke-store-') as d:
            url = 'file://' + os.path.join(d, 'tokens')
            write_store(np, url, cfg.max_seq_len, cfg.vocab_size,
                        OBS_FILES * OBS_ROWS_PER_FILE, args.seed,
                        rows_per_file=OBS_ROWS_PER_FILE)
            with open(os.path.join(d, 'health_gate.py'), 'w') as f:
                f.write(HEALTH_GATE_MODULE)
            sys.path.insert(0, d)
            params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                              device=device)
            _, step = tlm.make_train_step(cfg, params)
            if device == 'cuda':
                torch.cuda.synchronize()
            kernels.reset_launch_counts()
            phase = time.perf_counter()
            _, healthy = watched_lm_run(torch, url, cfg, step, 'watched', d,
                                        device, args, label='health LM',
                                        epochs=HEALTH_EPOCHS)
            check_healthy(healthy)
            log('health healthy run %.1f s' % (time.perf_counter() - phase))
            phase = time.perf_counter()
            _, wedged = watched_lm_run(
                torch, url, cfg, step, 'watched', d, device, args,
                gate=os.path.join(d, 'gate-thread'),
                label='health wedged LM')
            check_wedged(wedged)
            log('health wedged run %.1f s' % (time.perf_counter() - phase))
            steady = {}
            for n in range(HEALTH_ROUNDS):
                # ABC then CBA: a drift over the runs cancels in the ratios
                order = HEALTH_SETTINGS[::1 if n % 2 == 0 else -1]
                for setting in order:
                    times, _ = watched_lm_run(
                        torch, url, cfg, step, setting, d, device, args,
                        label='health cost %s run %d' % (setting, n))
                    steady.setdefault(setting, []).append(
                        statistics.median(times))
            lm = dict(kernels.LAUNCHES)
            runs = HEALTH_EPOCHS + 1 + HEALTH_ROUNDS * len(HEALTH_SETTINGS)
            if device == 'cuda':
                check(all(lm[k] == runs * OBS_FILES * cfg.n_layers
                          for k in FLASH),
                      'health LM launches %r for %d epochs of %d steps of '
                      '%d layers' % (lm, runs, OBS_FILES, cfg.n_layers))
            phase = time.perf_counter()
            process = wedged_process_pass(torch, url, d, device, args,
                                          os.path.join(d, 'gate-process'))
            check_process(process)
            log('health process pass %.1f s' % (time.perf_counter() - phase))
            sys.path.remove(d)
    finally:
        if saved is None:
            os.environ.pop(HEALTH_ENV_VAR, None)
        else:
            os.environ[HEALTH_ENV_VAR] = saved
    base = statistics.mean(steady['off'])
    spread = max(steady['off']) / min(steady['off'])
    for setting in HEALTH_SETTINGS:
        slower = sum(t > o for t, o in zip(steady[setting], steady['off']))
        log('health cost LM steady step (median of steps 2-%d) %s: %s ms; '
            '/ heartbeats off %.4f (medians %.4f; slower than the round\'s '
            'off run in %d of %d) (the off runs\' spread %.4f: %s ms) [%s]'
            % (OBS_FILES, setting,
               ' '.join('%.3f' % (t * 1e3) for t in steady[setting]),
               statistics.mean(steady[setting]) / base,
               statistics.median(steady[setting])
               / statistics.median(steady['off']), slower,
               len(steady['off']), spread,
               ' '.join('%.3f' % (t * 1e3) for t in steady['off']), CARD))
    log('health LM launches %s (%d epochs of %d steps)'
        % (json.dumps(lm), runs, OBS_FILES))
    return lm


def check_healthy(facts):
    label = 'health LM'
    replies = facts['replies']
    first, last = facts['span']
    run_s = last - first
    check(run_s >= 1.5 * HEALTH_STALL,
          '%s: the steps took %.3f s, under 1.5 stall timeouts'
          % (label, run_s))
    during = [v for t, _, v in replies if first <= t <= last]
    floor = int(HEALTH_POLL_SHARE * run_s / HEALTH_POLL_S)
    check(len(during) >= floor,
          '%s: %d /healthz replies during %.3f s of steps, under %d'
          % (label, len(during), run_s, floor))
    # each watchdog tick moves the progress baseline (items_out less its
    # delta); a probe leaves it alone, so the baselines the replies show
    # count the ticks that followed progress
    ticks = {v['items_out'] - v['items_out_delta'] for v in during} - {0}
    check(len(ticks) >= 2, '%s: %d watchdog ticks seen during the steps'
          % (label, len(ticks)))
    bad = [(s, v.get('state')) for _, s, v in replies
           if s != 200 or v.get('state') == 'stalled']
    check(not bad, '%s: /healthz replies %s' % (label, bad[:5]))
    armed = [v['slo']['fail_healthz'] and not v['slo']['hard_breach']
             for _, _, v in replies]
    check(all(armed), '%s: the SLO was not armed and met on every reply'
          % label)
    routes = facts['routes']
    blob = json.loads(routes['/diagnostics'][1])
    entities = set(blob['heartbeats'])
    workers = sorted(e for e in entities if e.startswith('worker-'))
    check({'ventilator', 'loader-prefetch'} <= entities and workers,
          '%s: /diagnostics entities %s' % (label, sorted(entities)))
    lines = [line.split() for line in routes['/metrics'][1].splitlines()
             if line.startswith('petastorm_tpu_items_out ')]
    check(lines and float(lines[0][1]) == facts['items_out']
          == HEALTH_EPOCHS * OBS_FILES,
          '%s: /metrics items_out %s, reader.stats %d' % (
              label, lines, facts['items_out']))
    coverage = json.loads(routes['/coverage'][1])
    check(routes['/coverage'][0] == 200 and coverage['complete']
          and len(coverage['epochs']) == HEALTH_EPOCHS,
          '%s: /coverage %s' % (label, routes['/coverage'][0]))
    goodput = json.loads(routes['/goodput'][1])
    check(goodput.get('attached', True)
          and goodput['steps'] == HEALTH_EPOCHS * OBS_FILES,
          '%s: /goodput %s' % (label, goodput))
    stacks = facts['stacks']
    check(stacks[0] == 200 and 'petastorm-torch-prefetch' in stacks[1],
          '%s: /stacks names no staging thread' % label)
    absent = {r: routes[r][0] for r in HEALTH_ABSENT}
    check(set(absent.values()) == {404}, '%s: %s' % (label, absent))
    snapshot = json.loads(routes['/observe/snapshot'][1])
    check(routes['/observe/snapshot'][0] == 200
          and snapshot['kind'] == 'petastorm_tpu.observe_snapshot'
          and 0 < snapshot['stats']['items_out'] <= facts['items_out'],
          '%s: /observe/snapshot %s' % (label, routes['/observe/snapshot'][0]))
    # the profiler is on: /profile answers with a profile over a cached
    # calibration (never probing), uncalibrated where none is cached
    if '/profile' in routes:
        check(routes['/profile'][0] == 200
              and 'calibrated' in json.loads(routes['/profile'][1]),
              '%s: /profile %s' % (label, routes['/profile'][0]))
    check(facts['final']['state'] != 'stalled'
          and facts['rows'] == [64] * HEALTH_EPOCHS,
          '%s: final %s, windows %s' % (label, facts['final']['state'],
                                        facts['rows']))
    log('%s: %d steps in %.3f s; %d /healthz replies (%d during the steps, '
        'floor %d), all 200, none stalled; %d watchdog ticks seen during '
        'the steps; the SLO armed '
        '(fail_healthz) and met; /diagnostics entities %s; /metrics '
        'items_out %d == reader.stats; /coverage complete; /goodput %d '
        'steps, goodput %.4f; /stacks names the staging thread; /profile '
        '200; /observe/snapshot 200; %s 404; '
        'loader-prefetch staging reached %.4f s at most; infeed_diagnosis '
        '%s, pipeline %s [%s]'
        % (label, goodput['steps'], run_s, len(replies), len(during), floor,
           len(ticks), ' '.join(sorted(entities)),
           facts['items_out'], goodput['steps'],
           goodput['goodput_fraction'] or 0.0, ' '.join(HEALTH_ABSENT),
           facts['staging_max_age_s'], facts['diagnosis']['bottleneck'],
           facts['diagnosis']['pipeline_state'], CARD))


def check_wedged(facts):
    label = 'health wedged LM'
    verdict = facts['stalled_verdict']
    stalled = verdict['stalled_entities']
    check(verdict['state'] == 'stalled' and len(stalled) == 1
          and stalled[0]['entity'].startswith('worker-')
          and stalled[0]['stage'] == 'decode',
          '%s: the stalled verdict %s' % (label, stalled))
    check(len(facts['flights']) == 1,
          '%s: %d flight records' % (label, len(facts['flights'])))
    flight = facts['flight']
    for key in ('heartbeats', 'stats', 'stacks', 'latency', 'goodput', 'slo',
                'lineage'):
        check(flight.get(key), '%s: the flight record has no %s'
              % (label, key))
    check(any('health_gate.py' in s for s in flight['stacks'].values()),
          '%s: no stack shows the gate' % label)
    entity = stalled[0]['entity']
    check(flight['heartbeats'][entity]['stage'] == 'decode',
          '%s: the record\'s %s' % (label, flight['heartbeats'][entity]))
    check(facts['stall_diagnosis']['bottleneck'] == 'stalled',
          '%s: infeed_diagnosis %s' % (label,
                                       facts['stall_diagnosis']['bottleneck']))
    check(facts['slo_during']['stall_episodes'] == 1
          and facts['slo']['stall_episodes'] == 1,
          '%s: %d stall episodes' % (label,
                                     facts['slo']['stall_episodes']))
    after = [(t - facts['opened'], s) for t, s, _ in facts['replies']
             if t > facts['opened']]
    back = [t for t, s in after if s == 200]
    check(back and back[0] <= HEALTH_RECOVER_S,
          '%s: /healthz after the gate opened %s' % (label, after[:8]))
    check(facts['final']['state'] == 'healthy' and facts['rows'] == [64],
          '%s: final %s, windows %s' % (label, facts['final']['state'],
                                        facts['rows']))
    codes = [s for _, s, _ in facts['replies']]
    log('%s: /healthz 503 (stalled: %s in %s, %.3f s) -> one flight record '
        '%s (heartbeats, stats, %d stacks with the gate, latency, goodput, '
        'SLO, lineage); infeed_diagnosis %s; SLO stall episodes %d; 200 '
        'again %.3f s after the gate opened; %d replies (%d 503); 8 steps, '
        '64 windows, audit complete [%s]'
        % (label, entity, stalled[0]['stage'], stalled[0]['age_s'],
           facts['flights'][0], len(flight['stacks']),
           facts['stall_diagnosis']['bottleneck'],
           facts['slo']['stall_episodes'], back[0], len(codes),
           codes.count(503), CARD))


def check_process(facts):
    label = 'health wedged process pool'
    verdict = facts.get('verdict')
    check(verdict is not None, '%s: never stalled' % label)
    stalled = verdict['stalled_entities']
    check(len(stalled) == 1 and stalled[0]['entity'].startswith('worker-')
          and stalled[0]['stage'] == 'decode',
          '%s: the stalled verdict %s' % (label, stalled))
    pid = facts['beats'][stalled[0]['entity']]['pid']
    check(pid != os.getpid(), '%s: the stalled pid is the consumer\'s'
          % label)
    check(facts['rows'] == 64 and len(facts['steps']) == 64
          and facts['final']['state'] == 'healthy',
          '%s: %d windows, final %s' % (label, facts['rows'],
                                        facts['final']['state']))
    log('%s: %s stalled in %s (pid %d, the consumer %d) %.3f s into the '
        'pass, seen through the liveness frames; after the gate opened 64 '
        'windows staged, audit complete, healthy; pass %.1f s [%s]'
        % (label, stalled[0]['entity'], stalled[0]['stage'], pid,
           os.getpid(), facts['stalled_at'], facts['seconds'], CARD))


# ---------------------------------------------------------------------------
# phase 16: times
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 19: the autotune and roofline line
# ---------------------------------------------------------------------------

TUNE_TICK_S = 0.5                 # the controllers' tick interval
TUNE_TICKS = 20                   # the png line reads epochs until this many
TUNE_MAX_S = 15.0                 # ... or this long
TUNE_MAX_EPOCHS = 12
TUNE_MAX_WORKERS = 8
TUNE_PNG_GROUP_MB = 1             # the png line's row groups: 128 of 2 images
TUNE_QUEUE_BOUND = 8              # set live before the png line's last epoch
TUNE_LM_EPOCHS = 6                # the profiled LM's pass: 48 steps
TUNE_ACTUATE_AT = 4               # its step at which the actuations start
TUNE_COST_PAIRS = 6               # (d): autotune off/on runs
TUNE_COST_EPOCHS = 2              # a cost run: 16 steps


class TuneLog(logging.Handler):
    """The ``petastorm_tpu_torch.autotune`` records at ERROR (a failed tick,
    a failed calibration): the controller logs them and carries on, which
    keeps a training job alive but must not hide a broken actuator here."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.failures = []

    def emit(self, record):
        self.failures.append(record.getMessage())

    def check(self, label):
        check(not self.failures, '%s: autotune logged %s'
              % (label, self.failures))


def _ngram():
    from petastorm_tpu_torch.ngram import NGram
    return NGram(fields={0: ['step', 'tokens'], 1: ['tokens']},
                 delta_threshold=1, timestamp_field='step')


def _lm_targets(torch, batch):
    tokens = batch[0]['tokens']
    return tokens, torch.cat([tokens[:, 1:], batch[1]['tokens'][:, :1]], 1)


def tuned_png_line(torch, np, kernels, args, d, device, scratch, rows, batch,
                   size, group_mb=TUNE_PNG_GROUP_MB):
    """(a) The png store (256 images, ``idx``, row groups of ``group_mb``
    MB) through the columnar reader
    with the resize on ONE worker thread, ``autotune`` (0.5 s ticks, a
    cooldown of one tick, at most 8 workers), lineage on, epochs into CNN
    steps on K4 until about 20 ticks; the results queue's bound set to 8
    live before the last epoch. Returns the launch counts."""
    from petastorm_tpu_torch import (TorchDataLoader, TransformSpec,
                                     make_columnar_reader, prefetch_to_device)
    from petastorm_tpu_torch.examples.imagenet.main import \
        make_resize_transform
    from petastorm_tpu_torch.models import image_cnn as cnn
    label = 'autotune png'
    path = os.path.join(d, 'images_idx')
    url = 'file://' + path
    write_indexed_images(np, url, rows, args.seed, group_mb=group_mb)
    groups = row_groups(path)
    resize = make_resize_transform(size)
    spec = TransformSpec(resize.func, edit_fields=resize.edit_fields,
                         selected_fields=['idx', 'image', 'label'])
    params = cnn.init(torch.Generator().manual_seed(args.seed),
                      num_classes=IMAGE_CLASSES, device=device)
    step = cnn.make_train_step(params, lr=1e-3)
    options = dict(tick_interval_s=TUNE_TICK_S, cooldown_ticks=1,
                   max_workers=TUNE_MAX_WORKERS, scratch_dir=scratch,
                   device=device)
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    steps, epochs, bound = 0, [], None
    start = time.perf_counter()
    with make_columnar_reader(url, num_epochs=1, workers_count=1,
                              reader_pool_type='thread', seed=args.seed,
                              transform_spec=spec,
                              autotune=options) as reader:
        controller = reader.autotune
        check(controller is not None, '%s: no controller' % label)
        pool = reader._pool
        loader = TorchDataLoader(reader, batch_size=batch, device=device)
        while True:
            last = (controller.report()['ticks'] >= TUNE_TICKS
                    or time.perf_counter() - start >= TUNE_MAX_S
                    or len(epochs) == TUNE_MAX_EPOCHS - 1)
            if last:
                pool.set_results_queue_bound(TUNE_QUEUE_BOUND)
                bound = pool.results_queue_bound
            seen = []
            t0 = time.perf_counter()
            batches = prefetch_to_device(iter(loader), size=2, device=device,
                                         stats=reader.stats,
                                         goodput=loader.goodput)
            with contextlib.closing(batches):
                for b in batches:
                    loss = float(step(b['image'], b['label']))
                    seen.append(b['idx'].cpu())
                    steps += 1
            elapsed = time.perf_counter() - t0
            check(math.isfinite(loss), '%s: non-finite loss' % label)
            seen = torch.cat(seen).numpy()
            check(np.array_equal(np.sort(seen), np.arange(rows)),
                  '%s epoch %d: %d images, not each once'
                  % (label, len(epochs) + 1, len(seen)))
            # each epoch's ledger: every row delivered exactly once across
            # the resizes
            reader.audit().assert_complete()
            epochs.append((len(seen) / elapsed, pool.workers_count,
                           controller.report()['ticks']))
            if last:
                break
        report = controller.report()
        workers = pool.workers_count
    launches = dict(kernels.LAUNCHES)
    ups = [a for a in report['actions']
           if a['knob'] == 'workers_count' and a['direction'] == 'up']
    graded = [a for a in ups if a.get('graded') == 'measured']
    for a in report['actions']:
        log('%s action %s' % (label, json.dumps(a, sort_keys=True,
                                                 default=str)))
    # the sensor values first: a gate below that fails has them above it
    log('%s: %d row groups, %d epochs, %d CNN steps on K4, every epoch '
        'audited complete; images/s by epoch %s (workers %s, ticks %s); '
        'workers 1 -> %d (os.cpu_count() %s, worker cap %s); %d actions, %d '
        'workers_count up, %d graded; model error %s; queue bound %s live '
        '[%s]'
        % (label, groups, len(epochs), steps,
           ' '.join('%.1f' % e[0] for e in epochs),
           ' '.join(str(e[1]) for e in epochs),
           ' '.join(str(e[2]) for e in epochs), workers, os.cpu_count(),
           report['config']['worker_cap'], report['actions_total'],
           len(ups), len(graded), json.dumps(report['prediction']), bound,
           CARD))
    log('%s: images/s first epoch %.1f, last epoch %.1f [%s]'
        % (label, epochs[0][0], epochs[-1][0], CARD))
    check(bound == TUNE_QUEUE_BOUND, '%s: the queue bound reads %r, not %d'
          % (label, bound, TUNE_QUEUE_BOUND))
    check(graded, '%s: no graded workers_count move up: %s'
          % (label, json.dumps(report['actions'], default=str)))
    check(workers > 1, '%s: %d workers at the end' % (label, workers))
    if device == 'cuda':
        check(launches['normalize'] == steps,
              'K4 launched %d times in %d autotuned png steps'
              % (launches['normalize'], steps))
    return launches


def profiled_lm_line(torch, np, kernels, args, d, device, scratch, url, cfg,
                     step):
    """(b) The LM store's NGram windows on TWO worker interpreters,
    ``autotune=True`` (0.5 s ticks, calibrating on its first model tick,
    staging to ``device``), ``debug_port=0``, ``trace=True``, a
    flight-record directory, into AdamW steps from ``prefetch_to_device(
    stats=, tracer=)``; from step 4 a thread resizes to 4 then 1, sets the
    readahead depth to 2 and widens the ventilation window by 2. Then the
    profile, its sentence, the routes, the flight record and
    ``infeed_diagnosis``. Returns the launch counts."""
    from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.profiler import (CEILING_STAGES,
                                              SANE_FRACTION_LIMIT)
    from petastorm_tpu_torch.torch_utils import infeed_diagnosis
    label = 'autotune LM'
    flights = tempfile.mkdtemp(dir=d, prefix='flight-')
    options = dict(tick_interval_s=TUNE_TICK_S, scratch_dir=scratch,
                   device=device)
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times, acts = [], {}
    with make_reader(url, schema_fields=_ngram(), num_epochs=TUNE_LM_EPOCHS,
                     reader_pool_type='process', workers_count=2,
                     seed=args.seed, autotune=options, debug_port=0,
                     trace=True, flight_record_dir=flights) as reader:
        pool, job = reader._pool, reader._pool.ventilation
        port = reader.debug_port

        def actuate():
            acts['up'] = pool.resize(4, timeout_s=30)
            acts['down'] = pool.resize(1, timeout_s=30)
            acts['hits_before'] = reader.stats.snapshot().get(
                'readahead_hits', 0)
            pool.set_readahead_depth(2)
            acts['depth'] = pool.readahead_depth
            window = job.max_in_flight + 2
            job.set_max_in_flight(window)
            acts['window'] = (window, job.max_in_flight)

        actuator = threading.Thread(target=actuate, daemon=True,
                                    name='smoke-actuator')
        loader = TorchDataLoader(reader, batch_size=BATCH, drop_last=True,
                                 device=device)
        batches = prefetch_to_device(iter(loader), size=2, device=device,
                                     stats=reader.stats,
                                     tracer=reader.tracer,
                                     goodput=loader.goodput)
        first = None
        with contextlib.closing(batches):
            for i, batch in enumerate(batches):
                if i == TUNE_ACTUATE_AT:
                    actuator.start()
                t0 = time.perf_counter()
                first = first or t0
                loss = float(loader.goodput.fence(step(*_lm_targets(
                    torch, batch))))
                times.append(time.perf_counter() - t0)
                check(math.isfinite(loss), '%s: non-finite loss' % label)
        wall = time.perf_counter() - first
        actuator.join(60)
        check(not actuator.is_alive(), '%s: the actuations hung' % label)
        windows = len(times) * BATCH
        check(len(times) == TUNE_LM_EPOCHS * OBS_FILES,
              '%s: %d steps, not %d' % (label, len(times),
                                        TUNE_LM_EPOCHS * OBS_FILES))
        audit = reader.audit().assert_complete()
        hits = reader.stats.snapshot().get('readahead_hits', 0)
        rate = windows / wall
        profile = reader.profile(device=device, samples_per_sec=rate)
        calibration = reader.calibration
        sentence = reader.explain_throughput(calibrate='cached')
        routes = {r: http_get(port, r)
                  for r in ('/profile', '/autotune', '/metrics')}
        record_path = reader.dump_flight_record()
        diagnosis = infeed_diagnosis(reader.diagnostics, roofline=profile)
        report = reader.autotune.report()
    launches = dict(kernels.LAUNCHES)
    lingering = [t.name for t in threading.enumerate()
                 if t.name.endswith('-autotune')]
    check(not lingering, '%s: %s outlived the reader' % (label, lingering))
    check(acts.get('up') == 4 and acts.get('down') == 1,
          '%s: resize(4) gave %s, resize(1) gave %s'
          % (label, acts.get('up'), acts.get('down')))
    check(acts['depth'] == 2 and hits > acts['hits_before'],
          '%s: readahead depth %s, hits %d before the set, %d after'
          % (label, acts['depth'], acts['hits_before'], hits))
    check(acts['window'][0] == acts['window'][1],
          '%s: set_max_in_flight(%d) reads back %d'
          % ((label,) + acts['window']))
    if device == 'cuda':
        check(all(launches[k] == len(times) * cfg.n_layers for k in FLASH),
              '%s: launches %r for %d steps' % (label, launches, len(times)))
    check(profile['calibrated'] is True, '%s: profile not calibrated'
          % label)
    probe = calibration['probes']['device_stage']
    card = CARD.split(',')[0].strip()
    check(probe['device'] == (card if device == 'cuda' else 'cpu')
          and probe['rows_per_s'] > 0,
          '%s: the staging probe names %r at %s rows/s, the card is %r'
          % (label, probe['device'], probe['rows_per_s'], card))
    check(profile['binding_stage'] in CEILING_STAGES,
          '%s: binding stage %r' % (label, profile['binding_stage']))
    fraction = profile['roofline_fraction']
    check(fraction is not None and (fraction <= SANE_FRACTION_LIMIT
                                    or 'drained' in profile.get('warning',
                                                                 '')),
          '%s: roofline fraction %s, warning %r'
          % (label, fraction, profile.get('warning')))
    check(sentence.startswith('measured '), '%s: explain_throughput %r'
          % (label, sentence))
    for route in ('/profile', '/autotune'):
        status, body = routes[route]
        check(status == 200 and isinstance(json.loads(body), dict),
              '%s: %s %d' % (label, route, status))
    metrics = routes['/metrics'][1]
    for name in ('petastorm_tpu_stage_ceiling_', 'petastorm_tpu_roofline_'
                 'fraction', 'binding_stage', 'petastorm_tpu_autotune_ticks',
                 'petastorm_tpu_autotune_workers'):
        check(name in metrics, '%s: /metrics names no %s' % (label, name))
    with open(record_path) as f:
        record = json.load(f)
    check(record.get('roofline') and record.get('autotune'),
          '%s: flight record roofline %r, autotune %r'
          % (label, record.get('roofline'), record.get('autotune')))
    check('roofline' in diagnosis, '%s: infeed_diagnosis has no roofline'
          % label)
    ceilings = calibration['ceilings']
    log('%s: %d steps on K1-K3 (%d windows in %.3f s, %.1f windows/s), '
        'audit complete (%d epochs); resize(4) -> %d, resize(1) -> %d, '
        'readahead depth %d (hits %d -> %d), window %d; %d controller '
        'actions, %d ticks [%s]'
        % (label, len(times), windows, wall, rate, len(audit['epochs']),
           acts['up'], acts['down'], acts['depth'], acts['hits_before'], hits,
           acts['window'][1], report['actions_total'], report['ticks'],
           CARD))
    for a in report['actions']:
        log('%s action %s' % (label, json.dumps(a, sort_keys=True,
                                                 default=str)))
    log('%s calibration: ceilings (rows/s) %s; staging probe %s rows/s, '
        '%s MB/s, %d bytes, %s s (device %r); decode %s rows/s; storage '
        '%s MB/s sequential [%s]'
        % (label, json.dumps(ceilings, sort_keys=True), probe['rows_per_s'],
           probe['mb_per_s'], probe['payload_bytes'], probe['seconds'],
           probe['device'], calibration['probes']['decode']['rows_per_s'],
           calibration['probes']['storage']['seq_read_mb_per_s'], CARD))
    log('%s profile: measured %.1f windows/s, binding %s at %s, fraction '
        '%s, effective ceilings %s%s; %s [%s]'
        % (label, rate, profile['binding_stage'],
           profile['binding_ceiling_samples_per_s'], fraction,
           json.dumps(profile['effective_ceilings'], sort_keys=True),
           '; warning: ' + profile['warning'] if 'warning' in profile
           else '', sentence, CARD))
    return launches


def tune_kill_switches(torch, url, d, args):
    """(c) ``PETASTORM_TPU_AUTOTUNE=0`` with ``autotune=True``: no controller
    thread, no file in the scratch directory; ``PETASTORM_TPU_PROFILER=0``:
    ``/profile`` 404 and ``profile()`` raises JAX's ``RuntimeError``."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.autotune import AUTOTUNE_ENV_VAR
    from petastorm_tpu_torch.profiler import PROFILER_ENV_VAR
    label = 'autotune kill switches'
    scratch = tempfile.mkdtemp(dir=d, prefix='scratch-off-')
    before = set(threading.enumerate())
    os.environ[AUTOTUNE_ENV_VAR] = '0'
    try:
        with make_reader(url, schema_fields=_ngram(), num_epochs=1,
                         workers_count=2, seed=args.seed,
                         autotune=dict(scratch_dir=scratch)) as reader:
            threads = [t.name for t in set(threading.enumerate()) - before
                       if t.name.endswith('-autotune')]
            chunks = sum(1 for _ in reader.iter_ngram_chunks())
            controller = reader.autotune
    finally:
        os.environ.pop(AUTOTUNE_ENV_VAR, None)
    check(controller is None and not threads and not os.listdir(scratch)
          and chunks == OBS_FILES,
          '%s: controller %r, threads %s, scratch %s, %d chunks'
          % (label, controller, threads, os.listdir(scratch), chunks))
    os.environ[PROFILER_ENV_VAR] = '0'
    try:
        with make_reader(url, schema_fields=_ngram(), num_epochs=1,
                         workers_count=2, seed=args.seed,
                         debug_port=0) as reader:
            status = http_get(reader.debug_port, '/profile')
            try:
                reader.profile()
                raised = None
            except RuntimeError as e:
                raised = str(e)
            sum(1 for _ in reader.iter_ngram_chunks())
    finally:
        os.environ.pop(PROFILER_ENV_VAR, None)
    want = 'the roofline profiler is disabled via PETASTORM_TPU_PROFILER=0'
    check(status[0] == 404 and raised == want,
          '%s: /profile %d, profile() raised %r' % (label, status[0], raised))
    log('%s: PETASTORM_TPU_AUTOTUNE=0 with autotune=True: no controller, no '
        'thread, no scratch file; PETASTORM_TPU_PROFILER=0: /profile 404, '
        'profile() raises %r' % (label, raised))


def tune_cost_run(torch, url, step, device, args, tuned, scratch):
    """(d) One run: ``TUNE_COST_EPOCHS`` epochs of the LM store on 4 worker
    threads into AdamW steps, with ``autotune`` (0.5 s ticks,
    ``calibrate='force'``: its first model tick probes, staging to the card
    while steps are in flight) or without. Returns the steady step (the
    median of the steps after the first)."""
    from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                     prefetch_to_device)
    kw = {}
    if tuned:
        kw['autotune'] = dict(tick_interval_s=TUNE_TICK_S, calibrate='force',
                              scratch_dir=scratch, device=device)
    times = []
    with make_reader(url, schema_fields=_ngram(),
                     num_epochs=TUNE_COST_EPOCHS, workers_count=4,
                     seed=args.seed, **kw) as reader:
        loader = TorchDataLoader(reader, batch_size=BATCH, drop_last=True,
                                 device=device)
        batches = prefetch_to_device(iter(loader), size=2, device=device,
                                     goodput=loader.goodput)
        with contextlib.closing(batches):
            for batch in batches:
                t0 = time.perf_counter()
                loss = float(loader.goodput.fence(step(*_lm_targets(
                    torch, batch))))
                times.append(time.perf_counter() - t0)
        check(math.isfinite(loss), 'autotune cost: non-finite loss')
        check((reader.autotune is not None) == tuned,
              'autotune cost: controller %r' % reader.autotune)
    check(len(times) == TUNE_COST_EPOCHS * OBS_FILES,
          'autotune cost: %d steps' % len(times))
    return statistics.median(times[1:])


def tune_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
              image_rows=IMAGE_ROWS, image_batch=IMAGE_BATCH,
              image_size=IMAGE_SIZE):
    """Phase 19: the roofline profiler and the autotune controller. (a)
    the autotuned png line on K4, (b) the profiled, autotuned LM on the
    process pool on K1-K3, (c) the kill switches, (d) the LM steady step
    with autotune off against on. The calibration and scratch directories
    are temporary; an ERROR record of the controller fails the phase.
    Returns the launch counts of (a) and of the LM steps of (b) and (d)."""
    from petastorm_tpu_torch.autotune import AUTOTUNE_DIR_ENV_VAR
    from petastorm_tpu_torch.profiler import CALIBRATION_DIR_ENV_VAR
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    tune_log = TuneLog()
    logger = logging.getLogger('petastorm_tpu_torch.autotune')
    logger.addHandler(tune_log)
    saved = {k: os.environ.get(k)
             for k in (CALIBRATION_DIR_ENV_VAR, AUTOTUNE_DIR_ENV_VAR)}
    try:
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix='.smoke-store-') as d:
            os.environ[CALIBRATION_DIR_ENV_VAR] = os.path.join(d, 'cal')
            scratch = os.path.join(d, 'scratch')
            os.environ[AUTOTUNE_DIR_ENV_VAR] = scratch
            phase = time.perf_counter()
            png = tuned_png_line(torch, np, kernels, args, d, device,
                                 scratch, image_rows, image_batch,
                                 image_size)
            tune_log.check('autotune png')
            log('autotune png line %.1f s' % (time.perf_counter() - phase))
            url = 'file://' + os.path.join(d, 'tokens')
            write_store(np, url, cfg.max_seq_len, cfg.vocab_size,
                        OBS_FILES * OBS_ROWS_PER_FILE, args.seed,
                        rows_per_file=OBS_ROWS_PER_FILE)
            params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                              device=device)
            _, step = tlm.make_train_step(cfg, params)
            phase = time.perf_counter()
            lm = profiled_lm_line(torch, np, kernels, args, d, device,
                                  scratch, url, cfg, step)
            tune_log.check('autotune LM')
            log('autotune LM line %.1f s' % (time.perf_counter() - phase))
            phase = time.perf_counter()
            tune_kill_switches(torch, url, d, args)
            log('autotune kill switches %.1f s'
                % (time.perf_counter() - phase))
            phase = time.perf_counter()
            if device == 'cuda':
                torch.cuda.synchronize()
            kernels.reset_launch_counts()
            steady = {False: [], True: []}
            for n in range(TUNE_COST_PAIRS):
                for tuned in ((False, True) if n % 2 == 0 else (True, False)):
                    steady[tuned].append(tune_cost_run(
                        torch, url, step, device, args, tuned, scratch))
            cost = dict(kernels.LAUNCHES)
            tune_log.check('autotune cost')
            log('autotune cost runs %.1f s' % (time.perf_counter() - phase))
    finally:
        logger.removeHandler(tune_log)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    off, on = steady[False], steady[True]
    log('autotune cost LM steady step (median of steps 2-%d), %d pairs: off '
        '%s ms; on %s ms; on / off by means %.4f, by medians %.4f; the off '
        "runs' spread %.4f (max / min) [%s]"
        % (TUNE_COST_EPOCHS * OBS_FILES, TUNE_COST_PAIRS,
           ' '.join('%.3f' % (t * 1e3) for t in off),
           ' '.join('%.3f' % (t * 1e3) for t in on),
           statistics.mean(on) / statistics.mean(off),
           statistics.median(on) / statistics.median(off),
           max(off) / min(off), CARD))
    runs = 2 * TUNE_COST_PAIRS * TUNE_COST_EPOCHS * OBS_FILES
    if device == 'cuda':
        check(all(cost[k] == runs * cfg.n_layers for k in FLASH),
              'autotune cost launches %r for %d steps' % (cost, runs))
    for k in FLASH:
        lm[k] += cost[k]
    log('autotune launches: png %s; LM %s' % (json.dumps(png),
                                              json.dumps(lm)))
    return png, lm


# ---------------------------------------------------------------------------
# phase 20: the resilience line
# ---------------------------------------------------------------------------

RES_EPOCHS = 2                    # (a): 16 steps a run
RES_WORKERS = 4
RES_READAHEAD = 2
RES_HEDGE_S = 0.05                # (b)'s fixed hedge threshold
RES_KILL_EPOCHS = 2               # (c) under worker-kill: 16 steps, enough
                                  # reads that interpreters die
RES_POISON_GROUP = 3              # (d): the row group whose rows crash
RES_POISON = dict(poison_threshold=2, max_respawns=5)
RES_BUDGET = dict(max_respawns=2, poison_threshold=99)
RES_LOUD_S = 60.0                 # a spent budget raises within this
RES_LOUD_EPOCHS = 4               # (e)'s kill: items still to ventilate
RES_LOUD_KILL_S = 0.5             # (e): from the freeze to the SIGKILL
RES_COST_PAIRS = 6                # (f): retry off/on runs


def chaos_specs(seed):
    """The phase's scenarios, armed by ``PETASTORM_TPU_CHAOS``, each from a
    seed derived from ``--seed``."""
    return {'transient': 'transient-errors:%d' % (101 + seed),
            'truncated': 'truncated-reads:%d' % (202 + seed),
            'hangs': 'read-hangs:%d:hang_rate=0.1,hang_s=0.3' % (404 + seed),
            'kill': 'worker-kill:%d:kill_after_reads=6,max_kills=2'
                    % (505 + seed)}


def freeze(proc):
    """SIGSTOP a worker interpreter and return it. Workers finish an item
    in milliseconds while the consumer takes a step a batch, so a bare
    SIGKILL mostly finds the victim idle with its results already sent;
    frozen first, it holds the items ventilated to it meanwhile, which the
    SIGKILL then loses. The work socket deals items round robin, so of
    any ``RES_WORKERS`` sent after the freeze one is the victim's: the
    kill waits for them (a kill one batch after the freeze can find the
    victim holding none)."""
    import signal
    os.kill(proc.pid, signal.SIGSTOP)
    return proc


@contextlib.contextmanager
def chaos(spec):
    """``PETASTORM_TPU_CHAOS=spec`` (None: unset) with a fresh injector
    cache, so a run replays its scenario from occurrence 0; yields the
    injector of this process (None when unarmed)."""
    from petastorm_tpu_torch import faultfs
    saved = os.environ.get(faultfs.CHAOS_ENV_VAR)
    faultfs.reset_chaos_cache()
    if spec is None:
        os.environ.pop(faultfs.CHAOS_ENV_VAR, None)
    else:
        os.environ[faultfs.CHAOS_ENV_VAR] = spec
    try:
        yield faultfs.chaos_from_env()
    finally:
        faultfs.reset_chaos_cache()
        if saved is None:
            os.environ.pop(faultfs.CHAOS_ENV_VAR, None)
        else:
            os.environ[faultfs.CHAOS_ENV_VAR] = saved


def resilient_lm_run(torch, url, step, device, args, label, epochs=RES_EPOCHS,
                     pool='thread', kill=False, **reader_kw):
    """``epochs`` of the LM store (NGram windows) on ``RES_WORKERS`` workers
    of ``pool`` -> ``TorchDataLoader`` -> ``prefetch_to_device`` -> AdamW
    steps on K1-K3. ``kill``: one worker interpreter is frozen as the
    reader starts and SIGKILLed at the first batch after more than
    ``RES_WORKERS`` items went out (:func:`freeze`).
    Returns the run's facts: each window as ``(step, host bytes of both
    timesteps)``, the losses, the step times, the stats snapshot, the
    audit, the pool's recovery records and the kill's time."""
    from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                     prefetch_to_device)
    facts = {'windows': [], 'losses': [], 'times': [], 'killed_at': None}
    start = time.perf_counter()
    with make_reader(url, schema_fields=_ngram(), num_epochs=epochs,
                     workers_count=RES_WORKERS, seed=args.seed,
                     reader_pool_type=pool, **reader_kw) as reader:
        check(reader.lineage.enabled, '%s: lineage is off' % label)
        loader = TorchDataLoader(reader, batch_size=BATCH, drop_last=True,
                                 device=device)
        batches = prefetch_to_device(iter(loader), size=2, device=device,
                                     goodput=loader.goodput)
        with contextlib.closing(batches):
            if kill:
                victim = freeze(reader._pool._processes[0])
                frozen_at = reader._pool._ventilated
            for batch in batches:
                # one item counted may still be on its way out
                if (kill and facts['killed_at'] is None
                        and reader._pool._ventilated - frozen_at
                        > RES_WORKERS):
                    facts['killed_at'] = time.monotonic()
                    victim.kill()
                t0 = time.perf_counter()
                tokens, targets = _lm_targets(torch, batch)
                loss = float(loader.goodput.fence(step(tokens, targets)))
                facts['times'].append(time.perf_counter() - t0)
                facts['losses'].append(loss)
                steps = batch[0]['step'].cpu().numpy()
                now = tokens.cpu().numpy()
                nxt = batch[1]['tokens'].cpu().numpy()
                facts['windows'].extend(
                    (int(s), now[i].tobytes() + nxt[i].tobytes())
                    for i, s in enumerate(steps))
        check(not kill or facts['killed_at'] is not None,
              '%s: fewer than %d items went out after the freeze'
              % (label, RES_WORKERS))
        facts['report'] = reader.audit().assert_complete()
        facts['snapshot'] = reader.stats.snapshot()
        facts['recoveries'] = list(getattr(reader._pool, 'recoveries', ()))
    facts['seconds'] = time.perf_counter() - start
    check(len(facts['losses']) == epochs * OBS_FILES
          and all(math.isfinite(x) for x in facts['losses']),
          '%s: %d steps, losses %s' % (label, len(facts['losses']),
                                       facts['losses']))
    for epoch in facts['report']['epochs'].values():
        check(epoch['complete'] and not epoch['dup_items']
              and not epoch['dropped_items'],
              '%s: audit %s' % (label, epoch))
    return facts


def retry_runs(torch, url, step, device, args, specs):
    """(a) The LM under ``transient-errors`` and ``truncated-reads``, then
    clean: every window equals the clean run's bit for bit, the injector
    fired, reads were retried and none failed for good."""
    runs = {}
    for name, spec in (('transient', specs['transient']),
                       ('truncated', specs['truncated']), ('clean', None)):
        label = 'resilience retry %s' % (spec or 'clean')
        with chaos(spec) as injector:
            facts = resilient_lm_run(torch, url, step, device, args, label,
                                     io_readahead=RES_READAHEAD)
            facts['injected'] = dict(injector.injected) if injector else {}
        runs[name] = facts
    clean = sorted(runs['clean']['windows'])
    for name in ('transient', 'truncated'):
        facts, spec = runs[name], specs[name]
        snap = facts['snapshot']
        check(sorted(facts['windows']) == clean,
              'resilience retry %s: the windows differ from the clean run'
              % spec)
        check(sum(facts['injected'].values()) > 0 and snap['io_retries'] > 0
              and snap['io_permanent_failures'] == 0,
              'resilience retry %s: injected %s, io_retries %d, '
              'io_permanent_failures %d' % (spec, facts['injected'],
                                            snap['io_retries'],
                                            snap['io_permanent_failures']))
    for name in ('transient', 'truncated', 'clean'):
        facts = runs[name]
        snap = facts['snapshot']
        log('resilience retry %s: %d steps, loss %.4f -> %.4f, %d windows '
            '(== the clean run\'s bit for bit, keyed by step), injected %s, '
            'io_retries %d, io_permanent_failures %d, audit complete (%d '
            'epochs), steady step %.2f ms, run %.2f s [%s]'
            % (specs.get(name, 'clean'), len(facts['losses']),
               facts['losses'][0], facts['losses'][-1],
               len(facts['windows']), json.dumps(facts['injected']),
               snap['io_retries'], snap['io_permanent_failures'],
               len(facts['report']['epochs']),
               statistics.median(facts['times'][1:]) * 1e3,
               facts['seconds'], CARD))
    return runs


def hedge_runs(torch, np, d, device, args, spec, rows):
    """(b) The token store on 4 threads under ``read-hangs``, hedged and
    not: rows equal the generator in both; hedges fired and won."""
    from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
    url = 'file://' + os.path.join(d, 'token_rows')
    tokens = write_token_rows(np, url, rows, 2049, 32000, args.seed)
    saved = os.environ.get(DEVICE_DECODE_ENV_VAR)
    out = {}
    try:
        for hedge in (RES_HEDGE_S, False):
            label = 'resilience hedge=%s' % hedge
            with chaos(spec) as injector:
                start = time.perf_counter()
                got = token_pass(torch, np, url, tokens, 'thread', 'on',
                                 device, TOKEN_BATCH, label=label,
                                 workers=RES_WORKERS, hedge=hedge)
                wall = time.perf_counter() - start
                out[hedge] = (got['diagnostics'], dict(injector.injected),
                              wall, len(tokens) / got['rate'])
    finally:
        if saved is None:
            os.environ.pop(DEVICE_DECODE_ENV_VAR, None)
        else:
            os.environ[DEVICE_DECODE_ENV_VAR] = saved
    snap = out[RES_HEDGE_S][0]
    check(snap['io_hedges'] > 0 and snap['io_hedge_wins'] > 0,
          'resilience hedge: io_hedges %d, io_hedge_wins %d'
          % (snap['io_hedges'], snap['io_hedge_wins']))
    for hedge in (RES_HEDGE_S, False):
        snap, injected, wall, pass_s = out[hedge]
        log('resilience hedge=%s under %s: %d rows == generator, injected '
            '%s, io_hedges %d, io_hedge_wins %d, io_hedge_losses %d; pass '
            '%.3f s (reader open to last batch), wall %.3f s [%s]'
            % (hedge, spec, len(tokens), json.dumps(injected),
               snap['io_hedges'], snap['io_hedge_wins'],
               snap['io_hedge_losses'], pass_s, wall, CARD))
    return out


def recovery_runs(torch, url, step, device, args, spec, clean):
    """(c) The LM on 4 worker interpreters, one SIGKILLed after the first
    batch, then under ``worker-kill``: respawned, the lost items sent
    again, every window once, ``degraded`` naming ``worker-respawns``."""
    from petastorm_tpu_torch.health import classify_pipeline
    runs = {}
    for name, spec_or_none, kill, epochs in (
            ('sigkill', None, True, RES_KILL_EPOCHS),
            ('worker-kill', spec, False, RES_KILL_EPOCHS)):
        label = 'resilience recovery %s' % (spec_or_none or 'SIGKILL')
        with chaos(spec_or_none):
            facts = resilient_lm_run(torch, url, step, device, args, label,
                                     epochs=epochs, pool='process',
                                     kill=kill)
        # each window of the store, once an epoch
        once = sorted(clean)[::RES_EPOCHS] * epochs
        snap = facts['snapshot']
        verdict = classify_pipeline({}, snap)
        check(snap['worker_respawns'] >= 1 and snap['items_redispatched'] >= 1,
              '%s: worker_respawns %d, items_redispatched %d'
              % (label, snap['worker_respawns'], snap['items_redispatched']))
        check(sorted(facts['windows']) == sorted(once),
              '%s: the windows are not the store\'s, each once an epoch'
              % label)
        check(verdict['state'] == 'degraded'
              and any('worker-respawns' in c
                      for c in verdict['degraded_causes']),
              '%s: verdict %s' % (label, verdict))
        episodes = facts['recoveries']
        # an item sent again can die again with a later victim: it then
        # counts for the later episode
        redelivered = [e for e in episodes
                       if e['first_redelivery'] is not None]
        check(redelivered, '%s: recovery episodes %s' % (label, episodes))
        first = redelivered[0]
        origin = facts['killed_at'] if kill else first['began']
        log('%s: %d steps, loss %.4f -> %.4f, %d windows (each once, == the '
            'clean run\'s), audit complete; worker_respawns %d, '
            'items_redispatched %d, exit codes %s; %.3f s from the %s to the '
            'first redispatched delivery (detected after %.3f s, finalized '
            'after %.3f s); verdict %s: %s; run %.2f s [%s]'
            % (label, len(facts['losses']), facts['losses'][0],
               facts['losses'][-1], len(facts['windows']),
               snap['worker_respawns'], snap['items_redispatched'],
               '%s in %d episode(s)' % (
                   [c for e in episodes for c in e['codes']],
                   len(episodes)),
               first['first_redelivery'] - origin,
               'kill' if kill else 'detected death',
               first['began'] - origin, first['finalized'] - origin,
               verdict['state'], '; '.join(verdict['degraded_causes']),
               facts['seconds'], CARD))
        runs[name] = facts
    return runs


def poisoned_png_run(torch, np, kernels, args, d, device, rows, batch, size):
    """(d) The png store on 2 threads with a row transform that raises
    ``SimulatedWorkerCrash`` on one row group's rows, under
    ``worker_recovery=dict(poison_threshold=2, max_respawns=5)``, into
    CNN steps on K4: the item is quarantined after 2 deaths, the others
    arrive once."""
    from petastorm_tpu_torch import (TorchDataLoader, TransformSpec,
                                     make_reader, prefetch_to_device)
    from petastorm_tpu_torch.faultfs import SimulatedWorkerCrash
    from petastorm_tpu_torch.health import classify_pipeline
    from petastorm_tpu_torch.models import image_cnn as cnn
    label = 'resilience poison png'
    path = os.path.join(d, 'images')
    url = 'file://' + path
    write_indexed_images(np, url, rows, args.seed)
    sources = source_idx(path)
    poisoned_group = sorted(sources)[RES_POISON_GROUP % len(sources)]
    poisoned = {int(i) for i in sources[poisoned_group]}
    want = sorted(set(range(rows)) - poisoned)

    def crash_or_resize(row):
        import cv2
        if int(row['idx']) in poisoned:
            raise SimulatedWorkerCrash('poison row %d' % row['idx'])
        row['image'] = cv2.resize(row['image'], (size, size),
                                  interpolation=cv2.INTER_AREA)
        return row

    spec = TransformSpec(crash_or_resize,
                         edit_fields=[('image', np.uint8, (size, size, 3),
                                       False)])
    params = cnn.init(torch.Generator().manual_seed(args.seed),
                      num_classes=IMAGE_CLASSES, device=device)
    step = cnn.make_train_step(params, lr=1e-3)
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    seen, losses = [], []
    start = time.perf_counter()
    with make_reader(url, schema_fields=['idx', 'image', 'label'],
                     num_epochs=1, workers_count=2, seed=args.seed,
                     transform_spec=spec,
                     worker_recovery=RES_POISON) as reader:
        loader = TorchDataLoader(reader, batch_size=batch, device=device)
        batches = prefetch_to_device(iter(loader), size=2, device=device)
        with contextlib.closing(batches):
            for b in batches:
                losses.append(float(step(b['image'], b['label'])))
                seen.append(b['idx'].cpu())
        report = reader.audit().assert_complete()
        snap = reader.stats.snapshot()
        records = reader.lineage.quarantines()
    wall = time.perf_counter() - start
    launches = dict(kernels.LAUNCHES)
    seen = sorted(torch.cat(seen).numpy().tolist())
    epoch = report['epochs'][0]
    check(snap['poison_items_quarantined'] == 1
          and snap['worker_respawns'] == 2,
          '%s: poison_items_quarantined %d, worker_respawns %d'
          % (label, snap['poison_items_quarantined'],
             snap['worker_respawns']))
    check(len(records) == 1 and records[0]['stage'] == 'worker-crash'
          and (os.path.basename(records[0]['path']), records[0]['row_group'])
          == (os.path.basename(poisoned_group[0]), poisoned_group[1])
          and records[0]['rows'] == len(poisoned)
          and len(epoch['quarantined_items']) == 1
          and epoch['rows_quarantined'] == len(poisoned),
          '%s: records %s, audit %s' % (label, records, epoch))
    check(seen == want, '%s: %d images, not the %d clean ones once'
          % (label, len(seen), len(want)))
    check(all(math.isfinite(x) for x in losses), '%s: losses %s'
          % (label, losses))
    if device == 'cuda':
        check(launches['normalize'] == len(losses),
              '%s: K4 launched %d times in %d steps'
              % (label, launches['normalize'], len(losses)))
    verdict = classify_pipeline({}, snap)
    log('%s: row group %s:%d (%d rows) killed its worker twice and was '
        'quarantined (stage %s, %d rows), worker_respawns %d, '
        'items_redispatched %d; %d other images each once into %d CNN steps '
        'on K4 (loss %.4f -> %.4f); verdict %s: %s; run %.2f s [%s]'
        % (label, os.path.basename(poisoned_group[0]), poisoned_group[1],
           len(poisoned), records[0]['stage'], records[0]['rows'],
           snap['worker_respawns'], snap['items_redispatched'], len(seen),
           len(losses), losses[0], losses[-1], verdict['state'],
           '; '.join(verdict['degraded_causes']), wall, CARD))
    return launches


def loud_failures(torch, np, url, d, args):
    """(e) What recovery must not swallow: a removed data file raises
    ``FileNotFoundError`` on its first attempt with no respawn; a kill
    with ``worker_recovery=False`` raises JAX's ``RuntimeError``; a spent
    budget raises within ``RES_LOUD_S``."""
    import shutil
    from petastorm_tpu_torch import TransformSpec, make_reader
    from petastorm_tpu_torch.faultfs import SimulatedWorkerCrash
    label = 'resilience loud'
    gone = os.path.join(d, 'gone')
    shutil.copytree(url[len('file://'):], gone)
    reader = make_reader('file://' + gone, schema_fields=['step'],
                         workers_count=1, shuffle_row_groups=False)
    victim = reader.pieces[-1].path
    os.remove(victim)
    raised = None
    start = time.perf_counter()
    try:
        with reader:
            for _ in reader:
                pass
    except FileNotFoundError as e:
        raised = e
    snap = reader.stats.snapshot()
    check(raised is not None and snap['io_permanent_failures'] == 1
          and snap['io_retries'] == 0 and snap['worker_respawns'] == 0,
          '%s: removed file raised %r, io_permanent_failures %d, io_retries '
          '%d, worker_respawns %d' % (label, raised,
                                      snap['io_permanent_failures'],
                                      snap['io_retries'],
                                      snap['worker_respawns']))
    log('%s: removed %s raised %s in %.3f s on its first attempt '
        '(io_permanent_failures 1, io_retries 0, worker_respawns 0)'
        % (label, os.path.basename(victim), type(raised).__name__,
           time.perf_counter() - start))
    raised = killer = None
    start = time.perf_counter()
    try:
        with make_reader(url, schema_fields=['step'], workers_count=2,
                         num_epochs=RES_LOUD_EPOCHS,
                         reader_pool_type='process',
                         worker_recovery=False) as reader:
            iterator = iter(reader)
            next(iterator)
            # frozen, the victim holds the items sent to it, which may fill
            # the in-flight window and stall the pass: the kill comes from a
            # timer, so it lands whether or not the pass goes on meanwhile
            victim = freeze(reader._pool._processes[0])
            killer = threading.Timer(RES_LOUD_KILL_S, victim.kill)
            killer.start()
            for _ in iterator:
                pass
    except RuntimeError as e:
        raised = e
    finally:
        if killer is not None:
            killer.join()
    check(raised is not None and 'died with exit codes' in str(raised),
          '%s: a kill without recovery raised %r' % (label, raised))
    log('%s: SIGKILL with worker_recovery=False raised RuntimeError(%r) in '
        '%.3f s' % (label, str(raised), time.perf_counter() - start))

    def always_crash(row):
        raise SimulatedWorkerCrash('every item crashes')

    raised = None
    start = time.perf_counter()
    try:
        with make_reader(url, schema_fields=['step'], workers_count=1,
                         transform_spec=TransformSpec(always_crash),
                         worker_recovery=RES_BUDGET) as reader:
            for _ in reader:
                check(time.perf_counter() - start < RES_LOUD_S,
                      '%s: a spent budget ran on' % label)
            snap = reader.stats.snapshot()
    except SimulatedWorkerCrash as e:
        raised = e
        snap = reader.stats.snapshot()
    took = time.perf_counter() - start
    check(raised is not None and took < RES_LOUD_S
          and snap['worker_respawns'] == RES_BUDGET['max_respawns'],
          '%s: spent budget raised %r after %.3f s, worker_respawns %d'
          % (label, raised, took, snap['worker_respawns']))
    log('%s: a budget of %d respawns spent, the crash raised %s in %.3f s '
        '(limit %.0f s)' % (label, RES_BUDGET['max_respawns'],
                            type(raised).__name__, took, RES_LOUD_S))


def retry_cost(torch, url, step, device, args):
    """(f) The clean path's cost: the LM steady step (2 epochs, 4 threads)
    with ``retry=False`` and with the default, in ``RES_COST_PAIRS`` pairs
    in turns."""
    steady = {False: [], True: []}
    for n in range(RES_COST_PAIRS):
        for retry in ((False, True) if n % 2 == 0 else (True, False)):
            facts = resilient_lm_run(torch, url, step, device, args,
                                     'resilience cost retry=%s' % retry,
                                     retry=None if retry else False)
            steady[retry].append(statistics.median(facts['times'][1:]))
    off, on = steady[False], steady[True]
    log('resilience cost LM steady step (median of steps 2-%d), %d pairs: '
        'retry=False %s ms; default %s ms; default / off by means %.4f, by '
        "medians %.4f; the off runs' spread %.4f (max / min) [%s]"
        % (RES_EPOCHS * OBS_FILES, RES_COST_PAIRS,
           ' '.join('%.3f' % (t * 1e3) for t in off),
           ' '.join('%.3f' % (t * 1e3) for t in on),
           statistics.mean(on) / statistics.mean(off),
           statistics.median(on) / statistics.median(off),
           max(off) / min(off), CARD))
    return steady


def resilience_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
                    image_rows=IMAGE_ROWS, image_batch=IMAGE_BATCH,
                    image_size=IMAGE_SIZE, token_rows=TOKEN_ROWS):
    """Phase 20: resilience and the seeded fault injector on the card. (a)
    retry under injected faults on the LM (K1-K3), (b) hedged reads of the
    token store, (c) worker recovery on the process pool (K1-K3), (d) a
    poison item on the png line (K4), (e) the loud failures, (f) the
    clean path's cost. Returns the launch counts of the LM steps and of
    the png steps."""
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    specs = chaos_specs(args.seed)
    log('resilience scenarios (seeded from --seed %d): %s'
        % (args.seed, json.dumps(specs)))
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        url = 'file://' + os.path.join(d, 'tokens')
        write_store(np, url, cfg.max_seq_len, cfg.vocab_size,
                    OBS_FILES * OBS_ROWS_PER_FILE, args.seed,
                    rows_per_file=OBS_ROWS_PER_FILE)
        params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                          device=device)
        _, step = tlm.make_train_step(cfg, params)
        if device == 'cuda':
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        phase = time.perf_counter()
        retried = retry_runs(torch, url, step, device, args, specs)
        log('resilience (a) retry %.1f s' % (time.perf_counter() - phase))
        phase = time.perf_counter()
        recovery_runs(torch, url, step, device, args, specs['kill'],
                      retried['clean']['windows'])
        log('resilience (c) recovery %.1f s' % (time.perf_counter() - phase))
        phase = time.perf_counter()
        retry_cost(torch, url, step, device, args)
        log('resilience (f) cost %.1f s' % (time.perf_counter() - phase))
        lm = dict(kernels.LAUNCHES)
        runs = (3 * RES_EPOCHS + 2 * RES_KILL_EPOCHS
                + 2 * RES_COST_PAIRS * RES_EPOCHS) * OBS_FILES
        if device == 'cuda':
            check(all(lm[k] == runs * cfg.n_layers for k in FLASH),
                  'resilience LM launches %r for %d steps of %d layers'
                  % (lm, runs, cfg.n_layers))
        phase = time.perf_counter()
        hedge_runs(torch, np, d, device, args, specs['hangs'], token_rows)
        log('resilience (b) hedge %.1f s' % (time.perf_counter() - phase))
        phase = time.perf_counter()
        png = poisoned_png_run(torch, np, kernels, args, d, device,
                               image_rows, image_batch, image_size)
        log('resilience (d) poison png %.1f s' % (time.perf_counter() - phase))
        phase = time.perf_counter()
        loud_failures(torch, np, url, d, args)
        log('resilience (e) loud failures %.1f s'
            % (time.perf_counter() - phase))
    log('resilience launches: LM %s (%d steps); png %s'
        % (json.dumps(lm), runs, json.dumps(png)))
    return lm, png


def time_ms(torch, fn, reps):
    for _ in range(2):
        fn()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return statistics.median(samples)


def bounds(shape):
    """(bound_ms, bound_by, flops) per kernel at the causal bf16 path shape:
    operations over the bf16 tensor-core peak against compulsory bytes
    (each input read once, each output written once) over HBM rate."""
    b, h, l, d = shape
    pairs = b * h * l * (l + 1) // 2            # live causal (q, k) pairs
    elem = b * h * l * d * 2                    # one bf16 (B, H, L, D)
    row = b * h * l * 4                         # one float32 (B, H, L)
    work = {'flash_fwd': (4 * d * pairs, 4 * elem + row),
            'flash_bwd_dq': (6 * d * pairs, 5 * elem + 2 * row),
            'flash_bwd_dkdv': (8 * d * pairs, 6 * elem + 2 * row)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     'operations' if t_ops >= t_bytes else 'bytes', flops)
    return out


def timings(torch, kernels, gen, reps, shape=PATH_SHAPE):
    b, h, l, d = shape
    q, k, v, do = _operands(torch, gen, b, h, h, l, l, d, torch.bfloat16)
    kw = dict(n_heads=h, n_kv_heads=h, causal=True)
    o, lse = kernels.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    runs = {
        'flash_fwd': (lambda: kernels.flash_fwd(q, k, v, **kw),
                      lambda: kernels.flash_fwd_plain(q, k, v, **kw)),
        'flash_bwd_dq': (
            lambda: kernels.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
            lambda: kernels.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                               **kw)),
        'flash_bwd_dkdv': (
            lambda: kernels.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw),
            lambda: kernels.flash_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                 **kw)),
    }
    out = {}
    for name, (kern, plain) in runs.items():
        out[name] = {'ms': time_ms(torch, kern, reps),
                     'plain_ms': time_ms(torch, plain, max(3, reps // 4))}
    # yardsticks only: the port never calls these
    q4, k4, v4, do4 = (x.view(b, h, l, d) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out['flash_fwd']['library_ms'] = time_ms(
        torch, lambda: sdpa(q4, k4, v4, is_causal=True), reps)
    out['flash_fwd']['library'] = 'scaled_dot_product_attention'
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, True)
    o4, lse4, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    lib_bwd = aten._scaled_dot_product_flash_attention_backward
    bwd_ms = time_ms(torch, lambda: lib_bwd(do4, q4, k4, v4, o4, lse4, cum_q,
                                            cum_k, max_q, max_k, 0.0, True,
                                            seed, offset), reps)
    for name in ('flash_bwd_dq', 'flash_bwd_dkdv'):
        # one call computes dq, dk and dv: compare it with K2 + K3 together
        out[name]['library_ms'] = bwd_ms
        out[name]['library'] = ('_scaled_dot_product_flash_attention_backward'
                                ' (dq, dk, dv in one call)')
    return out


SMALL_HEAD_SHAPE = (2, 2, 32, 16)  # the dry run's float32 chunk pair


def small_head_times(torch, kernels, gen):
    """The float32 D = 16 kernels at the dry run's chunk pair, causal:
    each launch's device time (``loop_ms``, 200 back to back) beside its
    twin's and its bound (float32 FP32-core peak against compulsory
    bytes); logged, not in the kernel table (whose rows are the bf16
    path's)."""
    b, h, l, d = SMALL_HEAD_SHAPE
    q, k, v, do = _operands(torch, gen, b, h, h, l, l, d, torch.float32)
    kw = dict(n_heads=h, n_kv_heads=h, causal=True)
    o, lse = kernels.flash_fwd(q, k, v, **kw)
    delta = (do * o).sum(-1)
    pairs = b * h * l * (l + 1) // 2
    elem, row = b * h * l * d * 4, b * h * l * 4
    runs = {
        'flash_fwd': (lambda: kernels.flash_fwd(q, k, v, **kw),
                      lambda: kernels.flash_fwd_plain(q, k, v, **kw),
                      4 * d * pairs, 4 * elem + row),
        'flash_bwd_dq': (
            lambda: kernels.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
            lambda: kernels.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
            6 * d * pairs, 5 * elem + 2 * row),
        'flash_bwd_dkdv': (
            lambda: kernels.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw),
            lambda: kernels.flash_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                 **kw),
            8 * d * pairs, 6 * elem + 2 * row)}
    for name, (kern, plain, flops, nbytes) in runs.items():
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        bound = max(t_ops, t_bytes) * 1e3
        ms, plain_ms = loop_ms(torch, kern, 200), loop_ms(torch, plain, 50)
        log('time D=16 f32 %-14s %.4f ms at %s causal, %.1f%% of its bound '
            '(bound %.5f ms by %s, plain %.4f ms)'
            % (name, ms, SMALL_HEAD_SHAPE, 100 * bound / ms, bound,
               'operations' if t_ops >= t_bytes else 'bytes', plain_ms))


def loop_ms(torch, fn, n):
    """Device time of one ``fn()`` from ``n`` calls between two events. A
    sleep kernel queued first keeps the card busy while the host enqueues
    the calls, so the events time the launches back to back and not the
    host's launch rate; median of 5 such loops."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)          # ~25 ms at 2 GHz
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / n)
    return statistics.median(samples)


def k4_times(torch, kernels, seed, shape=K4_SHAPE):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randint(0, 256, shape, generator=gen, device='cuda',
                      dtype=torch.uint8)
    zero, one = torch.zeros(shape[-1]), torch.ones(shape[-1])
    bf16 = torch.bfloat16
    nbytes = x.numel() * (1 + 2)        # read uint8 once, write bf16 once
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 3 * x.numel() / PEAK_F32_FLOPS
    return {
        'ms': loop_ms(torch, lambda: kernels.normalize(x, zero, one, bf16),
                      K4_LOOP),
        'plain_ms': loop_ms(
            torch, lambda: kernels.normalize_plain(x, zero, one, bf16), 20),
        'yardstick_ms': loop_ms(torch, lambda: x.to(bf16), K4_LOOP),
        'bound': (max(t_bytes, t_ops) * 1e3,
                  'bytes' if t_bytes >= t_ops else 'operations'),
    }


# ---------------------------------------------------------------------------
# phase 21: the remote line (read planes, per-range hedging, the pod tier)
# ---------------------------------------------------------------------------

REMOTE_WORKERS = 4
REMOTE_STEPS = 16                 # (a): LM steps from the ranged process pool
REMOTE_HEDGE_S = 0.05             # (c)'s fixed hedge threshold
POD_HOSTS = 3
POD_THREADS = 2                   # reader threads of each host
POD_STEPS = 4                     # CNN steps from host 3's batches
DEAD_PEER = '127.0.0.1:9'         # nothing listens there


def remote_specs(seed):
    """The phase's scenarios, each from a seed derived from ``--seed``."""
    return {'trace': 'trace-replay:%d:trace=s3-us-east-1' % (606 + seed),
            'hangs': 'read-hangs:%d:hang_rate=0.1,hang_s=0.3' % (707 + seed)}


def remote_pass(torch, np, url, tokens, device, spec, label, pool='thread',
                workers=REMOTE_WORKERS, **reader_kw):
    """One token pass under ``spec`` (:func:`token_pass`, 4 workers,
    device decode on); returns its facts with the injector's tallies and
    the wall time."""
    with chaos(spec) as injector:
        start = time.perf_counter()
        got = token_pass(torch, np, url, tokens, pool, 'on', device,
                         TOKEN_BATCH, label=label, workers=workers,
                         **reader_kw)
        got['wall'] = time.perf_counter() - start
        got['injected'] = dict(injector.injected) if injector else {}
        got['injected_s'] = dict(injector.injected_s) if injector else {}
    snap = got['diagnostics']
    ranged = reader_kw.get('remote_read') == 'ranged'
    check(bool(snap.get('io_range_requests')) == ranged,
          '%s: io_range_requests %s under %s' % (
              label, snap.get('io_range_requests'),
              reader_kw.get('remote_read')))
    store = got['store']
    log('%s: %.0f rows/s, store reads %s, bytes %s; replayed %d reads, '
        '%.3f s; io_range_requests %d, io_range_bytes %d, '
        'io_range_wasted_bytes %d, io_range_fallbacks %d, io_range p99 '
        '%.4f s; wall %.3f s [%s]'
        % (label, got['rate'], store[0] if store else 'n/a (processes)',
           store[1] if store else 'n/a', got['injected'].get('trace_reads', 0),
           got['injected_s'].get('trace_latency_s', 0.0),
           snap.get('io_range_requests', 0), snap.get('io_range_bytes', 0),
           snap.get('io_range_wasted_bytes', 0),
           snap.get('io_range_fallbacks', 0), snap.get('io_range_p99_s', 0),
           got['wall'], CARD))
    return got


def remote_lm(torch, np, tlm, kernels, url, cfg, device, args, spec, steps):
    """``steps`` AdamW steps of the LM on K1-K3 from a ranged reader on
    ``REMOTE_WORKERS`` worker processes under ``spec`` (tokens decoded on
    the card and cast to int64 by a device ``TransformSpec``). Returns the
    launch counts and the steady step in ms."""
    from petastorm_tpu_torch import (TorchDataLoader, TransformSpec,
                                     make_columnar_reader)
    seq = cfg.max_seq_len + 1
    spec_cast = TransformSpec(
        lambda c: dict(c, tokens=c['tokens'].to(torch.int64)),
        edit_fields=[('tokens', np.int64, (seq,), False)], device=True)
    params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                      device=device)
    _, step = tlm.make_train_step(cfg, params)
    losses, times = [], []
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with chaos(spec):
        with make_columnar_reader(url, num_epochs=None,
                                  workers_count=REMOTE_WORKERS,
                                  reader_pool_type='process',
                                  remote_read='ranged',
                                  transform_spec=spec_cast,
                                  seed=args.seed) as reader:
            loader = TorchDataLoader(reader, batch_size=TOKEN_BATCH,
                                     drop_last=True, device=device)
            batches = loader.iter_prefetched()
            with contextlib.closing(batches):
                for _ in range(steps):
                    t0 = time.perf_counter()
                    b = next(batches)['tokens']
                    check(b.device.type == device and b.dtype == torch.int64
                          and tuple(b.shape) == (TOKEN_BATCH, seq),
                          'remote LM batch %s %s on %s'
                          % (b.dtype, tuple(b.shape), b.device))
                    losses.append(float(loader.goodput.fence(
                        step(b[:, :-1], b[:, 1:]))))
                    times.append(time.perf_counter() - t0)
            snap = reader.stats.snapshot()
    launches = dict(kernels.LAUNCHES)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          'remote LM: losses %s' % losses)
    if device == 'cuda':
        check(all(launches[k] == steps * cfg.n_layers for k in FLASH),
              'remote LM launches %r for %d steps of %d layers'
              % (launches, steps, cfg.n_layers))
    steady = statistics.median(times[1:]) * 1e3
    log('remote LM: %d AdamW steps (full width, bf16, flash) from a ranged '
        'reader on %d worker processes under the trace: loss %.4f -> %.4f, '
        'steady step %.2f ms (batch wait included), io_range_requests %d '
        'merged by the last step, launches %s [%s]'
        % (steps, REMOTE_WORKERS, losses[0], losses[-1], steady,
           snap.get('io_range_requests', 0), json.dumps(launches), CARD))
    return launches, steady


def pod_line(torch, np, kernels, args, d, device, rows, batch, size):
    """(d) The pod tier over ``POD_HOSTS`` shared-cache roots. Returns the
    launch counts of the CNN steps."""
    import threading as _threading
    from petastorm_tpu_torch import (TorchDataLoader, TransformSpec,
                                     make_columnar_reader, prefetch_to_device)
    from petastorm_tpu_torch.examples.imagenet.main import \
        make_resize_transform
    from petastorm_tpu_torch.models import image_cnn as cnn
    from petastorm_tpu_torch.sharedcache import SharedRowGroupCache
    path = os.path.join(d, 'pod_images')
    url = 'file://' + path
    write_indexed_images(np, url, rows, args.seed)
    groups = row_groups(path)
    resize = make_resize_transform(size)
    spec = TransformSpec(resize.func, edit_fields=resize.edit_fields,
                         selected_fields=['idx', 'image', 'label'])
    roots = SharedRoots(d)
    hosts, servers, thread = [], [], None
    try:
        for i in range(POD_HOSTS):
            root, kw = roots.kw('pod_host%d' % i, IMAGE_TIER0)
            server = SharedRowGroupCache(root, CACHE_LIMIT,
                                         **kw['cache_extra_settings'])
            servers.append(server)
            hosts.append((root, kw, '127.0.0.1:%d' % server.serve_peers()))

        def reader_kw(i, peers=None):
            root, kw, _ = hosts[i]
            extra = dict(kw['cache_extra_settings'], peers=peers or [
                h[2] for j, h in enumerate(hosts) if j != i])
            return dict(kw, cache_extra_settings=extra)

        def read_host(i, out, workers=POD_THREADS, **kw):
            with make_columnar_reader(url, num_epochs=1, workers_count=workers,
                                      seed=args.seed + i, transform_spec=spec,
                                      **(kw or reader_kw(i))) as reader:
                for b in reader:
                    for k, x in zip(b.idx, b.image):
                        out[int(k)] = np.ascontiguousarray(x).tobytes()

        start = time.perf_counter()
        cold = {}
        read_host(0, cold)
        cold_s = time.perf_counter() - start
        check(sorted(cold) == list(range(rows)),
              'pod cold host: %d images' % len(cold))
        # hosts 2 and 3 at once: host 2 on a thread, host 3 into the CNN
        second, errors = {}, []

        def host2():
            try:
                read_host(1, second)
            except BaseException as e:   # re-raised on the main thread
                errors.append(e)
        params = cnn.init(torch.Generator().manual_seed(args.seed),
                          num_classes=IMAGE_CLASSES, device=device)
        step = cnn.make_train_step(params, lr=1e-3)
        if device == 'cuda':
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        thread = _threading.Thread(target=host2, name='pod-host2')
        thread.start()
        third, losses = {}, []
        with make_columnar_reader(url, num_epochs=1, workers_count=POD_THREADS,
                                  seed=args.seed + 2, transform_spec=spec,
                                  **reader_kw(2)) as reader:
            loader = TorchDataLoader(reader, batch_size=batch, device=device)
            batches = prefetch_to_device(iter(loader), size=2, device=device)
            with contextlib.closing(batches):
                for b in batches:
                    if len(losses) < POD_STEPS:
                        losses.append(float(step(b['image'], b['label'])))
                    images = b['image'].cpu().numpy()
                    for k, x in zip(b['idx'].cpu().numpy(), images):
                        third[int(k)] = x.tobytes()
        thread.join(120)
        warm_s = time.perf_counter() - start
        check(not thread.is_alive() and not errors,
              'pod host 2: %s' % (errors or 'did not finish'))
        launches = dict(kernels.LAUNCHES)
        check(len(losses) == POD_STEPS and all(math.isfinite(x)
                                               for x in losses),
              'pod CNN: losses %s' % losses)
        if device == 'cuda':
            check(launches['normalize'] == POD_STEPS,
                  'pod CNN: K4 launched %d times in %d steps'
                  % (launches['normalize'], POD_STEPS))
        check(third == cold and second == cold,
              "pod hosts 2 and 3: images differ from the cold host's")
        totals = {}
        for root, _, _ in hosts:
            for k, n in SharedRowGroupCache.global_counters(root).items():
                totals[k] = totals.get(k, 0) + n
        check(totals.get('fills') == groups
              and totals.get('peer_hits') == 2 * groups,
              'pod certificate: fills %s, peer_hits %s over %d row groups'
              % (totals.get('fills'), totals.get('peer_hits'), groups))
        log('pod tier: %d hosts x %d threads over %d png row groups: cold '
            'host %.2f s, hosts 2 and 3 at once %.2f s; fills %d (== row '
            'groups), peer_hits %d (== 2 x row groups), peer_misses %d, '
            'peer_errors %d, peer_bytes %d; %d CNN steps on K4 from host '
            "3's batches, loss %.4f -> %.4f, images == the cold host's byte "
            'for byte [%s]'
            % (POD_HOSTS, POD_THREADS, groups, cold_s, warm_s,
               totals['fills'], totals['peer_hits'],
               totals.get('peer_misses', 0), totals.get('peer_errors', 0),
               totals.get('peer_bytes', 0), POD_STEPS, losses[0], losses[-1],
               CARD))
        # a reader whose first peer is dead: one error, then skipped
        root, kw = roots.kw('pod_dead_peer', IMAGE_TIER0)
        extra = dict(kw['cache_extra_settings'],
                     peers=[DEAD_PEER, hosts[0][2]], peer_timeout_s=1.0)
        dead = {}
        start = time.perf_counter()
        read_host(3, dead, workers=1,
                  **dict(kw, cache_extra_settings=extra))
        c = SharedRowGroupCache.global_counters(root)
        check(dead == cold and c.get('peer_errors') == 1
              and c.get('peer_skipped_dead', 0) >= 1
              and c.get('peer_hits') == groups and not c.get('fills'),
              'pod dead peer: %d images, counters %s' % (len(dead), c))
        log('pod dead first peer %s: %d images == the cold host\'s in %.2f '
            's, peer_errors %d, peer_skipped_dead %d, peer_hits %d, fills %d'
            % (DEAD_PEER, len(dead), time.perf_counter() - start,
               c['peer_errors'], c['peer_skipped_dead'], c['peer_hits'],
               c.get('fills', 0)))
    finally:
        if thread is not None:
            thread.join(120)
        for server in servers:
            server.close()
        roots.remove()
    return launches


def remote_failures(np, url, d, device):
    """(e) The ranged ceiling of the profiler, and the loud failures."""
    from petastorm_tpu_torch import make_columnar_reader
    from petastorm_tpu_torch.profiler import CALIBRATION_DIR_ENV_VAR
    saved = os.environ.get(CALIBRATION_DIR_ENV_VAR)
    os.environ[CALIBRATION_DIR_ENV_VAR] = os.path.join(d, 'calibration')
    try:
        with make_columnar_reader(url, num_epochs=1, remote_read='ranged',
                                  workers_count=REMOTE_WORKERS) as reader:
            rows = sum(len(b.idx) for b in reader)
            reader.profile(calibrate='force', device=device)
            storage = reader.calibration['probes']['storage']
    finally:
        if saved is None:
            os.environ.pop(CALIBRATION_DIR_ENV_VAR, None)
        else:
            os.environ[CALIBRATION_DIR_ENV_VAR] = saved
    ranged = storage['parquet_ranged_rows_per_s']
    check(isinstance(ranged, (int, float)) and ranged > 0,
          'profile: parquet_ranged_rows_per_s %r' % ranged)
    log('remote profile (%d rows read ranged, clean store): storage ceilings '
        'plain %.0f, pre_buffer %.0f, ranged %.0f rows/s [%s]'
        % (rows, storage['parquet_rows_per_s'],
           storage['parquet_pre_buffer_rows_per_s'], ranged, CARD))
    loud = [('remote_read typo', dict(remote_read='rangedd'),
             "remote_read must be one of ['ranged', 'prebuffer', 'serial']"),
            ('file://tmp/x', dict(dataset_url='file://tmp/x'),
             'file:// URLs must use three slashes'),
            ('ftp://', dict(dataset_url='ftp://host/x'),
             "Unsupported url scheme 'ftp'")]
    for label, kw, words in loud:
        try:
            make_columnar_reader(kw.pop('dataset_url', url), **kw)
        except ValueError as e:
            check(words in str(e), '%s: %s' % (label, e))
            log('remote loud failure %s: ValueError: %s' % (label, e))
        else:
            check(False, '%s: no ValueError' % label)


def remote_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
                rows=TOKEN_ROWS, image_rows=IMAGE_ROWS,
                image_batch=IMAGE_BATCH, image_size=IMAGE_SIZE,
                steps=REMOTE_STEPS):
    """Phase 21: the read planes under the recorded S3 trace, per-range
    hedging and the pod tier. Returns the launch counts of the LM steps
    (K1-K3) and of the pod's CNN steps (K4)."""
    from petastorm_tpu_torch.ops.decode import DEVICE_DECODE_ENV_VAR
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    specs = remote_specs(args.seed)
    log('remote scenarios (seeded from --seed %d): %s'
        % (args.seed, json.dumps(specs)))
    saved = os.environ.get(DEVICE_DECODE_ENV_VAR)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix='.smoke-store-') as d:
            url = 'file://' + os.path.join(d, 'token_rows')
            tokens = write_token_rows(np, url, rows, cfg.max_seq_len + 1,
                                      cfg.vocab_size, args.seed)
            # a process's first pass imports pandas (through pyarrow's
            # to_numpy): pay that outside the planes that are compared
            log('remote warm-up pass (clean, not compared):')
            token_pass(torch, np, url, tokens, 'thread', 'on', device,
                       TOKEN_BATCH, workers=REMOTE_WORKERS)
            phase = time.perf_counter()
            passes = {}
            for mode, readahead in (('serial', 0), ('prebuffer', 0),
                                    ('ranged', 0), ('ranged', 2)):
                passes[mode, readahead] = remote_pass(
                    torch, np, url, tokens, device, specs['trace'],
                    'remote %s readahead %d' % (mode, readahead),
                    remote_read=mode, io_readahead=readahead)
            log('remote ranged / serial rows/s %.3f, ranged / prebuffer '
                '%.3f, ranged readahead 2 / 0 %.3f'
                % (passes['ranged', 0]['rate'] / passes['serial', 0]['rate'],
                   passes['ranged', 0]['rate']
                   / passes['prebuffer', 0]['rate'],
                   passes['ranged', 2]['rate'] / passes['ranged', 0]['rate']))
            remote_pass(torch, np, url, tokens, device, specs['trace'],
                        'remote ranged on %d processes' % REMOTE_WORKERS,
                        pool='process', remote_read='ranged')
            lm, steady = remote_lm(torch, np, tlm, kernels, url, cfg, device,
                                   args, specs['trace'], steps)
            log('remote (a) planes and LM %.1f s'
                % (time.perf_counter() - phase))
            phase = time.perf_counter()
            again = remote_pass(torch, np, url, tokens, device,
                                specs['trace'], 'remote ranged again (same '
                                'seed)', remote_read='ranged')
            first = passes['ranged', 0]
            tally = [(p['injected'].get('trace_reads'),
                      round(p['injected_s'].get('trace_latency_s', 0), 6),
                      p['diagnostics']['io_range_requests'])
                     for p in (first, again)]
            check(tally[0] == tally[1],
                  'remote determinism: (replayed reads, seconds, '
                  'io_range_requests) %s then %s' % tuple(tally))
            log('remote (b) determinism: two same-seed ranged passes replay '
                '%d reads, %.6f s, io_range_requests %d, identical (%.1f s)'
                % (tally[0] + (time.perf_counter() - phase,)))
            phase = time.perf_counter()
            hedged = {}
            for hedge in (REMOTE_HEDGE_S, False):
                hedged[hedge] = remote_pass(
                    torch, np, url, tokens, device, specs['hangs'],
                    'remote ranged on 1 thread, hedge=%s' % hedge,
                    workers=1, remote_read='ranged', hedge=hedge)
            snap = hedged[REMOTE_HEDGE_S]['diagnostics']
            check(snap['io_hedges'] >= 1,
                  'remote hedge: io_hedges %d' % snap['io_hedges'])
            log('remote (c) per-range hedging under %s on 1 thread: rows == '
                'generator both ways; hedged: io_hedges %d, io_hedge_wins '
                '%d, wall %.3f s; unhedged: wall %.3f s (%.1f s) [%s]'
                % (specs['hangs'], snap['io_hedges'],
                   snap.get('io_hedge_wins', 0),
                   hedged[REMOTE_HEDGE_S]['wall'], hedged[False]['wall'],
                   time.perf_counter() - phase, CARD))
            phase = time.perf_counter()
            png = pod_line(torch, np, kernels, args, d, device, image_rows,
                           image_batch, image_size)
            log('remote (d) pod tier %.1f s' % (time.perf_counter() - phase))
            phase = time.perf_counter()
            remote_failures(np, url, d, device)
            log('remote (e) profile and loud failures %.1f s'
                % (time.perf_counter() - phase))
    finally:
        if saved is None:
            os.environ.pop(DEVICE_DECODE_ENV_VAR, None)
        else:
            os.environ[DEVICE_DECODE_ENV_VAR] = saved
    log('remote launches: LM %s (%d steps, steady %.2f ms); png %s'
        % (json.dumps(lm), steps, steady, json.dumps(png)))
    return lm, png


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 22: the resume line (cursor, mixture, replay)
# ---------------------------------------------------------------------------

RESUME_WORKERS = 4                # run A's loader; the restored one has 1
RESUME_EPOCHS = 2
RESUME_PAST_EPOCH = 5             # (a) run A: one epoch, then 5 steps
RESUME_STOP = 20                  # (a) run B's steps before its checkpoint
MIX_P = (0.75, 0.25)
MIX_STEPS = 24                    # (b) run A
MIX_STOP = 10                     # (b) run B's steps before its restore
REPLAY_STEPS = 12                 # (c) run A
REPLAY_STOP = 5
RESUME_LOSS_RTOL = 1e-3


def resume_ngram():
    from petastorm_tpu_torch.ngram import NGram
    return NGram(fields={0: ['step', 'tokens'], 1: ['tokens']},
                 delta_threshold=1, timestamp_field='step')


def resumed_lm(torch, tlm, cfg, device, seed, d, label, make, total, stop,
               on_batch=None):
    """Run A: ``total`` AdamW steps of the LM from ``make(None)``. Run B:
    ``stop`` steps, a checkpoint of ``{params, optimizer, data state}``
    through ``torch.save`` (the data state through JSON), everything
    dropped and rebuilt from it (the data source by ``make(state)``), then
    the other ``total - stop`` steps. ``make(state)`` returns ``(source,
    batches)``: ``source.state_dict()`` is the data state and ``batches``
    the host batch iterator; every batch goes through
    :func:`prefetch_to_device`. ``on_batch(k, batch)`` sees each staged
    batch of step ``k``. Returns a dict of what both runs measured."""
    import itertools

    from petastorm_tpu_torch import prefetch_to_device

    def steps(step, batches, n, first, tokens, losses, times):
        staged = prefetch_to_device(itertools.islice(batches, n), size=2,
                                    device=device)
        with contextlib.closing(staged):
            for k in range(first, first + n):
                t0 = time.perf_counter()
                batch = next(staged)
                if k == first:
                    first_at = time.perf_counter()
                inputs = batch[0]['tokens']
                targets = torch.cat([inputs[:, 1:],
                                     batch[1]['tokens'][:, :1]], 1)
                if on_batch is not None:
                    on_batch(k, batch)
                tokens.append(inputs)
                losses.append(float(step(inputs, targets)))
                times.append(time.perf_counter() - t0)
        return first_at

    def fresh():
        params = tlm.init(cfg, torch.Generator().manual_seed(seed),
                          device=device)
        return (params,) + tlm.make_train_step(cfg, params)

    out = {}
    # run A: uninterrupted
    params, _, step = fresh()
    source, batches = make(None)
    tokens_a, losses_a, times_a = [], [], []
    steps(step, batches, total, 0, tokens_a, losses_a, times_a)
    batches.close()
    del params, step, source, batches
    # run B: stop, checkpoint, drop, rebuild, restore, go on
    params, optimizer, step = fresh()
    source, batches = make(None)
    tokens_b, losses_b, times_b = [], [], []
    steps(step, batches, stop, 0, tokens_b, losses_b, times_b)
    state = source.state_dict()
    batches.close()
    path = os.path.join(d, 'ckpt-%s.pt' % label.split()[0])
    torch.save({'params': params, 'optimizer': optimizer.state_dict(),
                'data': json.dumps(state)}, path)
    del params, optimizer, step, source, batches
    t0 = time.perf_counter()
    ckpt = torch.load(path, map_location=device)
    params = ckpt['params']
    optimizer, step = tlm.make_train_step(cfg, params)
    optimizer.load_state_dict(ckpt['optimizer'])
    t1 = time.perf_counter()
    source, batches = make(json.loads(ckpt['data']))
    first_at = steps(step, batches, total - stop, stop, tokens_b, losses_b,
                     times_b)
    out['restore_s'] = first_at - t0
    out['data_restore_s'] = first_at - t1
    batches.close()
    out['state'] = state
    out['tokens_equal'] = (len(tokens_a) == len(tokens_b) == total and all(
        torch.equal(a, b) for a, b in zip(tokens_a, tokens_b)))
    out['losses_bit_equal'] = losses_a == losses_b
    out['loss_rel_err'] = max(abs(a - b) / max(abs(a), 1e-12)
                              for a, b in zip(losses_a, losses_b))
    out['losses'] = (losses_a[0], losses_a[-1])
    out['steady_ms'] = statistics.median(times_a[1:] + times_b[1:stop]
                                         + times_b[stop + 1:]) * 1e3
    check(all(math.isfinite(x) for x in losses_a + losses_b),
          '%s: non-finite loss' % label)
    check(out['tokens_equal'], '%s: the resumed run\'s token batches differ '
          'from the uninterrupted run\'s' % label)
    check(out['loss_rel_err'] <= RESUME_LOSS_RTOL,
          '%s: losses differ by %.3g relative (limit %g)'
          % (label, out['loss_rel_err'], RESUME_LOSS_RTOL))
    # the step is a function of its inputs on the card (no atomics on the
    # path), so a restore that lost the optimizer's moments or step count
    # shows here even where it stays within the relative limit
    check(device != 'cuda' or out['losses_bit_equal'],
          '%s: losses within %g relative but not bit-equal'
          % (label, RESUME_LOSS_RTOL))
    return out


def log_resumed(label, total, stop, out, extra=''):
    log('%s: run A %d steps; run B %d + %d steps around a restore; steady '
        'step %.2f ms; restore %.3f s to its first staged batch (data '
        'source alone %.3f s); token batches bit-equal %s; losses bit-equal '
        '%s (max relative difference %.3g, limit %g), loss %.4f -> %.4f%s '
        '[%s]' % (label, total, stop, total - stop, out['steady_ms'],
                  out['restore_s'], out['data_restore_s'],
                  out['tokens_equal'], out['losses_bit_equal'],
                  out['loss_rel_err'], RESUME_LOSS_RTOL, out['losses'][0],
                  out['losses'][1], extra, CARD))


def resume_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
                rows=ROWS, batch=BATCH):
    """Phase 22: the flagship LM stopped mid-epoch and resumed: (a) from the
    indexed NGram loader's cursor across an epoch boundary, (b) from a
    weighted mixture of two indexed NGram loaders, (c) from the replay
    checkpoint over ``make_reader`` + ``TorchDataLoader``. Returns the
    phase's launch counts (K1-K3)."""
    from petastorm_tpu_torch import (TorchDataLoader, WeightedIndexedMixture,
                                     make_indexed_ngram_loader, make_reader)
    from petastorm_tpu_torch.checkpoint import CheckpointableLoader
    from petastorm_tpu_torch.weighted_sampling_reader import (
        draw_index, normalize_cumulative)
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    seq = cfg.max_seq_len
    ngram = resume_ngram()
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    total_steps = 0
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        urls, stores = [], []
        for k in range(2):
            urls.append('file://' + os.path.join(d, 'tokens%d' % k))
            stores.append(write_store(np, urls[-1], seq, cfg.vocab_size,
                                      rows, args.seed + k))

        # (a) the cursor, across an epoch boundary
        assembled = []

        def make_cursor(state):
            loader = make_indexed_ngram_loader(
                urls[0], ngram, batch_size=batch, num_epochs=RESUME_EPOCHS,
                seed=args.seed,
                workers_count=RESUME_WORKERS if state is None else 1)
            if state is not None:
                loader.load_state_dict(state)
                assemble = loader._assemble

                def counted(epoch, b):
                    assembled.append((epoch, b))
                    return assemble(epoch, b)
                loader._assemble = counted
            return loader, iter(loader)

        probe = make_cursor(None)[0]
        per_epoch = probe.batches_per_epoch
        probe.close()
        total = per_epoch + RESUME_PAST_EPOCH
        out = resumed_lm(torch, tlm, cfg, device, args.seed, d,
                         '(a) cursor', make_cursor, total, RESUME_STOP)
        cursor = (out['state']['epoch'], out['state']['batch'])
        check(cursor == (0, RESUME_STOP),
              '(a) the checkpoint cursor is %r' % (cursor,))
        check(assembled and min(assembled) >= cursor,
              '(a) the restored loader assembled %r, before its cursor %r'
              % (sorted(assembled)[:3], cursor))
        check(len(assembled) >= total - RESUME_STOP,
              '(a) the restored loader assembled %d batches for %d steps'
              % (len(assembled), total - RESUME_STOP))
        total_steps += 2 * total
        log_resumed('resume (a) cursor, %d batches an epoch, %d epochs'
                    % (per_epoch, RESUME_EPOCHS), total, RESUME_STOP, out,
                    '; the restored loader (1 worker) assembled %d batches '
                    '(its steps and its lookahead), none before its cursor %r'
                    % (len(assembled), cursor))

        # (b) a weighted mixture, resumed mid-stream
        cumulative = normalize_cumulative(MIX_P)
        sources = []

        def make_mixture(state):
            loaders = [make_indexed_ngram_loader(
                u, ngram, batch_size=batch, num_epochs=RESUME_EPOCHS,
                seed=args.seed, workers_count=RESUME_WORKERS) for u in urls]
            mixture = WeightedIndexedMixture(loaders, MIX_P, seed=args.seed)
            if state is not None:
                mixture.load_state_dict(state)
            return mixture, iter(mixture)

        def source_of(k, staged):
            steps_ = staged[0]['step'].cpu().numpy()
            toks = staged[0]['tokens'].cpu().numpy()
            told = [i for i in range(2)
                    if np.array_equal(toks, stores[i][steps_])]
            want = draw_index(cumulative,
                              np.random.default_rng((args.seed, k)).random())
            check(told == [want], '(b) step %d came from store %r, drawn %d'
                  % (k, told, want))
            sources.append(want)

        out = resumed_lm(torch, tlm, cfg, device, args.seed, d, '(b) mixture',
                         make_mixture, MIX_STEPS, MIX_STOP,
                         on_batch=source_of)
        check(out['state']['step'] == MIX_STOP,
              '(b) the mixture checkpointed at step %r' % out['state']['step'])
        total_steps += 2 * MIX_STEPS
        log_resumed('resume (b) mixture p=%s over 2 stores' % (MIX_P,),
                    MIX_STEPS, MIX_STOP, out,
                    '; sources of run A %s, each as drawn from (seed, step)'
                    % ''.join(str(s) for s in sources[:MIX_STEPS]))

        # (c) the replay checkpoint over a streaming reader
        def make_replay(state):
            def factory():
                reader = make_reader(urls[0], schema_fields=ngram,
                                     reader_pool_type='dummy',
                                     seed=args.seed)
                return TorchDataLoader(reader, batch_size=batch,
                                       drop_last=True, device=device)
            ckpt = CheckpointableLoader(factory)
            if state is not None:
                ckpt.load_state_dict(state)
            return ckpt, ckpt.epochs(1)

        out = resumed_lm(torch, tlm, cfg, device, args.seed, d, '(c) replay',
                         make_replay, REPLAY_STEPS, REPLAY_STOP)
        check(out['state'] == {'epoch': 0, 'step': REPLAY_STOP,
                               'version': 1},
              '(c) the replay state is %r' % out['state'])
        total_steps += 2 * REPLAY_STEPS
        log_resumed('resume (c) replay over make_reader (dummy pool) + '
                    'TorchDataLoader', REPLAY_STEPS, REPLAY_STOP, out,
                    '; the restore re-read %d batches' % REPLAY_STOP)
    launches = dict(kernels.LAUNCHES)
    if device == 'cuda':
        check(all(launches[k] == total_steps * cfg.n_layers for k in FLASH),
              'resume line launches %r for %d steps of %d layers'
              % (launches, total_steps, cfg.n_layers))
    log('resume line: %d LM steps (d_model %d, %d layers, %s, %s), '
        'launches %s' % (total_steps, cfg.d_model, cfg.n_layers,
                         str(cfg.dtype).replace('torch.', ''),
                         cfg.attention, json.dumps(launches)))
    return launches


# ---------------------------------------------------------------------------
# phase 23: the pod line (elastic membership, pod observability)
# ---------------------------------------------------------------------------

ELASTIC_ROWS = 1024               # token rows of 2,049 int32: about 8.4 MB
ELASTIC_GROUP_MB = 1              # in row groups of about 1 MB
ELASTIC_BATCH = 8
ELASTIC_HOSTS = 3                 # the clean and death runs
ELASTIC_JOIN_FROM = 2             # the join run starts from this many


def elastic_specs(seed, hosts=ELASTIC_HOSTS):
    """The phase's two membership scenarios from ``--seed``. ``host-death``
    names its victim: a seed-drawn victim index can lie past a 3-host pod
    (JAX draws it in [0, 4)), and then no host dies."""
    return {'death': 'host-death:%d:die_host=%d' % (606 + seed, seed % hosts),
            'join': 'host-join:%d' % (707 + seed)}


def arrow_token_rows(np, path):
    """The token store read with pyarrow alone (``np.load`` of each cell),
    rows in file order, which is the indexed reader's global row order of a
    one-file store; checks ``idx`` is that order."""
    import io
    import pyarrow.parquet as pq
    files = sorted(n for n in os.listdir(path)
                   if n.endswith('.parquet') and not n.startswith(('_', '.')))
    check(len(files) == 1, 'elastic store: %d parquet files' % len(files))
    table = pq.read_table(os.path.join(path, files[0]),
                          columns=['idx', 'tokens']).to_pydict()
    check(table['idx'] == list(range(len(table['idx']))),
          'elastic store: idx is not the row order')
    return np.stack([np.load(io.BytesIO(c)) for c in table['tokens']])


def elastic_run(np, url, coord, spec, hosts, batch, seed, consume=None):
    """One epoch of an ``ElasticPodSim`` of ``hosts`` simulated hosts over
    the token store under ``PETASTORM_TPU_CHAOS=spec`` (None: clean). Each
    delivered batch's ``tokens`` goes to ``consume(tokens, lease, batch)``,
    or is kept (None). Returns ``(sim report, facts)``: the kept batches,
    the injector's tallies, the epoch's wall time, the seconds from an
    injected death to the first batch delivered on a lease the dead host
    held, and each delivering ``ElasticHost.step``'s time beside its
    ``gather`` and its consumer."""
    from petastorm_tpu_torch.indexed import IndexedDatasetReader
    from petastorm_tpu_torch.podelastic import (ElasticPodSim,
                                                SimulatedHostDeath)
    facts = {'batches': {}, 'step_s': [], 'gather_s': [], 'consume_s': [],
             'death_at': None, 'moved': (), 'first_moved_s': None}
    dataset = IndexedDatasetReader(url)
    gather = dataset.gather

    def timed_gather(rows, fields=None):
        t0 = time.perf_counter()
        out = gather(rows, fields)
        facts['gather_s'].append(time.perf_counter() - t0)
        return out
    dataset.gather = timed_gather

    def on_batch(columns, lease, b):
        t0 = time.perf_counter()
        if (facts['death_at'] is not None and facts['first_moved_s'] is None
                and lease in facts['moved']):
            facts['first_moved_s'] = t0 - facts['death_at']
        if consume is None:
            facts['batches'][(lease, b)] = np.array(columns['tokens'])
        else:
            consume(columns['tokens'], lease, b)
        facts['consume_s'].append(time.perf_counter() - t0)

    def timed(host):
        step = host.step

        def timed_step(epoch, on_batch=None):
            held = host._held
            t0 = time.perf_counter()
            try:
                out = step(epoch, on_batch=on_batch)
            except SimulatedHostDeath:
                facts['death_at'] = time.perf_counter()
                facts['moved'] = held
                raise
            if out is not None:
                facts['step_s'].append(time.perf_counter() - t0)
            return out
        host.step = timed_step
        return host

    try:
        with chaos(spec) as injector:
            sim = ElasticPodSim(dataset, coord, k_hosts=hosts,
                                batch_size=batch, seed=seed)
            for host in sim.hosts:
                timed(host)
            spawn = sim._spawn_host
            sim._spawn_host = lambda index: timed(spawn(index))
            start = time.perf_counter()
            report = sim.run_epoch(0, on_batch=on_batch)
            facts['epoch_s'] = time.perf_counter() - start
            facts['certificate'] = sim.certificate(0)
            facts['tallies'] = dict(injector.injected) if injector else {}
            facts['plan'] = sim.plan
            sim.close()
    finally:
        dataset.close()
    # the lease plane's own time: the steps less their gathers and their
    # consumers
    facts['plane_s'] = ((sum(facts['step_s']) - sum(facts['gather_s'])
                         - sum(facts['consume_s']))
                        / max(1, len(facts['step_s'])))
    return report, facts


def elastic_readers(np, url, d, rows):
    """``make_reader(..., elastic=)``: two registered hosts read shards 0
    and 1 of 2, disjoint, their union the store; under
    ``PETASTORM_TPU_ELASTIC=0`` a reader makes no member file and reads the
    whole store; ``elastic=`` beside ``cur_shard`` raises with JAX's
    words."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.podelastic import (ELASTIC_ENV_VAR,
                                                ElasticConfigError,
                                                PodMembership)
    coord = os.path.join(d, 'coord-readers')
    for host in ('a', 'b'):
        PodMembership(coord, host_id=host)
    shards = {}
    for host in ('a', 'b'):
        with make_reader(url, schema_fields=['idx'], workers_count=2,
                         elastic={'coord_root': coord,
                                  'host_id': host}) as reader:
            shards[host] = sorted(int(r.idx) for r in reader)
    check(shards['a'] and shards['b']
          and not set(shards['a']) & set(shards['b'])
          and sorted(shards['a'] + shards['b']) == list(range(rows)),
          'elastic readers: shards of %d and %d rows, union %d of %d'
          % (len(shards['a']), len(shards['b']),
             len(set(shards['a']) | set(shards['b'])), rows))
    off = os.path.join(d, 'coord-off')
    os.environ[ELASTIC_ENV_VAR] = '0'
    try:
        with make_reader(url, schema_fields=['idx'], workers_count=2,
                         elastic={'coord_root': off}) as reader:
            whole = sorted(int(r.idx) for r in reader)
    finally:
        os.environ.pop(ELASTIC_ENV_VAR, None)
    check(not os.path.exists(off) and whole == list(range(rows)),
          'PETASTORM_TPU_ELASTIC=0: %s, %d rows'
          % (os.listdir(off) if os.path.exists(off) else 'no directory',
             len(whole)))
    try:
        make_reader(url, elastic={'coord_root': coord}, cur_shard=0,
                    shard_count=2)
        raised = None
    except ElasticConfigError as e:
        raised = str(e)
    check(raised is not None and 'mutually exclusive with explicit '
          'cur_shard/shard_count' in raised,
          'elastic= beside cur_shard: %r' % raised)
    return {h: len(v) for h, v in shards.items()}


def elastic_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
                 rows=ELASTIC_ROWS, batch=ELASTIC_BATCH,
                 group_mb=ELASTIC_GROUP_MB):
    """Phase 23 (a): the flagship LM fed by an elastic pod that loses a host
    and, in another run, gains one. Returns the launch counts (K1-K3)."""
    from petastorm_tpu_torch.torch_utils import stage_to_device
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    seq = cfg.max_seq_len
    specs = elastic_specs(args.seed)
    dev = torch.device(device if device != 'cuda'
                       else 'cuda:%d' % torch.cuda.current_device())
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        path = os.path.join(d, 'elastic_tokens')
        url = 'file://' + path
        tokens = write_token_rows(np, url, rows, seq + 1, cfg.vocab_size,
                                  args.seed, group_mb=group_mb)
        arrow = arrow_token_rows(np, path)
        check(np.array_equal(arrow, tokens),
              'elastic store: the pyarrow read differs from the generator')
        groups = row_groups(path)

        def run(tag, spec, hosts, consume=None):
            return elastic_run(np, url, os.path.join(d, 'coord-' + tag), spec,
                               hosts, batch, args.seed, consume)

        # (1) the clean references, one a grid (3 hosts: 6 leases; the
        # join run's 2 hosts: 4 leases), batches kept on the host
        clean = {}
        for hosts in (ELASTIC_HOSTS, ELASTIC_JOIN_FROM):
            report, facts = run('clean%d' % hosts, None, hosts)
            plan = facts['plan']
            check(facts['certificate']['ok'] and not report['deaths']
                  and not report['joins'],
                  'elastic clean %d hosts: %s' % (hosts, report['audit']))
            for (lease, b), got in facts['batches'].items():
                check(np.array_equal(got, arrow[plan.batch_rows(lease, 0, b)]),
                      'elastic clean: lease %d batch %d differs from the '
                      'pyarrow rows' % (lease, b))
            clean[hosts] = (report, facts)
        report, facts = clean[ELASTIC_HOSTS]
        log('elastic clean: %d hosts, %d row groups, %d leases, %d batches '
            'of %d rows, certificate ok, each batch == pyarrow\'s rows of '
            'plan.batch_rows; epoch %.3f s host-only, lease plane %.3f ms a '
            'batch (ElasticHost.step less its gather and consumer), gather '
            '%.3f ms a batch'
            % (ELASTIC_HOSTS, groups, facts['plan'].num_leases,
               len(facts['batches']), batch, facts['epoch_s'],
               facts['plane_s'] * 1e3,
               statistics.median(facts['gather_s']) * 1e3))

        # (2) death and (3) join: every delivered batch staged to the card
        # and one AdamW step of the LM
        params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                          device=device)
        _, step = tlm.make_train_step(cfg, params)
        if device == 'cuda':
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        lm = {}
        for tag, hosts in (('death', ELASTIC_HOSTS),
                           ('join', ELASTIC_JOIN_FROM)):
            plan = clean[hosts][1]['plan']
            refs = {key: (torch.from_numpy(got).to(dev),
                          torch.from_numpy(
                              arrow[plan.batch_rows(key[0], 0, key[1])])
                          .to(dev))
                    for key, got in clean[hosts][1]['batches'].items()}
            out = {'losses': [], 'step_s': [], 'unequal': []}

            def consume(host_tokens, lease, b):
                staged, _ = stage_to_device({'tokens': host_tokens}, dev)
                t = staged['tokens']
                ref, want = refs[(lease, b)]
                if not (torch.equal(t, ref) and torch.equal(t, want)):
                    out['unequal'].append((lease, b))
                t0 = time.perf_counter()
                t = t.long()
                out['losses'].append(float(step(t[:, :-1], t[:, 1:])))
                out['step_s'].append(time.perf_counter() - t0)

            report, facts = run(tag, specs[tag], hosts, consume)
            check(facts['certificate']['ok'],
                  'elastic %s: certificate %s' % (tag, report['audit']))
            check(not out['unequal'],
                  'elastic %s: staged batches %s differ from the clean run '
                  "or pyarrow's rows" % (tag, out['unequal'][:4]))
            check(len(out['losses']) == facts['plan'].total_batches()
                  and all(math.isfinite(x) for x in out['losses']),
                  'elastic %s: %d steps, losses %s'
                  % (tag, len(out['losses']), out['losses'][:4]))
            counters = report['counters']
            if tag == 'death':
                check(len(report['deaths']) == 1
                      and counters['hosts_died'] >= 1
                      and counters['leases_rebalanced'] > 0
                      and facts['first_moved_s'] is not None,
                      'elastic death: deaths %s, counters %s'
                      % (report['deaths'], counters))
            else:
                check(len(report['joins']) == 1
                      and counters['hosts_joined'] >= 1
                      and report['audit']['by_host'].get(
                          report['joins'][0], 0) > 0,
                      'elastic join: joins %s, counters %s, by host %s'
                      % (report['joins'], counters,
                         report['audit']['by_host']))
            # the same chaos seed, host only: the same membership story
            replay, _ = run(tag + '-replay', specs[tag], hosts)
            check((replay['deaths'], replay['joins'], replay['counters'])
                  == (report['deaths'], report['joins'], counters),
                  'elastic %s replay: %s %s %s against %s %s %s'
                  % (tag, replay['deaths'], replay['joins'],
                     replay['counters'], report['deaths'], report['joins'],
                     counters))
            lm[tag] = (report, facts, out)
            log('elastic %s (%s, %d hosts%s): %d batches, %d LM steps, '
                'certificate ok; deaths %s, joins %s; counters %s; staged '
                'tokens == the clean run\'s and pyarrow\'s, bit for bit; '
                'same-seed replay: the same deaths, joins and counters; '
                'epoch %.3f s; LM steady step %.2f ms; loss %.4f -> %.4f; '
                'lease plane %.3f ms a batch%s [%s]'
                % (tag, specs[tag], hosts,
                   ', one joins' if tag == 'join' else ', one dies',
                   facts['plan'].total_batches(), len(out['losses']),
                   report['deaths'], report['joins'],
                   json.dumps(counters, sort_keys=True), facts['epoch_s'],
                   statistics.median(out['step_s'][1:]) * 1e3,
                   out['losses'][0], out['losses'][-1],
                   facts['plane_s'] * 1e3,
                   '; %.3f s from the death to the first batch on a moved '
                   'lease' % facts['first_moved_s']
                   if tag == 'death' else '', CARD))
        steps = sum(len(v[2]['losses']) for v in lm.values())
        launches = dict(kernels.LAUNCHES)
        if device == 'cuda':
            check(all(launches[k] == steps * cfg.n_layers for k in FLASH),
                  'elastic LM launches %r for %d steps of %d layers'
                  % (launches, steps, cfg.n_layers))
        shards = elastic_readers(np, url, d, rows)
        log('elastic readers: make_reader(elastic=) hosts a and b read '
            'shards of %d and %d rows, disjoint, union the store; '
            'PETASTORM_TPU_ELASTIC=0 made no member file; elastic= beside '
            "cur_shard raised JAX's words; LM launches %s over %d steps"
            % (shards['a'], shards['b'], json.dumps(launches), steps))
    return launches


def reserve_port():
    """A free port of 127.0.0.1, known before the server that binds it
    starts."""
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def podobs_off_checks(url, roots, servers, hosts, routes_text):
    """``PETASTORM_TPU_PODOBS=0``: both routes 404 with JAX's text, no trace
    id on a cache, no header on a peer reply, no ``io_attempt`` span of a
    hedged, traced reader (which records them with the plane on)."""
    from petastorm_tpu_torch import make_columnar_reader, podobs
    from petastorm_tpu_torch.sharedcache import SharedRowGroupCache

    def hedged_pass():
        with make_columnar_reader(url, schema_fields=['idx'], num_epochs=1,
                                  workers_count=2, trace=True, hedge=10.0,
                                  debug_port=0) as reader:
            n = sum(len(b.idx) for b in reader)
            spans = sum(1 for s in reader.tracer.spans()
                        if s[0] == 'io_attempt')
            routes = {r: http_exchange(reader.debug_port, r)[:2]
                      for r in routes_text}
        return n, spans, routes

    on = hedged_pass()
    os.environ[podobs.PODOBS_ENV_VAR] = '0'
    try:
        off = hedged_pass()
        root, kw = roots.kw('podobs_off', 1 << 20)
        cache = SharedRowGroupCache(root, CACHE_LIMIT, peers=[hosts[0]],
                                    **kw['cache_extra_settings'])
        trace_id = cache.trace_id
        cache.close()
        before = dict(servers[0]._peer_server.traces)
        _, _, headers = http_exchange(servers[0]._peer_server.port,
                                      '/peercache/' + 'f' * 32,
                                      {podobs.TRACE_HEADER: 'off'})
        after = dict(servers[0]._peer_server.traces)
    finally:
        os.environ.pop(podobs.PODOBS_ENV_VAR, None)
    check(on[1] > 0 and on[0] == off[0] and off[1] == 0,
          'io_attempt spans: %d with the pod plane on, %d off' % (on[1],
                                                                  off[1]))
    check(all(status == 404 and body == routes_text[r]
              for r, (status, body) in off[2].items()),
          'PETASTORM_TPU_PODOBS=0 routes: %s' % off[2])
    check(on[2]['/observe/snapshot'][0] == 200,
          'the pod plane on: /observe/snapshot %s'
          % on[2]['/observe/snapshot'][0])
    check(trace_id == '' and before == after
          and podobs.TRACE_HEADER not in headers
          and podobs.CLOCK_HEADER not in headers,
          'PETASTORM_TPU_PODOBS=0: trace id %r, headers %s' % (trace_id,
                                                              headers))
    return on[1]


def pod_obs_line(torch, np, kernels, args, device='cuda', rows=IMAGE_ROWS,
                 batch=IMAGE_BATCH, size=IMAGE_SIZE):
    """Phase 23 (b): pod observability over the png store's pod of three
    shared-cache roots, each host's reader serving ``/observe/snapshot``,
    the third aggregating ``/podmetrics``, the CNN on K4 from its
    batches. Returns the launch counts (K4)."""
    from petastorm_tpu_torch import (PodObserver, TorchDataLoader,
                                     TransformSpec, make_columnar_reader,
                                     podobs, prefetch_to_device)
    from petastorm_tpu_torch.examples.imagenet.main import \
        make_resize_transform
    from petastorm_tpu_torch.health import UNWIRED_ROUTES
    from petastorm_tpu_torch.models import image_cnn as cnn
    from petastorm_tpu_torch.sharedcache import SharedRowGroupCache
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        path = os.path.join(d, 'podobs_images')
        url = 'file://' + path
        write_indexed_images(np, url, rows, args.seed)
        groups = row_groups(path)
        resize = make_resize_transform(size)
        spec = TransformSpec(resize.func, edit_fields=resize.edit_fields,
                             selected_fields=['idx', 'image', 'label'])
        roots = SharedRoots(d)
        servers, hosts, readers, thread = [], [], [], None
        try:
            for i in range(POD_HOSTS):
                root, kw = roots.kw('podobs_host%d' % i, IMAGE_TIER0)
                server = SharedRowGroupCache(root, CACHE_LIMIT,
                                             **kw['cache_extra_settings'])
                servers.append(server)
                hosts.append((kw, '127.0.0.1:%d' % server.serve_peers()))

            def open_host(i, debug_port=0):
                kw, _ = hosts[i]
                extra = dict(kw['cache_extra_settings'], peers=[
                    h[1] for j, h in enumerate(hosts) if j != i])
                readers.append(make_columnar_reader(
                    url, num_epochs=1, workers_count=POD_THREADS,
                    seed=args.seed + i, transform_spec=spec, trace=True,
                    debug_port=debug_port,
                    **dict(kw, cache_extra_settings=extra)))
                return readers[-1]

            def drain(reader, out):
                for b in reader:
                    for k, x in zip(b.idx, b.image):
                        out[int(k)] = np.ascontiguousarray(x).tobytes()

            cold = {}
            drain(open_host(0), cold)
            check(sorted(cold) == list(range(rows)),
                  'podobs cold host: %d images' % len(cold))
            second, errors = {}, []
            reader2 = open_host(1)
            port3 = reserve_port()
            peers = ['127.0.0.1:%d' % r.debug_port for r in readers] + [
                '127.0.0.1:%d' % port3]
            os.environ[podobs.PODOBS_PEERS_ENV_VAR] = ','.join(peers)
            try:
                reader3 = open_host(2, debug_port=port3)
            finally:
                os.environ.pop(podobs.PODOBS_PEERS_ENV_VAR, None)
            check(reader3.debug_port == port3,
                  'podobs host 3 bound %s, not the reserved %d'
                  % (reader3.debug_port, port3))

            def host2():
                try:
                    drain(reader2, second)
                except BaseException as e:   # re-raised on the main thread
                    errors.append(e)
            params = cnn.init(torch.Generator().manual_seed(args.seed),
                              num_classes=IMAGE_CLASSES, device=device)
            step = cnn.make_train_step(params, lr=1e-3)
            if device == 'cuda':
                torch.cuda.synchronize()
            kernels.reset_launch_counts()
            thread = threading.Thread(target=host2, name='podobs-host2')
            thread.start()
            third, losses = {}, []
            loader = TorchDataLoader(reader3, batch_size=batch,
                                     device=device)
            batches = prefetch_to_device(iter(loader), size=2, device=device)
            with contextlib.closing(batches):
                for b in batches:
                    if len(losses) < POD_STEPS:
                        losses.append(float(step(b['image'], b['label'])))
                    images = b['image'].cpu().numpy()
                    for k, x in zip(b['idx'].cpu().numpy(), images):
                        third[int(k)] = x.tobytes()
            thread.join(120)
            check(not thread.is_alive() and not errors,
                  'podobs host 2: %s' % (errors or 'did not finish'))
            launches = dict(kernels.LAUNCHES)
            check(len(losses) == POD_STEPS
                  and all(math.isfinite(x) for x in losses),
                  'podobs CNN: losses %s' % losses)
            if device == 'cuda':
                check(launches['normalize'] == POD_STEPS,
                      'podobs CNN: K4 launched %d times in %d steps'
                      % (launches['normalize'], POD_STEPS))
            check(third == cold and second == cold,
                  "podobs hosts 2 and 3: images differ from the cold host's")

            # each host's snapshot: one JSON, the clock, the trace echoed
            trace_id = podobs.new_trace_id()
            snaps = []
            for peer in peers:
                status, body, headers = http_exchange(
                    int(peer.rsplit(':', 1)[1]), podobs.SNAPSHOT_ROUTE,
                    {podobs.TRACE_HEADER: trace_id})
                snap = json.loads(body)
                check(status == 200
                      and snap['kind'] == 'petastorm_tpu.observe_snapshot'
                      and isinstance(float(headers[podobs.CLOCK_HEADER]),
                                     float)
                      and headers.get(podobs.TRACE_HEADER) == trace_id,
                      'podobs %s snapshot: %s, headers %s'
                      % (peer, status, headers))
                snaps.append(snap)
            status, body, headers = http_exchange(
                port3, podobs.PODMETRICS_ROUTE,
                {podobs.TRACE_HEADER: trace_id})
            served = json.loads(body)
            check(status == 200 and served['kind'] == 'petastorm_tpu.'
                  'podmetrics' and served['hosts_reporting'] == POD_HOSTS
                  and headers.get(podobs.TRACE_HEADER) == trace_id,
                  'podobs /podmetrics: %s' % status)
            observer = PodObserver(peers, expected_row_groups=groups)
            start = time.perf_counter()
            report = observer.report()
            poll_s = time.perf_counter() - start
            observer.assert_certificate(report)
            for label, rep in (('/podmetrics', served), ('report()', report)):
                cert = rep['certificate']
                check(cert['fills'] == groups
                      and cert['peer_hits'] == 2 * groups
                      and rep['verdict'] != podobs.PARTIAL_POD,
                      'podobs %s: fills %s, peer_hits %s over %d row groups, '
                      'verdict %s' % (label, cert['fills'], cert['peer_hits'],
                                      groups, rep['verdict']))
            merged = podobs.merge_histogram_states(
                [s['latency_histograms'] for s in snaps])
            want = round(podobs.state_percentiles(
                merged['peer_fetch'])['p99'], 9)
            got = (report['latency']['peer_fetch']['p99_s'],
                   served['latency']['peer_fetch']['p99_s'])
            check(got == (want, want),
                  'podobs peer_fetch p99 %s, bucket-merged %s' % (got, want))
            offsets = [(h['clock_offset_s'], h['rtt_s'])
                       for h in report['hosts']]
            check(all(abs(o) <= rtt for o, rtt in offsets),
                  'podobs clock offsets %s' % offsets)
            # a dead peer: named, and the certificate refuses
            partial_observer = PodObserver(peers + [DEAD_PEER], timeout_s=0.5,
                                           expected_row_groups=groups)
            partial = partial_observer.report()
            try:
                partial_observer.assert_certificate(partial)
                refused = None
            except podobs.PodCertificateError as e:
                refused = str(e)
            check(partial['verdict'] == podobs.PARTIAL_POD
                  and [u['peer'] for u in partial['unreachable']]
                  == [DEAD_PEER] and refused is not None
                  and DEAD_PEER in refused,
                  'podobs partial pod: verdict %s, unreachable %s, refused %r'
                  % (partial['verdict'], partial['unreachable'], refused))
            # the stitched trace: a track a host; host 3's peer fetches
            # against the serving side's record of its trace id
            trace_path = os.path.join(d, 'pod_trace.json')
            observer.export_pod_chrome_trace(trace_path, report)
            with open(trace_path) as f:
                events = json.load(f)['traceEvents']
            tracks = {e['pid']: e['args']['name'] for e in events
                      if e['ph'] == 'M'}
            check(len(tracks) == POD_HOSTS
                  and all(sum(p in n for n in tracks.values()) == 1
                          for p in peers),
                  'podobs stitched trace tracks %s' % tracks)
            track3 = next(pid for pid, n in tracks.items() if peers[2] in n)
            hits3 = [e for e in events if e.get('name') == 'peer_fetch'
                     and e['pid'] == track3
                     and (e.get('args') or {}).get('outcome') == 'hit']
            trace3 = reader3._spec.cache.trace_id
            fetches3 = sum(1 for s in reader3.tracer.spans()
                           if s[0] == 'peer_fetch')
            echoed3 = sum(s._peer_server.traces.get(trace3, 0)
                          for s in servers)
            check(hits3 and trace3 and fetches3 == echoed3,
                  'podobs trace id %r: %d peer_fetch hits on host 3\'s '
                  'track, %d fetches, %d served under its id'
                  % (trace3, len(hits3), fetches3, echoed3))
            io_attempts = podobs_off_checks(
                url, roots, servers, [h[1] for h in hosts], UNWIRED_ROUTES)
        finally:
            if thread is not None:
                thread.join(120)
            for reader in readers:
                reader.stop()
                reader.join()
            for server in servers:
                server.close()
            roots.remove()
    log('podobs: %d hosts x %d threads over %d png row groups, each '
        'serving /observe/snapshot (one JSON, X-Petastorm-Clock-S, the '
        'trace id echoed); host 3 aggregates /podmetrics; report() %.3f s: '
        'fills %d (== row groups), peer_hits %d (== 2 x row groups), '
        'certificate ok; pod peer_fetch p99 %.6f s == the bucket-merged '
        'p99 of the three hosts\' states; clock offsets %s within their '
        'round trips; %s named partial_pod and refused; stitched trace of '
        '%d tracks, host 3\'s %d peer fetches all served under its trace '
        'id; %d io_attempt spans of a hedged traced reader, none and both '
        'routes 404 under PETASTORM_TPU_PODOBS=0; %d CNN steps on K4 from '
        "host 3's batches, loss %.4f -> %.4f, images == the cold host's "
        'byte for byte [%s]'
        % (POD_HOSTS, POD_THREADS, groups, poll_s,
           report['certificate']['fills'], report['certificate']['peer_hits'],
           want, ' '.join('%+.6f/%.6f' % o for o in offsets), DEAD_PEER,
           len(tracks), fetches3, io_attempts, POD_STEPS, losses[0],
           losses[-1], CARD))
    return launches


def pod_planes_line(torch, np, tlm, kernels, args):
    """Phase 23: (a) :func:`elastic_line`, (b) :func:`pod_obs_line`; returns
    their launch counts."""
    phase = time.perf_counter()
    elastic = elastic_line(torch, np, tlm, kernels, args)
    log('phase 23 (a) elastic pod %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    observed = pod_obs_line(torch, np, kernels, args)
    log('phase 23 (b) pod observability %.1f s'
        % (time.perf_counter() - phase))
    return elastic, observed


# ---------------------------------------------------------------------------
# phase 24: data and sequence parallelism (ranks on one card)
# ---------------------------------------------------------------------------

PAR_RING_SHAPE = (8, 8, 2048, 64)  # (a): B, H, L, head_dim of the ring
PAR_RING_SEQS = (2, 4)             # (a): seq ranks of the ring
PAR_RING_REPS = 3                  # (a): ring calls a case, the first warms up
PAR_MESH = {'data': 2, 'seq': 2}   # (b)
PAR_BATCH = 8                      # (b), (c): the global batch
PAR_STEPS = 8                      # (b): AdamW steps on the mesh
PAR_DP_ROWS = 288                  # (c): rows of 2,049 tokens ...
PAR_DP_GROUP_MB = 0.26             # ... in 9 row groups of 32 rows
PAR_DP_STEPS = 4                   # (c): LM steps of the first pass
PAR_LOSS_RTOL = 2e-3               # a sharded step's loss vs one process's
PAR_GRAD_RTOL = 5e-2               # step 1's gradient, relative norm a leaf
PAR_LR = 3e-4                      # the train step's AdamW rate
PAR_TIMEOUT_S = 600


def _par_leaves(tlm, params):
    return [p.detach() for p in tlm.parameters(params)]


def _par_seq_cat(torch, x, group, dim):
    """``x`` all-gathered over the seq ``group`` and concatenated on
    ``dim``."""
    from petastorm_tpu_torch.parallel.mesh import all_gather
    return torch.cat(all_gather(x.contiguous(), group), dim=dim)


def ring_gates(torch, kernels, label, n, full, got, plain, causal, h, hkv):
    """(a)'s gates on the gathered ring outputs ``got`` (the kernels) and
    ``plain`` (the twins' ring in float32; its backward on the kernel
    ring's residuals). The ring holds against one process's K1 over the
    whole sequence and K2 + K3 on the ring's own (o, lse), and against the
    twins' ring, within limits derived from the rounding each side does:
    both sides are within ``flash_gate_limit`` of the float32 value, and the
    ring rounds each chunk pair's o (or dq, dk, dv) to bf16 before its float32
    merge, at most half an ulp of a term whose magnitudes sum to at most
    the bound ``B`` (``flash_rounding_bounds``): ``2^-9 B``; its n float32
    partial sums add ``n 1e-5``. So ring vs whole: ``2 flash_gate_limit +
    2^-9 B + n 1e-5``, ring vs twins: ``flash_gate_limit + 2^-9 B + n
    1e-5``; lse (float32 throughout): ``2 TOL_F32 (1 + |lse|)`` and
    ``TOL_F32 (1 + |lse|)``. Float32 operands: ``TOL_F32`` (twice for the
    whole). Returns the max abs error of each output against the whole."""
    from petastorm_tpu_torch.ops.attention import (flash_attention_with_lse,
                                                   flash_backward)
    q, k, v, do = full
    o, lse, dq, dk, dv = got
    bf16 = q.dtype == torch.bfloat16
    o_w, lse_w = flash_attention_with_lse(q, k, v, causal=causal)
    dq_w, dk_w, dv_w = flash_backward(q, k, v, o, lse, do, causal=causal)
    b, _, l, d = q.shape
    flat = lambda x, hh: x.float().reshape(b * hh, l, d)
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, l)
    bound = kernels.flash_rounding_bounds(
        flat(q, h), flat(k, hkv), flat(v, hkv), flat(do, h),
        lse.reshape(b * h, l), delta, n_heads=h, n_kv_heads=hkv,
        causal=causal)
    g = h // hkv
    bounds = {'o': bound['o'].reshape(b, h, l, d),
              'dq': bound['dq'].reshape(b, h, l, d),
              'dk': bound['dk'].reshape(b, hkv, g, l, d).sum(2),
              'dv': bound['dv'].reshape(b, hkv, g, l, d).sum(2)}
    errs = {}
    for name, x, whole, twin in (('o', o, o_w, plain[0]),
                                 ('dq', dq, dq_w, plain[2]),
                                 ('dk', dk, dk_w, plain[3]),
                                 ('dv', dv, dv_w, plain[4])):
        check(bool(torch.isfinite(x).all()), '%s %s: non-finite' % (label,
                                                                    name))
        for ref, twice in ((whole, 2), (twin, 1)):
            ref = ref.float()
            if bf16:
                limit = (twice * kernels.flash_gate_limit(ref, bounds[name],
                                                          x.dtype)
                         + 2.0 ** -9 * bounds[name] + n * 1e-5)
            else:
                limit = twice * TOL_F32 * (1 + ref.abs())
            err = (x.float() - ref).abs()
            bad = err > limit
            check(not bool(bad.any()),
                  '%s %s: %d elements beyond the limit against the %s (max '
                  'abs err %.3g)' % (label, name, int(bad.sum()),
                                     'whole sequence' if twice == 2
                                     else "twins' ring", float(err.max())))
        errs[name] = float((x.float() - whole.float()).abs().max())
    for ref, twice in ((lse_w, 2), (plain[1], 1)):
        err = (lse - ref).abs()
        check(not bool((err > twice * TOL_F32 * (1 + ref.abs())).any()),
              '%s lse: max abs err %.3g' % (label, float(err.max())))
    errs['lse'] = float((lse - lse_w).abs().max())
    return errs


def ring_case(torch, kernels, mesh, shape, hkv, causal, seed, dtype, reps):
    """(a) on one rank: the ring over ``mesh``'s seq group on this rank's
    chunk of seeded (B, H, L, D) q, k, v, do (``reps`` calls, fwd and bwd
    timed, the launches of the last counted), then its outputs gathered;
    the rank of global rank 0 runs :func:`ring_gates`."""
    import torch.distributed as dist

    from petastorm_tpu_torch.ops.attention import (
        _FlashDims, _prepare_flash_bwd_q_side)
    from petastorm_tpu_torch.parallel import ring as pring
    from petastorm_tpu_torch.parallel.mesh import (TRANSPORT_STATS,
                                                   axis_index, axis_size,
                                                   reset_transport_stats)
    b, h, l, d = shape
    n, me = axis_size(mesh, 'seq'), axis_index(mesh, 'seq')
    group = mesh.get_group('seq')
    device = mesh.device_type
    cuda = device == 'cuda'
    gen = torch.Generator().manual_seed(seed)
    full = [torch.randn(b, hh, l, d, generator=gen).to(dtype).to(device)
            for hh in (h, hkv, hkv, h)]
    c = l // n
    q, k, v, do = (x[:, :, me * c:(me + 1) * c].contiguous() for x in full)
    times = []
    for rep in range(reps):
        ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))
        if rep == reps - 1:
            kernels.reset_launch_counts()
            reset_transport_stats()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = pring.ring_attention(ql, kl, vl, group, causal=causal,
                                 impl='kernel')
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        o.backward(do)
        if cuda:
            torch.cuda.synchronize()
        times.append((t1 - t0, time.perf_counter() - t1))
    launches = dict(kernels.LAUNCHES)
    moved = sum(s['bytes'] for s in TRANSPORT_STATS.values())
    routes = sorted(TRANSPORT_STATS)
    steady = times[1:] or times
    # the gates' inputs, not counted: lse, the twins' ring, the gathers
    _, lse = pring.ring_lse(q, k, v, group, causal=causal, impl='kernel')
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o_p, lse_p = pring.ring_lse(q32, k32, v32, group, causal=causal,
                                impl='plain')
    dims = _FlashDims(q.shape, k.shape)
    prep = _prepare_flash_bwd_q_side(dims, q32, o.detach().float(), lse,
                                     do32)
    grads_p = pring._ring_backward(dims, prep, dims.flat_kv(k32),
                                   dims.flat_kv(v32), group, causal, True)
    dq_p, dk_p, dv_p = (dims.unflat_q(grads_p[0]),
                        dims.unflat_kv(grads_p[1]),
                        dims.unflat_kv(grads_p[2]))
    got = [_par_seq_cat(torch, x, group, 2)
           for x in (o.detach(), lse, ql.grad, kl.grad, vl.grad)]
    plain = [_par_seq_cat(torch, x, group, 2)
             for x in (o_p, lse_p, dq_p, dk_p, dv_p)]
    label = 'ring seq=%d %s %s' % (n, 'causal' if causal else 'non-causal',
                                   'MHA' if hkv == h else 'GQA %d->%d'
                                   % (h, hkv))
    errs = (ring_gates(torch, kernels, label, n, full, got, plain, causal, h,
                       hkv) if dist.get_rank() == 0 else None)
    return {'label': label, 'n': n, 'causal': causal, 'launches': launches,
            'fwd_ms': 1e3 * statistics.median(t[0] for t in steady),
            'bwd_ms': 1e3 * statistics.median(t[1] for t in steady),
            'bytes': moved, 'routes': routes, 'errs': errs}


def adamw_gate(torch, tag, params1, ref_leaves, grads1):
    """Step 1's parameters on the mesh (``params1``, gathered) against the
    one-process step's (``ref_leaves``, with their ``.grad``): AdamW's
    first step moves a parameter by lr g / (|g| + eps), about lr sign(g),
    so the two steps' parameters part by more than lr/2 only where the
    gradients (``grads1``: the mesh's, gathered) differ in sign or one is
    within 100 eps of zero. Returns ``(max |diff|, share > lr/2)``."""
    moved = unexplained = total = 0
    top = 0.0
    worst = []
    for a, p, g in zip(params1, ref_leaves, grads1):
        diff = (a - p.detach()).abs()
        far = diff > PAR_LR / 2
        top = max(top, float(diff.max()))
        g, g_ref = g.float(), p.grad.float()
        explained = ((g * g_ref <= 0)
                     | (torch.minimum(g.abs(), g_ref.abs()) < 100 * 1e-8))
        bad = far & ~explained
        moved += int(far.sum())
        unexplained += int(bad.sum())
        total += p.numel()
        if bad.any():
            i = int(bad.flatten().nonzero()[0])
            worst.append((float(g.flatten()[i]), float(g_ref.flatten()[i]),
                          float(diff.flatten()[i])))
    check(top <= 2 * PAR_LR * 1.01 and unexplained == 0,
          '%s step 1 params: max |diff| %.3g, %d more than lr/2 apart where '
          'the gradients agree in sign and are not near 0; (g, g_ref, '
          'diff) e.g. %r' % (tag, top, unexplained, worst[:4]))
    return top, moved / total


def ring_lm(torch, np, tlm, kernels, mesh, cfg, url, seed, batch, steps):
    """(b) on one rank: the flagship LM with ring attention on ``mesh``
    (data x seq), fed by the sharded indexed NGram loader; global rank 0
    then replays the steps in one process with flash attention on the
    gathered global batches."""
    import dataclasses

    import torch.distributed as dist

    from petastorm_tpu_torch import make_indexed_ngram_loader
    from petastorm_tpu_torch.parallel.mesh import (TRANSPORT_STATS,
                                                   all_gather, axis_index,
                                                   axis_size,
                                                   reset_transport_stats)
    from petastorm_tpu_torch.weights import gather_params, shard_params
    device = mesh.device_type
    cuda = device == 'cuda'
    init = tlm.init(cfg, torch.Generator().manual_seed(seed), device=device)
    start = [p.clone() for p in tlm.parameters(init)]
    params = shard_params(init, cfg, mesh)
    _, step = tlm.make_train_step(cfg, params, mesh)
    leaves = tlm.parameters(params)
    loader = make_indexed_ngram_loader(url, resume_ngram(), batch_size=batch,
                                       num_epochs=1, seed=seed, mesh=mesh,
                                       workers_count=2)
    seq_n, seq_i = axis_size(mesh, 'seq'), axis_index(mesh, 'seq')
    local, losses, times, transport = [], [], [], []
    grads1 = params1 = None
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    it = iter(loader)
    for s in range(steps):
        batch_s = next(it)
        tokens = batch_s[0]['tokens']
        targets = torch.cat([tokens[:, 1:], batch_s[1]['tokens'][:, :1]], 1)
        local.append((tokens, targets))
        c = tokens.shape[1] // seq_n
        sl = slice(seq_i * c, (seq_i + 1) * c)
        reset_transport_stats()
        t0 = time.perf_counter()
        loss = float(step(tokens[:, sl].contiguous(),
                          targets[:, sl].contiguous()))
        times.append(time.perf_counter() - t0)
        transport.append(sum(v['seconds'] for v in TRANSPORT_STATS.values()))
        losses.append(loss)
        if s == 0:
            grads1 = [p.grad.detach().clone() for p in leaves]
            params1 = _par_leaves(tlm, gather_params(params, cfg, mesh))
    launches = dict(kernels.LAUNCHES)
    it.close()
    loader.close()
    # the seq ranks of a data group staged equal batches
    seq_group, data_group = mesh.get_group('seq'), mesh.get_group('data')
    for tokens, targets in local:
        for x in (tokens, targets):
            parts = all_gather(x, seq_group)
            check(all(torch.equal(p, parts[0]) for p in parts),
                  '(b) the seq ranks of a data group staged different '
                  'batches')
    global_batches = [tuple(torch.cat(all_gather(x, data_group), 0)
                            for x in pair) for pair in local]
    out = {'losses': losses, 'times': times, 'transport': transport,
           'launches': launches, 'finite': all(math.isfinite(x)
                                               for x in losses)}
    if cuda:
        # every rank's cached blocks go back to the card before rank 0
        # runs the whole global batch in one process
        torch.cuda.empty_cache()
        dist.barrier()
    if dist.get_rank() != 0:
        return out
    # the unsharded loader's global batches, bit for bit
    ref_loader = make_indexed_ngram_loader(url, resume_ngram(),
                                           batch_size=batch, num_epochs=1,
                                           seed=seed, workers_count=2)
    ref_it = iter(ref_loader)
    for s, (tokens, targets) in enumerate(global_batches):
        want = next(ref_it)
        check(np.array_equal(tokens.cpu().numpy(), want[0]['tokens'])
              and np.array_equal(targets[:, -1].cpu().numpy(),
                                 want[1]['tokens'][:, 0]),
              '(b) step %d: the data groups\' batches are not the unsharded '
              'loader\'s global batch' % s)
    ref_it.close()
    ref_loader.close()
    # one process, flash attention, the same parameters and batches
    flash = dataclasses.replace(cfg, attention='flash')
    ref = tlm.init(flash, torch.Generator().manual_seed(seed), device=device)
    for p, p0 in zip(tlm.parameters(ref), start):
        p.data.copy_(p0)
    _, ref_step = tlm.make_train_step(flash, ref)
    ref_leaves = tlm.parameters(ref)
    diffs = []
    for s, (tokens, targets) in enumerate(global_batches):
        want = float(ref_step(tokens, targets))
        diffs.append(abs(losses[s] - want) / abs(want))
        check(diffs[-1] <= PAR_LOSS_RTOL,
              '(b) step %d: loss %.6f on the mesh, %.6f in one process'
              % (s, losses[s], want))
        if s == 0:
            grad_rel = max(float((g - p.grad).norm()
                                 / (p.grad.norm() + 1e-12))
                           for g, p in zip(grads1, ref_leaves))
            check(grad_rel <= PAR_GRAD_RTOL,
                  '(b) step 1 gradient relative error %.3g' % grad_rel)
            top, share = adamw_gate(torch, '(b)', params1, ref_leaves,
                                    grads1)
    out.update(loss_rtol=max(diffs), grad_rel=grad_rel, param_max=top,
               param_share=share)
    return out


def gloo_cuda_ops(torch):
    """Which gloo collectives take CUDA tensors on this build: each is
    called with a CUDA tensor on every rank (a refusal raises on every rank
    alike, so no rank waits alone). Send and receive are not tried: gloo's
    point-to-point takes host tensors only, and a rank stuck in one would
    hang the others."""
    import torch.distributed as dist
    out = {}
    x = torch.ones(4, device='cuda')
    tries = {'all_reduce': lambda: dist.all_reduce(x),
             'broadcast': lambda: dist.broadcast(x, src=0),
             'all_gather': lambda: dist.all_gather(
                 [torch.empty_like(x) for _ in range(dist.get_world_size())],
                 x)}
    for name, call in tries.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = 'yes'
        except Exception as e:        # the build refuses CUDA tensors
            out[name] = 'no: %s' % str(e).splitlines()[0][:80]
    return out


def parallel_ranks(spec):
    """The body of phase 24 (a) and (b) on each of 4 ranks."""
    import torch

    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.ops import kernels
    from petastorm_tpu_torch.parallel import make_mesh
    import numpy as np
    device = spec['device']
    gloo_ops = None
    if device == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        gloo_ops = gloo_cuda_ops(torch)
    cases = []
    for n in spec['seqs']:
        world = torch.distributed.get_world_size()
        axes = {'seq': n} if n == world else {'data': world // n, 'seq': n}
        mesh = make_mesh(axes, device)
        for causal in (True, False):
            for hkv in (spec['shape'][1], 2):
                cases.append(ring_case(torch, kernels, mesh, spec['shape'],
                                       hkv, causal, spec['seed'],
                                       spec['dtype'], spec['reps']))
    if device == 'cuda':
        torch.cuda.empty_cache()        # (a)'s blocks, for the other ranks
    mesh = make_mesh(spec['mesh'], device)
    lm = ring_lm(torch, np, tlm, kernels, mesh, spec['cfg'], spec['url'],
                 spec['seed'], spec['batch'], spec['steps'])
    return {'cases': cases, 'lm': lm, 'gloo_cuda_ops': gloo_ops}


def pyarrow_shard(np, path, shard, shards):
    """``(idx, tokens, row groups)`` of row groups ``shard::shards`` of the
    one-file token store, read with pyarrow alone, in the row reader's
    order: the groups in order, each group's rows last first (the results
    reader pops an item's rows from its end, as JAX's does)."""
    import io

    import pyarrow.parquet as pq
    files = sorted(n for n in os.listdir(path)
                   if n.endswith('.parquet') and not n.startswith(('_', '.')))
    pf = pq.ParquetFile(os.path.join(path, files[0]))
    idx, tokens = [], []
    for g in range(shard, pf.num_row_groups, shards):
        table = pf.read_row_group(g, columns=['idx', 'tokens']).to_pydict()
        idx.extend(table['idx'][::-1])
        tokens.extend(np.load(io.BytesIO(c)) for c in table['tokens'][::-1])
    return np.asarray(idx), np.stack(tokens), pf.num_row_groups


def dp_stream_rank(spec):
    """Phase 24 (c) on each of 2 ranks: ``make_reader(shard_by_jax_process=
    True)`` -> ``make_torch_loader(mesh=)`` -> the LM (flash) for the first
    steps, the loader alone to the lockstep stop; a second pass after the
    reset; global rank 0 replays the steps in one process."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch import make_reader, make_torch_loader
    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.ops import kernels
    from petastorm_tpu_torch.parallel import make_mesh
    from petastorm_tpu_torch.parallel.mesh import all_gather
    from petastorm_tpu_torch.weights import shard_params
    device, cfg, seed = spec['device'], spec['cfg'], spec['seed']
    if device == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh({'data': 2}, device)
    rank = dist.get_rank()
    init = tlm.init(cfg, torch.Generator().manual_seed(seed), device=device)
    start = [p.clone() for p in tlm.parameters(init)]
    params = shard_params(init, cfg, mesh)
    _, step = tlm.make_train_step(cfg, params, mesh)
    reader = make_reader(spec['url'], schema_fields=['idx', 'tokens'],
                         shard_by_jax_process=True, shuffle_row_groups=False,
                         workers_count=1, num_epochs=1)
    drains = []
    drain = reader.drain
    reader.drain = lambda: (drains.append(1), drain())[1]
    loader = make_torch_loader(reader, batch_size=spec['batch'] // 2,
                               mesh=mesh)
    idx, tokens_seen, losses, local = [], [], [], []
    kernels.reset_launch_counts()
    for i, batch in enumerate(loader):
        idx.append(batch['idx'].cpu().numpy())
        tokens = batch['tokens']
        tokens_seen.append(tokens.cpu().numpy())
        if i < spec['steps']:
            local.append(tokens)
            losses.append(float(step(tokens[:, :-1].contiguous(),
                                     tokens[:, 1:].contiguous())))
    launches = dict(kernels.LAUNCHES)
    first = len(idx)
    first_drains = len(drains)
    second = sum(1 for _ in loader)
    reader.stop()
    reader.join()
    counts = all_gather(torch.tensor([first, second, first_drains]))
    counts = [c.tolist() for c in counts]
    want_idx, want_tokens, groups = pyarrow_shard(np, spec['path'], rank, 2)
    got_idx = np.concatenate(idx)
    n = len(got_idx)
    check(np.array_equal(got_idx, want_idx[:n])
          and np.array_equal(np.concatenate(tokens_seen), want_tokens[:n]),
          '(c) rank %d: rows differ from shard %d of 2 read with pyarrow'
          % (rank, rank))
    global_batches = [torch.cat(all_gather(t, None), 0) for t in local]
    out = {'counts': counts, 'rows': n, 'shard_rows': len(want_idx),
           'groups': groups, 'losses': losses, 'launches': launches}
    if rank != 0:
        return out
    flash = dataclasses.replace(cfg, attention='flash')
    ref = tlm.init(flash, torch.Generator().manual_seed(seed), device=device)
    for p, p0 in zip(tlm.parameters(ref), start):
        p.data.copy_(p0)
    _, ref_step = tlm.make_train_step(flash, ref)
    diffs = []
    for s, tokens in enumerate(global_batches):
        want = float(ref_step(tokens[:, :-1].contiguous(),
                              tokens[:, 1:].contiguous()))
        diffs.append(abs(losses[s] - want) / abs(want))
        check(diffs[-1] <= PAR_LOSS_RTOL,
              '(c) step %d: loss %.6f over 2 ranks, %.6f in one process'
              % (s, losses[s], want))
    out['loss_rtol'] = max(diffs)
    return out


def nccl_line(torch, tlm, kernels, cfg, tokens, targets, seed, d):
    """Phase 24 (d): the ring step on a one-rank NCCL mesh {'data': 1,
    'seq': 1} against the flash step, bit for bit (a one-chunk ring is K1-K3
    on the whole sequence). Returns the ring step's launches."""
    import dataclasses

    import torch.distributed as dist

    from petastorm_tpu_torch.parallel import make_mesh
    from petastorm_tpu_torch.parallel.launch import init_rank
    init_rank(d, 0, 1, backend='nccl')
    try:
        mesh = make_mesh({'data': 1, 'seq': 1})
        losses = {}
        launches = None
        for mode in ('ring', 'flash'):
            c = dataclasses.replace(cfg, attention=mode)
            params = tlm.init(c, torch.Generator().manual_seed(seed),
                              device='cuda')
            _, step = tlm.make_train_step(c, params,
                                          mesh if mode == 'ring' else None)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            losses[mode] = [float(step(tokens, targets)) for _ in range(2)]
            if mode == 'ring':
                launches = dict(kernels.LAUNCHES)
        check(losses['ring'] == losses['flash'],
              '(d) ring on one NCCL rank %r vs flash %r'
              % (losses['ring'], losses['flash']))
        check(dist.get_backend() == 'nccl', '(d) backend %s'
              % dist.get_backend())
    finally:
        dist.destroy_process_group()
    log('parallel (d) NCCL mesh {data: 1, seq: 1}: 2 ring steps, losses %s '
        '== flash bit for bit; launches %s'
        % (losses['ring'], json.dumps(launches)))
    return launches


def free_card(torch, label):
    """Give this process's cached device memory back to the card before
    ranks start on it (each rank is a process of its own on the one card)
    and log what the card has free."""
    import gc
    allocated = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log('%s: this process held %.2f GiB allocated, %.2f GiB reserved; '
        'after its cache was emptied the card has %.2f of %.2f GiB free'
        % (label, allocated / 2**30, reserved / 2**30, free / 2**30,
           total / 2**30))


def parallel_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
                  shape=PAR_RING_SHAPE, seqs=PAR_RING_SEQS,
                  reps=PAR_RING_REPS, rows=ROWS, steps=PAR_STEPS,
                  dp_rows=PAR_DP_ROWS, dp_group_mb=PAR_DP_GROUP_MB,
                  dp_steps=PAR_DP_STEPS, dtype=None):
    """Phase 24: data and sequence parallelism, every rank a process on the
    one card over gloo (several ranks on one card cannot form a NCCL
    group); CUDA tensors cross through pinned host memory (the
    ``gloo-host`` transport). (a) + (b) on 4 ranks, (c) on 2, (d) in this
    process on NCCL. Returns the phase's launch counts (K1-K3), summed
    over the ranks."""
    import dataclasses

    from petastorm_tpu_torch.parallel import launch_ranks
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    dtype = dtype or torch.bfloat16
    total = {name: 0 for name in FLASH}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        url = 'file://' + os.path.join(d, 'tokens')
        write_store(np, url, cfg.max_seq_len, cfg.vocab_size, rows,
                    args.seed)
        spec = dict(device=device, seed=args.seed, shape=shape, seqs=seqs,
                    dtype=dtype, reps=reps, mesh=PAR_MESH,
                    cfg=dataclasses.replace(cfg, attention='ring'), url=url,
                    batch=PAR_BATCH, steps=steps)
        if device == 'cuda':
            free_card(torch, 'parallel (a) + (b) before the spawn')
        start = time.perf_counter()
        ranks = launch_ranks('chip_smoke:parallel_ranks', 4,
                             os.path.join(d, 'ab'), args=(spec,),
                             timeout_s=PAR_TIMEOUT_S)
        log('parallel (a) + (b) on 4 ranks %.1f s (spawn, CUDA init and the '
            'runs); gloo collectives on CUDA tensors: %s'
            % (time.perf_counter() - start,
               json.dumps(ranks[0]['gloo_cuda_ops'])))
        # (a)
        for i, case in enumerate(ranks[0]['cases']):
            n = case['n']
            per = [r['cases'][i] for r in ranks]
            groups = 4 // n
            pairs = n * (n + 1) // 2 if case['causal'] else n * n
            for name in FLASH:
                got = sum(p['launches'][name] for p in per)
                # the CPU rehearsal runs the twins: no launches
                check(got == groups * pairs or device != 'cuda',
                      '%s: %s launched %d times over %d seq group(s) of %d, '
                      'not %d a group' % (case['label'], name, got, groups,
                                          n, pairs))
                total[name] += got
            errs = case['errs']
            log('parallel (a) %-28s fwd ms %s bwd ms %s, %d bytes rotated a '
                'rank (%s), launches a group K1 %d K2 %d K3 %d; max abs err '
                'vs whole sequence o %.3g lse %.3g dq %.3g dk %.3g dv %.3g '
                '(limits 2 gate + 2^-9 B + n 1e-5 against the whole, gate + '
                "2^-9 B + n 1e-5 against the twins' ring; lse 2 and 1 x "
                '1e-4(1+|lse|))'
                % (case['label'],
                   '/'.join('%.3f' % p['fwd_ms'] for p in per),
                   '/'.join('%.3f' % p['bwd_ms'] for p in per),
                   per[0]['bytes'], ','.join(per[0]['routes']) or 'none',
                   pairs, pairs, pairs, errs['o'], errs['lse'], errs['dq'],
                   errs['dk'], errs['dv']))
        # (b)
        lm = [r['lm'] for r in ranks]
        check(all(r['finite'] for r in lm), '(b) a non-finite loss')
        for name in FLASH:
            total[name] += sum(r['launches'][name] for r in lm)
            check(all(r['launches'][name] > 0 for r in lm)
                  or device != 'cuda',
                  '(b) %s not launched on every rank' % name)
        check(all(r['losses'] == lm[0]['losses'] for r in lm),
              '(b) the ranks report different losses')
        share = [sum(r['transport'][1:]) / sum(r['times'][1:]) for r in lm]
        log('parallel (b) LM on %s (ring, %s, %d steps, global batch %d): '
            'losses %s; loss vs one process (flash) max rel %.3g (limit %g), '
            'step-1 gradient max rel %.3g (limit %g), step-1 params max '
            '|diff| %.3g (limit 2 lr), %.3g of them > lr/2 apart, each where '
            'the gradients can flip its sign; batches: seq ranks '
            'equal, data groups == the unsharded loader\'s; steady step ms '
            'per rank %s, gloo-host transport share %s'
            % (json.dumps(PAR_MESH), str(cfg.dtype).split('.')[-1], steps,
               PAR_BATCH,
               ['%.4f' % x for x in lm[0]['losses']], lm[0]['loss_rtol'],
               PAR_LOSS_RTOL, lm[0]['grad_rel'], PAR_GRAD_RTOL,
               lm[0]['param_max'], lm[0]['param_share'],
               '/'.join('%.1f' % (1e3 * statistics.median(r['times'][1:]
                                                          or r['times']))
                        for r in lm),
               '/'.join('%.2f' % x for x in share)))

        # (c)
        path = os.path.join(d, 'dp_tokens')
        write_token_rows(np, 'file://' + path, dp_rows, cfg.max_seq_len + 1,
                         cfg.vocab_size, args.seed, group_mb=dp_group_mb)
        spec = dict(device=device, seed=args.seed, cfg=cfg, path=path,
                    url='file://' + path, batch=PAR_BATCH, steps=dp_steps)
        if device == 'cuda':
            free_card(torch, 'parallel (c) before the spawn')
        start = time.perf_counter()
        dp = launch_ranks('chip_smoke:dp_stream_rank', 2,
                          os.path.join(d, 'c'), args=(spec,),
                          timeout_s=PAR_TIMEOUT_S)
        counts = dp[0]['counts']
        check(dp[0]['groups'] == 9, '(c) %d row groups' % dp[0]['groups'])
        check(counts[0][0] == counts[1][0] and counts[0][1] == counts[1][1]
              and counts[0][0] == counts[0][1] > 0,
              '(c) steps a rank (first pass, second pass, drains): %r'
              % counts)
        # at the lockstep stop every rank drains (the one whose stream
        # ended drains nothing); the surplus rank leaves rows unread
        check(all(c[2] == 1 for c in counts)
              and any(r['rows'] < r['shard_rows'] for r in dp),
              '(c) drains a rank %r, rows %r of %r: a surplus must be drained'
              % ([c[2] for c in counts], [r['rows'] for r in dp],
                 [r['shard_rows'] for r in dp]))
        check(all(r['losses'] == dp[0]['losses'] for r in dp),
              '(c) the ranks report different losses')
        for name in FLASH:
            total[name] += sum(r['launches'][name] for r in dp)
        log('parallel (c) 2 ranks, %d row groups, shard_by_jax_process: %d '
            'lockstep steps a pass, both passes (the second after reset), '
            'drains a rank %s; rows a rank %s of shards of %s == pyarrow; '
            'losses %s, vs one process max rel %.3g (limit %g); %.1f s'
            % (dp[0]['groups'], counts[0][0], [c[2] for c in counts],
               [r['rows'] for r in dp], [r['shard_rows'] for r in dp],
               ['%.4f' % x for x in dp[0]['losses']], dp[0]['loss_rtol'],
               PAR_LOSS_RTOL, time.perf_counter() - start))

        # (d)
        if device == 'cuda':
            from petastorm_tpu_torch import make_indexed_ngram_loader
            loader = make_indexed_ngram_loader(url, resume_ngram(),
                                               batch_size=PAR_BATCH,
                                               num_epochs=1, seed=args.seed,
                                               workers_count=1)
            it = iter(loader)
            first = next(it)
            it.close()
            loader.close()
            tokens = torch.from_numpy(first[0]['tokens']).cuda()
            targets = torch.cat([tokens[:, 1:], torch.from_numpy(
                first[1]['tokens'][:, :1]).cuda()], 1)
            launched = nccl_line(torch, tlm, kernels, cfg, tokens, targets,
                                 args.seed, os.path.join(d, 'd'))
            for name in FLASH:
                total[name] += launched[name]
    log('parallel phase launches %s' % json.dumps(total))
    return total

# ---------------------------------------------------------------------------
# phase 25: tensor, expert and pipeline parallelism (ranks on one card)
# ---------------------------------------------------------------------------

TP_MESH = {'data': 2, 'model': 2}  # (a)
EP_MESH = {'data': 2, 'expert': 2}  # (b)
PP_MESH = {'pipe': 2, 'data': 2}   # (c)
TP_STEPS = 4                       # (a), (b): AdamW steps on the mesh
PP_MICRO = 8                       # (c): microbatches ...
PP_ROWS = 2                        # ... of 2 rows a data rank
PP_LAYERS = 2                      # (c): flagship layers a stage
PP_ITERS = 2                       # (c): pipelined steps, the first warms up
PP_OUT_TOL = 2.0 ** -8             # (c): outputs, relative to max |ref|
PP_GRAD_RTOL = 1e-3                # (c): a stage leaf's gradient, rel. norm
# (b): two router probabilities this close count as a bf16 tie. The mesh
# and one process feed the router bf16 activations that may differ by one
# bf16 rounding (2^-8 relative) of the partial sums the mesh adds; through
# the float32 router and its softmax that moves a probability by well
# under 2^-6 (router logits are O(1), |d p / d logit| <= 1/4).
MOE_TIE = 2.0 ** -6
DRY_TOL = 1e-4                     # (d): a dry-run loss vs one process
TP_TIMEOUT_S = 900


def _grad_tree(params):
    """The LM tree of ``params``' gradients (zeros where none)."""
    import torch

    def g(p):
        return p.grad if p.grad is not None else torch.zeros_like(p)
    return {'embed': g(params['embed']),
            'final_norm': g(params['final_norm']),
            'unembed': g(params['unembed']),
            'layers': [{k: g(v) for k, v in layer.items()}
                       for layer in params['layers']]}


def route_gates(torch, got, ref, k, tag):
    """(b)'s bf16 routing gate, rank 0: each layer's units on the mesh
    (``got``) against one process's (``ref``). A unit's top-k margin is
    the smaller gap between its choice's probability and its neighbours'
    in the token's sorted probabilities. Until a layer routes some unit
    differently, the two sides' inputs differ by rounding alone: there
    every unit routed differently must be within ``MOE_TIE`` of a tie, and
    a unit of an expert no differing unit touched must be dropped alike
    (a differing unit moves the slots of both its experts' later units).
    From the first differing layer on, the counts are printed only.
    Returns one line of counts a layer."""
    lines, clean = [], True
    for layer, (g, r) in enumerate(zip(got, ref)):
        top = r['top'].float()
        gaps = top[:, :-1] - top[:, 1:]                 # (N, k) at least
        margin = gaps[:, :k].clone()
        margin[:, 1:] = torch.minimum(margin[:, 1:], gaps[:, :k - 1])
        margin = margin.reshape(-1)
        differ = g['expert'] != r['expert']
        near = differ & (margin < MOE_TIE)
        touched = torch.cat([g['expert'][differ], r['expert'][differ]])
        alike = ~(torch.isin(g['expert'], touched)
                  | torch.isin(r['expert'], touched))
        drop_diff = (g['kept'] != r['kept']) & alike
        n_diff, n_near = int(differ.sum()), int(near.sum())
        if clean:
            check(n_diff == n_near and int(drop_diff.sum()) == 0,
                  '%s layer %d: %d units routed differently, %d of them '
                  'near a tie (< %g); %d drops differ among untouched '
                  'experts' % (tag, layer, n_diff, n_near, MOE_TIE,
                               int(drop_diff.sum())))
        lines.append('layer %d: dropped %d mesh / %d one process, %d units '
                     'routed differently (%d within %g of a tie)%s'
                     % (layer, int((~g['kept']).sum()),
                        int((~r['kept']).sum()), n_diff, n_near, MOE_TIE,
                        '' if clean else ' [after a differing layer]'))
        clean = clean and n_diff == 0
    return lines


def moe_route_f32(torch, tlm, cfg, mesh, params, tokens):
    """(b)'s exact gate on a float32 copy of layer 0: the rank's tokens'
    embeddings, normed by ``ln2``, through the mesh's ``_moe_ffn`` (which
    gathers them over data and routes the global stream) against one
    process's ``_moe_ffn`` on the gathered batch (global rank 0): every
    unit's expert, slot and drop equal."""
    import dataclasses

    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.mesh import all_gather
    from petastorm_tpu_torch.weights import gather_params
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    full = gather_params(params, cfg, mesh)
    block = {k: v.detach().float() for k, v in params['layers'][0].items()}
    with torch.no_grad():
        h = tlm._rms_norm(full['embed'][tokens.long()], block['ln2'])
        mine = {'routes': []}
        tlm._moe_ffn(h, block, c32, stats=mine, mesh=mesh)
        whole = torch.cat(all_gather(h, mesh.get_group('data')), 0)
    if dist.get_rank() != 0:
        return None
    with torch.no_grad():
        one = {'routes': []}
        tlm._moe_ffn(whole, full['layers'][0], c32, stats=one)
    got, ref = mine['routes'][0], one['routes'][0]
    same = all(torch.equal(got[key], ref[key])
               for key in ('expert', 'slot', 'kept'))
    check(same, '(b) float32 layer 0: the mesh routes %d units to other '
          'experts, %d to other slots, %d dropped otherwise than one '
          'process on the global batch'
          % tuple(int((got[key] != ref[key]).sum())
                  for key in ('expert', 'slot', 'kept')))
    return {'units': int(ref['expert'].numel()),
            'dropped': int((~ref['kept']).sum())}


def sharded_lm(torch, np, tlm, kernels, mesh, cfg, spec, tag):
    """(a) or (b) on one rank: the LM on ``mesh``, fed by the sharded
    indexed NGram loader, ``spec['steps']`` AdamW steps; global rank 0
    then replays them in one process on the gathered global batches."""
    import torch.distributed as dist

    from petastorm_tpu_torch import make_indexed_ngram_loader
    from petastorm_tpu_torch.parallel.mesh import (TRANSPORT_STATS,
                                                   all_gather, axes_group,
                                                   axis_size,
                                                   reset_transport_stats)
    from petastorm_tpu_torch.weights import gather_params, shard_params
    device, seed = mesh.device_type, spec['seed']
    cuda = device == 'cuda'
    init = tlm.init(cfg, torch.Generator().manual_seed(seed), device=device)
    start = [p.clone() for p in tlm.parameters(init)]
    params = shard_params(init, cfg, mesh)
    del init
    _, step = tlm.make_train_step(cfg, params, mesh)
    leaves = tlm.parameters(params)
    # the data group's float32 sum of every gradient block and the loss
    grad_bytes = 4 * (sum(p.numel() for p in leaves) + 1)
    loader = make_indexed_ngram_loader(spec['url'], resume_ngram(),
                                       batch_size=spec['batch'],
                                       num_epochs=1, seed=seed, mesh=mesh,
                                       workers_count=2)
    seen = set()             # (q rows, heads, kv heads) K1 was launched on
    launch = kernels.flash_fwd

    def watched(q, k, v, **kw):
        seen.add((q.shape[0], kw['n_heads'], kw['n_kv_heads']))
        return launch(q, k, v, **kw)

    local, losses, times, transport, moved, dropped = [], [], [], [], [], []
    grads1 = params1 = routes1 = None
    if cuda:
        torch.cuda.synchronize()
    kernels.flash_fwd = watched
    kernels.reset_launch_counts()
    it = iter(loader)
    try:
        for s in range(spec['steps']):
            batch_s = next(it)
            tokens = batch_s[0]['tokens']
            targets = torch.cat([tokens[:, 1:], batch_s[1]['tokens'][:, :1]],
                                1)
            local.append((tokens, targets))
            stats = None
            if cfg.n_experts:
                stats = {'routes': []} if s == 0 else {}
            reset_transport_stats()
            t0 = time.perf_counter()
            loss = float(step(tokens, targets, moe_stats=stats))
            times.append(time.perf_counter() - t0)
            transport.append(sum(v['seconds']
                                 for v in TRANSPORT_STATS.values()))
            moved.append(sum(v['bytes'] for v in TRANSPORT_STATS.values()))
            losses.append(loss)
            if stats is not None:
                dropped.append(int(stats['dropped']))
            if s == 0:
                grads1 = tlm.parameters(gather_params(_grad_tree(params), cfg,
                                                      mesh))
                params1 = _par_leaves(tlm, gather_params(params, cfg, mesh))
                if stats is not None:
                    routes1 = stats['routes']
    finally:
        kernels.flash_fwd = launch
    launches = dict(kernels.LAUNCHES)
    it.close()
    loader.close()
    with torch.no_grad():
        block = tuple(tlm.forward(params, local[0][0], cfg,
                                  mesh=mesh).shape)
    exact = (moe_route_f32(torch, tlm, cfg, mesh, params, local[0][0])
             if cfg.n_experts else None)
    # the ranks of a data group (model or expert) staged equal batches
    same = axes_group(mesh, ('model', 'expert'))
    if same is not None:
        for tokens, _ in local:
            parts = all_gather(tokens, same)
            check(all(torch.equal(p, parts[0]) for p in parts),
                  '%s the ranks of a data group staged different batches'
                  % tag)
    data_group = mesh.get_group('data')
    global_batches = [tuple(torch.cat(all_gather(x, data_group), 0)
                            for x in pair) for pair in local]
    out = {'losses': losses, 'times': times, 'transport': transport,
           'moved': moved, 'grad_bytes': grad_bytes, 'launches': launches,
           'heads': sorted(seen), 'block': block, 'dropped': dropped,
           'exact': exact, 'finite': all(math.isfinite(x) for x in losses),
           'route_bytes': (cfg.n_layers * local[0][0].numel() * cfg.d_model
                           * torch.finfo(cfg.dtype).bits // 8
                           if cfg.n_experts else 0)}
    del params, step, leaves
    if cuda:
        torch.cuda.empty_cache()
        dist.barrier()
    if dist.get_rank() != 0:
        return out
    ref_loader = make_indexed_ngram_loader(spec['url'], resume_ngram(),
                                           batch_size=spec['batch'],
                                           num_epochs=1, seed=seed,
                                           workers_count=2)
    ref_it = iter(ref_loader)
    for s, (tokens, targets) in enumerate(global_batches):
        want = next(ref_it)
        check(np.array_equal(tokens.cpu().numpy(), want[0]['tokens']),
              "%s step %d: the data groups' batches are not the unsharded "
              "loader's global batch" % (tag, s))
    ref_it.close()
    ref_loader.close()
    ref = tlm.init(cfg, torch.Generator().manual_seed(seed), device=device)
    for p, p0 in zip(tlm.parameters(ref), start):
        p.data.copy_(p0)
    _, ref_step = tlm.make_train_step(cfg, ref)
    ref_leaves = tlm.parameters(ref)
    diffs, routes = [], []
    for s, (tokens, targets) in enumerate(global_batches):
        stats = {'routes': []} if cfg.n_experts and s == 0 else None
        want = float(ref_step(tokens, targets, moe_stats=stats))
        diffs.append(abs(losses[s] - want) / abs(want))
        check(diffs[-1] <= PAR_LOSS_RTOL,
              '%s step %d: loss %.6f on the mesh, %.6f in one process'
              % (tag, s, losses[s], want))
        if s == 0:
            names = ['embed', 'final_norm', 'unembed'] + [
                'layers.%d.%s' % (i, n) for i, layer in enumerate(ref['layers'])
                for n in sorted(layer)]
            rels = sorted(((float((g - p.grad).norm()
                                  / (p.grad.norm() + 1e-12)), n)
                           for g, p, n in zip(grads1, ref_leaves, names)),
                          reverse=True)
            grad_rel, worst = rels[0][0], rels[:3]
            check(grad_rel <= PAR_GRAD_RTOL,
                  '%s step 1 gradient relative error %.3g' % (tag, grad_rel))
            top, share = adamw_gate(torch, tag, params1, ref_leaves, grads1)
            if stats is not None:
                routes = route_gates(torch, routes1, stats['routes'],
                                     cfg.moe_top_k, tag)
    out.update(loss_rtol=max(diffs), grad_rel=grad_rel, param_max=top,
               param_share=share, route_lines=routes, worst_leaves=worst,
               tp=axis_size(mesh, 'model'))
    return out


def pipeline_lm(torch, tlm, kernels, mesh, cfg, seed):
    """(c) on one rank: ``make_pipeline_fn`` over ``mesh``'s pipe axis with
    a stage of ``PP_LAYERS`` flagship layers (attention on ``cfg``'s
    kernel path, then the FFN), ``PP_MICRO`` microbatches of ``PP_ROWS``
    rows a data rank; the ranks of data coordinate 0 hold their stage's
    gradients and their outputs against one process running the stages in
    order on every microbatch."""
    import dataclasses

    import torch.distributed as dist

    from petastorm_tpu_torch.parallel import mesh as pmesh
    from petastorm_tpu_torch.parallel.pipeline import make_pipeline_fn
    device = mesh.device_type
    cuda = device == 'cuda'
    n_stages = pmesh.axis_size(mesh, 'pipe')
    stage, data_i = (pmesh.axis_index(mesh, a) for a in ('pipe', 'data'))
    deep = dataclasses.replace(cfg, n_layers=n_stages * PP_LAYERS)
    full = tlm.init(deep, torch.Generator().manual_seed(seed), device=device)
    names = sorted(full['layers'][0])
    stacked = {'layers': [
        {n: torch.stack([full['layers'][s * PP_LAYERS + i][n]
                         for s in range(n_stages)]) for n in names}
        for i in range(PP_LAYERS)]}
    mine = {'layers': [{n: v[stage:stage + 1].clone().requires_grad_(True)
                        for n, v in layer.items()}
                       for layer in stacked['layers']]}
    positions = torch.arange(cfg.max_seq_len, device=device)

    def stage_fn(p, x):
        for layer in p['layers']:
            x = x + tlm._attention(tlm._rms_norm(x, layer['ln1']), layer,
                                   cfg, positions)
            x = x + tlm._dense_ffn(tlm._rms_norm(x, layer['ln2']), layer)
        return x

    gen = torch.Generator(device=device).manual_seed(seed + 25)
    n_data = pmesh.axis_size(mesh, 'data')
    xg = torch.randn(PP_MICRO, n_data * PP_ROWS, cfg.max_seq_len,
                     cfg.d_model, generator=gen, device=device).to(cfg.dtype)
    x = xg[:, data_i * PP_ROWS:(data_i + 1) * PP_ROWS].contiguous()
    fn = make_pipeline_fn(stage_fn, mesh, batch_axis='data')
    leaves = [v for layer in mine['layers'] for _, v in sorted(layer.items())]
    data_group = pmesh.axes_group(mesh, 'data')
    shifts = []
    original = pmesh.ring_shift

    def counted(tensors, group=None, shift=1):
        shifts.append(shift)
        return original(tensors, group, shift)

    pmesh.ring_shift = counted
    times, moved = [], []
    kernels.reset_launch_counts()
    try:
        for _ in range(PP_ITERS):
            for p in leaves:
                p.grad = None
            shifts.clear()
            pmesh.reset_transport_stats()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(mine, x)
            loss = (out.float() ** 2).sum() / xg.numel()
            loss.backward()
            grads = [p.grad for p in leaves]
            if data_group is not None:
                pmesh.all_reduce_sum_(grads, data_group)
            if cuda:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            moved.append(sum(v['bytes']
                             for v in pmesh.TRANSPORT_STATS.values()))
    finally:
        pmesh.ring_shift = original
    launches = dict(kernels.LAUNCHES)
    result = {'times': times, 'moved': moved, 'launches': launches,
              'forward_shifts': shifts.count(1),
              'backward_shifts': shifts.count(-1), 'stage': stage,
              'data': data_i, 'steps': PP_MICRO + n_stages - 1}
    if data_i != 0:
        return result
    # one process: the stages in order on each data rank's microbatches
    ref = [{n: v.detach().clone().requires_grad_(True)
            for n, v in full['layers'][i].items()}
           for i in range(n_stages * PP_LAYERS)]
    outs = []
    for m in range(PP_MICRO):
        for j in range(n_data):
            y = xg[m, j * PP_ROWS:(j + 1) * PP_ROWS]
            for s in range(n_stages):
                y = stage_fn({'layers': ref[s * PP_LAYERS:
                                            (s + 1) * PP_LAYERS]}, y)
            ((y.float() ** 2).sum() / xg.numel()).backward()
            if j == 0:
                outs.append(y.detach())
    want = torch.stack(outs)
    out_err = float((out.detach().float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(out_err <= PP_OUT_TOL * scale,
          '(c) stage %d: outputs differ from the stages in order by %.3g '
          '(limit %g x max |ref| %.3g)' % (stage, out_err, PP_OUT_TOL,
                                           scale))
    mine_ref = [v.grad for layer in ref[stage * PP_LAYERS:
                                        (stage + 1) * PP_LAYERS]
                for _, v in sorted(layer.items())]
    grad_rel = max(float((g[0] - r).norm() / (r.norm() + 1e-12))
                   for g, r in zip(grads, mine_ref))
    check(grad_rel <= PP_GRAD_RTOL,
          '(c) stage %d: gradient relative error %.3g (limit %g)'
          % (stage, grad_rel, PP_GRAD_RTOL))
    result.update(out_err=out_err, out_scale=scale, grad_rel=grad_rel)
    return result


def tp_ep_pp_ranks(spec):
    """The body of phase 25 (a), (b) and (c) on each of 4 ranks."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.ops import kernels
    from petastorm_tpu_torch.parallel import make_mesh
    device = spec['device']
    if device == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key, axes, cfg, tag in (('tp', TP_MESH, spec['cfg'], '(a)'),
                                ('ep', EP_MESH, spec['moe_cfg'], '(b)')):
        started = time.perf_counter()
        out[key] = sharded_lm(torch, np, tlm, kernels,
                              make_mesh(axes, device), cfg, spec, tag)
        out[key]['seconds'] = time.perf_counter() - started
        if device == 'cuda':
            torch.cuda.empty_cache()
    started = time.perf_counter()
    out['pp'] = pipeline_lm(torch, tlm, kernels, make_mesh(PP_MESH, device),
                            spec['cfg'], spec['seed'])
    out['pp']['seconds'] = time.perf_counter() - started
    return out


def dryrun_line(torch, tlm, kernels, device):
    """(d): ``dryrun_multichip(8)`` on ``device``, its three lines, each
    loss against one process's unsharded step of the same config from the
    same parameters (the LM's attention blockwise there; the pipeline's
    two stages in order). Returns the ranks' launches."""
    from petastorm_tpu_torch.parallel import dryrun
    started = time.perf_counter()
    result = dryrun.dryrun_multichip(8, device_type=device,
                                     log=lambda s: log('parallel (d) ' + s),
                                     timeout_s=TP_TIMEOUT_S)
    seconds = time.perf_counter() - started
    errs = []
    for label, axes, loss in result['runs']:
        if label == 'dryrun_pipeline':
            stacked, x, target = dryrun.pipeline_arrays(8)
            w, b = (torch.from_numpy(stacked[k]).to(device) for k in 'wb')
            y = torch.from_numpy(x).to(device)
            for s in range(2):
                y = torch.tanh(y @ w[s] + b[s])
            want = float(((y - torch.from_numpy(target).to(device)) ** 2)
                         .mean())
        else:
            kw = dryrun.lm_config(axes)
            kw['attention'] = 'blockwise'
            cfg = tlm.TransformerConfig(dtype=torch.float32, **kw)
            params = tlm.init(cfg, torch.Generator().manual_seed(0),
                              device=device)
            _, step = tlm.make_train_step(cfg, params)
            tokens, targets = (torch.from_numpy(a).to(device)
                               for a in dryrun.lm_batch(axes))
            want = float(step(tokens, targets))
        err = abs(loss - want) / max(1.0, abs(want))
        errs.append(err)
        check(err <= DRY_TOL, '(d) %s: loss %.6f on %s, %.6f in one process'
              % (label, loss, axes, want))
    log('parallel (d) dryrun_multichip(8) on %s: %d lines, losses vs one '
        'process max rel %.3g (limit %g); launches %s (float32 K1-K3 at head '
        'dim 16 in the ring); %.1f s'
        % (device, len(result['runs']), max(errs), DRY_TOL,
           json.dumps(result['launches']), seconds))
    return result['launches']


def tp_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
            moe_cfg=None, rows=ROWS, steps=TP_STEPS, batch=PAR_BATCH,
            dry=True):
    """Phase 25: tensor, expert and pipeline parallelism, every rank a
    process on the one card over gloo (``gloo-host`` for CUDA tensors).
    (a) + (b) + (c) on 4 ranks, (d) on 8. Returns the phase's launch
    counts (K1-K3), summed over the ranks."""
    import dataclasses

    from petastorm_tpu_torch.parallel import launch_ranks
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    moe_cfg = moe_cfg or dataclasses.replace(cfg, n_kv_heads=2, n_experts=8,
                                             moe_top_k=2)
    total = {name: 0 for name in FLASH}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        url = 'file://' + os.path.join(d, 'tokens')
        write_store(np, url, cfg.max_seq_len, cfg.vocab_size, rows,
                    args.seed)
        spec = dict(device=device, seed=args.seed, cfg=cfg, moe_cfg=moe_cfg,
                    url=url, batch=batch, steps=steps)
        if device == 'cuda':
            free_card(torch, 'parallel 3b (a) + (b) + (c) before the spawn')
        start = time.perf_counter()
        ranks = launch_ranks('chip_smoke:tp_ep_pp_ranks', 4,
                             os.path.join(d, 'abc'), args=(spec,),
                             timeout_s=TP_TIMEOUT_S)
        log('parallel 3b (a) + (b) + (c) on 4 ranks %.1f s (spawn, CUDA init '
            'and the runs)' % (time.perf_counter() - start))
        for key, axes, tag, c in (('tp', TP_MESH, '(a)', cfg),
                                  ('ep', EP_MESH, '(b)', moe_cfg)):
            lm = [r[key] for r in ranks]
            check(all(r['finite'] for r in lm), '%s a non-finite loss' % tag)
            check(all(r['losses'] == lm[0]['losses'] for r in lm),
                  '%s the ranks report different losses' % tag)
            for name in FLASH:
                total[name] += sum(r['launches'][name] for r in lm)
                check(all(r['launches'][name] > 0 for r in lm)
                      or device != 'cuda',
                      '%s %s not launched on every rank' % (tag, name))
            tp = axes.get('model', 1)
            heads = {(h, hkv) for r in lm for _, h, hkv in r['heads']}
            check(device != 'cuda'
                  or heads == {(c.n_heads // tp, c.kv_heads // tp)},
                  '%s K1 saw (heads, kv heads) %r, not the rank\'s %d of %d'
                  % (tag, sorted(heads), c.n_heads // tp, c.n_heads))
            want_block = (batch // axes['data'], c.max_seq_len,
                          c.vocab_size // tp)
            check(all(r['block'] == want_block for r in lm),
                  '%s logits blocks %r, not %r' % (tag, lm[0]['block'],
                                                   want_block))
            head = lm[0]
            steady = [sum(r['times'][1:] or r['times']) for r in lm]
            share = [sum(r['transport'][1:] or r['transport']) / t
                     for r, t in zip(lm, steady)]
            act = statistics.median(head['moved']) - head['grad_bytes']
            log('parallel 3b %s LM on %s (%s, %d steps, global batch %d): '
                'losses %s; vs one process max rel %.3g (limit %g), step-1 '
                'gradient max rel %.3g (limit %g), step-1 params max |diff| '
                '%.3g (limit 2 lr), %.3g of them > lr/2 apart, each where '
                'the gradients can flip its sign; logits block %s a rank; K1 '
                'on %s (heads, kv heads) a rank; steady step ms per rank %s, '
                'gloo-host transport share %s; bytes a step a rank %d: '
                'activation collectives %d, gradient sums %d; %.1f s'
                % (tag, json.dumps(axes), str(c.dtype).split('.')[-1], steps,
                   batch, ['%.4f' % x for x in head['losses']],
                   head['loss_rtol'], PAR_LOSS_RTOL, head['grad_rel'],
                   PAR_GRAD_RTOL, head['param_max'], head['param_share'],
                   head['block'], sorted({(h, k) for _, h, k in
                                          head['heads']}),
                   '/'.join('%.1f' % (1e3 * statistics.median(
                       r['times'][1:] or r['times'])) for r in lm),
                   '/'.join('%.2f' % x for x in share),
                   statistics.median(head['moved']), act, head['grad_bytes'],
                   head['seconds']))
            log('parallel 3b %s step-1 gradient, leaves furthest from one '
                "process's (relative norm): %s"
                % (tag, ', '.join('%s %.3g' % (n, r)
                                  for r, n in head['worst_leaves'])))
            if c.n_experts:
                log('parallel 3b (b) float32 layer 0 routing == one process '
                    'on the global batch: %d units, %d dropped, every '
                    "unit's expert, slot and drop equal; units dropped a "
                    'step %s; bytes gathered for routing a step a rank %d'
                    % (head['exact']['units'], head['exact']['dropped'],
                       head['dropped'], head['route_bytes']))
                for line in head['route_lines']:
                    log('parallel 3b (b) bf16 step 1 routing ' + line)
        pp = [r['pp'] for r in ranks]
        for r in pp:
            check(r['forward_shifts'] == r['steps']
                  and r['backward_shifts'] == r['steps'] - 1,
                  '(c) %d sends forward and %d back, not %d and %d'
                  % (r['forward_shifts'], r['backward_shifts'], r['steps'],
                     r['steps'] - 1))
            for name in FLASH:
                total[name] += r['launches'][name]
                check(r['launches'][name] > 0 or device != 'cuda',
                      '(c) %s not launched on stage %d' % (name, r['stage']))
        checked = [r for r in pp if r['data'] == 0]
        n_stages = PP_MESH['pipe']
        log('parallel 3b (c) pipeline on %s: %d microbatches of %d rows a '
            'data rank through %d stages of %d flagship layers, %d steps '
            '(bubble share %.3f); step ms per rank %s; bytes sent a step a '
            'rank %d; outputs max |diff| vs the stages in order %s (limit '
            '%g x max |ref|), stage gradients max rel %s (limit %g); %.1f s'
            % (json.dumps(PP_MESH), PP_MICRO, PP_ROWS, n_stages, PP_LAYERS,
               pp[0]['steps'], (n_stages - 1) / pp[0]['steps'],
               '/'.join('%.1f' % (1e3 * r['times'][-1]) for r in pp),
               pp[0]['moved'][-1],
               '/'.join('%.3g' % r['out_err'] for r in checked), PP_OUT_TOL,
               '/'.join('%.3g' % r['grad_rel'] for r in checked),
               PP_GRAD_RTOL, pp[0]['seconds']))
    if dry:
        if device == 'cuda':
            free_card(torch, 'parallel 3b (d) before the spawn')
        launched = dryrun_line(torch, tlm, kernels, device)
        for name in FLASH:
            check(launched[name] > 0 or device != 'cuda',
                  '(d) float32 %s at head dim 16 not launched' % name)
            total[name] += launched[name]
    log('parallel 3b phase launches %s' % json.dumps(total))
    return total



# ---------------------------------------------------------------------------
# phase 26: the adapter line (pytorch.DataLoader / BatchedDataLoader, the
# converter, the console tools, a user codec)
# ---------------------------------------------------------------------------

ADAPTER_ROWS = 256                # token rows x 2,049 int32 (NdarrayCodec)
ADAPTER_GROUP_MB = 0.25           # ~30 rows a row group: 4 workers share it
ADAPTER_WORKERS = 4
ADAPTER_BATCH = 8
ADAPTER_SHUFFLE = 64
ADAPTER_STEPS = 8                 # LM AdamW steps (the first warms up)
ADAPTER_IMAGE_GROUP_MB = 1        # ~7 png images of 224 x 224 a row group
ADAPTER_IMAGE_STEPS = 3
ADAPTER_MNIST_SHUFFLE = 4096
ADAPTER_MNIST_EPOCHS = 2
ADAPTER_TABLE_ROWS = 10000        # the converter's DataFrame
ADAPTER_FEATURES = 16
ADAPTER_COPY_ROWS_PER_FILE = 64
ADAPTER_LOSS_RTOL = 1e-2          # flash vs blockwise, bf16, step 1


def reversed_bytes_codec():
    """A codec neither package ships: a cell is the array's C-order bytes,
    reversed (what a user's :class:`DataframeColumnCodec` subclass looks
    like)."""
    import numpy as np
    import pyarrow as pa

    from petastorm_tpu_torch.codecs import DataframeColumnCodec

    class ReversedBytesCodec(DataframeColumnCodec):
        codec_name = 'chip_smoke_reversed_bytes'

        def encode(self, unischema_field, value):
            return np.ascontiguousarray(value).tobytes()[::-1]

        def decode(self, unischema_field, value):
            return np.frombuffer(bytes(value)[::-1],
                                 dtype=unischema_field.numpy_dtype).reshape(
                                     unischema_field.shape).copy()

        def arrow_type(self, unischema_field):
            return pa.binary()

    return ReversedBytesCodec


def adapter_token_pass(torch, np, url, tokens, device, seed, label,
                       step=None, steps=0, gate=None):
    """One epoch of ``make_reader(workers_count=4)`` ->
    ``pytorch.DataLoader(batch 8, shuffling 64, seed)`` on ``device``:
    every batch's ``tokens`` an int32 ``(8, seq + 1)`` tensor on the
    device, each row the tokens written for its ``idx``, every ``idx``
    once. ``step(inputs, targets)`` trains on the first ``steps`` batches;
    ``gate(inputs, targets, loss)`` runs on the first. Returns the losses,
    the step times and the batch waits (s)."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.pytorch import DataLoader
    rows, width = tokens.shape
    seen, losses, times, waits, held = [], [], [], [], []
    with make_reader(url, num_epochs=1, workers_count=ADAPTER_WORKERS,
                     seed=seed) as reader:
        loader = DataLoader(reader, batch_size=ADAPTER_BATCH,
                            shuffling_queue_capacity=ADAPTER_SHUFFLE,
                            seed=seed, device=device)
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter()
            tok = batch['tokens']
            check(tok.device.type == device and tok.dtype == torch.int32
                  and tuple(tok.shape) == (ADAPTER_BATCH, width),
                  '%s: tokens %s %s on %s' % (label, tok.dtype,
                                              tuple(tok.shape), tok.device))
            if len(losses) < steps:
                inputs, targets = tok[:, :-1], tok[:, 1:]
                loss = float(step(inputs, targets))
                times.append(time.perf_counter() - t1)
                waits.append(t1 - t0)
                if gate is not None and len(losses) == 0:
                    gate(inputs, targets, loss)
                losses.append(loss)
            held.append((batch['idx'].cpu().numpy(), tok.cpu().numpy()))
    for idx, tok in held:
        seen.extend(idx.tolist())
        check(np.array_equal(tok, tokens[idx]),
              '%s: a batch is not the tokens written for its idx' % label)
    check(sorted(seen) == list(range(rows)),
          '%s: the pass delivered %d idx (%d unique) of %d'
          % (label, len(seen), len(set(seen)), rows))
    check(all(math.isfinite(x) for x in losses), '%s: non-finite loss'
          % label)
    log('%s: %d batches, all %d idx once, each == the tokens written; '
        '%d steps%s' % (label, len(held), rows, len(losses),
                        (', losses ' + ' '.join('%.4f' % x for x in losses))
                        if losses else ''))
    return losses, times, waits


def adapter_lm(torch, np, tlm, kernels, args, d, device, cfg, rows):
    """(a) The flagship LM trained on ``pytorch.DataLoader`` batches; the
    same-seed order on the dummy pool; returns the launches, the store's
    url and its tokens."""
    import dataclasses

    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.pytorch import DataLoader
    url = 'file://' + os.path.join(d, 'tokens')
    start = time.perf_counter()
    tokens = write_token_rows(np, url, rows, cfg.max_seq_len + 1,
                              cfg.vocab_size, args.seed,
                              group_mb=ADAPTER_GROUP_MB)
    log('adapter (a) store %d rows x %d int32 tokens (NdarrayCodec) in %d '
        'row groups, written in %.2f s'
        % (rows, cfg.max_seq_len + 1, row_groups(os.path.join(d, 'tokens')),
           time.perf_counter() - start))
    params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                      device=device)
    _, step = tlm.make_train_step(cfg, params)
    plain = dataclasses.replace(cfg, attention='blockwise')

    def gate(inputs, targets, flash_loss):
        # both losses are of the parameters before step 1's update
        ref = float(saved['plain'])
        rel = abs(flash_loss - ref) / abs(ref)
        check(rel < ADAPTER_LOSS_RTOL,
              'adapter (a): step 1 loss with K1-K3 %.6f, blockwise %.6f '
              '(rel %.3g)' % (flash_loss, ref, rel))
        log('adapter (a) step 1 loss with K1-K3 %.6f, plain blockwise %.6f '
            'on the same batch and parameters: rel %.3g (limit %g)'
            % (flash_loss, ref, rel, ADAPTER_LOSS_RTOL))

    saved = {}

    def first_step(inputs, targets):
        if not saved:
            with torch.no_grad():
                saved['plain'] = tlm.loss_fn(params, inputs, targets, plain)
        return step(inputs, targets)

    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, times, waits = adapter_token_pass(
        torch, np, url, tokens, device, args.seed, 'adapter (a) LM',
        step=first_step, steps=ADAPTER_STEPS, gate=gate)
    launches = {k: kernels.LAUNCHES[k] for k in FLASH}
    want = ADAPTER_STEPS * cfg.n_layers if device == 'cuda' else 0
    check(all(launches[k] == want for k in FLASH),
          'adapter (a): launches %r, reckoned %d each (%d steps x %d '
          'layers; the blockwise gate launches none)'
          % (launches, want, ADAPTER_STEPS, cfg.n_layers))
    steady = times[1:] or times
    log('adapter (a) LM %d steps from pytorch.DataLoader, loss %.4f -> %.4f,'
        ' median steady step %.2f ms, median batch wait %.2f ms, launches %s'
        % (len(losses), losses[0], losses[-1],
           statistics.median(steady) * 1e3,
           statistics.median(waits[1:] or waits) * 1e3,
           json.dumps(launches)))
    orders = []
    for _ in range(2):
        with make_reader(url, reader_pool_type='dummy', num_epochs=1,
                         seed=args.seed) as reader:
            orders.append([int(i) for b in DataLoader(
                reader, batch_size=ADAPTER_BATCH,
                shuffling_queue_capacity=ADAPTER_SHUFFLE, seed=args.seed,
                device=device) for i in b['idx'].tolist()])
    check(orders[0] == orders[1] and sorted(orders[0]) == list(range(rows))
          and orders[0] != sorted(orders[0]),
          'adapter (a): two same-seed DataLoaders on the dummy pool differ')
    log('adapter (a) two DataLoaders on the dummy pool, seed %d: the same '
        'shuffled order of all %d idx' % (args.seed, rows))
    return launches, url, tokens


def write_square_images(np, url, rows, seed, size):
    """The image line's png rows resized to ``size`` x ``size``, with an
    ``idx`` field."""
    import cv2

    from petastorm_tpu_torch import materialize_dataset
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.examples.imagenet.generate_imagenet import \
        synthetic_rows
    from petastorm_tpu_torch.examples.imagenet.schema import \
        make_imagenet_schema
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('ImagenetIdx', list(
        make_imagenet_schema('png').fields.values()) + [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False)])
    with materialize_dataset(url, schema,
                             row_group_size_mb=ADAPTER_IMAGE_GROUP_MB) as w:
        w.write_rows(dict(row, idx=np.int64(i), image=cv2.resize(
            row['image'], (size, size), interpolation=cv2.INTER_AREA))
            for i, row in enumerate(synthetic_rows(
                rows, classes=IMAGE_CLASSES, seed=seed,
                base_hw=(size, size))))


def adapter_images(torch, np, kernels, args, d, device, rows, batch, size):
    """(b) The image CNN (K4 first) on ``pytorch.DataLoader`` batches of a
    png store read on 8 worker threads; each image == cv2's decode of the
    cell pyarrow reads for its ``idx``. Returns the launches."""
    import cv2
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.models import image_cnn as cnn
    from petastorm_tpu_torch.pytorch import DataLoader
    path = os.path.join(d, 'images')
    start = time.perf_counter()
    write_square_images(np, 'file://' + path, rows, args.seed, size)
    log('adapter (b) store %d png images %d x %d in %d row groups, written '
        'in %.2f s' % (rows, size, size, row_groups(path),
                       time.perf_counter() - start))
    params = cnn.init(torch.Generator().manual_seed(args.seed),
                      num_classes=IMAGE_CLASSES, device=device)
    step = cnn.make_train_step(params, lr=1e-3)
    losses, held, times = [], [], []
    if device == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with make_reader('file://' + path, num_epochs=1,
                     workers_count=IMAGE_WORKERS, seed=args.seed,
                     schema_fields=['idx', 'image', 'label']) as reader:
        with DataLoader(reader, batch_size=batch, device=device) as loader:
            it = iter(loader)
            for _ in range(ADAPTER_IMAGE_STEPS):
                t0 = time.perf_counter()
                b = next(it)
                images = b['image']
                check(images.device.type == device
                      and images.dtype == torch.uint8
                      and tuple(images.shape) == (batch, size, size, 3),
                      'adapter (b): images %s %s on %s' % (
                          images.dtype, tuple(images.shape), images.device))
                losses.append(float(step(images, b['label'])))
                times.append(time.perf_counter() - t0)
                held.append((b['idx'].cpu().numpy(), images.cpu().numpy()))
            it.close()
    launches = dict(kernels.LAUNCHES)
    want = ADAPTER_IMAGE_STEPS if device == 'cuda' else 0
    check(launches['normalize'] == want,
          'adapter (b): K4 launched %d times in %d steps'
          % (launches['normalize'], ADAPTER_IMAGE_STEPS))
    table = pq.read_table(path, columns=['idx', 'image'])
    cells = dict(zip(table.column('idx').to_pylist(),
                     table.column('image').to_pylist()))
    for idx, images in held:
        for i, img in zip(idx.tolist(), images):
            ref = cv2.cvtColor(cv2.imdecode(np.frombuffer(cells[i], np.uint8),
                                            cv2.IMREAD_UNCHANGED),
                               cv2.COLOR_BGR2RGB)
            check(np.array_equal(img, ref),
                  'adapter (b): image %d != cv2 decode of its cell' % i)
    check(all(math.isfinite(x) for x in losses), 'adapter (b): non-finite '
          'loss')
    log('adapter (b) CNN %d steps from pytorch.DataLoader (png, %d worker '
        'threads, batch %d): images == cv2.imdecode of the pyarrow cells '
        '(%d images), losses %s, step with batch wait %s ms, K4 launches %d'
        % (len(losses), IMAGE_WORKERS, batch, sum(len(i) for i, _ in held),
           ' '.join('%.4f' % x for x in losses),
           ' '.join('%.1f' % (t * 1e3) for t in times),
           launches['normalize']))
    return launches


def adapter_batched(torch, np, args, d, device, rows, batch):
    """(c) ``BatchedDataLoader`` with ``inmemory_cache_all`` over the batch
    line's store: epoch 1's idx multiset == the store's, epoch 2 bit-equal
    to epoch 1 and no second reader pass; MLP SGD steps on both."""
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.models import mnist_mlp
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    url = 'file://' + os.path.join(d, 'mnist')
    start = time.perf_counter()
    write_mnist_list_store(np, url, rows, args.seed)
    log('adapter (c) store %d rows (idx, digit, image 28 x 28 uint8 under '
        'ArrowListCodec) written in %.2f s'
        % (rows, time.perf_counter() - start))
    params = mnist_mlp.init(torch.Generator().manual_seed(args.seed),
                            device=device)
    epochs, losses, walls = [], [], []
    with make_batch_reader(url, num_epochs=1, seed=args.seed,
                           workers_count=ADAPTER_WORKERS) as reader:
        resets = []
        real_reset = reader.reset
        reader.reset = lambda: (resets.append(1), real_reset())
        loader = BatchedDataLoader(
            reader, batch_size=batch,
            shuffling_queue_capacity=ADAPTER_MNIST_SHUFFLE, seed=args.seed,
            inmemory_cache_all=True, device=device)
        for _ in range(ADAPTER_MNIST_EPOCHS):
            start = time.perf_counter()
            held = []
            for b in loader:
                images = b['image']
                check(images.device.type == device
                      and images.dtype == torch.uint8
                      and tuple(images.shape[1:]) == (28, 28),
                      'adapter (c): images %s %s on %s' % (
                          images.dtype, tuple(images.shape), images.device))
                x = images.reshape(len(images), -1).float() / 255.0
                losses.append(mnist_mlp.train_step(params, x, b['digit'],
                                                   BATCH_LINE_LR))
                held.append(b)
            losses = [float(x) for x in losses]
            walls.append(time.perf_counter() - start)
            epochs.append(held)
    first, second = epochs
    idx = torch.cat([b['idx'] for b in first]).cpu().numpy()
    check(np.array_equal(np.sort(idx), np.arange(rows)),
          'adapter (c): epoch 1 delivered %d idx (%d unique) of %d'
          % (len(idx), len(np.unique(idx)), rows))
    check(not resets and len(second) == len(first) and all(
        set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
        for a, b in zip(first, second)),
        'adapter (c): epoch 2 is not epoch 1 from memory (%d resets)'
        % len(resets))
    check(all(math.isfinite(x) for x in losses), 'adapter (c): non-finite '
          'loss')
    per = len(first)
    log('adapter (c) BatchedDataLoader (batch %d, shuffling %d, '
        'inmemory_cache_all): epoch 1 %d batches, idx multiset == the '
        'store\'s %d rows, %.2f s; epoch 2 bit-equal from memory, no reader '
        'pass, %.2f s; %d MLP steps, loss %.4f -> %.4f'
        % (batch, ADAPTER_MNIST_SHUFFLE, per, rows, walls[0], walls[1],
           len(losses), statistics.mean(losses[:4]),
           statistics.mean(losses[-4:])))


def adapter_converter(torch, np, args, d, device, rows, batch):
    """(d) ``make_dataset_converter`` over a pandas DataFrame with
    ``precision='float32'``: the torch dataloader's CUDA rows == the
    frame's, the cached handle on a second call, ``make_torch_loader``'s
    rows, ``delete()``."""
    import pandas as pd

    from petastorm_tpu_torch.converter import make_dataset_converter
    rng = np.random.default_rng(args.seed)
    names = ['f%02d' % k for k in range(ADAPTER_FEATURES)]
    features = rng.standard_normal((rows, ADAPTER_FEATURES))
    frame = pd.DataFrame(features, columns=names)
    frame.insert(0, 'digit', rng.integers(0, 10, rows))
    frame.insert(0, 'idx', np.arange(rows, dtype=np.int64))
    want = features.astype(np.float32)
    parent = os.path.join(d, 'converter')
    start = time.perf_counter()
    saved = make_dataset_converter(frame, parent_cache_dir_url=parent,
                                   precision='float32', delete_at_exit=False)
    made = time.perf_counter() - start
    dirs = sorted(os.listdir(parent))
    check(len(dirs) == 1 and len(saved) == rows,
          'adapter (d): %d directories under the parent, %d rows'
          % (len(dirs), len(saved)))

    def rows_of(loader, on):
        seen = []
        with loader:
            for b in loader:
                x = torch.stack([b[n] for n in names], 1)
                check(x.device.type == on and x.dtype == torch.float32,
                      'adapter (d): features %s on %s' % (x.dtype, x.device))
                i = b['idx'].cpu().numpy()
                check(np.array_equal(x.cpu().numpy(), want[i])
                      and np.array_equal(b['digit'].cpu().numpy(),
                                         frame['digit'].to_numpy()[i]),
                      'adapter (d): a batch is not the frame\'s rows')
                seen.extend(i.tolist())
        check(sorted(seen) == list(range(rows)),
              'adapter (d): %d idx of %d' % (len(seen), rows))
        return seen

    rows_of(saved.make_torch_dataloader(batch_size=batch, num_epochs=1,
                                        device=device), device)
    start = time.perf_counter()
    again = make_dataset_converter(frame, parent_cache_dir_url=parent,
                                   precision='float32', delete_at_exit=False)
    hit = time.perf_counter() - start
    check(again is saved and sorted(os.listdir(parent)) == dirs,
          'adapter (d): a second call wrote %s' % sorted(os.listdir(parent)))
    rows_of(saved.make_torch_loader(batch_size=batch, num_epochs=1,
                                    device=device), 'cpu')
    saved.delete()
    check(os.listdir(parent) == [], 'adapter (d): delete() left %s'
          % os.listdir(parent))
    log('adapter (d) converter: %d rows x %d float64 -> float32 '
        'materialised in %.3f s, the cached handle in %.3f s (no new '
        'directory); make_torch_dataloader (%s) and make_torch_loader rows '
        '== the frame\'s; delete() removed it'
        % (rows, ADAPTER_FEATURES, made, hit, device))


def adapter_tools(torch, np, args, d, device, url, tokens):
    """(e) On the host: ``copy_dataset`` of (a)'s store read back through
    (a)'s DataLoader on the device, ``metadata_util``'s row-group count,
    ``generate_metadata`` on a plain Parquet store, and a user codec's
    store on the device."""
    import io

    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_reader, materialize_dataset
    from petastorm_tpu_torch.codecs import ScalarCodec, register_codec
    from petastorm_tpu_torch.etl.dataset_metadata import \
        get_schema_from_dataset_url
    from petastorm_tpu_torch.etl.generate_metadata import generate_metadata
    from petastorm_tpu_torch.etl.metadata_util import main as metadata_main
    from petastorm_tpu_torch.pytorch import DataLoader
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    copy_path = os.path.join(d, 'copy')
    start = time.perf_counter()
    copied = copy_dataset(url, 'file://' + copy_path,
                          field_regex=['idx', 'tokens'],
                          rows_per_file=ADAPTER_COPY_ROWS_PER_FILE)
    files = [n for n in os.listdir(copy_path) if n.endswith('.parquet')]
    check(copied == len(tokens) and len(files) == -(
        -copied // ADAPTER_COPY_ROWS_PER_FILE),
        'adapter (e): copied %d rows into %d files' % (copied, len(files)))
    log('adapter (e) copy_dataset: %d rows into %d files in %.2f s'
        % (copied, len(files), time.perf_counter() - start))
    adapter_token_pass(torch, np, 'file://' + copy_path, tokens, device,
                       args.seed, 'adapter (e) copy read back')

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = metadata_main(['file://' + copy_path, '--schema',
                            '--row-groups'])
    groups = row_groups(copy_path)
    check(rc == 0 and '%d row groups:' % groups in out.getvalue()
          and 'Schema (stored)' in out.getvalue(),
          'adapter (e): metadata_util exit %d, printed %r' % (
              rc, out.getvalue()[:200]))
    log('adapter (e) metadata_util --schema --row-groups: exit 0, %d row '
        'groups == pyarrow\'s' % groups)

    plain = os.path.join(d, 'plain')
    os.makedirs(plain)
    n = 100
    table = pa.table({'id': np.arange(n, dtype=np.int64),
                      'x': np.arange(n, dtype=np.float32) / 4,
                      'name': ['row %d' % i for i in range(n)]})
    pq.write_table(table, os.path.join(plain, 'part_0.parquet'),
                   row_group_size=32)
    generate_metadata('file://' + plain)
    schema = get_schema_from_dataset_url('file://' + plain)
    check(sorted(schema.fields) == ['id', 'name', 'x'],
          'adapter (e): generated schema %r' % schema)
    with make_reader('file://' + plain, reader_pool_type='dummy',
                     num_epochs=1) as reader:
        got = sorted((int(r.id), float(r.x), r.name) for r in reader)
    check(got == sorted(zip(table.column('id').to_pylist(),
                            table.column('x').to_pylist(),
                            table.column('name').to_pylist())),
          'adapter (e): rows after generate_metadata differ')
    log('adapter (e) generate_metadata on a plain pyarrow store: schema %s '
        'from get_schema_from_dataset_url, make_reader reads its %d rows'
        % (sorted(schema.fields), n))

    codec_cls = register_codec(reversed_bytes_codec())
    user = Unischema('UserCodec', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('v', np.float32, (4, 3), codec_cls(), False)])
    rng = np.random.default_rng(args.seed)
    values = rng.standard_normal((48, 4, 3)).astype(np.float32)
    user_url = 'file://' + os.path.join(d, 'user_codec')
    with materialize_dataset(user_url, user, rows_per_file=16) as w:
        w.write_rows({'idx': np.int64(i), 'v': values[i]} for i in range(48))
    check(type(get_schema_from_dataset_url(user_url).v.codec) is codec_cls,
          'adapter (e): the stored schema does not name the user codec')
    seen = 0
    with make_reader(user_url, num_epochs=1, workers_count=2,
                     seed=args.seed) as reader:
        for b in DataLoader(reader, batch_size=16, device=device):
            check(b['v'].device.type == device
                  and b['v'].dtype == torch.float32,
                  'adapter (e): user codec column %s on %s'
                  % (b['v'].dtype, b['v'].device))
            check(np.array_equal(b['v'].cpu().numpy(),
                                 values[b['idx'].cpu().numpy()]),
                  'adapter (e): user codec values differ')
            seen += len(b['idx'])
    check(seen == 48, 'adapter (e): user codec store gave %d rows' % seen)
    log('adapter (e) user codec %r registered with register_codec: a store '
        'of %d rows round-trips to %s exactly'
        % (codec_cls.codec_name, seen, device))


def adapter_line(torch, np, tlm, kernels, args, device='cuda', cfg=None,
                 rows=ADAPTER_ROWS, image_rows=IMAGE_ROWS,
                 image_batch=IMAGE_BATCH, image_size=IMAGE_SIZE,
                 mnist_rows=BATCH_LINE_ROWS, mnist_batch=BATCH_LINE_BATCH,
                 table_rows=ADAPTER_TABLE_ROWS):
    """Phase 26: the PyTorch adapters and the tools. Returns the launches
    of (a) (K1-K3) and (b) (K4)."""
    cfg = cfg or tlm.TransformerConfig(attention='flash')
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        phase = time.perf_counter()
        launches, url, tokens = adapter_lm(torch, np, tlm, kernels, args, d,
                                           device, cfg, rows)
        log('phase 26 (a) LM through pytorch.DataLoader %.1f s'
            % (time.perf_counter() - phase))
        phase = time.perf_counter()
        launches['normalize'] = adapter_images(
            torch, np, kernels, args, d, device, image_rows, image_batch,
            image_size)['normalize']
        log('phase 26 (b) CNN through pytorch.DataLoader %.1f s'
            % (time.perf_counter() - phase))
        phase = time.perf_counter()
        adapter_batched(torch, np, args, d, device, mnist_rows, mnist_batch)
        log('phase 26 (c) BatchedDataLoader %.1f s'
            % (time.perf_counter() - phase))
        phase = time.perf_counter()
        adapter_converter(torch, np, args, d, device, table_rows,
                          mnist_batch)
        log('phase 26 (d) converter %.1f s' % (time.perf_counter() - phase))
        phase = time.perf_counter()
        adapter_tools(torch, np, args, d, device, url, tokens)
        log('phase 26 (e) tools and a user codec %.1f s'
            % (time.perf_counter() - phase))
    return launches


INST_LM_STEPS = 16                # (b): measured LM steps (+3 warm, +26 sync)
INST_LM_BATCH = 8
INST_LM_PREFETCH = 8
INST_DISPATCH_AHEAD = 2
INST_MNIST_STEPS = 8              # (b): mnist and imagenet benches, JAX's
INST_IMAGENET_STEPS = 6           # defaults but for the step counts
INST_CLI_WARMUP = 200             # (c): the command's -m and -n
INST_CLI_MEASURE = 1000
INST_CLI_TIMEOUT_S = 300


def json_after(out, label):
    """The JSON object on the line of ``out`` that starts with ``label``."""
    for line in out.splitlines():
        if line.startswith(label + ': {'):
            return json.loads(line[len(label) + 2:])
    raise RuntimeError('no %r line in the command\'s output:\n%s'
                       % (label, out[-4000:]))


def instruments_line(torch, np, tlm, kernels, args, device='cuda',
                     cfg=None, rows=TOKEN_ROWS, group_mb=None,
                     lm_batch=INST_LM_BATCH, lm_steps=INST_LM_STEPS,
                     mnist=None, imagenet=None,
                     cli_cycles=(INST_CLI_WARMUP, INST_CLI_MEASURE)):
    """Phase 27: the instruments on the token store of phase 13. (a) the
    profiler's device-decode and ingest probes; (b) the north-star LM fed
    by ``prefetch_batches``, then the mnist and imagenet train benches;
    (c) the throughput command as a subprocess; (d) the device-decode and
    goodput benches with their own checks. ``mnist`` and ``imagenet`` are
    keyword overrides of those benches (the CPU rehearsal shrinks them).
    The goodput bench's verdicts are gated; its overhead is printed, not
    gated: its quick protocol compares 2 pairs of passes of a few
    milliseconds, whose rates spread 2x from pass to pass on the card, so
    its 15% gate reads noise (``PERF.md``, the instruments findings).
    Returns the launches of (b) (K4 from the imagenet bench; the LM bench
    keeps JAX's blockwise attention, so no K1-K3)."""
    from petastorm_tpu_torch import make_columnar_reader
    from petastorm_tpu_torch import profiler as tprof
    from petastorm_tpu_torch.benchmark import northstar
    from petastorm_tpu_torch.benchmark.device_decode import \
        run_device_decode_bench
    from petastorm_tpu_torch.benchmark import goodput
    cfg = cfg or tlm.TransformerConfig()
    check(cfg.attention == 'blockwise',
          'the north-star LM keeps TransformerConfig\'s default attention')
    seq = cfg.max_seq_len + 1
    launches = {name: 0 for name in kernels.LAUNCHES}
    saved = os.environ.get(tprof.CALIBRATION_DIR_ENV_VAR)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        os.environ[tprof.CALIBRATION_DIR_ENV_VAR] = os.path.join(d, 'cal')
        try:
            url = 'file://' + os.path.join(d, 'token_rows')
            start = time.perf_counter()
            write_token_rows(np, url, rows, seq, cfg.vocab_size, args.seed,
                             group_mb=group_mb)
            log('phase 27 %s token store %d rows x %d int32 (NdarrayCodec), '
                '%d row groups, written in %.2f s'
                % (CARD, rows, seq,
                   row_groups(os.path.join(d, 'token_rows')),
                   time.perf_counter() - start))

            # (a) the profiler's bytes-through probes
            phase = time.perf_counter()
            with make_columnar_reader(url, workers_count=1,
                                      num_epochs=1) as reader:
                check(set(reader.device_decode_plans) == {'tokens'},
                      'phase 27 (a): the store plans %r'
                      % sorted(reader.device_decode_plans))
                cal = tprof.calibrate(reader.dataset_path, reader.pieces,
                                      reader._view, save=False,
                                      device=device)
            probes, ceilings = cal['probes'], cal['ceilings']
            for name in ('device_decode', 'ingest'):
                probe = probes[name]
                check(probe is not None and probe['rows_per_s'] > 0
                      and ceilings[name] == probe['rows_per_s'],
                      'phase 27 (a): the %s probe is %r' % (name, probe))
                log('phase 27 (a) %s probe %s: %.1f rows/s, %.1f MB/s, '
                    '%.6f s for %d rows (%s)'
                    % (CARD, name, probe['rows_per_s'], probe['mb_per_s'],
                       probe['seconds'], probe['rows'], cal['device']))
            check(probes['device_decode']['path'] == 'device'
                  and probes['device_decode']['columns'] == ['tokens'],
                  'phase 27 (a): device_decode probe %r'
                  % probes['device_decode'])
            stage = probes['device_stage']
            log('phase 27 (a) %s device_stage ceiling %.1f rows/s (%.1f '
                'MB/s); device_decode %.2fx and ingest %.2fx of it'
                % (CARD, ceilings['device_stage'], stage['mb_per_s'],
                   ceilings['device_decode'] / ceilings['device_stage'],
                   ceilings['ingest'] / ceilings['device_stage']))
            log('phase 27 (a) %s %.1f s' % (CARD, time.perf_counter() - phase))

            # (b) the north-star LM through prefetch_batches, then the
            # mnist and imagenet benches
            phase = time.perf_counter()
            kernels.reset_launch_counts()
            report = northstar.run_transformer_train_bench(
                url, batch_size=lm_batch, num_steps=lm_steps,
                warmup_steps=3, workers_count=TOKEN_WORKERS,
                prefetch=INST_LM_PREFETCH, d_model=cfg.d_model,
                n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
                seq_len=cfg.max_seq_len, vocab=cfg.vocab_size,
                dispatch_ahead=INST_DISPATCH_AHEAD, device=device)
            lm_launches = dict(kernels.LAUNCHES)
            out = report.as_dict()
            check(report.steps == lm_steps
                  and report.samples == lm_steps * lm_batch,
                  'phase 27 (b): LM bench %r' % out)
            check(all(lm_launches[k] == 0 for k in FLASH),
                  'phase 27 (b): the blockwise LM launched %r' % lm_launches)
            PHASE27_LM.update(
                seq_len=cfg.max_seq_len,
                tokens_per_s=report.samples_per_sec * cfg.max_seq_len,
                step_ms=report.total_time_s / report.steps * 1e3)
            log('phase 27 (b) %s north-star LM (prefetch_batches, '
                'dispatch_ahead=%d): %d steps of %d x %d, %.1f tokens/s, '
                '%.2f samples/s, infeed stall %.2f%%, overlap %.2f%%, sync '
                'probe overlap %.2f%%'
                % (CARD, INST_DISPATCH_AHEAD, report.steps, lm_batch,
                   cfg.max_seq_len, report.samples_per_sec * cfg.max_seq_len,
                   report.samples_per_sec, out['infeed_stall_pct'],
                   out['overlap_pct'], out['overlap_pct_sync']))
            mnist_url = 'file://' + os.path.join(d, 'mnist')
            start = time.perf_counter()
            northstar.generate_mnist_images_dataset(
                mnist_url, **(mnist or {}).get('store', {}))
            log('phase 27 (b) %s mnist png store written in %.2f s'
                % (CARD, time.perf_counter() - start))
            report = northstar.run_mnist_train_bench(
                mnist_url, num_steps=INST_MNIST_STEPS, device=device,
                **(mnist or {}).get('bench', {}))
            log('phase 27 (b) %s mnist bench: %r' % (CARD, report.as_dict()))
            check(report.steps == INST_MNIST_STEPS,
                  'phase 27 (b): mnist bench %r' % report.as_dict())
            image_url = 'file://' + os.path.join(d, 'imagenet')
            start = time.perf_counter()
            northstar.generate_imagenet_dataset(
                image_url, **(imagenet or {}).get('store', {}))
            log('phase 27 (b) %s imagenet png store written in %.2f s'
                % (CARD, time.perf_counter() - start))
            kernels.reset_launch_counts()
            image_args = (imagenet or {}).get('bench', {})
            report = northstar.run_imagenet_train_bench(
                image_url, num_steps=INST_IMAGENET_STEPS, device=device,
                **image_args)
            launches['normalize'] = kernels.LAUNCHES['normalize']
            log('phase 27 (b) %s imagenet bench: %r; K4 launched %d times'
                % (CARD, report.as_dict(), launches['normalize']))
            check(report.steps == INST_IMAGENET_STEPS,
                  'phase 27 (b): imagenet bench %r' % report.as_dict())
            warm = image_args.get('warmup_steps', 3)
            check(device != 'cuda'
                  or launches['normalize'] == INST_IMAGENET_STEPS + warm,
                  'phase 27 (b): K4 launched %d times in %d imagenet steps'
                  % (launches['normalize'], INST_IMAGENET_STEPS + warm))
            log('phase 27 (b) %s %.1f s' % (CARD, time.perf_counter() - phase))

            # (c) the throughput command, a fresh interpreter
            phase = time.perf_counter()
            repo = os.path.dirname(os.path.abspath(__file__))
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [repo] + [p for p in os.environ.get('PYTHONPATH', '').split(
                    os.pathsep) if p]))
            cmd = [sys.executable, '-m', 'petastorm_tpu_torch.benchmark.cli',
                   url, '--read-method', 'torch', '--profile', '-d',
                   '--device', device, '-w', str(TOKEN_WORKERS),
                   '--torch-batch-size', str(lm_batch),
                   '-m', str(cli_cycles[0]), '-n', str(cli_cycles[1])]
            done = subprocess.run(cmd, capture_output=True, text=True,
                                  env=env, cwd=repo,
                                  timeout=INST_CLI_TIMEOUT_S)
            check(done.returncode == 0,
                  'phase 27 (c): the command exited %d:\n%s'
                  % (done.returncode, done.stderr[-4000:]))
            profile = json_after(done.stdout, 'Roofline profile')
            diagnosis = json_after(done.stdout,
                                   'Infeed diagnosis (median run)')
            rate = profile['measured_samples_per_s']
            roof = diagnosis.get('roofline') or {}
            check(rate and rate > 0 and roof.get('binding_stage'),
                  'phase 27 (c): samples/s %r, roofline %r' % (rate, roof))
            log('phase 27 (c) %s petastorm-tpu-torch-throughput --read-method '
                'torch: %.2f samples/s, binding stage %s (ceiling %.1f '
                'samples/s, %.1f%% of it), bottleneck %s'
                % (CARD, rate, roof['binding_stage'],
                   roof['binding_ceiling_samples_per_s'],
                   100 * (roof['roofline_fraction'] or 0),
                   diagnosis.get('bottleneck')))
            log('phase 27 (c) %s %.1f s' % (CARD, time.perf_counter() - phase))
        finally:
            if saved is None:
                os.environ.pop(tprof.CALIBRATION_DIR_ENV_VAR, None)
            else:
                os.environ[tprof.CALIBRATION_DIR_ENV_VAR] = saved

    # (d) the device-decode and goodput benches, their own checks
    phase = time.perf_counter()
    result = run_device_decode_bench(quick=True, device=device)
    lines = result['lines']
    check(result['identical']
          and lines['tokens_device']['device_decode_fraction'] == 1.0
          and lines['tokens_host']['device_decode_fraction'] == 0.0,
          'phase 27 (d): device-decode bench %r' % lines)
    log('phase 27 (d) %s device-decode bench (%s): on %.1f samples/s, off '
        '%.1f samples/s, bit-equal epochs, fraction 1.0 / 0.0; ceilings '
        'device_decode %.1f, ingest %.1f rows/s'
        % (CARD, result['jax_backend'], lines['tokens_device'][
            'samples_per_sec'], lines['tokens_host']['samples_per_sec'],
           result['roofline']['device_decode_ceiling_samples_per_s'],
           result['roofline']['ingest_ceiling_samples_per_s']))
    result = goodput.run_goodput_bench(quick=True, check=False,
                                       device=device)
    goodput._check_verdicts(result)
    log('phase 27 (d) %s goodput bench: overhead %.2f%% (pairs %r; '
        'off %.1f, on %.1f items/s; not gated), slow data %s, slow '
        'compute %s, straggler %s'
        % (CARD, result['overhead']['overhead_pct'],
           result['overhead']['per_pair_deltas_pct'],
           result['overhead']['baseline_items_per_s'],
           result['overhead']['goodput_on_items_per_s'],
           result['classification']['slow_data']['verdict'],
           result['classification']['slow_compute']['verdict'],
           result['pod']['straggler']['host']))
    log('phase 27 (d) %s %.1f s' % (CARD, time.perf_counter() - phase))
    return launches


TWIN_SCALING_STEPS = 20           # JAX's 60 accelerator steps, cut
TWIN_WORKERS = (1, 2, 4, 8)


def twin_table(device, full=True):
    """Phase 28, a row a benchmark twin: (module, group, keyword
    arguments). The exact conditions are each module's ``_check_exact``,
    its timing bars its ``_bars``. ``full=False`` (the CPU rehearsal) runs
    the three full-size twins small."""
    quick = dict(quick=True, check=False)
    big = dict(quick=not full, check=False, device=device)
    on_device = dict(quick, device=device)
    return (
        ('decode_batch', 'decode and read', big),
        ('transport', 'decode and read', quick),
        ('readahead', 'decode and read', quick),
        ('shared_cache', 'decode and read', quick),
        ('roofline', 'decode and read', big),
        ('autotune', 'control and fault', on_device),
        ('chaos', 'control and fault', quick),
        ('object_store', 'control and fault', quick),
        ('lineage_overhead', 'overheads', on_device),
        ('trace_overhead', 'overheads', quick),
        ('latency_overhead', 'overheads', on_device),
        ('health_overhead', 'overheads', quick),
        ('podobs', 'pod and scaling', quick),
        ('podelastic', 'pod and scaling', quick),
        ('scaling', 'pod and scaling', dict(
            worker_counts=TWIN_WORKERS if full else (1, 2),
            num_steps=TWIN_SCALING_STEPS, device=device)),
    )


def benchmark_twins_line(torch, kernels, device='cuda', full=True):
    """Phase 28: the port's benchmark twins, each with ``check=False``;
    then each twin's exact conditions (its ``_check_exact``), which fail
    the run, and each timing ratio beside JAX's bar, printed and not
    gated (quick pairs of sub-second passes cannot resolve such bars on
    the card). Returns the kernels' launches in the phase."""
    import importlib
    from petastorm_tpu_torch.benchmark import bar_held
    groups = {}
    held = []
    kernels.reset_launch_counts()
    for name, group, kwargs in twin_table(device, full):
        module = importlib.import_module(
            'petastorm_tpu_torch.benchmark.' + name)
        run = (module.run if name == 'scaling'
               else getattr(module, 'run_%s_bench' % name))
        start = time.perf_counter()
        result = run(**kwargs)
        seconds = time.perf_counter() - start
        groups[group] = groups.get(group, 0.0) + seconds
        try:
            module._check_exact(result)
        except AssertionError as e:
            raise RuntimeError('phase 28 %s: an exact condition failed: %s'
                               % (name, e)) from e
        log('phase 28 %s %s (%s, %.1f s): exact conditions held'
            % (CARD, name, ', '.join('%s=%s' % kv for kv in sorted(
                kwargs.items()) if kv[0] != 'check'), seconds))
        for label, value, op, bar in getattr(module, '_bars',
                                             lambda r: ())(result):
            ok = bar_held(value, op, bar)
            held.append(ok)
            log('phase 28 %s %s %s %r (JAX bar %s %s: %s; not gated)'
                % (CARD, name, label, value, op, bar,
                   'held' if ok else 'missed'))
        if name == 'decode_batch':
            log('phase 28 %s decode_batch column speedups: %s; lines %s; '
                'binding stage %s (ceiling %s samples/s)' % (CARD, ', '.join(
                    '%s %sx (%s batched, %s per-cell rows/s)'
                    % (k, v['speedup_x'], v['batched_rows_per_s'],
                       v['percell_rows_per_s'])
                    for k, v in sorted(result['column_decode'].items())),
                    ', '.join('%s %s samples/s' % (k, v['samples_per_sec'])
                              for k, v in sorted(result['lines'].items())),
                    result['roofline']['binding_stage'],
                    result['roofline']['binding_ceiling_samples_per_s']))
        elif name == 'roofline':
            roof = result['roofline']
            log('phase 28 %s roofline: %s samples/s measured, binding stage '
                '%s (ceiling %s samples/s), %s%% of it, %d workers, %d cores'
                % (CARD, result['measured_samples_per_sec'],
                   roof['binding_stage'], roof['binding_ceiling_samples_per_s'],
                   roof['roofline_pct'], result['workers'],
                   result['cpu_count']))
        elif name == 'scaling':
            log('phase 28 %s scaling (%s, %d steps of %d, os.cpu_count() %d): '
                '%s' % (CARD, result['platform'], result['num_steps'],
                        result['batch_size'], os.cpu_count(), '; '.join(
                            '%d workers %.1f samples/s, overlap %.2f%%'
                            % (e['workers'], e['samples_per_sec'],
                               e['overlap_pct'])
                            for e in result['curve'])))
    for group, seconds in groups.items():
        log('phase 28 %s group %s %.1f s' % (CARD, group, seconds))
    log('phase 28 %s timing bars held %d of %d (not gated)'
        % (CARD, sum(held), len(held)))
    return dict(kernels.LAUNCHES)


# ---------------------------------------------------------------------------
# phase 29: head dims (K1-K3 at 32 and 128 and padded; the LM with 128-wide
# heads; the north-star LM on flash; K4 at 8 channels)
# ---------------------------------------------------------------------------

# phase 3's edge shapes, run at every head dim the kernels are built for
EDGE_CASES = [('ragged L=300', dict(b=2, h=2, hkv=2, lq=300, lk=300)),
              ('non-causal 300x170', dict(b=1, h=2, hkv=2, lq=300, lk=170,
                                          causal=False)),
              ('gqa 8->2', dict(b=1, h=8, hkv=2, lq=256, lk=256)),
              ('segments masked row', dict(b=2, h=2, hkv=2, lq=300, lk=300,
                                           segmented=True)),
              ('window=128', dict(b=1, h=2, hkv=2, lq=512, lk=512,
                                  window=128))]
# the causal bf16 path shape at each new head dim: H x D = 512, the
# flagship's d_model, so each kernel's bound is the same at every head dim
HEAD_DIM_PATHS = {32: (8, 16, 2048, 32), 128: (8, 4, 2048, 128)}
PADDED_HEAD_DIMS = (80, 96)       # launched at 128 with zero columns
WIDE_HEADS = 4                    # (c): d_model 512 over 4 heads: D = 128
# (d): JAX's north-star bench widths (petastorm_tpu/benchmark/
# northstar.py:372-373): d_model 256 over 8 heads, head dim 32
NS_WIDTHS = dict(vocab_size=8192, d_model=256, n_heads=8, n_layers=4,
                 d_ff=1024, max_seq_len=256)
NS_ROWS = 1024
NS_BATCH = 8                      # phase 27's batch and step counts
NS_WARMUP = 3
NS_STEPS = 16
K4_CHANNELS = 8
#: phase 27 (b)'s north-star LM report (blockwise), printed beside (d)
PHASE27_LM = {}


def head_dim_gates(torch, kernels, gen, errs):
    """Phase 29 (a), (b): each new instantiation, and the padded head dims,
    against the twins; ``errs[(kernel, D)]`` gets the bf16 max abs errors
    at D 32 and 128."""
    for d, shape in HEAD_DIM_PATHS.items():
        b, h, l, _ = shape
        case = compare_case(torch, kernels, 'D=%d path bf16 causal' % d, gen,
                            b=b, h=h, hkv=h, lq=l, lk=l, d=d,
                            dtype=torch.bfloat16)
        for name, err in case.items():
            errs[name, d] = max(errs.get((name, d), 0.0), err)
        for dtype, tag in ((torch.bfloat16, 'bf16'), (torch.float32, 'f32')):
            for label, edge in EDGE_CASES:
                case = compare_case(torch, kernels, 'D=%d %s %s'
                                    % (d, tag, label), gen, d=d,
                                    dtype=dtype, **edge)
                if dtype == torch.bfloat16:
                    for name, err in case.items():
                        errs[name, d] = max(errs[name, d], err)
    for d in PADDED_HEAD_DIMS:
        for dtype, tag in ((torch.bfloat16, 'bf16'), (torch.float32, 'f32')):
            for label, edge in (EDGE_CASES[0], EDGE_CASES[2]):
                kernels.reset_launch_counts()
                compare_case(torch, kernels, 'D=%d padded %s %s'
                             % (d, tag, label), gen, d=d, dtype=dtype,
                             **edge)
                launched = dict(kernels.LAUNCHES)
                check(all(launched[k] == 1 for k in FLASH),
                      'D=%d %s %s: launches %r' % (d, tag, label, launched))


def wide_head_lm(torch, np, tlm, kernels, args):
    """Phase 29 (c): the flagship LM with 128-wide heads on its main path;
    returns (launches, steady step seconds)."""
    cfg = tlm.TransformerConfig(attention='flash', n_heads=WIDE_HEADS)
    check(cfg.head_dim == 128, 'head dim %d' % cfg.head_dim)
    reference_check(torch, tlm, args.seed, cfg, label='D=128 reference')
    stats = {}
    launches = main_path(torch, np, tlm, kernels, args, cfg=cfg,
                         label='D=128 LM', stats=stats)
    want = STEPS * cfg.n_layers
    check(all(launches[k] == want for k in FLASH),
          'D=128 LM: launches %r, expected %d of each of K1-K3'
          % (launches, want))
    return launches, stats['steady_s']


def northstar_lm(torch, np, tlm, kernels, args, url, mode, device='cuda',
                 widths=None):
    """Phase 29 (d): the north-star LM at JAX's bench widths (or
    ``widths``) with ``attention=mode``, fed as phase 27's run; returns
    (report, launches, first loss)."""
    from petastorm_tpu_torch import make_columnar_reader
    from petastorm_tpu_torch.benchmark.infeed import measure_infeed_overlap
    from petastorm_tpu_torch.torch_utils import (TorchDataLoader,
                                                 prefetch_batches)
    cfg = tlm.TransformerConfig(attention=mode, **(widths or NS_WIDTHS))
    params = tlm.init(cfg, torch.Generator().manual_seed(args.seed),
                      device=device)
    _, step = tlm.make_train_step(cfg, params)

    def step_fn(batch):
        tokens = batch['tokens'].to(device, non_blocking=True).long()
        return step(tokens[:, :-1], tokens[:, 1:])

    def sync():
        if device == 'cuda':
            torch.cuda.synchronize()

    with make_columnar_reader(url, reader_pool_type='thread',
                              workers_count=TOKEN_WORKERS,
                              num_epochs=None) as reader:
        loader = TorchDataLoader(reader, batch_size=NS_BATCH, drop_last=True,
                                 device=device)
        batches = prefetch_batches(iter(loader), size=INST_LM_PREFETCH)
        first = next(batches)
        tokens = first['tokens'].to(device).long()
        if mode == 'flash':    # the first step's loss and gradients
            reference_check(torch, tlm, args.seed, cfg, params,
                            tokens[:, :-1], tokens[:, 1:],
                            label='north-star first step')
        sync()
        kernels.reset_launch_counts()
        loss = float(step_fn(first))
        report = measure_infeed_overlap(
            batches, step_fn, num_steps=NS_STEPS, warmup_steps=NS_WARMUP - 1,
            count_fn=lambda b: int(b['tokens'].shape[0]),
            dispatch_ahead=INST_DISPATCH_AHEAD)
        sync()
        launches = dict(kernels.LAUNCHES)
    check(math.isfinite(loss) and report.steps == NS_STEPS,
          'north-star %s: loss %r, %d steps' % (mode, loss, report.steps))
    want = ((NS_WARMUP + NS_STEPS) * cfg.n_layers
            if mode == 'flash' and device == 'cuda' else 0)
    check(all(launches[k] == want for k in FLASH),
          'north-star %s: launches %r, expected %d of each of K1-K3'
          % (mode, launches, want))
    return report, launches, loss


def head_dim_line(torch, np, tlm, kernels, args, gen, errs):
    """Phase 29. Returns ({D: launches of that head dim's main path},
    {D: steady step ms})."""
    phase = time.perf_counter()
    head_dim_gates(torch, kernels, gen, errs)
    log('phase 29 (a, b) %s kernel gates at D 32, 128 and padded %s %.1f s'
        % (CARD, PADDED_HEAD_DIMS, time.perf_counter() - phase))
    phase = time.perf_counter()
    wide, wide_s = wide_head_lm(torch, np, tlm, kernels, args)
    cfg = tlm.TransformerConfig(n_heads=WIDE_HEADS)
    log('phase 29 (c) %s D=128 LM (d_model %d over %d heads): steady step '
        '%.2f ms, %.0f tokens/s, launches %s; %.1f s'
        % (CARD, cfg.d_model, WIDE_HEADS, wide_s * 1e3,
           BATCH * cfg.max_seq_len / wide_s, json.dumps(wide),
           time.perf_counter() - phase))
    phase = time.perf_counter()
    seq = NS_WIDTHS['max_seq_len'] + 1
    with tempfile.TemporaryDirectory(dir=ROOT, prefix='.smoke-store-') as d:
        url = 'file://' + os.path.join(d, 'northstar_tokens')
        write_token_rows(np, url, NS_ROWS, seq, NS_WIDTHS['vocab_size'],
                         args.seed)
        runs = {mode: northstar_lm(torch, np, tlm, kernels, args, url, mode)
                for mode in ('flash', 'blockwise')}
    steady = {}
    for mode, (report, launches, loss) in runs.items():
        steady[mode] = report.total_time_s / report.steps
        log('phase 29 (d) %s north-star LM (D=32) %s: first loss %.6f, %d '
            'steps of %d x %d, steady step %.3f ms, %.1f tokens/s, infeed '
            'stall %.2f%%, launches %s'
            % (CARD, mode, loss, report.steps, NS_BATCH,
               NS_WIDTHS['max_seq_len'], steady[mode] * 1e3,
               report.samples * NS_WIDTHS['max_seq_len']
               / report.total_time_s,
               report.as_dict()['infeed_stall_pct'], json.dumps(launches)))
    if PHASE27_LM:
        log('phase 29 (d) %s beside phase 27 (b) (blockwise, TransformerConfig'
            "'s widths, L %d): %.1f tokens/s, %.3f ms a step"
            % (CARD, PHASE27_LM['seq_len'], PHASE27_LM['tokens_per_s'],
               PHASE27_LM['step_ms']))
    log('phase 29 (d) %s %.1f s' % (CARD, time.perf_counter() - phase))
    phase = time.perf_counter()
    errs['normalize', K4_CHANNELS] = k4_channels_check(torch, kernels)
    log('phase 29 (e) %s K4 at C=%d %.1f s'
        % (CARD, K4_CHANNELS, time.perf_counter() - phase))
    return ({128: wide, 32: runs['flash'][1]},
            {128: wide_s * 1e3, 32: steady['flash'] * 1e3,
             'blockwise 32': steady['blockwise'] * 1e3})


def k4_channels_check(torch, kernels):
    """K4 at 8 channels, a distinct mean and std a channel, bit for bit
    against its twin over every uint8 value in every channel, bf16 and
    float32; returns the max abs error (0)."""
    v = torch.arange(256, dtype=torch.uint8).reshape(2, 16, 8)
    x = torch.stack([torch.roll(v.flatten(), i).reshape(2, 16, 8)
                     for i in range(K4_CHANNELS)], -1).cuda()
    mean = torch.linspace(0.1, 0.8, K4_CHANNELS)
    inv = 1.0 / torch.linspace(0.2, 0.5, K4_CHANNELS)
    for dtype in (torch.bfloat16, torch.float32):
        kernels.reset_launch_counts()
        got = kernels.normalize(x, mean, inv, dtype)
        ref = kernels.normalize_plain(x, mean, inv, dtype)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES['normalize'] == 1 and torch.equal(got, ref),
              'K4 at C=%d %s: %d elements differ from the twin'
              % (K4_CHANNELS, dtype, int((got != ref).sum())))
    log('K4 C=%d %s, bf16 and float32: bit-equal to the twin over %d values'
        % (K4_CHANNELS, tuple(x.shape), x.numel()))
    return 0.0


def ptxas_instances(log_text):
    """{kernel name: [{dtype, head_dim, out, registers, spill_stores,
    spill_loads}, ...]} of every flash instantiation (and K4's) in nvcc's
    ``-Xptxas -v`` report, from the mangled names."""
    import re
    instance = re.compile(
        r'(fwd_sm90_kernel|dq_sm90_kernel|dkdv_sm90_kernel|fwd_kernel|'
        r'dq_kernel|dkdv_kernel|normalize_kernel)I(.*?)EEv')
    kernel_of = {'fwd': 'flash_fwd', 'dq': 'flash_bwd_dq',
                 'dkdv': 'flash_bwd_dkdv', 'normalize': 'normalize'}
    out = {}
    for line in ptxas_summary(log_text):
        name, rest = line.split(': ', 1)
        m = instance.search(name)
        if m is None:
            continue
        regs, spill = rest.split(' registers, spill ')
        stores, loads = spill[:-2].split('/')
        kind, args = m.group(1), m.group(2)
        dims = re.findall(r'Li(\d+)', args)
        sm90 = 'sm90' in kind
        entry = {'dtype': 'bfloat16' if sm90 else 'float32',
                 'head_dim': int(dims[0]) if dims else None,
                 'registers': int(regs), 'spill_stores': int(stores),
                 'spill_loads': int(loads)}
        if kind == 'dkdv_sm90_kernel':
            entry['out'] = 'float32' if args.endswith('f') else 'bfloat16'
        if kind == 'normalize_kernel':
            entry['dtype'] = 'uint8'
            entry['out'] = 'bfloat16' if 'bfloat16' in args else 'float32'
        out.setdefault(kernel_of[kind.split('_')[0]], []).append(entry)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the weights, the store and the inputs')
    parser.add_argument('--profile', action='store_true',
                        help='profile two more main-path steps (device time '
                        'by kernel to standard error) and the token line\'s '
                        'host threads, device decode on against off')
    parser.add_argument('--ptxas-log', action='store_true',
                        help="print nvcc's register/shared-memory report")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from petastorm_tpu_torch.models import transformer_lm as tlm
    from petastorm_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 twins: full
    torch.backends.cudnn.allow_tf32 = False         # float32, no TF32

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)

    wall = start = time.perf_counter()
    kernels.build()
    log('build %.1f s (nvcc, a call a source started together, 4 kernels, '
        '%s)'
        % (time.perf_counter() - start,
           'cached' if kernels.BUILD_INFO['cached'] else 'fresh'))
    for line in ptxas_summary(kernels.BUILD_INFO['log']):
        log('ptxas ' + line)
    if args.ptxas_log:
        print(kernels.BUILD_INFO['log'], file=sys.stderr)

    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    b, h, l, d = PATH_SHAPE
    errs = compare_case(torch, kernels, 'path bf16 causal', gen, b=b, h=h,
                        hkv=h, lq=l, lk=l, d=d, dtype=torch.bfloat16)
    for dtype, tag in ((torch.bfloat16, 'bf16'), (torch.float32, 'f32')):
        for label, shape in EDGE_CASES:
            case = compare_case(torch, kernels, '%s %s' % (tag, label), gen,
                                d=64, dtype=dtype, **shape)
            if dtype == torch.bfloat16:
                for name, err in case.items():
                    errs[name] = max(errs[name], err)
    # phase 25's shapes: a tensor-parallel rank's 4 heads of 8, and the
    # dry run's float32 chunk pairs at head dim 16 (the D = 16 build)
    case = compare_case(torch, kernels, 'bf16 tp rank 4 of 8 heads', gen,
                        b=4, h=4, hkv=4, lq=2048, lk=2048, d=64,
                        dtype=torch.bfloat16)
    for name, err in case.items():
        errs[name] = max(errs[name], err)
    for causal in (True, False):
        compare_case(torch, kernels, 'f32 D=16 chunk %s' % (
            'causal' if causal else 'non-causal'), gen, b=2, h=2, hkv=2,
            lq=32, lk=32, d=16, dtype=torch.float32, causal=causal)
    compare_case(torch, kernels, 'f32 D=16 GQA 2->1', gen, b=2, h=2, hkv=1,
                 lq=32, lk=32, d=16, dtype=torch.float32)
    case = compare_case(torch, kernels, 'bf16 non-negative q,k,v,do', gen,
                        b=2, h=4, hkv=4, lq=1024, lk=1024, d=64,
                        dtype=torch.bfloat16, nonneg=True)
    for name, err in case.items():
        errs[name] = max(errs[name], err)

    phase = time.perf_counter()
    errs['normalize'] = k4_check(torch, kernels, args.seed)
    log('phase K4 check %.1f s' % (time.perf_counter() - phase))

    reference_check(torch, tlm, args.seed)
    phase = time.perf_counter()
    image_reference_check(torch, kernels, args.seed)
    log('phase image reference %.1f s' % (time.perf_counter() - phase))

    launches = main_path(torch, np, tlm, kernels, args)
    phase = time.perf_counter()
    launches['normalize'] = image_main_path(torch, kernels,
                                            args)['normalize']
    log('phase image main path %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    mnist_line(torch, args)
    log('phase MNIST line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    batch_line(torch, np, args)
    log('phase batch line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    legacy_line(torch, np)
    log('phase legacy store %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    jpeg = jpeg_line(torch, np, kernels, args)
    check(jpeg['normalize'] == JPEG_STEPS,
          'K4 launched %d times in %d jpeg steps'
          % (jpeg['normalize'], JPEG_STEPS))
    launches['normalize'] += jpeg['normalize']
    log('phase jpeg image line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    selected, forced = selection_line(torch, np, tlm, kernels, args)
    check(all(selected[k] > 0 for k in FLASH),
          'a kernel was not launched on the selection line: %r' % selected)
    check(forced['flash_fwd'] > 0,
          'float32 K1 was not launched by the teacher-forced forward')
    for name in FLASH:
        launches[name] += selected[name] + forced[name]
    log('phase selection line and decode %.1f s'
        % (time.perf_counter() - phase))
    phase = time.perf_counter()
    packed, packed_forced = packed_moe_line(torch, np, tlm, kernels, args)
    check(packed_forced['flash_fwd'] > 0,
          'float32 K1 was not launched by the MoE teacher-forced forward')
    for name in FLASH:
        launches[name] += packed[name] + packed_forced[name]
    log('phase packed MoE line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    token = token_line(torch, np, tlm, kernels, args)
    check(all(token[k] > 0 for k in FLASH),
          'a kernel was not launched on the token line: %r' % token)
    for name in FLASH:
        launches[name] += token[name]
    log('phase columnar token line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    cached_image, cached_lm = cache_line(torch, np, tlm, kernels, args)
    check(all(cached_lm[k] > 0 for k in FLASH),
          'a kernel was not launched on the cached token LM: %r' % cached_lm)
    check(cached_image['normalize'] > 0,
          'K4 was not launched on the cached image line')
    for name in FLASH:
        launches[name] += cached_lm[name]
    launches['normalize'] += cached_image['normalize']
    log('phase cache and readahead line %.1f s'
        % (time.perf_counter() - phase))
    phase = time.perf_counter()
    lineage_image, lineage_lm = lineage_line(torch, np, tlm, kernels, args)
    check(all(lineage_lm[k] > 0 for k in FLASH),
          'a kernel was not launched on the audited token LM: %r'
          % lineage_lm)
    check(lineage_image['normalize'] > 0,
          'K4 was not launched on the quarantined png line')
    for name in FLASH:
        launches[name] += lineage_lm[name]
    launches['normalize'] += lineage_image['normalize']
    log('phase lineage line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    observed_lm, observed_png = observability_line(torch, np, tlm, kernels,
                                                   args)
    check(all(observed_lm[k] > 0 for k in FLASH),
          'a kernel was not launched on the metered LM line: %r'
          % observed_lm)
    check(observed_png['normalize'] > 0,
          'K4 was not launched on the metered png pass')
    for name in FLASH:
        launches[name] += observed_lm[name]
    launches['normalize'] += observed_png['normalize']
    log('phase observability line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    watched_lm = health_line(torch, np, tlm, kernels, args)
    check(all(watched_lm[k] > 0 for k in FLASH),
          'a kernel was not launched on the watched LM line: %r'
          % watched_lm)
    for name in FLASH:
        launches[name] += watched_lm[name]
    log('phase health line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    tuned_png, tuned_lm = tune_line(torch, np, tlm, kernels, args)
    check(tuned_png['normalize'] > 0,
          'K4 was not launched on the autotuned png line')
    check(all(tuned_lm[k] > 0 for k in FLASH),
          'a kernel was not launched on the autotuned LM line: %r'
          % tuned_lm)
    for name in FLASH:
        launches[name] += tuned_lm[name]
    launches['normalize'] += tuned_png['normalize']
    log('phase autotune and roofline line %.1f s'
        % (time.perf_counter() - phase))
    phase = time.perf_counter()
    resilient_lm, resilient_png = resilience_line(torch, np, tlm, kernels,
                                                  args)
    check(all(resilient_lm[k] > 0 for k in FLASH),
          'a kernel was not launched on the resilience LM line: %r'
          % resilient_lm)
    check(resilient_png['normalize'] > 0,
          'K4 was not launched on the poisoned png line')
    for name in FLASH:
        launches[name] += resilient_lm[name]
    launches['normalize'] += resilient_png['normalize']
    log('phase resilience line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    remote_lm_launches, pod_png = remote_line(torch, np, tlm, kernels, args)
    check(all(remote_lm_launches[k] > 0 for k in FLASH),
          'a kernel was not launched on the remote LM line: %r'
          % remote_lm_launches)
    check(pod_png['normalize'] > 0,
          'K4 was not launched on the pod-served png line')
    for name in FLASH:
        launches[name] += remote_lm_launches[name]
    launches['normalize'] += pod_png['normalize']
    log('phase remote line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    resumed = resume_line(torch, np, tlm, kernels, args)
    check(all(resumed[k] > 0 for k in FLASH),
          'a kernel was not launched on the resume line: %r' % resumed)
    for name in FLASH:
        launches[name] += resumed[name]
    log('phase resume line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    elastic_lm, observed_pod = pod_planes_line(torch, np, tlm, kernels, args)
    check(all(elastic_lm[k] > 0 for k in FLASH),
          'a kernel was not launched on the elastic LM line: %r' % elastic_lm)
    check(observed_pod['normalize'] > 0,
          'K4 was not launched on the observed pod png line')
    for name in FLASH:
        launches[name] += elastic_lm[name]
    launches['normalize'] += observed_pod['normalize']
    log('phase pod line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    parallel = parallel_line(torch, np, tlm, kernels, args)
    check(all(parallel[k] > 0 for k in FLASH),
          'a kernel was not launched on the parallel line: %r' % parallel)
    for name in FLASH:
        launches[name] += parallel[name]
    log('phase parallel line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    parallel3b = tp_line(torch, np, tlm, kernels, args)
    check(all(parallel3b[k] > 0 for k in FLASH),
          'a kernel was not launched on the tp/ep/pp line: %r' % parallel3b)
    for name in FLASH:
        launches[name] += parallel3b[name]
    log('phase tensor, expert and pipeline parallel line %.1f s'
        % (time.perf_counter() - phase))
    phase = time.perf_counter()
    adapted = adapter_line(torch, np, tlm, kernels, args)
    for name in FLASH + ('normalize',):
        launches[name] += adapted[name]
    log('phase adapter line %.1f s' % (time.perf_counter() - phase))
    phase = time.perf_counter()
    instrumented = instruments_line(torch, np, tlm, kernels, args)
    for name in FLASH + ('normalize',):
        launches[name] += instrumented[name]
    log('phase instruments line %s %.1f s'
        % (CARD, time.perf_counter() - phase))
    phase = time.perf_counter()
    twins = benchmark_twins_line(torch, kernels)
    check(all(twins[k] == 0 for k in FLASH),
          'phase 28 launched a flash kernel: %r' % twins)
    for name in FLASH + ('normalize',):
        launches[name] += twins[name]
    log('phase benchmark twins line %s %.1f s (launches %r)'
        % (CARD, time.perf_counter() - phase, twins))
    phase = time.perf_counter()
    head_launches, head_steps = head_dim_line(torch, np, tlm, kernels, args,
                                              gen, errs)
    log('phase head-dim line %s %.1f s (D=128 LM step %.2f ms, north-star '
        'D=32 step %.3f ms on flash, %.3f ms on blockwise)'
        % (CARD, time.perf_counter() - phase, head_steps[128],
           head_steps[32], head_steps['blockwise 32']))

    times = timings(torch, kernels, gen, REPS)
    head_times = {d: timings(torch, kernels, gen, REPS, shape)
                  for d, shape in HEAD_DIM_PATHS.items()}
    small_head_times(torch, kernels, gen)
    bound = bounds(PATH_SHAPE)
    phase = time.perf_counter()
    k4 = k4_times(torch, kernels, args.seed)
    k4_c8 = k4_times(torch, kernels, args.seed,
                     K4_SHAPE[:3] + (K4_CHANNELS,))
    log('time normalize at C=%d %.4f ms, %.1f%% of its bound (bound %.4f '
        'ms by %s, plain %.4f ms; yardstick %.4f ms)'
        % (K4_CHANNELS, k4_c8['ms'], 100 * k4_c8['bound'][0] / k4_c8['ms'],
           k4_c8['bound'][0], k4_c8['bound'][1], k4_c8['plain_ms'],
           k4_c8['yardstick_ms']))
    log('phase K4 times %.1f s' % (time.perf_counter() - phase))
    times['normalize'] = {
        'ms': k4['ms'], 'plain_ms': k4['plain_ms'], 'library_ms': None,
        'library': 'none: no single PyTorch call computes this function',
        'yardstick_ms': k4['yardstick_ms'],
        'yardstick': 'x.to(torch.bfloat16): the same bytes, not the function'}
    bound['normalize'] = k4['bound']
    instances = ptxas_instances(kernels.BUILD_INFO['log'])
    # a row a kernel at each bf16 head dim: D = 64 (the flagship's, every
    # earlier phase), then 32 and 128 (phase 29's paths and shapes)
    rows = [(name, name, 64, times[name], bound[name], launches[name],
             errs[name]) for name in KERNELS]
    for d, shape in HEAD_DIM_PATHS.items():
        head_bound = bounds(shape)
        rows += [('%s_d%d' % (name, d), name, d, head_times[d][name],
                  head_bound[name], head_launches[d][name], errs[name, d])
                 for name in FLASH]
    table = []
    for label, name, d, t, bnd, count, err in rows:
        source, replaces = KERNELS[name]
        row = {'name': label, 'route': 'cuda', 'source': source,
               'replaces': replaces, 'status': 'ported',
               'launches': count, 'max_abs_err': err, 'ms': t['ms'],
               'plain_ms': t['plain_ms'], 'bound_ms': bnd[0],
               'bound_by': bnd[1],
               'library_ms': t['library_ms'], 'library': t['library']}
        if 'yardstick_ms' in t:
            row.update(yardstick_ms=t['yardstick_ms'],
                       yardstick=t['yardstick'])
        if name in FLASH:
            # the float32-only head dim 16 is listed with the D = 64 rows
            row['head_dim'] = d
            dims = (d, 16) if d == 64 else (d,)
            row['ptxas'] = [e for e in instances[name]
                            if e['head_dim'] in dims]
        else:
            row['ptxas'] = instances[name]
        table.append(row)
        rate = ('%.1f TFLOP/s, ' % (bnd[2] / t['ms'] / 1e9)
                if name in FLASH else '')
        log('time %-20s %.4f ms, %s%.1f%% of its bound (bound %.4f ms by %s, '
            'plain %.4f ms, library %s: %s%s)'
            % (label, t['ms'], rate, 100 * bnd[0] / t['ms'],
               bnd[0], bnd[1], t['plain_ms'],
               'n/a' if t['library_ms'] is None
               else '%.4f ms' % t['library_ms'], t['library'],
               '; yardstick %.4f ms, %s' % (t['yardstick_ms'],
                                            t['yardstick'])
               if 'yardstick_ms' in t else ''))
    for d, t in ((64, times), *head_times.items()):
        bwd = t['flash_bwd_dq']['ms'] + t['flash_bwd_dkdv']['ms']
        aten = t['flash_bwd_dq']['library_ms']
        log('time D=%d backward K2 + K3 %.4f ms, aten flash backward (dq, dk, '
            'dv) %.4f ms: %.2fx; K1 %.2fx SDPA'
            % (d, bwd, aten, bwd / aten, t['flash_fwd']['ms']
               / t['flash_fwd']['library_ms']))
    log('wall %.1f s' % (time.perf_counter() - wall))
    print(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
