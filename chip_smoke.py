#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each
printing one line or a few:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the four CUDA kernels from ``csrc/`` in one ``nvcc`` call
   (bf16 K1, K2, K3 on Hopper's tensor cores: ``flash_fwd_sm90.cu``,
   ``flash_bwd_dq_sm90.cu``, ``flash_bwd_sm90.cu``; float32 K1-K3 on the
   FP32 cores: ``flash_fwd.cu``, ``flash_bwd.cu``; K4 ``normalize.cu``);
3. kernels: the registers and spills of each kernel (``ptxas -v``); K1
   (forward), K2 (dq) and K3 (dk/dv) against their plain PyTorch twins run
   in float32 on the same values, at the training shape (8, 8, 2048, 64)
   bf16 causal and at edge shapes in bf16 and in float32 (ragged L=300,
   non-causal 300 x 170, GQA 8->2, segment ids with a fully masked row,
   window 128). Float32 outputs: atol = rtol = 1e-4. bf16 o, dq, dk and dv
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
   ``/autotune`` (no controller), ``/observe/snapshot`` and ``/podmetrics``
   404; the largest age a ``staging`` beat reached. The wedged LM: the
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
   in turns, both ratios beside the off runs' spread.

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

def reference_check(torch, tlm, seed):
    """Full-width model on a (1, 256) input: the flash path's loss and
    gradients against the plain blockwise attention's."""
    import dataclasses
    cfg = tlm.TransformerConfig(attention='flash')
    gen = torch.Generator().manual_seed(seed)
    params = tlm.init(cfg, gen, device='cuda')
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
    (lf, gf), (lb, gb) = results
    check(math.isfinite(lf) and abs(lf - lb) < 1e-2,
          'reference: flash loss %r vs blockwise %r' % (lf, lb))
    rel = max(float((a - b).norm() / (b.norm() + 1e-12))
              for a, b in zip(gf, gb))
    check(rel < 5e-2, 'reference: gradient relative error %.3g' % rel)
    log('reference loss flash %.6f blockwise %.6f |dL| %.3g, max grad '
        'rel err %.3g (tol loss 1e-2, grad 5e-2)' % (lf, lb, abs(lf - lb),
                                                     rel))


def write_store(np, url, seq_len, vocab, rows, seed, rows_per_file=None):
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


def main_path(torch, np, tlm, kernels, args):
    from petastorm_tpu_torch import (TorchDataLoader, make_reader,
                                     prefetch_to_device)
    from petastorm_tpu_torch.ngram import NGram
    cfg = tlm.TransformerConfig(attention='flash')
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
                    log('step %d loss %.6f time %.2f ms tokens/s %.0f; '
                        'consumer: batch wait %.2f ms, dispatch %.2f ms, '
                        'fence %.2f ms'
                        % (i, loss, dt * 1e3,
                           BATCH * cfg.max_seq_len / dt,
                           *(x * 1e3 for x in splits[-1])))
                launches = dict(kernels.LAUNCHES)
                if args.profile:
                    def run_step():
                        batch = next(batches)
                        tokens = batch[0]['tokens']
                        nxt = batch[1]['tokens'][:, :1]
                        step(tokens, torch.cat([tokens[:, 1:], nxt], 1))
                    profile_steps(torch, run_step, 2, 'flash', 'LM')
            # the epoch's items the loader did not take, read and dropped:
            # then every item was delivered once and the audit is complete
            rest = sum(1 for _ in reader.iter_ngram_chunks())
            report = reader.audit().assert_complete()
    epoch = report['epochs'][0]
    log('LM reader audit complete: %d items, %d windows delivered in epoch '
        '0 (%d items read after the steps); no batch held _provenance'
        % (epoch['items_delivered'], epoch['rows_delivered'], rest))
    log_goodput(goodput, 'LM')
    check(all(math.isfinite(x) for x in losses), 'non-finite loss')
    check(all(launches[k] > 0 for k in FLASH),
          'a kernel was not launched on the main path: %r' % launches)
    steady = times[1:] or times
    log('main path %d steps, loss %.4f -> %.4f, steady step %.2f ms, '
        '%.0f tokens/s, launches %s'
        % (len(losses), losses[0], losses[-1],
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

def write_token_rows(np, url, rows, seq_len, vocab, seed):
    """``idx`` int64 (ScalarCodec) and ``tokens`` int32 ``(seq_len,)``
    (NdarrayCodec, non-nullable) in row groups of about 2 MB; returns the
    tokens written."""
    from petastorm_tpu_torch import materialize_dataset
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('TokenRows', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (seq_len,), NdarrayCodec(),
                       False)])
    tokens = np.random.default_rng(seed).integers(0, vocab, (rows, seq_len),
                                                  dtype=np.int32)
    with materialize_dataset(url, schema, row_group_size_mb=TOKEN_GROUP_MB,
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
    its tracer, 'pids': its worker processes' pids}``."""
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
            'diagnostics': diagnostics, 'tracer': tracer, 'pids': pids}


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
HEALTH_ABSENT = ('/autotune', '/observe/snapshot', '/podmetrics')

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
    from http.client import HTTPConnection
    conn = HTTPConnection('127.0.0.1', port, timeout=10)
    try:
        conn.request('GET', route)
        response = conn.getresponse()
        return response.status, response.read().decode('utf-8')
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
                '/diagnostics', '/metrics', '/coverage', '/goodput', '/slo')
                + HEALTH_ABSENT}
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
        '200; %s 404; '
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


def timings(torch, kernels, gen, reps):
    b, h, l, d = PATH_SHAPE
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


def k4_times(torch, kernels, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randint(0, 256, K4_SHAPE, generator=gen, device='cuda',
                      dtype=torch.uint8)
    zero, one = torch.zeros(3), torch.ones(3)
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
    log('build %.1f s (nvcc, one call, 4 kernels, %s)'
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
    edges = [('ragged L=300', dict(b=2, h=2, hkv=2, lq=300, lk=300)),
             ('non-causal 300x170', dict(b=1, h=2, hkv=2, lq=300, lk=170,
                                         causal=False)),
             ('gqa 8->2', dict(b=1, h=8, hkv=2, lq=256, lk=256)),
             ('segments masked row', dict(b=2, h=2, hkv=2, lq=300, lk=300,
                                          segmented=True)),
             ('window=128', dict(b=1, h=2, hkv=2, lq=512, lk=512,
                                 window=128))]
    for dtype, tag in ((torch.bfloat16, 'bf16'), (torch.float32, 'f32')):
        for label, shape in edges:
            case = compare_case(torch, kernels, '%s %s' % (tag, label), gen,
                                d=64, dtype=dtype, **shape)
            if dtype == torch.bfloat16:
                for name, err in case.items():
                    errs[name] = max(errs[name], err)
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

    times = timings(torch, kernels, gen, REPS)
    bound = bounds(PATH_SHAPE)
    phase = time.perf_counter()
    k4 = k4_times(torch, kernels, args.seed)
    log('phase K4 times %.1f s' % (time.perf_counter() - phase))
    times['normalize'] = {
        'ms': k4['ms'], 'plain_ms': k4['plain_ms'], 'library_ms': None,
        'library': 'none: no single PyTorch call computes this function',
        'yardstick_ms': k4['yardstick_ms'],
        'yardstick': 'x.to(torch.bfloat16): the same bytes, not the function'}
    bound['normalize'] = k4['bound']
    table = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        row = {'name': name, 'route': 'cuda', 'source': source,
               'replaces': replaces, 'status': 'ported',
               'launches': launches[name],
               'max_abs_err': errs[name], 'ms': t['ms'],
               'plain_ms': t['plain_ms'], 'bound_ms': bound[name][0],
               'bound_by': bound[name][1],
               'library_ms': t['library_ms'], 'library': t['library']}
        if 'yardstick_ms' in t:
            row.update(yardstick_ms=t['yardstick_ms'],
                       yardstick=t['yardstick'])
        table.append(row)
        rate = ('%.1f TFLOP/s, ' % (bound[name][2] / t['ms'] / 1e9)
                if name in FLASH else '')
        log('time %-15s %.4f ms, %s%.1f%% of its bound (bound %.4f ms by %s, '
            'plain %.4f ms, library %s: %s%s)'
            % (name, t['ms'], rate, 100 * bound[name][0] / t['ms'],
               bound[name][0], bound[name][1], t['plain_ms'],
               'n/a' if t['library_ms'] is None
               else '%.4f ms' % t['library_ms'], t['library'],
               '; yardstick %.4f ms, %s' % (t['yardstick_ms'],
                                            t['yardstick'])
               if 'yardstick_ms' in t else ''))
    bwd = times['flash_bwd_dq']['ms'] + times['flash_bwd_dkdv']['ms']
    aten = times['flash_bwd_dq']['library_ms']
    log('time backward K2 + K3 %.4f ms, aten flash backward (dq, dk, dv) '
        '%.4f ms: %.2fx' % (bwd, aten, bwd / aten))
    log('wall %.1f s' % (time.perf_counter() - wall))
    print(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
