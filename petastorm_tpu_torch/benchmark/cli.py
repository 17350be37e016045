"""``petastorm-tpu-torch-throughput``, the port's throughput command (JAX
``benchmark/cli.py``), with JAX's flags, apart from ``--read-method torch``
(JAX's ``jax``) and ``--torch-batch-size`` (JAX's ``--jax-batch-size``),
and with ``--device``: where the ``torch`` method's batches and the
``--profile`` probes go (``cuda`` by default, which raises without CUDA;
``--device cpu`` runs on the host).

Usage::

    python -m petastorm_tpu_torch.benchmark.cli file:///tmp/hello_world_dataset \
        -w 3 -p thread -m 200 -n 1000 --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging

from petastorm_tpu_torch.benchmark.throughput import reader_throughput


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Measure petastorm_tpu_torch reader throughput')
    parser.add_argument('dataset_url', help='e.g. file:///tmp/hello_world_dataset')
    parser.add_argument('-f', '--field-regex', nargs='+', default=None,
                        help='Read only fields matching these regexes')
    parser.add_argument('-w', '--workers-count', type=int, default=3)
    parser.add_argument('-p', '--pool-type', default='thread',
                        choices=['thread', 'process', 'dummy'])
    parser.add_argument('-m', '--warmup-cycles', type=int, default=200)
    parser.add_argument('-n', '--measure-cycles', type=int, default=1000)
    parser.add_argument('-q', '--shuffling-queue-size', type=int, default=500)
    parser.add_argument('--batch-reader', action='store_true',
                        help='Use make_batch_reader (vectorized path)')
    parser.add_argument('--read-method', default='python',
                        choices=['python', 'torch'])
    parser.add_argument('--io-readahead', default='0',
                        help="per-worker row-group read prefetch depth: an "
                             "int or 'auto' (overlap storage I/O with "
                             "decode; see docs/readahead.md)")
    parser.add_argument('--torch-batch-size', type=int, default=16)
    parser.add_argument('--prefetch-depth', type=int, default=None,
                        help='device-staging prefetch depth for the torch '
                             'read method (batches materialized ahead of the '
                             'consumer; default: '
                             'PETASTORM_TPU_PREFETCH_DEPTH or 2; owned by '
                             'this flag, the autotuner does not actuate it)')
    parser.add_argument('-r', '--runs', type=int, default=1,
                        help='Repeat the measurement N times and report '
                             'best/median/min + spread (noisy shared hosts '
                             'need dispersion, not one sample)')
    parser.add_argument('-d', '--diagnostics', action='store_true',
                        help='Print the per-stage pipeline telemetry '
                             '(Reader.diagnostics) of the median run')
    parser.add_argument('--trace', metavar='PATH', default=None,
                        help='Record per-item pipeline spans and export a '
                             'Chrome trace-event JSON (open in Perfetto / '
                             'chrome://tracing) covering the measured window '
                             'to PATH; with -r, each run overwrites it, so '
                             'the last run wins (see docs/tracing.md)')
    parser.add_argument('--metrics-interval', type=float, default=0,
                        help='Snapshot reader stats every N seconds into '
                             '--metrics-out while the benchmark runs')
    parser.add_argument('--metrics-out', metavar='PATH', default=None,
                        help='Metrics emitter output: JSON-lines, or '
                             'Prometheus text exposition for .prom paths')
    parser.add_argument('--debug-port', type=int, default=None,
                        help='Serve the live health endpoints on '
                             '127.0.0.1:PORT while the benchmark runs '
                             '(/healthz /metrics /diagnostics /stacks; 0 = '
                             'ephemeral; see docs/health.md)')
    parser.add_argument('--stall-timeout', type=float, default=0,
                        help='Arm the pipeline watchdog: classify the reader '
                             'stalled (and write a flight-recorder JSON) '
                             'after N seconds without entity progress')
    parser.add_argument('--audit', action='store_true',
                        help='Print the lineage coverage audit of the median '
                             'run: per-epoch exactly-once verdicts, dup/drop '
                             'row groups, shuffle quality, quarantine totals. '
                             'The benchmark stops mid-stream after its '
                             'measured samples, so the in-flight tail epoch '
                             'honestly reads as dropped; judge the fully '
                             'consumed epochs (see docs/lineage.md)')
    parser.add_argument('--profile', action='store_true',
                        help='Roofline-profile the median run: calibrate '
                             'per-stage ceilings against this dataset '
                             '(storage, codec decode, transport, device '
                             'staging; cached per host+dataset), report '
                             'measured samples/sec as a %% of the binding '
                             "stage's ceiling, and print the what-if "
                             "advisor's ranked knob recommendations (see "
                             'docs/profiling.md)')
    parser.add_argument('--cache-type', default='null',
                        choices=['null', 'local-disk', 'shared'],
                        help="row-group cache: 'null' (none), 'local-disk' "
                             "(per-reader pickle-on-disk), 'shared' (host-"
                             'wide tiered decoded cache that concurrent '
                             'readers attach to; see docs/cache.md)')
    parser.add_argument('--cache-location', metavar='DIR', default=None,
                        help='cache directory (required for local-disk and '
                             'shared; for shared it is the host-wide root '
                             'every attaching reader must agree on)')
    parser.add_argument('--cache-size-limit', type=int, default=None,
                        help='cache byte budget (required for local-disk '
                             'and shared; shared bounds the disk tier, with '
                             'the shared-memory tier capped at min(this, '
                             '1 GiB))')
    parser.add_argument('--slo-p99-ms', type=float, default=None,
                        help='arm the SLO monitor with a p99 end-to-end '
                             'batch-latency target (milliseconds over the '
                             'rolling window); the verdict — per-target '
                             'checks + error-budget burn — prints after the '
                             'run (see docs/latency.md)')
    parser.add_argument('--slo-min-samples-per-s', type=float, default=None,
                        help='add a minimum samples/s target to the SLO '
                             'monitor (window rate from ReaderStats)')
    parser.add_argument('--autotune', action='store_true',
                        help='run the model-predictive pipeline controller '
                             'on the benchmarked reader: live worker/'
                             'readahead/window/queue tuning with hysteresis '
                             'and revert-on-regression; the controller '
                             'report (every move, predicted vs measured) '
                             'prints after the run (see docs/autotune.md)')
    parser.add_argument('--on-decode-error', default='raise',
                        choices=['raise', 'skip', 'quarantine'],
                        help="bad-sample policy: 'raise' propagates decode/"
                             "transform errors, 'skip' drops failing rows "
                             "counting them, 'quarantine' drops AND records "
                             'provenance-tagged quarantine records')
    parser.add_argument('--remote-read', default=None,
                        choices=['serial', 'prebuffer', 'ranged', 'auto'],
                        help='row-group fetch strategy against the object '
                             "store: 'serial' opens and reads sequentially, "
                             "'prebuffer' uses the Arrow pre-buffered reads, "
                             "'ranged' plans coalesced parallel range reads "
                             'from the Parquet footer (see '
                             "docs/object_store.md); 'auto'/omitted picks "
                             'per-protocol')
    parser.add_argument('--storage-options', metavar='JSON', default=None,
                        help='JSON object of fsspec storage options handed '
                             'to the filesystem resolver, e.g. '
                             '\'{"anon": true}\' for public s3:// buckets')
    parser.add_argument('--device', default='cuda',
                        help="where the torch method's batches and the "
                             "--profile probes go: 'cuda' (the default; "
                             "raises without CUDA) or 'cpu'")
    parser.add_argument('-v', action='store_true', help='INFO logging')
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from petastorm_tpu_torch.benchmark import resolve_cli_device
    device = resolve_cli_device(args.device, 'petastorm-tpu-torch-throughput')
    if args.v:
        logging.basicConfig(level=logging.INFO)
    io_readahead = (args.io_readahead if args.io_readahead == 'auto'
                    else int(args.io_readahead))
    if args.metrics_interval and not args.metrics_out:
        raise SystemExit('--metrics-interval needs --metrics-out PATH')
    if args.cache_type != 'null' and not (args.cache_location
                                          and args.cache_size_limit):
        raise SystemExit('--cache-type {} needs --cache-location and '
                         '--cache-size-limit'.format(args.cache_type))
    storage_options = None
    if args.storage_options:
        storage_options = json.loads(args.storage_options)
        if not isinstance(storage_options, dict):
            raise SystemExit('--storage-options must be a JSON object, got '
                             '{!r}'.format(args.storage_options))
    slo = {}
    if args.slo_p99_ms is not None:
        slo['p99_e2e_ms'] = args.slo_p99_ms
    if args.slo_min_samples_per_s is not None:
        slo['min_samples_per_s'] = args.slo_min_samples_per_s
    results = [reader_throughput(
        args.dataset_url, field_regex=args.field_regex,
        warmup_cycles=args.warmup_cycles, measure_cycles=args.measure_cycles,
        pool_type=args.pool_type, workers_count=args.workers_count,
        shuffling_queue_size=args.shuffling_queue_size,
        read_method=args.read_method, batch_reader=args.batch_reader,
        torch_batch_size=args.torch_batch_size,
        prefetch_depth=args.prefetch_depth,
        io_readahead=io_readahead, trace_path=args.trace,
        metrics_interval=args.metrics_interval,
        metrics_out=args.metrics_out, debug_port=args.debug_port,
        stall_timeout=args.stall_timeout, audit=args.audit,
        profile=args.profile, slo=slo or None, autotune=args.autotune,
        on_decode_error=args.on_decode_error, cache_type=args.cache_type,
        cache_location=args.cache_location,
        cache_size_limit=args.cache_size_limit,
        remote_read=args.remote_read, storage_options=storage_options,
        device=device)
        for _ in range(max(1, args.runs))]
    # headline = median run: the honest central figure (best would overstate)
    by_rate = sorted(results, key=lambda r: r.samples_per_sec)
    result = by_rate[len(by_rate) // 2]
    print('Average sample read rate: {:.2f} samples/sec; RAM {:.2f} MB (rss); '
          'CPU {:.2f}%'.format(result.samples_per_sec, result.rss_mb,
                               result.cpu_percent))
    if len(results) > 1:
        rates = [r.samples_per_sec for r in by_rate]
        median = result.samples_per_sec
        print('Dispersion over {} runs: min {:.2f} / median {:.2f} / best '
              '{:.2f} samples/sec (spread {:.1f}%)'.format(
                  len(rates), rates[0], median, rates[-1],
                  100.0 * (rates[-1] - rates[0]) / median if median else 0.0))
    if args.diagnostics and result.diagnostics is not None:
        print('Pipeline telemetry (median run): {}'.format(
            json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in sorted(result.diagnostics.items())
                        # raw histogram states belong to /metrics scrapes;
                        # the derived *_p50_s/*_p99_s keys print here
                        if not k.startswith('_')})))
        if result.diagnosis is not None:
            # the same classification the watchdog / GET /healthz makes
            # (infeed_diagnosis over the snapshot + live heartbeats)
            print('Infeed diagnosis (median run): {}'.format(
                json.dumps(result.diagnosis, sort_keys=True)))
    if args.profile and result.profile is not None:
        from petastorm_tpu_torch.profiler import explain
        print('Roofline (median run): {}'.format(explain(result.profile)))
        print('Roofline profile: {}'.format(
            json.dumps(result.profile, sort_keys=True, default=str)))
    if slo and result.slo is not None:
        print('SLO verdict (median run): {}'.format(
            json.dumps(result.slo, sort_keys=True, default=str)))
    if args.autotune and result.autotune is not None:
        report = dict(result.autotune)
        report['actions'] = report.get('actions', [])[-10:]
        print('Autotune report (median run): {}'.format(
            json.dumps(report, sort_keys=True, default=str)))
    if args.audit and result.audit is not None:
        print('Coverage audit (median run): {}'.format(
            json.dumps(result.audit, sort_keys=True, default=str)))
    if args.trace:
        print('Chrome trace written to {} (open in https://ui.perfetto.dev)'
              .format(args.trace))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
