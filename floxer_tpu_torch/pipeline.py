"""End-to-end alignment pipeline of the port.

Counterpart of floxer_tpu/pipeline.py. Reading, index build or load, the
native scheme search, anchor choice, tracebacks and SAM/BAM writing are
this package's copies of the reference's jax-free host code (the
pipeline's own host helpers are in pipeline_host.py). What this module
carries is the device wiring of the batched engines: the device
choice, the resident reference bank (cached across a server's jobs), the
warmup that builds the CUDA kernels off the align loop, the verifier of
this package, --profile through torch.profiler, and the multi-process run
(parallel/: the process set on torch.distributed's gloo, the strided
query shards and process 0's merge of the shard outputs).

Stdout stays empty; all logs go to stderr (and the optional log file).
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time

import numpy as np
import torch

from . import tracing
from .backend import accelerator_available, cpu_requested
from .cli import CommandLineInput
from .io.sam import AlignmentOutput
from .io.sequence_io import Queries, read_references
from .output import write_alignments_for_query
from .pipeline_host import (
    _apply_search_stats,
    _pretty_elapsed_suffix,
    build_or_load_index,
    initialize_logger,
    make_searcher,
    prepare_query_tree,
    process_query,
    search_query_pure,
)
from .stats import SearchAndAlignmentStatistics
from .verify import VerificationKind

logger = logging.getLogger("floxer-tpu")

def kernel_launches() -> dict[str, int]:
    """Launches of the CUDA kernels K1-K4 and K9-K13 in this process so
    far (the wrappers count only launches on the card); K11 counts its
    instance over the index, K11s the one over the sharded index."""
    from .ops import (
        cuda_fm_index,
        cuda_frontier,
        cuda_myers,
        cuda_myers_banded,
        cuda_myers_large,
        cuda_search_queue,
        cuda_select,
        cuda_sharded,
        traceback_device,
    )

    return {
        "K1": cuda_myers_banded.launches(),
        "K2": cuda_myers.LAUNCHES,
        "K3": cuda_myers_large.launches(),
        "K4": traceback_device.LAUNCHES,
        "K9": cuda_fm_index.RANK_LAUNCHES,
        "K9x": cuda_fm_index.EXTEND_LAUNCHES,
        "K9l": cuda_fm_index.LOCATE_LAUNCHES,
        "K10": cuda_search_queue.LAUNCHES,
        "K11": cuda_frontier.LAUNCHES,
        "K11s": cuda_frontier.SHARDED_LAUNCHES,
        "K12": cuda_select.LAUNCHES,
        "K13": cuda_sharded.RANK_LAUNCHES,
        "K13l": cuda_sharded.LOCATE_LAUNCHES,
    }


def warm_kernels(device: torch.device) -> None:
    """Build the kernels and launch each once on a tiny task, so the
    one-time costs (nvcc, CUDA context, module load) are paid here."""
    from .ops.cuda_myers import myers_small_host
    from .ops.cuda_myers_banded import myers_banded_host
    from .ops.cuda_myers_large import myers_large_host

    text = np.tile(np.arange(1, 5, dtype=np.uint8), 80)[None, :]  # [1, 320]
    length = np.full(1, text.shape[1], dtype=np.int32)
    myers_banded_host(
        [text[0, :16]], text, length, np.ones(1, dtype=np.int64), 32, device
    )
    myers_small_host(text[:, :16], np.full(1, 16), text, length, device)
    myers_large_host(text[:, :300], np.full(1, 300), text, length, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_search_kernels(device: torch.device) -> None:
    """Launch the device search's kernels once on the index of a tiny
    text: K9 (a rank), K10 (one seed), K11 (one seed's frontier) and K12
    (its groups' selection)."""
    from .index.device_index import DeviceIndex, rank_all
    from .index.fmindex import FmIndex
    from .schemes import expand_scheme
    from .search_device import SchemeTables, search_seeds_device
    from .search_queue import workqueue_runner
    from .search_select_device import device_select_from_groups_batch

    text = np.tile(np.arange(1, 5, dtype=np.uint8), 64)
    index = DeviceIndex.from_host(FmIndex([text]), device)
    rank_all(index.fwd, torch.arange(8, dtype=torch.int32, device=device))
    tables = SchemeTables.from_length_classes([expand_scheme(1, 16)])
    workqueue_runner(
        index, text[None, :16].astype(np.int32), np.zeros(1, np.int32),
        tables, 1 << 12, 16, 1,
    )
    groups, totals, _, _ = search_seeds_device(
        index, [text[:16]], 1, expand_scheme(1, 16)
    )
    flat = np.asarray(groups[0], dtype=np.int64).reshape(-1, 4)
    device_select_from_groups_batch(
        index, flat, np.array([0, flat.shape[0]]), totals,
        np.zeros(1, np.int64), 500, 50, 0, 0, True,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm_verification(device: torch.device) -> None:
    from .verify_batch import _device_call_overhead

    warm_kernels(device)
    # prime the router's round-trip probe off the align loop
    _device_call_overhead(device)


class _DeviceWarmup:
    """Builds and warms kernels on a daemon thread, so the one-time
    costs overlap the reference read, the index build and the first
    search instead of stalling the first verification wave. Started once
    per process; ready() is the non-blocking readiness probe the batched
    engine routes on, and re-raises a failed build."""

    def __init__(self, warm=_warm_verification):
        self._warm_device = warm
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._error: BaseException | None = None
        self._done = False

    def start(self, device: torch.device) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._warm, args=(device,), name="device-warmup",
                daemon=True,
            )
            self._thread.start()

    def _warm(self, device: torch.device) -> None:
        try:
            started = time.monotonic()
            self._warm_device(device)
            logger.debug(
                "device warmup complete in %.2fs", time.monotonic() - started
            )
        except Exception as error:  # noqa: BLE001 - re-raised by ready()
            self._error = error
        self._done = True

    def join(self, timeout: float | None = None) -> None:
        """Wait for the warmup; re-raise its failure."""
        if self._thread is not None:
            started = time.monotonic()
            self._thread.join(timeout)
            logger.debug(
                "waited %.1fs for device warmup", time.monotonic() - started
            )
        self._raise_failure()

    def ready(self) -> bool:
        """True once the warmup finished; never blocks."""
        self._raise_failure()
        return self._done

    def _raise_failure(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                f"device warmup (CUDA kernel build) failed: {self._error}"
            ) from self._error


_WARMUP = _DeviceWarmup()
# the device search's kernels, warmed once per process by the first
# --device-search run
_SEARCH_WARMUP = _DeviceWarmup(warm_search_kernels)


def start_device_warmup(device: torch.device,
                        device_search: bool = False) -> None:
    _WARMUP.start(device)
    if device_search:
        _SEARCH_WARMUP.start(device)


def join_device_warmup(timeout: float | None = None) -> None:
    _WARMUP.join(timeout)
    _SEARCH_WARMUP.join(timeout)


def _accelerator_ready() -> bool:
    """Non-blocking readiness for the batched engine's routing: waves go
    to the native host engine until the warmup has built the kernels."""
    return _WARMUP.ready()


# set by server.serve(): the process hosts many jobs, so the resident
# reference bank is cached across them
_PERSISTENT_PROCESS = False
# server-process cache of the device-resident reference bank, keyed by the
# reference file's identity (path, size, mtime) and the device: jobs
# against the same genome reuse the uploaded bank instead of uploading it
# again. One entry: device memory holds one genome at a time. A cached bank
# holds no host copy of the genome once uploaded (ResidentBank drops it).
_RESIDENT_BANK_CACHE: dict = {}


def _get_resident_bank(cli, references, device: torch.device):
    """The run's resident reference bank; its packed upload happens on
    first use (ops/resident.py), and it drops its host copy then. In a
    server process the bank is cached and uploaded in the background once
    the kernels are built."""
    from .ops.resident import ResidentBank

    key = None
    try:
        stat = os.stat(cli.reference_path)
        key = (
            str(cli.reference_path), stat.st_size, stat.st_mtime_ns,
            str(device),
        )
    except OSError:
        pass
    if key is not None and key in _RESIDENT_BANK_CACHE:
        logger.debug("resident reference bank: cache hit (%s)", key[0])
        return _RESIDENT_BANK_CACHE[key]
    bank = ResidentBank(
        [record.rank_sequence for record in references.records], device
    )
    if key is not None and _PERSISTENT_PROCESS:
        _RESIDENT_BANK_CACHE.clear()
        _RESIDENT_BANK_CACHE[key] = bank

        def preload() -> None:
            try:
                join_device_warmup(timeout=600)
                bank.flat
                logger.debug("resident bank preloaded to %s", device)
            except Exception as error:  # noqa: BLE001 - the align loop's
                # own upload raises it again where it matters
                logger.debug("resident bank preload failed: %s", error)

        threading.Thread(
            target=preload, name="bank-preload", daemon=True
        ).start()
    return bank


def _start_profiler(device):
    """torch.profiler over the alignment phase: CPU activity, plus CUDA
    activity when the run has a CUDA device. Where this torch can, it
    records every thread's host ops, so the search worker's, the finalize
    thread's and the traceback pool's ops and spans are in the trace
    beside the pipeline's."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    options = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        options["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True
        )
    except (ImportError, TypeError):
        pass
    profiler = profile(activities=activities, **options)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str) -> None:
    """Stop the profiler and write its Chrome trace under profile_dir."""
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"floxer_tpu_torch_{os.getpid()}.json")
    profiler.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def verify_and_write_chunk(
    chunk,
    searched,
    cli: CommandLineInput,
    references,
    output: AlignmentOutput,
    stats: SearchAndAlignmentStatistics,
    use_device,
    resident_ref=None,
    defer_finalize: bool = False,
    deadline_check=None,
    device=None,
):
    """Verification + output for a chunk whose search results are ready.

    With defer_finalize=True the heavy synchronous part (wave loop, device
    kernels) runs here, but root CIGAR tracebacks stay in flight on the
    traceback pool and ALL stats/output writing is packaged into the
    returned zero-arg closure — the caller runs closures in chunk order on
    a single finalize thread. Copied from floxer_tpu/pipeline.py with the
    port's verifier, an explicit use_device and the verifier's device
    (bucketed batcher calls and device tracebacks)."""
    from .verify_batch import BatchVerifier, _QueryItem

    items = []
    for query, (pex_tree, seeds, forward_result, rc_result, ms) in zip(
        chunk, searched
    ):
        items.append(_QueryItem(query, pex_tree, forward_result, rc_result))

    verification_started = time.monotonic()
    verifier = BatchVerifier(
        references.records,
        kind=(
            VerificationKind.DIRECT_FULL
            if cli.direct_full_verification
            else VerificationKind.HIERARCHICAL
        ),
        extra_verification_ratio=cli.extra_verification_ratio,
        without_cigar=cli.without_cigar,
        use_interval_optimization=cli.use_interval_optimization,
        use_device=use_device,
        resident_ref=resident_ref,
        defer_finalize=defer_finalize,
        deadline_check=deadline_check,
        device=device,
    )
    all_alignments = verifier.process(items)
    verification_ms = int((time.monotonic() - verification_started) * 1000)

    def complete() -> None:
        with tracing.span("finalize.tracebacks"):
            verifier.resolve_deferred()
        with tracing.span("finalize.write"):
            write()

    def write() -> None:
        soa = all(
            hasattr(entry[2], "kept_useful")
            and hasattr(entry[3], "kept_useful")
            for entry in searched
        )
        if soa and searched:
            stats.add_search_statistics_for_chunk(
                [
                    (len(query.rank_sequence), seeds, fwd, rc)
                    for query, (_, seeds, fwd, rc, _) in zip(chunk, searched)
                ],
                search_ms=searched[0][4],
            )
        else:
            for query, (pex_tree, seeds, forward_result, rc_result, ms) in zip(
                chunk, searched
            ):
                _apply_search_stats(
                    query, seeds, forward_result, rc_result, ms, stats
                )
        for kind, value in verifier.last_stats_events:
            if kind == "aligned_root":
                stats.add_reference_span_size_aligned_root(value)
            elif kind == "aligned_inner":
                stats.add_reference_span_size_aligned_inner_node(value)
            elif kind == "avoided_root":
                stats.add_reference_span_size_avoided_root(value)
        stats.add_reference_span_sizes_avoided_root_many(
            verifier.last_avoided_lengths
        )

        per_query_ms = verification_ms // max(len(chunk), 1)
        sizes = []
        edit_distances = []
        for query, alignments in zip(chunk, all_alignments):
            sizes.append(alignments.size())
            for per_reference in alignments.per_reference:
                for alignment in per_reference:
                    edit_distances.append(alignment.num_errors)
            write_alignments_for_query(
                output, query, alignments, references.records
            )
        stats.histograms["alignments per query"].add_values(
            np.asarray(sizes, dtype=np.int64)
        )
        stats.histograms[
            "milliseconds spent in verification per query"
        ].add_values(np.full(len(chunk), per_query_ms, dtype=np.int64))
        stats.histograms["alignments edit distance"].add_values(
            np.asarray(edit_distances, dtype=np.int64)
        )

    if defer_finalize:
        return complete
    complete()
    return None


def run(
    cli: CommandLineInput,
    device: torch.device | None = None,
    use_device=None,
    extra_log_handler=None,
) -> int:
    """Main driver; mirrors floxer_tpu.pipeline.run (src/main/floxer.cpp).

    device: where device work runs (fused waves, bucketed batcher calls,
    device tracebacks, the device and sharded seed searches). None picks
    CUDA device 0 when it is a Hopper GPU, and the CPU when
    FLOXER_TPU_PLATFORM=cpu; a CPU device runs that work through the
    kernels' plain versions (tests). use_device: None takes the CLI's choice (--engine device:
    True; --engine batched: the warmup's readiness probe, so waves route by
    the cost model once the kernels are built); False keeps every wave on
    the host engines. extra_log_handler: a logging.Handler attached for
    this run (the server mirrors a job's logs to its client with it)."""
    if getattr(cli, "cprofile_path", None):
        import cProfile

        path = cli.cprofile_path
        cli.cprofile_path = None
        profiler = cProfile.Profile()
        try:
            return profiler.runcall(
                run, cli, device, use_device, extra_log_handler
            )
        finally:
            cli.cprofile_path = path
            profiler.dump_stats(path)
            logger.info("cProfile written to %s", path)

    # the run is one traced job (inside a server job, that job); with
    # tracing on, its `trace spans:` line is logged at its end
    with tracing.job(on=bool(cli.profile_dir), emit=_log_trace_line):
        return _run_logged(cli, device, use_device, extra_log_handler)


def _log_trace_line(line: str) -> None:
    logger.info("%s", line)


def _run_logged(cli, device, use_device, extra_log_handler) -> int:
    initialize_logger(cli.logfile_path, cli.console_debug_logs)
    if extra_log_handler is not None:
        logger.addHandler(extra_log_handler)
    # multi-process execution: with JAX_COORDINATOR_ADDRESS set, join the
    # process set before any device work and derive the query shard from
    # it; explicit --num-hosts/--host-id still override (file-level
    # sharded workflows)
    from .parallel.collectives import (
        ProcessSetError,
        leave_process_set,
        maybe_initialize_distributed,
    )

    try:
        process_index, process_count = maybe_initialize_distributed()
    except ProcessSetError as error:
        logger.error("%s", error)
        return -1
    try:
        return _run(cli, device, use_device, process_index, process_count)
    finally:
        leave_process_set()


def _run(cli, device, use_device, process_index, process_count) -> int:
    """run() once the process set is joined (a single process is rank 0
    of 1)."""
    distributed = process_count > 1
    if distributed and cli.num_hosts == 1:
        cli.num_hosts = process_count
        cli.host_id = process_index
    warming = False
    if device is None and cpu_requested():
        # FLOXER_TPU_PLATFORM=cpu: the CPU where cuda:0 would be taken
        device = torch.device("cpu")
    # the seed search on the device: --device-search, or the sharded index
    # (whose frontier search runs on the device under every engine, as
    # the reference's does)
    sharded = cli.index_shards > 1
    search_on_device = cli.device_search or sharded
    search_option = "--index-shards" if sharded else "--device-search"
    if cli.engine == "reference" and search_on_device:
        # the per-query frontier search on the device (K11 on the card)
        if device is None and accelerator_available():
            device = torch.device("cuda", 0)
        if device is None:
            logger.error(
                "%s runs the seed search on a CUDA device of compute "
                "capability >= 9.0 (Hopper); none is available",
                search_option,
            )
            return -1
        if device.type == "cuda":
            _SEARCH_WARMUP.start(device)
    if cli.engine in ("device", "batched"):
        if device is None and accelerator_available():
            device = torch.device("cuda", 0)
        if device is None and cli.engine == "device":
            logger.error(
                "--engine device needs a CUDA device of compute capability "
                ">= 9.0 (Hopper); none is available"
            )
            return -1
        from .verify_batch import device_tracebacks_requested

        if device is None and device_tracebacks_requested():
            logger.error(
                "FLOXER_TPU_DEVICE_TRACEBACK=1 runs the root tracebacks on "
                "a CUDA device of compute capability >= 9.0 (Hopper); none "
                "is available"
            )
            return -1
        if use_device is None:
            if cli.engine == "device":
                use_device = True
            elif device is not None and device.type == "cuda":
                use_device = _accelerator_ready
            else:
                use_device = False
        if device is None and search_on_device:
            logger.error(
                "%s runs the seed search on a CUDA device of compute "
                "capability >= 9.0 (Hopper); none is available",
                search_option,
            )
            return -1
        if use_device is not False and device is None:
            logger.error("device verification needs a device")
            return -1
        warming = device is not None and device.type == "cuda" and (
            use_device is not False or search_on_device
        )
        if warming:
            # build and warm the kernels NOW, while the reference read,
            # index build and first search keep the host busy
            start_device_warmup(device, search_on_device)
    logger.info("successfully parsed CLI input ... starting")
    logger.debug("command line call: %s", cli.command_line_call())

    try:
        with tracing.span("job.reference"):
            references = read_references(cli.reference_path)
    except Exception as error:  # noqa: BLE001
        logger.error(
            "An error occured while trying to read the reference from the "
            "file %s. %s",
            cli.reference_path,
            error,
        )
        return -1

    try:
        with tracing.span("job.index"):
            index = build_or_load_index(cli, references)
    except Exception as error:  # noqa: BLE001 - parity: floxer.cpp:70-80
        logger.error(
            "An error occured while trying to load or build the index. %s",
            error,
        )
        return -1
    with tracing.span("job.searcher"):
        searcher = make_searcher(cli, index, len(references.records))
        if sharded:
            # the row-sharded index, as the reference routes it (before
            # --device-search): frontier searches over the shard tables
            # (K11 over K13's rank) under every engine
            from .search_device import make_sharded_searcher

            searcher = make_sharded_searcher(searcher, index,
                                             cli.index_shards, device)
        elif cli.device_search:
            # the seed search on the device: the work queue (K10) under
            # the batched engines, the per-query frontier (K11) under
            # --engine reference
            from .index.device_index import DeviceIndex
            from .search_device import DeviceSearcher

            searcher = DeviceSearcher(searcher,
                                      DeviceIndex.from_host(index, device))

    # distributed runs write per-process shard files (extension preserved
    # so the SAM/BAM writer selection is unchanged); process 0 merges the
    # canonical output after the post-align barrier below
    if distributed:
        from .parallel.multihost import shard_output_path

        effective_output_path = shard_output_path(cli.output_path, cli.host_id)
    else:
        effective_output_path = cli.output_path

    # checkpoint/resume: a progress cursor on the (sharded) query stream
    progress_path = f"{effective_output_path}.progress"
    skip = 0
    if cli.resume and os.path.exists(progress_path):
        try:
            with open(progress_path) as handle:
                skip = int(handle.read().strip() or 0)
        except ValueError:
            skip = 0
        if skip:
            logger.info("resuming: skipping %d already-processed queries", skip)

    output = AlignmentOutput(
        effective_output_path,
        references.records,
        append=cli.resume and skip > 0,
    )
    stats = SearchAndAlignmentStatistics(cli.stats_input_hint)

    queries_stream = Queries(
        cli.queries_path,
        cli.query_num_errors,
        cli.query_error_probability,
        cli.pex_seed_num_errors,
    )
    if cli.num_hosts > 1:
        from .parallel.multihost import shard_queries

        queries = shard_queries(queries_stream, cli.host_id, cli.num_hosts)
    else:
        queries = iter(queries_stream)
    num_processed = 0
    if skip:
        queries = itertools.islice(queries, skip, None)
        num_processed = skip

    def record_progress() -> None:
        with open(progress_path, "w") as handle:
            handle.write(f"{num_processed}\n")

    if cli.engine == "device" and warming:
        # the kernels must be built before the first wave
        try:
            join_device_warmup()
        except RuntimeError as error:
            logger.error("%s", error)
            return -1

    # the batched engines' chunk stages, each a span of the job: the
    # search (search.chunk, on the search worker), the wave loop
    # (verify.chunk) and the finalize stage (finalize.chunk, on the
    # finalize thread); the seed search proper is search.host, or
    # search.device for a device searcher
    search_span = getattr(searcher, "trace_name", "search.host")

    def next_chunk():
        chunk = []
        with tracing.span("pipeline.read_queries"):
            for query in queries:
                chunk.append(query)
                if len(chunk) >= cli.batch_size:
                    break
        return chunk

    def search_chunk(chunk):
        with tracing.span("search.chunk", reads=len(chunk)):
            return search_chunk_seeds(chunk)

    def search_chunk_seeds(chunk):
        started = time.monotonic()
        many = getattr(searcher, "search_seeds_many", None)
        if many is None:
            with tracing.span(search_span):
                result = [
                    search_query_pure(query, cli, searcher)
                    for query in chunk
                ]
        else:
            # chunk-level batched search: every query's fwd+rc seeds in
            # one native call per seed class; per-query search ms is
            # chunk-averaged
            prepared = []
            jobs = []
            with tracing.span("search.prepare"):
                for query in chunk:
                    pex_tree, seeds = prepare_query_tree(query, cli)
                    prepared.append((pex_tree, seeds))
                    jobs.append((seeds, query.rank_sequence))
                    jobs.append(
                        (seeds, query.reverse_complement_rank_sequence)
                    )
            with tracing.span(search_span):
                searched = many(jobs)
            elapsed_ms = int((time.monotonic() - started) * 1000) // max(
                len(chunk), 1
            )
            result = [
                (
                    pex_tree,
                    seeds,
                    searched[2 * i],
                    searched[2 * i + 1],
                    elapsed_ms,
                )
                for i, (pex_tree, seeds) in enumerate(prepared)
            ]
        logger.debug(
            "search chunk: %d queries in %.2fs",
            len(chunk),
            time.monotonic() - started,
        )
        return result

    def finalize_chunk(complete, reads):
        with tracing.span("finalize.chunk", reads=reads):
            return complete()

    logger.info(
        "aligning queries against %d references and writing output file to %s",
        len(references.records),
        cli.output_path,
    )
    aligning_started = time.monotonic()
    launches_before = kernel_launches()
    # torch.profiler trace of the alignment phase (the reference traces it
    # with jax.profiler); stopped on every exit path below
    profiler = (
        _start_profiler(device) if cli.profile_dir else None
    )
    try:
        timed_out = False

        def hit_timeout() -> bool:
            return (
                cli.timeout_seconds is not None
                and time.monotonic() - aligning_started > cli.timeout_seconds
            )

        failed = False
        batched = cli.engine != "reference"
        with tracing.span("align"):
            if not batched:
                try:
                    for query in queries:
                        if hit_timeout():
                            timed_out = True
                            break
                        process_query(query, cli, references, searcher,
                                      output, stats)
                        num_processed += 1
                        record_progress()
                except Exception as error:  # noqa: BLE001 - parity with
                    # the reference's task-level abort
                    # (parallelization.cpp:149-157)
                    logger.error(
                        "An error occurred while reading/searching/verifying "
                        "a query. Shutting down. The output file is likely "
                        "incomplete. Error message: %s",
                        error,
                    )
                    failed = True
            else:
                # double-buffered pipeline: the host searches chunk N+1 on a
                # worker thread (the native search releases the GIL) while
                # chunk N verifies, and a single finalize worker writes
                # chunk N-1
                from concurrent.futures import ThreadPoolExecutor

                from .verify_batch import VerificationTimeout

                resident_ref = None
                if use_device is not False:
                    with tracing.span("job.bank"):
                        resident_ref = _get_resident_bank(cli, references,
                                                          device)
                with ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="search") \
                        as pool, \
                        ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="finalize") \
                        as finalize_pool:
                    pending = None
                    finalizing = None  # (chunk_len, future)
                    try:
                        while not timed_out:
                            chunk = next_chunk()
                            future = (
                                tracing.submit(pool, search_chunk, chunk)
                                if chunk else None
                            )
                            if pending is not None:
                                prev_chunk, prev_future = pending
                                try:
                                    # verify= of the stage split: the wait for
                                    # this chunk's search, then its wave loop
                                    with tracing.span("verify.chunk",
                                                      reads=len(prev_chunk)):
                                        with tracing.span(
                                            "pipeline.wait_search"
                                        ):
                                            searched = prev_future.result()
                                        complete = verify_and_write_chunk(
                                            prev_chunk,
                                            searched,
                                            cli,
                                            references,
                                            output,
                                            stats,
                                            use_device=use_device,
                                            resident_ref=resident_ref,
                                            defer_finalize=True,
                                            deadline_check=hit_timeout,
                                            device=device,
                                        )
                                except VerificationTimeout:
                                    # per-wave timeout check: drop the
                                    # in-flight chunk, output stays
                                    # truncated like the reference's
                                    timed_out = True
                                    if future is not None:
                                        future.cancel()
                                    break
                                if finalizing is not None:
                                    done_len, done_future = finalizing
                                    with tracing.span(
                                        "pipeline.wait_finalize"
                                    ):
                                        done_future.result()
                                    num_processed += done_len
                                    record_progress()

                                finalizing = (
                                    len(prev_chunk),
                                    tracing.submit(
                                        finalize_pool, finalize_chunk,
                                        complete, len(prev_chunk),
                                    ),
                                )
                            if not chunk:
                                break
                            if hit_timeout():
                                timed_out = True
                                future.cancel()
                                break
                            pending = (chunk, future)
                        if finalizing is not None:
                            done_len, done_future = finalizing
                            with tracing.span("pipeline.wait_finalize"):
                                done_future.result()
                            num_processed += done_len
                            record_progress()
                            finalizing = None
                    except Exception as error:  # noqa: BLE001 - see the
                        # reference-engine branch above
                        logger.error(
                            "An error occurred during batched alignment. "
                            "Shutting down. The output file is likely "
                            "incomplete. Error message: %s",
                            error,
                        )
                        logger.debug(
                            "batched alignment failure traceback:",
                            exc_info=True,
                        )
                        failed = True

        if timed_out:
            logger.warning(
                "Timeout happened. Shutting down now. The output file might "
                "be incomplete."
            )

        with tracing.span("job.close"):
            output.close()
    finally:
        if profiler is not None:
            _stop_profiler(profiler, cli.profile_dir)
    if warming:
        # a batched run may finish before the warmup; a failed kernel
        # build fails the run either way
        try:
            join_device_warmup()
        except RuntimeError as error:
            logger.error("%s", error)
            failed = True

    # launches= counts the CUDA kernel launches of this run (in a server:
    # of this job)
    launches = {
        name: count - launches_before[name]
        for name, count in kernel_launches().items()
    }
    job = tracing.current()
    if job is not None:
        job.launches = launches
    if timed_out or failed:
        return -1

    # a completed run needs no resume cursor
    if os.path.exists(progress_path):
        os.remove(progress_path)

    align_elapsed = time.monotonic() - aligning_started
    logger.info(
        "finished aligning successfully in %.2f seconds%s",
        align_elapsed,
        _pretty_elapsed_suffix(align_elapsed),
    )
    if batched and job is not None:
        # machine-parsable per-stage attribution from the job's span sums.
        # Stages overlap, so the sums can exceed the align wall;
        # device_kernel is the unhidden device wait observed by the wave
        # loop this run (verify.device_wait)
        logger.info(
            "stage split: search=%.2fs verify=%.2fs finalize=%.2fs "
            "device_kernel=%.2fs fused_dispatches=%d launches=%s",
            job.seconds("search.chunk"),
            job.seconds("verify.chunk"),
            job.seconds("finalize.chunk"),
            job.seconds("verify.device_wait"),
            job.counter("verify.fused_dispatches"),
            ",".join(f"{name}:{count}" for name, count in launches.items()),
        )

    if distributed:
        # cross-process stats merge, then a barrier so every shard file is
        # closed before process 0 interleaves the canonical output; fd 1
        # goes to stderr around the first collective (gloo may print as
        # its context forms, and stdout stays empty)
        from .parallel.collectives import (
            allreduce_stats,
            barrier,
            stdout_to_stderr,
        )
        from .parallel.multihost import (
            merge_bam_shards,
            merge_sam_shards,
            shard_output_path,
        )

        with stdout_to_stderr():
            stats.apply_merged_arrays(
                *allreduce_stats(*stats.to_merge_arrays())
            )
            barrier()
        if process_index == 0:
            shard_paths = [
                shard_output_path(cli.output_path, h)
                for h in range(process_count)
            ]
            merge = (
                merge_sam_shards
                if cli.output_path.endswith(".sam")
                else merge_bam_shards
            )
            merged = merge(shard_paths, cli.output_path)
            logger.info(
                "merged %d queries from %d shards into %s",
                merged, process_count, cli.output_path,
            )
        else:
            # one canonical stats report: only process 0 emits
            return 0

    if cli.stats_target is not None:
        with tracing.span("job.close"):
            if cli.stats_target == "terminal":
                for line in stats.format_for_terminal():
                    logger.info("%s", line)
            else:
                with open(cli.stats_target, "w") as handle:
                    handle.write(stats.format_as_toml())

    return 0
