# Copied from floxer_tpu/pipeline.py: the host helpers of its pipeline
# (logging, index build or load, the host searcher, the per-query host
# path), without its jax paths.
"""Host helpers of the alignment pipeline (the port's pipeline.py drives
them): logger setup, index build or load with a per-process cache, the
native host searcher, PEX tree preparation, the per-query search, and the
reference engine's per-query search + verification + output
(parallelization.cpp:45-293)."""

from __future__ import annotations

import logging
import sys
import time

from .cli import CommandLineInput
from .index.fmindex import DEFAULT_SAMPLING_RATE, FmIndex
from .intervals import create_verified_intervals_per_reference
from .io import sequence_io
from .io.sam import AlignmentOutput
from .io.sequence_io import QueryRecord, References
from .ops.dp_reference import Orientation
from .output import write_alignments_for_query
from .pex import BuildStrategy, cached_pex_tree
from .search_host import (
    AnchorChoiceStrategy,
    AnchorGroupOrder,
    SearchConfig,
    Searcher,
)
from .stats import SearchAndAlignmentStatistics
from .verify import QueryAlignments, QueryVerifier, VerificationKind

logger = logging.getLogger("floxer-tpu")


def _pretty_elapsed_suffix(seconds: float) -> str:
    """' (MM:SS minutes)' for long durations (output.cpp:153-172 format);
    the numeric seconds stay in the message for machine consumers."""
    if seconds <= 60:
        return ""
    from .output import format_elapsed_time

    return f" ({format_elapsed_time(seconds)})"


def initialize_logger(logfile_path, console_debug_logs: bool) -> None:
    """Parity: output::initialize_logger (output.cpp:110-151). All diagnostics
    go to stderr; stdout stays empty (asserted by the reference's e2e test)."""
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    console = logging.StreamHandler(sys.stderr)
    console.setLevel(logging.DEBUG if console_debug_logs else logging.INFO)
    console.setFormatter(
        logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s")
    )
    logger.addHandler(console)
    if logfile_path:
        from logging.handlers import RotatingFileHandler

        file_handler = RotatingFileHandler(
            logfile_path, maxBytes=1024 * 1024 * 20, backupCount=5
        )
        file_handler.setLevel(logging.DEBUG)
        file_handler.setFormatter(
            logging.Formatter(
                "[thread %(thread)d] [%(asctime)s] [%(levelname)s] %(message)s"
            )
        )
        logger.addHandler(file_handler)


# (path, mtime, size) -> FmIndex; lets a long-lived server process (see
# server.py) skip re-loading an index file across jobs. Bounded: big
# indexes are the dominant memory object, keep at most two
_INDEX_CACHE: dict = {}


def _cache_index(cache_key, index) -> None:
    while len(_INDEX_CACHE) >= 2:
        _INDEX_CACHE.pop(next(iter(_INDEX_CACHE)))
    _INDEX_CACHE[cache_key] = index


def build_or_load_index(cli: CommandLineInput, references: References) -> FmIndex:
    """floxer.cpp:62-107: load the index if the file exists, otherwise build
    (sampling rate 4) and save it when an index path was given."""
    import os

    if cli.index_path and os.path.exists(cli.index_path):
        stat = os.stat(cli.index_path)
        cache_key = (os.path.abspath(cli.index_path), stat.st_mtime, stat.st_size)
        cached = _INDEX_CACHE.get(cache_key)
        if cached is not None:
            logger.info("reusing cached index for %s", cli.index_path)
            return cached
        logger.info("loading index from %s", cli.index_path)
        index = FmIndex.load(cli.index_path)
        # force the v3 artifact's lazily-memmapped SA samples to
        # materialize NOW, inside the load phase — otherwise the first
        # chunk's locate pays it inside the align phase (measured ~5.5 s
        # at 500 Mb genome scale, ~20 s projected at hg38) and stalls the
        # pipeline's first search stage
        index.sampled_rows
        _cache_index(cache_key, index)
        return index

    logger.info("building index")
    started = time.monotonic()
    index = FmIndex(
        [record.rank_sequence for record in references.records],
        sampling_rate=DEFAULT_SAMPLING_RATE,
    )
    build_elapsed = time.monotonic() - started
    logger.info(
        "building index took %.2f seconds%s",
        build_elapsed,
        _pretty_elapsed_suffix(build_elapsed),
    )
    if cli.index_path:
        logger.info("saving index to %s", cli.index_path)
        try:
            index.save(cli.index_path)
            stat = os.stat(cli.index_path)
            _cache_index(
                (os.path.abspath(cli.index_path), stat.st_mtime, stat.st_size),
                index,
            )
        except Exception as error:  # noqa: BLE001 - parity: warn and continue
            logger.warning(
                "An error occured while trying to write the index to the "
                "file %s. Continuing without saving the index. %s",
                cli.index_path,
                error,
            )
    return index


def make_searcher(cli: CommandLineInput, index: FmIndex, num_references: int):
    searcher = Searcher(
        index=index,
        num_reference_sequences=num_references,
        config=SearchConfig(
            max_num_anchors_hard=cli.max_num_anchors_hard,
            max_num_anchors_soft=cli.max_num_anchors_soft,
            anchor_group_order=AnchorGroupOrder(cli.anchor_group_order),
            anchor_choice_strategy=AnchorChoiceStrategy(cli.anchor_choice_strategy),
            erase_useless_anchors=not cli.dont_erase_useless_anchors,
        ),
        num_threads=cli.num_threads,
    )
    # the device searchers wrap this one in the port's pipeline.py, in
    # the reference's order: --index-shards > 1 first (the sharded
    # searcher), then --device-search (a DeviceSearcher)
    return searcher


def prepare_query_tree(query: QueryRecord, cli: CommandLineInput):
    """PEX tree + seeds for one query (pure function of length/config)."""
    query_num_errors = sequence_io.num_errors_from_config(
        len(query.rank_sequence),
        cli.query_num_errors,
        cli.query_error_probability,
    )
    strategy = (
        BuildStrategy.BOTTOM_UP
        if cli.bottom_up_pex_tree_building
        else BuildStrategy.RECURSIVE
    )
    pex_tree = cached_pex_tree(
        len(query.rank_sequence),
        query_num_errors,
        cli.pex_seed_num_errors,
        strategy,
    )
    seeds = pex_tree.generate_seeds(cli.seed_sampling_step_size)
    return pex_tree, seeds


def search_query_pure(
    query: QueryRecord, cli: CommandLineInput, searcher: Searcher
):
    """Search stage for one query without stats side effects: PEX tree,
    seeds, fwd+rc FM search (parallelization.cpp:91-101). Thread-safe — the
    native search releases the GIL, so chunks parallelize across
    --threads host workers."""
    search_started = time.monotonic()

    pex_tree, seeds = prepare_query_tree(query, cli)

    forward_result = searcher.search_seeds(seeds, query.rank_sequence)
    rc_result = searcher.search_seeds(
        seeds, query.reverse_complement_rank_sequence
    )
    elapsed_ms = int((time.monotonic() - search_started) * 1000)
    return pex_tree, seeds, forward_result, rc_result, elapsed_ms


def _apply_search_stats(
    query, seeds, forward_result, rc_result, elapsed_ms, stats
):
    stats.add_query_length(len(query.rank_sequence))
    stats.add_statistics_for_seeds(seeds, seeds)
    stats.add_statistics_for_search_result(forward_result, rc_result)
    stats.add_milliseconds_spent_in_search_per_query(elapsed_ms)


def search_query(
    query: QueryRecord,
    cli: CommandLineInput,
    searcher: Searcher,
    stats: SearchAndAlignmentStatistics,
):
    """Search stage for one query: PEX tree, seeds, fwd+rc FM search, stats
    (parallelization.cpp:91-116)."""
    pex_tree, seeds, forward_result, rc_result, elapsed_ms = search_query_pure(
        query, cli, searcher
    )
    _apply_search_stats(
        query, seeds, forward_result, rc_result, elapsed_ms, stats
    )
    return pex_tree, forward_result, rc_result


def process_query(
    query: QueryRecord,
    cli: CommandLineInput,
    references: References,
    searcher: Searcher,
    output: AlignmentOutput,
    stats: SearchAndAlignmentStatistics,
) -> None:
    """One query through search + verification + output; mirrors the combined
    search/verification task bodies (parallelization.cpp:56-161, 198-281)."""
    pex_tree, forward_result, rc_result = search_query(
        query, cli, searcher, stats
    )

    verification_started = time.monotonic()
    kind = (
        VerificationKind.DIRECT_FULL
        if cli.direct_full_verification
        else VerificationKind.HIERARCHICAL
    )
    alignments = QueryAlignments(len(references.records))

    for orientation, result in (
        (Orientation.FORWARD, forward_result),
        (Orientation.REVERSE_COMPLEMENT, rc_result),
    ):
        oriented_query = (
            query.rank_sequence
            if orientation == Orientation.FORWARD
            else query.reverse_complement_rank_sequence
        )
        verified_intervals = create_verified_intervals_per_reference(
            len(references.records), cli.use_interval_optimization
        )
        # anchors are grouped into packages of --num-anchors-per-task, the
        # reference's verification-task granularity (create_anchor_packages,
        # parallelization.cpp:14-43; search.cpp:111-141). Executed here in
        # package order on one thread, so the boundary is output-neutral —
        # exactly as it is in the reference, where it only sets how many
        # anchors one pool task carries.
        anchors = list(result.iter_anchors())
        package_size = max(1, cli.num_anchors_per_verification_task)
        packages = [
            anchors[base : base + package_size]
            for base in range(0, len(anchors), package_size)
        ]
        for package in packages:
            for anchor in package:
                verifier = QueryVerifier(
                    pex_tree=pex_tree,
                    anchor=anchor,
                    pex_leaf_node=pex_tree.leaves[anchor.pex_leaf_index],
                    query=oriented_query,
                    orientation=orientation,
                    reference=references.records[anchor.reference_id],
                    kind=kind,
                    already_verified_intervals=verified_intervals[
                        anchor.reference_id
                    ],
                    extra_verification_ratio=cli.extra_verification_ratio,
                    without_cigar=cli.without_cigar,
                    alignments=alignments,
                    stats=stats,
                )
                verifier.verify()

    stats.add_num_alignments(alignments.size())
    stats.add_milliseconds_spent_in_verification_per_query(
        int((time.monotonic() - verification_started) * 1000)
    )
    for per_reference in alignments.per_reference:
        for alignment in per_reference:
            stats.add_alignment_edit_distance(alignment.num_errors)

    write_alignments_for_query(output, query, alignments, references.records)
