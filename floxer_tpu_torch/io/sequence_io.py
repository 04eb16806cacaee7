# Copied from floxer_tpu/io/sequence_io.py; relative imports resolve to this package's copies.
"""FASTA/FASTQ streaming readers and the query/reference record types.

Parity target: src/lib/input.cpp (replaces ivio). Gzip transparently
supported by extension. Skip rules match the reference exactly:

  - empty sequences are skipped with a warning (input.cpp:47-54 / 95-101)
  - queries longer than 100'000 bp are skipped (input.hpp:42, input.cpp:106)
  - queries whose configured error count makes alignment meaningless are
    skipped: length <= num_errors or num_errors < seed errors
    (input.cpp:114-129)
  - record id = header tag up to the first space (input.cpp:161-163)
"""

from __future__ import annotations

import gzip
import logging
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..alphabet import chars_to_ranks, reverse_complement
from ..utils.mathutils import float_aware_ceil

logger = logging.getLogger("floxer-tpu")

MAX_ALLOWED_QUERY_LENGTH = 100_000


@dataclass
class ReferenceRecord:
    id: str
    rank_sequence: np.ndarray
    internal_id: int


@dataclass
class References:
    records: list[ReferenceRecord]
    total_sequence_length: int


@dataclass
class QueryRecord:
    id: str
    rank_sequence: np.ndarray
    reverse_complement_rank_sequence: np.ndarray
    quality: str
    internal_id: int


def extract_record_id(tag: str) -> str:
    """Record id = tag up to the first space (input.cpp:161-163)."""
    return tag.split(" ", 1)[0]


def _open_binary(path):
    # binary mode: readline stays in C and sequence payloads skip the
    # text-mode decode (profiled at ~0.3 s per 250x20 kb reads)
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=1 << 20)


def read_fasta(path) -> Iterator[tuple[str, bytes]]:
    """Yield (tag, sequence) pairs; sequences are ASCII bytes."""
    tag = None
    chunks: list[bytes] = []
    with _open_binary(path) as handle:
        for line in handle:
            line = line.rstrip(b"\n\r")
            if line.startswith(b">"):
                if tag is not None:
                    yield tag, b"".join(chunks)
                tag = line[1:].decode("ascii", errors="replace")
                chunks = []
            elif line.startswith(b";"):
                continue
            else:
                chunks.append(line)
        if tag is not None:
            yield tag, b"".join(chunks)


def read_fastq(path) -> Iterator[tuple[str, bytes, bytes]]:
    """Yield (tag, sequence, quality) triples; sequence and quality are
    ASCII bytes (decode quality only where SAM output needs text)."""
    with _open_binary(path) as handle:
        while True:
            header = handle.readline()
            if not header:
                return
            header = header.rstrip(b"\n\r")
            if not header:
                continue
            if not header.startswith(b"@"):
                raise ValueError(f"malformed FASTQ record header: {header!r}")
            seq = handle.readline().rstrip(b"\n\r")
            plus = handle.readline()
            if not plus.startswith(b"+"):
                raise ValueError("malformed FASTQ record: missing '+' line")
            qual = handle.readline().rstrip(b"\n\r")
            yield header[1:].decode("ascii", errors="replace"), seq, qual


def read_references(path) -> References:
    """input::read_references (input.cpp:36-76)."""
    logger.info("reading reference sequences from %s", path)
    records: list[ReferenceRecord] = []
    total_length = 0
    internal_id = 0
    for tag, seq in read_fasta(path):
        record_id = extract_record_id(tag)
        if not seq:
            logger.warning(
                "The record %s in the reference file has an empty sequence "
                "and will be skipped.",
                record_id,
            )
            continue
        rank_sequence = chars_to_ranks(seq)
        logger.debug("read reference, id: %s, length %d", record_id, len(rank_sequence))
        total_length += len(rank_sequence)
        records.append(ReferenceRecord(record_id, rank_sequence, internal_id))
        internal_id += 1
    if not records:
        raise RuntimeError("The reference file is empty, which is not allowed.")
    return References(records, total_length)


def num_errors_from_config(
    query_length: int,
    query_num_errors: Optional[int],
    query_error_probability: Optional[float],
) -> int:
    """input::num_errors_from_user_config (input.cpp:26-34)."""
    if query_error_probability is not None:
        return float_aware_ceil(query_length * query_error_probability)
    assert query_num_errors is not None
    return query_num_errors


class Queries:
    """Streaming query reader with skip rules (input.cpp:83-148)."""

    def __init__(
        self,
        path,
        query_num_errors: Optional[int],
        query_error_probability: Optional[float],
        pex_seed_num_errors: int,
    ):
        self._iter = read_fastq(path)
        self._query_num_errors = query_num_errors
        self._query_error_probability = query_error_probability
        self._pex_seed_num_errors = pex_seed_num_errors
        self.num_queries_read = 0

    def __iter__(self):
        return self

    def __next__(self) -> QueryRecord:
        record = self.next()
        if record is None:
            raise StopIteration
        return record

    def next(self) -> Optional[QueryRecord]:
        for tag, seq, qual in self._iter:
            record_id = extract_record_id(tag)
            if not seq:
                logger.warning(
                    "The record %s in the query file has an empty sequence "
                    "and will be skipped.",
                    record_id,
                )
                continue
            if len(seq) > MAX_ALLOWED_QUERY_LENGTH:
                logger.warning("skipping too large query: %s", record_id)
                continue
            query_num_errors = num_errors_from_config(
                len(seq), self._query_num_errors, self._query_error_probability
            )
            if (
                len(seq) <= query_num_errors
                or query_num_errors < self._pex_seed_num_errors
            ):
                logger.warning(
                    "skipping query: %s due to bad configuration regarding the "
                    "number of errors. query length: %d, errors in query: %d, "
                    "PEX seed errors: %d",
                    record_id,
                    len(seq),
                    query_num_errors,
                    self._pex_seed_num_errors,
                )
                continue
            rank_sequence = chars_to_ranks(seq)
            self.num_queries_read += 1
            return QueryRecord(
                id=record_id,
                rank_sequence=rank_sequence,
                reverse_complement_rank_sequence=reverse_complement(rank_sequence),
                quality=qual.decode("ascii", errors="replace"),
                internal_id=self.num_queries_read - 1,
            )
        return None
