# Copied from floxer_tpu/parallel/multihost.py (its jax-free functions); _next_blob raises ValueError on a 1-3-byte size prefix.
"""Multi-host orchestration: read sharding and output merging.

Host h of H processes the queries whose internal id i satisfies
i % H == h (every host streams the same FASTQ and skips foreign records);
each writes its own shard output, and the shards merge into one canonical
SAM/BAM ordered by query internal id, a round-robin interleave of
per-query record groups. In a process set (parallel/collectives.py) process
0 merges after a barrier; the same merge is exposed as
`floxer_tpu_torch.tools.merge_sam` for file-based workflows.

CLI: --num-hosts / --host-id select the shard (default 1/0: single host).
"""

from __future__ import annotations

from typing import Iterable, Iterator


def shard_queries(
    queries: Iterable, host_id: int, num_hosts: int
) -> Iterator:
    """Strided query sharding by internal id (deterministic across hosts)."""
    for query in queries:
        if query.internal_id % num_hosts == host_id:
            yield query


def shard_output_path(path: str, host_id: int) -> str:
    """Per-process shard file next to the requested output, extension
    preserved so the SAM/BAM writer selection is unchanged:
    out.sam -> out.shard3.sam."""
    import os

    base, ext = os.path.splitext(path)
    return f"{base}.shard{host_id}{ext}"


def _read_sam_query_groups(path):
    """Yield (header_lines, groups) where groups are per-query record runs
    in file order."""
    header = []
    groups = []
    current_qname = None
    with open(path) as handle:
        for line in handle:
            line = line.rstrip("\n")
            if line.startswith("@"):
                header.append(line)
                continue
            qname = line.split("\t", 1)[0]
            if qname != current_qname:
                groups.append((qname, []))
                current_qname = qname
            groups[-1][1].append(line)
    return header, groups


def merge_sam_shards(shard_paths: list[str], output_path: str) -> int:
    """Round-robin interleave of strided shards into one SAM ordered by
    query internal id. Returns the number of merged queries."""
    shards = [_read_sam_query_groups(path) for path in shard_paths]
    header = shards[0][0]
    for other_header, _ in shards[1:]:
        if other_header != header:
            raise ValueError("shard headers disagree; not outputs of one run")

    groups = [groups for _, groups in shards]
    positions = [0] * len(shards)
    total = 0
    with open(output_path, "w") as out:
        for line in header:
            out.write(line + "\n")
        exhausted = 0
        shard = 0
        while exhausted < len(shards):
            if positions[shard] < len(groups[shard]):
                _, lines = groups[shard][positions[shard]]
                for line in lines:
                    out.write(line + "\n")
                positions[shard] += 1
                total += 1
                exhausted = 0
            else:
                exhausted += 1
            shard = (shard + 1) % len(shards)
    return total


class _BamShardCursor:
    """Streaming per-query-group cursor over a BGZF BAM shard. Decompresses
    incrementally through gzip.GzipFile so at most one group's record blobs
    (block_size prefix included, byte-for-byte) are resident — the merge of
    large-run shards must not hold every shard fully decompressed at once.
    `header_blob` is the raw uncompressed bytes from the BAM magic through
    the reference list."""

    def __init__(self, path):
        import gzip
        import struct

        self._struct = struct
        self._fh = gzip.open(path, "rb")
        magic = self._exact(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path} is not a BAM file")
        l_text = struct.unpack("<i", self._exact(4))[0]
        text = self._exact(l_text)
        n_ref_raw = self._exact(4)
        n_ref = struct.unpack("<i", n_ref_raw)[0]
        refs = bytearray()
        for _ in range(n_ref):
            l_name_raw = self._exact(4)
            l_name = struct.unpack("<i", l_name_raw)[0]
            refs += l_name_raw + self._exact(l_name + 4)
        self.header_blob = (
            magic + struct.pack("<i", l_text) + text + n_ref_raw + bytes(refs)
        )
        self._pending = self._next_blob()

    def _exact(self, n):
        data = self._fh.read(n)
        if len(data) != n:
            raise ValueError("truncated BAM stream")
        return data

    def _next_blob(self):
        size_raw = self._fh.read(4)
        if not size_raw:
            return None
        if len(size_raw) != 4:
            raise ValueError("truncated BAM stream")
        block_size = self._struct.unpack("<i", size_raw)[0]
        return size_raw + self._exact(block_size)

    @staticmethod
    def _qname(blob):
        l_read_name = blob[4 + 8]
        return blob[4 + 32 : 4 + 32 + l_read_name - 1]

    def next_group(self):
        """Next per-query run of record blobs, or None at end of shard."""
        if self._pending is None:
            return None
        qname = self._qname(self._pending)
        blobs = [self._pending]
        while True:
            blob = self._next_blob()
            if blob is None or self._qname(blob) != qname:
                self._pending = blob
                return blobs
            blobs.append(blob)

    def close(self):
        self._fh.close()


def merge_bam_shards(shard_paths: list[str], output_path: str) -> int:
    """Round-robin interleave of strided BAM shards into one BGZF BAM
    ordered by query internal id (the BAM counterpart of merge_sam_shards;
    reference writes BAM directly in all modes, output.cpp:25-108).
    Record blobs are copied byte-for-byte; only the BGZF framing is new.
    Shards are streamed group-by-group (never fully resident).
    Returns the number of merged queries."""
    from ..io.sam import _BgzfWriter

    shards = [_BamShardCursor(path) for path in shard_paths]
    try:
        header = shards[0].header_blob
        for other in shards[1:]:
            if other.header_blob != header:
                raise ValueError(
                    "shard headers disagree; not outputs of one run"
                )

        total = 0
        writer = _BgzfWriter(open(output_path, "wb"))
        try:
            writer.write(header)
            exhausted = 0
            shard = 0
            while exhausted < len(shards):
                blobs = shards[shard].next_group()
                if blobs is not None:
                    for blob in blobs:
                        writer.write(blob)
                    total += 1
                    exhausted = 0
                else:
                    exhausted += 1
                shard = (shard + 1) % len(shards)
        finally:
            writer.close()
    finally:
        for cursor in shards:
            cursor.close()
    return total
