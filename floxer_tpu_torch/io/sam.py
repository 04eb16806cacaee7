# Copied from floxer_tpu/io/sam.py; relative imports resolve to this package's copies.
"""SAM and BAM alignment output.

Parity target: src/lib/output.cpp:42-108 (record field semantics) and the
seqan3 sam_file_output header layout (output.cpp:197-212): @SQ lines carry
each reference's id and length in internal-id order. BAM files are written as
spec-compliant BGZF blocks (pure Python + zlib — host-side IO, no third-party
dependency).

Record semantics (output.cpp:49-108):
  - records iterate references in internal-id order
  - primary = first record whose num_errors equals the best across all
    references; it carries SEQ (forward characters) + QUAL
  - all other records get the secondary_alignment flag and empty SEQ/QUAL
  - reverse-complement hits get flag 16, but SEQ stays the forward sequence
  - MAPQ is always 255 (unavailable), NM tag = edit distance
  - ref_offset saturates to int32 max
  - fully unmapped query -> one flag-4 record with SEQ + QUAL
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..cigar import Cigar

FLAG_UNMAPPED = 4
FLAG_REVERSE = 16
FLAG_SECONDARY = 256

MAPQ_NOT_AVAILABLE = 255


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str  # "" for unmapped
    pos: int  # 0-based; -1 for unmapped
    mapq: int
    cigar: list[tuple[int, str]]
    seq: str
    qual: str
    tags: list[tuple[str, str, int | str]] = field(default_factory=list)

    def to_sam_line(self) -> str:
        if isinstance(self.cigar, Cigar):
            cigar = self.cigar.string() or "*"
        else:
            cigar = "".join(f"{n}{op}" for n, op in self.cigar) or "*"
        fields = [
            self.qname,
            str(self.flag),
            self.rname or "*",
            str(self.pos + 1 if self.pos >= 0 else 0),
            str(self.mapq),
            cigar,
            "*",  # RNEXT
            "0",  # PNEXT
            "0",  # TLEN
            self.seq or "*",
            self.qual or "*",
        ]
        for tag, tag_type, value in self.tags:
            fields.append(f"{tag}:{tag_type}:{value}")
        return "\t".join(fields)


_BAM_CIGAR_OPS = "MIDNSHP=X"
_BAM_SEQ_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def _build_bam_luts():
    op_lut = np.zeros(256, dtype=np.uint32)
    for i, op in enumerate(_BAM_CIGAR_OPS):
        op_lut[ord(op)] = i
    seq_lut = np.full(256, 15, dtype=np.uint8)
    for char, code in _BAM_SEQ_CODE.items():
        seq_lut[ord(char)] = code
    return op_lut, seq_lut


_BAM_OP_LUT, _BAM_SEQ_LUT = _build_bam_luts()


class _BgzfWriter:
    """Minimal BGZF (blocked gzip) writer for BAM output."""

    MAX_BLOCK = 64 * 1024 - 1024

    def __init__(self, handle):
        self._handle = handle
        self._buffer = bytearray()

    def write(self, data: bytes) -> None:
        self._buffer.extend(data)
        while len(self._buffer) >= self.MAX_BLOCK:
            self._flush_block(self._buffer[: self.MAX_BLOCK])
            del self._buffer[: self.MAX_BLOCK]

    def _flush_block(self, data: bytes) -> None:
        compressor = zlib.compressobj(6, zlib.DEFLATED, -15)
        compressed = compressor.compress(bytes(data)) + compressor.flush()
        crc = zlib.crc32(bytes(data)) & 0xFFFFFFFF
        bsize = len(compressed) + 25 + 1
        header = struct.pack(
            "<BBBBIBBHBBHH",
            31, 139, 8, 4,  # gzip magic, deflate, FEXTRA
            0, 0, 255,  # mtime, xfl, os
            6,  # xlen
            66, 67, 2,  # 'B', 'C', subfield length
            bsize - 1,
        )
        footer = struct.pack("<II", crc, len(data) % (1 << 32))
        self._handle.write(header + compressed + footer)

    def close(self) -> None:
        if self._buffer:
            self._flush_block(bytes(self._buffer))
            self._buffer.clear()
        # BGZF EOF marker block
        self._handle.write(
            bytes.fromhex(
                "1f8b08040000000000ff0600424302001b0003000000000000000000"
            )
        )
        self._handle.close()


_BGZF_EOF_SIZE = 28


class AlignmentOutput:
    """SAM or BAM writer selected by output path extension.

    append=True resumes an interrupted run: SAM appends records directly;
    BAM strips the 28-byte BGZF EOF marker and continues the block stream.
    """

    def __init__(self, output_path, references, append: bool = False):
        import os

        self.references = references
        self._ref_index = {ref.id: i for i, ref in enumerate(references)}
        path = str(output_path)
        self._is_bam = path.endswith(".bam")
        resuming = append and os.path.exists(path) and os.path.getsize(path) > 0
        if self._is_bam:
            if resuming:
                handle = open(path, "r+b")
                handle.seek(0, os.SEEK_END)
                size = handle.tell()
                if size >= _BGZF_EOF_SIZE:
                    handle.truncate(size - _BGZF_EOF_SIZE)
                handle.seek(0, os.SEEK_END)
                self._bgzf = _BgzfWriter(handle)
            else:
                self._bgzf = _BgzfWriter(open(path, "wb"))
                self._write_bam_header(self._header_text())
        else:
            if resuming:
                self._handle = open(path, "at")
            else:
                self._handle = open(path, "wt")
                self._handle.write(self._header_text())

    def _header_text(self) -> str:
        lines = ["@HD\tVN:1.6\tSO:unknown"]
        for ref in self.references:
            lines.append(f"@SQ\tSN:{ref.id}\tLN:{len(ref.rank_sequence)}")
        return "\n".join(lines) + "\n"

    def _write_bam_header(self, header_text: str) -> None:
        out = bytearray(b"BAM\x01")
        encoded = header_text.encode()
        out += struct.pack("<i", len(encoded))
        out += encoded
        out += struct.pack("<i", len(self.references))
        for ref in self.references:
            name = ref.id.encode() + b"\x00"
            out += struct.pack("<i", len(name))
            out += name
            out += struct.pack("<i", len(ref.rank_sequence))
        self._bgzf.write(bytes(out))

    def write_record(self, record: SamRecord) -> None:
        if self._is_bam:
            self._bgzf.write(self._encode_bam_record(record))
        else:
            self._handle.write(record.to_sam_line() + "\n")

    def _encode_bam_record(self, record: SamRecord) -> bytes:
        ref_id = self._ref_index.get(record.rname, -1)
        pos = record.pos if record.pos >= 0 else -1
        read_name = record.qname.encode() + b"\x00"
        if isinstance(record.cigar, Cigar):
            packed = (
                record.cigar.counts.astype(np.uint32) << 4
            ) | _BAM_OP_LUT[record.cigar.op_chars]
            cigar_packed = packed.astype("<u4").tobytes()
        else:
            cigar_packed = b"".join(
                struct.pack("<I", (n << 4) | _BAM_CIGAR_OPS.index(op))
                for n, op in record.cigar
            )
        seq = record.seq
        l_seq = len(seq)
        if l_seq:
            codes = _BAM_SEQ_LUT[
                np.frombuffer(
                    seq.upper().encode("ascii", errors="replace"),
                    dtype=np.uint8,
                )
            ]
            if l_seq % 2:
                codes = np.append(codes, np.uint8(0))
            seq_packed = ((codes[0::2] << 4) | codes[1::2]).tobytes()
        else:
            seq_packed = b""
        if record.qual:
            quals = (
                np.frombuffer(
                    record.qual.encode("ascii", errors="replace"),
                    dtype=np.uint8,
                ).astype(np.int16)
                - 33
            )
            if quals.min(initial=0) < 0:
                raise ValueError(
                    "quality characters below '!' are not valid phred+33"
                )
            qual_packed = np.minimum(quals, 93).astype(np.uint8).tobytes()
        else:
            qual_packed = b"\xff" * l_seq
        tags_packed = bytearray()
        for tag, tag_type, value in record.tags:
            if tag_type == "i":
                tags_packed += tag.encode() + b"i" + struct.pack("<i", int(value))
            else:
                tags_packed += tag.encode() + b"Z" + str(value).encode() + b"\x00"

        # bin computation (SAM spec reg2bin) for the record's interval
        if isinstance(record.cigar, Cigar):
            end = pos + record.cigar.consumed_reference_bases()
        else:
            end = pos + sum(n for n, op in record.cigar if op in "MDN=X")
        bin_ = _reg2bin(pos if pos >= 0 else -1, end if end > pos else pos + 1)

        body = bytearray()
        body += struct.pack("<i", ref_id)
        body += struct.pack("<i", pos)
        body += struct.pack("<B", len(read_name))
        body += struct.pack("<B", record.mapq)
        body += struct.pack("<H", bin_)
        body += struct.pack("<H", len(record.cigar))
        body += struct.pack("<H", record.flag)
        body += struct.pack("<i", l_seq)
        body += struct.pack("<i", -1)  # next_ref_id
        body += struct.pack("<i", -1)  # next_pos
        body += struct.pack("<i", 0)  # tlen
        body += read_name
        body += cigar_packed
        body += bytes(seq_packed)
        body += qual_packed
        body += bytes(tags_packed)
        return struct.pack("<i", len(body)) + bytes(body)

    def close(self) -> None:
        if self._is_bam:
            self._bgzf.close()
        else:
            self._handle.close()


def read_alignment_records(path):
    """Iterate alignment records from a SAM or BAM file as dicts with keys
    qname, flag, rname, pos (0-based, -1 unmapped), mapq, cigar (string),
    seq, qual, tags (dict). Header reference names are resolved for BAM.

    Host-side reader used by the analysis tools (the reference reads both
    formats through seqan3::sam_file_input)."""
    path = str(path)
    if path.endswith(".bam"):
        yield from _read_bam_records(path)
        return
    with open(path) as handle:
        for line in handle:
            line = line.rstrip("\n")
            if not line or line.startswith("@"):
                continue
            fields = line.split("\t")
            tags = {}
            for tag_field in fields[11:]:
                name, tag_type, value = tag_field.split(":", 2)
                tags[name] = int(value) if tag_type == "i" else value
            yield {
                "qname": fields[0],
                "flag": int(fields[1]),
                "rname": "" if fields[2] == "*" else fields[2],
                "pos": int(fields[3]) - 1,
                "mapq": int(fields[4]),
                "cigar": fields[5],
                "seq": "" if fields[9] == "*" else fields[9],
                "qual": "" if fields[10] == "*" else fields[10],
                "tags": tags,
            }


def _read_bam_records(path):
    import gzip

    raw = gzip.decompress(open(path, "rb").read())
    if raw[:4] != b"BAM\x01":
        raise ValueError(f"{path} is not a BAM file")
    l_text = struct.unpack("<i", raw[4:8])[0]
    offset = 8 + l_text
    n_ref = struct.unpack("<i", raw[offset : offset + 4])[0]
    offset += 4
    names = []
    for _ in range(n_ref):
        l_name = struct.unpack("<i", raw[offset : offset + 4])[0]
        names.append(raw[offset + 4 : offset + 4 + l_name - 1].decode())
        offset += 4 + l_name + 4
    seq_chars = "=ACMGRSVTWYHKDBN"
    while offset < len(raw):
        block_size = struct.unpack("<i", raw[offset : offset + 4])[0]
        body = raw[offset + 4 : offset + 4 + block_size]
        offset += 4 + block_size
        ref_id, pos = struct.unpack("<ii", body[0:8])
        l_read_name = body[8]
        mapq = body[9]
        n_cigar, flag = struct.unpack("<HH", body[12:16])
        l_seq = struct.unpack("<i", body[16:20])[0]
        cursor = 32
        qname = body[cursor : cursor + l_read_name - 1].decode()
        cursor += l_read_name
        cigar_raw = struct.unpack(
            f"<{n_cigar}I", body[cursor : cursor + 4 * n_cigar]
        )
        cursor += 4 * n_cigar
        cigar = "".join(
            f"{c >> 4}{_BAM_CIGAR_OPS[c & 15]}" for c in cigar_raw
        ) or "*"
        seq_bytes = body[cursor : cursor + (l_seq + 1) // 2]
        cursor += (l_seq + 1) // 2
        seq = "".join(
            seq_chars[(seq_bytes[i // 2] >> (4 if i % 2 == 0 else 0)) & 15]
            for i in range(l_seq)
        )
        qual_bytes = body[cursor : cursor + l_seq]
        cursor += l_seq
        qual = (
            ""
            if l_seq == 0 or (qual_bytes and qual_bytes[0] == 0xFF)
            else "".join(chr(q + 33) for q in qual_bytes)
        )
        tags = {}
        tail = body[cursor:]
        tag_cursor = 0
        while tag_cursor + 3 <= len(tail):
            tag_name = tail[tag_cursor : tag_cursor + 2].decode()
            tag_type = chr(tail[tag_cursor + 2])
            tag_cursor += 3
            if tag_type == "i":
                tags[tag_name] = struct.unpack(
                    "<i", tail[tag_cursor : tag_cursor + 4]
                )[0]
                tag_cursor += 4
            elif tag_type in "cC":
                tags[tag_name] = tail[tag_cursor]
                tag_cursor += 1
            elif tag_type in "sS":
                tags[tag_name] = struct.unpack(
                    "<h", tail[tag_cursor : tag_cursor + 2]
                )[0]
                tag_cursor += 2
            elif tag_type == "A":
                tags[tag_name] = chr(tail[tag_cursor])
                tag_cursor += 1
            elif tag_type == "Z":
                end_idx = tail.index(b"\x00", tag_cursor)
                tags[tag_name] = tail[tag_cursor:end_idx].decode()
                tag_cursor = end_idx + 1
            else:  # unsupported tag types: stop parsing this record's tags
                break
        yield {
            "qname": qname,
            "flag": flag,
            "rname": names[ref_id] if ref_id >= 0 else "",
            "pos": pos,
            "mapq": mapq,
            "cigar": cigar,
            "seq": seq,
            "qual": qual,
            "tags": tags,
        }


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0
