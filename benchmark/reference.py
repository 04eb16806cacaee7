"""The plain reference that decides `correct`: NumPy and Python integers.

It imports nothing of the program. From the genome and the reads that the
benchmark made, it judges each SAM file the program wrote:

- the SAM records: every read of a job has a record; a primary or unmapped
  record carries the read's own characters;
- the seed search: each read's origin, carried in its name, is found: a
  record on its chromosome and on the read's strand (flag 16 for a read
  drawn as the reverse complement of its origin) whose span overlaps the
  origin;
- the traceback: each mapped record's CIGAR consumes the read exactly,
  stays on its chromosome, its `=` columns match the genome and its `X`
  columns do not, and its edits equal its NM, which is within the read's
  error budget ceil(p * length);
- the verification: for a sample of reads drawn from the seed, the NM of
  the origin record equals the read's least edit distance anywhere in a
  window around its origin (Myers' bit-parallel column, one Python integer
  a column). An exact aligner reports that optimum.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np

CHAR_RANK = np.full(256, 255, dtype=np.uint8)
for _rank, _char in enumerate(b"ACGT"):
    CHAR_RANK[_char] = _rank
COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.uint8)
FLAG_UNMAPPED, FLAG_REVERSE, FLAG_SECONDARY = 4, 16, 256
CIGAR_OP = re.compile(r"(\d+)([MIDNSHP=X])")
_EPSILON = 1e-9


def error_budget(length: int, probability: float) -> int:
    """ceil(length * p) less an epsilon, as floxer's math.hpp takes it."""
    return int(math.ceil(length * probability - _EPSILON) + _EPSILON)


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int  # 0-based, -1 unmapped
    cigar: str
    seq: str
    nm: int | None


def read_sam(path) -> list[SamRecord]:
    records = []
    with open(path) as handle:
        for line in handle:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            nm = None
            for tag in fields[11:]:
                if tag.startswith("NM:i:"):
                    nm = int(tag[5:])
            records.append(SamRecord(
                fields[0], int(fields[1]), fields[2], int(fields[3]) - 1,
                fields[5], fields[9], nm,
            ))
    return records


def cigar_edits(cigar: str, read: np.ndarray, reference: np.ndarray,
                pos: int) -> tuple[int, int] | None:
    """(edits, reference span) of a CIGAR laid over the read and the
    reference from pos, or None where it is not a valid alignment of them:
    it does not consume the read exactly, runs off the reference, or an
    `=` column mismatches or an `X` column matches."""
    ops = CIGAR_OP.findall(cigar)
    if not ops or "".join(n + op for n, op in ops) != cigar:
        return None
    lengths = np.array([int(n) for n, _ in ops], dtype=np.int64)
    kinds = np.array([op for _, op in ops])
    if not np.isin(kinds, ["=", "X", "I", "D"]).all():
        return None
    on_read = np.isin(kinds, ["=", "X", "I"])
    on_ref = np.isin(kinds, ["=", "X", "D"])
    if lengths[on_read].sum() != len(read):
        return None
    span = int(lengths[on_ref].sum())
    if pos < 0 or pos + span > len(reference):
        return None
    read_at = np.concatenate([[0], np.cumsum(lengths * on_read)])[:-1]
    ref_at = np.concatenate([[0], np.cumsum(lengths * on_ref)])[:-1] + pos
    for want_equal in (True, False):
        chosen = kinds == ("=" if want_equal else "X")
        if not chosen.any():
            continue
        runs = lengths[chosen]
        within = np.arange(runs.sum()) - np.repeat(
            np.cumsum(runs) - runs, runs
        )
        read_idx = np.repeat(read_at[chosen], runs) + within
        ref_idx = np.repeat(ref_at[chosen], runs) + within
        equal = read[read_idx] == reference[ref_idx]
        if not (equal.all() if want_equal else not equal.any()):
            return None
    edits = int(lengths[kinds != "="].sum())
    return edits, span


def least_edit_distance(pattern: np.ndarray, text: np.ndarray) -> int:
    """The least edit distance of the whole pattern against any substring
    of the text (Myers 1999, semi-global: the text's ends are free)."""
    m = len(pattern)
    mask = (1 << m) - 1
    top = 1 << (m - 1)
    peq = []
    for rank in range(4):
        bits = np.packbits((pattern == rank)[::-1].astype(np.uint8))
        peq.append(int.from_bytes(bits.tobytes(), "big") >> ((-m) % 8))
    pv, mv, score = mask, 0, m
    best = m
    for rank in text.tolist():
        eq = peq[rank]
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | ((xh | pv) ^ mask)
        mh = pv & xh
        if ph & top:
            score += 1
        elif mh & top:
            score -= 1
        ph = (ph << 1) & mask
        mh = (mh << 1) & mask
        pv = mh | ((xv | ph) ^ mask)
        mv = ph & xv
        if score < best:
            best = score
    return best


def origin_strand(read) -> np.ndarray:
    """The read as it lies on its origin's forward strand."""
    return COMPLEMENT[read.ranks][::-1] if read.reverse else read.ranks


@dataclass
class Judgement:
    """What the reference found in the SAM files it was given."""

    reads: int = 0
    missing_reads: int = 0
    origin_missed: int = 0
    record_faults: int = 0
    optimum_checked: int = 0
    nm_gap_max: int = 0
    faults: list[str] = field(default_factory=list)

    def add(self, other: "Judgement") -> None:
        self.reads += other.reads
        self.missing_reads += other.missing_reads
        self.origin_missed += other.origin_missed
        self.record_faults += other.record_faults
        self.optimum_checked += other.optimum_checked
        self.nm_gap_max = max(self.nm_gap_max, other.nm_gap_max)
        self.faults.extend(other.faults[: max(0, 10 - len(self.faults))])

    def numbers(self) -> dict[str, int]:
        """Each number compared, with its limit. Every one is an exact
        comparison, so every limit is 0."""
        return {
            "missing_reads": self.missing_reads,
            "origin_missed": self.origin_missed,
            "record_faults": self.record_faults,
            "nm_gap_max": self.nm_gap_max,
        }


LIMITS = {"missing_reads": 0, "origin_missed": 0, "record_faults": 0,
          "nm_gap_max": 0}


def judge_job(genome, reads, records: list[SamRecord], probability: float,
              optimum_sample: set[str]) -> Judgement:
    """Judge one job's SAM records against its reads (simulate.Read) on
    the genome [(name, ranks)]; the reads named in optimum_sample also get
    the optimum check."""
    judgement = Judgement(reads=len(reads))
    chromosome_of = {name: ranks for name, ranks in genome}
    by_name = {read.name: read for read in reads}
    origin_nm: dict[str, int] = {}
    seen = set()

    def fault(text: str) -> None:
        judgement.record_faults += 1
        if len(judgement.faults) < 10:
            judgement.faults.append(text)

    for record in records:
        read = by_name.get(record.qname)
        if read is None:
            fault(f"{record.qname}: not a read of this job")
            continue
        seen.add(record.qname)
        if not record.flag & FLAG_SECONDARY:
            chars = CHAR_RANK[np.frombuffer(record.seq.encode(), np.uint8)]
            if not np.array_equal(chars, read.ranks):
                fault(f"{record.qname}: SEQ is not the read")
        if record.flag & FLAG_UNMAPPED:
            continue
        reference = chromosome_of.get(record.rname)
        if reference is None or record.nm is None:
            fault(f"{record.qname}: no such reference or no NM")
            continue
        pattern = (COMPLEMENT[read.ranks][::-1]
                   if record.flag & FLAG_REVERSE else read.ranks)
        laid = cigar_edits(record.cigar, pattern, reference, record.pos)
        budget = error_budget(len(read.ranks), probability)
        if laid is None or laid[0] != record.nm or record.nm > budget:
            fault(f"{record.qname}: CIGAR/NM {record.nm} not an alignment "
                  f"within {budget} at {record.pos}")
            continue
        span = laid[1]
        if (bool(record.flag & FLAG_REVERSE) == read.reverse
                and record.rname == genome[read.chromosome][0]
                and record.pos < read.start + len(read.ranks)
                and record.pos + span > read.start):
            origin_nm[record.qname] = min(
                record.nm, origin_nm.get(record.qname, record.nm)
            )
    for name in sorted(optimum_sample & origin_nm.keys()):
        read = by_name[name]
        reference = genome[read.chromosome][1]
        margin = error_budget(len(read.ranks), probability) + 1
        lo = max(0, read.start - margin)
        hi = min(len(reference), read.start + len(read.ranks) + margin)
        optimum = least_edit_distance(origin_strand(read), reference[lo:hi])
        judgement.optimum_checked += 1
        gap = abs(origin_nm[name] - optimum)
        if gap and len(judgement.faults) < 10:
            judgement.faults.append(
                f"{name}: NM {origin_nm[name]}, optimum {optimum}"
            )
        judgement.nm_gap_max = max(judgement.nm_gap_max, gap)
    judgement.missing_reads = len(by_name) - len(seen & by_name.keys())
    judgement.origin_missed = len(by_name) - len(origin_nm)
    return judgement


def truth_sam(path, genome, reads, forward_only: bool = False) -> None:
    """The control: a SAM that reports, for each read, the generator's own
    path from its origin in place of the least-edit alignment, as an
    aligner that is not exact could. Valid alignments, origins found, but
    NM above the optimum wherever the path is not the best. A reverse
    read's record has flag 16 and the path laid against the read's reverse
    complement; its SEQ stays the read, as floxer writes it. With
    `forward_only`, a reverse read is written unmapped, as by an aligner
    that searches only the forward strand."""
    chars = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "w") as handle:
        handle.write("@HD\tVN:1.6\tSO:unknown\n")
        for name, ranks in genome:
            handle.write(f"@SQ\tSN:{name}\tLN:{len(ranks)}\n")
        for read in reads:
            seq = chars[read.ranks].tobytes().decode()
            if read.reverse and forward_only:
                handle.write(f"{read.name}\t{FLAG_UNMAPPED}\t*\t0\t255\t*"
                             f"\t*\t0\t0\t{seq}\t*\n")
                continue
            cigar, edits = _truth_cigar(read)
            flag = FLAG_REVERSE if read.reverse else 0
            handle.write(
                f"{read.name}\t{flag}\t{genome[read.chromosome][0]}\t"
                f"{read.start + 1}\t255\t{cigar}\t*\t0\t0\t{seq}\t*\t"
                f"NM:i:{edits}\n"
            )


def _truth_cigar(read) -> tuple[str, int]:
    """The generator's path as a CIGAR: an origin base kept is `=`, a
    mismatch `X`, an insertion `=` then `I`, a deletion `D`."""
    origin_length = (len(read.ranks) - int((read.kinds == 1).sum())
                     + int((read.kinds == 2).sum()))
    columns = np.full(origin_length, "=", dtype="<U2")
    columns[read.offsets] = np.array(["X", "=I", "D"], dtype="<U2")[read.kinds]
    ops = "".join(columns.tolist())
    runs = re.findall(r"(=+|X+|I+|D+)", ops)
    cigar = "".join(f"{len(run)}{run[0]}" for run in runs)
    edits = sum(len(run) for run in runs if run[0] != "=")
    return cigar, edits
