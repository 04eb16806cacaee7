"""The port's multi-host sharding, process set and shard merge
(floxer_tpu_torch/parallel/) against the reference's.

Port versions of tests/test_multihost.py and tests/test_distributed.py:
--num-hosts shards merged by the port's merge_sam equal the single-process
port SAM and the reference's; --resume continues on a shard path; two
processes joined on torch.distributed (gloo, on the CPU) write the merged
SAM or BAM of the single run, keep stdout empty, partition the queries and
report the single run's statistics from process 0 only. The copied merge
functions give the reference's bytes on the same shards, and the
repaired _next_blob raises ValueError on a truncated size prefix."""

import gzip
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from floxer_tpu.parallel import multihost as ref_multihost
from floxer_tpu_torch.__main__ import main
from floxer_tpu_torch.io.sam import read_alignment_records
from floxer_tpu_torch.parallel import multihost
from test_distributed import _stable_stats_lines

ROOT = Path(__file__).resolve().parent.parent
BASE = [
    "--query-errors", "2", "--seed-errors", "1",
    "--extra-verification-ratio", "2", "--interval-optimization",
]
PROCESS_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def data_args(data_dir, output, extra=()):
    return [
        "--reference", str(data_dir / "reference.fasta"),
        "--queries", str(data_dir / "queries.fastq"),
        "--output", str(output),
        *BASE, *extra,
    ]


def child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in PROCESS_ENV}
    env.update({"CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT), **extra})
    return env


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def port_cli(args, env=None, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "floxer_tpu_torch", *args],
        capture_output=True, text=True, env=env or child_env(), cwd=ROOT,
        timeout=timeout,
    )


def run_process_set(args_of, num_processes=2, timeout=300):
    """python -m floxer_tpu_torch in num_processes processes joined through
    a free local port; args_of(rank) gives each its arguments. Returns
    [(returncode, stdout, stderr)]; every child is killed on a failure."""
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "floxer_tpu_torch", *args_of(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT,
            env=child_env(
                JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                JAX_NUM_PROCESSES=str(num_processes),
                JAX_PROCESS_ID=str(rank),
            ),
        )
        for rank in range(num_processes)
    ]
    try:
        outs = [proc.communicate(timeout=timeout) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [(proc.returncode, *out) for proc, out in zip(procs, outs)]


@pytest.fixture(scope="module")
def single(tmp_path_factory, data_dir):
    """The single-process port run: its SAM, BAM and stats TOML paths."""
    out = tmp_path_factory.mktemp("single")
    for name in ("single.sam", "single.bam"):
        stats = out / f"stats_{name.split('.')[1]}.toml"
        assert main(data_args(data_dir, out / name, ["--stats", str(stats)])) == 0
    return out


@pytest.fixture(scope="module")
def reference_sam(tmp_path_factory, data_dir):
    """SAM of the JAX package on the same arguments."""
    output = tmp_path_factory.mktemp("reference") / "out.sam"
    env = child_env(FLOXER_TPU_PLATFORM="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "floxer_tpu", *data_args(data_dir, output)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return output.read_bytes()


def query_names(sam_text):
    return {
        line.split("\t", 1)[0]
        for line in sam_text.splitlines() if not line.startswith("@")
    }


@pytest.mark.timeout(300)
def test_two_host_shards_merge_to_single_host_output(
    tmp_path, data_dir, single, reference_sam
):
    shards = []
    for host_id in range(2):
        shard = tmp_path / f"shard{host_id}.sam"
        assert main(data_args(
            data_dir, shard, ["--num-hosts", "2", "--host-id", str(host_id)]
        )) == 0
        shards.append(shard)
    assert query_names(shards[0].read_text()).isdisjoint(
        query_names(shards[1].read_text())
    )
    merged = tmp_path / "merged.sam"
    proc = subprocess.run(
        [
            sys.executable, "-m", "floxer_tpu_torch.tools.merge_sam",
            "-i", *map(str, shards), "-o", str(merged),
        ],
        capture_output=True, text=True, env=child_env(), cwd=ROOT,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""
    assert "merged 6 queries from 2 shards" in proc.stderr
    assert merged.read_bytes() == (single / "single.sam").read_bytes()
    assert merged.read_bytes() == reference_sam


def truncate_to_queries(full: Path, partial: Path, keep: int) -> None:
    """partial = full's header and the records of its first `keep`
    queries, as an interrupted run leaves it."""
    lines = full.read_text().splitlines(keepends=True)
    header = [line for line in lines if line.startswith("@")]
    records = [line for line in lines if not line.startswith("@")]
    qnames = []
    for record in records:
        qname = record.split("\t", 1)[0]
        if qname not in qnames:
            qnames.append(qname)
    kept = set(qnames[:keep])
    partial.write_text("".join(
        header + [r for r in records if r.split("\t", 1)[0] in kept]
    ))


@pytest.mark.timeout(300)
def test_resume_continues_a_host_shard(tmp_path, data_dir):
    """--resume on a --num-hosts shard: the cursor counts the shard's own
    queries, and the resumed shard equals the uninterrupted one."""
    hosts = ["--num-hosts", "2", "--host-id", "1"]
    full = tmp_path / "full.shard1.sam"
    assert main(data_args(data_dir, full, hosts)) == 0
    partial = tmp_path / "partial.shard1.sam"
    truncate_to_queries(full, partial, 1)
    (tmp_path / "partial.shard1.sam.progress").write_text("1\n")
    assert main(data_args(data_dir, partial, [*hosts, "--resume"])) == 0
    assert partial.read_text() == full.read_text()
    assert not (tmp_path / "partial.shard1.sam.progress").exists()


@pytest.mark.timeout(600)
@pytest.mark.parametrize("suffix", ["sam", "bam"])
def test_two_process_run_matches_single(tmp_path, data_dir, single, suffix):
    """Two processes joined on gloo: process 0 merges the canonical output
    (SAM byte-identical, BAM records identical to the single run's), the
    shards partition the queries, stdout stays empty, and only process 0
    writes statistics, equal to the single run's stable lines."""
    out = tmp_path / f"dist.{suffix}"
    results = run_process_set(lambda rank: data_args(
        data_dir, out, ["--stats", str(tmp_path / f"stats_{rank}.toml")]
    ))
    for code, stdout, stderr in results:
        assert code == 0, stderr[-3000:]
        assert stdout == "", "stdout must stay empty"
    assert "merged 6 queries from 2 shards" in results[0][2]
    want = single / f"single.{suffix}"
    if suffix == "sam":
        assert out.read_bytes() == want.read_bytes()
        names = [
            query_names((tmp_path / f"dist.shard{rank}.sam").read_text())
            for rank in range(2)
        ]
        assert names[0] and names[1] and names[0].isdisjoint(names[1])
    else:
        assert gzip.decompress(out.read_bytes())[:4] == b"BAM\x01"
        assert list(read_alignment_records(out)) == list(
            read_alignment_records(want)
        )
        for rank in range(2):
            assert (tmp_path / f"dist.shard{rank}.bam").exists()
    assert _stable_stats_lines(tmp_path / "stats_0.toml") == (
        _stable_stats_lines(single / f"stats_{suffix}.toml")
    )
    assert not (tmp_path / "stats_1.toml").exists()


@pytest.mark.timeout(600)
def test_two_process_resume_on_shard_path(tmp_path, data_dir, single):
    """In a process set the --resume cursor sits beside each process's
    shard file: process 1 resumes its interrupted shard, process 0 runs
    its shard afresh, and the merge equals the single run."""
    out = tmp_path / "dist.sam"
    results = run_process_set(lambda rank: data_args(data_dir, out))
    assert all(code == 0 for code, _, _ in results), results[1][2][-3000:]
    shard1 = tmp_path / "dist.shard1.sam"
    full1 = shard1.read_text()
    truncate_to_queries(shard1, shard1, 1)
    (tmp_path / "dist.shard1.sam.progress").write_text("1\n")
    out.unlink()
    results = run_process_set(
        lambda rank: data_args(data_dir, out, ["--resume"])
    )
    for code, stdout, stderr in results:
        assert code == 0, stderr[-3000:]
        assert stdout == ""
    assert "resuming: skipping 1 already-processed queries" in results[1][2]
    assert "resuming" not in results[0][2]
    assert shard1.read_text() == full1
    assert not (tmp_path / "dist.shard1.sam.progress").exists()
    assert out.read_bytes() == (single / "single.sam").read_bytes()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("missing", ["JAX_NUM_PROCESSES", "JAX_PROCESS_ID"])
def test_coordinator_without_process_count_fails(tmp_path, data_dir, missing):
    """The port detects no cluster: a coordinator without the process
    count or id exits non-zero, names the missing variable, writes
    nothing and keeps stdout empty."""
    env = child_env(
        JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
        JAX_NUM_PROCESSES="2", JAX_PROCESS_ID="0",
    )
    del env[missing]
    output = tmp_path / "out.sam"
    proc = port_cli(data_args(data_dir, output), env=env, timeout=100)
    assert proc.returncode != 0
    assert missing in proc.stderr
    assert proc.stdout == ""
    assert not output.exists()
    assert not (tmp_path / "out.shard0.sam").exists()


@pytest.mark.timeout(120)
def test_process_id_outside_the_set_fails(tmp_path, data_dir):
    """A join that cannot succeed (process id 2 of 2) exits non-zero."""
    env = child_env(
        JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
        JAX_NUM_PROCESSES="2", JAX_PROCESS_ID="2",
    )
    proc = port_cli(data_args(data_dir, tmp_path / "out.sam"), env=env,
                    timeout=100)
    assert proc.returncode != 0
    assert "JAX_PROCESS_ID=2" in proc.stderr
    assert proc.stdout == ""


def write_shards(tmp_path, data_dir, suffix):
    shards = []
    for host_id in range(2):
        shard = tmp_path / f"out.shard{host_id}.{suffix}"
        assert main(data_args(
            data_dir, shard, ["--num-hosts", "2", "--host-id", str(host_id)]
        )) == 0
        shards.append(str(shard))
    return shards


@pytest.mark.timeout(300)
@pytest.mark.parametrize("suffix", ["sam", "bam"])
def test_merge_equals_reference_merge(tmp_path, data_dir, suffix):
    """The copied merge functions write the reference's bytes from the
    same shards and count the same queries."""
    shards = write_shards(tmp_path, data_dir, suffix)
    name = f"merge_{suffix}_shards"
    got = getattr(multihost, name)(shards, str(tmp_path / f"port.{suffix}"))
    want = getattr(ref_multihost, name)(shards, str(tmp_path / f"ref.{suffix}"))
    assert got == want == 6
    assert (tmp_path / f"port.{suffix}").read_bytes() == (
        tmp_path / f"ref.{suffix}"
    ).read_bytes()


def test_shard_helpers_match_reference():
    class Query:
        def __init__(self, internal_id):
            self.internal_id = internal_id

    queries = [Query(i) for i in range(11)]
    for host_id in range(3):
        assert [q.internal_id for q in multihost.shard_queries(
            queries, host_id, 3
        )] == [q.internal_id for q in ref_multihost.shard_queries(
            queries, host_id, 3
        )]
    for path in ("out.sam", "dir/out.bam", "noext"):
        assert multihost.shard_output_path(path, 3) == (
            ref_multihost.shard_output_path(path, 3)
        )


def test_merge_rejects_shards_of_different_runs(tmp_path):
    for name, header in (("a.sam", "@HD\tVN:1.6\n"), ("b.sam", "@HD\tVN:1.5\n")):
        (tmp_path / name).write_text(header + "q\t4\t*\t0\t0\t*\t*\t0\t0\tA\tI\n")
    with pytest.raises(ValueError, match="shard headers disagree"):
        multihost.merge_sam_shards(
            [str(tmp_path / "a.sam"), str(tmp_path / "b.sam")],
            str(tmp_path / "out.sam"),
        )


@pytest.mark.timeout(300)
@pytest.mark.parametrize("prefix_bytes", [1, 2, 3])
def test_truncated_size_prefix_raises_value_error(
    tmp_path, data_dir, prefix_bytes
):
    """R2 repaired: a BAM shard that ends 1-3 bytes into a record's size
    prefix raises ValueError('truncated BAM stream'), where the reference
    raises struct.error."""
    import struct

    from floxer_tpu_torch.io.sam import _BgzfWriter

    shards = write_shards(tmp_path, data_dir, "bam")
    raw = gzip.decompress(Path(shards[0]).read_bytes())
    cut = tmp_path / "cut.bam"
    with open(cut, "wb") as handle:
        writer = _BgzfWriter(handle)
        writer.write(raw + b"\x10\x00\x00"[:prefix_bytes])
        writer.close()
    with pytest.raises(ValueError, match="truncated BAM stream"):
        multihost.merge_bam_shards([str(cut)], str(tmp_path / "out.bam"))
    with pytest.raises(struct.error):
        ref_multihost.merge_bam_shards([str(cut)], str(tmp_path / "ref.bam"))
