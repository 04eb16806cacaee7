"""Seconds a job spends outside its align phase: the client's wall of the
job less the program's `finished aligning ... in X seconds`. Request
parsing, the reference FASTA read again, index and bank lookups, the SAM
file's opening and the server's reply."""


def read(run):
    gaps = [job.reply.wall - job.align_s for job in run.ok_jobs
            if job.align_s is not None]
    return sum(gaps) / len(gaps) if gaps else None
