"""Seconds a job spends inside the server outside its align phase: the
program's `job` span (the request's parse to its exit code) less its
`align` span, averaged over the window's traced jobs. The reference
FASTA read again (`job.reference`), the index (`job.index`), the searcher
(`job.searcher`) and the output's close and statistics (`job.close`);
the inside counterpart of job_nonalign_s, which the client times."""

from benchmark.spans import traced_jobs


def read(run):
    gaps = []
    for _, spans in traced_jobs(run):
        job, align = spans.named("job"), spans.named("align")
        if job and align:
            gaps.append(job[0].seconds - align[0].seconds)
    return sum(gaps) / len(gaps) if gaps else None
