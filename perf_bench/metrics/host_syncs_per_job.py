"""host_syncs_per_job (syncs/job): the points at which the program made the
host wait for the card, its ``repro_torch.sync.<cause>`` spans that start
inside the traced jobs (the schedule's pageable copy per chunk, the flip
counter's reads, the driver's synchronises), per job.  Layer: the driver.
Moves updates_per_s."""

from perf_bench import spans as P


def read(tl):
    spans = P.program_spans(tl)
    if spans is None:
        return None
    return len(P.named(spans, "sync.")) / len(tl.jobs)
