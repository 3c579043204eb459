"""entry_self_ms_per_job (ms/job): the self time of the program's
``repro_torch.entry.*`` spans in the traced jobs (the hand-over
``shard_state`` and ``run_recorded``), each span's duration less the union
of the program spans inside it, summed and per job: the host's work at the
entry that no chunk, record point or sync covers (the schedule turned into
LUT rows, the LUT, the cursor and its bookkeeping between chunks).  Layer:
the entry.  Moves updates_per_s."""

from perf_bench import spans as P


def read(tl):
    spans = P.program_spans(tl)
    if spans is None:
        return None
    entry = P.named(spans, "entry.")
    return sum(P.self_us(s, spans) for s in entry) / 1e3 / len(tl.jobs)
