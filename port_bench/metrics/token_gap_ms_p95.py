"""``token_gap_ms_p95.decode``: the 95th percentile, in ms on the host
clock, of the gaps between a sequence's consecutive tokens over the
window's steps that no profiler stretch covered (the decode driver's
count)."""


def read(run, summary, name):
    return run.traced.get("token_gap_ms_p95")
