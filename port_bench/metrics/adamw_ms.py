"""``adamw_ms.train``: device milliseconds a step of what the optimizer
launches (a span around the port's ``optim.adamw.update``)."""

SPANS = {"adamw": "repro_torch.optim.adamw:update"}


def read(run, summary, name):
    seconds = summary.span_s.get("adamw", 0.0)
    if seconds <= 0 or not run.spans.calls["adamw"]:
        return None
    return 1e3 * seconds / len(run.spans.calls["adamw"])
