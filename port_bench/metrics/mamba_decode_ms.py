"""``mamba_decode_ms.decode``: device milliseconds a decode step of what
the Mamba layers' one-token update launches (spans around the port's
``models.layers.mamba_decode``, every layer)."""

SPANS = {"mamba_decode": "repro_torch.models.layers:mamba_decode"}


def read(run, summary, name):
    seconds = summary.span_s.get("mamba_decode", 0.0)
    steps = run.traced.get("steps", 0)
    if seconds <= 0 or not steps:
        return None
    return 1e3 * seconds / steps
