"""``mfu.<cell kind>``: the model FLOPs of the traced steps
(``counts/model.py``: matrix products and attention's products, three
times the forward for a training step, the last position's vocabulary
projection for a prefill) over the traced window's seconds, over the
card's bf16 peak, in %."""
from port_bench.counts import peaks


def read(run, summary, name):
    flops = run.traced.get("model_flops")
    if not flops or summary.window_s <= 0 or summary.busy_s <= 0:
        return None
    return 100.0 * flops / summary.window_s / peaks.BF16_FLOPS
