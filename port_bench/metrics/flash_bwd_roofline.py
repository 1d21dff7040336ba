"""``flash_bwd_roofline.<cell kind>``: flash attention's backward least
time (``counts/kernels.py::flash_bwd``: dout's shape, the autograd
context's causality and window, the configuration's KV heads) over the
device time of what runs inside spans around the port's
``FlashAttention.backward``, in %."""
from port_bench.counts import kernels

SPANS = {"flash_bwd": "repro_torch.kernels.flash_attention.ops:"
                      "FlashAttention.backward"}
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(run, summary, name):
    seconds = summary.span_s.get("flash_bwd", 0.0)
    calls = run.spans.calls["flash_bwd"]
    if seconds <= 0 or not calls:
        return None
    kvh = run.cfg["num_kv_heads"]
    bound = 0.0
    for args, _ in calls:
        ctx, dout = args[0], args[1]
        b, h, s, d = dout["shape"]
        bound += kernels.flash_bwd(b, h, kvh, s, s, d, ctx["causal"],
                                   ctx["window"],
                                   ITEMSIZE[dout["dtype"]]).bound_s()
    return 100.0 * bound / seconds
