"""``scan_fwd_roofline.<cell kind>``: the fused selective scan's least
time (``counts/kernels.py::scan_fwd`` of each call's shapes) over the
device time of what runs inside spans around the port's
``kernels.selective_scan.ops.selective_scan_fused``, in %."""
from port_bench.counts import kernels

SPANS = {"scan_fwd": "repro_torch.kernels.selective_scan.ops:"
                     "selective_scan_fused"}


def read(run, summary, name):
    seconds = summary.span_s.get("scan_fwd", 0.0)
    calls = run.spans.calls["scan_fwd"]
    if seconds <= 0 or not calls:
        return None
    bound = 0.0
    for args, _ in calls:
        b, t, di = args[0]["shape"]
        n = args[4]["shape"][1]
        bound += kernels.scan_fwd(b, t, di, n).bound_s()
    return 100.0 * bound / seconds
