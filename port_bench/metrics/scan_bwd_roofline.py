"""``scan_bwd_roofline.<cell kind>``: the fused selective scan's backward
least time (``counts/kernels.py::scan_bwd``: dy's shape, the
configuration's state size) over the device time of what runs inside
spans around the port's ``SelectiveScanFused.backward``, in %."""
from port_bench.counts import kernels

SPANS = {"scan_bwd": "repro_torch.kernels.selective_scan.ops:"
                     "SelectiveScanFused.backward"}


def read(run, summary, name):
    seconds = summary.span_s.get("scan_bwd", 0.0)
    calls = run.spans.calls["scan_bwd"]
    if seconds <= 0 or not calls:
        return None
    n = run.cfg["ssm_state"]
    bound = 0.0
    for args, _ in calls:
        b, t, di = args[1]["shape"]
        bound += kernels.scan_bwd(b, t, di, n).bound_s()
    return 100.0 * bound / seconds
