"""The port's roofline (``repro_torch/roofline.py``) and dry run
(``repro_torch/launch/dryrun.py``), held against the JAX package's.

- ``model_flops`` equals the reference's on every config and shape;
  ``_ring_bytes`` on every collective and group size; ``Roofline``'s
  terms, ``dominant``, MFU and record equal the reference's for the same
  inputs under the reference's constants, and are the quantities over
  NVIDIA's H100 SXM datasheet figures under the port's.
- ``StepCounter`` (the dispatcher's counterpart of ``analyze_hlo``):
  exact on a single matmul, scaling with a loop's trips under
  checkpointing and autograd, bytes on every operation, and each
  collective's ring bytes on a fake group, functional and c10d alike
  (the counterparts of ``tests/test_roofline.py``).
- Dry-run cells on a fake 4 x 4 group at the qwen3 and olmoe smoke
  configs (``train_4k``): status ok, FLOPs per device at least
  ``model_flops`` over the chips, every collective kind the reference's
  own dry run of the same cell shows (run on 16 fake XLA CPU devices in
  a subprocess, as ``tests/test_dryrun_integration.py`` runs it, its
  ``jax.make_mesh`` given ``AxisType.Auto`` axes and its ``get_config``
  the smoke configs), and a rank's FLOPs 1/16 of one rank's alone; the
  prefill and decode kinds; Qwen3-1.7B at full width on the 16 x 16
  production mesh (256 fake ranks) through ``run_cells``.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import torch.distributed as dist  # noqa: E402
import torch.distributed._functional_collectives as funcol  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro import roofline as RR  # noqa: E402
from repro.config import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_configs as ref_list_configs  # noqa: E402
from repro.launch import dryrun as RD  # noqa: E402
from repro_torch import roofline as R  # noqa: E402
from repro_torch.config import SHAPES  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
CELL_ARCHS = ("qwen3-1.7b", "olmoe-1b-7b")

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=16 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import json
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.launch import dryrun as D
    D.get_config = lambda arch: get_config(arch).smoke()
    mesh = jax.make_mesh((4, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in ("qwen3-1.7b", "olmoe-1b-7b"):
        rec = D.lower_cell(arch, "train_4k", mesh, "test4x4")
        out[arch] = {"status": rec["status"],
                     "colls": rec["collectives_by_op"]}
    print("RESULT " + json.dumps(out))
""")


# ----------------------------------------------------------------------
# the analytic pieces
# ----------------------------------------------------------------------
def test_configs_match_reference():
    assert list_configs() == ref_list_configs()
    assert list(SHAPES) == list(REF_SHAPES)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_matches_reference(shape):
    for arch in list_configs():
        for cut in (lambda c: c, lambda c: c.smoke()):
            got = R.model_flops(cut(get_config(arch)), SHAPES[shape])
            want = RR.model_flops(cut(ref_get_config(arch)),
                                  REF_SHAPES[shape])
            assert got == want, (arch, shape)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_skip_reason_matches_reference(shape):
    for arch in list_configs():
        assert D.skip_reason(get_config(arch), SHAPES[shape]) \
            == RD.skip_reason(ref_get_config(arch), REF_SHAPES[shape])


@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute", "x"])
def test_ring_bytes_match_reference(op):
    for s in (1, 2, 16, 256, 512):
        for b in (0.0, 1.0, 4096.0, 3.5e9):
            assert R._ring_bytes(op, b, s) == RR._ring_bytes(op, b, s)


ROOFLINES = [
    dict(flops_per_device=197e12, bytes_per_device=819e9 * 0.5,
         collective_bytes=50e9 * 0.25, model_flops_total=197e12 * 256 * 0.8),
    dict(flops_per_device=1e12, bytes_per_device=819e9 * 2,
         collective_bytes=50e9, model_flops_total=1e14),
    dict(flops_per_device=1e12, bytes_per_device=1e9,
         collective_bytes=50e9 * 3, model_flops_total=5e13,
         memory_per_device=7.0),
    dict(flops_per_device=0.0, bytes_per_device=0.0, collective_bytes=0.0,
         model_flops_total=0.0),
]


@pytest.mark.parametrize("case", range(len(ROOFLINES)))
def test_roofline_matches_reference(case, monkeypatch):
    """Under the reference's constants every term, ``dominant``, the
    bound, the FLOP ratio, MFU and the record equal the reference's."""
    for name, ref in (("PEAK_FLOPS", "PEAK_FLOPS"), ("HBM_BW", "HBM_BW"),
                      ("LINK_BW", "ICI_BW")):
        monkeypatch.setattr(R, name, getattr(RR, ref))
    kw = dict(arch="x", shape="train_4k", mesh="single", chips=256,
              **ROOFLINES[case])
    got, want = R.Roofline(**kw), RR.Roofline(**kw)
    for attr in ("compute_s", "memory_s", "collective_s", "dominant",
                 "bound_s", "useful_flops_ratio", "mfu"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.to_dict() == want.to_dict()


def test_roofline_takes_the_h100_datasheet_figures():
    """NVIDIA's H100 SXM figures, no TPU constant: dense bf16 989
    TFLOP/s, HBM3 3.35 TB/s, NVLink 4 450 GB/s a direction."""
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    rl = R.Roofline(arch="x", shape="train_4k", mesh="single", chips=256,
                    flops_per_device=989e12, bytes_per_device=3.35e12 * 0.5,
                    collective_bytes=450e9 * 0.25,
                    model_flops_total=989e12 * 256 * 0.8)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(0.5)
    assert rl.collective_s == pytest.approx(0.25)
    assert rl.dominant == "compute"
    assert rl.mfu == pytest.approx(0.8)
    assert rl.useful_flops_ratio == pytest.approx(0.8)


# ----------------------------------------------------------------------
# the counter
# ----------------------------------------------------------------------
def _count(fn, *shapes, grad=False):
    with FakeTensorMode():
        args = [torch.empty(s, requires_grad=grad) for s in shapes]
        with R.StepCounter() as c:
            fn(*args)
    return c.stats


def test_single_matmul_flops_exact():
    st = _count(lambda a, b: a @ b, (128, 512), (512, 64))
    assert st.flops == 2 * 128 * 512 * 64
    assert st.bytes_hbm == 4 * (128 * 512 + 512 * 64 + 128 * 64)


def test_flops_scale_with_loop_trips():
    """L layers of tanh(c @ w) under checkpointing, differentiated: the
    forward, its recompute and two backward products a layer."""
    def make(n):
        def f(ws, x):
            c = x
            for i in range(n):
                c = checkpoint(lambda c_, w: torch.tanh(c_ @ w), c, ws[i],
                               use_reentrant=False)
            torch.autograd.grad(torch.sum(c ** 2), [ws, x])
        return f
    flops = {n: _count(make(n), (n, 256, 256), (256, 256), grad=True).flops
             for n in (4, 16)}
    assert flops[16] == 4 * flops[4]
    assert flops[4] == 4 * 4 * 2 * 256 ** 3


def test_bytes_counted_on_every_operation():
    st = _count(lambda a: torch.sum(a * 2.0), (1 << 20,))
    # the product reads and writes the input's size, the sum reads it
    assert st.bytes_hbm >= 3 * 4 * (1 << 20)
    views = _count(lambda a: a.view(1024, 1024).T[:5].unsqueeze(0),
                   (1 << 20,))
    assert views.bytes_hbm == 0 and views.flops == 0


def test_collectives_counted_with_ring_bytes():
    """Each kind on a fake group of 8 ranks, through the functional
    collectives and through ``torch.distributed``'s (c10d) calls: counts
    and ring bytes as ``_ring_bytes`` of the result and the group."""
    n, elems = 8, 1024
    with D.fake_group(n):
        with FakeTensorMode():
            x = torch.empty(elems)
            with R.StepCounter() as c:
                funcol.all_gather_tensor(x, 0, dist.group.WORLD)
                funcol.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD)
                funcol.all_reduce(x, "sum", dist.group.WORLD)
                funcol.all_to_all_single(x, None, None, dist.group.WORLD)
                out = torch.empty(n * elems)
                dist.all_gather_into_tensor(out, x)
                dist.all_reduce(x)
    st = c.stats
    b = 4.0 * elems
    want = {"all-gather": 2 * R._ring_bytes("all-gather", n * b, n),
            "reduce-scatter": R._ring_bytes("reduce-scatter", b / n, n),
            "all-reduce": 2 * R._ring_bytes("all-reduce", b, n),
            "all-to-all": R._ring_bytes("all-to-all", b, n)}
    assert st.coll_by_op == pytest.approx(want)
    assert st.coll_counts == {"all-gather": 2, "reduce-scatter": 1,
                              "all-reduce": 2, "all-to-all": 1}
    assert st.collective_bytes == pytest.approx(sum(want.values()))


# ----------------------------------------------------------------------
# dry-run cells
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_cells():
    r = subprocess.run([sys.executable, "-c", REFERENCE],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=SRC,
                                JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[0][len("RESULT "):])


def _cell(arch, shape, n):
    """``lower_cell`` at ``arch``'s smoke config (its ``get_config``
    patched, as the reference's test patches the reference's) on an
    n x n mesh of a fake group."""
    orig = D.get_config
    D.get_config = lambda a: orig(a).smoke()
    try:
        with D.fake_group(n * n):
            mesh = init_device_mesh("cpu", (n, n),
                                    mesh_dim_names=("data", "model"))
            return D.lower_cell(arch, shape, mesh, f"{n}x{n}")
    finally:
        D.get_config = orig


@pytest.fixture(scope="module")
def cells():
    return {arch: _cell(arch, "train_4k", 4) for arch in CELL_ARCHS}


KEYS = ("arch", "shape", "mesh", "chips", "tag", "status", "lower_s",
        "compile_s", "xla_cost_analysis", "argument_bytes", "output_bytes",
        "alias_bytes", "temp_bytes", "collectives_by_op",
        "collective_counts", "roofline", "bytes_by_op_top")


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_dryrun_cell_on_fake_4x4(cells, reference_cells, arch):
    rec = cells[arch]
    assert tuple(rec) == KEYS
    assert rec["status"] == "ok" == reference_cells[arch]["status"]
    rl = rec["roofline"]
    assert rl["chips"] == 16 and rl["flops_per_device"] > 0
    assert rl["flops_per_device"] * 16 >= rl["model_flops_total"] \
        == R.model_flops(get_config(arch).smoke(), SHAPES["train_4k"])
    assert any(op in rec["collectives_by_op"] for op in
               ("all-reduce", "reduce-scatter", "all-gather"))
    assert set(reference_cells[arch]["colls"]) \
        <= set(rec["collectives_by_op"])
    assert rec["alias_bytes"] > 0 and rl["memory_per_device"] \
        == rec["argument_bytes"]
    if arch == "olmoe-1b-7b":        # the sequence-sharded MoE's exchange:
        # two all-to-alls in the forward, its recompute and the backward
        assert rec["collective_counts"]["all-to-all"] \
            == 6 * get_config(arch).smoke().num_layers


def test_dryrun_flops_split_over_the_ranks(cells):
    """A rank of the 4 x 4 mesh (its 16 of the 256 rows) counts 1/16 of
    the FLOPs one rank counts for the whole batch."""
    one = _cell("qwen3-1.7b", "train_4k", 1)
    assert one["collectives_by_op"] == {}
    assert one["roofline"]["flops_per_device"] \
        == 16 * cells["qwen3-1.7b"]["roofline"]["flops_per_device"]


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dryrun_inference_cells(shape):
    rec = _cell("qwen3-1.7b", shape, 4)
    assert rec["status"] == "ok" and rec["alias_bytes"] == 0
    assert rec["roofline"]["flops_per_device"] > 0
    assert "all-gather" in rec["collectives_by_op"]


def test_dryrun_full_width_on_the_production_mesh(tmp_path):
    """Qwen3-1.7B at full width and depth, train_4k, on the 16 x 16 mesh
    of 256 fake ranks through ``run_cells``: one record a cell in the
    dir, read back on a second call."""
    recs = D.run_cells(["qwen3-1.7b"], ["train_4k"], ["single"], tmp_path)
    (rec,) = recs
    assert rec["status"] == "ok" and rec["chips"] == 256
    rl = rec["roofline"]
    assert rl["flops_per_device"] * 256 >= rl["model_flops_total"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} \
        <= set(rec["collectives_by_op"])
    path = tmp_path / "qwen3-1.7b__train_4k__single.json"
    assert json.loads(path.read_text()) == rec
    assert D.run_cells(["qwen3-1.7b"], ["train_4k"], ["single"],
                       tmp_path) == [rec]
