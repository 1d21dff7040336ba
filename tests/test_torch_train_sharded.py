"""The port's train loop on DTensor state across ranks, held against the
JAX package's ``train_loop(model_parallel=2)`` and against the port's own
one-device loop.

Four gloo ranks on the CPU (``tests/torch_dist_ranks.py``, job
``sharded``: ``train``, ``norm`` and ``moe_train`` in one start) run ``train_loop(model_parallel=2)`` on a (2, 2) mesh for the
qwen3 and olmoe smoke configs, 3 steps of a 4 x 16 batch, from a step-0
checkpoint of the reference's initial state with fp32 parameters (both
packages' ``layers.DTYPE`` set to fp32, so the restored state is fp32;
AdamW casts every parameter to bf16, so steps 2 and 3 run on bf16
parameters).  The reference runs the same loop from the same checkpoint
on 4 fake XLA CPU devices in a subprocess (``XLA_FLAGS`` set before JAX
starts).  Its ``jax.make_mesh`` is given ``AxisType.Auto`` axes there:
this JAX makes explicit-sharding meshes by default, under which the
reference's embedding gather raises.

- Against the reference: the first loss (fp32 parameters) within 1e-4,
  the bf16 steps' within 2e-2, the tolerances of
  ``tests/test_torch_train.py`` (measured: ~1e-7 and ~3.4e-4).
- Against the port's one-device loop from the same checkpoint, step by
  step: every loss within 1e-4, masters within 1e-4 of each tensor's
  largest; moments within 1e-4 and parameters within one bf16 step after
  the fp32 step, both within 2e-2 of the largest after the bf16 steps (a
  bf16 product rounds a rank's rows apart from the whole batch's).
- The sharded state keeps ``state_specs``' placements after the steps;
  the step-0 checkpoint restored under them and saved again is the
  reference's file, byte for byte (manifest and arrays).
- ``adamw.global_norm`` on leaves of five placements, and ``update``
  with a ``Partial`` gradient (reduced once), against whole tensors.
- The train step with the sequence-sharded MoE on DTensor state (4
  ranks, grad_accum 1 and 2) against the one-device step, at capacity
  factor 8.
- A one-rank gloo group in this process: ``train_loop`` on the (1, 1)
  mesh equals the one-device loop bit for bit, at grad_accum 1 and 2.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import steps as RS  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import steps as S  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from torch_dist_ranks import (NORM_SPECS, SRC, TRAIN, TRAIN_ARCHS,  # noqa: E402
                              run_ranks)

TOL = 1e-4                # fp32 parameters, and port against port
BF16_TOL = 2e-2           # the reference's bf16 steps
RANKS_TIMEOUT = 240.0

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import json
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    _make_mesh = jax.make_mesh
    jax.make_mesh = lambda shape, names, **kw: _make_mesh(
        shape, names, axis_types=(AxisType.Auto,) * len(shape), **kw)
    from repro.configs import get_config
    from repro.launch.train import train_loop
    from repro.models import layers as RL
    RL.DTYPE = jnp.float32
    tmp, kw = sys.argv[1], json.loads(sys.argv[2])
    out = {}
    for arch in kw.pop("archs"):
        run = train_loop(get_config(arch).smoke(),
                         ckpt_dir=os.path.join(tmp, arch, "ref"),
                         save_every=kw["steps"], log_every=1,
                         log=lambda *a: None, **kw)
        out[arch] = {"losses": run["losses"],
                     "final_step": run["final_step"]}
    print("REFERENCE " + json.dumps(out))
""")


def _quiet(*_):
    pass


MOE_BATCH = (8, 16)          # 2 rows a rank: one a micro-batch at accum 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's records, the ranks' records, the port's one-device
    runs by arch, the dir, the norm and MoE inputs): every train loop
    starts from the same step-0 checkpoint, the reference's fresh state
    in fp32 (written here into each run's dir).  The reference runs in
    its subprocess while the ranks run."""
    tmp = tmp_path_factory.mktemp("train_sharded")
    old = RL.DTYPE
    RL.DTYPE = jnp.float32
    try:
        for arch in TRAIN_ARCHS:
            st = RS.init_state(jax.random.PRNGKey(0),
                               ref_get_config(arch).smoke())
            for sub in ("ref", "sharded", "single", "first"):
                ref_ckpt.save(st, 0, str(tmp / arch / sub))
    finally:
        RL.DTYPE = old
    rng = np.random.default_rng(11)
    arrays = {f"a{i}": rng.standard_normal((8, 12)).astype(np.float32)
              for i in range(len(NORM_SPECS))}
    arrays["g"] = rng.standard_normal((6, 4)).astype(np.float32)
    arrays["m"] = rng.standard_normal((6, 4)).astype(np.float32)
    vocab = get_config("olmoe-1b-7b").smoke().vocab_size
    for k in ("tokens", "targets"):
        arrays[k] = rng.integers(0, vocab, MOE_BATCH).astype(np.int32)
    np.savez(tmp / "inputs.npz", dir=np.array(str(tmp)),
             dtype=np.array("float32"), **arrays)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    kw = dict(TRAIN, archs=list(TRAIN_ARCHS))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp),
                            json.dumps(kw)], env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        ranks = run_ranks([("sharded", 4, tmp)], RANKS_TIMEOUT)[0]
        single = {}
        L_old = L.DTYPE
        L.DTYPE = torch.float32
        try:
            for arch in TRAIN_ARCHS:
                single[arch] = train_loop(
                    get_config(arch).smoke(),
                    ckpt_dir=str(tmp / arch / "single"),
                    save_every=1, log_every=1, log=_quiet,
                    device="cpu", **dict(TRAIN, model_parallel=1))
        finally:
            L.DTYPE = L_old
        out, err = ref.communicate(timeout=RANKS_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("REFERENCE ")]
    reference = json.loads(line[0][len("REFERENCE "):])
    return (reference, ranks[0]["train"], single, tmp, arrays,
            [r["norm"] for r in ranks], [r["moe_train"] for r in ranks])


def _files(d):
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as data:
        return manifest, {k: data[k] for k in data.files}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if got.size else 0.0
    return err / scale if scale else err


def _bf16_steps(got, want) -> int:
    """Largest distance in bf16 steps between two arrays of bf16 values
    (stored widened to fp32)."""
    def line(a):
        b = torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
        return np.where(b < 0, -32768 - b, b)
    return int(np.abs(line(got) - line(want)).max()) if np.size(got) else 0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_loop_matches_reference(runs, arch):
    reference, ranks, *_ = runs
    want = reference[arch]["losses"]
    got = ranks[arch]["losses"]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    assert ranks[arch]["final_step"] == reference[arch]["final_step"] == 3
    (_, g1), (_, w1) = got[0], want[0]
    assert abs(g1 - w1) <= TOL * abs(w1), (g1, w1)
    for (_, g), (_, w) in zip(got[1:], want[1:]):
        assert abs(g - w) <= BF16_TOL * abs(w), (g, w)


@pytest.mark.parametrize("step", [1, 2, 3])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_loop_matches_one_device_loop(runs, arch, step):
    """The loss, and the checkpoint each loop wrote after the step (rank 0
    for the sharded one), leaf by leaf.  Step 1 runs on fp32 parameters:
    moments within 1e-4 of each tensor's largest.  Steps 2 and 3 run on
    bf16 parameters, whose products round each rank's rows apart from the
    whole batch's: their gradients, and so the moments, agree to bf16's
    2e-2 (measured ~0.6% for mu, ~1.5% for nu: one bf16 step of a
    gradient), and so do the parameters (AdamW's m / sqrt(v) moves an
    element whose gradient is near 0 by a whole lr on a last-bit
    difference: up to 40 bf16 steps near 0, 0.2% of the largest).  The
    fp32 masters within 1e-4 of the largest throughout, the parameters
    within one bf16 step after step 1."""
    _, ranks, single, tmp, *_ = runs
    (s1, g), = [x for x in ranks[arch]["losses"] if x[0] == step]
    (s2, w), = [x for x in single[arch]["losses"] if x[0] == step]
    assert abs(g - w) <= TOL * abs(w), (g, w)
    gm, ga = _files(tmp / arch / "sharded" / f"step_{step}")
    wm, wa = _files(tmp / arch / "single" / f"step_{step}")
    assert gm == wm
    assert int(ga["opt__.step"]) == int(wa["opt__.step"]) == step
    moments = TOL if step == 1 else BF16_TOL
    for key in wa:
        if key.startswith(("opt__.mu", "opt__.nu")):
            assert _rel(ga[key], wa[key]) <= moments, key
        elif key.startswith("opt__.master"):
            assert _rel(ga[key], wa[key]) <= TOL, key
        elif key.startswith("params"):
            assert wm["leaves"][key.replace("__", "/")]["dtype"] \
                == "bfloat16", key
            if step == 1:
                assert _bf16_steps(ga[key], wa[key]) <= 1, key
            else:
                assert _rel(ga[key], wa[key]) <= BF16_TOL, key


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_state_keeps_state_specs(runs, arch):
    """After the steps every parameter, master, moment and the step keep
    the placements ``named(state_specs)`` gives (rank 0 and rank 3 of
    the (2, 2) mesh)."""
    _, ranks, *_ = runs
    assert ranks[arch]["placed"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_checkpoint_is_the_references_file(runs, arch):
    """The reference's step-0 checkpoint, restored under ``state_specs``
    on the (2, 2) mesh and saved again by the sharded state (gathered, one
    rank writing): the same manifest, the same npz arrays, byte for byte;
    likewise restored and saved by the one-device port."""
    tmp = runs[3]
    rm, ra = _files(tmp / arch / "first" / "step_0")
    for sub in ("resaved",):
        pm, pa = _files(tmp / arch / sub / "step_0")
        assert list(pm["leaves"]) == list(rm["leaves"]) and pm == rm
        assert list(pa) == list(ra)
        for k in ra:
            assert pa[k].dtype == ra[k].dtype \
                and pa[k].tobytes() == ra[k].tobytes(), k
    old = L.DTYPE
    L.DTYPE = torch.float32
    try:
        like = S.state_shapes(get_config(arch).smoke())
        st, _ = ckpt.restore(like, str(tmp / arch / "first"), step=0,
                             device="cpu")
    finally:
        L.DTYPE = old
    ckpt.save(st, 0, str(tmp / arch / "unsharded"))
    um, ua = _files(tmp / arch / "unsharded" / "step_0")
    assert um == rm and all(ua[k].tobytes() == ra[k].tobytes() for k in ra)


@pytest.fixture(scope="module")
def norm_run(runs):
    return runs[4], runs[5]


def test_global_norm_sharded_matches_whole(norm_run):
    """Leaves sharded on both dims, on one, on the other, replicated, and
    in the mesh's reverse order: every rank's norm is the whole tensors'
    and the reference's (each element counted once, not once a rank)."""
    arrays, outs = norm_run
    leaves = [arrays[f"a{i}"] for i in range(len(NORM_SPECS))]
    whole = float(adamw.global_norm([torch.from_numpy(a) for a in leaves]))
    want = float(ref_adamw.global_norm([jnp.asarray(a) for a in leaves]))
    assert abs(whole - want) <= 1e-6 * want
    bf = float(adamw.global_norm([torch.from_numpy(a).bfloat16()
                                  for a in leaves]))
    for out in outs:
        assert abs(out["norm"] - whole) <= 1e-6 * whole
        assert abs(out["norm_bf16"] - bf) <= 1e-6 * bf


def test_partial_gradient_reduced_once(norm_run):
    """A replicated master whose gradient arrives ``Partial`` (each rank a
    quarter): the norm and the update are those of the whole gradient on
    one device, on every rank."""
    arrays, outs = norm_run
    opt = adamw.init({"w": torch.from_numpy(arrays["m"])})
    params, opt, m = adamw.update({"w": torch.from_numpy(arrays["g"])},
                                  opt, TrainConfig())
    for out in outs:
        assert abs(out["update_norm"] - float(m["grad_norm"])) \
            <= 1e-6 * float(m["grad_norm"])
        assert _rel(out["master"], opt.master["w"].numpy()) <= 1e-6
        assert _rel(out["mu"], opt.mu["w"].numpy()) <= 1e-6
        assert _bf16_steps(out["param"], params["w"].float().numpy()) == 0


@pytest.fixture(scope="module")
def moe_run(runs):
    return {k: runs[4][k] for k in ("tokens", "targets")}, runs[6]


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_moe_train_step_matches_one_device(moe_run, accum):
    """The train step on DTensor state with the sequence-sharded MoE
    (``moe_shard_map``'s differentiable all-to-alls, the experts kept as
    DTensors, each rank's rows exchanged onto the sequence) against the
    one-device step at capacity factor 8 (no pair drops in either): loss,
    grad norm and lr within 1e-4 on every rank, the first moments (the
    gradients) within 1e-4 of each tensor's largest; two all-to-alls a
    MoE layer in the forward, its recompute and the backward, a
    micro-batch."""
    arrays, outs = moe_run
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").smoke(),
                              capacity_factor=8.0)
    state = S.init_state(cfg, seed=0, device="cpu", dtype=torch.float32)
    step = S.make_train_step(cfg, TrainConfig(total_steps=10,
                                              warmup_steps=2),
                             ParallelConfig(grad_accum=accum))
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in arrays.items()})
    for out in outs:
        got = out[accum]
        for k in ("loss", "grad_norm", "lr"):
            assert abs(got["metrics"][k] - float(m[k])) \
                <= TOL * abs(float(m[k])), k
        for n, t in state["opt"].mu.items():
            assert _rel(got["mu"][n], t.numpy()) <= TOL, n
        assert got["launches"]["all_to_all"] \
            == 6 * accum * cfg.num_layers


@pytest.mark.parametrize("accum", [1, 2])
def test_one_rank_mesh_loop_equals_one_device_loop(tmp_path, accum):
    """``train_loop`` on the (1, 1) mesh of a one-rank group (DTensor
    state, a checkpoint saved and restored through a kill), at grad_accum
    1 and 2, ends where the one-device loop ends, bit for bit: losses and
    every leaf."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").smoke(), num_layers=1)
    kw = dict(steps=4, batch=2, seq=16, device="cpu", log=_quiet,
              log_every=1, save_every=2,
              parallel=ParallelConfig(seq_shard_activations=False,
                                      grad_accum=accum))
    plain = train_loop(cfg, ckpt_dir=str(tmp_path / "plain"), **kw)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = train_loop(cfg, ckpt_dir=str(tmp_path / "mesh"), fail_at=3,
                          **kw)
    finally:
        dist.destroy_process_group()
    assert mesh["restarts"] == 1 and mesh["final_step"] == 4
    assert dict(mesh["losses"]) == dict(plain["losses"])
    pm, pa = _files(tmp_path / "plain" / "step_4")
    mm, ma = _files(tmp_path / "mesh" / "step_4")
    assert mm == pm and all(ma[k].tobytes() == pa[k].tobytes() for k in pa)
