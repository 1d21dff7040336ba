"""The port's expert-parallel MoE (``models/moe_sharded.py``) across real
ranks, held against the JAX package.

Four gloo ranks on the CPU (``tests/torch_dist_ranks.py``: a ``FileStore``
under the test's tmp dir, one thread a rank, every run under a time
limit) make a (2, 2) ("data", "model") mesh.  The MoE is the olmoe smoke
config at top-k 2, fp32, with distinct random weights for each expert,
in both of the reference's strategies: expert parallel (E 4) and the TP
fallback (E 3).

- With drops (capacity factor 1.0): against the reference's own
  ``moe_shard_map`` on 4 fake XLA CPU devices, run in a subprocess as
  ``tests/test_moe_sharded.py`` runs it.  Capacity is per (expert,
  source shard) there, where ``layers.moe`` counts per batch row, so
  other pairs drop and only the sharded reference can be held.  Each
  rank's experts, slots and kept pairs equal the reference's on the same
  shard (recorded inside its ``shard_map`` with ``jax.debug.callback``),
  and the outputs agree within 1e-5 of the largest.
- Without drops (capacity factor 8): the output against the reference's
  ``layers.moe``, and the gradients of x, the router and the experts
  (each rank's shards gathered) against the port's plain ``layers.moe``,
  within 1e-5; the collective calls, forward and backward.
- The olmoe smoke model (2 layers, the reference's parameters in fp32,
  capacity factor 8) through ``make_prefill_step`` with the
  sequence-sharded constraint on (1, 2) and (2, 2) meshes: every MoE
  layer on the sharded path (two all-to-alls a layer), the logits within
  1e-4 of the largest of the reference's ``make_prefill_step``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import steps as RS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from torch_dist_ranks import SRC, run_ranks  # noqa: E402

B, S, D, F = 4, 16, 64, 128       # x [B, S, d]: 2 x 8 tokens a rank
CASES = {"ep": 4, "tp": 3}        # experts: 4 % 2 == 0 -> all-to-all
TOL = 1e-5
PREFILL_TOL = 1e-4
PREFILL_TOKENS = (2, 16)
RANKS_TIMEOUT = 240.0

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.models import moe_sharded as MS

    tmp = sys.argv[1]
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    routes, tag = {}, [None]
    orig = MS._topk_dispatch

    def record(x, router, k, e, cap):
        res = orig(x, router, k, e, cap)

        def keep_(di, mi, fe, pos, kp):
            routes[(tag[0], int(di), int(mi))] = np.stack(
                [np.asarray(fe), np.asarray(pos), np.asarray(kp, np.int32)])
        jax.debug.callback(keep_, jax.lax.axis_index("data"),
                           jax.lax.axis_index("model"), *res[1:4])
        return res

    MS._topk_dispatch = record
    base = get_config("olmoe-1b-7b").smoke()
    out = {}
    for t, e in (("ep", 4), ("tp", 3)):
        tag[0] = t
        cfg = dataclasses.replace(base, num_experts=e, top_k=2,
                                  capacity_factor=1.0)
        ep = e % 2 == 0
        spec = {"router": P("data", None),
                "we_gate": P("model", "data", None) if ep
                else P(None, "data", "model"),
                "we_up": P("model", "data", None) if ep
                else P(None, "data", "model"),
                "we_down": P("model", None, "data") if ep
                else P(None, "model", "data")}
        put = lambda a, s: jax.device_put(jnp.asarray(a),
                                          NamedSharding(mesh, s))
        p = {n: put(inp[f"{t}_{n}"], s) for n, s in spec.items()}
        x = put(inp["x"], P("data", "model", None))
        with mesh:
            y = jax.jit(lambda p_, x_: MS.moe_shard_map(
                p_, cfg, x_, mesh, ("data",)))(p, x)
            out[f"{t}_y"] = np.asarray(y)
        jax.effects_barrier()
    for (t, di, mi), r in routes.items():
        out[f"{t}_routes_{di}_{mi}"] = r
    np.savez(os.path.join(tmp, "reference.npz"), **out)
    print("REFERENCE OK")
""")


def _close(got, want, tol: float) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _prefill_cfg():
    return dataclasses.replace(ref_get_config("olmoe-1b-7b").smoke(),
                               capacity_factor=8.0)


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _inputs() -> dict:
    """Seeded fp32 inputs: x and a cotangent [B, S, d], each case's router
    and experts (every expert its own weights), the reference's olmoe
    smoke parameters (fp32) and prefill tokens."""
    rng = np.random.default_rng(31)
    out = {"x": rng.standard_normal((B, S, D)),
           "cot": rng.standard_normal((B, S, D))}
    for tag, e in CASES.items():
        out[f"{tag}_router"] = rng.standard_normal((D, e))
        out[f"{tag}_we_gate"] = rng.standard_normal((e, D, F)) / D ** 0.5
        out[f"{tag}_we_up"] = rng.standard_normal((e, D, F)) / D ** 0.5
        out[f"{tag}_we_down"] = rng.standard_normal((e, F, D)) / F ** 0.5
    out = {k: v.astype(np.float32) for k, v in out.items()}
    params = init_params(jax.random.PRNGKey(0), _prefill_cfg())
    for path, a in _flat(params).items():
        out[f"param/{path}"] = np.asarray(a, np.float32)
    out["tokens"] = rng.integers(0, 256, PREFILL_TOKENS).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess and the port's ranks, run together: the
    MoE cases on (2, 2), the prefill on (2, 2) and (1, 2)."""
    dirs = {k: tmp_path_factory.mktemp(k) for k in
            ("reference", "moe", "prefill22", "prefill12")}
    inputs = _inputs()
    for d in dirs.values():
        np.savez(d / "inputs.npz", **inputs)
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": str(dirs["reference"]), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(dirs["reference"])], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        moe, pre22, pre12 = run_ranks([("moe", 4, dirs["moe"]),
                                       ("prefill", 4, dirs["prefill22"]),
                                       ("prefill", 2, dirs["prefill12"])],
                                      RANKS_TIMEOUT)
        stdout, stderr = ref.communicate(timeout=RANKS_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REFERENCE OK" in stdout, stderr[-3000:]
    with np.load(dirs["reference"] / "reference.npz") as f:
        reference = dict(f)
    return {"inputs": inputs, "reference": reference, "moe": moe,
            "prefill": {(2, 2): pre22, (1, 2): pre12}}


def _cfg(tag: str, cf: float):
    return dataclasses.replace(get_config("olmoe-1b-7b").smoke(),
                               num_experts=CASES[tag], top_k=2,
                               capacity_factor=cf)


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_moe_with_drops_matches_reference(runs, tag):
    ref, inp = runs["reference"], runs["inputs"]
    dropped = 0
    for out in runs["moe"]:
        rec = out[f"{tag}_1.0"]
        di, mi = out["coordinate"]
        (fe, pos, keep), = rec["routes"]
        want = ref[f"{tag}_routes_{di}_{mi}"]
        np.testing.assert_array_equal(fe, want[0])
        np.testing.assert_array_equal(pos, want[1])
        np.testing.assert_array_equal(keep, want[2].astype(bool))
        dropped += int((~keep).sum())
        _close(rec["y"], ref[f"{tag}_y"], TOL)
    assert dropped > 0, "the case must drop pairs"
    assert inp["x"].shape == runs["moe"][0][f"{tag}_1.0"]["y"].shape


def _plain(tag: str, inp: dict):
    """The port's plain ``layers.moe`` at capacity factor 8: output and
    the gradients of (y * cot).sum() for x and the four weights."""
    cfg = _cfg(tag, 8.0)
    p = L.init_moe(cfg, None, "cpu")
    p.load_state_dict({n: torch.from_numpy(inp[f"{tag}_{n}"]) for n in
                       ("router", "we_gate", "we_up", "we_down")},
                      assign=True)
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y = L.moe(p, cfg, x)
    grads = torch.autograd.grad((y * torch.from_numpy(inp["cot"])).sum(),
                                [x, p.router, p.we_gate, p.we_up,
                                 p.we_down])
    return y.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_moe_without_drops_matches_layers_moe(runs, tag):
    inp = runs["inputs"]
    cfg = dataclasses.replace(ref_get_config("olmoe-1b-7b").smoke(),
                              num_experts=CASES[tag], top_k=2,
                              capacity_factor=8.0)
    p = {n: jnp.asarray(inp[f"{tag}_{n}"]) for n in
         ("router", "we_gate", "we_up", "we_down")}
    want = np.asarray(RL.moe(p, cfg, jnp.asarray(inp["x"])))
    for out in runs["moe"]:
        rec = out[f"{tag}_8.0"]
        assert all(k.all() for _, _, k in rec["routes"])
        _close(rec["y"], want, TOL)


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_moe_gradients_match_plain_moe(runs, tag):
    y, grads = _plain(tag, runs["inputs"])
    for out in runs["moe"]:
        rec = out[f"{tag}_8.0"]
        _close(rec["y"], y, TOL)
        for name, got, want in zip(("x", "router", "we_gate", "we_up",
                                    "we_down"), rec["grads"], grads):
            assert float(np.abs(want).max()) > 0, name
            _close(got, want, TOL)


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_moe_collectives(runs, tag):
    """EP: the four weights gathered over "data" and two all-to-alls;
    TP: the weights and the sequence gathered and one reduce-scatter;
    the backward calls each one's transpose."""
    fwd = {"ep": {"all_gather": 4, "all_to_all": 2, "reduce_scatter": 0},
           "tp": {"all_gather": 5, "all_to_all": 0, "reduce_scatter": 1}}
    both = {"ep": {"all_gather": 4, "all_to_all": 4, "reduce_scatter": 4},
            "tp": {"all_gather": 6, "all_to_all": 0, "reduce_scatter": 6}}
    for out in runs["moe"]:
        assert out[f"{tag}_1.0"]["launches"] == fwd[tag]
        assert out[f"{tag}_8.0"]["launches_with_backward"] == both[tag]
        assert out[f"{tag}_8.0"]["y_shard_dims"] == (0, 1)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_olmoe_prefill_through_constraint_matches_reference(runs, mesh):
    cfg = _prefill_cfg()
    inp = runs["inputs"]
    params = jax.tree.map(jnp.asarray, init_params(jax.random.PRNGKey(0),
                                                   cfg))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    want = np.asarray(RS.make_prefill_step(cfg, ParallelConfig())(
        params, {"tokens": jnp.asarray(inp["tokens"])}))
    for out in runs["prefill"][mesh]:
        assert out["mesh"] == mesh
        assert out["plain_moe_calls"] == 0
        assert out["launches"]["all_to_all"] == 2 * cfg.num_layers
        _close(out["logits"], want, PREFILL_TOL)
