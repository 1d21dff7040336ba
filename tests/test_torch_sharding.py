"""The port's sharding rules, shape stand-ins and meshes held against the
JAX package.

- Spec trees: for every config, both production meshes (16 x 16 ("data",
  "model") and 2 x 16 x 16 ("pod", "data", "model")), ``MODE`` "2d" and
  "dp_only", and ``fsdp`` on and off, ``param_specs``, ``state_specs``,
  ``batch_specs`` (train and prefill shapes), ``cache_specs`` (decode
  shapes) and ``logits_spec`` equal the reference's entry for entry.  The
  reference's side gets a ``jax.sharding.AbstractMesh`` and the port's a
  ``sharding.MeshShape``: the rules read only axis names and sizes.  The
  port keeps a parameter a layer where the reference stacks the layers:
  a per-layer spec is compared with the reference's without its leading
  L entry.
- Shape stand-ins: ``launch.specs.input_specs`` gives the shapes and
  dtypes of the reference's ``ShapeDtypeStruct``s for every config and
  every ``SHAPES`` entry (per-layer leaves without the L axis).
- Placements: on four gloo ranks (``tests/torch_dist_ranks.py``) a (2, 2)
  mesh from ``make_local_mesh``; every parameter of the olmoe and hymba
  smoke models after ``distribute`` has, on each rank, the global dim
  divided by the sizes of the axes its entry names.  ``make_local_mesh``
  raises without a process group and when the model axis does not divide
  the ranks; ``make_production_mesh`` raises on 4 ranks and builds both
  production meshes on torch's fake backend of 256 and 512 ranks.
"""
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

import repro.sharding as RSH  # noqa: E402
from repro.config import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.launch import specs as RSP  # noqa: E402
from repro_torch import sharding as SH  # noqa: E402
from repro_torch.config import SHAPES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models.convert import reference_path  # noqa: E402
from torch_dist_ranks import SRC, run_ranks  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _ref_inputs(arch: str, shape: str):
    return RSP.input_specs(ref_get_config(arch), REF_SHAPES[shape])


@functools.lru_cache(maxsize=None)
def _port_inputs(arch: str, shape: str):
    return SP.input_specs(get_config(arch), SHAPES[shape])


def _shape(kind: str) -> str:
    return next(n for n, s in SHAPES.items() if s.kind == kind)


def _ref_node(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _check_tree(port: dict, ref, check) -> None:
    """Every port leaf (by parameter name) against the reference tree's
    leaf at its path, ``check(port_leaf, ref_leaf, name, layer)`` with
    ``layer`` true for a layer's leaf (the reference's has the L axis);
    and no reference leaf left out."""
    seen = set()
    for name, leaf in port.items():
        path, li = reference_path(name)
        seen.add(path)
        check(leaf, _ref_node(ref, path), name, li is not None)
    assert seen == {"/".join(str(getattr(k, "key", k)) for k in p)
                    for p, _ in jax.tree_util.tree_leaves_with_path(
                        ref, is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))}


def _same_spec(got, want, name: str, layer: bool) -> None:
    if layer:
        assert tuple(want)[0] is None, name
    assert tuple(got) == tuple(want)[layer:], name


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp"])
@pytest.mark.parametrize("mode", ["2d", "dp_only"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_spec_trees_match_reference(arch, mesh, mode, fsdp, monkeypatch):
    monkeypatch.setattr(RSH, "MODE", mode)
    monkeypatch.setattr(SH, "MODE", mode)
    sizes, names = MESHES[mesh]
    rmesh, tmesh = AbstractMesh(sizes, names), SH.MeshShape(names, sizes)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    rtrain, ttrain = _ref_inputs(arch, "train_4k"), \
        _port_inputs(arch, "train_4k")

    _check_tree(SH.param_specs(tmesh, cfg, ttrain["state"]["model"], fsdp),
                RSH.param_specs(rmesh, rcfg, rtrain["state"]["params"],
                                fsdp), _same_spec)
    tstate = SH.state_specs(tmesh, cfg, ttrain["state"], fsdp)
    rstate = RSH.state_specs(rmesh, rcfg, rtrain["state"], fsdp)
    assert tstate["opt"].step == rstate["opt"].step == ()
    for field in ("master", "mu", "nu"):
        _check_tree(getattr(tstate["opt"], field),
                    getattr(rstate["opt"], field), _same_spec)
    for kind in ("train", "prefill"):
        shape = SHAPES[_shape(kind)]
        got = SH.batch_specs(tmesh, cfg, shape)
        want = RSH.batch_specs(rmesh, rcfg, REF_SHAPES[shape.name])
        assert {k: tuple(v) for k, v in got.items()} \
            == {k: tuple(v) for k, v in want.items()}
    for shape in (n for n, s in SHAPES.items() if s.kind == "decode"):
        got = SH.cache_specs(tmesh, cfg, _port_inputs(arch, shape)["caches"])
        want = RSH.cache_specs(rmesh, rcfg, _ref_inputs(arch, shape)["caches"])
        assert {k: tuple(v) for k, v in got.items()} \
            == {k: tuple(v) for k, v in want.items()}
    assert tuple(SH.logits_spec(tmesh, cfg)) \
        == tuple(RSH.logits_spec(rmesh, rcfg))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "") if isinstance(x, torch.Tensor) \
        else np.dtype(x.dtype).name


def _same_shape(got, want, name: str = "", layer: bool = False) -> None:
    assert tuple(got.shape) == tuple(want.shape)[layer:], name
    assert _dtype(got) == _dtype(want), name
    assert got.device.type == "meta", name


def _check_params(port, ref) -> None:
    _check_tree(dict(port.named_parameters()) if isinstance(
        port, torch.nn.Module) else port, ref, _same_shape)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_configs())
def test_input_specs_match_reference(arch, shape):
    got, want = _port_inputs(arch, shape), _ref_inputs(arch, shape)
    assert set(got) == set(want)
    if "state" in want:
        _check_params(got["state"]["model"], want["state"]["params"])
        gopt, wopt = got["state"]["opt"], want["state"]["opt"]
        _same_shape(gopt.step, wopt.step)
        for field in ("master", "mu", "nu"):
            _check_params(getattr(gopt, field), getattr(wopt, field))
    else:
        _check_params(got["params"], want["params"])
    for key in ("batch", "caches"):
        if key in want:
            assert set(got[key]) == set(want[key])
            for k in want[key]:
                _same_shape(got[key][k], want[key][k], k)
    for key in ("token", "cache_len"):
        if key in want:
            _same_shape(got[key], want[key], key)


def test_spec_normalises_as_jax():
    """A one-name tuple is the name, a list a tuple, as in JAX."""
    P = jax.sharding.PartitionSpec
    for entries in [(("data",), None), (["pod", "data"], "model"), ()]:
        assert tuple(SH.P(*entries)) == tuple(P(*entries))


def test_placements_of_specs():
    mesh = SH.MeshShape(("pod", "data", "model"), (2, 16, 16))
    Sh, R = torch.distributed.tensor.Shard, \
        torch.distributed.tensor.Replicate
    assert SH.named(mesh, {"a": SH.P(("pod", "data"), None, "model")}) \
        == {"a": (Sh(0), Sh(0), Sh(2))}
    assert SH.placements(mesh, SH.P(None, "data")) == (R(), Sh(1), R())
    with pytest.raises(ValueError, match="order"):
        SH.placements(mesh, SH.P(("data", "pod")))
    with pytest.raises(ValueError, match="two dims"):
        SH.placements(mesh, SH.P("data", "data"))


def test_make_local_mesh_raises_without_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        MESH.make_local_mesh(1, "cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        MESH.make_production_mesh(device_type="cpu")


def test_production_meshes_on_a_fake_group():
    """Both production meshes on torch's fake backend of 256 and 512
    ranks (in a subprocess: the group is the process's)."""
    code = textwrap.dedent("""
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_production_mesh
        for multi_pod, world in ((False, 256), (True, 512)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            m = make_production_mesh(multi_pod=multi_pod,
                                     device_type="cpu")
            print(tuple(m.shape), m.mesh_dim_names)
            dist.destroy_process_group()
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split("\n")[:2] == [
        "(16, 16) ('data', 'model')",
        "(2, 16, 16) ('pod', 'data', 'model')"]


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placements")
    np.savez(tmp / "inputs.npz", unused=np.zeros(1))
    return run_ranks([("placements", 4, tmp)], timeout=150.0)[0]


def test_meshes_the_group_cannot_hold_raise(placed):
    for out in placed:
        errors = out["mesh_errors"]
        assert "does not divide" in errors["local_3"]
        assert "needs 256 ranks" in errors["production"]


def test_activation_constraint_on_ranks(placed):
    """A local tensor comes back as it was; a DTensor [4, 8, 2] is
    redistributed to batch over "data" and sequence over "model"."""
    for out in placed:
        assert out["constraint"] == {"local_unchanged": True,
                                     "act_local_shape": (2, 4, 2),
                                     "attrs": (("data",), True)}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "hymba-1.5b"])
def test_distribute_places_each_shard(placed, arch):
    sizes = {"data": 2, "model": 2}
    coords = sorted(tuple(out["coordinate"]) for out in placed)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    want_names = {n for n, _ in SP.input_specs(
        get_config(arch).smoke(), SHAPES["prefill_32k"])[
        "params"].named_parameters()}
    for out in placed:
        params = out["models"][arch]
        assert set(params) == want_names
        for name, (shape, local, spec, grad) in params.items():
            assert grad, name
            want = tuple(
                n if e is None else n // int(np.prod(
                    [sizes[a] for a in ((e,) if isinstance(e, str) else e)]))
                for n, e in zip(shape, spec))
            assert local == want, (name, shape, spec)
        assert any(s != l for s, l, *_ in params.values())
