"""The dense configs beyond Qwen3-1.7B held against the JAX package.

``qwen2.5-14b`` (QKV bias), ``minitron-4b`` (a 256,000-token vocabulary
at full width) and ``granite-34b`` (MQA: 48 query heads on one KV head at
full width) on their smoke configs, with the reference's parameters
carried over by ``from_reference``:

* one train step of each package at grad_accum 1 and 2
  (``test_torch_train.check_train_step``: loss, grad norm and lr within
  1e-4, moments and masters within 1e-4 of each tensor's largest, the new
  parameters within one bf16 step);
* the serving engines in fp32, with and without device-pool pressure:
  identical tokens, stats and pool byte counters;
* the engines on Granite's smoke config widened to 48:1 heads (the
  paged kernel's three 16-row chunks) and to 17:1 (a full chunk and a
  ragged one of one row), so the plain paged version the port's CPU
  engine takes is held against the reference at the groups the kernel
  now takes;
* ``supports`` of both attention kernels over every attention config in
  the registry: each is accepted, so no config's decode or prefill on the
  card meets a refusal the reference does not have.

The port's engine runs on ``torch_device="cpu"`` here; the card run
(``chip_smoke.py`` phases 5 and 20) holds the kernels against the plain
versions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.serving as ref_serving  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_kernel)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention as paged_kernel)
from repro_torch.models import from_reference  # noqa: E402
from test_torch_train import check_train_step  # noqa: E402

ARCHS = ["qwen2.5-14b", "minitron-4b", "granite-34b"]
# (zones and pages of the engines, requests, prompt lengths, new tokens):
# ``tests/test_torch_serving.py``'s two settings
NO_PRESSURE = (dict(hbm_zones=16, host_zones=16, pages_per_zone=4,
                    page_size=8, max_batch=1, cache_zones=0), 1, (8, 9), 5)
PRESSURE = (dict(hbm_zones=3, host_zones=48, pages_per_zone=2, page_size=8,
                 max_batch=4, cache_zones=1), 3, (10, 20), 4)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, accum):
    check_train_step(arch, accum)


def _run_engines(cfg, setting, seed: int = 1):
    """The reference's and the port's engines on ``cfg`` (a reference
    config, smoke sized; the port's is the same dataclass's fields) with
    the reference's fp32 parameters from seed 0, serving the same seeded
    requests: (port engine, reference engine, their run() stats)."""
    kw, n_req, (lo, hi), new = setting
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          init_params(jax.random.PRNGKey(0), cfg))
    tcfg = ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})
    port = serving.ServingEngine(
        tcfg, from_reference(tcfg, params, device="cpu"),
        torch_device="cpu", **kw)
    ref = ref_serving.ServingEngine(cfg, jax.tree.map(jnp.asarray, params),
                                    **kw)
    stats = []
    for eng, pkg in ((port, serving), (ref, ref_serving)):
        rng = np.random.default_rng(seed)
        for i in range(n_req):
            n = int(rng.integers(lo, hi))
            eng.submit(pkg.Request(
                rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                .astype(np.int32), max_new_tokens=new))
        stats.append(eng.run(max_steps=80))
    return port, ref, stats


def _check_engines(cfg, setting) -> None:
    port, ref, (got, want) = _run_engines(cfg, setting)
    assert [r.out_tokens for r in port.done] == \
        [r.out_tokens for r in ref.done]
    assert got == want and got["done"] == setting[1]
    assert [(p.bytes_written, p.bytes_read, p.num_free())
            for p in (port.hbm, port.host)] == \
        [(p.bytes_written, p.bytes_read, p.num_free())
         for p in (ref.hbm, ref.host)]
    if setting is PRESSURE:
        assert got["demotions"] >= 1 and port.staged_bytes > 0
    else:
        assert port.staged_bytes == 0


@pytest.mark.parametrize("setting", [NO_PRESSURE, PRESSURE],
                         ids=["no_pressure", "pressure"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, setting):
    """fp32: identical tokens, stats and pool byte counters; under
    pressure a sequence is demoted and host-resident sequences decode
    through the staging copy."""
    _check_engines(ref_get_config(arch).smoke(), setting)


@pytest.mark.parametrize("heads", [48, 17])
def test_engine_wide_mqa_group_matches_reference(heads):
    """Granite's smoke config with its one KV head under 48 and 17 query
    heads, under pool pressure: the groups the paged kernel takes in three
    chunks and in a full and a ragged chunk."""
    cfg = dataclasses.replace(ref_get_config("granite-34b").smoke(),
                              num_heads=heads)
    assert cfg.num_kv_heads == 1
    assert paged_kernel.group_chunks(heads, 1) == (3 if heads == 48 else 2)
    _check_engines(cfg, PRESSURE)


ATTENTION_CONFIGS = [name for name in list_configs()
                     if get_config(name).has_attention]


@pytest.mark.parametrize("name", ATTENTION_CONFIGS)
def test_kernels_support_every_attention_config(name):
    """Both attention kernels take every attention config of the registry
    (and its smoke config): Granite-34B's 48:1 group among them."""
    for cfg in (get_config(name), get_config(name).smoke()):
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        assert paged_kernel.supports(h, kvh, d), (cfg.name, h, kvh, d)
        assert flash_kernel.supports(h, kvh, d), (cfg.name, h, kvh, d)


def test_supports_and_group_chunks():
    """Any group H % KV == 0, chunks of 16 rows; a ragged group, a head
    dim past 256 and a grid past 65,535 blocks on y are refused."""
    assert [paged_kernel.group_chunks(g, 1) for g in (1, 16, 17, 32, 48)] \
        == [1, 1, 2, 2, 3]
    assert paged_kernel.group_chunks(40, 8) == 1
    for kernel in (paged_kernel, flash_kernel):
        assert kernel.supports(48, 1, 128) and kernel.supports(17, 1, 16)
        assert kernel.supports(4096, 1, 256)
        assert not kernel.supports(48, 5, 128)
        assert not kernel.supports(48, 1, 257)
        assert not kernel.supports(48, 1, 0)
    assert flash_kernel.supports(65535, 65535, 64)
    assert not flash_kernel.supports(65536, 65536, 64)
    assert paged_kernel.supports(65535, 65535, 64)
    assert not paged_kernel.supports(17 * 40000, 40000, 64)   # 80,000 on y
