"""The port's serving stack held against the JAX package.

* paged pools: the same writes, reads and zone copies on ``repro`` and
  ``repro_torch`` pools give the same data and byte counters;
* tier managers: the three policies run the seeded schedules of
  ``tests/test_serving.py`` in lockstep on both packages, with stats,
  zone maps and free counts compared after every operation;
* dense layers against the reference's, fp32 within 2e-5 (the two
  frameworks sum in another order);
* ``models.convert`` carries the reference's parameters over exactly;
* the engines on ``qwen3-1.7b`` smoke with the reference's parameters:
  identical tokens, stats and byte counters in fp32, and pool K/V within
  2e-2 with bf16 parameters (bf16 products round at other places in the
  two frameworks).

The port's engine runs on ``torch_device="cpu"`` here, so its attention
takes the plain versions; the card run (``chip_smoke.py``) holds the CUDA
kernels against them.
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
from repro.models import layers as RL  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import from_reference, layers as L  # noqa: E402
from repro_torch.models.convert import reference_leaf  # noqa: E402

NL, KV, D = 2, 2, 8
SHAPE = (NL, KV, D)
FP32 = dict(rtol=2e-5, atol=2e-5)


def _payload(sid, pos):
    return np.full(SHAPE, ((sid * 100003 + pos) % 65521) / 7.0, np.float32)


def _pools(pkg, hbm=4, host=16, ppz=2, ps=4, materialize=True):
    extra = {"torch_device": "cpu"} if pkg is serving else {}
    mk = lambda name, zones, host_: pkg.PagedPool(
        name, NL, zones, ppz, ps, KV, D, host=host_,
        materialize=materialize, **extra)
    return mk("hbm", hbm, False), mk("host", host, True)


def _counters(*pools):
    return [(p.bytes_written, p.bytes_read, p.num_free()) for p in pools]


# ======================================================================
# paged pools
# ======================================================================
def test_pool_write_read_roundtrip():
    for pkg in (ref_serving, serving):
        hbm, _ = _pools(pkg)
        z = hbm.alloc_zone(owner=0)
        for pos in range(8):
            hbm.write_token(z, _payload(0, pos), _payload(0, pos))
        for pos in range(8):
            k, v = hbm.read_token(z, pos)
            np.testing.assert_array_equal(k, _payload(0, pos))
            np.testing.assert_array_equal(v, _payload(0, pos))
        with pytest.raises(AssertionError):
            hbm.write_token(z, _payload(0, 0), _payload(0, 0))
    assert isinstance(hbm.k, torch.Tensor) and hbm.k.dtype == torch.float32


@pytest.mark.parametrize("direction", ["demote", "promote", "cache"])
def test_pool_copy_zone_partial_fill(direction):
    """Only the pages the source write pointer covers move, and the bytes
    charged are the written tokens; every tier pair, both packages."""
    counters, data = [], []
    for pkg in (ref_serving, serving):
        hbm, host = _pools(pkg)
        src_pool, dst_pool = {"demote": (hbm, host), "promote": (host, hbm),
                              "cache": (hbm, hbm)}[direction]
        src = src_pool.alloc_zone(owner=0)
        for pos in range(5):                # 5 of 8 tokens: 2 pages
            src_pool.write_token(src, _payload(0, pos), _payload(1, pos))
        dst = dst_pool.alloc_zone(owner=0)
        moved = dst_pool.copy_zone_from(src_pool, src, dst)
        assert moved == 5 * hbm.token_bytes and dst.write_ptr == 5
        data.append([dst_pool.read_token(dst, pos) for pos in range(5)])
        counters.append(_counters(hbm, host))
    assert counters[0] == counters[1]
    for (rk, rv), (pk, pv) in zip(*data):
        np.testing.assert_array_equal(pk, rk)
        np.testing.assert_array_equal(pv, rv)


def test_pool_accounting_only():
    hbm, _ = _pools(serving, materialize=False)
    assert hbm.k is None and hbm.v is None
    z = hbm.alloc_zone(owner=0)
    hbm.write_token(z)
    assert z.write_ptr == 1 and hbm.bytes_written == hbm.token_bytes
    with pytest.raises(ValueError, match="no data"):
        hbm.read_token(z, 0)
    # no storage, so no card is needed even with the default device
    serving.PagedPool("hbm", NL, 2, 2, 4, KV, D, host=False,
                      materialize=False)


def test_device_pool_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serving.PagedPool("hbm", NL, 2, 2, 4, KV, D, host=False)


# ======================================================================
# tier managers in lockstep with the reference
# ======================================================================
def _state(mgr, hbm, host):
    seqs = {sid: (s.length, s.tier, s.prefix_cached, s.last_active_step,
                  [(z.zid, z.write_ptr, z.owner) for z in s.zones])
            for sid, s in mgr.seqs.items()}
    cache = {sid: z.zid for sid, z in mgr.prefix_cache.items()}
    return (dict(mgr.stats), seqs, cache, list(hbm._free), list(host._free),
            _counters(hbm, host))


def _fill(mgr, seq, tokens):
    for _ in range(tokens):
        mgr.pool_of(seq).write_token(mgr.writable_zone(seq))
        seq.length += 1


def _run_schedule(pkg, policy, ops):
    """``tests/test_serving.py::_apply_schedule`` on one package: the
    state after every operation, then after releasing all, or the error
    the schedule raised."""
    hbm, host = _pools(pkg, hbm=4, host=24, materialize=False)
    mgr = pkg.make_manager(policy, hbm, host, cache_zones=1)
    live, next_sid, states = [], 0, []
    try:
        for op, arg in ops:
            if op == "submit":
                tokens = 1 + arg % 20
                if mgr.admit(next_sid, tokens):
                    _fill(mgr, mgr.on_prefill(next_sid, tokens), tokens)
                    live.append(next_sid)
                    next_sid += 1
            elif op == "step" and live:
                active = live[:1 + arg % 4]
                mgr.tick(active)
                for sid in active:
                    _fill(mgr, mgr.seqs[sid], 1)
            elif op == "rotate" and live:
                live.append(live.pop(0))
            elif op == "release" and live:
                mgr.release(live.pop(arg % len(live)))
            states.append(_state(mgr, hbm, host))
        for sid in live:
            mgr.release(sid)
        states.append(_state(mgr, hbm, host))
    except RuntimeError as err:
        states.append(("raised", str(err)))
    return states


@pytest.mark.parametrize("policy", ["static", "lru", "hhzs"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_managers_match_reference(policy, seed):
    rng = np.random.default_rng(seed)
    ops = [(("submit", "step", "rotate", "release")[int(rng.integers(4))],
            int(rng.integers(0, 40))) for _ in range(120)]
    want = _run_schedule(ref_serving, policy, ops)
    got = _run_schedule(serving, policy, ops)
    assert got == want
    assert want[-1][0] != "raised"


def test_static_growth_past_budget_raises_in_both():
    """The static policy reserves device zones for the budget a sequence
    was admitted with; growing it past that budget raises, in the
    reference and in the port alike."""
    ops = [("submit", 0), ("submit", 0), ("submit", 7), ("submit", 0),
           ("step", 2)]
    want = _run_schedule(ref_serving, "static", ops)
    got = _run_schedule(serving, "static", ops)
    assert got == want
    assert got[-1][0] == "raised" and "HBM pool exhausted" in got[-1][1]


# ======================================================================
# dense layers
# ======================================================================
def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _module(mod, values):
    mod.load_state_dict({k: _t(v) for k, v in values.items()}, assign=True)
    return mod


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 4, 16), _rand(rng, 16)
    np.testing.assert_allclose(
        L.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(RL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        **FP32)
    pos = rng.integers(0, 1500, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.apply_rope(_t(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        **FP32)


@pytest.mark.parametrize("qkv_bias,qk_norm", [(False, True), (True, False)])
def test_project_qkv_matches_reference(qkv_bias, qk_norm):
    cfg = ref_get_config("qwen3-1.7b").smoke()
    cfg = dataclasses.replace(cfg, qkv_bias=qkv_bias, qk_norm=qk_norm)
    rng = np.random.default_rng(1)
    p = {k: _rand(rng, *np.shape(v)) for k, v in
         RL.init_attention(jax.random.PRNGKey(0), cfg).items()}
    att = _module(L.Attention(cfg), p)
    x = _rand(rng, 2, 7, cfg.d_model)
    got = L._project_qkv(att, cfg, _t(x), _t(x))
    want = RL._project_qkv({k: jnp.asarray(v) for k, v in p.items()}, cfg,
                           jnp.asarray(x), jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **FP32)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    cfg = ref_get_config("qwen3-1.7b").smoke()
    cfg = dataclasses.replace(cfg, act=act)
    rng = np.random.default_rng(2)
    p = {k: _rand(rng, *np.shape(v), scale=0.1) for k, v in
         RL.init_mlp(jax.random.PRNGKey(0), cfg).items()}
    x = _rand(rng, 2, 7, cfg.d_model)
    got = L.mlp(_module(L.MLP(cfg), p), cfg, _t(x))
    want = RL.mlp({k: jnp.asarray(v) for k, v in p.items()}, cfg,
                  jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FP32)


def test_matmul_promotes_like_jax():
    a = torch.ones(2, 3, dtype=torch.float32)
    w = torch.ones(3, 4, dtype=torch.bfloat16)
    assert L.matmul(a, w).dtype == torch.float32
    assert L.matmul(w.T, w).dtype == torch.bfloat16


# ======================================================================
# parameters carried across, and the engines
# ======================================================================
@pytest.fixture(scope="module")
def smoke():
    """qwen3-1.7b smoke config and the reference's parameters (bf16) as
    numpy, initialised once for the module."""
    cfg = ref_get_config("qwen3-1.7b").smoke()
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))
    return cfg, params


def _f32_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def test_config_matches_reference():
    for name in ("qwen3-1.7b", "mixtral-8x22b", "whisper-base"):
        for smoke_ in (False, True):
            want = ref_get_config(name + "-smoke" * smoke_)
            assert get_config(name + "-smoke" * smoke_).__dict__ == \
                want.__dict__


def test_convert_carries_every_parameter(smoke):
    cfg, params = smoke
    model = from_reference(get_config(cfg.name), params, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    n_ref = sum(a.size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    for name in names:
        got = dict(model.named_parameters())[name]
        want = reference_leaf(params, name)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want, np.float32))


def _engines(cfg, params, **kw):
    port = serving.ServingEngine(get_config(cfg.name),
                                 from_reference(get_config(cfg.name), params,
                                                device="cpu"),
                                 torch_device="cpu", **kw)
    ref = ref_serving.ServingEngine(cfg, jax.tree.map(jnp.asarray, params),
                                    **kw)
    return port, ref


def test_engine_matches_reference_without_pressure(smoke):
    cfg, params = smoke
    port, ref = _engines(cfg, _f32_tree(params), hbm_zones=16, host_zones=16,
                         pages_per_zone=4, page_size=8, max_batch=1,
                         cache_zones=0)
    prompt = np.array([5, 9, 2, 7, 1, 3, 8, 4], np.int32)
    stats = []
    for eng, pkg in ((port, serving), (ref, ref_serving)):
        eng.submit(pkg.Request(rid=0, prompt=prompt, max_new_tokens=5))
        stats.append(eng.run(max_steps=20))
    assert port.done[0].out_tokens == ref.done[0].out_tokens
    assert stats[0] == stats[1]
    assert port.staged_bytes == 0


def test_engine_matches_reference_under_pressure(smoke):
    """A device pool of 2 free zones: prefills land on the host, a
    sequence is demoted and promoted, and host-resident sequences decode
    through the staging copy."""
    cfg, params = smoke
    port, ref = _engines(cfg, _f32_tree(params), hbm_zones=3, host_zones=48,
                         pages_per_zone=2, page_size=8, max_batch=4,
                         cache_zones=1)
    stats = []
    for eng, pkg in ((port, serving), (ref, ref_serving)):
        rng = np.random.default_rng(1)
        for i in range(3):
            n = int(rng.integers(10, 20))
            eng.submit(pkg.Request(
                rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                .astype(np.int32), max_new_tokens=4))
        stats.append(eng.run(max_steps=80))
    assert [r.out_tokens for r in port.done] == \
        [r.out_tokens for r in ref.done]
    assert stats[0] == stats[1]
    assert _counters(port.hbm, port.host) == _counters(ref.hbm, ref.host)
    assert stats[0]["done"] == 3 and stats[0]["demotions"] >= 1
    assert port.staged_bytes > 0


def test_engine_bf16_pool_kv_matches_reference(smoke):
    """bf16 parameters: the same tokens through both engines' forward; the
    K/V each writes into its device pool agree within bf16 tolerance."""
    cfg, params = smoke
    port, ref = _engines(cfg, params, hbm_zones=4, host_zones=4,
                         pages_per_zone=2, page_size=8, cache_zones=0)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 11) \
        .astype(np.int32)
    for eng, pkg in ((port, serving), (ref, ref_serving)):
        req = pkg.Request(rid=0, prompt=prompt, max_new_tokens=4)
        eng.mgr.on_prefill(0, len(prompt))
        eng._forward_tokens(req, prompt)
        for tok in (17, 4, 250):
            eng._forward_tokens(req, np.asarray([tok], np.int32))
    assert port.mgr.seqs[0].length == ref.mgr.seqs[0].length == 14
    for got, want in ((port.hbm.k, ref.hbm.k), (port.hbm.v, ref.hbm.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-2, atol=2e-2)


def test_engine_on_cuda_without_card_raises(smoke):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    cfg, params = smoke
    model = from_reference(get_config(cfg.name), params, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serving.ServingEngine(get_config(cfg.name), model)
