"""The port's model entry points held against the JAX package.

``forward``, ``decode_step``, ``make_prefill_step`` and
``make_serve_step`` of ``repro_torch`` against ``repro``'s on the smoke
configs of every family (``falcon-mamba-7b`` ssm, ``hymba-1.5b`` hybrid,
``qwen3-1.7b`` dense, ``olmoe-1b-7b`` and ``mixtral-8x22b`` moe, the
latter with a ring-buffer cache, ``whisper-base`` encdec,
``internvl2-26b`` vlm), with the reference's parameters carried over by
``from_reference``: logits within 1e-4 of the
reference's relative to their largest magnitude with fp32 parameters (the
two frameworks sum in another order) and 2e-2 with bf16 (one bf16
rounding that falls the other way, in a few places, moves a logit by a
bf16 ulp of the residual stream, ~1% of the largest).  Caches are held
alike, at 2e-2 where they are bf16: an fp32 value a few ulps off rounds
to the neighbouring bf16 value.  On the CPU the port's prefill takes the
plain versions of its kernels; the card run (``chip_smoke.py``) holds the
kernels against them.

The reference's encoder casts its frames to ``layers.DTYPE`` (bf16), and
with fp32 parameters its layer scan then refuses the carry that turns
fp32; the port casts them to the parameters' dtype.  The fp32 cases of
``whisper-base`` run the reference with ``layers.DTYPE`` set to fp32 for
the call (``_ref_dtype``), where the two casts agree as they do in bf16.
An encdec decode fills ``cross_k``/``cross_v`` from ``encoder_kv`` in
both packages, as ``tests/test_models.py`` does.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import steps as RS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (Model, decode_step,  # noqa: E402
                                encoder_kv, forward, from_reference,
                                init_caches, layer_windows,
                                make_prefill_step, make_serve_step)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (reference_path,  # noqa: E402
                                        stacked_layers)

ARCHS = ["falcon-mamba-7b", "hymba-1.5b", "qwen3-1.7b", "olmoe-1b-7b",
         "mixtral-8x22b", "whisper-base", "internvl2-26b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S = 2, 24              # S > the hybrid smoke window of 16


@functools.lru_cache(maxsize=None)
def _setup(arch: str, dtype: str, seed: int = 0):
    """(reference cfg, reference params on jnp, port cfg, port model)."""
    cfg = ref_get_config(arch).smoke()
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed),
                                                  cfg))
    if dtype == "float32":
        params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    model = from_reference(get_config(cfg.name), params, device="cpu")
    return cfg, jax.tree.map(jnp.asarray, params), get_config(cfg.name), \
        model


def _tokens(cfg, seed: int = 0, b: int = B, s: int = S) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _inputs(cfg, seed: int = 0, b: int = B) -> dict:
    """The batch's other inputs, fp32 numpy: ``frames`` [B, encoder_seq,
    d] for encdec, ``vision_embeds`` [B, vision_prefix, d] for vlm."""
    rng = np.random.default_rng(seed + 100)
    out = {}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_prefix:
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return out


def _batches(cfg, toks: np.ndarray, seed: int = 0):
    """The same batch for each package: (jnp dict, torch dict)."""
    arrays = {"tokens": toks, **_inputs(cfg, seed, toks.shape[0])}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


@contextlib.contextmanager
def _ref_dtype(params):
    """The reference's ``layers.DTYPE`` set to its parameters' dtype for
    the calls inside (its encoder's cast of the frames)."""
    old = RL.DTYPE
    RL.DTYPE = jax.tree.leaves(params)[0].dtype
    try:
        yield
    finally:
        RL.DTYPE = old


def _cross_caches(cfg, params, tcfg, model, caches, tcaches, frames):
    """Both packages' cross K/V caches from their encoders' outputs over
    the same frames (numpy), as tests/test_models.py fills them."""
    with _ref_dtype(params):
        ek, ev = RM.encoder_kv(cfg, params,
                               RM._encode(cfg, params, jnp.asarray(frames)))
    caches["cross_k"], caches["cross_v"] = ek, ev
    with torch.no_grad():
        tk, tv = encoder_kv(tcfg, model, TM._encode(
            tcfg, model, torch.from_numpy(frames)))
    tcaches["cross_k"], tcaches["cross_v"] = tk, tv


def _close(got, want, tol: float) -> None:
    """|got - want| <= tol * max |want| everywhere."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * float(np.abs(want).max()), (err, tol)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _ref_decode(cfg):
    return jax.jit(functools.partial(RM.decode_step, cfg))


def _teacher_forced(cfg, params, tcfg, model, toks, max_len,
                    fp32_caches: bool = False):
    """Both packages' decode_step over ``toks`` one position at a time:
    per-step logits [B, V] of each, and the final caches of each; with
    ``fp32_caches`` the bf16 caches ``init_caches`` makes are widened to
    fp32 in both first."""
    b, s = toks.shape
    caches = RM.init_caches(cfg, b, max_len)
    tcaches = init_caches(tcfg, b, max_len, device="cpu")
    if fp32_caches:
        caches = {k: v.astype(jnp.float32) for k, v in caches.items()}
        tcaches = {k: v.float() for k, v in tcaches.items()}
    if cfg.encoder_layers:
        _cross_caches(cfg, params, tcfg, model, caches, tcaches,
                      _inputs(cfg, 0, b)["frames"])
    ref, port = [], []
    with torch.no_grad():
        for t in range(s):
            logits, caches = _ref_decode(cfg)(
                params, jnp.asarray(toks[:, t:t + 1]),
                jnp.full((b,), t, jnp.int32), caches)
            tlogits, tcaches = decode_step(
                tcfg, model, torch.from_numpy(toks[:, t:t + 1]),
                torch.full((b,), t, dtype=torch.int32), tcaches)
            ref.append(_np(logits[:, 0]))
            port.append(_np(tlogits[:, 0]))
    return np.stack(ref, 1), np.stack(port, 1), caches, tcaches


# ----------------------------------------------------------------------
# forward and decode against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(arch, dtype):
    cfg, params, tcfg, model = _setup(arch, dtype)
    rb, tb = _batches(cfg, _tokens(cfg))
    with _ref_dtype(params):
        want = RM.forward(cfg, params, rb, remat=False)
    with torch.no_grad():
        got = forward(tcfg, model, tb)
    assert got.shape == want.shape == (B, S, cfg.vocab_size)
    assert str(got.dtype).endswith(str(want.dtype))
    _close(got, want, TOL[dtype])


# fp32 parameters decode against the bf16 caches ``init_caches`` makes,
# except on these smoke configs: a k or v the two frameworks compute a
# few fp32 ulps apart rounds to neighbouring bf16 values in a few elements
# (4-8 of 4,096), which moves a logit by 1.1e-4 (olmoe) and 2.2e-4
# (internvl2) of the largest, so their fp32 cases widen the caches to fp32
# in both packages.  ``test_decode_fp32_caches_matches_reference`` runs
# every config so.
BF16_CACHES_MISS_FP32 = {"olmoe-1b-7b", "internvl2-26b"}


def _check_decode(arch, dtype, fp32_caches):
    cfg, params, tcfg, model = _setup(arch, dtype)
    ref, port, caches, tcaches = _teacher_forced(
        cfg, params, tcfg, model, _tokens(cfg, 1), max_len=32,
        fp32_caches=fp32_caches)
    for t in range(port.shape[1]):
        _close(port[:, t], ref[:, t], TOL[dtype])
    assert sorted(caches) == sorted(tcaches)
    for key, want in caches.items():
        got = tcaches[key]
        assert str(got.dtype).endswith(str(want.dtype)), key
        _close(got, want, TOL["bfloat16" if want.dtype == jnp.bfloat16
                              else dtype])
    return caches


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(arch, dtype):
    """Teacher-forced decode past the hybrid and moe smoke windows (the
    latter a ring buffer of 16 slots): logits at every step and the caches
    after the last, dtypes included (the conv cache turns fp32 under fp32
    weights in both, k and v stay bf16; encdec's cross caches are its
    encoder's output's dtype in both)."""
    fp32_caches = dtype == "float32" and arch in BF16_CACHES_MISS_FP32
    caches = _check_decode(arch, dtype, fp32_caches)
    if "k" in caches and not fp32_caches:
        assert caches["k"].dtype == caches["v"].dtype == jnp.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_fp32_caches_matches_reference(arch):
    """fp32 parameters against caches widened to fp32 in both packages:
    logits at every step within 1e-4, the caches after the last too."""
    caches = _check_decode(arch, "float32", True)
    assert all(v.dtype == jnp.float32 for v in caches.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_reference(arch):
    """make_prefill_step's next-token logits, then make_serve_step's
    greedy tokens over a teacher-forced prompt, fp32."""
    cfg, params, tcfg, model = _setup(arch, "float32")
    toks = _tokens(cfg, 2, s=12)
    rb, tb = _batches(cfg, toks, 2)
    with _ref_dtype(params):
        want = RS.make_prefill_step(cfg, ParallelConfig())(params, rb)
    got = make_prefill_step(tcfg)(model, tb)
    assert got.shape == (B, cfg.vocab_size)
    _close(got, want, TOL["float32"])

    step, tstep = jax.jit(RS.make_serve_step(cfg)), make_serve_step(tcfg)
    caches = RM.init_caches(cfg, B, 32)
    tcaches = init_caches(tcfg, B, 32, device="cpu")
    if cfg.encoder_layers:
        _cross_caches(cfg, params, tcfg, model, caches, tcaches,
                      _inputs(cfg, 2)["frames"])
    tok, ttok, out, tout = None, None, [], []
    for t in range(20):
        feed = toks[:, t:t + 1] if t < toks.shape[1] else None
        tok, _, caches = step(params, jnp.asarray(feed) if feed is not None
                              else tok, jnp.full((B,), t, jnp.int32), caches)
        ttok, _, tcaches = tstep(model, torch.from_numpy(feed)
                                 if feed is not None else ttok,
                                 torch.full((B,), t, dtype=torch.int32),
                                 tcaches)
        assert ttok.dtype == torch.int32 and ttok.shape == (B, 1)
        out.append(np.asarray(tok))
        tout.append(ttok.numpy())
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(out, 1))


# ----------------------------------------------------------------------
# the port's own decode against its own prefill
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b",
                                  "olmoe-1b-7b"])
def test_decode_matches_prefill_logits(arch):
    """Teacher-forced decode reproduces the forward pass's logits, as
    ``tests/test_models.py::test_decode_matches_prefill_logits`` checks for
    the reference on the dense family (bf16 parameters, its bound of
    3e-2), here relative to the largest logit: on falcon-mamba's smoke
    config the reference's own decode misses the elementwise form in 3 of
    its 2,048 logits (its relative error is 0.018).  The MoE runs at a
    capacity factor of E / k, where an expert has a slot for every token
    of the prompt, so the prefill drops no pair (a decode step never
    does)."""
    cfg, _, tcfg, model = _setup(arch, "bfloat16", seed=1)
    if tcfg.num_experts:
        tcfg = dataclasses.replace(
            tcfg, capacity_factor=tcfg.num_experts / tcfg.top_k)
    b, s = 1, 8
    toks = _tokens(cfg, 0, b, s)
    with torch.no_grad():
        full = forward(tcfg, model, {"tokens": torch.from_numpy(toks)})
        caches = init_caches(tcfg, b, 32, device="cpu")
        for t in range(s):
            logits, caches = decode_step(
                tcfg, model, torch.from_numpy(toks[:, t:t + 1]),
                torch.full((b,), t, dtype=torch.int32), caches)
            _close(logits[:, 0], full[:, t], 3e-2)


def test_hybrid_decode_past_window_as_reference():
    """Hymba's caches hold ``max_len`` slots (it has full-attention layers),
    and decode masks only with the ring-buffer test, so its sliding-window
    layers see the whole context in decode while ``forward`` masks them:
    both packages' decodes agree with each other and depart from their own
    forward past the window, and only there."""
    cfg, params, tcfg, model = _setup("hymba-1.5b", "float32")
    toks = _tokens(cfg, 3)
    ref, port, _, _ = _teacher_forced(cfg, params, tcfg, model, toks,
                                      max_len=32)
    _close(port, ref, TOL["float32"])
    with torch.no_grad():
        full = _np(forward(tcfg, model, {"tokens": torch.from_numpy(toks)}))
    want = _np(RM.forward(cfg, params, {"tokens": jnp.asarray(toks)},
                          remat=False))
    w = cfg.sliding_window
    for dec, fwd in ((port, full), (ref, want)):
        rel = np.abs(dec - fwd).max(-1) / np.abs(fwd).max(-1)   # [B, S]
        assert rel[:, :w].max() < 0.05
        assert rel[:, w + 4:].min() > 0.05


def test_ring_decode_past_wrap_as_reference():
    """Mixtral's caches are a ring of ``sliding_window`` slots (it has no
    full-attention layer), and the ring-buffer test ``kpos > cache_len -
    s_max`` compares a slot's index with a position: from the first wrap
    on it keeps only the slots whose index exceeds ``cache_len - S``, the
    token's own slot and the newest ones never among them.  Both
    packages' decodes agree with each other and depart from their own
    forward from the wrap on, and only there (capacity wide enough that
    no expert drops a token, so the ring is all that differs)."""
    cfg, params, tcfg, model = _setup("mixtral-8x22b", "float32")
    cfg, tcfg = (dataclasses.replace(c, capacity_factor=c.num_experts)
                 for c in (cfg, tcfg))
    toks = _tokens(cfg, 3, s=40)
    ref, port, caches, _ = _teacher_forced(cfg, params, tcfg, model, toks,
                                           max_len=64)
    w = cfg.sliding_window
    assert caches["k"].shape[2] == w
    _close(port, ref, TOL["float32"])
    with torch.no_grad():
        full = _np(forward(tcfg, model, {"tokens": torch.from_numpy(toks)}))
    want = _np(RM.forward(cfg, params, {"tokens": jnp.asarray(toks)},
                          remat=False))
    for dec, fwd in ((port, full), (ref, want)):
        rel = np.abs(dec - fwd).max(-1) / np.abs(fwd).max(-1)   # [B, S]
        assert rel[:, :w].max() < 0.05
        assert rel[:, w:].min() > 0.05


# ----------------------------------------------------------------------
# configuration and families
# ----------------------------------------------------------------------
@pytest.mark.parametrize("layers", [2, 3, 32])
def test_layer_windows_match_reference(layers):
    for arch in ("hymba-1.5b", "falcon-mamba-7b", "qwen3-1.7b",
                 "mixtral-8x22b"):
        cfg = dataclasses.replace(ref_get_config(arch), num_layers=layers)
        want = RM.layer_windows(cfg)
        got = layer_windows(dataclasses.replace(get_config(arch),
                                                num_layers=layers))
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_unknown_family_raises():
    """Every family of the configs is in the port; a name outside them
    is refused by ``Model`` and ``init_caches``."""
    assert set(TM.FAMILIES) == {ref_get_config(a).family
                                for a in list_configs()}
    cfg = dataclasses.replace(get_config("qwen3-1.7b").smoke(),
                              family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        Model(cfg, device="meta")
    with pytest.raises(ValueError, match="rnn"):
        init_caches(cfg, 1, 8, device="cpu")


@pytest.mark.parametrize("arch", list_configs())
def test_parameters_match_reference_tree(arch):
    """The port's parameters are the reference's leaves one for one:
    each name's ``reference_path`` is a leaf of ``param_shapes``, stacked
    over the decoder's or the encoder's layers where it has a layer
    index, of the same shape and dtype (the MoE router fp32, no QKV bias
    in cross-attention), and no leaf is left over."""
    cfg, tcfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(RM.param_shapes(cfg))}
    got = {}
    for name, p in Model(tcfg, device="meta").named_parameters():
        path, li = reference_path(name)
        shape = tuple(p.shape)
        if li is not None:
            n = stacked_layers(tcfg, path)
            assert 0 <= li < n, name
            shape = (n, *shape)
        got[path] = (shape, str(p.dtype).split(".")[1])
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path] == (tuple(leaf.shape), str(leaf.dtype)), path


def test_reference_path_maps_encoder_layers():
    assert reference_path("layers.3.attn.wq") == ("layers/attn/wq", 3)
    assert reference_path("encoder.layers.1.mlp.wi") \
        == ("encoder/layers/mlp/wi", 1)
    assert reference_path("encoder.final_norm") \
        == ("encoder/final_norm", None)
    assert reference_path("layers.0.moe.router") == ("layers/moe/router", 0)
    assert reference_path("embed") == ("embed", None)
