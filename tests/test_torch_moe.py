"""The port's MoE, cross-attention and encoder held against the JAX
package, and the moe, encdec and vlm families' train steps and
checkpoints.

``layers.moe`` against the reference's ``L.moe`` on the same parameters
and input at a capacity that drops pairs: the chosen experts (the
reference's own ``top_k`` output, recorded as it runs), the kept slots
(against a numpy count of each expert's pairs in (token, k) order), and
the output within 1e-4 of the largest in fp32 (the expert products sum
in another order) and equal in bf16 (the combine adds the k slots in
order in bf16, as the reference's scatter-add; a sum rounded once differs
in the last bit).  ``cross_attention``, ``_encode`` and
``encoder_kv`` against the reference's on ``whisper-base``'s smoke
config.  The train step on the smoke configs of ``olmoe-1b-7b``,
``whisper-base`` and ``internvl2-26b`` at grad_accum 1 and 2, and
checkpoints of ``whisper-base`` and ``olmoe-1b-7b`` across the packages,
through tests/test_torch_train.py's checks.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import from_reference  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from test_torch_models import _ref_dtype  # noqa: E402
from test_torch_train import (check_checkpoint_files,  # noqa: E402
                              check_restore_across_packages,
                              check_train_step)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MOE_ARCHS = ["olmoe-1b-7b", "mixtral-8x22b"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, tol: float) -> None:
    """|got - want| <= tol * max |want| everywhere."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) \
        <= tol * float(np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _setup(arch: str, dtype: str):
    """(reference smoke cfg, its parameters as jnp in ``dtype`` (the
    router fp32 as drawn), the port's cfg and model holding them)."""
    cfg = ref_get_config(arch).smoke()
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                  cfg))
    if dtype == "float32":
        params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    tcfg = get_config(cfg.name)
    model = from_reference(tcfg, params, device="cpu")
    return cfg, jax.tree.map(jnp.asarray, params), tcfg, model


def _x(shape, dtype: str, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _slots(top_e: np.ndarray, e: int, cap: int):
    """(slot, kept) of each (token, k) pair of each row, counted pair by
    pair in (token, k) order."""
    b = top_e.shape[0]
    flat = top_e.reshape(b, -1)
    pos = np.zeros_like(flat)
    for r in range(b):
        seen = np.zeros(e, np.int64)
        for i, ex in enumerate(flat[r]):
            pos[r, i] = seen[ex]
            seen[ex] += 1
    return pos, pos < cap


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,top_k", [("olmoe-1b-7b", 2),
                                         ("olmoe-1b-7b", 3),
                                         ("mixtral-8x22b", 2)])
def test_moe_matches_reference(arch, top_k, dtype, monkeypatch):
    """Layer 0's MoE on x [2, 32, d] at capacity factor 1 (S k / E slots
    an expert: 16 for top-2 of 4 experts, 24 for top-3): some pairs are
    dropped; experts, slots and output as the reference's.  Top-3 tells
    the in-order combine from a sum rounded once (at top-2 the first add
    is to zero, exact, so the two agree)."""
    cfg, params, tcfg, model = _setup(arch, dtype)
    cfg = dataclasses.replace(cfg, capacity_factor=1.0, top_k=top_k)
    tcfg = dataclasses.replace(tcfg, capacity_factor=1.0, top_k=top_k)
    p = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    x = _x((2, 32, cfg.d_model), dtype, 3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    seen = []
    top_k = jax.lax.top_k

    def record(operand, k):
        out = top_k(operand, k)
        seen.append(out)
        return out
    monkeypatch.setattr(jax.lax, "top_k", record)
    want = RL.moe(p, cfg, jnp.asarray(x, jdt))
    monkeypatch.undo()
    (ref_w, ref_e), = seen
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    layer = model.layers[0].moe
    with torch.no_grad():
        top_w, top_e = L.moe_route(layer, tcfg, tx)
        got = L.moe(layer, tcfg, tx)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(ref_e))
    cap = L.moe_capacity(tcfg, 32)
    assert cap == max(int(1.0 * 32 * cfg.top_k / cfg.num_experts), 1)
    pos, keep = L.moe_slots(top_e, cfg.num_experts, cap)
    want_pos, want_keep = _slots(np.asarray(ref_e), cfg.num_experts, cap)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (~keep).any(), "capacity drops some pairs"
    assert top_w.dtype == torch.float32
    _close(top_w, ref_w / jnp.sum(ref_w, -1, keepdims=True), 1e-6)
    assert got.dtype == tx.dtype and str(want.dtype) == dtype
    if dtype == "bfloat16":
        # the k slots added in order in bf16, as the reference's
        # scatter-add: bit for bit (a sum rounded once is not)
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        _close(got, want, TOL[dtype])


def test_moe_routes_topk():
    """tests/test_models.py::test_moe_routes_topk on the port (its own
    init, bf16): the output's shape, finite; each token's k experts
    distinct, largest gate first, the weights summing to 1."""
    cfg = get_config("olmoe-1b-7b").smoke()
    gen = torch.Generator().manual_seed(3)
    p = L.init_moe(cfg, gen)
    assert p.router.dtype == torch.float32
    assert p.we_gate.dtype == torch.bfloat16
    x = torch.from_numpy(_x((2, 16, cfg.d_model), "bfloat16", 2)).bfloat16()
    with torch.no_grad():
        out = L.moe(p, cfg, x)
        top_w, top_e = L.moe_route(p, cfg, x)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert top_e.shape == (2, 16, cfg.top_k)
    assert all(len(set(t.tolist())) == cfg.top_k
               for t in top_e.reshape(-1, cfg.top_k))
    assert bool((top_w[..., :-1] >= top_w[..., 1:]).all())
    assert torch.allclose(top_w.sum(-1), torch.ones(()), atol=1e-6)


def test_moe_drops_and_combines_as_written():
    """A token whose pairs are all dropped gets a zero row; a kept pair
    adds its weighted expert output in (token, k) order, in bf16, each
    sum rounded: the combine by hand on the same routing."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").smoke(),
                              capacity_factor=0.25)
    gen = torch.Generator().manual_seed(5)
    p = L.init_moe(cfg, gen)
    x = torch.from_numpy(_x((1, 32, cfg.d_model), "bfloat16", 4)).bfloat16()
    with torch.no_grad():
        out = L.moe(p, cfg, x)
        top_w, top_e = L.moe_route(p, cfg, x)
    cap = L.moe_capacity(cfg, 32)
    pos, keep = L.moe_slots(top_e, cfg.num_experts, cap)
    want = torch.zeros_like(x)
    for i in range(32):
        for j in range(cfg.top_k):
            f = i * cfg.top_k + j
            if not keep[0, f]:
                continue
            e = int(top_e[0, i, j])
            xe = x[0, i].float()
            h = L.silu((xe @ p.we_gate[e].float()).bfloat16()) \
                * (xe @ p.we_up[e].float()).bfloat16()
            y = (h.float() @ p.we_down[e].float()).bfloat16()
            want[0, i] = want[0, i] + y * top_w[0, i, j].bfloat16()
    dropped = ~keep.reshape(1, 32, cfg.top_k).any(-1)
    assert bool(dropped.any()) and not bool(dropped.all())
    assert bool((out[dropped] == 0).all())
    _close(out, want, 2e-2)


# ----------------------------------------------------------------------
# cross-attention and the encoder
# ----------------------------------------------------------------------
def _frames(cfg, seed: int = 6, b: int = 2) -> np.ndarray:
    return _x((b, cfg.encoder_seq, cfg.d_model), "float32", seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 5, 12])
def test_cross_attention_matches_reference(sq, dtype):
    """Layer 1's cross-attention of sq decoder positions (1: a decode
    step) against the encoder's K/V of 8 frames, non-causal."""
    cfg, params, tcfg, model = _setup("whisper-base", dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    p = jax.tree.map(lambda a: a[1], params["layers"]["cross_attn"])
    x = _x((2, sq, cfg.d_model), dtype, 7)
    kv = [_x((2, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim_), dtype,
             s) for s in (8, 9)]
    want = RL.cross_attention(p, cfg, jnp.asarray(x, jdt),
                              tuple(jnp.asarray(a, jdt) for a in kv))
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = L.cross_attention(model.layers[1].cross_attn, tcfg,
                                torch.from_numpy(x).to(tdt),
                                tuple(torch.from_numpy(a).to(tdt)
                                      for a in kv))
    assert got.dtype == tdt
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_encoder_kv_match_reference(dtype):
    """``_encode`` (bidirectional, RoPE) over the same frames, then
    ``encoder_kv``'s [L, B, S, KV, D] K and V, in the output's dtype."""
    cfg, params, tcfg, model = _setup("whisper-base", dtype)
    frames = _frames(cfg)
    with _ref_dtype(params):
        enc = RM._encode(cfg, params, jnp.asarray(frames))
    ek, ev = RM.encoder_kv(cfg, params, enc)
    with torch.no_grad():
        tenc = M._encode(tcfg, model, torch.from_numpy(frames))
        tk, tv = M.encoder_kv(tcfg, model, tenc)
    assert str(tenc.dtype).endswith(str(enc.dtype))
    _close(tenc, enc, TOL[dtype])
    shape = (cfg.num_layers, 2, cfg.encoder_seq, cfg.num_kv_heads,
             cfg.head_dim_)
    for got, want in ((tk, ek), (tv, ev)):
        assert tuple(got.shape) == tuple(want.shape) == shape
        assert str(got.dtype).endswith(str(want.dtype))
        _close(got, want, TOL[dtype])


def test_encoder_attention_is_bidirectional():
    """The encoder's output at the first frame depends on the last frame
    (no causal mask), and a decoder's forward depends on the frames."""
    cfg, _, tcfg, model = _setup("whisper-base", "float32")
    frames = torch.from_numpy(_frames(cfg, b=1))
    moved = frames.clone()
    moved[0, -1] += 1.0
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        a, b = (M._encode(tcfg, model, f) for f in (frames, moved))
        la, lb = (M.forward(tcfg, model, {"tokens": toks, "frames": f})
                  for f in (frames, moved))
    assert not torch.equal(a[0, 0], b[0, 0])
    assert not torch.equal(la, lb)


def test_vision_prefix_overwrites_the_first_positions():
    cfg, _, tcfg, model = _setup("internvl2-26b", "float32")
    toks = torch.from_numpy(np.arange(12, dtype=np.int32)[None])
    ve = torch.from_numpy(_x((1, cfg.vision_prefix, cfg.d_model),
                             "float32", 8))
    x = M.embed_inputs(tcfg, model, {"tokens": toks, "vision_embeds": ve})
    assert torch.equal(x[:, :cfg.vision_prefix], ve)
    assert torch.equal(x[:, cfg.vision_prefix:],
                       model.embed[toks[:, cfg.vision_prefix:].long()])


# ----------------------------------------------------------------------
# train steps and checkpoints of the new families
# ----------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-base",
                                  "internvl2-26b"])
def test_train_step_matches_reference(arch, accum):
    check_train_step(arch, accum)


@pytest.mark.parametrize("arch", ["whisper-base", "olmoe-1b-7b"])
def test_checkpoint_files_match_reference(tmp_path, arch):
    check_checkpoint_files(tmp_path, arch)


@pytest.mark.parametrize("arch", ["whisper-base", "olmoe-1b-7b"])
def test_checkpoints_restore_across_packages(tmp_path, arch):
    check_restore_across_packages(tmp_path, arch)
