"""The training backward's plain versions held against the JAX package.

The backward kernels of the fused selective scan and of flash attention
(``csrc/selective_scan.cu``, ``csrc/flash_attention.cu``) compute the
functions ``selective_scan_fused_bwd_ref`` and ``attention_bwd_ref``: the
gradients written out, not autograd through a forward.  Here, on the CPU,
each is held against the reference's own gradient on seeded inputs:

* the scan's against ``jax.vjp`` of the reference's training scan
  (``repro.models.layers._ssm_scan_chunked``) at lengths around 32
  steps, most no multiple of the backward kernel's 8-step chunk, and T =
  1, within 1e-4 of each gradient's largest;
* attention's against ``jax.grad`` through the reference's custom-VJP
  flash attention (its Pallas forward in interpret mode), causal,
  non-causal and windowed, Sq != Skv, groups of 1, 2, 5 and 48, D 64 and
  128: fp32 within 1e-4, bf16 inputs within 2e-2; and rows that see no
  key (a window, Sq past Skv + window - 1), where the -1e30 fill gives
  uniform weights, against ``jax.vjp`` of the reference's
  ``attention_ref`` (its backward);
* ``supports`` and the backward's variant over every attention config of
  the registry, which all train through the backward.

The card run (``chip_smoke.py`` phases 5, 9, 14; ``tests/test_torch_gpu.py``)
holds the kernels against these functions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as ref_flash)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_attention_ref)
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_kernel)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.selective_scan import fused  # noqa: E402
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_fused_bwd_ref)
from repro_torch.kernels.selective_scan.selective_scan import (  # noqa
    busiest_sm)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    return err / scale if scale > 0 else err


# ----------------------------------------------------------------------
# the fused scan
# ----------------------------------------------------------------------
def _scan_inputs(seed, b, t, di, n):
    rng = np.random.default_rng(seed)
    dt = (0.01 + 0.2 * rng.random((b, t, di))).astype(np.float32)
    x = rng.standard_normal((b, t, di)).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    c = rng.standard_normal((b, t, n)).astype(np.float32)
    a = -(np.arange(1, n + 1, dtype=np.float32)[None]
          * (0.5 + rng.random((di, n)))).astype(np.float32)
    dy = rng.standard_normal((b, t, di)).astype(np.float32)
    return (dt, x, bm, c, a), dy


# (T, the reference's chunk, which must divide T): one step; lengths
# around 32 steps, most no multiple of the kernel's 8-step chunk; several
# reference chunks
@pytest.mark.parametrize("t,chunk", [(1, 1), (13, 13), (31, 31), (33, 11),
                                     (37, 37), (40, 8)])
def test_scan_bwd_ref_matches_reference_vjp(t, chunk):
    """ddt, dx, dB, dC and dA of ``selective_scan_fused_bwd_ref`` against
    ``jax.vjp`` of the reference's ``_ssm_scan_chunked`` (bx = (dt * x) *
    B formed before it, as the reference's Mamba block does)."""
    args, dy = _scan_inputs(t, 2, t, 8, 4)

    def ref(dt, x, bm, c, a):
        bx = (dt * x)[..., None] * bm[:, :, None, :]
        return RL._ssm_scan_chunked(dt, a, bx, c, chunk)
    _, vjp = jax.vjp(ref, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    got = selective_scan_fused_bwd_ref(*map(torch.from_numpy, args),
                                       torch.from_numpy(dy))
    for name, g, r in zip(("ddt", "dx", "dB", "dC", "dA"), got, want):
        assert _rel(g, r) <= 1e-4, name


@pytest.mark.parametrize("t", [1, 9, 35])
def test_scan_bwd_ref_matches_function_on_cpu(t):
    """The plain backward against the ``Function``'s CPU backward (autograd
    through the chunked scan), which the CPU route keeps: one function."""
    args, dy = _scan_inputs(100 + t, 2, t, 6, 16)
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    want = torch.autograd.grad(scan_ops.selective_scan_fused(*ins), ins,
                               torch.from_numpy(dy))
    got = selective_scan_fused_bwd_ref(*map(torch.from_numpy, args),
                                       torch.from_numpy(dy))
    for name, g, r in zip(("ddt", "dx", "dB", "dC", "dA"), got, want):
        assert _rel(g, r) <= 1e-4, name


def test_scan_bwd_scratch_and_wrapper_refuse_cpu():
    """The backward's scratch as the source lays it out (B and C in the
    scan's four state orders, a state at each 8-step chunk's end, each
    block's dB and dC a step at the plan's channels a block, each row's
    dA), and the kernel wrapper and the occupancy query refuse the CPU
    (the ``Function`` takes the plain route there)."""
    assert fused.bwd_scratch(4, 2048, 3200, 104) == {
        "bcp": (2, 4, 2048, 4, 16), "hbuf": (4, 256, 3200, 16),
        "part_bc": (4, 31, 2048, 32), "part_a": (4, 3200, 16)}
    assert fused.bwd_scratch(2, 33, 37, 8)["hbuf"] == (2, 5, 37, 16)
    assert fused.bwd_scratch(2, 32, 37, 8)["part_bc"] == (2, 5, 32, 32)
    args, dy = _scan_inputs(0, 1, 4, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fused.selective_scan_fused_bwd(*map(torch.from_numpy, args),
                                       torch.from_numpy(dy))
    with pytest.raises(ValueError, match="card"):
        fused.bwd_occupancy(104, torch.device("cpu"))


H100_SMS = 132


# (B, di, channels a block, blocks the busiest SM runs): Hymba-1.5B's
# and Falcon-Mamba-7B's prefill widths, B 1 at Falcon's, a narrow layer
@pytest.mark.parametrize("b,di,channels,per_sm", [
    (4, 3200, 104, 1), (4, 8192, 128, 2), (1, 8192, 64, 1), (2, 96, 8, 1)])
def test_scan_bwd_plan_model_widths(b, di, channels, per_sm):
    """``bwd_plan`` on 132 SMs: the channels a block it takes, the blocks
    the busiest SM runs (its grid spread evenly: what the card holds of
    them at once is the card's to say, ``bwd_occupancy``), and that no
    other channels a block give the busiest SM fewer channels."""
    p = fused.bwd_plan(b, di, H100_SMS)
    assert (p.channels, p.sm_blocks) == (channels, per_sm)
    assert p.threads == 4 * channels and p.threads % 32 == 0
    assert p.grid == (-(-di // channels), b)
    load = busiest_sm(b, di, channels, H100_SMS)
    assert load == per_sm * channels
    assert all(busiest_sm(b, di, ch, H100_SMS) >= load
               for ch in fused.BWD_CHANNELS)


@pytest.mark.parametrize("channels,per_sm", [(8, 13), (32, 4), (56, 2),
                                             (64, 2), (104, 1), (128, 1)])
def test_scan_bwd_blocks_an_sm(channels, per_sm):
    """The blocks the busiest SM runs at Hymba-1.5B's width (B 4, di
    3,200) on 132 SMs, at each channels a block: the grid's blocks spread
    evenly, so no SM runs more than one block over the mean."""
    p = fused.bwd_shape(4, 3200, channels, H100_SMS)
    blocks = p.grid[0] * p.grid[1]
    assert p.sm_blocks == per_sm
    assert (per_sm - 1) * H100_SMS < blocks <= per_sm * H100_SMS


@pytest.mark.parametrize("b,di,channels", [(4, 3200, 12), (4, 3200, 0),
                                           (4, 3200, 136),
                                           (65536, 3200, 104),
                                           (0, 3200, 104), (4, 0, 104)])
def test_scan_bwd_shape_refuses(b, di, channels):
    """Channels a block the launcher refuses (no multiple of 8, past 128)
    and grids the card does not take (B past 65,535 or 0, di 0) raise."""
    with pytest.raises(ValueError):
        fused.bwd_shape(b, di, channels, H100_SMS)


def test_scan_bwd_plan_refuses_past_the_grid():
    with pytest.raises(ValueError, match="rows"):
        fused.bwd_plan(65536, 3200, H100_SMS)


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------
def _attn_inputs(seed, b, h, kv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d), (b, h, sq, d)))


def _check_attention(dtype, b, h, kv, sq, skv, d, causal, window):
    """``attention_bwd_ref`` (given the reference's output) against
    ``jax.grad`` of sum(flash_attention(q, k, v) * dout) through the
    reference's custom VJP, its forward in interpret mode."""
    tdt, jdt = DTYPES[dtype]
    q, k, v, w = _attn_inputs(sq * h + d, b, h, kv, sq, skv, d)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jw = jnp.asarray(w, jdt)
    out = ref_flash(jq, jk, jv, causal, window, True)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(
        (ref_flash(q_, k_, v_, causal, window, True) * jw)
        .astype(jnp.float32)), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tw = (torch.from_numpy(a).to(tdt) for a in (q, k, v, w))
    tout = torch.from_numpy(_np(out).copy()).to(tdt)
    got = attention_bwd_ref(tq, tk, tv, tout, tw, causal=causal,
                            window=window)
    for name, g, r in zip("qkv", got, want):
        assert g.dtype == tdt, name
        assert _rel(g, r) <= TOL[dtype], name


MASKS = [(True, None), (False, None), (True, 32)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("h,kv,d", [(4, 4, 64), (4, 2, 64), (10, 2, 128)])
def test_attention_bwd_ref_matches_reference_grad(dtype, causal, window, h,
                                                  kv, d):
    """Groups 1, 2 and 5 at D 64 and 128 under each mask."""
    _check_attention(dtype, 1, h, kv, 64, 64, d, causal, window)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_bwd_ref_wide_group(dtype):
    """Granite-34B's group, 48 query heads on one KV head, D 128."""
    _check_attention(dtype, 1, 48, 1, 32, 32, 128, True, None)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sq,skv,causal", [(32, 64, False), (64, 32, False),
                                           (64, 32, True)])
def test_attention_bwd_ref_sq_differs_from_skv(dtype, sq, skv, causal):
    """Sq != Skv, as Whisper's cross-attention (fewer queries than keys,
    non-causal), and more queries than keys."""
    _check_attention(dtype, 2, 4, 2, sq, skv, 64, causal, None)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_ref_rows_that_see_no_key(dtype, causal):
    """Window 8 over 24 keys: query rows 31 on see no key, so the -1e30
    fill gives them uniform weights 1 / Skv; they add dO / Skv to every
    key's dv and nothing to dq or dk.  Against ``jax.vjp`` of the
    reference's ``attention_ref`` (the reference's backward), given its
    output."""
    tdt, jdt = DTYPES[dtype]
    q, k, v, w = _attn_inputs(7, 1, 4, 2, 48, 24, 64)
    jin = [jnp.asarray(a, jdt) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_attention_ref(
        q_, k_, v_, causal=causal, window=8), *jin)
    want = vjp(jnp.asarray(w, jdt))
    tin = [torch.from_numpy(a).to(tdt) for a in (q, k, v, w)]
    got = attention_bwd_ref(tin[0], tin[1], tin[2],
                            torch.from_numpy(_np(out).copy()).to(tdt), tin[3],
                            causal=causal, window=8)
    for name, g, r in zip("qkv", got, want):
        assert _rel(g, r) <= TOL[dtype], name
    # the rows past 24 + 8 - 1 move dv only, by their dO / Skv (in fp32,
    # on the same values: the difference of two bf16 dv would round)
    assert torch.all(got[0][:, :, 31:] == 0)
    q32, k32, v32, w32 = (t.float() for t in tin)
    out32 = torch.from_numpy(_np(out).copy()).to(tdt).float()
    whole = attention_bwd_ref(q32, k32, v32, out32, w32, causal=causal,
                              window=8)
    base = attention_bwd_ref(q32[:, :, :31], k32, v32, out32[:, :, :31],
                             w32[:, :, :31], causal=causal, window=8)
    extra = w32[:, :, 31:].reshape(1, 2, 2, 17, 64).sum((2, 3)) / 24
    assert _rel(whole[2] - base[2],
                extra[:, :, None].expand(1, 2, 24, 64)) <= 1e-5
    assert _rel(whole[1], base[1]) <= 1e-6


@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_bwd_ref_matches_function_on_cpu(causal, window):
    """The plain backward against the ``Function``'s CPU backward (autograd
    through ``attention_ref``), which the CPU route keeps."""
    q, k, v, w = (torch.from_numpy(a) for a in
                  _attn_inputs(3, 2, 6, 3, 40, 40, 16))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_ops.flash_attention(*ins, causal, window)
    want = torch.autograd.grad(out, ins, w)
    got = attention_bwd_ref(q, k, v, out.detach(), w, causal=causal,
                            window=window)
    for name, g, r in zip("qkv", got, want):
        assert _rel(g, r) <= 1e-5, name
    assert torch.equal(out.detach(), attention_ref(q, k, v, causal=causal,
                                                   window=window))


def test_flash_bwd_wrapper_refuses_cpu():
    """The backward kernels' wrapper raises on CPU tensors (the
    ``Function`` takes the plain route there) and on an lse of the wrong
    shape."""
    q, k, v, w = (torch.from_numpy(a) for a in
                  _attn_inputs(4, 1, 2, 1, 8, 8, 16))
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_bwd(q, k, v, q, lse, w)


ATTENTION_CONFIGS = [name for name in list_configs()
                     if get_config(name).has_attention]


@pytest.mark.parametrize("name", ATTENTION_CONFIGS)
def test_backward_supports_every_attention_config(name):
    """Every attention config of the registry (and its smoke config)
    trains through the backward kernels: ``supports`` takes its heads, and
    its bf16 backward takes the tensor cores (D a multiple of 16 up to
    128), fp32 the CUDA cores."""
    for cfg in (get_config(name), get_config(name).smoke()):
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        assert flash_kernel.supports(h, kvh, d), (cfg.name, h, kvh, d)
        assert flash_kernel.bwd_variant(torch.bfloat16, d) == "mma", \
            (cfg.name, d)
        assert flash_kernel.bwd_variant(torch.float32, d) == "simt"


def test_bwd_variant_edges():
    """The tensor-core backward takes bf16 at D 16 to 128 in steps of 16
    with aligned rows; D 256, D 40 and unaligned rows take the CUDA
    cores, as fp32 always does."""
    for d in range(16, 129, 16):
        assert flash_kernel.bwd_variant(torch.bfloat16, d) == "mma"
    for d in (8, 40, 144, 256):
        assert flash_kernel.bwd_variant(torch.bfloat16, d) == "simt"
    assert flash_kernel.bwd_variant(torch.bfloat16, 64, False) == "simt"
    assert flash_kernel.bwd_variant(torch.float32, 64) == "simt"
    assert flash_kernel.variant(torch.bfloat16, 256) == "mma"
