"""The port's attention held against the JAX package.

The same seeded numpy inputs go through ``repro`` (the jnp oracles and the
Pallas kernels in interpret mode) and ``repro_torch`` (the plain PyTorch
versions and the ``ops`` entry points, which take the plain versions for
CPU tensors).  Tolerances are those of ``tests/test_kernels.py``: fp32
2e-5 (the two frameworks sum in another order), bf16 2e-2 (one bf16
rounding of the output).  bf16 inputs are rounded once, by JAX, and the
same values go to both packages.

The CUDA kernels run only on the card: ``tests/test_torch_gpu.py`` holds
them against these plain versions there.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_fwd as pallas_flash)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_attention_ref)
from repro.kernels.paged_attention.paged_attention import (  # noqa: E402
    paged_attention_decode as pallas_paged)
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref as jax_paged_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_kernel)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention as paged_kernel)
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the sweeps of tests/test_kernels.py
FLASH_SHAPES = [(1, 4, 4, 256, 64), (2, 8, 2, 512, 64), (1, 8, 1, 256, 128)]
MASKS = [(True, None), (False, None), (True, 64)]
PAGED_SHAPES = [(2, 4, 2, 16, 16, 4, 64), (3, 2, 4, 32, 8, 8, 128),
                (1, 1, 8, 8, 16, 2, 64)]
# Hymba-1.5B's prefill: B 4, 25 / 5 heads, S 2,048, D 64
HYMBA_FLASH = (4, 25, 5, 2048, 64)


def _tol(dtype: str):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(a: np.ndarray, dtype: str):
    """One array in both packages, rounded once (by JAX) to ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype(jnp.float32))


def _flash_inputs(seed, b, h, kv, s, d, dtype):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(shape).astype(np.float32), dtype)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]


def _paged_inputs(seed, b, kv, g, pages, ps, mp, d, dtype):
    rng = np.random.default_rng(seed)
    h = kv * g
    q, kp, vp = [_pair(rng.standard_normal(shape).astype(np.float32), dtype)
                 for shape in ((b, h, d), (pages, ps, kv, d),
                               (pages, ps, kv, d))]
    tables = rng.integers(0, pages, (b, mp)).astype(np.int32)
    lens = rng.integers(1, mp * ps, (b,)).astype(np.int32)
    return q, kp, vp, tables, lens


# ----------------------------------------------------------------------
# plain versions against the jnp oracles
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,h,kv,s,d", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_ref_matches_reference(b, h, kv, s, d, dtype, causal,
                                         window):
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(0, b, h, kv, s, d, dtype)
    want = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = flash_ops.flash_attention(tq, tk, tv, causal, window)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_rows_that_see_no_key(dtype, causal):
    """300 queries against 100 keys with a window of 64: rows 163 on see
    no key.  The -1e30 fill gives them uniform weights, so the reference
    and the port's plain forward (through the entry point) give them the
    mean of their KV head's v; the rows before stay the reference's."""
    rng = np.random.default_rng(9)
    (jq, tq), (jk, tk), (jv, tv) = [
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((1, 4, 300, 64), (1, 2, 100, 64), (1, 2, 100, 64))]
    want = jax_attention_ref(jq, jk, jv, causal=causal, window=64)
    got = flash_ops.flash_attention(tq, tk, tv, causal, 64)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    mean = tv.float().mean(dim=2).repeat_interleave(2, dim=1)  # [1, 4, 64]
    blind = got[:, :, 100 + 64 - 1:]
    np.testing.assert_allclose(
        _f32(blind), _f32(mean[:, :, None].expand_as(blind).to(tv.dtype)),
        **_tol(dtype))
    np.testing.assert_allclose(_f32(want)[:, :, 163:], _f32(blind),
                               **_tol(dtype))


@pytest.mark.parametrize("s", [37, 300])
def test_attention_ref_ragged_matches_reference(s):
    """Prompt lengths the Pallas kernel's block assert refuses (causal,
    GQA 2:1, D 128)."""
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(1, 1, 4, 2, s, 128,
                                                 "float32")
    want = jax_attention_ref(jq, jk, jv, causal=True)
    got = attention_ref(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


@pytest.mark.parametrize("b,kv,g,pages,ps,mp,d", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_attention_ref_matches_reference(b, kv, g, pages, ps, mp, d,
                                               dtype):
    (jq, tq), (jk, tk), (jv, tv), tables, lens = _paged_inputs(
        2, b, kv, g, pages, ps, mp, d, dtype)
    want = jax_paged_ref(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens))
    got = paged_ops.paged_attention(tq, tk, tv, torch.from_numpy(tables),
                                    torch.from_numpy(lens))
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


# ----------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ----------------------------------------------------------------------
def test_attention_ref_matches_pallas_kernel():
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(3, 1, 4, 2, 128, 64,
                                                 "float32")
    want = pallas_flash(jq, jk, jv, causal=True, interpret=True)
    got = attention_ref(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


def test_paged_attention_ref_matches_pallas_kernel():
    (jq, tq), (jk, tk), (jv, tv), tables, lens = _paged_inputs(
        4, 2, 4, 2, 16, 16, 4, 64, "float32")
    want = pallas_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens),
                        interpret=True)
    got = paged_attention_ref(tq, tk, tv, torch.from_numpy(tables),
                              torch.from_numpy(lens))
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


# ----------------------------------------------------------------------
# the paged kernel's split-and-combine, in plain torch
# ----------------------------------------------------------------------
def _split_combine(q, k_pages, v_pages, tables, lens, split):
    """Paged decode as the kernel computes it: the context cut into splits
    of ``split`` positions, each split's (max, sum, weighted V) taken over
    its own valid positions alone (a split with none is (NEG_INF, 0, 0)),
    then every split rescaled by exp(m - max m) and summed."""
    b, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    g = h // kvh
    cap = tables.shape[1] * ps
    k = k_pages[tables.long()].reshape(b, cap, kvh, d).float()
    v = v_pages[tables.long()].reshape(b, cap, kvh, d).float()
    qr = q.reshape(b, kvh, g, d).float() / math.sqrt(d)
    ms, ls, accs = [], [], []
    for p0 in range(0, cap, split):
        pos = torch.arange(p0, min(p0 + split, cap))
        s = torch.einsum("bhgd,bkhd->bhgk", qr, k[:, pos])
        valid = (pos[None, :] <= lens.long()[:, None])[:, None, None, :]
        m = torch.where(valid, s, torch.tensor(-1e30)).amax(-1)
        p = torch.where(valid, torch.exp(s - m[..., None]), torch.tensor(0.))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bkhd->bhgd", p, v[:, pos]))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(0))
    out = (w[..., None] * torch.stack(accs)).sum(0) / \
        (w * torch.stack(ls)).sum(0)[..., None]
    return out.reshape(b, h, d)


@pytest.mark.parametrize("split", [16, 64, 256])
@pytest.mark.parametrize("b,kv,g,pages,ps,mp,d", [(4, 2, 2, 32, 16, 24, 64),
                                                  (4, 1, 8, 64, 8, 100, 32)])
def test_split_combine_matches_reference(split, b, kv, g, pages, ps, mp, d):
    """Splits of 16, 64 and 256 positions: lens 0 (every split but the
    first empty), on a split's last and the next's first position, and a
    ragged tail; the tables reach far past most contexts."""
    (jq, tq), (jk, tk), (jv, tv), tables, _ = _paged_inputs(
        9, b, kv, g, pages, ps, mp, d, "float32")
    lens = np.array([0, split - 1, split, min(mp * ps - 1, 2 * split + 7)],
                    np.int32)[:b]
    want = jax_paged_ref(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens))
    got = _split_combine(tq, tk, tv, torch.from_numpy(tables),
                         torch.from_numpy(lens), split)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


@pytest.mark.parametrize("mp,ps", [(1, 16), (74, 16), (4000, 16), (40, 8),
                                   (3, 64), (129, 1)])
def test_split_plan_covers_the_table(mp, ps):
    """Whole pages, at least MIN_SPLIT positions, at most MAX_SPLITS
    splits, and the splits cover the capacity; the split-and-combine over
    that plan equals the reference."""
    split, n = paged_kernel.split_plan(mp, ps)
    assert split % ps == 0 and split >= paged_kernel.MIN_SPLIT
    assert 1 <= n <= paged_kernel.MAX_SPLITS
    assert (n - 1) * split < mp * ps <= n * split
    if mp * ps <= 8192:
        (jq, tq), (jk, tk), (jv, tv), tables, lens = _paged_inputs(
            10, 2, 2, 2, 16, ps, mp, 32, "float32")
        want = jax_paged_ref(jq, jk, jv, jnp.asarray(tables),
                             jnp.asarray(lens))
        got = _split_combine(tq, tk, tv, torch.from_numpy(tables),
                             torch.from_numpy(lens), split)
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


def test_split_plan_of_the_serving_shape():
    """One Qwen3-1.7B request of ~1,180 positions in pages of 16: 19 splits
    of 64, 152 blocks over 8 KV heads."""
    assert paged_kernel.split_plan(74, 16) == (64, 19)
    assert paged_kernel.split_plan(4000, 16) == (512, 125)
    with pytest.raises(ValueError):
        paged_kernel.split_plan(0, 16)


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (torch.bfloat16, 64, True, "mma"), (torch.bfloat16, 128, True, "mma"),
    (torch.bfloat16, 16, True, "mma"), (torch.bfloat16, 256, True, "mma"),
    (torch.bfloat16, 48, True, "mma"), (torch.bfloat16, 40, True, "simt"),
    (torch.bfloat16, 8, True, "simt"), (torch.bfloat16, 64, False, "simt"),
    (torch.float32, 64, True, "simt"), (torch.float32, 128, True, "simt")])
def test_flash_variant_choice(dtype, d, aligned, want):
    """bf16 with D a multiple of 16 up to 256 on aligned tensors takes the
    tensor-core kernel; fp32 (no TF32) and every other call the CUDA-core
    kernel."""
    assert flash_kernel.variant(dtype, d, aligned) == want


def test_reset_launches_clears_the_variant_counts():
    flash_kernel.launches.update(flash_attention=3, flash_attention_bwd=2)
    flash_kernel.variant_launches.update(mma=2, simt=1)
    flash_kernel.bwd_variant_launches.update(mma=1, simt=1)
    flash_kernel.reset_launches()
    assert flash_kernel.launches == {"flash_attention": 0,
                                     "flash_attention_bwd": 0}
    assert flash_kernel.variant_launches == {"mma": 0, "simt": 0}
    assert flash_kernel.bwd_variant_launches == {"mma": 0, "simt": 0}


# ----------------------------------------------------------------------
# the CUDA wrappers take CUDA tensors only
# ----------------------------------------------------------------------
def test_kernel_wrappers_refuse_cpu_tensors():
    (_, tq), (_, tk), (_, tv) = _flash_inputs(6, 1, 2, 1, 8, 16, "float32")
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_kernel.flash_attention_fwd(tq, tk, tv)
    (_, q), (_, kp), (_, vp), tables, lens = _paged_inputs(
        6, 1, 1, 2, 4, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="CUDA kernel"):
        paged_kernel.paged_attention_decode(
            q, kp, vp, torch.from_numpy(tables), torch.from_numpy(lens))
