"""The port's CUDA kernels held against its own plain versions, on a card.

Every test here needs a CUDA card and ``nvcc``: each carries the ``gpu``
marker and skips, with the reason, where either is missing.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
a card and no JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

The plain versions are held against the JAX package on the CPU by the
other ``tests/test_torch_*.py`` files; here each kernel is held against
its plain version on the same seeded inputs: the Bloom probes bit for bit,
attention within fp32 2e-5 / bf16 2e-2, the scans within 1e-4, the
training backward's kernels within 1e-4 (fp32) / 2e-2 (bf16) of each
gradient's largest and bit for bit from one launch to the next, and a
store on the card publishes the CPU store's rows byte for byte.  The
example twins (``examples/*_torch.py``) run on the card at their smallest
sizes, each launching its path's kernels, their lines those of the
reference's examples (``tests/data/examples_reference``) or of a CPU run.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.lsm as pt_lsm  # noqa: E402
from repro_torch import workloads as pt_wl  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bloom_probe import bloom_probe as bloom_kernel  # noqa
from repro_torch.kernels.bloom_probe import ref as bloom_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_kernel)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention as paged_kernel)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref)
from repro_torch.kernels.selective_scan import fused as fused_kernel  # noqa
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan as scan_kernel)
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_fused_bwd_ref, selective_scan_fused_ref,
    selective_scan_ref)
from repro_torch.lsm import filters  # noqa: E402
from repro_torch.zoned.device import MiB  # noqa: E402

ATTN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_SHAPES = [(1, 4, 4, 256, 64), (2, 8, 2, 512, 64), (1, 8, 1, 256, 128)]
MASKS = [(True, None), (False, None), (True, 64)]
PAGED_SHAPES = [(2, 4, 2, 16, 16, 4, 64), (3, 2, 4, 32, 8, 8, 128),
                (1, 1, 8, 8, 16, 2, 64)]
# Hymba-1.5B's prefill: B 4, 25 / 5 heads, S 2,048, D 64
HYMBA_FLASH = (4, 25, 5, 2048, 64)
# the dense configs' groups at D 128: Granite-34B's MQA (48 / 1),
# Qwen2.5-14B's 40 / 8 and Minitron-4B's 24 / 8, at ragged S
DENSE_FLASH = [(1, 48, 1, 1531, 128), (2, 40, 8, 1000, 128),
               (2, 24, 8, 1000, 128)]
# paged groups past a block's 16 rows: G 48 (three chunks), 32 (two) and
# 17 on two KV heads (a full chunk and one of a row), contexts past one
# split; the same groups also at lens 0, 63 and 64 (PAGED_LENS)
WIDE_PAGED = [(2, 1, 48, 256, 16, 96, 128), (2, 1, 32, 256, 16, 96, 128),
              (3, 2, 17, 128, 16, 40, 128)]
PAGED_LENS = (0, 63, 64)
# scans (b, t, di, n): the sweep of tests/test_kernels.py, lengths and
# widths the Pallas kernels refuse, and the fused kernel's edges
SCAN_SHAPES = [(1, 64, 256, 8), (2, 128, 512, 16), (1, 256, 256, 4)]
RAGGED = [(2, 37, 200, 16), (1, 1, 48, 8), (3, 70, 96, 5)]
EDGES = [(2, 40, 96, 16, "underflow"), (2, 40, 96, 16, "zero"),
         (2, 40, 96, 16, "zero_odd_steps"), (2, 40, 96, 1, "model"),
         (1, 33, 37, 5, "model"), (3, 17, 100, 8, "zero_odd_steps")]
# v1's edges: T 1 and around its 4-step ring stage, di 3,000 (no multiple
# of a block's channels) and 37 (the scalar route), N 1, 5, 8 (the scalar
# route), decays all 0, all 1 and 1 on every other step, B 1 at
# Falcon-Mamba-7B's width, and bx offset by one float (not 16-byte
# aligned: the scalar route at N 16)
V1_EDGES = ([(2, t, 3000, 16, "model") for t in (1, 3, 4, 5, 9)]
            + [(3, 70, 37, 16, "model"), (2, 40, 1000, 1, "model"),
               (2, 40, 1000, 5, "model"), (2, 40, 1000, 8, "model"),
               (2, 100, 1000, 16, "underflow"), (2, 100, 1000, 16, "zero"),
               (2, 100, 1000, 16, "zero_odd_steps"),
               (1, 2048, 8192, 16, "model"), (2, 37, 200, 16, "bx_offset"),
               (2, 65, 3000, 16, "bx_offset")])
# v1's launch options (channels a block, stages) whatever the wrapper picks:
# the fewest of each, a width no power of 2, the model shapes' plans (the
# widest block among them)
V1_OPTIONS = [(8, 1), (40, 2), (104, 8), (256, 3)]
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
# Bloom pairs cases: (filter sizes in keys, extra slots' num_words,
# queries, pairs a query, the pairs' k: fixed values or "mixed" 1..16)
SLOT_CASES = {
    "several_slots_mixed_k": ((64, 300, 1000, 7), (), 400, 3, "mixed"),
    "k1_and_k16": ((300, 1000), (), 200, 2, (1, 16)),
    "one_word": ((1,), (), 64, 1, "mixed"),
    "no_pairs": ((64,), (), 5, 0, "mixed"),
}


@pytest.fixture
def card():
    """The CUDA device, or a skip with the reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        _build.nvcc_path()
    except RuntimeError as err:
        pytest.skip(str(err))
    return torch.device("cuda")


def _f32(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def _attn_tol(dtype: str):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _randn(rng, shape, dtype: str) -> torch.Tensor:
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(ATTN_DTYPES[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,s,d", FLASH_SHAPES + [(1, 16, 8, 1000, 128),
                                                       (1, 16, 8, 1531, 128),
                                                       HYMBA_FLASH]
                         + DENSE_FLASH)
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_kernel_matches_plain(card, b, h, kv, s, d, dtype, causal,
                                    window):
    rng = np.random.default_rng(7)
    args = [_randn(rng, shape, dtype).to(card)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]
    got = flash_kernel.flash_attention_fwd(*args, causal=causal,
                                           window=window)
    want = attention_ref(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_attn_tol(dtype))


# (b, h, kv, sq, d, skv), window 64: the rows from Skv + 63 on see no key.
# A forward block takes 64 folded rows (32 positions at G 2, 12.8 at G 5),
# so some blocks straddle the first such row and the later ones hold only
# such rows
NO_KEY_FLASH = [(1, 4, 2, 300, 64, 100), (1, 4, 2, 300, 128, 100),
                (2, 10, 2, 257, 64, 90), (1, 10, 2, 257, 128, 90)]
# the forward kernels and the dtypes each takes ("mma": bf16 only)
FWD_KINDS = [("float32", "simt"), ("bfloat16", "simt"), ("bfloat16", "mma")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,sq,d,skv", NO_KEY_FLASH)
@pytest.mark.parametrize("dtype,kind", FWD_KINDS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_rows_that_see_no_key(card, b, h, kv, sq, d, skv,
                                            dtype, kind, causal):
    """Both forward kernels against ``attention_ref`` where the last rows
    see no key (window 64): there the mean of the KV head's v, summed in
    fp32, and the -1e30 fill's log-sum-exp; a rerun gives the same bits."""
    rng = np.random.default_rng(sq + d)
    q, k, v = (_randn(rng, shape, dtype).to(card) for shape in
               ((b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d)))
    outs = []
    for _ in range(2):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=card)
        flash_kernel.launch(kind, q, k, v, out, causal, 64, lse)
        outs.append((out, lse))
    want = attention_ref(q, k, v, causal=causal, window=64)
    torch.cuda.synchronize()
    (out, lse), (again, lse_again) = outs
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    np.testing.assert_allclose(_f32(out), _f32(want), **_attn_tol(dtype))
    first = skv + 64 - 1
    mean = v.float().mean(dim=2).repeat_interleave(h // kv, dim=1)
    np.testing.assert_allclose(
        _f32(out[:, :, first:]),
        _f32(mean[:, :, None].expand(b, h, sq - first, d).to(q.dtype)),
        **_attn_tol(dtype))
    assert torch.all(lse[:, :, first:] == -1e30)
    assert torch.isfinite(lse[:, :, :first]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("b,kv,g,pages,ps,mp,d",
                         PAGED_SHAPES + [(1, 8, 2, 512, 16, 80, 128)]
                         + WIDE_PAGED)
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
def test_paged_kernel_matches_plain(card, b, kv, g, pages, ps, mp, d, dtype):
    _check_paged(card, b, kv, g, pages, ps, mp, d, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kv,g", [(1, 48), (1, 32), (2, 17)])
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
def test_paged_kernel_wide_groups_at_split_edges(card, kv, g, dtype):
    """lens 0 (every split but the first empty), on a split's last
    position (63) and on the next's first (64), in a table of 8 pages of
    16."""
    _check_paged(card, len(PAGED_LENS), kv, g, 64, 16, 8, 128, dtype,
                 PAGED_LENS)


def _check_paged(card, b, kv, g, pages, ps, mp, d, dtype, lens=None):
    rng = np.random.default_rng(8)
    q, kp, vp = [_randn(rng, shape, dtype).to(card)
                 for shape in ((b, kv * g, d), (pages, ps, kv, d),
                               (pages, ps, kv, d))]
    tables = torch.from_numpy(
        rng.integers(0, pages, (b, mp)).astype(np.int32)).to(card)
    lens = torch.from_numpy(
        (rng.integers(1, mp * ps, (b,)) if lens is None
         else np.array(lens)).astype(np.int32)).to(card)
    got = paged_kernel.paged_attention_decode(q, kp, vp, tables, lens)
    want = paged_attention_ref(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_attn_tol(dtype))


# ----------------------------------------------------------------------
# Bloom probes
# ----------------------------------------------------------------------
def _adversarial_keys(rng, n):
    keys = rng.integers(0, 2**63, n).astype(np.uint64)
    keys[0] = np.uint64(0)
    keys[1] = np.uint64(2**64 - 1)
    keys[2] = np.uint64(2**64 - 1)          # duplicate extreme
    keys[3:6] = keys[6]                     # duplicate run
    return keys


def _t32(a):
    """uint32 numpy -> int32 CPU tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _i64(keys):
    """uint64 numpy keys -> int64 CPU tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(keys, np.uint64)
                            .view(np.int64))


def _queries(rng, member):
    return np.concatenate([
        member[:512],
        np.array([0, 2**64 - 1, 2**64 - 1, 1], dtype=np.uint64),
        rng.integers(0, 2**64, 1532, dtype=np.uint64)])


def _slot_case(rng, sizes, extra_words, n_queries, per_query, ks):
    """The pairs form's operands: a store image of filters of ``sizes``
    keys (10 bits a key) plus slots of ``extra_words`` words at offset 0,
    and ``per_query`` pairs for each query on random slots."""
    chunks, offs, nws, kk, cur, members = [], [], [], [], 0, []
    for n in sizes:
        keys = _adversarial_keys(rng, n) if n >= 7 else \
            rng.integers(0, 2**63, n).astype(np.uint64)
        nw, k = filters.filter_params(n, 10)
        lo, hi = filters.split_hash(keys)
        chunks.append(filters.build_filter_np(lo, hi, nw, k))
        offs.append(cur)
        nws.append(nw)
        kk.append(k)
        members.append(keys)
        cur += nw
    for nw in extra_words:
        offs.append(0)
        nws.append(nw)
        kk.append(7)
    words = np.concatenate(chunks)
    queries = np.concatenate([
        members[min(1, len(members) - 1)][:n_queries // 4],
        np.array([0, 2**63, 2**63 + 1, 2**64 - 1], np.uint64),
        rng.integers(0, 2**64, n_queries, dtype=np.uint64)])[:n_queries]
    p = n_queries * per_query
    pair_key = rng.integers(0, n_queries, p).astype(np.int32)
    if p:
        pair_key[-1] = n_queries - 1
    pair_slot = rng.integers(0, len(offs), p).astype(np.int32)
    if ks == "mixed":
        pair_k = rng.integers(1, 17, p).astype(np.uint8)
    else:
        pair_k = np.array(ks, np.uint8)[rng.integers(0, len(ks), p)]
    return (_i64(queries), torch.from_numpy(pair_key),
            torch.from_numpy(pair_slot), torch.from_numpy(pair_k),
            torch.from_numpy(np.array(offs, np.int64)),
            torch.from_numpy(np.array(nws, np.int32)), _t32(words))


@pytest.mark.gpu
def test_kernel_matches_plain(card):
    """Both Bloom launchers equal their plain versions bit for bit."""
    rng = np.random.default_rng(13)
    member = _adversarial_keys(rng, 4096)
    nw, k = filters.filter_params(len(member), 10)
    lo, hi = filters.split_hash(member)
    bits = filters.build_filter_np(lo, hi, nw, k)
    qlo, qhi = filters.split_hash(_queries(rng, member))
    args = (_t32(qlo), _t32(qhi), _t32(bits))
    got = bloom_kernel.bloom_probe(*(a.to(card) for a in args), k)
    assert torch.equal(got.cpu(), bloom_ref.bloom_probe_ref(*args, k))
    for case in SLOT_CASES.values():
        args = _slot_case(rng, *case)
        got = bloom_kernel.bloom_probe_pairs(*(a.to(card) for a in args))
        assert torch.equal(got.cpu(), bloom_ref.bloom_probe_pairs_ref(*args))


# ----------------------------------------------------------------------
# selective scans
# ----------------------------------------------------------------------
def _scan_inputs(seed, b, t, di, n):
    """dt, bx, c, a as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((b, t, di))).astype(np.float32) * 0.1,
            rng.standard_normal((b, t, di, n)).astype(np.float32) * 0.1,
            rng.standard_normal((b, t, n)).astype(np.float32),
            -np.abs(rng.standard_normal((di, n))).astype(np.float32))


def _fused_inputs(seed, b, t, di, n):
    """dt, x, B, c, a."""
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((b, t, di))).astype(np.float32) * 0.1,
            rng.standard_normal((b, t, di)).astype(np.float32),
            rng.standard_normal((b, t, n)).astype(np.float32) * 0.3,
            rng.standard_normal((b, t, n)).astype(np.float32),
            -np.abs(rng.standard_normal((di, n))).astype(np.float32))


def _edge_inputs(seed, b, t, di, n, mode):
    """_fused_inputs with chip_smoke.py's phase 9 edges: "underflow" (dt
    500, |A| >= 0.5: every decay exp(<= -250) = 0), "zero" (dt 0: every
    decay 1), "zero_odd_steps" (dt 0 on odd steps)."""
    dt, x, bm, c, a = _fused_inputs(seed, b, t, di, n)
    if mode == "underflow":
        dt[:], a = 500.0, a - 0.5
    elif mode == "zero":
        dt[:] = 0.0
    elif mode == "zero_odd_steps":
        dt[:, 1::2] = 0.0
    return dt, x, bm, c, a


def _torch(*arrays, dev="cpu"):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element into its
    storage (4 bytes past a 16-byte boundary for fp32)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _bx(dt, x, bm):
    """bx formed outside, in the fused kernel's order: (dt * x) * B."""
    return (dt * x)[..., None] * bm[:, :, None, :]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,di,n", SCAN_SHAPES + RAGGED
                         + [(2, 1000, 3200, 16)])
def test_scan_kernels_match_plain(card, b, t, di, n):
    dt, bx, c, a = _torch(*_scan_inputs(8, b, t, di, n), dev=card)
    got = scan_kernel.selective_scan(dt, bx, c, a)
    np.testing.assert_allclose(_f32(got),
                               _f32(selective_scan_ref(dt, bx, c, a)),
                               **SCAN_TOL)
    dt, x, bm, c, a = _torch(*_fused_inputs(9, b, t, di, n), dev=card)
    got = fused_kernel.selective_scan_fused(dt, x, bm, c, a)
    want = selective_scan_fused_ref(dt, x, bm, c, a)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **SCAN_TOL)
    np.testing.assert_allclose(
        _f32(got),
        _f32(scan_kernel.selective_scan(dt, _bx(dt, x, bm), c, a)),
        **SCAN_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("b,t,di,n,mode", EDGES + [(2, 65, 3000, 16,
                                                     "model")])
def test_fused_kernel_lanes_match_plain(card, lanes, b, t, di, n, mode):
    dt, x, bm, c, a = _torch(*_edge_inputs(12, b, t, di, n, mode), dev=card)
    y = torch.empty_like(dt)
    fused_kernel.launch(fused_kernel.shape(b, di, lanes), dt, x, bm, c, a,
                        y)
    want = selective_scan_fused_ref(dt, x, bm, c, a)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(y), _f32(want), **SCAN_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,di,n,mode", V1_EDGES)
def test_v1_kernel_edges_match_plain(card, b, t, di, n, mode):
    """v1 (bx formed outside) through the wrapper's plan at its edges."""
    dt, x, bm, c, a = _torch(*_edge_inputs(13, b, t, di, n,
                                           "model" if mode == "bx_offset"
                                           else mode), dev=card)
    bx = _bx(dt, x, bm)
    want = selective_scan_ref(dt, bx, c, a)
    if mode == "bx_offset":
        bx = _offset(bx)
        assert bx.is_contiguous() and bx.data_ptr() % 16 == 4
    got = scan_kernel.selective_scan(dt, bx, c, a)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **SCAN_TOL)
    if mode == "zero":
        assert not got.abs().max()          # h stays 0: bx = 0 every step


@pytest.mark.gpu
@pytest.mark.parametrize("channels,stages", V1_OPTIONS)
@pytest.mark.parametrize("b,t,di,n", [(2, 65, 3000, 16), (1, 33, 37, 5)])
def test_v1_kernel_options_match_plain(card, channels, stages, b, t, di, n):
    dt, x, bm, c, a = _torch(*_fused_inputs(14, b, t, di, n), dev=card)
    bx = _bx(dt, x, bm)
    y = torch.empty_like(dt)
    scan_kernel.launch(scan_kernel.shape(b, di, channels, stages), dt, bx,
                       c, a, y)
    want = selective_scan_ref(dt, bx, c, a)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(y), _f32(want), **SCAN_TOL)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_inputs_that_require_grad(card):
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card) for s in ((1, 2, 16, 16), (1, 1, 16, 16),
                                   (1, 1, 16, 16)))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_kernel.flash_attention_fwd(q.requires_grad_(), k, v)
    args = _torch(*_fused_inputs(3, 1, 8, 32, 4), dev=card)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_kernel.selective_scan_fused(args[0].requires_grad_(),
                                          *args[1:])
    with torch.no_grad():
        fused_kernel.selective_scan_fused(*args)


# ----------------------------------------------------------------------
# the training backward
# ----------------------------------------------------------------------
# (b, h, kv, sq, d, skv): G 1, 4, 5 and 48 at D 64 and 128, ragged S,
# fewer queries than keys, and S 300 against 100 keys (with window 64 its
# rows 163 on see no key)
BWD_FLASH = [(1, 4, 4, 256, 64, 256), (2, 8, 2, 200, 64, 200),
             (1, 10, 2, 130, 128, 130), (1, 48, 1, 150, 128, 150),
             (2, 4, 2, 64, 64, 100), (1, 4, 2, 300, 64, 100)]
# the train paths' calls and the tensor-core kernels' edges, each with its
# masks: Hymba-1.5B's layers (full and window 1,024), Qwen3-1.7B's in
# phase 19a (B 2, 16 / 8 heads, S 256, D 128), a ragged Skv (333: no
# multiple of 64 or 128) against fewer and more queries, and G 48 at D
# 128 past one dQ block of positions
BWD_WIDE = [(HYMBA_FLASH + (2048,), True, None),
            (HYMBA_FLASH + (2048,), True, 1024),
            ((2, 16, 8, 256, 128, 256), True, None),
            ((1, 8, 2, 333, 64, 333), True, None),
            ((1, 8, 2, 333, 64, 333), True, 64),
            ((2, 6, 3, 200, 128, 333), False, None),
            ((1, 6, 3, 400, 64, 333), True, 100),
            ((1, 48, 1, 400, 128, 400), True, None)]
BWD_CASES = ([(shape, causal, window) for shape in BWD_FLASH
              for causal, window in MASKS] + BWD_WIDE)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (b, t, di, n, mode): T 1, around 32 and 16 steps, and one below, at and
# one above the backward's 8-step chunk; di no multiple of the plan's
# channels a block (1,000 and 3,000 at B 2: 16 and 48), di odd and dt, x,
# dy one float past a 16-byte boundary ("offset": the 4-byte copies), N 5,
# every decay 0, every other decay 1, Hymba-1.5B's width
BWD_SCAN = [(2, 1, 200, 16, "model"), (2, 33, 96, 16, "model"),
            (3, 70, 37, 5, "model"), (2, 100, 1000, 16, "underflow"),
            (2, 64, 96, 16, "zero_odd_steps"), (1, 300, 3200, 16, "model"),
            (2, 15, 96, 16, "model"), (2, 16, 96, 16, "model"),
            (2, 17, 96, 16, "model"), (2, 7, 96, 16, "model"),
            (2, 8, 96, 16, "model"), (2, 9, 96, 16, "model"),
            (2, 47, 3000, 16, "model"),
            (2, 40, 200, 16, "offset"), (1, 33, 35, 3, "offset")]
# channels a block of the backward's launch, whatever its plan, at di no
# multiple of any of them
BWD_SCAN_CHANNELS = (8, 32, 56, 104, 128)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err / scale if scale > 0 else err


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,window", BWD_CASES)
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
def test_flash_backward_matches_plain(card, shape, causal, window, dtype):
    """dq, dk, dv of the backward kernels (dout in the layers' [B, S, H, D]
    memory) against ``attention_bwd_ref`` on the forward kernel's output,
    and a second launch bit for bit."""
    b, h, kv, sq, d, skv = shape
    rng = np.random.default_rng(sq + h)
    q, k, v = (_randn(rng, shape, dtype).to(card) for shape in
               ((b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d)))
    dout = _randn(rng, (b, sq, h, d), dtype).to(card).transpose(1, 2)
    out, lse = flash_kernel.flash_attention_fwd(
        q, k, v, causal=causal, window=window, with_lse=True)
    got = flash_kernel.flash_attention_bwd(q, k, v, out, lse, dout,
                                           causal=causal, window=window)
    again = flash_kernel.flash_attention_bwd(q, k, v, out, lse, dout,
                                             causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, out, dout, causal=causal,
                             window=window)
    torch.cuda.synchronize()
    for name, g, w, a in zip("qkv", got, want, again):
        assert torch.equal(g, a), name
        assert _rel(g, w) <= BWD_TOL[dtype], name


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,di,n,mode", BWD_SCAN)
def test_scan_backward_matches_plain(card, b, t, di, n, mode):
    """The five gradients of the scan's backward kernels against
    ``selective_scan_fused_bwd_ref``, and a second launch bit for bit."""
    args = _torch(*_edge_inputs(21, b, t, di, n,
                                "model" if mode == "offset" else mode),
                  dev=card)
    dy = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (b, t, di)).astype(np.float32)).to(card)
    if mode == "offset":
        args[0], args[1], dy = _offset(args[0]), _offset(args[1]), \
            _offset(dy)
    got = fused_kernel.selective_scan_fused_bwd(*args, dy)
    again = fused_kernel.selective_scan_fused_bwd(*args, dy)
    want = selective_scan_fused_bwd_ref(*args, dy)
    torch.cuda.synchronize()
    for name, g, w, a in zip(("ddt", "dx", "dB", "dC", "dA"), got, want,
                             again):
        assert torch.equal(g, a), name
        assert _rel(g, w) <= 1e-4, name


@pytest.mark.gpu
@pytest.mark.parametrize("channels", BWD_SCAN_CHANNELS)
def test_scan_backward_channel_options(card, channels):
    """The backward launched with ``channels`` a block, whatever its plan,
    at ragged T and di: the plain backward's gradients, bit for bit from
    one launch to the next."""
    b, t, di = 2, 45, 1004
    args = _torch(*_fused_inputs(23, b, t, di, 16), dev=card)
    dy = torch.from_numpy(np.random.default_rng(24).standard_normal(
        (b, t, di)).astype(np.float32)).to(card)
    p = fused_kernel.bwd_shape(b, di, channels,
                               fused_kernel.sm_count(args[0].device))
    got = fused_kernel.bwd_launch(p, *args, dy)
    again = fused_kernel.bwd_launch(p, *args, dy)
    want = selective_scan_fused_bwd_ref(*args, dy)
    torch.cuda.synchronize()
    for name, g, w, a in zip(("ddt", "dx", "dB", "dC", "dA"), got, want,
                             again):
        assert torch.equal(g, a), name
        assert _rel(g, w) <= 1e-4, name


@pytest.mark.gpu
@pytest.mark.parametrize("channels", BWD_SCAN_CHANNELS)
def test_scan_backward_occupancy(card, channels):
    """What the card reports for the backward's compiled scan kernel at
    ``channels`` a block, on both routes: a block fits (its shared memory
    within the 227 KiB a block may take, at least one block an SM) within
    the 128 registers a thread of its launch bounds; and the SMs hold all
    of the plan's blocks at Hymba-1.5B's width at once."""
    for vec in (True, False):
        occ = fused_kernel.bwd_occupancy(channels, card, vec)
        assert 0 < occ.smem_bytes <= 232448, occ
        assert occ.blocks_per_sm >= 1, occ
        assert occ.registers <= 128, occ
    p = fused_kernel.bwd_plan(4, 3200, fused_kernel.sm_count(card))
    assert fused_kernel.bwd_occupancy(p.channels, card).blocks_per_sm \
        >= p.sm_blocks


@pytest.mark.gpu
def test_functions_launch_the_backward_kernels(card):
    """Through the differentiable entry points on CUDA tensors, each
    backward launches its kernels once (counts + 1; flash's bf16 on the
    tensor cores), and the gradients are the plain backward's."""
    flash_kernel.reset_launches()
    fused_kernel.reset_launches()
    rng = np.random.default_rng(31)
    q, k, v = (_randn(rng, shape, "bfloat16").to(card).requires_grad_()
               for shape in ((2, 6, 96, 64), (2, 2, 96, 64), (2, 2, 96, 64)))
    dout = _randn(rng, (2, 6, 96, 64), "bfloat16").to(card)
    out = flash_ops.flash_attention(q, k, v, True, 32)
    assert flash_kernel.launches == {"flash_attention": 1,
                                     "flash_attention_bwd": 0}
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert flash_kernel.launches["flash_attention_bwd"] == 1
    assert flash_kernel.bwd_variant_launches == {"mma": 1, "simt": 0}
    want = attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                             out.detach(), dout, causal=True, window=32)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) <= BWD_TOL["bfloat16"], name
    args = [t.requires_grad_() for t in
            _torch(*_fused_inputs(32, 2, 45, 96, 16), dev=card)]
    dy = torch.ones(2, 45, 96, device=card)
    y = scan_ops.selective_scan_fused(*args)
    got = torch.autograd.grad(y, args, dy)
    assert fused_kernel.launches == {"selective_scan_fused": 1,
                                     "selective_scan_fused_bwd": 1}
    want = selective_scan_fused_bwd_ref(*(t.detach() for t in args), dy)
    for name, g, w in zip(("ddt", "dx", "dB", "dC", "dA"), got, want):
        assert _rel(g, w) <= 1e-4, name


# ----------------------------------------------------------------------
# the store on the card
# ----------------------------------------------------------------------
def _tiny_scenario() -> pt_lsm.ScenarioConfig:
    """tests/conftest.py's ``tiny_scenario()`` in the port's types."""
    lsm = pt_lsm.LSMConfig(
        obj_size=1024, block_size=4096,
        sst_size=int(0.0632 * MiB),
        memtable_size=int(0.032 * MiB),
        level_targets=(int(0.0632 * MiB),) * 2
        + (int(0.632 * MiB), int(6.32 * MiB), int(63.2 * MiB)),
        store_values=True, block_cache_blocks=8)
    return pt_lsm.ScenarioConfig(
        ssd_zones=20, ssd_zone_cap=int(0.0673 * MiB), hdd_zones=4000,
        hdd_zone_cap=int(0.016 * MiB), lsm=lsm)


@pytest.mark.gpu
def test_cuda_store_matches_cpu_store(card):
    """The same YCSB-C open-loop cell on the card and on the CPU: rows and
    stats identical, and the card's batched reads went through the pairs
    kernel, one launch a batch with a filtered pair plus the re-probes."""
    rows, stats = [], []
    bloom_kernel.reset_launches()
    for dev in ("cuda", "cpu"):
        port = pt_lsm.DB("HHZS", _tiny_scenario(), store_values=True,
                         torch_device=dev)
        pt_wl.run_load(port, n_keys=1200)
        port.flush_all()
        port.drain()
        port.get(3)
        res = pt_wl.run_open_loop(port, pt_wl.YCSB["C"],
                                  pt_wl.PoissonArrivals(60.0), duration=40.0,
                                  n_keys=1200, warmup=5.0, read_batch=64,
                                  seed=3)
        rows.append(json.dumps(res.to_json(), sort_keys=True))
        stats.append(dict(port.tree.stats))
        if dev == "cuda":
            launched = dict(bloom_kernel.launches)
            port_calls = dict(port.tree.probe_calls)
    assert rows[0] == rows[1] and stats[0] == stats[1]
    assert launched["bloom_probe_pairs"] > 0
    calls = port_calls["batch"] + port_calls["reprobe_epoch"] + \
        port_calls["reprobe_mixed_k"] + 1         # + the per-key read
    assert sum(launched.values()) <= calls


# ----------------------------------------------------------------------
# a train step on DTensor state
# ----------------------------------------------------------------------
@pytest.mark.gpu
def test_sharded_step_matches_unsharded_step(card):
    """One train step of the qwen3 smoke config (bf16, seed 0) on the card
    with no mesh, and on DTensor state over the (1, 1) mesh of a one-rank
    NCCL group: the same metrics and every leaf equal, and flash launched
    in both (the forward and its recompute a layer)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import sharding as S
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import to_device
    from repro_torch.models import steps
    cfg = get_config("qwen3-1.7b").smoke()
    tc, par = TrainConfig(total_steps=10, warmup_steps=2), \
        ParallelConfig(seq_shard_activations=False)
    host = SyntheticLM(cfg.vocab_size, 2, 64, seed=3).batch_at(0)
    flash_kernel.reset_launches()
    plain, pm = steps.make_train_step(cfg, tc, par)(
        steps.init_state(cfg, seed=0, device=card), to_device(host, card))
    plain_launches = flash_kernel.launches["flash_attention"]
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, "cuda")
        specs = S.state_specs(mesh, cfg, steps.state_shapes(cfg))
        flash_kernel.reset_launches()
        sharded, sm = steps.make_train_step(
            cfg, tc, par, S.activation_constraint(mesh))(
            steps.init_state(cfg, seed=0, device=card,
                             shardings=(mesh, specs)),
            to_device(host, card, mesh))
        sharded_launches = flash_kernel.launches["flash_attention"]
        assert all(isinstance(p, DTensor)
                   for p in sharded["model"].parameters())
        for k in ("loss", "grad_norm", "lr"):
            assert float(sm[k]) == float(pm[k]), k
        for (n, p), (_, q) in zip(sharded["model"].named_parameters(),
                                  plain["model"].named_parameters()):
            assert torch.equal(p.to_local(), q), n
        for f in ("master", "mu", "nu"):
            for n, t in getattr(plain["opt"], f).items():
                assert torch.equal(getattr(sharded["opt"], f)[n].to_local(),
                                   t), (f, n)
    finally:
        dist.destroy_process_group()
    assert plain_launches == sharded_launches == 2 * cfg.num_layers


# ----------------------------------------------------------------------
# the example twins
# ----------------------------------------------------------------------
ROOT = Path(__file__).resolve().parents[1]
EXAMPLE_REFERENCE = ROOT / "tests" / "data" / "examples_reference"
sys.path.insert(0, str(ROOT))
try:
    from chip_smoke import load_example, wall_free  # noqa: E402
finally:
    sys.path.remove(str(ROOT))


def _twin_launches(run) -> dict:
    """Every kernel wrapper's launches during ``run()``."""
    for mod in (bloom_kernel, flash_kernel, paged_kernel):
        mod.reset_launches()
    run()
    return {**bloom_kernel.launches, **flash_kernel.launches,
            **paged_kernel.launches,
            "flash_bwd_mma": flash_kernel.bwd_variant_launches["mma"]}


@pytest.mark.gpu
@pytest.mark.parametrize("name,argv,file", [
    ("quickstart", [], "quickstart.txt"),
    ("ycsb_demo", ["--quick"], "ycsb_demo_quick.txt")])
def test_store_twin_on_card(card, name, argv, file):
    """The reference example's lines, every read probed by the pairs
    kernel on the card."""
    out = []
    launched = _twin_launches(lambda: out.extend(
        load_example(f"{name}_torch").main(argv + ["--device", "cuda"])))
    assert "".join(line + "\n" for line in out) == \
        (EXAMPLE_REFERENCE / file).read_text()
    assert launched["bloom_probe_pairs"] > 0


@pytest.mark.gpu
def test_serve_paged_twin_on_card(card):
    """Prefill on flash and decode on paged at page size 8; the engine's
    counters and every request's tokens those of the CPU run."""
    out = {}
    launched = _twin_launches(lambda: out.update(
        load_example("serve_paged_torch").main(["--device", "cuda"])))
    cpu = load_example("serve_paged_torch").main(["--device", "cpu"])
    assert out["stats"] == cpu["stats"]
    assert wall_free(out["lines"]) == wall_free(cpu["lines"])
    assert out["tokens"] == cpu["tokens"]
    assert launched["flash_attention"] > 0 and launched["paged_attention"] > 0


@pytest.mark.gpu
def test_train_lm_twin_on_card(card):
    """The default size (D 32): the reference example's model and restarts
    lines, the loss falls, and every attention call runs the flash
    forward and both tensor-core backward kernels."""
    out = {}
    launched = _twin_launches(lambda: out.update(
        load_example("train_lm_torch").main(["--device", "cuda"])))
    lines = [line for line in out["lines"] if not line.startswith("[train]")]
    assert "".join(line + "\n" for line in lines[:2]) == \
        (EXAMPLE_REFERENCE / "train_lm.txt").read_text()
    assert out["losses"][-1][1] < out["losses"][0][1]
    assert launched["flash_attention"] > 0
    assert launched["flash_attention_bwd"] == launched["flash_bwd_mma"] > 0
