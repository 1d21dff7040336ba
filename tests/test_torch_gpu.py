"""The port's CUDA kernels held against its own plain versions, on a card.

Every test here needs a CUDA card and ``nvcc``: each carries the ``gpu``
marker and skips, with the reason, where either is missing.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
a card and no JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

The plain versions are held against the JAX package on the CPU by the
other ``tests/test_torch_*.py`` files; here each kernel is held against
its plain version on the same seeded inputs: the Bloom probes bit for bit,
attention within fp32 2e-5 / bf16 2e-2, the scans within 1e-4, and a
store on the card publishes the CPU store's rows byte for byte.
"""
import json

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
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention as paged_kernel)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref)
from repro_torch.kernels.selective_scan import fused as fused_kernel  # noqa
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan as scan_kernel)
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_fused_ref, selective_scan_ref)
from repro_torch.lsm import filters  # noqa: E402
from repro_torch.zoned.device import MiB  # noqa: E402

ATTN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_SHAPES = [(1, 4, 4, 256, 64), (2, 8, 2, 512, 64), (1, 8, 1, 256, 128)]
MASKS = [(True, None), (False, None), (True, 64)]
PAGED_SHAPES = [(2, 4, 2, 16, 16, 4, 64), (3, 2, 4, 32, 8, 8, 128),
                (1, 1, 8, 8, 16, 2, 64)]
# Hymba-1.5B's prefill: B 4, 25 / 5 heads, S 2,048, D 64
HYMBA_FLASH = (4, 25, 5, 2048, 64)
# scans (b, t, di, n): the sweep of tests/test_kernels.py, lengths and
# widths the Pallas kernels refuse, and the fused kernel's edges
SCAN_SHAPES = [(1, 64, 256, 8), (2, 128, 512, 16), (1, 256, 256, 4)]
RAGGED = [(2, 37, 200, 16), (1, 1, 48, 8), (3, 70, 96, 5)]
EDGES = [(2, 40, 96, 16, "underflow"), (2, 40, 96, 16, "zero"),
         (2, 40, 96, 16, "zero_odd_steps"), (2, 40, 96, 1, "model"),
         (1, 33, 37, 5, "model"), (3, 17, 100, 8, "zero_odd_steps")]
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
                                                       HYMBA_FLASH])
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


@pytest.mark.gpu
@pytest.mark.parametrize("b,kv,g,pages,ps,mp,d",
                         PAGED_SHAPES + [(1, 8, 2, 512, 16, 80, 128)])
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
def test_paged_kernel_matches_plain(card, b, kv, g, pages, ps, mp, d, dtype):
    rng = np.random.default_rng(8)
    q, kp, vp = [_randn(rng, shape, dtype).to(card)
                 for shape in ((b, kv * g, d), (pages, ps, kv, d),
                               (pages, ps, kv, d))]
    tables = torch.from_numpy(
        rng.integers(0, pages, (b, mp)).astype(np.int32)).to(card)
    lens = torch.from_numpy(
        rng.integers(1, mp * ps, (b,)).astype(np.int32)).to(card)
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
