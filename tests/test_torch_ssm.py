"""The port's selective scans and Mamba layers held against the JAX package.

The same seeded numpy inputs go through ``repro`` (the jnp oracle, the
Pallas kernels in interpret mode, the model's ``mamba`` and
``mamba_decode``) and ``repro_torch`` (the plain PyTorch versions, which
the ``ops`` entry points take for CPU tensors, and the port's layers with
the reference's parameters carried over by ``from_reference``).

Tolerances: the scans 1e-4 (``tests/test_kernels.py``: fp32, sums in
another order); the layers 1e-4 with fp32 parameters and 2e-2 with bf16
(bf16 products round at other places in the two frameworks).

The CUDA kernels run only on the card: ``tests/test_torch_gpu.py`` holds
them against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels.selective_scan.fused import (  # noqa: E402
    selective_scan_fused as pallas_fused)
from repro.kernels.selective_scan.ops import (  # noqa: E402
    mamba_scan as pallas_mamba_scan)
from repro.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref as jax_scan_ref)
from repro.models import init_params  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.selective_scan import fused as fused_kernel  # noqa
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan as scan_kernel)
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_fused_ref, selective_scan_ref)
from repro_torch.models import from_reference, init_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

# the sweep of tests/test_kernels.py (b, t, di, n)
SHAPES = [(1, 64, 256, 8), (2, 128, 512, 16), (1, 256, 256, 4)]
# lengths and widths the Pallas kernels' divisibility asserts refuse
RAGGED = [(2, 37, 200, 16), (1, 1, 48, 8), (3, 70, 96, 5)]
TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.array(x, np.float32)


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


def _torch(*arrays, dev="cpu"):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _bx(dt, x, bm):
    """bx formed outside, in the fused kernel's order: (dt * x) * B."""
    return (dt * x)[..., None] * bm[:, :, None, :]


# ----------------------------------------------------------------------
# plain scans against the jnp oracle and the Pallas kernels
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,t,di,n", SHAPES + RAGGED)
def test_scan_ref_matches_reference(b, t, di, n):
    args = _scan_inputs(0, b, t, di, n)
    want = jax_scan_ref(*map(jnp.asarray, args))
    got = scan_ops.mamba_scan(*_torch(*args))
    assert got.dtype == torch.float32 and got.shape == (b, t, di)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("b,t,di,n", SHAPES)
def test_scan_ref_matches_pallas_kernel(b, t, di, n):
    args = _scan_inputs(1, b, t, di, n)
    want = pallas_mamba_scan(*map(jnp.asarray, args), interpret=True)
    got = selective_scan_ref(*_torch(*args))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("b,t,di,n", SHAPES)
def test_fused_ref_matches_pallas_kernel(b, t, di, n):
    args = _fused_inputs(2, b, t, di, n)
    want = pallas_fused(*map(jnp.asarray, args), interpret=True)
    got = scan_ops.selective_scan_fused(*_torch(*args))
    assert got.dtype == torch.float32 and got.shape == (b, t, di)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("b,t,di,n", SHAPES[:1] + RAGGED)
def test_fused_ref_matches_reference_with_bx_outside(b, t, di, n):
    dt, x, bm, c, a = _fused_inputs(3, b, t, di, n)
    want = jax_scan_ref(*map(jnp.asarray, (dt, _bx(dt, x, bm), c, a)))
    got = selective_scan_fused_ref(*_torch(dt, x, bm, c, a))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


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


EDGES = [(2, 40, 96, 16, "underflow"), (2, 40, 96, 16, "zero"),
         (2, 40, 96, 16, "zero_odd_steps"), (2, 40, 96, 1, "model"),
         (1, 33, 37, 5, "model"), (3, 17, 100, 8, "zero_odd_steps")]


@pytest.mark.parametrize("b,t,di,n,mode", EDGES)
def test_fused_ref_edges_match_reference(b, t, di, n, mode):
    """Decays all 0, all 1 or 1 on every other step, and N 1, 5, 8: the
    plain fused scan (the CPU entry point) against the jnp oracle given
    bx formed outside."""
    dt, x, bm, c, a = _edge_inputs(10, b, t, di, n, mode)
    want = jax_scan_ref(*map(jnp.asarray, (dt, _bx(dt, x, bm), c, a)))
    got = scan_ops.selective_scan_fused(*_torch(dt, x, bm, c, a))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if mode == "zero":
        assert not got.abs().max()          # h stays 0: bx = 0 every step
    if mode == "underflow":                 # h_t = bx_t exactly
        bx = _bx(dt, x, bm)
        np.testing.assert_allclose(
            _np(got), np.einsum("btdn,btn->btd", bx, c), **TOL)


@pytest.mark.parametrize("mode", ["underflow", "zero", "zero_odd_steps"])
def test_fused_ref_edges_match_pallas_kernel(mode):
    args = _edge_inputs(11, 1, 64, 256, 16, mode)
    want = pallas_fused(*map(jnp.asarray, args), interpret=True)
    got = selective_scan_fused_ref(*_torch(*args))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ----------------------------------------------------------------------
# the fused kernel's launch shape: a plain function of B, di, SMs
# ----------------------------------------------------------------------
H100_SMS = 132
# chip_smoke.py's phase 9 (b, t, di, n): the sweep, the models' widths,
# then the fused kernel's edges
PHASE9 = ([(1, 64, 256, 8), (2, 128, 512, 16), (1, 256, 256, 4)]
          + [(2, t, di, 16) for t in (1, 1000, 2048) for di in (3200, 8192)]
          + [(2, t, 3000, 16) for t in (1, 3, 4, 5, 7, 8, 9, 15, 16, 17,
                                        31, 32, 33)]
          + [(3, 70, 37, 16), (2, 40, 1000, 1), (2, 40, 1000, 5),
             (2, 40, 1000, 8), (2, 100, 1000, 16), (4, 48, 3208, 16),
             (1, 2048, 8192, 16)])


def _check_plan(p, b, di):
    assert p.lanes in fused_kernel.LANES
    assert p.channels * p.lanes == fused_kernel.THREADS
    assert p.channels % 4 == 0              # 16-byte copies of dt and x
    assert p.grid == (-(-di // p.channels), b)
    assert (p.grid[0] - 1) * p.channels < di <= p.grid[0] * p.channels
    assert 1 <= p.grid[1] <= scan_kernel.MAX_BATCH
    # two buffers of dt, x for the block's channels and B, C for 16
    # states, within the 48 KiB a block has without opting in
    assert p.smem_bytes == 4 * 2 * fused_kernel.CHUNK * (2 * p.channels
                                                         + 32)
    assert p.smem_bytes <= 48 * 1024


@pytest.mark.parametrize("b,t,di,n", PHASE9)
def test_fused_plan_for_phase9_shapes(b, t, di, n):
    p = fused_kernel.plan(b, di, H100_SMS)
    _check_plan(p, b, di)
    warps = b * di * p.lanes // 32
    if p.lanes == fused_kernel.LANES[0]:
        assert warps >= fused_kernel.WARPS_PER_SM * H100_SMS
    else:   # the fewest lanes did not reach WARPS_PER_SM an SM
        assert b * di * fused_kernel.LANES[0] // 32 < \
            fused_kernel.WARPS_PER_SM * H100_SMS
    for lanes in fused_kernel.LANES:        # what chip_smoke.py forces
        _check_plan(fused_kernel.shape(b, di, lanes), b, di)


@pytest.mark.parametrize("b,di,sms,lanes,grid", [
    (4, 8192, 132, 2, (128, 4)),        # Falcon-Mamba-7B's prefill
    (4, 3200, 132, 2, (50, 4)),         # Hymba-1.5B's prefill
    (1, 8192, 132, 4, (256, 1)),        # B 1 at Falcon's width
    (4, 3200, 264, 4, (100, 4)),        # a card with twice the SMs
    (1, 1, 132, 4, (1, 1))])
def test_fused_plan_model_shapes(b, di, sms, lanes, grid):
    p = fused_kernel.plan(b, di, sms)
    assert (p.lanes, p.grid) == (lanes, grid)
    _check_plan(p, b, di)


@pytest.mark.parametrize("b,di,lanes", [(1, 64, 1), (1, 64, 3), (1, 64, 8),
                                        (65536, 64, 2), (0, 64, 2),
                                        (1, 0, 4)])
def test_fused_shape_refuses(b, di, lanes):
    with pytest.raises(ValueError):
        fused_kernel.shape(b, di, lanes)


def test_fused_plan_refuses_past_the_grid():
    with pytest.raises(ValueError, match="rows"):
        fused_kernel.plan(scan_kernel.MAX_BATCH + 1, 64, H100_SMS)


# ----------------------------------------------------------------------
# v1's launch shape: a plain function of B, di, SMs
# ----------------------------------------------------------------------
def _check_v1_plan(p, b, di):
    assert p.channels % 8 == 0                  # whole warps, 32-byte
    assert p.threads == 4 * p.channels          # runs of dt; 4 lanes a
    assert p.threads <= scan_kernel.MAX_THREADS  # channel
    assert p.grid == (-(-di // p.channels), b)
    assert (p.grid[0] - 1) * p.channels < di <= p.grid[0] * p.channels
    assert 1 <= p.grid[1] <= scan_kernel.MAX_BATCH
    assert 1 <= p.stages <= scan_kernel.MAX_STAGES
    # the mbarriers, then per stage bx [4][channels][16], dt
    # [4][channels] and C [4][16] in fp32; within what a block may take
    # on an H100 (227 KiB)
    assert p.smem_bytes == 128 + p.stages * 4 * 4 * (p.channels * 17 + 16)
    assert p.smem_bytes <= 232448


@pytest.mark.parametrize("b,t,di,n", PHASE9)
def test_v1_plan_for_phase9_shapes(b, t, di, n):
    p = scan_kernel.plan(b, di, H100_SMS)
    _check_v1_plan(p, b, di)
    assert p.stages >= scan_kernel.MIN_STAGES
    # the blocks an SM runs at once fit its threads (64 registers each)
    # and shared memory with the plan's stages
    blocks = p.grid[0] * p.grid[1]
    resident = min(-(-blocks // H100_SMS), 1024 // p.threads)
    assert resident * p.threads <= 1024
    assert resident * (p.smem_bytes + 1024) <= 233472
    # no channels a block in CHANNELS gives the busiest SM fewer
    load = scan_kernel.busiest_sm(b, di, p.channels, H100_SMS)
    assert load == min(scan_kernel.busiest_sm(b, di, ch, H100_SMS)
                       for ch in scan_kernel.CHANNELS)
    for ch, st in ((8, 1), (40, 2), (256, 3)):  # what chip_smoke.py forces
        _check_v1_plan(scan_kernel.shape(b, di, ch, st), b, di)


@pytest.mark.parametrize("b,di,sms,channels,stages,grid", [
    (4, 8192, 132, 256, 3, (32, 4)),    # Falcon-Mamba-7B's prefill
    (4, 3200, 132, 104, 8, (31, 4)),    # Hymba-1.5B's prefill
    (1, 8192, 132, 64, 8, (128, 1)),    # B 1 at Falcon's width
    (4, 3200, 264, 56, 8, (58, 4)),     # a card with twice the SMs
    (1, 1, 132, 8, 8, (1, 1))])
def test_v1_plan_model_shapes(b, di, sms, channels, stages, grid):
    p = scan_kernel.plan(b, di, sms)
    assert (p.channels, p.stages, p.grid) == (channels, stages, grid)
    _check_v1_plan(p, b, di)


@pytest.mark.parametrize("b,di", [(4, 8192), (4, 3200)])
def test_v1_plan_balances_the_model_shapes(b, di):
    """On an H100 the busiest SM carries within 10% of the mean."""
    p = scan_kernel.plan(b, di, H100_SMS)
    assert scan_kernel.busiest_sm(b, di, p.channels, H100_SMS) <= \
        1.1 * b * di / H100_SMS


@pytest.mark.parametrize("b,di,channels,stages", [
    (1, 64, 0, 3), (1, 64, 4, 3), (1, 64, 12, 3), (1, 64, 264, 3),
    (1, 64, 8, 0),
    (1, 64, 8, 9), (1, 64, 256, 4), (65536, 64, 8, 3), (0, 64, 8, 3),
    (1, 0, 8, 3)])
def test_v1_shape_refuses(b, di, channels, stages):
    with pytest.raises(ValueError):
        scan_kernel.shape(b, di, channels, stages)


# ----------------------------------------------------------------------
# the CUDA wrappers take CUDA tensors only; the entry points CUDA or CPU
# ----------------------------------------------------------------------
def test_kernel_wrappers_refuse_cpu_tensors():
    dt, bx, c, a = _torch(*_scan_inputs(4, 1, 8, 32, 4))
    with pytest.raises(ValueError, match="CUDA kernel"):
        scan_kernel.selective_scan(dt, bx, c, a)
    dt, x, bm, c, a = _torch(*_fused_inputs(4, 1, 8, 32, 4))
    with pytest.raises(ValueError, match="CUDA kernel"):
        fused_kernel.selective_scan_fused(dt, x, bm, c, a)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fused_kernel.selective_scan_fused_bwd(dt, x, bm, c, a, x)
    assert scan_kernel.launches == {"selective_scan": 0}
    assert fused_kernel.launches == {"selective_scan_fused": 0,
                                     "selective_scan_fused_bwd": 0}


def test_entry_points_refuse_other_devices():
    dt, bx, c, a = (t.to("meta") for t in
                    _torch(*_scan_inputs(5, 1, 4, 8, 4)))
    with pytest.raises(ValueError, match="no selective scan"):
        scan_ops.mamba_scan(dt, bx, c, a)
    with pytest.raises(ValueError, match="no selective scan"):
        scan_ops.selective_scan_fused(dt, dt, c, c, a)


# ----------------------------------------------------------------------
# Mamba layers against the reference's
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def falcon_smoke():
    cfg = ref_get_config("falcon-mamba-7b").smoke()
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                  cfg))
    return cfg, params


def _cast(params, dtype: str):
    if dtype == "bfloat16":
        return params
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _layer0(params):
    return jax.tree.map(lambda a: jnp.asarray(a[0]),
                        params["layers"]["ssm"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 37, 64])
def test_mamba_matches_reference(falcon_smoke, dtype, t):
    cfg, params = falcon_smoke
    params = _cast(params, dtype)
    model = from_reference(get_config(cfg.name), params, device="cpu")
    x = np.random.default_rng(6).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = RL.mamba(_layer0(params), cfg, jx)
    got = L.mamba(model.layers[0].ssm, get_config(cfg.name),
                  torch.from_numpy(_np(jx)).to(getattr(torch, dtype)))
    assert str(got.dtype).endswith(str(want.dtype))
    np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)),
                               **LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_reference(falcon_smoke, dtype):
    """Three steps from random states; the conv state comes in bf16, as
    ``init_caches`` makes it, and leaves in the promoted dtype."""
    cfg, params = falcon_smoke
    params = _cast(params, dtype)
    model = from_reference(get_config(cfg.name), params, device="cpu")
    rng = np.random.default_rng(7)
    conv = jnp.asarray(rng.standard_normal(
        (2, cfg.ssm_conv - 1, cfg.d_inner_)), jnp.bfloat16)
    ssm = jnp.asarray(rng.standard_normal(
        (2, cfg.d_inner_, cfg.ssm_state)), jnp.float32)
    tconv, tssm = torch.from_numpy(_np(conv)).bfloat16(), \
        torch.from_numpy(_np(ssm))
    p = _layer0(params)
    for _ in range(3):
        x = jnp.asarray(rng.standard_normal((2, 1, cfg.d_model)),
                        jnp.dtype(dtype))
        want, conv, ssm = RL.mamba_decode(p, cfg, x, conv, ssm)
        got, tconv, tssm = L.mamba_decode(
            model.layers[0].ssm, get_config(cfg.name),
            torch.from_numpy(_np(x)).to(getattr(torch, dtype)), tconv, tssm)
        assert str(tconv.dtype).endswith(str(conv.dtype))
        assert tssm.dtype == torch.float32
        for g, w in ((got, want), (tconv, conv), (tssm, ssm)):
            np.testing.assert_allclose(_np(g), _np(w.astype(jnp.float32)),
                                       **LAYER_TOL[dtype])


def test_fp32_leaves_stay_fp32(falcon_smoke):
    """``A_log`` and ``D`` are fp32 in the reference; ``from_reference``
    and ``init_model`` keep them so while the rest is bf16."""
    cfg, params = falcon_smoke
    port_cfg = get_config(cfg.name)
    for model in (from_reference(port_cfg, params, device="cpu"),
                  init_model(port_cfg, device="cpu")):
        for name, p in model.named_parameters():
            want = torch.float32 if name.split(".")[-1] in ("A_log", "D") \
                else torch.bfloat16
            assert p.dtype == want, name
    ref = _layer0(params)
    got = from_reference(port_cfg, params, device="cpu").layers[0].ssm
    np.testing.assert_array_equal(_np(got.A_log), np.asarray(ref["A_log"]))
    # drawn by the port itself: log(1..N) to within one fp32 rounding
    np.testing.assert_allclose(_np(init_model(port_cfg, device="cpu")
                                   .layers[1].ssm.A_log),
                               np.asarray(ref["A_log"]), rtol=1e-7)
