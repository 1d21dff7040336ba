"""The port's selective scans and Mamba layers held against the JAX package.

The same seeded numpy inputs go through ``repro`` (the jnp oracle, the
Pallas kernels in interpret mode, the model's ``mamba`` and
``mamba_decode``) and ``repro_torch`` (the plain PyTorch versions, which
the ``ops`` entry points take for CPU tensors, and the port's layers with
the reference's parameters carried over by ``from_reference``).

Tolerances: the scans 1e-4 (``tests/test_kernels.py``: fp32, sums in
another order); the layers 1e-4 with fp32 parameters and 2e-2 with bf16
(bf16 products round at other places in the two frameworks).

The CUDA kernels run only on the card: the ``gpu`` tests decide inside
their fixture whether a card and ``nvcc`` are present, and skip here.
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
from repro_torch.kernels import _build  # noqa: E402
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
    assert scan_kernel.launches == {"selective_scan": 0}
    assert fused_kernel.launches == {"selective_scan_fused": 0}


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


# ----------------------------------------------------------------------
# on the card: each kernel against its plain version
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device with the scan library built, or a skip with the
    reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        _build.nvcc_path()
    except RuntimeError as err:
        pytest.skip(str(err))
    scan_kernel.load()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,di,n", SHAPES + RAGGED + [(2, 1000, 3200, 16)])
def test_scan_kernels_match_plain(card, b, t, di, n):
    dt, bx, c, a = _torch(*_scan_inputs(8, b, t, di, n), dev=card)
    got = scan_kernel.selective_scan(dt, bx, c, a)
    np.testing.assert_allclose(_np(got), _np(selective_scan_ref(dt, bx, c,
                                                                a)), **TOL)
    dt, x, bm, c, a = _torch(*_fused_inputs(9, b, t, di, n), dev=card)
    got = fused_kernel.selective_scan_fused(dt, x, bm, c, a)
    want = selective_scan_fused_ref(dt, x, bm, c, a)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(
        _np(got), _np(scan_kernel.selective_scan(dt, _bx(dt, x, bm), c, a)),
        **TOL)
