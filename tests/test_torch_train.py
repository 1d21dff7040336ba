"""The port's training stack held against the JAX package.

``make_train_step`` of ``repro_torch`` against ``repro``'s on the smoke
configs of ``qwen3-1.7b`` (dense), ``falcon-mamba-7b`` (ssm) and
``hymba-1.5b`` (hybrid) here, and through ``check_train_step`` on the
moe, encdec and vlm families in tests/test_torch_moe.py, from the reference's
``init_state`` with fp32 parameters carried over by
``state_from_reference``, on the same batch: loss, grad norm and learning
rate within 1e-4 relative; the moments within 1e-4 of each tensor's
largest (the gradients); the masters within 1e-4 of each tensor's largest
against the reference's AdamW given the port's gradients, and the new
parameters bf16 everywhere (``A_log`` and ``D`` included) within one bf16
ulp of the reference's.  The masters are held given the same gradients
because AdamW's first step maps a gradient g to about g / (|g| + 1e-8):
a gradient near 1e-8, where the two frameworks' sums in another order
differ in the last bits, moves its master by up to the learning rate
(an element of ``conv_b`` whose gradient is 6e-8 moved by 0.6% of that
tensor's largest); the moments hold the gradients themselves to 1e-4.

Also: the pieces (``_pick_chunks``, ``cosine_schedule``, ``global_norm``,
the data pipeline, byte for byte), the two autograd ``Function``s'
gradients against the reference's custom VJP and chunked scan, the
checkpoint layout across the packages, and ``train_loop``'s kill and
resume.  On the CPU the port's steps take the kernels' plain versions;
the card run (``chip_smoke.py`` phases 13-14) holds the kernels' path.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.config import ParallelConfig as RefParallel  # noqa: E402
from repro.config import TrainConfig as RefTrain  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as ref_flash)
from repro.models import layers as RL  # noqa: E402
from repro.models import steps as RS  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_fused_ref, ssm_scan_chunked)
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import steps as S  # noqa: E402
from repro_torch.models.convert import (reference_leaf,  # noqa: E402
                                        stack_layers, state_from_reference)
from repro_torch.optim import adamw  # noqa: E402
from test_torch_models import _ref_dtype  # noqa: E402

ARCHS = ["qwen3-1.7b", "falcon-mamba-7b", "hymba-1.5b"]
B, SEQ = 4, 24            # SEQ > the hybrid smoke window of 16
TC = dict(total_steps=10, warmup_steps=2)
TOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if got.size else 0.0
    return err / scale if scale else err


@functools.lru_cache(maxsize=None)
def _ref_state(arch: str):
    """(reference smoke cfg, its fresh train state with fp32 parameters,
    numpy leaves)."""
    cfg = ref_get_config(arch).smoke()
    st = RS.init_state(jax.random.PRNGKey(0), cfg)
    return cfg, {"params": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        st["params"]),
                 "opt": jax.tree.map(np.array, st["opt"])}


def _batch(cfg, seed: int = 0):
    """(jnp batch, torch batch) of the same arrays: tokens and targets,
    and an encdec model's ``frames`` or a vlm's ``vision_embeds`` (fp32)."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ)),
              "targets": rng.integers(0, cfg.vocab_size, (B, SEQ))}
    arrays = {k: v.astype(np.int32) for k, v in arrays.items()}
    if cfg.encoder_layers:
        arrays["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_prefix:
        arrays["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


@functools.lru_cache(maxsize=None)
def _ref_train_step(cfg, accum: int, remat: bool = True):
    return jax.jit(RS.make_train_step(
        cfg, RefTrain(**TC), RefParallel(seq_shard_activations=False,
                                         grad_accum=accum, remat=remat)))


def _port(arch: str):
    cfg, st = _ref_state(arch)
    tcfg = get_config(cfg.name)
    return tcfg, state_from_reference(tcfg, st, device="cpu")


def _port_grads(tcfg, state, batch, accum: int):
    """The port's gradients of its loss (micro-batched as the train step
    does), by parameter name, fp32."""
    loss_fn = S.make_loss_fn(tcfg, ParallelConfig(grad_accum=accum))
    names, params = zip(*state["model"].named_parameters())
    n = accum
    acc = [torch.zeros(p.shape) for p in params]
    for i in range(n):
        sl = slice(i * B // n, (i + 1) * B // n)
        loss = loss_fn(state["model"], {k: v[sl] for k, v in batch.items()})
        for a, g in zip(acc, torch.autograd.grad(loss, params,
                                                 allow_unused=True)):
            if g is not None:           # the ssm family's unused norms
                a.add_(g.float() / n)
    return dict(zip(names, acc))


def _bf16_ulps(got: torch.Tensor, want) -> int:
    """Largest distance in bf16 steps between two bf16 arrays (same-sign
    values: the distance of their bit patterns)."""
    a = got.detach().view(torch.int16).numpy().astype(np.int64)
    b = torch.from_numpy(np.asarray(want, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
    # map sign-magnitude to a monotone integer line
    a = np.where(a < 0, -32768 - a, a)
    b = np.where(b < 0, -32768 - b, b)
    return int(np.abs(a - b).max())


# ----------------------------------------------------------------------
# the train step against the reference's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, accum):
    check_train_step(arch, accum)


def check_train_step(arch: str, accum: int) -> None:
    """One train step of each package from the same state and batch, then
    a second on the bf16 parameters the first left (see the module's
    docstring for what is held and how closely)."""
    cfg, st = _ref_state(arch)
    rb, tb = _batch(cfg)
    step = _ref_train_step(cfg, accum)
    with _ref_dtype(st["params"]):
        rs1, rm1 = step(jax.tree.map(jnp.asarray, st), rb)
    tcfg, ps = _port(arch)
    grads = _port_grads(tcfg, ps, tb, accum)
    tstep = S.make_train_step(tcfg, TrainConfig(**TC),
                              ParallelConfig(grad_accum=accum))
    ps1, pm1 = tstep(ps, tb)
    for k in ("loss", "grad_norm", "lr"):
        assert pm1[k].dtype == torch.float32
        assert abs(float(pm1[k]) - float(rm1[k])) \
            <= TOL * abs(float(rm1[k])), (k, float(pm1[k]), float(rm1[k]))
    assert int(ps1["opt"].step) == int(rs1["opt"].step) == 1
    # the moments hold the gradients: within 1e-4 of each tensor's largest
    for field in ("mu", "nu"):
        for name, t in getattr(ps1["opt"], field).items():
            want = reference_leaf(getattr(rs1["opt"], field), name)
            assert _rel(t, want) <= TOL, (field, name)
    # the masters: the reference's AdamW given the port's gradients
    stacked = stack_layers((n, _np(g)) for n, g in grads.items())
    ref_grads = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(stacked[_path(path)]), st["params"])
    _, ropt, om = ref_adamw.update(
        ref_grads, jax.tree.map(jnp.asarray, st["opt"]), RefTrain(**TC))
    assert abs(float(om["grad_norm"]) - float(pm1["grad_norm"])) \
        <= TOL * float(om["grad_norm"])
    for name, t in ps1["opt"].master.items():
        assert _rel(t, reference_leaf(ropt.master, name)) <= TOL, name
    # every parameter bf16, within one bf16 ulp of the reference's
    for name, p in ps1["model"].named_parameters():
        assert p.dtype == torch.bfloat16, name
        want = reference_leaf(rs1["params"], name)
        assert str(want.dtype) == "bfloat16", name
        assert _bf16_ulps(p, want) <= 1, name
    # a second step, now on bf16 parameters (A_log, D and the router
    # included)
    with _ref_dtype(rs1["params"]):
        _, rm2 = step(rs1, rb)
    _, pm2 = tstep(ps1, tb)
    assert abs(float(pm2["loss"]) - float(rm2["loss"])) \
        <= 2e-2 * abs(float(rm2["loss"]))



def _path(path) -> str:
    """A jax tree path as the "/"-joined string the checkpoints use."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch):
    """Per-layer checkpointing recomputes the same operations: the loss
    and every gradient as without it."""
    tcfg, ps = _port(arch)
    _, tb = _batch(get_config(arch).smoke())
    names, params = zip(*ps["model"].named_parameters())
    out = []
    for remat in (True, False):
        loss = S.make_loss_fn(tcfg, ParallelConfig(remat=remat))(
            ps["model"], tb)
        out.append((loss, torch.autograd.grad(loss, params,
                                              allow_unused=True)))
    (l1, g1), (l0, g0) = out
    assert float(l1.detach()) == float(l0.detach())
    for name, a, b in zip(names, g1, g0):
        assert (a is None) == (b is None), name
        if a is not None:
            assert _rel(a, b) <= 1e-6, name


# ----------------------------------------------------------------------
# the pieces
# ----------------------------------------------------------------------
def test_pick_chunks_matches_reference():
    got = [S._pick_chunks(s) for s in range(1, 4097)]
    assert got == [RS._pick_chunks(s) for s in range(1, 4097)]


@pytest.mark.parametrize("warmup,total", [(2, 10), (100, 1000), (0, 1)])
def test_cosine_schedule_matches_reference(warmup, total):
    steps = np.arange(0, total + 3, dtype=np.int32)
    want = np.asarray(jax.vmap(ref_adamw.cosine_schedule(
        RefTrain(warmup_steps=warmup, total_steps=total)))(
            jnp.asarray(steps)))
    lr = adamw.cosine_schedule(TrainConfig(warmup_steps=warmup,
                                           total_steps=total))
    got = np.array([float(lr(torch.tensor(s))) for s in steps])
    assert lr(torch.tensor(3)).dtype == torch.float32
    # relative to the peak: near the end 1 + cos(pi * prog) cancels, and
    # one ulp of cos there (torch's against XLA's) is ~1e-5 of the value
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((3, 5), (7,), (2, 3, 4), ())]
    want = float(ref_adamw.global_norm([jnp.asarray(a) for a in arrays]))
    got = adamw.global_norm([torch.from_numpy(a) for a in arrays])
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want
    bf = adamw.global_norm([torch.from_numpy(a).bfloat16() for a in arrays])
    assert bf.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_synthetic_batches_byte_identical(seed):
    ref = ref_pipeline.SyntheticLM(1000, 3, 17, seed=seed)
    port = pipeline.SyntheticLM(1000, 3, 17, seed=seed)
    for step in (0, 1, 7, 2**20):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == set(want) == {"tokens", "targets"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_file_tokens_byte_identical(tmp_path, seed):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(4).integers(0, 50000, 4001).astype(
        np.uint16).tofile(path)
    ref = ref_pipeline.FileTokens(str(path), 4, 33, seed=seed)
    port = pipeline.FileTokens(str(path), 4, 33, seed=seed)
    for step in (0, 3, 99):
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()


def test_prefetcher_keeps_order():
    data = pipeline.SyntheticLM(500, 2, 9, seed=1)
    it = pipeline.Prefetcher(data.iter_from(5), depth=2)
    try:
        for step in range(5, 15):
            assert next(it)["tokens"].tobytes() \
                == data.batch_at(step)["tokens"].tobytes()
    finally:
        it.close()


# ----------------------------------------------------------------------
# the autograd Functions around the kernels
# ----------------------------------------------------------------------
MASKS = [(True, None), (False, None), (True, 64)]


@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_function_grads_match_reference_vjp(causal, window):
    """q, k and v gradients of the port's ``flash_attention`` against
    ``jax.grad`` through the reference's custom-VJP flash attention (the
    Pallas forward in interpret mode), as tests/test_kernels.py holds the
    reference against its own oracle; fp32 within 1e-4."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64)))
    w = rng.standard_normal((1, 4, 128, 64)).astype(np.float32)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(
        ref_flash(q_, k_, v_, causal, window, True) * w),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_ops.flash_attention(tq, tk, tv, causal, window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(w))
    for name, g, r in zip("qkv", got, want):
        assert _rel(g, r) <= TOL, name


def _scan_inputs(seed, b, t, di, n):
    rng = np.random.default_rng(seed)
    dt = (0.01 + 0.2 * rng.random((b, t, di))).astype(np.float32)
    x = rng.standard_normal((b, t, di)).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    c = rng.standard_normal((b, t, n)).astype(np.float32)
    a = -np.exp(np.log(np.arange(1, n + 1, dtype=np.float32)))[None] \
        .repeat(di, 0)
    a = (a * (0.5 + rng.random((di, n)))).astype(np.float32)
    w = rng.standard_normal((b, t, di)).astype(np.float32)
    return (dt, x, bm, c, a), w


@pytest.mark.parametrize("t,chunk", [(24, 6), (21, 7), (40, 40), (36, 12)])
def test_ssm_scan_chunked_matches_reference(t, chunk):
    """Values and the gradients of dt, x, B, C and A against the
    reference's ``_ssm_scan_chunked`` under ``jax.vjp`` at chunks that are
    no power of two (the associative scan's ragged steps)."""
    args, w = _scan_inputs(1, 2, t, 8, 4)

    def ref(dt, x, bm, c, a):
        bx = (dt * x)[..., None] * bm[:, :, None, :]
        return RL._ssm_scan_chunked(dt, a, bx, c, chunk)
    want, vjp = jax.vjp(ref, *map(jnp.asarray, args))
    want_g = vjp(jnp.asarray(w))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = ssm_scan_chunked(*targs, chunk=chunk)
    assert _rel(got, want) <= TOL
    got_g = torch.autograd.grad(got, targs, torch.from_numpy(w))
    for name, g, r in zip(("dt", "x", "B", "C", "A"), got_g, want_g):
        assert _rel(g, r) <= TOL, name


@pytest.mark.parametrize("t,chunk", [(13, 5), (9, 128), (1, 4)])
def test_fused_function_grads_match_plain_autograd(t, chunk, monkeypatch):
    """The fused scan's ``Function`` (forward the sequential plain version
    on the CPU, backward through ``ssm_scan_chunked``) against autograd
    through ``selective_scan_fused_ref``'s T-step loop at a tiny T, an
    oracle independent of the chunked scan; a last chunk shorter than the
    rest included."""
    monkeypatch.setattr(scan_ops, "ssm_scan_chunked",
                        functools.partial(ssm_scan_chunked, chunk=chunk))
    args, w = _scan_inputs(2, 2, t, 6, 3)
    ref_in = [torch.from_numpy(a).requires_grad_() for a in args]
    want = selective_scan_fused_ref(*ref_in)
    want_g = torch.autograd.grad(want, ref_in, torch.from_numpy(w))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = scan_ops.selective_scan_fused(*targs)
    assert type(got.grad_fn).__name__ == "SelectiveScanFusedBackward"
    assert torch.equal(got, want.detach())
    got_g = torch.autograd.grad(got, targs, torch.from_numpy(w))
    for name, g, r in zip(("dt", "x", "B", "C", "A"), got_g, want_g):
        assert _rel(g, r) <= TOL, name


def test_model_layers_take_the_functions():
    """Under autograd the model's attention and scan outputs are the
    Functions' (hybrid smoke: both in one layer)."""
    tcfg, ps = _port("hymba-1.5b")
    _, tb = _batch(get_config("hymba-1.5b").smoke())
    seen = []
    orig = (flash_ops.flash_attention, scan_ops.selective_scan_fused)

    def flash(*a, **kw):
        out = orig[0](*a, **kw)
        seen.append(type(out.grad_fn).__name__)
        return out

    def scan(*a):
        out = orig[1](*a)
        seen.append(type(out.grad_fn).__name__)
        return out
    try:
        flash_ops.flash_attention, scan_ops.selective_scan_fused = flash, scan
        S.make_loss_fn(tcfg, ParallelConfig(remat=False))(ps["model"], tb)
    finally:
        flash_ops.flash_attention, scan_ops.selective_scan_fused = orig
    assert seen == ["FlashAttentionBackward",
                    "SelectiveScanFusedBackward"] * tcfg.num_layers


# ----------------------------------------------------------------------
# checkpoints across the packages
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _stepped(arch: str):
    """The reference's state after one train step (bf16 parameters, A_log
    and D included), numpy leaves."""
    cfg, st = _ref_state(arch)
    with _ref_dtype(st["params"]):
        rs1, _ = _ref_train_step(cfg, 1)(jax.tree.map(jnp.asarray, st),
                                         _batch(cfg)[0])
    return cfg, jax.tree.map(np.asarray, rs1)


def _files(d):
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as data:
        return manifest, {k: data[k] for k in data.files}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen3-1.7b"])
def test_checkpoint_files_match_reference(tmp_path, arch):
    check_checkpoint_files(tmp_path, arch)


def check_checkpoint_files(tmp_path, arch: str) -> None:
    """The same state saved by each package: the same manifest (keys in
    the same order, shapes, dtype names) and byte-equal npz arrays."""
    cfg, rs1 = _stepped(arch)
    ref_ckpt.save(rs1, 1, str(tmp_path / "ref"))
    ckpt.save(state_from_reference(get_config(cfg.name), rs1, "cpu"), 1,
              str(tmp_path / "port"))
    rm, ra = _files(tmp_path / "ref" / "step_1")
    pm, pa = _files(tmp_path / "port" / "step_1")
    assert list(pm["leaves"]) == list(rm["leaves"])
    assert pm == rm
    assert list(pa) == list(ra)
    for k in ra:
        assert pa[k].dtype == ra[k].dtype and pa[k].tobytes() \
            == ra[k].tobytes(), k
    if cfg.has_ssm:
        assert rm["leaves"]["params/layers/ssm/A_log"]["dtype"] \
            == "bfloat16"


def test_checkpoints_restore_across_packages(tmp_path):
    check_restore_across_packages(tmp_path, "hymba-1.5b")


def check_restore_across_packages(tmp_path, arch: str) -> None:
    """The port's checkpoint restores in the reference and the
    reference's in the port, each into a fresh state's structure: every
    leaf byte-equal to the saved values after widening, cast to the fresh
    dtypes (A_log and D, and the MoE router, back to fp32 in both)."""
    cfg, rs1 = _stepped(arch)
    tcfg = get_config(cfg.name)
    ps1 = state_from_reference(tcfg, rs1, "cpu")
    ckpt.save(ps1, 1, str(tmp_path / "port"))
    ref_ckpt.save(rs1, 1, str(tmp_path / "ref"))
    got_ref, step = ref_ckpt.restore(RS.state_shapes(cfg),
                                     str(tmp_path / "port"))
    assert step == 1
    want_ref, _ = ref_ckpt.restore(RS.state_shapes(cfg),
                                   str(tmp_path / "ref"))
    fp32 = [("ssm", "A_log")] if cfg.has_ssm else [("moe", "router")] \
        if cfg.is_moe else []
    for block, leaf in fp32:
        assert got_ref["params"]["layers"][block][leaf].dtype == jnp.float32
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_ref),
                            jax.tree.leaves(want_ref)):
        assert g.dtype == w.dtype and np.asarray(g).tobytes() \
            == np.asarray(w).tobytes(), _path(path)
    got, step = ckpt.restore(S.state_shapes(tcfg), str(tmp_path / "ref"),
                             device="cpu")
    assert step == 1
    fresh = S.state_shapes(tcfg)
    for (name, p), (_, f) in zip(got["model"].named_parameters(),
                                 fresh["model"].named_parameters()):
        assert p.dtype == f.dtype and p.device.type == "cpu", name
        want = np.asarray(reference_leaf(rs1["params"], name), np.float32)
        assert p.float().detach().numpy().tobytes() == want.tobytes(), name
    for block, leaf in fp32:
        assert getattr(getattr(got["model"].layers[0], block),
                       leaf).dtype == torch.float32
    assert int(got["opt"].step) == 1
    assert got["opt"].step.dtype == torch.int32
    for field in ("master", "mu", "nu"):
        for name, t in getattr(got["opt"], field).items():
            want = reference_leaf(getattr(rs1["opt"], field), name)
            assert t.dtype == torch.float32
            assert t.numpy().tobytes() == np.asarray(want).tobytes(), name


def test_checkpoint_housekeeping(tmp_path):
    """Atomic publish, keep_last pruning, latest_step, save_async, and a
    shape mismatch refused."""
    tcfg = get_config("qwen3-1.7b").smoke()
    state = S.init_state(tcfg, seed=1, device="cpu")
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(S.state_shapes(tcfg), d, device="cpu")
    for step in (1, 2, 3):
        ckpt.save(state, step, d, keep_last=2)
    ckpt.save_async(state, 4, d, keep_last=2).join(timeout=60)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3", "step_4"]
    assert ckpt.latest_step(d) == 4
    got, step = ckpt.restore(S.state_shapes(tcfg), d, device="cpu")
    assert step == 4
    for (name, p), (_, q) in zip(got["model"].named_parameters(),
                                 state["model"].named_parameters()):
        assert torch.equal(p, q), name
    with pytest.raises(ValueError, match="needs a device"):
        ckpt.restore(S.state_shapes(tcfg), d)
    other = dataclasses.replace(tcfg, d_model=32)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(S.state_shapes(other), d, device="cpu")


# ----------------------------------------------------------------------
# the train loop
# ----------------------------------------------------------------------
def _tiny():
    """tests/test_e2e_train.py's model."""
    return dataclasses.replace(
        get_config("qwen3-1.7b").smoke(), name="tiny", num_layers=2,
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=512)


def _quiet(*_):
    pass


def test_train_loop_kill_and_resume(tmp_path):
    """An injected failure restarts from the latest checkpoint, and the
    resumed run ends where the uninterrupted one does: the data stream is
    (seed, step)-indexed and a checkpoint holds the state exactly."""
    kw = dict(steps=12, batch=2, seq=16, device="cpu", log=_quiet,
              log_every=1)
    out = train_loop(_tiny(), ckpt_dir=str(tmp_path), save_every=4,
                     fail_at=6, **kw)
    assert out["restarts"] == 1
    assert out["final_step"] == 12
    assert any("restored at 4" in e for e in out["events"])
    assert ckpt.latest_step(str(tmp_path)) == 12
    plain = train_loop(_tiny(), **kw)
    assert dict(out["losses"]) == dict(plain["losses"])
    for (name, p), (_, q) in zip(out["state"]["model"].named_parameters(),
                                 plain["state"]["model"].named_parameters()):
        assert torch.equal(p, q), name
    resumed = train_loop(_tiny(), ckpt_dir=str(tmp_path), **dict(kw,
                                                                steps=14))
    assert [s for s, _ in resumed["losses"]] == [13, 14]


def test_train_loop_refuses_model_parallel():
    """Without a process group ``model_parallel > 1`` raises: the loop
    never falls back to one device."""
    with pytest.raises(RuntimeError, match="needs a process group"):
        train_loop(_tiny(), steps=1, batch=2, seq=8, model_parallel=2,
                   device="cpu")


def test_grad_accum_equivalent_loss_scale():
    """tests/test_e2e_train.py's check on the port: the same data and
    init, micro-batched, give about the full batch's loss."""
    cfg = _tiny()
    out1 = train_loop(cfg, steps=20, batch=8, seq=32, device="cpu",
                      log=_quiet)
    out2 = train_loop(cfg, steps=20, batch=8, seq=32, device="cpu",
                      log=_quiet,
                      parallel=ParallelConfig(seq_shard_activations=False,
                                              grad_accum=4))
    l1, l2 = dict(out1["losses"]), dict(out2["losses"])
    assert abs(l1[10] - l2[10]) < 0.2


@pytest.mark.slow
def test_loss_decreases():
    out = train_loop(_tiny(), steps=150, batch=8, seq=64, device="cpu",
                     tc=TrainConfig(learning_rate=1e-3, warmup_steps=10,
                                    total_steps=150), log=_quiet)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    assert last < first - 0.3, f"loss should drop: {first} -> {last}"
