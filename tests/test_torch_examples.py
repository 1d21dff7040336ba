"""The port's four example twins (``examples/*_torch.py``) held against the
reference's examples on the CPU.

* quickstart and ycsb_demo ``--quick``: the reference example, run in
  this process, prints the lines stored in ``tests/data/examples_reference``
  byte for byte, and so does the twin (every figure is simulated); the
  full demo likewise under ``-m slow`` (~1 min for the reference, ~2-3
  for the twin); ``chip_smoke.py`` phase 21 holds the card's lines
  against these files.
* serve_paged on the reference's ``init_params(PRNGKey(0))`` carried over
  by ``models.convert.from_reference`` (bf16): the engine's stats and
  each request's generated tokens equal the reference engine's at the
  example's settings, on the first 4 requests; all 12 through the
  reference example itself (~80 s) under ``-m slow``.
* train_lm: the reference example's model line and restarts line at each
  size (its loop cut to the smoke width: the drill's steps, checkpoints
  and failure are the example's) stored in ``train_lm*.txt``; the twin's
  sizes equal the example's; the twin at 16 steps against the
  reference's ``train_loop`` at the same settings: restarts, events, final
  step and logged steps equal, and the loss falls.  The reference runs on
  a one-device mesh with ``AxisType.Auto`` axes, as
  ``tests/test_torch_train_sharded.py`` gives it Auto axes: this JAX's
  explicit axes make its embedding gather raise.
* each twin raises without a card at its default ``--device cuda``.
"""
import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import AxisType  # noqa: E402

import repro.launch.train as ref_train  # noqa: E402
import repro.serving as ref_serving  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_kernel)
from repro_torch.models import from_reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
try:
    # examples/<name>.py as a fresh module; printed lines without the
    # wall-clock tokens a second
    from chip_smoke import load_example as load, wall_free  # noqa: E402
finally:
    sys.path.remove(str(ROOT))
REFERENCE = ROOT / "tests" / "data" / "examples_reference"
# (example, argv, file of the reference's lines)
STORE_EXAMPLES = [("quickstart", [], "quickstart.txt"),
                  ("ycsb_demo", ["--quick"], "ycsb_demo_quick.txt"),
                  pytest.param("ycsb_demo", [], "ycsb_demo.txt",
                               marks=pytest.mark.slow)]
TRAIN_SIZES = [([], "train_lm.txt"), (["--full"], "train_lm_full.txt")]
TWIN_STEPS, TWIN_BATCH, TWIN_SEQ = 16, 2, 32


def run_reference(monkeypatch, name: str, argv: list, patch=None) -> str:
    """What the reference example prints, run in this process with
    ``argv`` (``patch(mod)`` may replace a name in it first)."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    mod = load(name)
    if patch is not None:
        patch(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def one_device_mesh(monkeypatch) -> None:
    """The reference's train loop on a (1, 1) mesh of the first device
    with ``AxisType.Auto`` axes: the local mesh of a host with one device,
    whatever device count an earlier test in this process forced."""
    monkeypatch.setattr(ref_train, "make_local_mesh", lambda mp=1:
                        jax.make_mesh((1, mp), ("data", "model"),
                                      devices=jax.devices()[:mp],
                                      axis_types=(AxisType.Auto,) * 2))


def text(lines: list) -> str:
    return "".join(line + "\n" for line in lines)


# ----------------------------------------------------------------------
# quickstart, ycsb_demo --quick
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,argv,file", STORE_EXAMPLES)
def test_reference_example_prints_the_stored_lines(monkeypatch, name, argv,
                                                   file):
    assert run_reference(monkeypatch, name, argv) == \
        (REFERENCE / file).read_text()


@pytest.mark.parametrize("name,argv,file", STORE_EXAMPLES)
def test_twin_prints_the_reference_lines(name, argv, file):
    lines = load(f"{name}_torch").main(argv + ["--device", "cpu"])
    assert text(lines) == (REFERENCE / file).read_text()


# ----------------------------------------------------------------------
# serve_paged
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_params():
    return init_params(jax.random.PRNGKey(0), ref_get_config("qwen3-1.7b")
                       .smoke())


def twin_serve(params, requests: int) -> dict:
    cfg = get_config("qwen3-1.7b").smoke()
    return load("serve_paged_torch").main(
        ["--device", "cpu"], model=from_reference(cfg, params, device="cpu"),
        requests=requests)


def test_serve_paged_twin_matches_reference_engine(ref_params):
    """The example's first 4 requests: the pool settings of
    ``examples/serve_paged.py:22-24``, its seeded requests, its weights."""
    twin = load("serve_paged_torch")
    pools = dict(hbm_zones=6, host_zones=64, pages_per_zone=2, page_size=8,
                 max_batch=4, cache_zones=2)
    assert twin.POOLS == pools
    cfg = ref_get_config("qwen3-1.7b").smoke()
    ref = ref_serving.ServingEngine(cfg, ref_params, **pools)
    rng = np.random.default_rng(7)
    for i in range(4):
        plen = int(rng.integers(8, 24))
        ref.submit(ref_serving.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, plen)
            .astype(np.int32), max_new_tokens=int(rng.integers(4, 10))))
    stats = ref.run(max_steps=200)
    out = twin_serve(ref_params, 4)
    assert out["stats"] == stats and stats["done"] == 4
    assert out["tokens"] == {r.rid: list(r.out_tokens) for r in ref.done}


@pytest.mark.slow
def test_serve_paged_twin_matches_reference_example(monkeypatch, ref_params):
    """All 12 requests: the reference example's own run (its weights are
    ``ref_params``), its printed counters and its engine's tokens."""
    engines = []

    class Recorded(ref_serving.ServingEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            engines.append(self)

    printed = run_reference(monkeypatch, "serve_paged", [], patch=lambda mod:
                            setattr(mod, "ServingEngine", Recorded))
    out = twin_serve(ref_params, 12)
    assert wall_free(out["lines"]) == wall_free(printed.splitlines())
    assert out["tokens"] == {r.rid: list(r.out_tokens)
                             for r in engines[0].done}


# ----------------------------------------------------------------------
# train_lm
# ----------------------------------------------------------------------
def reference_train_lm(monkeypatch, argv: list) -> tuple:
    """The reference example's printed lines, its train loop cut to the
    smoke config on 2 x 16 batches (the example's steps, checkpoint period
    and failure step kept), and the (cfg, steps, batch, seq) it asked
    for."""
    one_device_mesh(monkeypatch)
    asked = []

    def loop(cfg, *, steps, batch, seq, **kw):
        asked.append((cfg, steps, batch, seq))
        return ref_train.train_loop(ref_get_config("qwen3-1.7b").smoke(),
                                    steps=steps, batch=2, seq=16,
                                    log=lambda *a: None, **kw)

    printed = run_reference(monkeypatch, "train_lm", argv, patch=lambda mod:
                            setattr(mod, "train_loop", loop))
    return printed.splitlines(), asked[0]


@pytest.mark.parametrize("argv,file", TRAIN_SIZES)
def test_train_lm_reference_lines_and_twin_sizes(monkeypatch, argv, file):
    """The stored model and restarts lines are the reference example's,
    and the twin trains the example's config, steps, batch and seq."""
    printed, (cfg, steps, batch, seq) = reference_train_lm(monkeypatch, argv)
    assert text(printed[:2]) == (REFERENCE / file).read_text()
    t_cfg, t_steps, t_batch, t_seq = load("train_lm_torch").sizes(
        "--full" in argv)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(cfg)
    assert t_cfg.param_count() == cfg.param_count()
    assert (t_steps, t_batch, t_seq) == (steps, batch, seq)


@pytest.mark.parametrize("full", [False, True])
def test_train_lm_sizes_take_the_tensor_core_kernels(full):
    """In bf16 at D 32 (default) and D 64 (--full), the flash forward and
    both backward kernels take the tensor-core variants."""
    cfg = load("train_lm_torch").sizes(full)[0]
    assert cfg.head_dim_ == (64 if full else 32)
    assert flash_kernel.supports(cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim_)
    assert flash_kernel.variant(torch.bfloat16, cfg.head_dim_) == "mma"
    assert flash_kernel.bwd_variant(torch.bfloat16, cfg.head_dim_) == "mma"


def test_train_lm_twin_matches_reference_loop(monkeypatch, tmp_path):
    """The default size's config at 16 steps of 2 x 32: the kill at step 8
    and the resume from step 8's checkpoint as the reference's loop does
    them, losses logged at the same steps, and the twin's loss falls.
    Each package draws its initial weights from its own generator, so the
    losses themselves differ (``tests/test_torch_train.py`` holds the
    step on one state)."""
    one_device_mesh(monkeypatch)
    cfg = load("train_lm_torch").sizes(False)[0]
    ref = ref_train.train_loop(
        ref_get_config("qwen3-1.7b").__class__(**dataclasses.asdict(cfg)),
        steps=TWIN_STEPS, batch=TWIN_BATCH, seq=TWIN_SEQ,
        ckpt_dir=str(tmp_path), save_every=TWIN_STEPS // 4,
        fail_at=TWIN_STEPS // 2, log=lambda *a: None)
    twin = load("train_lm_torch").main(["--device", "cpu"], steps=TWIN_STEPS,
                                       batch=TWIN_BATCH, seq=TWIN_SEQ)
    assert (twin["restarts"], twin["events"], twin["final_step"]) == \
        (ref["restarts"], ref["events"], ref["final_step"])
    assert twin["restarts"] == 1
    assert [s for s, _ in twin["losses"]] == [s for s, _ in ref["losses"]]
    assert twin["losses"][-1][1] < twin["losses"][0][1]


# ----------------------------------------------------------------------
# no card
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["quickstart_torch", "ycsb_demo_torch",
                                  "serve_paged_torch", "train_lm_torch"])
def test_twin_raises_without_card(name):
    """The default ``--device cuda`` with no card raises; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        load(name).main([])
