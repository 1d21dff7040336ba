"""Toy runs of each traffic driver on the CPU against the reference: a
sound run is correct; the control (the reference in float8 in the
program's place) and each fault the cell can have make it not correct;
the harness's look for a chip is skipped, the rest of a run is driven."""
import time

import pytest
import torch

from port_bench import calibrate, harness
import toy

CELLS = sorted(toy.CELLS)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return harness.Bench(toy.make(tmp_path_factory.mktemp("toy")))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    run = harness.Run(bench, cell, 2**31 + 12345, 0.3, False, "cpu")
    line = harness.execute(run, time.perf_counter())
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    assert {m["name"] for m in bench.end_to_end(cell)} == set(line["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    out = calibrate.readings(bench, cell, 3, 0.3, "cpu", True, ())
    program, control = (r["numbers"] for r in out)
    limits = bench.cell(cell)["checks"]
    assert harness.judge(program, limits)[0]
    assert not harness.judge(control, limits)[0], control


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in toy.FAULTS[c]])
def test_fault_is_not_correct(bench, cell, fault):
    run = harness.Run(bench, cell, 4, 0.3, False, "cpu", (fault,))
    line = harness.execute(run, time.perf_counter())
    assert not line["correct"], line["checks"]


def test_faults_are_put_back(bench):
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    store, update = M._store, adamw.update
    for cell in ("toy-hybrid.train-toy", "toy-ssm.decode-toy"):
        run = harness.Run(bench, cell, 5, 0.1, False, "cpu", ("unchanged",))
        harness.execute(run, time.perf_counter())
    assert M._store is store and adamw.update is update


def test_same_seed_same_inputs_and_weights():
    from port_bench import data, weights
    cfg = toy.SSM
    a = weights.draw(cfg, 2**31 + 7, "cpu")
    b = weights.draw(cfg, 2**31 + 7, "cpu")
    c = weights.draw(cfg, 2**31 + 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert (data.tokens(9, 1, 3, (2, 5), 50)
            == data.tokens(9, 1, 3, (2, 5), 50)).all()
    lm = data.SyntheticLM(50, 2, 8, 9)
    assert (lm.batch_at(1)["tokens"] != lm.batch_at(2)["tokens"]).any()


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of the decode cell through ``run.py`` on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, str(toy.BENCH / "run.py"), "--workload",
         "falcon-mamba-7b.prefill-4x2k", "--seed", "2147483700",
         "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
        timeout=900, cwd=toy.BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
