"""A cell, a traffic mix and a per-layer metric added as files only, in a
copy of the benchmark, are found by name and run; nothing is edited."""
import json
import time

from port_bench import harness
import toy


def test_added_files_are_found_and_run(tmp_path):
    root = toy.make(tmp_path)
    bench = root / "port_bench"
    before = {p: p.read_bytes() for p in bench.rglob("*.py")}
    # a new mix for an existing driver, a new cell on it, a new metric
    mix = dict(toy.MIXES["prefill-toy"], seq=24, check_calls=1)
    (bench / "traffic" / "prefill-new.json").write_text(json.dumps(mix))
    (bench / "workloads" / "toy-ssm.prefill-new.json").write_text(
        json.dumps(toy.CELLS["toy-ssm.prefill-toy"]))
    (bench / "metrics" / "traced_steps.py").write_text(
        "def read(run, summary, name):\n"
        "    return float(run.traced['steps'])\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append(
        {"name": "toy-ssm.prefill-new", "config": "toy-ssm",
         "traffic": "prefill-new", "chips": 1, "why": "added as files"})
    for m in manifest["end_to_end"]:
        if m["name"] == "prefill_tokens_per_s":
            m["workloads"].append("toy-ssm.prefill-new")
    manifest["per_layer"].append(
        {"name": "traced_steps", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "device",
         "moves": "prefill_tokens_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    b = harness.Bench(root)
    assert b.traffic("prefill-new")["seq"] == 24
    assert b.cell("toy-ssm.prefill-new") == toy.CELLS["toy-ssm.prefill-toy"]
    assert b.reader("traced_steps").read.__module__.endswith("traced_steps")
    assert b.reader("idle_share.decode").__name__.endswith("idle_share")
    # a metric without ``workloads`` goes to every cell reporting its moves
    assert "traced_steps" in {m["name"] for m in
                              b.per_layer("toy-ssm.prefill-new")}
    assert "traced_steps" not in {m["name"] for m in
                                  b.per_layer("toy-ssm.decode-toy")}

    run = harness.Run(b, "toy-ssm.prefill-new", 11, 0.2, False, "cpu")
    line = harness.execute(run, time.perf_counter())
    assert line["correct"] and line["attempted"] >= 2
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    traced = harness.Run(b, "toy-ssm.prefill-new", 12, 0.2, True, "cpu")
    line = harness.execute(traced, time.perf_counter())
    # no device here: the device readers find nothing and are left out,
    # the counter reads what the driver counted
    assert line["metrics"] == {"traced_steps": {"value": 2.0,
                                                "unit": "steps"}}
    assert {p: p.read_bytes() for p in bench.rglob("*.py")
            if p in before} == before
