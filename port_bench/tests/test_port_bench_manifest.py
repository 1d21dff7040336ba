"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, and every file and reader it implies."""
import json
import re
from pathlib import Path

import pytest

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|"
                   r"_rank$|expan|experts_per_tok|d_model|d_inner|d_ff)")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32
    assert all(_line(w) for w in MANIFEST["command"])
    named = [w for w in MANIFEST["command"] if w.endswith(".py")]
    assert all(any(w.startswith(p + "/") for p in MANIFEST["paths"])
               for w in named)


def test_names_units_and_lines():
    seen = set()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[key]:
            assert NAME.match(e["name"]), e["name"]
            assert (key, e["name"]) not in seen
            seen.add((key, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs_files_and_reductions():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert 1 <= len(MANIFEST["configs"]) <= 24
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))


def test_workloads_cells_and_metrics():
    wl = MANIFEST["workloads"]
    assert 1 <= len(wl) <= 24
    pairs = {(w["config"], w["traffic"]) for w in wl}
    assert len(pairs) == len(wl)
    assert sum(w["chips"] == 4 for w in wl) <= max(1, len(wl) // 4)
    bench = harness.Bench(ROOT)
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in wl:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        reported = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.per_layer(w["name"])
        mix = bench.traffic(w["traffic"])
        assert (bench.dir / "traffic" / f"{mix['driver']}.py").is_file()
        limits = bench.cell(w["name"])["checks"]
        assert limits and all(v > 0 for v in limits.values())
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in bench.end_to_end(cell)}
        assert bench.reader(m["name"]) is not None
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split(
                "_") + m["name"].split("."):
            assert m["unit"] == "%"


@pytest.mark.parametrize("key", ["configs", "workloads"])
def test_every_file_is_under_paths(key):
    for e in MANIFEST[key]:
        path = e.get("file") or f"port_bench/workloads/{e['name']}.json"
        assert (ROOT / path).is_file()
        assert any(path.startswith(p + "/") for p in MANIFEST["paths"])
