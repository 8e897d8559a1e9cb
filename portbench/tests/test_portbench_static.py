"""The benchmark's files on their own: what they import, the work counts,
BENCHMARK.json against the contract's shape, and that every piece of a
cell is found by name, a new cell by new files alone."""

import ast
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, work  # noqa: E402

PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in BENCH["configs"]}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_file_imports_jax_or_the_jax_package(path):
    # whole top-level names: the port's own name begins with the JAX
    # package's
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("name", ["reference.py", "work.py", "trace.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in top_level_imports(PB / name)
    assert top_level_imports(PB / name) <= {"__future__", "contextlib",
                                            "math", "torch", "json",
                                            "collections", "pathlib"}


def test_forbidden_modules_compares_whole_names():
    port = ["repro_torch", "repro_torch.fft", "jaxtyping", "flaxen", "torch"]
    assert harness.forbidden_modules(port) == []
    assert harness.forbidden_modules([*port, "repro.fft", "jax._src.core"]) \
        == ["jax", "repro"]


# the shapes of the work counted by hand: the cells' configuration, and
# 2-D and 2^32-point ones for the entries no cell drives yet
CONFIGS |= {"images_4096": {"shape": [4096, 4096], "batch_shape": [8]},
            "gfft_2e32": {"shape": [2 ** 32], "batch_shape": []}}
# (kind, config) -> bytes in, bytes out, flops, bound in ms, by hand
WORK = {
    ("c2c", "paper_c2c1024"): (
        32768 * 1024 * 8, 32768 * 1024 * 8, 5 * 1024 * 10 * 32768, 0.160260),
    ("c2c", "images_4096"): (
        8 * 4096 ** 2 * 8, 8 * 4096 ** 2 * 8, 5 * 4096 ** 2 * 24 * 8, 0.641040),
    ("r2c", "images_4096"): (
        8 * 4096 ** 2 * 4, 8 * 4096 * 2049 * 8, 2.5 * 4096 ** 2 * 24 * 8,
        0.320598),
    ("c2c", "gfft_2e32"): (
        2 ** 32 * 8, 2 ** 32 * 8, 5 * 2 ** 32 * 32, 20.51328),
}


@pytest.mark.parametrize("kind,config", sorted(WORK))
def test_work_counts_by_hand(kind, config):
    nin, nout, flops, bound_ms = WORK[kind, config]
    cfg = CONFIGS[config]
    assert work.in_bytes(kind, cfg) == nin
    assert work.out_bytes(kind, cfg) == nout
    assert work.flops(kind, cfg) == pytest.approx(flops)
    assert work.bound_s(kind, cfg) * 1e3 == pytest.approx(bound_ms, rel=1e-4)
    # a chip's share of a split signal
    assert work.bound_s(kind, cfg, 4) == pytest.approx(
        work.bound_s(kind, cfg) / 4)


NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"


def test_benchmark_json_has_the_contracts_shape():
    import re
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    cells = BENCH["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = [x["name"] for x in (*BENCH["configs"], *cells,
                                 *BENCH["end_to_end"], *BENCH["per_layer"])]
    assert all(re.match(NAME, n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert (PB / "entries" / f"{c.traffic['entry']}.py").exists()
    entry = importlib.import_module(f"portbench.entries.{c.traffic['entry']}")
    assert entry.Driver.kind in ("c2c", "r2c")
    assert "kind" not in c.traffic   # stated once, by the driver
    for name in (*c.end_to_end, *c.per_layer):
        assert callable(harness.reader(name))
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    # every per-layer metric's cells report the end-to-end metric it moves
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert m["moves"] in c.end_to_end, (m["name"], cell)
    assert set(c.traffic["limits"]) and c.traffic["checked_calls"] >= 1


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((PB / "traffic" / "device.json").read_text())
    traffic["inflight"] = 4
    (tmp_path / "portbench" / "traffic" / "deep.json").write_text(
        json.dumps(traffic))
    bench["workloads"].append({"name": "paper_c2c1024.deep",
                               "config": "paper_c2c1024", "traffic": "deep",
                               "chips": 1, "why": "four calls in flight"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(tmp_path, "paper_c2c1024.deep")
    assert cell.traffic["inflight"] == 4
    assert cell.config == CONFIGS["paper_c2c1024"]
    # metrics without a list of cells reach the new one too
    assert cell.end_to_end == [m["name"] for m in bench["end_to_end"]
                               if "workloads" not in m]


def run_cli(cwd: Path):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "paper_c2c1024.device", "--seed", str(2 ** 31 + 7), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_run_fails_without_a_card_and_prints_no_result():
    proc = run_cli(ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA device" in proc.stderr


def test_run_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = run_cli(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_per_layer_metrics_name_one_layer_each():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"planner", "executors", "kernels", "exchanges",
                      "copy path", "device"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("code,rc", [("0", 0), ("3", 4)])
def test_rank_launcher_starts_and_waits_for_the_other_ranks(tmp_path, code,
                                                            rc):
    from portbench import ranks
    child = [sys.executable, "-c", f"import sys; sys.exit({code})"]
    got, port = ranks.run_world(child, 0, 0, 3, tmp_path,
                                lambda port: (0, port))
    assert got == rc and port > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rank1.log",
                                                          "rank2.log"]
    # a rank other than 0, or a world of one, runs its body alone
    assert ranks.run_world(child, 1, 7, 3, tmp_path,
                           lambda port: (0, port)) == (0, 7)
