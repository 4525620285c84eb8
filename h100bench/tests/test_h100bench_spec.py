"""The benchmark's spec, its yardstick and its import rules, on the CPU.

    python3 -m pytest -q h100bench/tests
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import harness as h  # noqa: E402
import work  # noqa: E402

SPEC = h.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["h100bench"]
    assert SPEC["command"] == ["python3", "h100bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_to_the_allowed_keys_and_characters(section):
    for entry in SPEC[section]:
        assert set(entry) <= KEYS[section], entry
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in \
                    entry[key]
        for key in entry.get("reduced", []):
            assert NAME.match(key)


def test_names_are_unique_and_cells_are_well_formed():
    for section in KEYS:
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for cell in SPEC["workloads"]:
        assert cell["config"] in configs and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4)
        assert (cell["config"], cell["traffic"]) not in pairs
        pairs.add((cell["config"], cell["traffic"]))
        assert (HERE / "mixes" / f"{cell['traffic']}.json").exists()
        assert (HERE / "traffic" / f"{h.mix_of(cell['traffic'])['kind']}.py").exists()
    assert {c["config"] for c in SPEC["workloads"]} == configs
    fours = sum(c["chips"] == 4 for c in SPEC["workloads"])
    assert fours <= max(1, len(SPEC["workloads"]) // 4)


def test_bounds_and_setup():
    names = [m["name"] for m in SPEC["end_to_end"]]
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_per_layer_metric_moves_one_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {c["name"] for c in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(len(x) <= 200 for x in layers)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    for cell in SPEC["workloads"]:
        e2e = [m["name"] for m in h.cell_metrics(SPEC, cell["name"], trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert h.cell_metrics(SPEC, cell["name"], trace=True)


def test_configuration_files_lie_under_paths_and_name_their_cuts():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for entry in SPEC["configs"]:
        assert entry["file"].startswith("h100bench/configs/")
        data = json.loads((HERE.parent / entry["file"]).read_text())
        assert sorted(entry["reduced"]) == sorted(data["reduced"])
        assert entry["source"] == data["source"]
        for key in entry["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")) and "expert" not in key


# -- the yardstick --------------------------------------------------------------------


def test_shape_counts_against_hand_worked_values():
    yi16 = h.config_of(SPEC, "yi-9b-16l")
    yi48 = {**yi16, "num_hidden_layers": 48}
    # a yi layer: 4096 * 128 * (2 * 32 + 2 * 4) + 3 * 4096 * 11008 + 2 * 4096
    assert work.param_count(yi16) - work.embedding_params(yi16) - 4096 == 16 * 173_023_232
    assert round(work.param_count(yi16) / 1e9, 2) == 3.29
    assert round(work.param_count(yi48) / 1e9, 2) == 8.83
    # 6 N T + 3 x causal attention: 80.9 + 6.6 TFLOP
    assert abs(work.train_flops(yi16, 1, 4096) / 1e12 - 87.5) < 0.1
    assert work.gf_matmul_bytes(3, 6, 2, 1 << 20) == 2 * 9 * (1 << 20)


def test_the_checkpoint_stage_holds_the_stated_bytes():
    """The state the checkpoint cell keeps on the card, and its shards, as
    the configuration states them."""
    ckpt = h.kind_of(h.mix_of("ckpt-save-degraded-restore"))
    c = h.config_of(SPEC, "hdfs-rs-6-3-1024k")
    shapes = ckpt.tensor_shapes(c)
    per_value = 3 * 4                                   # fp32 weight, m and v
    layer = sum(a * b for a, b in shapes.values())
    assert layer == 4096 * 128 * (2 * 32 + 2 * 4) + 3 * 4096 * 11008
    assert c["stage_layers"] * layer * per_value == 33_218_887_680
    attn = sum(shapes[n][0] * shapes[n][1] for n in ckpt.PARTS[0][1])
    assert attn * per_value + 8 == 452_984_840
    assert shapes["gate"][0] * shapes["gate"][1] * per_value + 8 == 541_065_224


def test_reference_shapes_are_the_ports_tree():
    h.port_path()
    import train_ref  # noqa: F401  (the benchmark's reference, no program code)

    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import steps

    import port_config

    c = h.config_of(SPEC, "yi-9b-16l")
    cfg = port_config.model_config(c, remat=True)
    struct = steps.params_struct(ArchConfig(model=cfg, smoke=cfg))
    ours = train_ref.param_shapes(c)
    port = {path: tuple(leaf.shape) for path, leaf in h.tree_paths(struct)}
    assert ours == port
    assert train_ref.sorted_paths(ours) == list(port)


# -- imports ---------------------------------------------------------------------------------


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = imported_tops(path)
        assert not tops & {"jax", "jaxlib", "flax", "repro", "chip_smoke", "tools",
                           "benchmarks"}, path


def test_the_references_import_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert "repro_torch" not in imported_tops(path), path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in h.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in h.forbidden_modules()


# -- the last line ------------------------------------------------------------------------------


def test_the_result_line_has_the_contract_keys_compared_last():
    line = h.result_line(True, 3, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                         {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1},
                         {"loss_gap": {"value": 1e-5, "limit": 2e-4}},
                         {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "compared"]


def test_judge_holds_each_number_to_its_limit():
    ok, compared = h.judge({"a": 1.0, "b": 0.0}, {"a": 1.0, "b": 0.0})
    assert ok and compared["a"] == {"value": 1.0, "limit": 1.0}
    assert not h.judge({"a": 1.5}, {"a": 1.0})[0]
    assert not h.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not h.judge({}, {"a": 1.0})[0]


def test_every_cell_has_limits_with_their_readings():
    for cell in SPEC["workloads"]:
        limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
        assert limits
        for name, entry in limits.items():
            assert {"limit", "lower", "why"} <= set(entry), (cell["name"], name)
            assert entry["limit"] >= entry["lower"]
            if entry.get("upper") is not None:
                assert entry["limit"] < entry["upper"]


def test_the_command_refuses_without_a_card(tmp_path):
    """No card here: exit 2 and nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "yi9b-train4k",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120, cwd=HERE.parent)
    assert proc.returncode == 2 and proc.stdout == ""


# -- the traced window ------------------------------------------------------------------------


def test_the_trace_is_read_over_the_window_alone(tmp_path):
    """A warm-up kernel before the window range is left out, one that
    straddles its start counts for its part inside, and a kernel counts in
    the range that launched it."""
    import gzip

    import tracing

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1,
                "args": args}

    events = [
        x("user_annotation", tracing.WINDOW, 1000.0, 1000.0),
        x("user_annotation", "attention", 1100.0, 100.0),
        x("cuda_runtime", "cudaLaunchKernel", 10.0, 1.0, correlation=1),
        x("kernel", "warm", 20.0, 500.0, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 900.0, 1.0, correlation=2),
        x("kernel", "straddles", 950.0, 100.0, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 1150.0, 1.0, correlation=3),
        x("kernel", "inside", 1200.0, 300.0, correlation=3),
    ]
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    out = tracing.summarize(path, ("attention",))
    assert out["busy_s"] == pytest.approx(350e-6)
    assert out["range_s"]["attention"] == pytest.approx(300e-6)
    assert set(out["kernels_s"]) == {"straddles", "inside"}
