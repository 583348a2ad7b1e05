"""``experiments/make_tables_torch.py`` against the reference's
``experiments/make_tables.py``: the same hand-written cells, as the
port's dry run writes them (exactly ``FIELDS`` of
tests/test_torch_pipeline.py) and as the reference's does (its field
names), must give the same three tables row for row. Only the
compile/trace label, the flops column's name, the roofline header's
constants and each note's words (the same branch of ``improvement_hint``)
may differ, and no TPU constant may appear in the port's output.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest

from test_torch_pipeline import FIELDS

ROOT = Path(__file__).resolve().parents[1]

# the reference's field names for the port's
RENAMED = {"trace_seconds": "compile_seconds",
           "flops_per_device": "hlo_flops_per_device",
           "bytes_per_device_unfused": "hlo_bytes_per_device"}
BUCKETS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
           "collective-permute")
# words of the reference's header and output that name TPU v5e figures
TPU_WORDS = ("197 TF", "819 GB/s", " 50 GB/s", "bf16,", "TPU", "v5e",
             "compile(")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def modules():
    return _load("make_tables"), _load("make_tables_torch")


def _ok(arch, shape, mesh, kind, bottleneck, t, coll, ar=0.0, trace=1.5,
        args=3.2e9, temps=7.7e10, ratio=0.61):
    """A port record of an ``ok`` cell, its fields exactly ``FIELDS``."""
    c = dict.fromkeys(BUCKETS, 0.0)
    c.update(coll, **{"all-reduce": ar})
    wire = {k: v * 255 / 256 for k, v in c.items()}
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh,
        "chips": 512 if mesh.startswith("2x") else 256, "kind": kind,
        "status": "ok", "pipelined": False, "trace_seconds": trace,
        "memory": {"argument_bytes": args, "output_bytes": None,
                   "temp_bytes": temps, "alias_bytes": None},
        "flops_per_device": 4.1e14, "bytes_per_device_unfused": 2.2e12,
        "collective_bytes_per_device": c,
        "collective_counts": {k: int(v > 0) for k, v in c.items()},
        "collective_wire_bytes_per_device": wire,
        "t_collective_wire": sum(wire.values()) / 450e9,
        "inner_scan_flops_correction_per_device": 0.0,
        "t_compute": t[0], "t_memory": t[1], "t_collective": t[2],
        "bottleneck": bottleneck, "model_flops_total": 6.4e16,
        "model_flops_per_device": 2.5e14, "useful_flops_ratio": ratio}
    assert set(rec) == set(FIELDS)
    return rec


def _skip(arch, shape, mesh, kind):
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "chips": 512 if mesh.startswith("2x") else 256, "kind": kind,
            "pipelined": False, "status": "skip",
            "reason": "quadratic full attention at 500k"}


def _error(arch, shape, mesh):
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
            "error": "Traceback (most recent call last): ..."}


# (file stem, record): every branch of improvement_hint, every unit of
# fmt_s and fmt_b, skips, an error, a pending multi-pod cell, a pipelined
# record (keyed apart, not tabled) and a record under a hyphenated alias
RECORDS = [
    ("granite_8b_train_4k_single", _ok(
        "granite_8b", "train_4k", "16x16", "train", "collective",
        (2.31, 0.0123, 4.5), {"all-gather": 3.3e9, "reduce-scatter": 1.1e9},
        ar=2.4e10, trace=21.47)),
    ("granite_8b_train_4k_multi", _ok(
        "granite_8b", "train_4k", "2x16x16", "train", "collective",
        (1.2, 0.5, 2.6), {"all-gather": 1.7e9}, ar=1.2e10, trace=33.1)),
    ("granite_8b_train_4k_multi_pipeline", _ok(
        "granite_8b", "train_4k", "2x16x16", "train", "compute",
        (9.9, 0.1, 0.2), {"collective-permute": 5e8}, trace=99.0)),
    ("granite_8b_long_500k_single", _skip(
        "granite_8b", "long_500k", "16x16", "decode")),
    ("granite_8b_long_500k_multi", _skip(
        "granite_8b", "long_500k", "2x16x16", "decode")),
    ("olmo_1b_decode_32k_single", _ok(
        "olmo_1b", "decode_32k", "16x16", "decode", "memory",
        (2.1e-6, 3.4e-4, 1.2e-5), {"all-gather": 512.0}, ar=4.1e4,
        trace=0.8, args=5.5e5, temps=999.0, ratio=0.02)),
    ("olmo_1b_prefill_32k_single", _ok(
        "olmo_1b", "prefill_32k", "16x16", "prefill", "memory",
        (0.004, 0.0071, 0.0002), {"all-to-all": 2.5e6}, ar=8.8e7)),
    ("dbrx_132b_train_4k_single", _ok(
        "dbrx_132b", "train_4k", "16x16", "train", "collective",
        (0.9, 0.3, 1.7), {"all-to-all": 6.1e9, "all-gather": 2.1e12},
        ar=9.9e9, args=8.7e9, temps=1.3e12)),
    ("qwen2_vl_7b_prefill_32k_single", _ok(
        "qwen2_vl_7b", "prefill_32k", "16x16", "prefill", "compute",
        (0.75, 0.12, 0.033), {}, ar=3.0e9, ratio=1.07)),
    ("zamba2_7b_train_4k_single", _error(
        "zamba2_7b", "train_4k", "16x16")),
    ("granite-8b_prefill_32k_single", _ok(
        "granite-8b", "prefill_32k", "16x16", "prefill", "compute",
        (0.5, 0.1, 0.1), {})),
]


def _as_reference(rec):
    """The port's record under the reference's field names."""
    return {RENAMED.get(k, k): v for k, v in rec.items()}


def _tables(mod, dir_):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(str(dir_))
    return buf.getvalue()


@pytest.fixture(scope="module")
def outputs(modules, tmp_path_factory):
    ref_mod, port_mod = modules
    port_dir = tmp_path_factory.mktemp("port_records")
    ref_dir = tmp_path_factory.mktemp("ref_records")
    for stem, rec in RECORDS:
        (port_dir / f"{stem}.json").write_text(json.dumps(rec))
        (ref_dir / f"{stem}.json").write_text(json.dumps(_as_reference(rec)))
    (port_dir / "fft_roofline.json").write_text("[]")      # not a cell
    return _tables(ref_mod, ref_dir), _tables(port_mod, port_dir)


def _hint_words(modules):
    """The reference's note -> the port's, for the same branch."""
    ref_mod, port_mod = modules
    probes = [dict(kind="train", bottleneck="compute",
                   collective_bytes_per_device={"all-reduce": 2e10}),
              dict(kind="decode", bottleneck="memory"),
              dict(kind="prefill", bottleneck="memory"),
              dict(kind="train", bottleneck="collective"),
              dict(kind="prefill", bottleneck="compute")]
    pairs = {ref_mod.improvement_hint(r): port_mod.improvement_hint(r)
             for r in probes}
    assert len(pairs) == len(set(pairs.values())) == len(probes)
    return pairs


def _rows(text):
    return [ln for ln in text.splitlines() if ln.startswith("|")]


def test_every_row_carries_the_references_cells(modules, outputs):
    ref, port = outputs
    hints = _hint_words(modules)
    ref_rows, port_rows = _rows(ref), _rows(port)
    assert len(port_rows) == len(ref_rows)
    for r, p in zip(ref_rows, port_rows):
        rc, pc = r.split(" | "), p.split(" | ")
        assert len(rc) == len(pc), (r, p)
        if rc[0] == "| arch":           # a header: only its names differ
            continue
        if len(rc) == 8 and rc[5] in ("compute", "memory", "collective"):
            rc[-1] = hints[rc[-1][:-2]] + " |"      # the roofline's note
        assert pc == rc, (r, p)


def test_the_headers_differ_only_by_their_names(outputs):
    ref, port = outputs
    heads = [(r, p) for r, p in zip(_rows(ref), _rows(port))
             if r.startswith("| arch")]
    assert len(heads) == 3
    swap = {"compile(s/m)": "trace(s/m)",
            "MODEL/HLO flops": "MODEL/counted flops"}
    for r, p in heads:
        for old, new in swap.items():
            r = r.replace(old, new)
        assert r == p


def test_the_tables_cover_the_cells_as_the_reference_keys_them(outputs):
    ref, port = outputs
    rows = _rows(port)
    assert "| granite_8b | train_4k | ok | ok | 21.47/33.1 | 3.20GB | " \
        "77.00GB |" in rows
    assert "| granite_8b | long_500k | skip* | skip* | -/- | - | - |" in rows
    assert "| zamba2_7b | train_4k | ERROR | (pending) | -/- | - | - |" \
        in rows
    # the pipelined record is keyed apart: the flat one is tabled
    assert not any("99.0" in r for r in rows)
    # a record written under a hyphenated alias (``--arch granite-8b``)
    # carries the alias as its arch, which the order's module ids miss:
    # the reference drops it, and so does the port
    assert "granite-8b" not in port and "granite-8b" not in ref


def test_the_port_prints_the_h100_constants_and_no_tpu_one(outputs):
    from repro_torch.core.plan import H100_CARD
    ref, port = outputs
    assert any(w in ref for w in TPU_WORDS)
    for w in TPU_WORDS:
        assert w not in port, w
    head = [ln for ln in port.splitlines() if ln.startswith("### Roofline")]
    assert head == [f"### Roofline (single-pod 16x16, per rank: 51.33 TF "
                    f"float32 matmul, 2974 GB/s HBM, 450 GB/s link; "
                    f"{H100_CARD})"]


def test_the_order_is_the_ports_configs_and_shapes(modules):
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.config import SHAPES
    ref_mod, port_mod = modules
    assert port_mod.ARCH_ORDER == list(ARCH_IDS) == ref_mod.ARCH_ORDER
    assert port_mod.SHAPE_ORDER == [s.name for s in SHAPES] \
        == ref_mod.SHAPE_ORDER
