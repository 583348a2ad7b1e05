"""The port's roofline of the paper's own problem
(``experiments/fft_roofline_torch.py``) against the reference's
(``experiments/fft_roofline.py``).

One module-scoped fixture starts three processes at once from this file
and the port's script:

    XLA_FLAGS=--xla_force_host_platform_device_count=256 JAX_PLATFORMS=cpu \
        python tests/test_torch_roofline.py ref OUT.json
    python tests/test_torch_roofline.py port OUT.json
    python experiments/fft_roofline_torch.py --out D   (then --pencil)

The first lowers the reference's seven cases at N = 2^10 over 256 fake
devices and its pencil at n3 = ``PENCIL_N3`` (``lower_case``,
``lower_pencil``); the second traces the same through the port's
``lower_case`` and ``lower_pencil`` on a fake 256-rank group and records
whether JAX or the reference's package was imported; the third is the
port's script at full size (2^14, every case, and ``--pencil``). The
collectives (counts, operand and wire bytes) must be equal; the FLOPs
are not compared (the port counts matmul-class ops, XLA elementwise ones
too), but Karatsuba's must be 3/4 of the four-multiply count.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "experiments" / "fft_roofline_torch.py"
RUN_TIMEOUT = 240      # seconds; the three runs take about 20 s together
SMALL_N = 1 << 10
PENCIL_N3 = 64

# name -> (planner, comm, keep_transposed, chunks, permuted_cols): the
# reference's seven cases (experiments/fft_roofline.py, main); planner
# "plain" is its jnp planner and the port's torch one, "karatsuba" their
# Karatsuba twins
CASES = {
    "baseline_paper": ("plain", "collective", False, 4, False),
    "agas": ("plain", "agas", False, 4, False),
    "keep_transposed": ("plain", "collective", True, 4, False),
    "karatsuba": ("karatsuba", "collective", True, 4, False),
    "pipelined_c4": ("karatsuba", "pipelined", True, 4, False),
    "pipelined_c8": ("karatsuba", "pipelined", True, 8, False),
    "permuted_cols": ("plain", "collective", True, 4, True),
}
TERMS = ("t_compute", "t_memory", "t_collective")
# the TPU v5e constants the reference prices at (197 TF bf16, 819 GB/s
# HBM, 50 GB/s link)
TPU_CONSTANTS = (197e12, 819e9, 50e9)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _collectives(rec):
    return dict(counts=rec["collective_counts"],
                operand=rec.get("collective_operand_bytes"),
                wire=rec["collective_wire_bytes"])


def ref_main(out_path):
    """The reference's cases at SMALL_N on 256 fake devices."""
    from repro.core import plan
    roof = _load(ROOT / "experiments" / "fft_roofline.py", "fft_roofline")
    roof.N = SMALL_N
    planners = {
        "plain": plan.Planner(mode="estimate", backends=("jnp",)),
        "karatsuba": plan.Planner(mode="estimate",
                                  backends=("jnp_karatsuba",))}
    out = {}
    for name, (pl, comm, kt, chunks, perm) in CASES.items():
        rec = roof.lower_case(name, planners[pl], comm, kt, chunks=chunks,
                              permuted_cols=perm)
        out[name] = dict(_collectives(rec),
                         flops=rec["hlo_flops_per_device"])
    out["pencil"] = _collectives(roof.lower_pencil(PENCIL_N3))
    Path(out_path).write_text(json.dumps(out))


def port_main(out_path):
    """The port's cases at SMALL_N on a fake 256-rank group."""
    roof = _load(SCRIPT, "fft_roofline_torch")
    roof.N = SMALL_N
    out = {"settings": {}}
    for name, kw in roof.cases():
        kind = {("torch",): "plain", ("torch_karatsuba",): "karatsuba"}[
            kw["planner"].backends]
        out["settings"][name] = [kind, kw["comm"], kw["keep_transposed"],
                                 kw.get("chunks", 4),
                                 kw.get("permuted_cols", False)]
        rec = roof.lower_case(name, **kw)
        out[name] = dict(_collectives(rec), flops=rec["flops_per_device"])
    out["pencil"] = _collectives(roof.lower_pencil(PENCIL_N3))
    out["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "repro", "fft_roofline", "make_tables"))
    Path(out_path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("roofline")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=256")
    full = tmp / "full"
    cmds = {
        "ref": ([sys.executable, __file__, "ref", str(tmp / "ref.json")],
                ref_env),
        "port": ([sys.executable, __file__, "port", str(tmp / "port.json")],
                 env),
        "full": ([sys.executable, str(SCRIPT), "--out", str(full)], env),
        "full_pencil": ([sys.executable, str(SCRIPT), "--pencil", "--out",
                         str(full)], env)}
    procs = {name: subprocess.Popen(cmd, env=e, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (cmd, e) in cmds.items()}
    logs = {}
    try:
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=RUN_TIMEOUT)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for name, proc in procs.items():
        assert proc.returncode == 0, f"{name} run failed:\n{logs[name]}"
    return dict(
        ref=json.loads((tmp / "ref.json").read_text()),
        port=json.loads((tmp / "port.json").read_text()),
        full=json.loads((full / "fft_roofline.json").read_text()),
        pencil=json.loads((full / "fft_pencil3d.json").read_text()),
        logs=logs)


def test_the_port_runs_the_references_seven_cases(runs):
    assert runs["port"]["settings"] == {k: list(v) for k, v in CASES.items()}


@pytest.mark.parametrize("case", list(CASES) + ["pencil"])
def test_collectives_equal_the_references(runs, case):
    ours, theirs = runs["port"][case], runs["ref"][case]
    assert ours["counts"] == theirs["counts"]
    assert sum(ours["counts"].values()) > 0
    assert ours["wire"] == pytest.approx(theirs["wire"], rel=1e-12)
    if theirs["operand"] is not None:       # the reference's pencil has none
        assert ours["operand"] == pytest.approx(theirs["operand"],
                                                rel=1e-12)


def test_karatsuba_counts_three_quarters_of_the_products(runs):
    port = runs["port"]
    assert port["karatsuba"]["flops"] == 0.75 * port["keep_transposed"][
        "flops"]
    assert port["karatsuba"]["flops"] > 0


def test_the_port_imports_no_jax(runs):
    assert runs["port"]["imported"] == []


def _check_record(rec):
    from repro_torch.core.plan import H100, H100_CARD
    assert rec["card"] == H100_CARD
    assert rec["constants"] == {"flops": H100.flops, "hbm_bw": H100.hbm_bw,
                                "link_bw": H100.link_bw}
    assert not set(TPU_CONSTANTS) & set(rec["constants"].values())
    for k in TERMS + ("t_collective_exposed", "t_total_max"):
        assert math.isfinite(rec[k]) and rec[k] > 0, (rec["name"], k)
    assert rec["bottleneck"] in TERMS
    exposed = dict(rec, t_collective=rec["t_collective_exposed"])
    assert rec["t_total_max"] == max(exposed[k] for k in TERMS)
    assert rec["t_compute"] == rec["flops_per_device"] / H100.flops
    assert rec["t_memory"] == rec["bytes_per_device_unfused"] / H100.hbm_bw
    assert rec["t_collective"] == rec["collective_wire_bytes"] / H100.link_bw


def test_the_full_size_run_writes_every_case_priced_at_the_h100(runs):
    recs = runs["full"]
    assert [r["name"] for r in recs] == list(CASES)
    for rec in recs:
        _check_record(rec)
        # the monolithic exchanges stay exposed, the chunked ones less so
        if rec["name"].startswith("pipelined"):
            assert rec["t_collective_exposed"] < rec["t_collective"]
        else:
            assert rec["t_collective_exposed"] == rec["t_collective"]
    pencil = runs["pencil"]
    assert pencil["name"] == "pencil3d_1024"
    _check_record(pencil)
    assert pencil["collective_counts"]["all-to-all"] == 4
    lines = runs["logs"]["full"].splitlines() + \
        runs["logs"]["full_pencil"].splitlines()
    from repro_torch.core.plan import H100_CARD
    printed = [ln for ln in lines if "t_comp=" in ln]
    assert len(printed) == len(CASES) + 1
    assert all(ln.endswith(f"[{H100_CARD}]") for ln in printed)


def test_the_full_size_collectives_halve_without_the_second_exchange(runs):
    """At 2^14: the baseline's four all-to-alls move 8616960 wire bytes a
    rank, each one-exchange case 4308480 (the reference's HLO counts the
    same), and AGAS's all-gathers move the whole rows' (P-1)/P."""
    wire = {r["name"]: r["collective_wire_bytes"] for r in runs["full"]}
    assert wire["baseline_paper"] == 8616960
    for name in ("keep_transposed", "karatsuba", "pipelined_c4",
                 "pipelined_c8", "permuted_cols"):
        assert wire[name] == 4308480, name
    assert wire["agas"] > 100 * wire["baseline_paper"]


if __name__ == "__main__":
    {"ref": ref_main, "port": port_main}[sys.argv[1]](*sys.argv[2:])
