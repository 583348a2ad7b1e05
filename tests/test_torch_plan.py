"""The port's planner (repro_torch.core.plan) against the reference's
(repro.core.plan): same cost model, same wisdom files, same recipes."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import algo as jalgo
from repro.core import api as japi
from repro.core import plan as jplan
from repro.core import wisdom as jwisdom
from repro_torch.convert import plan_from_reference
from repro_torch.core import algo, plan, wisdom

# the reference's TPU profile values (and its one collective latency), so
# both planners price alike
TPU_VALUES = plan.HardwareSpec(**dataclasses.asdict(jplan.TPU_V5E),
                               collective_lat=japi.COLLECTIVE_LAT)
RNG = np.random.default_rng(13)


def _np(c):
    return np.asarray(c[0], np.float64) + 1j * np.asarray(c[1], np.float64)


@pytest.mark.parametrize("n,kind", [(256, "c2c"), (512, "c2c"),
                                    (1000, "c2c"), (16384, "c2c"),
                                    (16384, "r2c")])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_estimate_picks_the_reference_factors(n, kind, backend):
    ref_backend = {"torch": "jnp", "hopper": "pallas"}[backend]
    ours = plan.Planner(hardware=TPU_VALUES, backends=(backend,)).plan(n, kind)
    theirs = jplan.Planner(hardware=jplan.TPU_V5E,
                           backends=(ref_backend,)).plan(n, kind)
    assert ours.factors == theirs.factors
    assert ours.est_cost == pytest.approx(theirs.est_cost, rel=1e-12)


@pytest.mark.parametrize("n,factors", [(16384, (128, 128)), (512, (32, 16)),
                                       (64, (8, 8)), (7, (7, 1)),
                                       (32768, (32, 32, 32))])
def test_hopper_c2c_plans_take_the_kernels_splits(n, factors):
    """Under the H100 profile the estimate prefers three-factor matmul
    splits; the kernel backend still plans the kernel's two-factor split
    wherever n has one."""
    p = plan.Planner(backends=("hopper",)).plan(n, "c2c")
    assert (p.backend, p.factors) == ("hopper", factors)
    if n == 16384:
        assert len(plan.Planner(backends=("torch",)).plan(n).factors) == 3


def test_wisdom_round_trip(tmp_path):
    path = str(tmp_path / "wisdom.json")
    p = plan.Planner(backends=("torch",), wisdom_path=path)
    first = p.plan(4096, "c2c", batch=8)
    assert p.last_plan_seconds > 0
    again = plan.Planner(backends=("torch",), wisdom_path=path)
    assert again.plan(4096, "c2c", batch=8) == first
    assert again.last_plan_seconds == 0.0
    text = again.export_wisdom()
    store = wisdom.WisdomStore()
    assert store.import_wisdom(text) == 1
    assert store.export_wisdom() == text
    assert again.forget_wisdom("plan/") == 1 and len(again.wisdom) == 0


def test_plan_keys_carry_the_hardware():
    a = plan.Planner(hardware=TPU_VALUES)
    b = plan.Planner(hardware=plan.H100, wisdom=a.wisdom)
    a.plan(16384)
    b.plan(16384)
    assert len(a.wisdom) == 2
    assert a.wisdom_key(16384).endswith("/tpu_v5e")


def test_reference_wisdom_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / "reference.json")
    jp = jplan.Planner(backends=("jnp",), wisdom_path=path)
    for n in (256, 4096):
        jp.plan(n, "c2c", batch=4)
    store = wisdom.WisdomStore(path)
    ref_store = jwisdom.WisdomStore(path)
    assert list(store.keys()) == list(ref_store.keys())
    assert len(store) == 2
    for k in store.keys():
        assert store.get(k) == ref_store.get(k)
    assert store.export_wisdom() == ref_store.export_wisdom()
    assert json.loads(store.export_wisdom())["schema"] == "repro-wisdom"


@pytest.mark.parametrize("backend", ["jnp", "pallas", "jnp_karatsuba",
                                     "xla_native"])
def test_plan_from_reference_runs_the_reference_plan(backend):
    theirs = jplan.Planner(hardware=jplan.TPU_V5E,
                           backends=(backend,)).plan(1024, "c2c")
    ours = plan_from_reference(dataclasses.asdict(theirs))
    assert ours.factors == theirs.factors
    assert ours.backend == {"jnp": "torch", "pallas": "hopper",
                            "jnp_karatsuba": "torch_karatsuba",
                            "xla_native": "torch_native"}[backend]
    x = (RNG.standard_normal((3, 1024)).astype(np.float32)
         + 1j * RNG.standard_normal((3, 1024)).astype(np.float32))
    got = _np(plan.execute(ours, algo.to_pair(x)))
    want = _np(jplan.execute(theirs, jalgo.to_pair(x)))
    ref = np.fft.fft(x)
    tol = 2e-4 * np.abs(ref).max()
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(got, ref, atol=tol)
    with pytest.raises(ValueError):
        plan_from_reference({**dataclasses.asdict(theirs), "backend": "tpu"})


@pytest.mark.parametrize("backend", plan.BACKENDS)
def test_execute_every_backend_matches_numpy(backend):
    x = RNG.standard_normal((4, 1024)).astype(np.float32)
    p = plan.Planner(backends=(backend,))
    ref = np.fft.fft(x)
    tol = 2e-4 * np.abs(ref).max()
    c2c = plan.execute(p.plan(1024, "c2c"), algo.to_pair(x.astype(np.complex64)))
    np.testing.assert_allclose(_np(c2c), ref, atol=tol)
    inv = plan.execute_inverse(p.plan(1024, "c2c"), c2c)
    np.testing.assert_allclose(_np(inv), x, atol=1e-4)
    r2c = plan.execute(p.plan(1024, "r2c"), torch.from_numpy(x))
    np.testing.assert_allclose(_np(r2c), np.fft.rfft(x), atol=tol)
    back = plan.execute(p.plan(1024, "c2r"), r2c)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)


def test_measured_mode_times_on_the_given_device(tmp_path):
    p = plan.Planner(mode="measured", backends=("torch", "torch_native"),
                     hardware=plan.CPU_LOCAL, device="cpu",
                     wisdom_path=str(tmp_path / "w.json"))
    for kind in ("c2c", "r2c", "c2r"):
        pl = p.plan(512, kind, batch=4)
        assert pl.measured_cost > 0
        assert p.plan(512, kind, batch=4) == pl
        assert p.last_plan_seconds == 0.0


def test_measured_candidate_that_raises_makes_plan_raise(monkeypatch):
    def broken(p, x):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(plan, "execute", broken)
    p = plan.Planner(mode="measured", backends=("torch",), device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        p.plan(256, "c2c")
    assert len(p.wisdom) == 0


def test_measured_mode_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        plan.Planner(mode="measured").plan(256, "c2c")


def test_bad_planner_arguments_raise():
    with pytest.raises(ValueError):
        plan.Planner(backends=("pallas",))
    with pytest.raises(ValueError):
        plan.Planner(mode="exhaustive")
    with pytest.raises(ValueError):
        plan.execute_inverse(plan.Plan(64, "r2c", (32,), "torch"),
                             torch.zeros(2, 64))


def test_reference_pricing_is_the_default():
    """A profile that does not set the new fields prices as the reference:
    dense four-step flops, the reference's pipelined rule."""
    assert TPU_VALUES.fft_share == 0.0
    assert TPU_VALUES.pipelined_hides_compute
    assert plan.CPU_LOCAL.fft_share == 0.0
    p = plan.Planner(hardware=TPU_VALUES, backends=("hopper",)).plan(
        16384, "c2c", batch=8193)
    theirs = jplan.Planner(hardware=jplan.TPU_V5E,
                           backends=("pallas",)).plan(16384, "c2c",
                                                      batch=8193)
    assert p.est_cost == pytest.approx(theirs.est_cost, rel=1e-12)


def test_h100_prices_a_kernel_pass_as_a_radix_fft_at_its_share():
    """Under H100 the four-step kernel's pass is its radix-FFT bound over
    the share measured on the card; the torch.matmul plans keep the dense
    pricing."""
    hw = plan.H100
    assert 0 < hw.fft_share <= 1
    batch, n = 8193, 16384
    p = plan.Planner(backends=("hopper",)).plan(n, "c2c", batch=batch)
    assert (p.backend, p.factors) == ("hopper", (128, 128))
    bound = max(5.0 * batch * n * 14 / hw.flops, 16.0 * batch * n / hw.hbm_bw)
    assert p.est_cost == pytest.approx(bound / hw.fft_share, rel=1e-12)
    # the dense pricing of the same pass: about 4x the kernel's price
    dense = plan.Planner(hardware=dataclasses.replace(hw, fft_share=0.0),
                         backends=("hopper",)).plan(n, "c2c", batch=batch)
    assert dense.est_cost > 3 * p.est_cost
    t = plan.Planner(backends=("torch",)).plan(n, "c2c", batch=batch)
    assert t.backend == "torch" and t.est_cost == pytest.approx(
        plan.Planner(hardware=dataclasses.replace(hw, fft_share=0.0),
                     backends=("torch",)).plan(n, "c2c", batch=batch)
        .est_cost, rel=1e-12)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_stage_seconds_is_the_cheapest_candidate(backend):
    p = plan.Planner(backends=(backend,))
    for n, kind in ((512, "c2c"), (16384, "r2c"), (7, "c2c")):
        assert p.stage_seconds(n, kind, 100) == pytest.approx(
            p.plan(n, kind, batch=100).est_cost, rel=1e-12)
    # no factorization of at most three factors <= 128
    assert p.stage_seconds(1 << 26, "c2c", 1) == float("inf")
