"""The port's int8 compressed all-reduce (repro_torch.optim.compress)
against the reference's (repro.optim.compress), in one process: the
quantizer bit for bit, the resolver, and the all-reduce on a one-rank gloo
group. The 8-rank cases are tests/test_torch_dist.py."""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro.optim import compress as jcompress
from repro_torch.core import comm, plan
from repro_torch.core.wisdom import WisdomStore
from repro_torch.optim import (choose_psum_comm, compressed_psum,
                               dequantize_int8, quantize_int8)

SHAPES = st.lists(st.integers(1, 40), min_size=1, max_size=3).map(tuple)


@settings(max_examples=25, deadline=None)
@given(shape=SHAPES, seed=st.integers(0, 2 ** 16),
       scale=st.sampled_from([1e-6, 1.0, 300.0]),
       block=st.sampled_from([256, 7, 64]))
def test_quantize_matches_the_reference_bit_for_bit(shape, seed, scale,
                                                    block):
    x = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    q, s, pad = quantize_int8(torch.from_numpy(x), block)
    jq, js, jpad = jcompress.quantize_int8(jnp.asarray(x), block)
    assert pad == jpad == (-x.size) % block
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js, np.float32))
    ours = dequantize_int8(q, s, pad, shape)
    theirs = jcompress.dequantize_int8(jq, js, jpad, shape)
    assert tuple(ours.shape) == shape
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_quantize_keeps_all_zero_blocks_finite():
    q, s, pad = quantize_int8(torch.zeros(300))
    assert pad == 212 and not q.any()
    assert torch.isfinite(dequantize_int8(q, s, pad, (300,))).all()


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process (an in-process store)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield comm.make_mesh((1,), ("pod",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec", ["collective", "pipelined:2", "agas"])
def test_one_rank_compressed_psum_is_its_own_dequantized_input(one_rank,
                                                               spec):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (7, 100)).astype(np.float32))
    error = torch.full((7, 100), 0.01)
    total, new_error = compressed_psum(x, one_rank.get_group("pod"),
                                       error=error, comm=spec)
    q, s, pad = quantize_int8(x + error)
    want = dequantize_int8(q, s, pad, x.shape)
    assert total.shape == x.shape
    torch.testing.assert_close(total, want, rtol=0, atol=0)
    torch.testing.assert_close(new_error, x + error - want, rtol=0, atol=0)


def test_choose_psum_comm_resolves_as_the_reference(one_rank):
    assert choose_psum_comm(one_rank, "pod", (10, 10), mode="pipelined:3") \
        == "pipelined:3"
    wisdom = WisdomStore()
    # one rank: nothing to time, nothing to plan
    assert choose_psum_comm(one_rank, "pod", (1000,), mode="measure",
                            wisdom=wisdom) == "collective"
    assert choose_psum_comm(one_rank, "pod", (1000,)) == "collective"
    assert list(wisdom.keys("comm/")) == []


@pytest.mark.parametrize("n,p", [(12_617_728, 4), (1 << 20, 8), (1000, 2)])
def test_gather_roofline_under_the_reference_rule_and_the_h100s(n, p):
    """A profile with the reference's rule gives the reference's verdict;
    the H100's prices the port's chunked gather, which has no pack copy
    to overlap and adds a concatenation: always the collective."""
    from repro.core import comm as jcomm
    from repro.core import plan as jplan
    import dataclasses
    values = dataclasses.asdict(jplan.TPU_V5E)
    ours = comm.plan_comm_gather(n, p, hw=plan.HardwareSpec(
        **values, collective_lat=0.0))
    assert ours == jcomm.plan_comm_gather(n, p, hw=jplan.TPU_V5E)
    assert comm.plan_comm_gather(n, p, hw=plan.H100) == "collective"
