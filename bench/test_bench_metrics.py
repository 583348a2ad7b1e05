"""Each per-layer reader on canned traces, and the reduction of a
profiler's events to what the readers take."""

import pytest

from bench import run
from bench.lib import counts, trace

FOUR_STEP = ("void (anonymous namespace)::four_step_big<false>("
             "CUtensorMap_st, CUtensorMap_st, float const*)")
TRANSPOSE = ("void (anonymous namespace)::transpose_kernel<unsigned int>("
             "unsigned int const*, unsigned int*, long long)")
CMUL = "void (anonymous namespace)::cmul_kernel<float4>(float4 const*)"
GEMM32 = ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_"
          "warpsize1x4x1_ffma")
GEMM16 = "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float>>")
NCCL_K = "ncclDevKernel_AllToAll_RING_LL(ncclDevComm*, unsigned long)"


def local_trace(**extra):
    t = {"kernels": [[ADD, 0.030, 10], [GEMM32, 0.040, 8],
                     [FOUR_STEP, 0.020, 4], [TRANSPOSE, 0.010, 8]],
         "busy_s": 0.095, "window_s": 0.100, "idle_gaps": [], "steps": 4}
    t.update(extra)
    return t


def test_reduce_events_union_gaps_and_labels():
    dev = [(0.0, 10.0, "k1"), (5.0, 20.0, "k2"), (30.0, 40.0, "k1"),
           (41.0, 45.0, "nccl:all_to_all"), (100.0, 110.0, "k3")]
    host = [(0.0, 200.0, "step"), (50.0, 90.0, "cudaStreamSynchronize"),
            (20.0, 30.0, "aten::add")]
    got = trace.reduce_events(dev, host, window_s=200e-6)
    assert got["busy_s"] == pytest.approx(40e-6)  # the annotation left out
    assert [k[0] for k in got["kernels"]] == ["k1", "k2", "k3"]
    assert got["kernels"][0][1:] == [pytest.approx(20e-6), 2]
    gaps = dict(got["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(60e-6)
    assert gaps["aten::add"] == pytest.approx(10e-6)
    br = trace.breakdown(got)
    assert br["device_ops"][0][0] == "k1" and len(br["idle_gaps"]) == 2


def test_fft_roofline_local():
    t = local_trace(fft_flops_per_step=1e9, fft_bytes_per_step=3.35e9)
    got = run.reader("fft_roofline.local")({"traces": [t]})
    # 1 ms least a step, 95 ms busy over 4 steps
    assert got == pytest.approx(100 * 1e-3 * 4 / 0.095)


def test_shares_and_idle():
    out = {"traces": [local_trace()]}
    assert run.reader("matmul_share.local")(out) == pytest.approx(40.0)
    assert run.reader("idle_share.local")(out) == pytest.approx(5.0)
    assert run.reader("idle_share.train")(out) == pytest.approx(5.0)
    assert run.reader("port_kernels_share.train")(out) == pytest.approx(
        30.0)
    assert run.reader("matmul_f32_share.train")(out) == pytest.approx(40.0)


def test_bf16_gemms_are_no_float32_share():
    t = local_trace(kernels=[[GEMM16, 0.05, 1], [GEMM32, 0.05, 1]])
    out = {"traces": [t]}
    assert run.reader("matmul_f32_share.train")(out) == pytest.approx(50.0)
    assert run.reader("matmul_share.local")(out) == pytest.approx(100.0)


def test_train_mfu():
    t = local_trace(model_flops_per_step=989e12 * 0.01)
    # 4 steps in 0.1 s of 0.01 s of peak work each: 40%
    assert run.reader("train_mfu")({"traces": [t]}) == pytest.approx(40.0)


def test_dist_readers_take_the_slowest_rank():
    a = local_trace(kernels=[[NCCL_K, 0.02, 4], [FOUR_STEP, 0.08, 4]],
                    busy_s=0.09, window_s=0.1, fft_flops_per_step=4e9,
                    fft_bytes_per_step_rank=3.35e9)
    b = dict(a, kernels=[[NCCL_K, 0.05, 4], [FOUR_STEP, 0.05, 4]],
             busy_s=0.08, window_s=0.12)
    out = {"traces": [a, b]}
    assert run.reader("nccl_share.dist")(out) == pytest.approx(50.0)
    assert run.reader("idle_share.dist")(out) == pytest.approx(
        (10.0 + 100 * (1 - 0.08 / 0.12)) / 2)
    # 1 ms least a step (bytes) over the slowest rank's 30 ms a step
    assert run.reader("fft_roofline.dist")(out) == pytest.approx(
        100 * 1e-3 / 0.03)


@pytest.mark.parametrize("name", [
    "fft_roofline.local", "matmul_share.local", "idle_share.local",
    "fft_roofline.dist", "idle_share.dist", "nccl_share.dist", "train_mfu",
    "port_kernels_share.train", "matmul_f32_share.train",
    "idle_share.train"])
def test_readers_find_nothing_without_a_trace(name):
    assert run.reader(name)({}) is None
    assert run.reader(name)({"traces": []}) is None


def test_nccl_share_without_nccl_is_nothing():
    assert run.reader("nccl_share.dist")({"traces": [local_trace()]}) is None


def test_peaks_are_the_published_ones():
    assert counts.PEAKS == {"fp32_flops": 67e12, "bf16_flops": 989e12,
                            "hbm_bytes": 3.35e12}
