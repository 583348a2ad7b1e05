"""The CUDA sources of the FFT kernels, compiled for the CPU and held
against numpy.

The CPU tests run where no CUDA compiler is installed, so the sources of
``dft_matmul.cu`` and ``fftconv.cu`` (with ``common/fft_radix.cuh``) are
compiled with g++ against ``tests/cuda_host/cuda_runtime.h``, a host
stand-in that runs one thread per CUDA thread with a real barrier, and
called through the same C interface the wrappers call on the card. This checks the kernels' index arithmetic,
radix plans, barriers and launch limits on every radix path; the card runs
the same sources in tests/test_torch_gpu.py and chip_smoke.py.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dft_matmul import ops as dft_ops
from repro_torch.kernels.fftconv.ref import filter_spectrum_plain

HOST = Path(__file__).resolve().parent / "cuda_host"
RNG = np.random.default_rng(13)


def _host_source(text: str) -> str:
    """A kernel source with its launch and dynamic shared memory turned to
    the host stand-in's."""
    text = text.replace("extern __shared__ float4 fft_radix_smem[];",
                        "float4* fft_radix_smem = host_cuda::shared;")
    return re.sub(r"kernel<<<(.*)>>>\(", r"host_cuda::launch(kernel, \1)(",
                  text)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("kernels")
    (out / "common").mkdir()
    header = (_build.KERNELS_DIR / "common" / "fft_radix.cuh").read_text()
    assert "extern __shared__ float4 fft_radix_smem[];" in header
    (out / "common" / "fft_radix.cuh").write_text(_host_source(header))
    procs = []
    for name in ("dft_matmul", "fftconv"):
        src = (_build.KERNELS_DIR / name / f"{name}.cu").read_text()
        assert "kernel<<<" in src
        (out / name).mkdir()
        (out / name / f"{name}.cpp").write_text(_host_source(src))
        procs.append(subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
             f"-I{HOST}", "-o", str(out / f"{name}.so"),
             str(out / name / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log, _ = p.communicate()
        assert p.returncode == 0, log
    so = {name: ctypes.CDLL(str(out / f"{name}.so"))
          for name in ("dft_matmul", "fftconv")}
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so["dft_matmul"].four_step_fft.argtypes = [ptr] * 7 + [i64] + [i32] * 4 \
        + [ptr]
    so["dft_matmul"].four_step_fft.restype = i32
    so["fftconv"].fftconv_fused.argtypes = [ptr] * 6 + [i64] + [i32] * 3 \
        + [ptr]
    so["fftconv"].fftconv_fused.restype = i32
    return so


def _four_step(lib, x, factors, karatsuba=False, permuted=False):
    n1, n2 = factors
    a = torch.from_numpy(x.real.astype(np.float32).copy())
    b = torch.from_numpy(x.imag.astype(np.float32).copy())
    yr, yi = torch.full_like(a, np.nan), torch.full_like(b, np.nan)
    r1, tw, r2 = dft_ops.tables(n1, n2, torch.device("cpu"))
    rc = lib["dft_matmul"].four_step_fft(
        a.data_ptr(), b.data_ptr(), r1.data_ptr(), tw.data_ptr(),
        r2.data_ptr(), yr.data_ptr(), yi.data_ptr(), a.shape[0], n1, n2,
        int(karatsuba), int(permuted), None)
    return rc, yr.numpy() + 1j * yi.numpy()


def _expected(x, factors, permuted):
    n1, n2 = factors
    spec = np.fft.fft(x.astype(np.complex128), axis=-1)
    if permuted:    # C[k1, k2] = X[k2*n1 + k1], flat
        spec = spec.reshape(-1, n2, n1).transpose(0, 2, 1).reshape(x.shape)
    return spec


def _randc(shape):
    return RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)


@pytest.mark.parametrize("factors", [(8, 8), (16, 16), (16, 32), (32, 16),
                                     (25, 40), (125, 8), (7, 3), (4, 9),
                                     (128, 1), (1, 127), (11, 13), (1, 1),
                                     (6, 10), (81, 2), (128, 128)])
@pytest.mark.parametrize("permuted", [False, True])
def test_four_step_source_matches_numpy(lib, factors, permuted):
    x = _randc((1 if factors == (128, 128) else 3, factors[0] * factors[1]))
    rc, y = _four_step(lib, x, factors, permuted=permuted)
    assert rc == 0
    ref = _expected(x, factors, permuted)
    # the reference's kernel tolerance (tests/test_kernels.py)
    assert np.abs(y - ref).max() <= 1e-4 * np.abs(ref.real).max()


@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("rows", [4, 300])
def test_four_step_source_modes_and_many_ctas(lib, karatsuba, rows):
    # 300 rows of 64 points take three CTAs
    factors = (32, 32) if rows == 4 else (8, 8)
    x = _randc((rows, factors[0] * factors[1]))
    for permuted in (False, True):
        rc, y = _four_step(lib, x, factors, karatsuba, permuted)
        assert rc == 0
        ref = _expected(x, factors, permuted)
        assert np.abs(y - ref).max() <= 1e-4 * np.abs(ref.real).max()


def test_four_step_source_refuses_bad_factors(lib):
    x = _randc((2, 129))
    rc, _ = _four_step(lib, x, (129, 1))
    assert rc != 0


@pytest.mark.parametrize("factors", [(8, 8), (16, 32), (5, 7), (11, 13),
                                     (128, 1), (1, 127), (8, 16), (6, 10),
                                     (128, 128)])
@pytest.mark.parametrize("batch", [5, 6])
@pytest.mark.parametrize("block_rows", [1, 8])
def test_fftconv_source_matches_numpy(lib, factors, batch, block_rows):
    n1, n2 = factors
    n = n1 * n2
    x = RNG.standard_normal((batch, n)).astype(np.float32)
    h = (RNG.standard_normal(n) * np.exp(-np.arange(n) / 64.0)).astype(
        np.float32)
    spec = dft_ops.interleaved(filter_spectrum_plain(torch.from_numpy(h),
                                                     factors))
    r1, tw, r2 = dft_ops.tables(n1, n2, torch.device("cpu"))
    xt = torch.from_numpy(x)
    y = torch.full_like(xt, np.nan)
    rc = lib["fftconv"].fftconv_fused(
        xt.data_ptr(), spec.data_ptr(), r1.data_ptr(), tw.data_ptr(),
        r2.data_ptr(), y.data_ptr(), batch, n1, n2, block_rows, None)
    assert rc == 0
    ref = np.fft.ifft(np.fft.fft(x.astype(np.float64), axis=-1)
                      * np.fft.fft(h.astype(np.float64))).real
    # the reference's kernel tolerance (tests/test_kernels_fftconv.py)
    assert np.abs(y.numpy() - ref).max() <= 2e-4 * np.abs(ref).max()
