"""The CUDA sources of the FFT kernels, compiled for the CPU and held
against numpy (and the fused kernel against the reference's).

The CPU tests run where no CUDA compiler is installed, so the sources of
``dft_matmul.cu`` and ``fftconv.cu`` (with ``common/fft_radix.cuh``) are
compiled with g++ against ``tests/cuda_host/cuda_runtime.h``, a host
stand-in that runs one thread per CUDA thread with a real barrier, and
called through the same C interface the wrappers call on the card. This checks the kernels' index arithmetic,
radix plans, barriers, copy paths and launch limits on every radix path;
the card runs the same sources in tests/test_torch_gpu.py and
chip_smoke.py.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fftconv import fftconv_fused as jax_fftconv_fused
from repro_torch.kernels import _build
from repro_torch.kernels.dft_matmul import ops as dft_ops
from repro_torch.kernels.fftconv.ref import filter_spectrum_plain

HOST = Path(__file__).resolve().parent / "cuda_host"
ASYNC_COPY = ("align128", "make_tile_map", "mbar_init", "mbar_init_fence",
              "mbar_arrive_expect_tx", "mbar_wait", "fence_proxy_async",
              "tile_load", "bulk_load", "copy4", "mbar_arrive_copies")
COPY4, BULK, TILE = 0, 1, 2     # the stand-in's copy counters
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
    common = _build.KERNELS_DIR / "common"
    headers = {p.name: p.read_text() for p in common.glob("*.cuh")}
    assert "extern __shared__ float4 fft_radix_smem[];" in \
        headers["fft_radix.cuh"]
    assert "kernel<<<" in headers["persistent.cuh"]
    # the stand-in defines async_copy's functions in place of its PTX
    for name in ASYNC_COPY:
        assert f" {name}(" in headers["async_copy.cuh"], name
    headers["async_copy.cuh"] = "#pragma once\n"
    for name, text in headers.items():
        (out / "common" / name).write_text(_host_source(text))
    procs = []
    for name in ("dft_matmul", "fftconv"):
        src = (_build.KERNELS_DIR / name / f"{name}.cu").read_text()
        assert '#include "../common/persistent.cuh"' in src
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
    so["dft_matmul"].host_cuda_bytes_copied.argtypes = [i32]
    so["dft_matmul"].host_cuda_bytes_copied.restype = ctypes.c_longlong
    so["fftconv"].fftconv_fused.argtypes = [ptr] * 6 + [i64] + [i32] * 3 \
        + [ptr]
    so["fftconv"].fftconv_fused.restype = i32
    so["fftconv"].host_cuda_bytes_copied.argtypes = [i32]
    so["fftconv"].host_cuda_bytes_copied.restype = ctypes.c_longlong
    return so


def _placed(a, offset):
    """The real array a as a float32 tensor that starts `offset` floats into
    a 16-byte aligned buffer."""
    buf = torch.empty(a.size + offset + 4, dtype=torch.float32)
    skip = (-buf.data_ptr() // 4) % 4 + offset
    t = buf[skip:skip + a.size].view(a.shape)
    t.copy_(torch.from_numpy(a.astype(np.float32)))
    assert t.data_ptr() % 16 == 4 * (offset % 4)
    return t


def _planes(x, offset):
    """x's real and imaginary planes as float32 tensors that start `offset`
    floats into a 16-byte aligned buffer."""
    return [_placed(part, offset) for part in (x.real, x.imag)]


def _four_step(lib, x, factors, karatsuba=False, permuted=False, offset=0):
    n1, n2 = factors
    a, b = _planes(x, offset)
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


def _copied(lib):
    """Input bytes each copy path of the stand-in took since the last call."""
    return [lib["dft_matmul"].host_cuda_bytes_copied(k)
            for k in (COPY4, BULK, TILE)]


# Persistent CTAs: the stand-in reports 2 SMs of one CTA, so BIG rows
# (128 x 128) are walked two CTAs at a time, and 70 rows of 512 are five
# batches of 16 (the last of 6), three through one CTA's two stages.
@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("factors,rows,path", [((128, 128), 3, TILE),
                                               ((128, 128), 5, TILE),
                                               ((32, 16), 70, BULK)])
def test_four_step_source_persistent_ctas(lib, factors, rows, path,
                                          karatsuba, permuted):
    x = _randc((rows, factors[0] * factors[1]))
    _copied(lib)
    rc, y = _four_step(lib, x, factors, karatsuba, permuted)
    assert rc == 0
    # every input byte came in once, by the path the shape takes
    want = [0, 0, 0]
    want[path] = x.size * 8
    assert _copied(lib) == want
    ref = _expected(x, factors, permuted)
    assert np.abs(y - ref).max() <= 1e-4 * np.abs(ref.real).max()


# The shapes and inputs that take the other copy paths: an input one float
# off 16-byte alignment, n2 (BIG) or n (short rows) not a multiple of 4
# take 4-byte copies. (96, 100) takes TMA boxes with a last group of 36
# columns (a box of 32 columns, 4 of them in the row, and an empty tile);
# (127, 65) a generic radix-127 DFT_n1 of one pass that reads the ring and
# multiplies by T.
@pytest.mark.parametrize("factors,rows,offset,path", [
    ((128, 128), 3, 1, COPY4), ((32, 16), 37, 1, COPY4),
    ((127, 65), 3, 0, COPY4), ((96, 100), 3, 0, TILE),
    ((7, 3), 700, 0, COPY4), ((25, 40), 33, 0, BULK)])
def test_four_step_source_staging_paths(lib, factors, rows, offset, path):
    x = _randc((rows, factors[0] * factors[1]))
    _copied(lib)
    for permuted in (False, True):
        rc, y = _four_step(lib, x, factors, permuted=permuted, offset=offset)
        assert rc == 0
        ref = _expected(x, factors, permuted)
        assert np.abs(y - ref).max() <= 1e-4 * np.abs(ref.real).max()
    copied = _copied(lib)
    assert [c > 0 for c in copied] == [k == path for k in range(3)]
    # a box covers whole tiles; the others copy each input byte once
    assert copied[path] == 2 * x.size * 8 or (
        path == TILE and copied[path] > 2 * x.size * 8)


def test_four_step_source_refuses_bad_factors(lib):
    x = _randc((2, 129))
    rc, _ = _four_step(lib, x, (129, 1))
    assert rc != 0


def _conv_inputs(rows, n):
    x = RNG.standard_normal((rows, n)).astype(np.float32)
    h = (RNG.standard_normal(n) * np.exp(-np.arange(n) / 64.0)).astype(
        np.float32)
    return x, h


def _fused(lib, x, h, factors, block_rows=8, offset=0):
    """The stand-in's fused kernel on real rows x with filter h, x placed
    `offset` floats past 16-byte alignment: (return code, y)."""
    n1, n2 = factors
    spec = dft_ops.interleaved(filter_spectrum_plain(torch.from_numpy(h),
                                                     factors))
    r1, tw, r2 = dft_ops.tables(n1, n2, torch.device("cpu"))
    xt = _placed(x, offset)
    y = torch.full(x.shape, np.nan, dtype=torch.float32)
    rc = lib["fftconv"].fftconv_fused(
        xt.data_ptr(), spec.data_ptr(), r1.data_ptr(), tw.data_ptr(),
        r2.data_ptr(), y.data_ptr(), x.shape[0], n1, n2, block_rows, None)
    return rc, y.numpy()


def _conv_close(y, x, h):
    ref = np.fft.ifft(np.fft.fft(x.astype(np.float64), axis=-1)
                      * np.fft.fft(h.astype(np.float64))).real
    # the reference's kernel tolerance (tests/test_kernels_fftconv.py)
    assert np.abs(y - ref).max() <= 2e-4 * np.abs(ref).max()


def _conv_copied(lib):
    """Input bytes each copy path of the fused kernel's stand-in took since
    the last call."""
    return [lib["fftconv"].host_cuda_bytes_copied(k)
            for k in (COPY4, BULK, TILE)]


@pytest.mark.parametrize("factors", [(8, 8), (16, 32), (5, 7), (11, 13),
                                     (128, 1), (1, 127), (8, 16), (6, 10),
                                     (128, 128)])
@pytest.mark.parametrize("batch", [5, 6])
@pytest.mark.parametrize("block_rows", [1, 8])
def test_fftconv_source_matches_numpy(lib, factors, batch, block_rows):
    x, h = _conv_inputs(batch, factors[0] * factors[1])
    rc, y = _fused(lib, x, h, factors, block_rows)
    assert rc == 0
    _conv_close(y, x, h)


# Persistent CTAs: the stand-in reports 2 SMs of one CTA, so BIG pairs of
# rows (128 x 128) are walked two CTAs at a time, an odd batch leaving the
# last pair's second row (and its TMA boxes) out; 151 rows of 512 are five
# batches of 16 pairs (the last of 23 rows), three through one CTA's two
# stages.
@pytest.mark.parametrize("factors,rows,path", [((128, 128), 5, TILE),
                                               ((128, 128), 6, TILE),
                                               ((32, 16), 151, BULK)])
def test_fftconv_source_persistent_ctas(lib, factors, rows, path):
    x, h = _conv_inputs(rows, factors[0] * factors[1])
    _conv_copied(lib)
    rc, y = _fused(lib, x, h, factors)
    assert rc == 0
    # every input byte came in once, by the path the shape takes
    want = [0, 0, 0]
    want[path] = x.size * 4
    assert _conv_copied(lib) == want
    _conv_close(y, x, h)


# The fused kernel's other copy paths: an input one float off 16-byte
# alignment, n2 (BIG) or n (short rows) not a multiple of 4 take 4-byte
# copies. (96, 100) takes TMA boxes with a last group of 36 columns (a box
# of 32 columns, 4 of them in the row, and an empty tile) and a pair with
# no second row; (127, 65) a generic radix-127 DFT_n1 of one pass that
# reads the ring and multiplies by T, and a generic radix-13 middle in
# shared-memory passes; (25, 40) an 8 x 5 middle in shared-memory passes;
# (16, 64) a 16 x 4 middle in registers.
@pytest.mark.parametrize("factors,rows,offset,path", [
    ((128, 128), 3, 1, COPY4), ((32, 16), 37, 1, COPY4),
    ((127, 65), 3, 0, COPY4), ((96, 100), 3, 0, TILE),
    ((7, 3), 701, 0, COPY4), ((25, 40), 33, 0, BULK),
    ((16, 64), 9, 0, BULK)])
def test_fftconv_source_staging_paths(lib, factors, rows, offset, path):
    x, h = _conv_inputs(rows, factors[0] * factors[1])
    _conv_copied(lib)
    rc, y = _fused(lib, x, h, factors, offset=offset)
    assert rc == 0
    _conv_close(y, x, h)
    copied = _conv_copied(lib)
    assert [c > 0 for c in copied] == [k == path for k in range(3)]
    # a box covers whole tiles; the others copy each input byte once
    assert copied[path] == x.size * 4 or (
        path == TILE and copied[path] > x.size * 4)


def test_fftconv_source_matches_reference_kernel(lib):
    # the reference's fftconv_fused (Pallas, interpret mode) on the same
    # rows and filter, batch 5: an odd batch, the last pair half empty
    factors = (16, 32)
    x, h = _conv_inputs(5, factors[0] * factors[1])
    rc, y = _fused(lib, x, h, factors)
    assert rc == 0
    theirs = np.asarray(jax_fftconv_fused(jnp.asarray(x), jnp.asarray(h),
                                          factors))
    assert np.abs(y - theirs).max() <= 2e-4 * np.abs(theirs).max()
