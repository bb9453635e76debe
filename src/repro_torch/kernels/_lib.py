"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
go to ``build/kernels/`` at the repository root, named by a hash of their
sources (the ``.cu`` and every ``.cuh``), each with its nvcc / ptxas log
beside it, and are built at first use;
:func:`build_all` starts every build at once.  A :class:`Kernel` counts
its launches: ``launches`` grows by one for each successful launch of the
kernel from Python, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return found


class Kernel:
    """One CUDA source file: its library, its C functions and a launch count."""

    def __init__(self, name: str, functions: dict[str, tuple]):
        self.name = name
        self.functions = functions      # C name -> argtypes
        self.launches = 0
        self.build_log = ""
        self._lib = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def library_path(self) -> Path:
        """Named by a hash of the source and every header under ``CSRC``,
        so a changed header rebuilds every library."""
        h = hashlib.sha256()
        for f in (self.source, *sorted(CSRC.glob("*.cuh"))):
            h.update(f.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> tuple | None:
        """Start nvcc for this source unless its library exists (then
        ``build_log`` is the log kept beside it); the output lands under a
        temporary name and is renamed when complete."""
        out = self.library_path()
        if out.exists():
            log = out.with_suffix(".log")
            self.build_log = log.read_text() if log.exists() else ""
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        return proc, tmp, out

    def finish_build(self, build: tuple | None) -> None:
        if build is None:
            return
        proc, tmp, out = build
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{self.build_log}")
        out.with_suffix(".log").write_text(self.build_log)
        os.replace(tmp, out)

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call C function ``fn`` (which launches on the current stream and
        returns its cudaError_t); raise on a refused launch, else count it."""
        lib = self.lib()
        code = getattr(lib, fn)(*args)
        if code != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {code}: "
                               f"{lib.error_string(code).decode()}")
        self.launches += 1


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


SCALE_SEARCH = Kernel("scale_search", {
    # wp, wb, amax, alphas, out, I, O, bs, n_cand, qmax, qmax_recip, stream
    "sweep_partials": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P)})
FP8_QUANT = Kernel("fp8_quant", {
    # w, alpha, q, scales, I, O, bs, instance, qmax, qmax_recip, stream
    "quantize_fp8": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P)})
FP8_MATMUL = Kernel("fp8_matmul", {
    # x, w, scales, y, scratch, M, K, N, bs, splits, kb_per_split, x_dtype, stream
    "matmul_fp8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)})
FP8_MATMUL_WGMMA = Kernel("fp8_matmul_wgmma", {
    # x, w, scales, y, M, K, N, bs, x_f16, stream
    "matmul_fp8_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)})
FP8_MATMUL_DECODE = Kernel("fp8_matmul_decode", {
    # x, w, scales, y, scratch, M, K, N, bs, x_f16, bn, splits, kb_per_split, stream
    "matmul_fp8_decode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)})

KERNELS = (SCALE_SEARCH, FP8_QUANT, FP8_MATMUL, FP8_MATMUL_WGMMA, FP8_MATMUL_DECODE)


def build_all() -> None:
    """Build every kernel library, one nvcc process per source, all at once."""
    builds = [(k, k.start_build()) for k in KERNELS]
    for k, build in builds:
        k.finish_build(build)
    for k in KERNELS:
        k.lib()


def require_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}, expected a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError("kernel input must be contiguous")
