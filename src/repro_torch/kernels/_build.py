"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Every ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` with a plain C interface, and the objects are
linked into one shared library under ``build/`` at the repository root.
The compilers' output (``ptxas -v``: registers, stack and spills of every
kernel) is kept beside it, as ``libreprotorch_<hash>.log``.
The library is named by a hash of the flags and of every file under
``csrc/`` (the shared ``*.cuh`` headers too), so a changed source or
header builds anew and an unchanged tree loads the existing file. It is
loaded with ``ctypes``; every pointer and the stream travel as
``c_void_p``. The build runs at first use, from a kernel wrapper that
was handed a CUDA tensor, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")
# dynamic shared memory one CTA may use on Hopper (227 KB)
SMEM_MAX = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "repro_fft_fourstep": (_P, _P, _P, _P, _L, _I, _I, _P),
    "repro_fft_mixed": (_P, _P, _P, _P, _P, _L, _L, _P, _I, _P),
    "repro_fft_cluster": (_P, _P, _P, _P, _L, _L, _P, _I, _P),
    "repro_fft_bluestein": (_P, _P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _P,
                            _I, _P),
    "repro_fft_tile": (_P, _P, _P, _P, _P, _L, _P, _P, _P, _I, _P),
    "repro_fft_fourstep_axis": (_P, _P, _P, _P, _P, _L, _I, _I, _L, _I,
                                _P),
    "repro_fft_stockham": (_P, _P, _P, _P, _I, _I, _I, _P),
    "repro_fft_stockham_axis": (_P, _P, _P, _P, _L, _I, _L, _I, _P),
    "repro_bandpass": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P),
    "repro_bandpass_ctas_per_sm": (_I,),
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              *(_L,) * 12, _I, _F, _F, _I, _P),
}

_LIB = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _digest(csrc: Path) -> str:
    """Hash of the flags and of every file under ``csrc``, in path order."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(f.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash has no library yet); return the
    library's path."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / f"libreprotorch_{_digest(CSRC)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s.name, log) for s, p, log in zip(sources, procs, logs)
                  if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        log = Path(tmp) / "nvcc.log"
        log.write_text("".join(f"--- {s.name}\n{text}"
                               for s, text in zip(sources, logs)))
        os.replace(log, lib.with_suffix(".log"))
        out = Path(tmp) / lib.name
        res = subprocess.run([nvcc, ARCH, "-shared", "-o", str(out),
                              *map(str, objs)], capture_output=True,
                             text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(out, lib)          # atomic: concurrent builds agree
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(code: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code:
        text = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code}: {text}")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check_planes(kernel: str, *tensors, ndim: int = 2) -> None:
    """What the kernels take: CUDA float32 row-major planes of ``ndim``
    dimensions, all of one shape and on one device."""
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{kernel}: tensors must share one CUDA "
                             f"device, got {t.device} and {first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: float32 planes required, got "
                            f"{t.dtype}")
        if t.dim() != ndim or t.shape != first.shape:
            raise ValueError(f"{kernel}: {ndim}-D planes of one shape "
                             f"required, got {tuple(t.shape)} and "
                             f"{tuple(first.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: contiguous planes required")
    if first.numel() == 0:
        raise ValueError(f"{kernel}: empty planes {tuple(first.shape)}")


def check_block(kernel: str, block: int, name: str = "block_b") -> None:
    """The reference's TPU block hint must be a positive int."""
    if not isinstance(block, int) or block < 1:
        raise ValueError(f"{kernel}: {name} must be a positive int, got "
                         f"{block!r}")
