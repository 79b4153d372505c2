"""Build and load the Hopper kernels: ``nvcc`` into shared libraries, bound with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use, for ``sm_90a``, into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout (listed in
``.gitignore``); the hash covers the sources and flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is. Each source has a plain C
interface and includes no PyTorch header, so a build takes seconds, and
:func:`build_all` starts one ``nvcc`` per source, all at once.

Every C entry point takes its pointers and the stream as ``void*`` and returns
``cudaGetLastError()``; :func:`check` turns a non-zero return into an error.
A source that does not compile or load, and a launch that fails, raise
:class:`KernelError`; :func:`is_device_fault` tells those, the card's own
errors and every error raised inside this package (a wrapper refusing its
input included) apart from everything else, so that the engine's fallbacks
(the exhaustive scan behind the banded prefilter) never hide them. Nothing
here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, List, Sequence

__all__ = ["SOURCES", "NVCC_FLAGS", "KernelError", "build_all", "check", "is_device_fault",
           "library", "require_cuda", "stream_handle"]

_PACKAGE = pathlib.Path(__file__).resolve().parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("sketch_build", "popcount_sim", "topk_stream", "count_bins", "rebucket",
           "band_hash", "hash_build")
# --fmad=false keeps the float epilogue free of contracted multiply-adds, so
# it rounds where the plain version does; no fast math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
_LONG = ctypes.c_longlong
_ULONG = ctypes.c_ulonglong
# argtypes of every C entry point, by library
_SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "sketch_build": {
        # bins, B, P, n_bins, W, rows_per_block, smem_bytes, vec_in, vec_out,
        # out, stream
        "sketch_build": (_VOIDP, _INT, _INT, _INT, _INT, _INT, _LONG, _INT, _INT, _VOIDP,
                         _VOIDP),
    },
    "popcount_sim": {
        # a, b, na, nb, Q, C, W, measure, card, inv, n_bins, out, warpgroups,
        # stages, stage_steps, splits, tiles_per_split, smem_bytes, vec16, stream
        "sketch_score": (_VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT, _INT, _INT, _INT,
                         _VOIDP, _FLOAT, _INT, _VOIDP, _INT, _INT, _INT, _INT, _INT, _LONG,
                         _INT, _VOIDP),
        # blocks, iters, out, stream
        "mma_b1_loop": (_INT, _INT, _VOIDP, _VOIDP),
    },
    "topk_stream": {
        # a, b, na, nb, valid, Q, C, W, measure, card, inv, n_bins, k_pad,
        # warpgroups, stages, stage_steps, splits, tiles_per_split, smem_bytes,
        # vec16, partial, stream
        "sketch_topk_partial": (_VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT, _INT,
                                _INT, _INT, _VOIDP, _FLOAT, _INT, _INT, _INT, _INT, _INT,
                                _INT, _INT, _LONG, _INT, _VOIDP, _VOIDP),
        # partial, Q, splits, k_pad, out_scores, out_ids, stream
        "sketch_topk_merge": (_VOIDP, _INT, _INT, _INT, _VOIDP, _VOIDP, _VOIDP),
    },
    "count_bins": {
        # bins, B, P, n_bins, tile, out, stream
        "count_bins": (_VOIDP, _INT, _INT, _INT, _INT, _VOIDP, _VOIDP),
    },
    "rebucket": {
        # src, B, W, n_bins, n_bins_new, W_new, out, stream
        "rebucket": (_VOIDP, _INT, _INT, _INT, _INT, _INT, _VOIDP, _VOIDP),
    },
    "band_hash": {
        # src, B, W, nb_eff, wpb, out, stream
        "band_hash": (_VOIDP, _INT, _INT, _INT, _INT, _VOIDP, _VOIDP),
    },
    "hash_build": {
        # idx, B, P, coeffs, n_bins, recip, W, rows_per_block, smem_bytes,
        # vec_in, vec_out, out, stream
        "hash_build": (_VOIDP, _INT, _INT, _VOIDP, _INT, _ULONG, _INT, _INT, _LONG, _INT,
                       _INT, _VOIDP, _VOIDP),
    },
}


class KernelError(RuntimeError):
    """A Hopper kernel did not build, did not load, or failed at launch."""


def is_device_fault(err: BaseException) -> bool:
    """True for faults no fallback may hide: a kernel's own failure, the
    card's errors (out of memory, a CUDA error surfacing in PyTorch), and any
    error raised inside this package, which holds the kernels' wrappers and
    their plain versions (a wrapper's refusal of its input is a ``ValueError``
    or ``TypeError``). A degradation path re-raises these and handles only the
    rest."""
    if isinstance(err, KernelError):
        return True
    import torch

    if isinstance(err, (torch.cuda.OutOfMemoryError,
                        getattr(torch, "AcceleratorError", torch.cuda.OutOfMemoryError))):
        return True
    if isinstance(err, RuntimeError) and "CUDA error" in str(err):
        return True
    tb = err.__traceback__
    while tb is not None:
        if pathlib.Path(tb.tb_frame.f_code.co_filename).resolve().parent == _PACKAGE:
            return True
        tb = tb.tb_next
    return False


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _inputs(name: str) -> List[pathlib.Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _inputs(name):
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns the
    process (or None) and the library path."""
    out = _target(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return (proc, tmp), out


def _finish(name: str, started, out: pathlib.Path) -> None:
    if started is None:
        return
    proc, tmp = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                          f"{stderr}{stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every missing library, one nvcc per source in parallel."""
    started = {n: _start(n) for n in SOURCES}
    for n, (proc, out) in started.items():
        _finish(n, proc, out)
    return {n: out for n, (_, out) in started.items()}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    proc, out = _start(name)
    _finish(name, proc, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise KernelError(f"cannot load {out.name}: {e}") from e
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a CUDA error code."""
    if err != 0:
        name = lib.cuda_error_string(err).decode(errors="replace")
        raise KernelError(f"{what}: CUDA error {err} ({name}) at launch")


def require_cuda(t, what: str) -> None:
    """The kernels take CUDA tensors only: a wrapper runs a CPU tensor through
    its plain version and hands anything else here, where it is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: kernel needs a CUDA tensor, got device {t.device}")


def stream_handle(t) -> int:
    """PyTorch's current stream on the tensor's device, as the C side's void*
    (the raw handle: no ``torch.cuda.Stream`` object is made for it)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
