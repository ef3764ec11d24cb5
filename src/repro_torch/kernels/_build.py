"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file becomes one shared library with a plain C
interface, compiled for ``sm_90a`` at first use into
``src/repro_torch/_build/`` (listed in ``.gitignore``).  A library's file
name carries a hash of the sources and flags, so an edited kernel is
rebuilt and a current one is loaded as it is.  :func:`build_all` compiles
every missing library at once, one ``nvcc`` process per source, and is
what ``chip_smoke.py`` calls first.  Nothing here runs at import time.

:func:`counted` is the launch counter every ``*_cuda`` wrapper of
``kernels/*.py`` carries: a launch is a call of a kernel's C entry point
that :func:`check` passed.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.runtime import telemetry

__all__ = ["SOURCES", "build_all", "load", "ptxas_report", "check", "counted", "recording",
           "by_wrapper", "tiles", "batch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("potrf", "trsm", "band_cholesky", "solve_panel", "band_solve", "selinv", "gemm",
           "band_update", "selinv_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of each library's entry points: pointers and the stream as
# c_void_p, sizes as c_int, strides as c_longlong
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "potrf": {"stiles_potrf_f32": [_P, _P, _I, _I, _P]},
    "trsm": {"stiles_trsm_f32": [_P, _P, _P, _I, _I, _I, _P]},
    "band_cholesky": {
        "stiles_band_cholesky_sweep_f32":
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "stiles_band_cholesky_partitioned_sweep_f32":
            [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P],
        "stiles_sweep_max_active_clusters": [_I, _I, _P]},
    "solve_panel": {"stiles_solve_panel_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]},
    "band_solve": {
        "stiles_band_forward_sweep_f32": [_P] * 6 + [_I] * 10 + [_P],
        "stiles_band_backward_sweep_f32": [_P] * 6 + [_I] * 10 + [_P],
        "stiles_solve_max_active_clusters": [_I, _I, _P]},
    "selinv": {"stiles_selinv_prepass_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
               "stiles_selinv_sweep_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "gemm": {"stiles_gemm_f32": [_P, _P, _P, _P, _I, _L, _L, _I, _I, _P],
             "stiles_geadd_f32": [_P, _P, _P, _L, _L, _L, _L, _I, _I, _P],
             "stiles_geadd_empty_f32": [_L, _L, _I, _I, _P],
             "stiles_cuda_versions": [_P, _P]},
    "band_update": {"stiles_band_update_f32": [_P, _P, _I, _I, _I, _L, _I, _I, _I, _P]},
    "selinv_step": {"stiles_selinv_step_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
}

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(f"-D{d}" for d in defines)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES,
              defines: Tuple[str, ...] = ()) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes started together; returns name -> library path.
    ``defines`` are preprocessor macros of a measurement build.  Raises
    with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n, defines) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {n}.cu ---\n{out}")
            continue
        paths[n].with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of a
    built library."""
    f = _lib_path(name).with_suffix(".ptxas.txt")
    return f.read_text() if f.exists() else ""


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get((name, defines))
    if lib is None:
        path = build_all([name], defines)[name]
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.stiles_error_string.argtypes = [ctypes.c_int]
        lib.stiles_error_string.restype = ctypes.c_char_p
        _loaded[name, defines] = lib
    return lib


# per thread: the C entry points check passed, by name, and the log of the
# capture being recorded (recording)
_local = threading.local()


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error; else count the call
    of ``what`` for :func:`counted`."""
    if code != 0:
        msg = lib.stiles_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
    _passed()[what] += 1


def _passed() -> Counter:
    passed = getattr(_local, "passed", None)
    if passed is None:
        passed = _local.passed = Counter()
    return passed


def counted(labels: Callable[..., dict]):
    """Decorate the wrapper ``<kernel>_cuda`` of a CUDA kernel: its
    ``launches`` attribute counts the calls that launched the kernel (that
    reached :func:`check` for ``<kernel>``; an empty input launches
    nothing).  While telemetry is on, each launch opens
    ``record_function("stiles.<kernel>")`` for a running profiler and
    counts one ``kernel.launches`` labelled ``kernel`` and ``labels(*args,
    **kwargs)`` (``t``, ``n`` the matrices or tiles it covers, ``k`` the
    panel width where there is one).  A launch into a CUDA-graph capture
    counts nothing in telemetry: the capture's :func:`recording` keeps it,
    and the graph cache counts it at each replay."""
    def wrap(fn):
        kernel = fn.__name__.removesuffix("_cuda")

        @functools.wraps(fn)
        def launch(*args, **kwargs):
            passed = _passed()
            before = passed[kernel]
            on = telemetry.enabled()
            if on and torch.autograd._profiler_enabled():
                with torch.autograd.profiler.record_function(f"stiles.{kernel}"):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if passed[kernel] == before:
                return out
            launch.launches += 1
            log = getattr(_local, "log", None)
            if log is not None:
                log[fn.__name__, _label_items(kernel, labels(*args, **kwargs))] += 1
            elif on and not (torch.cuda.is_initialized()
                             and torch.cuda.is_current_stream_capturing()):
                telemetry.inc("kernel.launches", kernel=kernel, **labels(*args, **kwargs))
            return out

        launch.launches = 0
        return launch
    return wrap


def tiles(x: torch.Tensor) -> dict:
    """``kernel.launches`` labels of a launch over the (..., t, t) tiles of
    ``x``: ``t`` and ``n`` the tiles."""
    t = x.shape[-1]
    return {"t": t, "n": x.numel() // (t * t)}


def batch(x: torch.Tensor, dims: int, **more) -> dict:
    """``kernel.launches`` labels of a launch over the matrices of ``x``,
    one a leading index before its last ``dims`` axes: ``t`` (the last
    axis's), ``n`` the matrices, and ``more`` (the panel width ``k`` where
    there is one)."""
    return {"t": x.shape[-1], "n": math.prod(x.shape[:-dims]), **more}


def _label_items(kernel: str, labels: dict) -> tuple:
    return (("kernel", kernel),) + tuple(sorted(labels.items()))


@contextlib.contextmanager
def recording():
    """Keep the counted launches this thread makes in the block, a CUDA
    graph's capture: yields a Counter of ``(wrapper name, labels)``, the
    labels ``kernel.launches``'s as ``(key, value)`` pairs."""
    log, prev = Counter(), getattr(_local, "log", None)
    _local.log = log
    try:
        yield log
    finally:
        _local.log = prev


def by_wrapper(log: Counter) -> Counter:
    """A :func:`recording`'s launches by kernel wrapper name."""
    out = Counter()
    for (name, _), n in log.items():
        out[name] += n
    return out
