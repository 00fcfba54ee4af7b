"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``.  All sources build in parallel, one ``nvcc`` each, the first
time any kernel is asked for; libraries land in ``kernels/build/`` (listed
in ``.gitignore``) under a name that carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is needed only once a kernel is launched on a card.

:data:`LAUNCHES` counts the launches of each kernel: :func:`launch` adds one
after each successful launch, and only the kernel wrappers call it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C entry point of every source: name -> (symbol, argtypes).  Each entry
#: returns its cudaGetLastError() as an int.
ENTRY_POINTS = {
    "cubic_solve": ("cubic_solve_launch",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _P]),
    "topk_compress": ("topk_compress_launch", [_P, _P, _P, _I, _I, _I, _P]),
    "krum_scores": ("krum_scores_launch", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "sort_workers": ("sort_workers_launch", [_P, _P, _I, _I, _P]),
    "topk_sharded": ("topk_sharded_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _P]),
    "sparse_agg": ("sparse_agg_launch", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "rmsnorm": ("rmsnorm_launch", [_P, _P, _P, _I, _I, _F, _I, _I, _I, _P]),
    "flash_attention": ("flash_attention_launch",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
LAUNCHES: dict[str, int] = {name: 0 for name in ENTRY_POINTS}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, one ``nvcc`` per
    source, all started together; raise with the compiler's output if any
    fails.  Returns the library path of every kernel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in ENTRY_POINTS}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            # atomic: a concurrent build never sees half a file
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all kernels on first
    use), with its entry point's argtypes and restype declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, path in paths.items():
                cdll = ctypes.CDLL(str(path))
                symbol, argtypes = ENTRY_POINTS[n]
                fn = getattr(cdll, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _libs[n] = cdll
            lib = _libs[name]
        return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point and raise on a CUDA error."""
    symbol, _ = ENTRY_POINTS[name]
    err = getattr(library(name), symbol)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
