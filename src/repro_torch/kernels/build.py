"""Build and load the CUDA kernels: ``nvcc`` + ``ctypes``, no PyTorch headers.

Every ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so``,
where the hash covers all sources and headers under ``csrc/`` and the
compiler flags, so an edited source never loads a stale library.  The
sources expose a plain C interface (``extern "C"`` launchers taking raw
pointers, sizes and a stream), which keeps a build to seconds; pointers
come from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``.

Nothing here runs at import: the first kernel launch on a CUDA tensor
calls :func:`load`, which compiles what is missing.  :func:`build_all`
compiles every source at once, one ``nvcc`` process each, started
together.  The build directory is ``build/repro_torch`` at the root of the
source tree (beside ``src/``).

Whatever keeps a kernel from running on its GPU — no such device, no
compiler, a failed build, a library that does not load, a refused launch
— raises :class:`KernelError`.  The retry and fallback layers of the
service re-raise it untouched: a kernel that cannot run is never answered
for by its plain version, by another backend or by the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = [
    "KernelError", "NVCC_FLAGS", "KERNEL_SOURCES",
    "build_dir", "build_all", "load", "nvcc_path",
]


class KernelError(RuntimeError):
    """A GPU kernel cannot run: its device, compiler, build, library or
    launch failed.  Never contained, retried or degraded by a caller."""


CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

# IEEE division and square root are nvcc's defaults; no --use_fast_math, and
# no fused multiply-add, so the kernels round like their plain versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

KERNEL_SOURCES = ("mcop_sw", "mcop_fused", "mcop_phase", "flash_attention", "mamba_scan",
                  "flash_attention_bwd", "mamba_scan_bwd", "decode_attention")

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``PATH``, or the
    toolkit's usual place.  Raises if there is none — a kernel cannot be
    built without it, and nothing falls back to the plain version."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the repro_torch kernels are compiled from source at first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> pathlib.Path:
    return build_dir() / f"{name}-{_source_hash()}.so"


def _start(name: str, extra_flags: tuple[str, ...] = ()):
    """Start one nvcc for ``csrc/<name>.cu``; returns (process, tmp, final)."""
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise KernelError(f"kernel source missing: {src}")
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, proc, tmp: pathlib.Path, out: pathlib.Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return log


def build_all(*, verbose_ptxas: bool = False) -> dict:
    """Compile every kernel source that has no up-to-date library.

    One ``nvcc`` per source, all started together.  Returns
    ``{"seconds": wall time, "built": [names], "log": {name: compiler output}}``;
    with ``verbose_ptxas`` the log holds each kernel's registers, shared
    memory and spills (``-Xptxas -v``) and everything is rebuilt.
    """
    t0 = time.perf_counter()
    extra = ("-Xptxas", "-v") if verbose_ptxas else ()
    started = []
    for name in KERNEL_SOURCES:
        if verbose_ptxas or not _lib_path(name).is_file():
            started.append((name, *_start(name, extra)))
    logs = {name: _finish(name, proc, tmp, out) for name, proc, tmp, out in started}
    return {
        "seconds": time.perf_counter() - t0,
        "built": [name for name, *_ in started],
        "log": logs,
    }


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.is_file():
            _finish(name, *_start(name))
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as err:
            raise KernelError(f"cannot load {path}: {err}") from err
        _LIBS[name] = lib
    return lib
