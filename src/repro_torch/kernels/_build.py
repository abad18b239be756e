"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Nothing is built when the package is imported: :func:`load` builds at
first use, and :func:`build_all` starts one ``nvcc`` per source at once.

Libraries go to ``build/repro_torch/<hash>/`` at the repository root
(listed in ``.gitignore``), keyed by a hash of the source and the
flags, so an edit always rebuilds and an unchanged source never does.

Calling convention of every C entry point: pointers and the CUDA stream
are ``void*`` (``ctypes.c_void_p``; a bare Python int would be cut to
32 bits), sizes are ``int``, and the function returns
``cudaGetLastError()`` right after its launches, which :func:`check`
turns into an exception.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("repro_torch kernels need nvcc (the CUDA toolkit) "
                       "to build csrc/*.cu; none was found")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / key[:16] / f"lib{name}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists. Returns
    ``(process, tmp_path, final_path)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)              # atomic: no half-written library
    return log


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` at once, one ``nvcc`` each. Returns
    the compiler's output per source (``-Xptxas -v``: registers, shared
    memory and spills of each kernel); empty for cached libraries."""
    started = {name: _start(name) for name in sources()}
    return {name: _finish(name, s) for name, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library with its
    ctypes signature, set once per library (setting it on every call
    costs a launch more host time than the kernel takes)."""
    lib = load(name)
    cached = _ENTRIES.get((name, symbol))
    # the library object itself is held and compared: a library swapped
    # into _LIBS never reaches a function of the one it replaced
    if cached is not None and cached[0] is lib:
        return cached[1]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    _ENTRIES[(name, symbol)] = (lib, fn)
    return fn


def on_device(device):
    """A context that makes ``device`` current, or none where it is."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(name: str, rc: int) -> None:
    """Raise if a C entry point of ``csrc/<name>.cu`` returned a CUDA
    error."""
    if rc != 0:
        msg = getattr(load(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"{msg} (cudaError {rc})")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
