"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a``. All of them are built in
one go, one ``nvcc`` process per source started together, at the first
call that needs any of them, into ``build/kernels/<hash>/`` at the root of
the checkout (``.gitignore`` lists ``build/``). The hash covers every
source and header and the flags, so an edited source builds afresh and an
unchanged one is reused. ``nvcc``'s ``-Xptxas -v`` report (registers,
shared memory and spills of every kernel) goes to ``build.log`` beside the
libraries.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

from repro_torch import tracing

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                 "kernels"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# cudaError_t codes for a launch the card refuses before it runs (bad
# configuration, too many resources, an invalid value such as a shared-
# memory request above the limit): the candidate is invalid. Every other
# nonzero code is a fault.
REFUSED_LAUNCH = {1: "cudaErrorInvalidValue", 9: "cudaErrorInvalidConfiguration",
                  701: "cudaErrorLaunchOutOfResources"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a nonzero ``cudaError_t``. ``refused`` is
    True when the card declined the launch itself (the candidate cannot
    run); False for a fault, which may leave the context unusable."""

    def __init__(self, kernel: str, code: int, message: str):
        super().__init__(f"{kernel}: CUDA error {code} ({message})")
        self.kernel, self.code = kernel, code
        self.refused = code in REFUSED_LAUNCH


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build_dir() -> str:
    """Directory the current sources build into (content-hashed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_all() -> str:
    """Compile every source that has no library yet, all ``nvcc`` processes
    started together; returns the build directory. Raises with the
    compiler's output if any build fails."""
    out_dir = build_dir()
    todo = [src for src in _sources()
            if not os.path.exists(_lib_path(out_dir, src))]
    if not todo:
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    with tracing.span("kernels.compile", sources=len(todo)):
        for src in todo:
            # write to a private name, rename when done: concurrent builders
            # (test workers) never load a half-written library
            tmp = f"{_lib_path(out_dir, src)}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures, log = [], []
        for src, tmp, proc in procs:
            output, _ = proc.communicate()
            log.append(f"== {os.path.basename(src)} (rc {proc.returncode})\n"
                       f"{output}")
            if proc.returncode == 0:
                os.replace(tmp, _lib_path(out_dir, src))
            else:
                failures.append(os.path.basename(src))
    with open(os.path.join(out_dir, "build.log"), "a") as f:
        f.write("\n".join(log))
    if failures:
        raise RuntimeError(f"nvcc failed for {failures}:\n" + "\n".join(log))
    return out_dir


def _lib_path(out_dir: str, src: str) -> str:
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(out_dir, f"lib{stem}.so")


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building every
    source first if needed). Loaded once per process."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            out_dir = build_all()
            lib = ctypes.CDLL(_lib_path(out_dir, os.path.join(CSRC,
                                                              stem + ".cu")))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        return lib


def check(lib: ctypes.CDLL, kernel: str, code: int) -> None:
    """Raise :class:`KernelLaunchError` for a nonzero launch status."""
    if code:
        message = lib.kernel_error_string(code).decode()
        raise KernelLaunchError(kernel, code, message)


def build_log() -> str:
    """The ``nvcc``/``ptxas`` output of the current build ('' if none)."""
    path = os.path.join(build_dir(), "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def sass(stem: str) -> dict[str, str]:
    """The SASS of each kernel of ``lib<stem>.so`` (building first if
    needed), by mangled name, as ``cuobjdump -sass`` of the CUDA toolkit
    prints it."""
    path = _lib_path(build_all(), os.path.join(CSRC, stem + ".cu"))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    functions: dict[str, list[str]] = {}
    body = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            body = functions.setdefault(m.group(1), [])
        elif body is not None:
            body.append(line)
    return {name: "\n".join(lines) for name, lines in functions.items()}
