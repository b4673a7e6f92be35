"""Builds the port's CUDA kernels and loads them through ctypes.

Each source under ``csrc/`` has a plain C interface, so ``nvcc`` builds
it in seconds without PyTorch's headers. The first call to
:func:`library` compiles every source, one ``nvcc`` per source, all
started together, into ``build/torch_kernels/`` at the root of the
checkout, and loads the results. A library's file name carries a hash
of its source, the ``csrc/`` headers it includes (directly or through
another header) and the flags, so a later process reuses an up-to-date
build and an edited source or header is built anew. Nothing here runs
at import: the CPU tests import every module, and a machine without a
card may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("layer_norm", "sdpa_short", "sdpa_short_bwd", "flash_attention",
           "flash_attention_bwd", "xent", "attention_block", "ffn_block",
           "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(rb'^[ \t]*#include[ \t]+"([^"]+)"', re.M)
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# per source: seconds its nvcc took in this process (0.0 when an
# up-to-date library was reused) and what ptxas reported (kept beside the
# library, so a reused one has it too)
BUILD_SECONDS: Dict[str, float] = {}
PTXAS_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built with the CUDA "
            "toolkit's nvcc (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources(name: str) -> List[bytes]:
    """The text of ``csrc/<name>.cu`` and of every ``csrc/`` header it
    includes, directly or through another header, each once, in the order
    first reached."""
    texts, seen, todo = [], set(), [f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = (CSRC / path).read_bytes()
        texts.append(text)
        todo.extend(reversed([h.decode() for h in _INCLUDE.findall(text)]))
    return texts


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for text in _sources(name):
        h.update(text)
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _build_all() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in SOURCES if not _target(n).exists()}
    procs = {}
    nvcc = nvcc_path() if todo else None
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       time.monotonic(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.monotonic() - t0
        PTXAS_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            continue
        out.with_suffix(".ptxas").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for name in SOURCES:
        BUILD_SECONDS.setdefault(name, 0.0)
        log = _target(name).with_suffix(".ptxas")
        if name not in PTXAS_LOG and log.exists():
            PTXAS_LOG[name] = log.read_text()
        _LIBS[name] = ctypes.CDLL(str(_target(name)))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building every kernel on
    the first call."""
    with _LOCK:
        if not _LIBS:
            _build_all()
        return _LIBS[name]
