"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one source ``csrc/<name>.cu`` with a plain ``extern "C"``
launcher. It is compiled for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the repository root, at first use; the file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a built one is reused. Nothing here runs when a module is
imported.

:func:`refuse_grad` is the wrappers' guard against autograd: no kernel has
a backward, as none of the JAX package's Pallas kernels has one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    install location, or ``nvcc`` on the ``PATH``."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(name: str) -> Path:
    """Compile kernel ``name`` unless it is built already; returns the
    library's path. The compiler's output (with ``-Xptxas -v``: registers,
    shared memory, spills) is kept beside the library as ``.log``."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{build_log(name)}")
    os.replace(tmp, so)
    return so


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The built library of kernel ``name`` (building it at first use),
    with ``argtypes`` set from ``signatures`` and an ``int`` return (the
    launcher's ``cudaGetLastError()``) on each named function."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def refuse_grad(kernel: str, plain: str, **tensors: torch.Tensor) -> None:
    """Raises ``RuntimeError`` when autograd would record a launch of
    ``kernel`` (grad mode on and one of ``tensors`` requiring grad). The
    kernels write into fresh tensors through ``ctypes``, so autograd would
    see a result with no ``grad_fn`` and no gradient would reach the
    inputs; ``jax.grad`` through the reference's Pallas kernels raises
    instead, and so does this. ``plain`` names the differentiable route."""
    if not torch.is_grad_enabled():
        return
    for name, t in tensors.items():
        if t.requires_grad:
            raise RuntimeError(
                f"{kernel}: {name} requires grad, and the kernel has no "
                f"backward (nor has the JAX package's Pallas kernel); "
                f"differentiate through the plain route, {plain}")
