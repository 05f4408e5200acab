"""Builds the native shared-memory transports for the port.

The JAX package binds ``native/ingest/ingest.cc`` (the trajectory ingest
ring) and ``native/varstore/varstore.cc`` (the weight store) as
``native/build/*.so``, rebuilt there by ``make -C native``. The port
compiles the same sources itself, with the system C++ compiler and
`native/Makefile`'s flags, into a directory of its own
(``agents_tpu_torch/_native_build``, which git ignores): on first use, and
again when the source is newer than the library. It never runs make,
never writes ``native/build/`` and never loads the prebuilt libraries
there; a failed build raises.

The port's CUDA kernels (``agents_tpu_torch/csrc/*.cu``, plain C
interfaces loaded with `ctypes`) build the same way with `nvcc` for the
H100 (`build_cuda_library`), linked against the shared CUDA runtime so
that the profiler sees their launches.

Several processes may build at once (test workers, a learner and its
collectors): the build holds an exclusive lock on a file in the build
directory, compiles to a temporary name and renames it into place, so a
process sees either no library or a whole one.
"""
from __future__ import annotations

import fcntl
import os
import shutil
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(REPO, "native")
CSRC_DIR = os.path.join(REPO, "agents_tpu_torch", "csrc")
BUILD_DIR = os.path.join(REPO, "agents_tpu_torch", "_native_build")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
LINK_FLAGS = ("-lrt", "-pthread")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared")


def _fresh(library: str, source: str) -> bool:
  return (os.path.exists(library)
          and os.path.getmtime(library) >= os.path.getmtime(source))


def _build(name: str, source: str, command) -> str:
  """``libagents_tpu_<name>.so`` in `BUILD_DIR`, compiled from `source` by
  ``command(output_path)`` unless it is there and not older than the
  source; under the lock file ``<name>.lock``, written to a temporary name
  and renamed into place."""
  library = os.path.join(BUILD_DIR, f"libagents_tpu_{name}.so")
  if _fresh(library, source):
    return library
  os.makedirs(BUILD_DIR, exist_ok=True)
  with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)
    if _fresh(library, source):   # another process built it meanwhile
      return library
    tmp = f"{library}.{os.getpid()}.tmp"
    try:
      out = subprocess.run(command(tmp), capture_output=True, text=True)
      if out.returncode != 0:
        raise RuntimeError(f"building {library} from {source} failed "
                           f"(exit {out.returncode}):\n{out.stderr}")
      os.replace(tmp, library)
    finally:
      if os.path.exists(tmp):
        os.remove(tmp)
  return library


def build_library(name: str) -> str:
  """The path of ``libagents_tpu_<name>.so`` built from
  ``native/<name>/<name>.cc`` into `BUILD_DIR`, compiling it if it is
  missing or older than its source. Raises `RuntimeError` if the compiler
  fails."""
  source = os.path.join(NATIVE_DIR, name, f"{name}.cc")
  return _build(name, source,
                lambda out: ["g++", *CXX_FLAGS, "-o", out, source,
                             *LINK_FLAGS])


def nvcc() -> str:
  """The CUDA compiler: `nvcc` on the PATH, else under ``$CUDA_HOME`` (by
  default ``/usr/local/cuda``)."""
  return shutil.which("nvcc") or os.path.join(
      os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build_cuda_library(name: str) -> str:
  """The path of ``libagents_tpu_<name>.so`` built from
  ``agents_tpu_torch/csrc/<name>.cu`` with `nvcc` for sm_90a into
  `BUILD_DIR`, as `build_library` builds (the runtime's directory is the
  library's run path). Raises `RuntimeError` if the compiler fails."""
  source = os.path.join(CSRC_DIR, f"{name}.cu")
  compiler = nvcc()
  runtime = os.path.join(os.path.dirname(os.path.dirname(compiler)), "lib64")
  return _build(name, source,
                lambda out: [compiler, *NVCC_FLAGS, "-Xlinker",
                             f"-rpath,{runtime}", "-o", out, source])
