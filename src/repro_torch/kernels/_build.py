"""Builds the CUDA sources under ``csrc/`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``<build dir>/lib<name>.so``, a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds).  Nothing is built when this
module is imported: ``load(name)`` builds at first use, and again when the
source, or any header ``csrc/*.cuh`` (they are shared by the sources), is
newer than the library.  ``build_all()`` starts one ``nvcc`` per source at
once and waits for all of them.

The build directory is ``build/`` at the root of the checkout, or
``$REPRO_TORCH_BUILD_DIR``.  A failed build raises; nothing here falls back
to another implementation.  ``blocks_per_sm`` asks the CUDA occupancy calculator how many
blocks of a built kernel one SM holds (what the autotuner's residency
mirrors are held to).
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $PATH and /usr/local/cuda): "
        "the CUDA kernels of repro_torch are built from source and need the "
        "CUDA toolkit")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _stale(name: str) -> bool:
    """No library yet, or one older than its source or any header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    inputs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def _start(name: str, extra_flags: Sequence[str]):
    """Start nvcc for one source; returns (process, temporary, final)."""
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: another process never sees half a file
    return log


def build_all(extra_flags: Sequence[str] = (), force: bool = False
              ) -> Dict[str, str]:
    """Compile every stale source, all ``nvcc`` processes started together.
    Returns the compiler's output per source that was built."""
    with _lock:
        todo = [n for n in sources() if force or _stale(n)]
        started = [(n, *_start(n, extra_flags)) for n in todo]
        logs = {}
        for n, proc, tmp, out in started:
            logs[n] = _finish(n, proc, tmp, out)
            _libs.pop(n, None)
        return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not (CSRC / f"{name}.cu").exists():
            raise FileNotFoundError(f"no kernel source {name}.cu in {CSRC}")
        if _stale(name):
            _finish(name, *_start(name, ()))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
        return lib


# --- the occupancy of a built kernel (what the residency mirrors are held to)

_cubins: Dict[str, List[ctypes.c_void_p]] = {}


def _libcuda() -> ctypes.CDLL:
    cu = ctypes.CDLL("libcuda.so.1")
    if cu.cuInit(0) != 0:
        raise RuntimeError("cuInit failed")
    return cu


def _modules(name: str) -> List[ctypes.c_void_p]:
    """The cubins of ``lib<name>.so`` (``cuobjdump -xelf all``), loaded
    into the current context (the caller has made one, e.g. with a first
    tensor on the card)."""
    mods = _cubins.get(name)
    if mods is None:
        cu = _libcuda()
        lib = _lib_path(name).resolve()
        cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
        mods = []
        with tempfile.TemporaryDirectory() as d:
            subprocess.run([str(cuobjdump), "-xelf", "all", str(lib)],
                           cwd=d, check=True, capture_output=True)
            for cubin in sorted(glob.glob(os.path.join(d, "*.cubin"))):
                mod = ctypes.c_void_p()
                if cu.cuModuleLoad(ctypes.byref(mod), cubin.encode()) != 0:
                    raise RuntimeError(f"cuModuleLoad failed for {cubin}")
                mods.append(mod)
        _cubins[name] = mods
    return mods


def blocks_per_sm(name: str, function: str, threads: int,
                  dynamic_smem: int) -> int:
    """The blocks of ``function`` (a mangled entry of ``csrc/<name>.cu``,
    as built) one SM of the current device holds at ``threads`` threads a
    block and ``dynamic_smem`` bytes of dynamic shared memory, by the
    CUDA occupancy calculator (after allowing the kernel all the
    dynamic shared memory a block may have, as the launches do).  Needs the
    card, ``cuobjdump`` beside ``nvcc`` and a built library."""
    cu = _libcuda()
    for mod in _modules(name):
        fn = ctypes.c_void_p()
        if cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                  function.encode()) != 0:
            continue
        static = ctypes.c_int()
        cu.cuFuncGetAttribute(ctypes.byref(static), 1, fn)  # static smem
        # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
        if cu.cuFuncSetAttribute(fn, 8, 232448 - static.value) != 0:
            raise RuntimeError(f"cuFuncSetAttribute failed for {function}")
        n = ctypes.c_int()
        if cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                ctypes.byref(n), fn, threads,
                ctypes.c_size_t(dynamic_smem)) != 0:
            raise RuntimeError(f"occupancy query failed for {function}")
        return n.value
    raise KeyError(f"no function {function} in lib{name}.so")
