"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `csrc/build/lib<name>.so` (a plain C
interface, no PyTorch headers), compiled for sm_90a at first use. `build`
starts one nvcc per source, all at once, and keeps each compiler log
beside its library (`lib<name>.log`). The build directory is git-ignored; a
library older than its source, or without its log, is rebuilt. Processes
that build at once (the ranks of a distributed run) take turns on an
exclusive lock of the build directory, so that a library is built once; the
lock is released when its holder ends, whatever the way.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
# -Xptxas -v: each kernel's registers, spills and shared memory in the log
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs = {}


def sources():
    """Names of the CUDA sources (without .cu)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def lib_path(name):
    return os.path.join(BUILD_DIR, "lib{}.so".format(name))


def log_path(name):
    return os.path.join(BUILD_DIR, "lib{}.log".format(name))


def _fresh(name):
    lib = lib_path(name)
    src = os.path.join(CSRC, name + ".cu")
    return (os.path.exists(lib) and os.path.exists(log_path(name))
            and os.path.getmtime(lib) >= os.path.getmtime(src))


def build(names=None):
    """Compile the named sources (default: all), one nvcc each, in parallel.

    Returns {name: compiler log}, the kept log for a library that was
    already fresh. Raises RuntimeError naming every source that failed, with
    its compiler output."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(names)


def _build_locked(names):
    nvcc = _nvcc()
    procs, logs = {}, {}
    for name in names:
        if _fresh(name):
            with open(log_path(name)) as f:
                logs[name] = f.read()
            continue
        tmp = "{}.{}.tmp".format(lib_path(name), os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append("{} (nvcc exit {}):\n{}".format(name, proc.returncode, out))
            continue
        with open(tmp + ".log", "w") as f:
            f.write(out)
        os.replace(tmp + ".log", log_path(name))
        os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def load(name, signatures):
    """Load lib<name>.so (building it first if needed) and declare its
    functions: signatures = {fn: (restype, [argtypes])}."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib
