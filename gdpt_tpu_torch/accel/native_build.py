"""Build the package's native sources (csrc/) at first use.

One compiler run per source, into build/gdpt_tpu_torch/ of the checkout,
under a file name keyed by a hash of the source, the headers of csrc/
that it includes and the flags, so a source, header or flag change
rebuilds and an unchanged one is reused. Nothing
is built when a module is imported. A failure raises: no caller catches
it to carry on without the library. load opens a library with ctypes in
the program span native.load; BUILDS counts the builds run and reused.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from gdpt_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gdpt_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared"]

BUILDS = profiling.counter_group("native_build.builds", {"built": 0, "reused": 0})


def nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return path


def cxx_name():
    return os.environ.get("CXX", "g++")


def gxx():
    path = shutil.which(cxx_name())
    if path is None:
        raise RuntimeError(f"{cxx_name()} not found on PATH (set CXX to a C++17 compiler)")
    return path


def _flags(src):
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS


def library_path(source) -> Path:
    """Where csrc/<source> is built to: the name hashes the source, the
    headers of csrc/ it names in an #include "..." line, theirs in turn,
    and the flags."""
    src = CSRC / source
    text = src.read_bytes()
    seen, todo = set(), [text]
    while todo:
        for name in sorted(set(re.findall(rb'^#include "([^"]+)"', todo.pop(), re.M)) - seen):
            seen.add(name)
            todo.append((CSRC / name.decode()).read_bytes())
            text += todo[-1]
    key = hashlib.sha256(text + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{key}.so"


def build(source, verbose=False) -> Path:
    """Compile csrc/<source> (.cu with nvcc, .cpp with g++) unless this
    source with these flags was built before; returns the library path."""
    src = CSRC / source
    cuda = src.suffix == ".cu"
    flags = _flags(src)
    out = library_path(source)
    if out.exists():
        BUILDS["reused"] += 1
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc() if cuda else gxx(), *flags,
           *(["-Xptxas", "-v"] if cuda and verbose else []), "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}) on {source}:\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    BUILDS["built"] += 1
    return out


def load(source):
    """csrc/<source>'s library (build) opened with ctypes."""
    with profiling.span("native.load"):
        return ctypes.CDLL(str(build(source)))


def build_all(sources, verbose=False):
    """Build several sources at once, one compiler process each."""
    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(lambda s: build(s, verbose), sources))
