"""Build the package's native sources (csrc/) at first use.

One compiler run per source, into build/gdpt_tpu_torch/ of the checkout,
under a file name keyed by a hash of the source and the flags, so a
source or flag change rebuilds and an unchanged one is reused. Nothing
is built when a module is imported. A failure raises: no caller catches
it to carry on without the library.
"""

import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gdpt_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared"]


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


def build(source, verbose=False) -> Path:
    """Compile csrc/<source> (.cu with nvcc, .cpp with g++) unless this
    source and these flags were built before; returns the library path."""
    src = CSRC / source
    cuda = src.suffix == ".cu"
    flags = NVCC_FLAGS if cuda else GXX_FLAGS
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{key}.so"
    if out.exists():
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
    return out


def build_all(sources, verbose=False):
    """Build several sources at once, one compiler process each."""
    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(lambda s: build(s, verbose), sources))
