"""Build of the port's CUDA sources: ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded by each kernel's wrapper with
``ctypes``.  Nothing is built when a module is imported; a wrapper builds its
library at its first CUDA call.

Where the libraries go: from a source checkout (the package's parent holds
``pyproject.toml``, which no install has) into the checkout's
``build/pocket_tts_tpu_torch/``; from an install into the user's cache,
``$XDG_CACHE_HOME/pocket_tts_tpu_torch/kernels`` (``~/.cache`` when unset),
never into site-packages."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent


def _build_dir() -> Path:
    if (PKG.parent / "pyproject.toml").is_file():
        return PKG.parent / "build" / "pocket_tts_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "pocket_tts_tpu_torch" / "kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "cannot build the port's CUDA kernels")


def build(source: Path, stem: str) -> Path:
    """Compile ``source`` into ``lib<stem>_<hash>.so`` under :data:`BUILD_DIR`,
    named by the source's hash (a changed source never reuses a stale build),
    with the compiler's register and shared-memory report beside it
    (``.ptxas.txt``).  Raises if ``nvcc`` is missing or fails."""
    src = source.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{stem}_{digest}.so"
    if lib_path.exists():
        return lib_path
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"cannot make the kernel build directory {BUILD_DIR}: {e}") from e
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    lib_path.with_suffix(".ptxas.txt").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib_path)
    return lib_path
