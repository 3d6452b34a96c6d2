"""Build and load the hand-written CUDA kernels of ``enerf_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so``, where
the hash covers the source and the flags: an unchanged source is built
once per checkout, and ``python3 chip_smoke.py`` on a fresh checkout
builds everything it needs. The library is loaded with ``ctypes``
(pointers, sizes and the stream are passed as plain integers), and each
C function is bound once (``load_function``).

Nothing here runs at import time: this module imports on a machine with
no CUDA toolkit, and only ``load_library`` / ``build_all`` need ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
KERNELS = ("cost_volume", "render", "render_l0", "depth_regression",
           "conv3d_wgrad", "layer_render")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], Callable[..., int]] = {}
BUILD_LOGS: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """A kernel could not be built or loaded; never caught in the port."""


def _nvcc_candidates() -> List[Path]:
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(Path(os.environ[var]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    return cands


def find_nvcc() -> str:
    for cand in _nvcc_candidates():
        if cand.is_file():
            return str(cand)
    raise KernelBuildError(
        "nvcc not found (looked at $CUDA_HOME/bin, $CUDA_PATH/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of enerf_tpu_torch are built "
        "from csrc/*.cu at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc; returns (process, tmp_out, final_path) or None when
    the library is already built."""
    out = _lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Build every named kernel library that is not built yet, one nvcc
    per source, all started together."""
    nvcc = find_nvcc()
    started = {n: _start(n, nvcc) for n in names}
    errors = []
    for n, s in started.items():   # wait for every nvcc before raising
        if s is not None:
            try:
                _finish(n, s)
            except KernelBuildError as e:
                errors.append(str(e))
    if errors:
        raise KernelBuildError("\n".join(errors))


def build_log(name: str) -> str:
    """nvcc's output (with ptxas' ``-v``) for kernel library ``name``, from
    this process's build or the one kept beside the built library; "" if
    neither exists."""
    if name in BUILD_LOGS:
        return BUILD_LOGS[name]
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed. Raises
    ``KernelBuildError`` when it cannot be built."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if not _lib_path(name).is_file():
        build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    _LIBS[name] = lib
    return lib


def load_function(name: str, symbol: str,
                  argtypes: Sequence[type]) -> Callable[..., int]:
    """The C function ``symbol`` of kernel library ``name``, returning an
    ``int`` (a ``cudaError_t``) and taking ``argtypes``; bound at the first
    call and cached, so a launch pays no library lookup or ``argtypes``
    set-up."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load_library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _FUNCS[(name, symbol)] = fn
    return fn


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def refuse_grad(kernel: str, plain: str, *tensors) -> None:
    """Raise when autograd would need a gradient through ``kernel``, which
    has no backward: launching it would cut the graph without a word. The
    training path calls the differentiable ``plain`` version instead."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise ValueError(
            f"the {kernel} kernel has no backward and an input requires a "
            f"gradient: call {plain} (differentiable) or run under "
            "torch.no_grad() / torch.inference_mode()")


def require(cond: bool, msg: str, *args: object) -> None:
    if not cond:
        raise ValueError(msg.format(*args))
