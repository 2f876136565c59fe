"""Build and load the hand-written CUDA kernels of ``ep_tpu_torch/csrc``.

nvcc compiles every ``csrc/*.cu`` to an object file, one process per source,
all started together, and links them into one shared library with a plain C
interface, which is loaded with ``ctypes``. The library lands in
``ep_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed by a
hash of the sources and flags, so an unchanged tree reuses it and a changed
one rebuilds. Nothing is built at import: the first kernel launch builds.

Every entry point returns ``cudaGetLastError()``; :func:`call` raises when it
is not 0. Pointers and the stream go in as ``c_void_p``, sizes as ``c_int``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argument types (all return int, a cudaError_t)
SIGNATURES = {
    "ep_ln_row_stats": [_P, _P, _I, _I, _F, _P],
    "ep_ln_qkv_gemm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "ep_proj_residual_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ep_ln1_apply": [_P, _P, _P, _P, _P, _I, _I, _P],
    "ep_ln1_bwd_blocks": [_I, _I],
    "ep_ln1_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "ep_attn_core": [_P, _P, _I, _I, _I, _I, _F, _P],
    "ep_attn_core_smem_bytes": [_I, _I],
    "ep_attn_core_bwd": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "ep_attn_core_bwd_smem_bytes": [_I, _I],
    "ep_attn_flash": [_P, _P, _I, _I, _I, _I, _F, _P],
    "ep_pool": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ep_pool_smem_bytes": [_I, _I, _I, _I],
    "ep_pool_resident_clusters": [_I, _I, _I, _I],
    "ep_pool_proj": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P],
    "ep_pool_proj_smem_bytes": [_I, _I, _I],
    "ep_pool_proj_resident_clusters": [_I, _I, _I],
    "ep_mlp_int8_ln_quant": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    "ep_mlp_int8_gelu_table": [_P, _P],
    "ep_mlp_int8_gelu_table_entries": [],
    "ep_mlp_int8_gelu_check": [_P, _P, _P],
    "ep_mlp_int8_fc1": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    "ep_mlp_int8_fc2": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ep_swiglu_gate": [_P, _P, _I, _I, _P],
    "ep_lars_norms": [_P, _P, _P, _P, _I, _I, _P],
    "ep_lars_apply": [_P, _P, _P, _P, _I, _I, _F, _P],
    "ep_rope_qk": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ep_ls_residual": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); the kernels of "
                           "ep_tpu_torch/csrc are built on a machine with one")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build() -> tuple[Path, float, bool]:
    """Compile the kernels unless a library for these sources exists.

    Returns (library path, seconds spent, whether it compiled). nvcc's output,
    including ptxas' register and shared-memory report, is kept beside the
    library as ``<name>.log``. A failed build raises with that output."""
    t0 = time.perf_counter()
    lib = BUILD_DIR / f"libep_kernels_{_source_hash()}.so"
    if lib.exists():
        return lib, time.perf_counter() - t0, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(sources(), objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(" ".join(c) + "\n" + out for c, out in zip(cmds, outs))
        failed = any(p.returncode for p in procs)
        if not failed:
            tmp = Path(tmpdir) / lib.name
            link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs),
                    "-ldl"]  # hopper.cuh takes the tensor-map encoder by dlsym
            proc = subprocess.run(link, capture_output=True, text=True)
            log += " ".join(link) + "\n" + proc.stdout + proc.stderr
            failed = proc.returncode != 0
        lib.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, True


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ep_error_string.argtypes = [ctypes.c_int]
    lib.ep_error_string.restype = ctypes.c_char_p
    return lib


def call(name: str, *args) -> None:
    """Launch entry point ``name``; raise if CUDA reports an error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.ep_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def query(name: str, *args) -> int:
    """Call a size query (an entry point that launches nothing)."""
    return getattr(library(), name)(*args)


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a raw handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
