"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``*.cu`` source is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``; pointers and
the stream cross as ``c_void_p``.  Nothing is built when a module is
imported: ``load(name)`` builds on first use, and ``build()`` starts one
``nvcc`` per source, all at once.  Libraries land in ``_build/`` next to
this package (listed in ``.gitignore``), named by a hash of their sources
and flags so that an edited kernel is never served from a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("block_sparse", "block_sparse_col", "fused_gate_up", "paged_attention",
           "flash_attention", "batched_ffn", "quant_matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.int8: 2,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "block_sparse": {
        # x, blocks, rows, counts, scales, y, M, K, N, mb, n_experts, x_dtype,
        # w_dtype, bm, split, stream
        "bsmm_launch": ([_P] * 6 + [_I] * 9 + [_P], _I),
    },
    "block_sparse_col": {
        # x, blocks, rows, counts, scales, y, M, K, N, mb, n_experts, x_dtype,
        # w_dtype, bm, split, stream (B1's arguments)
        "bsmm_col_launch": ([_P] * 6 + [_I] * 9 + [_P], _I),
    },
    "fused_gate_up": {
        # x, gate (blocks, rows, counts, scales), up (...), y,
        # M, K, N, mb_g, mb_u, act, x_dtype, w_dtype, bm, split, n_experts, stream
        "fused_gate_up_launch": ([_P] * 10 + [_I] * 11 + [_P], _I),
    },
    "paged_attention": {
        # q, k_pages, v_pages, k_scales, v_scales, table, pos, out,
        # B, T, H, KVH, hd, P, ps, num_pages, causal, window, softcap, scale,
        # q_dtype, kv_dtype, pool_kvh, kv_off, split, stages, groups, stream
        "paged_decode_launch": ([_P] * 8 + [_I] * 10 + [_F, _F] + [_I] * 7 + [_P], _I),
        # rows, hd, ps, kv_dtype, stages, groups
        "paged_decode_smem_bytes": ([_I] * 6, ctypes.c_size_t),
    },
    "flash_attention": {
        # q, k, v, k_scale, v_scale, out, B, Sq, Sk, H, KVH, hd, causal, window,
        # scale, softcap, kv_dtype, stream
        "flash_attention_launch": ([_P] * 6 + [_I] * 8 + [_F, _F, _I, _P], _I),
    },
    "batched_ffn": {
        # x, w, b, y, M, K, N, ldx, ldw, act, x_dtype, sb, split, width, ks,
        # stream
        "batched_ffn_launch": ([_P] * 4 + [_I] * 11 + [_P], _I),
        # M, sb, ks, x_dtype
        "batched_ffn_smem_bytes": ([_I] * 4, _I),
        # split, smem
        "stream_max_clusters": ([_I] * 2, _I),
    },
    "quant_matmul": {
        # x, w_q, scales, y, M, K, N, ldx, ldw, act, x_dtype, bm, split, stream
        "quant_matmul_launch": ([_P] * 4 + [_I] * 9 + [_P], _I),
        # a_q, w_q, y, M, K, N, lda, ldw, sb, split, width, ks, stream
        "q78_matmul_launch": ([_P] * 3 + [_I] * 9 + [_P], _I),
        # M, sb, ks
        "q78_matmul_smem_bytes": ([_I] * 3, _I),
    },
}

_LIBS: dict = {}  # name -> loaded ctypes.CDLL (process-wide, like the .so itself)


def nvcc_path() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                       "toolkit is installed (CUDA_HOME or PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns {name: {"path",
    "seconds", "log"}} where ``log`` is nvcc's output (ptxas register and
    shared-memory report) and ``seconds`` 0.0 for a library already built.
    Raises RuntimeError with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        target = library_path(name)
        if target.exists():
            log = target.with_suffix(".log")
            out[name] = {"path": target, "seconds": 0.0,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, target)
    failed = []
    for name, (proc, t0, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu failed (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a reader never sees a half-written .so
        target.with_suffix(".log").write_text(log)
        out[name] = {"path": target, "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]["path"]
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        lib.repro_error_string.argtypes = [_I]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t) -> int | None:
    """Device address of a tensor for a ``c_void_p`` argument (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
