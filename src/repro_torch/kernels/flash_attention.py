"""Flash attention on Hopper: build, bind and launch the CUDA kernels.

Replaces ``repro/kernels/flash_attention.py`` (three Pallas TPU kernels).
The kernels live in ``csrc/flash_attention.cu``; its header says what each
one replaces and what bounds it on an H100.  They are compiled at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a plain-C shared
library under ``build/repro_torch_kernels/<hash of sources and flags>/``
at the repository root, and loaded with ``ctypes``.

Each wrapper takes the kernel layout (q (B, H, Sq, D); k, v (B, KV, Sk, D),
any strides with the last dim contiguous).  A tensor on the CPU goes to the
plain version in ``kernels/ref.py``; a CUDA tensor goes to the kernel, or
the wrapper raises.  ``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

from . import ref

NEG_INF = ref.NEG_INF
MAX_HEAD_DIM = 128

SOURCES = (Path(__file__).parent / "csrc" / "flash_attention.cu",)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

#: launches of each kernel since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ------------------------------------------------------------------- build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the flash-attention kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the library for the current sources and flags is built."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libflash_attention.so"


def build() -> Path:
    """Compile the kernels if this version of the sources is not built yet.

    The compiler's output (``-Xptxas=-v``: registers and shared memory per
    kernel) is kept beside the library as ``nvcc.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i] * 7 + [f, p]  # B, H, KV, Sq, Sk, D, causal, scale, stream
    lib.flash_fwd.argtypes = [i, p, p, p, p, p, p] + tail
    lib.flash_bwd_dq.argtypes = [i, p, p, p, p, p, p, p, p] + tail
    lib.flash_bwd_dkv.argtypes = [i, p, p, p, p, p, p, p, p, p] + tail
    for name in KERNELS:
        getattr(lib, name).restype = ctypes.c_int
    return lib


# ------------------------------------------------------------------ checks


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *same_as_q: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """Shapes, dtypes and layout the kernels take; returns B, H, KV, Sq, Sk, D."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,Sq,D), k/v (B,KV,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    for t in same_as_q:
        if t.shape != q.shape:
            raise ValueError(f"expected shape {tuple(q.shape)}, got {tuple(t.shape)}")
    if min(Sq, Sk) < 1 or D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"need S >= 1 and D a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}; got Sq={Sq} Sk={Sk} D={D}")
    return B, H, KV, Sq, Sk, D


def _check_cuda(*ts: torch.Tensor) -> int:
    """All on one CUDA device, one supported dtype, last dim contiguous."""
    dev, dt = ts[0].device, ts[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}")
    if dt not in _DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16, got {dt}")
    for t in ts:
        if t.device != dev or t.dtype != dt:
            raise ValueError("q, k, v (and out, do) must share device and dtype")
        if t.stride(-1) != 1:
            raise ValueError("the last dim of every input must be contiguous")
    return _DTYPE_CODES[dt]


def _check_stats(t: torch.Tensor, B: int, H: int, Sq: int, dev: torch.device) -> None:
    if (t.shape != (B, H, Sq) or t.dtype != torch.float32 or t.device != dev
            or not t.is_contiguous()):
        raise ValueError("lse/delta must be contiguous float32 (B, H, Sq) on "
                         "the inputs' device")


def _strides(*ts: torch.Tensor) -> ctypes.Array:
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(name: str, *args) -> None:
    err = getattr(_library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


# --------------------------------------------------------------- wrappers


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,H,Sq,D) in q's dtype and strides, lse (B,H,Sq) f32)."""
    B, H, KV, Sq, Sk, D = _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return ref.attention_with_lse_ref(q, k, v, causal=causal)
    code = _check_cuda(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_fwd", code, _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse),
                _strides(q, k, v, out), B, H, KV, Sq, Sk, D, int(causal),
                1.0 / math.sqrt(D), ctypes.c_void_p(stream))
    return out, lse


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, do: torch.Tensor, causal: bool = True,
) -> torch.Tensor:
    """dq (B,H,Sq,D) in q's dtype and strides."""
    B, H, KV, Sq, Sk, D = _check_inputs(q, k, v, do)
    if q.device.type == "cpu":
        return ref.attention_bwd_dq_ref(q, k, v, lse, delta, do, causal=causal)
    code = _check_cuda(q, k, v, do)
    _check_stats(lse, B, H, Sq, q.device)
    _check_stats(delta, B, H, Sq, q.device)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_bwd_dq", code, _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                _ptr(delta), _ptr(dq), _strides(q, k, v, do, dq),
                B, H, KV, Sq, Sk, D, int(causal), 1.0 / math.sqrt(D),
                ctypes.c_void_p(stream))
    return dq


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, do: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) on the KV heads, in k's dtype and strides.

    Unlike the reference, k and v are not expanded to full heads first: the
    kernel sums each head group in registers, which equals the reference's
    fold (``repro/kernels/ops.py:55-58``).
    """
    B, H, KV, Sq, Sk, D = _check_inputs(q, k, v, do)
    if q.device.type == "cpu":
        return ref.attention_bwd_dkv_ref(q, k, v, lse, delta, do, causal=causal)
    code = _check_cuda(q, k, v, do)
    _check_stats(lse, B, H, Sq, q.device)
    _check_stats(delta, B, H, Sq, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_bwd_dkv", code, _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                _ptr(delta), _ptr(dk), _ptr(dv), _strides(q, k, v, do, dk, dv),
                B, H, KV, Sq, Sk, D, int(causal), 1.0 / math.sqrt(D),
                ctypes.c_void_p(stream))
    return dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recompute backward: (dq, dk, dv), dk/dv on the KV heads.

    ``delta = rowsum(do∘out)`` is a torch op, as in the reference.
    """
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} does not match q {tuple(q.shape)}")
    delta = ref.row_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, lse, delta, do, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal)
    return dq, dk, dv
