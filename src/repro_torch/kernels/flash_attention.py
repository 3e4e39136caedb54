"""Flash attention on Hopper: build, bind and launch the CUDA kernels.

Replaces ``repro/kernels/flash_attention.py`` (three Pallas TPU kernels).
The kernels live in ``csrc/``: bf16 forward, dq and dk/dv on the tensor
cores in ``flash_attention_sm90.cu`` (D a multiple of 16), the f32 kernels
and bf16 at any other D on the CUDA cores in ``flash_attention.cu``, whose
C entry points pick the route by dtype and D, as ``tensor_core_route`` does
here.  Each file's header says what its kernels replace and what bounds
them on an H100.  They are compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` (one nvcc per source, run
together, then one link; the library also holds the MoE dispatch kernels
of ``csrc/moe_dispatch.cu``, bound in ``moe_dispatch.py``) into a plain-C
shared library under
``build/repro_torch_kernels/<hash of sources and flags>/`` at the
repository root, and loaded with ``ctypes``.

Each wrapper takes the kernel layout (q (B, H, Sq, D); k, v (B, KV, Sk, D),
any strides with the last dim contiguous; the tensor-core route loads
through TMA and also needs 16-byte aligned bases and strides).  A tensor on
the CPU goes to the plain version in ``kernels/ref.py``; a CUDA tensor goes
to the kernel, or the wrapper raises.  ``LAUNCHES`` counts the launches of
each kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from . import ref

NEG_INF = ref.NEG_INF
MAX_HEAD_DIM = 128

SM90_D_STEP = 16  # the tensor-core kernels take bf16 at D a multiple of this
# their kernel functions, indexed as ``flash_sm90_launch_regs`` takes them
SM90_KERNELS = ("fwd_kernel_sm90", "dkv_kernel_sm90", "dq_kernel_sm90")

SOURCES = tuple(Path(__file__).parent / "csrc" / name
                for name in ("flash_attention.cu", "flash_attention_sm90.cu", "moe_dispatch.cu"))
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
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

    One nvcc per source, all started together, then one link.  The
    compilers' output (``-Xptxas=-v``: registers, shared memory and spills
    per kernel) is kept beside the library as ``nvcc.log``.  A library whose
    tensor-core kernels are not built at the registers their setmaxnreg
    split assumes is not installed: ``check_register_split`` raises.
    While recording (``repro_torch.obs``) a compile counts ``kernels.built``
    and its seconds ``kernels.build_s``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    with obs.timed("kernels.build_s"):
        _compile(lib)
    obs.count("kernels.built")
    return lib


def _compile(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [lib.parent / f"{src.stem}.{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = lib.with_suffix(f".{tag}.so")
    if all(proc.returncode == 0 for proc in procs):
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        procs.append(link)
    (lib.parent / "nvcc.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [p for p in procs if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0].returncode}):\n" + "".join(logs)[-8000:])
    launch = ctypes.CDLL(str(tmp)).flash_sm90_launch_regs
    try:
        check_register_split(ptxas_registers("".join(logs)),
                             {name: launch(i) for i, name in enumerate(SM90_KERNELS)})
    except RuntimeError:
        tmp.unlink()
        raise
    os.replace(tmp, lib)


def ptxas_registers(log: str) -> Dict[str, int]:
    """Kernel function (mangled) -> registers a thread, from ptxas's
    ``-v`` report."""
    regs, fn = {}, ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            fn = line.split("'")[1]
        elif "Used " in line and " registers" in line:
            regs[fn] = int(line.split("Used ")[1].split()[0])
    return regs


def check_register_split(regs: Dict[str, int], launch: Dict[str, int]) -> None:
    """Each tensor-core kernel's producer warpgroup gives its registers to
    the consumers with setmaxnreg, which hands out exactly the registers a
    thread the kernel is launched with (``launch``, from its launch bounds).
    Built with fewer, the consumers' ``setmaxnreg.inc`` would wait forever;
    so every instantiation must be built at that count, or this raises."""
    for name, want in launch.items():
        found = {fn: n for fn, n in regs.items() if name in fn}
        wrong = {fn: n for fn, n in found.items() if n != want}
        if not found or wrong:
            raise RuntimeError(f"{name}: ptxas built {wrong or 'no instantiation'} registers a "
                               f"thread; its setmaxnreg split needs {want}")


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
    """Shapes, dtypes and layout the kernels take; returns B, H, KV, Sq, Sk, D.
    A DTensor raises: the custom ops' sharding rules (``kernels/ops.py``)
    hand the wrappers local shards only."""
    for t in (q, k, v, *same_as_q):
        if type(t).__name__ == "DTensor":
            raise TypeError("the flash-attention wrappers take local tensors; a DTensor "
                            "goes through the custom op repro_torch::flash_attention")
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


def tensor_core_route(dtype: torch.dtype, D: int) -> bool:
    """Whether the forward, dq and dk/dv run the tensor-core kernels (bf16,
    D a multiple of ``SM90_D_STEP``) or the SIMT ones; the C entry points
    switch on the same rule."""
    return dtype == torch.bfloat16 and D % SM90_D_STEP == 0


def _check_tma(**tensors: torch.Tensor) -> None:
    """The tensor-core route loads these through TMA tensor maps: each base
    address and each stride of a dim longer than 1 must be a multiple of 16
    bytes.  Raises; never copies."""
    for name, t in tensors.items():
        item = t.element_size()
        bad = t.data_ptr() % 16 or any(s * item % 16 for s, n in zip(t.stride()[:3], t.shape[:3])
                                       if n > 1)
        if bad:
            raise ValueError(f"{name}: the tensor-core kernels load it through TMA, which needs "
                             f"a 16-byte aligned base and 16-byte multiple strides; got address "
                             f"{t.data_ptr():#x}, strides {t.stride()} ({item} B elements)")


def _strides(*ts: torch.Tensor) -> ctypes.Array:
    """(batch, head, seq) element strides of each tensor; a dim of length 1
    gets the stride D, since any stride indexes it and TMA wants one aligned."""
    vals = [s if n > 1 else t.shape[-1] for t in ts for s, n in zip(t.stride()[:3], t.shape[:3])]
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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,H,Sq,D) in q's dtype and strides, lse (B,H,Sq) f32);
    scores scaled by ``scale`` (None: 1/sqrt(D))."""
    B, H, KV, Sq, Sk, D = _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return ref.attention_with_lse_ref(q, k, v, causal=causal, scale=scale)
    code = _check_cuda(q, k, v)
    if tensor_core_route(q.dtype, D):
        _check_tma(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_fwd", code, _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse),
                _strides(q, k, v, out), B, H, KV, Sq, Sk, D, int(causal),
                ref.softmax_scale(D, scale), ctypes.c_void_p(stream))
    return out, lse


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, do: torch.Tensor, causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """dq (B,H,Sq,D) in q's dtype and strides; deterministic (no atomics)."""
    B, H, KV, Sq, Sk, D = _check_inputs(q, k, v, do)
    if q.device.type == "cpu":
        return ref.attention_bwd_dq_ref(q, k, v, lse, delta, do, causal=causal, scale=scale)
    code = _check_cuda(q, k, v, do)
    if tensor_core_route(q.dtype, D):
        _check_tma(q=q, k=k, v=v, do=do)
    _check_stats(lse, B, H, Sq, q.device)
    _check_stats(delta, B, H, Sq, q.device)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_bwd_dq", code, _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                _ptr(delta), _ptr(dq), _strides(q, k, v, do, dq),
                B, H, KV, Sq, Sk, D, int(causal), ref.softmax_scale(D, scale),
                ctypes.c_void_p(stream))
    return dq


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, do: torch.Tensor, causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) on the KV heads, in k's dtype and strides.

    Unlike the reference, k and v are not expanded to full heads first: the
    kernel sums each head group in registers, which equals the reference's
    fold (``repro/kernels/ops.py:55-58``).
    """
    B, H, KV, Sq, Sk, D = _check_inputs(q, k, v, do)
    if q.device.type == "cpu":
        return ref.attention_bwd_dkv_ref(q, k, v, lse, delta, do, causal=causal, scale=scale)
    code = _check_cuda(q, k, v, do)
    if tensor_core_route(q.dtype, D):
        _check_tma(q=q, k=k, v=v, do=do)
    _check_stats(lse, B, H, Sq, q.device)
    _check_stats(delta, B, H, Sq, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_bwd_dkv", code, _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                _ptr(delta), _ptr(dk), _ptr(dv), _strides(q, k, v, do, dk, dv),
                B, H, KV, Sq, Sk, D, int(causal), ref.softmax_scale(D, scale),
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
    dlse: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recompute backward: (dq, dk, dv), dk/dv on the KV heads.

    ``delta = rowsum(do∘out)`` is a torch op, as in the reference.  A
    cotangent of lse, ``dlse`` (B, H, Sq), enters as ``delta − dlse``: with
    ``ds = p·(dp − delta)``, that adds ``dlse·p`` to ds, lse's derivative.
    """
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} does not match q {tuple(q.shape)}")
    delta = ref.row_delta(out, do)
    if dlse is not None:
        delta = (delta - dlse).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, lse, delta, do, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal, scale)
    return dq, dk, dv
