"""What every CUDA kernel wrapper of the port shares.

The launch counters, the checks a wrapper makes before it hands pointers
to a kernel, and the ctypes call itself.  ``LAUNCHES`` counts kernel
launches per wrapper (one per wrapper call that reaches the card);
``PLAIN_ON_CUDA`` counts plain PyTorch versions run on CUDA tensors, so a
run can show which path the card took.  Both are keyed by the kernel's
name, in the order of the TPU kernels they replace (K1 … K8).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build

LAUNCHES = {
    "fused_cg_update": 0,
    "fused_deflate_direction": 0,
    "rbf_matvec": 0,
    "self_gram": 0,
    "recombine_blocks": 0,
    "fused_rz_reduce": 0,
    "lsmr_update": 0,
    "rbf_matvec_rect": 0,
}
PLAIN_ON_CUDA = dict.fromkeys(LAUNCHES, 0)

SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
PTR = ctypes.c_void_p
INT = ctypes.c_int
INT64 = ctypes.c_int64
DOUBLE = ctypes.c_double


@functools.lru_cache(maxsize=None)
def _entry(lib: str, name: str, dtype: torch.dtype, argtypes: tuple):
    fn = getattr(_build.load(lib), f"{name}_{SUFFIX[dtype]}")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check(name: str, like: torch.Tensor, **tensors) -> None:
    """Device, dtype, shape and layout checks shared by the wrappers."""
    if like.device.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel called on a {like.device} tensor")
    if like.dtype not in SUFFIX:
        raise TypeError(f"{name}: dtype {like.dtype} not supported (f32, f64)")
    for key, (t, shape) in tensors.items():
        if t.device != like.device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {like.device}")
        if t.dtype != like.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {like.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype on ``like``'s device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(())


def launch(lib: str, name: str, argtypes: Sequence, like: torch.Tensor, *args) -> None:
    """Call ``<name>_<f32|f64>`` of ``csrc/<lib>.cu`` on ``like``'s device
    and current stream (the stream is the last argument), count it, and
    raise on a launch error."""
    fn = _entry(lib, name, like.dtype, (*argtypes, PTR))
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def note_plain(name: str, t: torch.Tensor) -> None:
    """Count a plain version run on a CUDA tensor."""
    if t.device.type == "cuda":
        PLAIN_ON_CUDA[name] += 1
