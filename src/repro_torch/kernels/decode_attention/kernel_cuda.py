"""ctypes wrapper of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces `repro.kernels.decode_attention.kernel.decode_attention_pallas`.
The source's header states its bound on the card and its design: splits of
the sequence axis sized to the card's SMs, combined in one launch through
the distributed shared memory of a thread-block cluster. The wrapper
validates its inputs (q may be a strided (B, H, D) view with a contiguous
last dimension; the caches must be contiguous; any head_dim a block's
shared memory holds), allocates the (B, H, D) output in q's dtype (and,
with ``return_lse``, the (B, H) float32 log-sum-exp of each row's scaled
logits, which the kernel's combine writes beside the output), launches on
the current stream and raises if the launch was refused.
``decode_attention_cuda.launches`` counts calls that launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build

SOURCE = "decode_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_CHECKED = set()  # shapes the source's plan accepts, per device


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    lib.decode_attention_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ll, ll,
                                            ctypes.c_float, p]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_splits.argtypes = [i, i, i, i, i, i]
    lib.decode_attention_splits.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p


def _check_shape(lib, device, B, H, KVH, S, D, cache_dtype) -> None:
    """Raises for a shape the kernel cannot take (its plan on this device)."""
    key = (device.index, B, H, KVH, S, D, cache_dtype)
    if key in _CHECKED:
        return
    n = lib.decode_attention_splits(B, H, KVH, S, D, cache_dtype)
    if n == 0:
        raise ValueError(f"decode_attention: head_dim {D} (or the grid of B={B}, "
                         f"KVH={KVH}) is beyond what the kernel's blocks hold")
    if n < 0:
        raise RuntimeError("decode_attention: no CUDA device to plan for")
    _CHECKED.add(key)


def decode_attention_cuda(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KVH, S, D)
    v_cache: torch.Tensor,  # (B, KVH, S, D)
    lengths: torch.Tensor,  # (B,) int32
    *,
    scale: Optional[float] = None,
    return_lse: bool = False,
):  # (B, H, D) in q's dtype, and (B, H) float32 with return_lse
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {device}")
    for t, name in ((k_cache, "k_cache"), (v_cache, "v_cache"), (lengths, "lengths")):
        if t.device != device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, expected {device}")
    if q.dtype not in DTYPES or k_cache.dtype not in DTYPES:
        raise TypeError(f"decode_attention: unsupported dtypes q {q.dtype}, "
                        f"cache {k_cache.dtype}")
    if v_cache.dtype != k_cache.dtype:
        raise TypeError("decode_attention: k_cache and v_cache differ in dtype")
    if lengths.dtype != torch.int32 or lengths.dim() != 1:
        raise TypeError("decode_attention: lengths must be a 1-D int32 tensor")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} must be 3-D and the "
                         f"cache {tuple(k_cache.shape)} 4-D")
    B, H, D = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (B, KVH, S, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if lengths.shape[0] != B:
        raise ValueError(f"decode_attention: {lengths.shape[0]} lengths for {B} sequences")
    if KVH == 0 or H % KVH:
        raise ValueError(f"decode_attention: {H} heads do not group over {KVH} KV heads")
    if q.stride(-1) != 1:
        raise ValueError("decode_attention: q's last dimension must be contiguous")
    for t, name in ((k_cache, "k_cache"), (v_cache, "v_cache")):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if scale is None:
        scale = 1.0 / (D**0.5)
    if q.numel() == 0 or S == 0:
        raise ValueError(f"decode_attention: empty shapes q {tuple(q.shape)}, S={S}")
    out = torch.empty((B, H, D), dtype=q.dtype, device=device)
    lse = torch.empty((B, H), dtype=torch.float32, device=device) if return_lse else None
    lib = build.load(SOURCE, _bind)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check_shape(lib, device, B, H, KVH, S, D, DTYPES[k_cache.dtype])
        rc = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), DTYPES[q.dtype],
            DTYPES[k_cache.dtype], B, H, KVH, S, D,
            q.stride(0), q.stride(1), float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"decode_attention launch failed: "
            f"{lib.decode_attention_error_string(rc).decode()} ({rc})"
        )
    decode_attention_cuda.launches += 1
    if return_lse:
        decode_attention_cuda.lse_launches += 1
        return out, lse
    return out


decode_attention_cuda.launches = 0
decode_attention_cuda.lse_launches = 0  # those of them that wrote the log-sum-exp
