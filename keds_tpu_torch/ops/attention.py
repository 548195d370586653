"""Fused self-attention for the CLIP towers (counterpart of
``keds_tpu/ops/attention.py``).

:func:`attention` is the op every tower block calls.  On a CUDA tensor it
launches a hand-written kernel of ``csrc/attention.cu`` (which replaces the
Pallas ``flash_attention``) or raises: bf16 runs the tensor-core kernel
(variant ``bf16_tc``, Dh = 64), f32 the exact-f32 CUDA-core kernel
(variant ``f32``).  On a CPU tensor it runs the plain version
:func:`attention_reference`.  Keys at or past the real sequence length
never enter a softmax, so no sequence padding is needed.  Forward only: the
backward arrives with the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from keds_tpu_torch.ops.cuda_build import CudaKernel, require_cuda, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("attention", {
    "keds_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                           ctypes.c_float, _P],
    "keds_attention_max_seq": [],
    "keds_attention_max_head_dim": [],
    "keds_attention_tc_head_dim": [],
}, variants=("bf16_tc", "f32"))
_VARIANTS = {torch.bfloat16: ("bf16_tc", 1), torch.float32: ("f32", 0)}


def causal_mask(n: int, device=None) -> torch.Tensor:
    """Additive upper-triangular -inf mask (reference build_attention_mask)."""
    return torch.full((n, n), float("-inf"), device=device).triu(1)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain PyTorch attention over (B, H, S, Dh) with the kernel's numerics:
    q scaled in f32, f32 scores and softmax, probabilities rounded to v's
    dtype, f32 accumulation of P.V, output in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        scores = scores + causal_mask(q.shape[2], q.device)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh), optionally causal) v for (B, H, S, Dh)
    tensors, which may be strided views as long as Dh is contiguous.

    The CUDA result is a (B, H, S, Dh) view of a (B, S, H, Dh) contiguous
    buffer, so ``out.transpose(1, 2).reshape(B, S, H * Dh)`` is free."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal)
    require_cuda(q, k, v)
    B, H, S, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _VARIANTS:
        raise ValueError(f"attention kernel takes f32 or bf16 q/k/v, got "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention kernel needs a contiguous head dimension")
    lib = KERNEL.lib()
    max_seq = lib.keds_attention_max_seq()
    if not 1 <= S <= max_seq:
        raise ValueError(f"attention kernel supports 1 <= S <= {max_seq}, got S={S}")
    variant, code = _VARIANTS[q.dtype]
    if variant == "bf16_tc":
        head_dim = lib.keds_attention_tc_head_dim()
        if Dh != head_dim:
            raise ValueError(f"bf16 attention kernel supports Dh = {head_dim}, got {Dh}")
        # 16-byte cp.async rows of k and v, 4-byte loads of q
        if any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in (k, v)) \
                or q.data_ptr() % 4 or any(s % 2 for s in q.stride()[:3]):
            raise ValueError("bf16 attention kernel needs 16-byte aligned k/v rows")
    elif Dh > lib.keds_attention_max_head_dim():
        raise ValueError(f"f32 attention kernel supports Dh <= "
                         f"{lib.keds_attention_max_head_dim()}, got {Dh}")
    out = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*[
        st for t in (q, k, v, out) for st in (t.stride(0), t.stride(2), t.stride(1))])
    err = lib.keds_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
        B, H, S, Dh, ctypes.cast(strides, ctypes.c_void_p), int(causal),
        1.0 / math.sqrt(Dh), stream_ptr(q))
    KERNEL.check(err)
    KERNEL.launches[variant] += 1
    return out
