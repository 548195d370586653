"""Fused self-attention for the CLIP towers (counterpart of
``keds_tpu/ops/attention.py``).

:func:`attention` is the op every tower block calls.  On a CUDA tensor it
launches a hand-written kernel of ``csrc/attention.cu`` (which replaces the
Pallas ``flash_attention``) or raises: bf16 runs the tensor-core kernel
(variant ``bf16_tc``, Dh = 64), f32 the exact-f32 CUDA-core kernel
(variant ``f32``), at any sequence length (above 288 the kernels stream
K and V through shared memory).  On a CPU tensor it runs the plain version
:func:`attention_reference`.  Keys at or past the real sequence length
never enter a softmax, so no sequence padding is needed.

Gradients (the counterpart of the JAX op's ``custom_vjp``): when grad mode
is on and q, k or v requires grad, a CUDA call goes through an autograd
Function whose backward launches ``csrc/attention_bwd.cu``
(:func:`attention_backward`, variants ``bf16`` and ``f32``, and above 128
keys the streamed ``bf16_stream`` and ``f32_stream``); on the CPU
autograd runs through :func:`attention_reference`.  Otherwise (serving,
``torch.inference_mode``) the forward kernel runs alone and nothing is
saved.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from keds_tpu_torch.ops.cuda_build import CudaKernel, require_cuda, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("attention", {
    "keds_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                           ctypes.c_float, _P],
    "keds_attention_max_head_dim": [],
    "keds_attention_tc_head_dim": [],
}, variants=("bf16_tc", "f32"))
_VARIANTS = {torch.bfloat16: ("bf16_tc", 1), torch.float32: ("f32", 0)}

BWD_KERNEL = CudaKernel("attention_bwd", {
    "keds_attention_bwd": [_P] * 7 + [_I] * 5 + [_P, _I, ctypes.c_float, _P, _P],
    "keds_attention_bwd_head_dim": [],
    "keds_attention_bwd_plan": [_I, _P],
}, variants=("bf16", "f32", "bf16_stream", "f32_stream"))
_BWD_VARIANTS = {torch.bfloat16: ("bf16", 1), torch.float32: ("f32", 0)}


class BwdPlan(NamedTuple):
    """Launch plan of the bf16 backward kernels (``csrc/attention_bwd.cu``)."""

    key_tiles: int      # 16-row tiles of the sequence
    slices: int         # (batch, head) slices a block takes
    warps: int          # warps a block
    smem_bytes: int     # dynamic shared memory a block (the dkv kernel's above 128)
    workspace_rows: int  # f32 rows a (batch, head) per statistic (0 at S <= 128)

    def blocks(self, batch_heads: int) -> int:
        return -(-batch_heads // self.slices)


# Mirror of csrc/attention_bwd.cu's keds_attention_bwd_plan (a card test
# checks one against the other).  S <= BWD_RESIDENT_SEQ: one block holds a
# (batch, head), q, k, v and dO in 144-byte rows and three f32 statistics a
# row, per slice; S <= 16 packs BWD_SMALL_SLICES slices into a block, one
# warp each.  Above it two streamed launches (dq, then dk and dv) of
# BWD_STREAM_WARPS warps, K and V of 128 keys resident in the dkv kernel
# plus two 64-row stages of q and dO and of the statistics, which a
# workspace of S rounded up to 128 rows carries between the two.
BWD_SMALL_SLICES = 4
BWD_RESIDENT_SEQ = 128
BWD_STREAM_WARPS = 8


def bwd_plan(S: int) -> BwdPlan:
    n = -(-S // 16)
    if S > BWD_RESIDENT_SEQ:
        rows = 16 * BWD_STREAM_WARPS
        smem = (2 * rows * 144 + 2 * 2 * 64 * 144) + 2 * 3 * 64 * 4
        return BwdPlan(n, 1, BWD_STREAM_WARPS, smem, -(-S // rows) * rows)
    slice_bytes = 16 * n * (4 * 144 + 3 * 4)
    slices = BWD_SMALL_SLICES if n == 1 else 1
    return BwdPlan(n, slices, BWD_SMALL_SLICES if n == 1 else n, slices * slice_bytes, 0)


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


def attention_reference_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 dout: torch.Tensor, causal: bool = False
                                 ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward: (dq, dk, dv) by autograd through
    :func:`attention_reference` (the JAX op's ``_bwd`` is the VJP of the
    same plain math)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_reference(*leaves, causal)
        return torch.autograd.grad(out, leaves, dout)


def _check_qkv(q, k, v) -> None:
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _VARIANTS:
        raise ValueError(f"attention kernel takes f32 or bf16 q/k/v, got "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention kernel needs a contiguous head dimension")


def _strides(*tensors: torch.Tensor):
    """(batch, seq, head) element strides of (B, H, S, Dh) tensors, as the
    C entry points take them."""
    vals = [st for t in tensors for st in (t.stride(0), t.stride(2), t.stride(1))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    require_cuda(q, k, v)
    B, H, S, Dh = q.shape
    _check_qkv(q, k, v)
    if S < 1:
        raise ValueError(f"attention kernel needs S >= 1, got S={S}")
    lib = KERNEL.lib()
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
    strides = _strides(q, k, v, out)
    err = lib.keds_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
        B, H, S, Dh, ctypes.cast(strides, ctypes.c_void_p), int(causal),
        1.0 / math.sqrt(Dh), stream_ptr(q))
    KERNEL.check(err)
    KERNEL.launches[variant] += 1
    return out


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, causal: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention` for the output gradient ``dout``.

    On CUDA it launches ``csrc/attention_bwd.cu`` (Dh = 64, any S >= 1, f32
    or bf16; above 128 two streamed launches with an f32 workspace of
    3 * B * H * ``bwd_plan(S).workspace_rows`` floats) or raises; q, k and v
    may be strided views, and a ``dout`` whose
    head dimension is not contiguous is made contiguous here, as is, for
    bf16, any input whose rows are not 16-byte aligned.  The three
    gradients are views of one (B, S, 3, H, Dh) buffer, laid out as the
    fused qkv projection's output.  On the CPU it runs
    :func:`attention_reference_backward`."""
    if q.device.type == "cpu":
        return attention_reference_backward(q, k, v, dout, causal)
    require_cuda(q, k, v, dout)
    B, H, S, Dh = q.shape
    _check_qkv(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"output gradient {dout.shape} {dout.dtype} does not match "
                         f"q {q.shape} {q.dtype}")
    lib = BWD_KERNEL.lib()
    head_dim = lib.keds_attention_bwd_head_dim()
    if S < 1 or Dh != head_dim:
        raise ValueError(f"attention backward kernel supports Dh = {head_dim} and "
                         f"S >= 1, got Dh={Dh}, S={S}")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    variant, code = _BWD_VARIANTS[q.dtype]
    if variant == "bf16":       # 16-byte cp.async rows
        q, k, v, dout = (t if t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
                         else torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)
                         for t in (q, k, v, dout))
    grads = torch.empty((B, S, 3, H, Dh), dtype=q.dtype, device=q.device)
    dq, dk, dv = (grads[:, :, i].transpose(1, 2) for i in range(3))
    strides = _strides(q, k, v, dout, dq, dk, dv)
    rows = bwd_plan(S).workspace_rows
    workspace = torch.empty((3 * B * H * rows,), dtype=torch.float32, device=q.device) \
        if rows else None
    err = lib.keds_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), code, B, H, S, Dh,
        ctypes.cast(strides, ctypes.c_void_p), int(causal), 1.0 / math.sqrt(Dh),
        workspace.data_ptr() if rows else None, stream_ptr(q))
    BWD_KERNEL.check(err)
    # above BWD_RESIDENT_SEQ the call's two streamed launches count once,
    # apart from the resident kernel's
    BWD_KERNEL.launches[variant + ("_stream" if rows else "")] += 1
    return dq, dk, dv


class _AttentionFunction(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient; q, k and
    v are saved (they are views of the qkv projection, alive anyway) and P
    is recomputed in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward_kernel(q, k, v, causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, dout, ctx.causal), None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh), optionally causal) v for (B, H, S, Dh)
    tensors, which may be strided views as long as Dh is contiguous.

    The CUDA result is a (B, H, S, Dh) view of a (B, S, H, Dh) contiguous
    buffer, so ``out.transpose(1, 2).reshape(B, S, H * Dh)`` is free."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _AttentionFunction.apply(q, k, v, causal)
    return _forward_kernel(q, k, v, causal)
