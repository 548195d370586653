"""Fused self-attention for the CLIP towers (counterpart of
``keds_tpu/ops/attention.py``).

:func:`attention` is the op every tower block calls.  On a CUDA tensor it
launches a hand-written kernel of ``csrc/attention.cu`` (which replaces the
Pallas ``flash_attention``) or raises: bf16 at Dh <= 64 runs the tensor-core
kernel (variant ``bf16_tc``: up to 288 keys at Dh rounded up to 16, in
shared memory alone; above them K and V stream through shared memory in
tiles at Dh = 64, narrower heads zero-padded to it), f32 at Dh <= 128 the
f32 kernel (variant ``f32``), whose products run on tensor cores in three
TF32 terms: about f32's accuracy, where one TF32 product keeps 11 bits (its
note in the source says what it measured), at any sequence length.  Wider
heads run the wide-head kernels: bf16 above 64 on tensor cores
(``bf16_wide``: the head zero-padded to a multiple of 16 in shared memory,
128-column chunks), f32 above 128 on CUDA cores (``f32_wide``).
On a CPU tensor it runs the plain version :func:`attention_reference`.  Keys
at or past the real sequence length never enter a softmax, so no sequence
padding is needed.

Gradients (the counterpart of the JAX op's ``custom_vjp``): when grad mode
is on and q, k or v requires grad, a CUDA call goes through an autograd
Function whose backward launches ``csrc/attention_bwd.cu``
(:func:`attention_backward`: at Dh <= 64 variants ``bf16``, above 128 keys
the streamed ``bf16_stream``, and ``f32``, one design at any S; wider heads
``bf16_wide`` and ``f32_wide``); on the CPU autograd runs through
:func:`attention_reference`.  Otherwise (serving, ``torch.inference_mode``)
the forward kernel runs alone and nothing is saved.

Which route a call takes, the width it takes the inputs at and the head
width it runs at, the libraries say (``keds_attention_fwd_route``,
``keds_attention_bwd_route``).  Where a route takes a wider head than the
caller's (bf16's streamed routes and f32's backward take 64), the head is
zero-padded to it here, its output sliced back: the padded columns add
exact zeros to q.k^T and P.V and give zero gradient columns.  The scale
stays 1/sqrt(Dh) of the caller's Dh.  ``pads[variant]`` counts those
calls; every other route runs at the caller's width, zero past it in
shared memory alone, and pads nothing here.  The bf16 kernels stage rows
with 16-byte copies: an input whose rows are not 16-byte aligned is copied
first (:func:`_aligned_rows`).  An empty batch (B * H = 0) launches
nothing: it returns empty results of the usual layout.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from keds_tpu_torch.ops.cuda_build import CudaKernel, require_cuda, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("attention", {
    "keds_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                           ctypes.c_float, _P],
    "keds_attention_fwd_route": [_I, _I, _I, _P],
}, variants=("bf16_tc", "f32", "bf16_wide", "f32_wide"))

BWD_KERNEL = CudaKernel("attention_bwd", {
    "keds_attention_bwd": [_P] * 7 + [_I] * 5 + [_P, _I, ctypes.c_float, _P, _P],
    "keds_attention_bwd_route": [_I, _I, _I, _P],
    "keds_attention_bwd_plan": [_I, _I, _I, _P],
}, variants=("bf16", "f32", "bf16_stream", "bf16_wide", "f32_wide"))

# dtype -> (variant prefix, the C entry points' dtype code)
_DTYPES = {torch.bfloat16: ("bf16", 1), torch.float32: ("f32", 0)}


# Keys the bf16 forward holds whole in shared memory (csrc/attention.cu
# kMaxResident); above it K and V stream through it in tiles.
FWD_RESIDENT_SEQ = 288


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
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"attention kernel takes f32 or bf16 q/k/v, got "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention kernel needs a contiguous head dimension")
    if q.shape[2] < 1:
        raise ValueError(f"attention kernel needs S >= 1, got S={q.shape[2]}")


class Route(NamedTuple):
    """A library's route for a call: which kernel takes it, the width it
    takes the inputs at (the caller's Dh, or wider: the inputs are
    zero-padded to it), the head width it runs at, and the f32 workspace
    rows a (batch, head) takes for each of three statistics (the backward's;
    0: none)."""

    route: int
    width: int
    runs_at: int
    rows: int


def _route(fn, *args) -> Route:
    """The route of a library's route function (``keds_attention_fwd_route``
    or ``keds_attention_bwd_route`` at dtype code, Dh and S): the libraries
    decide which kernel takes which head width."""
    out = (ctypes.c_int * 3)()
    route = fn(*args, ctypes.cast(out, ctypes.c_void_p))
    if route < 0:
        raise ValueError(f"attention kernel takes Dh >= 1, got Dh={args[1]}")
    return Route(route, *out)


def _aligned_rows(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t``, or a copy whose rows are ``nbytes``-aligned where its own are
    not: a view of a contiguous buffer whose rows are rounded up to
    ``nbytes`` (Dh = 100 in bf16, 200-byte rows, is copied into 208-byte
    rows).  The head width stays Dh: the copy pads nothing the kernel reads."""
    step = nbytes // t.element_size()
    if t.data_ptr() % nbytes == 0 and all(st % step == 0 for st in t.stride()[:3]):
        return t
    width = -(-t.shape[-1] // step) * step
    return t.new_empty((*t.shape[:-1], width))[..., :t.shape[-1]].copy_(t)


def _zero_padded(width: int, *tensors: torch.Tensor):
    return tuple(F.pad(t, (0, width - t.shape[-1])) for t in tensors)


def _strides(*tensors: torch.Tensor):
    """(batch, seq, head) element strides of (B, H, S, Dh) tensors, as the
    C entry points take them."""
    vals = [st for t in tensors for st in (t.stride(0), t.stride(2), t.stride(1))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _output(B: int, H: int, S: int, width: int, like: torch.Tensor) -> torch.Tensor:
    """A (B, H, S, width) view of a new (B, S, H, width) buffer."""
    return torch.empty((B, S, H, width), dtype=like.dtype, device=like.device).transpose(1, 2)


def _forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    require_cuda(q, k, v)
    _check_qkv(q, k, v)
    B, H, S, Dh = q.shape
    if B * H == 0:                              # nothing to compute, nothing launched
        return _output(B, H, S, Dh, q)
    lib = KERNEL.lib()
    prefix, code = _DTYPES[q.dtype]
    route, width, _, _ = _route(lib.keds_attention_fwd_route, code, Dh, S)
    variant = ("f32", "bf16_tc", prefix + "_wide")[route]
    if width != Dh:
        q, k, v = _zero_padded(width, q, k, v)
        KERNEL.pads[variant] += 1
    elif variant == "bf16_tc":
        # 16-byte rows of k and v (copies, tensor-map tiles), 4-byte loads of
        # q; above FWD_RESIDENT_SEQ q's rows are copied in 16 bytes too
        q = _aligned_rows(q, 16 if S > FWD_RESIDENT_SEQ else 4)
        k, v = _aligned_rows(k, 16), _aligned_rows(v, 16)
    elif variant == "bf16_wide":                # 16-byte cp.async rows
        q, k, v = (_aligned_rows(t, 16) for t in (q, k, v))
    out = _output(B, H, S, width, q)
    _launch_forward(lib, code, q, k, v, out, causal, 1.0 / math.sqrt(Dh))
    KERNEL.launches[variant] += 1
    return out if width == Dh else out[..., :Dh]


def _launch_forward(lib, code: int, q, k, v, out, causal: bool, scale: float) -> None:
    """keds_attention_fwd at the inputs' width, into ``out``."""
    B, H, S, width = q.shape
    strides = _strides(q, k, v, out)
    KERNEL.check(lib.keds_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
        B, H, S, width, ctypes.cast(strides, ctypes.c_void_p), int(causal), scale,
        stream_ptr(q)))


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, causal: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention` for the output gradient ``dout``.

    On CUDA it launches ``csrc/attention_bwd.cu`` at any S >= 1 and Dh >= 1,
    f32 or bf16 (Dh <= 64 on the tuned kernels: bf16 up to 128 keys at the
    caller's width, bf16 above them and f32 padded to 64; bf16 above 128
    and f32 above 64 keys as two launches; wider heads the wide-head pair,
    two launches; a workspace of 3 * B * H * rows floats, the rows from
    ``keds_attention_bwd_route``); q, k and v may be strided views, and a
    ``dout`` whose head dimension is not contiguous is made contiguous
    here, as is, for every bf16 route, any input whose rows are not
    16-byte aligned.  The three gradients are views of one (B, S, 3, H, Dh)
    buffer (a padded width's, sliced, where the route pads), laid out as
    the fused qkv projection's output; at B * H = 0 nothing is launched.
    On the CPU it runs :func:`attention_reference_backward`."""
    if q.device.type == "cpu":
        return attention_reference_backward(q, k, v, dout, causal)
    return _backward_kernel(q, k, v, dout, causal)


def _gradients(B: int, H: int, S: int, width: int, like: torch.Tensor):
    """(dq, dk, dv): (B, H, S, width) views of a new (B, S, 3, H, width)
    buffer, laid out as the fused qkv projection's output."""
    grads = torch.empty((B, S, 3, H, width), dtype=like.dtype, device=like.device)
    return tuple(grads[:, :, i].transpose(1, 2) for i in range(3))


def _backward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, causal: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    require_cuda(q, k, v, dout)
    _check_qkv(q, k, v)
    B, H, S, Dh = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"output gradient {dout.shape} {dout.dtype} does not match "
                         f"q {q.shape} {q.dtype}")
    if B * H == 0:                              # nothing to compute, nothing launched
        return _gradients(B, H, S, Dh, q)
    lib = BWD_KERNEL.lib()
    prefix, code = _DTYPES[q.dtype]
    route, width, _, rows = _route(lib.keds_attention_bwd_route, code, Dh, S)
    # bf16 above BWD_RESIDENT_SEQ: the call's two streamed launches count
    # once, apart from the resident kernel's; f32 and the wide pair: a call
    # counts once
    variant = (prefix + ("_stream" if rows and prefix == "bf16" else ""),
               prefix + "_wide")[route]
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    if width != Dh:
        q, k, v, dout = _zero_padded(width, q, k, v, dout)
        BWD_KERNEL.pads[variant] += 1
    elif prefix == "bf16":                      # 16-byte cp.async rows, every route
        q, k, v, dout = (_aligned_rows(t, 16) for t in (q, k, v, dout))
    dq, dk, dv = _gradients(B, H, S, width, q)
    _launch_backward(lib, code, q, k, v, dout, (dq, dk, dv), causal, 1.0 / math.sqrt(Dh), rows)
    BWD_KERNEL.launches[variant] += 1
    return (dq, dk, dv) if width == Dh else tuple(g[..., :Dh] for g in (dq, dk, dv))


def _launch_backward(lib, code: int, q, k, v, dout, grads, causal: bool, scale: float,
                     rows: int) -> None:
    """keds_attention_bwd at the inputs' width, into ``grads`` (dq, dk, dv),
    with a workspace of ``rows`` rows a statistic."""
    B, H, S, width = q.shape
    strides = _strides(q, k, v, dout, *grads)
    workspace = torch.empty((3 * B * H * rows,), dtype=torch.float32, device=q.device) \
        if rows else None
    BWD_KERNEL.check(lib.keds_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        *(g.data_ptr() for g in grads), code, B, H, S, width,
        ctypes.cast(strides, ctypes.c_void_p), int(causal), scale,
        workspace.data_ptr() if rows else None, stream_ptr(q)))


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
        return (*_backward_kernel(q, k, v, dout, ctx.causal), None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh), optionally causal) v for (B, H, S, Dh)
    tensors, which may be strided views as long as Dh is contiguous.

    The CUDA result is a (B, H, S, Dh) view of a (B, S, H, Dh) contiguous
    buffer, so ``out.transpose(1, 2).reshape(B, S, H * Dh)`` is free (but
    where a bf16 head narrower than 64 streams, above 288 keys: its result
    is a slice of the 64-wide buffer, and the reshape copies)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _AttentionFunction.apply(q, k, v, causal)
    return _forward_kernel(q, k, v, causal)
