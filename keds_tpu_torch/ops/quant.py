"""W8A8 dynamic int8 for the CLIP tower GEMMs and the int8 product the
int8 retrieval backend scores with (counterpart of ``keds_tpu/ops/quant.py``).

Scheme (inference; the gradient is straight-through):

* **weights**: symmetric per-output-channel int8, quantized once at load
  (:func:`quantize_weight`), scale_j = max_i |W_ij| / 127;
* **activations**: symmetric per-token int8, quantized on every call
  (:func:`quantize_activations`);
* the four residual-block projections (fused qkv, attention out, MLP fc
  and proj) of each transformer tower take the int8 product
  (:func:`quantize_clip_blocks`); LayerNorm, softmax, attention (the B2
  kernel, bf16), biases, embeddings and the final projections stay as
  they are.

:func:`int8_matmul` is an s8 x s8 -> s32 product.  The JAX package leaves
it to XLA's ``dot_general``, not to a Pallas kernel, so on the card it is
the library's ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM), padded
to the shapes it takes: more than 16 rows (fewer are padded with zero rows
and the result sliced) and a column count that is a multiple of 8 (the
last ragged columns run as one zero-padded 8-column product); the depth
must be a multiple of 8, or it raises with the shape.  Each call counts in
``INT8_MM.launches``.  On the CPU, and as the card check's plain version,
:func:`int8_matmul_plain` takes the same product in float64, exact for any
depth the towers or the DB have.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

QUANT_KEYS = frozenset({"q", "s"})
_BLOCK_GEMM_KEYS = ("qkv_w", "out_w", "fc_w", "proj_w")
_MIN_ROWS = 17          # torch._int_mm on CUDA takes more than 16 rows
_COL_STEP = 8           # and depths and column counts that are multiples of 8


class LaunchCount:
    """Calls of a library product by the path that made them, counted by
    the wrapper where it calls the library on a CUDA tensor (as
    :class:`~keds_tpu_torch.ops.cuda_build.CudaKernel` counts launches)."""

    def __init__(self, *paths: str):
        self.launches = dict.fromkeys(paths, 0)

    def reset(self) -> None:
        self.launches = dict.fromkeys(self.launches, 0)


INT8_MM = LaunchCount("retrieval", "linear")


def by_127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` rounded as IEEE division rounds it.  PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, which rounds
    some quotients one ulp off the CPU's (and XLA's); a 0-d tensor on
    ``x``'s device is divided elementwise."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and QUANT_KEYS.issuperset(w.keys()) and "q" in w


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8, w ~ q * s, reducing over the
    second-to-last (input) axis; stacked (L, d_in, d_out) weights keep
    their layer axis.  ``s`` is f32 (..., 1, d_out).  ``q`` is laid out
    column-major (each output channel's d_in values contiguous): cuBLASLt's
    int8 GEMM takes that layout at every shape and 4.7-5.6x faster than a
    row-major one at the towers' (``kernel_sweeps.py int8_layouts``)."""
    wf = w.float()
    s = by_127(wf.abs().amax(dim=-2, keepdim=True)).clamp_min(1e-12)
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return {"q": q.transpose(-1, -2).contiguous().transpose(-1, -2), "s": s}


def dequantize_weight(wq: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (wq["q"].float() * wq["s"]).to(dtype)


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (last-axis) symmetric int8: x ~ q * s with s (..., 1) f32."""
    xf = x.float()
    s = by_127(xf.abs().amax(dim=-1, keepdim=True)).clamp_min(1e-12)
    return torch.round(xf / s).to(torch.int8), s


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 times (K, N) int8 -> (M, N) int32 in float64: every
    partial sum is an integer below 2^53, so the product is exact."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` with a's rows padded to more than 16."""
    M = a.shape[0]
    if M < _MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_MIN_ROWS - M, a.shape[1]))])
    return torch._int_mm(a, b)[:M]


def int8_matmul(a: torch.Tensor, b: torch.Tensor, path: str = "linear") -> torch.Tensor:
    """s8 x s8 -> s32 product of ``a`` (M, K) and ``b`` (K, N), which may
    be a transposed view (the DB's ``db_i8.T``).  CPU tensors take
    :func:`int8_matmul_plain`; CUDA tensors ``torch._int_mm`` (module
    docstring), counted under ``path``."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2 \
            or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul takes (M, K) and (K, N) int8 matrices, got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} {b.dtype}")
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    K, N = b.shape
    if K % _COL_STEP:
        raise ValueError(f"torch._int_mm needs a depth that is a multiple of {_COL_STEP}, "
                         f"got {tuple(a.shape)} x {tuple(b.shape)}")
    n_main = N - N % _COL_STEP
    parts = []
    if n_main:
        parts.append(_int_mm(a, b[:, :n_main]))
        INT8_MM.launches[path] += 1
    if n_main < N:
        tail = b.new_zeros((K, _COL_STEP))
        tail[:, :N - n_main] = b[:, n_main:]
        parts.append(_int_mm(a, tail)[:, :N - n_main])
        INT8_MM.launches[path] += 1
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def quantize_clip_blocks(params: dict) -> dict:
    """The residual-block GEMM weights (``qkv_w``, ``out_w``, ``fc_w``,
    ``proj_w``) of each transformer tower quantized to ``{"q", "s"}``; every
    other tensor is kept as it is.  A tower without transformer blocks (the
    ModifiedResNet visual tower) is left unquantized with a warning; an RN
    model's text tower is quantized."""
    out = dict(params)
    for tower in ("visual", "text"):
        if tower not in params:
            continue
        tw = dict(params[tower])
        if "blocks" not in tw:
            logging.warning(
                "quantize_clip_blocks: %r tower has no transformer blocks "
                "(ResNet backbone?); leaving it unquantized", tower)
            continue
        blocks = dict(tw["blocks"])
        for key in _BLOCK_GEMM_KEYS:
            blocks[key] = quantize_weight(blocks[key])
        tw["blocks"] = blocks
        out[tower] = tw
    return out


def maybe_quantize_clip(params: dict, mode: Optional[str]) -> dict:
    """The ``--quant-towers`` value applied: 'int8' quantizes the blocks,
    'none' (or empty) returns ``params``."""
    if mode == "int8":
        return quantize_clip_blocks(params)
    if mode not in (None, "", "none"):
        raise ValueError(f"unknown --quant-towers mode {mode!r}")
    return params


def _i8_affine(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """f32 dequant(x_q @ q) with the folded activation and weight scales;
    s is (1, d_out)."""
    x_q, a_s = quantize_activations(x)
    acc = int8_matmul(x_q.reshape(-1, x.shape[-1]), q)
    return (acc.float().view(*x.shape[:-1], q.shape[1]) * a_s) * s


class _I8Affine(torch.autograd.Function):
    """:func:`_i8_affine` with the straight-through gradient: the forward
    approximates x @ (q * s), so the input's cotangent is g @ (q * s)^T
    (the rounding would otherwise zero it); q and s get none."""

    @staticmethod
    def forward(ctx, x, q, s):
        ctx.save_for_backward(q, s)
        ctx.x_dtype = x.dtype
        return _i8_affine(x, q, s)

    @staticmethod
    def backward(ctx, g):
        q, s = ctx.saved_tensors
        w_deq = q.float() * s                     # (d_in, d_out)
        return torch.matmul(g.float(), w_deq.T).to(ctx.x_dtype), None, None


def int8_linear(x: torch.Tensor, wq: dict, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 dynamic linear: ``x`` quantized per token, the int8 product,
    dequantized with the folded scales in f32, the bias added in f32, the
    result in ``x``'s dtype.  ``wq`` is one layer's ``{"q": (d_in, d_out)
    int8, "s": (1, d_out) f32}``."""
    w = wq["q"]
    if w.dim() != 2:
        raise ValueError(f"int8_linear expects a 2-D weight slice; got {tuple(w.shape)}")
    out = _I8Affine.apply(x, w, wq["s"].reshape(1, -1).float())
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)
