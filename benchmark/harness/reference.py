"""The plain reference: KEDs' composed query and its image-stream training
step, written from the published models in plain PyTorch, float32, with
TF32 off.  It reads the same inputs as the program (OpenAI CLIP's state
dict, KEDs' head state dicts, the knowledge DB's tables, uint8 images and
token rows) and nothing the program made from them.  It imports torch and
the standard library only.

* CLIP (``clip/model.py``): ViT image tower (conv1 patches, class token,
  positional embedding, ln_pre, pre-LN residual attention blocks with
  QuickGELU, ln_post on the class token, proj) and the causal text tower
  (token + positional embedding, blocks, ln_final at the pooled row,
  text_projection); images normalised with CLIP's mean and std.
* KEDs (``src/model/model.py``): IM2TEXT, Linear -> Dropout -> ReLU per
  layer and an output Linear; CrossFormer, CrossAttention layers (8 heads
  of 64, softmax over keys, no residual) with the query fed back; the
  pseudo-tokens [retrieval-fused, text-conditioned, mapped] replace ``*``
  in a composed prompt and are inserted before EOT of the training prompt.
* Retrieval: exact top-k by inner product of the unit image feature with
  each table, in f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
EOT = 49407
Masks = Optional[Callable[[tuple], torch.Tensor]]


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32 (no TF32) for the enclosed code."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _w(sd, key: str) -> torch.Tensor:
    return sd[key].float()


def _ln(x, sd, p: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), _w(sd, p + ".weight"), _w(sd, p + ".bias"), 1e-5)


def _resblock(x: torch.Tensor, sd, p: str, causal: bool) -> torch.Tensor:
    B, S, W = x.shape
    H, Dh = W // 64, 64
    h = _ln(x, sd, p + "ln_1")
    qkv = h @ _w(sd, p + "attn.in_proj_weight").T + _w(sd, p + "attn.in_proj_bias")
    q, k, v = qkv.view(B, S, 3, H, Dh).permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) * Dh ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1),
                          float("-inf"))
    a = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, S, W)
    x = x + a @ _w(sd, p + "attn.out_proj.weight").T + _w(sd, p + "attn.out_proj.bias")
    h = _ln(x, sd, p + "ln_2")
    h = h @ _w(sd, p + "mlp.c_fc.weight").T + _w(sd, p + "mlp.c_fc.bias")
    h = h * torch.sigmoid(1.702 * h)
    return x + h @ _w(sd, p + "mlp.c_proj.weight").T + _w(sd, p + "mlp.c_proj.bias")


def _n_blocks(sd, prefix: str) -> int:
    return len({k.split(".")[len(prefix.split("."))] for k in sd
                if k.startswith(prefix + ".") and k.endswith("attn.in_proj_weight")})


def encode_image(sd, images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, embed_dim) image features."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    conv = _w(sd, "visual.conv1.weight")
    x = F.conv2d(x, conv, stride=conv.shape[-1]).flatten(2).transpose(1, 2)
    B, _, W = x.shape
    cls = _w(sd, "visual.class_embedding").expand(B, 1, W)
    x = torch.cat([cls, x], dim=1) + _w(sd, "visual.positional_embedding")
    x = _ln(x, sd, "visual.ln_pre")
    for i in range(_n_blocks(sd, "visual.transformer.resblocks")):
        x = _resblock(x, sd, f"visual.transformer.resblocks.{i}.", causal=False)
    return _ln(x[:, 0], sd, "visual.ln_post") @ _w(sd, "visual.proj")


def _text_tower(sd, x: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Embedded rows (B, S, width), pooled at ``pool`` (B,)."""
    x = x + _w(sd, "positional_embedding")[:x.shape[1]]
    for i in range(_n_blocks(sd, "transformer.resblocks")):
        x = _resblock(x, sd, f"transformer.resblocks.{i}.", causal=True)
    row = x[torch.arange(x.shape[0], device=x.device), pool]
    return _ln(row, sd, "ln_final") @ _w(sd, "text_projection")


def encode_text_composed(sd, text: torch.Tensor, pseudo: torch.Tensor,
                         star: int) -> torch.Tensor:
    """Each row's ``*`` replaced by its K pseudo-tokens (the rest shifts
    right), pooled at the shifted EOT."""
    emb = _w(sd, "token_embedding.weight")[text.long()]
    K = pseudo.shape[1]
    rows = []
    for b in range(text.shape[0]):
        s = int(torch.argmax((text[b] == star).int()))
        rows.append(torch.cat([emb[b, :s], pseudo[b], emb[b, s + 1:]])[:text.shape[1]])
    pool = torch.argmax((text == EOT).int(), dim=1) + K - 1
    return _text_tower(sd, torch.stack(rows)[:, :int(pool.max()) + 1], pool)


def encode_text_prompt(sd, prompt: Sequence[int], pseudo: torch.Tensor) -> torch.Tensor:
    """The training prompt (SOT .. EOT, one row for the batch) with the K
    pseudo-tokens inserted before EOT, pooled at EOT + K."""
    B, K, _ = pseudo.shape
    ids = torch.tensor(list(prompt), device=pseudo.device)
    eot = int(torch.argmax((ids == EOT).int()))
    emb = _w(sd, "token_embedding.weight")[ids[:eot + 1]].expand(B, eot + 1, -1)
    x = torch.cat([emb[:, :eot], pseudo, emb[:, eot:]], dim=1)
    return _text_tower(sd, x, torch.full((B,), eot + K, device=x.device))


def _linear(sd, p: str, x: torch.Tensor) -> torch.Tensor:
    return x @ _w(sd, p + ".weight").T + _w(sd, p + ".bias")


def im2text(sd, x: torch.Tensor, masks: Masks = None, rate: float = 0.1) -> torch.Tensor:
    n = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    for i in range(n):
        x = _linear(sd, f"layers.{i}.0", x)
        if masks is not None:
            x = torch.where(masks(tuple(x.shape)), x / (1 - rate), torch.zeros_like(x))
        x = torch.relu(x)
    return _linear(sd, "fc_out", x)


def crossformer(sd, q: torch.Tensor, kv: torch.Tensor, dim_head: int = 64) -> torch.Tensor:
    n = len({k.split(".")[1] for k in sd if k.startswith("cross_layers.")})
    B, Nq, _ = q.shape
    for i in range(n):
        p = f"cross_layers.{i}"
        qh = _linear(sd, p + ".to_q", q)
        H = qh.shape[-1] // dim_head
        qh = qh.view(B, Nq, H, dim_head).transpose(1, 2)
        kh = _linear(sd, p + ".to_k", kv).view(B, -1, H, dim_head).transpose(1, 2)
        vh = _linear(sd, p + ".to_v", kv).view(B, -1, H, dim_head).transpose(1, 2)
        a = torch.softmax((qh @ kh.transpose(-1, -2)) * dim_head ** -0.5, dim=-1)
        q = _linear(sd, p + ".to_out.0", (a @ vh).transpose(1, 2).reshape(B, Nq, H * dim_head))
    return q


def pseudo_tokens(heads: Dict[str, dict], f: torch.Tensor, ti: torch.Tensor,
                  tt: torch.Tensor, masks: Masks = None) -> torch.Tensor:
    """[retrieval-fused, text-conditioned, mapped] (B, 3, width)."""
    i2t = heads["state_dict_img2text"]
    m = im2text(i2t, f, masks)[:, None]
    ki, kt = im2text(i2t, ti, masks), im2text(i2t, tt, masks)
    return torch.cat([crossformer(heads["state_dict_retrieval_fuse"], m, ki),
                      crossformer(heads["state_dict_text_condition"], m, kt), m], dim=1)


def topk_rows(q: torch.Tensor, table: torch.Tensor, k: int,
              block: int = 1 << 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``q @ table.T`` in f32, the table read in blocks."""
    best_v = torch.full((q.shape[0], 0), float("-inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.long, device=q.device)
    for r0 in range(0, table.shape[0], block):
        s = q @ table[r0:r0 + block].float().T
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        best_v, j = torch.topk(torch.cat([best_v, v], 1), min(k, best_v.shape[1] + v.shape[1]),
                               dim=1)
        best_i = torch.gather(torch.cat([best_i, i + r0], 1), 1, j)
    return best_v, best_i


def neighbours(f: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor],
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    q = f / f.norm(dim=-1, keepdim=True)
    img, txt = tables
    return img[topk_rows(q, img, k)[1]].float(), txt[topk_rows(q, txt, k)[1]].float()


def composed_features(sd, heads, tables, images_u8: torch.Tensor, text: torch.Tensor,
                      k: int, star: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit composed-query features (B, embed_dim) of uint8 images and
    composed prompts, and the image features (B, embed_dim) they start from."""
    f = encode_image(sd, images_u8)
    ti, tt = neighbours(f, tables, k)
    out = encode_text_composed(sd, text, pseudo_tokens(heads, f, ti, tt), star)
    return out / out.norm(dim=-1, keepdim=True), f


def in_blocks(fn, n: int, block: int):
    """``fn`` over slices of ``block`` rows, its tensors (or tuples of
    tensors) joined."""
    parts = [fn(slice(i, min(i + block, n))) for i in range(0, n, block)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


# --------------------------------------------------------------------------
# The image-stream training step (KEDs get_loss_img2text_image) and AdamW
# --------------------------------------------------------------------------

def info_nce(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    logits = scale * a @ b.T
    labels = torch.arange(a.shape[0], device=a.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


def head_leaves(heads: Dict[str, dict]) -> Dict[str, torch.Tensor]:
    """Every head tensor as an f32 leaf, keyed '<module>.<state-dict key>'."""
    return {f"{m[len('state_dict_'):]}.{k}": v.detach().float().clone().requires_grad_(True)
            for m, sd in heads.items() for k, v in sd.items()}


def _as_heads(leaves: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for key, v in leaves.items():
        mod, name = key.split(".", 1)
        out.setdefault(f"state_dict_{mod}", {})[name] = v
    return out


def warmup_cosine_lr(opt: dict, t: int) -> float:
    """open_clip's schedule at update ``t``: linear warm-up, then cosine."""
    if t < opt["warmup"]:
        return opt["lr"] * (t + 1) / opt["warmup"]
    e, es = t - opt["warmup"], max(opt["total_steps"] - opt["warmup"], 1)
    return 0.5 * (1 + math.cos(math.pi * e / es)) * opt["lr"]


def train_steps(sd, heads, tables, batches: List[torch.Tensor], prompt: Sequence[int],
                k: int, opt: dict, step_random: Callable[[int], Tuple[torch.Tensor, Masks]]
                ) -> dict:
    """Follow ``len(batches)`` image-stream steps from ``heads`` with AdamW
    (decoupled decay on matrices only, eps outside the square root, bias
    correction, linear warm-up).  ``step_random(t)`` gives step t's order
    of the image neighbours (KEDs shuffles them; with dropout the order
    matters) and its dropout masks in the order IM2TEXT meets them.
    Returns each step's loss, image features and text features, the first
    step's gradients and the leaves after the last step."""
    leaves = head_leaves(heads)
    m = {n: torch.zeros_like(v) for n, v in leaves.items()}
    v2 = {n: torch.zeros_like(v) for n, v in leaves.items()}
    b1, b2 = opt["beta1"], opt["beta2"]
    scale = _w(sd, "logit_scale").exp()
    losses, features, text_features, first_grads = [], [], [], None
    for t, images in enumerate(batches):
        with torch.no_grad():
            f = encode_image(sd, images)
            features.append(f)
            ti, tt = neighbours(f, tables, k)
        perm, masks = step_random(t)
        tok = pseudo_tokens(_as_heads(leaves), f, ti[:, perm], tt, masks)
        txt = encode_text_prompt(sd, prompt, tok)
        text_features.append(txt.detach())
        loss = info_nce(f / f.norm(dim=-1, keepdim=True),
                        txt / txt.norm(dim=-1, keepdim=True), scale)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {n: g.detach().clone() for n, g in zip(leaves, grads)}
        lr = warmup_cosine_lr(opt, t)
        with torch.no_grad():
            for (n, p), g in zip(leaves.items(), grads):
                if p.ndim >= 2:
                    p.mul_(1 - lr * opt["wd"])
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v2[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[n].sqrt() / math.sqrt(1 - b2 ** (t + 1))).add_(opt["eps"])
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** (t + 1)))
    return {"losses": losses, "features": features, "text_features": text_features,
            "grads": first_grads,
            "params": {n: p.detach() for n, p in leaves.items()}}
