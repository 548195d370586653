"""What the serving drivers share: the inputs of a composed query made from
the seed, the program built from them through its public entries, and
the plain reference's verdict on sampled answers.

The program gets OpenAI CLIP's state dict and KEDs' head state dicts
through its converters (``clip_from_state_dict``,
``heads_from_checkpoint``), the path a user's checkpoint takes, and the
knowledge DB as a ``KnowledgeDB`` of the tables made on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.harness import reference, traffic, weights


@dataclasses.dataclass
class Inputs:
    clip_sd: Dict[str, torch.Tensor]
    heads: Dict[str, dict]
    tables: Tuple[torch.Tensor, torch.Tensor]
    pool: np.ndarray                  # (n, batch, px, px, 3) uint8, on the host
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def make_inputs(ctx, batch: int, pool_batches: int, heads_dtype: str) -> Inputs:
    cfg, dev = ctx.config, ctx.device
    sd = weights.clip_state_dict(cfg, ctx.seed, dev, dtype(cfg["compute_dtype"]))
    heads = weights.heads_checkpoint(cfg, ctx.seed, dev, dtype(heads_dtype))
    tables = weights.knowledge_tables(cfg, ctx.seed, dev)
    pool = traffic.image_pool(pool_batches, batch, cfg["image_resolution"],
                              weights.generator(ctx.seed, weights.STREAM_IMAGES, dev))
    return Inputs(sd, heads, tables, pool)


def check_config(cfg: dict, clip_cfg) -> None:
    """The widths the program read from the state dict are the file's."""
    for key in ("embed_dim", "image_resolution", "vision_layers", "vision_width",
                "vision_patch_size", "context_length", "vocab_size", "transformer_width",
                "transformer_heads", "transformer_layers"):
        if getattr(clip_cfg, key) != cfg[key]:
            raise ValueError(f"the program read {key}={getattr(clip_cfg, key)} from the "
                             f"state dict; the configuration states {cfg[key]}")


def engine(ctx, inputs: Inputs):
    """The program's serving engine over these inputs (``ctx.control``
    'int8' switches its W8A8 towers on)."""
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models.convert import clip_from_state_dict, heads_from_checkpoint
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    cfg, dev, mix = ctx.config, ctx.device, ctx.mix
    params, clip_cfg = clip_from_state_dict(inputs.clip_sd, device=dev)
    check_config(cfg, clip_cfg)
    heads = heads_from_checkpoint(inputs.heads, device=dev)
    img, txt = inputs.tables
    db = KnowledgeDB(img, txt, [str(i) for i in range(img.shape[0])])
    eng = ComposedQueryEngine(params, clip_cfg, heads, db, split_id=traffic.STAR,
                              db_topk=cfg["db"]["topk"],
                              compute_dtype=dtype(cfg["compute_dtype"]),
                              encode_chunk=mix["encode_chunk"], device=dev,
                              quant_towers=ctx.control or "none")
    plant_fault(eng, ctx.fault)
    return eng


class NeighbourLog:
    """The neighbour ids (image DB, caption DB; each (B, k) on the device)
    that a retriever of the program searched, in call order.  It keeps the
    tensors and copies nothing: no synchronise on the timed path."""

    def __init__(self, retriever):
        self.entries: List[tuple] = []
        self._retriever, self._search = retriever, retriever.neighbour_indices

        def logged(feature, k, text=True):
            ids = self._search(feature, k, text)
            self.entries.append(ids)
            return ids

        retriever.neighbour_indices = logged

    def take(self) -> List[tuple]:
        out, self.entries = self.entries, []
        return out

    def close(self) -> None:
        self._retriever.neighbour_indices = self._search


def shift_neighbours(retriever) -> None:
    """A retrieval fault: every search answers the rows one past its own."""
    search = retriever.neighbour_indices

    def shifted(feature, k, text=True):
        img, txt = search(feature, k, text)
        db = retriever.db
        return ((img + 1) % db.image_db.shape[0],
                None if txt is None else (txt + 1) % db.text_db.shape[0])

    retriever.neighbour_indices = shifted


def plant_fault(eng, fault) -> None:
    """Break the timed path underneath (the harness's own tests): 'half'
    computes the second half of every batch from the first half's images;
    'answer' gives every eighth row of a batch its neighbour's answer;
    'neighbours' retrieves the DB rows one past the right ones."""
    if fault is None:
        return
    if fault == "neighbours":
        shift_neighbours(eng.retriever)
    elif fault == "half":
        encode = eng.encode_features

        def half(images):
            f = encode(images)
            h = f.shape[0] // 2
            return torch.cat([f[:h], f[:f.shape[0] - h]])

        eng.encode_features = half
    elif fault == "answer":
        compose = eng.compose_features

        def altered(f, text):
            out = compose(f, text).clone()
            out[::8] = out[1::8][:out[::8].shape[0]] if out.shape[0] > 1 else -out[::8]
            return out

        eng.compose_features = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")


def reference_features(ctx, inputs: Inputs, images: np.ndarray, text: np.ndarray,
                       block: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain reference's unit composed features of these queries, and
    its image features of their images."""
    dev = ctx.device
    im = torch.from_numpy(images).to(dev)
    tx = torch.from_numpy(text).to(dev)
    with torch.no_grad(), reference.exact_f32():
        return reference.in_blocks(
            lambda s: reference.composed_features(inputs.clip_sd, inputs.heads, inputs.tables,
                                                  im[s], tx[s], ctx.config["db"]["topk"],
                                                  traffic.STAR),
            im.shape[0], block)


def sample_rows(ctx, lengths: Sequence[int], n: int) -> List[int]:
    """``n`` answered rows drawn from the seed, a quarter of them among the
    rows whose caption is the mix's longest."""
    r = traffic.rng(ctx.seed, 6)
    lengths = np.asarray(lengths)
    top = np.flatnonzero(lengths == lengths.max())
    pick = list(r.choice(top, size=min(len(top), max(1, n // 4)), replace=False))
    rest = np.setdiff1d(np.arange(len(lengths)), pick)
    pick += list(r.choice(rest, size=min(len(rest), n - len(pick)), replace=False))
    return sorted(int(i) for i in pick)


def cosine_gap(prog: np.ndarray, ref: torch.Tensor) -> float:
    """The widest 1 - cos between program rows and reference rows."""
    p = torch.from_numpy(np.asarray(prog, np.float32)).to(ref.device)
    cos = (p * ref).sum(1) / (p.norm(dim=1) * ref.norm(dim=1))
    return float((1 - cos).max())


def neighbour_deficit(f_ref: torch.Tensor, tables: Sequence[torch.Tensor],
                      ids: Sequence[torch.Tensor], k: int) -> float:
    """How far the reference's scores of the program's k neighbours sum
    below the reference's own top k, by the reference's unit image features
    ``f_ref`` (B, D), over each table and its program ids (B, k); the mean
    over queries and tables.  Near ties that the program orders otherwise
    cost little; a wrong row costs a whole top score."""
    q = f_ref / f_ref.norm(dim=-1, keepdim=True)
    gaps = []
    with torch.no_grad(), reference.exact_f32():
        for table, idx in zip(tables, ids):
            best = reference.topk_rows(q, table, k)[0].sum(1)
            got = torch.einsum("bd,bkd->b", q, table[idx.to(q.device).long()].float())
            gaps.append(best - got)
    return float(torch.cat(gaps).mean())
