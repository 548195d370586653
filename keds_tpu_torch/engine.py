"""ComposedQueryEngine, the serving entry point (counterpart of
``keds_tpu/engine.py``).

A composed query encodes the reference image with the CLIP image tower,
retrieves the top-k image and caption neighbours from the knowledge DB,
fuses them into pseudo tokens, splices those into the prompt at ``*`` and
runs the causal text tower; a corpus is ranked against the unit-norm result.

    engine = ComposedQueryEngine(clip_params, cfg, heads, db)
    corpus = engine.encode_corpus(image_batches)          # (N, D) unit-norm
    scores, idx = engine.search(query_images, query_texts, corpus, topn=10)

The ``*`` token id (``split_id``) comes from the CLIP BPE vocab
(``tokenizer.star_token_id``, which raises ``FileNotFoundError`` without
one) unless the caller passes it.  Everything runs on ``device`` (the CUDA
device unless the caller asks for the CPU); the tower attention and both
searches go through the fused kernels there.  ``retriever`` (a
:class:`~keds_tpu_torch.retrieval.database.Retriever` over ``db``) picks the
retrieval backend, exact by default; ``quant_towers='int8'`` runs the
towers' block GEMMs in W8A8 int8 after the cast to ``compute_dtype``.

Under a ``mesh`` of several ranks every rank feeds the same global batches
(the serving feed): each rank encodes and composes its block of every batch
(:func:`~keds_tpu_torch.parallel.mesh.shard_global_batch`), results come
back in global order on every rank, a DB split with
:meth:`KnowledgeDB.shard_over` is searched across the ranks, and
:meth:`corpus_to_device` splits the corpus rows too, ranked with
:func:`~keds_tpu_torch.ops.topk.mips_topk_sharded`.

While a profile runs, each call and each of its batches is a span, the
batch's stages inside it (:mod:`keds_tpu_torch.profiling`).
"""

from __future__ import annotations

from typing import (Callable, Iterable, Iterator, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from keds_tpu_torch.models import clip as mclip
from keds_tpu_torch.models.composition import FusionHeads, compose_pseudo_tokens
from keds_tpu_torch.models.convert import cast_floating
from keds_tpu_torch.ops.quant import maybe_quantize_clip
from keds_tpu_torch.ops.topk import mips_topk, mips_topk_sharded
from keds_tpu_torch.parallel.mesh import (Mesh, all_gather, fetch_global,
                                          shard_global_batch, shard_rows)
from keds_tpu_torch.profiling import span
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
from keds_tpu_torch.runtime import DeviceLike, resolve_device
from keds_tpu_torch.tokenizer import bucket_text, star_token_id


class DeviceCorpus(NamedTuple):
    """An encoded retrieval corpus resident on the device (under a mesh,
    this rank's block of the rows, padded to a multiple of the ranks)."""

    array: torch.Tensor   # (N, D) f32, or this rank's (N_padded / W, D)
    n_real: int           # the corpus's true row count


class ComposedQueryEngine:
    def __init__(self, clip_params: dict, cfg: mclip.ClipConfig, heads: FusionHeads,
                 db: KnowledgeDB, *, split_id: Optional[int] = None, db_topk: int = 16,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 encode_chunk: Optional[int] = mclip.DEFAULT_ENCODE_CHUNK,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None,
                 retriever: Optional[Retriever] = None, quant_towers: str = "none"):
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = self.mesh.device if self.mesh is not None else resolve_device(device)
        if db.image_db.device != self.device:
            raise ValueError(f"knowledge DB is on {db.image_db.device}, engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.clip_c = maybe_quantize_clip(cast_floating(clip_params, compute_dtype, self.device),
                                          quant_towers)
        self.heads = cast_floating(heads, compute_dtype, self.device)
        self.db = db
        if retriever is not None and retriever.db is not db:
            raise ValueError("the retriever searches another knowledge DB than the engine's")
        self.retriever = retriever if retriever is not None else Retriever(db)
        self.db_topk = db_topk
        self.split_id = int(star_token_id() if split_id is None else split_id)
        self.encode_chunk = encode_chunk

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _rows(self, a) -> Tuple[torch.Tensor, int]:
        """This rank's block of a global batch on the device, and the
        batch's row count."""
        return shard_global_batch(self.mesh, a, self.device)

    def _fetch(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """A batch's rows of every rank in global order, trimmed to ``n``."""
        return fetch_global(self.mesh, x, n)

    def encode_features(self, images: torch.Tensor) -> torch.Tensor:
        """Image-tower features of one batch (not normalised)."""
        return mclip.encode_image_chunked(self.clip_c, self.cfg, images,
                                          self.encode_chunk)

    def compose_features(self, f: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """Retrieval, fusion and the composed text tower for image features
        ``f``; unit-norm result in the compute dtype."""
        ti, tt = self.retriever.retrieve_features(f.float(), k=self.db_topk)
        with span("fuse"):
            tok = compose_pseudo_tokens(self.heads, f, ti.to(f.dtype), tt.to(f.dtype))
        with span("text"):
            out = mclip.encode_text_img_retrieval(self.clip_c, self.cfg, text, tok,
                                                  split_id=self.split_id)
            return out / out.norm(dim=-1, keepdim=True)

    # -- corpus -------------------------------------------------------------
    @torch.inference_mode()
    def encode_corpus(self, image_batches: Iterable) -> np.ndarray:
        """Encode target images (NHWC, uint8 or float) into unit-norm f32
        features on the host."""
        with span("engine.encode_corpus"):
            outs = []
            for b in image_batches:
                with span("engine.batch", step=True):
                    with span("input"):
                        x, n = self._rows(b)
                    with span("encode"):
                        f = self.encode_features(x)
                        f = (f / f.norm(dim=-1, keepdim=True)).float()
                    with span("fetch"):
                        outs.append(self._fetch(f, n))
            with span("fetch"):
                return torch.cat(outs).cpu().numpy()

    # -- queries ------------------------------------------------------------
    def _compose_device(self, image_batches: Sequence, text_batches: Sequence,
                        then: Optional[Callable[[torch.Tensor], object]] = None
                        ) -> Iterator[Tuple[object, int]]:
        """Each batch's composed features, or ``then`` of them, and its row
        count.  A batch is an ``engine.batch`` span, which ends before the
        caller gets its result: ``then`` runs inside it."""
        for im, tx in zip(image_batches, text_batches):
            with span("engine.batch", step=True):
                with span("input"):
                    xi, n = self._rows(im)
                    xt, _ = self._rows(bucket_text(tx))   # one bucket on every rank
                with span("encode"):
                    f = self.encode_features(xi)
                out = self.compose_features(f, xt)
                if then is not None:
                    out = then(out)
            yield out, n

    @torch.inference_mode()
    def compose_batch(self, images, text) -> Tuple[torch.Tensor, int]:
        """Composed features of ONE batch, left on the device (this rank's
        block under a mesh); (features, the batch's row count)."""
        ((f, n),) = self._compose_device([images], [text])
        return f, n

    @torch.inference_mode()
    def compose(self, image_batches: Sequence, text_batches: Sequence) -> np.ndarray:
        """Composed query features for (reference image, prompt-with-*) pairs."""
        with span("engine.compose"):
            feats = list(self._compose_device(image_batches, text_batches))
            with span("fetch"):
                return torch.cat([self._fetch(f.float(), n) for f, n in feats]).cpu().numpy()

    # -- device-side corpus ranking ------------------------------------------
    def corpus_to_device(self, corpus: np.ndarray) -> DeviceCorpus:
        """The corpus on the device; under a mesh, zero rows pad it to a
        multiple of the ranks and this rank keeps its block."""
        host = torch.as_tensor(np.asarray(corpus, np.float32))
        return DeviceCorpus(shard_rows(self.mesh, host).to(self.device), int(host.shape[0]))

    @torch.inference_mode()
    def rank(self, q_feats: torch.Tensor, corpus: DeviceCorpus,
             topn: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-``topn`` (scores, indices) of a device corpus, in f32 (the
        fused top-k kernel on the card).  Under a mesh ``q_feats`` is this
        rank's block of a batch (:meth:`compose_batch`); every rank gets the
        whole padded batch's results, searched over every corpus shard."""
        with span("rank"):
            topn = min(topn, corpus.n_real)
            q = q_feats.float().contiguous()
            if self.mesh is None:
                return mips_topk(q, corpus.array, topn)
            return mips_topk_sharded(all_gather(self.mesh, q).flatten(0, 1), corpus.array,
                                     topn, self.mesh, corpus.n_real)

    @torch.inference_mode()
    def search(self, image_batches: Sequence, text_batches: Sequence,
               corpus: Union[np.ndarray, DeviceCorpus],
               topn: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, indices) of the top ``topn`` corpus rows per composed
        query.  A :class:`DeviceCorpus` ranks on the device; a numpy corpus
        ranks on the host."""
        with span("engine.search"):
            if isinstance(corpus, DeviceCorpus):
                ranked = list(self._compose_device(image_batches, text_batches,
                                                   lambda f: self.rank(f, corpus, topn)))
                with span("fetch"):
                    scores = torch.cat([s[:n] for (s, _), n in ranked]).cpu().numpy()
                    idx = torch.cat([i[:n] for (_, i), n in ranked]).cpu().numpy()
                return scores, idx.astype(np.int64)
            q = self.compose(image_batches, text_batches)
            sims = q @ np.asarray(corpus, np.float32).T
            idx = np.argsort(-sims, axis=1, kind="stable")[:, :topn]
            return np.take_along_axis(sims, idx, axis=1), idx
