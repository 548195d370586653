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
searches go through the fused kernels there.
"""

from __future__ import annotations

from typing import Iterable, Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from keds_tpu_torch.models import clip as mclip
from keds_tpu_torch.models.composition import FusionHeads, compose_pseudo_tokens
from keds_tpu_torch.models.convert import cast_floating
from keds_tpu_torch.ops.topk import mips_topk
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
from keds_tpu_torch.runtime import DeviceLike, resolve_device
from keds_tpu_torch.tokenizer import bucket_text, star_token_id


class DeviceCorpus(NamedTuple):
    """An encoded retrieval corpus resident on the device."""

    array: torch.Tensor   # (N, D) f32


class ComposedQueryEngine:
    def __init__(self, clip_params: dict, cfg: mclip.ClipConfig, heads: FusionHeads,
                 db: KnowledgeDB, *, split_id: Optional[int] = None, db_topk: int = 16,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 encode_chunk: Optional[int] = mclip.DEFAULT_ENCODE_CHUNK,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if db.image_db.device != self.device:
            raise ValueError(f"knowledge DB is on {db.image_db.device}, engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.clip_c = cast_floating(clip_params, compute_dtype, self.device)
        self.heads = cast_floating(heads, compute_dtype, self.device)
        self.db = db
        self.retriever = Retriever(db)
        self.db_topk = db_topk
        self.split_id = int(star_token_id() if split_id is None else split_id)
        self.encode_chunk = encode_chunk

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def encode_features(self, images: torch.Tensor) -> torch.Tensor:
        """Image-tower features of one batch (not normalised)."""
        return mclip.encode_image_chunked(self.clip_c, self.cfg, images,
                                          self.encode_chunk)

    def compose_features(self, f: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """Retrieval, fusion and the composed text tower for image features
        ``f``; unit-norm result in the compute dtype."""
        ti, tt = self.retriever.retrieve_features(f.float(), k=self.db_topk)
        tok = compose_pseudo_tokens(self.heads, f, ti.to(f.dtype), tt.to(f.dtype))
        out = mclip.encode_text_img_retrieval(self.clip_c, self.cfg, text, tok,
                                              split_id=self.split_id)
        return out / out.norm(dim=-1, keepdim=True)

    # -- corpus -------------------------------------------------------------
    @torch.inference_mode()
    def encode_corpus(self, image_batches: Iterable) -> np.ndarray:
        """Encode target images (NHWC, uint8 or float) into unit-norm f32
        features on the host."""
        outs = []
        for b in image_batches:
            f = self.encode_features(self._to_device(b))
            outs.append((f / f.norm(dim=-1, keepdim=True)).float())
        return torch.cat(outs).cpu().numpy()

    # -- queries ------------------------------------------------------------
    def _compose_device(self, image_batches: Sequence,
                        text_batches: Sequence) -> Iterator[Tuple[torch.Tensor, int]]:
        for im, tx in zip(image_batches, text_batches):
            xi = self._to_device(im)
            xt = self._to_device(bucket_text(tx))
            yield self.compose_features(self.encode_features(xi), xt), xi.shape[0]

    @torch.inference_mode()
    def compose_batch(self, images, text) -> Tuple[torch.Tensor, int]:
        """Composed features of ONE batch, left on the device; (features, n)."""
        ((f, n),) = self._compose_device([images], [text])
        return f, n

    @torch.inference_mode()
    def compose(self, image_batches: Sequence, text_batches: Sequence) -> np.ndarray:
        """Composed query features for (reference image, prompt-with-*) pairs."""
        outs = [f.float() for f, _ in self._compose_device(image_batches, text_batches)]
        return torch.cat(outs).cpu().numpy()

    # -- device-side corpus ranking ------------------------------------------
    def corpus_to_device(self, corpus: np.ndarray) -> DeviceCorpus:
        return DeviceCorpus(torch.as_tensor(np.asarray(corpus, np.float32)).to(self.device))

    @torch.inference_mode()
    def rank(self, q_feats: torch.Tensor, corpus: DeviceCorpus,
             topn: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-``topn`` (scores, indices) of a device corpus, in f32 (the
        fused top-k kernel on the card)."""
        topn = min(topn, corpus.array.shape[0])
        return mips_topk(q_feats.float().contiguous(), corpus.array, topn)

    @torch.inference_mode()
    def search(self, image_batches: Sequence, text_batches: Sequence,
               corpus: Union[np.ndarray, DeviceCorpus],
               topn: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, indices) of the top ``topn`` corpus rows per composed
        query.  A :class:`DeviceCorpus` ranks on the device; a numpy corpus
        ranks on the host."""
        if isinstance(corpus, DeviceCorpus):
            ranked = [self.rank(f, corpus, topn)
                      for f, _ in self._compose_device(image_batches, text_batches)]
            scores = torch.cat([s for s, _ in ranked]).cpu().numpy()
            idx = torch.cat([i for _, i in ranked]).cpu().numpy()
            return scores, idx.astype(np.int64)
        q = self.compose(image_batches, text_batches)
        sims = q @ np.asarray(corpus, np.float32).T
        idx = np.argsort(-sims, axis=1, kind="stable")[:, :topn]
        return np.take_along_axis(sims, idx, axis=1), idx
