"""Bi-modality knowledge database and exact retrieval (counterpart of
``keds_tpu/retrieval/database.py``).

The DB is two unit-normalised (N, D) tensors (image and caption features,
bf16 by default) resident on the device; the neighbour search is
:func:`keds_tpu_torch.ops.topk.mips_topk`, the fused kernel on the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from keds_tpu_torch.ops.topk import mips_topk
from keds_tpu_torch.runtime import DeviceLike, resolve_device


def _read_array(path: str):
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[z.files[0]]
    return torch.load(path, map_location="cpu", weights_only=True)


@dataclasses.dataclass
class KnowledgeDB:
    """Unit-normalised embedding database for both modalities."""

    image_db: torch.Tensor   # (N, D)
    text_db: torch.Tensor    # (N, D)
    names: List[str]

    @property
    def size(self) -> int:
        return int(self.image_db.shape[0])

    @property
    def dim(self) -> int:
        return int(self.image_db.shape[1])

    @classmethod
    def from_arrays(cls, image, text, names: Optional[List[str]] = None,
                    dtype: torch.dtype = torch.bfloat16, normalize: bool = True,
                    device: DeviceLike = None) -> "KnowledgeDB":
        """Arrays or tensors -> a DB on ``device``; rows are L2-normalised in
        f32 with numpy, as the JAX package does (a norm summed in another
        order rounds some rows otherwise), before the cast to ``dtype``."""
        dev = resolve_device(device)

        def place(a):
            # torch.load gives tensors (possibly bf16, which numpy lacks);
            # numpy arrays are copied out of a read-only .npy memory map
            a = (a.float().cpu().numpy() if isinstance(a, torch.Tensor)
                 else np.array(a, np.float32))
            if normalize:
                a = a / np.linalg.norm(a, axis=1, keepdims=True)
            return torch.from_numpy(a).to(dev, dtype)

        image_t, text_t = place(image), place(text)
        names = names if names is not None else [str(i) for i in range(len(image_t))]
        return cls(image_t, text_t, names)

    @classmethod
    def load(cls, image_file: str, text_file: str, names_file: Optional[str] = None,
             dtype: torch.dtype = torch.bfloat16,
             device: DeviceLike = None) -> "KnowledgeDB":
        """Load ``cc_image_databases.pt`` / ``cc_text_databases.pt`` (.pt via
        ``torch.load``, .npy or .npz) and ``database_names.txt``."""
        names: Optional[List[str]] = None
        if names_file and os.path.isfile(names_file):
            with open(names_file) as f:
                names = [line.strip() for line in f]
        logging.info("Loading knowledge DB: %s / %s", image_file, text_file)
        db = cls.from_arrays(_read_array(image_file), _read_array(text_file),
                             names, dtype, device=device)
        logging.info("Knowledge DB ready: %d rows, dim %d", db.size, db.dim)
        return db

    @classmethod
    def from_directory(cls, path: str, dtype: torch.dtype = torch.bfloat16,
                       device: DeviceLike = None) -> "KnowledgeDB":
        """The ``--database-path`` layout: ``cc_{image,text}_databases.pt``
        (or ``{image,text}_db.npy`` / ``.npz``) and ``database_names.txt``."""
        files = [_first_existing(path, modality) for modality in ("image", "text")]
        for f, modality in zip(files, ("image", "text")):
            if f is None:
                raise FileNotFoundError(f"knowledge DB: no cc_{modality}_databases.pt, "
                                        f"{modality}_db.npy or {modality}_db.npz in {path}")
        return cls.load(*files, os.path.join(path, "database_names.txt"), dtype, device)

    @classmethod
    def from_config(cls, cfg, dtype: torch.dtype = torch.bfloat16,
                    device: DeviceLike = None) -> "KnowledgeDB":
        """The DB files of a config: ``--database-path``'s layout
        (:meth:`from_directory`), each file overridden by ``--db-image-file``,
        ``--db-text-file`` or ``--db-names-file``."""
        img, txt, names = cfg.db_image_file, cfg.db_text_file, cfg.db_names_file
        if cfg.database_path:
            base = cfg.database_path
            img = img or _first_existing(base, "image")
            txt = txt or _first_existing(base, "text")
            names = names or os.path.join(base, "database_names.txt")
        if not (img and txt):
            raise FileNotFoundError("knowledge database not found; pass --database-path "
                                    "or --db-image-file/--db-text-file")
        return cls.load(img, txt, names, dtype, device)


def _first_existing(base: str, modality: str) -> Optional[str]:
    """``cc_<modality>_databases.pt``, ``<modality>_db.npy`` or ``.npz`` in
    ``base``, the first that exists."""
    for name in (f"cc_{modality}_databases.pt", f"{modality}_db.npy", f"{modality}_db.npz"):
        if os.path.isfile(os.path.join(base, name)):
            return os.path.join(base, name)
    return None


def db_fingerprint(db: KnowledgeDB) -> dict:
    """Identity of a knowledge DB for staleness checks of precomputed
    neighbour packs: row count, sha1 of the names, and a sha1 over a 64-row
    strided subsample of both tables as f32 bytes."""
    n_rows = len(db.names)
    sig = hashlib.sha1()
    idx = np.unique(np.linspace(0, max(n_rows - 1, 0), num=min(64, n_rows)).astype(int))
    for arr in (db.image_db, db.text_db):
        rows = arr[torch.as_tensor(idx, device=arr.device)].float().cpu().numpy()
        sig.update(np.ascontiguousarray(rows).tobytes())
    return {"rows": n_rows,
            "names_sha1": hashlib.sha1("\n".join(db.names).encode()).hexdigest(),
            "db_rows_sha1": sig.hexdigest()}


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` over its L2 norm along the last axis, in ``x``'s dtype."""
    return x / x.norm(dim=-1, keepdim=True)


class Retriever:
    """Exact top-k retrieval of both modalities over a :class:`KnowledgeDB`
    (the reference's ``get_retrieved_features`` and, for the text stream,
    ``get_extra_cap_features``).  At eval the image neighbours are not
    shuffled: cross-attention is permutation-invariant over keys and values,
    so the shuffle changes nothing there."""

    def __init__(self, db: KnowledgeDB):
        self.db = db

    def search(self, queries: torch.Tensor, db_array: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return mips_topk(queries, db_array, k)

    def _gather(self, db_array: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return db_array[idx.long().clamp(0, db_array.shape[0] - 1)]   # (B, k, D)

    def neighbour_indices(self, feature: torch.Tensor, k: int, text: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Top-k rows of the image DB and (with ``text``) of the caption DB
        for each query: the query is normalised in f32 and cast to the DB
        dtype.  ``text=False`` skips the caption search (None)."""
        q = unit_rows(feature.float()).to(self.db.image_db.dtype)
        img_idx = self.search(q, self.db.image_db, k)[1]
        return img_idx, self.search(q, self.db.text_db, k)[1] if text else None

    def caption_indices(self, feature: torch.Tensor, k: int = 2) -> torch.Tensor:
        """Top-k caption-DB rows for caption queries, normalised (again, for
        the text stream, whose trainer normalises them first) and cast to
        the DB dtype."""
        return self.search(unit_rows(feature).to(self.db.text_db.dtype), self.db.text_db, k)[1]

    def retrieve_features(self, feature: torch.Tensor, k: int = 16,
                          generator: Optional[torch.Generator] = None,
                          idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          text: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Top-k image and caption neighbour rows (B, k, D) for each query, in
        ``feature``'s dtype (:meth:`neighbour_indices`).

        ``idx=(img_idx, txt_idx)``, each (B, k), skips the search and gathers
        those precomputed rows.  ``generator`` (training) draws one
        permutation of the k image neighbours for the whole batch; without
        it (eval, the default) nothing is shuffled.  The gather ->
        permutation -> cast tail is the same either way.  ``text=False``
        (the text stream, which fuses without the caption neighbours)
        neither searches nor gathers them and returns None for them."""
        image_db, text_db = self.db.image_db, self.db.text_db
        if idx is not None:
            img_idx, txt_idx = idx
            if img_idx.shape[1] != k or txt_idx.shape[1] != k:
                raise ValueError(
                    f"precomputed neighbour indices are {img_idx.shape[1]}/"
                    f"{txt_idx.shape[1]} wide but k={k}; slice the pack to k columns")
        else:
            img_idx, txt_idx = self.neighbour_indices(feature, k, text)
        topk_img = self._gather(image_db, img_idx)
        if generator is not None:
            topk_img = topk_img[:, torch.randperm(k, generator=generator,
                                                  device=generator.device)]
        topk_txt = self._gather(text_db, txt_idx).to(feature.dtype) if text else None
        return topk_img.to(feature.dtype), topk_txt

    def retrieve_caption_neighbors(self, feature: torch.Tensor, k: int = 2,
                                   idx: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k caption rows (B, k, D) in ``feature``'s dtype and their
        indices (B, k) (:meth:`caption_indices`); ``idx`` skips the search
        and gathers those precomputed rows through the same tail."""
        if idx is None:
            idx = self.caption_indices(feature, k)
        return self._gather(self.db.text_db, idx).to(feature.dtype), idx
