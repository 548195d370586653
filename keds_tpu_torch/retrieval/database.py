"""Bi-modality knowledge database and exact retrieval (counterpart of
``keds_tpu/retrieval/database.py``).

The DB is two unit-normalised (N, D) tensors (image and caption features,
bf16 by default) resident on the device; the neighbour search is
:func:`keds_tpu_torch.ops.topk.mips_topk`, the fused kernel on the card.

Under a mesh (``--db-shard``) :meth:`KnowledgeDB.shard_over` keeps only this
rank's block of the rows, and a :class:`Retriever` over it searches with
:func:`~keds_tpu_torch.ops.topk.mips_topk_sharded` and gathers neighbour
rows by global index across the ranks.

``Retriever(db, backend=...)`` takes the JAX package's backends: 'auto',
'xla' and 'pallas' run the exact search (B1 on the card), 'approx' runs it
too (``approx_max_k`` is exact off the TPU, see
:func:`~keds_tpu_torch.ops.topk.mips_topk_approx`), and 'int8' scores an
int8 copy of each table and re-ranks the candidates against the true rows
(:func:`~keds_tpu_torch.ops.topk.mips_topk_int8`).  The int8 copy is the
DB's pre-quantized artifacts (``build_database --int8``, read with the DB
by :meth:`KnowledgeDB.from_config`) or, without them, quantized once on the
device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from keds_tpu_torch.ops.quant import pad_depth
from keds_tpu_torch.ops.topk import (mips_topk, mips_topk_approx, mips_topk_int8,
                                     mips_topk_int8_sharded, mips_topk_sharded,
                                     quantize_int8)
from keds_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce_sum, shard_rows
from keds_tpu_torch.profiling import span
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
    """Unit-normalised embedding database for both modalities.  ``names``
    hold the true row count; with ``mesh`` the tables are this rank's block
    of the rows padded to a multiple of the world size."""

    image_db: torch.Tensor   # (N, D), or this rank's (N_padded / W, D)
    text_db: torch.Tensor
    names: List[str]
    mesh: Optional[Mesh] = None   # the mesh the rows are split over
    # pre-quantized int8 artifacts, {"image"|"text": (int8 (N, D), f32 (N,))}
    # numpy arrays of all N rows (memory-mapped); the int8 Retriever places them
    quant: Optional[dict] = None

    @property
    def size(self) -> int:
        """Rows held on this device."""
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
        db = cls.load(img, txt, names, dtype, device)
        if cfg.database_path:
            quant = _load_int8_artifacts(cfg.database_path)
            # artifacts of another sampling (a rebuild with another --size or
            # --seed, or a --db-*-file elsewhere) would give wrong neighbours
            if quant is not None and any(
                    quant[m][0].shape != tuple(getattr(db, f"{m}_db").shape)
                    or quant[m][1].shape[0] != db.size for m in ("image", "text")):
                logging.warning("ignoring int8 artifacts in %s: shape mismatch vs the "
                                "loaded DB (%s rows) — rebuild with build_database --int8",
                                cfg.database_path, db.size)
                quant = None
            db.quant = quant
        return db

    def shard_over(self, mesh: Mesh) -> "KnowledgeDB":
        """Split the rows over the mesh (the counterpart of faiss
        ``index_cpu_to_all_gpus``): zero rows pad the tables to a multiple
        of the world size and this rank keeps its contiguous block on its
        device.  The unsharded DB may live on the CPU."""
        def place(a):
            return shard_rows(mesh, a).to(mesh.device, copy=True)

        return KnowledgeDB(place(self.image_db), place(self.text_db), self.names, mesh,
                           self.quant)


def _first_existing(base: str, modality: str) -> Optional[str]:
    """``cc_<modality>_databases.pt``, ``<modality>_db.npy`` or ``.npz`` in
    ``base``, the first that exists."""
    for name in (f"cc_{modality}_databases.pt", f"{modality}_db.npy", f"{modality}_db.npz"):
        if os.path.isfile(os.path.join(base, name)):
            return os.path.join(base, name)
    return None


def _load_int8_artifacts(base: str) -> Optional[dict]:
    """The int8 artifacts ``tools/build_database.py --int8`` writes
    (``{image,text}_db_int8.npy`` memory-mapped and ``*_db_scale.npy``), or
    None unless all four files exist."""
    out = {}
    for name in ("image", "text"):
        qf = os.path.join(base, f"{name}_db_int8.npy")
        sf = os.path.join(base, f"{name}_db_scale.npy")
        if not (os.path.isfile(qf) and os.path.isfile(sf)):
            return None
        out[name] = (np.load(qf, mmap_mode="r"), np.asarray(np.load(sf), np.float32))
    logging.info("loaded pre-quantized int8 DB artifacts from %s", base)
    return out


def db_fingerprint(db: KnowledgeDB) -> dict:
    """Identity of a knowledge DB for staleness checks of precomputed
    neighbour packs: row count, sha1 of the names, and a sha1 over a 64-row
    strided subsample of both tables as f32 bytes."""
    n_rows = len(db.names)
    sig = hashlib.sha1()
    idx = np.unique(np.linspace(0, max(n_rows - 1, 0), num=min(64, n_rows)).astype(int))
    for arr in (db.image_db, db.text_db):
        gidx = torch.as_tensor(idx, device=arr.device)
        rows = (global_rows(db.mesh, arr, gidx) if db.mesh is not None
                else arr[gidx]).float().cpu().numpy()
        sig.update(np.ascontiguousarray(rows).tobytes())
    return {"rows": n_rows,
            "names_sha1": hashlib.sha1("\n".join(db.names).encode()).hexdigest(),
            "db_rows_sha1": sig.hexdigest()}


def global_rows(mesh: Mesh, shard: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Rows of a row-sharded table by global index (``gidx`` the same on
    every rank), on every rank: each rank writes the rows it owns and zeros
    for the rest, then a sum over the ranks, exact because every entry has
    one nonzero term."""
    m = shard.shape[0]
    local = gidx.long().clamp(0, m * mesh.size - 1) - mesh.rank * m
    owned = ((local >= 0) & (local < m))[..., None]
    rows = torch.where(owned, shard[local.clamp(0, m - 1)], shard.new_zeros(()))
    return all_reduce_sum(mesh, rows)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` over its L2 norm along the last axis, in ``x``'s dtype."""
    return x / x.norm(dim=-1, keepdim=True)


class Retriever:
    """Exact top-k retrieval of both modalities over a :class:`KnowledgeDB`
    (the reference's ``get_retrieved_features`` and, for the text stream,
    ``get_extra_cap_features``).  At eval the image neighbours are not
    shuffled: cross-attention is permutation-invariant over keys and values,
    so the shuffle changes nothing there.

    A DB split by :meth:`~KnowledgeDB.shard_over` is searched and gathered
    across the ranks of its mesh.  Every rank passes its own rows of one
    global batch (equal blocks) and gets its own rows back: the queries are
    all-gathered, searched on every shard and merged
    (:func:`~keds_tpu_torch.ops.topk.mips_topk_sharded`), and the neighbour
    rows are read by global index (:func:`global_rows`).

    ``backend`` is one of :data:`BACKENDS` (the module docstring).  The
    int8 backend's index arrays (:meth:`quant_arrays`) follow the DB's rows:
    with a mesh each rank holds its block of them, padded as the tables.
    Their depth is zero-padded once to a multiple of 8, the depth
    ``torch._int_mm`` takes, so that no search copies the DB."""

    BACKENDS = ("auto", "xla", "pallas", "int8", "approx")

    def __init__(self, db: KnowledgeDB, backend: str = "xla"):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown retrieval backend {backend!r}; one of {self.BACKENDS}")
        self.db = db
        self.backend = backend
        self._int8: dict = {}
        if backend == "int8":
            for name, arr in (("image", db.image_db), ("text", db.text_db)):
                if db.quant is not None:
                    q8, scale = (torch.from_numpy(np.array(a)) for a in db.quant[name])
                    if db.mesh is not None:     # this rank's block, zero-padded
                        q8, scale = shard_rows(db.mesh, q8), shard_rows(db.mesh, scale)
                    q8, scale = q8.to(arr.device), scale.to(arr.device)
                else:
                    q8, scale = quantize_int8(arr)
                self._int8[name] = (pad_depth(q8), scale)

    def quant_arrays(self):
        """((image int8, image scales), (text int8, text scales)) of the int8
        backend (this rank's rows under a mesh), or None for the others."""
        if self.backend != "int8":
            return None
        return self._int8["image"], self._int8["text"]

    def _local_search(self, queries: torch.Tensor, db_array: torch.Tensor, k: int,
                      modality: str) -> Tuple[torch.Tensor, torch.Tensor]:
        mesh, n_real = self.db.mesh, len(self.db.names)
        if self.backend == "int8":
            # the int8 scan proposes candidates; the order comes from the
            # re-rank against the true rows, resident for the gather anyway
            q8, scale = self._int8[modality]
            if mesh is None:
                return mips_topk_int8(queries.float(), q8, scale, k, db=db_array)
            return mips_topk_int8_sharded(queries.float(), q8, scale, k, mesh, n_real,
                                          db_shard=db_array)
        if mesh is None:
            return (mips_topk_approx if self.backend == "approx" else mips_topk)(
                queries, db_array, k)
        return mips_topk_sharded(queries, db_array, k, mesh, n_real, self.backend)

    def search(self, queries: torch.Tensor, db_array: torch.Tensor, k: int,
               modality: str = "image") -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k of ``db_array`` (the DB's ``modality`` table) for this
        rank's queries; under a mesh every rank's queries are searched over
        every shard and each rank keeps its own rows of the result."""
        mesh = self.db.mesh
        if mesh is None:
            return self._local_search(queries, db_array, k, modality)
        q = all_gather(mesh, queries).flatten(0, 1)
        vals, idx = self._local_search(q, db_array, k, modality)
        return shard_rows(mesh, vals), shard_rows(mesh, idx)

    def _gather(self, db_array: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        mesh = self.db.mesh
        if mesh is not None:   # (B, k, D): rows of the global batch's indices, own block kept
            gidx = all_gather(mesh, idx).flatten(0, 1)
            return shard_rows(mesh, global_rows(mesh, db_array, gidx))
        return db_array[idx.long().clamp(0, db_array.shape[0] - 1)]   # (B, k, D)

    def neighbour_indices(self, feature: torch.Tensor, k: int, text: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Top-k rows of the image DB and (with ``text``) of the caption DB
        for each query: the query is normalised in f32 and cast to the DB
        dtype.  ``text=False`` skips the caption search (None)."""
        q = unit_rows(feature.float()).to(self.db.image_db.dtype)
        img_idx = self.search(q, self.db.image_db, k, "image")[1]
        return img_idx, self.search(q, self.db.text_db, k, "text")[1] if text else None

    def caption_indices(self, feature: torch.Tensor, k: int = 2) -> torch.Tensor:
        """Top-k caption-DB rows for caption queries, normalised (again, for
        the text stream, whose trainer normalises them first) and cast to
        the DB dtype."""
        return self.search(unit_rows(feature).to(self.db.text_db.dtype), self.db.text_db, k,
                           "text")[1]

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
        neither searches nor gathers them and returns None for them.  It is
        the ``retrieve`` span (:mod:`keds_tpu_torch.profiling`)."""
        image_db, text_db = self.db.image_db, self.db.text_db
        if idx is not None:
            img_idx, txt_idx = idx
            if img_idx.shape[1] != k or txt_idx.shape[1] != k:
                raise ValueError(
                    f"precomputed neighbour indices are {img_idx.shape[1]}/"
                    f"{txt_idx.shape[1]} wide but k={k}; slice the pack to k columns")
        with span("retrieve"):
            if idx is None:
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

    def names_for(self, idx) -> List[str]:
        """The DB names at ``idx``, flattened: a numpy array or a tensor on
        any device, of global rows (a sharded DB's names are the whole
        DB's)."""
        flat = idx.reshape(-1).tolist() if torch.is_tensor(idx) else np.asarray(idx).reshape(-1)
        return [self.db.names[i] for i in flat]
