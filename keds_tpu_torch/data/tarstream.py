"""Tar-shard streaming dataset (counterpart of ``keds_tpu/data/tarstream.py``),
for one process.

The reference's WebDataset pipeline (``src/data.py:78-231, 875-953``):
brace-expanded shard lists, a shard shuffle and a 5000-sample shuffle
buffer, grouping of tar members into samples by key prefix (a repeated
suffix starts a new sample), decode with drop-and-log on error, a caption
looked up by ``__key__`` in a caption map, fixed-size batches and an epoch
budget of ``train_num_samples // batch_size`` batches.  With ``resampled``
the shards are drawn with replacement (weighted per source by
``upsampling_factors``).  The order is the JAX package's at rank 0 of one:
shards shuffled by ``random.Random(seed + epoch)`` (resampled draws by
``random.Random(f"{seed}:0:{epoch}")``), and the buffer fills before it yields.

Decode runs in the calling thread, or in a pool of ``workers`` threads with
an order-preserving window.  Process pools and the multi-rank shard split
wait for ROADMAP.md section A item 10.
"""

from __future__ import annotations

import collections
import io
import logging
import os
import random
import re
import tarfile
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np


def braceexpand(pattern: str) -> List[str]:
    """Expand one ``{00000..00099}`` (or ``{a,b,c}``) range in a shard URL."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        return [pattern[:m.start()] + str(i).zfill(width) + pattern[m.end():]
                for i in range(int(lo), int(hi) + 1)]
    m = re.search(r"\{([^{}]*,[^{}]*)\}", pattern)
    if m:
        return [pattern[:m.start()] + part + pattern[m.end():]
                for part in m.group(1).split(",")]
    return [pattern]


def base_plus_ext(path: str):
    """Split 'dir/abc.image_byte' -> ('dir/abc', 'image_byte') (extension
    lowercased); (None, None) for hidden or extension-less members."""
    m = re.match(r"^((?:.*/)?[^.]+)\.([^/]*)$", path)
    if not m:
        return None, None
    return m.group(1), m.group(2).lower()


def group_tar_samples(members: Iterable) -> Iterator[Dict[str, bytes]]:
    """Group (name, bytes) pairs into {'__key__', suffix: bytes} samples; a
    repeated suffix starts a new sample instead of raising."""
    current: Optional[Dict[str, object]] = None
    for fname, data in members:
        prefix, suffix = base_plus_ext(fname)
        if prefix is None:
            continue
        if current is None or prefix != current["__key__"] or suffix in current:
            if current is not None and len(current) > 1:
                yield current  # type: ignore[misc]
            current = {"__key__": prefix}
        current[suffix] = data
    if current is not None and len(current) > 1:
        yield current  # type: ignore[misc]


def iter_tar(path: str) -> Iterator:
    """(member basename, bytes) of a tar's files; a read error ends the
    shard with a warning and the stream goes on."""
    try:
        with tarfile.open(path, mode="r|*") as tf:
            for member in tf:
                if not member.isfile():
                    continue
                f = tf.extractfile(member)
                if f is None:
                    continue
                yield os.path.basename(member.name), f.read()
    except (OSError, EOFError, tarfile.TarError) as exn:
        logging.warning("tar stream error in %s (%r); continuing", path, exn)


class ShuffleBuffer:
    """Streaming reservoir shuffle (webdataset's bufsize / initial)."""

    def __init__(self, bufsize: int, initial: int, rng: random.Random):
        self.bufsize, self.initial, self.rng = bufsize, initial, rng

    def __call__(self, src: Iterable) -> Iterator:
        buf: List = []
        for sample in src:
            buf.append(sample)
            if len(buf) < max(self.initial, 1):
                continue
            if len(buf) >= self.bufsize:
                yield buf.pop(self.rng.randrange(len(buf)))
        self.rng.shuffle(buf)
        yield from buf


class TarShardDataset:
    """Iterable (image, caption tokens) batches over tar shards.

    ``urls`` is a brace pattern (several sources joined by ``::``) or a list
    of shard paths.  ``decode_image`` turns a sample's ``image_key`` bytes
    into an array; ``tokenize`` (optional) the caption into tokens.
    """

    def __init__(self, urls, *, batch_size: int,
                 decode_image: Callable[[bytes], Optional[np.ndarray]],
                 caption_map: Optional[Dict[str, object]] = None,
                 tokenize: Optional[Callable] = None, image_key: str = "image_byte",
                 shuffle_shards: bool = True, shuffle_buffer: int = 5000, seed: int = 0,
                 train_num_samples: int = 2_803_766,   # reference default, src/data.py:880
                 partial_batches: bool = False, resampled: bool = False,
                 upsampling_factors=None, workers: int = 0):
        if isinstance(urls, str):
            sources = [braceexpand(u) for u in urls.split("::")]
        else:
            sources = [list(urls)]
        self.shards = [s for src in sources for s in src]
        self.shard_weights: Optional[List[float]] = None
        if upsampling_factors is not None and upsampling_factors != "":
            if isinstance(upsampling_factors, str):
                factors = [float(x) for x in upsampling_factors.split("::")]
            else:
                factors = [float(x) for x in upsampling_factors]
            if len(factors) != len(sources):
                raise ValueError(
                    f"--train-data-upsampling-factors has {len(factors)} entries but "
                    f"--train-data names {len(sources)} sources")
            if not resampled:
                raise ValueError(
                    "--train-data-upsampling-factors requires --dataset-resampled "
                    "(weights only apply to the with-replacement shard draw)")
            self.shard_weights = [f for f, src in zip(factors, sources) for _ in src]
        self.resampled = resampled
        self.batch_size = batch_size
        self.decode_image = decode_image
        self.caption_map = caption_map or {}
        self.tokenize = tokenize
        self.image_key = image_key
        self.shuffle_shards = shuffle_shards
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.partial_batches = partial_batches
        self.workers = workers
        self.epoch = 0
        self._pool: Optional[ThreadPoolExecutor] = None
        self.num_batches = train_num_samples // batch_size
        self.num_samples = self.num_batches * batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _shard_stream(self) -> tuple:
        """(shard iterator, the generator the shuffle buffer then draws from)."""
        if self.resampled:
            rng = random.Random(f"{self.seed}:0:{self.epoch}")

            def draws() -> Iterator[str]:
                while True:
                    yield rng.choices(self.shards, weights=self.shard_weights, k=1)[0]
            return draws(), rng
        rng = random.Random(self.seed + self.epoch)
        shards = list(self.shards)
        if self.shuffle_shards:
            rng.shuffle(shards)
        return iter(shards), rng

    def _samples(self) -> Iterator[dict]:
        shards, rng = self._shard_stream()
        raw = (s for shard in shards for s in group_tar_samples(iter_tar(shard)))
        yield from ShuffleBuffer(self.shuffle_buffer, self.shuffle_buffer // 5, rng)(raw)

    def _decode(self, sample: dict) -> Optional[tuple]:
        key = os.path.basename(str(sample["__key__"]))
        raw = sample.get(self.image_key)
        if raw is None:
            return None
        try:
            img = self.decode_image(raw)
        except Exception as exn:    # a corrupt image is dropped, as the reference does
            logging.warning("decode error for %s (%r); dropping", key, exn)
            return None
        if img is None:
            return None
        cap = self.caption_map.get(key)
        if cap is None:
            logging.warning("no caption for %s; dropping", key)
            return None
        if self.tokenize is not None:
            cap = self.tokenize([str(cap)])[0]
        return img, cap

    def _decoded(self) -> Iterator[Optional[tuple]]:
        """Decoded samples in stream order; with ``workers`` > 0 a thread
        pool decodes a bounded window ahead."""
        if self.workers <= 0:
            for sample in self._samples():
                yield self._decode(sample)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.workers)
        window = max(2 * self.batch_size, 4 * self.workers)
        inflight: collections.deque = collections.deque()
        try:
            for sample in self._samples():
                inflight.append(self._pool.submit(self._decode, sample))
                if len(inflight) >= window:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()
        finally:
            # the consumer stops at the epoch budget: drop the queued window,
            # keep the pool for the next epoch
            for f in inflight:
                f.cancel()

    def close(self) -> None:
        """Shut the decode pool down (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __iter__(self) -> Iterator[tuple]:
        images: List = []
        caps: List = []
        produced = 0
        # a stream of nothing but undecodable samples (a wrong caption map or
        # image key) fails instead of spinning through a resampled stream
        per_shard = self.num_samples // max(len(self.shards), 1)
        drop_limit = max(10_000, 8 * self.batch_size * max(self.workers, 1), 4 * per_shard)
        dropped_streak = 0
        for out in self._decoded():
            if produced >= self.num_batches:
                return
            if out is None:
                dropped_streak += 1
                if dropped_streak >= drop_limit:
                    raise RuntimeError(
                        f"{dropped_streak} consecutive samples dropped without one valid "
                        "decode: check --caption-map, the image key and the shards")
                continue
            dropped_streak = 0
            images.append(out[0])
            caps.append(out[1])
            if len(images) == self.batch_size:
                yield np.stack(images), np.stack(caps)
                images, caps = [], []
                produced += 1
        if images and produced < self.num_batches and self.partial_batches:
            yield np.stack(images), np.stack(caps)


class _PilJpegDecoder:
    """Image bytes -> array through the host PIL pipeline."""

    def __init__(self, n_px: int, is_train: bool, normalize: bool, rng):
        from keds_tpu_torch.transforms import image_transform

        self.tf = image_transform(n_px, is_train=is_train, rng=rng, normalize=normalize)

    def __call__(self, raw: bytes):
        from PIL import Image

        return self.tf(Image.open(io.BytesIO(raw)))


def pil_jpeg_decoder(n_px: int = 224, is_train: bool = True, normalize: bool = True,
                     rng: Optional[random.Random] = None) -> Callable:
    """Bytes -> array decoder with the host PIL pipeline (reference
    my_decoder_kv, src/data.py:866-871); ``normalize=False`` gives uint8,
    normalised on the device.  The train crop draws from ``rng``."""
    return _PilJpegDecoder(n_px, is_train, normalize, rng)


def load_caption_map(path: Optional[str]) -> Dict[str, object]:
    """``--caption-map``: a {key: caption} .json, or a .pkl list of
    {'filename', 'text'} records (the reference's ``cc3m_have*.pkl``)."""
    if not path:
        return {}
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            return {e["filename"]: e["text"] for e in pickle.load(f)}
    import json

    with open(path) as f:
        return json.load(f)

