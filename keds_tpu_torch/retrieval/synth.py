"""Synthetic embedding corpora with realistic CLIP-feature geometry (a
numpy copy of ``keds_tpu/retrieval/synth.py``; the same seed gives the same
arrays bit for bit).

Real CLIP features occupy a narrow cone, are clustered and have an
anisotropic spectrum; all three compress the score distribution, so the gap
between the k-th and (k+1)-th neighbour shrinks toward the int8 grid's
noise.  :func:`correlated_embeddings` draws such corpora, with ``spread``
setting how tight the clusters are (0.35 close to measured CLIP corpora,
0.15 tighter, 0.05 near-duplicates).  :func:`structured_images` draws images
with natural-image statistics, and :func:`inject_outlier_channels` gives a
tower the huge hidden channels of trained transformers.  Used by
``tools/quant_accuracy.py`` and the int8 tests.
"""

from __future__ import annotations

import numpy as np


def correlated_embeddings(
    rng: np.random.Generator,
    n: int,
    dim: int,
    *,
    n_clusters: int = 64,
    alpha: float = 1.0,
    cone: float = 1.0,
    spread: float = 0.35,
    basis: tuple | None = None,
) -> np.ndarray:
    """Unit-norm (n, dim) float32 embeddings: shared cone direction +
    cluster centers + power-law anisotropic within-cluster noise.

    ``basis`` lets callers draw queries and corpus from the SAME geometry —
    pass a :func:`shared_geometry` result; by default a fresh
    cone/basis/centers set is drawn from ``rng``.
    """
    if basis is None:
        basis = shared_geometry(rng, dim, n_clusters=n_clusters, alpha=alpha)
    mu, U, lam, centers = basis
    assign = rng.integers(0, len(centers), n)
    noise = (rng.standard_normal((n, dim)) * lam) @ U.T
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    x = cone * mu[None, :] + centers[assign] + spread * noise
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def shared_geometry(rng: np.random.Generator, dim: int, *,
                    n_clusters: int = 64, alpha: float = 1.0):
    """Draw the (cone, basis, spectrum, centers) tuple once so corpus and
    queries share clusters — queries landing inside corpus clusters is what
    makes retrieval hard; independent geometries would decorrelate them."""
    lam = np.arange(1, dim + 1, dtype=np.float64) ** -alpha
    U = np.linalg.qr(rng.standard_normal((dim, dim)))[0]
    mu = rng.standard_normal(dim)
    mu /= np.linalg.norm(mu)
    centers = (rng.standard_normal((n_clusters, dim)) * lam) @ U.T
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return mu, U, lam, centers


def inject_outlier_channels(params: dict, *, towers=("visual", "text"),
                            n_channels: int = 4, magnitude: float = 20.0,
                            seed: int = 4) -> dict:
    """A copy of a port CLIP parameter dict with ``n_channels`` random MLP
    hidden channels scaled by ``magnitude`` in every block of each tower
    (and the matching proj rows shrunk to keep output magnitudes sane).

    Trained transformers develop a few huge-magnitude hidden channels, the
    classic per-token-int8 hazard; random weights have none, which flatters
    quantization.  The outlier model is its own reference: quantization
    accuracy is measured against its outputs.  The channels come from
    ``np.random.default_rng(seed)``, as in the JAX package, and the scaling
    runs in f32 numpy before the cast back to each weight's dtype."""
    import torch

    out = dict(params)
    for tower in towers:
        blocks = dict(out[tower]["blocks"])
        fc_t, pj_t = blocks["fc_w"], blocks["proj_w"]
        fc = fc_t.detach().float().cpu().numpy().copy()
        pj = pj_t.detach().float().cpu().numpy().copy()
        cols = np.random.default_rng(seed).integers(0, fc.shape[-1], n_channels)
        fc[..., cols] *= magnitude
        pj[..., cols, :] /= magnitude
        out[tower] = {**out[tower],
                      "blocks": {**blocks,
                                 "fc_w": torch.from_numpy(fc).to(fc_t.device, fc_t.dtype),
                                 "proj_w": torch.from_numpy(pj).to(pj_t.device, pj_t.dtype)}}
    return out


def structured_images(rng: np.random.Generator, n: int, res: int) -> np.ndarray:
    """(n, res, res, 3) float32 images with natural-image statistics rather
    than i.i.d. pixel noise: low-frequency sinusoid mixtures + smooth color
    gradients + a few sharp blobs.  Tower activations on these are spatially
    correlated (like real photos), which is the regime where per-token
    activation quantization actually gets exercised — white noise spreads
    activation mass evenly and hides outlier behaviour."""
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res),
                         indexing="ij")
    out = np.empty((n, res, res, 3), np.float32)
    for i in range(n):
        img = np.zeros((res, res, 3), np.float32)
        for _ in range(4):  # low-frequency sinusoid mixture
            fx, fy = rng.uniform(0.5, 4, 2)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.2, 0.6)
            wave = np.sin(2 * np.pi * (fx * xx + fy * yy) + ph) * amp
            img += wave[:, :, None] * rng.uniform(0.3, 1.0, 3)
        gx, gy = rng.uniform(-1, 1, 2)  # smooth gradient
        img += (gx * xx + gy * yy)[:, :, None] * rng.uniform(0.2, 0.8, 3)
        for _ in range(rng.integers(1, 4)):  # sharp blobs
            cx, cy = rng.uniform(0.2, 0.8, 2)
            r2 = (xx - cx) ** 2 + (yy - cy) ** 2
            img += np.exp(-r2 / rng.uniform(0.002, 0.02))[:, :, None] \
                * rng.uniform(-1.5, 1.5, 3)
        out[i] = img
    out -= out.mean(axis=(1, 2, 3), keepdims=True)
    out /= out.std(axis=(1, 2, 3), keepdims=True) + 1e-6
    return out
