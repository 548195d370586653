"""Shared fixtures of the keds_tpu_torch parity tests: one tiny CLIP config
and heads built with the JAX package's initialisers, handed to both
packages as numpy arrays."""

import functools

import numpy as np

import jax

from keds_tpu.models import clip as jclip, heads as jheads
from keds_tpu.models.composition import FusionHeads as JFusionHeads

from keds_tpu_torch.models import clip as tclip
from keds_tpu_torch.models.convert import clip_from_numpy, heads_from_numpy

D = 64
SPLIT_ID = 265
TINY = dict(embed_dim=D, image_resolution=32, vision_layers=2, vision_width=128,
            vision_patch_size=16, transformer_width=D, transformer_heads=1,
            transformer_layers=2)
JCFG = jclip.ClipConfig(**TINY)
TCFG = tclip.ClipConfig(**TINY)


def to_numpy(tree):
    return jax.tree.map(np.array, tree)


@functools.lru_cache()
def jax_models(seed: int = 0):
    """(clip params, FusionHeads) from the JAX initialisers, f32."""
    params = jclip.init_clip(jax.random.key(seed), JCFG)
    k1, k2, k3 = jax.random.split(jax.random.key(seed + 1), 3)
    heads = JFusionHeads(
        img2text=jheads.init_im2text(k1, D, 48, D),
        retrieval_fuse=jheads.init_crossformer(k2, D, D, D, num_layers=3),
        text_condition=jheads.init_crossformer(k3, D, D, D, num_layers=3),
    )
    return params, heads


def port_models(params, heads):
    return (clip_from_numpy(to_numpy(params), device="cpu"),
            heads_from_numpy(to_numpy(heads), device="cpu"))


def prompt_tokens(batch: int, caption_len: int, seed: int = 0) -> np.ndarray:
    """"a photo of * , <caption>" token rows, (batch, 77) int32."""
    rng = np.random.default_rng(seed)
    text = np.zeros((batch, 77), np.int32)
    text[:, 0] = 49406
    text[:, 1:4] = [320, 1125, 539]
    text[:, 4:6] = [SPLIT_ID, 267]
    end = min(6 + caption_len, 76)
    text[:, 6:end] = rng.integers(1000, 40000, (batch, end - 6))
    text[:, end] = 49407
    return text


# A synthetic CLIP merges file: a header line and a few dozen merges in the
# byte-to-unicode alphabet ("Ã ©" is the UTF-8 of "é"), enough to merge
# the words of the templates and test texts.  '*' keeps its id 265.
SYNTHETIC_MERGES = """t h|th e</w>|o f</w>|p h|ph o|pho t|phot o</w>|a n|an d</w>|i n|in g</w>
e r|e s|o n|o r|r e|a t|e n|h a|ha t</w>|d o|do g</w>|c a|ca t</w>|w e|a r|t o|s t
l l</w>|b a|ba ll</w>|c h|ch a|cha s|chas ing</w>|r ed</w>|e d</w>|Ã ©|Ã ©</w>
ca f|caf Ã©</w>|n u|nu m|num b|numb er|number s</w>|1 2</w>|w or|wor ld</w>|l d</w>
x x|xx xx|xxxx xxxx|! !|!! !</w>|' s</w>""".replace("\n", "|").split("|")


def write_synthetic_vocab(path) -> str:
    import gzip

    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: synthetic\n" + "\n".join(SYNTHETIC_MERGES) + "\n")
    return str(path)


def tiny_run_dir(tmp_path):
    """A tiny train-CLI run: packed features (24 samples), a 50-row DB
    directory and a reference-layout CLIP .pt, plus the text stream's
    subject and other-caption maps over the samples and the DB rows."""
    import json

    import torch

    from keds_tpu.models.convert import clip_pytree_to_state_dict

    rng = np.random.default_rng(0)
    data, dbdir = tmp_path / "features", tmp_path / "db"
    data.mkdir()
    dbdir.mkdir()
    n = 24
    img = rng.standard_normal((n, D)).astype(np.float32)
    np.save(data / "image_features.npy", img)
    np.save(data / "text_features.npy",
            (img + 0.3 * rng.standard_normal((n, D))).astype(np.float32))
    names = [f"s{i}" for i in range(n)]
    (data / "names.json").write_text(json.dumps(names))
    np.save(dbdir / "image_db.npy", rng.standard_normal((50, D)).astype(np.float32))
    np.save(dbdir / "text_db.npy", rng.standard_normal((50, D)).astype(np.float32))
    db_names = [f"r{i}" for i in range(50)]
    (dbdir / "database_names.txt").write_text("\n".join(db_names))
    words = "the dog cat ball red hat chasing and of world numbers cafe".split()
    other = {k: " ".join(rng.choice(words, int(rng.integers(1, 9))))
             for k in names + db_names}
    (data / "cc_other.json").write_text(json.dumps(other))
    (data / "cc_subject.json").write_text(json.dumps({k: "a dog" for k in names}))
    params, _ = jax_models()
    clip_path = tmp_path / "clip.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                clip_pytree_to_state_dict(to_numpy(params), JCFG).items()}, clip_path)
    return data, dbdir, clip_path


def run_cli(tmp_path, data, dbdir, clip_path, name, epochs, *extra):
    """The port's train CLI on :func:`tiny_run_dir`'s run, f32 on the CPU;
    returns the checkpoint directory."""
    from keds_tpu_torch.cli.main import main as train_main

    train_main(["--train-data", str(data), "--dataset-type", "directory",
                "--clip-weights", str(clip_path), "--database-path", str(dbdir),
                "--batch-size", "8", "--epochs", str(epochs), "--lr", "1e-3",
                "--warmup", "2", "--skip-scheduler", "--db-topk", "8",
                "--precision", "fp32", "--logs", str(tmp_path / "logs"), "--name", name,
                "--device", "cpu", "--seed", "3", *extra])
    return tmp_path / "logs" / name / "checkpoints"
