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


# --- evaluation ----------------------------------------------------------------

N_IMGS = 12
N_QUERIES = 6


def _rand_png(path, rng):
    from PIL import Image

    Image.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(path)


def write_eval_tree(root) -> str:
    """The tiny on-disk CIRR val and test, Fashion-IQ (dress), COCO-csv and
    ImageNet-list trees of tests/test_eval_integration.py, under one data
    root; returns it."""
    import csv
    import json

    rng = np.random.default_rng(1)
    cirr = root / "CIRR"
    for d in ("dev", "test1", "captions", "image_splits"):
        (cirr / d).mkdir(parents=True)
    names = [f"img{i}" for i in range(N_IMGS)]
    for n in names:
        _rand_png(cirr / "dev" / f"{n}.png", rng)
    caps = [{"reference": names[q], "target_hard": names[(q + 1) % N_IMGS],
             "caption": f"make it more colorful {q}"} for q in range(N_QUERIES)]
    (cirr / "captions" / "cap.rc2.val.json").write_text(json.dumps(caps))
    (cirr / "image_splits" / "split.rc2.val.json").write_text(
        json.dumps({n: f"dev/{n}.png" for n in names}))
    tnames = [f"t{i}" for i in range(60)]   # the test output lists 50 names
    for n in tnames:
        _rand_png(cirr / "test1" / f"{n}.png", rng)
    tcaps = [{"reference": tnames[q], "caption": f"modify {q}", "pairid": 1000 + q}
             for q in range(4)]
    (cirr / "captions" / "cap.rc2.test1.json").write_text(json.dumps(tcaps))
    (cirr / "image_splits" / "split.rc2.test1.json").write_text(
        json.dumps({n: f"test1/{n}.png" for n in tnames}))

    fiq = root / "fashion-iq"
    for d in ("images", "json", "image_splits"):
        (fiq / d).mkdir(parents=True)
    fnames = [f"d{i}" for i in range(N_IMGS)]
    for n in fnames:
        _rand_png(fiq / "images" / f"{n}.png", rng)
    fcaps = [{"candidate": fnames[q], "target": fnames[(q + 2) % N_IMGS],
              "captions": [f"is red {q}", f"has stripes {q}"]} for q in range(N_QUERIES)]
    (fiq / "json" / "cap.dress.val.json").write_text(json.dumps(fcaps))
    (fiq / "image_splits" / "split.dress.val.json").write_text(json.dumps(fnames))

    coco = root / "coco"
    for d in ("val2017", "val2017_masked", "annotations"):
        (coco / d).mkdir(parents=True)
    rows = []
    for i in range(6):
        name = f"{i:012d}.jpg"
        _rand_png(coco / "val2017" / name, rng)
        _rand_png(coco / "val2017_masked" / name, rng)
        rows.append({"id": name, "query_regions": "2;2;30;30", "query_class": "dog",
                     "classes": "cat;tree"})
    with open(coco / "coco_eval.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)

    imgdir = root / "imgnet" / "imgs"
    imgdir.mkdir(parents=True)
    q_lines, t_lines = [], []
    for i in range(6):
        _rand_png(imgdir / f"q{i}.png", rng)
        q_lines.append(f"imgnet/imgs/q{i}.png {i % 3}")
    for i in range(10):
        _rand_png(imgdir / f"t{i}.png", rng)
        t_lines.append(f"imgnet/imgs/t{i}.png {i % 3}")
    (root / "imgnet" / "imgnet_real_query.txt").write_text("\n".join(q_lines))
    (root / "imgnet" / "imgnet_targets.txt").write_text("\n".join(t_lines))
    return str(root)


def write_branches(root, epochs=(1, 2)):
    """Head checkpoints ``epoch_j.pt`` of an image and a text branch, each
    epoch its own heads, written by keds_tpu's save_train_checkpoint with
    the tiny CLIP of :func:`jax_models`; returns (image_branch, text_branch)."""
    import os

    from keds_tpu.io.checkpoint import save_train_checkpoint

    params, _ = jax_models()
    branches = (str(root / "image_branch"), str(root / "text_branch"))
    for b, branch in enumerate(branches):
        for epoch in epochs:
            _, heads = jax_models(10 * (b + 1) + epoch)
            save_train_checkpoint(os.path.join(branch, f"epoch_{epoch}.pt"), epoch=epoch,
                                  name="t", clip_params=params, clip_cfg=JCFG, heads=heads)
    return branches


def eval_db_arrays(rows: int = 128):
    """The evaluation tests' knowledge DB (image, caption) as f32 arrays."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((rows, D)), rng.standard_normal((rows, D))


# --- ModifiedResNet (RN) checkpoints -----------------------------------------


def rn_state_dict(layers=(1, 1, 1, 1), width=8, resolution=64, embed_dim=16,
                  text_width=64, text_layers=1, seed=0) -> dict:
    """A reference-layout RN CLIP state dict of f32 numpy arrays (the
    reference ``ModifiedResNet`` keys and shapes, ``num_batches_tracked``
    included), random from ``seed``, with non-trivial BatchNorm gains,
    shifts and running statistics.  embed_dim != text_width, as in every
    published RN model."""
    rng = np.random.default_rng(seed)
    sd = {}

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def conv(key, c_in, c_out, k):
        sd[key] = normal((c_out, c_in, k, k), (c_in * k * k) ** -0.5)

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{prefix}.bias"] = normal((c,), 0.1)
        sd[f"{prefix}.running_mean"] = normal((c,), 0.2)
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(7, np.int64)

    conv("visual.conv1.weight", 3, width // 2, 3)
    bn("visual.bn1", width // 2)
    conv("visual.conv2.weight", width // 2, width // 2, 3)
    bn("visual.bn2", width // 2)
    conv("visual.conv3.weight", width // 2, width, 3)
    bn("visual.bn3", width)
    inplanes = width
    for li, n in enumerate(layers):
        planes = width * 2 ** li
        for bi in range(n):
            pre = f"visual.layer{li + 1}.{bi}"
            conv(f"{pre}.conv1.weight", inplanes, planes, 1)
            bn(f"{pre}.bn1", planes)
            conv(f"{pre}.conv2.weight", planes, planes, 3)
            bn(f"{pre}.bn2", planes)
            conv(f"{pre}.conv3.weight", planes, 4 * planes, 1)
            bn(f"{pre}.bn3", 4 * planes)
            if (li > 0 and bi == 0) or inplanes != 4 * planes:
                conv(f"{pre}.downsample.0.weight", inplanes, 4 * planes, 1)
                bn(f"{pre}.downsample.1", 4 * planes)
            inplanes = 4 * planes
    d, grid = 32 * width, resolution // 32
    sd["visual.attnpool.positional_embedding"] = normal((grid * grid + 1, d), d ** -0.5)
    for name, d_out in (("q", d), ("k", d), ("v", d), ("c", embed_dim)):
        sd[f"visual.attnpool.{name}_proj.weight"] = normal((d_out, d), d ** -0.5)
        sd[f"visual.attnpool.{name}_proj.bias"] = normal((d_out,), 0.02)
    tw = text_width
    sd["token_embedding.weight"] = normal((49408, tw), 0.02)
    sd["positional_embedding"] = normal((77, tw), 0.01)
    for i in range(text_layers):
        pre = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{pre}.{ln}.weight"] = rng.uniform(0.8, 1.2, tw).astype(np.float32)
            sd[f"{pre}.{ln}.bias"] = normal((tw,), 0.02)
        sd[f"{pre}.attn.in_proj_weight"] = normal((3 * tw, tw), tw ** -0.5)
        sd[f"{pre}.attn.in_proj_bias"] = normal((3 * tw,), 0.02)
        sd[f"{pre}.attn.out_proj.weight"] = normal((tw, tw), tw ** -0.5)
        sd[f"{pre}.attn.out_proj.bias"] = normal((tw,), 0.02)
        sd[f"{pre}.mlp.c_fc.weight"] = normal((4 * tw, tw), tw ** -0.5)
        sd[f"{pre}.mlp.c_fc.bias"] = normal((4 * tw,), 0.02)
        sd[f"{pre}.mlp.c_proj.weight"] = normal((tw, 4 * tw), (4 * tw) ** -0.5)
        sd[f"{pre}.mlp.c_proj.bias"] = normal((tw,), 0.02)
    sd["ln_final.weight"] = np.ones(tw, np.float32)
    sd["ln_final.bias"] = np.zeros(tw, np.float32)
    sd["text_projection"] = normal((tw, embed_dim), tw ** -0.5)
    sd["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    return sd


def save_state_dict(sd: dict, path) -> str:
    """``sd`` (numpy arrays) as a torch ``.pt`` of tensors."""
    import torch

    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return str(path)


# --- artifact gate ----------------------------------------------------------------

def write_artifact_fixture(tmp_path):
    """tests/test_validate_artifacts.py's fixture: single-checkpoint image
    and text streams (train checkpoints with CLIP and heads), a 64-row
    ``cc_*_databases.pt`` DB and an 8-image CIRR val tree with 4 queries.
    Returns (image stream, text stream, DB dir, data root)."""
    import json

    from PIL import Image

    from keds_tpu.io.checkpoint import save_train_checkpoint
    from keds_tpu.io.pt import save_pt

    cfg = jclip.ClipConfig(embed_dim=D, image_resolution=32, vision_layers=1, vision_width=64,
                           vision_patch_size=16, transformer_width=D, transformer_heads=1,
                           transformer_layers=1)
    clip_params = jclip.init_clip(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)

    def mk_heads(seed):
        k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
        return JFusionHeads(img2text=jheads.init_im2text(k1, D, 48, D),
                            retrieval_fuse=jheads.init_crossformer(k2, D, D, D, num_layers=3),
                            text_condition=jheads.init_crossformer(k3, D, D, D, num_layers=3))

    img_stream, txt_stream = str(tmp_path / "image_stream.pt"), str(tmp_path / "text_stream.pt")
    save_train_checkpoint(img_stream, epoch=1, name="i", clip_params=clip_params, clip_cfg=cfg,
                          heads=mk_heads(2))
    save_train_checkpoint(txt_stream, epoch=1, name="t", clip_params=clip_params, clip_cfg=cfg,
                          heads=mk_heads(3))
    db = tmp_path / "db"
    db.mkdir()
    save_pt(np.float32(rng.standard_normal((64, D))), str(db / "cc_image_databases.pt"))
    save_pt(np.float32(rng.standard_normal((64, D))), str(db / "cc_text_databases.pt"))
    (db / "database_names.txt").write_text("\n".join(f"n{i}" for i in range(64)))
    root = tmp_path / "data"
    base = root / "CIRR"
    for sub in ("dev", "captions", "image_splits"):
        (base / sub).mkdir(parents=True)
    names = [f"img{i}" for i in range(8)]
    for n in names:
        Image.fromarray(rng.integers(0, 255, (36, 36, 3), dtype=np.uint8)).save(
            base / "dev" / f"{n}.png")
    caps = [{"reference": names[q], "target_hard": names[(q + 1) % 8], "caption": f"change {q}"}
            for q in range(4)]
    (base / "captions" / "cap.rc2.val.json").write_text(json.dumps(caps))
    (base / "image_splits" / "split.rc2.val.json").write_text(
        json.dumps({n: f"dev/{n}.png" for n in names}))
    return img_stream, txt_stream, str(db), str(root)
