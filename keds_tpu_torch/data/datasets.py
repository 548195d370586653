"""Datasets (counterpart of ``keds_tpu/data/datasets.py``): the evaluation
benchmarks and the precomputed CC3M feature pairs of training.

The benchmarks (``CIRR``, ``FashionIQ``, ``CsvCOCO``, ``ImageList``) read the
reference's directory layouts and return the JAX package's tuples in its
order: images through the given transform (PIL, imported when an image is
opened), prompts tokenized by the port's BPE.  ``CustomFolder`` (a folder
of images) and ``CsvDataset`` (image paths and captions in a csv) feed the
serve and demo CLIs and raw-image training.  ``CsvDataset``'s
``caption_token_needs`` (rank-consistent caption buckets) waits for
multi-process training, ROADMAP.md section A item 10.

``FeaturePairDataset`` (training) reads two layouts: packed (``image_features.npy`` (N, D), ``text_features.npy``
(N, D) and ``names.json`` in one directory, memory-mapped) and the
reference's per-file one (``cc_image_feature_folder_clipl/*.pt`` and
``cc_text_feature_folder_clipl/*.pt``, read with ``torch.load``).  A sample
is ``(image_feature, caption_feature)`` as f32 arrays; with ``templates``
(the text stream) it is ``(image_feature, caption_feature, subject,
own_template_tokens)``, the tokens of ``"a photo of * * * " + other``
(stars in ``other`` blanked) from the ``cc_subject.json`` and
``cc_other.json`` maps in the folder.  Attached precomputed-neighbour
arrays add one int32 row each.  The image stream reads no vocab: only
templates are tokenized.
"""

from __future__ import annotations

import csv
import json
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from keds_tpu_torch.tokenizer import tokenize


def _open_image(path: str):
    from PIL import Image

    img = Image.open(path)
    img.load()
    return img


class CIRR:
    """CIRR val/test (reference src/data.py:233-333): ``mode="caps"`` gives
    composed-query samples, ``mode="imgs"`` the target corpus."""

    def __init__(self, transforms: Callable, mode: str = "caps",
                 vis_mode: bool = False, test: bool = False, root: str = "./data"):
        self.mode = mode
        self.transforms = transforms
        self.vis_mode = vis_mode
        self.test = test
        self.root = os.path.join(root, "CIRR")
        self.root_img = os.path.join(self.root, "test1" if test else "dev")
        split = "test1" if test else "val"
        if mode == "caps":
            path = os.path.join(self.root, f"captions/cap.rc2.{split}.json")
        else:
            path = os.path.join(self.root, f"image_splits/split.rc2.{split}.json")
        with open(path) as f:
            data = json.load(f)
        self.ref_imgs: List[str] = []
        self.target_imgs: List[str] = []
        self.target_caps: List[str] = []
        self.pairids: List[int] = []
        if mode == "caps":
            for d in data:
                self.ref_imgs.append(d["reference"] + ".png")
                self.target_caps.append(d["caption"])
                if test:
                    self.pairids.append(d["pairid"])
                    self.target_imgs.append("dummy")
                else:
                    self.target_imgs.append(d["target_hard"] + ".png")
        else:
            self.target_imgs = [k + ".png" for k in data]
        if vis_mode:
            self.target_imgs = sorted(set(self.target_imgs))
        logging.info("CIRR: %d samples", len(self))

    def __len__(self):
        return len(self.target_imgs)

    def __getitem__(self, idx: int):
        if self.mode != "caps" or self.vis_mode:
            tar = str(self.target_imgs[idx])
            img = self.transforms(_open_image(os.path.join(self.root_img, tar)))
            # the val corpus gives the full path, the test corpus the name
            path = tar if self.test else os.path.join(self.root_img, tar)
            return img, path
        ref = str(self.ref_imgs[idx])
        ref_img = self.transforms(_open_image(os.path.join(self.root_img, ref)))
        cap = self.target_caps[idx]
        text_with_blank = f"a photo of * , {cap}"
        if self.test:
            return (ref_img, tokenize(text_with_blank)[0], tokenize(cap)[0],
                    ref, self.pairids[idx], text_with_blank)
        return (ref_img, tokenize(text_with_blank)[0], tokenize(cap)[0],
                ref, str(self.target_imgs[idx]), text_with_blank, cap)


class FashionIQ:
    """Fashion-IQ per cloth type (reference src/data.py:339-427); the two
    captions are joined "a photo of * , {cap2} and {cap1}"."""

    def __init__(self, cloth: str, transforms: Callable, mode: str = "caps",
                 is_return_target_path: bool = False, vis_mode: bool = False,
                 root: str = "./data"):
        base = os.path.join(root, "fashion-iq")
        self.root_img = os.path.join(base, "images")
        self.mode = mode
        self.vis_mode = vis_mode
        self.is_return_target_path = is_return_target_path
        self.transforms = transforms
        self.ref_imgs: List[str] = []
        self.target_imgs: List[str] = []
        self.ref_caps: List = []
        if mode == "imgs":
            path = os.path.join(base, "image_splits", f"split.{cloth}.val.json")
            with open(path) as f:
                self.target_imgs = [k + ".png" for k in json.load(f)]
        else:
            path = os.path.join(base, "json", f"cap.{cloth}.val.json")
            with open(path) as f:
                data = json.load(f)
            for d in data:
                ref = os.path.join(self.root_img, d["candidate"] + ".png")
                tar = os.path.join(self.root_img, d["target"] + ".png")
                if os.path.isfile(ref) and os.path.isfile(tar):
                    self.ref_imgs.append(ref)
                    self.target_imgs.append(tar)
                    self.ref_caps.append((d["captions"][0], d["captions"][1]))
                else:
                    logging.warning("cannot load %s", d["candidate"])
        logging.info("FashionIQ %s: %d samples", cloth, len(self))

    def __len__(self):
        return len(self.ref_imgs) if self.mode == "caps" else len(self.target_imgs)

    def __getitem__(self, idx: int):
        if self.mode == "imgs" or self.vis_mode:
            tar = str(self.target_imgs[idx])
            path = tar if self.vis_mode else os.path.join(self.root_img, tar)
            return self.transforms(_open_image(path)), path
        ref_img = self.transforms(_open_image(str(self.ref_imgs[idx])))
        tar_img = self.transforms(_open_image(str(self.target_imgs[idx])))
        cap1, cap2 = self.ref_caps[idx]
        text_with_blank = f"a photo of * , {cap2} and {cap1}"
        tokens = tokenize(text_with_blank)[0]
        if self.is_return_target_path:
            return (ref_img, tar_img, tokens, tokens,
                    str(self.target_imgs[idx]), str(self.ref_imgs[idx]), text_with_blank)
        return ref_img, tar_img, text_with_blank


class CsvCOCO:
    """COCO composed-region queries (reference src/data.py:433-509): the
    query is a masked-region crop; prompts are built from the query class
    and the other classes in the target."""

    def __init__(self, transforms: Callable, transforms_region: Callable,
                 root: str = "./data", sep: str = ","):
        self.transforms = transforms
        self.transforms_region = transforms_region
        self.root = os.path.join(root, "coco")
        self.root_img = os.path.join(self.root, "val2017")
        with open(os.path.join(self.root, "coco_eval.csv")) as f:
            rows = list(csv.DictReader(f, delimiter=sep))
        self.images = [r["id"] for r in rows]
        self.regions = []
        for r in rows:
            x1, y1, x2, y2 = (int(float(v)) for v in r["query_regions"].split(";"))
            self.regions.append((x1, y1, x2, y2))
        self.query_classes = [r["query_class"] for r in rows]
        self.classes = [r["classes"].split(";") if r.get("classes") else [""] for r in rows]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        name = str(self.images[idx])
        img_path = os.path.join(self.root_img, name)
        basename = os.path.basename(img_path).split(".")[0]
        image = _open_image(img_path)
        masked = _open_image(os.path.join(self.root_img.replace("val2017", "val2017_masked"),
                                          name))
        region = masked.crop(self.regions[idx])
        image_t = self.transforms(image)
        region_t = self.transforms_region(region)
        qc = self.query_classes[idx]
        others = " and ".join(self.classes[idx])
        text_with_blank = f"a photo of * and {others}"
        text_with_queryclass = f"a photo of * and {qc} and {others}"
        text_full = f"a photo of {qc} and {others}"
        return (image_t, region_t, tokenize(text_full)[0], tokenize(text_with_blank)[0],
                tokenize(text_with_queryclass)[0], name, text_with_queryclass, basename)


class ImageList:
    """Images from a txt listing, optionally "path label" pairs (reference
    src/data.py:512-546), for the ImageNet domain-transfer evaluation."""

    def __init__(self, input_filename: str, transforms: Callable,
                 root: Optional[str] = None, is_labels: bool = False,
                 return_filename: bool = False):
        with open(input_filename) as f:
            lines = [line.strip() for line in f if line.strip()]
        if is_labels:
            self.images = [ln.split(" ")[0] for ln in lines]
            self.labels = [int(ln.split(" ")[1]) for ln in lines]
        else:
            self.images = lines
            self.labels = None
        self.transforms = transforms
        self.root = root
        self.return_filename = return_filename

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        path = str(self.images[idx])
        if self.root is not None:
            path = os.path.join(self.root, path)
        img = self.transforms(_open_image(path))
        basename = os.path.basename(path).split(".")[0]
        if self.return_filename:
            return img, path
        if self.labels is not None:
            return img, self.labels[idx], basename
        return img


class CustomFolder:
    """All images in one folder, in sorted name order (reference
    src/data.py:549-571): the serve CLI's corpus and the demo's COCO one."""

    def __init__(self, folder: str, transform: Callable):
        self.samples = [os.path.join(folder, n) for n in sorted(os.listdir(folder))]
        self.transform = transform

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        path = self.samples[idx]
        return self.transform(_open_image(path)), path


class CsvDataset:
    """(image, caption tokens) rows of a csv (reference src/data.py:673-696):
    raw-image training, and the demo's corpus with ``return_filename``
    (image, path).  ``transforms`` may be None where no sample is read (the
    train CLI's ``--val-data`` count)."""

    def __init__(self, input_filename: str, transforms: Optional[Callable], img_key: str,
                 caption_key: str, sep: str = "\t", return_filename: bool = False):
        with open(input_filename) as f:
            rows = list(csv.DictReader(f, delimiter=sep))
        self.images = [r[img_key] for r in rows]
        self.captions = [r[caption_key] for r in rows]
        self.transforms = transforms
        self.return_filename = return_filename

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, idx: int):
        img = self.transforms(_open_image(str(self.images[idx])))
        if self.return_filename:
            return img, str(self.images[idx])
        return img, tokenize([str(self.captions[idx])])[0]


def _load_json_maybe(folder: str, name: str) -> dict:
    """``<folder>/<name>``, or {} where there is none."""
    path = os.path.join(folder, name)
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _read_pt_feature(path: str) -> np.ndarray:
    return torch.load(path, map_location="cpu", weights_only=True).float().numpy().reshape(-1)


class FeaturePairDataset:
    TEMPLATE_PREFIX = "a photo of * * * "

    def __init__(self, folder: str, templates: bool = False):
        self.folder = folder
        self.templates = templates
        packed_img = os.path.join(folder, "image_features.npy")
        if os.path.isfile(packed_img):
            self.mode = "packed"
            self.image_feats = np.load(packed_img, mmap_mode="r")
            self.text_feats = np.load(os.path.join(folder, "text_features.npy"), mmap_mode="r")
            with open(os.path.join(folder, "names.json")) as f:
                self.names = json.load(f)
        else:
            self.mode = "per-file"
            self.image_dir = os.path.join(folder, "cc_image_feature_folder_clipl")
            self.text_dir = os.path.join(folder, "cc_text_feature_folder_clipl")
            self.files = sorted(os.listdir(self.image_dir))
            self.names = [os.path.basename(f).split(".")[0] for f in self.files]
        self.subject: Dict[str, str] = {}
        self.other: Dict[str, str] = {}
        if templates:
            self.subject = _load_json_maybe(folder, "cc_subject.json")
            self.other = _load_json_maybe(folder, "cc_other.json")
        self.neighbors = None

    def features(self, lo: int, hi: int):
        """f32 (image, caption) features of samples ``lo:hi``, without the
        templates."""
        if self.mode == "packed":
            return (np.asarray(self.image_feats[lo:hi], np.float32),
                    np.asarray(self.text_feats[lo:hi], np.float32))
        return tuple(np.stack([_read_pt_feature(os.path.join(d, self.files[i]))
                               for i in range(lo, hi)])
                     for d in (self.image_dir, self.text_dir))

    def attach_neighbors(self, neighbors: tuple) -> None:
        """Attach precomputed-neighbour arrays (``(img_idx, txt_idx)`` for
        the image stream, ``(img_idx, txt_idx, cap2_idx)`` for the text
        stream), aligned with this dataset's sample order."""
        if any(len(a) != len(self.names) for a in neighbors):
            raise ValueError(
                f"neighbour pack rows {[len(a) for a in neighbors]} do not match "
                f"the dataset ({len(self.names)} samples)")
        self.neighbors = neighbors

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int):
        img, txt = (a[0] for a in self.features(idx, idx + 1))
        base = (img, txt)
        if self.templates:
            name = self.names[idx]
            other = self.other.get(name, "*")
            template = self.TEMPLATE_PREFIX + other.replace("*", " ")
            base += (self.subject.get(name, ""), tokenize(template)[0])
        if self.neighbors is not None:
            return base + tuple(np.asarray(a[idx], np.int32) for a in self.neighbors)
        return base


def build_other_tokens(names: Sequence[str], other: Dict[str, str],
                       template_prefix: str = "a photo of * * ") -> np.ndarray:
    """The neighbour templates ``template_prefix + other`` of every DB row,
    tokenized once, (N, 77) int32, so that the text-stream step gathers
    them by neighbour index.  Refuses a caption map that holds none of the
    DB's row names (the wrong map would train the neighbour term on bare
    prefixes)."""
    keys = [n.split(".")[0] for n in names]
    missing = sum(1 for k in keys if k not in other)
    if missing == len(names) and names:
        raise ValueError("none of the knowledge-DB row names appear in the 'other' "
                         "caption map (cc_other.json): wrong map for this DB?")
    if missing:
        logging.warning("%d/%d knowledge-DB rows have no 'other' caption entry; their "
                        "neighbour templates fall back to the bare prefix", missing,
                        len(names))
    return tokenize([template_prefix + other.get(k, "").replace("*", " ") for k in keys])
