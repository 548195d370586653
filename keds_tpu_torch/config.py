"""Train CLI configuration (counterpart of the training subset of
``keds_tpu/config.py``): the JAX package's flag names and defaults for
features-mode training, plus the device and the two values the image
stream takes as arguments so that it needs no BPE vocab (``--split-id``,
``--prompt-tokens``; the text stream reads both from the vocab)."""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

MODEL_CHOICES = ["ViT-B/16", "ViT-B/32", "ViT-L/14", "ViT-H-14"]
# tokenize("a photo of") in the CLIP vocab: SOT, a, photo, of, EOT
DEFAULT_PROMPT_TOKENS = (49406, 320, 1125, 539, 49407)


def get_default_params(model_name: str) -> dict:
    """CLIP-paper optimizer defaults keyed by backbone."""
    if model_name in ("ViT-B/32", "ViT-L/14", "ViT-B/16"):
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


@dataclasses.dataclass
class Config:
    train_data: Optional[str] = None
    dataset_type: str = "auto"
    workers: int = 1
    database_path: Optional[str] = None
    db_topk: int = 16
    neighbors: Optional[str] = None
    model: str = "ViT-L/14"
    clip_weights: Optional[str] = None
    droprate: float = 0.1
    batch_size: int = 64
    epochs: int = 32
    lr: Optional[float] = None
    beta1: Optional[float] = None
    beta2: Optional[float] = None
    eps: Optional[float] = None
    wd: float = 0.2
    warmup: int = 10000
    skip_scheduler: bool = False
    precision: str = "amp"
    seed: int = 0
    stream: str = "image"
    logs: str = "./logs/"
    name: Optional[str] = None
    time_suffix: bool = True
    checkpoint_path: Optional[str] = None
    save_frequency: int = 1
    save_most_recent: bool = False
    resume: Optional[str] = None
    split_id: Optional[int] = None
    prompt_tokens: List[int] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_PROMPT_TOKENS))
    device: Optional[str] = None

    def finalize(self) -> "Config":
        for k, v in get_default_params(self.model).items():
            if getattr(self, k) is None:
                setattr(self, k, v)
        return self


def _add_flags(parser: argparse.ArgumentParser) -> None:
    add = parser.add_argument
    add("--train-data", type=str, default=None)
    add("--dataset-type", type=str, default="auto",
        choices=["webdataset", "csv", "inet", "auto", "directory",
                 "fashion-iq", "cirr", "imgnet_r"])
    add("--workers", type=int, default=1)
    add("--database-path", type=str, default=None)
    add("--db-topk", type=int, default=16)
    add("--neighbors", type=str, default=None,
        help="precomputed-neighbour pack, or 'auto' for <train-data>/neighbors.npz")
    add("--model", type=str, default="ViT-L/14", choices=MODEL_CHOICES)
    add("--clip-weights", type=str, default=None,
        help="reference-layout CLIP .pt (a state dict or a TorchScript archive)")
    add("--droprate", type=float, default=0.1)
    add("--batch-size", type=int, default=64)
    add("--epochs", type=int, default=32)
    add("--lr", type=float, default=None)
    add("--beta1", type=float, default=None)
    add("--beta2", type=float, default=None)
    add("--eps", type=float, default=None)
    add("--wd", type=float, default=0.2)
    add("--warmup", type=int, default=10000)
    add("--skip-scheduler", action="store_true", default=False)
    add("--precision", type=str, default="amp", choices=["amp", "fp16", "fp32", "bf16"])
    add("--seed", type=int, default=0)
    add("--stream", type=str, default="image", choices=["image", "text"])
    add("--logs", type=str, default="./logs/")
    add("--name", type=str, default=None)
    add("--no-time-suffix", dest="time_suffix", action="store_false", default=True)
    add("--checkpoint-path", type=str, default=None,
        help="checkpoint directory (default <logs>/<name>/checkpoints)")
    add("--save-frequency", type=int, default=1)
    add("--save-most-recent", action="store_true", default=False)
    add("--resume", type=str, default=None)
    add("--split-id", type=int, default=None,
        help="token id of '*' in the vocab (image stream default 265; the text "
             "stream reads it from the vocab and refuses another)")
    add("--prompt-tokens", type=lambda s: [int(t) for t in s.split(",")],
        default=list(DEFAULT_PROMPT_TOKENS),
        help="comma-separated token ids of the image-stream prompt, SOT to EOT")
    add("--device", type=str, default=None,
        help="torch device; default the current CUDA device ('cpu' runs the "
             "plain versions of the kernels)")


def parse_args(argv: Optional[List[str]] = None) -> Config:
    parser = argparse.ArgumentParser(prog="keds_tpu_torch.cli.main")
    _add_flags(parser)
    return Config(**vars(parser.parse_args(argv))).finalize()
