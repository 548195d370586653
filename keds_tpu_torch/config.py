"""CLI configuration (counterpart of ``keds_tpu/config.py``): the JAX
package's flag names and defaults for training (features, csv and
webdataset), evaluation, serving and the demo, plus the device and the two
values the image stream takes as arguments so that it needs no BPE vocab
(``--split-id``, ``--prompt-tokens``; the text stream, raw-image training,
serving and the demo read both from the vocab, and so does evaluation
unless ``--split-id`` is given).

Every flag of the JAX parser parses here under its name and default.
Those that are inert there (read by nothing: the reference's GPU-era and
open_clip-heritage flags) are inert here too; those of parts that are not
ported yet, or left out on purpose, are refused by :func:`parse_args` with
the ROADMAP.md item that ports them or the reason."""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

MODEL_CHOICES = [
    "RN50", "RN101", "RN50x4", "RN50x64", "RN50x16",
    "ViT-B/16", "ViT-B/32", "ViT-L/14", "ViT-H-14",
]
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
    val_data: Optional[str] = None
    dataset_type: str = "auto"
    dataset_type_val: str = "auto"
    csv_separator: str = "\t"
    csv_img_key: str = "filepath"
    csv_caption_key: str = "title"
    imagenet_val: Optional[str] = None      # inert, as in the JAX package
    imagenet_v2: Optional[str] = None       # inert
    train_num_samples: Optional[int] = None
    dataset_resampled: bool = False
    caption_map: Optional[str] = None
    train_data_upsampling_factors: Optional[str] = None
    workers: int = 1
    prompts: Optional[str] = None
    retrieval_data: Optional[str] = None
    demo_out: str = "demo"
    query_file: Optional[str] = None
    topn: int = 10
    target_data: Optional[str] = None
    root_data: str = "./data"
    source_data: Optional[str] = None
    target_pad: bool = False
    eval_mode: str = "coco"
    database_path: Optional[str] = None
    db_image_file: Optional[str] = None
    db_text_file: Optional[str] = None
    db_names_file: Optional[str] = None
    db_topk: int = 16
    db_shard: bool = False
    retrieval_backend: str = "auto"
    quant_towers: str = "none"
    worker_processes: bool = False
    eval_ranking: str = "host"
    device_preprocess: bool = True
    neighbors: Optional[str] = None
    model: str = "ViT-L/14"
    middle_dim: int = 512
    n_layer: int = 2
    openai_pretrained: bool = False
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
    image_branch: str = "./image_branch/checkpoints"
    text_branch: str = "./text_branch/checkpoints"
    logs: str = "./logs/"
    name: Optional[str] = None
    time_suffix: bool = True
    checkpoint_path: Optional[str] = None
    save_frequency: int = 1
    save_most_recent: bool = False
    resume: Optional[str] = None
    checkpoint_format: str = "pt"
    report_to: str = ""
    wandb_notes: str = ""
    profile_dir: Optional[str] = None
    debug: bool = False
    copy_codebase: bool = False
    pre_save_feature: bool = False
    load_feature: bool = False
    distributed: bool = False
    skip_aggregate: bool = False
    dist_url: str = "tcp://127.0.0.1:6100"
    num_partitions: int = 0
    # inert, as in the JAX package: the reference's GPU-era distribution
    # knobs and open_clip-heritage flags that no code path reads
    dist_backend: str = "ici"
    gpu: Optional[int] = None
    dp: bool = False
    multigpu: Optional[List[int]] = None
    use_bn_sync: bool = False
    use_debiased_sampler: bool = False
    use_prefix: bool = False
    zeroshot_frequency: int = 2
    regression_frequency: int = 2
    C: float = 3.16
    split_id: Optional[int] = None
    prompt_tokens: List[int] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_PROMPT_TOKENS))
    device: Optional[str] = None

    @property
    def aggregate(self) -> bool:
        return not self.skip_aggregate

    def finalize(self) -> "Config":
        for k, v in get_default_params(self.model).items():
            if getattr(self, k) is None:
                setattr(self, k, v)
        return self


def _add_flags(parser: argparse.ArgumentParser) -> None:
    add = parser.add_argument
    add("--train-data", type=str, default=None,
        help="feature directory, csv/tsv file, or tar shards ('{00000..00331}.tar', "
             "several sources joined by '::')")
    add("--val-data", type=str, default=None,
        help="a csv whose samples are counted into the run's log")
    add("--dataset-type", type=str, default="auto",
        choices=["webdataset", "csv", "inet", "auto", "directory",
                 "fashion-iq", "cirr", "imgnet_r"])
    add("--dataset-type-val", type=str, default="auto")
    add("--csv-separator", type=str, default="\t")
    add("--csv-img-key", type=str, default="filepath")
    add("--csv-caption-key", type=str, default="title")
    add("--imagenet-val", type=str, default=None, help="inert, as in the JAX package")
    add("--imagenet-v2", type=str, default=None, help="inert, as in the JAX package")
    add("--train-num-samples", type=int, default=None,
        help="webdataset: samples in an epoch (default CC3M's 2,803,766)")
    add("--dataset-resampled", action="store_true", default=False,
        help="webdataset: draw shards with replacement, per (seed, epoch)")
    add("--caption-map", type=str, default=None,
        help="webdataset: {key: caption} .json, or a .pkl list of "
             "{'filename', 'text'} records")
    add("--train-data-upsampling-factors", type=str, default=None,
        help="webdataset: '::'-separated shard weights per source; needs "
             "--dataset-resampled")
    add("--workers", type=int, default=1,
        help="decode threads of the image loaders")
    add("--prompts", type=str, default=None,
        help="demo: comma-separated prompts with '*' (default 'a photo of *')")
    add("--retrieval-data", type=str, default=None,
        help="demo corpus: a csv path, imgnet, cirr, dress, shirt, toptee or coco")
    add("--demo-out", type=str, default="demo",
        help="demo: output directory; serve: results file (.jsonl added)")
    add("--query_file", type=str, default=None,
        help="demo: comma-separated query images; serve: queries.jsonl")
    add("--topn", type=int, default=10,
        help="results returned per query (serve CLI ranking depth)")
    add("--target-data", type=str, default=None,
        help="serve: the folder of corpus images")
    add("--root-data", type=str, default="./data")
    add("--source-data", type=str, default=None,
        help="Fashion-IQ cloth type: dress, shirt or toptee")
    add("--target-pad", action="store_true", default=False)
    add("--eval-mode", type=str, default="coco",
        choices=["coco", "cirr", "cirr_test", "fashion", "imgnet"])
    add("--database-path", type=str, default=None)
    add("--db-image-file", type=str, default=None)
    add("--db-text-file", type=str, default=None)
    add("--db-names-file", type=str, default=None)
    add("--db-topk", type=int, default=16)
    add("--db-shard", action="store_true", default=False,
        help="split the knowledge DB's rows over the ranks of --distributed "
             "(each rank searches its block; the candidates are merged)")
    add("--quant-towers", type=str, default="none", choices=["none", "int8"],
        help="int8: W8A8 int8 for the transformer towers' block GEMMs at inference "
             "(per-channel weights, per-token activations; an RN visual tower is "
             "left as it is)")
    add("--worker-processes", action="store_true", default=False,
        help="decode in --workers spawned processes instead of threads")
    add("--retrieval-backend", type=str, default="auto",
        choices=["auto", "xla", "pallas", "int8", "approx"],
        help="auto, xla and pallas run the exact fused top-k kernel; approx runs it "
             "too (approx_max_k is exact off the TPU); int8 scores an int8 copy of "
             "the DB and re-ranks 4x-oversampled candidates against the true rows")
    add("--eval-ranking", type=str, default="host", choices=["host", "device"],
        help="device: the sweeps' mixtures and rankings on the device (the fused "
             "top-k kernel in f32), only the indices fetched; host: the numpy "
             "formulas (default)")
    add("--no-device-preprocess", dest="device_preprocess", action="store_false",
        default=True, help="left out on purpose: the port sends uint8 and normalises "
                           "on the device")
    add("--neighbors", type=str, default=None,
        help="precomputed-neighbour pack, or 'auto' for <train-data>/neighbors.npz")
    add("--model", type=str, default="ViT-L/14", choices=MODEL_CHOICES,
        help="the from-scratch architecture without --clip-weights (ViT only; RN "
             "towers load from --clip-weights)")
    add("--middle_dim", type=int, default=512, help="IM2TEXT hidden width")
    add("--n-layer", type=int, default=2, help="IM2TEXT hidden layers")
    add("--openai-pretrained", action="store_true", default=False,
        help="load --model's OpenAI weights from ~/.cache/clip (nothing is "
             "downloaded)")
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
    add("--image-branch", type=str, default="./image_branch/checkpoints")
    add("--text-branch", type=str, default="./text_branch/checkpoints")
    add("--logs", type=str, default="./logs/")
    add("--name", type=str, default=None)
    add("--no-time-suffix", dest="time_suffix", action="store_false", default=True)
    add("--checkpoint-path", type=str, default=None,
        help="checkpoint directory (default <logs>/<name>/checkpoints)")
    add("--save-frequency", type=int, default=1)
    add("--save-most-recent", action="store_true", default=False)
    add("--resume", type=str, default=None)
    add("--checkpoint-format", type=str, default="pt", choices=["pt", "orbax"],
        help="orbax is not ported (ROADMAP.md section A item 16)")
    add("--report-to", type=str, default="",
        help="tensorboard, wandb or all, beside scalars.jsonl")
    add("--wandb-notes", type=str, default="")
    add("--profile-dir", type=str, default=None,
        help="write a torch.profiler trace of steps 10-20 of the first epoch here")
    add("--debug", action="store_true", default=False, help="log at DEBUG")
    add("--copy-codebase", action="store_true", default=False,
        help="copy keds_tpu_torch into <logs>/<name>/code before training")
    add("--distributed", action="store_true", default=False,
        help="one process per rank, from RANK and WORLD_SIZE (LOCAL_RANK, "
             "LOCAL_WORLD_SIZE) and --dist-url: data parallelism with --batch-size "
             "rows per rank; gloo on the CPU or where ranks share a CUDA device, "
             "NCCL where each has its own")
    add("--skip-aggregate", action="store_true", default=False,
        help="names the run agg=False (the reference's loss aggregation flag)")
    add("--dist-url", type=str, default="tcp://127.0.0.1:6100",
        help="init method of the process group (tcp://host:port)")
    for flag, kw in (("--dist-backend", dict(type=str, default="ici")),
                     ("--gpu", dict(type=int, default=None)),
                     ("--dp", dict(action="store_true", default=False)),
                     ("--multigpu", dict(type=lambda x: [int(a) for a in x.split(",")],
                                         default=None)),
                     ("--use-bn-sync", dict(action="store_true", default=False)),
                     ("--use-debiased-sampler", dict(action="store_true", default=False)),
                     ("--use-prefix", dict(action="store_true", default=False)),
                     ("--zeroshot-frequency", dict(type=int, default=2)),
                     ("--regression-frequency", dict(type=int, default=2)),
                     ("--C", dict(type=float, default=3.16))):
        add(flag, help="inert, as in the JAX package", **kw)
    add("--pre-save-feature", action="store_true", default=False,
        help="features come from python -m keds_tpu_torch.tools.extract_features; "
             "the train CLI exits naming it")
    add("--load-feature", action="store_true", default=False,
        help="train on precomputed features (the default; refused with webdataset)")
    add("--num-partitions", type=int, default=0,
        help="ranks on the data axis: 0, or at least the world size (clamped to it, "
             "with a warning)")
    add("--split-id", type=int, default=None,
        help="token id of '*' in the vocab (image stream default 265; the text "
             "stream reads it from the vocab and refuses another)")
    add("--prompt-tokens", type=lambda s: [int(t) for t in s.split(",")],
        default=list(DEFAULT_PROMPT_TOKENS),
        help="comma-separated token ids of the image-stream prompt, SOT to EOT")
    add("--device", type=str, default=None,
        help="torch device; default the current CUDA device ('cpu' runs the "
             "plain versions of the kernels)")


# Flags of parts not ported yet, or left out on purpose: (field, value that
# asks for them, ROADMAP item or reason).
UNPORTED = (("checkpoint_format", "orbax", "ROADMAP.md section A item 16 (tools and "
             "harness)"),
            ("device_preprocess", False, "left out on purpose (ROADMAP.md section A): the "
             "port sends uint8 and normalises on the device"))


def parse_args(argv: Optional[List[str]] = None,
               prog: str = "keds_tpu_torch.cli.main") -> Config:
    parser = argparse.ArgumentParser(prog=prog)
    _add_flags(parser)
    cfg = Config(**vars(parser.parse_args(argv))).finalize()
    for field, value, item in UNPORTED:
        got = getattr(cfg, field)
        if got == value if value is not None else got is not None:
            flag = "--" + ("no-" if value is False else "") + field.replace("_", "-")
            arg = "" if isinstance(value, bool) else f" {got}"
            raise SystemExit(f"{flag}{arg}: not ported, {item}")
    return cfg
