"""Reorganize a flat ImageNet val directory into per-synset subfolders
(counterpart of ``keds_tpu/tools/prep_imagenet_val.py``).

The reference ships this step as a 51k-line generated shell script
(its ``valprep.sh:1-5`` — 1000 ``mkdir`` + 50000 ``mv`` lines).
Here it is a tool that consumes either

* a two-column mapping file (``ILSVRC2012_val_00000001.JPEG n01751748``), or
* a ``valprep.sh``-style script itself (the ``mv FILE SYNSET/`` lines are
  parsed; everything else is ignored),

and moves each image into ``<val_dir>/<synset>/``.  After this,
``keds_tpu_torch.data.datasets.ImageList`` / folder datasets see the reorganized tree the
reference evaluators assume.

Usage::

    python -m keds_tpu_torch.tools.prep_imagenet_val --val-dir /data/imagenet/val \
        --mapping valprep.sh [--dry-run]
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, Iterable, Tuple


def parse_mapping(lines: Iterable[str]) -> Dict[str, str]:
    """filename -> synset from either mapping format (see module doc)."""
    mapping: Dict[str, str] = {}
    for raw in lines:
        parts = raw.split()
        if not parts or parts[0] == "mkdir":
            continue
        if parts[0] == "mv" and len(parts) >= 3:  # valprep.sh: mv FILE SYNSET/
            mapping[parts[1]] = parts[2].rstrip("/")
        elif len(parts) == 2 and not parts[0].startswith("#"):
            mapping[parts[0]] = parts[1].rstrip("/")
    return mapping


def prep_val_dir(val_dir: str, mapping: Dict[str, str],
                 dry_run: bool = False) -> Tuple[int, int]:
    """Move mapped files into synset subdirs.  Returns (moved, missing)."""
    moved = missing = 0
    for fname, synset in mapping.items():
        src = os.path.join(val_dir, fname)
        if not os.path.isfile(src):
            missing += 1
            continue
        dst_dir = os.path.join(val_dir, synset)
        if not dry_run:
            os.makedirs(dst_dir, exist_ok=True)
            shutil.move(src, os.path.join(dst_dir, fname))
        moved += 1
    return moved, missing


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--val-dir", required=True,
                   help="flat ImageNet val directory to reorganize in place")
    p.add_argument("--mapping", required=True,
                   help="two-column mapping file or a valprep.sh script")
    p.add_argument("--dry-run", action="store_true",
                   help="report counts without moving anything")
    args = p.parse_args(argv)
    with open(args.mapping) as f:
        mapping = parse_mapping(f)
    if not mapping:
        p.error(f"no filename->synset entries parsed from {args.mapping}")
    moved, missing = prep_val_dir(args.val_dir, mapping, dry_run=args.dry_run)
    verb = "would move" if args.dry_run else "moved"
    print(f"{verb} {moved} files into {len(set(mapping.values()))} synset dirs"
          f" ({missing} mapped files not present)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
