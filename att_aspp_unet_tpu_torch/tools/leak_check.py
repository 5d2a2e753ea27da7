"""Train/val overlap (data-leak) checker (a copy of the JAX package's
``tools/leak_check.py``).

The reference's ``test.py`` capability: compare the file sets of the train
and val image directories (by name or by stem, optionally recursive) and
write ``check_results/{present,missing_in_val}.txt``.  For a correctly split
dataset the "present" list must be EMPTY — any overlap is a leak.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Set


def collect_files(d: Path, recursive: bool = False,
                  by_stem: bool = False) -> Set[str]:
    d = Path(d)
    if not d.exists():
        return set()
    it = d.rglob("*") if recursive else d.iterdir()
    return {p.stem if by_stem else p.name for p in it if p.is_file()}


def check_split_leak(train_dir, val_dir, out_dir="check_results",
                     recursive: bool = False, by_stem: bool = False,
                     log=print) -> Dict[str, list]:
    train_set = collect_files(train_dir, recursive, by_stem)
    val_set = collect_files(val_dir, recursive, by_stem)

    present_in_val = sorted(train_set & val_set)     # leaked files
    missing_in_val = sorted(train_set - val_set)

    log(f"train files: {len(train_set)}")
    log(f"present in val (LEAK if non-empty): {len(present_in_val)}")
    log(f"absent from val: {len(missing_in_val)}")

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "present.txt").write_text("\n".join(present_in_val))
    (out / "missing_in_val.txt").write_text("\n".join(missing_in_val))
    return {"present": present_in_val, "missing_in_val": missing_in_val}
