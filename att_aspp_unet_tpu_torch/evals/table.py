"""Row tables read and written as the JAX package's pandas code reads and
writes them, with ``csv`` and numpy only: the port does not need pandas.

A table is a list of column names and a list of row dicts.  Reading infers a
column's type as ``pandas.read_csv`` does for these files: integers when
every field is an integer, floats when every non-empty field is a number
(empty fields become NaN), text otherwise (empty fields become ``None``).
Writing formats as ``DataFrame.to_csv`` does: floats by their shortest
round-trip ``repr``, NaN and ``None`` as an empty field.
"""

from __future__ import annotations

import csv
import math
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

Row = Dict[str, object]


def _parse_column(tokens: List[str]) -> list:
    try:
        return [int(t) for t in tokens]
    except ValueError:
        pass
    try:
        return [float(t) if t.strip() else math.nan for t in tokens]
    except ValueError:
        return [t if t != "" else None for t in tokens]


def read_csv(path) -> Tuple[List[str], List[Row]]:
    with open(path, newline="") as f:
        reader = csv.reader(f)
        columns = next(reader)
        body = [r for r in reader if r]
    cols = {c: _parse_column([r[i] if i < len(r) else "" for r in body])
            for i, c in enumerate(columns)}
    return columns, [{c: cols[c][k] for c in columns}
                     for k in range(len(body))]


def column(rows: Sequence[Row], name: str) -> np.ndarray:
    """One numeric column as float64 (missing values NaN)."""
    return np.array([math.nan if r.get(name) is None else r[name]
                     for r in rows], dtype=float)


def fmt(v) -> str:
    if v is None:
        return ""
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    return str(v)


def write_csv(path, columns: Sequence[str], rows: Sequence[Row],
              header: Sequence[str] = None) -> None:
    """``rows`` under ``header`` (default the column names), one line per
    row, the fields of ``columns`` in order."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(header or columns))
        w.writerows([fmt(r.get(c)) for c in columns] for r in rows)


def format_table(columns: Sequence[str], rows: Sequence[Row]) -> str:
    """Right-aligned text table of ``rows`` for a log."""
    cells = [list(columns)] + [[fmt(r.get(c)) for c in columns] for r in rows]
    widths = [max(len(line[i]) for line in cells) for i in range(len(columns))]
    return "\n".join("  ".join(s.rjust(w) for s, w in zip(line, widths))
                     for line in cells)


def pyplot(files: Sequence):
    """matplotlib's pyplot on the Agg backend; without matplotlib ``None``,
    after one ``[warn] matplotlib unavailable: skipped <file>`` line per
    figure file that the caller would have drawn."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        for f in files:
            print(f"[warn] matplotlib unavailable: skipped {Path(f)}",
                  file=sys.stderr, flush=True)
        return None
    return plt


def inner_join(left: Sequence[tuple], right: Sequence[tuple]
               ) -> List[Tuple[int, int]]:
    """(left row, right row) index pairs of ``DataFrame.merge(how="inner")``
    on the key tuples ``left`` and ``right``, whose keys must be unique on
    the right (the GT table, the second run's cases): then pandas keeps the
    left order and drops the unmatched rows.  A duplicated right key raises
    ``ValueError`` (pandas would join it, in an order that depends on its
    join path)."""
    pos: Dict[tuple, int] = {}
    for j, k in enumerate(right):
        if pos.setdefault(tuple(k), j) != j:
            raise ValueError(f"duplicated join key {tuple(k)!r} on the right")
    return [(i, pos[tuple(k)]) for i, k in enumerate(left) if tuple(k) in pos]
