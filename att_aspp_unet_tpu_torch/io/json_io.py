"""JSON helpers (the reference wrote its frame JSON with ``indent=4``)."""

from __future__ import annotations

import json
from pathlib import Path


def read_json(path):
    return json.loads(Path(path).read_text())


def write_json(path, content, indent: int = 4) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(content, indent=indent))
