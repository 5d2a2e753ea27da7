"""Reference-API compatibility layer (a copy of the JAX package's
``compat.py``, backed by the port's engines).

Drop-in names for code written against the reference modules
(``model_attention_aspp.py`` / ``model.py``): a ``FetalAbdomenSegmentation``
class with ``predict(path) → probability map`` and ``postprocess(probs) →
mask stack``, plus ``select_fetal_abdomen_mask_and_frame``.  Both return
numpy arrays; the engines run on ``device`` (default the card).  Accepts
flat ``.npz`` archives and reference ``.pt`` / ``.pth`` checkpoints.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .infer.container import select_labeled_mask_and_frame
from .infer.engine import select_mask_and_frame
from .infer.models import build_engine, load_model
from .io.volume import read_volume


class ValidationError(Exception):
    """Raised when an input-case validator rejects the case set."""


class UniquePathIndicesValidator:
    """evalutils-compatible validator: the numeric indices parsed from the
    input filenames must be unique (``evalutils.validators`` semantics, used
    by the reference at ``model.py:21-27``).  Accepts a list of paths or an
    object with a ``path`` column/attribute per row."""

    def __call__(self, cases) -> None:
        indices = []
        for p in _case_paths(cases):
            m = re.search(r"(\d+)", Path(p).name)
            if m:
                indices.append(m.group(1))
        if len(indices) != len(set(indices)):
            raise ValidationError("duplicate path indices in input cases")


class UniqueImagesValidator:
    """evalutils-compatible validator: no two input images may have
    identical content (compared by content hash)."""

    def __call__(self, cases) -> None:
        seen = set()
        for p in _case_paths(cases):
            h = hashlib.sha256(Path(p).read_bytes()).hexdigest()
            if h in seen:
                raise ValidationError(f"duplicate input image: {p}")
            seen.add(h)


def _case_paths(cases):
    if hasattr(cases, "path"):          # DataFrame-like with a path column
        return list(cases.path)
    return [c if isinstance(c, (str, Path)) else getattr(c, "path")
            for c in cases]


class FetalAbdomenSegmentation:
    """Reference-compatible facade over the port's inference engines.

    ``model_tag='att_aspp'`` → the ROI deployment path
    (``model_attention_aspp.py:33-89``); ``model_tag='baseline'`` → the
    sliding-window PlainConvUNet path (``model.py:19-104``); any other tag
    of ``infer/models.py``'s table as the container serves it.
    ``variables`` skips the checkpoint (what ``build_engine`` takes).
    """

    def __init__(self, checkpoint_path: Optional[str] = "checkpoints/best_model.pth",
                 model_tag: str = "att_aspp", cfg: Optional[Config] = None,
                 variables=None, device="cuda"):
        self.cfg = cfg or Config()
        self.model_tag = model_tag
        # evalutils SegmentationAlgorithm scaffolding (reference
        # model.py:20-28): the validator set the reference registers
        self.validators = dict(input_image=(UniqueImagesValidator(),
                                            UniquePathIndicesValidator()))
        if variables is None:
            if checkpoint_path is None or not Path(checkpoint_path).exists():
                raise FileNotFoundError(f"checkpoint not found: {checkpoint_path}")
            variables = load_model(model_tag, Path(checkpoint_path), self.cfg)
        self._serving = build_engine(model_tag, self.cfg, variables, device)

    def predict(self, input_img_path, save_probabilities: bool = False
                ) -> np.ndarray:
        """Path (or [path]) → probability map: (N, H, W) for att_aspp (N =
        the subsampled frames), (C, N, H, W) softmax for baseline.  With
        ``save_probabilities`` it is also written to
        ``output/probabilities/<case>_prob.npy`` under the working
        directory, as the reference does."""
        if isinstance(input_img_path, (list, tuple)):
            input_img_path = input_img_path[0]
        self.case_id = Path(input_img_path).stem
        vol = read_volume(input_img_path,
                          default_spacing=self.cfg.container.spacing_mm)
        probs = self._serving.predict(vol.array).cpu().numpy()
        if save_probabilities:
            out = Path("output/probabilities")
            out.mkdir(parents=True, exist_ok=True)
            np.save(out / f"{self.case_id}_prob.npy", probs)
        return probs

    def postprocess(self, probability_map) -> np.ndarray:
        probs = probability_map
        if not isinstance(probs, torch.Tensor):
            probs = torch.from_numpy(np.array(probs))   # a writable copy
        probs = probs.to(self._serving.device)
        return self._serving.postprocess(probs).cpu().numpy()

    def validate(self, cases) -> None:
        """Run every registered validator over the input case set
        (evalutils ``Algorithm.validate`` hook)."""
        for validators in self.validators.values():
            for v in validators:
                v(cases)


def select_fetal_abdomen_mask_and_frame(mask_3d) -> Tuple[np.ndarray, int]:
    """Max-area frame pick with the −1/empty contract.  Label-aware for the
    baseline path's {1, 2} class masks (``model.py:107-139``), binary
    otherwise (``model_attention_aspp.py:91-97``).

    Like the reference function, the returned index is relative to the stack
    passed in: for the ROI path that is the *subsampled* axis.  Mapping it
    back to the original frame axis is the container's job
    (``infer/container.py``), not this function's."""
    m = np.asarray(mask_3d)
    if m.ndim == 3 and m.max(initial=0) > 1:
        return select_labeled_mask_and_frame(m)
    return select_mask_and_frame(m)
