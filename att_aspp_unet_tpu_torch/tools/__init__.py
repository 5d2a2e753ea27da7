"""Dataset tooling (.mha→PNG conversion, train/val split, leak checker) and the
port's test and measurement tools."""

from .convert import (NegativeRule, PositiveRule, build_png_dataset,  # noqa: F401
                      convert_frames_with_negatives, window_to_u8)
from .split import split_train_val  # noqa: F401
from .leak_check import check_split_leak  # noqa: F401
