"""Offline evaluation and analysis suite, and the diagnostic outputs of the
predict CLI (``panels``).

CSV-compatible with the reference's downstream scripts: ``seg_eval.csv``
columns match ``eval_segmentation_batch.py:152-158``; the AC analyzer
consumes and produces the same ``ac_results.csv`` / ``merged_ac_values.csv``
shapes as ``analyze_ac.py``.  No module here needs pandas, and matplotlib is
imported only where a figure is drawn.
"""

from .seg_metrics import dice, hd95, iou, evaluate_directories, show_metric  # noqa: F401
from .ac_analysis import analyze_ac  # noqa: F401
