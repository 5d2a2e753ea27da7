"""Mask postprocessing: morphology, components, refinement, selection."""

from .cc import label_components, largest_component  # noqa: F401
from .morphology import (binary_closing, binary_dilation,  # noqa: F401
                         binary_erosion, fill_holes, structuring_ellipse)
from .refine import (postprocess_roi_stack,  # noqa: F401
                     postprocess_softmax_stack, refine_mask)
from .select import (circularity, select_best_frame_exact,  # noqa: F401
                     select_max_area_frame)
