"""Host-side volume and image IO: MetaImage (.mha), TIFF sweeps, PNG, JSON."""

from .json_io import read_json, write_json  # noqa: F401
from .mha import MetaImage, read_mha, write_mha  # noqa: F401
from .png import read_gray_png, write_gray_png  # noqa: F401
from .volume import read_volume  # noqa: F401
