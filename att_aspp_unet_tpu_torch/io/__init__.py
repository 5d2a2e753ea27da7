"""Host-side volume IO: MetaImage (.mha) and JSON."""

from .json_io import read_json, write_json  # noqa: F401
from .mha import MetaImage, read_mha, write_mha  # noqa: F401
