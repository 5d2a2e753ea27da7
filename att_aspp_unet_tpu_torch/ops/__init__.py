"""Image ops: normalisation, median, blur, resize (``image``) and CLAHE
(``clahe``); the hand-written kernels live in ``kernels``."""
