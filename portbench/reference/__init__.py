"""The benchmark's plain reference: plain PyTorch (f32, TF32 off), NumPy and
SciPy, importing nothing of the program."""
