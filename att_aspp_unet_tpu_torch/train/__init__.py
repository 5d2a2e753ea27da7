"""Training: losses, on-device augmentation, the host data pipeline and the
train loop."""
