"""PyTorch + CUDA port of att_aspp_unet_tpu for NVIDIA Hopper."""
