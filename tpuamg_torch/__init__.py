"""PyTorch + CUDA port of tpuamg."""
