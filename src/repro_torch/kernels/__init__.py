# Hand-written CUDA kernels (sources in ../csrc), each with its plain
# PyTorch version beside it; built with nvcc on first use (build.py).
