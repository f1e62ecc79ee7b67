# Attention kernels of the port: each module holds a hand-written CUDA
# kernel's wrapper, its plain PyTorch version and a launch counter.
