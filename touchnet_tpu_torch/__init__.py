# Copyright (c) 2026 touchnet_tpu authors.
# touchnet_tpu_torch: the PyTorch / CUDA port of touchnet_tpu for NVIDIA
# Hopper (H100). Module paths mirror touchnet_tpu/ so each counterpart is
# found under the same name; the JAX package stays the reference the port
# is tested against. This package imports torch and never jax.
#
# Slice 1 is serving: Llama KV-cache generation
# (models/llama/inference_llama.py) with hand-written CUDA kernels for the
# packed flash-attention forward (ops/attention.py) and the ragged flash
# decode (ops/decode_attention.py).

__version__ = "0.1.0"
