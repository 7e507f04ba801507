"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

K1 `decode_attention.paged_decode_attention`, K2 `flash_attention.
chunk_prefill_attention`, K3 `topk_l2.topk_l2`: each wrapper launches its
CUDA kernel (`csrc/`, built on first use by `_build`) for a CUDA tensor and
runs its plain version for a CPU tensor. There is no backend switch.
"""
