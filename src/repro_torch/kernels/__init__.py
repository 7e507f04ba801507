"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

K1 `decode_attention.paged_decode_attention`, K2 `flash_attention.
chunk_prefill_attention`, K3 `topk_l2.topk_l2`, K4 `verify_attention.
paged_verify_attention`, K5 `decode_attention.decode_attention` (dense,
slab-layout cache), K7 `ssm_scan.ssm_scan` (the Mamba1 selective scan):
each wrapper launches its CUDA kernel (`csrc/`, built
on first use by `_build`) for a CUDA tensor, counts the launch, and runs
its plain version for a CPU tensor. There is no backend switch.
"""
