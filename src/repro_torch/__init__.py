"""PyTorch / CUDA port of the QUEST query engine (`repro`), for an NVIDIA H100.

Module names and layout mirror the JAX package so each counterpart is easy
to find (`repro_torch.models.layers` <-> `repro.models.layers`, ...). The
jax-free modules of `repro` (core/, obs/, data/, index/segmenter.py,
extract/oracle.py, models/config.py) are kept here as copies; this package
imports torch, numpy and the standard library, and never `jax` or `repro`.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``. The kernels of the served paths -- L2 top-k, paged decode
attention, paged chunk-prefill attention, paged verify attention,
dense-cache (slab) decode attention and the Mamba1 selective scan, K1-K5
and K7 of `kernels/` -- are hand-written CUDA C++ for sm_90a under
`kernels/csrc/`; on a CPU tensor each wrapper runs its plain PyTorch
version instead.
"""
