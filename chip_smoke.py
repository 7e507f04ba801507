#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out DIR] [--profile] [--phases P,Q,...]

Runs from the root of a checkout, imports nothing of JAX or of the JAX
package, and goes through its phases, each printing one JSON line. By
default it runs every phase; `--phases` names some (main, spec, slab,
draft, frontend, cascade, live, mesh, train, ssm, moe, vlm, grok, hybrid,
whisper, dense_family, dryrun, kernels, reference), and each brings the phases it
needs (`NEEDS`: the paths on the legal corpus's 100 documents compare with
main's rows, kernels checks the launches the model paths captured):

  device     the card's name and power limit (nvidia-smi);
  build      nvcc build of the port's CUDA kernels from the checkout's sources,
             with ptxas' registers, spills and shared memory of the
             paged-attention core's K4, K5 and non-causal K2 instantiations
             (`ptxas_core`), of K2's non-causal form on Hopper's wgmma
             (`ptxas_k2nc_sm90`: no spill allowed) and of K7's (`ptxas_scan`);
  main       one QUEST query on qwen2.5-3b at its published width
             (d_model 2048, bf16, random weights from --seed), cut to its
             first MAIN_LAYERS = 8 of 36 layers to fit the time limit,
             through the entry points a user calls: Session.prepare(q).
             submit() -> TwoLevelRetriever over the legal corpus ->
             ServedExtractor -> paged ServingEngine; the kernel launch
             counts are set to 0 just before the query and read just after;
  spec       the same query and cut weights with the settings the system is
             served with: prefix cache on and prompt-lookup speculative
             decoding (spec_k=4), so every decode round is a verify round
             through K4 and prompt suffixes resume after a cached prefix;
             counts set to 0 just before and read just after; agreement
             with the main phase is reported, not asserted (bf16 rounds
             differently in verify rounds and resumed chunks);
  slab       the same query and cut weights on the slab KV layout
             (kv_layout="slab", prefix cache and speculation off): every
             prompt prefills whole, bucketed to chunk_size, through K2 over
             the slab seen as pages, and every decode step runs K5 on the
             slab (one launch a layer); rows and the ledger's token columns
             must equal the main phase's, K1 and K4 must stay at 0;
  draft      on the cut weights, the spec phase's engine with draft-model
             speculation instead of prompt lookup: spec_decode="draft" with
             the target's own weights as the draft (self-drafting, the
             acceptance ceiling). The target prefills in chunks (K2) and
             verifies (K4); the drafter prefills each prompt bucketed (K2)
             and drafts with batched slab decode steps (K5). Acceptance,
             verify rounds and the drafter's steps are reported; rows and
             ledger token columns must equal the main phase's, K1 must
             stay at 0;
  frontend   on the cut weights, the serving tier: the query submitted at
             once by two tenants ("gold" with weight 2, "silver") into one
             session, whose extraction rounds go through a ServingFrontend
             (max_prefill_chunks=2) over a ReplicaGroup of two engines
             sharing one KV pool and one prefix cache (slots 4 each, spec
             off: K1, K2, K3). Every ticket must end DONE, each tenant's
             rows equal main's, both replicas decode, and once the query
             is done the pool holds only the prefix cache's pages; the
             tenants' TenantStats (in pump ticks) and ledgers are reported;
  cascade    on the cut weights, benchmarks/bench_cascade.py's workload (40
             SWDE universities and 10 laptops, its tuition/enrollment
             query, max_new 6): target-only, cascade="verify_all" and
             cascade="on", the cheap tier bench_cascade's one-layer cut of
             the target config (d_model 32) with weights from --seed + 1.
             Rows must be identical across the three and verify_all must
             escalate every small-tier extraction; routed_small,
             escalations and target_tokens_saved are reported;
  live       on the cut weights, a LiveCorpus over the first LIVE_DOCS
             legal documents with a LiveRetriever on the card and a
             LiveSession with the spec settings and document-first
             escalation: one query, a doc-first escalate_batch of the
             document to delete, three one-attribute updates, the delete
             and one ingest, then the query again. Its rows must equal a
             fresh Session's over rebuild_reference() in the same phase,
             the live doc index must rank as the rebuild's, and the
             deleted document's prefix pages must be back in the pool
             (K2, K3, K4); reembedded / edited bytes are reported;
  mesh       on the cut weights, the query on the first FAMILY_DOCS legal
             documents on a serving mesh: a one-rank NCCL process group (a
             FileStore under --out, no network), make_serving_mesh((1, 1))
             and ServingEngine(mesh=) with MESH_CHUNK chunks in two modes,
             off (K1, K2, K3) and prompt lookup with the prefix cache (K2,
             K3, K4), each also on the card without a mesh: rows, ledger,
             engine counters (kv_bytes_peak included), every request's
             tokens and the launch counts must be identical; on the first
             MESH_FEW_DOCS documents the same for the slab layout (the
             slab's sequence over `model`: its decode steps run the
             sequence-sharded combine, whose leaf is K5s, where the card
             alone runs K5) and the draft-model drafter (its slab on the
             mesh too). Then the sequence-sharded decode combine
             (`distributed.decode`, leaf K5s) against K5 at the slab
             path's decode shape in bf16 within TOL, and the int8 pod
             gradient mean on a one-rank pod group against _dq8(_q8(g))
             exactly; the process group is destroyed. A failed NCCL init
             or collective fails the phase. The ssm, moe, grok, hybrid
             and whisper phases each end with their query on the first
             FAMILY_MESH_DOCS = 3 documents on a 1x1 mesh of their own and on the
             card alone, on the phase's cut weights, which must be
             identical in the same way (`_family_mesh`, a line
             "<phase>_mesh");
  train      with the served qwen2.5-3b weights freed, training
             (`repro_torch.training.Trainer`) at published width:
             qwen2.5-3b's first MAIN_LAYERS layers as float32 masters,
             TRAIN_STEPS AdamW steps (OptConfig's defaults) of TRAIN_BATCH x
             TRAIN_SEQ tokens of the wiki corpus; losses, step ms (median of
             steps 2-4), tokens/s, peak allocated memory and the model-flops
             share (6 N D over the step time and 989e12 flop/s); K2 =
             layers x rows x steps and nothing else; the first step's loss
             and gradients within TRAIN_CONTROL_TOL of the same step through
             the kernels' plain versions on the card; a second trainer on
             one repeated batch must lower its loss (`phase_train`); with
             --profile one more step's device busy share. Then, with those
             trainers freed, the same Trainer for MESH_TRAIN_STEPS = 2 steps
             on a 1x1 NCCL mesh (`Trainer(mesh=)`: `forward(mesh=)`, the
             collectives with their gradients, the sharded AdamW state):
             its losses, gradient norms and per-leaf parameter checksums
             equal to the card alone's first two steps bit for bit, K2 =
             layers x rows x 2 and nothing else; its step ms beside the
             card alone's. The peak memory is read from the allocation at
             the phase's start, after the garbage of the earlier phases is
             collected (both allocations reported);
  ssm        with the qwen2.5-3b weights freed, the same query on
             falcon-mamba-7b (Mamba1) at its published width, cut to its
             first SSM_LAYERS = 16 of 64 layers (d_model 4096, d_inner 8192,
             bf16, random weights from --seed), with the spec phase's served
             settings and chunk_size=128: every prompt chunk and every
             verify round runs the selective scan through K7 (one launch a
             layer a forward), verify
             rounds keep per-position state checkpoints and roll rejected
             drafts back from them, prefix entries carry the recurrent
             state. Rows and the ledger's input tokens must equal the main
             phase's (output tokens are reported: another model may end
             elsewhere); K1, K2, K4, K5 and K6 must stay at 0;
  moe        with the falcon-mamba-7b weights freed, the same query on
             deepseek-v2-lite-16b (MLA attention + MoE, 15.7B parameters)
             at its published width, cut to its first MOE_LAYERS = 7 of 27
             layers (d_model 2048, 64 routed experts of which 6 a token,
             bf16, random weights from --seed), with the ssm phase's
             settings: every prompt chunk and verify round gates each of
             its 6 MoE layers through K6; MLA
             attends the compressed ckv/krope pool in plain PyTorch, as the
             JAX package does. Rows and the ledger's input tokens must equal
             the main phase's; K6 = 13 x (chunks + verify rounds); K1, K2,
             K4, K5 and K7 must stay at 0;
  vlm        with the deepseek-v2-lite-16b weights freed, the query on the
             first VLM_DOCS = 40 legal documents on llava-next-mistral-7b
             (a Mistral-7B decoder behind a 2,880-position image prefix,
             7.26B parameters) at its published width and all 32 layers
             (d_model 4096, 32 heads over 8 KV heads, bf16, random weights
             from --seed), with the ssm phase's settings and max_len
             VLM_MAX_LEN: every prompt's first chunk carries the projected
             image rows ahead of its 128 text positions (K2 at C = 3,008
             from position 0), prefix entries hold image and text pages,
             and every verify round attends ~3,000-4,000 keys (K4). Rows
             and the ledger's input tokens must equal SMOKE qwen2.5-3b's on
             the same documents; K1, K5, K6 and K7 must stay at 0;
  grok       with the llava weights freed, grok-1-314b (MoE with standard
             GQA attention, 48 heads over 8 at D 128, 8 experts of d_ff
             32,768 of which 2 a token) at its published width, its first
             GROK_LAYERS = 4 of 64 layers (only the cut is drawn, ~42.6 GB
             in bf16; the count of the whole, 316,489,340,928, comes from
             the meta device), on the first FAMILY_DOCS = 20 legal documents
             with the ssm phase's settings, rows held to SMOKE
             qwen2.5-3b's there: K2, K3 and K4 on the pool (the sink page
             written as the JAX engine writes it), K6 = 4 x (chunks +
             verify rounds), no K1, K5 or K7;
  hybrid     with the grok weights freed, zamba2-2.7b (Mamba2 layers in
             plain PyTorch; 2 shared attention blocks applied before every
             6 of them with a LoRA adapter each, 32 heads over 32 at D 80)
             at its published width, its first HYBRID_LAYERS = 18 of 54
             layers (3 of the 9 applications; the count of the whole,
             2,551,125,920, comes from the meta device), on the same
             documents with the same settings: K2 = 3 x chunks, K4 = 3 x
             verify rounds, no K1, K5, K6 or K7; at least one prefix hit
             (rollback is held by the reference phase's scripted drafts);
  whisper    with the zamba2 weights freed, whisper-medium (the
             encoder-decoder family: 24 LayerNorm encoder layers over the
             stub frontend's 1,500 zero frames, 24 decoder layers with
             learned positions and cross-attention, 16 heads over 16 at D
             64, 844,666,880 parameters) at its published width and all its
             layers, on the same documents with the same settings, rows held
             to SMOKE qwen2.5-3b's: the engine encodes the frames once (K2's
             non-causal form, "K2nc", 24 launches, all on its Hopper kernel,
             `bidirectional_attention_sm90.cu`) into each slot's cross K/V;
             every chunk runs K2 and every verify round K4 for the decoder's
             self-attention, and each of them K2nc on the paged-attention
             core for every decoder layer's cross-attention; K5 for the
             cross-attention of decode steps (none with prompt lookup), no
             K1, K6 or K7. Not profiled;
  dense_family  with the zamba2 weights freed, qwen3-32b (qk-norm),
             nemotron-4-15b (ungated squared-ReLU MLP, 48 heads over 8:
             GQA group 6) and deepseek-67b at their published widths, each
             cut to its first DENSE_LAYERS layers (only the cut is drawn;
             the full count comes from the meta device), each serving the
             query on the reference phase's 20 documents with the spec
             settings. Rows must equal SMOKE qwen2.5-3b's on the same
             documents; K2, K3 and K4 must launch and K1 must stay at 0.
             Then a fourth, derived model (not a published one, DENSE_MLA):
             deepseek-v2-lite-16b's own first-layer block -- MLA attention
             (r 512, rope 64, nope 128, v 128) and its dense MLP (d_ff
             10,944) -- as a dense model at its published widths (d_model
             2,048, 16 heads, vocab 102,400), DENSE_LAYERS deep, bf16 from
             --seed, served the same way: MLA attends the latent pools in
             plain PyTorch, so K3 launches and no other kernel; its
             kv_bytes_peak beside qwen3-32b's; and its query on the first
             FAMILY_MESH_DOCS documents on a 1x1 NCCL mesh, identical to
             the card alone ("dense_family_mesh");
  dryrun     the production dry run (`repro_torch.launch.dryrun`) in two
             child processes without a CUDA device (its fake process
             group must not meet the mesh phases' NCCL group), started
             after the build beside the card's phases: qwen2.5-3b's
             decode_32k and train_4k cells at --probe 2 as rank 0 of the
             (16, 16) production mesh, on meta tensors; each record's
             status, flops, collective bytes, temp bytes and seconds. A
             record that is not "ok" fails the phase;
  kernels    every kernel of those paths (K1 paged decode attention, K2
             paged chunk-prefill attention, K3 L2 top-k, K4 paged verify
             attention, K5 dense-cache decode attention, K5s its
             statistics on one shard of a sequence-sharded slab, K6 MoE
             gating, K7 selective scan) on the inputs of one of its real
             launches (K5s at the mesh phase's sequence-sharded decode
             shape, the second of two shards, with rows whose length ends
             before it, and K5 over the same shard's keys as its
             yardstick; K6
             and K7: a prefill chunk and a verify round; K2 also the slab
             phase's largest whole-prompt launch and the vlm phase's first
             chunk with the image prefix, K2 and K4 also at grok's and
             zamba2's shapes, K6 also at grok's E 8, k 2, and K6's grouped
             launch (`_kernel_k6_grouped`: the moe chunk's logits as 2 and
             4 groups, grok's as 2, each group at its own capacity, beside
             one ungrouped launch a group; its launches are the reference
             phase's grouped mode's); K2's non-causal
             form at whisper's encoder, cross-attention chunk and verify
             round, K5 also at whisper's cross-attention of a decode step
             (four slots over 1,500 keys); K1
             also its captured
             launch with every length at the full table; K4 in the engine's
             layout and as a contiguous input), plus edge cases (K1, K2, K4
             and K5: ~66-74 each in bf16 and float32, `_paged_edges`,
             GQA group 6, the dense family's head counts, zamba2's head
             width 80 and whisper's 16 heads over 16 at D 64 among them;
             K2's non-causal form 16, Skv 1 to 1,500 x Sq 1 to 1,500, and 21
             bf16 cases on its Hopper kernel, partial query and key tiles and
             key limits inside a tile; K3 12
             shapes, N up to 16,384 and exact
             ties; K6 20, with the capacity numbering, grok's E 8, k 2 at
             T 128 and 20 among them; K7 11 shapes in both dtypes), held
             against its plain PyTorch version (an attention row in its
             own dtype in the allclose form of the JAX package's kernel
             tests, `close_err`; K3's indices where the distances are
             unique, K6's indices and slots, K7's states exactly), and each
             training kernel's gradient (`_kernel_grads`: K2 at the train
             phase's launch and at D 80, K2nc on both routes, K6 at E 64 k 6
             and E 8 k 2, K7 at a falcon chunk): the autograd form's
             forward and gradient (the kernel forward, the plain version's
             backward recomputed, the upstream gradient a function of the
             forward's output) against the plain version's autograd, with
             forward + backward
             times beside SDPA's where one exists; K7 also at each
             R (states a thread) and group (steps walked together) its kernel has,
             whose outputs must equal the wrapper's bit for bit. Times: CUDA
             events (`ms`) beside its bound and a PyTorch library yardstick
             where one call computes the same function (none does for K7;
             K6's is the sequence it replaced in `moe_apply`);
             and for every kernel (K6 and K7 at both launches, K7 at each R
             and group) and the library yardsticks the device time per call
             (`device_ms`: a CUDA graph of 20 calls, every kernel a call
             launches, the merge included, replayed under CUDA events),
             since events over back-to-back calls read the host's call
             rate;
  profile    (only with --profile) torch.profiler over one extraction round
             of each path (main, spec, slab, draft, ssm, moe, vlm, hybrid):
             device busy share, device time by kernel group; on the ssm, moe
             and hybrid paths also the round's forwards and device kernels
             a forward; on the moe path the device time of MLA attention
             and of the expert products;
  reference  the same served query code at a small size (SMOKE configs,
             float32, 10 legal documents) on the card and on the CPU's plain
             path: qwen2.5-3b in four modes (speculation and the prefix
             cache off; prompt lookup with the prefix cache; the slab layout
             with the prefix cache, whose snapshot, expand and token-by-
             token suffix decode run on the card; self-drafting),
             falcon-mamba-7b in four (off; prompt lookup with the prefix
             cache; slab with the prefix cache; scripted drafts of which two
             of four are right, so rejected drafts roll back to a checkpoint
             past the first position), deepseek-v2-lite-16b in
             qwen2.5-3b's four, K6 gating on the card, llava-next-mistral-7b
             in three (off; prompt lookup with the prefix cache; slab with
             the prefix cache: the image prefix through every layout),
             qwen3-32b (random q/k-norm weights), nemotron-4-15b and
             deepseek-67b with prompt lookup and the prefix cache, SMOKE
             dense MLA (DENSE_MLA's derivation of SMOKE
             deepseek-v2-lite-16b) with prompt lookup and the prefix cache
             on the page pool, grok-1-314b in llava's three (its K/V pools, sink page
             included, card against CPU to TOL, and its prompt-lookup mode
             twice on the card with bit-identical pools), zamba2-2.7b in
             falcon-mamba-7b's four and whisper-medium in llava's three with a
             position table of REF_WHISPER_POSITIONS rows, its slots' cross
             K/V card against CPU (every mode on the first REF_NEW_DOCS =
             5 documents, every slab mode on the first
             REF_SLAB_DOCS = 3, beside qwen2.5-3b's plain mode there,
             "off_few", which gives their rows); and the serving
             tier in three qwen2.5-3b modes (the frontend phase's two
             tenants over two replicas; cascade="on" with the cheap tier;
             one update and one delete between two queries on a live
             corpus, with doc-first escalation). Rows, ledger token
             columns, engine (and drafter) counters and every generated
             token must be identical across the two devices (for the
             serving tier also the group, replica, frontend and tenant
             counters, the CascadeServedStats and the live corpus's
             counters), and rows and
             tokens identical to the model's first mode in every mode (for
             MoE rows only: capacity is set per call, so a verify round
             drops assignments a decode step does not, and tokens may
             differ by mode; the dense family's one mode: rows equal
             llava's first mode's on the same documents; the slab modes'
             rows equal "off_few"'s, and their tokens their off mode's for
             every prompt the two share);
             falcon-mamba-7b's and zamba2-2.7b's recurrent state and
             whisper-medium's cross K/V must also
             agree across the devices. Training modes (`training_runs`):
             the seven families' SMOKE configs in float32, the first
             step's loss and gradients and the parameters after two AdamW
             steps (qwen2.5-3b also Adafactor and 8-bit Adam; SMOKE dense
             MLA too;
             deepseek-v2-lite-16b also under set_moe_groups(2): K6's
             grouped launch, aux 0) card against CPU within TRAIN_REF_TOL,
             each family's kernels launched on the card, and crash-resume
             on the card (crash at step 6, resume from the step-4
             checkpoint) bit for bit, also with the crash on a 1x1 NCCL
             mesh (its checkpoint the global arrays) resumed on the card
             alone.

The compile cache: the main phase's engine is built with
`compilation_cache_dir=` the build's directory, and a child process
started after the build enables the same directory
(`launch.compile_cache`) and loads the kernel library from it, with
nvcc made to fail: it must load the cached library ("compile_cache").

Every phase raises on a mismatch. Then it prints each phase's seconds,
the `kernels` summary line (K1-K7 and K2's non-causal form; empty when
the kernels phase did not run), the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that
line. It needs one CUDA device and exits non-zero without one, or when
the repository's `src/repro_torch` is not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (dense): HBM bytes/s and flop/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5, "topk": 1e-4}
# K3's indices against its plain version's are compared where the plain
# distance is farther than this from its neighbours (the two sum d^2 in
# different orders, so values within a few ulps may swap)
K3_MARGIN = 1e-3
# K6's weights against its plain version: float32 throughout, the softmax's
# exponentials and sum rounded in another order (the indices must be equal)
K6_TOL = 1e-6
# the recurrent state of a served SMOKE query, card against CPU, float32:
# the same recurrence, with matmuls summed in another order on the card
STATE_TOL = 1e-4
# exponentials per second on the SFU: 16 per clock per SM (NVIDIA's CUDA
# C++ documentation, the arithmetic instruction throughput table, compute
# capability 9.0) x 132 SMs x the H100 SXM's 1,980 MHz boost clock
SFU_OPS_S = 16 * 132 * 1.98e9


def _ptxas_entries(log: str):
    """(mangled kernel name, spill-store bytes, registers, static smem bytes)
    of every entry function in nvcc's `-Xptxas -v` log."""
    import re
    name, spill = None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), "?"
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            yield name, spill, m.group(1), smem.group(1) if smem else "0"


def core_ptxas(log: str, tags) -> dict:
    """The paged-attention core's instantiations for the given tags, from
    nvcc's `-Xptxas -v` log: "<tag> <dtype> DP=<head width> KW=<key
    groups>" -> registers, spill bytes, static and dynamic shared memory
    (the dynamic part is paged_attention.cuh's `smem_bytes`)."""
    import re
    out = {}
    for name, spill, regs, smem in _ptxas_entries(log):
        k = re.search(r"paged_attention_kernelI.*?(\w+?)E(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
                      name)
        tag = k and next((t for t in tags if k.group(1).endswith(t)), None)
        if tag is None:
            continue
        size = 4 if k.group(2) == "f" else 2
        dp, kw = int(k.group(3)), int(k.group(4))
        stages = 1 if size == 4 and dp > 128 else 2
        dyn = (64 // kw + 2 * stages * 64) * (dp + 16 // size) * size
        out[f"{tag} {'float32' if size == 4 else 'bf16'} DP={dp} KW={kw}"] = (
            f"{regs} registers, spill {spill} B, smem {smem} B static + {dyn} B dynamic")
    return out


def sm90_ptxas(log: str) -> dict:
    """K2's non-causal form on Hopper's wgmma (`bidirectional_attention_sm90.cu`)
    from nvcc's `-Xptxas -v` log: its one kernel's registers a thread at
    launch (before `setmaxnreg` moves them), spill bytes and static shared
    memory; raises if the kernel is missing or spills."""
    found = [(spill, regs, smem) for name, spill, regs, smem in _ptxas_entries(log)
             if "bidirectional_attention_sm90_kernel" in name]
    if len(found) != 1:
        raise AssertionError(f"bidirectional_attention_sm90: {len(found)} kernels in the log")
    spill, regs, smem = found[0]
    if spill != "0":
        raise AssertionError(f"bidirectional_attention_sm90 spills {spill} B")
    return {"kernel": f"{regs} registers, spill {spill} B, smem {smem} B static"}


def gating_topk_ptxas(log: str) -> dict:
    """K3's kernels and K6's instantiations (input type, experts a lane)
    from nvcc's `-Xptxas -v` log -> registers and spill bytes."""
    import re
    out = {}
    for name, spill, regs, _smem in _ptxas_entries(log):
        k3 = re.search(r"(topk_l2_\w+?_kernel)", name)
        k6 = re.search(r"moe_gating_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
        if k3:
            out[k3.group(1)] = f"{regs} registers, spill {spill} B"
        elif k6:
            dtype = "float32" if k6.group(1) == "f" else "bf16"
            out[f"moe_gating {dtype} EPL={k6.group(2)}"] = f"{regs} registers, spill {spill} B"
    return out


def scan_ptxas(log: str) -> dict:
    """K7's instantiations from nvcc's `-Xptxas -v` log: "<dtype>" and its
    template integers (R=<states a thread> L=<lanes a channel> G=<steps
    walked together>) -> registers, spill bytes, static shared memory (the
    tiles are dynamic shared memory, sized per launch)."""
    import re
    out = {}
    for name, spill, regs, smem in _ptxas_entries(log):
        k = re.search(r"ssm_scan_kernelI(f|13__nv_bfloat16)((?:Li\d+E)*)", name)
        if k is None:
            continue
        ints = re.findall(r"Li(\d+)E", k.group(2))
        tag = ("float32" if k.group(1) == "f" else "bf16") + "".join(
            f" {n}={v}" for n, v in zip(("R", "L", "G"), ints))
        out[tag] = f"{regs} registers, spill {spill} B, smem {smem} B static"
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DEVICE_MS_METHOD = ("a CUDA graph of 20 calls (every kernel each call launches, the merge "
                    "included) replayed 10 times under CUDA events, after 3 warm-up calls; / 200")


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time (ms) per call of `fn`, without the host: `calls` calls
    captured in one CUDA graph, replayed `replays` times between two CUDA
    events (`DEVICE_MS_METHOD`); the gaps between the graph's kernels are
    counted, the host's launch overhead is not."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound(nbytes: float, flops: float, dtype: str, exps: float = 0.0) -> tuple:
    """The least time (ms) for the work, and what bounds it: the bytes over
    HBM's rate, or the operations -- flops over the peak for their type,
    exponentials over the SFU's rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(flops / PEAK_FLOPS[dtype], exps / SFU_OPS_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def close_err(a, b) -> float:
    """The largest |a - b| / (1 + |b|): within tol exactly when a and b are
    allclose at atol = rtol = tol, the form of the JAX package's kernel
    tests (`tests/test_kernels.py`). An attention row's check takes it in
    its own dtype: at grok-1-314b's width its outputs reach |x| >= 4, where
    one bf16 ulp is 0.03125."""
    if not a.numel():
        return 0.0
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (1 + b.abs())).max())


def _sha(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes (None
    skipped): equal digests mean bit-identical tensors."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            t = t.detach().contiguous().cpu()
            h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()[:16]


# ------------------------------------------------------------- capture ---


class Capture:
    """Wrap a kernel wrapper (module attribute) to keep a copy of the inputs
    of its most demanding launch. The original wrapper still runs and
    counts the launch."""

    def __init__(self, module, name, size_of):
        self.module, self.name, self.size_of = module, name, size_of
        self.orig = getattr(module, name)
        self.best, self.args = -1, None
        setattr(module, name, self)

    def __call__(self, *args):
        size = self.size_of(*args)
        if size > self.best:
            self.best = size
            self.args = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
        return self.orig(*args)

    def restore(self):
        setattr(self.module, self.name, self.orig)


# --------------------------------------------------------------- phases ---


def _legal_query(core):
    return core.Query(tables=["cases"], select=[("cases", "case_number")],
                      where=core.conj(core.Filter("year", ">=", 2015, table="cases"),
                                      core.Filter("charges", ">", 3, table="cases")))


SPEC = {"prefix_cache": True, "spec_decode": "prompt_lookup", "spec_k": 4}
SLAB = {"kv_layout": "slab"}
# The four qwen2.5-3b phases run the first MAIN_LAYERS of the 36 layers at
# full width, so that the whole command stays well inside its time limit:
# the four paths at 36 layers took 1,128 s of the 1,200 s with --profile
# on one H100 80GB HBM3; main and spec were cut first, then slab and draft
# when the moe phase and its reference modes came in (1,223 s with
# --profile, slab and draft still at 36 layers); the whisper phase brought
# them from 12 to 8 layers, after the cuts of SSM_LAYERS and MOE_LAYERS.
MAIN_LAYERS = 8
# The ssm and moe phases feed prompts in 128-token chunks: their walls
# follow the number of forwards, and each chunk gives K7 a real sequence and
# K6 a real batch of tokens.
DEEP_CHUNK = 128
# With the vlm and dense_family phases and six more reference modes the
# whole command took 1,360 s with --profile on one H100 80GB HBM3,
# so these were cut, in this order: the new reference modes run on the
# first REF_NEW_DOCS legal documents, the vlm phase on the first VLM_DOCS,
# and falcon-mamba-7b and deepseek-v2-lite-16b run their first SSM_LAYERS
# of 64 and MOE_LAYERS of 27 layers at full width (drawn whole, then cut).
# REF_NEW_DOCS went from 10 to 5 (3 rows, every spec mode with prefix hits
# and drafts) to pay, with REF_SLAB_DOCS, for the train phase's mesh run,
# the grouped training mode and the mesh crash-resume.
REF_NEW_DOCS = 5
VLM_DOCS = 40
# The mesh phase (~20 s on one H100 80GB HBM3) took its time from the
# reference phase's slab modes, that phase's largest block (~204 of its
# ~260 s of card time on 10 documents): with the prefix cache each request
# decodes its unshared suffix token by token, so a slab mode's time follows
# its documents. Every slab mode runs on the first REF_SLAB_DOCS documents,
# its rows held to qwen2.5-3b's plain mode on the same documents
# ("off_few"): 5 until the mesh training runs came, then 3 (1 row, two
# prefix hits a mode).
REF_SLAB_DOCS = 3
# Each family's query on a 1x1 mesh (`_family_mesh`: 49.7 s over five
# phases on 5 documents) runs on the first FAMILY_MESH_DOCS, which pays
# for the train phase's mesh run and the reference phase's grouped mode
# and mesh crash-resume.
FAMILY_MESH_DOCS = 3
# With the whisper phase, its kernel rows and its three reference modes
# the command would pass its limit with --profile, so the earlier depths
# were cut again (whisper itself runs on FAMILY_DOCS, its reference modes
# on REF_NEW_DOCS, and it is not profiled): deepseek-v2-lite-16b to its
# first 7 layers, then falcon-mamba-7b to its first 16, then the qwen2.5-3b
# paths to MAIN_LAYERS = 8.
SSM_LAYERS = 16
MOE_LAYERS = 7
# The vlm phase's cache bound: llava's 2,880 image positions, the longest
# legal prompt and max_new fit in 4,096 positions (256 pages of 16).
VLM_MAX_LEN = 4096
# The grok and hybrid phases serve the first FAMILY_DOCS legal
# documents, as vlm does its VLM_DOCS; grok-1-314b runs its first
# GROK_LAYERS of 64 layers at published width (4 x 4.92e9 + 1.61e9
# parameters, ~42.6 GB in bf16: the whole model, ~633 GB, fits no card),
# zamba2-2.7b its first HYBRID_LAYERS of 54 (3 of its 9 shared-block
# applications). At 40 documents and all 54 layers, with their seven
# reference modes, the whole command took 1,330.5 s with --profile on one
# H100 80GB HBM3; the reference phase's CPU half then moved beside the
# card's phases (`_CpuReference`) and these phases were cut to 20
# documents (1,154.4 s), then zamba2-2.7b to 18 layers.
FAMILY_DOCS = 20
GROK_LAYERS = 4
HYBRID_LAYERS = 18
# The dense_family phase's configs, each cut to its first DENSE_LAYERS
# layers at full width: deepseek-67b whole (134.9 GB in bf16) does not fit
# one card, and three whole models would not fit the time limit.
DENSE_FAMILY = ("qwen3-32b", "nemotron-4-15b", "deepseek-67b")
DENSE_LAYERS = 4
# The dense_family phase's fourth model and the reference phase's dense MLA
# mode: deepseek-v2-lite-16b's own first-layer block (MLA attention and its
# dense MLP) as a dense model, a derived configuration and not a published
# model (the JAX model runs dense with MLA, src/repro/models/model.py:46).
DENSE_MLA = "deepseek-v2-lite-16b-dense-mla"


def _dense_mla_config(get_config):
    return get_config("deepseek-v2-lite-16b").replace(
        name=DENSE_MLA, family="dense", n_experts=0, n_shared_experts=0,
        first_dense_layers=0)


def _smoke_config(arch: str):
    """The SMOKE config of a registry id, or DENSE_MLA's derivation of SMOKE
    deepseek-v2-lite-16b."""
    from repro_torch.configs import get_smoke_config
    return _dense_mla_config(get_smoke_config) if arch == DENSE_MLA else \
        get_smoke_config(arch)


def _cut(cfg, params, n: int = MAIN_LAYERS):
    """The published config and weights cut to their first n layers (the
    moe family's dense layers first)."""
    nd = len(params.get("dense_layers", []))
    return cfg.replace(num_layers=n), {**params, "layers": params["layers"][:n - nd]}


def _served_query(cfg, params, corpus, device, max_new, chunk_size=32, max_len=1024,
                  retriever=None, **engine_kw):
    """A session over a new TwoLevelRetriever of `corpus`, or over a fork of
    `retriever` (its indexes shared, its per-query state fresh)."""
    from repro_torch import core
    from repro_torch.extract import ServedExtractor
    from repro_torch.index.retriever import TwoLevelRetriever
    from repro_torch.serving import ServingEngine
    t0 = time.perf_counter()
    retriever = TwoLevelRetriever(corpus, device=device) if retriever is None \
        else retriever.fork()
    build_s = time.perf_counter() - t0
    engine = ServingEngine(cfg, params, slots=4, max_len=max_len, page_size=16,
                           chunk_size=chunk_size, device=device, **engine_kw)
    extractor = ServedExtractor(corpus, engine, max_new=max_new)
    session = core.Session(retriever, extractor, batch_size=4)
    return session, engine, extractor, build_s


def _ledger(result) -> dict:
    led = result.ledger
    return {"input_tokens": led.input_tokens, "output_tokens": led.output_tokens,
            "llm_calls": led.llm_calls, "extractions": led.extractions,
            "per_phase": led.per_phase}


def _check_like_main(name, result, main_result):
    """Rows and the ledger's token columns must equal the main phase's: the
    KV layout and the drafter change how tokens are computed, not which
    requests are served."""
    if len(result.rows) != len(main_result.rows) or not result.rows:
        raise AssertionError(f"{name}: {len(result.rows)} rows, main had "
                             f"{len(main_result.rows)}")
    for col in ("input_tokens", "output_tokens"):
        a, b = getattr(result.ledger, col), getattr(main_result.ledger, col)
        if a != b:
            raise AssertionError(f"{name}: ledger {col} {a} != main's {b}")


def _launch_counts():
    """Every kernel's launches; "K2nc" is K2's non-causal form on either of
    its kernels, "K2nc_sm90" those of them on its Hopper kernel, "K6_grouped"
    K6's launches over more than one group (counted in "K6" too)."""
    from repro_torch.kernels import decode_attention as k15
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.kernels import ssm_scan as k7
    from repro_torch.kernels import topk_l2 as k3
    from repro_torch.kernels import verify_attention as k4
    return {"K1": k15.launches, "K2": k2.launches, "K2nc": k2.bidirectional_launches,
            "K2nc_sm90": k2.bidirectional_sm90_launches, "K3": k3.launches,
            "K4": k4.launches, "K5": k15.dense_launches, "K5s": k15.stats_launches,
            "K6": k6.launches, "K6_grouped": k6.grouped_launches, "K7": k7.launches}


def _zero_launches():
    from repro_torch.kernels import decode_attention as k15
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.kernels import ssm_scan as k7
    from repro_torch.kernels import topk_l2 as k3
    from repro_torch.kernels import verify_attention as k4
    k15.launches = k15.dense_launches = k15.stats_launches = 0
    k2.launches = k3.launches = k4.launches = 0
    k2.bidirectional_launches = k2.bidirectional_sm90_launches = k6.launches = k7.launches = 0
    k6.grouped_launches = 0


def _timed_query(session):
    import torch
    from repro_torch import core
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = session.prepare(_legal_query(core)).submit().result()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, _launch_counts()


def phase_main(seed: int, captures: dict) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import topk_l2 as k3
    from repro_torch.models import init_params, param_count

    full_cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full_params = init_params(full_cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, params = _cut(full_cfg, full_params)
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, compilation_cache_dir=str(_build.BUILD_DIR))

    captures["K1"] = Capture(k1, "paged_decode_attention",
                             lambda q, kp, vp, tbl, lens: tbl.shape[1] * q.shape[0])
    captures["K2"] = Capture(k2, "chunk_prefill_attention",
                             lambda q, kp, vp, ctx, start: start)
    captures["K3"] = Capture(k3, "topk_l2_packed", lambda db, q, k: db.shape[0] * q.shape[0])
    result, wall, launches = _timed_query(session)
    for c in captures.values():
        c.restore()

    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "main", "model": cfg.name, "layers": cfg.num_layers,
           "layers_published": full_cfg.num_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "params": param_count(params),
           "params_published": param_count(full_params),
           "docs": len(corpus.docs), "rows": len(result.rows), "ledger": _ledger(result),
           "engine": dict(engine.stats), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "weights_init_s": init_s,
           "index_build_s": build_s, "query_wall_s": wall,
           "generated_tokens_per_s": gen_tokens / wall,
           "compilation_cache_dir": str(_build.BUILD_DIR), "launches": launches}
    emit(out)
    if not result.rows:
        raise AssertionError("the main-path query returned no rows")
    missing = [k for k in ("K1", "K2", "K3") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if not engine.stats["decode_steps"] or not engine.stats["prefill_chunks"]:
        raise AssertionError("the engine ran no decode step or no prefill chunk")
    return out, (session, extractor), (full_params, result, engine)


def _token_agreement(a: dict, b: dict) -> float:
    """Share of generated token positions equal between two runs' finished
    requests (by request id; a position one run lacks counts as unequal)."""
    same = total = 0
    for rid in set(a) | set(b):
        x, y = a.get(rid, []), b.get(rid, [])
        total += max(len(x), len(y))
        same += sum(1 for u, v in zip(x, y) if u == v)
    return same / total if total else 1.0


def phase_spec(main_run, captures: dict) -> dict:
    """The main query on the same weights with the prefix cache and
    prompt-lookup speculative decoding on."""
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import verify_attention as k4

    full_params, main_result, main_engine = main_run
    cfg, params = _cut(get_config("qwen2.5-3b"), full_params)
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, **SPEC)
    captures["K4"] = Capture(k4, "paged_verify_attention",
                             lambda q, kp, vp, tbl, starts: tbl.shape[1] * q.shape[0])
    result, wall, launches = _timed_query(session)
    captures["K4"].restore()

    st = engine.stats
    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "spec", "model": cfg.name, "layers": cfg.num_layers,
           "engine_options": SPEC, "rows": len(result.rows), "ledger": _ledger(result),
           "engine": dict(st), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "index_build_s": build_s,
           "query_wall_s": wall, "generated_tokens_per_s": gen_tokens / wall,
           "acceptance": st["accepted_tokens"] / max(st["draft_tokens"], 1),
           "launches": launches,
           "rows_equal_main": result.rows == main_result.rows,
           "token_agreement_main": _token_agreement(
               {r: q.out for r, q in engine.finished.items()},
               {r: q.out for r, q in main_engine.finished.items()})}
    emit(out)
    if not result.rows:
        raise AssertionError("the spec-path query returned no rows")
    if launches["K4"] <= 0:
        raise AssertionError("K4 never launched on the spec path")
    if launches["K1"] != 0:
        raise AssertionError("K1 launched on the spec path: a decode round skipped verify")
    if st["prefix_hits"] <= 0 or st["spec_rounds"] <= 0:
        raise AssertionError("the spec path had no prefix hit or no verify round")
    return out, (session, extractor)


def phase_slab(main_run, captures: dict) -> tuple:
    """The main query on the slab layout, prefix cache and speculation off;
    keeps K2's largest whole-prompt launch."""
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import flash_attention as k2

    full_params, main_result, _ = main_run
    cfg, params = _cut(get_config("qwen2.5-3b"), full_params)
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, **SLAB)
    captures["K2_slab"] = Capture(k2, "chunk_prefill_attention",
                                  lambda q, kp, vp, ctx, start: q.shape[0])
    result, wall, launches = _timed_query(session)
    captures["K2_slab"].restore()
    st = engine.stats
    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "slab", "model": cfg.name, "layers": cfg.num_layers,
           "engine_options": SLAB, "rows": len(result.rows),
           "rows_main": len(main_result.rows), "ledger": _ledger(result),
           "engine": dict(st), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "index_build_s": build_s,
           "query_wall_s": wall, "generated_tokens_per_s": gen_tokens / wall,
           "launches": launches, "rows_equal_main": result.rows == main_result.rows}
    emit(out)
    _check_like_main("slab", result, main_result)
    L = cfg.num_layers
    if launches["K1"] or launches["K4"]:
        raise AssertionError(f"slab: K1/K4 launched on the slab path: {launches}")
    if launches["K5"] != L * st["decode_steps"] or not st["decode_steps"]:
        raise AssertionError(f"slab: K5 launched {launches['K5']} times for "
                             f"{st['decode_steps']} decode steps of {L} layers")
    if launches["K2"] != L * st["prefill_invocations"] or not launches["K3"]:
        raise AssertionError(f"slab: K2 {launches['K2']} for {st['prefill_invocations']} "
                             f"bucketed prefills, K3 {launches['K3']}")
    return out, (session, extractor), {r: q.out for r, q in engine.finished.items()}


def phase_draft(main_run, captures: dict, slab_tokens: dict) -> tuple:
    """The spec phase's engine with self-drafting instead of prompt lookup."""
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import decode_attention as k15

    full_params, main_result, main_engine = main_run
    cfg, params = _cut(get_config("qwen2.5-3b"), full_params)
    corpus = make_legal_corpus(seed=1)
    opts = {**SPEC, "spec_decode": "draft"}
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, draft_model=(cfg, params), **opts)
    seen = [0]

    def late_launch(q, kc, vc, lens):            # keep a late launch, no sync
        seen[0] += 1
        return seen[0] if seen[0] == 1 or seen[0] % 900 == 0 else -1
    captures["K5"] = Capture(k15, "decode_attention", late_launch)
    result, wall, launches = _timed_query(session)
    captures["K5"].restore()
    if captures["K5"].args is None:
        raise AssertionError("draft: K5 captured no launch")
    st, dst = engine.stats, engine.drafter.stats
    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "draft", "model": cfg.name, "layers": cfg.num_layers,
           "engine_options": {**opts, "draft_model": "the target (self-draft)"},
           "rows": len(result.rows), "rows_main": len(main_result.rows),
           "ledger": _ledger(result), "engine": dict(st), "drafter": dict(dst),
           "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "index_build_s": build_s,
           "query_wall_s": wall, "generated_tokens_per_s": gen_tokens / wall,
           "verify_rounds": st["spec_rounds"], "main_decode_steps": main_engine.stats["decode_steps"],
           "drafted": st["draft_tokens"], "accepted": st["accepted_tokens"],
           "acceptance": st["accepted_tokens"] / max(st["draft_tokens"], 1),
           "launches": launches, "rows_equal_main": result.rows == main_result.rows,
           "token_agreement_slab": _token_agreement(
               {r: q.out for r, q in engine.finished.items()}, slab_tokens)}
    emit(out)
    _check_like_main("draft", result, main_result)
    L = cfg.num_layers
    if launches["K1"]:
        raise AssertionError("draft: K1 launched: a decode round skipped verify")
    if launches["K5"] != L * dst["draft_model_steps"] or not launches["K5"]:
        raise AssertionError(f"draft: K5 launched {launches['K5']} times for "
                             f"{dst['draft_model_steps']} drafter steps of {L} layers")
    if not (launches["K2"] and launches["K3"] and launches["K4"]):
        raise AssertionError(f"draft: a kernel of the path never launched: {launches}")
    if st["spec_rounds"] <= 0 or st["draft_tokens"] <= 0:
        raise AssertionError("draft: no verify round or no draft token")
    return out, (session, extractor)


# The frontend phase: two tenants behind the admission tier, over two
# replicas that share one KV pool and one prefix cache.
FRONTEND_GROUP = {"replicas": 2, "share_kv_pool": True, "prefix_cache": True,
                  "spec_decode": "off", "slots": 4, "max_len": 1024, "chunk_size": 32,
                  "page_size": 16}
FRONTEND = {"tenant_weights": {"gold": 2.0}, "max_prefill_chunks": 2}
TENANTS = ("gold", "silver")
# The live phase runs on the first LIVE_DOCS legal documents: it serves
# three queries (two on the live corpus, one on its rebuild) and builds two
# indexes, so the whole corpus would cost about three main phases.
LIVE_DOCS = 40


def _frontend_stack(cfg, params, corpus, device, max_new):
    """A served session whose extraction rounds go through a
    `ServingFrontend` over a two-replica `ReplicaGroup`."""
    from repro_torch import core
    from repro_torch.extract import ServedExtractor
    from repro_torch.index.retriever import TwoLevelRetriever
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.replicas import ReplicaGroup
    t0 = time.perf_counter()
    retriever = TwoLevelRetriever(corpus, device=device)
    build_s = time.perf_counter() - t0
    group = ReplicaGroup(cfg, params, device=device, **FRONTEND_GROUP)
    frontend = ServingFrontend(group, **FRONTEND)
    extractor = ServedExtractor(corpus, group, max_new=max_new, frontend=frontend)
    return core.Session(retriever, extractor, batch_size=4), group, frontend, extractor, build_s


def _run_tenants(session):
    """The legal query submitted at once as each tenant; both handles are
    driven together to their results."""
    from repro_torch import core
    handles = [session.submit(_legal_query(core), tenant=t) for t in TENANTS]
    return [h.result() for h in handles]


def _prefix_pages(prefix_cache) -> set:
    """Page ids the prefix cache's entries hold (full pages and CoW tails)."""
    pages = set()
    for e in prefix_cache._entries.values():
        pages.update(e.pages)
        if e.tail_page is not None:
            pages.add(e.tail_page)
    return pages


def phase_frontend(main_run) -> dict:
    """The main query submitted at once by two tenants through the admission
    frontend, over two replicas sharing one KV pool and prefix cache."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.serving.frontend import DONE

    full_params, main_result, _ = main_run
    cfg, params = _cut(get_config("qwen2.5-3b"), full_params)
    corpus = make_legal_corpus(seed=1)
    session, group, frontend, extractor, build_s = _frontend_stack(
        cfg, params, corpus, "cuda", max_new=12)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = _run_tenants(session)
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, _launch_counts()
    alloc = group.engines[0].alloc
    held = _prefix_pages(group.prefix_cache)
    tickets = list(frontend._tickets.values())
    statuses = sorted({t.status for t in tickets})
    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "frontend", "model": cfg.name, "layers": cfg.num_layers,
           "group_options": FRONTEND_GROUP, "frontend_options": FRONTEND,
           "tenants": list(TENANTS),
           "rows": {t: len(r.rows) for t, r in zip(TENANTS, results)},
           "rows_equal_main": {t: r.rows == main_result.rows for t, r in zip(TENANTS, results)},
           "ledger": {t: _ledger(r) for t, r in zip(TENANTS, results)},
           "tenant_ledgers": session.tenant_costs(),
           "tenant_stats_ticks": frontend.tenant_snapshot(),
           # one session serves both handles: a need of silver's that gold's
           # request already answers is not sent again
           "requests_by_tenant": {t: frontend.tenants[t].submitted if t in frontend.tenants
                                  else 0 for t in TENANTS},
           "frontend": dict(frontend.stats), "tickets": len(tickets),
           "ticket_statuses": statuses, "group": dict(group.stats),
           "replicas": [dict(e.stats) for e in group.engines],
           "served_requests": extractor.stats.requests, "generated_tokens": gen_tokens,
           "index_build_s": build_s, "query_wall_s": wall,
           "generated_tokens_per_s": gen_tokens / wall,
           "pool_pages": alloc.num_pages, "pool_used_pages": alloc.used_pages,
           "prefix_cache_pages": len(held), "launches": launches}
    emit(out)
    for t, r in zip(TENANTS, results):
        if not r.rows or r.rows != main_result.rows:
            raise AssertionError(f"frontend: tenant {t} got {len(r.rows)} rows, not main's "
                                 f"{len(main_result.rows)}")
    if not tickets or statuses != [DONE]:
        raise AssertionError(f"frontend: tickets ended {statuses}, not all done")
    if not all(e.alloc is alloc for e in group.engines) or \
            not all(e.stats["decode_steps"] > 0 for e in group.engines):
        raise AssertionError("frontend: the replicas do not share one pool, or one "
                             "replica did no decode work")
    if alloc.used_pages != len(held) or \
            any(alloc.refcount[p] <= 0 for p in held):
        raise AssertionError(f"frontend: {alloc.used_pages} pages in use once the query "
                             f"is done, the prefix cache holds {len(held)}")
    missing = [k for k in ("K1", "K2", "K3") if launches[k] <= 0]
    if missing or launches["K4"] or launches["K5"]:
        raise AssertionError(f"frontend: kernels of the path {launches}")
    return out


def _cascade_corpus():
    """`benchmarks/bench_cascade.py`'s small corpus: 40 SWDE universities and
    10 laptops."""
    from repro_torch.data.corpus import make_swde_corpus
    full = make_swde_corpus()
    uni = [d for d in sorted(full.docs) if "universities" in d][:40]
    lap = [d for d in sorted(full.docs) if "laptops" in d][:10]
    return full.subset(uni + lap)


def _cascade_query(core):
    return core.Query(tables=["universities"], select=[("universities", "university_name")],
                      where=core.conj(core.Filter("tuition", "<", 42000, table="universities"),
                                      core.Filter("enrollment", ">", 15000,
                                                  table="universities")))


def _small_cfg(cfg):
    """bench_cascade's cheap tier of the target config."""
    return cfg.replace(num_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                       d_ff=48)


def _cascade_session(cfg, params, small, corpus, device, mode, max_new, **engine_kw):
    """A served session on the target alone (mode "target") or a
    `CascadeExtractor` over the target and the small tier in `mode`."""
    from repro_torch import core
    from repro_torch.extract import CascadeExtractor, ServedExtractor
    from repro_torch.index.retriever import TwoLevelRetriever
    from repro_torch.serving import ServingEngine
    kw = {"slots": 4, "max_len": 1024, "prefix_cache": True, "device": device, **engine_kw}
    retriever = TwoLevelRetriever(corpus, device=device)
    engine = ServingEngine(cfg, params, **kw)
    small_engine = None
    if mode == "target":
        extractor = ServedExtractor(corpus, engine, max_new=max_new)
    else:
        small_engine = ServingEngine(*small, **kw)
        extractor = CascadeExtractor(corpus, engine, small_engine, cascade=mode,
                                     difficulty=core.DifficultyEstimator(retriever),
                                     max_new=max_new)
    return core.Session(retriever, extractor, batch_size=4), engine, small_engine, extractor


def phase_cascade(seed: int, main_run) -> dict:
    """bench_cascade's workload on the cut target and its cheap tier:
    target-only, then cascade="verify_all", then cascade="on"."""
    import dataclasses

    import torch
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count

    full_params = main_run[0]
    cfg, params = _cut(get_config("qwen2.5-3b"), full_params)
    scfg = _small_cfg(cfg)
    sparams = init_params(scfg, torch.Generator(device="cuda").manual_seed(seed + 1),
                          device="cuda")
    corpus = _cascade_corpus()
    runs = {}
    for mode in ("target", "verify_all", "on"):
        session, engine, small_engine, extractor = _cascade_session(
            cfg, params, (scfg, sparams), corpus, "cuda", mode, max_new=6)
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = session.execute(_cascade_query(core))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[mode] = {"rows": len(result.rows), "query_wall_s": wall,
                      "launches": _launch_counts(), "ledger": session.ledger.snapshot(),
                      "stats": dataclasses.asdict(extractor.stats),
                      "engine": dict(engine.stats),
                      "small_engine": dict(small_engine.stats) if small_engine else None,
                      "_rows": result.rows}
    rows = {m: r.pop("_rows") for m, r in runs.items()}
    va, on = runs["verify_all"]["stats"], runs["on"]["stats"]
    out = {"phase": "cascade", "model": cfg.name, "layers": cfg.num_layers,
           "small_tier": {"layers": scfg.num_layers, "d_model": scfg.d_model,
                          "heads": scfg.n_heads, "head_dim": scfg.head_dim,
                          "params": param_count(sparams), "seed": seed + 1},
           "docs": len(corpus.docs), "runs": runs,
           "rows_identical": rows["verify_all"] == rows["target"] == rows["on"],
           "routed_small": {m: runs[m]["stats"]["routed_small"] for m in ("verify_all", "on")},
           "escalations": {m: runs[m]["stats"]["escalations"] for m in ("verify_all", "on")},
           "target_tokens_saved": {m: runs[m]["stats"]["target_tokens_saved"]
                                   for m in ("verify_all", "on")}}
    emit(out)
    if not rows["target"] or not out["rows_identical"]:
        raise AssertionError(f"cascade: rows differ across modes or are empty: "
                             f"{ {m: len(r) for m, r in rows.items()} }")
    if not va["routed_small"] or va["escalations"] != va["routed_small"] or \
            va["accepted_small"]:
        raise AssertionError(f"cascade: verify_all did not escalate every small-tier "
                             f"extraction: {va}")
    for m, r in runs.items():
        # SWDE documents hold fewer than 256 segments, so segment searches
        # rank in numpy; K3 runs where the difficulty estimator measures
        # retrieval margins (the cascade modes)
        need = ("K1", "K2") if m == "target" else ("K1", "K2", "K3")
        missing = [k for k in need if r["launches"][k] <= 0]
        if missing or r["launches"]["K4"]:
            raise AssertionError(f"cascade {m}: kernels of the path {r['launches']}")
    return out


def _live_stack(cfg, params, corpus, device, max_new, embedder=None, **engine_kw):
    """A `LiveSession` over a `LiveCorpus` of `corpus`, a `LiveRetriever` and
    a served extractor with document-first escalation."""
    from repro_torch.extract import ServedExtractor
    from repro_torch.index.embedder import HashedEmbedder
    from repro_torch.live import LiveCorpus, LiveRetriever, LiveSession
    from repro_torch.serving import ServingEngine
    live = LiveCorpus(corpus)
    t0 = time.perf_counter()
    retriever = LiveRetriever(live, embedder=embedder or HashedEmbedder(device=device),
                              device=device)
    build_s = time.perf_counter() - t0
    kw = {"slots": 4, "max_len": 1024, "page_size": 16, "chunk_size": 32, "device": device,
          **engine_kw}
    engine = ServingEngine(cfg, params, **kw)
    extractor = ServedExtractor(live, engine, max_new=max_new, doc_prefix_escalation=True)
    session = LiveSession(live, retriever, extractor, batch_size=4)
    return live, retriever, engine, extractor, session, kw, build_s


def _count_escalations(extractor) -> list:
    """Wrap the extractor's `escalate_batch` to count its calls and items."""
    seen = [0, 0]
    run = extractor.escalate_batch

    def counted(items, owners=None):
        seen[0] += 1
        seen[1] += len(items)
        return run(items, owners)
    extractor.escalate_batch = counted
    return seen


def _live_oracle(cfg, params, live, retriever, device, max_new, engine_kw, query):
    """A fresh session over the rebuilt corpus and index: the rows a
    from-scratch build gives at this mutation point."""
    from repro_torch import core
    from repro_torch.extract import ServedExtractor
    from repro_torch.serving import ServingEngine
    snap = live.snapshot()
    engine = ServingEngine(cfg, params, **engine_kw)
    session = core.Session(retriever.rebuild_reference(snap),
                           ServedExtractor(snap, engine, max_new=max_new,
                                           doc_prefix_escalation=True), batch_size=4)
    return session.execute(query), engine


def phase_live(main_run) -> dict:
    """Mutations between two queries on a live legal corpus with the spec
    settings and document-first escalation, against a rebuild."""
    import dataclasses

    import torch
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.live import render_edit

    full_params = main_run[0]
    cfg, params = _cut(get_config("qwen2.5-3b"), full_params)
    full = make_legal_corpus(seed=1)
    ids = sorted(full.docs)[:LIVE_DOCS]
    live, retriever, engine, extractor, session, kw, build_s = _live_stack(
        cfg, params, full.subset(ids), "cuda", 12, **SPEC)
    escalations = _count_escalations(extractor)
    query = _legal_query(core)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = session.execute(query)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    # the document to delete escalates two attributes document-first, so
    # the prefix cache holds pages tagged with it
    gone = ids[1]
    text = live.docs[gone].text[:600]
    extractor.escalate_batch([(gone, "year", [text]), (gone, "charges", [text])])
    alloc, pc = engine.alloc, engine.prefix_cache
    tagged = [e for e in pc._entries.values() if gone in e.doc_ids]
    refs = {}
    for e in tagged:
        for p in list(e.pages) + ([e.tail_page] if e.tail_page is not None else []):
            refs[p] = refs.get(p, 0) + 1
    own = {p for p, n in refs.items() if alloc.refcount[p] == n}
    free_before = alloc.free_pages
    # three one-attribute edits that move rows of the query (year >= 2015
    # and charges > 3): 2019 -> 2012, 3 -> 7 charges, 2016 -> 2011
    emb = retriever.embedder
    emb.reset_counters()
    session.update(ids[0], render_edit(live, ids[0], "year", 2012))
    session.update(ids[2], render_edit(live, ids[2], "charges", 7))
    session.update(ids[3], render_edit(live, ids[3], "year", 2011))
    edited, reembedded = live.stats.edited_bytes, emb.reembedded_bytes
    session.delete(gone)
    freed = alloc.free_pages - free_before
    session.ingest("legal/cases/live-000", full.docs[sorted(full.docs)[LIVE_DOCS]].text,
                   "cases")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second = session.execute(query)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches = _launch_counts()
    oracle, _ = _live_oracle(cfg, params, live, retriever, "cuda", 12, kw, query)
    probe = emb.embed_one("judgment delivered charges indictment")
    (live_ids, live_d), = retriever.doc_index.search(probe, k=10)
    ref = retriever.rebuild_reference()
    (ref_ids, ref_d), = ref.doc_index.search(probe, k=10)
    stats = live.stats
    out = {"phase": "live", "model": cfg.name, "layers": cfg.num_layers,
           "engine_options": SPEC, "docs": LIVE_DOCS, "docs_note":
           f"the first {LIVE_DOCS} of the legal corpus's 100 documents",
           "mutations": {"updates": stats.updates, "deletes": stats.deletes,
                         "ingests": stats.ingests},
           "rows": [len(first.rows), len(second.rows)], "rows_oracle": len(oracle.rows),
           "rows_equal_oracle": sorted(second.rows, key=repr) == sorted(oracle.rows, key=repr),
           "ledger": [_ledger(first), _ledger(second)], "engine": dict(engine.stats),
           "prefix_cache": pc.stats.snapshot(), "live_stats": dict(session.live_stats),
           "invalidation": dataclasses.asdict(session.cascade.stats),
           "escalate_batch": {"calls": escalations[0], "items": escalations[1]},
           "deleted_doc_pages": len(own), "pages_freed_by_delete": freed,
           "updates_edited_bytes": edited, "updates_reembedded_bytes": reembedded,
           "updates_reembedded_over_edited": reembedded / max(edited, 1),
           "edited_bytes": stats.edited_bytes, "reembedded_bytes": emb.reembedded_bytes,
           "reembedded_over_edited": emb.reembedded_bytes / max(stats.edited_bytes, 1),
           "doc_search_ids_equal": live_ids == ref_ids,
           "doc_search_max_dist_diff": max((abs(a - b) for a, b in zip(live_d, ref_d)),
                                           default=0.0),
           "index_build_s": build_s, "query_wall_s": [wall1, wall2],
           "launches": launches}
    emit(out)
    if not second.rows or not out["rows_equal_oracle"]:
        raise AssertionError(f"live: {len(second.rows)} rows after the mutations, the "
                             f"rebuild gives {len(oracle.rows)} different ones")
    if not out["doc_search_ids_equal"]:
        raise AssertionError(f"live: the live doc index ranks {live_ids}, the rebuild "
                             f"{ref_ids}")
    if not own or freed < len(own) or tagged and any(gone in e.doc_ids
                                                     for e in pc._entries.values()):
        raise AssertionError(f"live: the deleted document's {len(own)} prefix pages were "
                             f"not returned ({freed} freed)")
    if escalations[0] <= 0:
        raise AssertionError("live: no escalate_batch ran")
    missing = [k for k in ("K2", "K3", "K4") if launches[k] <= 0]
    if missing or launches["K1"] or launches["K5"]:
        raise AssertionError(f"live: kernels of the path {launches}")
    return out


# ------------------------------------------------------------------ mesh ---
# The mesh phase: the card's machine has one GPU, so a 1x1 NCCL mesh, the
# same code as any (data, model) mesh (every collective is called whatever
# its group's size; on it the slab's sequence is "over model", so its
# decode steps run the sequence-sharded combine over K5s). The shape of
# the sequence-sharded leaf: the slab path's decode launch in PERF.md (4
# rows, 16 heads over 2, D 128, 1,024 positions, bf16), seen as the second
# of two shards of 512 positions by K5s's own row (`_kernel_k5s`).
MESH_SHAPE = (1, 1)
MESH_MODES = {"off": {}, "spec": SPEC}
# The slab layout (K5s where the card alone runs K5; without the prefix
# cache, whose hits decode each unshared suffix token by token: ~8,000
# one-token steps on these documents, each with the mesh's collectives)
# and the draft-model drafter (the target as its own draft, its slab on
# the mesh too), on the first MESH_FEW_DOCS documents; each family's query
# on the mesh runs in its own phase, on that phase's cut weights
# (`_family_mesh`). On 5 documents
# retrieval ranks below K3's 256-row gate (numpy, as on any device), so
# those runs launch no K3; the two modes on FAMILY_DOCS do.
MESH_NEW_MODES = {"slab": SLAB,
                  "draft": {"prefix_cache": True, "spec_decode": "draft", "spec_k": 4}}
MESH_FEW_DOCS = 5
# Every collective costs host time (~30 of them a forward on the mesh), so
# the phase's time follows its forwards: prompts go in 256-token chunks,
# half as many as DEEP_CHUNK's (with those the phase took 19.8-27.5 s on
# one H100 80GB HBM3, against a budget of 25 s).
MESH_CHUNK = 256
MESH_K5 = (4, 1024, 2, 8, 128)
MESH_GRAD = (2048, 11008)


def _mesh_run(cfg, params, corpus, retriever, mesh, engine_kw, chunk=MESH_CHUNK) -> tuple:
    """The query on `corpus` through Session -> ServedExtractor ->
    ServingEngine over a fork of `retriever`, on `mesh` (the rank's device)
    or on the card alone: (what must be identical, wall s, launches). A
    draft-model mode drafts with the target itself."""
    if engine_kw.get("spec_decode") == "draft":
        engine_kw = {**engine_kw, "draft_model": (cfg, params)}
    session, engine, extractor, _ = _served_query(
        cfg, params, corpus, None if mesh is not None else "cuda", max_new=12,
        chunk_size=chunk, retriever=retriever, mesh=mesh, **engine_kw)
    result, wall, launches = _timed_query(session)
    same = {"rows": result.rows, "ledger": _ledger(result), "engine": dict(engine.stats),
            "tokens": {r: q.out for r, q in engine.finished.items()}}
    return same, wall, launches


def _as_card(launches: dict) -> dict:
    """A mesh run's launches as the card alone's: the slab's decode steps
    run K5s on the mesh where the card runs K5."""
    return {**launches, "K5": launches["K5"] + launches["K5s"], "K5s": 0}


@contextlib.contextmanager
def _nccl_mesh(out_dir):
    """A one-rank NCCL process group on a FileStore under `out_dir` (or
    build/), no network, and `make_serving_mesh(MESH_SHAPE)` over it;
    yields (mesh, seconds to set up). The group is destroyed on exit,
    whatever happened."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serving_mesh
    store = Path(out_dir or ROOT / "build") / "mesh_filestore"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")     # one host: loopback bootstrap
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_serving_mesh(MESH_SHAPE)
        yield mesh, time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def _mesh_pairs(cfg, params, corpus, modes: dict, mesh, chunk=MESH_CHUNK) -> dict:
    """Each mode's query on the card alone and on `mesh`: walls, launches,
    the mesh run's rows and engine counters, and whether rows, ledger,
    engine counters and tokens are identical."""
    from repro_torch.index.retriever import TwoLevelRetriever
    retriever = TwoLevelRetriever(corpus, device="cuda")
    out = {"walls": {}, "launches": {}, "identical": {}, "modes": {}}
    for mode, kw in modes.items():
        alone, out["walls"][f"{mode}/card"], out["launches"][f"{mode}/card"] = _mesh_run(
            cfg, params, corpus, retriever, None, kw, chunk)
        on_mesh, out["walls"][f"{mode}/mesh"], out["launches"][f"{mode}/mesh"] = _mesh_run(
            cfg, params, corpus, retriever, mesh, kw, chunk)
        out["identical"][mode] = {k: on_mesh[k] == alone[k] for k in alone}
        out["modes"][mode] = {"rows": len(on_mesh["rows"]), "engine": on_mesh["engine"]}
    return out


def _check_mesh_pairs(phase: str, pairs: dict) -> None:
    """Identical results, rows, and the card alone's launches on the mesh
    (K5s standing for K5, which the mesh runs no time)."""
    bad = {m: v for m, v in pairs["identical"].items() if not all(v.values())}
    if bad:
        raise AssertionError(f"{phase}: the mesh engine differs from the card alone: {bad}")
    if not all(m["rows"] for m in pairs["modes"].values()):
        raise AssertionError(f"{phase}: a mesh query returned no rows")
    for mode in pairs["modes"]:
        card, mesh = pairs["launches"][f"{mode}/card"], pairs["launches"][f"{mode}/mesh"]
        if _as_card(mesh) != card or card["K5s"]:
            raise AssertionError(f"{phase}: {mode} launches on the mesh {mesh}, on the "
                                 f"card alone {card}")


def _family_mesh(phase: str, cfg, params) -> dict:
    """A family's query on its phase's cut weights, on a 1x1 NCCL mesh and
    on the card alone (the served settings, DEEP_CHUNK chunks, the first
    FAMILY_MESH_DOCS documents): identical rows, ledger, engine counters,
    tokens and launches. Emitted as its own line."""
    from repro_torch.data.corpus import make_legal_corpus
    full = make_legal_corpus(seed=1)
    corpus = full.subset(sorted(full.docs)[:FAMILY_MESH_DOCS])
    t0 = time.perf_counter()
    with _nccl_mesh(None) as (mesh, init_s):
        pairs = _mesh_pairs(cfg, params, corpus, {"spec": SPEC}, mesh, DEEP_CHUNK)
    out = {"phase": f"{phase}_mesh", "mesh": list(MESH_SHAPE), "backend": "nccl",
           "model": cfg.name, "layers": cfg.num_layers, "docs": len(corpus.docs),
           "engine_options": {**SPEC, "chunk_size": DEEP_CHUNK},
           "process_group_and_mesh_s": init_s, "seconds": time.perf_counter() - t0,
           "query_wall_s": pairs["walls"], "launches": pairs["launches"],
           "identical_to_the_card_alone": pairs["identical"], "modes": pairs["modes"]}
    emit(out)
    _check_mesh_pairs(f"{phase}_mesh", pairs)
    return out


def phase_mesh(seed: int, main_run, out_dir) -> dict:
    """The served query on a 1x1 NCCL mesh: a one-rank process group
    (a FileStore under --out, no network), `make_serving_mesh((1, 1))`,
    and the query on main's cut qwen2.5-3b weights in four modes, each on
    the mesh and on the card alone, whose rows, ledger, engine counters,
    tokens and launches must be identical: on the first FAMILY_DOCS legal
    documents off (K1, K2, K3) and prompt lookup with the prefix cache
    (K2, K3, K4); on the first MESH_FEW_DOCS the slab layout (K2, and
    K5s on the mesh where the card alone runs K5) and the draft-model
    drafter with the prefix cache (K2, K4, and K5s for K5). Then
    `make_seq_sharded_decode_attn` (its leaf K5s) against K5
    (`decode_attention`) at MESH_K5 in bf16 within TOL, and
    `compressed_pod_mean` on a one-rank pod group against _dq8(_q8(g)).
    The process group is destroyed at the end, whatever happened."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.distributed.compression import compressed_pod_mean, make_pod_grad_sync
    from repro_torch.distributed.decode import make_seq_sharded_decode_attn
    from repro_torch.kernels import decode_attention as k15
    from repro_torch.training.optim import _dq8, _q8

    cfg, params = _cut(get_config("qwen2.5-3b"), main_run[0])
    full = make_legal_corpus(seed=1)
    docs = sorted(full.docs)
    corpus = full.subset(docs[:FAMILY_DOCS])
    few = full.subset(docs[:MESH_FEW_DOCS])
    with _nccl_mesh(out_dir) as (mesh, init_s):
        pairs = _mesh_pairs(cfg, params, corpus, MESH_MODES, mesh)
        new = _mesh_pairs(cfg, params, few, MESH_NEW_MODES, mesh)
        for key in pairs:
            pairs[key].update(new[key])
        walls, launches, identical, modes = (pairs[k] for k in ("walls", "launches",
                                                                 "identical", "modes"))

        g = torch.Generator(device="cuda").manual_seed(seed + 7)
        B, S, hkv, G, hd = MESH_K5
        q = torch.randn((B, 1, hkv, G, hd), generator=g, device="cuda").bfloat16()
        kc = torch.randn((B, S, hkv, hd), generator=g, device="cuda").bfloat16()
        vc = torch.randn((B, S, hkv, hd), generator=g, device="cuda").bfloat16()
        lens = torch.tensor([S, S // 2 + 5, 33, 1], dtype=torch.int32, device="cuda")
        seq = make_seq_sharded_decode_attn(mesh)(q, kc, vc, lens).reshape(B, hkv * G, hd)
        decode_err = max_err(seq, k15.decode_attention(q.reshape(B, hkv * G, hd), kc, vc,
                                                       lens))
        pmesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
        grad = torch.randn(MESH_GRAD, generator=g, device="cuda")
        mean, _ = compressed_pod_mean({"w": grad}, pmesh.get_group("pod"))
        synced = make_pod_grad_sync(pmesh)({"w": grad})
        want = _dq8(*_q8(grad, 256), 256)
        compress_err = max(max_err(mean["w"], want), max_err(synced["w"], want))
        torch.cuda.synchronize()
    out = {"phase": "mesh", "mesh": list(MESH_SHAPE), "backend": "nccl", "ranks": 1,
           "model": cfg.name, "layers": cfg.num_layers,
           "docs": {**{m: len(corpus.docs) for m in MESH_MODES},
                    **{m: len(few.docs) for m in MESH_NEW_MODES}},
           "engine_options": {m: {**kw, "chunk_size": MESH_CHUNK}
                              for m, kw in {**MESH_MODES, **MESH_NEW_MODES}.items()},
           "process_group_and_mesh_s": init_s, "query_wall_s": walls,
           "launches": {m: {k: n[k] for k in ("K1", "K2", "K3", "K4", "K5", "K5s")}
                        for m, n in launches.items()},
           "identical_to_the_card_alone": identical, "modes": modes,
           "seq_sharded_decode_vs_k5": {"shape": list(MESH_K5), "dtype": "bfloat16",
                                        "max_abs_err": decode_err, "tol": TOL["bfloat16"]},
           "compressed_pod_mean_vs_q8": {"shape": list(MESH_GRAD), "max_abs_err": compress_err}}
    emit(out)
    _check_mesh_pairs("mesh", pairs)
    missing = [k for k in ("K1", "K2", "K3") if launches["off/mesh"][k] <= 0] + \
        [f"spec {k}" for k in ("K2", "K3", "K4") if launches["spec/mesh"][k] <= 0] + \
        [f"slab {k}" for k in ("K2", "K5s") if launches["slab/mesh"][k] <= 0] + \
        [f"draft {k}" for k in ("K2", "K4", "K5s") if launches["draft/mesh"][k] <= 0]
    if missing or launches["spec/mesh"]["K1"] or launches["slab/mesh"]["K5"] or \
            launches["draft/mesh"]["K5"]:
        raise AssertionError(f"mesh: kernels of the path {launches}")
    if modes["spec"]["engine"]["prefix_hits"] <= 0 or modes["spec"]["engine"]["spec_rounds"] <= 0 \
            or modes["draft"]["engine"]["spec_rounds"] <= 0:
        raise AssertionError("mesh: a mode had no prefix hit or no verify round")
    if decode_err > TOL["bfloat16"] or compress_err != 0.0:
        raise AssertionError(f"mesh: sequence-sharded decode {decode_err} against K5, "
                             f"compressed pod mean {compress_err} against _dq8(_q8(g))")
    return out


def phase_ssm(seed: int, captures: dict, main_result) -> tuple:
    """The main query on falcon-mamba-7b at full width, its first
    SSM_LAYERS layers, with the served settings (prefix cache, prompt
    lookup) and 128-token chunks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import ssm_scan as k7
    from repro_torch.models import init_params, param_count

    full_cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full_params = init_params(full_cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, params = _cut(full_cfg, full_params, SSM_LAYERS)
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, chunk_size=DEEP_CHUNK, **SPEC)
    # K7's inputs on two kinds of launch: the first full prompt chunk (B = 1,
    # S = DEEP_CHUNK, from a carried state) and the first verify round of all
    # four slots (B = 4, S = spec_k + 1, per-position states written)
    captures["K7_verify"] = Capture(
        k7, "ssm_scan", lambda x, dt, A, Bm, Cm, D, h0=None, states=None:
        1 if states is not None and x.shape[0] == 4 else -1)
    captures["K7"] = Capture(
        k7, "ssm_scan", lambda x, dt, A, Bm, Cm, D, h0=None, states=None:
        x.shape[1] if states is None and h0 is not None else -1)
    result, wall, launches = _timed_query(session)
    captures["K7"].restore()
    captures["K7_verify"].restore()
    if captures["K7"].args is None or captures["K7_verify"].args is None:
        raise AssertionError("ssm: K7 captured no prefill chunk or no verify launch")
    st = engine.stats
    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "ssm", "model": cfg.name, "layers": cfg.num_layers,
           "layers_published": full_cfg.num_layers,
           "d_model": cfg.d_model, "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
           "dtype": cfg.dtype, "params": param_count(params),
           "params_published": param_count(full_params),
           "engine_options": {**SPEC, "chunk_size": DEEP_CHUNK},
           "rows": len(result.rows), "rows_main": len(main_result.rows),
           "rows_equal_main": result.rows == main_result.rows, "ledger": _ledger(result),
           "engine": dict(st), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "weights_init_s": init_s,
           "index_build_s": build_s, "query_wall_s": wall,
           "generated_tokens_per_s": gen_tokens / wall,
           "verify_rounds": st["spec_rounds"], "drafted": st["draft_tokens"],
           "accepted": st["accepted_tokens"], "prefix_hits": st["prefix_hits"],
           "kv_bytes_peak": st["kv_bytes_peak"], "launches": launches}
    emit(out)
    if not result.rows or result.rows != main_result.rows:
        raise AssertionError(f"ssm: {len(result.rows)} rows, not the main phase's "
                             f"{len(main_result.rows)}")
    if result.ledger.input_tokens != main_result.ledger.input_tokens:
        raise AssertionError(f"ssm: ledger input_tokens {result.ledger.input_tokens} != "
                             f"main's {main_result.ledger.input_tokens}")
    stray = {k: launches[k] for k in ("K1", "K2", "K4", "K5", "K6") if launches[k]}
    if stray or not launches["K3"]:
        raise AssertionError(f"ssm: attention or gating kernels launched or K3 did not: "
                             f"{launches}")
    forwards = st["prefill_chunks"] + st["spec_rounds"]
    if launches["K7"] != cfg.num_layers * forwards or not st["spec_rounds"]:
        raise AssertionError(f"ssm: K7 launched {launches['K7']} times for {forwards} "
                             f"chunk and verify forwards of {cfg.num_layers} layers")
    if st["prefix_hits"] <= 0:
        raise AssertionError("ssm: no prefix hit")
    out["mesh"] = _family_mesh("ssm", cfg, params)
    return out, (session, extractor)


def phase_moe(seed: int, captures: dict, main_result) -> tuple:
    """The main query on deepseek-v2-lite-16b (MLA + MoE) at full width,
    its first MOE_LAYERS layers, with the served settings (prefix cache,
    prompt lookup) and 128-token chunks: every forward gates each of its
    MoE layers through K6, and MLA attends the compressed pool in plain
    PyTorch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.models import init_params, param_count

    full_cfg = get_config("deepseek-v2-lite-16b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full_params = init_params(full_cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, params = _cut(full_cfg, full_params, MOE_LAYERS)
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, chunk_size=DEEP_CHUNK, **SPEC)
    # K6's inputs on two kinds of launch: the first prompt chunk (T =
    # DEEP_CHUNK tokens) and the first verify round of all four slots (T =
    # 4 x (spec_k + 1))
    verify_T = 4 * (SPEC["spec_k"] + 1)
    captures["K6_verify"] = Capture(k6, "moe_gating",
                                    lambda lg, k, C=None, G=1: 1 if lg.shape[0] == verify_T else -1)
    captures["K6"] = Capture(k6, "moe_gating",
                             lambda lg, k, C=None, G=1: 1 if lg.shape[0] == DEEP_CHUNK else -1)
    result, wall, launches = _timed_query(session)
    captures["K6"].restore()
    captures["K6_verify"].restore()
    if captures["K6"].args is None or captures["K6_verify"].args is None:
        raise AssertionError("moe: K6 captured no prefill chunk or no verify launch")
    st = engine.stats
    gen_tokens = extractor.stats.generated_tokens
    n_moe = len(params["layers"])
    out = {"phase": "moe", "model": cfg.name, "layers": cfg.num_layers, "moe_layers": n_moe,
           "layers_published": full_cfg.num_layers,
           "d_model": cfg.d_model, "experts": cfg.n_experts, "top_k": cfg.moe_top_k,
           "kv_lora_rank": cfg.kv_lora_rank, "dtype": cfg.dtype,
           "params": param_count(params), "params_published": param_count(full_params),
           "engine_options": {**SPEC, "chunk_size": DEEP_CHUNK},
           "rows": len(result.rows), "rows_main": len(main_result.rows),
           "rows_equal_main": result.rows == main_result.rows, "ledger": _ledger(result),
           "engine": dict(st), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "weights_init_s": init_s,
           "index_build_s": build_s, "query_wall_s": wall,
           "generated_tokens_per_s": gen_tokens / wall,
           "verify_rounds": st["spec_rounds"], "drafted": st["draft_tokens"],
           "accepted": st["accepted_tokens"], "prefix_hits": st["prefix_hits"],
           "kv_bytes_peak": st["kv_bytes_peak"], "launches": launches}
    emit(out)
    if out["params_published"] != 15_706_484_224:
        raise AssertionError(f"moe: {out['params_published']} parameters, not "
                             f"deepseek-v2-lite-16b's")
    if not result.rows or result.rows != main_result.rows:
        raise AssertionError(f"moe: {len(result.rows)} rows, not the main phase's "
                             f"{len(main_result.rows)}")
    if result.ledger.input_tokens != main_result.ledger.input_tokens:
        raise AssertionError(f"moe: ledger input_tokens {result.ledger.input_tokens} != "
                             f"main's {main_result.ledger.input_tokens}")
    stray = {k: launches[k] for k in ("K1", "K2", "K4", "K5", "K7") if launches[k]}
    if stray or not launches["K3"]:
        raise AssertionError(f"moe: attention or scan kernels launched or K3 did not: "
                             f"{launches}")
    forwards = st["prefill_chunks"] + st["spec_rounds"]
    if launches["K6"] != n_moe * forwards or not st["spec_rounds"]:
        raise AssertionError(f"moe: K6 launched {launches['K6']} times for {forwards} "
                             f"chunk and verify forwards of {n_moe} MoE layers")
    if st["prefix_hits"] <= 0:
        raise AssertionError("moe: no prefix hit")
    out["mesh"] = _family_mesh("moe", cfg, params)
    return out, (session, extractor)


def phase_vlm(seed: int, captures: dict) -> tuple:
    """The query on the first VLM_DOCS legal documents on
    llava-next-mistral-7b at full width and depth with the served settings
    (prefix cache, prompt lookup), 128-token chunks and VLM_MAX_LEN: every
    prompt's first chunk carries the 2,880 projected image rows; the
    decoder's attention runs K2 and K4 on the pool. Rows and ledger input
    tokens must equal SMOKE qwen2.5-3b's on the same documents."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import verify_attention as k4
    from repro_torch.models import init_params, param_count

    cfg = get_config("llava-next-mistral-7b")
    n_img = cfg.n_image_tokens
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    full = make_legal_corpus(seed=1)
    corpus = full.subset(sorted(full.docs)[:VLM_DOCS])
    want = _smoke_result(seed, corpus, "cuda")
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, chunk_size=DEEP_CHUNK,
        max_len=VLM_MAX_LEN, **SPEC)
    # K2 at a first chunk (the image rows and DEEP_CHUNK text positions
    # from position 0), K4 at its widest verify round (starts past the
    # image prefix); neither size reads the card
    captures["K2_vlm"] = Capture(
        k2, "chunk_prefill_attention",
        lambda q, kp, vp, ctx, start: 1 if start == 0 and q.shape[0] == DEEP_CHUNK + n_img
        else -1)
    captures["K4_vlm"] = Capture(k4, "paged_verify_attention",
                                 lambda q, kp, vp, tbl, starts: tbl.shape[1] * q.shape[0])
    result, wall, launches = _timed_query(session)
    captures["K2_vlm"].restore()
    captures["K4_vlm"].restore()
    if captures["K2_vlm"].args is None or captures["K4_vlm"].args is None:
        raise AssertionError("vlm: K2 captured no first chunk or K4 no verify round")
    k4_starts = captures["K4_vlm"].args[4]
    st = engine.stats
    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "vlm", "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "image_tokens": n_img, "dtype": cfg.dtype, "params": param_count(params),
           "engine_options": {**SPEC, "chunk_size": DEEP_CHUNK, "max_len": VLM_MAX_LEN},
           "docs": len(corpus.docs), "rows": len(result.rows),
           "rows_smoke_qwen2.5-3b": len(want.rows), "rows_equal_smoke": result.rows == want.rows,
           "ledger": _ledger(result),
           "engine": dict(st), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "weights_init_s": init_s,
           "index_build_s": build_s, "query_wall_s": wall,
           "generated_tokens_per_s": gen_tokens / wall,
           "verify_rounds": st["spec_rounds"], "drafted": st["draft_tokens"],
           "accepted": st["accepted_tokens"], "prefix_hits": st["prefix_hits"],
           "kv_bytes_peak": st["kv_bytes_peak"], "launches": launches,
           "k2_image_chunk": list(captures["K2_vlm"].args[0].shape),
           "k4_captured_starts": k4_starts.tolist()}
    emit(out)
    if not result.rows or result.rows != want.rows:
        raise AssertionError(f"vlm: {len(result.rows)} rows, not SMOKE qwen2.5-3b's "
                             f"{len(want.rows)}")
    if result.ledger.input_tokens != want.ledger.input_tokens:
        raise AssertionError(f"vlm: ledger input_tokens {result.ledger.input_tokens} != "
                             f"SMOKE qwen2.5-3b's {want.ledger.input_tokens}")
    stray = {k: launches[k] for k in ("K1", "K5", "K6", "K7") if launches[k]}
    if stray or not all(launches[k] for k in ("K2", "K3", "K4")):
        raise AssertionError(f"vlm: K1/K5/K6/K7 launched or K2/K3/K4 did not: {launches}")
    if int(k4_starts.max()) <= n_img:
        raise AssertionError(f"vlm: the captured verify round starts at {k4_starts.tolist()}, "
                             f"not past the {n_img} image positions")
    if st["prefix_hits"] <= 0 or st["spec_rounds"] <= 0:
        raise AssertionError("vlm: no prefix hit or no verify round")
    return out, (session, extractor)


def _family_phase(phase: str, arch: str, n_layers: int, seed: int, captures: dict) -> tuple:
    """The query on the first FAMILY_DOCS legal documents on `arch` at its
    published width, its first n_layers layers (only the cut is drawn, the
    published count comes from the meta device), with the ssm
    phase's settings. Captures K2 at the widest chunk (C = DEEP_CHUNK, the
    latest start), K4 at the widest verify round and, for MoE, K6 at a
    chunk (T = DEEP_CHUNK) and at a verify round of all four slots; for the
    encdec family K2's non-causal form at the encoder (encoder_seq over
    encoder_seq), at a chunk's cross-attention (C = DEEP_CHUNK) and at a
    verify round's of all four slots, and, for K5 at a decode step's
    cross-attention, the four slots' cross K/V of the first decoder layer
    with a seeded query. Rows and ledger input tokens must equal SMOKE
    qwen2.5-3b's on the same documents; every forward of the path must
    have launched its kernels: the encdec family's encoder once (the
    engine encodes the frames once) and its cross-attention every decoder
    layer of every forward (K2's non-causal form in chunks and verify
    rounds, K5 in decode steps)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.kernels import verify_attention as k4
    from repro_torch.models import init_params, param_count
    from repro_torch.models.cache_ops import cache_nbytes
    from repro_torch.models.model import n_applications

    full_cfg = get_config(arch)
    cfg = full_cfg.replace(num_layers=n_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    full = make_legal_corpus(seed=1)
    corpus = full.subset(sorted(full.docs)[:FAMILY_DOCS])
    want = _smoke_result(seed, corpus, "cuda")
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, chunk_size=DEEP_CHUNK, **SPEC)
    H = cfg.n_heads
    verify_T = 4 * (SPEC["spec_k"] + 1)
    # in the order they wrap, so that reversed they unwrap
    encdec = cfg.family == "encdec"
    tags = [f"K2_{phase}", f"K4_{phase}"] + ([f"K6_{phase}_verify", f"K6_{phase}"]
                                              if cfg.n_experts else []) + \
        ([f"K2nc_{phase}_{w}" for w in ("encoder", "chunk", "verify")] if encdec else [])
    captures[f"K2_{phase}"] = Capture(
        k2, "chunk_prefill_attention",
        lambda q, kp, vp, ctx, start: start if q.shape[:2] == (DEEP_CHUNK, H) else -1)
    captures[f"K4_{phase}"] = Capture(
        k4, "paged_verify_attention",
        lambda q, kp, vp, tbl, starts: tbl.shape[1] * q.shape[0] if q.shape[1] == H else -1)
    if cfg.n_experts:
        captures[f"K6_{phase}_verify"] = Capture(
            k6, "moe_gating", lambda lg, k, C=None, G=1: 1 if lg.shape[0] == verify_T else -1)
        captures[f"K6_{phase}"] = Capture(
            k6, "moe_gating", lambda lg, k, C=None, G=1: 1 if lg.shape[0] == DEEP_CHUNK else -1)
    if encdec:
        shapes = {"encoder": (1, cfg.encoder_seq), "chunk": (1, DEEP_CHUNK),
                  "verify": (4, SPEC["spec_k"] + 1)}
        for w, shape in shapes.items():
            captures[f"K2nc_{phase}_{w}"] = Capture(
                k2, "bidirectional_attention",
                lambda q, k, v, n, shape=shape: 1 if q.shape[:2] == shape else -1)
    result, wall, launches = _timed_query(session)
    for tag in reversed(tags):
        captures[tag].restore()
    missing = [t for t in tags if captures[t].args is None]
    if missing:
        raise AssertionError(f"{phase}: nothing captured for {missing}")
    st = engine.stats
    gen_tokens = extractor.stats.generated_tokens
    attn_layers = n_applications(cfg) if cfg.family == "hybrid" else cfg.num_layers
    extra = {}
    if encdec:
        # K5 as a decode step's cross-attention runs it: every slot's cross
        # K/V of the first decoder layer, at length encoder_seq
        ck, cv = engine.cache["ck"][0].clone(), engine.cache["cv"][0].clone()
        q = torch.randn((ck.shape[0], H, cfg.resolved_head_dim), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed + 5))
        captures[f"K5_{phase}_cross"] = SimpleNamespace(
            args=(q.to(ck.dtype), ck, cv, torch.full((ck.shape[0],), cfg.encoder_seq,
                                                     dtype=torch.int32, device="cuda")))
        extra = {"encoder_layers": cfg.n_encoder_layers, "encoder_seq": cfg.encoder_seq,
                 "cross_kv_bytes_per_slot": ck[0].numel() * ck.element_size() * 2 *
                 cfg.num_layers,
                 "cross_kv_bytes_all_slots": cache_nbytes(
                     {k: engine.cache[k] for k in ("ck", "cv")})}
    out = {"phase": phase, "model": cfg.name, "layers": cfg.num_layers,
           "layers_published": full_cfg.num_layers, "attention_layers": attn_layers,
           "d_model": cfg.d_model, "heads": H, "kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.resolved_head_dim, "experts": cfg.n_experts,
           "top_k": cfg.moe_top_k, "dtype": cfg.dtype, "params": param_count(params),
           "params_published": param_count(init_params(full_cfg, device="meta")),
           "engine_options": {**SPEC, "chunk_size": DEEP_CHUNK}, "docs": len(corpus.docs),
           "rows": len(result.rows), "rows_smoke_qwen2.5-3b": len(want.rows),
           "rows_equal_smoke": result.rows == want.rows, "ledger": _ledger(result),
           "engine": dict(st), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "weights_init_s": init_s,
           "index_build_s": build_s, "query_wall_s": wall,
           "generated_tokens_per_s": gen_tokens / wall,
           "verify_rounds": st["spec_rounds"], "drafted": st["draft_tokens"],
           "accepted": st["accepted_tokens"], "prefix_hits": st["prefix_hits"],
           "kv_bytes_peak": st["kv_bytes_peak"], "launches": launches, **extra}
    emit(out)
    if not result.rows or result.rows != want.rows or \
            result.ledger.input_tokens != want.ledger.input_tokens:
        raise AssertionError(f"{phase}: {len(result.rows)} rows and "
                             f"{result.ledger.input_tokens} input tokens, not SMOKE "
                             f"qwen2.5-3b's {len(want.rows)} and {want.ledger.input_tokens}")
    chunks, rounds = st["prefill_chunks"], st["spec_rounds"]
    if st["prefix_hits"] <= 0 or rounds <= 0:
        raise AssertionError(f"{phase}: no prefix hit or no verify round")
    if launches["K2"] != attn_layers * chunks or launches["K4"] != attn_layers * rounds or \
            not launches["K3"]:
        raise AssertionError(f"{phase}: K2 {launches['K2']} and K4 {launches['K4']} for "
                             f"{chunks} chunks and {rounds} verify rounds of {attn_layers} "
                             f"attention layers, K3 {launches['K3']}")
    moe_layers = len(params["layers"]) if cfg.n_experts else 0
    if launches["K6"] != moe_layers * (chunks + rounds):
        raise AssertionError(f"{phase}: K6 launched {launches['K6']} times for "
                             f"{chunks + rounds} forwards of {moe_layers} MoE layers")
    steps = st["decode_steps"] - rounds             # decode steps that are not rounds
    want_nc = cfg.n_encoder_layers + cfg.num_layers * (chunks + rounds) if encdec else 0
    want_k5 = cfg.num_layers * steps if encdec else 0
    if launches["K2nc"] != want_nc or launches["K5"] != want_k5:
        raise AssertionError(f"{phase}: K2's non-causal form launched {launches['K2nc']} "
                             f"times (want {want_nc}: the encoder once, then every layer's "
                             f"cross-attention in {chunks} chunks and {rounds} verify "
                             f"rounds), K5 {launches['K5']} (want {want_k5})")
    if launches["K2nc_sm90"] != (cfg.n_encoder_layers if encdec else 0):
        raise AssertionError(f"{phase}: K2's non-causal form launched its Hopper kernel "
                             f"{launches['K2nc_sm90']} times (want the encoder's "
                             f"{cfg.n_encoder_layers if encdec else 0}; every cross-"
                             f"attention launch on the core)")
    stray = {k: launches[k] for k in ("K1", "K7") if launches[k]}
    if stray:
        raise AssertionError(f"{phase}: K1 or K7 launched: {launches}")
    out["mesh"] = _family_mesh(phase, cfg, params)
    return out, (session, extractor)


def phase_grok(seed: int, captures: dict) -> tuple:
    """grok-1-314b (MoE with standard GQA attention: 48 heads over 8, D
    128, 8 experts of d_ff 32,768, top 2) at its published width, its
    first GROK_LAYERS of 64 layers: K2, K3, K4 on the pool, K6 every MoE
    layer, the sink page written as the JAX engine writes it."""
    return _family_phase("grok", "grok-1-314b", GROK_LAYERS, seed, captures)


def phase_whisper(seed: int, captures: dict) -> tuple:
    """whisper-medium (the encoder-decoder family: 24 LayerNorm encoder
    layers over the stub frontend's 1,500 zero frames, 24 decoder layers
    with learned positions and cross-attention, 16 heads over 16 at D 64)
    at its published width and all its layers: K2, K3 and K4 on the pool,
    K2's non-causal form for the encoder once and for each decoder layer's
    cross-attention in every chunk and verify round."""
    return _family_phase("whisper", "whisper-medium", 24, seed, captures)


def phase_hybrid(seed: int, captures: dict) -> tuple:
    """zamba2-2.7b at its published width, its first HYBRID_LAYERS of 54
    Mamba2 layers (plain PyTorch) with their shared-block applications (32
    heads over 32 at D 80, a LoRA adapter each): K2, K3, K4 on the pool at
    head width 80."""
    return _family_phase("hybrid", "zamba2-2.7b", HYBRID_LAYERS, seed, captures)


_SMOKE_RESULTS: dict = {}


def _smoke_result(seed: int, corpus, device):
    """The query's result on SMOKE qwen2.5-3b (float32, weights from --seed
    on the CPU), speculation and the prefix cache off: its rows and ledger
    input tokens are what any model's are on `corpus` (answers that do not
    parse fall back to the corpus oracle, ServedExtractor)."""
    import torch
    from repro_torch import core
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_data
    from repro_torch.models import init_params
    key = (seed, tuple(sorted(corpus.docs)), device)
    if key not in _SMOKE_RESULTS:
        cfg = get_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB)
        params = _to(init_params(cfg, torch.Generator().manual_seed(seed), device="cpu"),
                     device)
        session, _, _, _ = _served_query(cfg, params, corpus, device, max_new=12)
        _SMOKE_RESULTS[key] = session.prepare(_legal_query(core)).submit().result()
    return _SMOKE_RESULTS[key]


def phase_dense_family(seed: int) -> dict:
    """The query on qwen3-32b, nemotron-4-15b and deepseek-67b at their
    published widths, each cut to its first DENSE_LAYERS layers, with the
    served settings, on the first 20 legal documents; then on DENSE_MLA,
    derived from deepseek-v2-lite-16b at its widths, and that model's query
    on a 1x1 mesh."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.models import init_params, param_count

    full = make_legal_corpus(seed=1)
    corpus = full.subset(sorted(full.docs)[:20])
    want = _smoke_result(seed, corpus, "cuda")
    out = {"phase": "dense_family", "docs": len(corpus.docs), "layers": DENSE_LAYERS,
           "engine_options": SPEC, "rows_smoke_qwen2.5-3b": len(want.rows), "models": {}}
    for arch in DENSE_FAMILY + (DENSE_MLA,):
        full_cfg = _dense_mla_config(get_config) if arch == DENSE_MLA else get_config(arch)
        cfg = full_cfg.replace(num_layers=DENSE_LAYERS)
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_params(cfg, gen, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        session, engine, extractor, build_s = _served_query(
            cfg, params, corpus, "cuda", max_new=12, **SPEC)
        result, wall, launches = _timed_query(session)
        st = engine.stats
        gen_tokens = extractor.stats.generated_tokens
        row = {"layers_published": full_cfg.num_layers, "d_model": cfg.d_model,
               "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
               "qk_norm": cfg.qk_norm, "gated_mlp": cfg.gated_mlp,
               "activation": cfg.activation, "dtype": cfg.dtype,
               "params": param_count(params),
               "params_published": param_count(init_params(full_cfg, device="meta")),
               "rows": len(result.rows), "rows_equal_smoke": result.rows == want.rows,
               "ledger": _ledger(result), "engine": dict(st),
               "served_requests": extractor.stats.requests,
               "generated_tokens": gen_tokens, "weights_init_s": init_s,
               "index_build_s": build_s, "query_wall_s": wall,
               "generated_tokens_per_s": gen_tokens / wall, "launches": launches,
               "seconds": time.perf_counter() - t0}
        if arch == DENSE_MLA:
            row.update(derived="deepseek-v2-lite-16b's first-layer block as a dense model, "
                               "not a published model",
                       mla={"kv_lora_rank": cfg.kv_lora_rank, "qk_rope_dim": cfg.qk_rope_dim,
                            "qk_nope_dim": cfg.qk_nope_dim, "v_head_dim": cfg.v_head_dim},
                       vocab=cfg.vocab_size)
        out["models"][arch] = row
        emit({"phase": "dense_family", "model": arch, **row})
        if not result.rows or result.rows != want.rows or \
                result.ledger.input_tokens != want.ledger.input_tokens:
            raise AssertionError(f"{arch}: {len(result.rows)} rows and "
                                 f"{result.ledger.input_tokens} input tokens, not SMOKE "
                                 f"qwen2.5-3b's {len(want.rows)} and "
                                 f"{want.ledger.input_tokens}")
        if arch == DENSE_MLA:
            # MLA attends its latent pools in plain PyTorch: retrieval's K3 alone
            if launches["K3"] <= 0 or any(n for k, n in launches.items() if k != "K3"):
                raise AssertionError(f"{arch}: K3 did not launch or another kernel did: "
                                     f"{launches}")
        elif launches["K1"] or not all(launches[k] for k in ("K2", "K3", "K4")):
            raise AssertionError(f"{arch}: K1 launched or K2/K3/K4 did not: {launches}")
        if st["prefix_hits"] <= 0 or st["spec_rounds"] <= 0:
            raise AssertionError(f"{arch}: no prefix hit or no verify round")
        del session, engine, extractor
        if arch == DENSE_MLA:
            out["kv_bytes_peak"] = {a: out["models"][a]["engine"]["kv_bytes_peak"]
                                    for a in ("qwen3-32b", DENSE_MLA)}
            emit({"phase": "dense_family", "kv_bytes_peak": out["kv_bytes_peak"]})
            out["mesh"] = _family_mesh("dense_family", cfg, params)
        del params
        torch.cuda.empty_cache()
    return out


class _Spans:
    """Name the MoE path's two plain-PyTorch hot spots for the profiler,
    while the block is open: "mla_attention" (gathering each row's page
    view, the absorbed scores, softmax and context, writing the blocks
    back: what a paged MLA kernel would replace) and "moe_expert_bmm" (the
    experts' three batched products; `torch.bmm` has no other caller on
    the path)."""
    NAMES = ("mla_attention", "moe_expert_bmm")

    def __enter__(self):
        import torch
        from repro_torch.models import layers

        def named(fn, name):
            def run(*a, **kw):
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            return run
        self.saved = [(layers, n, getattr(layers, n))
                      for n in ("page_view", "_mla_attend", "_write_latent")]
        self.saved.append((torch, "bmm", torch.bmm))
        for mod, n, fn in self.saved:
            setattr(mod, n, named(fn, "moe_expert_bmm" if n == "bmm" else "mla_attention"))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)


def phase_profile(session, extractor, out_dir, path: str) -> dict:
    """torch.profiler over one extraction round of a path's served model
    (4 legal documents, attribute `year`): wall time, the device's busy
    share, and device time by kernel group; on the ssm and moe paths the
    round's forwards (prefill chunks + verify rounds) and device kernels a
    forward; on the moe path also the device time of MLA attention and of
    the expert products (`_Spans`)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    retriever = session.retriever
    docs = sorted(retriever.corpus.docs)[:4]
    items = [(d, "year", retriever.segments(d, "year", "cases")) for d in docs]
    extractor.extract_batch(items)                 # warm-up round
    torch.cuda.synchronize()
    st = extractor.engine.stats
    fwd0 = st["prefill_chunks"] + st["spec_rounds"]
    spans = _Spans() if path == "moe" else contextlib.nullcontext()
    with spans, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extractor.extract_batch(items)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    forwards = st["prefill_chunks"] + st["spec_rounds"] - fwd0
    events = prof.key_averages()                   # aggregated once: it is slow
    by_group, count_by_group, launches, by_span = _device_groups(events)
    busy = sum(by_group.values())
    out = {"phase": "profile", "path": path, "requests": len(items),
           "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
           "device_kernels": launches,
           "device_ms_by_group": {g: t / 1e3 for g, t in by_group.items()},
           "device_launches_by_group": count_by_group}
    if path == "moe":
        out["device_ms_by_span"] = {n: by_span.get(n, 0.0) / 1e3 for n in _Spans.NAMES}
    if path in ("ssm", "moe", "hybrid"):           # every forward a chunk or a verify round
        out["forwards"] = forwards
        out["device_kernels_per_forward"] = launches / forwards if forwards else None
    emit(out)
    _profile_table(events, out_dir, path)
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return out


def _profile_table(events, out_dir, path: str) -> None:
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        key = "self_device_time_total" if events and \
            hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
        (Path(out_dir) / f"profile_table_{path}.txt").write_text(
            events.table(sort_by=key, row_limit=40))


def _device_groups(events) -> tuple:
    """Device time (us) and launches of a profile's kernels by group (each
    path kernel, gemm, other), the device kernels launched, and the
    `_Spans`' extents."""
    from torch.autograd import DeviceType
    # each attention kernel's span and merge launches (the merge kernel is
    # shared; its tag names the caller)
    groups = {"K1 paged_decode": ("PagedDecode",),
              "K2 chunk_prefill": ("ChunkPrefill",),
              "K3 topk_l2": ("topk_l2_",),
              "K4 paged_verify": ("PagedVerify",),
              "K5 dense_decode": ("DenseDecode",),
              "K6 moe_gating": ("moe_gating_kernel",),
              "K2nc bidirectional": ("Bidirectional",
                                     "bidirectional_attention_sm90"),
              "K7 ssm_scan": ("ssm_scan_kernel",)}
    by_group = dict.fromkeys(list(groups) + ["gemm", "other"], 0.0)
    count_by_group = dict.fromkeys(by_group, 0)
    by_span = {}
    launches = 0
    for e in events:
        if e.key in _Spans.NAMES:                  # the span's kernels, summed; its
            if e.device_type != DeviceType.CUDA:   # device-side row is its extent
                by_span[e.key] = getattr(e, "device_time_total", None) or e.cuda_time_total
            continue
        if e.device_type != DeviceType.CUDA:       # device kernels only: an
            continue                               # op's own row repeats them
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        launches += e.count
        name = e.key
        g = next((g for g, keys in groups.items() if any(k in name for k in keys)), None)
        if g is None:
            g = "gemm" if any(w in name.lower() for w in ("gemm", "nvjet", "cutlass", "sm90_xmma")) \
                else "other"
        by_group[g] += t
        count_by_group[g] += e.count
    return by_group, count_by_group, launches, by_span


# The train phase: qwen2.5-3b at published width, its first MAIN_LAYERS
# layers (the served phases' cut), B x S tokens a step, AdamW with
# OptConfig's defaults through `Trainer.run`. Float32 masters, grads, the
# clip's float32 copy and AdamW's m and v are 20 B a parameter: ~25 GB
# for the 1.24 B parameters, with the bf16 cast, the float32 logits
# (B S V x 4 B, ~1.2 GB) and their gradient beside them.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 4


# The train phase's control: its first step through the kernels against the
# same step through their plain versions on the card, both in bf16. Loss:
# relative error; gradients: each parameter's ||a - b|| / ||b|| (its largest
# over the parameters), where a wrong kernel moves the attention weights'
# gradients by their own size.
TRAIN_CONTROL_TOL = {"loss": 1e-3, "grad": 0.1}


def _train_control(cfg, t) -> dict:
    """The loss and every parameter's gradient of trainer t's first batch
    (the data cursor left where it was) through the kernels' autograd forms
    and again with `kernels.autograd`'s four functions swapped for the
    kernels' plain versions (PyTorch's autograd), on the same parameters on
    the card. Launches made here are not the main path's: the caller zeroes
    the counts after it."""
    import torch
    from repro_torch.kernels import autograd as kag
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.kernels import ssm_scan as k7
    from repro_torch.training import make_loss_fn
    from repro_torch.tree import flat

    snap = t.data.snapshot()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in t.data.next().items()}
    t.data.restore(snap)
    loss_fn, leaves = make_loss_fn(cfg, remat=False), flat(t.params)
    for p in leaves:
        p.requires_grad_(True)

    def value_and_grads():
        loss, _ = loss_fn(t.params, batch)
        return loss.item(), torch.autograd.grad(loss, leaves, allow_unused=True)
    loss_k, grads_k = value_and_grads()
    plain = {"chunk_prefill_attention": k2.chunk_prefill_attention_plain,
             "bidirectional_attention": k2.bidirectional_attention_plain,
             "moe_gating": k6.moe_gating_plain, "ssm_scan": k7.ssm_scan_plain}
    kernels = {name: getattr(kag, name) for name in plain}
    try:
        for name, fn in plain.items():
            setattr(kag, name, fn)
        loss_p, grads_p = value_and_grads()
    finally:
        for name, fn in kernels.items():
            setattr(kag, name, fn)
    errs = [float((a - b).norm() / b.norm()) for a, b in zip(grads_k, grads_p)
            if a is not None and float(b.norm()) > 0]
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_err": abs(loss_k - loss_p) / abs(loss_p), "grad_err": max(errs),
            "grads_compared": len(errs), "tol": TRAIN_CONTROL_TOL}


def phase_train(seed: int, profile: bool, out_dir) -> dict:
    """Training on the card at published width (`repro_torch.training`):
    qwen2.5-3b cut to MAIN_LAYERS layers, parameters drawn from --seed as
    float32 masters, `Trainer.run` for TRAIN_STEPS AdamW steps on
    `LMBatches(corpus_token_stream(make_wiki_corpus()), TRAIN_BATCH,
    TRAIN_SEQ)` (the byte ids reach only the first rows of the embedding;
    the logits span the whole vocabulary). Reported: each step's loss and
    host seconds (synchronised), the step time (the median of steps 2-4)
    and tokens/s, the peak of allocated device memory (reset after the
    earlier phases' garbage is collected; the allocation on entry and at
    the start beside it), and the model-flops
    share: `launch/flops.py`'s 6 N D for a training step over the step time
    and `serving/costs.py`'s peak (989e12 flop/s). Asserted: finite losses,
    K2 = layers x rows x steps (one launch a row a layer, forward only: the
    backward recomputes the plain version) and no other kernel, and the
    first step's loss and gradients within TRAIN_CONTROL_TOL of the same
    step through the plain versions (`_train_control`, before the counted
    run). Then a
    second trainer from the same seed on one batch that repeats (the
    stream cut to one batch): its loss must fall over the steps. With
    --profile one more step of the first trainer is profiled for its
    device busy share. No checkpoint is written at this width (~15 GB of
    npz)."""
    import statistics
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import lm_data
    from repro_torch.data.corpus import make_wiki_corpus
    from repro_torch.launch.flops import model_flops
    from repro_torch.serving.costs import PEAK_FLOPS
    from repro_torch.training import OptConfig, Trainer, TrainerConfig
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cfg = get_config("qwen2.5-3b").replace(num_layers=MAIN_LAYERS)
    stream = lm_data.corpus_token_stream(make_wiki_corpus())
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")    # stays empty

    def trainer(tokens, steps=TRAIN_STEPS, mesh=None):
        tcfg = TrainerConfig(total_steps=steps, ckpt_every=TRAIN_STEPS + 1,
                             ckpt_dir=ckpt_dir, seed=seed, log_every=1)
        t = Trainer(cfg, OptConfig(), lm_data.LMBatches(tokens, TRAIN_BATCH, TRAIN_SEQ), tcfg,
                    mesh=mesh)
        t.init()
        seconds, norms, sums = [], [], []

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            norms.append(float(out[2]["grad_norm"]))
            if len(seconds) == MESH_TRAIN_STEPS:
                sums.extend(_checksums(out[0]))
            return out
        step = t.train_step
        t.train_step = timed
        return t, seconds, {"grad_norms": norms, "checksums": sums}

    # what the earlier phases left: garbage that a reference cycle keeps
    # until Python's cyclic collector runs, and tensors still referenced
    entry = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t, seconds, alone = trainer(stream)
    control = _train_control(cfg, t)
    _zero_launches()
    losses = t.run()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(seconds[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(cfg, ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH))
    out = {"phase": "train", "card": nvidia_smi(), "model": "qwen2.5-3b",
           "layers": f"{MAIN_LAYERS} of 36",
           "parameters": cfg.param_count(), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "optimizer": "adamw, OptConfig() defaults", "losses": losses,
           "step_seconds": seconds, "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "max_memory_allocated": peak, "allocated_at_entry": entry,
           "allocated_at_start": start, "model_flops_per_step": flops,
           "model_flops_share": flops / step_s / PEAK_FLOPS, "peak_flops": PEAK_FLOPS,
           "launches": launches, "control": control}
    if profile:
        batch = t.data.next()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            t.params, t.opt_state, _ = t.train_step(t.params, t.opt_state, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        by_group, _, kernels, _ = _device_groups(events)
        busy = sum(by_group.values())
        out["profile"] = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                          "device_busy_share": busy / wall_us, "device_kernels": kernels,
                          "device_ms_by_group": {g: v / 1e3 for g, v in by_group.items()}}
        _profile_table(events, out_dir, "train")
        if busy <= 0:
            raise AssertionError("train: the profiler saw no device time")
    del t
    torch.cuda.empty_cache()
    repeat, _, _ = trainer(stream[:TRAIN_BATCH * (TRAIN_SEQ + 1)])
    out["losses_one_batch"] = repeat.run()
    del repeat
    torch.cuda.empty_cache()
    out["mesh"] = _train_mesh(trainer, stream, losses, seconds, alone, out_dir)
    emit(out)
    want = MAIN_LAYERS * TRAIN_BATCH * TRAIN_STEPS
    others = {k: n for k, n in launches.items() if k != "K2" and n}
    if launches["K2"] != want or others:
        raise AssertionError(f"train: K2 launched {launches['K2']} times, want {want} "
                             f"(layers x rows x steps), and nothing else: {others}")
    if not (control["loss_err"] <= TRAIN_CONTROL_TOL["loss"]
            and control["grad_err"] <= TRAIN_CONTROL_TOL["grad"]):
        raise AssertionError(f"train: the first step differs from its plain-version "
                             f"control: {control}")
    if not all(math.isfinite(x) for x in losses + out["losses_one_batch"]):
        raise AssertionError(f"train: a loss is not finite: {out}")
    first, *_, last = out["losses_one_batch"]
    if not last < first:
        raise AssertionError(f"train: the loss on one repeated batch did not fall: "
                             f"{out['losses_one_batch']}")
    _check_train_mesh(out["mesh"])
    return out


# The train phase's mesh run: MESH_TRAIN_STEPS steps of the same Trainer on
# a 1x1 NCCL mesh, held to the card alone's first steps. At group size 1
# every collective is the identity and the mesh step keeps one card's
# arithmetic (the loss's share is 1, the norm adds its leaves in one
# card's order), so its losses, gradient norms and the checksums of each
# parameter leaf must equal the card alone's bit for bit.
MESH_TRAIN_STEPS = 2


def _checksums(params) -> list:
    """(sum, sum of |x|) of each parameter leaf: float32 reductions, which
    allocate no copy of the leaf (the phase reports its peak memory), and
    which the card computes in the same order for the same leaf."""
    import torch
    from repro_torch.tree import flat
    return [(float(t.detach().sum()), float(torch.linalg.vector_norm(t.detach(), 1)))
            for t in flat(params)]


def _train_mesh(trainer, stream, losses, seconds, alone, out_dir) -> dict:
    """The train phase's Trainer for MESH_TRAIN_STEPS steps on a 1x1 NCCL
    mesh (`Trainer(mesh=)`: `forward(mesh=)`, the FSDP gathers and their
    reduce-scatters, the `model` sums and region entries, the vocabulary's
    gather, the sharded AdamW state), after the card-alone trainers are
    freed: its losses, gradient norms and parameter checksums beside the
    card alone's first steps (their largest differences, 0 where they are
    identical), its step ms and K2 launches."""
    import statistics

    import torch
    with _nccl_mesh(out_dir) as (mesh, init_s):
        t, mesh_seconds, got = trainer(stream, MESH_TRAIN_STEPS, mesh)
        _zero_launches()
        mesh_losses = t.run()
        launches = _launch_counts()
        del t
        torch.cuda.empty_cache()
    n = MESH_TRAIN_STEPS
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(mesh_losses, losses[:n]))
    norm_err = max(abs(a - b) / abs(b) for a, b in zip(got["grad_norms"], alone["grad_norms"][:n]))
    sum_err = max(abs(a[0] - b[0]) / max(b[1], 1e-30)
                  for a, b in zip(got["checksums"], alone["checksums"]))
    return {"mesh": list(MESH_SHAPE), "backend": "nccl", "steps": n,
            "process_group_and_mesh_s": init_s,
            "losses": mesh_losses, "losses_alone": losses[:n],
            "grad_norms": got["grad_norms"], "grad_norms_alone": alone["grad_norms"][:n],
            "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
            "checksum_rel_err": sum_err,
            "identical_to_the_card_alone": (mesh_losses == losses[:n]
                                            and got["grad_norms"] == alone["grad_norms"][:n]
                                            and got["checksums"] == alone["checksums"]),
            "step_seconds": mesh_seconds, "step_ms": statistics.median(mesh_seconds) * 1e3,
            "step_ms_alone": statistics.median(seconds[:n]) * 1e3,
            "launches": launches}


def _check_train_mesh(m: dict) -> None:
    want = MAIN_LAYERS * TRAIN_BATCH * MESH_TRAIN_STEPS
    others = {k: n for k, n in m["launches"].items() if k != "K2" and n}
    if m["launches"]["K2"] != want or others:
        raise AssertionError(f"train on the mesh: K2 launched {m['launches']['K2']} times, "
                             f"want {want}, and nothing else: {others}")
    if not m["identical_to_the_card_alone"]:
        raise AssertionError(f"train on the 1x1 mesh is not the card alone's bit for bit: {m}")


def phase_kernels(captures: dict, launches: dict) -> list:
    rows = []

    edges = _paged_edges()
    rows += _kernel_k1(captures, launches, edges)
    rows += _kernel_k2(captures, launches, edges)

    rows += [_k2_row(*captures[f"K2_{p}"].args, launches[f"K2_{p}"], f" [{name} chunk]")
             for p, name in (("grok", "grok"), ("hybrid", "zamba2"))]
    rows.append(_kernel_k3(captures, launches))
    rows += _kernel_k4(captures, launches, edges)
    rows += [_k4_row(captures[f"K4_{p}"].args, launches[f"K4_{p}"], f" [{name}]")
             for p, name in (("grok", "grok"), ("hybrid", "zamba2"))]
    rows.append(_kernel_k5(captures, launches, edges))
    rows.append(_kernel_k5s(launches))
    rows.append(_k5_row(*captures["K5_whisper_cross"].args, launches["K5_whisper"],
                        " [whisper cross decode]"))
    rows += _kernel_k2nc(captures, launches, edges)
    rows += _kernel_k6(captures, launches)
    rows += _kernel_k6_grouped(captures)
    rows.append(_kernel_k7(captures, launches))
    rows += _kernel_grads(launches["train"])

    for r in rows:
        r["kernel_ms"] = r["ms"]
        emit({"phase": "kernels", **r})
        for key in ("max_abs_err", "max_abs_err_contiguous", "max_abs_err_float32",
                    "max_abs_err_edge_float32", "max_abs_err_edge_bf16"):
            tol = r["tol"] if key in ("max_abs_err", "max_abs_err_contiguous") else \
                r.get("tol_bf16", TOL["bfloat16"]) if key.endswith("bf16") else \
                r.get("tol_float32", r["tol"])
            # an attention row's own-dtype check: allclose (`close_err`)
            key = key.replace("abs", "close") if key.replace("abs", "close") in r else key
            if key in r and not r[key] <= tol:
                raise AssertionError(f"{r['name']}: {key}={r[key]} > {tol}")
        if "tol_grad" in r and not r["rel_err_grad"] <= r["tol_grad"]:
            raise AssertionError(f"{r['name']}: rel_err_grad={r['rel_err_grad']} > "
                                 f"{r['tol_grad']}")
    return rows


def _k3_check(db, q, k) -> tuple:
    """K3 against its plain version on one input: the distances' largest
    error, that every index realises its reported distance (within the
    same tolerance), and the indices identical wherever the plain
    version's distance is unique (more than K3_MARGIN from its neighbours:
    nearer values may swap, the two sum in different orders). Returns
    (error, indices equal where unique)."""
    import torch
    from repro_torch.kernels import topk_l2 as k3
    d, i = k3.topk_l2(db, q, k)
    dp, ip = k3.topk_l2_plain(db, q, k)
    d2 = ((q[:, None, :] - db[None]) ** 2).sum(-1)
    realised = torch.sqrt(torch.clamp(torch.gather(d2, 1, i.long()), min=0.0))
    gap = torch.full_like(dp, float("inf"))
    if k > 1:
        step = (dp[:, 1:] - dp[:, :-1]).abs()
        gap[:, 1:] = step
        gap[:, :-1] = torch.minimum(gap[:, :-1], step)
    unique = gap > K3_MARGIN
    if k < db.shape[0]:                          # the next rank, beyond the output
        d_all, _ = k3.topk_l2_plain(db, q, k + 1)
        unique[:, -1] &= (d_all[:, -1] - dp[:, -1]).abs() > K3_MARGIN
    return (max(max_err(d, dp), max_err(realised, d)),
            bool(torch.equal(i[unique], ip[unique])))


def _kernel_k3(captures: dict, launches: dict) -> dict:
    """K3 on the inputs of the main phase's largest launch and on edge
    shapes (N at the cluster's edges and the two-kernel shape up to MAX_N,
    D 32 and 64, M 1 and 8, k < N, exact ties), against its plain version
    (`_k3_check`; exact ties: indices identical everywhere)."""
    import torch
    from repro_torch.kernels import topk_l2 as k3

    db, qq, k = captures["K3"].args
    err, same = _k3_check(db, qq, k)
    gen = torch.Generator(device="cuda").manual_seed(13)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    edges = {"N=256": (r(256, 256), r(4, 256), 256), "N=2048": (r(2048, 256), r(4, 256), 2048),
             "N=2049": (r(2049, 64), r(2, 64), 2049), "N=16384": (r(16384, 32), r(1, 32), 16384),
             "D=32,M=8": (r(309, 32), r(8, 32), 309), "D=64,M=1": (r(309, 64), r(1, 64), 309),
             "k=10": (db, qq, 10), "N=2049,k=100": (r(2049, 64), r(8, 64), 100),
             "N=1": (r(1, 256), r(4, 256), 1), "N=40": (r(40, 256), r(4, 256), 40)}
    edge_err, edge_same = {}, {}
    for name, args in edges.items():
        edge_err[name], edge_same[name] = _k3_check(*args)
    # exact ties (duplicated rows; a query equal to a row): lowest index first
    dup = torch.cat([db[:100], db[:100], db[50:150]])
    qd = torch.cat([qq[:2], db[10:11]])
    for name, (dbt, qt) in {"ties": (dup, qd),
                           "ties N=2400": (torch.cat([dup] * 8), qd)}.items():
        de, ie = k3.topk_l2(dbt, qt, dbt.shape[0])
        dpe, ipe = k3.topk_l2_plain(dbt, qt, dbt.shape[0])
        edge_err[name], edge_same[name] = max_err(de, dpe), bool(torch.equal(ie, ipe))
    bad = {n: (edge_err[n], edge_same[n]) for n in edges.keys() | {"ties", "ties N=2400"}
           if not (edge_err[n] <= TOL["topk"] and edge_same[n])}
    if bad or not same:
        raise AssertionError(f"K3 disagrees with its plain version (error, indices equal "
                             f"where unique): captured {err, same}, edges {bad}")
    M, D = qq.shape
    N = db.shape[0]
    nbytes = (N * D + M * D) * 4 + M * k * 8
    b_ms, b_by = bound(nbytes, 3 * M * N * D, "float32")

    def kernel():
        return k3.topk_l2(db, qq, k)

    def library():
        return torch.sort(torch.cdist(qq, db), dim=1, stable=True)
    return dict(
        name="topk_l2", route="cuda", source="src/repro_torch/kernels/csrc/topk_l2.cu",
        replaces="src/repro/kernels/topk_l2.py:55", launches=launches["K3"],
        shape=f"db{tuple(db.shape)} q{tuple(qq.shape)} k={k} float32",
        plan=list(k3.topk_plan(N)), max_abs_err=err, tol=TOL["topk"],
        digest=_sha(db, qq, *k3.topk_l2(db, qq, k)),
        indices_identical_where_unique=same, edge_cases=sorted(edge_err),
        max_abs_err_edge_float32=max(edge_err.values()), tol_float32=TOL["topk"],
        ms=cuda_ms(kernel), plain_ms=cuda_ms(lambda: k3.topk_l2_plain(db, qq, k)),
        library_ms=cuda_ms(library),
        device_ms=device_ms(kernel), library_device_ms=device_ms(library),
        device_ms_method=DEVICE_MS_METHOD,
        library_call="torch.cdist + torch.sort(stable=True)",
        bound_ms=b_ms, bound_by=b_by)


def _paged_edges() -> tuple:
    """K1, K2, K4, K5 and K2's non-causal form -- the kernels on the
    paged-attention core --
    against their plain versions, bf16 and float32, on seeded inputs at edge
    cases: the JAX package's K1, K2 and K4 test shapes; every G = 1, 2, 4, 8
    x D = 32, 64, 128 x ps = 8, 16, 32, 256 for K1 and K2; for K1 a dead row
    (all-sink table, length three times the table) and a zero length (whose
    zeros are asserted) in every case, and in the grid's cases a length of 1
    (every key span but the first empty); for K2 a 37-token chunk (a ragged
    tile) at a start that is not page-aligned in every case. K4: G = 1, 2,
    8, 16 x C = 1, 3, 5 x (D, ps) = (32, 8), (64, 256), (128, 16), (256,
    32) -- G = 16 at C = 5 is 80 rows, two query tiles -- each with a start
    whose candidates cross a page, a dead all-sink row at a stale start,
    start 0 and a random start. K5: G = 1, 2, 8, 32 x D = 32, 64, 128, 256
    (G x D up to 8,192, twice the old kernel's limit) x S = 64, 700, 1,000
    (not multiples of the 64-position key tile among them), lengths 1, S, S
    + 1 and 0 (whose zeros are asserted). Then, at D = 128, GQA group 6
    (H 12 over 2 KV heads: the first group that is not a power of two, so
    query rows c * G + g straddle the 16-row MMA tiles; K1 and K2 at every
    ps of the grid, K4 at C = 1, 3, 5, K5 at every S) and the dense
    family's head counts at ps 16 (K5: S 700 and 1,000): H 48 over 8
    (nemotron-4-15b), 64 over 8 (qwen3-32b, deepseek-67b) and 32 over 8
    (llava-next-mistral-7b). Last, zamba2-2.7b's head width D = 80 (the
    core's DP = 128 instance): G = 1 and 4 for every kernel (K1 and K2 at
    ps 8, 16, 32; K4 at C = 1, 3, 5; K5 at every S) and its 32 heads over
    32. Then whisper-medium's head width D = 64 at G = 1 (16 heads over 16)
    for every kernel (K1 and K2 at ps 8 and 16, K2 also a 128-token chunk at
    start 820, K4 at C = 1, 3, 5, K5 at S 64, 700, 1,000 and 1,500); and K2's
    non-causal form ("K2nc"): Skv = 1, 65, 1,500 x Sq = 1, 5, 128, 1,500 at
    B = 2, 16 heads over 16, D 64 (partial query and key tiles, one query
    tile shared by key quarters, and whisper's encoder), then GQA group 4
    with a key limit below Skv, group 6, D 32 and D 256; the bf16 ones whose
    shape `bidirectional_route` sends to the Hopper kernel run there. Then
    that kernel ("K2nc_sm90", bf16) through the same wrapper: B 2, Sq 1,500
    over Skv 1,500, and Sq 257 and 385 (partial 192-row query tiles: one
    warpgroup and a row, a row) over Skv 129 and 1,500 with n_keys 1, 127
    (limits inside a key tile) and 1,463, 16 heads over 16 and over 4; its
    launch count must have moved once for each launch routed there and for
    no other. Returns ({(kernel, dtype): max error}, {kernel: number of
    cases}); "K2nc_sm90_close" holds the allclose-form error
    (`close_err`)."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import verify_attention as k4
    gen = torch.Generator(device="cuda").manual_seed(16)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    grid = [(G, D, ps) for G in (1, 2, 4, 8) for D in (32, 64, 128) for ps in (8, 16, 32, 256)]
    # (B, H, Hkv, D, P, ps, nb): tests/test_torch_kernels.py's K1 shapes, then the grid
    k1_cases = [(2, 4, 2, 64, 16, 16, 4), (3, 8, 1, 32, 12, 8, 3)] + \
        [(4, 2 * G, 2, D, 4 * max(2, 512 // ps) + 3, ps, max(2, 512 // ps)) for G, D, ps in grid]
    # (C, H, Hkv, D, ps, n_ctx, start, identity table): its K2 shapes, then the grid
    k2_cases = [(64, 4, 2, 32, 16, 4, 0, True), (128, 2, 1, 64, 32, 4, 0, True),
                (8, 4, 2, 16, 8, 8, 0, False), (8, 4, 2, 16, 8, 8, 21, False),
                (16, 4, 2, 16, 8, 8, 40, False)] + \
        [(37, 2 * G, 2, D, ps, (ps + ps // 2 + 1 + 37) // ps + 2, ps + ps // 2 + 1, False)
         for G, D, ps in grid]
    # (B, H, Hkv, C, D, P, ps, nb): its K4 shapes, then the grid
    k4_cases = [(2, 4, 2, 5, 64, 16, 128, 4), (3, 2, 1, 3, 128, 9, 256, 2)] + \
        [(4, 2 * G, 2, C, D, 4 * max(2, 512 // ps) + 3, ps, max(2, 512 // ps))
         for G in (1, 2, 8, 16) for C in (1, 3, 5)
         for D, ps in ((32, 8), (64, 256), (128, 16), (256, 32))]
    # (B, H, Hkv, D, S)
    k5_cases = [(4, 2 * G, 2, D, S) for G in (1, 2, 8, 32) for D in (32, 64, 128, 256)
                for S in (64, 700, 1000)]
    # GQA group 6 at every page size of the grid, and the dense family's heads
    heads = [(12, 2, ps) for ps in (8, 16, 32, 256)] + \
        [(H, 8, 16) for H in (48, 64, 32)]
    k1_cases += [(4, H, Hkv, 128, 4 * max(2, 512 // ps) + 3, ps, max(2, 512 // ps))
                 for H, Hkv, ps in heads]
    k2_cases += [(37, H, Hkv, 128, ps, (ps + ps // 2 + 1 + 37) // ps + 2, ps + ps // 2 + 1,
                  False) for H, Hkv, ps in heads]
    k4_cases += [(4, H, Hkv, C, 128, 4 * 32 + 3, 16, 32)
                 for H, Hkv in ((12, 2), (48, 8), (64, 8), (32, 8)) for C in (1, 3, 5)]
    k5_cases += [(4, 12, 2, 128, S) for S in (64, 700, 1000)] + \
        [(4, H, 8, 128, S) for H in (48, 64, 32) for S in (700, 1000)]
    # zamba2-2.7b's head width D = 80, in the core's DP = 128 instance: G = 1
    # and 4 over 2 KV heads at page sizes 8, 16, 32, and its own 32 heads
    # over 32 at 16
    d80 = [(2 * G, 2, ps) for G in (1, 4) for ps in (8, 16, 32)] + [(32, 32, 16)]
    k1_cases += [(4, H, Hkv, 80, 4 * max(2, 512 // ps) + 3, ps, max(2, 512 // ps))
                 for H, Hkv, ps in d80]
    k2_cases += [(37, H, Hkv, 80, ps, (ps + ps // 2 + 1 + 37) // ps + 2, ps + ps // 2 + 1,
                  False) for H, Hkv, ps in d80]
    k4_cases += [(4, H, Hkv, C, 80, 4 * 32 + 3, 16, 32)
                 for H, Hkv in ((2, 2), (8, 2), (32, 32)) for C in (1, 3, 5)]
    k5_cases += [(4, H, Hkv, 80, S) for H, Hkv in ((2, 2), (8, 2), (32, 32))
                 for S in (64, 700, 1000)]
    # whisper-medium's head width D = 64 at G = 1: 16 heads over 16
    k1_cases += [(4, 16, 16, 64, 4 * max(2, 512 // ps) + 3, ps, max(2, 512 // ps))
                 for ps in (8, 16)]
    k2_cases += [(37, 16, 16, 64, ps, (ps + ps // 2 + 1 + 37) // ps + 2, ps + ps // 2 + 1,
                  False) for ps in (8, 16)] + [(128, 16, 16, 64, 16, 64, 820, False)]
    k4_cases += [(4, 16, 16, C, 64, 4 * 32 + 3, 16, 32) for C in (1, 3, 5)]
    k5_cases += [(4, 16, 16, 64, S) for S in (64, 700, 1000, 1500)]
    # K2's non-causal form: (B, Sq, Skv, H, Hkv, D, n_keys)
    nc_cases = [(2, Sq, Skv, 16, 16, 64, Skv) for Skv in (1, 65, 1500)
                for Sq in (1, 5, 128, 1500)] + \
        [(3, 37, 100, 8, 2, 128, 77), (2, 5, 65, 12, 2, 128, 65), (2, 128, 1500, 4, 4, 32, 1500),
         (1, 16, 300, 4, 1, 256, 299)]
    # K2's non-causal form on its Hopper kernel: (B, Sq, Skv, H, Hkv, D, n_keys)
    sm90_cases = [(2, 1500, 1500, 16, 16, 64, 1500)] + \
        [(2, Sq, Skv, 16, Hkv, 64, n) for Sq in (257, 385)
         for Skv, n in ((129, 1), (129, 127), (1500, 1), (1500, 127), (1500, 1463))
         for Hkv in (16, 4)]
    errs = {}

    def note(kernel, name, err):
        errs[kernel, name] = max(errs.get((kernel, name), 0.0), err)
    sm90_before = k2.bidirectional_sm90_launches
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).removeprefix("torch.")
        for B, H, Hkv, D, P, ps, nb in k1_cases:
            q, kp, vp = r(B, H, D).to(dt), r(P, ps, Hkv, D).to(dt), r(P, ps, Hkv, D).to(dt)
            tbl = torch.randperm(P, generator=gen, device="cuda")[: B * nb].reshape(B, nb).int()
            lens = torch.randint(1, nb * ps + 1, (B,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            tbl[B - 2], lens[B - 2] = 0, nb * ps * 3      # dead: all-sink, past its table
            lens[B - 1] = 0
            if B == 4:
                lens[1] = 1                                # one key: later spans empty
            got = k1.paged_decode_attention(q, kp, vp, tbl, lens)
            note("K1", name, max_err(got, k1.paged_decode_attention_plain(q, kp, vp, tbl, lens)))
            if float(got[B - 1].float().abs().max()) != 0.0:
                raise AssertionError(f"K1: lengths == 0 must give zeros ({name}, D={D})")
        for C, H, Hkv, D, ps, n_ctx, start, ident in k2_cases:
            P = n_ctx + 3
            q, kp, vp = r(C, H, D).to(dt), r(P, ps, Hkv, D).to(dt), r(P, ps, Hkv, D).to(dt)
            ctx = (torch.arange(n_ctx, device="cuda") if ident else
                   torch.randperm(P, generator=gen, device="cuda")[:n_ctx]).int()
            note("K2", name, max_err(k2.chunk_prefill_attention(q, kp, vp, ctx, start),
                                     k2.chunk_prefill_attention_plain(q, kp, vp, ctx, start)))
        for B, H, Hkv, C, D, P, ps, nb in k4_cases:
            q, kp, vp = r(B, H, C, D).to(dt), r(P, ps, Hkv, D).to(dt), r(P, ps, Hkv, D).to(dt)
            tbl = torch.randperm(P, generator=gen, device="cuda")[: B * nb].reshape(B, nb).int()
            starts = torch.randint(0, nb * ps - C + 1, (B,), generator=gen, device="cuda",
                                   dtype=torch.int32)
            if B == 4:
                starts[0] = ps * (nb // 2) - C // 2 - 1   # candidates cross a page
                tbl[1], starts[1] = 0, nb * ps * 3        # dead: all-sink, stale start
                starts[2] = 0
            note("K4", name, max_err(k4.paged_verify_attention(q, kp, vp, tbl, starts),
                                     k4.paged_verify_attention_plain(q, kp, vp, tbl, starts)))
        for B, H, Hkv, D, S in k5_cases:
            q, kc, vc = r(B, H, D).to(dt), r(B, S, Hkv, D).to(dt), r(B, S, Hkv, D).to(dt)
            lens = torch.tensor([1, S, S + 1, 0], dtype=torch.int32, device="cuda")
            got = k1.decode_attention(q, kc, vc, lens)
            note("K5", name, max_err(got, k1.decode_attention_plain(q, kc, vc, lens)))
            if float(got[3].float().abs().max()) != 0.0:
                raise AssertionError(f"K5: a zero length must give zeros ({name}, D={D})")
        for B, Sq, Skv, H, Hkv, D, n in nc_cases:
            q, k, v = r(B, Sq, H, D).to(dt), r(B, Skv, Hkv, D).to(dt), r(B, Skv, Hkv, D).to(dt)
            note("K2nc", name, max_err(k2.bidirectional_attention(q, k, v, n),
                                       k2.bidirectional_attention_plain(q, k, v, n)))
    routed = sum(k2.bidirectional_route(torch.bfloat16, B, Sq, H, Hkv, D) == "sm90"
                 for B, Sq, Skv, H, Hkv, D, n in nc_cases)
    for B, Sq, Skv, H, Hkv, D, n in sm90_cases:
        if k2.bidirectional_route(torch.bfloat16, B, Sq, H, Hkv, D) != "sm90":
            raise AssertionError(f"K2nc_sm90: ({B}, {Sq}, {Skv}, {H}, {Hkv}, {D}) routes "
                                 f"to the core")
        q, k, v = (r(B, S, h, D).bfloat16() for S, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
        got = k2.bidirectional_attention(q, k, v, n)
        want = k2.bidirectional_attention_plain(q, k, v, n)
        note("K2nc_sm90", "bfloat16", max_err(got, want))
        note("K2nc_sm90_close", "bfloat16", close_err(got, want))
    moved = k2.bidirectional_sm90_launches - sm90_before
    if moved != routed + len(sm90_cases):
        raise AssertionError(f"K2nc_sm90: {moved} launches of the Hopper kernel for "
                             f"{routed} + {len(sm90_cases)} launches routed there")
    return errs, {"K1": len(k1_cases), "K2": len(k2_cases), "K4": len(k4_cases),
                  "K5": len(k5_cases), "K2nc": len(nc_cases),
                  "K2nc_sm90": routed + len(sm90_cases)}


def _k1_row(q, kp, vp, tbl, lens, launches: int, variant: str) -> dict:
    """K1 at one launch's inputs: errors (its dtype and float32), event and
    device times, bound, and SDPA over a pre-gathered view as yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as k1
    dt = str(q.dtype).removeprefix("torch.")
    got = k1.paged_decode_attention(q, kp, vp, tbl, lens)
    want = k1.paged_decode_attention_plain(q, kp, vp, tbl, lens)
    errs = {dt: max_err(got, want), "close": close_err(got, want)}
    q32, kp32, vp32 = q.float(), kp.float(), vp.float()
    errs["float32"] = max_err(k1.paged_decode_attention(q32, kp32, vp32, tbl, lens),
                              k1.paged_decode_attention_plain(q32, kp32, vp32, tbl, lens))
    B, H, D = q.shape
    Hkv, ps = kp.shape[2], kp.shape[1]
    S = tbl.shape[1] * ps
    vis = torch.clamp(lens.long(), max=S)
    nbytes = (2 * int(vis.sum()) * Hkv * D + 2 * B * H * D) * q.element_size() \
        + tbl.numel() * 4 + lens.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * int(vis.sum()) * H * D, dt)
    idx = tbl.long()
    kg = kp[idx].reshape(B, S, Hkv, D).transpose(1, 2).repeat_interleave(H // Hkv, 1)
    vg = vp[idx].reshape(B, S, Hkv, D).transpose(1, 2).repeat_interleave(H // Hkv, 1)
    mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def kernel():
        return k1.paged_decode_attention(q, kp, vp, tbl, lens)

    def library():
        return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)
    return dict(
        name="paged_decode_attention" + variant, route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        core="src/repro_torch/kernels/csrc/paged_attention.cuh",
        replaces="src/repro/kernels/decode_attention.py:101", launches=launches,
        shape=f"q{tuple(q.shape)} table{tuple(tbl.shape)} lengths {lens.tolist()} {dt}",
        max_abs_err=errs[dt], max_close_err=errs["close"], tol=TOL[dt],
        max_abs_err_float32=errs["float32"],
        tol_float32=TOL["float32"],
        ms=cuda_ms(kernel), plain_ms=cuda_ms(lambda: k1.paged_decode_attention_plain(
            q, kp, vp, tbl, lens)),
        library_ms=cuda_ms(library),
        device_ms=device_ms(kernel), library_device_ms=device_ms(library),
        device_ms_method=DEVICE_MS_METHOD,
        library_call="F.scaled_dot_product_attention over a pre-gathered view",
        bound_ms=b_ms, bound_by=b_by)


def _with_edges(row: dict, kernel: str, edges: tuple, captured_edge: float) -> dict:
    """The edge cases' errors on a kernel's row: `_paged_edges`' and the
    float32 error of an edge case on the captured inputs."""
    errs, n_cases = edges
    row.update(max_abs_err_edge_float32=max(errs[kernel, "float32"], captured_edge),
               max_abs_err_edge_bf16=errs[kernel, "bfloat16"], edge_cases=n_cases[kernel],
               tol_bf16=TOL["bfloat16"])
    return row


def _kernel_k1(captures: dict, launches: dict, edges: tuple) -> list:
    """K1 at its captured launch (the first decode step of the main path)
    and with every row's length at the full table (nb * ps), with the edge
    cases of `_paged_edges` and, on the captured pools in float32, a dead
    row (all-sink table, length past nb * ps) and a zero length."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    q, kp, vp, tbl, lens = captures["K1"].args
    q32, kp32, vp32 = q.float(), kp.float(), vp.float()
    tbl_e, lens_e = tbl.clone(), lens.clone()
    tbl_e[0] = 0
    lens_e[0] = tbl.shape[1] * kp.shape[1] * 3
    lens_e[-1] = 0
    got = k1.paged_decode_attention(q32, kp32, vp32, tbl_e, lens_e)
    edge = max_err(got, k1.paged_decode_attention_plain(q32, kp32, vp32, tbl_e, lens_e))
    if float(got[-1].abs().max()) != 0.0:
        raise AssertionError("K1: lengths == 0 must give zeros")
    full = torch.full_like(lens, tbl.shape[1] * kp.shape[1])
    return [_with_edges(_k1_row(q, kp, vp, tbl, lens, launches["K1"], ""), "K1", edges, edge),
            _k1_row(q, kp, vp, tbl, full, launches["K1"], " [full table]")]


def _k2_row(q, kp, vp, ctx, start, launches: int, variant: str) -> dict:
    """K2 at one launch's inputs, as `_k1_row`."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k2
    dt = str(q.dtype).removeprefix("torch.")
    got = k2.chunk_prefill_attention(q, kp, vp, ctx, start)
    want = k2.chunk_prefill_attention_plain(q, kp, vp, ctx, start)
    errs = {dt: max_err(got, want), "close": close_err(got, want)}
    q32, kp32, vp32 = q.float(), kp.float(), vp.float()
    errs["float32"] = max_err(k2.chunk_prefill_attention(q32, kp32, vp32, ctx, start),
                              k2.chunk_prefill_attention_plain(q32, kp32, vp32, ctx, start))
    C, H, D = q.shape
    Hkv, ps = kp.shape[2], kp.shape[1]
    pairs = sum(start + i + 1 for i in range(C))
    nbytes = (2 * (start + C) * Hkv * D + 2 * C * H * D) * q.element_size() + ctx.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * pairs * H * D, dt)
    S = ctx.shape[0] * ps
    idx = ctx.long()
    kg = kp[idx].reshape(S, Hkv, D).transpose(0, 1).repeat_interleave(H // Hkv, 0)[None]
    vg = vp[idx].reshape(S, Hkv, D).transpose(0, 1).repeat_interleave(H // Hkv, 0)[None]
    qpos = start + torch.arange(C, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, :] <= qpos[:, None])[None, None]
    q4 = q.transpose(0, 1)[None]

    def kernel():
        return k2.chunk_prefill_attention(q, kp, vp, ctx, start)

    def library():
        return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)
    return dict(
        name="chunk_prefill_attention" + variant, route="cuda",
        source="src/repro_torch/kernels/csrc/chunk_prefill_attention.cu",
        core="src/repro_torch/kernels/csrc/paged_attention.cuh",
        replaces="src/repro/kernels/flash_attention.py:71", launches=launches,
        shape=f"q{tuple(q.shape)} start={start} ctx{tuple(ctx.shape)} pages of {ps} {dt}",
        max_abs_err=errs[dt], max_close_err=errs["close"], tol=TOL[dt],
        max_abs_err_float32=errs["float32"],
        tol_float32=TOL["float32"],
        ms=cuda_ms(kernel),
        plain_ms=cuda_ms(lambda: k2.chunk_prefill_attention_plain(q, kp, vp, ctx, start)),
        library_ms=cuda_ms(library),
        device_ms=device_ms(kernel), library_device_ms=device_ms(library),
        device_ms_method=DEVICE_MS_METHOD,
        library_call="F.scaled_dot_product_attention over a pre-gathered view",
        bound_ms=b_ms, bound_by=b_by)


def _kernel_k2(captures: dict, launches: dict, edges: tuple) -> list:
    """K2 at its captured main-path chunk (the latest start), at the slab
    path's largest whole-prompt launch and at the vlm path's first chunk
    (the image rows and 128 text positions from position 0), with
    `_paged_edges`' K2 cases and, on the captured pools in float32, the
    first chunk of the sequence (start = 0)."""
    from repro_torch.kernels import flash_attention as k2
    q, kp, vp, ctx, start = captures["K2"].args
    q32, kp32, vp32 = q.float(), kp.float(), vp.float()
    edge = max_err(k2.chunk_prefill_attention(q32, kp32, vp32, ctx, 0),
                   k2.chunk_prefill_attention_plain(q32, kp32, vp32, ctx, 0))
    chunk = _k2_row(q, kp, vp, ctx, start, launches["K2"], "")
    return [_with_edges(chunk, "K2", edges, edge),
            _k2_row(*captures["K2_slab"].args, launches["K2_slab"], " [slab]"),
            _k2_row(*captures["K2_vlm"].args, launches["K2_vlm"], " [llava image chunk]")]


def _k4_err(q, kp, vp, tbl, starts, err=max_err) -> float:
    from repro_torch.kernels import verify_attention as k4
    return err(k4.paged_verify_attention(q, kp, vp, tbl, starts),
               k4.paged_verify_attention_plain(q, kp, vp, tbl, starts))


def _kernel_k4(captures: dict, launches: dict, edges: tuple) -> list:
    """K4 at its captured spec-path launch and at the vlm path's widest
    verify round (starts past the image prefix), each in the engine's
    layout (a transposed view of a (B, C, H, D) tensor, which the wrapper
    reads without a copy) and as a contiguous (B, H, C, D) input, with
    `_paged_edges`' K4 cases and, on the spec path's captured pools, a start
    whose candidates cross a page, a dead all-sink row at a stale start and
    start 0 (float32), and the captured launch cut to C = 1 and C = 3 (both
    dtypes)."""
    q, kp, vp, tbl, starts = captures["K4"].args
    q = q.transpose(1, 2).contiguous().transpose(1, 2)    # the engine's layout
    q32, kp32, vp32 = q.float(), kp.float(), vp.float()
    B, H, C, D = q.shape
    ps, nb = kp.shape[1], tbl.shape[1]
    tbl_e, st_e = tbl.clone(), starts.clone()
    st_e[0] = ps - C // 2 - 1 + ps * (nb // 2 - 1)
    tbl_e[1 % B] = 0
    st_e[1 % B] = nb * ps * 3
    st_e[-1] = 0
    edge = _k4_err(q32, kp32, vp32, tbl_e, st_e)
    edge_bf16 = 0.0
    for c in (1, 3):
        edge = max(edge, _k4_err(q32[:, :, :c], kp32, vp32, tbl, starts))
        edge_bf16 = max(edge_bf16, _k4_err(q[:, :, :c], kp, vp, tbl, starts))
    row = _with_edges(_k4_row(captures["K4"].args, launches["K4"], ""), "K4", edges, edge)
    row["max_abs_err_edge_bf16"] = max(row["max_abs_err_edge_bf16"], edge_bf16)
    return [row, _k4_row(captures["K4_vlm"].args, launches["K4_vlm"], " [llava]")]


def _k4_row(args, launches: int, variant: str) -> dict:
    """K4 at one captured launch, as `_k1_row`, with the error of a
    contiguous copy of q beside the engine's layout."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import verify_attention as k4
    q, kp, vp, tbl, starts = args
    q = q.transpose(1, 2).contiguous().transpose(1, 2)    # the engine's layout
    qc = q.contiguous()
    dt = str(q.dtype).removeprefix("torch.")
    q32, kp32, vp32 = q.float(), kp.float(), vp.float()
    B, H, C, D = q.shape
    Hkv, ps = kp.shape[2], kp.shape[1]
    nb = tbl.shape[1]
    vis = torch.clamp(starts.long() + C, max=nb * ps)
    pairs = int(sum(torch.clamp(starts.long() + c + 1, max=nb * ps).sum() for c in range(C)))
    nbytes = (2 * int(vis.sum()) * Hkv * D + 2 * B * H * C * D) * q.element_size() \
        + tbl.numel() * 4 + starts.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * pairs * H * D, dt)
    idx = tbl.long()
    S = nb * ps
    kg = kp[idx].reshape(B, S, Hkv, D).transpose(1, 2).repeat_interleave(H // Hkv, 1)
    vg = vp[idx].reshape(B, S, Hkv, D).transpose(1, 2).repeat_interleave(H // Hkv, 1)
    qpos = starts.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    mask = (torch.arange(S, device=q.device)[None, None, :] <= qpos[:, :, None])[:, None]

    def kernel():
        return k4.paged_verify_attention(q, kp, vp, tbl, starts)

    def library():
        return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)
    return dict(
        name="paged_verify_attention" + variant, route="cuda",
        source="src/repro_torch/kernels/csrc/paged_verify_attention.cu",
        core="src/repro_torch/kernels/csrc/paged_attention.cuh",
        replaces="src/repro/kernels/decode_attention.py:185",
        launches=launches,
        shape=f"q{tuple(q.shape)} (a view of (B, C, H, D)) table{tuple(tbl.shape)} "
              f"starts {starts.tolist()} {dt}",
        max_abs_err=_k4_err(q, kp, vp, tbl, starts),
        max_close_err=_k4_err(q, kp, vp, tbl, starts, close_err), tol=TOL[dt],
        max_abs_err_contiguous=_k4_err(qc, kp, vp, tbl, starts),
        max_close_err_contiguous=_k4_err(qc, kp, vp, tbl, starts, close_err),
        max_abs_err_float32=_k4_err(q32, kp32, vp32, tbl, starts),
        tol_float32=TOL["float32"],
        ms=cuda_ms(kernel),
        plain_ms=cuda_ms(lambda: k4.paged_verify_attention_plain(q, kp, vp, tbl, starts)),
        library_ms=cuda_ms(library),
        device_ms=device_ms(kernel), library_device_ms=device_ms(library),
        device_ms_method=DEVICE_MS_METHOD,
        library_call="F.scaled_dot_product_attention over a pre-gathered view "
                     "with the per-candidate causal mask",
        bound_ms=b_ms, bound_by=b_by)


def _kernel_k5(captures: dict, launches: dict, edges: tuple) -> dict:
    """K5 at its captured drafter launch, with `_paged_edges`' K5 cases
    and, on the captured slab, per-row lengths 1, S and one past S (a slot
    that is not live), a zero length (whose zeros are asserted) and a
    scalar length."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    q, kc, vc, lens = captures["K5"].args
    B, S = q.shape[0], kc.shape[1]

    def err(q_, kc_, vc_, lens_):
        return max_err(k1.decode_attention(q_, kc_, vc_, lens_),
                       k1.decode_attention_plain(q_, kc_, vc_, lens_))
    q32, kc32, vc32 = q.float(), kc.float(), vc.float()
    lens_e = torch.tensor([1, S, S + 1, 0][:B] + [S // 2] * max(0, B - 4),
                          dtype=torch.int32, device=q.device)
    got = k1.decode_attention(q32, kc32, vc32, lens_e)
    edge = max(max_err(got, k1.decode_attention_plain(q32, kc32, vc32, lens_e)),
               err(q32, kc32, vc32, S // 3))
    got_bf = k1.decode_attention(q, kc, vc, lens_e)
    edge_bf16 = max_err(got_bf, k1.decode_attention_plain(q, kc, vc, lens_e))
    if B >= 4 and (float(got[3].abs().max()) != 0.0 or float(got_bf[3].abs().max()) != 0.0):
        raise AssertionError("K5: a zero length must give zeros")
    row = _k5_row(q, kc, vc, lens, launches["K5"], "")
    row["launches_slab"] = launches.get("K5_slab")
    row = _with_edges(row, "K5", edges, edge)
    row["max_abs_err_edge_bf16"] = max(row["max_abs_err_edge_bf16"], edge_bf16)
    return row


def _k5_row(q, kc, vc, lens, launches: int, variant: str) -> dict:
    """K5 at one launch's inputs, as `_k1_row`, with SDPA over the slab as
    yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as k1
    dt = str(q.dtype).removeprefix("torch.")
    B, H, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]

    def err(q_, kc_, vc_, lens_):
        return max_err(k1.decode_attention(q_, kc_, vc_, lens_),
                       k1.decode_attention_plain(q_, kc_, vc_, lens_))
    vis = torch.clamp(lens.long(), 0, S)
    nbytes = (2 * int(vis.sum()) * Hkv * D + 2 * B * H * D) * q.element_size() \
        + lens.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * int(vis.sum()) * H * D, dt)
    G = H // Hkv
    kg = kc.transpose(1, 2).repeat_interleave(G, 1)
    vg = vc.transpose(1, 2).repeat_interleave(G, 1)
    mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def kernel():
        return k1.decode_attention(q, kc, vc, lens)

    def library():
        return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)
    return dict(
        name="dense_decode_attention" + variant, route="cuda",
        source="src/repro_torch/kernels/csrc/dense_decode_attention.cu",
        core="src/repro_torch/kernels/csrc/paged_attention.cuh",
        replaces="src/repro/kernels/decode_attention.py:274",
        launches=launches,
        shape=f"q{tuple(q.shape)} cache{tuple(kc.shape)} lengths {lens.tolist()} {dt}",
        max_abs_err=err(q, kc, vc, lens), tol=TOL[dt],
        max_abs_err_float32=err(q.float(), kc.float(), vc.float(), lens),
        tol_float32=TOL["float32"],
        ms=cuda_ms(kernel),
        plain_ms=cuda_ms(lambda: k1.decode_attention_plain(q, kc, vc, lens)),
        library_ms=cuda_ms(library),
        device_ms=device_ms(kernel), library_device_ms=device_ms(library),
        device_ms_method=DEVICE_MS_METHOD,
        library_call="F.scaled_dot_product_attention over the slab in (B, H, S, D) "
                     "with a per-row length mask",
        bound_ms=b_ms, bound_by=b_by)


def _kernel_k5s(launches: dict) -> dict:
    """K5s, the sequence-sharded decode's leaf, at MESH_K5 in bf16: q (4,
    16, 128), the cache's second half as one rank's shard (start 512, 512
    positions), lengths [1,024, 517, 33, 1], so rows 3 and 4 end before the
    shard (m = -inf, l = 0 and acc = 0 asserted). Its error: the largest of
    m's, acc / l's (the output the combine forms on one shard) and l's
    relative error against `decode_attention_stats_plain`, in bf16 and in
    float32. Library yardstick: `aten._scaled_dot_product_efficient_attention`
    over the same shard, its KV heads repeated outside the timing and the
    lengths as an additive -inf mask, with `compute_log_sumexp`: it returns
    (acc / l, m + log l) a row, the pair the cross-shard combine could
    take in place of (m, l, acc) (the rows that end before the shard aside,
    whose statistics the combine must read as no keys). K5 over the same
    shard's keys (lengths - start), the same bytes read, which writes
    acc / l in place of the statistics, is timed beside it. Where the
    library call does not run on this card, its error stands in the row
    in place of its times."""
    import torch
    from repro_torch.kernels import decode_attention as k15
    B, S, hkv, G, hd = MESH_K5
    start, S_loc = S // 2, S - S // 2
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn((B, hkv * G, hd), generator=g, device="cuda").bfloat16()
    kc = torch.randn((B, S_loc, hkv, hd), generator=g, device="cuda").bfloat16()
    vc = torch.randn((B, S_loc, hkv, hd), generator=g, device="cuda").bfloat16()
    lens = torch.tensor([S, start + 5, 33, 1], dtype=torch.int32, device="cuda")
    live = lens > start

    def err(q_, kc_, vc_) -> float:
        m, l, acc = k15.decode_attention_stats(q_, kc_, vc_, lens, start)
        pm, pl, pacc = k15.decode_attention_stats_plain(q_, kc_, vc_, lens, start)
        if not (torch.isneginf(m[~live]).all() and (l[~live] == 0).all()
                and (acc[~live] == 0).all()):
            raise AssertionError("K5s: a length that ends before the shard must give "
                                 "-inf, 0 and zeros")
        out, pout = acc[live] / l[live][..., None], pacc[live] / pl[live][..., None]
        return max(max_err(m[live], pm[live]), max_err(out, pout),
                   float((l[live] / pl[live] - 1).abs().max()))

    vis = torch.clamp(lens.long() - start, 0, S_loc)
    H = hkv * G
    nbytes = (2 * int(vis.sum()) * hkv * hd + B * H * hd) * q.element_size() \
        + B * H * (hd + 2) * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * int(vis.sum()) * H * hd, "bfloat16")
    local = torch.clamp(lens - start, min=0).to(torch.int32)

    def kernel():
        return k15.decode_attention_stats(q, kc, vc, lens, start)

    def k5():
        return k15.decode_attention(q, kc, vc, local)

    qr = q[:, :, None]                                       # (B, H, 1, hd)
    kr = kc.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vr = vc.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    dead = start + torch.arange(S_loc, device="cuda")[None, :] >= lens[:, None]
    mask = torch.zeros((B, H, 1, S_loc), dtype=q.dtype, device="cuda") \
        .masked_fill_(dead[:, None, None, :], float("-inf"))

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(qr, kr, vr, mask, True)
    try:
        library()
        torch.cuda.synchronize()
        lib = dict(library_ms=cuda_ms(library), library_device_ms=device_ms(library),
                   library_call="aten._scaled_dot_product_efficient_attention over the "
                                "shard with a length mask, compute_log_sumexp=True")
    except RuntimeError as exc:
        lib = dict(library_ms=None, library_device_ms=None,
                   library_call=f"aten._scaled_dot_product_efficient_attention: {exc}"[:200])
    return dict(
        name="dense_decode_attention_stats", route="cuda",
        source="src/repro_torch/kernels/csrc/dense_decode_attention_stats.cu",
        core="src/repro_torch/kernels/csrc/paged_attention.cuh",
        replaces="src/repro/distributed/decode.py:33 (the jnp body of _partial_attn: "
                 "no Pallas kernel)",
        launches=launches["K5s"],
        shape=f"q{tuple(q.shape)} shard{tuple(kc.shape)} start {start} lengths "
              f"{lens.tolist()} bfloat16",
        max_abs_err=err(q, kc, vc), tol=TOL["bfloat16"],
        max_abs_err_float32=err(q.float(), kc.float(), vc.float()),
        tol_float32=TOL["float32"],
        ms=cuda_ms(kernel),
        plain_ms=cuda_ms(lambda: k15.decode_attention_stats_plain(q, kc, vc, lens, start)),
        device_ms=device_ms(kernel), device_ms_method=DEVICE_MS_METHOD, **lib,
        k5_same_shard_ms=cuda_ms(k5), k5_same_shard_device_ms=device_ms(k5),
        bound_ms=b_ms, bound_by=b_by)


# the encoder launch's device time on the core, `bidirectional_attention.cu`,
# before it had the Hopper kernel (this script's kernels phase on an H100,
# 700 W)
K2NC_ENCODER_CORE_MS = 0.07081


def _k2nc_row(q, k, v, n_keys, launches: int, variant: str, before=None) -> dict:
    """K2's non-causal form at one launch's inputs, as `_k1_row`, with SDPA
    over the same dense K/V (transposed to (B, H, S, D) and its KV heads
    repeated outside the timing) as yardstick. The row names the kernel
    `bidirectional_route` picks ("sm90": the Hopper kernel, with the core's
    device time on the same inputs in this run; "core"); `before`: the row's device time before the Hopper kernel, in
    brackets."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k2
    dt = str(q.dtype).removeprefix("torch.")
    B, Sq, H, D = q.shape
    route = k2.bidirectional_route(q.dtype, B, Sq, H, k.shape[2], D)
    extra = {}
    if route == "sm90":
        out = torch.empty_like(q)
        extra = {"core_device_ms": device_ms(lambda: k2._launch_core(q, k, v, out, n_keys))}
    if before is not None:
        extra["before_device_ms"] = f"[{before}] (the core, before the Hopper kernel)"

    def err(q_, k_, v_, n_, e=max_err):
        return e(k2.bidirectional_attention(q_, k_, v_, n_),
                 k2.bidirectional_attention_plain(q_, k_, v_, n_))
    Hkv = k.shape[2]
    G = H // Hkv
    nbytes = (2 * B * n_keys * Hkv * D + 2 * B * Sq * H * D) * q.element_size()
    b_ms, b_by = bound(nbytes, 4 * B * Sq * n_keys * H * D, dt, exps=B * Sq * n_keys * H)
    qt = q.transpose(1, 2).contiguous()
    kt = k[:, :n_keys].transpose(1, 2).repeat_interleave(G, 1).contiguous()
    vt = v[:, :n_keys].transpose(1, 2).repeat_interleave(G, 1).contiguous()

    def kernel():
        return k2.bidirectional_attention(q, k, v, n_keys)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt)
    sources = {"sm90": {"source": "src/repro_torch/kernels/csrc/bidirectional_attention_sm90.cu"},
               "core": {"source": "src/repro_torch/kernels/csrc/bidirectional_attention.cu",
                        "core": "src/repro_torch/kernels/csrc/paged_attention.cuh"}}
    return dict(
        name=f"bidirectional_attention{variant[:-1]}, {route}]", route="cuda",
        kernel_route=route, **sources[route],
        replaces="src/repro/kernels/flash_attention.py:86 (causal=False)",
        launches=launches,
        shape=f"q{tuple(q.shape)} k/v{tuple(k.shape)} n_keys {n_keys} {dt}",
        max_abs_err=err(q, k, v, n_keys), max_close_err=err(q, k, v, n_keys, close_err),
        tol=TOL[dt], max_abs_err_float32=err(q.float(), k.float(), v.float(), n_keys),
        tol_float32=TOL["float32"],
        ms=cuda_ms(kernel),
        plain_ms=cuda_ms(lambda: k2.bidirectional_attention_plain(q, k, v, n_keys)),
        library_ms=cuda_ms(library),
        device_ms=device_ms(kernel), library_device_ms=device_ms(library),
        device_ms_method=DEVICE_MS_METHOD,
        library_call="F.scaled_dot_product_attention over the same K/V in (B, H, S, D), "
                     "no mask",
        bound_ms=b_ms, bound_by=b_by, **extra)


def _kernel_k2nc(captures: dict, launches: dict, edges: tuple) -> list:
    """K2's non-causal form at the whisper path's three launches: the
    encoder (1,500 frames over 1,500), a chunk's cross-attention (C = 128
    over the cross K/V) and a verify round's (4 slots x 5 candidates), with
    `_paged_edges`' non-causal cases and, on the chunk's captured K/V in
    float32, a key limit of 1 and of encoder_seq - 37. The encoder's launch
    runs on the Hopper kernel and carries its edge cases
    (`_paged_edges`' "K2nc_sm90"); the other two on the core."""
    from repro_torch.kernels import flash_attention as k2
    q, k, v, n = captures["K2nc_whisper_chunk"].args
    q32, k32, v32 = q.float(), k.float(), v.float()
    edge = max(max_err(k2.bidirectional_attention(q32, k32, v32, m),
                       k2.bidirectional_attention_plain(q32, k32, v32, m))
               for m in (1, n - 37))
    n_all = launches["K2nc_whisper"]
    rows = [_k2nc_row(*captures[f"K2nc_whisper_{w}"].args,
                      launches["K2nc_sm90_whisper"] if w == "encoder"
                      else n_all - launches["K2nc_sm90_whisper"],
                      f" [whisper {name}]", K2NC_ENCODER_CORE_MS if w == "encoder" else None)
            for w, name in (("encoder", "encoder"), ("chunk", "cross chunk"),
                            ("verify", "cross verify round"))]
    if [r["kernel_route"] for r in rows] != ["sm90", "core", "core"]:
        raise AssertionError(f"K2nc routes {[r['kernel_route'] for r in rows]}")
    errs, n_cases = edges
    rows[0].update(max_abs_err_edge_bf16=errs["K2nc_sm90", "bfloat16"],
                   max_close_err_edge_bf16=errs["K2nc_sm90_close", "bfloat16"],
                   edge_cases=n_cases["K2nc_sm90"], tol_bf16=TOL["bfloat16"])
    rows[1] = _with_edges(rows[1], "K2nc", edges, edge)
    return rows


def _k6_cap(T, k, E, factor=1.25):
    from types import SimpleNamespace

    from repro_torch.models.layers import moe_capacity
    return moe_capacity(SimpleNamespace(capacity_factor=factor, moe_top_k=k, n_experts=E), T)


def _k6_errs(logits, k, C):
    """K6 against `moe_gating_plain` on one input: (the largest error of the
    weights and the kept weights, whether indices and slots are identical
    and the kept weights exactly the kernel's where kept and 0 where
    dropped, the assignments dropped)."""
    import torch
    from repro_torch.kernels import moe_gating as k6
    wk, ik, sk, kk = k6.moe_gating(logits, k, C)
    wp, ip, sp, kp = k6.moe_gating_plain(logits, k, C)
    drop = logits.shape[1] * C
    same = (torch.equal(ik, ip) and torch.equal(sk, sp)
            and torch.equal(kk, wk.reshape(-1) * (sk != drop)))
    return max(max_err(wk, wp), max_err(kk, kp)), bool(same), int((sk == drop).sum())


def _kernel_k6(captures: dict, launches: dict) -> list:
    """K6 on the inputs of a captured prefill chunk (T = DEEP_CHUNK) and
    verify round (bf16 logits, the model's capacity) of the moe path
    (deepseek-v2-lite-16b: E 64, k 6) and of the grok path (grok-1-314b:
    E 8, k 2), the same in float32, and edge cases, against
    `moe_gating_plain`: the weights within K6_TOL (float32 throughout; the
    softmax's exponentials and sum round differently), the indices and the
    slots identical, the kept weights exactly the kernel's weights where
    kept and 0 where dropped, and within K6_TOL of the plain version's.
    Yardstick: the sequence the fused launch replaced in `moe_apply` (the
    cast, the gating alone, the numbering)."""
    import torch
    from repro_torch.kernels import moe_gating as k6

    gen = torch.Generator(device="cuda").manual_seed(12)

    def r(T, E, scale=1.0):
        return torch.randn((T, E), generator=gen, device="cuda") * scale

    def case(logits, k, factor=1.25):
        return logits, k, _k6_cap(logits.shape[0], k, logits.shape[1], factor)
    # (logits, k, capacity) of the captured ungrouped launches (their groups, 1, dropped)
    pre, ver = captures["K6"].args[:3], captures["K6_verify"].args[:3]
    gpre, gver = captures["K6_grok"].args[:3], captures["K6_grok_verify"].args[:3]
    one = r(50, 16)
    one[:, 3] += 10.0
    cases = {"chunk": pre, "verify": ver, "chunk f32": (pre[0].float(), *pre[1:]),
             "verify f32": (ver[0].float(), *ver[1:]),
             "grok chunk": gpre, "grok verify": gver,
             "grok chunk f32": (gpre[0].float(), *gpre[1:]),
             "grok verify f32": (gver[0].float(), *gver[1:]),
             "T=1": case(r(1, 64), 6), "E=8,k=2": case(r(100, 8, 2.0), 2),
             "E=8,k=2,T=128": case(r(128, 8, 0.9).bfloat16(), 2),
             "E=8,k=2,T=20": case(r(20, 8, 0.9).bfloat16(), 2),
             "E=4,k=2": case(r(17, 4, 2.0), 2), "E=160": case(r(64, 160), 6),
             "E=256,k=8": case(r(40, 256), 8), "E=40,k=1": case(r(37, 40), 1),
             "k=E": case(r(20, 8), 8),
             "all equal": case(torch.full((9, 64), 0.37, device="cuda"), 6),
             "bf16-rounded": case(r(512, 64, 0.9).bfloat16().float(), 6),
             "bf16 T=1000": case(r(1000, 64, 0.9).bfloat16(), 6),
             "T=2000": case(r(2000, 64, 0.9), 6), "T=37": case(r(37, 64), 6),
             "drops": case(r(128, 64, 0.9).bfloat16(), 6, factor=0.25),
             "one expert": case(one, 2)}
    errs, same, dropped = {}, {}, {}
    for name, args in cases.items():
        errs[name], same[name], dropped[name] = _k6_errs(*args)
    w_eq, i_eq = k6.moe_gating(cases["all equal"][0], 6)
    if not torch.equal(i_eq.cpu(), torch.arange(6, dtype=torch.int32).expand(9, 6)) or \
            max_err(w_eq, torch.full_like(w_eq, 1 / 6)) > K6_TOL:
        raise AssertionError("K6: equal logits must give indices 0..k-1 and weights 1/k")
    bad = {n: (errs[n], same[n]) for n in cases if not (errs[n] <= K6_TOL and same[n])}
    if bad:
        raise AssertionError(f"K6 disagrees with its plain version (error, indices, slots "
                             f"and kept weights equal): {bad}")
    if not dropped["drops"] or not dropped["one expert"]:
        raise AssertionError(f"K6: the capacity cases dropped nothing: {dropped}")
    edges = [n for n in cases if n not in ("chunk", "verify", "grok chunk", "grok verify")]
    edge_err = max(errs[n] for n in edges)
    rows = []
    for p, v, key, path in ((pre, ver, "", "moe"), (gpre, gver, "grok ", "grok")):
        row = _k6_row(p, v, launches[f"K6_{path}"], f" [{path}]" if key else "")
        row.update(max_abs_err=errs[key + "chunk"], max_abs_err_verify=errs[key + "verify"],
                   indices_slots_identical=all(same.values()))
        rows.append(row)
    rows[0].update(max_abs_err_edge_float32=edge_err, tol_float32=K6_TOL, edge_cases=edges,
                   dropped=dropped)
    return rows


# K6 grouped's cases: (captured chunk, its k's path name, groups)
K6_GROUPED = (("K6", "moe", 2), ("K6", "moe", 4), ("K6_grok", "grok", 2))


def _kernel_k6_grouped(captures: dict) -> list:
    """K6's grouped launch (`moe_gating(..., groups=G)`, the grouped
    dispatch of `moe_apply`) on the moe phase's captured chunk logits (T
    128, E 64, k 6) as G = 2 and 4 groups and grok's (E 8, k 2) as G = 2,
    each group at its own capacity moe_capacity(T / G): against the plain
    version group by group, the weights within K6_TOL and the indices,
    slots and kept weights identical. Times beside two yardsticks: G
    ungrouped launches, one a group, and the library sequence of K6's row
    (the cast, the gating alone, the numbering group by group). `launches`
    is filled in from the reference phase's grouped training mode, the
    path that runs it."""
    import torch
    from repro_torch.kernels import moe_gating as k6

    rows = []
    for key, path, G in K6_GROUPED:
        logits, k = captures[key].args[:2]
        T, E = logits.shape
        C = _k6_cap(T // G, k, E)
        wk, ik, sk, kk = k6.moe_gating(logits, k, C, G)
        wp, ip, sp, kp = k6.moe_gating_plain(logits, k, C, G)
        drop = E * C
        same = (torch.equal(ik, ip) and torch.equal(sk, sp) and torch.equal(kk, kp)
                and torch.equal(kk, wk.reshape(-1) * (sk != drop)))
        err = max(max_err(wk, wp), max_err(kk, kp))
        if not (same and err <= K6_TOL):
            raise AssertionError(f"K6 grouped [{path}, G {G}] disagrees with its plain "
                                 f"version: error {err}, identical {same}")

        def loop(logits=logits, k=k, C=C, G=G):
            return [k6.moe_gating(g, k, C) for g in logits.chunk(G)]

        def replaced(logits=logits, k=k, C=C, G=G):
            w, i = k6.moe_gating(logits.float(), k)
            return [k6.number_assignments(a, b, E, C)
                    for a, b in zip(w.chunk(G), i.chunk(G))]
        nbytes = T * E * logits.element_size() + T * k * (4 + 4 + 8 + 4)
        b_ms, b_by = bound(nbytes, T * E * (3 + k) + 4 * T * k, "float32", T * E)
        rows.append(dict(
            name=f"moe_gating grouped [{path}, G {G}]", route="cuda",
            source="src/repro_torch/kernels/csrc/moe_gating.cu",
            replaces="src/repro/kernels/moe_gating.py:47 (the grouped dispatch's gating "
                     "and numbering, src/repro/models/layers.py:588-634)",
            launches=None, tol=K6_TOL, max_abs_err=err, identical=same,
            dropped=int((sk == drop).sum()),
            shape=f"logits{tuple(logits.shape)} {logits.dtype} k={k} G={G} C={C} a group",
            ms=cuda_ms(lambda: k6.moe_gating(logits, k, C, G)),
            plain_ms=cuda_ms(lambda: k6.moe_gating_plain(logits, k, C, G)),
            device_ms=device_ms(lambda: k6.moe_gating(logits, k, C, G)),
            ungrouped_launches_ms=cuda_ms(loop), ungrouped_launches_device_ms=device_ms(loop),
            library_ms=cuda_ms(replaced), library_device_ms=device_ms(replaced),
            device_ms_method=DEVICE_MS_METHOD,
            library_call="the sequence of K6's row, the numbering group by group: "
                         "logits.float(), this kernel's gating alone, one_hot + cumsum - 1 + "
                         "gather, < C, where, w * keep",
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes))
    return rows


def _k6_row(pre, ver, launches: int, variant: str) -> dict:
    """K6 at a captured chunk and verify round: times, device times, the
    bounds and the yardstick, as `_k1_row`."""
    from repro_torch.kernels import moe_gating as k6

    def work(logits, k, C):
        """bytes (logits read; weights, indices, slots and kept weights
        written), flops (exp argument, sum, divide, k rounds of compares,
        the numbering), exponentials"""
        T, E = logits.shape
        return (T * E * logits.element_size() + T * k * (4 + 4 + 8 + 4),
                T * E * (3 + k) + 4 * T * k, T * E)

    def replaced(logits, k, C):
        """What `moe_apply` ran before the fused launch: the float32 cast,
        the gating alone, and the numbering in plain PyTorch."""
        w, i = k6.moe_gating(logits.float(), k)
        return k6.number_assignments(w, i, logits.shape[1], C)
    nbytes, flops, exps = work(*pre)
    b_ms, b_by = bound(nbytes, flops, "float32", exps)
    vb_ms, vb_by = bound(*work(*ver)[:2], "float32", work(*ver)[2])
    return dict(
        name="moe_gating" + variant, route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gating.cu",
        replaces="src/repro/kernels/moe_gating.py:47", launches=launches,
        shape=f"logits{tuple(pre[0].shape)} k={pre[1]} C={pre[2]} {pre[0].dtype} "
              "(a prefill chunk)",
        shape_verify=f"logits{tuple(ver[0].shape)} k={ver[1]} C={ver[2]} {ver[0].dtype} "
                     "(a verify round)",
        tol=K6_TOL,
        # the logits as float32 (the parent's kernel took them so), weights, indices
        digest=_sha(pre[0].float(), *k6.moe_gating(*pre)[:2]),
        digest_verify=_sha(ver[0].float(), *k6.moe_gating(*ver)[:2]),
        ms=cuda_ms(lambda: k6.moe_gating(*pre)),
        plain_ms=cuda_ms(lambda: k6.moe_gating_plain(*pre)),
        ms_verify=cuda_ms(lambda: k6.moe_gating(*ver)),
        plain_ms_verify=cuda_ms(lambda: k6.moe_gating_plain(*ver)),
        library_ms=cuda_ms(lambda: replaced(*pre)),
        device_ms=device_ms(lambda: k6.moe_gating(*pre)),
        device_ms_verify=device_ms(lambda: k6.moe_gating(*ver)),
        device_ms_gating_alone=device_ms(lambda: k6.moe_gating(*pre[:2])),
        library_device_ms=device_ms(lambda: replaced(*pre)),
        library_device_ms_verify=device_ms(lambda: replaced(*ver)),
        device_ms_method=DEVICE_MS_METHOD,
        library_call="the sequence the launch replaced in moe_apply: logits.float(), this "
                     "kernel's gating alone, one_hot + cumsum - 1 + gather, < C, where, w * keep",
        bound_ms=b_ms, bound_by=b_by, bound_ms_verify=vb_ms, bound_by_verify=vb_by,
        bound_bytes=nbytes)


def _k7_work(x, N, h0, states) -> tuple:
    """Bytes K7 must move (each input read once, each output written once),
    its flops and its exponentials, for x (B, S, di) and state size N."""
    B, S, di = x.shape
    e = x.element_size()
    nbytes = (3 * B * S * di + 2 * B * S * N + di) * e + di * N * 4 + B * di * N * 4 \
        + (B * di * N * 4 if h0 is not None else 0) \
        + (B * S * di * N * 4 if states is not None else 0)
    return nbytes, B * S * di * (6 * N + 3), B * S * di * N


def _kernel_k7(captures: dict, launches: dict) -> dict:
    """K7 on the inputs of a captured prefill chunk and verify round, and on
    edge cases, against `ssm_scan_plain`. Tolerances: y in bf16 at 2e-2
    (one bf16 rounding of an fp32 value the kernel and the plain version
    sum in another order), as the other kernels; in float32, y at 2e-5
    (only the order of y's sum over N differs). With random
    weights y is mostly D * x and the captured launches' scan term
    sum_n h C is far below either tolerance (reported, not relied on), so
    the edge cases run at unit scale at the captured widths, where the
    scan term must exceed ten times the float32 tolerance: a y without
    it fails there. The states (final and per position, every case) must
    equal the plain version's exactly: both round each multiply and add
    of the update on its own."""
    import torch
    from repro_torch.kernels import ssm_scan as k7

    def run(args, states=None):
        """((y, h, states) of the kernel, the same of the plain version)."""
        x, dt, A, Bm, Cm, D, h0 = (list(args) + [None])[:7]
        st_k = st_p = None
        if states is not None:
            st_k, st_p = torch.empty_like(states), torch.empty_like(states)
        yk, hk = k7.ssm_scan(x, dt, A, Bm, Cm, D, h0, st_k)
        yp, hp = k7.ssm_scan_plain(x, dt, A, Bm, Cm, D, h0, st_p)
        return (yk, hk, st_k), (yp, hp, st_p)

    def errs_of(args, states=None):
        """(y error, final-state error, states error) of kernel vs plain."""
        got, want = run(args, states)
        return tuple(0.0 if a is None else max_err(a, b) for a, b in zip(got, want))

    def f32(args):
        return tuple(a.float() if a is not None and a.dtype == torch.bfloat16 else a
                     for a in args)

    pre = captures["K7"].args                      # (x, dt, A, B, C, D, h0)
    ver = captures["K7_verify"].args               # (..., h0, states)
    x, dt, A, Bm, Cm, D, h0 = pre
    dtn = str(x.dtype).removeprefix("torch.")
    N = A.shape[1]
    errs = {}
    errs[dtn], errs["state"], _ = errs_of(pre)
    e_y, e_h, e_s = errs_of(ver[:7], ver[7])
    errs["verify"], errs["state"] = e_y, max(errs["state"], e_h, e_s)
    y32, h32, _ = errs_of(f32(pre))
    vy32, vh32, vs32 = errs_of(f32(ver[:7]), ver[7])
    errs["float32"] = max(y32, h32, vy32, vh32, vs32)
    # the final states and per-position states, captured and edge cases:
    # the kernel's update rounds as the plain version's unfused tensor ops,
    # so they must agree exactly
    state_all = max(errs["state"], h32, vh32, vs32)
    # the captured inputs and the kernel's outputs on them, hashed, so two
    # runs of this script (two kernel bodies) can be compared bit for bit
    digests = {"chunk_inputs": _sha(*pre), "chunk_outputs": _sha(*run(pre)[0]),
               "verify_inputs": _sha(*ver[:7]),
               "verify_outputs": _sha(*run(ver[:7], ver[7])[0])}

    def scan_term(args):
        """max |y - D x| of the plain version in float32: the part of y
        the scan contributes."""
        xf, dtf, Af, Bf, Cf, Df, h0f = f32(args[:7])
        yp, _ = k7.ssm_scan_plain(xf, dtf, Af, Bf, Cf, Df, h0f)
        return (yp - Df * xf).abs().max().item()
    errs["scan_term"] = max(scan_term(pre), scan_term(ver))
    # edge cases at unit scale (the JAX package's K7 test distributions) on
    # the captured widths and on small ones: h0 = None, S = 1, verify
    # shapes (B = 4 and 8, S = 5) from a carried state, dt zeroed past a
    # true length (the state must freeze), N = 32, N = 8 and N = 4, a di
    # that is not a multiple of a block's channels (200, 96), a di whose
    # rows are not 16-byte aligned (100: staged without cp.async), and S = 0
    # (y empty, h = h0 exactly)
    gen = torch.Generator(device="cuda").manual_seed(11)

    def unit(B, S, di, n, dtype):
        def r(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale
        xs = r(B, S, di, scale=0.5)
        dts = torch.nn.functional.softplus(r(B, S, di) - 1.0)
        As = -torch.exp(r(di, n, scale=0.3))
        return [xs.to(dtype), dts.to(dtype), As, r(B, S, n, scale=0.5).to(dtype),
                r(B, S, n, scale=0.5).to(dtype), torch.ones(di, device="cuda").to(dtype),
                r(B, di, n)]
    di = x.shape[2]
    edge32, edge_bf, edge_scan = 0.0, 0.0, float("inf")
    cases = ((1, 128, di, N, True, None), (4, 1, di, N, False, None),
             (4, 5, di, N, False, None), (8, 5, di, N, False, None),
             (1, 128, di, N, False, 77), (1, 64, di, 32, False, None),
             (2, 37, 200, N, False, None), (2, 37, 128, 8, False, 20),
             (3, 5, 96, 4, True, None), (2, 19, 100, 8, False, None),
             (2, 0, di, N, False, None))
    for B, S, width, n, h0_none, cut in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = unit(B, S, width, n, dtype)
            if cut is not None:
                args[1][:, cut:] = 0
            if h0_none:
                args[6] = None
            states = torch.empty((B, S, width, n), device="cuda")
            ey, eh, es = errs_of(args, states)
            state_all = max(state_all, eh, es)
            if dtype == torch.float32:
                edge32 = max(edge32, ey, eh, es)
                if S:
                    edge_scan = min(edge_scan, scan_term(args))
            else:
                edge_bf = max(edge_bf, ey)
                edge32 = max(edge32, eh, es)
            if S == 0:                                # nothing to walk
                y0, hk = k7.ssm_scan(*args[:7])
                if y0.shape != (B, 0, width) or not torch.equal(hk, args[6]):
                    raise AssertionError("K7: S = 0 must give an empty y and h = h0")
            if cut is not None:                       # frozen past the length
                st_k = torch.empty_like(states)
                k7.ssm_scan(*args[:7], st_k)
                if not torch.equal(st_k[:, cut:], st_k[:, cut - 1:cut].expand_as(st_k[:, cut:])):
                    raise AssertionError("K7: the state moved where dt is zero")
    errs["edge"], errs["edge_bf16"] = edge32, edge_bf
    # the body at each R (states a thread) and group (steps walked
    # together) the kernel has, on the captured launches and on unit-scale
    # ones at their shapes: outputs equal to the wrapper's bit for bit (y's
    # sum tree depends on neither), and the device time of each
    def with_plan(r, g, args, states=None):
        y_ = torch.empty_like(args[0])
        h_ = torch.empty((args[0].shape[0], args[0].shape[2], N), device="cuda")
        k7._launch(k7.plan_for(r, g, *args[0].shape, N), *args[:7], y_, h_, states)
        return y_, h_, states

    def same_with_plan(r, g, args, states=None):
        want = run(args, states)[0]
        got = with_plan(r, g, args, None if states is None else torch.empty_like(states))
        return all(a is None or torch.equal(a, b) for a, b in zip(want, got))
    unit_pre = unit(1, x.shape[1], di, N, x.dtype)
    unit_ver = unit(*ver[0].shape[:2], di, N, x.dtype)
    by_plan, differ_r = {}, []
    for r in k7.R_CHOICES:
        for g in k7.GROUP_CHOICES:
            for name, args, states in (("chunk", pre, None), ("verify", ver[:7], ver[7]),
                                       ("unit chunk", unit_pre, None),
                                       ("unit verify", unit_ver, ver[7])):
                if not same_with_plan(r, g, args, states):
                    differ_r.append(f"R={r} group={g} {name}")
            by_plan[f"R={r} group={g}"] = {
                "chunk": device_ms(lambda: with_plan(r, g, pre)),
                "verify": device_ms(lambda: with_plan(r, g, ver[:7], ver[7]))}
    if differ_r:
        raise AssertionError(f"K7: outputs differ from the wrapper's at {differ_r}")
    for key, tol in ((dtn, TOL[dtn]), ("verify", TOL[dtn]), ("edge_bf16", TOL["bfloat16"]),
                     ("state", TOL["float32"]), ("float32", TOL["float32"]),
                     ("edge", TOL["float32"])):
        if not errs[key] <= tol:
            raise AssertionError(f"K7: {key} error {errs[key]} > {tol}")
    if state_all != 0.0:
        raise AssertionError(f"K7: a state differs from the plain version's by {state_all}")
    if not edge_scan > 10 * TOL["float32"]:
        raise AssertionError(f"K7: the edge cases' scan term {edge_scan} is too small for "
                             f"the float32 check to see it")
    nbytes, flops, exps = _k7_work(x, N, h0, None)
    b_ms, b_by = bound(nbytes, flops, "float32", exps)
    vx, vh0, vst = ver[0], ver[6], ver[7]
    vbytes, vflops, vexps = _k7_work(vx, N, vh0, vst)
    vb_ms, vb_by = bound(vbytes, vflops, "float32", vexps)
    return dict(
        name="ssm_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:55", launches=launches["K7"],
        shape=f"x{tuple(x.shape)} N={N} h0 {dtn} (a prefill chunk)",
        shape_verify=f"x{tuple(vx.shape)} N={N} h0 + states {dtn} (a verify round)",
        max_abs_err=errs[dtn], tol=TOL[dtn], max_abs_err_verify=errs["verify"],
        max_abs_err_state=errs["state"], max_abs_err_state_all=state_all,
        max_abs_err_float32=errs["float32"],
        max_abs_err_edge_float32=errs["edge"], max_abs_err_edge_bf16=errs["edge_bf16"],
        tol_float32=TOL["float32"], scan_term_max_abs=errs["scan_term"],
        edge_scan_term_min=edge_scan, edge_cases=len(cases) * 2, sha256=digests,
        ms=cuda_ms(lambda: k7.ssm_scan(*pre)),
        plain_ms=cuda_ms(lambda: k7.ssm_scan_plain(*pre), iters=10, warmup=2),
        ms_verify=cuda_ms(lambda: k7.ssm_scan(*ver)),
        plain_ms_verify=cuda_ms(lambda: k7.ssm_scan_plain(*ver), iters=10, warmup=2),
        device_ms=device_ms(lambda: k7.ssm_scan(*pre)),
        device_ms_verify=device_ms(lambda: k7.ssm_scan(*ver)),
        device_ms_by_plan=by_plan, plan=k7.scan_plan(*x.shape, N)._asdict(),
        plan_verify=k7.scan_plan(*vx.shape, N)._asdict(),
        device_ms_method=DEVICE_MS_METHOD,
        library_ms=None, library_call="none: no single PyTorch call computes a selective scan",
        bound_ms=b_ms, bound_by=b_by, bound_ms_verify=vb_ms, bound_by_verify=vb_by,
        bound_bytes=nbytes, bound_exps=exps)


def _grad_row(name, kernel, plain, inputs, diff, *, tol, work, dtype, library=None,
              library_call=None, **info) -> dict:
    """A kernel's forward and gradient on the card: its autograd form
    (`kernels.autograd`: the kernel's forward, the plain version's gradient
    recomputed in the backward) against the plain version's own autograd,
    on the same inputs. The forward outputs are held at `tol` (max_abs_err,
    max_close_err). The gradients are those of sum(y^2 / 2 + y g) over the
    floating outputs y, g seeded randoms: the upstream gradient y + g is
    the form's own forward output, so a wrong kernel forward shows in the
    gradients too. Each gradient is held by its relative L2 error
    ||a - b|| / ||b|| at TOL["bfloat16"]; the elementwise errors are
    reported beside it. Elementwise, a bf16 plain backward is not stable
    under its inputs' last ulp: the softmax backward subtracts terms of
    ~sqrt(D) in bf16, and a causal key's gradient sums thousands of them,
    so one-ulp differences of the forward move single elements of K2's
    gradient by up to ~5% (PERF.md, §6). `diff` flags
    the inputs that take a gradient; `work` is (bytes, flops,
    exponentials) of the forward and backward as one function (each input
    and output gradient read once, each output and input gradient written
    once; flops of the forward's products and the backward's, twice the
    forward's). Times: CUDA events over forward + backward."""
    import torch

    def floats(ys):
        return [y for y in (ys if isinstance(ys, tuple) else (ys,)) if y.is_floating_point()]
    gen = torch.Generator(device="cuda").manual_seed(13)
    with torch.no_grad():
        g_outs = [torch.randn(o.shape, generator=gen, device="cuda")
                  for o in floats(plain(*inputs))]

    def run(fn):
        xs = [x.detach().requires_grad_(d) if torch.is_tensor(x) else x
              for x, d in zip(inputs, diff)]
        ys = floats(fn(*xs))
        loss = sum((y.float() ** 2 / 2 + y.float() * g).sum() for y, g in zip(ys, g_outs))
        return ys, torch.autograd.grad(loss, [x for x, d in zip(xs, diff) if d])
    (y_got, got), (y_want, want) = run(kernel), run(plain)
    b_ms, b_by = bound(*work[:2], dtype, work[2])
    return dict(
        name=name, route="cuda", replaces_backward="none: the JAX package differentiates "
        "plain jnp code (jax.value_and_grad); no backward Pallas kernel",
        backward="src/repro_torch/kernels/autograd.py: the plain version's gradient, "
                 "recomputed from the saved inputs (a stand-in)",
        **info, max_abs_err=max(max_err(a, b) for a, b in zip(y_got, y_want)),
        max_close_err=max(close_err(a, b) for a, b in zip(y_got, y_want)), tol=tol,
        max_abs_err_grad=max(max_err(a, b) for a, b in zip(got, want)),
        max_close_err_grad=max(close_err(a, b) for a, b in zip(got, want)),
        rel_err_grad=max(float((a.float() - b.float()).norm() / b.float().norm())
                         for a, b in zip(got, want)),
        tol_grad=TOL["bfloat16"],
        ms=cuda_ms(lambda: run(kernel), iters=10, warmup=2),
        plain_ms=cuda_ms(lambda: run(plain), iters=10, warmup=2),
        library_ms=None if library is None else cuda_ms(library, iters=10, warmup=2),
        library_call=library_call or "none: no single PyTorch call computes it",
        bound_ms=b_ms, bound_by=b_by)


def _kernel_grads(launches: dict) -> list:
    """The gradient rows: K2 over a whole sequence from position 0 (the
    train phase's launch: 512 positions of one row, 16 heads over 2 at D
    128, over the batch's slab seen as pages of 64; and zamba2's 32 heads
    over 32 at D 80), K2's non-causal form on both routes (whisper's
    encoder on the Hopper kernel; 128 queries a row over 1,500 keys, four
    rows, on the core), K6 at 2,048 tokens (E 64 k 6 and E 8 k 2, bf16
    logits, the model's capacity) and K7 at a falcon-mamba-7b chunk (x (1,
    128, 8,192), N 16). Each compares the autograd form's forward and
    gradient with the plain version's autograd on the card (`_grad_row`),
    the forward at the dtype's tolerance. launches: the train phase's (qwen2.5-3b has no
    MoE, SSM or encoder; the reference phase's training modes launch
    those)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import autograd as kag
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.kernels import ssm_scan as k7
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(14)
    bf = torch.bfloat16

    def r(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
    rows = []
    for H, Hkv, D, tag in ((16, 2, 128, "train"), (32, 32, 80, "zamba2 heads, D 80")):
        S, ps = TRAIN_SEQ, L.slab_page_size(TRAIN_SEQ)
        kp, vp = r(S // ps, ps, Hkv, D), r(S // ps, ps, Hkv, D)
        q, tbl = r(S, H, D), L.slab_tables(1, S, ps, "cuda")[0]
        pairs = S * (S + 1) // 2
        q4 = q.transpose(0, 1)[None]
        k4 = kp.reshape(S, Hkv, D).transpose(0, 1)[None]
        v4 = vp.reshape(S, Hkv, D).transpose(0, 1)[None]

        def sdpa(q4=q4, k4=k4, v4=v4):
            xs = [t.detach().requires_grad_() for t in (q4, k4, v4)]
            o = F.scaled_dot_product_attention(*xs, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(o, xs, torch.ones_like(o))
        rows.append(_grad_row(
            f"chunk_prefill_attention gradient [{tag}]",
            lambda q, kp, vp: kag.chunk_prefill_attention(q, kp, vp, tbl, 0),
            lambda q, kp, vp: k2.chunk_prefill_attention_plain(q, kp, vp, tbl, 0),
            (q, kp, vp), (True, True, True), tol=TOL["bfloat16"], dtype="bfloat16",
            work=((4 * S * H * D + 4 * S * Hkv * D) * 2, 12 * pairs * H * D, pairs * H),
            library=sdpa, library_call="F.scaled_dot_product_attention(is_causal=True, "
            "enable_gqa=True) forward and backward over the same K/V in (1, H, S, D)",
            source="src/repro_torch/kernels/csrc/chunk_prefill_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:86 (causal)",
            launches=launches["K2"] if tag == "train" else 0,
            shape=f"q({S}, {H}, {D}) over a {S}-position row, pages of {ps}, bf16"))
    for B, Sq, Skv in ((1, 1500, 1500), (4, 128, 1500)):
        q, k, v = r(B, Sq, 16, 64), r(B, Skv, 16, 64), r(B, Skv, 16, 64)
        route = k2.bidirectional_route(bf, B, Sq, 16, 16, 64)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(qt=qt, kt=kt, vt=vt):
            xs = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            o = F.scaled_dot_product_attention(*xs)
            return torch.autograd.grad(o, xs, torch.ones_like(o))
        rows.append(_grad_row(
            f"bidirectional_attention gradient [{route}]",
            lambda q, k, v: kag.bidirectional_attention(q, k, v, Skv),
            lambda q, k, v: k2.bidirectional_attention_plain(q, k, v, Skv),
            (q, k, v), (True, True, True), tol=TOL["bfloat16"], dtype="bfloat16",
            work=((4 * B * Sq * 16 * 64 + 4 * B * Skv * 16 * 64) * 2,
                  12 * B * Sq * Skv * 16 * 64, B * Sq * Skv * 16),
            library=sdpa, library_call="F.scaled_dot_product_attention forward and "
            "backward over the same K/V in (B, H, S, D), no mask",
            source="src/repro_torch/kernels/csrc/" + (
                "bidirectional_attention_sm90.cu" if route == "sm90"
                else "bidirectional_attention.cu"),
            replaces="src/repro/kernels/flash_attention.py:86 (causal=False)",
            launches=launches["K2nc"], kernel_route=route,
            shape=f"q{tuple(q.shape)} k/v{tuple(k.shape)} bf16"))
    T = TRAIN_BATCH * TRAIN_SEQ
    for E, k in ((64, 6), (8, 2)):
        C = _k6_cap(T, k, E)
        rows.append(_grad_row(
            f"moe_gating gradient [E {E}, k {k}]",
            lambda logits: kag.moe_gating(logits, k, C),
            lambda logits: k6.moe_gating_plain(logits, k, C),
            (r(T, E, scale=0.9),), (True,), tol=K6_TOL, dtype="float32",
            work=(T * E * 2 * 2 + T * k * (4 + 4 + 8 + 4) * 2, T * E * (3 + k) * 3, T * E),
            source="src/repro_torch/kernels/csrc/moe_gating.cu",
            replaces="src/repro/kernels/moe_gating.py:55", launches=launches["K6"],
            shape=f"logits ({T}, {E}) bf16, k {k}, C {C}"))
    B, S, di, N = 1, DEEP_CHUNK, 8192, 16
    args = (r(B, S, di, scale=0.5), F.softplus(r(B, S, di, dtype=torch.float32) - 1).to(bf),
            -torch.exp(r(di, N, scale=0.3, dtype=torch.float32)), r(B, S, N, scale=0.5),
            r(B, S, N, scale=0.5), torch.ones(di, device="cuda", dtype=bf))
    nbytes, flops, exps = _k7_work(args[0], N, None, None)
    rows.append(_grad_row(
        "ssm_scan gradient", lambda *a: kag.ssm_scan(*a), lambda *a: k7.ssm_scan_plain(*a),
        args, (True,) * 6, tol=TOL["bfloat16"], dtype="float32",
        work=(2 * nbytes, 3 * flops, exps),
        source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:68", launches=launches["K7"],
        shape=f"x({B}, {S}, {di}) N {N} bf16, from a zero state"))
    return rows


class _Scripted:
    """Drafter proposing each request's known greedy continuation (the
    off mode's tokens) with every token from index `good` on corrupted, so
    every round accepts some drafts and rolls the rest back: the Mamba1
    state is restored from a checkpoint past the first position."""

    def __init__(self, truth: dict, good: int, vocab: int):
        self.truth, self.good, self.vocab = truth, good, vocab

    def on_insert(self, slot, req):
        pass

    def on_free(self, slot):
        pass

    def draft_round(self, reqs, k_eff):
        out = {}
        for slot, req in reqs.items():
            d = self.truth[req.rid][len(req.out):][: k_eff.get(slot, 0)]
            out[slot] = [t if i < self.good else (t + 1) % self.vocab for i, t in enumerate(d)]
        return out


def _tier_modes(seed: int, corpus, device) -> dict:
    """The serving tier's three reference modes on one device, SMOKE
    qwen2.5-3b (vocab lm_data.VOCAB, float32, weights from --seed on the
    CPU): the two-tenant frontend over two replicas; cascade="on" with
    bench_cascade's cheap tier from --seed + 1; and one update and one
    delete between two queries on a live corpus, with the spec settings,
    document-first escalation and one explicit doc-first escalation of
    the document deleted. Returns what each mode served and counted."""
    import dataclasses

    import torch
    from repro_torch import core
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_data
    from repro_torch.live import render_edit
    from repro_torch.models import init_params

    cfg = get_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB)
    params = _to(init_params(cfg, torch.Generator().manual_seed(seed), device="cpu"), device)
    out = {}

    session, group, frontend, extractor, _ = _frontend_stack(cfg, params, corpus, device, 6)
    results = _run_tenants(session)
    out["frontend"] = ([r.rows for r in results], [_ledger(r) for r in results],
                       session.tenant_costs(), dict(group.stats),
                       [dict(e.stats) for e in group.engines], dict(frontend.stats),
                       frontend.tenant_snapshot(), dataclasses.asdict(extractor.stats),
                       {r: q.out for r, q in group.finished.items()})

    scfg = _small_cfg(cfg)
    sparams = _to(init_params(scfg, torch.Generator().manual_seed(seed + 1), device="cpu"),
                  device)
    session, engine, small_engine, extractor = _cascade_session(
        cfg, params, (scfg, sparams), corpus, device, "on", max_new=6, page_size=16,
        chunk_size=32)
    res = session.execute(_legal_query(core))
    out["cascade_on"] = (res.rows, session.ledger.snapshot(),
                         dataclasses.asdict(extractor.stats), dict(engine.stats),
                         dict(small_engine.stats),
                         {r: q.out for r, q in engine.finished.items()},
                         {r: q.out for r, q in small_engine.finished.items()})

    ids = sorted(corpus.docs)
    live_corpus = corpus.subset(ids)
    live_corpus.docs = {d: type(doc)(doc.doc_id, doc.domain, doc.text, dict(doc.truth),
                                     dict(doc.spans), doc.tokens, version=doc.version,
                                     sha=doc.sha)
                        for d, doc in live_corpus.docs.items()}
    live, retriever, engine, extractor, session, _, _ = _live_stack(
        cfg, params, live_corpus, device, 6, **SPEC)
    first = session.execute(_legal_query(core))
    session.update(ids[0], render_edit(live, ids[0], "year", 2012))
    text = live.docs[ids[1]].text[:400]
    escalated = extractor.escalate_batch([(ids[1], "year", [text]),
                                          (ids[1], "charges", [text])])
    free_before = engine.alloc.free_pages
    session.delete(ids[1])
    freed = engine.alloc.free_pages - free_before
    second = session.execute(_legal_query(core))
    out["live"] = ([first.rows, second.rows], [_ledger(first), _ledger(second)],
                   dict(engine.stats), engine.prefix_cache.stats.snapshot(),
                   dict(session.live_stats), dataclasses.asdict(session.cascade.stats),
                   live.stats.snapshot(), escalated, freed,
                   {r: q.out for r, q in engine.finished.items()})
    return out


# The reference phase's CPU half runs in a process of its own, started
# after the build, beside the card's phases (its models are small: their
# host time is what it costs), with this many torch threads of the
# machine's cores; the card's half runs in the reference phase itself.
CPU_REFERENCE_THREADS = 2
MOE_ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b")
# SMOKE whisper-medium's decoder position table has 256 rows, while the
# legal prompts run past 256 positions and the engine's max_len is 1,024.
# Past the table the JAX model clips a chunk's positions, clamps a scalar
# decode position, and reads NaN for a per-row decode position; a slab
# prompt longer than the table cannot be prefilled at all. A slot that is
# not live keeps advancing its position in plain decode steps, so its
# NaN K/V would reach the sink page, which the CPU's plain attention
# multiplies by zero probabilities (NaN) and the kernels never read. The
# reference modes therefore run whisper with a table of REF_WHISPER_POSITIONS
# rows, past every position a row reaches there; tests/test_torch_whisper.py
# holds the behaviour past the table against the JAX package.
REF_WHISPER_POSITIONS = 4096


def _reference_models() -> dict:
    """The reference phase's models and their modes' engine options."""
    slab = {**SLAB, "prefix_cache": True}
    rollback = {"prefix_cache": True, "spec_k": 4}
    draft = {"spec_decode": "draft", "spec_k": 4}
    return {"qwen2.5-3b": {"off": {}, "spec": SPEC, "slab": slab, "draft": draft,
                           "off_few": {}},
            "falcon-mamba-7b": {"off": {}, "spec": SPEC, "slab": slab, "rollback": rollback},
            "deepseek-v2-lite-16b": {"off": {}, "spec": SPEC, "slab": slab, "draft": draft},
            "llava-next-mistral-7b": {"off": {}, "spec": SPEC, "slab": slab},
            **{arch: {"spec": SPEC} for arch in DENSE_FAMILY + (DENSE_MLA,)},
            "grok-1-314b": {"off": {}, "spec": SPEC, "slab": slab},
            "zamba2-2.7b": {"off": {}, "spec": SPEC, "slab": slab, "rollback": rollback},
            "whisper-medium": {"off": {}, "spec": SPEC, "slab": slab}}


def _reference_docs(arch: str, mode: str) -> int:
    """How many of the legal corpus's first documents a mode serves:
    REF_SLAB_DOCS for every slab mode and qwen2.5-3b's "off_few" (the slab
    modes' plain rows), REF_NEW_DOCS for every other mode (the first three
    models' served 20 until the mesh phases' family runs needed the time,
    and 10 until the mesh training runs did)."""
    if mode in ("slab", "off_few"):
        return REF_SLAB_DOCS
    return REF_NEW_DOCS


def reference_runs(seed: int, device: str) -> dict:
    """Every reference mode on one device, and the serving tier's three:
    what each served and counted (the card runs grok-1-314b's prompt-lookup
    mode a second time, "spec again"). Returns runs, states, grok's pools,
    K6 launches and seconds, keyed by (arch, mode)."""
    import torch
    from repro_torch import core
    from repro_torch.data import lm_data
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.models import init_params

    full = make_legal_corpus(seed=1)
    docs = {n: full.subset(sorted(full.docs)[:n]) for n in (REF_NEW_DOCS, REF_SLAB_DOCS)}
    runs, states, pools, gating, seconds = {}, {}, {}, {}, {}
    for arch, modes in _reference_models().items():
        cfg = _smoke_config(arch).replace(vocab_size=lm_data.VOCAB)
        if cfg.family == "encdec":
            cfg = cfg.replace(max_position=REF_WHISPER_POSITIONS)
        gen = torch.Generator().manual_seed(seed)
        cpu_params = init_params(cfg, gen, device="cpu")
        if cfg.qk_norm:
            for lp in cpu_params["layers"]:
                for name in ("q_norm", "k_norm"):
                    lp["attn"][name] = 1 + 0.5 * torch.randn(lp["attn"][name].shape,
                                                             generator=gen)
        params = _to(cpu_params, device)
        for mode, engine_kw in modes.items():
            tags = [mode, "spec again"] if (arch, mode, device) == \
                ("grok-1-314b", "spec", "cuda") else [mode]
            for tag in tags:
                t0 = time.perf_counter()
                kw = dict(engine_kw)
                if mode == "draft":
                    kw["draft_model"] = (cfg, params)
                if mode == "rollback":
                    kw["spec_decode"] = _Scripted(runs[arch, "off"][5], good=2,
                                                  vocab=cfg.vocab_size)
                session, engine, _, _ = _served_query(
                    cfg, params, docs[_reference_docs(arch, mode)], device, max_new=6, **kw)
                k6.launches = 0
                res = session.prepare(_legal_query(core)).submit().result()
                gating[arch, tag] = k6.launches
                runs[arch, tag] = (
                    res.rows, res.ledger.input_tokens, res.ledger.output_tokens,
                    res.ledger.per_phase, dict(engine.stats),
                    {r: q.out for r, q in engine.finished.items()},
                    dict(getattr(engine.drafter, "stats", {})),
                    {tuple(q.prompt): q.out for q in engine.finished.values()})
                if "ssm" in engine.cache:
                    states[arch, tag] = {k: engine.cache[k].cpu() for k in ("conv", "ssm")}
                if "ck" in engine.cache:                # the slots' cross K/V
                    states[arch, tag] = {k: engine.cache[k].cpu() for k in ("ck", "cv")}
                    runs[arch, tag] += ((max(len(q.prompt) + len(q.out)
                                             for q in engine.finished.values()),
                                         int(engine._pos_h.max())),)
                if arch == "grok-1-314b" and engine.paged:
                    n = engine.alloc.num_pages
                    pools[tag] = {k: p[:, :n].cpu() for k, p in engine.alloc.pools.items()}
                seconds[f"{arch}/{tag}/{device}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    training = training_runs(seed, device)
    seconds[f"training/{device}"] = time.perf_counter() - t0
    return {"runs": runs, "states": states, "pools": pools, "gating": gating,
            "seconds": seconds, "tier": _tier_modes(seed, docs[REF_NEW_DOCS], device),
            "training": training}


# The reference phase's training modes: each family's SMOKE config in
# float32 (the test batch of tests/test_torch_train_forward.py: 2 rows of
# 16 tokens, seeded image embeddings or frames), two steps of
# `make_train_step` at this lr; qwen2.5-3b also with Adafactor and 8-bit
# Adam (q_block 32, so that its stacked norms are quantized).
TRAIN_REF_ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "grok-1-314b", "falcon-mamba-7b",
                   "zamba2-2.7b", "llava-next-mistral-7b", "whisper-medium", DENSE_MLA)
TRAIN_REF_OPT = {"lr": 1e-3, "warmup_steps": 1}
TRAIN_REF_EXTRA = {"adafactor": {"name": "adafactor"},
                   "adam8bit": {"name": "adam8bit", "q_block": 32}}
# deepseek-v2-lite-16b's grouped mode: AdamW under set_moe_groups(
# GROUPED_GROUPS), K6's grouped launch on the card
GROUPED_MODE, GROUPED_GROUPS = "adamw grouped", 2
# the kernels each family's training forward must launch on the card (dense
# MLA none: its attention is plain PyTorch)
TRAIN_REF_KERNELS = {"qwen2.5-3b": ("K2",), "deepseek-v2-lite-16b": ("K6",),
                     "grok-1-314b": ("K2", "K6"), "falcon-mamba-7b": ("K7",),
                     "zamba2-2.7b": ("K2",), "llava-next-mistral-7b": ("K2",),
                     "whisper-medium": ("K2", "K2nc"), DENSE_MLA: ()}
# card against CPU, float32: the loss, its parts and each step's loss and
# gradient norm relative, each gradient tensor relative to its largest
# value, a parameter in the allclose form |a - b| / (1 + |b|): 10% of one
# step's lr (a wrong gradient moves an entry by ~lr; the optimizers divide
# by running scales that magnify the devices' ~1e-6 gradient noise, seen
# up to 2.4e-5), where the first step's gradient is not within its noise
# of 0 (there the first Adam step may go +lr on one device and -lr on the
# other: held to 2 lr a step)
TRAIN_REF_TOL = {"loss": 1e-5, "grad": 1e-4, "param": 1e-4, "near_zero": 1e-4}


def _train_ref_batch(cfg, seed: int) -> dict:
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (2, cfg.n_image_tokens, 1024)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def training_runs(seed: int, device: str) -> dict:
    """The training modes on one device: for each (arch, optimizer) the
    first step's loss and gradients, then two train steps' losses and
    gradient norms and the parameters after each step, and the kernels the two steps launched;
    deepseek-v2-lite-16b also under set_moe_groups(GROUPED_GROUPS) (K6's
    grouped launch); on the card also the crash-resume check
    (`_crash_resume`, its crash written from a 1x1 mesh too)."""
    from repro_torch.models import layers

    out = {}
    for arch in TRAIN_REF_ARCHS:
        cfg = _smoke_config(arch)
        opts = ("adamw", "adafactor", "adam8bit") if arch == "qwen2.5-3b" else \
            ("adamw", GROUPED_MODE) if arch == "deepseek-v2-lite-16b" else ("adamw",)
        for opt in opts:
            layers.set_moe_groups(GROUPED_GROUPS if opt == GROUPED_MODE else 0)
            try:
                out[arch, opt] = _training_mode(cfg, opt, seed, device)
            finally:
                layers.set_moe_groups(0)
    return {"modes": out, "crash_resume": _crash_resume(device) if device == "cuda" else None}


def _training_mode(cfg, opt: str, seed: int, device: str) -> dict:
    """One training mode of `training_runs`."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.training import OptConfig, make_loss_fn, make_train_step
    from repro_torch.tree import flat

    params = _to(init_params(cfg, torch.Generator().manual_seed(seed), device="cpu",
                             dtype=torch.float32), device)
    init_fn, step = make_train_step(
        cfg, OptConfig(**TRAIN_REF_OPT, **TRAIN_REF_EXTRA.get(opt, {})), remat=False)
    state = init_fn(params)
    batch = _train_ref_batch(cfg, seed)
    leaves = flat(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, parts = make_loss_fn(cfg, remat=False)(
        params, {k: torch.as_tensor(v, device=device) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    _zero_launches()
    steps, after = [], []
    for _ in range(2):
        params, state, metrics = step(params, state, batch)
        steps += [float(metrics["loss"]), float(metrics["grad_norm"])]
        # a copy: the next step writes the parameters in place
        after.append([t.detach().to("cpu", copy=True) for t in flat(params)])
    return {"loss": loss.item(), "ce": parts["ce"].item(),
            "aux": parts["aux"].item(), "steps": steps,
            "grads": [g.cpu() for g in grads], "params": after,
            "launches": _launch_counts()}


def _crash_resume(device: str) -> dict:
    """tests/test_runtime.py's crash-resume check with the port's Trainer
    on `device`: SMOKE qwen2.5-3b on the byte vocabulary, 12 steps with a
    checkpoint every 4 straight through, then a run that crashes at step 6
    and a third trainer that resumes from its step-4 checkpoint and runs to
    12: its losses must equal the first run's steps 5-12 bit for bit. The
    same with the crash on a 1x1 NCCL mesh (`Trainer(mesh=)`, its
    checkpoint the global arrays) resumed on the card alone: at group size
    1 the mesh step is one card's arithmetic, so bit for bit too."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_data
    from repro_torch.data.corpus import make_swde_corpus
    from repro_torch.training import OptConfig, Trainer, TrainerConfig

    cfg = get_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB)
    stream = lm_data.corpus_token_stream(make_swde_corpus())
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))

    def trainer(name, mesh=None):
        kw = {"device": device} if mesh is None else {"mesh": mesh}
        return Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=2),
                       lm_data.LMBatches(stream, batch=2, seq=16),
                       TrainerConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(root / name),
                                     seed=0, log_every=100), **kw)
    a = trainer("a")
    a.init()
    straight = a.run()
    out = {"straight": straight[4:]}
    for name in ("b", "mesh"):
        if name == "mesh":
            # the crash on a 1x1 NCCL mesh: its step-4 checkpoint holds the
            # global arrays, gathered and written by rank 0
            with _nccl_mesh(None) as (mesh, _):
                crashed = _crash(trainer(name, mesh))
        else:
            crashed = _crash(trainer(name))
        if not crashed:
            raise AssertionError(f"crash-resume ({name}): the injected failure did not fire")
        resumed = trainer(name)            # on the card alone
        resumed.init()
        if not resumed.resume() or resumed.step != 4:
            raise AssertionError(f"crash-resume ({name}): resumed at step {resumed.step}, "
                                 f"want 4")
        out["resumed" if name == "b" else "resumed_from_the_mesh"] = resumed.run()
    return out


def _crash(t) -> bool:
    """Run trainer t to its injected failure at step 6; whether it fired."""
    from repro_torch.training import CrashInjected
    t.init()
    try:
        t.run(failure_at=6)
    except CrashInjected:
        t.ckpt.wait()
        return True
    return False


def _check_training(training: dict, crash: dict) -> None:
    """Raise unless every training mode is within TRAIN_REF_TOL, each
    family launched its kernels on the card (qwen2.5-3b's K2 once a layer
    a row a step: 2 x 2 x 2) and crash-resume repeated the losses."""
    from repro_torch.configs import get_smoke_config
    bad = {k: e for k, e in training.items()
           if not (e["loss"] <= TRAIN_REF_TOL["loss"] and e["grad"] <= TRAIN_REF_TOL["grad"]
                   and e["param"] <= TRAIN_REF_TOL["param"]
                   and e["param_near_zero_in_steps"] <= 1.01)}
    if bad:
        raise AssertionError(f"training on the card differs from the CPU's: {bad}")
    missing = {a: TRAIN_REF_KERNELS[a] for a in TRAIN_REF_ARCHS
               if not all(training[f"{a}/adamw"]["launches"].get(k)
                          for k in TRAIN_REF_KERNELS[a])}
    qwen_k2 = training["qwen2.5-3b/adamw"]["launches"].get("K2")
    if missing or qwen_k2 != get_smoke_config("qwen2.5-3b").num_layers * 2 * 2:
        raise AssertionError(f"training did not launch its kernels on the card: {missing}, "
                             f"qwen2.5-3b's K2 {qwen_k2}")
    if not crash["straight"] == crash["resumed"] == crash["resumed_from_the_mesh"]:
        raise AssertionError(f"crash-resume on the card is not bit for bit: {crash}")
    grouped = training[f"deepseek-v2-lite-16b/{GROUPED_MODE}"]
    if not grouped["launches"].get("K6_grouped") or grouped["aux"] != 0.0:
        raise AssertionError(f"the grouped mode did not launch K6's grouped form on the card "
                             f"or its aux is not 0: {grouped}")


def _compare_training(card: dict, cpu: dict) -> dict:
    """The training modes' errors, card against CPU (`TRAIN_REF_TOL`);
    8-bit Adam's parameters only after its first step: its second divides
    by moments rebuilt from int8 codes, which the two devices may round to
    neighbouring codes, and a second moment quantized to 0 leaves the step
    ill-conditioned (tests/test_torch_training.py holds it against the JAX
    package step by step)."""
    out = {}
    for key, want in cpu.items():
        got = card[key]
        loss = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-6)
                   for k in ("loss", "ce"))
        loss = max([loss] + [abs(a - b) / abs(b) for a, b in zip(got["steps"],
                                                                  want["steps"])])
        grad = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(got["grads"], want["grads"]))
        steps = 1 if key[1] == "adam8bit" else 2
        param = loose = 0.0
        for i in range(steps):
            for a, b, g in zip(got["params"][i], want["params"][i], want["grads"]):
                err = (a - b).abs() / (1 + b.abs())
                near = g.abs() <= TRAIN_REF_TOL["near_zero"] * g.abs().max()
                param = max(param, float(err[~near].max()) if (~near).any() else 0.0)
                loose = max(loose, float(err.max()) / (2 * TRAIN_REF_OPT["lr"] * (i + 1)))
        out["/".join(key)] = {"loss": loss, "grad": grad, "param": param,
                              "param_near_zero_in_steps": loose,
                              "aux": got["aux"], "launches": {
                                  k: n for k, n in got["launches"].items() if n}}
    return out


class _Array:
    """A tensor's values as a numpy array, marked, so that a result tree
    crosses a process boundary by plain pickling, not by torch's
    shared-memory handles (which die with the process that sent them)."""

    def __init__(self, array):
        self.array = array


def _arrays(tree, back: bool = False):
    """A result tree with its tensors as `_Array`s (back=True: the reverse)."""
    import torch
    if isinstance(tree, dict):
        return {k: _arrays(v, back) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_arrays(v, back) for v in tree]
    if isinstance(tree, tuple):
        items = [_arrays(v, back) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if back and isinstance(tree, _Array):
        return torch.from_numpy(tree.array)
    return _Array(tree.numpy()) if torch.is_tensor(tree) else tree


def _cpu_reference_child(seed: int, queue) -> None:
    import torch
    torch.set_num_threads(CPU_REFERENCE_THREADS)
    try:
        queue.put(("ok", _arrays(reference_runs(seed, "cpu"))))
    except Exception:
        queue.put(("error", traceback.format_exc()))


class _CpuReference:
    """The reference phase's CPU half in a spawned process that sees no
    CUDA device; `result()` waits for it, `close()` ends it."""

    def __init__(self, seed: int):
        import multiprocessing
        import os
        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        self.proc = ctx.Process(target=_cpu_reference_child, args=(seed, self.queue),
                                daemon=True)
        old = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            self.proc.start()
        finally:
            if old is None:
                del os.environ["CUDA_VISIBLE_DEVICES"]
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = old

    def result(self) -> dict:
        status, payload = self.queue.get()
        self.proc.join()
        if status != "ok":
            raise RuntimeError(f"the reference phase's CPU half failed:\n{payload}")
        return _arrays(payload, back=True)

    def close(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()


def phase_reference(seed: int, cpu_half) -> dict:
    """The served path at a small size, card against the CPU's plain path:
    qwen2.5-3b in four modes (off, prompt lookup with the prefix cache, the
    slab layout with the prefix cache, self-drafting), falcon-mamba-7b
    in four (off, prompt lookup with the prefix cache, slab with the prefix
    cache, and scripted drafts that accept two of four, so that rejected
    drafts roll back to a checkpoint past the first position),
    deepseek-v2-lite-16b in four (qwen2.5-3b's modes; K6 gates every MoE
    layer on the card), llava-next-mistral-7b in three (off, prompt lookup
    with the prefix cache, slab with the prefix cache: the image prefix
    through each layout), qwen3-32b (random q/k-norm weights: ones would
    hide a norm on the wrong axis), nemotron-4-15b and deepseek-67b with
    prompt lookup and the prefix cache, grok-1-314b in three (off, prompt
    lookup with the prefix cache, slab with the prefix cache),
    zamba2-2.7b in falcon-mamba-7b's four and whisper-medium in grok's
    three (with REF_WHISPER_POSITIONS learned positions). Every slab mode
    runs on the first REF_SLAB_DOCS documents, beside qwen2.5-3b's plain
    mode there ("off_few"), every other mode, the serving tier's three too,
    on the first REF_NEW_DOCS. Falcon-mamba-7b's and zamba2-2.7b's per-slot
    recurrent state, and whisper-medium's per-slot cross K/V, after the
    query must also agree across the devices to STATE_TOL:
    with random SMOKE weights the skip path D * x dominates each block, so
    their tokens alone say little about the state. grok-1-314b's K/V pools,
    the sink page included, must agree across the devices to TOL, and its
    prompt-lookup mode runs twice on the card with bit-identical pools: the
    sink's write does not depend on the order the card runs it in. The
    card's half runs here; `cpu_half` (`_CpuReference`) ran the CPU's
    beside the card's earlier phases. The training modes (`training_runs`):
    each family's SMOKE config, the first step's loss and gradients and the
    parameters after two AdamW steps (qwen2.5-3b also Adafactor and 8-bit
    Adam) within TRAIN_REF_TOL of the CPU's, the family's kernels launched
    on the card (`TRAIN_REF_KERNELS`), and crash-resume on the card bit for
    bit (`_crash_resume`)."""
    import torch

    card, cpu = reference_runs(seed, "cuda"), cpu_half.result()
    models = _reference_models()
    moe_archs = MOE_ARCHS
    halves = {"cuda": card, "cpu": cpu}
    runs = {(a, m, dev): h["runs"][a, m] for dev, h in halves.items() for a, m in h["runs"]}
    states = {(a, m, dev): h["states"][a, m] for dev, h in halves.items()
              for a, m in h["states"]}
    pools = {(m, dev): h["pools"][m] for dev, h in halves.items() for m in h["pools"]}
    gating = {(a, m, dev): h["gating"][a, m] for dev, h in halves.items()
              for a, m in h["gating"]}
    seconds = {**card["seconds"], **cpu["seconds"]}
    tier = {dev: h["tier"] for dev, h in halves.items()}
    docs = _reference_docs
    keys = [(arch, mode) for arch, modes in models.items() for mode in modes]
    same = {f"{a}/{m}": runs[a, m, "cuda"] == runs[a, m, "cpu"] for a, m in keys}
    same["grok-1-314b/spec again"] = runs["grok-1-314b", "spec again", "cuda"] == \
        runs["grok-1-314b", "spec", "cpu"]
    same.update({f"qwen2.5-3b/{m}": tier["cuda"][m] == tier["cpu"][m] for m in tier["cpu"]})
    # rows and tokens equal the off mode's; for MoE rows only: capacity is
    # set per call, so a verify round of 20 tokens drops assignments that a
    # decode step of 4 never does, and tokens may differ by mode (as in the
    # JAX package); the card must still equal the CPU in every mode. A mode
    # on fewer documents than its off mode holds its rows to the plain rows
    # on its documents (llava's off mode's on REF_NEW_DOCS, qwen2.5-3b's
    # "off_few" on REF_SLAB_DOCS: answers that do not parse take the corpus
    # oracle's), and its tokens to the off mode's for every prompt the two
    # runs share
    plain = {REF_NEW_DOCS: {dev: runs["llava-next-mistral-7b", "off", dev][0]
                            for dev in ("cuda", "cpu")},
             REF_SLAB_DOCS: {dev: runs["qwen2.5-3b", "off_few", dev][0]
                             for dev in ("cuda", "cpu")}}
    plain_small = plain[REF_NEW_DOCS]

    def like_off(a, m, dev):
        off, run = runs[a, "off", dev], runs[a, m, dev]
        if docs(a, m) == docs(a, "off"):
            return (off[0], off[5]) == (run[0], run[5]) if a not in moe_archs else \
                off[0] == run[0]
        shared = set(off[7]) & set(run[7])
        return run[0] == plain[docs(a, m)][dev] and (a in moe_archs or (
            bool(shared) and all(off[7][p] == run[7][p] for p in shared)))
    invariant = {f"{a}/{m}/{dev}": like_off(a, m, dev)
                 for a, m in keys if m != "off" and "off" in models[a]
                 for dev in ("cuda", "cpu")}
    # the dense family's one mode: rows equal the plain mode's on its documents
    invariant.update({f"{a}/spec/{dev}": runs[a, "spec", dev][0] == plain_small[dev]
                      for a in DENSE_FAMILY + (DENSE_MLA,) for dev in ("cuda", "cpu")})
    moe_tokens = {f"{a}/{m}/{dev}": _token_agreement(runs[a, "off", dev][5], runs[a, m, dev][5])
                  for a in moe_archs for m in models[a] if m != "off"
                  and docs(a, m) == docs(a, "off") for dev in ("cuda", "cpu")}
    state_err = {f"{a}/{m}": max(max_err(states[a, m, "cuda"][k], states[a, m, "cpu"][k])
                                 for k in states[a, m, "cpu"])
                 for a, m in keys if (a, m, "cpu") in states}
    pool_err = {m: max(max_err(pools[m, "cuda"][k], pools[m, "cpu"][k]) for k in ("k", "v"))
                for m in models["grok-1-314b"] if (m, "cpu") in pools}
    pools_repeat = all(torch.equal(pools["spec", "cuda"][k], pools["spec again", "cuda"][k])
                       for k in ("k", "v"))
    sink_written = {m: float(pools[m, "cpu"]["k"][:, 0].abs().max())
                    for m in models["grok-1-314b"] if (m, "cpu") in pools}
    st = {f"{a}/{m}": runs[a, m, "cuda"][4] for a, m in keys}
    training = _compare_training(card["training"]["modes"], cpu["training"]["modes"])
    crash = card["training"]["crash_resume"]
    out = {"phase": "reference", "docs": REF_NEW_DOCS,
           "training": training, "training_tol": TRAIN_REF_TOL,
           "crash_resume_on_the_card": crash,
           "cpu_half": f"a spawned process with {CPU_REFERENCE_THREADS} torch threads, "
                       f"beside the card's phases",
           "seconds": seconds,
           "rows": len(runs["qwen2.5-3b", "off", "cpu"][0]),
           "rows_newest_modes": len(plain_small["cpu"]),
           "docs_slab_modes": REF_SLAB_DOCS, "rows_slab_modes": len(plain[REF_SLAB_DOCS]["cpu"]),
           "identical": same, "same_rows_and_tokens_as_off": invariant,
           "moe_token_agreement_with_off": moe_tokens,
           "state_max_abs_err": state_err, "state_tol": STATE_TOL,
           "whisper_position_table": REF_WHISPER_POSITIONS,
           "whisper_longest_sequence_and_last_position": {
               m: runs["whisper-medium", m, "cpu"][8] for m in models["whisper-medium"]},
           "grok_pool_max_abs_err": pool_err, "pool_tol": TOL["float32"],
           "grok_spec_pools_bit_identical_on_the_card": pools_repeat,
           "grok_sink_max_abs": sink_written, "engine": st,
           "drafter": {a: runs[a, "draft", "cuda"][6] for a in models if "draft" in models[a]},
           "k6_launches": {f"{a}/{m}/{dev}": n for (a, m, dev), n in gating.items() if n},
           "serving_tier": {
               "frontend_rows": [len(r) for r in tier["cpu"]["frontend"][0]],
               "frontend_group": tier["cuda"]["frontend"][3],
               "frontend_tenants_ticks": tier["cuda"]["frontend"][6],
               "cascade_on_rows": len(tier["cpu"]["cascade_on"][0]),
               "cascade_on_stats": tier["cuda"]["cascade_on"][2],
               "live_rows": [len(r) for r in tier["cpu"]["live"][0]],
               "live_stats": tier["cuda"]["live"][4],
               "live_pages_freed_by_delete": tier["cuda"]["live"][8]}}
    emit(out)
    if not all(same.values()) or \
            not all(runs[a, "off", "cpu"][0] for a in models if "off" in models[a]) or \
            not plain[REF_SLAB_DOCS]["cpu"]:
        raise AssertionError(f"the card's served query differs from the CPU reference: {same}")
    if not all(invariant.values()):
        raise AssertionError(f"rows or tokens differ from the plain mode: {invariant}")
    fe_rows = tier["cpu"]["frontend"][0]
    if not fe_rows[0] or fe_rows[0] != fe_rows[1] or \
            fe_rows[0] != runs["qwen2.5-3b", "off", "cpu"][0]:
        raise AssertionError("the two tenants' rows differ from each other or from the "
                             "plain mode's")
    if tier["cpu"]["cascade_on"][0] != runs["qwen2.5-3b", "off", "cpu"][0]:
        raise AssertionError("cascade='on' changed the rows of the plain mode")
    if not tier["cpu"]["live"][0][1] or tier["cpu"]["live"][8] <= 0:
        raise AssertionError("the live mode's second query returned no rows or the delete "
                             "returned no prefix page")
    if not all(e <= STATE_TOL for e in state_err.values()):
        raise AssertionError(f"the card's recurrent state differs from the CPU's: {state_err}")
    # the off mode's dead rows write the sink in their decode steps (a
    # verify round's winner may be a block nobody wrote, so spec's may stay 0)
    if not all(e <= TOL["float32"] for e in pool_err.values()) or not pools_repeat or \
            not sink_written["off"] > 0:
        raise AssertionError(f"grok-1-314b's pools: card against CPU {pool_err}, the spec "
                             f"mode's twice on the card bit-identical {pools_repeat}, the "
                             f"sink's largest value {sink_written}")
    for arch in models:
        if st[f"{arch}/spec"]["spec_rounds"] <= 0 or st[f"{arch}/spec"]["prefix_hits"] <= 0:
            raise AssertionError(f"{arch}: the reference spec run had no verify round "
                                 f"or no prefix hit")
        if st[f"{arch}/spec"]["draft_tokens"] <= 0:
            raise AssertionError(f"{arch}: prompt lookup drafted nothing in the reference")
        if "slab" in models[arch] and st[f"{arch}/slab"]["prefix_hits"] <= 0:
            raise AssertionError(f"{arch}: the reference slab run had no prefix hit")
        if "rollback" in models[arch]:
            rb = st[f"{arch}/rollback"]
            if not 0 < rb["accepted_tokens"] < rb["draft_tokens"]:
                raise AssertionError(f"{arch}: the scripted drafts did not roll back in part: "
                                     f"{rb['accepted_tokens']} of {rb['draft_tokens']} "
                                     f"accepted")
    for arch in ("qwen2.5-3b", "deepseek-v2-lite-16b"):
        draft = st[f"{arch}/draft"]
        if draft["spec_rounds"] <= 0 or draft["draft_tokens"] <= 0:
            raise AssertionError(f"{arch}: the reference draft run had no verify round or "
                                 f"no draft")
    _check_training(training, crash)
    on_card = [(a, m, "cuda") for a in moe_archs for m in models[a]]
    if not all(gating[g] > 0 for g in on_card) or \
            any(n for g, n in gating.items() if g not in on_card and g[1] != "spec again"):
        raise AssertionError(f"K6 did not gate every MoE run on the card alone: {gating}")
    return out


# The dry run's cells (`phase_dryrun`): reduced-depth probes at published
# widths, on the (16, 16) production mesh's rank 0.
DRYRUN_CELLS = (("qwen2.5-3b", "decode_32k"), ("qwen2.5-3b", "train_4k"))
DRYRUN_PROBE = 2


class _Child:
    """A child process started now, its output and wall kept when it ends
    (a thread waits on it, so it runs beside the card's phases); `stop_all`
    kills those still running."""
    started: list = []

    def __init__(self, cmd, env=None):
        import threading
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True, env=env)
        _Child.started.append(self)
        self.text, self.wall_s = "", None
        self.thread = threading.Thread(target=self._wait, daemon=True)
        self.thread.start()

    def _wait(self):
        self.text, _ = self.proc.communicate()
        self.wall_s = time.perf_counter() - self.t0

    @classmethod
    def stop_all(cls):
        for child in cls.started:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait()

    def join(self, timeout: float = 600):
        self.thread.join(timeout)
        if self.thread.is_alive():
            self.proc.kill()
            self.thread.join()
            raise AssertionError(f"child {self.proc.args[:4]} did not end in {timeout} s")
        return self


def _child_env(**extra) -> dict:
    import os
    return {**os.environ, "PYTHONPATH": str(SRC), **extra}


def start_dryrun(out_dir) -> list:
    """The dry run's cells, each `python -m repro_torch.launch.dryrun` in a
    child process with no CUDA device visible: its default process group
    is the fake backend's, which must not meet the mesh phases' NCCL
    group."""
    base = Path(out_dir) if out_dir else ROOT / "build"
    base.mkdir(parents=True, exist_ok=True)
    cells = []
    for arch, shape in DRYRUN_CELLS:
        out = base / f"dryrun_{shape}.json"
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single",
               "--arch", arch, "--shape", shape, "--probe", str(DRYRUN_PROBE),
               "--out", str(out)]
        cells.append((f"{arch}|{shape}|single|probe{DRYRUN_PROBE}", out,
                      _Child(cmd, _child_env(CUDA_VISIBLE_DEVICES=""))))
    return cells


def phase_dryrun(cells) -> dict:
    """Each dry-run cell's record: status, flops, collective bytes and
    counts, argument and temp bytes, its seconds and its process's."""
    records = {}
    for key, out, child in cells:
        child.join()
        rec = json.loads(out.read_text()).get(key, {}) if out.exists() else {}
        records[key] = {"status": rec.get("status", "missing"), "rc": child.proc.returncode,
                        "n_devices": rec.get("n_devices"), "rank": rec.get("rank"),
                        "flops": rec.get("cost", {}).get("flops"),
                        "collective_bytes": rec.get("collectives", {}).get("_total"),
                        "collective_counts": rec.get("collectives", {}).get("_counts"),
                        "collective_sites": rec.get("collective_sites"),
                        "temp_bytes": rec.get("memory", {}).get("temp_size_in_bytes"),
                        "argument_bytes": rec.get("memory", {}).get("argument_size_in_bytes"),
                        "run_s": rec.get("run_s"), "process_s": child.wall_s,
                        "error": rec.get("error") or (child.text[-1500:]
                                                      if child.proc.returncode else None)}
    out = {"phase": "dryrun", "mesh": "single: (data 16, model 16), rank 0, fake backend, "
                                      "meta tensors, no CUDA device visible",
           "records": records}
    emit(out)
    bad = {k: r for k, r in records.items() if r["status"] != "ok" or r["rc"] != 0}
    if bad:
        raise AssertionError(f"dry-run cells not ok: {bad}")
    return out


CACHE_CHILD = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.kernels import _build
from repro_torch.launch.compile_cache import compilation_cache_dir, enable_compilation_cache

def no_nvcc():
    raise RuntimeError("nvcc started: the library was not found in the cache")

_build._nvcc = no_nvcc
enabled = enable_compilation_cache({cache!r})
_build.library()
print(json.dumps({{"enabled": enabled, "dir": compilation_cache_dir(),
                  "cached": _build.build_info["cached"],
                  "nvcc_seconds": _build.build_info["seconds"],
                  "library": str(_build.build())}}))
"""


def start_cache_child() -> _Child:
    """A process that enables the compile cache at the build's directory
    and loads the kernel library from it, nvcc made to fail."""
    from repro_torch.kernels import _build
    code = CACHE_CHILD.format(src=str(SRC), cache=str(_build.BUILD_DIR))
    return _Child([sys.executable, "-c", code], _child_env())


def check_cache_child(child: _Child) -> dict:
    from repro_torch.kernels import _build
    child.join(300)
    lines = [ln for ln in child.text.splitlines() if ln.startswith("{")]
    got = json.loads(lines[-1]) if child.proc.returncode == 0 and lines else {}
    out = {"phase": "compile_cache", "dir": str(_build.BUILD_DIR), "rc": child.proc.returncode,
           "process_s": child.wall_s, **got}
    if child.proc.returncode:
        out["error"] = child.text[-1500:]
    emit(out)
    if not got.get("cached") or got.get("dir") != str(_build.BUILD_DIR) or \
            got.get("library") != str(_build.build()):
        raise AssertionError(f"the later process did not load the cached library: {out}")
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# every phase, in the order they run; the device and build phases always run
PHASES = ("main", "spec", "slab", "draft", "frontend", "cascade", "live", "mesh", "train",
          "ssm", "moe", "vlm", "grok", "hybrid", "whisper", "dense_family", "dryrun",
          "kernels", "reference")
# the phases whose results a phase reads: the qwen2.5-3b paths and the
# ssm and moe phases compare with main's rows, draft with slab's tokens,
# and kernels checks the launches the model paths captured
NEEDS = {**{p: ("main",) for p in ("spec", "slab", "frontend", "cascade", "live", "mesh",
                                   "ssm", "moe")},
         "draft": ("main", "slab"),
         "kernels": ("main", "spec", "slab", "draft", "mesh", "train", "ssm", "moe", "vlm",
                     "grok", "hybrid", "whisper")}


def _phases(arg: str) -> set:
    """The named phases and every phase they need."""
    named = {p.strip() for p in arg.split(",") if p.strip()}
    unknown = named - set(PHASES)
    if unknown or not named:
        raise ValueError(f"unknown phases {sorted(unknown)}; choose from {', '.join(PHASES)}")
    for p in list(named):
        named.update(NEEDS.get(p, ()))
    return named


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="weights seed")
    ap.add_argument("--out", default=None, help="directory for the full report")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one extraction round of every path")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run, of " + ", ".join(PHASES) +
                    " (default: all); a phase brings the phases it needs")
    args = ap.parse_args()
    try:
        phases = _phases(args.phases)
    except ValueError as e:
        ap.error(str(e))
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 comparisons in fp32
    torch.backends.cudnn.allow_tf32 = False

    report = {}
    cpu_reference = None
    try:
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        report["device"] = {"phase": "device", "name": kind, "nvidia_smi": smi,
                            "count": torch.cuda.device_count(),
                            "torch": torch.__version__, "cuda": torch.version.cuda}
        emit(report["device"])

        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.library()
        ptxas = [ln.strip() for ln in _build.build_info.get("ptxas", "").splitlines()
                 if "registers" in ln or "spill" in ln]
        report["build"] = {"phase": "build", "seconds": time.perf_counter() - t0,
                           "nvcc_seconds": _build.build_info["seconds"],
                           "cached": _build.build_info["cached"], "ptxas": ptxas[:12],
                           "ptxas_core": core_ptxas(_build.build_info.get("ptxas", ""),
                                                    ("PagedVerify", "DenseDecode",
                                                     "DenseDecodeStats", "Bidirectional")),
                           "ptxas_k2nc_sm90": sm90_ptxas(_build.build_info.get("ptxas", "")),
                           "ptxas_scan": scan_ptxas(_build.build_info.get("ptxas", "")),
                           "ptxas_k3_k6": gating_topk_ptxas(_build.build_info.get("ptxas", ""))}
        emit(report["build"])

        captures: dict = {}
        seconds = {"build": report["build"]["seconds"]}
        cache_child = start_cache_child()
        dryrun_cells = start_dryrun(args.out) if "dryrun" in phases else None
        if "reference" in phases:
            cpu_reference = _CpuReference(args.seed)
        clock = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            seconds[name] = now - clock[0]
            clock[0] = now
        served = {}
        if "main" in phases:
            report["main"], served["main"], main_run = phase_main(args.seed, captures)
            lap("main")
        if "spec" in phases:
            report["spec"], served["spec"] = phase_spec(main_run, captures)
            lap("spec")
        slab_tokens = {}
        if "slab" in phases:
            report["slab"], served["slab"], slab_tokens = phase_slab(main_run, captures)
            lap("slab")
        if "draft" in phases:
            report["draft"], served["draft"] = phase_draft(main_run, captures, slab_tokens)
            lap("draft")
        if args.profile and served:
            for path, served_path in served.items():
                key = "profile" if path == "main" else f"profile_{path}"
                report[key] = phase_profile(*served_path, args.out, path)
            lap("profile")
        served.clear()
        # the serving tier's phases, on the cut qwen2.5-3b weights (not profiled)
        if "frontend" in phases:
            report["frontend"] = phase_frontend(main_run)
            lap("frontend")
        if "cascade" in phases:
            report["cascade"] = phase_cascade(args.seed, main_run)
            lap("cascade")
        if "live" in phases:
            report["live"] = phase_live(main_run)
            lap("live")
        if "mesh" in phases:                # on the cut weights (not profiled)
            report["mesh"] = phase_mesh(args.seed, main_run, args.out)
            lap("mesh")
        main_result = main_run[1] if "main" in phases else None
        # free the qwen2.5-3b weights and engines before falcon-mamba-7b's
        main_run = None
        torch.cuda.empty_cache()
        if "train" in phases:
            report["train"] = phase_train(args.seed, args.profile, args.out)
            lap("train")
        if "ssm" in phases:
            report["ssm"], served_ssm = phase_ssm(args.seed, captures, main_result)
            lap("ssm")
            if args.profile:
                report["profile_ssm"] = phase_profile(*served_ssm, args.out, "ssm")
                lap("profile_ssm")
            # free the falcon-mamba-7b weights before deepseek-v2-lite-16b's
            del served_ssm
            torch.cuda.empty_cache()
        if "moe" in phases:
            report["moe"], served_moe = phase_moe(args.seed, captures, main_result)
            lap("moe")
            if args.profile:
                report["profile_moe"] = phase_profile(*served_moe, args.out, "moe")
                lap("profile_moe")
            del served_moe
            torch.cuda.empty_cache()
        if "vlm" in phases:
            report["vlm"], served_vlm = phase_vlm(args.seed, captures)
            lap("vlm")
            if args.profile:
                report["profile_vlm"] = phase_profile(*served_vlm, args.out, "vlm")
                lap("profile_vlm")
            # free the llava-next-mistral-7b weights before the dense family's
            del served_vlm
            torch.cuda.empty_cache()
        if "grok" in phases:
            report["grok"], served_grok = phase_grok(args.seed, captures)
            lap("grok")
            # free the grok-1-314b weights before zamba2-2.7b's
            del served_grok
            torch.cuda.empty_cache()
        if "hybrid" in phases:
            report["hybrid"], served_hybrid = phase_hybrid(args.seed, captures)
            lap("hybrid")
            if args.profile:
                report["profile_hybrid"] = phase_profile(*served_hybrid, args.out, "hybrid")
                lap("profile_hybrid")
            del served_hybrid
            torch.cuda.empty_cache()
        if "whisper" in phases:             # not profiled, to keep the time limit
            report["whisper"], served_whisper = phase_whisper(args.seed, captures)
            lap("whisper")
            del served_whisper
            torch.cuda.empty_cache()
        if "dense_family" in phases:
            report["dense_family"] = phase_dense_family(args.seed)
            lap("dense_family")
        if "dryrun" in phases:              # its children ran beside the phases above
            report["dryrun"] = phase_dryrun(dryrun_cells)
            lap("dryrun")
        report["compile_cache"] = check_cache_child(cache_child)
        if "kernels" in phases:
            launches = {**report["main"]["launches"], "K4": report["spec"]["launches"]["K4"],
                        "K5": report["draft"]["launches"]["K5"],
                        "K5_slab": report["slab"]["launches"]["K5"],
                        "K5s": sum(n["K5s"] for n in report["mesh"]["launches"].values()),
                        "K2_slab": report["slab"]["launches"]["K2"],
                        "K6_moe": report["moe"]["launches"]["K6"],
                        **{f"{k}_{p}": report[p]["launches"][k]
                           for p in ("grok", "hybrid") for k in ("K2", "K4")},
                        "K6_grok": report["grok"]["launches"]["K6"],
                        "K2nc_whisper": report["whisper"]["launches"]["K2nc"],
                        "K2nc_sm90_whisper": report["whisper"]["launches"]["K2nc_sm90"],
                        "K5_whisper": report["whisper"]["launches"]["K5"],
                        "K7": report["ssm"]["launches"]["K7"],
                        "K2_vlm": report["vlm"]["launches"]["K2"],
                        "K4_vlm": report["vlm"]["launches"]["K4"],
                        "train": report["train"]["launches"]}
            report["kernels"] = phase_kernels(captures, launches)
            lap("kernels")
        if "reference" in phases:
            report["reference"] = phase_reference(args.seed, cpu_reference)
            lap("reference")
            grouped = report["reference"]["training"][
                f"deepseek-v2-lite-16b/{GROUPED_MODE}"]["launches"].get("K6_grouped", 0)
            for row in report.get("kernels", []):
                if row["name"].startswith("moe_gating grouped"):
                    row["launches"] = grouped
        seconds["total"] = time.perf_counter() - t_start
        report["seconds"] = {"phase": "seconds", **seconds}
        emit(report["seconds"])
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        if leaked:
            raise AssertionError(f"JAX or the JAX package was imported: {leaked[:5]}")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        _Child.stop_all()
        if cpu_reference is not None:
            cpu_reference.close()
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            (Path(args.out) / "chip_smoke_report.json").write_text(
                json.dumps(report, indent=1, default=str))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "tol",
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "library_device_ms")
    emit({"kernels": [{k: r.get(k) for k in keys} for r in report.get("kernels", [])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
