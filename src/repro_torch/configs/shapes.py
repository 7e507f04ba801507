"""Assigned input shapes (per-arch applicability rules) — 40 cells total.

LM transformer shapes are seq_len x global_batch. decode_* / long_* lower
`serve_step` (one new token against a KV/state cache of seq_len), NOT
`train_step`. long_500k requires sub-quadratic attention: run for SSM /
hybrid archs, skip (and record the skip) for pure full-attention archs.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped). All 40 cells are reported; skips are
    explicit rows per DESIGN.md §3."""
    if shape_name == "long_500k" and not cfg.is_sub_quadratic:
        return False, ("pure full-attention arch: 524k-token decode KV cache is "
                       "not a sane deployment (skip per assignment; see DESIGN.md)")
    return True, ""
