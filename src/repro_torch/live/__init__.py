"""Live corpus subsystem (DESIGN.md §17): streaming ingestion, incremental
indexing, and exact invalidation over the static QUEST pipeline."""
from .corpus import (LiveCorpus, LiveCorpusStats, edit_span_bytes,
                     render_edit)
from .index import CachedEmbedder, LiveRetriever, clone_embedder
from .invalidate import CascadeStats, InvalidationCascade
from .log import MutationLog, MutationRecord, sha_text
from .session import LiveSession

__all__ = [
    "LiveCorpus", "LiveCorpusStats", "edit_span_bytes", "render_edit",
    "CachedEmbedder", "LiveRetriever", "clone_embedder",
    "CascadeStats", "InvalidationCascade",
    "MutationLog", "MutationRecord", "sha_text",
    "LiveSession",
]
