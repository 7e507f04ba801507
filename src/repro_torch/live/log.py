"""Versioned mutation log + content-hash manifest (DESIGN.md §17).

Every live-corpus mutation appends one `MutationRecord` carrying the
document's new `(version, sha)` and the payload needed to replay it, so a
dynamic run is an audit trail: `MutationLog.replay(corpus)` re-applies the
stream against a fresh snapshot and must land on the same manifest digest.
The manifest (`doc_id -> (version, sha)`) is the ground truth every cache
layer stamps against — an entry keyed to a stale `(doc_id, version)` is
invalid by construction, no content comparison needed.

The sha is over document *text* (blake2b-128): unchanged text hashes
identically across mutations, which is exactly the key the incremental
index uses to keep embeddings for untouched segments/sentences.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import Optional


def sha_text(text: str) -> str:
    """Content hash of a document/segment/sentence text (blake2b-128)."""
    return hashlib.blake2b(text.encode("utf-8"), digest_size=16).hexdigest()


@dataclass
class MutationRecord:
    seq: int                       # monotone log sequence number (from 1)
    op: str                        # 'ingest' | 'update' | 'delete'
    doc_id: str
    version: int                   # doc version after the op (delete: last)
    sha: str                       # content hash after the op (delete: "")
    n_bytes: int = 0               # len of the new text ("" for delete)
    domain: str = ""               # ingest payload
    text: Optional[str] = None     # ingest/update payload (replayability)
    truth: Optional[dict] = None   # explicit truth override, when given
    spans: Optional[dict] = None   # explicit span override, when given

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "MutationRecord":
        return cls(**json.loads(line))


@dataclass
class MutationLog:
    """Append-only record stream + the manifest it induces."""

    records: list = field(default_factory=list)
    manifest: dict = field(default_factory=dict)   # doc_id -> (version, sha)

    @property
    def seq(self) -> int:
        return self.records[-1].seq if self.records else 0

    def __len__(self) -> int:
        return len(self.records)

    def append(self, op: str, doc_id: str, version: int, sha: str, *,
               n_bytes: int = 0, domain: str = "", text: Optional[str] = None,
               truth: Optional[dict] = None,
               spans: Optional[dict] = None) -> MutationRecord:
        rec = MutationRecord(self.seq + 1, op, doc_id, version, sha,
                             n_bytes=n_bytes, domain=domain, text=text,
                             truth=truth, spans=spans)
        self.records.append(rec)
        if op == "delete":
            self.manifest.pop(doc_id, None)
        else:
            self.manifest[doc_id] = (version, sha)
        return rec

    def digest(self) -> str:
        """Chained hash over the record stream — two logs with the same
        digest describe byte-identical mutation histories."""
        h = hashlib.blake2b(digest_size=16)
        for rec in self.records:
            h.update(rec.to_json().encode("utf-8"))
        return h.hexdigest()

    def manifest_digest(self) -> str:
        """Hash of the *current* manifest only (order-independent): two
        corpora with equal manifest digests hold identical doc contents."""
        h = hashlib.blake2b(digest_size=16)
        for doc_id in sorted(self.manifest):
            v, s = self.manifest[doc_id]
            h.update(f"{doc_id}:{v}:{s}\n".encode("utf-8"))
        return h.hexdigest()

    # ----------------------------------------------------- serialization --

    def to_jsonl(self) -> str:
        return "\n".join(rec.to_json() for rec in self.records)

    @classmethod
    def from_jsonl(cls, blob: str) -> "MutationLog":
        log = cls()
        for line in blob.splitlines():
            if not line.strip():
                continue
            rec = MutationRecord.from_json(line)
            log.records.append(rec)
            if rec.op == "delete":
                log.manifest.pop(rec.doc_id, None)
            else:
                log.manifest[rec.doc_id] = (rec.version, rec.sha)
        return log

    def replay(self, live_corpus) -> None:
        """Re-apply the recorded stream against `live_corpus` (a fresh
        `LiveCorpus` over the same seed snapshot). The caller can then
        compare `manifest_digest()` — audit-log replayability."""
        for rec in self.records:
            if rec.op == "ingest":
                live_corpus.ingest(rec.doc_id, rec.text, rec.domain,
                                   truth=rec.truth, spans=rec.spans)
            elif rec.op == "update":
                live_corpus.update(rec.doc_id, rec.text,
                                   truth=rec.truth, spans=rec.spans)
            else:
                live_corpus.delete(rec.doc_id)
