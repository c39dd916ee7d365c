"""Checkpoint/resume for long device searches (the JAX package's
``checker/checkpoint.py``, file for file).

The whole search state is one dense frontier plus a few counters, so a
snapshot is a single ``.npz`` write, and resuming is the capacity-escalation
path the search already runs.  The file format is the JAX engine's: the
frontier in its dtypes (counts i32, tail/hi/lo u32, tok i32, valid bool),
the stream hash split into ``hi``/``lo`` words, and the same JSON ``meta``
record, so a snapshot written by either engine resumes in the other.

A checkpoint is bound to its history by a fingerprint over the encoded
arrays, equal to the JAX engine's for the same history; resuming against a
different history raises :class:`CheckpointError`.  Writes are atomic (tmp +
rename), so a crash mid-write never corrupts the previous snapshot.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import zipfile
from dataclasses import dataclass

import numpy as np

from ..models.encode import EncodedHistory

__all__ = [
    "ENCODING_FORMAT",
    "history_fingerprint",
    "fingerprint_mismatch_reason",
    "save_checkpoint",
    "load_checkpoint",
    "Checkpoint",
    "CheckpointError",
]

_FORMAT = 2  # v2: per-state frontier rows (no svalid / state-slot axis)


class CheckpointError(ValueError):
    """A snapshot is unreadable or does not belong to this search."""


#: The encoder's array-layout tag: a checkpoint from another layout fails
#: with an accurate message, not "different history".
ENCODING_FORMAT = "v3-bucketed"

#: the encoded arrays the fingerprint covers, in hashing order
_FINGERPRINT_FIELDS = (
    "op_type",
    "has_set_token",
    "set_token",
    "has_batch_token",
    "batch_token",
    "has_match",
    "match_seq",
    "num_records",
    "rh_row",
    "rh_len",
    "out_failure",
    "out_definite",
    "out_tail",
    "out_has_hash",
    "out_hash_hi",
    "out_hash_lo",
    "call",
    "ret",
    "chain_of",
    "rh_hi",
    "rh_lo",
    "chain_ops",
    "chain_len",
    "chain_start",
)


def history_fingerprint(enc: EncodedHistory) -> str:
    """Stable digest of everything the search semantics depend on,
    prefixed with the encoding-format tag so that stale-format snapshots
    are told apart from different-history ones."""
    h = hashlib.sha256()
    h.update(ENCODING_FORMAT.encode())
    for name in _FINGERPRINT_FIELDS:
        arr = np.ascontiguousarray(getattr(enc, name))
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    for s in sorted(enc.init_states):
        h.update(repr(s).encode())
    return f"{ENCODING_FORMAT}:{h.hexdigest()}"


def fingerprint_mismatch_reason(saved: str, current: str) -> str:
    """Why a fingerprint does not match: a snapshot from an older encoding
    format (a bare hex digest before the tag) is stale, not 'a different
    history'."""
    saved_fmt = saved.split(":", 1)[0] if ":" in saved else "<pre-v2>"
    cur_fmt = current.split(":", 1)[0]
    if saved_fmt != cur_fmt:
        return (
            f"was written by encoding format {saved_fmt} (current "
            f"{cur_fmt}) and cannot seed the new program shapes; delete "
            "it to restart the search"
        )
    return "belongs to a different history (fingerprint mismatch)"


@dataclass
class Checkpoint:
    fingerprint: str
    #: frontier arrays, host-side, in the JAX engine's dtypes
    counts: np.ndarray  # [F, C] int32
    tail: np.ndarray  # [F] uint32
    hi: np.ndarray  # [F] uint32
    lo: np.ndarray  # [F] uint32
    tok: np.ndarray  # [F] int32
    valid: np.ndarray  # [F] bool
    #: search state
    f: int
    beam: bool
    layers_done: int
    stats: dict


def save_checkpoint(path: str, ckpt: Checkpoint) -> None:
    meta = {
        "format": _FORMAT,
        "fingerprint": ckpt.fingerprint,
        "f": int(ckpt.f),
        "beam": bool(ckpt.beam),
        "layers_done": int(ckpt.layers_done),
        "stats": ckpt.stats,
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez_compressed(
                fh,
                meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                counts=ckpt.counts,
                tail=ckpt.tail,
                hi=ckpt.hi,
                lo=ckpt.lo,
                tok=ckpt.tok,
                valid=ckpt.valid,
            )
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def load_checkpoint(path: str) -> Checkpoint:
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("format") != _FORMAT:
                raise CheckpointError(
                    f"checkpoint {path} has format {meta.get('format')}, "
                    f"want {_FORMAT}"
                )
            return Checkpoint(
                fingerprint=meta["fingerprint"],
                counts=z["counts"],
                tail=z["tail"],
                hi=z["hi"],
                lo=z["lo"],
                tok=z["tok"],
                valid=z["valid"],
                f=int(meta["f"]),
                beam=bool(meta["beam"]),
                layers_done=int(meta["layers_done"]),
                stats=dict(meta["stats"]),
            )
    except CheckpointError:
        raise
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        # Truncated or corrupt archives surface as zipfile/pickle/KeyError
        # noise; one exception type for the callers.
        raise CheckpointError(f"cannot read checkpoint {path}: {e}") from e
