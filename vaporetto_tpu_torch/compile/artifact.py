"""Compiled-model artifact.

Analogue of the reference's zero-copy predictor serialization
(predictor.rs:639-664; used by the embedded/WASM fast paths,
examples/embedded_device/build.rs:17-26): a :class:`CompiledModel` — the
packed tables — serialized so a later process can skip the model compiler
and upload straight to the card.

Format: a zip (numpy .npz) of the raw arrays plus a JSON manifest, byte
for byte the JAX package's (``vaporetto_tpu/compile/artifact.py``), so an
artifact written by either package loads in the other. No pickling — the
artifact is data-only and safe to load.

The dense codepoint -> symbol table that the JAX format stores sparsely
(``char_sym_idx``/``char_sym_val``) is, for every compile of either
package, the hash projection's keys and symbols in codepoint order; the
port writes it from those and, for an artifact without the hash
projection, builds the projection from it.

The per-start-offset type tables (``type_pos_tables`` and
``type_pos_m``, type cache models only), which both packages' boundary
paths read under ``VAPORETTO_TPU_SMALL_TABLES=1``, travel with the
compiled model both ways. As in the JAX package, the split type tables
(``VAPORETTO_TPU_TYPE_SPLIT=1``) do not: a model read from an artifact has
none, and takes the next type table in the switches' order.
"""

from __future__ import annotations

import io
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from .compiler import (CompiledMatcher, CompiledModel, CompiledTagMeta,
                       _build_char_hash)

MAGIC = "vaporetto_tpu-compiled-1"

__all__ = ["serialize_compiled", "deserialize_compiled"]


def _pack_tag_weight(
    tag_weight: Optional[List[List[Dict[int, List[int]]]]]
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    if tag_weight is None:
        return None, None
    rows = []
    flat: List[int] = []
    for token_id, by_rel in enumerate(tag_weight):
        for rel, table in enumerate(by_rel):
            for state, w in sorted(table.items()):
                rows.append([token_id, rel, state, len(flat), len(w)])
                flat.extend(w)
    return (
        np.array(rows, dtype=np.int64).reshape(-1, 5),
        np.array(flat, dtype=np.int32),
    )


def _unpack_tag_weight(rows, flat, n_tokens, n_rel):
    if rows is None:
        return None
    out: List[List[Dict[int, List[int]]]] = [
        [dict() for _ in range(n_rel)] for _ in range(n_tokens)
    ]
    for token_id, rel, state, off, ln in rows:
        out[int(token_id)][int(rel)][int(state)] = flat[off : off + ln].tolist()
    return out


def _char_sym_sparse(c: CompiledModel) -> Tuple[np.ndarray, np.ndarray]:
    """(codepoints int32 ascending, their symbols int32): the nonzero
    entries of the dense symbol table, from the hash projection."""
    keys = np.asarray(c.char_hash_keys)
    live = np.flatnonzero(keys >= 0)
    order = np.argsort(keys[live], kind="stable")
    return (keys[live][order].astype(np.int32),
            np.asarray(c.char_hash_syms)[live][order].astype(np.int32))


def serialize_compiled(c: CompiledModel, predict_tags: bool) -> bytes:
    arrays: Dict[str, np.ndarray] = {}
    manifest = {
        "magic": MAGIC,
        "bias": c.bias,
        "char_window_size": c.char_window_size,
        "type_window_size": c.type_window_size,
        "pad_left": c.pad_left,
        "pad_right": c.pad_right,
        "n_tags": c.n_tags,
        "predict_tags": predict_tags,
    }
    if c.char_matcher is not None:
        arrays["char_sym_idx"], arrays["char_sym_val"] = _char_sym_sparse(c)
    for name, m in (("char", c.char_matcher), ("type", c.type_matcher)):
        if m is None:
            continue
        manifest[f"{name}_max_len"] = m.max_len
        manifest[f"{name}_max_chunks"] = m.max_chunks
        for field in ("base", "check", "value", "inherit", "rows_first",
                      "rows_cnt", "w8", "off"):
            arrays[f"{name}_{field}"] = getattr(m, field)
        rows, flat = _pack_tag_weight(m.tag_weight)
        if rows is not None:
            arrays[f"{name}_tagw_rows"] = rows
            arrays[f"{name}_tagw_flat"] = flat
            manifest[f"{name}_has_tagw"] = True
    if c.type_cache_table is not None:
        arrays["type_cache"] = c.type_cache_table
    if c.char_hash_keys is not None:
        manifest["char_hash_mul"] = c.char_hash_mul
        manifest["char_hash_shift"] = c.char_hash_shift
        arrays["char_hash_keys"] = c.char_hash_keys
        arrays["char_hash_syms"] = c.char_hash_syms
    if c.type_pos_tables is not None:
        manifest["type_pos_m"] = c.type_pos_m
        arrays["type_pos_tables"] = c.type_pos_tables
    if c.tag_meta is not None:
        manifest["tag_meta"] = {
            "tokens": sorted(c.tag_meta.token_ids, key=c.tag_meta.token_ids.get),
            "tags": c.tag_meta.tags,
            "bias": c.tag_meta.bias,
        }
    buf = io.BytesIO()
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), dtype=np.uint8
    ).copy()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def deserialize_compiled(data: bytes) -> Tuple[CompiledModel, bool]:
    with np.load(io.BytesIO(data)) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays.pop("__manifest__")).decode("utf-8"))
    if manifest.get("magic") != MAGIC:
        from ..errors import invalid_model

        raise invalid_model("compiled model version mismatch")

    tag_meta = None
    n_tokens = 0
    if "tag_meta" in manifest:
        tm = manifest["tag_meta"]
        tag_meta = CompiledTagMeta(
            {tok: i for i, tok in enumerate(tm["tokens"])},
            tm["tags"],
            tm["bias"],
        )
        n_tokens = len(tm["tokens"])

    matchers = {}
    for name, window in (
        ("char", manifest["char_window_size"]),
        ("type", manifest["type_window_size"]),
    ):
        if f"{name}_base" not in arrays:
            matchers[name] = None
            continue
        tag_weight = None
        if manifest.get(f"{name}_has_tagw"):
            tag_weight = _unpack_tag_weight(
                arrays[f"{name}_tagw_rows"],
                arrays[f"{name}_tagw_flat"],
                n_tokens,
                window + 1,
            )
        matchers[name] = CompiledMatcher(
            base=arrays[f"{name}_base"],
            check=arrays[f"{name}_check"],
            value=arrays[f"{name}_value"],
            inherit=arrays[f"{name}_inherit"],
            max_len=manifest[f"{name}_max_len"],
            rows_first=arrays[f"{name}_rows_first"],
            rows_cnt=arrays[f"{name}_rows_cnt"],
            w8=arrays[f"{name}_w8"],
            off=arrays[f"{name}_off"],
            max_chunks=manifest[f"{name}_max_chunks"],
            tag_weight=tag_weight,
        )

    hash_mul = manifest.get("char_hash_mul", 0)
    hash_shift = manifest.get("char_hash_shift", 0)
    hash_keys = arrays.get("char_hash_keys")
    hash_syms = arrays.get("char_hash_syms")
    if hash_keys is None and "char_sym_idx" in arrays:
        # an artifact with only the dense table: the kernel reads the hash
        hash_mul, hash_shift, hash_keys, hash_syms = _build_char_hash(
            arrays["char_sym_idx"].astype(np.int64), arrays["char_sym_val"])

    compiled = CompiledModel(
        bias=manifest["bias"],
        char_window_size=manifest["char_window_size"],
        type_window_size=manifest["type_window_size"],
        pad_left=manifest["pad_left"],
        pad_right=manifest["pad_right"],
        char_matcher=matchers["char"],
        type_matcher=matchers["type"],
        type_cache_table=arrays.get("type_cache"),
        tag_meta=tag_meta,
        n_tags=manifest["n_tags"],
        char_hash_mul=hash_mul,
        char_hash_shift=hash_shift,
        char_hash_keys=hash_keys,
        char_hash_syms=hash_syms,
        type_pos_tables=arrays.get("type_pos_tables"),
        type_pos_m=manifest.get("type_pos_m", 0),
    )
    return compiled, manifest["predict_tags"]
