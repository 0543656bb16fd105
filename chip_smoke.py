#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (vaporetto_tpu_torch).

Drives the port's main path — lean boundary serving, bytes in to tokenized
bytes out — on one CUDA card, at the full size of the largest model the
repo can build from its own code (the synthetic 50k-word dictionary model,
seed 17), and holds the hand-written boundary kernel against its plain
torch version on the same inputs. Phases, each printed on its own line:

1. device and build: the card's name and power limit, the g++ and nvcc
   build seconds (both built in parallel, from the sources in the tree);
2. model: compile seconds and the table bytes on the card;
3. kernel vs plain: full and serve epilogues on a seeded (8192, 256)
   batch, exact equality (tolerance 0: all values are int32), on (4, 20000)
   rows whose working set exceeds shared memory, on the launch geometry's
   edges (row lengths 0-2, 31-33, 255, 256 in one batch; batches that do
   not fill the last block or every SM; packed 512-wide rows with
   separators; a model whose hot tables exceed the staging budget), and
   on three small models (type trie, a 1000-char dictionary word, the
   reference's golden sentence);
4. lean serving: ``LeanServer.run`` over 50 000+ seeded mixed lines, whose
   bytes must equal the port's general path; the kernel's launch count
   during the run must be > 0 and cover every dispatch;
5. timing with CUDA events, kernel and plain version, at the three serve
   shapes ``LeanServer`` dispatches ((8192, 256) unpacked, (4096, 512)
   packed, (8192, 128)) and the full epilogue at (8192, 256), each shape's
   kernel first held to the plain version on its first batch (tolerance
   0); each with its launch geometry and occupancy, its bound, and what
   the inputs make the kernel do (live positions, walk steps, matches,
   weight-chunk rows, in-line gaps);
6. a ``kernels`` JSON line.

The last line is ``{"ok": true, "device": {...}}``. Any mismatch or
exception exits nonzero; without CUDA the script exits nonzero before
printing any result.

Usage: python3 chip_smoke.py [--timing-only]

``--timing-only`` runs phases 1, 2 and 5 and ends with a ``{"timing":
...}`` line instead; it reads only the package's entry points, so a copy
of this script placed in an earlier tree times that tree's kernel the same
way (an A/B on one card).
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA-core peak (no int32 rate is published)
B_FULL, L_FULL = 8192, 256
#: the serve shapes LeanServer dispatches: unpacked lines of 65-256 chars,
#: packed short lines (PACK_L = 512, at most PACK_TARGET_ROWS = 4096 rows),
#: a group of short lines that cannot pack (bucket 128)
SERVE_SHAPES = ((8192, 256, False), (4096, 512, True), (8192, 128, False))
#: wsconst on kanji and digits: the ``ws_types`` the comparisons also run
KANJI_DIGIT = (5, 1)


def log(*parts) -> None:
    print(*parts, flush=True)


# ----------------------------------------------------------------------
# models (seeded)
# ----------------------------------------------------------------------


def big_model(n_words: int = 50_000, n_ngrams: int = 3_000):
    """The repo's synthetic scale model (benchmarks/big_model_bench.py,
    seed 17): 50k dictionary words of length 2-7, 3k char n-grams and six
    type n-grams; windows 3, bias -100."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import (Model, NgramData,
                                                  WordWeightRecord)

    rng = np.random.default_rng(17)
    pools = np.concatenate([
        np.arange(0x3041, 0x3097),
        np.arange(0x30A1, 0x30FB),
        np.arange(0x4E00, 0x5800),
    ]).astype(np.int64)

    def rand_str(n):
        return "".join(chr(c) for c in pools[rng.integers(0, len(pools), n)])

    words = set()
    while len(words) < n_words:
        words.add(rand_str(int(rng.integers(2, 8))))
    ngrams = set()
    while len(ngrams) < n_ngrams:
        ngrams.add(rand_str(int(rng.integers(1, 4))))
    char_ngram = [
        NgramData(g, [int(w) for w in rng.integers(-500, 500, 7 - len(g))])
        for g in sorted(ngrams)
    ]
    dict_model = [
        WordWeightRecord(w, [int(x) for x in rng.integers(-500, 500,
                                                          len(w) + 1)])
        for w in sorted(words)
    ]
    type_ngram = [
        NgramData(bytes(t), [int(w) for w in rng.integers(-200, 200, 4)])
        for t in [(3,), (4,), (5,), (3, 5), (5, 5), (5, 3, 3)]
    ]
    return Model(char_ngram, type_ngram, dict_model, bias=-100,
                 char_window_size=3, type_window_size=3)


def golden_model():
    """Reference predictor.rs:749-838 without its tag models."""
    from vaporetto_tpu_torch.models.model import (Model, NgramData,
                                                  WordWeightRecord)

    H, J = 3, 5
    return Model(
        [NgramData("この人", [1, -2, 3, 4]), NgramData("人だ", [-5, 6, 7, 8, 9])],
        [NgramData(bytes([H, H, J]), [10, -11, 12, 13]),
         NgramData(bytes([J, H]), [-14, 15, 16, 17, -18])],
        [WordWeightRecord("人", [19, 20]),
         WordWeightRecord("地球", [21, -22, 23])],
        5, 3, 3,
    )


def small_model(seed: int, type_window: int, long_word: int = 0):
    """A seeded random model over hiragana; ``type_window`` 4 takes the
    type trie, ``long_word`` adds one dictionary word of that length."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import (Model, NgramData,
                                                  WordWeightRecord)

    rng = np.random.default_rng(seed)
    alpha = [chr(c) for c in range(0x3041, 0x3061)]

    def rand_str(n):
        return "".join(alpha[i] for i in rng.integers(0, len(alpha), n))

    ngrams = {rand_str(int(rng.integers(1, 4))):
              [int(x) for x in rng.integers(-50, 51, int(rng.integers(1, 8)))]
              for _ in range(30)}
    words = {rand_str(int(rng.integers(1, 13))): None for _ in range(10)}
    if long_word:
        words[rand_str(long_word)] = None
    dict_model = [WordWeightRecord(w, [int(x) for x in rng.integers(
        -50, 51, len(w) + 1)]) for w in words if w not in ngrams]
    types = {bytes(int(x) for x in rng.integers(1, 7, int(rng.integers(1, 4)))):
             [int(x) for x in rng.integers(-50, 51, int(rng.integers(1, 8)))]
             for _ in range(8)}
    return Model([NgramData(n, w) for n, w in ngrams.items()],
                 [NgramData(t, w) for t, w in types.items()],
                 dict_model, int(rng.integers(-5, 6)), 3, type_window), words


def wide_model(seed: int = 9, n_chars: int = 7000):
    """A seeded model over ``n_chars`` distinct kanji: its hash projection
    (16 384 slots, 128 KB) and root-child records exceed the kernel's
    staging budget, so the kernel reads them from global memory."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import (Model, NgramData,
                                                  WordWeightRecord)

    rng = np.random.default_rng(seed)
    chars = [chr(0x4E00 + i) for i in range(n_chars)]
    ngrams = {c: [int(x) for x in rng.integers(-50, 51, 6)] for c in chars}
    for _ in range(2000):
        g = "".join(rng.choice(chars, 2))
        ngrams[g] = [int(x) for x in rng.integers(-50, 51, 5)]
    words = sorted({"".join(rng.choice(chars, int(rng.integers(2, 6))))
                    for _ in range(2000)})
    return Model(
        [NgramData(n, w) for n, w in ngrams.items()],
        [NgramData(bytes([5]), [1, -2, 3, 4])],
        [WordWeightRecord(w, [int(x) for x in rng.integers(-50, 51,
                                                           len(w) + 1)])
         for w in words if w not in ngrams],
        -3, 3, 3), words


# ----------------------------------------------------------------------
# inputs (seeded)
# ----------------------------------------------------------------------


def text_pool():
    import numpy as np

    return np.concatenate([
        np.arange(0x3041, 0x3097), np.arange(0x30A1, 0x30FB),
        np.arange(0x4E00, 0x5800), np.arange(0x30, 0x3A),
        np.arange(0x41, 0x5B), np.arange(0x61, 0x7B),
        np.array([0x20, 0x2F, 0x5C, 0x28, 0x3002, 0xFF10]),
    ]).astype(np.int64)


def _random_text(rng, B, L, words):
    """(B, L) int32 pool chars with dictionary words spliced in."""
    import numpy as np

    pool = text_pool()
    cps = pool[rng.integers(0, len(pool), (B, L))].astype(np.int32)
    words = list(words)
    for _ in range(B * L // 32 if words else 0):
        w = words[int(rng.integers(0, len(words)))]
        b, t = int(rng.integers(0, B)), int(rng.integers(0, L))
        n = min(len(w), L - t)
        cps[b, t:t + n] = [ord(c) for c in w[:n]]
    return cps


def _with_types(cps, keep, lengths):
    """Zero the codepoints outside ``keep``; (cps, cts, lengths) int32."""
    import numpy as np

    from vaporetto_tpu_torch.sentence import char_types_of_codepoints

    cps = np.where(keep, cps, 0).astype(np.int32)
    cts = char_types_of_codepoints(cps).astype(np.int32)
    cts[cps == 0] = 0
    return cps, cts, np.asarray(lengths, dtype=np.int32)


def random_batch(B, L, seed, words=(), lengths=None):
    """(cps int32, cts int32, lengths int32) with ragged lengths, some
    empty rows, and dictionary words spliced in; ``lengths`` (B,) fixes
    the row lengths instead."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cps = _random_text(rng, B, L, words)
    if lengths is None:
        lengths = rng.integers(1, L + 1, B).astype(np.int32)
        lengths[rng.random(B) < 0.05] = 0  # padding rows
        lengths[: max(1, B // 8)] = L
    lengths = np.asarray(lengths, dtype=np.int32)
    return _with_types(cps, np.arange(L)[None, :] < lengths[:, None],
                       lengths)


def packed_batch(B, seed, words, sep, L=512, max_line=64):
    """Rows in ``LeanServer``'s packed layout: lines of 0..``max_line``
    chars one after another, ``sep`` codepoint-0 separators after each,
    until a row's fill passes PACK_L - max_line - sep; the rest of the
    row is 0 and every row's length is L."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cps = _random_text(rng, B, L, words)
    cap = L - max_line - sep
    t_idx = np.arange(L)[None, :]
    keep = np.zeros((B, L), dtype=bool)
    pos = np.zeros((B, 1), dtype=np.int64)
    while (pos < cap).any():
        n = rng.integers(0, max_line + 1, (B, 1))
        live = pos < cap
        keep |= live & (t_idx >= pos) & (t_idx < pos + n)
        pos = np.where(live, pos + n + sep, pos)
    return _with_types(cps, keep, np.full(B, L))


#: row lengths at the kernel's edges: empty, one char, one gap, a warp's
#: width and its neighbours, a full row
EDGE_LENGTHS = (0, 1, 2, 31, 32, 33, 255, 256)


def geometry_batches(words, sep):
    """name -> (cps, cts, lengths) at the edges of the launch geometry
    (csrc/boundary.cu: a warp per row, persistent blocks of up to 32
    warps, rows taken from a counter)."""
    import numpy as np

    return {
        "edge lengths (67, 256)": random_batch(
            67, 256, 11, words, np.resize(EDGE_LENGTHS, 67)),
        "ragged last block (1001, 256)": random_batch(1001, 256, 12, words),
        "fewer rows than SMs (50, 256)": random_batch(50, 256, 13, words),
        "packed rows with separators (256, 512)": packed_batch(
            256, 14, words, sep),
    }


def stream_lines(seed, words):
    """50 001 mixed lines in runs, as a corpus arrives: 20 000 short lines
    (<= 64 chars: the packed layout), 20 000 lines of 65-256 chars
    (unpacked (8192, 256) groups), 10 000 short lines of which three near
    the end carry an astral char (their group takes the general path),
    and one line of 9000 chars (the general path's chunking)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = text_pool()
    words = list(words)

    def line(n):
        """n chars: random pool chars and dictionary words, shuffled."""
        cps = pool[rng.integers(0, len(pool), n)]
        parts = [chr(int(c)) for c in cps]
        parts += [words[int(w)] for w in rng.integers(0, len(words), n // 6)]
        return "".join(parts[i] for i in rng.permutation(len(parts)))[:n]

    short = [line(int(rng.integers(0, 65))) for _ in range(20_000)]
    long_ = [line(int(rng.integers(65, 257))) for _ in range(20_000)]
    tail = [line(int(rng.integers(0, 65))) for _ in range(10_000)]
    for i in (9_100, 9_500, 9_900):
        tail[i] = tail[i][:10] + "\U0001F431" + tail[i][10:]
    return short + long_ + tail + [line(9000)]


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------


def build_all():
    """Build the host library (g++) and the kernel (nvcc) in parallel;
    returns {name: seconds} and the kernel's ptxas report."""
    from vaporetto_tpu_torch import native
    from vaporetto_tpu_torch.ops import boundary as bmod

    secs, errors, paths = {}, [], {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            paths[name] = fn()
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)
        secs[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=a) for a in
               (("g++", native.build), ("nvcc", bmod.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    with open(paths["nvcc"] + ".log") as f:
        ptxas = [ln.strip() for ln in f
                 if any(k in ln for k in ("registers", "smem", "spill"))]
    return secs, ptxas


def ptxas_summary(lines):
    """Most registers and spill bytes over the kernel's instantiations."""
    import re

    def most(pattern):
        return max((int(m) for ln in lines for m in re.findall(pattern, ln)),
                   default=0)

    return {"registers": most(r"Used (\d+) registers"),
            "spill_store_bytes": most(r"(\d+) bytes spill stores"),
            "spill_load_bytes": most(r"(\d+) bytes spill loads")}


def kernel_work(tabs, cps, cts, lengths):
    """What a batch makes the kernel do, counted in plain torch on the
    card from the plain version's outputs and the same tables: live
    positions (chars before each row's length), walk steps (alive
    transitions of the forward walks from every live start, the first
    step included), matched end positions, weight-chunk rows added,
    in-line gaps (type window lookups), for the char side."""
    import torch

    from vaporetto_tpu_torch.ops.boundary import boundary_scores_plain
    from vaporetto_tpu_torch.ops.match import hash_project_fused

    _, cm, _ = boundary_scores_plain(tabs, cps, cts, lengths)
    L = cps.shape[1]
    ln = lengths.long()[:, None]
    t_idx = torch.arange(L, device=cps.device)[None, :]
    m = tabs.char
    syms = hash_project_fused(cps, tabs.hash_mul, tabs.hash_shift,
                              tabs.hash2)
    live = t_idx < ln
    node = torch.where(live, 0, -1)
    nbase = torch.full_like(node, m.root_base)
    steps = 0
    for j in range(min(m.max_len, L)):
        ok = (node >= 0) & (t_idx + j < ln)
        if not bool(ok.any()):
            break
        nxt = torch.nn.functional.pad(syms[:, j:], (0, j))
        cand = (nbase + nxt).clamp(0, m.walk.shape[0] - 1).long()
        row = m.walk[cand]
        ok = ok & (row[..., 0] == node)
        steps += int(ok.sum())
        node = torch.where(ok, cand.int(), -1)
        nbase = row[..., 1]
    matched = cm[cm >= 0].long()
    return {
        "live positions": int(live.sum()),
        "walk steps": steps,
        "matched end positions": int(matched.numel()),
        "weight-chunk rows": int(m.rows_cnt[matched].sum())
        if matched.numel() else 0,
        "in-line gaps": int((lengths.long() - 1).clamp(min=0).sum()),
    }


def compare_kernel(tabs, cps, cts, lengths, ws_types_list=((),)):
    """Kernel vs plain on the card, full and serve epilogues; returns the
    max |difference| (must be 0)."""
    import torch

    from vaporetto_tpu_torch.ops.boundary import (boundary,
                                                  boundary_scores_plain,
                                                  serve_bits_plain)

    dev = tabs.device
    c32 = torch.from_numpy(cps).to(dev)
    t32 = torch.from_numpy(cts).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    got = boundary(tabs, c32, t32, ln)
    want = boundary_scores_plain(tabs, c32, t32, ln)
    torch.cuda.synchronize()
    err = 0
    for g, w, name in zip(got, want, ("scores", "char_match", "type_match")):
        if (g is None) != (w is None):
            raise AssertionError(f"{name}: presence differs")
        if g is not None:
            d = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            if d:
                raise AssertionError(f"full epilogue {name} differs by {d}")
            err = max(err, d)
    c16 = torch.from_numpy(cps.astype("uint16")).to(dev)
    t8 = torch.from_numpy(cts.astype("uint8")).to(dev)
    for ws in ws_types_list:
        for ct_in in (t8, None):  # host types, and in-kernel typing
            gb = boundary(tabs, c16, ct_in, ln, serve=True, ws_types=ws)
            wb = serve_bits_plain(tabs, c16, ct_in, ln, ws)
            if not torch.equal(gb, wb):
                raise AssertionError(f"serve bits differ (wsconst {ws})")
    torch.cuda.synchronize()
    return err


def general_path(pred, lines, batch=4096):
    """The reference CLI's per-line loop on the port (fullwidth filter ->
    Sentence -> predict on the card -> boundaries onto the original text
    -> write_tokenized_text), as bytes."""
    from vaporetto_tpu_torch.rules.string_filters import KyteaFullwidthFilter
    from vaporetto_tpu_torch.sentence import Sentence

    pre = KyteaFullwidthFilter()
    sents = []
    for line in lines:
        try:
            sents.append(Sentence.from_raw(pre.filter(line)))
        except Exception:  # the reference prints an empty line
            sents.append(None)
    ok = [s for s in sents if s is not None]
    for i in range(0, len(ok), batch):
        pred.predict_batch(ok[i:i + batch])
    out = []
    for line, s in zip(lines, sents):
        if s is None:
            out.append("")
            continue
        orig = Sentence.from_raw(line)
        orig.boundaries = s.boundaries
        out.append(orig.write_tokenized_text())
    return ("\n".join(out) + "\n").encode("utf-8") if out else b""


def cuda_ms(fn, inputs, iters, reps=5, hold=True):
    """Device ms per call: the median over ``reps`` runs of the mean over
    ``iters`` calls cycling through ``inputs`` (several batches, more than
    the 50 MB L2 holds), after a warm-up. A kernel of tens of us runs as
    fast as the host can launch it, so before each run the stream is held
    busy (``torch.cuda._sleep``) for longer than the host takes to enqueue
    the calls: the events then time the calls back to back on the device.
    A run the host outlasted is repeated with a longer hold. ``hold=False``
    times back to back without it, for the plain version, whose calls wait
    on the device inside."""
    import statistics

    import torch

    for x in inputs:
        fn(*x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_ev, start, end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
    cycles = int(3 * host_s * 2e9) + 1_000_000  # 3x at <= 2 GHz
    times = []
    while len(times) < reps:
        torch.cuda.synchronize()
        hold_ev.record()
        if hold:
            torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if not hold or hold_ev.elapsed_time(start) >= enqueue_ms:
            times.append(start.elapsed_time(end) / iters)
        elif cycles > 2e10:  # 10 s
            raise RuntimeError(f"host enqueue {enqueue_ms:.3f} ms outlasted "
                               f"the hold {hold_ev.elapsed_time(start):.3f} "
                               "ms")
        else:  # the host was slower than in the warm-up: hold longer
            cycles *= 2
    return statistics.median(times)


def time_kernel(pred, words, sep):
    """Phase 5: CUDA-event times of the kernel and its plain version at the
    serve shapes and of the full epilogue at (B_FULL, L_FULL), with each
    shape's bound, its launch geometry where the package reports one, and
    what the first batch makes the kernel do. Before timing a shape, the
    kernel is held to the plain version on its first batch (both
    epilogues, host and in-kernel types, wsconst none and KANJI+DIGIT).
    Returns (shapes, full, max |difference|). It reads only the package's
    entry points, so it times an earlier tree's kernel too
    (``--timing-only``)."""
    import torch

    from vaporetto_tpu_torch.ops import boundary as bmod
    from vaporetto_tpu_torch.ops.boundary import (boundary,
                                                  boundary_scores_plain,
                                                  serve_bits_plain)

    tabs = pred._tables()
    dev = tabs.device
    geometry = getattr(bmod, "launch_geometry", None)
    shapes, full, err = [], {}, 0
    for B, L, packed in SERVE_SHAPES:
        batches = []
        # more serve input than the 50 MB L2 holds (10 batches of
        # (8192, 256) are PR 1's timing batches, seeds 100-109)
        for seed in range(max(10, -(-60_000_000 // (3 * B * L)))):
            c, t, ln = (packed_batch(B, 200 + seed, words[:5000], sep, L)
                        if packed else
                        random_batch(B, L, 100 + seed, words[:5000]))
            if seed == 0:
                err = max(err, compare_kernel(tabs, c, t, ln,
                                              ((), KANJI_DIGIT)))
            batches.append(tuple(torch.from_numpy(x).to(dev) for x in (
                c.astype("uint16"), t.astype("uint8"), ln, c, t)))
        log(f"[5] ({B}, {L}){' packed' if packed else ''}, first timing "
            "batch: full and serve epilogues equal to plain")
        serve_in = [b[:3] for b in batches]
        full_in = [(b[3], b[4], b[2]) for b in batches]
        serve_ms = cuda_ms(
            lambda c, t, ln: boundary(tabs, c, t, ln, serve=True),
            serve_in, 50)
        serve_plain_ms = cuda_ms(
            lambda c, t, ln: serve_bits_plain(tabs, c, t, ln), serve_in[:2],
            4, hold=False)
        work = kernel_work(tabs, *full_in[0])
        W8 = -(-(L - 1) // 8)
        # least bytes: each input the function needs read once, each output
        # written once. Chars at or past a row's length are 0 by the
        # wrapper's contract and need no read, so the inputs are the live
        # chars (the mean over the timed batches) and the row lengths. The
        # model tables (tens of MB at most) are not counted: they stay in
        # the 50 MB L2 from one launch to the next
        live = sum(int(b[2].sum()) for b in batches) / len(batches)
        serve_bytes = live * (2 + 1) + B * 4 + B * W8
        # least operations this data needs: the adds of every matched
        # weight chunk lane and the type window shifts of every in-line gap
        ops = (8 * work["weight-chunk rows"]
               + 2 * 2 * tabs.type_window * work["in-line gaps"])
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        bytes_ms = serve_bytes / HBM_BYTES_PER_S * 1e3
        shape = {
            "shape": [B, L], "packed": packed, "ms": serve_ms,
            "plain_ms": serve_plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "live_positions_mean": live, "work": work,
        }
        shapes.append(shape)
        if geometry is not None:
            g = geometry(tabs, B, L)
            shape.update(warps_per_block=g.warps, blocks=g.blocks,
                         blocks_per_sm=g.blocks_per_sm,
                         occupancy=g.occupancy, smem=g.smem,
                         staged=g.staged)
            log(f"[5] geometry ({B}, {L}){' packed' if packed else ''}: "
                f"{g.warps} warps per block, {g.blocks} blocks, "
                f"{g.blocks_per_sm} per SM, occupancy {g.occupancy:.3f} of "
                f"{g.max_warps_per_sm} warps, {g.smem} B shared memory, hot "
                f"tables {'staged' if g.staged else 'global'}, rows in "
                f"{'global scratch' if g.scratch else 'shared memory'}")
        log(f"[5] work ({B}, {L}), first batch: " + ", ".join(
            f"{k} {v}" for k, v in work.items()) + f" (of {B * L} positions)")
        if (B, L) != (B_FULL, L_FULL):
            log(f"[5] timing ({B}, {L}){' packed' if packed else ''}: serve "
                f"kernel {serve_ms:.4f} ms, plain {serve_plain_ms:.3f} ms, "
                f"bound {shape['bound_ms']:.5f} ms ({serve_bytes:.0f} B at "
                f"3.35 TB/s; ops bound {ops_ms:.5f} ms, {ops} ops)")
            continue
        S = tabs.pad_left + L - 1 + tabs.pad_right
        n_match = (tabs.char is not None) + (tabs.type_trie is not None)
        # int32 codepoints and types of the live chars and the lengths in;
        # the whole score row and match id rows out
        full_bytes = live * (4 + 4) + B * 4 + B * S * 4 + n_match * B * L * 4
        full = {
            "ms": cuda_ms(lambda c, t, ln: boundary(tabs, c, t, ln), full_in,
                          50),
            "plain_ms": cuda_ms(
                lambda c, t, ln: boundary_scores_plain(tabs, c, t, ln),
                full_in[:2], 4, hold=False),
            "bound_ms": max(full_bytes / HBM_BYTES_PER_S * 1e3, ops_ms),
        }
        log(f"[5] timing ({B}, {L}): serve kernel {serve_ms:.4f} ms, plain "
            f"{serve_plain_ms:.3f} ms, bound {shape['bound_ms']:.5f} ms "
            f"({serve_bytes:.0f} B at 3.35 TB/s); full kernel "
            f"{full['ms']:.4f} ms, plain {full['plain_ms']:.3f} ms, bound "
            f"{full['bound_ms']:.5f} ms ({full_bytes:.0f} B); ops bound "
            f"{ops_ms:.5f} ms ({ops} ops)")
    return shapes, full, err


def main(argv) -> int:
    import torch

    timing_only = "--timing-only" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from vaporetto_tpu_torch import Predictor
    from vaporetto_tpu_torch.serving import pack_separator

    # ---- 1. device and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"[1] device: {kind}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    secs, ptxas = build_all()
    log(f"[1] build seconds (parallel): g++ {secs['g++']:.2f}, "
        f"nvcc {secs['nvcc']:.2f}")
    for ln in ptxas:
        log(f"[1] ptxas: {ln}")
    log(f"[1] ptxas summary: {ptxas_summary(ptxas)}")

    # ---- 2. model -----------------------------------------------------
    t0 = time.perf_counter()
    model = big_model()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = Predictor(model)
    compile_s = time.perf_counter() - t0
    tabs = pred._tables()
    torch.cuda.synchronize()
    cm_ = pred.compiled.char_matcher
    log(f"[2] model: generated {gen_s:.2f}s, compiled {compile_s:.2f}s; "
        f"{len(cm_.base)} trie slots, max_len {cm_.max_len}, "
        f"{len(cm_.rows_cnt)} pattern ids, {len(cm_.w8)} weight rows, "
        f"pad {pred.compiled.pad_left}/{pred.compiled.pad_right}; "
        f"tables on card {tabs.nbytes()} bytes")
    words = [w.word for w in model.dict_model]
    sep = pack_separator(pred.compiled)
    if timing_only:
        shapes, full, _ = time_kernel(pred, words, sep)
        log(json.dumps({"timing": {"serve_shapes": shapes, "full": full}}))
        return 0
    from vaporetto_tpu_torch import LeanServer, Sentence
    from vaporetto_tpu_torch.ops.boundary import (STAGE_BUDGET, boundary,
                                                  launch_geometry)

    # ---- 3. kernel vs plain -------------------------------------------
    cps, cts, lengths = random_batch(B_FULL, L_FULL, 1, words[:5000])
    err = compare_kernel(tabs, cps, cts, lengths, ((), KANJI_DIGIT))
    log(f"[3] 50k model ({B_FULL}, {L_FULL}): full and serve epilogues "
        f"equal to plain (tolerance 0), wsconst none and KANJI+DIGIT")
    c, t, ln = random_batch(4, 20000, 2, words[:5000])
    err = max(err, compare_kernel(tabs, c, t, ln))
    log("[3] 50k model (4, 20000): rows beyond shared memory (global "
        "scratch) equal to plain")
    for name, (c, t, ln) in geometry_batches(words[:5000], sep).items():
        err = max(err, compare_kernel(tabs, c, t, ln, ((), KANJI_DIGIT)))
        g = launch_geometry(tabs, len(ln), c.shape[1])
        log(f"[3] 50k model, {name}: equal to plain; {g.warps} warps per "
            f"block, {g.blocks} blocks")
    wm, wwords = wide_model()
    wt = Predictor(wm)._tables()
    if launch_geometry(wt, 64, 128).staged:
        raise AssertionError("the wide model's hot tables are staged")
    c, t, ln = random_batch(64, 128, 15, wwords)
    err = max(err, compare_kernel(wt, c, t, ln, ((), KANJI_DIGIT)))
    log(f"[3] wide model ({wt.hash2.shape[0]} hash slots, "
        f"{wt.stage_bytes()} B of hot tables > budget {STAGE_BUDGET} B): "
        f"tables read from global memory, equal to plain at (64, 128)")
    for name, (m, mwords) in (
        ("type trie (window 4)", small_model(3, 4)),
        ("1000-char dictionary word", small_model(4, 3, long_word=1000)),
    ):
        p = Predictor(m)
        L = 1280 if "1000" in name else 96
        c, t, ln = random_batch(64, L, 5, [w for w in mwords if w])
        err = max(err, compare_kernel(p._tables(), c, t, ln,
                                      ((), KANJI_DIGIT)))
        log(f"[3] {name}: equal to plain at (64, {L}); "
            f"max_len {p.compiled.char_matcher.max_len}, "
            f"type trie {p.compiled.type_matcher is not None}")
    gp = Predictor(golden_model())
    s = Sentence.from_raw("この人は地球人だ")
    gp.predict(s)
    want = [-22, 54, 58, 43, -54, 68, 48]
    if s.boundary_scores_list() != want or list(s.boundaries) != [
            0, 1, 1, 1, 0, 1, 1]:
        raise AssertionError(f"golden sentence: {s.boundary_scores_list()}")
    c, t, ln = random_batch(8, 16, 6)
    err = max(err, compare_kernel(gp._tables(), c, t, ln))
    log(f"[3] golden model: scores {want} and boundaries reproduced; "
        f"batch equal to plain")

    # ---- 4. lean serving ----------------------------------------------
    lines = stream_lines(7, words)
    blob = ("\n".join(lines) + "\n").encode("utf-8")
    n_chars = sum(map(len, lines))
    sink = io.BytesIO()

    def fallback(raw):
        sink.write(general_path(pred, [b.decode("utf-8") for b in raw]))

    server = LeanServer(pred, fallback=fallback)
    torch.cuda.synchronize()
    boundary.launches = 0
    t0 = time.perf_counter()
    server.run(io.BytesIO(blob), sink)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = boundary.launches
    st = server.stats
    want_bytes = general_path(pred, lines)
    if sink.getvalue() != want_bytes:
        raise AssertionError("lean serving bytes differ from the general path")
    if launches <= 0 or launches < st["dispatches"]:
        raise AssertionError(f"kernel launches {launches} < dispatches")
    log(f"[4] lean serving: {len(lines)} lines, {n_chars} chars, "
        f"{len(blob)} bytes in {run_s:.3f}s = {n_chars / run_s / 1e6:.2f} "
        f"Mchar/s; dispatches {st['dispatches']}, packed_dispatches "
        f"{st['packed_dispatches']}, fallback_lines {st['fallback_lines']}, "
        f"kernel launches {launches}; host seconds: dispatch "
        f"{st['t_dispatch_s']:.3f}, wait+readback {st['t_readback_s']:.3f} "
        f"({st['readback_bytes']} B), detok {st['t_detok_s']:.3f}, general "
        f"path {st['t_fallback_s']:.3f}; bytes equal to the general path")

    # ---- 5. timing ----------------------------------------------------
    n_before = boundary.launches
    log(f"[5] ptxas: {ptxas_summary(ptxas)}")
    shapes, full, timing_err = time_kernel(pred, words, sep)
    err = max(err, timing_err)
    boundary.launches = n_before  # timing launches are not the main path's

    # ---- 6. kernels ---------------------------------------------------
    main_shape = shapes[0]
    log(json.dumps({"kernels": [{
        "name": "boundary",
        "route": "cuda",
        "source": "vaporetto_tpu_torch/csrc/boundary.cu",
        "replaces": "vaporetto_tpu/ops/pallas_fused.py:242",
        "launches": launches,
        "matches_plain": True,
        "max_abs_err": err,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "shape": main_shape["shape"],
        "full_ms": full["ms"],
        "full_plain_ms": full["plain_ms"],
        "full_bound_ms": full["bound_ms"],
        "occupancy": main_shape["occupancy"],
        "ptxas": ptxas_summary(ptxas),
        "serve_shapes": shapes,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
