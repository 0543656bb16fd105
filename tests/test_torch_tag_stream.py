"""``chip_smoke.py``'s tag inputs on the CPU, at a small size.

The card run's lean tag stream ends with lines of tag tokens
(``chip_smoke.token_lines``), which the tagged model splits out
(``chip_smoke.split_out_tokens``), so that its bytes-equality check covers
many emitted tags; and the tag kernel's byte bound counts what the pass
must read (``chip_smoke.tag_work``). Both are checked here on small tagged
models, on the plain versions (every value an integer: exact).
"""

import io

import numpy as np
import pytest
import torch

import chip_smoke
from vaporetto_tpu_torch import LeanServer, Predictor

#: name -> small_tagged_model arguments: the fused uint16 word layout, and
#: the int16 tid + int8 choice layout of the tagged 50k model
LAYOUTS = {"word": (100, 5), "int16": (300, 6)}


def _split_model(layout):
    model, tokens = chip_smoke.small_tagged_model(*LAYOUTS[layout])
    chip_smoke.split_out_tokens(model, tokens)
    return Predictor(model, True, device="cpu"), tokens


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_token_lines_are_tagged_through_the_lean_path(layout):
    pred, tokens = _split_model(layout)
    lines = chip_smoke.token_lines(3, tokens, 100, 50)
    n = [len(x) for x in lines]
    assert max(n[:100]) <= 64 and min(n[100:]) >= 65
    want = chip_smoke.general_path(pred, lines, tags=True)
    sink = io.BytesIO()
    server = LeanServer(pred, tags=True, batch_lines=64,
                        fallback=lambda raw: sink.write(
                            chip_smoke.general_path(
                                pred, [b.decode() for b in raw], tags=True)))
    server.run(io.BytesIO(("\n".join(lines) + "\n").encode()), sink)
    assert sink.getvalue() == want
    assert server.stats["packed_dispatches"] > 0
    assert server.stats["fallback_lines"] == 0
    spans = want.split()
    tagged = sum(b"/" in s for s in spans)
    # most spans are tokens; 1-char tokens inside longer ones split some
    assert tagged > 1000 and tagged >= 0.6 * len(spans)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tag_work_counts_what_the_pass_reads(layout):
    """tag_work against a per-position count of the same rule: the gap
    score of each in-line gap, each live codepoint, the lengths, the match
    ids at e + rel (once each) for every token end e, every output byte."""
    pred, tokens = _split_model(layout)
    tt = pred._tag_tables()
    c, t, ln, edges = chip_smoke.token_batch(16, 64, 9, tokens)
    for (cps, cts, lengths), e, least in (
            (chip_smoke.random_batch(16, 64, 7, tokens), None, 1),
            ((c, t, ln), edges, 100)):  # rows of tokens only
        batch = chip_smoke.tag_inputs(pred, cps, cts, lengths, e)
        assert chip_smoke.tag_work(tt, batch) == _tag_work_by_position(
            tt, batch)
        assert chip_smoke.tag_work(tt, batch)[1] >= least


def _tag_work_by_position(tt, batch):
    from vaporetto_tpu_torch.ops.tags import serve_tags_plain

    out = serve_tags_plain(tt, *batch)
    tid = out[1].to(torch.int32).numpy()
    if tt.packed_tc:
        tid = (tid & 0x7F) - 1
    lengths = batch[2].numpy()
    B, L = tid.shape
    probed = set()
    for b in range(B):
        for e in range(L):
            if tid[b, e] < 0:
                continue
            for t in tt.tabs:
                if batch[4 + t.side] is not None and e + t.rel < L:
                    probed.add((t.side, b, e + t.rel))
    live = int(np.sum(lengths))
    gaps = int(np.sum(np.maximum(lengths - 1, 0)))
    written = sum(o.numel() * o.element_size() for o in out)
    return (2 * live + 4 * gaps + 4 * len(probed) + 4 * B + written,
            int((tid >= 0).sum()))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_shortest_token_rows_hold_the_most_tokens(layout):
    """Rows of the shortest tokens back to back: every span is a token,
    and a row holds as many as fit in its width."""
    pred, tokens = _split_model(layout)
    n = min(map(len, tokens))
    c, t, ln, edges = chip_smoke.shortest_token_batch(4, 512, 3, tokens)
    assert (ln == 512 // n * n).all()
    batch = chip_smoke.tag_inputs(pred, c, t, ln, edges)
    assert chip_smoke.tag_work(pred._tag_tables(), batch)[1] == 4 * (512 // n)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_far_key_batch_ends_probes_at_long_runs(layout):
    """Each match id the far-key batch sets is the state of a key placed at
    least 4 slots past its home, for the token ending ``rel`` chars
    before it, and the plain version finds those tokens."""
    from vaporetto_tpu_torch.compile.tagdev import _hash_slots

    pred, tokens = _split_model(layout)
    dt = pred.device_tag_tables()
    c, t, ln, edges, states = chip_smoke.far_key_batch(pred, 6, 64, 4)
    assert states
    batch = chip_smoke.tag_inputs(pred, c, t, ln, edges, states)
    tt = pred._tag_tables()
    from vaporetto_tpu_torch.ops.tags import serve_tags_plain

    out = serve_tags_plain(tt, *batch)
    tid = out[1].to(torch.int32).numpy()
    tid = (tid & 0x7F) - 1 if tt.packed_tc else tid
    tabs = {(0, x.rel): x for x in dt.char_tabs}
    tabs.update({(1, x.rel): x for x in dt.type_tabs})
    far = 0
    for side, b, pos, st in states:
        assert batch[4 + side][b, pos] == st
        for (s, rel), x in tabs.items():
            e = pos - rel
            if s != side or e < 0 or tid[b, e] < 0:
                continue
            slot = np.flatnonzero((x.ver_tid == tid[b, e])
                                  & (x.ver_state == st))
            if len(slot):
                home = _hash_slots(x.ver_tid[slot], x.ver_state[slot],
                                   x.shift)
                far += int(((slot - home) & (len(x.ver_tid) - 1))[0] >= 4)
    assert far >= len(states) // 2


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tag_probe_work_counts_the_kernel_rule(layout):
    """tag_probe_work against a per-token count of the kernel's probe
    rule (stop at the key, at an empty slot, or after probe_len slots)."""
    pred, tokens = _split_model(layout)
    c, t, ln, edges = chip_smoke.token_batch(8, 64, 5, tokens)
    batch = chip_smoke.tag_inputs(pred, c, t, ln, edges)
    got = chip_smoke.tag_probe_work(pred, batch)
    assert got == _probe_work_by_token(pred, batch)
    assert got["hits"] > 0 and got["probe slots"] > got["tokens"]


def _probe_work_by_token(pred, batch):
    from vaporetto_tpu_torch.compile.tagdev import _hash_slots
    from vaporetto_tpu_torch.ops.tags import serve_tags_plain

    tt = pred._tag_tables()
    dt = pred.device_tag_tables()
    out = serve_tags_plain(tt, *batch)
    tid = out[1].to(torch.int32).numpy()
    tid = (tid & 0x7F) - 1 if tt.packed_tc else tid
    B, L = tid.shape
    hits = slots = 0
    for side, tabs in ((0, dt.char_tabs), (1, dt.type_tabs)):
        m = batch[4 + side]
        if m is None:
            continue
        m = m.numpy()
        for x in tabs:
            for b, e in zip(*np.nonzero(tid >= 0)):
                st = m[b, e + x.rel] if e + x.rel < L else -1
                home = int(_hash_slots(tid[b, e:e + 1], np.array([st]),
                                       x.shift)[0])
                for p in range(x.probe_len):
                    s = (home + p) & (len(x.ver_tid) - 1)
                    slots += 1
                    if x.ver_tid[s] == tid[b, e] and x.ver_state[s] == st:
                        hits += 1
                        break
                    if x.ver_tid[s] == -2:
                        break
    n = int((tid >= 0).sum())
    return {"tokens": n, "hits": hits, "probe slots": slots,
            "table bytes read": 8 * slots + (4 + 4 * tt.C) * hits
            + (4 * tt.C + 8 * tt.S) * n}
