#!/usr/bin/env python3
"""Runs one cell of the benchmark of ``vaporetto_tpu_torch``:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. Set-up (timed
as ``setup_s``, from the process's start to the window's first read) builds
or finds the program's host library and kernels in the checkout's build
directory, draws the cell's model from the seed and builds the system
under test on it, draws the cell's pool of lines from the seed, and warms
the program on a short pass of the same traffic that also touches each of
the cell's shape buckets. The window then runs the system (by default the
predict CLI's lean path, ``portbench/system.py``) on a reader that serves
the pool in a loop until ``--seconds`` have passed, into an in-memory sink;
``mchar_s`` is every char of every line fed over the wall time from the
first read to the last write. The cell's configuration names the modules
of its generator, system, reference and yardstick (``portbench/spec.py``).
Once the window has closed and the device's peak is read, the program's
state is freed and its output is held to the plain reference
(``portbench/check.py``); each number compared is printed with its limit
as the last lines of standard error and under ``compared`` in the result,
the last line of standard output. ``--trace 1`` reports the per-layer
metrics instead of the end-to-end ones.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

#: top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "vaporetto_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def warm_streams(corpus, n_first: int, bucket_of):
    """The warm-up passes: for each shape bucket of the lines over 64 chars
    (the unpacked route) its longest line, the largest bucket first so that
    each host buffer grows once, each beside a short line in one order and
    then in the other, so that both of the program's host buffer sets see
    it; then the pool's first ``n_first`` lines."""
    import numpy as np

    chars = corpus.chars
    short = np.flatnonzero(chars <= 64)
    long_ = np.flatnonzero(chars > 64)
    tops = []
    if len(short) and len(long_):
        buckets = np.array([bucket_of(int(c)) for c in chars[long_]])
        for b in np.unique(buckets):
            sel = long_[buckets == b]
            tops.append(int(sel[np.argmax(chars[sel])]))
    s = int(short[0]) if len(short) else None
    first = list(range(min(n_first, corpus.n_lines)))

    def stream(idx):
        return b"".join(corpus.data[int(corpus.starts[i]):
                                    int(corpus.ends[i]) + 1] for i in idx)

    tops = tops[::-1]
    return [stream([i for t in tops for i in (t, s)]),
            stream([i for t in tops for i in (s, t)]), stream(first)]


def run_cell(cell, seed: int, seconds: float, trace: bool, *, t0: float,
             device=None, batch_size=None, read_bytes=None,
             make_system=None, config_overrides=None,
             traffic_overrides=None):
    """One run of ``cell`` (:class:`portbench.spec.Cell`) on ``device``
    (None: the current CUDA card). ``make_system(raw, device,
    batch_size)`` replaces the system under test (the control, and the
    tests' faults); the overrides replace keys of the configuration and
    the traffic, ``batch_size`` the CLI's lines a batch and ``read_bytes``
    the reader's (tests at a small size on the CPU). Returns (result line,
    numbers compared)."""
    import numpy as np
    import torch

    from portbench import check, spec, stream, trace as tr
    from portbench import traffic as traffic_gen
    from portbench import work

    generator, system, reference, yardstick = (
        cell.module(k) for k in ("generator", "system", "reference", "work"))
    config = dict(cell.config, **(config_overrides or {}))
    mix = dict(cell.traffic, **(traffic_overrides or {}))
    on_cuda = device is None or str(device).startswith("cuda")
    marks = {"start": time.perf_counter()}
    if on_cuda:
        system.prebuild()
    marks["build"] = time.perf_counter()
    raw = generator.generate(config, seed)
    marks["model"] = time.perf_counter()
    corpus = traffic_gen.generate(mix, raw, seed)
    marks["pool"] = time.perf_counter()
    sut = (make_system or system.System)(raw, device, batch_size)
    marks["predictor"] = time.perf_counter()
    for i, data in enumerate(warm_streams(corpus, int(mix["warm_lines"]),
                                          system.bucket_of)):
        sut.run(io.BytesIO(data), stream.Sink())
        if on_cuda:
            torch.cuda.synchronize()
        marks[f"warm{i}"] = time.perf_counter()
    server = sut.server
    stats0 = {k: v for k, v in server.stats.items()
              if isinstance(v, (int, float))}
    reader = stream.Reader(corpus, seconds,
                           **({"read_bytes": read_bytes} if read_bytes else {}))
    sink = stream.Sink(head_records=corpus.n_lines,
                       rng=np.random.default_rng([int(seed), 0x736E6B]))
    spans = prof = None
    if trace:
        spans = tr.Spans()
        spans.install(server, reader, sink)
        if on_cuda:
            prof = tr.profiler()
            prof.__enter__()
    w0_ns = time.time_ns()
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    sut.run(reader, sink)
    if on_cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    w1_ns = time.time_ns()
    cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    if prof is not None:
        prof.__exit__(None, None, None)
    if spans is not None:
        spans.uninstall()
    window_s = t_end - reader.t0
    setup_s = reader.t0 - t0
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if on_cuda else 0}
    stats = {k: server.stats[k] - v for k, v in stats0.items()}
    lines, chars = reader.lines_fed, reader.chars_fed
    tables = sut.table_bytes() if on_cuda else 0
    del server, sut
    if on_cuda:
        torch.cuda.empty_cache()
    log(f"[setup] {setup_s:.3f} s: " + ", ".join(
        f"{k} {v - t0:.3f}" for k, v in marks.items())
        + f"; {tables} B of tables on the device")
    log(f"[window] {window_s:.3f} s, {lines} lines, {chars} chars, "
        f"{sink.total} B out ({sink.head_len} B kept whole and "
        f"{len(sink.kept)} later writes), pool {corpus.n_lines} lines")
    log(f"[stats] {json.dumps(stats)}")
    log(f"[host] {cpu1.ru_utime - cpu0.ru_utime:.3f} user s, "
        f"{cpu1.ru_stime - cpu0.ru_stime:.3f} system s, "
        f"{cpu1.ru_nivcsw - cpu0.ru_nivcsw} involuntary and "
        f"{cpu1.ru_nvcsw - cpu0.ru_nvcsw} voluntary switches in the window")
    step = max(window_s / 10, 1e-9)
    edges = [max((b for t, b in sink.marks if t - reader.t0 <= k * step),
                 default=0) for k in range(11)]
    log("[rate] MB written a second by tenth of the window: " + " ".join(
        f"{(b - a) / step / 1e6:.4f}" for a, b in zip(edges, edges[1:])))
    # the comparison, on the host, once the window has closed
    t_check = time.perf_counter()
    ref = reference.Reference(raw)
    judged = check.judge(sink, corpus, lines, ref.render,
                         int(mix["sample_lines"]),
                         np.random.default_rng([int(seed), 0x63686B]))
    log(f"[check] {time.perf_counter() - t_check:.3f} s, "
        f"{json.dumps(judged['info'])}")
    result = {"correct": judged["correct"], "attempted": lines,
              "failed": judged["missing"]}
    if not trace:
        values = {"mchar_s": chars / window_s / 1e6, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        reduced = None
        if prof is not None:
            t_tr = time.perf_counter()
            reduced = tr.reduce(tr.device_events(prof), (w0_ns, w1_ns),
                                spans.spans)
            log(f"[trace] {time.perf_counter() - t_tr:.3f} s, "
                + json.dumps({k: v for k, v in (reduced or {}).items()
                              if k != "op_s"}))
        log(f"[spans] host s by stage: {json.dumps(spans.self_seconds())}")
        ctx = {"window_s": window_s, "lines": lines, "chars": chars,
               "stats": stats, "trace": reduced,
               "kernel_bytes": yardstick.kernel_bytes(config, raw, corpus,
                                                      lines, chars),
               "peak_bytes_per_s": work.HBM_BYTES_PER_S}
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if reduced is not None:
            dev["busy_s"] = reduced["busy_s"]
            dev["window_s"] = reduced["window_s"]
            result["breakdown"] = {"device_ops": reduced["device_ops"],
                                   "idle_gaps": reduced["idle_gaps"]}
    result["metrics"] = metrics
    result["device"] = dev
    nums = judged["numbers"]
    result["compared"] = {k: {"value": v, "limit": check.LIMITS[k]}
                          for k, v in nums.items()}
    order = ["correct", "attempted", "failed", "metrics", "device",
             "breakdown", "compared"]
    return {k: result[k] for k in order if k in result}, nums


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from portbench import spec

    cell = spec.Cell.find(spec.load(), args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        log(f"error: {args.workload} needs {cell.chips} CUDA card(s); "
            f"found {have}")
        return 2
    torch.cuda.set_device(0)
    result, nums = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            t0=_T0)
    bad = forbidden_modules()
    if bad:
        log(f"error: the run loaded {', '.join(bad)}")
        return 3
    for k, v in nums.items():
        log(f"{k} {v} limit {result['compared'][k]['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
