"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix and the readers of its
per-layer metrics are found by name from ``BENCHMARK.json``
(``harness/spec.py``).  The run builds the port's model and the mix's
inputs on the card from the seed, warms up every shape the mix uses
(``setup_s``, from the start of the process), then runs the mix's units
(frames or steps, each ending in a synchronise) back to back for
``--seconds``.  Then it frees the port's state, runs the plain reference
on a sample of what the window produced, and prints each compared number
beside its limit.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and ``compared`` last.

It exits with 2 and prints no result when there is no card, fewer cards
than the cell asks for, or a file of the cell is missing; with 3 when JAX
or the JAX package got loaded.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import types
from pathlib import Path

STARTED = time.perf_counter()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'fusionocc_tpu')


def process_age_s() -> float:
    """Seconds since this process started (from /proc where it exists)."""
    try:
        start = float(Path('/proc/self/stat').read_text().rsplit(')', 1)[1]
                      .split()[19]) / os.sysconf('SC_CLK_TCK')
        return float(Path('/proc/uptime').read_text().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - STARTED


def forbidden_modules():
    return sorted({m.split('.', 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    v = sorted(values)
    if not v:
        return math.nan
    x = (len(v) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def card_facts() -> dict:
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,power.draw,'
             'clocks.sm,clocks.max.sm,temperature.gpu',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ''
    return {'nvidia_smi': out}


def host_counters() -> dict:
    """The host's steal and total jiffies (``/proc/stat``) and this
    process's CPU seconds and context switches, for the window's notes."""
    import resource
    u = resource.getrusage(resource.RUSAGE_SELF)
    out = {'cpu_s': u.ru_utime + u.ru_stime, 'switches': u.ru_nvcsw,
           'preempted': u.ru_nivcsw}
    try:
        ticks = [int(x) for x in
                 Path('/proc/stat').read_text().split('\n', 1)[0].split()[1:]]
        out.update(jiffies=sum(ticks[:8]), steal=ticks[7])
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_during(a: dict, b: dict, wall: float) -> dict:
    """What the host did over a window between ``host_counters`` a and b:
    the machine's share of stolen time, this process's CPU seconds per
    second, its voluntary and involuntary context switches, the load."""
    out = {'cpu_per_s': (b['cpu_s'] - a['cpu_s']) / wall,
           'switches': b['switches'] - a['switches'],
           'preempted': b['preempted'] - a['preempted']}
    if 'jiffies' in a and 'jiffies' in b and b['jiffies'] > a['jiffies']:
        out['steal_share'] = ((b['steal'] - a['steal'])
                              / (b['jiffies'] - a['jiffies']))
    try:
        out['loadavg'] = Path('/proc/loadavg').read_text().split()[:3]
    except OSError:
        pass
    return out


def cache_dirs() -> None:
    """Build caches at fixed paths inside the checkout."""
    os.environ.setdefault('TRITON_CACHE_DIR',
                          str(ROOT / 'benchmark' / '_cache' / 'triton'))
    os.environ.setdefault('USE_FLAX', '0')


def window(drv, seconds: float, first: int):
    """Units back to back from unit ``first`` until ``seconds`` have
    passed: (latencies s, wall s, units)."""
    import torch
    lat = []
    i = first
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        a = time.perf_counter()
        if a >= end:
            break
        try:
            drv.step(i)
            torch.cuda.synchronize() if drv.ctx.cuda else None
            lat.append(time.perf_counter() - a)
        except Exception as e:          # a failed unit counts, and misses
            print(f'unit {i} failed: {e!r}', file=sys.stderr)
            lat.append(math.inf)
            drv.flags.append(None)
        i += 1
    return lat, time.perf_counter() - t0, i


def traced_stretches(drv, first: int, data, out_dir: Path, name: str):
    """The instrumented stretches at the start of a traced window, each
    of ``trace_units`` units from a cycle start: busy and profile (the
    same units again), clocks, syncs.  Returns the next unit."""
    import torch
    from torch.profiler import record_function

    from harness import trace
    P = drv.traffic['trace_units']
    i = -(-first // drv.cycle) * drv.cycle
    for _ in range(i - first):          # run up to a cycle start
        drv.step(first)
        first += 1
    torch.cuda.synchronize()
    out_dir.mkdir(parents=True, exist_ok=True)
    with trace.profiler(cpu=False) as prof:
        for k in range(P):
            drv.step(i + k)
            torch.cuda.synchronize()
    path = out_dir / f'{name}.busy.trace.json'
    prof.export_chrome_trace(str(path))
    data.profile_wall_s, data.busy_s, data.device_ops = trace.reduce_busy(
        path)
    data.profile_units = P
    data.profile_start = i
    with trace.profiler() as prof:
        for k in range(P):
            with record_function(trace.UNIT_SPAN):
                drv.step(i + k)
                torch.cuda.synchronize()
    path = out_dir / f'{name}.trace.json'
    prof.export_chrome_trace(str(path))
    data.idle_gaps = trace.idle_gaps(path)
    data.op_device_s = trace.op_device_seconds(prof)
    del prof
    i += P
    mods = {k: v for k, v in drv.modules().items() if v is not None}
    clocks = {k: trace.ModuleClock(v) for k, v in mods.items()}
    marks = trace.Marks()
    for k in range(P):
        marks.start()
        drv.step(i + k, mark=marks)
        torch.cuda.synchronize()
    data.module_ms = {k: c.ms() for k, c in clocks.items()}
    for c in clocks.values():
        c.remove()
    data.mark_ms = marks.ms()
    data.clock_units = P
    i += P
    with trace.SyncCounter(mods) as sc:
        for k in range(P):
            drv.step(i + k)
            torch.cuda.synchronize()
    data.syncs = dict(sc.counts)
    data.sync_units = P
    return i + P


def run(workload: str, seed: int, seconds: float, traced: bool,
        device: str = 'cuda', bench=None, conf=None, model_edit=None,
        traffic=None, out_dir: Path = ROOT / 'bench_out') -> dict:
    """One run of a cell; returns the result (the last line's object).
    ``conf``, ``traffic``: the configuration and the mix in place of the
    cell's files (the CPU tests' tiny sizes)."""
    import torch

    from harness import compare, spec, trace
    bench = bench or spec.load_benchmark(ROOT)
    w = spec.cell(bench, workload)
    entry = spec.config_entry(bench, w['config'])
    conf = conf or spec.load_json(ROOT, entry['file'])
    from harness import program
    defaulted = []
    program.port_config(conf, defaulted)
    tpath = spec.traffic_path(w['traffic'], ROOT)
    traffic = traffic or json.loads(tpath.read_text())
    drv_mod = spec.load_module(spec.driver_path(traffic['driver'], ROOT),
                               f'driver_{traffic["driver"]}')
    cuda = device == 'cuda'
    ctx = types.SimpleNamespace(conf=conf, traffic=traffic, seed=seed,
                                device=device, cuda=cuda,
                                model_edit=model_edit)
    drv = drv_mod.Driver(ctx)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = process_age_s()
    start_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    data = trace.TraceData()
    first = drv.cycle if hasattr(drv, 'cycle') else 0
    drv.flags = []
    if traced:
        first = traced_stretches(drv, first, data, out_dir, workload)
        drv.flags = []
    host0 = host_counters()
    lat, wall, last = window(drv, seconds, first)
    host = host_during(host0, host_counters(), wall)
    if cuda:
        torch.cuda.synchronize()
    units = len(lat)
    ok = [f is not None and bool(f) for f in drv.flags]
    failed = sum(1 for f in ok if not f)
    lat = [x if f else math.inf for x, f in zip(lat, ok)]
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    data.window_peak_bytes = window_peak
    data.plain_units, data.plain_wall_s = units, wall
    readers = {m['name']: spec.load_module(spec.reader_path(m['name'], ROOT),
                                           'reader_' + m['name'])
               for m in spec.per_layer(bench, workload)} if traced else {}
    if any(getattr(r, 'NEEDS_OP_CALLS', False) for r in readers.values()):
        rec = trace.OpRecorder()
        with rec:
            for k in range(data.profile_units):
                drv.step(data.profile_start + k, keep=False)
        if cuda:
            torch.cuda.synchronize()
        data.op_calls = dict(rec.calls)
    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
                   'count': 1,
                   'memory_peak_bytes': int(max(start_peak, window_peak))}
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers, ref_flops = drv.check(count=traced)
    data.ref_flops_per_unit = ref_flops
    correct = compare.held(numbers) and failed == 0
    metrics = {}
    if traced:
        for m in spec.per_layer(bench, workload):
            v = readers[m['name']].read(data, m['name'])
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        device_info['busy_s'] = data.busy_s
        device_info['window_s'] = data.profile_wall_s
    else:
        done = [x for x in lat if math.isfinite(x)]
        values = {
            'setup_s': setup_s,
            'frames_per_s': len(done) / wall,
            'samples_per_s': len(done) * drv.unit_samples / wall,
            'ms_p95': percentile(lat, 95) * 1e3,
        }
        for m in spec.end_to_end(bench, workload):
            key = traffic['reports'].get(m['name'], m['name'])
            metrics[m['name']] = {'value': values[key], 'unit': m['unit']}
    result = {'correct': correct, 'attempted': units, 'failed': failed,
              'metrics': metrics, 'device': device_info}
    if traced:
        result['breakdown'] = {'device_ops': data.device_ops,
                               'idle_gaps': data.idle_gaps}
    result['compared'] = {n: {'value': v, 'limit': lim}
                          for n, v, lim in numbers}
    result['_notes'] = {
        'window_s': wall, 'units': units, 'last_unit': last,
        'latency_ms_p50': percentile(lat, 50) * 1e3,
        'samples_beyond_p95': sum(1 for x in lat
                                  if x > percentile(lat, 95)),
        'setup_peak_bytes': start_peak,
        'readings': getattr(drv, 'readings', {}),
        'host': host, 'defaulted': defaulted}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    cache_dirs()
    from harness import spec
    try:
        bench = spec.load_benchmark(ROOT)
        w = spec.cell(bench, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f'benchmark: {e}', file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print('benchmark: no CUDA device; this benchmark runs on the card '
              'only', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w['chips']:
        print(f'benchmark: the cell asks for {w["chips"]} cards, '
              f'{torch.cuda.device_count()} found', file=sys.stderr)
        return 2
    facts = card_facts()
    print(f'card: {facts["nvidia_smi"]}', file=sys.stderr)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), bench=bench)
    except (OSError, KeyError) as e:
        print(f'benchmark: {e!r}', file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f'benchmark: loaded {bad}: the run must not import JAX or '
              'the JAX package', file=sys.stderr)
        return 3
    notes = result.pop('_notes')
    notes.update(card_facts())
    print('notes: ' + json.dumps(notes), file=sys.stderr)
    for n, c in result['compared'].items():
        print(f'compared {n} = {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
