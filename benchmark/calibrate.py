"""The readings the limits of ``correct`` are set from (not part of a
benchmark run).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 5 [--control fp8|int8]

For each seed, in one process: the cell's run with a short window (long
enough to serve the whole scene, so every sampled frame is compared) and
its compared numbers, one JSON line per seed.  ``--control int8``: the
control of the served cells, the port with its own lower-precision path
switched on (``swin.int8_dense``, int8 products in Swin-B's Linears);
``--control fp8``: the reference in the port's place, computed one
precision below the configuration's (bfloat16 with fp8 products), which
also stands for the training step.  The faults are planted by the CPU
tests (``test_harness.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def int8_serving(model_cfg):
    return dataclasses.replace(model_cfg, swin=dataclasses.replace(
        model_cfg.swin, int8_dense=True))


def _driver(workload: str, seed: int, device: str, conf=None):
    from harness import spec
    bench = spec.load_benchmark(ROOT)
    w = spec.cell(bench, workload)
    conf = conf or spec.load_json(ROOT, spec.config_entry(
        bench, w['config'])['file'])
    traffic = json.loads(spec.traffic_path(w['traffic'], ROOT).read_text())
    mod = spec.load_module(spec.driver_path(traffic['driver'], ROOT),
                           'driver_' + traffic['driver'])
    ctx = types.SimpleNamespace(conf=conf, traffic=traffic, seed=seed,
                                device=device, cuda=device == 'cuda',
                                model_edit=None)
    return mod, mod.Driver(ctx), conf


def fp8_control(workload: str, seed: int, device: str = 'cuda', conf=None,
                traffic=None):
    """The cell's numbers with the reference in the port's place, computed
    one precision below the configuration's: its stated compute dtype
    (bfloat16) with every Linear's and Conv's product on fp8 inputs."""
    from harness import program
    from reference.layers import fp8_products
    mod, drv, conf = _driver(workload, seed, device, conf)
    if traffic:
        drv.traffic = drv.ctx.traffic = traffic
        drv.cycle = traffic.get('frames', traffic.get('batches'))
    drv.make_inputs()
    dtype = program.port_config(conf).model.compute_dtype
    ref_cfg, ref = program.reference_model(conf, seed, device, dtype)
    with fp8_products():
        if hasattr(drv, 'serve_reference'):
            drv.serve_reference(ref)
        else:
            r = mod.follow(ref, ref_cfg, drv.cfg.seed, drv.fields, device)
            drv.losses, drv.grad, drv.change = (r['losses'], r['grad'],
                                                r['change'])
    del ref
    numbers = drv.check()[0]
    return numbers, getattr(drv, 'readings', {})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=5.0)
    ap.add_argument('--control', choices=('fp8', 'int8'))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    import torch

    import run
    run.cache_dirs()
    for seed in [int(s) for s in args.seeds.split(',')]:
        t = time.perf_counter()
        if args.control == 'fp8':
            numbers, readings = fp8_control(args.workload, seed)
            res = {'compared': {n: {'value': v, 'limit': lim}
                                for n, v, lim in numbers},
                   '_notes': {'readings': readings}}
        else:
            res = run.run(args.workload, seed, args.seconds, False,
                          model_edit=(int8_serving if args.control == 'int8'
                                      else None))
        torch.cuda.empty_cache()
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'control': args.control,
                          'correct': res.get('correct'),
                          'compared': res['compared'],
                          'metrics': res.get('metrics'),
                          'readings': res['_notes']['readings'],
                          'seconds': time.perf_counter() - t}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
