"""The readings the limits of ``bevformer_base_occ.stream_temporal`` are set
from (not part of a benchmark run): ``calibrate.py``'s sound runs, and the
fp8 control through the cell's own reference, BEVFormer-Occ
(``calibrate.fp8_control`` builds FusionOcc's).

    python3 benchmark/calibrate_bevformer.py --seeds 1,2,3 --seconds 5 \
        [--control fp8]

Sound runs are ``calibrate.py``'s, on the BEVFormer cell; ``--control
fp8`` prints, per seed, the compared numbers with the reference computed
one precision below the configuration's (bfloat16 with fp8 products) in
the port's place, one JSON line each.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CELL = 'bevformer_base_occ.stream_temporal'


def fp8_numbers(seed: int, device: str = 'cuda', conf=None, traffic=None):
    """(compared numbers, readings) of the fp8 control of the cell;
    ``conf``, ``traffic`` in place of the cell's files."""
    from harness import spec
    bench = spec.load_benchmark(ROOT)
    w = spec.cell(bench, CELL)
    conf = conf or spec.load_json(ROOT, spec.config_entry(
        bench, w['config'])['file'])
    traffic = traffic or json.loads(
        spec.traffic_path(w['traffic'], ROOT).read_text())
    from reference.layers import fp8_products
    mod = spec.load_module(spec.driver_path(traffic['driver'], ROOT),
                           'driver_' + traffic['driver'])
    drv = mod.Driver(types.SimpleNamespace(
        conf=conf, traffic=traffic, seed=seed, device=device,
        cuda=device == 'cuda', model_edit=None))
    drv.make_inputs()
    _, ref = mod.reference_model(conf, seed, device,
                                 drv.cfg.model.compute_dtype)
    with fp8_products():
        drv.serve_reference(ref)
    del ref
    return drv.check()[0], drv.readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=5.0)
    ap.add_argument('--control', choices=('fp8',))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    import calibrate
    if args.control != 'fp8':
        return calibrate.main(['--workload', CELL, '--seeds', args.seeds,
                               '--seconds', str(args.seconds)])
    import torch

    import run
    run.cache_dirs()
    for seed in [int(s) for s in args.seeds.split(',')]:
        t = time.perf_counter()
        numbers, readings = fp8_numbers(seed)
        torch.cuda.empty_cache()
        print(json.dumps({'workload': CELL, 'seed': seed, 'control': 'fp8',
                          'correct': all(v == v and v <= lim
                                         for _, v, lim in numbers),
                          'compared': {n: {'value': v, 'limit': lim}
                                       for n, v, lim in numbers},
                          'readings': readings,
                          'seconds': time.perf_counter() - t}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
