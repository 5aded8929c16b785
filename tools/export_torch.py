"""Serving export of the PyTorch port: the counterpart of ``tools/export.py``.

    python3 tools/export_torch.py --out /tmp/fusionocc.pt2 [--tiny] [--fp32] \
        [--int8-weights] [--streaming] [--verify] [--checkpoint DIR] \
        [--device cpu]

``torch.export.export`` traces ``FusionOcc.predict`` (or, with
``--streaming``, ``predict_streaming``: the batch and the
``StreamingState`` in, the prediction and the new state out) on a
synthetic batch and ``torch.export.save`` writes the program: its graph,
the weights and the custom ops it calls (``fusionocc::bev_pool``,
``fusionocc::window_attn``, Swin's glue ``fusionocc::window_in`` and
``window_out`` (traced under ``no_grad``, so the eval path's),
``fusionocc::zwin_conv`` and, with
``lidar.zwin_fuse``, ``fusionocc::zwin_conv_epi``, and each sparse stage's
index builds ``fusionocc::stride2_count``, ``stride2_set`` and
``stage_maps``: the hand-written kernels on the card, their plain versions
on the CPU).  A process that loads the
program imports ``fusionocc_tpu_torch.ops`` first, so the ops are
registered.  The program takes flat tensors, in the order of
``Batch``'s fields up to ``sparse_depth`` (then ``ego2global`` and the
three ``StreamingState`` tensors when streaming).

While tracing, the index builds take the static capacities of the config
(the JAX package's shapes) instead of reading padded widths from the card,
so the program holds no data-dependent shape; padding rows are masked as
at any width.  ``--verify`` loads the saved program, runs it on the batch
and requires its prediction to equal the eager one exactly, as
``tools/export.py`` does.  ``--int8-weights`` quantizes every kernel to
int8 per output channel and dequantizes it into the compute dtype before
the export.  Without ``--checkpoint`` the weights are random, from seed 0.
The model runs on ``--device`` (the card unless ``cpu`` is asked for).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

BATCH_FIELDS = ('imgs', 'sensor2keyego', 'intrins', 'post_rots',
                'post_trans', 'bda', 'points', 'points_mask', 'sparse_depth')


class PredictProgram(torch.nn.Module):
    """``model.predict`` on flat batch tensors: the (B, X, Y, Z) uint8
    classes."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *tensors):
        from fusionocc_tpu_torch.models.fusion_occ import Batch
        return self.model.predict(Batch(*tensors))


class StreamingProgram(torch.nn.Module):
    """``model.predict_streaming`` on flat tensors: the batch's fields,
    ``ego2global`` and the cache (voxel_feat, ego2global, valid) in; the
    prediction and the new cache out."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *tensors):
        from fusionocc_tpu_torch.models.fusion_occ import (Batch,
                                                           StreamingState)
        n = len(BATCH_FIELDS)
        batch = Batch(*tensors[:n], ego2global=tensors[n])
        pred, _, state = self.model.predict_streaming(
            batch, StreamingState(*tensors[n + 1:]))
        return (pred, *state)


def program_args(batch, state=None) -> tuple:
    """The flat inputs of ``PredictProgram`` (``state`` None) or
    ``StreamingProgram``."""
    args = tuple(getattr(batch, f) for f in BATCH_FIELDS)
    if state is None:
        return args
    return args + (batch.ego2global, *state)


def export_program(model, batch, state=None):
    """``torch.export.export`` of the predict (``state`` None) or of the
    streaming step, traced under ``torch.no_grad``.  Returns the
    ``ExportedProgram``."""
    program = (PredictProgram(model) if state is None
               else StreamingProgram(model))
    with torch.no_grad():
        return torch.export.export(program, program_args(batch, state),
                                   strict=False)


def run_loaded(path: str, batch, state=None):
    """Load a saved program and run it once on ``batch``: the prediction
    (and, streaming, the new cache tensors)."""
    # importing the kernels' modules registers their ops
    from fusionocc_tpu_torch.ops import (bev_pool, sparse_conv,  # noqa: F401
                                         swin_glue, window_attn, zwin_conv)
    program = torch.export.load(path).module()
    with torch.no_grad():
        return program(*program_args(batch, state))


def eager(model, batch, state=None):
    """The eager prediction (and, streaming, the new cache tensors)."""
    if state is None:
        return model.predict(batch)
    pred, _, new_state = model.predict_streaming(batch, state)
    return (pred, *new_state)


def model_config(tiny: bool, fp32: bool):
    """The default config, or the tiny one on the port's z-folded LiDAR
    path (``tools/test_torch.tiny_config``)."""
    from fusionocc_tpu_torch.config import full_model_config
    from tools.test_torch import tiny_config
    cfg = tiny_config() if tiny else full_model_config()
    if fp32:
        cfg = dataclasses.replace(cfg, compute_dtype='float32')
    return cfg


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', required=True)
    ap.add_argument('--checkpoint', default=None,
                    help="a step_<n> directory of the port's checkpoints, or "
                         'the work dir holding them (its latest); its EMA '
                         'weights are exported')
    ap.add_argument('--tiny', action='store_true')
    ap.add_argument('--fp32', action='store_true')
    ap.add_argument('--int8-weights', action='store_true',
                    help='weight-only int8 post-training quantization '
                         'before export')
    ap.add_argument('--verify', action='store_true',
                    help='load the saved program and compare its output '
                         'with the eager one')
    ap.add_argument('--streaming', action='store_true',
                    help='export the streaming serving step instead '
                         '(predict_streaming: batch + StreamingState in, '
                         'prediction + new state out)')
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.train import checkpoint as ckpt

    cfg = model_config(args.tiny, args.fp32)
    model = init_weights(FusionOcc(cfg, device=args.device),
                         torch.Generator().manual_seed(0))
    if args.checkpoint:
        path = (ckpt.latest_checkpoint(args.checkpoint)
                if os.path.isdir(args.checkpoint)
                and not os.path.isfile(os.path.join(args.checkpoint,
                                                    ckpt.STATE_FILE))
                else args.checkpoint)
        ckpt.load_for_eval(path, model, use_ema=True)
    if args.int8_weights:
        from fusionocc_tpu_torch.quant import load_int8_weights
        print('int8 weights:', load_int8_weights(model, cfg))
    batch = synthetic_batch(cfg, 1, 0, num_points=512 if args.tiny else None,
                            device=args.device)
    state = model.init_streaming_state(1) if args.streaming else None

    t0 = time.perf_counter()
    exported = export_program(model, batch, state)
    export_s = time.perf_counter() - t0
    torch.export.save(exported, args.out)
    size = os.path.getsize(args.out)
    print(f'exported {size / 2**20:.1f} MiB program -> {args.out} '
          f'({export_s:.1f} s)')
    info = {'export_s': export_s, 'bytes': size}
    if args.verify:
        got = run_loaded(args.out, batch, state)
        want = eager(model, batch, state)
        got0 = got[0] if state is not None else got
        want0 = want[0] if state is not None else want
        assert torch.equal(got0, want0), 'roundtrip mismatch'
        print('verify: roundtrip output matches')
        info['verified'] = True
    return info


if __name__ == '__main__':
    main()
