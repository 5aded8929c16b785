"""Evaluation CLI of the PyTorch port: the counterpart of ``tools/test.py``.

    python3 tools/test_torch.py --ann-file data/nuscenes/fusionocc-nuscenes_infos_val.pkl \
        --img-seg-dir data/nuscenes/img_seg --checkpoint work_dirs/fusion_occ_torch
    python3 tools/test_torch.py --synthetic --max-samples 4
    python3 tools/test_torch.py --tiny --device cpu --ann-file <infos.pkl> --buckets --rayiou

The same flags and the same output as ``tools/test.py``: one ``key: value``
line per result, then the result as one JSON line, last.  The model runs
on ``--device`` (the card unless ``cpu`` is asked for).  Samples come from
the port's ``NuScenesOccDataset`` through ``data_loader`` (4 threads) and
``prefetch``, stacked in pinned memory when the device is the card and
moved there one ``non_blocking`` copy per field; ``--synthetic`` takes
``synthetic_batch`` instead.  ``--config`` takes a preset of
``fusionocc_tpu_torch.configs`` with its evaluation protocol (metric,
eval-time camera mask, split) and its model (``configs.build_model``:
``bevdet_occ_stbase_stereo`` is BEVStereo4D-Occ, which reads a stereo
reference frame beyond the adjacent one and runs two-pass only: the tool
refuses ``--streaming`` and ``--batch-frames`` with it).  ``--tiny`` takes
the tiny model with its LiDAR encoder on the port's z-folded path (``backend='zfold'``,
``zconv='zband'``).  Without ``--checkpoint`` the weights are random, from
seed 0.

Two-pass (default), ``--streaming`` (one camera pass per frame, the cache
reset where the scene token changes) and ``--batch-frames`` (every frame
in one camera pass).  The key frame's pooling index is cached by its
geometry, as ``tools/test.py`` does.  ``--int8`` serves the Swin
backbone's Linears through int8 products (``SwinConfig.int8_dense``,
``quant.int8_linear``); ``--int8-weights`` quantizes every kernel to int8
per output channel and dequantizes it into the compute dtype before the
run (``quant.load_int8_weights``), as ``tools/test.py`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', default=None,
                    help='named preset of fusionocc_tpu_torch.configs: model '
                         'variant and eval protocol (metric, eval-time camera '
                         'mask, split)')
    ap.add_argument('--ann-file', default=None)
    ap.add_argument('--data-root', default='')
    ap.add_argument('--img-seg-dir', default=None)
    ap.add_argument('--checkpoint', default=None,
                    help="a step_<n> directory of the port's checkpoints, or "
                         'the work dir holding them (its latest)')
    ap.add_argument('--synthetic', action='store_true')
    ap.add_argument('--tiny', action='store_true')
    ap.add_argument('--max-samples', type=int, default=0)
    ap.add_argument('--batch-size', type=int, default=1)
    ap.add_argument('--warmup', type=int, default=5)
    ap.add_argument('--no-ema', action='store_true')
    ap.add_argument('--save-predictions', default=None,
                    help='directory for per-sample .npz prediction dumps')
    ap.add_argument('--buckets', action='store_true',
                    help='also report radius/height-bucketed mIoU')
    ap.add_argument('--rayiou', action='store_true',
                    help='also compute RayIoU from the batch point clouds')
    ap.add_argument('--streaming', action='store_true',
                    help='cached-BEV streaming inference (one camera pass '
                         'per frame; needs temporally ordered samples)')
    ap.add_argument('--batch-frames', action='store_true',
                    help='two-pass with every temporal frame in one camera '
                         'pass')
    ap.add_argument('--fp32', action='store_true',
                    help='fp32 compute instead of the default bf16')
    ap.add_argument('--int8-weights', action='store_true',
                    help='weight-only int8 post-training quantization '
                         '(every kernel, per output channel, dequantized '
                         'into the compute dtype)')
    ap.add_argument('--int8', action='store_true',
                    help='serve the image backbone with int8 x int8 -> '
                         'int32 products (dynamic activation '
                         'quantization)')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    if not args.synthetic and not args.ann_file:
        ap.error('pass --ann-file (an infos pkl) or --synthetic')
    from fusionocc_tpu_torch.configs import ARCHITECTURES
    if ARCHITECTURES.get(args.config, ('',))[0] == 'bevformer_occ':
        ap.error(f'--config {args.config} builds BEVFormerOcc, whose '
                 'evaluation loop is not ported here (its streamed path '
                 'runs in the benchmark cell bevformer_base_occ.'
                 'stream_temporal)')
    if (args.streaming or args.batch_frames) and args.config in ARCHITECTURES:
        ap.error(f'--config {args.config} builds '
                 f'{ARCHITECTURES[args.config][1]}, which runs two-pass only:'
                 ' --streaming and --batch-frames are FusionOcc\'s')
    return args


def tiny_config():
    """The tiny model with the LiDAR encoder on the port's z-folded path."""
    from fusionocc_tpu_torch.config import tiny_model_config
    cfg = tiny_model_config()
    return dataclasses.replace(cfg, lidar=dataclasses.replace(
        cfg.lidar, backend='zfold', zconv='zband'))


def resolve_config(args):
    """(model config, eval config) from the flags, as ``tools/test.py``
    chooses them; sets ``args.rayiou`` for the RayIoU protocols and moves
    ``args.ann_file`` to the preset's split."""
    from fusionocc_tpu_torch.config import EvalConfig, full_model_config
    eval_cfg = EvalConfig()
    if args.config:
        from fusionocc_tpu_torch.configs import get_config
        preset = get_config(args.config)
        model_cfg, eval_cfg = preset.model, preset.eval
        if eval_cfg.metric in ('rayiou', 'hybrid'):
            args.rayiou = True
        if args.ann_file and eval_cfg.split != 'val':
            args.ann_file = args.ann_file.replace(
                '_val.pkl', f'_{eval_cfg.split}.pkl')
    else:
        model_cfg = tiny_config() if args.tiny else full_model_config()
    if args.config and args.tiny:   # a preset without LiDAR keeps none
        tiny = tiny_config()
        model_cfg = dataclasses.replace(
            tiny, use_mask=model_cfg.use_mask,
            mask_mode=model_cfg.mask_mode, use_lidar=model_cfg.use_lidar,
            temperature=model_cfg.temperature,
            lidar_out_channels=(model_cfg.lidar_out_channels
                                and tiny.lidar_out_channels))
    if args.fp32:
        model_cfg = dataclasses.replace(model_cfg, compute_dtype='float32')
    if args.int8:
        model_cfg = dataclasses.replace(model_cfg, swin=dataclasses.replace(
            model_cfg.swin, int8_dense=True))
    return model_cfg, eval_cfg


def host_batches(args, cfg, pin: bool, frames: int):
    """(CPU Batch, scene tokens) pairs of ``frames`` temporal frames (the
    model's ``input_frames``): the dataset through ``data_loader`` and
    ``prefetch``, or synthetic batches (8 frames per scene token)."""
    if args.synthetic:
        from fusionocc_tpu_torch.data.synthetic import synthetic_batch
        n = args.max_samples or 4
        for i in range(n):
            yield (synthetic_batch(cfg, args.batch_size, seed=i,
                                   device='cpu', frames=frames),
                   [f'scene_{(i * args.batch_size + k) // 8}'
                    for k in range(args.batch_size)])
        return
    from fusionocc_tpu_torch.data.dataset import (NuScenesOccDataset,
                                                  data_loader, prefetch)
    ds = NuScenesOccDataset(args.ann_file, cfg, data_root=args.data_root,
                            img_seg_dir=args.img_seg_dir, train=False,
                            adj_cam=(1, frames, 1))
    count = 0
    for b, idxs in prefetch(data_loader(ds, args.batch_size, shuffle=False,
                                        yield_indices=True,
                                        pin_memory=pin)):
        if args.max_samples and count >= args.max_samples:
            return
        count += args.batch_size
        yield b, [ds.infos[int(j)].get('scene_token', '') for j in idxs]


class Evaluator:
    """The model's prediction in the chosen mode, with the key frame's
    pooling index cached by geometry and, when streaming, the cache reset
    where a sample's scene token changes."""

    def __init__(self, model, cfg, streaming: bool, batch_frames: bool,
                 batch_size: int):
        self.model, self.cfg = model, cfg
        self.streaming, self.batch_frames = streaming, batch_frames
        self.pool_cache = {}
        if streaming:
            self.state = model.init_streaming_state(batch_size)
            self.prev_scenes = [None] * batch_size

    def key_pool_idx(self, host, batch):
        """The key frame's pooling index, built once per geometry; the key
        is the host batch's bytes, so looking it up never waits on the
        card."""
        from fusionocc_tpu_torch.models.fusion_occ import frame_pooling_index
        geo = (host.sensor2keyego[:, 0], host.intrins[:, 0],
               host.post_rots[:, 0], host.post_trans[:, 0], host.bda)
        key = b''.join(g.numpy().tobytes() for g in geo)
        if key not in self.pool_cache:
            self.pool_cache[key] = frame_pooling_index(
                self.cfg, batch.sensor2keyego[:, 0], batch.intrins[:, 0],
                batch.post_rots[:, 0], batch.post_trans[:, 0], batch.bda)
        return self.pool_cache[key]

    def predict(self, host, batch, scenes):
        import torch
        if self.streaming:
            reset = torch.tensor([s != p for s, p in
                                  zip(scenes, self.prev_scenes)])
            self.prev_scenes = list(scenes)
            pred, _, self.state = self.model.predict_streaming(
                batch, self.state, pool_idx=self.key_pool_idx(host, batch),
                reset=reset.to(batch.imgs.device))
            return pred
        if self.batch_frames:
            # the folded frames' geometry moves with the ego: nothing to cache
            return self.model.predict(batch, batch_frames=True)
        idxs = ([self.key_pool_idx(host, batch)]
                + [None] * (self.cfg.num_frame - 1))
        return self.model.predict(batch, pool_idxs=idxs)


def build_model(args, cfg):
    """The ``--config`` preset's model (FusionOcc by default) on
    ``args.device``: seeded random weights, or the checkpoint's (its EMA
    unless ``--no-ema``); with ``--int8-weights`` every kernel quantized to
    int8 and dequantized into the compute dtype."""
    import torch

    from fusionocc_tpu_torch import configs
    from fusionocc_tpu_torch.models.fusion_occ import init_weights
    from fusionocc_tpu_torch.train import checkpoint as ckpt
    model = init_weights(configs.build_model(args.config, args.device, cfg),
                         torch.Generator().manual_seed(0))
    if args.checkpoint:
        path = (ckpt.latest_checkpoint(args.checkpoint)
                if os.path.isdir(args.checkpoint)
                and not os.path.isfile(os.path.join(args.checkpoint,
                                                    ckpt.STATE_FILE))
                else args.checkpoint)
        step = ckpt.load_for_eval(path, model, use_ema=not args.no_ema)
        print(f'loaded checkpoint {path} (step {step})')
    if args.int8_weights:
        from fusionocc_tpu_torch.quant import load_int8_weights
        load_int8_weights(model, cfg)
    return model


class Timings:
    """Host wall times (s) per batch of the loop's parts: waiting for the
    loader, the predict (synchronised), the device metric update and the
    host RayIoU update."""

    def __init__(self):
        self.wait, self.predict, self.metric, self.rayiou = [], [], [], []


def evaluate(args, model=None, on_batch=None):
    """Run the evaluation ``args`` asks for; returns (the result dict, the
    ``Timings``).  ``model``: use this model instead of building one;
    ``on_batch(host_batch, scenes, pred)`` is called after each predict."""
    import numpy as np
    import torch

    from fusionocc_tpu_torch.data.pipeline import to_device
    from fusionocc_tpu_torch.eval.metrics import OccupancyMetric
    from fusionocc_tpu_torch.eval.ray_metrics import (RayIoUMetric,
                                                      rays_from_points)
    from fusionocc_tpu_torch.utils.profiling import (device_memory_stats,
                                                     param_memory_report)

    cfg, eval_cfg = resolve_config(args)
    dev = torch.device(args.device)
    on_card = dev.type == 'cuda'
    if model is None:
        model = build_model(args, cfg)
    ev = Evaluator(model, cfg, args.streaming, args.batch_frames,
                   args.batch_size)
    # eval-time mask policy: the preset's protocol with --config, else the
    # model's own training-mask setting, as tools/test.py
    use_image_mask = (eval_cfg.use_image_mask if args.config
                      else cfg.use_mask)
    metric = OccupancyMetric(num_classes=cfg.num_classes,
                             use_image_mask=use_image_mask,
                             grid=cfg.grid if args.buckets else None)
    ray_metric = RayIoUMetric(cfg.grid)
    if args.save_predictions:
        os.makedirs(args.save_predictions, exist_ok=True)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    tm = Timings()
    lat = tm.predict
    count = 0
    gen = host_batches(args, cfg, pin=on_card, frames=model.input_frames)
    while True:
        t0 = time.perf_counter()
        try:
            host, scenes = next(gen)
        except StopIteration:
            break
        batch = to_device(host, dev)
        tm.wait.append(time.perf_counter() - t0)
        sync()
        t0 = time.perf_counter()
        pred = ev.predict(host, batch, scenes)
        sync()
        lat.append(time.perf_counter() - t0)
        if on_batch is not None:
            on_batch(host, scenes, pred)
        if batch.voxel_semantics is not None:
            t0 = time.perf_counter()
            metric.update(pred, batch.voxel_semantics,
                          mask_camera=batch.mask_camera)
            sync()
            tm.metric.append(time.perf_counter() - t0)
            if args.rayiou:
                t0 = time.perf_counter()
                pred_np = pred.cpu().numpy()
                for b in range(host.imgs.shape[0]):
                    pts = host.points[b].numpy()[host.points_mask[b].numpy()]
                    ray_metric.update(pred_np[b],
                                      host.voxel_semantics[b].numpy(),
                                      rays_from_points(pts, max_rays=4096))
                tm.rayiou.append(time.perf_counter() - t0)
        if args.save_predictions:
            np.savez_compressed(
                os.path.join(args.save_predictions, f'pred_{count:06d}.npz'),
                occ_pred=pred.cpu().numpy())
        count += host.imgs.shape[0]

    res = metric.compute()
    if args.rayiou and ray_metric.gt_cnt.sum() > 0:
        res.update(ray_metric.compute())
    warm = lat[min(args.warmup, len(lat) - 1):]
    res.update({
        'samples': count,
        'latency_mean_ms': round(float(np.mean(warm)) * 1000, 2),
        'latency_p50_ms': round(float(np.percentile(warm, 50)) * 1000, 2),
        'latency_p90_ms': round(float(np.percentile(warm, 90)) * 1000, 2),
        'fps': round(count / max(sum(lat), 1e-9), 3),
    })
    if on_card:
        for k, v in device_memory_stats(dev).items():
            res[f'mem_{k}_mb'] = round(v / 2 ** 20, 1)
    preport = param_memory_report(model)
    res['total_params'] = int(preport['total_params'])
    res['params_mb_fp32'] = round(preport['total_mb_fp32'], 1)
    return res, tm


def main(argv=None) -> None:
    res, _ = evaluate(parse_args(argv))
    for k, v in res.items():
        print(f'{k}: {v}')
    print(json.dumps(res))


if __name__ == '__main__':
    main()
