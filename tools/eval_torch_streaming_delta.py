"""How far streaming inference agrees with two-pass inference, in the
PyTorch port.

    python3 tools/eval_torch_streaming_delta.py [--scenes 3] [--frames 4]
        [--dtype float32] [--out FILE]
    python3 tools/eval_torch_streaming_delta.py --device cpu --tiny

Port of ``tools/eval_streaming_delta.py``.  Streaming (``predict_streaming``)
takes the adjacent frame's feature from the previous frame's camera voxel
feature, warped into the new ego frame; two-pass (``forward``) pools the
adjacent images again through their own pose.  This tool measures what the
warp costs, with the two-pass prediction as the label set, on a synthetic
clip per scene: scene s, frame t is the synthetic batch of seed 100*s + t,
whose ego is 0.5 m ahead of the frame before, and whose adjacent images are
the frame before's key images (its adjacent pose is already 0.5 m behind).
It prints, as one JSON object:

- ``agree_by_frame``: the share of voxels where the two argmax maps agree,
  per frame of the clip, averaged over scenes (at frame 0 the cache is
  empty, and streaming takes the key frame's feature for the adjacent
  one);
- ``divergence_miou``: the mIoU of streaming against two-pass through
  ``eval.metrics.OccupancyMetric``, over every voxel of frames 1..;
- ``iou_vs_twopass`` and ``agree_by_class``: per class, the IoU and the
  share of the two-pass voxels of that class that streaming also gives it;
- ``rel_logit_mae``: mean |logit difference| / mean |two-pass logit|.

By default it runs the default multi-modal configuration at full size in
bf16 (``--dtype float32``: the kernels' fp32 bodies) on the card, with
``spread_weights`` from seed 0;
``--device cpu --tiny`` runs the tiny configuration (LiDAR encoder on the
z-folded path) in fp32 on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from typing import List

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fusionocc_tpu_torch import config as tcfg  # noqa: E402
from fusionocc_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from fusionocc_tpu_torch.eval.metrics import (  # noqa: E402
    CLASS_NAMES, OccupancyMetric, miou_from_hist)
from fusionocc_tpu_torch.models.fusion_occ import (  # noqa: E402
    Batch, FusionOcc, batch_pooling_indices, spread_weights)


def tiny_config() -> tcfg.ModelConfig:
    """The tiny preset with its LiDAR encoder on the port's z-folded path."""
    cfg = tcfg.tiny_model_config()
    return dataclasses.replace(
        cfg, lidar=dataclasses.replace(cfg.lidar, backend='zfold'))


def clip_frames(cfg, first_seed: int, n_frames: int, device,
                num_points=None) -> List[Batch]:
    """Synthetic frames of seeds first_seed, first_seed + 1, ...: frame t's
    adjacent images are frame t-1's key images."""
    frames = []
    for t in range(n_frames):
        b = synthetic_batch(cfg, 1, first_seed + t, num_points=num_points,
                            device=device)
        if frames:
            b = b._replace(imgs=torch.cat(
                [b.imgs[:, :1], frames[-1].imgs[:, :1]], dim=1))
        frames.append(b)
    return frames


@torch.inference_mode()
def streaming_delta(model: FusionOcc, clips: List[List[Batch]]) -> dict:
    """Two-pass ``forward`` and ``predict_streaming`` on every frame of
    every clip (a fresh cache per clip); the rig is one, so the pooling
    indices are built once."""
    cfg = model.cfg
    idxs = batch_pooling_indices(cfg, clips[0][0])
    metric = OccupancyMetric(cfg.num_classes)
    agree = [[] for _ in clips[0]]
    diff = ref = 0.0
    classes = torch.zeros(cfg.num_classes, dtype=torch.int64)
    for clip in clips:
        state = model.init_streaming_state(1)
        for t, batch in enumerate(clip):
            full = model(batch, idxs)['occ_logits']
            _, out, state = model.predict_streaming(batch, state, idxs[0])
            stream = out['occ_logits']
            pf, ps = full.argmax(-1), stream.argmax(-1)
            classes += torch.bincount(pf.flatten(),
                                      minlength=cfg.num_classes).cpu()
            agree[t].append((pf == ps).float().mean().item())
            if t > 0:           # frame 0 has no cache to warp
                metric.update(ps, pf)
                diff += (stream - full).abs().sum().item()
                ref += full.abs().sum().item()
    hist = metric.hist.cpu().numpy()
    iou = miou_from_hist(hist)
    rows = hist.sum(1)
    return {
        'agree_by_frame': [sum(a) / len(a) for a in agree],
        'divergence_miou': iou.pop('mIoU'),
        'iou_vs_twopass': iou,
        'agree_by_class': {CLASS_NAMES[c]: float(hist[c, c] / rows[c])
                           for c in range(cfg.num_classes) if rows[c]},
        'rel_logit_mae': diff / max(ref, 1e-9),
        'twopass_voxels_by_class': classes.tolist(),
        'n_scenes': len(clips), 'n_frames': len(clips[0]),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--tiny', action='store_true',
                    help='the tiny configuration in fp32 (else full size)')
    ap.add_argument('--scenes', type=int, default=3)
    ap.add_argument('--frames', type=int, default=4)
    ap.add_argument('--dtype', choices=('bfloat16', 'float32'),
                    help="compute dtype (the configuration's by default)")
    ap.add_argument('--out', help='also write the JSON object here')
    args = ap.parse_args()
    if args.tiny:
        cfg, num_points, config = tiny_config(), 512, 'tiny'
    else:
        cfg, num_points, config = tcfg.full_model_config(), None, 'full'
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    card = ''
    if torch.device(args.device).type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True).stdout.strip()
        print(f'card: {card}', flush=True)
    model = spread_weights(FusionOcc(cfg, device=args.device),
                           torch.Generator().manual_seed(0))
    clips = [clip_frames(cfg, 100 * s, args.frames, args.device, num_points)
             for s in range(args.scenes)]
    out = streaming_delta(model, clips)
    for t, a in enumerate(out['agree_by_frame']):
        print(f'frame {t}: streaming/two-pass voxel agreement {a:.6f}',
              flush=True)
    out.update(config=config, dtype=str(cfg.dtype).split('.')[-1],
               device=args.device, card=card)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + '\n')


if __name__ == '__main__':
    main()
