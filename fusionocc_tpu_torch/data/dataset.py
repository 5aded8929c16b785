"""nuScenes occupancy dataset: pkl infos -> model-ready samples.

The port's copy of ``fusionocc_tpu/data/dataset.py``: the same samples from
the same files, as numpy; ``data_loader`` stacks them into the port's
``Batch`` of CPU tensors (pinned with ``pin_memory``), and the loop moves
each batch to the card (``pipeline.to_device``).

Host-side equivalent of NuScenesDatasetOccpancy + its transform pipeline
(reference: fusionocc/datasets/fusionocc_dataset.py:137-478 and
configs/fusion_occ.py:153-211):

  per index:
    - current info + adjacent camera frames (multi_adj_frame_id_cfg,
      default (1,2,1) -> 1 previous frame) + adjacent lidar sweeps
      ((1,8,1) -> 7 previous frames), clamped at scene boundaries by
      duplicating the current frame (fusionocc_dataset.py:253-266)
    - PrepareImageSeg: load 6 cams x num_frame JPEGs, per-camera aug,
      normalization (R<->B quirk), seg label maps
    - LoadOccGTFromFile: labels.npz -> semantics + masks
    - points: load + FuseAdjacentSweeps + lidar->ego + range filter
    - LoadAnnotationsAll: BDA matrix, GT/point flips
    - PointToMultiViewDepth: z-buffered per-camera sparse depth
    - pad/stack into the static-shape Batch
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import ModelConfig
from ..geometry import pose_matrix, sensor2keyego_chain
from . import pipeline as pl

CAM_ORDER = ['CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
             'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT']


class NuScenesOccDataset:
    """Maps index -> dict of Batch fields (numpy, unbatched)."""

    def __init__(self, ann_file: str, cfg: ModelConfig,
                 data_root: str = '', img_seg_dir: Optional[str] = None,
                 train: bool = False, seed: int = 0,
                 adj_cam: Tuple[int, int, int] = (1, 2, 1),
                 adj_lidar: Tuple[int, int, int] = (1, 8, 1)):
        self.cfg = cfg
        self.train = train
        self.data_root = data_root
        self.img_seg_dir = img_seg_dir
        self.adj_cam_ids = list(range(*adj_cam))
        self.adj_lidar_ids = list(range(*adj_lidar))
        # RNG is derived per (seed, epoch, index) inside __getitem__ — a
        # shared RandomState would race under the threaded loader and make
        # augmentations depend on worker interleaving.  Reference analog:
        # per-worker seeding via DistSamplerSeedHook (configs/fusion_occ.py:412).
        self.seed = seed
        self.epoch = 0
        with open(ann_file, 'rb') as f:
            data = pickle.load(f)
        infos = data['data_list'] if 'data_list' in data else data['infos']
        self.infos = sorted(infos, key=lambda e: e['timestamp'])

    def __len__(self) -> int:
        return len(self.infos)

    def set_epoch(self, epoch: int) -> None:
        """Vary augmentations across epochs (DistSamplerSeedHook semantics)."""
        self.epoch = int(epoch)

    def _sample_rng(self, index: int) -> np.random.RandomState:
        """Thread-safe deterministic per-sample RNG: own the state locally."""
        mix = np.random.SeedSequence([self.seed, self.epoch, int(index)])
        return np.random.RandomState(mix.generate_state(1)[0])

    # -- adjacency (scene-bounded) -----------------------------------------
    def _adj_info(self, index: int, offset: int) -> Dict:
        j = index - offset
        if j < 0 or j >= len(self.infos):
            return self.infos[index]
        if self.infos[j].get('scene_token') != \
                self.infos[index].get('scene_token'):
            return self.infos[index]
        return self.infos[j]

    def _path(self, p: str) -> str:
        if p.startswith('./'):
            p = p[2:]
        return os.path.join(self.data_root, p) if self.data_root else p

    # -- per-camera geometry ----------------------------------------------
    @staticmethod
    def _cam_poses(cam_info: Dict) -> Tuple[np.ndarray, np.ndarray]:
        s2e = pose_matrix(cam_info['sensor2ego_rotation'],
                          cam_info['sensor2ego_translation'])
        e2g = pose_matrix(cam_info['ego2global_rotation'],
                          cam_info['ego2global_translation'])
        return s2e, e2g

    def _load_camera_frames(self, infos: List[Dict],
                            rng: np.random.RandomState):
        """All frames x cams: images, seg labels, poses, intrinsics, aug."""
        from PIL import Image
        cfg = self.cfg
        F, N = len(infos), len(CAM_ORDER)
        H, W = cfg.input_size
        imgs = np.zeros((F, N, H, W, 3), np.float32)
        segs = np.full((N, H, W), 17, np.int32)
        s2e = np.zeros((F, N, 4, 4))
        e2g = np.zeros((F, N, 4, 4))
        intrins = np.zeros((F, N, 3, 3), np.float32)
        post_rots = np.zeros((F, N, 3, 3), np.float32)
        post_trans = np.zeros((F, N, 3), np.float32)

        # one aug per camera, shared across temporal frames (the reference
        # applies the same sampled aug to curr + adjacent, loading.py:430-456)
        augs = []
        for f, info in enumerate(infos):
            cams = info['cams']
            for n, cam_name in enumerate(CAM_ORDER):
                ci = cams[cam_name]
                path = self._path(ci['data_path'])
                img = Image.open(path)
                if f == 0:
                    augs.append(pl.sample_image_aug(
                        (img.size[1], img.size[0]), cfg.input_size,
                        self.train, rng))
                aug = augs[n]
                timg = pl.transform_image(img, aug)
                imgs[f, n] = pl.normalize_image(np.asarray(timg))
                pr, pt = pl.aug_homography(aug)
                post_rots[f, n], post_trans[f, n] = pr, pt
                intrins[f, n] = np.asarray(
                    ci.get('cam_intrinsic', ci.get('camera_intrinsics')),
                    np.float32)
                s2e[f, n], e2g[f, n] = self._cam_poses(ci)
                if f == 0 and self.img_seg_dir:
                    segs[n] = self._load_seg(path, aug)
        return imgs, segs, s2e, e2g, intrins, post_rots, post_trans, augs

    def _load_seg(self, img_path: str, aug: pl.ImageAug,
                  restore_upsample: int = 8) -> np.ndarray:
        """1/8-res .npy seg map -> full-res nearest -> same aug
        (loading.py:106-130)."""
        name = img_path.split('samples')[-1].replace('.jpg', '.npy')
        seg = np.load(os.path.join(self.img_seg_dir, name.lstrip('/')))
        seg = np.repeat(np.repeat(seg, restore_upsample, 1),
                        restore_upsample, 0)
        out = pl.transform_image(seg.astype(np.uint8), aug, nearest=True)
        return np.asarray(out, np.int32)

    # -- lidar --------------------------------------------------------------
    def _load_points(self, index: int, rng: np.random.RandomState
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        info = self.infos[index]
        l2e = pose_matrix(info['lidar2ego_rotation'],
                          info['lidar2ego_translation'])
        e2g = pose_matrix(info['ego2global_rotation'],
                          info['ego2global_translation'])
        curr = pl.load_points_bin(self._path(info['lidar_path']))
        sweeps = []
        for off in self.adj_lidar_ids:
            ai = self._adj_info(index, off)
            if ai is self.infos[index]:
                continue
            al2e = pose_matrix(ai['lidar2ego_rotation'],
                               ai['lidar2ego_translation'])
            ae2g = pose_matrix(ai['ego2global_rotation'],
                               ai['ego2global_translation'])
            sweeps.append((pl.load_points_bin(self._path(ai['lidar_path'])),
                           al2e, ae2g))
        fused = pl.fuse_adjacent_sweeps(curr, l2e, e2g, sweeps, rng)
        return fused, curr, l2e

    # -- main ---------------------------------------------------------------
    def __getitem__(self, index: int) -> Dict:
        cfg = self.cfg
        info = self.infos[index]
        rng = self._sample_rng(index)
        cam_infos = [info] + [self._adj_info(index, o)
                              for o in self.adj_cam_ids]
        (imgs, segs, s2e, e2g, intrins, post_rots, post_trans,
         augs) = self._load_camera_frames(cam_infos, rng)
        s2k = sensor2keyego_chain(s2e, e2g)

        # occupancy GT
        occ = np.load(os.path.join(self._path(info['occ_path']),
                                   'labels.npz'))
        voxel_semantics = occ['semantics'].astype(np.int32)
        mask_camera = occ['mask_camera'].astype(bool)
        mask_lidar = occ.get('mask_lidar', mask_camera).astype(bool)
        if self.train and cfg.mask_mode != 'baseline_with_mask':
            from .masks import build_training_mask
            mask_camera = build_training_mask(
                voxel_semantics, mask_camera.astype(np.uint8),
                cfg.mask_mode,
                dist_threshold_c=cfg.mask_dist_threshold_c).astype(bool)

        # points
        fused, curr_points, l2e = self._load_points(index, rng)
        ego_pts = pl.points_lidar_to_ego(fused, l2e)
        ego_pts = pl.filter_points_range(ego_pts, cfg.grid.point_cloud_range)

        # BDA
        bda, _, _, fdx, fdy = pl.sample_bda(rng, self.train)
        ego_pts = pl.apply_bda_to_points(ego_pts, bda)
        voxel_semantics, (mask_camera, mask_lidar) = pl.apply_bda_to_voxels(
            voxel_semantics, [mask_camera, mask_lidar], fdx, fdy)

        # sparse depth from CURRENT-frame raw points (depth_transforms.py:62+:
        # uses curr_points projected per camera with the full lidar2cam chain)
        H, W = cfg.input_size
        lidarego2global = pose_matrix(info['ego2global_rotation'],
                                      info['ego2global_translation'])
        sparse_depth = np.zeros((len(CAM_ORDER), H, W), np.float32)
        from .. import native
        for n, cam_name in enumerate(CAM_ORDER):
            ci = info['cams'][cam_name]
            cam2camego, camego2global = self._cam_poses(ci)
            lidar2cam = (np.linalg.inv(camego2global @ cam2camego)
                         @ lidarego2global @ l2e)
            cam2img = np.eye(4)
            cam2img[:3, :3] = intrins[0, n]
            lidar2img = cam2img @ lidar2cam
            uvd = native.project_points(curr_points, lidar2img,
                                        post_rots[0, n], post_trans[0, n])
            sparse_depth[n] = native.zbuffer_depth(
                uvd, H, W, (cfg.grid.depth[0], cfg.grid.depth[1]))

        points, points_mask = pl.pad_points(
            ego_pts, cfg.lidar.point_capacity,
            rng=rng if self.train else None)
        return dict(
            imgs=imgs, sensor2keyego=s2k, intrins=intrins,
            post_rots=post_rots, post_trans=post_trans, bda=bda,
            points=points, points_mask=points_mask,
            sparse_depth=sparse_depth, segs=segs,
            voxel_semantics=voxel_semantics, mask_camera=mask_camera,
            ego2global=lidarego2global.astype(np.float32))


def data_loader(dataset: NuScenesOccDataset, batch_size: int,
                shuffle: bool, seed: int = 0, drop_last: bool = True,
                max_resample: int = 8,
                host_id: int = 0, host_count: int = 1,
                num_workers: int = 4, pipeline_batches: int = 2,
                yield_indices: bool = False, pin_memory: bool = False):
    """Host loader: yields stacked Batches.

    Like the reference's BaseDataset error handling
    (fusionocc_dataset.py:93-106), a sample whose pipeline raises is replaced
    by resampling another index instead of crashing the epoch.

    host_id/host_count shard the (seed-synchronized) sample order across
    hosts — the jax-native replacement for DefaultSampler +
    DistSamplerSeedHook (configs/fusion_occ.py:321,412).

    num_workers: thread-pool width for per-sample fetch (JPEG decode /
    numpy transforms release the GIL), the reference's `workers_per_gpu=4`
    (configs/fusion_occ.py:317).  pipeline_batches: how many batches ahead
    to keep in flight.  yield_indices: yield (Batch, sample_indices) tuples
    instead of bare Batches (eval loops use the indices for scene-boundary
    detection).  pin_memory: stack into pinned CPU memory (batches bound for
    the card).
    """
    order = np.arange(len(dataset))
    rng = np.random.RandomState(seed)
    if shuffle:
        rng.shuffle(order)
    if host_count > 1:
        order = order[host_id::host_count]

    def fetch(j):
        j0 = int(j)
        for attempt in range(max_resample):
            try:
                return dataset[int(j)]
            except Exception as e:  # noqa: BLE001 — corrupt sample: resample
                print(f'[data] sample {j} failed ({type(e).__name__}: {e}); '
                      f'resampling', flush=True)
                # thread-local deterministic resample (shared rng would race)
                ss = np.random.SeedSequence([seed, j0, attempt])
                j = int(ss.generate_state(1)[0] % len(dataset))
        raise RuntimeError(f'{max_resample} consecutive sample failures')

    groups = []
    for i in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                   batch_size):
        idxs = order[i:i + batch_size]
        if drop_last and len(idxs) < batch_size:
            break
        groups.append(idxs)

    def emit(idxs, samples):
        b = pl.stack_batch(samples, pin_memory)
        return (b, idxs) if yield_indices else b

    if num_workers <= 0:
        for idxs in groups:
            yield emit(idxs, [fetch(j) for j in idxs])
        return

    import collections
    from concurrent.futures import ThreadPoolExecutor
    # keep enough batches in flight to occupy every worker even at batch 1
    window = max(1, pipeline_batches, -(-num_workers // batch_size))
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        inflight = collections.deque()
        gi = iter(groups)
        def fill():
            for idxs in gi:
                inflight.append((idxs, [ex.submit(fetch, j) for j in idxs]))
                if len(inflight) >= window:
                    break
        fill()
        while inflight:
            idxs, futs = inflight.popleft()
            samples = [f.result() for f in futs]
            fill()
            yield emit(idxs, samples)


def prefetch(iterator, depth: int = 2):
    """Background-thread prefetching wrapper (the dataloader-worker
    equivalent: overlaps host preprocessing with device steps).  An error in
    the producer is raised in the consumer."""
    import queue
    import threading

    q: 'queue.Queue' = queue.Queue(maxsize=depth)
    _END = object()
    error = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except Exception as e:  # noqa: BLE001 — raised in the consumer
            error.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if error:
                raise error[0]
            return
        yield item
