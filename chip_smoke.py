"""GPU smoke run of the PyTorch port (``fusionocc_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card (nvidia-smi name and power limit), CUDA and nvcc
   versions, TF32 switched off for matmuls and cuDNN.
2. build: compiles ``fusionocc_tpu_torch/csrc/*.cu`` with nvcc, one process
   per source, all started together (timed), prints ptxas's registers,
   spills and wgmma serialization notes, and counts per kernel body in the
   library, with ``cuobjdump --dump-sass``, Hopper's warpgroup products
   (``HGMMA``), the sm_80 tensor-core products (``HMMA``), TMA loads
   (``UTMALDG``) and cp.async (``LDGSTS``): the bf16 bodies of K2 and K3
   (K3's with the fused epilogue too) must have HGMMA and UTMALDG.
3. kernels: each kernel against its plain PyTorch version at the shapes the
   full-size main path gives it, with errors, tolerances, times and bounds:
   window attention (K2) at the four Swin-B stage shapes, shift 0 and 6,
   bf16 (tensor cores), two launches bit-identical, each shape's share of
   its bound, and the time and bound per two-pass predict weighted by each
   shape's launches, beside ``scaled_dot_product_attention`` on the same
   inputs (each backend that takes them, the fastest reported as the library
   time); frustum pooling (K1) on the full-size pooling index of the
   synthetic rig, bf16 features to bf16 voxels (the main path) and fp32 to
   fp32, two launches bit-identical, beside ``embedding_bag`` on the same
   inputs and the kernel on an index with no in-grid point (the zero-fill
   alone); the zwin sparse conv (K3) at the 9 launches of the
   full-size LiDAR encoder, bf16 (tensor cores), two launches
   bit-identical, with the inputs that the port's encoder (seeded random
   weights) gives it on the full-size synthetic cloud; K3 with its fused
   eval epilogue (``zwin_conv_fwd_epi``, ``zwin_fuse=True``) at the same 9
   launches of an encoder whose BatchNorms are away from the identity, bf16
   and fp32, each launch timed beside the unfused chain it replaces (K3,
   MaskedBatchNorm, ReLU), which it must beat over the 9; then
   K3's microbenchmark (``tools/profile_torch_zwin_micro.py``) once at
   stage 1's SubM launch; then both bf16 bodies at small shapes the main
   path does not give them (K2 with N = 49 and 100, padded to 144; K3,
   plain and fused, with B = 2, Cout = 24, f_out = 4, Cin = 64, random maps
   with misses and mask holes); then the sparse stages' index builds
   (``csrc/sparse_index.cu``, the six ``index_*`` entries) against the plain
   build on the card, at the full-size synthetic clouds, B = 1 and B = 2,
   every sparse stage chained on the kernels' own output set: keys,
   coords, masks, both neighbour maps and the strided lane mask equal
   element for element, each stage's launches, and its ms (CUDA events
   around the build, which waits once) beside the plain build's; then the
   plane sweep (``csrc/plane_sweep.cu``) against its plain version at the
   stereo cell's shapes (6 cameras, 88 planes, 128x352, 128 bf16
   channels, the synthetic drive's 0.5-m step), the plain version run on
   the CPU: the bias masks agree on all but ``SWEEP_MASK_SHARE`` of the
   hypotheses, the volume within ``SWEEP_TOL`` on every pixel whose mask
   agrees, the kernel's ms beside the plain version's on the card and the
   0.454-ms bound; and one BEVStereo4D-Occ
   two-pass predict at full size with its launches gated (2 sweeps).
   Last, Swin's block glue (``csrc/swin_glue.cu``: ``window_in_fwd``, the
   previous block's residual add, norm1, pad, shift and window split;
   ``window_out_fwd``, window merge, unshift, crop, residual add, norm2) at
   the four stage shapes of a camera pass, shift 0 and 6, bf16, against
   its plain version on the card: the residual sums equal, the normed
   values within one bf16 ulp, two launches bit-identical, each launch's
   ms beside the plain version's and its bytes bound, and the time and
   bound per two-pass predict weighted by launches.
4. reference: the midsize multi-modal config in fp32 on the card (the
   kernels' fp32 bodies) against the same weights on the CPU (plain
   versions).
5. slice: three full-size bf16 paths with seeded random weights, per-frame
   pooling indices built once, ``predict`` on three synthetic batches (seeds
   0-2): the image-only preset, the default multi-modal config (the main
   path), and the same with ``zwin_fuse=True`` (K3's fused epilogue).  Each
   path checks its output and its launch counts per predict, and prints ms
   per predict and peak memory; the multi-modal paths also print the LiDAR
   encoder's own device time.  Then ``zwin_fuse`` True against False on the
   same weights (spread, BatchNorms away from the identity), every launch
   of the fused runs held against its plain version: argmax agreement at
   least 0.999 in fp32, logit differences printed in bf16 and fp32.  Then
   the host syncs of one LiDAR encoder pass (``torch.cuda``'s sync debug
   mode), fused and unfused, at batch 1, 4 and 8: one count at every batch
   size and at most one per build site.
6. streaming: the default config at full size, with seeded weights spread
   so that the argmax takes many classes (``spread_weights``), on a clip of
   8 synthetic frames (seeds 0-7, batch 1, the ego 0.5 m ahead each frame,
   frame t's adjacent images frame t-1's key images), kept on the card
   once.  In bf16 (the main path): the streaming-against-two-pass agreement
   per frame (``tools/eval_torch_streaming_delta.py``), which is also the
   warm-up clip; then, with a reset at frame 4, ms per frame, peak memory
   (also above what was allocated before the run) and the LiDAR encoder's
   device ms per frame of ``predict_streaming`` frame by frame,
   ``predict_streaming_scan`` and ``predict_streaming_batch`` at (chunk 4,
   cam_chunk 0) and (8, 4), each after one warm-up clip, and of
   ``predict(batch_frames=True)`` on seeds 0-2; the scan equal to the
   frames one by one, and the other modes' agreement printed.  In fp32
   (the kernels' fp32 bodies): the time fold within 0.999 of the scan's
   voxels and ``batch_frames`` of the per-frame two-pass's (in bf16 the
   random weights' near-tied logits flip about 6 % of argmaxes when cuDNN
   rounds at another batch size).  Every mode's launches are counted per
   frame, block or predict, and every output is finite.  In both dtypes,
   every kernel launch of one block of each time fold (K2 at 24 images, K1
   at 4 samples, K3 at 4 and 8) and of one ``batch_frames`` predict is held
   against its plain version; then batch 4 against 4 x batch 1, part by
   part: the image encoder, the LiDAR encoder and K1 on the fold's index
   must give the same bits, the rest is printed.  The bf16 fold at (8, 4)
   runs once more with each row table over all 8 samples, for its peak
   memory.  Last, ``predict_streaming`` over the clip with ``zwin_fuse``:
   once with every launch held against its plain version, once timed, and
   its agreement with the unfused path on the same weights.

7. training: (a) each kernel's autograd ``Function`` at the main-path
   shapes (K2 at the 8 stage/shift shapes, bf16; K1 on the full-size
   index, bf16 and fp32 out; K3 at the encoder's 9 launches, bf16): its
   gradients against autograd through the plain version, and its
   backward's ms; (b) one midsize multi-modal fp32 ``train_step`` on the
   card and on the CPU from the same weights, the random parts off: the
   loss and its terms, ``grad_norm``, every gradient (within 3x the CPU's
   own change when the images move by 1e-6, plus 1e-3 of its norm), the
   running statistics and the updated parameters; (c) the default
   full-size config in bf16 with fp32 parameters: 2 warm-up and 5 timed
   ``train_step``s on the batches of seeds 0-2, each step's launches gated
   against the counts from the code, its losses and ``grad_norm`` finite;
   s/iter (CUDA events and wall), the forward / backward / optimizer
   split, the peak memory above what was held before, and the device idle
   share and kernel table of one profiled step.

8. evaluation: writes one scene of 9 consecutive samples at full raw size
   in a temporary directory, as the port's dataset reads it (six cameras
   of 900x1600 JPEGs on the synthetic rig with nuScenes intrinsics, one
   ray-cast LiDAR sweep per sample with the ego 2.5 m further each time,
   ``labels.npz`` at 200x200x16, 1/8-resolution segmentation maps, the
   infos pkl); times the loader (the first 3 samples alone, then all 9
   through ``data_loader(num_workers=4)`` and ``prefetch``); asserts that
   the native z-buffer library was built and used; prints each sample's
   fused LiDAR cloud before ``pad_points`` and its distinct voxels against
   the capacities (ROADMAP Queue C's C2); runs ``tools/test_torch.py``'s
   loop in-process with ``spread_weights``, bf16, batch 1, two-pass with
   ``--buckets --rayiou``, ``--streaming`` and ``--batch-frames``, each
   run's launches counted ({48, 2, 9} per sample two-pass, {24, 1, 9}
   streamed and folded) and every result finite; the device idle share of
   one profiled two-pass ``--buckets`` run; the two-pass predictions equal
   ``predict`` on the same loaded batches (timed by CUDA events); the
   F-score of the first 3 on the host; ``fit_temperature`` on one sample's
   logits on the card; and, inside ``KernelCheck``, every
   K1, K2 and K3 launch of one loaded sample, two-pass and streamed,
   against its plain version.

9. data-parallel training over processes on the one card (spawned ranks,
   the kernels built by the parent): two ranks exchange CUDA tensors over
   gloo, because NCCL refuses two ranks on one device (gloo stages each
   collective through the host, so its times measure neither NCCL nor a
   second card and are no scaling figures). (a) 2 ranks x batch 1 against
   one process at batch 2, midsize fp32, the random draws on (drop path
   0.2), 2 steps: each step against one process's step from the same
   state (losses, gradients, grad_norm, parameters, running statistics,
   EMA; tolerances at ``held_to_one``), and the ranks' parameters, buffers
   and EMA bit-identical after each step; (b) NCCL at world 1 against the
   plain step, the same way; (c) the default full-size config in bf16,
   batch 1 per rank, 1 warm-up and 3 timed steps on 2 ranks: s/iter per
   rank (CUDA events, wall), the time inside collectives (the card
   synchronised around each), the collectives per step (BatchNorm
   statistics, losses, gradient buckets), the peak memory above what each
   rank held, launches gated as phase 7c gates them, the ranks
   bit-identical; beside them one process at batch 1 and at batch 2; (d)
   ``OccupancyMetric`` over 2 ranks, 2 predicted samples each, equal to
   one process over the 4.

10. serving, the default config at full size, bf16, ``spread_weights``:
   (a) one ``int8_dense`` predict with every int8 product taken through
   ``torch._int_mm`` and through the exact float64 product on the same
   operands, bit-equal, each distinct shape timed both ways; (b) the
   ``int8_dense`` two-pass predict beside the bf16 one on the same weights
   (ms per predict by CUDA events, Swin-B's device ms and share, logit drift
   over scale and argmax agreement printed beside JAX's tiny-model bounds
   0.08 and 0.99), launches gated; (c) the same for ``--int8-weights``
   (bounds 0.05 and 0.995); (d) ``tools/export_torch.py``'s export, save,
   load and run of the predict and of the streaming step: the loaded
   program's output equal to eager's, its launches counted through the
   program (tracing launches none), export, save and load times, the
   program's size and its ms beside eager's; (e) ``LSSViewTransformer``
   and ``LSSViewTransformerBEVDepth`` (plain and with a stereo cost volume)
   on the key frame's pooling index, one K1 launch each held against its
   plain version.

11. the hybrid data x spatial mesh, ranks spawned on the one card over
   gloo after the parent built the kernels (``parallel.mesh.hybrid_mesh``,
   ``parallel.hybrid.HybridFusionOcc(cfg, mesh)``; gloo stages every
   collective through the host, so these times are no scaling figures).
   The parent computes one process's references.  (a) Midsize fp32: the
   two-pass forward at (2, 2) and (1, 2) within HYB_TOL of one process,
   and at (1, 4) on one sample
   (the same 4 ranks: 2 cameras leave ranks 2 and 3 none, the last Y
   level's 5 rows rank 3 none; XLA pads such blocks); at (2, 2)
   ``predict_streaming_batch`` on a 4-frame clip with a reset (agreement
   at least 0.999, state within 5e-3) and one train step with the draws
   on, held as phase 9a holds a step, the 4 ranks' parameters and EMA
   bit-identical.  (b) The default config at full size, bf16, (2, 2),
   batch 1 per data rank: per rank the ms per two-pass predict (CUDA
   events, median of 3), the collectives per predict by kind with their
   bytes and the ms inside them, the halo rows sent per predict and per
   layer, the peak memory above what was held, the argmax agreement with
   one process (printed), launches gated 48 / 2 / 9 with rank 0's every
   launch held against its plain version (``KernelCheck``), and 1 + 2
   train steps (s/iter, launches gated as phase 7c's).

12. FLOPs and density: ``utils/flops.count_flops`` of a two-pass
   predict, a streamed frame and a train step at full size (bf16), each
   with the kernels (their formulas) and without them, by op; each
   kernel's FLOPs counted through its op at phase 3's shapes, equal to
   those its bound used; the two-pass predict's achieved TFLOP/s and its
   share of the bf16 peak; ``tools/density_sweep_torch.py`` at 1x, 1.5x and
   2x ``point_capacity``: the rows each capacity cut keeps and drops and
   the LiDAR encoder's device ms.

Phases 5 and 8 also print the rows each static capacity cut of the LiDAR
encoder drops (``capacity_cuts``, ROADMAP Queue C's C2), and the script
prints its whole time before the card's line.

A kernel's bound is the least time the card could take for the same work:
the larger of its operations over the peak rate of their type and its bytes
(each input read once, each output written once) over the memory rate,
from NVIDIA's H100 SXM data sheet.

The last two lines are the kernels' JSON summary (with each kernel's
launches per full-size train step, its backward's ms, its launches in
phase 8's two-pass evaluation of 9 samples, per rank per step of phase
9c, per int8 predict, per run of the loaded two-pass and streaming
programs and per base view transformer call of phase 10, and per rank per
full-size predict of phase 11b, and the FLOPs phase 3 bounded it by and
counted through its op) and the result JSON.
Needs a CUDA GPU; on a machine without one it exits 1 before doing anything.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import torch

DEV = 'cuda:0'
WA_TOL = dict(atol=1e-3, rtol=1e-2)    # bf16 output: one bf16 ulp is 2^-7 relative
POOL_TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums taken in another order
POOL_BF16_TOL = dict(atol=1e-4, rtol=2 ** -7)  # the same, cast: one bf16 ulp
ZWIN_TOL = dict(atol=1e-3, rtol=1e-2)  # fp32 sums cast once to bf16: one ulp
REF_TOL = dict(atol=2e-3, rtol=2e-3)   # fp32 model, GPU vs CPU
CACHE_TOL = dict(atol=1e-6, rtol=2 ** -7)  # bf16 cache: one ulp
# Swin's glue: a LayerNorm's fp32 sums in another order, rounded once to
# bf16 (one ulp); the residual sums are equal
GLUE_TOL = dict(atol=1e-3, rtol=2 ** -7)
# each kernel's tolerance by its output dtype, in model runs
KERNEL_TOLS = {torch.bfloat16: {'window_attn_fwd': WA_TOL,
                                'bev_pool_fwd': POOL_BF16_TOL,
                                'zwin_conv_fwd': ZWIN_TOL,
                                'zwin_conv_fwd_epi': ZWIN_TOL,
                                'window_in_fwd': GLUE_TOL,
                                'window_out_fwd': GLUE_TOL},
               torch.float32: {'window_attn_fwd': REF_TOL,
                               'bev_pool_fwd': POOL_TOL,
                               'zwin_conv_fwd': REF_TOL,
                               'zwin_conv_fwd_epi': REF_TOL,
                               'window_in_fwd': REF_TOL,
                               'window_out_fwd': REF_TOL}}
SLICE_SEEDS = (0, 1, 2)
CLIP_FRAMES, CLIP_RESET = 8, 4          # the streaming clip, its reset
MIN_AGREE = 0.999                       # voxels, between inference modes
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
PEAK_BYTES = 3.35e12
QUEUE_CYCLES = 20_000_000   # about 10 ms at the H100's SM clock
# a sparse stage's index builds (csrc/sparse_index.cu)
INDEX_KERNELS = ('index_mark', 'index_count', 'index_prefix', 'index_set',
                 'index_table', 'index_maps')
# Swin's block glue around K2 (csrc/swin_glue.cu): one of each a Swin block
# on every eval path without autograd, none in training
GLUE_KERNELS = ('window_in_fwd', 'window_out_fwd')
# the kernels of the main paths (K3 with or without its fused epilogue, the
# index builds, BEVStereo4D-Occ's plane sweep, Swin's glue); the launch
# checks read these counts only
MAIN_KERNELS = ('window_attn_fwd', 'bev_pool_fwd', 'zwin_conv_fwd',
                'zwin_conv_fwd_epi') + INDEX_KERNELS + ('plane_sweep_fwd',
                                                         ) + GLUE_KERNELS
# the plane sweep against its plain version: a tap at the frame's edge can
# change sides with the last bits of its coordinate, which flips the
# hypothesis's bias mask; elsewhere the sums differ in order only
SWEEP_MASK_SHARE = 1e-4
SWEEP_TOL = 1e-4
# where an encoder pass may wait for the card: voxelize, regroup, each
# sparse stage's table build (3), densify
SYNC_SITES = 6
# a pattern of each kernel body's mangled name -> (C entry, body, whether
# it must run on Hopper's tensor cores and load by TMA); the zwin bodies are
# instantiated per n8 tile count of the Cout part
KERNEL_BODIES = {
    r'window_attn_wgmma_kernelILb\dE': ('window_attn_fwd', 'bf16', True),
    r'window_attn_fp32_kernel': ('window_attn_fwd', 'fp32', False),
    r'zwin_conv_wgmma_kernelILi\dELi\dELb0ELb0E': ('zwin_conv_fwd', 'bf16',
                                                   True),
    r'zwin_conv_wgmma_kernelILi\dELi\dELb1ELb0E': ('zwin_conv_null',
                                                   'bf16, no products',
                                                   False),
    r'zwin_conv_wgmma_kernelILi\dELi\dELb0ELb1E': ('zwin_conv_fwd_epi',
                                                   'bf16, fused epilogue',
                                                   True),
    r'zwin_conv_fp32_kernelILb0E': ('zwin_conv_fwd', 'fp32', False),
    r'zwin_conv_fp32_kernelILb1E': ('zwin_conv_fwd_epi',
                                    'fp32, fused epilogue', False),
    r'bev_pool_fwd_kernelILb1ELb1E': ('bev_pool_fwd', 'bf16 feat, bf16 out',
                                      False),
    r'bev_pool_fwd_kernelILb1ELb0E': ('bev_pool_fwd', 'bf16 feat, fp32 out',
                                      False),
    r'bev_pool_fwd_kernelILb0ELb1E': ('bev_pool_fwd', 'fp32 feat, bf16 out',
                                      False),
    r'bev_pool_fwd_kernelILb0ELb0E': ('bev_pool_fwd', 'fp32 feat, fp32 out',
                                      False),
    r'11mark_kernel': ('index_mark', 'occupancy', False),
    r'12count_kernel': ('index_count', 'tile counts', False),
    r'13prefix_kernel': ('index_prefix', 'prefix count', False),
    r'10set_kernel': ('index_set', 'output set', False),
    r'12table_kernel': ('index_table', 'row table', False),
    r'11maps_kernel': ('index_maps', 'maps and lane mask', False),
    r'18plane_sweep_kernelItLi\d+E': ('plane_sweep_fwd', 'bf16', False),
    r'18plane_sweep_kernelIfLi\d+E': ('plane_sweep_fwd', 'fp32', False),
    r'16window_in_kernelI13__nv_bfloat16': ('window_in_fwd', 'bf16', False),
    r'16window_in_kernelIf': ('window_in_fwd', 'fp32', False),
    r'17window_out_kernelI13__nv_bfloat16': ('window_out_fwd', 'bf16',
                                              False),
    r'17window_out_kernelIf': ('window_out_fwd', 'fp32', False),
}
# SASS opcodes counted per body: Hopper's warpgroup products, the sm_80
# tensor-core products, TMA loads, cp.async
SASS_OPS = ('HGMMA', 'HMMA', 'UTMALDG', 'LDGSTS')


def fail(msg: str) -> None:
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def within(got, want, atol, rtol):
    """(all within atol + rtol*|want|, max abs error, max rel error)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return (bool((diff <= atol + rtol * want.abs()).all()), diff.max().item(),
            (diff / want.abs().clamp_min(1e-6)).max().item())


def check_close(name, got, want, atol, rtol):
    """Max abs / rel error of got vs want; fail beyond atol + rtol*|want|."""
    ok, max_abs, max_rel = within(got, want, atol, rtol)
    print(f'  {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} '
          f'(tol atol {atol:g} + rtol {rtol:g}*|plain|) '
          f'{"ok" if ok else "FAILED"}', flush=True)
    if not ok:
        fail(f'{name} disagrees with its plain version')
    return max_abs


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events over reps calls.  The
    card first sleeps (QUEUE_CYCLES) while the host queues the calls, so a
    kernel shorter than its wrapper's host time is timed, not the host."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Bound:
    """Summed least time of a kernel's launches: per launch the larger of
    flops / peak and bytes / memory rate.  ``flops`` sums the FLOPs each
    launch was bounded by, ``counted`` those that ``utils/flops.py``
    counts for the same launch through its op (``count``)."""

    def __init__(self):
        self.ms = {'bytes': 0.0, 'operations': 0.0}
        self.flops = self.counted = 0

    def count(self, op, *args) -> None:
        """Count the op's FLOPs on one launch's inputs (it launches the
        kernel once more)."""
        from fusionocc_tpu_torch.utils.flops import counted
        self.counted += counted(lambda: op(*args))['total']

    def add(self, flops: float, nbytes: float, dtype) -> float:
        self.flops += flops
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        by = 'bytes' if t_bytes >= t_ops else 'operations'
        self.ms[by] += max(t_ops, t_bytes)
        print(f'    bound {max(t_ops, t_bytes):.4f} ms by {by} '
              f'({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)', flush=True)
        return max(t_ops, t_bytes)

    def total(self):
        return sum(self.ms.values()), max(self.ms, key=self.ms.get)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'runs only on a CUDA GPU', file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ''
    print('[1/12] device: nvidia-smi name, power.limit:')
    print(card)
    from fusionocc_tpu_torch.ops.kernels import find_nvcc
    nvcc = subprocess.run([find_nvcc(), '--version'], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'  torch {torch.__version__}, torch.version.cuda '
          f'{torch.version.cuda}, nvcc: {nvcc[-1] if nvcc else "?"}')
    print(f'  device 0: {torch.cuda.get_device_name(0)}, count '
          f'{torch.cuda.device_count()}; allow_tf32: matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn '
          f'{torch.backends.cudnn.allow_tf32}; cudnn.benchmark '
          f'{torch.backends.cudnn.benchmark}', flush=True)
    return card


def sass_counts(lib) -> dict:
    """Per kernel function of the built library, the count of each opcode
    of SASS_OPS, from ``cuobjdump --dump-sass``."""
    import re
    from pathlib import Path
    from fusionocc_tpu_torch.ops.kernels import find_nvcc
    cuobjdump = Path(find_nvcc()).with_name('cuobjdump')
    sass = subprocess.run([str(cuobjdump), '--dump-sass', str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split('Function :', 1)[1].strip()
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            m = re.search(r'\b(' + '|'.join(SASS_OPS) + r')\b', line)
            if m:
                counts[name][m.group(1)] += 1
    return counts


def phase_build() -> None:
    import re
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    t0 = time.perf_counter()
    path = KERNELS.build()
    KERNELS.load()
    took = time.perf_counter() - t0
    how = ('compiled' if KERNELS.build_seconds is not None
           else 'found built')
    print(f'[2/12] build: {how} {path.name} in {took:.1f} s')
    for line in KERNELS.build_log.splitlines():
        if ('Used' in line or 'Compiling entry' in line or 'spill' in line
                or 'Performance Loss' in line):
            print('  ptxas' + line.split('ptxas', 1)[-1])
    counts = sass_counts(path)
    print('  per kernel body, cuobjdump --dump-sass: '
          + ', '.join(SASS_OPS) + ' (summed over instantiations)')
    for key, (entry, body, hopper) in KERNEL_BODIES.items():
        found = [n for n in counts if re.search(key, n)]
        if not found:
            fail(f'kernel body {key} ({entry}) not in the library')
        total = {op: sum(counts[n][op] for n in found) for op in SASS_OPS}
        print(f'    {entry} {body} ({key}, {len(found)} instantiations): '
              + ', '.join(f'{op} {total[op]}' for op in SASS_OPS),
              flush=True)
        if hopper and (total['HGMMA'] == 0 or total['UTMALDG'] == 0):
            fail(f'the {body} body of {entry} has no wgmma (HGMMA) or no '
                 'TMA load (UTMALDG)')
    sys.stdout.flush()


def stage_shapes(cfg):
    """(nWh, nWw, C, heads) of each Swin stage for one camera pass."""
    sw = cfg.swin
    w = sw.window_size
    h, wd = cfg.input_size[0] // sw.patch_size, cfg.input_size[1] // sw.patch_size
    out = []
    for i, c in enumerate(sw.num_features):
        out.append((-(-h // w), -(-wd // w), c, sw.num_heads[i]))
        h, wd = -(-h // 2), -(-wd // 2)
    return out


def sdpa_times(q, k, v, bias, nWh, nWw, w, shift, heads, want):
    """``scaled_dot_product_attention`` on K2's inputs, timed only: per
    backend that takes them, ms and max abs diff to the plain version.

    The additive mask (bias, plus the shift mask) is in q's dtype, as SDPA
    takes it, and broadcast, never copied per window: shift 0 gives every window
    the (heads, N, N) bias; a shifted layer views each camera's windows as
    nW*heads heads of one batch entry against one (nW*heads, N, N) mask."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from fusionocc_tpu_torch.ops import window_attn as wa
    bn, n, c = q.shape
    d = c // heads
    nw = nWh * nWw
    if shift:
        mask = (bias[None] + wa.shift_masks(nWh, nWw, w, shift, DEV)[:, None]
                ).reshape(1, nw * heads, n, n)
        groups = bn // nw
    else:
        mask, groups = bias[None], bn
    mask = mask.to(q.dtype)
    qh, kh, vh = (t.reshape(bn, n, heads, d).transpose(1, 2)
                  .reshape(groups, -1, n, d) for t in (q, k, v))
    times = {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.FLASH_ATTENTION, SDPBackend.MATH):
        def sdpa():
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=d ** -0.5)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                got = sdpa()
        except RuntimeError:
            continue                      # this backend refuses the inputs
        got = got.reshape(bn, heads, n, d).transpose(1, 2).reshape(bn, n, c)
        times[backend.name] = (cuda_ms(sdpa),
                               (got.float() - want.float()).abs().max().item())
    return times


def check_window_attn(cfg, g) -> dict:
    """K2 at the 8 stage/shift shapes, beside SDPA on the same inputs; two
    launches bit-identical; each shape's share of its bound, and the time
    and bound per two-pass predict weighted by the launches of each
    shape."""
    from fusionocc_tpu_torch.ops import window_attn as wa
    w = cfg.swin.window_size
    n = w * w
    err, ms, plain_ms, lib_ms, bound = 0.0, 0.0, 0.0, 0.0, Bound()
    predict_ms = predict_bound = 0.0
    # launches of a stage's shape (one shift) per two-pass predict: two
    # camera passes whose blocks alternate shift 0 and w // 2
    per_predict = list(cfg.swin.depths)
    for stage, (nWh, nWw, c, heads) in enumerate(stage_shapes(cfg)):
        bn = cfg.num_cams * nWh * nWw
        d = c // heads
        qkv = torch.randn(bn, n, 3 * c, device=DEV, generator=g
                          ).to(torch.bfloat16)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        bias = torch.randn(heads, n, n, device=DEV, generator=g)
        for shift in (0, w // 2):
            args = (q, k, v, bias, nWh, nWw, w, shift, heads)
            got = wa.window_attention_cuda(*args)
            want = wa.window_attention_plain(*args)
            torch.cuda.synchronize()
            name = (f'window_attn Bn={bn} C={c} heads={heads} '
                    f'grid={nWh}x{nWw} shift={shift}')
            err = max(err, check_close(name, got, want, **WA_TOL))
            if not torch.equal(got, wa.window_attention_cuda(*args)):
                fail(f'{name}: two launches differ')
            t_k = cuda_ms(lambda: wa.window_attention_cuda(*args))
            t_p = cuda_ms(lambda: wa.window_attention_plain(*args))
            sdpa = sdpa_times(*args, want)
            if not sdpa:
                fail(f'{name}: no SDPA backend takes these inputs')
            best = min(sdpa, key=lambda b: sdpa[b][0])
            ms, plain_ms = ms + t_k, plain_ms + t_p
            lib_ms += sdpa[best][0]
            print(f'    kernel {t_k:.4f} ms, plain {t_p:.4f} ms; sdpa by '
                  'backend (ms, max abs diff to plain): '
                  + ', '.join(f'{b} {t:.4f} {e:.2e}'
                              for b, (t, e) in sdpa.items())
                  + f'; fastest {best}', flush=True)
            b_ms = bound.add(4 * bn * heads * n * n * d,
                             4 * bn * n * c * 2 + heads * n * n * 4,
                             torch.bfloat16)
            print(f'    two launches bit-identical; {b_ms / t_k:.3f} of the '
                  f'bound; {per_predict[stage]} launches per two-pass '
                  'predict', flush=True)
            predict_ms += per_predict[stage] * t_k
            predict_bound += per_predict[stage] * b_ms
            bound.count(wa.window_attn_op, *args)
    bound_ms, bound_by = bound.total()
    print(f'  window_attn summed over the 8 shapes: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, sdpa (fastest backend per shape) '
          f'{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}',
          flush=True)
    print(f'  window_attn per two-pass predict ({2 * sum(per_predict)} '
          f'launches): kernel {predict_ms:.4f} ms, bound '
          f'{predict_bound:.4f} ms ({predict_bound / predict_ms:.3f} of it)',
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, flops=bound.flops,
                counted_flops=bound.counted, predict_ms=predict_ms,
                predict_bound_ms=predict_bound)


def embedding_bag_pool(depth_flat, feat_flat, ranks_depth, ranks_feat,
                       bounds):
    """K1's function as one PyTorch call, the library yardstick (the port
    never calls it): ``embedding_bag`` sums each voxel's gathered feature
    rows weighted by the gathered depth values.  ranks_*: the in-grid points
    (``bounds[-1]`` of them), int64 like ``bounds``."""
    import torch.nn.functional as F
    return F.embedding_bag(ranks_feat, feat_flat, bounds, mode='sum',
                           per_sample_weights=depth_flat[ranks_depth],
                           include_last_offset=True)


def check_bev_pool(cfg, batch0, g) -> dict:
    """K1 on the full-size pooling index of the synthetic rig: bf16 to bf16
    (the main path) and fp32 to fp32, beside ``embedding_bag`` and the
    zero-fill alone."""
    from fusionocc_tpu_torch.models.fusion_occ import frame_pooling_index
    from fusionocc_tpu_torch.ops import bev_pool as bp
    idx = frame_pooling_index(cfg, batch0.sensor2keyego[:, 0],
                              batch0.intrins[:, 0], batch0.post_rots[:, 0],
                              batch0.post_trans[:, 0], batch0.bda)
    B, N, D = 1, cfg.num_cams, cfg.grid.num_depth_bins
    h, wf = cfg.feat_size
    C = cfg.vt.feature_channels
    gx, gy, gz = cfg.grid.grid_size
    nvox = B * gz * gy * gx
    depth = torch.softmax(torch.randn(B, N, D, h, wf, device=DEV, generator=g),
                          dim=2).reshape(-1)
    feat32 = torch.randn(B * N * h * wf, C, device=DEV, generator=g)
    feat16 = feat32.bfloat16()
    n_in = int(idx.bounds[-1])
    runs = idx.bounds[1:] - idx.bounds[:-1]
    n_long = idx.long_voxels.numel()
    print(f'  bev_pool index: P={idx.ranks_depth.numel()} in-grid={n_in} '
          f'C={C} voxels={nvox} (non-empty {int((runs > 0).sum())}); '
          f'longest run {int(runs.max())}; work table: {n_long} runs longer '
          f'than {idx.max_short} points (warp items, '
          f'{int(runs[idx.long_voxels.long()].sum())} points)', flush=True)
    cases = {}
    for f_in, out in ((feat16, torch.bfloat16), (feat32, torch.float32),
                      (feat16, torch.float32), (feat32, torch.bfloat16)):
        got = bp.bev_pool_cuda(depth, f_in, idx, nvox, out)
        again = bp.bev_pool_cuda(depth, f_in, idx, nvox, out)
        want = bp.bev_pool_plain(depth, f_in, idx, nvox).to(out)
        torch.cuda.synchronize()
        name = f'bev_pool {f_in.dtype} feat -> {out} out'
        tol = POOL_BF16_TOL if out == torch.bfloat16 else POOL_TOL
        err = check_close(name, got, want, **tol)
        if not torch.equal(got, again):
            fail(f'{name}: two launches differ')
        print('    two launches bit-identical', flush=True)
        cases[out, f_in.dtype] = err
    main_args = (depth, feat16, idx, nvox, torch.bfloat16)
    fp32_args = (depth, feat32, idx, nvox, torch.float32)
    # every point out of the grid: the kernel writes zeros only
    empty = idx._replace(ranks_bev=torch.full_like(idx.ranks_bev, nvox),
                         bounds=torch.zeros_like(idx.bounds),
                         long_voxels=idx.long_voxels[:0])
    if bp.bev_pool_cuda(depth, feat16, empty, nvox, torch.bfloat16).any():
        fail('bev_pool on an index with no in-grid point is not all zeros')
    rd, rf = idx.ranks_depth[:n_in], idx.ranks_feat[:n_in].long()
    bounds64 = idx.bounds.long()
    lib = embedding_bag_pool(depth, feat32, rd, rf, bounds64)
    lib_err = (lib - bp.bev_pool_plain(depth, feat32, idx, nvox)
               ).abs().max().item()
    t_k = cuda_ms(lambda: bp.bev_pool_cuda(*main_args))
    t_k32 = cuda_ms(lambda: bp.bev_pool_cuda(*fp32_args))
    t_p = cuda_ms(lambda: bp.bev_pool_plain(*main_args[:4]).to(
        torch.bfloat16))
    t_lib = cuda_ms(lambda: embedding_bag_pool(depth, feat32, rd, rf,
                                               bounds64))
    t_fill = cuda_ms(lambda: bp.bev_pool_cuda(depth, feat16, empty, nvox,
                                              torch.bfloat16))
    t_fill32 = cuda_ms(lambda: bp.bev_pool_cuda(depth, feat32, empty, nvox,
                                                torch.float32))
    print(f'    per launch: kernel bf16 {t_k:.4f} ms, fp32 {t_k32:.4f} ms; '
          f'plain (bf16 out) {t_p:.4f} ms; embedding_bag (fp32 weights, '
          f'depth gather included) {t_lib:.4f} ms, max abs diff to plain '
          f'{lib_err:.2e}; zero-fill alone (no in-grid point) bf16 '
          f'{t_fill:.4f} ms, fp32 {t_fill32:.4f} ms', flush=True)
    # the in-grid points' two ranks and depth value, every feature row, the
    # work table (bounds and long items), the pooled voxels written
    table = (nvox + 1) * 4 + n_long * 4
    bounds_ms = {}
    for name, f_in, es in (('bf16', feat16, 2), ('fp32', feat32, 4)):
        bound = Bound()
        print(f'    {name} out:', flush=True)
        bound.add(2 * n_in * C, n_in * 12 + f_in.numel() * f_in.element_size()
                  + table + nvox * C * es, torch.float32)
        bound.count(bp.bev_pool_op, depth, f_in, idx.ranks_depth,
                    idx.ranks_feat, idx.ranks_bev, idx.bounds,
                    idx.long_voxels, nvox, idx.max_short, f_in.dtype)
        bounds_ms[name] = bound.total() + (bound.flops, bound.counted)
    bound_ms, bound_by, flops, counted_flops = bounds_ms['bf16']
    return dict(max_abs_err=cases[torch.bfloat16, torch.bfloat16], ms=t_k,
                plain_ms=t_p, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=t_lib, flops=flops, counted_flops=counted_flops,
                fp32_max_abs_err=cases[torch.float32,
                                                         torch.float32],
                fp32_ms=t_k32, fp32_bound_ms=bounds_ms['fp32'][0],
                zero_fill_ms=t_fill, fp32_zero_fill_ms=t_fill32)


def zwin_plan(name, weight, f_in, f_out, stride) -> tuple:
    """The bf16 body's (zb, Cout parts, stages) at this launch, as the built
    library picks it; fails unless ``ops/zwin_conv.bf16_plan``, the copy
    that the CPU tests and tools read, picks the same."""
    from fusionocc_tpu_torch.ops import zwin_conv as zw
    cin, cout = weight.shape[1], weight.shape[2]
    nzi_max = max(n for _, n in zw.z_bands(f_in, f_out, stride))
    built = zw.built_bf16_plan(cin, cout, nzi_max)
    copy = zw.bf16_plan(cin, cout, nzi_max)
    if copy != built:
        fail(f'{name}: ops/zwin_conv.bf16_plan gives {copy}, the library '
             f'launches {built}')
    return built


def check_zwin(cfg, batch0) -> dict:
    """K3 at the full-size encoder's 9 launches, then its microbenchmark
    at stage 1's SubM launch."""
    from fusionocc_tpu_torch.ops import zwin_conv as zw
    from fusionocc_tpu_torch.ops.voxelize import voxelize_mean
    from tools import profile_torch_zwin_micro as micro
    lc = cfg.lidar
    calls = micro.record_zwin_launches(cfg, batch0, DEV)
    sp = voxelize_mean(batch0.points, batch0.points_mask,
                       cfg.grid.point_cloud_range, lc.voxel_size,
                       lc.sparse_shape(cfg.grid), lc.voxel_capacity[0])
    print(f'  full-size cloud: {int(batch0.points_mask.sum())} points, '
          f'{int(sp.mask.sum())} voxels (JAX capacity '
          f'{lc.voxel_capacity[0]})', flush=True)
    caps = cfg.lidar.zfold_capacity
    err, ms, plain_ms, bound = 0.0, 0.0, 0.0, Bound()
    stage = 0
    for feats, mask_out, nbr, weight, f_in, f_out, stride in calls:
        args = (feats, mask_out, nbr, weight, f_in, f_out, stride)
        B, s_in, l_in = feats.shape
        s_out = nbr.shape[1]
        cin, cout = weight.shape[1], weight.shape[2]
        kind = 'subm' if stride == 1 else 'down'
        cap = caps[stage] if stride == 1 else caps[stage + 1]
        name = (f'zwin stage {stage} {kind} Cin {cin}->{cout} L {l_in}->'
                f'{f_out * cout} rows {s_in}->{s_out} (active '
                f'{int(mask_out.sum())}, JAX capacity {cap})')
        got = zw.zwin_conv_cuda(*args)
        want = zw.zwin_conv_plain(*args)
        torch.cuda.synchronize()
        err = max(err, check_close(name, got, want, **ZWIN_TOL))
        if not torch.equal(got, zw.zwin_conv_cuda(*args)):
            fail(f'{name}: two launches differ')
        plan = zwin_plan(name, weight, f_in, f_out, stride)
        t_k = cuda_ms(lambda: zw.zwin_conv_cuda(*args))
        t_p = cuda_ms(lambda: zw.zwin_conv_plain(*args))
        ms, plain_ms = ms + t_k, plain_ms + t_p
        print(f'    two launches bit-identical; plan (zb, Cout parts, '
              f'stages) {plan}, as bf16_plan; kernel {t_k:.4f} ms, plain '
              f'{t_p:.4f} ms, no single PyTorch call', flush=True)
        # found taps of active rows, each over its band's nonzero
        # (zi, zo) cell pairs; feats, nbr, mask and weight read, out written
        found = ((nbr < s_in) & mask_out[..., None]).sum(dim=(0, 1)).tolist()
        macs = sum(found[t] * len(zw.band_pairs(f_in, f_out, stride, t % 3))
                   * cin * cout for t in range(27))
        es = feats.element_size()
        bound.add(2 * macs, feats.numel() * es + nbr.numel() * 4
                  + mask_out.numel() + 27 * cin * cout * es
                  + B * s_out * f_out * cout * es, feats.dtype)
        bound.count(zw.zwin_conv_op, *args)
        if stride == 2:
            stage += 1
    if len(calls) != 9:
        fail(f'the full-size encoder made {len(calls)} zwin calls, not 9')
    bound_ms, bound_by = bound.total()
    print(f'  zwin summed over the 9 launches: kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}',
          flush=True)
    print('  K3 microbenchmark (tools/profile_torch_zwin_micro.py) at stage '
          "1's SubM launch:", flush=True)
    stage1 = micro.stage1_subm(calls)
    micro.report(micro.run(stage1), stage1, indent='    ')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, flops=bound.flops,
                counted_flops=bound.counted)


@torch.no_grad()
def bn_away_from_identity(model, generator) -> None:
    """The LiDAR encoder's BatchNorms with statistics and parameters away
    from the identity (``init_weights`` leaves mean 0, var 1, scale 1, bias
    0), so the fused epilogue's affine is exercised."""
    from fusionocc_tpu_torch.nn.layers import MaskedBatchNorm
    for bn in model.modules():
        if isinstance(bn, MaskedBatchNorm):
            c = bn.num_features
            for t, v in ((bn.running_mean, 0.1 * torch.randn(c, generator=
                                                              generator)),
                         (bn.running_var, 0.5 + torch.rand(c, generator=
                                                           generator)),
                         (bn.weight, 1 + 0.1 * torch.randn(c, generator=
                                                           generator)),
                         (bn.bias, 0.1 * torch.randn(c, generator=generator))):
                t.copy_(v)


def fused_launches(cfg, batch):
    """The fused zwin calls (9 at full size) of the port's encoder with
    ``zwin_fuse=True`` (seeded random weights, BatchNorms away from the
    identity) on ``batch``, each with the MaskedBatchNorm it fuses."""
    import dataclasses
    from fusionocc_tpu_torch.models import lidar_encoder as le
    from fusionocc_tpu_torch.models.fusion_occ import init_weights
    g = torch.Generator().manual_seed(5)
    enc = init_weights(le.SparseEncoder(
        dataclasses.replace(cfg.lidar, zwin_fuse=True), cfg.grid, cfg.dtype,
        DEV), g)
    bn_away_from_identity(enc, g)
    calls = []

    def record(*args):
        calls.append(args)
        return real(*args)
    real, le.zwin_conv_epi = le.zwin_conv_epi, record
    try:
        with torch.inference_mode():
            enc(batch.points, batch.points_mask)
    finally:
        le.zwin_conv_epi = real
    bns = [conv[1] for conv in enc.modules()
           if isinstance(conv, le.SparseConvBN)]
    return list(zip(calls, bns))


def check_zwin_fused(cfg, batch0) -> dict:
    """K3 with the fused epilogue at the full-size encoder's 9 launches:
    the bf16 body within ZWIN_TOL and the fp32 body within REF_TOL of the
    plain version, each launch's time beside the plain version's and the
    unfused chain's it replaces (K3, MaskedBatchNorm, ReLU)."""
    import torch.nn.functional as F
    from fusionocc_tpu_torch.ops import zwin_conv as zw
    err = err32 = ms = plain_ms = chain_ms = 0.0
    bound = Bound()
    launches = fused_launches(cfg, batch0)
    for args, bn in launches:
        feats, mask_out, nbr, weight, f_in, f_out, stride, *epi = args
        B, s_in, _ = feats.shape
        s_out = nbr.shape[1]
        cin, cout = weight.shape[1], weight.shape[2]
        name = (f'zwin fused {"subm" if stride == 1 else "down"} Cin {cin}->'
                f'{cout} rows {s_in}->{s_out} (active {int(mask_out.sum())}'
                f', lanes on {int(epi[2].sum())} of {epi[2].numel()})')
        err = max(err, check_close(
            f'{name} bf16', zw.zwin_conv_epi_cuda(*args),
            zw.zwin_conv_epi_plain(*args), **ZWIN_TOL))
        args32 = (feats.float(), *args[1:])
        err32 = max(err32, check_close(
            f'{name} fp32', zw.zwin_conv_epi_cuda(*args32),
            zw.zwin_conv_epi_plain(*args32), **REF_TOL))

        def chain():
            y = zw.zwin_conv_cuda(feats, mask_out, nbr, weight, f_in, f_out,
                                  stride)
            return F.relu(bn(y, epi[2]))
        t_k = cuda_ms(lambda: zw.zwin_conv_epi_cuda(*args))
        t_p = cuda_ms(lambda: zw.zwin_conv_epi_plain(*args))
        t_c = cuda_ms(chain)
        ms, plain_ms, chain_ms = ms + t_k, plain_ms + t_p, chain_ms + t_c
        print(f'    fused kernel {t_k:.4f} ms, plain {t_p:.4f} ms, unfused '
              f'chain (K3, MaskedBatchNorm, ReLU) {t_c:.4f} ms', flush=True)
        # K3's work and bytes, plus the lane mask read and inv, shift
        found = ((nbr < s_in) & mask_out[..., None]).sum(dim=(0, 1)).tolist()
        macs = sum(found[t] * len(zw.band_pairs(f_in, f_out, stride, t % 3))
                   * cin * cout for t in range(27))
        es = feats.element_size()
        bound.add(2 * macs, feats.numel() * es + nbr.numel() * 4
                  + mask_out.numel() + 27 * cin * cout * es
                  + B * s_out * f_out * cout * es + epi[2].numel()
                  + 2 * f_out * cout * 4, feats.dtype)
        bound.count(zw.zwin_conv_epi_op, *args)
    if len(launches) != 9:
        fail(f'the fused encoder made {len(launches)} zwin calls, not 9')
    bound_ms, bound_by = bound.total()
    print(f'  zwin fused summed over the 9 launches: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, unfused chain {chain_ms:.4f} ms, bound '
          f'{bound_ms:.4f} ms by {bound_by}', flush=True)
    if ms >= chain_ms:
        fail('the fused K3 is not faster than the unfused chain it replaces')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, fp32_max_abs_err=err32,
                unfused_chain_ms=chain_ms, flops=bound.flops,
                counted_flops=bound.counted)


def check_edge_shapes(g) -> None:
    """The bf16 bodies at shapes off the main path: K2's padded keys and
    query rows, K3's batch offsets, odd n8 tiles, fewer warps, four k16
    steps, with and without the fused epilogue."""
    from fusionocc_tpu_torch.ops import window_attn as wa
    from fusionocc_tpu_torch.ops import zwin_conv as zw
    for w, nWh, nWw, heads in ((7, 2, 3, 2), (10, 3, 2, 4)):
        n, c, bn = w * w, 32 * heads, 2 * nWh * nWw
        qkv = torch.randn(bn, n, 3 * c, device=DEV, generator=g
                          ).to(torch.bfloat16)
        bias = torch.randn(heads, n, n, device=DEV, generator=g)
        for shift in (0, w // 2):
            args = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias,
                    nWh, nWw, w, shift, heads)
            check_close(f'edge window_attn N={n} heads={heads} shift={shift}',
                        wa.window_attention_cuda(*args),
                        wa.window_attention_plain(*args), **WA_TOL)
    for B, s_in, s_out, cin, cout, f_in, f_out, stride in (
            (2, 300, 200, 16, 24, 8, 4, 2), (1, 257, 257, 64, 8, 4, 4, 1)):
        feats = torch.randn(B, s_in, f_in * cin, device=DEV, generator=g
                            ).to(torch.bfloat16)
        nbr = torch.randint(0, s_in, (B, s_out, 27), device=DEV, generator=g,
                            dtype=torch.int32)
        miss = torch.rand(B, s_out, 27, device=DEV, generator=g) < 0.3
        nbr = torch.where(miss, s_in, nbr).to(torch.int32)
        mask = torch.rand(B, s_out, device=DEV, generator=g) > 0.2
        weight = 0.1 * torch.randn(27, cin, cout, device=DEV, generator=g)
        args = (feats, mask, nbr, weight, f_in, f_out, stride)
        name = (f'edge zwin B={B} Cin {cin}->{cout} f {f_in}->{f_out} '
                f'stride {stride}')
        check_close(name, zw.zwin_conv_cuda(*args),
                    zw.zwin_conv_plain(*args), **ZWIN_TOL)
        print(f'    plan (zb, Cout parts, stages) '
              f'{zwin_plan(name, weight, f_in, f_out, stride)}, as '
              'bf16_plan', flush=True)
        epi = (0.5 + torch.rand(f_out * cout, device=DEV, generator=g),
               0.2 * torch.randn(f_out * cout, device=DEV, generator=g),
               torch.rand(B, s_out, f_out, device=DEV, generator=g) > 0.3)
        check_close(f'edge zwin fused B={B} Cin {cin}->{cout} f {f_in}->'
                    f'{f_out} stride {stride}',
                    zw.zwin_conv_epi_cuda(*args, *epi),
                    zw.zwin_conv_epi_plain(*args, *epi), **ZWIN_TOL)


class plain_index:
    """Within ``with``, the index ops' CUDA implementations run the plain
    build (batched aten ops) on the card."""

    NAMES = ('stride2_count', 'stride2_set', 'stage_maps')

    def __enter__(self):
        from fusionocc_tpu_torch.ops import sparse_conv as sc
        self.reals = [getattr(sc, f'{n}_cuda') for n in self.NAMES]
        for n in self.NAMES:
            setattr(sc, f'{n}_cuda', getattr(sc, f'{n}_plain'))
        return self

    def __exit__(self, *exc):
        from fusionocc_tpu_torch.ops import sparse_conv as sc
        for n, real in zip(self.NAMES, self.reals):
            setattr(sc, f'{n}_cuda', real)


def check_index(cfg, batches) -> dict:
    """The sparse stages' index builds (``stage_indices_table`` with the
    lane mask, as the encoder calls it) through the kernels against the
    plain build on the card, on the full-size synthetic clouds of seeds 0
    and 1, at B = 1 and 2: every stage, each chained on the kernels'
    output set (its keys, coords, mask and lane mask: the next stage's
    input rows), every output equal element for element; per stage the
    launches and the ms of a build (CUDA events around it; the build waits
    once, so this is what the stage's index span lasts), the plain
    build's beside it.  Returns, per batch size, the launches and ms
    summed over the stages."""
    from fusionocc_tpu_torch.ops import sparse_conv as sc
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    from fusionocc_tpu_torch.ops.voxelize import voxelize_mean
    from fusionocc_tpu_torch.ops.zfold import (ZFoldVoxels, as_sparse,
                                               super_shape, zfold_regroup)
    lc = cfg.lidar
    out = {}
    for B in (1, 2):
        points = torch.cat([b.points for b in batches[:B]])
        pmask = torch.cat([b.points_mask for b in batches[:B]])
        cells = lc.sparse_shape(cfg.grid)
        sp = voxelize_mean(points, pmask, cfg.grid.point_cloud_range,
                           lc.voxel_size, cells, lc.voxel_capacity[0])
        zf = zfold_regroup(sp, cells, lc.zfold_capacity[0],
                           min(lc.zfold, cells[2]))
        total = {'launches': dict.fromkeys(INDEX_KERNELS, 0), 'ms': 0.0,
                 'plain_ms': 0.0}
        for i in range(min(lc.dense_from, len(lc.encoder_channels) - 1)):
            sshape = super_shape(cells, zf.fold)
            cells = sc.out_shape_strided(cells)
            f_out = min(lc.zfold, cells[2])
            args = (as_sparse(zf), sshape, lc.zfold_capacity[i + 1],
                    zf.lane_mask, f_out)
            torch.cuda.synchronize()
            KERNELS.reset_counts()
            subm, (got, _) = sc.stage_indices_table(*args)
            torch.cuda.synchronize()
            launches = {k: KERNELS.launches[k] for k in INDEX_KERNELS}
            with plain_index():
                want_subm, (want, _) = sc.stage_indices_table(*args)
            name = (f'index stage {i} B={B}: {tuple(zf.keys.shape)} rows '
                    f'({int(zf.mask.sum())} valid) on {sshape} -> '
                    f'{int(got[2].sum())} stride-2 rows (capacity '
                    f'{lc.zfold_capacity[i + 1]}), f {zf.fold}->{f_out}')
            for part, g, w in zip(('subm map', 'coords', 'keys', 'mask',
                                   'stride-2 map', 'lane mask'),
                                  (subm, *got), (want_subm, *want)):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    fail(f'{name}: {part} differs from the plain build')
            t_k = statistics.median(event_ms(
                lambda: sc.stage_indices_table(*args), 10))
            with plain_index():
                t_p = statistics.median(event_ms(
                    lambda: sc.stage_indices_table(*args), 10))
            print(f'  {name}: equal to the plain build (both maps, the out '
                  f'set, the lane mask); launches {launches}; ms (CUDA '
                  f'events, median of 10) kernels {t_k:.4f}, plain '
                  f'{t_p:.4f}', flush=True)
            for k, v in launches.items():
                total['launches'][k] += v
            total['ms'] += t_k
            total['plain_ms'] += t_p
            zf = ZFoldVoxels(got[4].float(), got[0], got[1], got[2], got[4],
                             f_out)
        if total['launches'] != index_launches(cfg, B):
            fail(f'index builds at B={B}: launches {total["launches"]}, '
                 f'expected {index_launches(cfg, B)}')
        print(f'  index builds B={B}, the {len(total["launches"])} entries '
              f'over the sparse stages: launches {total["launches"]} (as '
              f'index_launches), ms summed: kernels {total["ms"]:.4f}, plain '
              f'{total["plain_ms"]:.4f}', flush=True)
        out[B] = total
    return out


@torch.inference_mode()
def phase_kernels(cfg, batches) -> tuple:
    print('[3/12] kernels vs plain versions at main-path shapes')
    g = torch.Generator(device=DEV).manual_seed(1234)
    batch0 = batches[0]
    measured = {'zwin_conv_fwd': check_zwin(cfg, batch0),
                'zwin_conv_fwd_epi': check_zwin_fused(cfg, batch0),
                'window_attn_fwd': check_window_attn(cfg, g),
                'bev_pool_fwd': check_bev_pool(cfg, batch0, g)}
    check_edge_shapes(g)
    index = check_index(cfg, batches)
    sweep = check_plane_sweep(g)
    return measured, index, sweep, check_swin_glue(cfg, g)


def stereo_launches(cfg) -> dict:
    """Main-path launches of one BEVStereo4D-Occ two-pass predict: a full
    camera pass a frame, the reference frame's stage 0 (its window
    attentions and their glue), a plane sweep a camera pass."""
    out = launches_per(cfg, cfg.num_frame, 0, sweeps=cfg.num_frame)
    for k in ('window_attn_fwd',) + GLUE_KERNELS:
        out[k] += cfg.swin.depths[0]
    return out


@torch.inference_mode()
def check_swin_glue(cfg, g) -> dict:
    """Swin's glue kernels at the four stage shapes of one camera pass
    (``num_cams`` images), shift 0 and w // 2, bf16, against their plain
    versions on the card: the residual sums equal, the normed values within
    ``GLUE_TOL``; two launches bit-identical; ms beside the plain
    version's and the bytes bound (each real token's row read and written
    as the kernel does, padded window rows written), and per two-pass
    predict, weighted by each shape's launches (a block's kernel A takes
    the previous block's residual, as all but a stage's first do)."""
    from fusionocc_tpu_torch.ops import swin_glue as sg
    sw = cfg.swin
    w, B = sw.window_size, cfg.num_cams
    h, wd = cfg.input_size[0] // sw.patch_size, cfg.input_size[1] // sw.patch_size
    bf16 = torch.bfloat16
    out = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   predict_ms=0.0, predict_bound_ms=0.0) for k in GLUE_KERNELS}
    for stage, C in enumerate(sw.num_features):
        nWh, nWw = sg.window_grid(h, wd, w)
        x, r = (torch.randn(B, h * wd, C, device=DEV, generator=g).to(bf16)
                for _ in range(2))
        o = torch.randn(B * nWh * nWw, w * w, C, device=DEV, generator=g
                        ).to(bf16)
        weight, bias = (1 + 0.3 * torch.randn(C, device=DEV, generator=g),
                        0.3 * torch.randn(C, device=DEV, generator=g))
        row = C * 2
        real, padded = B * h * wd * row, B * nWh * nWw * w * w * row
        for shift in (0, w // 2):
            geom = (1e-6, h, wd, w, shift)
            cases = (
                ('window_in_fwd', sg.window_in_cuda, sg.window_in_plain,
                 (x, r, weight, bias, *geom), 3 * real + padded),
                ('window_out_fwd', sg.window_out_cuda, sg.window_out_plain,
                 (o, x, weight, bias, *geom), 4 * real))
            if shift == 0:    # a stage's first block: no residual to add
                cases += (('window_in_fwd', sg.window_in_cuda,
                           lambda *a: (x.new_empty(0),
                                       sg.window_in_plain(*a)[1]),
                           (x, None, weight, bias, *geom), real + padded),)
            for k, kernel, plain, args, nbytes in cases:
                (gs, gy), (ws, wy) = kernel(*args), plain(*args)
                name = (f'{k} B={B} C={C} map={h}x{wd} shift={shift}'
                        f'{" no residual" if args[1] is None else ""}')
                if not torch.equal(gs, ws):
                    fail(f'{name}: the residual sum differs from the plain '
                         'version\'s')
                err = check_close(name, gy, wy, **GLUE_TOL)
                again = kernel(*args)
                if not (torch.equal(gs, again[0])
                        and torch.equal(gy, again[1])):
                    fail(f'{name}: two launches differ')
                t_k = cuda_ms(lambda: kernel(*args))
                t_p = cuda_ms(lambda: plain(*args))
                b_ms = nbytes / PEAK_BYTES * 1e3
                print(f'    kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound '
                      f'{b_ms:.4f} ms ({nbytes / 1e6:.2f} MB), '
                      f'{b_ms / t_k:.3f} of it; two launches bit-identical',
                      flush=True)
                m = out[k]
                m['max_abs_err'] = max(m['max_abs_err'], err)
                if args[1] is None:
                    continue
                m['ms'] += t_k
                m['plain_ms'] += t_p
                m['bound_ms'] += b_ms
                # per two-pass predict: two camera passes, each of the
                # stage's blocks at one of the two shifts
                m['predict_ms'] += sw.depths[stage] * t_k
                m['predict_bound_ms'] += sw.depths[stage] * b_ms
        h, wd = -(-h // 2), -(-wd // 2)
    for k, m in out.items():
        print(f'  {k} over the 8 stage/shift shapes: kernel {m["ms"]:.4f} ms, '
              f'plain {m["plain_ms"]:.4f} ms, bound {m["bound_ms"]:.4f} ms; '
              f'per two-pass predict ({2 * sum(sw.depths)} launches): kernel '
              f'{m["predict_ms"]:.4f} ms, bound {m["predict_bound_ms"]:.4f} '
              f'ms ({m["predict_bound_ms"] / m["predict_ms"]:.3f} of it)',
              flush=True)
    return out


def sweep_against_cpu(prev, curr, geom, gs, bias) -> tuple:
    """The plane sweep on the card against the op's CPU path on the same
    inputs: (the volume, the share of hypotheses whose bias masks differ,
    the max abs difference on the pixels whose masks agree, the share
    masked).  On the card the plain version samples through cuDNN, whose
    coordinates round on their own (about 1e-3 off the CPU's at the cell's
    shapes, as far as fp32 lies from fp64 there), so the CPU's is the
    yardstick."""
    from fusionocc_tpu_torch.ops import plane_sweep as ps
    D, hs, ws, _ = geom.frustum.shape
    N, C = prev.shape[0], prev.shape[-1]
    invalid = torch.empty(N, D, hs, ws, dtype=torch.uint8, device=DEV)
    got = ps.plane_sweep_cuda(prev, curr, geom.frustum, geom.cams, geom.hi,
                              geom.wi, gs, bias, invalid).cpu()
    grid = ps.sweep_grid(ps.SweepGeometry(geom.frustum.cpu(),
                                          geom.cams.cpu(), geom.hi, geom.wi))
    want = ps.plane_sweep(prev.cpu(), curr.cpu(), grid, D, gs, bias)
    ch = (C - 1) // gs * gs
    warp = ps.grid_sample_2d(
        prev[..., ch:ch + 1].cpu().permute(0, 3, 1, 2), grid)
    mask = (warp[:, 0] == 0).reshape(N, D, hs, ws)
    flips = invalid.cpu().bool() != mask
    agree = ~flips.any(dim=1, keepdim=True)
    share = float(flips.float().mean())
    err = float(((got - want).abs() * agree).max())
    if not bool(torch.isfinite(got).all()) or share > SWEEP_MASK_SHARE \
            or err > SWEEP_TOL:
        fail(f'plane sweep {tuple(got.shape)} {prev.dtype}: bias masks '
             f'differ on {share:.3e} of the hypotheses (limit '
             f'{SWEEP_MASK_SHARE}), max abs {err:.3e} elsewhere (limit '
             f'{SWEEP_TOL})')
    return got, share, err, float(mask.float().mean())


@torch.inference_mode()
def check_plane_sweep(g) -> dict:
    """The plane sweep against its plain version (the op's CPU path) at
    the stereo cell's shapes, bf16 features (``prev`` random, ``curr`` it
    plus noise) and the cameras of the synthetic drive (frame 0 into frame
    1: 0.5 m); at small shapes the bodies the cell does not use (fp32, 64
    channels), a ragged last block, 20 planes, groups of 3 and cameras
    with an image augmentation; then one full-size BEVStereo4D-Occ
    predict, its launches gated."""
    from fusionocc_tpu_torch import configs
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.geometry import make_frustum
    from fusionocc_tpu_torch.models.fusion_occ import init_weights
    from fusionocc_tpu_torch.ops import plane_sweep as ps
    cfg = configs.get_config('bevdet_occ_stbase_stereo').model
    H, W = cfg.input_size
    hs, ws, C, N = H // 4, W // 4, cfg.swin.embed_dims, cfg.num_cams
    D = cfg.grid.num_depth_bins
    batch = synthetic_batch(cfg, 1, 0, device=DEV, frames=3)
    s2k = batch.sensor2keyego
    k2s = (torch.linalg.inv(s2k[:, 1].double()) @ s2k[:, 0].double()).float()
    args = (batch.intrins[:, 0], batch.post_rots[:, 0],
            batch.post_trans[:, 0])
    geom = ps.sweep_geometry(make_frustum(cfg.grid.depth, (H, W), 4,
                                          device=DEV), k2s, *args, H, W)
    for dtype in (torch.float32, torch.bfloat16):
        small = (2, 20, 44, 64)
        rot = args[1][:, :2].clone()
        rot[..., :2, :2] = torch.tensor([[0.9, 0.03], [-0.03, 0.9]],
                                        device=DEV)
        tran = args[2][:, :2] + torch.tensor([3.0, -2.0, 0.0], device=DEV)
        intrins = args[0][:, :2].clone()
        intrins[..., :2, :] *= 0.125            # the rig at 80x176
        small_geom = ps.sweep_geometry(
            make_frustum((1.0, 11.0, 0.5), (80, 176), 4, device=DEV),
            k2s[:, :2], intrins, rot, tran, 80, 176)
        p = torch.randn(small, generator=g, device=DEV)
        q = (p + 0.3 * torch.randn(small, generator=g, device=DEV))
        _, share, err, masked = sweep_against_cpu(
            p.to(dtype), q.to(dtype), small_geom, 3, 2.0)
        print(f'  plane sweep {small} {str(dtype).split(".")[-1]}, 20 '
              f'planes, groups of 3: masked {masked:.4f}, masks differ on '
              f'{share:.3e}, max abs {err:.3e} elsewhere', flush=True)
    prev = torch.randn(N, hs, ws, C, generator=g, device=DEV)
    curr = (prev + 0.3 * torch.randn(N, hs, ws, C, generator=g, device=DEV)
            ).to(torch.bfloat16)
    prev = prev.to(torch.bfloat16)
    gs, bias = 4, 5.0
    got, share, err, masked = sweep_against_cpu(prev, curr, geom, gs, bias)

    def kernel():
        return ps.plane_sweep_cuda(prev, curr, geom.frustum, geom.cams, H, W,
                                   gs, bias)

    def plain():
        return ps.plane_sweep(prev, curr, ps.sweep_grid(geom), D, gs, bias)
    card_err = float((got - plain().cpu()).abs().max())
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, reps=3, warmup=1)
    bound = 10 * C * N * D * hs * ws / PEAK_FLOPS[torch.float32] * 1e3
    print(f'  plane sweep ({N}, {D}, {hs}, {ws}) from ({N}, {hs}, {ws}, {C}) '
          f'bf16: masked {masked:.4f} of the hypotheses, masks differ on '
          f'{share:.3e}, max abs {err:.3e} elsewhere against the CPU (the '
          f'kernel against the plain version on the card {card_err:.3e}); '
          f'{ms:.4f} ms a volume, plain {plain_ms:.4f}, bound {bound:.4f} '
          f'(share {100 * bound / ms:.2f} %)', flush=True)
    del prev, curr, got
    model = init_weights(configs.build_model('bevdet_occ_stbase_stereo', DEV,
                                             cfg),
                         torch.Generator().manual_seed(0))
    expect = stereo_launches(cfg)
    counted('BEVStereo4D-Occ predict', lambda: model.predict(batch), expect)
    pred_ms = cuda_ms(lambda: model.predict(batch), reps=3, warmup=1)
    print(f'  BEVStereo4D-Occ two-pass predict: launches {expect}, '
          f'{pred_ms:.2f} ms', flush=True)
    del model
    torch.cuda.empty_cache()
    return {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'mask_share': share, 'max_abs_err': err, 'launches': expect}


def phase_reference() -> None:
    """Midsize multi-modal fp32: the card (kernels) against the CPU (plain
    versions); the LiDAR encoder also with ``zwin_fuse`` (BatchNorms away
    from the identity)."""
    from fusionocc_tpu_torch.config import midsize_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    print('[4/12] reference: midsize multi-modal fp32, card vs CPU plain '
          'versions')
    cfg = midsize_model_config(use_lidar=True)
    g = torch.Generator().manual_seed(7)
    model = init_weights(FusionOcc(cfg, device='cpu'), g)
    bn_away_from_identity(model.lidar_encoder, g)
    batch = synthetic_batch(cfg, 1, 0, device='cpu')

    def lidar_both(b):
        """The LiDAR feature unfused, then fused."""
        outs = []
        for fuse in (False, True):
            set_fuse(model, fuse)
            outs.append(model.lidar_encoder(b.points, b.points_mask))
        set_fuse(model, False)
        return outs
    with torch.inference_mode():
        want = model(batch)
        want_lidar = lidar_both(batch)
    model.to(DEV)
    batch = synthetic_batch(cfg, 1, 0, device=DEV)
    KERNELS.reset_counts()
    with torch.inference_mode():
        got = model(batch)
        got_lidar = lidar_both(batch)
    torch.cuda.synchronize()
    print(f'  launches on the card: {dict(KERNELS.launches)}')
    if min(KERNELS.launches[k] for k in MAIN_KERNELS
           if k != 'plane_sweep_fwd') == 0:
        fail('a kernel was not launched by the midsize model on the card')
    for fused, g_l, w_l in zip(('', ', zwin_fuse=True'), got_lidar,
                               want_lidar):
        check_close(f'midsize lidar feature{fused}', g_l.cpu(), w_l,
                    **REF_TOL)
    for key in ('occ_logits', 'depth', 'seg_logits'):
        check_close(f'midsize {key}', got[key].cpu(), want[key], **REF_TOL)
    agree = (got['occ_logits'].argmax(-1).cpu()
             == want['occ_logits'].argmax(-1)).float().mean().item()
    print(f'  midsize argmax agreement {agree:.6f} (need >= 0.999)', flush=True)
    if agree < 0.999:
        fail('midsize argmax agreement below 0.999')


class ModuleClock:
    """CUDA events around every call of ``module``."""

    def __init__(self, module):
        self.events = []
        self.hooks = [module.register_forward_pre_hook(self._pre),
                      module.register_forward_hook(self._post)]

    def _pre(self, mod, args):
        self.events.append([torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)])
        self.events[-1][0].record()

    def _post(self, mod, args, result):
        self.events[-1][1].record()

    def call_ms(self) -> list:
        """Device ms of each call since the last ``reset``."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def reset(self) -> None:
        self.events.clear()

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()


class KernelCheck:
    """Within ``with``, every launch of a main-path kernel's wrapper is held
    against its plain version on the same inputs, at the tolerance of the
    kernel and its output dtype; on leaving, one line per kernel: launches,
    what a launch took (images or samples), max abs error.  ``keep`` names
    the kernels whose (inputs, output) are kept in ``kept``, in launch
    order."""

    def __init__(self, label, cfg, keep=()):
        from fusionocc_tpu_torch.ops import bev_pool as bp
        from fusionocc_tpu_torch.ops import swin_glue as sg
        from fusionocc_tpu_torch.ops import window_attn as wa
        from fusionocc_tpu_torch.ops import zwin_conv as zw
        self.label, self.keep, self.kept, self.seen = label, keep, [], {}

        def glue_in_plain(x, r, *args):
            x_new, wins = sg.window_in_plain(x, r, *args)
            return (x.new_empty(0) if r is None else x_new), wins
        gx, gy, gz = cfg.grid.grid_size
        # (module, wrapper, kernel, plain version, what a launch takes)
        self.wrappers = (
            (wa, 'window_attention_cuda', 'window_attn_fwd',
             wa.window_attention_plain,
             lambda q, k, v, bias, nWh, nWw, *_:
                 f'{q.shape[0] // (nWh * nWw)} images'),
            (bp, 'bev_pool_cuda', 'bev_pool_fwd',
             lambda d, f, idx, n, out: bp.bev_pool_plain(d, f, idx, n).to(out),
             lambda d, f, idx, n, out: f'{n // (gx * gy * gz)} samples'),
            (zw, 'zwin_conv_cuda', 'zwin_conv_fwd', zw.zwin_conv_plain,
             lambda feats, *_: f'{feats.shape[0]} samples'),
            (zw, 'zwin_conv_epi_cuda', 'zwin_conv_fwd_epi',
             zw.zwin_conv_epi_plain,
             lambda feats, *_: f'{feats.shape[0]} samples'),
            (sg, 'window_in_cuda', 'window_in_fwd', glue_in_plain,
             lambda x, *_: f'{x.shape[0]} images'),
            (sg, 'window_out_cuda', 'window_out_fwd', sg.window_out_plain,
             lambda o, x, *_: f'{x.shape[0]} images'))

    def _checked(self, real, name, plain, takes):
        def run(*args):
            got, want = real(*args), plain(*args)
            pairs = ([(got, want)] if isinstance(got, torch.Tensor)
                     else [p for p in zip(got, want) if p[0].numel()])
            ok, err = True, 0.0
            for g, w in pairs:
                ok_g, err_g, _ = within(g, w, **KERNEL_TOLS[g.dtype][name])
                ok, err = ok and ok_g, max(err, err_g)
            if not ok:
                fail(f'{self.label}: {name} at {tuple(args[0].shape)} '
                     f'disagrees with its plain version (max abs {err:.3e})')
            n, worst, seen = self.seen.get(name, (0, 0.0, set()))
            self.seen[name] = (n + 1, max(worst, err), seen | {takes(*args)})
            if name in self.keep:
                self.kept.append((args, got))
            return got
        return run

    def __enter__(self):
        self.reals = [getattr(m, w) for m, w, *_ in self.wrappers]
        for (m, w, name, plain, takes), real in zip(self.wrappers,
                                                    self.reals):
            setattr(m, w, self._checked(real, name, plain, takes))
        return self

    def __exit__(self, *exc):
        for (m, w, *_), real in zip(self.wrappers, self.reals):
            setattr(m, w, real)
        if exc[0] is None:
            torch.cuda.synchronize()
            print(f'  {self.label}, each launch against its plain version: '
                  + '; '.join(f'{name} {n} launches of '
                              f'{", ".join(sorted(seen))}, max_abs_err '
                              f'{err:.3e}'
                              for name, (n, err, seen) in self.seen.items())
                  + '; all within tolerance', flush=True)


def drive_path(label, cfg, batches, expect) -> dict:
    """Full-size ``predict`` on ``batches`` with seeded random weights:
    launch counts set to 0 just before, read just after."""
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, batch_pooling_indices, init_weights)
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    t0 = time.perf_counter()
    model = init_weights(FusionOcc(cfg, device=DEV),
                         torch.Generator().manual_seed(0))
    pool_idxs = batch_pooling_indices(cfg, batches[0])
    torch.cuda.synchronize()
    print(f'  {label}: model + pooling indices ready in '
          f'{time.perf_counter() - t0:.1f} s '
          f'({sum(p.numel() for p in model.parameters())} parameters)')
    with torch.inference_mode():
        out = model(batches[0], pool_idxs)          # warm-up, checks logits
    torch.cuda.synchronize()
    logits = out['occ_logits']
    gx, gy, gz = cfg.grid.grid_size
    if logits.shape != (1, gx, gy, gz, cfg.num_classes):
        fail(f'occ_logits shape {tuple(logits.shape)}')
    if not bool(torch.isfinite(logits).all()):
        fail('occ_logits not finite')
    print(f'  warm-up forward: occ_logits {tuple(logits.shape)} finite, '
          f'depth {tuple(out["depth"].shape)}, seg '
          f'{tuple(out["seg_logits"].shape)}')
    del out, logits

    if cfg.use_lidar:
        clock = ModuleClock(model.lidar_encoder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNELS.reset_counts()
    times = []
    for batch in batches:
        before = dict(KERNELS.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred = model.predict(batch, pool_idxs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        delta = {k: KERNELS.launches[k] - before[k] for k in MAIN_KERNELS}
        if pred.shape != (1, gx, gy, gz) or pred.dtype != torch.uint8:
            fail(f'predict gave {tuple(pred.shape)} {pred.dtype}')
        if delta != expect:
            fail(f'{label}: launches per predict {delta}, expected {expect}')
    totals = {k: KERNELS.launches[k] for k in MAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    print(f'  {label} predict x{len(batches)}: output (1, {gx}, {gy}, {gz}) '
          f'uint8; launches per predict {expect}, total {totals}')
    print(f'  {label}: ms per predict (median of {len(times)}) '
          f'{statistics.median(times):.1f}, all '
          f'{[round(t, 1) for t in times]}; peak memory '
          f'{peak / 2**30:.2f} GiB', flush=True)
    if cfg.use_lidar:
        enc_ms = clock.call_ms()
        clock.remove()
        print(f'  {label}: LiDAR encoder device ms per predict (CUDA events) '
              f'median {statistics.median(enc_ms):.2f}, all '
              f'{[round(t, 2) for t in enc_ms]}', flush=True)
    del model
    torch.cuda.empty_cache()
    return totals


def index_launches(cfg, batch: int = 1) -> dict:
    """Index-build launches of one LiDAR pass of ``batch`` samples: per
    sparse stage one each of mark, count, prefix and set, and one table
    scatter and one maps launch per table group
    (``sparse_conv.TABLE_CELLS`` as it is set when called); none without
    LiDAR."""
    from fusionocc_tpu_torch.ops import sparse_conv
    from fusionocc_tpu_torch.ops.zfold import super_shape
    lc = cfg.lidar
    out = dict.fromkeys(INDEX_KERNELS, 0)
    if not cfg.use_lidar:
        return out
    cells = lc.sparse_shape(cfg.grid)
    for _ in range(min(lc.dense_from, len(lc.encoder_channels) - 1)):
        fold = min(lc.zfold, cells[2])
        n_cells = math.prod(super_shape(cells, fold))
        group = max(1, sparse_conv.TABLE_CELLS // (n_cells + 4))
        for k in INDEX_KERNELS:
            out[k] += -(-batch // group) if k in ('index_table',
                                                   'index_maps') else 1
        cells = sparse_conv.out_shape_strided(cells)
    return out


def launches_per(cfg, camera_passes: int, lidar_passes: int,
                 batch: int = 1, sweeps: int = 0) -> dict:
    """Main-path launches of a run: one window attention per Swin block and
    one pooling per camera pass, one zwin per sparse-stage conv and LiDAR
    pass (the last stage runs dense; fused with ``zwin_fuse``), whatever
    the batch of a pass; the index builds of each LiDAR pass of ``batch``
    samples (``index_launches``); ``sweeps`` plane sweeps (BEVStereo4D-Occ,
    one a camera pass); Swin's glue as K2 (eval, autograd off)."""
    lc = cfg.lidar
    sparse = lc.encoder_channels[:min(lc.dense_from,
                                      len(lc.encoder_channels) - 1)]
    zwin = sum(map(len, sparse)) * lidar_passes * cfg.use_lidar
    blocks = sum(cfg.swin.depths) * camera_passes
    return {'window_attn_fwd': blocks, **{k: blocks for k in GLUE_KERNELS},
            'bev_pool_fwd': camera_passes,
            'zwin_conv_fwd': 0 if lc.zwin_fuse else zwin,
            'zwin_conv_fwd_epi': zwin if lc.zwin_fuse else 0,
            **{k: v * lidar_passes
               for k, v in index_launches(cfg, batch).items()},
            'plane_sweep_fwd': sweeps}


def fused_config(cfg):
    """``cfg`` with the fused zwin epilogue (``zwin_fuse=True``)."""
    import dataclasses
    return dataclasses.replace(cfg, lidar=dataclasses.replace(
        cfg.lidar, zwin_fuse=True))


def set_fuse(model, fuse: bool) -> None:
    """Switch the LiDAR encoder's convs between the fused and the unfused
    zwin path (the same weights either way)."""
    from fusionocc_tpu_torch.models.lidar_encoder import SparseConvBN
    for conv in model.lidar_encoder.modules():
        if isinstance(conv, SparseConvBN):
            conv.fuse = fuse


@torch.inference_mode()
def fused_against_unfused(batches) -> None:
    """Two-pass predict on seeds 0-2 with ``zwin_fuse`` True and False on
    the same weights (spread, BatchNorms away from the identity), every
    launch of the fused runs held against its plain version: the argmax
    agreement (at least MIN_AGREE in fp32) and the logit difference, in
    bf16 and fp32."""
    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, batch_pooling_indices, spread_weights)
    for dtype in ('bfloat16', 'float32'):
        cfg = full_model_config(compute_dtype=dtype)
        g = torch.Generator().manual_seed(0)
        model = spread_weights(FusionOcc(cfg, device=DEV), g)
        bn_away_from_identity(model.lidar_encoder, g)
        idxs = batch_pooling_indices(cfg, batches[0])
        want = [model(b, idxs)['occ_logits'] for b in batches]
        set_fuse(model, True)
        label = (f'{dtype} zwin_fuse=True two-pass predict on seeds '
                 f'{SLICE_SEEDS}')
        with KernelCheck(label, cfg):
            got = counted(label, lambda: [model(b, idxs)['occ_logits']
                                          for b in batches],
                          launches_per(fused_config(cfg), 2 * len(batches),
                                       len(batches)))
        diff = torch.stack([(a - b).abs().max() for a, b in zip(got, want)])
        rel = (sum((a - b).abs().mean() for a, b in zip(got, want))
               / sum(b.abs().mean() for b in want)).item()
        if not all(bool(torch.isfinite(x).all()) for x in got):
            fail(f'{label}: logits not finite')
        print(f'  {dtype} zwin_fuse=True against False, same weights: max '
              f'abs logit difference per seed '
              f'{[f"{d:.3e}" for d in diff.tolist()]}, mean abs difference '
              f'/ mean abs logit {rel:.3e}', flush=True)
        agreement(f'{dtype} zwin_fuse=True against False',
                  torch.stack([x.argmax(-1) for x in got]),
                  torch.stack([x.argmax(-1) for x in want]),
                  dtype == 'float32')
        del model, got, want
        torch.cuda.empty_cache()


def sync_sites(fn):
    """Run fn() with torch.cuda's sync debug mode on: the host syncs it
    made, counted by where the port made each (the innermost port function
    on the stack other than the one that reads a width)."""
    import collections
    import traceback
    sites = collections.Counter()

    def record(message, *_):
        if 'called a synchronizing' not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if 'fusionocc_tpu_torch' in f.filename
                  and f.name != 'padded_width']
        where = frames[-1] if frames else traceback.extract_stack()[-2]
        sites[f'{where.name} ({where.filename.rsplit("/", 1)[-1]}:'
              f'{where.lineno})'] += 1
    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    return sites


@torch.inference_mode()
def count_encoder_syncs(batches) -> dict:
    """Host syncs of one LiDAR encoder pass, fused (the slice's path) and
    unfused, at batch 1, 4 and 8 (the clouds of seeds 0-2 in turn): fail if
    a count grows with the batch or passes SYNC_SITES."""
    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.models.fusion_occ import init_weights
    from fusionocc_tpu_torch.models.lidar_encoder import SparseEncoder
    points = torch.cat([b.points for b in batches])
    pmask = torch.cat([b.points_mask for b in batches])
    counts = {}
    for cfg in (fused_config(full_model_config()), full_model_config()):
        enc = init_weights(SparseEncoder(cfg.lidar, cfg.grid, cfg.dtype, DEV),
                           torch.Generator().manual_seed(0))
        label = f'zwin_fuse={cfg.lidar.zwin_fuse}'
        for n in (1, 4, 8):
            rows = torch.arange(n, device=DEV) % len(batches)
            p, m = points[rows], pmask[rows]
            enc(p, m)                  # warm-up
            sites = sync_sites(lambda: enc(p, m))
            counts[label, n] = sum(sites.values())
            print(f'  host syncs of one LiDAR encoder pass, {label}, batch '
                  f'{n}: {counts[label, n]} ('
                  + ', '.join(f'{k} x{v}' for k, v in sorted(sites.items()))
                  + ')', flush=True)
        per_batch = {counts[label, n] for n in (1, 4, 8)}
        if len(per_batch) != 1 or max(per_batch) > SYNC_SITES:
            fail(f'{label}: host syncs per encoder pass {sorted(per_batch)} '
                 f'at batch 1, 4, 8; need one count, at most {SYNC_SITES}')
        del enc
    return counts


def phase_slice(batches) -> dict:
    """The image-only path, the default multi-modal main path and the same
    with the fused zwin epilogue; then the fused path against the unfused
    one on the same weights, and the encoder's host syncs.  Returns each
    kernel's launches on the path that runs it."""
    from fusionocc_tpu_torch.config import (full_model_config,
                                            image_only_model_config)
    print('[5/12] slice: full-size predict, bf16')
    paths = []
    for label, cfg in (('image-only', image_only_model_config()),
                       ('default multi-modal', full_model_config()),
                       ('multi-modal zwin_fuse=True',
                        fused_config(full_model_config()))):
        # one window-attention launch per Swin block and frame, one pooling
        # per frame, one zwin launch per sparse-stage conv (the last stage
        # runs dense)
        paths.append(drive_path(label, cfg, batches,
                                launches_per(cfg, cfg.num_frame, 1)))
    slice_cuts(full_model_config(), batches)
    fused_against_unfused(batches)
    count_encoder_syncs(batches)
    return {k: max(p[k] for p in paths) for k in MAIN_KERNELS}


def slice_cuts(cfg, batches) -> None:
    """C2 on the synthetic batches of seeds SLICE_SEEDS: the points each
    synthetic cloud had before its cut to ``point_capacity`` (its
    generator run again from the batch's seed with room for every ray:
    ``synthetic_batch`` draws nothing from that generator before the
    cloud), then ``capacity_cuts``."""
    import numpy as np

    from fusionocc_tpu_torch.data.synthetic import beam_lidar_cloud
    generated = [int(beam_lidar_cloud(np.random.RandomState(seed),
                                      SYNTHETIC_RAYS,
                                      cfg.grid.point_cloud_range)[1].sum())
                 for seed in SLICE_SEEDS]
    capacity_cuts('phase 5', cfg, torch.cat([b.points for b in batches]),
                  torch.cat([b.points_mask for b in batches]), generated)


def counted(label, run, expect) -> object:
    """run() with the launch counts set to 0 just before and read just
    after; fail unless they are ``expect``."""
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    torch.cuda.synchronize()
    KERNELS.reset_counts()
    out = run()
    torch.cuda.synchronize()
    got = {k: KERNELS.launches[k] for k in MAIN_KERNELS}
    if got != expect:
        fail(f'{label}: launches {got}, expected {expect}')
    return out


def agreement(label, got, want, gate: bool) -> float:
    """Share of voxels where two argmax maps agree; with ``gate``, fail
    below MIN_AGREE."""
    agree = (got == want).float().mean().item()
    print(f'  {label}: voxel agreement {agree:.6f}'
          + (f' (need >= {MIN_AGREE})' if gate else ''), flush=True)
    if gate and agree < MIN_AGREE:
        fail(f'{label}: voxel agreement {agree} below {MIN_AGREE}')
    return agree


def reset_peak() -> int:
    """Set the peak-memory count to what is allocated now; return that."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_above(base) -> str:
    """The peak memory since ``reset_peak``, and above ``base``, what was
    allocated then (weights, clip, indices)."""
    peak = torch.cuda.max_memory_allocated()
    return (f'peak memory {peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f}'
            f' GiB above the {base / 2**30:.2f} GiB held before the run')


def report_mode(label, ms, per, launches, base) -> None:
    print(f'  {label}: ms per {per} median {statistics.median(ms):.2f}, all '
          f'{[round(t, 2) for t in ms]}; {peak_above(base)}; launches '
          f'{launches}', flush=True)


def check_cache(label, state, want=None, tol=None) -> None:
    """A cache after the clip: finite and valid, and with ``want`` the same
    pose and a feature within ``tol`` of it."""
    if not bool(torch.isfinite(state.voxel_feat).all()):
        fail(f'{label}: cached feature not finite')
    if not bool(state.valid.all()):
        fail(f'{label}: cache not valid after the clip')
    if want is not None:
        check_close(f'{label} final cache', state.voxel_feat,
                    want.voxel_feat, **tol)
        if not torch.equal(state.ego2global, want.ego2global):
            fail(f'{label}: final pose differs')


def check_batch_fold(model, clip, key_idx, n: int = 4) -> None:
    """The clip's first n frames at batch n against the same frames one at
    a time, part by part: what running at another batch size changes.  The
    image encoder, the LiDAR encoder and the pooling kernel on the fold's
    index (given the batch-1 inputs) must give the same bits; the view
    transformer's convolutions, ``pre_process_net`` and the head are
    printed."""
    from fusionocc_tpu_torch.models.fusion_occ import (
        map_batch, streaming_fold_pooling_index)
    from fusionocc_tpu_torch.ops import bev_pool as bp
    cfg = model.cfg
    label = f'{str(cfg.dtype).split(".")[-1]} batch {n} against {n} x batch 1'
    print(f'  {label}, on the first {n} frames of the clip:', flush=True)
    frames = [map_batch(lambda a, t=t: a[t], clip) for t in range(n)]
    folded = map_batch(lambda a: a[:n].reshape((-1,) + a.shape[2:]), clip)
    fold_idx = streaming_fold_pooling_index(cfg, clip, n)

    def differ(name, got, want, same: bool):
        d = (got.float() - want.float()).abs()
        print(f'    {name}: max abs difference {d.max().item():.3e} (max '
              f'|value| {want.float().abs().max().item():.3e}), mean '
              f'{d.mean().item():.3e}, share of elements that differ '
              f'{(d > 0).float().mean().item():.4f}'
              + (' (must be 0)' if same else ''), flush=True)
        if same and bool((d > 0).any()):
            fail(f'{label}: {name} differs')

    def camera(b, idx):
        return model._frame_voxel_feat(
            b.imgs[:, 0], b.sensor2keyego[:, 0], b.sensor2keyego[:, 0],
            b.intrins[:, 0], b.post_rots[:, 0], b.post_trans[:, 0], b.bda,
            b.sparse_depth, idx)[0]

    with KernelCheck(label, cfg, keep=('bev_pool_fwd',)) as kc:
        differ('image encoder', model.image_encoder(folded.imgs[:, 0]),
               torch.cat([model.image_encoder(f.imgs[:, 0]) for f in frames]),
               True)
        vox4 = camera(folded, fold_idx)
        vox1 = torch.cat([camera(f, key_idx) for f in frames])
        lidar1 = torch.cat([model._lidar_feat(f) for f in frames])
        differ('LiDAR encoder', model._lidar_feat(folded), lidar1, True)
    (args4, pooled4), *ones = kc.kept
    depth1 = torch.cat([args[0] for args, _ in ones])
    feat1 = torch.cat([args[1] for args, _ in ones])
    pooled1 = torch.cat([out for _, out in ones])
    differ("depth softmax, the pooling's input (view transformer)",
           args4[0], depth1, False)
    differ("context feature, the pooling's input (view transformer)",
           args4[1], feat1, False)
    differ("pooling kernel on the fold's index, given the batch-1 inputs",
           bp.bev_pool_cuda(depth1, feat1, *args4[2:]), pooled1, True)
    differ('pooled voxels', pooled4, pooled1, False)
    gx, gy, gz = cfg.grid.grid_size
    differ('pre_process_net, given the batch-1 pooled voxels',
           model.pre_process_net(pooled1.reshape(n, gz, gy, gx, -1))[0],
           vox1, False)
    differ('camera voxel feature', vox4, vox1, False)
    fusion = torch.cat([vox1, vox1, lidar1], dim=-1)
    h1 = torch.cat([model._head(fusion[i:i + 1]) for i in range(n)])
    h4 = model._head(fusion)
    differ('head logits, given the batch-1 fusion', h4, h1, False)
    agree = (h4.argmax(-1) == h1.argmax(-1)).float()
    top = h1.topk(2, dim=-1).values
    gap = (top[..., 0] - top[..., 1]).flatten()
    print(f'    head argmax agreement {agree.mean().item():.6f}; top-2 logit '
          'gap ' + ', '.join(f'{(gap < g).float().mean().item():.4f} below {g}'
                             for g in (1e-3, 1e-2, 1e-1))
          + f'; mean |logit| {h1.abs().mean().item():.4f}', flush=True)


def streaming_modes(cfg, clip, frames, batches, timed: bool) -> None:
    """The streaming modes and ``batch_frames`` on the clip (``frames`` are
    its views, one per frame), launches counted per run, and one block of
    each time fold and one ``batch_frames`` predict with every kernel launch
    held against its plain version.  Timed (bf16, the main path): each
    mode's ms and peak memory, the scan held to the frames one by one, and
    the other modes' agreement printed.  Not timed (fp32, the kernels' fp32
    bodies): the time fold held to the scan and ``batch_frames`` to
    two-pass, at least MIN_AGREE of the voxels and the caches within
    REF_TOL.  Then batch 4 against 4 x batch 1, part by part."""
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, batch_pooling_indices, batched_frames_pooling_index,
        map_batch, spread_weights, streaming_fold_pooling_index)
    from tools.eval_torch_streaming_delta import streaming_delta
    dt = str(cfg.dtype).split('.')[-1]
    model = spread_weights(FusionOcc(cfg, device=DEV),
                           torch.Generator().manual_seed(0))
    resets = torch.zeros(CLIP_FRAMES, 1, dtype=torch.bool, device=DEV)
    resets[CLIP_RESET] = True
    idxs = batch_pooling_indices(cfg, frames[0])     # one rig in every frame
    per_frame = launches_per(cfg, 1, 1)

    clock = ModuleClock(model.lidar_encoder)

    def report_encoder(label, n_frames):
        if timed:
            print(f'  {label}: LiDAR encoder device ms per frame (CUDA events)'
                  f' {sum(clock.call_ms()) / n_frames:.2f}', flush=True)
        clock.reset()

    if timed:
        delta = streaming_delta(model, [frames])     # also the warm-up clip
        print(f'  {dt}: streaming against two-pass (tools/eval_torch_'
              'streaming_delta.py, no reset), voxel agreement per frame: '
              + ', '.join(f'{a:.6f}' for a in delta['agree_by_frame'])
              + f'; divergence mIoU {delta["divergence_miou"]}; mean |logit '
              f'difference| / mean |logit| {delta["rel_logit_mae"]:.4f}; '
              f'two-pass voxels by class {delta["twopass_voxels_by_class"]}',
              flush=True)
        if sum(n > 0 for n in delta['twopass_voxels_by_class']) < 4:
            fail('the two-pass argmax takes fewer than 4 classes')

        base = reset_peak()
        clock.reset()
        state, seq, ms, gaps = model.init_streaming_state(1), [], [], []
        for t, batch in enumerate(frames):
            t1 = time.perf_counter()
            pred, out, state = counted(
                f'predict_streaming frame {t}',
                lambda: model.predict_streaming(batch, state, idxs[0],
                                                resets[t]), per_frame)
            ms.append((time.perf_counter() - t1) * 1e3)
            if not bool(torch.isfinite(out['occ_logits']).all()):
                fail(f'predict_streaming frame {t}: logits not finite')
            top = out['occ_logits'].topk(2, dim=-1).values
            gaps.append((top[..., 0] - top[..., 1]).flatten())
            seq.append(pred)
        seq = torch.stack(seq)
        check_cache(f'{dt} predict_streaming', state)
        report_mode(f'{dt} predict_streaming frame by frame', ms, 'frame',
                    f'per frame {per_frame}', base)
        report_encoder(f'{dt} predict_streaming frame by frame', CLIP_FRAMES)
        gaps = torch.cat(gaps)
        print(f'  {dt}: top-2 logit gap of the streamed frames: '
              + ', '.join(f'{(gaps < g).float().mean().item():.4f} below {g}'
                          for g in (1e-3, 1e-2, 1e-1))
              + f'; mean |logit| {out["occ_logits"].abs().mean().item():.4f}',
              flush=True)
        seq_state = state
        del out, gaps

    def clip_run(label, run, expect):
        """Timed: one warm-up clip, then three timed, ms per frame of each.
        Else one run.  Returns the output, the ms and the bytes allocated
        before the timed runs."""
        if timed:
            run()
        base = reset_peak()
        clock.reset()
        ms = []
        for _ in range(3 if timed else 1):
            t1 = time.perf_counter()
            out = counted(label, run, expect)
            ms.append((time.perf_counter() - t1) * 1e3 / CLIP_FRAMES)
        return out, ms, base

    label = f'{dt} predict_streaming_scan'
    (scan_preds, scan_state), ms, base = clip_run(
        label, lambda: model.predict_streaming_scan(
            clip, model.init_streaming_state(1), resets, idxs[0]),
        launches_per(cfg, CLIP_FRAMES, CLIP_FRAMES))
    check_cache(label, scan_state)
    if timed:
        report_mode(label, ms, 'frame', f'per frame {per_frame}', base)
        report_encoder(label, 3 * CLIP_FRAMES)
        if not torch.equal(scan_preds, seq):
            fail('predict_streaming_scan differs from predict_streaming')
        print(f'  {label}: preds equal to the frames one by one', flush=True)
        check_cache(label, scan_state, seq_state, CACHE_TOL)

    for chunk, cam_chunk in ((4, 0), (8, 4)):
        label = (f'{dt} predict_streaming_batch chunk {chunk} cam_chunk '
                 f'{cam_chunk}')
        cams = chunk // cam_chunk if cam_chunk else 1
        idx = streaming_fold_pooling_index(cfg, clip, chunk, cam_chunk)
        blocks = CLIP_FRAMES // chunk
        (preds, final), ms, base = clip_run(
            label, lambda: model.predict_streaming_batch(
                clip, model.init_streaming_state(1), resets, idx, chunk,
                cam_chunk), launches_per(cfg, cams * blocks, blocks, chunk))
        if timed:
            report_mode(label, ms, 'frame', f'per block of {chunk} frames '
                        f'{launches_per(cfg, cams, 1, chunk)}', base)
            report_encoder(label, 3 * CLIP_FRAMES)
        agreement(f'{label} against the scan', preds, scan_preds, not timed)
        check_cache(label, final, None if timed else scan_state, REF_TOL)
        if timed:
            diff = (final.voxel_feat.float()
                    - scan_state.voxel_feat.float()).abs().max().item()
            print(f'  {label}: final cache against the scan\'s, max abs '
                  f'difference {diff:.3e}', flush=True)
        with KernelCheck(f'{label}, its first block', cfg):
            model.predict_streaming_batch(
                map_batch(lambda a: a[:chunk], clip),
                model.init_streaming_state(1), None, idx, chunk, cam_chunk)
        if timed and chunk == 8:
            one_table_fold(model, clip, resets, idx, label)
        del idx, preds, final

    label = f'{dt} predict(batch_frames=True)'
    base = reset_peak()
    two_pass = [model.predict(b, idxs) for b in batches]
    if timed:
        print(f'  {dt} two-pass predict on seeds {SLICE_SEEDS}: '
              f'{peak_above(base)}', flush=True)
    idx = batched_frames_pooling_index(cfg, batches[0])
    if timed:
        model.predict(batches[0], batch_frames=True, pool_idx_folded=idx)
    base = reset_peak()
    clock.reset()
    ms = []
    for b, want in zip(batches, two_pass):
        t1 = time.perf_counter()
        pred = counted(label, lambda: model.predict(
            b, batch_frames=True, pool_idx_folded=idx), per_frame)
        ms.append((time.perf_counter() - t1) * 1e3)
        agreement(f'{label} against two-pass predict', pred, want, not timed)
    if timed:
        report_mode(label, ms, 'predict', f'per predict {per_frame}', base)
        report_encoder(label, len(batches))
    with KernelCheck(f'{label} on seed {SLICE_SEEDS[0]}', cfg):
        model.predict(batches[0], batch_frames=True, pool_idx_folded=idx)
    clock.remove()
    check_batch_fold(model, clip, idxs[0])
    del model
    torch.cuda.empty_cache()


def one_table_fold(model, clip, resets, idx, label) -> None:
    """The fold once more with every row table over all samples of a block
    (``sparse_conv.TABLE_CELLS`` unbounded), against the default that
    builds a large table one sample at a time: peak memory and ms."""
    from fusionocc_tpu_torch.ops import sparse_conv
    cfg, cells = model.cfg, sparse_conv.TABLE_CELLS
    sparse_conv.TABLE_CELLS = 2 ** 62
    try:
        base = reset_peak()
        t1 = time.perf_counter()
        counted(label, lambda: model.predict_streaming_batch(
            clip, model.init_streaming_state(1), resets, idx, 8, 4),
            launches_per(cfg, 2 * CLIP_FRAMES // 8, CLIP_FRAMES // 8, 8))
        ms = (time.perf_counter() - t1) * 1e3 / CLIP_FRAMES
    finally:
        sparse_conv.TABLE_CELLS = cells
    print(f'  {label}, each row table over all 8 samples (TABLE_CELLS '
          f'unbounded; the default {cells} cells builds the stage-0 table '
          f'one sample at a time): {peak_above(base)}; {ms:.2f} ms per '
          'frame, one clip', flush=True)


@torch.inference_mode()
def fused_streaming(unfused, frames) -> None:
    """``predict_streaming`` frame by frame over the clip with ``zwin_fuse``
    (spread weights, BatchNorms away from the identity): one clip with
    every launch held against its plain version, then one timed (ms and
    the encoder's device ms per frame) and the same weights unfused (its
    agreement printed)."""
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, batch_pooling_indices, spread_weights)
    cfg = fused_config(unfused)
    g = torch.Generator().manual_seed(0)
    model = spread_weights(FusionOcc(cfg, device=DEV), g)
    bn_away_from_identity(model.lidar_encoder, g)
    idx = batch_pooling_indices(cfg, frames[0])[0]
    per_frame = launches_per(cfg, 1, 1)

    def clip_run(label, expect=per_frame):
        state, preds = model.init_streaming_state(1), []
        for t, batch in enumerate(frames):
            pred, out, state = counted(
                f'{label} frame {t}', lambda: model.predict_streaming(
                    batch, state, idx), expect)
            if not bool(torch.isfinite(out['occ_logits']).all()):
                fail(f'{label} frame {t}: logits not finite')
            preds.append(pred)
        check_cache(label, state)
        return torch.stack(preds)
    dt = str(cfg.dtype).split('.')[-1]
    label = f'{dt} zwin_fuse=True predict_streaming frame by frame'
    with KernelCheck(f'{label}, the clip', cfg):
        clip_run(label)
    clock = ModuleClock(model.lidar_encoder)
    base = reset_peak()
    t1 = time.perf_counter()
    preds = clip_run(label)
    ms = (time.perf_counter() - t1) * 1e3 / CLIP_FRAMES
    enc = sum(clock.call_ms()) / CLIP_FRAMES
    clock.remove()
    print(f'  {label}: {ms:.2f} ms per frame (one clip, launches counted '
          f'per frame {per_frame}), LiDAR encoder device ms per frame '
          f'{enc:.2f}; {peak_above(base)}', flush=True)
    set_fuse(model, False)
    agreement(f'{label} against zwin_fuse=False, same weights', preds,
              clip_run(f'{dt} predict_streaming',
                       launches_per(unfused, 1, 1)), False)
    del model
    torch.cuda.empty_cache()


@torch.inference_mode()
def phase_streaming(batches) -> None:
    """The streaming modes and ``batch_frames`` at full size: timed in
    bf16, then held to each other in fp32."""
    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.models.fusion_occ import map_batch, stack_batches
    from tools.eval_torch_streaming_delta import clip_frames
    print('[6/12] streaming: full-size default config, a clip of '
          f'{CLIP_FRAMES} frames, a reset at frame {CLIP_RESET}')
    t0 = time.perf_counter()
    clip = stack_batches(clip_frames(full_model_config(), 0, CLIP_FRAMES,
                                     DEV))
    frames = [map_batch(lambda a, t=t: a[t], clip) for t in range(CLIP_FRAMES)]
    torch.cuda.synchronize()
    print(f'  clip ready in {time.perf_counter() - t0:.1f} s, '
          f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated',
          flush=True)
    for dtype, timed in (('bfloat16', True), ('float32', False)):
        cfg = full_model_config(compute_dtype=dtype)
        streaming_modes(cfg, clip, frames, batches, timed)
    fused_streaming(full_model_config(), frames)


# phase 7: training
TRAIN_WARMUP, TRAIN_TIMED = 2, 5        # full-size train steps
GRAD_TOL = dict(atol=1e-3, rtol=1e-3)   # fp32 gradient sums in another order
TRAIN_NOISE = 1e-6      # relative image perturbation that measures the spread
TRAIN_SPREAD, TRAIN_RTOL = 3.0, 1e-3    # card vs CPU, per gradient tensor
SIGN_MIN = 1e-4         # |g| above which Adam's first update is sign(g)
TRAIN_LR = 3e-3         # card vs CPU: updates well above rounding


def train_launches(cfg) -> dict:
    """Main-path launches of one ``train_step``, from the code: a window
    attention per Swin block and frame (the adjacent frames' under
    ``no_grad``), and per block again in the backward's recompute with
    ``with_cp``; a pooling per frame; a zwin launch per sparse-stage conv,
    unfused (training never fuses); the index builds of one LiDAR pass
    at batch 1; no glue kernel (training composes the plain version)."""
    lc = cfg.lidar
    sparse = lc.encoder_channels[:min(lc.dense_from,
                                      len(lc.encoder_channels) - 1)]
    return {'window_attn_fwd': sum(cfg.swin.depths)
            * (cfg.num_frame + int(cfg.swin.with_cp)),
            'bev_pool_fwd': cfg.num_frame,
            'zwin_conv_fwd': sum(map(len, sparse)) * cfg.use_lidar,
            'zwin_conv_fwd_epi': 0, **index_launches(cfg),
            'plane_sweep_fwd': 0, **{k: 0 for k in GLUE_KERNELS}}


def function_grads(fn, inputs, cot):
    """Gradients of fn(*inputs) for the cotangent cot, each input a fresh
    leaf."""
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    fn(*leaves).backward(cot)
    return [x.grad for x in leaves]


def held(name, got, want, tols):
    """check_close for each gradient, its tolerance by input name."""
    for (label, tol), g, w in zip(tols.items(), got, want):
        check_close(f'{name} d{label}', g, w, **tol)


def window_attn_grads(cfg, g) -> float:
    """K2's Function at the 8 stage/shift shapes, bf16 inputs: its
    gradients against autograd through the plain version; its backward
    timed."""
    from fusionocc_tpu_torch.ops import window_attn as wa
    w = cfg.swin.window_size
    n = w * w
    total = 0.0
    for nWh, nWw, c, heads in stage_shapes(cfg):
        bn = cfg.num_cams * nWh * nWw
        qkv = torch.randn(bn, n, 3 * c, device=DEV, generator=g
                          ).to(torch.bfloat16)
        bias = torch.randn(heads, n, n, device=DEV, generator=g)
        cot = torch.randn(bn, n, c, device=DEV, generator=g
                          ).to(torch.bfloat16)
        for shift in (0, w // 2):
            geom = (nWh, nWw, w, shift, heads)

            def split(fn):
                return lambda x, b: fn(x[..., :c], x[..., c:2 * c],
                                       x[..., 2 * c:], b, *geom)
            got = function_grads(split(wa.window_attention), (qkv, bias), cot)
            want = function_grads(split(wa.window_attention_plain),
                                  (qkv, bias), cot)
            held(f'window_attn backward Bn={bn} C={c} shift={shift}', got,
                 want, {'qkv': WA_TOL, 'bias': GRAD_TOL})
            args = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias,
                    *geom, cot)
            t = cuda_ms(lambda: wa.window_attention_bwd(*args), reps=3)
            total += t
            print(f'    backward {t:.4f} ms', flush=True)
    print(f'  window_attn backward summed over the 8 shapes: {total:.4f} ms',
          flush=True)
    return total


def bev_pool_grads(cfg, batch0, g) -> float:
    """K1's Function on the full-size index, bf16 and fp32 out: its
    gradients against autograd through the plain version (and the cast);
    its backward timed (bf16, the main path's)."""
    from fusionocc_tpu_torch.models.fusion_occ import frame_pooling_index
    from fusionocc_tpu_torch.ops import bev_pool as bp
    idx = frame_pooling_index(cfg, batch0.sensor2keyego[:, 0],
                              batch0.intrins[:, 0], batch0.post_rots[:, 0],
                              batch0.post_trans[:, 0], batch0.bda)
    N, D, (h, wf) = cfg.num_cams, cfg.grid.num_depth_bins, cfg.feat_size
    C = cfg.vt.feature_channels
    gx, gy, gz = cfg.grid.grid_size
    nvox = gz * gy * gx
    depth = torch.softmax(torch.randn(N, D, h, wf, device=DEV, generator=g),
                          dim=1).reshape(-1)
    feat = torch.randn(N * h * wf, C, device=DEV, generator=g)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        f_in = feat.to(dtype)
        cot = torch.randn(nvox, C, device=DEV, generator=g).to(dtype)
        got = function_grads(
            lambda d, f: bp.bev_pool_flat(d, f, idx, nvox, dtype),
            (depth, f_in), cot)
        want = function_grads(
            lambda d, f: bp.bev_pool_plain(d, f, idx, nvox).to(dtype),
            (depth, f_in), cot)
        held(f'bev_pool backward {dtype} feat and out', got, want,
             {'depth': POOL_TOL,
              'feat': POOL_BF16_TOL if dtype == torch.bfloat16
              else POOL_TOL})
        times[dtype] = cuda_ms(lambda: bp.bev_pool_bwd(depth, f_in, idx, cot),
                               reps=3)
    print(f'  bev_pool backward per launch: bf16 '
          f'{times[torch.bfloat16]:.4f} ms, fp32 {times[torch.float32]:.4f}'
          ' ms', flush=True)
    return times[torch.bfloat16]


def zwin_grads(cfg, batch0, g) -> float:
    """K3's Function at the full-size encoder's 9 launches, bf16: its
    gradients against autograd through the plain version; its backward
    timed."""
    from fusionocc_tpu_torch.ops import zwin_conv as zw
    from tools import profile_torch_zwin_micro as micro
    total = 0.0
    for k, (feats, mask_out, nbr, weight, f_in, f_out, stride) in enumerate(
            micro.record_zwin_launches(cfg, batch0, DEV)):
        feats, mask_out, nbr = feats.clone(), mask_out.clone(), nbr.clone()
        weight = weight.clone()
        geom = (f_in, f_out, stride)
        cot = torch.randn(*nbr.shape[:2], f_out * weight.shape[2],
                          device=DEV, generator=g).to(feats.dtype)
        got = function_grads(
            lambda f, w: zw.zwin_conv(f, mask_out, nbr, w, *geom),
            (feats, weight), cot)
        want = function_grads(
            lambda f, w: zw.zwin_conv_plain(f, mask_out, nbr, w, *geom),
            (feats, weight), cot)
        held(f'zwin backward launch {k} stride {stride} rows '
             f'{feats.shape[1]}->{nbr.shape[1]}', got, want,
             {'feats': ZWIN_TOL, 'weight': ZWIN_TOL})
        t = cuda_ms(lambda: zw.zwin_conv_bwd(feats, mask_out, nbr, weight,
                                             *geom, cot), reps=3)
        total += t
        print(f'    backward {t:.4f} ms', flush=True)
    print(f'  zwin backward summed over the 9 launches: {total:.4f} ms',
          flush=True)
    return total


def train_functions(cfg, batch0) -> dict:
    """(a) each kernel Function's gradients on the card at main-path
    shapes; backward ms by kernel."""
    g = torch.Generator(device=DEV).manual_seed(4321)
    return {'window_attn_fwd': window_attn_grads(cfg, g),
            'bev_pool_fwd': bev_pool_grads(cfg, batch0, g),
            'zwin_conv_fwd': zwin_grads(cfg, batch0, g)}


def no_dropout(x, rate):
    return x


def train_reference() -> None:
    """(b) One midsize multi-modal fp32 train_step on the card and on the
    CPU from the same weights, the random parts off (the two devices' draws
    differ): the loss and its terms, grad_norm, every gradient, the running
    statistics and the updated parameters.  A gradient tensor may differ by
    TRAIN_SPREAD times the CPU's own change when the images move by
    TRAIN_NOISE, plus TRAIN_RTOL of its norm (in training a ReLU of the
    camera branch sits at its kink: tests/test_torch_train_step.py)."""
    import copy
    import dataclasses
    from fusionocc_tpu_torch.config import (OptimConfig, TrainConfig,
                                            midsize_model_config)
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.nn import layers
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    from fusionocc_tpu_torch.train import loop
    cfg = midsize_model_config(use_lidar=True)
    cfg = dataclasses.replace(cfg, vt=dataclasses.replace(
        cfg.vt, depth_drop_rate=0.0))
    tc = TrainConfig(model=cfg, optim=OptimConfig(lr=TRAIN_LR))
    g = torch.Generator().manual_seed(7)
    model = init_weights(FusionOcc(cfg, device='cpu'), g)
    bn_away_from_identity(model.lidar_encoder, g)
    batch = synthetic_batch(cfg, 1, 0, device='cpu')
    real_dropout, layers.dropout = layers.dropout, no_dropout
    try:
        t0 = time.perf_counter()
        twin = copy.deepcopy(model)
        noise = torch.randn(batch.imgs.shape, generator=g)
        loop.compute_loss(twin, tc, batch._replace(
            imgs=batch.imgs * (1 + TRAIN_NOISE * noise)), None)[0].backward()
        cpu = copy.deepcopy(model)
        cpu_state = loop.create_train_state(cpu, tc)
        cpu_logs = loop.train_step(cpu, tc, cpu_state, batch)
        print(f'  CPU: two midsize forwards and backwards in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        card = copy.deepcopy(model).to(DEV)
        state = loop.create_train_state(card, tc)
        KERNELS.reset_counts()
        logs = loop.train_step(card, tc, state,
                               synthetic_batch(cfg, 1, 0, device=DEV))
        torch.cuda.synchronize()
    finally:
        layers.dropout = real_dropout
    print(f'  launches on the card: {dict(KERNELS.launches)}', flush=True)
    if min(KERNELS.launches[k] for k in MAIN_KERNELS[:3]) == 0:
        fail('a kernel was not launched by the midsize train step')
    for key in ('loss', 'depth_loss', 'seg_loss', 'loss_occ'):
        check_close(f'midsize train {key}', logs[key].cpu(), cpu_logs[key],
                    atol=0.0, rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    grads = {n: p.grad.cpu() for n, p in card.named_parameters()}
    want = {n: p.grad for n, p in cpu.named_parameters()}
    spread = {n: (p.grad - want[n]).norm() for n, p in twin.named_parameters()}
    worst, tight = 0.0, 0
    for n in names:
        err, ref = (grads[n] - want[n]).norm(), want[n].norm()
        bound = TRAIN_SPREAD * spread[n] + TRAIN_RTOL * ref
        worst = max(worst, float(err / ref.clamp_min(1e-30)))
        tight += bool(spread[n] <= TRAIN_RTOL * ref)
        if err > bound:
            fail(f'midsize train gradient {n}: card vs CPU {float(err):.3e} '
                 f'beyond {float(bound):.3e}')
    total_spread = float(loop.global_norm(list(spread.values())))
    gn, gn_cpu = float(logs['grad_norm']), float(cpu_logs['grad_norm'])
    if abs(gn - gn_cpu) > TRAIN_SPREAD * total_spread + TRAIN_RTOL * gn_cpu:
        fail(f'midsize grad_norm {gn} on the card, {gn_cpu} on the CPU')
    rel = sorted(float(spread[n] / want[n].norm().clamp_min(1e-30))
                 for n in names)
    print(f'  midsize gradients, card vs CPU: {len(names)} tensors, largest '
          f'relative L2 difference {worst:.3e}; {tight} tensors held to '
          f'{TRAIN_RTOL:g} alone, the rest to {TRAIN_SPREAD:g}x the CPU\'s '
          f'change under a {TRAIN_NOISE:g} image perturbation (relative, '
          f'median {rel[len(rel) // 2]:.3e}, largest {rel[-1]:.3e}); '
          f'grad_norm {gn:.6f} / {gn_cpu:.6f}', flush=True)
    sd, sd_cpu = card.state_dict(), cpu.state_dict()
    stats = [k for k in sd if k.endswith(('running_mean', 'running_var'))]
    for k in stats:
        ok, err, _ = within(sd[k].cpu(), sd_cpu[k], **REF_TOL)
        if not ok:
            fail(f'midsize running statistics {k} differ by {err:.3e}')
    lr0 = TRAIN_LR * tc.optim.warmup_start_factor
    n_held = n_all = 0
    for n in names:
        got, ref = sd[n].cpu(), sd_cpu[n]
        same = ((torch.sign(grads[n]) == torch.sign(want[n]))
                & (want[n].abs() > SIGN_MIN) & (grads[n].abs() > SIGN_MIN))
        close = (got - ref).abs() <= 1e-6 + 1e-5 * ref.abs()
        n_held, n_all = n_held + int(same.sum()), n_all + same.numel()
        if not bool((close | ~same).all()) or float(
                (got - ref).abs().max()) > 2.1 * lr0:
            fail(f'midsize updated parameter {n} differs')
    print(f'  midsize running statistics ({len(stats)} tensors) within '
          f'{REF_TOL}; updated parameters: within 2.1 lr everywhere, within '
          f'1e-6 + 1e-5|p| at the {n_held} of {n_all} entries whose two '
          'gradients agree in sign above 1e-4', flush=True)


def train_fullsize(batches) -> dict:
    """(c) The default full-size config in bf16, fp32 parameters:
    TRAIN_WARMUP + TRAIN_TIMED train_steps on the synthetic batches of
    seeds 0-2 in turn, each with its launches counted and gated; s/iter,
    the forward / backward / optimizer split, peak memory above what was
    held before, the losses and grad_norm per step (finite), and the device
    idle share of one profiled step.  Returns the launches per step."""
    from fusionocc_tpu_torch.config import TrainConfig, full_model_config
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    from fusionocc_tpu_torch.train import loop
    cfg = full_model_config()
    tc = TrainConfig(model=cfg)
    t0 = time.perf_counter()
    model = init_weights(FusionOcc(cfg, device=DEV),
                         torch.Generator().manual_seed(0))
    state = loop.create_train_state(model, tc)
    expect = train_launches(cfg)
    print(f'  full-size model and train state ready in '
          f'{time.perf_counter() - t0:.1f} s '
          f'({sum(p.numel() for p in model.parameters())} parameters); '
          f'launches per step from the code: {expect}', flush=True)
    base = reset_peak()
    rows = []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        events = {'start': torch.cuda.Event(enable_timing=True)}

        def mark(part):
            events[part] = torch.cuda.Event(enable_timing=True)
            events[part].record()
        torch.cuda.synchronize()
        KERNELS.reset_counts()
        t = time.perf_counter()
        events['start'].record()
        logs = loop.train_step(model, tc, state, batches[i % len(batches)],
                               mark)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        got = {k: KERNELS.launches[k] for k in MAIN_KERNELS}
        if got != expect:
            fail(f'train step {i}: launches {got}, expected {expect}')
        vals = {k: float(v) for k, v in logs.items()}
        if not all(map(math.isfinite, vals.values())):
            fail(f'train step {i}: a loss or grad_norm is not finite: {vals}')
        ms = {p: events[a].elapsed_time(events[p]) for a, p in
              (('start', 'forward'), ('forward', 'backward'),
               ('backward', 'optimizer'))}
        ms['step'] = events['start'].elapsed_time(events['optimizer'])
        ms['wall'] = wall
        print(f'  train step {i} ({"warm-up" if i < TRAIN_WARMUP else "timed"}'
              f', seed {SLICE_SEEDS[i % len(batches)]}): '
              + ' '.join(f'{k} {v:.4f}' for k, v in vals.items())
              + '; ms: ' + ', '.join(f'{k} {v:.1f}' for k, v in ms.items()),
              flush=True)
        if i >= TRAIN_WARMUP:
            rows.append(ms)
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    print(f'  full-size train step, median of {TRAIN_TIMED}: s/iter '
          f'{med["step"] / 1e3:.4f} (CUDA events), {med["wall"] / 1e3:.4f} '
          f'(wall); forward {med["forward"]:.1f} ms, backward '
          f'{med["backward"]:.1f} ms, optimizer {med["optimizer"]:.1f} ms; '
          f'{peak_above(base)}; launches per step {expect}', flush=True)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t = time.perf_counter()
        loop.train_step(model, tc, state, batches[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f'  one profiled step: kernel time {kernel_ms:.1f} ms; device '
          f'idle share {1 - kernel_ms / med["wall"]:.3f} against the median '
          f'unprofiled wall time, {1 - kernel_ms / wall:.3f} against the '
          f'profiled step\'s own wall time ({wall:.1f} ms, the profiler\'s '
          'host overhead included); its kernels by device time:', flush=True)
    print(prof.key_averages().table(sort_by='self_device_time_total',
                                    row_limit=12, max_name_column_width=50),
          flush=True)
    del model, state
    torch.cuda.empty_cache()
    return expect


def phase_training(batches) -> tuple:
    """Phase 7: (a) the kernel Functions' gradients, (b) the midsize
    train step card vs CPU, (c) the full-size train steps.  Returns (the
    launches per full-size step, backward ms by kernel)."""
    from fusionocc_tpu_torch.config import full_model_config
    print('[7/12] training: kernel Functions, midsize card vs CPU, '
          'full-size train steps (bf16)')
    bwd_ms = train_functions(full_model_config(), batches[0])
    torch.cuda.empty_cache()
    train_reference()
    return train_fullsize(batches), bwd_ms


# phase 8: evaluation from an on-disk tree
EVAL_SAMPLES = 9                        # one scene of consecutive samples
RAW_HW = (900, 1600)                    # nuScenes camera images
NUSC_INTRIN = ((1266.4, 0.0, 816.3), (0.0, 1266.4, 491.5), (0.0, 0.0, 1.0))
LIDAR_T = (0.9, 0.0, 1.84)              # lidar2ego translation
EGO_STEP = 2.5                          # ego metres per sample (2 Hz, 5 m/s)
EVAL_LOADER_WORKERS = 4
EVAL_SERIAL, EVAL_FSCORE = 3, 3         # samples timed alone; F-scored


def mat_to_quat(m) -> list:
    """3x3 rotation -> quaternion [w, x, y, z] (Shepperd's method)."""
    import numpy as np
    tr = np.trace(m)
    if tr > 0:
        s = 2.0 * math.sqrt(1.0 + tr)
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * math.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        q = [0.0] * 4
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    return [float(v) for v in q]


def scene_boxes(rng) -> list:
    """Static world of the scene, global frame: (min xyz, max xyz, class)
    for cars, trucks and buses (4, 10, 3), building walls (manmade, 15)
    and trees (vegetation, 16) along a straight road."""
    import numpy as np
    boxes = []
    for _ in range(26):
        cx, cy = rng.uniform(-30, 50), rng.uniform(-30, 30)
        if abs(cy) < 2.5:
            cy += 5.0 * np.sign(cy or 1)
        cls = int(rng.choice([4, 4, 4, 10, 3]))
        L, W, H = {4: (4.5, 2.0, 1.6), 10: (8.0, 2.6, 3.2),
                   3: (11.0, 2.9, 3.4)}[cls]
        if rng.rand() < 0.3:
            L, W = W, L
        boxes.append(((cx - L / 2, cy - W / 2, 0.0),
                      (cx + L / 2, cy + W / 2, H), cls))
    for _ in range(10):
        cx, cy = rng.uniform(-40, 60), rng.choice([-1, 1]) * rng.uniform(
            18, 38)
        L, W = rng.uniform(8, 25), rng.uniform(0.5, 3.0)
        boxes.append(((cx - L / 2, cy - W / 2, 0.0),
                      (cx + L / 2, cy + W / 2, rng.uniform(4, 10)), 15))
    for _ in range(12):
        cx, cy = rng.uniform(-40, 60), rng.choice([-1, 1]) * rng.uniform(
            10, 17)
        r = rng.uniform(0.8, 2.0)
        boxes.append(((cx - r, cy - r, 0.0), (cx + r, cy + r,
                                              rng.uniform(3, 7)), 16))
    return boxes


def lidar_sweep(rng, boxes, origin):
    """One 32-beam, 1100-azimuth sweep from ``origin`` (global), ray-cast
    against the ground and the boxes: (P, 5) float32 x, y, z in the LiDAR
    frame (axes along the global ones), intensity, ring."""
    import numpy as np
    n_beams, n_az = 32, 1100
    elev = np.deg2rad(np.linspace(-30.67, 10.67, n_beams))
    az = (np.arange(n_az) + rng.rand()) * (2 * np.pi / n_az)
    d = np.stack([np.cos(az)[:, None] * np.cos(elev)[None],
                  np.sin(az)[:, None] * np.cos(elev)[None],
                  np.broadcast_to(np.sin(elev), (n_az, n_beams))],
                 -1).reshape(-1, 3)
    ring = np.tile(np.arange(n_beams), n_az)
    o = np.asarray(origin, np.float64)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = np.where(d[:, 2] < -1e-6, -o[2] / d[:, 2], np.inf)
    bmin = np.asarray([b[0] for b in boxes])
    bmax = np.asarray([b[1] for b in boxes])
    inv = 1.0 / np.where(np.abs(d) > 1e-9, d, 1e-9)
    t0 = (bmin[None] - o) * inv[:, None]
    t1 = (bmax[None] - o) * inv[:, None]
    tn, tf = np.minimum(t0, t1).max(-1), np.maximum(t0, t1).min(-1)
    t = np.minimum(t, np.where((tn < tf) & (tn > 0.1), tn, np.inf).min(-1))
    ok = np.isfinite(t) & (t < 70.0) & (rng.rand(len(t)) > 0.03)
    pts = d[ok] * t[ok, None] + rng.randn(int(ok.sum()), 3) * 0.012
    out = np.zeros((len(pts), 5), np.float32)
    out[:, :3] = pts
    out[:, 3] = rng.rand(len(pts)) * 100.0
    out[:, 4] = ring[ok]
    return out


def occ_labels(rng, boxes, ego_x, grid):
    """(semantics, mask_camera, mask_lidar) at the grid in the ego frame of
    a sample whose ego stands at global x = ego_x: the ground layer
    driveable surface (11), voxels whose centre lies in a box that box's
    class, free (17) elsewhere; random visibility masks."""
    import numpy as np
    gx, gy, gz = grid.grid_size
    xs = grid.x[0] + (np.arange(gx) + 0.5) * grid.x[2] + ego_x
    ys = grid.y[0] + (np.arange(gy) + 0.5) * grid.y[2]
    zs = grid.z[0] + (np.arange(gz) + 0.5) * grid.z[2]
    sem = np.full((gx, gy, gz), 17, np.uint8)
    sem[:, :, int(np.argmin(np.abs(zs)))] = 11
    for lo, hi, cls in boxes:
        ix = (xs >= lo[0]) & (xs < hi[0])
        iy = (ys >= lo[1]) & (ys < hi[1])
        iz = (zs >= lo[2]) & (zs < hi[2])
        sem[np.ix_(ix, iy, iz)] = cls
    shape = (gx, gy, gz)
    return (sem, (rng.rand(*shape) > 0.25).astype(np.uint8),
            (rng.rand(*shape) > 0.35).astype(np.uint8))


def write_tree(root, cfg, seed: int = 0) -> tuple:
    """One scene of EVAL_SAMPLES consecutive samples at full raw size,
    written as the port's dataset reads it: six cameras of 900x1600 JPEGs
    on the synthetic rig with nuScenes intrinsics, one LiDAR ``.bin``
    sweep per sample with the ego EGO_STEP m further each sample,
    ``labels.npz`` at the occupancy grid, 1/8-resolution ``.npy``
    segmentation maps, and the infos pkl.  Returns (infos pkl, seg dir)."""
    import os
    import pickle

    import numpy as np
    from PIL import Image

    from fusionocc_tpu_torch.data.dataset import CAM_ORDER
    from fusionocc_tpu_torch.data.synthetic import _camera_rig
    rng = np.random.RandomState(seed)
    rig = _camera_rig(len(CAM_ORDER)).astype(np.float64)
    boxes = scene_boxes(rng)
    H, W = RAW_HW
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = []                   # one image per camera, shifted per sample
    for n in range(len(CAM_ORDER)):
        low = rng.rand(H // 50 + 1, W // 50 + 1, 3).repeat(50, 0).repeat(
            50, 1)[:H, :W] * 120
        img = np.stack([xx * (255 / W), yy * (255 / H),
                        (xx + yy + 40 * n) % 256], -1) * 0.5 + low
        base.append(np.clip(img, 0, 255).astype(np.uint8))
    seg_dir = os.path.join(root, 'img_seg')
    infos = []
    for i in range(EVAL_SAMPLES):
        ego = [EGO_STEP * i, 0.0, 0.0]
        ts = 1_000_000 + 500_000 * i
        token = f'tok{i:02d}'
        occ_dir = os.path.join(root, 'gts', 'scene-0001', token)
        os.makedirs(occ_dir)
        sem, mc, ml = occ_labels(rng, boxes, ego[0], cfg.grid)
        np.savez(os.path.join(occ_dir, 'labels.npz'), semantics=sem,
                 mask_camera=mc, mask_lidar=ml)
        lidar_path = os.path.join(root, 'samples', 'LIDAR_TOP',
                                  f'{i:04d}.bin')
        os.makedirs(os.path.dirname(lidar_path), exist_ok=True)
        lidar_sweep(rng, boxes, np.add(ego, LIDAR_T)).tofile(lidar_path)
        cams = {}
        for n, cam in enumerate(CAM_ORDER):
            path = os.path.join(root, 'samples', cam, f'{i:04d}.jpg')
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(np.roll(base[n], -40 * i, axis=1)).save(
                path, quality=90)
            seg_path = os.path.join(seg_dir, cam, f'{i:04d}.npy')
            os.makedirs(os.path.dirname(seg_path), exist_ok=True)
            np.save(seg_path, rng.randint(0, 18, (H // 8, W // 8)).astype(
                np.uint8))
            cams[cam] = {
                'data_path': path, 'sample_data_token': f'sd_{cam}_{i}',
                'sensor2ego_rotation': mat_to_quat(rig[n, :3, :3]),
                'sensor2ego_translation': [float(v) for v in rig[n, :3, 3]],
                'ego2global_rotation': [1.0, 0.0, 0.0, 0.0],
                'ego2global_translation': ego,
                'cam_intrinsic': [list(r) for r in NUSC_INTRIN],
                'timestamp': ts}
        infos.append({
            'token': token, 'scene_token': 'scene0',
            'scene_name': 'scene-0001', 'timestamp': ts,
            'lidar_path': lidar_path,
            'lidar2ego_rotation': [1.0, 0.0, 0.0, 0.0],
            'lidar2ego_translation': list(LIDAR_T),
            'ego2global_rotation': [1.0, 0.0, 0.0, 0.0],
            'ego2global_translation': ego, 'occ_path': occ_dir,
            'cams': cams})
    ann = os.path.join(root, 'fusionocc-nuscenes_infos_val.pkl')
    with open(ann, 'wb') as f:
        pickle.dump({'data_list': infos}, f)
    return ann, seg_dir


def lidar_density(ds, cfg) -> None:
    """The fused cloud of each sample before ``pad_points`` (the dataset's
    own loading, range filter in the ego frame), its point count against
    ``point_capacity`` and its distinct LiDAR voxels (numpy, on the host)
    against ``voxel_capacity[0]``, then each cut's dropped rows
    (``capacity_cuts``, the cloud padded as the dataset pads it in eval):
    ROADMAP Queue C's C2."""
    import numpy as np

    from fusionocc_tpu_torch.data import pipeline as pl
    lc = cfg.lidar
    lo = np.float32(cfg.grid.point_cloud_range[:3])
    vs = np.float32(lc.voxel_size)
    dims = np.asarray(lc.sparse_shape(cfg.grid), np.int64)
    rows, padded = [], []
    for i in range(len(ds)):
        fused, _, l2e = ds._load_points(i, ds._sample_rng(i))
        pts = pl.filter_points_range(pl.points_lidar_to_ego(fused, l2e),
                                     cfg.grid.point_cloud_range)
        padded.append(pl.pad_points(pts, lc.point_capacity))
        cell = np.clip(np.floor((pts[:, :3] - lo) / vs).astype(np.int64), 0,
                       dims - 1)
        keys = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        rows.append((len(fused), len(pts), len(np.unique(keys))))
    print('  LiDAR density per sample (fused cloud of up to 8 sweeps; '
          'in range before pad_points; distinct voxels of 0.05 m): '
          + '; '.join(f'{a} fused, {b} in range, {c} voxels'
                      for a, b, c in rows), flush=True)
    capacity_cuts('phase 8', cfg,
                  torch.from_numpy(np.stack([p for p, _ in padded])).to(DEV),
                  torch.from_numpy(np.stack([m for _, m in padded])).to(DEV),
                  [r[1] for r in rows])
    print(f'  LiDAR density, largest: {max(r[1] for r in rows)} points '
          f'against point_capacity {lc.point_capacity} '
          f'({max(r[1] for r in rows) / lc.point_capacity:.3f}); '
          f'{max(r[2] for r in rows)} voxels against voxel_capacity[0] '
          f'{lc.voxel_capacity[0]} '
          f'({max(r[2] for r in rows) / lc.voxel_capacity[0]:.3f})',
          flush=True)


SYNTHETIC_RAYS = 32 * 1100 * 8     # beam_lidar_cloud's rays: beams, azimuths, sweeps


def capacity_cuts(label, cfg, points, points_mask, generated) -> None:
    """ROADMAP Queue C's C2: the rows each static cut of the LiDAR encoder
    drops, per sample: points at ``point_capacity`` (``generated`` holds
    each sample's points before that cut), then the index builds' cuts
    (``models.lidar_encoder.capacity_cuts``, counted by the port's own
    builds run with and without each capacity)."""
    from fusionocc_tpu_torch.models.lidar_encoder import capacity_cuts as cut
    cuts = [('points', torch.as_tensor(generated), cfg.lidar.point_capacity)
            ] + cut(cfg, points, points_mask)
    for b in range(points.shape[0]):
        print(f'  C2 {label} sample {b}: rows before each cut, capacity, '
              'dropped: ' + '; '.join(
                  f'{name} {int(n[b])} / {cap} -> {max(int(n[b]) - cap, 0)}'
                  for name, n, cap in cuts), flush=True)


def eval_args(ann, seg, *extra):
    import tools.test_torch as tt
    return tt.parse_args(['--ann-file', ann, '--img-seg-dir', seg,
                          '--device', DEV, '--warmup', '1', *extra])


def eval_run(label, model, ann, seg, expect, *extra, keep=False):
    """``tools/test_torch.evaluate`` in-process on the tree with ``model``;
    launches counted over the run against ``expect`` per sample; every
    result finite.  Returns (result, timings, launches, kept (host batch,
    pred) when ``keep``)."""
    import tools.test_torch as tt
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    kept = []
    on_batch = ((lambda host, scenes, pred: kept.append((host, pred.clone())))
                if keep else None)
    torch.cuda.synchronize()
    KERNELS.reset_counts()
    t = time.perf_counter()
    res, tm = tt.evaluate(eval_args(ann, seg, *extra), model=model,
                          on_batch=on_batch)
    wall = time.perf_counter() - t
    got = {k: KERNELS.launches[k] for k in MAIN_KERNELS}
    want = {k: v * EVAL_SAMPLES for k, v in expect.items()}
    if got != want:
        fail(f'eval {label}: launches {got}, expected {want}')
    bad = [k for k, v in res.items() if not math.isfinite(v)]
    if res['samples'] != EVAL_SAMPLES or bad:
        fail(f'eval {label}: {res["samples"]} samples, not finite: {bad}')
    def ms(xs):
        return statistics.median(xs) * 1e3
    print(f'  eval {label}: {EVAL_SAMPLES} samples in {wall:.2f} s '
          f'({EVAL_SAMPLES / wall:.2f} samples/s); per sample median ms: '
          f'loader wait {ms(tm.wait):.1f}, predict {ms(tm.predict):.1f}, '
          f'mIoU update {ms(tm.metric):.2f}'
          + (f', RayIoU update {ms(tm.rayiou):.1f}' if tm.rayiou else '')
          + f'; launches {got} ({expect} per sample)', flush=True)
    print(f'  eval {label} result: ' + json.dumps(res), flush=True)
    return res, tm, got, kept


def phase_eval() -> dict:
    """Phase 8: the evaluation path of ``tools/test_torch.py`` from an
    on-disk tree at full size.  Returns the two-pass run's launches."""
    import tempfile

    import numpy as np

    from fusionocc_tpu_torch import native
    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.data.dataset import (NuScenesOccDataset,
                                                  data_loader, prefetch)
    from fusionocc_tpu_torch.data.pipeline import to_device
    from fusionocc_tpu_torch.eval.metrics import fscore
    from fusionocc_tpu_torch.models.fusion_occ import (FusionOcc,
                                                       frame_pooling_index,
                                                       spread_weights)
    print(f'[8/12] evaluation: a written scene of {EVAL_SAMPLES} samples at '
          'full raw size through tools/test_torch.py, bf16, batch 1')
    cfg = full_model_config()
    with tempfile.TemporaryDirectory(prefix='fusionocc_eval_') as root:
        t = time.perf_counter()
        ann, seg = write_tree(root, cfg)
        print(f'  tree written in {time.perf_counter() - t:.1f} s', flush=True)
        ds = NuScenesOccDataset(ann, cfg, img_seg_dir=seg, train=False)
        serial = []
        for i in range(EVAL_SERIAL):
            t = time.perf_counter()
            ds[i]
            serial.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        n = sum(1 for _ in prefetch(data_loader(
            ds, 1, shuffle=False, num_workers=EVAL_LOADER_WORKERS,
            pin_memory=True)))
        threaded = n / (time.perf_counter() - t)
        print(f'  loader: ms per sample, serial (first {EVAL_SERIAL}), '
              f'median {statistics.median(serial):.1f}, all '
              f'{[round(x, 1) for x in serial]}; through data_loader('
              f'num_workers={EVAL_LOADER_WORKERS}) and prefetch: '
              f'{threaded:.2f} samples/s', flush=True)
        if not native.STATS.built or min(
                native.STATS.calls.get(k, 0)
                for k in ('project_points', 'zbuffer_depth')) == 0:
            fail(f'the native z-buffer library was not built and used: '
                 f'built {native.STATS.built} ({native.STATS.error}), calls '
                 f'{native.STATS.calls}')
        print(f'  native library {native.STATS.path}: calls '
              f'{native.STATS.calls}', flush=True)
        lidar_density(ds, cfg)

        model = spread_weights(FusionOcc(cfg, device=DEV),
                               torch.Generator().manual_seed(0))
        res, tm, launched, kept = eval_run(
            'two-pass --buckets --rayiou', model, ann, seg,
            launches_per(cfg, cfg.num_frame, 1), '--buckets', '--rayiou',
            keep=True)
        eval_run('--streaming', model, ann, seg, launches_per(cfg, 1, 1),
                 '--streaming')
        eval_run('--batch-frames', model, ann, seg, launches_per(cfg, 1, 1),
                 '--batch-frames')
        import tools.test_torch as tt
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            t = time.perf_counter()
            tt.evaluate(eval_args(ann, seg, '--buckets'), model=model)
            wall = (time.perf_counter() - t) * 1e3
        kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        ) / 1e3
        print(f'  profiled two-pass --buckets run: wall {wall:.1f} ms, '
              f'kernel time {kernel_ms:.1f} ms, device idle share '
              f'{1 - kernel_ms / wall:.3f}', flush=True)

        # the loop's predictions against predict on the same loaded batches
        batches = [to_device(host, DEV) for host, _ in kept]
        key = frame_pooling_index(
            cfg, batches[0].sensor2keyego[:, 0], batches[0].intrins[:, 0],
            batches[0].post_rots[:, 0], batches[0].post_trans[:, 0],
            batches[0].bda)
        dev_ms, f_ms = [], []
        for i, (b, (host, pred)) in enumerate(zip(batches, kept)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = model.predict(b, pool_idxs=[key, None])
            end.record()
            torch.cuda.synchronize()
            dev_ms.append(start.elapsed_time(end))
            if not torch.equal(pred, want):
                fail(f'eval sample {i}: the loop predicted otherwise than '
                     f'predict (agreement '
                     f'{(pred == want).float().mean().item():.6f})')
            if i >= EVAL_FSCORE:
                continue
            t = time.perf_counter()
            fs = fscore(pred[0].cpu().numpy(), host.voxel_semantics[0].numpy(),
                        host.mask_camera[0].numpy())
            f_ms.append((time.perf_counter() - t) * 1e3)
            if not all(map(math.isfinite, fs.values())):
                fail(f'eval sample {i}: F-score not finite: {fs}')
        print(f'  two-pass predictions equal predict on the same loaded '
              f'batches ({EVAL_SAMPLES} samples); predict device ms per '
              f'sample (CUDA events) median {statistics.median(dev_ms):.2f}, '
              f'all {[round(x, 2) for x in dev_ms]}; F-score (host) ms per '
              f'sample, first {EVAL_FSCORE}, median '
              f'{statistics.median(f_ms):.1f}, last {fs}',
              flush=True)
        print(f'  where an evaluated sample\'s time goes (medians, ms): '
              f'loader serial {statistics.median(serial):.1f} '
              f'(threaded {1e3 / threaded:.1f} per sample); predict device '
              f'{statistics.median(dev_ms):.2f}; mIoU update '
              f'{statistics.median(tm.metric) * 1e3:.2f} (device); RayIoU '
              f'{statistics.median(tm.rayiou) * 1e3:.1f}, F-score '
              f'{statistics.median(f_ms):.1f} (host)', flush=True)

        # calibration on the card: one sample's logits, the temperature fit
        from fusionocc_tpu_torch.eval.calibration import (export_logits,
                                                          fit_temperature,
                                                          uncertainty_maps)
        ex = export_logits(model, batches[0])
        logits = torch.from_numpy(ex['logits']).to(DEV)
        torch.cuda.synchronize()
        t = time.perf_counter()
        temp = fit_temperature(logits,
                               torch.from_numpy(ex['voxel_semantics']).to(DEV),
                               torch.from_numpy(ex['mask_camera']).to(DEV))
        fit_ms = (time.perf_counter() - t) * 1e3
        unc = uncertainty_maps(logits, temp)
        if not (math.isfinite(temp) and bool(torch.isfinite(
                unc['entropy']).all())):
            fail(f'calibration: temperature {temp} or entropy not finite')
        print(f'  calibration on the card: fit_temperature over one sample\'s '
              f'{logits.shape[1:4].numel()} voxels (60 golden-section steps) '
              f'T = {temp:.4f} in {fit_ms:.1f} ms; mean MSP '
              f'{unc["msp"].mean().item():.4f}, mean normalised entropy '
              f'{unc["entropy"].mean().item():.4f}', flush=True)
        del ex, logits, unc

        # every kernel launch of one loaded sample against its plain version
        with KernelCheck('eval two-pass, one loaded sample', cfg) as kc:
            model.predict(batches[0], pool_idxs=[key, None])
        with KernelCheck('eval streamed, one loaded sample', cfg) as ks:
            model.predict_streaming(batches[0], model.init_streaming_state(1),
                                    pool_idx=key)
        for label, check, passes in (('two-pass', kc, cfg.num_frame),
                                     ('streamed', ks, 1)):
            want = {k: v for k, v in launches_per(cfg, passes, 1).items()
                    if v and k in KERNEL_TOLS[torch.bfloat16]}
            got = {k: n for k, (n, _, _) in check.seen.items()}
            if got != want:
                fail(f'eval {label}: launches per sample {got}, expected '
                     f'{want}')
        del model, batches, kept
    torch.cuda.empty_cache()
    return launched


# phase 9: data-parallel training over processes
DIST_WORLD = 2
DIST_STEPS = 2                          # midsize steps of 9a and 9b
DIST_WARMUP, DIST_TIMED = 1, 3          # full-size steps of 9c
DIST_DRAWS = 0.2                        # drop path rate of the midsize Swin
# against the one process's own change when its images and weights move by
# TRAIN_NOISE: phase 7b's gradient tolerances (fp32 sums in other orders
# through ReLUs at their kinks), tests/test_torch_train_step.py's others
DIST_SPREAD, DIST_GRAD_RTOL, DIST_LOSS_RTOL = TRAIN_SPREAD, TRAIN_RTOL, 1e-4
DIST_PARAM_RTOL, DIST_STATS_TOL = 1e-5, dict(atol=1e-4, rtol=1e-4)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def dist_midsize_config():
    """The midsize multi-modal config, fp32, every random draw on (ASPP's
    dropout, the depth-input drop, drop path at DIST_DRAWS)."""
    import dataclasses
    from fusionocc_tpu_torch.config import (OptimConfig, TrainConfig,
                                            midsize_model_config)
    cfg = midsize_model_config(use_lidar=True)
    cfg = dataclasses.replace(cfg, swin=dataclasses.replace(
        cfg.swin, drop_path_rate=DIST_DRAWS))
    return TrainConfig(model=cfg, optim=OptimConfig(lr=TRAIN_LR))


def differing_words(tensors) -> int:
    """32-bit words of ``tensors`` that differ between the ranks (0 when
    every rank holds the same bits)."""
    import torch.distributed as dist
    bits = torch.cat([t.detach().contiguous().reshape(-1).view(torch.int32)
                      for t in tensors])
    hi, lo = bits.clone(), bits
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return int((hi != lo).sum())


def model_words(model, state) -> list:
    return ([p for p in model.parameters()] + list(model.buffers())
            + list(state.ema.values()))


def to_host(tree):
    """A (nested) dict of tensors copied to the host."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return (tree.detach().to('cpu', copy=True) if torch.is_tensor(tree)
            else tree)


def midsize_steps(model, tc, batch, steps: int, state=None,
                  identical: bool = False) -> dict:
    """``steps`` train steps (from ``state``, else a fresh one): the logs
    and gradients of each, the model and train state after each (on the
    host); with ``identical`` the words that differ between the ranks
    after each step."""
    from fusionocc_tpu_torch.train import loop
    state = state or loop.create_train_state(model, tc)
    out = {'logs': [], 'grads': [], 'after': [], 'differ': []}
    for _ in range(steps):
        logs = loop.train_step(model, tc, state, batch)
        out['logs'].append({k: float(v) for k, v in logs.items()})
        out['grads'].append({n: p.grad.detach().to('cpu', copy=True)
                             for n, p in model.named_parameters()})
        out['after'].append(to_host({'model': model.state_dict(),
                                     'train': state.state_dict()}))
        if identical:
            out['differ'].append(differing_words(model_words(model, state)))
    return out


def dist_mid_task(rank, world, tmp) -> dict:
    """9a (2 ranks) or 9b (world 1): the midsize steps on this rank's rows
    of the first ``world`` samples; with 2 ranks also 9d, the metric of
    the trained model's predictions of this rank's 2 of the 4 samples."""
    from fusionocc_tpu_torch.eval.metrics import OccupancyMetric
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
    from fusionocc_tpu_torch.parallel.mesh import shard_batch
    saved = torch.load(f'{tmp}/mid.pt', weights_only=False)
    tc = dist_midsize_config()
    model = FusionOcc(tc.model, device=DEV)
    model.load_state_dict(saved['model'])
    four = saved['batch']
    batch = shard_batch(type(four)(*(None if a is None else a[:world]
                                     for a in four)), rank, world)
    out = midsize_steps(model, tc, to_card(batch), DIST_STEPS,
                        identical=world > 1)
    if world > 1:
        mine = to_card(shard_batch(four, rank, world))
        pred = model.predict(mine)
        met = OccupancyMetric(grid=tc.model.grid)
        met.update(pred, mine.voxel_semantics, mask_camera=mine.mask_camera)
        out['pred'] = pred.cpu()
        out['metric'] = met.compute()
    return out


def dist_full_task(rank, world, tmp) -> dict:
    """9c: the default full-size config in bf16, batch 1 per rank: warm-up
    and timed train steps with their launches, collectives and times; the
    peak memory above what was held; the ranks' differing words."""
    from fusionocc_tpu_torch.config import TrainConfig, full_model_config
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    from fusionocc_tpu_torch.parallel import mesh
    from fusionocc_tpu_torch.train import loop
    cfg = full_model_config()
    tc = TrainConfig(model=cfg)
    model = init_weights(FusionOcc(cfg, device=DEV),
                         torch.Generator().manual_seed(0))
    state = loop.create_train_state(model, tc)
    batch = to_card(mesh.shard_batch(
        torch.load(f'{tmp}/full.pt', weights_only=False), rank, world))
    base = reset_peak()
    rows = []
    for i in range(DIST_WARMUP + DIST_TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in '12')
        torch.cuda.synchronize()
        KERNELS.reset_counts()
        mesh.COLLECTIVES.reset()
        mesh.COLLECTIVES.timed = True
        t = time.perf_counter()
        start.record()
        logs = loop.train_step(model, tc, state, batch)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        mesh.COLLECTIVES.timed = False
        rows.append({'ms': start.elapsed_time(end), 'wall_ms': wall * 1e3,
                     'collective_ms': sum(
                         mesh.COLLECTIVES.kind_seconds.values()) * 1e3,
                     'collectives': dict(mesh.COLLECTIVES.calls),
                     'collective_mb': sum(
                         mesh.COLLECTIVES.kind_bytes.values()) / 1e6,
                     'launches': {k: KERNELS.launches[k]
                                  for k in MAIN_KERNELS},
                     'logs': {k: float(v) for k, v in logs.items()}})
    peak = torch.cuda.max_memory_allocated()
    return {'rows': rows, 'held_gib': base / 2 ** 30,
            'peak_above_gib': (peak - base) / 2 ** 30,
            'differ': differing_words(model_words(model, state))}


DIST_TASKS = {'mid': dist_mid_task, 'full': dist_full_task}


def to_card(batch):
    return type(batch)(*(None if a is None else a.to(DEV) for a in batch))


def dist_rank(rank, world, tasks, tmp, port) -> None:
    """A spawned rank: 2 ranks join a gloo group on the one card (NCCL
    refuses two ranks on one device); world 1 joins an NCCL group (9b)."""
    import torch.distributed as dist
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    from fusionocc_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    url = f'tcp://localhost:{port}'
    if world == 1:
        dist.init_process_group('nccl', init_method=url, world_size=1,
                                rank=0, device_id=torch.device(DEV))
    else:
        mesh.init_distributed(url, world, rank, backend='gloo', device=DEV)
    KERNELS.load()
    try:
        for task in tasks:
            torch.save(DIST_TASKS[task](rank, world, tmp),
                       f'{tmp}/{task}_{world}_{rank}.pt')
    finally:
        dist.destroy_process_group()


def spawn_ranks(world, tasks, tmp) -> list:
    """Run ``tasks`` on ``world`` spawned ranks; their results by rank."""
    import torch.multiprocessing as mp
    try:
        mp.spawn(dist_rank, args=(world, tasks, tmp, free_port()),
                 nprocs=world, join=True)
    except Exception as e:      # noqa: BLE001 -- a failed rank fails the phase
        fail(f'{world} rank(s) running {tasks}: {e}')
    return [{t: torch.load(f'{tmp}/{t}_{world}_{r}.pt', weights_only=False)
             for t in tasks} for r in range(world)]


def held_to_one(label, tc, got, pairs) -> None:
    """Each of the ranks' midsize steps against one process's step at the
    global batch from the same state (``one_process_steps``): the losses
    within DIST_SPREAD x the one process's change under the perturbation
    plus DIST_LOSS_RTOL of the loss; the gradients and
    grad_norm within DIST_SPREAD x that change plus DIST_GRAD_RTOL of the
    norm; after the step, as tests/test_torch_train_step.py holds them
    after Adam's first: each parameter within 2.1 lr everywhere and, where
    the two gradients agree in sign above SIGN_MIN, within 1e-6 +
    DIST_PARAM_RTOL of itself plus 2 lr times their relative difference
    (the most such a difference moves Adam's update from one state), the
    EMA within ema_momentum x 2.1 lr, the running statistics within
    DIST_STATS_TOL."""
    from fusionocc_tpu_torch.train import loop
    worst = {'loss': 0.0, 'grad': 0.0, 'param': 0.0, 'at': ''}
    for s, (one, perts) in enumerate(pairs):
        want, logs = one['logs'][0], got['logs'][s]
        for key in ('loss', 'depth_loss', 'seg_loss', 'loss_occ'):
            err = abs(logs[key] - want[key])
            bound = (DIST_SPREAD * max(abs(p['logs'][0][key] - want[key])
                                       for p in perts)
                     + DIST_LOSS_RTOL * abs(want[key]))
            worst['loss'] = max(worst['loss'], err / max(bound, 1e-30))
            if err > bound:
                fail(f'{label} step {s} {key} {logs[key]} against {want[key]}')
        ref_g = one['grads'][0]
        moved = [p['grads'][0] for p in perts]
        spread = max(float(loop.global_norm([m[n] - g for n, g in
                                             ref_g.items()])) for m in moved)
        if abs(logs['grad_norm'] - want['grad_norm']) > (
                DIST_SPREAD * spread + DIST_GRAD_RTOL * want['grad_norm']):
            fail(f'{label} step {s} grad_norm {logs["grad_norm"]} against '
                 f'{want["grad_norm"]}')
        for n, g in ref_g.items():
            err = float((got['grads'][s][n] - g).norm())
            bound = float(DIST_SPREAD * max((m[n] - g).norm() for m in moved)
                          + DIST_GRAD_RTOL * g.norm())
            if err / max(bound, 1e-30) > worst['grad']:
                worst['grad'], worst['at'] = err / max(bound, 1e-30), \
                    f'{n} step {s}'
            if err > bound:
                fail(f'{label} step {s} gradient {n}: {err:.3e} beyond '
                     f'{bound:.3e}')
        # the step's update from the same state: Adam moves a parameter by
        # at most lr (2.1 lr between two runs, whatever their gradients);
        # where the two gradients agree in sign above SIGN_MIN, a relative
        # gradient difference d (with the clipping's: the norms') moves it
        # by at most 2 d lr
        lr = loop.make_lr_schedule(tc.optim)(got['after'][s]['train']['count']
                                             - 1)
        ema_tol = tc.optim.ema_momentum * 2.1 * lr
        mine, ref = got['after'][s], one['after'][0]
        grads = got['grads'][s]
        d_norm = abs(logs['grad_norm'] - want['grad_norm']) / want['grad_norm']
        for k, want_t in ref['model'].items():
            g = mine['model'][k]
            if k in grads:
                same = ((torch.sign(grads[k]) == torch.sign(ref_g[k]))
                        & (grads[k].abs() > SIGN_MIN)
                        & (ref_g[k].abs() > SIGN_MIN))
                d = ((grads[k] - ref_g[k]).abs()
                     / torch.minimum(grads[k].abs(), ref_g[k].abs())
                     .clamp_min(SIGN_MIN)) + d_norm
                diff = (g - want_t).abs()
                close = diff <= (1e-6 + DIST_PARAM_RTOL * want_t.abs()
                                 + 2 * d * lr)
                worst['param'] = max(worst['param'],
                                     float(diff.max()) / (2.1 * lr))
                ok = bool((close | ~same).all()) and float(
                    diff.max()) <= 2.1 * lr
                if not ok:
                    i = int(((diff - 2.1 * lr) * ~same
                             + diff * (same & ~close)).argmax())
                    print(f'    {k}: {int((same & ~close).sum())} of '
                          f'{same.numel()} entries beyond their bound; the '
                          f'worst moves {float(diff.view(-1)[i]):.3e} '
                          f'(gradients {float(grads[k].view(-1)[i]):.4e}, '
                          f'{float(ref_g[k].view(-1)[i]):.4e}; lr {lr:.3e})',
                          flush=True)
            elif want_t.is_floating_point():
                ok, _, _ = within(g, want_t, **DIST_STATS_TOL)
            else:
                ok = torch.equal(g, want_t)
            if not ok:
                fail(f'{label} step {s}: {k} differs from one process')
        for k, want_t in ref['train']['ema'].items():
            ok, _, _ = within(mine['train']['ema'][k], want_t, ema_tol,
                              DIST_PARAM_RTOL)
            if not ok:
                fail(f'{label} step {s}: the EMA of {k} differs')
    print(f'  {label}: each step\'s losses, gradients and grad_norm, then '
          f'its parameters, running statistics and EMA held; largest error '
          f'over its bound: losses {worst["loss"]:.3f}, gradients '
          f'{worst["grad"]:.3f} ({worst["at"]}); largest parameter change '
          f'against one process {worst["param"]:.3f} of 2.1 lr', flush=True)


def one_process_steps(tc, start, four, rows: int, got,
                      steps: int = DIST_STEPS) -> list:
    """For each step of the ranks' run ``got``: the same step in this
    process at batch ``rows`` from the state the ranks held before it
    (``start`` before the first), and twice more with the images moved
    by TRAIN_NOISE (relative), the second time the weights too (the BEV
    trunk's ReLUs sit at kinks that the images barely reach:
    tests/test_torch_parallel.py); the spread of a value is the larger of
    its two changes.  Each step is so held against one process's
    step from the same state: after the first, Adam's first update has
    moved the parameters of near-zero gradients by up to 2 lr either way,
    so two runs' trajectories part further than any one step does."""
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
    from fusionocc_tpu_torch.train import loop
    batch = to_card(type(four)(*(None if a is None else a[:rows]
                                 for a in four)))
    noise = torch.randn(batch.imgs.shape, device=DEV,
                        generator=torch.Generator(DEV).manual_seed(5))
    moved = batch._replace(imgs=batch.imgs * (1 + TRAIN_NOISE * noise))
    pairs = []
    for s in range(steps):
        before = ({'model': start} if s == 0 else got['after'][s - 1])
        runs = []
        for b, weights in ((batch, False), (moved, False), (moved, True)):
            model = FusionOcc(tc.model, device=DEV)
            model.load_state_dict(before['model'])
            if weights:
                g = torch.Generator(DEV).manual_seed(6)
                with torch.no_grad():
                    for p in model.parameters():
                        p.mul_(1 + TRAIN_NOISE * torch.randn(
                            p.shape, device=DEV, generator=g))
            state = loop.create_train_state(model, tc)
            if 'train' in before:
                state.load_state_dict(before['train'])
            runs.append(midsize_steps(model, tc, b, 1, state))
        pairs.append((runs[0], runs[1:]))
    return pairs


def one_process_fullsize(batch) -> dict:
    """Single-process full-size bf16 steps beside 9c: ms per step (CUDA
    events, wall) and the peak above what was held, at batch 1 and 2."""
    from fusionocc_tpu_torch.config import TrainConfig, full_model_config
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.train import loop
    cfg = full_model_config()
    tc = TrainConfig(model=cfg)
    out = {}
    for b in (1, 2):
        model = init_weights(FusionOcc(cfg, device=DEV),
                             torch.Generator().manual_seed(0))
        state = loop.create_train_state(model, tc)
        rows = type(batch)(*(None if a is None else a[:b] for a in batch))
        base = reset_peak()
        ms, wall = [], []
        for i in range(DIST_WARMUP + DIST_TIMED):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in '12')
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            loop.train_step(model, tc, state, rows)
            end.record()
            torch.cuda.synchronize()
            if i >= DIST_WARMUP:
                ms.append(start.elapsed_time(end))
                wall.append((time.perf_counter() - t) * 1e3)
        out[b] = (statistics.median(ms), statistics.median(wall),
                  peak_above(base))
        del model, state
        torch.cuda.empty_cache()
    return out


def phase_dist(batches) -> dict:
    """Phase 9: data-parallel training over processes on the one card.
    Returns the launches per rank per full-size step."""
    import tempfile
    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.eval.metrics import OccupancyMetric
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    print(f'[9/12] data-parallel training: {DIST_WORLD} ranks on the one '
          'card exchange CUDA tensors over gloo (NCCL refuses two ranks on '
          'one device; gloo stages each collective through the host, so '
          'these times measure neither NCCL nor a second card and are no '
          'scaling figures); NCCL at world 1', flush=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='fusionocc_dist_')
    tc = dist_midsize_config()
    model = init_weights(FusionOcc(tc.model, device='cpu'),
                         torch.Generator().manual_seed(11))
    four = synthetic_batch(tc.model, 2 * DIST_WORLD, 0, device='cpu')
    torch.save({'model': model.state_dict(), 'batch': four}, f'{tmp}/mid.pt')
    full = type(batches[0])(*(None if a[0] is None else
                              torch.cat(a[:DIST_WORLD]).cpu()
                              for a in zip(*batches)))
    torch.save(full, f'{tmp}/full.pt')
    t1 = time.perf_counter()
    single = one_process_fullsize(to_card(full))
    print(f'  inputs in {t1 - t0:.1f} s, one-process full-size steps in '
          f'{time.perf_counter() - t1:.1f} s', flush=True)

    t0 = time.perf_counter()
    nccl = spawn_ranks(1, ['mid'], tmp)[0]['mid']
    t1 = time.perf_counter()
    held_to_one('9b NCCL world 1, midsize fp32, batch 1, against the '
                'non-distributed step', tc, nccl, one_process_steps(
                    tc, model.state_dict(), four, 1, nccl))
    print(f'  9b: the rank in {t1 - t0:.1f} s, the one-process steps and '
          f'checks in {time.perf_counter() - t1:.1f} s', flush=True)

    t0 = time.perf_counter()
    ranks = spawn_ranks(DIST_WORLD, ['mid', 'full'], tmp)
    print(f'  {DIST_WORLD} ranks (9a, 9c, 9d) in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    mids = [r['mid'] for r in ranks]
    for r, m in enumerate(mids):
        if any(m['differ']) or m['logs'] != mids[0]['logs']:
            fail(f'9a: rank {r} holds other bits after a step '
                 f'(differing words per step {m["differ"]})')
    held_to_one(f'9a {DIST_WORLD} ranks x batch 1 against one process at '
                f'batch {DIST_WORLD}, midsize fp32, draws on, '
                f'{DIST_STEPS} steps', tc, mids[0], one_process_steps(
                    tc, model.state_dict(), four, DIST_WORLD, mids[0]))
    print(f'  9a: the ranks\' parameters, buffers and EMA bit-identical '
          f'after each step (differing words {mids[0]["differ"]})',
          flush=True)

    fulls = [r['full'] for r in ranks]
    expect = train_launches(full_model_config())
    for r, f in enumerate(fulls):
        for i, row in enumerate(f['rows']):
            if row['launches'] != expect:
                fail(f'9c rank {r} step {i}: launches {row["launches"]}, '
                     f'expected {expect}')
            if not all(map(math.isfinite, row['logs'].values())):
                fail(f'9c rank {r} step {i}: not finite: {row["logs"]}')
        if f['differ']:
            fail(f'9c: rank {r} differs in {f["differ"]} words')
        timed = f['rows'][DIST_WARMUP:]
        med = {k: statistics.median(row[k] for row in timed)
               for k in ('ms', 'wall_ms', 'collective_ms', 'collective_mb')}
        print(f'  9c rank {r}: s/iter {med["ms"] / 1e3:.4f} (CUDA events), '
              f'{med["wall_ms"] / 1e3:.4f} (wall), median of {DIST_TIMED} '
              f'after {DIST_WARMUP} warm-up; inside collectives '
              f'{med["collective_ms"]:.1f} ms per step (card synchronised '
              f'around each); collectives per step {timed[0]["collectives"]}'
              f' ({med["collective_mb"]:.1f} MB); peak memory '
              f'{f["peak_above_gib"]:.2f} GiB above the '
              f'{f["held_gib"]:.2f} GiB held; launches per step '
              f'{timed[0]["launches"]}; losses '
              + ', '.join(f'{row["logs"]["loss"]:.4f}' for row in f['rows']),
              flush=True)
    if fulls[0]['rows'][-1]['logs'] != fulls[1]['rows'][-1]['logs']:
        fail('9c: the ranks log other losses')
    print(f'  9c: the ranks\' parameters, buffers and EMA bit-identical after '
          f'{DIST_WARMUP + DIST_TIMED} steps', flush=True)
    for b, (ms, wall, peak) in single.items():
        print(f'  one process, batch {b}, same steps: s/iter {ms / 1e3:.4f} '
              f'(CUDA events), {wall / 1e3:.4f} (wall); {peak}', flush=True)

    # 9d: the metric over the ranks against one process over the 4 samples
    met = OccupancyMetric(grid=tc.model.grid)
    for r, m in enumerate(mids):
        rows = type(four)(*(None if a is None else
                            a[2 * r:2 * r + 2].to(DEV) for a in four))
        met.update(m['pred'].to(DEV), rows.voxel_semantics,
                   mask_camera=rows.mask_camera)
    want = met.compute()
    for r, m in enumerate(mids):
        if m['metric'].keys() != want.keys() or not all(
                m['metric'][k] == v or math.isnan(v)
                and math.isnan(m['metric'][k]) for k, v in want.items()):
            fail(f'9d: rank {r}\'s summed metric {m["metric"]} differs from '
                 f'one process\'s {want}')
    print(f'  9d: OccupancyMetric summed over {DIST_WORLD} ranks (2 predicted '
          f'samples each) equals one process over the 4: mIoU '
          f'{want["mIoU"]:.4f}, {len(want)} keys equal', flush=True)
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return fulls[0]['rows'][-1]['launches']


# -- phase 10: int8 serving, the serving export, the base view transformers --
INT8_DENSE_BOUNDS = (0.08, 0.99)    # JAX's tests/test_quant.py:136-140
INT8_WEIGHT_BOUNDS = (0.05, 0.995)  # JAX's tests/test_quant.py:109-111
SERVE_REPS = 5                      # timed predicts per serving mode


def set_int8(model, on: bool) -> None:
    """Route the Swin backbone's Linears through int8 products or not (the
    same weights either way: ``SwinConfig.int8_dense``)."""
    from fusionocc_tpu_torch.nn.layers import Linear
    for mod in model.img_backbone.modules():
        if isinstance(mod, Linear):
            mod.int8 = on


def timed_predicts(model, batches, pool_idxs, reps: int = SERVE_REPS):
    """One warm-up, then ``reps`` two-pass predicts over ``batches`` in
    turn: (device ms per predict by CUDA events, Swin-B's device ms per
    predict, the logits of each batch)."""
    clock = ModuleClock(model.img_backbone)
    with torch.inference_mode():
        logits = [model(b, pool_idxs)['occ_logits'] for b in batches]
        clock.reset()
        ms = []
        for i in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.predict(batches[i % len(batches)], pool_idxs)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
    swin = clock.call_ms()
    clock.remove()
    per = [sum(swin[i:i + 2]) for i in range(0, len(swin), 2)]
    return ms, per, logits


def drift_agree(got, want) -> tuple:
    """max |got - want| / max |want| over the batches' logits, and the
    share of voxels whose argmax agrees."""
    drift = max((g - w).abs().max().item() for g, w in zip(got, want))
    scale = max(w.abs().max().item() for w in want)
    agree = (sum((g.argmax(-1) == w.argmax(-1)).float().mean().item()
                 for g, w in zip(got, want)) / len(want))
    return drift / scale, agree


def int8_products(model, batch, pool_idxs) -> list:
    """10a: one int8 predict with every int8 product taken twice, through
    ``torch._int_mm`` and through the exact plain product on the same
    operands: fail unless bit-equal.  Returns the distinct (M, K, N) with
    each shape's operands of its first call."""
    from fusionocc_tpu_torch import quant
    real, seen = quant.int8_mm, {}

    def checked(a, b):
        got = real(a, b)
        want = quant.int8_mm_plain(a, b)
        if not torch.equal(got, want):
            fail(f'10a: torch._int_mm at {tuple(a.shape)} x {tuple(b.shape)} '
                 'differs from the plain int32 product')
        seen.setdefault((a.shape[0], a.shape[1], b.shape[1]), (a, b))
        return got
    quant.int8_mm = checked
    try:
        with torch.inference_mode():
            model.predict(batch, pool_idxs)
    finally:
        quant.int8_mm = real
    return seen


def serving_int8(cfg, batches) -> dict:
    """10a-10c on one full-size bf16 model with spread weights: the int8
    products, the ``int8_dense`` predict and the ``--int8-weights`` predict
    beside the bf16 one, each predict's launches gated.  Returns the
    launches per int8 predict."""
    from fusionocc_tpu_torch import quant
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, batch_pooling_indices, spread_weights)
    model = spread_weights(FusionOcc(cfg, device=DEV),
                           torch.Generator().manual_seed(0))
    pool_idxs = batch_pooling_indices(cfg, batches[0])
    expect = launches_per(cfg, cfg.num_frame, 1)

    set_int8(model, True)
    shapes = int8_products(model, batches[0], pool_idxs)
    rows = []
    for (M, K, N), (a, b) in sorted(shapes.items()):
        t_lib = cuda_ms(lambda: quant.int8_mm(a, b), reps=5, warmup=1)
        t_plain = cuda_ms(lambda: quant.int8_mm_plain(a, b), reps=2,
                          warmup=1)
        rows.append(f'{M}x{K}x{N} {t_lib:.4f}/{t_plain:.3f}')
    print(f'  10a: every int8 product of one int8_dense predict '
          f'({len(shapes)} shapes) through torch._int_mm bit-equal to the '
          f'plain int32 product (float64 sums); ms torch._int_mm / plain '
          f'per shape M x K x N: ' + ', '.join(rows), flush=True)

    set_int8(model, False)
    base_ms, base_swin, base = timed_predicts(model, batches, pool_idxs)
    set_int8(model, True)
    counted('10b int8_dense predict',
            lambda: model.predict(batches[0], pool_idxs), expect)
    int8_ms, int8_swin, got = timed_predicts(model, batches, pool_idxs)
    if not all(bool(torch.isfinite(g).all()) for g in got):
        fail('10b: int8_dense logits not finite')
    drift, agree = drift_agree(got, base)
    med = statistics.median
    print(f'  10b int8_dense two-pass predict, launches {expect} per predict:'
          f' ms per predict median {med(int8_ms):.2f} (all '
          f'{[round(t, 2) for t in int8_ms]}) against bf16 {med(base_ms):.2f}'
          f' (all {[round(t, 2) for t in base_ms]}) in this run; Swin-B '
          f'{med(int8_swin):.2f} ms ({med(int8_swin) / med(int8_ms):.3f} of '
          f'the predict) against {med(base_swin):.2f} '
          f'({med(base_swin) / med(base_ms):.3f}); logit drift / scale '
          f'{drift:.4f} (JAX tiny fp32 bound {INT8_DENSE_BOUNDS[0]}), argmax '
          f'agreement with bf16 {agree:.4f} (bound {INT8_DENSE_BOUNDS[1]})',
          flush=True)
    set_int8(model, False)

    live = {k: v.clone() for k, v in model.state_dict().items()}
    sizes = quant.load_int8_weights(model, cfg)
    counted('10c --int8-weights predict',
            lambda: model.predict(batches[0], pool_idxs), expect)
    w8_ms, _, got = timed_predicts(model, batches, pool_idxs)
    if not all(bool(torch.isfinite(g).all()) for g in got):
        fail('10c: --int8-weights logits not finite')
    drift, agree = drift_agree(got, base)
    print(f'  10c --int8-weights two-pass predict ({sizes}), launches '
          f'{expect}: ms per predict median {med(w8_ms):.2f} (all '
          f'{[round(t, 2) for t in w8_ms]}); logit drift / scale '
          f'{drift:.4f} (JAX tiny fp32 bound {INT8_WEIGHT_BOUNDS[0]}), '
          f'argmax agreement with bf16 {agree:.4f} (bound '
          f'{INT8_WEIGHT_BOUNDS[1]})', flush=True)
    model.load_state_dict(live)
    del model, live
    torch.cuda.empty_cache()
    return expect


def serving_export(cfg, batches) -> dict:
    """10d: ``tools/export_torch.py``'s export, save, load and run of the
    full-size predict and streaming step (bf16, spread weights): the loaded
    program's output equal to eager's, its launches counted, its ms beside
    eager's.  Returns the launches per run of each loaded program."""
    import os
    import shutil
    import tempfile
    from fusionocc_tpu_torch.models.fusion_occ import (FusionOcc,
                                                       spread_weights)
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    from tools import export_torch as et
    model = spread_weights(FusionOcc(cfg, device=DEV),
                           torch.Generator().manual_seed(0))
    tmp = tempfile.mkdtemp(prefix='fusionocc_export_')
    out = {}
    try:
        for mode in ('two-pass', 'streaming'):
            state = (model.init_streaming_state(1) if mode == 'streaming'
                     else None)
            passes = 1 if state is not None else cfg.num_frame
            expect = launches_per(cfg, passes, 1)
            KERNELS.reset_counts()
            t0 = time.perf_counter()
            program = et.export_program(model, batches[0], state)
            export_s = time.perf_counter() - t0
            traced = {k: v for k, v in KERNELS.launches.items() if v}
            if traced:
                fail(f'10d: tracing launched kernels {traced}')
            path = os.path.join(tmp, f'{mode}.pt2')
            t0 = time.perf_counter()
            torch.export.save(program, path)
            save_s = time.perf_counter() - t0
            del program
            t0 = time.perf_counter()
            loaded = torch.export.load(path).module()
            load_s = time.perf_counter() - t0
            args = et.program_args(batches[0], state)

            def run_loaded():
                with torch.no_grad():
                    return loaded(*args)
            got = counted(f'10d loaded {mode} program', run_loaded, expect)
            want = et.eager(model, batches[0], state)
            got0 = got[0] if state is not None else got
            want0 = want[0] if state is not None else want
            if not torch.equal(got0, want0):
                agree = (got0 == want0).float().mean().item()
                fail(f'10d: the loaded {mode} program\'s prediction differs '
                     f'from eager\'s (voxel agreement {agree:.6f})')
            if state is not None and not all(
                    torch.equal(g, w) for g, w in zip(got[1:], want[1:])):
                fail('10d: the loaded streaming program\'s new state differs')
            ms_loaded = cuda_ms(run_loaded, reps=SERVE_REPS, warmup=1)
            ms_eager = cuda_ms(lambda: et.eager(model, batches[0], state),
                               reps=SERVE_REPS, warmup=1)
            out[mode] = expect
            print(f'  10d {mode}: torch.export {export_s:.1f} s, save '
                  f'{save_s:.1f} s, {os.path.getsize(path) / 2**20:.1f} MiB, '
                  f'load {load_s:.1f} s; the loaded program\'s output equals '
                  f'eager\'s; launches {expect} per run; ms per run (CUDA '
                  f'events, {SERVE_REPS} queued) loaded {ms_loaded:.2f}, '
                  f'eager {ms_eager:.2f}', flush=True)
            del loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model
    torch.cuda.empty_cache()
    return out


@torch.inference_mode()
def serving_lss_base(cfg, batch) -> dict:
    """10e: ``LSSViewTransformer`` and ``LSSViewTransformerBEVDepth`` (plain
    and stereo) at full size on the key frame's pooling index, bf16: one K1
    launch each, every launch held against its plain version; the stereo
    one's cost volume (``stereo_cost_volume``) one plane sweep.  Returns
    the launches of the three calls and the cost volume's."""
    from fusionocc_tpu_torch.geometry import make_frustum
    from fusionocc_tpu_torch.models import lss_base
    from fusionocc_tpu_torch.models.fusion_occ import (frame_pooling_index,
                                                       init_weights)
    g = torch.Generator().manual_seed(5)
    idx = frame_pooling_index(cfg, batch.sensor2keyego[:, 0],
                              batch.intrins[:, 0], batch.post_rots[:, 0],
                              batch.post_trans[:, 0], batch.bda)
    H, W = cfg.input_size
    ds = cfg.vt.downsample
    N, cin, C = cfg.num_cams, cfg.img_neck_out_channels, cfg.img_channels
    x = torch.randn(1, N, H // ds, W // ds, cin, generator=g).to(
        DEV, cfg.dtype)
    mlp = torch.randn(1, N, 27, generator=g).to(DEV)
    hs, ws = H // 4, W // 4
    prev = torch.randn(N, hs, ws, 128, generator=g).to(DEV, cfg.dtype)
    curr = (prev.float() + 0.3 * torch.randn(N, hs, ws, 128, generator=g).to(
        DEV)).to(cfg.dtype)
    sweep = {k: 0 for k in MAIN_KERNELS}
    sweep['plane_sweep_fwd'] = 1
    cv = counted('10e stereo_cost_volume', lambda: lss_base.stereo_cost_volume(
        prev, curr, make_frustum(cfg.grid.depth, (H, W), 4, device=DEV),
        batch.sensor2keyego[:, 0], batch.intrins[:, 0],
        batch.post_rots[:, 0], batch.post_trans[:, 0]), sweep)
    modules = (
        ('LSSViewTransformer', lss_base.LSSViewTransformer(cfg.grid, cin, C),
         lambda m: m(x, idx)),
        ('LSSViewTransformerBEVDepth',
         lss_base.LSSViewTransformerBEVDepth(cfg.grid, cin, C),
         lambda m: m(x, mlp, idx)),
        ('LSSViewTransformerBEVDepth stereo',
         lss_base.LSSViewTransformerBEVDepth(cfg.grid, cin, C, stereo=True),
         lambda m: m(x, mlp, idx, cv)))
    expect = {k: 0 for k in MAIN_KERNELS}
    expect['bev_pool_fwd'] = 1
    for label, mod, run in modules:
        mod = init_weights(mod.to(DEV).eval(), g)
        with KernelCheck(f'10e {label}', cfg):
            voxel, depth = counted(f'10e {label}', lambda: run(mod), expect)
        gx, gy, gz = cfg.grid.grid_size
        if (voxel.shape != (1, gz, gy, gx, C) or not bool(
                torch.isfinite(voxel).all()) or not bool(
                torch.isfinite(depth).all())):
            fail(f'10e {label}: voxel {tuple(voxel.shape)} or depth not '
                 'finite')
        ms = cuda_ms(lambda: run(mod), reps=3, warmup=1)
        print(f'  10e {label}: voxel {tuple(voxel.shape)} '
              f'{str(voxel.dtype).split(".")[-1]} finite, K1 1 launch, '
              f'{ms:.2f} ms per call', flush=True)
    print(f'  10e: stereo cost volume {tuple(cv.shape)} finite '
          f'{bool(torch.isfinite(cv).all())}, 1 plane sweep', flush=True)
    return {k: expect[k] + sweep[k] for k in MAIN_KERNELS}


def phase_serving(batches) -> dict:
    """Phase 10: int8 serving, the serving export and the base view
    transformers at full size.  Returns each kernel's launches per run of
    the int8 predict, the loaded two-pass program and a base view
    transformer."""
    from fusionocc_tpu_torch.config import full_model_config
    print('[10/12] serving: int8 products, int8_dense and --int8-weights '
          'predicts, torch.export round trips, base view transformers; '
          'full size, bf16', flush=True)
    cfg = full_model_config()
    t0 = time.perf_counter()
    int8 = serving_int8(cfg, batches)
    t1 = time.perf_counter()
    export = serving_export(cfg, batches)
    t2 = time.perf_counter()
    lss = serving_lss_base(cfg, batches[0])
    print(f'  phase 10: int8 {t1 - t0:.1f} s, export {t2 - t1:.1f} s, base '
          f'view transformers {time.perf_counter() - t2:.1f} s', flush=True)
    return {'int8': int8, 'export': export['two-pass'],
            'export_streaming': export['streaming'], 'lss_base': lss}


# -- phase 11: the hybrid data x spatial mesh --------------------------------
HYB_SPATIAL = 2                     # spatial ranks of both meshes
HYB_BATCH = 2                       # the global batch
# midsize fp32 against one process on the card: sums in other orders and
# cuDNN's algorithms at other shapes (REF_TOL's size); the streaming state
# as tests/test_sharding.py:168-169 holds JAX's
HYB_TOL = dict(atol=1e-3, rtol=1e-3)
HYB_STATE_TOL = dict(atol=5e-3, rtol=5e-3)
HYB_REPS = 3                        # timed full-size predicts per rank
HYB_WARMUP, HYB_TIMED = 1, 2        # full-size train steps


def event_ms(fn, reps: int) -> list:
    """Device ms of each of ``reps`` calls of fn(), by CUDA events around
    each (fn may wait on the host)."""
    ms = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in '12')
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def hybrid_mid_task(rank, world, tmp) -> dict:
    """11a on one rank of (world // 2, 2): the midsize two-pass forward;
    at (2, 2) also ``predict_streaming_batch`` on the clip and one train
    step with the draws on (``midsize_steps``)."""
    from fusionocc_tpu_torch.models.fusion_occ import stack_batches
    from fusionocc_tpu_torch.parallel import mesh
    from fusionocc_tpu_torch.parallel.hybrid import HybridFusionOcc
    saved = torch.load(f'{tmp}/hmid.pt', weights_only=False)
    tc = dist_midsize_config()
    m = mesh.hybrid_mesh(world // HYB_SPATIAL, HYB_SPATIAL)
    model = HybridFusionOcc(tc.model, m, device=DEV)
    model.load_state_dict(saved['model'])
    batch = to_card(m.shard(saved['batch']))
    with torch.inference_mode():
        out = {'coords': (m.d, m.s),
               'logits': model(batch)['occ_logits'].cpu()}
    if world // HYB_SPATIAL == 1:
        return out
    frames = stack_batches([to_card(m.shard(f)) for f in saved['frames']])
    b = frames.imgs.shape[1]
    resets = saved['resets'][:, m.d * b:(m.d + 1) * b].to(DEV)
    preds, state = model.predict_streaming_batch(
        frames, model.init_streaming_state(b), resets=resets, chunk=2)
    out['stream'] = (preds.cpu(), state.voxel_feat.cpu(), state.valid.cpu())
    model.load_state_dict(saved['train'])
    from fusionocc_tpu_torch.train import loop
    state = loop.create_train_state(model, tc)
    out['train'] = midsize_steps(model, tc, batch, 1, state)
    out['differ'] = {
        'parameters and EMA': differing_words(
            list(model.parameters()) + list(state.ema.values())),
        'buffers': differing_words(list(model.buffers()))}
    return out


def hybrid_full_task(rank, world, tmp) -> dict:
    """11b on one rank of (2, 2): the default config at full size, bf16,
    ``spread_weights``, batch 1 per data rank.  A warm-up predict; one
    predict with the launches counted (rank 0 holds every launch against
    its plain version) and the collectives and halo rows counted;
    HYB_REPS timed by CUDA events; one with the time inside each
    collective; the peak memory above what was held.  Then train steps
    from ``init_weights``."""
    from fusionocc_tpu_torch.config import TrainConfig, full_model_config
    from fusionocc_tpu_torch.models.fusion_occ import (init_weights,
                                                       spread_weights)
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    from fusionocc_tpu_torch.parallel import mesh
    from fusionocc_tpu_torch.parallel.hybrid import HybridFusionOcc
    from fusionocc_tpu_torch.train import loop
    cfg = full_model_config()
    m = mesh.hybrid_mesh(world // HYB_SPATIAL, HYB_SPATIAL)
    batch = to_card(m.shard(torch.load(f'{tmp}/hfull.pt',
                                       weights_only=False)))
    model = spread_weights(HybridFusionOcc(cfg, m, device=DEV),
                           torch.Generator().manual_seed(0))
    idx = model.batch_pooling_indices(batch)
    base = reset_peak()
    model.predict(batch, idx)
    torch.cuda.synchronize()
    KERNELS.reset_counts()
    mesh.COLLECTIVES.reset()
    if rank == 0:
        with KernelCheck(f'11b rank {rank} predict', cfg):
            pred = model.predict(batch, idx)
    else:
        pred = model.predict(batch, idx)
    torch.cuda.synchronize()
    c = mesh.COLLECTIVES
    out = {'coords': (m.d, m.s), 'pred': pred.cpu(),
           'launches': {k: KERNELS.launches[k] for k in MAIN_KERNELS},
           'calls': dict(c.calls), 'bytes': dict(c.kind_bytes),
           'rows': sum(c.rows.values()), 'layer_rows': dict(c.rows)}
    ms = event_ms(lambda: model.predict(batch, idx), HYB_REPS)
    c.reset()
    c.timed = True
    t = time.perf_counter()
    model.predict(batch, idx)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    c.timed = False
    out.update(ms=ms, timed_wall_ms=wall,
               collective_ms={k: v * 1e3 for k, v in c.kind_seconds.items()},
               held_gib=base / 2 ** 30,
               peak_above_gib=(torch.cuda.max_memory_allocated() - base)
               / 2 ** 30)
    del model, idx
    torch.cuda.empty_cache()
    tc = TrainConfig(model=cfg)
    model = init_weights(HybridFusionOcc(cfg, m, device=DEV),
                         torch.Generator().manual_seed(0))
    state = loop.create_train_state(model, tc)
    rows = []
    for _ in range(HYB_WARMUP + HYB_TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in '12')
        torch.cuda.synchronize()
        KERNELS.reset_counts()
        start.record()
        logs = loop.train_step(model, tc, state, batch)
        end.record()
        torch.cuda.synchronize()
        rows.append({'ms': start.elapsed_time(end),
                     'launches': {k: KERNELS.launches[k]
                                  for k in MAIN_KERNELS},
                     'logs': {k: float(v) for k, v in logs.items()}})
    out['train'] = rows
    return out


def hybrid_mid14_task(rank, world, tmp) -> dict:
    """11a at (1, 4) on one rank of the same 4: the midsize two-pass forward
    of the first sample alone, so that ranks 2 and 3 hold no camera and
    rank 3 no row of the last Y level (XLA pads those blocks)."""
    from fusionocc_tpu_torch.models.fusion_occ import map_batch
    from fusionocc_tpu_torch.parallel import mesh
    from fusionocc_tpu_torch.parallel.hybrid import HybridFusionOcc
    saved = torch.load(f'{tmp}/hmid.pt', weights_only=False)
    m = mesh.hybrid_mesh(1, 4)
    model = HybridFusionOcc(dist_midsize_config().model, m, device=DEV)
    model.load_state_dict(saved['model'])
    batch = to_card(map_batch(lambda a: a[:1], saved['batch']))
    with torch.inference_mode():
        return {'coords': (m.d, m.s), 'images': m.image_block(
                    batch.imgs.shape[0] * batch.imgs.shape[2]),
                'logits': model(batch)['occ_logits'].cpu()}


HYB_TASKS = {'mid': hybrid_mid_task, 'full': hybrid_full_task,
             'mid14': hybrid_mid14_task}


def hybrid_rank(rank, world, tasks, tmp, port) -> None:
    """A spawned rank of the hybrid mesh: gloo on the one card (NCCL
    refuses two ranks on one device)."""
    import torch.distributed as dist
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    from fusionocc_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.init_distributed(f'tcp://localhost:{port}', world, rank,
                          backend='gloo', device=DEV)
    KERNELS.load()
    try:
        for task in tasks:
            t = time.perf_counter()
            out = HYB_TASKS[task](rank, world, tmp)
            out['seconds'] = time.perf_counter() - t
            torch.save(out, f'{tmp}/h{task}_{world}_{rank}.pt')
    finally:
        dist.destroy_process_group()


def spawn_hybrid(world, tasks, tmp) -> list:
    import torch.multiprocessing as mp
    try:
        mp.spawn(hybrid_rank, args=(world, tasks, tmp, free_port()),
                 nprocs=world, join=True)
    except Exception as e:      # noqa: BLE001 -- a failed rank fails the phase
        fail(f'{world} hybrid rank(s) running {tasks}: {e}')
    return [{t: torch.load(f'{tmp}/h{t}_{world}_{r}.pt', weights_only=False)
             for t in tasks} for r in range(world)]


def hybrid_mid_references(tmp) -> dict:
    """11a's inputs, saved for the ranks, and one process's outputs on
    them: the midsize fp32 forward and streamed clip (``spread_weights``)
    and the train step's start (``init_weights``)."""
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, init_weights, spread_weights, stack_batches)
    tc = dist_midsize_config()
    model = spread_weights(FusionOcc(tc.model, device=DEV),
                           torch.Generator().manual_seed(11))
    batch = synthetic_batch(tc.model, HYB_BATCH, 0, device='cpu')
    frames = [synthetic_batch(tc.model, HYB_BATCH, s, device='cpu')
              for s in range(4)]
    resets = torch.zeros(4, HYB_BATCH, dtype=torch.bool)
    resets[2] = True
    train = init_weights(FusionOcc(tc.model, device='cpu'),
                         torch.Generator().manual_seed(11)).state_dict()
    torch.save({'model': model.state_dict(), 'batch': batch,
                'frames': frames, 'resets': resets, 'train': train},
               f'{tmp}/hmid.pt')
    ref = {'tc': tc, 'batch': batch, 'train': train}
    with torch.inference_mode():
        ref['logits'] = model(to_card(batch))['occ_logits'].cpu()
        ref['logits14'] = model(to_card(
            type(batch)(*(None if a is None else a[:1] for a in batch)))
        )['occ_logits'].cpu()
        stacked = to_card(stack_batches(frames))
        preds, state = model.predict_streaming_batch(
            stacked, model.init_streaming_state(HYB_BATCH),
            resets=resets.to(DEV), chunk=2)
    ref['stream'] = (preds.cpu(), state.voxel_feat.cpu(), state.valid.cpu())
    return ref


def hybrid_full_references(tmp, ref) -> dict:
    """11b's batch, saved for the ranks, and one process's full-size bf16
    predict of its 2 samples (``spread_weights``) and ms at batch 1."""
    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, batch_pooling_indices, spread_weights)
    cfg = full_model_config()
    full = synthetic_batch(cfg, HYB_BATCH, 0, device='cpu')
    torch.save(full, f'{tmp}/hfull.pt')
    model = spread_weights(FusionOcc(cfg, device=DEV),
                           torch.Generator().manual_seed(0))
    card = to_card(full)
    ref['full_pred'] = model.predict(
        card, batch_pooling_indices(cfg, card)).cpu()
    one = type(card)(*(None if a is None else a[:1] for a in card))
    idx = batch_pooling_indices(cfg, one)
    model.predict(one, idx)
    ref['one_ms'] = statistics.median(
        event_ms(lambda: model.predict(one, idx), HYB_REPS))
    del model
    torch.cuda.empty_cache()
    return ref


def hybrid_midsize(ref, square, row) -> None:
    """11a: every rank's forward within HYB_TOL of one process's (at (1, 4)
    on the first sample), the streamed clip as
    tests/test_sharding.py:162-171 holds JAX's, the train step as phase
    9a holds the data mesh's."""
    worst = 0.0
    for r in square:
        got = r['mid14']
        ok, err, _ = within(got['logits'], ref['logits14'], **HYB_TOL)
        worst = max(worst, err)
        if not ok:
            fail(f'11a (1, 4) rank {got["coords"]}: logits {err:.3e} from '
                 'one process')
    print(f'  11a (1, 4) midsize fp32 two-pass forward, batch 1 (camera '
          f'blocks {[r["mid14"]["images"] for r in square]}, the last Y '
          f'level\'s 5 rows as 2 + 2 + 1 + 0): every rank\'s logits within '
          f'{HYB_TOL} of one process (max abs {worst:.3e}); the task took '
          f'{max(r["mid14"]["seconds"] for r in square):.1f} s per rank',
          flush=True)
    for label, ranks in (('(2, 2)', square), ('(1, 2)', row)):
        b = HYB_BATCH * HYB_SPATIAL // len(ranks)
        worst = 0.0
        for r in ranks:
            d = r['mid']['coords'][0]
            ok, err, _ = within(r['mid']['logits'],
                                ref['logits'][d * b:(d + 1) * b], **HYB_TOL)
            worst = max(worst, err)
            if not ok:
                fail(f'11a {label} rank {r["mid"]["coords"]}: logits '
                     f'{err:.3e} from one process')
        print(f'  11a {label} midsize fp32 two-pass forward, batch '
              f'{HYB_BATCH}: every rank\'s logits within {HYB_TOL} of one '
              f'process (max abs {worst:.3e})', flush=True)
    want_pred, want_feat, want_valid = ref['stream']
    agrees, worst = [], 0.0
    for r in square:
        d = r['mid']['coords'][0]
        pred, feat, valid = r['mid']['stream']
        agrees.append(float((pred == want_pred[:, d:d + 1]).float().mean()))
        ok, err, _ = within(feat, want_feat[d:d + 1], **HYB_STATE_TOL)
        worst = max(worst, err)
        if not ok or not torch.equal(valid, want_valid[d:d + 1]):
            fail(f'11a (2, 2) streaming state of rank {r["mid"]["coords"]}'
                 f' off by {err:.3e}')
    if min(agrees) < MIN_AGREE:
        fail(f'11a (2, 2) streaming agreement {agrees} below {MIN_AGREE}')
    print(f'  11a (2, 2) predict_streaming_batch, 4 frames, chunk 2, reset '
          f'at frame 2: voxel agreement with one process per rank '
          f'{[round(a, 6) for a in agrees]} (need >= {MIN_AGREE}); state '
          f'max abs {worst:.3e} (within {HYB_STATE_TOL})', flush=True)
    got = square[0]['mid']['train']
    for r in square:
        if r['mid']['differ']['parameters and EMA'] or (
                r['mid']['train']['logs'] != got['logs']):
            fail(f'11a: rank {r["mid"]["coords"]} holds other parameters '
                 f'after the step ({r["mid"]["differ"]})')
    held_to_one(f'11a (2, 2) x batch 1 against one process at batch '
                f'{HYB_BATCH}, midsize fp32, draws on, 1 step', ref['tc'],
                got, one_process_steps(ref['tc'], ref['train'],
                                       ref['batch'], HYB_BATCH, got, 1))
    print(f'  11a: after the step the ranks\' words that differ: '
          f'{square[0]["mid"]["differ"]}', flush=True)


def hybrid_fullsize(ref, square) -> dict:
    """11b: gates and prints the full-size ranks' rows; returns the
    launches of one rank's predict."""
    from fusionocc_tpu_torch.config import full_model_config
    cfg = full_model_config()
    expect = launches_per(cfg, cfg.num_frame, 1)
    train_expect = train_launches(cfg)
    for r in square:
        f = r['full']
        where = f'11b rank {f["coords"]}'
        if f['launches'] != expect:
            fail(f'{where}: launches per predict {f["launches"]}, expected '
                 f'{expect}')
        for i, row in enumerate(f['train']):
            if row['launches'] != train_expect:
                fail(f'{where} train step {i}: launches {row["launches"]}, '
                     f'expected {train_expect}')
            if not all(map(math.isfinite, row['logs'].values())):
                fail(f'{where} train step {i}: not finite: {row["logs"]}')
        d = f['coords'][0]
        agree = float((f['pred'] == ref['full_pred'][d:d + 1]).float()
                      .mean())
        timed = [row['ms'] for row in f['train'][HYB_WARMUP:]]
        print(f'  {where}: ms per two-pass predict (CUDA events) median '
              f'{statistics.median(f["ms"]):.1f}, all '
              f'{[round(x, 1) for x in f["ms"]]}; collectives per predict '
              f'{f["calls"]}, bytes {f["bytes"]}; ms inside them (card '
              f'synchronised around each, a predict of '
              f'{f["timed_wall_ms"]:.1f} ms wall) '
              f'{ {k: round(v, 1) for k, v in f["collective_ms"].items()} };'
              f' halo rows sent per predict {f["rows"]}; peak memory '
              f'{f["peak_above_gib"]:.2f} GiB above the {f["held_gib"]:.2f} '
              f'GiB held; launches per predict {f["launches"]}; argmax '
              f'agreement with one process (bf16, printed) {agree:.4f}; '
              f'train s/iter {statistics.median(timed) / 1e3:.4f} (median '
              f'of {HYB_TIMED} after {HYB_WARMUP}), losses '
              + ', '.join(f'{row["logs"]["loss"]:.4f}'
                          for row in f['train']), flush=True)
    layer_rows = square[0]['full']['layer_rows']
    print(f'  11b rank (0, 0) halo rows sent per layer in one predict: '
          f'{layer_rows}', flush=True)
    print(f'  11b one process, batch 1, the same weights: ms per two-pass '
          f'predict (CUDA events, median of {HYB_REPS}) {ref["one_ms"]:.1f}',
          flush=True)
    return square[0]['full']['launches']


def phase_hybrid() -> dict:
    """Phase 11: the hybrid data x spatial mesh, ranks spawned on the one
    card.  Returns one rank's launches per full-size predict."""
    import shutil
    import tempfile
    print('[11/12] hybrid data x spatial mesh: ranks on the one card over '
          'gloo (NCCL refuses two ranks on one device; gloo stages each '
          'collective through the host, so these times are no scaling '
          'figures)', flush=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='fusionocc_hybrid_')
    ref = hybrid_full_references(tmp, hybrid_mid_references(tmp))
    t1 = time.perf_counter()
    square = spawn_hybrid(2 * HYB_SPATIAL, ['mid', 'mid14', 'full'], tmp)
    t2 = time.perf_counter()
    row = spawn_hybrid(HYB_SPATIAL, ['mid'], tmp)
    t3 = time.perf_counter()
    hybrid_midsize(ref, square, row)
    launches = hybrid_fullsize(ref, square)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f'  phase 11: references {t1 - t0:.1f} s, (2, 2) and (1, 4) ranks '
          f'{t2 - t1:.1f} s, (1, 2) ranks {t3 - t2:.1f} s, checks '
          f'{time.perf_counter() - t3:.1f} s', flush=True)
    return launches


# -- phase 12: FLOPs per path and the density sweep ---------------------------
FLOP_REPS = 3                       # timed two-pass predicts


def report_flops(label, got) -> None:
    print(f'  {label}: {got["total"] / 1e9:.2f} GFLOP with the kernels, '
          f'{got["outside"] / 1e9:.2f} without them; kernels (GFLOP) '
          + ', '.join(f'{k} {v / 1e9:.4f}' for k, v in got['kernels'].items())
          + f'; by op (GFLOP) '
          + ', '.join(f'{k} {v / 1e9:.3f}' for k, v in got['by_op'].items()),
          flush=True)


def phase_flops(cfg, batches, measured) -> None:
    """Phase 12: the FLOPs of a two-pass predict, a streamed frame and a
    train step at full size (``utils/flops.count_flops``, the kernels by
    their formulas), each kernel's counted FLOPs at phase 3's shapes
    against those its bound used, the achieved TFLOP/s of the two-pass
    predict, and ``tools/density_sweep_torch.py``'s three densities."""
    from fusionocc_tpu_torch.config import TrainConfig
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, batch_pooling_indices, init_weights)
    from fusionocc_tpu_torch.utils.flops import count_flops
    from tools import density_sweep_torch as sweep
    print('[12/12] FLOPs per path (torch.utils.flop_counter, the kernels by '
          'their formulas) and the density sweep', flush=True)
    t0 = time.perf_counter()
    for name, m in measured.items():
        ok = m['flops'] == m['counted_flops']
        print(f'  {name} at phase 3\'s shapes: counted {m["counted_flops"]} '
              f'FLOPs, its bound used {m["flops"]}: '
              f'{"equal" if ok else "DIFFER"}', flush=True)
        if not ok:
            fail(f'{name}: counted FLOPs differ from its bound\'s')
    model = init_weights(FusionOcc(cfg, device=DEV),
                         torch.Generator().manual_seed(0))
    got = {mode: count_flops(model, batches[0], mode, TrainConfig(model=cfg))
           for mode in ('predict', 'streaming', 'train')}
    for mode, label in (('predict', 'two-pass predict'),
                        ('streaming', 'streamed frame (predict_streaming)'),
                        ('train', 'train step (forward, backward, '
                                  'optimizer)')):
        report_flops(label, got[mode])
    idx = batch_pooling_indices(cfg, batches[0])
    model.predict(batches[0], idx)
    ms = statistics.median(event_ms(lambda: model.predict(batches[0], idx),
                                    FLOP_REPS))
    rate = got['predict']['total'] / ms / 1e9
    print(f'  two-pass predict with its pooling indices built once (the main '
          f'path, as phase 5 runs it; the count above builds them in the '
          f'call): {ms:.2f} ms (CUDA events, median of {FLOP_REPS}), '
          f'{rate:.2f} TFLOP/s achieved, '
          f'{rate * 1e12 / PEAK_FLOPS[torch.bfloat16]:.4f} of the '
          f'{PEAK_FLOPS[torch.bfloat16] / 1e12:.0f} TFLOP/s bf16 peak',
          flush=True)
    del model, idx
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    for row in sweep.sweep(cfg, DEV, say=lambda line: print(
            f'  {line}', flush=True)):
        if row['ms'] is None:
            fail(f'density x{row["scale"]}: no encoder time on the card')
    t2 = time.perf_counter()
    print(f'  phase 12: FLOPs {t1 - t0:.1f} s, density sweep {t2 - t1:.1f} s',
          flush=True)


def main() -> None:
    start = time.perf_counter()
    card = phase_device()
    phase_build()
    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    cfg = full_model_config()
    t0 = time.perf_counter()
    batches = [synthetic_batch(cfg, 1, s, device=DEV) for s in SLICE_SEEDS]
    print(f'  synthetic batches (seeds {SLICE_SEEDS}) in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    measured, index, sweep, glue = phase_kernels(cfg, batches)
    phase_reference()
    launches = phase_slice(batches)
    phase_streaming(batches)
    train, bwd_ms = phase_training(batches)
    evaluated = phase_eval()
    dist_launches = phase_dist(batches)
    serving = phase_serving(batches)
    hybrid = phase_hybrid()
    phase_flops(cfg, batches, measured)
    sources = {
        'window_attn_fwd': ('fusionocc_tpu_torch/csrc/window_attn.cu',
                            'fusionocc_tpu/ops/pallas/window_attn.py:79'),
        'bev_pool_fwd': ('fusionocc_tpu_torch/csrc/bev_pool.cu',
                         'fusionocc_tpu/ops/pallas/segsum.py:31'),
        'zwin_conv_fwd': ('fusionocc_tpu_torch/csrc/zwin_conv.cu',
                          'fusionocc_tpu/ops/pallas/zwin_conv.py:145'),
        'zwin_conv_fwd_epi': ('fusionocc_tpu_torch/csrc/zwin_conv.cu',
                              'fusionocc_tpu/ops/pallas/zwin_conv.py:78'),
    }
    kernels = []
    for name, m in measured.items():
        if launches[name] == 0:
            fail(f'{name} was not launched by the main path')
        kernels.append({'name': name, 'route': 'cuda',
                        'source': sources[name][0],
                        'replaces': sources[name][1],
                        'launches': launches[name], **m,
                        'train_launches': train[name],
                        'backward_ms': bwd_ms.get(name),
                        'eval_launches': evaluated[name],
                        'dist_train_launches': dist_launches[name],
                        'int8_launches': serving['int8'][name],
                        'export_launches': serving['export'][name],
                        'export_streaming_launches':
                            serving['export_streaming'][name],
                        'lss_base_launches': serving['lss_base'][name],
                        'hybrid_launches': hybrid[name]})
    kernels.append({
        'name': 'index_*', 'route': 'cuda',
        'source': 'fusionocc_tpu_torch/csrc/sparse_index.cu',
        'replaces': 'none (XLA ops: fusionocc_tpu/ops/sparse_conv.py:392)',
        'launches': {k: launches[k] for k in INDEX_KERNELS},
        'ms_per_pass': {B: round(v['ms'], 4) for B, v in index.items()},
        'plain_ms_per_pass': {B: round(v['plain_ms'], 4)
                              for B, v in index.items()},
        'train_launches': {k: train[k] for k in INDEX_KERNELS},
        'eval_launches': {k: evaluated[k] for k in INDEX_KERNELS},
        'dist_train_launches': {k: dist_launches[k] for k in INDEX_KERNELS},
        'hybrid_launches': {k: hybrid[k] for k in INDEX_KERNELS}})
    kernels.append({
        'name': 'plane_sweep_fwd', 'route': 'cuda',
        'source': 'fusionocc_tpu_torch/csrc/plane_sweep.cu',
        'replaces': 'none (XLA ops: fusionocc_tpu/models/lss_base.py:131)',
        'launches': sweep['launches']['plane_sweep_fwd'],
        **{k: round(sweep[k], 4) for k in ('ms', 'plain_ms', 'bound_ms')},
        'mask_share': sweep['mask_share'],
        'max_abs_err': sweep['max_abs_err'],
        'main_path_launches': launches['plane_sweep_fwd'],
        'train_launches': train['plane_sweep_fwd'],
        'eval_launches': evaluated['plane_sweep_fwd'],
        'lss_base_launches': serving['lss_base']['plane_sweep_fwd'],
        'hybrid_launches': hybrid['plane_sweep_fwd']})
    for name in GLUE_KERNELS:
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'fusionocc_tpu_torch/csrc/swin_glue.cu',
            'replaces': 'none (XLA ops: fusionocc_tpu/nn/swin.py)',
            'launches': launches[name],
            **{k: round(v, 4) for k, v in glue[name].items()},
            'train_launches': train[name], 'eval_launches': evaluated[name],
            'dist_train_launches': dist_launches[name],
            'int8_launches': serving['int8'][name],
            'export_launches': serving['export'][name],
            'export_streaming_launches': serving['export_streaming'][name],
            'hybrid_launches': hybrid[name]})
    print(f'whole script: {time.perf_counter() - start:.1f} s', flush=True)
    print(f'card: {card}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
