"""Flax parameter trees -> the port's ``state_dict`` (reference key names).

The inverse of ``fusionocc_tpu/train/torch_import.py`` (``build_rules``):
Swin, FPN_LSS, CrossModalLSS, pre_process, the LiDAR encoder (when the
config uses it), the BEV encoder and the head; and, each as its own root,
the base view transformers of ``models/lss_base.py``
(``lss_base_rules``).  The trees come in as nested
dicts of numpy arrays, so nothing here imports JAX.  Each rule maps a flax
leaf path to its torch key and the layout change (flax kernels are
(..., in, out), torch's (out, in, ...), spconv2's (out, k, k, k, in)).
``num_batches_tracked`` and ``relative_position_index`` buffers, which flax
does not keep, are filled in.

``bevstereo_depth_net_names`` lists BEVDet's names of the stereo
``DepthNet`` of ``models/bevstereo_occ.py`` (no JAX model has one).

``convert_official_swin``, ``resize_bias_table`` and ``load_official_swin``
warm-start the image backbone from an official (Microsoft) Swin checkpoint,
as ``fusionocc_tpu/train/torch_import.py`` does for JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .nn.swin import relative_position_index


def conv2d(w):  # (kh, kw, I, O) -> (O, I, kh, kw)
    return np.transpose(w, (3, 2, 0, 1))


def conv3d(w):  # (kd, kh, kw, I, O) -> (O, I, kd, kh, kw)
    return np.transpose(w, (4, 3, 0, 1, 2))


def linear(w):  # (I, O) -> (O, I)
    return np.transpose(w, (1, 0))


def spconv3(w):  # (27, I, O) -> spconv2 (O, 3, 3, 3, I)
    return np.transpose(w, (2, 0, 1)).reshape(w.shape[2], 3, 3, 3, w.shape[1])


def spconv1(w):  # (I, O) -> spconv2 (O, 1, 1, 1, I)
    return np.transpose(w, (1, 0)).reshape(w.shape[1], 1, 1, 1, w.shape[0])


def ident(w):
    return np.asarray(w)


Rule = Tuple[str, Callable]     # (torch key, converter flax -> torch)
Rules = Dict[str, Dict[str, Rule]]


def _convbn(rules: Rules, fpath, tconv, tbn, nd):
    rules['params'][f'{fpath}/Conv_0/kernel'] = (
        f'{tconv}.weight', conv3d if nd == 3 else conv2d)
    _bn(rules, f'{fpath}/BatchNorm_0/BatchNorm_0', tbn)


def _bn(rules: Rules, fpath, tbn):
    rules['params'][f'{fpath}/scale'] = (f'{tbn}.weight', ident)
    rules['params'][f'{fpath}/bias'] = (f'{tbn}.bias', ident)
    rules['batch_stats'][f'{fpath}/mean'] = (f'{tbn}.running_mean', ident)
    rules['batch_stats'][f'{fpath}/var'] = (f'{tbn}.running_var', ident)


def _conv(rules: Rules, fpath, tkey, nd, bias=True):
    rules['params'][f'{fpath}/kernel'] = (f'{tkey}.weight',
                                          conv3d if nd == 3 else conv2d)
    if bias:
        rules['params'][f'{fpath}/bias'] = (f'{tkey}.bias', ident)


def _dense(rules: Rules, fpath, tkey, bias=True):
    rules['params'][f'{fpath}/kernel'] = (f'{tkey}.weight', linear)
    if bias:
        rules['params'][f'{fpath}/bias'] = (f'{tkey}.bias', ident)


def _ln(rules: Rules, fpath, tkey):
    rules['params'][f'{fpath}/scale'] = (f'{tkey}.weight', ident)
    rules['params'][f'{fpath}/bias'] = (f'{tkey}.bias', ident)


def _basicblock2d(rules: Rules, fpath, tpath):
    _convbn(rules, f'{fpath}/ConvBN_0', f'{tpath}.conv1', f'{tpath}.bn1', 2)
    _convbn(rules, f'{fpath}/ConvBN_1', f'{tpath}.conv2', f'{tpath}.bn2', 2)


def _resnet3d(rules: Rules, fpath, tpath, num_layer):
    k = 0
    for layer, n in enumerate(num_layer):
        for j in range(n):
            f, t = f'{fpath}/BasicBlock3D_{k}', f'{tpath}.layers.{layer}.{j}'
            names = (['downsample'] if j == 0 else []) + ['conv1', 'conv2']
            for i, name in enumerate(names):
                _convbn(rules, f'{f}/ConvBN_{i}', f'{t}.{name}.conv',
                        f'{t}.{name}.bn', 3)
            k += 1


def _lidar_encoder(rules: Rules, lc):
    """conv_input, the SubM and stride-2 convs with their BN1d, conv_out."""
    le = 'lidar_encoder'
    P = rules['params']
    P[f'{le}/conv_input_kernel'] = (f'{le}.conv_input.0.weight', spconv1)
    P[f'{le}/conv_out_kernel'] = (f'{le}.conv_out.0.weight', spconv1)
    last = len(lc.encoder_channels) - 1
    for i, blocks in enumerate(lc.encoder_channels):
        for j in range(len(blocks)):
            down = i < last and j == len(blocks) - 1
            f = f'{le}/stage{i}_down' if down else f'{le}/stage{i}_subm{j}'
            t = f'{le}.encoder_layers.encoder_layer{i + 1}.{j}'
            P[f'{f}/kernel'] = (f'{t}.0.weight', spconv3)
            _bn(rules, f'{f}/MaskedBatchNorm_0', f'{t}.1')


def _mlp(rules: Rules, fpath, tpath):
    _dense(rules, f'{fpath}/Dense_0', f'{tpath}.fc1')
    _dense(rules, f'{fpath}/Dense_1', f'{tpath}.fc2')


def _selayer(rules: Rules, fpath, tpath):
    _conv(rules, f'{fpath}/Conv_0', f'{tpath}.conv_reduce', 2)
    _conv(rules, f'{fpath}/Conv_1', f'{tpath}.conv_expand', 2)


def _aspp(rules: Rules, fpath, tpath):
    """Branches aspp1..aspp4, the global pool, the fused 1x1 (ConvBN_0..5)."""
    for i in range(4):
        _convbn(rules, f'{fpath}/ConvBN_{i}', f'{tpath}.aspp{i + 1}.atrous_conv',
                f'{tpath}.aspp{i + 1}.bn', 2)
    _convbn(rules, f'{fpath}/ConvBN_4', f'{tpath}.global_avg_pool.1',
            f'{tpath}.global_avg_pool.2', 2)
    _convbn(rules, f'{fpath}/ConvBN_5', f'{tpath}.conv1', f'{tpath}.bn1', 2)


def _depth_net(rules: Rules, fpath, tpath, stereo: bool):
    """``models/lss_base.DepthNet`` (with ASPP)."""
    _convbn(rules, f'{fpath}/reduce_conv', f'{tpath}.reduce_conv.0',
            f'{tpath}.reduce_conv.1', 2)
    _bn(rules, f'{fpath}/mlp_bn/BatchNorm_0', f'{tpath}.bn')
    for m in ('context', 'depth'):
        _mlp(rules, f'{fpath}/{m}_mlp', f'{tpath}.{m}_mlp')
        _selayer(rules, f'{fpath}/{m}_se', f'{tpath}.{m}_se')
    _conv(rules, f'{fpath}/context_conv', f'{tpath}.context_conv', 2)
    if stereo:
        for k in range(2):
            _convbn(rules, f'{fpath}/cost_volumn_{k}',
                    f'{tpath}.cost_volumn_net.{2 * k}',
                    f'{tpath}.cost_volumn_net.{2 * k + 1}', 2)
        _conv(rules, f'{fpath}/cv_downsample', f'{tpath}.cv_downsample', 2)
    for i in range(3):
        _basicblock2d(rules, f'{fpath}/block{i}', f'{tpath}.depth_conv.{i}')
    _aspp(rules, f'{fpath}/aspp', f'{tpath}.depth_conv.3')
    _conv(rules, f'{fpath}/depth_out', f'{tpath}.depth_conv.4', 2)


def lss_base_rules(kind: str, stereo: bool = False) -> Rules:
    """The rules of a base view transformer of ``models/lss_base.py`` as
    its own root: ``kind`` 'lss' (``LSSViewTransformer``) or 'bevdepth'
    (``LSSViewTransformerBEVDepth``, ``stereo`` as built)."""
    rules: Rules = {'params': {}, 'batch_stats': {}}
    if kind == 'lss':
        _conv(rules, 'depth_net', 'depth_net', 2)
    elif kind == 'bevdepth':
        _depth_net(rules, 'depth_net', 'depth_net', stereo)
    else:
        raise ValueError(f'kind {kind!r}: lss or bevdepth')
    return rules


def bevstereo_depth_net_names() -> List[str]:
    """BEVDet's ``state_dict`` names of its stereo ``DepthNet``
    (``use_dcn=False``, ``use_aspp=True``; BEVDet dev2.1
    ``necks/view_transformer.py``), in its order: what a BEVStereo4D-Occ
    checkpoint holds under ``img_view_transformer.depth_net.``.  Every
    other module of that model is named as FusionOcc's."""
    stats = ('weight', 'bias', 'running_mean', 'running_var',
             'num_batches_tracked')

    def conv(p, bias=True):
        return [f'{p}.weight'] + ([f'{p}.bias'] if bias else [])

    def bn(p):
        return [f'{p}.{k}' for k in stats]

    def block(p, downsample=False):     # mmdet BasicBlock
        return (conv(f'{p}.conv1', False) + bn(f'{p}.bn1')
                + conv(f'{p}.conv2', False) + bn(f'{p}.bn2')
                + (conv(f'{p}.downsample') if downsample else []))
    names = conv('reduce_conv.0') + bn('reduce_conv.1') + conv(
        'context_conv') + bn('bn')
    for m in ('depth', 'context'):
        names += (conv(f'{m}_mlp.fc1') + conv(f'{m}_mlp.fc2')
                  + conv(f'{m}_se.conv_reduce') + conv(f'{m}_se.conv_expand'))
    names += (conv('cost_volumn_net.0') + bn('cost_volumn_net.1')
              + conv('cost_volumn_net.2') + bn('cost_volumn_net.3'))
    names += (block('depth_conv.0', downsample=True) + block('depth_conv.1')
              + block('depth_conv.2'))
    for i in range(1, 5):
        names += (conv(f'depth_conv.3.aspp{i}.atrous_conv', False)
                  + bn(f'depth_conv.3.aspp{i}.bn'))
    names += (conv('depth_conv.3.global_avg_pool.1', False)
              + bn('depth_conv.3.global_avg_pool.2')
              + conv('depth_conv.3.conv1', False) + bn('depth_conv.3.bn1')
              + conv('depth_conv.4'))
    return names


def slice_rules(cfg: ModelConfig) -> Rules:
    """flax leaf path -> (torch key, converter), per collection."""
    rules: Rules = {'params': {}, 'batch_stats': {}}
    P = rules['params']

    bb = 'img_backbone'
    _conv(rules, f'{bb}/patch_embed', f'{bb}.patch_embed.projection', 2)
    _ln(rules, f'{bb}/patch_norm', f'{bb}.patch_embed.norm')
    for i, depth in enumerate(cfg.swin.depths):
        for j in range(depth):
            f, t = f'{bb}/stage{i}_block{j}', f'{bb}.stages.{i}.blocks.{j}'
            _ln(rules, f'{f}/norm1', f'{t}.norm1')
            _ln(rules, f'{f}/norm2', f'{t}.norm2')
            P[f'{f}/attn/relative_position_bias_table'] = (
                f'{t}.attn.w_msa.relative_position_bias_table', ident)
            _dense(rules, f'{f}/attn/qkv', f'{t}.attn.w_msa.qkv')
            _dense(rules, f'{f}/attn/proj', f'{t}.attn.w_msa.proj')
            _dense(rules, f'{f}/ffn_fc1', f'{t}.ffn.layers.0.0')
            _dense(rules, f'{f}/ffn_fc2', f'{t}.ffn.layers.1')
        if i < len(cfg.swin.depths) - 1:
            _ln(rules, f'{bb}/downsample{i}/norm',
                f'{bb}.stages.{i}.downsample.norm')
            P[f'{bb}/downsample{i}/reduction/kernel'] = (
                f'{bb}.stages.{i}.downsample.reduction.weight', linear)
    for i in cfg.swin.out_indices:
        _ln(rules, f'{bb}/out_norm{i}', f'{bb}.norm{i}')

    _convbn(rules, 'img_neck/ConvBN_0', 'img_neck.conv.0', 'img_neck.conv.1', 2)
    _convbn(rules, 'img_neck/ConvBN_1', 'img_neck.conv.3', 'img_neck.conv.4', 2)

    vt = 'img_view_transformer'
    _convbn(rules, f'{vt}/img_reduce_conv', f'{vt}.img_reduce_conv.0',
            f'{vt}.img_reduce_conv.1', 2)
    _convbn(rules, f'{vt}/depth_encoder0', f'{vt}.depth_encoder.0',
            f'{vt}.depth_encoder.1', 2)
    _convbn(rules, f'{vt}/depth_encoder1', f'{vt}.depth_encoder.3',
            f'{vt}.depth_encoder.4', 2)
    cmf, tcmf = f'{vt}/cross_modal_fusion', f'{vt}.cross_model_fusion'
    _dense(rules, f'{cmf}/channel_mlp_c', f'{tcmf}.channel_mlp_c.0')
    _dense(rules, f'{cmf}/channel_mlp_d', f'{tcmf}.channel_mlp_d.0')
    for s in ('spatial_c', 'spatial_d'):
        _conv(rules, f'{cmf}/{s}_0', f'{tcmf}.{s}.0', 2)
        _conv(rules, f'{cmf}/{s}_1', f'{tcmf}.{s}.2', 2)
    _convbn(rules, f'{cmf}/fuse_conv', f'{tcmf}.fuse_conv.0',
            f'{tcmf}.fuse_conv.1', 2)
    _basicblock2d(rules, f'{vt}/further_fuse', f'{vt}.further_fuse')

    dsn, tdsn = f'{vt}/depth_seg_net', f'{vt}.depth_seg_net'
    for r in ('reduce_conv_depth', 'reduce_conv_seg', 'reduce_conv_context'):
        _convbn(rules, f'{dsn}/{r}', f'{tdsn}.{r}.0', f'{tdsn}.{r}.1', 2)
    _bn(rules, f'{dsn}/mlp_bn/BatchNorm_0', f'{tdsn}.bn')
    for m in ('depth', 'context', 'seg'):
        _mlp(rules, f'{dsn}/{m}_mlp', f'{tdsn}.{m}_mlp')
        _selayer(rules, f'{dsn}/{m}_se', f'{tdsn}.{m}_se')
    _basicblock2d(rules, f'{dsn}/depth_block0', f'{tdsn}.depth_conv.0')
    _basicblock2d(rules, f'{dsn}/depth_block1', f'{tdsn}.depth_conv.1')
    _aspp(rules, f'{dsn}/aspp', f'{tdsn}.depth_conv.2')
    _conv(rules, f'{dsn}/depth_out', f'{tdsn}.depth_conv.3', 2)
    _conv(rules, f'{dsn}/context_conv', f'{tdsn}.context_conv', 2)
    _conv(rules, f'{dsn}/seg_conv0/Conv_0', f'{tdsn}.seg_conv.0', 2)
    _basicblock2d(rules, f'{dsn}/seg_conv1', f'{tdsn}.seg_conv.1')
    _conv(rules, f'{dsn}/seg_out', f'{tdsn}.seg_out', 2)

    _resnet3d(rules, 'pre_process_net', 'pre_process_net', (1,))
    if cfg.use_lidar:
        _lidar_encoder(rules, cfg.lidar)
    _resnet3d(rules, 'bev_backbone', 'img_bev_encoder_backbone',
              cfg.bev_num_layer)
    _convbn(rules, 'bev_neck/ConvBN_0', 'img_bev_encoder_neck.conv.conv',
            'img_bev_encoder_neck.conv.bn', 3)

    _conv(rules, 'final_conv', 'final_conv.conv', 3)
    _dense(rules, 'predicter_fc1', 'predicter.0')
    _dense(rules, 'predicter_fc2', 'predicter.2')
    return rules


def flatten_tree(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Nested mapping -> {'a/b/c': leaf}."""
    if hasattr(tree, 'items'):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, prefix + (k,)))
        return out
    return {'/'.join(prefix): tree}


def state_dict_from_flax(params: Any, batch_stats: Any, cfg: ModelConfig
                         ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for flax ``params`` / ``batch_stats``.

    Raises KeyError for a flax leaf no rule covers.
    """
    sd = state_dict_from_rules(params, batch_stats, slice_rules(cfg))
    rpi = relative_position_index(cfg.swin.window_size)
    for key in list(sd):
        if key.endswith('.relative_position_bias_table'):
            sd[key[:-len('relative_position_bias_table')]
               + 'relative_position_index'] = rpi.clone()
    return sd


def state_dict_from_rules(params: Any, batch_stats: Any, rules: Rules
                          ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` that ``rules`` make of flax ``params`` /
    ``batch_stats``, with each BatchNorm's ``num_batches_tracked``.

    Raises KeyError for a flax leaf no rule covers.
    """
    sd: Dict[str, torch.Tensor] = {}
    for kind, tree in (('params', params), ('batch_stats', batch_stats)):
        for path, leaf in flatten_tree(tree).items():
            if path not in rules[kind]:
                raise KeyError(f'no rule for flax {kind} leaf {path!r}')
            tkey, conv = rules[kind][path]
            sd[tkey] = torch.tensor(conv(np.asarray(leaf, np.float32)))
    for key in list(sd):
        if key.endswith('.running_mean'):
            sd[key[:-len('running_mean')] + 'num_batches_tracked'] = (
                torch.tensor(0, dtype=torch.long))
    return sd


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, of |x| (in x's dtype)."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(x.dtype)


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 resampling weights of ``jax.image.resize(...,
    'cubic')``, with its float32 operation order: sample points on
    half-pixel centres, the kernel widened by the scale when shrinking
    (antialias), each column normalised over the input samples, and
    columns whose sample lies outside the input zero."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale)
              - f32(0.0)) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(n_in) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bias_table(table: np.ndarray, target_len: int) -> np.ndarray:
    """Resize a ((2w-1)^2, heads) relative-position bias table to
    ``target_len`` rows (another window size), as JAX's importer does with
    ``jax.image.resize(..., 'cubic')``: Keys' cubic with a = -0.5 on
    half-pixel centres, separable over the two table axes; JAX's float32
    weights, summed in float64.
    ``F.interpolate(mode='bicubic')`` takes a = -0.75 and differs."""
    table = np.asarray(table)
    L1, nH = table.shape
    s1 = int(round(L1 ** 0.5))
    s2 = int(round(target_len ** 0.5))
    if s1 == s2:
        return table
    w = _cubic_weights(s1, s2).astype(np.float64)
    t = table.reshape(s1, s1, nH).astype(np.float64)
    out = np.einsum('ijh,ia,jb->abh', t, w, w)
    return out.reshape(s2 * s2, nH).astype(np.float32)


def convert_official_swin(state_dict: Dict[str, np.ndarray],
                          prefix: str = 'img_backbone.'
                          ) -> Dict[str, np.ndarray]:
    """Official (Microsoft) Swin checkpoint keys -> the mmcv keys the port's
    backbone carries: layers -> stages, attn. -> attn.w_msa., mlp.fc1/fc2
    -> ffn.layers.0.0/1, patch_embed.proj -> projection, the classification
    head dropped, and PatchMerging's reduction and norm weights reordered
    from the official concat order [x00, x10, x01, x11] to mmcv unfold's
    interleaved c*4+p (the reference's swin_convert)."""
    def reduction_order(x):
        o, i = x.shape
        return x.reshape(o, 4, i // 4)[:, (0, 2, 1, 3)].transpose(
            0, 2, 1).reshape(o, i)

    def norm_order(x):
        i = x.shape[0]
        return x.reshape(4, i // 4)[(0, 2, 1, 3), :].T.reshape(i)

    out: Dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        v = np.asarray(v)
        if k.startswith('head'):
            continue
        if k.startswith('layers'):
            if 'attn.' in k:
                k = k.replace('attn.', 'attn.w_msa.')
            elif 'mlp.fc1.' in k:
                k = k.replace('mlp.fc1.', 'ffn.layers.0.0.')
            elif 'mlp.fc2.' in k:
                k = k.replace('mlp.fc2.', 'ffn.layers.1.')
            elif 'mlp.' in k:
                k = k.replace('mlp.', 'ffn.')
            elif 'downsample' in k:
                if 'reduction.' in k:
                    v = reduction_order(v)
                elif 'norm.' in k:
                    v = norm_order(v)
            k = k.replace('layers', 'stages', 1)
        elif k.startswith('patch_embed') and 'proj' in k:
            k = k.replace('proj', 'projection')
        out[prefix + k] = v
    return out


@torch.no_grad()
def load_official_swin(model: torch.nn.Module,
                       state_dict: Dict[str, np.ndarray]) -> Dict[str, list]:
    """Copy an official Swin checkpoint into ``model.img_backbone``:
    ``convert_official_swin``, then each tensor of the backbone whose key
    the checkpoint has, the bias tables resized to the model's window
    (``resize_bias_table``); ``relative_position_index`` is the model's
    own.  Returns the report: ``loaded``, ``missing`` (backbone tensors the
    checkpoint lacks), ``unused`` (checkpoint keys the backbone lacks) and
    ``shape_mismatch``; raises ValueError on a mismatch."""
    sd = convert_official_swin(state_dict)
    own = {k: v for k, v in model.state_dict().items()
           if k.startswith('img_backbone.')
           and not k.endswith('relative_position_index')}
    report: Dict[str, list] = {'loaded': [], 'missing': [], 'unused': [],
                               'shape_mismatch': []}
    for key, dst in own.items():
        if key not in sd:
            report['missing'].append(key)
            continue
        val = np.asarray(sd[key], np.float32)
        if (key.endswith('relative_position_bias_table')
                and val.shape != tuple(dst.shape)
                and val.shape[1] == dst.shape[1]):
            val = resize_bias_table(val, dst.shape[0])
        if val.shape != tuple(dst.shape):
            report['shape_mismatch'].append(
                f'{key}: checkpoint {val.shape} vs model {tuple(dst.shape)}')
            continue
        dst.copy_(torch.from_numpy(val))
        report['loaded'].append(key)
    report['unused'] = sorted(
        k for k in sd if k not in own
        and not k.endswith(('relative_position_index', 'attn_mask')))
    if report['shape_mismatch']:
        raise ValueError(f'official Swin import: {report["shape_mismatch"]}')
    return report
