"""
Model construction from a config (the JAX package's models/factory.py
setup_model, for the families this port has: the depth net, the pose net,
the supervised and photometric losses and the model's loss fields) and
seeded random weights.
"""

import math

import torch

from packnet_sfm_tpu_torch.losses.dual_head import DualHeadDepthLoss
from packnet_sfm_tpu_torch.losses.generic_photometric import (
    GenericMultiViewPhotometricLoss)
from packnet_sfm_tpu_torch.losses.photometric import MultiViewPhotometricLoss
from packnet_sfm_tpu_torch.losses.supervised import SupervisedLoss
from packnet_sfm_tpu_torch.models.generic import (
    GenericSfmModel, GenericSelfSupModel)
from packnet_sfm_tpu_torch.models.sfm import (
    SfmModel, SelfSupModel, SemiSupModel, SemiSupCompletionModel,
    VelSupModel)
from packnet_sfm_tpu_torch.networks.depth.depth_resnet import DepthResNet
from packnet_sfm_tpu_torch.networks.depth.packnet import (
    PackNet01, PackNetSAN01, PackNetSlim01, PackNetSlimSAN01,
    _PackNetSANBase)
from packnet_sfm_tpu_torch.networks.depth.ray_surface_resnet import (
    RaySurfaceResNet)
from packnet_sfm_tpu_torch.networks.depth.resnet_san import ResNetSAN01
from packnet_sfm_tpu_torch.networks.layers.packnet import Conv3DStack
from packnet_sfm_tpu_torch.networks.layers.resnet import (
    Conv, BatchNorm, GroupNorm)
from packnet_sfm_tpu_torch.networks.layers.san import (
    _MaskedConv, MaskedBatchNorm)
from packnet_sfm_tpu_torch.networks.pose.pose_net import PoseNet, PoseResNet

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def compute_dtype(config):
    """The conv compute dtype from `tpu.compute_dtype` (float32 default)."""
    return DTYPES.get(config.get('tpu', {}).get('compute_dtype', 'float32'),
                      torch.float32)


# the config keys the JAX package's _net_kwargs forwards to each network
# (its dataclass fields; min/max_depth and dtype aside)
DEPTH_NET_KEYS = {
    'ResNetSAN01': ('version', 'use_film', 'film_scales', 'use_dual_head',
                    'san_row_window'),
    'PackNet01': ('version', 'dropout'),
    'PackNetSlim01': ('version', 'dropout'),
    'PackNetSAN01': ('version', 'dropout', 'ni', 'channels', 'num_3d_feat',
                     'use_film', 'film_scales', 'san_row_window'),
}
DEPTH_NET_KEYS['PackNetSlimSAN01'] = DEPTH_NET_KEYS['PackNetSAN01']
DEPTH_NETS = {'ResNetSAN01': ResNetSAN01, 'PackNet01': PackNet01,
              'PackNetSlim01': PackNetSlim01, 'PackNetSAN01': PackNetSAN01,
              'PackNetSlimSAN01': PackNetSlimSAN01}


def setup_depth_net(config, dtype=torch.float32):
    """Build cfg.model.depth_net (ResNetSAN01, the PackNet family,
    DepthResNet or RaySurfaceResNet in this port). A key the config leaves
    None or '' falls through to the class default."""
    if config.name == 'RaySurfaceResNet':
        return RaySurfaceResNet(version=config.get('version') or '18pt',
                                dtype=dtype)
    if config.name == 'DepthResNet':
        return DepthResNet(version=config.get('version') or '18pt',
                           dtype=dtype)
    if config.name not in DEPTH_NETS:
        raise NotImplementedError(
            'depth_net {!r} is not ported yet'.format(config.name))
    kwargs = {}
    for key in DEPTH_NET_KEYS[config.name]:
        v = config.get(key, None)
        if v is not None and v != '':
            kwargs[key] = tuple(v) if isinstance(v, list) else v
    return DEPTH_NETS[config.name](dtype=dtype, **kwargs)


def setup_pose_net(config, dtype=torch.float32):
    """Build cfg.model.pose_net: PoseNet (its default two contexts) or
    PoseResNet."""
    if config.name == 'PoseResNet':
        return PoseResNet(version=config.get('version') or '18pt',
                          dtype=dtype)
    if config.name != 'PoseNet':
        raise NotImplementedError(
            'pose_net {!r} is not ported yet'.format(config.name))
    return PoseNet(dtype=dtype)


def setup_photometric_loss(config):
    """MultiViewPhotometricLoss from cfg.model.loss, cfg.model.params and
    cfg.tpu (use_pallas, photometric_dtype)."""
    loss_cfg, params_cfg = config.model.loss, config.model.params
    tpu = config.get('tpu', {})
    return MultiViewPhotometricLoss(
        num_scales=loss_cfg.num_scales,
        ssim_loss_weight=loss_cfg.ssim_loss_weight,
        smooth_loss_weight=loss_cfg.smooth_loss_weight,
        C1=loss_cfg.C1, C2=loss_cfg.C2,
        photometric_reduce_op=loss_cfg.photometric_reduce_op,
        clip_loss=loss_cfg.clip_loss,
        progressive_scaling=loss_cfg.get('progressive_scaling', 0.0),
        padding_mode=loss_cfg.padding_mode,
        automask_loss=loss_cfg.automask_loss,
        min_depth=params_cfg.min_depth or 0.05,
        max_depth=params_cfg.max_depth or 80.0,
        use_pallas=bool(tpu.get('use_pallas', False)),
        photometric_dtype=str(tpu.get('photometric_dtype', 'float32')))


def setup_supervised_loss(loss_cfg, params_cfg):
    """SupervisedLoss from cfg.model.loss / cfg.model.params."""
    return SupervisedLoss(
        supervised_method=loss_cfg.supervised_method,
        supervised_num_scales=loss_cfg.supervised_num_scales,
        progressive_scaling=loss_cfg.get('progressive_scaling', 0.0),
        loss_kwargs=(
            ('min_depth', params_cfg.min_depth),
            ('max_depth', params_cfg.max_depth),
            ('ssi_weight', loss_cfg.ssi_weight),
            ('silog_weight', loss_cfg.silog_weight),
            ('alpha', loss_cfg.alpha),
            ('silog_ratio2', loss_cfg.silog_ratio2),
            ('gradient_weight', loss_cfg.gradient_weight),
            ('gradient_scales', loss_cfg.gradient_scales),
        ))


def setup_model(config):
    """Build the model from cfg.model (float32 parameters on the CPU; move
    it with .to(device), pick the branch with .train() / .eval())."""
    model_cfg = config.model
    loss_cfg, params_cfg = model_cfg.loss, model_cfg.params
    dtype = compute_dtype(config)
    depth_net = setup_depth_net(model_cfg.depth_net, dtype)
    pose_net = None
    if model_cfg.pose_net.name:
        pose_net = setup_pose_net(model_cfg.pose_net, dtype)
    common = dict(pose_net=pose_net, rotation_mode=loss_cfg.rotation_mode,
                  flip_lr_prob=loss_cfg.get('flip_lr_prob', 0.0),
                  upsample_depth_maps=loss_cfg.upsample_depth_maps)
    name = model_cfg.name
    if name == 'SfmModel':
        return SfmModel(depth_net, **common)
    if name == 'SelfSupModel':
        return SelfSupModel(depth_net, setup_photometric_loss(config),
                            **common)
    if name == 'SemiSupModel':
        return SemiSupModel(
            depth_net, photometric_loss=setup_photometric_loss(config),
            supervised_loss=setup_supervised_loss(loss_cfg, params_cfg),
            supervised_loss_weight=loss_cfg.supervised_loss_weight,
            **common)
    if name == 'SemiSupCompletionModel':
        min_d = params_cfg.min_depth or 0.5
        max_d = params_cfg.max_depth or 80.0
        if max_d <= min_d:
            max_d = min_d + 1.0
        return SemiSupCompletionModel(
            depth_net,
            supervised_loss=setup_supervised_loss(loss_cfg, params_cfg),
            supervised_loss_weight=loss_cfg.supervised_loss_weight,
            weight_rgbd=loss_cfg.get('weight_rgbd', 1.0),
            consistency_loss_weight=loss_cfg.consistency_loss_weight,
            min_depth=min_d, max_depth=max_d,
            use_log_space=params_cfg.use_log_space,
            qat_outputs='outputs' in str(params_cfg.get('qat', '')),
            dual_head_loss=DualHeadDepthLoss(
                max_depth=max_d, min_depth=min_d,
                integer_weight=loss_cfg.get('integer_weight', 1.0),
                fractional_weight=loss_cfg.get('fractional_weight', 10.0),
                consistency_weight=loss_cfg.get('dual_consistency_weight',
                                                0.5)),
            photometric_loss=setup_photometric_loss(config),
            **common)
    if name == 'VelSupModel':
        return VelSupModel(
            depth_net, setup_photometric_loss(config),
            velocity_loss_weight=loss_cfg.velocity_loss_weight, **common)
    if name == 'GenericSelfSupModel':
        # the fields the JAX factory passes: no depth range, no map dtype
        generic = GenericMultiViewPhotometricLoss(
            num_scales=1,
            ssim_loss_weight=loss_cfg.ssim_loss_weight,
            smooth_loss_weight=loss_cfg.smooth_loss_weight,
            C1=loss_cfg.C1, C2=loss_cfg.C2,
            photometric_reduce_op=loss_cfg.photometric_reduce_op,
            clip_loss=loss_cfg.clip_loss,
            padding_mode=loss_cfg.padding_mode,
            automask_loss=loss_cfg.automask_loss,
            full_res_projection=loss_cfg.get('generic_full_res', False))
        return GenericSelfSupModel(depth_net,
                                   generic_photometric_loss=generic, **common)
    if name == 'GenericSfmModel':
        return GenericSfmModel(depth_net, **common)
    raise NotImplementedError('model {!r} is not ported yet'.format(name))


def _xavier_(t, fan_in, fan_out, gen):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=gen)


@torch.no_grad()
def init_weights(model, generator):
    """Random weights drawn from `generator`, with the flax initialisers'
    distributions: kaiming fan-out normal for encoder convs, lecun fan-in
    truncated normal for the pose decoder's, glorot uniform for the others
    (PoseNet's and PackNet's too), the masked convs and PackNet's 3D conv
    (`win2d_kernel` [3, 3, 3, d]: fan-in 27, fan-out 9d), zero biases,
    identity BN (running mean 0, var 1) and GroupNorm, and the SAN fusion
    gates at their initial values (ResNetSAN01 0.5; PackNet-SAN 1.0 plain,
    0.5 FiLM) with zero biases. The draws are not those of the JAX
    package's keys."""
    for mod in model.modules():
        if isinstance(mod, Conv):
            o, i, kh, kw = mod.weight.shape
            if mod.init == 'kaiming':
                std = math.sqrt(2.0 / (o * kh * kw))
                mod.weight.normal_(0.0, std, generator=generator)
            elif mod.init == 'lecun':
                # flax's truncated normal at +-2 std, rescaled to unit
                # variance
                std = math.sqrt(1.0 / (i * kh * kw)) / .87962566103423978
                torch.nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                            2 * std, generator=generator)
            else:
                _xavier_(mod.weight, i * kh * kw, o * kh * kw, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, _MaskedConv):
            kh, kw, i, o = mod.kernel.shape
            _xavier_(mod.kernel, i * kh * kw, o * kh * kw, generator)
            mod.bias.zero_()
        elif isinstance(mod, (BatchNorm, GroupNorm)):
            mod.reset_parameters()
        elif isinstance(mod, MaskedBatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)
        elif isinstance(mod, Conv3DStack):
            _xavier_(mod.win2d_kernel, 27, 9 * mod.d, generator)
            mod.win2d_bias.zero_()
        elif isinstance(mod, ResNetSAN01):
            mod.weight.fill_(0.5)
            mod.bias.zero_()
        elif isinstance(mod, _PackNetSANBase):
            mod.weight.fill_(mod.gate_init)
            mod.bias.zero_()
    return model
