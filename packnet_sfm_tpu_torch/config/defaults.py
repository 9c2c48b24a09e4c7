"""
Default configuration tree (a copy of the JAX package's config/defaults.py,
so both packages parse the same YAML files into the same tree).

Key-compatible with the reference's yacs defaults (reference:
configs/default_config.py:7-294) so the reference's YAML configs parse
unchanged, plus a `tpu` section that the PyTorch port reads only for
`compute_dtype` (the conv compute dtype, 'float32' or 'bfloat16').
"""

from packnet_sfm_tpu_torch.config.cfg_node import CfgNode as CN


def get_cfg_defaults():
    cfg = CN()
    cfg.name = ''
    cfg.debug = False

    # ------------------------------------------------------------------ model
    cfg.model = CN()
    cfg.model.name = ''
    cfg.model.checkpoint_path = ''

    cfg.model.loss = CN()
    cfg.model.loss.rotation_mode = 'euler'
    cfg.model.loss.upsample_depth_maps = True
    cfg.model.loss.ssim_loss_weight = 0.85
    cfg.model.loss.occ_reg_weight = 0.1
    cfg.model.loss.smooth_loss_weight = 0.001
    cfg.model.loss.C1 = 1e-4
    cfg.model.loss.C2 = 9e-4
    cfg.model.loss.photometric_reduce_op = 'min'
    cfg.model.loss.disp_norm = True
    cfg.model.loss.clip_loss = 0.0
    cfg.model.loss.padding_mode = 'zeros'
    cfg.model.loss.automask_loss = True
    cfg.model.loss.progressive_scaling = 0.0
    # TPU-native addition: full-resolution generic (ray-surface) softmax
    # projection — the reference pins it to half-res for memory
    # (reference: geometry/camera_generic.py:159-208); the Pallas
    # projection kernel lifts that constraint.
    cfg.model.loss.generic_full_res = False
    cfg.model.loss.velocity_loss_weight = 0.1
    cfg.model.loss.supervised_method = 'sparse-l1'
    cfg.model.loss.supervised_num_scales = 4
    cfg.model.loss.supervised_loss_weight = 0.9
    cfg.model.loss.consistency_loss_weight = 0.1
    # scale-adaptive loss defaults (reference: default_config.py:43-48)
    cfg.model.loss.lambda_sg = 0.5
    cfg.model.loss.num_scales = 4
    cfg.model.loss.use_absolute = True
    cfg.model.loss.use_inv_depth = False
    cfg.model.loss.epsilon = 1e-8
    # SSI-Silog family (reference: default_config.py:50-57)
    cfg.model.loss.ssi_weight = 0.7
    cfg.model.loss.silog_weight = 0.3
    cfg.model.loss.alpha_ssi = 0.85
    cfg.model.loss.beta_silog = 0.15
    cfg.model.loss.min_depth = 0.05
    cfg.model.loss.max_depth = 100.0
    cfg.model.loss.gradient_weight = 0.0
    cfg.model.loss.gradient_scales = 4
    cfg.model.loss.w_structure = 0.4
    cfg.model.loss.w_scale = 0.6
    cfg.model.loss.alpha = 0.85
    cfg.model.loss.silog_ratio = 10
    cfg.model.loss.silog_ratio2 = 0.85
    cfg.model.loss.enable_near_field_weighting = False
    cfg.model.loss.enable_road_weighting = False
    cfg.model.loss.near_field_threshold = 1.0
    cfg.model.loss.road_weight = 5.0
    cfg.model.loss.road_nearfield_weight = 10.0
    cfg.model.loss.nonroad_nearfield_weight = 3.0
    # dual-head loss weights (reference: losses/dual_head_depth_loss.py:46-66)
    cfg.model.loss.integer_weight = 1.0
    cfg.model.loss.fractional_weight = 10.0
    cfg.model.loss.dual_consistency_weight = 0.5

    cfg.model.depth_net = CN()
    cfg.model.depth_net.name = ''
    cfg.model.depth_net.checkpoint_path = ''
    cfg.model.depth_net.version = ''
    cfg.model.depth_net.dropout = 0.0
    cfg.model.depth_net.force_output_shape = ()
    cfg.model.depth_net.use_film = False
    cfg.model.depth_net.film_scales = [0]
    cfg.model.depth_net.use_enhanced_lidar = False
    # > 0: crop the SAN LiDAR branch to an active-row window of this
    # fraction of the image height (TPU optimization for row-structured
    # LiDAR; exact when the band fits — see layers/san.py). 0 = off.
    cfg.model.depth_net.san_row_window = 0.0
    cfg.model.depth_net.use_dual_head = False
    cfg.model.depth_net.use_encoder_rezero = False
    cfg.model.depth_net.variant = 's'
    cfg.model.depth_net.use_neck_features = False
    cfg.model.depth_net.use_imagenet_pretrained = False
    cfg.model.depth_net.use_depth_neck = False
    # TPU additions: 'pt' versions FAIL unless weights are found (fail-loud,
    # the reference's accuracy depends on pretrained encoders); opt out with
    # allow_random_init or point weights_path at a state_dict file.
    cfg.model.depth_net.allow_random_init = False
    cfg.model.depth_net.weights_path = ''

    cfg.model.pose_net = CN()
    cfg.model.pose_net.name = ''
    cfg.model.pose_net.checkpoint_path = ''
    cfg.model.pose_net.version = ''
    cfg.model.pose_net.dropout = 0.0
    cfg.model.pose_net.allow_random_init = False
    cfg.model.pose_net.weights_path = ''

    cfg.model.optimizer = CN()
    cfg.model.optimizer.name = 'Adam'
    cfg.model.optimizer.depth = CN()
    cfg.model.optimizer.depth.lr = 0.0002
    cfg.model.optimizer.depth.weight_decay = 0.0
    cfg.model.optimizer.pose = CN()
    cfg.model.optimizer.pose.lr = 0.0002
    cfg.model.optimizer.pose.weight_decay = 0.0
    # TPU-native addition: average grads over k micro-batches, apply once
    # (optax.MultiSteps) — effective batch k*batch_size beyond HBM limits
    cfg.model.optimizer.grad_accumulation_steps = 1
    # TPU-native addition: parameter EMA (0 = off); eval/checkpointing use
    # the averaged params when ema_eval is true
    cfg.model.optimizer.ema_decay = 0.0
    cfg.model.optimizer.ema_eval = True

    cfg.model.scheduler = CN()
    cfg.model.scheduler.name = 'StepLR'
    cfg.model.scheduler.step_size = 10
    cfg.model.scheduler.gamma = 0.5
    cfg.model.scheduler.T_max = 20
    # TPU-native addition: linear LR warmup over the first N epochs
    # (fractional values work: 0.5 = half an epoch)
    cfg.model.scheduler.warmup_epochs = 0.0

    cfg.model.params = CN()
    cfg.model.params.crop = 'garg'
    cfg.model.params.min_depth = 0.0
    cfg.model.params.max_depth = 100.0
    cfg.model.params.scale_output = 'resize'
    cfg.model.params.use_log_space = False
    cfg.model.params.flip_tta = False  # flipped test-time augmentation at eval
    # TPU addition: fake-quantize sigmoid outputs to uint8 at eval — the
    # measured INT8/NPU output-quantization cost (ops/quantization.py)
    cfg.model.params.int8_outputs = False
    # TPU addition: eval with per-channel int8 fake-quantized depth-net conv
    # kernels (weight PTQ on a float checkpoint; QAT validation after qat)
    cfg.model.params.int8_weights = False
    # TPU addition: quantization-aware training — '' (off), 'outputs',
    # 'weights', or 'weights+outputs'. Straight-through fake-quant of the
    # head sigmoids / depth-net conv kernels inside the train step, so the
    # network learns weights robust to the NPU's INT8 grid
    # (ops/quantization.py; the reference only validates INT8 post-hoc)
    cfg.model.params.qat = ''

    # ------------------------------------------------------------------- arch
    cfg.arch = CN()
    cfg.arch.seed = 42
    cfg.arch.min_epochs = 1
    cfg.arch.max_epochs = 50
    cfg.arch.validate_first = False
    cfg.arch.eval_during_training = True
    cfg.arch.eval_progress_interval = 0.1
    cfg.arch.eval_subset_size = 25
    cfg.arch.clip_grad = 10.0   # applied by the TPU trainer (dead flag upstream)
    cfg.arch.dtype = ''         # '', 'bfloat16', 'float32' — compute dtype

    # --------------------------------------------------------------- datasets
    cfg.datasets = CN()
    cfg.datasets.augmentation = CN()
    cfg.datasets.augmentation.image_shape = ()
    cfg.datasets.augmentation.jittering = (0.2, 0.2, 0.2, 0.05)
    cfg.datasets.augmentation.crop_train_borders = ()
    cfg.datasets.augmentation.crop_eval_borders = ()
    for aug, knobs in [
        ('randaugment', dict(enabled=False, n=9, m=0.5, prob=0.5)),
        ('random_erasing', dict(enabled=False, probability=0.1, sl=0.02,
                                sh=0.4, r1=0.3, mean=[0.485, 0.456, 0.406])),
        ('mixup', dict(enabled=False, alpha=0.2, prob=0.5)),
        ('cutmix', dict(enabled=False, alpha=1.0, prob=0.5)),
    ]:
        cfg.datasets.augmentation[aug] = CN(knobs)

    def _split(batch_size, num_workers, back, forward):
        node = CN()
        node.batch_size = batch_size
        node.num_workers = num_workers
        node.back_context = back
        node.forward_context = forward
        node.dataset = []
        node.path = []
        node.split = []
        node.depth_type = ['']
        node.input_depth_type = ['']
        node.cameras = [[]]
        node.repeat = [1]
        node.num_logs = 5
        node.mask_file = ['']
        node.use_mask = [False]
        # decoded-sample cache: ''|'ram'|'disk' (TPU addition — the
        # reference's /tmp cache analogue, datasets/cache.py)
        node.cache = ''
        node.cache_dir = ''
        return node

    cfg.datasets.train = _split(2, 16, 1, 1)
    cfg.datasets.validation = _split(1, 8, 0, 0)
    cfg.datasets.test = _split(1, 8, 0, 0)
    del cfg.datasets.validation['repeat']
    del cfg.datasets.test['repeat']

    # ------------------------------------------------------------- checkpoint
    cfg.checkpoint = CN()
    cfg.checkpoint.filepath = ''
    cfg.checkpoint.save_top_k = 5
    cfg.checkpoint.monitor = 'loss'
    cfg.checkpoint.monitor_index = 0
    cfg.checkpoint.mode = 'auto'
    cfg.checkpoint.period = 1
    cfg.checkpoint.s3_path = ''
    cfg.checkpoint.s3_frequency = 1
    cfg.checkpoint.s3_url = ''
    # TPU addition: rolling mid-epoch checkpoint every N train steps
    # (0 = off). Resuming from it replays the loader to the exact batch
    # (the shuffle is keyed by (seed, epoch), datasets/loader.py).
    cfg.checkpoint.save_every_n_steps = 0

    # ------------------------------------------------------------------- save
    cfg.save = CN()
    cfg.save.folder = ''
    cfg.save.depth = CN()
    cfg.save.depth.rgb = True
    cfg.save.depth.viz = True
    cfg.save.depth.npz = True
    cfg.save.depth.png = True
    cfg.save.pretrained = ''

    # ---------------------------------------------------------------- loggers
    cfg.wandb = CN()
    cfg.wandb.dry_run = True
    cfg.wandb.name = ''
    cfg.wandb.project = ''
    cfg.wandb.entity = ''
    cfg.wandb.tags = []
    cfg.wandb.dir = ''
    cfg.wandb.url = ''
    cfg.wandb.mode = ''  # '', 'online', 'offline', 'disabled' (TPU addition)

    cfg.tensorboard = CN()
    cfg.tensorboard.dry_run = True
    cfg.tensorboard.log_frequency = 100
    cfg.tensorboard.log_dir = ''

    # ------------------------------------------------------------ TPU-native
    cfg.tpu = CN()
    cfg.tpu.mesh_shape = ()          # e.g. (8,) for 8-way data parallelism; () = all devices
    cfg.tpu.mesh_axes = ('data',)    # mesh axis names
    cfg.tpu.compute_dtype = 'float32'  # conv compute dtype ('bfloat16' on pods)
    # rematerialize the forward in backward (jax.checkpoint): ~1.3x FLOPs
    # for a large peak-HBM cut — enables activation-bound configs (e.g.
    # PackNet literal conv3d at bs8) that otherwise OOM
    cfg.tpu.remat = False
    # Photometric map dtype. bf16 maps + fp32 accumulation islands (every
    # SSIM moment product/pool computes fp32 inside the fused pooling
    # kernels, ops/ssim.py) track fp32 convergence step-for-step — the
    # round-3 overfit A/B closed the round-2 quality gap (BENCH_NOTES.md
    # "fp32 accumulation islands") — at ~2.7x the self-sup step speed, so
    # bf16 is the default. 'float32' remains the bit-exact-parity knob.
    cfg.tpu.photometric_dtype = 'bfloat16'
    # With bf16 photometric: switch to fp32 at this training-progress
    # fraction for final-quality convergence (-1 = never switch).
    cfg.tpu.photometric_fp32_progress = -1.0
    cfg.tpu.use_pallas = False         # fused Pallas photometric kernel (A/B'd)
    cfg.tpu.donate_buffers = True      # donate params/opt state to train step
    cfg.tpu.device_augment = False     # run color jitter on-device in the step
    cfg.tpu.prefetch = 2               # host->device prefetch depth

    # ------------------------------------------------------------- book-keeping
    cfg.config = ''
    cfg.default = ''
    cfg.prepared = False
    return cfg
