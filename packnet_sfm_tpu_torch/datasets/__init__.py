"""
Datasets of the port, and `setup_dataset`, the dispatch on the dataset name
of the JAX package's datasets/__init__.py (reference: model_wrapper.py
setup_dataset): 'KITTI', 'ncdb' and 'Synthetic'. 'DGP' and 'Image' are not
ported yet and raise.
"""

from packnet_sfm_tpu_torch.datasets.kitti import KITTIDataset
from packnet_sfm_tpu_torch.datasets.ncdb import NcdbDataset
from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticDataset
from packnet_sfm_tpu_torch.datasets.transforms import get_transforms

_NOT_PORTED = {
    'DGP': 'ROADMAP.md section 1: the Image and DGP datasets',
    'Image': 'ROADMAP.md section 1: the Image and DGP datasets',
}


def setup_dataset(split_cfg, augmentation_cfg, mode, seed=0):
    """The list of datasets of one split from its config node; `mode` is
    'train', 'validation' or 'test'. Train datasets each get their own
    TrainTransform (crop_train_borders, jittering), its jitter keyed by
    `seed` and the dataset's position in the split."""
    names = split_cfg.get('dataset', [])
    if not names:
        return []
    paths = split_cfg.get('path', [])
    splits = split_cfg.get('split', [''] * len(names))
    depth_types = split_cfg.get('depth_type', [''] * len(names))
    input_depth_types = split_cfg.get('input_depth_type', [''] * len(names))
    mask_files = split_cfg.get('mask_file', [''] * len(names))
    use_masks = split_cfg.get('use_mask', [False] * len(names))
    back = split_cfg.get('back_context', 0)
    forward = split_cfg.get('forward_context', 0)

    def pick(values, i, default):
        return values[i] if i < len(values) else default

    def aug(key):
        return tuple(augmentation_cfg.get(key, ()) or ())

    transforms = [get_transforms(
        mode, image_shape=aug('image_shape'),
        jittering=aug('jittering') if mode == 'train' else (),
        crop_train_borders=aug('crop_train_borders'),
        crop_eval_borders=aug('crop_eval_borders'),
        augmentation=augmentation_cfg, seed=seed, dataset=i)
        for i in range(len(names))]

    datasets = []
    for i, name in enumerate(names):
        if name in _NOT_PORTED:
            raise NotImplementedError('dataset {!r} is not ported yet ({})'
                                      .format(name, _NOT_PORTED[name]))
        if name == 'KITTI':
            datasets.append(KITTIDataset(
                path=pick(paths, i, ''), split=pick(splits, i, ''),
                depth_type=pick(depth_types, i, ''),
                input_depth_type=pick(input_depth_types, i, ''),
                back_context=back, forward_context=forward,
                transform=transforms[i]))
        elif name == 'ncdb':
            datasets.append(NcdbDataset(
                path=pick(paths, i, ''), split=pick(splits, i, ''),
                depth_type=pick(depth_types, i, ''),
                input_depth_type=pick(input_depth_types, i, ''),
                mask_file=pick(mask_files, i, ''),
                use_mask=pick(use_masks, i, False), transform=transforms[i]))
        elif name == 'Synthetic':
            datasets.append(SyntheticDataset(
                num_samples=int(splits[i]) if str(splits[i]).isdigit()
                else 32,
                with_input_depth=bool(pick(input_depth_types, i, '')),
                back_context=back, forward_context=forward))
        else:
            raise ValueError('Unknown dataset {}'.format(name))
    return datasets
