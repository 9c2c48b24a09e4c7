"""
The decoded-sample cache (the JAX package's datasets/cache.py; reference:
datasets/kitti_dataset_optimized.py:59-113): each sample is read and
transformed once, then served from memory or disk instead of being decoded
again:
- 'ram': samples kept in process memory;
- 'disk': one .npy of the pickled sample dict under `cache_dir` (by default
  <temp dir>/packnet_sfm_tpu_torch_cache/<dataset type>_<length>; like the
  JAX package's, that default is keyed by the type and length only, so two
  such datasets share it unless the config names a cache_dir), written
  through a temporary file and renamed; an unreadable file is decoded
  again.

A cached sample is frozen, so the cache must not wrap a transform with host
randomness: `validate_transform` says whether a train split may have it
(no host jitter, or the jitter moved to the card by tpu.device_augment; no
RandAugment or random erasing; mixup and cutmix run on batches after the
cache and stay random).
"""

import os
import pickle
import tempfile
import threading

import numpy as np


class SampleCache:
    def __init__(self, dataset, mode='ram', cache_dir=None):
        if mode not in ('ram', 'disk'):
            raise ValueError("cache mode {!r}: 'ram' or 'disk'".format(mode))
        self.dataset = dataset
        self.mode = mode
        if mode == 'disk':
            self.cache_dir = cache_dir or os.path.join(
                tempfile.gettempdir(), 'packnet_sfm_tpu_torch_cache',
                '{}_{}'.format(type(dataset).__name__, len(dataset)))
            os.makedirs(self.cache_dir, exist_ok=True)
        self._ram = {}

    @staticmethod
    def validate_transform(aug_cfg, device_augment):
        """True when a train split may be cached under the augmentation node
        `aug_cfg`."""
        if tuple(aug_cfg.get('jittering', ()) or ()) and not device_augment:
            return False
        return not any(aug_cfg.get(k, {}).get('enabled', False)
                       for k in ('randaugment', 'random_erasing'))

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        if self.mode == 'ram':
            s = self._ram.get(idx)
            if s is None:
                s = self._ram[idx] = self.dataset[idx]
            return s
        path = os.path.join(self.cache_dir, '{}.npy'.format(idx))
        if os.path.exists(path):
            try:
                return np.load(path, allow_pickle=True).item()
            except (OSError, ValueError, EOFError, pickle.UnpicklingError):
                pass  # a partial write of a run that died: decode again
        s = self.dataset[idx]
        tmp = '{}.tmp{}-{}'.format(path, os.getpid(), threading.get_ident())
        with open(tmp, 'wb') as f:
            np.save(f, np.asarray(s, dtype=object), allow_pickle=True)
        os.replace(tmp, path)
        return s
