"""
Synthetic SfM dataset (a copy of the JAX package's datasets/synthetic.py):
procedurally textured fronto-parallel scenes with known depth and
ego-motion, for tests and for runs without a dataset on disk.

Produces the same sample dict schema as the real datasets (NHWC numpy):
rgb, rgb_original, rgb_context[], rgb_context_original[], intrinsics,
depth, input_depth, pose_context[].
"""

import numpy as np


def _texture(rng, H, W):
    """Smooth random RGB texture (sum of low-frequency sinusoids)."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.zeros((H, W, 3), np.float32)
    for _ in range(6):
        fx, fy = rng.uniform(0.02, 0.2, 2)
        ph = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(0.1, 0.3, 3)
        for c in range(3):
            img[..., c] += amp[c] * np.sin(2 * np.pi * (fx * xs + fy * ys) + ph[c])
    img = (img - img.min()) / (img.max() - img.min() + 1e-6)
    return img


class SyntheticDataset:
    def __init__(self, num_samples=32, height=64, width=96,
                 back_context=1, forward_context=1, with_depth=True,
                 with_input_depth=False, input_depth_fill=0.05, seed=0,
                 min_depth=1.0, max_depth=10.0):
        self.n = num_samples
        self.H, self.W = height, width
        self.back_context = back_context
        self.forward_context = forward_context
        self.with_depth = with_depth
        self.with_input_depth = with_input_depth
        self.fill = input_depth_fill
        self.seed = seed
        self.min_depth, self.max_depth = min_depth, max_depth
        K = np.array([[width * 1.1, 0, width / 2 - 0.5],
                      [0, width * 1.1, height / 2 - 0.5],
                      [0, 0, 1]], np.float32)
        self.K = K

    def __len__(self):
        return self.n

    def _render(self, tex, depth, shift_px):
        """Shift the texture horizontally by shift_px (simulating x-motion)."""
        W = self.W
        xs = (np.arange(W) + shift_px) % W
        return tex[:, xs.astype(int), :]

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        H, W = self.H, self.W
        tex = _texture(rng, H, W)
        # slanted-plane depth
        ys = np.linspace(0, 1, H, dtype=np.float32)[:, None]
        base = rng.uniform(self.min_depth + 1, self.max_depth - 1)
        depth = (base + 3.0 * ys + 0.5 * np.sin(
            np.linspace(0, 6, W, dtype=np.float32))[None, :])
        depth = np.clip(depth, self.min_depth, self.max_depth)[..., None]

        sample = {
            'idx': idx,
            'rgb': tex,
            'rgb_original': tex.copy(),
            'intrinsics': self.K.copy(),
        }
        ctx, ctx_orig, poses = [], [], []
        n_ctx = self.back_context + self.forward_context
        for j in range(n_ctx):
            sign = -1 if j < self.back_context else 1
            shift = sign * 2.0
            img = self._render(tex, depth, shift)
            ctx.append(img)
            ctx_orig.append(img.copy())
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = sign * 0.1
            poses.append(T)
        if n_ctx:
            sample['rgb_context'] = ctx
            sample['rgb_context_original'] = ctx_orig
            sample['pose_context'] = poses
        if self.with_depth:
            sample['depth'] = depth.astype(np.float32)
        if self.with_input_depth:
            mask = rng.rand(H, W, 1) < self.fill
            sample['input_depth'] = (depth * mask).astype(np.float32)
        return sample
