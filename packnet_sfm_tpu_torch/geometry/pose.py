"""
SE(3) poses as batched [B,4,4] tensors (the JAX package's
geometry/pose.py): euler(x, y, z) -> R = Rx @ Ry @ Rz, the 6-vector layout
[tx, ty, tz, rx, ry, rz], the inverse by the transpose rule, and a small
`Pose` wrapper with `@` for composition and for transforming points.
"""

import torch


def euler2mat(angle):
    """[B,3] euler angles -> [B,3,3] rotation, R = Rx @ Ry @ Rz."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    B = angle.shape[0]
    zeros, ones = torch.zeros_like(z), torch.ones_like(z)
    cz, sz = torch.cos(z), torch.sin(z)
    zmat = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones],
                       dim=1).reshape(B, 3, 3)
    cy, sy = torch.cos(y), torch.sin(y)
    ymat = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy],
                       dim=1).reshape(B, 3, 3)
    cx, sx = torch.cos(x), torch.sin(x)
    xmat = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx],
                       dim=1).reshape(B, 3, 3)
    return xmat @ ymat @ zmat


def _homogeneous(R, t):
    """[B,4,4] from R [B,3,3] and t [B,3] (differentiable in both)."""
    B = R.shape[0]
    top = torch.cat([R, t[:, :, None]], dim=2)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(B, 1, 4)
    return torch.cat([top, bottom], dim=1)


def pose_vec2mat(vec, mode='euler'):
    """[B,6] (translation, rotation) -> [B,4,4] homogeneous transform."""
    if mode is None:
        return vec
    if mode != 'euler':
        raise ValueError('Rotation mode not supported {}'.format(mode))
    return _homogeneous(euler2mat(vec[:, 3:]), vec[:, :3])


def invert_pose(T):
    """Invert [B,4,4] rigid transforms."""
    Rt = T[:, :3, :3].transpose(-2, -1)
    tinv = -torch.einsum('bij,bj->bi', Rt, T[:, :3, 3])
    return _homogeneous(Rt, tinv)


def transform_points(T, points):
    """Apply [B,4,4] to [B,H,W,3] (or [B,N,3]) points."""
    R, t = T[:, :3, :3], T[:, :3, 3]
    if points.dim() == 4:
        return torch.einsum('bij,bhwj->bhwi', R, points) + t[:, None, None, :]
    if points.dim() == 3:
        return torch.einsum('bij,bnj->bni', R, points) + t[:, None, :]
    raise ValueError('Unsupported points shape {}'.format(
        tuple(points.shape)))


class Pose:
    """A batch of [B,4,4] transforms."""

    def __init__(self, mat):
        self.mat = mat

    @classmethod
    def identity(cls, B=1, dtype=torch.float32, device=None):
        return cls(torch.eye(4, dtype=dtype, device=device).expand(
            B, 4, 4).clone())

    @classmethod
    def from_vec(cls, vec, mode='euler'):
        return cls(pose_vec2mat(vec, mode))

    def inverse(self):
        return Pose(invert_pose(self.mat))

    def compose(self, other):
        return Pose(self.mat @ other.mat)

    def transform(self, points):
        return transform_points(self.mat, points)

    def __matmul__(self, other):
        if isinstance(other, Pose):
            return self.compose(other)
        return self.transform(other)
