"""
The pinhole camera (the JAX package's geometry/camera.py `Camera`,
`image_grid`, `scale_intrinsics`): Kinv lifting of depth to points and
projection to grid_sample's [-1, 1] coordinates, with the +0.5/-0.5
pixel-centre rule when intrinsics are rescaled. The VADAS fisheye camera is
not ported yet (ROADMAP.md).

Layout: depth maps are [B,H,W,1], points [B,H,W,3], intrinsics [B,3,3].
"""

import torch

from packnet_sfm_tpu_torch.geometry.pose import Pose


def image_grid(B, H, W, dtype=torch.float32, device=None):
    """Homogeneous pixel grid [B,H,W,3] of (u=x, v=y, 1)."""
    xs = torch.arange(W, dtype=dtype, device=device)
    ys = torch.arange(H, dtype=dtype, device=device)
    u = xs[None, :].expand(H, W)
    v = ys[:, None].expand(H, W)
    grid = torch.stack([u, v, torch.ones_like(u)], dim=-1)
    return grid[None].expand(B, H, W, 3)


def scale_intrinsics(K, x_scale, y_scale):
    """Scale [B,3,3] intrinsics (pixel-centre convention)."""
    K = K.clone()
    K[..., 0, 0] = K[..., 0, 0] * x_scale
    K[..., 1, 1] = K[..., 1, 1] * y_scale
    K[..., 0, 2] = (K[..., 0, 2] + 0.5) * x_scale - 0.5
    K[..., 1, 2] = (K[..., 1, 2] + 0.5) * y_scale - 0.5
    return K


class Camera:
    """Pinhole camera: intrinsics K [B,3,3] and the camera->world pose Tcw
    (identity when not given)."""

    def __init__(self, K, Tcw=None):
        if K.dim() == 2:
            K = K[None]
        self.K = K
        self.Tcw = Tcw if Tcw is not None else Pose.identity(
            K.shape[0], K.dtype, K.device)

    @property
    def fx(self):
        return self.K[:, 0, 0]

    @property
    def fy(self):
        return self.K[:, 1, 1]

    @property
    def cx(self):
        return self.K[:, 0, 2]

    @property
    def cy(self):
        return self.K[:, 1, 2]

    @property
    def Twc(self):
        return self.Tcw.inverse()

    @property
    def Kinv(self):
        """Closed-form inverse of the calibration matrix."""
        zeros, ones = torch.zeros_like(self.fx), torch.ones_like(self.fx)
        row0 = torch.stack([1.0 / self.fx, zeros, -self.cx / self.fx], dim=-1)
        row1 = torch.stack([zeros, 1.0 / self.fy, -self.cy / self.fy], dim=-1)
        row2 = torch.stack([zeros, zeros, ones], dim=-1)
        return torch.stack([row0, row1, row2], dim=1).to(self.K.dtype)

    def reconstruct(self, depth, frame='w'):
        """Lift [B,H,W,1] depth to [B,H,W,3] points in the camera ('c') or
        world ('w') frame."""
        B, H, W, _ = depth.shape
        grid = image_grid(B, H, W, depth.dtype, depth.device)
        Xc = torch.einsum('bij,bhwj->bhwi', self.Kinv, grid) * depth
        if frame == 'c':
            return Xc
        if frame == 'w':
            return self.Twc @ Xc
        raise ValueError('Unknown reference frame {}'.format(frame))

    def project(self, X, frame='w'):
        """Project [B,H,W,3] points to normalised [-1, 1] coordinates
        [B,H,W,2]; the depth is clipped at 1e-5 before the division."""
        B, H, W, _ = X.shape
        if frame == 'w':
            Xc = self.Tcw @ X
        elif frame == 'c':
            Xc = X
        else:
            raise ValueError('Unknown reference frame {}'.format(frame))
        pix = torch.einsum('bij,bhwj->bhwi', self.K, Xc)
        Z = pix[..., 2].clamp(min=1e-5)
        Xn = 2.0 * (pix[..., 0] / Z) / (W - 1) - 1.0
        Yn = 2.0 * (pix[..., 1] / Z) / (H - 1) - 1.0
        return torch.stack([Xn, Yn], dim=-1)
